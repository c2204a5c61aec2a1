"""The PyTorch port's whole slice (batched extract + consecutive-frame
match, and the SLAM extractor facade) against the JAX package with the
shipped weights, plus the port's guards: no JAX import, no silent CPU
fallback, no kernel launch for CPU tensors."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# float32 parity: no TF32 in convolutions or matmuls, should a GPU be used
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

import jax.numpy as jnp  # noqa: E402

from xfeatslam_tpu.models import weights as jw  # noqa: E402
from xfeatslam_tpu.models.extractor import XFeatExtractor as JaxExtractor  # noqa: E402
from xfeatslam_tpu.parallel import batched as jb  # noqa: E402
from xfeatslam_tpu_torch.models import weights as tw  # noqa: E402
from xfeatslam_tpu_torch.models.extractor import XFeatExtractor  # noqa: E402
from xfeatslam_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from xfeatslam_tpu_torch.ops import image as ti  # noqa: E402
from xfeatslam_tpu_torch.ops.camera import Pinhole  # noqa: E402
from xfeatslam_tpu_torch.slam.settings import Settings  # noqa: E402
from xfeatslam_tpu_torch.slam.system import Sensor, System  # noqa: E402
from xfeatslam_tpu_torch.parallel import batched as tb  # noqa: E402

from test_torch_xfeat import NPZ, blob_images  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pixels(kpts, valid):
    return {tuple(k) for k in kpts[valid].astype(np.int64)}


def _jaccard(a, b):
    return len(a & b) / max(len(a | b), 1)


def _pair_set(kpts, idx, b):
    """Matched pairs of frames (b, b+1) as pixel-coordinate pairs."""
    return {(tuple(kpts[b, i].astype(np.int64)),
             tuple(kpts[b + 1, j].astype(np.int64)))
            for i, j in enumerate(idx[b]) if j >= 0}


def test_extract_and_match_consecutive_match_jax():
    B, H, W, K = 3, 128, 160, 200
    images = blob_images(np.random.default_rng(8), B, H, W, n_blobs=25)
    params = jw.load_npz(NPZ)
    oj = {k: np.asarray(v) for k, v in
          jb.extract_batch(params, jnp.asarray(images), K).items()}
    rj = jb.match_consecutive(jnp.asarray(oj["desc"]), jnp.asarray(oj["valid"]),
                              fused=False)

    ck.reset_launch_counts()
    model = tw.load_npz(NPZ, device="cpu")
    ot = tb.extract_batch(model, torch.from_numpy(images), K)
    rt = tb.match_consecutive(ot["desc"], ot["valid"])
    ot = {k: v.numpy() for k, v in ot.items()}
    assert set(ck.launch_counts().values()) == {0}

    assert ot["kpts"].shape == (B, K, 2) and ot["desc"].shape == (B, K, 64)
    for b in range(B):
        vj, vt = oj["valid"][b], ot["valid"][b]
        assert vt.sum() == vj.sum() > 20
        assert _jaccard(_pixels(ot["kpts"][b], vt),
                        _pixels(oj["kpts"][b], vj)) >= 0.99
    idx_j, idx_t = np.asarray(rj.idx), rt.idx.numpy()
    assert idx_t.shape == (B - 1, K)
    for b in range(B - 1):
        pj = _pair_set(oj["kpts"], idx_j, b)
        pt = _pair_set(ot["kpts"], idx_t, b)
        assert len(pj) > 5
        assert _jaccard(pt, pj) >= 0.98


def test_extractor_matches_jax():
    """A 100x140 uint8 frame: resized to 96x128 (antialiased shrink),
    sub-pixel selection, coordinates scaled back to the frame."""
    rng = np.random.default_rng(9)
    frame = (blob_images(rng, 1, 100, 140, n_blobs=20)[0, ..., 0] * 255).astype(
        np.uint8)
    oj = JaxExtractor(nfeatures=100)(frame)
    ot = XFeatExtractor(nfeatures=100, device="cpu")(frame)
    assert {k: v.shape for k, v in ot.items()} == {k: v.shape for k, v in oj.items()}
    vj, vt = oj["valid"][0], ot["valid"][0]
    assert vt.sum() == vj.sum() > 10
    kt = ot["kpts"][0][vt]
    # in the frame, up to a border pixel's one-pixel sub-pixel offset
    assert (kt >= -1.1).all()
    assert (kt[:, 0] <= 140).all() and (kt[:, 1] <= 100).all()
    dist = np.linalg.norm(kt[:, None] - oj["kpts"][0][vj][None], axis=-1)
    assert (dist.min(axis=1) < 1e-2).mean() >= 0.99
    np.testing.assert_allclose(np.sort(ot["scores"][0][vt]),
                               np.sort(oj["scores"][0][vj]), atol=1e-4)


def test_weight_resolution_order(monkeypatch, tmp_path):
    monkeypatch.delenv("XFEATSLAM_WEIGHTS", raising=False)
    assert XFeatExtractor._default_weights() == os.path.join(
        REPO, "weights/xfeat_synthetic.npz")
    alt = tmp_path / "alt.npz"
    alt.write_bytes(b"")
    monkeypatch.setenv("XFEATSLAM_WEIGHTS", str(alt))
    assert XFeatExtractor._default_weights() == str(alt)


def test_port_and_smoke_script_import_no_jax():
    code = (
        "import sys\n"
        "import xfeatslam_tpu_torch\n"
        "from xfeatslam_tpu_torch import _build\n"
        "from xfeatslam_tpu_torch.models import xfeat, weights, extractor\n"
        "from xfeatslam_tpu_torch.ops import image, detect, matching, cuda_kernels\n"
        "from xfeatslam_tpu_torch.ops import lie, camera\n"
        "from xfeatslam_tpu_torch.ops import geometry\n"
        "from xfeatslam_tpu_torch.optim import pose_opt, track_step, local_ba\n"
        "from xfeatslam_tpu_torch.parallel import batched\n"
        "from xfeatslam_tpu_torch.utils import synthetic, io, timing, verbose\n"
        "from xfeatslam_tpu_torch.slam import (atlas, frame, local_mapping,\n"
        "    map, settings, system, tracking)\n"
        "from xfeatslam_tpu_torch.examples import rgbd_tum\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'xfeatslam_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_points_default_to_cuda():
    """Without ``device`` the entry points put tensors on CUDA; on a host
    without a GPU they raise instead of running on the CPU."""
    entry_points = [
        lambda: tw.load_npz(NPZ),
        lambda: tw.from_jax_params(tw.load_npz_params(NPZ)),
        lambda: XFeatExtractor(nfeatures=10),
        lambda: ti.to_float_image(np.zeros((32, 32), np.uint8)),
        lambda: System(Settings(cam=Pinhole.from_list([100.0, 100.0, 16.0,
                                                       16.0])),
                       Sensor.RGBD, enable_loop_closing=False).extractor,
    ]
    for make in entry_points:
        if torch.cuda.is_available():
            out = make()
            dev = out.device if isinstance(out, torch.Tensor) else next(
                (out.model if hasattr(out, "model") else out).parameters()).device
            assert dev.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()


def test_smoke_script_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: chip_smoke.py would run for real")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
