"""The port's tool twins (``xfeatslam_tpu_torch/tools/``) against the
scripts in ``tools/`` they mirror, and the port's PNG writer, on the CPU.

The training pair renderer gives the JAX tool's arrays bit for bit on the
same ``default_rng`` (1 scene, 2 pairs and a homography pair at 64x96);
``eval_pairs`` and ``make_eval_pairs`` give the JAX tool's numbers; the
PNG writer's files read back sample for sample through cv2 and the port's
decoder (8-bit gray and RGB, 16-bit gray); ``render_tum_dataset`` writes
the JAX tool's images and lists; ``learn_brief_pattern``'s patches and
greedy selection at a small size; ``conv_flops``; and each twin's ``main``
(``--help``, and a tiny run of four of them, the three that compute
turning TF32 off) in a process that must not import jax, the JAX package,
``bench``, cv2, optax, matplotlib or PIL."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import eval_repeatability as j_eval  # noqa: E402
import learn_brief_pattern as j_brief  # noqa: E402
import profile_pipeline as j_prof  # noqa: E402
import render_tum_dataset as j_tum  # noqa: E402
import train_xfeat as j_train  # noqa: E402

from xfeatslam_tpu_torch.tools import eval_repeatability as t_eval  # noqa: E402,E501
from xfeatslam_tpu_torch.tools import learn_brief_pattern as t_brief  # noqa: E402,E501
from xfeatslam_tpu_torch.tools import profile_pipeline as t_prof  # noqa: E402,E501
from xfeatslam_tpu_torch.tools import render_tum_dataset as t_tum  # noqa: E402,E501
from xfeatslam_tpu_torch.tools import train_xfeat as t_train  # noqa: E402
from xfeatslam_tpu_torch.utils import io as tio  # noqa: E402
from xfeatslam_tpu_torch.utils import png  # noqa: E402

TOOLS = ("train_xfeat", "eval_repeatability", "profile_pipeline",
         "learn_brief_pattern", "render_tum_dataset")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_pair_renderer_matches_jax_tool():
    kw = dict(n_scenes=1, hw=(64, 96), pairs_per_scene=2, f=130.0 * 96 / 160,
              homog_per_scene=1)
    want = j_train.render_pair_pool(np.random.default_rng(0), **kw)
    got = t_train.render_pair_pool(np.random.default_rng(0), **kw)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(got["img_a"]) >= 2
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    np.testing.assert_array_equal(t_train._rand_homography(rng_a, (64, 96)),
                                  j_train._rand_homography(rng_b, (64, 96)))
    w = np.array([0.1, -0.2, 0.05], np.float32)
    np.testing.assert_array_equal(t_train._rot(w), j_train._rot(w))


def test_eval_pairs_matches_jax_tool():
    pairs_t = t_eval.make_eval_pairs(2, hw=(96, 128))
    pairs_j = j_eval.make_eval_pairs(2, hw=(96, 128))
    for pt, pj in zip(pairs_t, pairs_j):
        for a, b in zip((pt[0], pt[1], pt[2], *pt[3], pt[4]),
                        (pj[0], pj[1], pj[2], *pj[3], pj[4])):
            np.testing.assert_array_equal(a, b)
    from xfeatslam_tpu.models.extractor import XFeatExtractor as JaxExtractor
    from xfeatslam_tpu_torch.models.extractor import XFeatExtractor

    ext = XFeatExtractor(nfeatures=200, device="cpu")
    # the same extractor through both tools' arithmetic: equal numbers
    assert t_eval.eval_pairs(ext, pairs_t) == j_eval.eval_pairs(ext, pairs_t)
    # the port's extractor against the JAX package's on those pairs
    got = t_eval.eval_pairs(ext, pairs_t)
    want = j_eval.eval_pairs(JaxExtractor(nfeatures=200), pairs_j)
    assert set(got) == {"rep@1px", "rep@2px", "rep@3px", "loc_err_px"}
    for k in got:
        assert abs(got[k] - want[k]) <= 0.01, (k, got[k], want[k])


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "gray16"])
def test_png_writer_reads_back(tmp_path, kind):
    import cv2

    rng = np.random.default_rng(3)
    px = {"gray8": rng.integers(0, 256, (37, 53), dtype=np.uint8),
          "rgb8": rng.integers(0, 256, (20, 31, 3), dtype=np.uint8),
          "gray16": rng.integers(0, 65536, (29, 41), dtype=np.uint16)}[kind]
    path = str(tmp_path / f"{kind}.png")
    png.write(path, px)
    np.testing.assert_array_equal(png.read(path), px)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back[..., ::-1] if px.ndim == 3 else back,
                                  px)
    assert back.dtype == px.dtype
    with pytest.raises(ValueError):
        png.encode(px.astype(np.float32))


def test_render_tum_dataset_matches_jax_tool(tmp_path):
    import cv2

    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    t_tum.render_tum_dataset(a, n_frames=3)
    j_tum.render_tum_dataset(b, n_frames=3)
    for name in ("rgb.txt", "depth.txt", "groundtruth.txt"):
        assert open(os.path.join(a, name)).read() == \
            open(os.path.join(b, name)).read(), name

    def settings_lines(d):
        return [ln for ln in open(os.path.join(d, "settings.yaml"))
                if not ln.startswith("#")]

    assert settings_lines(a) == settings_lines(b)
    for sub in ("rgb", "depth"):
        names = sorted(os.listdir(os.path.join(b, sub)))
        assert sorted(os.listdir(os.path.join(a, sub))) == names
        for n in names:
            want = cv2.imread(os.path.join(b, sub, n), cv2.IMREAD_UNCHANGED)
            got = png.read(os.path.join(a, sub, n))
            np.testing.assert_array_equal(got, want)
    # the port's TUM reader takes the directory
    seq = tio.associate_tum(a)
    assert len(seq) == 3
    first = sorted(os.listdir(os.path.join(b, "rgb")))[0]
    np.testing.assert_array_equal(
        seq.read(0)[0], cv2.imread(os.path.join(b, "rgb", first),
                                   cv2.IMREAD_GRAYSCALE))


def test_brief_patches_and_selection_match_jax_tool():
    import jax.numpy as jnp  # noqa: F401  (the JAX tool's patches)

    rng = np.random.default_rng(1)
    img = (rng.random((60, 80)) * 255).astype(np.float32)
    grid = t_brief._brief_grid()
    np.testing.assert_array_equal(grid, j_brief._brief_grid())
    xx = rng.integers(14, 66, 20)
    yy = rng.integers(14, 46, 20)
    ang = rng.uniform(-np.pi, np.pi, 20)
    got = t_brief._extract_patches(img, xx, yy, ang, grid)
    want = j_brief._extract_patches(img, xx, yy, ang, grid)
    # the port's blur7 is the correctly rounded blur, JAX's a float32
    # convolution within its rounding of it
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    PA = rng.random((300, 40)).astype(np.float32)
    PB = PA + rng.normal(0, 0.05, PA.shape).astype(np.float32)
    g40 = grid[:40]
    kw = dict(n_bits=16, n_cand=300, seed=5)
    np.testing.assert_array_equal(t_brief.greedy_decorrelate(PA, PB, g40, **kw),
                                  j_brief.greedy_decorrelate(PA, PB, g40, **kw))


@pytest.mark.parametrize("hw", [(480, 640), (128, 160), (64, 96)])
def test_conv_flops_matches_jax_tool(hw):
    assert t_prof.conv_flops(hw) == j_prof.conv_flops(hw)


def test_make_images_is_bench_copy():
    import bench

    np.testing.assert_array_equal(t_prof.make_images(2), bench.make_images(2))


def test_mains_run_without_jax(tmp_path):
    """Every twin's --help, then tiny runs of four mains on the CPU, in a
    fresh process; none of the forbidden modules may be imported, and the
    three that compute turn TF32 off."""
    script = textwrap.dedent(f"""
        import sys, os
        import numpy as np
        sys.path.insert(0, {REPO!r})
        import torch
        torch.set_num_threads(1)
        from xfeatslam_tpu_torch.tools import ({", ".join(TOOLS)})
        from xfeatslam_tpu_torch.models import weights
        for mod in ({", ".join(TOOLS)}):
            try:
                mod.main(["--help"])
            except SystemExit as e:
                assert e.code == 0, mod
        def tf32_on():
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True

        def tf32_turned_off(tool):
            assert not torch.backends.cudnn.allow_tf32, tool
            assert not torch.backends.cuda.matmul.allow_tf32, tool

        out = os.path.join({str(tmp_path)!r}, "w.npz")
        tf32_on()
        model = train_xfeat.main(["--steps", "2", "--batch", "2", "--scenes",
            "1", "--pairs-per-scene", "2", "--hw", "64", "96",
            "--steps-per-call", "1", "--out", out, "--device", "cpu",
            "--aug", "--cosine"])
        tf32_turned_off("train_xfeat")
        back = weights.load_npz(out, device="cpu")
        x = torch.rand(1, 64, 96, 1)
        with torch.no_grad():
            for a, b in zip(model(x), back(x)):
                assert torch.equal(a, b)
        try:
            train_xfeat.main(["--hw", "100", "96"])
        except SystemExit as e:
            assert e.code == 2
        render_tum_dataset.main([os.path.join({str(tmp_path)!r}, "tum"),
                                 "--frames", "2"])
        tf32_on()
        profile_pipeline.main(["--device", "cpu", "--batch", "2", "--hw",
                               "64", "96", "--kpts", "50", "--iters", "1"])
        tf32_turned_off("profile_pipeline")
        tf32_on()
        eval_repeatability.main(["--device", "cpu", "--pairs", "1",
                                 "--nfeatures", "100"])
        tf32_turned_off("eval_repeatability")
        bad = [m for m in ("jax", "xfeatslam_tpu", "bench", "cv2", "optax",
                           "matplotlib", "PIL")
               if m in sys.modules]
        assert not bad, bad
        print("TOOLS_OK")
    """)
    env = dict(os.environ, XFEATSLAM_BRIEF_PATTERN="gaussian")
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, cwd=str(tmp_path), env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "TOOLS_OK" in r.stdout
    assert "end-to-end pipeline" in r.stdout and "rep@1px" in r.stdout


@pytest.mark.parametrize("tool", TOOLS)
def test_module_entry_point_help(tool):
    r = subprocess.run([sys.executable, "-m", f"xfeatslam_tpu_torch.tools.{tool}",
                        "--help"], capture_output=True, text=True, cwd=REPO,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "usage: python -m xfeatslam_tpu_torch.tools." + tool in r.stdout
