"""The PyTorch port's tracking step and whole RGB-D / monocular frame step
against the JAX package, on the port's synthetic scene (bit-identical to
the JAX one) at 96x128 with the shipped weights, K=128, M1=128, M2=256.

Tolerances: poses within 1e-4 (the LM's accept/reject and chi2 gates
compare float32 sums taken in another order, so the two runs may stop a
few ulps apart; 1e-4 is two orders below the pose error against the
truth); match slots and inlier sets by agreement >= 0.99 (a near-tie in a
distance or chi2 gate may flip one slot); keypoints to 1e-3 px."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from xfeatslam_tpu.models import weights as jw  # noqa: E402
from xfeatslam_tpu.models.extractor import extract_fn as jax_extract  # noqa: E402
from xfeatslam_tpu.ops import camera as jc  # noqa: E402
from xfeatslam_tpu.ops import lie as jl  # noqa: E402
from xfeatslam_tpu.optim import track_step as jts  # noqa: E402
from xfeatslam_tpu.utils import synthetic as jsyn  # noqa: E402
from xfeatslam_tpu_torch.models import weights as tw  # noqa: E402
from xfeatslam_tpu_torch.ops import camera as tc  # noqa: E402
from xfeatslam_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from xfeatslam_tpu_torch.optim import track_step as tts  # noqa: E402
from xfeatslam_tpu_torch.utils import synthetic as tsyn  # noqa: E402

from test_torch_xfeat import NPZ  # noqa: E402

H, W, KP, M1, M2 = 96, 128, 128, 128, 256
# TUM1 intrinsics scaled to 96x128 (1/5 of 480x640)
KMAT = np.array([[517.3 * 0.2, 0, 318.6 * 0.2], [0, 516.5 * 0.2, 255.3 * 0.2],
                 [0, 0, 1]], np.float32)
CAMP = [float(KMAT[0, 0]), float(KMAT[1, 1]), float(KMAT[0, 2]),
        float(KMAT[1, 2])]
# TrackerConfig's XFeat defaults: bf, depth_edge_rel, inv_sigma2, radii,
# th_high, ratio, widen_below (min_inliers_motion), scale factor
SETTINGS = (40.0, 0.05, 1.0, 15.0, 10.0, 1000.0, 0.9, 20, 1.2)


def t(x):
    return torch.tensor(np.asarray(x))


def test_make_sequence_matches_jax_bit_for_bit():
    a = tsyn.make_sequence(2, (H, W), K=KMAT)
    b = jsyn.make_sequence(2, (H, W), K=KMAT)
    for key in ("images", "depths"):
        for x, y in zip(a[key], b[key]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    for (Ra, ta), (Rb, tb) in zip(a["poses"], b["poses"]):
        np.testing.assert_array_equal(Ra, Rb)
        np.testing.assert_array_equal(ta, tb)
    assert a["timestamps"] == b["timestamps"]


def _pad(a, n, fill=0):
    out = np.full((n,) + a.shape[1:], fill, a.dtype)
    out[: len(a)] = a
    return out


@pytest.fixture(scope="module")
def scene():
    """Frame 0's valid keypoints with depth, back-projected with the true
    pose into a map: even ones fill stage 1's M1 slots, odd ones stage 2's
    M2-row local map under ids stage 1 does not hold."""
    seq = tsyn.make_sequence(2, (H, W), K=KMAT)
    params = jw.load_npz(NPZ)
    img0 = seq["images"][0].astype(np.float32)[None, ..., None] / 255.0
    o = {k: np.asarray(v) for k, v in jax_extract(params, jnp.asarray(img0),
                                                   KP).items()}
    kp, desc, val = o["kpts"][0], o["desc"][0], o["valid"][0]
    xi = np.clip(np.round(kp[:, 0]).astype(int), 0, W - 1)
    yi = np.clip(np.round(kp[:, 1]).astype(int), 0, H - 1)
    z = seq["depths"][0][yi, xi]
    fx, fy, cx, cy = CAMP
    Xc = np.stack([(kp[:, 0] - cx) / fx * z, (kp[:, 1] - cy) / fy * z, z], -1)
    R0, t0 = seq["poses"][0]
    Xw = ((Xc - t0) @ R0).astype(np.float32)
    sel = np.nonzero(val & (z > 0))[0]
    s1, s2 = sel[0::2], sel[1::2]
    zf1, zi1 = np.zeros(M1, np.float32), np.zeros(M1, np.int32)
    zf2, zi2 = np.zeros(M2, np.float32), np.zeros(M2, np.int32)
    maps = (R0, t0,
            _pad(Xw[s1], M1), _pad(desc[s1], M1),
            _pad(np.ones(len(s1), bool), M1, False), zf1, zi1,
            _pad(np.arange(len(s1), dtype=np.int32), M1, -1),
            _pad(Xw[s2], M2), _pad(desc[s2], M2),
            _pad(np.ones(len(s2), bool), M2, False), zf2, zi2,
            _pad(np.arange(len(s2), dtype=np.int32) + 1000, M2, -1),
            np.full(M2, 10.0, np.float32))
    return dict(seq=seq, params=params, maps=maps)


@pytest.mark.parametrize("has_depth", [True, False])
def test_frame_step_matches_jax(scene, has_depth):
    seq = scene["seq"]
    img1 = seq["images"][1].astype(np.float32)[None, ..., None] / 255.0
    dep1 = seq["depths"][1] if has_depth else np.zeros((1, 1), np.float32)
    bf, edge, isig, r1, r2, th, ratio, widen_below, sf = SETTINGS
    jo, jr1, jr2 = jts.xfeat_rgbd_frame_step(
        scene["params"], jnp.asarray(img1), jnp.asarray(dep1),
        *map(jnp.asarray, scene["maps"]), jc.Pinhole.from_list(CAMP),
        jnp.float32(bf), jnp.float32(edge), jnp.float32(isig),
        jnp.float32(r1), jnp.float32(r2), jnp.float32(th),
        jnp.float32(ratio), jnp.int32(widen_below), jnp.float32(sf),
        jnp.float32(2 * CAMP[2]), jnp.float32(2 * CAMP[3]),
        num_keypoints=KP, n_levels=1, has_depth=has_depth)

    ck.reset_launch_counts()
    model = tw.load_npz(NPZ, device="cpu")
    to, tr1, tr2 = tts.xfeat_rgbd_frame_step(
        model, t(img1), t(dep1), *map(t, scene["maps"]),
        tc.Pinhole.from_list(CAMP), bf, edge, isig, r1, r2, th, ratio,
        widen_below, sf, 2 * CAMP[2], 2 * CAMP[3], num_keypoints=KP,
        n_levels=1, has_depth=has_depth)
    assert set(ck.launch_counts().values()) == {0}

    valid = to["valid"].numpy()
    np.testing.assert_array_equal(valid, np.asarray(jo["valid"]))
    np.testing.assert_allclose(to["kpts"].numpy()[valid],
                               np.asarray(jo["kpts"])[valid], atol=1e-3)
    np.testing.assert_allclose(to["depth"].numpy(), np.asarray(jo["depth"]),
                               atol=1e-6)
    np.testing.assert_allclose(to["ur"].numpy(), np.asarray(jo["ur"]),
                               atol=1e-3)
    if has_depth:
        assert (to["depth"].numpy() > 0).sum() > 30
    else:
        assert (to["ur"].numpy() == -1).all()

    for jr, tr in ((jr1, tr1), (jr2, tr2)):
        np.testing.assert_allclose(tr.R.numpy(), np.asarray(jr.R), atol=1e-4)
        np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t), atol=1e-4)
        assert (tr.slot_mp.numpy() == np.asarray(jr.slot_mp)).mean() >= 0.99
        assert (tr.inlier.numpy() == np.asarray(jr.inlier)).mean() >= 0.99
        assert (tr.visible.numpy() == np.asarray(jr.visible)).mean() >= 0.99
        assert abs(int(tr.n_matched) - int(jr.n_matched)) <= 1
        assert int(tr.n_matched) > 10  # both stages bind matches
        assert tr.slot_mp.dtype == torch.int32
    # stage 2 binds only snapshot rows (ids >= 1000 are its own)
    assert (tr2.slot_mp.numpy() < M2).all()
    Rg, tg = seq["poses"][1]
    C = -tr2.R.numpy().T @ tr2.t.numpy()
    assert np.linalg.norm(C - (-Rg.T @ tg)) < 0.02


def _step_problem(rng, M=150, N=200):
    """Map points seen by a camera near the identity, keypoints at their
    projections (+ noise and distractors), planted descriptors."""
    X = np.stack([rng.uniform(-2, 2, M), rng.uniform(-1.5, 1.5, M),
                  rng.uniform(2, 6, M)], -1).astype(np.float32)
    R, tt = (np.asarray(x) for x in jl.se3_exp(jnp.asarray(
        np.array([0.02, -0.01, 0.03, 0.01, -0.02, 0.015], np.float32))))
    Xc = X @ R.T + tt
    uv = np.stack([517.3 * Xc[:, 0] / Xc[:, 2] + 318.6,
                   516.5 * Xc[:, 1] / Xc[:, 2] + 255.3], -1)
    kpt = rng.uniform([0, 0], [640, 480], (N, 2)).astype(np.float32)
    kpt[:M] = uv + rng.normal(0, 0.5, (M, 2))
    md = rng.standard_normal((M, 64)).astype(np.float32)
    md /= np.linalg.norm(md, axis=1, keepdims=True)
    kd = rng.standard_normal((N, 64)).astype(np.float32)
    kd[:M] = md + 0.1 * rng.standard_normal((M, 64))
    kd /= np.linalg.norm(kd, axis=1, keepdims=True)
    perm = rng.permutation(N)
    kpt, kd = kpt[perm], kd[perm]
    octv = rng.integers(0, 3, N).astype(np.int32)
    dist = np.linalg.norm(X, axis=1).astype(np.float32)
    return dict(
        pos=X, md=md, vm=rng.uniform(size=M) > 0.05,
        ang=np.zeros(M, np.float32), moct=rng.integers(0, 3, M).astype(np.int32),
        dmin=0.7 * dist, dmax=1.3 * dist,
        normal=(X / dist[:, None]).astype(np.float32),
        kpt=kpt.astype(np.float32), kd=kd.astype(np.float32),
        vk=rng.uniform(size=N) > 0.05, kang=np.zeros(N, np.float32), koct=octv,
        ur=np.where(rng.uniform(size=N) > 0.5, kpt[:, 0] - 10.0, -1.0).astype(
            np.float32),
        isig=np.ones(N, np.float32), free=rng.uniform(size=N) > 0.1)


@pytest.mark.parametrize("config", ["motion", "local_scale", "octave_window",
                                    "band"])
def test_match_pose_step_matches_jax(rng, config):
    """The other configurations of one tracking step: widen-on-failure,
    the predicted-scale gate, the frame-to-frame octave window and the
    distance-band / viewing-angle gate."""
    p = _step_problem(rng)
    N = len(p["kpt"])
    flags = {"motion": dict(widen=True),
             "local_scale": dict(scale_gate=True, n_levels=8, widen=False),
             "octave_window": dict(n_levels=8, widen=True),
             "band": dict(band_gate=True, widen=True)}[config]
    prev_valid = np.zeros(N, bool)
    prev_valid[:5] = True
    prev_Xw = np.zeros((N, 3), np.float32)
    arrays = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
              p["pos"], p["md"], p["vm"], p["ang"], p["moct"], p["dmin"],
              p["dmax"], p["normal"], p["kpt"], p["kd"], p["vk"], p["kang"],
              p["koct"], p["ur"], p["isig"], p["free"], prev_Xw, prev_valid)
    # widen_below 200: the motion configuration takes the 2x pass
    scalars = (40.0, 8.0, 1000.0, 0.9, 200, 1.2, 640.0, 480.0)
    ref = jts.match_pose_step(
        *map(jnp.asarray, arrays), jc.Pinhole.from_list([517.3, 516.5, 318.6,
                                                         255.3]),
        *(jnp.float32(s) if isinstance(s, float) else jnp.int32(s)
          for s in scalars), **flags)
    got = tts.match_pose_step(
        *map(t, arrays), tc.Pinhole.from_list([517.3, 516.5, 318.6, 255.3]),
        *scalars, **flags)
    np.testing.assert_array_equal(got.visible.numpy(), np.asarray(ref.visible))
    assert (got.slot_mp.numpy() == np.asarray(ref.slot_mp)).mean() >= 0.99
    assert int(got.n_matched) == int(ref.n_matched) > 20
    assert (got.inlier.numpy() == np.asarray(ref.inlier)).mean() >= 0.99
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-4)


@pytest.mark.parametrize("with_angles", [True, False])
def test_rotation_consistency_matches_jax(rng, with_angles):
    M, N = 300, 250
    kang = rng.uniform(0, 2 * np.pi, N).astype(np.float32)
    idx = rng.integers(-1, N, M).astype(np.int32)
    mang = (kang[np.clip(idx, 0, None)] + 0.4).astype(np.float32)
    mang[rng.uniform(size=M) < 0.25] = rng.uniform(0, 2 * np.pi)
    if not with_angles:
        kang[:] = 0.0
        mang[:] = 0.0
    mask = (idx >= 0) & (rng.uniform(size=M) > 0.1)
    ref = jts._rotation_consistency(jnp.asarray(mang), jnp.asarray(kang),
                                    jnp.asarray(idx), jnp.asarray(mask))
    got = tts._rotation_consistency(t(mang), t(kang), t(idx), t(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if with_angles:
        assert 0 < got.sum() < mask.sum()
