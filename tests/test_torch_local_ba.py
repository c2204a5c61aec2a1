"""The PyTorch port's bundle adjustment against the JAX package: one padded
problem built in numpy goes through both ``bundle_adjust``s. Poses must
agree within 1e-4, the inlier classification exactly, and the points that
two or more inlier observations determine within 1e-4 (2e-3 on a problem
of mostly mono edges, where float32 rounding in the conjugate gradients
moves weakly determined depths). The problems are those of
``tests/test_local_ba.py`` with RGB-D (stereo) edges on part of the
observations, which fix the scale gauge that mono edges leave free. The
card's summation order (the ``SegmentPlan``'s, run on CPU tensors) meets
the same bars against the JAX solves, the points within 2e-3."""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager CPU ops are thousands of small tensors; with the
    test workers sharing the cores, torch's intra-op threads only contend
    (one thread runs these modules many times faster under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

import jax.numpy as jnp  # noqa: E402

from xfeatslam_tpu.ops import camera as jc  # noqa: E402
from xfeatslam_tpu.ops import lie as jl  # noqa: E402
from xfeatslam_tpu.optim import local_ba as jba  # noqa: E402
from xfeatslam_tpu_torch.ops import camera as tc  # noqa: E402
from xfeatslam_tpu_torch.optim import local_ba as tba  # noqa: E402

CAMP = [517.3, 516.5, 318.6, 255.3]
BF = 40.0


def make_problem(seed, n_cams=6, n_pts=300, noise_px=0.4, pose_noise=0.02,
                 point_noise=0.05, outlier_frac=0.0, stereo_frac=0.5,
                 pad_cams=8, pad_pts=512, pad_obs=4096):
    """Cameras along a small arc, points in front, observations with pixel
    noise (and outliers), perturbed starting poses and points; camera 0
    fixed. Returns the BAProblem fields as numpy arrays, the truth and
    the outlier mask."""
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = CAMP
    X_true = rng.uniform(-2.5, 2.5, (n_pts, 3)).astype(np.float32)
    X_true[:, 2] = rng.uniform(3.0, 8.0, n_pts)
    poses = [tuple(np.asarray(a) for a in jl.se3_exp(jnp.asarray(np.array(
        [0.12 * i, 0.02 * i, 0.01 * i, 0.01 * i, 0.03 * i, 0.005 * i],
        np.float32)))) for i in range(n_cams)]
    obs_cam, obs_pt, uv, ur = [], [], [], []
    for c, (R, t) in enumerate(poses):
        Xc = X_true @ R.T + t
        u = fx * Xc[:, 0] / Xc[:, 2] + cx
        v = fy * Xc[:, 1] / Xc[:, 2] + cy
        vis = (u >= 0) & (u < 640) & (v >= 0) & (v < 480) & (Xc[:, 2] > 0.1)
        for p in np.nonzero(vis)[0]:
            obs_cam.append(c)
            obs_pt.append(p)
            uv.append([u[p], v[p]])
            ur.append(u[p] - BF / Xc[p, 2])
    n_obs = len(obs_cam)
    noise = rng.normal(0, noise_px, (n_obs, 3)).astype(np.float32)
    uv = np.array(uv, np.float32) + noise[:, :2]
    ur = np.array(ur, np.float32) + noise[:, 2]
    stereo = rng.uniform(size=n_obs) < stereo_frac
    is_out = np.zeros(n_obs, bool)
    if outlier_frac > 0:
        sel = rng.choice(n_obs, int(outlier_frac * n_obs), replace=False)
        uv[sel] += rng.uniform(20, 60, (len(sel), 2)).astype(np.float32)
        is_out[sel] = True
    R0, t0 = [poses[0][0]], [poses[0][1]]
    for c in range(1, n_cams):
        dR, dt = (np.asarray(a) for a in jl.se3_exp(jnp.asarray(
            rng.normal(0, pose_noise, 6).astype(np.float32))))
        R0.append(dR @ poses[c][0])
        t0.append(dR @ poses[c][1] + dt)
    X0 = X_true + rng.normal(0, point_noise, X_true.shape).astype(np.float32)

    def pad(a, n, fill=0, dtype=None):
        a = np.asarray(a, dtype)
        out = np.full((n,) + a.shape[1:], fill, a.dtype)
        out[: len(a)] = a
        return out

    fixed = np.zeros(pad_cams, bool)
    fixed[0] = True
    fields = dict(
        R=pad(R0, pad_cams, 0, np.float32), t=pad(t0, pad_cams, 0, np.float32),
        fixed=fixed, cam_valid=pad(np.ones(n_cams, bool), pad_cams, False),
        X=pad(X0, pad_pts), p_valid=pad(np.ones(n_pts, bool), pad_pts, False),
        obs_cam=pad(obs_cam, pad_obs, 0, np.int32),
        obs_pt=pad(obs_pt, pad_obs, 0, np.int32),
        uv=pad(uv, pad_obs), ur=pad(np.where(stereo, ur, 0.0), pad_obs, 0,
                                    np.float32),
        stereo=pad(stereo, pad_obs, False),
        valid=pad(np.ones(n_obs, bool), pad_obs, False),
        inv_sigma2=np.ones(pad_obs, np.float32))
    return fields, X_true, is_out, n_obs


def _solve(fields, **kw):
    """The port's solve; with the card's sums (``_planned`` patched true)
    the problem carries its plan, as on the card."""
    prob = tba.BAProblem(**{k: torch.from_numpy(np.array(v))
                            for k, v in fields.items()})
    if tba._planned(prob.R):
        prob = prob._replace(plan=_plan_of(fields))
    return tba.bundle_adjust(prob, tc.Pinhole.from_list(CAMP), BF, **kw)


def run_both(fields, **kw):
    rj = jba.bundle_adjust(
        jba.BAProblem(**{k: jnp.asarray(v) for k, v in fields.items()}),
        jc.Pinhole.from_list(CAMP), jnp.float32(BF), **kw)
    return ({k: np.asarray(v) for k, v in rj._asdict().items()},
            {k: v.numpy() for k, v in _solve(fields, **kw)._asdict().items()})


def constrained(fields, res, n_obs):
    """Points with at least two inlier observations: those the problem
    determines (local mapping drops a point left with fewer)."""
    ok = res["inlier"][:n_obs]
    return np.bincount(fields["obs_pt"][:n_obs][ok],
                       minlength=len(fields["X"])) >= 2


# (problem, tolerance on the constrained points' X). Poses agree within
# 1e-4 everywhere. Where most edges are mono, a point's depth is weakly
# determined and float32 rounding in the 40-step CG moves it by up to
# ~1e-3 between the two implementations.
CASES = {
    "clean": (dict(noise_px=0.0, pose_noise=0.03, point_noise=0.08), 1e-4),
    "noisy": (dict(noise_px=0.5, pose_noise=0.03, point_noise=0.08), 1e-4),
    "outliers": (dict(noise_px=0.4, outlier_frac=0.15, stereo_frac=1.0),
                 1e-4),
    "mono_heavy": (dict(stereo_frac=0.2), 2e-3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bundle_adjust_matches_jax(case):
    _check_against_jax(case, CASES[case][1])


def _check_against_jax(case, x_tol):
    fields, X_true, is_out, n_obs = make_problem(0, **CASES[case][0])
    j, t = run_both(fields)
    for k in ("R", "t"):
        np.testing.assert_allclose(t[k], j[k], atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(t["inlier"], j["inlier"])
    c = constrained(fields, j, n_obs)
    assert c.sum() > 250
    np.testing.assert_allclose(t["X"][c], j["X"][c], atol=x_tol)
    np.testing.assert_allclose(t["chi2"][:n_obs], j["chi2"][:n_obs],
                               rtol=1e-3, atol=1e-2)
    # and the solve moved the points toward the truth
    def err(X):
        return np.median(np.linalg.norm(X[:300] - X_true, axis=1))

    assert err(t["X"]) < 0.7 * err(fields["X"])
    if case == "outliers":
        inl = t["inlier"][:n_obs]
        assert inl[~is_out].mean() > 0.9 and inl[is_out].mean() < 0.05


def test_budgeted_rounds_match_jax():
    """The rounds local mapping runs: the robust first stage alone, then
    one budgeted tick (prune, 5 iterations) from its result."""
    _check_rounds_against_jax(1e-4)


def _check_rounds_against_jax(x_tol):
    fields, _, _, n_obs = make_problem(0, noise_px=0.5, pose_noise=0.03,
                                       point_noise=0.08)
    j1, t1 = run_both(fields, stage_iters=(5, 0))
    fields2 = dict(fields, R=j1["R"], t=j1["t"], X=j1["X"])
    j2, t2 = run_both(fields2, stage_iters=(0, 5))
    for j, t in ((j1, t1), (j2, t2)):
        for k in ("R", "t"):
            np.testing.assert_allclose(t[k], j[k], atol=1e-4, err_msg=k)
        np.testing.assert_array_equal(t["inlier"], j["inlier"])
        c = constrained(fields, j, n_obs)
        np.testing.assert_allclose(t["X"][c], j["X"][c], atol=x_tol)
        # the fixed camera and the padding stay where they were
        np.testing.assert_array_equal(t["R"][0], fields["R"][0])
        np.testing.assert_array_equal(t["t"][6:], fields["t"][6:])


def _plan_of(fields):
    return tba.segment_plan(fields["obs_cam"], fields["obs_pt"],
                            fields["valid"], len(fields["R"]),
                            len(fields["X"]))


def test_segment_plan_covers_each_valid_observation_once(monkeypatch):
    fields, _, _, n_obs = make_problem(0)
    plan = _plan_of(fields)
    O = len(fields["obs_cam"])
    cam_rows, cam_chunks, pt_rows = (x.numpy() for x in plan)
    assert cam_rows.shape[1] == tba.SEGMENT_CHUNK
    for rows in (cam_rows, pt_rows):
        used = rows[rows < O]
        # every valid row once, no padded row
        np.testing.assert_array_equal(np.sort(used), np.arange(n_obs))
    # each camera's chunks hold its rows in observation order
    for c in range(len(fields["R"])):
        chunks = cam_chunks[c][cam_chunks[c] < len(cam_rows)]
        rows = cam_rows[chunks].reshape(-1)
        rows = rows[rows < O]
        np.testing.assert_array_equal(
            rows, np.nonzero(fields["obs_cam"][:n_obs] == c)[0])
    # each point's row lists its observations in order
    for p in (0, 7, 299):
        rows = pt_rows[p][pt_rows[p] < O]
        np.testing.assert_array_equal(
            rows, np.nonzero(fields["obs_pt"][:n_obs] == p)[0])
    # the card's sums (the plan's order) equal index_add_'s to float32
    # rounding
    vals = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (O, 9)).astype(np.float32)) * torch.from_numpy(fields["valid"])[:, None]
    args = (plan, torch.from_numpy(fields["obs_cam"]).long(),
            torch.from_numpy(fields["obs_pt"]).long(), len(fields["R"]),
            len(fields["X"]))
    ref = tba._segment_sums(vals, vals, *args)
    monkeypatch.setattr(tba, "_planned", lambda t: True)
    got = tba._segment_sums(vals, vals, *args)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-4)


@pytest.mark.parametrize("card", [False, True], ids=["cpu", "card_sums"])
def test_two_solves_are_bit_identical(card, monkeypatch):
    """Each formulation twice; ``card`` runs the card's (the plan's
    segment sums) on CPU tensors."""
    if card:
        monkeypatch.setattr(tba, "_planned", lambda t: True)
    fields, _, _, _ = make_problem(1, outlier_frac=0.1)
    a, b = _solve(fields, stage_iters=(5, 0)), _solve(fields,
                                                     stage_iters=(5, 0))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("case", list(CASES))
def test_card_sums_match_jax(case, monkeypatch):
    """The card's formulation on CPU tensors against the JAX package
    directly, at the JAX bars with the constrained points within 2e-3."""
    monkeypatch.setattr(tba, "_planned", lambda t: True)
    _check_against_jax(case, max(CASES[case][1], 2e-3))


def test_card_sums_budgeted_rounds_match_jax(monkeypatch):
    monkeypatch.setattr(tba, "_planned", lambda t: True)
    _check_rounds_against_jax(2e-3)


@pytest.mark.slow
@pytest.mark.parametrize("stage_iters", [(5, 0), (0, 5)])
def test_full_bucket_against_jax(stage_iters, monkeypatch):
    """``chip_smoke.full_ba_problem`` (32 cameras, 4096 points, 16384
    observations), the bucket the card's solve is timed and checked on,
    through the JAX package and both of the port's orders on the CPU. It
    prints each gap (``chip_smoke.ba_gap``) and holds what the problem
    determines: poses within 1e-4, at most one inlier flipped. Its weakly
    seen points (two mono inliers, cameras on a short arc) move with the
    rounding, in JAX's own order too. Run it with ``pytest -m slow -s -k
    full_bucket``."""
    from chip_smoke import ba_gap, full_ba_problem

    cam = tc.Pinhole.from_list(CAMP)
    prob = full_ba_problem(cam, BF, "cpu")
    rj = jba.bundle_adjust(
        jba.BAProblem(**{k: jnp.asarray(v.numpy())
                         for k, v in prob._asdict().items() if k != "plan"}),
        jc.Pinhole.from_list(CAMP), jnp.float32(BF), stage_iters=stage_iters)
    rj = tba.BAResult(**{k: torch.from_numpy(np.array(v))
                         for k, v in rj._asdict().items()})
    gaps = {"JAX's order": tba.bundle_adjust(prob._replace(plan=None), cam,
                                             BF, stage_iters=stage_iters)}
    monkeypatch.setattr(tba, "_planned", lambda t: True)
    gaps["the card's order"] = tba.bundle_adjust(prob, cam, BF,
                                                 stage_iters=stage_iters)
    for name, res in gaps.items():
        gap = ba_gap(res, rj, prob)
        print(f"\nfull bucket {stage_iters}, the port in {name} against "
              f"JAX: {gap}")
        assert gap["R"] <= 1e-4 and gap["t"] <= 1e-4
        assert gap["inliers_differ"] <= 1


def test_local_ba_graph_needs_cuda():
    with pytest.raises(ValueError, match="CUDA"):
        tba.LocalBAGraph("cpu")


# ---------------------------------------------------------------------------
# the kernels' wrapper (ops/cuda_kernels.local_ba): CPU dispatch, input
# checks and the arguments the library gets, driven here through its CUDA
# branch with the library call recorded (the kernels run on the card only:
# chip_smoke.py holds them to the plain twin there)

from xfeatslam_tpu_torch.ops import cuda_kernels as ck  # noqa: E402


def _card_problem():
    fields, _, _, _ = make_problem(2, outlier_frac=0.1)
    prob = tba.BAProblem(**{k: torch.from_numpy(np.array(v))
                            for k, v in fields.items()})
    return prob._replace(plan=_plan_of(fields))


def test_cpu_tensors_take_the_plain_twin():
    """On CPU tensors ``bundle_adjust`` is the plain twin, bit for bit, and
    launches nothing."""
    prob = _card_problem()._replace(plan=None)
    cam = tc.Pinhole.from_list(CAMP)
    ck.reset_launch_counts()
    a = tba.bundle_adjust(prob, cam, BF, stage_iters=(2, 1))
    b = tba.bundle_adjust_plain(prob, cam, BF, stage_iters=(2, 1))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert ck.launch_counts()["local_ba"] == 0


@pytest.fixture
def as_if_on_cuda(monkeypatch):
    """The wrapper's CUDA branch on CPU tensors: the library's calls are
    recorded; the solve writes its one launch to its count."""
    calls = []

    def launch(fn, dev, *a):
        calls.append((fn, a))
        ctypes.c_int.from_address(a[-1]).value = 1

    monkeypatch.setattr(ck, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(ck, "_launch", launch)
    monkeypatch.setattr(ck, "_entry", lambda fn: {
        "local_ba_scratch_floats": lambda *a: calls.append((fn, a)) or 1000
    }[fn])
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 0)
    return calls


BAD_INPUTS = {
    "obs_cam int64": (lambda p: p._replace(obs_cam=p.obs_cam.long()),
                      TypeError, "obs_cam"),
    "R (C,9)": (lambda p: p._replace(R=p.R.reshape(-1, 9)), ValueError,
                "R: expected shape"),
    "valid as uint8": (lambda p: p._replace(valid=p.valid.to(torch.uint8)),
                       TypeError, "valid"),
    "chunk width 64": (lambda p: p._replace(plan=p.plan._replace(
        cam_rows=p.plan.cam_rows[:, :64].contiguous())), ValueError,
        "cam_rows"),
    "pt_rows int32": (lambda p: p._replace(plan=p.plan._replace(
        pt_rows=p.plan.pt_rows.int())), TypeError, "pt_rows"),
    "no plan": (lambda p: p._replace(plan=None), ValueError, "SegmentPlan"),
}


@pytest.mark.parametrize("case", list(BAD_INPUTS))
def test_wrapper_checks_raise_before_the_library(as_if_on_cuda, case):
    bad, err, match = BAD_INPUTS[case]
    with pytest.raises(err, match=match):
        ck.local_ba(bad(_card_problem()), tc.Pinhole.from_list(CAMP), BF)
    assert as_if_on_cuda == []


def test_wrapper_refuses_negative_iterations(as_if_on_cuda):
    with pytest.raises(ValueError, match=">= 0"):
        ck.local_ba(_card_problem(), tc.Pinhole.from_list(CAMP), BF,
                    stage_iters=(5, -1))
    assert as_if_on_cuda == []


def test_wrapper_passes_the_kernels_their_arguments(as_if_on_cuda):
    prob = _card_problem()
    C, P, O = prob.R.shape[0], prob.X.shape[0], prob.obs_cam.shape[0]
    NCH, NW = prob.plan.cam_rows.shape[0], prob.plan.cam_chunks.shape[1]
    PW = prob.plan.pt_rows.shape[1]
    before = ck.local_ba.launches
    R, t, X, inlier, chi2 = ck.local_ba(prob, tc.Pinhole.from_list(CAMP),
                                        BF, stage_iters=(5, 0), cg_iters=7,
                                        huber=False)
    assert ck.local_ba.launches == before + 1
    (fn0, size_args), (fn, a) = as_if_on_cuda
    assert fn0 == "local_ba_scratch_floats"
    assert size_args == (C, P, O, NCH, PW, 5)
    assert fn == "local_ba"
    ptrs, ints, floats = a[:22], a[22:32], a[32:37]
    assert ints == (C, P, O, NCH, NW, PW, 5, 0, 7, 0)
    np.testing.assert_allclose(floats, CAMP + [BF])
    # the inputs, then the outputs and scratch the wrapper allocated
    assert ptrs[0] == prob.R.data_ptr() and ptrs[13] == \
        prob.plan.cam_rows.data_ptr()
    assert ptrs[16:21] == tuple(x.data_ptr()
                                for x in (R, t, X, inlier, chi2))
    assert (R.shape, t.shape, X.shape, inlier.dtype, chi2.shape) == (
        (C, 3, 3), (C, 3), (P, 3), torch.bool, (O,))


@pytest.mark.parametrize("stage_iters,cg,n", [
    ((5, 0), 40, 1), ((0, 5), 40, 1), ((10, 10), 40, 1),
    ((0, 0), 40, 1), ((2, 3), 7, 1)])
def test_launch_count_formula(stage_iters, cg, n):
    """The launches of one solve: csrc/local_ba.cu's one persistent
    cooperative launch, whatever the stages and CG steps."""
    assert ck.local_ba_launches(stage_iters, cg) == n
