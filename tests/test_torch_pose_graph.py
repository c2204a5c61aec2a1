"""The PyTorch port's Sim3 pose graph (``optim/pose_graph.py``) against the
JAX package on ``tests/test_solvers.py::TestPoseGraph.test_loop_correction``'s
problem: 12 keyframes on a circle, drifted odometry edges and one loop
edge. Both optimizers must give the same poses within 1e-4 (float32 sums
in another order), and the port must meet the JAX test's own bars. The
4-DoF inertial mode is held to JAX's on
``TestPoseGraph.test_loop_correction_4dof``'s problem the same way."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from xfeatslam_tpu.ops import lie as jl  # noqa: E402
from xfeatslam_tpu.optim import pose_graph as jpg  # noqa: E402
from xfeatslam_tpu_torch.optim import pose_graph as tpg  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def loop_problem(C=12):
    """TestPoseGraph.test_loop_correction's problem as numpy arrays, with
    the ground-truth translations and the drift before optimization."""
    s_gt, R_gt, t_gt = [], [], []
    for i in range(C):
        ang = 2 * np.pi * i / C
        xi = np.array([np.sin(ang), 0.0, np.cos(ang) - 1.0,
                       0.0, ang if ang < np.pi else ang - 2 * np.pi, 0.0],
                      np.float32)
        R, t = jl.se3_exp(jnp.asarray(xi))
        s_gt.append(1.0)
        R_gt.append(np.asarray(R))
        t_gt.append(np.asarray(t))
    s_gt = np.array(s_gt, np.float32)
    R_gt, t_gt = np.stack(R_gt), np.stack(t_gt)

    def rel(i, j):
        inv = jl.sim3_inverse(jnp.float32(s_gt[i]), jnp.asarray(R_gt[i]),
                              jnp.asarray(t_gt[i]))
        return jl.sim3_compose(jnp.float32(s_gt[j]), jnp.asarray(R_gt[j]),
                               jnp.asarray(t_gt[j]), *inv)

    edges = [(i, i + 1) for i in range(C - 1)] + [(0, C - 1)]
    m_s, m_R, m_t, ei, ej = [], [], [], [], []
    drift = np.array([0.01, 0.004, -0.008, 0.002, 0.004, -0.002, 0.004],
                     np.float32)
    for k, (i, j) in enumerate(edges):
        ms, mR, mt = rel(i, j)
        if k < C - 1:
            ds, dR, dt = jl.sim3_exp(jnp.asarray(drift))
            ms, mR, mt = jl.sim3_compose(ds, dR, dt, ms, mR, mt)
        m_s.append(float(ms))
        m_R.append(np.asarray(mR))
        m_t.append(np.asarray(mt))
        ei.append(i)
        ej.append(j)
    s0, R0, t0 = [1.0], [R_gt[0]], [t_gt[0]]
    for k in range(C - 1):
        sc, Rc, tc = jl.sim3_compose(
            jnp.float32(m_s[k]), jnp.asarray(m_R[k]), jnp.asarray(m_t[k]),
            jnp.float32(s0[-1]), jnp.asarray(R0[-1]), jnp.asarray(t0[-1]))
        s0.append(float(sc))
        R0.append(np.asarray(Rc))
        t0.append(np.asarray(tc))
    fixed = np.zeros(C, bool)
    fixed[0] = True
    arrays = dict(
        s=np.array(s0, np.float32), R=np.stack(R0), t=np.stack(t0),
        fixed=fixed, cam_valid=np.ones(C, bool),
        edge_i=np.asarray(ei, np.int32), edge_j=np.asarray(ej, np.int32),
        m_s=np.asarray(m_s, np.float32), m_R=np.stack(m_R),
        m_t=np.stack(m_t), e_valid=np.ones(len(ei), bool))
    drift_before = np.linalg.norm(arrays["t"][-1] - t_gt[-1])
    return arrays, t_gt, drift_before


@pytest.fixture(scope="module")
def solved():
    arrays, t_gt, drift_before = loop_problem()
    ref = jpg.optimize_pose_graph(jpg.PoseGraphProblem(
        **{k: jnp.asarray(v) for k, v in arrays.items()}))
    prob = tpg.PoseGraphProblem(**{k: torch.from_numpy(v)
                                   for k, v in arrays.items()})
    got = tpg.optimize_pose_graph(prob)
    return ref, got, prob, t_gt, drift_before


def test_loop_correction_matches_jax(solved):
    ref, got, *_ = solved
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)


def test_loop_correction_bars(solved):
    """TestPoseGraph.test_loop_correction's own bars on the port."""
    _, got, _, t_gt, drift_before = solved
    err = np.linalg.norm(got[2].numpy() - t_gt, axis=-1)
    assert err[-1] < 0.3 * drift_before, (err[-1], drift_before)
    assert err.max() < drift_before


def test_padded_edges_and_vertices_match_jax(solved):
    """The problem padded as loop closing pads it (power-of-two buckets:
    invalid edges, fixed invalid vertices) gives JAX's unpadded poses."""
    ref = solved[0]
    arrays, _, _ = loop_problem()
    C, E = 16, 16
    pad = dict(arrays)
    n_c, n_e = len(arrays["s"]), len(arrays["edge_i"])

    def grow(a, n, fill):
        out = np.full((n,) + a.shape[1:], fill, a.dtype)
        out[: len(a)] = a
        return out

    for k, fill in (("s", 1.0), ("t", 0.0), ("cam_valid", False)):
        pad[k] = grow(arrays[k], C, fill)
    pad["R"] = grow(arrays["R"], C, 0.0)
    pad["R"][n_c:] = np.eye(3)
    pad["fixed"] = grow(arrays["fixed"], C, True)
    for k, fill in (("edge_i", 0), ("edge_j", 0), ("m_s", 1.0), ("m_t", 0.0),
                    ("e_valid", False)):
        pad[k] = grow(arrays[k], E, fill)
    pad["m_R"] = grow(arrays["m_R"], E, 0.0)
    pad["m_R"][n_e:] = np.eye(3)
    got = tpg.optimize_pose_graph(tpg.PoseGraphProblem(
        **{k: torch.from_numpy(v) for k, v in pad.items()}))
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy()[:n_c], np.asarray(a), atol=1e-4)
    # the padding stays where it was
    np.testing.assert_array_equal(got[0].numpy()[n_c:], 1.0)


def loop_problem_4dof(C=12):
    """TestPoseGraph.test_loop_correction_4dof's problem: the same circle,
    the odometry drifting in yaw (world z) and translation only."""
    R_gt, t_gt = [], []
    for i in range(C):
        ang = 2 * np.pi * i / C
        xi = np.array([np.sin(ang), 0.0, np.cos(ang) - 1.0,
                       0.0, ang if ang < np.pi else ang - 2 * np.pi, 0.0],
                      np.float32)
        R, t = jl.se3_exp(jnp.asarray(xi))
        R_gt.append(np.asarray(R))
        t_gt.append(np.asarray(t))
    R_gt, t_gt = np.stack(R_gt), np.stack(t_gt)
    edges = [(i, i + 1) for i in range(C - 1)] + [(0, C - 1)]
    drift = np.array([0.0, 0.012, -0.008, 0.002, 0.0, -0.006, 0.0],
                     np.float32)
    m_s, m_R, m_t = [], [], []
    for k, (i, j) in enumerate(edges):
        inv = jl.sim3_inverse(jnp.float32(1.0), jnp.asarray(R_gt[i]),
                              jnp.asarray(t_gt[i]))
        ms, mR, mt = jl.sim3_compose(jnp.float32(1.0), jnp.asarray(R_gt[j]),
                                     jnp.asarray(t_gt[j]), *inv)
        if k < C - 1:
            ms, mR, mt = jl.sim3_compose(*jl.sim3_exp(jnp.asarray(drift)),
                                         ms, mR, mt)
        m_s.append(float(ms))
        m_R.append(np.asarray(mR))
        m_t.append(np.asarray(mt))
    R0, t0 = [R_gt[0]], [t_gt[0]]
    for k in range(C - 1):
        _, Rc, tc = jl.sim3_compose(
            jnp.float32(m_s[k]), jnp.asarray(m_R[k]), jnp.asarray(m_t[k]),
            jnp.float32(1.0), jnp.asarray(R0[-1]), jnp.asarray(t0[-1]))
        R0.append(np.asarray(Rc))
        t0.append(np.asarray(tc))
    fixed = np.zeros(C, bool)
    fixed[0] = True
    arrays = dict(
        s=np.ones(C, np.float32), R=np.stack(R0), t=np.stack(t0),
        fixed=fixed, cam_valid=np.ones(C, bool),
        edge_i=np.asarray([e[0] for e in edges], np.int32),
        edge_j=np.asarray([e[1] for e in edges], np.int32),
        m_s=np.asarray(m_s, np.float32), m_R=np.stack(m_R),
        m_t=np.stack(m_t), e_valid=np.ones(len(edges), bool))
    return arrays, t_gt, np.linalg.norm(arrays["t"][-1] - t_gt[-1])


def test_4dof_mode_matches_jax():
    """The inertial essential graph (yaw and translation vertices, the
    matLambda-weighted SE3 edges) against JAX's on
    test_loop_correction_4dof's problem, within 1e-4, and that test's bars
    on the port: the scale untouched, the drift redistributed, every update
    a pure world-z rotation."""
    arrays, t_gt, drift_before = loop_problem_4dof()
    ref = jpg.optimize_pose_graph(jpg.PoseGraphProblem(
        **{k: jnp.asarray(v) for k, v in arrays.items()}), mode="4dof")
    got = tpg.optimize_pose_graph(tpg.PoseGraphProblem(
        **{k: torch.from_numpy(v) for k, v in arrays.items()}), mode="4dof")
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)
    s1, R1, t1 = (x.numpy() for x in got)
    assert np.allclose(s1, 1.0)
    err = np.linalg.norm(t1 - t_gt, axis=-1)
    assert err[-1] < 0.3 * drift_before, (err[-1], drift_before)
    for i in range(len(s1)):
        dW = R1[i].T @ arrays["R"][i]
        assert abs(dW[2, 2] - 1.0) < 1e-5, (i, dW)
        assert np.abs([dW[0, 2], dW[1, 2], dW[2, 0], dW[2, 1]]).max() < 1e-4
    with pytest.raises(ValueError, match="mode"):
        tpg.optimize_pose_graph(tpg.PoseGraphProblem(
            **{k: torch.from_numpy(v) for k, v in arrays.items()}),
            mode="se3")
