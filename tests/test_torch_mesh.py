"""The port's mesh (``xfeatslam_tpu_torch/parallel/mesh.py``), its data- and
tensor-parallel training step and pool trainer, and its sharded pipeline,
on a (4, 2) mesh of 8 gloo ranks on the CPU, against the port's one-device
code and the JAX package's.

The 8 ranks (``tests/torch_mesh_ranks.py``, no JAX) run once for every case
of this file: they meet through a file under the test's temporary
directory, read the inputs this process writes and write their results as
npz files. This process computes the references meanwhile: the port's
one-device step, pool trainer and pipeline, and JAX's. The cases mirror
``tests/test_parallel.py`` at its shapes (8 images of 64x96, 128
keypoints) and bars: a step on the mesh equals the one-device step (loss
within 1e-4 relative, every parameter within atol 5e-5 and rtol 5e-4), on
JAX's identity batch and on a batch whose valid pixels differ from image
to image; the sharded pipeline's keypoints within 1e-5 and its match masks
equal. A mesh of one rank gives the one-device results bit for bit."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from xfeatslam_tpu.parallel import batched as jb  # noqa: E402
from xfeatslam_tpu.parallel import mesh as jmesh  # noqa: E402
from xfeatslam_tpu.parallel import train as jt  # noqa: E402
from xfeatslam_tpu_torch.models import weights as tw  # noqa: E402
from xfeatslam_tpu_torch.parallel import batched as tb  # noqa: E402
from xfeatslam_tpu_torch.parallel import mesh as tm  # noqa: E402
from xfeatslam_tpu_torch.parallel import train as tt  # noqa: E402
from torch_mesh_ranks import (ATOL, GRAD_GAP, LOSS_RTOL, RTOL,  # noqa: E402
                              grad_gap, weights_off)

RANKS = 8
HERE = os.path.dirname(os.path.abspath(__file__))
RANK_PROGRAM = os.path.join(HERE, "torch_mesh_ranks.py")
NPZ = os.path.join(os.path.dirname(HERE), "weights", "xfeat_synthetic.npz")
# the rank program's learning rate and keypoint count
LR, K = 1e-3, 128
CASES = ("identity", "unequal")
KEYS = ("img_a", "img_b", "corr_px", "px_valid")
AUX = ("nce", "kp", "rel", "loc")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_inputs():
    """The shipped weights, and as numpy arrays: JAX's identity batch of 8
    noise images (test_parallel's), the same batch with an invalid band of
    another width in each image, a pool of both and two steps' rows into
    it, and 8 noise frames for the pipeline.

    test_parallel starts from JAX's random initialization. The port is held
    to JAX from the shipped weights, as test_torch_train holds it: from the
    random initialization on these noise images many ReLU inputs lie within
    float32 rounding of zero, and the two packages' one-device gradients
    differ there by up to ~1% of a leaf's max abs (1.5e-5 from the shipped
    weights)."""
    params = tw.load_npz_params(NPZ)
    rng = np.random.default_rng(2)
    imgs = rng.random((8, 64, 96, 1), np.float32)
    identity = {k: np.array(v) for k, v in
                jt.identity_pair_batch(jnp.asarray(imgs)).items()}
    unequal = dict(identity)
    valid = np.ones((8, 64, 96), bool)
    for i in range(8):
        valid[i, :, :12 * i] = False  # 0 to 84 invalid columns
        valid[i, 8 * (i % 3):8 * (i % 3) + 16, 40:] = False
    unequal["px_valid"] = valid
    data = {f"{c}/{k}": b[k] for c, b in (("identity", identity),
                                          ("unequal", unequal)) for k in KEYS}
    for k in KEYS:
        data[f"pool/{k}"] = np.concatenate([identity[k], unequal[k]])
    data["pool/idx"] = rng.integers(0, 16, (2, 8))
    data["frames"] = np.random.default_rng(1).random((8, 64, 96, 1),
                                                     np.float32)
    return params, data


class Job:
    """The 8 ranks, started at once; ``result()`` waits for them."""

    def __init__(self, root):
        self.root = root
        self.params, self.data = make_inputs()
        tw.save_npz(os.path.join(root, "params.npz"), self.params)
        np.savez(os.path.join(root, "inputs.npz"), **self.data)
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        self.logs = [open(os.path.join(root, f"rank{r}.log"), "w")
                     for r in range(RANKS)]
        self.procs = [subprocess.Popen(
            [sys.executable, RANK_PROGRAM, str(r), str(RANKS), root],
            stdout=log, stderr=subprocess.STDOUT, env=env)
            for r, log in enumerate(self.logs)]
        self._ranks = None

    def result(self, timeout=300):
        """Every rank's npz, once all have exited 0."""
        if self._ranks is None:
            try:
                rcs = [p.wait(timeout=timeout) for p in self.procs]
            finally:
                self.close()
            for r, rc in enumerate(rcs):
                with open(os.path.join(self.root, f"rank{r}.log")) as f:
                    log = f.read()[-3000:]
                assert rc == 0, f"rank {r} exited {rc}:\n{log}"
            self._ranks = []
            for r in range(RANKS):
                with np.load(os.path.join(self.root, f"rank{r}.npz")) as f:
                    self._ranks.append(dict(f))
        return self._ranks

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in self.logs:
            log.close()


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    j = Job(str(tmp_path_factory.mktemp("mesh")))
    yield j
    j.close()


def batch_of(job, case):
    return {k: torch.from_numpy(job.data[f"{case}/{k}"]) for k in KEYS}


def params_of(rank, prefix):
    """A rank's npz entries under ``prefix`` as {name.i.w: array}."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in rank.items() if k.startswith(prefix + "/")}


def flat(params):
    return {f"{tw._prefix(p)}.{k}": tw._node(params, p)[k]
            for p in tw._paths() for k in ("w", "b")}


def held(got, want):
    """test_parallel's bars on every parameter."""
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=ATOL, rtol=RTOL,
                                   err_msg=k)


def one_device_step(job, case, mesh=None):
    init_fn, step_fn = tt.make_train_step(tt.adam(LR), mesh=mesh)
    model, opt = init_fn(tw.trainable(job.params, device="cpu"))
    model, opt, loss, aux = step_fn(model, opt, batch_of(job, case))
    return float(loss), {k: float(v) for k, v in aux.items()}, \
        flat(tw.to_params(model)), flat(tw.grads_to_params(model))


@pytest.fixture(scope="module")
def single(job):
    """The port's one-device step on each whole batch."""
    return {case: one_device_step(job, case) for case in CASES}


@pytest.fixture(scope="module")
def jax_steps(job):
    """JAX's one-device ``make_train_step`` on each batch: loss, the
    gradients and the parameters after the step."""
    mesh = jmesh.make_mesh(n_devices=1)
    init_fn, step_fn = jt.make_train_step(mesh, optax.adam(LR))
    grad = jax.jit(jax.grad(lambda p, b: jt.loss_fn(p, b)[0]))
    out = {}
    for case in CASES:
        b = {k: jnp.asarray(job.data[f"{case}/{k}"]) for k in KEYS}
        p, o = init_fn(job.params)
        p, o, loss, _ = step_fn(p, o, b)
        out[case] = (float(loss), flat(jax.tree_util.tree_map(
            np.asarray, grad(job.params, b))), flat(jax.tree_util.tree_map(
                np.asarray, p)))
    return out


def test_mesh_layout(job):
    """(a) make_mesh over 8 ranks is {data: 4, model: 2}, data-major as
    JAX's reshape; make_mesh(1) is the process alone; another n_devices and
    a batch the data axis does not divide raise."""
    ranks = job.result()
    for r, res in enumerate(ranks):
        assert res["shape"].tolist() == [4, 2]
        assert res["coords"].tolist() == [r // 2, r % 2]
        assert res["data_peers"].tolist() == [r % 2 + 2 * d for d in range(4)]
        assert res["model_peers"].tolist() == [r - r % 2, r - r % 2 + 1]
        assert res["one"].tolist() == [1, 0, 0, 1]
        np.testing.assert_array_equal(res["one_shard"], np.arange(8.0))
        np.testing.assert_array_equal(res["shard"],
                                      np.arange(8.0)[2 * (r // 2):][:2])
        np.testing.assert_array_equal(res["gathered"], np.arange(8.0))
        assert "8 ranks" in str(res["bad_n"])
        assert "does not split" in str(res["bad_b"])
    # no process group here: the mesh is this process alone
    assert tm.make_mesh(device="cpu").size == 1
    assert tm.make_mesh(1, device="cpu").shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        tm.make_mesh(2, device="cpu")


@pytest.mark.parametrize("case", CASES)
def test_train_step_sharded_matches_single_device(job, single, case):
    """(b) One step on the (4, 2) mesh equals the one-device step on the
    whole batch, at test_parallel's bars, and its gradients are within
    1e-3 of each leaf's max abs of the one-device step's; every rank holds
    the same weights. On the unequal batch the data ranks' valid counts
    differ, so a mean of the ranks' losses would miss."""
    ranks = job.result()
    loss, aux, want, grads = single[case]
    got = ranks[0]
    assert abs(float(got[f"{case}/loss"]) - loss) <= LOSS_RTOL * max(
        1.0, abs(loss))
    np.testing.assert_allclose(got[f"{case}/aux"], [aux[k] for k in AUX],
                               rtol=1e-4, atol=1e-7)
    held(params_of(got, f"{case}/params"), want)
    gap, leaf = grad_gap(params_of(got, f"{case}/grads"), grads)
    assert gap <= GRAD_GAP, (leaf, gap)
    assert max(float(r[f"{case}/spread"]) for r in ranks) <= 1e-6
    if case == "unequal":
        v = job.data["unequal/px_valid"].reshape(4, -1).sum(1)
        assert len(set(v.tolist())) == 4  # the shards' valid counts differ


@pytest.mark.parametrize("case", CASES)
def test_train_step_sharded_matches_jax(job, jax_steps, case):
    """(b) The mesh's gathered weights after one step against JAX's
    one-device ``make_train_step``: the loss within 1e-4 relative
    (test_torch_train's bar), and each weight within 2e-5 of its leaf's max
    abs (test_torch_train's Adam bar) wherever JAX's gradient is above the
    1e-4 of the leaf's max that the gradients agree to; below it Adam's
    first step, lr * g / (|g| + eps), takes its sign from rounding, and the
    weight moves by at most 2 lr either way."""
    ranks = job.result()
    loss, grads, want = jax_steps[case]
    assert abs(float(ranks[0][f"{case}/loss"]) - loss) <= 1e-4 * abs(loss)
    got = params_of(ranks[0], f"{case}/params")
    for k, w in want.items():
        g = np.abs(grads[k])
        decided = g > 1e-4 * g.max()
        err = np.abs(got[k] - w)
        scale = np.abs(w).max()
        assert (err[decided] <= 2e-5 * scale + 1e-12).all(), (k, err.max())
        assert (err <= 2 * LR + 2e-5 * scale).all(), (k, err.max())


def test_wide_layers_partitioned(job):
    """(c) Each model rank holds half of every wide tensor's output
    features, block_fusion_final's among them; its gathered weights are
    the whole ones exactly; strict refuses a 127-channel block5, naming it,
    and without strict it stays whole."""
    ranks = job.result()
    whole = flat(job.params)
    for res in ranks:
        names = [str(n) for n in res["split_names"]]
        weights = [n for n in names if n.endswith("weight")]
        assert len(weights) >= 6, names
        assert "block_fusion_final.weight" in names
        assert all(n.startswith(tt.WIDE_LAYERS) for n in names)
        for part, full in res["split_rows"]:
            assert part * 2 == full
        for k, v in params_of(res, "round_trip").items():
            np.testing.assert_array_equal(v, whole[k], err_msg=k)
        assert "block5" in str(res["strict"])
        assert str(res["lenient"]) == "whole"
    # every conv and linear of the wide layers, and no other
    model = tw.trainable(job.params, device="cpu")
    assert sum(n.startswith(tt.WIDE_LAYERS) for n, _ in
               model.named_parameters()) == len(ranks[0]["split_names"])


def test_pool_trainer_sharded_matches_single_device(job):
    """(d) Two pool-trainer steps with augmentation on the mesh equal the
    one-device trainer's: the mean loss within 1e-4 relative and the
    weights at test_parallel's bars, every rank drawing the whole batch's
    augmentation and taking its rows. Over two steps a few weights had a
    first-step gradient within float32 rounding of zero (at most 1e-6 of
    its leaf's max abs, ~1e-9 for some): Adam's normalized step,
    lr * g / (|g| + 1e-8), takes its sign and size from that rounding, so
    each such weight is held within 2 lr a step, and at most 10 of them."""
    init_fn, run_fn = tt.make_pool_trainer(tt.adam(LR), steps_per_call=2,
                                           augment=True)
    model, opt = init_fn(tw.trainable(job.params, device="cpu"))
    pool = {k: torch.from_numpy(job.data[f"pool/{k}"]) for k in KEYS}
    idx = torch.from_numpy(job.data["pool/idx"])
    model, opt, loss, _ = run_fn(model, opt, pool, idx,
                                 torch.Generator().manual_seed(3))
    want = flat(tw.to_params(model))
    # the same two steps one at a time, for each step's gradients
    init_fn, run_fn = tt.make_pool_trainer(tt.adam(LR), steps_per_call=1,
                                           augment=True)
    model, opt = init_fn(tw.trainable(job.params, device="cpu"))
    gen, grads = torch.Generator().manual_seed(3), []
    for s in range(2):
        model, opt, _, _ = run_fn(model, opt, pool, idx[s:s + 1], gen)
        grads.append(flat(tw.grads_to_params(model)))
    for k, v in flat(tw.to_params(model)).items():
        np.testing.assert_array_equal(v, want[k])

    ranks = job.result()
    assert abs(float(ranks[0]["pool/loss"]) - float(loss)) <= LOSS_RTOL * abs(
        float(loss))
    unexplained, undecided, beyond, worst = weights_off(
        params_of(ranks[0], "pool/params"), want, grads, LR)
    assert unexplained == 0 and beyond == 0, (unexplained, beyond, worst)
    assert undecided <= 10, undecided
    assert max(float(r["pool/spread"]) for r in ranks) <= 1e-6


@pytest.fixture(scope="module")
def unsharded(job):
    """The port's pipeline on one device, float32 and bf16, and JAX's
    float32 extract_batch + match_consecutive."""
    model = tw.from_jax_params(job.params, device="cpu")
    frames = torch.from_numpy(job.data["frames"])
    out = {}
    for dt in ("float32", "bfloat16"):
        o = tb.extract_batch(model, frames, K, getattr(torch, dt))
        r = tb.match_consecutive(o["desc"], o["valid"])
        out[dt] = (o["kpts"].numpy(), r.mask.numpy())
    o = jb.extract_batch(job.params, jnp.asarray(job.data["frames"]), K)
    r = jb.match_consecutive(o["desc"], o["valid"])
    out["jax"] = (np.asarray(o["kpts"]), np.asarray(r.mask))
    return out


def by_position(kpts):
    """Each frame's keypoints in (x, y) order."""
    return np.stack([k[np.lexsort((k[:, 1], k[:, 0]))] for k in kpts])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_sharded_pipeline_matches_unsharded(job, unsharded, dt):
    """(e) 8 frames over 4 data ranks: pairs (1, 2), (3, 4) and (5, 6)
    cross a shard boundary. Every rank's keypoints within 1e-5 of the
    port's unsharded path in the same dtype and its match masks equal; in
    float32 the masks equal JAX's extract_batch + match_consecutive too,
    and each frame's keypoints are JAX's within 1e-5. Against JAX they are
    compared in (x, y) order: where two scores lie within the packages'
    agreement (1e-5 relative), their top-k order may differ (here 6 of
    1024 slots, each swapped with a neighbour less than 2e-6 away)."""
    want_kpts, want_mask = unsharded[dt]
    for res in job.result():
        kpts, mask = res[f"pipe_{dt}/kpts"], res[f"pipe_{dt}/mask"]
        assert kpts.shape == (8, K, 2) and mask.shape == (7, K)
        assert res[f"pipe_{dt}/desc"].shape == (8, K, 64)
        np.testing.assert_allclose(kpts, want_kpts, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(mask, want_mask)
        assert mask[[1, 3, 5]].any(1).all()  # the boundary pairs match
        if dt == "float32":
            jax_kpts, jax_mask = unsharded["jax"]
            np.testing.assert_allclose(by_position(kpts),
                                       by_position(jax_kpts), atol=1e-5,
                                       rtol=0)
            np.testing.assert_array_equal(mask, jax_mask)


def test_mesh_of_one_is_unsharded(job, single):
    """(f) A mesh of one rank: the step, the pool trainer and the pipeline
    give the one-device results bit for bit."""
    one = tm.make_mesh(1, device="cpu")
    for case in CASES:
        loss, aux, params, grads = one_device_step(job, case, mesh=one)
        assert (loss, aux) == single[case][:2]
        for k, v in params.items():
            np.testing.assert_array_equal(v, single[case][2][k], err_msg=k)
            np.testing.assert_array_equal(grads[k], single[case][3][k],
                                          err_msg=k)
    pool = {k: torch.from_numpy(job.data[f"pool/{k}"]) for k in KEYS}
    runs = []
    for mesh in (None, one):
        init_fn, run_fn = tt.make_pool_trainer(
            tt.adam(LR), steps_per_call=2, augment=True, mesh=mesh)
        model, opt = init_fn(tw.trainable(job.params, device="cpu"))
        model, opt, loss, _ = run_fn(model, opt, pool,
                                     torch.from_numpy(job.data["pool/idx"]),
                                     torch.Generator().manual_seed(3))
        runs.append((float(loss), flat(tw.to_params(model))))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        np.testing.assert_array_equal(v, runs[1][1][k], err_msg=k)
    model = tw.from_jax_params(job.params, device="cpu")
    frames = torch.from_numpy(job.data["frames"])
    pipe = tb.make_sharded_pipeline(one, model, num_keypoints=K)
    o = tb.extract_batch(model, frames, K, torch.bfloat16)
    r = tb.match_consecutive(o["desc"], o["valid"])
    for got, want in zip(pipe(frames), (o["kpts"], o["desc"], o["valid"],
                                        r.idx, r.mask)):
        assert torch.equal(got, want)
