"""The port's training module (``xfeatslam_tpu_torch/parallel/train.py``)
and trainable XFeat against the JAX package's ``parallel/train.py``, on
the same inputs (made with numpy from a seed) and the same weights.

Each helper to JAX at atol 1e-6; ``loss_fn``'s loss and aux within 1e-5
relative and each gradient leaf within 1e-4 of that leaf's max abs, over
both teachers, both responses, loc_weight 0 and 0.5, with and without the
augmentation (the port given the draws JAX makes from its key); Adam and
the cosine schedule to optax on identical gradients (the schedule at 1e-6
relative; the parameters at 2e-5 of each leaf's max abs, which optax's own
float32 rounding of its bias corrections takes up to ~1e-5); the
pool trainer's mean losses to JAX's ``make_pool_trainer`` on a one-device
mesh within 1e-4 relative. Float32 on the CPU, 2x64x96 pairs."""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from xfeatslam_tpu.models import weights as jw  # noqa: E402
from xfeatslam_tpu.ops import image as jimage  # noqa: E402
from xfeatslam_tpu.parallel import mesh as jmesh  # noqa: E402
from xfeatslam_tpu.parallel import train as jt  # noqa: E402
from xfeatslam_tpu_torch.models import weights as tw  # noqa: E402
from xfeatslam_tpu_torch.ops import image as timage  # noqa: E402
from xfeatslam_tpu_torch.parallel import train as tt  # noqa: E402

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "weights", "xfeat_synthetic.npz")
B, H, W = 2, 64, 96


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(rng, n):
    """Smooth pattern plus blobs, (n,H,W) float32 in [0,1]."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = []
    for i in range(n):
        img = 0.5 + 0.3 * np.sin(xx / 9 + i) * np.cos(yy / 7 - i)
        for _ in range(12):
            cy, cx = rng.uniform(4, H - 4), rng.uniform(4, W - 4)
            img += 0.4 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 6.0)
        out.append(np.clip(img, 0, 1))
    return np.stack(out).astype(np.float32)


def make_pool(seed=0, n=4):
    """Pairs whose view B is view A moved by a subpixel shift, with noise:
    corr_px is the exact A -> B map, px_valid where it lands inside B."""
    rng = np.random.default_rng(seed)
    a = _images(rng, n)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img_b, corr, valid = [], [], []
    for i in range(n):
        dx, dy = rng.uniform(-5, 5), rng.uniform(-4, 4)
        # B(x + d) = A(x): B sampled at x - d
        sx, sy = xx - dx, yy - dy
        x0 = np.clip(np.floor(sx).astype(int), 0, W - 2)
        y0 = np.clip(np.floor(sy).astype(int), 0, H - 2)
        fx, fy = np.clip(sx - x0, 0, 1), np.clip(sy - y0, 0, 1)
        ai = a[i]
        b = (ai[y0, x0] * (1 - fx) * (1 - fy) + ai[y0, x0 + 1] * fx * (1 - fy)
             + ai[y0 + 1, x0] * (1 - fx) * fy + ai[y0 + 1, x0 + 1] * fx * fy)
        b = np.clip(b + rng.normal(0, 0.01, b.shape), 0, 1)
        c = np.stack([xx + dx, yy + dy], -1)
        ok = ((c[..., 0] >= 1) & (c[..., 0] < W - 1) & (c[..., 1] >= 1)
              & (c[..., 1] < H - 1))
        c[~ok] = 0.0
        img_b.append(b)
        corr.append(c)
        valid.append(ok)
    return {"img_a": a[..., None], "img_b": np.stack(img_b)[..., None]
            .astype(np.float32), "corr_px": np.stack(corr).astype(np.float32),
            "px_valid": np.stack(valid)}


@pytest.fixture(scope="module")
def pool():
    return make_pool()


@pytest.fixture(scope="module")
def params():
    return jw.load_npz(NPZ)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tbatch(b):
    return {k: _t(v) for k, v in b.items()}


def _batch(pool, rows=(0, 1)):
    return {k: v[list(rows)] for k, v in pool.items()}


def _close(a, b, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


def test_sample_bilinear_px(pool):
    rng = np.random.default_rng(1)
    img = pool["corr_px"][:2]
    pts = rng.uniform(-2, [W + 1, H + 1], (2, 300, 2)).astype(np.float32)
    pts[0, :4] = [[0, 0], [W - 1, H - 1], [W - 1, 0], [3, 5]]  # integers
    for src in (img, pool["img_a"][:2]):
        want = jimage.sample_bilinear_px(jnp.asarray(src), jnp.asarray(pts))
        got = timage.sample_bilinear_px(_t(src), _t(pts))
        _close(got, want)
        np.testing.assert_array_equal(got[0, 0].numpy(), src[0, 0, 0])


def test_identity_pair_batch(pool):
    x = pool["img_a"][:2]
    want = jt.identity_pair_batch(jnp.asarray(x))
    got = tt.identity_pair_batch(_t(x))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("name", ["contrast_map", "box3", "box5",
                                  "local_contrast", "shi_tomasi",
                                  "parabola_offsets"])
def test_teacher_helpers(pool, name):
    from xfeatslam_tpu.models import xfeat as jx

    g = jx.instance_norm(jnp.asarray(pool["img_a"]))
    gt_ = _t(np.asarray(g))
    fns = {
        "contrast_map": (jt._contrast_map, tt._contrast_map),
        "box3": (lambda x: jt._box(x, 3), lambda x: tt._box(x, 3)),
        "box5": (lambda x: jt._box(x, 5), lambda x: tt._box(x, 5)),
        "local_contrast": (jt.local_contrast, tt.local_contrast),
        "shi_tomasi": (jt.shi_tomasi_response, tt.shi_tomasi_response),
        "parabola_offsets": (
            lambda x: jt._parabola_offsets(jt.local_contrast(x)),
            lambda x: tt._parabola_offsets(tt.local_contrast(x))),
    }
    jf, tf = fns[name]
    want, got = jf(g), tf(gt_)
    if name == "parabola_offsets":
        for w_, g_ in zip(want, got):
            _close(g_, w_)
    else:
        _close(got, want)
    # the teachers' input, values up to ~4: within 1e-6 of each value
    np.testing.assert_allclose(tt.instance_norm(_t(pool["img_a"])).numpy(),
                               np.asarray(g), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("response", ["contrast5", "shitomasi"])
def test_peak_teacher(pool, response):
    from xfeatslam_tpu.models import xfeat as jx

    g = jx.instance_norm(jnp.asarray(pool["img_a"]))
    r = jt._RESPONSES[response](g)
    want = jt.peak_teacher(r, sigma=0.7)
    got = tt.peak_teacher(_t(np.asarray(r)), sigma=0.7)
    assert got.shape == (4, H // 8, W // 8, 65)
    _close(got, want)


def jax_draws(key, shape):
    """The numbers ``photometric_aug`` draws from ``key`` (JAX's split and
    order), in ``draw_aug``'s layout."""
    n = shape[0]
    kg, kb, ka, kv, ks, kn = jax.random.split(key, 6)
    u = functools.partial(jax.random.uniform, shape=(n, 1, 1, 1))
    d = {"gain": u(kg, minval=0.6, maxval=1.4),
         "bias": u(kb, minval=-0.15, maxval=0.15),
         "alpha": u(ka, minval=0.0, maxval=1.0),
         "vig": u(kv, minval=0.0, maxval=0.5),
         "sigma": u(ks, minval=0.0, maxval=0.04),
         "noise": jax.random.normal(kn, shape)}
    return {k: _t(np.asarray(v)) for k, v in d.items()}


def loss_draws(key, b):
    ka, kb = jax.random.split(key)
    return (jax_draws(ka, b["img_a"].shape), jax_draws(kb, b["img_b"].shape))


def test_augmentation_on_jax_draws(pool):
    x = pool["img_a"]
    key = jax.random.PRNGKey(3)
    want = jt.photometric_aug(key, jnp.asarray(x))
    got = tt.apply_aug(_t(x), jax_draws(key, x.shape))
    _close(got, want)
    # both halves of the blur switch are exercised by these draws
    alpha = np.asarray(jax_draws(key, x.shape)["alpha"]).ravel()
    assert (alpha < 0.5).any() and (alpha >= 0.5).any()


def test_draw_aug_from_generator(pool):
    x = _t(pool["img_a"])
    d1 = tt.draw_aug(torch.Generator().manual_seed(5), x.shape)
    d2 = tt.draw_aug(torch.Generator().manual_seed(5), x.shape)
    for k in d1:
        assert torch.equal(d1[k], d2[k])
    assert 0.6 <= float(d1["gain"].min()) and float(d1["gain"].max()) < 1.4
    assert d1["noise"].shape == x.shape
    y = tt.photometric_aug(torch.Generator().manual_seed(5), x)
    assert torch.equal(y, tt.apply_aug(x, d1))


# (kp_teacher, response, loc_weight, augmented): every teacher, response,
# loc weight and augmentation state appears
LOSS_CASES = [
    ("contrast", "contrast5", 0.0, False),
    ("contrast", "contrast5", 0.5, True),
    ("peak", "contrast5", 0.0, True),
    ("peak", "shitomasi", 0.5, False),
    ("peak", "contrast5", 0.5, False),
]


@pytest.fixture(scope="module")
def jax_value_and_grad():
    fns = {}

    def get(kp_teacher, response, loc_weight):
        key = (kp_teacher, response, loc_weight)
        if key not in fns:
            fns[key] = jax.jit(jax.value_and_grad(functools.partial(
                jt.loss_fn, kp_teacher=kp_teacher, response=response,
                loc_weight=loc_weight), has_aux=True))
        return fns[key]

    return get


@pytest.mark.parametrize("case", LOSS_CASES,
                         ids=["-".join(map(str, c)) for c in LOSS_CASES])
def test_loss_and_grads_match_jax(pool, params, jax_value_and_grad, case):
    kp_teacher, response, loc_weight, augmented = case
    b = _batch(pool)
    key = jax.random.PRNGKey(11) if augmented else None
    (jl, jaux), jg = jax_value_and_grad(kp_teacher, response, loc_weight)(
        params, {k: jnp.asarray(v) for k, v in b.items()}, aug_key=key)

    model = tw.trainable(jax.tree_util.tree_map(np.asarray, params),
                         device="cpu")
    loss, aux = tt.loss_fn(model, _tbatch(b), kp_teacher=kp_teacher,
                           response=response, loc_weight=loc_weight,
                           aug=loss_draws(key, b) if augmented else None)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for k in ("nce", "kp", "rel", "loc"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5,
                                   atol=1e-7)
    if loc_weight > 0:
        assert float(aux["loc"]) > 0
    tg = tw.grads_to_params(model)
    jl_, tl_ = jax.tree_util.tree_leaves(jg), jax.tree_util.tree_leaves(tg)
    assert len(jl_) == len(tl_)
    for j, t in zip(jl_, tl_):
        j = np.asarray(j)
        assert j.shape == t.shape
        err = np.abs(t - j).max()
        assert err <= 1e-4 * np.abs(j).max() + 1e-12, (j.shape, err,
                                                       np.abs(j).max())


def test_grads_round_trip_to_jax_layout(params):
    """Gradients set by hand in JAX's layout come back out of
    ``grads_to_params`` where they were put; unused parameters read 0."""
    model = tw.trainable(jax.tree_util.tree_map(np.asarray, params),
                         device="cpu")
    rng = np.random.default_rng(2)
    ref = jax.tree_util.tree_map(
        lambda a: rng.normal(size=np.shape(a)).astype(np.float32), params)
    donor = tw.from_jax_params(ref, device="cpu")
    for p, q in zip(model.parameters(), donor.parameters()):
        p.grad = q.detach().clone()
    back = tw.grads_to_params(model)
    for a, b in zip(jax.tree_util.tree_leaves(ref),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    model.zero_grad(set_to_none=True)
    assert all((a == 0).all() for a in
               jax.tree_util.tree_leaves(tw.grads_to_params(model)))
    # trainable() from a seed, an npz and a pytree
    m1 = tw.trainable(NPZ, device="cpu")
    assert all(p.requires_grad for p in m1.parameters())
    np.testing.assert_array_equal(tw.to_params(m1)["block1"][0]["w"],
                                  np.asarray(params["block1"][0]["w"]))
    assert tw.trainable(3, device="cpu").block1[0].weight.requires_grad


@pytest.mark.parametrize("lr,steps", [(2e-3, 100), (1e-3, 40), (5e-4, 7)])
def test_cosine_schedule_matches_optax(lr, steps):
    want = optax.warmup_cosine_decay_schedule(
        0.0, lr, int(steps * 0.05), steps, lr / 20)
    got = tt.warmup_cosine_schedule(lr, steps)
    for c in range(steps + 3):
        np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("scheduled", [False, True])
def test_adam_matches_optax(scheduled):
    rng = np.random.default_rng(4)
    shapes = [(3, 3, 4, 8), (8,), (16, 5)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    init[1][:] = 0.0  # a zero-initialized bias
    lr = tt.warmup_cosine_schedule(1e-2, 40) if scheduled else 1e-2
    jlr = (optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 40, 1e-2 / 20)
           if scheduled else 1e-2)
    opt = optax.adam(jlr)
    jp = [jnp.asarray(a) for a in init]
    state = opt.init(jp)
    tp = [torch.tensor(a, requires_grad=True) for a in init]
    topt = tt.adam(lr)(tp)
    for step in range(8):
        grads = [(rng.normal(size=s) * 10.0 ** rng.integers(-6, 1))
                 .astype(np.float32) for s in shapes]
        upd, state = opt.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, upd)
        topt.zero_grad()
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g)
        topt.step()
        # relative to each leaf's largest value: an element that passes
        # near zero keeps the absolute rounding of the values around it.
        # optax rounds its bias corrections in float32 (1 - 0.999f ** t)
        # but weights the second moment by 1 - 0.999 in float64, which
        # puts its step-1 second moment 1.29e-5 high (6.5e-6 on the
        # update); torch.optim.Adam's corrections are float64
        for a, b in zip(tp, jp):
            b = np.asarray(b)
            err = np.abs(a.detach().numpy() - b).max()
            assert err <= 2e-5 * np.abs(b).max(), (step, err)


def test_pool_trainer_matches_jax(pool, params):
    """Two calls of two steps each, augmentation off, the same pool and
    rows: the mean losses within 1e-4 relative."""
    mesh = jmesh.make_mesh(n_devices=1)
    S, n_calls = 2, 2
    idx = np.random.default_rng(9).integers(0, len(pool["img_a"]),
                                            (n_calls, S, B)).astype(np.int32)
    init_fn, run_fn = jt.make_pool_trainer(mesh, optax.adam(2e-3),
                                           steps_per_call=S, augment=False)
    jp, jo = init_fn(params)
    jpool = jax.device_put({k: jnp.asarray(v) for k, v in pool.items()})

    tinit, trun = tt.make_pool_trainer(tt.adam(2e-3), steps_per_call=S,
                                       augment=False)
    model, topt = tinit(tw.trainable(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    tpool = _tbatch(pool)
    for c in range(n_calls):
        jp, jo, jl, jaux = run_fn(jp, jo, jpool, jnp.asarray(idx[c]),
                                  jax.random.PRNGKey(c))
        model, topt, tl, taux = trun(model, topt, tpool,
                                     torch.from_numpy(idx[c]).long())
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
        # the mean aux are the mean loss's terms
        assert set(taux) == set(jaux)
        np.testing.assert_allclose(sum(float(v) for v in taux.values()),
                                   float(tl), rtol=1e-5)
    assert topt.count == S * n_calls
    with pytest.raises(ValueError):
        trun(model, topt, tpool, torch.zeros((S + 1, B), dtype=torch.long))


def test_train_step_matches_jax(pool, params):
    """Three steps of ``make_train_step`` against JAX's on a one-device
    mesh, the peak teacher with loc_weight 0.5, each on two pool rows: each
    step's loss within 1e-4 relative, its aux summing to it; the step leaves
    the deterministic settings as it found them."""
    mesh = jmesh.make_mesh(n_devices=1)
    kw = dict(kp_teacher="peak", loc_weight=0.5)
    init_fn, step_fn = jt.make_train_step(mesh, optax.adam(2e-3), **kw)
    jp, jo = init_fn(params)
    tinit, tstep = tt.make_train_step(tt.adam(2e-3), **kw)
    model, topt = tinit(tw.trainable(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    before = torch.are_deterministic_algorithms_enabled()
    for rows in ((0, 1), (2, 3), (1, 2)):
        b = _batch(pool, rows)
        jp, jo, jl, jaux = step_fn(jp, jo,
                                   {k: jnp.asarray(v) for k, v in b.items()})
        model, topt, tl, taux = tstep(model, topt, _tbatch(b))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
        assert set(taux) == set(jaux)
        np.testing.assert_allclose(sum(float(v) for v in taux.values()),
                                   float(tl), rtol=1e-5)
    assert topt.count == 3
    assert torch.are_deterministic_algorithms_enabled() == before
