"""The PyTorch port's image ops, detection post-processing and descriptor
sampling against the JAX package on the same numpy inputs. The Pallas
kernels run in interpret mode, as tests/test_pallas_kernels.py runs them;
the port's wrappers take their plain versions on these CPU tensors."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# float32 parity: no TF32 in convolutions or matmuls, should a GPU be used
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from xfeatslam_tpu.ops import detect as jd  # noqa: E402
from xfeatslam_tpu.ops import image as ji  # noqa: E402
from xfeatslam_tpu.ops import pallas_kernels as pk  # noqa: E402
from xfeatslam_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from xfeatslam_tpu_torch.ops import detect as td  # noqa: E402
from xfeatslam_tpu_torch.ops import image as ti  # noqa: E402


def t(x):
    return torch.tensor(np.asarray(x))


# ---- (b) image ops --------------------------------------------------------

@pytest.mark.parametrize("src,dst,atol", [
    ((120, 168), (96, 160), 1e-5),   # shrink: antialiased like jax.image
    ((48, 64), (96, 128), 1e-6),     # grow
])
def test_resize_bilinear_matches_jax(rng, src, dst, atol):
    x = rng.uniform(size=(2, *src, 3)).astype(np.float32)
    got = ti.resize_bilinear(t(x), dst).numpy()
    ref = np.asarray(ji.resize_bilinear(jnp.asarray(x), dst))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=atol)


def test_samplers_match_jax(rng):
    B, Hs, Ws, C, Hn, Wn = 2, 12, 16, 5, 96, 128
    img = rng.standard_normal((B, Hs, Ws, C)).astype(np.float32)
    # inside the frame and a little outside it, to exercise zero padding
    pos = np.stack([rng.uniform(-4, Wn + 3, (B, 60)),
                    rng.uniform(-4, Hn + 3, (B, 60))], -1).astype(np.float32)
    for fj, ft in [(ji.sample_bilinear, ti.sample_bilinear),
                   (ji.sample_nearest, ti.sample_nearest)]:
        np.testing.assert_allclose(
            ft(t(img), t(pos), (Hn, Wn)).numpy(),
            np.asarray(fj(jnp.asarray(img), jnp.asarray(pos), (Hn, Wn))),
            atol=1e-6)
    np.testing.assert_allclose(
        ti.dense_grid_sample_bilinear(t(img[..., :1]), (Hn, Wn)).numpy(),
        np.asarray(ji.dense_grid_sample_bilinear(jnp.asarray(img[..., :1]),
                                                 (Hn, Wn))), atol=1e-6)


def test_to_float_image(rng):
    u8 = rng.integers(0, 256, (10, 12)).astype(np.uint8)
    got = ti.to_float_image(u8, device="cpu")
    assert got.shape == (1, 10, 12, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ji.to_float_image(u8)), atol=0)


# ---- cell-space detection ops ----------------------------------------------

def random_detect_inputs(rng, B, H8, W8):
    logits = (rng.standard_normal((B, H8, W8, 65)) * 3).astype(np.float32)
    heat = rng.uniform(size=(B, H8, W8, 1)).astype(np.float32)
    return logits, heat


def sparse_detect_inputs(rng, B=2, H8=30, W8=40):
    """Isolated peaks: at most a couple of survivors per cell (the shape of
    real frames; see TestDetectCandidates in test_pallas_kernels.py)."""
    logits = np.full((B, H8, W8, 65), -8.0, np.float32)
    for b in range(B):
        cy, cx = rng.integers(0, H8, 250), rng.integers(0, W8, 250)
        logits[b, cy, cx, rng.integers(0, 64, 250)] = rng.uniform(4.0, 9.0, 250)
    heat = rng.uniform(size=(B, H8, W8, 1)).astype(np.float32)
    return logits, heat


def test_keypoint_heatmap_nms_and_ranked_match_jax(rng):
    logits, heat = random_detect_inputs(rng, 2, 12, 16)
    np.testing.assert_allclose(
        td.keypoint_heatmap(t(logits)).numpy(),
        np.asarray(jd.keypoint_heatmap(jnp.asarray(logits))), atol=1e-6)
    rj, pj = jd.ranked_score_cells(jnp.asarray(logits), jnp.asarray(heat))
    rt, pt = td.ranked_score_cells(t(logits), t(heat))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6)
    rj = np.asarray(rj)
    np.testing.assert_array_equal(rt.numpy() > 0, rj > 0)
    np.testing.assert_allclose(rt.numpy(), rj, atol=1e-6)
    np.testing.assert_array_equal(
        td.nms_mask_cells(pt).numpy(), np.asarray(jd.nms_mask_cells(pj)))
    np.testing.assert_allclose(
        td._rel_cells(t(heat), 12, 16).numpy(),
        np.asarray(jd._rel_cells(jnp.asarray(heat), 12, 16)), atol=1e-7)


def test_cells_topk_matches_jax(rng):
    logits, heat = random_detect_inputs(rng, 2, 12, 16)
    rj, _ = jd.ranked_score_cells(jnp.asarray(logits), jnp.asarray(heat))
    sj, ij = jd._cells_topk(rj, 100)
    st, it = td._cells_topk(t(np.asarray(rj)), 100)
    v = np.asarray(sj) > 0
    np.testing.assert_array_equal(st.numpy()[v], np.asarray(sj)[v])
    for b in range(2):
        assert set(it.numpy()[b][v[b]]) == set(np.asarray(ij)[b][v[b]])


# ---- (c) detect_candidates: plain version vs the Pallas kernel -------------

DETECT_CASES = {
    "multistrip": lambda rng: random_detect_inputs(rng, 2, 30, 40),
    "single_strip": lambda rng: random_detect_inputs(rng, 2, 16, 24),
    "sparse": sparse_detect_inputs,
}


@pytest.mark.parametrize("nc", [5, 9])
@pytest.mark.parametrize("case", sorted(DETECT_CASES))
def test_detect_candidates_matches_pallas(rng, case, nc):
    logits, heat = DETECT_CASES[case](rng)
    vj, aj = (np.asarray(a) for a in pk.detect_candidates(
        jnp.asarray(logits), jnp.asarray(heat), interpret=True, nc=nc))
    vt, at = (a.numpy() for a in ck.detect_candidates(t(logits), t(heat), nc=nc))
    assert vt.shape == vj.shape == (2, logits.shape[1], nc, logits.shape[2])
    m = vj > 0
    assert m.any()
    np.testing.assert_array_equal(vt > 0, m)
    # rtol: XLA:CPU's softmax is itself ~2e-6 off the float64 value on peaky
    # logits (1.7e-6 measured on the sparse case), PyTorch's ~2.5e-7
    np.testing.assert_allclose(vt[m], vj[m], atol=1e-6, rtol=1e-5)
    ai, bi = at[m].astype(np.int64), aj[m].astype(np.int64)
    np.testing.assert_array_equal(ai >> 18, bi >> 18)
    # quantized offsets within one 1/255 px step
    assert np.abs(((ai >> 9) & 511) - ((bi >> 9) & 511)).max() <= 1
    assert np.abs((ai & 511) - (bi & 511)).max() <= 1


# ---- (d) select_keypoints vs the JAX XLA path -------------------------------

def _keyset(kpts, valid):
    return {tuple(k) for k in np.round(kpts[valid] * 255).astype(np.int64)}


@pytest.mark.parametrize("subpixel", [False, True])
def test_select_keypoints_matches_jax(rng, subpixel):
    B, H8, W8, K = 2, 16, 20, 150
    feats = rng.standard_normal((B, H8, W8, 64)).astype(np.float32)
    logits, heat = sparse_detect_inputs(rng, B, H8, W8)
    oj = {k: np.asarray(v) for k, v in jd.select_keypoints(
        jnp.asarray(feats), jnp.asarray(logits), jnp.asarray(heat), K,
        subpixel=subpixel).items()}
    ot = {k: v.numpy() for k, v in td.select_keypoints(
        t(feats), t(logits), t(heat), K, subpixel=subpixel).items()}
    for b in range(B):
        vj, vt = oj["valid"][b], ot["valid"][b]
        assert vj.sum() == vt.sum() > 0
        sj, st = _keyset(oj["kpts"][b], vj), _keyset(ot["kpts"][b], vt)
        assert len(sj & st) / len(sj | st) >= 0.99
        np.testing.assert_allclose(np.sort(ot["scores"][b][vt]),
                                   np.sort(oj["scores"][b][vj]), atol=1e-5)
        rows_j = {k: i for i, k in enumerate(
            map(tuple, np.round(oj["kpts"][b] * 255).astype(np.int64)))}
        for i, k in enumerate(np.round(ot["kpts"][b] * 255).astype(np.int64)):
            j = rows_j.get(tuple(k))
            if vt[i] and j is not None and vj[j]:
                np.testing.assert_allclose(ot["desc"][b][i], oj["desc"][b][j],
                                           atol=1e-4)
        assert not ot["desc"][b][~vt].any()


# ---- (e) descriptor sampling ------------------------------------------------

def test_bilinear_desc_sample_matches_pallas(rng):
    B, H8, W8, K = 2, 16, 24, 200
    H, W = H8 * 8, W8 * 8
    feats = rng.standard_normal((B, H8, W8, 64)).astype(np.float32)
    kpts = np.stack([rng.uniform(0, W - 1, (B, K)),
                     rng.uniform(0, H - 1, (B, K))], -1).astype(np.float32)
    valid = rng.uniform(size=(B, K)) > 0.2
    idx4, w4 = td.desc_taps(t(kpts), t(valid), H8, W8)
    got = ck.bilinear_desc_sample(t(feats).reshape(B, H8 * W8, 64), idx4,
                                  w4).numpy()
    pad = ((0, 0), (0, pk.KPT_TILE - K), (0, 0))  # Pallas wants K % 256 == 0
    ref = np.asarray(pk.bilinear_desc_sample(
        jnp.asarray(feats.reshape(B, H8 * W8, 64)),
        jnp.pad(jnp.asarray(idx4.numpy()), pad),
        jnp.pad(jnp.asarray(w4.numpy()), pad), interpret=True))[:, :K]
    np.testing.assert_allclose(got[valid], ref[valid], atol=2e-6)
    assert np.abs(got[~valid]).max() == 0.0
    # and the taps reproduce the straight normalize -> sample -> renormalize
    fj = jnp.asarray(feats)
    fn = fj * lax.rsqrt(jnp.sum(fj * fj, axis=-1, keepdims=True) + 1e-12)
    d = ji.sample_bilinear(fn, jnp.asarray(kpts), (H, W))
    d = np.asarray(d * lax.rsqrt(jnp.sum(d * d, axis=-1, keepdims=True) + 1e-12))
    np.testing.assert_allclose(got[valid], d[valid], atol=2e-6)


# ---- (f) the fused descriptor stage's plain version vs the JAX chain -------

def border_detect_inputs(rng, B=2, H8=12, W8=16):
    """Sparse peaks plus peaks on the image's top row and left column, whose
    bilinear taps leave the descriptor grid."""
    logits, heat = sparse_detect_inputs(rng, B, H8, W8)
    logits[:, 0, 1::3, 2] = 9.0   # pixel row 0
    logits[:, 2::3, 0, 24] = 9.0  # pixel column 0
    return logits, heat


@pytest.mark.parametrize("subpixel", [False, True])
def test_keypoint_desc_plain_matches_jax_chain(rng, subpixel):
    B, H8, W8 = 2, 12, 16
    logits, heat = border_detect_inputs(rng, B, H8, W8)
    feats = rng.standard_normal((B, H8 * W8, 64)).astype(np.float32)
    vals, aux = (np.asarray(a) for a in pk.detect_candidates(
        jnp.asarray(logits), jnp.asarray(heat), interpret=True))
    npos = int((vals > 0).sum(axis=(1, 2, 3)).min())
    # K = npos: every row valid, so the whole tensors compare (tie order among
    # equal scores is not pinned across the JAX merge seam); 2*npos adds
    # invalid rows, compared where valid and held to zero elsewhere
    for K in (npos, 2 * npos):
        sj, ij, oj = jd._candidates_topk(jnp.asarray(vals), jnp.asarray(aux),
                                         K, W8)
        W = W8 * 8
        kj = jnp.stack([(ij % W).astype(jnp.float32),
                        (ij // W).astype(jnp.float32)], -1)
        if subpixel:
            kj = kj + oj
        vj = sj > 0.0
        dj = np.asarray(jd._desc_sample_pallas(
            jnp.asarray(feats.reshape(B, H8, W8, 64)), kj, vj, H8, W8))
        kj, vj = np.asarray(kj), np.asarray(vj)
        scores, sel = torch.topk(t(vals).reshape(B, -1), K, dim=1)
        kt, dt = (a.numpy() for a in ck.keypoint_desc_plain(
            t(feats), scores, sel, t(aux), W8, subpixel))
        vt = scores.numpy() > 0.0
        np.testing.assert_array_equal(vt, vj)
        assert vt.all() == (K == npos)
        np.testing.assert_allclose(kt[vt], kj[vt], atol=1e-6)
        np.testing.assert_allclose(dt[vt], dj[vt], atol=2e-6)
        assert not dt[~vt].any()
    # some keypoints' taps leave the grid (position < 0 on either axis)
    assert (kt[vt] < 4.0).any()


def test_select_keypoints_equals_its_unfused_chain(rng):
    """select_keypoints' one-call descriptor stage gives what detect ->
    topk -> decode -> desc_taps -> bilinear_desc_sample gives."""
    B, H8, W8, K = 2, 12, 16, 120
    logits, heat = border_detect_inputs(rng, B, H8, W8)
    feats = t(rng.standard_normal((B, H8, W8, 64)).astype(np.float32))
    out = td.select_keypoints(feats, t(logits), t(heat), K, subpixel=True)
    vals, aux = ck.detect_candidates(t(logits), t(heat))
    scores, sel = torch.topk(vals.reshape(B, -1), K, dim=1)
    kpts, off = td.decode_candidates(sel, aux, W8)
    kpts = kpts + off
    desc = td.sample_descriptors(feats, kpts, scores > 0)
    assert torch.equal(out["kpts"], kpts) and torch.equal(out["desc"], desc)
    assert torch.equal(out["valid"], scores > 0)


# ---- (g) the detect kernel's grid ------------------------------------------

@pytest.mark.parametrize("B", [1, 32])
@pytest.mark.parametrize("H8,W8", [(60, 80), (13, 120), (13, 83)])
def test_detect_grid_covers_every_cell_once(B, H8, W8):
    ctas, S, parts = ck.detect_grid(B, H8, W8)
    CW = -(-W8 // parts)
    strips = -(-H8 // S)
    assert ctas == B * strips * parts
    hits = np.zeros((B, H8, W8), np.int64)
    for b in range(B):  # blockIdx.y
        for i in range(strips * parts):  # blockIdx.x
            s, p = divmod(i, parts)
            hits[b, s * S:min(s * S + S, H8), p * CW:min(p * CW + CW, W8)] += 1
    assert (hits == 1).all()
    if B == 1 and (H8, W8) == (60, 80):
        assert ctas >= 132  # the frame step's shape: a CTA for every SM


def test_cpu_calls_launch_no_kernel(rng):
    ck.reset_launch_counts()
    logits, heat = random_detect_inputs(rng, 1, 8, 8)
    feats = rng.standard_normal((1, 8, 8, 64)).astype(np.float32)
    td.select_keypoints(t(feats), t(logits), t(heat), 20)
    assert ck.launch_counts() == {"detect_candidates": 0,
                                  "bilinear_desc_sample": 0,
                                  "keypoint_desc": 0,
                                  "mutual_nn_pairs": 0,
                                  "similarity_top2": 0,
                                  "pose_lm": 0,
                                  "local_ba": 0,
                                  "orb_fast": 0,
                                  "orb_describe": 0,
                                  "xfeat_stem": 0}
