"""Self-supervised XFeat training, on one device or data- and
tensor-parallel over a mesh.

Counterpart of ``xfeatslam_tpu/parallel/train.py``: the same cross-view
loss over rendered view pairs with known geometry (``loss_fn``), the same
teachers and augmentation, Adam with optax's defaults, and a trainer that
keeps the pair pool on the device and gathers each step's rows there
(``make_pool_trainer``).

On a mesh (``parallel/mesh.py``) the batch is split over "data" and the
wide layers (``param_shardings``) over "model": each model rank holds only
its part of their output features, so Adam's state is split with them.
The loss is the whole batch's: its normalizers and the gradients are summed
over the data ranks, so a step on the mesh is the one-device step. A mesh
of one rank runs the one-device code.

Random draws cannot follow JAX's keys, so ``photometric_aug`` is split in
two: ``draw_aug`` takes its numbers from a ``torch.Generator`` and
``apply_aug`` applies given numbers, which lets a caller feed the draws a
JAX key makes. Tensors are NHWC, as in the JAX package.

A step gives the same bits on every run of the same inputs on one GPU:
``deterministic()`` switches cuDNN to its deterministic algorithms and the
scatters behind the gathers' backward to their sorted, ordered versions,
and the network's upsampling has no scatter in its backward
(``models/xfeat._resize_bilinear``).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.xfeat import BN_EPS
from ..ops import image as image_ops
from .mesh import ModelSplit, Sharding, replicated

# the layers whose output features go over "model": JAX's key-path test,
# a substring test, so block_fusion_final is one of them
WIDE_LAYERS = ("block5", "block_fusion", "fine_matcher")


def param_shardings(mesh, model: nn.Module, strict: bool = False) -> dict:
    """{parameter name: ``Sharding``}: dim 0 (the output features) of the
    wide layers' weights and biases over "model", everything else whole.

    A wide layer whose width does not divide the model axis stays whole;
    with ``strict`` and a model axis above 1 it raises instead, naming the
    layer (a whole block5 on a tensor-parallel mesh wastes the axis)."""
    n = mesh.shape["model"]
    out = {}
    for name, p in model.named_parameters():
        spec = replicated(mesh)
        if any(w in name for w in WIDE_LAYERS) and p.ndim in (1, 2, 4):
            if p.shape[0] % n == 0:
                spec = Sharding(mesh, "model")
            elif strict and n > 1 and p.ndim > 1:
                raise ValueError(
                    f"wide layer {name} (shape {tuple(p.shape)}) does not "
                    f"divide the model axis ({n}); refusing to keep it "
                    f"whole on a tensor-parallel mesh")
        out[name] = spec
    return out


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """Partition ``model`` in place over the mesh's "model" axis as
    ``param_shardings`` says, strictly (a wide layer whose width does not
    divide the axis raises): each split conv or linear keeps only this
    rank's part of its weight and bias and gathers its output features
    (``mesh.ModelSplit``). A model axis of 1 leaves it as it is."""
    if mesh.shape["model"] == 1:
        return model
    specs = param_shardings(mesh, model, strict=True)
    for name, layer in model.named_modules():
        if not isinstance(layer, (nn.Conv2d, nn.Linear)):
            continue
        spec = specs[f"{name}.weight"]
        if spec.axis != "model":
            continue
        with torch.no_grad():
            for attr in ("weight", "bias"):
                part = spec.local(getattr(layer, attr)).clone()
                setattr(layer, attr, nn.Parameter(
                    part, requires_grad=getattr(layer, attr).requires_grad))
        layer.model_split = ModelSplit(
            mesh, 1 if isinstance(layer, nn.Conv2d) else -1)
    return model


def identity_pair_batch(images):
    """A training batch whose view B is view A (identity correspondence),
    for shape tests and dry runs."""
    B, H, W, _ = images.shape
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=images.device),
        torch.arange(W, dtype=torch.float32, device=images.device),
        indexing="ij")
    return {
        "img_a": images,
        "img_b": images,
        "corr_px": torch.stack([xs, ys], -1).expand(B, H, W, 2),
        "px_valid": torch.ones((B, H, W), dtype=torch.bool,
                               device=images.device),
    }


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def unfold2d(x, ws: int = 8):
    """Space-to-depth of NHWC ``x``: (B,H,W,C) -> (B,H/ws,W/ws,ws*ws*C),
    channel (i*ws + j)*C + c with i the row offset (the JAX ``unfold2d``)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H // ws, W // ws, ws * ws * C)


def instance_norm(x, eps: float = BN_EPS):
    """Instance norm of NHWC ``x`` over (H, W), population variance."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


def _contrast_map(x_gray):
    """(B,H,W,1) instance-normed gray -> each pixel minus its 8x8 cell's
    mean: the signal the 1x1-conv keypoint head can express."""
    B, H, W, _ = x_gray.shape
    m = x_gray.reshape(B, H // 8, 8, W // 8, 8, 1).sum(dim=(2, 4)) / 64.0
    return x_gray - m.repeat_interleave(8, 1).repeat_interleave(8, 2)


def _box(x, k: int):
    """(B,H,W,1) mean filter, SAME padding, each output divided by the
    number of taps inside the image."""
    return _nhwc(F.avg_pool2d(_nchw(x), k, 1, k // 2,
                              count_include_pad=False))


def local_contrast(x_gray, k: int = 5):
    """Shift-invariant band-pass |x - box_k(x)|: its peaks do not depend on
    the 8x8 cell grid, so a scene point peaks at the same subpixel place in
    both views."""
    return (x_gray - _box(x_gray, k)).abs()


def shi_tomasi_response(x_gray):
    """(B,H,W,1) -> min-eigenvalue corner response over a 3x3 window
    (central differences with wrap-around, as ``jnp.roll``)."""
    gx = 0.5 * (torch.roll(x_gray, -1, 2) - torch.roll(x_gray, 1, 2))
    gy = 0.5 * (torch.roll(x_gray, -1, 1) - torch.roll(x_gray, 1, 1))
    ixx = _box(gx * gx, 3)
    iyy = _box(gy * gy, 3)
    ixy = _box(gx * gy, 3)
    tr = ixx + iyy
    det = ixx * iyy - ixy * ixy
    disc = torch.sqrt(torch.clamp(tr * tr - 4.0 * det, min=0.0))
    return 0.5 * (tr - disc)


_RESPONSES = {
    "contrast5": lambda x: local_contrast(x, 5),
    "shitomasi": shi_tomasi_response,
}


def _shift(x, d: int, dim: int):
    """y[i] = x[i - d] along ``dim``, the edge sample repeated."""
    n = x.shape[dim]
    idx = (torch.arange(n, device=x.device) - d).clamp(0, n - 1)
    return x.index_select(dim, idx)


def _parabola_offsets(r):
    """Per-pixel 1-D quadratic peak offsets of (B,H,W,1) ``r``: (ox, oy),
    each in [-0.5, 0.5], zero where the pixel is no local max along that
    axis (curvature >= -1e-9)."""
    def axis_off(dim):
        rm = _shift(r, 1, dim)  # r[i-1]
        rp = _shift(r, -1, dim)  # r[i+1]
        den = rm - 2.0 * r + rp
        peak = den < -1e-9
        off = torch.where(peak, 0.5 * (rm - rp) / torch.where(peak, den, -1.0),
                          0.0)
        return off.clamp(-0.5, 0.5)

    return axis_off(2), axis_off(1)


def peak_teacher(r, sigma: float = 0.7, gate_q: float = 0.5):
    """(B,H,W,1) response -> (B,H8,W8,65) soft target: a normalized
    Gaussian bump (std ``sigma`` px) at the subpixel argmax of each 8x8
    cell, weighted by a soft keypointness gate against the image's median
    cell peak (``torch.quantile``'s linear interpolation, as
    ``jnp.quantile``'s); the rest of the mass on the dustbin."""
    B = r.shape[0]
    cells = unfold2d(r, 8)
    ox, oy = _parabola_offsets(r)
    arg = cells.argmax(-1, keepdim=True)  # the first max, as jnp.argmax
    s = cells.gather(-1, arg)[..., 0]
    tx = (arg[..., 0] % 8).float() + unfold2d(ox, 8).gather(-1, arg)[..., 0]
    ty = (arg[..., 0] // 8).float() + unfold2d(oy, 8).gather(-1, arg)[..., 0]

    q = torch.quantile(s.reshape(B, -1), gate_q, dim=1)[:, None, None]
    srel = s / (q + 1e-8)
    gate = (srel * srel) / (1.0 + srel * srel)

    c = torch.arange(64, dtype=torch.float32, device=r.device)
    d2 = ((c % 8) - tx[..., None]) ** 2 + ((c // 8) - ty[..., None]) ** 2
    bump = torch.exp(-d2 / (2.0 * sigma * sigma))
    bump = bump / bump.sum(-1, keepdim=True)
    return torch.cat([gate[..., None] * bump, (1.0 - gate)[..., None]], -1)


def draw_aug(gen: torch.Generator, shape, device=None) -> dict:
    """The numbers of one ``photometric_aug`` of a (B,H,W,C) batch, drawn
    from ``gen`` in a fixed order: per image gain U(0.6, 1.4), bias
    U(-0.15, 0.15), blur alpha U(0, 1), vignette U(0, 0.5), noise sigma
    U(0, 0.04), then a standard normal per sample."""
    B = shape[0]
    dev = gen.device if device is None else device

    def uniform(lo, hi):
        u = torch.rand((B, 1, 1, 1), generator=gen, device=dev)
        return u * (hi - lo) + lo

    d = {"gain": uniform(0.6, 1.4), "bias": uniform(-0.15, 0.15),
         "alpha": uniform(0.0, 1.0), "vig": uniform(0.0, 0.5),
         "sigma": uniform(0.0, 0.04)}
    d["noise"] = torch.randn(tuple(shape), generator=gen, device=dev)
    return d


def apply_aug(img, d: dict):
    """Photometric augmentation of (B,H,W,1) float [0,1] with the numbers
    ``d`` (``draw_aug``'s keys): gain and bias, a lerp toward the 3x3
    binomial blur (zero padding) for half the images, a vignette and
    Gaussian noise, clipped to [0, 1]. Geometry is untouched, so the
    ground-truth correspondences stay exact."""
    _, H, W, _ = img.shape
    x = img * d["gain"] + d["bias"]
    xp = F.pad(x, (0, 0, 1, 1))  # W
    blur = 0.25 * xp[:, :, :-2] + 0.5 * xp[:, :, 1:-1] + 0.25 * xp[:, :, 2:]
    bp = F.pad(blur, (0, 0, 0, 0, 1, 1))  # H
    blur = 0.25 * bp[:, :-2] + 0.5 * bp[:, 1:-1] + 0.25 * bp[:, 2:]
    alpha = torch.where(d["alpha"] < 0.5, 0.0, (d["alpha"] - 0.5) * 1.6)
    x = (1.0 - alpha) * x + alpha * blur

    # in the image's dtype: float32, or float64 for a reference
    fdt = dict(dtype=img.dtype, device=img.device)
    yy = (torch.arange(H, **fdt) / (H - 1) - 0.5)[None, :, None, None]
    xx = (torch.arange(W, **fdt) / (W - 1) - 0.5)[None, None, :, None]
    rr = (yy * yy + xx * xx) * 2.0
    x = x * (1.0 - d["vig"] * rr)
    x = x + d["sigma"] * d["noise"]
    return x.clamp(0.0, 1.0)


def photometric_aug(gen: torch.Generator, img):
    """``apply_aug`` with numbers drawn from ``gen``."""
    return apply_aug(img, draw_aug(gen, img.shape, img.device))


def _norm(f):
    return f * torch.rsqrt((f * f).sum(-1, keepdim=True) + 1e-8)


def loss_fn(model, batch, temp: float = 0.1, teacher_gain: float = 5.0,
            kp_teacher: str = "contrast", response: str = "contrast5",
            sigma: float = 0.7, loc_weight: float = 0.0, aug=None,
            mesh=None):
    """Cross-view self-supervised loss over a pair batch: descriptor
    InfoNCE at the ground-truth correspondences (B's cells within 1.5
    cells of the match left out of the negatives), the keypoint head's
    cross-view teacher (``kp_teacher`` "contrast": a softmax over the
    cross-view within-cell contrast; "peak": ``peak_teacher`` of the
    cross-view ``response``, "contrast5" or "shitomasi"), reliability
    regressed toward descriptor agreement and, with ``loc_weight`` > 0,
    the cross-view agreement of the cells' soft-argmax peaks.

    batch: img_a, img_b (B,H,W,1) float [0,1], corr_px (B,H,W,2) A-pixel
    -> B-pixel, px_valid (B,H,W) bool. aug: None; a ``torch.Generator``
    (the network inputs augmented with ``draw_aug``'s numbers, A's then
    B's); or a pair of ``draw_aug``-style dicts for A and B. The teachers
    always see the clean renders. Returns (loss, {"nce", "kp", "rel",
    "loc"}), 0-dim tensors.

    mesh: None, or a mesh whose "data" axis splits the batch; ``batch``
    and ``aug`` are then this rank's rows, each normalizer is summed over
    the data ranks, and the loss and aux are this rank's shares, whose sums
    over the data ranks are the whole batch's."""
    img_a, img_b = batch["img_a"], batch["img_b"]
    corr_px, px_valid = batch["corr_px"], batch["px_valid"]
    B, H, W, _ = img_a.shape
    H8, W8 = H // 8, W // 8
    N = H8 * W8
    dev = img_a.device
    # the data ranks' shards are equal: a mean over the whole batch is the
    # sum of each rank's mean over the number of ranks
    n_data = 1 if mesh is None else mesh.shape["data"]

    def total(x):  # a normalizer (no gradient) over the whole batch
        return x if mesh is None else mesh.data_sum(x)
    f32 = dict(dtype=torch.float32, device=dev)

    if aug is None:
        in_a, in_b = img_a, img_b
    elif isinstance(aug, torch.Generator):
        in_a = photometric_aug(aug, img_a)
        in_b = photometric_aug(aug, img_b)
    else:
        in_a, in_b = apply_aug(img_a, aug[0]), apply_aug(img_b, aug[1])
    # both views through one forward: instance norm and the convs work per
    # image
    feats, logits, heat = model(torch.cat([in_a, in_b]))
    feats_a, feats_b = feats[:B], feats[B:]
    logits_a, logits_b = logits[:B], logits[B:]
    heat_a = heat[:B]

    # ---- descriptor InfoNCE at ground-truth correspondences ----
    cy, cx = torch.meshgrid(torch.arange(H8, **f32) * 8.0 + 3.5,
                            torch.arange(W8, **f32) * 8.0 + 3.5,
                            indexing="ij")
    centers = torch.stack([cx, cy], -1).reshape(1, N, 2).expand(B, N, 2)
    corr_at_c = image_ops.sample_bilinear(corr_px, centers, (H, W))
    valid_at_c = image_ops.sample_bilinear(
        px_valid[..., None].float(), centers, (H, W))[..., 0] > 0.99
    valid_at_c &= ((corr_at_c[..., 0] >= 4.0) & (corr_at_c[..., 0] < W - 4.0)
                   & (corr_at_c[..., 1] >= 4.0)
                   & (corr_at_c[..., 1] < H - 4.0))

    fa = _norm(feats_a).reshape(B, N, -1)
    fb = _norm(feats_b)
    fb_grid = fb.reshape(B, N, -1)
    fb_pos = _norm(image_ops.sample_bilinear(fb, corr_at_c, (H, W)))

    sim_pos = (fa * fb_pos).sum(-1) / temp
    sim_neg = torch.bmm(fa, fb_grid.transpose(1, 2)) / temp
    bx = (corr_at_c[..., 0] - 3.5) / 8.0  # the match on B's feature grid
    by = (corr_at_c[..., 1] - 3.5) / 8.0
    near_x = (torch.arange(W8, **f32) - bx[..., None]).abs() <= 1.5
    near_y = (torch.arange(H8, **f32) - by[..., None]).abs() <= 1.5
    near = (near_y[..., :, None] & near_x[..., None, :]).reshape(B, N, N)
    sim_neg = sim_neg.masked_fill(near, -math.inf)
    denom = torch.logaddexp(sim_pos, torch.logsumexp(sim_neg, -1))
    w = valid_at_c.float()
    nce = ((denom - sim_pos) * w).sum() / total(w.sum()).clamp_min(1.0)

    # ---- keypoint head: cross-view teacher (contrast | peak) ----
    xa = instance_norm(img_a.mean(-1, keepdim=True))
    xb = instance_norm(img_b.mean(-1, keepdim=True))
    flat_corr = corr_px.reshape(B, H * W, 2)
    vw = px_valid[..., None].float()
    if kp_teacher == "contrast":
        c_a, c_b = _contrast_map(xa), _contrast_map(xb)
        c_b_in_a = image_ops.sample_bilinear(c_b, flat_corr, (H, W)).reshape(
            B, H, W, 1)
        cells = unfold2d(vw * 0.5 * (c_a + c_b_in_a) + (1.0 - vw) * c_a, 8)
        teacher = torch.softmax(torch.cat(
            [teacher_gain * cells, torch.zeros_like(cells[..., :1])], -1), -1)
    elif kp_teacher == "peak":
        resp = _RESPONSES[response]
        r_a, r_b = resp(xa), resp(xb)
        r_b_in_a = image_ops.sample_bilinear(r_b, flat_corr, (H, W)).reshape(
            B, H, W, 1)
        teacher = peak_teacher(vw * 0.5 * (r_a + r_b_in_a) + (1.0 - vw) * r_a,
                               sigma=sigma)
    else:
        raise ValueError(f"kp_teacher {kp_teacher!r}: 'contrast' or 'peak'")
    # optax.softmax_cross_entropy
    kp_loss = (-(teacher * F.log_softmax(logits_a, -1)).sum(-1).mean()
               / n_data)

    # ---- reliability: cross-view descriptor agreement ----
    agree = ((fa * fb_pos).sum(-1) * 0.5 + 0.5).detach() * w
    rel_loss = ((heat_a.reshape(B, N) - agree) ** 2).mean() / n_data

    # ---- cross-view localization agreement (loc_weight > 0) ----
    loc_loss = torch.zeros((), **f32)
    if loc_weight > 0.0:
        c64 = torch.arange(64, **f32)

        def cell_peaks(lg):
            p64 = torch.softmax(lg, -1)[..., :64].reshape(B, N, 64)
            kpness = p64.sum(-1)  # 1 - dustbin
            w_in = p64 / kpness[..., None].clamp_min(1e-6)
            return (w_in * (c64 % 8)).sum(-1), (w_in * (c64 // 8)).sum(-1), \
                kpness

        pax, pay, kp_a = cell_peaks(logits_a)
        pbx, pby, kp_b = cell_peaks(logits_b)
        ox = torch.arange(W8, **f32)[None, None, :] * 8.0
        oy = torch.arange(H8, **f32)[None, :, None] * 8.0
        peak_a = torch.stack([(ox + pax.reshape(B, H8, W8)).reshape(B, N),
                              (oy + pay.reshape(B, H8, W8)).reshape(B, N)], -1)
        # A's peak warped into B through the dense correspondence, sampled
        # at exact pixel positions
        in_b = image_ops.sample_bilinear_px(corr_px, peak_a)
        v_at_peak = image_ops.sample_bilinear_px(
            px_valid[..., None].float(), peak_a)[..., 0] > 0.99
        v_at_peak &= ((in_b[..., 0] >= 1.0) & (in_b[..., 0] < W - 1)
                      & (in_b[..., 1] >= 1.0) & (in_b[..., 1] < H - 1))
        cbx = torch.floor(in_b[..., 0] / 8).long().clamp(0, W8 - 1)
        cby = torch.floor(in_b[..., 1] / 8).long().clamp(0, H8 - 1)
        cell = cby * W8 + cbx
        peak_b = torch.stack([cbx.float() * 8.0 + pbx.gather(1, cell),
                              cby.float() * 8.0 + pby.gather(1, cell)], -1)
        d2 = ((peak_b - in_b) ** 2).sum(-1)
        hub = torch.where(d2 < 4.0, d2, 4.0 * (torch.sqrt(d2) - 1.0))
        # a gate, not a path that shrinks every cell's mass
        wgt = (torch.minimum(kp_a, kp_b.gather(1, cell))
               * v_at_peak.float()).detach()
        loc_loss = (loc_weight * (wgt * hub).sum()
                    / total(wgt.sum()).clamp_min(1.0))

    return nce + kp_loss + rel_loss + loc_loss, {
        "nce": nce, "kp": kp_loss, "rel": rel_loss, "loc": loc_loss}


def warmup_cosine_schedule(lr: float, steps: int):
    """``optax.warmup_cosine_decay_schedule(0, lr, int(0.05 * steps),
    steps, lr / 20)`` as a function of the step count (from 0): a linear
    warmup from 0 to ``lr``, then a cosine decay to ``lr / 20`` at
    ``steps``."""
    warm = int(steps * 0.05)
    decay = steps - warm
    alpha = 1.0 / 20.0

    def schedule(count: int) -> float:
        if count < warm:
            return -lr * (1.0 - min(max(count, 0), warm) / warm) + lr
        c = min(count - warm, decay)
        cos = 0.5 * (1.0 + math.cos(math.pi * c / decay))
        return lr * ((1.0 - alpha) * cos + alpha)

    return schedule


class Adam:
    """``optax.adam(learning_rate)`` on ``torch.optim.Adam``: betas 0.9 and
    0.999, eps 1e-8, ``learning_rate`` a float or a schedule of the step
    count, read before each step as optax reads it (from 0)."""

    def __init__(self, params, learning_rate=1e-3):
        self.schedule = learning_rate if callable(learning_rate) else None
        lr = self.schedule(0) if self.schedule else float(learning_rate)
        self.opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999),
                                    eps=1e-8)
        self.count = 0

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def step(self):
        if self.schedule is not None:
            for group in self.opt.param_groups:
                group["lr"] = float(self.schedule(self.count))
        self.opt.step()
        self.count += 1


def adam(learning_rate=1e-3):
    """An optimizer factory for the trainers: ``adam(lr)(params)``."""
    return lambda params: Adam(params, learning_rate)


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms for a training step on the GPU: cuDNN's
    deterministic convolutions (no autotuning) and the ordered scatter-adds
    behind the gathers' backward. Ops with no deterministic version warn
    rather than raise. Restores the settings on exit."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.backends.cudnn.deterministic = prev[2]
        torch.backends.cudnn.benchmark = prev[3]


def _step(model, opt, batch, aug, loss_kw, mesh=None):
    """One optimizer step; on a mesh, ``batch`` and ``aug`` are this rank's
    rows and the step is the whole batch's (gradients, loss and aux summed
    over the data ranks)."""
    opt.zero_grad()
    loss, aux = loss_fn(model, batch, aug=aug, mesh=mesh, **loss_kw)
    loss.backward()
    figures = [loss.detach(), *(v.detach() for v in aux.values())]
    if mesh is not None:
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        flat = mesh.data_sum(torch.cat([g.reshape(-1) for g in grads]))
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view(g.shape))
        figures = mesh.data_sum(torch.stack(figures)).unbind()
    opt.step()
    return figures[0], dict(zip(aux, figures[1:]))


def _local_aug(mesh, aug, shapes, device):
    """This rank's rows of the whole batch's augmentation: ``aug`` drawn
    from a generator as one device draws it (A's numbers, then B's, of
    ``shapes``), or the whole batch's draws given; None stays None."""
    if isinstance(aug, torch.Generator):
        aug = tuple(draw_aug(aug, shape, device) for shape in shapes)
    return None if aug is None else tuple(
        {k: mesh.shard_batch(v) for k, v in d.items()} for d in aug)


def _one_rank(mesh):
    """None for no mesh or a mesh of one rank: the one-device code."""
    return None if mesh is None or mesh.size == 1 else mesh


def make_train_step(optimizer=None, mesh=None, **loss_kw):
    """Returns (init_fn, step_fn): ``init_fn(model)`` -> (model, opt), the
    optimizer built over the trainable ``model``'s parameters (``adam(1e-3)``
    unless ``optimizer`` is given); ``step_fn(model, opt, batch, aug=None)``
    -> (model, opt, loss, aux) takes one optimizer step in place, under
    ``deterministic()``. ``loss_kw`` goes to ``loss_fn``.

    With a ``mesh`` of more than one rank, ``init_fn`` partitions the model
    (``shard_model``, strict) and every rank passes the whole batch (and
    ``aug``: a generator, seeded alike on every rank, or the whole batch's
    draws); each rank steps on its rows and the returned loss and aux are
    the whole batch's."""
    optimizer = optimizer or adam(1e-3)
    mesh = _one_rank(mesh)

    def init_fn(model):
        if mesh is not None:
            shard_model(model, mesh)
        return model, optimizer(model.parameters())

    def step_fn(model, opt, batch, aug=None):
        if mesh is not None:
            aug = _local_aug(mesh, aug, (batch["img_a"].shape,
                                         batch["img_b"].shape),
                             batch["img_a"].device)
            batch = {k: mesh.shard_batch(v) for k, v in batch.items()}
        with deterministic():
            loss, aux = _step(model, opt, batch, aug, loss_kw, mesh)
        return model, opt, loss, aux

    return init_fn, step_fn


def make_pool_trainer(optimizer=None, steps_per_call: int = 16,
                      augment: bool = True, mesh=None, **loss_kw):
    """A trainer over a pair pool that stays on the device.

    Returns (init_fn, run_fn): ``init_fn`` as ``make_train_step``'s;
    ``run_fn(model, opt, pool, idx, gen)`` -> (model, opt, mean_loss,
    mean_aux) takes ``idx.shape[0]`` (``steps_per_call``) optimizer steps,
    step s on the pool rows ``idx[s]`` gathered on the device, the
    augmentation's numbers drawn from ``gen`` when ``augment``; the steps
    run as ``make_train_step``'s, under ``deterministic()``. The mean loss
    and aux stay on the device (one read for the caller).

    With a ``mesh`` of more than one rank, every rank passes the same pool,
    ``idx`` and seeded ``gen``: each takes its data rank's part of each
    step's rows, and its part of the draws made for the whole batch."""
    optimizer = optimizer or adam(1e-3)
    mesh = _one_rank(mesh)
    init_fn, _ = make_train_step(optimizer, mesh)

    def run_fn(model, opt, pool, idx, gen=None):
        if idx.shape[0] != steps_per_call:
            raise ValueError(f"idx has {idx.shape[0]} steps, the trainer "
                             f"{steps_per_call}")
        total, totals = 0.0, {}
        with deterministic():
            for s in range(idx.shape[0]):
                rows = idx[s] if mesh is None else mesh.shard_batch(idx[s])
                batch = {k: v[rows] for k, v in pool.items()}
                aug = gen if augment else None
                if mesh is not None:
                    aug = _local_aug(mesh, aug, [
                        (idx.shape[1], *pool[k].shape[1:])
                        for k in ("img_a", "img_b")], pool["img_a"].device)
                loss, aux = _step(model, opt, batch, aug, loss_kw, mesh)
                total = total + loss
                totals = {k: totals.get(k, 0.0) + v for k, v in aux.items()}
        n = idx.shape[0]
        return model, opt, total / n, {k: v / n for k, v in totals.items()}

    return init_fn, run_fn
