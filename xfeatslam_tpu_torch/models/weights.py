"""XFeat weight IO: npz checkpoints, torch state dicts with BatchNorm
folding, and parameters carried over from the JAX package.

Counterpart of ``xfeatslam_tpu/models/weights.py``. The on-disk and numpy
parameter layout is the JAX package's pytree, so both packages read the
same ``weights/xfeat_synthetic.npz``:

  {"block1": [{"w": HWIO, "b": (cout,)}, ...], ..., "skip1_conv": {...},
   "fine_matcher": [{"w": (in, out), "b": (out,)}, ...]}

``from_jax_params`` turns that pytree into an ``XFeat`` module (HWIO ->
OIHW, (in,out) -> (out,in)) on a device; ``to_params`` goes back, and
``grads_to_params`` maps a trainable model's gradients the same way. On a
model partitioned over a mesh's "model" axis (``parallel/train.shard_model``)
both gather each split layer's parts back into the whole pytree: they are
collectives, which every rank of the model axis calls.

Folding a reference BasicLayer y = relu(BN(conv(x))) with BN affine=False:
  w' = w * s,  b' = -mean * s,  s = 1/sqrt(var + eps)
Linear+BN1d pairs in fine_matcher fold the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .xfeat import (_BASIC_STACKS, _FINAL_CONVS, _FINE_MATCHER, BN_EPS, XFeat,
                    init_params)

# torch Sequential indices of the plain convs that end each stack
_FINAL_TORCH_KEYS = {
    "skip1_conv": "skip1.1",
    "block_fusion_final": "block_fusion.2",
    "heatmap_final": "heatmap_head.2",
    "keypoint_final": "keypoint_head.3",
}


def _strip_prefix(sd):
    """Drop a leading 'net.' prefix if present (python-side wrappers)."""
    if any(k.startswith("net.") for k in sd):
        return {k[4:]: v for k, v in sd.items() if k.startswith("net.")}
    return sd


def from_torch_state_dict(sd) -> dict:
    """Convert a reference-layout torch state_dict (tensors or ndarrays) to
    the folded numpy parameter pytree."""
    sd = _strip_prefix(sd)

    def arr(k):
        v = sd[k]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return np.asarray(v, dtype=np.float32)

    params = {}
    for name, layers in _BASIC_STACKS.items():
        stack = []
        for i, _spec in enumerate(layers):
            w = arr(f"{name}.{i}.layer.0.weight")  # OIHW
            mean = arr(f"{name}.{i}.layer.1.running_mean")
            var = arr(f"{name}.{i}.layer.1.running_var")
            s = 1.0 / np.sqrt(var + BN_EPS)
            w = np.transpose(w, (2, 3, 1, 0)) * s[None, None, None, :]
            stack.append({"w": w, "b": -mean * s})
        params[name] = stack

    for name, tkey in _FINAL_TORCH_KEYS.items():
        params[name] = {"w": np.transpose(arr(f"{tkey}.weight"), (2, 3, 1, 0)),
                        "b": arr(f"{tkey}.bias")}

    fm = []
    lin_idx = [0, 3, 6, 9, 12]
    bn_idx = [1, 4, 7, 10, None]
    for li, bi in zip(lin_idx, bn_idx):
        w = arr(f"fine_matcher.{li}.weight").T  # (in, out)
        b = arr(f"fine_matcher.{li}.bias")
        if bi is not None:
            mean = arr(f"fine_matcher.{bi}.running_mean")
            var = arr(f"fine_matcher.{bi}.running_var")
            s = 1.0 / np.sqrt(var + BN_EPS)
            w = w * s[None, :]
            b = (b - mean) * s
        fm.append({"w": w, "b": b})
    params["fine_matcher"] = fm
    return params


def _paths():
    """(attribute name, index or None) of every conv/linear, in the order of
    the parameter pytree."""
    for name, layers in _BASIC_STACKS.items():
        for i in range(len(layers)):
            yield name, i
    for name in _FINAL_CONVS:
        yield name, None
    for i in range(len(_FINE_MATCHER)):
        yield "fine_matcher", i


def _node(tree, path):
    """The pytree node or module at ``path``."""
    name, i = path
    node = tree[name] if isinstance(tree, dict) else getattr(tree, name)
    return node if i is None else node[i]


def _build(params_np, dev) -> XFeat:
    """An ``XFeat`` on ``dev`` holding the JAX-layout pytree's values."""
    model = XFeat()
    with torch.no_grad():
        for path in _paths():
            node = _node(params_np, path)
            w = np.asarray(node["w"], np.float32)
            # HWIO -> OIHW for convs, (in, out) -> (out, in) for linears
            w = np.transpose(w, (3, 2, 0, 1)) if w.ndim == 4 else w.T
            layer = _node(model, path)
            layer.weight.copy_(torch.tensor(w))
            layer.bias.copy_(torch.tensor(np.asarray(node["b"], np.float32)))
    return model.to(dev, memory_format=torch.channels_last)


def from_jax_params(params_np, device=None) -> XFeat:
    """Build the port's ``XFeat`` from the JAX package's parameter pytree
    (any arrays numpy can read, numpy or jax), frozen for inference. Runs
    on CUDA unless ``device`` says otherwise."""
    model = _build(params_np, resolve_device(device))
    model.requires_grad_(False)
    return model.eval()


def trainable(source=0, device=None) -> XFeat:
    """The same ``XFeat`` with trainable parameters, for
    ``parallel/train.py``: ``source`` is a JAX-layout parameter pytree, the
    path of an npz checkpoint, or the seed of the port's ``init_params``.
    Runs on CUDA unless ``device`` says otherwise."""
    if isinstance(source, str):
        source = load_npz_params(source)
    elif isinstance(source, (int, np.integer)):
        source = init_params(int(source))
    return _build(source, resolve_device(device)).train()


def _prefix(path):
    name, i = path
    return name if i is None else f"{name}.{i}"


def _tree(nodes):
    """Assemble the parameter pytree from ``(path, node)`` pairs given in
    ``_paths()`` order."""
    params: dict = {}
    for (name, i), node in nodes:
        if i is None:
            params[name] = node
        else:
            params.setdefault(name, []).append(node)
    return params


def _whole(layer, t):
    """``t``, a parameter of ``layer`` or its gradient, whole: gathered
    over the mesh's "model" axis where the layer is split."""
    split = getattr(layer, "model_split", None)
    return t.detach() if split is None else split.gather(t)


def to_params(model: XFeat) -> dict:
    """The inverse of ``from_jax_params``: numpy pytree in JAX layout."""
    def node(layer):
        w = _whole(layer, layer.weight).float().cpu().numpy()
        w = np.transpose(w, (2, 3, 1, 0)) if w.ndim == 4 else w.T
        return {"w": np.ascontiguousarray(w),
                "b": _whole(layer, layer.bias).float().cpu().numpy()}

    return _tree((path, node(_node(model, path))) for path in _paths())


def grads_to_params(model: XFeat) -> dict:
    """The ``.grad`` of every parameter as a numpy pytree in JAX's layout
    (HWIO convs, (in, out) linears), zeros where no gradient reached a
    parameter (as ``jax.grad`` gives for an unused one)."""
    def arr(layer, p):
        g = torch.zeros_like(p) if p.grad is None else p.grad
        g = _whole(layer, g).float().cpu().numpy()
        return np.transpose(g, (2, 3, 1, 0)) if g.ndim == 4 else g.T

    def node(layer):
        return {"w": np.ascontiguousarray(arr(layer, layer.weight)),
                "b": arr(layer, layer.bias)}

    return _tree((path, node(_node(model, path))) for path in _paths())


def save_npz(path: str, model) -> None:
    """Write the model, or its ``to_params`` pytree, in the JAX package's
    npz layout (``name.i.w``)."""
    params = model if isinstance(model, dict) else to_params(model)
    flat = {}
    for p in _paths():
        node = _node(params, p)
        flat[f"{_prefix(p)}.w"] = node["w"]
        flat[f"{_prefix(p)}.b"] = node["b"]
    np.savez(path, **flat)


def load_npz_params(path: str) -> dict:
    """Read an npz checkpoint into the numpy parameter pytree."""
    with np.load(path) as data:
        return _tree((p, {"w": data[f"{_prefix(p)}.w"],
                          "b": data[f"{_prefix(p)}.b"]}) for p in _paths())


def load_npz(path: str, device=None) -> XFeat:
    """Load an npz checkpoint (BN-folded HWIO) as an ``XFeat`` on CUDA
    unless ``device`` says otherwise."""
    return from_jax_params(load_npz_params(path), device=device)


def load_torch(path: str, device=None) -> XFeat:
    """Load a reference .pt/.pth checkpoint, fold BN and build the model."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return from_jax_params(from_torch_state_dict(obj), device=device)
