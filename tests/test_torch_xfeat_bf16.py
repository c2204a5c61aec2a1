"""The port's bfloat16 forward held to tests/test_xfeat_bf16.py's bars: at
480x640 with 500 features and the shipped weights, the 200 strongest
float32 keypoints each have a bf16 keypoint within 1 px at a share >= 0.85,
and the median descriptor cosine at those keypoints is >= 0.995; against
the port's own float32 extraction and against the JAX package's float32
extractor. Bit parity with JAX's bf16 is not asked: the port rounds each
conv's sum to bf16 before the float32 bias add, JAX after it (ROADMAP
T.2)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

import jax.numpy as jnp  # noqa: E402

from xfeatslam_tpu.models.extractor import XFeatExtractor as JaxExtractor  # noqa: E402,E501
from xfeatslam_tpu.utils.synthetic import RoomScene  # noqa: E402
from xfeatslam_tpu_torch.models.extractor import XFeatExtractor  # noqa: E402

from test_torch_xfeat import NPZ  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rendered_frame(hw=(480, 640)):
    """tests/test_xfeat_bf16.py's frame."""
    K = np.array([[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1]],
                 np.float32)
    gray, _ = RoomScene(seed=4).render(K, np.eye(3, dtype=np.float32),
                                       np.array([0.0, -0.4, -0.2],
                                                np.float32), hw)
    return gray


def bf16_agreement(o32, o16, top_n=200):
    """(share of the top_n strongest float32 keypoints with a bf16 keypoint
    within 1 px, median descriptor cosine at them): test_xfeat_bf16.py's
    measure."""
    v32 = o32["valid"][0]
    k32, s32 = o32["kpts"][0][v32], o32["scores"][0][v32]
    v16 = o16["valid"][0]
    k16 = o16["kpts"][0][v16]
    assert len(k32) >= 100 and len(k16) >= 100
    top = np.argsort(-s32)[:top_n]
    d = np.linalg.norm(k32[top, None, :] - k16[None, :, :], axis=-1)
    nearest = d.min(axis=1)
    agree = nearest <= 1.0
    d32 = o32["desc"][0][v32][top][agree]
    d16 = o16["desc"][0][v16][d.argmin(axis=1)[agree]]
    return float(agree.mean()), float(np.median((d32 * d16).sum(-1)))


@pytest.fixture(scope="module")
def outputs():
    img = _rendered_frame()
    ex32 = XFeatExtractor(weights_path=NPZ, nfeatures=500, device="cpu")
    ex16 = XFeatExtractor(model=ex32.model, nfeatures=500,
                          compute_dtype=torch.bfloat16, device="cpu")
    jex = JaxExtractor(weights_path=NPZ, nfeatures=500,
                       compute_dtype=jnp.float32)
    return {"port_f32": ex32(img), "port_bf16": ex16(img), "jax_f32": jex(img)}


@pytest.mark.parametrize("reference", ["port_f32", "jax_f32"])
def test_bf16_selection_matches_f32(outputs, reference):
    frac, cos = bf16_agreement(outputs[reference], outputs["port_bf16"])
    assert frac >= 0.85, frac
    assert cos >= 0.995, cos


def test_bf16_heads_come_out_float32(outputs):
    o16 = outputs["port_bf16"]
    assert o16["desc"].dtype == np.float32
    assert o16["kpts"].dtype == np.float32
    # the port's float32 extraction is the JAX package's (the parity the
    # bars above are measured from)
    frac, cos = bf16_agreement(outputs["jax_f32"], outputs["port_f32"])
    assert frac >= 0.99 and cos >= 0.9999, (frac, cos)
