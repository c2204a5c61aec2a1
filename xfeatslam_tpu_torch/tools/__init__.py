"""Command-line tools on the port, each a twin of a script in ``tools/``
but ``network_layers`` (the card only):
``python -m xfeatslam_tpu_torch.tools.<name> --help``."""


def float32_math():
    """Float32 convolutions and matmuls on the card, as the JAX package
    computes them: PyTorch's default lets cuDNN run float32 convolutions in
    TF32. Each tool's ``main`` calls this, as the examples do."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
