"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
card and no explicit CPU request they raise instead of quietly running
on the CPU (a CPU run says nothing about the card's speed or kernels).
"""
import contextlib
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """None -> ``cuda``. Raises if a CUDA device is requested (explicitly
    or by default) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "notsofar_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain PyTorch path")
    return dev


@contextlib.contextmanager
def cudnn_f32():
    """cuDNN convolutions and RNNs in full f32 inside the block. PyTorch
    lets cuDNN round f32 operands to TF32 (10 mantissa bits) by default
    (``torch.backends.cudnn.allow_tf32``), which a float32 model that is
    held to the JAX package's f32 numerics must not do; the setting is
    restored on exit. Matmuls already default to f32
    (``torch.backends.cuda.matmul.allow_tf32`` is False)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev
