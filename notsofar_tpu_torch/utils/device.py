"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
card and no explicit CPU request they raise instead of quietly running
on the CPU (a CPU run says nothing about the card's speed or kernels).
"""
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
