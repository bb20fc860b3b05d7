"""Training-time augmentations.

Port of notsofar_tpu/training/augmentations.py. Mic-shift: a random cyclic
rotation of the 6 circular microphones (mic 0 fixed), applied consistently
to the mixture and every GT column, as a per-sample gather on the batch's
device. The shifts are drawn from the caller's torch.Generator, or passed
in (the JAX package draws them from its step's PRNG key; a test passes
those).
"""
from typing import Dict, Optional

import torch

MIC_ARRAY_KEYS = ("mixture", "gt_spk_direct_early_echoes", "gt_spk_reverb",
                  "gt_noise")


def batch_roll_mics(arr: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Roll dim 2 (mics) per batch element: out[b,t,m] = arr[b,t,(m - s_b) % M].

    arr: [B, T, M] or [B, T, M, S]; shifts: [B] int.
    """
    B, M = arr.shape[0], arr.shape[2]
    idx = (torch.arange(M, device=arr.device)[None, :]
           - shifts.to(arr.device, torch.int64)[:, None]) % M   # [B, M]
    rows = torch.arange(B, device=arr.device)[:, None]
    # [B, M, T, ...] gathered per row, then mics back to dim 2
    return arr.transpose(1, 2)[rows, idx].transpose(1, 2)


def mic_shift_augment(batch: Dict[str, torch.Tensor],
                      generator: Optional[torch.Generator] = None,
                      shifts: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
    """Apply one random rotation (0..5) of mics 1..6 per sample: `shifts`
    [B] if given, else drawn from `generator` (on the batch's device)."""
    ref = batch["mixture"]
    assert ref.shape[2] == 7, "expecting 7 microphones at dim 2"
    if shifts is None:
        if generator is None:
            raise ValueError("mic_shift_augment draws its shifts from an "
                             "explicit torch.Generator; pass generator=")
        shifts = torch.randint(0, 6, (ref.shape[0],), generator=generator,
                               device=ref.device)
    out = dict(batch)
    for key in MIC_ARRAY_KEYS:
        if key in out:
            arr = out[key]
            rolled = batch_roll_mics(arr[:, :, 1:], shifts)
            out[key] = torch.cat([arr[:, :, :1], rolled], dim=2)
    return out
