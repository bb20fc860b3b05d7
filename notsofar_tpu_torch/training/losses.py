"""CSS training loss: PIT speaker loss + noise loss.

Port of notsofar_tpu/training/losses.py (the reference's _calc_loss). Both
published loss modes:

* 'masked_mag' — |mask * mix_mag| vs GT magnitude (v0.5 era models);
* 'mask' — mask vs ideal-ratio GT/mix_mag (the shipped v1.0 models, l1).

The PIT assignment over 3 speakers is the brute-force argmin of ops/pit.py.
The noise mask is non-PIT with a fixed weight.
"""
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from notsofar_tpu_torch.models.css_wrapper import CssModel
from notsofar_tpu_torch.ops.pit import BASE_LOSSES, permute_sources, pit_loss

EPS = float(np.finfo(np.float32).eps)


def gt_mic0_stft_mag(model: CssModel, gt: torch.Tensor, ref_mic: int = 0
                     ) -> torch.Tensor:
    """gt: [B, T, Mics, Max_spks] -> magnitude [B, F, T', Max_spks]."""
    g = gt[:, :, ref_mic, :].transpose(1, 2)       # [B, S, T]
    B, S, T = g.shape
    c = model.stft(g.reshape(B * S, T))            # [B*S, F, T']
    mag = c.abs().reshape(B, S, *c.shape[1:])
    return mag.movedim(1, -1)                      # [B, F, T', S]


def css_loss(model: CssModel, masks: Dict[str, torch.Tensor],
             batch: Dict[str, torch.Tensor], loss_name: str,
             base_loss_name: str, noise_weight: float = 1.0,
             clip_gt_to_mixture: bool = False,
             calc_side_info: bool = False, ref_mic: int = 0
             ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """masks: model output dict; batch: mixture/gt columns [B, T, Mics(,S)].

    Returns (scalar loss, side_info dict of 0-d tensors or None).
    """
    base_loss = BASE_LOSSES[base_loss_name]
    mix = batch["mixture"]
    mix_mag = model.stft(mix[:, :, ref_mic]).abs()[..., None]    # [B,F,T,1]

    gt_spks = gt_mic0_stft_mag(model, batch["gt_spk_direct_early_echoes"],
                               ref_mic)                          # [B,F,T,S]
    gt_noise = model.stft(batch["gt_noise"][:, :, ref_mic]).abs()  # [B,F,T]

    gt_spks_clipped = torch.minimum(gt_spks, mix_mag)
    gt_noise_clipped = torch.minimum(gt_noise, mix_mag[..., 0])
    gt_spks_eff = gt_spks_clipped if clip_gt_to_mixture else gt_spks
    gt_noise_eff = gt_noise_clipped if clip_gt_to_mixture else gt_noise

    pred_spk = masks["spk_masks"]
    pred_noise = masks["noise_masks"][..., 0]

    if loss_name == "masked_mag":
        spk_loss, perm = pit_loss(pred_spk * mix_mag, gt_spks_eff,
                                  base=base_loss_name)
        noise_loss = base_loss(pred_noise * mix_mag[..., 0],
                               gt_noise_eff).mean(dim=(1, 2))
    elif loss_name == "mask":
        spk_loss, perm = pit_loss(pred_spk, gt_spks_eff / (mix_mag + EPS),
                                  base=base_loss_name)
        noise_loss = base_loss(pred_noise,
                               gt_noise_eff / (mix_mag[..., 0] + EPS)
                               ).mean(dim=(1, 2))
    else:
        raise ValueError(f"Unknown loss name: {loss_name}!")

    loss = (spk_loss + noise_weight * noise_loss).mean()

    side_info = None
    if calc_side_info:
        def si(gts, gtn, prefix):
            expected_spk = permute_sources(gts, perm) / (mix_mag + EPS)
            expected_noise = gtn / (mix_mag[..., 0] + EPS)
            return {
                prefix + "spk_mask_l1": (pred_spk - expected_spk).abs().mean(),
                prefix + "noise_mask_l1":
                    (pred_noise - expected_noise).abs().mean(),
            }
        with torch.no_grad():
            side_info = {**si(gt_spks, gt_noise, ""),
                         **si(gt_spks_clipped, gt_noise_clipped, "clipped_")}
    return loss, side_info
