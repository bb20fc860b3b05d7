"""Permutation-invariant loss by brute force over the S! permutations.

Port of notsofar_tpu/ops/pit.py (the reference PitWrapper without the
host Hungarian solver: with 3 sources there are 6 permutations).

    preds/targets: [B, ..., S] (sources last).
    returns (loss [B], perm [B, S]): loss is the per-sample mean of the
    optimally assigned pairwise losses; targets[..., perm[b]] aligns with
    preds[b]. Ties go to the first permutation in itertools order.
"""
import functools
import itertools
from typing import Callable, Tuple

import numpy as np
import torch


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise squared error (no reduction)."""
    return (pred - target) ** 2


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise absolute error (no reduction)."""
    return torch.abs(pred - target)


BASE_LOSSES = {"mse": mse_loss, "l1": l1_loss}


def _permutations(n: int) -> np.ndarray:
    return np.array(list(itertools.permutations(range(n))), dtype=np.int64)


@functools.lru_cache(maxsize=16)
def _device_permutations(n: int, device: torch.device) -> torch.Tensor:
    """The [n!, n] permutation table on `device`, copied there once: a copy
    from pageable host memory in every call would make the host wait for
    the card's queued work (a train step's forward pass)."""
    return torch.from_numpy(_permutations(n)).to(device)


def pairwise_loss_matrix(preds: torch.Tensor, targets: torch.Tensor,
                         base_loss: Callable) -> torch.Tensor:
    """[B, ..., S] x [B, ..., S] -> [B, S, S]: loss_mat[b, i, j] = mean
    over the non-source dims of base_loss(preds[..., i], targets[..., j])."""
    lm = base_loss(preds[..., :, None], targets[..., None, :])
    dims = tuple(range(1, lm.dim() - 2))
    return lm.mean(dim=dims) if dims else lm


def pit_loss(preds: torch.Tensor, targets: torch.Tensor, base: str = "mse"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (loss [B], perm [B, S] int64): the minimum over
    permutations of the mean assigned loss, and that permutation of the
    targets."""
    lm = pairwise_loss_matrix(preds, targets, BASE_LOSSES[base])  # [B,S,S]
    S = lm.shape[-1]
    perms = _device_permutations(S, lm.device)                   # [P, S]
    # totals[b, p] = mean_s lm[b, s, perms[p, s]]
    gathered = lm[:, torch.arange(S, device=lm.device)[None, :], perms]
    totals = gathered.mean(dim=-1)                                # [B, P]
    best = torch.argmin(totals, dim=-1)
    loss = totals.gather(1, best[:, None])[:, 0]
    return loss, perms[best]


def permute_sources(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """out[b, ..., s] = x[b, ..., perm[b, s]]; x: [B, ..., S]; perm [B, S]."""
    B, S = perm.shape
    idx = perm.reshape(B, *([1] * (x.dim() - 2)), S).expand(x.shape)
    return torch.gather(x, -1, idx.to(torch.int64))
