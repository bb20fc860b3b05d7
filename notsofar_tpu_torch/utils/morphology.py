"""1-D binary morphology (erode/dilate).

Port of notsofar_tpu/utils/morphology.py: numpy host versions and tensor
versions on any device (max pooling along one axis). Outside the signal,
dilation counts as False and erosion as True, as the JAX package's
reduce_window padding does.
"""
import numpy as np
import torch
import torch.nn.functional as F


def erode_np(arr: np.ndarray, iters: int) -> np.ndarray:
    assert arr.ndim == 1
    if iters <= 0:
        return arr.copy()
    p = np.pad(arr, iters, mode="constant", constant_values=1)
    return np.lib.stride_tricks.sliding_window_view(p, 2 * iters + 1).min(1)


def dilate_np(arr: np.ndarray, iters: int) -> np.ndarray:
    assert arr.ndim == 1
    if iters <= 0:
        return arr.copy()
    p = np.pad(arr, iters, mode="constant", constant_values=0)
    return np.lib.stride_tricks.sliding_window_view(p, 2 * iters + 1).max(1)


def _max_window(x: torch.Tensor, iters: int, axis: int) -> torch.Tensor:
    """Max over a (2*iters + 1)-wide window along `axis`; positions
    outside the signal never win (max_pool1d pads with -inf)."""
    xt = x.float().movedim(axis, -1)
    lead = xt.shape[:-1]
    out = F.max_pool1d(xt.reshape(-1, 1, xt.shape[-1]), 2 * iters + 1,
                       stride=1, padding=iters)
    return out.reshape(*lead, -1).movedim(-1, axis)


def dilate(x: torch.Tensor, iters: int, axis: int = 0) -> torch.Tensor:
    """Binary dilation along `axis` of a boolean/0-1 tensor (any rank)."""
    if iters <= 0:
        return x
    return _max_window(x, iters, axis) > 0.5


def erode(x: torch.Tensor, iters: int, axis: int = 0) -> torch.Tensor:
    """Binary erosion along `axis`; outside-signal values count as True."""
    if iters <= 0:
        return x
    return -_max_window(-x.float(), iters, axis) > 0.5
