"""DFT-matrix STFT / iSTFT as f32 matmuls.

Port of notsofar_tpu/ops/stft.py: the reference conv1d STFT's analysis
matrix (``rfft(eye(N)/S) * window``, with the NOTSOFAR no-conjugate fix)
applied as ``frames @ K^T``. For frame_len == 2*hop (the NOTSOFAR
configuration) framing is two reshapes and a concat, and the iSTFT's
overlap-add is two adds on a slot grid, as in the JAX package.

The matmuls run in f32; TF32 must stay off for them (PyTorch's default:
``torch.backends.cuda.matmul.allow_tf32`` is False), because the raw IPD
features downstream flip by 2*pi under any error near the branch cut.
"""
import math
from typing import Tuple

import numpy as np
import torch


def _make_window(frame_len: int, window: str) -> np.ndarray:
    # torch.hann_window(N) is the *periodic* hann: 0.5*(1-cos(2*pi*n/N))
    n = np.arange(frame_len, dtype=np.float64)
    hann = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / frame_len))
    if window == "hann":
        return hann
    if window == "sqrt_hann":
        return np.sqrt(hann)
    raise ValueError(f"unsupported window: {window}")


def make_stft_kernels(frame_len: int = 512, frame_hop: int = 256,
                      window: str = "hann", normalize: bool = True,
                      round_pow_of_two: bool = True
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The (real, imag) analysis matrices, each [F, frame_len] f32: N =
    next pow2 of frame_len, scale S = 0.5*sqrt(N*N/hop) only for
    normalized sqrt_hann, row f = w[n] * exp(-2pi i f n / N) / S."""
    N = 2 ** math.ceil(math.log2(frame_len)) if round_pow_of_two else frame_len
    w = _make_window(frame_len, window)
    if window == "sqrt_hann" and normalize:
        S = 0.5 * (N * N / frame_hop) ** 0.5
    else:
        S = 1.0
    n = np.arange(frame_len, dtype=np.float64)
    f = np.arange(N // 2 + 1, dtype=np.float64)
    phase = 2.0 * np.pi * np.outer(f, n) / N  # [F, frame_len]
    Kr = np.cos(phase) * (w / S)
    Ki = -np.sin(phase) * (w / S)
    return Kr.astype(np.float32), Ki.astype(np.float32)


def num_frames(num_samples: int, frame_len: int = 512, frame_hop: int = 256) -> int:
    """'valid' conv frame count, matching F.conv1d(stride=hop, padding=0)."""
    return (num_samples - frame_len) // frame_hop + 1


def frame_signal(x: torch.Tensor, frame_len: int,
                 frame_hop: int) -> torch.Tensor:
    """Frame the last axis: [..., S] -> [..., T, frame_len]."""
    S = x.shape[-1]
    T = num_frames(S, frame_len, frame_hop)
    if frame_len == 2 * frame_hop:
        usable = (T + 1) * frame_hop
        a = x[..., :usable].reshape(*x.shape[:-1], T + 1, frame_hop)
        return torch.cat([a[..., :-1, :], a[..., 1:, :]], dim=-1)
    return x.unfold(-1, frame_len, frame_hop)


def overlap_add(frames: torch.Tensor, frame_hop: int) -> torch.Tensor:
    """Overlap-add [..., T, L] -> [..., (T-1)*hop + L]."""
    T, L = frames.shape[-2], frames.shape[-1]
    lead = frames.shape[:-2]
    if L == 2 * frame_hop:
        slots = frames.new_zeros((*lead, T + 1, frame_hop))
        slots[..., :-1, :] += frames[..., :frame_hop]
        slots[..., 1:, :] += frames[..., frame_hop:]
        return slots.reshape(*lead, (T + 1) * frame_hop)
    out = frames.new_zeros((*lead, (T - 1) * frame_hop + L))
    idx = (torch.arange(T, device=frames.device)[:, None] * frame_hop
           + torch.arange(L, device=frames.device)[None, :]).reshape(-1)
    return out.index_add_(-1, idx, frames.reshape(*lead, T * L))


class STFT:
    """STFT/iSTFT pair with the analysis matrices on `device`."""

    def __init__(self, frame_len: int = 512, frame_hop: int = 256,
                 window: str = "hann", normalize: bool = True,
                 round_pow_of_two: bool = True, device="cpu"):
        self.frame_len = frame_len
        self.frame_hop = frame_hop
        self.window = window
        Kr, Ki = make_stft_kernels(frame_len, frame_hop, window, normalize,
                                   round_pow_of_two)
        self.Kr = torch.from_numpy(Kr).to(device)   # [F, frame_len]
        self.Ki = torch.from_numpy(Ki).to(device)
        self.num_bins = Kr.shape[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [..., S] real f32 -> complex64 STFT [..., F, T]."""
        frames = frame_signal(x, self.frame_len, self.frame_hop)  # [..,T,L]
        r = torch.matmul(self.Kr, frames.transpose(-1, -2))       # [..,F,T]
        i = torch.matmul(self.Ki, frames.transpose(-1, -2))
        return torch.complex(r, i)

    def mag_phase(self, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [..., S] -> (magnitude, phase), each [..., F, T]."""
        c = self.forward(x)
        return c.abs(), c.angle()

    def inverse(self, c: torch.Tensor) -> torch.Tensor:
        """c: complex [..., F, T] -> real [..., S], the exact adjoint of
        `forward` (conv_transpose1d with the same kernel)."""
        frames = (torch.matmul(c.real.transpose(-1, -2), self.Kr)
                  + torch.matmul(c.imag.transpose(-1, -2), self.Ki))
        return overlap_add(frames, self.frame_hop)
