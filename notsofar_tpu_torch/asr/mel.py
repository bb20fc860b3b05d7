"""Whisper-compatible log-mel spectrogram frontend in PyTorch.

Port of notsofar_tpu/asr/mel.py. Contract: n_fft=400, hop=160, periodic
hann, slaney-normalized mel filterbank (librosa.filters.mel defaults),
log10 with 1e-10 clamp, dynamic-range compression to max-8, then
(x+4)/4. The STFT stays a matmul against a precomputed DFT matrix, as in
the JAX package, so both packages compute the same sums.
"""
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE      # 480000
N_FRAMES = N_SAMPLES // HOP_LENGTH          # 3000


def hz_to_mel(f):
    """Slaney mel scale (librosa default, htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mel = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = f >= min_log_hz
    return np.where(above, min_log_mel
                    + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    mel)


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = m >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    freqs)


@lru_cache(maxsize=4)
def mel_filterbank(n_mels: int = 80, sr: int = SAMPLE_RATE,
                   n_fft: int = N_FFT) -> np.ndarray:
    """Slaney-style mel filterbank [n_mels, n_fft//2 + 1], norm='slaney'."""
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    fb *= enorm[:, None]
    return fb.astype(np.float32)


@lru_cache(maxsize=2)
def _stft_matrices(n_fft: int = N_FFT):
    n = np.arange(n_fft)
    w = 0.5 * (1 - np.cos(2 * np.pi * n / n_fft))  # periodic hann
    f = np.arange(n_fft // 2 + 1)
    phase = 2 * np.pi * np.outer(f, n) / n_fft
    return (np.cos(phase) * w).astype(np.float32), \
           (-np.sin(phase) * w).astype(np.float32)


def _log10_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """audio [..., L] f32 -> log10 mel power [..., n_mels, T]: reflect-
    padded centered STFT as a DFT matmul, last frame dropped (whisper)."""
    Kr, Ki = (torch.from_numpy(m).to(audio.device) for m in _stft_matrices())
    fb = torch.from_numpy(mel_filterbank(n_mels)).to(audio.device)
    lead = audio.shape[:-1]
    pad = N_FFT // 2
    x = F.pad(audio.float().reshape(-1, 1, audio.shape[-1]), (pad, pad),
              mode="reflect").reshape(*lead, -1)
    frames = x.unfold(-1, N_FFT, HOP_LENGTH)       # [..., T, n_fft]
    r = torch.matmul(frames, Kr.T)                 # [..., T, F]
    i = torch.matmul(frames, Ki.T)
    mag2 = (r * r + i * i)[..., :-1, :]
    mel = torch.matmul(fb, mag2.transpose(-1, -2))  # [..., n_mels, T]
    return torch.log10(torch.clamp_min(mel, 1e-10))


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80
                        ) -> torch.Tensor:
    """audio: [..., N_SAMPLES] float32 -> [..., n_mels, n_frames]."""
    log_spec = _log10_mel(audio, n_mels)
    maxv = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, maxv - 8.0)
    return (log_spec + 4.0) / 4.0


def log_mel_spectrogram_batch(audio: torch.Tensor,
                              valid_frames: torch.Tensor,
                              n_mels: int = 80) -> torch.Tensor:
    """Batched log_mel_spectrogram over streams of different lengths.

    audio: [B, L_max], each row its stream followed by zeros;
    valid_frames: [B] — the frame count the per-stream call would produce
    ((len_b + N_SAMPLES) // HOP_LENGTH). The dynamic-range clamp maxes over
    each row's valid frames only, so rows sliced to their own extent equal
    per-stream calls."""
    log_spec = _log10_mel(audio, n_mels)
    frame = torch.arange(log_spec.shape[-1], device=audio.device)
    mask = (frame[None, :] < valid_frames.to(audio.device)[:, None]
            )[:, None, :]
    masked = torch.where(mask, log_spec, torch.full_like(log_spec,
                                                         -float("inf")))
    maxv = masked.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, maxv - 8.0)
    return (log_spec + 4.0) / 4.0
