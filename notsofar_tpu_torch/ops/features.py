"""Spectral + spatial (IPD) feature extraction.

Port of notsofar_tpu/ops/features.py. The NOTSOFAR configuration is
window='hann', frame 512 / hop 256 (257 bins), ipd_index='1,0;...;6,0',
ipd_cos=False (raw normalized phase difference), mean-normalize v1,
log_spectrogram=False, mvn_spectrogram=True: MC feature dim
257*(1+6) = 1799, SC 257.

Raw IPD v1 is arctan2(yi - yim, yr - yrm): near its branch cut an
f32-level difference in the STFT flips a feature by 2*pi, so parity
checks feed both packages the same STFT.
"""
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from notsofar_tpu_torch.ops.stft import STFT

EPSILON = float(np.finfo(np.float32).eps)


def parse_index_pairs(index_str: str) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Parse '1,0;2,0;...' into (left_indices, right_indices)."""
    pairs = [tuple(map(int, p.split(","))) for p in index_str.split(";")]
    return tuple(t[0] for t in pairs), tuple(t[1] for t in pairs)


@dataclass(frozen=True)
class IPDConfig:
    ipd_index: str = "1,0;2,0;3,0;4,0;5,0;6,0"
    cos: bool = False
    sin: bool = False
    mean_normalize: bool = True
    mean_normalize_version: int = 1


def ipd_features(phase: torch.Tensor, cfg: IPDConfig) -> torch.Tensor:
    """Inter-channel phase differences: phase [B, C, F, T] -> [B, M*F, T]
    (M pairs, x2 with cos and sin)."""
    idx_l, idx_r = parse_index_pairs(cfg.ipd_index)
    pha_dif = phase[:, list(idx_l)] - phase[:, list(idx_r)]  # [B, M, F, T]
    if cfg.mean_normalize:
        yr = torch.cos(pha_dif)
        yi = torch.sin(pha_dif)
        yrm = yr.mean(-1, keepdim=True)
        yim = yi.mean(-1, keepdim=True)
        if cfg.mean_normalize_version == 1:
            pha_dif = torch.atan2(yi - yim, yr - yrm)
        elif cfg.mean_normalize_version == 2:
            pha_dif = pha_dif - torch.atan2(yim, yrm)
        elif cfg.mean_normalize_version == 3:
            pha_dif = pha_dif - pha_dif.mean(-1, keepdim=True)
        else:
            raise ValueError(f"unsupported ipd mean-normalize version: "
                             f"{cfg.mean_normalize_version}")
    if cfg.cos:
        out = torch.cos(pha_dif)
        if cfg.sin:
            out = torch.cat([out, torch.sin(pha_dif)], dim=2)
    else:
        out = pha_dif
    B, M, F, T = out.shape
    return out.reshape(B, M * F, T)


@dataclass(frozen=True)
class AngleConfig:
    """Mirror of AngleFeature's constructor (the reference feature.py)."""
    af_index: str = "1,0;2,0;3,0;4,0;5,0;6,0"
    geometric: str = "princeton"
    sr: int = 16000
    velocity: float = 340.0
    num_bins: int = 257
    num_doas: int = 1


def princeton_phase_delay(doa: torch.Tensor, cfg: AngleConfig) -> torch.Tensor:
    """Oracle per-mic phase delay for the 7-mic princeton circular array
    (radius 0.0425 m, mic 0 at the center). doa: [N] DoAs in radians
    (num_doas == 1); with num_doas == D the doa values are ignored and D
    DoAs spread uniformly on [0, 2pi). Returns [N, 7, F] (or
    [N, D, 7, F])."""
    if cfg.geometric != "princeton":
        raise ValueError(f"unsupported array geometric: {cfg.geometric}")
    if cfg.num_doas != 1:
        n = doa.shape[0]
        doa = torch.linspace(0.0, 2.0 * np.pi, cfg.num_doas + 1,
                             dtype=doa.dtype, device=doa.device
                             )[:-1].repeat(n, 1)
    radius = 0.0425
    zero = torch.zeros_like(doa)
    tau = radius * torch.stack([
        zero, -torch.cos(doa), -torch.cos(np.pi / 3 - doa),
        -torch.cos(2 * np.pi / 3 - doa), torch.cos(doa),
        torch.cos(np.pi / 3 - doa), torch.cos(2 * np.pi / 3 - doa)],
        dim=-1) / cfg.velocity                     # [N, 7] or [N, D, 7]
    omega = torch.tensor(np.pi * cfg.sr * np.arange(cfg.num_bins)
                         / (cfg.num_bins - 1), dtype=doa.dtype,
                         device=doa.device)
    return tau[..., None] * (-omega)               # [..., 7, F]


def angle_features(phase: torch.Tensor, doa, cfg: AngleConfig
                   ) -> torch.Tensor:
    """Directional features: per mic pair, the cosine alignment of the
    observed IPD with the DoA-predicted phase difference, averaged over
    pairs. phase: [B, C, F, T]; doa: one [B] tensor, or a sequence of
    per-speaker [B] tensors (num_doas == 1: speakers concatenate along
    the frequency axis). Returns [B, F * n_spk, T] or [B, D, F, T]."""
    idx_l, idx_r = parse_index_pairs(cfg.af_index)
    ipd = phase[:, list(idx_l)] - phase[:, list(idx_r)]    # [B, M, F, T]

    def one(d):
        d = torch.as_tensor(d, dtype=phase.dtype, device=phase.device)
        phi = princeton_phase_delay(d, cfg)
        if cfg.num_doas == 1:
            dif = phi[:, list(idx_l)] - phi[:, list(idx_r)]    # [B, M, F]
            return torch.mean(torch.cos(ipd - dif[..., None]), dim=1)
        dif = phi[:, :, list(idx_l)] - phi[:, :, list(idx_r)]  # [B,D,M,F]
        return torch.mean(torch.cos(ipd[:, None] - dif[..., None]), dim=2)

    if isinstance(doa, (list, tuple)):
        if cfg.num_doas != 1:
            raise ValueError("known_doa=False: pass one doa array, "
                             "not a sequence")
        return torch.cat([one(d) for d in doa], dim=1)
    return one(doa)


@dataclass(frozen=True)
class ExtractorConfig:
    """Mirror of ExtractorCfg (the reference conformer_wrapper.py)."""
    ang_index: str = ""
    frame_hop: int = 256
    frame_len: int = 512
    ipd_cos: bool = False
    ipd_index: str = "1,0;2,0;3,0;4,0;5,0;6,0"
    ipd_mean_normalize: bool = True
    ipd_mean_normalize_version: int = 1
    log_spectrogram: bool = False
    mvn_spectrogram: bool = True
    num_spks: int = 2
    round_pow_of_two: bool = True
    window: str = "hann"
    ipd_sin: bool = False
    normalize: bool = True

    @property
    def num_bins(self) -> int:
        n = 2 ** int(np.ceil(np.log2(self.frame_len))) if self.round_pow_of_two \
            else self.frame_len
        return n // 2 + 1


class FeatureExtractor:
    """Magnitude (mvn/log) + IPD + angle features.

    Reference quirk kept: the synthesis STFT (`istft_op`) always uses the
    normalized sqrt_hann window, whatever window the analysis uses (the
    reference builds its iSTFT without forwarding the window argument)."""

    def __init__(self, cfg: ExtractorConfig, device="cpu"):
        self.cfg = cfg
        self.stft = STFT(cfg.frame_len, cfg.frame_hop, cfg.window,
                         cfg.normalize, cfg.round_pow_of_two, device=device)
        self.istft_op = STFT(cfg.frame_len, cfg.frame_hop, "sqrt_hann",
                             cfg.normalize, cfg.round_pow_of_two,
                             device=device)
        self.has_spatial = bool(cfg.ipd_index)
        self.ipd_cfg = IPDConfig(cfg.ipd_index, cfg.ipd_cos, cfg.ipd_sin,
                                 cfg.ipd_mean_normalize,
                                 cfg.ipd_mean_normalize_version) \
            if self.has_spatial else None
        self.num_bins = self.stft.num_bins
        self.feature_dim = self.num_bins
        if self.has_spatial:
            n_pairs = len(cfg.ipd_index.split(";"))
            if cfg.ipd_cos and cfg.ipd_sin:
                n_pairs *= 2
            self.feature_dim += n_pairs * self.num_bins
        self.ang_cfg = None
        if cfg.ang_index:
            self.ang_cfg = AngleConfig(af_index=cfg.ang_index,
                                       num_bins=self.num_bins)
            self.feature_dim += self.num_bins * cfg.num_spks
            self.has_spatial = True

    def spectra_feature(self, mag: torch.Tensor) -> torch.Tensor:
        """mag: [B, C, F, T] or [B, F, T] -> normalized ch0 magnitude
        [B, F, T], with the unbiased (N-1) std of torch's Tensor.std."""
        f = mag[:, 0] if mag.dim() == 4 else mag
        f = torch.clamp(f, min=EPSILON)
        if self.cfg.log_spectrogram:
            f = torch.log(f)
        if self.cfg.mvn_spectrogram:
            mean = f.mean(-1, keepdim=True)
            var = torch.sum((f - mean) ** 2, dim=-1, keepdim=True) \
                / (f.shape[-1] - 1)
            f = (f - mean) / (torch.sqrt(var) + EPSILON)
        return f

    def __call__(self, mag: torch.Tensor, pha: torch.Tensor, doa=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """mag/pha: [B, C, F, T] (MC) or [B, F, T] (SC); doa: per-speaker
        DoAs (required iff ang_index is configured). Returns (mag_ref,
        pha_ref, feature [B, D, T]); the reference channel is 0."""
        if doa is not None and self.ang_cfg is None:
            raise ValueError("DoA given but the angle extractor is not "
                             "configured")
        feats = [self.spectra_feature(mag)]
        if self.has_spatial:
            assert pha.dim() == 4, "spatial features need multi-channel phase"
            if self.ipd_cfg is not None:
                feats.append(ipd_features(pha, self.ipd_cfg))
            if self.ang_cfg is not None:
                if doa is None:
                    raise ValueError("ang_index is configured but no DoA "
                                     "was passed")
                feats.append(angle_features(pha, doa, self.ang_cfg))
        feature = torch.cat(feats, dim=1)
        if mag.dim() == 4:
            return mag[:, 0], pha[:, 0], feature
        return mag, pha, feature
