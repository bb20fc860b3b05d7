"""The pluggable CSS model interface: forward / separate / stft / istft.

Port of notsofar_tpu/models/css_wrapper.py (the reference
ConformerCssWrapper) with the same tensor contracts:

    forward(mix [B, T, Mics]) -> {'spk_masks' [B,F,T,S], 'noise_masks' [B,F,T,N]}
    separate(stft complex [B,F,T,Mics] or [B,F,T]) -> same dict
    stft(s [B,T,Mics] or [B,T]) -> complex [B,F,T,Mics] or [B,F,T]
    istft(stft complex [B,F,T]) -> [B, NSamples]

`CssModel` holds the ConformerCSS module with its weights on one device
(the JAX package passes `variables` to every call instead).
"""
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from notsofar_tpu_torch.models.conformer import ConformerConfig, ConformerCSS
from notsofar_tpu_torch.ops.features import ExtractorConfig, FeatureExtractor
from notsofar_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class NnetConfig:
    """Mirror of NnetCfg (the reference conformer_wrapper.py)."""
    conformer_conf: ConformerConfig = field(default_factory=ConformerConfig)
    in_features: int = 1799
    num_nois: int = 1
    num_spks: int = 3


@dataclass(frozen=True)
class ConformerCssConfig:
    """Mirror of ConformerCssCfg (the reference conformer_wrapper.py)."""
    extractor_conf: ExtractorConfig = field(default_factory=ExtractorConfig)
    nnet_conf: NnetConfig = field(default_factory=NnetConfig)


class CssModel:
    """Feature extractor + ConformerCSS with its weights, on one device."""

    def __init__(self, cfg: ConformerCssConfig, dtype=torch.float32,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 device=None, seed: int = 0):
        """dtype: compute dtype of the Conformer's matmuls and conv (the
        weights stay f32). state_dict None: seeded random weights, drawn
        on the CPU from torch.Generator().manual_seed(seed), so every
        device gets the same ones. device: default ``cuda`` (raises
        without a card); pass ``"cpu"`` for the plain path."""
        dev = resolve_device(device)
        self.cfg = cfg
        self.device = dev
        self.extractor = FeatureExtractor(cfg.extractor_conf, device=dev)
        n = cfg.nnet_conf
        self.module = ConformerCSS(
            in_features=n.in_features, num_bins=self.extractor.num_bins,
            num_spks=n.num_spks, num_nois=n.num_nois,
            conformer=n.conformer_conf, dtype=dtype)
        if state_dict is None:
            self.module.init(torch.Generator().manual_seed(seed))
        else:
            self.module.load_state_dict(state_dict)
        self.module.to(dev).eval().requires_grad_(False)
        self.num_spks = n.num_spks
        self.num_nois = n.num_nois

    def stft(self, s: torch.Tensor) -> torch.Tensor:
        """s: [B, T, Mics] or [B, T] -> complex [B, F, T, Mics] or
        [B, F, T] (channels last)."""
        if s.dim() == 3:
            c = self.extractor.stft.forward(s.transpose(1, 2))  # [B,M,F,T]
            return c.permute(0, 2, 3, 1)
        return self.extractor.stft.forward(s)

    def istft(self, stft_c: torch.Tensor) -> torch.Tensor:
        """stft_c: complex [B, F, T] -> [B, NSamples]."""
        assert stft_c.dim() == 3
        return self.extractor.istft_op.inverse(stft_c)

    def features(self, stft_c: torch.Tensor) -> torch.Tensor:
        """stft_c: complex [B,F,T,Mics] (MC) or [B,F,T] (SC) -> the
        network's input features [B, D, T]."""
        cm = stft_c.permute(0, 3, 1, 2) if stft_c.dim() == 4 else stft_c
        _, _, feat = self.extractor(cm.abs(), cm.angle())
        return feat

    @torch.no_grad()
    def masks_from_feature(self, feat: torch.Tensor
                           ) -> Dict[str, torch.Tensor]:
        all_masks = self.module(feat)                       # [B, F, T, S+N]
        return {"spk_masks": all_masks[..., :self.num_spks],
                "noise_masks": all_masks[..., self.num_spks:]}

    def separate(self, stft_c: torch.Tensor) -> Dict[str, torch.Tensor]:
        """stft_c: complex [B,F,T,Mics] (MC) or [B,F,T] (SC) -> mask
        dict."""
        return self.masks_from_feature(self.features(stft_c))

    def forward(self, mix: torch.Tensor) -> Dict[str, torch.Tensor]:
        """mix: [B, T, Mics] time domain -> mask dict (the mic axis is
        squeezed for SC)."""
        is_sc = mix.shape[2] == 1
        assert is_sc == (not self.extractor.has_spatial), (
            "IPD extractor is expected iff the number of microphones is "
            "greater than 1 — model misconfiguration?")
        s = mix[:, :, 0] if is_sc else mix
        return self.separate(self.stft(s))


def sc_extractor_config() -> ExtractorConfig:
    """Single-channel extractor: no IPD (ipd_index=''), 257-dim features
    (configs/train_css/local/conformer_v1.0_sc.yaml)."""
    return ExtractorConfig(ipd_index="")


def sc_css_config(conformer: Optional[ConformerConfig] = None
                  ) -> ConformerCssConfig:
    return ConformerCssConfig(
        extractor_conf=sc_extractor_config(),
        nnet_conf=NnetConfig(conformer_conf=conformer or ConformerConfig(),
                             in_features=257))


def large_conformer_config() -> ConformerConfig:
    """The shipped v1.0 'large' model (conformer_v1.0_mc.yaml:36-41)."""
    return ConformerConfig(attention_dim=512, attention_heads=8,
                           num_blocks=18, dropout_rate=0.0)
