"""Analytic FLOP / memory-traffic models for the serving stages, and the
peaks of the card they run on.

A copy of notsofar_tpu/utils/flops.py (the port imports nothing of the
JAX package): the same closed-form counts (matmul-dominated; elementwise
and normalization terms are dropped), printed as achieved FLOP/s and
device-memory GB/s against the device's published peaks. The peaks are
an NVIDIA card's, read from ``torch.cuda.get_device_name()``; a card
that is not in the table raises, since a bound against another device's
peaks would be a wrong bound.

Conventions: 1 MAC = 2 FLOPs; attention counts include QK^T and PV; all
counts are per forward pass (no backward here — serving only).
"""
from dataclasses import dataclass
from typing import Dict, Optional

import torch

# H100 SXM (80 GB HBM3): dense bf16 tensor-core rate, f32 FMA rate
# outside the tensor cores, device-memory rate (NVIDIA's H100 data sheet)
H100_PEAK_BF16 = 989e12
H100_PEAK_F32 = 67e12
H100_HBM_BYTES_PER_S = 3.35e12

# name fragment (lower case) of torch.cuda.get_device_name() ->
# (bf16 FLOP/s, f32 FLOP/s, device-memory bytes/s)
_PEAKS = {
    "h100 80gb hbm3": (H100_PEAK_BF16, H100_PEAK_F32, H100_HBM_BYTES_PER_S),
}


def device_peaks(name: Optional[str] = None) -> Dict[str, float]:
    """Published peaks of the CUDA card ``name`` (default: card 0 as
    torch.cuda.get_device_name() gives it). Keys as in the JAX package:
    ``bf16`` and ``f32`` FLOP/s, ``hbm_gbps`` in bytes/s, ``kind``.
    Raises for a card not in the table, and when there is no card."""
    if name is None:
        if not torch.cuda.is_available():
            raise RuntimeError("device_peaks: no CUDA card")
        name = torch.cuda.get_device_name(0)
    kind = name.lower()
    for key, (bf16, f32, bw) in _PEAKS.items():
        if key in kind:
            return {"bf16": bf16, "f32": f32, "hbm_gbps": bw, "kind": kind}
    raise ValueError(f"device_peaks: no published peaks for {name!r}")


# --------------------------------------------------------------------------
# CSS conformer
# --------------------------------------------------------------------------

def conformer_css_flops(n_frames: int, in_features: int = 1799,
                        d: int = 512, heads: int = 8, ffn: int = 1024,
                        kernel: int = 33, blocks: int = 18,
                        num_bins: int = 257, n_out_masks: int = 4) -> float:
    """One CSS-net forward over `n_frames` STFT frames (one window).

    Matches models/conformer.py::ConformerCSS composition: embed linear,
    per block two macaron half-FFNs + MHSA (with the rel-pos key term)
    + GLU conv module, then the mask head.
    """
    T = n_frames
    embed = 2 * T * in_features * d
    ffn_f = 2 * (2 * T * d * ffn)                     # two linears
    attn_proj = 2 * T * d * d * 4                     # q,k,v,out
    attn_mat = 2 * T * T * d * 2                      # QK^T + PV
    attn_pos = 2 * T * T * d                          # additive pos-key term
    conv = 2 * T * d * (2 * d) + 2 * T * d * kernel + 2 * T * d * d
    # macaron sandwich: both half-FFNs run full compute (the 0.5 factor
    # scales the residual, not the matmuls)
    per_block = ffn_f + attn_proj + attn_mat + attn_pos + conv
    head = 2 * T * d * (num_bins * n_out_masks)
    return embed + blocks * per_block + head


# --------------------------------------------------------------------------
# Whisper
# --------------------------------------------------------------------------

def whisper_encoder_flops(dims) -> float:
    """One 30 s window through the audio encoder (3000 mel frames -> 1500)."""
    D, L = dims.n_audio_state, dims.n_audio_layer
    T0, T = 3000, dims.n_audio_ctx
    conv = 2 * T0 * 3 * dims.n_mels * D + 2 * T * 3 * D * D
    ffn = 2 * (2 * T * D * (4 * D))
    attn_proj = 2 * T * D * D * 4
    attn_mat = 2 * T * T * D * 2
    return conv + L * (ffn + attn_proj + attn_mat)


def whisper_decoder_params(dims) -> float:
    """Decoder parameter count (self+cross attention + FFN + embedding)."""
    D, L, V = dims.n_text_state, dims.n_text_layer, dims.n_vocab
    per_layer = 4 * D * D + 4 * D * D + 2 * D * (4 * D)  # self + cross + ffn
    return L * per_layer + V * D + dims.n_text_ctx * D


def whisper_decode_step_flops(dims, batch: int, ctx_len: int = 224,
                              cross_len: int = 1500) -> float:
    """One incremental decode step for `batch` rows (KV-cached; cross K/V
    precomputed): weight matmuls + attention against the caches + logits."""
    D, L, V = dims.n_text_state, dims.n_text_layer, dims.n_vocab
    proj = L * (4 * D * D + 2 * D * D + 2 * D * 4 * D) * 2   # q,k,v,o + q,o + ffn
    attn = L * 2 * D * (ctx_len + cross_len) * 2
    logits = 2 * D * V
    return batch * (proj + attn + logits)


def whisper_decode_step_bytes(dims, dtype_bytes: int = 2,
                              batch: int = 1, ctx_len: int = 224,
                              cross_len: int = 1500) -> float:
    """HBM traffic per incremental step: every decoder weight is read once
    (weights dominate; batch amortizes them), plus each row's KV caches."""
    D, L = dims.n_text_state, dims.n_text_layer
    weights = whisper_decoder_params(dims) * dtype_bytes
    kv = batch * L * (ctx_len * 2 + cross_len * 2) * D * dtype_bytes
    return weights + kv


def whisper_alignment_flops(dims, n_tokens: int) -> float:
    """Teacher-forced alignment pass (per window): full-sequence decoder
    forward with cross-attention kept."""
    D, L, V = dims.n_text_state, dims.n_text_layer, dims.n_vocab
    T = n_tokens
    proj = L * (4 * D * D + 2 * D * D + 2 * D * 4 * D) * 2 * T
    attn = L * 2 * D * T * (T + 1500) * 2
    return proj + attn + 2 * T * D * V


# --------------------------------------------------------------------------
# TitaNet
# --------------------------------------------------------------------------

def titanet_flops(n_frames: int, n_mels: int = 80, filters: int = 1024,
                  repeat: int = 3, kernels=(7, 11, 15),
                  epilogue: int = 3072, emb: int = 192,
                  att_dim: int = 128) -> float:
    """One TitaNet-large forward over n_frames mel frames. Pointwise convs
    dominate; depthwise and SE terms included for completeness."""
    T = n_frames
    f = 0.0
    # prologue: dw(k=3) + pw(n_mels -> filters)
    f += 2 * T * (n_mels * 3 + n_mels * filters)
    c = filters
    for k in kernels:
        for r in range(repeat):
            f += 2 * T * (c * k + c * c)
        f += 2 * T * c * c            # residual 1x1
        f += 2 * (c * c // 8) * 2     # SE linears (per sequence)
    f += 2 * T * (c * 1 + c * epilogue)           # epilogue separable
    f += 2 * T * (3 * epilogue) * att_dim + 2 * T * att_dim * epilogue
    f += 2 * (2 * epilogue) * emb
    return f


# --------------------------------------------------------------------------
# report helper
# --------------------------------------------------------------------------

@dataclass
class StageCost:
    name: str
    flops: float
    seconds: float
    bytes_moved: Optional[float] = None

    def report(self, peaks: Dict[str, float]) -> Dict:
        out = {"stage": self.name, "seconds": round(self.seconds, 2),
               "tflops": round(self.flops / 1e12, 2),
               "achieved_tflops_s": round(self.flops / self.seconds / 1e12, 2)
               if self.seconds else None,
               "mfu_bf16": round(self.flops / self.seconds
                                 / peaks["bf16"], 4) if self.seconds else None}
        if self.bytes_moved is not None and self.seconds:
            out["achieved_gbps"] = round(self.bytes_moved / self.seconds
                                         / 1e9, 1)
            out["hbm_util"] = round(self.bytes_moved / self.seconds
                                    / peaks["hbm_gbps"], 3)
        return out
