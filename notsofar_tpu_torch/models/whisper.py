"""Whisper encoder/decoder in torch.nn with KV-cached decoding.

Port of notsofar_tpu/models/whisper.py. Parameters use the openai-whisper
checkpoint layout (``encoder.blocks.{i}.attn.query.weight`` ...), so an
openai ``.pt`` loads with ``load_state_dict``; ``variables_from_jax``
converts the JAX package's flax tree into the same layout, which is how
the parity tests give both packages identical weights, and
``convert_hf_whisper_state_dict`` a Hugging Face checkpoint's.

Numerics follow the JAX model: matmuls in the model dtype; attention
logits, softmax and the decoder's output logits in f32, with attention
weights rounded to the value dtype before the weights-times-values
product. ``MHA`` keeps the reference's four kernel dispatch predicates
exactly (split cache, T=1 cache step, encoder 512 <= T == S <= 2048, int8
cross-attention memory at a folded query length <= 8), so the same calls
reach the same kernels on both sides. Two more kernels serve the decode
step where the reference relies on XLA fusing dtype conversions, layer
norms, activations and adds into its dots: ``xattn_step`` (the float
cross-attention memory at a folded query length <= 8) and
``decode_gemv`` (every int8 or bf16 dense layer and the output logits at
up to DECODE_GEMV_MAX_ROWS rows), each reading its operand once in the
stored dtype. A single-token decode step (``TextDecoder.fused_step``)
runs each block as ``ResidualBlock.decode_step``: six decode_gemv
launches a layer (the layer norm in the prologue of the self-attention's
one q/k/v launch, which writes k and v into the cache, of the
cross-attention's query and of fc1; GELU and the three residual adds in
the epilogues), the same rounding points as the layer-by-layer path.

The int8 decoder (``quant_decoder=True``, the JAX package's serving
configuration) stores every decoder matrix weight-only int8 with f32
per-output-channel scales (QuantDense) and the tied embedding int8 with a
per-row scale; quantize_whisper_decoder makes those from float weights,
quantize_cross_kv makes the int8 cross-attention memory that the
xattn_int8 kernel reads.
"""
import math
import re
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from notsofar_tpu_torch.ops.kernels import (XATTN_STEP_MAX_TQ, GemvLN,
                                            attn_step, attn_step_split,
                                            decode_gemv, decode_qkv,
                                            encoder_mha, uses_decode_gemv,
                                            xattn_int8, xattn_step)
from notsofar_tpu_torch.utils.device import resolve_device

LN_EPS = 1e-5
XATTN_INT8_MAX_TQ = 8   # folded query lengths the int8 kernel serves


def uses_xattn_int8(B: int, T: int, precomputed_kv) -> bool:
    """Whether cross-attention of B x T queries against the memory
    `precomputed_kv` goes through the xattn_int8 kernel: the memory is the
    int8 5-tuple and the query length, with the beams of a window folded
    into it (B // Bm of them), is at most XATTN_INT8_MAX_TQ."""
    return len(precomputed_kv) == 5 and \
        B // precomputed_kv[0].shape[0] * T <= XATTN_INT8_MAX_TQ


def uses_xattn_step(B: int, T: int, precomputed_kv) -> bool:
    """Whether cross-attention of B x T queries against the memory
    `precomputed_kv` goes through the xattn_step kernel: the memory is the
    float (k, v) pair and the folded query length is at most
    XATTN_STEP_MAX_TQ (the decode steps; prefill keeps the matmul path)."""
    return len(precomputed_kv) == 2 and \
        B // precomputed_kv[0].shape[0] * T <= XATTN_STEP_MAX_TQ


# TextDecoder.forward calls whose work reaches each kernel by the rules MHA,
# the dense layers and the logits dispatch by: an xattn_int8 or xattn_step
# call launches it once per layer; a decode_gemv call (a fused step,
# TextDecoder.fused_step) TextDecoder.decode_gemv_per_call() times, a
# decode_gemv_layerwise call (layer by layer, at most DECODE_GEMV_MAX_ROWS
# rows) decode_gemv_per_call(fused=False) times
DECODER_CALLS: Dict[str, int] = {"xattn_int8": 0, "xattn_step": 0,
                                 "decode_gemv": 0,
                                 "decode_gemv_layerwise": 0}


def reset_decoder_calls() -> None:
    for k in DECODER_CALLS:
        DECODER_CALLS[k] = 0


@dataclass(frozen=True)
class WhisperDims:
    """Mirror of whisper ModelDimensions."""
    n_mels: int = 80
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_vocab: int = 51865
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4


# famous configurations (openai/whisper model zoo)
WHISPER_DIMS = {
    "tiny": WhisperDims(80, 1500, 384, 6, 4, 51865, 448, 384, 6, 4),
    "tiny.en": WhisperDims(80, 1500, 384, 6, 4, 51864, 448, 384, 6, 4),
    "base": WhisperDims(80, 1500, 512, 8, 6, 51865, 448, 512, 8, 6),
    "base.en": WhisperDims(80, 1500, 512, 8, 6, 51864, 448, 512, 8, 6),
    "small": WhisperDims(80, 1500, 768, 12, 12, 51865, 448, 768, 12, 12),
    "small.en": WhisperDims(80, 1500, 768, 12, 12, 51864, 448, 768, 12, 12),
    "medium": WhisperDims(80, 1500, 1024, 16, 24, 51865, 448, 1024, 16, 24),
    "medium.en": WhisperDims(80, 1500, 1024, 16, 24, 51864, 448, 1024, 16,
                             24),
    "large-v1": WhisperDims(80, 1500, 1280, 20, 32, 51865, 448, 1280, 20, 32),
    "large-v2": WhisperDims(80, 1500, 1280, 20, 32, 51865, 448, 1280, 20, 32),
    "large-v3": WhisperDims(128, 1500, 1280, 20, 32, 51866, 448, 1280, 20,
                            32),
    "large": WhisperDims(128, 1500, 1280, 20, 32, 51866, 448, 1280, 20, 32),
}


def sinusoids(length: int, channels: int, max_timescale: float = 10000
              ) -> np.ndarray:
    """Whisper's sinusoidal position embedding."""
    assert channels % 2 == 0
    log_inc = math.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1
                          ).astype(np.float32)


class QuantDense(nn.Module):
    """Weight-only int8 Dense (JAX QuantDense): an int8 weight [out, in]
    (the openai Linear layout) with an f32 per-output-channel scale. Each
    step rounds to the compute dtype as flax does: y = x @ w8, then y * s,
    then + b. The scale is never folded into the weight and the bias never
    enters the product: either would move a bf16 rounding point. ``dtype``
    is the compute dtype (WhisperModel sets it); x is cast to it here. Up to
    DECODE_GEMV_MAX_ROWS rows (decode steps) go through decode_gemv, which
    reads the int8 weight once; more rows (prefill) widen it for a
    matmul. ``out_dtype`` f32 returns the same rounded values stored as
    f32 (for an output added to the int8 decoder's f32 residual stream)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.dtype = torch.float32
        self.out_dtype: Optional[torch.dtype] = None
        self.register_buffer("weight", torch.zeros(
            (out_features, in_features), dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias \
            else None

    def forward(self, x: torch.Tensor, post=None) -> torch.Tensor:
        """post: decode_gemv's optional last step, (s, p, rows per group);
        decode steps only (DECODE_GEMV_MAX_ROWS rows)."""
        dt = self.dtype
        if uses_decode_gemv(x.numel() // x.shape[-1], self.weight.dtype):
            return decode_gemv(x, self.weight, dt, self.scale, self.bias,
                               out_dtype=self.out_dtype, post=post)
        if post is not None:
            raise ValueError("QuantDense: post serves decode steps only")
        y = torch.matmul(x.to(dt), self.weight.to(dt).T) * self.scale.to(dt)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y if self.out_dtype is None else y.to(self.out_dtype)


class QuantEmbedding(nn.Module):
    """The int8 tied token embedding with an f32 per-row scale: rows for
    the embedding lookup, the whole matrix for the output logits."""

    def __init__(self, n_vocab: int, n_state: int):
        super().__init__()
        self.register_buffer("weight", torch.zeros((n_vocab, n_state),
                                                   dtype=torch.int8))
        self.register_buffer("scale", torch.ones(n_vocab))


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm that promotes like flax's: an f32 input with bf16
    parameters (the int8 decoder's f32 residual stream) is normalized in
    f32 with the parameters' values, and stays f32. The promoted copies of
    the parameters are made once and kept until the parameters change
    (their version counters), not at every decode step."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        return F.layer_norm(x.to(dt), self.normalized_shape,
                            *self._params_as(dt), self.eps)

    def _params_as(self, dt: torch.dtype):
        key = (dt, self.weight.data_ptr(), self.weight._version,
               self.bias.data_ptr(), self.bias._version)
        cached = getattr(self, "_promoted", None)
        if cached is None or cached[0] != key:
            cached = (key, self.weight.to(dt), self.bias.to(dt))
            self._promoted = cached
        return cached[1:]


def _dense(quant: bool, n_in: int, n_out: int, bias: bool = True):
    return QuantDense(n_in, n_out, bias) if quant else \
        nn.Linear(n_in, n_out, bias=bias)


def _dtype(layer: nn.Module) -> torch.dtype:
    """A dense layer's compute dtype."""
    return layer.dtype if isinstance(layer, QuantDense) else \
        layer.weight.dtype


def _lin(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Dense in the layer's compute dtype (flax Dense(dtype) casts its
    input; QuantDense casts its own, in decode_gemv's case on the card). A
    bf16 Linear at up to DECODE_GEMV_MAX_ROWS rows goes through decode_gemv
    with flax nn.Dense's rounding points, dtype(acc) then dtype(y +
    dtype(b)); more rows (prefill) keep addmm's single rounding."""
    if isinstance(layer, QuantDense):
        return layer(x)
    if uses_decode_gemv(x.numel() // x.shape[-1], layer.weight.dtype):
        return decode_gemv(x, layer.weight, layer.weight.dtype,
                           bias=layer.bias)
    return layer(x.to(layer.weight.dtype))


def _dense_args(layer: nn.Module):
    """(weight, scale or None, bias or None) of a QuantDense or Linear."""
    return (layer.weight, layer.scale if isinstance(layer, QuantDense)
            else None, layer.bias)


def _gemv(layer: nn.Module, x: torch.Tensor, **kw) -> torch.Tensor:
    """A dense layer of a fused decode step through decode_gemv, with the
    same rounding points as _lin (QuantDense's three, a bf16 Linear's two);
    kw: decode_gemv's ln, gelu, residual, post."""
    if isinstance(layer, QuantDense) and "residual" not in kw:
        kw["out_dtype"] = layer.out_dtype
    return decode_gemv(x, layer.weight, _dtype(layer),
                       *_dense_args(layer)[1:], **kw)


def _norm(ln: nn.LayerNorm) -> GemvLN:
    """A LayerNorm as decode_gemv's prologue (the raw parameters: the
    kernel widens them; the plain version promotes them as
    LayerNorm.forward does)."""
    return GemvLN(ln.weight, ln.bias, ln.eps)


class CacheSlot(NamedTuple):
    """A decode step's self-attention cache slot held on the device, so
    that a CUDA graph of the step serves every step as the slot advances:
    ``index`` [1] int64 for the cache write, ``slot`` 0-d int32 for the
    kernels. TextDecoder makes it once per step from a tensor pos_offset;
    in a split beam cache it counts from the generated segment's start."""
    index: torch.Tensor
    slot: torch.Tensor


def _kernel_geometry(n_state: int, d_k: int) -> bool:
    """The head geometry the decode-step kernels cover (every Whisper
    checkpoint has dk=64)."""
    return d_k in (64, 128) and n_state % 128 == 0


class MHA(nn.Module):
    """Whisper attention: q/out have bias, k has none, v has bias; scaling
    by d_k**-0.25 applied to both q and k."""

    def __init__(self, n_state: int, n_head: int, quant: bool = False):
        super().__init__()
        self.n_state = n_state
        self.n_head = n_head
        self.query = _dense(quant, n_state, n_state)
        self.key = _dense(quant, n_state, n_state, bias=False)
        self.value = _dense(quant, n_state, n_state)
        self.out = _dense(quant, n_state, n_state)

    def forward(self, x, xa=None, mask=None, kv_cache=None, cache_index=None,
                precomputed_kv=None, pad_lens=None):
        """x: [B, T, D] queries. xa: cross-attention memory [B, S, D] or
        None for self-attention. kv_cache: optional (k, v) [B, ctx, D]
        caches written at cache_index (an int, or a CacheSlot for a
        single-token step), or the split beam cache (kp, vp, kg, vg[,
        anc]). Caches are updated IN PLACE (the JAX
        model's dynamic_update_slice on its loop carry) and returned.
        precomputed_kv: optional (k, v) [Bm, S, D] cross-attention memory
        already projected (see WhisperModel.precompute_cross_kv), or its
        int8 form (k8, k_scale, v8, v_scale, s_valid) from
        WhisperModel.quantize_cross_kv.
        Returns (out, attention weights or None, cache or None)."""
        d_k = self.n_state // self.n_head
        H = self.n_head
        dtype = _dtype(self.query)
        if precomputed_kv is not None:
            out, w = self._attend_precomputed(x, precomputed_kv, mask)
            return _lin(self.out, out), w, None
        q = _lin(self.query, x)
        src = x if xa is None else xa
        k = _lin(self.key, src)
        v = _lin(self.value, src)

        if kv_cache is not None and len(kv_cache) in (4, 5):
            # split prompt/generated cache (beam search): the prompt
            # segment [Bs, Pp, D] is shared by each stream's beams; the
            # [B, G, D] generated segment is per beam, and with the
            # [Bs, K, G] ancestry (5th element) beam reordering is a
            # visibility change inside attn_step_split — the caches never
            # move
            if not (x.shape[1] == 1 and _kernel_geometry(self.n_state,
                                                         d_k)):
                raise ValueError("split caches serve single-token beam "
                                 "decode only")
            kp, vp, kg, vg = kv_cache[:4]
            anc = kv_cache[4] if len(kv_cache) == 5 else None
            Bs = kp.shape[0]
            B = q.shape[0]
            beams = B // Bs
            if isinstance(cache_index, CacheSlot):
                kg.index_copy_(1, cache_index.index, k.to(kg.dtype))
                vg.index_copy_(1, cache_index.index, v.to(vg.dtype))
                gslot = cache_index.slot
            else:
                gslot = cache_index - kp.shape[1]
                kg[:, gslot] = k[:, 0].to(kg.dtype)
                vg[:, gslot] = v[:, 0].to(vg.dtype)
            pads = (torch.zeros(Bs, dtype=torch.int32, device=q.device)
                    if pad_lens is None
                    else pad_lens.reshape(Bs, beams)[:, 0].contiguous())
            q_eff = (q * (d_k ** -0.5)).to(kp.dtype)
            out = attn_step_split(q_eff, kp, vp, kg, vg, gslot, pads, d_k,
                                  beams, anc=anc)
            out = _lin(self.out, out.reshape(B, 1, self.n_state))
            return out, None, kv_cache
        new_cache = None
        if kv_cache is not None:
            ck, cv = kv_cache
            T = x.shape[1]
            if isinstance(cache_index, CacheSlot):
                ck.index_copy_(1, cache_index.index, k.to(ck.dtype))
                cv.index_copy_(1, cache_index.index, v.to(cv.dtype))
                pos = cache_index.slot
            else:
                ck[:, cache_index:cache_index + T] = k.to(ck.dtype)
                cv[:, cache_index:cache_index + T] = v.to(cv.dtype)
                pos = cache_index
            new_cache = (ck, cv)
            if T == 1 and _kernel_geometry(self.n_state, d_k):
                # incremental decode step: the fused kernel builds the
                # suffix-decode mask (incl. pad_lens) itself, so `mask` is
                # ignored on this path
                B = q.shape[0]
                pads = (torch.zeros(B, dtype=torch.int32, device=q.device)
                        if pad_lens is None else pad_lens)
                q_eff = (q * (d_k ** -0.5)).to(ck.dtype)
                out = attn_step(q_eff, ck, cv, pos, pads, d_k)
                out = _lin(self.out, out.reshape(B, 1, self.n_state))
                return out, None, new_cache
            k, v = ck.to(k.dtype), cv.to(v.dtype)

        B, T, _ = q.shape
        S = k.shape[1]
        qh = q.reshape(B, T, H, d_k).transpose(1, 2)
        kh = k.reshape(B, S, H, d_k).transpose(1, 2)
        vh = v.reshape(B, S, H, d_k).transpose(1, 2)
        scale = d_k ** -0.25
        if (mask is None and kv_cache is None and xa is None
                and 512 <= T == S <= 2048):
            # long-context encoder self-attention through the fused
            # kernel (the 2048 bound is the TPU kernel's VMEM budget, kept
            # so both packages dispatch identically)
            out = encoder_mha(
                (qh * scale).to(dtype).reshape(-1, T, d_k).contiguous(),
                (kh * scale).to(dtype).reshape(-1, S, d_k).contiguous(),
                vh.reshape(-1, S, d_k).contiguous())
            out = out.reshape(B, H, T, d_k).transpose(1, 2) \
                .reshape(B, T, self.n_state)
            return _lin(self.out, out), None, None
        logits = torch.matmul((qh * scale).float(),
                              (kh * scale).float().transpose(-1, -2))
        if mask is not None:
            logits = logits + mask
        w = torch.softmax(logits, dim=-1)
        out = torch.matmul(w.to(vh.dtype).float(), vh.float())
        out = out.transpose(1, 2).reshape(B, T, self.n_state)
        return _lin(self.out, out), w, new_cache

    def _q_scales(self, k_s: torch.Tensor, v_s: torch.Tensor, scale: float):
        """(scale as a 1-element f32 tensor, k_s * scale, v_s[:, 0]
        contiguous) for the int8 decode steps: q * the first is q.float() *
        scale in one kernel; the others are made once per cross-attention
        memory (kept while k_s and v_s are these very tensors) instead of at
        every step. The same products as the reference's, bit for bit."""
        cached = getattr(self, "_q_scale_cache", None)
        if cached is None or cached[0] is not k_s or cached[1] is not v_s:
            cached = (k_s, v_s, torch.full((1,), scale, dtype=torch.float32,
                                           device=k_s.device), k_s * scale,
                      v_s[:, 0].contiguous())
            self._q_scale_cache = cached
        return cached[2:]

    def bind_q_scales(self, k_s: torch.Tensor, v_s: torch.Tensor,
                      out: Optional[Tuple[torch.Tensor, ...]] = None):
        """_q_scales' products of the int8 memory's scales (k_s, v_s)
        computed into `out` (made here when None) and cached as theirs.
        A decode workspace keeps `out` and calls this in its set-up at
        every call: a CUDA graph of the step reads the products from
        `out`, so they must be this call's (the host cache alone would
        hand a replay its capture's products). The same products as
        _q_scales', bit for bit. Returns `out`."""
        scale = (self.n_state // self.n_head) ** -0.25
        if out is None:
            out = (torch.full((1,), scale, dtype=torch.float32,
                              device=k_s.device), torch.empty_like(k_s),
                   torch.empty_like(v_s[:, 0]))
        torch.mul(k_s, scale, out=out[1])
        out[2].copy_(v_s[:, 0])
        self._q_scale_cache = (k_s, v_s, *out)
        return out

    def step_self(self, x, ln: nn.LayerNorm, kv_cache, cache_index, pads):
        """The self-attention of a fused single-token step: x [B, 1, D] the
        raw residual stream, ln its layer norm. One decode_gemv launch
        normalizes x and projects q, k and v, writes k and v into the cache
        (unified (k, v), or the split beam cache's generated segment) at
        the step's slot and returns q_eff; then attn_step or
        attn_step_split with `pads` (TextDecoder.step_pads). Returns the
        attention output [B, 1, D] before the out projection."""
        d_k = self.n_state // self.n_head
        B = x.shape[0]
        if len(kv_cache) in (4, 5):
            kp, vp, ck, cv = kv_cache[:4]
            slot = cache_index.slot if isinstance(cache_index, CacheSlot) \
                else cache_index - kp.shape[1]
        else:
            ck, cv = kv_cache
            slot = cache_index.slot if isinstance(cache_index, CacheSlot) \
                else cache_index
        q_eff = decode_qkv(x, _norm(ln), [_dense_args(layer) for layer in
                                          (self.query, self.key, self.value)],
                           _dtype(self.query), ck, cv, slot, d_k ** -0.5)
        if len(kv_cache) in (4, 5):
            out = attn_step_split(q_eff, kp, vp, ck, cv, slot, pads, d_k,
                                  B // kp.shape[0],
                                  anc=kv_cache[4] if len(kv_cache) == 5
                                  else None)
        else:
            out = attn_step(q_eff, ck, cv, slot, pads, d_k)
        return out.reshape(B, 1, self.n_state)

    def step_cross(self, x, ln: nn.LayerNorm, precomputed_kv):
        """The cross-attention of a fused single-token step: x [B, 1, D] the
        raw residual stream, ln its layer norm; the query's decode_gemv
        normalizes x (and for the int8 memory folds the scales into q as
        _attend_precomputed does), then xattn_int8 or xattn_step. Returns
        the attention output [B, 1, D] before the out projection (f32 for
        the int8 memory)."""
        d_k = self.n_state // self.n_head
        B = x.shape[0]
        Bm = precomputed_kv[0].shape[0]
        Tq = B // Bm
        scale = d_k ** -0.25
        if len(precomputed_kv) == 5:
            k8, k_s, v8, v_s, s_valid = precomputed_kv
            _, ks_s, vs0 = self._q_scales(k_s, v_s, scale)
            q_eff = _gemv(self.query, x, ln=_norm(ln),
                          post=(scale, ks_s.reshape(Bm, -1), Tq))
            out = xattn_int8(q_eff.reshape(Bm, Tq, self.n_state), k8, v8,
                             vs0, d_k, s_valid)
        else:
            q = _gemv(self.query, x, ln=_norm(ln))
            out = xattn_step(q.reshape(Bm, Tq, self.n_state),
                             precomputed_kv[0], precomputed_kv[1], d_k)
        return out.reshape(B, 1, self.n_state)

    def _attend_precomputed(self, x, precomputed_kv, mask):
        """Cross-attention of the queries of x [B, T, D] against an
        already-projected memory: (k, v) [Bm, S, D], or the int8 5-tuple
        (k8, k_scale, v8, v_scale, s_valid). When the query batch B is a
        multiple of Bm (beam search: K beams share one window's memory) the
        beam axis folds into the query-time axis, so the memory is read once
        per window.
        Returns (out [B, T, D] pre-out-projection, weights or None)."""
        d_k = self.n_state // self.n_head
        H = self.n_head
        dtype = _dtype(self.query)
        B, T, _ = x.shape
        k = precomputed_kv[0]
        Bm, S = k.shape[:2]
        fold = Bm != B
        if fold:
            assert mask is None and B % Bm == 0
        Tq = (B // Bm) * T
        scale = d_k ** -0.25
        if len(precomputed_kv) == 5 and uses_xattn_int8(B, T, precomputed_kv):
            # decode steps: the k-scales and both scale factors fold into q
            # in f32, ((q * s) * (k_s * s)) rounded to the dtype: in the
            # query's decode_gemv where it serves the rows (the
            # reference's fusion into the dot), else in two kernels; the
            # kernel reads the int8 bytes (decode paths never consume
            # these attention weights)
            assert mask is None, "quantized cross-attention is unmasked"
            k8, k_s, v8, v_s, s_valid = precomputed_kv
            s1, ks_s, vs0 = self._q_scales(k_s, v_s, scale)
            if isinstance(self.query, QuantDense) and uses_decode_gemv(
                    B * T, self.query.weight.dtype):
                q_eff = self.query(x, post=(scale, ks_s.reshape(Bm, -1), Tq))
            else:
                q = _lin(self.query, x)
                q_eff = torch.mul(q.reshape(Bm, Tq, self.n_state) * s1,
                                  ks_s, out=torch.empty(
                                      (Bm, Tq, self.n_state), dtype=dtype,
                                      device=x.device))
            out = xattn_int8(q_eff.reshape(Bm, Tq, self.n_state), k8, v8,
                             vs0, d_k, s_valid)
            if fold:
                out = out.reshape(B, T, self.n_state)
            # f32: the out projection rounds it to the dtype on its way in,
            # the reference's out.astype(dtype)
            return out, None
        q = _lin(self.query, x)
        if fold:
            q = q.reshape(Bm, Tq, self.n_state)
        if len(precomputed_kv) == 5:
            assert mask is None, "quantized cross-attention is unmasked"
            k8, k_s, v8, v_s, s_valid = precomputed_kv
            # prefill: one dequantized pass with the padding masked
            k = (k8.float() * k_s).to(dtype)
            v = (v8.float() * v_s).to(dtype)
            # (the constants made on the device: a host tensor's copy
            # would sync, which a decode set-up's CUDA graph capture
            # cannot)
            mask = torch.where(
                torch.arange(S, device=q.device) >= s_valid,
                torch.full((), -1e30, device=q.device),
                torch.zeros((), device=q.device))[None, None, None, :]
        else:
            if uses_xattn_step(B, T, precomputed_kv):
                # decode steps: the kernel reads the bf16 memory once,
                # scaling and rounding k in registers (no weights returned:
                # decode paths never consume them)
                assert mask is None, "the decode cross-attention is unmasked"
                out = xattn_step(q.contiguous(), k, precomputed_kv[1], d_k)
                if fold:
                    out = out.reshape(B, T, self.n_state)
                return out, None
            v = precomputed_kv[1]
        qh = q.reshape(Bm, Tq, H, d_k).transpose(1, 2)
        kh = k.reshape(Bm, S, H, d_k).transpose(1, 2)
        vh = v.reshape(Bm, S, H, d_k).transpose(1, 2)
        logits = torch.matmul((qh * scale).float(),
                              (kh * scale).float().transpose(-1, -2))
        if mask is not None:
            logits = logits + mask
        w = torch.softmax(logits, dim=-1)
        out = torch.matmul(w.to(dtype).float(), vh.to(dtype).float())
        out = out.transpose(1, 2).reshape(Bm, Tq, self.n_state)
        if fold:
            out = out.reshape(B, T, self.n_state)
        return out.to(dtype), w


class ResidualBlock(nn.Module):
    def __init__(self, n_state: int, n_head: int,
                 cross_attention: bool = False, quant: bool = False):
        super().__init__()
        self.attn = MHA(n_state, n_head, quant)
        self.attn_ln = LayerNorm(n_state, eps=LN_EPS)
        self.cross_attn = MHA(n_state, n_head, quant) if cross_attention \
            else None
        self.cross_attn_ln = (LayerNorm(n_state, eps=LN_EPS)
                              if cross_attention else None)
        self.mlp = nn.Sequential(_dense(quant, n_state, 4 * n_state),
                                 nn.GELU(approximate="none"),
                                 _dense(quant, 4 * n_state, n_state))
        self.mlp_ln = LayerNorm(n_state, eps=LN_EPS)
        if quant:
            # the int8 decoder's residual stream is f32: the layers whose
            # outputs are only added to it store their rounded outputs as
            # f32 (the same values), so that each add reads one dtype
            for layer in (self.attn.out, self.mlp[2]) + (
                    (self.cross_attn.out,) if cross_attention else ()):
                layer.out_dtype = torch.float32

    def forward(self, x, xa=None, mask=None, kv_cache=None, cache_index=None,
                cross_kv=None, pad_lens=None):
        a, _, new_cache = self.attn(self.attn_ln(x), None, mask, kv_cache,
                                    cache_index, pad_lens=pad_lens)
        x = x + a
        cross_w = None
        if self.cross_attn is not None:
            a, cross_w, _ = self.cross_attn(self.cross_attn_ln(x), xa,
                                            precomputed_kv=cross_kv)
            x = x + a
        h = _lin(self.mlp[0], self.mlp_ln(x))
        return x + _lin(self.mlp[2], self.mlp[1](h)), cross_w, new_cache

    def decode_step(self, x, kv_cache, cache_index, cross_kv, pads):
        """forward for a fused single-token decode step (TextDecoder.
        fused_step): six decode_gemv launches and the two attention
        kernels, with forward's rounding points -- the layer norms in the
        GEMVs' prologues, GELU and the residual adds in their epilogues, k
        and v written into the cache by the q/k/v launch. Returns the new
        residual stream."""
        a = self.attn.step_self(x, self.attn_ln, kv_cache, cache_index, pads)
        x = _gemv(self.attn.out, a, residual=x)
        a = self.cross_attn.step_cross(x, self.cross_attn_ln, cross_kv)
        x = _gemv(self.cross_attn.out, a, residual=x)
        h = _gemv(self.mlp[0], x, ln=_norm(self.mlp_ln), gelu=True)
        return _gemv(self.mlp[2], h, residual=x)


class AudioEncoder(nn.Module):
    def __init__(self, dims: WhisperDims):
        super().__init__()
        d = dims
        self.conv1 = nn.Conv1d(d.n_mels, d.n_audio_state, 3, padding=1)
        self.conv2 = nn.Conv1d(d.n_audio_state, d.n_audio_state, 3,
                               stride=2, padding=1)
        self.register_buffer("positional_embedding", torch.from_numpy(
            sinusoids(d.n_audio_ctx, d.n_audio_state)))
        self.blocks = nn.ModuleList(
            ResidualBlock(d.n_audio_state, d.n_audio_head)
            for _ in range(d.n_audio_layer))
        self.ln_post = nn.LayerNorm(d.n_audio_state, eps=LN_EPS)

    def forward(self, mel):
        """mel: [B, n_mels, 3000] -> [B, 1500, n_audio_state]."""
        x = F.gelu(self.conv1(mel.to(self.conv1.weight.dtype)))
        x = F.gelu(self.conv2(x)).transpose(1, 2)
        x = x + self.positional_embedding
        for block in self.blocks:
            x, _, _ = block(x)
        return self.ln_post(x)


class TextDecoder(nn.Module):
    def __init__(self, dims: WhisperDims, quant: bool = False):
        super().__init__()
        d = self.dims = dims
        self.quant = quant
        self.token_embedding = (QuantEmbedding if quant else nn.Embedding)(
            d.n_vocab, d.n_text_state)
        self.positional_embedding = nn.Parameter(
            torch.empty(d.n_text_ctx, d.n_text_state))
        self.blocks = nn.ModuleList(
            ResidualBlock(d.n_text_state, d.n_text_head, cross_attention=True,
                          quant=quant)
            for _ in range(d.n_text_layer))
        self.ln = LayerNorm(d.n_text_state, eps=LN_EPS)

    def forward(self, tokens, xa, pos_offset=0, kv_caches=None,
                return_cross_attn: bool = False, cross_kvs=None,
                pad_lens=None):
        """tokens: [B, T] int64; xa: [B, 1500, D] encoder output (only read
        when cross_kvs is None). pos_offset: the position of the first
        token, an int or, for a single-token step (T = 1), a 0-d int64
        tensor on the model's device (a CUDA graph of the step reads it
        there; no host sync).

        kv_caches: None or per-layer caches — (k, v) [B, ctx, D] unified
        caches (decode mode: T new tokens written at cache slot
        pos_offset) or split beam caches (kp, vp, kg, vg[, anc]); updated
        in place. cross_kvs: None or per-layer (k, v) cross-attention
        projections (WhisperModel.precompute_cross_kv), or their int8 form
        (WhisperModel.quantize_cross_kv). pad_lens: None or
        [B] int32 left-pad widths of per-row prompts right-aligned in a
        common bucket (pad slots are masked; positions shift by -pad so
        each row's first real token sits at position 0).
        Returns (logits [B, T, vocab] f32, caches or None, cross weights).
        """
        d = self.dims
        dev = tokens.device
        T = tokens.shape[1]
        on_device = isinstance(pos_offset, torch.Tensor)
        if on_device and T != 1:
            raise ValueError("a pos_offset tensor serves single-token steps")
        B = tokens.shape[0]
        fused = self.fused_step(B, T, kv_caches, cross_kvs)
        if cross_kvs is not None:
            DECODER_CALLS["xattn_int8"] += uses_xattn_int8(B, T, cross_kvs[0])
            DECODER_CALLS["xattn_step"] += uses_xattn_step(B, T, cross_kvs[0])
        gemv = uses_decode_gemv(B * T, self.token_embedding.weight.dtype)
        DECODER_CALLS["decode_gemv"] += gemv and fused
        DECODER_CALLS["decode_gemv_layerwise"] += gemv and not fused
        if self.quant:
            # int8 rows times their scale, in f32: the int8 decoder's
            # residual stream is f32 (as in flax, f32 + bf16 positions)
            emb8 = self.token_embedding
            emb = emb8.weight[tokens].float() * emb8.scale[tokens][..., None]
        else:
            emb = self.token_embedding(tokens)
        if pad_lens is None:
            x = emb + (self.positional_embedding.index_select(
                0, pos_offset.reshape(1)) if on_device else
                self.positional_embedding[pos_offset:pos_offset + T])
        else:
            pos_idx = torch.clamp(pos_offset + torch.arange(T, device=dev)
                                  [None, :] - pad_lens[:, None], 0,
                                  d.n_text_ctx - 1)
            x = emb + self.positional_embedding[pos_idx]

        d_k = d.n_text_state // d.n_text_head
        if kv_caches is None:
            mask = torch.triu(torch.full((T, T), -float("inf"), device=dev),
                              diagonal=1)
            if pad_lens is not None:
                # pad keys are invisible to every query EXCEPT themselves:
                # a fully-masked softmax row yields NaN, and NaN pad values
                # would poison real rows through 0-weight x NaN
                keypad = (torch.arange(T, device=dev)[None, :]
                          < pad_lens[:, None])[:, None, None, :]
                eye = torch.eye(T, dtype=torch.bool, device=dev)[None, None]
                mask = torch.where(keypad & ~eye, -float("inf"),
                                   mask[None, None])
        elif len(kv_caches[0]) in (4, 5) or (
                T == 1 and _kernel_geometry(d.n_text_state, d_k)):
            # the fused kernels build the visibility rules themselves
            mask = None
        else:
            # suffix decode: attend to cache positions <= current
            ctx = kv_caches[0][0].shape[1]
            pos = pos_offset + torch.arange(T, device=dev)[:, None]
            keys = torch.arange(ctx, device=dev)[None, :]
            mask = torch.where(keys <= pos, 0.0, -float("inf"))
            if pad_lens is not None:
                keypad = (torch.arange(ctx, device=dev)[None, :]
                          < pad_lens[:, None])[:, None, None, :]
                self_key = (keys == pos)[None, None]
                mask = torch.where(keypad & ~self_key, -float("inf"),
                                   mask[None, None])

        cache_index = pos_offset
        if on_device and kv_caches is not None:
            # the slot in the cache (a split cache's generated segment
            # starts after the prompt), made once for every layer
            rel = pos_offset - kv_caches[0][0].shape[1] \
                if len(kv_caches[0]) in (4, 5) else pos_offset
            cache_index = CacheSlot(rel.reshape(1).long(),
                                    rel.to(torch.int32))
        new_caches: List = []
        cross_ws: List = []
        pads = self.step_pads(B, kv_caches[0], pad_lens) if fused else None
        for i, block in enumerate(self.blocks):
            cache = kv_caches[i] if kv_caches is not None else None
            if fused:
                x = block.decode_step(x, cache, cache_index, cross_kvs[i],
                                      pads)
                new_caches.append(cache)
                if return_cross_attn:
                    cross_ws.append(None)
                continue
            x, cw, nc = block(
                x, xa, mask, cache, cache_index,
                cross_kv=cross_kvs[i] if cross_kvs is not None else None,
                pad_lens=pad_lens)
            new_caches.append(nc)
            if return_cross_attn:
                cross_ws.append(cw)
        # the final layer norm stays its own launch: in the logits'
        # prologue every one of their 811 tiles would recompute the rows'
        # statistics (chip_smoke.py phase 2: slower than the separate
        # launch at 3 and 15 rows)
        x = self.ln(x)
        emb = self.token_embedding
        if self.quant:
            # bf16 x times the int8 rows, summed in f32, times the per-row
            # scale (the JAX einsum's preferred_element_type=f32)
            logits = decode_gemv(x, emb.weight, self.ln.weight.dtype,
                                 emb.scale, logits=True) if gemv else \
                torch.matmul(x.to(self.ln.weight.dtype).float(),
                             emb.weight.float().T) * emb.scale
        elif gemv:
            logits = decode_gemv(x, emb.weight, x.dtype, logits=True)
        else:
            logits = torch.matmul(x.float(), emb.weight.float().T)
        return logits, (new_caches if kv_caches is not None else None), \
            cross_ws

    def fused_step(self, B: int, T: int, kv_caches, cross_kvs) -> bool:
        """Whether a forward call of B rows x T tokens runs each block as
        ResidualBlock.decode_step: a single-token step with caches and a
        precomputed cross-attention memory that the step kernels serve
        (xattn_int8 or xattn_step), the kernels' head geometry, and every
        dense layer int8 or bf16 at up to DECODE_GEMV_MAX_ROWS rows."""
        d = self.dims
        return (T == 1 and kv_caches is not None and cross_kvs is not None
                and _kernel_geometry(d.n_text_state,
                                     d.n_text_state // d.n_text_head)
                and uses_decode_gemv(B, self.token_embedding.weight.dtype)
                and uses_decode_gemv(B, self.blocks[0].attn.query.weight.dtype)
                and (uses_xattn_int8(B, 1, cross_kvs[0])
                     or uses_xattn_step(B, 1, cross_kvs[0])))

    @staticmethod
    def step_pads(B: int, cache, pad_lens) -> torch.Tensor:
        """The attention kernels' left-pad widths of a fused step, made once
        for every layer: [B] for the unified cache, one per stream (of the
        split cache's kp.shape[0]) for the split beam cache."""
        rows = cache[0].shape[0] if len(cache) in (4, 5) else B
        if pad_lens is None:
            return torch.zeros(rows, dtype=torch.int32,
                               device=cache[0].device)
        if rows == B:
            return pad_lens
        return pad_lens.reshape(rows, B // rows)[:, 0].contiguous()

    def decode_gemv_per_call(self, fused: bool = True) -> int:
        """decode_gemv launches of a forward call that DECODER_CALLS counts
        under it: a fused step 6 a block (q/k/v, the out projection, the
        cross-attention's query and out projection, fc1, fc2) and the
        logits; a call layer by layer (decode_gemv_layerwise) 8 a block
        and the logits."""
        return (6 if fused else 8) * len(self.blocks) + 1


class WhisperModel(nn.Module):
    """Encoder + decoder bundle with the JAX WhisperModel's entry points.

    Built directly on ``device`` (default: the card; raises without one)
    in ``dtype``; weights come from ``load_state_dict`` (openai layout,
    see load_openai_whisper_checkpoint / variables_from_jax) or ``init``.
    Inference only: parameters do not require grad.

    quant_decoder=True builds the weight-only int8 decoder (QuantDense,
    QuantEmbedding); load it with a state_dict from
    quantize_whisper_decoder (or variables_from_jax of a quantized JAX
    tree). Its int8 weights and f32 scales keep their dtypes; the encoder
    stays in ``dtype``."""

    def __init__(self, dims: WhisperDims, dtype=torch.float32, device=None,
                 quant_decoder: bool = False):
        super().__init__()
        dev = resolve_device(device)
        self.dims = dims
        self.quant_decoder = quant_decoder
        with torch.device(dev):
            self.encoder = AudioEncoder(dims)
            self.decoder = TextDecoder(dims, quant=quant_decoder)
        self.to(device=dev, dtype=dtype)
        for mod in self.decoder.modules():
            if isinstance(mod, QuantDense):
                mod.dtype = dtype
            if isinstance(mod, (QuantDense, QuantEmbedding)):
                mod.scale = mod.scale.float()    # .to(dtype) rounded it
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.decoder.ln.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.decoder.ln.weight.dtype

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "WhisperModel":
        """Seeded random weights with the JAX model's init scales: Dense
        and Conv kernels normal(0, fan_in**-0.5) (lecun), zero biases,
        unit LayerNorms, token embedding normal(0.02), decoder positions
        normal(0.01). ``generator`` must live on the model's device. The
        int8 decoder is made from float weights by
        quantize_whisper_decoder instead."""
        if self.quant_decoder:
            raise ValueError("init a float WhisperModel and quantize its "
                             "state_dict with quantize_whisper_decoder")
        for mod in self.modules():
            if isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, (nn.Linear, nn.Conv1d)):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
        self.decoder.token_embedding.weight.normal_(0.0, 0.02,
                                                    generator=generator)
        self.decoder.positional_embedding.normal_(0.0, 0.01,
                                                  generator=generator)
        return self

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        return self.encoder(mel)

    def encode_windows(self, mels: torch.Tensor, seeks) -> torch.Tensor:
        """Slice per-stream 30 s windows out of the device-resident full
        mels [B, n_mels, T] at frame offsets seeks [B] and encode them.
        The mels are computed over audio padded with N_SAMPLES of zeros,
        so final partial windows carry mel-of-silence exactly like
        openai-whisper's transcribe slicing."""
        n_frames = 2 * self.dims.n_audio_ctx
        windows = torch.stack([mels[b, :, int(s):int(s) + n_frames]
                               for b, s in enumerate(seeks)])
        return self.encoder(windows)

    @torch.no_grad()
    def decode_logits(self, tokens: torch.Tensor, xa: torch.Tensor,
                      pos_offset: int = 0) -> torch.Tensor:
        """Teacher-forced logits [B, T, vocab] f32 of tokens [B, T] against
        the encoder output xa, the first token at position pos_offset."""
        logits, _, _ = self.decoder(tokens, xa, pos_offset)
        return logits

    def empty_kv_caches(self, batch: int, dtype=None,
                        cache_len: Optional[int] = None):
        """Self-attention caches [batch, ctx, D] per layer, in the model
        dtype unless given. ctx defaults to n_text_ctx; callers that know
        prompt+max_new size it tight (every step reads the whole cache)."""
        d = self.dims
        dtype = self.dtype if dtype is None else dtype
        ctx = d.n_text_ctx if cache_len is None else min(cache_len,
                                                         d.n_text_ctx)
        return [tuple(torch.zeros((batch, ctx, d.n_text_state), dtype=dtype,
                                  device=self.device) for _ in range(2))
                for _ in range(d.n_text_layer)]

    def precompute_cross_kv(self, xa: torch.Tensor,
                            layers: Optional[Sequence[int]] = None):
        """Per-layer cross-attention (k, v) projections of xa, hoisted out
        of the decode loop (they depend only on the encoder output). The
        int8 decoder's QuantDense applies the key/value scales. layers:
        only these decoder layers' (a decode workspace projects one layer
        at a time, so that one layer's temporaries are alive at once)."""
        xa_c = xa.to(self.dtype)
        blocks = self.decoder.blocks
        return [(_lin(b.cross_attn.key, xa_c), _lin(b.cross_attn.value, xa_c))
                for b in (blocks if layers is None
                          else [blocks[i] for i in layers])]

    @staticmethod
    def quantize_cross_kv(cross_kvs):
        """Per-(row, channel) symmetric int8 quantization of the
        precomputed cross-attention K/V (JAX WhisperModel.quantize_cross_kv,
        the same operations in the same order, so equal inputs give equal
        codes): scale = max|x| over S, floored at 1e-6, / 127; codes
        round(x / scale) (round half to even) as int8; S zero-padded to a
        multiple of 32 (1500 -> 1504).

        Returns per layer (k8 [B, S_pad, D], k_scale [B, 1, D] f32, v8,
        v_scale, s_valid) with s_valid the real memory length."""
        out = []
        for k, v in cross_kvs:
            codes, scales = [], []
            for x in (k.float(), v.float()):
                s = torch.clamp_min(x.abs().amax(dim=1, keepdim=True),
                                    1e-6) / 127.0
                codes.append(torch.round(x / s).to(torch.int8))
                scales.append(s)
            s_valid = codes[0].shape[1]
            s_pad = -(-s_valid // 32) * 32
            codes = [F.pad(c, (0, 0, 0, s_pad - s_valid)) for c in codes]
            out.append((codes[0], scales[0], codes[1], scales[1], s_valid))
        return out


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def load_openai_whisper_checkpoint(path
                                   ) -> Tuple[Dict[str, torch.Tensor],
                                              WhisperDims]:
    """Load an openai-whisper .pt checkpoint (dims + model_state_dict) as
    (state_dict for WhisperModel, dims)."""
    cpt = torch.load(path, map_location="cpu", weights_only=True)
    dims = WhisperDims(**cpt["dims"])
    sd = dict(cpt["model_state_dict"])
    sd.setdefault("encoder.positional_embedding", torch.from_numpy(
        sinusoids(dims.n_audio_ctx, dims.n_audio_state)))
    return sd, dims


def variables_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's flax variables {"encoder", "decoder"} (numpy or
    array-like leaves) -> a WhisperModel state_dict (f32, int8 kept).
    Inverse of notsofar_tpu.models.whisper.convert_whisper_state_dict:
    Dense kernels (in, out) -> Linear weights [out, in]; Conv kernels
    (k, in, out) -> [out, in, k]; LayerNorm scale -> weight. A tree from the
    JAX package's quantize_whisper_decoder (int8 kernels with their
    ``scale``, int8 ``token_embedding`` with ``token_scale``) gives the
    state_dict of a quant_decoder=True model."""
    sd: Dict[str, torch.Tensor] = {}

    def t(x, perm=None):
        a = np.asarray(x)
        a = a if a.dtype == np.int8 else a.astype(np.float32)
        return torch.tensor(a if perm is None else a.transpose(perm))

    def lin(prefix, p, bias=True):
        sd[prefix + ".weight"] = t(p["kernel"], (1, 0))
        if "scale" in p:            # QuantDense
            sd[prefix + ".scale"] = t(p["scale"])
        if bias:
            sd[prefix + ".bias"] = t(p["bias"])

    def ln(prefix, p):
        sd[prefix + ".weight"] = t(p["scale"])
        sd[prefix + ".bias"] = t(p["bias"])

    def conv(prefix, p):
        sd[prefix + ".weight"] = t(p["kernel"], (2, 1, 0))
        sd[prefix + ".bias"] = t(p["bias"])

    def block(prefix, p, cross):
        for sub in ("attn", "cross_attn") if cross else ("attn",):
            ln(prefix + f".{sub}_ln", p[f"{sub}_ln"])
            for name in ("query", "key", "value", "out"):
                lin(f"{prefix}.{sub}.{name}", p[sub][name],
                    bias=name != "key")
        ln(prefix + ".mlp_ln", p["mlp_ln"])
        lin(prefix + ".mlp.0", p["mlp1"])
        lin(prefix + ".mlp.2", p["mlp2"])

    enc = variables["encoder"]["params"]
    conv("encoder.conv1", enc["conv1"])
    conv("encoder.conv2", enc["conv2"])
    ln("encoder.ln_post", enc["ln_post"])
    n_audio = sum(1 for k in enc if k.startswith("block_"))
    for i in range(n_audio):
        block(f"encoder.blocks.{i}", enc[f"block_{i}"], cross=False)
    consts = variables["encoder"].get("constants", {})
    if "positional_embedding" in consts:
        sd["encoder.positional_embedding"] = t(consts["positional_embedding"])
    else:   # trees converted from checkpoints without the buffer
        sd["encoder.positional_embedding"] = torch.from_numpy(sinusoids(
            WhisperDims.n_audio_ctx, sd["encoder.ln_post.weight"].shape[0]))
    dec = variables["decoder"]["params"]
    sd["decoder.token_embedding.weight"] = t(dec["token_embedding"])
    if "token_scale" in dec:
        sd["decoder.token_embedding.scale"] = t(dec["token_scale"])
    sd["decoder.positional_embedding"] = t(dec["positional_embedding"])
    ln("decoder.ln", dec["ln"])
    n_text = sum(1 for k in dec if k.startswith("block_"))
    for i in range(n_text):
        block(f"decoder.blocks.{i}", dec[f"block_{i}"], cross=True)
    return sd


def convert_hf_whisper_state_dict(sd: Dict, dims: WhisperDims
                                  ) -> Dict[str, torch.Tensor]:
    """HuggingFace transformers Whisper weights (numpy arrays or tensors)
    -> a WhisperModel state_dict in the openai layout.

    Accepts WhisperModel / WhisperForConditionalGeneration state dicts
    (the 'model.' prefix is stripped). Every key the dims call for must
    be present; HF's key projections carry no bias, as openai's."""
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items()
              if k.startswith("model.")}
    out: Dict[str, torch.Tensor] = {}

    def take(dst, src):
        out[dst] = torch.as_tensor(sd[src])

    def lin(dst, src, bias=True):
        take(dst + ".weight", src + ".weight")
        if bias:
            take(dst + ".bias", src + ".bias")

    def block(dst, src, cross):
        subs = (("attn", "self_attn"), ("cross_attn", "encoder_attn")) \
            if cross else (("attn", "self_attn"),)
        for ours, theirs in subs:
            lin(f"{dst}.{ours}_ln", f"{src}.{theirs}_layer_norm")
            for name, hf in (("query", "q_proj"), ("key", "k_proj"),
                             ("value", "v_proj"), ("out", "out_proj")):
                lin(f"{dst}.{ours}.{name}", f"{src}.{theirs}.{hf}",
                    bias=name != "key")
        lin(dst + ".mlp_ln", src + ".final_layer_norm")
        lin(dst + ".mlp.0", src + ".fc1")
        lin(dst + ".mlp.2", src + ".fc2")

    lin("encoder.conv1", "encoder.conv1")
    lin("encoder.conv2", "encoder.conv2")
    lin("encoder.ln_post", "encoder.layer_norm")
    take("encoder.positional_embedding", "encoder.embed_positions.weight")
    for i in range(dims.n_audio_layer):
        block(f"encoder.blocks.{i}", f"encoder.layers.{i}", cross=False)
    take("decoder.token_embedding.weight", "decoder.embed_tokens.weight")
    take("decoder.positional_embedding", "decoder.embed_positions.weight")
    lin("decoder.ln", "decoder.layer_norm")
    for i in range(dims.n_text_layer):
        block(f"decoder.blocks.{i}", f"decoder.layers.{i}", cross=True)
    return out


_QUANT_KEY = re.compile(r"decoder\.(blocks\.\d+\.((cross_)?attn\.(query|key|"
                        r"value|out)|mlp\.[02])|token_embedding)\.weight")


def quantize_whisper_decoder(sd: Dict[str, torch.Tensor]
                             ) -> Dict[str, torch.Tensor]:
    """A float WhisperModel state_dict -> the state_dict of a
    quant_decoder=True model (JAX quantize_whisper_decoder).

    Every decoder block's self- and cross-attention query/key/value/out
    and mlp weights get a per-output-channel scale max|w| / 127 (0 -> 1)
    and codes clip(round(w / scale), -127, 127) as int8; the tied token
    embedding gets a per-row scale. Layer norms, biases, the positional
    embedding and the encoder are untouched. Runs on the tensors' own
    device, so a model on the card is quantized there and only int8 bytes
    reach the int8 model."""
    out = dict(sd)
    for name, w in sd.items():
        if not _QUANT_KEY.fullmatch(name):
            continue
        w = w.float()                       # [out, in] or [V, D]: per row
        s = w.abs().amax(dim=1) / 127.0
        s = torch.where(s == 0, torch.ones_like(s), s)
        out[name] = torch.clamp(torch.round(w / s[:, None]), -127,
                                127).to(torch.int8)
        out[name[:-len("weight")] + "scale"] = s
    return out
