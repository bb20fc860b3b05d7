"""Whisper encoder/decoder in torch.nn with KV-cached decoding.

Port of notsofar_tpu/models/whisper.py. Parameters use the openai-whisper
checkpoint layout (``encoder.blocks.{i}.attn.query.weight`` ...), so an
openai ``.pt`` loads with ``load_state_dict``; ``variables_from_jax``
converts the JAX package's flax tree into the same layout, which is how
the parity tests give both packages identical weights.

Numerics follow the JAX model: matmuls in the model dtype; attention
logits, softmax and the decoder's output logits in f32, with attention
weights rounded to the value dtype before the weights-times-values
product. ``MHA`` keeps the reference's three kernel dispatch predicates
exactly (split cache, T=1 cache step, encoder 512 <= T == S <= 2048), so
the same calls reach the same kernels on both sides.

The int8 decoder (QuantDense, quantize_whisper_decoder, quantize_cross_kv
and the xattn_int8 kernel) is a later slice of the port.
"""
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from notsofar_tpu_torch.ops.kernels import (attn_step, attn_step_split,
                                            encoder_mha)
from notsofar_tpu_torch.utils.device import resolve_device

LN_EPS = 1e-5
INT8_SLICE_MSG = ("the int8 decoder (QuantDense, quantize_cross_kv and the "
                  "xattn_int8 kernel) is ported in a later slice of "
                  "notsofar_tpu_torch")


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


def _lin(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """Dense in the layer's dtype (flax Dense(dtype) casts its input)."""
    return layer(x.to(layer.weight.dtype))


def _kernel_geometry(n_state: int, d_k: int) -> bool:
    """The head geometry the decode-step kernels cover (every Whisper
    checkpoint has dk=64)."""
    return d_k in (64, 128) and n_state % 128 == 0


class MHA(nn.Module):
    """Whisper attention: q/out have bias, k has none, v has bias; scaling
    by d_k**-0.25 applied to both q and k."""

    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.n_state = n_state
        self.n_head = n_head
        self.query = nn.Linear(n_state, n_state)
        self.key = nn.Linear(n_state, n_state, bias=False)
        self.value = nn.Linear(n_state, n_state)
        self.out = nn.Linear(n_state, n_state)

    def forward(self, x, xa=None, mask=None, kv_cache=None, cache_index=None,
                precomputed_kv=None, pad_lens=None):
        """x: [B, T, D] queries. xa: cross-attention memory [B, S, D] or
        None for self-attention. kv_cache: optional (k, v) [B, ctx, D]
        caches written at cache_index, or the split beam cache
        (kp, vp, kg, vg[, anc]). Caches are updated IN PLACE (the JAX
        model's dynamic_update_slice on its loop carry) and returned.
        precomputed_kv: optional (k, v) [Bm, S, D] cross-attention memory
        already projected (see WhisperModel.precompute_cross_kv).
        Returns (out, attention weights or None, cache or None)."""
        d_k = self.n_state // self.n_head
        H = self.n_head
        dtype = self.query.weight.dtype
        q = _lin(self.query, x)
        if precomputed_kv is not None:
            out, w = self._attend_precomputed(q, precomputed_kv, mask)
            return _lin(self.out, out), w, None
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
            ck[:, cache_index:cache_index + T] = k.to(ck.dtype)
            cv[:, cache_index:cache_index + T] = v.to(cv.dtype)
            new_cache = (ck, cv)
            if T == 1 and _kernel_geometry(self.n_state, d_k):
                # incremental decode step: the fused kernel builds the
                # suffix-decode mask (incl. pad_lens) itself, so `mask` is
                # ignored on this path
                B = q.shape[0]
                pads = (torch.zeros(B, dtype=torch.int32, device=q.device)
                        if pad_lens is None else pad_lens)
                q_eff = (q * (d_k ** -0.5)).to(ck.dtype)
                out = attn_step(q_eff, ck, cv, cache_index, pads, d_k)
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

    def _attend_precomputed(self, q, precomputed_kv, mask):
        """Cross-attention against an already-projected memory (k, v)
        [Bm, S, D]. When the query batch B is a multiple of Bm (beam
        search: K beams share one window's memory) the beam axis folds
        into the query-time axis, so the memory is read once per window.
        Returns (out [B, T, D] pre-out-projection, weights)."""
        if len(precomputed_kv) != 2:
            raise NotImplementedError(INT8_SLICE_MSG)
        d_k = self.n_state // self.n_head
        H = self.n_head
        dtype = self.query.weight.dtype
        B, T, _ = q.shape
        k, v = precomputed_kv
        Bm, S = k.shape[:2]
        fold = Bm != B
        if fold:
            assert mask is None and B % Bm == 0
            q = q.reshape(Bm, (B // Bm) * T, self.n_state)
        Tq = q.shape[1]
        scale = d_k ** -0.25
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
                 cross_attention: bool = False):
        super().__init__()
        self.attn = MHA(n_state, n_head)
        self.attn_ln = nn.LayerNorm(n_state, eps=LN_EPS)
        self.cross_attn = MHA(n_state, n_head) if cross_attention else None
        self.cross_attn_ln = (nn.LayerNorm(n_state, eps=LN_EPS)
                              if cross_attention else None)
        self.mlp = nn.Sequential(nn.Linear(n_state, 4 * n_state),
                                 nn.GELU(approximate="none"),
                                 nn.Linear(4 * n_state, n_state))
        self.mlp_ln = nn.LayerNorm(n_state, eps=LN_EPS)

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
        return x + self.mlp(self.mlp_ln(x)), cross_w, new_cache


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
    def __init__(self, dims: WhisperDims):
        super().__init__()
        d = self.dims = dims
        self.token_embedding = nn.Embedding(d.n_vocab, d.n_text_state)
        self.positional_embedding = nn.Parameter(
            torch.empty(d.n_text_ctx, d.n_text_state))
        self.blocks = nn.ModuleList(
            ResidualBlock(d.n_text_state, d.n_text_head, cross_attention=True)
            for _ in range(d.n_text_layer))
        self.ln = nn.LayerNorm(d.n_text_state, eps=LN_EPS)

    def forward(self, tokens, xa, pos_offset: int = 0, kv_caches=None,
                return_cross_attn: bool = False, cross_kvs=None,
                pad_lens=None):
        """tokens: [B, T] int64; xa: [B, 1500, D] encoder output (only read
        when cross_kvs is None).

        kv_caches: None or per-layer caches — (k, v) [B, ctx, D] unified
        caches (decode mode: T new tokens written at cache slot
        pos_offset) or split beam caches (kp, vp, kg, vg[, anc]); updated
        in place. cross_kvs: None or per-layer (k, v) cross-attention
        projections (WhisperModel.precompute_cross_kv). pad_lens: None or
        [B] int32 left-pad widths of per-row prompts right-aligned in a
        common bucket (pad slots are masked; positions shift by -pad so
        each row's first real token sits at position 0).
        Returns (logits [B, T, vocab] f32, caches or None, cross weights).
        """
        d = self.dims
        dev = tokens.device
        T = tokens.shape[1]
        emb = self.token_embedding(tokens)
        if pad_lens is None:
            x = emb + self.positional_embedding[pos_offset:pos_offset + T]
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

        new_caches: List = []
        cross_ws: List = []
        for i, block in enumerate(self.blocks):
            cache = kv_caches[i] if kv_caches is not None else None
            x, cw, nc = block(
                x, xa, mask, cache, pos_offset,
                cross_kv=cross_kvs[i] if cross_kvs is not None else None,
                pad_lens=pad_lens)
            new_caches.append(nc)
            if return_cross_attn:
                cross_ws.append(cw)
        x = self.ln(x)
        logits = torch.matmul(x.float(),
                              self.token_embedding.weight.float().T)
        return logits, (new_caches if kv_caches is not None else None), \
            cross_ws


class WhisperModel(nn.Module):
    """Encoder + decoder bundle with the JAX WhisperModel's entry points.

    Built directly on ``device`` (default: the card; raises without one)
    in ``dtype``; weights come from ``load_state_dict`` (openai layout,
    see load_openai_whisper_checkpoint / variables_from_jax) or ``init``.
    Inference only: parameters do not require grad."""

    def __init__(self, dims: WhisperDims, dtype=torch.float32, device=None,
                 quant_decoder: bool = False):
        super().__init__()
        if quant_decoder:
            raise NotImplementedError(INT8_SLICE_MSG)
        dev = resolve_device(device)
        self.dims = dims
        with torch.device(dev):
            self.encoder = AudioEncoder(dims)
            self.decoder = TextDecoder(dims)
        self.to(device=dev, dtype=dtype)
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
        normal(0.01). ``generator`` must live on the model's device."""
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

    def precompute_cross_kv(self, xa: torch.Tensor):
        """Per-layer cross-attention (k, v) projections of xa, hoisted out
        of the decode loop (they depend only on the encoder output)."""
        xa_c = xa.to(self.dtype)
        return [(_lin(b.cross_attn.key, xa_c), _lin(b.cross_attn.value, xa_c))
                for b in self.decoder.blocks]


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
    array-like leaves) -> a WhisperModel state_dict (f32). Inverse of
    notsofar_tpu.models.whisper.convert_whisper_state_dict: Dense kernels
    (in, out) -> Linear weights [out, in]; Conv kernels (k, in, out) ->
    [out, in, k]; LayerNorm scale -> weight."""
    sd: Dict[str, torch.Tensor] = {}

    def t(x, perm=None):
        a = np.asarray(x, dtype=np.float32)
        return torch.tensor(a if perm is None else a.transpose(perm))

    def lin(prefix, p, bias=True):
        sd[prefix + ".weight"] = t(p["kernel"], (1, 0))
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
    sd["decoder.positional_embedding"] = t(dec["positional_embedding"])
    ln("decoder.ln", dec["ln"])
    n_text = sum(1 for k in dec if k.startswith("block_"))
    for i in range(n_text):
        block(f"decoder.blocks.{i}", dec[f"block_{i}"], cross=True)
    return sd
