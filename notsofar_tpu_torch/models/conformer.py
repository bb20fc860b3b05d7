"""Conformer speech-separation network in torch.nn.

Port of notsofar_tpu/models/conformer.py (the reference Conformer CSS):

* relative position term: a [2*maxlen, d_k] table indexed by pairwise
  offsets clipped to +-maxlen, added to the logits as q . pos_k before the
  1/sqrt(d_k) scale;
* pre-LN multi-head attention; macaron 0.5*FFN sandwich; conv module (LN
  -> two scalar pointwise taps forming a GLU -> depthwise temporal conv
  -> BatchNorm -> ReLU -> scalar pointwise tap); a LayerNorm at the end
  of every layer;
* ConformerCSS head: constant input bias/scale, encoder,
  Linear(d, F*(S+N)), sigmoid, source-major chunks -> [B, F, T, S+N].

Modules and parameters carry the flax names, so a flax tree maps onto the
state dict by name (models/convert.py::variables_from_jax). They round
where the flax modules round: Dense layers compute in the module dtype
(weights kept f32 and cast at use); LayerNorm and BatchNorm promote to f32
(flax's fast variance E[x^2] - E[x]^2); attention logits and softmax are
f32 products of the dtype-rounded q, k and position table, and the
weights are cast to the value dtype before the f32 p.v product; the
depthwise conv (33 taps, a flax nn.Conv in the JAX package) is
F.conv1d(groups=D) in the module dtype plus its bias in that dtype; the
mask sigmoid runs on f32.

`module.eval()` is flax's deterministic=True, use_running_average=True;
`module.train()` is deterministic=False, use_running_average=False:
dropout at flax's six sites (FFN after the ReLU and after w2, the
attention probabilities and output, the conv module's output, the encoder
after embed_ln) with masks drawn from the `generator` passed to forward,
and the conv module's batch norm on batch statistics (models/titanet.py
BatchNorm, momentum 0.9).
"""
import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from notsofar_tpu_torch.models.titanet import BatchNorm, Dense

LN_EPS = 1e-5  # torch nn.LayerNorm default


@dataclass(frozen=True)
class ConformerConfig:
    """Mirror of ConformerCfg (the reference conformer_wrapper.py)."""
    attention_dim: int = 256
    attention_heads: int = 4
    dropout_rate: float = 0.1
    kernel_size: int = 33
    linear_units: int = 1024
    num_blocks: int = 16
    relative_pos_emb: bool = True
    pos_maxlen: int = 1000


class LayerNorm(nn.Module):
    """flax nn.LayerNorm over the last axis, in f32: var = max(0,
    E[x^2] - E[x]^2), y = (x - mean) * (rsqrt(var + eps) * scale) + bias."""

    def __init__(self, dim: int, eps: float = LN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp_min((x * x).mean(-1, keepdim=True) - mean * mean,
                              0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


def dropout(mod: nn.Module, x: torch.Tensor, p: float, generator
            ) -> torch.Tensor:
    """flax nn.Dropout(p): the identity in eval mode or at p 0; in train
    mode each element is kept with probability 1 - p (a Bernoulli draw from
    `generator`, a torch.Generator on x's device) and scaled by
    1 / (1 - p)."""
    if not mod.training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode draws its masks from an "
                         "explicit torch.Generator; pass generator=")
    keep = torch.empty(x.shape, device=x.device).bernoulli_(
        1.0 - p, generator=generator)
    return torch.where(keep.bool(), x / (1.0 - p), torch.zeros_like(x))


class FeedForward(nn.Module):
    def __init__(self, d_model: int, d_inner: int, dtype,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.p = dropout_rate
        self.ln = LayerNorm(d_model)
        self.w1 = Dense(d_model, d_inner, True, dtype)
        self.w2 = Dense(d_inner, d_model, True, dtype)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        x = dropout(self, torch.relu(self.w1(self.ln(x))), self.p, generator)
        return dropout(self, self.w2(x), self.p, generator)


class MultiHeadedAttention(nn.Module):
    def __init__(self, n_head: int, n_feat: int, dtype,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.p = dropout_rate
        self.h = n_head
        self.d_k = n_feat // n_head
        self.ln = LayerNorm(n_feat)
        self.q = Dense(n_feat, n_feat, True, dtype)
        self.k = Dense(n_feat, n_feat, True, dtype)
        self.v = Dense(n_feat, n_feat, True, dtype)
        self.out = Dense(n_feat, n_feat, True, dtype)

    def forward(self, x: torch.Tensor, pos_k, generator=None
                ) -> torch.Tensor:
        """x: [B, T, D]; pos_k: [T, T, d_k] f32 or None."""
        B, T, D = x.shape
        h, d_k = self.h, self.d_k
        x = self.ln(x)
        q, k, v = (lin(x).reshape(B, T, h, d_k).transpose(1, 2)
                   for lin in (self.q, self.k, self.v))     # [B, h, T, dk]
        # f32 products of the dtype-rounded operands (flax's
        # preferred_element_type=float32 einsums)
        qf = q.float()
        scores = torch.matmul(qf, k.float().transpose(-1, -2))
        if pos_k is not None:
            pk = pos_k.to(q.dtype).float()                  # [T, T, dk]
            rel = torch.matmul(qf.permute(2, 0, 1, 3).reshape(T, B * h, d_k),
                               pk.transpose(1, 2))          # [T, B*h, T]
            scores = scores + rel.reshape(T, B, h, T).permute(1, 2, 0, 3)
        scores = scores / math.sqrt(d_k)
        attn = dropout(self, torch.softmax(scores, dim=-1), self.p, generator)
        out = torch.matmul(attn.to(v.dtype).float(), v.float())
        out = out.transpose(1, 2).reshape(B, T, D)
        return dropout(self, self.out(out), self.p, generator)


class ConvModule(nn.Module):
    def __init__(self, input_dim: int, kernel_size: int, dtype,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.p = dropout_rate
        self.dtype = dtype
        self.kernel_size = kernel_size
        self.ln = LayerNorm(input_dim)
        # the reference's Conv2d(1, 2, 1) and Conv2d(1, 1, 1): scalar taps
        self.pw1_w = nn.Parameter(torch.ones(2))
        self.pw1_b = nn.Parameter(torch.zeros(2))
        self.dw = nn.Conv1d(input_dim, input_dim, kernel_size,
                            groups=input_dim)
        self.bn = BatchNorm(input_dim, 1e-5, momentum=0.9)
        self.pw2_w = nn.Parameter(torch.ones(1))
        self.pw2_b = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """x: [B, T, D] -> [B, T, D] f32."""
        x = self.ln(x)
        a = x * self.pw1_w[0] + self.pw1_b[0]
        b = x * self.pw1_w[1] + self.pw1_b[1]
        x = a * torch.sigmoid(b)
        pad = (self.kernel_size - 1) // 2
        y = F.conv1d(x.to(self.dtype).transpose(1, 2),
                     self.dw.weight.to(self.dtype), padding=pad,
                     groups=x.shape[-1])
        x = y.transpose(1, 2) + self.dw.bias.to(self.dtype)
        x = torch.relu(self.bn(x))
        return dropout(self, x * self.pw2_w[0] + self.pw2_b[0], self.p,
                       generator)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ConformerConfig, dtype):
        super().__init__()
        c, p = cfg, cfg.dropout_rate
        self.ffn_in = FeedForward(c.attention_dim, c.linear_units, dtype, p)
        self.attn = MultiHeadedAttention(c.attention_heads, c.attention_dim,
                                         dtype, p)
        self.conv = ConvModule(c.attention_dim, c.kernel_size, dtype, p)
        self.ffn_out = FeedForward(c.attention_dim, c.linear_units, dtype, p)
        self.ln_out = LayerNorm(c.attention_dim)

    def forward(self, x: torch.Tensor, pos_k, generator=None
                ) -> torch.Tensor:
        x = x + 0.5 * self.ffn_in(x, generator)
        x = x + self.attn(x, pos_k, generator)
        x = x + self.conv(x, generator)
        x = x + 0.5 * self.ffn_out(x, generator)
        return self.ln_out(x)


class ConformerEncoder(nn.Module):
    def __init__(self, idim: int, cfg: ConformerConfig, dtype):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.embed = Dense(idim, c.attention_dim, True, dtype)
        self.embed_ln = LayerNorm(c.attention_dim)
        if c.relative_pos_emb:
            self.pos_emb = nn.Parameter(torch.zeros(
                2 * c.pos_maxlen, c.attention_dim // c.attention_heads))
        for i in range(c.num_blocks):
            self.add_module(f"layer_{i}", EncoderLayer(c, dtype))

    def forward(self, xs: torch.Tensor, generator=None) -> torch.Tensor:
        """xs: [B, T, idim] -> [B, T, attention_dim] f32."""
        c = self.cfg
        x = dropout(self, self.embed_ln(self.embed(xs)), c.dropout_rate,
                    generator)
        x = torch.relu(x)
        pos_k = None
        if c.relative_pos_emb:
            T = x.shape[1]
            ar = torch.arange(T, device=x.device)
            pos_seq = torch.clamp(ar[:, None] - ar[None, :], -c.pos_maxlen,
                                  c.pos_maxlen - 1) + c.pos_maxlen
            # a gather, whose gradient is a scatter-add into the table
            pos_k = self.pos_emb[pos_seq]                   # [T, T, d_k]
        for i in range(c.num_blocks):
            x = getattr(self, f"layer_{i}")(x, pos_k, generator)
        return x


class ConformerCSS(nn.Module):
    """Mask-estimation head: encoder -> Linear -> sigmoid -> masks
    [B, F, T, num_spks + num_nois]. The reference's stats-file input
    normalization is the constant input_bias/input_scale buffers."""

    def __init__(self, in_features: int = 1799, num_bins: int = 257,
                 num_spks: int = 3, num_nois: int = 1,
                 conformer: ConformerConfig = ConformerConfig(),
                 dtype=torch.float32):
        super().__init__()
        self.num_bins = num_bins
        self.num_src = num_spks + num_nois
        self.register_buffer("input_bias", torch.zeros(in_features))
        self.register_buffer("input_scale", torch.ones(in_features))
        self.encoder = ConformerEncoder(in_features, conformer, dtype)
        self.mask_head = Dense(conformer.attention_dim,
                               num_bins * self.num_src, True, dtype)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "ConformerCSS":
        """Seeded random weights with flax's initializers: lecun_normal
        (normal truncated at two std, std fan_in**-0.5 / 0.8796) for dense
        and conv kernels, zero biases, identity norms, N(0, 1) position
        table and scalar taps; identity input normalization."""
        trunc = 0.87962566103423978
        for mod in self.modules():
            if isinstance(mod, (Dense, nn.Conv1d)):
                fan_in = mod.weight.shape[1] if isinstance(mod, Dense) \
                    else mod.weight.shape[1] * mod.weight.shape[2]
                std = fan_in ** -0.5 / trunc
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std,
                                      2 * std, generator=generator)
                mod.bias.zero_()
            elif isinstance(mod, (LayerNorm, BatchNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                if isinstance(mod, BatchNorm):
                    mod.running_mean.zero_()
                    mod.running_var.fill_(1.0)
            elif isinstance(mod, ConvModule):
                for p in (mod.pw1_w, mod.pw2_w):
                    p.normal_(generator=generator)
                mod.pw1_b.zero_()
                mod.pw2_b.zero_()
        if hasattr(self.encoder, "pos_emb"):
            self.encoder.pos_emb.normal_(generator=generator)
        self.input_bias.zero_()
        self.input_scale.fill_(1.0)
        return self

    def forward(self, f: torch.Tensor, generator=None) -> torch.Tensor:
        """f: [B, D, T] feature -> masks [B, F, T, S+N] f32. generator:
        the dropout masks' torch.Generator in train mode."""
        x = (f.transpose(1, 2) + self.input_bias) * self.input_scale
        x = self.encoder(x, generator)
        m = torch.sigmoid(self.mask_head(x).float())        # [B, T, F*(S+N)]
        B, T, _ = m.shape
        # torch.chunk along the feature axis: source s is columns
        # [s*F, (s+1)*F)
        return m.reshape(B, T, self.num_src, self.num_bins).permute(0, 3, 1, 2)
