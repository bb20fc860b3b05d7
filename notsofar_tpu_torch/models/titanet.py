"""TitaNet speaker-embedding encoder in PyTorch.

Port of notsofar_tpu/models/titanet.py (NeMo's TitaNet-large as used by
word-based diarization):

    mel features (80, 25ms/10ms, per-feature normalized)
    -> prologue: separable conv block (k=3)
    -> 3 mega blocks: repeated separable convs + residual + squeeze-excite
       (kernels 7/11/15, 1024 channels for the 'large' variant)
    -> epilogue separable conv block (k=1, 3072 channels)
    -> ECAPA-style attentive statistics pooling with global context
    -> bottleneck linear + BN -> 192-d embedding.

Activations are [B, T, C] (time-major, channels last) as in the JAX
package, and the modules round where the flax modules round: convs and
dense layers compute in the module dtype (weights kept in f32 and cast at
use, as flax does), batch norms promote to f32 (flax BatchNorm without a
dtype returns float32 for a bf16 input and f32 statistics), and the
pooling statistics and softmax run in f32. Pointwise 1x1 convs are
matmuls, never cuDNN convs (which run f32 in TF32 on the card by
default). The depthwise convs of the mega blocks (kernel > 1, C % 128 ==
0, where the JAX module takes its Pallas kernel) go through
ops.kernels.depthwise_conv1d: the CUDA kernel on the card, its plain
version on the CPU.
"""
import contextlib
import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from notsofar_tpu_torch.asr.mel import mel_filterbank
from notsofar_tpu_torch.ops.kernels import depthwise_conv1d
from notsofar_tpu_torch.parallel.mesh import all_reduce_sum
from notsofar_tpu_torch.utils.device import cudnn_f32, resolve_device

HOP = 160


@dataclass(frozen=True)
class TitaNetConfig:
    n_mels: int = 80
    filters: int = 1024
    prologue_kernel: int = 3
    block_kernels: Tuple[int, ...] = (7, 11, 15)
    block_repeat: int = 3
    epilogue_filters: int = 3072
    se_reduction: int = 8
    attention_dim: int = 128
    emb_dim: int = 192
    dropout: float = 0.0
    # squeeze-excite presence on the prologue / epilogue blocks (NeMo
    # builds it from the checkpoint's jasper config; titanet_convert.
    # detect_titanet_config reads it from a state dict)
    prologue_se: bool = True
    epilogue_se: bool = True


@lru_cache(maxsize=2)
def _dft_matrices(win: int = 400, nfft: int = 512):
    """[nfft//2+1, win] real and imaginary DFT rows times a symmetric hann
    of `win` taps (zero-centred in the nfft frame)."""
    n = np.arange(win)
    w = 0.5 * (1 - np.cos(2 * np.pi * n / (win - 1)))
    f = np.arange(nfft // 2 + 1)
    ph = 2 * np.pi * np.outer(f, n) / nfft
    return (np.cos(ph) * w).astype(np.float32), \
        (-np.sin(ph) * w).astype(np.float32)


def titanet_features(audio: torch.Tensor, sr: int = 16000,
                     n_mels: int = 80,
                     lengths: Optional[torch.Tensor] = None,
                     preemph: float = 0.97,
                     pad_to: int = 16) -> torch.Tensor:
    """[B, L] waveform -> [B, n_mels, frames] normalized log-mel (f32).

    NeMo AudioToMelSpectrogramPreprocessor semantics, as in the JAX
    package: preemphasis 0.97, 25 ms window / 10 ms hop, 512-point DFT by
    matmul (400-tap symmetric hann, reflect pad of 200), slaney mel,
    log(x + 2^-24), then per-mel-bin normalization over time with the
    unbiased (N-1) std. With `lengths` (valid samples per row) the
    statistics use only the valid frames and the padded frames are zeroed.
    Frames are right-padded to a multiple of `pad_to` (NeMo pad_to=16),
    which sets the squeeze-excite padded-width denominator downstream."""
    win, hop, nfft = 400, HOP, 512
    audio = audio.float()
    if preemph:
        audio = torch.cat([audio[..., :1],
                           audio[..., 1:] - preemph * audio[..., :-1]], -1)
    kr, ki = (torch.from_numpy(m).to(audio.device) for m in _dft_matrices())
    fb = torch.from_numpy(mel_filterbank(n_mels, sr, nfft)).to(audio.device)
    lead = audio.shape[:-1]
    pad = win // 2
    x = F.pad(audio.reshape(-1, 1, audio.shape[-1]), (pad, pad),
              mode="reflect").reshape(*lead, -1)
    frames = x.unfold(-1, win, hop)                  # [..., T, win]
    r = torch.matmul(frames, kr.t())                 # [..., T, F]
    i = torch.matmul(frames, ki.t())
    mag2 = r * r + i * i
    mel = torch.matmul(mag2, fb.t()).transpose(-1, -2)   # [..., M, T]
    logmel = torch.log(mel + 2.0 ** -24)
    if lengths is None:
        n = logmel.shape[-1]
        mean = logmel.mean(dim=-1, keepdim=True)
        var = logmel.var(dim=-1, keepdim=True, correction=0) \
            * (n / max(n - 1, 1))
        out = (logmel - mean) / (torch.sqrt(var) + 1e-5)
    else:
        frame_lengths = lengths.to(audio.device) // hop + 1
        Tf = logmel.shape[-1]
        m = (torch.arange(Tf, device=audio.device)[None, :]
             < frame_lengths[:, None])[:, None, :].float()   # [B, 1, Tf]
        denom = torch.clamp_min(m.sum(dim=-1, keepdim=True), 1.0)
        mean = (logmel * m).sum(dim=-1, keepdim=True) / denom
        var = ((logmel - mean) ** 2 * m).sum(dim=-1, keepdim=True) \
            / torch.clamp_min(denom - 1.0, 1.0)
        out = (logmel - mean) / (torch.sqrt(var) + 1e-5) * m
    if pad_to and out.shape[-1] % pad_to:
        out = F.pad(out, (0, pad_to - out.shape[-1] % pad_to))
    return out


class Dense(nn.Module):
    """flax nn.Dense / 1x1 nn.Conv over the last axis: weight [out, in]
    (f32, cast to `dtype` at use), optional bias; the product and the bias
    add both round to `dtype`, as flax's dot then add do."""

    def __init__(self, d_in: int, d_out: int, bias: bool, dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.dtype), self.weight.to(self.dtype).t())
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class BatchNorm(nn.Module):
    """Batch norm over the last axis with flax's arithmetic:
    (x - mean) * (rsqrt(var + eps) * scale) + bias, promoted to f32.

    mean and var are the running statistics, except in train mode with a
    `momentum` (the Conformer's flax nn.BatchNorm(momentum=0.9) with
    use_running_average=False): there they are the batch's, in f32 over
    every axis but the last, mean = E[x] and the biased fast variance
    var = max(0, E[x^2] - E[x]^2), summed over the global batch when a
    process group is initialized (parallel.mesh.all_reduce_sum, which the
    backward pass reduces too); the running statistics then move to
    momentum * running + (1 - momentum) * batch. Without a momentum
    (TitaNet, MarbleNet: inference only) both modes read the running
    statistics."""

    def __init__(self, channels: int, eps: float,
                 momentum: Optional[float] = None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training and self.momentum is not None:
            flat = x.reshape(-1, x.shape[-1])
            count = torch.full((1,), flat.shape[0], dtype=torch.float32,
                               device=x.device)
            stats = all_reduce_sum(torch.cat(
                [flat.sum(0), (flat * flat).sum(0), count]))
            C, n = x.shape[-1], stats[-1]
            mean, mean2 = stats[:C] / n, stats[C:2 * C] / n
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class DepthwiseConv(nn.Module):
    """'Same' depthwise conv over time; weight [k, C] f32 taps (flax's
    nn.Conv(feature_group_count=C) kernel [k, 1, C], squeezed).

    Where the JAX module takes its Pallas kernel (kernel > 1 and
    C % 128 == 0) this calls ops.kernels.depthwise_conv1d on the input in
    the module dtype and f32 taps, and casts its f32 output to the module
    dtype; elsewhere (the prologue's 80 mel channels, the epilogue's k=1)
    it runs the grouped conv in the module dtype, as the JAX module's
    lax.conv branch does."""

    def __init__(self, channels: int, kernel: int, dtype):
        super().__init__()
        self.kernel = kernel
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(kernel, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        C = x.shape[-1]
        if self.kernel > 1 and C % 128 == 0:
            out = depthwise_conv1d(x.to(self.dtype).contiguous(),
                                   self.weight, self.kernel)
            return out.to(self.dtype)
        pad = (self.kernel - 1) // 2
        w = self.weight.to(self.dtype).t().unsqueeze(1)      # [C, 1, k]
        # in f32 with cuDNN's TF32 off, as the JAX module's f32 lax.conv
        with cudnn_f32() if self.dtype == torch.float32 else \
                contextlib.nullcontext():
            out = F.conv1d(x.to(self.dtype).transpose(1, 2), w, padding=pad,
                           groups=C)
        return out.transpose(1, 2)


class SeparableConv(nn.Module):
    def __init__(self, c_in: int, filters: int, kernel: int, dtype):
        super().__init__()
        self.dw = DepthwiseConv(c_in, kernel, dtype)
        self.pw = Dense(c_in, filters, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, T, C]."""
        return self.pw(self.dw(x))


class SqueezeExcite(nn.Module):
    """NeMo jasper.SqueezeExcite (context_window=-1): the masked sum over
    valid frames divided by the PADDED width x.shape[1] (NeMo's
    export-compat choice, so bucket widths must stay NeMo's pad-to-16
    frame counts), two bias-free linears with ReLU between, sigmoid
    gate."""

    def __init__(self, channels: int, reduction: int, dtype):
        super().__init__()
        self.fc1 = Dense(channels, channels // reduction, False, dtype)
        self.fc2 = Dense(channels // reduction, channels, False, dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        s = (x * mask).sum(dim=1, keepdim=True) / x.shape[1]   # [B, 1, C]
        s = self.fc2(torch.relu(self.fc1(s)))
        return x * torch.sigmoid(s)


class TitaNetBlock(nn.Module):
    """One JasperBlock: `repeat` separable convs (BN + ReLU between, the
    input masked before each conv), squeeze-excite, the masked 1x1-conv
    residual (+ BN) add, then ReLU."""

    def __init__(self, cfg: TitaNetConfig, c_in: int, kernel: int,
                 repeat: int, residual: bool, filters: int, use_se: bool,
                 dtype):
        super().__init__()
        self.repeat = repeat
        for r in range(repeat):
            self.add_module(f"conv_{r}", SeparableConv(
                c_in if r == 0 else filters, filters, kernel, dtype))
            self.add_module(f"bn_{r}", BatchNorm(filters, 1e-3))
        self.se = SqueezeExcite(filters, cfg.se_reduction, dtype) \
            if use_se else None
        if residual:
            self.res_pw = Dense(c_in, filters, False, dtype)
            self.res_bn = BatchNorm(filters, 1e-3)
        else:
            self.res_pw = None

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        inp = x
        for r in range(self.repeat):
            x = getattr(self, f"conv_{r}")(x * mask)
            x = getattr(self, f"bn_{r}")(x)
            if r < self.repeat - 1:
                x = torch.relu(x)
        if self.se is not None:
            x = self.se(x, mask)
        if self.res_pw is not None:
            x = x + self.res_bn(self.res_pw(inp * mask))
        return torch.relu(x)


class AttentiveStatsPooling(nn.Module):
    """ECAPA attentive statistics pooling with global context (NeMo
    AttentivePoolLayer): the attention net sees [x ; masked mean ; masked
    std] (3C channels) -> 1x1 conv + ReLU + BN (eps 1e-5) -> tanh -> 1x1
    conv to C; a -inf-masked softmax over time gives per-frame weights;
    returns [weighted mean ; weighted std] with variances clamped at
    1e-10. Statistics and softmax in f32."""

    def __init__(self, channels: int, attention_dim: int, dtype):
        super().__init__()
        self.att1 = Dense(3 * channels, attention_dim, True, dtype)
        self.att_bn = BatchNorm(attention_dim, 1e-5)
        self.att2 = Dense(attention_dim, channels, True, dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x: [B, T, C]; mask: [B, T, 1] -> [B, 2C] f32."""
        xf = x.float()
        m = mask.float()
        w = m / torch.clamp_min(m.sum(dim=1, keepdim=True), 1e-10)
        mean = (w * xf).sum(dim=1, keepdim=True)                # [B,1,C]
        std = torch.sqrt(torch.clamp_min(
            (w * (xf - mean) ** 2).sum(dim=1, keepdim=True), 1e-10))
        gc = torch.cat([x, mean.expand_as(x).to(x.dtype),
                        std.expand_as(x).to(x.dtype)], dim=-1)
        h = torch.tanh(self.att_bn(torch.relu(self.att1(gc))))
        logits = self.att2(h).float()
        logits = torch.where(mask > 0, logits,
                             torch.full_like(logits, -math.inf))
        alpha = torch.softmax(logits, dim=1)
        mu = (alpha * xf).sum(dim=1)
        sg = torch.sqrt(torch.clamp_min(
            (alpha * (xf - mu[:, None]) ** 2).sum(dim=1), 1e-10))
        return torch.cat([mu, sg], dim=-1)


class TitaNet(nn.Module):
    def __init__(self, cfg: TitaNetConfig = TitaNetConfig(),
                 dtype=torch.float32):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.dtype = dtype
        self.prologue = TitaNetBlock(c, c.n_mels, c.prologue_kernel, 1,
                                     False, c.filters, c.prologue_se, dtype)
        for bi, k in enumerate(c.block_kernels):
            self.add_module(f"block_{bi}", TitaNetBlock(
                c, c.filters, k, c.block_repeat, True, c.filters, True,
                dtype))
        # epilogue: one more JasperBlock (kernel 1, 3072 ch, no residual)
        self.epilogue = TitaNetBlock(c, c.filters, 1, 1, False,
                                     c.epilogue_filters, c.epilogue_se,
                                     dtype)
        self.pool = AttentiveStatsPooling(c.epilogue_filters,
                                          c.attention_dim, dtype)
        # SpeakerDecoder bottleneck: Linear (with bias) + BatchNorm1d
        self.emb = Dense(2 * c.epilogue_filters, c.emb_dim, True, dtype)
        self.emb_bn = BatchNorm(c.emb_dim, 1e-5)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "TitaNet":
        """Seeded random weights with flax's initializers: lecun_normal
        (normal truncated at two std, std fan_in**-0.5 / 0.8796) for conv
        and dense kernels, zero biases, identity batch norms."""
        for mod in self.modules():
            if isinstance(mod, (Dense, DepthwiseConv)):
                fan_in = mod.weight.shape[1] if isinstance(mod, Dense) \
                    else mod.weight.shape[0]
                std = fan_in ** -0.5 / 0.87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std,
                                      2 * std, generator=generator)
                if isinstance(mod, Dense) and mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, BatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        return self

    def forward(self, feats: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
        """feats: [B, n_mels, T]; lengths: [B] valid frames ->
        embeddings [B, emb_dim] f32."""
        x = feats.transpose(1, 2)                          # [B, T, n_mels]
        T = x.shape[1]
        mask = (torch.arange(T, device=x.device)[None, :]
                < lengths.to(x.device)[:, None])[..., None].to(x.dtype)
        x = self.prologue(x, mask)
        for bi in range(len(self.cfg.block_kernels)):
            x = getattr(self, f"block_{bi}")(x, mask)
        x = self.epilogue(x, mask)
        stats = self.pool(x, mask)
        return self.emb_bn(self.emb(stats))


def variables_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's flax variables {"params", "batch_stats"} (numpy
    or array-like leaves) -> a TitaNet state_dict (f32): depthwise
    kernels (k, 1, C) -> [k, C]; 1x1 conv kernels (1, in, out) and dense
    kernels (in, out) -> [out, in]; BatchNorm scale/bias -> weight/bias
    and batch_stats mean/var -> running_mean/running_var."""
    sd: Dict[str, torch.Tensor] = {}

    def t(a):
        return torch.tensor(np.asarray(a, dtype=np.float32))

    def walk(tree, path, stats):
        for name, v in tree.items():
            p = path + [name]
            if isinstance(v, dict):
                walk(v, p, stats)
                continue
            a = np.asarray(v, dtype=np.float32)
            prefix = ".".join(path)
            if stats:
                key = {"mean": "running_mean", "var": "running_var"}[name]
                sd[f"{prefix}.{key}"] = t(a)
            elif name == "kernel" and path[-1] == "dw":
                sd[f"{prefix}.weight"] = t(a[:, 0, :])
            elif name == "kernel":
                w = a[0] if a.ndim == 3 else a
                sd[f"{prefix}.weight"] = t(w.T)
            elif name == "scale":
                sd[f"{prefix}.weight"] = t(a)
            else:
                sd[f"{prefix}.{name}"] = t(a)

    walk(dict(variables["params"]), [], stats=False)
    walk(dict(variables.get("batch_stats", {})), [], stats=True)
    return sd


class SpeakerEncoder:
    """A TitaNet on a device with the batched embedding entry points."""

    def __init__(self, cfg: TitaNetConfig = TitaNetConfig(),
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 compute_dtype=torch.float32, device=None, seed: int = 0):
        """state_dict None: seeded random weights, drawn on the CPU from
        torch.Generator().manual_seed(seed) (the same weights on every
        device). compute_dtype bf16 runs the conv/matmul stack in bf16; the
        mel front end and the pooling statistics stay f32."""
        dev = resolve_device(device)
        self.cfg = cfg
        self.module = TitaNet(cfg, dtype=compute_dtype)
        if state_dict is None:
            self.module.init(torch.Generator().manual_seed(seed))
        else:
            self.module.load_state_dict(state_dict)
        self.module.to(dev).eval().requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.module.emb.weight.device

    @staticmethod
    def from_checkpoint(path, cfg: TitaNetConfig = TitaNetConfig(),
                        compute_dtype=torch.float32, device=None):
        """Load from a NeMo .nemo archive or a torch state-dict file."""
        from notsofar_tpu_torch.models.titanet_convert import (
            convert_nemo_titanet, load_nemo_archive)
        if str(path).endswith(".nemo"):
            sd, _ = load_nemo_archive(path)
        else:
            raw = torch.load(path, map_location="cpu", weights_only=False)
            raw = raw.get("state_dict", raw)
            sd = {k: v.detach().cpu().numpy() for k, v in raw.items()}
        return SpeakerEncoder(cfg, convert_nemo_titanet(sd, cfg),
                              compute_dtype=compute_dtype, device=device)

    def _forward(self, wavs: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
        feats = titanet_features(wavs, lengths=lengths)
        return self.module(feats, lengths // HOP + 1)

    @torch.no_grad()
    def embed(self, wavs: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """wavs: [B, T] zero-padded; lengths: [B] valid samples ->
        [B, emb_dim] numpy f32."""
        w = torch.as_tensor(np.asarray(wavs, np.float32), device=self.device)
        ln = torch.as_tensor(np.asarray(lengths, np.int64),
                             device=self.device)
        return self._forward(w, ln).cpu().numpy()

    def _embed_body(self, session_wavs: torch.Tensor, chans: torch.Tensor,
                    starts: torch.Tensor, blen: int,
                    lengths: torch.Tensor) -> torch.Tensor:
        """Gather [B, blen] windows out of the device-resident session bank
        and embed them. session_wavs: [C, L + blen] (zero right-padded so
        a window starting anywhere < L stays inside its row); each start
        is clamped row-locally to W - blen, so a window never reads into
        the next stream. Samples past each window's length are zeroed."""
        W = session_wavs.shape[1]
        s0 = torch.clamp_max(starts, W - blen)
        ar = torch.arange(blen, device=session_wavs.device)
        idx = (chans * W + s0)[:, None] + ar[None, :]
        wavs = session_wavs.reshape(-1)[idx]
        wavs = torch.where(ar[None, :] < lengths[:, None], wavs,
                           torch.zeros((), device=wavs.device))
        return self._forward(wavs, lengths)

    @torch.no_grad()
    def embed_windows(self, session_wavs: torch.Tensor, chans: np.ndarray,
                      starts: np.ndarray, blen: int, lengths: np.ndarray,
                      inner_bs: int = 256) -> torch.Tensor:
        """Embed windows sliced on the device from the session bank, in
        chunks of inner_bs rows (one TitaNet forward each). chans/starts/
        lengths must have a length that is a multiple of inner_bs (callers
        pad with dummy rows). Returns a device tensor [len(chans),
        emb_dim] f32."""
        if len(chans) % inner_bs:
            raise ValueError(f"{len(chans)} windows is not a multiple of "
                             f"inner_bs={inner_bs}")
        dev = session_wavs.device
        ch, s0, ln = (torch.as_tensor(np.asarray(a, np.int64), device=dev)
                      for a in (chans, starts, lengths))
        return torch.cat([
            self._embed_body(session_wavs, ch[i:i + inner_bs],
                             s0[i:i + inner_bs], int(blen),
                             ln[i:i + inner_bs])
            for i in range(0, len(ch), inner_bs)])

    def embed_windows_multi(self, session_wavs: torch.Tensor, specs,
                            inner_bs: int = 256) -> torch.Tensor:
        """Every length bucket's windows: specs is a list of (chans,
        starts, lengths, blen), each a multiple of inner_bs long. Returns
        [sum(len(chans)), emb_dim] in spec order."""
        return torch.cat([self.embed_windows(session_wavs, c, s, b, ln,
                                             inner_bs)
                          for c, s, ln, b in specs])
