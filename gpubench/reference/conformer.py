"""Plain float32 multichannel CSS Conformer and its training step, written
from the NOTSOFAR-1 baseline's description (conformer_v1.0_mc), for the
benchmark's output check.

It imports nothing of the measured program; the weights are the
benchmark's own (``param_specs`` lists their names and shapes), the data
is read from the benchmark's partition files. Every matmul runs in
float32 with TF32 off.

* ``stft``: a 512-sample periodic-Hann frame every 256 samples, no
  padding, 257 bins, as the baseline's DFT-kernel convolution;
* ``features``: the reference mic's magnitude normalised over time (mean
  and unbiased std), and six inter-mic phase differences (mics 1-6
  against mic 0), each mean-normalised as atan2(sin - mean, cos - mean):
  1799 features a frame;
* ``masks``: the Conformer (input Linear, LayerNorm, ReLU; per block a
  half-step FFN, relative-position self-attention, the convolution
  module: LayerNorm, a GLU of two scalar taps, a depthwise convolution,
  batch norm on the batch's statistics, ReLU, a scalar tap; a second
  half-step FFN and a LayerNorm), a Linear to 4 x 257 and a sigmoid;
* ``loss``: the 'mask' loss on 'l1': permutation-invariant over the three
  speakers' ideal ratio masks, plus the noise mask's;
* ``train``: the recipe's steps (mic rotation, loss, backward, global-norm
  clip, torch.optim.AdamW) from given weights over given batches.
"""
import itertools
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

EPS = float(np.finfo(np.float32).eps)


def param_specs(c: Dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor of the model. kind: 'matrix'
    (fan-in scaled normal), 'bias', 'ln_w', 'ln_b', 'pos' and 'tap'
    (unit normal), 'zeros', 'ones' (buffers)."""
    d, h, u, k = c["attention_dim"], c["attention_heads"], \
        c["linear_units"], c["kernel_size"]
    nb = c["num_bins"] * (c["num_spks"] + c["num_nois"])
    out = [("input_bias", (c["in_features"],), "zeros"),
           ("input_scale", (c["in_features"],), "ones"),
           ("encoder.pos_emb", (2 * c["pos_maxlen"], d // h), "pos"),
           ("encoder.embed.weight", (d, c["in_features"]), "matrix"),
           ("encoder.embed.bias", (d,), "bias"),
           ("encoder.embed_ln.weight", (d,), "ln_w"),
           ("encoder.embed_ln.bias", (d,), "ln_b")]
    for i in range(c["num_blocks"]):
        p = f"encoder.layer_{i}"
        for ffn in ("ffn_in", "ffn_out"):
            out += [(f"{p}.{ffn}.ln.weight", (d,), "ln_w"),
                    (f"{p}.{ffn}.ln.bias", (d,), "ln_b"),
                    (f"{p}.{ffn}.w1.weight", (u, d), "matrix"),
                    (f"{p}.{ffn}.w1.bias", (u,), "bias"),
                    (f"{p}.{ffn}.w2.weight", (d, u), "matrix"),
                    (f"{p}.{ffn}.w2.bias", (d,), "bias")]
        out += [(f"{p}.attn.ln.weight", (d,), "ln_w"),
                (f"{p}.attn.ln.bias", (d,), "ln_b")]
        for m in ("q", "k", "v", "out"):
            out += [(f"{p}.attn.{m}.weight", (d, d), "matrix"),
                    (f"{p}.attn.{m}.bias", (d,), "bias")]
        out += [(f"{p}.conv.pw1_w", (2,), "tap"),
                (f"{p}.conv.pw1_b", (2,), "bias"),
                (f"{p}.conv.pw2_w", (1,), "tap"),
                (f"{p}.conv.pw2_b", (1,), "bias"),
                (f"{p}.conv.ln.weight", (d,), "ln_w"),
                (f"{p}.conv.ln.bias", (d,), "ln_b"),
                (f"{p}.conv.dw.weight", (d, 1, k), "matrix"),
                (f"{p}.conv.dw.bias", (d,), "bias"),
                (f"{p}.conv.bn.weight", (d,), "ln_w"),
                (f"{p}.conv.bn.bias", (d,), "ln_b"),
                (f"{p}.conv.bn.running_mean", (d,), "zeros"),
                (f"{p}.conv.bn.running_var", (d,), "ones"),
                (f"{p}.ln_out.weight", (d,), "ln_w"),
                (f"{p}.ln_out.bias", (d,), "ln_b")]
    out += [("mask_head.weight", (nb, d), "matrix"),
            ("mask_head.bias", (nb,), "bias")]
    return out


TRAINED = ("matrix", "bias", "ln_w", "ln_b", "pos", "tap")


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------

def dft_kernel(frame: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """The baseline's convolutional STFT kernel: Hann-windowed
    cos(2 pi f n / N) and -sin(2 pi f n / N) evaluated in float64 and
    stored as float32, [257, 512] each. Its imaginary rows at DC and
    Nyquist are zero or the float64 sine's round-off, which fixes the
    phase that the inter-mic features see there."""
    n = np.arange(frame, dtype=np.float64)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / frame))
    ph = 2.0 * np.pi * np.outer(np.arange(frame // 2 + 1), n) / frame
    return (np.cos(ph) * w).astype(np.float32), \
        (-np.sin(ph) * w).astype(np.float32)


def stft(x: torch.Tensor, frame: int = 512, hop: int = 256) -> torch.Tensor:
    """x [..., S] -> complex [..., 257, T]: frames every `hop` samples, no
    padding, the DFT kernel times the frames. The product is laid out as
    kernel [257, N] @ frames [..., N, T] over contiguous frames, the
    baseline's orientation: a raw inter-mic phase flips by 2 pi where its
    round-off crosses the branch cut, so the reference sums in the order
    of the model it checks, and the two round alike there."""
    kr, ki = (torch.from_numpy(k).to(x.device) for k in dft_kernel(frame))
    frames = x.float().unfold(-1, frame, hop).contiguous()   # [..., T, N]
    ft = frames.transpose(-1, -2)
    return torch.complex(torch.matmul(kr, ft), torch.matmul(ki, ft))


def features(mix: torch.Tensor) -> torch.Tensor:
    """mix [B, S, 7] -> [B, 1799, T]."""
    spec = stft(mix.transpose(1, 2))                       # [B, 7, F, T]
    mag = spec[:, 0].abs().clamp_min(EPS)
    mean = mag.mean(-1, keepdim=True)
    std = mag.std(-1, keepdim=True)
    feat = [(mag - mean) / (std + EPS)]
    pha = spec.angle()
    dif = pha[:, 1:] - pha[:, :1]                          # [B, 6, F, T]
    c, s = torch.cos(dif), torch.sin(dif)
    ipd = torch.atan2(s - s.mean(-1, keepdim=True),
                      c - c.mean(-1, keepdim=True))
    B, M, Fq, T = ipd.shape
    feat.append(ipd.reshape(B, M * Fq, T))
    return torch.cat(feat, dim=1)


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

def _ln(x, p, name):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"],
                        p[f"{name}.bias"], 1e-5)


def _lin(x, p, name):
    return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def _ffn(x, p, name):
    return _lin(torch.relu(_lin(_ln(x, p, f"{name}.ln"), p, f"{name}.w1")),
                p, f"{name}.w2")


def _attention(x, p, name, heads, pos_k):
    B, T, D = x.shape
    dk = D // heads
    y = _ln(x, p, f"{name}.ln")
    q, k, v = (_lin(y, p, f"{name}.{m}").view(B, T, heads, dk)
               .transpose(1, 2) for m in ("q", "k", "v"))
    scores = q @ k.transpose(-1, -2) + \
        torch.einsum("bhtd,tsd->bhts", q, pos_k)
    att = torch.softmax(scores / math.sqrt(dk), dim=-1)
    out = (att @ v).transpose(1, 2).reshape(B, T, D)
    return _lin(out, p, f"{name}.out")


def _conv(x, p, name, kernel):
    y = _ln(x, p, f"{name}.ln")
    w, b = p[f"{name}.pw1_w"], p[f"{name}.pw1_b"]
    y = (y * w[0] + b[0]) * torch.sigmoid(y * w[1] + b[1])
    y = F.conv1d(y.transpose(1, 2), p[f"{name}.dw.weight"],
                 p[f"{name}.dw.bias"], padding=(kernel - 1) // 2,
                 groups=y.shape[-1]).transpose(1, 2)
    flat = y.reshape(-1, y.shape[-1])
    mean = flat.mean(0)
    var = flat.var(0, unbiased=False)
    y = (y - mean) * torch.rsqrt(var + 1e-5) * p[f"{name}.bn.weight"] + \
        p[f"{name}.bn.bias"]
    return torch.relu(y) * p[f"{name}.pw2_w"][0] + p[f"{name}.pw2_b"][0]


def _block(x, p, i, c, pos_k):
    n = f"encoder.layer_{i}"
    x = x + 0.5 * _ffn(x, p, f"{n}.ffn_in")
    x = x + _attention(x, p, f"{n}.attn", c["attention_heads"], pos_k)
    x = x + _conv(x, p, f"{n}.conv", c["kernel_size"])
    x = x + 0.5 * _ffn(x, p, f"{n}.ffn_out")
    return _ln(x, p, f"{n}.ln_out")


def masks(p: Dict[str, torch.Tensor], c: Dict, feat: torch.Tensor
          ) -> torch.Tensor:
    """feat [B, 1799, T] -> masks [B, F, T, speakers + noises]; each block
    recomputed in the backward pass (torch.utils.checkpoint) so that a
    whole batch fits."""
    x = (feat.transpose(1, 2) + p["input_bias"]) * p["input_scale"]
    x = torch.relu(_ln(_lin(x, p, "encoder.embed"), p, "encoder.embed_ln"))
    T = x.shape[1]
    ar = torch.arange(T, device=x.device)
    L = c["pos_maxlen"]
    pos_k = p["encoder.pos_emb"][torch.clamp(ar[:, None] - ar[None, :], -L,
                                             L - 1) + L]
    for i in range(c["num_blocks"]):
        x = checkpoint(_block, x, p, i, c, pos_k, use_reentrant=False)
    m = torch.sigmoid(_lin(x, p, "mask_head"))
    B = m.shape[0]
    S = c["num_spks"] + c["num_nois"]
    return m.view(B, T, S, c["num_bins"]).permute(0, 3, 1, 2)


def loss(p: Dict[str, torch.Tensor], c: Dict, batch: Dict) -> torch.Tensor:
    """The 'mask' loss on 'l1' over the batch's mean."""
    m = masks(p, c, features(batch["mixture"]))
    mix = stft(batch["mixture"][:, :, 0]).abs()[..., None]      # [B,F,T,1]
    gt = stft(batch["gt_spk_direct_early_echoes"][:, :, 0]
              .transpose(1, 2)).abs().movedim(1, -1)            # [B,F,T,S]
    noise = stft(batch["gt_noise"][:, :, 0]).abs()
    ns = c["num_spks"]
    pred, target = m[..., :ns], gt / (mix + EPS)
    pair = (pred[..., :, None] - target[..., None, :]).abs().mean(dim=(1, 2))
    perms = torch.tensor(list(itertools.permutations(range(ns))),
                         device=pred.device)
    per = pair[:, torch.arange(ns, device=pred.device)[None, :], perms]
    spk = per.mean(-1).min(-1).values                            # [B]
    nl = (m[..., ns] - noise / (mix[..., 0] + EPS)).abs().mean(dim=(1, 2))
    return (spk + nl).mean()


def rotate_mics(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Rotate mics 1-6 of x [B, S, 7(, K)] by shifts [B]: out mic 1 + m is
    in mic 1 + (m - shift) % 6."""
    M = 6
    idx = (torch.arange(M, device=x.device)[None] - shifts[:, None]) % M
    ring = x[:, :, 1:]
    rolled = torch.stack([ring[b][:, idx[b]] for b in range(x.shape[0])])
    return torch.cat([x[:, :, :1], rolled], dim=2)


def train(sd: Dict[str, torch.Tensor], c: Dict, batches: Sequence[Dict],
          shifts: Sequence[torch.Tensor], lr: float, weight_decay: float,
          clip: float) -> Dict:
    """The recipe's steps from weights sd over the batches, in float32
    with TF32 off. Returns the losses, each leaf's first gradient before
    and after the clip (its norm), and each leaf's change after the last
    step (its norm)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        kinds = {n: k for n, _, k in param_specs(c)}
        p = {n: t.detach().float().clone().requires_grad_(kinds[n] in TRAINED)
             for n, t in sd.items()}
        trained = [n for n in p if p[n].requires_grad]
        opt = torch.optim.AdamW([p[n] for n in trained], lr=lr,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
        start = {n: p[n].detach().clone() for n in trained}
        losses, raw, clipped = [], {}, {}
        dev = next(iter(sd.values())).device
        for i, (batch, s) in enumerate(zip(batches, shifts)):
            b = {k: rotate_mics(v.to(dev), s.to(dev))
                 for k, v in batch.items()}
            opt.zero_grad(set_to_none=True)
            value = loss(p, c, b)
            value.backward()
            grads = [p[n].grad for n in trained]
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            if i == 0:
                raw = {n: float(torch.linalg.vector_norm(p[n].grad))
                       for n in trained}
            if norm >= clip:
                for g in grads:
                    g.mul_(clip / norm)
            if i == 0:
                clipped = {n: float(torch.linalg.vector_norm(p[n].grad))
                           for n in trained}
            opt.step()
            losses.append(float(value.detach()))
        change = {n: float(torch.linalg.vector_norm(p[n].detach() - start[n]))
                  for n in trained}
        return dict(losses=losses, grad_raw=raw, grad=clipped, change=change)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
