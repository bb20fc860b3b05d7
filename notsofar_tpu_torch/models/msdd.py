"""Multi-scale diarization decoder (MSDD) in PyTorch.

Port of notsofar_tpu/models/msdd.py (NeMo's MSDD_module as the
reference's `nmesc_msdd` mode runs it through `diar_msdd_telephonic`):

  inputs   ms_emb_seq  [B, T, K, D]  per-segment embeddings at K scales
           ms_avg_embs [B, K, D, S]  cluster-average embeddings per speaker
  1. conv scale weights: the [cluster-average rows ; segment rows] grid
     (K*(S+1) rows x D) is collapsed by a conv stack into per-step scale
     weights (softmax over the K scales);
  2. scale-weighted cosine similarity between the segment and each
     speaker's cluster average at every scale -> K*S context features;
  3. dist_to_emb projection + a 3-layer bidirectional LSTM over the
     segment sequence;
  4. hidden_to_spks linear + sigmoid -> [B, T, S] speaker activity
     probabilities.

The JAX module's NHWC grid [BT, K(S+1), D, 1] is the NCHW [BT, 1,
K(S+1), D] here, so the convs are ``nn.Conv2d`` with NeMo's own kernel
layout [C, 1, K(S+1), 1] (then [C, 1, C, 1]). The cosine divides by
|a||b| + 1e-6 (not F.cosine_similarity's clamped denominator); the batch
norms have no affine parameters and eps 1e-5. The JAX module's three
flax RNN(OptimizedLSTMCell) pairs (the backward one reversed and kept in
order) are one ``nn.LSTM(num_layers=3, bidirectional=True)``: gates
(i, f, g, o), the cells' biases in bias_hh and bias_ih zero. The convs
and the LSTM run in full f32 on the card (cuDNN's default TF32 off,
utils.device.cudnn_f32).
"""
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from notsofar_tpu_torch.utils.device import cudnn_f32, resolve_device

BN_EPS = 1e-5
GATES = ("i", "f", "g", "o")   # torch's gate order


@dataclass(frozen=True)
class MSDDConfig:
    emb_dim: int = 192
    n_scales: int = 5
    num_spks: int = 2
    hidden: int = 256
    num_lstm_layers: int = 3
    cnn_channels: int = 16
    conv_repeat: int = 1


class MSDD(nn.Module):
    def __init__(self, cfg: MSDDConfig = MSDDConfig()):
        super().__init__()
        c = self.cfg = cfg
        K, S, C, D, H = (c.n_scales, c.num_spks, c.cnn_channels, c.emb_dim,
                         c.hidden)
        for i in range(c.conv_repeat + 1):
            rows = K * (S + 1) if i == 0 else C
            self.add_module(f"conv_{i}", nn.Conv2d(1, C, (rows, 1)))
            self.register_buffer(f"conv_bn_{i}_mean", torch.zeros(D))
            self.register_buffer(f"conv_bn_{i}_var", torch.ones(D))
        self.conv_to_linear = nn.Linear(C * D, H)
        self.linear_to_weights = nn.Linear(H, K)
        self.dist_to_emb = nn.Linear(K * S, H)
        self.lstm = nn.LSTM(H, H, num_layers=c.num_lstm_layers,
                            bidirectional=True, batch_first=True)
        self.hidden_to_spks = nn.Linear(2 * H, S)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "MSDD":
        """Seeded random weights with flax's initializers: lecun_normal
        (normal truncated at two std, std fan_in**-0.5 / 0.8796) for conv,
        dense and the LSTM's input kernels, an orthogonal block per gate
        for its recurrent kernels, zero biases, identity statistics."""
        def lecun(w, fan_in):
            std = fan_in ** -0.5 / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)

        for name, p in self.named_parameters():
            if name.startswith("lstm.weight_hh"):
                H = p.shape[1]
                for g in range(4):
                    q, r = torch.linalg.qr(torch.randn(H, H,
                                                       generator=generator))
                    p[g * H:(g + 1) * H] = q * torch.sign(
                        torch.diagonal(r))[None, :]
            elif name.startswith("lstm.weight_ih"):
                H = p.shape[0] // 4
                for g in range(4):
                    lecun(p[g * H:(g + 1) * H], p.shape[1])
            elif "weight" in name:
                lecun(p, p[0].numel())
            else:
                p.zero_()
        for i in range(self.cfg.conv_repeat + 1):
            getattr(self, f"conv_bn_{i}_mean").zero_()
            getattr(self, f"conv_bn_{i}_var").fill_(1.0)
        return self

    @staticmethod
    def _cos(a, b):
        num = (a * b).sum(-1)
        return num / (torch.linalg.vector_norm(a, dim=-1)
                      * torch.linalg.vector_norm(b, dim=-1) + 1e-6)

    def _conv_bn(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """conv_{i} + ReLU over a [BT, 1, rows, D] grid -> [BT, C, D], then
        the non-affine batch norm over D (NeMo: BatchNorm2d(emb_dim,
        affine=False), eval mode) and a leaky ReLU."""
        with cudnn_f32():
            x = torch.relu(getattr(self, f"conv_{i}")(x))[:, :, 0]
        mean = getattr(self, f"conv_bn_{i}_mean")
        var = getattr(self, f"conv_bn_{i}_var")
        x = (x - mean) * torch.rsqrt(var + BN_EPS)
        return F.leaky_relu(x, 0.01)

    def forward(self, ms_emb_seq: torch.Tensor,
                ms_avg_embs: torch.Tensor) -> torch.Tensor:
        """ms_emb_seq: [B, T, K, D]; ms_avg_embs: [B, K, D, S]
        -> speaker activity probabilities [B, T, S]."""
        c = self.cfg
        B, T, K, D = ms_emb_seq.shape
        S = ms_avg_embs.shape[-1]
        avg = ms_avg_embs.transpose(-1, -2)               # [B, K, S, D]
        # grid rows: per-(scale, speaker) cluster averages, then the K
        # segment embeddings
        grid = torch.cat([avg.reshape(B, 1, K * S, D).expand(B, T, K * S, D),
                          ms_emb_seq], dim=2)             # [B, T, K(S+1), D]
        x = self._conv_bn(0, grid.reshape(B * T, 1, K * (S + 1), D))
        for i in range(1, c.conv_repeat + 1):
            x = self._conv_bn(i, x[:, None])              # [BT, C, D]
        h = F.leaky_relu(self.conv_to_linear(
            x.reshape(B, T, c.cnn_channels * D)), 0.01)
        w = torch.softmax(self.linear_to_weights(h), dim=-1)   # [B, T, K]

        sim = self._cos(ms_emb_seq[:, :, :, None, :],     # [B, T, K, 1, D]
                        avg[:, None])                     # [B, 1, K, S, D]
        ctx = (w[..., None] * sim).reshape(B, T, K * S)   # scale-major
        ctx = torch.relu(self.dist_to_emb(ctx))
        with cudnn_f32():
            h, _ = self.lstm(ctx)                         # [B, T, 2H]
        return torch.sigmoid(self.hidden_to_spks(torch.relu(h)))


def variables_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's MSDD variables {"params", "batch_stats"} (numpy
    leaves; the layout models/msdd_convert.py produces) -> an MSDD
    state_dict (f32): conv kernels (KH, 1, 1, C) -> [C, 1, KH, 1]; dense
    kernels (in, out) -> [out, in]; each LSTM cell's per-gate kernels
    stacked in (i, f, g, o) order into weight_ih / weight_hh, its hidden
    biases into bias_hh and bias_ih zero (the inverse of msdd_convert's
    folding)."""
    p, bs = variables["params"], variables.get("batch_stats", {})

    def t(a):
        return torch.tensor(np.ascontiguousarray(np.asarray(a, np.float32)))

    sd: Dict[str, torch.Tensor] = {}
    for name, stats in bs.items():
        i, which = name[len("conv_bn_"):].split("_")
        sd[f"conv_bn_{i}_{which}"] = t(stats)
    layers = sorted({int(k[len("lstm_l"):].split("_")[0]) for k in p
                     if k.startswith("lstm_l")})
    for name, leaves in p.items():
        if name.startswith("lstm_l"):
            continue
        k = np.asarray(leaves["kernel"], np.float32)
        sd[f"{name}.weight"] = t(k.transpose(3, 2, 0, 1) if k.ndim == 4
                                 else k.T)
        sd[f"{name}.bias"] = t(leaves["bias"])
    for layer in layers:
        for d, sfx in (("fw", ""), ("bw", "_reverse")):
            cell = p[f"lstm_l{layer}_{d}"]
            sd[f"lstm.weight_ih_l{layer}{sfx}"] = t(np.concatenate(
                [np.asarray(cell[f"i{g}"]["kernel"]).T for g in GATES]))
            sd[f"lstm.weight_hh_l{layer}{sfx}"] = t(np.concatenate(
                [np.asarray(cell[f"h{g}"]["kernel"]).T for g in GATES]))
            bias = np.concatenate([np.asarray(cell[f"h{g}"]["bias"])
                                   for g in GATES])
            sd[f"lstm.bias_hh_l{layer}{sfx}"] = t(bias)
            sd[f"lstm.bias_ih_l{layer}{sfx}"] = t(np.zeros_like(bias))
    return sd


class OverlapDecoder:
    """An MSDD on a device exposing a batched refinement call."""

    def __init__(self, cfg: MSDDConfig = MSDDConfig(),
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 device=None, seed: int = 0):
        """state_dict None: seeded random weights, drawn on the CPU from
        torch.Generator().manual_seed(seed)."""
        dev = resolve_device(device)
        self.cfg = cfg
        self.module = MSDD(cfg)
        if state_dict is None:
            self.module.init(torch.Generator().manual_seed(seed))
        else:
            self.module.load_state_dict(state_dict)
        self.module.to(dev).eval().requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.module.hidden_to_spks.weight.device

    @classmethod
    def from_checkpoint(cls, path, device=None) -> "OverlapDecoder":
        """Load a NeMo MSDD .nemo archive (diar_msdd_telephonic layout)."""
        from notsofar_tpu_torch.models.msdd_convert import \
            load_msdd_checkpoint
        cfg, variables = load_msdd_checkpoint(path)
        return cls(cfg, variables_from_jax(variables), device=device)

    @torch.no_grad()
    def refine(self, ms_emb_seq: np.ndarray,
               ms_avg_embs: np.ndarray) -> np.ndarray:
        """[B, T, K, D], [B, K, D, S] -> [B, T, S] activity probs."""
        e = torch.as_tensor(np.asarray(ms_emb_seq, np.float32),
                            device=self.device)
        a = torch.as_tensor(np.asarray(ms_avg_embs, np.float32),
                            device=self.device)
        return self.module(e, a).cpu().numpy()
