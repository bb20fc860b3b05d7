"""MarbleNet frame-level voice activity detection in PyTorch.

Port of notsofar_tpu/models/marblenet.py (NeMo's
`vad_multilingual_marblenet`, which the reference's time-based
diarization recipe runs): a QuartzNet-style stack of time-channel
separable 1D convolutions over log-mel features,

  prologue  128ch k=11 x1          separable, no residual
  3 blocks   64ch k=13/15/17 x2    separable, residual
  epilogue  128ch k=29 dil=2 x1    separable, no residual
  epilogue  128ch k=1  x1          plain conv, no residual
  decoder   linear -> 2 classes (speech / non-speech)

and, as in the JAX package, the classifier applied per frame on the
encoder output of the whole waveform (one forward per stream at the
10 ms hop) instead of NeMo's 0.63 s sliding windows.

Activations are [B, T, C]. Each repeat masks its input before its conv;
the residual 1x1 conv reads the block's unmasked input (the JAX module's
order). Batch norms are eval-mode with eps 1e-3. The depthwise convs are
grouped ``F.conv1d`` calls (the JAX module's nn.Conv, outside Pallas),
run in full f32 on the card (cuDNN's default TF32 off, utils.device.
cudnn_f32); pointwise convs and the classifier are matmuls
(models.titanet.Dense).
Models live on an explicit device (default ``cuda``, raising without a
card; ``device="cpu"`` runs on the CPU).
"""
import re
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from notsofar_tpu_torch.models.titanet import (HOP, BatchNorm, Dense,
                                               titanet_features)
from notsofar_tpu_torch.utils.device import cudnn_f32, resolve_device
from notsofar_tpu_torch.utils.logging_def import get_logger

_LOG = get_logger("marblenet")


class BlockSpec(NamedTuple):
    filters: int
    repeat: int
    kernel: int
    dilation: int
    residual: bool
    separable: bool


DEFAULT_BLOCKS: Tuple[BlockSpec, ...] = (
    BlockSpec(128, 1, 11, 1, False, True),
    BlockSpec(64, 2, 13, 1, True, True),
    BlockSpec(64, 2, 15, 1, True, True),
    BlockSpec(64, 2, 17, 1, True, True),
    BlockSpec(128, 1, 29, 2, False, True),
    BlockSpec(128, 1, 1, 1, False, False),
)


@dataclass(frozen=True)
class MarbleNetConfig:
    n_mels: int = 80
    blocks: Tuple[BlockSpec, ...] = DEFAULT_BLOCKS
    num_classes: int = 2


class Conv1d(nn.Module):
    """A 'same'-padded conv over time on [B, T, C]: weight [C_out,
    C_in / groups, k] (torch's layout), no bias; depthwise when groups =
    C_in."""

    def __init__(self, c_in: int, c_out: int, kernel: int, dilation: int,
                 groups: int, dtype):
        super().__init__()
        self.dilation = dilation
        self.groups = groups
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(c_out, c_in // groups,
                                               kernel))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.dilation * (self.weight.shape[-1] - 1) // 2
        with cudnn_f32():
            y = F.conv1d(x.to(self.dtype).transpose(1, 2),
                         self.weight.to(self.dtype), padding=pad,
                         dilation=self.dilation, groups=self.groups)
        return y.transpose(1, 2)


class MarbleBlock(nn.Module):
    """One Jasper-style block: repeat x (conv -> BN -> ReLU), optional
    pointwise residual. Submodule names follow the JAX module's
    (conv_{r}_dw, conv_{r}_pw or conv_{r}_full, bn_{r}, res_pw, res_bn)."""

    def __init__(self, spec: BlockSpec, c_in: int, dtype=torch.float32):
        super().__init__()
        b = self.spec = spec
        for r in range(b.repeat):
            ci = c_in if r == 0 else b.filters
            if b.separable:
                self.add_module(f"conv_{r}_dw", Conv1d(
                    ci, ci, b.kernel, b.dilation, ci, dtype))
                self.add_module(f"conv_{r}_pw",
                                Dense(ci, b.filters, False, dtype))
            else:
                self.add_module(f"conv_{r}_full", Conv1d(
                    ci, b.filters, b.kernel, b.dilation, 1, dtype))
            self.add_module(f"bn_{r}", BatchNorm(b.filters, 1e-3))
        if b.residual:
            self.res_pw = Dense(c_in, b.filters, False, dtype)
            self.res_bn = BatchNorm(b.filters, 1e-3)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b = self.spec
        inp = x
        for r in range(b.repeat):
            h = x * mask
            if b.separable:
                h = getattr(self, f"conv_{r}_pw")(
                    getattr(self, f"conv_{r}_dw")(h))
            else:
                h = getattr(self, f"conv_{r}_full")(h)
            h = getattr(self, f"bn_{r}")(h)
            if r < b.repeat - 1:
                h = torch.relu(h)
            x = h
        if b.residual:
            x = x + self.res_bn(self.res_pw(inp))
        return torch.relu(x)


class MarbleNet(nn.Module):
    def __init__(self, cfg: MarbleNetConfig = MarbleNetConfig(),
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        c_in = cfg.n_mels
        for bi, spec in enumerate(cfg.blocks):
            self.add_module(f"block_{bi}", MarbleBlock(spec, c_in, dtype))
            c_in = spec.filters
        self.classifier = Dense(c_in, cfg.num_classes, True, dtype)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "MarbleNet":
        """Seeded random weights with flax's initializers: lecun_normal
        (normal truncated at two std, std fan_in**-0.5 / 0.8796) for conv
        and dense kernels (fan_in = input channels per group x taps),
        zero biases, identity batch norms."""
        for mod in self.modules():
            if isinstance(mod, (Dense, Conv1d)):
                w = mod.weight
                fan_in = w.shape[1] * (w.shape[2] if w.ndim == 3 else 1)
                std = fan_in ** -0.5 / 0.87962566103423978
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
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
        """feats: [B, n_mels, T]; lengths: [B] valid frames. Returns
        per-frame class logits [B, T, num_classes]."""
        x = feats.transpose(1, 2)
        T = x.shape[1]
        mask = (torch.arange(T, device=x.device)[None, :]
                < lengths.to(x.device)[:, None])[..., None].to(x.dtype)
        for bi in range(len(self.cfg.blocks)):
            x = getattr(self, f"block_{bi}")(x, mask)
        return self.classifier(x)


def variables_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's MarbleNet variables {"params", "batch_stats"}
    (numpy or array-like leaves) -> a MarbleNet state_dict (f32):
    depthwise kernels (k, 1, C) and full conv kernels (k, C_in, C_out) ->
    [C_out, C_in / groups, k]; pointwise kernels (1, C, C2) and dense
    kernels (in, out) -> [out, in]; BatchNorm scale -> weight and
    batch_stats mean/var -> running_mean/running_var."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree, path, stats):
        for name, v in tree.items():
            if hasattr(v, "items"):
                walk(v, path + [name], stats)
                continue
            a = np.asarray(v, dtype=np.float32)
            prefix = ".".join(path)
            if stats:
                name = {"mean": "running_mean", "var": "running_var"}[name]
            elif name == "kernel" and path[-1].endswith(("_dw", "_full")):
                name, a = "weight", a.transpose(2, 1, 0)
            elif name == "kernel":
                name, a = "weight", (a[0] if a.ndim == 3 else a).T
            elif name == "scale":
                name = "weight"
            sd[f"{prefix}.{name}"] = torch.tensor(np.ascontiguousarray(a))

    walk(variables["params"], [], stats=False)
    walk(variables.get("batch_stats", {}), [], stats=True)
    return sd


# ---------------------------------------------------------------------------
# NeMo checkpoint conversion (shape-driven, as titanet_convert)
# ---------------------------------------------------------------------------

def blocks_from_nemo_config(cfg_yaml: dict) -> Tuple[BlockSpec, ...]:
    """Build BlockSpecs from a NeMo model_config.yaml 'jasper' block list."""
    enc = cfg_yaml.get("encoder", {})
    jasper = enc.get("jasper") or enc.get("params", {}).get("jasper")
    if not jasper:
        raise ValueError("no encoder.jasper block list in NeMo config")

    def one(v):
        return v[0] if isinstance(v, (list, tuple)) else v

    return tuple(BlockSpec(int(j["filters"]), int(j.get("repeat", 1)),
                           int(one(j["kernel"])),
                           int(one(j.get("dilation", 1))),
                           bool(j.get("residual", False)),
                           bool(j.get("separable", False)))
                 for j in jasper)


def convert_nemo_marblenet(sd: Dict[str, np.ndarray],
                           cfg: MarbleNetConfig) -> Dict:
    """NeMo EncDecClassificationModel state dict -> the JAX package's
    flax-layout variables (variables_from_jax turns them into the port's
    state_dict), by the JAX converter's rules.

    Shape-driven within each encoder block: depthwise [C,1,k], pointwise
    [C2,C,1] (or full conv when the block is non-separable), batch-norms by
    their running stats, residual branches by '.res' in the key. The
    classifier is the 2-class linear of ConvASRDecoderClassification."""
    from notsofar_tpu_torch.models.titanet_convert import _dw, _pw, _t_lin

    raw_blocks: Dict[int, Dict[str, np.ndarray]] = defaultdict(dict)
    for k, v in sd.items():
        m = re.match(r"encoder\.encoder\.(\d+)\.(.+)", k)
        if m:
            raw_blocks[int(m.group(1))][m.group(2)] = np.asarray(v)
    if len(raw_blocks) != len(cfg.blocks):
        raise ValueError(f"checkpoint has {len(raw_blocks)} encoder blocks, "
                         f"config expects {len(cfg.blocks)}")

    params: Dict = {}
    stats: Dict = {}
    for bi, spec in enumerate(cfg.blocks):
        raw = raw_blocks[bi]
        conv3d = []
        res_pw = None
        res_bn: Dict[str, np.ndarray] = {}
        bn_parts: Dict[str, list] = defaultdict(list)
        for k in sorted(raw):
            v = raw[k]
            is_res = ".res" in k or k.startswith("res")
            if v.ndim == 3:
                if is_res:
                    res_pw = _pw(v)
                else:
                    conv3d.append(v)
                continue
            part = ("mean" if k.endswith("running_mean") else
                    "var" if k.endswith("running_var") else
                    "scale" if k.endswith(".weight") and v.ndim == 1 else
                    "bias" if k.endswith(".bias") and v.ndim == 1 else None)
            if part is None:
                continue
            if is_res:
                res_bn[part] = v
            else:
                bn_parts[part].append(v)
        bp: Dict = {}
        bs: Dict = {}
        ci = 0
        for r in range(spec.repeat):
            if spec.separable:
                dw_w, pw_w = conv3d[ci], conv3d[ci + 1]
                if dw_w.shape[1] != 1:  # order not guaranteed by key sort
                    dw_w, pw_w = pw_w, dw_w
                if not (dw_w.shape[1] == 1 and pw_w.shape[2] == 1):
                    raise ValueError(
                        f"block {bi} rep {r}: not separable-shaped "
                        f"({dw_w.shape}, {pw_w.shape})")
                bp[f"conv_{r}_dw"] = {"kernel": _dw(dw_w)}
                bp[f"conv_{r}_pw"] = {"kernel": _pw(pw_w)}
                ci += 2
            else:
                w = conv3d[ci]  # [C_out, C_in, k]
                bp[f"conv_{r}_full"] = {
                    "kernel": np.ascontiguousarray(w.transpose(2, 1, 0))}
                ci += 1
            bp[f"bn_{r}"] = {"scale": bn_parts["scale"][r],
                             "bias": bn_parts["bias"][r]}
            bs[f"bn_{r}"] = {"mean": bn_parts["mean"][r],
                             "var": bn_parts["var"][r]}
        if ci != len(conv3d):
            raise ValueError(f"block {bi}: {len(conv3d) - ci} unconsumed "
                             "conv weights")
        if spec.residual:
            if res_pw is None:
                raise ValueError(f"block {bi}: residual conv missing")
            bp["res_pw"] = {"kernel": res_pw}
            bp["res_bn"] = {"scale": res_bn["scale"], "bias": res_bn["bias"]}
            bs["res_bn"] = {"mean": res_bn["mean"], "var": res_bn["var"]}
        params[f"block_{bi}"] = bp
        if bs:
            stats[f"block_{bi}"] = bs

    lin = sorted((k, np.asarray(v)) for k, v in sd.items()
                 if k.startswith("decoder") and np.asarray(v).ndim == 2
                 and np.asarray(v).shape[0] == cfg.num_classes)
    if not lin:
        raise ValueError("classifier linear not found in decoder keys")
    w = lin[0][1]
    bias_key = lin[0][0].rsplit(".", 1)[0] + ".bias"
    params["classifier"] = {
        "kernel": _t_lin(w),
        "bias": np.asarray(sd.get(bias_key,
                                  np.zeros(cfg.num_classes, np.float32)))}
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# Frame-VAD entry point (vad_fn-compatible: (wav, sr) -> bool mask @ 10 ms)
# ---------------------------------------------------------------------------

class FrameVAD:
    """A MarbleNet on a device, exposing the diarizer's vad_fn interface
    at 10 ms frames."""

    @staticmethod
    def from_checkpoint(path, cfg: Optional[MarbleNetConfig] = None,
                        threshold: float = 0.5, device=None) -> "FrameVAD":
        """Load from a NeMo .nemo archive (topology from its yaml) or a
        torch state-dict file."""
        from notsofar_tpu_torch.models.titanet_convert import \
            load_nemo_archive
        if str(path).endswith(".nemo"):
            sd, cfg_yaml = load_nemo_archive(path)
            if cfg is None:
                try:
                    blocks = blocks_from_nemo_config(cfg_yaml)
                    n_mels = int(cfg_yaml.get("preprocessor", {})
                                 .get("features", 80))
                    cfg = MarbleNetConfig(n_mels=n_mels, blocks=blocks)
                except (ValueError, KeyError) as e:
                    _LOG.warning(f"could not parse NeMo config ({e}); "
                                 "using default MarbleNet topology")
                    cfg = MarbleNetConfig()
        else:
            raw = torch.load(path, map_location="cpu", weights_only=False)
            raw = raw.get("state_dict", raw)
            sd = {k: v.detach().cpu().numpy() for k, v in raw.items()}
            cfg = cfg or MarbleNetConfig()
        state = variables_from_jax(convert_nemo_marblenet(sd, cfg))
        return FrameVAD(cfg, state, threshold=threshold, device=device)

    def __init__(self, cfg: Optional[MarbleNetConfig] = None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 threshold: float = 0.5, device=None, seed: int = 0):
        """state_dict None: seeded random weights, drawn on the CPU from
        torch.Generator().manual_seed(seed)."""
        dev = resolve_device(device)
        self.cfg = cfg or MarbleNetConfig()
        self.threshold = threshold
        self.module = MarbleNet(self.cfg)
        if state_dict is None:
            self.module.init(torch.Generator().manual_seed(seed))
        else:
            self.module.load_state_dict(state_dict)
        self.module.to(dev).eval().requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.module.classifier.weight.device

    @torch.no_grad()
    def frame_probs(self, wavs: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """wavs: [B, T] zero-padded 16 kHz; lengths: [B] valid samples ->
        [B, frames] speech probabilities at 10 ms (the softmax's class
        1). The features are normalized over each whole row, as in the
        JAX package."""
        w = torch.as_tensor(np.asarray(wavs, np.float32), device=self.device)
        ln = torch.as_tensor(np.asarray(lengths, np.int64),
                             device=self.device)
        feats = titanet_features(w, n_mels=self.cfg.n_mels)
        logits = self.module(feats, ln // HOP + 1)
        return torch.softmax(logits.float(), dim=-1)[..., 1].cpu().numpy()

    def __call__(self, wav: np.ndarray, sr: int) -> np.ndarray:
        """vad_fn interface: 1-D waveform -> boolean speech mask @ 10 ms."""
        if sr != 16000:
            raise ValueError("resample to 16 kHz before VAD")
        wav = np.asarray(wav, np.float32)[None]
        probs = self.frame_probs(wav, np.asarray([wav.shape[1]]))[0]
        n = wav.shape[1] // HOP  # match energy_vad's frame count
        return probs[:n] > self.threshold
