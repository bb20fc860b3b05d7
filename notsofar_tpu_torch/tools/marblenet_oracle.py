"""Independent PyTorch MarbleNet forward with NeMo's eval-mode semantics.

Copy of tools/torch_marblenet_oracle.py's ``torch_frame_logits`` (its JAX
self-test left out): the published QuartzNet/MarbleNet time-channel-
separable forward written directly with torch.nn.functional, reading the
NeMo-layout state dict that models.marblenet.convert_nemo_marblenet reads.
It shares no code with models/marblenet.py, so the real-weight validator
holds the port's FrameVAD to it on a checkpoint's own weights.

    torch_frame_logits(sd, cfg, feats, lengths) -> [B, T, num_classes]

NeMo semantics encoded here:
  - MaskedConv1d zero-masks its input past the valid length before EVERY
    conv (depthwise, pointwise, and the 1x1 residual conv);
  - JasperBlock: repeat x (dw-conv, pw-conv, BN eps 1e-3), ReLU between
    repeats; residual = pointwise conv + BN added before the final ReLU;
  - symmetric 'same' padding dilation*(kernel-1)//2, stride 1 throughout
    (every MarbleNet block);
  - the classifier linear applied PER FRAME on the encoder output (the
    port's FrameVAD does the same in place of NeMo's sliding-window
    segments).

It runs on the CPU in float32 (its tensors are made there).
"""
import re
from collections import defaultdict
from typing import Dict

import numpy as np


def torch_frame_logits(sd: Dict[str, np.ndarray], cfg, feats: np.ndarray,
                       lengths: np.ndarray) -> np.ndarray:
    """Eval-mode MarbleNet frame logits in torch from a NeMo-layout state
    dict. feats: [B, n_mels, T]; lengths: [B] valid frames."""
    import torch
    import torch.nn.functional as F

    t = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32)
         for k, v in sd.items()}
    x = torch.as_tensor(np.asarray(feats), dtype=torch.float32)  # [B, C, T]
    lengths = torch.as_tensor(np.asarray(lengths), dtype=torch.int64)
    B, _, T = x.shape
    mask = (torch.arange(T)[None, :] < lengths[:, None]).float()[:, None]

    def bn(x, stats, eps=1e-3):
        shape = (1, -1, 1)
        y = (x - stats["mean"].view(shape)) \
            / torch.sqrt(stats["var"].view(shape) + eps)
        return y * stats["scale"].view(shape) + stats["bias"].view(shape)

    # shape-driven parse, same discipline as convert_nemo_marblenet: sorted
    # keys per block, conv weights by ndim, res branch by '.res'/'res' key
    raw_blocks: Dict[int, Dict[str, np.ndarray]] = defaultdict(dict)
    for k, v in sd.items():
        m = re.match(r"encoder\.encoder\.(\d+)\.(.+)", k)
        if m:
            raw_blocks[int(m.group(1))][m.group(2)] = np.asarray(v)

    for bi, spec in enumerate(cfg.blocks):
        raw = raw_blocks[bi]
        conv3d, res_pw = [], None
        bn_parts: Dict[str, list] = defaultdict(list)
        res_bn: Dict[str, "torch.Tensor"] = {}
        for k in sorted(raw):
            v = torch.as_tensor(raw[k], dtype=torch.float32)
            is_res = ".res" in k or k.startswith("res")
            if v.dim() == 3:
                if is_res:
                    res_pw = v
                else:
                    conv3d.append(v)
            elif k.endswith("running_mean"):
                (res_bn.__setitem__("mean", v) if is_res
                 else bn_parts["mean"].append(v))
            elif k.endswith("running_var"):
                (res_bn.__setitem__("var", v) if is_res
                 else bn_parts["var"].append(v))
            elif k.endswith(".weight") and v.dim() == 1:
                (res_bn.__setitem__("scale", v) if is_res
                 else bn_parts["scale"].append(v))
            elif k.endswith(".bias") and v.dim() == 1:
                (res_bn.__setitem__("bias", v) if is_res
                 else bn_parts["bias"].append(v))

        inp = x
        ci = 0
        for r in range(spec.repeat):
            pad = spec.dilation * (spec.kernel - 1) // 2
            if spec.separable:
                dw_w, pw_w = conv3d[ci], conv3d[ci + 1]
                if dw_w.shape[1] != 1:
                    dw_w, pw_w = pw_w, dw_w
                x = F.conv1d(x * mask, dw_w, padding=pad,
                             dilation=spec.dilation, groups=dw_w.shape[0])
                x = F.conv1d(x * mask, pw_w)
                ci += 2
            else:
                x = F.conv1d(x * mask, conv3d[ci], padding=pad,
                             dilation=spec.dilation)
                ci += 1
            x = bn(x, {k: v[r] for k, v in
                       {kk: bn_parts[kk] for kk in
                        ("mean", "var", "scale", "bias")}.items()})
            if r < spec.repeat - 1:
                x = F.relu(x)
        assert ci == len(conv3d), f"block {bi}: unconsumed conv weights"
        if spec.residual:
            res = F.conv1d(inp * mask, res_pw)
            res = bn(res, res_bn)
            x = x + res
        x = F.relu(x)

    lin = sorted((k, np.asarray(v)) for k, v in sd.items()
                 if k.startswith("decoder") and np.asarray(v).ndim == 2
                 and np.asarray(v).shape[0] == cfg.num_classes)
    w = torch.as_tensor(lin[0][1], dtype=torch.float32)
    bkey = lin[0][0].rsplit(".", 1)[0] + ".bias"
    b = t.get(bkey, torch.zeros(cfg.num_classes))
    logits = torch.einsum("bct,oc->bto", x, w) + b[None, None, :]
    return logits.numpy()
