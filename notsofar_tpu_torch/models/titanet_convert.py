"""NeMo TitaNet checkpoint -> the port's TitaNet state_dict.

Copy of notsofar_tpu/models/titanet_convert.py. A `.nemo` file is a tar
archive holding `model_weights.ckpt` (torch state dict) and
`model_config.yaml`. NeMo's internal module indices shift across
versions, so the mapping is *shape-driven* within each block: depthwise
conv weights are recognized by shape [C, 1, k], pointwise by [C2, C, 1],
batch-norms by their running-stats siblings, and squeeze-excite /
attention-pooling layers by their characteristic dimensions. Unmatched
layouts raise with a listing so a new NeMo layout fails loudly instead of
silently mis-mapping.

The mapping builds the flax-layout tree of the JAX converter, which
models.titanet.variables_from_jax turns into the port's state_dict, so
both packages read a checkpoint through the same shape rules.
"""
import io
import re
import tarfile
from collections import defaultdict
from dataclasses import replace
from typing import Dict, Tuple

import numpy as np
import torch

from notsofar_tpu_torch.models.titanet import TitaNetConfig, variables_from_jax


def load_nemo_archive(path) -> Tuple[Dict[str, np.ndarray], dict]:
    """Extract (state_dict, config_dict) from a .nemo tar archive."""
    import yaml
    with tarfile.open(path, "r:*") as tar:
        names = tar.getnames()
        ckpt_name = next(n for n in names if n.endswith("model_weights.ckpt"))
        cfg_name = next(n for n in names if n.endswith("model_config.yaml"))
        sd = torch.load(io.BytesIO(tar.extractfile(ckpt_name).read()),
                        map_location="cpu", weights_only=False)
        cfg = yaml.safe_load(tar.extractfile(cfg_name).read())
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}, cfg


def _t_lin(w):  # [out, in] -> flax [in, out]
    return np.ascontiguousarray(np.asarray(w).T)


def _dw(w):  # torch depthwise conv [C, 1, k] -> flax (k, 1, C)
    return np.ascontiguousarray(np.asarray(w).transpose(2, 1, 0))


def _pw(w):  # torch pointwise conv [C2, C, 1] -> flax (1, C, C2)
    return np.ascontiguousarray(np.asarray(w).transpose(2, 1, 0))


def _natural(k: str):
    """Sort key treating embedded integers numerically — NeMo mconv
    indices reach two digits (mconv.10/.11/.12), where lexicographic order
    would put 'mconv.10' before 'mconv.2' and swap conv weights."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", k)]


def _group_encoder_blocks(sd: Dict[str, np.ndarray]) -> Dict[int, Dict]:
    blocks = defaultdict(dict)
    for k, v in sd.items():
        m = re.match(r"encoder\.encoder\.(\d+)\.(.+)", k)
        if m:
            blocks[int(m.group(1))][m.group(2)] = np.asarray(v)
    return dict(blocks)


def _convert_block(raw: Dict[str, np.ndarray], repeat: int) -> Tuple[Dict, Dict]:
    """One JasperBlock -> flax-layout (params, batch_stats)."""
    dw, pw = [], []
    bn_scale, bn_bias, bn_mean, bn_var = [], [], [], []
    se_fc = []
    res_pw = None
    res_bn: Dict[str, np.ndarray] = {}
    for k in sorted(raw, key=_natural):
        v = np.asarray(raw[k])
        is_res = ".res" in k or k.startswith("res")
        if v.ndim == 3:
            if is_res:
                res_pw = _pw(v)
            elif v.shape[1] == 1 and v.shape[0] != 1:
                dw.append(_dw(v))      # depthwise: [C, in_per_group=1, k]
            elif v.shape[2] == 1:      # pointwise: [C_out, C_in, 1]
                pw.append(_pw(v))
        elif ".fc." in k and v.ndim == 2:
            se_fc.append(v)            # NeMo SE linears are bias-free
        elif k.endswith("running_mean"):
            res_bn.__setitem__("mean", v) if is_res else bn_mean.append(v)
        elif k.endswith("running_var"):
            res_bn.__setitem__("var", v) if is_res else bn_var.append(v)
        elif k.endswith(".weight") and v.ndim == 1:
            res_bn.__setitem__("scale", v) if is_res else bn_scale.append(v)
        elif k.endswith(".bias") and v.ndim == 1 and ".fc." not in k:
            res_bn.__setitem__("bias", v) if is_res else bn_bias.append(v)

    if len(dw) == 0 and len(pw) == repeat:
        # non-separable variant (plain convs classified as pointwise when
        # kernel==1); synthesize identity depthwise kernels
        for w in pw:
            dw.append(np.ones((1, 1, w.shape[1]), np.float32))
    if not len(dw) == len(pw) == repeat:
        raise ValueError(f"expected {repeat} separable convs, found "
                         f"dw={len(dw)} pw={len(pw)}")
    if len(bn_scale) < repeat:
        raise ValueError("missing batch norms")
    params: Dict = {}
    stats: Dict = {}
    for r in range(repeat):
        params[f"conv_{r}"] = {"dw": {"kernel": dw[r]},
                               "pw": {"kernel": pw[r]}}
        params[f"bn_{r}"] = {"scale": bn_scale[r], "bias": bn_bias[r]}
        stats[f"bn_{r}"] = {"mean": bn_mean[r], "var": bn_var[r]}
    if se_fc:
        if len(se_fc) != 2:
            raise ValueError(f"expected 2 SE linears, got {len(se_fc)}")
        w1, w2 = (se_fc if se_fc[0].shape[0] < se_fc[0].shape[1]
                  else se_fc[::-1])   # squeeze first: [C/r, C]
        params["se"] = {"fc1": {"kernel": _t_lin(w1)},
                        "fc2": {"kernel": _t_lin(w2)}}
    if res_pw is not None:
        params["res_pw"] = {"kernel": res_pw}
        params["res_bn"] = {"scale": res_bn["scale"], "bias": res_bn["bias"]}
        stats["res_bn"] = {"mean": res_bn["mean"], "var": res_bn["var"]}
    return params, stats


def _convert_tree(sd: Dict[str, np.ndarray], cfg: TitaNetConfig) -> Dict:
    """NeMo EncDecSpeakerLabelModel state dict -> flax-layout variables."""
    blocks = _group_encoder_blocks(sd)
    if not blocks:
        raise ValueError(
            "no encoder.encoder.* keys found — not a NeMo ConvASREncoder "
            f"state dict? keys sample: {sorted(sd)[:10]}")
    n_blocks = len(blocks)
    if n_blocks < len(cfg.block_kernels) + 2:
        raise ValueError(f"expected prologue + {len(cfg.block_kernels)} "
                         f"blocks + epilogue, found {n_blocks}")

    params: Dict = {}
    stats: Dict = {}
    params["prologue"], stats["prologue"] = _convert_block(blocks[0], 1)
    for bi in range(len(cfg.block_kernels)):
        params[f"block_{bi}"], stats[f"block_{bi}"] = _convert_block(
            blocks[1 + bi], cfg.block_repeat)
    params["epilogue"], stats["epilogue"] = _convert_block(
        blocks[n_blocks - 1], 1)

    # decoder: ECAPA attentive pooling (global context) + bottleneck,
    # routed by SHAPE (NeMo module paths shift across versions): the
    # context conv eats 3*C_epi channels, the score conv eats
    # attention_dim; the bottleneck linear is the 2-d decoder weight with
    # 2*C_epi inputs (which excludes the classification head).
    dec3 = sorted(((k, np.asarray(v)) for k, v in sd.items()
                   if k.startswith("decoder") and np.asarray(v).ndim == 3),
                  key=lambda kv: _natural(kv[0]))
    att1 = [(k, v) for k, v in dec3 if v.shape[1] == 3 * cfg.epilogue_filters]
    att2 = [(k, v) for k, v in dec3 if v.shape[1] == cfg.attention_dim
            and v.shape[0] == cfg.epilogue_filters]
    if len(att1) != 1 or len(att2) != 1:
        raise ValueError("attention convs not found by shape: "
                         f"{[(k, v.shape) for k, v in dec3]}")

    def sibling_bias(weight_key, n):
        bk = weight_key[: -len(".weight")] + ".bias"
        return np.asarray(sd[bk]) if bk in sd else np.zeros(n, np.float32)

    (k1, w1), (k2, w2) = att1[0], att2[0]
    params["pool"] = {
        "att1": {"kernel": _pw(w1), "bias": sibling_bias(k1, w1.shape[0])},
        "att2": {"kernel": _pw(w2), "bias": sibling_bias(k2, w2.shape[0])},
    }
    emb_ws = [(k, np.asarray(v)) for k, v in sd.items()
              if k.startswith("decoder") and np.asarray(v).ndim == 2
              and np.asarray(v).shape[1] == 2 * cfg.epilogue_filters]
    if len(emb_ws) != 1:
        raise ValueError("decoder embedding linear not found: "
                         f"{[(k, v.shape) for k, v in emb_ws]}")
    emb_k, emb_w = emb_ws[0]
    params["emb"] = {"kernel": _t_lin(emb_w),
                     "bias": sibling_bias(emb_k, emb_w.shape[0])}
    # decoder batch-norms routed by width: attention_dim -> pool TDNN BN,
    # emb_dim -> embedding BN; identity when a checkpoint lacks one
    decoder_bns = {}
    for k in sd:
        if k.startswith("decoder") and k.endswith("running_mean"):
            decoder_bns[int(np.asarray(sd[k]).shape[0])] = \
                k[: -len(".running_mean")]
    if cfg.attention_dim == cfg.emb_dim:
        raise ValueError("width-driven BN routing needs distinct "
                         "attention/emb dims")
    for name, dim in [("att_bn", cfg.attention_dim), ("emb_bn", cfg.emb_dim)]:
        prefix = decoder_bns.get(dim)
        dst_p = params["pool"] if name == "att_bn" else params
        dst_s = stats.setdefault("pool", {}) if name == "att_bn" else stats
        if prefix is not None:
            # affine is optional: angular-trained checkpoints
            # (titanet_large) build the emb BatchNorm1d with affine=False
            w, b = sd.get(prefix + ".weight"), sd.get(prefix + ".bias")
            dst_p[name] = {"scale": np.asarray(w) if w is not None
                           else np.ones(dim, np.float32),
                           "bias": np.asarray(b) if b is not None
                           else np.zeros(dim, np.float32)}
            dst_s[name] = {"mean": np.asarray(sd[prefix + ".running_mean"]),
                           "var": np.asarray(sd[prefix + ".running_var"])}
        else:
            dst_p[name] = {"scale": np.ones(dim, np.float32),
                           "bias": np.zeros(dim, np.float32)}
            dst_s[name] = {"mean": np.zeros(dim, np.float32),
                           "var": np.ones(dim, np.float32)}
    return {"params": params, "batch_stats": stats}


def convert_nemo_titanet(sd: Dict[str, np.ndarray],
                         cfg: TitaNetConfig = TitaNetConfig()
                         ) -> Dict[str, torch.Tensor]:
    """NeMo EncDecSpeakerLabelModel state dict -> TitaNet state_dict."""
    return variables_from_jax(_convert_tree(sd, cfg))


def detect_titanet_config(sd: Dict[str, np.ndarray],
                          base: TitaNetConfig = TitaNetConfig()
                          ) -> TitaNetConfig:
    """Per-block squeeze-excite presence of the prologue and epilogue,
    read from a NeMo state dict."""
    blocks = _group_encoder_blocks(sd)
    if not blocks:
        return base
    n = len(blocks)
    has_se = {i: any(".fc." in k for k in blocks[i]) for i in blocks}
    return replace(base, prologue_se=has_se.get(0, base.prologue_se),
                   epilogue_se=has_se.get(n - 1, base.epilogue_se))
