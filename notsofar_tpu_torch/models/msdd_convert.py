"""NeMo MSDD checkpoint -> the JAX package's flax-layout MSDD variables.

Copy of notsofar_tpu/models/msdd_convert.py (numpy and tarfile); the port
turns the tree into its state_dict with models.msdd.variables_from_jax
(OverlapDecoder.from_checkpoint), so both packages read a checkpoint
through the same rules.

The reference's `nmesc_msdd` mode loads `diar_msdd_telephonic` through
NeMo's NeuralDiarizer (time_based_diarization.py:20-117). A `.nemo` file
is a tar archive holding `model_weights.ckpt` (torch state dict) and
`model_config.yaml`. This converter maps the MSDD_module weights onto
the JAX package's MSDD:

    msdd.conv.{i}.cnn.0.{weight,bias}      -> conv_{i} (NHWC kernel)
    msdd.conv_bn.{i}.running_{mean,var}    -> batch_stats conv_bn_{i}_*
    msdd.conv_to_linear / linear_to_weights / dist_to_emb / hidden_to_spks
                                           -> same-named Dense layers
    msdd.lstm.weight_ih_l{k}[_reverse] ... -> lstm_l{k}_{fw,bw} cells,
        torch gate order (i, f, g, o) split into flax's per-gate Dense
        params; bias = bias_ih + bias_hh folded into the h-side bias
        (flax LSTMCell carries bias only on the hidden projection).

The MSDD .nemo also contains the underlying TitaNet speaker model
(`msdd._speaker_model.*`) — that part converts via
models/titanet_convert.py and is not handled here.

Every expected key must be present with the expected shape; a new NeMo
layout fails loudly. NOTE: validated structurally (synthetic-layout tests
in tests/test_msdd.py and tests/test_torch_msdd.py); numerical validation
needs the real checkpoint, which no test has.
"""
import re
from typing import Dict, Tuple

import numpy as np

from notsofar_tpu_torch.models.msdd import MSDDConfig
from notsofar_tpu_torch.models.titanet_convert import load_nemo_archive


def _lin(w):  # torch [out, in] -> flax kernel [in, out]
    return np.ascontiguousarray(np.asarray(w, np.float32).T)


def _conv_nhwc(w):  # torch [C_out, C_in, KH, KW] -> flax (KH, KW, C_in, C_out)
    return np.ascontiguousarray(
        np.asarray(w, np.float32).transpose(2, 3, 1, 0))


def config_from_shapes(sd: Dict[str, np.ndarray]) -> MSDDConfig:
    """Infer the MSDDConfig from the decoder weight shapes."""
    lw = sd["linear_to_weights.weight"]          # [K, hidden]
    n_scales, hidden = int(lw.shape[0]), int(lw.shape[1])
    d2e = sd["dist_to_emb.weight"]               # [hidden, K*S]
    num_spks = int(d2e.shape[1]) // n_scales
    c2l = sd["conv_to_linear.weight"]            # [hidden, C*D]
    conv0 = sd["conv.0.cnn.0.weight"]            # [C, 1, K(S+1), 1]
    cnn_channels = int(conv0.shape[0])
    emb_dim = int(c2l.shape[1]) // cnn_channels
    conv_repeat = len({int(m.group(1))
                      for k in sd
                      for m in [re.match(r"conv\.(\d+)\.cnn\.0\.weight", k)]
                      if m}) - 1
    n_lstm = len({int(m.group(1))
                  for k in sd
                  for m in [re.match(r"lstm\.weight_ih_l(\d+)$", k)] if m})
    return MSDDConfig(emb_dim=emb_dim, n_scales=n_scales, num_spks=num_spks,
                      hidden=hidden, num_lstm_layers=n_lstm,
                      cnn_channels=cnn_channels, conv_repeat=conv_repeat)


def _lstm_cell(sd: Dict[str, np.ndarray], layer: int, reverse: bool) -> Dict:
    """One torch LSTM direction -> flax OptimizedLSTMCell params."""
    sfx = f"l{layer}" + ("_reverse" if reverse else "")
    w_ih = np.asarray(sd[f"lstm.weight_ih_{sfx}"], np.float32)   # [4H, in]
    w_hh = np.asarray(sd[f"lstm.weight_hh_{sfx}"], np.float32)   # [4H, H]
    b = (np.asarray(sd[f"lstm.bias_ih_{sfx}"], np.float32)
         + np.asarray(sd[f"lstm.bias_hh_{sfx}"], np.float32))    # [4H]
    H = w_hh.shape[1]
    gates = ["i", "f", "g", "o"]                                  # torch order
    cell: Dict[str, Dict[str, np.ndarray]] = {}
    for gi, g in enumerate(gates):
        sl = slice(gi * H, (gi + 1) * H)
        cell[f"i{g}"] = {"kernel": _lin(w_ih[sl])}
        cell[f"h{g}"] = {"kernel": _lin(w_hh[sl]), "bias": b[sl]}
    return cell


def convert_msdd_state_dict(sd: Dict[str, np.ndarray]
                            ) -> Tuple[MSDDConfig, Dict]:
    """NeMo MSDD_module state dict (numpy-valued; 'msdd.' prefix stripped
    or present) -> (MSDDConfig, flax variables)."""
    # strip an optional 'msdd.' prefix; drop the embedded speaker model
    clean = {}
    for k, v in sd.items():
        if "._speaker_model." in k or k.startswith("_speaker_model."):
            continue
        clean[k[5:] if k.startswith("msdd.") else k] = np.asarray(v)
    sd = clean
    cfg = config_from_shapes(sd)

    params: Dict = {}
    batch_stats: Dict = {}
    for i in range(cfg.conv_repeat + 1):
        w = sd[f"conv.{i}.cnn.0.weight"]
        expect = (cfg.cnn_channels, 1,
                  cfg.n_scales * (cfg.num_spks + 1) if i == 0
                  else cfg.cnn_channels, 1)
        if w.shape != expect:
            raise ValueError(f"conv.{i} weight shape {w.shape} != {expect}")
        params[f"conv_{i}"] = {
            "kernel": _conv_nhwc(w),
            "bias": np.asarray(sd[f"conv.{i}.cnn.0.bias"], np.float32)}
        batch_stats[f"conv_bn_{i}_mean"] = np.asarray(
            sd[f"conv_bn.{i}.running_mean"], np.float32)
        batch_stats[f"conv_bn_{i}_var"] = np.asarray(
            sd[f"conv_bn.{i}.running_var"], np.float32)
        if batch_stats[f"conv_bn_{i}_mean"].shape != (cfg.emb_dim,):
            raise ValueError(f"conv_bn.{i} statistics are not "
                             f"[{cfg.emb_dim}]")

    for name in ["conv_to_linear", "linear_to_weights", "dist_to_emb",
                 "hidden_to_spks"]:
        params[name] = {"kernel": _lin(sd[f"{name}.weight"]),
                        "bias": np.asarray(sd[f"{name}.bias"], np.float32)}

    for layer in range(cfg.num_lstm_layers):
        params[f"lstm_l{layer}_fw"] = _lstm_cell(sd, layer, reverse=False)
        params[f"lstm_l{layer}_bw"] = _lstm_cell(sd, layer, reverse=True)

    return cfg, {"params": params, "batch_stats": batch_stats}


def load_msdd_checkpoint(path) -> Tuple[MSDDConfig, Dict]:
    sd, _ = load_nemo_archive(path)
    return convert_msdd_state_dict(sd)
