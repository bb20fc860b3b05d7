"""The benchmark's operation and byte counts: large-v3's decode step
against a hand count, and no count above what a kernel that reads only
what it needs must read."""
import json
from pathlib import Path

import pytest
import torch

from gpubench.counts import conformer as cc
from gpubench.counts import whisper as wc
from gpubench.reference import conformer as rc
from gpubench.reference import whisper as rw

ROOT = Path(__file__).resolve().parents[2]
LARGE_V3 = json.loads((ROOT / "gpubench/configs/whisper-large-v3.json")
                      .read_text())
CONFORMER = json.loads((ROOT / "gpubench/configs/conformer-css-large-mc.json")
                       .read_text())


def test_large_v3_step_weights_by_hand():
    # 32 blocks x (self q,k,v,out 4 x 1280^2 + cross q,out 2 x 1280^2 +
    # fc1, fc2 2 x 4 x 1280^2) + the tied embedding 51866 x 1280
    per_block = 14 * 1280 * 1280
    params = 32 * per_block + 51866 * 1280
    assert params == 800_391_680
    assert wc.decode_step_weight_params(LARGE_V3) == params
    assert wc.decode_step_weight_bytes(LARGE_V3) == 2 * params
    assert abs(2 * params / 1e9 - 1.60) < 0.01


def test_step_weights_are_the_decoders_matrices_a_step_reads():
    """The count equals the elements of the checkpoint's matrices a
    cached step multiplies by: every decoder matrix but the cross
    attention's key and value, and the embedding."""
    specs = rw.param_specs(LARGE_V3)
    used = sum(int(torch.Size(s).numel()) for n, s, k in specs
               if n.startswith("decoder.") and k in ("matrix", "emb")
               and ".cross_attn.key." not in n
               and ".cross_attn.value." not in n)
    assert wc.decode_step_weight_params(LARGE_V3) == used


def test_cross_memory_counted_once_per_window_whatever_the_beams():
    d = LARGE_V3
    one = wc.decode_step_bytes(d, [200, 200], 1, 0)
    five = wc.decode_step_bytes(d, [200, 200], 5, 0)
    kv_row = 2 * d["n_text_layer"] * d["n_text_state"] * 2
    assert five - one == 2 * 4 * kv_row   # only the generated slots grow


@pytest.mark.parametrize("step", [0, 40, 79])
def test_step_bytes_never_above_a_minimal_reader(step):
    """A kernel that reads each weight, each window's memory and each
    row's cache once reads at least the count: the count's share of any
    such kernel's time at the peak rate is at most 100%."""
    d = LARGE_V3
    prompts = [158, 227]
    need = wc.decode_step_bytes(d, prompts, 5, step)
    weights = wc.decode_step_weight_bytes(d)
    memory = len(prompts) * d["n_audio_ctx"] * 2 * d["n_text_layer"] * \
        d["n_text_state"] * 2
    caches = (sum(prompts) + 2 * 5 * (step + 1)) * 2 * d["n_text_layer"] * \
        d["n_text_state"] * 2
    assert need <= weights + memory + caches


def test_conformer_counts_both_macaron_ffns_and_scalar_taps():
    c = {k: CONFORMER[k] for k in ("attention_dim", "attention_heads",
                                    "linear_units", "kernel_size",
                                    "num_blocks", "in_features", "num_bins",
                                    "num_spks", "num_nois")}
    T = 186
    d, u = 512, 1024
    block = 2 * 4 * T * d * u + 8 * T * d * d + 6 * T * T * d + \
        2 * T * d * 33
    want = 2 * T * 1799 * d + 18 * block + 2 * T * d * 257 * 4
    assert cc.forward_flops(c, T) == want
    # the matrices of a block are the two FFNs' and the attention's
    spec_c = dict(c, pos_maxlen=1000)
    mats = sum(torch.Size(s).numel() for n, s, k in rc.param_specs(spec_c)
               if k == "matrix" and ".layer_0." in n and ".dw." not in n)
    assert 2 * T * mats == 2 * 4 * T * d * u + 8 * T * d * d
