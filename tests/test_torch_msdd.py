"""notsofar_tpu_torch's MSDD (models/msdd.py, models/msdd_convert.py)
against the JAX package, on the CPU: probabilities on shared weights (max
abs 1e-4), any speaker count, batch independence, the synthetic NeMo
checkpoint's converter (plain and 'msdd.'-prefixed keys), the .nemo tar
and the torch NeMo-semantics oracle (the card against the CPU:
tests/test_torch_time_based_gpu.py).

Small shapes (D 16, K 3, hidden 8, 2 LSTM layers, 4 channels); weights
from the JAX init or a synthetic NeMo-layout state dict through each
package's converter; inputs made from a seed.
"""
import sys
import tarfile
from dataclasses import asdict, replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from notsofar_tpu.models import msdd as jmsdd
from notsofar_tpu.models import msdd_convert as jconv
from notsofar_tpu_torch.models import msdd as tmsdd
from notsofar_tpu_torch.models import msdd_convert as tconv
from tests.test_msdd import _synthetic_nemo_sd
from tests.test_torch_whisper import torch_threads  # noqa: F401

JCFG = jmsdd.MSDDConfig(emb_dim=16, n_scales=3, num_spks=2, hidden=8,
                        num_lstm_layers=2, cnn_channels=4)
TOL = 1e-4


def tcfg(cfg) -> tmsdd.MSDDConfig:
    return tmsdd.MSDDConfig(**asdict(cfg))


def numpy_sd(**kw):
    return {k: v.numpy() for k, v in _synthetic_nemo_sd(**kw).items()}


def inputs(seed: int, B: int, T: int, cfg, S: int = 2):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, cfg.n_scales, cfg.emb_dim).astype(np.float32),
            rng.randn(B, cfg.n_scales, cfg.emb_dim, S).astype(np.float32))


def port_of(cfg, variables) -> tmsdd.OverlapDecoder:
    return tmsdd.OverlapDecoder(tcfg(cfg), tmsdd.variables_from_jax(
        jax.tree_util.tree_map(np.asarray, variables)), device="cpu")


@pytest.mark.parametrize("weights", ["jax_init", "nemo"])
def test_probs_match_jax(weights):
    """[B, T, S] activity probabilities of both packages on the same
    weights: max abs <= 1e-4 (observed ~1e-7), inside [0, 1]."""
    if weights == "jax_init":
        jdec = jmsdd.OverlapDecoder(JCFG)
    else:
        cfg, variables = jconv.convert_msdd_state_dict(numpy_sd(seed=1))
        jdec = jmsdd.OverlapDecoder(cfg, variables=variables)
    tdec = port_of(jdec.cfg, jdec.variables)
    e, a = inputs(0, 2, 7, jdec.cfg)
    got, want = tdec.refine(e, a), jdec.refine(e, a)
    assert got.shape == want.shape == (2, 7, 2)
    assert np.abs(got - want).max() <= TOL
    assert (got >= 0).all() and (got <= 1).all()


def test_variable_speaker_count():
    """S is data-driven: a module built for S = 3 equals the JAX module
    initialized on S = 3 inputs."""
    e, a3 = inputs(1, 1, 5, JCFG, S=3)
    m = jmsdd.MSDD(JCFG)
    v = m.init(jax.random.PRNGKey(0), jnp.asarray(e), jnp.asarray(a3))
    want = np.asarray(m.apply(v, jnp.asarray(e), jnp.asarray(a3)))
    got = port_of(replace(JCFG, num_spks=3), v).refine(e, a3)
    assert got.shape == want.shape == (1, 5, 3)
    assert np.abs(got - want).max() <= TOL


def test_batch_consistency():
    """Each batch element is processed independently."""
    dec = tmsdd.OverlapDecoder(tcfg(JCFG), device="cpu", seed=2)
    e, a = inputs(2, 3, 6, JCFG)
    np.testing.assert_allclose(dec.refine(e, a)[1:2],
                               dec.refine(e[1:2], a[1:2]), atol=1e-6)


@pytest.mark.parametrize("prefix", ["", "msdd."])
def test_converter_synthetic_checkpoint(prefix):
    """The synthetic NeMo MSDD_module state dict (keys bare or under
    'msdd.', the embedded speaker model's keys ignored): the port's
    converter gives the JAX converter's config and tree leaf for leaf,
    and the converted weights give the JAX decoder's probabilities (and
    differ from a random init's)."""
    sd = {f"{prefix}{k}" if not k.startswith("msdd.") else k: v
          for k, v in numpy_sd().items()}
    cfg_t, tree_t = tconv.convert_msdd_state_dict(sd)
    cfg_j, tree_j = jconv.convert_msdd_state_dict(sd)
    assert asdict(cfg_t) == asdict(cfg_j)
    assert (cfg_t.emb_dim, cfg_t.n_scales, cfg_t.num_spks, cfg_t.hidden,
            cfg_t.num_lstm_layers, cfg_t.cnn_channels,
            cfg_t.conv_repeat) == (16, 3, 2, 8, 2, 4, 1)
    assert jax.tree_util.tree_structure(tree_t) == \
        jax.tree_util.tree_structure(tree_j)
    for x, y in zip(jax.tree_util.tree_leaves(tree_t),
                    jax.tree_util.tree_leaves(tree_j)):
        np.testing.assert_array_equal(x, y)
    state = tmsdd.variables_from_jax(tree_t)
    assert set(state) == set(tmsdd.MSDD(cfg_t).state_dict())
    dec = tmsdd.OverlapDecoder(cfg_t, state, device="cpu")
    e, a = inputs(3, 1, 6, cfg_t)
    p = dec.refine(e, a)
    want = jmsdd.OverlapDecoder(cfg_j, variables=tree_j).refine(e, a)
    assert p.shape == (1, 6, 2) and np.isfinite(p).all()
    assert np.abs(p - want).max() <= TOL
    p_rand = tmsdd.OverlapDecoder(cfg_t, device="cpu").refine(e, a)
    assert np.abs(p - p_rand).max() > 1e-4


def test_nemo_tar_roundtrip(tmp_path):
    """.nemo tar (model_weights.ckpt with 'msdd.' keys + a yaml) ->
    OverlapDecoder.from_checkpoint on the CPU, equal to the JAX
    package's decoder from the same archive."""
    sd = {f"msdd.{k}" if not k.startswith("msdd.") else k: v
          for k, v in _synthetic_nemo_sd(seed=4).items()}
    torch.save(sd, tmp_path / "model_weights.ckpt")
    (tmp_path / "model_config.yaml").write_text(
        yaml.safe_dump({"name": "synthetic_msdd"}))
    nemo = tmp_path / "diar_msdd_synth.nemo"
    with tarfile.open(nemo, "w") as tar:
        tar.add(tmp_path / "model_weights.ckpt", arcname="model_weights.ckpt")
        tar.add(tmp_path / "model_config.yaml", arcname="model_config.yaml")
    dec = tmsdd.OverlapDecoder.from_checkpoint(nemo, device="cpu")
    assert dec.cfg.n_scales == 3 and dec.device.type == "cpu"
    e, a = inputs(4, 1, 4, dec.cfg)
    want = jmsdd.OverlapDecoder.from_checkpoint(nemo).refine(e, a)
    assert np.abs(dec.refine(e, a) - want).max() <= TOL


@pytest.mark.parametrize("seed", [0, 5])
def test_torch_oracle_parity(seed):
    """The port against tools/torch_msdd_oracle.py's NeMo-semantics
    forward (torch's own nn.LSTM on the NeMo state dict): < 1e-4."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from tools.torch_msdd_oracle import torch_forward
    sd = numpy_sd(seed=seed)
    cfg, tree = tconv.convert_msdd_state_dict(sd)
    dec = tmsdd.OverlapDecoder(cfg, tmsdd.variables_from_jax(tree),
                               device="cpu")
    e, a = inputs(seed + 10, 2, 9, cfg)
    assert np.abs(dec.refine(e, a) - torch_forward(sd, cfg, e, a)).max() \
        < TOL
