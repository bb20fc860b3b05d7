"""notsofar_tpu_torch's MarbleNet frame VAD (models/marblenet.py) against
the JAX package, on the CPU: the converter's tree, frame probabilities
on shared weights (max abs 1e-4 in f32), the vad_fn interface inside the
time-based diarizer, the NeMo topology parser, the .nemo round trip, the
energy-VAD fallback and the torch NeMo-semantics oracle (the card
against the CPU: tests/test_torch_time_based_gpu.py).

Small topology (16 mels; separable, residual, dilated and plain blocks);
weights from a synthetic NeMo-layout state dict with its batch norms
redrawn away from identity, or the JAX init; inputs made from a seed.
"""
import logging
import sys
import tarfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from notsofar_tpu.diarization import time_based as jtb
from notsofar_tpu.models import marblenet as jm
from notsofar_tpu.models.titanet import titanet_features as j_features
from notsofar_tpu_torch.diarization import common as tcommon
from notsofar_tpu_torch.diarization import time_based as ttb
from notsofar_tpu_torch.models import marblenet as tm
from tests.test_marblenet import CFG as JCFG
from tests.test_marblenet import synth_nemo_marblenet_sd
from tests.test_torch_whisper import torch_threads  # noqa: F401

TCFG = tm.MarbleNetConfig(
    n_mels=JCFG.n_mels, blocks=tuple(tm.BlockSpec(*b) for b in JCFG.blocks))
TOL = 1e-4


def nemo_sd(seed: int):
    """A synthetic NeMo-layout MarbleNet state dict whose batch norms are
    redrawn away from identity, so that statistics or orientation errors
    cannot hide behind identity values."""
    rng = np.random.RandomState(seed)
    sd = synth_nemo_marblenet_sd(rng, JCFG)
    for k, v in sd.items():
        if k.endswith(("running_var", ".1.weight", ".2.weight",
                       ".5.weight", ".8.weight")) and v.ndim == 1:
            sd[k] = (0.5 + rng.rand(*v.shape)).astype(np.float32)
        elif k.endswith(("running_mean", ".bias")) and v.ndim == 1:
            sd[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    return sd


def pair(variables):
    """(JAX FrameVAD, port FrameVAD on the CPU) on one flax tree."""
    v = jax.tree_util.tree_map(np.asarray, variables)
    return (jm.FrameVAD(JCFG, variables=v),
            tm.FrameVAD(TCFG, tm.variables_from_jax(v), device="cpu"))


def waves(seed: int):
    rng = np.random.RandomState(seed)
    wavs = (rng.randn(2, 16000) * 0.1).astype(np.float32)
    lengths = np.asarray([16000, 9000])
    wavs[1, 9000:] = 0.0
    return wavs, lengths


def test_converter_tree_matches_the_module():
    """The port's converter gives the JAX converter's tree, leaf for
    leaf, and variables_from_jax maps it onto every parameter and
    running statistic of the port's module with its shapes."""
    sd = nemo_sd(0)
    got = tm.convert_nemo_marblenet(sd, TCFG)
    want = jm.convert_nemo_marblenet(sd, JCFG)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    state = tm.variables_from_jax(got)
    module = tm.MarbleNet(TCFG).state_dict()
    assert set(state) == set(module)
    assert all(state[k].shape == module[k].shape for k in module)
    # the JAX init's tree has the same leaves as the converted one
    init = jax.tree_util.tree_map(lambda x: np.asarray(x).shape,
                                  jm.FrameVAD(JCFG).variables)
    assert init == jax.tree_util.tree_map(lambda x: np.asarray(x).shape,
                                          want)


@pytest.mark.parametrize("weights", ["nemo", "jax_init"])
def test_frame_probs_match_jax(weights):
    """P(speech) per 10 ms frame from both packages on the same weights
    and waveforms: max abs difference <= 1e-4 (f32; observed ~1e-7),
    on every frame of the padded output."""
    variables = (jm.convert_nemo_marblenet(nemo_sd(1), JCFG)
                 if weights == "nemo" else jm.FrameVAD(JCFG).variables)
    jvad, tvad = pair(variables)
    wavs, lengths = waves(2)
    want = jvad.frame_probs(wavs, lengths)
    got = tvad.frame_probs(wavs, lengths)
    assert got.shape == want.shape and got.shape[1] >= 100
    assert np.abs(got - want).max() <= TOL
    assert (got >= 0).all() and (got <= 1).all()
    # vad_fn interface: a boolean mask with energy_vad's frame count
    mask = tvad(wavs[0], 16000)
    assert mask.dtype == bool and len(mask) == 100
    np.testing.assert_array_equal(mask, jvad(wavs[0], 16000))


def test_vad_fn_in_diarizer():
    """A FrameVAD as the diarizer's vad_fn (random weights: plumbing),
    in both packages on the same weights and a toy encoder: equal [C, S,
    T] tensors of 0/1."""
    class ToyEncoder:
        def embed(self, wavs, lengths):
            rng = np.random.RandomState(int(lengths[0]) % 97)
            return rng.randn(len(wavs), 8).astype(np.float32)

    jvad, tvad = pair(jm.FrameVAD(JCFG).variables)
    rng = np.random.RandomState(2)
    wavs = [(rng.randn(16000 * 2) * 0.1).astype(np.float32)
            for _ in range(2)]
    got = ttb.diarize_streams(wavs, 16000, ToyEncoder(), vad_fn=tvad)
    want = jtb.diarize_streams(wavs, 16000, ToyEncoder(), vad_fn=jvad)
    assert got.ndim == 3 and got.shape[0] == 2
    assert set(np.unique(got)) <= {0.0, 1.0}
    np.testing.assert_array_equal(got, want)
    assert ttb.LAST_VAD_USED["kind"] == "custom"


def test_blocks_from_nemo_config():
    cfg_yaml = dict(encoder=dict(jasper=[
        dict(filters=128, repeat=1, kernel=[11], residual=False,
             separable=True),
        dict(filters=64, repeat=2, kernel=[13], dilation=[1], residual=True,
             separable=True),
        dict(filters=128, repeat=1, kernel=[29], dilation=[2],
             residual=False, separable=True),
        dict(filters=128, repeat=1, kernel=[1], residual=False),
    ]))
    blocks = tm.blocks_from_nemo_config(cfg_yaml)
    assert blocks == tuple(tm.BlockSpec(*b) for b in
                           jm.blocks_from_nemo_config(cfg_yaml))
    assert blocks[0] == tm.BlockSpec(128, 1, 11, 1, False, True)
    assert blocks[2].dilation == 2
    assert blocks[3].separable is False
    with pytest.raises(ValueError):
        tm.blocks_from_nemo_config(dict(encoder={}))


def test_resolve_frame_vad_fallback(monkeypatch, caplog):
    """No checkpoint mounted: None, with the loud warning of the JAX
    package, so that diarize_streams takes the energy VAD."""
    monkeypatch.delenv("NOTSOFAR_MODELS_DIR", raising=False)
    ttb._VAD_CACHE.clear()
    with caplog.at_level(logging.WARNING):
        assert ttb.resolve_frame_vad(tcommon.DiarizationCfg(),
                                     device="cpu") is None
    assert "NOT mounted" in caplog.text
    ttb._VAD_CACHE.clear()


def test_nemo_archive_roundtrip(tmp_path, monkeypatch):
    """.nemo tar -> FrameVAD with the topology parsed from the archive's
    yaml, resolved through the diarizer's model lookup on the CPU; its
    probabilities equal the JAX package's FrameVAD.from_checkpoint on the
    same archive."""
    sd = nemo_sd(3)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "model_weights.ckpt")
    cfg_yaml = dict(
        preprocessor=dict(features=JCFG.n_mels),
        encoder=dict(jasper=[
            dict(filters=b.filters, repeat=b.repeat, kernel=[b.kernel],
                 dilation=[b.dilation], residual=b.residual,
                 separable=b.separable) for b in JCFG.blocks]))
    (tmp_path / "model_config.yaml").write_text(yaml.safe_dump(cfg_yaml))
    nemo = tmp_path / "vad_multilingual_marblenet.nemo"
    with tarfile.open(nemo, "w") as tar:
        tar.add(tmp_path / "model_weights.ckpt", arcname="model_weights.ckpt")
        tar.add(tmp_path / "model_config.yaml", arcname="model_config.yaml")
    monkeypatch.setenv("NOTSOFAR_MODELS_DIR", str(tmp_path))
    ttb._VAD_CACHE.clear()
    vad = ttb.resolve_frame_vad(tcommon.DiarizationCfg(), device="cpu")
    ttb._VAD_CACHE.clear()
    assert isinstance(vad, tm.FrameVAD) and vad.device.type == "cpu"
    assert vad.cfg == TCFG
    mask = vad(np.zeros(16000, np.float32), 16000)
    assert mask.shape == (100,) and mask.dtype == bool
    wavs, lengths = waves(4)
    want = jm.FrameVAD.from_checkpoint(nemo).frame_probs(wavs, lengths)
    assert np.abs(vad.frame_probs(wavs, lengths) - want).max() <= TOL


def test_torch_oracle_parity():
    """The port's frame logits against the independent NeMo-semantics
    forward of tools/torch_marblenet_oracle.py on the NeMo state dict:
    < 1e-4 relative on every valid frame."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from tools.torch_marblenet_oracle import torch_frame_logits
    sd = nemo_sd(5)
    vad = tm.FrameVAD(TCFG, tm.variables_from_jax(
        tm.convert_nemo_marblenet(sd, TCFG)), device="cpu")
    wavs, lengths = waves(6)
    feats = np.asarray(j_features(wavs, n_mels=JCFG.n_mels))
    frame_lengths = lengths // 160 + 1
    ref = torch_frame_logits(sd, JCFG, feats, frame_lengths)
    with torch.no_grad():
        got = vad.module(torch.from_numpy(feats),
                         torch.from_numpy(frame_lengths)).numpy()
    for b, n in enumerate(frame_lengths):
        rel = np.abs(ref[b, :n] - got[b, :n]).max() / \
            max(np.abs(ref[b, :n]).max(), 1e-9)
        assert rel < 1e-4, f"row {b}: rel diff {rel}"
