"""notsofar_tpu_torch.tools.validate_real_weights against the JAX package's
tools/validate_real_weights.py, on the CPU.

One models dir holds a synthetic checkpoint of every format the validator
reads: the reference CSS .pt + yaml (MC), the native params.msgpack (SC),
an openai-layout Whisper .pt of a seeded port model, and the TitaNet
(published TitaNet-large width), MarbleNet and MSDD .nemo archives. The
port's validator runs with --device cpu (its kernel wrappers take their
plain versions on CPU tensors); the JAX tool's check functions run on the
same directory (not its Whisper check, slow to compile), with spies on
the calls that make their numbers.
"""
import dataclasses
import shutil

import numpy as np
import pytest
import torch
import yaml

import tools.torch_marblenet_oracle as joracle
import tools.validate_real_weights as JV
from notsofar_tpu.models import marblenet as jm
from notsofar_tpu.models import msdd as jmsdd
from notsofar_tpu.models import titanet as jt
from notsofar_tpu.models.css_wrapper import CssModel as JCssModel
from notsofar_tpu.training.config import (ConformerCssCfgM, NnetCfgM,
                                          TrainCfg)
from notsofar_tpu.utils.conf import dataclass_to_dict
from notsofar_tpu_torch.models import whisper as tw
from notsofar_tpu_torch.tools import marblenet_oracle as toracle
from notsofar_tpu_torch.tools import validate_real_weights as V
from tests.test_convert import synth_state_dict
from tests.test_marblenet import CFG as MN_CFG
from tests.test_msdd import _synthetic_nemo_sd
from tests.test_pipeline_e2e import (StubTranscriber, make_meeting,
                                     make_sc_css_model)
from tests.test_titanet_convert import synth_nemo_state_dict
from tests.test_torch_marblenet import nemo_sd as marblenet_nemo_sd
from tests.test_torch_pipeline import BatchStub
from tests.test_torch_whisper import torch_threads  # noqa: F401
from tests.test_validate_real_weights import TINY, _write_nemo

MINI = tw.WhisperDims(n_mels=80, n_audio_ctx=1500, n_audio_state=64,
                      n_audio_head=4, n_audio_layer=2, n_vocab=1864,
                      n_text_ctx=448, n_text_state=64, n_text_head=4,
                      n_text_layer=2)
MODELS = ("css-mc", "css-sc", "whisper", "titanet", "marblenet", "msdd")
NEMO = {"titanet": "titanet_large.nemo",
        "marblenet": "vad_multilingual_marblenet.nemo",
        "msdd": "diar_msdd_telephonic.nemo"}


@pytest.fixture(scope="module")
def models_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("real_weights")
    # css mc: the reference .pt + yaml
    mc_cfg = TrainCfg(conformer_css_cfg=ConformerCssCfgM(
        nnet_conf=NnetCfgM(conformer_conf=TINY, in_features=1799)))
    mc_dir = root / "notsofar" / "conformer1.0" / "mc"
    mc_dir.mkdir(parents=True)
    (mc_dir / "config.yaml").write_text(
        yaml.safe_dump(dataclass_to_dict(mc_cfg)))
    sd = synth_state_dict(np.random.RandomState(0), d=32, idim=1799, ffn=64,
                          blocks=2, k=33)
    torch.save({"model": {f"module.{k}": torch.from_numpy(np.asarray(v))
                          for k, v in sd.items()}},
               mc_dir / "checkpoint.pt")
    # css sc: native params.msgpack
    make_sc_css_model(root)
    # whisper: an openai-layout .pt of a seeded port model
    wm = tw.WhisperModel(MINI, device="cpu").init(
        torch.Generator().manual_seed(7))
    (root / "whisper").mkdir()
    torch.save(dict(dims=dataclasses.asdict(MINI), model_state_dict={
        k: v for k, v in wm.state_dict().items()
        if k != "encoder.positional_embedding"}), root / "whisper" / "mini.pt")
    # nemo archives
    _write_nemo(root / NEMO["titanet"], synth_nemo_state_dict(
        np.random.RandomState(1), jt.TitaNetConfig()), {})
    _write_nemo(root / NEMO["marblenet"], marblenet_nemo_sd(2),
                dict(preprocessor=dict(features=MN_CFG.n_mels),
                     encoder=dict(jasper=[
                         dict(filters=b.filters, repeat=b.repeat,
                              kernel=[b.kernel], dilation=[b.dilation],
                              residual=b.residual, separable=b.separable)
                         for b in MN_CFG.blocks])))
    _write_nemo(root / NEMO["msdd"],
                {k: v.numpy() for k, v in _synthetic_nemo_sd(seed=3).items()},
                {})
    return root


def statuses(results):
    return {name: st for name, st, _ in results}


def details(results):
    return {name: d for name, _, d in results}


def test_validator_passes_every_model_component_on_the_cpu(models_dir,
                                                           monkeypatch):
    """(a) Every model component PASSes; without --meetings-dir both
    pipeline components SKIP."""
    monkeypatch.setenv("NOTSOFAR_MODELS_DIR", str(models_dir))
    rc = V.main(["--models-dir", str(models_dir), "--whisper-model", "mini",
                 "--device", "cpu"])
    st = statuses(V.RESULTS)
    assert rc == 0, V.RESULTS
    assert [name for name, _, _ in V.RESULTS] == list(MODELS) + [
        "e2e-wer", "int8-wer-delta"]
    assert all(st[c] == "PASS" for c in MODELS), st
    assert st["e2e-wer"] == st["int8-wer-delta"] == "SKIP"


def test_validator_defaults_to_the_card():
    """No --device: the card, and without one it raises (no fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        V.main(["--models-dir", "."])


@pytest.mark.parametrize("component", ["css-mc", "titanet", "marblenet",
                                       "msdd"])
def test_validator_reports_corrupt_checkpoints(component, models_dir,
                                               tmp_path, monkeypatch):
    """(b) A garbage MC .pt, or a truncated .nemo, FAILs its component
    with rc 1; a component still intact PASSes beside it."""
    bad = tmp_path / "bad_models"
    shutil.copytree(models_dir / "notsofar", bad / "notsofar")
    if component == "css-mc":
        (bad / "notsofar" / "conformer1.0" / "mc" / "checkpoint.pt"
         ).write_bytes(b"not a checkpoint")
    else:
        data = (models_dir / NEMO[component]).read_bytes()
        (bad / NEMO[component]).write_bytes(data[:len(data) // 2])
    monkeypatch.setenv("NOTSOFAR_MODELS_DIR", str(bad))
    rc = V.main(["--models-dir", str(bad), "--device", "cpu"])
    st = statuses(V.RESULTS)
    assert rc == 1
    assert st[component] == "FAIL"
    assert st["css-sc"] == "PASS"
    if component != "css-mc":
        assert st["css-mc"] == "PASS"


class Spy:
    """Records what a wrapped function or method returns."""

    def __init__(self, monkeypatch, owner, name):
        self.out = []
        fn = getattr(owner, name)

        def spy(*a, **k):
            r = fn(*a, **k)
            self.out.append(r)
            return r
        monkeypatch.setattr(owner, name, spy)


def test_validator_numbers_match_the_jax_tool(models_dir, monkeypatch):
    """(c) The port's numbers against the JAX tool's check functions on
    the same directory: mask mean within 1e-5, TitaNet cross-cosine within
    1e-4, MSDD probabilities within 1e-5, MarbleNet speech fraction equal
    and both oracle rels below 1e-3; the same detail lines."""
    monkeypatch.setenv("NOTSOFAR_MODELS_DIR", str(models_dir))
    nemo = str(models_dir)
    masks = Spy(monkeypatch, JCssModel, "forward")
    embs = Spy(monkeypatch, jt.SpeakerEncoder, "embed")
    vad = Spy(monkeypatch, jm.FrameVAD, "__call__")
    probs = Spy(monkeypatch, jmsdd.OverlapDecoder, "refine")
    JV.RESULTS.clear()
    JV.check_css_mc(str(models_dir), None)
    JV.check_css_sc(str(models_dir), None)
    JV.check_titanet(nemo)
    JV.check_marblenet(nemo)
    JV.check_msdd(nemo)
    assert set(statuses(JV.RESULTS).values()) == {"PASS"}, JV.RESULTS

    V.RESULTS.clear()
    cpu = torch.device("cpu")
    got = {"css-mc": V.check_css_mc(str(models_dir), None, cpu),
           "css-sc": V.check_css_sc(str(models_dir), None, cpu),
           "titanet": V.check_titanet(nemo, cpu),
           "marblenet": V.check_marblenet(nemo, cpu),
           "msdd": V.check_msdd(nemo, cpu)}
    assert set(statuses(V.RESULTS).values()) == {"PASS"}, V.RESULTS

    for i, kind in enumerate(("css-mc", "css-sc")):
        want = np.asarray(masks.out[i]["spk_masks"])
        assert got[kind]["shape"] == want.shape
        assert abs(got[kind]["mean"] - float(want.mean())) < 1e-5, kind
    e = embs.out[0] / np.linalg.norm(embs.out[0], axis=1, keepdims=True)
    assert got["titanet"]["dim"] == e.shape[1]
    assert abs(got["titanet"]["cross_cos"] - float(e[0] @ e[1])) < 1e-4
    assert got["marblenet"]["speech_frac"] == float(np.mean(vad.out[0]))
    assert got["marblenet"]["mask_len"] == len(vad.out[0])
    jax_rel = float(details(JV.RESULTS)["marblenet"].split("rel ")[1]
                    .split(",")[0])
    assert got["marblenet"]["rel"] < 1e-3 and jax_rel < 1e-3
    np.testing.assert_allclose(got["msdd"]["probs"], probs.out[0],
                               rtol=0, atol=1e-5)
    # mask means and cross-cosines print to 3 decimals: equal lines
    for name in ("css-mc", "css-sc", "titanet", "msdd"):
        assert details(V.RESULTS)[name] == details(JV.RESULTS)[name], name


def write_conf(path, method):
    """test_torch_pipeline.py's pipeline settings as a --conf file, with
    inference_v1.yaml's embedding windows for word_nmesc."""
    diar = dict(method=method)
    if method == "word_nmesc":
        diar["min_embedding_windows"] = [3.0, 2.5, 2.0, 1.5, 1.0, 0.5]
    path.write_text(yaml.safe_dump(dict(
        asr=dict(model_name="tiny", max_new_tokens=24),
        css=dict(seg_bucket_multiple=4), diarization=diar)))
    return str(path)


class SilentStub(StubTranscriber):
    """A transcriber that hears nothing on any stream: no segment at all,
    or one segment without text or words (what a random-weight Whisper
    mostly emits)."""

    heard = "nothing"

    def transcribe(self, audio, sr=16000):
        segs = [dict(start=0.0, end=2.0, text="", tokens=[], words=[])] \
            if self.heard == "wordless" else []
        return dict(text="", segments=segs, language="en")

    def transcribe_batch(self, audios, timer=None):
        return [self.transcribe(a) for a in audios]


@pytest.mark.parametrize("method,heard", [
    ("by_wav_file_name", "gt"), ("word_nmesc", "nothing"),
    ("word_nmesc", "wordless")])
def test_e2e_wer_matches_the_jax_tool(method, heard, models_dir, tmp_path,
                                      monkeypatch):
    """(d) e2e-wer on tests/test_pipeline_e2e.py's meeting, the stub
    transcriber in both pipelines: the port's tcpWER / tcORC line equals
    the JAX tool's. With a transcriber that hears nothing, word_nmesc,
    the hypothesis writer and the scorer get through the empty ASR frame
    as the JAX pipeline does: no segment at all skips the session's WER
    row, segments without words score 1.0."""
    import notsofar_tpu.asr.inference as jasr
    import notsofar_tpu_torch.asr.inference as tasr
    meetings = tmp_path / "MTG"
    make_meeting(meetings)
    conf = write_conf(tmp_path / "conf.yaml", method)
    jstub, tstub = (StubTranscriber, BatchStub) if heard == "gt" else \
        (SilentStub, SilentStub)
    monkeypatch.setattr(SilentStub, "heard", heard)
    monkeypatch.setattr(jasr, "WhisperTranscriber", jstub)
    monkeypatch.setattr(tasr, "WhisperTranscriber", tstub)
    monkeypatch.setattr(jasr, "load_whisper_model", lambda *a, **k: [None] * 4)
    monkeypatch.setattr(tasr, "load_whisper_model", lambda *a, **k: [None] * 3)
    monkeypatch.setenv("NOTSOFAR_MODELS_DIR", str(models_dir))
    query = "is_mc == False"
    StubTranscriber.calls = 0
    JV.RESULTS.clear()
    JV.check_e2e(str(models_dir), str(meetings), str(tmp_path / "jax"),
                 query, conf)
    StubTranscriber.calls = 0
    V.RESULTS.clear()
    got = V.check_e2e(str(models_dir), str(meetings), str(tmp_path / "port"),
                      query, conf, torch.device("cpu"))
    want = details(JV.RESULTS)["e2e-wer"]
    assert statuses(JV.RESULTS)["e2e-wer"] == "PASS", want
    assert details(V.RESULTS)["e2e-wer"] == want
    if heard == "nothing":
        assert got["wer"] is None and want.startswith("pipeline ran (no GT")
        return
    assert want.startswith("tcpWER ")
    if heard != "gt":
        assert got["wer"].tcp_wer.iloc[0] == 1.0
        assert got["wer"].tcorc_wer.iloc[0] == 1.0


def test_marblenet_oracle_copy_is_bit_equal():
    """(e) The port's copy of torch_frame_logits equals the JAX tool's
    bit for bit on a seeded state and input."""
    rng = np.random.RandomState(5)
    sd = marblenet_nemo_sd(5)
    feats = rng.randn(2, MN_CFG.n_mels, 120).astype(np.float32)
    lengths = np.asarray([120, 77])
    want = joracle.torch_frame_logits(sd, MN_CFG, feats, lengths)
    got = toracle.torch_frame_logits(sd, MN_CFG, feats, lengths)
    assert got.dtype == want.dtype and np.array_equal(got, want)
