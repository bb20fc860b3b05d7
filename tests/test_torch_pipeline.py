"""notsofar_tpu_torch's orchestration (load_meeting_data, session sharding,
run_inference_gpu's configs, inference_pipeline) against the JAX package,
on the CPU.

The pipeline runs end to end on the synthetic meeting of
tests/test_pipeline_e2e.py with the same tiny SC CSS weights on both sides
and the same stub transcriber (ASR output independent of the audio, so
the hypothesis files and WER rows must be equal), and on the accuracy
fixture of tests/test_e2e_accuracy.py (a trained tiny CSS model and a
band-energy transcriber), where separation through the port must bring
tcORC-WER to 0.10 or less.
"""
import dataclasses
import json

import numpy as np
import pandas as pd
import pytest
import torch

import run_inference_gpu
from notsofar_tpu.inference_pipeline import inference as jinf
from notsofar_tpu.inference_pipeline import load_meeting_data as jload
from notsofar_tpu.utils.conf import load_yaml_to_dataclass as j_load_yaml
from notsofar_tpu_torch.inference_pipeline import inference as tinf
from notsofar_tpu_torch.inference_pipeline import load_meeting_data as tload
from notsofar_tpu_torch.parallel.mesh import shard_sessions
from tests.test_e2e_accuracy import (FIXTURE, BandTranscriber,
                                     make_band_meeting)
from tests.test_pipeline_e2e import (StubTranscriber, make_meeting,
                                     make_sc_css_model)
from tests.test_torch_whisper import torch_threads  # noqa: F401


class BatchStub(StubTranscriber):
    """The stub transcriber with the batched entry the port's ASR calls."""

    def transcribe_batch(self, audios, timer=None):
        return [self.transcribe(a) for a in audios]


class BatchBand(BandTranscriber):
    def transcribe_batch(self, audios, timer=None):
        return [self.transcribe(a) for a in audios]


def test_load_data_contract(tmp_path):
    """Sessions (close-talk excluded), GT utterances and metadata equal to
    the JAX package's, with and without a session query."""
    make_meeting(tmp_path / "MTG")
    make_meeting(tmp_path / "MTG", meeting_id="MTG_9002", seconds=5)
    for query in (None, "is_mc == False ##and index<1##", "is_mc == True"):
        want = jload.load_data(str(tmp_path / "MTG"), session_query=query)
        got = tload.load_data(str(tmp_path / "MTG"), session_query=query)
        for g, w in zip(got, want):
            pd.testing.assert_frame_equal(g, w)
    sessions = got[0]
    assert len(sessions) == 0
    sessions, gt, meta = tload.load_data(str(tmp_path / "MTG"))
    assert list(sessions.session_id) == ["singlechannel/MTG_9001_sc0",
                                         "singlechannel/MTG_9002_sc0"]
    assert isinstance(sessions.wav_file_names.iloc[0], list)
    assert len(gt) == 4 and len(meta) == 2


def test_close_talk_mode_matches_jax(tmp_path):
    make_meeting(tmp_path / "MTG")
    want = jload.load_data(str(tmp_path / "MTG"), return_close_talk=True,
                           out_dir=str(tmp_path / "jax"))
    got = tload.load_data(str(tmp_path / "MTG"), return_close_talk=True,
                          out_dir=str(tmp_path / "port"))
    assert got[0].session_id.tolist() == ["close_talk/MTG_9001"]
    pd.testing.assert_frame_equal(got[1], want[1])


@pytest.mark.parametrize("rank,world", [(0, 1), (0, 3), (2, 3), (4, 3)])
def test_shard_sessions_with_rank_and_world(rank, world):
    got = shard_sessions(10, rank, world)
    assert got == list(range(rank, 10, world))
    assert sorted(sum((shard_sessions(10, r, world) for r in range(world)),
                      [])) == list(range(10))


def test_shard_sessions_reads_the_process_group(tmp_path):
    """With no rank given, the torch.distributed group's rank and world
    size decide; without a group, (0, 1)."""
    import torch.distributed as dist
    assert shard_sessions(5) == [0, 1, 2, 3, 4]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        assert shard_sessions(5) == [0, 1, 2, 3, 4]
        assert shard_sessions(5, process_count=2) == [0, 2, 4]
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name,yaml,query", [
    ("full_dev_set_mc", "inference_v1.yaml", "is_mc == True"),
    ("full_dev_set_sc", "inference_v1.yaml", "is_mc == False"),
    ("dev_set_mc_debug", "debug_inference.yaml",
     'device_name == "plaza_0" and is_mc == True and '
     'meeting_id == "MTG_30860"')])
def test_load_config_for_the_three_names(name, yaml, query):
    """run_inference_gpu.load_config reads the YAML that run_inference.py
    reads for the name; every value the JAX package's loader gives for
    the same file is the port's."""
    cfg = run_inference_gpu.load_config(name)
    assert cfg.session_query == query
    want = j_load_yaml(str(run_inference_gpu.get_project_root() / "configs"
                           / "inference" / yaml), jinf.InferenceCfg)
    for section in ("css", "asr", "diarization", "scoring"):
        w = dataclasses.asdict(getattr(want, section))
        g = dataclasses.asdict(getattr(cfg, section))
        assert {k: g[k] for k in w if k in g} == \
            {k: w[k] for k in w if k in g}, section
    assert cfg.asr.text_normalizer()("It costs $20") == \
        want.asr.text_normalizer()("It costs $20")


def _pipeline_cfg(cfg_type):
    cfg = cfg_type()
    cfg.asr.model_name = "tiny"
    cfg.asr.max_new_tokens = 24
    cfg.diarization.method = "by_wav_file_name"
    cfg.css.seg_bucket_multiple = 4
    return cfg


def test_pipeline_matches_jax(tmp_path, monkeypatch):
    """CSS (tiny SC model, the same weights) -> ASR (the stub) ->
    by_wav_file_name diarization -> hypothesis jsons -> tcpWER/tcORC-WER:
    every contract file exists, the hypothesis and submission jsons are
    the JAX pipeline's, and so are the WER rows."""
    import notsofar_tpu.asr.inference as jasr
    import notsofar_tpu_torch.asr.inference as tasr
    meetings = tmp_path / "MTG"
    make_meeting(meetings)
    models_dir = tmp_path / "models"
    make_sc_css_model(models_dir)
    monkeypatch.setattr(jasr, "WhisperTranscriber", StubTranscriber)
    monkeypatch.setattr(tasr, "WhisperTranscriber", BatchStub)
    # the stub needs no Whisper model
    monkeypatch.setattr(jasr, "load_whisper_model", lambda *a, **k: [None] * 4)
    monkeypatch.setattr(tasr, "load_whisper_model", lambda *a, **k: [None] * 3)

    StubTranscriber.calls = 0
    want = jinf.inference_pipeline(str(meetings), str(models_dir),
                                   str(tmp_path / "jax"),
                                   _pipeline_cfg(jinf.InferenceCfg),
                                   jinf.FetchFromCacheCfg())
    StubTranscriber.calls = 0
    got = tinf.inference_pipeline(str(meetings), str(models_dir),
                                  str(tmp_path / "port"),
                                  _pipeline_cfg(tinf.InferenceCfg),
                                  tinf.FetchFromCacheCfg(), device="cpu")
    assert StubTranscriber.calls == 3

    sid = "singlechannel/MTG_9001_sc0"
    out = tmp_path / "port"
    assert sorted(p.name for p in (out / "css_inference" / sid).glob(
        "sep_stream*.wav")) == [f"sep_stream{k}.wav" for k in range(3)]
    assert (out / "asr" / sid / "tiny" / "all_segments_df.pkl").exists()
    for rel in (f"wer/{sid}/tcp_wer_hyp.json", f"wer/{sid}/tc_orc_wer_hyp.json",
                "wer/singlechannel/tcp_wer_hyp.json",
                "wer/singlechannel/tc_orc_wer_hyp.json"):
        assert json.loads((out / rel).read_text()) == \
            json.loads((tmp_path / "jax" / rel).read_text()), rel
    assert (out / "wer" / "css_tiny_by_wav_file_name_results.csv").exists()
    cols = [c for c in want.columns if not c.endswith("_hyp_json")]
    pd.testing.assert_frame_equal(got[cols], want[cols])
    assert np.isfinite(got.tcp_wer.iloc[0]) and \
        np.isfinite(got.tcorc_wer.iloc[0])


def test_pipeline_accuracy_through_the_port(tmp_path, monkeypatch):
    """The trained tiny SC CSS fixture separates the band meeting through
    the port's CSS engine; the band-energy transcriber then hears one band
    per stream, so tcORC-WER <= 0.10 (ROADMAP A.9's acceptance), tcpWER
    <= 0.40 and both words in GT proportion, as in the JAX package's
    test."""
    import notsofar_tpu_torch.asr.inference as tasr
    meetings = tmp_path / "MTG"
    make_band_meeting(meetings)
    monkeypatch.setattr(tasr, "WhisperTranscriber", BatchBand)
    monkeypatch.setattr(tasr, "load_whisper_model", lambda *a, **k: [None] * 3)
    cfg = _pipeline_cfg(tinf.InferenceCfg)
    cfg.css.checkpoint_sc = "css_tiny_trained"
    cfg.css.activity_th = 0.02     # band-limited masks (see the JAX test)
    out_dir = tmp_path / "out"
    wer_df = tinf.inference_pipeline(str(meetings), str(FIXTURE.parent),
                                     str(out_dir), cfg,
                                     tinf.FetchFromCacheCfg(), device="cpu")
    assert wer_df is not None and len(wer_df) == 1
    row = wer_df.iloc[0]
    assert row.tcorc_wer <= 0.10, row.tcorc_wer
    assert row.tcp_wer <= 0.40, row.tcp_wer
    hyp = json.loads((out_dir / "wer" / "singlechannel/MTG_7001_sc0"
                      / "tcp_wer_hyp.json").read_text())
    words = " ".join(seg["words"] for seg in hyp).split()
    assert 8 <= len(words) <= 16, words
    assert 4 <= sum(w == "low" for w in words) <= 8, words
    assert 4 <= sum(w == "high" for w in words) <= 8, words


def test_entry_point_needs_a_card_unless_told_cpu(tmp_path):
    """run_inference_gpu runs on cuda by default: without a card the
    pipeline raises at its first model instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    meetings = tmp_path / "MTG"
    make_meeting(meetings)
    models_dir = tmp_path / "models"
    make_sc_css_model(models_dir)
    cfg = _pipeline_cfg(tinf.InferenceCfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinf.inference_pipeline(str(meetings), str(models_dir),
                                str(tmp_path / "out"), cfg,
                                tinf.FetchFromCacheCfg())
