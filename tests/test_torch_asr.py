"""notsofar_tpu_torch's ASR path (decoding, beam search, word timestamps,
long-form transcription, asr_inference) against the JAX package, on the
CPU, at kernel dims (dk=64) so both sides run their kernel paths:
attn_step for greedy steps, attn_step_split with the ancestry matrix for
beam steps, encoder_mha in the encoder. f32 weights from the JAX model's
init; inputs from numpy seeds. Sampling (temperature > 0) cannot match
JAX's threefry bits, so the comparisons run at temperature 0 and the
sampler is checked against its own per-row contract.
"""
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.io.wavfile as wf
import torch

from notsofar_tpu.asr import beam as jbeam
from notsofar_tpu.asr import decoding as jdec
from notsofar_tpu.asr import inference as jinf
from notsofar_tpu.asr import transcribe as jtr
from notsofar_tpu_torch.asr import beam as tbeam
from notsofar_tpu_torch.asr import decoding as tdec
from notsofar_tpu_torch.asr import inference as tinf
from notsofar_tpu_torch.asr import transcribe as ttr
from notsofar_tpu_torch.models import whisper as tw
from tests.test_torch_whisper import (KDIMS_ARGS, mini_tokenizers,  # noqa
                                      pair, torch_threads)

# a word's start/end may move by one 20 ms DTW frame: the JAX package runs
# the DTW on device in f32, the port on the host in float64, and razor
# ties can break the other way
WORD_TIME_TOL = 0.02 + 1e-6


def _xa(seed, B, S=96):
    return np.random.RandomState(seed).randn(B, S, 128).astype(
        np.float32) * 0.2


def _assert_same_decode(t, j, lp_tol=1e-4):
    assert t["tokens"] == j["tokens"]
    np.testing.assert_allclose(t["avg_logprob"], j["avg_logprob"],
                               atol=lp_tol)
    np.testing.assert_allclose(t["no_speech_prob"], j["no_speech_prob"],
                               atol=1e-5)


def test_greedy_decode_and_decode_prompted_match_jax(pair):  # noqa: F811
    """Greedy tokens equal; avg_logprob within 1e-4 (f32)."""
    jm, variables, tm = pair
    jt, tt = mini_tokenizers()
    opts = dict(max_new_tokens=10)
    jd = jdec.GreedyDecoder(jm, jt, jdec.DecodeOptions(**opts))
    td = tdec.GreedyDecoder(tm, tt, tdec.DecodeOptions(**opts))
    xa = _xa(6, 3)
    _assert_same_decode(td.decode(torch.from_numpy(xa)),
                        jd.decode(variables, jnp.asarray(xa)))
    prompts = [None, [5, 6, 7], list(range(40, 70))]
    _assert_same_decode(
        td.decode_prompted(torch.from_numpy(xa), prompts),
        jd.decode_prompted(variables, jnp.asarray(xa), prompts))


def test_beam3_decode_prompted_matches_jax(pair):  # noqa: F811
    """Beam K=3 over the split cache with the ancestry matrix (f32 caches
    on both sides): tokens equal, avg_logprob within 1e-4."""
    jm, variables, tm = pair
    jt, tt = mini_tokenizers()
    opts = dict(max_new_tokens=8)
    jd = jbeam.BeamDecoder(jm, jt, jdec.DecodeOptions(**opts), beam_size=3,
                           cache_dtype=jnp.float32)
    td = tbeam.BeamDecoder(tm, tt, tdec.DecodeOptions(**opts), beam_size=3,
                           cache_dtype=torch.float32)
    xa = _xa(7, 2)
    prompts = [[300, 301, 302], [400]]
    _assert_same_decode(
        td.decode_prompted(torch.from_numpy(xa), prompts),
        jd.decode_prompted(variables, jnp.asarray(xa), prompts))


def test_beam_unified_cache_matches_split_cache(pair):  # noqa: F811
    """The gathered unified-cache beam path equals the split-cache one."""
    _, _, tm = pair
    _, tt = mini_tokenizers()
    opts = tdec.DecodeOptions(max_new_tokens=8)
    xa = torch.from_numpy(_xa(8, 2))
    prompts = [[300, 301], None]
    split = tbeam.BeamDecoder(tm, tt, opts, beam_size=3,
                              cache_dtype=torch.float32)
    unified = tbeam.BeamDecoder(tm, tt, opts, beam_size=3,
                                cache_dtype=torch.float32,
                                split_cache=False)
    _assert_same_decode(unified.decode_prompted(xa, prompts),
                        split.decode_prompted(xa, prompts), lp_tol=1e-5)


def test_sampling_rows_draw_as_single_decodes(pair):  # noqa: F811
    """Row b of a batched sampled decode equals a B=1 decode with the same
    generator: the per-(seek, rung) seeding contract."""
    _, _, tm = pair
    _, tt = mini_tokenizers()
    td = tdec.GreedyDecoder(tm, tt, tdec.DecodeOptions(max_new_tokens=8))
    xa = torch.from_numpy(_xa(9, 2))
    prompts = [[7, 8], None]
    batched = td.decode_prompted(
        xa, prompts, temperature=0.6,
        generators=[ttr.fallback_generator(s, 2, xa.device)
                    for s in (0, 3000)])
    for r, seek in enumerate((0, 3000)):
        single = td.decode_prompted(
            xa[r:r + 1], prompts[r:r + 1], temperature=0.6,
            generators=[ttr.fallback_generator(seek, 2, xa.device)])
        assert batched["tokens"][r] == single["tokens"][0]


def test_detect_language_matches_jax(pair):  # noqa: F811
    jm, variables, tm = pair
    jt, tt = mini_tokenizers()
    xa = _xa(10, 2)
    assert tdec.detect_language(tm, tt, torch.from_numpy(xa)) == \
        jdec.detect_language(jm, variables, jt, jnp.asarray(xa))


def test_word_timestamps_match_jax(pair):  # noqa: F811
    """Teacher-forced alignment + DTW, all-heads and head-selection paths:
    word text equal, times within one DTW frame (0.02 s), probabilities
    within 1e-4."""
    jm, variables, tm = pair
    jt, tt = mini_tokenizers()
    rng = np.random.RandomState(5)
    xa = [rng.randn(1, 1500, 128).astype(np.float32) * 0.05
          for _ in range(3)]
    toks = [tt.encode(" hello world"),
            tt.encode(" a much longer utterance with many more tokens"),
            tt.encode(" ok")]
    frames = [3000, 2400, 1200]
    for heads in (None, [(0, 1), (1, 0)]):
        want = jdec.find_word_timestamps_batch(
            jm, variables, jt, [jnp.asarray(x) for x in xa], toks, frames,
            alignment_heads=heads, merge=False)
        got = tdec.find_word_timestamps_batch(
            tm, tt, [torch.from_numpy(x) for x in xa], toks, frames,
            alignment_heads=heads, merge=False)
        for g, w in zip(got, want):
            assert [x["word"] for x in g] == [x["word"] for x in w]
            for a, b in zip(g, w):
                assert abs(a["start"] - b["start"]) <= WORD_TIME_TOL
                assert abs(a["end"] - b["end"]) <= WORD_TIME_TOL
                assert abs(a["probability"] - b["probability"]) < 1e-4


@pytest.mark.parametrize("seed", [3, 4])
def test_dtw_matches_the_jax_reference_dp(seed):
    """The port's wavefront float64 DTW returns the JAX package's numpy
    reference path exactly, and the same per-row first frames."""
    rng = np.random.RandomState(seed)
    cost = rng.randn(17, 40)
    ti, tj = tdec.dtw_path(cost)
    ri, rj = jdec._dtw_path_numpy(cost)
    np.testing.assert_array_equal(ti, ri)
    np.testing.assert_array_equal(tj, rj)
    starts = tdec.dtw_token_starts(cost, 17, 40)
    first = {}
    for a, b in zip(ri, rj):
        first.setdefault(int(a), int(b))
    assert starts.tolist() == [float(first[i]) for i in range(17)]


@pytest.mark.parametrize("tokens", [
    [1800, 10, 11, 1810, 1810, 20, 1820],          # pair + single ending
    [1800, 10, 11, 1810, 1811, 20, 21],            # unfinished tail
    [10, 11, 12],                                  # no timestamps
    [1800, 10, 1850],                              # one segment, ts end
])
def test_parse_segments_matches_jax(tokens):
    _, tt = mini_tokenizers()
    ts = tt.timestamp_begin
    toks = [t - 1800 + ts if t >= 1800 else t for t in tokens]
    want = jtr.parse_segments(toks, ts, 12.0, 2500, tt.decode)
    got = ttr.parse_segments(toks, ts, 12.0, 2500, tt.decode)
    assert got == want


def _synthetic_streams(seconds):
    rng = np.random.RandomState(13)
    out = []
    for s in seconds:
        n = int(s * 16000)
        t = np.arange(n) / 16000
        x = 0.02 * rng.randn(n) + 0.1 * np.sin(2 * np.pi * 140 * t) * \
            (np.sin(2 * np.pi * 0.3 * t) > 0)
        out.append(x.astype(np.float32))
    return out


def test_transcribe_batch_matches_jax(pair):  # noqa: F811
    """The slice as a whole: long-form transcription of 2 streams of
    about 35 s (several windows each, condition_on_previous_text with
    batched prompts, word timestamps, hallucination rules) at temperature
    0. The token embedding is scaled x10 in both packages so the random
    model's logits are peaked enough to emit text and timestamps. Texts
    and segment tokens equal; segment and word times within one DTW
    frame."""
    jm, variables, _ = pair
    jt, tt = mini_tokenizers()
    dec = dict(variables["decoder"]["params"])
    dec["token_embedding"] = dec["token_embedding"] * 10.0
    sharp = dict(variables, decoder={"params": dec})
    tm = tw.WhisperModel(tw.WhisperDims(*KDIMS_ARGS), device="cpu")
    tm.load_state_dict(tw.variables_from_jax(sharp))
    opts = dict(temperatures=(0.0,), max_new_tokens=24,
                logprob_threshold=None, no_speech_threshold=None)
    audios = _synthetic_streams([35.0, 33.5])
    want = jtr.WhisperTranscriber(jm, sharp, jt, jtr.TranscribeOptions(
        **opts)).transcribe_batch([a.copy() for a in audios])
    got = ttr.WhisperTranscriber(tm, tt, ttr.TranscribeOptions(
        **opts)).transcribe_batch([a.copy() for a in audios])
    n_segments = n_words = 0
    for g, w in zip(got, want):
        assert g["text"] == w["text"]
        assert len(g["segments"]) == len(w["segments"])
        for sg, sw in zip(g["segments"], w["segments"]):
            n_segments += 1
            assert sg["tokens"] == sw["tokens"]
            assert abs(sg["start"] - sw["start"]) <= WORD_TIME_TOL
            assert abs(sg["end"] - sw["end"]) <= WORD_TIME_TOL
            assert [x["word"] for x in sg["words"]] == \
                [x["word"] for x in sw["words"]]
            for a, b in zip(sg["words"], sw["words"]):
                n_words += 1
                assert abs(a["start"] - b["start"]) <= WORD_TIME_TOL
                assert abs(a["end"] - b["end"]) <= WORD_TIME_TOL
    assert n_segments >= 8 and n_words >= 2


@pytest.mark.parametrize("variant", ["serial", "lockstep"])
def test_transcribe_paths_agree(pair, variant):  # noqa: F811
    """The port's other long-form paths give the default path's result at
    temperature 0: per-stream serial decodes (batched_prompts=False) with
    condition_on_previous_text, and one lockstep decode per iteration
    without it (as the JAX package's own tests pin for its paths)."""
    _, _, tm = pair
    _, tt = mini_tokenizers()
    base = dict(temperatures=(0.0,), max_new_tokens=10,
                logprob_threshold=None, no_speech_threshold=None)
    if variant == "serial":
        a_opts = dict(batched_prompts=False)
        b_opts = dict()
    else:
        base["condition_on_previous_text"] = False
        a_opts = dict(lockstep_decode=True)
        b_opts = dict(batched_prompts=False)
    audios = _synthetic_streams([8.0, 5.0])
    a = ttr.WhisperTranscriber(tm, tt, ttr.TranscribeOptions(
        **base, **a_opts)).transcribe_batch(audios)
    b = ttr.WhisperTranscriber(tm, tt, ttr.TranscribeOptions(
        **base, **b_opts)).transcribe_batch(audios)
    for ra, rb in zip(a, b):
        assert ra["text"] == rb["text"]
        assert [s["tokens"] for s in ra["segments"]] == \
            [s["tokens"] for s in rb["segments"]]
        assert [[(w["start"], w["end"]) for w in s["words"]]
                for s in ra["segments"]] == \
            [[(w["start"], w["end"]) for w in s["words"]]
             for s in rb["segments"]]


def _write_checkpoint(models_dir, model, name="tiny"):
    """An openai-format checkpoint of `model` at models_dir/whisper/name.pt
    (the loader takes the dims from the file, so a small model can serve
    under a zoo name)."""
    import dataclasses
    d = models_dir / "whisper"
    d.mkdir(parents=True, exist_ok=True)
    sd = {k: v for k, v in model.state_dict().items()
          if k != "encoder.positional_embedding"}
    torch.save(dict(dims=dataclasses.asdict(model.dims),
                    model_state_dict=sd), str(d / f"{name}.pt"))
    return str(models_dir)


def test_asr_inference_writes_the_jax_layout(tmp_path, pair):  # noqa: F811
    """asr_inference on a 2-stream session (a kernel-dims checkpoint, on
    the CPU): the JAX package's dataframe columns, and the per-session
    pickle cache that a second call with fetch_from_cache reads back."""
    models_dir = _write_checkpoint(tmp_path / "models", pair[2])
    names = []
    for i, a in enumerate(_synthetic_streams([4.0, 3.0])):
        p = tmp_path / f"sep_stream{i}.wav"
        wf.write(p, 16000, (a * 32767).astype(np.int16))
        names.append(str(p))
    session = pd.Series(dict(session_id="sess0", meeting_id="MTG_0",
                             sep_wav_file_names=names))
    cfg = tinf.WhisperAsrCfg(model_name="tiny", max_new_tokens=4,
                             beam_size=2, compute_dtype="float32")
    df = tinf.asr_inference(str(tmp_path / "out"), session, cfg,
                            fetch_from_cache=False, models_dir=models_dir,
                            device="cpu")
    ref_cols = list(jinf._results_to_df(session, names[:1], [dict(
        segments=[dict(start=0.0, end=1.0, text="x", words=[])])]).columns)
    assert list(df.columns) == ref_cols
    assert len(df) > 0 and set(df.wav_file_name) <= set(names)
    pkl = tmp_path / "out" / "asr" / "sess0" / "tiny" / "all_segments_df.pkl"
    assert pkl.exists()
    again = tinf.asr_inference(str(tmp_path / "out"), session, cfg,
                               fetch_from_cache=True, models_dir=models_dir,
                               device="cpu")
    pd.testing.assert_frame_equal(again, df)


def test_asr_batch_prepass_fills_the_session_caches(tmp_path,
                                                    pair):  # noqa: F811
    """Streams of two sessions transcribed in one cross-session batch land
    in each session's pickle cache, which asr_inference then reads."""
    models_dir = _write_checkpoint(tmp_path / "models", pair[2])
    sessions = []
    audio = _synthetic_streams([3.0, 2.0, 2.5])
    for si, idx in enumerate(([0, 1], [2])):
        names = []
        for i in idx:
            p = tmp_path / f"s{si}_stream{i}.wav"
            wf.write(p, 16000, (audio[i] * 32767).astype(np.int16))
            names.append(str(p))
        sessions.append(pd.Series(dict(session_id=f"sess{si}",
                                       meeting_id=f"MTG_{si}",
                                       sep_wav_file_names=names)))
    cfg = tinf.WhisperAsrCfg(model_name="tiny", max_new_tokens=4,
                             beam_size=None, batch_streams=3,
                             compute_dtype="float32")
    out = str(tmp_path / "out")
    tinf.asr_batch_prepass(out, sessions, cfg, fetch_from_cache=False,
                           models_dir=models_dir, device="cpu")
    for s in sessions:
        pkl = tmp_path / "out" / "asr" / s.session_id / "tiny" / \
            "all_segments_df.pkl"
        assert pkl.exists()
        df = tinf.asr_inference(out, s, cfg, fetch_from_cache=True,
                                models_dir=models_dir, device="cpu")
        pd.testing.assert_frame_equal(df, pd.read_pickle(pkl))
        assert set(df.session_id) <= {s.session_id}


def test_checkpoint_and_alignment_heads_load_like_jax(tmp_path, pair):  # noqa: F811
    """load_whisper_model finds {models_dir}/whisper/<name>.pt and its
    alignment-heads sidecar (pairs or whisper's base85 blob) as the JAX
    package does; the loaded weights are the checkpoint's."""
    import json
    _, _, tm = pair
    _write_checkpoint(tmp_path, tm, "kdims")
    ckpt = tmp_path / "whisper" / "kdims.pt"
    side = ckpt.with_suffix(".alignment_heads.json")
    for content in ([[1, 0], [0, 1]],
                    dict(blob=jdec.encode_alignment_heads(
                        [(1, 1)], tm.dims.n_text_layer,
                        tm.dims.n_text_head))):
        side.write_text(json.dumps(content))
        assert tinf._load_alignment_heads(ckpt, tm.dims) == \
            jinf._load_alignment_heads(ckpt, tm.dims)
    model, _, heads = tinf.load_whisper_model(
        "kdims", str(tmp_path), compute_dtype="float32", device="cpu")
    assert heads == [(1, 1)]
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, tm.state_dict()[k], rtol=0, atol=0)
