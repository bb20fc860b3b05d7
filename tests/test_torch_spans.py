"""The port's profiler spans (utils.profiling.span) in the long-form ASR
call, on the CPU at small dims: every span the word timings and the
decode dispatches emit, each inside its stage's span and named
``stage.``; nothing entered while no profiler records; and the
align_windows counter."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from notsofar_tpu_torch.asr import decoding as tdec
from notsofar_tpu_torch.asr import transcribe as ttr
from notsofar_tpu_torch.asr.tokenizer import WhisperTokenizer
from notsofar_tpu_torch.models import whisper as tw
from notsofar_tpu_torch.utils import native as tnative
from notsofar_tpu_torch.utils import profiling

DIMS = (80, 1500, 128, 2, 1, 1864, 448, 128, 2, 2)
WORD_TS = {"stage.word_ts.pass", "stage.word_ts.readback",
           "stage.word_ts.dtw", "stage.word_ts.words"}
DISPATCH = {"stage.decode.prepare", "stage.decode.setup",
            "stage.decode.steps", "stage.decode.readback",
            "stage.decode.unpack"}
# every row fails the logprob gate (avg_logprob < 0), so both rungs run:
# beam search, then the sampler
OPTS = dict(beam_size=3, max_new_tokens=8, temperatures=(0.0, 0.4),
            logprob_threshold=0.0, no_speech_threshold=None,
            compression_ratio_threshold=None,
            hallucination_silence_threshold=None)
VARIANTS = {"batched": dict(),
            "serial": dict(batched_prompts=False),
            "lockstep": dict(condition_on_previous_text=False,
                             lockstep_decode=True)}


@pytest.fixture(scope="module")
def small():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    model = tw.WhisperModel(tw.WhisperDims(*DIMS), device="cpu").init(
        torch.Generator().manual_seed(0))
    tok = WhisperTokenizer(None, 256, multilingual=True, num_languages=99)
    yield model, tok
    torch.set_num_threads(threads)


def _streams(seconds, seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(int(s * 16000)) * 0.1).astype(np.float32)
            for s in seconds]


def _names(monkeypatch):
    """The names the program passes to torch.profiler.record_function."""
    names = []
    real = torch.profiler.record_function

    def spy(name, *a, **k):
        names.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    return names


def _inside(child, parents):
    return any(s <= child[0] and child[1] <= e for s, e in parents)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_transcribe_batch_emits_every_span_inside_its_stage(
        small, monkeypatch, variant):
    model, tok = small
    names = _names(monkeypatch)
    aligned = []
    real_batch = ttr.find_word_timestamps_batch
    monkeypatch.setattr(ttr, "find_word_timestamps_batch",
                        lambda m, t, xas, *a, **k: aligned.append(len(xas))
                        or real_batch(m, t, xas, *a, **k))
    tr = ttr.WhisperTranscriber(model, tok, ttr.TranscribeOptions(
        **OPTS, **VARIANTS[variant]))
    tdec.reset_decode_steps()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.transcribe_batch(_streams([34.0, 12.0]))
    assert names and all(n.startswith("stage.") for n in names)
    spans = {}
    for e in prof.events():
        if e.name in names:
            spans.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    want = WORD_TS | DISPATCH | {"stage.mel", "stage.encode",
                                 "stage.decode", "stage.word_ts"}
    if variant != "lockstep":
        want.add("stage.decode.gates")      # the lockstep path has no ladder
    assert set(spans) == want
    for name, ivs in spans.items():
        stage = name.rsplit(".", 1)[0]
        if stage != "stage":
            assert all(_inside(iv, spans[stage]) for iv in ivs), name
    # the parts of a stage are flat: none lies inside another
    parts = [(n, iv) for n, ivs in spans.items() if n.count(".") == 2
             for iv in ivs]
    for n, iv in parts:
        assert not any(_inside(iv, [o]) for _, o in parts if o != iv), n
    windows = sum(aligned) if variant != "serial" else \
        len(spans["stage.word_ts.dtw"])
    assert windows >= 3
    assert len(spans["stage.word_ts.dtw"]) == \
        len(spans["stage.word_ts.words"]) == windows
    assert tdec.DECODE_STEPS["align_windows"] == windows
    # one set of dispatch spans a decode call; no span per step
    assert len(spans["stage.decode.setup"]) == \
        len(spans["stage.decode.steps"]) == tdec.DECODE_STEPS["calls"]
    assert tdec.DECODE_STEPS["eager"] > len(spans["stage.decode.steps"])


def test_no_span_entered_while_no_profiler_records(small, monkeypatch):
    model, tok = small

    def entered(*a, **k):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        entered)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="entered"):
            with profiling.span("stage.x"):
                pass
    assert profiling.span("stage.a") is profiling.span("stage.b")
    timer = profiling.StageTimer()
    tr = ttr.WhisperTranscriber(model, tok, ttr.TranscribeOptions(**OPTS))
    tr.transcribe_batch(_streams([12.0, 8.0]), timer=timer)
    assert set(timer.stage_seconds) == {"mel", "encode", "decode",
                                        "word_ts"}


def test_align_windows_counts_the_windows_aligned(small):
    model, tok = small
    rng = np.random.RandomState(5)
    xas = [torch.from_numpy(rng.randn(1, 1500, 128).astype(np.float32)
                            * 0.2) for _ in range(3)]
    texts = [[300, 301, 302], [400, 401], list(range(500, 540))]
    tdec.reset_decode_steps()
    tdec.DECODE_STEPS.update(calls=4, hits=3, eager=17, replayed=5)
    before = dict(tdec.DECODE_STEPS)
    out = tdec.find_word_timestamps_batch(model, tok, xas, texts,
                                          [3000, 2000, 3000])
    assert len(out) == 3
    assert tdec.DECODE_STEPS["align_windows"] == 3
    # the windows whose DTW ran in the native core, where it loads
    native = tnative.load_native("dtw") is not None
    assert tdec.DECODE_STEPS["dtw_native"] == (3 if native else 0)
    counted = ("align_windows", "dtw_native")
    assert {k: tdec.DECODE_STEPS[k] for k in before
            if k not in counted} == \
        {k: v for k, v in before.items() if k not in counted}
    tdec.find_word_timestamps(model, tok, xas[0], texts[0], 3000)
    assert tdec.DECODE_STEPS["align_windows"] == 4
    tdec.reset_decode_steps()
    assert tdec.DECODE_STEPS["align_windows"] == 0
    assert tdec.DECODE_STEPS["dtw_native"] == 0
