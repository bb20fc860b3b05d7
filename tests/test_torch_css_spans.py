"""The CSS engine's profiler spans, its counters (``CSS_COUNTS``) and its
taps, on the CPU with a small Conformer: each span once per call (the
per-chunk stages' once per chunk), the counts of a two-session call as planned, and the
streams bit-equal with and without the profiler and the taps."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from notsofar_tpu_torch.css import engine as E
from notsofar_tpu_torch.models import conformer as tc
from notsofar_tpu_torch.models import css_wrapper as tw

SMALL = tc.ConformerConfig(attention_dim=16, attention_heads=2,
                           linear_units=32, num_blocks=1, kernel_size=5,
                           dropout_rate=0.0)
FS = 16000
# two sessions of 5 s: 311 frames, 3 windows each; a bucket of 4 windows
# a session, so 8 windows run in 2 chunks of 4
PLAN = dict(calls=1, sessions=2, windows=6, padded=8, chunks=2,
            systems=8 * 3 * 257)
ONCE = ("stage.css.prepare", "stage.css.upload", "stage.stitch.chain")


@pytest.fixture(scope="module")
def engine():
    model = tw.CssModel(tw.ConformerCssConfig(
        nnet_conf=tw.NnetConfig(conformer_conf=SMALL)), device="cpu", seed=3)
    return E.CssEngine(model, E.CssCfg(seg_chunk=4, seg_bucket_multiple=4,
                                       activity_th=0.3))


@pytest.fixture(scope="module")
def mixes():
    rng = np.random.RandomState(21)
    return [(rng.randn(1, 5 * FS, 7) * 0.1).astype(np.float32)
            for _ in range(2)]


def _events(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    names = [e.name for e in prof.events()]
    return out, {n: names.count(n) for n in set(names)}


def test_spans_once_per_call_and_mvdr_once_per_chunk(engine, mixes):
    _, seen = _events(lambda: engine.separate_sessions_batch(mixes, FS))
    for name in ONCE:
        assert seen.get(name) == 1, (name, seen.get(name))
    # the scales' read, then the lazy list's copy of the streams
    assert seen.get("stage.css.readback") == 2
    assert seen.get("stage.mvdr.scm") == PLAN["chunks"]
    assert seen.get("stage.mvdr.solve") == PLAN["chunks"]
    # without a StageTimer each device stage is still its span
    for name in ("stage.features", "stage.conformer", "stage.mvdr"):
        assert seen.get(name) == PLAN["chunks"], (name, seen.get(name))
    for name in ("stage.stft", "stage.stitch", "stage.istft"):
        assert seen.get(name) == 1, (name, seen.get(name))


def test_no_span_without_a_profiler(engine, mixes, monkeypatch):
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or real(name))
    engine.separate_sessions_batch(mixes, FS)
    assert opened == []


def test_counts_of_a_two_session_call(engine, mixes):
    E.reset_css_counts()
    engine.separate_sessions_batch(mixes, FS)
    assert E.CSS_COUNTS == PLAN
    E.reset_css_counts()
    assert set(E.CSS_COUNTS.values()) == {0}


def test_profiler_and_taps_leave_the_streams_bit_equal(engine, mixes):
    plain = engine.separate_sessions_batch(mixes, FS)
    traced, _ = _events(lambda: engine.separate_sessions_batch(mixes, FS))
    kinds = []
    engine.taps = lambda kind, **kw: kinds.append(kind)
    try:
        tapped = engine.separate_sessions_batch(mixes, FS)
    finally:
        engine.taps = None
    assert kinds == ["chunk"] * PLAN["chunks"] + ["stitch", "gate"]
    for other in (traced, tapped):
        for a, b in zip(plain, other):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
