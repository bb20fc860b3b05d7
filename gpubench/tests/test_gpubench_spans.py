"""The readers of the program's span metrics on a hand-built trace:
align_ms_per_window.asr, dtw_ms_per_window.asr and
decode_host_ms_per_dispatch.asr."""
import pytest

from gpubench import harness

# one traced call of 0-100 ms (us); spans and operations by hand
SPANS = [
    ("stage.word_ts", 10_000, 60_000),
    ("stage.word_ts.pass", 10_000, 12_000),
    ("stage.word_ts.readback", 12_000, 20_000),
    ("stage.word_ts.dtw", 20_000, 23_000),
    ("stage.word_ts.words", 23_000, 24_000),
    ("stage.word_ts.dtw", 24_000, 29_000),
    ("stage.word_ts.words", 29_000, 30_000),
    ("stage.decode", 60_000, 100_000),
    ("stage.decode.prepare", 60_000, 61_000),
    ("stage.decode.setup", 61_000, 62_000),
    ("stage.decode.steps", 62_000, 90_000),
    ("stage.decode.readback", 90_000, 95_000),
    ("stage.decode.unpack", 95_000, 97_000),
    ("stage.decode.gates", 97_000, 98_500),
]
OPS = [
    ("median", 10_500, 14_500),      # launched in the pass: 4 ms
    ("softmax", 11_000, 11_500),     # 0.5 ms
    ("neg", 12_100, 12_600),         # launched in the read-back: 0.5 ms
    ("copy", 20_500, 20_700),        # launched in the DTW: not counted
    ("decode_gemv", 62_500, 89_000),
]


def _rec(counters, calls=2, trace=True):
    tr = harness.Trace(OPS, SPANS + [(harness.CALL_SPAN, 0, 100_000)],
                       0, 100_000) if trace else None
    return dict(trace=tr, counters=counters, calls=calls)


@pytest.mark.parametrize("name, counters, want", [
    # 5 ms of device time over 4 / 2 windows a call
    ("align_ms_per_window.asr", dict(align_windows=4), 2.5),
    # 3 + 5 ms of host DTW over 2 windows a call
    ("dtw_ms_per_window.asr", dict(align_windows=4), 4.0),
    # 1 + 2 + 1.5 ms over 3 dispatches a call
    ("decode_host_ms_per_dispatch.asr", dict(calls=6), 1.5),
])
def test_reader_on_a_hand_built_trace(name, counters, want):
    read = harness.metric_reader(name)
    assert read(_rec(counters)) == pytest.approx(want)
    assert read(_rec(counters, trace=False)) is None
    assert read(_rec({k: 0 for k in counters})) is None
    # the parent's program: no such counter or span
    assert read(_rec({})) is None
    bare = _rec(counters)
    bare["trace"].spans = [s for s in bare["trace"].spans
                           if s[0].count(".") < 2]
    assert read(bare) is None
