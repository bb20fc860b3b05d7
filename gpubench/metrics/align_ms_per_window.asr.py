"""Milliseconds of device time a window in the word-timing pass: the
operations of the traced call that start inside the program's spans
stage.word_ts.pass (the alignment pass's launches) or
stage.word_ts.readback (the host's wait on its read-back), over the
windows a call aligns (DECODE_STEPS align_windows over the window's
calls: every call runs the same plan)."""

SPANS = ("stage.word_ts.pass", "stage.word_ts.readback")


def read(rec):
    tr, n = rec["trace"], rec["counters"].get("align_windows", 0)
    if tr is None or not n or not rec["calls"] or \
            not any(s[0] in SPANS for s in tr.spans):
        return None
    t = sum(tr.op_seconds(lambda _: True, span=s) for s in SPANS)
    return 1000.0 * t / (n / rec["calls"])
