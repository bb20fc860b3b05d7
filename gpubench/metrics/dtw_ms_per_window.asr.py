"""Milliseconds of host time a window in the word timings' DTW: the
program's stage.word_ts.dtw spans of the traced call (one a window,
around dtw_token_starts), over the windows a call aligns (DECODE_STEPS
align_windows over the window's calls: every call runs the same plan)."""


def read(rec):
    tr, n = rec["trace"], rec["counters"].get("align_windows", 0)
    if tr is None or not n or not rec["calls"]:
        return None
    us = [e - s for name, s, e in tr.spans if name == "stage.word_ts.dtw"]
    return sum(us) / 1000.0 / (n / rec["calls"]) if us else None
