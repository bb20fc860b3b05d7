"""Milliseconds of device time a window in MVDR: the operations of the
traced call that start inside the StageTimer stage 'mvdr' (covariances,
solves, beamforming, the mask floor), over the windows a call runs
(CSS_COUNTS 'padded' over the window's calls: every call runs the same
plan)."""


def read(rec):
    tr, n = rec["trace"], rec["counters"].get("padded", 0)
    if tr is None or not n or not rec["calls"] or \
            not any(s[0] == "stage.mvdr" for s in tr.spans):
        return None
    t = tr.op_seconds(lambda _: True, span="stage.mvdr")
    return 1000.0 * t / (n / rec["calls"])
