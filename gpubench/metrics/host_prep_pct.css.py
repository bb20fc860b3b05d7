"""Share of the traced call that the host spends in the CSS engine's
host work: the spans stage.css.prepare (int16 quantisation, padding,
overlap-add weights), stage.css.upload (the copies in) and
stage.css.readback (the scales' read and the streams' host copy), less
the time inside them in which a device operation runs: the wait for the
pass that the scales' read holds, and the copies themselves, are the
device's."""

SPANS = ("stage.css.prepare", "stage.css.upload", "stage.css.readback")


def _busy(ops, a, b):
    """Time of [a, b] covered by the intervals ops (sorted by start)."""
    busy, cur = 0.0, a
    for s, e in ops:
        s, e = max(s, cur), min(e, b)
        if e > s:
            busy += e - s
            cur = e
    return busy


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    spans = [(s, e) for n, s, e in tr.spans if n in SPANS]
    if not spans:
        return None
    ops = sorted((s, e) for _, s, e in tr.ops)
    t = sum(e - s - _busy(ops, s, e) for s, e in spans)
    return 100.0 * t / 1e6 / tr.window_s
