"""Share of the traced call with no operation on the device."""


def read(rec):
    tr = rec["trace"]
    return None if tr is None else 100.0 * (1.0 - tr.busy_s / tr.window_s)
