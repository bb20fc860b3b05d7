"""Milliseconds of the decode stage (StageTimer 'decode': set-ups, steps
and the host's work between them) a decode step (DECODE_STEPS eager +
replayed)."""


def read(rec):
    c = rec["counters"]
    steps = c.get("eager", 0) + c.get("replayed", 0)
    s = rec["stages"].get("decode")
    return None if not steps or s is None else 1000.0 * s / steps
