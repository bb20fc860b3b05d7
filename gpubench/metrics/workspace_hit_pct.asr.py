"""Share of the window's decode calls whose key had its workspace and
graphs already (DECODE_STEPS hits over calls)."""


def read(rec):
    c = rec["counters"]
    return 100.0 * c["hits"] / c["calls"] if c.get("calls") else None
