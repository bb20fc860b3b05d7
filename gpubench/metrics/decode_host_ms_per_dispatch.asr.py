"""Milliseconds of host time a decode dispatch outside the card's work:
the program's spans stage.decode.prepare (prompt packing, the inputs'
copies, the workspace key and look-up), stage.decode.unpack (the beams
or rows unpacked) and stage.decode.gates (the fallback gates, one a
rung) of the traced call, over the dispatches a call makes (DECODE_STEPS
calls over the window's calls: every call runs the same plan). The card
has no work of the call queued in these spans."""

SPANS = ("stage.decode.prepare", "stage.decode.unpack", "stage.decode.gates")


def read(rec):
    tr, n = rec["trace"], rec["counters"].get("calls", 0)
    if tr is None or not n or not rec["calls"]:
        return None
    us = [e - s for name, s, e in tr.spans if name in SPANS]
    return sum(us) / 1000.0 / (n / rec["calls"]) if us else None
