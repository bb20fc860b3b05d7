"""The decode steps' share of their roofline in the traced call: the
bytes every step of the call's decode dispatches must read (weights once,
each window's cross-attention memory once, the self caches up to the
step; counts/whisper.py) at the card's published memory rate, over the
device time of every operation in the call's decode stage (the dispatches'
set-ups included)."""
from gpubench.counts.peaks import peaks


def read(rec):
    tr, pk = rec["trace"], peaks(rec["device_kind"])
    if tr is None or pk is None:
        return None
    t = tr.op_seconds(lambda n: True, span="stage.decode")
    if t <= 0:
        return None
    need = sum(rec["work"]["per_call"][i]["decode_bytes"]
               for i in rec["traced_calls"])
    return 100.0 * need / pk["hbm_bytes_per_s"] / t
