"""The Conformer's share of its roofline in the traced call: its
operations on every window it runs (the bucket's padding included) and
the least it moves (weights once a chunk, each window's features in and
masks out; counts/css.py), as max(operations at the bf16 peak, bytes at
the memory rate), over the device time of the operations in the call's
StageTimer stage 'conformer'."""
from gpubench.counts.peaks import peaks


def read(rec):
    tr, pk = rec["trace"], peaks(rec["device_kind"])
    w = rec["work"]
    if tr is None or pk is None or "conformer_flops" not in w:
        return None
    t = tr.op_seconds(lambda n: True, span="stage.conformer")
    if t <= 0:
        return None
    need = max(w["conformer_flops"] / pk["bf16"],
               w["conformer_bytes"] / pk["hbm_bytes_per_s"])
    return 100.0 * need / t
