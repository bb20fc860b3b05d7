"""decode_gemv's share of its roofline in the traced call: the weight
bytes its launches must read (each fused step's launches read the decoder's
matrices and the logits' embedding once, counts/whisper.py) at the card's
published memory rate, over the launches' device time."""
from gpubench.counts.peaks import peaks


def read(rec):
    tr, pk = rec["trace"], peaks(rec["device_kind"])
    if tr is None or pk is None:
        return None
    match = lambda n: "decode_gemv" in n  # noqa: E731
    t = tr.op_seconds(match)
    if t <= 0:
        return None
    w = rec["work"]
    steps = tr.op_count(match) / w["gemv_launches_per_step"]
    return 100.0 * steps * w["gemv_weight_bytes"] / pk["hbm_bytes_per_s"] / t
