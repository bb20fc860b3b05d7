"""Operations the window's training steps need (forward, backward, STFTs;
counts/conformer.py) over the window's time at the card's published
float32 peak (the recipe's precision, TF32 off)."""
from gpubench.counts.peaks import peaks


def read(rec):
    pk = peaks(rec["device_kind"])
    if pk is None:
        return None
    return 100.0 * rec["work"]["flops"] / rec["window_s"] / pk["f32"]
