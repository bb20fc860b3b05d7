"""Operations the window's CSS calls need (STFT, features, the Conformer
on real windows, covariances, solves, stitching losses, overlap-add,
iSTFT; counts/css.py) over the window's time at the card's published
bf16 peak."""
from gpubench.counts.peaks import peaks


def read(rec):
    pk = peaks(rec["device_kind"])
    flops = rec["work"].get("flops")
    if pk is None or not isinstance(flops, dict):
        return None
    return 100.0 * sum(flops.values()) / rec["window_s"] / pk["bf16"]
