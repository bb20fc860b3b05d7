"""Operations the window's ASR calls need (encoder, decode set-ups and
steps, word-timing passes; counts/whisper.py) over the window's time at
the card's published bf16 peak."""
from gpubench.counts.peaks import peaks


def read(rec):
    pk = peaks(rec["device_kind"])
    if pk is None:
        return None
    flops = sum(rec["work"]["flops"].values())
    return 100.0 * flops / rec["window_s"] / pk["bf16"]
