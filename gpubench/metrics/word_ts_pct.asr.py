"""Share of the window in the word-timing stage (StageTimer 'word_ts':
the alignment pass and its DTW, synchronised at the stage's end)."""


def read(rec):
    s = rec["stages"].get("word_ts")
    return None if s is None else 100.0 * s / rec["window_s"]
