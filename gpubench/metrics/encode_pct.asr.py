"""Share of the window in the log-mel and encoder stages (StageTimer
'mel' + 'encode')."""


def read(rec):
    s = [rec["stages"].get(k) for k in ("mel", "encode")]
    if all(v is None for v in s):
        return None
    return 100.0 * sum(v or 0.0 for v in s) / rec["window_s"]
