"""Share of the window the host spent waiting for the loader's next batch
(the harness's span around each fetch)."""


def read(rec):
    s = rec["stages"].get("loader")
    return None if s is None else 100.0 * s / rec["window_s"]
