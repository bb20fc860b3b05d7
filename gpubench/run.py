"""Run one benchmark cell once and print its result line.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

(or ``python3 -m gpubench.run ...``) from the root of a checkout. The cell
is an entry of BENCHMARK.json's ``workloads``. With ``--trace 0`` the
result holds the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics, read from one call of the window traced under
torch.profiler. The output check's numbers and their limits close
standard error and the result line. Exits non-zero, printing no result,
without the CUDA cards the cell asks for, when a module of JAX or of the
JAX package is loaded once the run is over (just before the result would
be printed), or when the system under test cannot be imported.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from gpubench import harness
    harness.set_run_environment(ROOT)
    try:
        out = harness.run(args.workload, args.seed, args.seconds,
                          bool(args.trace), t_start=T_START, root=ROOT)
    except harness.NoCard as e:
        print(f"gpubench: {e}", file=sys.stderr)
        return 3
    checks = out.pop("_checks")
    out.pop("_after")
    bad = harness.forbidden_modules()
    if bad:
        print("gpubench: modules of JAX or the JAX package are loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 4
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
