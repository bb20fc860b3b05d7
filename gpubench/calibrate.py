"""Readings that the output check's limits are set from.

    python3 gpubench/calibrate.py --workload <name> --seeds 11 12 ... \
        [--seconds S] [--control] [--out <file>.jsonl]

For each seed, in one process: the cell's set-up and a short window at
the cell's own load, then the check's numbers for the program and, with
--control, the driver's control_readings over the same outputs (the
reference computed one precision below the configuration's), held to the
same limits as the program's where the driver has ``judge``
(``control_correct``). One JSON line per seed. Benchmark runs never run
the control.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from gpubench import harness
    harness.set_run_environment(ROOT)
    files = harness.cell_files(harness.manifest(ROOT), args.workload)

    def after(mod, ctx, record):
        if not args.control:
            return None
        ctrl = mod.control_readings(ctx, record)
        if hasattr(mod, "judge"):
            checks = mod.judge(ctx, ctrl)
            ctrl["control_correct"] = all(c.ok for c in checks)
            ctrl["control_failed"] = [c.name for c in checks if not c.ok]
        return ctrl

    out_f = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t = time.perf_counter()
        res = harness.run_files(files, seed, args.seconds, False,
                                after=after)
        line = {"seed": seed,
                "program": {c.name: c.value for c in res["_checks"]},
                "control": res["_after"], "metrics": res["metrics"],
                "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        if out_f:
            out_f.write(json.dumps(line) + "\n")
            out_f.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
