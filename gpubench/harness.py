"""The benchmark's run of one cell: set-up, the measured window, the trace,
the metrics and the output check.

A cell is an entry of BENCHMARK.json's ``workloads``. It names a
configuration (``configs/<config>.json``) and a traffic mix
(``workloads/<traffic>.json``); the traffic file names the driver
(``drivers/<driver>.py``) that builds the system under test from them.
Each per-layer metric is read by ``metrics/<name>.py``. Nothing here
knows a cell, a configuration or a metric by name.

A driver module has ``setup(ctx) -> cell`` and the cell object:

* ``call()``: one unit of the entry's work, finished on the device when
  it returns; returns the units it completed (the rate's numerator);
* ``start_window()`` / ``window_record()``: zero the program's stage
  timers and counters at the window's start; after it, what they read
  (``stages``, ``counters``, ``work``) for the metric readers;
* ``release()``: drop the program's state (after the peak memory is read);
* ``check()``: the output check, a list of ``Check``.

With ``--trace``, call ``TRACED_CALL`` of the window (counted from 0) runs
under torch.profiler. The cell's rate is its end-to-end metric other than
``setup_s``: the units its calls completed over the window.
"""
import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

REPO = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "notsofar_tpu")
TRACED_CALL = 1       # the window's second call: the first follows set-up


class NoCard(RuntimeError):
    """The run asked for more cards than the machine has."""


@dataclass
class Check:
    """One number of the output check, held to its limit: the check passes
    where value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that are JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = REPO) -> Dict:
    return load_json(root / "BENCHMARK.json")


def cell_files(man: Dict, name: str) -> Dict:
    """The cell's manifest entry, configuration, traffic and metrics."""
    cells = {c["name"]: c for c in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]

    def mine(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in man["end_to_end"] if mine(m)]
    layer = [m for m in man["per_layer"] if mine(m)]
    rates = [m["name"] for m in e2e if m["name"] != "setup_s"]
    if len(rates) != 1:
        raise ValueError(f"{name}: the harness reports one rate a cell "
                         f"besides setup_s, the manifest names {rates}")
    return dict(cell=cell,
                config=load_json(HERE / "configs" / f"{cell['config']}.json"),
                traffic=load_json(HERE / "workloads"
                                  / f"{cell['traffic']}.json"),
                end_to_end=e2e, per_layer=layer)


def metric_reader(name: str) -> Callable:
    """metrics/<name>.py's read(record) -> value or None."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str):
    return importlib.import_module(f"gpubench.drivers.{name}")


def set_run_environment(root: Path) -> None:
    """Caches inside the checkout at fixed paths; no JAX through a
    library; no vocabulary or model files from outside."""
    cache = root / ".gpubench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ["USE_FLAX"] = "0"
    for k in ("WHISPER_VOCAB_PATH", "NOTSOFAR_MODELS_DIR"):
        os.environ.pop(k, None)


# ---------------------------------------------------------------------------
# the profiler's trace
# ---------------------------------------------------------------------------

@dataclass
class Trace:
    """What one traced call's profile holds: device operations (name,
    start us, end us), the harness's and the drivers' host spans (name,
    start us, end us) and the call's own span."""
    ops: List[tuple]
    spans: List[tuple]
    t0: float
    t1: float

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def _union(self, ivs) -> float:
        ivs = sorted((max(s, self.t0), min(e, self.t1)) for s, e in ivs)
        busy, cur_s, cur_e = 0.0, None, None
        for s, e in ivs:
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy

    @property
    def busy_s(self) -> float:
        """Seconds of the call's span in which a device operation ran."""
        return self._union([(s, e) for _, s, e in self.ops]) / 1e6

    def op_seconds(self, match: Callable[[str], bool],
                   span: Optional[str] = None) -> float:
        """Device seconds of the operations whose name matches, within the
        host spans named `span` where given."""
        ivs = [(s, e) for n, s, e in self.spans if n == span] \
            if span else None
        total = 0.0
        for n, s, e in self.ops:
            if not match(n):
                continue
            if ivs is not None and not any(a <= s < b for a, b in ivs):
                continue
            total += e - s
        return total / 1e6

    def op_count(self, match: Callable[[str], bool]) -> int:
        return sum(1 for n, _, _ in self.ops if match(n))

    def top_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for n, s, e in self.ops:
            by[n] = by.get(n, 0.0) + (e - s) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda x: -x[1])
                [:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The longest stretches with no device operation, each named by
        the innermost host span at its middle, summed by that name."""
        ivs = sorted((s, e) for _, s, e in self.ops)
        gaps, cur = [], self.t0
        for s, e in ivs:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if self.t1 > cur:
            gaps.append((cur, self.t1))
        by: Dict[str, float] = {}
        for a, b in gaps:
            mid = (a + b) / 2
            inner = [(e - s, n) for n, s, e in self.spans if s <= mid <= e]
            name = min(inner)[1] if inner else "outside any span"
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda x: -x[1])
                [:k]]


CALL_SPAN = "gpubench.call"


def traced(fn: Callable[[], float]):
    """Run fn under torch.profiler (CPU and CUDA activity); returns (its
    result, Trace, seconds spent reading the profile after fn ended)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(CALL_SPAN):
            out = fn()
        torch.cuda.synchronize()
        t_done = time.perf_counter()
    ops, spans = [], []
    t0 = t1 = None
    for e in prof.events():
        mine = e.name.startswith("gpubench.") or e.name.startswith("stage.")
        if e.device_type == DeviceType.CUDA:
            # the device timeline also carries the host spans' names
            if not mine:
                ops.append((e.name, e.time_range.start, e.time_range.end))
        elif e.name == CALL_SPAN:
            t0, t1 = e.time_range.start, e.time_range.end
        elif mine:
            spans.append((e.name, e.time_range.start, e.time_range.end))
    spans.append((CALL_SPAN, t0, t1))
    return out, Trace(ops, spans, t0, t1), time.perf_counter() - t_done


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def device_info(device: str, chips: int) -> Dict:
    import torch
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise NoCard(f"the cell asks for {chips} card(s); this machine "
                     f"has {n}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def run(name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", root: Path = REPO, t_start: float = None,
        log=None) -> Dict:
    """One run of the cell `name` of root's BENCHMARK.json. Returns the
    result line's object (``checks`` last) and, under ``_checks``, the
    Check list."""
    t_start = time.perf_counter() if t_start is None else t_start
    files = cell_files(manifest(root), name)
    return run_files(files, seed, seconds, trace, device, t_start, log)


def run_files(files: Dict, seed: int, seconds: float, trace: bool,
              device: str = "cuda", t_start: float = None, log=None,
              after=None) -> Dict:
    """run() of a cell given as cell_files() gives it. after(driver
    module, ctx, record), where given, runs after the check; its result is
    kept under ``_after``."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    name = files["cell"]["name"]
    cell, traffic = files["cell"], files["traffic"]
    dev_info = device_info(device, int(cell["chips"]))
    import torch
    mod = driver(traffic["driver"])
    ctx = dict(seed=int(seed), device=device, config=files["config"],
               traffic=traffic)
    system = mod.setup(ctx)
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"[gpubench] {name}: set-up {setup_s:.3f} s")

    record: Dict = {}
    system.start_window()
    units, calls, tr = 0.0, 0, None
    reading = 0.0     # reading the profile is left out of the window
    w0 = time.perf_counter()
    while True:
        if trace and calls == TRACED_CALL:
            done, tr, post = traced(system.call)
            reading += post
        else:
            done = system.call()
        units += done
        calls += 1
        if time.perf_counter() - w0 - reading >= seconds:
            break
    if device == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - w0 - reading
    record.update(system.window_record())
    record.update(window_s=window_s, units=units, calls=calls, trace=tr,
                  traced_calls=[TRACED_CALL] if tr is not None else [],
                  config=files["config"], traffic=traffic,
                  device_kind=dev_info["kind"])
    log(f"[gpubench] {name}: {calls} calls, {units:.1f} units in "
        f"{window_s:.3f} s")
    if device == "cuda":
        peak = max(torch.cuda.max_memory_allocated(i)
                   for i in range(int(cell["chips"])))
    else:
        peak = 0
    dev_info["memory_peak_bytes"] = int(peak)

    metrics: Dict = {}
    if trace:
        for m in files["per_layer"]:
            v = metric_reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if tr is not None:
            dev_info["busy_s"] = tr.busy_s
            dev_info["window_s"] = tr.window_s
    else:
        for m in files["end_to_end"]:
            value = setup_s if m["name"] == "setup_s" else units / window_s
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    system.release()
    del system
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = mod.check(ctx, record)
    log(f"[gpubench] {name}: check {time.perf_counter() - t_check:.3f} s")
    extra = after(mod, ctx, record) if after is not None else None
    out = {"correct": all(c.ok for c in checks),
           "attempted": int(record.get("attempted", calls)),
           "failed": int(record.get("failed", 0)),
           "metrics": metrics, "device": dev_info}
    if trace and tr is not None:
        out["breakdown"] = {"device_ops": tr.top_ops(),
                            "idle_gaps": tr.idle_gaps()}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in checks}
    out["_checks"] = checks
    out["_after"] = extra
    return out
