"""Tracing and per-stage wall-clock timing (port of
notsofar_tpu/utils/profiling.py).

* `trace(log_dir)` — a torch.profiler scope over the CPU and, where there
  is one, the card; writes a Chrome trace (view in Perfetto or
  chrome://tracing) into log_dir.
* `span(name)` — a named range on torch.profiler's timeline, on the
  clock of the card's kernel events, while a profiler records; otherwise
  one boolean check and nothing else. The program's spans are named
  ``stage.<stage>[.<part>]``.
* `StageTimer` — wall-clock seconds per stage, each stage also a span
  ``stage.<name>``. PyTorch launches CUDA work asynchronously, so a host
  clock read right after a stage's last call measures the enqueue, not
  the work. Every stage therefore ends with ``torch.cuda.synchronize()``
  when CUDA is in use — the counterpart of the JAX package's
  ``block_until_ready`` at the stage ends of asr/transcribe.py.
"""
import contextlib
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict

import torch

from notsofar_tpu_torch.utils.logging_def import get_logger

_LOG = get_logger("profiling")


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler scope; writes a Chrome trace file into log_dir."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = Path(log_dir) / f"trace_{os.getpid()}_{time.time_ns()}.json"
        prof.export_chrome_trace(str(path))
        _LOG.info(f"profiler trace written to {path}")


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A profiler range named `name` while torch.profiler records (on its
    timeline, beside the kernels the range launches); else a shared no-op
    context: no clock read, no allocation, no synchronise."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@dataclass
class StageTimer:
    """Accumulates wall time per pipeline stage; each stage is also the
    span ``stage.<name>``."""
    stage_seconds: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        with span(f"stage.{name}"):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if torch.cuda.is_initialized():
                    torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                self.stage_seconds[name] = \
                    self.stage_seconds.get(name, 0.0) + dt
