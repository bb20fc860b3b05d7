"""Per-stage wall-clock timing (port of notsofar_tpu/utils/profiling.py's
StageTimer).

PyTorch launches CUDA work asynchronously, so a host clock read right
after a stage's last call measures the enqueue, not the work. Every stage
therefore ends with ``torch.cuda.synchronize()`` when CUDA is in use —
the counterpart of the JAX package's ``block_until_ready`` at the stage
ends of asr/transcribe.py.
"""
import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Dict

import torch

from notsofar_tpu_torch.utils.logging_def import get_logger

_LOG = get_logger("profiling")


@dataclass
class StageTimer:
    """Accumulates wall time per pipeline stage and reports RTFx."""
    audio_seconds: float = 0.0
    stage_seconds: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.stage_seconds[name] = self.stage_seconds.get(name, 0.0) + dt

    def add_audio(self, seconds: float):
        self.audio_seconds += seconds

    def report(self) -> Dict:
        total = sum(self.stage_seconds.values())
        return {
            "audio_seconds": round(self.audio_seconds, 2),
            "wall_seconds": round(total, 2),
            "rtfx": round(self.audio_seconds / total, 2) if total else None,
            "stages": {k: dict(seconds=round(v, 2),
                               rtfx=round(self.audio_seconds / v, 2)
                               if v else None)
                       for k, v in self.stage_seconds.items()},
        }

    def log(self):
        _LOG.info(f"RTFx report: {json.dumps(self.report())}")
