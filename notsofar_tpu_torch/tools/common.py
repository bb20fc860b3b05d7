"""What the kernel tools and chip_smoke.py share: the ``--device`` and
``--iters`` arguments, the card's line, the timers and the roofline bound."""
import argparse
import subprocess
import time
from typing import Callable, Tuple

import torch

from notsofar_tpu_torch.ops import kernels
from notsofar_tpu_torch.utils.cuda_graph import StepGraph


def add_device_args(ap: argparse.ArgumentParser, iters: int) -> None:
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu "
                         "(the kernels' plain versions, timed on the host)")
    ap.add_argument("--iters", type=int, default=iters,
                    help="timed calls per row (their mean is printed)")


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def device_line(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"device: {card_line()}"
    return "device: cpu (plain PyTorch versions; host times)"


def time_cuda(fn: Callable[[], object], iters: int) -> float:
    """Mean milliseconds of fn() on the card: CUDA events around each call,
    with a 256 MB write (evicts the 50 MB L2) and a short spin before it,
    so every call finds its inputs in device memory and the host has
    enqueued the call before the card reaches it."""
    fn()
    return _event_ms(fn, iters)


def time_cuda_graph(fn: Callable[[], object], iters: int) -> float:
    """Mean milliseconds of one replay of fn() captured in a CUDA graph,
    timed as time_cuda times a call: a chain of launches without the
    host's time between them, as the JAX tools' jitted chains run. One
    eager call first (the warm-up the capture needs); the kernel launch
    counters count it and every replay, as time_cuda's calls."""
    fn()
    torch.cuda.synchronize()
    return _event_ms(StepGraph(fn, (kernels.LAUNCHES,)).replay, iters)


def _event_ms(fn: Callable[[], object], iters: int) -> float:
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    evs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(100_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in evs) / iters


def time_ms(fn: Callable[[], object], iters: int, dev: torch.device) -> float:
    """Mean milliseconds of fn(): time_cuda_graph on a card, the host clock
    (after one warm-up call) on the CPU."""
    if dev.type == "cuda":
        return time_cuda_graph(fn, iters)
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def bound_ms(nbytes: float, flops: float, peak_flops: float,
             bytes_per_s: float) -> Tuple[float, str]:
    """The least time a card could take: the larger of the bytes over its
    memory rate and the operations over its peak for their type; with
    which of the two it is."""
    t_bytes = nbytes / bytes_per_s * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")
