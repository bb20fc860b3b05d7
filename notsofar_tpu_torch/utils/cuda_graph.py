"""One step of a loop captured as a CUDA graph and replayed: the port's
counterpart of the JAX package's compiled loop bodies (``lax.while_loop``
around a decode step, ``jit`` around a timed kernel chain).

A step is a function of no arguments whose state lives in tensors that it
updates in place (rebinding a Python name is lost under replay), whose
device scalars (a step counter, a cache position) are tensors it reads and
advances on the card, and that never syncs the host. It is captured once,
on a side stream, into one memory pool shared by every graph of the
process (so graphs must be replayed one at a time: a decode call replays
its own graph and no other), and then replayed on the current stream.
Capture launches nothing: the caller runs the step eagerly first (loading
every kernel library and setting its attributes) and replays after
capturing.

Python counters that the step bumps (``ops.kernels.LAUNCHES``,
``asr.decoding.DECODER_CALLS``) are kept true: what the capture added is
taken back, and added again at every replay. Generators the step draws from
are registered with the graph, so each replay draws what the eager step
would. A capture or replay error raises; nothing falls back to the eager
step.
"""
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

_POOL = None
_STREAM: Optional[torch.cuda.Stream] = None
# the latest graph: PyTorch lets a capture share a pool only while another
# graph of the pool is alive, so each graph lives until the next capture
# has ended (its memory went back to the pool at its capture's end)
_LATEST: Optional["StepGraph"] = None


def capture_stream() -> torch.cuda.Stream:
    """The side stream every capture runs on (and the eager warm-up step
    before it, so that its per-stream library state exists first)."""
    global _STREAM
    if _STREAM is None:
        _STREAM = torch.cuda.Stream()
    return _STREAM


def _pool():
    global _POOL
    if _POOL is None:
        _POOL = torch.cuda.graph_pool_handle()
    return _POOL


class StepGraph:
    """``step`` captured once; ``replay()`` runs it again on the card.

    counters: dicts of ints that the step's Python code bumps; each replay
    adds what one capture of the step added. generators: the non-default
    CUDA generators the step draws from. The host seconds of the capture
    (capture_s) and, summed over the replays, of their launches
    (launch_s) and of the counting after them (count_s)."""

    def __init__(self, step: Callable[[], object],
                 counters: Sequence[Dict[str, int]] = (),
                 generators: Sequence[torch.Generator] = ()):
        global _LATEST
        t0 = time.perf_counter()
        self.counters = list(counters)
        before = [dict(c) for c in self.counters]
        self.graph = torch.cuda.CUDAGraph()
        if generators and not hasattr(self.graph,
                                      "register_generator_state"):
            raise RuntimeError("this PyTorch cannot replay draws from "
                               "non-default generators in a CUDA graph "
                               "(CUDAGraph.register_generator_state)")
        for gen in generators:
            self.graph.register_generator_state(gen)
        stream = capture_stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self.graph.capture_begin(pool=_pool())
            try:
                step()
            except BaseException:
                try:
                    self.graph.capture_end()
                except RuntimeError:
                    pass   # the step's own error is the one to raise
                raise
            self.graph.capture_end()
        torch.cuda.current_stream().wait_stream(stream)
        _LATEST = self
        # the capture launched nothing: take back what it counted
        self.deltas: List[Dict[str, int]] = []
        for c, b in zip(self.counters, before):
            d = {k: c[k] - b.get(k, 0) for k in c if c[k] != b.get(k, 0)}
            for k, v in d.items():
                c[k] -= v
            self.deltas.append(d)
        self.capture_s = time.perf_counter() - t0
        self.launch_s = self.count_s = 0.0

    def replay(self) -> None:
        t0 = time.perf_counter()
        self.graph.replay()
        t1 = time.perf_counter()
        for c, d in zip(self.counters, self.deltas):
            for k, v in d.items():
                c[k] += v
        self.launch_s += t1 - t0
        self.count_s += time.perf_counter() - t1
