"""Work captured once as CUDA graphs and replayed: the port's counterpart
of the JAX package's compiled programs (a decode call's ``jit`` of set-up
and ``lax.while_loop``, ``jit`` around a timed kernel chain).

A captured function takes no arguments, keeps its state in tensors that
it updates in place (rebinding a Python name is lost under replay), reads
its device scalars (a step counter, a cache position) from tensors it
advances on the card, and never syncs the host. It is captured on a side
stream into a memory pool, and replayed on the current stream. Capture
launches nothing: the caller runs the function eagerly first (loading
every kernel library and setting its attributes) and replays after
capturing.

Graphs of one pool may be replayed in any order only where no tensor
made inside one capture is read after another graph of the pool ran: a
graph's temporaries live in its pool, and another graph of the pool may
reuse their memory. So a decode workspace (asr/decoding.py) allocates
every tensor that lives from one graph to the next itself, outside the
captures, and gives its three graphs a pool of their own; a graph made
without a pool gets one of its own.

Python counters that the function bumps (``ops.kernels.LAUNCHES``,
``asr.decoding.DECODER_CALLS``) are kept true: what the capture added is
taken back, and added again at every replay. Generators the function
draws from are registered with the graph, so each replay draws what the
eager function would from their states at that time. A capture or replay
error raises; nothing falls back to eager execution.

``WorkspaceCache`` keeps such graphs' workspaces across calls: a
least-recently-used cache bounded by a byte budget.
"""
import time
import weakref
from collections import OrderedDict
from typing import Callable, Dict, Hashable, List, Optional, Sequence

import torch

_STREAM: Optional[torch.cuda.Stream] = None


def capture_stream() -> torch.cuda.Stream:
    """The side stream every capture runs on (and the eager warm-up before
    it, so that its per-stream library state exists first)."""
    global _STREAM
    if _STREAM is None:
        _STREAM = torch.cuda.Stream()
    return _STREAM


class StepGraph:
    """``step`` captured once; ``replay()`` runs it again on the card.

    counters: dicts of ints that the step's Python code bumps; each replay
    adds what one capture of the step added. generators: the non-default
    CUDA generators the step draws from. pool: the memory pool to capture
    into (torch.cuda.graph_pool_handle(); several graphs may share one
    while one of them is alive), by default a pool of its own. The host
    seconds of the capture (capture_s) and, summed over the replays, of
    their launches (launch_s) and of the counting after them (count_s);
    the device memory the capture reserved (pool_bytes)."""

    def __init__(self, step: Callable[[], object],
                 counters: Sequence[Dict[str, int]] = (),
                 generators: Sequence[torch.Generator] = (),
                 pool=None):
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
        if pool is None:
            pool = torch.cuda.graph_pool_handle()
        reserved = torch.cuda.memory_reserved()
        stream = capture_stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self.graph.capture_begin(pool=pool)
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
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
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


class WorkspaceCache:
    """Workspaces (objects with an int ``nbytes`` and an optional
    ``release()``) by (owner, key), least recently used first out, bounded
    by a byte budget that each ``put``/``fit`` is given. An owner's
    entries go when the owner is garbage-collected, so a workspace never
    outlives the object whose tensors its graphs read (and an owner's id
    is never reused while its entries stand). Evicting calls
    ``release()``."""

    def __init__(self):
        self._entries: "OrderedDict[tuple, object]" = OrderedDict()
        self._owners = set()

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def nbytes(self) -> int:
        return sum(ws.nbytes for ws in self._entries.values())

    def keys(self) -> List[Hashable]:
        """The keys held, least recently used first (owners left out)."""
        return [k[1] for k in self._entries]

    def get(self, owner: object, key: Hashable):
        """The owner's workspace of `key` (now the most recently used), or
        None."""
        k = (id(owner), key)
        ws = self._entries.get(k)
        if ws is not None:
            self._entries.move_to_end(k)
        return ws

    def put(self, owner: object, key: Hashable, ws, budget: int) -> int:
        """Add `ws` as the most recently used and fit the budget; returns
        the workspaces evicted."""
        oid = id(owner)
        if oid not in self._owners:
            self._owners.add(oid)
            weakref.finalize(owner, self._drop_owner, oid)
        self._entries[(oid, key)] = ws
        return self.fit(budget)

    def fit(self, budget: int) -> int:
        """Evict the least recently used workspaces until the rest hold at
        most `budget` bytes; the most recently used one always stays.
        Returns how many went."""
        n = 0
        while len(self._entries) > 1 and self.nbytes > budget:
            _, ws = self._entries.popitem(last=False)
            self._release(ws)
            n += 1
        return n

    def _drop_owner(self, oid: int) -> None:
        self._owners.discard(oid)
        for k in [k for k in self._entries if k[0] == oid]:
            self._release(self._entries.pop(k))

    @staticmethod
    def _release(ws) -> None:
        release = getattr(ws, "release", None)
        if release is not None:
            release()
