"""Batched Whisper decoding: greedy/sampled decode with whisper's logit
filters, and word timestamps from a teacher-forced alignment pass.

Port of notsofar_tpu/asr/decoding.py. The JAX package compiles each
decode call once per shape (``jit`` of the cross-K/V projection, the
prompt's prefill and one ``lax.while_loop``) and runs the cached program
at every later call of that shape. Here a decode call is a set-up (the
state's reset, the cross-attention memory, the prompt's prefill and the
no-speech probability), then one step function, step 0 with its own
logit filters and the later steps alike; every tensor they read or write
lives in a DecodeWorkspace kept per key (what the JAX program is
compiled on: loop kind, rows, prompt length, cache length, max_new,
sampling mode, dtype, int8 flags, pads, ...; the temperature is read
from device memory, so one graph serves every rung of the fallback
ladder). On the
card the key's first call runs the set-up and step 0 eagerly and
captures three CUDA graphs (set-up, step 0, step; utils/cuda_graph.py);
every later call of the key copies its inputs into the workspace and
replays them, capturing nothing. The workspaces sit in a least-recently-
used cache bounded by WORKSPACE_BUDGET bytes. On the CPU the same
functions run eagerly in the same workspaces. The loop reads
``finished.all()`` every FINISHED_CHECK_EVERY steps, never past
max_new_tokens, and keeps one step queued ahead of the host: the read of
step i is copied to pinned host memory behind an event and waited on
only once step i + 1 is enqueued, so at most one step runs past the one
where every row finished. Rows that finished emit EOT and add 0
log-probability, so extra steps change nothing and the check only saves
steps.

Logit filters (pure functions of a small per-row state):

* suppress-blank at the first sampled position,
* non-speech token suppression,
* timestamp pairing rules (only text/eot after a closed pair, only
  timestamps after an open one, monotonic timestamps, forced timestamp
  when the total timestamp probability dominates, timestamp-only first
  token),
* eot latching.

Word timestamps use whisper's approach: a teacher-forced pass collecting
cross-attention from alignment heads, reduced on device by one
hand-written kernel, ops.kernels.align_reduce (head selection, per-frame
z-norm over the real token rows, width-7 median filter, head mean, in one
pass over the heads). The DTW runs on the host in float64, in the native
core native/dtw.cpp (the JAX package ran it on device only to avoid its
TPU host link): only the reduced [T, 1500] matrix per window leaves the
card.

Model weights live in the ``WhisperModel`` (an ``nn.Module``), so the
decoders take no ``variables`` argument.
"""
import base64
import gzip
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from notsofar_tpu_torch.asr.tokenizer import WhisperTokenizer
from notsofar_tpu_torch.models.whisper import (  # noqa: F401 (re-exported)
    DECODER_CALLS, WhisperModel, reset_decoder_calls)
from notsofar_tpu_torch.ops import kernels
from notsofar_tpu_torch.ops.kernels import (  # noqa: F401 (re-exported)
    median_filter)
from notsofar_tpu_torch.utils.cuda_graph import (StepGraph, WorkspaceCache,
                                                 capture_stream)
from notsofar_tpu_torch.utils.native import load_native, ptr
from notsofar_tpu_torch.utils.profiling import span

NEG_INF = -1e30

# decode steps between two reads of finished.all(): of 1, 2, 4 and 8, 1
# was the fastest on an H100 (chip_smoke.py phase 3b, rows ending at
# different steps): each step run past the last EOT costs a whole step
FINISHED_CHECK_EVERY = 1


@torch.no_grad()
def detect_language(model: WhisperModel, tokenizer: WhisperTokenizer,
                    xa: torch.Tensor) -> List[str]:
    """Language identification: the distribution over language tokens at
    the position following <|startoftranscript|> (whisper detect_language).

    xa: [B, 1500, D] encoded windows -> list of language codes."""
    B = xa.shape[0]
    sot = torch.full((B, 1), tokenizer.sot, dtype=torch.long,
                     device=xa.device)
    logits, _, _ = model.decoder(sot, xa, 0, None)
    lang_items = sorted(tokenizer.specials.languages.items(),
                        key=lambda kv: kv[1])
    lang_ids = torch.tensor([i for _, i in lang_items], device=xa.device)
    best = logits[:, 0, :][:, lang_ids].argmax(dim=-1).tolist()
    return [lang_items[int(b)][0] for b in best]


def non_speech_tokens(tokenizer: WhisperTokenizer) -> List[int]:
    """Symbols suppressed during decoding (whisper's suppress_tokens='-1'):
    sound annotations, brackets, music symbols etc."""
    symbols = list("\"#()*+/:;<=>@[\\]^_`{|}~「」『』") + \
        ["<<", ">>", "<<<", ">>>", "--", "---", "-(", "-[", "('", "(\"",
         "((", "))", "(((", ")))", "[[", "]]", "{{", "}}", "♪♪", "♪♪♪",
         "♩", "♪", "♫", "♬", "♭", "♮", "♯"]
    ids = set()
    for s in symbols:
        for variant in (s, " " + s):
            toks = tokenizer.encode(variant)
            if len(toks) == 1:
                ids.add(toks[0])
    return sorted(ids)


@dataclass(frozen=True)
class DecodeOptions:
    max_new_tokens: int = 224
    language: str = "en"
    without_timestamps: bool = False
    max_initial_timestamp: float = 1.0
    suppress_blank: bool = True
    suppress_non_speech: bool = True
    temperature: float = 0.0  # >0 -> gumbel sampling (fallback ladder)
    # rows per decode call (beam paths count batch*K): bounds the per-row
    # cross-attention K/V (~0.25 GB per row on large-v3 in bf16)
    max_rows_per_dispatch: int = 12
    # int8 cross-attention K/V (WhisperModel.quantize_cross_kv), read by
    # the xattn_int8 kernel at every decode step: a quarter of the f32
    # bytes, half of bf16's, so a dispatch can hold more rows
    cross_kv_quant: bool = False


# the bytes the decode workspaces of this process may hold (their tensors
# and their graphs' pools) before the least recently used one goes; a
# workspace weighs about 0.9 GB at large-v3, greedy, 3 rows in bf16, 1.4 GB
# at beam 5 on 3 streams and 8-11 GB at the int8 pipeline's 45-48 rows, so
# the int8 beam rung and two sampled rungs fit beside the models, the CSS
# engine and TitaNet on an 80 GB card
WORKSPACE_BUDGET = 24 << 30

# the decode workspaces by (decoder, key)
WORKSPACES = WorkspaceCache()

# in this process: decode calls, the calls whose key had a workspace (hits)
# or needed a new one (misses), the workspaces evicted for the budget and
# the bytes the workspaces hold now; decode steps run eagerly and replayed
# from CUDA graphs, the graphs captured (three at a key's first call on the
# card) and the seconds they took; and the loops' host seconds: each
# call's set-up before step 0 (the copy of its inputs, then the set-up
# eagerly or its graph's replay), step 0 (eager, the graphs' warm-up, or
# its graph's replay), the later steps' replays, the counters they bump,
# and the waits on finished.all() reads; and the windows the word-timing
# pass aligned (find_word_timestamps_batch), and those whose DTW ran in the
# native core (dtw_path)
DECODE_STEPS: Dict[str, float] = {"calls": 0, "hits": 0, "misses": 0,
                                  "evictions": 0, "workspace_bytes": 0,
                                  "eager": 0, "replayed": 0, "captures": 0,
                                  "capture_s": 0.0, "prefill_s": 0.0,
                                  "step0_s": 0.0, "launch_s": 0.0,
                                  "count_s": 0.0, "read_s": 0.0,
                                  "align_windows": 0, "dtw_native": 0}


def reset_decode_steps() -> None:
    """Zero the counts; workspace_bytes reads what is held now."""
    for k in DECODE_STEPS:
        DECODE_STEPS[k] = 0
    DECODE_STEPS["workspace_bytes"] = WORKSPACES.nbytes


# what a graph of the decode loops counts in Python (see StepGraph)
_COUNTERS = (kernels.LAUNCHES, DECODER_CALLS)


class DecodeWorkspace:
    """The tensors and CUDA graphs of one decode key, kept across calls.

    t: every tensor the set-up, step 0 and the step read or write -- the
    inputs (xa, prompt, pads), the caches, the cross-attention memory
    (int8 and the products the int8 step reads where quantized), the
    loop's state and constants -- allocated outside the graphs' captures:
    the shapes known from the key when the workspace is made, the rest at
    the key's first set-up, which runs eagerly (``into``). st: the logit
    filters' state. gens: the generators the steps draw from; each call
    loads its generators' states into them and hands the advanced states
    back. On the card: the set-up graph and the (step 0, step) graphs,
    captured at the key's first call into a pool of the workspace's own.
    nbytes: the tensors' bytes and the pool's (measure())."""

    def __init__(self, device: torch.device, n_gens: int, st: Dict,
                 **tensors: torch.Tensor):
        self.device = device
        self.gens = [torch.Generator(device=device) for _ in range(n_gens)]
        self.st = st
        self.t: Dict = dict(tensors)
        self.cross: List = []
        self.setup_graph: Optional[StepGraph] = None
        self.step_graphs: Optional[Tuple[StepGraph, StepGraph]] = None
        self._pool = None
        self.nbytes = 0

    def into(self, name, value: torch.Tensor) -> torch.Tensor:
        """Copy `value` into the workspace's tensor `name` (made like it at
        the first call) and return that tensor."""
        buf = self.t.get(name)
        if buf is None:
            buf = self.t[name] = torch.empty_like(
                value, memory_format=torch.contiguous_format)
        return buf.copy_(value)

    def load(self, xa: torch.Tensor, prompt: torch.Tensor,
             pads: Optional[torch.Tensor],
             generators: Sequence[torch.Generator]) -> None:
        """A call's inputs into the workspace."""
        self.into("xa", xa)
        self.into("prompt", prompt)
        if pads is not None:
            self.into("pads", pads)
        for mine, theirs in zip(self.gens, generators):
            mine.set_state(theirs.get_state())

    def hand_back(self, generators: Sequence[torch.Generator]) -> None:
        """The generators' states after the call, back to the caller's."""
        for mine, theirs in zip(self.gens, generators):
            theirs.set_state(mine.get_state())

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def measure(self) -> None:
        seen, n = set(), 0
        todo = [*self.t.values(), *self.st.values()]
        while todo:
            x = todo.pop()
            if isinstance(x, (list, tuple)):
                todo.extend(x)
            elif isinstance(x, torch.Tensor) and \
                    x.untyped_storage().data_ptr() not in seen:
                seen.add(x.untyped_storage().data_ptr())
                n += x.untyped_storage().nbytes()
        graphs = [self.setup_graph, *(self.step_graphs or ())]
        self.nbytes = n + sum(g.pool_bytes for g in graphs if g is not None)

    def release(self) -> None:
        """Drop the graphs and tensors (evicted). The card finishes what
        it has queued first: a graph being replayed is not destroyed."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_graph = self.step_graphs = self._pool = None
        self.t, self.st, self.cross, self.nbytes = {}, {}, [], 0


class _FinishedRead:
    """finished.all() read back to the host. post() enqueues the read
    (on the card: a copy into pinned host memory and an event behind it,
    so the stream does not wait); wait() returns it, blocking until the
    event is done. On the CPU the read is taken at post()."""

    def __init__(self, finished: torch.Tensor):
        self.finished = finished
        self.value = False
        if finished.is_cuda:
            self.host = torch.zeros((), dtype=torch.bool, pin_memory=True)
            self.event = torch.cuda.Event()

    def post(self) -> None:
        if self.finished.is_cuda:
            self.host.copy_(self.finished.all(), non_blocking=True)
            self.event.record()
        else:
            self.value = bool(self.finished.all())

    def wait(self) -> bool:
        if self.finished.is_cuda:
            self.event.synchronize()
            return bool(self.host)
        return self.value


def set_temperature(buf: torch.Tensor, temperature: float) -> None:
    """Write `temperature` into a sampled step's 0-d f32 tensor `buf`, the
    form by_temperature reads: one graph then serves every temperature of
    the fallback ladder. On the card the f32 reciprocal (PyTorch's CUDA
    division by a host scalar is the product with its f32 reciprocal),
    on the CPU the temperature itself."""
    if buf.is_cuda:
        buf.fill_(float(np.float32(1.0) / np.float32(temperature)))
    else:
        buf.fill_(temperature)


def by_temperature(logits: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
    """``logits / temperature`` bit for bit, with the temperature read
    from device memory (set_temperature)."""
    return logits * buf if logits.is_cuda else logits / buf


def gumbel_noise(shape, generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1), drawn
    from ``generator`` (jax.random.gumbel's construction)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


class GreedyDecoder:
    """Batched greedy (or temperature-sampled) decoder bound to a model and
    tokenizer."""

    def __init__(self, model: WhisperModel, tokenizer: WhisperTokenizer,
                 options: DecodeOptions = DecodeOptions()):
        self.model = model
        self.tok = tokenizer
        self.opt = options
        d = model.dims
        mask = np.zeros(d.n_vocab, np.float32)
        if options.suppress_non_speech:
            for t in non_speech_tokens(tokenizer):
                mask[t] = NEG_INF
        for t in (tokenizer.specials.translate, tokenizer.specials.transcribe,
                  tokenizer.sot, tokenizer.specials.sot_prev,
                  tokenizer.specials.sot_lm, tokenizer.no_speech):
            if t < d.n_vocab:
                mask[t] = NEG_INF
        for lang_tok in tokenizer.specials.languages.values():
            if lang_tok < d.n_vocab:
                mask[lang_tok] = NEG_INF
        if not options.without_timestamps:
            mask[tokenizer.no_timestamps] = NEG_INF
        blank = np.zeros(d.n_vocab, np.float32)
        if options.suppress_blank:
            for t in tokenizer.encode(" ") + [tokenizer.eot]:
                blank[t] = NEG_INF
        self._ts_begin = tokenizer.timestamp_begin
        self._eot = tokenizer.eot
        self._max_initial_ts = self._ts_begin + int(
            options.max_initial_timestamp / 0.02)
        dev = model.device
        vocab = torch.arange(d.n_vocab, device=dev)
        self._suppress = torch.from_numpy(mask).to(dev)
        self._suppress_blank = torch.from_numpy(blank).to(dev)
        self._is_ts = vocab >= self._ts_begin
        self._is_text = vocab < self._eot
        self._vocab = vocab
        self._bad_first = ~self._is_ts | (vocab > self._max_initial_ts)
        # their promoted parameters (LayerNorm._params_as) are host state a
        # graph reads: a workspace's key holds what that cache is keyed on
        self._layer_norms = [m for m in model.decoder.modules()
                             if isinstance(m, torch.nn.LayerNorm)]

    # ------------------------------------------------------------------
    def _apply_timestamp_rules(self, logits, prev_was_ts, prev_prev_was_ts,
                               last_ts, any_ts, step: int):
        """whisper ApplyTimestampRules on a [B, V] logits batch.

        * after a closing timestamp pair -> timestamps suppressed;
          after an opening timestamp -> text (ids < eot) suppressed;
        * timestamps never decrease: suppress ts < last (an open pair may
          repeat the same value, else strictly greater);
        * first sampled token must be a timestamp <= max_initial_timestamp
          (eot suppressed too);
        * if the summed timestamp probability exceeds the best text
          token's, text (everything below timestamp_begin) is suppressed.
        """
        is_ts = self._is_ts[None, :]
        only_text = prev_was_ts & prev_prev_was_ts     # just closed a pair
        open_pair = prev_was_ts & ~prev_prev_was_ts    # must close the pair
        logits = logits.masked_fill(only_text[:, None] & is_ts, NEG_INF)
        logits = logits.masked_fill(open_pair[:, None] & self._is_text[None],
                                    NEG_INF)
        threshold = torch.where(open_pair, last_ts, last_ts + 1)
        below = self._vocab[None, :] < threshold[:, None]
        logits = logits.masked_fill(any_ts[:, None] & is_ts & below, NEG_INF)
        if step == 0:
            logits = logits.masked_fill(self._bad_first[None, :], NEG_INF)
        logprobs = torch.log_softmax(logits, dim=-1)
        ts_lp = torch.logsumexp(logprobs.masked_fill(~is_ts, NEG_INF), dim=-1)
        text_lp = logprobs.masked_fill(is_ts, NEG_INF).amax(dim=-1)
        force_ts = ts_lp > text_lp
        return logits.masked_fill(force_ts[:, None] & ~is_ts, NEG_INF)

    def _filter(self, cur_logits, state: Dict, step: int) -> torch.Tensor:
        """The logit filters every decode step applies before choosing."""
        lg = cur_logits + self._suppress
        if step == 0:
            lg = lg + self._suppress_blank
        if not self.opt.without_timestamps:
            lg = self._apply_timestamp_rules(
                lg, state["prev_was_ts"], state["prev_prev_was_ts"],
                state["last_ts"], state["any_ts"], step)
        return lg

    def _init_state(self, rows: int) -> Dict:
        dev = self.model.device
        return dict(
            prev_was_ts=torch.zeros(rows, dtype=torch.bool, device=dev),
            prev_prev_was_ts=torch.zeros(rows, dtype=torch.bool, device=dev),
            last_ts=torch.full((rows,), self._ts_begin, dtype=torch.long,
                               device=dev),
            any_ts=torch.zeros(rows, dtype=torch.bool, device=dev),
            length=torch.zeros(rows, dtype=torch.long, device=dev),
            finished=torch.zeros(rows, dtype=torch.bool, device=dev))

    def _reset_state(self, st: Dict) -> None:
        """_init_state's values, in place (a workspace's set-up)."""
        for k in ("prev_was_ts", "prev_prev_was_ts", "any_ts", "length",
                  "finished"):
            st[k].zero_()
        st["last_ts"].fill_(self._ts_begin)

    def _key(self, kind: str, xa: torch.Tensor, graph: bool,
             prompt_len: int, *shape) -> tuple:
        """A decode call's workspace key: what the JAX package compiles
        its decode program on (kind, prompt_len and `shape`: rows, cache
        length, max_new, sampling mode, pads given, ...; not the
        temperature, which the step reads from device memory),
        the encoder output's shape and dtype, the model's dtype and int8
        flags, the index the no-speech probability is read at, whether the
        call is graphed, and what the layer norms' promoted parameters are
        cached on (host state a graph reads)."""
        m = self.model
        norms = tuple((n.weight.data_ptr(), n.weight._version,
                       n.bias.data_ptr(), n.bias._version)
                      for n in self._layer_norms)
        return (kind, prompt_len, *shape, tuple(xa.shape[1:]), xa.dtype,
                xa.device, m.dtype, m.quant_decoder, self.opt.cross_kv_quant,
                self._sot_pos(prompt_len), graph, norms)

    def _workspace(self, key: tuple, make) -> Tuple[DecodeWorkspace, bool]:
        """The workspace of `key` (made by make() where there is none, and
        fitted into WORKSPACE_BUDGET); with whether it is new."""
        DECODE_STEPS["calls"] += 1
        ws = WORKSPACES.get(self, key)
        if ws is not None:
            DECODE_STEPS["hits"] += 1
            return ws, False
        DECODE_STEPS["misses"] += 1
        ws = make()
        ws.measure()
        DECODE_STEPS["evictions"] += WORKSPACES.put(self, key, ws,
                                                    WORKSPACE_BUDGET)
        return ws, True

    def _setup_cross(self, ws: DecodeWorkspace) -> List:
        """The set-up's cross-attention memory: the k/v projections of the
        workspace's xa, quantized to int8 when the options ask for it,
        into the workspace one layer at a time (so that one layer's
        temporaries are alive at once; the same operations in the same
        order, so the same values, as projecting every layer first). The
        int8 step's products of the memory's scales are made here too
        (MHA.bind_q_scales)."""
        model, cross = self.model, []
        for i, blk in enumerate(model.decoder.blocks):
            (k, v), = model.precompute_cross_kv(ws.t["xa"], layers=[i])
            if self.opt.cross_kv_quant:
                (*mem, s_valid), = model.quantize_cross_kv([(k, v)])
                mem = [ws.into(("cross", i, j), x) for j, x in enumerate(mem)]
                ws.t[("q", i)] = blk.cross_attn.bind_q_scales(
                    mem[1], mem[3], ws.t.get(("q", i)))
                cross.append((*mem, s_valid))
            else:
                cross.append((ws.into(("cross", i, 0), k),
                              ws.into(("cross", i, 1), v)))
            del k, v
        ws.cross = cross
        return cross

    def _run_call(self, ws: DecodeWorkspace, setup, step, max_new: int,
                  graph: bool, t_call: float, gens) -> None:
        """A decode call in its workspace: the set-up, then the steps
        (_run_steps). Graphed, the key's first call runs the set-up
        eagerly on the capture stream and captures it; later calls replay
        it. DECODE_STEPS takes the set-up's host seconds (from t_call) and
        the capture's apart. The spans stage.decode.setup and
        stage.decode.steps lie around the set-up and the steps, outside
        what the graphs capture."""
        with span("stage.decode.setup"):
            if not graph:
                setup()
            elif ws.setup_graph is None:
                cur, side = torch.cuda.current_stream(), capture_stream()
                side.wait_stream(cur)
                with torch.cuda.stream(side):
                    setup()
                cur.wait_stream(side)
                t = time.perf_counter()
                DECODE_STEPS["prefill_s"] += t - t_call
                ws.setup_graph = StepGraph(setup, _COUNTERS, pool=ws.pool())
                DECODE_STEPS["captures"] += 1
                DECODE_STEPS["capture_s"] += ws.setup_graph.capture_s
                t_call = time.perf_counter()
            else:
                ws.setup_graph.replay()
        DECODE_STEPS["prefill_s"] += time.perf_counter() - t_call
        with span("stage.decode.steps"):
            self._run_steps(step, max_new, ws.st["finished"],
                            ws if graph else False, gens)

    def _finish_call(self, ws: DecodeWorkspace, fresh: bool, gens) -> None:
        ws.hand_back(gens)
        if fresh:
            # the graphs' pool is known now
            ws.measure()
            DECODE_STEPS["evictions"] += WORKSPACES.fit(WORKSPACE_BUDGET)
        DECODE_STEPS["workspace_bytes"] = WORKSPACES.nbytes

    def _run_steps(self, step, max_new: int, finished: torch.Tensor,
                   graph, generators: Sequence[torch.Generator] = ()
                   ) -> None:
        """Decode steps 0 .. max_new - 1 through ``step(first)``, which
        updates the loop's state in place and advances its step counter;
        stop early once ``finished`` is all true. graph: False runs every
        step eagerly (the CPU path, and the card's comparison); else the
        call's DecodeWorkspace: at its key's first call step 0 runs
        eagerly on the capture stream (the warm-up), then ``step(True)``
        and ``step(False)`` are captured into its step-0 and step graphs;
        every later call replays step 0's graph; the later steps replay
        the step graph. generators: the workspace's, registered with the
        graphs.

        finished.all() is read after every FINISHED_CHECK_EVERY-th step:
        the read after step i is posted without blocking and waited on
        only after step i + 1 is enqueued, so the card always has a step
        queued while the host waits, and at most one step runs past the
        step where every row finished. The host seconds of each part go
        to DECODE_STEPS."""
        if max_new <= 0:
            return
        read, gate = _FinishedRead(finished), None

        def stop_after(i: int) -> bool:
            """Step i is enqueued: wait on the read posted after step
            i - 1 (it gates step i + 1), then post the read after step i
            (it gates step i + 2). True when every row had finished by
            step i - 1, so step i ran past the end."""
            nonlocal gate
            if gate == i + 1:
                t = time.perf_counter()
                done = read.wait()
                DECODE_STEPS["read_s"] += time.perf_counter() - t
                gate = None
                if done:
                    return True
            if (i + 2) % FINISHED_CHECK_EVERY == 0 and i + 2 < max_new:
                read.post()
                gate = i + 2
            return False

        t0 = time.perf_counter()
        if not graph:
            step(True)
            DECODE_STEPS["eager"] += 1
        elif graph.step_graphs is None:
            # the warm-up on the capture stream: every kernel library is
            # loaded and its attributes set before the captures
            cur, side = torch.cuda.current_stream(), capture_stream()
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                step(True)
            cur.wait_stream(side)
            DECODE_STEPS["eager"] += 1
            DECODE_STEPS["step0_s"] += time.perf_counter() - t0
            graph.step_graphs = tuple(
                StepGraph(lambda first=first: step(first), _COUNTERS,
                          generators, pool=graph.pool())
                for first in (True, False))
            DECODE_STEPS["captures"] += 2
            DECODE_STEPS["capture_s"] += sum(g.capture_s
                                             for g in graph.step_graphs)
            t0 = time.perf_counter()
        else:
            graph.step_graphs[0].replay()
            DECODE_STEPS["replayed"] += 1
        DECODE_STEPS["step0_s"] += time.perf_counter() - t0
        replay = graph.step_graphs[1] if graph else None
        if replay is not None:
            launch_s, count_s = replay.launch_s, replay.count_s
        try:
            if stop_after(0):
                return
            for i in range(1, max_new):
                if replay is None:
                    step(False)
                    DECODE_STEPS["eager"] += 1
                else:
                    replay.replay()
                    DECODE_STEPS["replayed"] += 1
                if stop_after(i):
                    break
        finally:
            if replay is not None:
                DECODE_STEPS["launch_s"] += replay.launch_s - launch_s
                DECODE_STEPS["count_s"] += replay.count_s - count_s

    def _lengths(self, prompt_len: int) -> Tuple[int, int]:
        """(max_new, cache_len) of a decode after a prompt_len-token
        prompt: never past n_text_ctx; the self-KV cache sized to what the
        decode can write (prompt + max_new rounded up to 64 slots), as
        every step reads the whole cache."""
        n_ctx = self.model.dims.n_text_ctx
        max_new = min(self.opt.max_new_tokens, n_ctx - prompt_len)
        return max_new, min(-(-(max_new + prompt_len) // 64) * 64, n_ctx)

    def _sot_pos(self, prompt_len: int) -> int:
        """Index of <|startoftranscript|> in a prompt that ends with the
        sot sequence (where whisper reads the no-speech probability)."""
        return prompt_len - 1 - (2 if len(self.tok.sot_sequence) == 3
                                 else 0)

    @torch.no_grad()
    def _decode_loop(self, xa: torch.Tensor, prompt_len: int,
                     prompt_tokens: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     temperature: float = 0.0,
                     pad_lens: Optional[torch.Tensor] = None,
                     row_generators: Optional[Sequence[torch.Generator]]
                     = None, graph: Optional[bool] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """xa: [B, 1500, D]; prompt_tokens: [B, prompt_len].

        temperature > 0 samples with the gumbel trick (whisper's fallback
        path) from ``generator`` ([B, V] noise per step) or, when given,
        from one generator per row ([V] noise per row per step, so a row
        draws as a B=1 decode with that generator would); the generators
        are left as the draws advanced them. temperature 0 is greedy
        argmax. pad_lens: optional [B] int32 — per-row prompts
        RIGHT-ALIGNED in the prompt_len bucket with pad_lens[b] masked
        left-pad slots. graph: None replays the key's CUDA graphs on the
        card (see _run_call, _run_steps); False runs eagerly. Returns
        (tokens [B, max_new] int64, stats [B, 3] = sum_logprob || length
        || no_speech_prob), tensors of their own."""
        t_call = time.perf_counter()
        model, tok = self.model, self.tok
        dev = xa.device
        B = xa.shape[0]
        max_new, cache_len = self._lengths(prompt_len)
        sample = temperature > 0 and (generator is not None
                                      or row_generators is not None)
        per_row = sample and row_generators is not None
        gens = (list(row_generators) if per_row else [generator]) \
            if sample else []
        graph = xa.is_cuda if graph is None else bool(graph)
        # the temperature is read from device memory (set_temperature), so
        # every rung of the fallback ladder shares a key
        with span("stage.decode.prepare"):
            key = self._key("greedy", xa, graph, prompt_len, B, cache_len,
                            max_new, ("rows" if per_row else "one")
                            if sample else "none", pad_lens is not None)
            ws, fresh = self._workspace(key, lambda: DecodeWorkspace(
                dev, len(gens), self._init_state(B),
                caches=model.empty_kv_caches(B, cache_len=cache_len),
                tokens=torch.empty((B, max_new), dtype=torch.long,
                                   device=dev),
                sum_lp=torch.empty(B, dtype=torch.float32, device=dev),
                step_t=torch.empty((), dtype=torch.long, device=dev),
                temperature=torch.empty((), dtype=torch.float32,
                                        device=dev)))
            ws.load(xa, prompt_tokens, pad_lens, gens)
            if sample:
                set_temperature(ws.t["temperature"], temperature)
        t, st = ws.t, ws.st
        tokens_buf, sum_lp, step_t = t["tokens"], t["sum_lp"], t["step_t"]
        pads = t["pads"] if pad_lens is not None else None
        sot_pos = self._sot_pos(prompt_len)

        def setup() -> None:
            cross = self._setup_cross(ws)
            for ck, cv in t["caches"]:
                ck.zero_()
                cv.zero_()
            logits, _, _ = model.decoder(t["prompt"], t["xa"], 0,
                                         t["caches"], cross_kvs=cross,
                                         pad_lens=pads)
            ws.into("nsp", torch.softmax(logits[:, sot_pos],
                                         dim=-1)[:, tok.no_speech])
            ws.into("cur_logits", logits[:, -1])
            tokens_buf.fill_(self._eot)
            self._reset_state(st)
            sum_lp.zero_()
            step_t.zero_()

        def step(first: bool) -> None:
            cur_logits = t["cur_logits"]
            lg = self._filter(cur_logits, st, 0 if first else 1)
            if sample:
                if per_row:
                    g = torch.stack([gumbel_noise(lg.shape[-1], gen, dev)
                                     for gen in ws.gens])
                else:
                    g = gumbel_noise(lg.shape, ws.gens[0], dev)
                next_tok = torch.argmax(
                    by_temperature(lg, t["temperature"]) + g, dim=-1)
            else:
                next_tok = torch.argmax(lg, dim=-1)
            # score from the post-filter renormalized distribution
            # (whisper's, and the beam path's)
            lp = torch.log_softmax(lg, dim=-1)
            tok_lp = lp.gather(1, next_tok[:, None])[:, 0]
            finished = st["finished"]
            next_tok = next_tok.masked_fill(finished, self._eot)
            is_eot = next_tok == self._eot
            sum_lp.add_(tok_lp.masked_fill(finished, 0.0))
            st["length"].add_((~(finished | is_eot)).long())
            new_finished = finished | is_eot
            is_ts = (next_tok >= self._ts_begin) & ~new_finished
            st["last_ts"].copy_(torch.where(is_ts, next_tok, st["last_ts"]))
            st["any_ts"].logical_or_(is_ts)
            st["prev_prev_was_ts"].copy_(st["prev_was_ts"])
            st["prev_was_ts"].copy_(is_ts)
            st["finished"].copy_(new_finished)
            tokens_buf.index_copy_(1, step_t.reshape(1), next_tok[:, None])
            new_logits, _, _ = model.decoder(
                next_tok[:, None], t["xa"], prompt_len + step_t,
                t["caches"], cross_kvs=ws.cross, pad_lens=pads)
            cur_logits.copy_(new_logits[:, 0])
            step_t.add_(1)

        self._run_call(ws, setup, step, max_new, graph, t_call, ws.gens)
        self._finish_call(ws, fresh, gens)
        stats = torch.stack([sum_lp, st["length"].float(), t["nsp"]], dim=1)
        return tokens_buf.clone(), stats

    # ------------------------------------------------------------------
    def _initial_tokens(self, prompt: Optional[Sequence[int]]) -> List[int]:
        """sot_prev + the prompt's last n_text_ctx//2 - 1 tokens, then the
        sot sequence (whisper's condition_on_previous_text)."""
        tok = self.tok
        prefix = list(prompt) if prompt else []
        if prefix:
            prefix = [tok.specials.sot_prev] + \
                prefix[-(self.model.dims.n_text_ctx // 2 - 1):]
        return prefix + tok.sot_sequence

    def decode(self, xa: torch.Tensor,
               prompt: Optional[Sequence[int]] = None,
               temperature: float = 0.0,
               generator: Optional[torch.Generator] = None) -> Dict:
        """Greedy (or temperature-sampled) decode of a batch of windows.

        prompt: optional previous-context token ids (prepended with
        sot_prev per whisper's condition_on_previous_text).
        Returns dict: tokens (lists), avg_logprob, no_speech_prob (numpy).
        """
        initial = self._initial_tokens(prompt)
        B = xa.shape[0]
        if temperature > 0 and generator is None:
            generator = torch.Generator(device=xa.device).manual_seed(0)
        cap = max(self.opt.max_rows_per_dispatch, 1)
        outs = []
        for c0 in range(0, B, cap):
            xa_c = xa[c0:c0 + cap]
            with span("stage.decode.prepare"):
                prompt_tokens = torch.tensor(initial, dtype=torch.long,
                                             device=xa.device
                                             ).repeat(xa_c.shape[0], 1)
            t, s = self._decode_loop(xa_c, len(initial), prompt_tokens,
                                     generator, float(temperature))
            with span("stage.decode.readback"):
                outs.append((t.cpu().numpy(), s.cpu().numpy()))
        with span("stage.decode.unpack"):
            tokens = np.concatenate([t for t, _ in outs])
            stats = np.concatenate([s for _, s in outs])
            return self._unpack_decode(tokens, stats)

    def _unpack_decode(self, tokens: np.ndarray, stats: np.ndarray) -> Dict:
        sum_lp, length, nsp = stats[:, 0], stats[:, 1], stats[:, 2]
        avg_lp = sum_lp / np.maximum(length + 1, 1)
        out_tokens = []
        for b in range(tokens.shape[0]):
            t = tokens[b]
            end = np.argmax(t == self._eot) if (t == self._eot).any() \
                else len(t)
            out_tokens.append(t[:end].tolist())
        return dict(tokens=out_tokens, avg_logprob=avg_lp,
                    no_speech_prob=nsp)

    def _pack_prompts(self, prompts: Sequence[Optional[Sequence[int]]]
                      ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Right-align per-row prompt prefixes in a power-of-two bucket.
        Returns (tokens [B, P_pad], pad_lens [B], P_pad)."""
        prefixes = [self._initial_tokens(pr) for pr in prompts]
        P = max(len(p) for p in prefixes)
        P_pad = 1 << max(2, (P - 1).bit_length())
        toks = np.full((len(prefixes), P_pad), self.tok.sot, np.int64)
        pads = np.zeros(len(prefixes), np.int32)
        for b, p in enumerate(prefixes):
            toks[b, P_pad - len(p):] = p
            pads[b] = P_pad - len(p)
        return toks, pads, P_pad

    @staticmethod
    def _concat_results(outs: List[Dict]) -> Dict:
        return dict(
            tokens=[t for o in outs for t in o["tokens"]],
            avg_logprob=np.concatenate([o["avg_logprob"] for o in outs]),
            no_speech_prob=np.concatenate(
                [o["no_speech_prob"] for o in outs]))

    def decode_prompted(self, xa: torch.Tensor,
                        prompts: Sequence[Optional[Sequence[int]]],
                        temperature: float = 0.0,
                        generator: Optional[torch.Generator] = None,
                        generators: Optional[Sequence[torch.Generator]]
                        = None) -> Dict:
        """Batched decode with a DIFFERENT prompt per row
        (condition_on_previous_text across streams): prompts are
        right-aligned in a power-of-two bucket with masked left-pad, so
        the whole batch runs as one loop. Batches larger than
        max_rows_per_dispatch split into chunks.

        Same contract as decode(); equal to per-row decode() at
        temperature 0. generators: optional per-row generators — row b
        samples exactly as a B=1 decode with generators[b]; generator: one
        generator for the whole batch."""
        B = xa.shape[0]
        cap = max(self.opt.max_rows_per_dispatch, 1)
        if B > cap:
            return self._concat_results([
                self.decode_prompted(
                    xa[c0:c0 + cap], list(prompts)[c0:c0 + cap],
                    temperature, generator,
                    list(generators)[c0:c0 + cap]
                    if generators is not None else None)
                for c0 in range(0, B, cap)])
        if temperature > 0 and generator is None and generators is None:
            generator = torch.Generator(device=xa.device).manual_seed(0)
        with span("stage.decode.prepare"):
            toks, pads, P_pad = self._pack_prompts(prompts)
            toks = torch.from_numpy(toks).to(xa.device)
            pads = torch.from_numpy(pads).to(xa.device)
        tokens, stats = self._decode_loop(
            xa, P_pad, toks, generator, float(temperature), pad_lens=pads,
            row_generators=generators)
        with span("stage.decode.readback"):
            tokens, stats = tokens.cpu().numpy(), stats.cpu().numpy()
        with span("stage.decode.unpack"):
            return self._unpack_decode(tokens, stats)


# --------------------------------------------------------------------------
# word-level timestamps (teacher-forced cross-attention + DTW)
# --------------------------------------------------------------------------

def dtw_path(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Monotonic DTW over cost [N, M] in float64; returns the alignment
    path (text indices, time indices).

    Runs in the native core native/dtw.cpp whenever it loads, on the same
    float64 upcast as the numpy DP, so both give the same path bit for
    bit; _dtw_path_numpy is its twin and the fallback without a
    compiler."""
    N, M = cost.shape
    lib = load_native("dtw")
    if lib is None:
        return _dtw_path_numpy(cost)
    c = np.ascontiguousarray(cost, np.float64)
    ti = np.empty(N + M, np.int32)
    tj = np.empty(N + M, np.int32)
    n = lib.dtw_path(ptr(c), N, M, ptr(ti), ptr(tj))
    DECODE_STEPS["dtw_native"] += 1
    return ti[:n].astype(np.int64), tj[:n].astype(np.int64)


def _dtw_path_numpy(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """dtw_path as a numpy DP. D[i, j] = cost + min(D[i-1, j-1],
    D[i-1, j], D[i, j-1]) runs one anti-diagonal at a time (every cell of
    a diagonal depends only on the two before it), so each of the N+M-1
    diagonals is one vectorized numpy step. Ties break as in the JAX
    package's reference DP: diagonal <= up < left."""
    N, M = cost.shape
    c = np.asarray(cost, np.float64)
    D = np.full((N + 1, M + 1), np.inf)
    D[0, 0] = 0.0
    trace = np.zeros((N + 1, M + 1), np.int8)
    for k in range(2, N + M + 1):         # i + j == k, 1 <= i <= N, 1 <= j <= M
        i = np.arange(max(1, k - M), min(N, k - 1) + 1)
        j = k - i
        c0, c1, c2 = D[i - 1, j - 1], D[i - 1, j], D[i, j - 1]
        diag = (c0 <= c1) & (c0 <= c2)
        up = ~diag & (c1 < c2)
        D[i, j] = c[i - 1, j - 1] + np.where(diag, c0,
                                             np.where(up, c1, c2))
        trace[i, j] = np.where(diag, 0, np.where(up, 1, 2))
    i, j = N, M
    text_idx, time_idx = [], []
    while i > 0 and j > 0:
        text_idx.append(i - 1)
        time_idx.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.array(text_idx[::-1]), np.array(time_idx[::-1])


def dtw_token_starts(neg_cost: np.ndarray, n_rows: int,
                     n_cols: int) -> np.ndarray:
    """Each token row's first DTW path frame over neg_cost[:n_rows,
    :n_cols] (the only DTW output word timing needs). Rows the path never
    visits read n_cols."""
    T = neg_cost.shape[0]
    tstart = np.full(T, float(n_cols))
    if n_rows > 0 and n_cols > 0:
        ti, tj = dtw_path(neg_cost[:n_rows, :n_cols])
        # the path's text index never decreases: a row's first frame is
        # where its index first appears
        first = np.flatnonzero(np.diff(ti, prepend=-1))
        tstart[ti[first]] = tj[first]
    return tstart


def decode_alignment_heads(blob: str, n_text_layer: int,
                           n_text_head: int) -> List[Tuple[int, int]]:
    """Decode whisper's compact alignment-heads mask: a base85-encoded
    gzipped [n_text_layer, n_text_head] boolean mask selecting the
    cross-attention heads whose maps are reliable for DTW word alignment.
    Returns the selected (layer, head) pairs."""
    arr = np.frombuffer(gzip.decompress(base64.b85decode(blob)),
                        dtype=bool).copy()
    arr = arr.reshape(n_text_layer, n_text_head)
    ls, hs = np.nonzero(arr)
    return list(zip(ls.tolist(), hs.tolist()))


def encode_alignment_heads(pairs: List[Tuple[int, int]], n_text_layer: int,
                           n_text_head: int) -> str:
    """Inverse of decode_alignment_heads (for tests / sidecar authoring)."""
    arr = np.zeros((n_text_layer, n_text_head), bool)
    for l, h in pairs:
        arr[l, h] = True
    return base64.b85encode(gzip.compress(arr.tobytes())).decode()


PREPEND_PUNCTUATIONS = "\"'“¿([{-"
APPEND_PUNCTUATIONS = "\"'.。,，!！?？:：”)]}、"


def merge_punctuations(words: List[Dict],
                       prepended: str = PREPEND_PUNCTUATIONS,
                       appended: str = APPEND_PUNCTUATIONS) -> List[Dict]:
    """Fold standalone punctuation 'words' into their neighbors (whisper's
    timing.merge_punctuations): a leading-space punctuation mark merges
    into the FOLLOWING word (keeping the follower's times), a bare
    punctuation mark merges into the PRECEDING word (keeping that word's
    times)."""
    ws = [dict(w) for w in words]

    def _absorb(dst, src):
        # the absorbing word inherits the punctuation's tokens (the emptied
        # entry keeps no tokens and is skipped by distribution)
        dst["n_tokens"] = dst.get("n_tokens", 1) + src.get("n_tokens", 1)
        src["n_tokens"] = 0

    # prepended punctuation: scan backwards
    i, j = len(ws) - 2, len(ws) - 1
    while i >= 0:
        prev, foll = ws[i], ws[j]
        if prev["word"].startswith(" ") and prev["word"].strip() in prepended:
            foll["word"] = prev["word"] + foll["word"]
            _absorb(foll, prev)
            prev["word"] = ""
        else:
            j = i
        i -= 1
    # appended punctuation: scan forwards
    i, j = 0, 1
    while j < len(ws):
        prev, foll = ws[i], ws[j]
        if not prev["word"].endswith(" ") and foll["word"] in appended:
            prev["word"] = prev["word"] + foll["word"]
            _absorb(prev, foll)
            foll["word"] = ""
        else:
            i = j
        j += 1
    return [w for w in ws if w["word"]]


@torch.no_grad()
def _alignment_pass(model: WhisperModel, heads_key, eot: int,
                    toks: torch.Tensor, xa: torch.Tensor,
                    n_real: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Batched teacher-forced alignment pass, reduced on device: the
    decoder's cross-attention from the selected heads, z-normed per
    (head, frame) over the real token rows, width-7 median filtered per
    head, averaged over heads (kernels.align_reduce); plus each next
    token's probability under the text-vocabulary softmax. The median
    filter sees the full 1500-frame width, as in the JAX package.

    toks [B, L]; xa [B, 1500, D]; n_real [B]. Returns (matrix [B, L, F]
    f32, next-token probabilities [B, L-1]); on the card a window's rows
    from n_real on are zeros."""
    kind, sel = heads_key
    logits, _, cross = model.decoder(toks, xa, 0, None,
                                     return_cross_attn=True)
    heads = sel if kind == "heads" else \
        [(l, h) for l in sel for h in range(cross[l].shape[1])]
    matrix = kernels.align_reduce(cross, heads, n_real)
    probs = torch.softmax(logits[..., :eot], dim=-1)
    nxt = toks[:, 1:].clamp(0, eot - 1)
    tok_probs = probs[:, :-1].gather(2, nxt[..., None])[..., 0]
    return matrix, tok_probs


def find_word_timestamps(model: WhisperModel, tokenizer: WhisperTokenizer,
                         xa_single: torch.Tensor, text_tokens: List[int],
                         num_frames: int, time_offset: float = 0.0,
                         alignment_layers: Optional[List[int]] = None,
                         alignment_heads: Optional[List[Tuple[int, int]]]
                         = None, merge: bool = True) -> List[Dict]:
    """Teacher-forced pass + DTW ->
    [{'word','start','end','probability','n_tokens'} ...] for one window
    (xa_single [1, 1500, D]). See find_word_timestamps_batch."""
    return find_word_timestamps_batch(
        model, tokenizer, [xa_single], [text_tokens], [num_frames],
        [time_offset], alignment_layers=alignment_layers,
        alignment_heads=alignment_heads, merge=merge)[0]


# sub-batch cap per alignment call: one layer's cross-attention is
# [B, n_head, L, 1500] f32 and every layer's is kept for the reduction
_ALIGN_MAX_BS_LAYERS = 12
_ALIGN_MAX_BS_HEADS = 24


def find_word_timestamps_batch(model: WhisperModel,
                               tokenizer: WhisperTokenizer,
                               xa_list: List[torch.Tensor],
                               text_tokens_list: List[List[int]],
                               num_frames_list: List[int],
                               time_offsets: Optional[List[float]] = None,
                               alignment_layers: Optional[List[int]] = None,
                               alignment_heads: Optional[List[Tuple[int, int]]]
                               = None, merge: bool = True
                               ) -> List[List[Dict]]:
    """Batched word timestamps over many (window, tokens) pairs.

    Items are bucketed by padded token length (eot padding; causality
    keeps the real prefix rows unchanged) and chunked to bound the
    cross-attention memory. alignment_heads: optional per-model
    (layer, head) selection (see decode_alignment_heads); without it all
    heads of the last half of the layers are used (whisper's default for
    models without a mask). merge=False returns the raw per-word
    alignment, so the caller can run the duration hacks before
    merge_punctuations as whisper's add_word_timestamps does."""
    d = model.dims
    if alignment_heads:
        alignment_layers = sorted({l for l, _ in alignment_heads})
    elif alignment_layers is None:
        alignment_layers = list(range(d.n_text_layer // 2, d.n_text_layer))
    if time_offsets is None:
        time_offsets = [0.0] * len(xa_list)
    heads_key = (("heads", tuple((int(l), int(h))
                                 for l, h in alignment_heads))
                 if alignment_heads else
                 ("layers", tuple(int(i) for i in alignment_layers)))
    max_bs = _ALIGN_MAX_BS_HEADS if alignment_heads else \
        _ALIGN_MAX_BS_LAYERS
    sot_len = len(tokenizer.sot_sequence) + 1
    eot = int(tokenizer.eot)

    items = []
    for i, text_tokens in enumerate(text_tokens_list):
        full = tokenizer.sot_sequence + [tokenizer.no_timestamps] + \
            list(text_tokens) + [tokenizer.eot]
        L = len(full)
        pad_to = min(max(32, 1 << (L - 1).bit_length()), d.n_text_ctx)
        if L > pad_to:
            raise ValueError(f"{L} tokens exceed the decoder context")
        items.append((pad_to, i, full, L))

    results: List[Optional[List[Dict]]] = [None] * len(xa_list)
    buckets: Dict[int, list] = {}
    for it in items:
        buckets.setdefault(it[0], []).append(it)
    for pad_to, bucket in sorted(buckets.items()):
        for c0 in range(0, len(bucket), max_bs):
            chunk = bucket[c0:c0 + max_bs]
            with span("stage.word_ts.pass"):
                B = len(chunk)
                toks = np.full((B, pad_to), eot, np.int64)
                n_real = np.zeros(B, np.int64)
                for j, (_, i, full, L) in enumerate(chunk):
                    toks[j, :L] = full
                    n_real[j] = L
                xa = torch.cat([xa_list[i] for _, i, _, _ in chunk], dim=0)
                dev = xa.device
                matrix, probs = _alignment_pass(
                    model, heads_key, eot, torch.from_numpy(toks).to(dev),
                    xa, torch.from_numpy(n_real).to(dev))
                # DTW rows: the text-token slice of each item's matrix
                rows = -matrix[:, sot_len:-1]
            with span("stage.word_ts.readback"):
                rows, probs = rows.cpu().numpy(), probs.cpu().numpy()
            for j, (_, i, full, L) in enumerate(chunk):
                n_text = len(text_tokens_list[i])
                with span("stage.word_ts.dtw"):
                    tstart = dtw_token_starts(rows[j], L - sot_len - 1,
                                              num_frames_list[i] // 2)
                with span("stage.word_ts.words"):
                    results[i] = _finish_word_timestamps(
                        tstart[:n_text], probs[j], tokenizer,
                        text_tokens_list[i], num_frames_list[i],
                        time_offsets[i], merge)
                DECODE_STEPS["align_windows"] += 1
    return results


def _finish_word_timestamps(tstart: np.ndarray, tok_probs: np.ndarray,
                            tokenizer: WhisperTokenizer,
                            text_tokens: List[int], num_frames: int,
                            time_offset: float, merge: bool) -> List[Dict]:
    """Host tail of the alignment: token start frames -> word dicts.

    tstart: [n_text] each token row's first DTW path frame; tok_probs:
    next-token probabilities under the text-vocabulary softmax (whisper
    timing.find_alignment), averaged over a word's tokens for its
    probability — which feeds the hallucination anomaly score."""
    n_text = len(text_tokens)
    sot_len = len(tokenizer.sot_sequence) + 1
    text_token_probs = tok_probs[sot_len - 1:sot_len - 1 + n_text]
    if n_text == 0 or num_frames // 2 == 0:
        return []

    words, word_tokens = tokenizer.split_to_word_tokens(list(text_tokens))
    if not words:
        return []
    # first path time of each token row (the 'jump' into that row), plus
    # a sentinel end time at the window's valid extent
    n_tok = n_text
    token_start = np.full(n_tok + 1, (num_frames // 2) * 0.02)
    token_start[:n_tok] = np.minimum(tstart, num_frames // 2) * 0.02
    token_start = np.maximum.accumulate(token_start)   # monotonic fill
    out = []
    pos = 0
    for word, wt in zip(words, word_tokens):
        start = token_start[min(pos, n_tok)]
        end = token_start[min(pos + len(wt), n_tok)]
        prob = float(np.mean(text_token_probs[pos:pos + len(wt)])) \
            if len(wt) and pos + len(wt) <= n_text else 0.0
        out.append(dict(word=word, start=time_offset + float(start),
                        end=time_offset + float(max(end, start)),
                        probability=prob, n_tokens=len(wt)))
        pos += len(wt)
    if merge:
        return merge_punctuations(out)
    return out
