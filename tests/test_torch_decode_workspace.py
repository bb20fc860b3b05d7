"""The decode workspaces (asr/decoding.py DecodeWorkspace, the cache
utils/cuda_graph.py WorkspaceCache): a decode call of a key that ran
before reuses that call's tensors (on the card its three CUDA graphs),
and must give what a fresh decoder gives on its inputs, and what the JAX
decoder gives on the same weights. On the CPU every call runs eagerly in
its workspace, so these tests hold the copy-in of the inputs, the reset
of the state, the generators' hand-over and the keys; the card's cases
are in test_torch_decode_graph.py.
"""
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from notsofar_tpu.asr import beam as jbeam
from notsofar_tpu.asr import decoding as jdec
from notsofar_tpu_torch.asr import beam as tbeam
from notsofar_tpu_torch.asr import decoding as tdec
from notsofar_tpu_torch.asr import transcribe as ttr
from notsofar_tpu_torch.utils.cuda_graph import WorkspaceCache
from tests.test_torch_whisper import (int8_pair, mini_tokenizers,  # noqa
                                      pair, torch_threads)

# three calls of one key: the prompts differ but share the 8-token bucket
PROMPTS = ([[5, 6], None], [[7, 8, 9], [3]], [None, [40, 41, 42, 43]])


def _xa(seed, B=2):
    return np.random.RandomState(seed).randn(B, 96, 128).astype(
        np.float32) * 0.2


class Blob:
    """A workspace stand-in: its bytes, and whether it was released."""

    def __init__(self, nbytes):
        self.nbytes = nbytes
        self.released = False

    def release(self):
        self.released = True


class Owner:
    pass


def test_workspace_cache_evicts_the_least_recently_used():
    """Entries by (owner, key); a get makes the entry the most recently
    used; fitting the budget releases the least recently used first and
    always keeps the most recent one, even above the budget."""
    cache, a, b = WorkspaceCache(), Owner(), Owner()
    w = {k: Blob(n) for k, n in (("x", 40), ("y", 30), ("z", 50))}
    assert cache.put(a, "x", w["x"], 100) == 0
    assert cache.put(b, "x", w["y"], 100) == 0      # another owner's "x"
    assert cache.get(b, "x") is w["y"] and cache.get(a, "x") is w["x"]
    assert cache.get(a, "y") is None
    assert cache.keys() == ["x", "x"] and cache.nbytes == 70
    # a's "x" was used last: b's goes first
    assert cache.put(a, "z", w["z"], 100) == 1
    assert w["y"].released and not w["x"].released
    assert cache.get(b, "x") is None and cache.nbytes == 90
    assert cache.fit(10) == 1 and w["x"].released and len(cache) == 1
    assert cache.get(a, "z") is w["z"] and not w["z"].released


def test_workspace_cache_drops_a_collected_owners_entries():
    cache, a, b = WorkspaceCache(), Owner(), Owner()
    wa, wb = Blob(1), Blob(1)
    cache.put(a, "k", wa, 100)
    cache.put(b, "k", wb, 100)
    del a
    gc.collect()
    assert len(cache) == 1 and wa.released and not wb.released
    assert cache.get(b, "k") is wb


@pytest.mark.parametrize("temperature", [0.2, 0.4, 0.6, 0.8, 1.0])
def test_temperature_from_memory_divides_as_a_host_scalar(temperature):
    """The sampled step's temperature, read from a tensor so that one
    workspace serves every rung, scales the logits bit for bit as
    ``logits / temperature`` with a host scalar (the card's twin is in
    test_torch_decode_graph.py)."""
    lg = torch.randn(15, 1864, generator=torch.Generator().manual_seed(0))
    buf = torch.empty(())
    tdec.set_temperature(buf, temperature)
    assert torch.equal(tdec.by_temperature(lg * 8, buf), lg * 8 / temperature)


def _steps(fn):
    """fn()'s result and the DECODE_STEPS it added."""
    before = dict(tdec.DECODE_STEPS)
    out = fn()
    return out, {k: tdec.DECODE_STEPS[k] - before[k]
                 for k in ("calls", "hits", "misses", "captures")}


def _same(a, b):
    """Two decode results equal bit for bit."""
    assert a["tokens"] == b["tokens"]
    np.testing.assert_array_equal(a["avg_logprob"], b["avg_logprob"])
    np.testing.assert_array_equal(a["no_speech_prob"], b["no_speech_prob"])


def _near_jax(t, j):
    assert t["tokens"] == j["tokens"]
    np.testing.assert_allclose(t["avg_logprob"], j["avg_logprob"], atol=1e-4)
    np.testing.assert_allclose(t["no_speech_prob"], j["no_speech_prob"],
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["greedy", "beam3", "beam3_unified",
                                  "int8_greedy"])
def test_reused_workspace_equals_a_fresh_decoder_and_jax(pair, kind):  # noqa: F811
    """Three prompted calls of one key on one decoder (xa and prompts
    differ; one prompt bucket): the first makes the workspace, the next
    two reuse it. Each equals a fresh decoder's call on its inputs bit for
    bit, and the JAX decoder's on the same weights (tokens equal,
    avg_logprob within 1e-4). Greedy, beam 3 on the split and the unified
    cache, and the int8 decoder with int8 cross-attention K/V (its step
    reads the memory's scale products, remade at every set-up)."""
    jm, variables, tm = pair
    if kind.startswith("int8"):
        jm, variables, tm = int8_pair(variables, "f32")
    jt, tt = mini_tokenizers()
    opts = dict(max_new_tokens=8, cross_kv_quant=kind.startswith("int8"))
    if kind.startswith("beam3"):
        jd = jbeam.BeamDecoder(jm, jt, jdec.DecodeOptions(**opts),
                               beam_size=3, cache_dtype=jnp.float32)

        def make():
            return tbeam.BeamDecoder(tm, tt, tdec.DecodeOptions(**opts),
                                     beam_size=3, cache_dtype=torch.float32,
                                     split_cache=kind == "beam3")
    else:
        jd = jdec.GreedyDecoder(jm, jt, jdec.DecodeOptions(**opts))

        def make():
            return tdec.GreedyDecoder(tm, tt, tdec.DecodeOptions(**opts))
    dec = make()
    for i, prompts in enumerate(PROMPTS):
        xa = _xa(20 + i)
        got, st = _steps(lambda: dec.decode_prompted(torch.from_numpy(xa),
                                                     prompts))
        assert st == dict(calls=1, hits=int(i > 0), misses=int(i == 0),
                          captures=0)
        _same(got, make().decode_prompted(torch.from_numpy(xa), prompts))
        _near_jax(got, jd.decode_prompted(variables, jnp.asarray(xa),
                                          prompts))


def test_reused_sampled_workspace_draws_as_fresh_generators(pair):  # noqa: F811
    """Sampled calls with per-row generators (the fallback ladder's) on one
    decoder: each reused call equals a fresh decoder's with fresh
    generators of the same seeds, and leaves its generators where the
    fresh call leaves them. One generator over chunks (decode with
    max_rows_per_dispatch 2 on 4 rows: the second chunk reuses the
    first's workspace) draws as two fresh decoders handed one generator
    in turn."""
    _, _, tm = pair
    _, tt = mini_tokenizers()
    opts = tdec.DecodeOptions(max_new_tokens=8, max_rows_per_dispatch=2)
    dec = tdec.GreedyDecoder(tm, tt, opts)

    def gens(seeks, rung):
        return [ttr.fallback_generator(s, rung, torch.device("cpu"))
                for s in seeks]

    for i, (prompts, seeks) in enumerate(zip(PROMPTS, ((0, 3000),
                                                       (100, 200),
                                                       (7, 7)))):
        xa = torch.from_numpy(_xa(30 + i))
        mine, theirs = gens(seeks, 2), gens(seeks, 2)
        got, st = _steps(lambda: dec.decode_prompted(
            xa, prompts, temperature=0.6, generators=mine))
        assert st["hits"] == int(i > 0)
        _same(got, tdec.GreedyDecoder(tm, tt, opts).decode_prompted(
            xa, prompts, temperature=0.6, generators=theirs))
        for a, b in zip(mine, theirs):
            assert torch.equal(a.get_state(), b.get_state())
    xa = torch.from_numpy(_xa(40, 4))
    g1, g2 = (torch.Generator().manual_seed(11) for _ in range(2))
    got, st = _steps(lambda: dec.decode(xa, [5], temperature=0.6,
                                        generator=g1))
    assert st == dict(calls=2, hits=1, misses=1, captures=0)
    want = [tdec.GreedyDecoder(tm, tt, opts).decode(
        xa[c:c + 2], [5], temperature=0.6, generator=g2) for c in (0, 2)]
    _same(got, tdec.GreedyDecoder._concat_results(want))
    assert torch.equal(g1.get_state(), g2.get_state())


def test_key_changes_make_new_workspaces(pair, monkeypatch):  # noqa: F811
    """Another prompt bucket, another sampling mode or another row count
    is another key (a new workspace); the same shapes with other values
    hit, other temperatures too (read from device memory: each call still
    equals a fresh decoder's).
    With a budget below two workspaces, A, B, A evicts and remakes A, and
    every call still equals a fresh decoder's."""
    _, _, tm = pair
    _, tt = mini_tokenizers()
    dec = tdec.GreedyDecoder(tm, tt, tdec.DecodeOptions(max_new_tokens=6))
    xa = torch.from_numpy(_xa(50))

    def kw(prompts, temperature=0.0, mode=None):
        """decode_prompted's arguments, with fresh generators."""
        return dict(prompts=prompts, temperature=temperature,
                    generators=[ttr.fallback_generator(s, 1, xa.device)
                                for s in (1, 2)] if mode == "rows" else None,
                    generator=torch.Generator().manual_seed(1)
                    if mode == "one" else None)

    calls = [
        (([[5], None],), 1),                                   # P 8
        (([[6, 7], [8]],), 0),                                 # P 8 again
        (([list(range(9)), None],), 1),                        # P 16
        (([[5], None], 0.4, "rows"), 1),
        (([[5], None], 0.8, "rows"), 0),                      # temperature
        (([[5], None], 0.8, "one"), 1),
    ]
    for args, miss in calls:
        want = tdec.GreedyDecoder(tm, tt, tdec.DecodeOptions(
            max_new_tokens=6)).decode_prompted(xa, **kw(*args))
        got, st = _steps(lambda: dec.decode_prompted(xa, **kw(*args)))
        assert st["misses"] == miss, args
        _same(got, want)
    _, st = _steps(lambda: dec.decode_prompted(xa[:1], [[5]]))
    assert st["misses"] == 1
    monkeypatch.setattr(tdec, "WORKSPACE_BUDGET", 1)
    seq = (([[5], None], 1), ([list(range(9)), None], 1), ([[6], [7]], 1),
           ([[8], None], 0))
    want = [tdec.GreedyDecoder(tm, tt, tdec.DecodeOptions(
        max_new_tokens=6)).decode_prompted(xa, p) for p, _ in seq]
    small = tdec.GreedyDecoder(tm, tt, tdec.DecodeOptions(max_new_tokens=6))
    before = tdec.DECODE_STEPS["evictions"]
    for (prompts, miss), ref in zip(seq, want):
        got, st = _steps(lambda: small.decode_prompted(xa, prompts))
        assert st["misses"] == miss
        _same(got, ref)
    assert tdec.DECODE_STEPS["evictions"] - before >= 2
    assert tdec.DECODE_STEPS["workspace_bytes"] == tdec.WORKSPACES.nbytes
    del dec, small
    gc.collect()


def test_decode_calls_hold_workspaces_only_while_their_decoder_lives(
        pair):  # noqa: F811
    _, _, tm = pair
    _, tt = mini_tokenizers()
    n0 = len(tdec.WORKSPACES)
    dec = tbeam.BeamDecoder(tm, tt, tdec.DecodeOptions(max_new_tokens=4),
                            beam_size=2, cache_dtype=torch.float32)
    dec.decode(torch.from_numpy(_xa(60)))
    assert len(tdec.WORKSPACES) == n0 + 1
    ws = tdec.WORKSPACES.get(dec, tdec.WORKSPACES.keys()[-1])
    assert ws.nbytes > 0 and ws.setup_graph is None
    del dec, ws
    gc.collect()
    assert len(tdec.WORKSPACES) == n0
