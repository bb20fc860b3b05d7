"""The decode loops as CUDA graphs (asr/decoding.py, asr/beam.py,
utils/cuda_graph.py): on the CPU every step runs eagerly; on the card a
key's first decode call captures its set-up, step 0 and step as graphs
(step 0 runs eagerly first) and replays the step graph; every later call
of the key replays all three and captures nothing. Tokens, scores and
counters must equal the eager loop's.

A small Whisper at kernel dims (dk 64, width 128, 2 decoder layers) with
seeded random weights, f32. The `gpu`-marked tests skip without a card.
This file imports nothing from tests/ (the card machine has an installed
package named `tests`).
"""
import numpy as np
import pytest
import torch

from notsofar_tpu_torch.asr import beam as tbeam
from notsofar_tpu_torch.asr import decoding as tdec
from notsofar_tpu_torch.asr import transcribe as ttr
from notsofar_tpu_torch.asr.tokenizer import WhisperTokenizer
from notsofar_tpu_torch.models import whisper as tw
from notsofar_tpu_torch.ops import kernels as tk

DIMS = tw.WhisperDims(80, 1500, 128, 2, 1, 1864, 448, 128, 2, 2)


def tokenizer():
    return WhisperTokenizer(None, 256, multilingual=True, num_languages=99)


def model(device, quant: bool = False):
    """The seeded small model (its int8 decoder quantized from the same
    float weights), its EOT embedding row scaled by 6 so that rows end at
    different steps within max_new_tokens."""
    m = tw.WhisperModel(DIMS, device="cpu").init(
        torch.Generator().manual_seed(3))
    with torch.no_grad():
        m.decoder.token_embedding.weight[tokenizer().eot] *= 6.0
    sd = m.state_dict()
    if quant:
        sd = tw.quantize_whisper_decoder(sd)
    out = tw.WhisperModel(DIMS, device=device, quant_decoder=quant)
    out.load_state_dict(sd)
    return out


def decoder(m, kind: str):
    tt = tokenizer()
    opts = tdec.DecodeOptions(max_new_tokens=40,
                              cross_kv_quant=m.quant_decoder)
    if kind.endswith("beam3"):
        return tbeam.BeamDecoder(m, tt, opts, beam_size=3,
                                 cache_dtype=torch.float32)
    return tdec.GreedyDecoder(m, tt, opts)


def decode(m, kind: str, graph, dec=None, seed: int = 9, rows: int = 3):
    """One decode loop of `rows` rows (of 3) with per-row prompts, by
    `dec` (default: a new decoder); returns (tokens, stats, the kernel
    launches and int8 decoder calls it made, its DECODE_STEPS)."""
    dev = m.device
    xa = torch.from_numpy(np.random.RandomState(seed).randn(3, 96, 128)
                          .astype(np.float32) * 0.2)[:rows].to(dev)
    prompts = [[5, 6], None, [40, 41, 42]][:rows]
    dec = dec or decoder(m, kind)
    toks, pads, P = dec._pack_prompts(prompts)
    args = (xa, P, torch.from_numpy(toks).to(dev))
    pads = torch.from_numpy(pads).to(dev)
    launches = dict(tk.LAUNCHES)
    tdec.reset_decoder_calls()
    tdec.reset_decode_steps()
    if kind.endswith("beam3"):
        out = dec._beam_loop(*args, pad_lens=pads, graph=graph)
    else:
        gens = [ttr.fallback_generator(s, 2, dev)
                for s in (0, 3000, 6000)[:rows]] \
            if kind == "sampled" else None
        out = dec._decode_loop(*args, None, 0.6 if gens else 0.0, pads,
                               gens, graph=graph)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launched = {k: v - launches[k] for k, v in tk.LAUNCHES.items()}
    return (*out, launched, dict(tdec.DECODER_CALLS),
            dict(tdec.DECODE_STEPS))


def test_cpu_decode_runs_every_step_eagerly():
    """No graph on the CPU: every step is an eager step, no capture."""
    _, _, _, _, steps = decode(model("cpu"), "greedy", None)
    assert steps["eager"] > 1 and steps["replayed"] == 0
    assert steps["captures"] == 0


def strict_run_steps(self, step, max_new, finished, graph, generators=()):
    """The strict schedule, the reference for the loops' queued one: every
    step eager, finished.all() read on the host before each step after
    the first, so the loop stops right after the first step at which
    every row has finished."""
    step(True)
    tdec.DECODE_STEPS["eager"] += 1
    for _ in range(1, max_new):
        if bool(finished.all()):
            break
        step(False)
        tdec.DECODE_STEPS["eager"] += 1


def watch_finished(monkeypatch):
    """Wrap the loops' _run_steps so that finished.all() is noted after
    every step (eager loops only); returns the list it fills."""
    seen = []
    run = tdec.GreedyDecoder._run_steps

    def watched(self, step, max_new, finished, graph, generators=()):
        def traced(first):
            step(first)
            seen.append(bool(finished.all()))
        return run(self, traced, max_new, finished, graph, generators)

    monkeypatch.setattr(tdec.GreedyDecoder, "_run_steps", watched)
    return seen


@pytest.mark.parametrize("kind", ["greedy", "sampled", "beam3"])
def test_queued_schedule_equals_the_strict_one(kind, monkeypatch):
    """The loops' schedule (the read of finished.all() after step i waited
    on only after step i + 1 is enqueued) against the strict one
    (strict_run_steps): the same tokens and stats bit for bit, the same
    launches per step, and exactly one step more than the strict loop,
    the one after the first step at which every row has finished. For
    greedy rows that step is the last row's first EOT."""
    m = model("cpu")
    with monkeypatch.context() as mp:
        mp.setattr(tdec.GreedyDecoder, "_run_steps", strict_run_steps)
        tok_s, st_s, _, calls_s, steps_s = decode(m, kind, None)
    with monkeypatch.context() as mp:
        seen = watch_finished(mp)
        tok_q, st_q, _, calls_q, steps_q = decode(m, kind, None)
    n_s, n_q = steps_s["eager"], steps_q["eager"]
    assert 1 < n_s < 40 and n_q == n_s + 1 == len(seen)
    assert seen.index(True) + 1 == n_s
    assert torch.equal(tok_s, tok_q) and torch.equal(st_s, st_q)
    # the prefill and one decoder call a step, both schedules
    assert calls_s["xattn_step"] == n_s + 1
    assert calls_q["xattn_step"] == n_q + 1
    assert steps_q["read_s"] > 0 and steps_q["step0_s"] > 0
    if kind != "beam3":
        first_eot = [int((row == tokenizer().eot).nonzero()[0])
                     for row in tok_s]
        assert n_s == max(first_eot) + 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA-only)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind,quant", [
    ("greedy", False), ("sampled", False), ("beam3", False),
    ("greedy", True), ("beam3", True)])
def test_gpu_graphed_decode_equals_the_eager_loop(cuda, kind, quant):
    """The loop's default on the card at a key's first call (set-up and
    step 0 eager, the set-up, step-0 and step graphs captured, the step
    graph replayed) against the same loop run eagerly: equal tokens,
    scores within 1e-5 (f32; the same kernels on the same inputs), the
    same kernel launches and int8 decoder calls, three captures, and every
    step after the first replayed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    m = model(cuda, quant)
    tok_e, st_e, launch_e, calls_e, steps_e = decode(m, kind, False)
    tok_g, st_g, launch_g, calls_g, steps_g = decode(m, kind, None)
    assert steps_e["replayed"] == 0 and steps_e["captures"] == 0
    assert steps_g["captures"] == 3 and steps_g["eager"] == 1
    assert steps_g["replayed"] == steps_e["eager"] - 1 > 0
    assert torch.equal(tok_e, tok_g)
    assert (st_e - st_g).abs().max().item() <= 1e-5
    assert launch_e == launch_g and calls_e == calls_g
    kern = "attn_step_split" if kind == "beam3" else "attn_step"
    assert launch_g[kern] == DIMS.n_text_layer * steps_e["eager"]
    if quant:
        assert launch_g["xattn_int8"] == \
            DIMS.n_text_layer * calls_g["xattn_int8"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("kind,quant", [
    ("greedy", False), ("sampled", False), ("beam3", False),
    ("greedy", True)])
def test_gpu_queued_graph_equals_the_strict_eager_loop(cuda, kind, quant,
                                                      monkeypatch):
    """The graphed loop with its queued schedule against the eager loop
    with the strict one (strict_run_steps): equal tokens, scores within
    1e-5, one step more when the rows finish before max_new_tokens (every
    step after the first replayed), and that step's kernel launches more:
    the step run past the end changes nothing. The sampled rows draw from
    the card's generators and may run to max_new_tokens; the others end
    early."""
    torch.backends.cuda.matmul.allow_tf32 = False
    m = model(cuda, quant)
    with monkeypatch.context() as mp:
        mp.setattr(tdec.GreedyDecoder, "_run_steps", strict_run_steps)
        tok_e, st_e, launch_e, _, steps_e = decode(m, kind, False)
    tok_g, st_g, launch_g, _, steps_g = decode(m, kind, None)
    n = steps_e["eager"]
    n_q = min(n + 1, 40)
    assert 1 < n <= 40 and (n < 40 or kind == "sampled")
    assert steps_g["captures"] == 3 and steps_g["eager"] == 1
    assert steps_g["replayed"] == n_q - 1
    assert torch.equal(tok_e, tok_g)
    assert (st_e - st_g).abs().max().item() <= 1e-5
    kern = "attn_step_split" if kind == "beam3" else "attn_step"
    assert launch_e[kern] == DIMS.n_text_layer * n
    assert launch_g[kern] == DIMS.n_text_layer * n_q


def check_equal(eager, graphed, replayed_all: bool = True):
    """A graphed call against the eager loop on the same inputs: equal
    tokens, scores within 1e-5, equal launches and int8 decoder calls;
    with replayed_all, a reused key's call (no capture, no eager step,
    every step replayed)."""
    tok_e, st_e, launch_e, calls_e, steps_e = eager
    tok_g, st_g, launch_g, calls_g, steps_g = graphed
    assert torch.equal(tok_e, tok_g)
    assert (st_e - st_g).abs().max().item() <= 1e-5
    assert launch_e == launch_g and calls_e == calls_g
    if replayed_all:
        assert steps_g["captures"] == 0 and steps_g["eager"] == 0
        assert steps_g["replayed"] == steps_e["eager"] > 1
        assert steps_g["hits"] == 1 and steps_g["misses"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("kind,quant", [
    ("greedy", False), ("sampled", False), ("beam3", False),
    ("greedy", True), ("beam3", True)])
def test_gpu_reused_key_equals_the_eager_loop(cuda, kind, quant):
    """Keys A (3 rows) and B (2 rows) on one decoder, graphed, in the order
    A, B, A, A, each call on other inputs (seeded xa; sampled rows from
    fresh generators): the calls after A's and B's first capture nothing
    and replay every step, and each equals the eager loop on its own
    inputs. Tensors one graph leaves for the next live in the workspace,
    outside the graphs' pools, so interleaving keys changes nothing."""
    torch.backends.cuda.matmul.allow_tf32 = False
    m = model(cuda, quant)
    dec = decoder(m, kind)
    for i, (seed, rows) in enumerate(((9, 3), (10, 2), (11, 3), (12, 3))):
        eager = decode(m, kind, False, seed=seed, rows=rows)
        graphed = decode(m, kind, None, dec, seed=seed, rows=rows)
        check_equal(eager, graphed, replayed_all=i >= 2)
        if i < 2:
            assert graphed[4]["captures"] == 3 and \
                graphed[4]["misses"] == 1


@pytest.mark.gpu
def test_gpu_evicted_key_is_captured_again(cuda, monkeypatch):
    """With a budget below one workspace, A, B, A evicts A at B's call and
    captures A again at its second call (a miss, three captures); every
    call equals the eager loop."""
    torch.backends.cuda.matmul.allow_tf32 = False
    m = model(cuda)
    monkeypatch.setattr(tdec, "WORKSPACE_BUDGET", 1)
    calls = ((9, 3), (10, 2), (11, 3))
    eager = [decode(m, "greedy", False, seed=seed, rows=rows)
             for seed, rows in calls]
    dec = decoder(m, "greedy")
    for i, (seed, rows) in enumerate(calls):
        graphed = decode(m, "greedy", None, dec, seed=seed, rows=rows)
        check_equal(eager[i], graphed, replayed_all=False)
        assert graphed[4]["misses"] == 1 and graphed[4]["captures"] == 3
        # the other key's workspace went
        assert graphed[4]["evictions"] >= int(i > 0)


@pytest.mark.gpu
def test_gpu_temperature_from_device_memory_divides_as_a_host_scalar(cuda):
    """A sampled step reads its temperature from device memory
    (set_temperature, by_temperature) so that one graph serves every rung
    of the ladder: bit for bit the eager loop's ``logits / temperature``
    with a host scalar."""
    lg = torch.randn(15, 51866, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(0)) * 8
    buf = torch.empty((), device=cuda)
    for t in (0.2, 0.4, 0.6, 0.8, 1.0):
        tdec.set_temperature(buf, t)
        assert torch.equal(tdec.by_temperature(lg, buf), lg / t)
