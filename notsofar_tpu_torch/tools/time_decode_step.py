"""Time a checkout's decode step and its dense-layer GEMVs on the card,
or (``--loops``) its whole decode loops.

    python3 notsofar_tpu_torch/tools/time_decode_step.py [--root DIR]
        [--out FILE]
    python3 notsofar_tpu_torch/tools/time_decode_step.py --loops
        [--root DIR] [--dtype bfloat16|int8] [--calls 3] [--eot-scale 0]
        [--max-new 224] [--out FILE]

``--root`` names the checkout whose ``notsofar_tpu_torch`` is imported
and timed (default: the one holding this file); its kernels are built
there. Two designs are compared by running this script on both checkouts
in turns (A, B, B, A) in one session on one card. Only entry points that
every checkout since the decode step was graphed has are used:
``load_whisper_model``, ``TextDecoder.forward`` with a device position,
``ops.kernels.decode_gemv(x, w, dtype, scale, bias, logits=...)`` and
``ops.kernels.xattn_step``.

Whisper large-v3 with seeded random weights, bf16 and the int8 decoder,
against a seeded random encoder output of 3 windows (the encoder is not
run). For each (dtype, rows) -- 3 rows (greedy: a 256-slot unified cache
after a 4-token prompt) and 15 rows (beam 5: the prompt in a split
cache's shared segment, a 64-slot generated segment, the beams folded
into the cross-attention's queries) -- one single-token decoder call is:

- profiled eagerly under torch.profiler: its kernels and their device ms;
- captured in a CUDA graph and replayed: ms per step by CUDA events over
  ``--reps`` replays; and a window of ``--window`` replays profiled, the
  device's busy share being the union of the kernels' intervals over the
  window's span (first kernel start to last kernel end). If the profiler
  shows no kernels inside the replays, that is printed and the share is
  not given.

Then decode_gemv's dense mode (QuantDense int8, scale and bf16 bias;
1280 -> 1280, 1280 -> 5120, 5120 -> 1280) and the int8 and bf16 logits
at 3, 15 and 48 rows, and xattn_step at 3 windows x Tq 1 and 5 (S 1500,
bf16): ms by CUDA events (L2 flushed) and as 32 launches in one CUDA
graph, ms per launch. Prints one line per measurement and, last, a JSON
object of them all (also written to ``--out``). Runs only on a CUDA card.

``--loops`` times whole decode calls instead, through entry points that
every checkout since the decode step was graphed has
(``GreedyDecoder._decode_loop``, ``BeamDecoder._beam_loop``, the
counters ``asr.decoding.DECODE_STEPS``): Whisper large-v3 with seeded
random weights in ``--dtype`` (bf16, or the int8 decoder with int8
cross-attention K/V), 3 seeded mel windows through the encoder, then
greedy (3 rows) and beam 5 (15 rows) decode calls of up to ``--max-new``
new tokens (default 224, the shipped max), each call timed by the host
clock from its start to a synchronize after it (the set-up, step 0, the
graph captures and every step): the first call of the loop's key
reported apart, then ``--calls`` more, each with its host seconds before
its first replayed step (set-up, step 0, capture) and whether its key
had a decode workspace (None on a checkout without them).
``--eot-scale`` > 0 scales the model's EOT embedding row, so that rows
end at different steps before max_new (random weights alone rarely end
a decode). Prints, per loop, the first call, then ms per call, the steps
a call runs and ms per step of the later calls, and each call; last,
the JSON object.
"""
import argparse
import json
import time
import sys
from collections import defaultdict
from pathlib import Path

D, DK, S, WINDOWS = 1280, 64, 1500, 3


def _setup(model, beams: int, seed: int = 3):
    """(tokens [rows, 1], xa, pos, caches, cross) of one single-token
    decoder call at `beams` rows a window, after the prompt's prefill."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    xa = torch.randn(WINDOWS, S, D, generator=g, device="cuda").to(
        model.dtype)
    with torch.no_grad():
        cross = model.precompute_cross_kv(xa)
        if model.quant_decoder:
            cross = model.quantize_cross_kv(cross)
        toks = torch.full((WINDOWS * beams, 4), 50258, dtype=torch.long,
                          device="cuda")
        if beams == 1:
            caches = model.empty_kv_caches(WINDOWS, cache_len=256)
            model.decoder(toks, xa, 0, caches, cross_kvs=cross)
        else:
            prompt = model.empty_kv_caches(WINDOWS, cache_len=4)
            model.decoder(toks[:WINDOWS], xa, 0, prompt, cross_kvs=cross)
            gen = model.empty_kv_caches(WINDOWS * beams, cache_len=64)
            anc = torch.zeros((WINDOWS, beams, 64), dtype=torch.int32,
                              device="cuda")
            caches = [(kp, vp, kg, vg, anc) for (kp, vp), (kg, vg)
                      in zip(prompt, gen)]
    pos = torch.tensor(4, device="cuda")
    return toks[:, :1], xa, pos, caches, cross


def _cuda_kernels(prof):
    """The profiler's device kernels: (name, start us, end us)."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def busy_share(kernels) -> float:
    """The union of the kernels' intervals over the span from the first
    start to the last end."""
    iv = sorted((s, e) for _, s, e in kernels)
    busy, cur_s, cur_e = 0.0, iv[0][0], iv[0][1]
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy / (iv[-1][1] - iv[0][0])


def step_profile(model, beams: int, reps: int = 50, window: int = 10,
                 top: int = 8) -> dict:
    """One decoder call at `beams` rows a window: its kernels and device ms
    eagerly, its ms per replay as a CUDA graph, and the device's busy
    share over `window` replays (None where the profiler sees no kernel in
    them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    tok, xa, pos, caches, cross = _setup(model, beams)

    def step():
        model.decoder(tok, xa, pos, caches, cross_kvs=cross)

    with torch.no_grad():
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        ks = _cuda_kernels(prof)
        by_name, count = defaultdict(float), defaultdict(int)
        for name, s, e in ks:
            by_name[name] += e - s
            count[name] += 1
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        graph.replay()
        torch.cuda.synchronize()
        s_ev = torch.cuda.Event(enable_timing=True)
        e_ev = torch.cuda.Event(enable_timing=True)
        s_ev.record()
        for _ in range(reps):
            graph.replay()
        e_ev.record()
        torch.cuda.synchronize()
        graph_ms = s_ev.elapsed_time(e_ev) / reps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(window):
                graph.replay()
            torch.cuda.synchronize()
        gk = _cuda_kernels(prof)
    return dict(
        rows=tok.shape[0], kernels=len(ks),
        device_ms=sum(e - s for _, s, e in ks) / 1e3, graph_ms=graph_ms,
        graph_kernels_seen=len(gk),
        busy_share=busy_share(gk) if gk else None,
        top=[(k[:60], count[k], round(v / 1e3, 4)) for k, v in
             sorted(by_name.items(), key=lambda kv: -kv[1])[:top]])


def gemv_times(iters: int) -> dict:
    """decode_gemv's dense and logits modes at the decode step's shapes, by
    events and as 32 launches in one graph (ms per launch), beside
    torch.matmul on the widened weight (the same two ways)."""
    import torch
    from notsofar_tpu_torch.ops import kernels as K
    from notsofar_tpu_torch.tools.common import time_cuda, time_cuda_graph
    g = torch.Generator(device="cuda").manual_seed(99)
    bf = torch.bfloat16
    out = {}
    for M in (3, 15, 48):
        cases = []
        for N, Kd in ((1280, 1280), (5120, 1280), (1280, 5120)):
            w = torch.randint(-127, 128, (N, Kd), generator=g,
                              device="cuda", dtype=torch.int8)
            s_ = (torch.rand(N, generator=g, device="cuda") + 0.1) * 1e-3
            b_ = (torch.randn(N, generator=g, device="cuda") * 0.1).to(bf)
            x = torch.randn(M, 1, Kd, generator=g, device="cuda").to(bf)
            cases.append((f"dense {Kd}->{N}", x, w, s_, b_, False))
        emb8 = torch.randint(-127, 128, (51866, D), generator=g,
                             device="cuda", dtype=torch.int8)
        es = (torch.rand(51866, generator=g, device="cuda") + 0.5) * 1e-3
        cases.append(("int8 logits", torch.randn(M, 1, D, generator=g,
                                                 device="cuda"),
                      emb8, es, None, True))
        for name, x, w, s_, b_, lg in cases:
            x16, w16 = x.to(bf), w.to(bf)

            def kern():
                return K.decode_gemv(x, w, bf, s_, b_, logits=lg)

            def lib():
                return torch.matmul(x16, w16.T)

            out[f"{name} {M}"] = dict(
                ms=time_cuda(kern, iters),
                graph_ms=time_cuda_graph(
                    lambda: [kern() for _ in range(32)], iters) / 32,
                library_ms=time_cuda(lib, iters),
                library_graph_ms=time_cuda_graph(
                    lambda: [lib() for _ in range(32)], iters) / 32)
    return out


def xattn_step_times(iters: int) -> dict:
    import torch
    from notsofar_tpu_torch.ops import kernels as K
    from notsofar_tpu_torch.tools.common import time_cuda, time_cuda_graph
    g = torch.Generator(device="cuda").manual_seed(7)
    bf = torch.bfloat16
    k = torch.randn(WINDOWS, S, D, generator=g, device="cuda").to(bf)
    v = torch.randn(WINDOWS, S, D, generator=g, device="cuda").to(bf)
    out = {}
    for T in (1, 5):
        q = torch.randn(WINDOWS, T, D, generator=g, device="cuda").to(bf)
        out[f"xattn_step Tq {T}"] = dict(
            ms=time_cuda(lambda: K.xattn_step(q, k, v, DK), iters),
            graph_ms=time_cuda_graph(
                lambda: [K.xattn_step(q, k, v, DK) for _ in range(32)],
                iters) / 32)
    return out


def time_loops(dtype: str, calls: int, eot_scale: float,
               max_new: int = 224) -> dict:
    """ms per call, steps per call and DECODE_STEPS per call of the
    greedy and beam-5 loops (``--loops``; see the module's docstring):
    the first call of the loop's key apart, then ``calls`` more, each with
    its own host seconds (set-up, step 0, capture) and whether its key had
    a workspace (a checkout without the workspace cache: None)."""
    import numpy as np
    import torch
    from notsofar_tpu_torch.asr import decoding as dec
    from notsofar_tpu_torch.asr.beam import BeamDecoder
    from notsofar_tpu_torch.asr.inference import load_whisper_model

    model, tok, _ = load_whisper_model("large-v3", None,
                                       compute_dtype=dtype, device="cuda")
    if eot_scale > 0 and model.quant_decoder:
        raise ValueError("--eot-scale scales a float embedding row; the "
                         "int8 decoder's embedding is quantized")
    mel = torch.from_numpy(np.random.RandomState(8).randn(3, 128, 3000)
                           .astype(np.float32)).cuda()
    emb = model.decoder.token_embedding.weight
    row = emb[tok.eot].clone()
    out = {}
    try:
        if eot_scale > 0:
            with torch.no_grad():
                emb[tok.eot] *= eot_scale
        with torch.no_grad():
            xa = model.encode(mel)
        opts = dec.DecodeOptions(max_new_tokens=max_new,
                                 cross_kv_quant=model.quant_decoder)
        for kind in ("greedy", "beam5"):
            d = BeamDecoder(model, tok, opts, beam_size=5) \
                if kind == "beam5" else dec.GreedyDecoder(model, tok, opts)
            loop = d._beam_loop if kind == "beam5" else d._decode_loop
            initial = d._initial_tokens(None)
            prompt = torch.tensor(initial, device="cuda").repeat(3, 1)
            per_call = []
            for _ in range(calls + 1):
                torch.cuda.synchronize()
                dec.reset_decode_steps()
                t0 = time.perf_counter()
                loop(xa, len(initial), prompt)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                st = dict(dec.DECODE_STEPS)
                steps = st["eager"] + st["replayed"]
                per_call.append(dict(
                    ms=wall * 1e3, steps=steps,
                    hit=bool(st["hits"]) if "hits" in st else None,
                    captures=st["captures"],
                    host_s_before_replay=st["prefill_s"] + st["step0_s"]
                    + st["capture_s"],
                    **{k: st[k] for k in ("prefill_s", "step0_s",
                                          "capture_s")}))
            later = per_call[1:]
            ms = float(np.mean([c["ms"] for c in later]))
            steps = float(np.mean([c["steps"] for c in later]))
            out[kind] = dict(first=per_call[0], ms_per_call=ms,
                             steps=steps, ms_per_step=ms / steps,
                             calls=later)
            del d, loop
    finally:
        with torch.no_grad():
            emb[tok.eot].copy_(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[2]))
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--window", type=int, default=10)
    ap.add_argument("--loops", action="store_true")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "int8"))
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--eot-scale", type=float, default=0.0)
    ap.add_argument("--max-new", type=int, default=224,
                    help="--loops: max_new_tokens of each decode call")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("time_decode_step: needs a CUDA card")
    from notsofar_tpu_torch.asr.inference import load_whisper_model
    from notsofar_tpu_torch.ops import kernels as K
    from notsofar_tpu_torch.tools.common import card_line
    if Path(K.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"time_decode_step: imported {K.__file__}, not "
                           f"the checkout {root}")
    if args.loops:
        res = dict(root=str(root), card=card_line(), dtype=args.dtype,
                   eot_scale=args.eot_scale, max_new=args.max_new,
                   loops=time_loops(args.dtype, args.calls, args.eot_scale,
                                    args.max_new))
        print(f"device: {res['card']}; checkout {root}", flush=True)
        for kind, r in res["loops"].items():
            def call(c):
                return (f"{c['ms']:.2f} ms, {c['steps']} steps, hit "
                        f"{c['hit']}, {c['captures']} captures, host s "
                        f"before the first replayed step "
                        f"{c['host_s_before_replay']:.4f} (set-up "
                        f"{c['prefill_s']:.4f}, step 0 {c['step0_s']:.4f}, "
                        f"capture {c['capture_s']:.4f})")
            print(f"{kind} {args.dtype} max_new {args.max_new}: first call "
                  f"of the key {call(r['first'])}; later calls "
                  f"{r['ms_per_call']:.2f} ms per call, {r['steps']:.1f} "
                  f"steps, {r['ms_per_step']:.4f} ms per step; each: "
                  + "; ".join(call(c) for c in r["calls"]), flush=True)
        return _emit(res, args.out)
    res = dict(root=str(root), card=card_line(), steps={})
    print(f"device: {res['card']}; checkout {root}", flush=True)
    for dtype in ("bfloat16", "int8"):
        model, _, _ = load_whisper_model("large-v3", None,
                                         compute_dtype=dtype, device="cuda")
        for beams in (1, 5):
            r = step_profile(model, beams, args.reps, args.window)
            res["steps"][f"{dtype} {r['rows']} rows"] = r
            print(f"step {dtype} {r['rows']} rows: {r['kernels']} kernels, "
                  f"{r['device_ms']:.4f} device ms eager; graphed "
                  f"{r['graph_ms']:.4f} ms a step, busy share "
                  f"{r['busy_share']} over {args.window} replays "
                  f"({r['graph_kernels_seen']} kernels seen); top "
                  f"{r['top']}", flush=True)
        del model
        import notsofar_tpu_torch.asr.inference as inf
        inf._MODEL_CACHE.clear()
        torch.cuda.empty_cache()
    res["gemv"] = gemv_times(args.iters)
    res["xattn_step"] = xattn_step_times(args.iters)
    for k, v in {**res["gemv"], **res["xattn_step"]}.items():
        print(f"{k}: " + ", ".join(f"{a} {b:.4f}" for a, b in v.items()),
              flush=True)
    return _emit(res, args.out)


def _emit(res: dict, out) -> int:
    """Print `res` as the last line, and write it to `out` if given."""
    line = json.dumps(res)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
