"""Time a checkout's attn_step kernel over recorded decode traffic.

    python3 notsofar_tpu_torch/tools/time_attn_step.py \\
        --traffic chiprun_out/attn_step_traffic.json [--root DIR]

The traffic file is what chip_smoke.py writes from its ASR and pipeline
phases: for each phase, [rows, cache length, pos, launches] of every
attn_step launch the decode loops made. ``--root`` names the checkout
whose ``notsofar_tpu_torch/ops/kernels.py::attn_step`` is timed (default:
the one holding this file); its kernels are built there. Two designs are
compared by running this script on both checkouts in turns (A, B, B, A)
in one session on one card.

For each (rows, cache length) the pos values are cut into bins of
``--bin`` slots. At each bin's launch-weighted mean pos, 32 launches over
32 layers' own caches (a decode step's form: each layer's caches are cold
when its turn comes) are captured in one CUDA graph and its replays are
timed with CUDA events, the L2 flushed before each. The traffic's time is
the sum over bins of the bin's launches times the ms per launch. Every row has pad 0 (the kernel
reads keys 0..pos), the traffic's cache dtype is bf16, and D, dk are
large-v3's (1280, 64). The bound reads each visible key's K and V row and
q once, writes the f32 output once, at 3.35 TB/s (the H100's HBM rate).
The same traffic is also timed through the plain version
(kernels.attn_step_plain) and one PyTorch call on the same work
(scaled_dot_product_attention with the step's visibility as a boolean
mask; a yardstick the port never calls), each in the same graphs.

Prints one line per (rows, cache length) and, last, a JSON object with
the ms (kernel, plain version, library) and launches by phase. Runs only
on a CUDA card.
"""
import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

D, DK, LAYERS = 1280, 64, 32
HBM_BYTES_PER_S = 3.35e12


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[2]))
    ap.add_argument("--bin", type=int, default=16)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("time_attn_step: needs a CUDA card")
    from notsofar_tpu_torch.ops import kernels as K
    if Path(K.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"time_attn_step: imported {K.__file__}, not "
                           f"the checkout {root}")

    traffic = json.loads(Path(args.traffic).read_text())
    # (rows, ctx) -> bin -> {pos: launches}, and the phases' shares
    groups = defaultdict(lambda: defaultdict(lambda: defaultdict(int)))
    for phase, entries in traffic.items():
        for B, ctx, pos, n in entries:
            groups[(B, ctx)][pos // args.bin][(pos, phase)] += n

    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    ms_by_phase = defaultdict(float)
    launches_by_phase = defaultdict(int)
    bound_total = plain_total = library_total = 0.0
    for (B, ctx), bins in sorted(groups.items()):
        layers = [tuple(torch.randn((B, ctx, D), generator=g, device="cuda")
                        .to(bf) for _ in range(2)) for _ in range(LAYERS)]
        q = (torch.randn((B, 1, D), generator=g, device="cuda")
             * DK ** -0.5).to(bf)
        pads = torch.zeros(B, dtype=torch.int32, device="cuda")
        group_ms = group_n = 0
        for _, cells in sorted(bins.items()):
            n_bin = sum(cells.values())
            pos = round(sum(p * n for (p, _), n in cells.items()) / n_bin)
            per_launch = graph_ms(
                lambda: [K.attn_step(q, k, v, pos, pads, DK)
                         for k, v in layers], args.reps) / LAYERS
            plain = graph_ms(
                lambda: [K.attn_step_plain(q, k, v, pos, pads, DK)
                         for k, v in layers], args.reps) / LAYERS
            mask = (torch.arange(ctx, device="cuda") <= pos)[None, None,
                                                              None]
            H = D // DK
            heads = [tuple(t.view(B, ctx, H, DK).transpose(1, 2)
                           for t in kv) for kv in layers]
            qh = q.view(B, 1, H, DK).transpose(1, 2)
            library = graph_ms(
                lambda: [torch.nn.functional.scaled_dot_product_attention(
                    qh, k, v, attn_mask=mask, scale=1.0) for k, v in heads],
                args.reps) / LAYERS
            plain_total += n_bin * plain
            library_total += n_bin * library
            for (p, phase), n in cells.items():
                ms_by_phase[phase] += n * per_launch
                launches_by_phase[phase] += n
                bound_total += n * ((2 * B * (p + 1) * D + B * D) * 2
                                    + B * 4 + B * D * 4) \
                    / HBM_BYTES_PER_S * 1e3
            group_ms += n_bin * per_launch
            group_n += n_bin
        print(f"rows {B}, cache {ctx}: {group_n} launches, "
              f"{group_ms:.3f} ms, {group_ms / group_n * 1e3:.2f} us a "
              "launch", flush=True)
        del layers
    total = sum(ms_by_phase.values())
    print(json.dumps({
        "root": str(root), "launches": sum(launches_by_phase.values()),
        "ms": total, "bound_ms": bound_total, "plain_ms": plain_total,
        "library_ms": library_total,
        "ms_by_phase": dict(ms_by_phase),
        "launches_by_phase": dict(launches_by_phase)}))
    return 0


def graph_ms(fn, reps: int) -> float:
    """Mean ms of one replay of fn() captured in a CUDA graph (one eager
    call first, on the capture's side stream), each replay timed alone
    after a 256 MB write that evicts the 50 MB L2."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    evs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        evs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in evs) / reps


if __name__ == "__main__":
    sys.exit(main())
