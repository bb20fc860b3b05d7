"""Decompose the int8 cross-attention kernel's gap to its bound: time
(a) ``stream``, a kernel that reads every K/V byte and computes almost
nothing (xattn_stream), (b) ``current``, the serving kernel (xattn_int8),
and (c) ``onedot``, the variant whose value pass rounds each product to
bf16 (xattn_onedot).

    python -m notsofar_tpu_torch.tools.bench_xattn_variants [--batch 24]
        [--s 1504] [--d 1280] [--layers 32] [--iters 5] [--device cpu]

The counterpart of tools/bench_xattn_variants.py, with its arguments,
defaults and seeded numpy inputs (q [B, 1, D] bf16; per layer int8 K and
V [B, S, D] and f32 v-scales [B, D]). Each variant runs as a chain over
the layers, x = bf16(x + o * 1e-6) from layer to layer. It prints the
``onedot vs current: rel maxdiff`` line, then for each chain the mean ms
of one chain call (on the card the chain is captured once in a CUDA graph
and its replays are timed with CUDA events, L2 flushed before each, so
the host's launch time stays out as in the JAX tool's jitted chain, of
which it prints the best of 5 host-clock calls), the int8 K/V GB/s and ms
per layer, and the bytes bound of one layer on the card.
"""
import argparse
import sys
from typing import List, Optional

import numpy as np
import torch

from notsofar_tpu_torch.ops import kernels as K
from notsofar_tpu_torch.tools.common import (add_device_args, bound_ms,
                                             device_line, time_ms)
from notsofar_tpu_torch.utils.device import resolve_device
from notsofar_tpu_torch.utils.flops import device_peaks

DK = 64


def make_inputs(B: int, S: int, D: int, L: int, dev: torch.device):
    """The JAX tool's inputs, drawn in its order from RandomState(0)."""
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(B, 1, D).astype(np.float32) * 0.1) \
        .to(torch.bfloat16).to(dev)
    kvs = [tuple(torch.from_numpy(a).to(dev) for a in (
        rng.randint(-127, 128, (B, S, D)).astype(np.int8),
        rng.randint(-127, 128, (B, S, D)).astype(np.int8),
        rng.rand(B, D).astype(np.float32) * 0.01)) for _ in range(L)]
    return q, kvs


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--s", type=int, default=1504)
    ap.add_argument("--d", type=int, default=1280)
    ap.add_argument("--layers", type=int, default=32)
    add_device_args(ap, iters=5)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    B, S, D, L = args.batch, args.s, args.d, args.layers
    print(device_line(dev), flush=True)
    q, kvs = make_inputs(B, S, D, L, dev)

    variants = {
        "stream": lambda x, k8, v8, vs: K.xattn_stream(k8, v8)[0],
        "current": lambda x, k8, v8, vs: K.xattn_int8(x, k8, v8, vs, DK, S),
        "onedot": lambda x, k8, v8, vs: K.xattn_onedot(x, k8, v8, vs, DK, S),
    }

    def chain(step):
        def run():
            x = q
            for k8, v8, vs in kvs:
                o = step(x, k8, v8, vs)
                x = (x + o * 1e-6).to(torch.bfloat16)
            return x.float().sum()
        return run

    # numeric check: onedot vs current on one layer
    k8, v8, vs = kvs[0]
    a = K.xattn_int8(q, k8, v8, vs, DK, S)
    b = K.xattn_onedot(q, k8, v8, vs, DK, S)
    rel = ((a - b).abs().max() / a.abs().max().clamp_min(1e-9)).item()
    print(f"onedot vs current: rel maxdiff {rel:.2e}", flush=True)

    gb = B * S * D * 2 * L / 1e9
    for name, step in variants.items():
        ms = time_ms(chain(step), args.iters, dev)
        print(f"{name:10s}: {ms:7.2f} ms  ({gb / ms * 1e3:6.0f} GB/s, "
              f"{ms / L:6.3f} ms/layer)", flush=True)
    nbytes = 2 * B * S * D
    if dev.type == "cuda":
        peaks = device_peaks()
        b_ms, by = bound_ms(nbytes, 4 * B * S * D, peaks["f32"],
                            peaks["hbm_gbps"])
        print(f"{'bound':10s}: {b_ms * L:7.2f} ms  ({nbytes / 1e6:.1f} MB "
              f"of int8 K/V per layer, by {by}, {b_ms:6.4f} ms/layer)",
              flush=True)
    else:
        print(f"{'bound':10s}: none on the cpu ({nbytes / 1e6:.1f} MB of "
              "int8 K/V per layer)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
