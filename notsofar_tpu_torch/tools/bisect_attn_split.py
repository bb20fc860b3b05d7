"""Bisect attn_step_split's time into building the visibility bias, the
kernel body alone and the whole wrapper, beside one SDPA call on the
same work.

    python -m notsofar_tpu_torch.tools.bisect_attn_split [--iters 50]
        [--batch 8] [--beams 5] [--prompt 256] [--gen 192] [--d 1280]
        [--device cpu]

The counterpart of tools/bisect_attn_split.py at its shapes (B 8 streams,
K 5 beams, Pp 256 prompt and G 192 generated slots, D 1280, dk 64, the
current token at slot G // 2, no pads, no ancestry). Rows, each the mean
ms of one call (on the card a CUDA graph of the row's call, its replays
timed with CUDA events, L2 flushed before each):
- ``pack(bias)``: split_visibility_bias, the JAX tool's pack_only less
  its block-diagonal query pack, which the kernel body now does itself;
- ``kernel_only``: attn_step_split_bias, the body on the blocks the
  wrapper passes, with that bias;
- ``full``: attn_step_split(..., anc=None), bias and kernel;
- ``library``: SDPA with the bias as an additive mask (the yardstick);
- ``bound``: bytes and FLOP of kernel_only over the card's peaks.
The JAX tool's ``diag unpack`` row has no counterpart: the kernel
collapses the heads itself.
"""
import argparse
import sys
from typing import List, Optional

import torch
import torch.nn.functional as F

from notsofar_tpu_torch.ops import kernels as K
from notsofar_tpu_torch.tools.common import (add_device_args, bound_ms,
                                             device_line, time_ms)
from notsofar_tpu_torch.utils.device import resolve_device
from notsofar_tpu_torch.utils.flops import device_peaks

DK = 64


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--beams", type=int, default=5)
    ap.add_argument("--prompt", type=int, default=256)
    ap.add_argument("--gen", type=int, default=192)
    ap.add_argument("--d", type=int, default=1280)
    add_device_args(ap, iters=50)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    B, Kb, Pp, G, D = args.batch, args.beams, args.prompt, args.gen, args.d
    H, BK, ncol = D // DK, B * args.beams, Pp + Kb * G
    print(device_line(dev), flush=True)

    g = torch.Generator().manual_seed(0)

    def randn(*shape):
        return (torch.randn(shape, generator=g) * 0.3).to(torch.bfloat16) \
            .to(dev)

    q = randn(BK, 1, D)
    kp, vp = randn(B, Pp, D), randn(B, Pp, D)
    kg, vg = randn(BK, G, D), randn(BK, G, D)
    gslot = G // 2
    pads = torch.zeros(B, dtype=torch.int32, device=dev)
    q3, kg3, vg3 = (x.view(B, -1, D) for x in (q, kg, vg))
    bias = K.split_visibility_bias(B, Kb, Pp, G, gslot, pads, None)
    # SDPA on the same work: heads as the batch's second axis, the keys
    # pre-concatenated as [prompt | K generated segments] per stream, the
    # bias as an additive mask in the query dtype
    q_lib = q3.view(B, Kb, H, DK).transpose(1, 2)
    k_lib, v_lib = (torch.cat([p_, g_], 1).view(B, ncol, H, DK)
                    .transpose(1, 2) for p_, g_ in ((kp, kg3), (vp, vg3)))
    mask = bias.to(q.dtype)[:, None]

    rows = {
        "pack(bias)": lambda: K.split_visibility_bias(B, Kb, Pp, G, gslot,
                                                      pads, None),
        "kernel_only": lambda: K.attn_step_split_bias(q3, kp, vp, kg3, vg3,
                                                      bias, DK),
        "full": lambda: K.attn_step_split(q, kp, vp, kg, vg, gslot, pads,
                                          DK, Kb),
        "library": lambda: F.scaled_dot_product_attention(
            q_lib, k_lib, v_lib, attn_mask=mask, scale=1.0),
    }
    for name, fn in rows.items():
        print(f"{name}: {time_ms(fn, args.iters, dev):.4f} ms/call",
              flush=True)
    print("diag unpack: none (the kernel collapses the heads itself)",
          flush=True)
    nbytes = (2 * B * ncol * D + BK * D) * 2 + B * Kb * ncol * 4 + BK * D * 4
    if dev.type == "cuda":
        peaks = device_peaks()
        b_ms, by = bound_ms(nbytes, 4 * BK * ncol * D, peaks["bf16"],
                            peaks["hbm_gbps"])
        print(f"bound: {b_ms:.4f} ms/call (kernel_only, {nbytes / 1e6:.2f} "
              f"MB, by {by})", flush=True)
    else:
        print(f"bound: none on the cpu (kernel_only, {nbytes / 1e6:.2f} MB)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
