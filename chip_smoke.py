#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (notsofar_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. card      print nvidia-smi's name and power limit.
2. kernels   build csrc/*.cu with nvcc (one process per source, all in
             parallel); at the main path's shapes (large-v3 attention,
             TitaNet-large depthwise convs at k = 7, 11, 15, MVDR's
             masked covariance) hold each
             kernel against its plain PyTorch version, show that the
             tolerance would catch a change of one key, tap, mask or
             STFT entry, and time
             kernel, plain version and one PyTorch library call (CUDA
             events, L2 flushed before every call).
3. reference a small Whisper on the card against the same weights on the
             CPU (plain paths): encoder output (bf16 and f32), greedy
             and beam-3 decode tokens (f32, TF32 off); a small TitaNet
             likewise (embeddings in f32 and bf16); the device
             clustering chain on a CUDA affinity against the float64
             host path (p_hat, speaker count, partition).
4. asr beam  a seeded synthetic session of 3 streams x 40 s through
             asr_inference with the shipped config: Whisper large-v3 at
             full width, bf16, beam 5, word timestamps,
             condition_on_previous_text, seeded random weights.
             Launch counts are reset before the call and read after it:
             encoder_mha and attn_step_split must be > 0.
5. asr greedy the same session with beam_size=None (greedy + fallback
             ladder); counted the same way: encoder_mha and attn_step
             must be > 0.
6. diarization the shipped word_nmesc config (6 scales, dedup,
             TitaNet-large at full width in bf16, seeded random weights)
             on the ASR dataframes of phases 4 and 5 as two sessions,
             each with a seeded word track added (random-weight Whisper
             emits almost no words; see add_word_track):
             diarization_batch_prepass, each session read back from the
             cache, then one serial diarization_inference of the beam-5
             session, whose speaker count must equal the prepass's.
             Each session needs >= 64 words (the device clustering
             chain); depthwise_conv1d must launch 9 times per planned
             TitaNet chunk.
7. css       CSS separation (css_batch_prepass of two seeded 7-channel
             360 s sessions in one pass, then one serial css_inference
             of the first) with Conformer-large at full width, bf16,
             seeded random weights, MVDR through the masked_scm kernel
             (use_pallas_scm=True) and the shipped activity_th 0.3. Every
             stream finite and on disk, the serial streams equal to the
             prepass's, masked_scm launched once per planned chunk.

Phase 2 also holds masked_scm at the MVDR shape (32 windows, 257 bins,
186 frames, 4 masks, 7 mics), and phase 3 a small MC Conformer CSS on the
card against the CPU (masks in f32 and bf16, one short engine pass with
the kernel against the CPU's plain path).

The line before the last is {"kernels": [...]}, with each kernel's
launches summed over phases 4-7 and split by phase in
"launches_by_path"; the last line is {"ok": true, "device": {...}}. The
run writes under chiprun_out/: the kernels' ptxas report
(kernel_build.log) and, while it runs, the sessions' wavs, ASR and
diarization pickles and separated streams (deleted at the end).
"""
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

# H100 SXM published peaks (NVIDIA data sheet, dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12           # f32 FMA outside the tensor cores

KERNEL_ITERS = 50                # timed calls per kernel in phase 2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

def time_cuda(fn, iters: int) -> float:
    """Mean milliseconds of fn() on the card: CUDA events around each call,
    with a 256 MB write (evicts the 50 MB L2) and a short spin before it,
    so every call finds its inputs in device memory and the host has
    enqueued the call before the card reaches it."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    fn()
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


def as_real(x: torch.Tensor) -> torch.Tensor:
    """f32 for real tensors; complex ones stay complex (abs is modulus)."""
    return x if x.is_complex() else x.float()


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions at large-v3 shapes
# --------------------------------------------------------------------------

def check_kernels(iters: int):
    import torch.nn.functional as F
    from notsofar_tpu_torch.ops import kernels as K

    g = torch.Generator(device="cuda").manual_seed(1234)
    bf = torch.bfloat16
    rows = []

    def randn(*shape, dtype=bf):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def record(name, replaces, out, ref, tol, mutant, fn, plain, library,
               nbytes, flops, peak_flops=PEAK_BF16_FLOPS, label=None,
               row=True):
        """Hold `out` to `ref` within `tol`, and `mutant` (the plain
        version on inputs with one key or tap changed) outside it, so the
        tolerance is shown to catch a one-input error; then time. With
        `row`, the result becomes the kernel's row of the {"kernels": ...}
        line; without, it is only logged."""
        label = label or name
        torch.cuda.synchronize()
        err = (as_real(out) - as_real(ref)).abs().max().item()
        moved = (as_real(out) - as_real(mutant)).abs().max().item()
        ref = as_real(ref)
        ms = time_cuda(fn, iters)
        plain_ms = time_cuda(plain, max(iters // 4, 3))
        lib_ms = time_cuda(library, iters) if library is not None else None
        b, by = bound_ms(nbytes, flops, peak_flops)
        log(f"kernel {label}: max_abs_err {err:.3e} (tolerance "
            f"{tol:.3e}; max|ref| {ref.abs().max().item():.3e}, "
            f"mean|ref| {ref.abs().mean().item():.3e}; one input "
            f"changed moves it {moved:.3e}) kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library "
            f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms, bound "
            f"{b:.4f} ms by {by} ({nbytes / 1e6:.3f} MB, "
            f"{flops / 1e9:.4f} GFLOP)")
        if not (math.isfinite(err) and err <= tol):
            raise AssertionError(f"{label}: max_abs_err {err} > {tol}")
        if not moved > tol:
            raise AssertionError(f"{label}: a one-input change moves the "
                                 f"output {moved}, within the tolerance {tol}")
        if row:
            rows.append(dict(name=name, route="cuda",
                             source=f"notsofar_tpu_torch/csrc/{name}.cu",
                             replaces=replaces, launches=None,
                             launches_by_path=None, max_abs_err=err,
                             ms=ms, plain_ms=plain_ms, bound_ms=b,
                             bound_by=by, library_ms=lib_ms))

    # encoder_mha: 3 windows x 20 heads, S=1500, dk=64; q and k pre-scaled
    # by dk**-0.25 as the encoder does. Every key is visible.
    BH, S, dk = 3 * 20, 1500, 64
    sc = dk ** -0.25
    q = (randn(BH, S, dk, dtype=torch.float32) * sc).to(bf)
    k = (randn(BH, S, dk, dtype=torch.float32) * sc).to(bf)
    v = randn(BH, S, dk)
    ref = K.encoder_mha_plain(q, k, v)
    # tolerance: both versions round to bf16 an f32 value that differs
    # only by summation order (~1e-6 relative), so they differ by at most
    # one bf16 ulp (2**-7 relative to the binade) of the output; allow two
    # ulps of the largest |output| (the log gives max and mean |output|)
    tol = 2 * 2.0 ** (math.floor(math.log2(ref.float().abs().max().item()))
                      - 7)
    v_mut = v.clone()
    v_mut[:, 0] = 0                     # key 0's values dropped
    record("encoder_mha", "notsofar_tpu/ops/pallas_kernels.py:573",
           K.encoder_mha(q, k, v), ref, tol,
           K.encoder_mha_plain(q, k, v_mut),
           lambda: K.encoder_mha(q, k, v),
           lambda: K.encoder_mha_plain(q, k, v),
           lambda: F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                  scale=1.0),
           nbytes=4 * BH * S * dk * 2, flops=4 * BH * S * S * dk)

    # attn_step: 12 rows (greedy / fallback dispatch width), ctx 448,
    # D 1280 (20 heads of 64), pos at the last slot, per-row left pads
    B, ctx, D, H = 12, 448, 1280, 20
    pos = ctx - 1
    qe = (randn(B, 1, D, dtype=torch.float32) * dk ** -0.5).to(bf)
    kc, vc = randn(B, ctx, D), randn(B, ctx, D)
    pads = torch.randint(0, 64, (B,), generator=g, device="cuda",
                         dtype=torch.int32)
    keys = torch.arange(ctx, device="cuda")
    vis = (keys[None] <= pos) & ((keys[None] >= pads[:, None])
                                 | (keys[None] == pos))
    qs = qe.view(B, 1, H, dk).transpose(1, 2).contiguous()
    ks = kc.view(B, ctx, H, dk).transpose(1, 2).contiguous()
    vs = vc.view(B, ctx, H, dk).transpose(1, 2).contiguous()
    pads_mut = pads.clone()
    pads_mut[0] += 1                    # row 0 loses key pads[0]
    # the output depends on keys pad..pos of each row (pos alone when
    # pad > pos): count those K/V rows, q, pads and the f32 output
    n_keys = int(vis.sum())
    # tolerance: f32 output. The versions sum logits in another order
    # (~1e-7 relative), which sends a few softmax weights p to the other
    # bf16 neighbour; each such weight moves the output by ulp(p)*|v|
    # <= 2**-7 * p * |v|. Measured 3.6e-5 at these inputs on an H100
    # 80GB HBM3 (700 W power limit); the tolerance is about 3x that.
    # |out| is ~0.05 typical; dropping one key moves it by ~1e-2.
    record("attn_step", "notsofar_tpu/ops/pallas_kernels.py:224",
           K.attn_step(qe, kc, vc, pos, pads, dk),
           K.attn_step_plain(qe, kc, vc, pos, pads, dk), 1e-4,
           K.attn_step_plain(qe, kc, vc, pos, pads_mut, dk),
           lambda: K.attn_step(qe, kc, vc, pos, pads, dk),
           lambda: K.attn_step_plain(qe, kc, vc, pos, pads, dk),
           lambda: F.scaled_dot_product_attention(
               qs, ks, vs, attn_mask=vis[:, None, None, :], scale=1.0),
           nbytes=(2 * n_keys * D + B * D) * 2 + B * 4 + B * D * 4,
           flops=4 * n_keys * D)

    # attn_step_split: 2 streams x 5 beams, prompt Pp=256, generated G=256
    # at its last slot, random ancestry (each beam owns its newest slot)
    Bs, Kb, Pp, G = 2, 5, 256, 256
    gslot = G - 1
    qe2 = (randn(Bs * Kb, 1, D, dtype=torch.float32) * dk ** -0.5).to(bf)
    kp, vp = randn(Bs, Pp, D), randn(Bs, Pp, D)
    kg, vg = randn(Bs * Kb, G, D), randn(Bs * Kb, G, D)
    pads2 = torch.randint(0, 128, (Bs,), generator=g, device="cuda",
                          dtype=torch.int32)
    anc = torch.randint(0, Kb, (Bs, Kb, G), generator=g, device="cuda",
                        dtype=torch.int32)
    anc[:, :, gslot] = torch.arange(Kb, device="cuda", dtype=torch.int32)
    anc_mut = anc.clone()
    anc_mut[0, 0, 0] = (anc[0, 0, 0] + 1) % Kb  # beam 0 sees another slot 0
    # the output depends on prompt rows c >= pad and on the distinct
    # generated rows (anc[b, j, s], s), s <= gslot, that some beam sees;
    # each beam sees Pp - pad prompt keys and gslot + 1 generated keys
    n_gen = gslot + 1
    n_prompt = int((Pp - pads2).sum())
    seen = torch.zeros(Bs, Kb, n_gen, device="cuda").scatter_(
        1, anc[:, :, :n_gen].long(), 1.0)
    n_rows = n_prompt + int(seen.sum())
    # tolerance: the same error model as attn_step. At these inputs no
    # weight changed its bf16 rounding (measured 1.2e-7, f32 order only);
    # one that did, at a typical weight p ~ 1.3e-3, would move the output
    # by ~5e-6, so the tolerance admits about two such weights. A wrong
    # ancestry entry on one slot moves it by ~1e-2.
    # library: one SDPA call over the keys pre-concatenated as
    # [prompt | K generated segments] per stream, the K beams as query
    # rows, with the boolean visibility mask of split_visibility_bias
    cols = Pp + Kb * G
    q_lib = qe2.view(Bs, Kb, H, dk).transpose(1, 2).contiguous()
    k_lib, v_lib = (torch.cat([p_, g_.view(Bs, Kb * G, D)], 1)
                    .view(Bs, cols, H, dk).transpose(1, 2).contiguous()
                    for p_, g_ in ((kp, kg), (vp, vg)))
    vis_lib = (K.split_visibility_bias(Bs, Kb, Pp, G, gslot, pads2, anc)
               == 0)[:, None]                          # [Bs, 1, Kb, cols]
    record("attn_step_split", "notsofar_tpu/ops/pallas_kernels.py:334",
           K.attn_step_split(qe2, kp, vp, kg, vg, gslot, pads2, dk, Kb,
                             anc=anc),
           K.attn_step_split_plain(qe2, kp, vp, kg, vg, gslot, pads2, dk,
                                   Kb, anc=anc), 1e-5,
           K.attn_step_split_plain(qe2, kp, vp, kg, vg, gslot, pads2, dk,
                                   Kb, anc=anc_mut),
           lambda: K.attn_step_split(qe2, kp, vp, kg, vg, gslot, pads2, dk,
                                     Kb, anc=anc),
           lambda: K.attn_step_split_plain(qe2, kp, vp, kg, vg, gslot,
                                           pads2, dk, Kb, anc=anc),
           lambda: F.scaled_dot_product_attention(q_lib, k_lib, v_lib,
                                                  attn_mask=vis_lib,
                                                  scale=1.0),
           nbytes=(2 * n_rows * D + Bs * Kb * D) * 2 + Bs * 4
           + Bs * Kb * n_gen * 4 + Bs * Kb * D * 4,
           flops=4 * D * (Kb * n_prompt + Bs * Kb * n_gen))

    # depthwise_conv1d at the TitaNet-large shapes of the diarization
    # path: 256 windows of the largest bucket (3.072 s -> 320 frames),
    # 1024 channels, bf16 activations, f32 taps, k = 7, 11, 15 (the three
    # mega blocks). The row of the kernels line is k = 15; k = 7 and 11 are
    # checked and timed on the lines before it.
    Bd, Td, Cd = 256, 320, 1024
    xd = randn(Bd, Td, Cd)
    for k in (7, 11, 15):
        w = randn(k, Cd, dtype=torch.float32) * k ** -0.5
        w_mut = w.clone()
        w_mut[0, 0] += 1.0                 # channel 0's tap 0 changed
        # tolerance: the kernel sums with FMAs, the plain version with a
        # rounded product and a rounded add, both in the order i=0..k-1
        # from 0; each of the k steps rounds once or twice, so the two
        # differ by at most 2k roundings of the running sum, each at most
        # 2**-24 of sum_i |x w| (largest over the outputs)
        mag = K.depthwise_conv1d_plain(xd.abs(), w.abs(), k).max().item()
        tol = 2 * k * 2.0 ** -24 * mag
        w_bct = w.t()[:, None, :].to(bf).contiguous()   # [C, 1, k]
        x_bct = xd.transpose(1, 2).contiguous()          # [B, C, T]
        record(
            "depthwise_conv1d", "notsofar_tpu/ops/pallas_kernels.py:435",
            K.depthwise_conv1d(xd, w, k), K.depthwise_conv1d_plain(xd, w, k),
            tol, K.depthwise_conv1d_plain(xd, w_mut, k),
            lambda: K.depthwise_conv1d(xd, w, k),
            lambda: K.depthwise_conv1d_plain(xd, w, k),
            lambda: F.conv1d(x_bct, w_bct, padding=(k - 1) // 2, groups=Cd),
            nbytes=Bd * Td * Cd * 2 + k * Cd * 4 + Bd * Td * Cd * 4,
            flops=2 * k * Bd * Td * Cd, peak_flops=PEAK_F32_FLOPS,
            label=f"depthwise_conv1d k={k}", row=k == 15)

    # masked_scm at the MVDR shape of the CSS path: one chunk of 32
    # windows x 257 bins x 186 frames, K = 3 speakers + noise, M = 7 mics;
    # winner-take-all masks of seeded [0, 1) masks, as make_wta gives them
    from notsofar_tpu_torch.ops.mvdr import make_wta
    Bm, Fm, Tm, Mm = 32, 257, 186, 7
    wta = make_wta(torch.rand(Bm, Fm, Tm, 3, generator=g, device="cuda"),
                   torch.rand(Bm, Fm, Tm, 1, generator=g, device="cuda"))
    xs = torch.complex(randn(Bm, Fm, Tm, Mm, dtype=torch.float32),
                       randn(Bm, Fm, Tm, Mm, dtype=torch.float32))
    Km = wta.shape[-1]
    ref = K.masked_scm_plain(wta, xs)
    # tolerance: both versions sum the Tm products of each entry in f32 in
    # other orders (the kernel with FMAs, the plain version in a complex
    # GEMM), so they differ by at most 2*Tm roundings of the entry's
    # sum_t w |x_m| |x_n| (largest over the entries)
    mag = K.masked_scm_plain(wta, xs.abs().to(torch.complex64)).real
    tol = 2 * Tm * 2.0 ** -24 * mag.max().item()
    wta_mut = wta.clone()
    wta_mut[0, 0, 0, 0] += 1.0            # one frame's mask changed
    xs_mut = xs.clone()
    xs_mut[0, 0, 0, 0] += 1.0             # one STFT entry changed
    moved = (K.masked_scm_plain(wta, xs_mut) - ref).abs().max().item()
    log(f"kernel masked_scm: one STFT entry changed moves the plain "
        f"version {moved:.3e} (tolerance {tol:.3e})")
    if not moved > tol:
        raise AssertionError("masked_scm: a one-entry STFT change stays "
                             f"within the tolerance ({moved} <= {tol})")
    wta_c = wta.to(torch.complex64)
    ne = Mm * (Mm + 1) // 2               # unique entries of x x^H
    record("masked_scm", "notsofar_tpu/ops/pallas_kernels.py:488",
           K.masked_scm(wta, xs), ref, tol, K.masked_scm_plain(wta_mut, xs),
           lambda: K.masked_scm(wta, xs),
           lambda: K.masked_scm_plain(wta, xs),
           lambda: torch.einsum("bftk,bftm,bftn->bkfmn", wta_c, xs,
                                xs.conj()),
           nbytes=Bm * Fm * Tm * (Km * 4 + Mm * 8) + Bm * Km * Fm * Mm * Mm * 8,
           # per frame: each unique entry's product (6 FLOP), then K
           # weighted complex adds (4 FLOP each)
           flops=Bm * Fm * Tm * ne * (6 + 4 * Km),
           peak_flops=PEAK_F32_FLOPS)
    return rows


# --------------------------------------------------------------------------
# phase 3: a small model on the card against the CPU reference
# --------------------------------------------------------------------------

def check_reference():
    from notsofar_tpu_torch.asr.beam import BeamDecoder
    from notsofar_tpu_torch.asr.decoding import DecodeOptions, GreedyDecoder
    from notsofar_tpu_torch.asr.tokenizer import WhisperTokenizer
    from notsofar_tpu_torch.models.whisper import WhisperDims, WhisperModel

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dims = WhisperDims(80, 1500, 128, 2, 2, 1864, 448, 128, 2, 2)
    tok = WhisperTokenizer(None, 256, multilingual=True, num_languages=99)
    cpu = WhisperModel(dims, device="cpu").init(
        torch.Generator().manual_seed(5))
    sd = cpu.state_dict()
    rng = np.random.RandomState(5)

    # encoder through encoder_mha: bf16 (the serving dtype; tolerance
    # 2e-2 relative, bf16 matmuls summed in another order) and f32
    # (tolerance 1e-4 relative)
    mel = torch.from_numpy(rng.randn(2, 80, 3000).astype(np.float32))
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        enc_c = WhisperModel(dims, dtype=dtype, device="cpu")
        enc_c.load_state_dict(sd)
        enc_g = WhisperModel(dims, dtype=dtype, device="cuda")
        enc_g.load_state_dict(sd)
        with torch.no_grad():
            a = enc_g.encode(mel.cuda()).float().cpu()
            b = enc_c.encode(mel).float()
        rel = ((a - b).norm() / b.norm()).item()
        log(f"reference encoder ({dtype}): relative error {rel:.3e} "
            f"(tolerance {tol:g})")
        if not (math.isfinite(rel) and rel <= tol):
            raise AssertionError(f"encoder reference: rel err {rel}")

    # decoders in f32 through attn_step / attn_step_split on the card
    gpu = WhisperModel(dims, device="cuda")
    gpu.load_state_dict(sd)
    xa = torch.from_numpy(rng.randn(2, 1500, 128).astype(np.float32) * 0.2)
    opts = DecodeOptions(max_new_tokens=12)
    prompts = [[300, 301, 302], None]
    for name, mk in (
            ("greedy", lambda m: GreedyDecoder(m, tok, opts)),
            ("beam3", lambda m: BeamDecoder(m, tok, opts, beam_size=3,
                                            cache_dtype=torch.float32))):
        rc = mk(cpu).decode_prompted(xa, prompts)
        rg = mk(gpu).decode_prompted(xa.cuda(), prompts)
        dl = float(np.abs(rc["avg_logprob"] - rg["avg_logprob"]).max())
        log(f"reference {name} decode (f32): tokens equal "
            f"{rc['tokens'] == rg['tokens']}, avg_logprob diff {dl:.2e} "
            "(tolerance 1e-3)")
        if rc["tokens"] != rg["tokens"] or not dl <= 1e-3:
            raise AssertionError(f"{name} decode differs from the CPU")
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32


def same_partition(a, b) -> bool:
    """Two label arrays split the items the same way (up to label ids)."""
    pairs = set(zip(np.asarray(a).tolist(), np.asarray(b).tolist()))
    return len(pairs) == len(set(np.asarray(a).tolist())) \
        == len(set(np.asarray(b).tolist()))


def check_diarization_reference():
    """A small TitaNet on the card (its mega-block depthwise convs through
    the CUDA kernel) against the same weights on the CPU (plain version),
    in f32 with TF32 off and in bf16; then the device clustering chain on
    a CUDA affinity against the float64 host path."""
    from notsofar_tpu_torch.diarization import clustering as C
    from notsofar_tpu_torch.models.titanet import SpeakerEncoder, TitaNetConfig
    from notsofar_tpu_torch.ops import kernels

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TitaNetConfig(filters=128, epilogue_filters=256, attention_dim=16,
                        emb_dim=32, block_kernels=(7, 11), block_repeat=2)
    rng = np.random.RandomState(6)
    wavs = (rng.randn(8, 24000) * 0.1).astype(np.float32)
    lengths = rng.randint(8000, 24001, size=8).astype(np.int32)
    for i, n in enumerate(lengths):
        wavs[i, n:] = 0.0
    # tolerances: f32 — sums in another order on both sides (cuBLAS,
    # cuDNN and the kernel's FMAs against CPU kernels), ~1e-6 relative
    # expected, 1e-4 allowed (the JAX-parity tolerance); bf16 — the same
    # sums rounded to bf16 at every conv and dense output, so a value
    # moves by up to a bf16 ulp (2**-8) per rounding point, 3e-2 allowed
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        cpu = SpeakerEncoder(cfg, compute_dtype=dtype, device="cpu", seed=5)
        gpu = SpeakerEncoder(cfg, cpu.module.state_dict(),
                             compute_dtype=dtype, device="cuda")
        before = kernels.LAUNCHES["depthwise_conv1d"]
        a = gpu.embed(wavs, lengths)
        launched = kernels.LAUNCHES["depthwise_conv1d"] - before
        b = cpu.embed(wavs, lengths)
        rel = float(np.abs(a - b).max() / np.abs(b).max())
        log(f"reference titanet ({dtype}): relative error {rel:.3e} "
            f"(tolerance {tol:g}), depthwise_conv1d launches {launched}")
        if not (math.isfinite(rel) and rel <= tol and launched == 4):
            raise AssertionError(f"titanet reference ({dtype}): rel err "
                                 f"{rel}, {launched} kernel launches")
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32

    # the seeded 4-speaker affinity of the JAX package's device-parity test
    rng = np.random.RandomState(7)
    spk = rng.randn(4, 64)
    emb = spk[rng.randint(4, size=150)] + 0.4 * rng.randn(150, 64)
    aff = C.cos_affinity_matrix(emb)
    host = C.nmesc(aff)
    host_labels = C.run_clustering(aff)
    aff_dev = torch.tensor(aff, dtype=torch.float32, device="cuda")
    t0 = time.perf_counter()
    dev = C.nmesc(aff_dev)
    dev_labels = C.run_clustering(aff_dev)
    secs = time.perf_counter() - t0
    log(f"reference clustering: host p_hat {host.p_hat} speakers "
        f"{host.num_speakers} g_p {host.g_p:.6f}; cuda p_hat {dev.p_hat} "
        f"speakers {dev.num_speakers} g_p {dev.g_p:.6f}; same partition "
        f"{same_partition(host_labels, dev_labels)} ({secs:.2f} s on the "
        "card for nmesc + run_clustering)")
    if (dev.p_hat, dev.num_speakers) != (host.p_hat, host.num_speakers) \
            or not same_partition(host_labels, dev_labels):
        raise AssertionError("device clustering differs from the host path")


SMALL_CSS = dict(attention_dim=32, attention_heads=4, linear_units=64,
                 num_blocks=2, kernel_size=5, dropout_rate=0.0)


def check_css_reference():
    """A small MC Conformer CSS (2 blocks, d = 32, kernel 5) on the card
    against the same weights on the CPU: masks from the same features in
    f32 (TF32 off) and bf16; then one short MC engine pass (7.3 s, MVDR
    with use_pallas_scm=True, so masked_scm runs on the card) against the
    CPU's plain path. Activity gating must be equal; streams must match
    where the CPU's f32 MVDR agrees with a float64 MVDR (the stability
    classification of the JAX package's engine test)."""
    from notsofar_tpu_torch.css import engine as E
    from notsofar_tpu_torch.models.conformer import ConformerConfig
    from notsofar_tpu_torch.models.css_wrapper import (ConformerCssConfig,
                                                       CssModel, NnetConfig)
    from notsofar_tpu_torch.ops import kernels

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    small = ConformerCssConfig(nnet_conf=NnetConfig(
        conformer_conf=ConformerConfig(**SMALL_CSS)))
    cpu = CssModel(small, device="cpu", seed=3)
    sd = cpu.module.state_dict()
    rng = np.random.RandomState(8)
    st = (rng.randn(4, 257, 186, 7) + 1j * rng.randn(4, 257, 186, 7)) \
        .astype(np.complex64)
    feat = cpu.features(torch.from_numpy(st))
    # tolerances (masks in [0, 1], absolute): f32 — sums in another order,
    # ~1e-6 expected; bf16 — bf16 roundings at the same points with
    # products summed in another order (4e-3 against the JAX package on
    # the CPU)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        c = CssModel(small, dtype=dtype, state_dict=sd, device="cpu")
        gm = CssModel(small, dtype=dtype, state_dict=sd, device="cuda")
        a = gm.masks_from_feature(feat.cuda())["spk_masks"].cpu()
        b = c.masks_from_feature(feat)["spk_masks"]
        err = (a - b).abs().max().item()
        log(f"reference css masks ({dtype}): max abs error {err:.3e} "
            f"(tolerance {tol:g})")
        if not (math.isfinite(err) and err <= tol):
            raise AssertionError(f"css masks ({dtype}): {err} > {tol}")

    mix = (rng.randn(1, int(7.3 * 16000), 7) * 0.1).astype(np.float32)
    cfg = E.CssCfg(seg_bucket_multiple=4, seg_chunk=2, use_pallas_scm=True)
    gpu = CssModel(small, state_dict=sd, device="cuda")
    before = kernels.LAUNCHES["masked_scm"]
    gw, gs = E.CssEngine(gpu, cfg).separate_and_stitch(mix, 16000)
    launched = kernels.LAUNCHES["masked_scm"] - before
    cw, cs = E.CssEngine(cpu, cfg).separate_and_stitch(mix, 16000)
    mvdr32 = E.mvdr_beamform
    E.mvdr_beamform = lambda s, n, x, use_pallas=False: mvdr32(
        s.double(), n.double(), x.to(torch.complex128)).to(torch.complex64)
    try:
        dw, _ = E.CssEngine(cpu, cfg).separate_and_stitch(mix, 16000)
    finally:
        E.mvdr_beamform = mvdr32
    act_equal = np.array_equal(gs["activity_final"], cs["activity_final"])
    mask_err = np.abs(gs["mask_stitched"] - cs["mask_stitched"]).max()
    gaps = []
    for s in range(3):
        scale = max(np.abs(dw[s]).max(), 1e-6)
        stable = np.abs(cw[s] - dw[s]).max() / scale < 1e-3
        gaps.append((bool(stable),
                     float(np.abs(gw[s] - cw[s]).max() / scale)))
    log(f"reference css engine: masked_scm launches {launched}, activity "
        f"equal {act_equal}, stitched mask max abs diff {mask_err:.3e}, "
        f"streams (stable in f32, rel diff card vs cpu) {gaps} "
        "(tolerances: activity equal, masks 5e-3 rel + 5e-4, stable "
        "streams 2e-2)")
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32
    if launched != 2 or not act_equal:
        raise AssertionError("css engine on the card: launches or activity")
    if not np.allclose(gs["mask_stitched"], cs["mask_stitched"],
                       rtol=5e-3, atol=5e-4):
        raise AssertionError(f"css engine stitched masks differ {mask_err}")
    for stable, d in gaps:
        if stable and not d < 2e-2:
            raise AssertionError(f"css engine stable stream differs {d}")


# --------------------------------------------------------------------------
# phases 4-5: the ASR serving path at full large-v3 width
# --------------------------------------------------------------------------

def write_session(work: Path, n_streams: int = 3, seconds: float = 40.0,
                  seed: int = 0):
    """A synthetic session: n_streams int16 wavs of `seconds`, seeded —
    bursts of harmonic tones and noise separated by pauses."""
    import pandas as pd
    import scipy.io.wavfile as wf
    rng = np.random.RandomState(seed)
    sr = 16000
    n = int(seconds * sr)
    t = np.arange(n) / sr
    names = []
    for s in range(n_streams):
        x = 0.01 * rng.randn(n)
        pos = 0.0
        while pos < seconds:
            dur = rng.uniform(1.0, 4.0)
            a, b = int(pos * sr), min(int((pos + dur) * sr), n)
            f0 = rng.uniform(90, 250)
            seg = sum(np.sin(2 * np.pi * f0 * h * t[a:b]) / h
                      for h in range(1, 6))
            x[a:b] += 0.2 * seg * np.hanning(b - a)
            pos += dur + rng.uniform(0.3, 2.0)
        name = work / f"sep_stream{s}.wav"
        wf.write(name, sr, (np.clip(x, -1, 1) * 32767).astype(np.int16))
        names.append(str(name))
    return pd.Series(dict(session_id="smoke_session", meeting_id="MTG_SMOKE",
                          sep_wav_file_names=names))


def run_asr(session, work: Path, beam_size, label, needs):
    """asr_inference with the shipped config (large-v3, bf16, word
    timestamps, the default max_new_tokens) and the given beam size.
    The launch counts are reset just before the call and read just
    after; every kernel in `needs` must have launched. Returns the
    counts and the segments dataframe."""
    import pandas as pd
    from notsofar_tpu_torch.asr.inference import WhisperAsrCfg, asr_inference
    from notsofar_tpu_torch.ops import kernels
    from notsofar_tpu_torch.utils.profiling import StageTimer
    cfg = WhisperAsrCfg(model_name="large-v3", beam_size=beam_size)
    timer = StageTimer()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    df = asr_inference(str(work / label), session, cfg,
                       fetch_from_cache=False, timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    log(f"asr {label}: kernel launches {counts}")
    missing = [n for n in needs if counts[n] <= 0]
    if missing:
        raise AssertionError(f"asr {label}: never launched {missing}")
    stages = {k: round(v, 3) for k, v in timer.stage_seconds.items()}
    log(f"asr {label}: {len(df)} segments, wall {wall:.2f} s, stages {stages}"
        f", max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    cols = ["start_time", "end_time", "text", "word_timing", "meeting_id",
            "session_id", "wav_file_name"]
    if list(df.columns) != cols:
        raise AssertionError(f"dataframe columns {list(df.columns)}")
    pkl = work / label / "asr" / "smoke_session" / "large-v3" / \
        "all_segments_df.pkl"
    if not pkl.exists() or len(pd.read_pickle(pkl)) != len(df):
        raise AssertionError(f"missing or different pickle cache {pkl}")
    if len(df) == 0:
        raise AssertionError("no segments")
    # segment times come from timestamp tokens and may run up to a window
    # (30 s) past the audio; word times come from the alignment, which
    # never leaves the audio (40 s)
    for _, r in df.iterrows():
        if not (math.isfinite(r.start_time) and math.isfinite(r.end_time)
                and 0 <= r.start_time <= r.end_time <= 40.0 + 30.0):
            raise AssertionError(f"bad segment times {r.start_time} "
                                 f"{r.end_time}")
        for w, ws, we in r.word_timing:
            if not (0 <= ws <= we <= 40.0 + 0.02):
                raise AssertionError(f"bad word times {w!r} {ws} {we}")
    return counts, df


# --------------------------------------------------------------------------
# phase 6: word-based diarization on the ASR output
# --------------------------------------------------------------------------

SHIPPED_SCALES = [3.0, 2.5, 2.0, 1.5, 1.0, 0.5]   # inference_v1.yaml


def add_word_track(df, seconds: float, seed: int, per_segment: int = 8):
    """The ASR dataframe plus a seeded track of words on every stream at
    conversational density (0.15-0.9 s words, 0.05-0.5 s gaps: ~1.25
    words/s per stream), as segments in the ASR frame's own format.

    Random-weight Whisper leaves the ASR frames nearly wordless: its
    near-uniform logits give the 1501 timestamp tokens more mass than any
    text token, so the timestamp rule forces timestamps at almost every
    step, and the byte-fallback tokenizer decodes ids >= 256 to nothing
    (even with a full-size vocabulary and no hallucination rule, large-v3
    gave 4 words per 30 s window on an H100). A meeting's transcript has
    hundreds of words per stream; this track gives the diarization path
    that load, on the session's own wavs."""
    import pandas as pd
    rng = np.random.RandomState(seed)
    letters = "etaoinshrdlucmfwypvbgkjqxz"
    rows = []
    for wav in sorted(df.wav_file_name.unique()):
        t, words = rng.uniform(0.0, 0.5), []
        while True:
            dur = rng.uniform(0.15, 0.9)
            if t + dur > seconds:
                break
            text = " " + "".join(rng.choice(list(letters), rng.randint(2, 8)))
            words.append([text, round(t, 2), round(t + dur, 2)])
            t += dur + rng.uniform(0.05, 0.5)
        for i in range(0, len(words), per_segment):
            seg = words[i:i + per_segment]
            rows.append(dict(start_time=seg[0][1], end_time=seg[-1][2],
                             text="".join(w[0] for w in seg),
                             word_timing=seg,
                             meeting_id=df.meeting_id.iloc[0],
                             session_id=df.session_id.iloc[0],
                             wav_file_name=wav))
    return pd.concat([df, pd.DataFrame(rows)], ignore_index=True)


def planned_chunks(dfs, cfg, seconds: float, batch_size: int = 256) -> dict:
    """Words, windows and TitaNet chunks that word_based_clustering_batch
    plans for these sessions (one shared bucket plan); each chunk is one
    TitaNet forward, 9 depthwise_conv1d launches at TitaNet-large."""
    from notsofar_tpu_torch.diarization import word_based as wb
    words_per, windows = [], []
    for df in dfs:
        d = df.copy()
        d["wav_file_name"] = d["wav_file_name"].astype("category")
        d["wav_file_name_ind"] = d["wav_file_name"].cat.codes
        w, win = wb.collect_word_windows(d, seconds, cfg.min_embedding_windows,
                                         cfg.max_allowed_word_duration)
        words_per.append(len(w))
        windows.extend((wds, ws) for wds, ws in zip(w, win))
    tasks = wb.window_tasks([w for w, _ in windows],
                             [ws for _, ws in windows], 16000,
                             int(seconds * 16000))
    buckets = wb.bucket_windows(tasks)
    chunks = {b: wb.chunk_count(len(v), batch_size)
              for b, v in sorted(buckets.items())}
    return dict(words=words_per, windows=len(tasks),
                windows_by_bucket={b: len(v) for b, v in
                                   sorted(buckets.items())},
                chunks_by_bucket=chunks, chunks=sum(chunks.values()))


def run_diarization(work: Path, asr_dfs: dict, seconds: float = 40.0):
    """The shipped word_nmesc config (6 scales, dedup, TitaNet-large at full
    width in bf16, seeded random weights) on the ASR dataframes of
    phases 4 and 5 as two sessions: diarization_batch_prepass, then each
    session read back through diarization_inference(fetch_from_cache=
    True), then one serial diarization_inference on the beam-5 session.
    Launch counts are reset before the phase; depthwise_conv1d must
    launch exactly 9 times per planned TitaNet chunk. Returns the
    counts."""
    import pandas as pd
    from notsofar_tpu_torch.diarization.common import DiarizationCfg
    from notsofar_tpu_torch.diarization.diarization import (
        diarization_batch_prepass, diarization_inference)
    from notsofar_tpu_torch.ops import kernels
    from notsofar_tpu_torch.utils.profiling import StageTimer

    cfg = DiarizationCfg(method="word_nmesc",
                         min_embedding_windows=SHIPPED_SCALES,
                         apply_deduplication=True)
    dfs = {}
    for seed, (label, df) in enumerate(asr_dfs.items()):
        d = df.copy()
        d["session_id"] = f"smoke_{label}"
        n_asr = sum(len(wt) for wt in d.word_timing)
        dfs[label] = add_word_track(d, seconds, seed)
        log(f"diarization session smoke_{label}: {n_asr} ASR words + "
            f"{sum(len(wt) for wt in dfs[label].word_timing) - n_asr} "
            "track words")
    plan = planned_chunks(list(dfs.values()), cfg, seconds)
    serial_plan = planned_chunks([dfs["beam5"]], cfg, seconds)
    log(f"diarization plan: words per session {plan['words']}, windows "
        f"{plan['windows']} {plan['windows_by_bucket']}, chunks "
        f"{plan['chunks']} {plan['chunks_by_bucket']}; serial beam5 "
        f"chunks {serial_plan['chunks']}")
    if min(plan["words"]) < 64:
        raise AssertionError(f"sessions need >= 64 words for the device "
                             f"clustering chain: {plan['words']}")

    out_dir = work / "diar"
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    prepass = StageTimer()
    diarization_batch_prepass(str(out_dir), list(dfs.values()), cfg,
                              fetch_from_cache=False, timer=prepass)
    torch.cuda.synchronize()
    t_prepass = time.perf_counter() - t0
    speakers = {}
    for label, df in dfs.items():
        pkl = out_dir / "diarization" / f"smoke_{label}" / "word_nmesc" / \
            "all_segments_df.pkl"
        if not pkl.exists():
            raise AssertionError(f"missing diarization pickle {pkl}")
        out = diarization_inference(str(out_dir), df, cfg,
                                    fetch_from_cache=True)
        check_attributed(out, label, seconds)
        speakers[label] = out.speaker_id.nunique()
    t1 = time.perf_counter()
    serial = StageTimer()
    out = diarization_inference(str(work / "diar_serial"), dfs["beam5"], cfg,
                                fetch_from_cache=False, timer=serial)
    torch.cuda.synchronize()
    t_serial = time.perf_counter() - t1
    check_attributed(out, "beam5 serial", seconds)
    counts = dict(kernels.LAUNCHES)
    log(f"diarization: kernel launches {counts}")
    log(f"diarization prepass: wall {t_prepass:.2f} s, stages "
        f"{ {k: round(v, 3) for k, v in prepass.stage_seconds.items()} }; "
        f"serial beam5: wall {t_serial:.2f} s, stages "
        f"{ {k: round(v, 3) for k, v in serial.stage_seconds.items()} }; "
        f"speakers {speakers}, serial beam5 {out.speaker_id.nunique()}; "
        f"max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    want = 9 * (plan["chunks"] + serial_plan["chunks"])
    n = counts["depthwise_conv1d"]
    if not (n > 0 and n % 9 == 0 and n == want):
        raise AssertionError(f"depthwise_conv1d launched {n} times, "
                             f"planned {want}")
    if out.speaker_id.nunique() != speakers["beam5"]:
        raise AssertionError("serial beam5 speaker count "
                             f"{out.speaker_id.nunique()} != prepass "
                             f"{speakers['beam5']}")
    return counts


def check_attributed(df, label: str, seconds: float) -> None:
    """Every word has a speaker and times inside the audio."""
    if len(df) == 0 or df.speaker_id.isna().any():
        raise AssertionError(f"diarization {label}: no segments or a "
                             "segment without speaker")
    for _, r in df.iterrows():
        if not str(r.speaker_id).startswith("spk"):
            raise AssertionError(f"diarization {label}: {r.speaker_id!r}")
        for w in r.word_timing:                 # [text, start, end, ch]
            if not (0 <= w[1] <= w[2] <= seconds + 0.02):
                raise AssertionError(f"diarization {label}: bad word times "
                                     f"{w!r}")


# --------------------------------------------------------------------------
# phase 7: CSS separation at full Conformer-large width
# --------------------------------------------------------------------------

def write_css_sessions(work: Path, n_sessions: int = 2,
                       seconds: float = 360.0, seed: int = 10):
    """Seeded 7-channel sessions of `seconds`: three sources of harmonic
    bursts (90-250 Hz f0, 5 harmonics, 1-4 s bursts, 0.5-5 s pauses), each
    at its own azimuth and reaching every mic with the plane-wave delay of
    the 7-mic circular array (utils/mic_array.py), plus noise; written as
    one int16 wav per mic, as load_session_audio reads them. Returns the
    sessions' rows."""
    import pandas as pd
    import scipy.io.wavfile as wf
    from notsofar_tpu_torch.utils.mic_array import multichannel_mic_pos_xyz_cm
    sr = 16000
    n = int(seconds * sr)
    pos = multichannel_mic_pos_xyz_cm()[:, :2] / 100.0     # metres
    freqs = torch.fft.rfftfreq(n, 1.0 / sr, device="cuda",
                               dtype=torch.float64)
    rows = []
    for si in range(n_sessions):
        rng = np.random.RandomState(seed + si)
        mics = torch.from_numpy(0.003 * rng.randn(7, n)).cuda()
        for _ in range(3):
            x = np.zeros(n)
            pos_s = rng.uniform(0.0, 3.0)
            while pos_s < seconds:
                dur = rng.uniform(1.0, 4.0)
                a, b = int(pos_s * sr), min(int((pos_s + dur) * sr), n)
                tt = np.arange(b - a) / sr
                f0 = rng.uniform(90, 250)
                x[a:b] = 0.1 * np.hanning(b - a) * sum(
                    np.sin(2 * np.pi * f0 * h * tt + rng.uniform(0, 6.3)) / h
                    for h in range(1, 6))
                pos_s += dur + rng.uniform(0.5, 5.0)
            az = rng.uniform(0.0, 2 * np.pi)
            delay = -(pos @ np.array([np.cos(az), np.sin(az)])) / 343.0
            X = torch.fft.rfft(torch.from_numpy(x).cuda())
            shift = torch.exp(-2j * np.pi * freqs[None, :]
                              * torch.from_numpy(delay).cuda()[:, None])
            mics += torch.fft.irfft(X[None, :] * shift, n)
        audio = mics.clamp(-1, 1).mul(32767).round().short().cpu().numpy()
        names = []
        for m in range(7):
            name = work / f"css_s{si}" / f"mic{m}.wav"
            name.parent.mkdir(parents=True, exist_ok=True)
            wf.write(name, sr, audio[m])
            names.append(str(name))
        rows.append(dict(session_id=f"css_smoke{si}", meeting_id="MTG_SMOKE",
                         is_mc=True, wav_file_names=names))
    return pd.DataFrame(rows), seconds


def planned_scm_launches(engine, seconds: float, sessions: int) -> int:
    """masked_scm launches of one pass over `sessions` equal sessions:
    one per chunk of windows (the engine's chunk rule)."""
    from notsofar_tpu_torch.ops.stft import num_frames
    geo = engine.seg_geometry(16000)
    T, hop = geo["seg_frames"], geo["hop_frames"]
    frames = num_frames(int(seconds * 16000))
    bucket = engine.cfg.seg_bucket_multiple
    num_seg = math.ceil(math.ceil((frames - (T - hop)) / hop) / bucket) \
        * bucket
    total = sessions * num_seg
    chunk = min(engine.cfg.seg_chunk, total)
    while total % chunk:
        chunk -= 1
    return total // chunk


def run_css(work: Path):
    """css_batch_prepass of both sessions in one pass, then one serial
    css_inference (fetch_from_cache=False) of the first, with the shipped
    CSS settings (inference_v1.yaml: MVDR, mask floor 0 dB, activity_th
    0.3), Conformer-large at full width in bf16 with seeded random
    weights, and use_pallas_scm=True. Launch counts are reset before the
    prepass and read after the serial call; masked_scm must launch once
    per planned chunk in each. Returns the counts."""
    import scipy.io.wavfile as wf
    from notsofar_tpu_torch.css.engine import CssCfg, CssEngine
    from notsofar_tpu_torch.css.inference import (css_batch_prepass,
                                                  css_inference)
    from notsofar_tpu_torch.models.css_wrapper import (
        ConformerCssConfig, CssModel, NnetConfig, large_conformer_config)
    from notsofar_tpu_torch.ops import kernels
    from notsofar_tpu_torch.utils.profiling import StageTimer

    t0 = time.perf_counter()
    sessions, seconds = write_css_sessions(work)
    cfg = CssCfg(mc_mvdr=True, mc_mask_floor_db=0.0, activity_th=0.3,
                 use_pallas_scm=True, batch_sessions=2)
    model = CssModel(ConformerCssConfig(nnet_conf=NnetConfig(
        conformer_conf=large_conformer_config())), dtype=torch.bfloat16,
        device="cuda", seed=11)
    engine = CssEngine(model, cfg)
    plan_pre = planned_scm_launches(engine, seconds, len(sessions))
    plan_ser = planned_scm_launches(engine, seconds, 1)
    log(f"css set-up: {len(sessions)} sessions x 7 mics x {seconds:.0f} s "
        f"written and Conformer-large ({sum(p.numel() for p in model.module.parameters()) / 1e6:.1f} M "
        f"parameters) built in {time.perf_counter() - t0:.1f} s; planned "
        f"masked_scm launches: prepass {plan_pre}, serial {plan_ser}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    pre = StageTimer()
    t0 = time.perf_counter()
    css_batch_prepass(str(work / "css"), "", sessions, cfg,
                      fetch_from_cache=False, timer=pre, engine=engine)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    n_pre = kernels.LAUNCHES["masked_scm"]
    ser = StageTimer()
    t0 = time.perf_counter()
    row = css_inference(str(work / "css_serial"), "", sessions.iloc[0], cfg,
                        fetch_from_cache=False, timer=ser, engine=engine)
    torch.cuda.synchronize()
    t_ser = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    n_ser = counts["masked_scm"] - n_pre
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    def stages(timer):
        st = timer.stage_seconds
        return {"stft+features": round(st.get("stft", 0.0)
                                       + st.get("features", 0.0), 3),
                **{k: round(st.get(k, 0.0), 3)
                   for k in ("conformer", "mvdr", "stitch", "istft")}}

    log(f"css: kernel launches {counts}")
    log(f"css prepass ({len(sessions)} sessions): wall {t_pre:.2f} s "
        f"({t_pre / len(sessions):.2f} s per session), stages "
        f"{stages(pre)}; serial: wall {t_ser:.2f} s, stages {stages(ser)};"
        f" max_memory_allocated {peak:.2f} GiB")
    if (n_pre, n_ser) != (plan_pre, plan_ser):
        raise AssertionError(f"masked_scm launched {n_pre} + {n_ser} times, "
                             f"planned {plan_pre} + {plan_ser}")

    names = ["input_mixture.wav"] + [f"sep_stream{k}.wav" for k in range(3)]
    for sid in sessions.session_id:
        d = work / "css" / "css_inference" / sid
        if sorted(p.name for p in d.iterdir()) != names:
            raise AssertionError(f"css {sid}: files {sorted(d.iterdir())}")
        for nm in names:
            sr, w = wf.read(d / nm)
            if sr != 16000 or len(w) < seconds * 16000 - 512 or \
                    not np.isfinite(w).all():
                raise AssertionError(f"css {sid}/{nm}: {sr} Hz, {len(w)} "
                                     "samples or non-finite values")
    # the serial call against the prepass, on the written (peak-0.99)
    # streams: tolerance one bf16 ulp (2**-8) of the peak — the two runs
    # batch the session's STFT with a different row count, and an f32
    # difference there can move a bf16 rounding of the Conformer
    diffs = []
    for k in range(3):
        a = wf.read(work / "css" / "css_inference" / sessions.session_id[0]
                    / f"sep_stream{k}.wav")[1]
        b = wf.read(row.sep_wav_file_names[k])[1]
        diffs.append(float(np.abs(a - b).max()))
    log(f"css serial vs prepass: max abs diff per stream {diffs} "
        f"(tolerance {2.0 ** -8:.3e})")
    if not max(diffs) <= 2.0 ** -8:
        raise AssertionError(f"serial streams differ from the prepass's "
                             f"{diffs}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from notsofar_tpu_torch.ops import build

    t_start = time.perf_counter()
    log("phase 1 card")
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    OUT.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    logs = build.build_all()
    (OUT / "kernel_build.log").write_text(
        "\n".join(f"== {n}\n{txt}" for n, txt in logs.items()))
    log(f"phase 2 kernels: built {sorted(logs)} in "
        f"{time.perf_counter() - t0:.1f} s (ptxas report in "
        "chiprun_out/kernel_build.log)")
    for n, txt in logs.items():
        for line in txt.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {n}: {line.strip()}")
    rows = check_kernels(KERNEL_ITERS)

    log("phase 3 reference")
    check_reference()
    check_diarization_reference()
    check_css_reference()

    by_path, asr_dfs = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=OUT) as tmp:
        work = Path(tmp)
        session = write_session(work)
        log("phase 4 asr, beam 5")
        by_path["beam5"], asr_dfs["beam5"] = run_asr(
            session, work, 5, "beam5", ("encoder_mha", "attn_step_split"))
        log("phase 5 asr, greedy")
        by_path["greedy"], asr_dfs["greedy"] = run_asr(
            session, work, None, "greedy", ("encoder_mha", "attn_step"))
        log("phase 6 diarization, word_nmesc")
        by_path["diarization"] = run_diarization(work, asr_dfs)
        log("phase 7 css, Conformer-large + MVDR")
        by_path["css"] = run_css(work)
    for r in rows:
        r["launches_by_path"] = {p: c[r["name"]] for p, c in by_path.items()}
        r["launches"] = sum(r["launches_by_path"].values())
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
