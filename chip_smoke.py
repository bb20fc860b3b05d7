#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (notsofar_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. card      print nvidia-smi's name and power limit.
2. kernels   build csrc/*.cu with nvcc (one process per source, all in
             parallel); at the main path's shapes (large-v3 attention,
             the int8 decoder's cross-attention at its beam-5 and greedy
             serving shapes, TitaNet-large depthwise convs at k = 7, 11,
             15 on word_nmesc's 256 x 320 frames and on the time-based
             path's 64 windows of 64 and 304 frames (logged), MVDR's
             masked covariance) and the kernel tools' default
             shapes (xattn_stream and xattn_onedot at 24 rows of int8
             K/V, S 1504, D 1280; attn_step_split_bias at 8 streams x 5
             beams, Pp 256, G 192, with a finite bias and a row masked
             everywhere), plus attn_step_split at 9 and 16 beams (Pp 224,
             G 224; logged), attn_step_split_bias at 9 beams (2 streams,
             Pp 224, G 224; logged) and attn_step_split with gslot as a
             device tensor (equal to the int path bit for bit), hold each
             kernel against its plain PyTorch version, show that the
             tolerance would catch a change of one key, tap, mask or
             STFT entry, and time
             kernel, plain version and one PyTorch library call (CUDA
             events, L2 flushed before every call). xattn_stream must be
             bit-exact with a checksum equal to the sum of every K and V
             byte. The split-softmax kernels (xattn_int8,
             attn_step_split_bias, attn_step) also log their launch plan
             and their times over cluster sizes R = 1-8. attn_step takes
             pos as a device tensor, at the last slot (447, the row) and at
             111 (logged), each against its plain version, the pad mutant
             and its own bound, and is also timed as 32 launches in one
             CUDA graph; the timer's floor (one 1-element launch) and
             xattn_stream over the same bytes are logged beside it. The
             two kernels that round each normalized weight on the decode
             step (attn_step, attn_step_split) are then held, over 8
             seeded draws of their inputs, pos and gslot, to their plain
             versions and to a float64 witness within the bf16
             weight-flip model of those inputs (attn_step_split's gates
             are that model). The decode step's two kernels for work
             the JAX package leaves to XLA fusion: xattn_step (3 windows
             x Tq 1 and 5 against 1500 frames of bf16 memory; SDPA as
             the library) and decode_gemv (QuantDense int8 1280 -> 1280,
             5120 and 5120 -> 1280, the int8 and the bf16 logits 1280 ->
             51 866, at 3, 15 and 48 rows; torch.matmul on pre-widened
             bf16 weights as the library), each within its error model
             and rejecting one memory row or weight changed, cluster
             sizes logged (also as 32 launches in one CUDA graph); then
             decode_gemv's modes of the fused decode step
             (check_fused_step_modes: the one q/k/v launch writing the
             cache, the layer norm in the prologue of the query and fc1,
             GELU and the residual add in the epilogues, bf16 dense
             layers with nn.Dense's rounding) for the int8 and bf16
             decoders at 3, 15 and 48 rows, each output within its own
             tolerance, the one-weight mutant outside it, an RMS gate that
             the plain version with one rounding point moved must exceed,
             timed by events and in a graph beside torch.matmul on the
             widened weights, the q/k/v launch's cluster size swept;
             xattn_onedot's cluster sizes (R = 1: a block per row, the
             first design's grid) and masked_scm's ring of
             1-8 buffers in flight (1: the first design's schedule).
3. reference a small Whisper on the card against the same weights on the
             CPU (plain paths): encoder output (bf16 and f32), greedy
             and beam-3 decode tokens (f32, TF32 off), and the same for
             its int8 decoder with int8 cross-attention K/V (xattn_int8
             launched once per layer per counted decoder call); a small TitaNet
             likewise (embeddings in f32 and bf16); the device
             clustering chain on a CUDA affinity against the float64
             host path (p_hat, speaker count, partition).
3b. graph   the decode loops on the card as CUDA graphs (the default)
             against the same loops run eagerly: Whisper large-v3 at full
             width with seeded random weights, bf16 then the int8 decoder,
             seeded mel windows, beam 5 and greedy, 32 new tokens; one
             decoder per loop decodes keys A (3 windows) and B (2) in the
             order A, B, A, A, each call on windows of its own: the first
             call of a key captures its set-up, step-0 and step graphs,
             the later A calls capture nothing and replay every step;
             every call's tokens equal, scores within 1e-4, launch and
             decoder call counts equal to the eager loop's on its inputs;
             a sampled greedy rung (per-row fallback generators) twice on
             one key draws what the eager loop draws from the same
             generators; per call the host seconds of the set-up, step 0
             and the captures, ms a call, eager and graphed ms per step
             (asr.decoding.DECODE_STEPS); one
             decoder step's kernels under torch.profiler at 3 rows
             (greedy) and 15 (beam 5), bf16 and int8, and the same step
             replayed as a CUDA graph: ms per replay and the device's
             busy share over 10 replays under torch.profiler
             (tools/time_decode_step.py step_profile).
             Then the bf16 model with its EOT row scaled (rows end at
             different steps) decodes greedy and beam 5 with the loops'
             finished.all() interval at 1, 2, 4 and 8: tokens and stats
             equal, steps and ms per decode call logged.
4. asr beam  a seeded synthetic session of 3 streams x 40 s through
             asr_inference with the shipped config: Whisper large-v3 at
             full width, bf16, beam 5, word timestamps,
             condition_on_previous_text, seeded random weights.
             Launch counts are reset before the call and read after it:
             encoder_mha and attn_step_split must be > 0, xattn_step
             launch 32 times per decoder call counted under it and
             decode_gemv 193 times per fused step (6 a layer and the
             logits) and 257 per call run layer by layer (prefill at up
             to 64 rows), the fused steps counted at least the decode
             steps. The decode
             steps (replayed from CUDA graphs and eager), the graph
             captures and their seconds, ms per step, the decode calls
             with their workspace hits, misses and evictions, the bytes
             the workspaces hold and the peak memory are logged, and
             the attn_step launches as a histogram of (rows, cache
             length, pos), which must account for every counted launch.
5. asr greedy the same session with beam_size=None (greedy + fallback
             ladder); counted the same way: encoder_mha and attn_step
             must be > 0; its steps logged as phase 4's.
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
6b. diarization, time-based: MarbleNet (DEFAULT_BLOCKS) and the
             telephonic MSDD on the card against the CPU (f32, TF32 off,
             1e-4); seeded NeMo-layout .nemo checkpoints of both written
             under chiprun_out/ and found through NOTSOFAR_MODELS_DIR
             (the MarbleNet's classifier bias makes speech win every
             frame: every window is embedded); diarization_inference
             with method 'nmesc' (meeting recipe) and 'nmesc_msdd'
             (telephonic) on phase 4's session plus phase 6's word track,
             TitaNet-large in bf16: the MarbleNet VAD ran, the MSDD
             loaded (no fallback), every word attributed, >= 1 speaker,
             depthwise_conv1d 9 times per planned TitaNet forward (64
             windows each, per recipe scale); then msdd_refine at full
             width on the telephonic base windows with a seeded
             4-speaker labelling (6 pairs). Stage times logged (read_wav,
             vad, embed, clustering, msdd, assign).
7. css       CSS separation (css_batch_prepass of two seeded 7-channel
             360 s sessions in one pass, then one serial css_inference
             of the first) with Conformer-large at full width, bf16,
             seeded random weights, MVDR through the masked_scm kernel
             (use_pallas_scm=True) and the shipped activity_th 0.3. Every
             stream finite and on disk, the serial streams equal to the
             prepass's, masked_scm launched once per planned chunk.
8. pipeline  what run_inference_gpu.py runs: a seeded synthetic 7-channel
             NOTSOFAR meeting (devices.json, gt_transcription.json,
             metadata, wavs) through inference_pipeline with the shipped
             configs/inference/inference_v1.yaml except asr.compute_dtype
             'int8': Conformer-large + MVDR, Whisper large-v3 int8 at beam
             5 with int8 cross-attention K/V at 48 rows per dispatch,
             TitaNet-large word_nmesc; CSS and Whisper weights seeded and
             saved under a models dir. The ASR frame reaches diarization
             with phase 6's seeded word track added. Every contract file
             must exist and the meeting gets a WER row; xattn_int8
             launches = 32 x and decode_gemv = 193 x (fused steps) + 257 x
             (layer by layer) the decoder calls that reach them, as the
             decoder counts them, each at least the decode steps;
             encoder_mha and attn_step_split launch;
             depthwise_conv1d launches 9 times per planned TitaNet chunk.
             Decode steps and attn_step traffic logged as phase 4's. A
             seeded hypothesis is
             then scored against the
             meeting's GT through calc_wer with known answers (the GT
             itself: 0; one word dropped: 1/N), naming the scorer core.
9. tools     python -m notsofar_tpu_torch.tools.bench_xattn_variants and
             .bisect_attn_split at their default shapes with a few
             iterations (each chain and row timed as replays of a CUDA
             graph): the numeric line must match the plain versions,
             every timed row be finite, and each kernel launch as many
             times as the tool's loops call it; the stream chain is
             logged against 32 x phase 2's xattn_stream time.
10. train    the CSS training stack at the shipped recipe's full width
             (configs/train_css/conformer_v1.0_mc.yaml: Conformer-large,
             f32, mask/l1 loss, AdamW, clip 0.01): (a) one step on 2
             seeded 3 s segments on the card against the CPU from the
             same seeded weights, held by training/parity.py (scalars
             1e-3 relative, arrays 0.1 of their scale, each update
             element in Adam's box, the card's update AdamW's step from
             its own moments), the one-gradient sign-flip mutant outside;
             ReLU inputs of another sign on the card, and the CPU against
             itself with the batch's rows swapped, logged; the card's
             gradient and first-moment distance and ReLU sign flips also
             with cuDNN's TF32 at PyTorch's default (on) under the port's
             f32 guard, and with the guard bypassed (logged); (b)
             run_training_css for 8 iterations of 32 segments on a seeded
             simulated partition in the reference byte format (eval and
             checkpoint every 4): ms a step after a sync, segments a
             second, the loader's wait, peak memory, every loss finite;
             (c) the step-8 checkpoint restored into a fresh state bit for
             bit with both step counters, then 2 more iterations with
             resume=True; (d) save_css_model's params.msgpack read back by
             load_css_model on the card, masks equal bit for bit to the
             in-memory module's. No hand-written kernel may launch.
11. validate python -m notsofar_tpu_torch.tools.validate_real_weights,
             run in process inside phase 8's directory (its MC reference
             .pt, Whisper large-v3 .pt and 7-channel 40 s meeting) with
             seeded checkpoints of every other format written beside
             them at published widths: the SC Conformer-large as
             params.msgpack, titanet_large.nemo, the MarbleNet
             (DEFAULT_BLOCKS, classifier bias 0) and the telephonic MSDD
             .nemo. All eight components must PASS with rc 0 (css-mc,
             css-sc, whisper, titanet, marblenet within rel 1e-3 of the
             independent NeMo-semantics oracle, msdd, e2e-wer with the
             shipped inference_v1.yaml, int8-wer-delta: the pipeline in
             bf16 and int8); each component timed, its launches counted;
             the whisper component under utils.profiling.trace into
             chiprun_out/validate_trace/ (gzipped), whose kernel events
             must name encoder_mha, attn_step, xattn_step and
             decode_gemv; the validator's decode calls (workspace hits,
             misses, bytes) and peak memory are logged.
             separate_uploaded_lazy must leave the streams
             on the card until first read. cuDNN's default TF32 against
             the full-f32 MarbleNet and MSDD is logged. Mutants: a sign
             flip in the MarbleNet conversion FAILs marblenet on the
             oracle bound; the MC .pt overwritten with garbage FAILs
             css-mc with rc 1, every other model component unchanged.

Phase 2 also holds masked_scm at the MVDR shape (32 windows, 257 bins,
186 frames, 4 masks, 7 mics), and phase 3 a small MC Conformer CSS on the
card against the CPU (masks in f32 and bf16, one short engine pass with
the kernel against the CPU's plain path).

The line before the last is {"kernels": [...]}, all eleven kernels, with
each kernel's launches summed over phases 4-11 and split by phase in
"launches_by_path" (phase 6b as "diarization_time", phase 9 as "tools",
phase 10 as "train", where every count is 0, phase 11 as "validate");
the last line is {"ok": true,
"device": {...}}. The run writes under chiprun_out/: the kernels' ptxas
report (kernel_build.log), its whole log (chip_smoke.log), the attn_step
traffic of phases 4, 5 and 8 (attn_step_traffic.json, which
notsofar_tpu_torch/tools/time_attn_step.py times), phase 11's Whisper
trace (validate_trace/*.json.gz) and, while it
runs, the sessions' wavs, ASR and diarization pickles and separated
streams (deleted at the end).
"""
import contextlib
import gc
import io
import json
import math
import re
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from notsofar_tpu_torch.tools.common import bound_ms as card_bound_ms
from notsofar_tpu_torch.tools.common import (card_line, time_cuda,
                                             time_cuda_graph)
from notsofar_tpu_torch.tools.time_train_step import (recipe_config,
                                                      write_train_data)
from notsofar_tpu_torch.utils.flops import (H100_HBM_BYTES_PER_S,
                                            H100_PEAK_BF16, H100_PEAK_F32)

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

# H100 SXM published peaks (NVIDIA data sheet, dense; utils/flops.py)
PEAK_BYTES_PER_S = H100_HBM_BYTES_PER_S
PEAK_BF16_FLOPS = H100_PEAK_BF16
PEAK_F32_FLOPS = H100_PEAK_F32   # f32 FMA outside the tensor cores

KERNEL_ITERS = 50                # timed calls per kernel in phase 2


def log(msg: str) -> None:
    """Print a line, and keep it in chiprun_out/chip_smoke.log (a run on a
    remote machine may hand back only the end of its output)."""
    print(msg, flush=True)
    if OUT.is_dir():
        with open(OUT / "chip_smoke.log", "a") as f:
            f.write(msg + "\n")


def as_real(x: torch.Tensor) -> torch.Tensor:
    """f32 for real tensors; complex ones stay complex (abs is modulus)."""
    return x if x.is_complex() else x.float()


def xattn_tolerance(q_eff, k8, vs, dk: int, s_valid: int,
                    flip: float = 2.0 ** -7) -> float:
    """Each xattn_int8 output is vs * sum_s p_s v_s with |v_s| <= 127 and
    sum p = 1. Summed in other f32 orders, two versions differ (a) by at
    most s_valid f32 roundings of that sum and (b), where a logit's
    summation order sends its weight to the other bf16 neighbour, by one
    bf16 ulp (<= 2**-7 p) of that weight times 127; (b) is allowed once,
    at the largest weight (tests/test_torch_kernels.py's tolerance). Where
    each product v * p is rounded to bf16 (xattn_onedot), a flip also moves
    the two roundings of its product (each <= 2**-8 of 127 p): flip 2**-6."""
    B, T, D = q_eff.shape
    H = D // dk
    lg = torch.einsum("bthd,bshd->bhts",
                      q_eff.double().reshape(B, T, H, dk),
                      k8[:, :s_valid].double().reshape(B, s_valid, H, dk))
    p_max = torch.softmax(lg, dim=-1).max().item()
    return 127 * vs.max().item() * (flip * p_max + s_valid * 2.0 ** -24)


XATTN_FLIP_SHARE = 5e-3


def xattn_rms_tolerance(q_eff, k8, v8, vs, dk: int, s_valid: int) -> float:
    """The RMS error over all outputs that two correct versions may show:
    bf16 roundings of the weights sent to the other neighbour at a share
    XATTN_FLIP_SHARE of all weights, each moving an output by ulp(p) v vs
    (a weight flips with odds of about its relative change over 2**-8, so
    the share stands for relative changes of p near 2e-5, far above what
    the f32 summation orders give); plus sqrt(s_valid) f32 roundings of
    the weighted value sum. Moving the rounding point of p changes every
    weight by a fraction of an ulp, like flips at a share of 1/12 or more,
    so it lands 2-4x above this (xattn_rounding_mutant; the same
    tolerance as tests/test_torch_kernels.py's)."""
    B, T, D = q_eff.shape
    H = D // dk
    lg = torch.einsum("bthd,bshd->bhts",
                      q_eff.double().reshape(B, T, H, dk),
                      k8[:, :s_valid].double().reshape(B, s_valid, H, dk))
    p = torch.softmax(lg, dim=-1)
    ulp = torch.ldexp(torch.ones_like(p), torch.frexp(p)[1] - 8)
    v = v8[:, :s_valid].double().reshape(B, s_valid, H, dk)
    w = vs.double().reshape(B, 1, H, dk)
    flips = torch.einsum("bhts,bshd->bthd", ulp ** 2, v ** 2) * w ** 2
    mag = torch.einsum("bhts,bshd->bthd", p, v.abs()) * w.abs()
    return (math.sqrt(XATTN_FLIP_SHARE * flips.mean().item())
            + math.sqrt(s_valid) * 2.0 ** -24
            * mag.pow(2).mean().sqrt().item())


def xattn_rounding_mutant(q_eff, k8, v8, vs, dk: int, s_valid: int,
                          mode: str):
    """The plain xattn_int8 with the bf16 rounding of p moved:
    'unnormalized' rounds exp(l - max) before dividing by the sum (an
    online softmax's rounding point), 'none' never rounds."""
    B, T, D = q_eff.shape
    S = k8.shape[1]
    H = D // dk
    lg = torch.einsum("bthd,bshd->bhts", q_eff.float().reshape(B, T, H, dk),
                      k8.float().reshape(B, S, H, dk))
    lg = lg.masked_fill(torch.arange(S, device=q_eff.device) >= s_valid,
                        -1e30)
    e = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    if mode == "unnormalized":
        e = e.to(torch.bfloat16).float()
    p = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhts,bshd->bthd", p, v8.float().reshape(B, S, H, dk))
    return out.reshape(B, T, D) * vs[:, None, :]


def onedot_lane_weights(q, k8, dk: int, s_valid: int) -> torch.Tensor:
    """xattn_onedot's float64 weights of each lane, [B, s_valid, D]: the
    softmax of head d % H's logits for lane d (the tool's pltpu.repeat
    tiles the [S, H] weights along the lanes)."""
    B, _, D = q.shape
    H = D // dk
    lg = torch.einsum("bhd,bshd->bhs", q.double().reshape(B, H, dk),
                      k8[:, :s_valid].double().reshape(B, s_valid, H, dk))
    p = torch.softmax(lg, dim=-1)
    return p[:, torch.arange(D, device=q.device) % H].transpose(1, 2)


def onedot_rms_tolerance(q, k8, v8, vs, dk: int, s_valid: int) -> float:
    """xattn_rms_tolerance's model for xattn_onedot, whose lane d takes
    head d % H's weights: bf16 flips of the weights at a share
    XATTN_FLIP_SHARE, each moving its rounded product by about ulp(p) v vs,
    plus sqrt(s_valid) f32 roundings of the sum. Leaving the products
    unrounded moves every product by up to half its bf16 ulp, like flips
    at a share of 1/12 (onedot_rounding_mutant; the same tolerance as
    tests/test_torch_kernels.py's)."""
    pe = onedot_lane_weights(q, k8, dk, s_valid)
    ulp = torch.ldexp(torch.ones_like(pe), torch.frexp(pe)[1] - 8)
    v = v8[:, :s_valid].double()
    w = vs.double()
    flips = (ulp ** 2 * v ** 2).sum(1) * w ** 2
    mag = (pe * v.abs()).sum(1) * w.abs()
    return (math.sqrt(XATTN_FLIP_SHARE * flips.mean().item())
            + math.sqrt(s_valid) * 2.0 ** -24
            * mag.pow(2).mean().sqrt().item())


def onedot_rounding_mutant(q, k8, v8, vs, dk: int, s_valid: int):
    """The plain xattn_onedot with the products v * p left unrounded."""
    B, _, D = q.shape
    S = k8.shape[1]
    H = D // dk
    lg = torch.einsum("bhd,bshd->bhs", q.float().reshape(B, H, dk),
                      k8.float().reshape(B, S, H, dk))
    lg = lg.masked_fill(torch.arange(S, device=q.device) >= s_valid, -1e30)
    p = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)).to(torch.bfloat16).float()
    lane_p = p[:, torch.arange(D, device=q.device) % H].transpose(1, 2)
    return (v8.float() * lane_p).sum(dim=1, keepdim=True) * vs[:, None, :]


def flip_tolerance(q, keys, vals, bias, dk: int) -> float:
    """The bf16 weight-flip model of the attention kernels that round each
    normalized weight p to bf16 (attn_step, attn_step_split,
    attn_step_split_bias): each output is sum_c p_c v_c (f32) with q [B,
    K, D], keys and values [B, ncol, D], bias [B, K, ncol] (0 or -1e30).
    Two versions that sum the logits and p.v in other f32 orders differ by
    at most ncol f32 roundings of sum_c p_c |v_c|, and, where a logit's
    order sends its weight to the other bf16 neighbour, by one bf16 ulp
    (<= 2**-7 p) of that weight times |v|; allowed once, at the largest
    weight and value (tests/test_torch_kernels.py's tolerance)."""
    B, K, D = q.shape
    H = D // dk
    ncol = keys.shape[1]
    lg = torch.einsum("bjhd,bchd->bhjc", q.double().reshape(B, K, H, dk),
                      keys.double().reshape(B, ncol, H, dk))
    p = torch.softmax(lg + bias.double()[:, None], dim=-1)
    mag = torch.einsum("bhjc,bchd->bjhd", p,
                       vals.double().abs().reshape(B, ncol, H, dk))
    return (2.0 ** -7 * p.max().item() * vals.abs().max().item()
            + ncol * 2.0 ** -24 * mag.max().item())


def ref64(q, keys, vals, bias, dk: int) -> torch.Tensor:
    """The same attention in float64 with the kernels' one rounding point:
    f64 logits plus bias, f64 softmax, each weight rounded to the values'
    dtype, f64 p.v. q [B, K, D], keys and values [B, ncol, D], bias [B, K,
    ncol] -> [B, K, D]: a witness independent of the f32 orders of both the
    kernel and its plain version."""
    B, K, D = q.shape
    H = D // dk
    ncol = keys.shape[1]
    lg = torch.einsum("bjhd,bchd->bhjc", q.double().reshape(B, K, H, dk),
                      keys.double().reshape(B, ncol, H, dk))
    p = torch.softmax(lg + bias.double()[:, None], dim=-1)
    p = p.to(vals.dtype).double()
    return torch.einsum("bhjc,bchd->bjhd", p, vals.double().reshape(
        B, ncol, H, dk)).reshape(B, K, D)


# seeds of the sweep that holds the two rounding-point kernels of the decode
# steps (attn_step, attn_step_split) to the float64 witness
SWEEP_SEEDS = range(8)


def seed_sweep(name: str, draw, seeds) -> None:
    """Hold a kernel and its plain version, on inputs drawn from each seed,
    to each other and to the float64 witness (ref64), within the weight-flip
    model (flip_tolerance) of those inputs; log each seed's distances.
    draw(seed) -> (kernel output, plain output, q, keys, values, bias, dk,
    what the seed drew), the outputs [B, K, D]."""
    worst = 0.0
    for seed in seeds:
        out, plain, q, keys, vals, bias, dk, what = draw(seed)
        ref = ref64(q, keys, vals, bias, dk)
        tol = flip_tolerance(q, keys, vals, bias, dk)
        torch.cuda.synchronize()
        kp = (out.double() - plain.double()).abs().max().item()
        kr = (out.double() - ref).abs().max().item()
        pr = (plain.double() - ref).abs().max().item()
        log(f"kernel {name} seed {seed} ({what}): kernel - plain {kp:.3e}, "
            f"kernel - float64 {kr:.3e}, plain - float64 {pr:.3e} "
            f"(flip model {tol:.3e})")
        if not (math.isfinite(kp) and kp <= tol and kr <= tol):
            raise AssertionError(f"{name} seed {seed}: kernel - plain {kp}, "
                                 f"kernel - float64 {kr}, model {tol}")
        worst = max(worst, kp / tol)
    log(f"kernel {name}: {len(seeds)} seeds within the flip model, the "
        f"largest kernel - plain at {worst:.3f} of it")


def split_flip_tolerance(qe, kp, vp, kg, vg, gslot: int, pads, dk: int,
                         beams: int, anc) -> float:
    """flip_tolerance of attn_step_split's inputs: each stream's keys as
    [prompt | the beams' generated segments] under the wrapper's bias."""
    from notsofar_tpu_torch.ops import kernels as K
    Bs, Pp, D = kp.shape
    G = kg.shape[1]
    keys, vals = (torch.cat([p_, g_.view(Bs, beams * G, D)], 1)
                  for p_, g_ in ((kp, kg), (vp, vg)))
    bias = K.split_visibility_bias(Bs, beams, Pp, G, gslot, pads, anc)
    return flip_tolerance(qe.view(Bs, beams, D), keys, vals, bias, dk)


def attn_step_draw(seed: int):
    """seed_sweep's draw for attn_step at the gated shape (12 rows, ctx 448,
    20 heads of 64, bf16): seeded caches, pads in [0, 64) and pos, the
    kernel reading pos as a device tensor."""
    from notsofar_tpu_torch.ops import kernels as K
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, ctx, D, dk = 12, 448, 1280, 64
    qe, kc, vc = (torch.randn(shape, generator=g, device="cuda")
                  .to(torch.bfloat16) for shape in
                  ((B, 1, D), (B, ctx, D), (B, ctx, D)))
    qe = (qe.float() * dk ** -0.5).to(torch.bfloat16)
    pads = torch.randint(0, 64, (B,), generator=g, device="cuda",
                         dtype=torch.int32)
    pos = int(torch.randint(0, ctx, (), generator=g, device="cuda"))
    keys = torch.arange(ctx, device="cuda")
    vis = (keys[None] <= pos) & ((keys[None] >= pads[:, None])
                                 | (keys[None] == pos))
    bias = torch.where(vis, 0.0, K.MASKED)[:, None]
    out = K.attn_step(qe, kc, vc, torch.tensor(pos, dtype=torch.int32,
                                               device="cuda"), pads, dk)
    return (out, K.attn_step_plain(qe, kc, vc, pos, pads, dk), qe, kc, vc,
            bias, dk, f"pos {pos}")


def attn_step_split_draw(seed: int):
    """seed_sweep's draw for attn_step_split at the row's shape (2 streams
    x 5 beams, Pp 256, G 256, bf16): seeded caches, pads in [0, 128),
    ancestry and gslot, the kernel reading gslot as a device tensor."""
    from notsofar_tpu_torch.ops import kernels as K
    g = torch.Generator(device="cuda").manual_seed(seed)
    Bs, Kb, Pp, G, D, dk = 2, 5, 256, 256, 1280, 64
    qe, kp, vp, kg, vg = (torch.randn(shape, generator=g, device="cuda")
                          .to(torch.bfloat16) for shape in
                          ((Bs * Kb, 1, D), (Bs, Pp, D), (Bs, Pp, D),
                           (Bs * Kb, G, D), (Bs * Kb, G, D)))
    qe = (qe.float() * dk ** -0.5).to(torch.bfloat16)
    pads = torch.randint(0, 128, (Bs,), generator=g, device="cuda",
                         dtype=torch.int32)
    anc = torch.randint(0, Kb, (Bs, Kb, G), generator=g, device="cuda",
                        dtype=torch.int32)
    gslot = int(torch.randint(0, G, (), generator=g, device="cuda"))
    anc[:, :, gslot] = torch.arange(Kb, device="cuda", dtype=torch.int32)
    out = K.attn_step_split(qe, kp, vp, kg, vg,
                            torch.tensor(gslot, dtype=torch.int32,
                                         device="cuda"), pads, dk, Kb,
                            anc=anc)
    plain = K.attn_step_split_plain(qe, kp, vp, kg, vg, gslot, pads, dk, Kb,
                                    anc=anc)
    keys, vals = (torch.cat([p_, g_.view(Bs, Kb * G, D)], 1)
                  for p_, g_ in ((kp, kg), (vp, vg)))
    bias = K.split_visibility_bias(Bs, Kb, Pp, G, gslot, pads, anc)
    return (out.view(Bs, Kb, D), plain.view(Bs, Kb, D), qe.view(Bs, Kb, D),
            keys, vals, bias, dk, f"gslot {gslot}")


def step_tolerance(q, k, v, dk: int) -> float:
    """xattn_step against its plain version: both round dtype(q s) and
    dtype(k s) (s = dk**-0.25 in f32), the weights and the output, and sum
    in other f32 orders. A logit moves by up to dk f32 roundings of sum_d
    |q s| |k s| (delta) and so a weight by a factor exp(2 delta); one
    weight's bf16 rounding may go the other way (2**-7 p_max |v|_max); S
    f32 roundings of sum_s p |v|; the output's bf16 rounding (one ulp,
    <= 2**-7 of sum_s p |v|). The largest over the outputs
    (tests/test_torch_kernels.py holds each output to its own)."""
    B, T, D = q.shape
    S, H = k.shape[1], D // dk
    sc = dk ** -0.25
    qs, ks = ((x.float() * sc).to(x.dtype).double().reshape(B, -1, H, dk)
              for x in (q, k))
    lg = torch.einsum("bthd,bshd->bhts", qs, ks)
    delta = dk * 2.0 ** -24 * torch.einsum("bthd,bshd->bhts", qs.abs(),
                                           ks.abs()).amax(-1)
    p = torch.softmax(lg, dim=-1)
    va = v.double().abs().reshape(B, S, H, dk)
    mag = torch.einsum("bhts,bshd->bthd", p, va)
    move = torch.expm1(2 * delta).permute(0, 2, 1)[..., None] * mag
    flip = 2.0 ** -7 * p.max().item() * va.max().item()
    return (move + flip + (S * 2.0 ** -24 + 2.0 ** -7) * mag).max().item()


def gemv_tolerance_map(xr, w, dtype, scale, bias, logits: bool,
                       post=None) -> torch.Tensor:
    """decode_gemv against its plain version per output, both from x
    rounded to the compute dtype (xr, [M, K]): the f32 sums of K exact
    products differ by up to 2K roundings of sum_k |x w| (delta); each
    later rounding to bf16 may go the other way (<= 2**-7 of its value),
    carried through the scale and bias (QuantDense's three rounding
    points) and post's s p and its rounding."""
    xr = xr.double().reshape(-1, xr.shape[-1])
    wf = w.double()
    acc = xr @ wf.T
    delta = 2 * xr.shape[-1] * 2.0 ** -24 * (xr.abs() @ wf.abs().T)
    s = torch.ones_like(acc[0]) if scale is None else scale.double()
    if logits:
        return delta * s.abs() + 2.0 ** -23 * (acc * s).abs()
    if dtype == torch.float32:
        b = 0 if bias is None else bias.double().abs()
        return delta * s.abs() + 2.0 ** -22 * ((acc * s).abs() + b)
    e = 2.0 ** -7
    d2 = (delta + e * acc.abs()) * s.abs() + e * (acc * s).abs()
    b = 0 if bias is None else bias.double()
    tol = d2 + e * ((acc * s + b).abs() + d2)
    if post is not None:
        ps = post[0] * post[1].double().repeat_interleave(post[2], dim=0)
        tol = tol * ps.abs() + e * ((acc * s + b).abs() + tol) * ps.abs()
    return tol


def gemv_tolerance(x, w, dtype, scale, bias, logits: bool) -> float:
    """The largest of gemv_tolerance_map over the outputs, x rounded to
    the compute dtype first (tests/test_torch_kernels.py holds each output
    to its own)."""
    return gemv_tolerance_map(x.to(dtype).reshape(-1, x.shape[-1]), w,
                              dtype, scale, bias, logits).max().item()


LN_FLIPS = 4        # bf16 flips of x a row may take from the layer norm
DIFF_SHARE = 2.0 ** -4  # outputs a fused mode may have off its plain version


def fused_tolerance_map(tol, xr, w, dtype, scale, ref, ln: bool,
                        gelu: bool, residual, post=None) -> torch.Tensor:
    """gemv_tolerance_map widened by the fused modes' added rounding
    points. The layer norm: the kernel's f32 statistics (per-share (mean,
    M2) combined in rank order) and F.layer_norm's (Welford) differ in
    order, so a normalized x moves by a few f32 ulps and its bf16 rounding
    may go the other way: at most LN_FLIPS elements a row, each by one bf16
    ulp, at most 2**-7 |x_k|, so 2**-7 |x_k| |w_nk| |s_n| on an output
    (bounded by the row's and channel's maxima), carried
    through the later roundings and post's s p; in f32 compute 8 f32 ulps
    of sum_k |x_k w_nk|. GELU (slope < 1.13) adds one rounding of the
    output; the residual add one rounding of the sum (a bf16 ulp, or an f32
    ulp for the f32 stream)."""
    e = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -23
    xr = xr.double().reshape(-1, xr.shape[-1])
    s = torch.ones_like(tol[0]) if scale is None else scale.double().abs()
    if ln and dtype == torch.bfloat16:
        flip = LN_FLIPS * 2.0 ** -7 * xr.abs().amax(-1, keepdim=True) * \
            w.double().abs().amax(-1)[None, :] * s
        if post is not None:
            flip = flip * post[0] * post[1].double().repeat_interleave(
                post[2], dim=0).abs()
        tol = tol + flip * (1 + 4 * e)
    elif ln:
        tol = tol + 8 * 2.0 ** -24 * (xr.abs() @ w.double().abs().T) * s
    ref = ref.double().reshape(tol.shape)
    if gelu:
        tol = 1.13 * tol + e * (ref.abs() + 1.13 * tol)
    if residual is not None:
        er = 2.0 ** -7 if residual.dtype == torch.bfloat16 else 2.0 ** -24
        tol = tol + er * (ref.abs() + tol)
    return tol


def differing(a: torch.Tensor, b: torch.Tensor) -> float:
    """The share of elements where a and b differ at all."""
    return (a.float() != b.float()).double().mean().item()


def fused_cases(M: int, g: torch.Generator, dev="cuda") -> list:
    """The fused decode step's decode_gemv modes at large-v3 width (D 1280)
    and M rows, as ModelDimensions large-v3's int8 and bf16 decoders run
    them (ResidualBlock.decode_step): seeded weights (int8 with f32 scales,
    or bf16 without), bf16 biases and layer-norm parameters, the int8
    decoder's f32 residual stream or the bf16 decoder's bf16 one (a mean
    of 0.5, scale 2). Each case: name; kern() -> the output the gates read
    (for q/k/v: q_eff and the k and v cache rows at the slot, [M, 3D]);
    plain(), its plain version; mutant(), the plain version with the
    weight of row 0's largest |x| in its largest output changed; moved(),
    the plain version with one rounding point moved (the share gate must
    reject it); tol_maps, fused_tolerance_map per segment, and tol, their
    largest value; library(), torch.matmul on the widened weights; nbytes,
    flops."""
    import torch.nn.functional as F
    from notsofar_tpu_torch.ops import kernels as K
    bf, f32, D = torch.bfloat16, torch.float32, 1280

    def rn(*shape, s=1.0, dt=f32):
        return (torch.randn(shape, generator=g, device=dev) * s).to(dt)

    def w8(n, k):
        return torch.randint(-127, 128, (n, k), generator=g, device=dev,
                             dtype=torch.int8)

    def sc(n):
        return (torch.rand(n, generator=g, device=dev) + 0.1) * 1e-3

    def dense(kind, n, k, bias=True):
        if kind == "int8":
            return w8(n, k), sc(n), rn(n, s=0.1, dt=bf) if bias else None
        return rn(n, k, s=k ** -0.5, dt=bf), None, \
            rn(n, s=0.1, dt=bf) if bias else None

    def flip_w(w, xr, ref=None):
        """w with the weight of row 0's largest |x| in its largest output
        changed (int8 to the other extreme, bf16 by 1); given the plain
        output `ref`, its largest positive output of row 0 (where GELU's
        slope is ~1)."""
        n = int((xr[0].abs().float() @ w.float().abs().T).argmax()) \
            if ref is None else int(ref.reshape(-1, w.shape[0])[0].float()
                                    .argmax())
        kk = int(xr[0].abs().argmax())
        m = w.clone()
        m[n, kk] = (-127 if w[n, kk] >= 0 else 127) \
            if w.dtype == torch.int8 else w[n, kk] - (
                1.0 if w[n, kk] >= 0 else -1.0)
        return m

    def ln_bf16_arith(x, ln):
        """The layer norm in bf16 arithmetic: x, its mean, the centred
        values, the variance, the normalized values and the affine each
        rounded to bf16 (the kernel's f32 rounding points moved to bf16)."""
        xb = x.to(bf)
        d = xb - xb.mean(-1, keepdim=True)
        var = (d * d).mean(-1, keepdim=True)
        xh = d * torch.rsqrt(var + ln.eps)
        return xh * ln.weight.to(bf) + ln.bias.to(bf)

    cases = []
    for kind in ("int8", "bf16"):
        pdt = bf                          # both decoders' norm parameters
        ln = K.GemvLN((1 + rn(D, s=0.1)).to(pdt), rn(D, s=0.1, dt=pdt),
                      1e-5)
        stream = rn(M, 1, D, s=2) + 0.5
        if kind == "bf16":
            stream = stream.to(bf)
        xln = K.layer_norm_plain(stream, ln).to(bf).reshape(M, D)

        # q/k/v: one launch, k and v into the caches at the slot
        layers = [dense(kind, D, D, bias=i != 1) for i in range(3)]
        ctx, pos = 256, 200
        kc, vc = rn(M, ctx, D, dt=bf), rn(M, ctx, D, dt=bf)
        slot = torch.tensor(pos, dtype=torch.int32, device=dev)
        sq = 64 ** -0.5

        def qkv_out(fn, lys=layers):
            k1, v1 = kc.clone(), vc.clone()
            q = fn(stream, ln, lys, bf, k1, v1, slot, sq)
            return torch.cat([q.reshape(M, D), k1[:, pos], v1[:, pos]], -1)

        def qkv_moved(x=stream, ln=ln):
            # the layer norm's affine in bf16 arithmetic
            def fn(x_, ln_, *a):
                return K.decode_qkv_plain(ln_bf16_arith(x_, ln_), None, *a)
            return qkv_out(fn)

        kcat = torch.cat([w for w, _, _ in layers]).to(bf)
        tols = [fused_tolerance_map(
            gemv_tolerance_map(xln, w, bf, s_, b, False), xln, w, bf, s_,
            torch.zeros(M, D, device=dev), True, False, None)
            for w, s_, b in layers]
        tols[0] = tols[0] * sq
        wb = sum(w.numel() * w.element_size() for w, _, _ in layers)
        kt, vt = kc.clone(), vc.clone()
        cases.append(dict(
            name=f"qkv {kind}", kern=lambda f=qkv_out: f(K.decode_qkv),
            time=lambda ly=layers, x=stream, ln=ln, kt=kt, vt=vt:
            K.decode_qkv(x, ln, ly, bf, kt, vt, slot, sq),
            sweep=(stream, ln, layers, kt, vt, slot, sq),
            plain=lambda f=qkv_out: f(K.decode_qkv_plain),
            mutant=lambda f=qkv_out, ly=layers: f(
                K.decode_qkv_plain,
                [ly[0], (flip_w(ly[1][0], xln),) + ly[1][1:], ly[2]]),
            moved=qkv_moved, tol=None, tol_maps=tols,
            library=lambda x=xln.to(bf), w=kcat: torch.matmul(x, w.T),
            nbytes=stream.numel() * stream.element_size() + wb + 3 * D * 6
            + 2 * D * 2 + 3 * M * D * 2, flops=2 * M * 3 * D * D))

        # the layer norm before a dense layer (the cross-attention's
        # query; int8: with post, the int8 memory's query folding at
        # M / 3 rows a window), fc1 with GELU, fc2 and the out projection
        # with the residual add
        w, s_, b = dense(kind, D, D)
        post = (64 ** -0.25, (torch.rand(3, D, generator=g, device=dev)
                              + 0.1) * 1e-2, M // 3) \
            if kind == "int8" and M % 3 == 0 else None
        cases.append(dict(
            name=f"ln+query {kind}", x=stream, w=w, s=s_, b=b,
            kw=dict(ln=ln, post=post), xr=xln,
            moved=lambda w=w, s_=s_, b=b, post=post, ln=ln, x=stream:
            K.decode_gemv_plain(ln_bf16_arith(x, ln), w, bf, s_, b,
                                post=post)))
        w1, s1, b1 = dense(kind, 4 * D, D)
        cases.append(dict(
            name=f"ln+fc1+gelu {kind}", x=stream, w=w1, s=s1, b=b1,
            kw=dict(ln=ln, gelu=True), xr=xln,
            moved=lambda w=w1, s_=s1, b=b1, x=stream, ln=ln:
            K.decode_gemv_plain(ln_bf16_arith(x, ln), w, bf, s_, b,
                                gelu=True)))
        xg = rn(M, 1, D, dt=bf)

        def gelu_moved(x=xg, w=w1, s_=s1, b=b1):
            # the bias's rounding dropped before GELU
            y = (x.float() @ w.float().T).to(bf)
            if s_ is not None:
                y = y * s_.to(bf)
            return F.gelu(y.float() + b.float()).to(bf)
        cases.append(dict(name=f"fc1+gelu {kind}", x=xg, w=w1, s=s1, b=b1,
                          kw=dict(gelu=True), xr=xg.reshape(M, D),
                          moved=gelu_moved))
        h = rn(M, 1, 4 * D, dt=bf)
        w2, s2, b2 = dense(kind, D, 4 * D)
        res = stream

        def res_moved(x=h, w=w2, s_=s2, b=b2, r=res):
            if r.dtype == torch.float32:
                # y's rounding dropped: the unrounded f32 y added
                acc = x.float() @ w.float().T
                y = acc.to(bf)
                if s_ is not None:
                    y = y * s_.to(bf)
                return r + (y.float() + b.float())
            # the bias added after the residual sum
            y = K.decode_gemv_plain(x, w, bf, s_, None)
            return (r + y) + b.to(bf)
        cases.append(dict(name=f"fc2+residual {kind}", x=h, w=w2, s=s2,
                          b=b2, kw=dict(residual=res),
                          xr=h.reshape(M, 4 * D), moved=res_moved))
        if kind == "bf16":
            # a bf16 dense layer alone: flax nn.Dense's two rounding
            # points; addmm's single rounding moved
            x = rn(M, 1, D, dt=bf)
            cases.append(dict(
                name="dense bf16", x=x, w=w, s=None, b=b, kw={},
                xr=x.reshape(M, D),
                moved=lambda x=x, w=w, b=b: F.linear(x, w, b)))
    for c in cases:
        if "kern" in c:
            continue
        x, w, s_, b, kw = c["x"], c["w"], c["s"], c["b"], c["kw"]
        c["kern"] = lambda x=x, w=w, s_=s_, b=b, kw=kw: K.decode_gemv(
            x, w, bf, s_, b, **kw)
        c["plain"] = lambda x=x, w=w, s_=s_, b=b, kw=kw: \
            K.decode_gemv_plain(x, w, bf, s_, b, **kw)
        lg = kw.get("logits", False)
        ref = c["plain"]()
        c["mutant"] = lambda x=x, w=w, s_=s_, b=b, kw=kw, xr=c["xr"], \
            ref=ref if kw.get("gelu") else None: K.decode_gemv_plain(
                x, flip_w(w, xr, ref), bf, s_, b, **kw)
        c["tol_maps"] = [fused_tolerance_map(
            gemv_tolerance_map(c["xr"], w, bf, s_, b, lg, kw.get("post")),
            c["xr"], w, bf, s_, ref, "ln" in kw, kw.get("gelu", False),
            kw.get("residual"), kw.get("post"))]
        r = kw.get("residual")
        x16, w16 = c["xr"].to(bf), w.to(bf)
        c["library"] = lambda x16=x16, w16=w16: torch.matmul(x16, w16.T)
        N, Kd = w.shape
        c["nbytes"] = (x.numel() * x.element_size() + w.numel()
                       * w.element_size() + (0 if s_ is None else N * 4)
                       + (0 if b is None else N * 2)
                       + (2 * Kd * 2 if "ln" in kw else 0)
                       + (0 if r is None else r.numel() * r.element_size())
                       + M * N * (4 if lg or (r is not None and r.dtype
                                              == torch.float32) else 2))
        c["flops"] = 2 * M * N * Kd
    for c in cases:
        c["tol"] = max(t.max().item() for t in c["tol_maps"])
    return cases


def rms(x: torch.Tensor) -> float:
    return x.double().pow(2).mean().sqrt().item()


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    return card_bound_ms(nbytes, flops, peak_flops, PEAK_BYTES_PER_S)


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions at large-v3 shapes
# --------------------------------------------------------------------------

def plan_line(plan: dict) -> str:
    """A split-softmax kernel's launch plan (ops/kernels.py *_launch)."""
    return (f"grid {plan['grid']}, clusters of {plan['cluster']} blocks of "
            f"{plan['threads']} threads, {plan['smem']} bytes of shared "
            f"memory a block, shares of up to {plan['per']}")


def launch_sweep(label: str, launches: dict, out_shape, iters: int,
                 graphed: bool = False,
                 out_dtype: torch.dtype = torch.float32) -> None:
    """Time a kernel through its C function under each launch
    configuration, launches[name](out) -> rc, on the row's inputs, and log
    the times: the measurement behind the plans' choice of cluster size
    (for xattn_int8, R = 1 is the block-per-row design). With graphed,
    also as 32 launches in one CUDA graph, ms per launch (the decode
    step's form: a replay leaves no host time between launches, but each
    launch of a cluster grid has its own cost). A configuration whose
    block passes the shared memory a block may use is logged as such.
    These launches count in no launch counter."""
    times, in_graph = {}, {}
    for name, launch in launches.items():
        out = torch.empty(out_shape, dtype=out_dtype, device="cuda")
        if launch(out) != 0:
            times[name] = "too large"
            continue
        times[name] = round(time_cuda(lambda: launch(out), iters), 4)
        if graphed:
            in_graph[name] = round(time_cuda_graph(
                lambda: [launch(out) for _ in range(32)], iters) / 32, 4)
    log(f"kernel {label}: ms by launch configuration {times}"
        + (f"; as 32 launches in one CUDA graph, ms per launch {in_graph}"
           if graphed else ""))


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
               row=True, rms_tol=None, rms_mutants=None, tol_map=None):
        """Hold `out` to `ref` within `tol`, and `mutant` (the plain
        version on inputs with one key or tap changed) outside it, so the
        tolerance is shown to catch a one-input error; with `tol_map` (a
        tolerance per output, flattened like out), each output within its
        own and the mutant outside its own somewhere; with `rms_tol`,
        hold the RMS of out - ref within it and each of `rms_mutants`
        (name -> plain version with a rounding point moved) outside it;
        then time. With `row`, the result becomes the kernel's row of the
        {"kernels": ...} line (and is returned); without, it is only
        logged."""
        label = label or name
        torch.cuda.synchronize()
        err = (as_real(out) - as_real(ref)).abs().max().item()
        moved = (as_real(out) - as_real(mutant)).abs().max().item()
        if tol_map is not None:
            tm = tol_map.reshape(-1)
            ratio = ((as_real(out) - as_real(ref)).abs().reshape(-1).double()
                     / tm).max().item()
            over = ((as_real(out) - as_real(mutant)).abs().reshape(-1)
                    .double() > tm).sum().item()
            log(f"kernel {label}: largest error over its own tolerance "
                f"{ratio:.3e}; the one-weight mutant outside its own at "
                f"{over} outputs")
            if not (math.isfinite(ratio) and ratio <= 1):
                raise AssertionError(f"{label}: an output is {ratio} times "
                                     "its tolerance")
            if not over:
                raise AssertionError(f"{label}: the one-weight mutant stays "
                                     "within every output's tolerance")
            err_gate, moved_gate = 0.0, 1.0
        else:
            err_gate, moved_gate = err, moved
        if rms_tol is not None:
            err_rms = rms(out - ref)
            moved_rms = {k: rms(out - m) for k, m in rms_mutants.items()}
            log(f"kernel {label}: RMS error {err_rms:.3e} (tolerance "
                f"{rms_tol:.3e}); a rounding moved takes it to "
                + ", ".join(f"{k} {v:.3e}" for k, v in moved_rms.items()))
            if not (math.isfinite(err_rms) and err_rms <= rms_tol):
                raise AssertionError(f"{label}: RMS error {err_rms} > "
                                     f"{rms_tol}")
            for k, v in moved_rms.items():
                if not v > rms_tol:
                    raise AssertionError(f"{label}: rounding {k} moves the "
                                         f"RMS {v}, within {rms_tol}")
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
        if not (math.isfinite(err) and err_gate <= tol):
            raise AssertionError(f"{label}: max_abs_err {err} > {tol}")
        if not moved_gate > tol:
            raise AssertionError(f"{label}: a one-input change moves the "
                                 f"output {moved}, within the tolerance {tol}")
        result = dict(name=name, route="cuda",
                      source=f"notsofar_tpu_torch/csrc/{name}.cu",
                      replaces=replaces, launches=None,
                      launches_by_path=None, max_abs_err=err, ms=ms,
                      plain_ms=plain_ms, bound_ms=b, bound_by=by,
                      library_ms=lib_ms)
        if row:
            rows.append(result)
        return result

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
    log(f"kernel encoder_mha: launch {K.encoder_mha_launch(BH, S, bf)}")

    # attn_step: 12 rows (greedy / fallback dispatch width), ctx 448,
    # D 1280 (20 heads of 64), per-row left pads; pos as a 0-d device
    # tensor (the CUDA graph's form) at the last slot (the kernels line's
    # row) and at 111, a quarter of the cache (logged, its own bound)
    B, ctx, D, H = 12, 448, 1280, 20
    qe = (randn(B, 1, D, dtype=torch.float32) * dk ** -0.5).to(bf)
    kc, vc = randn(B, ctx, D), randn(B, ctx, D)
    pads = torch.randint(0, 64, (B,), generator=g, device="cuda",
                         dtype=torch.int32)
    keys = torch.arange(ctx, device="cuda")
    qs = qe.view(B, 1, H, dk).transpose(1, 2).contiguous()
    ks = kc.view(B, ctx, H, dk).transpose(1, 2).contiguous()
    vs = vc.view(B, ctx, H, dk).transpose(1, 2).contiguous()
    pads_mut = pads.clone()
    pads_mut[0] += 1                    # row 0 loses key pads[0]
    plan = K.attn_step_launch(B, ctx, D, dk, bf)
    lib = K.build.load("attn_step")
    # the same 12 rows for 32 layers, each with its own caches: a decode
    # step's launches as one CUDA graph, timed per launch
    layers = [tuple(randn(B, ctx, D) for _ in range(2)) for _ in range(32)]
    for pos in (ctx - 1, 111):
        pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
        vis = (keys[None] <= pos) & ((keys[None] >= pads[:, None])
                                     | (keys[None] == pos))
        # the output depends on keys pad..pos of each row (pos alone when
        # pad > pos): count those K/V rows, q, pads and the f32 output
        n_keys = int(vis.sum())
        # tolerance: f32 output. The versions sum logits in another order
        # (~1e-7 relative), which sends a few softmax weights p to the
        # other bf16 neighbour; each such weight moves the output by
        # ulp(p)*|v| <= 2**-7 * p * |v|. Measured 3.6e-5 at these inputs
        # (pos 447) on an H100 80GB HBM3 (700 W power limit); the tolerance
        # is about 3x that. It holds for these inputs, not for every draw:
        # on other seeded inputs the plain version's own flip put it 1.4e-4
        # from a float64 witness, so the seed sweep below holds both
        # versions to the flip model itself. |out| is ~0.05 typical;
        # dropping one key moves it by ~1e-2.
        got = record(
            "attn_step", "notsofar_tpu/ops/pallas_kernels.py:224",
            K.attn_step(qe, kc, vc, pos_t, pads, dk),
            K.attn_step_plain(qe, kc, vc, pos, pads, dk), 1e-4,
            K.attn_step_plain(qe, kc, vc, pos, pads_mut, dk),
            lambda: K.attn_step(qe, kc, vc, pos_t, pads, dk),
            lambda: K.attn_step_plain(qe, kc, vc, pos, pads, dk),
            lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=vis[:, None, None, :], scale=1.0),
            nbytes=(2 * n_keys * D + B * D) * 2 + B * 4 + 4 + B * D * 4,
            flops=4 * n_keys * D, label=f"attn_step pos {pos}",
            row=pos == ctx - 1)
        if pos == ctx - 1:
            arow = got
            if not torch.equal(K.attn_step(qe, kc, vc, pos, pads, dk),
                               K.attn_step(qe, kc, vc, pos_t, pads, dk)):
                raise AssertionError("attn_step: pos as a device tensor "
                                     "differs from pos as an int")
            log(f"kernel attn_step: launch {plan_line(plan)} keys; pos as "
                "a device tensor equal to pos as an int")
        else:
            arow.update(pos111_ms=got["ms"], pos111_bound_ms=got["bound_ms"],
                        pos111_plain_ms=got["plain_ms"],
                        pos111_library_ms=got["library_ms"],
                        pos111_max_abs_err=got["max_abs_err"])

        def new_c(R, out, pos_t=pos_t):
            return lib.attn_step(qe.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                                 pads.data_ptr(), pos_t.data_ptr(),
                                 out.data_ptr(), B, ctx, D, dk, 0, R, 1,
                                 K._stream())

        launch_sweep(f"attn_step pos {pos}",
                     {f"R={R}": (lambda out, R=R: new_c(R, out))
                      for R in range(1, 9)}, (B, 1, D), iters)
        graph_ms = time_cuda_graph(
            lambda: [K.attn_step(qe, k_, v_, pos_t, pads, dk)
                     for k_, v_ in layers], iters) / 32
        log(f"kernel attn_step pos {pos}: as 32 launches in one CUDA graph "
            f"{graph_ms:.4f} ms per launch")
        arow["graph_ms" if pos == ctx - 1 else "pos111_graph_ms"] = graph_ms
    del layers
    # what one launch costs under this timer whatever it does, and what
    # the stream kernel takes over the gated shape's bytes (26.4 MB)
    z = torch.empty(1, device="cuda")
    k8, v8 = (torch.randint(-127, 128, (B, 860, D), generator=g,
                            device="cuda", dtype=torch.int8)
              for _ in range(2))
    stream_ms = time_cuda(lambda: K.xattn_stream(k8, v8), iters)
    log(f"kernel attn_step: timer floor (one 1-element zero_) "
        f"{time_cuda(z.zero_, iters):.4f} ms; xattn_stream over "
        f"{2 * k8.numel() / 1e6:.1f} MB {stream_ms:.4f} ms")
    del k8, v8
    seed_sweep("attn_step", attn_step_draw, SWEEP_SEEDS)

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
    # tolerance: the weight-flip model of these inputs (flip_tolerance,
    # as attn_step_split_bias, the same function with a general bias): a
    # weight p sent to its other bf16 neighbour moves the output by up to
    # 2**-7 p |v|. Measured on an H100 80GB HBM3 (700 W power limit):
    # 1.2e-7 at these inputs (f32 order only, no flip), 4.3e-5 on other
    # seeded inputs (one flip); the seed sweep below holds the kernel and
    # the plain version to a float64 witness. A wrong ancestry entry on one
    # slot moves the output by ~1e-2.
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
                                   Kb, anc=anc),
           split_flip_tolerance(qe2, kp, vp, kg, vg, gslot, pads2, dk, Kb,
                                anc),
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
    log("kernel attn_step_split: launch "
        f"{K.attn_step_split_launch(Bs, Kb, Pp, G, D, dk)}")

    # gslot as a 0-d device tensor, read by the kernel: the same kernel
    # on the gated row's inputs, so its output must equal the int path's
    # bit for bit
    slot_t = torch.tensor(gslot, dtype=torch.int32, device="cuda")
    by_int = K.attn_step_split(qe2, kp, vp, kg, vg, gslot, pads2, dk, Kb,
                               anc=anc)
    by_tensor = K.attn_step_split(qe2, kp, vp, kg, vg, slot_t, pads2, dk, Kb,
                                  anc=anc)
    torch.cuda.synchronize()
    if not torch.equal(by_int, by_tensor):
        raise AssertionError("attn_step_split: gslot as a device tensor "
                             "differs from gslot as an int")
    ms_t = time_cuda(lambda: K.attn_step_split(qe2, kp, vp, kg, vg, slot_t,
                                               pads2, dk, Kb, anc=anc),
                     iters)
    log(f"kernel attn_step_split gslot as a device tensor: equal to the int "
        f"path, kernel {ms_t:.4f} ms")
    seed_sweep("attn_step_split", attn_step_split_draw, SWEEP_SEEDS)

    # attn_step_split past the 8 beams of its first design (9 and 16) at
    # Whisper's 448-token context (Pp 224, G 224, the current token at the
    # last slot): the row's gates, logged only
    for Kx, Px, Gx in ((9, 224, 224), (16, 224, 224)):
        gx = Gx - 1
        qx = (randn(Bs * Kx, 1, D, dtype=torch.float32)
              * dk ** -0.5).to(bf)
        kpx, vpx = randn(Bs, Px, D), randn(Bs, Px, D)
        kgx, vgx = randn(Bs * Kx, Gx, D), randn(Bs * Kx, Gx, D)
        padx = torch.randint(0, Px // 2, (Bs,), generator=g, device="cuda",
                             dtype=torch.int32)
        ancx = torch.randint(0, Kx, (Bs, Kx, Gx), generator=g, device="cuda",
                             dtype=torch.int32)
        ancx[:, :, gx] = torch.arange(Kx, device="cuda", dtype=torch.int32)
        ancx_mut = ancx.clone()
        ancx_mut[0, 0, 0] = (ancx[0, 0, 0] + 1) % Kx
        seen = torch.zeros(Bs, Kx, Gx, device="cuda").scatter_(
            1, ancx.long(), 1.0)
        rows_x = int((Px - padx).sum()) + int(seen.sum())
        record("attn_step_split", "notsofar_tpu/ops/pallas_kernels.py:334",
               K.attn_step_split(qx, kpx, vpx, kgx, vgx, gx, padx, dk, Kx,
                                 anc=ancx),
               K.attn_step_split_plain(qx, kpx, vpx, kgx, vgx, gx, padx, dk,
                                       Kx, anc=ancx),
               split_flip_tolerance(qx, kpx, vpx, kgx, vgx, gx, padx, dk,
                                    Kx, ancx),
               K.attn_step_split_plain(qx, kpx, vpx, kgx, vgx, gx, padx, dk,
                                       Kx, anc=ancx_mut),
               lambda: K.attn_step_split(qx, kpx, vpx, kgx, vgx, gx, padx,
                                         dk, Kx, anc=ancx),
               lambda: K.attn_step_split_plain(qx, kpx, vpx, kgx, vgx, gx,
                                               padx, dk, Kx, anc=ancx),
               None,
               nbytes=(2 * rows_x * D + Bs * Kx * D) * 2 + Bs * 4
               + Bs * Kx * Gx * 4 + Bs * Kx * D * 4,
               flops=4 * D * (Kx * int((Px - padx).sum()) + Bs * Kx * Gx),
               label=f"attn_step_split K={Kx} Pp={Px} G={Gx}", row=False)
        log(f"kernel attn_step_split K={Kx}: launch "
            f"{K.attn_step_split_launch(Bs, Kx, Px, Gx, D, dk)}")

    # xattn_int8 at the int8 decoder's serving shapes: the large-v3 cross-
    # attention memory (D 1280, 20 heads of 64, 1500 frames padded to
    # 1504) quantized by quantize_cross_kv from seeded float K/V; beam 5
    # folds its 5 beams into the query axis of 9 streams (48 rows per
    # dispatch), greedy reads 48 rows with one query each. q_eff is made
    # as the model makes it: the k-scales and both dk**-0.25 folded, bf16.
    # The row of the kernels line is the beam-5 shape.
    from notsofar_tpu_torch.models.whisper import WhisperModel
    Sx = 1500
    for label, Bx, Tx in (("xattn_int8", 9, 5), ("xattn_int8 greedy", 48, 1)):
        k8, k_s, v8, v_s, s_valid = WhisperModel.quantize_cross_kv(
            [(randn(Bx, Sx, D, dtype=torch.float32),
              randn(Bx, Sx, D, dtype=torch.float32))])[0]
        qx = randn(Bx, Tx, D, dtype=torch.float32)
        q_eff = ((qx * dk ** -0.25) * (k_s * dk ** -0.25)).to(bf)
        vsx = v_s[:, 0].contiguous()
        tol = xattn_tolerance(q_eff, k8, vsx, dk, s_valid)
        rms_tol = xattn_rms_tolerance(q_eff, k8, v8, vsx, dk, s_valid)
        # the key of the largest logit of row 0, query 0, head 0 negated
        top = int((k8[0, :s_valid, :dk].float() @ q_eff[0, 0, :dk].float())
                  .argmax())
        k_mut = k8.clone()
        k_mut[0, top] = -k8[0, top]
        S_pad = k8.shape[1]
        q_lib = q_eff.view(Bx, Tx, H, dk).transpose(1, 2)
        valid = (torch.arange(S_pad, device="cuda") < s_valid)[None, None,
                                                                None]

        def deq_sdpa():
            kb, vb = (x.to(bf).view(Bx, S_pad, H, dk).transpose(1, 2)
                      for x in (k8, v8))
            o = F.scaled_dot_product_attention(q_lib, kb, vb,
                                               attn_mask=valid, scale=1.0)
            return o.transpose(1, 2).reshape(Bx, Tx, D).float() * vsx[:, None]

        got = record("xattn_int8", "notsofar_tpu/ops/pallas_kernels.py:108",
               K.xattn_int8(q_eff, k8, v8, vsx, dk, s_valid),
               K.xattn_int8_plain(q_eff, k8, v8, vsx, dk, s_valid), tol,
               K.xattn_int8_plain(q_eff, k_mut, v8, vsx, dk, s_valid),
               lambda: K.xattn_int8(q_eff, k8, v8, vsx, dk, s_valid),
               lambda: K.xattn_int8_plain(q_eff, k8, v8, vsx, dk, s_valid),
               None,
               # q, the s_valid int8 keys and values, v-scales, f32 output
               nbytes=Bx * Tx * D * 2 + 2 * Bx * s_valid * D + Bx * D * 4
               + Bx * Tx * D * 4,
               flops=4 * Bx * Tx * s_valid * D, peak_flops=PEAK_F32_FLOPS,
               label=label, row=Tx == 5, rms_tol=rms_tol,
               rms_mutants={m: xattn_rounding_mutant(q_eff, k8, v8, vsx, dk,
                                                     s_valid, m)
                            for m in ("unnormalized", "none")})
        # no PyTorch call reads int8 K/V; for reference, two calls on the
        # bf16 memory: dequantize, then SDPA (and the v-scale multiply)
        ref_err = (deq_sdpa() - K.xattn_int8_plain(q_eff, k8, v8, vsx, dk,
                                                   s_valid)).abs().max()
        ref_ms = time_cuda(deq_sdpa, iters)
        log(f"kernel {label}: dequantize + SDPA (two calls, bf16 memory) "
            f"{ref_ms:.4f} ms, max abs diff from the plain version "
            f"{ref_err.item():.3e}")
        plan = K.xattn_int8_launch(Bx, Tx, S_pad, D, dk, s_valid, bf)
        log(f"kernel {label}: launch {plan_line(plan)} keys")
        def xattn_c(R, out):
            return K.build.load("xattn_int8").xattn_int8(
                q_eff.data_ptr(), k8.data_ptr(), v8.data_ptr(),
                vsx.data_ptr(), out.data_ptr(), Bx, Tx, S_pad, D, dk,
                s_valid, R, 1, K._stream())

        # R = 1: a block streams a whole row; R >= 2: clusters
        launch_sweep(label, {f"R={R}": (lambda out, R=R: xattn_c(R, out))
                             for R in range(1, 9)}, (Bx, Tx, D), iters)
        if Tx == 5:
            xrow = rows[-1]
            xrow["dequant_sdpa_ms"] = ref_ms
        else:
            # the greedy shape beside the beam-5 row (one row per kernel)
            xrow["greedy_ms"] = got["ms"]
            xrow["greedy_bound_ms"] = got["bound_ms"]
            xrow["greedy_plain_ms"] = got["plain_ms"]
            xrow["greedy_dequant_sdpa_ms"] = ref_ms
        del k8, v8, k_mut

    # depthwise_conv1d at the TitaNet-large shapes of the diarization
    # path: 256 windows of the largest bucket (3.072 s -> 320 frames),
    # 1024 channels, bf16 activations, f32 taps, k = 7, 11, 15 (the three
    # mega blocks). The row of the kernels line is k = 15; k = 7 and 11 are
    # checked and timed on the lines before it. Then the time-based path's
    # forwards: diarization.time_based.EMBED_BATCH = 64 windows at its
    # shortest and longest recipe scales (0.5 and 3.0 s -> 51 and 301
    # frames, padded to 64 and 304), checked and timed on lines of their
    # own, their inputs from a generator of their own.
    g_tb = torch.Generator(device="cuda").manual_seed(11)
    Cd = 1024
    for Bd, Td, gd in ((256, 320, g), (64, 64, g_tb), (64, 304, g_tb)):
        xd = torch.randn((Bd, Td, Cd), generator=gd, device="cuda").to(bf)
        for k in (7, 11, 15):
            w = torch.randn((k, Cd), generator=gd, device="cuda") \
                * k ** -0.5
            w_mut = w.clone()
            w_mut[0, 0] += 1.0                 # channel 0's tap 0 changed
            # tolerance: the kernel sums with FMAs, the plain version with
            # a rounded product and a rounded add, both in the order
            # i=0..k-1 from 0; each of the k steps rounds once or twice,
            # so the two differ by at most 2k roundings of the running
            # sum, each at most 2**-24 of sum_i |x w| (largest over the
            # outputs)
            mag = K.depthwise_conv1d_plain(xd.abs(), w.abs(), k).max() \
                .item()
            tol = 2 * k * 2.0 ** -24 * mag
            w_bct = w.t()[:, None, :].to(bf).contiguous()   # [C, 1, k]
            x_bct = xd.transpose(1, 2).contiguous()          # [B, C, T]
            record(
                "depthwise_conv1d", "notsofar_tpu/ops/pallas_kernels.py:435",
                K.depthwise_conv1d(xd, w, k),
                K.depthwise_conv1d_plain(xd, w, k),
                tol, K.depthwise_conv1d_plain(xd, w_mut, k),
                lambda: K.depthwise_conv1d(xd, w, k),
                lambda: K.depthwise_conv1d_plain(xd, w, k),
                lambda: F.conv1d(x_bct, w_bct, padding=(k - 1) // 2,
                                 groups=Cd),
                nbytes=Bd * Td * Cd * 2 + k * Cd * 4 + Bd * Td * Cd * 4,
                flops=2 * k * Bd * Td * Cd, peak_flops=PEAK_F32_FLOPS,
                label=f"depthwise_conv1d {Bd}x{Td} k={k}",
                row=(Bd, Td, k) == (256, 320, 15))

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
    # the ring of 32-frame buffers a warp keeps in flight: 1 is the first
    # design's schedule (stage, then compute); the launches count nowhere
    def scm_c(stages, out):
        return K.build.load("masked_scm").masked_scm(
            wta.data_ptr(), xs.data_ptr(), out.data_ptr(), Bm, Fm, Tm, Km, Mm,
            stages, K._stream())

    launch_sweep("masked_scm", {f"stages={n}": (lambda o, n=n: scm_c(n, o))
                                for n in range(1, 9)},
                 (Bm, Km, Fm, Mm, Mm, 2), iters)
    log(f"kernel masked_scm: launch {K.masked_scm_launch(Bm, Fm, Km, Mm)}")
    check_decode_step_kernels(iters, record, randn)
    check_tool_kernels(iters, record, randn)
    return rows


def check_decode_step_kernels(iters: int, record, randn) -> None:
    """Phase 2 for the decode step's two kernels for work the JAX package
    leaves to XLA fusion, at large-v3's decode shapes, through
    check_kernels' record and seeded randn: xattn_step (3 windows x Tq 1
    and 5, S 1500, D 1280, bf16; the kernels line's row is Tq 1) and
    decode_gemv in its three modes (QuantDense int8 1280 -> 1280, 5120 and
    5120 -> 1280; the int8 and the bf16 logits 1280 -> 51 866) at 3, 15
    and 48 rows (the row: QuantDense 1280 -> 1280 at 3 rows). Each is held
    to its plain version within its error model and rejects the plain
    version with one memory row or one weight changed; library: SDPA on
    the bf16 memory, torch.matmul on pre-widened bf16 weights (calls the
    port never makes). Cluster sizes R = 1-8 are logged (launch_sweep).
    xattn_step and SDPA are also timed as 32 launches in one CUDA graph
    (graph_ms, library_graph_ms in its row), and xattn_step's phases
    apart (tools/time_decode_step.py xattn_step_phases: the kernel built
    with its stamps, on one memory and on 32 layers' memories)."""
    import torch.nn.functional as F
    from notsofar_tpu_torch.ops import kernels as K
    from notsofar_tpu_torch.tools import time_decode_step as tds

    bf = torch.bfloat16
    B, S, D, dk = 3, 1500, 1280, 64
    H = D // dk
    k, v = randn(B, S, D), randn(B, S, D)
    kh, vh = (x.view(B, S, H, dk).transpose(1, 2).contiguous()
              for x in (k, v))
    xrow = None
    for T in (1, 5):
        # queries at twice unit scale: logits of a few units, so that one
        # memory row matters
        q = (randn(B, T, D, dtype=torch.float32) * 2).to(bf)
        qh = q.view(B, T, H, dk).transpose(1, 2).contiguous()
        sc = dk ** -0.25
        top = int((((k[0, :, :dk].float() * sc).to(bf).float())
                   @ (q[0, 0, :dk].float() * sc).to(bf).float()).argmax())
        k_mut, v_mut = k.clone(), v.clone()
        k_mut[0, top], v_mut[0, top] = -k[0, top], -v[0, top]
        got = record(
            "xattn_step", "notsofar_tpu/models/whisper.py:324",
            K.xattn_step(q, k, v, dk), K.xattn_step_plain(q, k, v, dk),
            step_tolerance(q, k, v, dk),
            K.xattn_step_plain(q, k_mut, v_mut, dk),
            lambda: K.xattn_step(q, k, v, dk),
            lambda: K.xattn_step_plain(q, k, v, dk),
            lambda: F.scaled_dot_product_attention(qh, kh, vh),
            nbytes=(2 * B * T * D + 2 * B * S * D) * 2,
            flops=4 * B * T * S * D, label=f"xattn_step Tq {T}",
            row=T == 1)
        plan = K.xattn_step_launch(B, T, S, D, dk, bf)
        log(f"kernel xattn_step Tq {T}: launch {plan_line(plan)} keys")
        got["graph_ms"] = time_cuda_graph(
            lambda: [K.xattn_step(q, k, v, dk) for _ in range(32)],
            iters) / 32
        got["library_graph_ms"] = time_cuda_graph(
            lambda: [F.scaled_dot_product_attention(qh, kh, vh)
                     for _ in range(32)], iters) / 32
        log(f"kernel xattn_step Tq {T}: as 32 launches in one CUDA graph "
            f"{got['graph_ms']:.4f} ms a launch, SDPA the same way "
            f"{got['library_graph_ms']:.4f} ms")

        def step_c(R, out, q=q, T=T):
            return K.build.load("xattn_step").xattn_step(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                T, S, D, dk, sc, R, 1, K._stream())

        launch_sweep(f"xattn_step Tq {T}",
                     {f"R={R}": (lambda out, R=R: step_c(R, out))
                      for R in range(1, 9)}, (B, T, D), iters,
                     graphed=True, out_dtype=bf)
        if T == 1:
            xrow = got
        else:
            xrow.update(beam5_ms=got["ms"], beam5_bound_ms=got["bound_ms"],
                        beam5_plain_ms=got["plain_ms"],
                        beam5_library_ms=got["library_ms"],
                        beam5_max_abs_err=got["max_abs_err"],
                        beam5_graph_ms=got["graph_ms"],
                        beam5_library_graph_ms=got["library_graph_ms"])
    del k, v, kh, vh
    for label, r in tds.xattn_step_phases(ROOT, iters).items():
        log(tds.phases_line(f"kernel xattn_step {label} phases", r))

    g = torch.Generator(device="cuda").manual_seed(99)
    emb8 = torch.randint(-127, 128, (51866, D), generator=g, device="cuda",
                         dtype=torch.int8)
    emb_scale = (torch.rand(51866, generator=g, device="cuda") + 0.5) * 1e-3
    emb16 = (randn(51866, D, dtype=torch.float32) * 0.02).to(bf)
    shapes = {}
    grow = None
    for M in (3, 15, 48):
        cases = []
        for N, Kd in ((1280, 1280), (5120, 1280), (1280, 5120)):
            w = torch.randint(-127, 128, (N, Kd), generator=g, device="cuda",
                              dtype=torch.int8)
            s_ = (torch.rand(N, generator=g, device="cuda") + 0.1) * 1e-3
            b_ = (randn(N, dtype=torch.float32) * 0.1).to(bf)
            x = randn(M, 1, Kd)
            cases.append((f"dense {Kd}->{N}", x, w, bf, s_, b_, False))
        # the int8 logits take the f32 LN output of the int8 decoder
        cases.append(("int8 logits", randn(M, 1, D, dtype=torch.float32),
                      emb8, bf, emb_scale, None, True))
        cases.append(("bf16 logits", randn(M, 1, D), emb16, bf, None, None,
                      True))
        for name, x, w, dt, s_, b_, lg in cases:
            N, Kd = w.shape
            # the weight of row 0's largest |x| in its largest output
            n = int(K.decode_gemv_plain(x[:1], w, dt, s_, b_, logits=lg)
                    .float().abs().argmax())
            kk = int(x[0, 0].to(dt).float().abs().argmax())
            w_mut = w.clone()
            w_mut[n, kk] = (-127 if w[n, kk] >= 0 else 127) \
                if w.dtype == torch.int8 else w[n, kk] - (
                    1.0 if w[n, kk] >= 0 else -1.0)
            w16 = w.to(bf)
            x16 = x.to(bf)
            label = f"decode_gemv {name} {M} rows"
            got = record(
                "decode_gemv", "notsofar_tpu/models/whisper.py:86",
                K.decode_gemv(x, w, dt, s_, b_, logits=lg),
                K.decode_gemv_plain(x, w, dt, s_, b_, logits=lg),
                gemv_tolerance(x, w, dt, s_, b_, lg),
                K.decode_gemv_plain(x, w_mut, dt, s_, b_, logits=lg),
                lambda: K.decode_gemv(x, w, dt, s_, b_, logits=lg),
                lambda: K.decode_gemv_plain(x, w, dt, s_, b_, logits=lg),
                lambda: torch.matmul(x16, w16.T),
                nbytes=(x.numel() * x.element_size() + w.numel()
                        * w.element_size() + (0 if s_ is None else N * 4)
                        + (0 if b_ is None else N * 2)
                        + M * N * (4 if lg else 2)),
                flops=2 * M * N * Kd, label=label,
                row=M == 3 and name == "dense 1280->1280")
            if grow is None:
                grow = got
            shapes[f"{name} {M}"] = {key: got[key] for key in (
                "ms", "bound_ms", "plain_ms", "library_ms", "max_abs_err")}
            gplan = K.decode_gemv_launch(M, N, Kd, w.dtype, 1)
            log(f"kernel {label}: launch grid {gplan['grid']}, clusters of "
                f"{gplan['cluster']} blocks of {gplan['threads']} threads, "
                f"{gplan['tiles']} tiles of 8 rows, {gplan['smem']} bytes of "
                "shared memory a block")
            if name != "bf16 logits":
                def gemv_c(R, out, x=x, w=w, s_=s_, b_=b_, lg=lg, dt=dt,
                           M=M):
                    plan = K.decode_gemv_launch(M, w.shape[0], w.shape[1],
                                                w.dtype, 1, R=R)
                    return K._launch_decode_gemv(
                        x, [K._gemv_seg(w, s_, b_, out, w.shape[0],
                                        logits=lg)], dt, w.dtype, None, plan)
                nck = w.shape[1] // K._gemv_chunk(w.dtype)
                launch_sweep(label, {f"R={R}": (lambda o, R=R: gemv_c(R, o))
                                     for R in range(1, min(8, nck) + 1)},
                             (M, 1, w.shape[0]), iters, graphed=True,
                             out_dtype=torch.float32 if lg else dt)
                log(f"kernel {label}: the library call as 32 launches "
                    "in one CUDA graph, ms per launch "
                    f"{time_cuda_graph(lambda: [torch.matmul(x16, w16.T) for _ in range(32)], iters) / 32:.4f}")
            del w_mut, w16
    grow["shapes"] = shapes
    del emb8, emb16
    grow["fused"] = check_fused_step_modes(iters, record)


def check_fused_step_modes(iters: int, record) -> dict:
    """Phase 2 for decode_gemv's modes of the fused decode step
    (fused_cases, large-v3's int8 and bf16 decoders at 3, 15 and 48
    rows): each output held to its plain version within its own
    fused_tolerance_map value by check_kernels' record (the plain version
    with one weight changed must leave it somewhere), and at most
    DIFF_SHARE of the outputs off the plain version at all, a share that
    the plain version with one rounding point moved must exceed; timed by
    events and as 32 launches in one CUDA graph beside torch.matmul on the
    widened weights (the same two ways). The q/k/v launch's cluster size
    is swept as 32 launches in one graph (launch_sweep). Returns each
    case's numbers by
    "name rows"."""
    from notsofar_tpu_torch.ops import kernels as K
    g = torch.Generator(device="cuda").manual_seed(4242)
    out = {}
    for M in (3, 15, 48):
        for c in fused_cases(M, g):
            label = f"decode_gemv {c['name']} {M} rows"
            y, ref, moved = c["kern"](), c["plain"](), c["moved"]()
            torch.cuda.synchronize()
            # the share of outputs off their plain version: a flipped
            # normalized x or another summation order touches a few, a
            # rounding point moved touches many
            share, mshare = differing(y, ref), differing(moved, ref)
            log(f"kernel {label}: outputs off the plain version {share:.4f} "
                f"(at most {DIFF_SHARE}); with a rounding point moved "
                f"{mshare:.4f}")
            if not share <= DIFF_SHARE:
                raise AssertionError(f"{label}: {share} of the outputs off "
                                     "the plain version")
            if not mshare > DIFF_SHARE:
                raise AssertionError(f"{label}: a rounding point moved "
                                     f"changes only {mshare} of the outputs")
            fn = c.get("time", c["kern"])
            got = record(
                "decode_gemv", "notsofar_tpu/models/whisper.py:86", y, ref,
                c["tol"], c["mutant"](), fn, c["plain"], c["library"],
                nbytes=c["nbytes"], flops=c["flops"], label=label, row=False,
                tol_map=torch.cat(c["tol_maps"], -1))
            graph_ms = time_cuda_graph(lambda: [fn() for _ in range(32)],
                                       iters) / 32
            lib = c["library"]
            lib_graph = time_cuda_graph(lambda: [lib() for _ in range(32)],
                                        iters) / 32
            log(f"kernel {label}: as 32 launches in one CUDA graph "
                f"{graph_ms:.4f} ms a launch, the library call "
                f"{lib_graph:.4f}")
            out[f"{c['name']} {M}"] = dict(
                {k: got[k] for k in ("ms", "bound_ms", "plain_ms",
                                     "library_ms", "max_abs_err")},
                graph_ms=graph_ms, library_graph_ms=lib_graph)
            if "sweep" in c and c["name"] == "qkv int8":
                x, ln, layers, kt, vt, slot, sq = c["sweep"]
                D = x.shape[-1]

                def qkv_c(R, o, x=x, ln=ln, layers=layers, kt=kt,
                          vt=vt, slot=slot, sq=sq, M=M, D=D):
                    plan = K.decode_gemv_launch(M, [D] * 3, D, torch.int8,
                                                1, ln=True, R=R)
                    segs = [K._gemv_seg(*layers[0], o, D, mul=sq)] + [
                        K._gemv_seg(*ly, cache, cache.shape[1] * D,
                                    slot=slot)
                        for ly, cache in zip(layers[1:], (kt, vt))]
                    return K._launch_decode_gemv(x, segs, torch.bfloat16,
                                                 torch.int8, ln, plan)
                launch_sweep(
                    f"decode_gemv qkv int8 {M} rows",
                    {f"R={R}": (lambda o, R=R: qkv_c(R, o))
                     for R in range(1, 9)},
                    (M, 1, D), iters, graphed=True, out_dtype=torch.bfloat16)
    return out


def check_tool_kernels(iters: int, record, randn) -> None:
    """Phase 2 for the kernel-decomposition tools' three kernels, at the
    tools' default shapes (notsofar_tpu_torch/tools), through
    check_kernels' record and seeded randn."""
    import torch.nn.functional as F
    from notsofar_tpu_torch.ops import kernels as K

    g = torch.Generator(device="cuda").manual_seed(4321)
    bf = torch.bfloat16
    dk = 64

    # xattn_stream at bench_xattn_variants' layer: 24 rows of large-v3's
    # int8 cross-attention memory, S 1504, D 1280. Exact: integer sums,
    # one f32 rounding; the checksum must be the sum of every K and V byte
    # of a row, and a byte changed past row 7 must change it
    Bx, Sx, D = 24, 1504, 1280
    k8, v8 = (torch.randint(-127, 128, (Bx, Sx, D), generator=g,
                            device="cuda", dtype=torch.int8)
              for _ in range(2))
    out, checksum = K.xattn_stream(k8, v8)
    ref, _ = K.xattn_stream_plain(k8, v8)
    want = (k8.sum((1, 2), dtype=torch.int32)
            + v8.sum((1, 2), dtype=torch.int32))
    v_late = v8.clone()
    v_late[-1, -1, -1] ^= 1
    moved_sum = K.xattn_stream(k8, v_late)[1]
    log(f"kernel xattn_stream: checksum equal to the byte sums "
        f"{torch.equal(checksum, want)}; one byte of the last row's last "
        f"key changed changes it {bool(moved_sum[-1] != checksum[-1])}")
    if not torch.equal(checksum, want) or moved_sum[-1] == checksum[-1]:
        raise AssertionError("xattn_stream: checksum is not the byte sum")
    k_mut = k8.clone()
    k_mut[0, 0] = -k8[0, 0]              # row 0's first key negated
    del v_late
    stream = record("xattn_stream", "tools/bench_xattn_variants.py:53",
                    out, ref, 0.0, K.xattn_stream_plain(k_mut, v8)[0],
                    lambda: K.xattn_stream(k8, v8),
                    lambda: K.xattn_stream_plain(k8, v8), None,
                    # every K and V byte, the f32 output and the int32
                    # checksum; one integer add per byte
                    nbytes=2 * Bx * Sx * D + Bx * D * 4 + Bx * 4,
                    flops=2 * Bx * Sx * D, peak_flops=PEAK_F32_FLOPS)
    # no PyTorch call computes this function; for reference, a full int8
    # sum of each of K and V reads the same bytes (two calls)
    stream["int8_sum_ms"] = time_cuda(
        lambda: (k8.sum((1, 2), dtype=torch.int32),
                 v8.sum((1, 2), dtype=torch.int32)), iters)
    log(f"kernel xattn_stream: two int8 torch.sum calls (K, V) "
        f"{stream['int8_sum_ms']:.4f} ms")
    del k_mut

    # xattn_onedot at the same shape, s_valid = S as the tool passes it,
    # seeded like the tool's inputs but with q scaled to unit-scale logits
    # (the tool's 0.1 gives one weight ~1 per head, which is 1 in bf16
    # wherever it is rounded, so the product rounding could not show)
    q = (randn(Bx, 1, D, dtype=torch.float32) * 0.004).to(bf)
    vs = torch.rand(Bx, D, generator=g, device="cuda") * 0.01
    s_valid = Sx
    tol = xattn_tolerance(q, k8, vs, dk, s_valid, flip=2.0 ** -6)
    rms_tol = onedot_rms_tolerance(q, k8, v8, vs, dk, s_valid)
    top = int((k8[0, :, :dk].float() @ q[0, 0, :dk].float()).argmax())
    k_mut = k8.clone()
    k_mut[0, top] = -k8[0, top]
    H = D // dk
    q_lib = q.view(Bx, 1, H, dk).transpose(1, 2)

    def deq_sdpa():
        kb, vb = (x.to(bf).view(Bx, Sx, H, dk).transpose(1, 2)
                  for x in (k8, v8))
        o = F.scaled_dot_product_attention(q_lib, kb, vb, scale=1.0)
        return o.transpose(1, 2).reshape(Bx, 1, D).float() * vs[:, None]

    onedot = record(
        "xattn_onedot", "tools/bench_xattn_variants.py:96",
        K.xattn_onedot(q, k8, v8, vs, dk, s_valid),
        K.xattn_onedot_plain(q, k8, v8, vs, dk, s_valid), tol,
        K.xattn_onedot_plain(q, k_mut, v8, vs, dk, s_valid),
        lambda: K.xattn_onedot(q, k8, v8, vs, dk, s_valid),
        lambda: K.xattn_onedot_plain(q, k8, v8, vs, dk, s_valid), None,
        nbytes=Bx * D * 2 + 2 * Bx * s_valid * D + Bx * D * 4 + Bx * D * 4,
        flops=4 * Bx * s_valid * D, peak_flops=PEAK_F32_FLOPS,
        rms_tol=rms_tol,
        rms_mutants={"products unrounded": onedot_rounding_mutant(
            q, k8, v8, vs, dk, s_valid)})
    # no PyTorch call computes this function (its lanes take head d % H's
    # weights); for reference, attention over the same bytes as
    # xattn_int8's row times it: dequantize, then SDPA (two calls)
    onedot["dequant_sdpa_ms"] = time_cuda(deq_sdpa, iters)
    log(f"kernel xattn_onedot: dequantize + SDPA (two calls, bf16 memory) "
        f"{onedot['dequant_sdpa_ms']:.4f} ms")
    plan = K.xattn_onedot_launch(Bx, Sx, D, dk, s_valid)
    log(f"kernel xattn_onedot: launch grid {plan['grid']}, clusters of "
        f"{plan['cluster']} blocks of {plan['threads']} threads, "
        f"{plan['smem']} bytes of shared memory a block")

    def onedot_c(R, out):
        return K.build.load("xattn_onedot").xattn_onedot(
            q.data_ptr(), k8.data_ptr(), v8.data_ptr(), vs.data_ptr(),
            out.data_ptr(), Bx, Sx, D, dk, s_valid, R, K._stream())

    # R = 1: a block per row, the first design's grid
    launch_sweep("xattn_onedot", {f"R={R}": (lambda o, R=R: onedot_c(R, o))
                                  for R in range(1, 9)}, (Bx, 1, D), iters)
    del k8, v8, k_mut

    # attn_step_split_bias at bisect_attn_split's shape: 8 streams x 5
    # beams, Pp 256, G 192, D 1280, bf16 caches; the bias of
    # split_visibility_bias (random pads and ancestry, the newest slot
    # visible to its own beam) plus finite N(0, 2) values on the visible
    # columns, and stream 1's beam 2 masked everywhere (uniform weights)
    def split_bias_case(Bs, Kb, Pp, G):
        qs = (randn(Bs, Kb, D, dtype=torch.float32) * dk ** -0.5).to(bf)
        kp, vp = randn(Bs, Pp, D), randn(Bs, Pp, D)
        kg, vg = randn(Bs, Kb * G, D), randn(Bs, Kb * G, D)
        pads = torch.randint(0, 128, (Bs,), generator=g, device="cuda",
                             dtype=torch.int32)
        anc = torch.randint(0, Kb, (Bs, Kb, G), generator=g, device="cuda",
                            dtype=torch.int32)
        anc[:, :, G - 1] = torch.arange(Kb, device="cuda", dtype=torch.int32)
        bias = K.split_visibility_bias(Bs, Kb, Pp, G, G - 1, pads, anc)
        bias = torch.where(bias == 0, 2.0 * torch.randn(
            bias.shape, generator=g, device="cuda"), bias)
        bias[1, 2] = K.MASKED
        keys = torch.cat([kp, kg], 1)
        lg = keys[0, :, :dk].float() @ qs[0, 0, :dk].float() + bias[0, 0]
        top = int(lg.argmax())
        kp_mut, kg_mut = kp.clone(), kg.clone()
        if top < Pp:
            kp_mut[0, top] = -kp[0, top]
        else:
            kg_mut[0, top - Pp] = -kg[0, top - Pp]
        return qs, kp, vp, kg, vg, bias, kp_mut, kg_mut

    def check_split_bias(Bs, Kb, Pp, G, row):
        qs, kp, vp, kg, vg, bias, kp_mut, kg_mut = split_bias_case(Bs, Kb, Pp,
                                                                   G)
        ncol = Pp + Kb * G
        label = "attn_step_split_bias" + ("" if row else f" K={Kb}")
        vals = torch.cat([vp, vg], 1)
        tol = flip_tolerance(qs, torch.cat([kp, kg], 1), vals, bias, dk)
        out = K.attn_step_split_bias(qs, kp, vp, kg, vg, bias, dk)
        uniform = (torch.tensor(1.0 / ncol).to(bf).float()
                   * vals[1].float().sum(0))
        log(f"kernel {label}: the row masked everywhere is "
            f"{(out[1, 2] - uniform).abs().max().item():.3e} from the uniform "
            f"average of the values; outputs finite "
            f"{bool(out.isfinite().all())}")
        if not out.isfinite().all():
            raise AssertionError(f"{label}: non-finite output")
        # library: SDPA with the bias as an additive mask in the query
        # dtype, the keys pre-concatenated as [prompt | K generated segments]
        q_lib = qs.view(Bs, Kb, H, dk).transpose(1, 2)
        k_lib, v_lib = (x.view(Bs, ncol, H, dk).transpose(1, 2)
                        for x in (torch.cat([kp, kg], 1), vals))
        mask = bias.to(bf)[:, None]
        record("attn_step_split_bias", "tools/bisect_attn_split.py:58",
               out, K.attn_step_split_bias_plain(qs, kp, vp, kg, vg, bias, dk),
               tol, K.attn_step_split_bias_plain(qs, kp_mut, vp, kg_mut, vg,
                                                 bias, dk),
               lambda: K.attn_step_split_bias(qs, kp, vp, kg, vg, bias, dk),
               lambda: K.attn_step_split_bias_plain(qs, kp, vp, kg, vg, bias,
                                                    dk),
               lambda: F.scaled_dot_product_attention(q_lib, k_lib, v_lib,
                                                      attn_mask=mask,
                                                      scale=1.0),
               nbytes=(Bs * Kb * D + 2 * Bs * ncol * D) * 2
               + Bs * Kb * ncol * 4 + Bs * Kb * D * 4,
               flops=4 * Bs * Kb * ncol * D, label=label, row=row)
        plan = K.attn_step_split_bias_launch(Bs, Kb, Pp, Kb * G, D, dk, bf)
        log(f"kernel {label}: launch {plan_line(plan)} columns")
        if row:
            def bias_c(R, o):
                return K.build.load("attn_step_split_bias") \
                    .attn_step_split_bias(
                        qs.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                        kg.data_ptr(), vg.data_ptr(), bias.data_ptr(),
                        o.data_ptr(), Bs, Kb, Pp, Kb * G, D, dk, R, 1,
                        K._stream())
            launch_sweep(label, {f"R={R}": (lambda o, R=R: bias_c(R, o))
                                 for R in range(1, 9)}, (Bs, Kb, D), iters)

    check_split_bias(8, 5, 256, 192, row=True)
    # past the 8 beams of the first CUDA kernel, at Whisper's 448-token
    # context (Pp 224, G 224): the row's gates, logged only
    check_split_bias(2, 9, 224, 224, row=False)


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

    # the int8 decoder: decoder matrices and embedding quantized from the
    # same float weights (f32 compute), int8 cross-attention K/V read by
    # xattn_int8 on the card; every decoder call the decoders count as
    # reaching the kernel launches it once per layer
    from notsofar_tpu_torch.asr import decoding as dec
    from notsofar_tpu_torch.models.whisper import quantize_whisper_decoder
    from notsofar_tpu_torch.ops import kernels
    qsd = quantize_whisper_decoder(sd)
    cpu8 = WhisperModel(dims, device="cpu", quant_decoder=True)
    cpu8.load_state_dict(qsd)
    gpu8 = WhisperModel(dims, device="cuda", quant_decoder=True)
    gpu8.load_state_dict(qsd)
    opts8 = DecodeOptions(max_new_tokens=12, cross_kv_quant=True)
    for name, mk in (
            ("greedy", lambda m: GreedyDecoder(m, tok, opts8)),
            ("beam3", lambda m: BeamDecoder(m, tok, opts8, beam_size=3,
                                            cache_dtype=torch.float32))):
        rc = mk(cpu8).decode_prompted(xa, prompts)
        dec.reset_decoder_calls()
        before = kernels.LAUNCHES["xattn_int8"]
        rg = mk(gpu8).decode_prompted(xa.cuda(), prompts)
        launched = kernels.LAUNCHES["xattn_int8"] - before
        calls = dec.DECODER_CALLS["xattn_int8"]
        dl = float(np.abs(rc["avg_logprob"] - rg["avg_logprob"]).max())
        log(f"reference int8 {name} decode (f32, int8 cross-KV): tokens "
            f"equal {rc['tokens'] == rg['tokens']}, avg_logprob diff "
            f"{dl:.2e} (tolerance 1e-3), xattn_int8 launches {launched} "
            f"for {calls} counted decoder calls x {dims.n_text_layer} "
            "layers")
        if rc["tokens"] != rg["tokens"] or not dl <= 1e-3:
            raise AssertionError(f"int8 {name} decode differs from the CPU")
        if not launched == calls * dims.n_text_layer > 0:
            raise AssertionError(f"int8 {name}: {launched} xattn_int8 "
                                 f"launches for {calls} decoder calls")
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32


def check_graph_decode(max_new: int = 32) -> None:
    """Phase 3b: the decode loops as CUDA graphs against the same loops run
    eagerly (their internal graph=False), at full width: Whisper large-v3
    with seeded random weights, bf16 and then the int8 decoder with int8
    cross-attention K/V, seeded mel windows through the encoder, beam 5
    and greedy, max_new_tokens steps. One decoder per loop decodes keys A
    (3 windows) and B (2 windows) in the order A, B, A, A, each call on
    windows of its own (GRAPH_CALLS): A's and B's first calls capture the
    set-up, step-0 and step graphs, the later A calls must capture
    nothing, run no step eagerly and replay every step. Every call's
    tokens must equal the eager loop's on its inputs, the scores within
    1e-4 absolute, the kernel launches and decoder calls equal. Then a
    sampled greedy rung (per-row fallback generators, temperature 0.6)
    twice on one key: each call's tokens, scores and generator states
    after it equal the eager loop's from the same fresh generators. The
    host seconds per call (set-up, step 0, capture) and eager and
    graphed ms per step are logged."""
    from notsofar_tpu_torch.asr import decoding as dec
    from notsofar_tpu_torch.asr.beam import BeamDecoder
    from notsofar_tpu_torch.asr.inference import load_whisper_model

    n_win = sum(n for _, n, _ in GRAPH_CALLS)
    mel = torch.from_numpy(np.random.RandomState(8).randn(n_win, 128, 3000)
                           .astype(np.float32)).cuda()
    for dtype in ("bfloat16", "int8"):
        model, tok, _ = load_whisper_model("large-v3", None,
                                           compute_dtype=dtype,
                                           device="cuda")
        with torch.no_grad():
            xa_all = model.encode(mel)
        opts = dec.DecodeOptions(max_new_tokens=max_new,
                                 cross_kv_quant=model.quant_decoder)
        for kind in ("beam5", "greedy"):
            if kind == "beam5":
                d = BeamDecoder(model, tok, opts, beam_size=5)
                loop, K = d._beam_loop, 5
            else:
                d = dec.GreedyDecoder(model, tok, opts)
                loop, K = d._decode_loop, 1
            w0 = 0
            for i, (name, n, prompts) in enumerate(GRAPH_CALLS):
                xa = xa_all[w0:w0 + n]
                w0 += n
                toks, pads, P = d._pack_prompts(prompts)
                kw = dict(pad_lens=torch.from_numpy(pads).cuda()) \
                    if any(prompts) else {}
                if not kw:
                    P = len(d._initial_tokens(None))
                    toks = toks[:, -P:]
                prompt = torch.from_numpy(toks).cuda()
                e, gr = (decode_run(loop, K, xa, P, prompt, graph=graph,
                                    **kw) for graph in (False, None))
                reused = i >= 2
                check_graphed_call(f"graph {dtype} {kind} call {i + 1} "
                                   f"(key {name}, {n * K} rows)", e, gr,
                                   reused)
            del d, loop
        if dtype == "bfloat16":
            check_sampled_reuse(model, tok, xa_all, max_new)
        for beams in (1, 5):
            log(f"graph {dtype}: " + step_kernels(model, beams))
        if dtype == "bfloat16":
            time_finished_interval(model, tok, xa_all[:3])
        del model, xa_all
    ms = {f"{k[0].replace('torch.', '')} {k[1]} rows": round(v, 3)
          for k, v in STEP_DEVICE_MS.items()}
    replay = {f"{k[0].replace('torch.', '')} {k[1]} rows":
              (round(v["graph_ms"], 4), v["busy_share"] and
               round(v["busy_share"], 4)) for k, v in STEP_GRAPH.items()}
    log(f"graph: one decoder step's device ms {ms}; replayed as a graph "
        f"(ms a step, device busy share) {replay}; the int8 step below "
        "the bf16 step at " + ", ".join(
            f"{r} rows {STEP_DEVICE_MS[('torch.bfloat16/int8', r)] < STEP_DEVICE_MS[('torch.bfloat16', r)]}"
            for r in (3, 15)))
    # the int8 model is not the one phase 8 loads (that one comes from a
    # saved checkpoint): free its device memory
    import notsofar_tpu_torch.asr.inference as inf
    inf._MODEL_CACHE.pop("None/large-v3/int8/cuda", None)
    torch.cuda.empty_cache()


# phase 3b's decode calls on one decoder, in order: (key, windows, each
# window's prompt); key B's prompts are right-aligned in a 16-token bucket
# with left pads (the prompted ladder's packing; its int8 prefill takes
# the dequantized cross-attention path)
GRAPH_CALLS = (("A", 3, [None] * 3), ("B", 2, [list(range(300, 311)), None]),
               ("A", 3, [None] * 3), ("A", 3, [None] * 3))


def decode_run(loop, K: int, xa, prompt_len: int, prompt, **kw) -> dict:
    """One decode call timed by the host clock to a synchronize after it,
    with the launches, decoder calls and DECODE_STEPS it added."""
    from notsofar_tpu_torch.asr import decoding as dec
    from notsofar_tpu_torch.ops import kernels
    kernels.reset_launches()
    dec.reset_decoder_calls()
    dec.reset_decode_steps()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens, stats = loop(xa, prompt_len, prompt, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = dict(dec.DECODE_STEPS)
    return dict(tokens=tokens, lp=stats[:, :K], stats=stats,
                launches=dict(kernels.LAUNCHES),
                calls=dict(dec.DECODER_CALLS), steps=steps, wall=wall,
                n=steps["eager"] + steps["replayed"])


def check_graphed_call(label: str, e: dict, gr: dict, reused: bool) -> None:
    """A graphed decode call against the eager loop on the same inputs:
    tokens equal, sum_logprob within 1e-4, launches and decoder calls
    equal, the same steps; a reused key's call captures nothing and runs
    no step eagerly, a new key's captures three graphs and runs step 0
    eagerly."""
    st = gr["steps"]
    diff = (e["lp"] - gr["lp"]).abs().max().item()
    before = st["prefill_s"] + st["step0_s"] + st["capture_s"]
    log(f"{label}: {'hit' if st['hits'] else 'miss'}, {gr['n']} steps, "
        f"tokens equal {torch.equal(e['tokens'], gr['tokens'])}, "
        f"sum_logprob max abs diff {diff:.3e} (tolerance 1e-4), launches "
        f"equal {e['launches'] == gr['launches']}, decoder calls equal "
        f"{e['calls'] == gr['calls']}; ms a call {gr['wall'] * 1e3:.2f} "
        f"(eager {e['wall'] * 1e3:.2f}: {e['wall'] / e['n'] * 1e3:.2f} ms a "
        f"step); host s before the first replayed step {before:.4f} "
        f"(set-up {st['prefill_s']:.4f}, step 0 {st['step0_s']:.4f}, "
        f"capture {st['capture_s']:.4f}; {st['captures']} graphs); "
        + host_breakdown(st, gr["wall"]))
    if not torch.equal(e["tokens"], gr["tokens"]) or not diff <= 1e-4:
        raise AssertionError(f"{label}: the graphed decode differs from "
                             "the eager loop")
    if e["launches"] != gr["launches"] or e["calls"] != gr["calls"]:
        raise AssertionError(f"{label}: launches {gr['launches']} / "
                             f"{gr['calls']}, eager {e['launches']} / "
                             f"{e['calls']}")
    want = dict(captures=0, eager=0, hits=1) if reused else \
        dict(captures=3, eager=1, misses=1)
    if not (all(st[k] == v for k, v in want.items())
            and gr["n"] == e["n"] > 1 and st["replayed"] == gr["n"]
            - st["eager"]):
        raise AssertionError(f"{label}: steps {st}, eager {e['steps']}")


def check_sampled_reuse(model, tok, xa_all, max_new: int) -> None:
    """A sampled rung of the fallback ladder (greedy, temperature 0.6,
    fresh per-row generators, as transcribe's batched ladder makes them)
    twice on one key of one decoder: each graphed call (a miss, then a
    hit) draws what the eager loop draws from the same fresh
    generators: tokens equal, scores within 1e-4, the generators' states
    equal afterwards."""
    from notsofar_tpu_torch.asr import decoding as dec
    from notsofar_tpu_torch.asr.transcribe import fallback_generator
    d = dec.GreedyDecoder(model, tok, dec.DecodeOptions(
        max_new_tokens=max_new))
    toks, pads, P = d._pack_prompts([[300, 301], None, [402]])
    prompt = torch.from_numpy(toks).cuda()
    pads = torch.from_numpy(pads).cuda()
    for i, (w0, seeks) in enumerate(((0, (0, 3000, 6000)),
                                     (3, (9000, 12000, 15000)))):
        gens = {m: [fallback_generator(s, 3, torch.device("cuda"))
                    for s in seeks] for m in ("eager", "graphed")}
        runs = {m: decode_run(d._decode_loop, 1, xa_all[w0:w0 + 3], P,
                              prompt, generator=None, temperature=0.6,
                              pad_lens=pads, row_generators=gens[m],
                              graph=None if m == "graphed" else False)
                for m in ("eager", "graphed")}
        e, gr = runs["eager"], runs["graphed"]
        same_gens = all(torch.equal(a.get_state(), b.get_state())
                        for a, b in zip(gens["eager"], gens["graphed"]))
        check_graphed_call(f"graph sampled greedy call {i + 1} (3 rows, "
                           "temperature 0.6, per-row generators)", e, gr,
                           reused=i > 0)
        log(f"graph sampled greedy call {i + 1}: generator states after "
            f"the call equal {same_gens}")
        if not same_gens:
            raise AssertionError("graph sampled: the graphed call left its "
                                 "generators elsewhere than the eager loop")


FINISHED_EOT_SCALE = 4.0   # random weights alone rarely end a decode


def time_finished_interval(model, tok, xa, max_new: int = 224) -> None:
    """What the loops' finished.all() interval (asr.decoding.
    FINISHED_CHECK_EVERY, a host sync each) costs and saves on the card:
    with the model's EOT embedding row scaled by FINISHED_EOT_SCALE, so
    that rows latch EOT at different steps, 3 windows decode greedy and at
    beam 5 (max_new tokens, graphed) with the interval at 1, 2, 4, 8 and
    back (8, 4, 2, 1). Tokens and stats must be equal at every interval;
    the steps run and ms per decode call are logged. The row and the
    interval are restored afterwards."""
    from collections import defaultdict
    from notsofar_tpu_torch.asr import decoding as dec
    from notsofar_tpu_torch.asr.beam import BeamDecoder
    emb = model.decoder.token_embedding.weight
    row, default = emb[tok.eot].clone(), dec.FINISHED_CHECK_EVERY
    opts = dec.DecodeOptions(max_new_tokens=max_new)
    with torch.no_grad():
        emb[tok.eot] *= FINISHED_EOT_SCALE
    try:
        for kind in ("greedy", "beam5"):
            if kind == "beam5":
                d = BeamDecoder(model, tok, opts, beam_size=5)
                loop = d._beam_loop
            else:
                d = dec.GreedyDecoder(model, tok, opts)
                loop = d._decode_loop
            initial = d._initial_tokens(None)
            prompt = torch.tensor(initial, device="cuda").repeat(3, 1)
            ms, steps, first = defaultdict(list), {}, None
            for n in (1, 2, 4, 8, 8, 4, 2, 1):
                dec.FINISHED_CHECK_EVERY = n
                dec.reset_decode_steps()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = loop(xa, len(initial), prompt)
                torch.cuda.synchronize()
                ms[n].append(round((time.perf_counter() - t0) * 1e3, 2))
                steps[n] = dec.DECODE_STEPS["eager"] + \
                    dec.DECODE_STEPS["replayed"]
                first = first or out
                if not all(torch.equal(a, b) for a, b in zip(out, first)):
                    raise AssertionError(f"finished interval {kind}: the "
                                         f"decode at interval {n} differs")
            lengths = first[1][:, 1].tolist() if kind == "greedy" else None
            log(f"finished interval {kind} (EOT row x {FINISHED_EOT_SCALE}, "
                f"max_new {max_new}): tokens and stats equal at every "
                f"interval; rows' lengths {lengths}; interval: steps, ms per "
                "decode call (two runs) "
                + "; ".join(f"{n}: {steps[n]}, {ms[n]}" for n in sorted(ms)))
    finally:
        with torch.no_grad():
            emb[tok.eot].copy_(row)
        dec.FINISHED_CHECK_EVERY = default


def step_kernels(model, beams: int = 1) -> str:
    """Where a graphed step's time goes (tools/time_decode_step.py
    step_profile): the kernels of one single-token decoder call run
    eagerly under torch.profiler, their count, the sum of their device
    times and the names that take the most; the same call replayed as a
    CUDA graph, ms per replay and the device's busy share over 10 replays
    under torch.profiler. beams 1: the greedy shape (3 windows' rows, a
    256-slot cache after a 4-token prompt); beams K: the beam shape (K
    rows a window, the prompt in a split cache's shared segment, a 64-slot
    generated segment, the beams folded into the cross-attention's
    queries)."""
    from notsofar_tpu_torch.tools.time_decode_step import step_profile
    r = step_profile(model, beams)
    key = (str(model.dtype) + ("/int8" if model.quant_decoder else ""),
           r["rows"])
    STEP_DEVICE_MS[key] = r["device_ms"]
    STEP_GRAPH[key] = r
    share = ("not seen: the profiler shows no kernel inside the replays "
             "(the replay ms by events stands alone)"
             if r["busy_share"] is None else f"{r['busy_share']:.4f}")
    return (f"one decoder step ({r['rows']} rows, {beams} beam(s), eager, "
            f"torch.profiler): {r['kernels']} device activities, "
            f"{r['device_ms']:.3f} ms of device time; replayed as a CUDA "
            f"graph {r['graph_ms']:.4f} ms a step, device busy share "
            f"{share} ({r['graph_kernels_seen']} kernels in 10 replays); "
            "the most (name: launches, ms): "
            + "; ".join(f"{k}: {n}, {v:.3f}" for k, n, v in r["top"]))


# phase 3b's one decoder step replayed as a graph, by (dtype, rows)
STEP_GRAPH: dict = {}


# phase 3b's profiled device ms of one decoder step by (dtype, rows)
STEP_DEVICE_MS: dict = {}


# each phase's attn_step launches, [rows, cache length, pos, launches]
# (chiprun_out/attn_step_traffic.json, the input of
# notsofar_tpu_torch/tools/time_attn_step.py)
ATTN_STEP_TRAFFIC: dict = {}


@contextlib.contextmanager
def attn_step_traffic(label: str):
    """Record the attn_step launches of the decode loops run inside: a
    GreedyDecoder._decode_loop call over B rows with a cache of ctx slots
    and a P-token prompt runs n single-token steps at pos P .. P + n - 1,
    each one launch per decoder layer (the loops count their steps in
    DECODE_STEPS, replayed or eager). Yields the histogram {(B, ctx, pos):
    launches}; afterwards logs it and writes every phase's to
    chiprun_out/attn_step_traffic.json."""
    from collections import Counter
    from notsofar_tpu_torch.asr import decoding as dec
    hist = Counter()
    loop = dec.GreedyDecoder._decode_loop

    def decode_loop(self, xa, prompt_len, *args, **kwargs):
        st = dec.DECODE_STEPS
        n0 = st["eager"] + st["replayed"]
        out = loop(self, xa, prompt_len, *args, **kwargs)
        ctx = self._lengths(prompt_len)[1]
        for pos in range(prompt_len, prompt_len + st["eager"]
                         + st["replayed"] - n0):
            hist[(xa.shape[0], ctx, pos)] += self.model.dims.n_text_layer
        return out

    dec.GreedyDecoder._decode_loop = decode_loop
    try:
        yield hist
    finally:
        dec.GreedyDecoder._decode_loop = loop
    ATTN_STEP_TRAFFIC[label] = [[*k, n] for k, n in sorted(hist.items())]
    (OUT / "attn_step_traffic.json").write_text(json.dumps(ATTN_STEP_TRAFFIC))
    by = {}
    for i, name in ((0, "rows"), (1, "cache length")):
        c = Counter()
        for k, n in hist.items():
            c[k[i]] += n
        by[name] = dict(sorted(c.items()))
    pos = np.repeat([k[2] for k in hist], [n for n in hist.values()])
    quart = np.percentile(pos, [0, 25, 50, 75, 100]).tolist() if len(pos) \
        else []
    log(f"{label}: attn_step traffic {sum(hist.values())} launches; by "
        f"{by}; pos quartiles (0, 25, 50, 75, 100%) {quart}")


def check_traffic(label: str, traffic, counts: dict) -> None:
    """The recorded attn_step traffic accounts for every counted launch."""
    if sum(traffic.values()) != counts["attn_step"]:
        raise AssertionError(f"{label}: attn_step traffic "
                             f"{sum(traffic.values())} launches, counted "
                             f"{counts['attn_step']}")


def check_decode_launches(label: str, counts: dict, quant: bool) -> None:
    """Every decode step's cross-attention reached its kernel (xattn_step
    for the float memory, xattn_int8 for the int8 one) and every step's
    dense layers and logits reached decode_gemv: the decoder calls
    counted under each kernel (models.whisper.DECODER_CALLS, by the rules
    the model dispatches by) are at least the decode steps run (fused
    steps for decode_gemv), and the kernels launched once a layer
    (cross-attention) and TextDecoder.decode_gemv_per_call() times a
    fused step plus decode_gemv_per_call(fused=False) times a call run
    layer by layer (decode_gemv)."""
    from notsofar_tpu_torch.asr import decoding as dec
    from notsofar_tpu_torch.models.whisper import WHISPER_DIMS
    n_layers = WHISPER_DIMS["large-v3"].n_text_layer
    calls = dec.DECODER_CALLS
    steps = dec.DECODE_STEPS["eager"] + dec.DECODE_STEPS["replayed"]
    xattn = "xattn_int8" if quant else "xattn_step"
    per_fused, per_layer = 6 * n_layers + 1, 8 * n_layers + 1
    gemv = per_fused * calls["decode_gemv"] + \
        per_layer * calls["decode_gemv_layerwise"]
    log(f"{label}: {steps} decode steps; {xattn} launches "
        f"{counts[xattn]} = {n_layers} x {calls[xattn]} decoder calls; "
        f"decode_gemv launches {counts['decode_gemv']} = {per_fused} x "
        f"{calls['decode_gemv']} fused steps + {per_layer} x "
        f"{calls['decode_gemv_layerwise']} calls layer by layer")
    for name, want in ((xattn, n_layers * calls[xattn]),
                       ("decode_gemv", gemv)):
        if not (counts[name] == want > 0 and calls[name] >= steps > 0):
            raise AssertionError(f"{label}: {name} launched {counts[name]} "
                                 f"times, {want} expected from the decoder "
                                 f"calls {dict(calls)} ({steps} decode "
                                 "steps)")


def decode_steps_line(label: str, decode_s: float) -> str:
    """The decode loops' step counts since the last reset (graph captures,
    their seconds, replayed against eager steps), decode ms per step, the
    workspaces (workspace_line) and the loops' host seconds
    (host_breakdown) as shares of decode s."""
    from notsofar_tpu_torch.asr import decoding as dec
    st = dec.DECODE_STEPS
    n = st["eager"] + st["replayed"]
    return (f"{label}: decode steps {n} ({st['replayed']} replayed from "
            f"CUDA graphs, {st['eager']} eager), {st['captures']} graph "
            f"captures in {st['capture_s']:.3f} s, "
            f"{decode_s / max(n, 1) * 1e3:.2f} ms per step; "
            + workspace_line() + "; " + host_breakdown(st, decode_s))


def workspace_line() -> str:
    """Decode calls since the last reset of asr.decoding.DECODE_STEPS,
    those whose key had a workspace (hits) or needed one (misses), the
    workspaces evicted for the budget, the bytes the workspaces held
    after the last call, and the card's peak memory since the last reset
    of its statistics."""
    from notsofar_tpu_torch.asr import decoding as dec
    st = dec.DECODE_STEPS
    return (f"decode calls {st['calls']} (hits {st['hits']}, misses "
            f"{st['misses']}, hit rate "
            f"{st['hits'] / max(st['calls'], 1):.3f}), evictions "
            f"{st['evictions']}, the workspaces holding "
            f"{st['workspace_bytes'] / 2 ** 30:.3f} GiB after the last call "
            f"(budget {dec.WORKSPACE_BUDGET / 2 ** 30:.0f} GiB); peak memory "
            f"allocated {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
            f"GiB, reserved {torch.cuda.max_memory_reserved() / 2 ** 30:.2f}"
            " GiB")


def host_breakdown(st: dict, wall: float) -> str:
    """Where a decode loop's host time went (asr.decoding.DECODE_STEPS):
    each decode call's fixed cost (the set-up before its first step, step
    0 -- eager or replayed -- and the graph captures, which only a key's
    first call makes) as seconds and shares of `wall` and per call; per
    replayed step the graph's launch, the counters and the wait on the
    finished.all() read, in ms; and what `wall` holds beyond them (work
    around the decode calls: the fallback ladder's packing, the results'
    copy to the host). Host clocks: a part's device work that runs on
    while the host goes on is counted where the host waits for it."""
    n = max(st["replayed"], 1)
    calls = max(st["calls"], 1)
    fixed = {k: st[k] for k in ("prefill_s", "step0_s", "capture_s")}
    per = {k: st[k] / n * 1e3 for k in ("launch_s", "count_s", "read_s")}
    n_all = st["eager"] + st["replayed"]
    rest = wall - sum(fixed.values()) - sum(
        st[k] for k in ("launch_s", "count_s", "read_s"))
    return (f"wall {wall:.4f} s, {wall / max(n_all, 1) * 1e3:.4f} ms per "
            f"step; fixed ({st['calls']} decode calls, {st['misses']} "
            "misses; s, share of wall, s per call) " + ", ".join(
                f"{k} {v:.4f} ({v / max(wall, 1e-9):.4f}, {v / calls:.4f})"
                for k, v in fixed.items())
            + f"; per replayed step (ms, {st['replayed']} steps) "
            + ", ".join(f"{k[:-2]} {v:.4f}" for k, v in per.items())
            + f"; the rest {rest:.4f} s ({rest / max(wall, 1e-9):.4f})")


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
    from notsofar_tpu_torch.asr import decoding as dec
    from notsofar_tpu_torch.asr.inference import WhisperAsrCfg, asr_inference
    from notsofar_tpu_torch.ops import kernels
    from notsofar_tpu_torch.utils.profiling import StageTimer
    cfg = WhisperAsrCfg(model_name="large-v3", beam_size=beam_size)
    timer = StageTimer()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    dec.reset_decode_steps()
    dec.reset_decoder_calls()
    t0 = time.perf_counter()
    with attn_step_traffic(f"asr {label}") as traffic:
        df = asr_inference(str(work / label), session, cfg,
                           fetch_from_cache=False, timer=timer)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    log(f"asr {label}: kernel launches {counts}; decoder calls "
        f"{dict(dec.DECODER_CALLS)}")
    check_traffic(f"asr {label}", traffic, counts)
    missing = [n for n in needs if counts[n] <= 0]
    if missing:
        raise AssertionError(f"asr {label}: never launched {missing}")
    check_decode_launches(f"asr {label}", counts, quant=False)
    stages = {k: round(v, 3) for k, v in timer.stage_seconds.items()}
    log(f"asr {label}: {len(df)} segments, wall {wall:.2f} s, stages {stages}"
        f", max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    log(decode_steps_line(f"asr {label}", timer.stage_seconds["decode"]))
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
# phase 6b: time-based diarization (nmesc, nmesc_msdd) on the card
# --------------------------------------------------------------------------

SPEECH_BIAS = 12.0   # the seeded MarbleNet's classifier bias for speech


def nemo_marblenet_state(cfg, seed: int, bias: float = SPEECH_BIAS) -> dict:
    """A seeded NeMo EncDecClassificationModel state dict for a MarbleNet
    topology (conv weights at 1/sqrt(fan_in), batch norms away from
    identity), its classifier bias set to (-bias, +bias). The default,
    SPEECH_BIAS, makes the speech class win every frame: a random-weight
    VAD would find no speech, and with the bias every window of the
    session is embedded, the heaviest traffic."""
    rng = np.random.RandomState(seed)

    def r(*shape, fan_in):
        return rng.randn(*shape) / math.sqrt(fan_in)

    sd, c_in = {}, cfg.n_mels
    for bi, b in enumerate(cfg.blocks):
        p, ci = f"encoder.encoder.{bi}", c_in
        for rep in range(b.repeat):
            if b.separable:
                sd[f"{p}.mconv.{3 * rep}.conv.weight"] = r(
                    ci, 1, b.kernel, fan_in=b.kernel)
                sd[f"{p}.mconv.{3 * rep + 1}.conv.weight"] = r(
                    b.filters, ci, 1, fan_in=ci)
            else:
                sd[f"{p}.mconv.{3 * rep}.conv.weight"] = r(
                    b.filters, ci, b.kernel, fan_in=ci * b.kernel)
            bn = f"{p}.mconv.{3 * rep + 2}"
            sd[f"{bn}.weight"] = 1.0 + 0.1 * rng.randn(b.filters)
            sd[f"{bn}.bias"] = 0.1 * rng.randn(b.filters)
            sd[f"{bn}.running_mean"] = 0.1 * rng.randn(b.filters)
            sd[f"{bn}.running_var"] = 0.5 + rng.rand(b.filters)
            ci = b.filters
        if b.residual:
            sd[f"{p}.res.0.0.conv.weight"] = r(b.filters, c_in, 1,
                                               fan_in=c_in)
            sd[f"{p}.res.0.1.weight"] = np.ones(b.filters)
            sd[f"{p}.res.0.1.bias"] = np.zeros(b.filters)
            sd[f"{p}.res.0.1.running_mean"] = np.zeros(b.filters)
            sd[f"{p}.res.0.1.running_var"] = np.ones(b.filters)
        c_in = b.filters
    sd["decoder.decoder_layers.0.weight"] = r(cfg.num_classes, c_in,
                                              fan_in=c_in)
    sd["decoder.decoder_layers.0.bias"] = np.asarray([-bias, bias])
    return sd


def write_marblenet_nemo(path: Path, cfg, sd: dict) -> None:
    """A MarbleNet .nemo archive whose yaml gives the topology as NeMo's
    jasper encoder config (FrameVAD.from_checkpoint reads it)."""
    write_nemo(path, sd, dict(
        preprocessor=dict(features=cfg.n_mels),
        encoder=dict(jasper=[dict(
            filters=b.filters, repeat=b.repeat, kernel=[b.kernel],
            dilation=[b.dilation], residual=b.residual,
            separable=b.separable) for b in cfg.blocks])))


def nemo_msdd_state(cfg, seed: int) -> dict:
    """A seeded NeMo MSDD_module state dict ('msdd.' keys) of an MSDD
    shape, weights at 1/sqrt(fan_in)."""
    rng = np.random.RandomState(seed)
    K, S, C, D, H = (cfg.n_scales, cfg.num_spks, cfg.cnn_channels,
                     cfg.emb_dim, cfg.hidden)

    def r(*shape):
        return rng.randn(*shape) / math.sqrt(np.prod(shape[1:]))

    sd = {"conv.0.cnn.0.weight": r(C, 1, K * (S + 1), 1),
          "conv.0.cnn.0.bias": 0.1 * rng.randn(C)}
    for i in range(1, cfg.conv_repeat + 1):
        sd[f"conv.{i}.cnn.0.weight"] = r(C, 1, C, 1)
        sd[f"conv.{i}.cnn.0.bias"] = 0.1 * rng.randn(C)
    for i in range(cfg.conv_repeat + 1):
        sd[f"conv_bn.{i}.running_mean"] = 0.1 * rng.randn(D)
        sd[f"conv_bn.{i}.running_var"] = 0.5 + rng.rand(D)
    for name, (o, i) in (("conv_to_linear", (H, C * D)),
                         ("linear_to_weights", (K, H)),
                         ("dist_to_emb", (H, K * S)),
                         ("hidden_to_spks", (S, 2 * H))):
        sd[f"{name}.weight"] = r(o, i)
        sd[f"{name}.bias"] = 0.1 * rng.randn(o)
    for k in range(cfg.num_lstm_layers):
        for sfx in ("", "_reverse"):
            sd[f"lstm.weight_ih_l{k}{sfx}"] = r(4 * H, H if k == 0 else 2 * H)
            sd[f"lstm.weight_hh_l{k}{sfx}"] = r(4 * H, H)
            sd[f"lstm.bias_ih_l{k}{sfx}"] = 0.1 * rng.randn(4 * H)
            sd[f"lstm.bias_hh_l{k}{sfx}"] = 0.1 * rng.randn(4 * H)
    return {f"msdd.{k}": v for k, v in sd.items()}


def write_nemo(path: Path, sd: dict, config: dict) -> None:
    """A .nemo archive: model_weights.ckpt (float32 tensors) and
    model_config.yaml."""
    import tarfile
    import yaml
    path.parent.mkdir(parents=True, exist_ok=True)
    ckpt, cfg = path.with_suffix(".ckpt"), path.with_suffix(".yaml")
    torch.save({k: torch.tensor(np.asarray(v, np.float32))
                for k, v in sd.items()}, ckpt)
    cfg.write_text(yaml.safe_dump(config))
    with tarfile.open(path, "w") as tar:
        tar.add(ckpt, arcname="model_weights.ckpt")
        tar.add(cfg, arcname="model_config.yaml")
    ckpt.unlink()
    cfg.unlink()


def check_time_based_models() -> None:
    """MarbleNet (DEFAULT_BLOCKS, f32) frame probabilities and the
    telephonic MSDD's probabilities on the card against the same seeded
    weights on the CPU, TF32 off. Tolerance 1e-4 absolute: f32 sums in
    another order on both sides (cuDNN convs and LSTM, cuBLAS against CPU
    kernels), ~1e-6 expected."""
    from notsofar_tpu_torch.models.marblenet import FrameVAD
    from notsofar_tpu_torch.models.msdd import MSDDConfig, OverlapDecoder
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        rng = np.random.RandomState(11)
        wavs = (rng.randn(3, 40 * 16000) * 0.1).astype(np.float32)
        lengths = np.asarray([40 * 16000, 31 * 16000 + 7, 12 * 16000])
        cpu = FrameVAD(device="cpu", seed=4)
        gpu = FrameVAD(state_dict=cpu.module.state_dict(), device="cuda")
        d_vad = float(np.abs(gpu.frame_probs(wavs, lengths)
                             - cpu.frame_probs(wavs, lengths)).max())
        cfg = MSDDConfig()
        cpu_m = OverlapDecoder(cfg, device="cpu", seed=5)
        gpu_m = OverlapDecoder(cfg, cpu_m.module.state_dict(), device="cuda")
        e = rng.randn(2, 256, cfg.n_scales, cfg.emb_dim).astype(np.float32)
        a = rng.randn(2, cfg.n_scales, cfg.emb_dim, 2).astype(np.float32)
        d_msdd = float(np.abs(gpu_m.refine(e, a) - cpu_m.refine(e, a)).max())
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    log(f"time-based models, card against CPU (f32, TF32 off): MarbleNet "
        f"frame probabilities max abs {d_vad:.3e}, MSDD (telephonic: K "
        f"{cfg.n_scales}, D {cfg.emb_dim}, hidden {cfg.hidden}, "
        f"{cfg.num_lstm_layers} LSTM layers, {cfg.cnn_channels} channels) "
        f"max abs {d_msdd:.3e} (tolerance 1e-4)")
    if not (d_vad <= 1e-4 and d_msdd <= 1e-4):
        raise AssertionError("time-based models differ on the card")


def planned_forwards(vad: np.ndarray, total: int, recipe,
                     batch: int) -> dict:
    """Speaker-encoder forwards that diarize_streams plans for a VAD
    mask: windows per recipe scale in batches of `batch`."""
    from notsofar_tpu_torch.diarization import time_based as tb
    out = {}
    for w, h in zip(recipe.speaker_embeddings.window_length_in_sec,
                    recipe.speaker_embeddings.shift_length_in_sec):
        n = len(tb._speech_window_starts(vad, total, 16000, int(w * 16000),
                                         int(h * 16000)))
        out[w] = (n, -(-n // batch))
    return out


def run_time_based(work: Path, asr_df, seconds: float = 40.0):
    """Phase 6b: diarization_inference with method='nmesc' (the meeting
    recipe) and 'nmesc_msdd' (telephonic) on phase 4's session with a
    seeded word track, every model at full width on the card: MarbleNet
    (DEFAULT_BLOCKS, f32) and the telephonic MSDD loaded from seeded
    NeMo-layout .nemo checkpoints under NOTSOFAR_MODELS_DIR, TitaNet-large
    in bf16 (seeded random weights). No fallback may run (the MarbleNet
    VAD, the loaded MSDD); every word gets a speaker; depthwise_conv1d
    launches 9 times per planned TitaNet forward. Then msdd_refine on
    the telephonic base windows with a seeded 4-speaker labelling (6
    pairs), whatever the clustering found. Launch counts are reset before
    the phase; returns them."""
    import os
    from notsofar_tpu_torch.diarization import time_based as tb
    from notsofar_tpu_torch.diarization.common import DiarizationCfg
    from notsofar_tpu_torch.diarization.diarization import \
        diarization_inference
    from notsofar_tpu_torch.diarization.recipes import resolve_recipe
    from notsofar_tpu_torch.diarization.word_based import \
        resolve_speaker_encoder
    from notsofar_tpu_torch.models.marblenet import (FrameVAD,
                                                     MarbleNetConfig)
    from notsofar_tpu_torch.models.msdd import MSDDConfig, OverlapDecoder
    from notsofar_tpu_torch.ops import kernels
    from notsofar_tpu_torch.utils.audio import read_wav
    from notsofar_tpu_torch.utils.profiling import StageTimer

    check_time_based_models()
    models = work / "diar_models"
    mcfg, dcfg = MarbleNetConfig(), DiarizationCfg()
    write_marblenet_nemo(models / f"{dcfg.vad_model_name}.nemo", mcfg,
                         nemo_marblenet_state(mcfg, 21))
    write_nemo(models / f"{dcfg.msdd_model_name}.nemo",
               nemo_msdd_state(MSDDConfig(), 22), dict(name="msdd"))
    log(f"time-based checkpoints written under {models.name}/: MarbleNet "
        f"(DEFAULT_BLOCKS, classifier bias -{SPEECH_BIAS} / +{SPEECH_BIAS} "
        "so that speech wins every frame), MSDD (telephonic shape)")
    df = add_word_track(asr_df.assign(session_id="smoke_time"), seconds, 0)
    old_dir = os.environ.get("NOTSOFAR_MODELS_DIR")
    os.environ["NOTSOFAR_MODELS_DIR"] = str(models)
    tb._VAD_CACHE.clear()
    tb._MSDD_CACHE.clear()
    msdd_calls = {"n": 0}
    refine = OverlapDecoder.refine

    def counted(self, *a):
        msdd_calls["n"] += 1
        return refine(self, *a)

    OverlapDecoder.refine = counted
    try:
        encoder = resolve_speaker_encoder(dcfg)
        vad = tb.resolve_frame_vad(dcfg)
        if not isinstance(vad, FrameVAD):
            raise AssertionError("the MarbleNet checkpoint did not load")
        wavs = [read_wav(f, normalize=True) for f in
                sorted(df.wav_file_name.unique())]
        wavs = [w if w.ndim == 1 else w[0] for w in wavs]
        concat = np.concatenate(wavs)
        kernels.reset_launches()
        results, plan = {}, {}
        for method in ("nmesc", "nmesc_msdd"):
            recipe = resolve_recipe(method)
            mask = np.concatenate([tb.make_recipe_vad(vad, recipe)(w, 16000)
                                   for w in wavs])
            probs = np.concatenate([vad.frame_probs(w[None], [len(w)])[0]
                                    for w in wavs])
            plan[method] = planned_forwards(mask, len(concat), recipe,
                                            tb.EMBED_BATCH)
            cfg = DiarizationCfg(method=method)
            timer, before = StageTimer(), dict(kernels.LAUNCHES)
            calls0 = msdd_calls["n"]
            t0 = time.perf_counter()
            out = diarization_inference(str(work / "diar_time"), df, cfg,
                                        fetch_from_cache=False, timer=timer)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = kernels.LAUNCHES["depthwise_conv1d"] - \
                before["depthwise_conv1d"]
            want = 9 * sum(f for _, f in plan[method].values())
            msdd = tb._MSDD_CACHE.get((dcfg.msdd_model_name, "cuda"))
            spk = out.speaker_id.nunique()
            results[method] = dict(wall=wall, speakers=spk, stages={
                k: round(v, 3) for k, v in timer.stage_seconds.items()})
            log(f"diarization {method} ({recipe.name} recipe): wall "
                f"{wall:.2f} s, stages {results[method]['stages']}; VAD "
                f"{tb.LAST_VAD_USED['kind']}, speech frames "
                f"{mask.mean():.4f}, min P(speech) {probs.min():.4f}; "
                f"windows and forwards per scale {plan[method]}; "
                f"depthwise_conv1d launches {n} (planned {want}); speakers "
                f"{spk}; MSDD {type(msdd).__name__} calls "
                f"{msdd_calls['n'] - calls0}")
            check_attributed(out, f"time-based {method}", seconds)
            if tb.LAST_VAD_USED["kind"] != "marblenet":
                raise AssertionError(f"{method}: the {tb.LAST_VAD_USED} "
                                     "VAD ran, not MarbleNet")
            if method == "nmesc_msdd" and not isinstance(msdd,
                                                         OverlapDecoder):
                raise AssertionError("nmesc_msdd fell back: no MSDD loaded")
            if not (spk >= 1 and n == want > 0):
                raise AssertionError(f"{method}: {spk} speakers, "
                                     f"depthwise_conv1d {n} of {want}")
            if method == "nmesc_msdd" and spk >= 2 and \
                    msdd_calls["n"] == calls0:
                raise AssertionError("nmesc_msdd: the MSDD never ran")
        # the MSDD at full width on a seeded 4-speaker labelling of the
        # telephonic base windows (6 pairs), whatever the clustering found
        recipe = resolve_recipe("nmesc_msdd")
        mask = np.concatenate([tb.make_recipe_vad(vad, recipe)(w, 16000)
                               for w in wavs])
        base_win = int(recipe.speaker_embeddings.window_length_in_sec[-1]
                       * 16000)
        starts = tb._speech_window_starts(
            mask, len(concat), 16000, base_win,
            int(recipe.speaker_embeddings.shift_length_in_sec[-1] * 16000))
        labels = np.random.RandomState(23).randint(4, size=len(starts))
        labels[:4] = np.arange(4)
        calls0, before = msdd_calls["n"], kernels.LAUNCHES["depthwise_conv1d"]
        t0 = time.perf_counter()
        spk_vad = tb.msdd_refine(
            concat, 16000, encoder, tb._MSDD_CACHE[(dcfg.msdd_model_name,
                                                    "cuda")],
            starts, labels, mask.astype(float), 4,
            scales=recipe.speaker_embeddings.window_length_in_sec,
            hops=recipe.speaker_embeddings.shift_length_in_sec,
            cluster_win_sec=base_win / 16000)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = kernels.LAUNCHES["depthwise_conv1d"] - before
        want = 9 * sum(f for _, f in plan["nmesc_msdd"].values())
        active = spk_vad.reshape(4, -1).sum(axis=1).tolist()
        log(f"msdd_refine, 4 seeded speakers on {len(starts)} base windows: "
            f"{msdd_calls['n'] - calls0} MSDD calls (6 pairs), {secs:.2f} "
            f"s, active frames per speaker {active}, depthwise_conv1d "
            f"{n} (planned {want})")
        if not (msdd_calls["n"] - calls0 == 6 and spk_vad.shape[0] == 4
                and set(np.unique(spk_vad)) <= {0.0, 1.0} and n == want
                and sum(active) > 0):
            raise AssertionError("msdd_refine at full width failed")
    finally:
        OverlapDecoder.refine = refine
        if old_dir is None:
            os.environ.pop("NOTSOFAR_MODELS_DIR", None)
        else:
            os.environ["NOTSOFAR_MODELS_DIR"] = old_dir
    counts = dict(kernels.LAUNCHES)
    log(f"diarization, time-based: kernel launches {counts}")
    return counts


# --------------------------------------------------------------------------
# phase 7: CSS separation at full Conformer-large width
# --------------------------------------------------------------------------

def mc_mixture(seconds: float, rng: np.random.RandomState):
    """Seeded 7-channel audio of `seconds`: three sources of harmonic
    bursts (90-250 Hz f0, 5 harmonics, 1-4 s bursts, 0.5-5 s pauses), each
    at its own azimuth and reaching every mic with the plane-wave delay of
    the 7-mic circular array (utils/mic_array.py), plus noise. Returns
    (int16 audio [7, n], bursts [(source, start s, end s)])."""
    from notsofar_tpu_torch.utils.mic_array import multichannel_mic_pos_xyz_cm
    sr = 16000
    n = int(seconds * sr)
    pos = multichannel_mic_pos_xyz_cm()[:, :2] / 100.0     # metres
    freqs = torch.fft.rfftfreq(n, 1.0 / sr, device="cuda",
                               dtype=torch.float64)
    mics = torch.from_numpy(0.003 * rng.randn(7, n)).cuda()
    bursts = []
    for src in range(3):
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
            bursts.append((src, a / sr, b / sr))
            pos_s += dur + rng.uniform(0.5, 5.0)
        az = rng.uniform(0.0, 2 * np.pi)
        delay = -(pos @ np.array([np.cos(az), np.sin(az)])) / 343.0
        X = torch.fft.rfft(torch.from_numpy(x).cuda())
        shift = torch.exp(-2j * np.pi * freqs[None, :]
                          * torch.from_numpy(delay).cuda()[:, None])
        mics += torch.fft.irfft(X[None, :] * shift, n)
    audio = mics.clamp(-1, 1).mul(32767).round().short().cpu().numpy()
    return audio, bursts


def write_css_sessions(work: Path, n_sessions: int = 2,
                       seconds: float = 360.0, seed: int = 10):
    """Seeded 7-channel sessions of `seconds` (mc_mixture), written as one
    int16 wav per mic, as load_session_audio reads them. Returns the
    sessions' rows."""
    import pandas as pd
    import scipy.io.wavfile as wf
    sr = 16000
    rows = []
    for si in range(n_sessions):
        audio, _ = mc_mixture(seconds, np.random.RandomState(seed + si))
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


# --------------------------------------------------------------------------
# phase 8: the whole pipeline, as run_inference_gpu.py runs it
# --------------------------------------------------------------------------

PIPELINE_SECONDS = 40.0
PIPELINE_WHISPER = "large-v3"
PIPELINE_WORDS = ("alpha", "bravo", "charlie", "delta", "echo", "foxtrot",
                  "golf", "hotel", "india", "juliet", "kilo", "lima")


def write_meeting(meetings_dir: Path, seconds: float, seed: int = 20,
                  meeting_id: str = "MTG_90008"):
    """A seeded synthetic meeting in the NOTSOFAR layout (the writer of
    tests/test_pipeline_e2e.py::make_meeting, copied here since nothing
    run on the card may import tests): one 7-channel device plaza_0
    (mc_mixture: three speakers at their own azimuths), devices.json,
    gt_transcription.json (one utterance per burst, a seeded word per
    0.4 s of it, speaker spk<source>) and gt_meeting_metadata.json.
    Returns the GT utterances."""
    import scipy.io.wavfile as wf
    rng = np.random.RandomState(seed)
    mdir = meetings_dir / meeting_id
    (mdir / "plaza_0").mkdir(parents=True)
    audio, bursts = mc_mixture(seconds, rng)
    names = []
    for m in range(7):
        names.append(f"plaza_0/ch{m}.wav")
        wf.write(mdir / names[-1], 16000, audio[m])
    devices = [dict(device_name="plaza_0", is_close_talk=False, is_mc=True,
                    wav_file_names=",".join(names))]
    (mdir / "devices.json").write_text(json.dumps(devices))
    gt = []
    for src, a, b in sorted(bursts, key=lambda x: x[1]):
        starts = np.arange(a, b - 0.35, 0.4)
        words = [[str(rng.choice(PIPELINE_WORDS)), round(float(t), 2),
                  round(float(t) + 0.35, 2)] for t in starts]
        if words:
            gt.append(dict(start_time=round(a, 2), end_time=round(b, 2),
                           text=" ".join(w[0] for w in words),
                           speaker_id=f"spk{src}", word_timing=words,
                           ct_wav_file_name=f"ct_spk{src}.wav"))
    (mdir / "gt_transcription.json").write_text(json.dumps(gt))
    (mdir / "gt_meeting_metadata.json").write_text(json.dumps(dict(
        meeting_id=meeting_id, MtgType="natural", hashtags="#Smoke")))
    return gt


def save_reference_css_checkpoint(model_dir: Path, model, train_cfg):
    """A CssModel saved as the NOTSOFAR baseline's checkpoint: config.yaml
    and model.pt (the reference ConformerCssWrapper state dict with the DDP
    'module.' prefix), the inverse of models/convert.py's mapping."""
    import yaml
    from notsofar_tpu_torch.utils.conf import dataclass_to_dict
    sd = {k: v.detach().float().cpu() for k, v in
          model.module.state_dict().items()}
    P = "executor.nnet."
    ref = {P + "input_bias": sd["input_bias"],
           P + "input_scale": sd["input_scale"],
           P + "linear.weight": sd["mask_head.weight"],
           P + "linear.bias": sd["mask_head.bias"],
           P + "conformer.pos_emb.pe_k.weight": sd["encoder.pos_emb"]}
    for i, name in ((0, "embed"), (1, "embed_ln")):
        for w in ("weight", "bias"):
            ref[f"{P}conformer.embed.{i}.{w}"] = sd[f"encoder.{name}.{w}"]
    layer_names = {
        "ffn_in.ln": "feed_forward_in.layer_norm",
        "ffn_in.w1": "feed_forward_in.net.0",
        "ffn_in.w2": "feed_forward_in.net.3",
        "ffn_out.ln": "feed_forward_out.layer_norm",
        "ffn_out.w1": "feed_forward_out.net.0",
        "ffn_out.w2": "feed_forward_out.net.3",
        "attn.ln": "self_attn.layer_norm", "attn.q": "self_attn.linear_q",
        "attn.k": "self_attn.linear_k", "attn.v": "self_attn.linear_v",
        "attn.out": "self_attn.linear_out", "conv.ln": "conv.layer_norm",
        "conv.dw": "conv.dw_conv_1d", "conv.bn": "conv.BN",
        "ln_out": "layer_norm"}
    for i in range(train_cfg.conformer_css_cfg.nnet_conf.conformer_conf
                   .num_blocks):
        L, R = f"encoder.layer_{i}.", f"{P}conformer.encoders.{i}."
        for ours, theirs in layer_names.items():
            for w in ("weight", "bias", "running_mean", "running_var"):
                if L + ours + "." + w in sd:
                    ref[R + theirs + "." + w] = sd[L + ours + "." + w]
        for k, shape in (("pw1_w", (2, 1, 1, 1)), ("pw1_b", (2,)),
                         ("pw2_w", (1, 1, 1, 1)), ("pw2_b", (1,))):
            conv = "conv.pw_conv_1." if k.startswith("pw1") else \
                "conv.pw_conv_2."
            ref[R + conv + ("weight" if k.endswith("w") else "bias")] = \
                sd[L + "conv." + k].reshape(shape)
    model_dir.mkdir(parents=True, exist_ok=True)
    (model_dir / "config.yaml").write_text(
        yaml.safe_dump(dataclass_to_dict(train_cfg)))
    torch.save({f"module.{k}": v for k, v in ref.items()},
               model_dir / "model.pt")


def save_models(models_dir: Path):
    """Seeded random weights under models_dir, where the pipeline looks for
    them: the MC Conformer-large CSS model (notsofar/conformer1.0/mc) and
    the openai-format Whisper checkpoint (whisper/<name>.pt, fp16). The
    TitaNet-large speaker model takes its seeded random weights from
    resolve_speaker_encoder (it reads NeMo checkpoints only)."""
    import dataclasses
    from notsofar_tpu_torch.asr.inference import RANDOM_WEIGHTS_SEED
    from notsofar_tpu_torch.models.css_wrapper import CssModel
    from notsofar_tpu_torch.models.whisper import WHISPER_DIMS
    from notsofar_tpu_torch.models.whisper import WhisperModel
    from notsofar_tpu_torch.training.config import (ConformerCfgM,
                                                    ConformerCssCfgM,
                                                    NnetCfgM, TrainCfg)
    t0 = time.perf_counter()
    train_cfg = TrainCfg(conformer_css_cfg=ConformerCssCfgM(
        nnet_conf=NnetCfgM(conformer_conf=ConformerCfgM(
            attention_dim=512, attention_heads=8, num_blocks=18,
            dropout_rate=0.0))))
    css = CssModel(train_cfg.conformer_css_cfg.freeze(), device="cuda",
                   seed=12)
    save_reference_css_checkpoint(
        models_dir / "notsofar" / "conformer1.0" / "mc", css, train_cfg)
    dims = WHISPER_DIMS[PIPELINE_WHISPER]
    wm = WhisperModel(dims, dtype=torch.float16, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(RANDOM_WEIGHTS_SEED))
    sd = {k: v.cpu() for k, v in wm.state_dict().items()
          if k != "encoder.positional_embedding"}
    (models_dir / "whisper").mkdir(parents=True)
    torch.save(dict(dims=dataclasses.asdict(dims), model_state_dict=sd),
               models_dir / "whisper" / f"{PIPELINE_WHISPER}.pt")
    del css, wm, sd
    log(f"pipeline models saved in {time.perf_counter() - t0:.1f} s")


def run_pipeline(work: Path, seconds: float = PIPELINE_SECONDS):
    """inference_pipeline on one seeded meeting with the config that
    run_inference_gpu.py --config-name full_dev_set_mc loads
    (inference_v1.yaml) and asr.compute_dtype = 'int8'. Random-weight
    Whisper leaves the ASR frame wordless, so every ASR read in the
    pipeline returns the frame plus phase 6's seeded word track (the same
    on every read) and the diarization prepass embeds real load. The three
    prepasses are timed (synchronized) on their way through. Launch and
    decoder-call counts are reset just before the call and read just after
    it. Returns the counts."""
    import notsofar_tpu_torch.inference_pipeline.inference as pipe
    from notsofar_tpu_torch.asr import decoding as dec
    from notsofar_tpu_torch.ops import kernels
    from run_inference_gpu import load_config

    meetings, models, out = work / "meetings", work / "models", work / "out"
    gt = write_meeting(meetings, seconds)
    save_models(models)
    cfg = load_config("full_dev_set_mc")
    cfg.asr.compute_dtype = "int8"
    log(f"pipeline: 1 meeting, 7 channels x {seconds:.0f} s, "
        f"{sum(len(u['word_timing']) for u in gt)} GT words; asr "
        f"{cfg.asr.model_name} {cfg.asr.compute_dtype} beam "
        f"{cfg.asr.beam_size}, css mc_mvdr {cfg.css.mc_mvdr}, diarization "
        f"{cfg.diarization.method}")

    stage_s, tracked = {}, {}

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            result = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stage_s[name] = round(time.perf_counter() - t, 3)
            return result
        return run

    def asr_with_track(*args, **kwargs):
        df = saved["asr_inference"](*args, **kwargs)
        if len(df) == 0:
            raise AssertionError("pipeline: the ASR gave no segments")
        tracked[df.session_id.iloc[0]] = df = add_word_track(df, seconds, 2)
        return df

    saved = {k: getattr(pipe, k) for k in (
        "css_batch_prepass", "asr_batch_prepass", "diarization_batch_prepass",
        "asr_inference")}
    patches = {k: timed(k.split("_")[0], f) for k, f in saved.items()
               if k.endswith("prepass")}
    patches["asr_inference"] = asr_with_track
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    dec.reset_decoder_calls()
    dec.reset_decode_steps()
    for k, f in patches.items():
        setattr(pipe, k, f)
    try:
        t0 = time.perf_counter()
        with attn_step_traffic("pipeline") as traffic:
            wer = pipe.inference_pipeline(str(meetings), str(models),
                                          str(out), cfg,
                                          pipe.FetchFromCacheCfg())
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for k, f in saved.items():
            setattr(pipe, k, f)
    counts = dict(kernels.LAUNCHES)
    check_traffic("pipeline", traffic, counts)
    calls = dec.DECODER_CALLS["xattn_int8"]
    plan = planned_chunks(list(tracked.values()), cfg.diarization, seconds)
    log(f"pipeline: kernel launches {counts}; int8 decoder calls reaching "
        f"xattn_int8 {calls}; wall {wall:.2f} s, prepasses {stage_s}; "
        f"diarization words {plan['words']}, TitaNet chunks "
        f"{plan['chunks']}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; WER "
        + ("none (no words)" if wer is None else
           str(wer[["tcp_wer", "tcorc_wer"]].to_dict("records"))))
    log(decode_steps_line("pipeline (the ASR prepass's s)", stage_s["asr"]))

    sid = "multichannel/MTG_90008_plaza_0"
    files = [f"css_inference/{sid}/sep_stream{k}.wav" for k in range(3)] + [
        f"asr/{sid}/{cfg.asr.model_name}/all_segments_df.pkl",
        f"diarization/{sid}/word_nmesc/all_segments_df.pkl",
        f"wer/{sid}/tcp_wer_hyp.json", f"wer/{sid}/tc_orc_wer_hyp.json",
        "wer/multichannel/tcp_wer_hyp.json",
        "wer/multichannel/tc_orc_wer_hyp.json"]
    missing = [f for f in files if not (out / f).exists()]
    if missing:
        raise AssertionError(f"pipeline: missing contract files {missing}")
    if wer is None:
        raise AssertionError("pipeline: no WER row for the meeting")
    check_decode_launches("pipeline", counts, quant=True)
    never = [k for k in ("encoder_mha", "attn_step_split") if counts[k] <= 0]
    if never:
        raise AssertionError(f"pipeline: never launched {never}")
    if not counts["depthwise_conv1d"] == 9 * plan["chunks"] > 0:
        raise AssertionError(f"pipeline: depthwise_conv1d launched "
                             f"{counts['depthwise_conv1d']} times, planned "
                             f"9 x {plan['chunks']} chunks")
    check_scoring(out / "score_check", gt)
    return counts


def check_scoring(out_dir: Path, gt) -> None:
    """The port's calc_wer on the meeting's GT with known answers: the GT
    as the hypothesis scores 0, and with one word dropped 1/N (N the
    normalized GT words), for tcpWER and tcORC-WER."""
    import pandas as pd
    from notsofar_tpu_torch.utils.scoring import calc_wer
    from notsofar_tpu_torch.utils.scoring.levenshtein import core_name
    gt_df = pd.DataFrame(gt).assign(meeting_id="MTG_90008")
    hyp = [dict(session_id="multichannel/MTG_90008_plaza_0",
                start_time=u["start_time"], end_time=u["end_time"],
                words=u["text"], speaker=u["speaker_id"]) for u in gt]
    n = sum(len(u["text"].split()) for u in gt)
    dropped = [dict(h) for h in hyp]
    dropped[0]["words"] = " ".join(dropped[0]["words"].split()[1:])
    got = [calc_wer(out_dir / name, h, h, gt_df)
           for name, h in (("same", hyp), ("dropped", dropped))]
    rates = [(float(g.tcp_wer.iloc[0]), float(g.tcorc_wer.iloc[0]))
             for g in got]
    log(f"scoring ({core_name()} core): GT as hypothesis tcpWER/tcORC "
        f"{rates[0]} (want 0, 0); one of {n} words dropped {rates[1]} "
        f"(want {1 / n:.6f})")
    if rates[0] != (0.0, 0.0) or not all(abs(r - 1 / n) < 1e-12
                                         for r in rates[1]):
        raise AssertionError(f"calc_wer on known answers: {rates}")


# --------------------------------------------------------------------------
# phase 9: the kernel-decomposition tools, end to end
# --------------------------------------------------------------------------

TOOL_ITERS = {"bench_xattn_variants": 3, "bisect_attn_split": 10}


def run_tool(name: str, iters: int):
    """python -m notsofar_tpu_torch.tools.<name> --iters <iters> at its
    default shapes, in this process; returns its output lines and the
    kernel launches it made."""
    import importlib
    from notsofar_tpu_torch.ops import kernels
    main = importlib.import_module(f"notsofar_tpu_torch.tools.{name}").main
    before = dict(kernels.LAUNCHES)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(["--iters", str(iters)])
    torch.cuda.synchronize()
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"  {name}: {line}")
    launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                if v != before[k]}
    log(f"tools {name}: rc {rc}, {time.perf_counter() - t0:.1f} s, kernel "
        f"launches {launched}")
    if rc != 0 or not lines or not lines[0].startswith("device: NVIDIA"):
        raise AssertionError(f"{name}: rc {rc}, first line {lines[:1]}")
    return lines, launched


def run_tools(stream_ms: float) -> dict:
    """Both tools at their default shapes. bench_xattn_variants: its
    numeric line must equal the plain versions' on the same layer (the
    tool's seeded inputs) within 2% (the line prints 3 digits; onedot's
    lanes take another head's weights than xattn_int8's, so the two are
    far apart), every chain's ms finite and positive, and each chain
    variant launched 32 x (iters + 1) times (+1 for the numeric line).
    bisect_attn_split: every row's ms finite and positive, kernel_only and
    full launched iters + 1 times. The stream chain, a CUDA graph of 32
    xattn_stream launches and the chain's elementwise steps, is logged
    against 32 x phase 2's xattn_stream time (`stream_ms`). Returns the
    phase's launch counts."""
    from notsofar_tpu_torch.ops import kernels as K
    from notsofar_tpu_torch.tools import bench_xattn_variants as bx
    K.reset_launches()
    n = TOOL_ITERS["bench_xattn_variants"]
    lines, launched = run_tool("bench_xattn_variants", n)
    rel = float(re.fullmatch(r"onedot vs current: rel maxdiff (\S+)",
                             lines[1]).group(1))
    q, kvs = bx.make_inputs(24, 1504, 1280, 1, torch.device("cuda"))
    k8, v8, vs = kvs[0]
    a = K.xattn_int8_plain(q, k8, v8, vs, bx.DK, 1504)
    b = K.xattn_onedot_plain(q, k8, v8, vs, bx.DK, 1504)
    rel_plain = ((a - b).abs().max() / a.abs().max()).item()
    log(f"tools bench_xattn_variants: rel maxdiff {rel:.3e}, the plain "
        f"versions' {rel_plain:.3e}")
    if not abs(rel - rel_plain) <= 0.02 * rel_plain:
        raise AssertionError(f"bench_xattn_variants: rel maxdiff {rel}, "
                             f"plain {rel_plain}")
    chain_ms = {}
    for line, name in zip(lines[2:5], ("stream", "current", "onedot")):
        m = re.fullmatch(rf"{name}\s*:\s+(\S+) ms .*", line)
        if not (m and math.isfinite(float(m.group(1)))
                and float(m.group(1)) > 0):
            raise AssertionError(f"bench_xattn_variants: {line!r}")
        chain_ms[name] = float(m.group(1))
    log(f"tools bench_xattn_variants: stream chain {chain_ms['stream']} ms "
        f"= {chain_ms['stream'] / (32 * stream_ms):.3f} x 32 x phase 2's "
        f"xattn_stream {stream_ms:.4f} ms")
    chain = 32 * (n + 1)
    want = {"xattn_stream": chain, "xattn_int8": chain + 1,
            "xattn_onedot": chain + 1}
    if launched != want:
        raise AssertionError(f"bench_xattn_variants launched {launched}, "
                             f"expected {want}")
    n = TOOL_ITERS["bisect_attn_split"]
    lines, launched = run_tool("bisect_attn_split", n)
    for line, name in zip(lines[1:5], ("pack(bias)", "kernel_only", "full",
                                       "library")):
        m = re.fullmatch(rf"{re.escape(name)}: (\S+) ms/call", line)
        if not (m and math.isfinite(float(m.group(1)))
                and float(m.group(1)) > 0):
            raise AssertionError(f"bisect_attn_split: {line!r}")
    want = {"attn_step_split_bias": n + 1, "attn_step_split": n + 1}
    if launched != want:
        raise AssertionError(f"bisect_attn_split launched {launched}, "
                             f"expected {want}")
    return dict(K.LAUNCHES)


# --------------------------------------------------------------------------
# phase 10: the CSS training stack at Conformer-large width
# --------------------------------------------------------------------------

TRAIN_MUTANT = "encoder.layer_0.ffn_in.w1.weight"
TRAIN_BATCH = 32         # TrainCfg's default global batch, the debug recipe's


def train_step_record(cfg, dev: str, rows=(0, 1), mutant: bool = False):
    """One train step of `cfg` from seeded weights (seed 21) on `dev`, on
    rows `rows` of 2 seeded 3 s segments with mic shifts 1 and 4 (dropout
    0): its parity.step_record, its seconds, and the signs of every ReLU
    input of the forward pass (each FFN's w1 output, each conv module's
    batch-norm output) on the CPU. mutant: TRAIN_MUTANT's gradient negated
    after the clip."""
    from notsofar_tpu_torch.models.conformer import ConvModule, FeedForward
    from notsofar_tpu_torch.training import parity
    from notsofar_tpu_torch.training import train as T

    rng = np.random.RandomState(30)
    direct = (rng.randn(2, 48000, 7, 3) * 0.05).astype(np.float32)
    noise = (rng.randn(2, 48000, 7) * 0.01).astype(np.float32)
    rows = list(rows)
    batch = {k: torch.from_numpy(v[rows]).to(dev) for k, v in
             {"mixture": direct.sum(-1) + noise,
              "gt_spk_direct_early_echoes": direct, "gt_noise": noise}.items()}
    shifts = torch.tensor([1, 4], device=dev)[rows]
    model = T.get_model(cfg, dev, seed=21)
    state = T.init_state(model, cfg)
    step, _ = T.make_train_step(model, cfg)
    signs = []
    for mod in model.module.modules():
        pre = mod.w1 if isinstance(mod, FeedForward) else \
            mod.bn if isinstance(mod, ConvModule) else None
        if pre is not None:
            pre.register_forward_hook(
                lambda m, i, o: signs.append((o > 0).cpu()))
    clip = T.clip_by_global_norm
    if mutant:
        p = model.module.get_parameter(TRAIN_MUTANT)

        def clip_and_flip(params, max_norm):
            norm = clip(params, max_norm)
            p.grad.neg_()
            return norm
        T.clip_by_global_norm = clip_and_flip
    before = {n: q.detach().clone()
              for n, q in model.module.named_parameters()}
    try:
        t0 = time.perf_counter()
        metrics = step(state, batch, cfg.learning_rate,
                       torch.Generator(device=dev), shifts)
        if dev == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        T.clip_by_global_norm = clip
    return parity.step_record(state, before, metrics), secs, signs


def check_train_step():
    """Phase 10a: one train step of the full-width recipe on 2 seeded 3 s
    segments (dropout 0, mic shifts 1 and 4) on the card (TF32 off) and on
    the CPU from the same seeded weights, held by training/parity.py: the
    loss, side info and gradient norm within CARD_SCALAR_RTOL relative;
    gradients, AdamW moments and running statistics within CARD_RTOL of
    their scale; each update element within Adam's step over the moments'
    box; and the card's update AdamW's step from the card's own moments
    (parity.adam_mismatches). The card's step with one gradient's sign
    flipped after the clip must fall outside. Logged beside it: the ReLU
    inputs whose sign differs between the devices, and the same errors
    between the CPU and the CPU with the batch's two rows swapped (the
    same math, sums in another order)."""
    from unittest import mock

    from notsofar_tpu_torch.models import conformer
    from notsofar_tpu_torch.training import parity
    from notsofar_tpu_torch.training import train as T

    cfg = recipe_config()
    lr = cfg.learning_rate
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        got, t_card, s_card = train_step_record(cfg, "cuda")
        ref, t_cpu, s_cpu = train_step_record(cfg, "cpu")
        swap, _, _ = train_step_record(cfg, "cpu", rows=(1, 0))
        bad, _, _ = train_step_record(cfg, "cuda", mutant=True)
        # cuDNN's TF32 at PyTorch's default (on): the port's guard alone
        # (utils.device.cudnn_f32 around the conv and the backward), then
        # the guard bypassed
        torch.backends.cudnn.allow_tf32 = True
        guarded = train_step_record(cfg, "cuda")
        with mock.patch.object(conformer, "cudnn_f32",
                               contextlib.nullcontext), \
                mock.patch.object(T, "cudnn_f32", contextlib.nullcontext):
            allowed = train_step_record(cfg, "cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()
    rtol, srtol = parity.CARD_RTOL, parity.CARD_SCALAR_RTOL
    kw = dict(lr=lr, weight_decay=cfg.weight_decay, scalar_rtol=srtol)
    mism = parity.step_mismatches(ref, got, rtol, **kw) + \
        parity.adam_mismatches(got, lr, cfg.weight_decay)
    mut = parity.step_mismatches(ref, bad, rtol, **kw)
    ratios = parity.error_ratios(ref, got, rtol, lr, srtol)
    noise = parity.error_ratios(ref, swap, rtol, lr, srtol)
    flips = sum(int((a != b).sum()) for a, b in zip(s_card, s_cpu))
    units = sum(a.numel() for a in s_cpu)
    n_params = sum(a.size for a in ref["grad"].values())
    log(f"train step, card against CPU (Conformer-large, {n_params} "
        f"parameters, 2 x 3 s, f32, TF32 off; card {t_card:.2f} s, "
        f"CPU {t_cpu:.2f} s): loss {got['scalars']['loss']!r} vs "
        f"{ref['scalars']['loss']!r}, grad norm "
        f"{got['scalars']['grad_norm']!r} vs {ref['scalars']['grad_norm']!r}")
    log(f"train step errors over their tolerance (scalars rtol "
        f"{srtol:g}, arrays {rtol:g} of their scale; <= 1 "
        "holds): " + ", ".join(f"{k} {v:.3g}" for k, v in ratios.items()
                               if k != "tight")
        + f"; update elements bounded within 0.1 lr: "
        f"{100 * ratios['tight']:.1f}%; ReLU inputs of another sign on the "
        f"card: {flips} of {units}")
    log("train step, the CPU with the batch's rows swapped against the CPU "
        "(the same math, sums in another order): " + ", ".join(
            f"{k} {v:.3g}" for k, v in noise.items() if k != "tight"))
    log(f"train step mutant ({TRAIN_MUTANT}'s gradient negated): "
        f"{len(mut)} mismatches, e.g. {mut[:3]}")
    for label, (rec, secs, signs) in (
            ("cuDNN TF32 off for the step (as above)", (got, t_card, s_card)),
            ("cuDNN TF32 on, the port's f32 guard", guarded),
            ("cuDNN TF32 on, the guard bypassed", allowed)):
        r = parity.error_ratios(ref, rec, rtol, lr, srtol)
        n_flip = sum(int((a != b).sum()) for a, b in zip(signs, s_cpu))
        log(f"train step TF32, {label}: card against CPU, gradients "
            f"{100 * rtol * r['grad']:.3f}% and first moments "
            f"{100 * rtol * r['exp_avg']:.3f}% of their scale, ReLU sign "
            f"flips {n_flip} of {units}; loss {rec['scalars']['loss']!r}; "
            f"card {secs:.3f} s")
    if mism:
        raise AssertionError(f"train step card vs CPU: {mism[:10]}")
    if not any(m.startswith(f"update {TRAIN_MUTANT}") for m in mut):
        raise AssertionError(f"the train-step mutant was not caught: {mut}")


def run_training(work: Path) -> dict:
    """Phase 10b-d on the card at the recipe's full width with batch
    TRAIN_BATCH: run_training_css for 8 iterations (eval and save every
    4) on a seeded simulated partition of 256 segments, each step timed
    after a device sync; then the step-8 checkpoint restored into a fresh
    state (bit for bit, with the step counters) and 2 more iterations
    with resume=True; then the trained weights written by save_css_model
    and read by load_css_model on the card: the masks of one batch equal
    to the in-memory module's. Launch counts are reset before 10b and
    read after 10d; no hand-written kernel may launch. Returns them."""
    from notsofar_tpu_torch.css.inference import (load_css_model,
                                                  save_css_model)
    from notsofar_tpu_torch.ops import kernels
    from notsofar_tpu_torch.training import train as T

    t0 = time.perf_counter()
    train_dir = write_train_data(work / "train", 64, seed=40)
    val_dir = write_train_data(work / "val", 8, seed=41)
    out_dir = work / "run"
    cfg = recipe_config(global_batch_size=TRAIN_BATCH,
                       eval_every=(4, "iterations"),
                       save_every=(4, "iterations"),
                       stop_after=(8, "iterations"))
    log(f"train data: 64 + 8 utterances x 7.5 s x 7 mics written in "
        f"{time.perf_counter() - t0:.1f} s")

    make_step = T.make_train_step
    seen = {"state": None, "ms": [], "host_ms": [], "gaps": [], "losses": []}

    def timed_make_train_step(model, cfg):
        train_step, eval_step = make_step(model, cfg)
        last = {"end": None}

        def timed_step(state, *args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            if last["end"] is not None:
                seen["gaps"].append(start - last["end"])
            metrics = train_step(state, *args, **kwargs)
            seen["host_ms"].append(1e3 * (time.perf_counter() - start))
            torch.cuda.synchronize()
            last["end"] = time.perf_counter()
            seen["ms"].append(1e3 * (last["end"] - start))
            seen["losses"].append(metrics["loss"])
            seen["state"] = state
            return metrics
        return timed_step, eval_step

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    T.make_train_step = timed_make_train_step
    try:
        t0 = time.perf_counter()
        T.run_training_css(cfg, str(train_dir), str(val_dir), str(out_dir),
                           device="cuda")
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms, gaps = list(seen["ms"]), list(seen["gaps"])
        host = float(np.median(seen["host_ms"][2:8]))
        losses = [float(v) for v in seen["losses"]]
        trained = seen["state"]

        # 10c: restore into a fresh state, bit for bit, then 2 more steps
        fresh = T.init_state(T.get_model(cfg, "cuda", seed=99), cfg)
        fresh, sched = T.restore_checkpoint(str(out_dir), fresh)
        a = trained.model.module.state_dict()
        b = fresh.model.module.state_dict()
        same_model = a.keys() == b.keys() and all(torch.equal(a[k], b[k])
                                                  for k in a)
        oa, ob = trained.optimizer.state_dict(), fresh.optimizer.state_dict()
        same_opt = oa["param_groups"] == ob["param_groups"] and all(
            torch.equal(st[k], ob["state"][i][k])
            for i, st in oa["state"].items() for k in st)
        del fresh, a, b, oa, ob
        seen.update(ms=[], gaps=[], losses=[])
        T.run_training_css(recipe_config(
            global_batch_size=TRAIN_BATCH, eval_every=(4, "iterations"),
            save_every=(4, "iterations"), stop_after=(2, "iterations")),
            str(train_dir), str(val_dir), str(out_dir), resume=True,
            device="cuda")
        resumed_losses = [float(v) for v in seen["losses"]]
        resumed = seen["state"]
    finally:
        T.make_train_step = make_step
    last = torch.load(max((out_dir / "checkpoints").glob("*.pt"),
                          key=lambda p: int(p.stem)), weights_only=True)

    # 10d: the native save, read back on the card
    save_css_model(work / "native", resumed.model.module.state_dict(), cfg)
    loaded, _ = load_css_model(work / "native", device="cuda")
    seg = int(cfg.segment_len_secs * cfg.fs)
    mix = torch.from_numpy(np.stack([
        np.fromfile(f, np.int16).reshape(-1, 7)[:seg] / np.float32(30000.0)
        for f in sorted(val_dir.glob("*.mixture"))[:4]]).astype(np.float32))
    mix = mix.cuda()
    resumed.model.train(False)
    want = resumed.model.forward(mix)
    got = loaded.forward(mix)
    same_masks = all(torch.equal(want[k], got[k]) for k in want)
    counts = dict(kernels.LAUNCHES)

    steady = ms[2:8]
    med = float(np.median(steady))
    # the wait before each of steps 3-8, but step 5's follows an eval and
    # a checkpoint
    waits = [gaps[k - 2] for k in (3, 4, 6, 7, 8)]
    steps = [ms[k - 1] / 1e3 for k in (3, 4, 6, 7, 8)]
    wait_share = sum(waits) / (sum(waits) + sum(steps))
    log(f"train (Conformer-large, f32, batch {TRAIN_BATCH} x 3 s, "
        f"{len(ms)} steps, eval and save every 4): ms a step "
        f"{[round(x, 2) for x in ms]}; median of steps 3-8 {med:.2f} ms "
        f"= {TRAIN_BATCH * 1e3 / med:.1f} segments/s, of which the host "
        f"enqueues for {host:.2f} ms; loader wait before "
        f"steps 3, 4, 6-8 {[round(1e3 * w, 1) for w in waits]} ms, "
        f"{100 * wait_share:.1f}% of their wall; 8 iterations in "
        f"{wall:.1f} s wall with evals and checkpoints; "
        f"max_memory_allocated {peak:.2f} GiB ({peak - base:.2f} GiB above "
        f"the {base:.2f} GiB held before the run)")
    log(f"train losses {losses}; resumed {resumed_losses}")
    log(f"train resume: restored step {trained.step}, scheduler step "
        f"{sched}, model equal {same_model}, optimizer equal {same_opt}; "
        f"after 2 more steps checkpoint step {last['step']}, scheduler "
        f"step {last['scheduler_step']}; native save -> load_css_model "
        f"masks equal {same_masks}")
    log(f"train: kernel launches {counts}")
    if len(ms) != 8 or len(resumed_losses) != 2 or not all(
            math.isfinite(x) for x in losses + resumed_losses):
        raise AssertionError(f"train: steps or losses {losses} "
                             f"{resumed_losses}")
    if (trained.step, sched) != (8, 8) or not (same_model and same_opt):
        raise AssertionError("train: the restored state differs")
    if (last["step"], last["scheduler_step"]) != (10, 10):
        raise AssertionError(f"train resume: counters {last['step']}, "
                             f"{last['scheduler_step']}")
    if not same_masks:
        raise AssertionError("train: native save masks differ")
    if any(counts.values()):
        raise AssertionError(f"train: kernels launched {counts}")
    return counts


# --------------------------------------------------------------------------
# phase 11: the real-weight validator on seeded checkpoints of every format
# --------------------------------------------------------------------------

VALIDATE_CHECKS = (("css-mc", "check_css_mc"), ("css-sc", "check_css_sc"),
                   ("whisper", "check_whisper"), ("titanet", "check_titanet"),
                   ("marblenet", "check_marblenet"), ("msdd", "check_msdd"),
                   ("e2e-wer", "check_e2e"),
                   ("int8-wer-delta", "check_int8_wer_delta"))
# the kernels the validator's Whisper round trip (greedy, word timestamps)
# launches; a profiler trace names each as <name>_kernel (or
# <name>_f32_kernel)
WHISPER_KERNELS = ("encoder_mha", "attn_step", "xattn_step", "decode_gemv")
TRACE_DIR = OUT / "validate_trace"
TRACE_MAX_BYTES = 24 << 20   # what a chip call may bring back is limited


def nemo_titanet_state(cfg, seed: int, n_classes: int = 10) -> dict:
    """A seeded NeMo EncDecSpeakerLabelModel state dict of a TitaNet shape
    (the layout of titanet_large.nemo: per JasperBlock repeat five mconv
    slots, dw conv, pw conv, batch norm, with squeeze-excite appended at
    5 * (repeat - 1) + 3; the residual as res.0.0 + res.0.1; the attentive
    pooling's TDNN, tanh and conv; emb_layers.0 with an affine-free batch
    norm; the bias-free head). Weights at 1/sqrt(fan_in), batch norms away
    from identity."""
    rng = np.random.RandomState(seed)
    sd = {}

    def r(*shape):
        return rng.randn(*shape) / math.sqrt(np.prod(shape[1:]))

    def bn(p, c, affine=True):
        if affine:
            sd[f"{p}.weight"] = 1.0 + 0.1 * rng.randn(c)
            sd[f"{p}.bias"] = 0.1 * rng.randn(c)
        sd[f"{p}.running_mean"] = 0.1 * rng.randn(c)
        sd[f"{p}.running_var"] = 0.5 + rng.rand(c)

    def block(idx, c_in, c_out, kernel, repeat, residual, se):
        p, ci = f"encoder.encoder.{idx}", c_in
        for rep in range(repeat):
            sd[f"{p}.mconv.{5 * rep}.conv.weight"] = r(ci, 1, kernel)
            sd[f"{p}.mconv.{5 * rep + 1}.conv.weight"] = r(c_out, ci, 1)
            bn(f"{p}.mconv.{5 * rep + 2}", c_out)
            ci = c_out
        if se:
            si = 5 * (repeat - 1) + 3
            sd[f"{p}.mconv.{si}.fc.0.weight"] = r(c_out // cfg.se_reduction,
                                                   c_out)
            sd[f"{p}.mconv.{si}.fc.2.weight"] = r(c_out,
                                                   c_out // cfg.se_reduction)
        if residual:
            sd[f"{p}.res.0.0.conv.weight"] = r(c_out, c_in, 1)
            bn(f"{p}.res.0.1", c_out)

    block(0, cfg.n_mels, cfg.filters, cfg.prologue_kernel, 1, False,
          cfg.prologue_se)
    for bi, k in enumerate(cfg.block_kernels):
        block(1 + bi, cfg.filters, cfg.filters, k, cfg.block_repeat, True,
              True)
    block(1 + len(cfg.block_kernels), cfg.filters, cfg.epilogue_filters, 1,
          1, False, cfg.epilogue_se)
    C, A, E = cfg.epilogue_filters, cfg.attention_dim, cfg.emb_dim
    pool = "decoder._pooling.attention_layer"
    sd[f"{pool}.0.conv_layer.weight"] = r(A, 3 * C, 1)
    sd[f"{pool}.0.conv_layer.bias"] = 0.1 * rng.randn(A)
    bn(f"{pool}.0.bn", A)
    sd[f"{pool}.2.weight"] = r(C, A, 1)
    sd[f"{pool}.2.bias"] = 0.1 * rng.randn(C)
    sd["decoder.emb_layers.0.0.weight"] = r(E, 2 * C)
    sd["decoder.emb_layers.0.0.bias"] = 0.1 * rng.randn(E)
    bn("decoder.emb_layers.0.1", E, affine=False)
    sd["decoder.final.weight"] = r(n_classes, E)
    return sd


def write_validate_checkpoints(models: Path) -> None:
    """Beside phase 8's MC reference .pt and Whisper .pt: the SC
    Conformer-large in the native format (save_css_model:
    params.msgpack), and titanet_large.nemo (TitaNetConfig()),
    vad_multilingual_marblenet.nemo (DEFAULT_BLOCKS, classifier bias 0,
    so that the oracle's bound reads the network and not a constant) and
    diar_msdd_telephonic.nemo (MSDDConfig()), all seeded."""
    from notsofar_tpu_torch.css.inference import save_css_model
    from notsofar_tpu_torch.models.css_wrapper import CssModel
    from notsofar_tpu_torch.models.marblenet import MarbleNetConfig
    from notsofar_tpu_torch.models.msdd import MSDDConfig
    from notsofar_tpu_torch.models.titanet import TitaNetConfig
    from notsofar_tpu_torch.training.config import (ConformerCfgM,
                                                    ConformerCssCfgM,
                                                    ExtractorCfgM, NnetCfgM,
                                                    TrainCfg)
    t0 = time.perf_counter()
    sc_cfg = TrainCfg(conformer_css_cfg=ConformerCssCfgM(
        extractor_conf=ExtractorCfgM(ipd_index=""),
        nnet_conf=NnetCfgM(in_features=257, conformer_conf=ConformerCfgM(
            attention_dim=512, attention_heads=8, num_blocks=18,
            dropout_rate=0.0))))
    sc = CssModel(sc_cfg.conformer_css_cfg.freeze(), device="cuda", seed=13)
    save_css_model(models / "notsofar" / "conformer1.0" / "sc",
                   sc.module.state_dict(), sc_cfg)
    del sc
    write_nemo(models / "titanet_large.nemo",
               nemo_titanet_state(TitaNetConfig(), 23), {})
    mcfg = MarbleNetConfig()
    write_marblenet_nemo(models / "vad_multilingual_marblenet.nemo", mcfg,
                         nemo_marblenet_state(mcfg, 24, bias=0.0))
    write_nemo(models / "diar_msdd_telephonic.nemo",
               nemo_msdd_state(MSDDConfig(), 25), dict(name="msdd"))
    log(f"validate: checkpoints written in {time.perf_counter() - t0:.1f} "
        "s: css sc params.msgpack (Conformer-large), titanet_large.nemo, "
        "vad_multilingual_marblenet.nemo, diar_msdd_telephonic.nemo; "
        "phase 8's css mc model.pt and whisper/large-v3.pt")


def trace_kernels(trace_dir: Path) -> dict:
    """The profiler trace's device kernel events, counted per
    WHISPER_KERNELS entry, then the trace gzipped in place (Perfetto
    reads it so; dropped above TRACE_MAX_BYTES)."""
    import gzip
    files = sorted(trace_dir.glob("*.json"))
    if len(files) != 1:
        raise AssertionError(f"validate: {len(files)} trace files")
    events = json.loads(files[0].read_text())["traceEvents"]
    names = [e.get("name", "") for e in events
             if str(e.get("cat", "")).lower() == "kernel"]
    found = {k: sum(1 for n in names
                    if re.search(rf"\b{k}(_f32)?_kernel\b", n))
             for k in WHISPER_KERNELS}
    found["all kernels"] = len(names)
    gz = Path(str(files[0]) + ".gz")
    with gzip.open(gz, "wb") as f:
        f.write(files[0].read_bytes())
    files[0].unlink()
    size = gz.stat().st_size
    if size > TRACE_MAX_BYTES:
        gz.unlink()
        log(f"validate: the gzipped trace ({size} bytes) removed, over the "
            "output's room")
    return found


def check_lazy_separation(models: Path) -> None:
    """CssEngine.separate_uploaded_lazy on the card (the SC model): the
    scales come back, the int16 streams stay on the card until the lazy
    list is first read, and then equal separate_sessions_batch's."""
    from notsofar_tpu_torch.css.engine import CssCfg
    from notsofar_tpu_torch.css.inference import get_css_engine
    engine = get_css_engine(str(models), "notsofar/conformer1.0/sc",
                            CssCfg(), device="cuda")
    rng = np.random.RandomState(31)
    mix = (rng.randn(1, 20 * 16000, 1) * 0.1).astype(np.float32)
    up = engine.upload_sessions(engine.prepare_sessions([mix], 16000))
    lazy, (wav_dev, scales_dev, n_reals) = engine.separate_uploaded_lazy(up)
    deferred = lazy._host is None and wav_dev.is_cuda and scales_dev.is_cuda
    streams = lazy[0]
    want = engine.separate_sessions_batch([mix], 16000)[0]
    equal = all(np.array_equal(a, b) for a, b in zip(streams, want))
    log(f"validate: separate_uploaded_lazy streams {tuple(wav_dev.shape)} "
        f"{wav_dev.dtype} on {wav_dev.device} until first access "
        f"{deferred}; {len(streams)} streams of {n_reals[0]} samples after "
        f"it, equal to separate_sessions_batch {equal}")
    if not (deferred and equal and lazy._host is not None):
        raise AssertionError("validate: separate_uploaded_lazy")


# full-f32 MarbleNet and MSDD on the card: an order of magnitude above
# what f32 sums in another order gave on an H100 (rel 6.8e-07, max abs
# 6.0e-08) and below what cuDNN's TF32 gave there (2.8e-04, 8.1e-06)
F32_REL, F32_ABS = 1e-5, 1e-6


def tf32_effect(models: Path, V) -> None:
    """What cuDNN's default TF32 (torch.backends.cudnn.allow_tf32, on
    unless a caller turns it off) does to MarbleNet and the MSDD, which
    now run their convs and LSTM in full f32 (utils.device.cudnn_f32):
    the MarbleNet oracle's rel and the MSDD's probabilities against the
    CPU, with the guard (gated by F32_REL, F32_ABS), and with it bypassed
    and TF32 allowed (logged)."""
    from unittest import mock

    from notsofar_tpu_torch.models import marblenet, msdd
    from notsofar_tpu_torch.models.msdd import OverlapDecoder
    path = str(models / "diar_msdd_telephonic.nemo")
    cpu = OverlapDecoder.from_checkpoint(path, device="cpu")
    card = OverlapDecoder.from_checkpoint(path, device="cuda")
    c = cpu.cfg
    rng = np.random.RandomState(32)
    e = rng.randn(2, 256, c.n_scales, c.emb_dim).astype(np.float32)
    a = rng.randn(2, c.n_scales, c.emb_dim, 2).astype(np.float32)
    want = cpu.refine(e, a)
    out = {}
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for label, guard in (("f32", None), ("tf32",
                                             contextlib.nullcontext)):
            with contextlib.ExitStack() as stack:
                if guard is not None:
                    for mod in (marblenet, msdd):
                        stack.enter_context(mock.patch.object(
                            mod, "cudnn_f32", guard))
                V.RESULTS.clear()
                V.check_marblenet(str(models), torch.device("cuda"))
                rel = re.search(r"rel ([0-9.e+-]+)", V.RESULTS[-1][2])
                out[label] = (float(rel.group(1)) if rel else math.nan,
                              float(np.abs(card.refine(e, a) - want).max()))
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    log(f"validate: cuDNN in full f32 (the port): MarbleNet oracle rel "
        f"{out['f32'][0]:.3e}, MSDD card against CPU max abs "
        f"{out['f32'][1]:.3e} (gates {F32_REL}, {F32_ABS}); with cuDNN's "
        f"default TF32: rel {out['tf32'][0]:.3e}, max abs "
        f"{out['tf32'][1]:.3e}")
    if not (out["f32"][0] < F32_REL and out["f32"][1] < F32_ABS):
        raise AssertionError(f"validate: MarbleNet / MSDD not in f32 "
                             f"{out['f32']}")


def check_validate_mutants(models: Path, V, first: dict) -> None:
    """A one-tensor sign flip in the MarbleNet conversion (the last
    block's conv kernel) must FAIL marblenet on the oracle bound; the MC
    checkpoint overwritten with garbage must FAIL css-mc with rc 1 while
    every other model component keeps its status (no --meetings-dir, so
    both pipeline components SKIP)."""
    from unittest import mock

    from notsofar_tpu_torch.models import marblenet
    convert = marblenet.convert_nemo_marblenet

    def flipped(sd, cfg):
        v = convert(sd, cfg)
        blk = v["params"][f"block_{len(cfg.blocks) - 1}"]
        name = next(k for k in sorted(blk) if k.startswith("conv_"))
        blk[name]["kernel"] = -blk[name]["kernel"]
        return v

    with mock.patch.object(marblenet, "convert_nemo_marblenet", flipped):
        V.RESULTS.clear()
        flip = V.check_marblenet(str(models), torch.device("cuda"))
    flip_result = V.RESULTS[-1]
    (models / "notsofar" / "conformer1.0" / "mc" / "model.pt").write_bytes(
        b"not a checkpoint")
    rc = V.main(["--models-dir", str(models), "--whisper-model",
                 PIPELINE_WHISPER])
    status = {n: st for n, st, _ in V.RESULTS}
    log(f"validate mutants: sign flip -> {flip_result}; garbage MC .pt -> "
        f"rc {rc}, {status}")
    if flip is not None or "parity FAILED" not in flip_result[2]:
        raise AssertionError("validate: the sign-flip mutant passed")
    want = {n: first[n] for n in first}
    want.update({"css-mc": "FAIL", "e2e-wer": "SKIP",
                 "int8-wer-delta": "SKIP"})
    if rc != 1 or status != want:
        raise AssertionError(f"validate: garbage MC .pt gave rc {rc}, "
                             f"{status}, expected {want}")


def run_validate(work: Path) -> dict:
    """Phase 11: python -m notsofar_tpu_torch.tools.validate_real_weights
    run in process (validate_real_weights.main) on phase 8's models dir
    and meeting, with seeded checkpoints of every format at published
    widths written beside phase 8's. Every component must PASS, rc 0. Each
    component is timed (synchronized) and its kernel launches counted
    (counts reset before each); the Whisper component runs under
    utils.profiling.trace into chiprun_out/validate_trace/, whose device
    events must name its four kernels. Then separate_uploaded_lazy on the
    card, TF32's effect on MarbleNet and the MSDD (logged), and the two
    mutants. Returns the launches of the validator's run."""
    import os
    from notsofar_tpu_torch.asr import decoding as dec
    from notsofar_tpu_torch.ops import kernels
    from notsofar_tpu_torch.tools import validate_real_weights as V
    from notsofar_tpu_torch.utils.profiling import trace

    t_phase = time.perf_counter()
    models, meetings = work / "models", work / "meetings"
    write_validate_checkpoints(models)
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    for f in TRACE_DIR.glob("*"):
        f.unlink()
    per, total = {}, dict.fromkeys(kernels.LAUNCHES, 0)
    saved = {fn: getattr(V, fn) for _, fn in VALIDATE_CHECKS}

    def counted(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            kernels.reset_launches()
            t = time.perf_counter()
            with (trace(str(TRACE_DIR)) if name == "whisper"
                  else contextlib.nullcontext()):
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            per[name] = (time.perf_counter() - t,
                         {k: v for k, v in kernels.LAUNCHES.items() if v})
            for k, v in kernels.LAUNCHES.items():
                total[k] += v
            return out
        return run

    old_dir = os.environ.get("NOTSOFAR_MODELS_DIR")
    os.environ["NOTSOFAR_MODELS_DIR"] = str(models)
    try:
        for name, fn in VALIDATE_CHECKS:
            setattr(V, fn, counted(name, saved[fn]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dec.reset_decode_steps()
        t0 = time.perf_counter()
        rc = V.main(["--models-dir", str(models), "--meetings-dir",
                     str(meetings), "--whisper-model", PIPELINE_WHISPER,
                     "--out-dir", str(work / "validate_out")])
        wall = time.perf_counter() - t0
        log("validate: " + workspace_line())
        results = list(V.RESULTS)
        for name, fn in VALIDATE_CHECKS:
            setattr(V, fn, saved[fn])
        for name, status, detail in results:
            s, counts = per.get(name, (math.nan, {}))
            log(f"validate {name}: {status} in {s:.2f} s, launches "
                f"{counts}: {detail}")
        status = {n: st for n, st, _ in results}
        log(f"validate: rc {rc}, {len(results)} components in {wall:.1f} s")
        if rc != 0 or [n for n, _, _ in results] != [
                n for n, _ in VALIDATE_CHECKS] or set(status.values()) != {
                    "PASS"}:
            raise AssertionError(f"validate: rc {rc}, {status}")
        found = trace_kernels(TRACE_DIR)
        whisper = per["whisper"][1]
        log(f"validate whisper trace (chiprun_out/validate_trace/): kernel "
            f"events by name {found}; counted launches {whisper}")
        missing = [k for k in WHISPER_KERNELS
                   if not (found[k] > 0 and whisper.get(k, 0) > 0)]
        if missing:
            raise AssertionError(f"validate: whisper never ran {missing}")
        check_lazy_separation(models)
        tf32_effect(models, V)
        check_validate_mutants(models, V, status)
    finally:
        for name, fn in VALIDATE_CHECKS:
            setattr(V, fn, saved[fn])
        if old_dir is None:
            os.environ.pop("NOTSOFAR_MODELS_DIR", None)
        else:
            os.environ["NOTSOFAR_MODELS_DIR"] = old_dir
    log(f"validate: phase 11 in {time.perf_counter() - t_phase:.1f} s")
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from notsofar_tpu_torch.ops import build

    t_start = time.perf_counter()
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.log").write_text("")
    log("phase 1 card")
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    # xattn_step with its phase stamps (phase 2) builds beside the kernels
    from notsofar_tpu_torch.tools.time_decode_step import build_stamped
    stamped = threading.Thread(target=build_stamped, args=(ROOT,))
    stamped.start()
    logs = build.build_all()
    stamped.join()
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
    log("phase 3b graph, the decode loops graphed against eager")
    check_graph_decode()
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
        log("phase 6b diarization, time-based (nmesc, nmesc_msdd)")
        by_path["diarization_time"] = run_time_based(work, asr_dfs["beam5"])
        log("phase 7 css, Conformer-large + MVDR")
        by_path["css"] = run_css(work)
        log("phase 8 pipeline, inference_v1.yaml with int8 ASR")
        by_path["pipeline"] = run_pipeline(work)
        log("phase 11 validate, validate_real_weights on seeded checkpoints "
            "of every format")
        by_path["validate"] = run_validate(work)
    log("phase 9 tools, bench_xattn_variants and bisect_attn_split")
    by_path["tools"] = run_tools(
        next(r["ms"] for r in rows if r["name"] == "xattn_stream"))
    log("phase 10 train, the CSS training stack at Conformer-large width")
    check_train_step()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_",
                                     dir=OUT) as tmp:
        by_path["train"] = run_training(Path(tmp))
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
