#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (notsofar_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py                  # about 200 s on one H100

Phases (any failure raises and exits non-zero):

1. card      print nvidia-smi's name and power limit.
2. kernels   build csrc/*.cu with nvcc (one process per source, all in
             parallel); at the large-v3 shapes of the ASR path hold each
             kernel against its plain PyTorch version, show that the
             tolerance would catch a change of one key, and time kernel,
             plain version and one PyTorch library call (CUDA events, L2
             flushed before every call).
3. reference a small Whisper on the card against the same weights on the
             CPU (plain paths): encoder output (bf16 and f32), greedy
             and beam-3 decode tokens (f32, TF32 off).
4. asr beam  a seeded synthetic session of 3 streams x 40 s through
             asr_inference with the shipped config: Whisper large-v3 at
             full width, bf16, beam 5, word timestamps,
             condition_on_previous_text, seeded random weights.
             Launch counts are reset before the call and read after it:
             encoder_mha and attn_step_split must be > 0.
5. asr greedy the same session with beam_size=None (greedy + fallback
             ladder); counted the same way: encoder_mha and attn_step
             must be > 0.

The line before the last is {"kernels": [...]}, with each kernel's
launches summed over phases 4-5 and split by phase in
"launches_by_path"; the last line is {"ok": true, "device": {...}}. The
run writes under chiprun_out/: the kernels' ptxas report
(kernel_build.log) and, while it runs, the session's wavs and ASR
pickles (deleted at the end).
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
               nbytes, flops):
        """Hold `out` to `ref` within `tol`, and `mutant` (the plain
        version on inputs with one key changed) outside it, so the
        tolerance is shown to catch a one-key error; then time."""
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        moved = (out.float() - mutant.float()).abs().max().item()
        ms = time_cuda(fn, iters)
        plain_ms = time_cuda(plain, max(iters // 4, 3))
        lib_ms = time_cuda(library, iters) if library is not None else None
        b, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
        log(f"kernel {name}: max_abs_err {err:.3e} (tolerance {tol:.3e}; "
            f"max|ref| {ref.float().abs().max().item():.3e}, mean|ref| "
            f"{ref.float().abs().mean().item():.3e}; one key changed moves "
            f"it {moved:.3e}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
            f"bound {b:.4f} ms by {by} ({nbytes / 1e6:.3f} MB, "
            f"{flops / 1e9:.4f} GFLOP)")
        if not (math.isfinite(err) and err <= tol):
            raise AssertionError(f"{name}: max_abs_err {err} > {tol}")
        if not moved > tol:
            raise AssertionError(f"{name}: a one-key change moves the output "
                                 f"{moved}, within the tolerance {tol}")
        rows.append(dict(name=name, route="cuda",
                         source=f"notsofar_tpu_torch/csrc/{name}.cu",
                         replaces=replaces, launches=None,
                         launches_by_path=None, max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                         library_ms=lib_ms))

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
           None,
           nbytes=(2 * n_rows * D + Bs * Kb * D) * 2 + Bs * 4
           + Bs * Kb * n_gen * 4 + Bs * Kb * D * 4,
           flops=4 * D * (Kb * n_prompt + Bs * Kb * n_gen))
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
    counts."""
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

    by_path = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=OUT) as tmp:
        work = Path(tmp)
        session = write_session(work)
        log("phase 4 asr, beam 5")
        by_path["beam5"] = run_asr(session, work, 5, "beam5",
                                   ("encoder_mha", "attn_step_split"))
        log("phase 5 asr, greedy")
        by_path["greedy"] = run_asr(session, work, None, "greedy",
                                    ("encoder_mha", "attn_step"))
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
