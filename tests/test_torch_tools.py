"""The kernel-decomposition tools' kernels and entry points against the
JAX package's.

tools/bench_xattn_variants.py keeps its two Pallas bodies
(_stream_kernel, _onedot_kernel) inside main(); they are taken from the
unmodified file with ast and run through pl.pallas_call in interpret mode
with the tool's block shapes. tools/bisect_attn_split.py's kernel_only
runs PK._attn_step_split_kernel; here it runs with dk bound, on the
blocks attn_step_split passes it (q [1, K, D], bias [1, K, Pp + K*G],
out [1, K, D]). Each plain PyTorch version in notsofar_tpu_torch.ops.kernels
is held to the body on the same numpy inputs, and each tolerance is shown
to catch a fault. Then both port tools run end to end on the CPU at tiny
sizes, and the port's copy of utils/flops.py is held to the JAX package's.
"""
import ast
import contextlib
import functools
import io
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from notsofar_tpu.ops import pallas_kernels as pk
from notsofar_tpu.utils import flops as jflops
from notsofar_tpu_torch.ops import kernels as tk
from notsofar_tpu_torch.tools import (bench_xattn_variants, bisect_attn_split,
                                      time_attn_step, time_decode_step)
from notsofar_tpu_torch.utils import flops as tflops
from tests.test_torch_kernels import (bf16_round, onedot_rms_tolerance,
                                      onedot_rounding_mutant, rms,
                                      split_bias_tolerance, split_case, t,
                                      xattn_case, xattn_tolerance)

REPO = Path(__file__).resolve().parent.parent


@functools.lru_cache(maxsize=None)
def tool_bodies():
    """_stream_kernel and _onedot_kernel as tools/bench_xattn_variants.py
    defines them inside main()."""
    path = REPO / "tools" / "bench_xattn_variants.py"
    tree = ast.parse(path.read_text())
    defs = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
            and n.name in ("_stream_kernel", "_onedot_kernel")]
    assert len(defs) == 2
    ns = {"jax": jax, "jnp": jnp, "pl": pl, "pltpu": pltpu}
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(path), "exec"),
         ns)
    return ns["_stream_kernel"], ns["_onedot_kernel"]


def vmem(shape):
    return pl.BlockSpec(shape, lambda b: (b, 0, 0), memory_space=pltpu.VMEM)


def interpret(call, *args) -> np.ndarray:
    """Run an interpret-mode pallas_call as its source writes it. By
    default XLA on the CPU drops a round trip f32 -> bf16 -> f32 (excess
    precision allowed), which would remove the onedot body's rounding of
    each product v * p; compiled with it off, every astype rounds."""
    return np.asarray(jax.jit(call).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args))


def run_stream_body(q, k8, v8):
    """run_stream's pallas_call (tools/bench_xattn_variants.py:56)."""
    B, S, D = k8.shape
    call = pl.pallas_call(
        tool_bodies()[0], grid=(B,),
        in_specs=[vmem((1, 1, D)), vmem((1, S, D)), vmem((1, S, D))],
        out_specs=vmem((1, 1, D)),
        out_shape=jax.ShapeDtypeStruct((B, 1, D), jnp.float32),
        interpret=True)
    return interpret(call, jnp.asarray(q, jnp.bfloat16), jnp.asarray(k8),
                     jnp.asarray(v8))


def run_onedot_body(q, k8, v8, vs, dk, s_valid):
    """onedot (tools/bench_xattn_variants.py:96-121): the head-masked
    query built as the tool's wrapper builds it, then its pallas_call."""
    B, T, D = q.shape
    S = k8.shape[1]
    H = D // dk
    sel = (np.arange(D)[:, None] // dk
           == np.arange(H)[None, :]).astype(np.float32)
    qj = jnp.asarray(q, jnp.bfloat16)
    qp = (qj[:, 0, :, None] * jnp.asarray(sel)[None]).astype(jnp.bfloat16)
    kern = functools.partial(tool_bodies()[1], dk=dk, s_valid=s_valid)
    call = pl.pallas_call(
        kern, grid=(B,),
        in_specs=[vmem((1, D, H)), vmem((1, S, D)), vmem((1, S, D)),
                  vmem((1, 1, D))],
        out_specs=vmem((1, T, D)),
        out_shape=jax.ShapeDtypeStruct((B, T, D), jnp.float32),
        interpret=True)
    return interpret(call, qp, jnp.asarray(k8), jnp.asarray(v8),
                     jnp.asarray(vs).reshape(B, 1, D))


def run_split_body(q, kp, vp, kg, vg, bias, dk, dtype):
    """PK._attn_step_split_kernel with dk bound, on the blocks
    attn_step_split passes it (pallas_kernels.py:395-416); q [B, K, D],
    kg/vg [B, K*G, D] in dtype, bias [B, K, Pp + K*G] f32 -> [B, K, D]
    f32."""
    B, K, D = q.shape
    Pp, Ng = kp.shape[1], kg.shape[1]
    kern = functools.partial(pk._attn_step_split_kernel, dk=dk)
    call = pl.pallas_call(
        kern, grid=(B,),
        in_specs=[vmem((1, K, D)), vmem((1, Pp, D)), vmem((1, Pp, D)),
                  vmem((1, Ng, D)), vmem((1, Ng, D)),
                  vmem((1, K, Pp + Ng))],
        out_specs=vmem((1, K, D)),
        out_shape=jax.ShapeDtypeStruct((B, K, D), jnp.float32),
        interpret=True)
    return interpret(call, *(jnp.asarray(x, dtype)
                             for x in (q, kp, vp, kg, vg)),
                     jnp.asarray(bias))


# ---------------------------------------------------------------------------
# xattn_stream: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,D", [(2, 64, 128), (3, 96, 256), (2, 5, 128)])
def test_xattn_stream_plain_equals_the_tool_body(B, S, D):
    """Bit for bit: sums of int8 values are exact in f32, so both round
    once, at the product with 1e-6. S = 5 takes the rows there are. The
    checksum is the sum of every K and V byte of the row; changing one
    byte of a row past the first 8 changes it, and not the output."""
    rng = np.random.RandomState(S + D)
    q = bf16_round(rng.randn(B, 1, D).astype(np.float32))
    k8, v8 = (rng.randint(-127, 128, (B, S, D)).astype(np.int8)
              for _ in range(2))
    want = run_stream_body(q, k8, v8)
    out, checksum = tk.xattn_stream(t(k8), t(v8))
    assert out.dtype == torch.float32 and out.shape == (B, 1, D)
    assert np.array_equal(out.numpy(), want)
    assert checksum.dtype == torch.int32
    assert np.array_equal(checksum.numpy(),
                          k8.astype(np.int64).sum((1, 2))
                          + v8.astype(np.int64).sum((1, 2)))
    k_mut = k8.copy()
    k_mut[0, 0, 0] = -k_mut[0, 0, 0] if k_mut[0, 0, 0] else 1
    assert not np.array_equal(tk.xattn_stream(t(k_mut), t(v8))[0].numpy(),
                              want)
    if S > 8:
        v_mut = v8.copy()
        v_mut[B - 1, S - 1, D - 1] ^= 1
        out_m, sum_m = tk.xattn_stream(t(k8), t(v_mut))
        assert np.array_equal(out_m.numpy(), want)
        assert sum_m[B - 1] != checksum[B - 1]


# ---------------------------------------------------------------------------
# xattn_onedot: max and RMS gates; the unrounded product falls outside
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,D,dk,s_valid,q_scale", [
    (2, 96, 128, 64, 77, 0.004),     # unit-scale logits, keys masked
    (2, 64, 256, 128, 64, 0.004),
    (2, 96, 384, 64, 96, 0.1)])      # the tool's q scale: peaked weights
def test_xattn_onedot_plain_matches_the_tool_body(B, S, D, dk, s_valid,
                                                  q_scale):
    """Within xattn_tolerance with flip 2**-6 (each product rounded) and
    onedot_rms_tolerance; the key of the largest logit negated is outside
    the max tolerance, and at unit-scale logits the products left
    unrounded are outside the RMS tolerance. The body's lane d takes head
    d % H's weights (pltpu.repeat tiles), so it is far from xattn_int8's
    attention, which takes head d // dk's."""
    rng = np.random.RandomState(S + D + dk)
    q, k8, v8, vs = xattn_case(rng, B, 1, D, dk, S, s_valid, q_scale)
    want = run_onedot_body(q, k8, v8, vs, dk, s_valid)
    qt = t(q).bfloat16()
    got = tk.xattn_onedot(qt, t(k8), t(v8), t(vs), dk, s_valid)
    assert got.dtype == torch.float32 and got.shape == (B, 1, D)
    tol = xattn_tolerance(q, k8, vs, dk, s_valid, flip=2.0 ** -6)
    err = np.abs(got.numpy() - want).max()
    assert err <= tol, (err, tol)
    rms_tol = onedot_rms_tolerance(q, k8, v8, vs, dk, s_valid)
    assert rms(got.numpy() - want) <= rms_tol
    top = int((k8[0, :s_valid, :dk].astype(np.float64)
               @ q[0, 0, :dk].astype(np.float64)).argmax())
    k_mut = k8.copy()
    k_mut[0, top] = -k8[0, top]
    moved = tk.xattn_onedot_plain(qt, t(k_mut), t(v8), t(vs), dk, s_valid)
    assert np.abs(moved.numpy() - want).max() > tol
    if q_scale < 0.01:
        unrounded = onedot_rounding_mutant(qt, t(k8), t(v8), t(vs), dk,
                                           s_valid)
        assert rms(unrounded.numpy() - want) > rms_tol
    attention = tk.xattn_int8_plain(qt, t(k8), t(v8), t(vs), dk, s_valid)
    assert np.abs(attention.numpy() - want).max() > 0.1 * np.abs(want).max()


# ---------------------------------------------------------------------------
# attn_step_split_bias: derived tolerance; fully masked rows; finite bias
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,bias_kind,K", [
    pytest.param(torch.bfloat16, "visibility", 3, id="dtype0-visibility"),
    pytest.param(torch.bfloat16, "finite", 3, id="dtype0-finite"),
    pytest.param(torch.float32, "visibility", 3, id="dtype1-visibility"),
    pytest.param(torch.float32, "finite", 3, id="dtype1-finite"),
    # past the 8 beams the first CUDA kernel took (the TPU body takes any)
    pytest.param(torch.bfloat16, "finite", 9, id="dtype0-finite-K9"),
])
def test_attn_step_split_bias_plain_matches_the_kernel_body(bias_kind,
                                                            dtype, K):
    """B 2, K 3 (and 9), Pp 16, G 8. Within split_bias_tolerance of the
    TPU body; the fully masked row is the uniform average of the values,
    as the body gives it; the key of the largest weight of a visible row
    negated is outside the tolerance."""
    rng = np.random.RandomState(11 + len(bias_kind))
    q, kp, vp, kg, vg, bias = split_case(rng, 2, K, 16, 8, bias_kind)
    dk = 64
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = run_split_body(q, kp, vp, kg, vg, bias, dk, jdt)
    args = [t(x).to(dtype) for x in (q, kp, vp, kg, vg)]
    got = tk.attn_step_split_bias(*args, t(bias), dk)
    assert got.dtype == torch.float32 and got.shape == q.shape
    keys = np.concatenate([kp, kg], 1)
    vals = np.concatenate([vp, vg], 1)
    tol = split_bias_tolerance(q, keys, vals, bias, dk)
    err = np.abs(got.numpy() - want).max()
    assert err <= tol, (err, tol)
    # the masked row: weights bf16(1 / ncol) (f32 when dtype is), summed
    # in f32 within ncol roundings
    ncol = keys.shape[1]
    p_u = torch.tensor(1.0 / ncol).to(dtype).float().item()
    uniform = p_u * vals[0].astype(np.float64).sum(0)
    u_tol = ncol * 2.0 ** -24 * p_u * np.abs(vals[0]).sum(0).max()
    assert np.abs(want[0, 1] - uniform).max() <= u_tol
    assert np.abs(got[0, 1].numpy() - uniform).max() <= u_tol
    assert np.isfinite(got.numpy()).all()
    lg = (q[1, 0, :dk].astype(np.float64) @ keys[1, :, :dk].T.astype(
        np.float64)) + bias[1, 0]
    top = int(lg.argmax())
    k_mut = keys.copy()
    k_mut[1, top] = -keys[1, top]
    moved = tk.attn_step_split_bias_plain(
        args[0], t(k_mut[:, :16]).to(dtype), args[2],
        t(k_mut[:, 16:]).to(dtype), args[4], t(bias), dk)
    assert np.abs(moved.numpy() - want).max() > tol


# ---------------------------------------------------------------------------
# the tools end to end on the CPU, and their default device
# ---------------------------------------------------------------------------

def run_tool(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().splitlines()


def test_bench_xattn_variants_runs_on_the_cpu():
    lines = run_tool(bench_xattn_variants.main,
                     ["--device", "cpu", "--batch", "2", "--s", "64", "--d",
                      "128", "--layers", "2", "--iters", "1"])
    assert lines[0].startswith("device: cpu")
    # onedot's lanes take another head's weights than xattn_int8's (the
    # tool's pltpu.repeat tiles): the line shows the two apart, as the
    # plain versions on the tool's inputs have it
    rel = float(re.fullmatch(r"onedot vs current: rel maxdiff (\S+)",
                             lines[1]).group(1))
    q, kvs = bench_xattn_variants.make_inputs(2, 64, 128, 2, torch.device(
        "cpu"))
    k8, v8, vs = kvs[0]
    a = tk.xattn_int8_plain(q, k8, v8, vs, 64, 64)
    b = tk.xattn_onedot_plain(q, k8, v8, vs, 64, 64)
    assert rel == pytest.approx(((a - b).abs().max() / a.abs().max()).item(),
                                rel=1e-2)
    assert rel > 0.1
    names = []
    for line in lines[2:5]:
        m = re.fullmatch(r"(\w+)\s*:\s+(\S+) ms  \(\s*(\S+) GB/s,\s+(\S+) "
                         r"ms/layer\)", line)
        names.append(m.group(1))
        assert float(m.group(2)) > 0
        # ms to 2 decimals, ms/layer to 3
        assert float(m.group(4)) == pytest.approx(float(m.group(2)) / 2,
                                                  abs=3e-3)
    assert names == ["stream", "current", "onedot"]
    assert lines[5].startswith("bound     : none on the cpu")


def test_bisect_attn_split_runs_on_the_cpu():
    lines = run_tool(bisect_attn_split.main,
                     ["--device", "cpu", "--batch", "2", "--beams", "3",
                      "--prompt", "16", "--gen", "8", "--d", "128",
                      "--iters", "1"])
    assert lines[0].startswith("device: cpu")
    rows = [re.fullmatch(r"(\S+): (\S+) ms/call", x) for x in lines[1:5]]
    assert [m.group(1) for m in rows] == ["pack(bias)", "kernel_only",
                                          "full", "library"]
    assert all(float(m.group(2)) > 0 for m in rows)
    assert lines[5].startswith("diag unpack: none")
    assert lines[6].startswith("bound: none on the cpu")


def test_bisect_rows_compute_the_same_attention():
    """kernel_only on split_visibility_bias's bias, full, and the SDPA
    yardstick give one attention (the tool's inputs at a tiny size)."""
    B, Kb, Pp, G, D, dk = 2, 3, 16, 8, 128, 64
    g = torch.Generator().manual_seed(0)
    q, kg, vg = (torch.randn(s, generator=g).bfloat16()
                 for s in ((B * Kb, 1, D), (B * Kb, G, D), (B * Kb, G, D)))
    kp, vp = (torch.randn(B, Pp, D, generator=g).bfloat16() for _ in range(2))
    pads = torch.tensor([0, 5], dtype=torch.int32)
    bias = tk.split_visibility_bias(B, Kb, Pp, G, G // 2, pads, None)
    split = tk.attn_step_split_bias(q.view(B, Kb, D), kp, vp,
                                    kg.view(B, -1, D), vg.view(B, -1, D),
                                    bias, dk)
    full = tk.attn_step_split(q, kp, vp, kg, vg, G // 2, pads, dk, Kb)
    assert torch.equal(full.view(B, Kb, D), split)
    H = D // dk
    ql = q.view(B, Kb, H, dk).transpose(1, 2).float()
    kl, vl = (torch.cat([p_, g_.view(B, -1, D)], 1).view(B, -1, H, dk)
              .transpose(1, 2).float() for p_, g_ in ((kp, kg), (vp, vg)))
    lib = torch.nn.functional.scaled_dot_product_attention(
        ql, kl, vl, attn_mask=bias[:, None], scale=1.0)
    # the yardstick keeps p in f32: within a bf16 rounding of each weight
    assert (lib.transpose(1, 2).reshape(B, Kb, D) - split).abs().max() \
        <= 2.0 ** -8 * vl.abs().max()


@pytest.mark.parametrize("main", [bench_xattn_variants.main,
                                  bisect_attn_split.main])
def test_tools_default_to_cuda_and_raise_without_a_card(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--iters", "1"])


def test_time_attn_step_raises_without_a_card(tmp_path, monkeypatch):
    """tools/time_attn_step.py times a checkout's kernel on the card only
    (it has no plain path to time)."""
    traffic = tmp_path / "traffic.json"
    traffic.write_text('{"asr greedy": [[3, 256, 4, 32]]}')
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        time_attn_step.main(["--traffic", str(traffic), "--root",
                             str(REPO)])


def test_time_decode_step_raises_without_a_card(monkeypatch):
    """tools/time_decode_step.py times a checkout's decode step on the card
    only."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        time_decode_step.main(["--root", str(REPO)])


def test_time_decode_step_loops_mode_raises_without_a_card(monkeypatch):
    """--loops times a checkout's whole decode calls, on the card only."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        time_decode_step.main(["--loops", "--root", str(REPO), "--dtype",
                               "int8", "--calls", "1"])


def test_time_decode_step_phases_mode_raises_without_a_card(monkeypatch):
    """--phases times xattn_step's phases apart, on the card only."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        time_decode_step.main(["--phases", "--root", str(REPO)])


def test_build_extra_flags_name_their_own_library(monkeypatch, tmp_path):
    """ops/build.py: a library built with extra nvcc flags (the stamped
    xattn_step) gets a name of its own and those flags on its nvcc line;
    without them the name is the kernels' usual one. nvcc is stubbed by a
    script that writes its -o file."""
    from notsofar_tpu_torch.ops import build
    stamps = time_decode_step.STAMPS
    assert build.lib_path("xattn_step", ()) == build.lib_path("xattn_step")
    assert build.lib_path("xattn_step", stamps) != \
        build.lib_path("xattn_step")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\necho "$@"\nwhile [ "$1" != -o ]; do shift; '
                    'done\ntouch "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    logs = build.build_all(["xattn_step"], stamps)
    assert build.lib_path("xattn_step", stamps).exists()
    assert not build.lib_path("xattn_step").exists()
    assert stamps[0] in logs["xattn_step"].split()
    assert build.build_all(["xattn_step"], stamps) == {}


def test_stamp_summary_reads_phases_from_the_stamps():
    """xattn_step's phase stamps [launches, blocks, 9, (clock64,
    globaltimer)] -> per-phase microseconds (cycles over the clock rate
    that globaltimer gives), the block that ended last, each launch's
    span, spread of starts and gap to the next; launch 1 (cold) left out.
    Synthetic: a 2 GHz clock, phase i of block b lasting (i + 1 + b)
    microseconds, block b starting b us after its launch, launches 20 us
    apart."""
    L, B = 3, 2
    st = np.zeros((L, B, 9, 2), dtype=np.int64)
    for n in range(L):
        for b in range(B):
            t = 20.0 * n + b
            for i in range(9):
                st[n, b, i] = (round(t * 2000), round(t * 1000))
                if i < 8:
                    t += i + 1 + b
    r = time_decode_step.stamp_summary(st)
    assert r["ghz"] == pytest.approx(2.0)
    phases = time_decode_step.STAMP_PHASES
    assert list(r["mean_us"]) == list(phases)
    for i, p in enumerate(phases):
        assert r["mean_us"][p] == pytest.approx(i + 1.5)
        assert r["last_block_us"][p] == pytest.approx(i + 2)
    assert r["block_us"] == pytest.approx(36 + 4)
    assert r["span_us"] == pytest.approx(1 + 36 + 8)
    assert r["start_spread_us"] == pytest.approx(1.0)
    assert r["gap_us"] == pytest.approx(20 - 45)


@pytest.mark.parametrize("kernels,share", [
    ([("a", 0.0, 10.0)], 1.0),
    ([("a", 0.0, 4.0), ("b", 6.0, 10.0)], 0.8),          # a gap of 2
    ([("a", 0.0, 6.0), ("b", 4.0, 10.0), ("c", 12.0, 20.0)], 0.9),
    ([("c", 12.0, 20.0), ("a", 0.0, 6.0), ("b", 2.0, 5.0)], 0.7)])
def test_busy_share_is_the_union_of_kernel_intervals(kernels, share):
    """The replayed step's busy share: the union of the kernels' intervals
    (overlaps counted once, in any order) over the span from the first
    start to the last end."""
    assert time_decode_step.busy_share(kernels) == pytest.approx(share)


# ---------------------------------------------------------------------------
# utils/flops.py: the copy's stage models and the card's peaks
# ---------------------------------------------------------------------------

def test_flops_stage_models_equal_the_jax_package():
    from notsofar_tpu_torch.models.whisper import WhisperDims
    dims = WhisperDims(128, 1500, 1280, 20, 32, 51866, 448, 1280, 20, 32)
    for name in ("whisper_encoder_flops", "whisper_decoder_params"):
        assert getattr(tflops, name)(dims) == getattr(jflops, name)(dims)
    assert tflops.whisper_decode_step_flops(dims, 24) == \
        jflops.whisper_decode_step_flops(dims, 24)
    assert tflops.whisper_decode_step_bytes(dims, batch=24) == \
        jflops.whisper_decode_step_bytes(dims, batch=24)
    assert tflops.whisper_alignment_flops(dims, 50) == \
        jflops.whisper_alignment_flops(dims, 50)
    assert tflops.conformer_css_flops(186) == jflops.conformer_css_flops(186)
    assert tflops.titanet_flops(320) == jflops.titanet_flops(320)
    peaks = tflops.device_peaks("NVIDIA H100 80GB HBM3")
    assert tflops.StageCost("x", 1e12, 2.0, 1e9).report(peaks) == \
        jflops.StageCost("x", 1e12, 2.0, 1e9).report(peaks)


def test_device_peaks_are_the_h100s_and_unknown_cards_raise(monkeypatch):
    peaks = tflops.device_peaks("NVIDIA H100 80GB HBM3")
    assert (peaks["bf16"], peaks["f32"], peaks["hbm_gbps"]) == \
        (989e12, 67e12, 3.35e12)
    with pytest.raises(ValueError):
        tflops.device_peaks("NVIDIA H100 PCIe")
    with pytest.raises(ValueError):
        tflops.device_peaks("TPU v5 lite")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tflops.device_peaks()
