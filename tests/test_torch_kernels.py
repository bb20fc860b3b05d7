"""notsofar_tpu_torch.ops.kernels against the JAX package's Pallas kernels.

On the CPU every wrapper takes its plain PyTorch version (the kernels are
CUDA-only); these tests hold those plain versions to the Pallas kernels in
interpret mode on the same numpy inputs. The `gpu`-marked tests hold each
CUDA kernel to its plain version on the card and skip without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from notsofar_tpu.ops import pallas_kernels as pk
from notsofar_tpu_torch.ops import kernels as tk


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    """Two torch threads per module while it runs (several pytest workers
    share the CPU), then the old setting back. Defined here rather than
    imported from tests/, so that this file also runs where another
    installed package is named `tests` (the card machine's gpu run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def bf16_round(x: np.ndarray) -> np.ndarray:
    """Round f32 numpy values to bf16 (the same values on both sides)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("S,dk,seed,BH", [
    pytest.param(621, 64, 7, 4, id="621-64-7"),
    pytest.param(512, 64, 8, 4, id="512-64-8"),
    pytest.param(1500, 64, 9, 2, id="1500-64-9-BH2"),   # the encode shape
])
def test_encoder_mha_plain_matches_pallas(S, dk, seed, BH):
    """621 pads to 1024 inside the Pallas wrapper (masked key padding);
    512 is block-aligned; 1500 (Whisper's encoder length) pads to 1536.
    bf16 inputs, bf16 output on both sides: tolerance one bf16 ulp of the
    output scale (2**-8 relative)."""
    rng = np.random.RandomState(seed)
    scale = dk ** -0.25
    q, k, v = (bf16_round(rng.randn(BH, S, dk).astype(np.float32) * 0.5)
               for _ in range(3))
    qs, ks = bf16_round(q * scale), bf16_round(k * scale)
    want = np.asarray(pk.encoder_mha(
        jnp.asarray(qs, jnp.bfloat16), jnp.asarray(ks, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), interpret=True)).astype(np.float32)
    got = tk.encoder_mha(t(qs).bfloat16(), t(ks).bfloat16(),
                         t(v).bfloat16())
    assert got.dtype == torch.bfloat16 and got.shape == (BH, S, dk)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2 ** -8 * np.abs(want).max(), err


@pytest.mark.parametrize("dk,H,ctx,pos,pads,pos_tensor", [
    pytest.param(64, 4, 64, 37, [0, 5, 12], False, id="64-4-64-37-pads0"),
    pytest.param(128, 2, 32, 10, [3, 0, 0], False, id="128-2-32-10-pads1"),
    pytest.param(64, 4, 64, 37, [0, 5, 12], True,
                 id="64-4-64-37-pads0-tensor"),
    pytest.param(128, 2, 32, 10, [3, 0, 0], True,
                 id="128-2-32-10-pads1-tensor"),
    # a row whose pad passes pos sees key pos alone
    pytest.param(64, 2, 48, 4, [0, 9, 4], True, id="64-2-48-4-pad-past-pos"),
])
def test_attn_step_plain_matches_pallas(dk, H, ctx, pos, pads, pos_tensor):
    """f32 caches with per-row left pads, pos as an int or as a 0-d int32
    tensor (the CUDA graph's form); tolerance 1e-5 (f32 sums in another
    order)."""
    rng = np.random.RandomState(dk + pos)
    B, D = len(pads), H * dk
    pads = np.asarray(pads, np.int32)
    q = rng.randn(B, 1, D).astype(np.float32) * 0.3 * dk ** -0.5
    kc = rng.randn(B, ctx, D).astype(np.float32) * 0.3
    vc = rng.randn(B, ctx, D).astype(np.float32) * 0.3
    want = np.asarray(pk.attn_step(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(pos, jnp.int32), jnp.asarray(pads), dk, interpret=True))
    slot = torch.tensor(pos, dtype=torch.int32) if pos_tensor else pos
    got = tk.attn_step(t(q), t(kc), t(vc), slot, t(pads), dk)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if pos_tensor:
        assert torch.equal(got, tk.attn_step(t(q), t(kc), t(vc), pos,
                                             t(pads), dk))


@pytest.mark.parametrize("K,with_anc", [
    pytest.param(3, False, id="False"), pytest.param(3, True, id="True"),
    pytest.param(9, False, id="K9-False"), pytest.param(9, True, id="K9-True"),
    pytest.param(16, False, id="K16-False"),
    pytest.param(16, True, id="K16-True"),
])
def test_attn_step_split_plain_matches_pallas(K, with_anc):
    """Split prompt/generated cache with per-stream pads, with and without
    the beam ancestry matrix, at 3 beams and past the 8 the first CUDA
    kernel took (9, 16); tolerance 1e-5 (f32)."""
    rng = np.random.RandomState(11 + with_anc + 100 * (K != 3) + K)
    B, Pp, G, H, dk = 2, 16, 32, 4, 64
    D, BK, gslot = H * dk, B * K, 9
    pads = np.asarray([0, 5], np.int32)
    q = rng.randn(BK, 1, D).astype(np.float32) * 0.3 * dk ** -0.5
    kp, vp = (rng.randn(B, Pp, D).astype(np.float32) * 0.3
              for _ in range(2))
    kg, vg = (rng.randn(BK, G, D).astype(np.float32) * 0.3
              for _ in range(2))
    anc = None
    if with_anc:
        anc = rng.randint(0, K, (B, K, G)).astype(np.int32)
        anc[:, :, gslot] = np.arange(K)[None, :]
    want = np.asarray(pk.attn_step_split(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(kg),
        jnp.asarray(vg), jnp.asarray(gslot, jnp.int32), jnp.asarray(pads),
        dk, K, anc=None if anc is None else jnp.asarray(anc),
        interpret=True))
    got = tk.attn_step_split(t(q), t(kp), t(vp), t(kg), t(vg), gslot,
                             t(pads), dk, K,
                             anc=None if anc is None else t(anc))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("gslot", [0, 13, 31])
def test_attn_step_split_takes_gslot_as_int_or_tensor(gslot):
    """gslot as a Python int and as a 0-d int32 tensor give the same output
    (the plain path here; the kernel reads the tensor on the device), at
    the first slot, a middle one and the last (G - 1)."""
    rng = np.random.RandomState(21 + gslot)
    B, K, Pp, G, H, dk = 2, 5, 8, 32, 2, 64
    D = H * dk
    q = t(rng.randn(B * K, 1, D).astype(np.float32) * 0.3)
    kp, vp = (t(rng.randn(B, Pp, D).astype(np.float32) * 0.3)
              for _ in range(2))
    kg, vg = (t(rng.randn(B * K, G, D).astype(np.float32) * 0.3)
              for _ in range(2))
    pads = t(np.asarray([0, 3], np.int32))
    anc = rng.randint(0, K, (B, K, G)).astype(np.int32)
    anc[:, :, gslot] = np.arange(K)[None, :]
    for a in (None, t(anc)):
        by_int = tk.attn_step_split(q, kp, vp, kg, vg, gslot, pads, dk, K, a)
        by_tensor = tk.attn_step_split(
            q, kp, vp, kg, vg, torch.tensor(gslot, dtype=torch.int32), pads,
            dk, K, a)
        assert torch.equal(by_int, by_tensor)
        bias = tk.split_visibility_bias(
            B, K, Pp, G, torch.tensor(gslot, dtype=torch.int32), pads, a)
        assert torch.equal(bias, tk.split_visibility_bias(B, K, Pp, G, gslot,
                                                          pads, a))


def test_attn_step_split_single_beam_matches_attn_step():
    """K=1 split attention == attn_step over the concatenated cache, in the
    port and in the JAX package."""
    rng = np.random.RandomState(8)
    B, Pp, G, H, dk = 2, 8, 16, 2, 64
    D, gslot = H * dk, 4
    q = rng.randn(B, 1, D).astype(np.float32) * 0.3
    kp, vp = (rng.randn(B, Pp, D).astype(np.float32) * 0.3
              for _ in range(2))
    kg, vg = (rng.randn(B, G, D).astype(np.float32) * 0.3
              for _ in range(2))
    pads = np.asarray([0, 3], np.int32)
    got = tk.attn_step_split(t(q), t(kp), t(vp), t(kg), t(vg), gslot,
                             t(pads), dk, 1)
    kc, vc = np.concatenate([kp, kg], 1), np.concatenate([vp, vg], 1)
    # keys past the current slot carry weight exp(-1e30) = 0 either way
    kc[:, Pp + gslot + 1:] = 0.0
    vc[:, Pp + gslot + 1:] = 0.0
    mine = tk.attn_step(t(q), t(kc), t(vc), Pp + gslot, t(pads), dk)
    ref = np.asarray(pk.attn_step(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(Pp + gslot, jnp.int32), jnp.asarray(pads), dk,
        interpret=True))
    np.testing.assert_allclose(got.numpy(), mine.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_split_visibility_bias_matches_the_jax_wrapper():
    """The plain version's bias is the JAX wrapper's (0 / -1e30)."""
    B, K, Pp, G, gslot = 2, 3, 5, 6, 3
    pads = np.asarray([1, 4], np.int32)
    anc = np.random.RandomState(0).randint(0, K, (B, K, G)).astype(np.int32)
    bias = tk.split_visibility_bias(B, K, Pp, G, gslot, t(pads), t(anc))
    vis_p = np.arange(Pp)[None, None, :] >= pads[:, None, None]
    eq = anc[:, :, None, :] == np.arange(K)[None, None, :, None]
    vis_g = (eq & (np.arange(G) <= gslot)).reshape(B, K, K * G)
    vis = np.concatenate([np.broadcast_to(vis_p, (B, K, Pp)), vis_g], -1)
    np.testing.assert_array_equal(bias.numpy(),
                                  np.where(vis, 0.0, -1e30).astype(np.float32))


@pytest.mark.parametrize("C", [128, 256])
@pytest.mark.parametrize("k", [3, 7, 11, 15])
def test_depthwise_conv1d_plain_matches_pallas_and_grouped_conv(k, C):
    """The plain version against the Pallas kernel (interpret mode) and
    flax nn.Conv(feature_group_count=C), f32; T=40 is no multiple of the
    CUDA kernel's 64-row tile. Tolerance 1e-5 relative (f32 sums in
    another order)."""
    import flax.linen as nn
    rng = np.random.RandomState(k * C)
    B, T = 3, 40
    x = rng.randn(B, T, C).astype(np.float32)
    w = rng.randn(k, C).astype(np.float32) * 0.2
    got = tk.depthwise_conv1d(t(x), t(w), k)
    assert got.dtype == torch.float32 and got.shape == (B, T, C)
    got = got.numpy()
    pallas = np.asarray(pk.depthwise_conv1d(jnp.asarray(x), jnp.asarray(w),
                                            k, interpret=True))
    conv = nn.Conv(C, kernel_size=(k,), padding=[((k - 1) // 2,) * 2],
                   feature_group_count=C, use_bias=False)
    flax_out = np.asarray(conv.apply({"params": {"kernel": w[:, None, :]}},
                                     jnp.asarray(x)))
    for want in (pallas, flax_out):
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


@pytest.mark.parametrize("C,k", [(128, 7), (80, 3), (128, 1), (128, 17)])
def test_titanet_depthwise_module_matches_jax(C, k):
    """The port's DepthwiseConv against the JAX module with the same taps,
    f32: C=128 with k=7 or 17 (past the 16 taps the first CUDA kernel
    took) takes the kernel wrapper (its plain version here), C=80 and k=1
    the grouped conv, as in the JAX module. Tolerance 1e-5."""
    from notsofar_tpu.models import titanet as jt
    from notsofar_tpu_torch.models import titanet as tt
    rng = np.random.RandomState(3 + C + k)
    B, T = 2, 50
    x = rng.randn(B, T, C).astype(np.float32)
    w = rng.randn(k, 1, C).astype(np.float32) * 0.2
    want = np.asarray(jt.DepthwiseConv(k).apply({"params": {"kernel": w}},
                                                jnp.asarray(x)))
    mod = tt.DepthwiseConv(C, k, torch.float32)
    mod.load_state_dict({"weight": t(w[:, 0, :])})
    tk.reset_launches()
    got = mod(t(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert tk.LAUNCHES["depthwise_conv1d"] == 0


def test_titanet_depthwise_module_bf16_rounds_like_the_pallas_branch():
    """At bf16, C % 128 == 0: the port's DepthwiseConv equals the JAX
    module's TPU branch — the Pallas kernel on x in bf16 with f32 taps,
    its f32 output cast to bf16 — to one bf16 ulp (2**-8 relative: the
    f32 sums differ in order only)."""
    from notsofar_tpu_torch.models import titanet as tt
    rng = np.random.RandomState(5)
    B, T, C, k = 2, 37, 128, 11
    x = bf16_round(rng.randn(B, T, C).astype(np.float32))
    w = rng.randn(k, C).astype(np.float32) * 0.2
    want = np.asarray(pk.depthwise_conv1d(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), k,
        interpret=True).astype(jnp.bfloat16)).astype(np.float32)
    mod = tt.DepthwiseConv(C, k, torch.bfloat16)
    mod.load_state_dict({"weight": t(w)})
    got = mod(t(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=2 ** -8, atol=1e-6)


@pytest.mark.parametrize("B,F,T,M,S,f_block", [(2, 257, 186, 7, 3, 32),
                                               (1, 9, 40, 7, 3, 8),
                                               (2, 5, 33, 4, 2, 8)])
def test_masked_scm_plain_matches_pallas_and_einsum(B, F, T, M, S, f_block):
    """The plain version against masked_scm_pallas in interpret mode and
    the JAX package's einsum masked_scm on the same winner-take-all masks
    and STFT; 257 is no multiple of the Pallas block (F padding). f32
    sums over T in another order: tolerance 1e-5 of the largest entry."""
    from notsofar_tpu.ops.mvdr import make_wta, masked_scm
    rng = np.random.RandomState(B * F + T)
    spk = rng.rand(B, F, T, S).astype(np.float32)
    noi = rng.rand(B, F, T, 1).astype(np.float32)
    x = (rng.randn(B, F, T, M) + 1j * rng.randn(B, F, T, M)) \
        .astype(np.complex64)
    wta = np.asarray(make_wta(jnp.asarray(spk), jnp.asarray(noi)))
    got = tk.masked_scm(t(wta), t(x))
    assert got.dtype == torch.complex64 and got.shape == (B, S + 1, F, M, M)
    got = got.numpy()
    scale = np.abs(got).max()
    for want in (np.asarray(pk.masked_scm_pallas(
            jnp.asarray(wta), jnp.asarray(x), f_block=f_block,
            interpret=True)),
            np.asarray(masked_scm(jnp.asarray(wta), jnp.asarray(x)))):
        assert np.abs(got - want).max() <= 1e-5 * scale
    np.testing.assert_allclose(got, got.conj().swapaxes(-1, -2),
                               rtol=1e-5, atol=1e-5 * scale)


def test_masked_scm_of_an_all_zero_window_is_the_regularizer():
    """A padding window (all-zero STFT) gives exactly 1e-15 * I, which
    MVDR's trace normalisation then divides by."""
    wta = torch.rand(2, 6, 10, 4)
    x = torch.zeros(2, 6, 10, 7, dtype=torch.complex64)
    x[0] = torch.randn(6, 10, 7, dtype=torch.complex64)
    got = tk.masked_scm(wta, x)
    eye = torch.eye(7, dtype=torch.complex64) * 1e-15
    assert torch.equal(got[1], eye.expand(4, 6, 7, 7))
    assert not torch.equal(got[0], eye.expand(4, 6, 7, 7))


def xattn_case(rng, B, T, D, dk, S, s_valid, q_scale):
    """q (bf16 values) [B, T, D], int8 k8/v8 [B, S, D] zero past s_valid,
    v-scales [B, D] in [0, 0.01)."""
    q = bf16_round(rng.randn(B, T, D).astype(np.float32) * q_scale)
    k8, v8 = (rng.randint(-127, 128, (B, S, D)).astype(np.int8)
              for _ in range(2))
    k8[:, s_valid:] = 0
    v8[:, s_valid:] = 0
    vs = rng.rand(B, D).astype(np.float32) * 0.01
    return q, k8, v8, vs


def xattn_tolerance(q, k8, vs, dk, s_valid, flip=2.0 ** -7) -> float:
    """Each output is vs * sum_s p_s v_s with |v_s| <= 127 and sum p = 1.
    Two versions that sum in other f32 orders differ (a) by at most
    s_valid f32 roundings of that sum, and (b) where a logit's summation
    order sends its weight to the other bf16 neighbour, by one bf16 ulp
    (<= 2**-7 p) of that weight times 127; (b) is allowed once, at the
    largest weight. Where each product v * p is rounded to bf16
    (xattn_onedot), a flip also moves the two roundings of its product
    (each <= 2**-8 of 127 p): flip = 2**-6."""
    B, T, D = q.shape
    H = D // dk
    lg = np.einsum("bthd,bshd->bhts", q.reshape(B, T, H, dk).astype(
        np.float64), k8[:, :s_valid].reshape(B, s_valid, H, dk))
    p = np.exp(lg - lg.max(-1, keepdims=True))
    p_max = (p / p.sum(-1, keepdims=True)).max()
    return 127 * float(vs.max()) * (flip * p_max + s_valid * 2.0 ** -24)


XATTN_FLIP_SHARE = 5e-3


def xattn_rms_tolerance(q, k8, v8, vs, dk, s_valid) -> float:
    """The RMS error over all outputs that two correct versions may show:
    bf16 roundings of the weights sent to the other neighbour at a share
    XATTN_FLIP_SHARE of all weights, each moving an output by ulp(p) v vs
    (a weight flips with odds of about its relative change over 2**-8, so
    the share stands for relative changes of p near 2e-5, far above what
    the f32 summation orders give); plus sqrt(s_valid) f32 roundings of
    the weighted value sum. Moving the rounding point of p (rounding before
    normalizing, or not rounding) changes every weight by a fraction of an
    ulp, like flips at a share of 1/12 or more, so at logits of unit scale
    it lands 2-4x above this; see xattn_rounding_mutant."""
    B, T, D = q.shape
    H = D // dk
    lg = np.einsum("bthd,bshd->bhts", q.reshape(B, T, H, dk).astype(
        np.float64), k8[:, :s_valid].reshape(B, s_valid, H, dk))
    p = np.exp(lg - lg.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    ulp = np.ldexp(1.0, np.frexp(p)[1] - 8)         # bf16 ulp of each p
    v = v8[:, :s_valid].reshape(B, s_valid, H, dk).astype(np.float64)
    w = vs.reshape(B, 1, H, dk).astype(np.float64)
    flips = np.einsum("bhts,bshd->bthd", ulp ** 2, v ** 2) * w ** 2
    mag = np.einsum("bhts,bshd->bthd", p, np.abs(v)) * np.abs(w)
    return float(np.sqrt(XATTN_FLIP_SHARE * flips.mean())
                 + np.sqrt(s_valid) * 2.0 ** -24 * np.sqrt((mag ** 2).mean()))


def xattn_rounding_mutant(q, k8, v8, vs, dk, s_valid, mode):
    """xattn_int8_plain with the bf16 rounding of p moved: 'unnormalized'
    rounds exp(l - max) before dividing by the sum (an online softmax's
    rounding point), 'none' never rounds."""
    B, T, D = q.shape
    S = k8.shape[1]
    H = D // dk
    lg = torch.einsum("bthd,bshd->bhts", q.float().reshape(B, T, H, dk),
                      k8.float().reshape(B, S, H, dk))
    lg = lg.masked_fill(torch.arange(S, device=q.device) >= s_valid, -1e30)
    e = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    if mode == "unnormalized":
        e = e.to(torch.bfloat16).float()
    p = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhts,bshd->bthd", p, v8.float().reshape(B, S, H, dk))
    return out.reshape(B, T, D) * vs[:, None, :]


def rms(x) -> float:
    return float(torch.as_tensor(x).double().pow(2).mean().sqrt())


def onedot_lane_weights(q, k8, dk, s_valid) -> np.ndarray:
    """xattn_onedot's float64 weights of each lane, [B, s_valid, D]: the
    softmax of head d % H's logits for lane d (the tool's pltpu.repeat
    tiles the [S, H] weights along the lanes)."""
    B, _, D = q.shape
    H = D // dk
    lg = np.einsum("bhd,bshd->bhs", q.reshape(B, H, dk).astype(np.float64),
                   k8[:, :s_valid].reshape(B, s_valid, H, dk))
    p = np.exp(lg - lg.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return p[:, np.arange(D) % H].transpose(0, 2, 1)


def onedot_rms_tolerance(q, k8, v8, vs, dk, s_valid) -> float:
    """xattn_rms_tolerance's model for xattn_onedot, whose lane d takes
    head d % H's weights: bf16 flips of the weights at a share
    XATTN_FLIP_SHARE, each moving its rounded product by about ulp(p) v vs,
    plus sqrt(s_valid) f32 roundings of the sum. Leaving the products
    unrounded moves every product by up to half its bf16 ulp, like flips
    at a share of 1/12 (onedot_rounding_mutant)."""
    pe = onedot_lane_weights(q, k8, dk, s_valid)
    ulp = np.ldexp(1.0, np.frexp(pe)[1] - 8)
    v = v8[:, :s_valid].astype(np.float64)
    w = vs.astype(np.float64)
    flips = (ulp ** 2 * v ** 2).sum(1) * w ** 2
    mag = (pe * np.abs(v)).sum(1) * np.abs(w)
    return float(np.sqrt(XATTN_FLIP_SHARE * flips.mean())
                 + np.sqrt(s_valid) * 2.0 ** -24 * np.sqrt((mag ** 2).mean()))


def onedot_rounding_mutant(q, k8, v8, vs, dk, s_valid):
    """xattn_onedot_plain with the products v * p left unrounded."""
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


def split_bias_tolerance(q, keys, vals, bias, dk) -> float:
    """Each f32 output is sum_c p_c v_c. Two versions that sum the logits
    and p.v in other f32 orders differ by at most ncol f32 roundings of
    sum_c p_c |v_c|, and, where a logit's order sends its weight to the
    other neighbour of the value dtype, by one bf16 ulp (<= 2**-7 p) of
    that weight times |v|; allowed once, at the largest weight and value."""
    B, K, D = q.shape
    H = D // dk
    ncol = keys.shape[1]
    lg = np.einsum("bjhd,bchd->bhjc",
                   q.reshape(B, K, H, dk).astype(np.float64),
                   keys.reshape(B, ncol, H, dk).astype(np.float64))
    lg = lg + bias[:, None]
    p = np.exp(lg - lg.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    mag = np.einsum("bhjc,bchd->bjhd", p,
                    np.abs(vals).reshape(B, ncol, H, dk).astype(np.float64))
    return float(2.0 ** -7 * p.max() * np.abs(vals).max()
                 + ncol * 2.0 ** -24 * mag.max())


def split_case(rng, B, K, Pp, G, bias_kind, D=128, dk=64):
    """bf16 values in f32 arrays: q [B, K, D] scaled by dk**-0.5, caches
    [B, Pp, D] and [B, K*G, D] of unit scale; the bias [B, K, Pp + K*G] of
    split_visibility_bias with pads and a random ancestry ('visibility'),
    or that bias plus finite N(0, 2) values on the visible columns
    ('finite'); both with beam 1 of stream 0 masked everywhere."""
    q = bf16_round(rng.randn(B, K, D).astype(np.float32) * dk ** -0.5)
    kp, vp = (bf16_round(rng.randn(B, Pp, D).astype(np.float32))
              for _ in range(2))
    kg, vg = (bf16_round(rng.randn(B, K * G, D).astype(np.float32))
              for _ in range(2))
    pads = torch.from_numpy(rng.randint(0, Pp // 2, B).astype(np.int32))
    anc = torch.from_numpy(rng.randint(0, K, (B, K, G)).astype(np.int32))
    bias = tk.split_visibility_bias(B, K, Pp, G, G - 3, pads, anc).numpy()
    if bias_kind == "finite":
        bias = np.where(bias == 0, rng.randn(*bias.shape) * 2.0,
                        bias).astype(np.float32)
    bias[0, min(1, K - 1)] = tk.MASKED
    return q, kp, vp, kg, vg, bias


# the three shapes of test_pallas_kernels.py, Tq 8, and the large-v3 memory
# (S_pad 1504, s_valid 1500) with logits of unit scale as the model makes
# them
@pytest.mark.parametrize("B,T,D,dk,S,s_valid,q_scale", [
    (2, 1, 256, 64, 96, 77, 0.2), (2, 5, 384, 64, 96, 77, 0.2),
    (1, 1, 128, 128, 32, 20, 0.2), (2, 8, 256, 64, 96, 77, 0.2),
    (2, 5, 128, 64, 1504, 1500, 0.004)])
def test_xattn_int8_plain_matches_pallas(B, T, D, dk, S, s_valid, q_scale):
    """Within the worst-case max tolerance and the RMS tolerance; the
    rounding of p moved (before normalizing, or never) is outside the RMS
    tolerance at unit-scale logits."""
    rng = np.random.RandomState(4 + T + S)
    q, k8, v8, vs = xattn_case(rng, B, T, D, dk, S, s_valid, q_scale)
    want = np.asarray(pk.xattn_int8(jnp.asarray(q, jnp.bfloat16),
                                    jnp.asarray(k8), jnp.asarray(v8),
                                    jnp.asarray(vs), dk, s_valid,
                                    interpret=True))
    got = tk.xattn_int8(t(q).bfloat16(), t(k8), t(v8), t(vs), dk, s_valid)
    assert got.dtype == torch.float32 and got.shape == (B, T, D)
    tol = xattn_tolerance(q, k8, vs, dk, s_valid)
    err = np.abs(got.numpy() - want).max()
    assert err <= tol, (err, tol)
    rms_tol = xattn_rms_tolerance(q, k8, v8, vs, dk, s_valid)
    assert rms(got.numpy() - want) <= rms_tol
    # at q_scale 0.2 one weight holds nearly all the mass and is 1 in bf16
    # wherever it is rounded; the rounding point shows at unit-scale logits
    for mode in ("unnormalized", "none") if q_scale < 0.01 else ():
        mutant = xattn_rounding_mutant(t(q).bfloat16(), t(k8), t(v8), t(vs),
                                       dk, s_valid, mode)
        assert rms(mutant.numpy() - want) > rms_tol, mode


def test_cpu_tensors_take_the_plain_path_and_count_nothing():
    tk.reset_launches()
    q = torch.randn(2, 512, 64).bfloat16()
    out = tk.encoder_mha(q, q, q)
    torch.testing.assert_close(out, tk.encoder_mha_plain(q, q, q))
    wta, x = torch.rand(1, 3, 8, 4), torch.randn(1, 3, 8, 7,
                                                 dtype=torch.complex64)
    torch.testing.assert_close(tk.masked_scm(wta, x),
                               tk.masked_scm_plain(wta, x))
    k8 = torch.randint(-127, 128, (1, 32, 128), dtype=torch.int8)
    vs = torch.rand(1, 128)
    torch.testing.assert_close(
        tk.xattn_int8(q[:1, :3, :].reshape(1, 3, 64).repeat(1, 1, 2), k8, k8,
                      vs, 64, 30),
        tk.xattn_int8_plain(q[:1, :3, :].reshape(1, 3, 64).repeat(1, 1, 2),
                            k8, k8, vs, 64, 30))
    out, checksum = tk.xattn_stream(k8, k8)
    torch.testing.assert_close(out, tk.xattn_stream_plain(k8, k8)[0])
    q1 = q[:1, :1, :].repeat(1, 1, 2)
    torch.testing.assert_close(tk.xattn_onedot(q1, k8, k8, vs, 64, 30),
                               tk.xattn_onedot_plain(q1, k8, k8, vs, 64, 30))
    bias = torch.zeros(1, 1, 64)
    torch.testing.assert_close(
        tk.attn_step_split_bias(q1, k8[:, :32].bfloat16(),
                                k8[:, :32].bfloat16(), k8.bfloat16(),
                                k8.bfloat16(), bias, 64),
        tk.attn_step_split_bias_plain(q1, k8[:, :32].bfloat16(),
                                      k8[:, :32].bfloat16(), k8.bfloat16(),
                                      k8.bfloat16(), bias, 64))
    kf = k8[:, :32].bfloat16()
    torch.testing.assert_close(tk.xattn_step(q1, kf, kf, 64),
                               tk.xattn_step_plain(q1, kf, kf, 64))
    w8, sc = k8[0, :, :128], torch.rand(32)          # [N 32, K 128] int8
    torch.testing.assert_close(
        tk.decode_gemv(q1, w8, torch.bfloat16, sc, logits=True),
        tk.decode_gemv_plain(q1, w8, torch.bfloat16, sc, logits=True))
    assert all(n == 0 for n in tk.LAUNCHES.values())


def covers_once(shares, n) -> bool:
    """The shares (c0, len) lie end to end from 0 and cover [0, n) once."""
    pos = 0
    for c0, length in shares:
        if length < 0 or (length and c0 != pos):
            return False
        pos += length
    return pos == n


# large-v3 (D 1280, 20 heads of 64), D 1536 in heads of 64 and 128, the
# tests' small widths
@pytest.mark.parametrize("D,dk", [(1280, 64), (1536, 64), (1536, 128),
                                  (128, 64), (256, 128)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attn_step_plan_is_independent_of_pos_and_fits(D, dk, dtype):
    """attn_step_launch takes no pos: its grid (R, H, B) is fixed by the
    shapes, so one launch captured in a CUDA graph serves every step. For
    every cache length to Whisper's 448 and every pos in it, with pads
    before, at and past pos, the kernel's shares cover
    the keys [min(pad, pos), pos] exactly once, which hold every visible
    key, each share within the block's capacity; a block's shared memory
    stays within SMEM_LIMIT (227 KB)."""
    import inspect
    assert "pos" not in inspect.signature(tk.attn_step_launch).parameters
    for ctx in list(range(1, 65)) + [96, 128, 192, 256, 320, 384, 448]:
        plan = tk.attn_step_launch(12, ctx, D, dk, dtype)
        R = plan["cluster"]
        assert 1 <= R <= 8 and plan["grid"] == (R, D // dk, 12)
        assert plan["threads"] == tk.ATTN_STEP_THREADS
        assert plan["smem"] <= tk.SMEM_LIMIT
        for pos in range(ctx):
            for pad in sorted({0, 1, pos // 2, pos, pos + 1, ctx}):
                lo = min(pad, pos)
                # the kernel's shares: the keys [lo, pos] cut as
                # split_shares cuts them (csrc/attn_step.cu)
                shares = [(lo + c0, n) for c0, n in
                          tk.split_shares(pos - lo + 1, R)]
                assert len(shares) == R
                assert covers_once([(c0 - lo, n) for c0, n in shares],
                                   pos - lo + 1)
                assert max(n for _, n in shares) <= plan["per"]
                keys = np.arange(ctx)
                visible = (keys <= pos) & ((keys >= pad) | (keys == pos))
                assert visible[lo:pos + 1].all() and visible.sum() == \
                    pos - lo + 1
    assert tk.attn_step_launch(12, 448, 1280, 64, torch.bfloat16)[
        "grid"] == (4, 20, 12)   # 960 blocks at the greedy shape


# the serving grids (beam 5: 9 rows x 20 heads; greedy: 48 x 20), one row,
# and the tests' small grids
@pytest.mark.parametrize("B,D", [(9, 1280), (48, 1280), (1, 128), (3, 256)])
def test_xattn_int8_plan_covers_the_valid_keys_once(B, D):
    """Over the wrapper's range (T 1-8, dk 64/128, S_pad to 1504 and every
    s_valid of a few S_pad, bf16 and f32 queries): the R <= 8 shares cover
    [0, s_valid) exactly once (empty shares allowed; R = 1, a block per
    row, for grids of XATTN_ROW_PAIRS pairs or more), a share fits the
    block's capacity, the grid does not depend on s_valid, and a block's
    shared memory stays within SMEM_LIMIT."""
    for dk, dtype in ((64, torch.bfloat16), (128, torch.bfloat16),
                      (64, torch.float32), (128, torch.float32)):
        for T in range(1, 9):
            for S_pad in range(32, 1505, 32):
                full = S_pad in (32, 96, 1504)
                valids = range(1, S_pad + 1) if full else \
                    sorted({1, 2, 7, 9, S_pad // 3, S_pad - 1, S_pad} - {0})
                grid = None
                for s_valid in valids:
                    plan = tk.xattn_int8_launch(B, T, S_pad, D, dk, s_valid,
                                                dtype)
                    R = plan["cluster"]
                    assert 1 <= R <= 8 and len(plan["shares"]) == R
                    assert plan["grid"] == ((D // dk, B) if R == 1
                                            else (R, D // dk, B))
                    assert R == 1 or D // dk * B < tk.XATTN_ROW_PAIRS
                    assert grid in (None, plan["grid"])
                    grid = plan["grid"]
                    assert covers_once(plan["shares"], s_valid)
                    assert max(n for _, n in plan["shares"]) <= plan["per"]
                    assert plan["smem"] <= tk.SMEM_LIMIT


@pytest.mark.parametrize("T,dk,dtype", [(8, 64, torch.bfloat16),
                                        (8, 128, torch.bfloat16),
                                        (1, 128, torch.float32),
                                        (5, 64, torch.float32)])
def test_xattn_int8_wrapper_raises_exactly_where_the_plan_passes_smem(T, dk,
                                                                      dtype):
    """The wrapper's checks raise for the first S_pad whose plan needs more
    than SMEM_LIMIT bytes of shared memory a block, and take the S_pad
    before it (shapes only: the checks run before any launch)."""
    last_ok = None
    for S_pad in range(1504, 20001, 32):
        q = torch.empty(1, T, dk, dtype=dtype)
        k8 = torch.empty(1, S_pad, dk, dtype=torch.int8)
        vs = torch.empty(1, dk)
        smem = tk.xattn_int8_launch(1, T, S_pad, dk, dk, S_pad, dtype)["smem"]
        if smem <= tk.SMEM_LIMIT:
            assert tk._xattn_int8_plan(q, k8, k8, vs, dk, S_pad)["smem"] == \
                smem
            last_ok = S_pad
            continue
        with pytest.raises(ValueError, match="227 KB"):
            tk._xattn_int8_plan(q, k8, k8, vs, dk, S_pad)
        break
    else:
        pytest.fail("no S_pad up to 20000 passes the shared memory")
    assert last_ok is not None and last_ok >= 1504


# the bisect tool's shape (8 streams, Pp 256, G 192), Whisper's context
# (Pp 224, G 224), the tests' small shapes
@pytest.mark.parametrize("B,Pp,G,D,dk", [(8, 256, 192, 1280, 64),
                                         (2, 224, 224, 1280, 64),
                                         (2, 16, 8, 128, 64),
                                         (3, 40, 24, 256, 128),
                                         (1, 0, 3, 128, 128)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_bias_plan_covers_the_columns_once(B, Pp, G, D, dk, dtype):
    """For K 1-16 beams: R <= 8 shares that cover [0, Pp + K*G) exactly
    once (empty shares allowed), each within the block's capacity, and
    a block's shared memory within SMEM_LIMIT: at every K for bf16 caches
    (the tool's), at the first design's K <= 8 for f32 caches, whose rows
    take twice the bytes (past that the wrapper may raise, as
    test_split_bias_wrapper_raises_exactly_where_the_plan_passes_smem
    holds)."""
    for K in range(1, 17):
        ncol = Pp + K * G
        plan = tk.attn_step_split_bias_launch(B, K, Pp, K * G, D, dk, dtype)
        R = plan["cluster"]
        assert 1 <= R <= 8 and plan["grid"] == (R, D // dk, B)
        assert covers_once(plan["shares"], ncol)
        assert max(n for _, n in plan["shares"]) <= plan["per"]
        if dtype == torch.bfloat16 or K <= 8:
            assert plan["smem"] <= tk.SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_bias_wrapper_raises_exactly_where_the_plan_passes_smem(dtype):
    """The wrapper's checks take every beam count whose plan fits the
    block's shared memory and raise with the first that does not (shapes
    only: the checks run before any launch)."""
    B, Pp, G, D, dk = 1, 256, 192, 64, 64
    for K in range(1, 400):
        q = torch.empty(B, K, D, dtype=dtype)
        kp = torch.empty(B, Pp, D, dtype=dtype)
        kg = torch.empty(B, K * G, D, dtype=dtype)
        bias = torch.empty(B, K, Pp + K * G)
        smem = tk.attn_step_split_bias_launch(B, K, Pp, K * G, D, dk,
                                              dtype)["smem"]
        if smem <= tk.SMEM_LIMIT:
            assert tk._split_bias_plan(q, kp, kp, kg, kg, bias, dk)[
                "smem"] == smem
            continue
        with pytest.raises(ValueError, match="227 KB"):
            tk._split_bias_plan(q, kp, kp, kg, kg, bias, dk)
        assert K > (16 if dtype == torch.bfloat16 else 8)
        break
    else:
        pytest.fail("no beam count below 400 passes the shared memory")


# ---------------------------------------------------------------------------
# xattn_step and decode_gemv: the decode step's float cross-attention and
# weight-only GEMV (XLA-fused in the JAX package, no Pallas kernel)
# ---------------------------------------------------------------------------

def xattn_step_tolerance(q, k, v, dk, dtype, jax_scale=True) -> np.ndarray:
    """Per-output bound on the float cross-attention of the JAX package
    against the port's, on q [B, T, D], k/v [B, S, D] (f32 arrays holding
    the dtype's values) -> [B, T, D]. Both round dtype(q * s) and dtype(k *
    s) (s = dk**-0.25), p and the output, and sum in f32 in other orders.
    In bf16 JAX meets the Python scale as a bf16 weak type (0.353515625)
    where PyTorch multiplies by f32 s: the logits of the two roundings are
    computed here in float64, and a logit moved by delta moves a weight by
    a factor up to exp(2 max delta); beyond that, one weight's bf16
    rounding may go the other way (2**-7 p_max |v|_max, once), S f32
    roundings of sum_s p |v|, and the two roundings of the output (one
    ulp, <= 2**-7 of sum_s p |v|). Without jax_scale (the kernel against
    its plain version, both rounding with f32 s) a logit moves only by its
    f32 order: dk roundings of sum_d |q s| |k s|."""
    B, T, D = q.shape
    H = D // dk
    s = dk ** -0.25
    qh = q.reshape(B, T, H, dk).astype(np.float32)
    kh = k.reshape(B, -1, H, dk).astype(np.float32)
    if dtype == "bf16" and jax_scale:
        s_j = float(bf16_round(np.float32([s]))[0])
        pairs = [tuple(bf16_round(x * np.float32(sc)) for x in (qh, kh))
                 for sc in (s_j, s)]
    else:
        rnd = bf16_round if dtype == "bf16" else (lambda x: x)
        pairs = [(rnd(qh * np.float32(s)), rnd(kh * np.float32(s)))] * 2
    lgs = [np.einsum("bthd,bshd->bhts", a.astype(np.float64),
                     b.astype(np.float64)) for a, b in pairs]
    delta = np.abs(lgs[0] - lgs[1]).max(-1)                      # [B, H, T]
    if not jax_scale or dtype == "f32":
        delta = delta + dk * 2.0 ** -24 * np.einsum(
            "bthd,bshd->bhts", np.abs(pairs[1][0]).astype(np.float64),
            np.abs(pairs[1][1]).astype(np.float64)).max(-1)
    p = np.exp(lgs[1] - lgs[1].max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    vh = np.abs(v.reshape(B, -1, H, dk).astype(np.float64))
    mag = np.einsum("bhts,bshd->bthd", p, vh)
    move = np.expm1(2 * delta).transpose(0, 2, 1)[..., None] * mag
    flip = 2.0 ** -7 * p.max() * vh.max() if dtype == "bf16" else 0.0
    out_ulp = 2.0 ** -7 * mag if dtype == "bf16" else 2.0 ** -23 * mag
    return (move + flip + k.shape[1] * 2.0 ** -24 * mag
            + out_ulp).reshape(B, T, D)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("Bm,K,T,D,dk,S", [
    (2, 1, 1, 128, 64, 40),     # greedy: one query a window
    (2, 3, 1, 128, 64, 40),     # beam 3 folded into the query axis
    (1, 1, 8, 256, 128, 33),    # Tq 8, dk 128
    (2, 5, 1, 128, 64, 1500)])  # beam 5 against Whisper's 1500 frames
def test_xattn_step_plain_matches_jax_attend_precomputed(dtype, Bm, K, T, D,
                                                         dk, S):
    """xattn_step_plain on the folded queries against the JAX package's
    MHA._attend_precomputed float branch on the same q, k, v (its beams
    folded by the method itself), per output within
    xattn_step_tolerance; in bf16 the output is bf16 on both sides."""
    import jax
    from notsofar_tpu.models import whisper as jw
    rng = np.random.RandomState(S + K + T)
    q = rng.randn(Bm * K, T, D).astype(np.float32)
    k = rng.randn(Bm, S, D).astype(np.float32)
    v = rng.randn(Bm, S, D).astype(np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    if dtype == "bf16":
        q, k, v = (bf16_round(x) for x in (q, k, v))
    mha = jw.MHA(D, D // dk, dtype=jdt)
    want, w = mha.apply({}, jnp.asarray(q, jdt),
                        (jnp.asarray(k, jdt), jnp.asarray(v, jdt)), None,
                        method=jw.MHA._attend_precomputed)
    want = np.asarray(jax.device_get(want).astype(np.float32))
    got = tk.xattn_step_plain(t(q).to(tdt).reshape(Bm, K * T, D),
                              t(k).to(tdt), t(v).to(tdt), dk)
    assert got.dtype == tdt and got.shape == (Bm, K * T, D)
    got = got.float().reshape(Bm * K, T, D).numpy()
    tol = xattn_step_tolerance(q.reshape(Bm, K * T, D), k, v, dk, dtype)
    err = np.abs(got - want) - tol.reshape(Bm * K, T, D)
    assert err.max() <= 0, (np.abs(got - want).max(), tol.max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("use_bias", [True, False])
def test_decode_gemv_plain_matches_flax_quant_dense(dtype, use_bias):
    """Dense mode against flax QuantDense on the same int8 kernel, scale
    and bias, x in f32 (cast to the compute dtype by both): f32 within
    1e-6 relative (sums in another order); bf16 -- x @ w8, * s and + b each
    rounded to bf16 on both sides -- within one bf16 ulp (2**-8 relative to
    the binade) of each output (a summation order may send the first
    rounding the other way)."""
    from notsofar_tpu.models import whisper as jw
    rng = np.random.RandomState(12 + use_bias)
    x = rng.randn(3, 5, 128).astype(np.float32)
    k8 = rng.randint(-127, 128, (128, 40)).astype(np.int8)
    sc = (rng.rand(40).astype(np.float32) + 0.1) * 0.01
    bias = rng.randn(40).astype(np.float32) * 0.1
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    params = {"kernel": k8, "scale": sc}
    if use_bias:
        params["bias"] = bias
    want = np.asarray(jw.QuantDense(40, use_bias=use_bias, dtype=jdt).apply(
        {"params": params}, jnp.asarray(x)).astype(jnp.float32))
    got = tk.decode_gemv_plain(t(x), t(k8.T.copy()), tdt, t(sc),
                               t(bias) if use_bias else None)
    assert got.dtype == tdt and got.shape == (3, 5, 40)
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                      - 7)
        assert (np.abs(got - want) <= ulp).all()


@pytest.mark.parametrize("kind", ["int8_f32", "int8_bf16", "bf16"])
def test_decode_gemv_plain_matches_the_jax_logits_einsums(kind):
    """Logits mode against the JAX TextDecoder's two logits einsums
    (notsofar_tpu/models/whisper.py): int8 -- x cast to the compute dtype
    times the int8 embedding in that dtype, f32 accumulation, times the f32
    row scale; bf16 -- bf16 x times the bf16 embedding, f32 accumulation.
    f32 outputs within K f32 roundings of sum_k |x_k w_k| (times |scale|)
    per logit: the products are exact in f32, only the order differs."""
    rng = np.random.RandomState(31)
    x = rng.randn(2, 3, 128).astype(np.float32)
    if kind == "bf16":
        x = bf16_round(x)
        emb = bf16_round(rng.randn(200, 128).astype(np.float32) * 0.02)
        want = np.asarray(jnp.einsum(
            "btd,vd->btv", jnp.asarray(x, jnp.bfloat16),
            jnp.asarray(emb, jnp.bfloat16),
            preferred_element_type=jnp.float32))
        got = tk.decode_gemv_plain(t(x).bfloat16(), t(emb).bfloat16(),
                                   torch.bfloat16, logits=True)
        scale = np.ones(200, np.float32)
        xr, wr = x, emb
    else:
        jdt, tdt = ((jnp.float32, torch.float32) if kind == "int8_f32"
                    else (jnp.bfloat16, torch.bfloat16))
        emb = rng.randint(-127, 128, (200, 128)).astype(np.int8)
        scale = (rng.rand(200).astype(np.float32) + 0.1) * 1e-3
        want = np.asarray(jnp.einsum(
            "btd,vd->btv", jnp.asarray(x).astype(jdt),
            jnp.asarray(emb).astype(jdt),
            preferred_element_type=jnp.float32) * scale[None, None, :])
        got = tk.decode_gemv_plain(t(x), t(emb), tdt, t(scale), logits=True)
        xr = x if kind == "int8_f32" else bf16_round(x)
        wr = emb.astype(np.float32)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 200)
    mag = np.abs(xr) @ np.abs(wr).T * scale
    tol = 2 * 128 * 2.0 ** -24 * mag + 2.0 ** -24 * np.abs(want)
    assert (np.abs(got.numpy() - want) <= tol).all()


def _ln_module(K, dtype, rng):
    """The model's LayerNorm with seeded parameters in `dtype`."""
    from notsofar_tpu_torch.models.whisper import LN_EPS, LayerNorm
    ln = LayerNorm(K, eps=LN_EPS)
    with torch.no_grad():
        ln.weight.copy_(t(1 + 0.1 * rng.randn(K).astype(np.float32)))
        ln.bias.copy_(t(0.1 * rng.randn(K).astype(np.float32)))
    return ln.to(dtype)


# the unfused sequences of a decode step that decode_gemv's fused modes
# replace: int8 (QuantDense, bf16 compute, the f32 residual stream), bf16
# (a bf16 Linear through decode_gemv, the bf16 stream), int8 in f32 compute
@pytest.mark.parametrize("kind", ["int8", "bf16", "int8_f32"])
@pytest.mark.parametrize("mode", ["ln", "ln+gelu", "residual", "ln+post"])
def test_decode_gemv_fused_plain_equals_the_unfused_sequence(kind, mode):
    """Each fused mode's plain version equals, bit for bit, the sequence of
    PyTorch ops the model ran before it: the model's LayerNorm module, then
    the dense layer (QuantDense with its out_dtype, or decode_gemv_plain's
    dense mode for a bf16 Linear), then nn.GELU, or the residual stream plus
    the layer's output; the int8 query's post step behind the layer norm
    likewise."""
    from notsofar_tpu_torch.models.whisper import QuantDense
    rng = np.random.RandomState(len(mode) + len(kind))
    M, K, N = 6, 128, 96
    dt = torch.float32 if kind == "int8_f32" else torch.bfloat16
    sdt = torch.bfloat16 if kind == "bf16" else torch.float32   # stream
    x = t(rng.randn(M, 1, K).astype(np.float32) * 2 + 0.5).to(sdt)
    ln = _ln_module(K, dt, rng)
    gln = tk.GemvLN(ln.weight, ln.bias, ln.eps)
    if kind == "bf16":
        w = t(rng.randn(N, K).astype(np.float32) * 0.05).bfloat16()
        s, b = None, t(rng.randn(N).astype(np.float32) * 0.1).bfloat16()

        def dense(h, **kw):
            return tk.decode_gemv_plain(h, w, dt, s, b, **kw)
    else:
        layer = QuantDense(K, N)
        with torch.no_grad():
            layer.weight.copy_(t(rng.randint(-127, 128, (N, K)).astype(
                np.int8)))
            layer.scale.copy_(t((rng.rand(N).astype(np.float32) + 0.1)
                                * 1e-2))
            layer.bias.copy_(t(rng.randn(N).astype(np.float32) * 0.1))
        layer.bias.data = layer.bias.data.to(dt)
        layer.dtype = dt
        w, s, b = layer.weight, layer.scale, layer.bias

        def dense(h, **kw):
            return layer(h, **kw)
    if mode == "ln":
        want = dense(ln(x))
        got = tk.decode_gemv_plain(x, w, dt, s, b, ln=gln)
    elif mode == "ln+gelu":
        want = torch.nn.GELU(approximate="none")(dense(ln(x)))
        got = tk.decode_gemv_plain(x, w, dt, s, b, ln=gln, gelu=True)
    elif mode == "residual":
        h = t(rng.randn(M, 1, K).astype(np.float32)).to(dt)
        if kind != "bf16":
            layer.out_dtype = torch.float32 if kind == "int8" else None
        r = t(rng.randn(M, 1, N).astype(np.float32) * 4).to(sdt)
        want = r + dense(h)
        got = tk.decode_gemv_plain(h, w, dt, s, b, residual=r)
    else:
        p = t((rng.rand(2, N).astype(np.float32) + 0.1) * 1e-2)
        post = (64 ** -0.25, p, 3)
        if kind == "bf16":
            want = tk.decode_gemv_plain(ln(x), w, dt, s, b, post=post)
        else:
            want = layer(ln(x), post=post)
        got = tk.decode_gemv_plain(x, w, dt, s, b, post=post, ln=gln)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["int8", "bf16", "int8_f32"])
@pytest.mark.parametrize("slot_kind", ["tensor", "int"])
def test_decode_qkv_plain_equals_the_unfused_sequence(kind, slot_kind):
    """decode_qkv_plain equals, bit for bit, the self-attention's unfused
    projections of a single-token step: the model's LayerNorm, the three
    dense layers (decode_gemv_plain's dense mode, QuantDense's rounding
    points for int8 weights, nn.Dense's for bf16), k and v cast to the
    cache dtype and written with index_copy_ at the slot (or assigned at a
    host int), q scaled by d_k**-0.5 and cast to the cache dtype; the rest
    of each cache unchanged."""
    rng = np.random.RandomState(5 + len(kind))
    B, K, ctx = 4, 128, 16
    dt = torch.float32 if kind == "int8_f32" else torch.bfloat16
    sdt = torch.bfloat16 if kind == "bf16" else torch.float32
    x = t(rng.randn(B, 1, K).astype(np.float32) * 2).to(sdt)
    ln = _ln_module(K, dt, rng)
    layers = []
    for i in range(3):
        if kind == "bf16":
            w = t(rng.randn(K, K).astype(np.float32) * 0.05).bfloat16()
            sc = None
        else:
            w = t(rng.randint(-127, 128, (K, K)).astype(np.int8))
            sc = t((rng.rand(K).astype(np.float32) + 0.1) * 1e-2)
        b = None if i == 1 else t(rng.randn(K).astype(np.float32)).to(dt)
        layers.append((w, sc, b))
    kc = t(rng.randn(B, ctx, K).astype(np.float32)).to(dt)
    vc = t(rng.randn(B, ctx, K).astype(np.float32)).to(dt)
    pos = 11
    slot = torch.tensor(pos, dtype=torch.int32) if slot_kind == "tensor" \
        else pos
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    got = tk.decode_qkv_plain(x, tk.GemvLN(ln.weight, ln.bias, ln.eps),
                              layers, dt, k1, v1, slot, 64 ** -0.5)
    h = ln(x)
    q, k, v = (tk.decode_gemv_plain(h, w, dt, sc, b) for w, sc, b in layers)
    idx = torch.tensor([pos])
    k2.index_copy_(1, idx, k.to(k2.dtype))
    v2.index_copy_(1, idx, v.to(v2.dtype))
    want = (q * (64 ** -0.5)).to(k2.dtype)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    rest = torch.arange(ctx) != pos
    assert torch.equal(k1[:, rest], kc[:, rest])


def test_decode_gemv_plain_matches_flax_dense_bf16():
    """The bf16 decoder's dense layers at decode rows (decode_gemv's dense
    mode without a scale): dtype(acc) then dtype(y + dtype(b)), flax
    nn.Dense(dtype=bf16)'s rounding points, on the same bf16-rounded
    kernel, bias and x. Each output within one bf16 ulp of flax's (an f32
    summation order may send the first rounding the other way) and at
    least 99% bit-equal; addmm's single rounding (the matmul path) is
    further off."""
    import flax.linen as fnn
    rng = np.random.RandomState(21)
    x = bf16_round(rng.randn(6, 1, 256).astype(np.float32))
    k = bf16_round(rng.randn(256, 96).astype(np.float32) * 0.06)
    b = bf16_round(rng.randn(96).astype(np.float32))
    want = np.asarray(fnn.Dense(96, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": k, "bias": b}}, jnp.asarray(x))
        .astype(jnp.float32))
    got = tk.decode_gemv_plain(t(x).bfloat16(), t(k.T.copy()).bfloat16(),
                               torch.bfloat16, bias=t(b).bfloat16())
    assert got.dtype == torch.bfloat16 and got.shape == (6, 1, 96)
    got = got.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp).all()
    assert (got == want).mean() >= 0.99
    addmm = torch.nn.functional.linear(t(x).bfloat16(),
                                       t(k.T.copy()).bfloat16(),
                                       t(b).bfloat16()).float().numpy()
    assert (addmm == want).mean() < (got == want).mean()


# the decode step's shapes at large-v3 (3, 15, 48 rows; 1280 -> 1280, 5120,
# 51 866 and 5120 -> 1280), the small models' widths, a ragged N
@pytest.mark.parametrize("M,N,K", [(3, 1280, 1280), (15, 5120, 1280),
                                   (48, 1280, 5120), (48, 51866, 1280),
                                   (64, 1864, 128), (1, 40, 64),
                                   (5, 200, 512)])
@pytest.mark.parametrize("wdtype,planes", [(torch.int8, 1),
                                           (torch.bfloat16, 1),
                                           (torch.int8, 3)])
@pytest.mark.parametrize("ln,segments", [(False, 1), (True, 1), (True, 3)])
def test_decode_gemv_plan_covers_k_once_and_fits(M, N, K, wdtype, planes, ln,
                                                 segments):
    """decode_gemv_launch: R <= 8 shares of K's 64-byte chunks that cover
    them exactly once (R at most the chunk count), ceil(N / 64) blocks of
    64 channels along y per segment (three for the q/k/v launch), enough
    tiles of 8 rows for M, and a block's shared memory within SMEM_LIMIT,
    the layer norm's included; R reaches DECODE_GEMV_FILL blocks where the
    chunks allow; R may be given."""
    widths = N if segments == 1 else [N] * segments
    plan = tk.decode_gemv_launch(M, widths, K, wdtype, planes, ln=ln)
    nck = K // tk._gemv_chunk(wdtype)
    R, tiles = plan["cluster"], segments * -(-N // tk.DECODE_GEMV_CHANNELS)
    assert 1 <= R <= min(8, nck) and plan["grid"] == (R, tiles)
    assert covers_once(plan["shares"], nck) and len(plan["shares"]) == R
    assert 8 * plan["tiles"] >= M and plan["tiles"] in (1, 2, 4, 6, 8)
    assert plan["smem"] <= tk.SMEM_LIMIT
    assert R * tiles >= tk.DECODE_GEMV_FILL or R == min(8, nck)
    if ln:
        assert plan["smem"] > tk.decode_gemv_launch(
            M, widths, K, wdtype, planes, R=R)["smem"]
    forced = tk.decode_gemv_launch(M, widths, K, wdtype, planes, ln=ln, R=1)
    assert forced["cluster"] == 1 and covers_once(forced["shares"], nck)


def test_decode_gemv_wrapper_raises_what_the_kernel_does_not_take():
    """The wrapper's checks (shapes only, before any launch): more rows
    than DECODE_GEMV_MAX_ROWS, K not a multiple of 64, f32 weights, a bias
    in logits mode, a scale of another length, f16 x; the serving shapes
    pass."""
    w8 = torch.empty(1280, 1280, dtype=torch.int8)
    x = torch.empty(3, 1, 1280, dtype=torch.bfloat16)
    sc = torch.empty(1280)
    assert tk._decode_gemv_plan(x, w8, torch.bfloat16, sc, sc.bfloat16(),
                                False) == tk.decode_gemv_launch(
                                    3, 1280, 1280, torch.int8, 1)
    assert tk.DECODE_GEMV_MAX_ROWS >= 64
    bad = [(torch.empty(65, 1280, dtype=torch.bfloat16), w8, sc, None, False),
           (x[..., :96], torch.empty(1280, 96, dtype=torch.int8), sc, None,
            False),
           (x, w8.float(), sc, None, False),
           (x, w8, sc, sc, True),
           (x, w8, sc[:100], None, False),
           (x.half(), w8, sc, None, False)]
    for xx, ww, ss, bb, lg in bad:
        with pytest.raises(ValueError):
            tk._decode_gemv_plan(xx, ww, torch.bfloat16, ss, bb, lg)


@pytest.mark.parametrize("D,dk", [(1280, 64), (256, 128), (128, 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_xattn_step_plan_covers_the_keys_once(D, dk, dtype):
    """xattn_step_launch over T 1-8 and S 1-64, ragged S and Whisper's
    1500 frames: R <= 8 nonempty shares covering [0, S) once, each within
    the block's capacity (a multiple of 16 keys), grid (R, H, B) from the
    shapes, a block's shared memory within SMEM_LIMIT; R the split-softmax
    cluster size of S, grown only where a smaller R does not fit; at
    large-v3's 20 heads against 1500 frames R = 8 at Tq 1 and 5 for 1-4
    windows (one window: transcribe and the fallback ladder's subsets;
    three: the smoke's session); the wrapper raises past 8 queries."""
    esize = 2 if dtype == torch.bfloat16 else 4
    for T in range(1, 9):
        for S in list(range(1, 65)) + [100, 448, 1499, 1500, 1501, 1504]:
            plan = tk.xattn_step_launch(3, T, S, D, dk, dtype)
            R, cap = plan["cluster"], plan["per"]
            assert 1 <= R <= 8 and plan["grid"] == (R, D // dk, 3)
            assert cap % 16 == 0 and cap >= -(-S // R)
            assert covers_once(plan["shares"], S)
            assert all(0 < n <= cap for _, n in plan["shares"])
            assert plan["smem"] == tk.xattn_step_smem(cap, dk, esize, T, R)
            assert plan["smem"] <= tk.SMEM_LIMIT
            assert R >= min(8, -(-S // 32))
            for R2 in range(min(8, -(-S // 32)), R):
                cap2 = -(-(-(-S // R2)) // 16) * 16
                assert tk.xattn_step_smem(cap2, dk, esize, T, R2) > \
                    tk.SMEM_LIMIT
    if (D, dk) == (1280, 64):
        for B in (1, 2, 3, 4):
            for T in (1, 5):
                plan = tk.xattn_step_launch(B, T, 1500, D, dk, dtype)
                assert plan["cluster"] == 8 and plan["grid"] == (8, 20, B)
    q = torch.empty(3, 9, D, dtype=dtype)
    k = torch.empty(3, 1500, D, dtype=dtype)
    with pytest.raises(ValueError):
        tk._xattn_step_plan(q, k, k, dk)
    with pytest.raises(ValueError):
        tk._xattn_step_plan(q[:, :5], k, k.half(), dk)
    assert tk._xattn_step_plan(q[:, :5], k, k, dk) == \
        tk.xattn_step_launch(3, 5, 1500, D, dk, dtype)


def pv_fragment_walk(p, v, len_):
    """A numpy model of csrc/xattn_step.cu's bf16 p.v over one share: the
    share's value rows staged as the copies land (row i at i * dk * 2 bytes,
    its 16-byte piece k in slot k ^ (i % 8), zeros from the share's end to
    its last 16-key tile's), each warp's 16-channel tiles walked 16 keys at
    a time, batches of four tiles in two chains: lane l gives the
    address of key k0 + l % 8 + 8 (l / 16) at channel m0 + 8 (l / 8 % 2),
    ldmatrix.trans hands lane (g, c4) (row 2c4, col g) and (2c4 + 1, g) of
    each 8 x 8 matrix, P's B fragment holds query g's weights of keys k0 +
    2c4, + 1, + 8, + 9 (zero past Tq); mma.sync's A (16 x 16) and B (16 x
    8) reassembled from the lanes' fragments, D = A B accumulated in each
    lane's four registers (float64: every product and sum exact for the
    integer-valued inputs). p [T, len_], v [len_, dk] -> out [T, dk]."""
    T, dk = p.shape[0], v.shape[1]
    rows = -(-len_ // 16) * 16
    ppr = dk // 8                              # 16-byte pieces of a row
    smem = np.full((rows * dk,), np.nan)       # in bf16 elements

    def piece(i, kp):                          # element offset
        return i * dk + ((kp ^ (i & 7)) << 3)

    for i in range(rows):
        for kp in range(ppr):
            off = piece(i, kp)
            smem[off:off + 8] = (v[i, kp * 8:kp * 8 + 8] if i < len_
                                 else 0.0)
    lane = np.arange(32)
    g, c4 = lane // 4, lane % 4
    lrow, lch = (lane & 7) + 8 * (lane >> 4), 8 * ((lane >> 3) & 1)
    pz = np.zeros((8, -(-len_ // 16) * 16))
    pz[:T, :len_] = p
    out = np.zeros((T, dk))
    mpw = dk // 16 // 4
    for warp in range(4):
        for m in range(mpw):
            m0 = (warp * mpw + m) * 16
            acc = np.zeros((2, 32, 4))
            for k0 in range(0, len_, 16):
                key, ch = k0 + lrow, m0 + lch
                addr = piece(key, ch // 8)
                mats = [np.stack([smem[addr[8 * j + r]:addr[8 * j + r] + 8]
                                  for r in range(8)]) for j in range(4)]
                a = np.stack([np.stack([mt[2 * c4, g], mt[2 * c4 + 1, g]], 1)
                              for mt in mats])            # [4, lanes, 2]
                b0 = np.stack([pz[g, k0 + 2 * c4], pz[g, k0 + 2 * c4 + 1]],
                              1)
                b1 = np.stack([pz[g, k0 + 8 + 2 * c4],
                               pz[g, k0 + 9 + 2 * c4]], 1)
                A = np.full((16, 16), np.nan)
                B = np.full((16, 8), np.nan)
                for e in range(2):
                    A[g, 2 * c4 + e] = a[0][:, e]
                    A[g + 8, 2 * c4 + e] = a[1][:, e]
                    A[g, 8 + 2 * c4 + e] = a[2][:, e]
                    A[g + 8, 8 + 2 * c4 + e] = a[3][:, e]
                    B[2 * c4 + e, g] = b0[:, e]
                    B[8 + 2 * c4 + e, g] = b1[:, e]
                Dm = A @ B
                acc[k0 // 16 % 2] += np.stack(
                    [Dm[g, 2 * c4], Dm[g, 2 * c4 + 1], Dm[g + 8, 2 * c4],
                     Dm[g + 8, 2 * c4 + 1]], 1)
            acc = acc[0] + acc[1]
            for e in range(4):
                t = 2 * c4 + (e & 1)
                chn = m0 + g + 8 * (e >> 1)
                keep = t < T
                out[t[keep], chn[keep]] = acc[keep, e]
    return out


@pytest.mark.parametrize("dk", [64, 128])
@pytest.mark.parametrize("T", range(2, 9))
def test_xattn_step_pv_fragment_walk_reassembles_p_v(T, dk):
    """The tensor-core p.v's fragment walk (pv_fragment_walk; bf16 at Tq >=
    2, one query takes the FMA pass) over the
    shares of the plan (Whisper's 1500 frames at the plan's R, and a ragged
    53 keys in shares of 27 and 26) puts every product p[t, s] v[s, c] into
    out[t, c] exactly once: integer-valued p and v give p @ v exactly. On
    xattn_step_plain's own bf16 weights and bf16 values, the shares' sums
    in rank order, rounded to bf16, are xattn_step_plain's output within
    one bf16 ulp (its f32 p.v sums in another order)."""
    rng = np.random.RandomState(T * 7 + dk)
    for S, R in ((1500, tk.xattn_step_launch(1, T, 1500, dk, dk,
                                             torch.bfloat16)["cluster"]),
                 (53, 2)):
        shares = tk.split_shares(S, R)
        pi = rng.randint(-8, 9, (T, S)).astype(np.float64)
        vi = rng.randint(-8, 9, (S, dk)).astype(np.float64)
        got = sum(pv_fragment_walk(pi[:, c0:c0 + n], vi[c0:c0 + n], n)
                  for c0, n in shares)
        np.testing.assert_array_equal(got, pi @ vi)
        if S != 1500:
            continue
        q = bf16_round(rng.randn(1, T, dk).astype(np.float32) * 2)
        k = bf16_round(rng.randn(1, S, dk).astype(np.float32))
        v = bf16_round(rng.randn(1, S, dk).astype(np.float32))
        qt, kt = (t(x[0]).bfloat16() * dk ** -0.25 for x in (q, k))
        w = torch.softmax(qt.float() @ kt.float().T, -1)   # as the plain
        pw = w.to(torch.bfloat16).double().numpy()
        model = np.zeros((T, dk))
        for c0, n in shares:
            model = model + pv_fragment_walk(pw[:, c0:c0 + n],
                                             v[0, c0:c0 + n].astype(
                                                 np.float64), n)
        want = tk.xattn_step_plain(t(q).bfloat16(), t(k).bfloat16(),
                                   t(v).bfloat16(), dk).float().numpy()[0]
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(model), 1e-30)))
                      - 7)
        assert (np.abs(bf16_round(model.astype(np.float32)) - want)
                <= ulp + 1e-30).all()


@pytest.mark.parametrize("B,S,D,dk", [(24, 1504, 1280, 64), (2, 96, 384, 64),
                                      (3, 64, 256, 128), (1, 40, 4096, 128),
                                      (140, 64, 256, 64)])
def test_xattn_onedot_plan_covers_the_valid_keys_once(B, S, D, dk):
    """xattn_onedot_launch for every s_valid of S: R <= 8 shares covering
    [0, s_valid) once (empty shares allowed), the grid (R, B) fixed by the
    shapes, every head's logits of a share within its odd row stride, and
    a block's shared memory within SMEM_LIMIT."""
    grid = None
    for s_valid in range(1, S + 1):
        plan = tk.xattn_onedot_launch(B, S, D, dk, s_valid)
        R = plan["cluster"]
        assert 1 <= R <= 8 and plan["grid"] == (R, B)
        assert grid in (None, plan["grid"])
        grid = plan["grid"]
        assert covers_once(plan["shares"], s_valid)
        assert plan["smem"] <= tk.SMEM_LIMIT


@pytest.mark.parametrize("K,M", [(4, 7), (1, 1), (8, 8), (3, 4)])
def test_masked_scm_plan_fits_the_ring(K, M):
    """masked_scm_launch: a warp per (b, f), 4 a block, grid (ceil(F / 4),
    B); every ring of 1-8 buffers of 32 frames fits a block's shared
    memory, and the default ring is more than one buffer (the next frames
    in flight while the lanes compute)."""
    assert tk.MASKED_SCM_STAGES > 1
    for stages in range(1, 9):
        plan = tk.masked_scm_launch(32, 257, K, M, stages)
        assert plan["grid"] == (65, 32) and plan["threads"] == 128
        assert plan["smem"] <= tk.SMEM_LIMIT


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA-only)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("S,dk,dtype,tol,BH", [
    (621, 64, torch.bfloat16, 1e-2, 6),   # one bf16 ulp at |out| <= 2
    (1500, 64, torch.bfloat16, 1e-2, 6),
    (1500, 128, torch.bfloat16, 1e-2, 6),
    (621, 64, torch.float32, 1e-5, 6),    # f32 sums in another order
    (1500, 128, torch.float32, 1e-5, 6),
    # the wgmma kernel's edges: one key; one 64-row half of a block; a
    # ragged 128-key tile; a whole number of tiles; odd BH; dk 128 ragged
    (1, 64, torch.bfloat16, 1e-2, 5),
    (64, 64, torch.bfloat16, 1e-2, 5),
    (127, 64, torch.bfloat16, 1e-2, 5),
    (1500, 64, torch.bfloat16, 1e-2, 61),
    (1536, 64, torch.bfloat16, 1e-2, 5),
    (127, 128, torch.bfloat16, 1e-2, 3),
])
def test_gpu_encoder_mha_kernel(cuda, S, dk, dtype, tol, BH):
    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn(BH, S, dk, generator=g, device=cuda)
               .mul(0.35).to(dtype) for _ in range(3))
    before = tk.LAUNCHES["encoder_mha"]
    out = tk.encoder_mha(q, k, v)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["encoder_mha"] == before + 1
    assert out.dtype == dtype
    err = (out.float() - tk.encoder_mha_plain(q, k, v).float()).abs().max()
    assert err.item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dk", [64, 128])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-3)])
def test_gpu_attn_step_kernel(cuda, dtype, tol, dk):
    """The cluster kernel against its plain version with pos as an int and
    as a device tensor, at the first slot, below a row's pad (that row sees
    key pos alone), in the middle and at the last slot; the two forms give
    the same bits and each launches once."""
    g = torch.Generator(device=cuda).manual_seed(3 + dk)
    B, ctx, D = 5, 96, 1280
    q = torch.randn(B, 1, D, generator=g, device=cuda).mul(0.125).to(dtype)
    kc, vc = (torch.randn(B, ctx, D, generator=g, device=cuda).to(dtype)
              for _ in range(2))
    pads = torch.tensor([0, 3, 9, 40, 70], dtype=torch.int32, device=cuda)
    for pos in (0, 30, 70, ctx - 1):
        ref = tk.attn_step_plain(q, kc, vc, pos, pads, dk)
        outs = []
        for slot in (pos, torch.tensor(pos, dtype=torch.int32, device=cuda)):
            before = tk.LAUNCHES["attn_step"]
            outs.append(tk.attn_step(q, kc, vc, slot, pads, dk))
            torch.cuda.synchronize()
            assert tk.LAUNCHES["attn_step"] == before + 1
            assert (outs[-1] - ref).abs().max().item() <= tol, (pos, slot)
        assert torch.equal(outs[0], outs[1])


@pytest.mark.gpu
@pytest.mark.parametrize("K", [5, 1, 9, 16])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-3)])
def test_gpu_attn_step_split_kernel(cuda, dtype, tol, K):
    """The cluster kernel against its plain version at K beams (past the
    first kernel's 8 included), with and without ancestry, gslot at 0, in
    the middle and at G - 1, as an int and as a device tensor; stream 2's
    pad passes the prompt (no prompt key visible)."""
    g = torch.Generator(device=cuda).manual_seed(4 + K)
    B, Pp, G, D, dk = 3, 32, 64, 1280, 64
    q = torch.randn(B * K, 1, D, generator=g, device=cuda).mul(0.125) \
        .to(dtype)
    kp, vp = (torch.randn(B, Pp, D, generator=g, device=cuda).to(dtype)
              for _ in range(2))
    kg, vg = (torch.randn(B * K, G, D, generator=g, device=cuda).to(dtype)
              for _ in range(2))
    pads = torch.tensor([0, 7, Pp + 3], dtype=torch.int32, device=cuda)
    for gslot in (0, 20, G - 1):
        anc = torch.randint(0, K, (B, K, G), generator=g, device=cuda,
                            dtype=torch.int32)
        anc[:, :, gslot] = torch.arange(K, dtype=torch.int32, device=cuda)
        slot_t = torch.tensor(gslot, dtype=torch.int32, device=cuda)
        for a in (None, anc):
            ref = tk.attn_step_split_plain(q, kp, vp, kg, vg, gslot, pads,
                                           dk, K, a)
            for slot in (gslot, slot_t):
                before = tk.LAUNCHES["attn_step_split"]
                out = tk.attn_step_split(q, kp, vp, kg, vg, slot, pads, dk,
                                         K, a)
                torch.cuda.synchronize()
                assert tk.LAUNCHES["attn_step_split"] == before + 1
                assert (out - ref).abs().max().item() <= tol, (gslot, slot)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,C,k", [(40, 128, 3), (320, 1024, 15),
                                   (97, 256, 7), (64, 128, 11),
                                   (1, 128, 16), (200, 384, 2),
                                   (97, 256, 17), (320, 1024, 33)])
def test_gpu_depthwise_conv1d_kernel(cuda, T, C, k, dtype):
    """The CUDA kernel against its plain version, ragged T included. The
    kernel sums with FMAs, the plain version with a rounded product and a
    rounded add, each in the order i = 0..k-1: they differ by at most
    2k f32 roundings of the sum of |terms| (tolerance 2k * 2**-24 of
    max sum |x w|)."""
    g = torch.Generator(device=cuda).manual_seed(T + C + k)
    B = 3
    x = torch.randn(B, T, C, generator=g, device=cuda).to(dtype)
    w = torch.randn(k, C, generator=g, device=cuda) * 0.3
    before = tk.LAUNCHES["depthwise_conv1d"]
    out = tk.depthwise_conv1d(x, w, k)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["depthwise_conv1d"] == before + 1
    assert out.dtype == torch.float32 and out.shape == (B, T, C)
    ref = tk.depthwise_conv1d_plain(x, w, k)
    mag = tk.depthwise_conv1d_plain(x.abs(), w.abs(), k).max().item()
    assert (out - ref).abs().max().item() <= 2 * k * 2.0 ** -24 * mag


@pytest.mark.gpu
@pytest.mark.parametrize("B,F,T,K,M", [(32, 257, 186, 4, 7), (3, 9, 40, 4, 7),
                                       (2, 5, 33, 3, 4), (1, 7, 1, 1, 1),
                                       (2, 6, 70, 8, 8), (2, 5, 300, 5, 3)])
def test_gpu_masked_scm_kernel(cuda, B, F, T, K, M):
    """The CUDA kernel against its plain version (complex einsum), ragged
    frame tiles, odd F and the M = 8 second lane entry included. Both sum
    T products in f32 in other orders: within 2T f32 roundings of
    sum_t w |x_m| |x_n| (largest entry). Hermitian with a real diagonal;
    an all-zero window gives exactly 1e-15 * I. The ring of buffers in
    flight (1-8 of 32 frames, wrapping where T needs more) changes when the
    bytes arrive, never the order of the sums: every count gives the same
    bits."""
    g = torch.Generator(device=cuda).manual_seed(B + F + T + K + M)
    wta = torch.rand(B, F, T, K, generator=g, device=cuda)
    x = torch.complex(torch.randn(B, F, T, M, generator=g, device=cuda),
                      torch.randn(B, F, T, M, generator=g, device=cuda))
    x[0, 0] = 0
    before = tk.LAUNCHES["masked_scm"]
    out = tk.masked_scm(wta, x)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["masked_scm"] == before + 1
    assert out.dtype == torch.complex64 and out.shape == (B, K, F, M, M)
    ref = tk.masked_scm_plain(wta, x)
    mag = tk.masked_scm_plain(wta, x.abs().to(torch.complex64)).real
    assert (out - ref).abs().max().item() <= 2 * T * 2.0 ** -24 * \
        mag.max().item()
    assert torch.equal(out, out.conj().transpose(-1, -2).resolve_conj())
    eye = torch.eye(M, dtype=torch.complex64, device=cuda) * 1e-15
    assert torch.equal(out[0, :, 0], eye.expand(K, M, M))
    lib = tk.build.load("masked_scm")
    for stages in range(1, 9):
        other = torch.empty_like(out)
        assert lib.masked_scm(wta.data_ptr(), x.data_ptr(), other.data_ptr(),
                              B, F, T, K, M, stages, tk._stream()) == 0
        torch.cuda.synchronize()
        assert torch.equal(other, out), stages


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,D,dk,S,s_valid,q_scale", [
    (9, 5, 1280, 64, 1504, 1500, 0.004),     # beam 5, 9 streams
    (48, 1, 1280, 64, 1504, 1500, 0.004),    # greedy, 48 rows
    (2, 8, 256, 128, 96, 77, 0.2), (3, 3, 384, 64, 64, 33, 0.2),
    (1, 1, 128, 64, 1504, 1500, 0.004),
    # the cluster's shares: s_valid not a multiple of R; s_valid < R
    # (empty shares) at T 8 and dk 128, and at T 1
    (9, 5, 1280, 64, 1504, 1499, 0.004), (3, 8, 256, 128, 256, 3, 0.2),
    (2, 1, 128, 128, 320, 5, 0.2),
    # a block per row (XATTN_ROW_PAIRS pairs) at T 8 and dk 128
    (66, 8, 1024, 128, 96, 77, 0.2)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gpu_xattn_int8_kernel(cuda, B, T, D, dk, S, s_valid, q_scale,
                               dtype):
    """The CUDA kernel against its plain version within the tolerances of
    test_xattn_int8_plain_matches_pallas; the plain version with the key
    of the largest weight negated is outside the max tolerance, and with
    the rounding of p moved (at unit-scale logits), outside the RMS
    tolerance. Keys past s_valid are not read: they hold garbage here."""
    rng = np.random.RandomState(B + T + S)
    q, k8, v8, vs = xattn_case(rng, B, T, D, dk, S, s_valid, q_scale)
    qc = t(q).to(cuda, dtype)
    k8c, v8c, vsc = (t(x).to(cuda) for x in (k8, v8, vs))
    k8c[:, s_valid:] = 127
    v8c[:, s_valid:] = -128
    plan = tk.xattn_int8_launch(B, T, S, D, dk, s_valid, dtype)
    if s_valid < 8 and S >= 256:       # the cases with empty shares
        assert plan["cluster"] > s_valid
        assert any(n == 0 for _, n in plan["shares"])
    before = tk.LAUNCHES["xattn_int8"]
    out = tk.xattn_int8(qc, k8c, v8c, vsc, dk, s_valid)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["xattn_int8"] == before + 1
    assert out.dtype == torch.float32 and out.shape == (B, T, D)
    ref = tk.xattn_int8_plain(qc, k8c, v8c, vsc, dk, s_valid)
    tol = xattn_tolerance(q, k8, vs, dk, s_valid)
    assert (out - ref).abs().max().item() <= tol
    rms_tol = xattn_rms_tolerance(q, k8, v8, vs, dk, s_valid)
    assert rms(out - ref) <= rms_tol
    lg = q[0, 0, :dk].astype(np.float64) @ k8[0, :s_valid, :dk].T.astype(
        np.float64)
    k_mut = k8.copy()
    k_mut[0, lg.argmax()] = -k_mut[0, lg.argmax()]
    mutant = tk.xattn_int8_plain(qc, t(k_mut).to(cuda), v8c, vsc, dk,
                                 s_valid)
    assert (out - mutant).abs().max().item() > tol
    for mode in ("unnormalized", "none") if q_scale < 0.01 else ():
        mutant = xattn_rounding_mutant(qc, k8c, v8c, vsc, dk, s_valid, mode)
        assert rms(out - mutant) > rms_tol, mode


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,D", [(24, 1504, 1280), (3, 5, 128),
                                   (2, 333, 272)])
def test_gpu_xattn_stream_kernel(cuda, B, S, D):
    """Bit for bit against the plain version: the output (integer sums,
    one f32 rounding) and the checksum of every K and V byte of a row;
    the tools' shape, S < 8, and rows that end inside a 32 KB chunk."""
    g = torch.Generator(device=cuda).manual_seed(S + D)
    k8, v8 = (torch.randint(-127, 128, (B, S, D), generator=g, device=cuda,
                            dtype=torch.int8) for _ in range(2))
    before = tk.LAUNCHES["xattn_stream"]
    out, checksum = tk.xattn_stream(k8, v8)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["xattn_stream"] == before + 1
    assert out.dtype == torch.float32 and out.shape == (B, 1, D)
    ref, ref_checksum = tk.xattn_stream_plain(k8, v8)
    assert torch.equal(out, ref)
    assert torch.equal(checksum, ref_checksum)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,D,dk,s_valid,q_scale", [
    (24, 1504, 1280, 64, 1504, 0.004),   # the tool's shape
    (24, 1504, 1280, 64, 1504, 0.1),     # and its q scale (peaked weights)
    (2, 96, 384, 64, 77, 0.004), (3, 64, 256, 128, 33, 0.2),
    (1, 40, 4096, 128, 40, 0.004),
    # the cluster's shares: s_valid not a multiple of R; s_valid < R
    # (empty shares) with an odd head count (H 3); more rows than SMs
    (5, 1504, 1280, 64, 1499, 0.004), (2, 256, 384, 128, 5, 0.2),
    (140, 64, 256, 64, 61, 0.2)])
def test_gpu_xattn_onedot_kernel(cuda, B, S, D, dk, s_valid, q_scale):
    """The CUDA kernel against its plain version within xattn_tolerance
    (flip 2**-6) and onedot_rms_tolerance; the plain version with the key
    of the largest logit negated is outside the max tolerance, and at
    unit-scale logits with the products unrounded, outside the RMS
    tolerance. Keys past s_valid hold garbage: they are not read."""
    rng = np.random.RandomState(B + S + D)
    q, k8, v8, vs = xattn_case(rng, B, 1, D, dk, S, s_valid, q_scale)
    qc = t(q).to(cuda, torch.bfloat16)
    k8c, v8c, vsc = (t(x).to(cuda) for x in (k8, v8, vs))
    k8c[:, s_valid:] = 127
    v8c[:, s_valid:] = -128
    before = tk.LAUNCHES["xattn_onedot"]
    out = tk.xattn_onedot(qc, k8c, v8c, vsc, dk, s_valid)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["xattn_onedot"] == before + 1
    assert out.dtype == torch.float32 and out.shape == (B, 1, D)
    ref = tk.xattn_onedot_plain(qc, k8c, v8c, vsc, dk, s_valid)
    tol = xattn_tolerance(q, k8, vs, dk, s_valid, flip=2.0 ** -6)
    assert (out - ref).abs().max().item() <= tol
    rms_tol = onedot_rms_tolerance(q, k8, v8, vs, dk, s_valid)
    assert rms(out - ref) <= rms_tol
    lg = q[0, 0, :dk].astype(np.float64) @ k8[0, :s_valid, :dk].T.astype(
        np.float64)
    k_mut = k8.copy()
    k_mut[0, lg.argmax()] = -k_mut[0, lg.argmax()]
    mutant = tk.xattn_onedot_plain(qc, t(k_mut).to(cuda), v8c, vsc, dk,
                                   s_valid)
    assert (out - mutant).abs().max().item() > tol
    if q_scale < 0.01:
        mutant = onedot_rounding_mutant(qc, k8c, v8c, vsc, dk, s_valid)
        assert rms(out - mutant) > rms_tol


@pytest.mark.gpu
@pytest.mark.parametrize("B,K,Pp,G,D,dk,dtype,bias_kind", [
    (8, 5, 256, 192, 1280, 64, torch.bfloat16, "visibility"),  # tool shape
    (8, 5, 256, 192, 1280, 64, torch.bfloat16, "finite"),
    (2, 3, 16, 8, 128, 64, torch.float32, "finite"),
    (3, 1, 40, 24, 256, 128, torch.bfloat16, "visibility"),
    (2, 8, 32, 16, 384, 128, torch.float32, "visibility"),
    # past the 8 beams of the first design, a row masked everywhere
    (2, 9, 224, 224, 1280, 64, torch.bfloat16, "finite"),
    (2, 16, 64, 32, 256, 64, torch.float32, "visibility"),
    (1, 16, 40, 24, 256, 128, torch.bfloat16, "finite")])
def test_gpu_attn_step_split_bias_kernel(cuda, B, K, Pp, G, D, dk, dtype,
                                         bias_kind):
    """The CUDA kernel against its plain version within
    split_bias_tolerance, the row masked everywhere included (the uniform
    average of the values); the key of the largest weight of a visible
    row negated is outside the tolerance."""
    rng = np.random.RandomState(B + K + Pp + G)
    q, kp, vp, kg, vg, bias = split_case(rng, B, K, Pp, G, bias_kind, D, dk)
    args = [t(x).to(cuda, dtype) for x in (q, kp, vp, kg, vg)]
    bias_c = t(bias).to(cuda)
    before = tk.LAUNCHES["attn_step_split_bias"]
    out = tk.attn_step_split_bias(*args, bias_c, dk)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["attn_step_split_bias"] == before + 1
    assert out.dtype == torch.float32 and out.shape == (B, K, D)
    ref = tk.attn_step_split_bias_plain(*args, bias_c, dk)
    keys = np.concatenate([kp, kg], 1)
    tol = split_bias_tolerance(q, keys, np.concatenate([vp, vg], 1), bias,
                               dk)
    assert (out - ref).abs().max().item() <= tol
    assert torch.isfinite(out).all()
    b = B - 1
    lg = q[b, 0, :dk].astype(np.float64) @ keys[b, :, :dk].T.astype(
        np.float64) + bias[b, 0]
    k_mut = keys.copy()
    k_mut[b, lg.argmax()] = -k_mut[b, lg.argmax()]
    mutant = tk.attn_step_split_bias_plain(
        args[0], t(k_mut[:, :Pp]).to(cuda, dtype), args[2],
        t(k_mut[:, Pp:]).to(cuda, dtype), args[4], bias_c, dk)
    assert (out - mutant).abs().max().item() > tol


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,D,dk,S,dtype", [
    (3, 1, 1280, 64, 1500, torch.bfloat16),   # greedy, 3 windows
    (3, 5, 1280, 64, 1500, torch.bfloat16),   # beam 5 folded
    (3, 5, 1280, 64, 1500, torch.float32),
    (2, 8, 256, 128, 96, torch.bfloat16), (2, 3, 384, 64, 77, torch.float32),
    # the shares: S not a multiple of R; S < R (empty shares); S = 1
    (3, 2, 128, 64, 1499, torch.bfloat16), (2, 4, 256, 128, 5, torch.float32),
    (1, 1, 128, 64, 1, torch.bfloat16), (1, 7, 128, 64, 33, torch.bfloat16),
    # 6 and 8 queries, a ragged last share, heads of 128 (two channel
    # tiles a warp), 160 pairs in more than one wave, one and two windows
    # (transcribe, the fallback ladder's subsets)
    (3, 6, 1280, 64, 1500, torch.bfloat16),
    (3, 8, 1280, 64, 1500, torch.bfloat16),
    (3, 8, 1280, 64, 1500, torch.float32),
    (3, 5, 1280, 64, 1501, torch.bfloat16),
    (3, 5, 1280, 128, 1500, torch.bfloat16),
    (8, 5, 1280, 64, 1500, torch.bfloat16),
    (1, 1, 1280, 64, 1500, torch.bfloat16),
    (1, 5, 1280, 64, 1500, torch.bfloat16),
    (2, 5, 1280, 64, 1500, torch.bfloat16)])
def test_gpu_xattn_step_kernel(cuda, B, T, D, dk, S, dtype):
    """The CUDA kernel against its plain version, per output within
    xattn_step_tolerance without the JAX scale (both round dtype(q s) and
    dtype(k s) with f32 s; f32 orders, one flipped weight, the output's
    rounding); with the memory row (key and value) of the largest logit
    of window 0, query 0, head 0 negated the plain version lands outside
    it. Logits of a few units (q at 3x unit scale), so that one key
    matters."""
    rng = np.random.RandomState(B + T + S + D)
    q = rng.randn(B, T, D).astype(np.float32) * 3
    k = rng.randn(B, S, D).astype(np.float32)
    v = rng.randn(B, S, D).astype(np.float32)
    if dtype == torch.bfloat16:
        q, k, v = (bf16_round(x) for x in (q, k, v))
    qc, kc, vc = (t(x).to(cuda, dtype) for x in (q, k, v))
    before = tk.LAUNCHES["xattn_step"]
    out = tk.xattn_step(qc, kc, vc, dk)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["xattn_step"] == before + 1
    assert out.dtype == dtype and out.shape == (B, T, D)
    ref = tk.xattn_step_plain(qc, kc, vc, dk)
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    tol = torch.from_numpy(xattn_step_tolerance(q, k, v, dk, name,
                                                jax_scale=False)).to(cuda)
    assert ((out.float() - ref.float()).abs() <= tol).all()
    lg = q[0, 0, :dk].astype(np.float64) @ k[0, :, :dk].T.astype(np.float64)
    k_mut, v_mut = k.copy(), v.copy()
    k_mut[0, lg.argmax()] = -k_mut[0, lg.argmax()]
    v_mut[0, lg.argmax()] = -v_mut[0, lg.argmax()]
    mutant = tk.xattn_step_plain(qc, t(k_mut).to(cuda, dtype),
                                 t(v_mut).to(cuda, dtype), dk)
    assert ((out.float() - mutant.float()).abs() > tol).any()


def gemv_tolerance(x, w, scale, bias, dtype, logits, post=None):
    """Per-output bound on decode_gemv against its plain version on the
    card (f32 torch tensors holding x rounded to the compute dtype, w, the
    f32 scale, the bias): the f32 sums of K exact products differ by up to
    2 K roundings of sum_k |x w| (delta); each later rounding to bf16 may go
    the other way (<= 2**-7 of its value), carried through the scale and,
    with post (s, p, rows), through s p and one more rounding."""
    K = x.shape[-1]
    mag = x.abs() @ w.abs().T
    acc = x @ w.T
    delta = 2 * K * 2.0 ** -24 * mag
    s = torch.ones_like(acc[0]) if scale is None else scale
    if logits:
        return delta * s.abs() + 2.0 ** -23 * (acc * s).abs()
    if dtype == torch.float32:
        b = 0 if bias is None else bias
        return delta * s.abs() + 2.0 ** -22 * ((acc * s).abs() + abs(b))
    e = 2.0 ** -7
    d1 = delta + e * acc.abs()
    d2 = d1 * s.abs() + e * (acc * s).abs()
    y = acc * s + (0 if bias is None else bias)
    d3 = d2 + e * (y.abs() + d2) if bias is not None else d2 + e * d2
    if post is None:
        return d3
    ps = post[0] * post[1].repeat_interleave(post[2], dim=0).abs()
    return d3 * ps + e * ((y.abs() + d3) * ps)


LN_FLIPS = 4   # bf16 flips of x a row may take from the layer norm


def fused_tolerance(tol, xr, w, scale, ref, dtype, ln, gelu, residual,
                    post=None):
    """gemv_tolerance `tol` widened for the fused modes: with the layer
    norm, f32 statistics summed in another order than F.layer_norm's move
    each normalized x by a few f32 ulps, which can send a bf16 rounding of
    x the other way (at most LN_FLIPS elements a row, each by one bf16
    ulp, at most 2**-7 |x_k|, so 2**-7 |x_k| |w_nk| |s_n| on an output; in
    f32 compute, 8 f32 ulps of sum_k |x_k w_nk|), carried
    through the later roundings (and post's s p); GELU (slope < 1.13) and
    the residual add
    each add one rounding of the output (a bf16 ulp, or an f32 ulp for
    the f32 stream)."""
    e = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -23
    s = torch.ones_like(tol[0]) if scale is None else scale.abs()
    if ln and dtype == torch.bfloat16:
        flip = LN_FLIPS * 2.0 ** -7 * xr.abs().amax(-1, keepdim=True) * \
            w.abs().amax(-1)[None, :] * s
        if post is not None:
            flip = flip * post[0] * post[1].repeat_interleave(
                post[2], dim=0).abs()
        tol = tol + flip * (1 + 4 * e)
    elif ln:
        tol = tol + 8 * 2.0 ** -24 * (xr.abs() @ w.abs().T) * s
    if gelu:
        tol = 1.13 * tol + e * (ref.float().abs() + 1.13 * tol)
    if residual is not None:
        er = 2.0 ** -7 if residual.dtype == torch.bfloat16 else 2.0 ** -24
        tol = tol + er * (ref.float().abs() + tol)
    return tol


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K,wdt,xdt,dt,mode", [
    # QuantDense at large-v3: greedy 3 rows, beam 5 15 rows (f32 x, the
    # int8 model's LN output), the pipeline's 48, the f32 parity model
    (3, 1280, 1280, "int8", "bf16", "bf16", "dense+bias"),
    (3, 1280, 5120, "int8", "f32", "bf16", "dense+bias+f32out"),
    (15, 1280, 1280, "int8", "bf16", "bf16", "dense+bias+post"),
    (10, 256, 128, "int8", "f32", "f32", "dense+bias+post"),
    (15, 5120, 1280, "int8", "f32", "bf16", "dense+bias"),
    (48, 1280, 5120, "int8", "bf16", "bf16", "dense+bias"),
    (64, 1280, 1280, "int8", "f32", "f32", "dense+bias"),
    (2, 40, 512, "int8", "bf16", "bf16", "dense"),
    # logits: int8 (f32 LN output cast to bf16), bf16, the small f32 model
    (3, 51866, 1280, "int8", "f32", "bf16", "logits+scale"),
    (48, 51866, 1280, "int8", "f32", "bf16", "logits+scale"),
    (3, 51866, 1280, "bf16", "bf16", "bf16", "logits"),
    (5, 1864, 128, "int8", "f32", "f32", "logits+scale"),
    (7, 200, 64, "bf16", "f32", "f32", "logits"),
    (9, 130, 192, "bf16", "bf16", "f32", "dense+bias"),
    # the fused step's modes: the layer norm in the prologue (the int8
    # model's f32 stream, the bf16 model's bf16 stream, the f32 model's),
    # its statistics exchanged over the cluster (or, at 266 tiles of
    # channels, one block's own); GELU (fc1); the residual add (out
    # projections, fc2) into the f32 or bf16 stream; bf16 weights without
    # a scale (nn.Dense)
    (3, 1280, 1280, "int8", "f32", "bf16", "ln+dense+bias"),
    (8, 1280, 1280, "int8", "f32", "bf16", "ln+dense+bias"),
    (15, 1280, 1280, "int8", "f32", "bf16", "ln+dense+bias+post"),
    (48, 5120, 1280, "int8", "f32", "bf16", "ln+dense+bias+gelu"),
    (3, 5120, 1280, "bf16", "bf16", "bf16", "ln+dense+bias+gelu"),
    (15, 5120, 1280, "bf16", "bf16", "bf16", "ln+dense+bias+gelu"),
    (3, 1280, 5120, "int8", "bf16", "bf16", "dense+bias+res"),
    (48, 1280, 1280, "int8", "f32", "bf16", "dense+bias+res"),
    (15, 1280, 5120, "bf16", "bf16", "bf16", "dense+bias+res"),
    (3, 1280, 1280, "bf16", "bf16", "bf16", "dense+bias"),
    (10, 256, 128, "int8", "f32", "f32", "ln+dense+bias+gelu"),
    (3, 17024, 1280, "int8", "f32", "bf16", "ln+dense+bias"),
    (10, 128, 512, "int8", "f32", "f32", "dense+bias+res")])
def test_gpu_decode_gemv_kernel(cuda, M, N, K, wdt, xdt, dt, mode):
    """The CUDA kernel against its plain version per output within
    gemv_tolerance (fused_tolerance for the layer norm, GELU and residual
    modes); one weight of the row and column that matter most changed
    moves the kernel's output outside it. Ragged N edges (51 866, 1864,
    130, 200, 40), 1-8 row tiles, x rounded in the kernel (f32 x in bf16
    compute) or split into three bf16 planes (f32 x in f32 compute); the
    rounded dense output stored as f32 (out_dtype) holds the same values
    as the plain version's."""
    g = torch.Generator(device=cuda).manual_seed(M + N + K)
    dts = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8}
    ln = None
    if "ln" in mode:
        # a residual stream with a mean, the norm's parameters in the
        # model's dtype (bf16 for the bf16 and int8 decoders)
        x = (torch.randn(M, K, generator=g, device=cuda) * 2 + 0.5).to(
            dts[xdt])
        pdt = torch.float32 if dt == "f32" else torch.bfloat16
        ln = tk.GemvLN((1 + 0.1 * torch.randn(K, generator=g, device=cuda))
                       .to(pdt), (0.1 * torch.randn(K, generator=g,
                                                    device=cuda)).to(pdt),
                       1e-5)
    else:
        x = torch.randn(M, K, generator=g, device=cuda).to(dts[xdt])
    if wdt == "int8":
        w = torch.randint(-127, 128, (N, K), generator=g, device=cuda,
                          dtype=torch.int8)
    else:
        w = (torch.randn(N, K, generator=g, device=cuda) * 0.05).bfloat16()
    scale = (torch.rand(N, generator=g, device=cuda) + 0.1) * 1e-2 \
        if "scale" in mode or "dense" in mode and wdt == "int8" else None
    bias = (torch.randn(N, generator=g, device=cuda) * 0.1).to(dts[dt]) \
        if "bias" in mode else None
    logits = "logits" in mode
    out_dtype = torch.float32 if "f32out" in mode else None
    gelu = "gelu" in mode
    residual = (torch.randn(M, N, generator=g, device=cuda) * 4).to(
        dts[xdt]) if "res" in mode else None
    # the int8 cross-attention's query folding at 5 rows a window
    post = (64 ** -0.25, (torch.rand(M // 5, N, generator=g, device=cuda)
                          + 0.1) * 1e-2, 5) if "post" in mode else None
    kw = dict(logits=logits, out_dtype=out_dtype, post=post, ln=ln,
              gelu=gelu, residual=residual)
    before = tk.LAUNCHES["decode_gemv"]
    out = tk.decode_gemv(x, w, dts[dt], scale, bias, **kw)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["decode_gemv"] == before + 1
    assert out.shape == (M, N)
    assert out.dtype == (torch.float32 if logits else residual.dtype
                         if residual is not None else out_dtype or dts[dt])
    ref = tk.decode_gemv_plain(x, w, dts[dt], scale, bias, **kw)
    if out_dtype is not None:
        assert torch.equal(out.to(dts[dt]).float(), out)   # dtype's values
    xin = x if ln is None else tk.layer_norm_plain(x, ln)
    xr = xin.to(dts[dt]).float()
    tol = gemv_tolerance(xr, w.float(), scale,
                         None if bias is None else bias.float(), dts[dt],
                         logits, post)
    tol = fused_tolerance(tol, xr, w.float(), scale, ref, dts[dt],
                          ln is not None, gelu, residual, post)
    assert ((out.float() - ref.float()).abs() <= tol).all()
    # the weight of the largest |x| in row 0's column of the largest output
    n = int((xr[0].abs() @ w.float().abs().T).argmax())
    kk = int(xr[0].abs().argmax())
    w_mut = w.clone()
    w_mut[n, kk] = (-127 if w[n, kk] >= 0 else 127) if wdt == "int8" \
        else w[n, kk] - (1.0 if w[n, kk] >= 0 else -1.0)
    mutant = tk.decode_gemv_plain(x, w_mut, dts[dt], scale, bias, **kw)
    assert ((out.float() - mutant.float()).abs() > tol).any()


@pytest.mark.gpu
@pytest.mark.parametrize("B,ctx,wdt,stream,split,slot_kind", [
    (3, 256, "int8", "f32", False, "device"),    # greedy, int8 decoder
    (15, 64, "int8", "f32", True, "device"),     # beam 5, generated segment
    (3, 256, "bf16", "bf16", False, "device"),   # greedy, bf16 decoder
    (15, 64, "bf16", "bf16", True, "int"),
    (48, 448, "int8", "f32", False, "int"),
    (5, 32, "int8", "f32f32", False, "device")])  # the f32 parity model
def test_gpu_decode_qkv_kernel(cuda, B, ctx, wdt, stream, split, slot_kind):
    """The one q/k/v launch of a fused step against decode_qkv_plain: q_eff
    within the GEMV's tolerance (plus the query scale's rounding), k and v
    written at the slot within it, every other cache row untouched (bit
    equal); the slot read from device memory or given as a host int."""
    D = 1280 if stream != "f32f32" else 256
    g = torch.Generator(device=cuda).manual_seed(B + ctx)
    f32 = stream == "f32f32"
    dt = torch.float32 if f32 else torch.bfloat16
    x = (torch.randn(B, 1, D, generator=g, device=cuda) * 2 + 0.5).to(
        torch.bfloat16 if stream == "bf16" else torch.float32)
    ln = tk.GemvLN((1 + 0.1 * torch.randn(D, generator=g, device=cuda))
                   .to(dt), (0.1 * torch.randn(D, generator=g, device=cuda))
                   .to(dt), 1e-5)
    layers = []
    for i in range(3):
        if wdt == "int8":
            w = torch.randint(-127, 128, (D, D), generator=g, device=cuda,
                              dtype=torch.int8)
            s = (torch.rand(D, generator=g, device=cuda) + 0.1) * 1e-3
        else:
            w = (torch.randn(D, D, generator=g, device=cuda) * 0.03).to(dt)
            s = None
        b = None if i == 1 else (torch.randn(D, generator=g, device=cuda)
                                 * 0.1).to(dt)
        layers.append((w, s, b))
    kc = torch.randn(B, ctx, D, generator=g, device=cuda).to(dt)
    vc = torch.randn(B, ctx, D, generator=g, device=cuda).to(dt)
    pos = ctx - 3
    slot = torch.tensor(pos, dtype=torch.int32, device=cuda) \
        if slot_kind == "device" else pos
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    before = tk.LAUNCHES["decode_gemv"]
    q = tk.decode_qkv(x, ln, layers, dt, k1, v1, slot, 64 ** -0.5)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["decode_gemv"] == before + 1
    ref = tk.decode_qkv_plain(x, ln, layers, dt, k2, v2, slot, 64 ** -0.5)
    assert q.dtype == dt and q.shape == (B, 1, D)
    xr = tk.layer_norm_plain(x, ln).to(dt).float().reshape(B, D)
    e = 2.0 ** -7 if dt == torch.bfloat16 else 2.0 ** -23
    for (w, s, b), got, want, scale in (
            (layers[0], q[:, 0], ref[:, 0], 64 ** -0.5),
            (layers[1], k1[:, pos], k2[:, pos], 1.0),
            (layers[2], v1[:, pos], v2[:, pos], 1.0)):
        tol = gemv_tolerance(xr, w.float(), s, None if b is None
                             else b.float(), dt, False)
        tol = fused_tolerance(tol, xr, w.float(), s, want, dt, True, False,
                              None) * scale + e * want.float().abs()
        assert ((got.float() - want.float()).abs() <= tol).all()
    rest = torch.ones(ctx, dtype=torch.bool, device=cuda)
    rest[pos] = False
    assert torch.equal(k1[:, rest], kc[:, rest])
    assert torch.equal(v1[:, rest], vc[:, rest])


@pytest.mark.gpu
def test_gpu_pdl_chain_in_a_cuda_graph_equals_eager(cuda):
    """A chain of programmatically dependent launches as the fused step
    runs them (int8 decoder, 3 rows at large-v3 width): fc1 with the layer
    norm and GELU -> fc2 reading its output, with the residual add -> the
    cross-attention's query with the layer norm -> xattn_step reading it
    -> the out projection with the residual add. Captured in one CUDA
    graph and replayed over three residual streams written into the
    captured input, every output equals the eager chain's on the same
    stream bit for bit (the kernels are deterministic, so a read that
    overtook its producer would show), and the eager chain is within
    tolerance of the plain versions' at the end."""
    g = torch.Generator(device=cuda).manual_seed(77)
    bf, D, S = torch.bfloat16, 1280, 1500

    def w8(n, k):
        return torch.randint(-127, 128, (n, k), generator=g, device=cuda,
                             dtype=torch.int8)

    def vec(n, a=0.1):
        return (torch.randn(n, generator=g, device=cuda) * a).to(bf)

    def sc(n):
        return (torch.rand(n, generator=g, device=cuda) + 0.1) * 1e-3

    ln = tk.GemvLN((1 + vec(D)).to(bf), vec(D), 1e-5)
    w1, s1, b1 = w8(4 * D, D), sc(4 * D), vec(4 * D)
    w2, s2, b2 = w8(D, 4 * D), sc(D), vec(D)
    wq, sq, bq = w8(D, D), sc(D), vec(D)
    wo, so, bo = w8(D, D), sc(D), vec(D)
    k = torch.randn(3, S, D, generator=g, device=cuda).to(bf)
    v = torch.randn(3, S, D, generator=g, device=cuda).to(bf)
    x = torch.empty(3, 1, D, device=cuda)

    def chain():
        h = tk.decode_gemv(x, w1, bf, s1, b1, ln=ln, gelu=True)
        y = tk.decode_gemv(h, w2, bf, s2, b2, residual=x)
        q = tk.decode_gemv(y, wq, bf, sq, bq, ln=ln)
        o = tk.xattn_step(q, k, v, 64)
        z = tk.decode_gemv(o, wo, bf, so, bo, residual=y)
        return h, y, q, o, z

    streams = [torch.randn(3, 1, D, generator=g, device=cuda) * 2 + 0.5
               for _ in range(3)]
    eager = []
    for st in streams:
        x.copy_(st)
        eager.append([t.clone() for t in chain()])
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain()                                  # warm-up off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = tk.LAUNCHES["decode_gemv"]
    with torch.cuda.graph(graph):
        outs = chain()
    assert tk.LAUNCHES["decode_gemv"] == before + 4
    for st, want in zip(streams, eager):
        x.copy_(st)
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(outs, want):
            assert torch.equal(a, b)
    # the end of the eager chain against the plain versions' chain
    x.copy_(streams[-1])
    h = tk.decode_gemv_plain(x, w1, bf, s1, b1, ln=ln, gelu=True)
    y = tk.decode_gemv_plain(eager[-1][0], w2, bf, s2, b2, residual=x)
    q = tk.decode_gemv_plain(eager[-1][1], wq, bf, sq, bq, ln=ln)
    o = tk.xattn_step_plain(eager[-1][2], k, v, 64)
    z = tk.decode_gemv_plain(eager[-1][3], wo, bf, so, bo,
                             residual=eager[-1][1])
    for got, want, rel in zip(eager[-1], (h, y, q, o, z),
                              (0.05, 0.02, 0.05, 0.05, 0.02)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= rel * want.float().abs().max().item(), err


@pytest.mark.gpu
def test_gpu_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.randn(2, 512, 64, device=cuda).half()   # no f16 kernel
    with pytest.raises(ValueError):
        tk.encoder_mha(q, q, q)
    with pytest.raises(ValueError):                    # mixed dtypes
        tk.encoder_mha(q.float(), q.float(), q.bfloat16())
    kc = torch.randn(2, 16, 128, device=cuda).bfloat16()
    with pytest.raises(ValueError):                    # pos outside cache
        tk.attn_step(kc[:, :1], kc, kc, 16,
                     torch.zeros(2, dtype=torch.int32, device=cuda), 64)
    with pytest.raises(ValueError):                    # int64 pos tensor
        tk.attn_step(kc[:, :1], kc, kc, torch.tensor(3, device=cuda),
                     torch.zeros(2, dtype=torch.int32, device=cuda), 64)
    with pytest.raises(ValueError):                    # pos on the host
        tk.attn_step(kc[:, :1], kc, kc,
                     torch.tensor(3, dtype=torch.int32),
                     torch.zeros(2, dtype=torch.int32, device=cuda), 64)
    x = torch.randn(2, 16, 80, device=cuda)
    with pytest.raises(ValueError):                    # C % 128 != 0
        tk.depthwise_conv1d(x, torch.randn(3, 80, device=cuda), 3)
    x = torch.randn(2, 16, 128, device=cuda)
    with pytest.raises(ValueError):                    # bf16 taps
        tk.depthwise_conv1d(x, torch.randn(3, 128, device=cuda).bfloat16(),
                            3)
    with pytest.raises(ValueError):                    # k > 33
        tk.depthwise_conv1d(x, torch.randn(34, 128, device=cuda), 34)
    wta = torch.rand(1, 3, 8, 9, device=cuda)            # K > 8
    with pytest.raises(ValueError):
        tk.masked_scm(wta, torch.randn(1, 3, 8, 7, dtype=torch.complex64,
                                       device=cuda))
    with pytest.raises(ValueError):                    # complex128 stft
        tk.masked_scm(wta[..., :4], torch.randn(1, 3, 8, 7,
                                                dtype=torch.complex128,
                                                device=cuda))
    q = torch.randn(2, 9, 128, device=cuda).bfloat16()   # T > 8
    k8 = torch.zeros(2, 64, 128, dtype=torch.int8, device=cuda)
    vs = torch.ones(2, 128, device=cuda)
    with pytest.raises(ValueError):
        tk.xattn_int8(q, k8, k8, vs, 64, 64)
    with pytest.raises(ValueError):                    # S_pad % 32 != 0
        tk.xattn_int8(q[:, :1], k8[:, :60], k8[:, :60], vs, 64, 60)
    k8 = torch.zeros(2, 64, 24, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):                    # D % 16 != 0
        tk.xattn_stream(k8, k8)
    k8 = torch.zeros(2, 64, 128, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):                    # T > 1
        tk.xattn_onedot(q[:, :2], k8, k8, vs, 64, 64)
    with pytest.raises(ValueError):                    # f32 q
        tk.xattn_onedot(q[:, :1].float(), k8, k8, vs, 64, 64)
    q9 = torch.randn(2, 9, 128, device=cuda).bfloat16()
    kc = torch.zeros(2, 16, 128, device=cuda).bfloat16()
    kl = torch.zeros(1, 8192, 128, device=cuda).bfloat16()  # 8 shares of
    with pytest.raises(ValueError, match="227 KB"):         # 1024 rows:
        tk.attn_step_split_bias(q9[:1, :1], kl[:, :0], kl[:, :0], kl, kl,
                                torch.zeros(1, 1, 8192, device=cuda), 64)
    with pytest.raises(ValueError):                    # bf16 bias
        tk.attn_step_split_bias(q9[:, :5], kc, kc, kc, kc,
                                torch.zeros(2, 5, 32, device=cuda).bfloat16(),
                                64)
    q40 = torch.zeros(40, 1, 128, device=cuda).bfloat16()  # 40 beams at
    kp = torch.zeros(1, 0, 128, device=cuda).bfloat16()    # G 448: past
    kg = torch.zeros(40, 448, 128, device=cuda).bfloat16()  # 227 KB
    pads = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="227 KB"):
        tk.attn_step_split(q40, kp, kp, kg, kg, 0, pads, 64, 40)
    with pytest.raises(ValueError):                    # int64 gslot tensor
        tk.attn_step_split(q40[:5], kp, kp, kg[:5], kg[:5],
                           torch.tensor(0, device=cuda), pads, 64, 5)
    qx = torch.randn(3, 9, 1280, device=cuda).bfloat16()   # Tq > 8
    kx = torch.randn(3, 64, 1280, device=cuda).bfloat16()
    with pytest.raises(ValueError):
        tk.xattn_step(qx, kx, kx, 64)
    with pytest.raises(ValueError):                    # mixed dtypes
        tk.xattn_step(qx[:, :5], kx, kx.float(), 64)
    with pytest.raises(ValueError):                    # f16
        tk.xattn_step(qx[:, :5].half(), kx.half(), kx.half(), 64)
    w8 = torch.zeros(1280, 1280, dtype=torch.int8, device=cuda)
    sc = torch.ones(1280, device=cuda)
    x1 = qx[:, 0].contiguous()
    assert tk.decode_gemv(x1, w8, torch.bfloat16, sc).shape == (3, 1280)
    with pytest.raises(ValueError):                    # 65 rows
        tk.decode_gemv(torch.zeros(65, 1280, device=cuda), w8,
                       torch.bfloat16, sc)
    with pytest.raises(ValueError):                    # f32 weights
        tk.decode_gemv(x1, w8.float(), torch.bfloat16, sc)
    with pytest.raises(ValueError):                    # K % 64 != 0
        tk.decode_gemv(x1[:, :1248].contiguous(), w8[:, :1248].contiguous(),
                       torch.bfloat16, sc)
    with pytest.raises(ValueError):                    # a bias on logits
        tk.decode_gemv(x1, w8, torch.bfloat16, sc, sc, logits=True)
    with pytest.raises(ValueError):                    # f64 scale
        tk.decode_gemv(x1, w8, torch.bfloat16, sc.double())
