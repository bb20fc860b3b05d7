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


@pytest.mark.parametrize("S,dk,seed", [(621, 64, 7), (512, 64, 8)])
def test_encoder_mha_plain_matches_pallas(S, dk, seed):
    """621 pads to 1024 inside the Pallas wrapper (masked key padding);
    512 is block-aligned. bf16 inputs, bf16 output on both sides:
    tolerance one bf16 ulp of the output scale (2**-8 relative)."""
    rng = np.random.RandomState(seed)
    BH = 4
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


@pytest.mark.parametrize("dk,H,ctx,pos,pads", [
    (64, 4, 64, 37, [0, 5, 12]),
    (128, 2, 32, 10, [3, 0, 0]),
])
def test_attn_step_plain_matches_pallas(dk, H, ctx, pos, pads):
    """f32 caches with per-row left pads; tolerance 1e-5 (f32 sums in
    another order)."""
    rng = np.random.RandomState(dk + pos)
    B, D = len(pads), H * dk
    pads = np.asarray(pads, np.int32)
    q = rng.randn(B, 1, D).astype(np.float32) * 0.3 * dk ** -0.5
    kc = rng.randn(B, ctx, D).astype(np.float32) * 0.3
    vc = rng.randn(B, ctx, D).astype(np.float32) * 0.3
    want = np.asarray(pk.attn_step(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(pos, jnp.int32), jnp.asarray(pads), dk, interpret=True))
    got = tk.attn_step(t(q), t(kc), t(vc), pos, t(pads), dk)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_anc", [False, True])
def test_attn_step_split_plain_matches_pallas(with_anc):
    """Split prompt/generated cache with per-stream pads, with and without
    the beam ancestry matrix; tolerance 1e-5 (f32)."""
    rng = np.random.RandomState(11 + with_anc)
    B, K, Pp, G, H, dk = 2, 3, 16, 32, 4, 64
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


@pytest.mark.parametrize("C,k", [(128, 7), (80, 3), (128, 1)])
def test_titanet_depthwise_module_matches_jax(C, k):
    """The port's DepthwiseConv against the JAX module with the same taps,
    f32: C=128, k=7 takes the kernel wrapper (its plain version here),
    C=80 and k=1 the grouped conv, as in the JAX module. Tolerance 1e-5."""
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


def test_cpu_tensors_take_the_plain_path_and_count_nothing():
    tk.reset_launches()
    q = torch.randn(2, 512, 64).bfloat16()
    out = tk.encoder_mha(q, q, q)
    torch.testing.assert_close(out, tk.encoder_mha_plain(q, q, q))
    wta, x = torch.rand(1, 3, 8, 4), torch.randn(1, 3, 8, 7,
                                                 dtype=torch.complex64)
    torch.testing.assert_close(tk.masked_scm(wta, x),
                               tk.masked_scm_plain(wta, x))
    assert all(n == 0 for n in tk.LAUNCHES.values())


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA-only)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("S,dk,dtype,tol", [
    (621, 64, torch.bfloat16, 1e-2),   # one bf16 ulp at |out| <= 2
    (1500, 64, torch.bfloat16, 1e-2),
    (1500, 128, torch.bfloat16, 1e-2),
    (621, 64, torch.float32, 1e-5),    # f32 sums in another order
    (1500, 128, torch.float32, 1e-5),
])
def test_gpu_encoder_mha_kernel(cuda, S, dk, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn(6, S, dk, generator=g, device=cuda)
               .mul(0.35).to(dtype) for _ in range(3))
    before = tk.LAUNCHES["encoder_mha"]
    out = tk.encoder_mha(q, k, v)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["encoder_mha"] == before + 1
    assert out.dtype == dtype
    err = (out.float() - tk.encoder_mha_plain(q, k, v).float()).abs().max()
    assert err.item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-3)])
def test_gpu_attn_step_kernel(cuda, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(3)
    B, ctx, D, dk, pos = 5, 96, 1280, 64, 70
    q = torch.randn(B, 1, D, generator=g, device=cuda).mul(0.125).to(dtype)
    kc, vc = (torch.randn(B, ctx, D, generator=g, device=cuda).to(dtype)
              for _ in range(2))
    pads = torch.tensor([0, 3, 9, 40, 70], dtype=torch.int32, device=cuda)
    out = tk.attn_step(q, kc, vc, pos, pads, dk)
    ref = tk.attn_step_plain(q, kc, vc, pos, pads, dk)
    assert (out - ref).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-3)])
def test_gpu_attn_step_split_kernel(cuda, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(4)
    B, K, Pp, G, D, dk, gslot = 3, 5, 32, 64, 1280, 64, 20
    q = torch.randn(B * K, 1, D, generator=g, device=cuda).mul(0.125) \
        .to(dtype)
    kp, vp = (torch.randn(B, Pp, D, generator=g, device=cuda).to(dtype)
              for _ in range(2))
    kg, vg = (torch.randn(B * K, G, D, generator=g, device=cuda).to(dtype)
              for _ in range(2))
    pads = torch.tensor([0, 7, 31], dtype=torch.int32, device=cuda)
    anc = torch.randint(0, K, (B, K, G), generator=g, device=cuda,
                        dtype=torch.int32)
    anc[:, :, gslot] = torch.arange(K, dtype=torch.int32, device=cuda)
    for a in (None, anc):
        out = tk.attn_step_split(q, kp, vp, kg, vg, gslot, pads, dk, K, a)
        ref = tk.attn_step_split_plain(q, kp, vp, kg, vg, gslot, pads, dk,
                                       K, a)
        assert (out - ref).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,C,k", [(40, 128, 3), (320, 1024, 15),
                                   (97, 256, 7), (64, 128, 11),
                                   (1, 128, 16), (200, 384, 2)])
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
                                       (2, 6, 70, 8, 8)])
def test_gpu_masked_scm_kernel(cuda, B, F, T, K, M):
    """The CUDA kernel against its plain version (complex einsum), ragged
    frame tiles, odd F and the M = 8 second lane entry included. Both sum
    T products in f32 in other orders: within 2T f32 roundings of
    sum_t w |x_m| |x_n| (largest entry). Hermitian with a real diagonal;
    an all-zero window gives exactly 1e-15 * I."""
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
    x = torch.randn(2, 16, 80, device=cuda)
    with pytest.raises(ValueError):                    # C % 128 != 0
        tk.depthwise_conv1d(x, torch.randn(3, 80, device=cuda), 3)
    x = torch.randn(2, 16, 128, device=cuda)
    with pytest.raises(ValueError):                    # bf16 taps
        tk.depthwise_conv1d(x, torch.randn(3, 128, device=cuda).bfloat16(),
                            3)
    with pytest.raises(ValueError):                    # k > 16
        tk.depthwise_conv1d(x, torch.randn(17, 128, device=cuda), 17)
    wta = torch.rand(1, 3, 8, 9, device=cuda)            # K > 8
    with pytest.raises(ValueError):
        tk.masked_scm(wta, torch.randn(1, 3, 8, 7, dtype=torch.complex64,
                                       device=cuda))
    with pytest.raises(ValueError):                    # complex128 stft
        tk.masked_scm(wta[..., :4], torch.randn(1, 3, 8, 7,
                                                dtype=torch.complex128,
                                                device=cuda))
