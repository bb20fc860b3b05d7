"""notsofar_tpu_torch's TitaNet (features, modules, encoder, converter,
windowed embedding) against the JAX package, on the CPU.

Small dims (filters 128, epilogue 256, attention 16, embedding 32,
kernels 7 and 11, two repeats): C = 128 takes the depthwise kernel's
dispatch branch in both packages (the port's wrapper runs its plain
version on CPU tensors). Weights come from one source for both packages
(a synthetic NeMo state dict through each converter, or the JAX init
with randomized batch-norm statistics through variables_from_jax);
inputs are numpy arrays made from a seed.
"""
import io
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from notsofar_tpu.diarization import word_based as jwb
from notsofar_tpu.models import titanet as jt
from notsofar_tpu.models import titanet_convert as jc
from notsofar_tpu_torch.diarization import word_based as twb
from notsofar_tpu_torch.models import titanet as tt
from notsofar_tpu_torch.models import titanet_convert as tc
from notsofar_tpu_torch.ops import kernels as tk
from tests.test_titanet_convert import synth_nemo_state_dict
from tests.test_torch_whisper import torch_threads  # noqa: F401

SMALL = dict(filters=128, epilogue_filters=256, attention_dim=16,
             emb_dim=32, block_kernels=(7, 11), block_repeat=2)
JCFG = jt.TitaNetConfig(**SMALL)
TCFG = tt.TitaNetConfig(**SMALL)
SR = 16000


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def randomized(variables, seed):
    """The flax tree with every leaf redrawn (kernels at their init scale,
    BN scale/bias/mean/var and dense biases away from identity) so that
    orientation or statistics errors cannot hide behind identity values."""
    rng = np.random.RandomState(seed)

    def draw(path, x):
        name = path[-1].key
        x = np.asarray(x, np.float32)
        if name == "kernel":
            return (rng.randn(*x.shape) * x.std()).astype(np.float32)
        if name in ("scale", "var"):
            return (0.5 + rng.rand(*x.shape)).astype(np.float32)
        return (rng.randn(*x.shape) * 0.1).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, variables)


@pytest.fixture(scope="module")
def nemo_pair():
    """(NeMo state dict, JAX f32 encoder, port f32 encoder) from one
    synthetic NeMo-layout checkpoint."""
    sd = synth_nemo_state_dict(np.random.RandomState(0), JCFG)
    jenc = jt.SpeakerEncoder(JCFG, variables=jax.tree_util.tree_map(
        jnp.asarray, jc.convert_nemo_titanet(sd, JCFG)))
    tenc = tt.SpeakerEncoder(TCFG, tc.convert_nemo_titanet(sd, TCFG),
                             device="cpu")
    return sd, jenc, tenc


def windows(seed, B=3, L=9000):
    rng = np.random.RandomState(seed)
    wavs = (rng.randn(B, L) * 0.1).astype(np.float32)
    lengths = np.asarray([L, L * 5 // 9, L * 7 // 9][:B], np.int32)
    for i, n in enumerate(lengths):
        wavs[i, n:] = 0.0
    return wavs, lengths


@pytest.mark.parametrize("with_lengths", [True, False])
def test_titanet_features_match_jax(with_lengths):
    """Normalized log-mel, f32, with per-row valid lengths (statistics
    over valid frames, padded frames zeroed) and without; frame count
    padded to 16 in both. Tolerance 2e-4 absolute on unit-variance
    features (f32 DFT sums in another order, amplified by the log in
    low-energy bins)."""
    wavs, lengths = windows(1)
    want = np.asarray(jt.titanet_features(
        jnp.asarray(wavs),
        lengths=jnp.asarray(lengths) if with_lengths else None))
    got = tt.titanet_features(
        t(wavs), lengths=t(lengths).long() if with_lengths else None)
    assert got.shape == want.shape and got.shape[-1] % 16 == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)


def test_titanet_embeddings_match_jax_f32(nemo_pair):
    """Same NeMo checkpoint through both converters, same windows: f32
    embeddings within 1e-4 relative (tools/torch_titanet_oracle.py's
    tolerance)."""
    _, jenc, tenc = nemo_pair
    wavs, lengths = windows(2)
    want = jenc.embed(wavs, lengths)
    got = tenc.embed(wavs, lengths)
    assert got.shape == (3, JCFG.emb_dim) and got.dtype == np.float32
    assert rel(got, want) < 1e-4


def test_variables_from_jax_maps_every_leaf():
    """The JAX module's init tree (shapes from jax.eval_shape) maps onto
    the port's TitaNet state_dict key for key and shape, BN statistics
    included. The values through variables_from_jax are held by the
    converter and embedding tests, whose JAX trees come from the JAX
    converter."""
    shapes = jax.eval_shape(
        jt.TitaNet(JCFG).init, jax.random.PRNGKey(0),
        jnp.zeros((1, JCFG.n_mels, 50)), jnp.asarray([50]))
    sd = tt.variables_from_jax(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    want = tt.TitaNet(TCFG).state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert v.shape == want[k].shape, k


def test_converter_matches_the_jax_converter(nemo_pair, tmp_path):
    """Both converters read a NeMo state dict into the same weights: the
    port's state_dict equals variables_from_jax of the JAX converter's
    tree exactly; config detection agrees; a torch state-dict file and a
    .nemo archive load through from_checkpoint; garbage raises."""
    sd, _, tenc = nemo_pair
    mine = tc.convert_nemo_titanet(sd, TCFG)
    theirs = tt.variables_from_jax(jc.convert_nemo_titanet(sd, JCFG))
    assert set(mine) == set(theirs)
    for k in mine:
        assert torch.equal(mine[k], theirs[k]), k
    no_se = {k: v for k, v in sd.items()
             if not (k.startswith("encoder.encoder.0.") and ".fc." in k)}
    for s in (sd, no_se):
        a = tc.detect_titanet_config(s, TCFG)
        b = jc.detect_titanet_config(s, JCFG)
        assert (a.prologue_se, a.epilogue_se) == (b.prologue_se,
                                                  b.epilogue_se)
    assert tc.detect_titanet_config(no_se, TCFG).prologue_se is False

    wavs, lengths = windows(3)
    want = tenc.embed(wavs, lengths)
    pt = tmp_path / "titanet.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pt)
    ckpt = io.BytesIO()
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    nemo = tmp_path / "titanet.nemo"
    with tarfile.open(nemo, "w") as tar:
        for name, data in (("./model_weights.ckpt", ckpt.getvalue()),
                           ("./model_config.yaml", b"sample_rate: 16000\n")):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    for path in (pt, nemo):
        enc = tt.SpeakerEncoder.from_checkpoint(path, TCFG, device="cpu")
        np.testing.assert_array_equal(enc.embed(wavs, lengths), want)
    with pytest.raises(ValueError):
        tc.convert_nemo_titanet({"foo.bar": np.zeros(3)})


def test_titanet_embeddings_bf16_match_jax(nemo_pair):
    """compute_dtype bf16 in both packages. They round at the same points
    (convs and dense layers in bf16, batch norms promoted to f32, pooling
    statistics in f32) except one: on the CPU the JAX module's depthwise
    convs take the lax branch, which rounds the taps to bf16, while the
    port keeps f32 taps, as the Pallas branch does. Measured 5.9e-3
    relative at these inputs (each package is ~4.5e-3 from the f32
    embeddings); tolerance 2e-2 relative."""
    sd, jenc32, _ = nemo_pair
    jenc = jt.SpeakerEncoder(JCFG, variables=jenc32.variables,
                             compute_dtype=jnp.bfloat16)
    tenc = tt.SpeakerEncoder(TCFG, tc.convert_nemo_titanet(sd, TCFG),
                             compute_dtype=torch.bfloat16, device="cpu")
    wavs, lengths = windows(2)
    got, want = tenc.embed(wavs, lengths), jenc.embed(wavs, lengths)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert rel(got, want) < 2e-2
    assert rel(got, jenc32.embed(wavs, lengths)) < 2e-2


# ---------------------------------------------------------------------------
# module by module at bf16: the port rounds where flax rounds
# ---------------------------------------------------------------------------

def _pair(jmod, tmod, init_args, seed):
    variables = randomized(jmod.init(jax.random.PRNGKey(seed), *init_args),
                           seed)
    tmod.load_state_dict(tt.variables_from_jax(
        {"params": variables["params"],
         "batch_stats": variables.get("batch_stats", {})}))
    return variables


def _inputs(seed, B=2, T=24, C=64):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, C).astype(np.float32)
    mask = np.ones((B, T, 1), np.float32)
    mask[1, T * 2 // 3:] = 0.0
    return x, mask


def _check(jout, tout, tol):
    """Output dtype as flax returns it; values within `tol` relative."""
    assert str(jnp.asarray(jout).dtype) == str(tout.dtype).split(".")[1]
    assert rel(tout.detach().float().numpy(),
               np.asarray(jout, np.float32)) < tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_titanet_modules_round_like_flax(dtype):
    """SeparableConv (C=64: the grouped-conv branch in both), the block
    pieces, SqueezeExcite, TitaNetBlock and AttentiveStatsPooling, each
    against its flax module on the same inputs and weights. Output dtypes
    must equal flax's (batch norms promote bf16 to f32, pooling returns
    f32). f32: 1e-5 relative. bf16: 1.6e-2 relative — both sides round
    the same f32 values to bf16 after sums in another order, which moves
    a value by at most one bf16 ulp (2**-8 relative) per rounding point
    it passes through (measured: SeparableConv 0, SqueezeExcite 5.7e-3,
    TitaNetBlock 3.0e-3, pooling 8e-8)."""
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 1.6e-2
    x, mask = _inputs(7)
    jx, jm, tx, tm = jnp.asarray(x), jnp.asarray(mask), t(x), t(mask)

    jmod = jt.SeparableConv(96, 5, jd)
    tmod = tt.SeparableConv(64, 96, 5, td)
    v = _pair(jmod, tmod, (jx,), 1)
    _check(jmod.apply(v, jx), tmod(tx), tol)

    jmod = jt.SqueezeExcite(8, jd)
    tmod = tt.SqueezeExcite(64, 8, td)
    v = _pair(jmod, tmod, (jx, jm), 2)
    _check(jmod.apply(v, jx, jm), tmod(tx, tm), tol)

    jmod = jt.TitaNetBlock(jt.TitaNetConfig(se_reduction=8), 7, 2, True,
                           filters=64, dtype=jd)
    tmod = tt.TitaNetBlock(tt.TitaNetConfig(se_reduction=8), 64, 7, 2, True,
                           64, True, td)
    v = _pair(jmod, tmod, (jx, jm), 3)
    _check(jmod.apply(v, jx, jm), tmod(tx, tm), tol)

    jmod = jt.AttentiveStatsPooling(16, jd)
    tmod = tt.AttentiveStatsPooling(64, 16, td)
    v = _pair(jmod, tmod, (jx, jm), 4)
    _check(jmod.apply(v, jx, jm), tmod(tx, tm), tol)


def test_random_weights_are_seeded_and_finite():
    """No checkpoint: weights drawn on the CPU from a seeded
    torch.Generator, so two encoders with one seed are equal and another
    seed differs; embeddings are finite."""
    a = tt.SpeakerEncoder(TCFG, device="cpu", seed=0)
    b = tt.SpeakerEncoder(TCFG, device="cpu", seed=0)
    c = tt.SpeakerEncoder(TCFG, device="cpu", seed=1)
    sa, sb, sc = (e.module.state_dict() for e in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["prologue.conv_0.pw.weight"],
                           sc["prologue.conv_0.pw.weight"])
    wavs, lengths = windows(6)
    assert np.isfinite(a.embed(wavs, lengths)).all()


# ---------------------------------------------------------------------------
# windowed embedding (the diarization path's entry points)
# ---------------------------------------------------------------------------

def _word_windows():
    rng = np.random.RandomState(3)
    wavs = rng.randn(2, SR * 6).astype(np.float32) * 0.1
    words = [["w", 0.2 + i * 0.5, 0.45 + i * 0.5, i % 2] for i in range(10)]
    wins = [[(max(0.0, w[1] - s / 2), min(6.0, w[2] + s / 2))
             for s in (1.0, 0.5)] for w in words]
    return wavs, words, wins


def test_extract_embeddings_gather_equals_host_assembly_and_jax(nemo_pair):
    """extract_embeddings_bucketed: the on-device gather branch equals the
    host-assembly branch that encoders without embed_windows take, and
    both equal the JAX package's output on the same weights and windows
    (f32, 1e-4 relative). batch_size 8 pads the buckets' 10 windows to
    16 rows, so padding rows run and are dropped."""
    _, jenc, tenc = nemo_pair
    wavs, words, wins = _word_windows()
    tk.reset_launches()
    e_dev = twb.extract_embeddings_bucketed(tenc, wavs, SR, words, wins,
                                            batch_size=8)
    assert isinstance(e_dev, torch.Tensor) and e_dev.shape == (10, 2, 32)

    class HostOnly:          # no embed_windows -> host assembly
        cfg = tenc.cfg
        embed = tenc.embed

    e_host = twb.extract_embeddings_bucketed(HostOnly(), wavs, SR, words,
                                             wins, batch_size=8)
    assert isinstance(e_host, np.ndarray)
    want = np.asarray(jwb.extract_embeddings_bucketed(jenc, wavs, SR, words,
                                                      wins, batch_size=8))
    np.testing.assert_allclose(e_dev.numpy(), e_host, rtol=1e-5, atol=1e-5)
    assert rel(e_dev.numpy(), want) < 1e-4
    assert tk.LAUNCHES["depthwise_conv1d"] == 0      # CPU: plain version


def test_window_gather_clamps_starts_row_locally(nemo_pair):
    """A start past W - blen is clamped to W - blen inside its own stream
    row (never reading into the next stream), as the JAX gather does; the
    embeddings equal the JAX package's on-device gather (f32, 1e-4
    relative)."""
    _, jenc, tenc = nemo_pair
    rng = np.random.RandomState(9)
    blen = 8192
    sess = (rng.randn(2, 3 * blen) * 0.1).astype(np.float32)
    W = sess.shape[1]
    chans = np.asarray([0, 0, 1, 1], np.int32)
    starts = np.asarray([0, W - 100, 5000, W - blen + 7], np.int32)
    lengths = np.asarray([blen, 4000, 8000, blen], np.int32)
    want = np.asarray(jenc.embed_windows(jnp.asarray(sess), chans, starts,
                                         blen, lengths, inner_bs=4))
    got = tenc._embed_body(t(sess), t(chans).long(), t(starts).long(),
                           blen, t(lengths).long())
    assert rel(got.numpy(), want) < 1e-4
    # the clamped rows equal windows cut at W - blen of their own row
    cut = sess[[0, 1], W - blen:].copy()
    cut[0, 4000:] = 0.0
    same = tenc.embed(cut, np.asarray([4000, blen]))
    np.testing.assert_allclose(got.numpy()[[1, 3]], same, rtol=1e-5,
                               atol=1e-6)
