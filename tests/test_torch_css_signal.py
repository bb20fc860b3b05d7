"""The port's CSS signal core against the JAX package: STFT/iSTFT, IPD and
angle features, the feature extractor, PIT and binary morphology.

Inputs are made from seeded numpy and handed to both packages. Features
downstream of an STFT are compared on the same complex STFT (raw IPD v1
is an arctan2 whose value flips by 2*pi under an f32-level difference
near its branch cut).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from notsofar_tpu.ops import features as jf
from notsofar_tpu.ops import pit as jpit
from notsofar_tpu.ops import stft as jstft
from notsofar_tpu.utils import morphology as jmorph
from notsofar_tpu_torch.ops import features as tf
from notsofar_tpu_torch.ops import pit as tpit
from notsofar_tpu_torch.ops import stft as tstft
from notsofar_tpu_torch.utils import morphology as tmorph


def t(x):
    return torch.from_numpy(np.array(x))


def rel_err(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


@pytest.mark.parametrize("window", ["hann", "sqrt_hann"])
@pytest.mark.parametrize("frame_len,hop", [(512, 256), (400, 160)])
def test_stft_and_istft_match_jax(window, frame_len, hop):
    """Analysis matrices equal; forward and inverse within 1e-5 relative
    (f32 matmuls summed in another order); 400/160 takes the general
    framing and overlap-add paths."""
    rng = np.random.RandomState(frame_len + len(window))
    x = (rng.randn(2, 3, 8000) * 0.1).astype(np.float32)
    js = jstft.STFT(frame_len, hop, window)
    ts = tstft.STFT(frame_len, hop, window)
    np.testing.assert_array_equal(ts.Kr.numpy(), js.Kr)
    np.testing.assert_array_equal(ts.Ki.numpy(), js.Ki)
    want = np.asarray(js.forward(jnp.asarray(x)))
    got = ts.forward(t(x))
    assert got.dtype == torch.complex64 and got.shape == want.shape
    assert rel_err(got.numpy(), want) < 1e-5
    back_want = np.asarray(js.inverse(jnp.asarray(want)))
    back = ts.inverse(t(want)).numpy()
    assert back.shape == back_want.shape
    assert rel_err(back, back_want) < 1e-5
    assert tstft.num_frames(8000, frame_len, hop) == \
        jstft.num_frames(8000, frame_len, hop) == want.shape[-1]


@pytest.mark.parametrize("window", ["hann", "sqrt_hann"])
def test_stft_mag_phase_matches_jax(window):
    """STFT.mag_phase: magnitude within 1e-5 of its scale; phase within
    1e-4 rad where the magnitude is above 1e-3 of its scale (the angle of
    a near-zero bin is noise on both sides)."""
    rng = np.random.RandomState(len(window))
    x = (rng.randn(2, 8000) * 0.1).astype(np.float32)
    jmag, jph = jstft.STFT(512, 256, window).mag_phase(jnp.asarray(x))
    mag, ph = tstft.STFT(512, 256, window).mag_phase(t(x))
    jmag, jph = np.asarray(jmag), np.asarray(jph)
    assert mag.shape == ph.shape == jmag.shape
    assert mag.dtype == ph.dtype == torch.float32
    assert rel_err(mag.numpy(), jmag) < 1e-5
    big = jmag > 1e-3 * jmag.max()
    dph = np.angle(np.exp(1j * (ph.numpy() - jph)))
    assert big.mean() > 0.9 and np.abs(dph[big]).max() < 1e-4


def _phase(rng, B=2, C=7, F=257, T=60):
    c = rng.randn(B, C, F, T) + 1j * rng.randn(B, C, F, T)
    return np.angle(c).astype(np.float32)


@pytest.mark.parametrize("version", [1, 2, 3])
@pytest.mark.parametrize("cos,sin", [(False, False), (True, True)])
def test_ipd_features_match_jax(version, cos, sin):
    """Same phase in, 2e-5 absolute out (transcendentals in f32; atan2
    outputs near +-pi compared modulo 2*pi)."""
    rng = np.random.RandomState(version + 2 * cos)
    pha = _phase(rng)
    jc = jf.IPDConfig(cos=cos, sin=sin, mean_normalize_version=version)
    tc = tf.IPDConfig(cos=cos, sin=sin, mean_normalize_version=version)
    want = np.asarray(jf.ipd_features(jnp.asarray(pha), jc))
    got = tf.ipd_features(t(pha), tc).numpy()
    assert got.shape == want.shape == (2, 6 * 257 * (2 if cos and sin else 1),
                                       60)
    d = np.abs(got - want)
    d = np.minimum(d, np.abs(d - 2 * np.pi))
    assert d.max() < 2e-5


@pytest.mark.parametrize("num_doas", [1, 4])
def test_angle_features_match_jax(num_doas):
    rng = np.random.RandomState(num_doas)
    pha = _phase(rng, B=3, T=20)
    cfg_j = jf.AngleConfig(num_doas=num_doas)
    cfg_t = tf.AngleConfig(num_doas=num_doas)
    if num_doas == 1:
        doas = [rng.uniform(0, 2 * np.pi, 3).astype(np.float32)
                for _ in range(2)]
        want = jf.angle_features(jnp.asarray(pha),
                                 [jnp.asarray(d) for d in doas], cfg_j)
        got = tf.angle_features(t(pha), [t(d) for d in doas], cfg_t)
    else:
        doa = np.zeros(3, np.float32)
        want = jf.angle_features(jnp.asarray(pha), jnp.asarray(doa), cfg_j)
        got = tf.angle_features(t(pha), t(doa), cfg_t)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    phi_j = np.asarray(jf.princeton_phase_delay(jnp.asarray([0.3, 1.2]),
                                                cfg_j))
    phi_t = tf.princeton_phase_delay(torch.tensor([0.3, 1.2]), cfg_t)
    np.testing.assert_allclose(phi_t.numpy(), phi_j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mc", [True, False])
def test_feature_extractor_matches_jax(mc):
    """The shipped extractor (hann, raw IPD v1, mvn with the unbiased
    std): 1799-d MC and 257-d SC features from the same STFT magnitude and
    phase, within 2e-5 absolute (2*pi-wrapped)."""
    cfg_j = jf.ExtractorConfig() if mc else jf.ExtractorConfig(ipd_index="")
    cfg_t = tf.ExtractorConfig() if mc else tf.ExtractorConfig(ipd_index="")
    je, te = jf.FeatureExtractor(cfg_j), tf.FeatureExtractor(cfg_t)
    assert te.feature_dim == je.feature_dim == (1799 if mc else 257)
    rng = np.random.RandomState(4 + mc)
    shape = (2, 7, 257, 50) if mc else (2, 257, 50)
    c = (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)
    mag, pha = np.abs(c), np.angle(c).astype(np.float32)
    jm, jp, want = je(jnp.asarray(mag), jnp.asarray(pha))
    tm, tp, got = te(t(mag), t(pha))
    want = np.asarray(want)
    assert got.shape == want.shape == (2, te.feature_dim, 50)
    d = np.abs(got.numpy() - want)
    d = np.minimum(d, np.abs(d - 2 * np.pi))
    assert d.max() < 2e-5
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    # the synthesis STFT is the normalized sqrt_hann whatever the analysis
    np.testing.assert_array_equal(te.istft_op.Kr.numpy(), je.istft_op.Kr)


@pytest.mark.parametrize("base", ["mse", "l1"])
def test_pit_loss_matches_jax(base):
    rng = np.random.RandomState(3)
    preds = rng.rand(5, 40, 3).astype(np.float32)
    perm = np.stack([rng.permutation(3) for _ in range(5)])
    targets = np.take_along_axis(preds, perm[:, None, :], -1) + \
        0.05 * rng.rand(5, 40, 3).astype(np.float32)
    jl, jp = jpit.pit_loss(jnp.asarray(preds), jnp.asarray(targets), base)
    tl, tp = tpit.pit_loss(t(preds), t(targets), base)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6)
    aligned = tpit.permute_sources(t(targets), tp)
    np.testing.assert_array_equal(
        aligned.numpy(),
        np.asarray(jpit.permute_sources(jnp.asarray(targets), jp)))
    lm = tpit.pairwise_loss_matrix(t(preds), t(targets),
                                   tpit.BASE_LOSSES[base])
    np.testing.assert_allclose(
        lm.numpy(), np.asarray(jpit.pairwise_loss_matrix(
            jnp.asarray(preds), jnp.asarray(targets),
            jpit.BASE_LOSSES[base])), rtol=1e-6)


@pytest.mark.parametrize("iters", [0, 1, 3, 12])
def test_morphology_matches_numpy_and_jax(iters):
    """Edges included: outside the signal dilation sees False and erosion
    True, as the JAX package's reduce_window padding does."""
    rng = np.random.RandomState(iters)
    x = rng.rand(2, 3, 50) > 0.6
    x[0, 0, :2] = True
    x[1, 2, -3:] = True
    for tfn, jfn, nfn in ((tmorph.dilate, jmorph.dilate_jax,
                           tmorph.dilate_np),
                          (tmorph.erode, jmorph.erode_jax, tmorph.erode_np)):
        got = tfn(t(x), iters, axis=2).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            jfn(jnp.asarray(x), iters, axis=2)))
        for b in range(2):
            for s in range(3):
                np.testing.assert_array_equal(got[b, s], nfn(x[b, s], iters))
    np.testing.assert_array_equal(tmorph.erode_np(x[0, 0], 2),
                                  jmorph.erode_np(x[0, 0], 2))
    np.testing.assert_array_equal(tmorph.dilate_np(x[0, 0], 2),
                                  jmorph.dilate_np(x[0, 0], 2))
