"""The port's MVDR against the JAX package and the float64 oracle of
tests/test_mvdr.py (the published contract: WTA combine, masked SCM with
1e-15*I, W = solve(noise+others, target)/trace with eps at f=0, column 0,
conjugated weights)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from notsofar_tpu.ops import mvdr as jm
from notsofar_tpu_torch.ops import kernels as tk
from notsofar_tpu_torch.ops import mvdr as tm
from tests.test_mvdr import _rand_case, np_mvdr_oracle


def t(x):
    return torch.from_numpy(np.array(x))


def test_make_wta_matches_jax():
    rng = np.random.RandomState(0)
    spk = rng.rand(2, 5, 30, 3).astype(np.float32)
    noi = rng.rand(2, 5, 30, 2).astype(np.float32) * 0.5
    spk[0, 0, 0] = [0.7, 0.7, 0.1]                  # a tie keeps both
    want = np.asarray(jm.make_wta(jnp.asarray(spk), jnp.asarray(noi)))
    np.testing.assert_array_equal(tm.make_wta(t(spk), t(noi)).numpy(), want)
    np.testing.assert_array_equal(want[0, 0, 0, :2], spk[0, 0, 0, :2])


def test_gauss_jordan_and_solve_complex_match_jax():
    """Hermitian positive-definite systems as in MVDR; the solutions
    satisfy A X = B to 1e-3 and equal the JAX package's to 1e-5 relative
    (the same unpivoted elimination)."""
    rng = np.random.RandomState(3)
    A = rng.randn(5, 7, 7) + 1j * rng.randn(5, 7, 7)
    A = (A @ A.conj().transpose(0, 2, 1) + 7 * np.eye(7)).astype(np.complex64)
    B = (rng.randn(5, 7, 7) + 1j * rng.randn(5, 7, 7)).astype(np.complex64)
    X = tm.solve_complex(t(A), t(B)).numpy()
    np.testing.assert_allclose(A @ X, B, rtol=1e-3, atol=1e-3)
    want = np.asarray(jm.solve_complex(jnp.asarray(A), jnp.asarray(B)))
    assert np.abs(X - want).max() <= 1e-5 * np.abs(want).max()
    Ar = rng.randn(4, 6, 6).astype(np.float32)
    Ar = Ar @ Ar.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)
    Br = rng.randn(4, 6, 2).astype(np.float32)
    np.testing.assert_allclose(
        tm.gauss_jordan_solve(t(Ar), t(Br)).numpy(),
        np.asarray(jm.gauss_jordan_solve(jnp.asarray(Ar), jnp.asarray(Br))),
        rtol=1e-5, atol=1e-6)


def test_masked_scm_einsum_path_matches_jax_and_the_kernel_wrapper():
    spk, noi, stft = _rand_case(1)
    wta = jm.make_wta(spk[None], noi[None])
    want = np.asarray(jm.masked_scm(wta, stft[None]))
    got = tm.masked_scm(t(wta), t(stft[None]))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    torch.testing.assert_close(tk.masked_scm(t(wta), t(stft[None])), got,
                               rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("seed", [0, 2])
def test_mvdr_beamform_matches_jax_and_the_oracle(use_pallas, seed):
    """Both SCM paths (the einsum, and the kernel wrapper, which takes its
    plain version on the CPU) against the JAX package (5e-4 relative: f32
    Gauss-Jordan on these well-conditioned T = 200 windows) and the
    float64 oracle (the JAX test's 2e-2)."""
    spk, noi, stft = _rand_case(seed)
    got = tm.mvdr_beamform(t(spk[None]), t(noi[None]), t(stft[None]),
                           use_pallas=use_pallas).numpy()[0]
    want = np.asarray(jm.mvdr_beamform(
        jnp.asarray(spk[None]), jnp.asarray(noi[None]),
        jnp.asarray(stft[None]), use_pallas=False))[0]
    assert got.shape == want.shape == spk.shape
    assert np.abs(got - want).max() <= 5e-4 * np.abs(want).max()
    oracle = np_mvdr_oracle(spk.astype(np.float64), noi.astype(np.float64),
                            stft.astype(np.complex128))
    np.testing.assert_allclose(got, oracle, rtol=2e-2, atol=2e-2)


def test_mvdr_on_an_all_zero_window_stays_finite():
    """A padding window's SCMs are 1e-15 * I; the trace normalisation
    keeps the solve finite and the output is zero."""
    spk, noi, stft = _rand_case(4, F=3, T=40)
    zero = np.zeros_like(stft)
    x = np.stack([stft, zero])
    out = tm.mvdr_beamform(t(np.stack([spk, spk])), t(np.stack([noi, noi])),
                           t(x), use_pallas=True)
    assert torch.isfinite(out).all()
    assert torch.equal(out[1], torch.zeros_like(out[1]))


def test_mvdr_where_one_source_wins_every_frame_of_a_bin():
    """Where one source wins every frame of a bin, the others' masked
    SCMs carry only the 1e-10 loser weight. The port sums them (as the
    float64 oracle does) and stays finite and within the oracle's 2e-2 on
    the winner's stream; the JAX package forms total - target in f32,
    which cancels to an indefinite noise SCM, and its unpivoted solve
    gives NaN there (ROADMAP.md section C)."""
    spk, noi, stft = _rand_case(5, F=4)
    spk[1] = 0.1
    spk[1, :, 2] = 0.9                  # source 2 wins all of bin 1
    noi[1] = 0.05
    got = tm.mvdr_beamform(t(spk[None]), t(noi[None]), t(stft[None]),
                           use_pallas=True).numpy()[0]
    want = np.asarray(jm.mvdr_beamform(jnp.asarray(spk[None]),
                                       jnp.asarray(noi[None]),
                                       jnp.asarray(stft[None])))[0]
    oracle = np_mvdr_oracle(spk.astype(np.float64), noi.astype(np.float64),
                            stft.astype(np.complex128))
    assert np.isfinite(got).all()
    assert not np.isfinite(want[1, :, 2]).all()
    np.testing.assert_allclose(got[1, :, 2], oracle[1, :, 2], rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(got[[0, 2, 3]], oracle[[0, 2, 3]], rtol=2e-2,
                               atol=2e-2)
