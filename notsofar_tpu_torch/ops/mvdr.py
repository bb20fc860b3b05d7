"""Mask-weighted MVDR beamforming on a batch of windows.

Port of notsofar_tpu/ops/mvdr.py (the reference make_mvdr):

1. winner-take-all mask combine,
2. masked spatial covariance R = sum_t m * x x^H (+1e-15*I): the einsum,
   or with use_pallas the CUDA kernel behind ops.kernels.masked_scm,
3. per-(source, freq) W = solve(R_noise+others, R_tgt) / trace, column 0,
   on the trace-normalised real embedding, by the JAX package's unrolled
   Gauss-Jordan elimination without pivoting, run in float64 on the f32
   SCMs. Two departures from the JAX package, both where its f32 arithmetic
   fails: R_noise+others is the sum of the other SCMs (as in the reference
   oracle), not total - R_tgt, which cancels to an indefinite matrix where
   one source wins every frame of a bin (NaN); and the elimination runs in
   float64, because where a source wins nearly every frame the noise SCM's
   condition number reaches ~1e8 and f32 elimination returns rounding
   noise (a pivoting f32 solver, like the reference's, resolves it),
4. y = sum_c conj(W) * X.

The +1e-15 on the trace denominator lands at frequency 0 only, as in the
reference. Divisions by a real scalar are done on the real and imaginary
parts, and the complex num/den by Smith's algorithm, the arithmetic the
JAX package's complex division lowers to.

Profiler spans: ``stage.mvdr.scm`` (the winner-take-all masks and the
covariances) and ``stage.mvdr.solve`` (the solve and the weights).
"""
import torch

from notsofar_tpu_torch.ops.kernels import masked_scm as masked_scm_kernel
from notsofar_tpu_torch.utils.profiling import span


def make_wta(spk_masks: torch.Tensor, noise_masks: torch.Tensor
             ) -> torch.Tensor:
    """Winner-take-all combine: [B,F,T,S], [B,F,T,N] -> [B,F,T,S+1]; noise
    masks are summed into one, losers floored to 1e-10."""
    noise = noise_masks.sum(dim=-1, keepdim=True)
    m = torch.cat([spk_masks, noise], dim=-1)
    mmax = m.max(dim=-1, keepdim=True).values
    return torch.where(m == mmax, m, torch.full_like(m, 1e-10))


def masked_scm(masks: torch.Tensor, stft_c: torch.Tensor) -> torch.Tensor:
    """masks [B,F,T,K], stft [B,F,T,M] complex -> [B,K,F,M,M] with
    +1e-15*I (the JAX package's non-kernel path)."""
    scm = torch.einsum("bftk,bftm,bftn->bkfmn", masks.to(stft_c.dtype),
                       stft_c, stft_c.conj())
    eye = torch.eye(stft_c.shape[-1], dtype=scm.dtype, device=scm.device)
    return scm + 1e-15 * eye


def gauss_jordan_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched A X = B by unrolled Gauss-Jordan elimination, no pivoting.
    A: [..., n, n], B: [..., n, k] real; meant for the (near-)SPD real
    embeddings of Hermitian positive-definite covariances."""
    n = A.shape[-1]
    aug = torch.cat([A, B], dim=-1)                    # [..., n, n+k]
    for i in range(n):
        pivot = aug[..., i:i + 1, i:i + 1]
        row = aug[..., i:i + 1, :] / pivot
        factor = aug[..., :, i:i + 1]
        aug = aug - factor * row
        aug = torch.cat([aug[..., :i, :], row, aug[..., i + 1:, :]], dim=-2)
    return aug[..., n:]


def solve_complex(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A X = B for batched complex matrices via the real embedding
    [[Ar, -Ai], [Ai, Ar]] [[Xr], [Xi]] = [[Br], [Bi]]."""
    Ar, Ai = A.real, A.imag
    top = torch.cat([Ar, -Ai], dim=-1)
    bot = torch.cat([Ai, Ar], dim=-1)
    A2 = torch.cat([top, bot], dim=-2)                 # [..., 2M, 2M]
    B2 = torch.cat([B.real, B.imag], dim=-2)           # [..., 2M, K]
    X2 = gauss_jordan_solve(A2, B2)
    M = A.shape[-1]
    return torch.complex(X2[..., :M, :], X2[..., M:, :])


def _div_real(z: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """complex z / real r, part by part."""
    return torch.complex(z.real / r, z.imag / r)


def _cdiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """complex a / b by Smith's algorithm."""
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    big_r = br.abs() >= bi.abs()
    ratio = torch.where(big_r, bi / br, br / bi)
    denom = torch.where(big_r, br + bi * ratio, bi + br * ratio)
    re = torch.where(big_r, ar + ai * ratio, ar * ratio + ai) / denom
    im = torch.where(big_r, ai - ar * ratio, ai * ratio - ar) / denom
    return torch.complex(re, im)


def mvdr_beamform(spk_masks: torch.Tensor, noise_masks: torch.Tensor,
                  stft_c: torch.Tensor, use_pallas: bool = False
                  ) -> torch.Tensor:
    """spk_masks [B,F,T,S], noise_masks [B,F,T,N] f32, stft_c [B,F,T,M]
    complex64 -> [B,F,T,S] complex beamformed STFT per speaker.
    use_pallas selects the masked-SCM kernel (ops.kernels.masked_scm)."""
    S = spk_masks.shape[-1]
    with span("stage.mvdr.scm"):
        wta = make_wta(spk_masks, noise_masks)         # [B,F,T,S+1]
        if use_pallas:
            scm = masked_scm_kernel(wta.contiguous(), stft_c.contiguous())
        else:
            scm = masked_scm(wta, stft_c)              # [B,S+1,F,M,M]
    with span("stage.mvdr.solve"):
        W = _weights(scm, S, stft_c.dtype)
    return torch.einsum("bsfm,bftm->bfts", W.conj(), stft_c)


def _weights(scm: torch.Tensor, S: int, dtype) -> torch.Tensor:
    """scm [B,S+1,F,M,M] -> MVDR weights [B,S,F,M] of each speaker."""
    spk_scm = scm[:, :S]
    # noise + the other speakers, summed rather than total - target: where
    # one source wins every frame of a bin the others carry 1e-10 weights,
    # and the f32 difference would cancel into an indefinite matrix
    noi_scm = torch.stack(
        [sum((scm[:, j] for j in range(S) if j != i), scm[:, S])
         for i in range(S)], dim=1)
    # W = num / trace(num) is invariant to scaling either operand, so
    # both are normalised by their traces to keep the f32 pivots in range
    noi_tr = torch.diagonal(noi_scm, dim1=-2, dim2=-1).sum(-1).real
    spk_tr = torch.diagonal(spk_scm, dim1=-2, dim2=-1).sum(-1).real
    noi_n = _div_real(noi_scm, noi_tr[..., None, None])
    spk_n = _div_real(spk_scm, spk_tr[..., None, None])
    num = solve_complex(noi_n.to(torch.complex128),
                        spk_n.to(torch.complex128)).to(dtype)
    den = torch.diagonal(num, dim1=-2, dim2=-1).sum(-1)   # [B,S,F]
    den = torch.cat([den[:, :, :1] + 1e-15, den[:, :, 1:]], dim=2)
    return _cdiv(num[..., 0], den[..., None])          # [B,S,F,M]
