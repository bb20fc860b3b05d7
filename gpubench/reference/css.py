"""Plain float32 multichannel CSS separation (the NOTSOFAR-1 baseline's
``separate_and_stitch`` with MVDR), for the benchmark's output check.

It imports nothing of the measured program. The STFT and the Conformer's
layers come from reference/conformer.py; every matmul runs in float32
with TF32 off, complex values in complex64, the MVDR solve in complex128.
A session is separated whole, window after window; windows are only
grouped into blocks so that the work fits.

* windows: 3 s (186 frames) every 1.5 s (93 frames) over the session's
  STFT, the frames past its end zero;
* ``features``: reference/conformer.py's features of a window's STFT;
* ``masks``: the Conformer of reference/conformer.py in eval mode (batch
  norm on its running statistics), optionally with every matmul's
  operands rounded to float8 e4m3 (the check's control);
* ``mvdr``: the published ``mvdr_util.py``: winner-take-all masks,
  R = sum_t m x x^H + 1e-15 I per source, W = solve(R_noise+others,
  R_target) / trace, its column 0, y = sum_c conj(W_c) X_c; the solve is
  ``torch.linalg.solve`` (pivoting) in complex128. Two choices follow the
  port, not the JAX package: R_noise+others is the sum of the other
  sources' covariances (not the total less the target's), and a window's
  frames of zero weight add nothing to the overlap-add;
* the speaker masks clamped at the floor, times the beamformed STFT;
* stitching: the l1 loss of each adjacent pair's masks over their common
  hop, and the permutation chain (the first of tied permutations wins);
* the trapezoid-weighted overlap-add, the activity gate (the mean
  stitched mask at the threshold, dilated then eroded; outside the
  session a dilation sees silence, an erosion activity, and the frames
  past the last window are silent), the iSTFT with the normalised
  sqrt-Hann synthesis window and int16 quantisation at the stream's peak.

``separate(..., follow=...)`` runs everything after the network on
another run's masks (MVDR's covariances amplify a mask's rounding by the
noise covariance's condition number, which seeded weights' masks near 0.5
make large: the network is held by its own comparison), and takes that
run's decisions where this one's are near ties or undetermined: the
separated STFT of a (window, speaker, bin) whose R_noise+others has a
condition number above ``cond_max`` (float32 covariances do not determine
its solve: a source that wins nearly every frame of a bin leaves the
others a few frames and 1e-10 weights), a window's permutation
where the other run's lies within ``perm_tie`` of the best total, and a
frame's activity decision where the mean mask lies within
``activity_margin`` of the threshold. It counts what it took and where the
other run's decision lay outside. Over the systems it took, it holds the
other run's beamformer to MVDR's equations instead (``backward_sums``:
its backward error, ``loose_gap`` over ``loose_scale``), which float32
covariances do determine.
"""
import itertools
import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from gpubench.reference import conformer as ref
from gpubench.reference.whisper import f32_matmuls, fp8

FS = 16000
FRAME, HOP = 512, 256
# the published CssCfg's defaults that the serving configuration keeps
SEG_WEIGHT_M0_SEC, SEG_WEIGHT_M1_SEC = 0.15, 0.3
DILATION_SEC, EROSION_SEC = 0.4, 0.2
SCM_EPS = 1e-15


def num_frames(samples: int) -> int:
    return (samples - FRAME) // HOP + 1


def geometry(serving: Dict) -> Dict[str, int]:
    """Window, hop, trapezoid edges and the gate's morphology, in frames."""
    seg = serving["segment_size_sec"]
    T = num_frames(int(seg * FS))
    return dict(T=T, hop=int(T * serving["hop_size_sec"] / seg),
                m0=int(T * SEG_WEIGHT_M0_SEC / seg),
                m1=int(T * SEG_WEIGHT_M1_SEC / seg),
                dilation=int(T * DILATION_SEC / seg),
                erosion=int(T * EROSION_SEC / seg))


def windows_of(samples: int, g: Dict) -> int:
    """Windows that cover a session of `samples`."""
    frames = max(num_frames(samples), g["T"])
    return int(math.ceil((frames - (g["T"] - g["hop"])) / g["hop"]))


def segment_weight(g: Dict, first: bool, last: bool) -> np.ndarray:
    """The trapezoid overlap-add weight of a window."""
    T, m0, m1 = g["T"], g["m0"], g["m1"]
    w = np.ones(T, np.float32)
    w[:m0] = 0.0
    w[T - m0:] = 0.0
    ramp = np.linspace(0.1, 1.0, m1 - m0, dtype=np.float32)
    w[m0:m1] = ramp
    w[T - m1:T - m0] = ramp[::-1]
    if first:
        w[:m0] = 0.1
    if last:
        w[T - m0:] = 0.1
    return w


# ---------------------------------------------------------------------------
# features and masks
# ---------------------------------------------------------------------------

def feature_parts(spec: torch.Tensor):
    """spec [B, 7, F, T] complex -> the parts of ``features``: mic 0's
    normalised magnitude [B, F, T], and the deviations (c, s) [B, 6, F, T]
    of each mic's phase difference to mic 0, as cosine and sine, from
    their means over the window, whose angle is the feature."""
    mag = spec[:, 0].abs().clamp_min(ref.EPS)
    mean = mag.mean(-1, keepdim=True)
    std = mag.std(-1, keepdim=True)
    pha = spec.angle()
    dif = pha[:, 1:] - pha[:, :1]
    c, s = torch.cos(dif), torch.sin(dif)
    return ((mag - mean) / (std + ref.EPS), c - c.mean(-1, keepdim=True),
            s - s.mean(-1, keepdim=True))


def features(spec: torch.Tensor) -> torch.Tensor:
    """spec [B, 7, F, T] complex -> [B, 1799, T]: reference/conformer.py's
    ``features`` after its STFT (the window's frames past the session's
    end are zero, which its own STFT of samples would not give)."""
    mag, c, s = feature_parts(spec)
    ipd = torch.atan2(s, c)
    B, M, Fq, T = ipd.shape
    return torch.cat([mag, ipd.reshape(B, M * Fq, T)], dim=1)


def session_spec(x: torch.Tensor, g: Dict):
    """A session [N, 7] -> (its STFT [7, F, L] padded with zero frames to
    the L frames its windows cover, its windows n, its own frames Tn)."""
    spec = ref.stft(x.t())                                   # [7, F, Tn]
    Tn = spec.shape[-1]
    n = windows_of(x.shape[0], g)
    L = (n - 1) * g["hop"] + g["T"]
    padded = torch.zeros(spec.shape[:2] + (L,), dtype=spec.dtype,
                         device=spec.device)
    padded[..., :Tn] = spec
    return padded, n, Tn


def window_specs(padded: torch.Tensor, ks, g: Dict) -> torch.Tensor:
    """Windows ks of a session_spec: [len(ks), 7, F, T]."""
    return torch.stack([padded[..., k * g["hop"]:k * g["hop"] + g["T"]]
                        for k in ks])


class _Ops:
    """A matmul's operands as float32, or rounded to float8 e4m3 (lowp)."""

    def __init__(self, p: Dict[str, torch.Tensor], lowp: bool):
        self.p, self.lowp = p, lowp

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return fp8(x) if self.lowp else x

    def lin(self, x, name):
        w = self.p[f"{name}.weight"]
        return F.linear(self.q(x), self.q(w), self.p[f"{name}.bias"])

    def ln(self, x, name):
        return ref._ln(x, self.p, name)


def _ffn(o: _Ops, x, name):
    return o.lin(torch.relu(o.lin(o.ln(x, f"{name}.ln"), f"{name}.w1")),
                 f"{name}.w2")


def _attention(o: _Ops, x, name, heads, pos_k):
    B, T, D = x.shape
    dk = D // heads
    y = o.ln(x, f"{name}.ln")
    q, k, v = (o.lin(y, f"{name}.{m}").view(B, T, heads, dk).transpose(1, 2)
               for m in ("q", "k", "v"))
    q = o.q(q)
    scores = q @ o.q(k).transpose(-1, -2) + \
        torch.einsum("bhtd,tsd->bhts", q, o.q(pos_k))
    att = torch.softmax(scores / math.sqrt(dk), dim=-1)
    out = (o.q(att) @ o.q(v.transpose(-1, -2)).transpose(-1, -2))
    return o.lin(out.transpose(1, 2).reshape(B, T, D), f"{name}.out")


def _conv(o: _Ops, x, name, kernel):
    p = o.p
    y = o.ln(x, f"{name}.ln")
    w, b = p[f"{name}.pw1_w"], p[f"{name}.pw1_b"]
    y = (y * w[0] + b[0]) * torch.sigmoid(y * w[1] + b[1])
    dw = p[f"{name}.dw.weight"]
    y = F.conv1d(o.q(y).transpose(1, 2), o.q(dw.reshape(dw.shape[0], -1))
                 .reshape(dw.shape), p[f"{name}.dw.bias"],
                 padding=(kernel - 1) // 2, groups=y.shape[-1]).transpose(1, 2)
    y = (y - p[f"{name}.bn.running_mean"]) * torch.rsqrt(
        p[f"{name}.bn.running_var"] + 1e-5) * p[f"{name}.bn.weight"] + \
        p[f"{name}.bn.bias"]
    return torch.relu(y) * p[f"{name}.pw2_w"][0] + p[f"{name}.pw2_b"][0]


def masks(p: Dict[str, torch.Tensor], c: Dict, feat: torch.Tensor,
          lowp: bool = False) -> torch.Tensor:
    """feat [B, 1799, T] -> masks [B, F, T, speakers + noises], the
    network of reference/conformer.py ``masks`` in eval mode."""
    o = _Ops(p, lowp)
    x = (feat.transpose(1, 2) + p["input_bias"]) * p["input_scale"]
    x = torch.relu(o.ln(o.lin(x, "encoder.embed"), "encoder.embed_ln"))
    T = x.shape[1]
    ar = torch.arange(T, device=x.device)
    L = c["pos_maxlen"]
    pos_k = p["encoder.pos_emb"][torch.clamp(ar[:, None] - ar[None, :], -L,
                                             L - 1) + L]
    for i in range(c["num_blocks"]):
        n = f"encoder.layer_{i}"
        x = x + 0.5 * _ffn(o, x, f"{n}.ffn_in")
        x = x + _attention(o, x, f"{n}.attn", c["attention_heads"], pos_k)
        x = x + _conv(o, x, f"{n}.conv", c["kernel_size"])
        x = x + 0.5 * _ffn(o, x, f"{n}.ffn_out")
        x = o.ln(x, f"{n}.ln_out")
    m = torch.sigmoid(o.lin(x, "mask_head"))
    S = c["num_spks"] + c["num_nois"]
    return m.view(m.shape[0], T, S, c["num_bins"]).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# MVDR
# ---------------------------------------------------------------------------

def _solve_no_pivot(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A X = B by Gauss-Jordan elimination without pivoting, in A's
    dtype (the control's complex64 solve)."""
    n = A.shape[-1]
    aug = torch.cat([A, B], dim=-1)
    for i in range(n):
        row = aug[..., i:i + 1, :] / aug[..., i:i + 1, i:i + 1]
        aug = aug - aug[..., :, i:i + 1] * row
        aug = torch.cat([aug[..., :i, :], row, aug[..., i + 1:, :]], dim=-2)
    return aug[..., n:]


def mvdr(spk: torch.Tensor, noise: torch.Tensor, X: torch.Tensor,
         solve: str = "complex128"):
    """spk [B,F,T,S], noise [B,F,T,N] masks, X [B,F,T,M] complex64 ->
    ([B,F,T,S] beamformed, [B,S,F] condition number of each speaker's
    R_noise+others, those matrices [B,S,F,M,M] and R_target's first
    columns [B,S,F,M]). solve: 'complex128' (pivoting) or
    'complex64_no_pivot' (the control)."""
    S, M = spk.shape[-1], X.shape[-1]
    m = torch.cat([spk, noise.sum(-1, keepdim=True)], dim=-1)
    m = torch.where(m == m.max(-1, keepdim=True).values, m,
                    torch.full_like(m, 1e-10))
    xt = X.transpose(-1, -2)                                 # [B,F,M,T]
    eye = torch.eye(M, dtype=X.dtype, device=X.device)
    R = torch.stack([(xt * m[..., k][:, :, None, :].to(X.dtype))
                     @ X.conj() + SCM_EPS * eye
                     for k in range(S + 1)], dim=1)           # [B,K,F,M,M]
    Rn = torch.stack([sum((R[:, j] for j in range(S) if j != i), R[:, S])
                      for i in range(S)], dim=1)
    Rs = R[:, :S]
    if solve == "complex128":
        num = torch.linalg.solve(Rn.to(torch.complex128),
                                 Rs.to(torch.complex128))
    else:
        num = _solve_no_pivot(Rn, Rs).to(torch.complex128)
    den = torch.diagonal(num, dim1=-2, dim2=-1).sum(-1)      # [B,S,F]
    den[:, :, 0] += SCM_EPS
    W = (num[..., 0] / den[..., None]).to(X.dtype)           # [B,S,F,M]
    ev = torch.linalg.eigvalsh(Rn.to(torch.complex128))      # ascending
    cond = ev[..., -1] / ev[..., 0].clamp_min(1e-300)
    return torch.einsum("bsfm,bftm->bfts", W.conj(), X), cond, Rn, Rs[..., 0]


def backward_sums(X: torch.Tensor, Y: torch.Tensor, Rn: torch.Tensor,
                  Rsu: torch.Tensor, which: torch.Tensor):
    """How far another run's beamformer is from solving MVDR's equations,
    over the (window, speaker, bin) systems `which` [B,S,F]: its weights W
    are recovered from its output Y [B,S,F,T] (its separated STFT over its
    clipped masks) on the mixture X [B,F,T,M] by least squares; MVDR's W
    solves R_noise+others W = c R_target u for a scalar c (u: mic 0), so
    the residual r = Rn W - c Rsu, c fitted, is its backward error. Returns
    (sum |r|^2, sum (|Rn| |W| + |c| |Rsu|)^2), complex128; a non-finite Y
    makes both NaN."""
    b, s, f = which.nonzero(as_tuple=True)
    if b.numel() == 0:
        return 0.0, 0.0
    A = X[b, f].to(torch.complex128)                          # [n, T, M]
    AH = A.conj().transpose(-1, -2)
    y = Y[b, s, f].to(torch.complex128)[..., None]           # [n, T, 1]
    W = torch.linalg.solve(AH @ A, AH @ y)[..., 0].conj()    # [n, M]
    R = Rn[b, s, f].to(torch.complex128)
    a = Rsu[b, s, f].to(torch.complex128)
    v = (R @ W[..., None])[..., 0]
    c = (a.conj() * v).sum(-1) / (a.abs() ** 2).sum(-1).clamp_min(1e-300)
    r = v - c[:, None] * a
    scale = torch.linalg.matrix_norm(R) * torch.linalg.vector_norm(W, dim=-1) \
        + c.abs() * torch.linalg.vector_norm(a, dim=-1)
    return float((r.abs() ** 2).sum()), float((scale ** 2).sum())


# ---------------------------------------------------------------------------
# stitching, gate, synthesis
# ---------------------------------------------------------------------------

def chain(losses: np.ndarray, follow: Optional[np.ndarray], tie: float,
          tally: Dict) -> np.ndarray:
    """losses [n-1, S, S] (window i's source a against window i+1's b) ->
    perms [n, S]: stream s holds window i's source perms[i, s]. follow
    [n, S]: another run's perms, taken where its choice lies within `tie`
    of the best total."""
    S = losses.shape[-1]
    perms = list(itertools.permutations(range(S)))
    p = np.arange(S)
    out = [p]
    for i in range(losses.shape[0]):
        tot = np.array([sum(float(losses[i][p[s], q[s]]) for s in range(S))
                        for q in perms])
        best = int(np.argmin(tot))
        pick = best
        if follow is not None:
            # the other run's alignment of window i+1 to window i, applied
            # to this run's streams
            rel = np.empty(S, np.int64)
            rel[follow[i]] = follow[i + 1]
            theirs = perms.index(tuple(int(rel[p[s]]) for s in range(S)))
            if theirs != best:
                if tot[theirs] - tot[best] <= tie:
                    pick = theirs
                    tally["perm_excused"] += 1
                else:
                    tally["perm_err"] += 1
            tally["perm_gap_max"] = max(tally["perm_gap_max"],
                                        float(tot[theirs] - tot[best]))
        p = np.asarray(perms[pick], np.int64)
        out.append(p)
    return np.stack(out)


def _window_count(x: torch.Tensor, k: int, pad: float) -> torch.Tensor:
    """Sum of x [S, L] over a window of 2k+1 frames, padded with `pad`."""
    xp = F.pad(x.float(), (k, k), value=pad)
    cs = F.pad(torch.cumsum(xp, dim=-1), (1, 0))
    return cs[:, 2 * k + 1:] - cs[:, :-(2 * k + 1)]


def gate(bits: torch.Tensor, dilation: int, erosion: int) -> torch.Tensor:
    """Binary dilation (outside: silent) then erosion (outside: active)."""
    d = _window_count(bits, dilation, 0.0) > 0.5
    return _window_count(d, erosion, 1.0) > 2 * erosion + 0.5


def istft(spec: torch.Tensor) -> torch.Tensor:
    """spec [S, F, L] -> [S, (L-1)*256 + 512]: the transposed convolution
    with the normalised sqrt-Hann analysis kernel (the baseline builds its
    iSTFT without the analysis window argument)."""
    n = np.arange(FRAME, dtype=np.float64)
    w = np.sqrt(0.5 * (1.0 - np.cos(2.0 * np.pi * n / FRAME)))
    scale = 0.5 * (FRAME * FRAME / HOP) ** 0.5
    ph = 2.0 * np.pi * np.outer(np.arange(FRAME // 2 + 1), n) / FRAME
    kr = torch.from_numpy((np.cos(ph) * w / scale).astype(np.float32))
    ki = torch.from_numpy((-np.sin(ph) * w / scale).astype(np.float32))
    kr, ki = kr.to(spec.device), ki.to(spec.device)
    frames = spec.real.transpose(-1, -2) @ kr + \
        spec.imag.transpose(-1, -2) @ ki                      # [S, L, 512]
    S, L, _ = frames.shape
    out = torch.zeros(S, (L - 1) * HOP + FRAME, device=spec.device)
    for j in range(FRAME // HOP):
        part = frames[:, :, j * HOP:(j + 1) * HOP].reshape(S, -1)
        out[:, j * HOP:j * HOP + L * HOP] += part
    return out


# ---------------------------------------------------------------------------
# the separation
# ---------------------------------------------------------------------------

def separate(sessions: List[torch.Tensor], p: Dict[str, torch.Tensor],
             c: Dict, serving: Dict, lowp: bool = False,
             solve: str = "complex128", follow: Optional[List[Dict]] = None,
             cond_max: float = math.inf, perm_tie: float = 0.0,
             activity_margin: float = 0.0, block: int = 32) -> Dict:
    """Each session [N, 7] float32 (on the device the work runs on; int16
    values over 32768, which the engine's int16 quantisation keeps exactly)
    ->
    per session: masks [n, F, T, 4] and separated [n, S, F, T] of each
    window, perms [n, S], mean stitched masks [S, L], threshold
    decisions and gates [S, L] (L: the frames the windows cover) and the
    streams [S, samples] (int16 over the stream's scale, as float32);
    and the tally of decisions taken from `follow` (a list like this
    one's ``sessions``, whose ``masks`` this run's MVDR and stitching
    take)."""
    g = geometry(serving)
    T, hop = g["T"], g["hop"]
    floor_db = serving["mc_mask_floor_db"]
    floor = 10.0 ** (floor_db / 20.0) if np.isfinite(floor_db) else 0.0
    th = serving["activity_th"]
    S = c["num_spks"]
    tally = dict(undetermined=0, systems=0, loose_gap=0.0, loose_scale=0.0,
                 perm_err=0, perm_excused=0,
                 perm_gap_max=0.0,
                 activity_adopted=0, activity_outside=0)
    out = []
    with f32_matmuls(), torch.no_grad():
        for b, x in enumerate(sessions):
            padded, n, Tn = session_spec(x, g)
            L = (n - 1) * hop + T
            fol = follow[b] if follow is not None else None
            all_masks, seps, conds = [], [], []
            for k0 in range(0, n, block):
                ks = range(k0, min(n, k0 + block))
                win = window_specs(padded, ks, g)           # [B,7,F,T]
                if fol is None:
                    m = masks(p, c, features(win), lowp)     # [B,F,T,4]
                else:
                    m = fol["masks"][k0:k0 + len(ks)].to(win.device)
                X = win.permute(0, 2, 3, 1)
                bf, cond, Rn, Rsu = mvdr(m[..., :S], m[..., S:], X, solve)
                clipped = torch.clamp(m[..., :S], min=floor)
                sep = bf * clipped.to(bf.dtype)
                if fol is not None:
                    # the other run's beamformer where this one's does not
                    # determine it
                    theirs = fol["separated"][k0:k0 + len(ks)].to(X.device)
                    part = backward_sums(
                        X, theirs / clipped.permute(0, 3, 1, 2),
                        Rn, Rsu, cond > cond_max)
                    tally["loose_gap"] += part[0]
                    tally["loose_scale"] += part[1]
                conds.append(cond)
                all_masks.append(m)
                seps.append(sep.permute(0, 3, 1, 2))
            all_masks, seps = torch.cat(all_masks), torch.cat(seps)
            conds = torch.cat(conds)                         # [n, S, F]
            determined = conds <= cond_max
            if fol is not None:
                theirs = fol["separated"].to(seps.device)
                seps = torch.where(determined[..., None], seps, theirs)
                tally["undetermined"] += int((~determined).sum())
                tally["systems"] += determined.numel()
            spk = all_masks[..., :S].permute(0, 3, 1, 2)     # [n,S,F,T]
            ov = T - hop
            losses = torch.stack([
                (spk[i, :, None, :, -ov:] - spk[i + 1, None, :, :, :ov])
                .abs().mean(dim=(2, 3)) for i in range(n - 1)]) \
                if n > 1 else spk.new_zeros((0, S, S))
            perms = chain(losses.double().cpu().numpy(),
                          None if fol is None else fol["perms"], perm_tie,
                          tally)
            stitched = torch.zeros((S, padded.shape[1], L), dtype=seps.dtype,
                                   device=seps.device)
            mstitched = torch.zeros((S, padded.shape[1], L),
                                    device=seps.device)
            wsum = torch.zeros(L, device=seps.device)
            for k in range(n):
                w = torch.from_numpy(segment_weight(g, k == 0, k == n - 1)
                                     ).to(seps.device)
                idx = torch.from_numpy(perms[k]).to(seps.device)
                sl = slice(k * hop, k * hop + T)
                keep = w > 0
                stitched[:, :, sl] += torch.where(keep, seps[k, idx] * w, 0)
                mstitched[:, :, sl] += torch.where(keep, spk[k, idx] * w, 0)
                wsum[sl] += w
            wsafe = torch.where(wsum > 1e-5, wsum, torch.ones_like(wsum))
            stitched = stitched / wsafe
            activity = (mstitched / wsafe).mean(dim=1)      # [S, L]
            bits = activity >= th
            if fol is not None:
                near = (activity - th).abs() <= activity_margin
                theirs = fol["bits"].to(bits.device)
                tally["activity_adopted"] += int((near & (theirs != bits))
                                                 .sum())
                tally["activity_outside"] += int((~near & (theirs != bits))
                                                 .sum())
                bits = torch.where(near, theirs, bits)
            past = g["dilation"] + g["erosion"]
            gates = gate(torch.cat([bits, bits.new_zeros(S, past)], dim=1),
                         g["dilation"], g["erosion"])[:, :L]
            gated = torch.where(gates[:, None, :], stitched, 0)
            samples = (Tn - 1) * HOP + FRAME
            wav = istft(gated)[:, :samples]
            scale = 32767.0 / wav.abs().amax(-1, keepdim=True).clamp_min(1e-7)
            streams = torch.round(wav * scale) / scale
            out.append(dict(masks=all_masks, separated=seps, perms=perms,
                            determined=determined,
                            activity=activity, bits=bits, gates=gates,
                            streams=streams, frames=Tn))
    return dict(sessions=out, tally=tally)
