"""Operations and bytes of one CSS separation call (``CssEngine.
separate_sessions_batch``), from its shapes.

The Conformer's forward pass comes from counts/conformer.py. The rest is
counted at the sizes the call runs: each multiply-add counts 2, a complex
multiply-add 8, other elementwise arithmetic or function calls 1 each.

* ``stft``: every mic of every session's frames, as a DFT product;
* ``features``: the reference mic's magnitude and its normalisation, the
  7 phases, the 6 inter-mic differences and their mean normalisation;
* ``conformer``: the network on every real window;
* ``covariances``: sum_t m x x^H of each source (speakers and noise) in
  each bin of each window;
* ``solves``: a complex M x M system with M right-hand sides per
  (window, speaker, bin), as an LU factorisation (8/3 M^3) and two
  triangular solves per right-hand side (8 M^2 each), and the
  beamformer's sum over the mics;
* ``stitching``: the l1 loss of each adjacent pair's speaker masks over
  their common hop;
* ``ola``: the weighted overlap-add of the separated STFT and the masks;
* ``istft``: every stream's frames, as a DFT product.
"""
from typing import Dict, List

from gpubench.counts import conformer


def part_flops(c: Dict, sessions: List[Dict], T: int, hop: int,
               mics: int = 7) -> Dict[str, float]:
    """sessions: each session's real ``frames`` and ``windows``."""
    F, S = c["num_bins"], c["num_spks"]
    K = S + c["num_nois"]
    M = mics
    n_win = sum(s["windows"] for s in sessions)
    frames = sum(s["frames"] for s in sessions)
    pairs = sum(max(s["windows"] - 1, 0) for s in sessions)
    per_bin = 4 + 4 + M * 3 + (M - 1) * (1 + 2 + 4 + 1)
    solve = 8.0 / 3.0 * M ** 3 + 2 * 8 * M ** 2 * M + 8 * M * T
    return dict(
        stft=float(conformer.stft_flops(frames, M)),
        features=float(n_win * F * T * per_bin),
        conformer=float(n_win * conformer.forward_flops(c, T)),
        covariances=float(n_win * 8 * K * F * T * M * M),
        solves=float(n_win * S * F * solve),
        stitching=float(pairs * S * S * F * (T - hop) * 3),
        ola=float(n_win * S * F * T * 6),
        istft=float(conformer.stft_flops(frames, S)))


def weight_bytes(specs) -> float:
    """The network's tensors in float32 (reference.conformer.param_specs)."""
    n = 0
    for _, shape, _ in specs:
        k = 1
        for d in shape:
            k *= d
        n += k
    return 4.0 * n


def conformer_bytes(c: Dict, specs, windows: int, chunks: int,
                    T: int) -> float:
    """The least the Conformer moves: its weights once a chunk, each
    window's features in and masks out (float32)."""
    feats = c["in_features"] * T * 4
    out = c["num_bins"] * (c["num_spks"] + c["num_nois"]) * T * 4
    return chunks * weight_bytes(specs) + windows * (feats + out)
