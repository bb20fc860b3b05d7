"""Speaker clustering: cosine affinity, NMESC auto-tuning, spectral
clustering.

Port of notsofar_tpu/diarization/clustering.py (the published NMESC
algorithm, Park et al., IEEE SPL 2019, as NeMo implements it):

1. cosine affinity matrix, min-max scaled to [0, 1];
2. sparse search over the binarization parameter p: keep the top-p
   neighbours per row, symmetrize, estimate the speaker count from the
   eigengap of the graph Laplacian, and compute the NME ratio
   g_p = (p / N) / (max eigengap / max eigenvalue);
3. pick p minimizing g_p (repaired to the first connected candidate),
   take its speaker-count estimate (capped at max_num_speakers);
4. spectral clustering: k smallest Laplacian eigenvectors + k-means++.

Two paths, chosen by the affinity's type, never by a fallback:

* a numpy affinity takes the float64 host path (numpy/scipy, a copy of
  the JAX package's reference math);
* a torch tensor with N >= 64 takes the batched device path on that
  tensor's device (the CUDA card when serving; CPU tensors run the same
  algorithm in the tests): every candidate's binarize + Laplacian +
  eigen-statistics in one batch (polynomial-filtered subspace iteration
  with CholeskyQR2, power iteration, log-depth reachability), then the
  final binarize + eigenvectors + k-means++. f32 throughout; its
  decisions (p_hat, speaker count, partition) are tested against the
  host path. A tensor with N < 64 goes to the host path, as in the JAX
  package.
"""
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

DEVICE_MIN_N = 64       # smaller affinities always take the host path


def _on_device(aff) -> bool:
    return isinstance(aff, torch.Tensor) and aff.shape[0] >= DEVICE_MIN_N


def _host(aff) -> np.ndarray:
    if isinstance(aff, torch.Tensor):
        return aff.detach().cpu().double().numpy()
    return np.asarray(aff, np.float64)


# ---------------------------------------------------------------------------
# float64 host path (copy of the JAX package's numpy/scipy reference)
# ---------------------------------------------------------------------------

def cos_affinity_matrix(emb: np.ndarray) -> np.ndarray:
    """emb: [N, D] -> affinity [N, N] min-max scaled to [0, 1]."""
    emb = np.asarray(emb, np.float64)
    norms = np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12
    e = emb / norms
    sim = e @ e.T
    np.fill_diagonal(sim, 1.0)
    lo, hi = sim.min(), sim.max()
    if hi - lo < 1e-12:
        return np.ones_like(sim)
    return (sim - lo) / (hi - lo)


def binarize_top_p(mat: np.ndarray, p: int) -> np.ndarray:
    """Keep each row's top-p affinity values (others zeroed), then
    symmetrize by averaging — NeMo's getAffinityGraphMat equivalent."""
    N = mat.shape[0]
    p = int(np.clip(p, 1, N))
    idx = np.argpartition(mat, N - p, axis=1)[:, N - p:]
    x = np.zeros_like(mat)
    rows = np.arange(N)[:, None]
    x[rows, idx] = mat[rows, idx]
    return 0.5 * (x + x.T)


def laplacian(aff: np.ndarray) -> np.ndarray:
    d = aff.sum(axis=1)
    L = -aff.copy()
    np.fill_diagonal(L, d - np.diag(aff))
    return L


def _safe_eigvalsh(M: np.ndarray) -> np.ndarray:
    """eigvalsh with jitter retries — LAPACK can fail to converge on large
    nearly-degenerate affinity Laplacians; a tiny diagonal jitter resolves
    it without affecting the eigengap statistics."""
    M = np.nan_to_num(np.asarray(M, np.float64))
    for jitter in (0.0, 1e-10, 1e-8, 1e-6):
        try:
            return np.linalg.eigvalsh(
                M + jitter * np.eye(len(M)) if jitter else M)
        except np.linalg.LinAlgError:
            continue
    import scipy.linalg
    return scipy.linalg.eigh(M + 1e-6 * np.eye(len(M)), eigvals_only=True)


def _safe_eigh(M: np.ndarray):
    M = np.nan_to_num(np.asarray(M, np.float64))
    for jitter in (0.0, 1e-10, 1e-8, 1e-6):
        try:
            return np.linalg.eigh(M + jitter * np.eye(len(M)) if jitter else M)
        except np.linalg.LinAlgError:
            continue
    import scipy.linalg
    return scipy.linalg.eigh(M + 1e-6 * np.eye(len(M)))


def estimate_num_speakers(aff: np.ndarray, max_num_speakers: int = 8
                          ) -> Tuple[int, np.ndarray, np.ndarray]:
    """Eigengap speaker-count estimate on the graph Laplacian."""
    L = laplacian(aff)
    lambdas = np.sort(_safe_eigvalsh(L))
    lambdas = np.maximum(lambdas, 0.0)
    upper = min(max_num_speakers + 1, len(lambdas))
    gaps = np.diff(lambdas[:upper])  # gap k = lambda_{k+1} - lambda_k
    if len(gaps) == 0:
        return 1, lambdas, np.zeros(1)
    num_spk = int(np.argmax(gaps)) + 1
    return num_spk, lambdas, gaps


@dataclass
class NmescResult:
    num_speakers: int
    p_hat: int
    g_p: float
    # None = unknown (the host path checks connectivity lazily); the
    # device statistics carry it for every candidate
    connected: Optional[bool] = None


def is_graph_fully_connected(aff_bin: np.ndarray) -> bool:
    """BFS from node 0 over nonzero edges (NeMo isGraphFullyConnected)."""
    N = aff_bin.shape[0]
    seen = np.zeros(N, bool)
    stack = [0]
    seen[0] = True
    adj = aff_bin > 0
    while stack:
        i = stack.pop()
        nxt = np.where(adj[i] & ~seen)[0]
        seen[nxt] = True
        stack.extend(nxt.tolist())
    return bool(seen.all())


def _kmeans_pp_init(x: np.ndarray, k: int, rng: np.random.RandomState
                    ) -> np.ndarray:
    centers = [x[rng.randint(len(x))]]
    for _ in range(1, k):
        d2 = np.min([((x - c) ** 2).sum(1) for c in centers], axis=0)
        probs = d2 / max(d2.sum(), 1e-12)
        centers.append(x[rng.choice(len(x), p=probs)])
    return np.stack(centers)


def kmeans(x: np.ndarray, k: int, n_iter: int = 300, seed: int = 0,
           n_init: int = 10) -> np.ndarray:
    """k-means++ with several restarts; deterministic via seed."""
    rng = np.random.RandomState(seed)
    best_labels, best_inertia = None, None
    for _ in range(n_init):
        c = _kmeans_pp_init(x, k, rng)
        for _ in range(n_iter):
            d = ((x[:, None, :] - c[None]) ** 2).sum(-1)
            labels = d.argmin(1)
            newc = np.stack([
                x[labels == j].mean(0) if (labels == j).any() else c[j]
                for j in range(k)])
            if np.allclose(newc, c):
                break
            c = newc
        inertia = ((x - c[labels]) ** 2).sum()
        if best_inertia is None or inertia < best_inertia:
            best_labels, best_inertia = labels, inertia
    return best_labels


def _candidates(N: int, max_rp_threshold: float,
                sparse_search_volume: int) -> np.ndarray:
    p_max = max(int(np.floor(N * max_rp_threshold)), 2)
    return np.unique(np.linspace(1, p_max, num=min(
        sparse_search_volume, p_max)).astype(int))


def _eval_candidates_host(affinity: np.ndarray, candidates: np.ndarray,
                          max_num_speakers: int) -> List[NmescResult]:
    """Per-candidate float64 LAPACK eigvalsh (the reference)."""
    N = affinity.shape[0]
    out = []
    for p in candidates:
        aff_p = binarize_top_p(affinity, int(p))
        num_spk, lambdas, gaps = estimate_num_speakers(aff_p,
                                                       max_num_speakers)
        lambda_max = max(lambdas.max(), 1e-10)
        max_gap = gaps.max() if len(gaps) else 0.0
        nme = max_gap / lambda_max
        g_p = (p / N) / (nme + 1e-10)
        out.append(NmescResult(num_spk, int(p), float(g_p)))
    return out


def _results_from_stats(packed: np.ndarray, P: int, upper: int,
                        candidates: np.ndarray, N: int) -> List[NmescResult]:
    lam_small, lam_max = packed[:P, :upper], packed[:P, upper]
    conn = packed[:P, upper + 1] > 0.5
    out = []
    for ci, p in enumerate(candidates):
        lambdas = np.maximum(lam_small[ci], 0.0)
        gaps = np.diff(lambdas)
        num_spk = (int(np.argmax(gaps)) + 1) if len(gaps) else 1
        lmax = max(float(lam_max[ci]), 1e-10)
        max_gap = gaps.max() if len(gaps) else 0.0
        nme = max_gap / lmax
        g_p = (p / N) / (nme + 1e-10)
        out.append(NmescResult(num_spk, int(p), float(g_p),
                               connected=bool(conn[ci])))
    return out


def nmesc(affinity, max_num_speakers: int = 8,
          max_rp_threshold: float = 0.06,
          sparse_search_volume: int = 30,
          min_samples_for_nmesc: int = 6) -> NmescResult:
    """Normalized Maximum Eigengap search over the pruning parameter p
    (NeMo defaults: 8 speakers, max_rp_threshold 0.06, 30 candidates).
    affinity: numpy (host path) or torch tensor (device path if N >= 64).
    """
    N = affinity.shape[0]
    if N < min_samples_for_nmesc:
        return NmescResult(1 if N <= 1 else
                           estimate_num_speakers(_host(affinity), 2)[0],
                           max(1, N // 2), 0.0)
    candidates = _candidates(N, max_rp_threshold, sparse_search_volume)
    if _on_device(affinity):
        packed, P, upper = _candidate_eigs_device(affinity, candidates,
                                                  max_num_speakers)
        results = _results_from_stats(
            packed.cpu().double().numpy(), P, upper, candidates, N)
    else:
        results = _eval_candidates_host(_host(affinity), candidates,
                                        max_num_speakers)
    return _pick_with_repair(results, affinity, max_num_speakers)


def _pick_with_repair(cand_results, affinity, max_num_speakers: int
                      ) -> NmescResult:
    """argmin g_p + connectivity repair (NeMo getMinimumConnection): a
    pruning level that disconnects the graph yields all-zero eigengaps
    and a meaningless speaker count, so walk the candidate list to the
    first connected p (connectivity is monotone in p); when no candidate
    connects, search past the last one."""
    N = affinity.shape[0]
    best = min(cand_results, key=lambda r: r.g_p)

    def is_connected(r: NmescResult) -> bool:
        # device statistics carry every candidate's flag; the host path
        # checks lazily
        if r.connected is not None:
            return r.connected
        return is_graph_fully_connected(
            binarize_top_p(_host(affinity), r.p_hat))

    if is_connected(best):
        return best
    for r in sorted(cand_results, key=lambda r: r.p_hat):
        if r.p_hat > best.p_hat and is_connected(r):
            return NmescResult(r.num_speakers, r.p_hat, best.g_p, True)
    start = max(r.p_hat for r in cand_results) + 1
    if _on_device(affinity):
        # two or more connectivity-ladder batches (monotone in p: coarse
        # bracket, then refinement) + one single-candidate stats call
        p_fix = _min_connected_p_device(affinity, start)
        if p_fix is None:
            return best     # nothing connects (degenerate graph)
        packed, P, upper = _candidate_eigs_device(
            affinity, np.asarray([p_fix]), max_num_speakers)
        rs = _results_from_stats(packed.cpu().double().numpy(), P, upper,
                                 np.asarray([p_fix]), N)
        return NmescResult(rs[0].num_speakers, p_fix, best.g_p, True)
    aff_np = _host(affinity)
    for p in range(start, N + 1):
        aff_p = binarize_top_p(aff_np, p)
        if is_graph_fully_connected(aff_p):
            num_spk, _, _ = estimate_num_speakers(aff_p, max_num_speakers)
            return NmescResult(num_spk, p, best.g_p, True)
    return best


def spectral_clustering(aff, n_clusters: int, seed: int = 0) -> np.ndarray:
    """k smallest Laplacian eigenvectors + k-means (NeMo's
    SpectralClustering equivalent). aff: a binarized affinity, numpy
    (host) or torch tensor (device if N >= 64)."""
    N = aff.shape[0]
    if n_clusters <= 1 or N <= 1:
        return np.zeros(N, np.int64)
    if _on_device(aff):
        # k-means is isometry-invariant: eigenvector signs and rotations
        # inside a degenerate subspace are orthogonal column transforms,
        # so the partition matches the host path's
        emb = _laplacian_eigvecs_device(aff, n_clusters)
        return _kmeans_device(emb, n_clusters, seed=seed)
    _, vecs = _safe_eigh(laplacian(_host(aff)))
    return kmeans(vecs[:, :n_clusters], n_clusters,
                  seed=seed).astype(np.int64)


def run_clustering(raw_affinity, max_num_speakers: int = 8,
                   max_rp_threshold: float = 0.06,
                   sparse_search_volume: int = 30) -> np.ndarray:
    """NMESC + spectral clustering -> labels [N] int64.

    A torch affinity with N >= 64 runs the whole chain (candidate search,
    final binarize, spectral eigenvectors, k-means) on its device and only
    the labels come back. The device's final binarize keeps every entry
    tied at the p-th largest of its row (threshold semantics); the host's
    argpartition keeps an arbitrary p-subset — the two differ only on
    exact ties."""
    res = nmesc(raw_affinity, max_num_speakers, max_rp_threshold,
                sparse_search_volume)
    return _labels_for(raw_affinity, res)


def _labels_for(aff, res: NmescResult) -> np.ndarray:
    """The final binarize at p_hat + spectral clustering, on the path the
    affinity's type picks. (The JAX package fuses the device version into
    one compiled program to save dispatches; eagerly there is nothing to
    fuse.)"""
    if _on_device(aff):
        aff_b = _binarize_device(aff, res.p_hat)
    else:
        aff_b = binarize_top_p(_host(aff), res.p_hat)
    return spectral_clustering(aff_b, res.num_speakers)


def nmesc_batch(affs, max_num_speakers: int = 8,
                max_rp_threshold: float = 0.06,
                sparse_search_volume: int = 30) -> List[NmescResult]:
    """nmesc over many sessions: every device session's candidate
    statistics are launched before any is read back, and each group of
    equal shapes comes back in one copy."""
    results: list = [None] * len(affs)
    pend: dict = {}
    for i, aff in enumerate(affs):
        N = aff.shape[0]
        if not _on_device(aff):
            results[i] = nmesc(aff, max_num_speakers, max_rp_threshold,
                               sparse_search_volume)
            continue
        candidates = _candidates(N, max_rp_threshold, sparse_search_volume)
        packed, P, upper = _candidate_eigs_device(aff, candidates,
                                                  max_num_speakers)
        pend.setdefault(tuple(packed.shape), []).append(
            (i, packed, P, upper, candidates, N))
    for items in pend.values():
        stacked = torch.stack([it[1] for it in items]).cpu().double().numpy()
        for row, (i, _, P, upper, candidates, N) in enumerate(items):
            results[i] = _pick_with_repair(
                _results_from_stats(stacked[row], P, upper, candidates, N),
                affs[i], max_num_speakers)
    return results


def run_clustering_batch(affs, max_num_speakers: int = 8,
                         max_rp_threshold: float = 0.06,
                         sparse_search_volume: int = 30) -> List[np.ndarray]:
    """run_clustering over many sessions (batched statistics, then each
    session's final clustering). Returns the label arrays in order."""
    results = nmesc_batch(affs, max_num_speakers, max_rp_threshold,
                          sparse_search_volume)
    return [_labels_for(aff, res) for aff, res in zip(affs, results)]


# ---------------------------------------------------------------------------
# device path (torch, on the affinity's device)
# ---------------------------------------------------------------------------

_PAD_MULT = 256         # N pads to a multiple of this (the JAX package's
#   shape buckets; the padded solves below depend on the pad nodes' values)
_GUARD = 3              # extra Ritz vectors: the edge eigenvalue of the
#   requested block converges worst, so solve k+guard and keep k
_POWER_ITERS = 80
_LADDER_RUNGS = 48


def _n_pad(N: int) -> int:
    return int(np.ceil(N / _PAD_MULT) * _PAD_MULT)


def _start_block(seed: int, n_pad: int, k: int,
                 device: torch.device) -> torch.Tensor:
    """The fixed seeded start block: RandomState(0) for the candidate
    statistics, RandomState(1) for the final eigenvectors."""
    x0 = np.random.RandomState(seed).randn(n_pad, k).astype(np.float32)
    return torch.from_numpy(x0).to(device)


def _pad_sq(aff: torch.Tensor, n_pad: int) -> torch.Tensor:
    N = aff.shape[0]
    return torch.nn.functional.pad(aff.float(), (0, n_pad - N, 0, n_pad - N))


def _filtered_smallest(lap: torch.Tensor, alpha: torch.Tensor,
                       x0: torch.Tensor, inner: int = 4, outer: int = 160):
    """Smallest eigenpairs of a PSD Laplacian via polynomial-filtered
    subspace iteration, batched over leading axes.

    lap [..., N, N]; alpha [...] spectral upper bound (Gershgorin); x0
    [N, k] shared start with invalid rows zeroed. B = I - L/alpha maps the
    wanted near-zero eigenvalues to ~1 and the rest below; `inner`
    B-applications between CholeskyQR2 orthonormalizations amplify the
    wanted subspace, and one small Rayleigh-Ritz eigh at the end resolves
    clustered eigenvalues within it. inner stays 4: with rank-deficient
    affinities the complement columns decay by (1 - lam/alpha)^inner per
    span and must stay above the shifted-Cholesky noise floor.

    Returns (w [..., k] ascending Ritz values, U [..., N, k])."""
    batch = lap.shape[:-2]
    N, k = x0.shape
    a = alpha.reshape(batch + (1, 1))
    eye_n = torch.eye(N, dtype=lap.dtype, device=lap.device)
    bm = eye_n - lap / a
    eye_k = torch.eye(k, dtype=lap.dtype, device=lap.device)
    y = x0.expand(batch + (N, k))

    def chol_orth(y, shift_rel):
        """One shifted-CholeskyQR pass; the shift scales with the largest
        Gram entry so near-collapsed (but real) directions survive. A
        factorization that fails gives NaNs, as jnp.linalg.cholesky
        does."""
        g = y.transpose(-1, -2) @ y
        dmax = torch.amax(g.abs(), dim=(-1, -2), keepdim=True)
        lc, info = torch.linalg.cholesky_ex(g + (shift_rel * dmax + 1e-30)
                                            * eye_k)
        lc = torch.where((info > 0)[..., None, None],
                         torch.full_like(lc, float("nan")), lc)
        return torch.linalg.solve_triangular(
            lc, y.transpose(-1, -2), upper=False).transpose(-1, -2)

    for _ in range(outer):
        for _ in range(inner):
            y = bm @ y
        # CholeskyQR2: pass 1 tames the conditioning, pass 2 restores
        # orthogonality to f32 precision
        y = chol_orth(y, 1e-5)
        y = chol_orth(y, 1e-7)
    h = y.transpose(-1, -2) @ (lap @ y)
    w, v = torch.linalg.eigh(h)                  # ascending
    return w, y @ v


def _reach_all(sym: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """Per-graph connectivity of [P, N, N] symmetric graphs by log-depth
    reachability: square clip(A + I) ceil(log2 N) times (frontier
    expansion needs diameter-many steps, and near-disconnected graphs
    have diameters in the hundreds); the squaring stops early once the
    closure stops changing. 0/1 entries and nonnegative counts keep the
    sign of every product exact in bf16, so the card squares in bf16; the
    CPU, whose bf16 matmuls are slow, in f32."""
    n_pad = sym.shape[-1]
    dt = torch.bfloat16 if sym.device.type == "cuda" else torch.float32
    eye = torch.eye(n_pad, dtype=dt, device=sym.device)
    m = torch.clamp((sym > 0).to(dt) + eye, 0.0, 1.0)
    for _ in range(max(int(np.ceil(np.log2(max(n_pad, 2)))), 1)):
        nxt = torch.clamp(m @ m, 0.0, 1.0)
        if torch.equal(nxt, m):
            break
        m = nxt
    return torch.all((m[:, 0] > 0) | ~real[None], dim=1)


def _top_p_graphs(a: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """[N, N] affinity, [P] p values -> [P, N, N] symmetrized top-p
    graphs with threshold semantics (every entry tied at a row's p-th
    largest is kept)."""
    n_pad = a.shape[0]
    srt = torch.sort(a, dim=1, descending=True).values
    thr = srt[:, torch.clamp(cand - 1, 0, n_pad - 1)].t()      # [P, N]
    x = torch.where(a[None] >= thr[:, :, None], a[None],
                    torch.zeros((), device=a.device))
    return 0.5 * (x + x.transpose(1, 2))


def _candidate_eigs_device(affinity: torch.Tensor, candidates: np.ndarray,
                           max_num_speakers: int):
    """Top-p binarize + symmetrize + Laplacian + eigen-statistics for
    every candidate, batched on the affinity's device.

    The NME statistic needs only the K+1 smallest eigenvalues and the
    largest: the smallest by filtered subspace iteration, the largest by
    power iteration masked to real nodes, and per-candidate connectivity
    (NeMo's getMinimumConnection precheck) by log-depth reachability.
    N pads to a multiple of 256; pad nodes carry no edges and the
    Gershgorin bound on the diagonal, so their eigenvalues sort above
    every real one, and zeroed start rows keep the iteration in the real
    block. (The JAX package also pads the candidates to 30 and the ladder
    to 48 rungs to bound its compile cache; eagerly, each candidate is an
    independent batch row, so the port runs only the real ones.)

    Returns (packed [P, upper + 2] device tensor: lam_small, lam_max,
    connected; P; upper)."""
    dev = affinity.device
    N = affinity.shape[0]
    upper = min(max_num_speakers + 1, N)
    n_pad = _n_pad(N)
    P = len(candidates)
    k_solve = min(upper + _GUARD, max(N // 4, upper))
    cand = torch.as_tensor(np.asarray(candidates, np.int64), device=dev)

    a = _pad_sq(affinity, n_pad)
    real = torch.arange(n_pad, device=dev) < N
    realf = real.float()
    sym = _top_p_graphs(a, cand)
    deg = sym.sum(dim=2)
    alpha = 2.0 * deg.amax(dim=1) + 1e-3                       # [P]
    diag = torch.where(real[None], deg, alpha[:, None])
    eye = torch.eye(n_pad, device=dev)
    lap = -sym + eye[None] * diag[:, :, None]

    x0 = _start_block(0, n_pad, k_solve, dev) * realf[:, None]
    w_small, _ = _filtered_smallest(lap, alpha, x0)
    lam_small = w_small[:, :upper]

    v = (x0[:, 0] * realf).expand(P, n_pad)
    for _ in range(_POWER_ITERS):
        v = torch.einsum("pij,pj->pi", lap, v) * realf[None]
        v = v / torch.clamp_min(torch.linalg.norm(v, dim=1, keepdim=True),
                                1e-30)
    lam_max = torch.einsum("pi,pi->p", v, torch.einsum("pij,pj->pi", lap, v))

    connected = _reach_all(sym, real)
    packed = torch.cat([lam_small, lam_max[:, None],
                        connected[:, None].float()], dim=1)
    return packed, P, upper


def _connectivity_ladder_device(aff: torch.Tensor,
                                ps: np.ndarray) -> np.ndarray:
    """Connectivity of the top-p graph for many p at once."""
    N = aff.shape[0]
    n_pad = _n_pad(N)
    a = _pad_sq(aff, n_pad)
    real = torch.arange(n_pad, device=a.device) < N
    sym = _top_p_graphs(a, torch.as_tensor(np.asarray(ps, np.int64),
                                           device=a.device))
    return _reach_all(sym, real).cpu().numpy()


def _min_connected_p_device(aff: torch.Tensor, start: int,
                            rungs: int = _LADDER_RUNGS) -> Optional[int]:
    """Minimal p >= start whose top-p graph is connected (connectivity is
    monotone in p: coarse bracket, then exact refinement inside it)."""
    N = aff.shape[0]
    if start > N:
        return None
    coarse = np.unique(np.linspace(start, N, num=min(rungs, N - start + 1)
                                   ).astype(int))
    conn = _connectivity_ladder_device(aff, coarse)
    if not conn.any():
        return None
    hi_idx = int(np.argmax(conn))
    hi = int(coarse[hi_idx])
    lo = start if hi_idx == 0 else int(coarse[hi_idx - 1]) + 1
    while True:
        if lo >= hi:
            return hi
        if hi - lo + 1 <= rungs:   # consecutive grid: exact answer
            fine = np.arange(lo, hi + 1, dtype=int)
            conn2 = _connectivity_ladder_device(aff, fine)
            return int(fine[int(np.argmax(conn2))]) if conn2.any() else hi
        fine = np.unique(np.linspace(lo, hi, num=rungs).astype(int))
        conn2 = _connectivity_ladder_device(aff, fine)
        if not conn2.any():
            return hi
        j = int(np.argmax(conn2))
        hi = int(fine[j])
        lo = lo if j == 0 else int(fine[j - 1]) + 1


def _binarize_device(aff: torch.Tensor, p: int) -> torch.Tensor:
    """Top-p row pruning + symmetrize (threshold semantics)."""
    srt = torch.sort(aff, dim=1, descending=True).values
    x = torch.where(aff >= srt[:, p - 1:p], aff,
                    torch.zeros((), device=aff.device))
    return 0.5 * (x + x.t())


def _kmeans_core(x: torch.Tensor, n_real: int, generator: torch.Generator,
                 k: int, n_init: int = 10, n_iter: int = 300) -> torch.Tensor:
    """k-means++ with n_init restarts batched: x [N_pad, D] with rows >=
    n_real invalid; returns labels [N_pad] of the restart with the least
    inertia. Draws come from `generator` (on x's device), so they differ
    from the host path's RandomState and from jax.random: results are
    held by partition, not by label ids. Converged restarts freeze, as
    the host loop breaks."""
    n_pad, D = x.shape
    dev = x.device
    valid = torch.arange(n_pad, device=dev) < n_real
    validf = valid.to(x.dtype)
    rows = torch.arange(n_init, device=dev)

    def d2_to(c):                                    # c [n_init, D]
        return torch.where(valid[None], ((x[None] - c[:, None]) ** 2).sum(-1),
                           torch.zeros((), device=dev))

    i0 = torch.randint(0, n_real, (n_init,), generator=generator, device=dev)
    centers = [x[i0]]
    d2 = d2_to(centers[0])                           # [n_init, N_pad]
    for _ in range(1, k):
        probs = d2 / torch.clamp_min(d2.sum(1, keepdim=True), 1e-12)
        # all-zero rows (every point on a center) draw uniformly
        probs = torch.where(probs.sum(1, keepdim=True) > 0, probs, validf)
        idx = torch.multinomial(probs, 1, generator=generator)[:, 0]
        centers.append(x[idx])
        d2 = torch.minimum(d2, d2_to(centers[-1]))
    c = torch.stack(centers, dim=1)                  # [n_init, k, D]

    done = torch.zeros(n_init, dtype=torch.bool, device=dev)
    for it in range(n_iter):
        dist = ((x[None, :, None] - c[:, None]) ** 2).sum(-1)  # [I, N, k]
        lab = dist.argmin(-1)
        oh = torch.nn.functional.one_hot(lab, k).to(x.dtype) \
            * validf[None, :, None]
        cnt = oh.sum(1)                                        # [I, k]
        newc = oh.transpose(1, 2) @ x / torch.clamp_min(cnt, 1.0)[..., None]
        newc = torch.where(cnt[..., None] > 0, newc, c)
        newc = torch.where(done[:, None, None], c, newc)
        done = done | torch.all(
            (newc - c).abs() <= 1e-8 + 1e-5 * c.abs(), dim=(1, 2))
        c = newc
        if it % 10 == 9 and bool(done.all()):
            break
    dist = ((x[None, :, None] - c[:, None]) ** 2).sum(-1)
    lab = dist.argmin(-1)                                      # [I, N]
    inertia = torch.where(valid[None], dist.gather(2, lab[..., None])[..., 0],
                          torch.zeros((), device=dev)).sum(1)
    return lab[rows[torch.argmin(inertia)]]


def _kmeans_device(x: torch.Tensor, k: int, seed: int = 0) -> np.ndarray:
    """k-means++ restarts on x's device: x [N, D] -> labels [N] int64."""
    N, D = x.shape
    n_pad = _n_pad(N)
    xp = torch.nn.functional.pad(x.float(), (0, 0, 0, n_pad - N))
    g = torch.Generator(device=x.device).manual_seed(seed)
    return _kmeans_core(xp, N, g, k)[:N].cpu().numpy().astype(np.int64)


def _laplacian_eigvecs_device(aff: torch.Tensor, k: int) -> torch.Tensor:
    """k smallest Laplacian eigenvectors of a binarized affinity on its
    device -> [N, k] (pad nodes: no edges, the Gershgorin bound on the
    diagonal, zeroed start rows)."""
    N = aff.shape[0]
    n_pad = _n_pad(N)
    k_solve = min(k + _GUARD, max(N // 4, k))
    a = _pad_sq(aff, n_pad)
    real = torch.arange(n_pad, device=a.device) < N
    deg = a.sum(dim=1)
    alpha = 2.0 * deg.max() + 1e-3
    diag = torch.where(real, deg - torch.diagonal(a), alpha)
    eye = torch.eye(n_pad, device=a.device)
    lap = torch.where(eye > 0, torch.zeros((), device=a.device), -a) \
        + eye * diag[:, None]
    x0 = _start_block(1, n_pad, k_solve, a.device) * real.float()[:, None]
    _, u = _filtered_smallest(lap, alpha, x0)
    return u[:N, :k]
