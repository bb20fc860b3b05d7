"""notsofar_tpu_torch's NMESC / spectral clustering against the JAX
package, on the CPU.

The float64 host path (numpy affinities) is the JAX package's math
copied, so it must agree exactly. The device path (torch tensors with
N >= 64, here CPU tensors) is f32 batched iteration; it is held to the
host path by its decisions — p_hat, speaker count, and the partition up
to label permutation — on the JAX package's parity case and its
adversarial cases (tests/test_diarization.py).
"""
import numpy as np
import pytest
import torch

from notsofar_tpu.diarization import clustering as jc
from notsofar_tpu_torch.diarization import clustering as tc
from tests.test_diarization import agree, synth_embeddings


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: the device path is
    thousands of small batched ops, which intra-op threads only slow down
    when several pytest workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_host_path_equals_jax_exactly():
    """cos_affinity_matrix, binarize_top_p, nmesc, spectral_clustering,
    kmeans and run_clustering on numpy inputs: identical results (the
    same float64 code), on the cases of tests/test_diarization.py:37-98."""
    rng = np.random.RandomState(0)
    emb = rng.randn(20, 8)
    np.testing.assert_array_equal(tc.cos_affinity_matrix(emb),
                                  jc.cos_affinity_matrix(emb))

    rng = np.random.RandomState(1)
    emb, _ = synth_embeddings(rng, 40, [np.eye(8)[i] for i in range(3)])
    aff = jc.cos_affinity_matrix(emb)
    mine, theirs = tc.nmesc(aff), jc.nmesc(aff)
    assert (mine.num_speakers, mine.p_hat, mine.g_p) == \
        (theirs.num_speakers, theirs.p_hat, theirs.g_p)
    assert mine.num_speakers == 3
    np.testing.assert_array_equal(tc.binarize_top_p(aff, 7),
                                  jc.binarize_top_p(aff, 7))

    rng = np.random.RandomState(2)
    emb, truth = synth_embeddings(rng, 30, [np.eye(8)[i] for i in range(4)])
    aff = jc.cos_affinity_matrix(emb)
    labels = tc.run_clustering(aff)
    np.testing.assert_array_equal(labels, jc.run_clustering(aff))
    assert agree(labels, truth) > 0.95

    rng = np.random.RandomState(3)
    emb, truth = synth_embeddings(rng, 25, [np.array([1.0, 0.0]),
                                            np.array([0.0, 1.0])])
    aff_b = jc.binarize_top_p(jc.cos_affinity_matrix(emb), 5)
    labels = tc.spectral_clustering(aff_b, 2)
    np.testing.assert_array_equal(labels, jc.spectral_clustering(aff_b, 2))
    assert agree(labels, truth) == 1.0

    rng = np.random.RandomState(4)
    x = np.concatenate([rng.randn(30, 2) * 0.1, rng.randn(30, 2) * 0.1 + 5])
    np.testing.assert_array_equal(tc.kmeans(x, 2, seed=0),
                                  jc.kmeans(x, 2, seed=0))


def _four_speakers():
    rng = np.random.RandomState(7)
    spk = rng.randn(4, 64)
    return spk[rng.randint(4, size=150)] + 0.4 * rng.randn(150, 64)


def _near_tie():
    rng = np.random.RandomState(11)
    base = rng.randn(64)
    base /= np.linalg.norm(base)
    centers = []
    for _ in range(3):
        t = rng.randn(64)
        t -= t @ base * base
        t /= np.linalg.norm(t)
        centers.append(base + 0.28 * t)    # pairwise cos ~ 0.93
    return synth_embeddings(rng, 60, centers, noise=0.04)[0]


def _rank_deficient():
    rng = np.random.RandomState(12)
    reps = np.repeat(rng.randn(2, 32), 45, axis=0)
    return reps + 1e-4 * rng.randn(*reps.shape)


def _bucket_edge(n):
    rng = np.random.RandomState(13 + n)
    centers = [np.eye(16)[i] for i in range(4)]
    per = n // 4
    emb, _ = synth_embeddings(rng, per, centers, noise=0.08)
    extra = n - per * 4
    if extra:
        emb = np.concatenate(
            [emb, centers[0][None] + 0.08 * rng.randn(extra, 16)])
    return emb


def _unbalanced():
    rng = np.random.RandomState(14)
    c = [np.eye(24)[0], np.eye(24)[1]]
    return np.concatenate([c[0][None] + 0.06 * rng.randn(200, 24),
                           c[1][None] + 0.06 * rng.randn(5, 24)])


def _near_disconnected_affinity():
    rng = np.random.RandomState(15)
    emb, _ = synth_embeddings(rng, 80, [np.eye(48)[i] for i in range(2)],
                              noise=0.02)
    aff = jc.cos_affinity_matrix(emb)
    aff[:80, 80:] *= 0.02
    aff[80:, :80] *= 0.02
    aff[79, 80] = aff[80, 79] = 0.6
    np.fill_diagonal(aff, 1.0)
    return aff


CASES = {
    "four_speakers": lambda: jc.cos_affinity_matrix(_four_speakers()),
    "near_tie": lambda: jc.cos_affinity_matrix(_near_tie()),
    "rank_deficient": lambda: jc.cos_affinity_matrix(_rank_deficient()),
    "edge_254": lambda: jc.cos_affinity_matrix(_bucket_edge(254)),
    "edge_256": lambda: jc.cos_affinity_matrix(_bucket_edge(256)),
    "edge_258": lambda: jc.cos_affinity_matrix(_bucket_edge(258)),
    "unbalanced": lambda: jc.cos_affinity_matrix(_unbalanced()),
    "near_disconnected": _near_disconnected_affinity,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_path_decisions_equal_host(case, monkeypatch):
    """The device path on a torch f32 tensor against the float64 host
    path: p_hat and speaker count equal, g_p within 2e-2 relative (f32
    iterative eigen-statistics; measured 2e-6 to 1.6e-2 here),
    labels equal up to permutation. The host path here equals the JAX
    package's.

    rank_deficient: every candidate graph is disconnected, so the
    repaired result carries the g_p of the disconnected argmin, whose
    eigengaps are degenerate; the two paths read it differently (host
    0.90, device 0.011). There the port's device g_p is held to the JAX
    package's device path instead (1e-4 relative; measured 5e-7)."""
    aff = CASES[case]()
    host = tc.nmesc(aff)
    jhost = jc.nmesc(aff)
    assert (host.num_speakers, host.p_hat) == (jhost.num_speakers,
                                               jhost.p_hat)
    host_labels = tc.run_clustering(aff)

    ta = torch.tensor(aff, dtype=torch.float32)
    dev = tc.nmesc(ta)
    assert dev.connected is not None       # flags come with the statistics
    assert dev.num_speakers == host.num_speakers
    assert dev.p_hat == host.p_hat
    ref = host.g_p
    if case == "rank_deficient":
        import jax.numpy as jnp
        monkeypatch.setattr(jc, "_accelerator_available", lambda: True)
        ref = jc.nmesc(jnp.asarray(aff, jnp.float32)).g_p
        assert abs(dev.g_p - ref) <= 1e-4 * abs(ref)
    assert abs(dev.g_p - ref) <= 2e-2 * max(abs(ref), 1.0)
    dev_labels = tc._labels_for(ta, dev)
    assert dev_labels.dtype == np.int64 and dev_labels.shape == (len(aff),)
    assert agree(dev_labels, host_labels) == 1.0


def test_run_clustering_batch_matches_single():
    """run_clustering_batch over a mixed batch (two device tensors of
    different N, one numpy affinity) equals per-session run_clustering
    by partition; a tensor with N < 64 takes the host path exactly."""
    rng = np.random.RandomState(9)
    affs = []
    for n, k in ((120, 3), (136, 4)):
        spk = rng.randn(k, 48)
        emb = spk[rng.randint(k, size=n)] + 0.4 * rng.randn(n, 48)
        affs.append(torch.tensor(jc.cos_affinity_matrix(emb),
                                 dtype=torch.float32))
    affs.insert(1, jc.cos_affinity_matrix(_bucket_edge(40)))
    batched = tc.run_clustering_batch(affs)
    for a, b in zip(affs, batched):
        assert agree(tc.run_clustering(a), b) == 1.0
    small = torch.tensor(affs[1], dtype=torch.float32)
    np.testing.assert_array_equal(
        tc.run_clustering(small),
        jc.run_clustering(small.double().numpy()))


def test_device_spectral_clustering_matches_host():
    """spectral_clustering on a binarized device tensor (filtered
    subspace eigenvectors + batched k-means++ from a torch.Generator)
    gives the host partition."""
    aff = jc.cos_affinity_matrix(_four_speakers())
    host = tc.nmesc(aff)
    aff_b = jc.binarize_top_p(aff, host.p_hat)
    want = tc.spectral_clustering(aff_b, host.num_speakers)
    got = tc.spectral_clustering(torch.tensor(aff_b, dtype=torch.float32),
                                 host.num_speakers)
    assert agree(got, want) == 1.0
