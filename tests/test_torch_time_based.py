"""notsofar_tpu_torch's time-based diarization (diarization/time_based.py,
the `nmesc` and `nmesc_msdd` methods) against the JAX package, on the
CPU:

* diarize_streams with the numpy SpectralToyEncoder and the energy VAD,
  with and without each recipe and a synthetic MSDD: equal [C, S, T]
  tensors;
* the whole path with a small TitaNet, MarbleNet and MSDD, every weight
  carried across (variables_from_jax): the same word partition, and at
  least 99% of the [C, S, T] frames equal after the best speaker
  permutation;
* the `nmesc_msdd` dispatch through diarization_inference with a given
  MSDD, and its fallback to plain nmesc when no checkpoint is mounted.

The two-stream fixture of tests/test_diarization.py: a 150 Hz and a
2.5 kHz stream of 16 s, 76 alternating 0.18 s words. With TitaNet
embeddings the model path replaces the two pure tones by two seeded
voiced "speakers" (harmonic bursts at different pitch and timbre, pauses,
noise; voiced_streams): every window of a stationary tone embeds alike,
and NMESC's decisions on those near-tied affinities flip under any
perturbation (the JAX package's own embeddings times 1 + 1e-6 noise move
its telephonic-recipe speaker count from 3 to 5), whereas on the voiced
streams they hold under 1e-5.
"""
import itertools

import jax
import numpy as np
import pytest

from notsofar_tpu.diarization import common as jcommon
from notsofar_tpu.diarization import diarization as jdiar
from notsofar_tpu.diarization import time_based as jtb
from notsofar_tpu.diarization.recipes import load_diar_recipe as jrecipe
from notsofar_tpu.models import marblenet as jm
from notsofar_tpu.models import msdd as jmsdd
from notsofar_tpu.models import msdd_convert as jconv
from notsofar_tpu.models import titanet as jt
from notsofar_tpu.utils.audio import read_wav
from notsofar_tpu_torch.diarization import common as tcommon
from notsofar_tpu_torch.diarization import diarization as tdiar
from notsofar_tpu_torch.diarization import time_based as ttb
from notsofar_tpu_torch.diarization.recipes import load_diar_recipe as trecipe
from notsofar_tpu_torch.models import marblenet as tm
from notsofar_tpu_torch.models import msdd as tmsdd
from notsofar_tpu_torch.models import titanet as tt
from tests.test_diarization import SpectralToyEncoder, _segments_df
from tests.test_msdd import _synthetic_nemo_sd
from tests.test_torch_titanet import JCFG, TCFG
from tests.test_torch_whisper import torch_threads  # noqa: F401

SR = 16000


def stream_wavs(tmp_path):
    df = _segments_df(tmp_path)
    return df, [read_wav(str(tmp_path / f"sep_stream{i}.wav"),
                         normalize=True) for i in range(2)]


def msdd_pair(emb_dim: int, n_scales: int = 5):
    """(JAX, port) OverlapDecoders on one synthetic NeMo checkpoint."""
    sd = {k: v.numpy() for k, v in _synthetic_nemo_sd(
        emb_dim=emb_dim, n_scales=n_scales, num_spks=2, hidden=8, n_lstm=2,
        ch=4).items()}
    cfg, tree = jconv.convert_msdd_state_dict(sd)
    tcfg = tmsdd.MSDDConfig(**cfg.__dict__)
    return (jmsdd.OverlapDecoder(cfg, variables=tree),
            tmsdd.OverlapDecoder(tcfg, tmsdd.variables_from_jax(tree),
                                 device="cpu"))


@pytest.mark.parametrize("recipe", [None, "general", "meeting",
                                    "telephonic"])
def test_diarize_streams_toy_encoder_equals_jax(tmp_path, recipe):
    """The numpy toy encoder and the energy VAD (host clustering in both
    packages): the same [C, S, T] tensor, with two speakers found."""
    _, wavs = stream_wavs(tmp_path)
    got = ttb.diarize_streams(wavs, SR, SpectralToyEncoder(),
                              recipe=recipe and trecipe(recipe))
    want = jtb.diarize_streams(wavs, SR, SpectralToyEncoder(),
                               recipe=recipe and jrecipe(recipe))
    assert got.shape == want.shape and got.shape[:2] == (2, 2)
    np.testing.assert_array_equal(got, want)
    assert ttb.LAST_VAD_USED["kind"] == "energy"


@pytest.mark.parametrize("recipe", [None, "telephonic"])
def test_msdd_refinement_equals_jax(tmp_path, recipe):
    """The same with a synthetic MSDD carried across (threshold 0.5): the
    refined tensor equals the JAX package's and differs from the plain
    clustering's. With the recipe the port reuses the clustering's
    embeddings where the JAX package embeds again, so the toy encoder
    runs on fewer windows, for the same result."""
    _, wavs = stream_wavs(tmp_path)
    jdec, tdec = msdd_pair(emb_dim=4)
    counts = {}

    class Counting(SpectralToyEncoder):
        def __init__(self, name):
            self.name = name

        def embed(self, wavs, lengths):
            counts[self.name] = counts.get(self.name, 0) + len(wavs)
            return super().embed(wavs, lengths)

    got = ttb.diarize_streams(wavs, SR, Counting("port"), msdd=tdec,
                              msdd_threshold=0.5,
                              recipe=recipe and trecipe(recipe))
    want = jtb.diarize_streams(wavs, SR, Counting("jax"), msdd=jdec,
                               msdd_threshold=0.5,
                               recipe=recipe and jrecipe(recipe))
    plain = ttb.diarize_streams(wavs, SR, SpectralToyEncoder(),
                                recipe=recipe and trecipe(recipe))
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] == plain.shape[1] == 2
    assert np.abs(got - plain).mean() > 0.01
    if recipe is None:
        assert counts["port"] == counts["jax"]
    else:
        assert counts["port"] * 2 == counts["jax"]


def voiced_streams(tmp_path, seed: int = 0, seconds: float = 16.0):
    """The fixture's words on two seeded voiced streams, written over its
    wavs: bursts of 0.3-1.2 s (pauses of 0.05-0.4 s) of a harmonic stack
    with a 5% vibrato, f0 100-130 Hz and a falling spectrum for stream 0,
    200-260 Hz and a brighter one for stream 1, over faint noise."""
    from notsofar_tpu.utils.audio import write_wav
    df = _segments_df(tmp_path)
    voices = (((100, 130), [1, .6, .5, .2, .1, .05]),
              ((200, 260), [1, .3, .1, .4, .3, .2]))
    wavs = []
    for i, (f0_range, weights) in enumerate(voices):
        rng = np.random.RandomState(seed + 100 * i)
        n = int(seconds * SR)
        t = np.arange(n) / SR
        x = 0.003 * rng.randn(n)
        pos = rng.uniform(0, 0.3)
        while pos < seconds:
            dur = rng.uniform(0.3, 1.2)
            a, b = int(pos * SR), min(int((pos + dur) * SR), n)
            f0 = rng.uniform(*f0_range) * (
                1 + 0.05 * np.sin(2 * np.pi * rng.uniform(2, 5) * t[a:b]))
            ph = 2 * np.pi * np.cumsum(f0) / SR
            seg = sum(w * np.sin(h * ph) for h, w in enumerate(weights, 1))
            x[a:b] += 0.3 * seg * np.hanning(b - a)
            pos += dur + rng.uniform(0.05, 0.4)
        wav = (x / np.abs(x).max() * 0.5).astype(np.float32)
        write_wav(tmp_path / f"sep_stream{i}.wav", wav, SR, max_norm=False)
        wavs.append(read_wav(str(tmp_path / f"sep_stream{i}.wav"),
                             normalize=True))
    return df, wavs


def best_permutation_share(a: np.ndarray, b: np.ndarray) -> float:
    """The share of [C, S, T] entries equal after the best permutation of
    b's speakers."""
    if a.shape != b.shape:
        return 0.0
    return max(float((a == b[:, list(p)]).mean())
               for p in itertools.permutations(range(a.shape[1])))


def word_partition(df):
    words = sorted(((w[1], w[0], r.speaker_id) for _, r in df.iterrows()
                    for w in r.word_timing))
    labels = {}
    return [labels.setdefault(s, len(labels)) for _, _, s in words]


@pytest.fixture(scope="module")
def models():
    """(JAX, port) small TitaNet (the JAX init with key 2, as
    tests/test_torch_diarization.py), MarbleNet (the JAX init, its
    classifier bias set so that speech wins every frame: random weights
    alone would find no speech) and MSDD over the TitaNet's 32-d
    embeddings, every weight carried across, f32 on the CPU."""
    jenc = jt.SpeakerEncoder(JCFG, rng=jax.random.PRNGKey(2))
    tenc = tt.SpeakerEncoder(TCFG, tt.variables_from_jax(
        jax.tree_util.tree_map(np.asarray, jenc.variables)), device="cpu")
    mcfg = jm.MarbleNetConfig(n_mels=80, blocks=(
        jm.BlockSpec(32, 1, 11, 1, False, True),
        jm.BlockSpec(16, 2, 13, 1, True, True),
        jm.BlockSpec(32, 1, 1, 1, False, False)))
    v = jax.tree_util.tree_map(np.array, jm.FrameVAD(mcfg).variables)
    v["params"]["classifier"]["bias"] = np.asarray([-8.0, 8.0], np.float32)
    jvad = jm.FrameVAD(mcfg, variables=v)
    tvad = tm.FrameVAD(tm.MarbleNetConfig(
        n_mels=80, blocks=tuple(tm.BlockSpec(*b) for b in mcfg.blocks)),
        tm.variables_from_jax(v), device="cpu")
    jdec, tdec = msdd_pair(emb_dim=JCFG.emb_dim)
    return (jenc, jvad, jdec), (tenc, tvad, tdec)


def test_models_path_matches_jax(tmp_path, models, capsys):
    """nmesc_msdd's whole path (MarbleNet VAD through the telephonic
    recipe's binarization, TitaNet at 5 scales, host NMESC, the MSDD on
    every speaker pair, the word assignment) in both packages on the
    same weights: the same speaker count and word partition, and >= 99%
    of the [C, S, T] frames equal after the best speaker permutation
    (the share is printed)."""
    (jenc, jvad, jdec), (tenc, tvad, tdec) = models
    df, wavs = voiced_streams(tmp_path)
    jr, tr = jrecipe("telephonic"), trecipe("telephonic")
    want = jtb.diarize_streams(wavs, SR, jenc, msdd=jdec, recipe=jr,
                               vad_fn=jtb.make_recipe_vad(jvad, jr))
    assert jtb.LAST_VAD_USED["kind"] == "marblenet"
    got = ttb.diarize_streams(wavs, SR, tenc, msdd=tdec, recipe=tr,
                              vad_fn=ttb.make_recipe_vad(tvad, tr))
    assert ttb.LAST_VAD_USED["kind"] == "marblenet"
    assert got.shape == want.shape and got.shape[1] >= 2
    share = best_permutation_share(got, want)
    print(f"[C, S, T] frames equal after the best permutation: {share}")
    assert share >= 0.99
    d = df.copy()
    d["wav_file_name"] = d["wav_file_name"].astype("category")
    d["wav_file_name_ind"] = d["wav_file_name"].cat.codes
    assert word_partition(ttb.assign_words_to_speakers(d, got, True)) == \
        word_partition(jtb.assign_words_to_speakers(d, want, True))


def test_nmesc_msdd_dispatch_matches_jax(tmp_path):
    """diarization_inference(method='nmesc_msdd') with a given MSDD and
    the toy encoder: the JAX package's words and speakers; the pickle
    lands under the method's name."""
    df = _segments_df(tmp_path)
    jdec, tdec = msdd_pair(emb_dim=4)
    got = tdiar.diarization_inference(
        str(tmp_path / "t"), df, tcommon.DiarizationCfg(method="nmesc_msdd"),
        False, encoder=SpectralToyEncoder(), msdd=tdec, device="cpu")
    want = jdiar.diarization_inference(
        str(tmp_path / "j"), df, jcommon.DiarizationCfg(method="nmesc_msdd"),
        False, encoder=SpectralToyEncoder(), msdd=jdec)
    assert list(got.columns) == list(want.columns)
    assert word_partition(got) == word_partition(want)
    assert (tmp_path / "t" / "diarization" / "multichannel" /
            "MTG_0001_dev" / "nmesc_msdd" / "all_segments_df.pkl").exists()


def test_nmesc_msdd_falls_back_without_checkpoint(tmp_path, monkeypatch,
                                                  caplog):
    """No MSDD and no MarbleNet under NOTSOFAR_MODELS_DIR: nmesc_msdd
    degrades to plain nmesc with the energy VAD, logged, and gives the
    JAX package's result; so does nmesc."""
    monkeypatch.delenv("NOTSOFAR_MODELS_DIR", raising=False)
    ttb._MSDD_CACHE.clear()
    ttb._VAD_CACHE.clear()
    jtb._MSDD_CACHE.clear()
    jtb._VAD_CACHE.clear()
    df = _segments_df(tmp_path)
    for method in ("nmesc_msdd", "nmesc"):
        with caplog.at_level("INFO"):
            got = tdiar.diarization_inference(
                str(tmp_path / "t"), df, tcommon.DiarizationCfg(method=method),
                False, encoder=SpectralToyEncoder(), device="cpu")
        assert ttb.LAST_VAD_USED["kind"] == "energy"
        want = jdiar.diarization_inference(
            str(tmp_path / "j"), df, jcommon.DiarizationCfg(method=method),
            False, encoder=SpectralToyEncoder())
        assert "speaker_id" in got.columns and len(got) > 0
        assert word_partition(got) == word_partition(want)
    assert "not mounted" in caplog.text and "NOT mounted" in caplog.text
    assert ttb._MSDD_CACHE == {("diar_msdd_telephonic", "cpu"): None}
    ttb._MSDD_CACHE.clear()
    ttb._VAD_CACHE.clear()
