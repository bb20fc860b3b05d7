"""notsofar_tpu_torch's diarization entry points against the JAX package,
on the CPU: word_nmesc end to end (a toy encoder, then a small TitaNet on
shared weights), the cross-session batch, the dispatch modes, the pickle
cache, and the copied dataframe and wav helpers.

The two-stream fixture of tests/test_diarization.py (a 150 Hz stream and
a 2.5 kHz stream, 76 alternating 0.18 s words) has N = 76 >= 64 words,
so a TitaNet's tensor embeddings take the device clustering path (on CPU
tensors here), while the toy encoder's numpy embeddings take the host
path.
"""
import numpy as np
import pandas as pd
import pytest
import torch

from notsofar_tpu.diarization import common as jcommon
from notsofar_tpu.diarization import diarization as jdiar
from notsofar_tpu.models import titanet as jt
from notsofar_tpu.utils import audio as jaudio
from notsofar_tpu_torch.diarization import common as tcommon
from notsofar_tpu_torch.diarization import diarization as tdiar
from notsofar_tpu_torch.diarization import word_based as twb
from notsofar_tpu_torch.models import titanet as tt
from notsofar_tpu_torch.utils import audio as taudio
from tests.test_diarization import SpectralToyEncoder, _segments_df
from tests.test_torch_titanet import JCFG, TCFG
from tests.test_torch_whisper import torch_threads  # noqa: F401

WORD_CFG = dict(method="word_nmesc", min_embedding_windows=[1.0, 0.5],
                apply_deduplication=False)


def word_labels(df: pd.DataFrame):
    """[(word, start, channel, speaker)] in time order."""
    out = []
    for _, r in df.iterrows():
        for w in r.word_timing:
            out.append((w[0], w[1], r.wav_file_name, r.speaker_id))
    return sorted(out, key=lambda x: x[1])


def same_partition(a: pd.DataFrame, b: pd.DataFrame) -> bool:
    wa, wb = word_labels(a), word_labels(b)
    if [x[:3] for x in wa] != [x[:3] for x in wb]:
        return False
    pairs = set((x[3], y[3]) for x, y in zip(wa, wb))
    return len(pairs) == len({x[3] for x in wa}) == len({y[3] for y in wb})


@pytest.fixture(scope="module")
def encoders():
    """(JAX, port) small TitaNets in f32 on the JAX init's weights.

    Init weights, not a synthetic NeMo checkpoint: the latter's random
    biases and BN statistics map every window to nearly one embedding
    (cosines within 1e-4 of each other), where the min-max scaled
    affinity amplifies f32 rounding to ~3e-3 and NMESC's decisions flip
    between any two precisions — in the JAX package's own host and
    device paths too. Init weights spread the cosines over [0.96, 1].
    The fixture's stationary tones still give near-tied affinities, and
    the device path's top-p threshold keeps every tie where the host's
    argpartition keeps p entries: for 3 of the inits 0-7 the JAX
    package's own host and device paths part there. Init 2 is one where
    they agree, so the test holds the port's device path to the JAX
    host path."""
    import jax
    jenc = jt.SpeakerEncoder(JCFG, rng=jax.random.PRNGKey(2))
    tenc = tt.SpeakerEncoder(
        TCFG, tt.variables_from_jax(jax.tree_util.tree_map(
            np.asarray, jenc.variables)), device="cpu")
    return jenc, tenc


def test_word_nmesc_toy_encoder_matches_jax(tmp_path):
    """The toy encoder (numpy embeddings -> host clustering) through both
    packages: the same words, and the same partition, one label per
    stream; the pickle lands where the JAX package puts it and reads
    back."""
    df = _segments_df(tmp_path)
    cfg_t = tcommon.DiarizationCfg(**WORD_CFG)
    cfg_j = jcommon.DiarizationCfg(**WORD_CFG)
    got = tdiar.diarization_inference(str(tmp_path / "t"), df, cfg_t, False,
                                      encoder=SpectralToyEncoder())
    want = jdiar.diarization_inference(str(tmp_path / "j"), df, cfg_j,
                                       False, encoder=SpectralToyEncoder())
    assert list(got.columns) == list(want.columns)
    assert same_partition(got, want)
    by_stream = got.groupby("wav_file_name").speaker_id.nunique()
    assert (by_stream == 1).all() and got.speaker_id.nunique() == 2
    pkl = tmp_path / "t" / "diarization" / "multichannel" / \
        "MTG_0001_dev" / "word_nmesc" / "all_segments_df.pkl"
    assert pkl.exists()
    cached = tdiar.diarization_inference(str(tmp_path / "t"), df, cfg_t,
                                         True, encoder=None)
    pd.testing.assert_frame_equal(cached, got)


def test_word_nmesc_titanet_matches_jax(tmp_path, encoders):
    """A small TitaNet on shared weights (f32): the port (tensor
    embeddings, device clustering on CPU tensors) and the JAX package
    (host clustering on the CPU) give the same speaker count and
    partition. With deduplication on, as shipped."""
    jenc, tenc = encoders
    df = _segments_df(tmp_path)
    cfg = dict(WORD_CFG, apply_deduplication=True)
    got = tdiar.diarization_inference(
        str(tmp_path / "t"), df, tcommon.DiarizationCfg(**cfg), False,
        encoder=tenc)
    want = jdiar.diarization_inference(
        str(tmp_path / "j"), df, jcommon.DiarizationCfg(**cfg), False,
        encoder=jenc)
    assert got.speaker_id.nunique() == want.speaker_id.nunique() == 2
    assert same_partition(got, want)


def test_batch_prepass_matches_serial_calls(tmp_path, encoders):
    """word_based_clustering_batch (one shared embedding pass over two
    sessions, through diarization_batch_prepass) equals per-session
    word_based_clustering: same words and partition; then the per-session
    diarization_inference calls read the prepass's pickles. The stage
    timer sees every stage."""
    _, tenc = encoders
    cfg = tcommon.DiarizationCfg(**WORD_CFG)
    dfs = []
    for i in range(2):
        d = tmp_path / f"s{i}"
        d.mkdir()
        df = _segments_df(d)
        df["session_id"] = f"session_{i}"
        dfs.append(df)
    timer = twb.StageTimer()
    tdiar.diarization_batch_prepass(str(tmp_path / "out"), dfs, cfg, False,
                                    encoder=tenc, timer=timer)
    assert {"read_wav", "embed", "affinity", "clustering", "df"} <= \
        set(timer.stage_seconds)
    for df in dfs:
        cached = tdiar.diarization_inference(str(tmp_path / "out"), df, cfg,
                                             True, encoder=None)
        serial = tdiar.diarization_inference(str(tmp_path / "serial"), df,
                                             cfg, False, encoder=tenc)
        assert same_partition(cached, serial)


def test_dispatch_modes_match_jax(tmp_path):
    """skip and by_wav_file_name give the JAX package's frames; the
    time-based methods raise NotImplementedError naming their slice; an
    unknown method raises ValueError; word_nmesc without an encoder and
    without a card raises instead of running on the CPU."""
    df = _segments_df(tmp_path)
    for method in ("skip", "by_wav_file_name"):
        got = tdiar.diarization_inference(
            str(tmp_path), df, tcommon.DiarizationCfg(method=method), False)
        want = jdiar.diarization_inference(
            str(tmp_path), df, jcommon.DiarizationCfg(method=method), False)
        pd.testing.assert_frame_equal(got, want)
    for method in ("nmesc", "nmesc_msdd"):
        with pytest.raises(NotImplementedError, match="A.11"):
            tdiar.diarization_inference(
                str(tmp_path), df, tcommon.DiarizationCfg(method=method),
                False)
    with pytest.raises(ValueError):
        tdiar.diarization_inference(
            str(tmp_path), df, tcommon.DiarizationCfg(method="bogus"), False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdiar.diarization_inference(
                str(tmp_path), df, tcommon.DiarizationCfg(**WORD_CFG), False)


def test_resolve_speaker_encoder_random_titanet_large(monkeypatch, caplog):
    """No checkpoint under NOTSOFAR_MODELS_DIR: TitaNet-large at full width
    with seeded random weights, in the config's dtype (bf16 by default),
    logged as random, cached per (name, dtype, device)."""
    monkeypatch.delenv("NOTSOFAR_MODELS_DIR", raising=False)
    twb._ENCODER_CACHE.clear()
    cfg = tcommon.DiarizationCfg(method="word_nmesc")
    with caplog.at_level("WARNING"):
        enc = twb.resolve_speaker_encoder(cfg, device="cpu")
    assert "RANDOM weights" in caplog.text
    assert enc is twb.resolve_speaker_encoder(cfg, device="cpu")
    assert enc.cfg == tt.TitaNetConfig() and enc.module.dtype == \
        torch.bfloat16
    assert enc.module.block_2.conv_0.dw.weight.shape == (15, 1024)
    twb._ENCODER_CACHE.clear()


def test_dataframe_helpers_match_jax():
    """merge, dedup and overlap ratio: the copies give the JAX package's
    results on words with speaker and channel changes, duplicates across
    streams and zero-duration words."""
    words = [["x", 0.0, 1.0, 0, "spk0"], ["hello", 1.0, 2.0, 0, "spk0"],
             ["hello", 1.1, 2.1, 1, "spk0"], ["world", 2.5, 3.0, 1, "spk0"],
             ["a", 3.0, 3.0, 1, "spk1"], ["a", 3.0, 3.0, 0, "spk1"],
             ["b", 3.2, 3.6, 0, "spk1"], ["c", 3.6, 4.0, 2, "spk1"]]
    assert tcommon.merge_words_to_segments_by_spk_change(words) == \
        jcommon.merge_words_to_segments_by_spk_change(words)
    assert tcommon.deduplicate(words) == jcommon.deduplicate(words)
    for a, b in zip(words, words[1:]):
        assert tcommon.compute_overlap_ratio(*a[1:3], *b[1:3]) == \
            jcommon.compute_overlap_ratio(*a[1:3], *b[1:3])
    seg = pd.DataFrame(dict(
        meeting_id=["m"], session_id=["s"],
        wav_file_name=pd.Categorical(["w0"], categories=["w0", "w1", "w2"])))
    for dedup in (False, True):
        pd.testing.assert_frame_equal(
            tcommon.prepare_diarized_data_frame(words, seg, dedup),
            jcommon.prepare_diarized_data_frame(words, seg, dedup))


def test_wav_helpers_match_jax(tmp_path):
    """write_wav / read_wav copies: float32 files written by either
    package read back equal in both; int16 PCM normalizes by 32767."""
    rng = np.random.RandomState(0)
    x = (rng.randn(800) * 0.3).astype(np.float32)
    taudio.write_wav(tmp_path / "a" / "t.wav", x, 16000)
    jaudio.write_wav(tmp_path / "j.wav", x, 16000)
    for f in (tmp_path / "a" / "t.wav", tmp_path / "j.wav"):
        sr, got = taudio.read_wav(str(f), return_rate=True)
        assert sr == 16000
        np.testing.assert_array_equal(got, jaudio.read_wav(str(f)))
    import scipy.io.wavfile as wf
    pcm = (rng.randn(2, 400) * 3000).astype(np.int16)
    wf.write(tmp_path / "mc.wav", 16000, pcm.T)
    got = taudio.read_wav(str(tmp_path / "mc.wav"))
    assert got.shape == (2, 400)
    np.testing.assert_array_equal(got,
                                  jaudio.read_wav(str(tmp_path / "mc.wav")))
