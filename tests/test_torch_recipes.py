"""notsofar_tpu_torch's diarization recipes (diarization/recipes.py, a
copy of the JAX package's) and the recipe paths of its time-based
diarizer, on the CPU: the cases of tests/test_recipes.py on the port's
modules, and the binarizer equal to the JAX package's on seeded
probabilities under each shipped recipe."""
from dataclasses import asdict

import numpy as np
import pytest

from notsofar_tpu.diarization import recipes as jrec
from notsofar_tpu_torch.diarization import time_based as ttb
from notsofar_tpu_torch.diarization.recipes import (DiarRecipe, VadParams,
                                                    binarize_vad_probs,
                                                    load_diar_recipe,
                                                    resolve_recipe)


def test_recipe_yamls_load():
    for name, n_scales in [("general", 3), ("meeting", 6), ("telephonic", 5)]:
        r = load_diar_recipe(name)
        assert r.name == name
        assert asdict(r) == asdict(jrec.load_diar_recipe(name))
        se = r.speaker_embeddings
        assert len(se.window_length_in_sec) == n_scales
        assert len(se.shift_length_in_sec) == n_scales
        assert len(se.multiscale_weights) == n_scales
        for w, h in zip(se.window_length_in_sec, se.shift_length_in_sec):
            assert h == pytest.approx(w / 2)
        assert r.clustering.max_num_speakers == 8


def test_method_default_recipes_match_reference_choices():
    assert resolve_recipe("nmesc").name == "meeting"
    assert resolve_recipe("nmesc_msdd").name == "telephonic"
    assert resolve_recipe("nmesc", "telephonic").name == "telephonic"
    assert resolve_recipe("something_else").name == "general"


def test_telephonic_scales_match_msdd_constants():
    r = load_diar_recipe("telephonic")
    assert r.speaker_embeddings.window_length_in_sec == ttb.MSDD_SCALES
    assert r.speaker_embeddings.shift_length_in_sec == ttb.MSDD_HOPS


def test_binarize_hysteresis():
    p = VadParams(onset=0.8, offset=0.4, pad_onset=0, pad_offset=0,
                  min_duration_on=0, min_duration_off=0, smoothing="")
    probs = np.array([0.5, 0.9, 0.6, 0.5, 0.3, 0.6, 0.9, 0.2])
    assert binarize_vad_probs(probs, p).tolist() == [
        False, True, True, True, False, False, True, False]


def test_binarize_padding_and_min_durations():
    p = VadParams(onset=0.5, offset=0.5, pad_onset=0.02, pad_offset=0.02,
                  min_duration_on=0.05, min_duration_off=0, smoothing="")
    probs = np.zeros(40)
    probs[10:12] = 1.0
    probs[30] = 1.0
    mask = binarize_vad_probs(probs, p)
    assert mask[8:14].all() and not mask[:8].any() and not mask[14:28].any()
    assert mask[28:33].all()
    p2 = VadParams(onset=0.5, offset=0.5, pad_onset=0, pad_offset=0,
                   min_duration_on=0.05, min_duration_off=0, smoothing="")
    assert not binarize_vad_probs(probs, p2).any()


def test_binarize_gap_filling():
    p = VadParams(onset=0.5, offset=0.5, pad_onset=0, pad_offset=0,
                  min_duration_on=0, min_duration_off=0.05, smoothing="")
    probs = np.zeros(40)
    probs[5:10] = 1.0
    probs[13:20] = 1.0
    probs[30:35] = 1.0
    mask = binarize_vad_probs(probs, p)
    assert mask[5:20].all()
    assert not mask[20:30].any()
    assert mask[30:35].all()
    assert not mask[:5].any() and not mask[35:].any()


def test_binarize_median_smoothing_kills_spikes():
    p = VadParams(onset=0.5, offset=0.5, pad_onset=0, pad_offset=0,
                  min_duration_on=0, min_duration_off=0,
                  smoothing="median", window_length_in_sec=0.15, overlap=0.5)
    probs = np.zeros(50)
    probs[25] = 1.0
    assert not binarize_vad_probs(probs, p).any()
    probs[20:35] = 1.0
    assert binarize_vad_probs(probs, p)[22:33].all()


@pytest.mark.parametrize("name", ["general", "meeting", "telephonic"])
def test_binarize_equals_jax(name):
    """Seeded smooth probabilities (islands, gaps, spikes) through both
    packages' binarizers under each shipped recipe's VAD parameters: the
    same mask."""
    rng = np.random.RandomState(len(name))
    talk = np.where(np.sin(np.arange(3000) / 150.0) > 0, 1.0, 0.1)
    probs = np.clip(np.convolve(rng.rand(3000), np.ones(25) / 25,
                                mode="same") * 1.6 * talk - 0.3
                    + (rng.rand(3000) > 0.98) * 0.5, 0, 1)
    got = binarize_vad_probs(probs, load_diar_recipe(name).vad)
    want = jrec.binarize_vad_probs(probs, jrec.load_diar_recipe(name).vad)
    assert 0 < got.sum() < len(got)
    np.testing.assert_array_equal(got, want)


def test_diarize_streams_with_recipe():
    """Multiscale recipe clustering gives a [C, S, T] tensor from two
    alternating synthetic speakers, with the energy VAD reported."""
    class ToyEncoder:
        def embed(self, wavs, lengths):
            out = np.zeros((len(wavs), 4), np.float32)
            for i, (w, n) in enumerate(zip(wavs, lengths)):
                seg = w[:n]
                sign = np.sign(seg[np.abs(seg) > 1e-6])
                frac_pos = (sign > 0).mean() if len(sign) else 0.5
                out[i] = [1.0, frac_pos, 1 - frac_pos, 0.1]
            return out

    sr = 16000
    rng = np.random.RandomState(0)
    a = np.abs(rng.randn(4 * sr)) * 0.5
    b = -np.abs(rng.randn(4 * sr)) * 0.5
    wav = np.concatenate([a, b, a, b]).astype(np.float32)
    out = ttb.diarize_streams([wav], sr, ToyEncoder(),
                              recipe=load_diar_recipe("general"))
    assert out.ndim == 3 and out.shape[0] == 1 and out.shape[1] >= 1
    assert ttb.LAST_VAD_USED["kind"] == "energy"


def test_recipe_vad_wrapper_marks_kind():
    class FakeFrameVAD:
        def frame_probs(self, wavs, lengths):
            return np.ones((len(wavs), lengths[0] // 160 + 1), np.float32)

    vad = ttb.make_recipe_vad(FakeFrameVAD(), DiarRecipe())
    assert vad.vad_kind == "marblenet"
    mask = vad(np.zeros(16000, np.float32), 16000)
    assert mask.shape == (100,) and mask.all()
