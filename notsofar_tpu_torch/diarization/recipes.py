"""Diarization recipe configs (native NeMo-yaml equivalent).

Copy of notsofar_tpu/diarization/recipes.py (numpy only); the recipes are
read from the repo's configs/inference/diarization/*.yaml.

The reference's time-based diarization loads one of three NeMo recipe yamls
(`configs/inference/diarization/nemo/diar_infer_{general,meeting,telephonic}
.yaml`, chosen in the reference's diarization/time_based_diarization.py:51-66:
`nmesc` -> meeting, `nmesc_msdd` -> telephonic) and mutates the model paths.
This module is the native counterpart: the same parameter surface as
typed dataclasses, loaded from `configs/inference/diarization/*.yaml`, and a
NeMo-parity VAD binarizer (onset/offset hysteresis + padding + min-duration
filtering) that turns frame speech probabilities into a boolean mask.
"""
from dataclasses import dataclass, field
from pathlib import Path
from typing import List

import numpy as np

from notsofar_tpu_torch.utils.conf import load_yaml_to_dataclass


@dataclass
class VadParams:
    """NeMo vad.parameters (diar_infer_*.yaml `vad:` block)."""
    window_length_in_sec: float = 0.63
    shift_length_in_sec: float = 0.08
    smoothing: str = ""           # "" = off, "median" = median filter
    overlap: float = 0.5          # overlap ratio of the smoothing filter
    onset: float = 0.5            # hysteresis: prob to OPEN a speech region
    offset: float = 0.3           # hysteresis: prob to CLOSE a speech region
    pad_onset: float = 0.2        # seconds prepended to each speech segment
    pad_offset: float = 0.2       # seconds appended to each speech segment
    min_duration_on: float = 0.5  # drop speech segments shorter than this
    min_duration_off: float = 0.5  # fill non-speech gaps shorter than this
    filter_speech_first: bool = True


@dataclass
class EmbeddingScales:
    """NeMo speaker_embeddings.parameters — the multiscale ladder."""
    window_length_in_sec: List[float] = field(
        default_factory=lambda: [1.9, 1.2, 0.5])
    shift_length_in_sec: List[float] = field(
        default_factory=lambda: [0.95, 0.6, 0.25])
    multiscale_weights: List[float] = field(
        default_factory=lambda: [1.0, 1.0, 1.0])


@dataclass
class ClusteringParams:
    """NeMo clustering.parameters."""
    oracle_num_speakers: bool = False
    max_num_speakers: int = 8
    enhanced_count_thres: int = 80
    max_rp_threshold: float = 0.25
    sparse_search_volume: int = 30
    maj_vote_spk_count: bool = False


@dataclass
class MsddParams:
    """NeMo msdd_model.parameters."""
    sigmoid_threshold: List[float] = field(default_factory=lambda: [0.7])
    infer_batch_size: int = 25
    split_infer: bool = True
    diar_window_length: int = 50
    overlap_infer_spk_limit: int = 5


@dataclass
class DiarRecipe:
    """One diarization recipe = the `diarizer:` subtree the native pipeline
    consumes. Model paths live on DiarizationCfg (as in the reference, which
    overwrites them from cfg at time_based_diarization.py:57-72)."""
    name: str = "general"
    vad: VadParams = field(default_factory=VadParams)
    speaker_embeddings: EmbeddingScales = field(default_factory=EmbeddingScales)
    clustering: ClusteringParams = field(default_factory=ClusteringParams)
    msdd: MsddParams = field(default_factory=MsddParams)


_RECIPE_DIR = Path(__file__).resolve().parents[2] / "configs" / "inference" \
    / "diarization"

# method -> recipe, matching the reference's hardcoded picks
# (time_based_diarization.py:53 meeting for nmesc, :65 telephonic for msdd)
DEFAULT_RECIPE_FOR_METHOD = {"nmesc": "meeting", "nmesc_msdd": "telephonic"}


def load_diar_recipe(name_or_path: str) -> DiarRecipe:
    """Load a recipe by name (configs/inference/diarization/<name>.yaml)
    or by explicit yaml path."""
    p = Path(name_or_path)
    if not p.is_file():
        p = _RECIPE_DIR / f"{name_or_path}.yaml"
    return load_yaml_to_dataclass(p, DiarRecipe)


def resolve_recipe(method: str, recipe_name: str = "") -> DiarRecipe:
    """Recipe for a diarization method; explicit recipe_name wins."""
    name = recipe_name or DEFAULT_RECIPE_FOR_METHOD.get(method, "general")
    return load_diar_recipe(name)


def binarize_vad_probs(probs: np.ndarray, params: VadParams,
                       frame_sec: float = 0.01) -> np.ndarray:
    """NeMo-parity binarization of frame speech probabilities.

    Implements the published NeMo `binarization`+`filtering` postprocessing
    consumed by the reference recipes (diar_infer_*.yaml `vad.parameters`):
    optional median smoothing, onset/offset hysteresis thresholding,
    onset/offset padding, then (order set by filter_speech_first) removal of
    short speech islands (< min_duration_on) and filling of short gaps
    (< min_duration_off). Pure NumPy on 10 ms frames.
    """
    probs = np.asarray(probs, np.float32)
    if params.smoothing == "median":
        k = max(1, int(round(params.window_length_in_sec * params.overlap
                             / frame_sec)) | 1)
        if k > 1:
            pad = k // 2
            padded = np.pad(probs, (pad, pad), mode="edge")
            win = np.lib.stride_tricks.sliding_window_view(padded, k)
            probs = np.median(win, axis=1)

    # onset/offset hysteresis: open at >= onset, close at < offset
    n = len(probs)
    speech = np.zeros(n, bool)
    active = False
    for i in range(n):
        if not active and probs[i] >= params.onset:
            active = True
        elif active and probs[i] < params.offset:
            active = False
        speech[i] = active

    def _runs(mask: np.ndarray):
        """(start, end) frame pairs of True runs."""
        if not mask.any():
            return []
        d = np.diff(mask.astype(np.int8))
        starts = list(np.nonzero(d == 1)[0] + 1)
        ends = list(np.nonzero(d == -1)[0] + 1)
        if mask[0]:
            starts.insert(0, 0)
        if mask[-1]:
            ends.append(len(mask))
        return list(zip(starts, ends))

    pad_on = int(round(params.pad_onset / frame_sec))
    pad_off = int(round(params.pad_offset / frame_sec))
    padded_mask = np.zeros(n, bool)
    for s, e in _runs(speech):
        padded_mask[max(0, s - pad_on):min(n, e + pad_off)] = True
    speech = padded_mask

    min_on = int(round(params.min_duration_on / frame_sec))
    min_off = int(round(params.min_duration_off / frame_sec))

    def drop_short_speech(mask):
        out = mask.copy()
        for s, e in _runs(mask):
            if e - s < min_on:
                out[s:e] = False
        return out

    def fill_short_gaps(mask):
        out = mask.copy()
        for s, e in _runs(~mask):
            if s == 0 or e == len(mask):
                continue  # leading/trailing silence is never filled
            if e - s < min_off:
                out[s:e] = True
        return out

    if params.filter_speech_first:
        speech = fill_short_gaps(drop_short_speech(speech))
    else:
        speech = drop_short_speech(fill_short_gaps(speech))
    return speech
