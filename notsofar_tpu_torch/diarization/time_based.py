"""Time-based ('nmesc', 'nmesc_msdd') diarization: VAD + sliding-window
speaker clustering, without ASR word boundaries.

Port of notsofar_tpu/diarization/time_based.py (the native counterpart
of the reference's NeMo ClusteringDiarizer / NeuralDiarizer recipes),
with the same names and results:

1. the CSS streams are concatenated on the time axis;
2. speech regions come from a MarbleNet frame VAD through the recipe's
   NeMo-parity binarization (models/marblenet.py, diarization/recipes.py)
   or, when no MarbleNet is mounted, from an energy VAD (a loud fallback);
3. sliding windows over speech at the recipe's scales are embedded with
   the speaker encoder (TitaNet: every forward reaches the
   depthwise_conv1d kernel on the card) and clustered with NMESC +
   spectral clustering on the host (numpy affinity, as in the JAX
   package);
4. for `nmesc_msdd` the MSDD refines the clustering into overlap-aware
   per-speaker activity (models/msdd.py); without a mounted MSDD the
   mode degrades to plain nmesc (logged);
5. the result becomes a per-channel frame-level speaker-VAD tensor
   [C, S, T] at 10 ms resolution, and each ASR word is assigned the most
   active speaker in its span, with nearest-word fallback.

Two repeats of the JAX package are dropped with the same results: each
stream's VAD runs once (the JAX package runs it twice), and with a recipe
msdd_refine reuses the clustering's embeddings of the scales it shares
instead of embedding them again. Models run on `device` (default
``cuda``; raises without a card unless ``device="cpu"``).
"""
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import pandas as pd

from notsofar_tpu_torch.diarization.clustering import (cos_affinity_matrix,
                                                       run_clustering)
from notsofar_tpu_torch.diarization.common import (DiarizationCfg,
                                                   prepare_diarized_data_frame)
from notsofar_tpu_torch.diarization.recipes import (DiarRecipe,
                                                    binarize_vad_probs,
                                                    resolve_recipe)
from notsofar_tpu_torch.utils.audio import read_wav
from notsofar_tpu_torch.utils.device import resolve_device
from notsofar_tpu_torch.utils.logging_def import get_logger
from notsofar_tpu_torch.utils.profiling import StageTimer

_LOG = get_logger("time_based_diarization")

VAD_TIME_RESOLUTION = 0.01  # 10 ms frames, matching the reference
EMBED_BATCH = 64            # windows per speaker-encoder forward

# Which VAD ran in the last diarize_streams call ('marblenet', 'energy'
# or 'custom'), so that callers can report a silent fallback
LAST_VAD_USED: dict = {"kind": None}


def energy_vad(wav: np.ndarray, sr: int, frame_sec: float = 0.01,
               threshold_db: float = -40.0) -> np.ndarray:
    """Boolean speech mask at 10 ms resolution (simple energy gate;
    stands in for MarbleNet)."""
    frame = int(frame_sec * sr)
    n = len(wav) // frame
    x = wav[:n * frame].reshape(n, frame)
    rms = np.sqrt((x ** 2).mean(axis=1) + 1e-12)
    peak = rms.max() + 1e-12
    db = 20 * np.log10(rms / peak + 1e-12)
    return db > threshold_db


# an explicitly passed energy_vad reports the same label as the implicit
# fallback (vad_fn=None), not "custom"
energy_vad.vad_kind = "energy"


def _embed_windows(concat: np.ndarray, sr: int, encoder,
                   starts: List[int], win: int) -> np.ndarray:
    """Batched speaker embeddings for fixed-length windows of `concat`,
    EMBED_BATCH windows a forward (the last batch zero-padded)."""
    batch = np.zeros((len(starts), win), np.float32)
    lengths = np.full(len(starts), win, np.int32)
    for i, s0 in enumerate(starts):
        seg = concat[s0:s0 + win]
        batch[i, :len(seg)] = seg
        lengths[i] = max(len(seg), 1)
    embs = []
    bs = EMBED_BATCH
    for i in range(0, len(starts), bs):
        chunk = batch[i:i + bs]
        ln = lengths[i:i + bs]
        if len(chunk) < bs:
            chunk = np.pad(chunk, ((0, bs - len(chunk)), (0, 0)))
            ln = np.pad(ln, (0, bs - len(ln)), constant_values=1)
        embs.append(encoder.embed(chunk, ln)[:min(bs, len(starts) - i)])
    return np.concatenate(embs, axis=0)


# NeMo diar_msdd_telephonic multiscale setup (window, shift) in seconds.
# Kept as the no-recipe default; configs/inference/diarization/*.yaml
# carry the full ladders (telephonic.yaml mirrors these values).
MSDD_SCALES = [1.5, 1.25, 1.0, 0.75, 0.5]
MSDD_HOPS = [0.75, 0.625, 0.5, 0.375, 0.25]

# (window, hop) in samples -> (window starts, embeddings) at that scale
Embedded = Dict[Tuple[int, int], Tuple[List[int], np.ndarray]]


def _speech_window_starts(vad: np.ndarray, total: int, sr: int,
                          win: int, hop: int) -> List[int]:
    """Window start samples whose span is >30% speech (NeMo-style gating
    of embedding windows to VAD regions)."""
    starts = []
    for s0 in range(0, max(total - win, 1), hop):
        f0 = int(s0 / sr / VAD_TIME_RESOLUTION)
        f1 = int((s0 + win) / sr / VAD_TIME_RESOLUTION)
        if vad[f0:f1].mean() > 0.3:
            starts.append(s0)
    return starts or [0]


def _scale(concat: np.ndarray, sr: int, encoder, vad: np.ndarray, win: int,
           hop: int, embedded: Optional[Embedded]):
    """The speech windows of one (window, hop) scale and their
    embeddings, taken from `embedded` when it holds them, else embedded
    and added to it."""
    key = (win, hop)
    if embedded is not None and key in embedded:
        return embedded[key]
    starts = _speech_window_starts(vad, len(concat), sr, win, hop)
    out = starts, _embed_windows(concat, sr, encoder, starts, win)
    if embedded is not None:
        embedded[key] = out
    return out


def msdd_refine(concat: np.ndarray, sr: int, encoder, msdd,
                cluster_starts: List[int], cluster_labels: np.ndarray,
                vad: np.ndarray, n_spk: int,
                threshold: float = 0.7, chunk: int = 256,
                scales: Optional[List[float]] = None,
                hops: Optional[List[float]] = None,
                cluster_win_sec: float = 1.5,
                embedded: Optional[Embedded] = None) -> np.ndarray:
    """Overlap-aware refinement of a clustering initialization.

    Port of the JAX package's NeuralDiarizer flow: embed the session at K
    scales, map every base-scale (finest) segment to its nearest
    coarser-scale segment to build ms_emb_seq, average cluster embeddings
    per scale from the initial labels, score every speaker pair with the
    MSDD and average each speaker's sigmoid over its pairs. Returns a
    speaker-activity matrix [S, total_frames] at 10 ms resolution
    (multi-label: overlapped frames can be active for several speakers).
    embedded: scales already embedded (diarize_streams' clustering), so
    that they are not embedded again; it gains the scales embedded here.
    """
    scales = scales if scales is not None else MSDD_SCALES
    hops = hops if hops is not None else MSDD_HOPS
    total = len(concat)
    scale_data = []   # (starts, centers, embs) per scale, base last
    for w_sec, h_sec in zip(scales, hops):
        win = int(w_sec * sr)
        starts, emb = _scale(concat, sr, encoder, vad, win, int(h_sec * sr),
                             embedded if embedded is not None else {})
        centers = np.asarray(starts) + win / 2
        scale_data.append((starts, centers, emb))

    base_starts, base_centers, _ = scale_data[-1]
    T = len(base_starts)
    K = len(scales)
    D = scale_data[-1][2].shape[1]
    ms_emb_seq = np.zeros((T, K, D), np.float32)
    for k, (_, centers, emb) in enumerate(scale_data):
        idx = np.abs(base_centers[:, None] - centers[None, :]).argmin(axis=1)
        ms_emb_seq[:, k, :] = emb[idx]

    # initial label per base segment: nearest clustering window
    c_centers = np.asarray(cluster_starts) + int(cluster_win_sec * sr) / 2
    base_lab = cluster_labels[
        np.abs(base_centers[:, None] - c_centers[None, :]).argmin(axis=1)]

    ms_avg = np.zeros((K, D, n_spk), np.float32)
    for s in range(n_spk):
        sel = ms_emb_seq[base_lab == s]
        if len(sel):
            ms_avg[:, :, s] = sel.mean(axis=0)

    # score speaker pairs (NeMo runs S=2 pairs and averages per speaker)
    pair_probs = np.zeros((T, n_spk), np.float32)
    pair_counts = np.zeros(n_spk, np.float32)
    pairs = [(i, j) for i in range(n_spk) for j in range(i + 1, n_spk)]
    n_chunks = int(np.ceil(T / chunk))
    seq = np.zeros((n_chunks, chunk, K, D), np.float32)
    for ci in range(n_chunks):
        seg = ms_emb_seq[ci * chunk:(ci + 1) * chunk]
        seq[ci, :len(seg)] = seg
    for i, j in pairs:
        avg = np.repeat(ms_avg[None, :, :, [i, j]], n_chunks, axis=0)
        probs = msdd.refine(seq, avg)                   # [n_chunks, chunk, 2]
        probs = probs.reshape(n_chunks * chunk, 2)[:T]
        pair_probs[:, i] += probs[:, 0]
        pair_probs[:, j] += probs[:, 1]
        pair_counts[i] += 1
        pair_counts[j] += 1
    pair_probs /= np.maximum(pair_counts[None, :], 1)

    total_frames = int(np.ceil(total / sr / VAD_TIME_RESOLUTION))
    spk_vad = np.zeros((n_spk, total_frames))
    win_b = int(scales[-1] * sr)
    active = pair_probs > threshold
    # guarantee the argmax speaker stays active (NeMo keeps the clustering
    # speaker when the sigmoid is under threshold everywhere)
    active[np.arange(T), pair_probs.argmax(axis=1)] = True
    for t, s0 in enumerate(base_starts):
        f0 = int(round(s0 / sr / VAD_TIME_RESOLUTION))
        f1 = int(round((s0 + win_b) / sr / VAD_TIME_RESOLUTION))
        for s in range(n_spk):
            if active[t, s]:
                spk_vad[s, f0:f1] = 1
    spk_vad[:, :len(vad)] *= vad[None, :total_frames]
    return spk_vad


def diarize_streams(wavs: List[np.ndarray], sr: int, encoder,
                    window_sec: float = 1.5, hop_sec: float = 0.75,
                    vad_fn: Optional[Callable] = None,
                    max_num_speakers: int = 8,
                    msdd=None, msdd_threshold: Optional[float] = None,
                    recipe: Optional[DiarRecipe] = None,
                    timer: Optional[StageTimer] = None) -> np.ndarray:
    """Concatenated-stream clustering -> [C, S, T] speaker-VAD tensor.

    msdd: optional OverlapDecoder — when given, the clustering
    initialization is refined into overlap-aware per-speaker activity
    (the reference's `nmesc_msdd` NeuralDiarizer mode).

    recipe: optional DiarRecipe (configs/inference/diarization/*.yaml).
    When given, the clustering affinity is the weighted multiscale average
    over the recipe's (window, shift) ladder with the finest scale as the
    labeled base segments (NeMo ClusteringDiarizer semantics), and the
    clustering/MSDD hyperparameters come from the recipe. Without a recipe
    the single-scale 1.5 s / 0.75 s behavior is kept. timer: optional
    StageTimer for the stages vad, embed, clustering and msdd.
    """
    timer = timer or StageTimer()
    # only make_recipe_vad-wrapped functions carry vad_kind="marblenet";
    # an explicitly passed custom vad must not masquerade as it
    LAST_VAD_USED["kind"] = ("energy" if vad_fn is None
                             else getattr(vad_fn, "vad_kind", "custom"))
    vad_fn = vad_fn or energy_vad
    concat = np.concatenate(wavs)
    channel_len = max(len(w) for w in wavs)
    with timer.stage("vad"):
        masks = [vad_fn(w, sr) for w in wavs]
        vad = np.concatenate([
            np.pad(m, (0, max(0, int(len(w) / sr / VAD_TIME_RESOLUTION)
                              - len(m)))) for w, m in zip(wavs, masks)])

    total = len(concat)
    embedded: Embedded = {}
    if recipe is not None:
        max_num_speakers = recipe.clustering.max_num_speakers
        scale_wins = recipe.speaker_embeddings.window_length_in_sec
        scale_hops = recipe.speaker_embeddings.shift_length_in_sec
        weights = np.asarray(recipe.speaker_embeddings.multiscale_weights,
                             np.float64)
        # base scale (labeled units) = finest = last entry, as in NeMo
        base_win = int(scale_wins[-1] * sr)
        with timer.stage("embed"):
            scaled = [_scale(concat, sr, encoder, vad, int(w_sec * sr),
                             int(h_sec * sr), embedded)
                      for w_sec, h_sec in zip(scale_wins, scale_hops)]
        with timer.stage("clustering"):
            starts = scaled[-1][0]
            base_centers = np.asarray(starts) + base_win / 2
            aff = None
            for k, ((starts_k, emb_k), w_sec) in enumerate(
                    zip(scaled, scale_wins)):
                centers_k = np.asarray(starts_k) + int(w_sec * sr) / 2
                idx = np.abs(base_centers[:, None]
                             - centers_k[None, :]).argmin(axis=1)
                aff_k = cos_affinity_matrix(emb_k[idx]) * weights[k]
                aff = aff_k if aff is None else aff + aff_k
            aff /= weights.sum()
            labels = run_clustering(
                aff, max_num_speakers=max_num_speakers,
                max_rp_threshold=recipe.clustering.max_rp_threshold,
                sparse_search_volume=recipe.clustering.sparse_search_volume)
        win = base_win
        if msdd_threshold is None:
            msdd_threshold = recipe.msdd.sigmoid_threshold[0]
    else:
        win = int(window_sec * sr)
        hop = int(hop_sec * sr)
        with timer.stage("embed"):
            starts = _speech_window_starts(vad, total, sr, win, hop)
            emb = _embed_windows(concat, sr, encoder, starts, win)
        with timer.stage("clustering"):
            labels = run_clustering(cos_affinity_matrix(emb),
                                    max_num_speakers=max_num_speakers)
    if msdd_threshold is None:
        msdd_threshold = 0.7
    n_spk = int(labels.max()) + 1 if len(labels) else 1

    total_frames = int(np.ceil(total / sr / VAD_TIME_RESOLUTION))
    if msdd is not None and n_spk >= 2:
        with timer.stage("msdd"):
            spk_vad = msdd_refine(
                concat, sr, encoder, msdd, starts, labels, vad, n_spk,
                threshold=msdd_threshold,
                scales=(recipe.speaker_embeddings.window_length_in_sec
                        if recipe is not None else None),
                hops=(recipe.speaker_embeddings.shift_length_in_sec
                      if recipe is not None else None),
                cluster_win_sec=win / sr,
                embedded=embedded if recipe is not None else None)
    else:
        spk_vad = np.zeros((n_spk, total_frames))
        for s0, lab in zip(starts, labels):
            f0 = int(round(s0 / sr / VAD_TIME_RESOLUTION))
            f1 = int(round((s0 + win) / sr / VAD_TIME_RESOLUTION))
            spk_vad[int(lab), f0:f1] = 1
        # restrict to speech frames
        spk_vad[:, :len(vad)] *= vad[None, :total_frames]

    # split the global timeline back into per-channel tensors
    C = len(wavs)
    chan_frames = int(np.ceil(channel_len / sr / VAD_TIME_RESOLUTION))
    out = np.zeros((C, n_spk, chan_frames))
    offset = 0
    for c, w in enumerate(wavs):
        nf = int(np.ceil(len(w) / sr / VAD_TIME_RESOLUTION))
        seg = spk_vad[:, offset:offset + nf]
        out[c, :, :seg.shape[1]] = seg
        offset += nf
    return out


def assign_words_to_speakers(segments_df: pd.DataFrame, spk_vad: np.ndarray,
                             apply_deduplication: bool,
                             vad_time_resolution: float = VAD_TIME_RESOLUTION
                             ) -> pd.DataFrame:
    """Most-active-speaker-per-word assignment with nearest-word fallback
    (the reference's assign_words_to_speakers)."""
    has_unassigned = False
    all_words = []
    for _, seg in segments_df.iterrows():
        channel_id = seg.wav_file_name_ind
        for word in seg["word_timing"]:
            f0 = int(np.round(word[1] / vad_time_resolution))
            f1 = max(f0 + 1, int(np.round(word[2] / vad_time_resolution)))
            counts = spk_vad[channel_id][:, f0:f1]
            avg = counts.mean(axis=1) if counts.size else np.zeros(
                spk_vad.shape[1])
            if avg.sum() == 0:
                all_words.append(word + [channel_id, None])
                has_unassigned = True
            else:
                all_words.append(word + [channel_id,
                                         f"spk{int(np.argmax(avg))}"])

    if has_unassigned:
        mids = [np.mean(w[1:3]) for w in all_words if w[-1] is not None]
        spks = [w[-1] for w in all_words if w[-1] is not None]
        for w in all_words:
            if w[-1] is None:
                if not mids:
                    w[-1] = "spk0"
                    continue
                t = np.mean(w[1:3])
                j = int(np.argmin(np.abs(np.asarray(mids) - t)))
                w[-1] = spks[j]
    return prepare_diarized_data_frame(all_words, segments_df,
                                       apply_deduplication)


def _find_model(name: str) -> Optional[str]:
    """A checkpoint named `name`: an absolute path, or `name`.nemo /
    `name` under NOTSOFAR_MODELS_DIR; None when neither exists."""
    import os
    candidates = [name] if os.path.isabs(name) else []
    root = os.environ.get("NOTSOFAR_MODELS_DIR")
    if root:
        candidates += [os.path.join(root, f"{name}.nemo"),
                       os.path.join(root, name)]
    return next((c for c in candidates if os.path.exists(c)), None)


_VAD_CACHE: dict = {}


def resolve_frame_vad(cfg: DiarizationCfg, device=None):
    """Load the MarbleNet frame VAD named by cfg.vad_model_name under
    NOTSOFAR_MODELS_DIR (or an absolute path) onto `device`. Returns None
    when no checkpoint is mounted: diarize_streams then falls back to the
    energy VAD, with a warning. Cached per (name, device)."""
    name = cfg.vad_model_name
    if not name:
        return None
    dev = resolve_device(device)
    key = (name, str(dev))
    if key in _VAD_CACHE:
        return _VAD_CACHE[key]
    cand = _find_model(name)
    if cand is not None:
        from notsofar_tpu_torch.models.marblenet import FrameVAD
        _LOG.info(f"loading frame VAD from {cand}")
        _VAD_CACHE[key] = FrameVAD.from_checkpoint(cand, device=dev)
        return _VAD_CACHE[key]
    _LOG.warning(
        f"VAD model '{name}' is NOT mounted — substituting the energy VAD. "
        "Diarization output will differ from the MarbleNet recipe; mount "
        f"{name}.nemo under NOTSOFAR_MODELS_DIR for parity "
        "(time_based.LAST_VAD_USED reports which VAD ran).")
    _VAD_CACHE[key] = None
    return None


def make_recipe_vad(frame_vad, recipe: DiarRecipe) -> Callable:
    """Wrap a FrameVAD so its frame probabilities go through the recipe's
    NeMo-parity binarization (onset/offset hysteresis, padding,
    min-duration filtering) instead of a plain threshold."""
    def vad(wav: np.ndarray, sr: int) -> np.ndarray:
        if sr != 16000:
            raise ValueError("resample to 16 kHz before VAD")
        w = np.asarray(wav, np.float32)[None]
        probs = frame_vad.frame_probs(w, np.asarray([w.shape[1]]))[0]
        n = w.shape[1] // 160
        return binarize_vad_probs(probs[:n], recipe.vad)
    vad.vad_kind = "marblenet"
    return vad


_MSDD_CACHE: dict = {}


def resolve_overlap_decoder(cfg: DiarizationCfg, device=None):
    """Load the MSDD named by cfg.msdd_model_name under NOTSOFAR_MODELS_DIR
    (or an absolute path) onto `device`. Returns None when no checkpoint
    is mounted: `nmesc_msdd` then degrades to the plain clustering
    recipe, with a log. Cached per (name, device)."""
    name = cfg.msdd_model_name
    if not name:
        return None
    dev = resolve_device(device)
    key = (name, str(dev))
    if key in _MSDD_CACHE:
        return _MSDD_CACHE[key]
    cand = _find_model(name)
    if cand is not None:
        from notsofar_tpu_torch.models.msdd import OverlapDecoder
        _LOG.info(f"loading MSDD from {cand}")
        _MSDD_CACHE[key] = OverlapDecoder.from_checkpoint(cand, device=dev)
        return _MSDD_CACHE[key]
    _LOG.info(f"MSDD model '{name}' not mounted — falling back to plain "
              "nmesc clustering")
    _MSDD_CACHE[key] = None
    return None


def time_based_diarization(wav_files_sorted, segments_df: pd.DataFrame,
                           output_dir: str, cfg: DiarizationCfg,
                           encoder=None, vad_fn=None, msdd=None,
                           device=None,
                           timer: Optional[StageTimer] = None
                           ) -> pd.DataFrame:
    """The nmesc / nmesc_msdd recipe dispatch: the recipe for cfg.method
    (or cfg.recipe_name), the speaker encoder, frame VAD and (for
    nmesc_msdd) MSDD resolved onto `device` unless given, then
    diarize_streams and the word assignment. timer: optional StageTimer
    for read_wav, vad, embed, clustering, msdd and assign."""
    timer = timer or StageTimer()
    with timer.stage("read_wav"):
        srs_wavs = [read_wav(f, normalize=True, return_rate=True)
                    for f in wav_files_sorted]
    sr = srs_wavs[0][0]
    wavs = [w if w.ndim == 1 else w[0] for _, w in srs_wavs]
    recipe = resolve_recipe(cfg.method, cfg.recipe_name)
    if encoder is None:
        from notsofar_tpu_torch.diarization.word_based import \
            resolve_speaker_encoder
        encoder = resolve_speaker_encoder(cfg, device)
    if vad_fn is None:
        frame_vad = resolve_frame_vad(cfg, device)
        if frame_vad is not None:
            vad_fn = make_recipe_vad(frame_vad, recipe)
    if msdd is None and cfg.method == "nmesc_msdd":
        msdd = resolve_overlap_decoder(cfg, device)
    spk_vad = diarize_streams(wavs, sr, encoder, vad_fn=vad_fn, msdd=msdd,
                              recipe=recipe, timer=timer)
    with timer.stage("assign"):
        return assign_words_to_speakers(segments_df, spk_vad,
                                        cfg.apply_deduplication)
