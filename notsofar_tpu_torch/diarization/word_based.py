"""Word-based ('word_nmesc') diarization: multi-scale speaker embeddings per
ASR word + NMESC spectral clustering.

Port of notsofar_tpu/diarization/word_based.py. Semantics:

* per word, one embedding per scale window in cfg.min_embedding_windows
  ([3.0, 2.5, 2.0, 1.5, 1.0, 0.5] s in the shipped config); windows are
  centred on words shorter than the scale, clamped to the stream extent,
  and taken from the word's own CSS stream;
* words longer than max_allowed_word_duration are dropped entirely;
* per-scale cosine affinity matrices are averaged, then NMESC + spectral
  clustering labels each word.

Windows are bucketed by length (multiples of 8192 samples) and run in
chunks of 256 rows whose count follows a {1, 1.5} x 2^k ladder; padding
rows carry length 1 and are dropped. The bucket widths decide the padded
frame counts that squeeze-excite divides by, so they are kept as in the
JAX package. A SpeakerEncoder gathers the windows on its device out of
the session audio, uploaded once; the embeddings, affinities and the
clustering chain stay on that device and only the labels come back.
Encoders without embed_windows_multi (test doubles) take the
host-assembly branch, whose numpy embeddings take the float64 host
clustering path.
"""
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from notsofar_tpu_torch.diarization.clustering import (cos_affinity_matrix,
                                                       run_clustering,
                                                       run_clustering_batch)
from notsofar_tpu_torch.diarization.common import (DiarizationCfg,
                                                   prepare_diarized_data_frame)
from notsofar_tpu_torch.utils.audio import read_wav
from notsofar_tpu_torch.utils.device import resolve_device
from notsofar_tpu_torch.utils.logging_def import get_logger
from notsofar_tpu_torch.utils.profiling import StageTimer

_LOG = get_logger("word_based_diarization")

BUCKET = 8192           # window length bucket, samples
RANDOM_WEIGHTS_SEED = 0

_ENCODER_CACHE: Dict[tuple, object] = {}


def resolve_speaker_encoder(cfg: DiarizationCfg, device=None):
    """The speaker embedding model: a NeMo checkpoint named by
    cfg.embedding_model_name under NOTSOFAR_MODELS_DIR (or an absolute
    path), else a TitaNet-large with seeded random weights (pipeline
    smoke mode, logged). Cached per name, dtype and device."""
    from notsofar_tpu_torch.models.titanet import SpeakerEncoder
    dev = resolve_device(device)
    name = cfg.embedding_model_name
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        cfg.embedding_compute_dtype]
    key = (name, str(dtype), str(dev))
    if key in _ENCODER_CACHE:
        return _ENCODER_CACHE[key]
    candidates = []
    if os.path.isabs(name):
        candidates.append(name)
    root = os.environ.get("NOTSOFAR_MODELS_DIR")
    if root:
        candidates += [os.path.join(root, f"{name}.nemo"),
                       os.path.join(root, name)]
    for cand in candidates:
        if os.path.exists(cand):
            _LOG.info(f"loading speaker encoder from {cand}")
            enc = SpeakerEncoder.from_checkpoint(cand, compute_dtype=dtype,
                                                 device=dev)
            _ENCODER_CACHE[key] = enc
            return enc
    _LOG.warning(f"speaker model '{name}' not found (set NOTSOFAR_MODELS_DIR"
                 ") — using RANDOM weights; labels will be arbitrary")
    _ENCODER_CACHE[key] = SpeakerEncoder(compute_dtype=dtype, device=dev,
                                         seed=RANDOM_WEIGHTS_SEED)
    return _ENCODER_CACHE[key]


def collect_word_windows(segments_df: pd.DataFrame, wav_duration: float,
                         min_embedding_windows: List[float],
                         max_allowed_word_duration: float = 3.0
                         ) -> Tuple[List[list], List[List[Tuple[float, float]]]]:
    """Returns (words, per-word scale windows). Word entries are
    [text, start, end, channel_id]; windows are (t0, t1) per scale."""
    words, windows = [], []
    too_long = 0
    for _, seg in segments_df.iterrows():
        channel_id = seg.wav_file_name_ind
        for word in seg["word_timing"]:
            start, end = word[1], word[2]
            duration = end - start
            if duration > max_allowed_word_duration:
                _LOG.info(f"word '{word[0]}' has unreasonably long duration "
                          f"({start}s, {end}s). Skip it in diarization")
                too_long += 1
                continue
            center = 0.5 * (start + end)
            scales = []
            for win in min_embedding_windows:
                if duration < win:
                    t0 = max(0.0, center - win / 2)
                    t1 = min(wav_duration, center + win / 2)
                else:
                    t0, t1 = start, end
                scales.append((t0, t1))
            words.append([word[0], start, end, channel_id])
            windows.append(scales)
    if too_long:
        _LOG.info(f"dropped {too_long} over-long words")
    return words, windows


def window_tasks(words, windows, sr: int, n_samples: int):
    """(word_idx, scale_idx, channel, start_sample, length) per window."""
    tasks = []
    for wi, scales in enumerate(windows):
        ch = words[wi][3]
        for si, (t0, t1) in enumerate(scales):
            s0, s1 = int(t0 * sr), int(t1 * sr)
            s1 = min(s1, n_samples)
            tasks.append((wi, si, ch, s0, max(s1 - s0, 1)))
    return tasks


def bucket_windows(tasks) -> Dict[int, list]:
    """Windows by padded length: multiples of 8192 samples (0.512 s), one
    bucket per shipped scale with <= 0.5 s of padding."""
    buckets: Dict[int, list] = {}
    for t in tasks:
        blen = int(math.ceil(max(t[4], 1) / BUCKET) * BUCKET)
        buckets.setdefault(blen, []).append(t)
    return buckets


def chunk_count(n_windows: int, batch_size: int) -> int:
    """Chunks of batch_size rows for a bucket: the needed count rounded up
    the {1, 1.5} x 2^k ladder (row padding <= 33%)."""
    need = max(math.ceil(n_windows / batch_size), 1)
    n_chunks = 1
    while n_chunks < need:
        n_chunks *= 2
    if n_chunks > 2 and need <= 3 * n_chunks // 4:
        n_chunks = 3 * n_chunks // 4
    return n_chunks


def extract_embeddings_bucketed(encoder, wavs, sr: int, words: List[list],
                                windows: List[List[Tuple[float, float]]],
                                batch_size: int = 256):
    """Embed every (word, scale) window -> [n_words, n_scales, D].

    With a SpeakerEncoder (it has embed_windows_multi) the session bank is
    uploaded once, zero-padded to a power-of-two length plus the largest
    bucket, the windows are gathered on the device, and the result is a
    tensor on the encoder's device. Encoders without it (test doubles) get
    host-assembled [batch_size, blen] batches through `embed`, and the
    result is numpy."""
    n_scales = len(windows[0]) if windows else 0
    tasks = window_tasks(words, windows, sr, wavs.shape[1])
    buckets = bucket_windows(tasks)
    D = encoder.cfg.emb_dim if hasattr(encoder, "cfg") else None

    if hasattr(encoder, "embed_windows_multi"):
        dev = encoder.device
        if not buckets:
            return torch.zeros((0, n_scales, D), device=dev)
        max_blen = max(buckets)
        L = wavs.shape[1]
        L_pad = 1 << max(int(math.ceil(math.log2(max(L, 1)))), 8)
        sess = torch.as_tensor(wavs, dtype=torch.float32, device=dev)
        sess = torch.nn.functional.pad(sess, (0, L_pad + max_blen - L))
        specs, w_idx, s_idx, keep = [], [], [], []
        offset = 0
        for blen, items in sorted(buckets.items()):
            M = chunk_count(len(items), batch_size) * batch_size
            chans = np.zeros(M, np.int64)
            starts = np.zeros(M, np.int64)
            lengths = np.ones(M, np.int64)
            for j, (wi, si, ch, s0, ln) in enumerate(items):
                chans[j], starts[j] = ch, s0
                lengths[j] = min(ln, blen)
                w_idx.append(wi)
                s_idx.append(si)
            keep.extend(range(offset, offset + len(items)))
            offset += M
            specs.append((chans, starts, lengths, blen))
        emb_all = encoder.embed_windows_multi(sess, specs,
                                              inner_bs=batch_size)
        emb_all = emb_all[torch.as_tensor(keep, device=dev)]
        out = torch.zeros((len(words), n_scales, emb_all.shape[-1]),
                          dtype=torch.float32, device=dev)
        out[torch.as_tensor(w_idx, device=dev),
            torch.as_tensor(s_idx, device=dev)] = emb_all
        return out

    out = None
    for blen, items in sorted(buckets.items()):
        for i in range(0, len(items), batch_size):
            chunk = items[i:i + batch_size]
            batch = np.zeros((batch_size, blen), np.float32)
            lengths = np.ones(batch_size, np.int32)
            for j, (wi, si, ch, s0, ln) in enumerate(chunk):
                ln = min(ln, blen)
                batch[j, :ln] = wavs[ch, s0:s0 + ln]
                lengths[j] = ln
            emb = np.asarray(encoder.embed(batch, lengths))
            if out is None:
                out = np.zeros((len(words), n_scales, emb.shape[-1]),
                               np.float32)
            for j, (wi, si, ch, s0, ln) in enumerate(chunk):
                out[wi, si] = emb[j]
    if out is None:
        out = np.zeros((0, n_scales, D or 192), np.float32)
    return out


def _affinity_core(e: torch.Tensor) -> torch.Tensor:
    """Scale-averaged min-max cosine affinity, mirroring
    cos_affinity_matrix per scale: [..., N, S, D] -> [..., N, N]. Each
    scale's min and max run over its whole matrix; nan_to_num keeps one
    NaN embedding from zeroing the whole graph."""
    e = e.movedim(-2, -3)                            # [..., S, N, D]
    u = e / (torch.linalg.norm(e, dim=-1, keepdim=True) + 1e-12)
    sim = u @ u.transpose(-1, -2)                    # [..., S, N, N]
    N = sim.shape[-1]
    eye = torch.eye(N, dtype=sim.dtype, device=sim.device)
    sim = sim * (1 - eye) + eye
    lo = sim.amin(dim=(-1, -2), keepdim=True)
    hi = sim.amax(dim=(-1, -2), keepdim=True)
    scaled = torch.where(hi - lo < 1e-12, torch.ones_like(sim),
                         (sim - lo) / torch.clamp_min(hi - lo, 1e-12))
    return torch.nan_to_num(scaled.mean(dim=-3))


def _read_session(wav_files) -> Tuple[int, np.ndarray]:
    srs_wavs = [read_wav(f, normalize=True, return_rate=True)
                for f in wav_files]
    wav_list = [w if w.ndim == 1 else w[0] for _, w in srs_wavs]
    max_len = max(w.size for w in wav_list)
    return srs_wavs[0][0], np.stack([np.pad(w, (0, max_len - w.size))
                                     for w in wav_list])


def _host_affinity(emb: np.ndarray) -> np.ndarray:
    return np.mean([cos_affinity_matrix(emb[:, s])
                    for s in range(emb.shape[1])], axis=0)


def word_based_clustering_batch(sessions: List[dict], cfg: DiarizationCfg,
                                encoder=None, device=None,
                                timer: Optional[StageTimer] = None
                                ) -> List[pd.DataFrame]:
    """word_based_clustering over many sessions with one shared
    speaker-embedding pass.

    sessions: dicts with `wav_files` (list of paths) and `segments_df`,
    optionally `session_wavs` ([n_streams, L] numpy) + `sr`. All
    sessions' (word, scale) windows merge into one channel bank, so the
    embedding buckets are shared; affinities and clustering stay strictly
    per session. timer: optional StageTimer that accumulates the stages
    read_wav, embed, affinity, clustering and df. Returns the diarized
    dataframes in order."""
    timer = timer or StageTimer()
    if encoder is None:
        encoder = resolve_speaker_encoder(cfg, device)
    srs = [s.get("sr", 16000) for s in sessions]
    if len(set(srs)) > 1:
        raise ValueError("mixed sample rates in one diarization batch")
    sr = srs[0] if srs else 16000

    banks, metas = [], []
    ch_base = 0
    all_words: List[list] = []
    all_windows: List[List[Tuple[float, float]]] = []
    with timer.stage("read_wav"):
        for sess in sessions:
            wavs = sess.get("session_wavs")
            if wavs is None:
                _, wavs = _read_session(sess["wav_files"])
            dur = wavs.shape[1] / sr
            words, windows = collect_word_windows(
                sess["segments_df"], dur, cfg.min_embedding_windows,
                cfg.max_allowed_word_duration)
            for w in words:
                w[3] += ch_base
            metas.append((len(all_words), len(words), sess["segments_df"],
                          ch_base))
            all_words.extend(words)
            all_windows.extend(windows)
            banks.append(np.asarray(wavs, np.float32))
            ch_base += wavs.shape[0]

    outs: List[Optional[pd.DataFrame]] = [None] * len(sessions)
    if not all_words:
        for i, (_, _, df, _) in enumerate(metas):
            out = df.copy()
            out["speaker_id"] = "spk0"
            outs[i] = out
        return outs

    L_max = max(b.shape[1] for b in banks)
    bank = np.concatenate([np.pad(b, ((0, 0), (0, L_max - b.shape[1])))
                           for b in banks], axis=0)
    with timer.stage("embed"):
        emb = extract_embeddings_bucketed(encoder, bank, sr, all_words,
                                          all_windows)

    with timer.stage("affinity"):
        affs, aff_idx = [], []
        if isinstance(emb, torch.Tensor):
            # sessions with equal word counts share one batched affinity
            groups: dict = {}
            for i, (w0, n_w, _, _) in enumerate(metas):
                if n_w:
                    groups.setdefault(n_w, []).append((i, w0))
            for n_w, items in groups.items():
                batch_aff = _affinity_core(
                    torch.stack([emb[w0:w0 + n_w] for _, w0 in items]))
                for row, (i, _) in enumerate(items):
                    affs.append(batch_aff[row])
                    aff_idx.append(i)
            order = np.argsort(aff_idx)
            affs = [affs[o] for o in order]
            aff_idx = [aff_idx[o] for o in order]
        else:
            for i, (w0, n_w, _, _) in enumerate(metas):
                if n_w:
                    affs.append(_host_affinity(emb[w0:w0 + n_w]))
                    aff_idx.append(i)
    with timer.stage("clustering"):
        labels_by_session = dict(zip(aff_idx, run_clustering_batch(affs)))

    with timer.stage("df"):
        for i, (w0, n_w, df, base) in enumerate(metas):
            if n_w == 0:
                out = df.copy()
                out["speaker_id"] = "spk0"
                outs[i] = out
                continue
            labels = labels_by_session[i]
            # undo the bank channel offset: the attributed frame indexes
            # the session's own wav_file_name categories
            sess_words = [[w[0], w[1], w[2], w[3] - base, f"spk{int(l)}"]
                          for w, l in zip(all_words[w0:w0 + n_w], labels)]
            outs[i] = prepare_diarized_data_frame(sess_words, df,
                                                  cfg.apply_deduplication)
    return outs


def word_based_clustering(audio_files: list, segments_df: pd.DataFrame,
                          cfg: DiarizationCfg, encoder=None,
                          session_wavs: Optional[np.ndarray] = None,
                          sr: int = 16000, device=None,
                          timer: Optional[StageTimer] = None
                          ) -> pd.DataFrame:
    """ASR words -> speaker labels via multi-scale NMESC clustering.

    session_wavs: optional [n_streams, L] numpy audio (stream order
    matching wav_file_name_ind) in place of reading audio_files. timer:
    optional StageTimer that accumulates the stages read_wav, embed,
    affinity, clustering and df."""
    timer = timer or StageTimer()
    with timer.stage("read_wav"):
        if session_wavs is not None:
            wavs = np.asarray(session_wavs, np.float32)
        else:
            sr, wavs = _read_session(audio_files)

    if encoder is None:
        encoder = resolve_speaker_encoder(cfg, device)

    words, windows = collect_word_windows(
        segments_df, wavs.shape[1] / sr, cfg.min_embedding_windows,
        cfg.max_allowed_word_duration)
    if not words:
        df = segments_df.copy()
        df["speaker_id"] = "spk0"
        return df

    with timer.stage("embed"):
        emb = extract_embeddings_bucketed(encoder, wavs, sr, words, windows)
    with timer.stage("affinity"):
        affinity = _affinity_core(emb) if isinstance(emb, torch.Tensor) \
            else _host_affinity(emb)
    with timer.stage("clustering"):
        labels = run_clustering(affinity)
    with timer.stage("df"):
        all_words = [w + [f"spk{int(l)}"] for w, l in zip(words, labels)]
        return prepare_diarized_data_frame(all_words, segments_df,
                                           cfg.apply_deduplication)
