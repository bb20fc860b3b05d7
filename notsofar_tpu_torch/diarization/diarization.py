"""Diarization dispatch: skip / by_wav_file_name / word_nmesc.

Port of notsofar_tpu/diarization/diarization.py with the same contracts:
the input is the ASR segments dataframe of one session; the output adds a
'speaker_id' column (re-segmented for word_nmesc). The per-session pickle
cache layout is the same: out_dir/diarization/{session_id}/{method}/
all_segments_df.pkl. The time-based methods (nmesc, nmesc_msdd) come
with a later slice and raise NotImplementedError here.
"""
import os
from pathlib import Path
from typing import Optional

import pandas as pd

from notsofar_tpu_torch.diarization.common import DiarizationCfg
from notsofar_tpu_torch.diarization.word_based import (
    word_based_clustering, word_based_clustering_batch)
from notsofar_tpu_torch.utils.logging_def import get_logger
from notsofar_tpu_torch.utils.profiling import StageTimer

_LOG = get_logger("diarization")

TIME_BASED_SLICE_MSG = (
    "the time-based diarization methods (nmesc, nmesc_msdd: MarbleNet VAD "
    "+ MSDD) are not ported yet; they come with the time-based "
    "diarization slice (ROADMAP.md A.11). Use method='word_nmesc'.")


def _cache_file(out_dir: str, session_name: str, method: str) -> Path:
    return Path(out_dir) / "diarization" / session_name / method \
        / "all_segments_df.pkl"


def _with_stream_index(segments_df: pd.DataFrame):
    df = segments_df.copy()
    df["wav_file_name"] = df["wav_file_name"].astype("category")
    if "wav_file_name_ind" in df:
        raise ValueError("segments_df already has wav_file_name_ind")
    df["wav_file_name_ind"] = df["wav_file_name"].cat.codes
    return df, df["wav_file_name"].cat.categories.to_list()


def diarization_inference(out_dir: str, segments_df: pd.DataFrame,
                          cfg: DiarizationCfg, fetch_from_cache: bool,
                          encoder=None, device=None,
                          timer: Optional[StageTimer] = None
                          ) -> pd.DataFrame:
    """Assign a speaker label to each ASR word of one session.

    word_nmesc runs the speaker encoder on `device` (default ``cuda``;
    raises without a card unless the caller passes ``device="cpu"``)
    unless an encoder is given. timer: optional StageTimer for the
    word_nmesc stages."""
    _LOG.info("Running Speaker Diarization")
    if segments_df.session_id.nunique() > 1:
        raise ValueError("no cross-session information is permitted")

    if cfg.method == "skip":
        _LOG.info("Skipping Diarization")
        out = segments_df.copy()
        out["speaker_id"] = "spk0"
        return out
    if cfg.method == "by_wav_file_name":
        out = segments_df.copy()
        ind, uniques = pd.factorize(out["wav_file_name"], sort=True)
        out["speaker_id"] = "wav_" + pd.Series(ind, index=out.index).astype(str)
        _LOG.info(f"Diarization by wav file names: {list(uniques)}")
        return out
    if cfg.method in ("nmesc", "nmesc_msdd"):
        raise NotImplementedError(TIME_BASED_SLICE_MSG)
    if cfg.method != "word_nmesc":
        raise ValueError(f"unknown diarization method: {cfg.method}")

    if len(segments_df) == 0:
        out = segments_df.copy()
        out["speaker_id"] = pd.Series(dtype=object)
        return out

    session_name = segments_df.session_id.iloc[0]
    is_ct = str(session_name).startswith("close_talk")
    if segments_df.wav_file_name.nunique() > 3 and not is_ct:
        raise ValueError("expecting at most three separated channels")
    out_file = _cache_file(out_dir, session_name, cfg.method)
    if fetch_from_cache and out_file.exists():
        return pd.read_pickle(out_file)
    os.makedirs(out_file.parent, exist_ok=True)

    df, wav_files = _with_stream_index(segments_df)
    attributed = word_based_clustering(wav_files, df, cfg, encoder=encoder,
                                       device=device, timer=timer)
    attributed.to_pickle(out_file)
    _LOG.info(f"Speaker Diarization saved to {out_file}")
    return attributed


def diarization_batch_prepass(out_dir: str, sessions_segments,
                              cfg: DiarizationCfg, fetch_from_cache: bool,
                              encoder=None, device=None,
                              timer: Optional[StageTimer] = None) -> None:
    """Cross-session word_nmesc prepass: all sessions' speaker-embedding
    windows run as one shared batch (word_based_clustering_batch) and
    each session's result lands in the standard diarization cache, so the
    per-session diarization_inference calls become cache hits. No
    cross-session information flows into any clustering decision."""
    if cfg.method != "word_nmesc":
        return
    jobs = []
    for segments_df in sessions_segments:
        if len(segments_df) == 0:
            continue
        if segments_df.session_id.nunique() != 1:
            raise ValueError("one session per dataframe")
        out_file = _cache_file(out_dir, segments_df.session_id.iloc[0],
                               cfg.method)
        if fetch_from_cache and out_file.exists():
            continue
        df, wav_files = _with_stream_index(segments_df)
        jobs.append((out_file, wav_files, df))
    if not jobs:
        return
    _LOG.info(f"Diarization prepass: {len(jobs)} sessions in one "
              "embedding batch")
    outs = word_based_clustering_batch(
        [dict(wav_files=w, segments_df=d) for _, w, d in jobs], cfg,
        encoder=encoder, device=device, timer=timer)
    for (out_file, _, _), attributed in zip(jobs, outs):
        out_file.parent.mkdir(parents=True, exist_ok=True)
        attributed.to_pickle(out_file)
        _LOG.info(f"Speaker Diarization saved to {out_file}")
