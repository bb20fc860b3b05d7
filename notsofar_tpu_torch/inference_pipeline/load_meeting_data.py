"""Meeting data loader: session / GT-utterance / metadata dataframes.

Copy of notsofar_tpu/inference_pipeline/load_meeting_data.py (the NOTSOFAR
baseline's load_meeting_data.py:14-199). Scans MTG_* meeting directories
for devices.json, gt_transcription.json and
gt_meeting_metadata.json, and builds:

* all_session_df — one row per (meeting, device) recording ('session'),
  close-talk devices excluded; session_id is
  '{multichannel|singlechannel}/{meeting}_{device}'.
* all_gt_utt_df — one row per GT utterance.
* all_gt_metadata_df — one row per meeting (hashtags, MtgType, ...).

Pipeline rules carried over: sessions are processed independently;
close-talk is never used in inference; 'read' meetings are rejected; the
optional `session_query` supports the '##and index<n##' head-n extension.
"""
import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import pandas as pd

from notsofar_tpu_torch.utils.audio import read_wav_scaled, write_wav
from notsofar_tpu_torch.utils.logging_def import get_logger

_LOG = get_logger("load_meeting_data")


def load_data(meetings_dir: str, session_query: Optional[str] = None,
              return_close_talk: bool = False, out_dir: Optional[str] = None
              ) -> Tuple[pd.DataFrame, Optional[pd.DataFrame], Optional[pd.DataFrame]]:
    meetings_dir = Path(meetings_dir)
    gt_utt_dfs, session_dfs, metadata_dfs = [], [], []

    for meeting_subdir in sorted(meetings_dir.glob("*/")):
        if not meeting_subdir.is_dir():
            continue
        transcription_file = meeting_subdir / "gt_transcription.json"
        devices_file = meeting_subdir / "devices.json"
        metadata_file = meeting_subdir / "gt_meeting_metadata.json"

        gt_utt_df = None
        if transcription_file.exists():
            gt_utt_df = pd.read_json(transcription_file)
            gt_utt_df["meeting_id"] = meeting_subdir.name
            gt_utt_dfs.append(gt_utt_df)

        if metadata_file.exists():
            with open(metadata_file) as f:
                metadata_dfs.append(pd.DataFrame([json.load(f)]))

        devices_df = pd.read_json(devices_file)
        devices_df["meeting_id"] = meeting_subdir.name
        if return_close_talk:
            devices_df = devices_df[devices_df.is_close_talk].copy()
            assert len(devices_df) > 0, "no close-talk devices found"
            assert gt_utt_df is not None, "expecting GT transcription"
            new_names = concat_speech_segments(devices_df, gt_utt_df,
                                               meeting_subdir, out_dir)
            devices_df = devices_df.iloc[0:1].copy()
            devices_df["device_name"] = "close_talk"
            devices_df["wav_file_names"] = [new_names]
            devices_df["session_id"] = "close_talk/" + meeting_subdir.name
        else:
            devices_df = devices_df[~devices_df.is_close_talk].copy()
            prefix = devices_df.is_mc.map(
                {True: "multichannel", False: "singlechannel"})
            devices_df["session_id"] = (
                prefix + "/" + meeting_subdir.name + "_" + devices_df["device_name"])
            devices_df["wav_file_names"] = devices_df["wav_file_names"].apply(
                lambda x: [str(meeting_subdir / n.strip()) for n in x.split(",")])
        session_dfs.append(devices_df)

    all_gt_utt_df = pd.concat(gt_utt_dfs, ignore_index=True) if gt_utt_dfs else None
    all_session_df = pd.concat(session_dfs, ignore_index=True)
    all_metadata_df = pd.concat(metadata_dfs, ignore_index=True) if metadata_dfs else None

    if all_metadata_df is not None and "MtgType" in all_metadata_df.columns:
        merged = all_session_df.merge(all_metadata_df[["meeting_id", "MtgType"]],
                                      on="meeting_id", how="inner")
        assert len(merged) == len(all_session_df)
        assert not merged.MtgType.isna().any(), "expecting valid MtgType values"
        all_session_df = merged
        assert not all_session_df.MtgType.str.startswith("read").any(), \
            '"read" meetings are for debug, they are not expected here'
        all_session_df.drop("MtgType", axis=1, inplace=True)

    if session_query:
        query, head_n = _process_query(session_query)
        all_session_df = all_session_df.query(query)
        if head_n:
            all_session_df = all_session_df.head(head_n)

    return all_session_df, all_gt_utt_df, all_metadata_df


def _process_query(query: str):
    """Supports 'query ##and index<n##' (see load_meeting_data.py:131-144):
    the head-n must apply after the query, so it is split out."""
    if query.endswith("##"):
        first = query.split("##")[0]
        head_n = int(query.split("##")[1].split("<")[-1])
        return first, head_n
    return query, None


def concat_speech_segments(devices_df, gt_utt_df, meeting_subdir: Path,
                           out_dir, silence_duration_sec: float = 0.0):
    """Concatenate close-talk GT speech segments and rewrite GT timings.

    Parity with load_meeting_data.py:147-197 (single-process variant: no
    DDP rank gating; sessions are sharded by the orchestrator instead).
    """
    meeting_id = devices_df.meeting_id.unique().item()
    assert gt_utt_df.meeting_id.unique().item() == meeting_id
    new_names = []
    for wav_file_name in devices_df["wav_file_names"]:
        cur = gt_utt_df[gt_utt_df["ct_wav_file_name"] == wav_file_name]
        assert cur.start_time.is_monotonic_increasing
        wav, sr = read_wav_scaled(meeting_subdir / wav_file_name)
        silence = np.zeros(int(silence_duration_sec * sr), dtype=wav.dtype)
        cumulative = 0.0
        parts = []
        for index, row in cur.iterrows():
            seg = wav[int(row.start_time * sr):int(row.end_time * sr)]
            parts += [seg, silence]
            delta = cumulative - row.start_time
            gt_utt_df.at[index, "start_time"] += delta
            gt_utt_df.at[index, "end_time"] += delta
            gt_utt_df.at[index, "word_timing"] = [
                [w, s + delta, e + delta] for w, s, e in row.word_timing]
            cumulative += row.end_time - row.start_time + silence_duration_sec
        new_wav = np.concatenate(parts)
        new_name = str(Path(out_dir) / "concat_close_talk" / meeting_id
                       / wav_file_name)
        new_names.append(new_name)
        write_wav(new_name, new_wav, sr=sr)
    return new_names
