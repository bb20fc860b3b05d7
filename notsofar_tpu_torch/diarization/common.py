"""Diarization config + word/segment dataframe utilities.

Copy of notsofar_tpu/diarization/common.py. Word tuples flow through the
pipeline as [text, start, end, channel_id, speaker_id]; segments are cut
at speaker or channel changes so every segment maps to a single CSS
stream (required for tcORC-WER streams).
"""
from dataclasses import dataclass, field
from typing import List

import pandas as pd


@dataclass
class DiarizationCfg:
    """Mirror of the JAX package's DiarizationCfg (same defaults)."""
    method: str = "nmesc"  # "nmesc" | "nmesc_msdd" | "word_nmesc" | "skip"
    min_embedding_windows: List[float] = field(default_factory=list)
    max_allowed_word_duration: float = 3.0
    apply_deduplication: bool = True
    embedding_model_name: str = "titanet_large"
    msdd_model_name: str = "diar_msdd_telephonic"
    vad_model_name: str = "vad_multilingual_marblenet"
    # recipe yaml for the time-based methods (a later slice)
    recipe_name: str = ""
    # speaker-encoder matmul dtype: 'bfloat16' (serving) or 'float32'
    # (strict-parity runs); cosine-affinity clustering is robust to bf16
    # embeddings
    embedding_compute_dtype: str = "bfloat16"


def merge_words_to_segments_by_spk_change(all_words: list):
    """Group consecutive words sharing (speaker, channel) into segments."""
    if len(all_words) == 0:
        return []
    if len(all_words) == 1:
        # degenerate passthrough kept for parity (the reference returns the
        # word list itself here)
        return {"word_timing": [[w[:-1] for w in all_words]],
                "speaker_id": [all_words[0][-1]]}
    segments = {"word_timing": [], "speaker_id": []}
    seg_start = 0
    for i, word in enumerate(all_words):
        if i > 0 and (word[-1] != all_words[seg_start][-1]
                      or word[-2] != all_words[seg_start][-2]):
            seg_words = all_words[seg_start:i]
            segments["word_timing"].append([w[:-1] for w in seg_words])
            segments["speaker_id"].append(seg_words[0][-1])
            seg_start = i
    segments["word_timing"].append([w[:-1] for w in all_words[seg_start:]])
    segments["speaker_id"].append(all_words[seg_start][-1])
    return segments


def compute_overlap_ratio(start1, end1, start2, end2) -> float:
    overlap = min(end1, end2) - max(start1, start2)
    if overlap < 0:
        return 0
    longer = max(end1 - start1, end2 - start2)
    if longer <= 0:
        # two zero-duration words at the same instant (DTW can emit them)
        return 1.0 if overlap == 0 else 0.0
    return overlap / longer


def deduplicate(all_words_sorted, overlap_threshold: float = 0.5):
    """Drop duplicated words leaking across CSS streams: same text, same
    speaker, >50% temporal overlap with the previous word. The reference
    drops index 0 unconditionally — kept for parity."""
    out = []
    for i, cur in enumerate(all_words_sorted):
        if i == 0:
            continue
        prev = all_words_sorted[i - 1]
        skip = False
        if cur[0] == prev[0] and cur[4] == prev[4]:
            if compute_overlap_ratio(cur[1], cur[2], prev[1], prev[2]) > \
                    overlap_threshold:
                skip = True
        if not skip:
            out.append(cur)
    return out


def prepare_diarized_data_frame(all_words, segments_df,
                                apply_deduplication: bool) -> pd.DataFrame:
    """words + labels -> attributed segments dataframe."""
    all_words_sorted = sorted(all_words, key=lambda x: x[2])
    final_words = deduplicate(all_words_sorted) if apply_deduplication \
        else all_words_sorted
    if not final_words:
        # dedup drops index 0 unconditionally, so a single-word session can
        # end up empty; return an empty attributed frame
        return pd.DataFrame(columns=["start_time", "end_time", "text",
                                     "word_timing", "meeting_id",
                                     "session_id", "wav_file_name",
                                     "speaker_id"])
    segments = merge_words_to_segments_by_spk_change(final_words)

    df = pd.DataFrame({
        "start_time": [seg[0][1] for seg in segments["word_timing"]],
        "end_time": [seg[-1][2] for seg in segments["word_timing"]],
        "text": ["".join(w[0] for w in seg) for seg in segments["word_timing"]],
        "word_timing": segments["word_timing"],
    })
    df["meeting_id"] = segments_df["meeting_id"].iloc[0]
    df["session_id"] = segments_df["session_id"].iloc[0]
    stream_id = [seg[0][-1] for seg in df.word_timing.to_list()]
    df["wav_file_name"] = segments_df["wav_file_name"].cat.categories[stream_id]
    df["speaker_id"] = segments["speaker_id"]
    return df
