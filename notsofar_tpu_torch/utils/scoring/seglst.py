"""SegLST (segment-wise long-form speech transcription) structures and I/O.

Copy of notsofar_tpu/utils/scoring/seglst.py.
A minimal, meeteval-compatible representation: a SegLST is a list of segment
dicts with keys session_id, start_time, end_time, words, speaker. The JSON
on-disk format matches the reference hypothesis/submission files
(utils/scoring.py:26-43, inference_pipeline/inference.py:111-156) so outputs
remain drop-in comparable.
"""
import json
from pathlib import Path
from typing import Callable, Dict, Iterable, List


class SegLst:
    def __init__(self, segments: Iterable[Dict]):
        self.segments: List[Dict] = list(segments)

    # -- construction -----------------------------------------------------
    @staticmethod
    def load(path) -> "SegLst":
        with open(path) as f:
            data = json.load(f)
        assert isinstance(data, list), f"{path}: SegLST json must be a list"
        return SegLst(data)

    @staticmethod
    def from_dataframe(df) -> "SegLst":
        """Build from a segments dataframe (columns session_id, start_time,
        end_time, text, speaker_id), parity with df_to_seglst
        (utils/scoring.py:26-36)."""
        return SegLst([
            dict(session_id=row.session_id,
                 start_time=float(row.start_time),
                 end_time=float(row.end_time),
                 words=row.text,
                 speaker=row.speaker_id)
            for row in df.itertuples()])

    # -- transforms --------------------------------------------------------
    def map(self, fn: Callable[[Dict], Dict]) -> "SegLst":
        return SegLst([fn(dict(seg)) for seg in self.segments])

    def normalize_words(self, tn) -> "SegLst":
        return self.map(lambda s: {**s, "words": tn(s["words"])})

    def groupby(self, key: str) -> Dict[str, "SegLst"]:
        out: Dict[str, SegLst] = {}
        for seg in self.segments:
            out.setdefault(str(seg[key]), SegLst([])).segments.append(seg)
        return out

    def filter(self, pred) -> "SegLst":
        return SegLst([s for s in self.segments if pred(s)])

    # -- io ----------------------------------------------------------------
    def dump(self, path):
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.segments, f, indent=1, default=str)

    def __len__(self):
        return len(self.segments)

    def __iter__(self):
        return iter(self.segments)

    def extend(self, other: "SegLst"):
        self.segments.extend(other.segments)
        return self


def words_with_pseudo_times(seg: Dict) -> List[Dict]:
    """Split a segment into words with character-based pseudo timestamps.

    meeteval's default 'character_based' pseudo word-level timing: the
    segment interval is divided proportionally to word character lengths.
    """
    words = str(seg["words"]).split()
    if not words:
        return []
    start, end = float(seg["start_time"]), float(seg["end_time"])
    total_chars = sum(len(w) for w in words)
    if total_chars == 0:
        return []
    dur = end - start
    out = []
    acc = 0
    for w in words:
        b = start + dur * acc / total_chars
        acc += len(w)
        e = start + dur * acc / total_chars
        out.append(dict(word=w, begin=b, end=e))
    return out
