"""Scoring: tcpWER / tcORC-WER with the frozen chime8 normalizer.

Copy of notsofar_tpu/utils/scoring/__init__.py: the NOTSOFAR baseline's
utils/scoring.py with a native metric core instead of meeteval (the metric
semantics are reimplemented in tcpwer.py / levenshtein.py and the port's
own native/tclev.cpp).
"""
from dataclasses import dataclass
from functools import partial
from pathlib import Path
from typing import Callable, Dict, List, Union

import pandas as pd

from notsofar_tpu_torch.utils.logging_def import get_logger
from notsofar_tpu_torch.utils.scoring.seglst import SegLst
from notsofar_tpu_torch.utils.scoring.tcpwer import tcorc_wer, tcp_wer
from notsofar_tpu_torch.utils.text_norm import get_txt_norm

_LOG = get_logger("wer")


@dataclass
class ScoringCfg:
    """Mirror of ScoringCfg (utils/scoring.py:20-23)."""
    save_visualizations: bool = False


def df_to_seglst(df) -> SegLst:
    return SegLst.from_dataframe(df)


def normalize_segment(segment: Dict, tn) -> Dict:
    segment["words"] = tn(segment["words"])
    return segment


def calc_wer(out_dir,
             tcp_wer_hyp_json: Union[str, Path, List[Dict]],
             tcorc_wer_hyp_json: Union[str, Path, List[Dict]],
             gt_utt_df: pd.DataFrame,
             tn: Union[str, Callable] = "chime8",
             collar: float = 5,
             save_visualizations: bool = False) -> pd.DataFrame:
    """Per-session tcpWER + tcORC-WER. Contract parity with
    utils/scoring.py:46-142: hypothesis and reference are both normalized
    (idempotent), the reference transcript is dumped to out_dir/ref.json,
    and the result dataframe carries the same column names.
    """
    to_seglst = lambda x: SegLst(x) if isinstance(x, list) else SegLst.load(x)
    tcp_hyp = to_seglst(tcp_wer_hyp_json)
    tcorc_hyp = to_seglst(tcorc_wer_hyp_json)

    # join GT utterances per hypothesis session (MTG_xxx id join,
    # utils/scoring.py:80-84)
    sess_ids = sorted(tcp_hyp.groupby("session_id"))
    rows = []
    for sess in sess_ids:
        meeting_id = _extract_meeting_id(sess)
        gt = gt_utt_df[gt_utt_df.meeting_id == meeting_id]
        for r in gt.itertuples():
            rows.append(dict(session_id=sess,
                             start_time=float(r.start_time),
                             end_time=float(r.end_time),
                             words=r.text,
                             speaker=r.speaker_id))
    ref = SegLst(rows)

    if isinstance(tn, str):
        tn = get_txt_norm(tn)
    tcp_hyp = tcp_hyp.normalize_words(tn)
    tcorc_hyp = tcorc_hyp.normalize_words(tn)
    ref = ref.normalize_words(tn)

    ref_path = Path(out_dir) / "ref.json"
    ref.dump(ref_path)

    ref_by_sess = ref.groupby("session_id")
    res_rows = []
    for sess in sess_ids:
        r = ref_by_sess.get(sess, SegLst([]))
        hyp_sess = tcp_hyp.groupby("session_id").get(sess, SegLst([]))
        tcp = tcp_wer(r, hyp_sess, collar=collar)
        if save_visualizations:
            from notsofar_tpu_torch.utils.scoring.visualization import \
                render_alignment_html
            viz = render_alignment_html(
                r, hyp_sess, Path(out_dir) / "viz.html",
                assignment=tcp.get("assignment"),
                title=f"tcpWER alignment — {sess}")
            _LOG.info(f"Wrote alignment visualization: {viz}")
        tcorc = tcorc_wer(r, tcorc_hyp.groupby("session_id").get(sess, SegLst([])),
                          collar=collar)
        row = dict(session_id=sess)
        row.update({"tcp_wer" if k == "error_rate" else f"tcp_{k}": v
                    for k, v in tcp.items()})
        row.update({"tcorc_wer" if k == "error_rate" else f"tcorc_{k}": v
                    for k, v in tcorc.items()})
        res_rows.append(row)
    wer_df = pd.DataFrame(res_rows)

    if isinstance(tcp_wer_hyp_json, (str, Path)):
        wer_df["tcp_wer_hyp_json"] = str(tcp_wer_hyp_json)
    if isinstance(tcorc_wer_hyp_json, (str, Path)):
        wer_df["tcorc_wer_hyp_json"] = str(tcorc_wer_hyp_json)

    _LOG.info("Done calculating WER")
    _LOG.info(f"\n{wer_df[['session_id', 'tcp_wer', 'tcorc_wer']]}")
    return wer_df


def _extract_meeting_id(session_id: str) -> str:
    import re
    m = re.search(r"(MTG_\d+)", session_id)
    return m.group(1) if m else session_id


def write_submission_jsons(out_dir: str, hyp_jsons_df: pd.DataFrame):
    """Merge per-session hypothesis jsons into per-track submission files.

    Parity with utils/scoring.py:145-174.
    """
    hyp_jsons_df = hyp_jsons_df[~hyp_jsons_df.is_close_talk]

    def write(files, file_name, is_mc):
        merged = SegLst([])
        for f in files:
            merged.extend(SegLst.load(f))
        track = "multichannel" if is_mc else "singlechannel"
        filepath = Path(out_dir) / "wer" / track / file_name
        merged.dump(filepath)
        _LOG.info(f"Wrote hypothesis transcript for submission: {filepath}")

    mc = hyp_jsons_df[hyp_jsons_df.is_mc]
    sc = hyp_jsons_df[~hyp_jsons_df.is_mc]
    if len(mc) > 0:
        write(mc.tcp_wer_hyp_json, "tcp_wer_hyp.json", True)
        write(mc.tcorc_wer_hyp_json, "tc_orc_wer_hyp.json", True)
    if len(sc) > 0:
        write(sc.tcp_wer_hyp_json, "tcp_wer_hyp.json", False)
        write(sc.tcorc_wer_hyp_json, "tc_orc_wer_hyp.json", False)
