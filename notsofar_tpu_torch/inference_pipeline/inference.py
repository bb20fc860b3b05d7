"""The session orchestrator: CSS -> ASR -> diarization -> scoring.

Port of notsofar_tpu/inference_pipeline/inference.py with the same module
contracts, hypothesis json formats and per-session WER reporting. Sessions
are processed independently; with a torch.distributed process group each
process takes a strided slice of the session table
(parallel.mesh.shard_sessions). CSS, ASR and diarization run on ``device``
(default ``cuda``; raises without a card unless the caller passes
``device="cpu"``); ASR runs in the dtype of ``cfg.asr.compute_dtype``
('int8' is the int8 decoder with int8 cross-attention K/V).
"""
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import pandas as pd

from notsofar_tpu_torch.asr.inference import (WhisperAsrCfg,
                                              asr_batch_prepass,
                                              asr_inference)
from notsofar_tpu_torch.css.engine import CssCfg
from notsofar_tpu_torch.css.inference import css_batch_prepass, css_inference
from notsofar_tpu_torch.diarization.common import DiarizationCfg
from notsofar_tpu_torch.diarization.diarization import (
    diarization_batch_prepass, diarization_inference)
from notsofar_tpu_torch.inference_pipeline.load_meeting_data import load_data
from notsofar_tpu_torch.parallel.mesh import shard_sessions
from notsofar_tpu_torch.utils.logging_def import get_logger
from notsofar_tpu_torch.utils.scoring import (ScoringCfg, calc_wer,
                                              df_to_seglst,
                                              normalize_segment,
                                              write_submission_jsons)

_LOG = get_logger("inference")


@dataclass
class InferenceCfg:
    css: CssCfg = field(default_factory=CssCfg)
    asr: WhisperAsrCfg = field(default_factory=WhisperAsrCfg)
    diarization: DiarizationCfg = field(default_factory=DiarizationCfg)
    scoring: ScoringCfg = field(default_factory=ScoringCfg)
    session_query: Optional[str] = None


@dataclass
class FetchFromCacheCfg:
    css: bool = False
    asr: bool = False
    diarization: bool = False


def inference_pipeline(meetings_dir: str, models_dir: str, out_dir: str,
                       cfg: InferenceCfg, cache: FetchFromCacheCfg,
                       device=None):
    """Run the full pipeline over every session under meetings_dir (this
    process's shard of them). Returns the per-session WER dataframe, or
    None without GT."""
    _LOG.info(f"loading meetings from: {meetings_dir}")
    all_session_df, all_gt_utt_df, _ = load_data(meetings_dir,
                                                 cfg.session_query)

    my_rows = shard_sessions(len(all_session_df))

    # CSS prepass: sessions separated in batches of cfg.css.batch_sessions;
    # the per-session calls below read the results back from the cache
    css_cache = cache.css
    if cfg.css.batch_sessions > 1 and not cfg.css.pass_through_ch0:
        css_batch_prepass(out_dir, models_dir, all_session_df.iloc[my_rows],
                          cfg.css, cache.css, device=device)
        css_cache = True

    # ASR prepass: every session's separated streams in cross-session
    # batches of cfg.asr.batch_streams, written to the per-session cache
    asr_cache = cache.asr
    enriched: dict = {}
    if cfg.asr.batch_streams > 1:
        enriched = {pos: css_inference(out_dir, models_dir,
                                       all_session_df.iloc[pos], cfg.css,
                                       css_cache, device=device)
                    for pos in my_rows}
        asr_batch_prepass(out_dir, list(enriched.values()), cfg.asr,
                          cache.asr, models_dir=models_dir, device=device)
        asr_cache = True

    # diarization prepass: all sessions' speaker-embedding windows in one
    # shared batch (per-session clustering decisions unchanged)
    diar_cache = cache.diarization
    if enriched and cfg.diarization.method == "word_nmesc":
        seg_dfs = [asr_inference(out_dir, enriched[pos], cfg.asr, True,
                                 models_dir=models_dir, device=device)
                   for pos in my_rows if pos in enriched]
        diarization_batch_prepass(out_dir, seg_dfs, cfg.diarization,
                                  cache.diarization, device=device)
        diar_cache = True

    wer_dfs, hyp_jsons = [], []
    for pos in my_rows:
        _LOG.info(f"Processing session: "
                  f"{all_session_df.iloc[pos].session_id}")

        session = enriched[pos] if pos in enriched else css_inference(
            out_dir, models_dir, all_session_df.iloc[pos], cfg.css,
            css_cache, device=device)
        segments_df = asr_inference(out_dir, session, cfg.asr, asr_cache,
                                    models_dir=models_dir, device=device)
        attributed_segments_df = diarization_inference(
            out_dir, segments_df, cfg.diarization, diar_cache, device=device)

        hyp_paths = write_hypothesis_jsons(out_dir, session,
                                           attributed_segments_df,
                                           cfg.asr.text_normalizer())
        hyp_jsons.append(hyp_paths)

        if len(attributed_segments_df) == 0:
            _LOG.warning(f"no transcribed segments for {session.session_id}; "
                         "skipping WER for this session")
            continue
        if all_gt_utt_df is not None:
            calc_wer_out = Path(out_dir) / "wer" / session.session_id
            session_wer = calc_wer(
                calc_wer_out, hyp_paths.tcp_wer_hyp_json,
                hyp_paths.tcorc_wer_hyp_json, all_gt_utt_df,
                cfg.asr.text_normalizer(), collar=5,
                save_visualizations=cfg.scoring.save_visualizations)
            wer_dfs.append(session_wer)

    hyp_jsons_df = pd.DataFrame(hyp_jsons)
    if len(hyp_jsons_df):
        write_submission_jsons(out_dir, hyp_jsons_df)

    if wer_dfs:
        all_session_wer_df = pd.concat(wer_dfs, ignore_index=True)
        _LOG.info(f"Results:\n{all_session_wer_df}")
        _LOG.info(f"mean tcp_wer = {all_session_wer_df['tcp_wer'].mean()}")
        _LOG.info(f"mean tcorc_wer = {all_session_wer_df['tcorc_wer'].mean()}")
        exp_id = "_".join(["css", cfg.asr.model_name, cfg.diarization.method])
        result_file = Path(out_dir) / "wer" / f"{exp_id}_results.csv"
        result_file.parent.mkdir(parents=True, exist_ok=True)
        all_session_wer_df.to_csv(result_file, sep="\t")
        _LOG.info(f"Wrote full results to: {result_file}")
        return all_session_wer_df
    return None


def write_hypothesis_jsons(out_dir, session: pd.Series,
                           attributed_segments_df: pd.DataFrame,
                           text_normalizer) -> pd.Series:
    """Write the tcpWER and tcORC-WER hypothesis jsons of one session; the
    tcORC stream id is the CSS stream (factorized wav_file_name)."""
    _LOG.info(f"Writing hypothesis transcripts for session "
              f"{session.session_id}")

    def write_json(df, filename):
        filepath = Path(out_dir) / "wer" / session.session_id / filename
        seglst = df_to_seglst(df)
        seglst = seglst.map(lambda s: normalize_segment(s, text_normalizer))
        seglst.dump(filepath)
        _LOG.info(f"Wrote {filepath}")
        return filepath

    tcp_wer_hyp_json = write_json(attributed_segments_df, "tcp_wer_hyp.json")

    df_tcorc = attributed_segments_df.copy()
    df_tcorc["speaker_id"], uniques = pd.factorize(df_tcorc["wav_file_name"],
                                                   sort=True)
    _LOG.debug(f"Found {len(uniques)} streams for tc_orc_wer_hyp.json")
    tcorc_wer_hyp_json = write_json(df_tcorc, "tc_orc_wer_hyp.json")

    return pd.Series({
        "session_id": session.session_id,
        "tcp_wer_hyp_json": tcp_wer_hyp_json,
        "tcorc_wer_hyp_json": tcorc_wer_hyp_json,
        "is_mc": session.is_mc,
        "is_close_talk": session.is_close_talk,
    })
