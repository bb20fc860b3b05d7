"""ASR inference module: per-session transcription of CSS streams.

Port of notsofar_tpu/asr/inference.py with the same contracts:

* input: session row with `sep_wav_file_names` (the CSS output streams),
* output: segments dataframe with columns start_time, end_time, text,
  word_timing ([[word, start, end], ...]), meeting_id, session_id,
  wav_file_name,
* per-session pickle cache under out_dir/asr/{session_id}/{model}/.

Model loading: checkpoints are resolved under `models_dir` as
{models_dir}/whisper/{model_name}.pt (openai-whisper format). When none is
present, a random-initialized model of the right dimensions, seeded by a
torch.Generator, keeps the pipeline runnable (logged loudly —
transcription quality then carries no meaning).

Everything runs on ``device`` (default ``cuda``; raises without a card
unless the caller passes ``device="cpu"``).
"""
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from notsofar_tpu_torch.asr.tokenizer import WhisperTokenizer, load_tokenizer
from notsofar_tpu_torch.asr.transcribe import (TranscribeOptions,
                                               WhisperTranscriber)
from notsofar_tpu_torch.models.whisper import (WHISPER_DIMS, WhisperModel,
                                               load_openai_whisper_checkpoint,
                                               quantize_whisper_decoder)
from notsofar_tpu_torch.utils.audio import read_wav_scaled
from notsofar_tpu_torch.utils.device import resolve_device
from notsofar_tpu_torch.utils.logging_def import get_logger
from notsofar_tpu_torch.utils.profiling import StageTimer
from notsofar_tpu_torch.utils.text_norm import get_txt_norm

_LOG = get_logger("asr")

RANDOM_WEIGHTS_SEED = 0


@dataclass
class WhisperAsrCfg:
    """Mirror of the JAX package's WhisperAsrCfg (same defaults)."""
    model_name: str = "large-v2"
    language: Optional[str] = "en"
    word_level_time_stamps: bool = True
    beam_size: Optional[int] = 5
    hallucination_silence_threshold: Optional[float] = 2.0
    vocab_path: Optional[str] = None
    max_new_tokens: int = 224  # decode-step budget per 30 s window
    # matmul + weight dtype: 'bfloat16' (serving) or 'float32' (parity);
    # 'int8' keeps bf16 compute with the weight-only int8 decoder and int8
    # cross-attention K/V (the JAX package's serving configuration)
    compute_dtype: str = "bfloat16"
    # cross-session stream batching width for asr_batch_prepass (<=1
    # disables the prepass)
    batch_streams: int = 9

    def text_normalizer(self):
        return get_txt_norm("chime8")

    def assert_valid(self):
        if self.model_name not in WHISPER_DIMS:
            raise ValueError(f"unknown Whisper model {self.model_name!r}")


_MODEL_CACHE: Dict[str, Tuple[WhisperModel, WhisperTokenizer,
                              Optional[list]]] = {}


def _load_alignment_heads(ckpt: Path, dims) -> Optional[list]:
    """Optional `<ckpt stem>.alignment_heads.json` sidecar: either a list
    of [layer, head] pairs or {"blob": "<base85 gzip mask>"} in the format
    the whisper pip package hardcodes per model."""
    side = ckpt.with_suffix(".alignment_heads.json")
    if not side.exists():
        return None
    data = json.loads(side.read_text())
    if isinstance(data, dict) and "blob" in data:
        from notsofar_tpu_torch.asr.decoding import decode_alignment_heads
        heads = decode_alignment_heads(data["blob"], dims.n_text_layer,
                                       dims.n_text_head)
    else:
        heads = [(int(l), int(h)) for l, h in data]
    _LOG.info(f"Loaded {len(heads)} alignment heads from {side}")
    return heads


def load_whisper_model(model_name: str, models_dir: Optional[str] = None,
                       vocab_path: Optional[str] = None,
                       language: str = "en",
                       compute_dtype: str = "bfloat16",
                       device=None
                       ) -> Tuple[WhisperModel, WhisperTokenizer,
                                  Optional[list]]:
    """Load (model, tokenizer, alignment_heads); cached per model name,
    dtype and device.

    compute_dtype 'bfloat16' (default) stores every weight in bf16 and
    runs the matmuls in bf16, as the JAX package does; 'float32' is for
    strict-parity runs; 'int8' casts the float weights to bf16 first, then
    quantizes the decoder matrices and the embedding to int8
    (quantize_whisper_decoder) on the device that holds them, and runs
    the bf16 encoder with the weight-only int8 decoder."""
    quant = compute_dtype == "int8"
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "int8": torch.bfloat16}[compute_dtype]
    dev = resolve_device(device)
    key = f"{models_dir}/{model_name}/{compute_dtype}/{dev}"
    if key in _MODEL_CACHE:
        return _MODEL_CACHE[key]
    ckpt = None
    if models_dir is not None:
        for cand in (Path(models_dir) / "whisper" / f"{model_name}.pt",
                     Path(models_dir) / f"{model_name}.pt"):
            if cand.exists():
                ckpt = cand
                break
    alignment_heads = None
    if ckpt is not None:
        _LOG.info(f"Loading Whisper checkpoint: {ckpt}")
        sd, dims = load_openai_whisper_checkpoint(ckpt)
        alignment_heads = _load_alignment_heads(ckpt, dims)
        if quant:    # f32 tensors to bf16 first (the JAX package's cast)
            sd = {k: v.to(dtype) if v.dtype == torch.float32 else v
                  for k, v in sd.items()}
    else:
        dims = WHISPER_DIMS[model_name]
        _LOG.warning(
            f"No Whisper checkpoint found for '{model_name}' under "
            f"{models_dir} — using RANDOM weights (pipeline smoke mode; "
            "transcripts are meaningless)")
        sd = WhisperModel(dims, dtype=dtype, device=dev).init(
            torch.Generator(device=dev).manual_seed(RANDOM_WEIGHTS_SEED)
        ).state_dict()
    if quant:
        sd = quantize_whisper_decoder(sd)
    model = WhisperModel(dims, dtype=dtype, device=dev, quant_decoder=quant)
    model.load_state_dict(sd)
    del sd
    tokenizer = load_tokenizer(model_name, dims.n_vocab,
                               vocab_path=vocab_path, language=language)
    _MODEL_CACHE[key] = (model, tokenizer, alignment_heads)
    return _MODEL_CACHE[key]


def _asr_cache_path(out_dir: str, session: pd.Series,
                    cfg: WhisperAsrCfg) -> Path:
    return Path(out_dir) / "asr" / session.session_id / cfg.model_name \
        / "all_segments_df.pkl"


def _make_transcriber(cfg: WhisperAsrCfg, models_dir: Optional[str],
                      device=None) -> WhisperTranscriber:
    model, tokenizer, alignment_heads = load_whisper_model(
        cfg.model_name, models_dir, cfg.vocab_path,
        language=cfg.language or "en", compute_dtype=cfg.compute_dtype,
        device=device)
    return WhisperTranscriber(
        model, tokenizer,
        TranscribeOptions(
            language=cfg.language or "en",
            word_timestamps=cfg.word_level_time_stamps,
            hallucination_silence_threshold=cfg.hallucination_silence_threshold,
            max_new_tokens=cfg.max_new_tokens,
            beam_size=cfg.beam_size,
            alignment_heads=alignment_heads))


def _read_stream(wav_file) -> np.ndarray:
    wav, _ = read_wav_scaled(str(wav_file))
    return wav[:, 0] if wav.ndim > 1 else wav


def _results_to_df(session: pd.Series, wav_files: list,
                   results_per_stream: list) -> pd.DataFrame:
    """Build the per-session segments dataframe."""
    segments_dfs = []
    for wav_file, results in zip(wav_files, results_per_stream):
        if len(results["segments"]) == 0:
            _LOG.warning(f"No segments returned for {wav_file}")
            continue
        rows = []
        for seg in results["segments"]:
            rows.append(dict(
                start_time=seg["start"], end_time=seg["end"],
                text=seg["text"],
                word_timing=[[w["word"], w["start"], w["end"]]
                             for w in seg["words"]]))
        df = pd.DataFrame(rows)
        df["meeting_id"] = session.meeting_id
        df["session_id"] = session.session_id
        df["wav_file_name"] = wav_file
        segments_dfs.append(df)

    if not segments_dfs:
        all_segments_df = pd.DataFrame(columns=[
            "start_time", "end_time", "text", "word_timing", "meeting_id",
            "session_id", "wav_file_name"])
        all_segments_df["meeting_id"] = [session.meeting_id][:0]
    else:
        all_segments_df = pd.concat(segments_dfs, ignore_index=True)
    return all_segments_df


def asr_batch_prepass(out_dir: str, sessions: List[pd.Series],
                      cfg: WhisperAsrCfg, fetch_from_cache: bool,
                      models_dir: Optional[str] = None,
                      device=None) -> None:
    """Transcribe all sessions' separated streams in cross-session batches
    of cfg.batch_streams, so every encoder/decoder call is full even at a
    session's tail. Results land in the per-session pickle cache, which
    asr_inference then reads."""
    cfg.assert_valid()
    todo = [s for s in sessions
            if not (fetch_from_cache
                    and _asr_cache_path(out_dir, s, cfg).exists())]
    if not todo:
        return
    transcriber = _make_transcriber(cfg, models_dir, device)

    flat_wavs, owner = [], []  # owner[i] = index into todo
    for si, session in enumerate(todo):
        if not isinstance(session.sep_wav_file_names, list):
            raise TypeError("sep_wav_file_names must be a list")
        for wav_file in session.sep_wav_file_names:
            flat_wavs.append(_read_stream(wav_file))
            owner.append(si)
    _LOG.info(f"ASR prepass: {len(flat_wavs)} streams across {len(todo)} "
              f"sessions, batch width {cfg.batch_streams}")

    results = []
    bs = max(1, cfg.batch_streams)
    for i in range(0, len(flat_wavs), bs):
        results.extend(transcriber.transcribe_batch(flat_wavs[i:i + bs]))

    for si, session in enumerate(todo):
        res = [r for r, o in zip(results, owner) if o == si]
        df = _results_to_df(session, session.sep_wav_file_names, res)
        out_file = _asr_cache_path(out_dir, session, cfg)
        out_file.parent.mkdir(parents=True, exist_ok=True)
        df.to_pickle(out_file)
        _LOG.info(f"ASR prepass results saved to {out_file}")


def asr_inference(out_dir: str, session: pd.Series, cfg: WhisperAsrCfg,
                  fetch_from_cache: bool,
                  models_dir: Optional[str] = None,
                  device=None,
                  timer: Optional[StageTimer] = None) -> pd.DataFrame:
    """Transcribe every separated stream of a session (one batched
    transcribe_batch over the session's streams) and write the session's
    pickle cache. timer: optional StageTimer that accumulates the
    per-stage seconds."""
    _LOG.info("Running ASR")
    cfg.assert_valid()

    wav_files = session.sep_wav_file_names
    if not isinstance(wav_files, list):
        raise TypeError("sep_wav_file_names must be a list")

    out_file = _asr_cache_path(out_dir, session, cfg)
    if fetch_from_cache and out_file.exists():
        _LOG.info(f"Loading ASR results from {out_file}")
        return pd.read_pickle(out_file)

    transcriber = _make_transcriber(cfg, models_dir, device)

    _LOG.info(f"Running ASR on {len(wav_files)} streams (batched)")
    wavs = [_read_stream(w) for w in wav_files]
    results_per_stream = transcriber.transcribe_batch(wavs, timer=timer)
    all_segments_df = _results_to_df(session, wav_files, results_per_stream)

    out_file.parent.mkdir(parents=True, exist_ok=True)
    all_segments_df.to_pickle(out_file)
    _LOG.info(f"ASR results saved to {out_file}")
    return all_segments_df
