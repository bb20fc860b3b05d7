"""CSS module-level inference: session row -> separated wav streams.

Port of notsofar_tpu/css/inference.py with the same files on disk:

* outputs under out_dir/css_inference/{session_id}/sep_stream{i}.wav plus
  input_mixture.wav;
* `fetch_from_cache` returns existing sep*.wav;
* `pass_through_ch0` bypasses CSS entirely;
* a model directory holds a yaml config and either the native
  params.msgpack (written by save_css_model, here or in the JAX package)
  or a reference *.pt torch checkpoint (converted on load).

The entry points run on ``cuda`` unless the caller passes
``device="cpu"``; ``cfg.use_pallas_scm`` sends MVDR's masked covariance
through the CUDA kernel (default False, as in the JAX package).
"""
from pathlib import Path
from typing import Dict, Optional, Tuple

import pandas as pd
import torch

from notsofar_tpu_torch.css.engine import CssCfg, CssEngine
from notsofar_tpu_torch.models.convert import (convert_css_state_dict,
                                               load_torch_checkpoint,
                                               read_flax_msgpack,
                                               variables_from_jax,
                                               variables_to_jax,
                                               write_flax_msgpack)
from notsofar_tpu_torch.models.css_wrapper import CssModel
from notsofar_tpu_torch.training.config import TrainCfg
from notsofar_tpu_torch.utils.audio import load_session_audio, write_wav
from notsofar_tpu_torch.utils.conf import (dataclass_to_dict,
                                           load_yaml_to_dataclass)
from notsofar_tpu_torch.utils.device import resolve_device
from notsofar_tpu_torch.utils.logging_def import get_logger
from notsofar_tpu_torch.utils.profiling import StageTimer

_LOG = get_logger("css")

_ENGINE_CACHE: Dict[str, CssEngine] = {}

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def save_css_model(model_dir, state_dict: Dict[str, torch.Tensor],
                   train_cfg: TrainCfg):
    """Write the native checkpoint format: config.yaml plus params.msgpack
    holding the flax variables (params, batch_stats, constants) of a
    ConformerCSS state dict, laid out as flax.serialization.to_bytes lays
    them out, so the JAX package's load_css_model reads it too."""
    import yaml
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    (model_dir / "config.yaml").write_text(
        yaml.safe_dump(dataclass_to_dict(train_cfg)))
    (model_dir / "params.msgpack").write_bytes(
        write_flax_msgpack(variables_to_jax(state_dict)))


def load_css_model(model_dir, compute_dtype: str = "float32", device=None
                   ) -> Tuple[CssModel, TrainCfg]:
    """Load a CSS model from either checkpoint format onto `device`."""
    model_dir = Path(model_dir)
    yamls = sorted(model_dir.glob("*.yaml"))
    if not yamls:
        raise FileNotFoundError(f"expecting a yaml config in {model_dir}")
    train_cfg = load_yaml_to_dataclass(str(yamls[0]), TrainCfg)
    css_cfg = train_cfg.conformer_css_cfg.freeze()
    msgpack = model_dir / "params.msgpack"
    pts = sorted(model_dir.glob("*.pt"))
    if msgpack.exists():
        sd = variables_from_jax(read_flax_msgpack(msgpack.read_bytes()))
    elif pts:
        _LOG.info(f"Converting torch checkpoint {pts[0]}")
        sd = convert_css_state_dict(load_torch_checkpoint(pts[0]),
                                    css_cfg.nnet_conf.conformer_conf.num_blocks)
    else:
        raise FileNotFoundError(
            f"no checkpoint (params.msgpack or *.pt) in {model_dir}")
    model = CssModel(css_cfg, dtype=DTYPES[compute_dtype], state_dict=sd,
                     device=device)
    return model, train_cfg


def get_css_engine(models_dir, checkpoint_rel: str, cfg: CssCfg,
                   device=None) -> CssEngine:
    dev = resolve_device(device)
    key = f"{Path(models_dir) / checkpoint_rel}|{cfg.compute_dtype}|{dev}"
    if key not in _ENGINE_CACHE:
        model, _ = load_css_model(str(Path(models_dir) / checkpoint_rel),
                                  compute_dtype=cfg.compute_dtype,
                                  device=dev)
        _ENGINE_CACHE[key] = CssEngine(model, cfg)
    return _ENGINE_CACHE[key]


def _write_session(css_out_dir: Path, mix, wavs, sr: int):
    write_wav(css_out_dir / "input_mixture.wav", samps=mix[0, :, 0], sr=sr)
    names = []
    for k, w in enumerate(wavs):
        filename = css_out_dir / f"sep_stream{k}.wav"
        write_wav(filename, samps=w, sr=sr)
        names.append(str(filename))
    return names


def css_batch_prepass(out_dir: str, models_dir: str,
                      sessions: pd.DataFrame, cfg: CssCfg,
                      fetch_from_cache: bool, device=None,
                      timer: Optional[StageTimer] = None,
                      engine: Optional[CssEngine] = None):
    """Separate many sessions, cfg.batch_sessions per pass, grouped by mic
    count, writing the per-session wav layout that css_inference reads
    back as cache. engine: use this CssEngine for every session instead
    of loading the configured checkpoints from models_dir."""
    if cfg.pass_through_ch0 or cfg.batch_sessions <= 1:
        return
    todo = []
    for _, session in sessions.iterrows():
        css_out_dir = Path(out_dir) / "css_inference" / session.session_id
        if fetch_from_cache and sorted(css_out_dir.glob("sep*.wav")):
            continue
        todo.append(session)
    by_mc: Dict[bool, list] = {}
    for s in todo:
        by_mc.setdefault(bool(s.is_mc), []).append(s)
    for is_mc, group in by_mc.items():
        eng = engine or get_css_engine(
            models_dir, cfg.checkpoint_mc if is_mc else cfg.checkpoint_sc,
            cfg, device)
        for i in range(0, len(group), cfg.batch_sessions):
            chunk = group[i:i + cfg.batch_sessions]
            mixes, srs = [], []
            for s in chunk:
                mix, sr = load_session_audio(s.wav_file_names, is_mc=is_mc)
                if cfg.slice_audio_for_debug:
                    mix = mix[:, sr * 20:sr * 30, :]
                mixes.append(mix)
                srs.append(sr)
            _LOG.info(f"CSS batched prepass: separating {len(chunk)} "
                      f"{'MC' if is_mc else 'SC'} sessions in one pass")
            results = eng.separate_sessions_batch(mixes, srs[0],
                                                  timer=timer)
            for s, mix, wavs in zip(chunk, mixes, results):
                _write_session(Path(out_dir) / "css_inference" / s.session_id,
                               mix, wavs, srs[0])


def css_inference(out_dir: str, models_dir: str, session: pd.Series,
                  cfg: CssCfg, fetch_from_cache: bool, device=None,
                  timer: Optional[StageTimer] = None,
                  engine: Optional[CssEngine] = None) -> pd.Series:
    """Separate one session into cfg.num_spks wav streams; adds the
    `sep_wav_file_names` column to the session row. engine: use this
    CssEngine instead of loading the configured checkpoint."""
    _LOG.info("Running CSS (Continuous Speech Separation)")
    session_css = session.copy()
    assert isinstance(session.wav_file_names, list)

    if cfg.pass_through_ch0:
        session_css["sep_wav_file_names"] = session.wav_file_names[0:1]
        return session_css

    css_out_dir = Path(out_dir) / "css_inference" / session.session_id
    if fetch_from_cache and css_out_dir.exists():
        cached = sorted(css_out_dir.glob("sep*.wav"))
        if cached:
            session_css["sep_wav_file_names"] = [str(p) for p in cached]
            return session_css

    engine = engine or get_css_engine(
        models_dir, cfg.checkpoint_mc if session.is_mc else cfg.checkpoint_sc,
        cfg, device)
    mixwav, sr = load_session_audio(session.wav_file_names,
                                    is_mc=session.is_mc)
    if cfg.slice_audio_for_debug:
        mixwav = mixwav[:, sr * 20:sr * 30, :]
    separated_wavs, _ = engine.separate_and_stitch(
        mixwav, sr, return_side_info=False, timer=timer)
    session_css["sep_wav_file_names"] = _write_session(
        css_out_dir, mixwav, separated_wavs, sr)
    return session_css
