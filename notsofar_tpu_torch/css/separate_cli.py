"""Standalone separation CLI.

Port of notsofar_tpu/css/separate_cli.py: run a CSS model over one wav, a
directory of wavs, or a Kaldi-style wav.scp (`key /path/to/wav` per line)
without the meeting pipeline, writing the separated streams to the output
dir. Runs on the CUDA card unless given --device cpu.

    python -m notsofar_tpu_torch.css.separate_cli --model <model_dir> \
        --input mix.wav --out-dir separated/
    python -m notsofar_tpu_torch.css.separate_cli --model <model_dir> \
        --scp utterances.scp --out-dir separated/
"""
import argparse
from pathlib import Path

import numpy as np

from notsofar_tpu_torch.css.engine import CssCfg, CssEngine
from notsofar_tpu_torch.css.inference import load_css_model
from notsofar_tpu_torch.utils.audio import (ScpWaveReader, read_wav_scaled,
                                            write_wav)
from notsofar_tpu_torch.utils.logging_def import get_logger

_LOG = get_logger("separate_cli")


def _write_streams(wavs, out_dir: Path, stem: str, sr: int):
    out_dir.mkdir(parents=True, exist_ok=True)
    outs = []
    for i, w in enumerate(wavs):
        p = out_dir / f"{stem}_spk{i}.wav"
        write_wav(p, w, sr)
        outs.append(p)
    return outs


def separate_file(engine: CssEngine, wav_path: Path, out_dir: Path,
                  fs_expected: int = 16000):
    wav, sr = read_wav_scaled(str(wav_path))
    assert sr == fs_expected, f"expected {fs_expected} Hz, got {sr}"
    mix = wav[None, :, None] if wav.ndim == 1 else wav[None, :, :]
    wavs, _ = engine.separate_and_stitch(mix.astype(np.float32), sr,
                                         return_side_info=False)
    outs = _write_streams(wavs, out_dir, wav_path.stem, sr)
    _LOG.info(f"{wav_path.name}: wrote {len(outs)} streams to {out_dir}")
    return outs


def separate_scp(engine: CssEngine, scp_path: str, out_dir: Path,
                 fs_expected: int = 16000):
    """Separate every utterance of a wav.scp; outputs are named by key
    ('/' in keys becomes '_', kaldi keys are hierarchical)."""
    reader = ScpWaveReader(scp_path, sr=fs_expected, normalize=False)
    outs = []
    for key, samps in reader:
        # read_wav gives channels-first [C, N] for MC; the engine wants
        # [1, N, C] int16-scaled float
        mix = (samps.T if samps.ndim == 2 else samps[:, None])[None]
        wavs, _ = engine.separate_and_stitch(mix.astype(np.float32),
                                             fs_expected,
                                             return_side_info=False)
        outs += _write_streams(wavs, out_dir, key.replace("/", "_"),
                               fs_expected)
        _LOG.info(f"{key}: wrote separated streams to {out_dir}")
    return outs


def main(argv=None):
    parser = argparse.ArgumentParser(description="Standalone CSS separation")
    parser.add_argument("--model", required=True,
                        help="model dir (yaml + checkpoint)")
    parser.add_argument("--input",
                        help="wav file or directory of wavs")
    parser.add_argument("--scp",
                        help="Kaldi-style wav.scp ('key /path/wav' lines)")
    parser.add_argument("--out-dir", default="separated")
    parser.add_argument("--sc-mask-floor-db", type=float, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    if bool(args.input) == bool(args.scp):
        parser.error("pass exactly one of --input / --scp")

    model, _ = load_css_model(args.model, device=args.device)
    cfg = CssCfg()
    if args.sc_mask_floor_db is not None:
        cfg.sc_mask_floor_db = args.sc_mask_floor_db
    engine = CssEngine(model, cfg)

    if args.scp:
        separate_scp(engine, args.scp, Path(args.out_dir))
    else:
        inp = Path(args.input)
        files = sorted(inp.glob("*.wav")) if inp.is_dir() else [inp]
        for f in files:
            separate_file(engine, f, Path(args.out_dir))


if __name__ == "__main__":
    main()
