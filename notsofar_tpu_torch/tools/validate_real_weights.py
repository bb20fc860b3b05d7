"""Real-weight validation of the port: loaders, forwards, one-session WER.

Every checkpoint reader of the port is tested on synthetic checkpoints of
the real formats. The first time real weights are mounted, one command
checks them all on the card:

    python -m notsofar_tpu_torch.tools.validate_real_weights \
        --models-dir  <dir with notsofar/conformer1.0/{mc,sc}, whisper/*.pt> \
        [--nemo-dir   <dir with titanet_large.nemo, vad_multilingual_marblenet.nemo,
                       diar_msdd_telephonic.nemo>  (default: --models-dir)] \
        [--meetings-dir <NOTSOFAR dev-set meetings dir>] \
        [--session-query '<pandas query>'] \
        [--out-dir <scratch>] [--device cuda|cpu]

The arguments and defaults are those of tools/validate_real_weights.py
(the JAX package's validator) plus --device (default cuda; without a card
it raises unless --device cpu is given). There is no CPU fallback: a
component whose kernel does not build or launch FAILs.

Per component it prints PASS / SKIP (not mounted) / FAIL:
  css-mc / css-sc   load_css_model (reference .pt + yaml, or native
                    params.msgpack) + forward: masks finite, in [0, 1];
                    with --reference-dir pointing at a NOTSOFAR-baseline
                    checkout (its torch code imported from there), mask
                    parity of the port against the baseline's own model
                    within 1e-4.
  whisper           openai .pt + a 3 s transcribe() round trip with word
                    timestamps (greedy: encoder_mha, attn_step, xattn_step,
                    decode_gemv).
  titanet           .nemo conversion + two embeddings (dimension, cross-
                    cosine; depthwise_conv1d).
  marblenet         .nemo conversion + the frame logits held to the
                    independent NeMo-semantics forward of
                    tools/marblenet_oracle.py on the CPU, rel < 1e-3, then
                    one wav's frame mask.
  msdd              .nemo conversion + refinement forward sanity.
  e2e-wer           inference_pipeline on --meetings-dir sessions: the
                    session tcpWER / tcORC-WER (the NOTSOFAR baseline: MC
                    .324 / SC .468) and which VAD ran for the time-based
                    diarization methods.
  int8-wer-delta    the pipeline twice (ASR weights bf16 and int8):
                    wer(int8) - wer(bf16), the serving configuration's
                    accuracy cost, against a 0.003 verdict (xattn_int8).

RESULTS holds (component, status, detail) of the last main() in run
order. Exit code 0 iff nothing FAILed.
"""
import argparse
import functools
import os
import shutil
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from notsofar_tpu_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parents[2]
RESULTS = []


def check(name):
    """Run a component: it returns None (not mounted: SKIP) or a dict with
    its "detail" line and its numbers (PASS); an exception is a FAIL. The
    wrapped function returns the dict (None unless it passed)."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            try:
                out = fn(*a, **kw)
            except Exception as e:
                RESULTS.append((name, "FAIL", f"{type(e).__name__}: {e}"))
                print(f"[FAIL] {name}: {type(e).__name__}: {e}")
                traceback.print_exc()
                return None
            if out is None:
                RESULTS.append((name, "SKIP", "not mounted"))
                print(f"[SKIP] {name}: not mounted")
            else:
                RESULTS.append((name, "PASS", out["detail"]))
                print(f"[PASS] {name}: {out['detail']}")
            return out
        return run
    return deco


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _css_dir(models_dir, kind):
    d = Path(models_dir) / "notsofar" / "conformer1.0" / kind
    return d if d.exists() else None


def _reference_masks(d: Path, reference_dir, mix: np.ndarray):
    """The NOTSOFAR baseline's own ConformerCssWrapper, imported from the
    checkout at reference_dir, on the checkpoint's .pt: (stft, masks)."""
    sys.path.insert(0, str(reference_dir))
    from css.training.conformer_wrapper import ConformerCssWrapper
    from css.training.train import TrainCfg as RefTrainCfg
    from utils.conf import load_yaml_to_dataclass as ref_load
    ref_cfg = ref_load(str(sorted(d.glob("*.yaml"))[0]), RefTrainCfg)
    tm = ConformerCssWrapper(ref_cfg.conformer_css_cfg)
    sd = torch.load(sorted(d.glob("*.pt"))[0], map_location="cpu",
                    weights_only=False)
    sd = sd.get("model", sd)
    tm.load_state_dict({k.removeprefix("module."): v for k, v in sd.items()})
    tm.eval()
    with torch.no_grad():
        t_stft = tm.stft(torch.from_numpy(mix))
        return t_stft, tm.separate(t_stft)["spk_masks"].numpy()


def _check_css(models_dir, kind, reference_dir, device):
    d = _css_dir(models_dir, kind)
    if d is None:
        return None
    from notsofar_tpu_torch.css.inference import load_css_model
    model, _ = load_css_model(str(d), device=device)
    C = 7 if kind == "mc" else 1
    rng = np.random.RandomState(0)
    mix = (rng.randn(1, 16000, C) * 0.1).astype(np.float32)
    m = model.forward(torch.from_numpy(mix).to(device))["spk_masks"]
    m = m.float().cpu().numpy()
    _require(np.isfinite(m).all(), "non-finite masks")
    _require(((m >= 0) & (m <= 1)).all(), "masks out of [0,1]")
    out = dict(shape=m.shape, mean=float(m.mean()))
    out["detail"] = f"forward OK, masks {m.shape}, mean {out['mean']:.3f}"
    if reference_dir and sorted(d.glob("*.pt")):
        t_stft, t_masks = _reference_masks(d, reference_dir, mix)
        p_masks = model.separate(t_stft.to(device))["spk_masks"]
        d_net = float(np.abs(t_masks - p_masks.float().cpu().numpy()).max())
        _require(d_net < 1e-4, f"converted-weight mask parity {d_net:.2e}")
        out["torch_parity"] = d_net
        out["detail"] += f", torch-parity maxdiff {d_net:.2e}"
    return out


@check("css-mc")
def check_css_mc(models_dir, reference_dir, device):
    return _check_css(models_dir, "mc", reference_dir, device)


@check("css-sc")
def check_css_sc(models_dir, reference_dir, device):
    return _check_css(models_dir, "sc", reference_dir, device)


@check("whisper")
def check_whisper(models_dir, model_name, device):
    found = [p for p in (Path(models_dir) / "whisper" / f"{model_name}.pt",
                         Path(models_dir) / f"{model_name}.pt")
             if p.exists()]
    if not found:
        return None
    from notsofar_tpu_torch.asr.inference import load_whisper_model
    from notsofar_tpu_torch.asr.transcribe import (TranscribeOptions,
                                                   WhisperTranscriber)
    model, tok, heads = load_whisper_model(model_name, models_dir,
                                           device=device)
    tr = WhisperTranscriber(model, tok,
                            TranscribeOptions(word_timestamps=True,
                                              alignment_heads=heads,
                                              max_new_tokens=48))
    t = np.arange(16000 * 3) / 16000
    audio = (0.1 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    out = tr.transcribe(audio)
    _require("segments" in out, "no segments in the transcription")
    return dict(segments=len(out["segments"]), detail=(
        f"dims {model.dims.n_text_layer}L/{model.dims.n_text_state}d, "
        f"alignment_heads={'yes' if heads else 'fallback'}, "
        f"transcribe OK ({len(out['segments'])} segments)"))


@check("titanet")
def check_titanet(nemo_dir, device):
    p = Path(nemo_dir) / "titanet_large.nemo"
    if not p.exists():
        return None
    from notsofar_tpu_torch.models.titanet import SpeakerEncoder
    enc = SpeakerEncoder.from_checkpoint(str(p), device=device)
    rng = np.random.RandomState(0)
    wavs = (rng.randn(2, 24000) * 0.1).astype(np.float32)
    emb = enc.embed(wavs, np.array([24000, 16000], np.int32))
    _require(np.isfinite(emb).all(), "non-finite embeddings")
    e = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    cross = float(e[0] @ e[1])
    return dict(dim=emb.shape[1], cross_cos=cross,
                detail=f"emb dim {emb.shape[1]}, cross-cos {cross:.3f}")


@check("marblenet")
def check_marblenet(nemo_dir, device):
    """The port's frame logits on `device` against the independent
    NeMo-semantics forward (tools/marblenet_oracle.py, CPU f32) on the
    same state dict and features."""
    p = Path(nemo_dir) / "vad_multilingual_marblenet.nemo"
    if not p.exists():
        return None
    from notsofar_tpu_torch.models.marblenet import FrameVAD
    from notsofar_tpu_torch.models.titanet import titanet_features
    from notsofar_tpu_torch.models.titanet_convert import load_nemo_archive
    from notsofar_tpu_torch.tools.marblenet_oracle import torch_frame_logits
    vad = FrameVAD.from_checkpoint(str(p), device=device)
    sd, _ = load_nemo_archive(str(p))
    rng = np.random.RandomState(0)
    wavs = (rng.randn(2, 16000 * 4) * 0.1).astype(np.float32)
    lengths = np.asarray([16000 * 4, 16000 * 3])
    frame_lengths = lengths // 160 + 1
    with torch.no_grad():
        feats = titanet_features(torch.from_numpy(wavs).to(device),
                                 n_mels=vad.cfg.n_mels)
        got = vad.module(feats, torch.from_numpy(frame_lengths).to(device))
    got = got.float().cpu().numpy()
    ref = torch_frame_logits(sd, vad.cfg, feats.cpu().numpy(), frame_lengths)
    rel = max(np.abs(ref[b, :n] - got[b, :n]).max()
              / max(np.abs(ref[b, :n]).max(), 1e-9)
              for b, n in enumerate(frame_lengths))
    _require(rel < 1e-3, f"torch-oracle parity FAILED: rel {rel:.2e}")
    mask = vad(wavs[0], 16000)
    return dict(rel=float(rel), mask_len=len(mask),
                speech_frac=float(np.mean(mask)),
                detail=(f"torch-oracle parity rel {rel:.2e}, frame mask len "
                        f"{len(mask)}, speech frac {np.mean(mask):.2f}"))


@check("msdd")
def check_msdd(nemo_dir, device):
    p = Path(nemo_dir) / "diar_msdd_telephonic.nemo"
    if not p.exists():
        return None
    from notsofar_tpu_torch.models.msdd import OverlapDecoder
    dec = OverlapDecoder.from_checkpoint(str(p), device=device)
    c = dec.cfg
    rng = np.random.RandomState(0)
    probs = dec.refine(
        rng.randn(1, 8, c.n_scales, c.emb_dim).astype(np.float32),
        rng.randn(1, c.n_scales, c.emb_dim, 2).astype(np.float32))
    _require(probs.shape == (1, 8, 2) and np.isfinite(probs).all(),
             f"refine gave {probs.shape}, finite {np.isfinite(probs).all()}")
    return dict(probs=probs, detail=(
        f"K={c.n_scales} D={c.emb_dim} hidden={c.hidden} "
        f"lstm={c.num_lstm_layers}, refine OK"))


def _pipeline_cfg(conf_file, session_query):
    from notsofar_tpu_torch.inference_pipeline.inference import InferenceCfg
    from notsofar_tpu_torch.utils.conf import load_yaml_to_dataclass
    cfg = load_yaml_to_dataclass(conf_file, InferenceCfg)
    cfg.session_query = session_query
    return cfg


def _no_wer(wer) -> bool:
    return wer is None or (hasattr(wer, "__len__") and len(wer) == 0)


@check("int8-wer-delta")
def check_int8_wer_delta(models_dir, meetings_dir, out_dir, session_query,
                         conf_file, model_name, device):
    """wer(int8) - wer(bf16) on the mounted sessions: the full pipeline
    twice, toggling only the ASR weight storage (per-channel symmetric
    int8 may degrade on a trained model's outlier channels)."""
    if not meetings_dir:
        return None
    if not ((Path(models_dir) / "whisper" / f"{model_name}.pt").exists()
            or (Path(models_dir) / f"{model_name}.pt").exists()):
        return None
    from notsofar_tpu_torch.inference_pipeline.inference import (
        FetchFromCacheCfg, inference_pipeline)
    wers = {}
    for dtype in ("bfloat16", "int8"):
        cfg = _pipeline_cfg(conf_file, session_query)
        cfg.asr.compute_dtype = dtype
        d = os.path.join(out_dir, f"int8_delta_{dtype}")
        shutil.rmtree(d, ignore_errors=True)
        wer = inference_pipeline(meetings_dir, models_dir, d, cfg,
                                 FetchFromCacheCfg(), device=device)
        if _no_wer(wer):
            return dict(detail="no GT -> cannot compute the delta")
        wers[dtype] = float(wer["tcp_wer"].mean())
    delta = wers["int8"] - wers["bfloat16"]
    verdict = "OK (<=0.003 abs)" if abs(delta) <= 0.003 else \
        "REVIEW: int8 shifts tcpWER materially — serve bf16 or requantize"
    return dict(wers=wers, delta=delta, detail=(
        f"tcpWER bf16 {wers['bfloat16']:.4f} | int8 {wers['int8']:.4f} "
        f"| delta {delta:+.4f} {verdict}"))


@check("e2e-wer")
def check_e2e(models_dir, meetings_dir, out_dir, session_query, conf_file,
              device):
    if not meetings_dir:
        return None
    from notsofar_tpu_torch.diarization.time_based import LAST_VAD_USED
    from notsofar_tpu_torch.inference_pipeline.inference import (
        FetchFromCacheCfg, inference_pipeline)
    cfg = _pipeline_cfg(conf_file, session_query)
    wer = inference_pipeline(meetings_dir, models_dir, out_dir, cfg,
                             FetchFromCacheCfg(), device=device)
    # which VAD ran: an energy-VAD fallback changes what nmesc and
    # nmesc_msdd compute without failing
    vad_note = ""
    if cfg.diarization.method in ("nmesc", "nmesc_msdd"):
        vad_note = f" [VAD used: {LAST_VAD_USED['kind'] or 'n/a'}]"
    if _no_wer(wer):
        return dict(wer=None, detail="pipeline ran (no GT -> no WER "
                                     "computed)" + vad_note)
    try:
        return dict(wer=wer, detail=(
            f"tcpWER {float(wer['tcp_wer'].mean()):.4f}, "
            f"tcORC {float(wer['tcorc_wer'].mean()):.4f} "
            f"over {len(wer)} sessions (baseline MC .324 / SC .468)"
            + vad_note))
    except (KeyError, TypeError, ValueError):
        return dict(wer=wer, detail=f"pipeline ran; result: {wer}{vad_note}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Check every checkpoint format the port reads, on the "
                    "card, and score the pipeline on mounted meetings.")
    ap.add_argument("--models-dir", required=True)
    ap.add_argument("--nemo-dir", default=None,
                    help="dir with *.nemo files (default: --models-dir; "
                         "also sets NOTSOFAR_MODELS_DIR for the pipeline)")
    ap.add_argument("--meetings-dir", default=None)
    ap.add_argument("--out-dir", default="./validate_out")
    ap.add_argument("--session-query",
                    default="is_mc == True ##and index<1##")
    ap.add_argument("--whisper-model", default="large-v3")
    ap.add_argument("--reference-dir", default=None,
                    help="optional NOTSOFAR baseline checkout for exact "
                         "torch mask parity of converted CSS weights")
    ap.add_argument("--conf", default=str(
        REPO / "configs" / "inference" / "inference_v1.yaml"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    RESULTS.clear()
    nemo_dir = args.nemo_dir or args.models_dir
    os.environ.setdefault("NOTSOFAR_MODELS_DIR", str(nemo_dir))

    t0 = time.perf_counter()
    check_css_mc(args.models_dir, args.reference_dir, device)
    check_css_sc(args.models_dir, args.reference_dir, device)
    check_whisper(args.models_dir, args.whisper_model, device)
    check_titanet(nemo_dir, device)
    check_marblenet(nemo_dir, device)
    check_msdd(nemo_dir, device)
    check_e2e(args.models_dir, args.meetings_dir, args.out_dir,
              args.session_query, args.conf, device)
    check_int8_wer_delta(args.models_dir, args.meetings_dir, args.out_dir,
                         args.session_query, args.conf, args.whisper_model,
                         device)

    print(f"\n=== summary ({device}, {time.perf_counter() - t0:.1f} s) ===")
    for name, status, detail in RESULTS:
        print(f"{status:5s} {name}: {detail}")
    failed = [r for r in RESULTS if r[1] == "FAIL"]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
