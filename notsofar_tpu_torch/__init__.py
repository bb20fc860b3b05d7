"""notsofar_tpu_torch — the PyTorch/CUDA port of notsofar_tpu for NVIDIA
Hopper (H100).

The JAX package ``notsofar_tpu`` is the reference: each module here keeps
the file name and public names of its counterpart there, so every port
file names the file it is held against. The port imports ``torch`` and
never ``jax`` or ``notsofar_tpu``; modules it needs that have no framework
code are copied, not imported.

Ported so far (slice 1, ASR serving; slice 2, word-based diarization;
slice 3, CSS separation; slice 4, the int8 decoder, orchestrator and
scorer; slice 5, the kernel-decomposition tools):
    utils        — logging, wav I/O and session/scp readers, stage timing,
                   device selection, YAML configs, morphology, mic array
    asr          — mel frontend, tokenizer, greedy/beam decoding, word
                   timestamps, long-form transcription, asr_inference
    diarization  — word windows, NMESC clustering (float64 host path and
                   batched device path), diarization_inference
    css          — the separation engine (STFT, Conformer masks, MVDR,
                   PIT stitching, OLA, gating, iSTFT), css_inference,
                   css_batch_prepass, the standalone separate_cli
    models       — Whisper encoder/decoder, TitaNet speaker encoder,
                   Conformer CSS (torch.nn) and their checkpoint bridges
    ops          — STFT, features, MVDR, PIT, and the hand-written Hopper
                   kernels (csrc/*.cu) behind their wrappers, each with a
                   plain PyTorch version
    tools        — the kernel-decomposition tools (bench_xattn_variants,
                   bisect_attn_split), run with python -m
    training     — the config dataclasses that loading a CSS model needs

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
