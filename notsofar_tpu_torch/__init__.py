"""notsofar_tpu_torch — the PyTorch/CUDA port of notsofar_tpu for NVIDIA
Hopper (H100).

The JAX package ``notsofar_tpu`` is the reference: each module here keeps
the file name and public names of its counterpart there, so every port
file names the file it is held against. The port imports ``torch`` and
never ``jax`` or ``notsofar_tpu``; modules it needs that have no framework
code are copied, not imported.

Every module of the JAX package has a counterpart here:
    utils        — logging, I/O, stage timing and spans, configs, text
                   normalization, the scorer, native (every native library)
    asr          — mel, tokenizer, greedy/beam decoding in CUDA graphs,
                   word timestamps, long-form transcription, asr_inference
    diarization  — word- and time-based paths, NMESC clustering
    css          — the separation engine, css_inference, separate_cli
    models       — Whisper, TitaNet, MarbleNet, MSDD, Conformer CSS
    ops          — STFT, features, MVDR, PIT, the Hopper kernels (csrc/)
    native       — C++ host cores, each with a Python twin
    inference_pipeline, training, parallel — the orchestrator, CSS
                   training, torch.distributed
    tools        — kernel timing tools, the real-weights validator

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
