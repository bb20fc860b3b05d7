"""Measurement tools run as ``python -m notsofar_tpu_torch.tools.<name>``:
the kernel-decomposition timings (bench_xattn_variants for xattn_int8,
bisect_attn_split for attn_step_split), the decode step and attn_step
timers, and time_train_step for the CSS training step."""
