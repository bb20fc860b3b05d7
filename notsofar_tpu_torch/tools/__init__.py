"""Kernel-decomposition tools: timings that split a serving kernel's time
into its parts (bench_xattn_variants for xattn_int8, bisect_attn_split for
attn_step_split), run as ``python -m notsofar_tpu_torch.tools.<name>``."""
