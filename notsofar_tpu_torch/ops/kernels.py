"""The port's kernels (the ASR path's attention kernels, the TitaNet
depthwise conv, MVDR's masked covariance): CUDA wrappers, plain versions
and launch counters.

Each function here has three parts:

* ``<name>``: the wrapper the model calls. For a CPU tensor it returns the
  plain version (that is how the CPU tests run). For a CUDA tensor it
  checks device, dtype, shape and contiguity, launches the hand-written
  Hopper kernel from ``csrc/<name>.cu`` on the current stream, raises if
  the launch failed, and adds one to ``LAUNCHES[name]``. There is no
  fallback from a CUDA tensor to the plain version.
* ``<name>_plain``: the same function in plain PyTorch with the Pallas
  kernel's rounding points (for attention: f32 logits and softmax,
  weights rounded to the value dtype before the f32 p.v product). The CPU
  tests hold it to the JAX package; the card holds the kernel to it.
* the kernel source, which names the TPU kernel it replaces
  (notsofar_tpu/ops/pallas_kernels.py) and what bounds it on an H100.
"""
from typing import Dict, Optional

import torch

from notsofar_tpu_torch.ops import build

MASKED = -1e30   # the Pallas kernels' masked-logit value

# launches of each CUDA kernel in this process (the plain path never counts)
LAUNCHES: Dict[str, int] = {name: 0 for name in build.KERNELS}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """False for CPU tensors (plain path); True for CUDA tensors after the
    checks every kernel shares; raises for anything else."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
    return True


def _check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# encoder_mha (pallas_kernels.py:573)
# ---------------------------------------------------------------------------

def encoder_mha_plain(qh: torch.Tensor, kh: torch.Tensor,
                      vh: torch.Tensor) -> torch.Tensor:
    """qh/kh/vh [BH, S, dk], q and k pre-scaled by dk**-0.25. Exact f32
    softmax over all keys; weights rounded to the value dtype; output in
    the value dtype."""
    lg = torch.matmul(qh.float(), kh.float().transpose(1, 2))
    w = torch.softmax(lg, dim=-1).to(vh.dtype)
    return torch.matmul(w.float(), vh.float()).to(vh.dtype)


def encoder_mha(qh: torch.Tensor, kh: torch.Tensor,
                vh: torch.Tensor) -> torch.Tensor:
    """Fused unmasked self-attention for the Whisper encoder.

    qh/kh/vh: [BH, S, dk] with the attention scale folded into q and k.
    Returns [BH, S, dk] in the value dtype."""
    if not _on_card("encoder_mha", qh, kh, vh):
        return encoder_mha_plain(qh, kh, vh)
    BH, S, dk = qh.shape
    if kh.shape != qh.shape or vh.shape != qh.shape:
        raise ValueError("encoder_mha: q, k, v must share [BH, S, dk]")
    dt = qh.dtype
    if dt not in (torch.bfloat16, torch.float32) or \
            kh.dtype != dt or vh.dtype != dt:
        raise ValueError("encoder_mha: q, k, v share bf16 or f32")
    if dk not in (64, 128):
        raise ValueError(f"encoder_mha: dk={dk} not in (64, 128)")
    out = torch.empty_like(vh)
    lib = build.load("encoder_mha")
    rc = lib.encoder_mha(qh.data_ptr(), kh.data_ptr(), vh.data_ptr(),
                         out.data_ptr(), BH, S, dk,
                         int(dt == torch.bfloat16), _stream())
    LAUNCHES["encoder_mha"] += 1
    _check_rc("encoder_mha", rc)
    return out


# ---------------------------------------------------------------------------
# attn_step (pallas_kernels.py:224)
# ---------------------------------------------------------------------------

def attn_step_plain(q_eff: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, pos: int,
                    pad_lens: torch.Tensor, dk: int) -> torch.Tensor:
    """q_eff [B, 1, D] (dk**-0.5 folded, cache dtype); caches [B, ctx, D];
    key s visible iff s <= pos and (s >= pad or s == pos). -> [B, 1, D]
    f32."""
    B, _, D = q_eff.shape
    ctx = k_cache.shape[1]
    H = D // dk
    qh = q_eff.reshape(B, H, dk).float()
    kh = k_cache.reshape(B, ctx, H, dk).float()
    vh = v_cache.reshape(B, ctx, H, dk).float()
    lg = torch.einsum("bhd,bshd->bhs", qh, kh)
    s = torch.arange(ctx, device=q_eff.device)
    pads = pad_lens.to(q_eff.device).reshape(B, 1)
    visible = (s[None] <= pos) & ((s[None] >= pads) | (s[None] == pos))
    lg = torch.where(visible[:, None, :], lg, torch.full_like(lg, MASKED))
    p = torch.softmax(lg, dim=-1).to(v_cache.dtype).float()
    return torch.einsum("bhs,bshd->bhd", p, vh).reshape(B, 1, D)


def attn_step(q_eff: torch.Tensor, k_cache: torch.Tensor,
              v_cache: torch.Tensor, pos: int, pad_lens: torch.Tensor,
              dk: int) -> torch.Tensor:
    """Fused single-token KV-cache self-attention (decode step).

    q_eff: [B, 1, D] with the full dk**-0.5 folded in, in the cache dtype;
    k_cache/v_cache: [B, ctx, D] with the current token written at pos;
    pos: cache slot of this token (uniform across rows); pad_lens: [B]
    int32 masked left-pad widths. Returns [B, 1, D] f32."""
    pos = int(pos)
    if not _on_card("attn_step", q_eff, k_cache, v_cache, pad_lens):
        return attn_step_plain(q_eff, k_cache, v_cache, pos, pad_lens, dk)
    B, T, D = q_eff.shape
    ctx = k_cache.shape[1]
    if T != 1 or k_cache.shape != (B, ctx, D) or v_cache.shape != k_cache.shape:
        raise ValueError("attn_step: q [B, 1, D], caches [B, ctx, D]")
    if not 0 <= pos < ctx:
        raise ValueError(f"attn_step: pos={pos} outside the cache [0, {ctx})")
    if dk not in (64, 128) or D % dk:
        raise ValueError(f"attn_step: dk={dk} with D={D}")
    dt = q_eff.dtype
    if dt not in (torch.bfloat16, torch.float32) or \
            k_cache.dtype != dt or v_cache.dtype != dt:
        raise ValueError("attn_step: q and caches share bf16 or f32")
    if pad_lens.dtype != torch.int32 or pad_lens.shape != (B,):
        raise ValueError("attn_step: pad_lens must be int32 [B]")
    out = torch.empty((B, 1, D), dtype=torch.float32, device=q_eff.device)
    lib = build.load("attn_step")
    rc = lib.attn_step(q_eff.data_ptr(), k_cache.data_ptr(),
                       v_cache.data_ptr(), pad_lens.data_ptr(),
                       out.data_ptr(), B, ctx, D, dk, pos,
                       int(dt == torch.bfloat16), _stream())
    LAUNCHES["attn_step"] += 1
    _check_rc("attn_step", rc)
    return out


# ---------------------------------------------------------------------------
# attn_step_split (pallas_kernels.py:334)
# ---------------------------------------------------------------------------

def split_visibility_bias(B: int, K: int, Pp: int, G: int, gslot: int,
                          pad_lens: torch.Tensor,
                          anc: Optional[torch.Tensor]) -> torch.Tensor:
    """The additive f32 bias [B, K, Pp + K*G] the JAX wrapper builds
    (pallas_kernels.py:375-388): 0 where visible, -1e30 elsewhere."""
    dev = pad_lens.device
    colp = torch.arange(Pp, device=dev)
    beam_ids = torch.arange(K, device=dev)
    s_ok = torch.arange(G, device=dev) <= gslot
    vis_p = (colp[None, :] >= pad_lens[:, None])[:, None, :].expand(B, K, Pp)
    if anc is None:
        eq = (beam_ids[:, None] == beam_ids[None, :])[None, :, :, None] \
            .expand(B, K, K, G)
    else:
        eq = anc[:, :, None, :] == beam_ids[None, None, :, None]
    vis_g = (eq & s_ok[None, None, None, :]).reshape(B, K, K * G)
    vis = torch.cat([vis_p, vis_g], dim=-1)
    return torch.where(vis, torch.zeros((), device=dev),
                       torch.full((), MASKED, device=dev))


def attn_step_split_plain(q_eff, k_prompt, v_prompt, k_gen, v_gen,
                          gslot: int, pad_lens: torch.Tensor, dk: int,
                          beams: int,
                          anc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: the wrapper's bias plus per-head attention over each
    stream's (prompt | all K generated segments) keys. -> [B*K, 1, D] f32."""
    BK, _, D = q_eff.shape
    K = beams
    B = BK // K
    Pp, G = k_prompt.shape[1], k_gen.shape[1]
    H = D // dk
    bias = split_visibility_bias(B, K, Pp, G, gslot,
                                 pad_lens.to(q_eff.device), anc)
    keys = torch.cat([k_prompt, k_gen.reshape(B, K * G, D)], dim=1).float()
    vals = torch.cat([v_prompt, v_gen.reshape(B, K * G, D)], dim=1)
    qh = q_eff.reshape(B, K, H, dk).float()
    lg = torch.einsum("bjhd,bchd->bhjc", qh, keys.reshape(B, -1, H, dk))
    lg = lg + bias[:, None]
    p = torch.softmax(lg, dim=-1).to(vals.dtype).float()
    out = torch.einsum("bhjc,bchd->bjhd", p,
                       vals.float().reshape(B, -1, H, dk))
    return out.reshape(BK, 1, D)


def attn_step_split(q_eff: torch.Tensor, k_prompt: torch.Tensor,
                    v_prompt: torch.Tensor, k_gen: torch.Tensor,
                    v_gen: torch.Tensor, gslot: int, pad_lens: torch.Tensor,
                    dk: int, beams: int,
                    anc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Beam-search decode-step self-attention over a split KV cache.

    q_eff: [B*K, 1, D] (row b*K+j = stream b, beam j), dk**-0.5 folded,
    cache dtype; k_prompt/v_prompt: [B, Pp, D] per-stream prompt cache
    shared by the K beams; k_gen/v_gen: [B*K, G, D] per-beam generated
    caches with the current token at gslot; pad_lens: [B] int32 per-stream
    left-pad widths; anc: optional [B, K, G] int32 ancestry (anc[b, j, s]
    is the physical beam row whose slot-s K/V is in logical beam j's
    history). Returns [B*K, 1, D] f32."""
    gslot = int(gslot)
    tensors = [q_eff, k_prompt, v_prompt, k_gen, v_gen, pad_lens]
    if anc is not None:
        tensors.append(anc)
    if not _on_card("attn_step_split", *tensors):
        return attn_step_split_plain(q_eff, k_prompt, v_prompt, k_gen,
                                     v_gen, gslot, pad_lens, dk, beams, anc)
    BK, T, D = q_eff.shape
    K = beams
    if T != 1 or BK % K or not 1 <= K <= 8:
        raise ValueError(f"attn_step_split: q [B*K, 1, D] with 1 <= K <= 8")
    B = BK // K
    Pp, G = k_prompt.shape[1], k_gen.shape[1]
    if k_prompt.shape != (B, Pp, D) or v_prompt.shape != k_prompt.shape or \
            k_gen.shape != (BK, G, D) or v_gen.shape != k_gen.shape:
        raise ValueError("attn_step_split: prompt [B, Pp, D], "
                         "generated [B*K, G, D]")
    if not 0 <= gslot < G:
        raise ValueError(f"attn_step_split: gslot={gslot} outside [0, {G})")
    if dk not in (64, 128) or D % dk:
        raise ValueError(f"attn_step_split: dk={dk} with D={D}")
    dt = q_eff.dtype
    if dt not in (torch.bfloat16, torch.float32) or \
            any(t.dtype != dt for t in tensors[1:5]):
        raise ValueError("attn_step_split: q and caches share bf16 or f32")
    if pad_lens.dtype != torch.int32 or pad_lens.shape != (B,):
        raise ValueError("attn_step_split: pad_lens must be int32 [B]")
    if anc is not None and (anc.dtype != torch.int32
                            or anc.shape != (B, K, G)):
        raise ValueError("attn_step_split: anc must be int32 [B, K, G]")
    out = torch.empty((BK, 1, D), dtype=torch.float32, device=q_eff.device)
    lib = build.load("attn_step_split")
    rc = lib.attn_step_split(
        q_eff.data_ptr(), k_prompt.data_ptr(), v_prompt.data_ptr(),
        k_gen.data_ptr(), v_gen.data_ptr(), pad_lens.data_ptr(),
        anc.data_ptr() if anc is not None else None, out.data_ptr(),
        B, K, Pp, G, D, dk, gslot, int(dt == torch.bfloat16), _stream())
    LAUNCHES["attn_step_split"] += 1
    _check_rc("attn_step_split", rc)
    return out


# ---------------------------------------------------------------------------
# depthwise_conv1d (pallas_kernels.py:435)
# ---------------------------------------------------------------------------

def depthwise_conv1d_plain(x: torch.Tensor, w: torch.Tensor,
                           k: int) -> torch.Tensor:
    """x [B, T, C], w [k, C] -> [B, T, C] f32: the k shifted products of
    x.float() and w[i], summed in f32 in the order i = 0..k-1, over x
    zero-padded by (k-1)//2 rows before and k-1-(k-1)//2 after."""
    B, T, C = x.shape
    pad = (k - 1) // 2
    xp = torch.nn.functional.pad(x.float(), (0, 0, pad, k - 1 - pad))
    wf = w.float()
    acc = torch.zeros((B, T, C), dtype=torch.float32, device=x.device)
    for i in range(k):
        acc = acc + xp[:, i:i + T] * wf[i]
    return acc


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor, k: int
                     ) -> torch.Tensor:
    """'Same'-padded depthwise conv over time (TitaNet's channels-as-groups
    conv).

    x: [B, T, C] bf16 or f32 with C % 128 == 0; w: [k, C] f32 per-channel
    taps, 2 <= k <= 16. Returns [B, T, C] f32."""
    k = int(k)
    if not _on_card("depthwise_conv1d", x, w):
        return depthwise_conv1d_plain(x, w, k)
    if x.dim() != 3:
        raise ValueError("depthwise_conv1d: x must be [B, T, C]")
    B, T, C = x.shape
    if C % 128 or B == 0 or T == 0:
        raise ValueError(f"depthwise_conv1d: C={C} must be a multiple of "
                         "128 and B, T nonzero")
    if not 2 <= k <= 16 or w.shape != (k, C):
        raise ValueError(f"depthwise_conv1d: w must be [k, C] with "
                         f"2 <= k <= 16, got {tuple(w.shape)} for k={k}")
    if x.dtype not in (torch.bfloat16, torch.float32) or \
            w.dtype != torch.float32:
        raise ValueError("depthwise_conv1d: x bf16 or f32, w f32")
    out = torch.empty((B, T, C), dtype=torch.float32, device=x.device)
    lib = build.load("depthwise_conv1d")
    rc = lib.depthwise_conv1d(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                              B, T, C, k, int(x.dtype == torch.bfloat16),
                              _stream())
    LAUNCHES["depthwise_conv1d"] += 1
    _check_rc("depthwise_conv1d", rc)
    return out


# ---------------------------------------------------------------------------
# masked_scm (pallas_kernels.py:488)
# ---------------------------------------------------------------------------

def masked_scm_plain(wta: torch.Tensor, stft_c: torch.Tensor) -> torch.Tensor:
    """wta [B, F, T, K] f32, stft_c [B, F, T, M] complex64 -> [B, K, F, M,
    M] complex64: the einsum of the JAX package's masked_scm plus
    1e-15 * I."""
    scm = torch.einsum("bftk,bftm,bftn->bkfmn", wta.to(stft_c.dtype), stft_c,
                       stft_c.conj())
    eye = torch.eye(stft_c.shape[-1], dtype=scm.dtype, device=scm.device)
    return scm + 1e-15 * eye


def masked_scm(wta: torch.Tensor, stft_c: torch.Tensor) -> torch.Tensor:
    """Masked spatial covariance matrices for MVDR.

    wta: [B, F, T, K] f32 per-source masks (K <= 8); stft_c: [B, F, T, M]
    complex64 mixture STFT (M <= 8 mics). Returns [B, K, F, M, M]
    complex64: sum_t wta * x x^H, plus 1e-15 on the real diagonal."""
    if not _on_card("masked_scm", wta, stft_c):
        return masked_scm_plain(wta, stft_c)
    if wta.dim() != 4 or stft_c.dim() != 4 or \
            wta.shape[:3] != stft_c.shape[:3]:
        raise ValueError("masked_scm: wta [B, F, T, K], stft [B, F, T, M]")
    B, F, T, K = wta.shape
    M = stft_c.shape[-1]
    if wta.dtype != torch.float32 or stft_c.dtype != torch.complex64:
        raise ValueError("masked_scm: wta f32, stft complex64")
    if not (1 <= K <= 8 and 1 <= M <= 8) or min(B, F, T) == 0 or B > 65535:
        raise ValueError(f"masked_scm: K={K}, M={M} must be in [1, 8], "
                         f"B={B} in [1, 65535], F={F} and T={T} nonzero")
    out = torch.empty((B, K, F, M, M), dtype=torch.complex64,
                      device=wta.device)
    lib = build.load("masked_scm")
    rc = lib.masked_scm(wta.data_ptr(), stft_c.data_ptr(), out.data_ptr(),
                        B, F, T, K, M, _stream())
    LAUNCHES["masked_scm"] += 1
    _check_rc("masked_scm", rc)
    return out
