"""The port's kernels (the ASR path's attention kernels, the int8
decoder's cross-attention, the TitaNet depthwise conv, MVDR's masked
covariance, the three variants that the kernel-decomposition tools time:
xattn_stream, xattn_onedot, attn_step_split_bias; and two kernels for
work the JAX package leaves to XLA fusion on the decode step: the float
cross-attention xattn_step and the weight-only GEMV decode_gemv): CUDA
wrappers, plain versions and launch counters.

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
  (notsofar_tpu/ops/pallas_kernels.py), or the XLA-fused reference code,
  and what bounds it on an H100.
"""
import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from notsofar_tpu_torch.ops import build

MASKED = -1e30   # the Pallas kernels' masked-logit value

# a decode slot: a host int, or a 0-d int32 tensor the kernel reads on the
# device
Slot = Union[int, torch.Tensor]

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


def encoder_mha_launch(BH: int, S: int, dtype: torch.dtype) -> dict:
    """Grid and block size of the CUDA kernel for [BH, S, dk] inputs: bf16
    runs 3 warpgroups (a TMA producer, two wgmma consumers) per 128 query
    rows, f32 one thread per query row in blocks of 128."""
    threads = 384 if dtype == torch.bfloat16 else 128
    return dict(grid=(-(-S // 128), BH), threads=threads, cluster=1)


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
                    v_cache: torch.Tensor, pos: Slot,
                    pad_lens: torch.Tensor, dk: int) -> torch.Tensor:
    """q_eff [B, 1, D] (dk**-0.5 folded, cache dtype); caches [B, ctx, D];
    key s visible iff s <= pos and (s >= pad or s == pos); pos an int or a
    0-d integer tensor (compared on the device, no sync). -> [B, 1, D]
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


ATTN_STEP_THREADS = 128      # threads per block of the CUDA kernel
ATTN_STEP_CLUSTER = 4        # blocks per (head, row) pair (phase 2's sweep)


def attn_step_smem(per: int, dk: int, esize: int, R: int) -> int:
    """Bytes of shared memory of one block (csrc/attn_step.cu layout): the
    value barrier, the share's value rows, its logits, the 4 warps'
    partial outputs, the peers' partial outputs of its slice, stats."""
    return (16 + per * dk * esize + _align(per * 4, 16) + 4 * dk * 4
            + _align(R * -(-dk // R) * 4, 16) + 8 * R + 8)


def attn_step_launch(B: int, ctx: int, D: int, dk: int,
                     dtype: torch.dtype) -> dict:
    """Grid, cluster size and shared memory of the CUDA kernel: a cluster
    of R blocks along x per (head, row) pair, grid (R, H, B), from the
    shapes alone (never from pos, so that a launch captured in a CUDA graph
    serves every step). Block r holds up to `per` of the visible keys'
    value rows; R = ATTN_STEP_CLUSTER (of R = 1-8, the fastest at the
    greedy shape's last slot, chip_smoke.py phase 2)."""
    esize = 2 if dtype == torch.bfloat16 else 4
    R = ATTN_STEP_CLUSTER
    per = _share_rows(ctx, R)
    return dict(grid=(R, D // dk, B), threads=ATTN_STEP_THREADS, cluster=R,
                per=per, smem=attn_step_smem(per, dk, esize, R))


def _attn_step_plan(q_eff, k_cache, v_cache, pos: Slot, pad_lens,
                    dk: int) -> dict:
    """The wrapper's checks of what the CUDA kernel takes (shapes, dtypes,
    pos, its shared memory), raising ValueError; returns the launch plan."""
    if q_eff.dim() != 3 or k_cache.dim() != 3:
        raise ValueError("attn_step: q [B, 1, D], caches [B, ctx, D]")
    B, T, D = q_eff.shape
    ctx = k_cache.shape[1]
    if T != 1 or k_cache.shape != (B, ctx, D) or v_cache.shape != k_cache.shape:
        raise ValueError("attn_step: q [B, 1, D], caches [B, ctx, D]")
    if isinstance(pos, torch.Tensor):
        if pos.dim() != 0 or pos.dtype != torch.int32 or \
                pos.device != q_eff.device:
            raise ValueError("attn_step: a pos tensor must be a 0-d int32 "
                             "tensor on the caches' device")
    elif not 0 <= pos < ctx:
        raise ValueError(f"attn_step: pos={pos} outside the cache [0, {ctx})")
    if dk not in (64, 128) or D % dk or not 0 < B <= 65535:
        raise ValueError(f"attn_step: dk={dk} with D={D}, B={B}")
    dt = q_eff.dtype
    if dt not in (torch.bfloat16, torch.float32) or \
            k_cache.dtype != dt or v_cache.dtype != dt:
        raise ValueError("attn_step: q and caches share bf16 or f32")
    if pad_lens.dtype != torch.int32 or pad_lens.shape != (B,):
        raise ValueError("attn_step: pad_lens must be int32 [B]")
    plan = attn_step_launch(B, ctx, D, dk, dt)
    if plan["smem"] > SMEM_LIMIT:
        raise ValueError(f"attn_step: ctx={ctx} needs {plan['smem']} bytes "
                         "of shared memory per block (227 KB)")
    return plan


def attn_step(q_eff: torch.Tensor, k_cache: torch.Tensor,
              v_cache: torch.Tensor, pos: Slot, pad_lens: torch.Tensor,
              dk: int) -> torch.Tensor:
    """Fused single-token KV-cache self-attention (decode step).

    q_eff: [B, 1, D] with the full dk**-0.5 folded in, in the cache dtype;
    k_cache/v_cache: [B, ctx, D] with the current token written at pos;
    pos: cache slot of this token (uniform across rows), an int or a 0-d
    int32 tensor on the caches' device that the kernel reads there (0 <=
    pos < ctx; a tensor is not checked on the host, and the kernel clamps
    it); pad_lens: [B] int32 masked left-pad widths. Returns [B, 1, D]
    f32."""
    if not isinstance(pos, torch.Tensor):
        pos = int(pos)
    if not _on_card("attn_step", q_eff, k_cache, v_cache, pad_lens):
        return attn_step_plain(q_eff, k_cache, v_cache, pos, pad_lens, dk)
    plan = _attn_step_plan(q_eff, k_cache, v_cache, pos, pad_lens, dk)
    if isinstance(pos, torch.Tensor):
        slot, slot_ptr = 0, pos.data_ptr()
    else:
        slot, slot_ptr = pos, None
    B, _, D = q_eff.shape
    out = torch.empty((B, 1, D), dtype=torch.float32, device=q_eff.device)
    lib = build.load("attn_step")
    rc = lib.attn_step(q_eff.data_ptr(), k_cache.data_ptr(),
                       v_cache.data_ptr(), pad_lens.data_ptr(), slot_ptr,
                       out.data_ptr(), B, k_cache.shape[1], D, dk, slot,
                       plan["cluster"], int(q_eff.dtype == torch.bfloat16),
                       _stream())
    LAUNCHES["attn_step"] += 1
    _check_rc("attn_step", rc)
    return out


# ---------------------------------------------------------------------------
# attn_step_split (pallas_kernels.py:334)
# ---------------------------------------------------------------------------

def split_visibility_bias(B: int, K: int, Pp: int, G: int, gslot: Slot,
                          pad_lens: torch.Tensor,
                          anc: Optional[torch.Tensor]) -> torch.Tensor:
    """The additive f32 bias [B, K, Pp + K*G] the JAX wrapper builds
    (pallas_kernels.py:375-388): 0 where visible, -1e30 elsewhere. gslot
    is an int or a 0-d int32 tensor (compared on the device, no sync)."""
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
                          gslot: Slot, pad_lens: torch.Tensor, dk: int,
                          beams: int,
                          anc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: the wrapper's bias, then the kernel body's attention
    over each stream's (prompt | all K generated segments) keys
    (attn_step_split_bias_plain). -> [B*K, 1, D] f32."""
    BK, _, D = q_eff.shape
    K = beams
    B = BK // K
    Pp, G = k_prompt.shape[1], k_gen.shape[1]
    bias = split_visibility_bias(B, K, Pp, G, gslot,
                                 pad_lens.to(q_eff.device), anc)
    out = attn_step_split_bias_plain(
        q_eff.reshape(B, K, D), k_prompt, v_prompt,
        k_gen.reshape(B, K * G, D), v_gen.reshape(B, K * G, D), bias, dk)
    return out.reshape(BK, 1, D)


SPLIT_THREADS = 256          # threads per block of the CUDA kernel
SPLIT_COLS_PER_BLOCK = 128   # columns of Pp + K*G the cluster size aims at
SPLIT_MAX_CLUSTER = 8        # portable thread-block cluster size
SMEM_LIMIT = 232448          # shared memory one block may use (227 KB)
SPLIT_MIN_SHARE = 32         # key rows of one mbarrier chunk


def split_shares(n: int, R: int) -> list:
    """The R contiguous shares (c0, len) of n columns as the cluster
    kernels cut them (csrc/split_softmax.cuh share_of): ceil(n / R)
    columns each, the last ones short or empty."""
    s = -(-n // R)
    shares = []
    for r in range(R):
        c0 = min(r * s, n)
        shares.append((c0, min(c0 + s, n) - c0))
    return shares


def _share_rows(n: int, R: int) -> int:
    """A block's column capacity: ceil(n / R) rounded up to 16, a
    tensor-core tile (csrc/split_softmax.cuh share_rows)."""
    return (-(-n // R) + 15) // 16 * 16


def _align(x: int, a: int) -> int:
    return -(-x // a) * a


def _cluster_size(n: int) -> int:
    """R for n columns: the largest portable cluster (8), fewer where n
    gives fewer shares of SPLIT_MIN_SHARE rows. Of R = 1-8, 8 was the
    fastest at each of the smoke's shapes (chip_smoke.py phase 2 logs the
    sweep)."""
    return max(1, min(SPLIT_MAX_CLUSTER, -(-n // SPLIT_MIN_SHARE)))


def attn_step_split_launch(B: int, K: int, Pp: int, G: int, D: int,
                           dk: int) -> dict:
    """Grid, cluster size and shared memory of the CUDA kernel: a cluster
    of R blocks per (head, stream) along z, R from Pp + K*G (the grid
    depends on G, never on gslot); each block holds its share of the
    logits, the queries, the ancestry rows and a [warp, 8 beams, dk]
    reduction block in shared memory (csrc/attn_step_split.cu
    smem_words)."""
    cols = Pp + K * G
    R = max(1, min(SPLIT_MAX_CLUSTER, -(-cols // SPLIT_COLS_PER_BLOCK)))
    per = -(-cols // R)
    words = (K * dk + K * G + K * per + per + SPLIT_THREADS // 32 * 8 * dk
             + K * dk + (4 + 2 * R) * K)
    return dict(grid=(D // dk, B, R), threads=SPLIT_THREADS, cluster=R,
                smem=4 * words)


def attn_step_split(q_eff: torch.Tensor, k_prompt: torch.Tensor,
                    v_prompt: torch.Tensor, k_gen: torch.Tensor,
                    v_gen: torch.Tensor, gslot: Slot, pad_lens: torch.Tensor,
                    dk: int, beams: int,
                    anc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Beam-search decode-step self-attention over a split KV cache.

    q_eff: [B*K, 1, D] (row b*K+j = stream b, beam j), dk**-0.5 folded,
    cache dtype; k_prompt/v_prompt: [B, Pp, D] per-stream prompt cache
    shared by the K beams; k_gen/v_gen: [B*K, G, D] per-beam generated
    caches with the current token at gslot; gslot: an int, or a 0-d int32
    tensor on the caches' device that the kernel reads there (0 <= gslot <
    G; a tensor is not checked on the host, and the kernel clamps it);
    pad_lens: [B] int32 per-stream left-pad widths; anc: optional
    [B, K, G] int32 ancestry (anc[b, j, s] is the physical beam row whose
    slot-s K/V is in logical beam j's history). Any beam count K up to the
    kernel's shared memory (K = 16 at Whisper's 448-token context).
    Returns [B*K, 1, D] f32."""
    if not isinstance(gslot, torch.Tensor):
        gslot = int(gslot)
    tensors = [q_eff, k_prompt, v_prompt, k_gen, v_gen, pad_lens]
    if anc is not None:
        tensors.append(anc)
    if not _on_card("attn_step_split", *tensors):
        return attn_step_split_plain(q_eff, k_prompt, v_prompt, k_gen,
                                     v_gen, gslot, pad_lens, dk, beams, anc)
    BK, T, D = q_eff.shape
    K = beams
    if T != 1 or K < 1 or BK % K:
        raise ValueError("attn_step_split: q [B*K, 1, D] with K >= 1")
    B = BK // K
    Pp, G = k_prompt.shape[1], k_gen.shape[1]
    if k_prompt.shape != (B, Pp, D) or v_prompt.shape != k_prompt.shape or \
            k_gen.shape != (BK, G, D) or v_gen.shape != k_gen.shape:
        raise ValueError("attn_step_split: prompt [B, Pp, D], "
                         "generated [B*K, G, D]")
    if isinstance(gslot, torch.Tensor):
        if gslot.dim() != 0 or gslot.dtype != torch.int32 or \
                gslot.device != q_eff.device:
            raise ValueError("attn_step_split: a gslot tensor must be a 0-d "
                             "int32 tensor on the caches' device")
        slot, slot_ptr = 0, gslot.data_ptr()
    elif not 0 <= gslot < G:
        raise ValueError(f"attn_step_split: gslot={gslot} outside [0, {G})")
    else:
        slot, slot_ptr = gslot, None
    if dk not in (64, 128) or D % dk or not 0 < B <= 65535:
        raise ValueError(f"attn_step_split: dk={dk} with D={D}, B={B}")
    dt = q_eff.dtype
    if dt not in (torch.bfloat16, torch.float32) or \
            any(t.dtype != dt for t in tensors[1:5]):
        raise ValueError("attn_step_split: q and caches share bf16 or f32")
    if pad_lens.dtype != torch.int32 or pad_lens.shape != (B,):
        raise ValueError("attn_step_split: pad_lens must be int32 [B]")
    if anc is not None and (anc.dtype != torch.int32
                            or anc.shape != (B, K, G)):
        raise ValueError("attn_step_split: anc must be int32 [B, K, G]")
    shape = attn_step_split_launch(B, K, Pp, G, D, dk)
    if shape["smem"] > SMEM_LIMIT:
        raise ValueError(
            f"attn_step_split: K={K} beams over Pp={Pp} + K*G={K * G} "
            f"columns need {shape['smem']} bytes of shared memory per block, "
            f"past the {SMEM_LIMIT} bytes (227 KB) a block may use")
    out = torch.empty((BK, 1, D), dtype=torch.float32, device=q_eff.device)
    lib = build.load("attn_step_split")
    rc = lib.attn_step_split(
        q_eff.data_ptr(), k_prompt.data_ptr(), v_prompt.data_ptr(),
        k_gen.data_ptr(), v_gen.data_ptr(), pad_lens.data_ptr(),
        anc.data_ptr() if anc is not None else None, slot_ptr,
        out.data_ptr(), B, K, Pp, G, D, dk, slot, shape["cluster"],
        int(dt == torch.bfloat16), _stream())
    LAUNCHES["attn_step_split"] += 1
    _check_rc("attn_step_split", rc)
    return out


# ---------------------------------------------------------------------------
# attn_step_split_bias (tools/bisect_attn_split.py:58, the body at
# pallas_kernels.py:270)
# ---------------------------------------------------------------------------

def attn_step_split_bias_plain(q: torch.Tensor, k_prompt: torch.Tensor,
                               v_prompt: torch.Tensor, k_gen: torch.Tensor,
                               v_gen: torch.Tensor, bias: torch.Tensor,
                               dk: int) -> torch.Tensor:
    """q [B, K, D] (dk**-0.5 folded, cache dtype); keys/values [prompt |
    generated] = [B, Pp, D] then [B, Ng, D]; bias [B, K, Pp + Ng] f32 ->
    [B, K, D] f32. Per head: f32 logits plus the bias, f32 max/exp/sum,
    weights normalized and then rounded to the value dtype, f32 p.v."""
    B, K, D = q.shape
    H = D // dk
    keys = torch.cat([k_prompt, k_gen], dim=1).float()
    vals = torch.cat([v_prompt, v_gen], dim=1)
    ncol = keys.shape[1]
    lg = torch.einsum("bjhd,bchd->bhjc", q.float().reshape(B, K, H, dk),
                      keys.reshape(B, ncol, H, dk)) + bias[:, None]
    p = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)).to(vals.dtype).float()
    out = torch.einsum("bhjc,bchd->bjhd", p,
                       vals.float().reshape(B, ncol, H, dk))
    return out.reshape(B, K, D)


SPLIT_BIAS_THREADS = 256     # threads per block of the CUDA kernel


def split_bias_smem(per: int, dk: int, esize: int, K: int, R: int) -> int:
    """Bytes of shared memory of one block (csrc/attn_step_split_bias.cu
    layout): mbarriers, queries, key rows, value rows, logits, the bf16
    path's bf16 weights or the f32 path's [8 warps, 8 beams, dk] partial
    outputs, the peers' partial outputs of its slice, stats."""
    return (_align(8 * (1 + -(-per // 32)), 128) + K * dk * esize
            + 2 * per * dk * esize + K * per * 4
            + (_align(K, 16) * (per + 8) * 2 if esize == 2 else 8 * 8 * dk * 4)
            + _align(R * -(-K * dk // R) * 4, 16) + 8 * K * (R + 1))


def attn_step_split_bias_launch(B: int, K: int, Pp: int, Ng: int, D: int,
                                dk: int, dtype: torch.dtype) -> dict:
    """Grid, cluster size, column shares and shared memory of the CUDA
    kernel: a cluster of R blocks per (head, stream) pair along x, grid
    (R, H, B); block r stages its share of the Pp + Ng columns' key and
    value rows and the stream's bias share in shared memory."""
    esize = 2 if dtype == torch.bfloat16 else 4
    ncol = Pp + Ng
    R = _cluster_size(ncol)
    per = _share_rows(ncol, R)
    return dict(grid=(R, D // dk, B), threads=SPLIT_BIAS_THREADS, cluster=R,
                per=per, smem=split_bias_smem(per, dk, esize, K, R),
                shares=split_shares(ncol, R))


def _split_bias_plan(q, k_prompt, v_prompt, k_gen, v_gen, bias,
                     dk: int) -> dict:
    """The wrapper's checks of what the CUDA kernel takes (shapes, dtypes,
    its shared memory), raising ValueError; returns the launch plan."""
    tensors = (q, k_prompt, v_prompt, k_gen, v_gen, bias)
    if q.dim() != 3:
        raise ValueError("attn_step_split_bias: q must be [B, K, D]")
    B, K, D = q.shape
    Pp, Ng = k_prompt.shape[1], k_gen.shape[1]
    ncol = Pp + Ng
    if k_prompt.shape != (B, Pp, D) or v_prompt.shape != k_prompt.shape or \
            k_gen.shape != (B, Ng, D) or v_gen.shape != k_gen.shape or \
            bias.shape != (B, K, ncol):
        raise ValueError("attn_step_split_bias: prompt [B, Pp, D], "
                         "generated [B, Ng, D], bias [B, K, Pp + Ng]")
    if K < 1 or ncol == 0 or not 0 < B <= 65535:
        raise ValueError(f"attn_step_split_bias: K={K} must be >= 1, "
                         f"Pp + Ng={ncol} nonzero, B={B} in [1, 65535]")
    if dk not in (64, 128) or D % dk:
        raise ValueError(f"attn_step_split_bias: dk={dk} with D={D}")
    dt = q.dtype
    if dt not in (torch.bfloat16, torch.float32) or \
            any(t.dtype != dt for t in tensors[1:5]) or \
            bias.dtype != torch.float32:
        raise ValueError("attn_step_split_bias: q and caches share bf16 or "
                         "f32, bias f32")
    plan = attn_step_split_bias_launch(B, K, Pp, Ng, D, dk, dt)
    if plan["smem"] > SMEM_LIMIT:
        raise ValueError(
            f"attn_step_split_bias: K={K} beams over {ncol} columns need "
            f"{plan['smem']} bytes of shared memory per block, past the "
            f"{SMEM_LIMIT} bytes (227 KB) a block may use")
    return plan


def attn_step_split_bias(q: torch.Tensor, k_prompt: torch.Tensor,
                         v_prompt: torch.Tensor, k_gen: torch.Tensor,
                         v_gen: torch.Tensor, bias: torch.Tensor,
                         dk: int) -> torch.Tensor:
    """attn_step_split's kernel body on the blocks its wrapper passes, with
    a general additive bias in place of the visibility mask.

    q: [B, K, D] the streams' beam queries (dk**-0.5 folded), cache dtype;
    k_prompt/v_prompt: [B, Pp, D]; k_gen/v_gen: [B, Ng, D] (the K
    generated segments of a stream laid out beam-major, Ng = K*G); bias:
    [B, K, Pp + Ng] f32 added to the f32 logits (-1e30 masks a column; a
    row masked everywhere averages the values uniformly). Any beam count K
    up to the kernel's shared memory. Returns [B, K, D] f32."""
    tensors = (q, k_prompt, v_prompt, k_gen, v_gen, bias)
    if not _on_card("attn_step_split_bias", *tensors):
        return attn_step_split_bias_plain(*tensors, dk)
    plan = _split_bias_plan(*tensors, dk)
    B, K, D = q.shape
    Pp, Ng = k_prompt.shape[1], k_gen.shape[1]
    out = torch.empty((B, K, D), dtype=torch.float32, device=q.device)
    lib = build.load("attn_step_split_bias")
    rc = lib.attn_step_split_bias(
        q.data_ptr(), k_prompt.data_ptr(), v_prompt.data_ptr(),
        k_gen.data_ptr(), v_gen.data_ptr(), bias.data_ptr(), out.data_ptr(),
        B, K, Pp, Ng, D, dk, plan["cluster"], int(q.dtype == torch.bfloat16),
        _stream())
    LAUNCHES["attn_step_split_bias"] += 1
    _check_rc("attn_step_split_bias", rc)
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


DWCONV_MAX_K = 33   # taps the CUDA kernel is instantiated for


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor, k: int
                     ) -> torch.Tensor:
    """'Same'-padded depthwise conv over time (TitaNet's channels-as-groups
    conv).

    x: [B, T, C] bf16 or f32 with C % 128 == 0; w: [k, C] f32 per-channel
    taps, 2 <= k <= 33. Returns [B, T, C] f32."""
    k = int(k)
    if not _on_card("depthwise_conv1d", x, w):
        return depthwise_conv1d_plain(x, w, k)
    if x.dim() != 3:
        raise ValueError("depthwise_conv1d: x must be [B, T, C]")
    B, T, C = x.shape
    if C % 128 or B == 0 or T == 0:
        raise ValueError(f"depthwise_conv1d: C={C} must be a multiple of "
                         "128 and B, T nonzero")
    if not 2 <= k <= DWCONV_MAX_K or w.shape != (k, C):
        raise ValueError(f"depthwise_conv1d: w must be [k, C] with "
                         f"2 <= k <= {DWCONV_MAX_K}, got {tuple(w.shape)} "
                         f"for k={k}")
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


MASKED_SCM_STAGES = 2        # buffers of 32 frames a warp keeps in flight
MASKED_SCM_WARPS = 4         # frequencies a block


def masked_scm_launch(B: int, F: int, K: int, M: int,
                      stages: int = MASKED_SCM_STAGES) -> dict:
    """Grid and shared memory of the CUDA kernel (csrc/masked_scm.cu): a
    warp per (b, f) pair, 4 a block, grid (ceil(F / 4), B); each warp's
    ring of `stages` buffers of 32 frames (x, then the K masks, each
    16-byte aligned) behind the blocks' 8 mbarriers a warp."""
    buf = _align(32 * M * 8, 16) + _align(32 * K * 4, 16)
    return dict(grid=(-(-F // MASKED_SCM_WARPS), B),
                threads=32 * MASKED_SCM_WARPS, stages=stages,
                smem=MASKED_SCM_WARPS * (8 * 8 + stages * buf))


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
                        B, F, T, K, M, MASKED_SCM_STAGES, _stream())
    LAUNCHES["masked_scm"] += 1
    _check_rc("masked_scm", rc)
    return out


# ---------------------------------------------------------------------------
# xattn_int8 (pallas_kernels.py:108)
# ---------------------------------------------------------------------------

def xattn_int8_plain(q_eff: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                     v_scale: torch.Tensor, dk: int,
                     s_valid: int) -> torch.Tensor:
    """q_eff [B, T, D] bf16 or f32 (k-scales and both dk**-0.25 factors
    folded);
    k8/v8 [B, S_pad, D] int8; v_scale [B, D] f32 -> [B, T, D] f32. Per
    head: f32 logits, -1e30 for keys >= s_valid, f32 max/exp/sum, weights
    normalized and THEN rounded to bf16, f32 p.v, times the v-scales."""
    B, T, D = q_eff.shape
    S = k8.shape[1]
    H = D // dk
    qh = q_eff.float().reshape(B, T, H, dk)
    kh = k8.float().reshape(B, S, H, dk)
    lg = torch.einsum("bthd,bshd->bhts", qh, kh)
    masked = torch.arange(S, device=q_eff.device) >= s_valid
    lg = lg.masked_fill(masked, MASKED)
    p = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)).to(torch.bfloat16).float()
    out = torch.einsum("bhts,bshd->bthd", p, v8.float().reshape(B, S, H, dk))
    return out.reshape(B, T, D) * v_scale[:, None, :]


XATTN_THREADS = 128          # threads per block of the CUDA kernel


# (head, row) pairs from which xattn_int8 takes a block per row: 4 blocks
# of 256 threads on each of the H100's 132 SMs, the card full in one wave
XATTN_ROW_PAIRS = 4 * 132
XATTN_ROW_THREADS = 256


def xattn_int8_smem(per: int, dk: int, T: int, R: int, qsize: int) -> int:
    """Bytes of shared memory of one cluster block (csrc/xattn_int8.cu
    layout): mbarriers, queries of qsize bytes, int8 key and value rows,
    logits, the [4 warps, T, dk] partial outputs, the peers' partial
    outputs of its slice, stats."""
    return (_align(8 * (1 + -(-per // 32)), 128) + T * dk * qsize
            + 2 * per * dk + T * per * 4 + 4 * T * dk * 4
            + _align(R * -(-T * dk // R) * 4, 16) + 8 * T * (R + 1))


def xattn_int8_launch(B: int, T: int, S_pad: int, D: int, dk: int,
                      s_valid: int, dtype: torch.dtype) -> dict:
    """Grid, cluster size, key shares and shared memory of the CUDA kernel
    for queries of `dtype`, from the grid and S_pad (never from s_valid).
    Few (head, row) pairs: a cluster of R >= 2 blocks along x per pair,
    grid (R, H, B), block r staging its share of the s_valid keys' int8
    key and value rows in shared memory. From XATTN_ROW_PAIRS pairs on
    (greedy's 48 rows), or where S_pad gives one share: R = 1, a block of
    256 threads streams a whole row, grid (H, B)."""
    H = D // dk
    R = _cluster_size(S_pad)
    if H * B >= XATTN_ROW_PAIRS or R == 1:
        return dict(grid=(H, B), threads=XATTN_ROW_THREADS, cluster=1,
                    per=S_pad, smem=(T * dk + T * S_pad + 8 * T * dk) * 4,
                    shares=split_shares(s_valid, 1))
    qsize = 2 if dtype == torch.bfloat16 else 4
    per = _share_rows(S_pad, R)
    return dict(grid=(R, H, B), threads=XATTN_THREADS, cluster=R, per=per,
                smem=xattn_int8_smem(per, dk, T, R, qsize),
                shares=split_shares(s_valid, R))


def _xattn_int8_plan(q_eff, k8, v8, v_scale, dk: int, s_valid: int) -> dict:
    """The wrapper's checks of what the CUDA kernel takes (shapes, dtypes,
    its shared memory), raising ValueError; returns the launch plan."""
    if q_eff.dim() != 3 or k8.dim() != 3:
        raise ValueError("xattn_int8: q [B, T, D], k8/v8 [B, S_pad, D]")
    B, T, D = q_eff.shape
    S_pad = k8.shape[1]
    if k8.shape != (B, S_pad, D) or v8.shape != k8.shape or \
            v_scale.shape != (B, D):
        raise ValueError("xattn_int8: k8/v8 [B, S_pad, D], v_scale [B, D]")
    if q_eff.dtype not in (torch.bfloat16, torch.float32) or \
            k8.dtype != torch.int8 or v8.dtype != torch.int8 or \
            v_scale.dtype != torch.float32:
        raise ValueError("xattn_int8: q bf16 or f32, k8/v8 int8, "
                         "v_scale f32")
    if not 1 <= T <= 8 or S_pad % 32 or not 0 < s_valid <= S_pad:
        raise ValueError(f"xattn_int8: T={T} must be in [1, 8], "
                         f"S_pad={S_pad} a multiple of 32, 0 < s_valid="
                         f"{s_valid} <= S_pad")
    if dk not in (64, 128) or D % dk or not 0 < B <= 65535:
        raise ValueError(f"xattn_int8: dk={dk} with D={D}, B={B}")
    plan = xattn_int8_launch(B, T, S_pad, D, dk, s_valid, q_eff.dtype)
    if plan["smem"] > SMEM_LIMIT:
        raise ValueError(f"xattn_int8: S_pad={S_pad} needs {plan['smem']} "
                         "bytes of shared memory per block (227 KB)")
    return plan


def xattn_int8(q_eff: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
               v_scale: torch.Tensor, dk: int, s_valid: int) -> torch.Tensor:
    """Fused cross-attention against int8 K/V memory (int8 decode steps).

    q_eff: [B, T, D] bf16 (f32 for the f32 parity model), T <= 8, with the
    per-channel k-scales and both dk**-0.25 factors folded in; k8/v8:
    [B, S_pad, D] int8, S_pad a multiple of 32, zero past s_valid;
    v_scale: [B, D] f32. Returns [B, T, D] f32 (pre-out-projection,
    v-scales applied)."""
    s_valid = int(s_valid)
    if not _on_card("xattn_int8", q_eff, k8, v8, v_scale):
        return xattn_int8_plain(q_eff, k8, v8, v_scale, dk, s_valid)
    plan = _xattn_int8_plan(q_eff, k8, v8, v_scale, dk, s_valid)
    B, T, D = q_eff.shape
    out = torch.empty((B, T, D), dtype=torch.float32, device=q_eff.device)
    lib = build.load("xattn_int8")
    rc = lib.xattn_int8(q_eff.data_ptr(), k8.data_ptr(), v8.data_ptr(),
                        v_scale.data_ptr(), out.data_ptr(), B, T,
                        k8.shape[1], D, dk, s_valid, plan["cluster"],
                        int(q_eff.dtype == torch.bfloat16), _stream())
    LAUNCHES["xattn_int8"] += 1
    _check_rc("xattn_int8", rc)
    return out


# ---------------------------------------------------------------------------
# xattn_stream (tools/bench_xattn_variants.py:53, run_stream)
# ---------------------------------------------------------------------------

def xattn_stream_plain(k8: torch.Tensor, v8: torch.Tensor):
    """k8/v8 [B, S, D] int8 -> (out [B, 1, D] f32, checksum [B] int32):
    out = 1e-6 * (sum of rows 0-7 of k8 + those of v8), the integer sums
    exact and one f32 rounding; checksum = the sum of all of a row's K and
    V bytes, mod 2**32."""
    n = min(8, k8.shape[1])
    head = k8[:, :n].sum(dim=1, dtype=torch.int32) + \
        v8[:, :n].sum(dim=1, dtype=torch.int32)
    checksum = k8.sum(dim=(1, 2), dtype=torch.int32) + \
        v8.sum(dim=(1, 2), dtype=torch.int32)
    return head.float()[:, None, :] * 1e-6, checksum


def xattn_stream(k8: torch.Tensor, v8: torch.Tensor):
    """The streaming floor of xattn_int8: reads every byte of the int8
    K/V memory k8/v8 [B, S, D] (D % 16 == 0) and returns
    (out [B, 1, D] f32, checksum [B] int32) as xattn_stream_plain. The
    checksum is what makes the kernel consume every byte it loads."""
    if not _on_card("xattn_stream", k8, v8):
        return xattn_stream_plain(k8, v8)
    if k8.dim() != 3 or v8.shape != k8.shape:
        raise ValueError("xattn_stream: k8/v8 [B, S, D] of one shape")
    B, S, D = k8.shape
    if k8.dtype != torch.int8 or v8.dtype != torch.int8:
        raise ValueError("xattn_stream: k8/v8 int8")
    if D % 16 or not 0 < B <= 65535 or S == 0:
        raise ValueError(f"xattn_stream: D={D} must be a multiple of 16, "
                         f"B={B} in [1, 65535], S nonzero")
    out = torch.empty((B, 1, D), dtype=torch.float32, device=k8.device)
    checksum = torch.zeros(B, dtype=torch.int32, device=k8.device)
    lib = build.load("xattn_stream")
    rc = lib.xattn_stream(k8.data_ptr(), v8.data_ptr(), out.data_ptr(),
                          checksum.data_ptr(), B, S, D, _stream())
    LAUNCHES["xattn_stream"] += 1
    _check_rc("xattn_stream", rc)
    return out, checksum


# ---------------------------------------------------------------------------
# xattn_onedot (tools/bench_xattn_variants.py:96, onedot)
# ---------------------------------------------------------------------------

def xattn_onedot_plain(q: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                       v_scale: torch.Tensor, dk: int,
                       s_valid: int) -> torch.Tensor:
    """q [B, 1, D] (rounded to bf16, as the tool's head-masked query is);
    k8/v8 [B, S, D] int8; v_scale [B, D] f32 -> [B, 1, D] f32. Per head
    h: f32 logits, -1e30 for keys >= s_valid, f32 max/exp/sum, p[h] =
    bf16(exp / sum). Value pass: lane d takes the weights of head d % H
    (the tool tiles the [S, H] weights dk times along the lanes), each
    product v * p rounded to bf16, the products summed in f32, times the
    v-scales."""
    B, _, D = q.shape
    S = k8.shape[1]
    H = D // dk
    qh = q.to(torch.bfloat16).float().reshape(B, H, dk)
    lg = torch.einsum("bhd,bshd->bhs", qh, k8.float().reshape(B, S, H, dk))
    lg = lg.masked_fill(torch.arange(S, device=q.device) >= s_valid, MASKED)
    p = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)).to(torch.bfloat16).float()
    lane_p = p[:, torch.arange(D, device=q.device) % H].transpose(1, 2)
    prod = (v8.float() * lane_p).to(torch.bfloat16).float()     # [B, S, D]
    return prod.sum(dim=1, keepdim=True) * v_scale[:, None, :]


ONEDOT_THREADS = 512         # threads per block of the CUDA kernel


def xattn_onedot_launch(B: int, S: int, D: int, dk: int,
                        s_valid: int) -> dict:
    """Grid, cluster size, key shares and shared memory of the CUDA kernel
    (csrc/xattn_onedot.cu): a cluster of R blocks along x per row, grid (R,
    B), R from S (_cluster_size: 8 at the tool's 1504 keys); block r holds
    every head's logits of its share of the s_valid keys ([H][SP], SP odd),
    its key subsets' partial outputs, the peers' partial outputs of its
    slice and the stats."""
    H = D // dk
    R = _cluster_size(S)
    SP = -(-s_valid // R) | 1
    ksub = ONEDOT_THREADS // (D // 8)
    stats = _align(D + H * SP + ksub * D + R * -(-D // R), 2)
    return dict(grid=(R, B), threads=ONEDOT_THREADS, cluster=R,
                shares=split_shares(s_valid, R),
                smem=4 * (stats + 2 * (R + 1) * H))


def xattn_onedot(q: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                 v_scale: torch.Tensor, dk: int, s_valid: int) -> torch.Tensor:
    """The one-matmul variant of xattn_int8 that the kernel-decomposition
    tool times, at one query per row: the value pass rounds each product
    (bf16(v * p), summed in f32), and lane d takes head d % H's weights,
    as the tool's pltpu.repeat (a tile) gives them, so it is not
    xattn_int8's attention (see xattn_onedot_plain).

    q: [B, 1, D] bf16 (k-scales and both dk**-0.25 folded); k8/v8:
    [B, S, D] int8; v_scale: [B, D] f32; keys >= s_valid are masked;
    D <= 4096. Returns [B, 1, D] f32."""
    s_valid = int(s_valid)
    if not _on_card("xattn_onedot", q, k8, v8, v_scale):
        return xattn_onedot_plain(q, k8, v8, v_scale, dk, s_valid)
    if q.dim() != 3 or k8.dim() != 3:
        raise ValueError("xattn_onedot: q [B, 1, D], k8/v8 [B, S, D]")
    B, T, D = q.shape
    S = k8.shape[1]
    if T != 1 or k8.shape != (B, S, D) or v8.shape != k8.shape or \
            v_scale.shape != (B, D):
        raise ValueError("xattn_onedot: q [B, 1, D], k8/v8 [B, S, D], "
                         "v_scale [B, D]")
    if q.dtype != torch.bfloat16 or k8.dtype != torch.int8 or \
            v8.dtype != torch.int8 or v_scale.dtype != torch.float32:
        raise ValueError("xattn_onedot: q bf16, k8/v8 int8, v_scale f32")
    if dk not in (64, 128) or D % dk or D > 4096 or \
            not 0 < B <= 65535 or not 0 < s_valid <= S:
        raise ValueError(f"xattn_onedot: dk={dk} with D={D} <= 4096, B={B} "
                         f"in [1, 65535], 0 < s_valid={s_valid} <= S={S}")
    plan = xattn_onedot_launch(B, S, D, dk, s_valid)
    if plan["smem"] > SMEM_LIMIT:
        raise ValueError(f"xattn_onedot: S={S} needs {plan['smem']} bytes of "
                         "shared memory per block (227 KB)")
    out = torch.empty((B, 1, D), dtype=torch.float32, device=q.device)
    lib = build.load("xattn_onedot")
    rc = lib.xattn_onedot(q.data_ptr(), k8.data_ptr(), v8.data_ptr(),
                          v_scale.data_ptr(), out.data_ptr(), B, S, D, dk,
                          s_valid, plan["cluster"], _stream())
    LAUNCHES["xattn_onedot"] += 1
    _check_rc("xattn_onedot", rc)
    return out


# ---------------------------------------------------------------------------
# xattn_step (the float branch of MHA._attend_precomputed,
# notsofar_tpu/models/whisper.py:324-335, two XLA einsums there)
# ---------------------------------------------------------------------------

XATTN_STEP_MAX_TQ = 8        # folded query lengths the kernel serves
XATTN_STEP_THREADS = 128     # threads per block of the CUDA kernel


def xattn_step_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     dk: int) -> torch.Tensor:
    """q [B, Tq, D], k/v [B, S, D], one dtype (bf16 or f32) -> [B, Tq, D]
    in that dtype: per head, f32 logits of dtype(q * dk**-0.25) and
    dtype(k * dk**-0.25), f32 softmax, weights rounded to the dtype, f32
    p.v, the output rounded to the dtype (the model's matmul path)."""
    B, Tq, D = q.shape
    S = k.shape[1]
    H = D // dk
    scale = dk ** -0.25
    qh = q.reshape(B, Tq, H, dk).transpose(1, 2)
    kh = k.reshape(B, S, H, dk).transpose(1, 2)
    vh = v.reshape(B, S, H, dk).transpose(1, 2)
    logits = torch.matmul((qh * scale).float(),
                          (kh * scale).float().transpose(-1, -2))
    w = torch.softmax(logits, dim=-1)
    out = torch.matmul(w.to(q.dtype).float(), vh.to(q.dtype).float())
    return out.transpose(1, 2).reshape(B, Tq, D).to(q.dtype)


def xattn_step_smem(per: int, dk: int, esize: int, T: int, R: int) -> int:
    """Bytes of shared memory of one block (csrc/xattn_step.cu layout):
    mbarriers, the raw queries, key rows, value rows, logits, the [4
    warps, T, dk] partial outputs (the FMA p.v: f32, or one query), the
    peers' partial outputs of its slice, stats."""
    red = 4 * T * dk * 4 if esize == 4 or T == 1 else 0
    return (_align(8 * (1 + -(-per // 32)), 128) + T * dk * esize
            + 2 * per * dk * esize + T * per * 4 + red
            + _align(R * -(-T * dk // R) * 4, 16) + 8 * T * (R + 1))


def xattn_step_launch(B: int, T: int, S: int, D: int, dk: int,
                      dtype: torch.dtype) -> dict:
    """Grid, cluster size, key shares and shared memory of the CUDA kernel
    from the shapes alone: a cluster of R blocks along x per (head,
    window) pair, grid (R, H, B), block r staging its share of the S keys'
    key and value rows in shared memory. R = _cluster_size(S): 8 wherever
    S gives 8 shares of 32 keys, fewer where it does not, more where a
    share would not fit a block's shared memory. Of R = 1-8 as 32
    launches in one CUDA graph against 1500 frames (phase 2's sweep at 3
    windows, tools/time_decode_step.py's at 1, 2 and 3), R = 8 was the
    fastest at Tq 1 and 5 at each of them."""
    esize = 2 if dtype == torch.bfloat16 else 4
    R = _cluster_size(S)
    while True:
        per = _share_rows(S, R)
        smem = xattn_step_smem(per, dk, esize, T, R)
        if smem <= SMEM_LIMIT or R == SPLIT_MAX_CLUSTER:
            break
        R += 1
    return dict(grid=(R, D // dk, B), threads=XATTN_STEP_THREADS, cluster=R,
                per=per, smem=smem, shares=split_shares(S, R))


def _xattn_step_plan(q, k, v, dk: int) -> dict:
    """The wrapper's checks of what the CUDA kernel takes (shapes, dtypes,
    its shared memory), raising ValueError; returns the launch plan."""
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError("xattn_step: q [B, Tq, D], k/v [B, S, D]")
    B, T, D = q.shape
    S = k.shape[1]
    if k.shape != (B, S, D) or v.shape != k.shape:
        raise ValueError("xattn_step: q [B, Tq, D], k/v [B, S, D]")
    dt = q.dtype
    if dt not in (torch.bfloat16, torch.float32) or k.dtype != dt or \
            v.dtype != dt:
        raise ValueError("xattn_step: q, k and v share bf16 or f32")
    if not 1 <= T <= XATTN_STEP_MAX_TQ or S == 0:
        raise ValueError(f"xattn_step: Tq={T} must be in [1, "
                         f"{XATTN_STEP_MAX_TQ}], S={S} nonzero")
    if dk not in (64, 128) or D % dk or not 0 < B <= 65535:
        raise ValueError(f"xattn_step: dk={dk} with D={D}, B={B}")
    plan = xattn_step_launch(B, T, S, D, dk, dt)
    if plan["smem"] > SMEM_LIMIT:
        raise ValueError(f"xattn_step: S={S} needs {plan['smem']} bytes of "
                         "shared memory per block (227 KB)")
    return plan


def xattn_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               dk: int) -> torch.Tensor:
    """Fused cross-attention of a decode step against the float memory.

    q: [B, Tq, D] queries (the beams of a window folded into Tq <= 8),
    unscaled; k/v: [B, S, D] the precomputed cross-attention memory, in
    q's dtype (bf16 or f32). Returns [B, Tq, D] in that dtype, the
    pre-out-projection attention output (no weights)."""
    if not _on_card("xattn_step", q, k, v):
        return xattn_step_plain(q, k, v, dk)
    plan = _xattn_step_plan(q, k, v, dk)
    B, T, D = q.shape
    out = torch.empty_like(q)
    lib = build.load("xattn_step")
    rc = lib.xattn_step(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), B, T, k.shape[1], D, dk,
                        dk ** -0.25, plan["cluster"],
                        int(q.dtype == torch.bfloat16), _stream())
    LAUNCHES["xattn_step"] += 1
    _check_rc("xattn_step", rc)
    return out


# ---------------------------------------------------------------------------
# decode_gemv (every dense layer of the decode step and the logits, with the
# layer norms, GELU, residual adds, query scale and cache writes around
# them: notsofar_tpu/models/whisper.py :76-97, :346-368, :502-507, one XLA
# program there)
# ---------------------------------------------------------------------------

DECODE_GEMV_MAX_ROWS = 64    # rows of x the kernel serves (8 tiles of 8)
DECODE_GEMV_THREADS = 128    # threads per block of the CUDA kernel
DECODE_GEMV_CHANNELS = 64    # output channels of a block (4 warps x 16)
DECODE_GEMV_FILL = 2 * 132   # blocks the cluster size aims at (2 an SM)
DECODE_GEMV_SMEM_AIM = 96 * 1024   # a block's shared memory R aims under
_GEMV_TILES = (1, 2, 4, 6, 8)   # tiles of 8 rows the kernel is built for
_GEMV_LN_ITEMS = 32             # 8-element items of a stats chunk


# an optional last step of the dense mode: (s, p [G, N] f32, rows per
# group), y -> dtype((y * s) * p[row // rows]) in f32
Post = Tuple[float, torch.Tensor, int]


class GemvLN(NamedTuple):
    """A layer norm that decode_gemv applies to x before the product:
    weight and bias [K] (bf16 or f32, one dtype), eps; x is the raw
    residual stream."""
    weight: torch.Tensor
    bias: torch.Tensor
    eps: float


# one weight of a grouped launch: (weight [N, K], scale [N] f32 or None,
# bias [N] or None)
Dense = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]


def layer_norm_plain(x: torch.Tensor, ln: GemvLN) -> torch.Tensor:
    """models/whisper.py LayerNorm: F.layer_norm over the last axis in the
    promoted dtype of x and the parameters (an f32 stream with bf16
    parameters is normalized in f32 with the parameters' values)."""
    dt = torch.promote_types(x.dtype, ln.weight.dtype)
    w, b = ln.weight, ln.bias
    if w.dtype != dt:
        w, b = w.to(dt), b.to(dt)
    return F.layer_norm(x.to(dt), (x.shape[-1],), w, b, ln.eps)


def decode_gemv_plain(x: torch.Tensor, weight: torch.Tensor,
                      dtype: torch.dtype, scale: Optional[torch.Tensor] = None,
                      bias: Optional[torch.Tensor] = None,
                      logits: bool = False,
                      out_dtype: Optional[torch.dtype] = None,
                      post: Optional[Post] = None,
                      ln: Optional[GemvLN] = None, gelu: bool = False,
                      residual: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """x [..., K] times weight [N, K] (int8 or bf16) -> [..., N]: the port's
    unfused sequence of PyTorch ops, each rounding point where the model
    puts it.

    ln: x = layer_norm_plain(x, ln) first. Dense (QuantDense and flax
    nn.Dense's rounding points): acc = f32 sum of dtype(x) * w, y =
    dtype(acc), then dtype(y * dtype(scale)), then dtype(y + dtype(bias));
    with post (s, p, rows), then dtype((y * s) * p[row // rows]) in f32
    (the int8 cross-attention's query folding: ((q * s) * (k_scale * s))
    rounded); gelu: then F.gelu (exact); residual: returns residual + y in
    the residual's dtype; else returns dtype, or out_dtype (f32) holding
    those values. Logits: the f32 sum of dtype(x) * w, times the f32 scale
    where given; returns f32."""
    if ln is not None:
        x = layer_norm_plain(x, ln)
    acc = torch.matmul(x.to(dtype).float(), weight.float().T)
    if logits:
        return acc if scale is None else acc * scale
    y = acc.to(dtype)
    if scale is not None:
        y = y * scale.to(dtype)
    if bias is not None:
        y = y + bias.to(dtype)
    if post is not None:
        s, p, rows = post
        ps = p.repeat_interleave(rows, dim=0).reshape(y.shape)
        y = ((y.float() * s) * ps).to(dtype)
    if gelu:
        y = F.gelu(y)
    if residual is not None:
        return residual + y.to(residual.dtype)
    return y if out_dtype is None else y.to(out_dtype)


def decode_qkv_plain(x: torch.Tensor, ln: Optional[GemvLN],
                     layers: Sequence[Dense], dtype: torch.dtype,
                     k_cache: torch.Tensor, v_cache: torch.Tensor, slot: Slot,
                     q_scale: float) -> torch.Tensor:
    """The self-attention's projections of a single-token step as the
    model ran them unfused: h = layer_norm(x); q, k, v = the three dense
    layers of h (decode_gemv_plain's dense mode); k and v written into the
    caches [B, ctx, N] at `slot` (index_copy_ for a device slot), in the
    caches' dtype; returns q_eff = (q * q_scale) in the caches' dtype
    [B, 1, N] (what attn_step / attn_step_split take)."""
    h = x if ln is None else layer_norm_plain(x, ln)
    q, k, v = (decode_gemv_plain(h, w, dtype, s, b) for w, s, b in layers)
    for cache, y in ((k_cache, k), (v_cache, v)):
        if isinstance(slot, torch.Tensor):
            cache.index_copy_(1, slot.reshape(1).long(), y.to(cache.dtype))
        else:
            cache[:, slot] = y[:, 0].to(cache.dtype)
    return (q * q_scale).to(k_cache.dtype)


def _gemv_chunk(wdtype: torch.dtype) -> int:
    """k of a 64-byte chunk of a weight row (csrc/decode_gemv.cu)."""
    return 64 if wdtype == torch.int8 else 32


def _gemv_ln_chunks(slen: int) -> int:
    """csrc/decode_gemv.cu ln_chunks: stats chunks of a row of slen."""
    return -(-(slen // 8) // _GEMV_LN_ITEMS)


def decode_gemv_smem(rows_pad: int, klen: int, wdtype: torch.dtype,
                     planes: int, M: int, R: int, ln: bool = False) -> int:
    """Bytes of shared memory of one block (csrc/decode_gemv.cu layout):
    x's share of K as `planes` bf16 planes of rows_pad rows (the row stride
    padded off the banks of the next row), the peers' partial outputs of
    its slice, its channels' scale and bias; with the layer norm, its share
    of the norm's parameters (f32), the stats chunks, the peers' share
    stats and each row's (mean, rstd)."""
    stride = _align(klen, 64) + (8 if wdtype == torch.int8 else 32)
    nout = M * DECODE_GEMV_CHANNELS
    b = (planes * rows_pad * stride * 2 + _align(R * -(-nout // R) * 4, 16)
         + 2 * DECODE_GEMV_CHANNELS * 4)
    if ln:
        b += 2 * klen * 4 + M * _gemv_ln_chunks(klen) * 8 + R * M * 8 + M * 8
    return b


def decode_gemv_launch(M: int, N: Union[int, Sequence[int]], K: int,
                       wdtype: torch.dtype, planes: int, ln: bool = False,
                       R: Optional[int] = None) -> dict:
    """Grid, cluster size, K shares and shared memory of the CUDA kernel
    for x [M, K] and the weights [N_s, K] (N one width or the segments'
    widths, laid out along y): ceil(N_s / 64) blocks of 64 channels per
    segment along y; a cluster of R blocks along x splits K's 64-byte
    chunks into R shares, R the fewest that put DECODE_GEMV_FILL blocks on
    the card (at most 8 and the chunk count), more where a block's x would
    take more than DECODE_GEMV_SMEM_AIM bytes; tiles of 8 rows from the
    kernel's instances. (chip_smoke.py phase 2, 32 launches in a CUDA
    graph at 3, 15 and 48 rows, on two cards: R = 8 for 1280 -> 1280 and
    5120 -> 1280, 4-5 for 1280 -> 5120 and the q/k/v launch, 1 for the
    logits at 3-15 rows and 2 at 48 were the fastest or within 10% of
    it; an aim of 3 blocks an SM picked R = 7 for q/k/v, 1.7x slower.)
    R may be given (phase 2's sweeps). Memoized: a decode step asks for
    the same few plans at every launch."""
    return _gemv_plan((N,) if isinstance(N, int) else tuple(N), M, K,
                      wdtype, planes, ln, R)


@functools.lru_cache(maxsize=512)
def _gemv_plan(widths: Tuple[int, ...], M: int, K: int, wdtype: torch.dtype,
               planes: int, ln: bool, R: Optional[int]) -> dict:
    nck = K // _gemv_chunk(wdtype)
    tiles = sum(-(-n // DECODE_GEMV_CHANNELS) for n in widths)
    nt = next(t for t in _GEMV_TILES if 8 * t >= M)

    def smem(r):
        return decode_gemv_smem(8 * nt, -(-nck // r) * _gemv_chunk(wdtype),
                                wdtype, planes, M, r, ln)

    if R is None:
        R = max(1, min(SPLIT_MAX_CLUSTER, nck,
                       -(-DECODE_GEMV_FILL // tiles)))
        while smem(R) > DECODE_GEMV_SMEM_AIM and \
                R < min(SPLIT_MAX_CLUSTER, nck):
            R += 1
    return dict(grid=(R, tiles), threads=DECODE_GEMV_THREADS, cluster=R,
                tiles=nt, planes=planes, smem=smem(R),
                shares=split_shares(nck, R))


def uses_decode_gemv(rows: int, wdtype: torch.dtype) -> bool:
    """Whether rows of activations times a weight stored as `wdtype` go
    through decode_gemv: a decode step's few rows (at most
    DECODE_GEMV_MAX_ROWS) against int8 or bf16 weights."""
    return rows <= DECODE_GEMV_MAX_ROWS and wdtype in (torch.int8,
                                                        torch.bfloat16)


def _check_ln(ln: Optional[GemvLN], K: int, device) -> None:
    if ln is not None and (
            ln.weight.shape != (K,) or ln.bias.shape != (K,)
            or ln.weight.dtype not in (torch.bfloat16, torch.float32)
            or ln.bias.dtype != ln.weight.dtype
            or ln.weight.device != device):
        raise ValueError("decode_gemv: the layer norm's weight and bias "
                         "[K], one dtype, bf16 or f32")


def _decode_gemv_plan(x, weight, dtype, scale, bias, logits,
                      out_dtype=None, post: Optional[Post] = None,
                      ln: Optional[GemvLN] = None, gelu: bool = False,
                      residual: Optional[torch.Tensor] = None,
                      widths: Optional[Sequence[int]] = None) -> dict:
    """The wrapper's checks of what the CUDA kernel takes (shapes, dtypes,
    its shared memory), raising ValueError; returns the launch plan."""
    if weight.dim() != 2 or x.dim() < 1 or x.shape[-1] != weight.shape[1]:
        raise ValueError("decode_gemv: x [..., K], weight [N, K]")
    N, K = weight.shape
    M = x.numel() // K if K else 0
    if not 1 <= M <= DECODE_GEMV_MAX_ROWS or K % 64 or K == 0 or \
            not 0 < N <= 65535 * 64:
        raise ValueError(f"decode_gemv: {M} rows must be in [1, "
                         f"{DECODE_GEMV_MAX_ROWS}], K={K} a multiple of 64, "
                         f"N={N} in [1, {65535 * 64}]")
    if weight.dtype not in (torch.int8, torch.bfloat16) or \
            x.dtype not in (torch.bfloat16, torch.float32) or \
            dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("decode_gemv: weight int8 or bf16, x and the "
                         "compute dtype bf16 or f32")
    if scale is not None and (scale.dtype != torch.float32
                              or scale.shape != (N,)):
        raise ValueError("decode_gemv: scale must be f32 [N]")
    if bias is not None and (logits or bias.shape != (N,) or bias.dtype
                             not in (torch.bfloat16, torch.float32)):
        raise ValueError("decode_gemv: bias bf16 or f32 [N], dense only")
    if out_dtype not in (None, torch.float32) or \
            (out_dtype is not None and (logits or residual is not None)):
        raise ValueError("decode_gemv: out_dtype None or f32, dense only, "
                         "no residual")
    if post is not None:
        _, p, rows = post
        if logits or out_dtype is not None or rows < 1 or M % rows or \
                p.dtype != torch.float32 or p.shape != (M // rows, N) or \
                p.device != x.device or not p.is_contiguous():
            raise ValueError("decode_gemv: post (s, p [rows / group, N] f32 "
                             "contiguous, group) with dense, dtype output")
    if (gelu or residual is not None) and logits:
        raise ValueError("decode_gemv: gelu and residual are dense only")
    if residual is not None and (
            residual.shape != (*x.shape[:-1], N)
            or residual.dtype not in (torch.bfloat16, torch.float32)):
        raise ValueError("decode_gemv: residual [..., N] bf16 or f32")
    _check_ln(ln, K, x.device)
    # the staged x: the layer norm's output in the promoted dtype; f32 in
    # f32 compute takes three exact bf16 planes
    xdt = x.dtype if ln is None else torch.promote_types(x.dtype,
                                                         ln.weight.dtype)
    planes = 3 if xdt == dtype == torch.float32 else 1
    plan = decode_gemv_launch(M, widths or N, K, weight.dtype, planes,
                              ln=ln is not None)
    if plan["smem"] > SMEM_LIMIT:
        raise ValueError(f"decode_gemv: {M} rows of K={K} need "
                         f"{plan['smem']} bytes of shared memory per block "
                         "(227 KB)")
    return plan


def _gemv_seg(weight, scale, bias, out, row_stride: int, residual=None,
              post: Optional[Post] = None, slot=None, logits=False,
              gelu=False, mul: float = 0.0) -> build.GemvSeg:
    def ptr(t):
        return None if t is None else t.data_ptr()
    return build.GemvSeg(
        w=weight.data_ptr(), scale=ptr(scale), bias=ptr(bias),
        out=out.data_ptr(), residual=ptr(residual),
        post=None if post is None else post[1].data_ptr(), slot=ptr(slot),
        row_stride=row_stride, n=weight.shape[0],
        b_f32=int(bias is not None and bias.dtype == torch.float32),
        out_bf16=int(out.dtype == torch.bfloat16), logits=int(logits),
        gelu=int(gelu), post_rows=1 if post is None else post[2],
        mul=mul, post_s=0.0 if post is None else post[0])


def _launch_decode_gemv(x: torch.Tensor, segs, dtype: torch.dtype,
                        wdtype: torch.dtype, ln: Optional[GemvLN],
                        plan: dict) -> int:
    """The C call of one launch (rc, not raised): x, the segments
    (build.GemvSeg), the layer norm, the plan's tiles, planes and cluster
    size; counts in no launch counter (phase 2's sweeps call it
    directly)."""
    K = x.shape[-1]
    arr = (build.GemvSeg * len(segs))(*segs)
    return build.load("decode_gemv").decode_gemv(
        x.data_ptr(), x.numel() // K, K, len(segs), ctypes.addressof(arr),
        None if ln is None else ln.weight.data_ptr(),
        None if ln is None else ln.bias.data_ptr(),
        0.0 if ln is None else ln.eps,
        int(ln is not None and ln.weight.dtype == torch.float32),
        int(ln is not None), plan["tiles"],
        plan["planes"], plan["cluster"], int(x.dtype == torch.float32),
        int(wdtype == torch.int8), int(dtype == torch.bfloat16), _stream())


def decode_gemv(x: torch.Tensor, weight: torch.Tensor, dtype: torch.dtype,
                scale: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None,
                logits: bool = False,
                out_dtype: Optional[torch.dtype] = None,
                post: Optional[Post] = None,
                ln: Optional[GemvLN] = None, gelu: bool = False,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A decode step's few rows times a weight matrix read once in its
    stored type, never widened in device memory, with the layer norm before
    it and the activation or residual add after it in the same launch.

    x: [..., K] bf16 or f32 (at most DECODE_GEMV_MAX_ROWS rows), the raw
    residual stream when ln is given, rounded to the compute dtype `dtype`
    (bf16 or f32) on the way in; weight: [N, K] int8 or bf16, K % 64 == 0;
    scale: [N] f32 or None; bias: [N] bf16 or f32 or None. Dense: returns
    [..., N] in `dtype`, the product rounded, then scaled, then biased,
    each rounded, then the optional post step and GELU (stored as f32 with
    out_dtype f32, for a caller that adds it to an f32 stream); with
    residual [..., N], returns residual + that in the residual's dtype.
    Logits: returns [..., N] f32, the f32 product times the scale where
    given (see decode_gemv_plain)."""
    tensors = [x, weight] + [t for t in (scale, bias, residual)
                             if t is not None]
    if post is not None:
        tensors.append(post[1])
    if ln is not None:
        tensors += [ln.weight, ln.bias]
    if not _on_card("decode_gemv", *tensors):
        return decode_gemv_plain(x, weight, dtype, scale, bias, logits,
                                 out_dtype, post, ln, gelu, residual)
    plan = _decode_gemv_plan(x, weight, dtype, scale, bias, logits, out_dtype,
                             post, ln, gelu, residual)
    N = weight.shape[0]
    odt = torch.float32 if logits else (
        residual.dtype if residual is not None else out_dtype or dtype)
    out = torch.empty((*x.shape[:-1], N), dtype=odt, device=x.device)
    seg = _gemv_seg(weight, scale, bias, out, N, residual, post,
                    logits=logits, gelu=gelu)
    rc = _launch_decode_gemv(x, [seg], dtype, weight.dtype, ln, plan)
    LAUNCHES["decode_gemv"] += 1
    _check_rc("decode_gemv", rc)
    return out


def decode_qkv(x: torch.Tensor, ln: Optional[GemvLN],
               layers: Sequence[Dense], dtype: torch.dtype,
               k_cache: torch.Tensor, v_cache: torch.Tensor, slot: Slot,
               q_scale: float) -> torch.Tensor:
    """The self-attention's q, k and v of a single-token decode step as one
    decode_gemv launch (three segments of the grid sharing x): x [B, 1, K]
    the raw residual stream, ln its layer norm, layers the query, key and
    value (weight, scale, bias) of one weight dtype; k and v are written
    into the caches [B, ctx, N] at `slot` (a host int, or a 0-d int32
    device tensor read by the kernel), in the caches' dtype; returns q_eff
    = (q * q_scale) in the caches' dtype, [B, 1, N] (decode_qkv_plain)."""
    tensors = [x, k_cache, v_cache] + [t for layer in layers for t in layer
                                       if t is not None]
    if ln is not None:
        tensors += [ln.weight, ln.bias]
    if isinstance(slot, torch.Tensor):
        tensors.append(slot)
    if not _on_card("decode_gemv", *tensors):
        return decode_qkv_plain(x, ln, layers, dtype, k_cache, v_cache, slot,
                                q_scale)
    if len(layers) != 3 or x.dim() != 3 or x.shape[1] != 1:
        raise ValueError("decode_qkv: x [B, 1, K] and three layers")
    wq = layers[0][0]
    B, N = x.shape[0], wq.shape[0]
    ctx = k_cache.shape[1]
    if any(w.shape != wq.shape or w.dtype != wq.dtype for w, _, _ in layers) \
            or k_cache.shape != (B, ctx, N) or v_cache.shape != (B, ctx, N) \
            or k_cache.dtype not in (torch.bfloat16, torch.float32) or \
            v_cache.dtype != k_cache.dtype:
        raise ValueError("decode_qkv: weights [N, K] of one dtype, caches "
                         "[B, ctx, N] of one dtype, bf16 or f32")
    if isinstance(slot, torch.Tensor):
        if slot.dtype != torch.int32 or slot.numel() != 1:
            raise ValueError("decode_qkv: a slot tensor is 0-d int32")
    else:
        if not 0 <= slot < ctx:
            raise ValueError(f"decode_qkv: slot {slot} outside [0, {ctx})")
        slot = torch.full((), slot, dtype=torch.int32, device=x.device)
    plan = _decode_gemv_plan(x, wq, dtype, *layers[0][1:], False, ln=ln,
                             widths=(N,) * 3)
    for _, s, b in layers[1:]:
        if s is not None and (s.dtype != torch.float32 or s.shape != (N,)) \
                or b is not None and (b.shape != (N,) or b.dtype not in
                                      (torch.bfloat16, torch.float32)):
            raise ValueError("decode_qkv: scale f32 [N], bias bf16 or f32 "
                             "[N]")
    q_eff = torch.empty((B, 1, N), dtype=k_cache.dtype, device=x.device)
    segs = [_gemv_seg(*layers[0], q_eff, N, mul=q_scale)]
    segs += [_gemv_seg(*layer, cache, ctx * N, slot=slot)
             for layer, cache in zip(layers[1:], (k_cache, v_cache))]
    rc = _launch_decode_gemv(x, segs, dtype, wq.dtype, ln, plan)
    LAUNCHES["decode_gemv"] += 1
    _check_rc("decode_gemv", rc)
    return q_eff
