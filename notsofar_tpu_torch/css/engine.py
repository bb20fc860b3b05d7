"""Continuous speech separation engine: whole sessions on the device.

Port of notsofar_tpu/css/engine.py (the reference separate_and_stitch).
A batch of sessions padded to a common segment bucket runs as one pass:

* int16 waveforms in, int16 separated streams out; the full-session STFT
  on the device, padded frames zeroed with ``torch.where`` (never by a
  multiply: -0 would give the raw-IPD features a phase of +-pi),
* every session's windows gathered per chunk of ``seg_chunk`` windows as
  adjacent pairs of hop-wide slots (segment == 2 hops), each chunk through
  the features, the Conformer and MVDR, written into tensors allocated
  before the loop,
* PIT stitching: all adjacent-pair loss matrices in one batched pass, then
  the chain over tiny [Sb, S, S] matrices on the host (argmin takes the
  first of tied permutations, as jnp.argmin does),
* trapezoid-weighted overlap-add on the slot grid, activity gating with
  max-pool morphology, iSTFT, and int16 quantization (round half to even,
  as jnp.round).

Big tensors keep the [.., S, F, T] layout of the JAX package.
"""
import contextlib
import itertools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from notsofar_tpu_torch.models.css_wrapper import CssModel
from notsofar_tpu_torch.ops.mvdr import mvdr_beamform
from notsofar_tpu_torch.ops.pit import BASE_LOSSES
from notsofar_tpu_torch.ops.stft import num_frames
from notsofar_tpu_torch.utils.morphology import dilate, erode
from notsofar_tpu_torch.utils.profiling import StageTimer


@dataclass
class CssCfg:
    """Mirror of CssCfg (the reference css/css.py); the JAX package's
    fields and defaults. `device` and `device_id` are accepted for YAML
    compatibility; the engine runs where its model lives."""
    segment_size_sec: float = 3.0
    hop_size_sec: float = 1.5
    normalize_segment_power: bool = False
    stitching_loss: str = "l1"          # 'l1' or 'mse'
    stitching_input: str = "mask"       # 'mask' or 'separation_result'
    seg_weight_m0_sec: float = 0.15
    seg_weight_m1_sec: float = 0.3
    activity_th: float = 0.4
    activity_dilation_sec: float = 0.4
    activity_erosion_sec: float = 0.2
    device: Optional[str] = None
    show_progressbar: bool = True
    checkpoint_sc: str = "notsofar/conformer1.0/sc"
    checkpoint_mc: str = "notsofar/conformer1.0/mc"
    device_id: int = 0
    num_spks: int = 3
    mc_mvdr: bool = True
    mc_mask_floor_db: float = 0.0
    sc_mask_floor_db: float = -math.inf
    pass_through_ch0: bool = False
    slice_audio_for_debug: bool = False
    seg_chunk: int = 32             # windows per Conformer + MVDR step
    seg_bucket_multiple: int = 16   # num_segments padded to a multiple
    compute_dtype: str = "bfloat16"  # Conformer compute dtype for serving
    use_pallas_scm: bool = False    # MVDR's masked SCM through the CUDA
    #   kernel (ops.kernels.masked_scm); default: the einsum, as in the
    #   JAX package
    batch_sessions: int = 4         # sessions separated per dispatch


def calc_segment_weight(seg_frames: int, m0: int, m1: int,
                        is_first: bool = False, is_last: bool = False
                        ) -> np.ndarray:
    """Trapezoid OLA weight (the reference calc_segment_weight)."""
    assert seg_frames > 2 * m1, (
        "not enough frames to fit weighting window. try modifying hop_size, "
        "segment_size or m0, m1")
    wg = np.ones(seg_frames, dtype=np.float32)
    wg[:m0] = 0.0
    wg[seg_frames - m0:] = 0.0
    linear = np.linspace(0.1, 1.0, m1 - m0, dtype=np.float32)
    wg[m0:m1] = linear
    wg[seg_frames - m1:seg_frames - m0] = linear[::-1]
    if is_first:
        wg[:m0] = 0.1
    if is_last:
        wg[seg_frames - m0:] = 0.1
    return wg


def build_weight_matrix(num_seg_real: int, num_seg_bucket: int,
                        seg_frames: int, m0: int, m1: int) -> np.ndarray:
    """[num_seg_bucket, seg_frames] OLA weights; padding rows are zero."""
    wg = np.zeros((num_seg_bucket, seg_frames), dtype=np.float32)
    for i in range(num_seg_real):
        wg[i] = calc_segment_weight(seg_frames, m0, m1,
                                    is_first=(i == 0),
                                    is_last=(i == num_seg_real - 1))
    return wg


def _quantize_int16(mix: np.ndarray) -> np.ndarray:
    """float [C, N] -> int16 at 32768 per unit (pre-scaled to peak 1.0
    when the input exceeds it)."""
    peak = float(np.abs(mix).max()) if mix.size else 0.0
    scaled = mix * (32768.0 / peak if peak > 1.0 else 32768.0)
    q = np.rint(scaled, out=scaled)
    np.clip(q, -32768, 32767, out=q)
    return q.astype(np.int16)


class CssEngine:
    """Binds a CssModel (weights on its device) and a config into a
    session separator."""

    def __init__(self, model: CssModel, cfg: CssCfg):
        self.model = model
        self.cfg = cfg
        self.device = model.device
        stft = model.extractor.stft
        self.frame_len = stft.frame_len
        self.frame_hop = stft.frame_hop

    # ---- geometry ------------------------------------------------------
    def seg_geometry(self, fs: int) -> Dict[str, int]:
        cfg = self.cfg
        seg_samples = int(cfg.segment_size_sec * fs)
        seg_frames = num_frames(seg_samples, self.frame_len, self.frame_hop)
        return dict(
            seg_frames=seg_frames,
            hop_frames=int(seg_frames * cfg.hop_size_sec / cfg.segment_size_sec),
            m0=int(seg_frames * cfg.seg_weight_m0_sec / cfg.segment_size_sec),
            m1=int(seg_frames * cfg.seg_weight_m1_sec / cfg.segment_size_sec),
            dilation=int(seg_frames * cfg.activity_dilation_sec / cfg.segment_size_sec),
            erosion=int(seg_frames * cfg.activity_erosion_sec / cfg.segment_size_sec),
        )

    # ---- the device pass -------------------------------------------------
    @torch.no_grad()
    def _process_core(self, wav_pad: torch.Tensor, wg: torch.Tensor,
                      valid_frames: torch.Tensor, num_seg: int,
                      seg_frames: int, hop_frames: int, dilation: int,
                      erosion: int, want_side_info: bool = True,
                      timer: Optional[StageTimer] = None):
        """wav_pad: [Sb, C, N_pad] int16 with N_pad giving exactly
        Tpad = (num_seg-1)*hop + T STFT frames; wg: [Sb, num_seg, T] f32;
        valid_frames: [Sb] int. Returns (wav_i16 [Sb, S, samples],
        scales [Sb, S], mask_stitched [Sb, S, F, Tpad] (empty without
        side info), activity [Sb, S, Tpad] bool), all on the device.
        timer: optional StageTimer for the stages stft, features,
        conformer, mvdr, stitch and istft."""
        cfg = self.cfg
        model = self.model

        def stage(name):
            return timer.stage(name) if timer is not None \
                else contextlib.nullcontext()

        Sb, C, _ = wav_pad.shape
        T = seg_frames
        S = cfg.num_spks
        with stage("stft"):
            wav_f = wav_pad.float() * (1.0 / 32768.0)
            stft_pad = model.extractor.stft.forward(wav_f).permute(0, 2, 3, 1)
            Tpad = stft_pad.shape[2]
            frame_valid = (torch.arange(Tpad, device=wav_pad.device)[None, :]
                           < valid_frames[:, None])              # [Sb, Tpad]
            stft_pad = torch.where(frame_valid[:, None, :, None], stft_pad,
                                   torch.zeros((), dtype=stft_pad.dtype,
                                               device=stft_pad.device))
        F = stft_pad.shape[1]

        total_seg = Sb * num_seg
        chunk = min(cfg.seg_chunk, total_seg)
        while total_seg % chunk:
            chunk -= 1
        mask_floor_db = cfg.mc_mask_floor_db if C > 1 else cfg.sc_mask_floor_db
        mask_floor = 10.0 ** (mask_floor_db / 20.0) \
            if np.isfinite(mask_floor_db) else 0.0
        use_mvdr = C > 1 and cfg.mc_mvdr

        # every window is an adjacent pair of hop-wide slots
        assert T == 2 * hop_frames and Tpad == (num_seg + 1) * hop_frames
        slots = stft_pad.reshape(Sb, F, num_seg + 1, hop_frames, C)
        dev = stft_pad.device
        separated = torch.empty((total_seg, S, F, T), dtype=torch.complex64,
                                device=dev)
        spk_masks = torch.empty((total_seg, S, F, T), dtype=torch.float32,
                                device=dev)
        for c0 in range(0, total_seg, chunk):
            seg_ids = torch.arange(c0, c0 + chunk, device=dev)
            b, k = seg_ids // num_seg, seg_ids % num_seg
            seg_c = torch.cat([slots[b, :, k], slots[b, :, k + 1]], dim=2)
            with stage("features"):
                feat = model.features(seg_c if C > 1 else seg_c[..., 0])
            with stage("conformer"):
                masks = model.masks_from_feature(feat)
            spk_m, noi_m = masks["spk_masks"], masks["noise_masks"]
            with stage("mvdr"):
                if use_mvdr:
                    seg_for_masking = mvdr_beamform(
                        spk_m, noi_m, seg_c, use_pallas=cfg.use_pallas_scm)
                else:
                    seg_for_masking = seg_c[..., 0:1]
                clipped = torch.clamp(spk_m, min=mask_floor)
                sep = seg_for_masking * clipped.to(seg_for_masking.dtype)
                separated[c0:c0 + chunk] = sep.permute(0, 3, 1, 2)
                spk_masks[c0:c0 + chunk] = spk_m.permute(0, 3, 1, 2)
        separated = separated.reshape(Sb, num_seg, S, F, T)
        spk_masks = spk_masks.reshape(Sb, num_seg, S, F, T)

        with stage("stitch"):
            # PIT stitching: permuting the left operand only permutes ROWS
            # of the pairwise loss matrix, so every adjacent pair's matrix
            # comes from one batched pass and the chain runs on [Sb, S, S]
            overlap = T - hop_frames
            if cfg.stitching_input == "mask":
                stitch_in = spk_masks
            elif cfg.stitching_input == "separation_result":
                stitch_in = separated.abs()
            else:
                raise ValueError(
                    f"unexpected stitching_input: {cfg.stitching_input}")
            lm_elem = BASE_LOSSES[cfg.stitching_loss](
                stitch_in[:, :-1, :, None, :, -overlap:],
                stitch_in[:, 1:, None, :, :, :overlap])
            lm_all = lm_elem.mean(dim=(4, 5)).cpu().numpy()  # [Sb,n-1,S,S]
            del lm_elem
            perms = torch.from_numpy(_pit_chain(lm_all, S)).to(dev)
            idx = perms[:, :, :, None, None].expand(Sb, num_seg, S, F, T)
            separated = torch.gather(separated, 2, idx)
            spk_masks = torch.gather(spk_masks, 2, idx)

            stft_stitched, wsum = _weighted_ola(separated, wg, hop_frames,
                                                Tpad)
            mask_stitched, _ = _weighted_ola(spk_masks, wg, hop_frames, Tpad)
            del separated, spk_masks
            wsafe = torch.where(wsum > 1e-5, wsum, torch.ones_like(wsum))
            w4 = wsafe[:, None, None, :]
            stft_stitched = torch.complex(stft_stitched.real / w4,
                                          stft_stitched.imag / w4)
            mask_stitched = mask_stitched / w4

            # temporal activity gating
            activity = mask_stitched.mean(dim=2)           # [Sb, S, Tpad]
            act = erode(dilate(activity >= cfg.activity_th, dilation, 2),
                        erosion, 2)
            gated = torch.where(act[:, :, None, :], stft_stitched,
                                torch.zeros((), dtype=stft_stitched.dtype,
                                            device=dev))
            del stft_stitched

        with stage("istft"):
            wavs = model.extractor.istft_op.inverse(
                gated.reshape(Sb * S, F, Tpad)).reshape(Sb, S, -1)
            peak = wavs.abs().amax(dim=2, keepdim=True)
            scale = 32767.0 / torch.clamp_min(peak, 1e-7)
            wav_i16 = torch.round(wavs * scale).to(torch.int16)
        if not want_side_info:
            mask_stitched = mask_stitched.new_zeros((0,))
        return wav_i16, scale[..., 0], mask_stitched, act

    # ---- prepare (host) / upload / run ----------------------------------
    def prepare_sessions(self, speech_mixes: List[np.ndarray], fs: int
                         ) -> Dict:
        """Host-side batch prep: int16 quantization, padding to the
        common segment bucket, OLA weight matrices. Pure numpy."""
        cfg = self.cfg
        geo = self.seg_geometry(fs)
        T, hop = geo["seg_frames"], geo["hop_frames"]
        overlap = T - hop
        infos = [max(num_frames(mix.shape[1], self.frame_len,
                                self.frame_hop), T) for mix in speech_mixes]
        num_seg_max = max(int(np.ceil((mf - overlap) / hop)) for mf in infos)
        bucket = cfg.seg_bucket_multiple
        num_seg = int(np.ceil(num_seg_max / bucket) * bucket)
        t_pad = (num_seg - 1) * hop + T
        n_pad = (t_pad - 1) * self.frame_hop + self.frame_len

        B = len(speech_mixes)
        C = speech_mixes[0].shape[2]
        wav_pad = np.zeros((B, C, n_pad), np.int16)
        wgs = np.zeros((B, num_seg, T), np.float32)
        valid = np.zeros(B, np.int64)
        for b, mix in enumerate(speech_mixes):
            q = _quantize_int16(mix[0].T[:, :n_pad])
            wav_pad[b, :, :q.shape[1]] = q
            valid[b] = infos[b]
            nseg_real = int(np.ceil((infos[b] - overlap) / hop))
            wgs[b] = build_weight_matrix(nseg_real, num_seg, T,
                                         geo["m0"], geo["m1"])
        n_reals = [(mf - 1) * self.frame_hop + self.frame_len for mf in infos]
        return dict(wav_pad=wav_pad, wgs=wgs, valid=valid, num_seg=num_seg,
                    T=T, hop=hop, geo=geo, n_reals=n_reals)

    def upload_sessions(self, prep: Dict) -> Dict:
        """Copy a prepared batch to the device: one pinned, non-blocking
        copy of the int16 audio (on a card), plus the weights and frame
        counts. Any other keys of `prep` ride along."""
        up = dict(prep)
        del up["wav_pad"], up["wgs"], up["valid"]
        wav = torch.from_numpy(prep["wav_pad"])
        if self.device.type == "cuda":
            wav = wav.pin_memory()
        up["wav"] = wav.to(self.device, non_blocking=True)
        up["wg"] = torch.from_numpy(prep["wgs"]).to(self.device)
        up["valid"] = torch.from_numpy(prep["valid"]).to(self.device)
        return up

    def separate_uploaded(self, up: Dict,
                          timer: Optional[StageTimer] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Run the separation pass on uploaded tensors. Returns (wav_i16
        [Sb, S, N], scales [Sb, S]) on the device."""
        geo = up["geo"]
        wav_dev, scales_dev, _, _ = self._process_core(
            up["wav"], up["wg"], up["valid"], up["num_seg"], up["T"],
            up["hop"], geo["dilation"], geo["erosion"],
            want_side_info=False, timer=timer)
        return wav_dev, scales_dev

    def separate_uploaded_lazy(self, up: Dict,
                               timer: Optional[StageTimer] = None):
        """separate_uploaded with the host copy deferred: returns (lazy
        host wav lists, (wav_dev, scales_dev, n_reals)).

        Only the scales are read to the host here (a sync: the separation
        is done when this returns). The int16 streams stay on the device
        until the lazy list's first access, so their copy does not delay
        the scales read and does not compete with the next batch's
        upload."""
        wav_dev, scales_dev = self.separate_uploaded(up, timer=timer)
        out = _LazyHostWavs(wav_dev, scales_dev.cpu().numpy(), up["n_reals"],
                            self.cfg.num_spks)
        return out, (wav_dev, scales_dev, up["n_reals"])

    def separate_sessions_batch(self, speech_mixes: List[np.ndarray], fs: int,
                                return_device: bool = False,
                                defer_host: bool = False,
                                timer: Optional[StageTimer] = None):
        """Separate several sessions (same mic count) in one pass, padded
        to a common segment bucket. Returns per-session stream lists.

        return_device=True also returns the device outputs (wav_i16
        [Sb, S, N], scales [Sb, S], real sample counts) so later stages
        can read the separated audio without another upload.
        defer_host=True (with return_device) returns a lazy host list
        that copies the int16 streams off the device on first index."""
        up = self.upload_sessions(self.prepare_sessions(speech_mixes, fs))
        lazy, dev = self.separate_uploaded_lazy(up, timer=timer)
        if defer_host and return_device:
            return lazy, dev
        out = list(lazy)
        if return_device:
            return out, dev
        return out

    # ---- host wrapper -----------------------------------------------------
    def separate_and_stitch(self, speech_mix: np.ndarray, fs: int,
                            return_side_info: bool = True,
                            timer: Optional[StageTimer] = None
                            ) -> Tuple[List[np.ndarray], Dict]:
        """speech_mix: [Batch=1, Nsamples, Channels] float. Returns
        (num_spks separated wavs, side_info), the reference
        separate_and_stitch contract."""
        cfg = self.cfg
        assert speech_mix.ndim == 3, f"expecting 3 dims, got {speech_mix.shape}"
        assert speech_mix.shape[0] == 1, "assuming one session per call"
        if cfg.normalize_segment_power:
            raise NotImplementedError(
                "normalize_segment_power is off in every shipped config "
                "and not implemented in the engine")
        geo = self.seg_geometry(fs)
        T, hop = geo["seg_frames"], geo["hop_frames"]
        assert T == 2 * hop, (
            "the OLA fast path assumes segment == 2 hops (the NOTSOFAR "
            "3s/1.5s configuration)")
        prep = self.prepare_sessions([speech_mix], fs)
        mix_frames = int(prep["valid"][0])
        num_seg_real = int(np.ceil((mix_frames - (T - hop)) / hop))
        # sanity: full coverage of the real region
        wg = prep["wgs"][0]
        cover = np.zeros((prep["num_seg"] - 1) * hop + T, np.float32)
        for i in range(num_seg_real):
            cover[i * hop:i * hop + T] += wg[i]
        assert (cover[:mix_frames] > 1e-5).all(), \
            "zero OLA weights found. check hop_size, segment_size or m0, m1"

        up = self.upload_sessions(prep)
        wav_i16, scales, mask_stitched, act = self._process_core(
            up["wav"], up["wg"], up["valid"], up["num_seg"], T, hop,
            geo["dilation"], geo["erosion"],
            want_side_info=return_side_info, timer=timer)
        wavs = _LazyHostWavs(wav_i16, scales.cpu().numpy(), prep["n_reals"],
                             cfg.num_spks)[0]
        side_info = {"segment_frames": T, "num_segments": num_seg_real}
        if return_side_info:
            side_info["mask_stitched"] = mask_stitched[0].permute(
                1, 2, 0).cpu().numpy()[:, :mix_frames]
            side_info["activity_final"] = act[0].t().cpu().numpy()[
                :mix_frames]
        return wavs, side_info


def _pit_chain(lm_all: np.ndarray, S: int) -> np.ndarray:
    """lm_all [Sb, n-1, S, S] f32 adjacent-pair loss matrices -> perms
    [Sb, n, S] int64: each segment's permutation relative to the already
    aligned previous one (the first is the identity)."""
    Sb, n1 = lm_all.shape[:2]
    all_perms = np.array(list(itertools.permutations(range(S))), np.int64)
    rows = np.arange(Sb)[:, None]
    p = np.broadcast_to(np.arange(S), (Sb, S))
    out = [p]
    for i in range(n1):
        lm_eff = lm_all[:, i][rows, p]                     # [Sb, S, S]
        gathered = lm_eff[:, np.arange(S)[None, :], all_perms]  # [Sb,P,S]
        totals = gathered.sum(axis=-1, dtype=np.float32)
        p = all_perms[np.argmin(totals, axis=-1)]
        out.append(p)
    return np.stack(out, axis=1)


def _weighted_ola(segs: torch.Tensor, wg: torch.Tensor, hop: int,
                  t_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted overlap-add in the [Sb, num_seg, S, F, T] layout (T
    minor), T == 2*hop: segment s covers frames [s*hop, s*hop + T), two
    hop-wide slots. segs complex or real, wg [Sb, num_seg, T]. Returns
    (stitched [Sb, S, F, t_pad], wsum [Sb, t_pad])."""
    Sb, num_seg, S, F, T = segs.shape
    assert T == 2 * hop
    real = segs.is_complex()
    x = torch.view_as_real(segs) if real else segs[..., None]
    w = wg[:, :, None, None, :, None]
    # a frame of zero weight adds nothing, even where its window's MVDR
    # solve failed (NaN * 0 would be NaN): the bucket's padding windows
    # may cover the session's last frames with too few of them to be
    # well posed, and the reference never runs those windows at all
    contrib = torch.where(w > 0, x * w, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))
    slots = x.new_zeros((Sb, num_seg + 1, S, F, hop, x.shape[-1]))
    slots[:, :-1] += contrib[..., :hop, :]
    slots[:, 1:] += contrib[..., hop:, :]
    stitched = slots.permute(0, 2, 3, 1, 4, 5).reshape(
        Sb, S, F, (num_seg + 1) * hop, x.shape[-1])[:, :, :, :t_pad]
    stitched = torch.view_as_complex(stitched.contiguous()) if real \
        else stitched[..., 0]
    wslots = wg.new_zeros((Sb, num_seg + 1, hop))
    wslots[:, :-1] += wg[..., :hop]
    wslots[:, 1:] += wg[..., hop:]
    return stitched, wslots.reshape(Sb, -1)[:, :t_pad]


class _LazyHostWavs:
    """Per-session separated-stream lists, copied off the device and
    dequantized on first access."""

    def __init__(self, wav_dev: torch.Tensor, scales: np.ndarray,
                 n_reals: List[int], num_spks: int):
        self._wav_dev = wav_dev
        self._scales = scales
        self._n_reals = n_reals
        self._num_spks = num_spks
        self._host: Optional[list] = None

    def _materialize(self):
        if self._host is None:
            wav_i16 = self._wav_dev.cpu().numpy()
            self._host = [
                [(wav_i16[b, i, :n].astype(np.float32) / self._scales[b, i])
                 for i in range(self._num_spks)]
                for b, n in enumerate(self._n_reals)]
        return self._host

    def __getitem__(self, b):
        return self._materialize()[b]

    def __len__(self):
        return len(self._n_reals)

    def __iter__(self):
        return iter(self._materialize())
