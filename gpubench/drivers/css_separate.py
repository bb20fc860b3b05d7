"""Driver of CSS serving: ``CssEngine.separate_sessions_batch`` of the port,
as ``css_batch_prepass`` calls it, one call a batch of sessions.

Set-up draws the weights on the device from the seed (drivers/css_train.py
``make_weights``), builds the port's ``CssModel`` at the configuration's
widths in its serving dtype and a ``CssEngine`` with ``CssCfg``'s defaults
and the configuration's ``serving`` section, draws p['draws'] batches of
sessions, holds them on the host as float32 [1, samples, mics] (as
``load_session_audio`` returns a session's wavs) and runs one warm call.
The window repeats calls over the draws in turn; each call returns
p['sessions'] x p['session_seconds'] seconds of audio.

A session (``sessions``): p['talkers'] talkers (traffic.talkers, each
speaking in a p['speech_share'] share of one-second blocks), each at an
azimuth drawn from the seed, reaching the 7-mic circular array
(utils/mic_array.py) with its plane-wave delays; noise of standard
deviation p['noise'] on every mic; quantised to int16.

A call runs as ``css_batch_prepass`` runs it, with no StageTimer: the
stages are the engine's profiler spans, with no synchronise between them.
The traced call alone times its stages with a StageTimer, whose
synchronise at each stage's end keeps the stage's device operations
inside its span (a CUDA graph's kernels run after its launch returns, and
the trace's operations carry no link to the span that launched them), so
its idle share is that of a call with a synchronise a stage.

The check (``check``) runs the program once more on the last call's
sessions with ``CssEngine.taps`` set, and the plain float32 reference
(gpubench/reference/css.py) on the same sessions, on the device in blocks
of p['block'] windows:

* ``features_err``: the relative RMS gap between the program's features
  and the reference's of its own STFT of the same windows, over every real
  window: the magnitudes as they are, each phase difference as a unit
  vector at its angle weighted by the length of the reference's (cos, sin)
  deviation whose angle it is (a near-degenerate angle counts little);
* ``mask_err``: the largest gap between the program's masks and the
  reference network's on the program's features, over every real window;
* ``sep_err``: the relative RMS gap between the program's separated
  (beamformed, masked) STFT and the reference's on the program's masks,
  over every real window (everything after the network runs on the
  program's masks: with seeded weights the masks sit near 0.5, and the
  MVDR's noise covariance turns bfloat16's rounding of them into a
  different beamformer, PERF.md), leaving out the (window, speaker, bin)
  systems whose R_noise+others has a condition number above p['cond_max'],
  which float32 covariances do not determine: there the reference takes
  the program's output (``undetermined``, with the systems it was of);
* ``undetermined_err``: over those systems, the program's beamformer held
  to MVDR's equations rather than to the reference's solve: its weights,
  recovered from its output by least squares, against R_noise+others W =
  c R_target u (``reference.css.backward_sums``), as the relative RMS
  residual: a solve that fails or goes wrong there still shows;
* ``perm_err``: windows whose stitching permutation (relative to the
  window before) differs from the reference's, where the program's lies
  more than p['perm_tie'] above the reference's best total (within it, the
  reference takes the program's and counts it under ``perm_excused``);
* ``activity_err``: the share of the sessions' frames whose gate differs
  from the reference's; where the reference's mean mask lies within
  p['activity_margin'] of the threshold it takes the program's decision;
* ``stream_err``: the relative RMS gap between the last call's streams
  (int16 at the stream's scale) and the reference's, over the samples of
  frames whose gates agree;
* ``plan_err``: sessions, windows, padded windows, chunks, solves, taps
  and stream lengths that differ from the plan (0).

The limits' readings (``gpubench/calibrate.py --control``) are the
controls' (``control_readings``): the reference with the Conformer's
matmul operands in float8 e4m3, the features of the STFT rounded to
bfloat16, the MVDR solved in complex64 without pivoting, and the program
with a fault planted (``planted``): MVDR skipped (mic 0 passed through),
the mask floor dropped, window 2's permutation swapped in every session,
mic 0 passed through where R_noise+others' condition number exceeds
p['cond_max'] (the systems the reference leaves to the program).
"""
import contextlib
import math
import sys
from typing import Dict, List

import numpy as np
import torch

from gpubench import traffic as tg
from gpubench.counts import conformer as conformer_counts
from gpubench.counts import css as counts
from gpubench.drivers.css_train import make_weights, model_dims
from gpubench.harness import Check
from gpubench.reference import conformer as ref_conformer
from gpubench.reference import css as ref
from gpubench.reference.whisper import f32_matmuls

SOUND = 343.0
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
LIMITS = ("features_err", "mask_err", "sep_err", "undetermined_err",
          "perm_err", "activity_err", "stream_err", "plan_err")
FAULTS = ("mic0", "no_floor", "swap", "loose")


def sessions(p: Dict, seed: int, draw: int, device) -> List[np.ndarray]:
    """Draw `draw` of a batch of sessions: p['sessions'] arrays [1,
    samples, mics] float32, int16 values over 32768."""
    from notsofar_tpu_torch.utils.mic_array import multichannel_mic_pos_xyz_cm
    n = int(p["session_seconds"] * tg.SAMPLE_RATE)
    B, K, M = int(p["sessions"]), int(p["talkers"]), int(p["mics"])
    s = tg.sub_seed(seed, "sessions", draw)
    src = tg.talkers(B * K, n, s, device, speech_share=p["speech_share"])
    g = torch.Generator(device=device).manual_seed(s + 1)
    az = 2.0 * math.pi * torch.rand(B, K, generator=g, device=device,
                                    dtype=torch.float64)
    pos = torch.from_numpy(multichannel_mic_pos_xyz_cm()[:M, :2] / 100.0
                           ).to(device)                      # [M, 2] m
    freqs = torch.fft.rfftfreq(n, 1.0 / tg.SAMPLE_RATE, device=device,
                               dtype=torch.float64)
    out = []
    for b in range(B):
        spec = torch.fft.rfft(src[b * K:(b + 1) * K])        # [K, n/2+1]
        mix = torch.zeros(M, freqs.shape[0], dtype=spec.dtype, device=device)
        for k in range(K):
            d = torch.stack([torch.cos(az[b, k]), torch.sin(az[b, k])])
            delay = -(pos @ d) / SOUND                       # [M] s
            mix += spec[k] * torch.exp(-2j * math.pi * freqs[None]
                                       * delay[:, None]).to(spec.dtype)
        x = torch.fft.irfft(mix, n) + p["noise"] * torch.randn(
            M, n, generator=g, device=device)
        q = torch.round(x.clamp(-1.0, 32767.0 / 32768.0) * 32768.0)
        out.append((q / 32768.0).t().contiguous().cpu().numpy()[None])
    return out


def engine_cfg(cfg: Dict):
    from notsofar_tpu_torch.css.engine import CssCfg
    return CssCfg(**cfg["serving"])


def build_engine(cfg: Dict, sd: Dict[str, torch.Tensor], device):
    """The port's engine at the configuration's widths, weights sd."""
    from notsofar_tpu_torch.css.engine import CssEngine
    from notsofar_tpu_torch.models.conformer import ConformerConfig
    from notsofar_tpu_torch.models.css_wrapper import (ConformerCssConfig,
                                                       CssModel, NnetConfig)
    conf = ConformerConfig(
        attention_dim=cfg["attention_dim"],
        attention_heads=cfg["attention_heads"],
        linear_units=cfg["linear_units"], kernel_size=cfg["kernel_size"],
        num_blocks=cfg["num_blocks"], dropout_rate=cfg["dropout_rate"],
        pos_maxlen=cfg["pos_maxlen"])
    css = ConformerCssConfig(nnet_conf=NnetConfig(
        conformer_conf=conf, in_features=cfg["in_features"],
        num_nois=cfg["num_nois"], num_spks=cfg["num_spks"]))
    model = CssModel(css, dtype=DTYPES[cfg["serving"]["compute_dtype"]],
                     state_dict=sd, device=device)
    return CssEngine(model, engine_cfg(cfg))


def plan(cfg: Dict, lengths: List[int]) -> Dict:
    """The work one call is planned to do: windows of each session, the
    bucket's padded windows, chunks (the engine's rule), solves."""
    ecfg = engine_cfg(cfg)
    g = ref.geometry(cfg["serving"])
    wins = [ref.windows_of(n, g) for n in lengths]
    bucket = ecfg.seg_bucket_multiple
    num_seg = int(math.ceil(max(wins) / bucket) * bucket)
    padded = len(lengths) * num_seg
    chunk = min(ecfg.seg_chunk, padded)
    while padded % chunk:
        chunk -= 1
    return dict(sessions=len(lengths), windows=sum(wins), win=wins,
                padded=padded, num_seg=num_seg, chunk=chunk,
                chunks=padded // chunk,
                systems=padded * cfg["num_spks"] * cfg["num_bins"],
                frames=[max(ref.num_frames(n), g["T"]) for n in lengths],
                T=g["T"], hop=g["hop"])


class Cell:
    def __init__(self, ctx: Dict):
        # the plan check reads the engine's counters: a port without them
        # fails here, before any work
        from notsofar_tpu_torch.css import engine as css_engine
        from notsofar_tpu_torch.css.engine import CSS_COUNTS  # noqa: F401
        from notsofar_tpu_torch.utils.profiling import StageTimer
        cfg, p = ctx["config"], ctx["traffic"]
        self.ctx, self.cfg, self.p = ctx, cfg, p
        self.css_engine, self.StageTimer = css_engine, StageTimer
        dev = torch.device(ctx["device"])
        self.c = model_dims(cfg)
        self.sd = make_weights(self.c, ctx["seed"], dev)
        self.engine = build_engine(cfg, self.sd, dev)
        self.draws = [sessions(p, ctx["seed"], i, dev)
                      for i in range(int(p["draws"]))]
        self.plan = plan(cfg, [m.shape[1] for m in self.draws[0]])
        self.calls = 0
        self.call()                      # the warm call
        self.calls = 0

    # -- the work ------------------------------------------------------
    def call(self) -> float:
        mixes = self.draws[self.calls % len(self.draws)]
        timer = self.StageTimer() if torch.autograd._profiler_enabled() \
            else None
        out = self.engine.separate_sessions_batch(mixes, tg.SAMPLE_RATE,
                                                  timer=timer)
        self.last = (mixes, out)
        self.calls += 1
        return float(len(mixes) * self.p["session_seconds"])

    def start_window(self) -> None:
        self.css_engine.reset_css_counts()
        self.calls = 0

    def work(self) -> Dict:
        pl, c = self.plan, self.c
        per_call = counts.part_flops(
            c, [dict(frames=f, windows=w) for f, w in zip(pl["frames"],
                                                          pl["win"])],
            pl["T"], pl["hop"], int(self.p["mics"]))
        specs = ref_conformer.param_specs(c)
        return dict(
            flops={k: v * self.calls for k, v in per_call.items()},
            per_call=per_call,
            conformer_flops=pl["padded"] * float(
                conformer_counts.forward_flops(c, pl["T"])),
            conformer_bytes=counts.conformer_bytes(c, specs, pl["padded"],
                                                   pl["chunks"], pl["T"]),
            plan=pl)

    def window_record(self) -> Dict:
        return dict(stages={},
                    counters=dict(self.css_engine.CSS_COUNTS),
                    work=self.work(),
                    attempted=self.calls * int(self.p["sessions"]),
                    check_data=dict(engine=self.engine, sd=self.sd,
                                    mixes=self.last[0],
                                    streams=self.last[1], plan=self.plan,
                                    calls=self.calls))

    def release(self) -> None:
        self.draws = None
        self.last = None


def setup(ctx: Dict) -> Cell:
    return Cell(ctx)


# ---------------------------------------------------------------------------
# the output check
# ---------------------------------------------------------------------------

def feature_sums(got: torch.Tensor, spec: torch.Tensor):
    """(squared gap, squared scale) of features got [B, 1799, T] against
    the reference's of the windows' STFT spec [B, 7, F, T]: the magnitude
    rows as they are; each phase-difference row as the unit vector at its
    angle, scaled by the length r of the reference's (cos, sin) deviation
    whose angle it is, against that deviation."""
    mag, dc, ds = ref.feature_parts(spec)
    Fq = mag.shape[1]
    a = got[:, Fq:].reshape(dc.shape)
    r = torch.hypot(dc, ds)
    num = (got[:, :Fq] - mag).pow(2).sum() + \
        (r * torch.cos(a) - dc).pow(2).sum() + \
        (r * torch.sin(a) - ds).pow(2).sum()
    return float(num), float(mag.pow(2).sum() + r.pow(2).sum())


def _rel(sums) -> float:
    num, den = sums
    return math.sqrt(num / den) if den > 0 else (0.0 if num == 0 else
                                                 math.inf)


def program_run(engine, mixes: List[np.ndarray], sd: Dict, c: Dict,
                serving: Dict, block: int) -> Dict:
    """The program once more on `mixes` with its taps set: per session,
    each real window's separated STFT, the permutations, the threshold
    decisions and gates over the frames the windows cover; the gap between
    the program's features and the reference's of its own STFT
    (``features_err``) and the worst real window's gap between the
    program's masks and the reference network's on the program's features
    (``mask_err``); the taps' count and sizes; the streams."""
    g = ref.geometry(serving)
    wins = [ref.windows_of(m.shape[1], g) for m in mixes]
    bucket = engine.cfg.seg_bucket_multiple
    num_seg = int(math.ceil(max(wins) / bucket) * bucket)
    w = {k: v.to(engine.device, torch.float32) for k, v in sd.items()}
    with f32_matmuls():
        specs = [ref.session_spec(torch.from_numpy(m[0]).to(engine.device),
                                  g)[0] for m in mixes]
    got = dict(chunks=[], gaps={}, seps={}, masks={}, feat=[0.0, 0.0])

    def tap(kind, **kw):
        if kind == "chunk":
            first, feat = kw["first"], kw["features"].float()
            real: Dict[int, List] = {}
            for i in range(feat.shape[0]):
                b, k = divmod(first + i, num_seg)
                if k < wins[b]:
                    real.setdefault(b, []).append((i, k))
            with f32_matmuls():
                for b, ik in real.items():
                    sums = feature_sums(
                        feat[[i for i, _ in ik]],
                        ref.window_specs(specs[b], [k for _, k in ik], g))
                    got["feat"] = [x + y for x, y in zip(got["feat"], sums)]
            m = kw["masks"]
            prog = torch.cat([m["spk_masks"], m["noise_masks"]], -1).float()
            with f32_matmuls():
                want = torch.cat([ref.masks(w, c, kw["features"][i:i + block]
                                            .float())
                                  for i in range(0, prog.shape[0], block)])
            gap = (prog - want).abs().amax(dim=(1, 2, 3))
            for i in range(prog.shape[0]):
                got["gaps"][kw["first"] + i] = gap[i]
                got["masks"][kw["first"] + i] = prog[i]
                got["seps"][kw["first"] + i] = kw["separated"][i].permute(
                    2, 0, 1)
            got["chunks"].append(prog.shape[0])
        elif kind == "stitch":
            got["perms"] = kw["perms"].cpu().numpy()
        elif kind == "gate":
            got["activity"], got["gate"] = kw["activity"], kw["gate"]

    engine.taps = tap
    try:
        streams = engine.separate_sessions_batch(mixes, tg.SAMPLE_RATE)
    finally:
        engine.taps = None
    num_seg = got["perms"].shape[1]
    th = serving["activity_th"]
    out = []
    mask_err = 0.0
    for b, n in enumerate(wins):
        L = (n - 1) * g["hop"] + g["T"]
        ids = [b * num_seg + k for k in range(n)]
        mask_err = max(mask_err, max(float(got["gaps"][i]) for i in ids))
        out.append(dict(
            separated=torch.stack([got["seps"][i] for i in ids]),
            masks=torch.stack([got["masks"][i] for i in ids]),
            perms=got["perms"][b, :n],
            bits=got["activity"][b, :, :L] >= th,
            gates=got["gate"][b, :, :L]))
    return dict(sessions=out, mask_err=mask_err, chunks=got["chunks"],
                features_err=_rel(got["feat"]), streams=streams)


def compare(got: List[Dict], streams: List[List[np.ndarray]],
            want: Dict) -> Dict:
    """The check's numbers of one run's per-session results and streams
    against the reference's (``separate(..., follow=...)`` of that run)."""
    num = den = 0.0
    frames = differ = 0
    s_num = s_den = 0.0
    for b, (mine, ref_s) in enumerate(zip(got, want["sessions"])):
        keep = ref_s["determined"][..., None]
        num += float(torch.where(keep, mine["separated"].to(keep.device)
                                 - ref_s["separated"], 0).abs().pow(2).sum())
        den += float(torch.where(keep, ref_s["separated"], 0).abs()
                     .pow(2).sum())
        Tn = ref_s["frames"]
        diff = (mine["gates"][:, :Tn].to(ref_s["gates"].device)
                != ref_s["gates"][:, :Tn])
        frames += diff.numel()
        differ += int(diff.sum())
        # a frame's gate reaches the samples of that frame (512 from
        # t * 256): leave out the samples of frames whose gates differ
        bad = torch.nn.functional.pad(diff.float(), (1, 1))
        bad = torch.maximum(bad[:, 1:], bad[:, :-1]).repeat_interleave(
            ref.HOP, dim=1)
        prog = torch.from_numpy(np.stack(streams[b])).to(ref_s["streams"]
                                                         .device)
        n = min(prog.shape[1], ref_s["streams"].shape[1], bad.shape[1])
        ok = bad[:, :n] < 0.5
        r = ref_s["streams"][:, :n]
        s_num += float(((prog[:, :n] - r)[ok]).pow(2).sum())
        s_den += float(r[ok].pow(2).sum())
    t = want["tally"]
    return dict(sep_err=math.sqrt(num / max(den, 1e-30)),
                undetermined_err=_rel((t["loose_gap"], t["loose_scale"])),
                perm_err=float(t["perm_err"]),
                undetermined=t["undetermined"], systems=t["systems"],
                activity_err=differ / max(frames, 1),
                stream_err=math.sqrt(s_num / max(s_den, 1e-30)),
                perm_excused=t["perm_excused"],
                perm_gap_max=t["perm_gap_max"],
                activity_adopted=t["activity_adopted"],
                activity_outside=t["activity_outside"])


def plan_errors(pl: Dict, counters: Dict, calls: int, chunks: List[int],
                streams: List[List[np.ndarray]], S: int) -> int:
    """Counts of the window's calls and of the check's run against the
    plan."""
    err = abs(int(counters.get("calls", -1)) - calls)
    for k in ("sessions", "windows", "padded", "chunks", "systems"):
        err += abs(int(counters.get(k, -1)) - calls * pl[k])
    err += abs(len(chunks) - pl["chunks"]) + \
        sum(n != pl["chunk"] for n in chunks)
    err += abs(len(streams) - pl["sessions"])
    for f, s in zip(pl["frames"], streams):
        err += abs(len(s) - S) + sum(len(x) != (f - 1) * ref.HOP + ref.FRAME
                                     for x in s)
    return err


def _inputs(ctx: Dict, record: Dict):
    """The last call's sessions and the float32 weights, on the device the
    program ran on."""
    data = record["check_data"]
    dev = data["engine"].device
    return ([torch.from_numpy(m[0]).to(dev) for m in data["mixes"]],
            {k: v.to(dev, torch.float32) for k, v in data["sd"].items()})


def _following(ctx: Dict, x, w, run: List[Dict], **kw) -> Dict:
    """The reference, on `run`'s masks and taking its near-tie decisions,
    or (run None) on its own."""
    p, cfg = ctx["traffic"], ctx["config"]
    ties = {} if run is None else dict(
        follow=run, cond_max=float(p["cond_max"]),
        perm_tie=float(p["perm_tie"]),
        activity_margin=float(p["activity_margin"]))
    return ref.separate(x, w, model_dims(cfg), cfg["serving"],
                        block=int(p["block"]), **ties, **kw)


def reference_readings(ctx: Dict, record: Dict) -> Dict:
    data, cfg = record["check_data"], ctx["config"]
    c = model_dims(cfg)
    prog = program_run(data["engine"], data["mixes"], data["sd"], c,
                       cfg["serving"], int(ctx["traffic"]["block"]))
    r = compare(prog["sessions"], data["streams"],
                _following(ctx, *_inputs(ctx, record), prog["sessions"]))
    r["mask_err"], r["features_err"] = prog["mask_err"], prog["features_err"]
    r["plan_err"] = float(plan_errors(data["plan"], record["counters"],
                                      data["calls"], prog["chunks"],
                                      prog["streams"], c["num_spks"]))
    return r


def judge(ctx: Dict, readings: Dict) -> List[Check]:
    lim = ctx["traffic"]["limits"]
    return [Check(k, float(readings[k]), float(lim[k])) for k in LIMITS]


def check(ctx: Dict, record: Dict) -> List[Check]:
    r = reference_readings(ctx, record)
    print("[gpubench] css check: " + ", ".join(
        f"{k} {r[k]}" for k in ("undetermined", "systems",
                                "perm_excused", "perm_gap_max",
                                "activity_adopted", "activity_outside")),
        flush=True, file=sys.stderr)
    return judge(ctx, r)


# ---------------------------------------------------------------------------
# the controls
# ---------------------------------------------------------------------------

def feature_control(ctx: Dict, record: Dict) -> float:
    """features_err of the reference's features of each real window's STFT
    rounded to bfloat16, against its float32 features."""
    x, _ = _inputs(ctx, record)
    g = ref.geometry(ctx["config"]["serving"])
    block, sums = int(ctx["traffic"]["block"]), [0.0, 0.0]
    with f32_matmuls(), torch.no_grad():
        for xs in x:
            padded, n, _ = ref.session_spec(xs, g)
            for k0 in range(0, n, block):
                spec = ref.window_specs(padded, range(k0, min(n, k0 + block)),
                                        g)
                low = torch.complex(spec.real.bfloat16().float(),
                                    spec.imag.bfloat16().float())
                part = feature_sums(ref.features(low), spec)
                sums = [a + b for a, b in zip(sums, part)]
    return _rel(sums)


def chain_readings(ctx: Dict, record: Dict, base: List[Dict], lowp: bool,
                   solve: str) -> Dict:
    """The check's numbers of the reference computed with the Conformer's
    matmul operands in float8 e4m3 (lowp) or the MVDR solve in complex64
    without pivoting, in the program's place; its masks against `base`'s
    (the float32 reference's on the same features)."""
    x, w = _inputs(ctx, record)
    run = _following(ctx, x, w, None, lowp=lowp, solve=solve)["sessions"]
    streams = [list(s["streams"].cpu().numpy()) for s in run]
    r = compare(run, streams, _following(ctx, x, w, run))
    r["mask_err"] = max(float((a["masks"] - b["masks"]).abs().max())
                        for a, b in zip(run, base))
    r["features_err"] = 0.0
    r["plan_err"] = 0.0
    return r


@contextlib.contextmanager
def planted(engine, fault: str, cond_max: float = 1e6):
    """The engine with one fault planted: 'mic0' (MVDR skipped, mic 0's
    STFT passed through for every speaker), 'no_floor' (the mask floor
    dropped), 'swap' (window 2's first two streams swapped in every
    session's permutation chain) or 'loose' (mic 0's weights where the
    R_noise+others has a condition number above cond_max)."""
    from notsofar_tpu_torch.css import engine as E
    from notsofar_tpu_torch.ops import mvdr as V
    saved = (E.mvdr_beamform, E._pit_chain, engine.cfg.mc_mask_floor_db,
             V._weights)
    chain, weights = E._pit_chain, V._weights

    def loose(scm, S, dtype):
        W = weights(scm, S, dtype)                           # [B,S,F,M]
        rn = torch.stack([sum(scm[:, j] for j in range(S + 1) if j != i)
                          for i in range(S)], dim=1).to(torch.complex128)
        ev = torch.linalg.eigvalsh(rn)
        bad = ev[..., -1] > cond_max * ev[..., 0].clamp_min(1e-300)
        u = torch.zeros_like(W)
        u[..., 0] = 1.0
        return torch.where(bad[..., None], u, W)

    def swapped(lm_all, S):
        perms = chain(lm_all, S).copy()
        perms[:, 2, [0, 1]] = perms[:, 2, [1, 0]]
        return perms

    if fault == "mic0":
        E.mvdr_beamform = lambda spk, noi, stft, use_pallas=False: \
            stft[..., :1].expand(*stft.shape[:3], spk.shape[-1])
    elif fault == "no_floor":
        engine.cfg.mc_mask_floor_db = -math.inf
    elif fault == "swap":
        E._pit_chain = swapped
    elif fault == "loose":
        V._weights = loose
    else:
        raise ValueError(f"no fault {fault!r}")
    try:
        yield engine
    finally:
        (E.mvdr_beamform, E._pit_chain, engine.cfg.mc_mask_floor_db,
         V._weights) = saved


def fault_readings(ctx: Dict, record: Dict, fault: str) -> Dict:
    """The check's numbers of the program with `fault` planted, on the
    last call's sessions, with the checks it fails (``failed``)."""
    data, cfg = record["check_data"], ctx["config"]
    with planted(data["engine"], fault,
                 float(ctx["traffic"]["cond_max"])) as engine:
        prog = program_run(engine, data["mixes"], data["sd"],
                           model_dims(cfg), cfg["serving"],
                           int(ctx["traffic"]["block"]))
    r = compare(prog["sessions"], prog["streams"],
                _following(ctx, *_inputs(ctx, record), prog["sessions"]))
    r["mask_err"], r["features_err"] = prog["mask_err"], prog["features_err"]
    r["plan_err"] = 0.0
    r["failed"] = [k.name for k in judge(ctx, r) if not k.ok]
    return r


def control_readings(ctx: Dict, record: Dict) -> Dict:
    """The control (float8 e4m3 Conformer operands, features of the STFT
    rounded to bfloat16), and the readings of an MVDR solved in complex64
    without pivoting (``c64_no_pivot``) and of the planted faults
    (``faults``)."""
    base = _following(ctx, *_inputs(ctx, record), None)["sessions"]
    out = chain_readings(ctx, record, base, True, "complex128")
    out["features_err"] = feature_control(ctx, record)
    out["c64_no_pivot"] = chain_readings(ctx, record, base, False,
                                         "complex64_no_pivot")
    out["faults"] = {f: fault_readings(ctx, record, f) for f in FAULTS}
    return out
