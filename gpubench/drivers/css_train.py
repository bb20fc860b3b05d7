"""Driver of CSS training: the port's train step (``training/train.py::
make_train_step``) fed by its loader (``training/dataset.py``), wired as
``run_training_css`` wires them, one optimizer step a call.

Set-up writes a seeded partition in the reference byte format into the
run's temporary directory (p['utterances'] multichannel utterances:
mixture, each talker's direct path on every mic, noise), draws the
weights on the device from the seed, loads them into the port's model,
and runs the first p['first_steps'] steps through the same loader and
step as the window: their losses, the first gradient as AdamW got it
(from its first moment after step 1) and each parameter's change after
the last of them are kept for the check. The window goes on with the
same loader, model and optimizer; evaluation and checkpoints stay out of
it (the recipe runs them every 1000 steps).

The mic rotation of each row is drawn from the seed by the row's
(step, utterance, offset) and handed to the step.

The check (``check``): the plain float32 reference
(gpubench/reference/conformer.py) reads the same rows from the partition
files, runs the same steps from the same weights, and gives:

* ``grad_err``: the worst leaf's gap between the norms of the first
  clipped gradient, over the larger of that leaf's reference norm and the
  median leaf's;
* ``update_err``: the same of each leaf's change after the steps, leaving
  out leaves whose reference gradient is under a thousandth of the median
  leaf's (they move by round-off under Adam);
* ``plan_err``: rows that differ from the plan (whole batches of distinct
  3 s segments), 0.

The steps' losses are compared too (``loss_err``, the first step's
relative gap, and ``loss_steps``) but not held to a limit: the model's raw
inter-mic phase features flip by 2 pi where round-off crosses their branch
cut, and cuBLAS does not round the same on every run, so a sound run's
first loss is off by up to 6e-5 where the control (TF32) reads from 1.2e-4:
no limit lies between (PERF.md).
"""
import json
import shutil
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from gpubench import traffic as tg
from gpubench.counts import conformer as counts
from gpubench.harness import Check
from gpubench.reference import conformer as ref

COLUMNS = ("mixture", "gt_spk_direct_early_echoes", "gt_noise")
SCALE = 30000.0


def model_dims(cfg: Dict) -> Dict:
    keys = ("attention_dim", "attention_heads", "linear_units",
            "kernel_size", "num_blocks", "pos_maxlen", "in_features",
            "num_bins", "num_spks", "num_nois")
    return {k: cfg[k] for k in keys}


def make_weights(c: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's tensors, float32 on `device`, from one normal draw:
    matrices normal(0, fan_in^-1/2), biases and norm offsets
    normal(0, 0.02), norm gains 1 + normal(0, 0.05), the position table
    and the scalar taps normal(0, 1); identity input normalisation and
    batch-norm statistics."""
    specs = ref.param_specs(c)
    drawn = [(n, s, k) for n, s, k in specs if k not in ("zeros", "ones")]
    total = sum(int(np.prod(s)) for _, s, _ in drawn)
    g = torch.Generator(device=device).manual_seed(
        tg.sub_seed(seed, "weights"))
    flat = torch.randn(total, generator=g, device=device)
    sd, off = {}, 0
    for name, shape, kind in specs:
        if kind in ("zeros", "ones"):
            sd[name] = (torch.zeros if kind == "zeros" else torch.ones)(
                shape, device=device)
            continue
        n = int(np.prod(shape))
        t = flat[off:off + n].view(shape)
        off += n
        if kind == "matrix":
            t.mul_(float(np.prod(shape[1:])) ** -0.5)
        elif kind in ("bias", "ln_b"):
            t.mul_(0.02)
        elif kind == "ln_w":
            t.mul_(0.05).add_(1.0)
        sd[name] = t
    return sd


def write_partition(root: Path, p: Dict, seed: int, device) -> Dict:
    """p['utterances'] utterances of p['utterance_seconds'] in the
    reference byte format (raw int16 per column scaled by 30000, a json
    record each, a .map index): p['talkers'] talkers reaching p['mics']
    mics with their own delays and gains, noise on every mic. Drawn on the
    device in one call a column."""
    root.mkdir(parents=True, exist_ok=True)
    n = int(p["utterance_seconds"] * tg.SAMPLE_RATE)
    U, K, M = int(p["utterances"]), int(p["talkers"]), int(p["mics"])
    s = tg.sub_seed(seed, "partition")
    src = tg.talkers(U * K, n + 16, s, device).reshape(U, K, -1)
    g = torch.Generator(device=device).manual_seed(s + 1)
    delay = torch.randint(0, 16, (U, K, M), generator=g, device=device)
    gain = 0.6 + 0.4 * torch.rand(U, K, M, generator=g, device=device)
    t = torch.arange(n, device=device)
    direct = torch.stack([src[:, k][torch.arange(U, device=device)[:, None,
                                                                   None],
                                    t[None, None, :] + delay[:, k, :, None]]
                          * gain[:, k, :, None] for k in range(K)],
                         dim=-1)                      # [U, M, n, K]
    direct = direct.permute(0, 2, 1, 3).contiguous()   # [U, n, M, K]
    noise = 0.003 * torch.randn(U, n, M, generator=g, device=device)
    cols = {"mixture": direct.sum(-1) + noise,
            "gt_spk_direct_early_echoes": direct, "gt_noise": noise}
    utt_map = {}
    host = {k: torch.clamp(v * SCALE, -32768, 32767).to(torch.int16).cpu()
            .numpy() for k, v in cols.items()}
    for u in range(U):
        uid = f"{u:04d}_utt"
        utt_map[uid] = n
        meta = {}
        for name, arr in host.items():
            q = arr[u]
            row = int(np.prod(q.shape[1:]))
            meta[name] = dict(dtype="int16", shape=list(q.shape), itemsize=2,
                              element_in_row=row, row_size=2 * row)
            meta[name + "_scale"] = dict(values=str(SCALE))
            (root / f"{uid}.{name}").write_bytes(q.tobytes())
        (root / f"{uid}.json").write_text(json.dumps(
            dict(index_name=None, index_value=uid, columns=meta)))
    (root / "dataset-000000.map").write_text(json.dumps(utt_map))
    return {"samples": n}


def read_rows(root: Path, rows: List, seg_len: int, device) -> Dict:
    """The batch of rows (utterance id, offset) read from the partition's
    raw files, float32 on `device`: int16 times the float32 reciprocal of
    the scale, the descaling of the loader's native reader. The check
    keeps them on the host and moves one batch at a time."""
    out = {}
    for name in COLUMNS:
        arrs = []
        for uid, t0 in rows:
            meta = json.loads((root / f"{uid}.json").read_text())
            spec = meta["columns"][name]
            raw = np.fromfile(root / f"{uid}.{name}", dtype=np.int16,
                              count=seg_len * spec["element_in_row"],
                              offset=2 * t0 * spec["element_in_row"])
            arrs.append(raw.reshape([seg_len] + spec["shape"][1:]))
        out[name] = torch.from_numpy(np.stack(arrs).astype(np.float32)
                                     * np.float32(1.0 / SCALE)).to(device)
    return out


def row_shifts(seed: int, step: int, rows: List, device) -> torch.Tensor:
    """Each row's mic rotation (0-5), from the seed, the step and the
    row's (utterance, offset)."""
    return torch.tensor([tg.sub_seed(seed, "shift", step, uid, int(t0)) % 6
                         for uid, t0 in rows], device=device)


def train_cfg(cfg: Dict):
    from notsofar_tpu_torch.training.config import TrainCfg
    from notsofar_tpu_torch.utils.conf import update_dataclass
    return update_dataclass(TrainCfg(), cfg["train_cfg"])


def first_moment_norm(opt, param) -> float:
    """The norm of AdamW's first moment of `param` (0 where it has none:
    no step reached it)."""
    m = opt.state.get(param, {}).get("exp_avg")
    return 0.0 if m is None else float(torch.linalg.vector_norm(m))


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.float()))
            for n, t in tensors.items()}


class Cell:
    def __init__(self, ctx: Dict):
        from notsofar_tpu_torch.training import train as T
        from notsofar_tpu_torch.training.dataset import (DataLoader,
                                                         SegmentSplitter,
                                                         SimulatedDataset)
        from notsofar_tpu_torch.training.schedulers import make_schedule
        cfg, p = ctx["config"], ctx["traffic"]
        self.ctx, self.cfg, self.p = ctx, cfg, p
        dev = self.dev = torch.device(ctx["device"])
        self.T = T
        self.tc = tc = train_cfg(cfg)
        self.c = model_dims(cfg)
        self.root = Path(tempfile.mkdtemp(prefix="gpubench_train_"))
        write_partition(self.root, p, ctx["seed"], dev)
        self.sd = make_weights(self.c, ctx["seed"], dev)
        self.model = T.get_model(tc, dev, seed=0)
        self.model.module.load_state_dict(self.sd)
        self.state = T.init_state(self.model, tc)
        self.step, _ = T.make_train_step(self.model, tc)
        self.schedule = make_schedule(tc.scheduler_name,
                                      tc.scheduler_step_lr_cfg,
                                      tc.scheduler_linear_warmup_decay_cfg)
        seg = int(tc.segment_len_secs * tc.fs)
        self.seg_len = seg
        splitter = SegmentSplitter(
            min_overlap=int(seg * tc.segment_min_overlap_factor),
            max_overlap=int(seg * tc.segment_max_overlap_factor),
            pr_force_align=tc.segment_pr_force_align, desired_segm_len=seg)
        self.dataset = SimulatedDataset(str(self.root), splitter,
                                        seed=44697134,
                                        single_channel=tc.single_channel,
                                        needed_columns=list(COLUMNS))
        self.loader = DataLoader(self.dataset, tc.global_batch_size,
                                 shuffle=True, seed=tc.seed + 46117,
                                 num_threads=tc.dataloader_workers,
                                 drop_last=False)
        self.epoch, self.it = 0, iter(())
        self.generator = torch.Generator(device=dev)
        self.host_rng = np.random.RandomState(
            tg.sub_seed(ctx["seed"], "steps") % (1 << 32))
        self.steps, self.rows, self.losses = 0, [], []
        self.loader_s = 0.0
        # the first steps, through the window's own loader and step
        start = {n: t.detach().clone()
                 for n, t in self.model.module.named_parameters()}
        first = {}
        for i in range(int(p["first_steps"])):
            out = self._step()
            self.losses.append(float(out["loss"]))
            if i == 0:
                opt = self.state.optimizer
                b1 = opt.param_groups[0]["betas"][0]
                first = {n: first_moment_norm(opt, t) / (1.0 - b1)
                         for n, t in self.model.module.named_parameters()}
        change = leaf_norms({n: t.detach() - start[n] for n, t in
                             self.model.module.named_parameters()})
        self.first = dict(losses=list(self.losses), grad=first,
                          change=change, rows=list(self.rows))
        del start

    def _batch(self) -> Dict:
        """The loader's next batch (a new epoch where one ends), as
        run_training_css reads it."""
        try:
            return next(self.it)
        except StopIteration:
            self.epoch += 1
            self.loader.set_epoch(self.epoch)
            self.it = iter(self.loader)
            return next(self.it)

    def _step(self) -> Dict:
        t = time.perf_counter()
        with torch.profiler.record_function("gpubench.loader"):
            batch = self._batch()
        self.loader_s += time.perf_counter() - t
        rows = list(zip(batch["utterance_id"], batch["t0"]))
        self.rows.append((rows, list(batch["seg_len"])))
        with torch.profiler.record_function("gpubench.step"):
            dev_batch = self.T.to_device(batch, self.dev)
            lr = self.tc.learning_rate * self.schedule(0)
            self.generator.manual_seed(int(self.host_rng.randint(1 << 31)))
            out = self.step(self.state, dev_batch, lr, self.generator,
                            row_shifts(self.ctx["seed"], self.steps, rows,
                                       self.dev))
        self.steps += 1
        return out

    # -- the work ------------------------------------------------------
    def call(self) -> float:
        self._step()
        return float(self.tc.global_batch_size)

    def start_window(self) -> None:
        self.window_steps0 = self.steps
        self.loader_s = 0.0

    def window_record(self) -> Dict:
        n = self.steps - self.window_steps0
        T = (self.seg_len - self.cfg["frame_len"]) // self.cfg["frame_hop"] + 1
        step_flops = counts.train_step_flops(self.c, self.tc.global_batch_size,
                                             T)
        return dict(stages={"loader": self.loader_s},
                    counters={"steps": n},
                    work=dict(flops=step_flops * n, step_flops=step_flops),
                    attempted=n * self.tc.global_batch_size,
                    check_data=dict(first=self.first, sd=self.sd,
                                    root=self.root))

    def release(self) -> None:
        self.it = iter(())
        self.loader = self.dataset = None
        self.model = self.state = self.step = None


def setup(ctx: Dict) -> Cell:
    return Cell(ctx)


# ---------------------------------------------------------------------------
# the output check
# ---------------------------------------------------------------------------

def _reference(ctx: Dict, record: Dict, first: Dict) -> Dict:
    """The reference's steps over the rows the program's first steps
    read (cached in the record)."""
    cache = record.setdefault("_reference", {})
    if "ref" not in cache:
        data, cfg = record["check_data"], ctx["config"]
        dev = torch.device(ctx["device"])
        tc = cfg["train_cfg"]
        seg = int(tc["segment_len_secs"] * 16000)
        batches = [read_rows(data["root"], rows, seg, "cpu")
                   for rows, _ in first["rows"]]
        shifts = [row_shifts(ctx["seed"], i, rows, dev)
                  for i, (rows, _) in enumerate(first["rows"])]
        cache["batches"], cache["shifts"] = batches, shifts
        cache["ref"] = ref.train(data["sd"], model_dims(cfg), batches, shifts,
                                 tc["learning_rate"], tc["weight_decay"],
                                 tc["clip_grad_norm"])
    return cache["ref"]


def compare(got: Dict, want: Dict) -> Dict:
    """The check's numbers of one set of first steps against the
    reference's."""
    steps = [abs(a - b) / abs(b) for a, b in
             zip(got["losses"], want["losses"])]
    loss_err = steps[0]

    def worst(name, keep):
        med = float(np.median([want[name][n] for n in keep]))
        return max((abs(got[name][n] - want[name][n])
                    / max(want[name][n], med), n) for n in keep)

    leaves = list(want["grad"])
    med_raw = float(np.median([want["grad_raw"][n] for n in leaves]))
    moving = [n for n in leaves if want["grad_raw"][n] >= 1e-3 * med_raw]
    g, u = worst("grad", leaves), worst("change", moving)
    return dict(loss_err=loss_err, grad_err=g[0], update_err=u[0],
                loss_steps=steps, worst_grad=g[1], worst_update=u[1],
                excluded=[n for n in leaves if n not in moving])


def check(ctx: Dict, record: Dict) -> List[Check]:
    data, p = record["check_data"], ctx["traffic"]
    first = data["first"]
    try:
        plan_err = 0
        batch = ctx["config"]["train_cfg"]["global_batch_size"]
        for rows, lens in first["rows"]:
            plan_err += abs(len(rows) - batch) + \
                (len(rows) - len(set(rows))) + \
                sum(n != ctx["config"]["train_cfg"]["segment_len_secs"]
                    * 16000 for n in lens)
        want = _reference(ctx, record, first)
        r = compare(first, want)
        lim = p["limits"]
        return [Check("grad_err", r["grad_err"], float(lim["grad_err"])),
                Check("update_err", r["update_err"], float(lim["update_err"])),
                Check("plan_err", float(plan_err), 0.0)]
    finally:
        shutil.rmtree(data["root"], ignore_errors=True)


# ---------------------------------------------------------------------------
# the control and the faults
# ---------------------------------------------------------------------------

def program_steps(ctx: Dict, record: Dict, tf32: bool = False,
                  rows: slice = slice(None)) -> Dict:
    """The port's train step from the benchmark's weights over the rows
    the reference reads (rows: the part of each batch fed, a fault where
    not all), with TF32 on where asked (the control): the check's
    quantities."""
    from notsofar_tpu_torch.training import train as T
    cfg = ctx["config"]
    dev = torch.device(ctx["device"])
    tc = train_cfg(cfg)
    data = record["check_data"]
    cache = record["_reference"]
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        model = T.get_model(tc, dev, seed=0)
        model.module.load_state_dict(data["sd"])
        state = T.init_state(model, tc)
        step, _ = T.make_train_step(model, tc)
        start = {n: t.detach().clone()
                 for n, t in model.module.named_parameters()}
        g = torch.Generator(device=dev).manual_seed(0)
        losses, first = [], {}
        for i, (b, s) in enumerate(zip(cache["batches"], cache["shifts"])):
            out = step(state, {k: v[rows].to(dev) for k, v in b.items()},
                       tc.learning_rate, g, s[rows])
            losses.append(float(out["loss"]))
            if i == 0:
                opt = state.optimizer
                b1 = opt.param_groups[0]["betas"][0]
                first = {n: first_moment_norm(opt, t) / (1.0 - b1)
                         for n, t in model.module.named_parameters()}
        change = leaf_norms({n: t.detach() - start[n] for n, t in
                             model.module.named_parameters()})
        return dict(losses=losses, grad=first, change=change)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def control_readings(ctx: Dict, record: Dict) -> Dict:
    """The control (the port's step with TF32 on) and the half-batch
    fault, each against the reference."""
    want = _reference(ctx, record, record["check_data"]["first"])
    batch = ctx["config"]["train_cfg"]["global_batch_size"]
    out = {"program": compare(record["check_data"]["first"], want),
           "control": compare(program_steps(ctx, record, tf32=True), want),
           "half_batch": compare(program_steps(
               ctx, record, rows=slice(0, batch // 2)), want)}
    return out
