"""CSS trainer: a data-parallel AdamW loop with checkpoints.

Port of notsofar_tpu/training/train.py (the reference run_training_css):

* data parallelism: one process per card (torchrun); each reads its shard
  of every batch (the loader's shard_index / num_shards), rank 0's weights
  are broadcast at the start and every gradient is averaged over the ranks
  (parallel/mesh.py), where the JAX package shards the batch over a mesh
  axis and XLA inserts the all-reduce. Batch statistics are the global
  batch's in both (models/titanet.py BatchNorm);
* one train step: mic-shift augmentation, STFT features, the Conformer
  forward in train mode, the PIT loss, the backward pass, the global-norm
  clip with optax's formula (g * c / ||g|| when ||g|| >= c, else g) and
  torch.optim.AdamW (betas 0.9/0.999, eps 1e-8, decoupled weight decay on
  every parameter, as optax.adamw); the LR is set into the optimizer each
  step as learning_rate x schedule(scheduler_step) (optax's
  inject_hyperparams);
* the scheduler step counter is decoupled from the optimizer step
  (`scheduler_step_every` frequency tuples);
* checkpoints (torch.save, the newest cfg.checkpoint_keep kept) hold the
  parameters, the batch-norm running statistics, the constants, the
  optimizer state, `step` and `scheduler_step`. Restoring resumes what the
  JAX package's restore resumes: the loader position and the per-step RNG
  start afresh, as there;
* metrics stay on the device until an eval boundary; each is a mean over
  the global batch (averaged over the ranks); mlflow logging is
  import-guarded like the reference's.

Every random draw (dropout masks, mic shifts) comes from one
torch.Generator on the device, reseeded each step from a numpy RandomState
(the JAX package's per-step PRNG key) and the rank. Entry points run on
``cuda`` unless ``device="cpu"`` is passed.
"""
import dataclasses
import os
from dataclasses import dataclass
from functools import partial
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from notsofar_tpu_torch.models.css_wrapper import CssModel
from notsofar_tpu_torch.parallel.mesh import (all_reduce_mean,
                                              average_gradients, barrier,
                                              process_rank_and_count,
                                              replicate_module)
from notsofar_tpu_torch.training.augmentations import mic_shift_augment
from notsofar_tpu_torch.training.config import TrainCfg
from notsofar_tpu_torch.training.dataset import (DataLoader, SegmentSplitter,
                                                 SimulatedDataset)
from notsofar_tpu_torch.training.losses import css_loss
from notsofar_tpu_torch.training.schedulers import make_schedule
from notsofar_tpu_torch.utils.device import resolve_device
from notsofar_tpu_torch.utils.logging_def import get_logger

_LOG = get_logger("train")

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
STAT_BUFFERS = ("running_mean", "running_var")
CONSTANTS = ("input_bias", "input_scale")


@dataclass
class TrainState:
    """The model (parameters, batch-norm statistics, constants), its
    optimizer and the optimizer step count."""
    model: CssModel
    optimizer: torch.optim.AdamW
    step: int = 0


def get_model(cfg: TrainCfg, device=None, seed: int = 0) -> CssModel:
    """The configured CSS model with seeded random weights, in train mode.
    cfg.dtype (float32 or bfloat16) is the compute dtype; weights stay
    f32."""
    if cfg.model_name != "css_with_conformer":
        raise ValueError(f"Unknown model name: {cfg.model_name}!")
    return CssModel(cfg.conformer_css_cfg.freeze(), dtype=DTYPES[cfg.dtype],
                    device=device, seed=seed).train()


def make_optimizer(cfg: TrainCfg, params) -> torch.optim.AdamW:
    """optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay) on every
    parameter; the clip is clip_by_global_norm, run by the train step."""
    return torch.optim.AdamW(params, lr=cfg.learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=cfg.weight_decay)


def init_state(model: CssModel, cfg: TrainCfg) -> TrainState:
    return TrainState(model=model,
                      optimizer=make_optimizer(cfg, model.module.parameters()))


def clip_by_global_norm(params, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the gradients, in place: g * (c / n)
    when the global norm n >= c, else g (no 1e-6 in the denominator, unlike
    torch's clip_grad_norm_). max_norm 0: no clip. Returns n, a 0-d tensor
    on the device (no host sync)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.nn.utils.get_total_norm(grads)
    if max_norm > 0:
        scale = torch.where(norm < max_norm, torch.ones_like(norm),
                            max_norm / norm)
        torch._foreach_mul_(grads, scale)
    return norm


def make_train_step(model: CssModel, cfg: TrainCfg):
    """(train_step, eval_step) over batches of tensors on the model's
    device. Each returns a dict of 0-d device tensors: 'loss' and, with
    cfg.calc_side_info, the side info; train_step also 'grad_norm' (the
    global norm before the clip)."""
    is_mc = not cfg.single_channel
    params = list(model.module.parameters())

    def loss_of(batch, generator=None):
        res = model.forward(batch["mixture"], generator)
        return css_loss(model, res, batch, cfg.loss_name, cfg.base_loss_name,
                        cfg.noise_weight, cfg.clip_gt_to_mixture,
                        cfg.calc_side_info)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   lr: float, generator: torch.Generator,
                   shifts: Optional[torch.Tensor] = None):
        """One optimizer step on this rank's rows. The mic shifts are
        drawn from `generator` unless given."""
        model.train()
        if is_mc:
            batch = mic_shift_augment(batch, generator, shifts)
        loss, side = loss_of(batch, generator)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        average_gradients(params)
        grad_norm = clip_by_global_norm(params, cfg.clip_grad_norm)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach(), **(side or {}), "grad_norm": grad_norm}

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model.train(False)
        loss, side = loss_of(batch)
        return {"loss": loss, **(side or {})}

    return train_step, eval_step


def to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """The float columns of a loader batch as tensors on `device` (pinned
    and copied asynchronously to a card, so the host runs ahead)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.dtype != np.int8:
            t = torch.from_numpy(v)
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t
    return out


# --------------------------------------------------------------------------
# checkpointing (torch.save)
# --------------------------------------------------------------------------

def _state_tensors(state: TrainState) -> Dict[str, Dict[str, torch.Tensor]]:
    """The model's tensors by collection, as the JAX package's variables
    hold them: params, batch_stats (running statistics), constants."""
    out = {"params": {}, "batch_stats": {}, "constants": {}}
    for k, v in state.model.module.state_dict().items():
        name = k.rsplit(".", 1)[-1]
        col = ("batch_stats" if name in STAT_BUFFERS
               else "constants" if k in CONSTANTS else "params")
        out[col][k] = v.detach().cpu()
    return out


def _checkpoints(path: Path):
    return sorted((int(p.stem), p) for p in path.glob("*.pt")
                  if p.stem.isdigit())


def save_checkpoint(out_dir: str, state: TrainState, scheduler_step: int,
                    keep: int = 3) -> str:
    """Write out_dir/checkpoints/<step>.pt (written to a temporary name,
    then renamed) and keep the newest `keep`. Returns the directory."""
    path = Path(out_dir).absolute() / "checkpoints"
    path.mkdir(parents=True, exist_ok=True)
    ckpt = dict(_state_tensors(state), opt_state=state.optimizer.state_dict(),
                step=state.step, scheduler_step=scheduler_step)
    final = path / f"{state.step}.pt"
    tmp = path / f".{state.step}.pt.tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, final)
    for _, old in _checkpoints(path)[:-keep]:
        old.unlink()
    return str(path)


def restore_checkpoint(out_dir: str, state: TrainState
                       ) -> Tuple[TrainState, int]:
    """Restore the latest checkpoint into `state` (exact mid-train resume
    of the weights, statistics, optimizer and step counters)."""
    found = _checkpoints(Path(out_dir).absolute() / "checkpoints")
    if not found:
        return state, 0
    ckpt = torch.load(found[-1][1], map_location="cpu", weights_only=True)
    sd = {**ckpt["params"], **ckpt["batch_stats"], **ckpt["constants"]}
    state.model.module.load_state_dict(sd)
    state.optimizer.load_state_dict(ckpt["opt_state"])
    state.step = int(ckpt["step"])
    return state, int(ckpt["scheduler_step"])


# --------------------------------------------------------------------------
# the loop
# --------------------------------------------------------------------------

def _is_every(freq: Optional[Tuple], epoch: int, iter_in_epoch: int,
              num_batches: int, total_iters: int) -> bool:
    if freq is None:
        return False
    n, unit = freq
    if unit == "epochs":
        return epoch % n == 0 and iter_in_epoch == num_batches
    if unit == "iterations":
        return total_iters % n == 0
    raise ValueError(f"Unknown frequency type: {unit}!")


def run_training_css(train_cfg: TrainCfg, train_dir: str, val_dir: str,
                     out_dir: str, resume: bool = False, datasets=None,
                     device=None) -> str:
    """Full training loop. Returns out_dir. Under torchrun, call
    parallel.mesh.maybe_initialize_distributed first: each process then
    trains on its shard with global_batch_size / world rows a step."""
    cfg = train_cfg
    dev = resolve_device(device)
    rank, world = process_rank_and_count()
    _LOG.info("Starting training")
    _LOG.info(f"{cfg}")
    attempt_load_mlflow()
    if cfg.log_params_mlflow:
        log_params_to_mlflow(cfg)
    _LOG.info(f"Data parallel over {world} process(es) on {dev}")

    model = get_model(cfg, dev, seed=cfg.seed + 40973)
    state = init_state(model, cfg)
    scheduler_step = 0
    if resume:
        state, scheduler_step = restore_checkpoint(out_dir, state)
        _LOG.info(f"Resumed at step {state.step} "
                  f"(scheduler step {scheduler_step})")
    replicate_module(model.module)

    schedule = make_schedule(cfg.scheduler_name, cfg.scheduler_step_lr_cfg,
                             cfg.scheduler_linear_warmup_decay_cfg)
    train_step, eval_step = make_train_step(model, cfg)

    if datasets is None:
        seg_len = int(cfg.segment_len_secs * cfg.fs)
        splitter = SegmentSplitter(
            min_overlap=int(seg_len * cfg.segment_min_overlap_factor),
            max_overlap=int(seg_len * cfg.segment_max_overlap_factor),
            pr_force_align=cfg.segment_pr_force_align,
            desired_segm_len=seg_len)
        needed = ["mixture", "gt_spk_direct_early_echoes", "gt_noise"]
        train_set = SimulatedDataset(
            train_dir, splitter, seed=44697134,
            sample_frac=cfg.train_set_cfg.sample_frac,
            max_urls=cfg.train_set_cfg.max_urls,
            single_channel=cfg.single_channel, needed_columns=needed)
        val_set = SimulatedDataset(
            val_dir, splitter, seed=836591172,
            sample_frac=cfg.val_set_cfg.sample_frac,
            max_urls=cfg.val_set_cfg.max_urls,
            single_channel=cfg.single_channel, needed_columns=needed)
    else:
        train_set, val_set = datasets
    _LOG.info(f"Training set: {len(train_set)} segments, "
              f"{train_set.get_length_seconds() / 3600:.4} hours")
    _LOG.info(f"Validation set: {len(val_set)} segments, "
              f"{val_set.get_length_seconds() / 3600:.4} hours")

    workers = 0 if cfg.is_debug else cfg.dataloader_workers
    local_batch = cfg.global_batch_size // world
    # drop_last=False, as the reference's torch DataLoader; the loader pads
    # the shards to one size, so every rank runs the same steps
    train_loader = DataLoader(train_set, local_batch, shuffle=True,
                              seed=cfg.seed + 46117, num_threads=workers,
                              drop_last=False, shard_index=rank,
                              num_shards=world)
    val_loader = DataLoader(val_set, local_batch, shuffle=False,
                            num_threads=workers, drop_last=False,
                            shard_index=rank, num_shards=world)

    n_params = sum(p.numel() for p in model.module.parameters())
    _LOG.info(f"Model size: {n_params:,} params")

    total_iters = 1
    num_instances = 0
    pending_metrics: list = []  # device-side scalars; synced only at eval
    stop = False
    epoch = 0
    host_rng = np.random.RandomState(cfg.seed + 2112)
    generator = torch.Generator(device=dev)

    def drain_metrics() -> Dict[str, float]:
        """Sum the pending metrics, weighted by the global batch size, in
        one host sync (and one all-reduce: each rank's metric is its local
        rows' mean, and the ranks hold as many rows)."""
        nonlocal pending_metrics
        if not pending_metrics:
            return {}
        keys = list(pending_metrics[0][1])
        sums = sum(bs * torch.stack([m[k].float() for k in keys])
                   for bs, m in pending_metrics)
        pending_metrics = []
        return dict(zip(keys, all_reduce_mean(sums).tolist()))

    while not stop:
        epoch += 1
        _LOG.info(f"Starting epoch {epoch}")
        train_loader.set_epoch(epoch)
        num_batches = len(train_loader)
        if num_batches == 0:
            raise RuntimeError("empty training loader (batch > dataset?)")

        for iter_in_epoch, batch in enumerate(train_loader, start=1):
            if stop:
                break
            batch = to_device(batch, dev)
            lr = cfg.learning_rate * schedule(scheduler_step)
            generator.manual_seed(int(host_rng.randint(1 << 31))
                                  + rank * (1 << 31))
            metrics = train_step(state, batch, lr, generator)
            if iter_in_epoch % 10 == 0:
                _LOG.info(f"ep{epoch} it{iter_in_epoch}/{num_batches} "
                          f"tot_it{total_iters}: .")
            # metrics stay on the device until the next eval boundary:
            # reading them every step would make the host wait for each
            # step instead of reading the next batch meanwhile
            pending_metrics.append((cfg.global_batch_size, metrics))
            num_instances += cfg.global_batch_size

            every = partial(_is_every, epoch=epoch,
                            iter_in_epoch=iter_in_epoch,
                            num_batches=num_batches, total_iters=total_iters)
            if every(cfg.scheduler_step_every):
                scheduler_step += 1
            if every(cfg.stop_after):
                _LOG.info("Stopping training")
                stop = True
            if every(cfg.eval_every) or stop:
                _LOG.info("Evaluating")
                acc = drain_metrics()
                assert np.isfinite(acc.get("loss", 0.0)), "loss is not finite!"
                val_metrics = eval_model(eval_step, state, val_loader, dev)
                train_metrics = {f"train/{k}": v / max(num_instances, 1)
                                 for k, v in acc.items()}
                all_metrics = {**train_metrics,
                               **{f"val/{k}": v for k, v in val_metrics.items()},
                               "lr": lr,
                               "train/num_instances": num_instances}
                _LOG.info(f"ep{epoch} it{iter_in_epoch}: {all_metrics}")
                if cfg.log_metrics_mlflow:
                    log_metrics_to_mlflow(all_metrics, step=total_iters)
                num_instances = 0
            if every(cfg.save_every) or stop:
                if rank == 0:
                    path = save_checkpoint(out_dir, state, scheduler_step,
                                           keep=cfg.checkpoint_keep)
                    _LOG.info(f"Saved checkpoint at step {state.step} "
                              f"to {path}")
                barrier()
            total_iters += 1

    _LOG.info("Finished training")
    return out_dir


def eval_model(eval_step, state, val_loader, device) -> Dict[str, float]:
    """Average metrics over the validation loader. The loader pads the
    shards to one size, so every rank runs the same eval steps; each
    batch's metrics are averaged over the ranks, and the weights below
    (local batch sizes, equal on every rank) cancel."""
    sums: Dict[str, float] = {}
    n = 0
    for batch in val_loader:
        batch = to_device(batch, device)
        bs = batch["mixture"].shape[0]
        metrics = eval_step(state, batch)
        keys = list(metrics)
        vals = all_reduce_mean(torch.stack([metrics[k] for k in keys]))
        for k, v in zip(keys, vals.tolist()):
            sums[k] = sums.get(k, 0.0) + bs * v
        n += bs
    return {k: v / max(n, 1) for k, v in sums.items()}


# --------------------------------------------------------------------------
# optional mlflow (import-guarded, the reference's train.py:615-649)
# --------------------------------------------------------------------------
mlflow = None


def attempt_load_mlflow():
    global mlflow
    if mlflow is None:
        try:
            mlflow = __import__("mlflow")
        except ImportError:
            pass


def log_params_to_mlflow(d, prefix=""):
    if mlflow is None:
        return
    for f in dataclasses.fields(d):
        value = getattr(d, f.name)
        name = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(value):
            log_params_to_mlflow(value, prefix=name + ".")
        else:
            mlflow.log_param(name, value)


def log_metrics_to_mlflow(metrics: dict, step: int):
    if mlflow is None:
        return
    mlflow.log_metrics(metrics, step=step)
