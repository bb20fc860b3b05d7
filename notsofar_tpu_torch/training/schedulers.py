"""LR schedules as pure step -> multiplier functions.

Copy of notsofar_tpu/training/schedulers.py (the reference's schedulers
plus StepLR). The trainer decouples the schedule step counter from the
optimizer step (the reference's `scheduler_step_every` frequency), so
schedules are plain callables of the *scheduler* step.
"""
import warnings

from notsofar_tpu_torch.training.config import (LinearWarmupDecayCfg,
                                                SchedulerStepLrCfg)


def linear_warmup_decay(cfg: LinearWarmupDecayCfg):
    def fn(step: int) -> float:
        if step < cfg.warmup:
            return step / cfg.warmup
        if step < cfg.warmup + cfg.decay:
            return 1.0 - (step - cfg.warmup) / cfg.decay
        if step > cfg.warmup + cfg.decay:
            warnings.warn(f"Learning rate has been decayed to zero! {step=}")
        return 0.0
    return fn


def step_lr(cfg: SchedulerStepLrCfg):
    def fn(step: int) -> float:
        return cfg.gamma ** (step // cfg.step_size)
    return fn


def make_schedule(name: str, step_lr_cfg: SchedulerStepLrCfg,
                  warmup_decay_cfg: LinearWarmupDecayCfg):
    if name == "step_lr":
        return step_lr(step_lr_cfg)
    if name == "linear_warmup_decay":
        return linear_warmup_decay(warmup_decay_cfg)
    raise ValueError(f"Unknown scheduler name: {name}!")
