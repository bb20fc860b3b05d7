"""Error models for holding one training step against another.

A step is summarized by `step_record`: its metrics, and per parameter the
gradient (after the clip), the update p1 - p0, AdamW's moments, and the
batch-norm running statistics after the step. `step_mismatches` holds one
record against a reference:

* scalars (loss, side info, global gradient norm) within `scalar_rtol`
  relative (default `rtol`);
* gradients, moments and running statistics within `rtol` of a scale:
  the largest magnitude of the reference tensor, or FLOOR of the largest
  of its kind in any tensor if that is more (sums in another order move
  each element by a share of the scale of its terms, not of its own value;
  a gradient that is 0 but for rounding, such as a bias ahead of a
  normalization, has terms of the other gradients' scale);
* the update elementwise within the change of Adam's step
  lr * m_hat / (sqrt(v_hat) + eps) over the box m +- dm, v +- dv, dm and dv
  being the moments' tolerances above. The step is ~lr * sign(g) wherever
  |g| >> eps, so a tolerance on the parameters after a step would pass a
  wrong update; this bound is tight there and opens only where the
  gradient's own tolerance spans 0.

`adam_mismatches` holds one record to itself: its update is AdamW's step
from its own moments, within the decay term and two roundings of the
weights.

The tests hold the port against the JAX package and two processes against
one with it, chip_smoke.py the card against the CPU.
"""
from typing import Dict, List, Tuple

import numpy as np
import torch

FLOOR = 1e-2   # share of a kind's largest magnitude that every tensor's
               # scale reaches at least

# The card against the CPU (or one card against several) at the shipped
# recipe's full width, f32: scalars relative, arrays against their scale.
# There the devices' roundings put a few ReLU inputs on the other side of 0
# (22 of 17 M in one step), and each such unit moves its weights' gradients
# by up to a few % of their scale (4.9% measured, chip_smoke.py phase 10 on
# an H100); the CPU against itself with the batch's rows swapped, the same
# math in another order, moves the gradients that are 0 but for rounding
# by up to 9.5x their own scale.
CARD_RTOL = 0.1
CARD_SCALAR_RTOL = 1e-3


def step_record(state, params_before: Dict[str, torch.Tensor],
                metrics: Dict[str, torch.Tensor]) -> Dict:
    """Summarize the step that just ran on `state` (training.train
    TrainState) from the parameters before it, as f64 numpy arrays."""
    module, opt = state.model.module, state.optimizer

    def a(t):
        return t.detach().to("cpu", torch.float64).numpy()

    rec = {"scalars": {k: float(v) for k, v in metrics.items()},
           "grad": {}, "update": {}, "exp_avg": {}, "exp_avg_sq": {},
           "stats": {}, "pmax": {}, "step": None}
    for name, p in module.named_parameters():
        rec["grad"][name] = a(p.grad)
        rec["update"][name] = a(p) - a(params_before[name])
        rec["pmax"][name] = float(params_before[name].abs().max())
        st = opt.state[p]
        rec["exp_avg"][name] = a(st["exp_avg"])
        rec["exp_avg_sq"][name] = a(st["exp_avg_sq"])
        rec["step"] = int(st["step"])
    for name, b in module.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            rec["stats"][name] = a(b)
    return rec


def adam_step_bound(m, v, dm, dv, count: int, lr: float, b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-8) -> np.ndarray:
    """The largest change of lr * m_hat / (sqrt(v_hat) + eps) over the box
    [m - dm, m + dm] x [max(v - dv, 0), v + dv] (elementwise). The step is
    linear in m and monotone in v, so the extremes lie on the corners."""
    bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count

    def f(mm, vv):
        return (mm / bc1) / (np.sqrt(np.maximum(vv, 0.0) / bc2) + eps)

    f0 = f(m, v)
    worst = np.zeros_like(f0)
    for sm in (-1, 1):
        for sv in (-1, 1):
            worst = np.maximum(worst, np.abs(f(m + sm * dm, v + sv * dv) - f0))
    return lr * worst


def adam_mismatches(rec: Dict, lr: float, weight_decay: float,
                    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
                    ) -> List[str]:
    """Where `rec`'s update is not AdamW's step from its own moments:
    |update + lr * m_hat / (sqrt(v_hat) + eps)| may reach the decay term
    lr * wd * max|p|, two roundings of the weights (2^-22 max|p|) and
    1e-5 lr."""
    out = []
    bc1, bc2 = 1 - b1 ** rec["step"], 1 - b2 ** rec["step"]
    for name, u in rec["update"].items():
        m, v = rec["exp_avg"][name], rec["exp_avg_sq"][name]
        step = lr * (m / bc1) / (np.sqrt(v / bc2) + eps)
        pmax = rec["pmax"][name]
        tol = lr * weight_decay * pmax + 2.0 ** -22 * pmax + 1e-5 * lr
        err = np.abs(u + step).max()
        if not err <= tol:
            out.append(f"adam {name}: max err {err:.3e} > {tol:.3e}")
    return out


def _ratios(ref: Dict, got: Dict, rtol: float, lr: float,
            weight_decay: float = 0.0, param_tol: Dict = None,
            scalar_rtol: float = None) -> List[Tuple[str, str, float]]:
    """(kind, name, the largest error over its tolerance) for every scalar
    and tensor of the record (<= 1 holds)."""
    srtol = rtol if scalar_rtol is None else scalar_rtol
    out = [("scalars", k,
            abs(got["scalars"][k] - r) / (srtol * abs(r) + 1e-30))
           for k, r in ref["scalars"].items()]
    tol = tolerances(ref, rtol)
    for kind in tol:
        out += [(kind, n, np.abs(got[kind][n] - r).max() / tol[kind][n])
                for n, r in ref[kind].items()]
    for n, bound in update_bounds(ref, rtol, lr).items():
        if param_tol is not None:
            bound = bound + lr * weight_decay * param_tol[n]
        out.append(("update", n, (np.abs(got["update"][n] - ref["update"][n])
                                  / bound).max()))
    return out


def step_mismatches(ref: Dict, got: Dict, rtol: float, lr: float,
                    weight_decay: float, param_tol: Dict = None,
                    scalar_rtol: float = None) -> List[str]:
    """What in `got` lies outside the tolerance around `ref` (empty: it
    holds), one line per scalar or tensor. param_tol: per parameter, how
    far the parameters before this step may already differ (the sum of
    earlier steps' update bounds); the decay term lr * wd * p carries
    it."""
    out = [] if got["step"] == ref["step"] else \
        [f"optimizer step {got['step']} vs {ref['step']}"]
    for kind, name, ratio in _ratios(ref, got, rtol, lr, weight_decay,
                                     param_tol, scalar_rtol):
        if not ratio <= 1:
            where = name if kind == "scalars" else f"{kind} {name}"
            out.append(f"{where}: {ratio:.3g} x its tolerance")
    return out


def tolerances(ref: Dict, rtol: float) -> Dict[str, Dict[str, float]]:
    """Per kind and tensor, the largest error allowed: rtol x the larger of
    the tensor's largest magnitude and FLOOR x its kind's largest."""
    out = {}
    for kind in ("grad", "exp_avg", "exp_avg_sq", "stats"):
        top = max((np.abs(r).max() for r in ref[kind].values()), default=0.0)
        out[kind] = {name: rtol * max(np.abs(r).max(), FLOOR * top) + 1e-30
                     for name, r in ref[kind].items()}
    return out


def update_bounds(ref: Dict, rtol: float, lr: float) -> Dict[str, np.ndarray]:
    """Per parameter, the elementwise bound step_mismatches holds `ref`'s
    update to (without the decay term), which is also how far the
    parameters may differ after this step: Adam's step over the moments'
    tolerance box, plus 1e-6 lr for the update's own roundings."""
    tol = tolerances(ref, rtol)
    return {name: adam_step_bound(ref["exp_avg"][name],
                                  ref["exp_avg_sq"][name],
                                  tol["exp_avg"][name],
                                  tol["exp_avg_sq"][name], ref["step"], lr)
            + 1e-6 * lr
            for name in ref["update"]}


def error_ratios(ref: Dict, got: Dict, rtol: float, lr: float,
                 scalar_rtol: float = None) -> Dict[str, float]:
    """Per kind (scalars, grad, exp_avg, exp_avg_sq, stats, update), the
    largest error over its tolerance (<= 1 holds; the update's without
    the decay term), and 'tight': the share of update elements whose
    bound is at most 0.1 lr."""
    out: Dict[str, float] = {}
    for kind, _, ratio in _ratios(ref, got, rtol, lr,
                                  scalar_rtol=scalar_rtol):
        out[kind] = max(out.get(kind, 0.0), ratio)
    bounds = update_bounds(ref, rtol, lr)
    out["tight"] = sum(int((b <= 0.1 * lr).sum()) for b in bounds.values()) \
        / sum(b.size for b in bounds.values())
    return out
