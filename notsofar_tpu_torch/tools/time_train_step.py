"""Time the CSS training step of the shipped recipe on the card, try a
global batch through the training entry point, or hold a data-parallel
step against one card.

    python3 -m notsofar_tpu_torch.tools.time_train_step [--batch 32] [--steps 5]
    python3 -m notsofar_tpu_torch.tools.time_train_step --entry --batch 256
    torchrun --nproc_per_node 4 -m notsofar_tpu_torch.tools.time_train_step --dp

The recipe is configs/train_css/conformer_v1.0_mc.yaml (Conformer-large,
f32, loss mask/l1, AdamW 1e-4 / 1e-2, clip 0.01) with seeded random
weights and seeded random 3 s segments; matmuls in f32 (TF32 off, as
PyTorch's default).

* default: a batch of --batch segments in device memory; after 3 warm-up
  steps, ms a step over --steps steps enqueued back to back, then over as
  many each followed by a device sync; then 2 steps under torch.profiler:
  the kernels' device ms a step, the card's busy share (that device time
  over the unprofiled step's ms; the profiler slows the host, not the
  kernels) and the ops and kernels with the most device time.
* --entry: writes a seeded simulated partition (write_train_data: 64
  utterances, 256 segments; 8 for validation) and runs
  run_training_css_gpu.py's main for 2 iterations at global batch --batch:
  whether it fits, and max_memory_allocated.
* --dp (under torchrun, one card a rank): one step on a global batch of
  --batch rows split over the ranks (NCCL) held against the same step on
  rank 0's card alone (training/parity.py at the card's tolerances), the
  host collectives, then run_training_css for 2 iterations under the
  group.

Each prints its lines and, last, a JSON object of its numbers. --device
cpu with --tiny (2 blocks, d 32, 0.5 s segments) runs the same on the
CPU, for tests; without --device the tool needs a card.
"""
import argparse
import json
import runpy
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from notsofar_tpu_torch.tools.common import card_line
from notsofar_tpu_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[2]
RECIPE = ROOT / "configs/train_css/conformer_v1.0_mc.yaml"
TINY = {"segment_len_secs": 0.5,
        "conformer_css_cfg.nnet_conf.conformer_conf.attention_dim": 32,
        "conformer_css_cfg.nnet_conf.conformer_conf.attention_heads": 4,
        "conformer_css_cfg.nnet_conf.conformer_conf.num_blocks": 2,
        "conformer_css_cfg.nnet_conf.conformer_conf.linear_units": 64,
        "conformer_css_cfg.nnet_conf.conformer_conf.kernel_size": 5}


def recipe_config(**over):
    """The shipped recipe's TrainCfg without mlflow, with `over` set
    (dotted keys)."""
    from notsofar_tpu_torch.training.config import TrainCfg
    from notsofar_tpu_torch.utils.conf import (load_yaml_to_dataclass,
                                               update_dataclass)
    cfg = load_yaml_to_dataclass(RECIPE, TrainCfg)
    return update_dataclass(cfg, dict(log_params_mlflow=False,
                                      log_metrics_mlflow=False, **over))


def write_train_data(root: Path, n_utts: int, seed: int,
                     seconds: float = 7.5, device="cuda") -> Path:
    """A simulated training partition in the reference byte format (the
    layout tests/test_training.py writes: one raw int16 file per column
    and utterance with a json record, a .map index), 3 speakers on 7 mics,
    drawn on `device` from a seeded generator; mixture = direct + reverb +
    noise. A 7.5 s utterance gives four 3 s segments."""
    root.mkdir(parents=True, exist_ok=True)
    n = int(seconds * 16000)
    g = torch.Generator(device=device).manual_seed(seed)
    utt_map = {}
    for u in range(n_utts):
        uid = f"{u:04d}_utt"
        utt_map[uid] = n
        direct = torch.randn(n, 7, 3, device=device, generator=g) * 0.05
        reverb = torch.randn(n, 7, 3, device=device, generator=g) * 0.01
        noise = torch.randn(n, 7, device=device, generator=g) * 0.01
        cols = {
            "mixture": direct.sum(-1) + reverb.sum(-1) + noise,
            "gt_spk_direct_early_echoes": direct, "gt_spk_reverb": reverb,
            "gt_noise": noise,
            "gt_spk_activity_scores": torch.randint(
                -1, 2, (n, 3), device=device, generator=g)}
        meta = {}
        for name, arr in cols.items():
            scaled = name != "gt_spk_activity_scores"
            dtype = torch.int16 if scaled else torch.int8
            q = (torch.clamp(arr * 30000.0, -32768, 32767) if scaled
                 else arr).to(dtype).cpu().numpy()
            row = int(np.prod(q.shape[1:]))
            meta[name] = dict(dtype=q.dtype.name, shape=list(q.shape),
                              itemsize=q.itemsize, element_in_row=row,
                              row_size=q.itemsize * row)
            if scaled:
                meta[name + "_scale"] = dict(values=str(30000.0))
            (root / f"{uid}.{name}").write_bytes(q.tobytes())
        (root / f"{uid}.json").write_text(json.dumps(
            dict(index_name=None, index_value=uid, columns=meta)))
    (root / "dataset-000000.map").write_text(json.dumps(utt_map))
    return root


def seeded_batch(rows: int, samples: int, device, seed: int = 30):
    """`rows` seeded segments of `samples` samples, 7 mics, 3 speakers."""
    rng = np.random.RandomState(seed)
    direct = (rng.randn(rows, samples, 7, 3) * 0.05).astype(np.float32)
    noise = (rng.randn(rows, samples, 7) * 0.01).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in
            {"mixture": direct.sum(-1) + noise,
             "gt_spk_direct_early_echoes": direct, "gt_noise": noise}.items()}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def time_step(cfg, dev, batch_size: int, steps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from notsofar_tpu_torch.training import train as T
    model = T.get_model(cfg, dev, seed=5)
    state = T.init_state(model, cfg)
    step, _ = T.make_train_step(model, cfg)
    batch = seeded_batch(batch_size, int(cfg.segment_len_secs * cfg.fs), dev)
    g = torch.Generator(device=dev)
    out = {}
    for _ in range(3):
        step(state, batch, cfg.learning_rate, g)
    for sync in (False, True):
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, batch, cfg.learning_rate, g)
            if sync:
                _sync(dev)
        _sync(dev)
        out["ms_synced" if sync else "ms"] = \
            (time.perf_counter() - t0) / steps * 1e3
    acts = [ProfilerActivity.CPU] + \
        ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step(state, batch, cfg.learning_rate, g)
        _sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    # kernels only: each op's device time is also its kernels'
    device_ms = sum(e.self_device_time_total for e in ka
                    if e.device_type.name == "CUDA") / 1e3
    out.update(profiled_wall_ms=wall / 2, device_ms=device_ms / 2,
               busy=device_ms / 2 / out["ms"])
    top = sorted(ka, key=lambda e: -e.self_device_time_total)[:12]
    out["top_ops"] = [(e.key[:60], round(e.self_device_time_total / 2e3, 3),
                       e.count // 2) for e in top
                      if e.self_device_time_total > 0]
    print(f"batch {batch_size}: {out['ms']:.2f} ms a step enqueued back to "
          f"back, {out['ms_synced']:.2f} ms synchronized; profiled: "
          f"{out['device_ms']:.2f} ms of kernel time a step "
          f"({100 * out['busy']:.1f}% of the unprofiled step; "
          f"{out['profiled_wall_ms']:.2f} ms a step profiled)")
    for name, ms, calls in out["top_ops"]:
        print(f"  {ms:9.3f} ms a step, {calls:5d} calls  {name}")
    return out


def try_entry(cfg_over: dict, dev, batch_size: int) -> dict:
    """run_training_css_gpu.py's main for 2 iterations at `batch_size` on
    a seeded partition: whether it fits, and the peak memory."""
    import yaml

    from notsofar_tpu_torch.utils.conf import dataclass_to_dict
    main = runpy.run_path(str(ROOT / "run_training_css_gpu.py"))["main"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        seconds = 7.5 * cfg_over.get("segment_len_secs", 3.0) / 3.0
        write_train_data(tmp / "train", 64, 40, seconds, dev)
        write_train_data(tmp / "val", 8, 41, seconds, dev)
        cfg = recipe_config(
            global_batch_size=batch_size, train_dir=str(tmp / "train"),
            val_dir=str(tmp / "val"), out_dir="run",
            stop_after=(2, "iterations"), eval_every=(2, "iterations"),
            save_every=None, **cfg_over)
        conf = tmp / "conf.yaml"
        conf.write_text(yaml.safe_dump(dataclass_to_dict(cfg)))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = {"batch": batch_size}
        try:
            main(["--conf", str(conf), "--data_root_out", str(tmp),
                  "--device", str(dev)])
            out["fits"] = True
        except torch.cuda.OutOfMemoryError as e:
            out["fits"] = False
            out["error"] = str(e)[:300]
        out["seconds"] = time.perf_counter() - t0
        out["peak_gib"] = (torch.cuda.max_memory_allocated() / 2 ** 30
                           if dev.type == "cuda" else None)
    print(f"global batch {batch_size} through run_training_css_gpu.py: "
          f"{'fits' if out['fits'] else 'out of memory'}, 2 iterations with "
          f"eval in {out['seconds']:.1f} s, max_memory_allocated "
          f"{out['peak_gib']} GiB")
    return out


def dp_check(cfg_over: dict, dev, batch_size: int) -> dict:
    """One step over the process group against rank 0 alone, then a short
    run under the group. Returns rank 0's numbers (others: {})."""
    import torch.distributed as dist

    from notsofar_tpu_torch.parallel import mesh
    from notsofar_tpu_torch.training import parity
    from notsofar_tpu_torch.training import train as T

    if not mesh.maybe_initialize_distributed(dev):
        raise SystemExit("--dp runs under torchrun with 2 or more processes")
    rank, world = mesh.process_rank_and_count()
    cfg = recipe_config(**cfg_over)
    samples = int(cfg.segment_len_secs * cfg.fs)
    shifts = torch.from_numpy(np.random.RandomState(1).randint(
        0, 6, batch_size))

    def one_step(rank, world):
        model = T.get_model(cfg, dev, seed=21 + rank)
        mesh.replicate_module(model.module)
        state = T.init_state(model, cfg)
        train_step, _ = T.make_train_step(model, cfg)
        rows = slice(rank * batch_size // world,
                     (rank + 1) * batch_size // world)
        batch = {k: v[rows] for k, v in
                 seeded_batch(batch_size, samples, dev).items()}
        before = {n: p.detach().clone()
                  for n, p in model.module.named_parameters()}
        metrics = train_step(state, batch, cfg.learning_rate,
                             torch.Generator(device=dev),
                             shifts[rows].to(dev))
        metrics = {k: mesh.all_reduce_mean(v) for k, v in metrics.items()}
        return parity.step_record(state, before, metrics)

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    rec = one_step(rank, world)
    host = [mesh.all_reduce_max_host(rank),
            mesh.gather_dicts_to_zero({"rank": rank})]
    torch.backends.cudnn.allow_tf32 = tf32
    work = ROOT / "chiprun_out" / "time_train_step_dp"
    if rank == 0:
        shutil.rmtree(work, ignore_errors=True)
        seconds = 7.5 * cfg.segment_len_secs / 3.0
        write_train_data(work / "train", 64, 40, seconds, dev)
        write_train_data(work / "val", 8, 41, seconds, dev)
    mesh.barrier()
    t0 = time.perf_counter()
    T.run_training_css(recipe_config(
        global_batch_size=batch_size, stop_after=(2, "iterations"),
        eval_every=(2, "iterations"), save_every=(2, "iterations"),
        **cfg_over), str(work / "train"), str(work / "val"),
        str(work / "run"), device=dev)
    loop_s = time.perf_counter() - t0
    mesh.barrier()
    ckpts = sorted(p.name for p in (work / "run" / "checkpoints").glob("*.pt"))
    mesh.barrier()
    dist.destroy_process_group()
    if rank != 0:
        return {}
    shutil.rmtree(work, ignore_errors=True)
    torch.backends.cudnn.allow_tf32 = False
    one = one_step(0, 1)
    torch.backends.cudnn.allow_tf32 = tf32
    kw = dict(lr=cfg.learning_rate, weight_decay=cfg.weight_decay,
              scalar_rtol=parity.CARD_SCALAR_RTOL)
    out = {"world": world, "batch": batch_size,
           "mismatches": parity.step_mismatches(one, rec, parity.CARD_RTOL,
                                                **kw),
           "ratios": parity.error_ratios(one, rec, parity.CARD_RTOL,
                                         cfg.learning_rate,
                                         parity.CARD_SCALAR_RTOL),
           "loss": [rec["scalars"]["loss"], one["scalars"]["loss"]],
           "grad_norm": [rec["scalars"]["grad_norm"],
                         one["scalars"]["grad_norm"]],
           "host": host, "loop_s": loop_s, "checkpoints": ckpts}
    print(f"{world} ranks x {batch_size // world} rows against one device x "
          f"{batch_size} rows, one step: loss {out['loss']}, grad norm "
          f"{out['grad_norm']}; errors over their tolerance "
          + ", ".join(f"{k} {v:.3g}" for k, v in out["ratios"].items())
          + f"; mismatches {out['mismatches'][:5]}")
    print(f"host collectives {host}; run_training_css 2 iterations under "
          f"the group in {loop_s:.1f} s, checkpoints {ckpts}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--entry", action="store_true")
    ap.add_argument("--dp", action="store_true")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    over = TINY if args.tiny else {}
    torch.backends.cuda.matmul.allow_tf32 = False
    if dev.type == "cuda":
        print(f"device: {card_line()}")
    if args.dp:
        out = dp_check(over, dev, args.batch)
    elif args.entry:
        out = try_entry(over, dev, args.batch)
    else:
        out = time_step(recipe_config(**over), dev, args.batch, args.steps)
    if out:
        print(json.dumps(out, default=float))
    return out


if __name__ == "__main__":
    main()
