"""Data parallelism of the port's trainer over torch.distributed (gloo) on
the CPU: two processes, each holding half of a global batch of 4, against
one process holding all of it.

The children are this file run as a script (`python
test_torch_training_dp.py <rank> <world> <port> <out> <global|local>`):
each joins a gloo group on localhost through
maybe_initialize_distributed (the torchrun environment), runs one train
step on its rows (dropout 0, fixed mic shifts) and the host collectives,
and rank 0 writes the step's record (training/parity.py) with the
metrics averaged over the ranks. Rank 0's
weights reach both ranks through replicate_module, the gradients are
averaged by average_gradients and the batch norm's statistics are summed
over the ranks (all_reduce_sum), so the two-process step equals the
one-process step up to f32 summation order: the loss, side info and
gradient norm within 1e-6 relative (measured: 1.5e-7), gradients, moments
and statistics within 1e-4 of their scale and the update within Adam's
step over that box (training/parity.py, the tolerance the port is held
to against the JAX package). The scalar taps' gradients, sums over every
row, frame and feature, reach 3.2e-5 of their scale (split over two
processes the sums run in another order), so 1e-5 would fail them; the
largest update difference is 0.016 lr, in a gradient that is 0 but for
rounding. The local-BN mutant (each rank normalizes by its own
rows' statistics, the child's `local`) falls outside: the loss, the
gradients and the running statistics move.
"""
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
LR = 1e-3
SCALAR_RTOL = 1e-6
RTOL = 1e-4


def step_once(rank: int, world: int) -> dict:
    """One train step of a seeded tiny MC model on rows
    [rank * 4 / world, (rank + 1) * 4 / world) of a seeded global batch of
    4, recorded with the metrics averaged over the ranks."""
    from notsofar_tpu_torch.parallel.mesh import (all_reduce_mean,
                                                  replicate_module)
    from notsofar_tpu_torch.training import config as tcfg
    from notsofar_tpu_torch.training import parity
    from notsofar_tpu_torch.training import train as ttrain

    cfg = tcfg.TrainCfg(
        segment_len_secs=0.5, global_batch_size=4, learning_rate=LR,
        weight_decay=1e-2, clip_grad_norm=0.01, loss_name="mask",
        base_loss_name="l1", calc_side_info=True,
        conformer_css_cfg=tcfg.ConformerCssCfgM(nnet_conf=tcfg.NnetCfgM(
            conformer_conf=tcfg.ConformerCfgM(
                attention_dim=32, attention_heads=4, linear_units=64,
                num_blocks=2, kernel_size=5, dropout_rate=0.0))))
    model = ttrain.get_model(cfg, "cpu", seed=3 + rank)
    replicate_module(model.module)
    state = ttrain.init_state(model, cfg)
    train_step, _ = ttrain.make_train_step(model, cfg)
    rng = np.random.RandomState(0)
    direct = (rng.randn(4, 8000, 7, 3) * 0.05).astype(np.float32)
    noise = (rng.randn(4, 8000, 7) * 0.01).astype(np.float32)
    batch = {"mixture": direct.sum(-1) + noise,
             "gt_spk_direct_early_echoes": direct, "gt_noise": noise}
    rows = slice(rank * 4 // world, (rank + 1) * 4 // world)
    local = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
    shifts = torch.tensor([1, 4, 2, 5])[rows]
    before = {n: p.detach().clone() for n, p in model.module.named_parameters()}
    metrics = train_step(state, local, LR, torch.Generator(), shifts)
    metrics = {k: all_reduce_mean(v) for k, v in metrics.items()}
    return parity.step_record(state, before, metrics)


def child(rank: int, world: int, port: int, out: str, bn: str) -> None:
    import os

    import torch.distributed as dist
    from notsofar_tpu_torch.models import titanet
    from notsofar_tpu_torch.parallel import mesh
    if bn == "local":
        titanet.all_reduce_sum = lambda t: t
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    assert mesh.maybe_initialize_distributed("cpu")
    try:
        rec = step_once(rank, world)
        rec["host"] = (mesh.all_reduce_max_host(10 + rank),
                       mesh.gather_dicts_to_zero({"r": rank, "x": 0.5}),
                       mesh.shard_sessions(5))
        mesh.barrier()
        if rank == 0:
            Path(out).write_bytes(pickle.dumps(rec))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """{'one': the one-process step, 'global' / 'local': two processes
    with the batch norm's statistics over the global / local rows}. Both
    pairs run at once."""
    tmp = tmp_path_factory.mktemp("dp")
    procs = []
    for bn in ("global", "local"):
        port = _free_port()
        for rank in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, __file__, str(rank), "2", str(port),
                 str(tmp / f"{bn}.pkl"), bn],
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = step_once(0, 1)
    finally:
        torch.set_num_threads(n)
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
    out = {"one": one}
    for bn in ("global", "local"):
        out[bn] = pickle.loads((tmp / f"{bn}.pkl").read_bytes())
    return out


def mismatches(ref: dict, got: dict) -> list:
    from notsofar_tpu_torch.training import parity
    out = [f"{k}: {got['scalars'][k]!r} vs {r!r}"
           for k, r in ref["scalars"].items()
           if not abs(got["scalars"][k] - r) <= SCALAR_RTOL * abs(r)]
    return out + parity.step_mismatches(ref, got, RTOL, LR, 1e-2)


def test_two_processes_match_one(records):
    assert mismatches(records["one"], records["global"]) == []
    assert records["one"]["scalars"]["grad_norm"] > 0.01   # the clip ran
    # rank 0's view of the host collectives
    assert records["global"]["host"] == (
        11, [{"r": 0.0, "x": 0.5}, {"r": 1.0, "x": 0.5}], [0, 2, 4])


def test_local_batch_norm_mutant_is_caught(records):
    mism = mismatches(records["one"], records["local"])
    for what in ("loss:", "stats ", "grad "):
        assert any(m.startswith(what) for m in mism), (what, mism)


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    child(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
          sys.argv[5])
