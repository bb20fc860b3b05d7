"""The port's CSS training stack (notsofar_tpu_torch/training/*) against
the JAX package on the CPU.

Tiny widths: 2 blocks, d 32, 4 heads, 64 linear units, kernel 5, 0.5 s
segments; weights carried across by variables_from_jax. Tolerances:

* the dataset, splitter, loader (sharded too), tar partition, mic roll
  and schedules are copies or exact gathers: equal;
* css_loss: 1e-6 relative, both reading the same STFT (means in another
  order);
* batch norm in train mode: 1e-5 of the largest magnitude, f32;
* a train step (dropout 0, the JAX step's own mic shifts): the loss, side
  info and gradient norm within 1e-4 relative, gradients, AdamW moments
  and running statistics within 1e-4 of their scale, and the update
  p1 - p0 within Adam's step over that box (training/parity.py); step k of
  three within k x 1e-4, since the parameters entering it already differ.
  Measured on step 1: gradients 1.7e-5 of their scale at most (at 1e-5
  some fail), updates 0.0074 lr apart at most; steps 2 and 3 reach 8.5e-5
  and 1.2e-4 (a scalar tap's gradient, a sum over every frame and
  feature). One gradient with its sign flipped after the clip fails.
"""
import tarfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import flax.linen as fnn
from notsofar_tpu.css import inference as jinf
from notsofar_tpu.training import augmentations as jaug
from notsofar_tpu.training import config as jcfg
from notsofar_tpu.training import dataset as jds
from notsofar_tpu.training import losses as jlosses
from notsofar_tpu.training import schedulers as jsched
from notsofar_tpu.training import train as jtrain
from notsofar_tpu_torch.css import inference as tinf
from notsofar_tpu_torch.models import conformer as tconf
from notsofar_tpu_torch.models.convert import (variables_from_jax,
                                               variables_to_jax)
from notsofar_tpu_torch.models.titanet import BatchNorm
from notsofar_tpu_torch.training import augmentations as taug
from notsofar_tpu_torch.training import config as tcfg
from notsofar_tpu_torch.training import dataset as tds
from notsofar_tpu_torch.training import losses as tlosses
from notsofar_tpu_torch.training import parity
from notsofar_tpu_torch.training import schedulers as tsched
from notsofar_tpu_torch.training import train as ttrain
from notsofar_tpu_torch.utils import native
from notsofar_tpu_torch.utils.conf import dataclass_to_dict
from tests.test_training import write_sim_dataset
from tests.test_torch_whisper import torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
FS = 16000
KW = dict(attention_dim=32, attention_heads=4, linear_units=64, num_blocks=2,
          kernel_size=5, dropout_rate=0.0)
RTOL = 1e-4
LR = 1e-3
MUTANT = "encoder.layer_0.ffn_in.w1.weight"


def train_cfg(m, sc=False, **over):
    """A tiny TrainCfg of config module `m` (the JAX package's or the
    port's): the shipped v1.0 recipe's loss, clip and schedule."""
    kw = dict(
        train_dir="train", val_dir="val", out_dir="out", single_channel=sc,
        segment_len_secs=0.5, global_batch_size=4, learning_rate=LR,
        weight_decay=1e-2, clip_grad_norm=0.01, is_debug=True,
        loss_name="mask", base_loss_name="l1", clip_gt_to_mixture=False,
        calc_side_info=True, log_params_mlflow=False,
        log_metrics_mlflow=False, eval_every=(4, "iterations"),
        save_every=(4, "iterations"), scheduler_step_every=(1, "iterations"),
        stop_after=(4, "iterations"),
        conformer_css_cfg=m.ConformerCssCfgM(
            extractor_conf=m.ExtractorCfgM(
                ipd_index="" if sc else "1,0;2,0;3,0;4,0;5,0;6,0"),
            nnet_conf=m.NnetCfgM(conformer_conf=m.ConformerCfgM(**KW),
                                 in_features=257 if sc else 1799)))
    kw.update(over)
    return m.TrainCfg(**kw)


def make_batch(seed: int, B: int = 4, T: int = 8000, mics: int = 7):
    """mixture = direct speakers + noise, 3 speakers, [B, T, mics(, 3)]."""
    rng = np.random.RandomState(seed)
    direct = (rng.randn(B, T, mics, 3) * 0.05).astype(np.float32)
    noise = (rng.randn(B, T, mics) * 0.01).astype(np.float32)
    return {"mixture": direct.sum(-1) + noise,
            "gt_spk_direct_early_echoes": direct, "gt_noise": noise}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def port_names(tree, stats=False):
    """A flax params (or batch_stats) tree as f64 arrays by the port's
    state-dict names."""
    variables = {"params": {}, "batch_stats": tree} if stats else \
        {"params": tree}
    return {k: v.double().numpy()
            for k, v in variables_from_jax(variables).items()}


@pytest.fixture(scope="module")
def sim_root(tmp_path_factory):
    return write_sim_dataset(tmp_path_factory.mktemp("simdata"))


# ---------------------------------------------------------------------------
# data: splitter, dataset, loader, tar partition
# ---------------------------------------------------------------------------

def _same_items(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_segment_splitter_matches_jax():
    for args in [(8000, 24000, 0.5, 48000), (2000, 4000, 0.3, (6000, 9000))]:
        js, ts = jds.SegmentSplitter(*args), tds.SegmentSplitter(*args)
        for length in [6000, 48000, 60000, 100000, 200000]:
            for seed in [(1, 0), (7, 3), None]:
                assert js(length, seed=seed) == ts(length, seed=seed)


@pytest.mark.parametrize("sc", [False, True])
def test_dataset_and_sharded_loader_match_jax(sim_root, sc):
    """Items and batches (shuffled, two shards with a padded ragged tail,
    two epochs) array-equal to the JAX package's; the port's native
    reader is its own native/segread.cpp, built into native/build/."""
    sp = (2000, 4000, 0.5, 8000)
    jset = jds.SimulatedDataset(str(sim_root), jds.SegmentSplitter(*sp),
                                seed=3, single_channel=sc)
    tset = tds.SimulatedDataset(str(sim_root), tds.SegmentSplitter(*sp),
                                seed=3, single_channel=sc)
    assert len(jset) == len(tset) > 0
    for i in (0, len(tset) - 1):
        _same_items(jset[i], tset[i])
    assert native.load_native("segread") is not None
    assert native.core_path("segread").parent == \
        REPO / "notsofar_tpu_torch/native/build"
    assert native.core_path("segread").exists()
    for shard in (0, 1):
        kw = dict(batch_size=3, shuffle=True, seed=5, drop_last=False,
                  num_threads=2, shard_index=shard, num_shards=2)
        jl, tl = jds.DataLoader(jset, **kw), tds.DataLoader(tset, **kw)
        assert len(jl) == len(tl)
        for epoch in (1, 2):
            jl.set_epoch(epoch)
            tl.set_epoch(epoch)
            jb, tb = list(jl), list(tl)
            assert len(jb) == len(tb) == len(tl)
            for a, b in zip(jb, tb):
                _same_items(a, b)


def test_tar_partition_matches_jax(tmp_path):
    flat = write_sim_dataset(tmp_path / "flat", n_utts=2, n_samples=FS)
    tar_dir = tmp_path / "tar"
    tar_dir.mkdir()
    with tarfile.open(tar_dir / "part-000000.tar", "w") as tf:
        tf.add(flat / "dataset-000000.map", arcname="utterances.map")
        for f in sorted(flat.iterdir()):
            if not f.name.endswith(".map"):
                tf.add(f, arcname=f.name)
    sp = (2000, 4000, 0.5, 8000)
    jset = jds.SimulatedDataset(str(tar_dir), jds.SegmentSplitter(*sp), seed=7)
    tset = tds.SimulatedDataset(str(tar_dir), tds.SegmentSplitter(*sp), seed=7)
    tflat = tds.SimulatedDataset(str(flat), tds.SegmentSplitter(*sp), seed=7)
    assert len(jset) == len(tset) == len(tflat)
    for i in range(len(tset)):
        _same_items(jset[i], tset[i])
    np.testing.assert_allclose(tset[0]["mixture"], tflat[0]["mixture"],
                               atol=1e-6)


# ---------------------------------------------------------------------------
# augmentation and schedules
# ---------------------------------------------------------------------------

def test_mic_roll_and_shift_match_jax():
    rng = np.random.RandomState(0)
    shifts = np.array([0, 1, 3, 5])
    for shape in [(4, 50, 6), (4, 50, 6, 3)]:
        arr = rng.randn(*shape).astype(np.float32)
        want = np.asarray(jaug.batch_roll_mics(jnp.asarray(arr),
                                               jnp.asarray(shifts)))
        got = taug.batch_roll_mics(torch.from_numpy(arr),
                                   torch.from_numpy(shifts))
        assert np.array_equal(got.numpy(), want)
    batch = make_batch(1, B=4, T=40)
    key = jax.random.PRNGKey(3)
    want = jaug.mic_shift_augment({k: jnp.asarray(v)
                                   for k, v in batch.items()}, key)
    jshifts = torch.tensor(np.asarray(jax.random.randint(key, (4,), 0, 6)))
    got = taug.mic_shift_augment(torch_batch(batch), shifts=jshifts)
    for k in batch:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    # drawn from a generator: seeded, in 0..5, mic 0 untouched
    a = taug.mic_shift_augment(torch_batch(batch),
                               torch.Generator().manual_seed(9))
    b = taug.mic_shift_augment(torch_batch(batch),
                               torch.Generator().manual_seed(9))
    assert all(torch.equal(a[k], b[k]) for k in batch)
    assert torch.equal(a["mixture"][:, :, 0],
                       torch.from_numpy(batch["mixture"][:, :, 0]))
    with pytest.raises(ValueError, match="Generator"):
        taug.mic_shift_augment(torch_batch(batch))


def test_schedules_match_jax():
    cases = [("step_lr", dict(step_size=3, gamma=0.5), {}),
             ("linear_warmup_decay", {}, dict(warmup=10, decay=20))]
    for name, step_kw, warm_kw in cases:
        js = jsched.make_schedule(name, jcfg.SchedulerStepLrCfg(**step_kw),
                                  jcfg.LinearWarmupDecayCfg(**warm_kw))
        ts = tsched.make_schedule(name, tcfg.SchedulerStepLrCfg(**step_kw),
                                  tcfg.LinearWarmupDecayCfg(**warm_kw))
        assert [js(s) for s in range(30)] == [ts(s) for s in range(30)]


# ---------------------------------------------------------------------------
# loss, batch norm, dropout
# ---------------------------------------------------------------------------

class JaxStft:
    """A model whose stft is the JAX package's, for either css_loss: both
    then read the same magnitudes, and the test holds the loss arithmetic
    alone (the STFTs are held against each other in
    test_torch_css_signal.py). With the unclipped ratio target gt / mix,
    an STFT rounding of 1e-7 moves the mse loss by up to 3e-5 relative in
    bins where the mixture nearly cancels."""

    def __init__(self, model, port: bool):
        self.model, self.port = model, port

    def stft(self, s):
        if not self.port:
            return self.model.stft(s)
        return torch.from_numpy(np.array(self.model.stft(
            jnp.asarray(s.numpy()))))


@pytest.mark.parametrize("loss_name", ["mask", "masked_mag"])
@pytest.mark.parametrize("base", ["l1", "mse"])
@pytest.mark.parametrize("clip", [False, True])
def test_css_loss_matches_jax(loss_name, base, clip):
    jm = jtrain.get_model(train_cfg(jcfg))
    batch = make_batch(2, B=2, T=4000)
    frames = jm.stft(jnp.zeros((1, 4000))).shape[-1]
    masks = np.random.RandomState(4).rand(2, 257, frames, 4).astype(np.float32)
    jmasks = {"spk_masks": jnp.asarray(masks[..., :3]),
              "noise_masks": jnp.asarray(masks[..., 3:])}
    tmasks = {"spk_masks": torch.from_numpy(masks[..., :3]),
              "noise_masks": torch.from_numpy(masks[..., 3:])}
    want, wside = jlosses.css_loss(JaxStft(jm, False), jmasks,
                                   {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                                   loss_name, base, 0.7, clip, True)
    got, gside = tlosses.css_loss(JaxStft(jm, True), tmasks,
                                  torch_batch(batch), loss_name, base, 0.7,
                                  clip, True)
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    assert wside.keys() == gside.keys()
    for k in wside:
        assert abs(float(gside[k]) - float(wside[k])) <= \
            1e-6 * abs(float(wside[k])), k


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_batch_norm_train_mode_matches_flax(dt):
    """Batch statistics over every axis but the last (biased fast
    variance, f32), the running statistics moved by momentum 0.9, as flax;
    eval mode reads them. Without a momentum (TitaNet, MarbleNet) train
    mode keeps reading the running statistics."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    rng = np.random.RandomState(6)
    x = (rng.randn(3, 17, 8) * 2 + 1).astype(np.float32)
    xj = jnp.asarray(x, jdt)
    xt = torch.from_numpy(x).to(tdt)
    stats = {"mean": rng.randn(8).astype(np.float32),
             "var": (rng.rand(8) + 0.5).astype(np.float32)}
    params = {"scale": (rng.rand(8) + 0.5).astype(np.float32),
              "bias": rng.randn(8).astype(np.float32)}
    jbn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5)
    want, new = jbn.apply({"params": params, "batch_stats": stats}, xj,
                          use_running_average=False, mutable=["batch_stats"])
    bn = BatchNorm(8, 1e-5, momentum=0.9)
    bn.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                        "bias": torch.from_numpy(params["bias"]),
                        "running_mean": torch.from_numpy(stats["mean"]),
                        "running_var": torch.from_numpy(stats["var"])})
    got = bn.train()(xt)
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.float32
    assert np.abs(got.detach().numpy() - want).max() <= \
        1e-5 * np.abs(want).max()
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        ref = np.asarray(new["batch_stats"][key])
        assert np.abs(getattr(bn, name).numpy() - ref).max() <= \
            1e-6 * np.abs(ref).max(), name
    want_eval = jbn.apply({"params": params, "batch_stats": new["batch_stats"]},
                          xj, use_running_average=True)
    got_eval = bn.eval()(xt).detach()
    assert np.abs(got_eval.numpy() - np.asarray(want_eval, np.float32)
                  ).max() <= 1e-5 * np.abs(want).max()
    frozen = BatchNorm(8, 1e-5)
    frozen.load_state_dict(bn.state_dict())
    assert torch.equal(frozen.train()(xt), frozen.eval()(xt))


def test_dropout_keep_rate_scale_and_generator():
    """flax nn.Dropout's semantics: each element kept with probability
    1 - p and scaled by 1 / (1 - p), the rest 0; the identity in eval mode
    and at p 0; masks from the explicit generator (one seed, one mask)."""
    layer = tconf.FeedForward(8, 16, torch.float32, dropout_rate=0.25)
    x = torch.ones(200, 500)
    kept = tconf.dropout(layer.train(), x, 0.25,
                         torch.Generator().manual_seed(0))
    assert set(torch.unique(kept).tolist()) == {0.0, float(np.float32(1 / 0.75))}
    share = float((kept > 0).float().mean())
    assert abs(share - 0.75) < 4 * np.sqrt(0.75 * 0.25 / x.numel())
    again = tconf.dropout(layer, x, 0.25, torch.Generator().manual_seed(0))
    assert torch.equal(kept, again)
    assert tconf.dropout(layer, x, 0.0, None) is x
    assert tconf.dropout(layer.eval(), x, 0.25, None) is x
    with pytest.raises(ValueError, match="Generator"):
        tconf.dropout(layer.train(), x, 0.25, None)
    # a train-mode ConformerCSS with dropout: one seed, one output
    cfg = tconf.ConformerConfig(**{**KW, "dropout_rate": 0.1})
    net = tconf.ConformerCSS(in_features=12, num_bins=5, conformer=cfg)
    net.init(torch.Generator().manual_seed(1)).train()
    f = torch.randn(2, 12, 9, generator=torch.Generator().manual_seed(2))
    outs = [net(f, torch.Generator().manual_seed(s)) for s in (3, 3, 4)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])


# ---------------------------------------------------------------------------
# train steps against the JAX train_step
# ---------------------------------------------------------------------------

def jax_reference(steps: int):
    """The JAX package's train_step for `steps` steps from a seeded init
    (keys PRNGKey(10 + k), batch k), recorded as parity.step_record lays
    a step out; the gradients come from the same loss under jax.grad,
    clipped as optax clips. Returns (initial variables, per-step mic
    shifts, records)."""
    cfg = train_cfg(jcfg)
    model, tx = jtrain.get_model(cfg), jtrain.make_optimizer(cfg)
    variables = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0)))
    state = jtrain.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        constants=variables["constants"],
        opt_state=tx.init(variables["params"]), step=jnp.zeros((), jnp.int32))
    train_step = jtrain.make_train_step(model, tx, cfg)[0]

    def loss_fn(params, batch_stats, constants, batch, rng):
        res, _ = model.forward({"params": params, "batch_stats": batch_stats,
                                "constants": constants}, batch["mixture"],
                               deterministic=False, use_running_average=False,
                               mutable=["batch_stats"],
                               rngs={"dropout": rng})
        return jlosses.css_loss(model, res, batch, cfg.loss_name,
                                cfg.base_loss_name, cfg.noise_weight,
                                cfg.clip_gt_to_mixture, cfg.calc_side_info)[0]

    grad_fn = jax.jit(jax.grad(loss_fn))
    shifts, records = [], []
    for k in range(steps):
        batch = {key: jnp.asarray(v) for key, v in make_batch(10 + k).items()}
        key = jax.random.PRNGKey(10 + k)
        aug_rng, drop_rng = jax.random.split(key)
        shifts.append(np.asarray(jax.random.randint(aug_rng, (4,), 0, 6)))
        grads = jax.device_get(grad_fn(state.params, state.batch_stats,
                                       state.constants,
                                       jaug.mic_shift_augment(batch, aug_rng),
                                       drop_rng))
        norm = float(np.sqrt(sum((np.asarray(g, np.float64) ** 2).sum()
                                 for g in jax.tree_util.tree_leaves(grads))))
        before = port_names(jax.device_get(state.params))
        state, metrics = train_step(state, batch, jnp.asarray(LR, jnp.float32),
                                    key)
        after = port_names(jax.device_get(state.params))
        adam = state.opt_state.inner_state[1][0]
        fac = 1.0 if norm < cfg.clip_grad_norm else cfg.clip_grad_norm / norm
        records.append({
            "scalars": {**{m: float(v) for m, v in metrics.items()},
                        "grad_norm": norm},
            "grad": {n: g * fac for n, g in port_names(grads).items()},
            "update": {n: after[n] - before[n] for n in after},
            "exp_avg": port_names(jax.device_get(adam.mu)),
            "exp_avg_sq": port_names(jax.device_get(adam.nu)),
            "stats": port_names(jax.device_get(state.batch_stats), True),
            "step": k + 1})
    return variables, shifts, records


@pytest.fixture(scope="module")
def jax_steps():
    return jax_reference(3)


def port_steps(variables, shifts, steps: int):
    cfg = train_cfg(tcfg)
    model = ttrain.get_model(cfg, "cpu")
    model.module.load_state_dict(variables_from_jax(variables))
    state = ttrain.init_state(model, cfg)
    train_step, _ = ttrain.make_train_step(model, cfg)
    records = []
    for k in range(steps):
        before = {n: p.detach().clone()
                  for n, p in model.module.named_parameters()}
        metrics = train_step(state, torch_batch(make_batch(10 + k)), LR,
                             torch.Generator(), torch.tensor(shifts[k]))
        records.append(parity.step_record(state, before, metrics))
    return state, records


def mismatches(refs, gots):
    """Step k (from 1) held at k x RTOL: the parameters entering it already
    differ by what the earlier steps' tolerances allow."""
    out, carried = [], None
    for k, (ref, got) in enumerate(zip(refs, gots)):
        rtol = RTOL * (k + 1)
        out += [f"step {k + 1}: {m}" for m in parity.step_mismatches(
            ref, got, rtol, LR, 1e-2, carried)]
        bounds = parity.update_bounds(ref, rtol, LR)
        carried = bounds if carried is None else \
            {n: carried[n] + b for n, b in bounds.items()}
    return out


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax(jax_steps, steps):
    """Loss, side info, gradient norm, gradients, updates, AdamW moments
    and running statistics after one step and after each of three, within
    the stated tolerance (the module docstring)."""
    variables, shifts, refs = jax_steps
    state, gots = port_steps(variables, shifts, steps)
    assert state.step == steps
    assert mismatches(refs[:steps], gots) == []
    assert [m for g in gots for m in parity.adam_mismatches(g, LR, 1e-2)] == []
    # the clip ran: the clipped gradients' norm is the clip
    norm = np.sqrt(sum((g ** 2).sum() for g in gots[0]["grad"].values()))
    assert gots[0]["scalars"]["grad_norm"] > 0.01
    assert abs(norm - 0.01) < 1e-6


def test_train_step_mutant_is_caught(jax_steps, monkeypatch):
    """One parameter's gradient with its sign flipped after the clip
    falls outside the tolerance: its gradient, moment and update."""
    variables, shifts, refs = jax_steps
    clip = ttrain.clip_by_global_norm
    flipped = {}

    def clip_and_flip(params, max_norm):
        norm = clip(params, max_norm)
        flipped["p"].grad.neg_()
        return norm

    monkeypatch.setattr(ttrain, "clip_by_global_norm", clip_and_flip)
    cfg = train_cfg(tcfg)
    model = ttrain.get_model(cfg, "cpu")
    model.module.load_state_dict(variables_from_jax(variables))
    flipped["p"] = model.module.get_parameter(MUTANT)
    state = ttrain.init_state(model, cfg)
    before = {n: p.detach().clone() for n, p in model.module.named_parameters()}
    metrics = ttrain.make_train_step(model, cfg)[0](
        state, torch_batch(make_batch(10)), LR, torch.Generator(),
        torch.tensor(shifts[0]))
    out = mismatches(refs[:1], [parity.step_record(state, before, metrics)])
    assert any(m.startswith(f"step 1: update {MUTANT}") for m in out), out
    assert any(m.startswith(f"step 1: grad {MUTANT}") for m in out), out
    assert all(MUTANT in m for m in out), out


# ---------------------------------------------------------------------------
# checkpoints, the loop, the entry point, the native save
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip_and_keep(tmp_path):
    """Parameters, running statistics, constants and the optimizer state
    restore bit for bit with both step counters; the newest `keep`
    checkpoints stay; no checkpoint: the state and scheduler step 0."""
    cfg = train_cfg(tcfg)
    model = ttrain.get_model(cfg, "cpu", seed=1)
    state = ttrain.init_state(model, cfg)
    train_step, _ = ttrain.make_train_step(model, cfg)
    fresh = ttrain.init_state(ttrain.get_model(cfg, "cpu", seed=2), cfg)
    assert ttrain.restore_checkpoint(str(tmp_path), fresh) == (fresh, 0)
    for k in range(3):
        train_step(state, torch_batch(make_batch(k)), LR,
                   torch.Generator().manual_seed(k))
        ttrain.save_checkpoint(str(tmp_path), state, scheduler_step=5 + k,
                               keep=2)
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == \
        ["2.pt", "3.pt"]
    restored, sched = ttrain.restore_checkpoint(str(tmp_path), fresh)
    assert (restored.step, sched) == (3, 7)
    a, b = state.model.module.state_dict(), restored.model.module.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    sa, sb = state.optimizer.state_dict(), restored.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        assert st.keys() == sb["state"][i].keys()
        assert all(torch.equal(st[k], sb["state"][i][k]) for k in st)


def _write_conf(path: Path, cfg):
    import yaml
    path.write_text(yaml.safe_dump(dataclass_to_dict(cfg)))
    return path


def _latest(out_dir: Path):
    found = sorted((int(p.stem), p) for p in
                   (out_dir / "checkpoints").glob("*.pt"))
    return torch.load(found[-1][1], weights_only=True)


def test_entry_point_trains_and_resumes(tmp_path, sim_root):
    """run_training_css_gpu.py --device cpu (MC): 4 iterations with eval
    and a checkpoint, then --resume for 2 more: the checkpoint counters
    continue (6, 6) and the weights stay finite."""
    import run_training_css_gpu
    cfg = train_cfg(tcfg, train_dir=str(sim_root), val_dir=str(sim_root),
                    out_dir="run")
    conf = _write_conf(tmp_path / "conf.yaml", cfg)
    args = ["--conf", str(conf), "--data_root_out", str(tmp_path),
            "--device", "cpu"]
    out = Path(run_training_css_gpu.main(args))
    ckpt = _latest(out)
    assert (ckpt["step"], ckpt["scheduler_step"]) == (4, 4)
    assert (out / "config.yaml").exists()
    _write_conf(conf, train_cfg(tcfg, train_dir=str(sim_root),
                                val_dir=str(sim_root), out_dir="run",
                                stop_after=(2, "iterations")))
    run_training_css_gpu.main(args + ["--resume"])
    ckpt = _latest(out)
    assert (ckpt["step"], ckpt["scheduler_step"]) == (6, 6)
    assert all(torch.isfinite(v).all() for v in ckpt["params"].values())


def test_run_training_css_single_channel(tmp_path, sim_root):
    cfg = train_cfg(tcfg, sc=True)
    sp = tds.SegmentSplitter(2000, 4000, 0.5, 8000)
    needed = ["mixture", "gt_spk_direct_early_echoes", "gt_noise"]
    sets = tuple(tds.SimulatedDataset(str(sim_root), sp, seed=s,
                                      single_channel=True,
                                      needed_columns=needed) for s in (1, 2))
    ttrain.run_training_css(cfg, "", "", str(tmp_path), datasets=sets,
                            device="cpu")
    ckpt = _latest(tmp_path)
    assert (ckpt["step"], ckpt["scheduler_step"]) == (4, 4)
    assert ckpt["params"]["encoder.embed.weight"].shape == (32, 257)


def test_entry_point_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import run_training_css_gpu
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_training_css_gpu.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.run_training_css(train_cfg(tcfg), "", "", "unused")


def test_native_save_is_flax_to_bytes(tmp_path):
    """save_css_model writes the bytes flax.serialization.to_bytes writes
    for the same variables (and the same config.yaml as the JAX package's
    save_css_model); load_css_model reads them back to the same module."""
    cfg_j, cfg_t = train_cfg(jcfg), train_cfg(tcfg)
    model = jtrain.get_model(cfg_j)
    variables = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(4)))
    sd = variables_from_jax(variables)
    jinf.save_css_model(tmp_path / "jax", variables, cfg_j)
    tinf.save_css_model(tmp_path / "port", sd, cfg_t)
    for name in ("params.msgpack", "config.yaml"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    assert (tmp_path / "port" / "params.msgpack").read_bytes() == \
        serialization.to_bytes(variables)
    loaded, _ = tinf.load_css_model(tmp_path / "port", device="cpu")
    got = loaded.module.state_dict()
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    tree = variables_to_jax(sd)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(variables)



def test_time_train_step_tool_runs_on_the_cpu():
    """tools/time_train_step.py's timing and entry modes, at the tiny
    widths on the CPU (on the card they time the recipe's step, and try a
    global batch through run_training_css_gpu.py)."""
    from notsofar_tpu_torch.tools import time_train_step as tool
    out = tool.main(["--device", "cpu", "--tiny", "--batch", "2",
                     "--steps", "1"])
    assert out["ms"] > 0 and out["ms_synced"] > 0 and out["device_ms"] == 0
    out = tool.main(["--device", "cpu", "--tiny", "--entry", "--batch", "8"])
    assert out["fits"] and out["peak_gib"] is None
