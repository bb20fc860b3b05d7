"""The training cell's harness on a small Conformer: the first steps
through the loader, the output check, its faults and (on a card) its
control."""
from pathlib import Path

import pytest
import torch

from gpubench import harness

ROOT = Path(__file__).resolve().parents[2]
SMALL = {"attention_dim": 32, "attention_heads": 4, "linear_units": 64,
         "kernel_size": 5, "num_blocks": 2}


def small_cell(batch=8):
    """The training cell's files (not in BENCHMARK.json: PERF.md, Open
    questions), its model cut to SMALL."""
    bench = ROOT / "gpubench"
    files = dict(
        cell={"name": "train_b256", "chips": 1},
        config=harness.load_json(bench / "configs"
                                 / "conformer-css-large-mc.json"),
        traffic=harness.load_json(bench / "workloads" / "train_b256.json"),
        end_to_end=[], per_layer=[])
    files["config"].update(SMALL)
    prefix = "conformer_css_cfg.nnet_conf.conformer_conf."
    files["config"]["train_cfg"].update(
        {"global_batch_size": batch, "segment_len_secs": 0.5,
         "dataloader_workers": 2,
         **{prefix + k: v for k, v in SMALL.items()}})
    files["traffic"].update(utterances=batch // 4, utterance_seconds=1.25)
    return files


def run_small(device="cpu", after=None, seed=2 ** 31 + 3):
    return harness.run_files(small_cell(), seed, 0.2, False, device=device,
                             log=lambda *a: None, after=after)


def test_first_steps_through_the_loader_are_correct():
    out = run_small(after=lambda m, c, r: r)
    rec = out["_after"]
    first = rec["check_data"]["first"]
    assert len(first["losses"]) == 3
    for rows, lens in first["rows"]:
        assert len(rows) == 8 and len(set(rows)) == 8
        assert set(lens) == {8000}
    assert out["correct"], out["checks"]
    assert not rec["check_data"]["root"].exists()   # the partition is gone


def test_step_that_leaves_the_state_unchanged(monkeypatch):
    from notsofar_tpu_torch.training import train as T
    orig = T.make_optimizer

    def frozen(cfg, params):
        opt = orig(cfg, params)
        opt.step = lambda *a, **k: None
        return opt

    monkeypatch.setattr(T, "make_optimizer", frozen)
    out = run_small()
    assert not out["correct"]
    assert out["checks"]["update_err"]["value"] == pytest.approx(1.0)


def test_half_the_batch(monkeypatch):
    from notsofar_tpu_torch.training import train as T
    orig = T.make_train_step

    def halved(model, cfg):
        step, ev = orig(model, cfg)

        def half(state, batch, lr, generator, shifts=None):
            n = batch["mixture"].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()}, lr,
                        generator, None if shifts is None else shifts[:n])
        return half, ev

    monkeypatch.setattr(T, "make_train_step", halved)
    assert not run_small()["correct"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    return "cuda"


@pytest.mark.gpu
def test_gpu_control_reads_above_the_program(card):
    """The control (the port's step with TF32 on) at a small size: it
    reads at least three times the program on a compared number (at the
    cell's own size it fails the limits; PERF.md)."""
    out = run_small(card, after=lambda m, c, r: m.control_readings(c, r))
    prog = {c.name: c.value for c in out["_checks"]}
    ctrl = out["_after"]["control"]
    assert out["correct"], out["checks"]
    assert any(ctrl[k] >= 3 * prog[k] for k in ("grad_err", "update_err"))
