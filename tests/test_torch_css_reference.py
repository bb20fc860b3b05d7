"""The port's CSS engine against the benchmark's plain float32 reference
(gpubench/reference/css.py) on the CPU: two seeded 8 s sessions on the
7-mic array, the 1799-feature layout, and a Conformer cut in depth and
width for this test, both in float32 with the benchmark's seeded weights.
Each quantity of the benchmark's check is held to a tolerance, and five
faults of the engine each break one.

Tolerances:
* features 1e-6 (relative RMS, phase differences as unit vectors): the
  same float32 STFT and features, the port's STFT another algorithm than
  the reference's; the gap reads ~6e-8;
* masks 1e-5: the same float32 network; the port's layer norm takes the
  variance as E[x^2] - E[x]^2, the reference's as E[(x - E[x])^2];
* separated STFT 1e-3 (relative RMS): the covariances are float32 on both
  sides, summed in another order, and the solve is float64 Gauss-Jordan
  against a pivoting complex128 one, which a condition number up to the
  check's 1e6 turns into up to ~1e-4; systems above it are left out;
* the beamformer over the systems left out of the separated STFT's
  comparison 1e-6 (relative RMS backward error of MVDR's equations): the
  weights recovered from the output by least squares, float32
  covariances; it reads ~1e-8;
* permutations and gates: equal, and no near tie taken;
* streams 1e-3 (relative RMS): the separated STFT's gap, the overlap-add
  and the int16 rounding at the stream's peak.
"""
import contextlib
import json
from pathlib import Path

import pytest
import torch

from gpubench.drivers import css_separate as D
from gpubench.drivers.css_train import make_weights, model_dims
from gpubench.reference import css as ref
from notsofar_tpu_torch.css import engine as E

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 21
SMALL = {"attention_dim": 32, "attention_heads": 4, "linear_units": 64,
         "kernel_size": 5, "num_blocks": 2}
TOL = dict(features_err=1e-6, mask_err=1e-5, sep_err=1e-3,
           undetermined_err=1e-6, perm_err=0.0, activity_err=0.0,
           stream_err=1e-3)


def _files():
    cfg = json.loads((ROOT / "gpubench" / "configs"
                      / "conformer-css-large-mc.json").read_text())
    cfg.update(SMALL)
    cfg["serving"].update(compute_dtype="float32", seg_chunk=4,
                          seg_bucket_multiple=4)
    p = json.loads((ROOT / "gpubench" / "workloads"
                    / "css_mc_4x360s.json").read_text())
    p.update(sessions=2, session_seconds=8.0)
    return cfg, p


CFG, P = _files()
C = model_dims(CFG)
SD = make_weights(C, SEED, "cpu")
MIXES = D.sessions(P, SEED, 0, "cpu")
SESSIONS = [torch.from_numpy(m[0]) for m in MIXES]


def readings(engine) -> dict:
    prog = D.program_run(engine, MIXES, SD, C, CFG["serving"], 8)
    want = ref.separate(SESSIONS, SD, C, CFG["serving"],
                        follow=prog["sessions"],
                        cond_max=float(P["cond_max"]),
                        perm_tie=float(P["perm_tie"]),
                        activity_margin=float(P["activity_margin"]), block=8)
    r = D.compare(prog["sessions"], prog["streams"], want)
    r["mask_err"], r["features_err"] = prog["mask_err"], prog["features_err"]
    return r


@pytest.fixture(scope="module")
def sound():
    return readings(D.build_engine(CFG, SD, "cpu"))


@pytest.mark.parametrize("name", sorted(TOL))
def test_engine_agrees_with_the_reference(sound, name):
    assert sound[name] <= TOL[name], (name, sound)
    assert sound["perm_excused"] == 0 and sound["activity_adopted"] == 0


def test_reference_alone_makes_the_engines_decisions():
    """Without the engine's masks the reference makes every decision
    itself, on its own STFT, features and network: the same permutations
    and gates as the engine's."""
    prog = D.program_run(D.build_engine(CFG, SD, "cpu"), MIXES, SD, C,
                         CFG["serving"], 8)
    alone = ref.separate(SESSIONS, SD, C, CFG["serving"], block=8)
    for mine, theirs in zip(prog["sessions"], alone["sessions"]):
        assert (mine["perms"] == theirs["perms"]).all()
        assert torch.equal(mine["gates"], theirs["gates"])


def _swap_one(monkeypatch):
    chain = E._pit_chain

    def swapped(lm_all, S):
        perms = chain(lm_all, S).copy()
        perms[0, 2, [0, 1]] = perms[0, 2, [1, 0]]
        return perms

    monkeypatch.setattr(E, "_pit_chain", swapped)


def _mic0(monkeypatch):
    monkeypatch.setattr(E, "mvdr_beamform",
                        lambda spk, noi, stft, use_pallas=False:
                        stft[..., :1].expand(*stft.shape[:3],
                                             spk.shape[-1]))


def _stale(engine):
    real = engine.model.masks_from_feature
    seen = []

    def stale(feat, generator=None):
        out = real(feat, generator)
        seen.append(out)
        return seen[0] if len(seen) == 2 else out     # chunk 1 gets chunk 0's

    engine.model.masks_from_feature = stale


def _unnormalised(engine):
    real = engine.model.features

    def features(stft_c):
        f = real(stft_c).clone()
        mag = stft_c[..., 0].abs().clamp_min(1.1920929e-07)
        f[:, :mag.shape[1]] = mag
        return f

    engine.model.features = features


@pytest.mark.parametrize("fault,broken", [
    ("swapped_permutation", "perm_err"),
    ("mvdr_skipped", "sep_err"),
    ("stale_chunk", "mask_err"),
    ("magnitudes_unnormalised", "features_err"),
    ("mic0_where_undetermined", "undetermined_err")])
def test_faults_break_a_tolerance(monkeypatch, fault, broken):
    engine = D.build_engine(CFG, SD, "cpu")
    plant = contextlib.nullcontext()
    if fault == "swapped_permutation":
        _swap_one(monkeypatch)
    elif fault == "mvdr_skipped":
        _mic0(monkeypatch)
    elif fault == "stale_chunk":
        _stale(engine)
    elif fault == "magnitudes_unnormalised":
        _unnormalised(engine)
    else:
        # only the systems that sep_err leaves out
        plant = D.planted(engine, "loose", float(P["cond_max"]))
    with plant:
        r = readings(engine)
    assert r[broken] > max(TOL[broken], 1e-2), (fault, r)
