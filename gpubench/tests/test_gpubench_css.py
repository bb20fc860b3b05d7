"""The CSS serving cell's harness on a small Conformer: the driver end to
end on the CPU, its output check against seeded faults, the manifest's
entry, the calibration's planted faults and the cell's metric readers on
hand-built traces."""
from pathlib import Path

import pytest
import torch

from gpubench import harness

ROOT = Path(__file__).resolve().parents[2]
CELL = "css_mc_4x360s"
SMALL = {"attention_dim": 32, "attention_heads": 4, "linear_units": 64,
         "kernel_size": 5, "num_blocks": 2}


def small_cell():
    """The cell's files with its model cut to SMALL in float32, two 8 s
    sessions a call, and buckets and chunks of 4 windows."""
    files = harness.cell_files(harness.manifest(ROOT), CELL)
    files["config"].update(SMALL)
    files["config"]["serving"].update(compute_dtype="float32", seg_chunk=4,
                                      seg_bucket_multiple=4)
    files["traffic"].update(sessions=2, session_seconds=8.0, block=8)
    files["per_layer"] = []
    return files


def run_small(after=None, seed=2 ** 31 + 5):
    return harness.run_files(small_cell(), seed, 0.2, False, device="cpu",
                             log=lambda *a: None, after=after)


def test_driver_end_to_end_is_correct():
    out = run_small(after=lambda m, c, r: r)
    assert out["correct"], out["checks"]
    rec = out["_after"]
    assert rec["counters"]["windows"] == rec["calls"] * 10
    assert out["attempted"] == 2 * rec["calls"]
    assert set(rec["work"]["flops"]) == {
        "stft", "features", "conformer", "covariances", "solves",
        "stitching", "ola", "istft"}


def _swap(monkeypatch):
    from notsofar_tpu_torch.css import engine as E
    chain = E._pit_chain

    def swapped(lm_all, S):
        perms = chain(lm_all, S).copy()
        perms[:, 2, [0, 1]] = perms[:, 2, [1, 0]]
        return perms
    monkeypatch.setattr(E, "_pit_chain", swapped)


def _mic0(monkeypatch):
    from notsofar_tpu_torch.css import engine as E
    monkeypatch.setattr(E, "mvdr_beamform",
                        lambda spk, noi, stft, use_pallas=False:
                        stft[..., :1].expand(*stft.shape[:3],
                                             spk.shape[-1]))


def _stale(monkeypatch):
    from gpubench.drivers import css_separate
    build = css_separate.build_engine

    def stale_engine(*a, **k):
        eng = build(*a, **k)
        real, seen = eng.model.masks_from_feature, []

        def stale(feat, generator=None):
            seen.append(real(feat, generator))
            return seen[-2] if len(seen) % 4 == 2 else seen[-1]
        eng.model.masks_from_feature = stale
        return eng
    monkeypatch.setattr(css_separate, "build_engine", stale_engine)


def _no_floor(monkeypatch):
    from gpubench.drivers import css_separate
    build = css_separate.build_engine

    def floorless(*a, **k):
        eng = build(*a, **k)
        eng.cfg.mc_mask_floor_db = -float("inf")
        return eng
    monkeypatch.setattr(css_separate, "build_engine", floorless)


def _ipd_flipped(monkeypatch):
    from gpubench.drivers import css_separate
    build = css_separate.build_engine

    def flipped_features(*a, **k):
        eng = build(*a, **k)
        real = eng.model.features

        def features(stft_c):
            f = real(stft_c).clone()
            f[:, 257:] = -f[:, 257:]
            return f
        eng.model.features = features
        return eng
    monkeypatch.setattr(css_separate, "build_engine", flipped_features)


@pytest.mark.parametrize("fault,broken", [
    (_swap, "perm_err"), (_mic0, "sep_err"), (_stale, "mask_err"),
    (_no_floor, "sep_err"), (_ipd_flipped, "features_err")])
def test_faults_come_out_not_correct(monkeypatch, fault, broken):
    fault(monkeypatch)
    out = run_small()
    assert not out["correct"]
    c = out["checks"][broken]
    assert not c["value"] <= c["limit"], out["checks"]


@pytest.fixture(scope="module")
def controls():
    return run_small(after=lambda m, c, r: m.control_readings(c, r))


def test_control_reads_above_the_program(controls):
    ctrl, checks = controls["_after"], controls["checks"]
    assert ctrl["mask_err"] > 10 * checks["mask_err"]["value"]
    # the bfloat16 STFT's features, against the program's float32 ones
    assert ctrl["features_err"] > checks["features_err"]["limit"] > \
        100 * checks["features_err"]["value"]
    assert set(ctrl["c64_no_pivot"]) >= set(checks)


@pytest.mark.parametrize("fault,broken", [
    ("mic0", {"sep_err", "stream_err"}), ("no_floor", {"sep_err",
                                                       "stream_err"}),
    ("swap", {"perm_err", "stream_err"}), ("loose", {"undetermined_err"})])
def test_planted_faults_fail_their_checks(controls, fault, broken):
    """The faults that the calibration plants at the cell's size, each
    failing the checks it should, and the program's own run unmoved by
    having planted them."""
    assert controls["correct"], controls["checks"]
    got = controls["_after"]["faults"][fault]
    assert broken <= set(got["failed"]), got


def test_manifest_gives_the_cell_rtfx_and_its_metrics():
    files = harness.cell_files(harness.manifest(ROOT), CELL)
    assert [m["name"] for m in files["end_to_end"]] == ["rtfx", "setup_s"]
    assert {m["name"] for m in files["per_layer"]} == {
        "css_mfu_pct", "conformer_roofline.css", "mvdr_ms_per_segment.css",
        "host_prep_pct.css", "device_idle_pct.css"}
    assert files["traffic"]["driver"] == "css_separate"
    assert files["config"]["reduced"] == []


H100 = "NVIDIA H100 80GB HBM3"


def _record(trace):
    return dict(trace=trace, device_kind=H100, window_s=10.0, calls=4,
                counters=dict(padded=4096),
                work=dict(flops=dict(conformer=1e15, stft=1e13),
                          conformer_flops=989e9, conformer_bytes=3.35e9))


def _trace(spans):
    ops = [("gemm", 100.0, 400.0), ("solve", 500.0, 700.0),
           ("copy", 900.0, 950.0)]
    return harness.Trace(ops=ops, spans=spans, t0=0.0, t1=1000.0)


SPANS = [("stage.conformer", 90.0, 450.0), ("stage.mvdr", 480.0, 750.0),
         ("stage.css.prepare", 0.0, 50.0), ("stage.css.upload", 50.0, 80.0),
         ("stage.css.readback", 880.0, 1000.0)]


@pytest.mark.parametrize("name,spans,want", [
    # 1.01e15 FLOP over 10 s at 989 TFLOP/s
    ("css_mfu_pct", SPANS, 100.0 * 1.01e15 / 10.0 / 989e12),
    # 1 ms of need (both bounds) over the gemm's 300 us
    ("conformer_roofline.css", SPANS, 100.0 * 1e-3 / 300e-6),
    ("conformer_roofline.css", SPANS[1:], None),
    # the solve's 200 us over 1024 windows a call
    ("mvdr_ms_per_segment.css", SPANS, 1000.0 * 200e-6 / 1024),
    ("mvdr_ms_per_segment.css", SPANS[2:], None),
    # 50 + 30 + 120 us of the 1000 us call, less the copy's 50 us in the
    # read-back
    ("host_prep_pct.css", SPANS, 15.0),
    ("host_prep_pct.css", SPANS[:2], None),
    # busy 300 + 200 + 50 us of 1000
    ("device_idle_pct.css", SPANS, 45.0)])
def test_reader_on_a_hand_built_trace(name, spans, want):
    got = harness.metric_reader(name)(_record(_trace(spans)))
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)


@pytest.mark.parametrize("name", [
    "conformer_roofline.css", "mvdr_ms_per_segment.css",
    "host_prep_pct.css", "device_idle_pct.css"])
def test_readers_read_nothing_without_a_trace(name):
    rec = _record(None)
    assert harness.metric_reader(name)(rec) is None


def test_counts_by_part():
    from gpubench.counts import conformer, css
    from gpubench.reference import conformer as reference
    c = {"attention_dim": 512, "attention_heads": 8, "linear_units": 1024,
         "kernel_size": 33, "num_blocks": 18, "in_features": 1799,
         "num_bins": 257, "num_spks": 3, "num_nois": 1, "pos_maxlen": 1000}
    parts = css.part_flops(c, [dict(frames=22499, windows=241)] * 4, 186, 93)
    assert parts["conformer"] == 964 * conformer.forward_flops(c, 186)
    assert parts["covariances"] == 964 * 8 * 4 * 257 * 186 * 49
    assert parts["conformer"] > 0.9 * sum(parts.values())
    specs = reference.param_specs(c)
    assert css.weight_bytes(specs) == 4.0 * sum(
        torch.Size(s).numel() for _, s, _ in specs)


def test_reference_and_driver_load_no_jax():
    import subprocess
    import sys
    code = ("import gpubench.reference.css, gpubench.drivers.css_separate\n"
            "import sys\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    names = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not names & {"notsofar_tpu_torch", "notsofar_tpu", "jax",
                        "jaxlib", "flax"}
