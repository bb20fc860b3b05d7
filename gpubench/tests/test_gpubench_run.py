"""The run command without a card, without the program beside it, and
with JAX loaded after the window."""
import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def _run(cwd: Path, workload: str):
    return subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", workload,
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(cwd)})


def _no_result(stdout: str):
    for line in stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


@pytest.mark.parametrize("workload", [
    w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())
    ["workloads"]])
def test_no_card_exits_non_zero(workload):
    proc = _run(ROOT, workload)
    assert proc.returncode != 0
    _no_result(proc.stdout)


def test_without_the_program_exits_non_zero(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path, "asr_beam5_9x120s")
    assert proc.returncode != 0
    _no_result(proc.stdout)


@pytest.mark.parametrize("loads_jax", [False, True])
def test_jax_loaded_by_the_check_prints_no_result(monkeypatch, capsys,
                                                  loads_jax):
    """A cell whose output check loads a module named jax, after the
    window has closed: the run exits non-zero and prints no result (and
    without it, prints one)."""
    from gpubench import harness, run

    class Cell:
        def call(self):
            return 1.0

        def start_window(self):
            pass

        def window_record(self):
            return {}

        def release(self):
            pass

    def check(ctx, record):
        if loads_jax:
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return [harness.Check("err", 0.0, 1.0)]

    files = dict(cell={"name": "fake", "chips": 1}, config={},
                 traffic={"driver": "fake"}, per_layer=[],
                 end_to_end=[{"name": "setup_s", "unit": "s"},
                             {"name": "rate", "unit": "1/s"}])
    fake = types.SimpleNamespace(setup=lambda ctx: Cell(), check=check)
    monkeypatch.setattr(harness, "driver", lambda name: fake)
    monkeypatch.setattr(harness, "set_run_environment", lambda root: None)
    monkeypatch.setattr(harness, "run", lambda name, seed, seconds, trace,
                        **kw: harness.run_files(files, seed, seconds, trace,
                                                device="cpu",
                                                log=lambda *a: None))
    rc = run.main(["--workload", "fake", "--seed", "3000000001",
                   "--seconds", "0.01", "--trace", "0"])
    out = capsys.readouterr()
    if loads_jax:
        assert rc != 0 and "jax" in out.err
        _no_result(out.out)
    else:
        assert rc == 0
        assert json.loads(out.out.splitlines()[-1])["correct"]
