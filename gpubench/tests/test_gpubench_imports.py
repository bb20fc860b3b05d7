"""Nothing the benchmark runs loads JAX or the JAX package; the plain
references load nothing of the port either."""
import subprocess
import sys
from pathlib import Path

from gpubench import harness

ROOT = Path(__file__).resolve().parents[2]


def _loaded(code: str):
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"
    )], cwd=ROOT, capture_output=True, text=True, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "notsofar_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert harness.forbidden_modules() == [] or all(
        m in harness.FORBIDDEN for m in harness.forbidden_modules())
    assert "notsofar_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in harness.forbidden_modules()


def test_references_load_nothing_of_the_port_or_jax():
    names = _loaded("import gpubench.reference.whisper, "
                    "gpubench.reference.conformer")
    assert not names & {"notsofar_tpu_torch", "notsofar_tpu", "jax",
                        "jaxlib", "flax"}


def test_harness_and_drivers_load_no_jax():
    names = _loaded("import gpubench.run, gpubench.harness, "
                    "gpubench.drivers.asr_transcribe, "
                    "gpubench.drivers.css_train, gpubench.calibrate\n"
                    "import notsofar_tpu_torch.asr.transcribe, "
                    "notsofar_tpu_torch.training.train")
    assert not names & set(harness.FORBIDDEN)
