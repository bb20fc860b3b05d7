"""The port's one loader of native libraries (notsofar_tpu_torch/utils/
native.py) and its four C++ cores, on the CPU.

Each core loads once through load_native from a hash-named library under
native/build/, and its declared functions give the Python twin's answers.
Without a compiler each core warns once and gives None, and its caller's
public function answers as it does with the core. An edited source gets a
new library name, and two processes building one core at once both load a
whole library. Skips only where no g++ can build the cores.

The answers are equal bit for bit, except segread's: the native reader
multiplies by the float32 reciprocal of the scale where the Python reader
divides by it, two roundings against one, so they are held within two
float32 epsilons relative.
"""
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from notsofar_tpu_torch.asr import decoding as tdec
from notsofar_tpu_torch.training import dataset as tds
from notsofar_tpu_torch.utils import native
from notsofar_tpu_torch.utils.native import ptr
from notsofar_tpu_torch.utils.scoring import exact_orc as texact
from notsofar_tpu_torch.utils.scoring import levenshtein as tlev
from notsofar_tpu_torch.utils.scoring.seglst import SegLst
from tests.test_scoring import _random_session
from tests.test_training import write_sim_dataset

REPO = Path(__file__).resolve().parents[1]
CORES = ["tclev", "orc", "segread", "dtw"]
RTOL = {"segread": 2 * float(np.finfo(np.float32).eps)}


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native cores")


def _tclev_answers(lib, _tmp):
    """tc_levenshtein (interval-constrained) and levenshtein, as
    (errors, substitutions, insertions, deletions)."""
    ref = np.array([1, 2, 3, 4, 2], np.int32)
    hyp = np.array([1, 3, 3, 5, 4, 2], np.int32)
    rb = np.array([0.0, 1.0, 2.0, 3.0, 4.0])
    hb = np.array([0.0, 1.2, 2.0, 2.5, 3.1, 6.0])
    inf = np.full(len(ref), 1e30)
    if lib is None:
        return [tuple(vars(tlev._tc_lev_numpy(ref, rb, rb + 1.5, hyp, hb,
                                              hb + 1.0)).values()),
                tuple(vars(tlev._tc_lev_numpy(
                    ref, -inf, inf, hyp, np.zeros(len(hyp)),
                    np.ones(len(hyp)))).values())]
    tc, lev = np.zeros(4, np.int64), np.zeros(4, np.int64)
    lib.tc_levenshtein(ptr(ref), ptr(rb), ptr(rb + 1.5), len(ref), ptr(hyp),
                       ptr(hb), ptr(hb + 1.0), len(hyp), ptr(tc))
    lib.levenshtein(ptr(ref), len(ref), ptr(hyp), len(hyp), ptr(lev))
    return [tuple(tc.tolist()), tuple(lev.tolist())]


def _session():
    ref, hyp = _random_session(np.random.RandomState(7), 8, 2,
                               ["a", "b", "c"])
    return SegLst([dict(r) for r in ref]), SegLst([dict(r) for r in hyp])


def _orc_answers(lib, _tmp):
    """The exact tcORC-WER of a seeded session: orc_exact on every block,
    or assignment enumeration."""
    assert native.load_native("orc") is lib
    return texact.tcorc_wer_exact(*_session(), collar=5.0)


def _segread_answers(lib, tmp):
    """Rows 3..9 of a [20, 7] int16 column, descaled: one
    read_scaled_segment_i16, or the dataset's own int16 / scale."""
    raw = np.random.RandomState(3).randint(-32768, 32767, (20, 7))
    path = tmp / "col.bin"
    raw.astype(np.int16).tofile(path)
    if lib is None:
        return raw[3:10].astype(np.int16).astype(np.float32) / 3.7
    out = np.empty((7, 7), np.float32)
    assert lib.read_scaled_segment_i16(str(path).encode(), 3, 7, 7, 3.7,
                                       ptr(out)) == 0
    return out


def _dtw_answers(lib, _tmp):
    """The DTW path of a float32 cost with quarter-step ties."""
    cost = np.round(np.random.RandomState(5).randn(30, 90) * 4) / 4
    cost = np.ascontiguousarray(cost, np.float64)
    if lib is None:
        return [a.tolist() for a in tdec._dtw_path_numpy(cost)]
    ti, tj = np.empty(120, np.int32), np.empty(120, np.int32)
    n = lib.dtw_path(ptr(cost), 30, 90, ptr(ti), ptr(tj))
    return [ti[:n].tolist(), tj[:n].tolist()]


def _assert_same(a, b, rtol=0.0):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k], rtol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y, rtol)
    elif rtol and np.asarray(a).dtype.kind == "f":
        np.testing.assert_allclose(a, b, rtol=rtol, atol=0)
    else:
        np.testing.assert_array_equal(a, b)


ANSWERS = {"tclev": _tclev_answers, "orc": _orc_answers,
           "segread": _segread_answers, "dtw": _dtw_answers}


@pytest.mark.parametrize("core", CORES)
def test_core_loads_once_through_the_one_loader(gxx, tmp_path, monkeypatch,
                                                core):
    """load_native builds the core into native/build/lib<core>-<hash>.so,
    its declared functions give the Python twin's answers, and a second
    call gives the same library object."""
    lib = native.load_native(core)
    assert lib is not None
    path = native.core_path(core)
    assert path.parent == REPO / "notsofar_tpu_torch" / "native" / "build"
    assert re.fullmatch(rf"lib{core}-[0-9a-f]{{12}}\.so", path.name)
    assert lib._name == str(path) and path.exists()
    assert native.load_native(core) is lib
    got = ANSWERS[core](lib, tmp_path)
    monkeypatch.setitem(native._LIBS, core, None)
    _assert_same(got, ANSWERS[core](None, tmp_path), RTOL.get(core, 0.0))


def _public_answer(core, tmp):
    """The caller's public function over a small input."""
    if core == "tclev":
        r = tlev.tc_levenshtein(np.array([1, 2, 3]), np.array([0.0, 1, 2]),
                                np.array([1.0, 2, 3]), np.array([1, 3]),
                                np.array([0.2, 2.1]), np.array([0.9, 2.8]))
        return [vars(r), tlev.levenshtein(np.array([5, 6, 7]),
                                          np.array([5, 7, 7, 8]))]
    if core == "orc":
        return texact.tcorc_wer_exact(*_session(), collar=5.0)
    if core == "segread":
        root = tmp / "sim"
        if not root.exists():
            write_sim_dataset(root, n_utts=2, n_samples=12000)
        ds = tds.SimulatedDataset(str(root),
                                  tds.SegmentSplitter(2000, 4000, 0.5, 8000),
                                  seed=3)
        return [ds[i] for i in range(len(ds))]
    cost = np.round(np.random.RandomState(9).randn(40, 300) * 4) / 4
    return [a.tolist() for a in tdec.dtw_path(cost.astype(np.float32))]


@pytest.mark.parametrize("core", CORES)
def test_core_falls_back_when_it_cannot_be_built(gxx, tmp_path, monkeypatch,
                                                 caplog, core):
    """With $CXX naming no compiler and an empty build directory, the
    loader warns once, naming the core, and gives None; the caller's
    public function answers as it does with the core, and dtw_path counts
    no window as native."""
    assert native.load_native(core) is not None
    before = tdec.DECODE_STEPS["dtw_native"]
    want = _public_answer(core, tmp_path)
    if core == "dtw":
        assert tdec.DECODE_STEPS["dtw_native"] == before + 1
    src = tmp_path / "native"
    shutil.copytree(native.NATIVE_DIR, src, ignore=shutil.ignore_patterns(
        "build"))
    monkeypatch.setattr(native, "NATIVE_DIR", src)
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert native.load_native(core) is None
    assert native.load_native(core) is None
    warned = [r for r in caplog.records
              if r.name == "native" and f"native {core} core" in r.message]
    assert len(warned) == 1
    assert not (src / "build").exists() or \
        not any((src / "build").glob("*.so"))
    before = tdec.DECODE_STEPS["dtw_native"]
    _assert_same(_public_answer(core, tmp_path), want, RTOL.get(core, 0.0))
    assert tdec.DECODE_STEPS["dtw_native"] == before


_LOAD_IN_A_PROCESS = """
import sys
from pathlib import Path
import numpy as np
from notsofar_tpu_torch.utils import native
native.NATIVE_DIR = Path(sys.argv[1])
lib = native.load_native("dtw")
cost = np.arange(12, dtype=np.float64).reshape(3, 4)
ti, tj = np.zeros(7, np.int32), np.zeros(7, np.int32)
n = lib.dtw_path(native.ptr(cost), 3, 4, native.ptr(ti), native.ptr(tj))
print(lib._name, ti[:n].tolist(), tj[:n].tolist())
"""


def test_core_rebuilds_on_edit_and_builds_whole_in_parallel(gxx, tmp_path,
                                                            monkeypatch):
    """A copy of dtw.cpp keeps its library name until it is edited, then
    gets a new one. Two processes load the edited core at once, their $CXX
    a wrapper of g++ that holds each compile until both have started: each
    compiler writes a temporary name of its own process, and both processes
    load a whole library under the one final name, leaving no temporary."""
    src = tmp_path / "native"
    src.mkdir()
    shutil.copy(native.NATIVE_DIR / "dtw.cpp", src)
    monkeypatch.setattr(native, "NATIVE_DIR", src)
    first = native.core_path("dtw")
    assert native.core_path("dtw") == first
    with open(src / "dtw.cpp", "a") as f:
        f.write("// edited\n")
    edited = native.core_path("dtw")
    assert edited != first and edited.parent == src / "build"
    seen = tmp_path / "seen"
    seen.mkdir()
    cxx = tmp_path / "cxx"
    cxx.write_text(f"""#!/bin/sh
touch {seen}/started.$$
i=0
while [ $(ls {seen} | grep -c started) -lt 2 ] && [ $i -lt 600 ]; do
  sleep 0.1; i=$((i + 1))
done
prev=
for a; do [ "$prev" = -o ] && echo "$a" >> {seen}/outs; prev=$a; done
exec g++ "$@"
""")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD_IN_A_PROCESS,
                               str(src)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    ti, tj = (list(map(int, a)) for a in tdec._dtw_path_numpy(
        np.arange(12, dtype=np.float64).reshape(3, 4)))
    assert [out for out, _ in outs] == [f"{edited} {ti} {tj}\n"] * 2
    tmps = (seen / "outs").read_text().split()
    assert sorted(tmps) == sorted(f"{edited.with_suffix('')}.{p.pid}.tmp"
                                  for p in procs)
    assert sorted(p.name for p in (src / "build").iterdir()) == [edited.name]
