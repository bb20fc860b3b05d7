"""Build, name and load the port's native libraries: the CUDA kernels of
``csrc/`` (through ``ops/build.py``) and the C++ host cores of ``native/``.

A library is ``build/lib<name>-<hash>.so``, hashed over its sources and
flags. The compiler writes a temporary name, renamed only on success, so
concurrent builds never expose a half-written library. Each library is
loaded once per process, its signatures declared. A C++ core that cannot be
built or loaded warns once and gives None, and its caller takes its Python
twin; a CUDA build failure raises. Nothing is built at import.
"""
import ctypes
import hashlib
import os
import shlex
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from notsofar_tpu_torch.utils.logging_def import get_logger

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)
_I64 = ctypes.c_int64
# native/<name>.cpp's exported functions: {function: (restype, argtypes)}
CORES = {
    "tclev": {"tc_levenshtein": (_I64, [_I32P, _F64P, _F64P, _I64, _I32P,
                                        _F64P, _F64P, _I64, _I64P]),
              "levenshtein": (_I64, [_I32P, _I64, _I32P, _I64, _I64P])},
    "orc": {"orc_exact": (_I64, [_I32P, _F64P, _F64P, _I32P, _I64, _I32P,
                                 _F64P, _F64P, _I64P, _I64, _I64, _I64P])},
    "segread": {"read_scaled_segment_i16": (
        ctypes.c_int, [ctypes.c_char_p, _I64, _I64, _I64, ctypes.c_double,
                       ctypes.POINTER(ctypes.c_float)])},
    "dtw": {"dtw_path": (_I64, [_F64P, _I64, _I64, _I32P, _I32P])},
}

_LIBS: Dict[str, Optional[ctypes.CDLL]] = {}
_LOCK = threading.Lock()


def lib_path(build_dir: Path, name: str, sources: Sequence[Path],
             flags: Sequence[str]) -> Path:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    return build_dir / f"lib{name}-{h.hexdigest()[:12]}.so"


def compile_all(jobs: Mapping[Path, Tuple[Sequence[str], Path]]
                ) -> Dict[Path, Tuple[int, str]]:
    """Run every job {out: (command, source)} at once as ``command -o <tmp>
    source``, tmp renamed to out on success: {out: (exit code, output)}."""
    procs = {}
    for out, (cmd, src) in jobs.items():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[out] = tmp, subprocess.Popen(
            [*cmd, "-o", str(tmp), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    done = {}
    for out, (tmp, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        done[out] = proc.returncode, log
    return done


def open_library(path: Path, signatures: Mapping) -> ctypes.CDLL:
    """ctypes-load path with signatures {function: (restype, argtypes)}."""
    lib = ctypes.CDLL(str(path))
    for fn_name, (restype, argtypes) in signatures.items():
        getattr(lib, fn_name).restype = restype
        getattr(lib, fn_name).argtypes = argtypes
    return lib


def ptr(a: np.ndarray):
    """a's data as a pointer to its C element type (an int32 array's as
    POINTER(c_int32)), so that a declared argtype checks the dtype."""
    return a.ctypes.data_as(ctypes.POINTER(np.ctypeslib.as_ctypes_type(
        a.dtype)))


def load_once(name: str, open_fn: Callable[[str], Optional[ctypes.CDLL]]
              ) -> Optional[ctypes.CDLL]:
    """open_fn(name) once (one thread at a time), then what it gave."""
    if name not in _LIBS:
        with _LOCK:
            if name not in _LIBS:
                _LIBS[name] = open_fn(name)
    return _LIBS[name]


def core_path(name: str) -> Path:
    return lib_path(NATIVE_DIR / "build", name, [NATIVE_DIR / f"{name}.cpp"],
                    CXX_FLAGS)


def _open_core(name: str) -> Optional[ctypes.CDLL]:
    cxx = shlex.split(os.environ.get("CXX", "g++"))
    try:
        out = core_path(name)
        if not out.exists():
            rc, log = compile_all({out: ([*cxx, *CXX_FLAGS],
                                         NATIVE_DIR / f"{name}.cpp")})[out]
            if rc != 0:
                raise OSError(f"{shlex.join(cxx)} failed:\n{log}")
        return open_library(out, CORES[name])
    except OSError as e:
        get_logger("native").warning(f"native {name} core not built or "
                                     f"loaded ({e}); using its Python twin")
        return None


def load_native(name: str) -> Optional[ctypes.CDLL]:
    """The C++ core native/<name>.cpp (a key of CORES), built with $CXX
    (g++ if unset) at first use and loaded once; None where it cannot be."""
    return load_once(name, _open_core)
