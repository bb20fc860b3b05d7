"""Build the CUDA kernels in ``notsofar_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with ctypes
(no PyTorch headers, so a build takes seconds, not minutes). The first
use of any kernel builds every missing library, one ``nvcc`` per source,
all started together. Libraries go to ``csrc/build/`` (listed in
.gitignore), named by a hash of their sources and flags, so an edited
source is rebuilt and an unchanged one is reused.

Nothing is built at import: the CPU tests import every module.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
KERNELS = ("encoder_mha", "attn_step", "attn_step_split", "depthwise_conv1d",
           "masked_scm", "xattn_int8", "xattn_stream", "xattn_onedot",
           "attn_step_split_bias", "xattn_step", "decode_gemv")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures (all return the launch's cudaGetLastError())
_ARGTYPES = {
    "encoder_mha": ("encoder_mha", [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "attn_step": ("attn_step", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _I, _I, _P]),
    "attn_step_split": ("attn_step_split", [_P, _P, _P, _P, _P, _P, _P, _P,
                                            _P, _I, _I, _I, _I, _I, _I, _I,
                                            _I, _I, _P]),
    "depthwise_conv1d": ("depthwise_conv1d", [_P, _P, _P, _I, _I, _I, _I,
                                              _I, _P]),
    "masked_scm": ("masked_scm", [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "xattn_int8": ("xattn_int8", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _P]),
    "xattn_stream": ("xattn_stream", [_P, _P, _P, _P, _I, _I, _I, _P]),
    "xattn_onedot": ("xattn_onedot", [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _I, _I, _P]),
    "attn_step_split_bias": ("attn_step_split_bias",
                             [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _I, _I, _P]),
    "xattn_step": ("xattn_step", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                  _I, _I, _P]),
    "decode_gemv": ("decode_gemv", [_P, _I, _I, _I, _P, _P, _P, _F, _I, _I,
                                    _I, _I, _I, _I, _I, _I, _P]),
}


class GemvSeg(ctypes.Structure):
    """csrc/decode_gemv.cu's GemvSeg: one weight of a decode_gemv launch
    and its epilogue (pointers as ints, None for null)."""
    _fields_ = [("w", _P), ("scale", _P), ("bias", _P), ("out", _P),
                ("residual", _P), ("post", _P), ("slot", _P),
                ("row_stride", ctypes.c_longlong), ("n", _I), ("b_f32", _I),
                ("out_bf16", _I), ("logits", _I), ("gelu", _I),
                ("post_rows", _I), ("mul", _F), ("post_s", _F)]

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels are built from csrc/ at first use")
    return found


def lib_path(name: str, extra: Sequence[str] = ()) -> Path:
    """csrc/<name>.cu's library built with NVCC_FLAGS + extra, named by a
    hash of its sources and flags."""
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.read_bytes())
    h.update(" ".join([*NVCC_FLAGS, *extra]).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Sequence[str] = KERNELS,
              extra: Sequence[str] = ()) -> Dict[str, str]:
    """Compile every named kernel whose library (with the extra nvcc
    flags) is missing, one nvcc per source, all in parallel. Returns
    {name: nvcc output} for the ones built; raises with the compiler's
    output if any build fails."""
    todo = [n for n in names if not lib_path(n, extra).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        out = lib_path(n, extra)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    logs, failed = {}, []
    for n, (p, tmp, out) in procs.items():
        logs[n] = p.communicate()[0]
        if p.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(n)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, building all missing kernels first."""
    lib: Optional[ctypes.CDLL] = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(lib_path(name)))
        fn_name, argtypes = _ARGTYPES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
