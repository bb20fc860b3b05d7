"""Build the CUDA kernels in ``notsofar_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with ctypes
(no PyTorch headers, so a build takes seconds, not minutes). The first
use of any kernel builds every missing library, one ``nvcc`` per source,
all started together. Libraries go to ``csrc/build/``, named, built and
loaded as ``utils/native.py`` does every native library of the port. A
CUDA build failure raises: a CUDA tensor has no fallback.

Nothing is built at import: the CPU tests import every module.
"""
import ctypes
import os
import shutil
from pathlib import Path
from typing import Dict, Sequence

from notsofar_tpu_torch.utils import native

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
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
    "align_reduce": ("align_reduce", [_P, _P, _P, _I, _I, _I, _I,
                                      ctypes.c_longlong, _I, _P]),
}
KERNELS = tuple(_ARGTYPES)


class GemvSeg(ctypes.Structure):
    """csrc/decode_gemv.cu's GemvSeg: one weight of a decode_gemv launch
    and its epilogue (pointers as ints, None for null)."""
    _fields_ = [("w", _P), ("scale", _P), ("bias", _P), ("out", _P),
                ("residual", _P), ("post", _P), ("slot", _P),
                ("row_stride", ctypes.c_longlong), ("n", _I), ("b_f32", _I),
                ("out_bf16", _I), ("logits", _I), ("gelu", _I),
                ("post_rows", _I), ("mul", _F), ("post_s", _F)]


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
    return native.lib_path(
        BUILD_DIR, name, [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))],
        [*NVCC_FLAGS, *extra])


def build_all(names: Sequence[str] = KERNELS,
              extra: Sequence[str] = ()) -> Dict[str, str]:
    """Compile every named kernel whose library (with the extra nvcc
    flags) is missing, one nvcc per source, all in parallel. Returns
    {name: nvcc output} for the ones built; raises with the compiler's
    output if any build fails."""
    outs = {n: lib_path(n, extra) for n in names}
    outs = {n: out for n, out in outs.items() if not out.exists()}
    if not outs:
        return {}
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra]
    done = native.compile_all({out: (cmd, CSRC / f"{n}.cu")
                               for n, out in outs.items()})
    logs = {n: done[out][1] for n, out in outs.items()}
    failed = [n for n, out in outs.items() if done[out][0] != 0]
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def _open(name: str) -> ctypes.CDLL:
    build_all()
    fn_name, argtypes = _ARGTYPES[name]
    return native.open_library(lib_path(name),
                               {fn_name: (ctypes.c_int, argtypes)})


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, building all missing kernels first."""
    return native.load_once(name, _open)
