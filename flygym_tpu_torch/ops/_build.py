"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``flygym_tpu_torch/csrc/*.cu`` file is compiled at first use into one
shared library with a plain C interface, under ``flygym_tpu_torch/_build/``.
The library's name carries a hash of the sources and flags, so an edit to a
source builds anew and an unchanged tree reuses its build. Only the sources
in the repository are used. A failed build raises with nvcc's stderr.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["load_library", "NVCC_FLAGS"]

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
)

_lib = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"libflygym_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if their library is not built yet; return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    # Build to a private name, then rename: concurrent processes never load
    # a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on the first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tree_ldl_factor_f32.argtypes = [p, p, p, p, p, p, i, i, i, p]
        lib.tree_ldl_factor_f32.restype = i
        lib.tree_ldl_solve_f32.argtypes = [p, p, p, p, p, p, p, p, i, i, i, p]
        lib.tree_ldl_solve_f32.restype = i
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
