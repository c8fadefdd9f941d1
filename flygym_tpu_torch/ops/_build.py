"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The builds, each at first use, under ``flygym_tpu_torch/_build/``:

- The model-independent kernels: every ``flygym_tpu_torch/csrc/*.cu`` file
  except ``megastep.cu`` (the tree-LDL factor and solve K1/K1b, the retina
  K3), compiled into one shared library (:func:`build`,
  :func:`load_library`).
- K3's source alone (:func:`build_retina`, :func:`load_retina`): its
  profile build (``-DRT_PROFILE``: the cull's keep mask), its builds with
  other warps per block (``-DRT_WARPS``) and K3 as it stood before its
  redesign (``scripts/k3_before_redesign/retina.cu``, passed as
  ``source``).
- A K1/K1b source alone (:func:`build_ldl`, :func:`load_ldl`): K1/K1b as
  they stood before their redesign (``scripts/k1_before_redesign/tree_ldl.cu``).
- The mega-step kernel K2 (:func:`build_megastep`, :func:`load_megastep`):
  ``csrc/megastep.cu`` with the model's generated header
  ``megastep_model.h`` (``ops/megastep.py:model_header``), one library per
  model, and on request its profile build (``-DMS_PROFILE``: clock64
  counters of the step's phases).

nvcc's ``-Xptxas -v`` report of each build is kept beside it
(:func:`ptxas_report`). Each library's name carries a hash of its sources,
flags and (for K2) the header, so an edit builds anew and an unchanged tree
reuses its build. Only the sources in the repository and the model's arrays
are used. A failed build raises with the compiler's stderr.
:func:`build_megastep_host`, :func:`build_retina_host` and
:func:`build_ldl_host` compile the same K2, K3 and K1/K1b sources as host
C++ with g++, for the CPU tests.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = [
    "build",
    "build_ldl",
    "build_ldl_host",
    "build_megastep",
    "build_megastep_host",
    "build_retina",
    "build_retina_host",
    "load_library",
    "load_ldl",
    "load_megastep",
    "load_retina",
    "ptxas_report",
    "NVCC_FLAGS",
]

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
MEGASTEP_SRC = CSRC / "megastep.cu"
RETINA_SRC = CSRC / "retina.cu"
LDL_SRC = CSRC / "tree_ldl.cu"
# The kernels keep their plain versions' arithmetic: no contraction into
# FMAs; IEEE div and sqrt are nvcc's defaults. -Xptxas -v reports registers,
# stack and spills.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
)
GXX_FLAGS = ("-x", "c++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC")

_lib = None
_megastep_libs = {}
_retina_libs = {}
_ldl_libs = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources():
    return sorted(p for p in CSRC.glob("*.cu") if p != MEGASTEP_SRC)


def _digest(flags, sources, extra: str = "") -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(extra.encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD / f"libflygym_kernels_{_digest(NVCC_FLAGS, _sources() + sorted(CSRC.glob('*.cuh')))}.so"


def _compile(cmd_head: list, out: Path, sources: list) -> str:
    """Run a compiler into ``out`` via a private name; return its stderr."""
    out.parent.mkdir(parents=True, exist_ok=True)
    # Build to a private name, then rename: concurrent processes never load
    # a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [*cmd_head, "-o", tmp, *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"build failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return proc.stderr


def _ptxas_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def build() -> Path:
    """Compile the model-independent kernels if not built yet; return the
    path. nvcc's ptxas report is written beside the library."""
    out = library_path()
    if not out.exists():
        log = _compile([_nvcc(), *NVCC_FLAGS], out, _sources())
        _ptxas_path(out).write_text(log)
    return out


def load_library() -> ctypes.CDLL:
    """The model-independent kernels' shared library, built on the first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        _ldl_signatures(lib)
        _retina_signatures(lib)
        _lib = lib
    return _lib


def _signatures(lib: ctypes.CDLL, signatures: dict) -> None:
    """Argument types, and an int result, of each entry point of
    ``signatures`` that ``lib`` exports."""
    for name, args in signatures.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = args
            fn.restype = ctypes.c_int
    if hasattr(lib, "cuda_error_string"):
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p


def _ldl_signatures(lib: ctypes.CDLL) -> None:
    """Argument types of the K1/K1b entry points that ``lib`` exports (the
    shipped kernels', their host builds', the before build's)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    _signatures(lib, {
        "tree_ldl_factor_f32": [p, p, p, p, i, i, i, i, i, p],
        "tree_ldl_solve_f32": [p, p, p, p, p, i, i, i, i, i, p],
        "tree_ldl_shape": [i, i, i, p],
        "tree_ldl_factor_host_f32": [p, p, p, p, i, i, i, i, i, i],
        "tree_ldl_solve_host_f32": [p, p, p, p, p, i, i, i, i, i, i],
        "tree_ldl_before_factor_f32": [p, p, p, p, p, p, i, i, i, p],
        "tree_ldl_before_solve_f32": [p, p, p, p, p, p, p, p, i, i, i, p],
        "tree_ldl_before_factor_host_f32": [p, p, p, p, p, p, i, i, i],
        "tree_ldl_before_solve_host_f32": [p, p, p, p, p, p, p, p, i, i, i],
    })


def _retina_signatures(lib: ctypes.CDLL) -> None:
    """Argument types of the K3 entry points that ``lib`` exports (the
    shipped kernel's, its profile and host builds', the before build's)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tiled = [p] * 8 + [i, i, i, i, f, f, i]
    plain = [p] * 6 + [i, i, i, f, f, i]
    _signatures(lib, {
        "retina_f32": [*tiled, p],
        "retina_profile_f32": [*tiled, p, p],
        "retina_shape": [i, i, p],
        "retina_tiles_host_f32": [p] * 9 + tiled[8:],
        "retina_host_f32": plain,
        "retina_before_f32": [*plain, p],
        "retina_before_host_f32": plain,
    })


def _build_alone(src: Path, flags) -> Path:
    """One source with nvcc into its own library, named by the source's
    folder, stem and a hash of its text and flags; nvcc's ptxas report
    beside it."""
    out = BUILD / f"lib{src.parent.name}_{src.stem}_{_digest(flags, [src])}.so"
    if not out.exists():
        log = _compile([_nvcc(), *flags], out, [src])
        _ptxas_path(out).write_text(log)
    return out


def _load_alone(cache: dict, key, build_fn, signatures) -> ctypes.CDLL:
    """The library that ``build_fn()`` builds, loaded once per ``key`` (its
    build's arguments): a later call neither hashes nor stats its source."""
    lib = cache.get(key)
    if lib is None:
        lib = cache[key] = ctypes.CDLL(str(build_fn()))
        signatures(lib)
    return lib


def build_retina(source: Path | None = None, profile: bool = False,
                 warps: int | None = None) -> Path:
    """K3's source alone with nvcc into its own library; return its path,
    with nvcc's ptxas report beside it. ``profile`` builds the variant that
    also exports ``retina_profile_f32`` (``-DRT_PROFILE``: the cull's keep
    mask); ``warps`` builds K3 with that many warps per block
    (``-DRT_WARPS``; the shipped build's is the source's default);
    ``source`` replaces ``csrc/retina.cu``: ``chip_smoke.py`` builds K3 as
    it stood before its redesign (``scripts/k3_before_redesign/retina.cu``)."""
    src = RETINA_SRC if source is None else Path(source)
    flags = (*NVCC_FLAGS, *(("-DRT_PROFILE=1",) if profile else ()),
             *((f"-DRT_WARPS={warps}",) if warps is not None else ()))
    return _build_alone(src, flags)


def load_retina(source: Path | None = None, profile: bool = False,
                warps: int | None = None) -> ctypes.CDLL:
    """The library of :func:`build_retina`, built on the first call."""
    return _load_alone(_retina_libs, (source, profile, warps),
                       lambda: build_retina(source, profile, warps), _retina_signatures)


def build_ldl(source: Path) -> Path:
    """A K1/K1b source alone with nvcc into its own library; return its
    path, with nvcc's ptxas report beside it: ``chip_smoke.py`` builds K1/K1b
    as they stood before their redesign
    (``scripts/k1_before_redesign/tree_ldl.cu``)."""
    return _build_alone(Path(source), NVCC_FLAGS)


def load_ldl(source: Path) -> ctypes.CDLL:
    """The library of :func:`build_ldl`, built on the first call."""
    return _load_alone(_ldl_libs, source, lambda: build_ldl(source), _ldl_signatures)


def _megastep_dir(header: str, flags, source: Path = MEGASTEP_SRC) -> Path:
    """The build directory of K2 for one model header: holds the header."""
    d = BUILD / f"megastep_{_digest(flags, [source], header)}"
    d.mkdir(parents=True, exist_ok=True)
    path = d / "megastep_model.h"
    if not path.exists() or path.read_text() != header:
        fd, tmp = tempfile.mkstemp(suffix=".h", dir=d)
        with os.fdopen(fd, "w") as f:
            f.write(header)
        os.replace(tmp, path)
    return d


def build_megastep(header: str, profile: bool = False, source: Path | None = None) -> Path:
    """Compile K2 for the model whose header is ``header``; return the
    library's path, with nvcc's ptxas report beside it. ``profile`` builds
    the variant with ``clock64`` phase counters (``-DMS_PROFILE``), whose
    ``megastep_profile_f32`` takes one more buffer. ``source`` replaces
    ``csrc/megastep.cu``: ``chip_smoke.py`` profiles K2 as it stood before
    its redesign (``scripts/k2_before_redesign``) with its own header."""
    src = MEGASTEP_SRC if source is None else Path(source)
    flags = (*NVCC_FLAGS, "-DMS_PROFILE=1") if profile else NVCC_FLAGS
    d = _megastep_dir(header, flags, src)
    out = d / "libmegastep.so"
    if not out.exists():
        log = _compile([_nvcc(), *flags, "-I", str(d)], out, [src])
        _ptxas_path(out).write_text(log)
    return out


def ptxas_report(header: str | None = None, library: Path | None = None) -> str:
    """The ``-Xptxas -v`` lines of K2's build for ``header``, of the built
    ``library`` (a path from :func:`build_retina`), or of the
    model-independent library without either (built if need be)."""
    if library is None:
        library = build() if header is None else build_megastep(header)
    path = _ptxas_path(library)
    return path.read_text() if path.exists() else ""


def load_megastep(header: str, profile: bool = False, source: Path | None = None) -> ctypes.CDLL:
    """K2 for one model, built on the first call (``build_megastep``'s
    arguments)."""
    path = build_megastep(header, profile, source)
    lib = _megastep_libs.get(path)
    if lib is None:
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        if profile:
            lib.megastep_profile_f32.argtypes = [p, p, p, p, i, i, p]
            lib.megastep_profile_f32.restype = i
        else:
            lib.megastep_f32.argtypes = [p, p, p, i, i, p]
            lib.megastep_f32.restype = i
            if hasattr(lib, "megastep_powf_f32"):  # not in the build before the redesign
                lib.megastep_powf_f32.argtypes = [p, p, p, i, p]
                lib.megastep_powf_f32.restype = i
            lib.megastep_shape.argtypes = [p]
            lib.megastep_shape.restype = i
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _megastep_libs[path] = lib
    return lib


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    return gxx


def build_megastep_host(header: str) -> ctypes.CDLL:
    """K2's source compiled as host C++ with g++, loaded:
    ``megastep_host_f32(in, out, scratch, B, K, order)`` runs the kernel's
    blocks as a loop over worlds and each of their parallel loops serially,
    in order (``order`` 0) or reversed (1)."""
    gxx = _gxx()
    d = _megastep_dir(header, GXX_FLAGS)
    out = d / "libmegastep_host.so"
    if not out.exists():
        _compile([gxx, *GXX_FLAGS, "-I", str(d)], out, [MEGASTEP_SRC])
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.megastep_host_f32.argtypes = [p, p, p, i, i, i]
    lib.megastep_host_f32.restype = i
    lib.megastep_powf_host_f32.argtypes = [p, p, p, i]
    lib.megastep_powf_host_f32.restype = i
    return lib


def _build_host(src: Path) -> Path:
    out = BUILD / f"lib{src.parent.name}_{src.stem}_host_{_digest(GXX_FLAGS, [src])}.so"
    if not out.exists():
        _compile([_gxx(), *GXX_FLAGS], out, [src])
    return out


def build_ldl_host(source: Path | None = None) -> ctypes.CDLL:
    """K1/K1b's source compiled as host C++ with g++, loaded: each warp's
    phases as loops over their items, in order or reversed
    (``tree_ldl_factor_host_f32``, ``tree_ldl_solve_host_f32``, batch-first
    like the card's). ``source`` replaces ``csrc/tree_ldl.cu``: the before
    build's ``tree_ldl_before_factor_host_f32`` and
    ``tree_ldl_before_solve_host_f32`` (world-minor, one world after
    another)."""
    lib = ctypes.CDLL(str(_build_host(LDL_SRC if source is None else Path(source))))
    _ldl_signatures(lib)
    return lib


def build_retina_host(source: Path | None = None) -> ctypes.CDLL:
    """K3's source compiled as host C++ with g++, loaded: the kernel's
    blocks as loops over worlds, eyes, tiles and slots, with the cull's keep
    mask if asked (``retina_tiles_host_f32``), and the same over the rays in
    lattice order, each ray a tile of its own (``retina_host_f32``).
    ``source`` replaces ``csrc/retina.cu`` (the before build's
    ``retina_before_host_f32``)."""
    lib = ctypes.CDLL(str(_build_host(RETINA_SRC if source is None else Path(source))))
    _retina_signatures(lib)
    return lib
