"""Build the CUDA sources under ``mcpt_torch/csrc/`` with ``nvcc``, and the
host library under ``mcpt_torch/csrc/host/`` with ``g++``, and load them with
``ctypes``.

Each library is compiled at first use into ``build/mcpt_torch/`` at the root
of the checkout, named by a hash of its sources and flags, so an edited
source rebuilds and an unchanged one loads at once.  Its sources compile in
parallel, one compiler process each, and are then linked.  They have a plain
C interface and include no PyTorch header: a build takes seconds.  ``nvcc``
comes from ``$CUDA_HOME/bin``, ``PATH`` or ``/usr/local/cuda/bin``; ``g++``
from ``$CXX`` or ``PATH``.  A failed build raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "mcpt_torch"
SOURCES = ("megakernel.cu", "fused_bounce.cu", "cluster_mega.cu",
           "traverse.cu", "fma_peak.cu")
# -fmad=false: no contracted multiply-adds, so the kernels round as the plain
# PyTorch versions do (see csrc/bounce_core.cuh); no fast math either
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_SOURCES = ("host/treelet.cpp", "host/epo.cpp")
# mcpt/native/Makefile's flags: the treelet optimiser and the EPO walk must
# round as mcpt's native build does to give the same topology and the same sum
HOST_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread")


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise FileNotFoundError("nvcc not found (set CUDA_HOME or put nvcc on "
                            "PATH); the CUDA kernels are built from source")


def gxx_path() -> str:
    found = shutil.which(os.environ.get("CXX") or "g++")
    if not found:
        raise FileNotFoundError("g++ not found (set CXX or put g++ on "
                                "PATH); the host library (treelet "
                                "optimiser, EPO walk) is built from source")
    return found


def source_hash(flags: tuple[str, ...] = NVCC_FLAGS,
                pattern: str = "*.cu*") -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sorted(SRC_DIR.glob(pattern)):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(flags: tuple[str, ...] = NVCC_FLAGS) -> Path:
    return BUILD_DIR / f"libmcpt_kernels_{source_hash(flags)}.so"


def host_library_path() -> Path:
    return BUILD_DIR / (f"libmcpt_host_"
                        f"{source_hash(HOST_FLAGS, 'host/*.cpp')}.so")


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(cmd[0]).name} failed ({proc.returncode}):"
                           f"\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def _compile(compiler: str, flags, sources, lib: Path,
             link_flags=()) -> Path:
    """Unless ``lib`` exists: compile every source to an object with
    ``compiler flags -c``, all at once (one process each), then link them
    into ``lib`` with ``link_flags``.  The compilers' reports land beside it
    as ``.log``."""
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build in a private directory, then rename: concurrent builders never
    # load a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{Path(s).stem}.o") for s in sources]
        with ThreadPoolExecutor(max_workers=len(sources)) as pool:
            logs = list(pool.map(_run, [
                [compiler, *flags, "-c", "-o", obj, str(SRC_DIR / src)]
                for src, obj in zip(sources, objs)]))
        so = str(Path(tmp) / lib.name)
        logs.append(_run([compiler, "-shared", *link_flags, "-o", so,
                          *objs]))
        lib.with_suffix(".log").write_text("".join(logs))
        os.replace(so, lib)
    return lib


def build(flags: tuple[str, ...] = NVCC_FLAGS) -> Path:
    """Compile the kernel library with ``flags`` unless this source hash is
    already built (the ``.log`` beside it holds ptxas's register, stack and
    shared-memory report).  Returns the library path."""
    return _compile(nvcc_path(), flags, SOURCES, library_path(flags))


@functools.lru_cache(maxsize=None)
def load_host() -> ctypes.CDLL:
    """Build if needed and load the host library (the treelet optimiser and
    the EPO walk)."""
    lib = ctypes.CDLL(str(_compile(gxx_path(), HOST_FLAGS, HOST_SOURCES,
                                   host_library_path(),
                                   link_flags=("-pthread",))))
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.mcpt_treelet_optimize.argtypes = [i32] + [ptr] * 5
    lib.mcpt_treelet_optimize.restype = None
    lib.mcpt_epo.argtypes = [ptr, i32] + [ptr] * 4 + [f64, f64, i32]
    lib.mcpt_epo.restype = f64
    return lib


@functools.lru_cache(maxsize=None)
def load(flags: tuple[str, ...] = NVCC_FLAGS) -> ctypes.CDLL:
    """Build if needed and load the library, with every function's argument
    and return types declared (pointers and the stream as ``c_void_p``).
    The kernels use the default flags; others are for A/B measurements
    (``chip_smoke.py --fmad-ab``)."""
    lib = ctypes.CDLL(str(build(flags)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mcpt_render_mega.argtypes = (
        [ptr] * 6 + [i32] * 9 + [ptr] * 4 + [ptr])
    lib.mcpt_render_mega.restype = i32
    f32 = ctypes.c_float
    lib.mcpt_fused_bounce.argtypes = (
        [ptr] * 5 + [i32] * 4 + [f32] * 4 + [ctypes.c_uint32] + [i32] * 6
        + [ptr] * 3 + [i32] + [ptr, ptr])
    lib.mcpt_fused_bounce.restype = i32
    lib.mcpt_render_cluster.argtypes = (
        [ptr] * 5 + [i32] * 3 + [ptr] * 2 + [i32] * 5 + [ptr] + [i32]
        + [ptr] * 5 + [ptr])
    lib.mcpt_render_cluster.restype = i32
    lib.mcpt_traverse.argtypes = (
        [ptr] * 3 + [i32] * 3 + [ptr] * 4 + [f32] + [i32] + [ptr] * 4
        + [i32] + [ptr, ptr])
    lib.mcpt_traverse.restype = i32
    # resident blocks an SM at the launch's block size and shared memory
    lib.mcpt_fused_bounce_blocks_per_sm.argtypes = [i32]
    lib.mcpt_render_cluster_blocks_per_sm.argtypes = [i32] * 3
    lib.mcpt_traverse_blocks_per_sm.argtypes = [i32] * 2
    for fn in (lib.mcpt_fused_bounce_blocks_per_sm,
               lib.mcpt_render_cluster_blocks_per_sm,
               lib.mcpt_traverse_blocks_per_sm):
        fn.restype = i32
    lib.mcpt_fma_chain.argtypes = [ptr, ptr, i32, i32, ptr]
    lib.mcpt_fma_chain.restype = i32
    lib.mcpt_tables_in_smem.argtypes = [i32] * 4
    lib.mcpt_tables_in_smem.restype = i32
    lib.mcpt_error_string.argtypes = [i32]
    lib.mcpt_error_string.restype = ctypes.c_char_p
    return lib
