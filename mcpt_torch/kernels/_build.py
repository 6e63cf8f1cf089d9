"""Build the CUDA sources under ``mcpt_torch/csrc/`` with ``nvcc`` and load
them with ``ctypes``.

The library is compiled at first use into ``build/mcpt_torch/`` at the root
of the checkout, named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads at once.  The sources have a plain
C interface and include no PyTorch header: a build takes seconds.  ``nvcc``
comes from ``$CUDA_HOME/bin``, ``PATH`` or ``/usr/local/cuda/bin``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "mcpt_torch"
SOURCES = ("megakernel.cu",)
# -fmad=false: no contracted multiply-adds, so the kernels round as the plain
# PyTorch versions do (see csrc/bounce_core.cuh); no fast math either
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


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


def source_hash(flags: tuple[str, ...] = NVCC_FLAGS) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sorted(SRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(flags: tuple[str, ...] = NVCC_FLAGS) -> Path:
    return BUILD_DIR / f"libmcpt_kernels_{source_hash(flags)}.so"


def build(flags: tuple[str, ...] = NVCC_FLAGS) -> Path:
    """Compile the library with ``flags`` unless this source hash is already
    built; the compiler's register and shared-memory report lands beside it
    as ``.log``.  Returns the library path."""
    lib = library_path(flags)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *flags, "-o", tmp,
           *(str(SRC_DIR / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
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
    lib.mcpt_tables_in_smem.argtypes = [i32] * 4
    lib.mcpt_tables_in_smem.restype = i32
    lib.mcpt_error_string.argtypes = [i32]
    lib.mcpt_error_string.restype = ctypes.c_char_p
    return lib
