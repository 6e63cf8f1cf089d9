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

It is also the one seam between the kernels' Python side and the library:
``use_kernel`` is every dispatcher's device rule, ``plain_versions`` runs
the plain versions on CUDA tensors, ``check_cuda`` is the wrappers' common
tensor check, and ``launch`` calls a kernel's C entry point on the current
stream, raises on its error code and counts it in ``LAUNCHES``.  The walking
kernels' stack-overflow flags go through it too: ``overflow_flag`` hands a
launch its flag and ``check_overflow`` reads it back at once, or, inside an
``overflow_checked_once`` block, leaves it to the one read at the block's
end.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from mcpt_torch.trace import count, span

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "mcpt_torch"
SOURCES = ("megakernel.cu", "fused_bounce.cu", "cluster_mega.cu",
           "traverse.cu", "fma_peak.cu", "threefry.cu", "hybrid_stage.cu")
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
        + [ptr] * 3 + [i32] + [ptr] * 3)
    lib.mcpt_fused_bounce.restype = i32
    lib.mcpt_render_cluster.argtypes = (
        [ptr] * 5 + [i32] * 3 + [ptr] * 2 + [i32] * 5 + [ptr] + [i32]
        + [ptr] * 5 + [ptr])
    lib.mcpt_render_cluster.restype = i32
    lib.mcpt_traverse.argtypes = (
        [ptr] * 4 + [i32] * 3 + [ptr] * 4 + [f32] + [i32] + [ptr] * 5
        + [i32] + [ptr, ptr])
    lib.mcpt_traverse.restype = i32
    # resident blocks an SM at the launch's block size and shared memory
    lib.mcpt_render_mega_blocks_per_sm.argtypes = [i32] * 6
    lib.mcpt_render_mega_block_threads.argtypes = []
    lib.mcpt_fused_bounce_blocks_per_sm.argtypes = [i32]
    lib.mcpt_render_cluster_blocks_per_sm.argtypes = [i32] * 3
    lib.mcpt_traverse_blocks_per_sm.argtypes = [i32] * 2
    for fn in (lib.mcpt_render_mega_blocks_per_sm,
               lib.mcpt_render_mega_block_threads,
               lib.mcpt_fused_bounce_blocks_per_sm,
               lib.mcpt_render_cluster_blocks_per_sm,
               lib.mcpt_traverse_blocks_per_sm):
        fn.restype = i32
    lib.mcpt_fma_chain.argtypes = [ptr, ptr, i32, i32, ptr]
    lib.mcpt_fma_chain.restype = i32
    lib.mcpt_threefry.argtypes = [ctypes.c_uint32, ctypes.c_uint32,
                                  ctypes.c_uint64, i32, ptr, ptr]
    lib.mcpt_threefry.restype = i32
    u32 = ctypes.c_uint32
    lib.mcpt_hybrid_roulette.argtypes = [ptr, ptr, i32, f32, u32, u32, ptr,
                                         ptr]
    lib.mcpt_hybrid_sort_key.argtypes = ([ptr] * 7 + [i32] + [f32] * 6
                                         + [i32] * 2 + [ptr, ptr])
    lib.mcpt_hybrid_reorder.argtypes = [ptr] * 3 + [i32] * 2 + [ptr] * 6
    lib.mcpt_hybrid_raygen.argtypes = ([ptr] * 2 + [i32] * 5
                                       + [u32, ctypes.c_longlong, i32]
                                       + [ptr] * 3)
    for fn in (lib.mcpt_hybrid_roulette, lib.mcpt_hybrid_sort_key,
               lib.mcpt_hybrid_reorder, lib.mcpt_hybrid_raygen):
        fn.restype = i32
    lib.mcpt_error_string.argtypes = [i32]
    lib.mcpt_error_string.restype = ctypes.c_char_p
    return lib


# successful calls of each kernel entry point, by C symbol (never a plain
# version's call): how the tests and chip_smoke.py show that a path ran the
# kernels
LAUNCHES: collections.Counter = collections.Counter()
# inside plain_versions(): CUDA tensors take the plain versions
_PLAIN = False


def use_kernel(name: str, where) -> bool:
    """The device rule of every dispatcher ``name``, for ``where`` (a tensor
    or a device): False (the plain version) on the CPU, True (the kernel) on
    CUDA, False on CUDA inside ``plain_versions()``; any other device
    raises.  Nothing falls back."""
    kind = (where.device if isinstance(where, torch.Tensor)
            else torch.device(where)).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {kind}")
    return kind == "cuda" and not _PLAIN


@contextlib.contextmanager
def plain_versions():
    """Inside this block every dispatcher runs its plain version on CUDA
    tensors too: how a whole render is held against its plain version on
    the card (``cluster_megakernel.render_hybrid_reference``)."""
    global _PLAIN
    saved, _PLAIN = _PLAIN, True
    try:
        yield
    finally:
        _PLAIN = saved


def check_cuda(name: str, t: torch.Tensor, dtype=torch.float32) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(symbol: str, device, *args, lib: ctypes.CDLL | None = None):
    """Call the library's ``symbol`` (from ``lib``, default ``load()``)
    with ``args`` and the current stream of ``device``, on that device
    (the C side launches on the calling thread's current device); raise on
    a nonzero return and count the call in ``LAUNCHES``.  It neither
    synchronises nor reads anything back."""
    if lib is None:
        lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, symbol)(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc} "
                           f"({lib.mcpt_error_string(rc).decode()})")
    LAUNCHES[symbol] += 1


# the kernels whose stack-overflow flag a block may defer, by C symbol: the
# wait span each flag is read under and the message a set flag raises
OVERFLOW_READS = {
    "mcpt_fused_bounce": ("mcpt.wait.k2_flag",
                          "fused bounce: traversal stack overflow (> {cap} "
                          "entries); collapse_wide should have rejected "
                          "this tree"),
    "mcpt_traverse": ("mcpt.wait.k4_flag",
                      "traverse: stack overflow (> {cap} entries); "
                      "collapse_wide should have rejected this tree"),
}
# inside overflow_checked_once(): {(device, symbol): [flag, stack entries,
# launches]}, the one device int every launch of that kernel there sets on a
# stack overflow
_DEFERRED: dict | None = None


@contextlib.contextmanager
def overflow_checked_once():
    """Inside this block the launches of a kernel on a device set one shared
    stack-overflow flag instead of each reading its own back, and the
    block's end reads each flag once, under its kernel's wait span, and
    raises on an overflow: the host never waits on a launch in between, so
    it queues the work around the launches while they run.  Each read
    records ``trace.count("flags_deferred", n)``, the n launches it covers.
    The hybrid's step (``cluster_megakernel._run_hybrid``: 8 reads become
    one) and the wavefront's bounce loops (16) run in it.  Outside it every
    launch reads its flag back and raises at once.  A nested block leaves
    the reading to the outer one; an error in the body leaves the flags
    unread."""
    global _DEFERRED
    if _DEFERRED is not None:
        yield
        return
    _DEFERRED = {}
    try:
        yield
        flags = _DEFERRED
    finally:
        _DEFERRED = None
    for (_, symbol), (flag, cap, launches) in flags.items():
        count("flags_deferred", launches)
        _read_overflow(symbol, flag, cap)


def overflow_flag(symbol: str, device, cap: int) -> torch.Tensor:
    """The device int a launch of ``symbol`` on ``device`` (``cap`` stack
    entries a thread) sets on a stack overflow: the open
    ``overflow_checked_once`` block's for (device, symbol), counted as one
    more launch it covers, else a fresh one."""
    if _DEFERRED is None:
        return torch.zeros(1, dtype=torch.int32, device=device)
    key = (torch.device(device), symbol)
    if key not in _DEFERRED:
        _DEFERRED[key] = [torch.zeros(1, dtype=torch.int32, device=device),
                          cap, 0]
    _DEFERRED[key][2] += 1
    return _DEFERRED[key][0]


def check_overflow(symbol: str, flag: torch.Tensor, cap: int) -> None:
    """After a launch of ``symbol`` with ``overflow_flag``'s ``flag``:
    outside a block read it back now (the call synchronises) and raise on
    an overflow; inside one leave it to the block's end."""
    if _DEFERRED is None:
        _read_overflow(symbol, flag, cap)


def _read_overflow(symbol: str, flag: torch.Tensor, cap: int) -> None:
    wait, message = OVERFLOW_READS[symbol]
    with span(wait):
        overflow = int(flag.item())
    if overflow != 0:
        raise RuntimeError(message.format(cap=cap))
