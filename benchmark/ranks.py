#!/usr/bin/env python3
"""A cell on several cards: one rank a card, as ``torchrun`` would start
``render_cli`` over a config's ``mesh``.

The process the driver starts is rank 0.  It opens a ``TCPStore`` on a
free port of 127.0.0.1 and starts ranks 1..N−1 as this script, each with
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``: the store's
address; ``OMP_NUM_THREADS=1``, as torchrun sets it for several ranks a
host) and the cell, the seeds and the seconds:

    python3 benchmark/ranks.py --root ROOT --workload NAME --seeds A [B …] \
        --seconds S --device cuda --parent PID

While they import, rank 0 loads the program's CUDA library (a fresh
checkout builds ``build/mcpt_torch/`` there, once) and then sets a store
key; the other ranks wait for it before they load anything of their own.
Every rank joins the default group over that store, with a timeout, so a
rank that dies ends the run instead of hanging it; then the program's
``dist.init_world`` gives it its card and backend (``nccl``, a card a
rank) and ``dist.make_mesh`` the configuration's ``mesh``.  Every rank
builds, warms up and runs the harness's window; only rank 0's clock ends a
window, and the others learn of it through one store key a step (the
harness's ``step.agree``: no device collective, no copy).  Ranks 1..N−1
print nothing on standard output.  After the last window each posts its
memory peak and exits; rank 0 judges once they have.

The ranks die with rank 0 (``PR_SET_PDEATHSIG``), and rank 0 ends the run
with no result as soon as one of them exits early or with an error.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import traceback
from datetime import timedelta
from pathlib import Path

GROUP_TIMEOUT_S = 60  # the default group, the store and each rank's exit
LIB_TIMEOUT_S = 1200  # a fresh checkout's build of the library on rank 0
LIB_KEY = "bench/library"
HOST = "127.0.0.1"
RANK_FAILED = 5  # rank 0's exit code when another rank failed


def _join(store, rank: int, size: int, device_type: str, cfg: dict):
    """Join the default group over ``store`` → (backend, device, mesh)."""
    import torch
    import torch.distributed as td

    from mcpt_torch import dist

    td.init_process_group(
        dist.backend_for(torch.device(device_type), size),
        store=td.PrefixStore("pg", store), rank=rank, world_size=size,
        timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    backend, device = dist.init_world(device_type)
    shape = cfg.get("mesh", {})
    mesh = dist.make_mesh(samples=int(shape.get("samples", 1)),
                          pixels=int(shape.get("pixels", 0)) or None)
    return backend, device, mesh


def _environ(rank: int, size: int, port: int) -> dict:
    return dict(RANK=str(rank), WORLD_SIZE=str(size), LOCAL_RANK=str(rank),
                LOCAL_WORLD_SIZE=str(size), MASTER_ADDR=HOST,
                MASTER_PORT=str(port), OMP_NUM_THREADS="1")


class World:
    """This rank's place in the run: the store, its card, the mesh, and on
    rank 0 the processes of the other ranks."""

    def __init__(self, rank, size, store, device_type, cfg, procs=()):
        self.rank, self.size, self.store = rank, size, store
        self.procs = list(procs)
        self._steps = 0
        self._released = threading.Event()
        self._done = threading.Event()
        try:
            if rank == 0:
                threading.Thread(target=self._watch, daemon=True).start()
                if device_type == "cuda":
                    from mcpt_torch.kernels import _build

                    _build.load()  # built here, once, before any other rank
                store.set(LIB_KEY, "1")
            else:
                store.wait([LIB_KEY], timedelta(seconds=LIB_TIMEOUT_S))
            self.backend, self.device, self.mesh = _join(store, rank, size,
                                                         device_type, cfg)
        except BaseException:
            self._done.set()
            raise

    def agree(self, stop: bool) -> bool:
        """Rank 0's decision to end the window after this step, on every
        rank."""
        key = f"bench/stop/{self._steps}"
        self._steps += 1
        if self.rank == 0:
            self.store.set(key, "1" if stop else "0")
            return stop
        return self.store.get(key) == b"1"

    def post_peak(self, peak: int) -> None:
        """Ranks 1..N−1, after the last window: post this rank's memory
        peak, and wait until rank 0 has read every rank's."""
        self.store.set(f"bench/peak/{self.rank}", str(int(peak)))
        self.store.wait(["bench/release"])

    def finish(self) -> list:
        """Rank 0, after its last window: the other ranks' memory peaks,
        once each has exited; this rank leaves the group."""
        peaks = [int(self.store.get(f"bench/peak/{r}"))
                 for r in range(1, self.size)]
        self._released.set()
        self.store.set("bench/release", "1")
        self._leave()
        for r, p in enumerate(self.procs, 1):
            rc = p.wait(timeout=GROUP_TIMEOUT_S)
            if rc != 0:
                raise RuntimeError(f"rank {r} exited with code {rc}")
        self._done.set()
        return peaks

    def describe(self) -> str:
        return (f"{self.size} ranks, mesh {self.mesh.shape}, backend "
                f"{self.backend}")

    def close(self) -> None:
        """End whatever is left: the group, and any other rank still
        running (an error on rank 0)."""
        self._released.set()
        self._done.set()
        self._leave()
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()

    def _leave(self) -> None:
        import torch.distributed as td

        if td.is_initialized():
            td.destroy_process_group()

    def _watch(self) -> None:
        """Rank 0: end the run once another rank fails, wherever rank 0
        waits (a collective on the card cannot be interrupted)."""
        while not self._done.wait(0.2):
            for r, p in enumerate(self.procs, 1):
                rc = p.poll()
                if rc is None or (rc == 0 and self._released.is_set()):
                    continue
                print(f"rank {r} exited with code {rc} during the run",
                      file=sys.stderr, flush=True)
                for q in self.procs:
                    if q.poll() is None:
                        q.kill()
                    q.wait()
                os._exit(RANK_FAILED)


def start(cell, seeds, seconds: float, device_type: str,
          root: Path) -> World:
    """Rank 0: start ranks 1..N−1 of ``cell``, load the library while they
    import, and join them."""
    import torch
    import torch.distributed as td

    torch.set_num_threads(1)  # OMP_NUM_THREADS=1, as on the other ranks
    size = int(cell.chips)
    store = td.TCPStore(HOST, 0, size, True,
                        timedelta(seconds=GROUP_TIMEOUT_S),
                        wait_for_workers=False)
    argv = ["--root", str(root), "--workload", cell.name, "--seconds",
            repr(float(seconds)), "--device", device_type, "--parent",
            str(os.getpid()), "--seeds", *map(str, seeds)]
    procs = []
    try:
        for r in range(1, size):
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), *argv],
                env={**os.environ, **_environ(r, size, store.port)},
                stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL))
        os.environ.update(_environ(0, size, store.port))
        return World(0, size, store, device_type, cell.cfg, procs)
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise


def serve(args) -> int:
    """Ranks 1..N−1: the same set-up and windows as rank 0, no result."""
    import torch
    import torch.distributed as td

    from benchmark import harness

    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    store = td.TCPStore(os.environ["MASTER_ADDR"],
                        int(os.environ["MASTER_PORT"]), size, False,
                        timedelta(seconds=GROUP_TIMEOUT_S))
    cell = harness.load_cell(args.workload, Path(args.root))
    world = World(rank, size, store, args.device, cell.cfg)
    try:
        prog = harness.build(cell, world.device, mesh=world.mesh)
        harness.warm_up(cell, prog, args.seeds[0], world.device)
        for seed in args.seeds:
            harness.window(cell, prog, seed, args.seconds, False,
                           world.device, agree=world.agree)
        world.post_peak(torch.cuda.max_memory_allocated(world.device)
                        if world.device.type == "cuda" else 0)
    finally:
        world.close()
    return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="One rank 1..N-1 of a cell.")
    ap.add_argument("--root", required=True)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--parent", type=int, required=True)
    args = ap.parse_args(argv)
    import ctypes

    # die with rank 0, also where it died before this line
    ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    if os.getppid() != args.parent:
        return 1
    try:
        return serve(args)
    except Exception:
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    # the checkout's root, not this directory, heads the module path
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    sys.exit(main())
