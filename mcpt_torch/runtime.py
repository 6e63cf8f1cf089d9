"""Runtime utilities: per-stage timing, throughput, device info.

The port's counterpart of ``mcpt/runtime.py``.  The XLA compile cache and the
TPU's VPU-peak probe have no use here; an FP32 peak probe for the H100 comes
with the benchmark (ROADMAP Slice 5).
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from collections import defaultdict

import torch


def device_info(device="cuda") -> str:
    """One line per fact: the torch device, and for CUDA the card's name and
    power limit as ``nvidia-smi`` reports them (a card set below its maximum
    power runs slower, so every timing is read beside this line)."""
    device = torch.device(device)
    if device.type != "cuda":
        return f"device: {device} (torch {torch.__version__})"
    lines = [f"device: {torch.cuda.get_device_name(device)} "
             f"(torch {torch.__version__}, CUDA {torch.version.cuda})"]
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        lines.append(f"nvidia-smi: {smi.stdout.strip()}")
    except (OSError, subprocess.SubprocessError) as e:
        lines.append(f"nvidia-smi: unavailable ({e})")
    return "\n".join(lines)


class StageTimer:
    """Accumulating per-stage wall timer.  ``sync`` waits for the device
    (CUDA work is asynchronous), so a stage's time includes its kernels.

        timer = StageTimer()
        with timer.stage("render_step"):
            out = f(x)
            timer.sync(out)
        print(timer.report())
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    @staticmethod
    def sync(*tensors) -> None:
        """Wait until the devices of ``tensors`` have finished their work."""
        for dev in {t.device for t in tensors if isinstance(t, torch.Tensor)}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def report(self) -> str:
        width = max((len(k) for k in self.totals), default=0)
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name:<{width}}  {total*1e3:9.2f} ms total  "
                f"{total/n*1e3:9.2f} ms/call  ×{n}"
            )
        return "\n".join(lines)


def mrays(segments: float, seconds: float) -> float:
    return segments / max(seconds, 1e-12) / 1e6
