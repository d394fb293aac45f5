"""Shared helpers of the PyTorch port's benchmark runners: the device's
set-up, timing, CSV lines and the JSON record (the port's counterpart of
``benchmarks/common.py``, without JAX)."""

from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path
from typing import Callable, Tuple

import torch

from repro_torch.device import resolve_device

__all__ = ["setup_device", "sync", "time_step", "emit", "write_record"]

ROOT = Path(__file__).resolve().parents[1]


def setup_device(device) -> Tuple[torch.device, dict]:
    """The runner's device (``cuda`` unless the caller asks for the CPU)
    and what it is.  On the card: TF32 off for every f32 product (the dense
    baseline's included), the kernels built and loaded before anything is
    timed, and the card's name and power limit as ``nvidia-smi`` gives
    them."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev, {"device": str(dev)}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    build.load_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return dev, {"device": str(dev), "kind": torch.cuda.get_device_name(0),
                 "gpu": smi, "tf32": False}


def sync() -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_step(fn: Callable, *args, warmup: int = 2, iters: int = 5) -> float:
    """Median wall-clock seconds per call of ``fn(*args)``, the device
    synchronized before and after each call, so a call's time holds all of
    its device work."""
    for _ in range(warmup):
        fn(*args)
    sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def emit(name: str, us_per_call: float, derived: str = "") -> None:
    """One CSV line: ``name,microseconds,derived``."""
    print(f"{name},{us_per_call:.1f},{derived}")


def write_record(name: str, record: dict) -> Path:
    """Write ``record`` as ``out/<name>`` under the repository (git
    ignores ``out/``) and return the path."""
    path = ROOT / "out" / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(record, indent=1))
    return path
