"""What a continuous-serving run is scheduled and measured by: seeded
Poisson arrival ticks, nearest-rank tick percentiles, and a recorder of the
decode tick's aten operations (one sequence across churn: the tick is ready
for capture).  Shared by ``benchmarks/torch_serve_bench.py``,
``chip_smoke.py`` and the tests."""

from __future__ import annotations

import numpy as np
import torch


def poisson_arrivals(n: int, rate: float, seed: int) -> list:
    """Arrival tick per request: cumulative exponential gaps at ``rate``
    requests a tick from numpy's seeded generator (the reference's)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(scale=1.0 / rate, size=n)
    return [int(t) for t in np.floor(np.cumsum(gaps))]


def percentile_ticks(lat: list, q: float) -> int:
    """Nearest-rank percentile over integer tick latencies."""
    s = sorted(lat)
    idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return int(s[idx])


def _signature(args) -> tuple:
    """Tensors as (shape, dtype), sequences flattened, other arguments as
    themselves."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append((a.shape, a.dtype))
        elif isinstance(a, (list, tuple)):
            out.append(_signature(a))
        else:
            out.append(a)
    return tuple(out)


class TickRecorder:
    """Records every aten call of the engine's decode tick, one list a
    tick, as ``(op, argument signature)``, through a ``TorchDispatchMode``
    (``wrap`` the engine's ``_tick``)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        ticks = self.ticks = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                ticks[-1].append((func, _signature(args),
                                  _signature(kwargs.items())))
                return func(*args, **kwargs)

        self._mode = Mode

    def wrap(self, tick):
        def recorded():
            self.ticks.append([])
            with self._mode():
                return tick()
        return recorded

    def sequences(self) -> int:
        """Distinct operation sequences recorded."""
        return len({tuple(t) for t in self.ticks})
