"""Fault tolerance around the training step (port of
``repro/train/fault.py``): skip accounting, recovery orchestration, the
fault-event log and the straggler watchdog.

The non-finite guard itself lives in the step (``train/step.py``); this
module is the host-side policy around it:

* ``FaultPolicy.on_metrics`` counts consecutive skipped steps; after
  ``max_consecutive_skips`` in a row the driver rolls back to the newest
  valid checkpoint.
* ``run_with_recovery`` wraps the training loop: on any exception it sleeps
  an exponential backoff and calls the loop again with ``RESUME_LATEST``,
  so the driver restores the newest valid checkpoint and rewinds its loop
  counter and data cursor with it (``launch/train.py``).  Restarts are
  budgeted over a sliding window: a crash loop exhausts the budget and
  re-raises.
* ``FaultEventLog`` is the append-only JSONL record of every skip,
  rollback, restart, quarantine and slow step, with the schema of
  ``docs/fault.md``.
* ``StragglerDetector`` flags a step whose wall time exceeds ``factor``
  times the rolling median for ``patience`` steps in a row.

Fault injection, which exercises all of this on demand, is
``train/chaos.py``.  Nothing here touches a tensor.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable, List, Optional

log = logging.getLogger("repro_torch.fault")

__all__ = ["FaultPolicy", "run_with_recovery", "RESUME_LATEST",
           "FaultEventLog", "StragglerDetector"]

# What run_with_recovery passes to the loop after a failure: restore the
# newest valid checkpoint (``None`` is a cold start, which still resumes
# when the driver finds checkpoints on disk).
RESUME_LATEST = -1


@dataclasses.dataclass
class FaultPolicy:
    """Host-side skip accounting around the step's non-finite guard."""

    max_consecutive_skips: int = 5
    consecutive_skips: int = 0
    total_skips: int = 0

    def on_metrics(self, metrics: dict) -> bool:
        """Feed one step's metrics; True when a rollback is due
        (``max_consecutive_skips`` skipped steps in a row)."""
        if bool(metrics.get("skipped", 0.0)):
            self.consecutive_skips += 1
            self.total_skips += 1
            log.warning("step skipped (non-finite grads), %d consecutive",
                        self.consecutive_skips)
        else:
            self.consecutive_skips = 0
        return self.consecutive_skips >= self.max_consecutive_skips

    def reset(self) -> None:
        """Clear the consecutive count after a rollback or restart; the
        lifetime ``total_skips`` stays."""
        self.consecutive_skips = 0


class FaultEventLog:
    """Append-only JSONL fault-event log.

    ``emit`` appends ``{"t": <wall time>, "kind": ..., "step": ...,
    "cause": ..., **fields}`` to ``path`` (one line, written at once) and
    to ``self.events``.  ``path=None`` keeps the log in memory only.
    Thread-safe."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.events: List[dict] = []
        self._lock = threading.Lock()
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)

    def emit(self, kind: str, step: Optional[int] = None,
             cause: Optional[str] = None, **fields: Any) -> dict:
        """Record one event; returns it."""
        ev = {"t": time.time(), "kind": kind}
        if step is not None:
            ev["step"] = int(step)
        if cause is not None:
            ev["cause"] = cause
        ev.update(fields)
        with self._lock:
            self.events.append(ev)
            if self.path:
                with open(self.path, "a") as f:
                    f.write(json.dumps(ev) + "\n")
        return ev

    def kinds(self) -> List[str]:
        """The kinds of the events so far, in order."""
        return [ev["kind"] for ev in self.events]


class StragglerDetector:
    """Rolling-median slow-step watchdog.

    ``observe(step, dt)`` returns True, and emits a ``slow_step`` event,
    when ``dt`` exceeds ``factor`` times the median of the last ``window``
    step times for ``patience`` steps in a row.  The first ``min_samples``
    observations only fill the window, so a slow first step (kernel builds,
    allocator warm-up) never trips it.
    """

    def __init__(self, factor: float = 1.5, window: int = 50,
                 patience: int = 1, min_samples: int = 5,
                 event_log: Optional[FaultEventLog] = None):
        self.factor = factor
        self.patience = patience
        self.min_samples = min_samples
        self.event_log = event_log
        self._times: deque = deque(maxlen=window)
        self._consecutive = 0

    def observe(self, step: int, dt: float) -> bool:
        """Feed one step's wall seconds; True when the threshold has held
        for ``patience`` steps in a row."""
        times = sorted(self._times)
        median = times[len(times) // 2] if times else None
        self._times.append(dt)
        if median is None or len(times) < self.min_samples:
            return False
        if dt > self.factor * median:
            self._consecutive += 1
            if self._consecutive >= self.patience:
                log.warning("slow step %d: %.3fs > %.1fx median %.3fs",
                            step, dt, self.factor, median)
                if self.event_log is not None:
                    self.event_log.emit("slow_step", step=step,
                                        cause=f"{dt:.4f}s vs median "
                                              f"{median:.4f}s",
                                        dt=dt, median=median)
                return True
        else:
            self._consecutive = 0
        return False


def run_with_recovery(train_loop: Callable[[Optional[int]], Any],
                      max_restarts: int = 3,
                      backoff_base: float = 0.5,
                      backoff_max: float = 30.0,
                      restart_window: float = 600.0,
                      event_log: Optional[FaultEventLog] = None,
                      sleep: Callable[[float], None] = time.sleep) -> Any:
    """Run ``train_loop(resume)`` to completion, restarting on failure.

    The first call passes ``resume=None``; every restart passes
    ``RESUME_LATEST``.  Between restarts it sleeps ``backoff_base *
    2**(attempt-1)`` seconds, at most ``backoff_max``, through ``sleep``.
    More than ``max_restarts`` failures within ``restart_window`` seconds
    re-raise the last exception; ``KeyboardInterrupt`` always propagates.
    Emits ``restart`` and ``restart_budget_exhausted`` events.  The failed
    attempt's frames, and the tensors they held, are released before the
    next attempt starts: the exception is dropped when its handler ends."""
    recent: deque = deque()
    attempt = 0
    resume: Optional[int] = None
    while True:
        try:
            return train_loop(resume)
        except KeyboardInterrupt:
            raise
        except Exception as e:          # noqa: BLE001 — any device fault
            now = time.monotonic()
            recent.append(now)
            while recent and now - recent[0] > restart_window:
                recent.popleft()
            attempt += 1
            if len(recent) > max_restarts:
                log.error("restart budget exhausted: %d failures within "
                          "%.0fs window", len(recent), restart_window)
                if event_log is not None:
                    event_log.emit("restart_budget_exhausted",
                                   cause=repr(e),
                                   failures_in_window=len(recent))
                raise
            backoff = min(backoff_base * (2.0 ** (attempt - 1)),
                          backoff_max)
            log.error("training loop failed (%s); restart %d (%d/%d in "
                      "window) from latest checkpoint after %.2fs backoff",
                      e, attempt, len(recent), max_restarts, backoff)
            if event_log is not None:
                event_log.emit("restart", cause=repr(e), attempt=attempt,
                               backoff_s=backoff)
        if backoff > 0:
            sleep(backoff)
        resume = RESUME_LATEST
