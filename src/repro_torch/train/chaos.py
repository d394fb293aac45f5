"""Deterministic fault injection for the trainer (port of
``repro/train/chaos.py``).

A seeded ``ChaosSchedule`` injects planned faults at planned steps, so
every recovery path of the driver runs on demand.  Recovery is proven by
parity: a run hit by faults ends bit for bit equal to the fault-free run
(``tests/test_torch_substrate.py``, ``chip_smoke.py`` phase 21).

Spec grammar (``launch/train.py --chaos-spec``), events ``;``-separated::

    nan@S          poison the grads with NaN at step S (the step's poison
    nan@S+K        argument; the non-finite guard skips the update); +K
                   poisons K steps in a row (a burst that trips
                   FaultPolicy's rollback)
    preempt@S      raise ChaosPreemption after step S (process death)
    corrupt@S:M    corrupt the newest published checkpoint after step S.
                   Modes M: bitflip (default; one seeded byte of
                   arrays.npz), truncate (arrays.npz cut in half),
                   delmeta (meta.json deleted), orphan (a partial tmp.*
                   staging dir, as a crashed save leaves)
    slow@S:SEC     sleep SEC seconds before step S (a straggler)

Every event fires once per process, so the steps that a rollback or a
restart replays run clean.  Byte offsets and orphan nonces come from the
schedule's seeded numpy generator, drawn as the reference draws them, so
the same seed corrupts the same byte in either package.

``slow@`` is flagged by the port's driver: its step clock starts before
``pre_step`` sleeps, as ``docs/fault.md`` says it must be.  The
reference's driver starts its clock after the sleep and never flags it.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import time
from typing import Any, List, Optional, Tuple

import numpy as np

log = logging.getLogger("repro_torch.chaos")

__all__ = ["ChaosEvent", "ChaosSchedule", "ChaosPreemption",
           "CORRUPTION_MODES", "corrupt_checkpoint"]

CORRUPTION_MODES = ("bitflip", "truncate", "delmeta", "orphan")

_EVENT_RE = re.compile(
    r"^(?P<kind>nan|preempt|corrupt|slow)@(?P<step>\d+)"
    r"(?:\+(?P<count>\d+))?(?::(?P<arg>[^;]+))?$")


class ChaosPreemption(RuntimeError):
    """Injected preemption: the training loop dies here, and
    ``run_with_recovery`` (or a relaunch that resumes from the checkpoint
    dir) must bring it back."""


@dataclasses.dataclass
class ChaosEvent:
    """One planned fault: ``kind`` at ``step`` with an optional ``arg``
    (corruption mode or seconds); ``fired`` once it has."""

    kind: str
    step: int
    arg: Optional[str] = None
    fired: bool = False


def _flip_byte(path: str, rng: np.random.Generator) -> int:
    """XOR one drawn byte of ``path`` with 0xFF; returns its offset."""
    size = os.path.getsize(path)
    off = int(rng.integers(0, size))
    with open(path, "r+b") as f:
        f.seek(off)
        byte = f.read(1)[0]
        f.seek(off)
        f.write(bytes([byte ^ 0xFF]))
    return off


def corrupt_checkpoint(ckpt_dir: str, mode: str,
                       rng: Optional[np.random.Generator] = None,
                       step: Optional[int] = None) -> Optional[int]:
    """Corrupt the newest published checkpoint in ``ckpt_dir`` (or
    ``step``) as storage faults do; returns the step, or None when there
    is none.  ``bitflip`` XORs one drawn byte of ``arrays.npz``,
    ``truncate`` cuts it to half its size, ``delmeta`` deletes
    ``meta.json``, ``orphan`` plants a partial ``tmp.<step>.<nonce>``
    staging dir (which must be swept, never published)."""
    if mode not in CORRUPTION_MODES:
        raise ValueError(f"unknown corruption mode {mode!r}; "
                         f"expected one of {CORRUPTION_MODES}")
    from repro_torch.train.checkpoint import list_checkpoints
    steps = list_checkpoints(ckpt_dir)
    if step is None:
        step = steps[-1] if steps else None
    if step is None:
        log.warning("chaos corrupt(%s): no published checkpoint in %s",
                    mode, ckpt_dir)
        return None
    rng = rng or np.random.default_rng(0)
    d = os.path.join(ckpt_dir, f"step_{step}")
    if mode == "bitflip":
        off = _flip_byte(os.path.join(d, "arrays.npz"), rng)
        log.warning("chaos: flipped byte %d of step %d arrays.npz",
                    off, step)
    elif mode == "truncate":
        path = os.path.join(d, "arrays.npz")
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size // 2)
        log.warning("chaos: truncated step %d arrays.npz %d -> %d bytes",
                    step, size, size // 2)
    elif mode == "delmeta":
        os.remove(os.path.join(d, "meta.json"))
        log.warning("chaos: deleted step %d meta.json", step)
    else:
        nonce = "".join(rng.choice(list("0123456789abcdef"), 8))
        tmp = os.path.join(ckpt_dir, f"tmp.{step}.{nonce}")
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            f.write(b"partial write, crashed mid-save")
        log.warning("chaos: planted orphan staging dir %s",
                    os.path.basename(tmp))
    return step


class ChaosSchedule:
    """A seeded plan of faults, driven by the training loop through three
    hooks, in loop order (``launch/train.py``):

    * ``pre_step(step)``: sleeps a pending ``slow`` event's seconds and
      returns them;
    * ``poison(step)``: 1.0 when a ``nan`` event covers the step (consumed),
      else 0.0, the step's poison argument;
    * ``post_step(step, ckpt_dir, event_log=None)``: after the step's save,
      pending ``corrupt`` events, then a pending ``preempt`` (so one step
      can stage "preempted and the newest checkpoint is bad").
    """

    def __init__(self, events: List[ChaosEvent], seed: int = 0):
        self.events = list(events)
        self.seed = seed
        self.rng = np.random.default_rng(seed)

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "ChaosSchedule":
        """Parse the ``--chaos-spec`` grammar (module docstring); raises
        ``ValueError`` on a malformed spec."""
        events: List[ChaosEvent] = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            m = _EVENT_RE.match(part)
            if not m:
                raise ValueError(
                    f"bad chaos event {part!r}; expected "
                    "kind@step[+count][:arg] with kind in "
                    "nan|preempt|corrupt|slow")
            kind = m.group("kind")
            step = int(m.group("step"))
            count = int(m.group("count") or 1)
            arg = m.group("arg")
            if count > 1 and kind != "nan":
                raise ValueError(f"{part!r}: only nan events take a "
                                 "+count burst length")
            if kind == "corrupt":
                arg = arg or "bitflip"
                if arg not in CORRUPTION_MODES:
                    raise ValueError(f"{part!r}: corruption mode must be "
                                     f"one of {CORRUPTION_MODES}")
            if kind == "slow":
                arg = arg or "0.05"
                float(arg)            # validates
            if kind == "preempt" and arg is not None:
                raise ValueError(f"{part!r}: {kind} takes no argument")
            for i in range(count):
                events.append(ChaosEvent(kind=kind, step=step + i, arg=arg))
        events.sort(key=lambda e: e.step)
        return cls(events, seed=seed)

    def _pending(self, kind: str, step: int) -> List[ChaosEvent]:
        return [e for e in self.events
                if e.kind == kind and e.step == step and not e.fired]

    def poison(self, step: int) -> float:
        """1.0 when an unfired ``nan`` event covers ``step`` (now fired),
        else 0.0."""
        out = 0.0
        for e in self._pending("nan", step):
            e.fired = True
            out = 1.0
            log.warning("chaos: poisoning gradients at step %d", step)
        return out

    def pre_step(self, step: int) -> float:
        """Sleep and return the pending ``slow`` seconds of ``step``."""
        delay = 0.0
        for e in self._pending("slow", step):
            e.fired = True
            delay += float(e.arg)
        if delay > 0:
            log.warning("chaos: straggling step %d by %.3fs", step, delay)
            time.sleep(delay)
        return delay

    def post_step(self, step: int, ckpt_dir: Optional[str],
                  event_log: Any = None) -> None:
        """Fire the pending ``corrupt`` events of ``step``, then a pending
        ``preempt``."""
        for e in self._pending("corrupt", step):
            e.fired = True
            if not ckpt_dir:
                log.warning("chaos: corrupt event at step %d has no "
                            "ckpt dir; skipped", step)
                continue
            victim = corrupt_checkpoint(ckpt_dir, e.arg, rng=self.rng)
            if event_log is not None:
                event_log.emit("chaos_corrupt", step=step, cause=e.arg,
                               victim_step=victim)
        for e in self._pending("preempt", step):
            e.fired = True
            if event_log is not None:
                event_log.emit("chaos_preempt", step=step)
            raise ChaosPreemption(f"injected preemption after step {step}")

    def remaining(self) -> Tuple[ChaosEvent, ...]:
        """Events not fired yet (a finished run should have none)."""
        return tuple(e for e in self.events if not e.fired)
