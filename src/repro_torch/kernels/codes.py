"""Record and replay the int8 codes of the quantized run chains.

Two runs of the quantized model on different devices (the card's kernels,
the CPU's plain versions) compute the same f32 function with roundings in
other orders.  Where an f32 difference moves a value across a code
boundary the two sides' codes differ by one, and that code moves every
later value by a step of its block, so through many layers the two sides
part at quantization noise, not f32 noise.

A ``CodeTape`` in recording mode keeps, for every int8-activation run
chain (``ops.forward_runs`` called with a ``(q, scales)`` pair), its entry
codes and scales and its output codes and scales, in call order, on the
CPU.  A tape given another tape's recording replays it instead: each chain
runs from the recorded entry and hands the recorded output on, so the two
sides compute every layer from the same codes and differ by f32 noise
alone.  Per chain it notes how many entry codes its own side made
otherwise (and by how much), and whether its own output from the recorded
entry equals the recorded one bit for bit.

    with CodeTape() as card:
        run(params_on_card)
    with CodeTape(replay=card) as cpu:
        run(params_on_cpu)
    cpu.summary()
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops

__all__ = ["CodeTape"]


class CodeTape:
    """See the module docstring.  Not reentrant; one tape at a time."""

    def __init__(self, replay: Optional["CodeTape"] = None):
        self.replay = replay
        self.calls = []      # (entry q, entry scales, out q, out scales)
        self.stats = []      # one dict a replayed chain

    def __enter__(self):
        self._real = ops.forward_runs
        ops.forward_runs = self._hook
        return self

    def __exit__(self, *exc):
        ops.forward_runs = self._real

    def _hook(self, z, *args, **kw):
        if not isinstance(z, tuple):
            return self._real(z, *args, **kw)
        if self.replay is None:
            y, saved = self._real(z, *args, **kw)
            self.calls.append(tuple(t.detach().cpu() for t in (*z, *y)))
            return y, saved
        i = len(self.stats)
        if i >= len(self.replay.calls):
            raise ValueError(f"chain {i} is past the recording's "
                             f"{len(self.replay.calls)}")
        rq, rs, oq, os_ = self.replay.calls[i]
        if rq.shape != z[0].shape or rs.shape != z[1].shape:
            raise ValueError(f"chain {i}: entry {tuple(z[0].shape)} against "
                             f"the recorded {tuple(rq.shape)}")
        dev = z[0].device
        y, saved = self._real((rq.to(dev), rs.to(dev)), *args, **kw)
        own = z[0].detach().cpu().int() - rq.int()
        yq, ys = y[0].detach().cpu(), y[1].detach().cpu()
        self.stats.append(dict(
            codes=rq.numel(), entry_flips=int((own != 0).sum()),
            entry_max_diff=int(own.abs().max()) if own.numel() else 0,
            out_equal=bool(yq.shape == oq.shape and torch.equal(yq, oq)
                           and torch.equal(ys, os_))))
        return (oq.to(dev), os_.to(dev)), saved

    def summary(self) -> dict:
        """Totals over the replayed chains: ``chains`` (and the
        recording's ``recorded``), entry ``codes``, ``entry_flips`` and the
        largest ``entry_max_diff``, and ``out_differ``, the chains whose
        output from the recorded entry was not the recorded one."""
        s = self.stats
        return dict(chains=len(s), recorded=len(self.replay.calls)
                    if self.replay is not None else len(self.calls),
                    codes=sum(c["codes"] for c in s),
                    entry_flips=sum(c["entry_flips"] for c in s),
                    entry_max_diff=max((c["entry_max_diff"] for c in s),
                                       default=0),
                    out_differ=sum(not c["out_equal"] for c in s))
