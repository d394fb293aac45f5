"""Serving: the fixed-batch greedy/temperature engine."""

from repro_torch.serve.engine import ServeEngine, serve_step  # noqa: F401
