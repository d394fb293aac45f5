"""Serving: the fixed-batch engine and continuous batching."""

from repro_torch.serve.engine import (ContinuousBatchingEngine,  # noqa: F401
                                      Request, ServeEngine, serve_step)
