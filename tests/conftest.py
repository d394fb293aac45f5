# NOTE: do NOT set --xla_force_host_platform_device_count here — smoke
# tests and benches must see exactly 1 device; only launch/dryrun.py uses
# 512 placeholder devices.
import itertools
import sys
import types

import numpy as np
import pytest

# ---------------------------------------------------------------------------
# hypothesis fallback shim
# ---------------------------------------------------------------------------
#
# The property-based tests (test_pairings / test_spm_core /
# test_train_substrate) use hypothesis when available; this container does
# not ship it and nothing may be pip-installed.  Degrade gracefully: install
# a minimal stand-in into sys.modules BEFORE test modules import it, turning
# each @given test into a fixed-example sweep over a small deterministic
# cross-product of the declared strategies.  Real hypothesis, when present
# (e.g. the CI with-hypothesis job), takes priority.

try:
    import hypothesis  # noqa: F401
except ImportError:
    _MAX_EXAMPLES = 24

    class _Strategy:
        """A strategy degraded to an explicit example list."""

        def __init__(self, examples):
            self.examples = list(examples)

    def _sampled_from(seq):
        return _Strategy(seq)

    def _integers(min_value=0, max_value=100):
        vals = {min_value, max_value, (min_value + max_value) // 2}
        return _Strategy(sorted(vals))

    def _floats(min_value=0.0, max_value=1.0, **_kw):
        lo, hi = float(min_value), float(max_value)
        return _Strategy([lo, (lo + hi) / 2, hi])

    def _booleans():
        return _Strategy([False, True])

    def _settings(**_kw):  # max_examples / deadline are no-ops here
        def deco(fn):
            return fn
        return deco

    def _given(*s_args, **s_kw):
        if s_args:
            raise TypeError("shim @given supports keyword strategies only")

        def deco(fn):
            names = list(s_kw)
            combos = list(
                itertools.product(*(s_kw[k].examples for k in names)))
            if len(combos) > _MAX_EXAMPLES:
                # evenly-strided subsample: product() varies the FIRST
                # strategy slowest, so a head-truncation would silently
                # drop its trailing values; striding keeps every strategy
                # covered across its range.
                step = len(combos) / _MAX_EXAMPLES
                combos = [combos[int(i * step)]
                          for i in range(_MAX_EXAMPLES)]

            def wrapper(*args, **kwargs):
                for combo in combos:
                    example = dict(zip(names, combo))
                    try:
                        fn(*args, **example, **kwargs)
                    except BaseException:
                        print(f"\n[hypothesis-shim] failing example: "
                              f"{example}")
                        raise
            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            return wrapper
        return deco

    _st = types.ModuleType("hypothesis.strategies")
    _st.sampled_from = _sampled_from
    _st.integers = _integers
    _st.floats = _floats
    _st.booleans = _booleans

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    _hyp.__is_shim__ = True

    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU with compute capability >= 9.0 "
        "(the PyTorch port's CUDA kernels); skips elsewhere")
