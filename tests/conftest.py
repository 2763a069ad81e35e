"""Test-environment shims.

``hypothesis`` and ``zstandard`` are optional in the container this repo
targets. The seed property-based tests only use a narrow slice of the
hypothesis API, so when the real package is missing we install a minimal
deterministic stand-in (fixed seed, fixed example count) rather than skipping
whole test modules. With the real hypothesis installed, the shim is inert.
"""

from __future__ import annotations

import sys
import types


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (an H100); skips without one")


try:
    import hypothesis  # noqa: F401
except ImportError:
    import numpy as np

    class _Strategy:
        def __init__(self, draw_fn):
            self._draw_fn = draw_fn

        def draw(self, rng):
            return self._draw_fn(rng)

    class _DataObject:
        def __init__(self, rng):
            self._rng = rng

        def draw(self, strategy, label=None):
            return strategy.draw(self._rng)

    class _DataStrategy(_Strategy):
        def __init__(self):
            super().__init__(lambda rng: _DataObject(rng))

    def _integers(min_value, max_value):
        return _Strategy(lambda rng: int(rng.integers(min_value, max_value + 1)))

    def _floats(min_value, max_value):
        return _Strategy(
            lambda rng: float(min_value + (max_value - min_value) * rng.random()))

    def _sampled_from(options):
        opts = list(options)
        return _Strategy(lambda rng: opts[int(rng.integers(0, len(opts)))])

    def _sets(elements, min_size=0, max_size=None):
        cap = min_size + 8 if max_size is None else max_size

        def draw(rng):
            out = set()
            for _ in range(200):
                if len(out) >= min_size and (
                        len(out) >= cap or rng.random() < 0.3):
                    break
                out.add(elements.draw(rng))
            return out

        return _Strategy(draw)

    def _composite(fn):
        def make(*args, **kw):
            def draw_fn(rng):
                return fn(lambda s: s.draw(rng), *args, **kw)
            return _Strategy(draw_fn)
        return make

    _DEFAULT_EXAMPLES = 25

    def _given(*strategies, **kw_strategies):
        def deco(fn):
            # plain zero-arg wrapper: pytest must not see the drawn arguments
            # as fixtures, so the original signature is deliberately hidden
            def wrapper():
                n = getattr(wrapper, "_shim_max_examples", _DEFAULT_EXAMPLES)
                for ex in range(n):
                    rng = np.random.default_rng(ex)
                    drawn = [s.draw(rng) for s in strategies]
                    kw = {k: s.draw(rng) for k, s in kw_strategies.items()}
                    fn(*drawn, **kw)

            wrapper.__name__ = fn.__name__
            wrapper.__module__ = fn.__module__
            wrapper.__doc__ = fn.__doc__
            return wrapper
        return deco

    def _settings(max_examples=_DEFAULT_EXAMPLES, **_ignored):
        def deco(fn):
            fn._shim_max_examples = max_examples
            return fn
        return deco

    mod = types.ModuleType("hypothesis")
    mod.given = _given
    mod.settings = _settings
    st_mod = types.ModuleType("hypothesis.strategies")
    st_mod.integers = _integers
    st_mod.floats = _floats
    st_mod.sampled_from = _sampled_from
    st_mod.sets = _sets
    st_mod.composite = _composite
    st_mod.data = lambda: _DataStrategy()
    mod.strategies = st_mod
    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = st_mod
