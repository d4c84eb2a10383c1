"""Sharp-edges detection: impure Python during tracing.

Counterpart of ``thunder_tpu/core/sharp_edges.py`` (copied; the reporters
the bytecode interpreter calls come with it, ``ROADMAP.md`` Queue 1 item 13),
itself the analog of the reference's sharp-edges policy
(``thunder/core/options.py:146`` + ``jit_ext.py:472`` — ALLOW/WARN/ERROR on
nondeterministic or impure Python observed while tracing).  The functional
frontend executes the user's Python once at trace time, so any value produced
by an impure call (``time.time()``, ``random.random()``, ``np.random.*``)
bakes into the compiled program as a constant — correct-looking on call one,
silently stale forever after.  This guard intercepts the canonical impure
sources for the duration of tracing and applies the policy.
"""
from __future__ import annotations

import contextlib
import warnings
from typing import Any

from thunder_tpu_torch.core.options import SHARP_EDGES_OPTIONS

__all__ = ["sharp_edges_guard", "SharpEdgeError"]


class SharpEdgeError(RuntimeError):
    pass


_PATCH_SITES = (
    ("random", "random"),
    ("random", "randint"),
    ("random", "uniform"),
    ("random", "gauss"),
    ("random", "randrange"),
    ("random", "choice"),
    ("time", "time"),
    ("time", "time_ns"),
    ("time", "monotonic"),
    ("time", "perf_counter"),
)


def _dispatch(policy: SHARP_EDGES_OPTIONS, msg: str, stacklevel: int = 3):
    if policy is SHARP_EDGES_OPTIONS.ALLOW:
        return
    if policy is SHARP_EDGES_OPTIONS.ERROR:
        raise SharpEdgeError(msg)
    warnings.warn(msg, stacklevel=stacklevel)


def _report(policy: SHARP_EDGES_OPTIONS, what: str):
    _dispatch(policy, (
        f"sharp edge: {what} called during tracing — its result will be baked "
        f"into the compiled program as a constant (it will NOT re-run on later "
        f"calls).  Pass sharp_edges='allow' to silence, or move the call "
        f"outside the jitted function."
    ))


@contextlib.contextmanager
def sharp_edges_guard(policy: SHARP_EDGES_OPTIONS):
    """Patches the canonical impure call sites for the duration of tracing."""
    if policy is SHARP_EDGES_OPTIONS.ALLOW:
        yield
        return

    saved: list[tuple[Any, str, Any]] = []

    def wrap(mod, name, orig):
        def guarded(*args, **kwargs):
            _report(policy, f"{mod.__name__}.{name}()")
            return orig(*args, **kwargs)

        return guarded

    try:
        import importlib

        for mod_name, attr in _PATCH_SITES:
            try:
                mod = importlib.import_module(mod_name)
            except ImportError:  # pragma: no cover
                continue
            orig = getattr(mod, attr, None)
            if orig is None:
                continue
            saved.append((mod, attr, orig))
            setattr(mod, attr, wrap(mod, attr, orig))

        # numpy's global RNG namespace
        try:
            import numpy as np

            for attr in ("random", "rand", "randn", "randint", "uniform", "normal"):
                orig = getattr(np.random, attr, None)
                if orig is None:
                    continue
                saved.append((np.random, attr, orig))
                setattr(np.random, attr, wrap(np.random, attr, orig))
        except ImportError:  # pragma: no cover
            pass

        yield
    finally:
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)
