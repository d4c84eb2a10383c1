"""Sharp-edges detection: impure Python during tracing.

Counterpart of ``thunder_tpu/core/sharp_edges.py`` (copied, with the two
reporters the bytecode interpreter calls: ``report_unguardable_keys`` and
``report_external_write``), itself the analog of the reference's sharp-edges
policy
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

__all__ = ["sharp_edges_guard", "SharpEdgeError", "report_external_write", "report_unguardable_keys"]


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


def report_unguardable_keys(policy: SHARP_EDGES_OPTIONS, where: str) -> None:
    """Iterating a tracked dict whose keys are not guardable (non-primitive
    key objects) unrolls the loop over the OBSERVED keys/values, but the
    prologue can only re-check the dict's LENGTH — replacing a key at the
    same length would silently replay the stale program.  Surface that
    under-guarding per policy instead of staying silent (the caller is
    ``core/interpreter.py _read_keys``)."""
    _dispatch(policy, (
        f"sharp edge: iteration over a tracked dict with unguardable keys "
        f"({where}) during tracing — the observed keys and values are baked "
        f"into the compiled program and only the dict's LENGTH is guarded, "
        f"so replacing a key (at unchanged length) will NOT retrace.  Use "
        f"primitive (or all-primitive tuple) keys for exact guarding, pass "
        f"the dict as an argument, or pass sharp_edges='allow' to silence."
    ), stacklevel=4)


def report_external_write(policy: SHARP_EDGES_OPTIONS, where: str) -> None:
    """Writes into tracked external state execute ONCE, at trace time (like
    print() under constant-values caching) — warn/error per policy so the
    user knows the side effect will not re-run per call."""
    _dispatch(policy, (
        f"sharp edge: write to external state {where} during tracing — the "
        f"effect happens once, at trace time, and will NOT re-run on later "
        f"calls.  Pass the container as an argument (epilogue writes those "
        f"back per call) or move the write outside the jitted function."
    ), stacklevel=4)


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
