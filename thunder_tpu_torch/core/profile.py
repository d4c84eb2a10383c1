"""DEPRECATED shim: profiling moved to ``thunder_tpu_torch.observability``.

Counterpart of ``thunder_tpu/core/profile.py``, kept for its callers
(``profiling_enabled``, ``add_markers``).  ``THUNDER_TPU_ANNOTATE_TRACES``
is read on every call (``observability/config.py``); ``_ENABLED`` survives
only as a programmatic override that callers may set.
"""
from __future__ import annotations

import contextlib

from thunder_tpu_torch.observability.config import annotations_enabled as _annotations_enabled

__all__ = ["profiling_enabled", "add_markers"]

_ENABLED = False  # legacy override; the live gate is the dynamic env read


def profiling_enabled() -> bool:
    return _ENABLED or _annotations_enabled()


@contextlib.contextmanager
def add_markers(msg: str):
    """Annotates the enclosed work with ``msg`` in ``torch.profiler`` traces
    (``torch.profiler.record_function``)."""
    if not profiling_enabled():
        yield
        return
    assert "\n" not in msg, msg
    import torch

    with torch.profiler.record_function(msg):
        yield
