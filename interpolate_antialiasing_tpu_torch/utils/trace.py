"""Spans at the port's layer boundaries, on torch.profiler's own timeline.

:func:`span` is ``torch.profiler.record_function(name)`` while a torch
profiler runs, and one shared null context otherwise: outside a profile a
span costs a flag read and a call, and records nothing.  A span creates no
tensor, starts no device work and adds no synchronisation.

Every name starts with ``ia.``; its second word is the layer: ``models``
(the pipelines), ``ops`` (routing and checks), ``tables`` (host tables,
plans and their uploads), ``build`` (the body of a cached function, so it
opens only on a miss) and ``native`` (one launch of a hand-written kernel,
named as ``utils.inspect.launch_counts()`` names it).
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` as a span while a profiler runs."""
    # read through the module at each call: the profiler sets the flag
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator: the whole of the function's call inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            # off, the call skips even the null context's enter and exit
            if _profiler._is_profiler_enabled:
                with torch.profiler.record_function(name):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
        return call
    return wrap


def builds(fn):
    """Decorator for a cached function, beneath its cache decorator: the body
    inside ``span("ia.build.<function>")``, which then counts the misses."""
    return spanned(f"ia.build.{fn.__name__}")(fn)
