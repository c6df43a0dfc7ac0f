"""Lock factory: every Lock/RLock/Condition of the port is built here,
named by its static identity (`Class.attr`), as in the reference
(corda_tpu/utils/locks.py).

The reference's factory hands out instrumented wrappers while its
runtime concurrency sanitizer is armed; the sanitizer is not ported,
so these return the raw `threading` primitives. Keeping the seam keeps
the lock names (and so the lock order the reference documents) in the
code. Imports nothing of the port: every leaf module may use it.
"""

from __future__ import annotations

import threading


def make_lock(name: str):
    """A non-reentrant lock named by its static identity."""
    del name
    return threading.Lock()


def make_rlock(name: str):
    """A reentrant lock named by its static identity."""
    del name
    return threading.RLock()


def make_condition(name: str, lock=None):
    """A condition variable named by its static identity."""
    del name
    return threading.Condition(lock)
