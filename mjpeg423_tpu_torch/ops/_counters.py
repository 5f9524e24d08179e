"""Launch counters of the kernel wrappers, safe to add to from threads.

Each wrapper module keeps one LaunchCounts with a name per kernel and adds
one where it launches that kernel, nowhere else.  A run resets the counts
to 0 and reads them back to show which kernel did its work.  The module
serves the names as read-only attributes too (``transform_fused.LAUNCHES``)
through ``module_getattr``.
"""
from __future__ import annotations

import threading


class LaunchCounts:
    """Named launch counts behind one lock: add, get, read, reset."""

    def __init__(self, *names: str):
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(names, 0)

    def add(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] += n

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts[name]

    def read(self) -> dict[str, int]:
        """A copy of every count."""
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            for name in self._counts:
                self._counts[name] = 0

    def module_getattr(self, module: str):
        """A module-level __getattr__ that serves the counts by name."""
        def __getattr__(name: str):
            if name in self._counts:
                return self.get(name)
            raise AttributeError(f"module {module!r} has no attribute {name!r}")
        return __getattr__
