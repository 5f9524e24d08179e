"""Launch counters of the kernel wrappers, safe to add to from threads.

Each wrapper module keeps one LaunchCounts with a name per kernel and adds
one where it launches that kernel, nowhere else.  A run resets the counts
to 0 and reads them back to show which kernel did its work.  The module
serves the names as read-only attributes too (``transform_fused.LAUNCHES``)
through ``module_getattr``.  launch_counts() and reset_counts() read and
reset every wrapper's counts at once, by the kernels' names K1-K5.
"""
from __future__ import annotations

import importlib
import threading

# Each kernel of the port, by its name in the port's tables: the wrapper
# module under ops/ and the count that wrapper adds to where it launches it.
KERNEL_COUNTERS = {
    "K1": ("transform_fused", "LAUNCHES"),
    "K2": ("transform_fused", "LAUNCHES_CM"),
    "K3": ("transform_fused", "LAUNCHES_I8"),
    "K4": ("encode_fused", "LAUNCHES"),
    "K5": ("transform_coefmajor", "LAUNCHES_K5"),
}


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


def _wrapper_counts(module: str) -> LaunchCounts:
    # Imported on first use: the wrappers import this module.
    return importlib.import_module(f".{module}", __package__).COUNTS


def launch_counts() -> dict[str, int]:
    """Every kernel's launch count, {"K1": .., ..., "K5": ..}."""
    return {k: _wrapper_counts(m).get(name)
            for k, (m, name) in KERNEL_COUNTERS.items()}


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    for module in {m for m, _ in KERNEL_COUNTERS.values()}:
        _wrapper_counts(module).reset()
