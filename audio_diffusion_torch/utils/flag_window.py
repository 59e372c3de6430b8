"""A process-wide torch flag held at one value while any of its windows is open.

A flag of ``torch.backends`` (or torch's deterministic-algorithms setting) is
one value for the whole process, so a window on it is kept in one object: a
lock and a count of the windows open. The first window to open saves the
flag and sets it; the last to close puts the saved value back, when its body
raises too. Windows may overlap in any order and on any thread, and the flag
keeps the window's value while any is open; every other thread of the
process sees that value meanwhile.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable


class FlagWindow:
    """``with window():`` runs its body with the flag that ``get`` reads and
    ``set`` writes at ``value``."""

    def __init__(self, get: Callable[[], Any], set: Callable[[Any], None], value):
        self.get, self.set, self.value = get, set, value
        self._lock = threading.Lock()
        self._open = 0  # windows open now
        self._saved = None  # the flag before the first of them opened

    @contextlib.contextmanager
    def __call__(self):
        with self._lock:
            if self._open == 0:
                self._saved = self.get()
            self._open += 1
            self.set(self.value)
        try:
            yield
        finally:
            with self._lock:
                self._open -= 1
                if self._open == 0:
                    self.set(self._saved)
                    self._saved = None


def attribute_window(module, name: str, value) -> FlagWindow:
    """A window on the attribute ``module.name``, such as ``torch.backends.cudnn.enabled``."""
    return FlagWindow(lambda: getattr(module, name), lambda v: setattr(module, name, v), value)
