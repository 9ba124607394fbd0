"""Interactive 'q'-to-quit watcher for long searches.

Reference: watch_stream / check_for_user_quit
(SymbolicRegression.jl/src/SearchUtils.jl:140-188) — the scheduler polls stdin
between cycles and exits gracefully (returning the current hall of fame)
when the user types ``q``+Enter or hits Ctrl-C as raw bytes.

The default watcher only arms itself on a real TTY so test runners and
pipelines never have their stdin consumed; tests inject a pipe explicitly.
"""

from __future__ import annotations

import os
import select
import sys
import threading

__all__ = ["StdinReader"]

_CTRL_C = 0x03
_QUIT = ord("q")


class StdinReader:
    def __init__(self, stream=None):
        explicit = stream is not None
        self.stream = stream if explicit else sys.stdin
        self.can_read = False
        self._fd = None
        # sticky latch: once 'q' is seen, every subsequent check returns True
        # — required when one reader is SHARED by concurrent per-output
        # searches (only one caller consumes the actual bytes). The lock
        # serializes select+read: without it a second thread could pass
        # select() then block forever reading the already-drained fd.
        self._quit = False
        self._lock = threading.Lock()
        try:
            self._fd = self.stream.fileno()
            # implicit stdin: arm only on an interactive terminal
            self.can_read = explicit or self.stream.isatty()
        except (ValueError, OSError, AttributeError):
            self.can_read = False

    def check_for_user_quit(self) -> bool:
        """True iff the user typed 'q'+Enter or sent Ctrl-C bytes
        (reference checks the final two bytes, SearchUtils.jl:173-188)."""
        if self._quit:
            return True
        if not self.can_read:
            return False
        with self._lock:
            if self._quit:
                return True
            try:
                ready, _, _ = select.select([self._fd], [], [], 0)
            except (ValueError, OSError):
                self.can_read = False
                return False
            if not ready:
                return False
            try:
                data = os.read(self._fd, 1024)
            except (BlockingIOError, OSError):
                return False
        if not data:
            self.can_read = False  # EOF: stop watching
            return False
        if data[-1] == _CTRL_C:
            self._quit = True
            return True
        if len(data) > 1 and data[-2] == _QUIT:
            self._quit = True
            return True
        return False

    def close(self) -> None:
        self.can_read = False
