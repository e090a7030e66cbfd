"""Logger mixin giving every unit a named hierarchical logger.

The port's own copy of `veles_tpu/logger.py`, under the "veles_torch"
logger so that a process holding both packages (the tests) keeps their
output apart. Parity: reference `veles/logger.py` (`Logger` mixin).
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

_ROOT = "veles_torch"
_initialized = False
_console_handler: Optional[logging.Handler] = None


def setup_logging(level: Optional[int] = None, stream=None) -> None:
    """Install the console handler once; safe to call repeatedly. `level`
    None means "don't change an already-configured console level" (first
    call defaults to INFO)."""
    global _initialized, _console_handler
    if _initialized:
        if level is not None:
            _console_handler.setLevel(level)
            logging.getLogger(_ROOT).setLevel(level)
        return
    level = logging.INFO if level is None else level
    _console_handler = logging.StreamHandler(stream or sys.stderr)
    _console_handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)-7s %(name)s: %(message)s", "%H:%M:%S"))
    _console_handler.setLevel(level)
    log = logging.getLogger(_ROOT)
    log.addHandler(_console_handler)
    log.setLevel(level)
    log.propagate = False
    _initialized = True


def set_verbosity(count: int) -> None:
    """CLI -v mapping: 0 -> warning, 1 -> info, 2+ -> debug."""
    levels = (logging.WARNING, logging.INFO, logging.DEBUG)
    setup_logging(levels[min(count, 2)])


class Logger:
    """Mixin: `self.logger` is a child of the "veles_torch" logger named
    after the concrete class (plus the instance's `name` when present)."""

    _logger: Optional[logging.Logger] = None

    @property
    def logger(self) -> logging.Logger:
        if self._logger is None:
            name = type(self).__name__
            inst = getattr(self, "name", None)
            if inst and inst != name:
                name = f"{name}[{inst}]"
            self._logger = logging.getLogger(f"{_ROOT}.{name}")
        return self._logger

    def debug(self, msg: str, *args) -> None:
        self.logger.debug(msg, *args)

    def info(self, msg: str, *args) -> None:
        self.logger.info(msg, *args)

    def warning(self, msg: str, *args) -> None:
        self.logger.warning(msg, *args)

    def error(self, msg: str, *args) -> None:
        self.logger.error(msg, *args)
