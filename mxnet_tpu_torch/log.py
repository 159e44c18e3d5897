"""Logging utilities: the port of `mxnet_tpu/log.py` (parity
`python/mxnet/log.py`): `get_logger` with level-coloured console output or
plain file output."""
from __future__ import annotations

import logging
import sys

__all__ = ["get_logger"]

CRITICAL = logging.CRITICAL
ERROR = logging.ERROR
WARNING = logging.WARNING
INFO = logging.INFO
DEBUG = logging.DEBUG
NOTSET = logging.NOTSET

_LEVEL_CHAR = {logging.CRITICAL: "C", logging.ERROR: "E",
               logging.WARNING: "W", logging.INFO: "I",
               logging.DEBUG: "D"}


class _Formatter(logging.Formatter):
    """Single-letter level prefix, colorized on a tty (reference log.py
    _Formatter)."""

    def __init__(self, colored=True):
        self.colored = colored
        super().__init__(datefmt="%m%d %H:%M:%S")

    def format(self, record):
        char = _LEVEL_CHAR.get(record.levelno, "U")
        if self.colored and record.levelno in (logging.ERROR,
                                               logging.CRITICAL):
            prefix = f"\x1b[31m{char}\x1b[0m"
        elif self.colored and record.levelno == logging.WARNING:
            prefix = f"\x1b[33m{char}\x1b[0m"
        else:
            prefix = char
        self._style._fmt = (prefix + "%(asctime)s %(process)d "
                            "%(pathname)s:%(lineno)d] %(message)s")
        return super().format(record)


def _defer_to_root(record):
    """Handler filter: once the user configures the root logger
    (`logging.basicConfig`, pytest's capture, a FileHandler), records reach
    it via propagation — our default stream handler must then go quiet or
    every line prints twice. One configurable stream, with out-of-the-box
    visibility when nothing is configured."""
    return not logging.getLogger().handlers


def get_logger(name=None, filename=None, filemode=None, level=WARNING):
    """Get a customized logger (reference log.py:56): file handler when
    `filename` is given, else a stream handler with colored levels."""
    logger = logging.getLogger(name)
    if name is not None and not getattr(logger, "_init_done", False):
        logger._init_done = True
        if filename:
            mode = filemode if filemode else "a"
            hdlr = logging.FileHandler(filename, mode)
            hdlr.setFormatter(_Formatter(colored=False))
        else:
            hdlr = logging.StreamHandler(sys.stderr)
            hdlr.setFormatter(_Formatter(
                colored=getattr(sys.stderr, "isatty", lambda: False)()))
            hdlr.addFilter(_defer_to_root)
        logger.addHandler(hdlr)
        # level set ONLY at first init (reference log.py) — later
        # get_logger calls must not clobber a configured level
        logger.setLevel(level)
    return logger
