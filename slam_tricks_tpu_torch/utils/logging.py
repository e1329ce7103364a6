"""Leveled, ANSI-styled logger — the role of the reference's vendored logger
subsystem (st16-pcl-viewer/src/include/logger.h:273-638: LOG_PLAINTEXT/INFO/
PROCESS/WARNING/ERROR/FATAL macros, std+file loggers, LOG_VAR dumper),
re-designed as a thin layer over Python logging (port of
``slam_tricks_tpu/utils/logging.py``, the same code).

Loggers are global by name: in a process that imports both packages,
``get_logger(name)`` of either returns the same object, with the handlers
of whichever side called first.

Usage:
    from slam_tricks_tpu_torch.utils.logging import get_logger, log_var
    log = get_logger("solver")
    log.info("starting"); log.process("iter %d", i); log_var(log, x=x, cost=c)
"""

import logging
import sys

_STYLES = {
    "DEBUG": "\033[2m",      # dim
    "INFO": "\033[32m",      # green
    "PROCESS": "\033[36m",   # cyan (the reference's PROCESS level)
    "WARNING": "\033[33m",   # yellow
    "ERROR": "\033[31m",     # red
    "FATAL": "\033[1;31m",   # bold red
    "CRITICAL": "\033[1;31m",
}
_RESET = "\033[0m"

PROCESS = 25
logging.addLevelName(PROCESS, "PROCESS")


class _Formatter(logging.Formatter):
    def __init__(self, color=True):
        super().__init__("%(asctime)s [%(levelname)s] %(name)s: %(message)s",
                         datefmt="%H:%M:%S")
        self._color = color

    def format(self, record):
        msg = super().format(record)
        if self._color:
            style = _STYLES.get(record.levelname, "")
            return f"{style}{msg}{_RESET}" if style else msg
        return msg


class _Logger(logging.Logger):
    def process(self, msg, *args, **kw):
        if self.isEnabledFor(PROCESS):
            self._log(PROCESS, msg, args, **kw)

    fatal = logging.Logger.critical


logging.setLoggerClass(_Logger)


def get_logger(name="slam_tricks_tpu_torch", level=logging.INFO, file=None, color=None):
    log = logging.getLogger(name)
    if not log.handlers:
        h = logging.StreamHandler(sys.stderr)
        if color is None:
            color = sys.stderr.isatty()
        h.setFormatter(_Formatter(color))
        log.addHandler(h)
        if file is not None:
            fh = logging.FileHandler(file)
            fh.setFormatter(_Formatter(color=False))
            log.addHandler(fh)
        log.setLevel(level)
    return log


def log_var(log, **kwargs):
    """LOG_VAR analog (logger.h:546-556): dump named values on one line."""
    log.info(", ".join(f"{k} = {v}" for k, v in kwargs.items()))
