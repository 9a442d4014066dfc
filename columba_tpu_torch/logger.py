"""Global logger with elapsed-time stamps, levels, and optional log file.

Mirrors the reference's thread-safe Logger (reference: src/logger.h:40-116,
src/logger.cpp): messages carry an [elapsed-time] stamp and a level tag
(INFO / VERBOSE / DEVELOPER / WARNING / ERROR), default sink is stderr, and
``-l <file>`` redirects the stream to a file. Verbosity gates VERBOSE and
DEVELOPER messages (reference -v).
"""

from __future__ import annotations

import sys
import time

_START = time.time()

INFO, VERBOSE, DEVELOPER, WARNING, ERROR = range(5)
_TAGS = {INFO: "INFO", VERBOSE: "VERBOSE", DEVELOPER: "DEVELOPER",
         WARNING: "WARNING", ERROR: "ERROR"}


class Logger:
    def __init__(self):
        self._file = None
        self.verbose = False

    def set_log_file(self, path: str | None):
        if self._file is not None:
            self._file.close()
            self._file = None
        if path:
            self._file = open(path, "w")

    def _stream(self):
        return self._file if self._file is not None else sys.stderr

    def _log(self, level: int, msg: str):
        if level in (VERBOSE, DEVELOPER) and not self.verbose:
            return
        el = time.time() - _START
        h, rem = divmod(int(el), 3600)
        mnt, s = divmod(rem, 60)
        stamp = f"{h:02d}:{mnt:02d}:{s:02d}.{int((el % 1) * 1000):03d}"
        print(f"[{stamp} - {_TAGS[level]}]\t{msg}",
              file=self._stream(), flush=True)

    def info(self, msg: str):
        self._log(INFO, msg)

    def verbose_msg(self, msg: str):
        self._log(VERBOSE, msg)

    def developer(self, msg: str):
        self._log(DEVELOPER, msg)

    def warning(self, msg: str):
        self._log(WARNING, msg)

    def error(self, msg: str):
        self._log(ERROR, msg)


logger = Logger()
