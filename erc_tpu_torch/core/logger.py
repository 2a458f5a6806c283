"""Singleton, leveled logger with per-rank log files.

Port of ``erc_tpu.core.logger``: the same line format (``[HH:MM:SS] msg``),
levels, process-0 gating, an inline ``\\r`` progress line for the train
loop, and ``add_log_dir`` writing ``log.<YYMMDD-HHMMSS>.<rank>.txt``.  The
rank is ``torch.distributed.get_rank()`` where a process group is
initialised, else 0.  One departure: lines go to standard output, where the
port's entry points have always printed their log (the JAX logger writes to
standard error).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional

_LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Logger:
    _instance: Optional["Logger"] = None

    def __new__(cls, *a, **k):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance._initialized = False
        return cls._instance

    def __init__(self, level: str = "info"):
        if self._initialized:
            return
        self._initialized = True
        self.level = _LEVELS.get(level, 20)
        self._files = {}
        self._inline_active = False
        self.main_only = True

    def add_log_dir(self, path: str) -> str:
        """Also write every line to a new file in ``path``; returns its name."""
        os.makedirs(path, exist_ok=True)
        fname = os.path.join(path, f"log.{time.strftime('%y%m%d-%H%M%S')}.{_rank()}.txt")
        self._files[fname] = open(fname, "a")
        return fname

    def remove_log_file(self, fname: str) -> None:
        """Stop writing to (and close) a file that ``add_log_dir`` opened."""
        f = self._files.pop(fname, None)
        if f is not None:
            f.close()

    def _emit(self, level: int, *args, inline: bool = False):
        if level < self.level:
            return
        if self.main_only and _rank() != 0:
            return
        msg = " ".join(str(a) for a in args)
        line = f"[{time.strftime('%H:%M:%S')}] {msg}"
        out = sys.stdout
        if inline:
            out.write("\r" + line[:200].ljust(80))
            out.flush()
            self._inline_active = True
        else:
            if self._inline_active:
                out.write("\n")
                self._inline_active = False
            out.write(line + "\n")
            out.flush()
        for f in self._files.values():
            f.write(line + "\n")
            f.flush()

    def debug(self, *args):
        self._emit(10, *args)

    def info(self, *args):
        self._emit(20, *args)

    def warn(self, *args):
        self._emit(30, *args)

    def error(self, *args):
        self._emit(40, *args)

    def raw(self, *args):
        self._emit(100, *args)

    def inline(self, *args):
        self._emit(20, *args, inline=True)

    def newline(self):
        if self._inline_active:
            sys.stdout.write("\n")
            self._inline_active = False
