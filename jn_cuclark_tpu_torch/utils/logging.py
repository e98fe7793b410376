"""Leveled, timestamped, tee'd logger — the kent-mpi structured logger
(app/kent_mpi.cpp:150-179) as a small utility."""

from __future__ import annotations

import datetime
import os
import sys

LEVELS = {"debug": 0, "info": 1, "warn": 2, "error": 3}
_COLORS = {"debug": "\033[90m", "info": "\033[36m", "warn": "\033[33m", "error": "\033[31m"}
_RESET = "\033[0m"


class ClusterLogger:
    def __init__(self, level: str = "info", logfile: str | None = None, color: bool | None = None):
        self.level = LEVELS.get(level.lower(), 1)
        self.fh = None
        if logfile:
            os.makedirs(os.path.dirname(logfile) or ".", exist_ok=True)
            self.fh = open(logfile, "a")
        self.color = sys.stderr.isatty() if color is None else color

    def log(self, level: str, msg: str):
        if LEVELS.get(level, 1) < self.level:
            return
        ts = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        tag = level.upper()
        line = f"[{ts}] [{tag}] {msg}"
        if self.color:
            sys.stderr.write(f"{_COLORS.get(level, '')}{line}{_RESET}\n")
        else:
            sys.stderr.write(line + "\n")
        if self.fh:
            self.fh.write(line + "\n")
            self.fh.flush()

    def debug(self, msg):
        self.log("debug", msg)

    def info(self, msg):
        self.log("info", msg)

    def warn(self, msg):
        self.log("warn", msg)

    def error(self, msg):
        self.log("error", msg)

    def close(self):
        if self.fh:
            self.fh.close()
            self.fh = None
