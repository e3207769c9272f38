"""Structured JSON-lines logging.

The reference's entire observability surface is 21 ``print()`` calls
(SURVEY.md §5).  This replaces it with a structured logger: one JSON object
per event (timestamp, level, logger, message, fields), writable to stderr
and/or a file, cheap enough to leave on in production runs.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, TextIO

_LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}


@dataclass
class _LogConfig:
    level: int = 20
    stream: TextIO | None = None
    file_path: str | None = None
    _file: TextIO | None = None
    _lock: threading.Lock = field(default_factory=threading.Lock)


_CONFIG = _LogConfig(stream=sys.stderr)


def configure_logging(
    level: str = "info", stream: TextIO | None = None, file_path: str | None = None
) -> None:
    if level not in _LEVELS:
        raise ValueError(f"unknown log level {level!r}; one of {sorted(_LEVELS)}")
    _CONFIG.level = _LEVELS[level]
    if stream is not None:
        _CONFIG.stream = stream
    if file_path is not None:
        os.makedirs(os.path.dirname(file_path) or ".", exist_ok=True)
        if _CONFIG._file is not None:
            _CONFIG._file.close()
        _CONFIG._file = open(file_path, "a")
        _CONFIG.file_path = file_path


@dataclass(frozen=True)
class Logger:
    name: str

    def _emit(self, level: str, message: str, **fields: Any) -> None:
        if _LEVELS[level] < _CONFIG.level:
            return
        rec = {
            "ts": round(time.time(), 3),
            "level": level,
            "logger": self.name,
            "msg": message,
            **fields,
        }
        line = json.dumps(rec, default=str)
        with _CONFIG._lock:
            if _CONFIG.stream is not None:
                print(line, file=_CONFIG.stream)
            if _CONFIG._file is not None:
                _CONFIG._file.write(line + "\n")
                _CONFIG._file.flush()

    def debug(self, message: str, **fields: Any) -> None:
        self._emit("debug", message, **fields)

    def info(self, message: str, **fields: Any) -> None:
        self._emit("info", message, **fields)

    def warning(self, message: str, **fields: Any) -> None:
        self._emit("warning", message, **fields)

    def error(self, message: str, **fields: Any) -> None:
        self._emit("error", message, **fields)


_LOGGERS: dict[str, Logger] = {}


def get_logger(name: str) -> Logger:
    if name not in _LOGGERS:
        _LOGGERS[name] = Logger(name)
    return _LOGGERS[name]
