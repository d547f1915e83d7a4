"""Leveled structured logger (the port's own copy of gofr_tpu/glog.py:
the same levels, JSON lines and trace fields, the trace ids read from
the port's own ``tracing.current_span``; ``change_level`` for the remote
level poller and ``new_file_logger`` for CLI apps).

Reference: pkg/gofr/logging/logger.go — levels DEBUG<INFO<NOTICE<WARN<ERROR<FATAL
(logging/level.go:10-17), JSON output when piped and colorized pretty-print on a
TTY (logger.go:147-187), stderr split for >=ERROR (logger.go:60-63), Fatal exits
(logger.go:135-145). Named ``glog`` to avoid shadowing the stdlib ``logging``
module inside the package.
"""

from __future__ import annotations

import enum
import io
import json
import sys
import threading
import time
from typing import Any, IO


class LogLevel(enum.IntEnum):
    DEBUG = 1
    INFO = 2
    NOTICE = 3
    WARN = 4
    ERROR = 5
    FATAL = 6

    @classmethod
    def parse(cls, s: str | None, default: "LogLevel" = None) -> "LogLevel":
        default = default if default is not None else cls.INFO
        if not s:
            return default
        try:
            return cls[s.strip().upper()]
        except KeyError:
            return default


_COLORS = {
    LogLevel.DEBUG: 37,  # grey
    LogLevel.INFO: 36,  # cyan
    LogLevel.NOTICE: 36,
    LogLevel.WARN: 33,  # yellow
    LogLevel.ERROR: 31,  # red
    LogLevel.FATAL: 31,
}


def _is_terminal(stream: IO) -> bool:
    """Reference: logging/logger.go:257 checkIfTerminal."""
    try:
        return stream.isatty()
    except Exception:
        return False


class Logger:
    """Structured leveled logger with pluggable streams.

    Matches the reference ``logging.Logger`` interface surface
    (logging/logger.go:23-39): Debug/Log(Info)/Notice/Warn/Error/Fatal plus
    the ``*f`` format variants, and ``change_level`` used by the remote
    level poller (logging/dynamicLevelLogger.go).
    """

    def __init__(
        self,
        level: LogLevel = LogLevel.INFO,
        out: IO | None = None,
        err: IO | None = None,
        pretty: bool | None = None,
    ):
        self.level = level
        self.out = out if out is not None else sys.stdout
        self.err = err if err is not None else sys.stderr
        self.pretty = pretty if pretty is not None else _is_terminal(self.out)
        self._lock = threading.Lock()

    # -- core ---------------------------------------------------------------
    def _logf(self, level: LogLevel, *args: Any,
              fmt: str | None = None) -> None:
        if level < self.level:
            return
        stream = self.err if level >= LogLevel.ERROR else self.out
        now = time.time()
        if fmt is not None:
            message: Any = (fmt % args) if args else fmt
        elif len(args) == 1:
            message = args[0]
        else:
            message = " ".join(str(a) for a in args)

        if self.pretty:
            line = self._pretty_line(level, now, message)
        else:
            entry: dict[str, Any] = {
                "level": level.name,
                "time": time.strftime(
                    "%Y-%m-%dT%H:%M:%S", time.localtime(now)
                ) + f".{int((now % 1) * 1e6):06d}",
            }
            if isinstance(message, dict):
                entry["message"] = message
            elif hasattr(message, "log_fields"):
                entry["message"] = message.log_fields()
            else:
                entry["message"] = str(message)
            entry.update(_trace_fields())
            line = json.dumps(entry, default=str)
        with self._lock:
            try:
                stream.write(line + "\n")
                stream.flush()
            except ValueError:
                pass  # closed stream during shutdown

    def _pretty_line(self, level: LogLevel, now: float, message: Any) -> str:
        color = _COLORS[level]
        ts = time.strftime("%H:%M:%S", time.localtime(now))
        if hasattr(message, "pretty_print"):
            body = message.pretty_print()
        elif isinstance(message, dict):
            body = " ".join(f"{k}={v}" for k, v in message.items())
        else:
            body = str(message)
        return f"\x1b[{color}m{level.name:<6}\x1b[0m [{ts}] {body}"

    # -- public surface -----------------------------------------------------
    def debug(self, *args: Any) -> None:
        self._logf(LogLevel.DEBUG, *args)

    def debugf(self, fmt: str, *args: Any) -> None:
        self._logf(LogLevel.DEBUG, *args, fmt=fmt)

    def info(self, *args: Any) -> None:
        self._logf(LogLevel.INFO, *args)

    def infof(self, fmt: str, *args: Any) -> None:
        self._logf(LogLevel.INFO, *args, fmt=fmt)

    # reference calls INFO-level logging "Log"
    log = info
    logf = infof

    def notice(self, *args: Any) -> None:
        self._logf(LogLevel.NOTICE, *args)

    def noticef(self, fmt: str, *args: Any) -> None:
        self._logf(LogLevel.NOTICE, *args, fmt=fmt)

    def warn(self, *args: Any) -> None:
        self._logf(LogLevel.WARN, *args)

    def warnf(self, fmt: str, *args: Any) -> None:
        self._logf(LogLevel.WARN, *args, fmt=fmt)

    def error(self, *args: Any) -> None:
        self._logf(LogLevel.ERROR, *args)

    def errorf(self, fmt: str, *args: Any) -> None:
        self._logf(LogLevel.ERROR, *args, fmt=fmt)

    def fatal(self, *args: Any) -> None:
        self._logf(LogLevel.FATAL, *args)
        raise SystemExit(1)

    def fatalf(self, fmt: str, *args: Any) -> None:
        self._logf(LogLevel.FATAL, *args, fmt=fmt)
        raise SystemExit(1)

    def change_level(self, level: LogLevel) -> None:
        if level != self.level:
            self.info({"event": "log level changed", "to": level.name})
            self.level = level


def _trace_fields() -> dict[str, str]:
    """Stitch active trace/span ids into every structured log line
    (reference: middleware/logger.go:47-48 does this for request logs)."""
    from . import tracing  # local import: tracing imports nothing from glog

    span = tracing.current_span()
    if span is None:
        return {}
    return {"trace_id": span.trace_id, "span_id": span.span_id}


def new_logger(level: LogLevel | str = LogLevel.INFO, **kw: Any) -> Logger:
    if isinstance(level, str):
        level = LogLevel.parse(level)
    return Logger(level=level, **kw)


def new_file_logger(path: str, level: LogLevel = LogLevel.INFO) -> Logger:
    """Reference: logging/logger.go:236-255 NewFileLogger for CMD apps:
    every level to the file at ``path`` (appended, JSON lines); an empty
    path discards the logs."""
    if not path:
        return Logger(level=level, out=io.StringIO(), err=io.StringIO(),
                      pretty=False)
    f = open(path, "a", encoding="utf-8")  # noqa: SIM115 - long-lived handle
    return Logger(level=level, out=f, err=f, pretty=False)
