"""Remote log-level polling (the port's own copy of
gofr_tpu/remote_level.py).

Reference: pkg/gofr/logging/dynamicLevelLogger.go:17-97 -- a wrapper polls
REMOTE_LOG_URL every REMOTE_LOG_FETCH_INTERVAL (default 15s) and calls the
logger's private changeLevel. Here the poller mutates the shared Logger
directly (a level is a single int read; no wrapper indirection needed).
Its thread is a daemon; ``stop()`` ends it (the Container's ``close()``
calls it).
"""

from __future__ import annotations

import json
import threading
import urllib.request

from .glog import Logger, LogLevel


def _extract_level(payload: dict) -> str | None:
    """Accept common shapes: {"data":{"logLevel": X}} / {"data":{"LOG_LEVEL": X}}
    / {"level": X}, a list under "data" (its first item), and a
    {"value": X} wrapper (reference fetchAndUpdateLogLevel parses a
    service-config envelope, dynamicLevelLogger.go:65-97)."""
    if not isinstance(payload, dict):
        return None
    data = payload.get("data", payload)
    if isinstance(data, list) and data:
        data = data[0]
    if isinstance(data, dict):
        for key in ("logLevel", "LOG_LEVEL", "level"):
            v = data.get(key)
            if isinstance(v, str):
                return v
            if isinstance(v, dict) and isinstance(v.get("value"), str):
                return v["value"]
    return None


class RemoteLevelPoller:
    def __init__(self, logger: Logger, url: str, interval: float = 15.0,
                 http_get=None):
        self.logger = logger
        self.url = url
        self.interval = interval
        self._http_get = http_get or self._default_get
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="remote-log-level")
        self._thread.start()

    @staticmethod
    def _default_get(url: str) -> bytes:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.read()

    def poll_once(self) -> None:
        """One fetch: a payload that does not parse, or names no known
        level, leaves the level as it was."""
        try:
            payload = json.loads(self._http_get(self.url))
        except Exception:  # noqa: BLE001 — the next poll tries again
            return
        level = _extract_level(payload)
        if level is None:
            return
        try:
            self.logger.change_level(LogLevel[level.strip().upper()])
        except KeyError:
            pass

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.poll_once()

    def stop(self) -> None:
        self._stop.set()
