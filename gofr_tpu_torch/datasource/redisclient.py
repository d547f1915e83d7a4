"""A dependency-free RESP2 Redis client with command observability (the
port's own copy of gofr_tpu/datasource/redisclient.py, reduced to the
commands the kv-cache's shared tier, the async lane's checkpoints, the
migration ledger and their tests use: strings, counters, hashes, expiry,
key listing, pipelines and INFO for the health check). The App's Container builds one from
``REDIS_HOST``/``REDIS_PORT`` (``new_redis_client``) as ``ctx.redis``;
the shared tier builds its own.

It speaks the RESP2 wire protocol directly over a socket, and records
every command and pipeline with its duration in microseconds into the
``app_redis_stats`` histogram when given a metrics manager. The port's
``testutil.redisfake.FakeRedisServer`` is its hermetic counterpart.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Any

from . import STATUS_DOWN, STATUS_UP, Health


class RedisError(Exception):
    """Server-side error reply (RESP '-ERR ...')."""


class RedisConnectionLost(ConnectionError):
    """The server closed the connection mid-reply."""


def encode_command(*args: Any) -> bytes:
    """RESP2 array-of-bulk-strings request framing."""
    out = [f"*{len(args)}\r\n".encode()]
    for a in args:
        b = a if isinstance(a, bytes) else str(a).encode()
        out.append(f"${len(b)}\r\n".encode())
        out.append(b)
        out.append(b"\r\n")
    return b"".join(out)


class _Reader:
    """Buffered RESP2 reply parser over a socket. The buffer is one
    bytearray read through an offset, so a multi-megabyte reply (an MGET
    of a long prompt's KV frames) parses in linear time."""

    _RECV = 1 << 20

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = bytearray()
        self._pos = 0

    def _fill(self) -> None:
        if self._pos and self._pos * 2 >= len(self._buf):
            del self._buf[:self._pos]
            self._pos = 0
        chunk = self._sock.recv(self._RECV)
        if not chunk:
            raise RedisConnectionLost("redis connection closed")
        self._buf += chunk

    def _read_line(self) -> bytes:
        while True:
            end = self._buf.find(b"\r\n", self._pos)
            if end >= 0:
                line = bytes(self._buf[self._pos:end])
                self._pos = end + 2
                return line
            self._fill()

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) - self._pos < n + 2:
            self._fill()
        data = bytes(self._buf[self._pos:self._pos + n])
        self._pos += n + 2  # strip \r\n
        return data

    def read_reply(self) -> Any:
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RedisError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n == -1:
                return None
            return self._read_exact(n)
        if kind == b"*":
            n = int(rest)
            if n == -1:
                return None
            return [self.read_reply() for _ in range(n)]
        raise RedisError(f"unexpected RESP type {line!r}")


class Pipeline:
    """Batched commands flushed in one round trip; a command's error
    reply comes back in its place as a RedisError."""

    def __init__(self, client: "RedisClient"):
        self._client = client
        self._cmds: list[tuple] = []

    def command(self, *args) -> "Pipeline":
        self._cmds.append(args)
        return self

    def __getattr__(self, name: str):
        def call(*args):
            return self.command(name.upper(), *args)
        return call

    def execute(self) -> list[Any]:
        return self._client._execute_pipeline(self._cmds)


class RedisClient:
    def __init__(self, host: str = "localhost", port: int = 6379,
                 logger=None, metrics=None, timeout: float = 5.0):
        self.host = host
        self.port = port
        self.logger = logger
        self.metrics = metrics
        self.timeout = timeout
        self._io_lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._reader: _Reader | None = None
        self._connect()

    def _connect(self) -> None:
        self._sock = socket.create_connection((self.host, self.port),
                                              timeout=self.timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._reader = _Reader(self._sock)

    def _observe(self, label: str, dur_us: float) -> None:
        if self.metrics is not None:
            try:
                self.metrics.record_histogram("app_redis_stats", dur_us,
                                              type=label)
            except Exception:  # noqa: BLE001 — telemetry only
                pass
        if self.logger is not None:
            self.logger.debug({"event": "redis command", "command": label,
                               "duration_us": int(dur_us)})

    # -- generic command ----------------------------------------------------
    def command(self, *args) -> Any:
        label = str(args[0]).upper() if args else ""
        start = time.perf_counter()
        payload = encode_command(*args)
        with self._io_lock:
            try:
                self._sock.sendall(payload)
            except (OSError, AttributeError):
                # safe to retry: the command never reached the server
                # (AttributeError: the socket was closed, _sock is None)
                self._connect()
                self._sock.sendall(payload)
            try:
                reply = self._reader.read_reply()
            except OSError:
                # NOT safe to resend (the server may have run a
                # non-idempotent command before the connection died),
                # but reconnect so the stream is not left desynchronized
                self._connect()
                raise
        self._observe(label, (time.perf_counter() - start) * 1e6)
        return reply

    def _execute_pipeline(self, cmds: list[tuple]) -> list[Any]:
        if not cmds:
            return []
        start = time.perf_counter()
        payload = b"".join(encode_command(*c) for c in cmds)
        with self._io_lock:
            try:
                self._sock.sendall(payload)
                replies = []
                for _ in cmds:
                    try:
                        replies.append(self._reader.read_reply())
                    except RedisError as e:
                        replies.append(e)
            except OSError:
                # reconnect so leftover in-flight replies can't be read as
                # answers to later commands, then surface the failure
                self._connect()
                raise
        self._observe(f"pipeline[{len(cmds)}]",
                      (time.perf_counter() - start) * 1e6)
        return replies

    def pipeline(self) -> Pipeline:
        return Pipeline(self)

    # -- typed convenience surface ------------------------------------------
    @staticmethod
    def _text(reply: Any) -> str | None:
        return reply.decode() if isinstance(reply, bytes) else reply

    def ping(self) -> bool:
        return self.command("PING") == "PONG"

    def set(self, key: str, value: Any, ex: float | None = None) -> bool:
        args: list[Any] = ["SET", key, value]
        if ex is not None:
            args += ["PX", int(ex * 1000)]
        return self.command(*args) == "OK"

    def get(self, key: str) -> str | None:
        return self._text(self.command("GET", key))

    def get_bytes(self, key: str) -> bytes | None:
        """GET returning the raw bulk-string payload (``get`` decodes to
        ``str``, which is lossy for binary values such as KV frames)."""
        reply = self.command("GET", key)
        if reply is None or isinstance(reply, bytes):
            return reply
        return str(reply).encode()

    def mget(self, *keys: str) -> list[bytes | None]:
        """MGET returning raw ``bytes`` per key (None for absent keys):
        one round trip for a whole block chain, binary-safe."""
        if not keys:
            return []
        out = []
        for reply in self.command("MGET", *keys) or []:
            if reply is None or isinstance(reply, bytes):
                out.append(reply)
            else:
                out.append(str(reply).encode())
        return out

    def delete(self, *keys: str) -> int:
        return self.command("DEL", *keys)

    def exists(self, *keys: str) -> int:
        return self.command("EXISTS", *keys)

    def incr(self, key: str, by: int = 1) -> int:
        return self.command("INCRBY", key, by)

    def decr(self, key: str, by: int = 1) -> int:
        return self.command("DECRBY", key, by)

    def expire(self, key: str, seconds: float) -> bool:
        return self.command("PEXPIRE", key, int(seconds * 1000)) == 1

    def ttl(self, key: str) -> int:
        return self.command("TTL", key)

    def hset(self, key: str, field: str, value: Any, *more) -> int:
        return self.command("HSET", key, field, value, *more)

    def hgetall(self, key: str) -> dict[str, str]:
        flat = self.command("HGETALL", key) or []
        it = iter(flat)
        return {self._text(k): self._text(v) for k, v in zip(it, it)}

    def keys(self, pattern: str = "*") -> list[str]:
        return [self._text(k) for k in self.command("KEYS", pattern)]

    def flushdb(self) -> bool:
        return self.command("FLUSHDB") == "OK"

    def info(self, section: str = "") -> dict[str, str]:
        raw = self.command("INFO", section) if section \
            else self.command("INFO")
        out: dict[str, str] = {}
        for line in (self._text(raw) or "").splitlines():
            if line and not line.startswith("#") and ":" in line:
                k, v = line.split(":", 1)
                out[k] = v
        return out

    def health_check(self) -> Health:
        """The datasource health the App's ``/.well-known/health``
        renders under ``redis``."""
        try:
            stats = self.info("stats")
            return Health(status=STATUS_UP, details={
                "host": f"{self.host}:{self.port}", **stats})
        except Exception as e:  # noqa: BLE001 — health reports, never raises
            return Health(status=STATUS_DOWN, details={
                "host": f"{self.host}:{self.port}", "error": repr(e)})

    def close(self) -> None:
        with self._io_lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None


def new_redis_client(cfg, logger=None, metrics=None) -> RedisClient:
    """The client of ``REDIS_HOST`` (default localhost) and
    ``REDIS_PORT`` (default 6379)."""
    return RedisClient(host=cfg.get_or_default("REDIS_HOST", "localhost"),
                       port=cfg.get_int("REDIS_PORT", 6379),
                       logger=logger, metrics=metrics)
