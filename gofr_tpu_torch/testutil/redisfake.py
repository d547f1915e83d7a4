"""In-memory RESP2 server: the hermetic stand-in for Redis (the port's
own copy of gofr_tpu/testutil/redisfake.py).

It speaks the real protocol over TCP on localhost, so the client under
test is exercised over an actual socket: the command subset the
framework uses (strings, hashes, lists, expiry, INFO). ``chip_smoke.py``
runs the kv-cache's shared tier (T2) against it, and so do the tests.
"""

from __future__ import annotations

import fnmatch
import socket
import threading
import time
from typing import Any


class _Store:
    def __init__(self) -> None:
        self.data: dict[str, Any] = {}
        self.expires: dict[str, float] = {}
        self.lock = threading.RLock()
        self.stats = {"total_connections_received": 0, "total_commands_processed": 0}

    def _sweep(self, key: str) -> None:
        exp = self.expires.get(key)
        if exp is not None and time.monotonic() >= exp:
            self.data.pop(key, None)
            self.expires.pop(key, None)

    def get(self, key: str) -> Any:
        self._sweep(key)
        return self.data.get(key)

    def set(self, key: str, value: Any) -> None:
        self.data[key] = value
        self.expires.pop(key, None)


def _b(v) -> bytes:
    return v if isinstance(v, bytes) else str(v).encode()


class FakeRedisServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.store = _Store()
        self._srv = socket.create_server((host, port))
        self.host, self.port = self._srv.getsockname()[:2]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True,
                                        name="fake-redis")
        self._thread.start()

    # -- wire loop ----------------------------------------------------------
    def _accept_loop(self) -> None:
        self._srv.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            self.store.stats["total_connections_received"] += 1
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        # one bytearray read through an offset: a pipeline of megabyte
        # SETs (a long prompt's KV frames) parses in linear time
        buf, pos = bytearray(), 0
        try:
            while not self._stop.is_set():
                cmd, end = self._try_parse(buf, pos)
                if cmd is None:
                    if pos:
                        del buf[:pos]
                        pos = 0
                    chunk = conn.recv(1 << 20)
                    if not chunk:
                        return
                    buf += chunk
                    continue
                pos = end
                reply = self._dispatch(cmd)
                conn.sendall(reply)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    @staticmethod
    def _try_parse(buf: bytearray, pos: int):
        """Parse one array-of-bulk-strings request at ``pos``: (args, the
        offset past it), or (None, pos) if it is incomplete."""
        if buf[pos:pos + 1] != b"*":
            return None, pos
        eol = buf.find(b"\r\n", pos)
        if eol < 0:
            return None, pos
        n = int(buf[pos + 1:eol])
        at = eol + 2
        args = []
        for _ in range(n):
            if buf[at:at + 1] != b"$":
                return None, pos
            eol = buf.find(b"\r\n", at)
            if eol < 0:
                return None, pos
            ln = int(buf[at + 1:eol])
            at = eol + 2
            if len(buf) < at + ln + 2:
                return None, pos
            args.append(bytes(buf[at:at + ln]))
            at += ln + 2
        return args, at

    # -- replies ------------------------------------------------------------
    @staticmethod
    def _simple(s: str) -> bytes:
        return f"+{s}\r\n".encode()

    @staticmethod
    def _error(s: str) -> bytes:
        return f"-ERR {s}\r\n".encode()

    @staticmethod
    def _int(n: int) -> bytes:
        return f":{n}\r\n".encode()

    @staticmethod
    def _bulk(v) -> bytes:
        if v is None:
            return b"$-1\r\n"
        b = _b(v)
        return b"$" + str(len(b)).encode() + b"\r\n" + b + b"\r\n"

    @classmethod
    def _array(cls, items) -> bytes:
        return b"*" + str(len(items)).encode() + b"\r\n" + b"".join(
            cls._bulk(i) for i in items)

    # -- command dispatch ---------------------------------------------------
    def _dispatch(self, args: list[bytes]) -> bytes:
        s = self.store
        s.stats["total_commands_processed"] += 1
        cmd = args[0].decode().upper()
        # surrogateescape: VALUES may be arbitrary binary (KV cache
        # frames) — the text view must never throw; commands that care
        # about bytes read from ``raw`` anyway
        a = [x.decode("utf-8", "surrogateescape") for x in args[1:]]
        with s.lock:
            try:
                return self._run(cmd, a, args[1:])
            except RedisFakeError as e:
                return self._error(str(e))
            except Exception as e:
                return self._error(f"internal {e!r}")

    def _run(self, cmd: str, a: list[str], raw: list[bytes]) -> bytes:
        s = self.store
        if cmd == "PING":
            return self._simple("PONG")
        if cmd == "SET":
            s.set(a[0], raw[1])
            i = 2
            while i < len(a):
                if a[i].upper() == "PX":
                    s.expires[a[0]] = time.monotonic() + int(a[i + 1]) / 1000
                    i += 2
                elif a[i].upper() == "EX":
                    s.expires[a[0]] = time.monotonic() + int(a[i + 1])
                    i += 2
                else:
                    i += 1
            return self._simple("OK")
        if cmd == "GET":
            v = s.get(a[0])
            if v is not None and not isinstance(v, bytes):
                raise RedisFakeError("WRONGTYPE")
            return self._bulk(v)
        if cmd == "MGET":
            vals = []
            for k in a:
                v = s.get(k)
                vals.append(v if isinstance(v, bytes) else None)
            return self._array(vals)
        if cmd == "DEL":
            n = sum(1 for k in a if s.data.pop(k, None) is not None)
            return self._int(n)
        if cmd == "EXISTS":
            return self._int(sum(1 for k in a if s.get(k) is not None))
        if cmd in ("INCRBY", "DECRBY", "INCR", "DECR"):
            delta = int(a[1]) if len(a) > 1 else 1
            if cmd in ("DECRBY", "DECR"):
                delta = -delta
            cur = s.get(a[0])
            val = int(cur or 0) + delta
            s.set(a[0], _b(val))
            return self._int(val)
        if cmd == "PEXPIRE":
            if s.get(a[0]) is None:
                return self._int(0)
            s.expires[a[0]] = time.monotonic() + int(a[1]) / 1000
            return self._int(1)
        if cmd == "TTL":
            if s.get(a[0]) is None:
                return self._int(-2)
            exp = s.expires.get(a[0])
            return self._int(-1 if exp is None else max(0, int(exp - time.monotonic())))
        if cmd == "KEYS":
            return self._array([k for k in list(s.data)
                                if s.get(k) is not None and fnmatch.fnmatch(k, a[0])])
        if cmd == "HSET":
            h = s.get(a[0])
            if h is None:
                h = {}
                s.set(a[0], h)
            if not isinstance(h, dict):
                raise RedisFakeError("WRONGTYPE")
            added = 0
            for f, v in zip(a[1::2], raw[2::2]):
                added += 0 if f in h else 1
                h[f] = v
            return self._int(added)
        if cmd == "HGET":
            h = s.get(a[0]) or {}
            return self._bulk(h.get(a[1]) if isinstance(h, dict) else None)
        if cmd == "HGETALL":
            h = s.get(a[0]) or {}
            flat: list = []
            for k, v in h.items():
                flat += [k, v]
            return self._array(flat)
        if cmd == "HDEL":
            h = s.get(a[0]) or {}
            n = sum(1 for f in a[1:] if h.pop(f, None) is not None)
            return self._int(n)
        if cmd in ("LPUSH", "RPUSH"):
            lst = s.get(a[0])
            if lst is None:
                lst = []
                s.set(a[0], lst)
            if not isinstance(lst, list):
                raise RedisFakeError("WRONGTYPE")
            for v in raw[1:]:
                lst.insert(0, v) if cmd == "LPUSH" else lst.append(v)
            return self._int(len(lst))
        if cmd == "LRANGE":
            lst = s.get(a[0]) or []
            start, stop = int(a[1]), int(a[2])
            stop = len(lst) if stop == -1 else stop + 1
            return self._array(lst[start:stop])
        if cmd == "FLUSHDB":
            s.data.clear()
            s.expires.clear()
            return self._simple("OK")
        if cmd == "INFO":
            lines = ["# Stats"] + [f"{k}:{v}" for k, v in s.stats.items()]
            return self._bulk("\r\n".join(lines))
        raise RedisFakeError(f"unknown command '{cmd}'")

    def close(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except Exception:
            pass
        self._thread.join(timeout=1.0)


class RedisFakeError(Exception):
    pass
