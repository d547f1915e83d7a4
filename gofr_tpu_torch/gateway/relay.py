"""Forward + stream-relay mechanics for one gateway attempt (the port's
own copy of gofr_tpu/gateway/relay.py).

One attempt = one HTTP connection to one replica, hand-rolled over a
raw socket. Hand-rolled on purpose: ``http.client``'s chunked reader
treats a TRUNCATED stream (peer closed before the terminal chunk —
exactly what a SIGKILLed replica looks like) as a clean EOF, which
would silently turn a mid-stream death into a shorter "successful"
response. The typed-503 contract needs the distinction, so the chunk
decoder here is explicit: a stream ends cleanly ONLY at the terminal
``0\\r\\n\\r\\n`` chunk (or the declared Content-Length); EOF anywhere
else raises.

The contract the failover loop (gateway/__init__.py) builds on:

  - :func:`forward` raises :class:`TransportLoss` for ANY failure
    before the replica commits a response (connect refused, send
    failure, EOF/timeout before response headers) — safe to retry
    elsewhere: nothing was delivered;
  - a COMPLETE non-2xx response comes back as a buffered
    :class:`ReplicaResponse` (sheds, drains, client errors — the
    loop decides whether to fail over or relay them);
  - a 2xx comes back live (``("stream", stream)``): the replica's
    HTTP server coalesces status+headers with the FIRST token chunk,
    so a 2xx in hand means the first token is already on the wire —
    reading it (:func:`first_line`) is the commit point after which
    failover would duplicate delivered tokens;
  - after commit, :func:`relay_lines` pipes replica lines to the
    client verbatim; a mid-stream loss terminates the (already-200)
    stream with one final typed error line
    ``{"error": {"message", "status": 503, "retry_after"}}`` (the
    client side is ``service.stream_generate``).
"""

from __future__ import annotations

import json
import socket

from ..errors import parse_retry_after
from .table import Replica

__all__ = ["ReplicaResponse", "ReplicaStream", "TransportLoss",
           "error_line", "first_line", "forward", "relay_lines"]


class TransportLoss(Exception):
    """The replica was lost before committing a response (or before
    its first token reached us): retriable by contract."""


class ReplicaResponse:
    """A buffered (non-streaming) replica reply."""

    __slots__ = ("status", "headers", "body")

    def __init__(self, status: int, headers: dict, body: bytes):
        self.status = int(status)
        self.headers = headers  # already lower-cased keys
        self.body = body

    def header(self, key: str, default: str = "") -> str:
        return self.headers.get(key.lower(), default)

    def retry_after(self) -> float | None:
        return parse_retry_after(self.header("Retry-After"))

    def message(self) -> str:
        try:
            return json.loads(self.body)["error"]["message"]
        except Exception:  # noqa: BLE001 — non-envelope body
            return self.body.decode("utf-8", "replace")[:200]


class ReplicaStream:
    """Line reader over a live replica response body that KNOWS the
    difference between a clean end and a truncation.

    ``next_line()`` returns one payload line (newline included), or
    ``None`` at a CLEAN end (terminal chunk / Content-Length
    satisfied), and raises :class:`TransportLoss` when the peer
    vanishes mid-body — the distinction ``http.client`` erases."""

    def __init__(self, sock: socket.socket, buffered: bytes, *,
                 chunked: bool, length: int | None):
        self._sock = sock
        self._raw = bytearray(buffered)  # undecoded wire bytes
        self._text = bytearray()         # decoded payload bytes
        self._chunked = chunked
        self._length = length  # remaining body bytes (non-chunked)
        self._state = "size" if chunked else "plain"
        self._chunk_left = 0
        self._decode()

    # -- chunked-transfer decoding -------------------------------------------
    def _decode(self) -> None:
        if not self._chunked:
            if self._raw:
                take = (len(self._raw) if self._length is None
                        else min(self._length, len(self._raw)))
                self._text += self._raw[:take]
                del self._raw[:take]
                if self._length is not None:
                    self._length -= take
            # checked OUTSIDE the raw-bytes branch: a Content-Length: 0
            # body must read as ended at construction, not block in
            # recv() waiting for bytes that will never come
            if self._length is not None and self._length <= 0:
                self._state = "end"
            return
        while True:
            if self._state == "size":
                i = self._raw.find(b"\r\n")
                if i < 0:
                    return
                size = int(bytes(self._raw[:i]).split(b";")[0] or b"0", 16)
                del self._raw[:i + 2]
                if size == 0:
                    self._state = "end"  # trailers ignored
                    return
                self._chunk_left = size
                self._state = "data"
            elif self._state == "data":
                if not self._raw:
                    return
                take = min(self._chunk_left, len(self._raw))
                self._text += self._raw[:take]
                del self._raw[:take]
                self._chunk_left -= take
                if self._chunk_left == 0:
                    self._state = "crlf"
            elif self._state == "crlf":
                if len(self._raw) < 2:
                    return
                del self._raw[:2]
                self._state = "size"
            else:
                return

    def next_line(self) -> bytes | None:
        while True:
            nl = self._text.find(b"\n")
            if nl >= 0:
                line = bytes(self._text[:nl + 1])
                del self._text[:nl + 1]
                return line
            if self._state == "end":
                if self._text:  # trailing partial line: still payload
                    line = bytes(self._text)
                    del self._text[:]
                    return line
                return None
            try:
                data = self._sock.recv(65536)
            except (OSError, ValueError) as e:
                raise TransportLoss(f"replica read: {e!r}") from e
            if not data:
                # EOF before the terminal chunk / declared length: the
                # replica DIED — never a clean (shorter) stream
                if self._chunked or (self._length or 0) > 0:
                    raise TransportLoss(
                        "replica closed mid-stream (truncated body)")
                # close-delimited body: EOF IS the end — loop back so
                # the "end" branch flushes a trailing partial line
                self._state = "end"
                continue
            self._raw += data
            self._decode()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def _read_head(sock: socket.socket, buffered: bytearray) -> bytes:
    """Read up to the end of the response headers; returns the head
    bytes, leaving any body bytes in ``buffered``."""
    while b"\r\n\r\n" not in buffered:
        data = sock.recv(65536)
        if not data:
            raise TransportLoss("replica closed before response headers")
        buffered += data
    head, _, rest = bytes(buffered).partition(b"\r\n\r\n")
    del buffered[:]
    buffered += rest
    return head


def _parse_head(head: bytes) -> tuple[int, dict]:
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(None, 2)
    status = int(parts[1])
    headers: dict[str, str] = {}
    for line in lines[1:]:
        k, _, v = line.partition(":")
        if _:
            headers[k.strip().lower()] = v.strip()
    return status, headers


def forward(replica: Replica, path: str, body: bytes, headers: dict,
            *, connect_timeout_s: float = 2.0,
            read_timeout_s: float = 120.0):
    """POST ``body`` to ``replica``. Returns ``("stream", stream)``
    for a 2xx (live) or ``("response", ReplicaResponse)`` for
    anything else (connection closed). Raises TransportLoss for any
    pre-response failure."""
    try:
        sock = socket.create_connection((replica.host, replica.port),
                                        timeout=connect_timeout_s)
    except OSError as e:
        raise TransportLoss(f"connect {replica.address}: {e!r}") from e
    try:
        # connect proved liveness fast; the response read gets the
        # longer budget (a long prefill sits between the request and
        # the first-token-carrying response headers)
        sock.settimeout(read_timeout_s)
        head = [f"POST {path} HTTP/1.1",
                f"Host: {replica.host}:{replica.port}",
                f"Content-Length: {len(body)}",
                "Connection: close"]
        head += [f"{k}: {v}" for k, v in headers.items()]
        sock.sendall(("\r\n".join(head) + "\r\n\r\n").encode("latin-1")
                     + body)
        buffered = bytearray()
        status, resp_headers = _parse_head(_read_head(sock, buffered))
    except TransportLoss:
        sock.close()
        raise
    except (OSError, ValueError) as e:
        sock.close()
        raise TransportLoss(f"request {replica.address}: {e!r}") from e
    chunked = "chunked" in resp_headers.get("transfer-encoding", "")
    length = resp_headers.get("content-length")
    length = int(length) if length is not None else None
    stream = ReplicaStream(sock, bytes(buffered), chunked=chunked,
                           length=length)
    if 200 <= status < 300:
        return "stream", stream
    # buffered reply: drain the body (bounded by the read timeout)
    body_parts = []
    try:
        while True:
            line = stream.next_line()
            if line is None:
                break
            body_parts.append(line)
    except TransportLoss as e:
        raise TransportLoss(
            f"response body {replica.address}: {e}") from e
    finally:
        stream.close()
    return "response", ReplicaResponse(status, resp_headers,
                                       b"".join(body_parts))


def first_line(stream: ReplicaStream) -> bytes:
    """Read the commit point: the replica's first token line. EOF or
    a transport error HERE is still pre-delivery — the caller may
    fail over."""
    line = stream.next_line()
    if line is None:
        raise TransportLoss("replica ended the stream before the "
                            "first token")
    return line


def error_line(message: str, status: int = 503,
               retry_after: float | None = None) -> bytes:
    detail: dict = {"message": message, "status": int(status)}
    if retry_after is not None:
        detail["retry_after"] = round(float(retry_after), 3)
    return (json.dumps({"error": detail}) + "\n").encode()


def relay_lines(first: bytes, stream: ReplicaStream, replica: Replica,
                *, retry_after: float = 1.0, on_loss=None):
    """Generator the gateway hands to ``ctx.stream``: the committed
    first line, then every further replica line verbatim, each
    flushed to the client as it arrives. A mid-stream replica loss
    (SIGKILL, network, truncation) emits ONE typed error line and
    ends the stream — the client sees tokens 1..k then a parseable
    typed 503. The replica's
    in-flight count brackets the whole relay (drain observability)."""
    with replica._lock:
        replica.inflight += 1
    try:
        yield first
        while True:
            try:
                line = stream.next_line()
            except (TransportLoss, OSError) as e:
                if on_loss is not None:
                    on_loss(replica, e)
                yield error_line(
                    f"replica {replica.address} lost mid-stream",
                    status=503, retry_after=retry_after)
                return
            if line is None:
                return  # clean end: the terminal chunk arrived
            yield line
    finally:
        with replica._lock:
            replica.inflight -= 1
        stream.close()
