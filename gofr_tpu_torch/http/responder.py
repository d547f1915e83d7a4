"""Response serialization: JSON envelope ``{"data": ...}`` / ``{"error": ...}``.

Reference: pkg/gofr/http/responder.go:19-57 (Respond + HTTPStatusFromError)
and pkg/gofr/http/response/ (Raw, File).
"""

from __future__ import annotations

import dataclasses
import json
import mimetypes
import os
from typing import Any

from ..errors import HTTPError, status_from_error


class ResponseWriter:
    """Accumulates status/headers/body; the server flushes it to the socket.
    Also plays the reference's StatusResponseWriter role
    (middleware/logger.go:14-31) — middleware reads ``status`` after the
    handler ran."""

    def __init__(self) -> None:
        self.status: int = 200
        self.headers: dict[str, str] = {}
        self.body: bytes = b""
        self._streaming: bool = False
        self._chunks: list[bytes] = []

    def set_header(self, key: str, value: str) -> None:
        self.headers[key] = value

    def write(self, data: bytes) -> None:
        self.body += data

    def write_chunk(self, data: bytes) -> None:
        """Streaming (chunked/SSE) support — no reference equivalent; needed
        for token streaming over HTTP."""
        self._streaming = True
        self._chunks.append(data)

    def stream_from(self, source) -> None:
        """Drain a chunk source (any iterable of bytes). The live HTTP
        server replaces this per-request with a zero-handoff writer
        that lets a push-capable source (``GenStream.map(...)``, see
        gofr_tpu.wire.PushStream) deliver chunks on the producing
        thread; this default just iterates, which keeps handler tests
        and non-streaming servers working unchanged."""
        for chunk in source:
            self.write_chunk(bytes(chunk))


class Raw:
    """Bypass the envelope: serialize ``data`` as-is
    (reference response/raw.go)."""

    def __init__(self, data: Any):
        self.data = data


class FileResponse:
    """Serve file bytes with a content type (reference response/file.go)."""

    def __init__(self, content: bytes, content_type: str | None = None, name: str = ""):
        self.content = content
        self.name = name
        if content_type is None and name:
            content_type = mimetypes.guess_type(name)[0]
        self.content_type = content_type or "application/octet-stream"

    @classmethod
    def from_path(cls, path: str) -> "FileResponse":
        with open(path, "rb") as f:
            return cls(f.read(), name=os.path.basename(path))


def _jsonable(data: Any) -> Any:
    if dataclasses.is_dataclass(data) and not isinstance(data, type):
        return dataclasses.asdict(data)
    if hasattr(data, "to_dict"):
        return data.to_dict()
    if isinstance(data, (list, tuple)):
        return [_jsonable(d) for d in data]
    if isinstance(data, dict):
        return {k: _jsonable(v) for k, v in data.items()}
    if isinstance(data, bytes):
        return data.decode("utf-8", "replace")
    return data


class Responder:
    """Serializes (data, error) to the wire (reference responder.go:19-45)."""

    def __init__(self, writer: ResponseWriter):
        self.writer = writer

    def respond(self, data: Any, error: BaseException | None = None) -> None:
        w = self.writer
        if error is not None:
            status = status_from_error(error)
            detail = (error.to_dict() if isinstance(error, HTTPError)
                      else {"message": str(error) or "internal server error"})
            w.status = status
            # errors may carry response headers (TooManyRequests ->
            # Retry-After; drain -> Retry-After): honest backpressure
            # the client-side retry policy reads
            for k, v in getattr(error, "headers", {}).items():
                w.set_header(k, str(v))
            w.set_header("Content-Type", "application/json")
            w.write(json.dumps({"error": detail}, default=str).encode())
            return
        if isinstance(data, FileResponse):
            w.set_header("Content-Type", data.content_type)
            w.write(data.content)
            return
        if isinstance(data, Raw):
            w.set_header("Content-Type", "application/json")
            w.write(json.dumps(_jsonable(data.data), default=str).encode())
            return
        w.set_header("Content-Type", "application/json")
        w.write(json.dumps({"data": _jsonable(data)}, default=str).encode())
