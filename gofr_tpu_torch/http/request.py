"""Transport-level HTTP request implementing the framework Request surface.

Reference: pkg/gofr/http/request.go:22-77 — query/path params, JSON ``Bind``
with body re-buffering, JWT claims accessor, hostname. The abstract Request
interface the handlers see is defined at pkg/gofr/request.go:10-16
(Context/Param/PathParam/Bind/HostName); pub/sub Messages implement the same
surface (datasource/pubsub/message.go:8-50) so one handler shape serves both.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping
from urllib.parse import parse_qs, unquote, urlsplit

from ..errors import BadRequest


class Request:
    def __init__(
        self,
        method: str = "GET",
        path: str = "/",
        headers: Mapping[str, str] | None = None,
        body: bytes = b"",
        path_params: Mapping[str, str] | None = None,
        remote_addr: str = "",
    ):
        self.method = method.upper()
        split = urlsplit(path)
        # decode %XX escapes so path params and query params are consistent
        self.path = unquote(split.path) or "/"
        self.query: dict[str, list[str]] = parse_qs(split.query, keep_blank_values=True)
        # header lookup is case-insensitive
        self._headers = {k.lower(): v for k, v in (headers or {}).items()}
        self.body = body
        self.path_params: dict[str, str] = dict(path_params or {})
        self.remote_addr = remote_addr
        self.claims: dict[str, Any] | None = None  # set by OAuth middleware

    # -- framework Request interface ---------------------------------------
    def param(self, key: str, default: str = "") -> str:
        """First query-string value (reference request.go Param)."""
        vals = self.query.get(key)
        return vals[0] if vals else default

    def params(self, key: str) -> list[str]:
        return self.query.get(key, [])

    def path_param(self, key: str, default: str = "") -> str:
        return self.path_params.get(key, default)

    def header(self, key: str, default: str = "") -> str:
        return self._headers.get(key.lower(), default)

    @property
    def headers(self) -> dict[str, str]:
        return dict(self._headers)

    def host_name(self) -> str:
        proto = self._headers.get("x-forwarded-proto", "http")
        return f"{proto}://{self._headers.get('host', '')}"

    def content_type(self) -> str:
        return self._headers.get("content-type", "")

    def bind(self, into: type | None = None) -> Any:
        """Deserialize the JSON body; optionally into a dataclass
        (reference request.go:41-48 Bind unmarshals into a target struct)."""
        if not self.body:
            raise BadRequest("request body is empty")
        try:
            data = json.loads(self.body)
        except json.JSONDecodeError as e:
            raise BadRequest(f"invalid JSON body: {e}") from e
        if into is None:
            return data
        if dataclasses.is_dataclass(into):
            names = {f.name for f in dataclasses.fields(into)}
            if not isinstance(data, dict):
                raise BadRequest("JSON body must be an object")
            return into(**{k: v for k, v in data.items() if k in names})
        if callable(into):
            return into(data)
        raise BadRequest(f"cannot bind into {into!r}")

    def get_claims(self) -> dict[str, Any]:
        """JWT claims the OAuth middleware placed (empty without one)."""
        return self.claims or {}
