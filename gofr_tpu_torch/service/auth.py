"""Client auth decorators: basic, API key, OAuth2 client-credentials (the
port's own copy of gofr_tpu/service/auth.py).

Reference: pkg/gofr/service/basic_auth.go:9-40 (pre-encoded password),
apikey_auth.go:8-85 (X-API-KEY header), oauth.go:15-67 (client-credentials
token source injecting Bearer tokens). Each wraps the verb surface adding
one header — here via ServiceWrapper._do.
"""

from __future__ import annotations

import base64
import json
import threading
import time
import urllib.parse
import urllib.request

from .wrap import ServiceWrapper, set_header_default


class BasicAuth(ServiceWrapper):
    def __init__(self, inner, username: str, password: str):
        super().__init__(inner)
        token = base64.b64encode(f"{username}:{password}".encode()).decode()
        self._header = f"Basic {token}"

    def _do(self, method, path, params, body, headers):
        headers = dict(headers or {})
        set_header_default(headers, "Authorization", self._header)
        return super()._do(method, path, params, body, headers)


class BasicAuthOption:
    def __init__(self, username: str, password: str):
        self.username, self.password = username, password

    def add_option(self, svc):
        return BasicAuth(svc, self.username, self.password)


class APIKeyAuth(ServiceWrapper):
    def __init__(self, inner, api_key: str, header_name: str = "X-API-KEY"):
        super().__init__(inner)
        self.api_key = api_key
        self.header_name = header_name

    def _do(self, method, path, params, body, headers):
        headers = dict(headers or {})
        set_header_default(headers, self.header_name, self.api_key)
        return super()._do(method, path, params, body, headers)


class APIKeyAuthOption:
    def __init__(self, api_key: str, header_name: str = "X-API-KEY"):
        self.api_key, self.header_name = api_key, header_name

    def add_option(self, svc):
        return APIKeyAuth(svc, self.api_key, self.header_name)


class _TokenSource:
    """Client-credentials token fetcher with expiry-aware caching
    (reference oauth.go:15-44 wraps clientcredentials.Config)."""

    def __init__(self, token_url: str, client_id: str, client_secret: str,
                 scopes: tuple[str, ...] = (), fetch=None):
        self.token_url = token_url
        self.client_id = client_id
        self.client_secret = client_secret
        self.scopes = scopes
        self._fetch = fetch or self._fetch_http
        self._token: str | None = None
        self._expires_at = 0.0
        self._lock = threading.Lock()

    def _fetch_http(self) -> dict:
        form = {"grant_type": "client_credentials",
                "client_id": self.client_id,
                "client_secret": self.client_secret}
        if self.scopes:
            form["scope"] = " ".join(self.scopes)
        req = urllib.request.Request(
            self.token_url, data=urllib.parse.urlencode(form).encode(),
            headers={"Content-Type": "application/x-www-form-urlencoded"})
        with urllib.request.urlopen(req, timeout=10.0) as resp:
            return json.loads(resp.read())

    def token(self) -> str:
        with self._lock:
            now = time.monotonic()
            if self._token is None or now >= self._expires_at:
                payload = self._fetch()
                self._token = payload["access_token"]
                # refresh 30s before expiry; default 1h if server omits it
                ttl = float(payload.get("expires_in", 3600))
                self._expires_at = now + max(ttl - 30.0, 1.0)
            return self._token


class OAuth(ServiceWrapper):
    def __init__(self, inner, source: _TokenSource):
        super().__init__(inner)
        self.source = source

    def _do(self, method, path, params, body, headers):
        headers = dict(headers or {})
        set_header_default(headers, "Authorization", f"Bearer {self.source.token()}")
        return super()._do(method, path, params, body, headers)


class OAuthOption:
    def __init__(self, token_url: str, client_id: str, client_secret: str,
                 scopes: tuple[str, ...] = (), fetch=None):
        self.source = _TokenSource(token_url, client_id, client_secret, scopes, fetch)

    def add_option(self, svc):
        return OAuth(svc, self.source)
