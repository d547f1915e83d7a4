"""Router with path templates and a middleware chain.

Reference: pkg/gofr/http/router.go:13-34 wraps gorilla/mux and installs the
Tracer -> Logging -> CORS -> Metrics middleware chain. Here routes are
``/path/{param}`` templates compiled to regexes; middleware are
``Callable[[Handler], Handler]`` wrappers applied outermost-first, exactly the
order the reference uses.
"""

from __future__ import annotations

import re
from typing import Callable

from .request import Request
from .responder import ResponseWriter

# A transport handler: consumes the request, fills the writer.
Handler = Callable[[Request, ResponseWriter], None]
Middleware = Callable[[Handler], Handler]

_PARAM_RE = re.compile(r"\{([a-zA-Z_][a-zA-Z0-9_]*)\}")


def compile_template(path: str) -> re.Pattern:
    parts: list[str] = []
    idx = 0
    for m in _PARAM_RE.finditer(path):
        parts.append(re.escape(path[idx:m.start()]))
        parts.append(f"(?P<{m.group(1)}>[^/]+)")
        idx = m.end()
    parts.append(re.escape(path[idx:]))
    return re.compile("^" + "".join(parts) + "/?$")


class Route:
    def __init__(self, method: str, path: str, handler: Handler):
        self.method = method.upper()
        self.path = path
        self.pattern = compile_template(path)
        self.handler = handler


class Router:
    def __init__(self) -> None:
        self.routes: list[Route] = []
        self.middleware: list[Middleware] = []
        self._catch_all: Handler | None = None
        self._compiled: Handler | None = None

    def add(self, method: str, path: str, handler: Handler) -> None:
        self.routes.append(Route(method, path, handler))
        self._compiled = None

    def use(self, mw: Middleware) -> None:
        """Append middleware (reference router.go:19-24 UseMiddleware)."""
        self.middleware.append(mw)
        self._compiled = None

    def set_catch_all(self, handler: Handler) -> None:
        """404 fallthrough route (reference handler.go:57 catchAllHandler)."""
        self._catch_all = handler
        self._compiled = None

    # -- dispatch -----------------------------------------------------------
    def _dispatch(self, req: Request, w: ResponseWriter) -> None:
        path_matched = False
        for route in self.routes:
            m = route.pattern.match(req.path)
            if m is None:
                continue
            path_matched = True
            if route.method == req.method:
                req.path_params.update(m.groupdict())
                # route template for low-cardinality metrics labels
                req.matched_route = route.path  # type: ignore[attr-defined]
                route.handler(req, w)
                return
        if self._catch_all is not None:
            self._catch_all(req, w)
            return
        w.status = 405 if path_matched else 404
        w.set_header("Content-Type", "application/json")
        w.write(b'{"error":{"message":"route not found"}}' if w.status == 404
                else b'{"error":{"message":"method not allowed"}}')

    def handler(self) -> Handler:
        """Compose middleware around dispatch; first-added runs outermost."""
        if self._compiled is None:
            h: Handler = self._dispatch
            for mw in reversed(self.middleware):
                h = mw(h)
            self._compiled = h
        return self._compiled

    def __call__(self, req: Request, w: ResponseWriter) -> None:
        self.handler()(req, w)
