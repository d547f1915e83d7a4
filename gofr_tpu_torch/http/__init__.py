"""HTTP transport: server, router, middleware, request/responder (the
port's own copy of gofr_tpu/http/, without the auth middlewares).

Reference: pkg/gofr/http/ (+ middleware/, response/) and httpServer.go.
"""

from .request import Request
from .responder import Responder, Raw, FileResponse, ResponseWriter
from .router import Router, Route
from .server import HTTPServer

__all__ = [
    "Request",
    "Responder",
    "Raw",
    "FileResponse",
    "ResponseWriter",
    "Router",
    "Route",
    "HTTPServer",
]
