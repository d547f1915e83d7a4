"""The App: one object running the HTTP server, the gRPC server and the
metrics server over a container that holds the engine (the port's own
copy of the HTTP and gRPC halves of gofr_tpu/app.py; a service moves to
the port by changing its imports, ``from gofr_tpu_torch import App`` and
``from gofr_tpu_torch.grpcx import GRPCService, ServerStream``).

    app = App(device="cuda")          # TPU_* rows build ctx.tpu on the card
    install_generate(app)             # POST /generate (Llama; serving.py)
    install_embeddings(app)           # POST /v1/embeddings (BERT)
    app.register_grpc_service(llm)    # served on GRPC_PORT (default 9000)

    @app.subscribe("images")          # PUBSUB_BACKEND: one consumer thread
    def classify(ctx): ...            # a topic, commit on success
    app.run()

Reference: pkg/gofr/gofr.go -- route registration (gofr.go:190-207),
RegisterService (gofr.go:49-53), Subscribe (subscriber.go:11-46) and Run
(gofr.go:108-164): the metrics server, the default routes (health,
alive, favicon), the HTTP server, the gRPC server, then the
subscribers. ``run(block=False)`` and ``stop()`` make an App testable
in-process; ``stop(grace_s)`` drains it, stopping the subscribers
first.

``device`` reaches the container's engine and nothing else: an App with
no ``TPU_MODEL``/``TPU_ENABLED`` row touches no device. The CLI,
migrations, outbound HTTP services, the gateway (its rows raise at
construction, as does any serving role but ``fused``), the auth and
tenant middlewares (``X-Tenant-Id``, gRPC's ``x-tenant-id``) and the
``/debug`` pages other than ``/debug/cache`` and ``/debug/vars`` (the
latter reduced to the memory arbiter's sections) are not ported yet.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable

from .config import EnvConfig
from .container import Container
from .context import Context
from .http.middleware import (cors_middleware, deadline_middleware,
                              drain_middleware, inflight_middleware,
                              logging_middleware, metrics_middleware,
                              slo_class_middleware, tracer_middleware)
from .http.request import Request
from .http.responder import Responder, ResponseWriter
from .http.router import Router
from .http.server import HTTPServer
from .metrics import update_system_metrics
from .observe.debug import install_debug_routes
from .static import FAVICON_ICO
from .subscriber import SubscriptionManager

__version__ = "0.1.0-dev"

# Default ports (reference pkg/gofr/default.go:3-7)
DEFAULT_HTTP_PORT = 8000
DEFAULT_METRICS_PORT = 2121
DEFAULT_GRPC_PORT = 9000

HandlerFunc = Callable[[Context], Any]


class App:
    def __init__(self, config=None, config_folder: str = "./configs",
                 device="cuda"):
        self.config = config if config is not None else EnvConfig(
            config_folder)
        self.container = Container(self.config, device=device)
        self.logger = self.container.logger

        self.router = Router()
        self._http_registered = False
        self.http_port = self.config.get_int("HTTP_PORT", DEFAULT_HTTP_PORT)
        self.metrics_port = self.config.get_int("METRICS_PORT",
                                                DEFAULT_METRICS_PORT)
        self.grpc_port = self.config.get_int("GRPC_PORT", DEFAULT_GRPC_PORT)
        self._http_server: HTTPServer | None = None
        self._metrics_server: HTTPServer | None = None
        self._grpc_server = None
        self._grpc_services: list = []
        self.subscription_manager = SubscriptionManager(self.container)
        self._running = threading.Event()
        # graceful-drain readiness: flipped FIRST in stop(grace_s>0) so
        # load balancers stop routing before the engine stops serving
        self._draining = False
        self._drain_retry_after: float | None = None

        # Middleware chain in the JAX App's order: the drain gate
        # outermost (a draining server rejects before any span or log
        # work), then Tracer, the in-flight registry (its entries carry
        # the trace id), Logging(+recovery), the deadline and SLO-class
        # scopes (inside logging, so 504s are logged with their status),
        # CORS, Metrics.
        self.router.use(drain_middleware(lambda: self._draining,
                                         lambda: self._drain_retry_after))
        self.router.use(tracer_middleware(self.container.tracer))
        self.router.use(inflight_middleware(self.container.requests))
        self.router.use(logging_middleware(self.logger))
        self.router.use(deadline_middleware())
        self.router.use(slo_class_middleware())
        self.router.use(cors_middleware())
        self.router.use(metrics_middleware(self.container.metrics))

    # -- handler adaptation (reference handler.go:32-36) --------------------
    def _adapt(self, fn: HandlerFunc):
        def transport_handler(req: Request, w: ResponseWriter) -> None:
            ctx = Context(request=req, container=self.container,
                          responder=Responder(w))
            with ctx.trace("gofr-handler"):
                try:
                    data = fn(ctx)
                except Exception as e:
                    Responder(w).respond(None, e)
                    if not hasattr(e, "status_code"):
                        raise  # let logging middleware record the traceback
                    return
            if w._streaming or (w.body and data is None):
                return  # handler streamed or wrote directly
            Responder(w).respond(data, None)
        transport_handler.__name__ = getattr(fn, "__name__", "handler")
        return transport_handler

    def add_route(self, method: str, path: str, fn: HandlerFunc) -> None:
        """Register a handler and mark HTTP serving on."""
        self._http_registered = True
        self.router.add(method, path, self._adapt(fn))

    def _route(self, method: str, path: str, fn: HandlerFunc | None):
        """``app.get("/x", handler)`` or ``@app.get("/x")``."""
        if fn is not None:
            self.add_route(method, path, fn)
            return fn

        def deco(f: HandlerFunc) -> HandlerFunc:
            self.add_route(method, path, f)
            return f
        return deco

    def get(self, path: str, fn: HandlerFunc | None = None):
        return self._route("GET", path, fn)

    def post(self, path: str, fn: HandlerFunc | None = None):
        return self._route("POST", path, fn)

    def put(self, path: str, fn: HandlerFunc | None = None):
        return self._route("PUT", path, fn)

    def patch(self, path: str, fn: HandlerFunc | None = None):
        return self._route("PATCH", path, fn)

    def delete(self, path: str, fn: HandlerFunc | None = None):
        return self._route("DELETE", path, fn)

    def register_grpc_service(self, service) -> None:
        """Serve a ``grpcx.GRPCService`` on ``GRPC_PORT`` once the App
        runs (reference App.RegisterService, gofr.go:49-53)."""
        self._grpc_services.append(service)

    def subscribe(self, topic: str, fn: HandlerFunc | None = None):
        """``app.subscribe("t", handler)`` or ``@app.subscribe("t")``: one
        consumer thread for the topic once the App runs; the handler gets
        a Context over the message, and its message is committed when it
        returns (the JAX App's ``subscribe``)."""
        if fn is None:
            def deco(f: HandlerFunc) -> HandlerFunc:
                self.subscription_manager.register(topic, f)
                return f
            return deco
        self.subscription_manager.register(topic, fn)
        return fn

    # -- default routes (reference gofr.go:125-141, handler.go:38-57) --------
    def _install_default_routes(self) -> None:
        def health(req: Request, w: ResponseWriter) -> None:
            w.set_header("Content-Type", "application/json")
            w.write(json.dumps(
                {"data": self.container.health(),
                 "obs": {"wall_s": time.time(),
                         "metrics_port": self.metrics_port}},
                default=str).encode())

        def alive(req: Request, w: ResponseWriter) -> None:
            w.set_header("Content-Type", "application/json")
            w.write(b'{"data":{"status":"UP"}}')

        def favicon(req: Request, w: ResponseWriter) -> None:
            w.set_header("Content-Type", "image/x-icon")
            w.write(FAVICON_ICO)

        self.router.add("GET", "/.well-known/health", health)
        self.router.add("GET", "/.well-known/alive", alive)
        self.router.add("GET", "/favicon.ico", favicon)

    def _metrics_router(self) -> Router:
        r = Router()

        def metrics_handler(req: Request, w: ResponseWriter) -> None:
            update_system_metrics(self.container.metrics)
            # content negotiation (OpenMetrics spec): only an explicit
            # Accept for application/openmetrics-text gets the exemplar-
            # carrying exposition; every other scraper keeps the
            # Prometheus 0.0.4 text format
            accept = req.header("Accept") or ""
            if "application/openmetrics-text" in accept:
                w.set_header("Content-Type", "application/openmetrics-text; "
                                             "version=1.0.0; charset=utf-8")
                w.write(self.container.metrics.render_openmetrics().encode())
                return
            w.set_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
            w.write(self.container.metrics.render_prometheus().encode())

        r.add("GET", "/metrics", metrics_handler)
        install_debug_routes(r, self)
        return r

    # -- lifecycle (reference gofr.go:108-164 Run) ---------------------------
    def run(self, block: bool = True) -> None:
        c = self.container
        self.logger.info({"event": "starting app", "name": c.app_name,
                          "version": c.app_version, "framework": __version__})
        self._metrics_server = HTTPServer(self._metrics_router(),
                                          self.metrics_port, self.logger)
        self._metrics_server.start()
        self.metrics_port = self._metrics_server.port
        if self._http_registered:
            self._install_default_routes()
            self._http_server = HTTPServer(self.router, self.http_port,
                                           self.logger)
            self._http_server.start()
            self.http_port = self._http_server.port
        if self._grpc_services:
            from .grpcx.server import GRPCServer

            self._grpc_server = GRPCServer(
                self._grpc_services, self.grpc_port, self.container)
            self._grpc_server.start()
            self.grpc_port = self._grpc_server.port
        if self.subscription_manager.subscriptions:
            self.subscription_manager.start()
        self._running.set()
        if block:
            try:
                threading.Event().wait()
            except KeyboardInterrupt:
                self.stop()

    def stop(self, grace_s: float = 0.0) -> None:
        """Stop the app. ``grace_s > 0`` drains first, and the FIRST act
        of the grace window is flipping readiness: ``/.well-known/health``
        answers 503 + Retry-After and gRPC health NOT_SERVING, and every
        new request gets 503 or UNAVAILABLE with a retry-after, so load
        balancers stop routing BEFORE the engine stops serving. Pub/sub
        consumption stops next (a handler running finishes), the
        generation engine then finishes every accepted stream, and the
        in-flight HTTP requests and RPCs finish on their handler threads,
        with the listeners still up (clients receive complete streams
        over their live connections), all within ``grace_s``; then
        everything tears down."""
        grpc = self._grpc_server
        if grace_s > 0:
            self._drain_retry_after = grace_s
            self._draining = True
            if grpc is not None:
                grpc.start_draining(retry_after=grace_s)
            self.logger.info({"event": "drain started: readiness down",
                              "grace_s": grace_s})
            self.subscription_manager.stop()
            t_end = time.monotonic() + grace_s
            gen = getattr(self.container.tpu, "generator", None)
            if gen is not None:
                drained = gen.drain(grace_s)
                self.logger.info({"event": "generation engine drained",
                                  "clean": drained})
            # an RPC whose stream the engine has ended still writes its
            # trailers on its handler thread: wait for those as for the
            # HTTP handlers, or the GOAWAY below could overtake them
            reg = self.container.requests

            def inflight() -> int:
                return len(reg) + (grpc.inflight() if grpc is not None
                                   else 0)

            while time.monotonic() < t_end and inflight():
                time.sleep(0.02)
            self.logger.info({"event": "http in-flight drained",
                              "remaining": inflight()})
        for srv in (self._http_server, self._metrics_server):
            if srv is not None:
                srv.stop()
        if grpc is not None:
            grpc.stop()
        self.subscription_manager.stop()
        self.container.close()
        self._running.clear()

    def __enter__(self) -> "App":
        self.run(block=False)
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def new_app(config=None, **kw) -> App:
    """reference gofr.New (gofr.go:56)."""
    return App(config, **kw)
