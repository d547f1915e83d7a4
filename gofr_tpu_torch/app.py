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
    app.add_http_service("llm", "http://10.0.0.2:8000",
                         CircuitBreakerOption(threshold=3, interval=5.0))
    app.enable_apikey_auth("key")     # or enable_basic_auth / enable_oauth
    app.run()

``TPU_SERVING_ROLE=gateway`` turns the App into the prefix-affinity
front door over ``TPU_GATEWAY_REPLICAS`` (gofr_tpu_torch/gateway): it
builds no engine, registers ``POST <TPU_GATEWAY_PATH>`` and ``GET
/gateway/stats``, lists each replica's health client under ``services``
in ``/.well-known/health``, starts the replica health poller in
``run()``, and in ``stop(grace_s)`` lets its in-flight relays finish
before it closes. A missing replica list raises, and so does a
``TPU_MODEL`` row on a gateway App ("builds no engine").
``TPU_SERVING_ROLE=prefill`` or ``decode`` makes the App one pool of a
disaggregated pair (gofr_tpu_torch/pd): its engine's ``generate``
relays through the decode peer, or its engine takes shipped KV on
``TPU_PD_LISTEN`` (advertising the metrics port to its peers).

A CLI App (``new_cmd``) runs sub-commands instead of servers, over the
same Container (``TPU_MODEL`` builds the same engine, ``DB_DIALECT`` the
SQL datasource)::

    app = new_cmd(device="cuda")      # CMD_LOGS_FILE: the logs to a file
    app.migrate({1: Migrate(up=lambda ds: ds.sql.execute("CREATE ..."))})

    @app.sub_command("generate", description="-prompt 1,2,3 -max 32")
    def generate(ctx): ...            # ctx.param("prompt"), ctx.tpu, ctx.sql

    raise SystemExit(app.run_command())   # sys.argv[1:]: 0, or 1 on error

Reference: pkg/gofr/gofr.go -- route registration (gofr.go:190-207),
RegisterService (gofr.go:49-53), Subscribe (subscriber.go:11-46) and Run
(gofr.go:108-164): the metrics server, the default routes (health,
alive, favicon), the HTTP server, the gRPC server, then the
subscribers; the auth enablers (gofr.go:268-302) and AddHTTPService
(gofr.go:177), SubCommand (gofr.go:223), Migrate (gofr.go:227) and
NewCMD (gofr.go:93). ``run(block=False)`` and ``stop()`` make an App
testable in-process; ``stop(grace_s)`` drains it, stopping the
subscribers first.

``device`` reaches the container's engine and nothing else: an App with
no ``TPU_MODEL``/``TPU_ENABLED`` row touches no device. The tenant
middleware scopes ``X-Tenant-Id`` (``TPU_TENANT_HEADER``) as gRPC does
``x-tenant-id``, canonicalised through the engine's tenancy plane when
``TPU_TENANTS`` configures one (``tenancy.install_async_lane(app)`` adds
the async lane). The metrics server carries ``/metrics`` and the
``/debug`` pages (observe/debug.py): the in-flight requests, the flight
recorder, the serving timeline (``?fleet=1`` merges the peers'), one
request's story across processes, ``/debug/vars``, ``/debug/cache``
and the sampling profiler.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Iterable

from .config import EnvConfig
from .container import Container, serving_role
from .context import Context
from .glog import LogLevel
from .http.middleware import (JWKSKeyProvider, apikey_auth_middleware,
                              basic_auth_middleware, cors_middleware,
                              deadline_middleware, drain_middleware,
                              inflight_middleware, logging_middleware,
                              metrics_middleware, oauth_middleware,
                              slo_class_middleware, tenant_middleware,
                              tracer_middleware)
from .http.request import Request
from .http.responder import Responder, ResponseWriter
from .http.router import Router
from .http.server import HTTPServer
from .metrics import update_system_metrics
from .observe.debug import install_debug_routes
from .static import FAVICON_ICO
from .subscriber import SubscriptionManager
from .version import __version__

# Default ports (reference pkg/gofr/default.go:3-7)
DEFAULT_HTTP_PORT = 8000
DEFAULT_METRICS_PORT = 2121
DEFAULT_GRPC_PORT = 9000

HandlerFunc = Callable[[Context], Any]


class App:
    def __init__(self, config=None, config_folder: str = "./configs",
                 device="cuda", logger=None):
        self.config = config if config is not None else EnvConfig(
            config_folder)
        self.container = Container(self.config, logger=logger, device=device)
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
        # (pattern, handler, description) of each sub-command, in order
        self._cmd_routes: list[tuple] = []
        self._running = threading.Event()
        # graceful-drain readiness: flipped FIRST in stop(grace_s>0) so
        # load balancers stop routing before the engine stops serving
        self._draining = False
        self._drain_retry_after: float | None = None
        self._jwks_provider: JWKSKeyProvider | None = None

        # the gateway serving role: its routes are registered here, so
        # user routes may still be added beside them; a missing replica
        # list fails construction
        self._gateway = None
        if serving_role(self.config) == "gateway":
            from .gateway import install_gateway

            try:
                self._gateway = install_gateway(self)
            except BaseException:
                self.container.close()
                raise

        # Middleware chain in the JAX App's order: the drain gate
        # outermost (a draining server rejects before any span or log
        # work), then Tracer, the in-flight registry (its entries carry
        # the trace id), Logging(+recovery), the deadline and SLO-class
        # scopes (inside logging, so 504s are logged with their status),
        # the tenant scope (after the class: a tenant's registry default
        # class must see the request's explicit X-SLO-Class first; the
        # plane is resolved lazily, the engine being built after this
        # chain), CORS, Metrics; the enable_*_auth middlewares come
        # after them, innermost.
        self.router.use(drain_middleware(lambda: self._draining,
                                         lambda: self._drain_retry_after))
        self.router.use(tracer_middleware(self.container.tracer))
        self.router.use(inflight_middleware(self.container.observe.requests))
        self.router.use(logging_middleware(self.logger))
        self.router.use(deadline_middleware())
        self.router.use(slo_class_middleware())
        self.router.use(tenant_middleware(
            lambda: getattr(self.container.tpu, "tenancy", None),
            header=self.config.get("TPU_TENANT_HEADER") or "X-Tenant-Id"))
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

    # -- auth enablers (reference gofr.go:268-302) ---------------------------
    def enable_basic_auth(self, users: dict[str, str] | None = None,
                          validate: Callable[[str, str], bool] | None = None
                          ) -> None:
        self.router.use(basic_auth_middleware(users, validate))

    def enable_apikey_auth(self, *keys: str,
                           validate: Callable[[str], bool] | None = None
                           ) -> None:
        self.router.use(apikey_auth_middleware(keys, validate))

    def enable_oauth(self, jwks_url: str, refresh_interval: float = 300.0,
                     http_get=None) -> None:
        """Bearer JWTs (RS256) checked against the keys at ``jwks_url``,
        refreshed every ``refresh_interval`` seconds on a thread that
        ``stop()`` halts."""
        provider = JWKSKeyProvider(jwks_url, refresh_interval,
                                   http_get=http_get)
        self._jwks_provider = provider
        self.router.use(oauth_middleware(provider))

    # -- outbound services (reference gofr.go:177 AddHTTPService) -----------
    def add_http_service(self, name: str, address: str, *options) -> None:
        """Register ``new_http_service(address, ..., *options)`` as
        ``ctx.get_http_service(name)``; the Container closes it."""
        from .service import new_http_service

        self.container.register_service(
            name, new_http_service(address, self.logger,
                                   self.container.metrics, *options,
                                   tracer=self.container.tracer))

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

    # -- CLI (reference gofr.go:223 SubCommand) ------------------------------
    def sub_command(self, pattern: str, fn: HandlerFunc | None = None,
                    description: str = ""):
        """``app.sub_command("hello", handler)`` or
        ``@app.sub_command("hello")``: ``run_command`` runs the handler
        when the positional arguments, joined by spaces, match
        ``pattern`` in full (a regex; its named groups are path
        params)."""
        if fn is None:
            def deco(f: HandlerFunc) -> HandlerFunc:
                self._cmd_routes.append((pattern, f, description))
                return f
            return deco
        self._cmd_routes.append((pattern, fn, description))
        return fn

    def run_command(self, argv: Iterable[str] | None = None) -> int:
        """Run the sub-command ``argv`` (``sys.argv[1:]`` by default)
        names and return the process exit code (cli.run_cmd)."""
        from .cli import run_cmd

        return run_cmd(self, argv)

    # -- migrations (reference gofr.go:227-229 Migrate) ----------------------
    def migrate(self, migrations: dict) -> None:
        """Apply the pending ``{version: Migrate}`` in version order
        against the Container's datasources (migration.run)."""
        from .migration import run as migration_run

        migration_run(migrations, self.container)

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
        pd_ingest = getattr(c.tpu, "pd_ingest", None)
        if pd_ingest is not None:
            # a decode worker advertises its /debug surface to prefill
            # peers in HELLO_OK
            pd_ingest.debug_port = self.metrics_port
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
        if self._gateway is not None:
            # a constructed App that never runs polls no replica
            self._gateway.table.start()
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
        over their live connections), all within ``grace_s``: a
        gateway's replica relays run inside their handler threads, so
        they drain here too. Then everything tears down: the servers,
        the gateway's health poller, the subscribers, the JWKS refresh
        and the container (its service clients first)."""
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
            reg = self.container.observe.requests

            def inflight() -> int:
                return len(reg) + (grpc.inflight() if grpc is not None
                                   else 0)

            while time.monotonic() < t_end and inflight():
                time.sleep(0.02)
            self.logger.info({"event": "http in-flight drained",
                              "remaining": inflight()})
            if self._gateway is not None:
                self.logger.info({
                    "event": "gateway drained",
                    "clean": not any(r.inflight for r in
                                     self._gateway.table.replicas)})
        for srv in (self._http_server, self._metrics_server):
            if srv is not None:
                srv.stop()
        if grpc is not None:
            grpc.stop()
        if self._gateway is not None:
            # the health poller; the replica clients close with the
            # container's registered services below
            self._gateway.close()
        self.subscription_manager.stop()
        if self._jwks_provider is not None:
            self._jwks_provider.shutdown()
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


def new_cmd(config=None, **kw) -> App:
    """reference gofr.NewCMD (gofr.go:93): the same App, run through
    ``run_command``. ``CMD_LOGS_FILE`` routes the logs to that file
    (gofr.go:98), so stdout carries only the commands' output; the file
    logger is the Container's from its construction, so the engine and
    the datasources log there too."""
    config = config if config is not None else EnvConfig(
        kw.get("config_folder", "./configs"))
    log_file = config.get("CMD_LOGS_FILE")
    if log_file:
        from .glog import new_file_logger

        kw["logger"] = new_file_logger(
            log_file, LogLevel.parse(config.get("LOG_LEVEL")))
    return App(config, **kw)
