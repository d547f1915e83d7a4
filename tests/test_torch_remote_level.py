"""The remote log level of both packages (gofr_tpu/remote_level.py and
the port's gofr_tpu_torch/remote_level.py): ``poll_once`` with a stub
``http_get`` sets the same level for each payload shape either accepts,
leaves it as it was for a bad payload, and ``Logger.change_level`` logs
the change once; the poller's daemon thread polls on its interval and
ends with ``stop()``, which the Container's ``close()`` and the App's
``stop()`` call.
"""

import io
import json
import threading
import time

import pytest

import gofr_tpu
import gofr_tpu_torch
from gofr_tpu import glog as jglog
from gofr_tpu import remote_level as jremote
from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu_torch import glog as pglog
from gofr_tpu_torch import remote_level as premote
from gofr_tpu_torch.config import MapConfig

PACKAGES = {"jax": (jglog, jremote, JMapConfig, gofr_tpu.App),
            "port": (pglog, premote, MapConfig, gofr_tpu_torch.App)}
# a localhost port nothing listens on: a default fetch fails at once
URL = "http://127.0.0.1:1/level"
BASE = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "INFO"}

GOOD = [
    ({"data": {"logLevel": "DEBUG"}}, "DEBUG"),
    ({"data": {"LOG_LEVEL": "warn"}}, "WARN"),
    ({"data": {"level": " error "}}, "ERROR"),
    ({"level": "NOTICE"}, "NOTICE"),
    ({"data": [{"logLevel": "FATAL"}, {"logLevel": "DEBUG"}]}, "FATAL"),
    ({"data": {"logLevel": {"value": "Debug"}}}, "DEBUG"),
    ({"data": {"serviceName": "x", "logLevel": "INFO"}}, "INFO"),
]
BAD = [b"not json", b"[]", b'"DEBUG"', b"{}", b'{"data": {}}',
       b'{"data": []}', b'{"data": {"logLevel": "LOUD"}}',
       b'{"data": {"logLevel": 3}}', b'{"data": {"logLevel": {"v": 1}}}',
       None]


@pytest.fixture(params=sorted(PACKAGES))
def pk(request):
    return request.param


def _logger(pk, level="WARN"):
    glog = PACKAGES[pk][0]
    out = io.StringIO()
    return glog.Logger(level=glog.LogLevel[level], out=out, err=out,
                       pretty=False), out


def _poller(pk, log, get, interval=3600.0):
    return PACKAGES[pk][1].RemoteLevelPoller(log, URL, interval,
                                             http_get=get)


def test_extract_level_is_the_same_for_every_payload():
    payloads = [p for p, _ in GOOD] + [json.loads(b) for b in BAD[1:-1]]
    assert [premote._extract_level(p) for p in payloads] == \
        [jremote._extract_level(p) for p in payloads]


@pytest.mark.parametrize("payload,want", GOOD,
                         ids=[str(i) for i in range(len(GOOD))])
def test_poll_once_sets_the_same_level_for_each_accepted_shape(payload,
                                                               want):
    got = {}
    for pk in PACKAGES:
        log, out = _logger(pk)
        p = _poller(pk, log, lambda url: json.dumps(payload).encode())
        try:
            p.poll_once()
        finally:
            p.stop()
        got[pk] = (log.level.name, [json.loads(ln)["message"] for ln in
                                    out.getvalue().splitlines()])
    assert got["port"] == got["jax"]
    assert got["port"][0] == want


@pytest.mark.parametrize("body", BAD, ids=[str(i) for i in range(len(BAD))])
def test_a_bad_payload_leaves_the_level_as_it_was(pk, body):
    log, out = _logger(pk, "NOTICE")

    def get(url):
        if body is None:
            raise OSError("connection refused")
        return body

    p = _poller(pk, log, get)
    try:
        p.poll_once()
    finally:
        p.stop()
    assert log.level.name == "NOTICE"
    assert out.getvalue() == ""


def test_change_level_logs_a_change_once(pk):
    log, out = _logger(pk, "INFO")
    glog = PACKAGES[pk][0]
    log.debug("hidden")
    log.change_level(glog.LogLevel.DEBUG)
    log.change_level(glog.LogLevel.DEBUG)   # no change, no line
    log.debug("shown")
    lines = [json.loads(ln)["message"] for ln in out.getvalue().splitlines()]
    assert lines == [{"event": "log level changed", "to": "DEBUG"}, "shown"]


def test_the_thread_polls_on_its_interval_and_stop_ends_it(pk):
    log, _ = _logger(pk, "INFO")
    calls = []
    seen = threading.Event()

    def get(url):
        calls.append(url)
        seen.set()
        return b'{"data": {"logLevel": "ERROR"}}'

    p = _poller(pk, log, get, interval=0.01)
    assert p._thread.daemon and p._thread.name == "remote-log-level"
    assert seen.wait(10)
    p.stop()
    p._thread.join(timeout=10)
    assert not p._thread.is_alive()
    n = len(calls)
    time.sleep(0.05)
    assert len(calls) == n and calls[0] == URL
    assert log.level.name == "ERROR"


def test_an_app_s_stop_ends_its_poller_and_its_container_s_close_too(pk):
    glog, _, cfg, app_cls = PACKAGES[pk]
    kw = {"device": "cpu"} if pk == "port" else {}
    app = app_cls(cfg(dict(BASE, REMOTE_LOG_URL=URL,
                           REMOTE_LOG_FETCH_INTERVAL="0.01")), **kw)
    poller = app.container._remote_level_poller
    assert poller.logger is app.container.logger
    assert poller.interval == 0.01 and poller._thread.is_alive()
    # a stub that answers: the level reaches the App's logger
    poller._http_get = lambda url: b'{"data": {"logLevel": "ERROR"}}'
    end = time.monotonic() + 10
    while app.logger.level != glog.LogLevel.ERROR and time.monotonic() < end:
        time.sleep(0.01)
    assert app.logger.level == glog.LogLevel.ERROR
    app.stop()
    poller._thread.join(timeout=10)
    assert not poller._thread.is_alive()
