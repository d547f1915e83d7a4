"""The port's Redis client (gofr_tpu_torch.datasource.redisclient) over
the port's in-process server (gofr_tpu_torch.testutil.redisfake), the
JAX package's tests/test_redis.py cases for the commands the port's
client has, run on both packages (each client against each server), so
the replies are the JAX client's. The App's ``REDIS_HOST`` client
(``ctx.redis``, its health entry) is held in tests/test_torch_lane.py;
the kv-cache's shared tier builds this client itself.
"""

import pytest

from gofr_tpu.datasource import redisclient as jclient
from gofr_tpu.testutil import redisfake as jfake
from gofr_tpu_torch.datasource import redisclient as pclient
from gofr_tpu_torch.metrics import Manager, register_framework_metrics
from gofr_tpu_torch.testutil import redisfake as pfake

PAIRS = [("port", pclient, pfake), ("jax", jclient, jfake),
         ("port-on-jax-server", pclient, jfake),
         ("jax-on-port-server", jclient, pfake)]


@pytest.fixture(params=PAIRS, ids=[p[0] for p in PAIRS])
def client(request):
    _, cmod, smod = request.param
    srv = smod.FakeRedisServer()
    c = cmod.RedisClient(srv.host, srv.port)
    c.flushdb()
    yield c
    c.close()
    srv.close()


def test_strings(client):
    assert client.ping()
    assert client.set("k", "v")
    assert client.get("k") == "v"
    assert client.get("missing") is None
    assert client.exists("k") == 1
    assert client.delete("k") == 1
    assert client.exists("k") == 0


def test_counters_and_expiry(client):
    assert client.incr("n") == 1
    assert client.incr("n", 5) == 6
    assert client.decr("n", 2) == 4
    client.set("tmp", "x", ex=30)
    assert 0 < client.ttl("tmp") <= 30
    assert client.ttl("no-such-key") == -2
    assert client.expire("n", 60)
    assert client.ttl("n") > 0


def test_binary_values_round_trip(client):
    """KV frames are binary: ``get_bytes`` and ``mget`` keep the bytes
    (``get`` decodes to str)."""
    blob = bytes(range(256)) + b"\xff\xfe\x00raw"
    assert client.set("bin", blob)
    assert client.get_bytes("bin") == blob
    assert client.get_bytes("missing-bin") is None
    client.set("txt", "héllo")
    assert client.get_bytes("txt") == "héllo".encode()
    b1, b2 = b"\x00\x01\x02", bytes([0xff] * 64)
    client.set("m1", b1)
    client.set("m2", b2)
    assert client.mget("m1", "nope", "m2") == [b1, None, b2]
    assert client.mget() == []


def test_keys_pattern(client):
    client.set("user:1", "x")
    client.set("user:2", "y")
    client.set("other", "z")
    assert sorted(client.keys("user:*")) == ["user:1", "user:2"]


def test_pipeline_and_in_band_error_replies(client):
    p = client.pipeline()
    p.set("a", "1").incrby("n", 3).get("a")
    replies = p.execute()
    assert replies[0] == "OK" and replies[1] == 3 and replies[2] == b"1"
    # a failed command's error comes back in its place; the rest run
    replies = client.pipeline().command("SET", "b", "2", "PX", 60000) \
        .command("NOPE").command("GET", "b").execute()
    assert replies[0] == "OK" and replies[2] == b"2"
    assert type(replies[1]).__name__ == "RedisError"


def test_error_reply_raises(client):
    with pytest.raises(Exception) as ei:
        client.command("HGET-FAKE-UNKNOWN", "x")
    assert type(ei.value).__name__ == "RedisError"


def test_reconnect_after_a_dropped_connection(client):
    """The client retries once on a connection broken before the send."""
    client.set("before", "1")
    client._sock.close()
    assert client.ping()
    assert client.get("before") == "1"


def test_the_metrics_hook():
    srv = pfake.FakeRedisServer()
    try:
        m = Manager()
        register_framework_metrics(m)
        c = pclient.RedisClient(srv.host, srv.port, metrics=m)
        c.set("k", "v")
        c.pipeline().get("k").execute()
        text = m.render_prometheus()
        assert 'app_redis_stats' in text and 'type="SET"' in text
        assert 'pipeline[1]' in text
        c.close()
    finally:
        srv.close()
