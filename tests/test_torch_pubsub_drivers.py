"""The gated broker drivers on both packages, against the fake client
seams of tests/test_pubsub_drivers.py (no network, no broker library):
every case there runs on the JAX package's Kafka, Google Cloud Pub/Sub
and MQTT drivers and on the port's own copies
(gofr_tpu_torch.datasource.pubsub.kafka, .google, .mqtt), through the
same ``factory=``, ``publisher=``/``subscriber=`` and
``client_factory=`` seams: publish, subscribe, the offset-precise
commit, topic admin, health, the MQTT queue's overflow. Each case also
holds the two packages' observable results equal on the same script.
"""

from __future__ import annotations

import importlib.util
import threading
import time
import types
from pathlib import Path
from types import SimpleNamespace

import pytest

from gofr_tpu.datasource import STATUS_DOWN as J_DOWN
from gofr_tpu.datasource import STATUS_UP as J_UP
from gofr_tpu.datasource.pubsub.google import GooglePubSubClient as JGoogle
from gofr_tpu.datasource.pubsub.kafka import KafkaClient as JKafka
from gofr_tpu.datasource.pubsub.mqtt import MQTTClient as JMQTT
from gofr_tpu_torch.datasource import STATUS_DOWN, STATUS_UP
from gofr_tpu_torch.datasource.pubsub.google import GooglePubSubClient
from gofr_tpu_torch.datasource.pubsub.kafka import KafkaClient
from gofr_tpu_torch.datasource.pubsub.mqtt import MQTTClient


def _fakes():
    """The fake seams of tests/test_pubsub_drivers.py, loaded from it."""
    path = Path(__file__).with_name("test_pubsub_drivers.py")
    spec = importlib.util.spec_from_file_location("_pubsub_driver_fakes",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


F = _fakes()
PACKAGES = {
    "jax": SimpleNamespace(kafka=JKafka, google=JGoogle, mqtt=JMQTT,
                           up=J_UP, down=J_DOWN),
    "port": SimpleNamespace(kafka=KafkaClient, google=GooglePubSubClient,
                            mqtt=MQTTClient, up=STATUS_UP, down=STATUS_DOWN),
}


@pytest.fixture(params=sorted(PACKAGES))
def pk(request):
    return PACKAGES[request.param]


def _both(script):
    """``script(pk)`` on each package; their results must be equal."""
    out = {name: script(pk) for name, pk in PACKAGES.items()}
    assert out["port"] == out["jax"]
    return out["port"]


# -- kafka ---------------------------------------------------------------------

def test_kafka_publish_subscribe_commit_offset_precise(pk):
    f = F.FakeKafkaFactory()
    client = pk.kafka("b1:9092,b2:9092", consumer_group="g",
                      offset="earliest", factory=f)
    assert client.brokers == ["b1:9092", "b2:9092"]
    assert client.offset == "earliest"
    client.publish("orders", b"one")
    client.publish("orders", b"two")
    m1 = client.subscribe("orders", timeout=0.1)
    assert m1.value == b"one" and m1.topic == "orders"
    assert m1.metadata == {"offset": "0", "partition": "0"}
    m2 = client.subscribe("orders", timeout=0.1)
    assert m2.value == b"two"
    # commit-on-success commits THE MESSAGE's offset, not the position
    m1.commit()
    assert f.committed[("orders", 0)] == 1
    m2.commit()
    assert f.committed[("orders", 0)] == 2
    # the lazy per-topic consumer is cached
    assert client.subscribe("orders", timeout=0.05) is None
    assert list(client._consumers) == ["orders"]


def test_kafka_offset_names(pk):
    for given, want in (("oldest", "earliest"), ("EARLIEST", "earliest"),
                        ("latest", "latest"), ("newest", "latest")):
        assert pk.kafka("b:1", offset=given,
                        factory=F.FakeKafkaFactory()).offset == want


def test_kafka_topic_admin_and_health(pk):
    f = F.FakeKafkaFactory()
    client = pk.kafka("b:9092", factory=f)
    client.create_topic("t1")
    client.delete_topic("t1")
    assert f.created == ["t1"] and f.deleted == ["t1"]
    assert client.health_check().status == pk.up
    f.connected = False
    h = client.health_check()
    assert h.status == pk.down
    assert h.details["backend"] == "KAFKA"
    client.close()


def test_kafka_scripts_agree():
    def script(pk):
        f = F.FakeKafkaFactory()
        c = pk.kafka("b:9092", consumer_group="g", factory=f)
        for v in (b"a", b"b", b"c"):
            c.publish("t", v)
        msgs = [c.subscribe("t", 0.05) for _ in range(4)]
        msgs[2].commit()
        msgs[0].commit()
        return ([None if m is None else (m.value, m.metadata)
                 for m in msgs], dict(f.committed),
                c.health_check().to_dict())

    _both(script)


# -- google --------------------------------------------------------------------

def test_google_publish_subscribe_ack_and_autocreate(pk):
    broker = F.FakeGoogleBroker()
    client = pk.google("proj", subscription_name="svc",
                       publisher=F.FakePublisher(broker),
                       subscriber=F.FakeSubscriber(broker))
    client.publish("events", b"payload")
    assert "projects/proj/topics/events" in broker.topics
    msg = client.subscribe("events", timeout=0.2)
    assert msg.value == b"payload" and msg.metadata == {"k": "v"}
    assert broker.subs == {"projects/proj/subscriptions/svc-events":
                           "projects/proj/topics/events"}
    msg.commit()  # ack
    assert broker.acked == [b"payload"]
    assert client.subscribe("events", timeout=0.05) is None


def test_google_requires_a_project(pk):
    with pytest.raises(ValueError, match="GOOGLE_PROJECT_ID"):
        pk.google("", publisher=object(), subscriber=object())


def test_google_topic_admin_and_health(pk):
    broker = F.FakeGoogleBroker()
    client = pk.google("proj", publisher=F.FakePublisher(broker),
                       subscriber=F.FakeSubscriber(broker))
    client.create_topic("a")
    assert client.health_check().status == pk.up
    assert "projects/proj/topics/a" in client.health_check().details["topics"]
    client.delete_topic("a")
    assert broker.topics == {}
    client.close()
    assert client._subscriber.closed


def test_google_scripts_agree():
    def script(pk):
        broker = F.FakeGoogleBroker()
        c = pk.google("p", subscription_name="s",
                      publisher=F.FakePublisher(broker),
                      subscriber=F.FakeSubscriber(broker))
        c.publish("e", b"1")
        c.publish("e", b"2")
        got = [c.subscribe("e", 0.05) for _ in range(3)]
        for m in got:
            if m is not None:
                m.commit()
        return ([None if m is None else m.value for m in got],
                list(broker.acked), sorted(broker.topics), dict(broker.subs))

    _both(script)


# -- mqtt ----------------------------------------------------------------------

def test_mqtt_publish_subscribe_loopback(pk):
    client = pk.mqtt(broker="test", port=1883, qos=1,
                     client_factory=F.FakeMQTT)
    fake = client._client
    assert fake.connected
    got = {}

    def bg():
        got["msg"] = client.subscribe("sensors", timeout=2.0)

    t = threading.Thread(target=bg)
    t.start()
    for _ in range(100):
        if "sensors" in fake.subscribed:
            break
        time.sleep(0.01)
    client.publish("sensors", b"21.5c")
    t.join(timeout=3)
    msg = got["msg"]
    assert msg.value == b"21.5c" and msg.metadata == {"qos": "1"}
    assert fake.published == [("sensors", b"21.5c", 1, False)]
    msg.commit()  # QoS owns delivery; commit is a no-op but must not raise


def test_mqtt_subscribe_with_function_and_admin(pk):
    client = pk.mqtt(client_factory=F.FakeMQTT)
    fake = client._client
    seen = []
    client.subscribe_with_function("alerts", lambda m: seen.append(m.value))
    client.publish("alerts", b"fire")
    assert seen == [b"fire"]
    client.delete_topic("alerts")  # == unsubscribe
    assert fake.unsubscribed == ["alerts"]
    assert client.ping() and client.health_check().status == pk.up
    client.close()
    assert client.health_check().status == pk.down


def test_mqtt_queue_overflow_drops(pk):
    client = pk.mqtt(client_factory=F.FakeMQTT)
    fake = client._client
    for i in range(15):
        msg = types.SimpleNamespace(topic="t", payload=bytes([i]), qos=0)
        client._on_message(fake, None, msg)
    q = client._queues["t"]
    assert q.qsize() == 10  # the size-10 per-topic buffer; overflow dropped
    assert [q.get_nowait().payload for _ in range(10)] == [
        bytes([i]) for i in range(10)]
    client.close()


def test_mqtt_scripts_agree():
    def script(pk):
        c = pk.mqtt(broker="b", port=1, qos=2, retained=True,
                    client_factory=F.FakeMQTT)
        seen = []
        c.subscribe_with_function("x", lambda m: seen.append(
            (m.topic, m.value, m.metadata)))
        c.publish("x", b"1")
        c.publish("y", b"2")
        h = c.health_check().to_dict()
        c.close()
        return seen, list(c._client.published), h

    _both(script)
