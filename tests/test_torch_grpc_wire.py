"""The port's gRPC wire layer (gofr_tpu_torch.grpcx, gofr_tpu_torch.wire),
no engine involved.

Held against the JAX package: the port's encoder emits the same bytes
as JAX's for the same header sequences (JAX's memoized and plain
encoders both), its stateless blocks and Huffman table are
byte-identical, its frames parse on JAX's FrameIO, and its server
streams to JAX's client on the JAX package's legacy wire settings
(stateful HPACK, eager window updates, one write per frame).

Run on the port alone: the engine-free cases of tests/test_grpc.py
(HPACK, Huffman, the server's RPC semantics, client and bidi
streaming), tests/test_transport_fast.py (encode caching, stateless
blocks, the socket writer, the outbox, push streams, the zero-handoff
server stream) and tests/test_wire_fuzz.py (seeded HPACK and HTTP/2
framing fuzz), which those files run on the JAX package.
"""

import random
import socket
import string
import threading
import time
from types import SimpleNamespace

import pytest

from gofr_tpu import grpcx as jgrpcx
from gofr_tpu.grpcx import hpack as jhpack
from gofr_tpu.grpcx import http2 as jh2
from gofr_tpu_torch import grpcx as pgrpcx
from gofr_tpu_torch import tracing as ptracing
from gofr_tpu_torch import wire as pwire
from gofr_tpu_torch.grpcx import hpack as phpack
from gofr_tpu_torch.grpcx import http2 as ph2

@pytest.fixture(scope="module")
def pk():
    return SimpleNamespace(grpcx=pgrpcx, hpack=phpack, h2=ph2, wire=pwire,
                           tracing=ptracing)


NAME_CHARS = string.ascii_lowercase + string.digits + "-"
FUZZ_NAME_CHARS = string.ascii_lowercase + string.digits + "-_"
VALUE_CHARS = string.printable.strip() + "  "


def _rand_headers(rng):
    """tests/test_transport_fast.py's generator."""
    out = []
    for _ in range(rng.randint(0, 10)):
        if rng.random() < 0.4:  # repeats exercise the dynamic table
            name = rng.choice([":status", "content-type", "grpc-status",
                               "x-request-id", "grpc-message"])
            value = rng.choice(["200", "application/grpc", "0", "abc", ""])
        else:
            name = "".join(rng.choice(NAME_CHARS)
                           for _ in range(rng.randint(1, 16)))
            value = "".join(rng.choice(string.printable.strip())
                            for _ in range(rng.randint(0, 40)))
        out.append((name, value))
    return out


def _fuzz_headers(rng):
    """tests/test_wire_fuzz.py's generator."""
    out = []
    for _ in range(rng.randint(0, 12)):
        if rng.random() < 0.3:  # realistic repeated names hit the table
            name = rng.choice([":path", ":method", "content-type",
                               "grpc-status", "x-correlation-id"])
        else:
            name = "".join(rng.choice(FUZZ_NAME_CHARS)
                           for _ in range(rng.randint(1, 24)))
        value = "".join(rng.choice(VALUE_CHARS)
                        for _ in range(rng.randint(0, 64)))
        out.append((name, value))
    return out


# -- the port's encoder against JAX's, byte for byte ---------------------------

@pytest.mark.parametrize("memo", [True, False])
def test_port_encoder_emits_jax_bytes(memo):
    """One seeded header sequence through the port's encoder and JAX's
    (with its encode memo on or off), with Huffman and indexing toggled
    and the table resized mid-stream (down to 0 and back): every block
    is byte-identical, and each decodes on the other package's
    decoder."""
    rng = random.Random(0x14)
    j = jhpack.Encoder(max_table_size=512, memo=memo)
    p = phpack.Encoder(max_table_size=512)
    on_port, on_jax = phpack.Decoder(), jhpack.Decoder()
    for i in range(400):
        j.huffman = p.huffman = rng.random() < 0.7
        j.indexing = p.indexing = rng.random() < 0.8
        if i % 29 == 13:
            size = rng.choice([0, 64, 256, 512])
            j.set_max_table_size(size)
            p.set_max_table_size(size)
        headers = _rand_headers(rng)
        a, b = j.encode(headers), p.encode(headers)
        assert bytes(a) == bytes(b), f"case {i}: {headers!r}"
        want = [(n.lower().encode(), v.encode()) for n, v in headers]
        assert on_port.decode(bytes(a)) == want  # JAX's block
        assert on_jax.decode(bytes(b)) == want   # the port's block


def test_encode_stateless_blocks_are_byte_identical():
    rng = random.Random(0x5714)
    cases = [[(":status", "200"), ("content-type", "application/grpc")],
             [("grpc-status", "0")],
             [("grpc-status", "8"), ("grpc-message", "shed (throughput)"),
              ("retry-after", "30")]]
    cases += [_rand_headers(rng) for _ in range(100)]
    for headers in cases:
        assert phpack.encode_stateless(headers) == \
            jhpack.encode_stateless(headers)
    assert phpack.huffman_encode(bytes(range(256))) == \
        jhpack.huffman_encode(bytes(range(256)))
    assert phpack.STATIC_TABLE == jhpack.STATIC_TABLE
    from gofr_tpu.grpcx._hufftable import HUFFMAN_CODES as J
    from gofr_tpu_torch.grpcx._hufftable import HUFFMAN_CODES as P
    assert P == J


def test_port_frames_parse_on_jax_frameio():
    rng = random.Random(0xF14)
    a, b = socket.socketpair()
    wio, rio = ph2.FrameIO(a), jh2.FrameIO(b)
    try:
        for i in range(60):
            frame = (rng.randint(0, 9), rng.randint(0, 255),
                     rng.randint(0, 0x7FFFFFFF),
                     bytes(rng.getrandbits(8)
                           for _ in range(rng.randint(0, 300))))
            wio.send_frames([frame], block=True)
            f = rio.recv_frame()
            assert (f.type, f.flags, f.stream_id, f.payload) == frame
        assert ph2.encode_settings({1: 4096, 5: 16384}) == \
            jh2.encode_settings({1: 4096, 5: 16384})
    finally:
        a.close()
        b.close()


# -- hpack (tests/test_grpc.py) --------------------------------------------------

def test_hpack_integer_roundtrip(pk):
    for prefix in (4, 5, 6, 7):
        for val in (0, 1, 9, 30, 31, 127, 128, 255, 1337, 1 << 20):
            data = bytes(pk.hpack.encode_int(val, prefix))
            got, pos = pk.hpack.decode_int(data, 0, prefix)
            assert got == val and pos == len(data)


def test_huffman_roundtrip(pk):
    for s in (b"", b"a", b"www.example.com", b"no-cache",
              b"custom-value", bytes(range(256))):
        assert pk.hpack.huffman_decode(pk.hpack.huffman_encode(s)) == s


def test_huffman_rfc_vectors(pk):
    # RFC 7541 C.4.1: "www.example.com" huffman-encodes to these bytes
    assert pk.hpack.huffman_encode(b"www.example.com") == bytes.fromhex(
        "f1e3c2e5f23a6ba0ab90f4ff")
    assert pk.hpack.huffman_encode(b"no-cache") == bytes.fromhex(
        "a8eb10649cbf")


def test_huffman_rejects_bad_padding(pk):
    with pytest.raises(pk.hpack.HPACKError):
        pk.hpack.huffman_decode(b"\x00")  # '0' * 8: invalid padding


def test_hpack_header_roundtrip_with_dynamic_table(pk):
    enc, dec = pk.hpack.Encoder(), pk.hpack.Decoder()
    rounds = [
        [(":method", "POST"), (":path", "/pkg.Svc/M"), (":scheme", "http"),
         ("content-type", "application/grpc"), ("te", "trailers"),
         ("x-request-id", "abc-123")],
        [(":method", "POST"), (":path", "/pkg.Svc/M"), (":scheme", "http"),
         ("content-type", "application/grpc"), ("x-request-id", "abc-124")],
    ]
    for headers in rounds:
        block = enc.encode(headers)
        got = [(n.decode(), v.decode()) for n, v in dec.decode(block)]
        assert got == [(n.lower(), v) for n, v in headers]
    # the second round is far smaller thanks to the dynamic table
    assert len(enc.encode(rounds[1])) < 30


def test_hpack_decoder_handles_plain_literals_and_size_update(pk):
    dec = pk.hpack.Decoder()
    # literal without indexing, new name, no huffman: "x-a: b"
    block = b"\x00" + bytes([3]) + b"x-a" + bytes([1]) + b"b"
    assert dec.decode(block) == [(b"x-a", b"b")]
    # a table size update within bounds, then an indexed static header
    block = b"\x3f\xe1\x1f" + b"\x82"  # resize to 4064, then :method GET
    assert dec.decode(block) == [(b":method", b"GET")]
    with pytest.raises(pk.hpack.HPACKError):
        dec.decode(b"\x80")  # index 0 invalid
    with pytest.raises(pk.hpack.HPACKError):
        dec.decode(b"\xff\xff\xff")  # truncated integer


def test_hpack_no_indexing_mode(pk):
    enc, dec = pk.hpack.Encoder(), pk.hpack.Decoder()
    enc.indexing = False
    headers = [("x-custom", "v1"), (":path", "/x")]
    for _ in range(2):
        got = dec.decode(enc.encode(headers))
        assert got == [(b"x-custom", b"v1"), (b":path", b"/x")]
    assert not enc.table.entries  # nothing was indexed
    assert not dec.table.entries


def test_hpack_table_size_downgrade_emits_update(pk):
    """RFC 7541 §4.2: a shrunk SETTINGS_HEADER_TABLE_SIZE evicts at once
    and opens the next block with a dynamic-table-size update."""
    enc, dec = pk.hpack.Encoder(), pk.hpack.Decoder()
    headers = [("x-custom", "v1"), ("x-other", "v2")]
    dec.decode(enc.encode(headers))
    assert len(enc.table.entries) == 2

    enc.set_max_table_size(0)
    assert not enc.table.entries
    block = enc.encode(headers)
    assert block[0] & 0xE0 == 0x20 and block[0] & 0x1F == 0  # §6.3 update
    dec2 = pk.hpack.Decoder()
    dec2.table.resize(0)
    assert dec2.decode(block) == [(b"x-custom", b"v1"), (b"x-other", b"v2")]
    assert not dec2.table.entries

    enc.set_max_table_size(4096)
    block = enc.encode(headers)
    assert dec.decode(block) == [(b"x-custom", b"v1"), (b"x-other", b"v2")]


def test_hpack_shrink_then_grow_signals_minimum(pk):
    enc, dec = pk.hpack.Encoder(), pk.hpack.Decoder()
    headers = [("x-a", "1")]
    dec.decode(enc.encode(headers))
    assert dec.table.entries
    enc.set_max_table_size(0)
    enc.set_max_table_size(4096)
    block = enc.encode(headers)
    assert block[0] == 0x20  # two §6.3 updates: 0, then 4096
    assert dec.decode(block) == [(b"x-a", b"1")]
    assert dec.table.max_size == 4096
    assert len(dec.table.entries) == 1


# -- end-to-end RPC (tests/test_grpc.py) -------------------------------------------

@pytest.fixture(scope="module")
def server(pk):
    g = pk.grpcx
    echo = g.GRPCService("test.Echo")

    @echo.unary("Say")
    def say(ctx, req):
        return {"msg": req["msg"], "peer_set": bool(ctx.peer)}

    @echo.unary("Fail")
    def fail(ctx, req):
        raise g.GRPCError(g.INVALID_ARGUMENT, "bad thing")

    @echo.unary("Panic")
    def panic(ctx, req):
        raise RuntimeError("boom")

    @echo.unary("Meta")
    def meta(ctx, req):
        return {"got": ctx.metadata.get("x-api-key", "")}

    @echo.server_stream("Count")
    def count(ctx, req):
        for i in range(req["n"]):
            yield {"i": i}

    @echo.unary("Slow")
    def slow(ctx, req):
        time.sleep(req.get("sleep", 0.5))
        return {"ok": True}

    srv = g.GRPCServer([echo], port=0)
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture()
def channel(pk, server):
    ch = pk.grpcx.dial(f"127.0.0.1:{server.port}")
    yield ch
    ch.close()


def test_server_stream_abandoned_iterator_sends_rst(channel):
    it = channel.server_stream("/test.Echo/Count", {"n": 50000})
    assert [next(it) for _ in range(3)] == [{"i": 0}, {"i": 1}, {"i": 2}]
    it.close()  # GeneratorExit -> RST_STREAM(CANCEL)
    assert not channel._calls
    assert channel.unary("/test.Echo/Say", {"msg": "after"})["msg"] == "after"


def test_unary_roundtrip(channel):
    out = channel.unary("/test.Echo/Say", {"msg": "hello"})
    assert out == {"msg": "hello", "peer_set": True}


def test_unary_many_sequential_calls_one_connection(channel):
    for i in range(20):
        assert channel.unary("/test.Echo/Say",
                             {"msg": str(i)})["msg"] == str(i)


def test_concurrent_calls_multiplex(channel):
    out = [None] * 10

    def worker(i):
        out[i] = channel.unary("/test.Echo/Say", {"msg": f"m{i}"})["msg"]

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(10)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert out == [f"m{i}" for i in range(10)]


def test_server_streaming(channel):
    got = list(channel.server_stream("/test.Echo/Count", {"n": 25}))
    assert got == [{"i": i} for i in range(25)]


def test_error_statuses(pk, channel):
    g = pk.grpcx
    with pytest.raises(g.GRPCError) as e:
        channel.unary("/test.Echo/Fail", {})
    assert e.value.code == g.INVALID_ARGUMENT and "bad thing" in e.value.message
    with pytest.raises(g.GRPCError) as e:
        channel.unary("/test.Echo/Panic", {})
    assert e.value.code == g.INTERNAL  # recovery interceptor, no leak
    assert "boom" not in e.value.message
    for path in ("/test.Echo/Nope", "/test.Nothing/X"):
        with pytest.raises(g.GRPCError) as e:
            channel.unary(path, {})
        assert e.value.code == g.UNIMPLEMENTED


def test_metadata_passthrough(channel):
    out = channel.unary("/test.Echo/Meta", {}, metadata={"X-API-Key": "k1"})
    assert out == {"got": "k1"}


def test_deadline_exceeded(pk, channel):
    with pytest.raises(pk.grpcx.GRPCError) as e:
        channel.unary("/test.Echo/Slow", {"sleep": 0.5}, timeout=0.1)
    assert e.value.code == pk.grpcx.DEADLINE_EXCEEDED


def test_large_message_flow_control(channel):
    big = "x" * (1 << 20)  # multi-frame DATA and window refills both ways
    out = channel.unary("/test.Echo/Say", {"msg": big}, timeout=30.0)
    assert out["msg"] == big


def test_protobuf_codec_roundtrip(pk):
    """ProtoCodec over a hand-built descriptor (no protoc needed)."""
    pytest.importorskip("google.protobuf")
    from google.protobuf import (descriptor_pb2, descriptor_pool,
                                 message_factory)

    pool = descriptor_pool.DescriptorPool()
    fd = descriptor_pb2.FileDescriptorProto()
    fd.name = "t.proto"
    fd.package = "t"
    m = fd.message_type.add()
    m.name = "Ping"
    f = m.field.add()
    f.name, f.number = "text", 1
    f.type, f.label = f.TYPE_STRING, f.LABEL_OPTIONAL
    pool.Add(fd)
    Ping = message_factory.GetMessageClass(
        pool.FindMessageTypeByName("t.Ping"))
    g = pk.grpcx
    svc_obj = g.GRPCService("t.P")

    @svc_obj.unary("Ping", request_type=Ping, response_type=Ping)
    def ping(ctx, req):
        out = Ping()
        out.text = req.text + "!"
        return out

    srv = g.GRPCServer([svc_obj], port=0)
    srv.start()
    try:
        ch = g.dial(f"127.0.0.1:{srv.port}")
        req = Ping()
        req.text = "hi"
        assert ch.unary("/t.P/Ping", req,
                        codec=g.ProtoCodec(Ping)).text == "hi!"
        ch.close()
    finally:
        srv.stop()


@pytest.fixture(scope="module")
def stream_server(pk):
    g = pk.grpcx
    agg = g.GRPCService("test.Stream")

    @agg.client_stream("Sum")
    def sum_(ctx, requests):
        return {"total": sum(r["n"] for r in requests)}

    @agg.bidi_stream("EchoUpper")
    def echo_upper(ctx, requests):
        for r in requests:
            yield {"msg": r["msg"].upper()}

    @agg.bidi_stream("Forever")
    def forever(ctx, requests):
        next(iter(requests))
        i = 0
        while not ctx.is_cancelled():
            yield {"i": i}
            i += 1

    srv = g.GRPCServer([agg], port=0)
    srv.start()
    yield srv
    srv.stop()


def test_client_streaming_aggregates(pk, stream_server):
    ch = pk.grpcx.dial(f"127.0.0.1:{stream_server.port}")
    try:
        assert ch.client_stream("/test.Stream/Sum",
                                ({"n": i} for i in range(10))) == \
            {"total": 45}
    finally:
        ch.close()


def test_bidi_streaming_interleaves(pk, stream_server):
    ch = pk.grpcx.dial(f"127.0.0.1:{stream_server.port}")
    try:
        call = ch.bidi_stream("/test.Stream/EchoUpper")
        it = iter(call)
        for word in ("alpha", "beta", "gamma"):
            call.send({"msg": word})
            assert next(it)["msg"] == word.upper()
        call.close_send()
        assert list(it) == []
    finally:
        ch.close()


def test_bidi_mid_stream_cancel(pk, stream_server):
    ch = pk.grpcx.dial(f"127.0.0.1:{stream_server.port}")
    try:
        call = ch.bidi_stream("/test.Stream/Forever")
        call.send({"go": True})
        it = iter(call)
        assert [next(it)["i"] for _ in range(3)] == [0, 1, 2]
        call.cancel()
        assert not ch._calls
        assert ch.client_stream("/test.Stream/Sum",
                                [{"n": 2}, {"n": 3}]) == {"total": 5}
    finally:
        ch.close()


# -- HPACK encode caching (tests/test_transport_fast.py) -----------------------

def test_encoder_memo_is_byte_identical_under_eviction(pk):
    """The port's encoder, whose string memo is always on, against the
    JAX package's with its memo off, through table evictions."""
    rng = random.Random(0xFA57)
    memo = pk.hpack.Encoder(max_table_size=256)
    plain = jhpack.Encoder(max_table_size=256, memo=False)
    dec = pk.hpack.Decoder(max_table_size=256)
    dec.table.resize(256)
    for i in range(300):
        if i % 23 == 11:
            size = rng.choice([0, 64, 128, 256])
            memo.set_max_table_size(size)
            plain.set_max_table_size(size)
        headers = _rand_headers(rng)
        a = memo.encode(headers)
        assert a == plain.encode(headers), f"case {i}: {headers!r}"
        assert dec.decode(a) == [(n.lower().encode(), v.encode())
                                 for n, v in headers]
    assert memo._str_cache


def test_encoder_memo_matches_across_huffman_and_indexing_modes(pk):
    rng = random.Random(0x5EED)
    memo, plain = pk.hpack.Encoder(), jhpack.Encoder(memo=False)
    for i in range(150):
        memo.huffman = plain.huffman = rng.random() < 0.7
        memo.indexing = plain.indexing = rng.random() < 0.8
        headers = _rand_headers(rng)
        assert memo.encode(headers) == plain.encode(headers), f"case {i}"


def test_encode_stateless_blocks_leave_decoder_state_untouched(pk):
    resp = [(":status", "200"), ("content-type", "application/grpc")]
    block_resp = pk.hpack.encode_stateless(resp)
    assert block_resp == pk.hpack.encode_stateless(resp)
    enc, dec = pk.hpack.Encoder(), pk.hpack.Decoder()
    stateful = [("x-request-id", "abc-123"), ("content-type", "text/html")]
    dec.decode(enc.encode(stateful))
    entries_before = list(dec.table.entries)
    assert dec.decode(block_resp) == [(b":status", b"200"),
                                      (b"content-type", b"application/grpc")]
    assert dec.decode(pk.hpack.encode_stateless([("grpc-status", "0")])) \
        == [(b"grpc-status", b"0")]
    assert dec.table.entries == entries_before
    assert dec.decode(enc.encode(stateful)) == [
        (b"x-request-id", b"abc-123"), (b"content-type", b"text/html")]


def test_dynamic_table_duplicate_entries_index_newest(pk):
    enc, dec = pk.hpack.Encoder(), pk.hpack.Decoder()
    headers = [("x-dup", "v"), ("x-other", "a"), ("x-dup", "v")]
    for _ in range(3):
        assert dec.decode(enc.encode(headers)) == [
            (b"x-dup", b"v"), (b"x-other", b"a"), (b"x-dup", b"v")]


# -- SocketWriter, Outbox, PushStream (tests/test_transport_fast.py) -----------

def _writer_pair(pk):
    a, b = socket.socketpair()
    # tiny buffers force the EAGAIN/backlog path deterministically
    a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 8192)
    return pk.wire.SocketWriter(a), a, b


def test_socket_writer_preserves_order_across_modes_and_backpressure(pk):
    wr, a, b = _writer_pair(pk)
    rng = random.Random(0xB10B)
    sent, received = bytearray(), bytearray()

    def reader():
        while True:
            chunk = b.recv(65536)
            if not chunk:
                return
            received.extend(chunk)

    t = threading.Thread(target=reader)
    try:
        parked = 0
        for i in range(200):  # no reader: nonblocking writes park
            payload = bytes([i % 251]) * rng.randint(200, 2000)
            sent.extend(payload)
            parked += not wr.write([payload], block=False)
        assert parked > 0, "the backlog path never ran"
        assert wr._backlog
        t.start()
        for i in range(200):
            payload = bytes([(100 + i) % 251]) * rng.randint(1, 2000)
            sent.extend(payload)
            wr.write([payload], block=rng.random() < 0.5)
        wr.flush()
        assert not wr._backlog
        a.shutdown(socket.SHUT_WR)
        t.join(timeout=20)
        assert not t.is_alive()
        assert bytes(received) == bytes(sent)
    finally:
        a.close()
        b.close()


def test_socket_writer_vectored_single_syscall(pk):
    a, b = socket.socketpair()
    calls = []

    class Counted:
        def sendmsg(self, *args):
            calls.append(args)
            return a.sendmsg(*args)

    wr = pk.wire.SocketWriter(Counted())
    try:
        bufs = [b"h" * 9, b"x" * 100, b"h" * 9, b"y" * 100]
        wr.write(bufs, block=True)
        assert len(calls) == 1
        assert b.recv(65536) == b"".join(bufs)
    finally:
        a.close()
        b.close()


def test_socket_writer_close_refuses_later_writes(pk):
    """``close`` drops the backlog and shuts the socket down; a later
    write raises the package's ConnectionLost, an EOFError."""
    wr, a, b = _writer_pair(pk)
    try:
        wr.write([b"x" * 50000], block=False)
        wr.close()
        assert not wr._backlog
        with pytest.raises(EOFError):
            wr.write([b"late"], block=True)
    finally:
        b.close()


def test_outbox_drains_in_order_across_threads(pk):
    drained = []

    def drain(batch, block):
        drained.extend(batch)
        return len(batch)

    box = pk.wire.Outbox(drain)
    items = list(range(500))

    def produce(chunk):
        for i in chunk:
            box.append(i)
            box.pump(block=False)

    ts = [threading.Thread(target=produce, args=(items[i::2],))
          for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    box.pump(block=True)
    assert sorted(drained) == items and len(drained) == len(items)
    for lane in (items[0::2], items[1::2]):
        assert [i for i in drained if i in set(lane)] == lane


def test_outbox_stall_then_blocking_pump_completes(pk):
    drained = []

    def drain(batch, block):
        n = len(batch) if block else min(1, len(batch))
        drained.extend(batch[:n])
        return n

    box = pk.wire.Outbox(drain)
    for i in range(5):
        box.append(i)
    box.pump(block=False)
    assert box.stalled and drained == [0] and len(box) == 4
    box.pump(block=True)
    assert drained == [0, 1, 2, 3, 4] and not box.stalled


def test_push_stream_sink_registration_drains_in_order(pk):
    src = pk.wire.PushStream()
    for i in range(3):
        src._push(i)
    got = []
    src.set_sink(lambda item: (got.append(item), True)[1])
    for i in range(3, 6):
        src._push(i)
    src._push(None)
    assert got == [0, 1, 2, 3, 4, 5]
    assert list(src) == []


def test_push_stream_declined_items_fall_back_to_queue_in_order(pk):
    src = pk.wire.PushStream()
    got = []

    def sink(item):
        if item >= 2:
            return False
        got.append(item)
        return True

    src.set_sink(sink)
    for i in range(5):
        src._push(i)
    src._push(None)
    assert got == [0, 1] and list(src) == [2, 3, 4]


def test_push_stream_raising_sink_is_dropped_not_fatal(pk):
    src = pk.wire.PushStream()

    def sink(item):
        raise RuntimeError("broken sink")

    src.set_sink(sink)
    src._push(1)
    src._push(None)
    assert list(src) == [1]


def test_push_stream_queued_error_reraises(pk):
    src = pk.wire.PushStream()
    src._push(7)
    src._push(ValueError("boom"))
    it = iter(src)
    assert next(it) == 7
    with pytest.raises(ValueError, match="boom"):
        next(it)


def test_mapped_stream_sink_iter_wake_cancel_and_trace(pk):
    """``map`` keeps the sink protocol: a sink through the map sees
    mapped items, the iterator maps queued ones and passes WAKE through,
    ``map`` composes, ``cancel``/``wake`` reach the source and ``trace``
    is the source's."""
    src = pk.wire.PushStream()
    src.trace = {"first_put": 1.5}
    cancelled = []
    src.cancel = lambda: cancelled.append(True)
    mapped = src.map(lambda t: t * 10)
    got = []
    mapped.set_sink(lambda item: (got.append(item), True)[1])
    src._push(1)
    src._push(2)
    mapped.clear_sink()
    src._push(3)
    mapped.wake()
    src._push(None)
    assert got == [10, 20]
    assert list(mapped) == [30, pk.wire.WAKE]
    src2 = pk.wire.PushStream()
    twice = src2.map(lambda t: t + 1).map(lambda t: t * 2)
    src2._push(4)
    src2._push(None)
    assert list(twice) == [10]
    mapped.cancel()
    assert cancelled == [True] and mapped.trace == {"first_put": 1.5}


# -- loopback streaming (tests/test_transport_fast.py) ---------------------------

def _token_server(pk, gap_s=0.0, container=None, spans=False):
    g = pk.grpcx
    svc = g.GRPCService("t.Stream")

    @svc.unary("Echo")
    def echo(ctx, req):
        return req

    @svc.server_stream("Tokens")
    def tokens(ctx, req):
        src = pk.wire.PushStream()
        if spans:
            src.trace = {}

        def produce():
            for i in range(req.get("n", 5)):
                if spans:
                    src.trace.setdefault("first_put", time.monotonic())
                src._push({"t": i, "pad": "x" * req.get("pad", 0)})
                if gap_s:
                    time.sleep(gap_s)
            src._push(None)

        threading.Thread(target=produce, daemon=True).start()
        return g.ServerStream(src)

    srv = g.GRPCServer([svc], port=0, container=container)
    srv.start()
    return srv


@pytest.mark.parametrize("legacy", [False, True], ids=["fast", "legacy"])
def test_stream_tokens_arrive_complete_and_ordered(pk, legacy):
    """The port's client, and the JAX package's client on its legacy
    wire settings (stateful HPACK blocks, a WINDOW_UPDATE pair per DATA
    frame, one write per frame), against the port's server."""
    srv = _token_server(pk, gap_s=0.001)
    ch = (jgrpcx.dial(f"127.0.0.1:{srv.port}",
                      options=jgrpcx.TransportOptions.legacy())
          if legacy else pk.grpcx.dial(f"127.0.0.1:{srv.port}"))
    try:
        got = [m["t"] for m in ch.server_stream("/t.Stream/Tokens",
                                                {"n": 40})]
        assert got == list(range(40))
        assert ch.unary("/t.Stream/Echo", {"ok": 1}) == {"ok": 1}
    finally:
        ch.close()
        srv.stop()


def test_fast_path_coalesces_headers_with_first_data(pk, monkeypatch):
    """The server's response HEADERS leave in the same write as the
    first DATA frame."""
    writes = []
    send_frames = pk.h2.FrameIO.send_frames

    def record(io, frames, block=True):
        writes.append((io, [(f[0], f[2]) for f in frames]))
        return send_frames(io, frames, block)

    monkeypatch.setattr(pk.h2.FrameIO, "send_frames", record)
    srv = _token_server(pk)
    ch = pk.grpcx.dial(f"127.0.0.1:{srv.port}")
    try:
        list(ch.server_stream("/t.Stream/Tokens", {"n": 4}))
        conn = next(iter(srv._conns))
        sid = 1
        assert [kinds[:2] for io, kinds in writes if io is conn.io
                and (pk.h2.HEADERS, sid) in kinds] == \
            [[(pk.h2.HEADERS, sid), (pk.h2.DATA, sid)], [(pk.h2.HEADERS, sid)]]
    finally:
        ch.close()
        srv.stop()


def test_oversized_messages_downgrade_to_worker_path(pk):
    srv = _token_server(pk)
    ch = pk.grpcx.dial(f"127.0.0.1:{srv.port}")
    try:
        pad = pk.h2.DEFAULT_MAX_FRAME  # each message > one frame
        got = list(ch.server_stream("/t.Stream/Tokens",
                                    {"n": 6, "pad": pad}, timeout=60.0))
        assert [m["t"] for m in got] == list(range(6))
        assert all(len(m["pad"]) == pad for m in got)
    finally:
        ch.close()
        srv.stop()


def test_lazy_window_replenish_sustains_long_streams(pk):
    srv = _token_server(pk)
    ch = pk.grpcx.dial(f"127.0.0.1:{srv.port}")
    try:
        got = list(ch.server_stream("/t.Stream/Tokens",
                                    {"n": 300, "pad": 1024}, timeout=60.0))
        assert [m["t"] for m in got] == list(range(300))
    finally:
        ch.close()
        srv.stop()


def test_zero_handoff_cancel_mid_stream_releases_cleanly(pk):
    srv = _token_server(pk, gap_s=0.002)
    ch = pk.grpcx.dial(f"127.0.0.1:{srv.port}")
    try:
        it = ch.server_stream("/t.Stream/Tokens", {"n": 100000})
        assert [next(it)["t"] for _ in range(3)] == [0, 1, 2]
        it.close()
        assert not ch._calls
        assert ch.unary("/t.Stream/Echo", {"after": 1}) == {"after": 1}
    finally:
        ch.close()
        srv.stop()


def test_first_send_spans_exported(pk):
    exporter = pk.tracing.InMemoryExporter()
    box = SimpleNamespace(logger=None, exporter=exporter,
                          tracer=pk.tracing.Tracer(service_name="t",
                                                   exporter=exporter))
    srv = _token_server(pk, container=box,
                        spans=True)
    ch = pk.grpcx.dial(f"127.0.0.1:{srv.port}")
    want = {"grpc.hpack", "grpc.frame-write", "grpc.handoff"}
    try:
        assert len(list(ch.server_stream("/t.Stream/Tokens", {}))) == 5
        deadline = time.monotonic() + 5
        names = set()
        while time.monotonic() < deadline:
            names = {s.name for s in exporter.spans}
            if want <= names:
                break
            time.sleep(0.01)
        assert want <= names
        assert sum(1 for s in exporter.spans if s.name == "grpc.hpack") == 1
    finally:
        ch.close()
        srv.stop()


def test_record_span_joins_the_trace_and_leaves_the_stack(pk):
    exporter = pk.tracing.InMemoryExporter()
    tracer = pk.tracing.Tracer(service_name="t", exporter=exporter)
    tid = "4bf92f3577b34da6a3ce929d0e0e4736"
    t0 = time.monotonic()
    s = tracer.record_span("grpc.handoff", t0, t0 + 0.002,
                           traceparent=f"00-{tid}-00f067aa0ba902b7-01",
                           attributes={"stream": 1})
    loose = tracer.record_span("grpc.hpack", t0, t0 + 0.001, trace_id=tid)
    assert (s.trace_id, s.parent_id, s.duration_us) == \
        (tid, "00f067aa0ba902b7", 2000)
    assert (loose.trace_id, loose.parent_id) == (tid, None)
    assert pk.tracing.current_span() is None
    assert [x.name for x in exporter.spans] == ["grpc.handoff", "grpc.hpack"]


# -- seeded fuzz (tests/test_wire_fuzz.py) -----------------------------------------

def test_hpack_roundtrip_fuzz(pk):
    rng = random.Random(0xC0FFEE)
    enc, dec = pk.hpack.Encoder(), pk.hpack.Decoder()
    for i in range(400):
        enc.huffman = rng.random() < 0.7
        enc.indexing = rng.random() < 0.8
        if i % 37 == 17:
            enc.set_max_table_size(rng.choice([0, 64, 256, 4096]))
        headers = _fuzz_headers(rng)
        got = dec.decode(bytes(enc.encode(headers)))
        assert got == [(n.lower().encode(), v.encode())
                       for n, v in headers], f"case {i}"


def test_hpack_garbage_never_hangs_or_crashes(pk):
    rng = random.Random(0xBAD5EED)
    for _ in range(600):
        blob = bytes(rng.getrandbits(8) for _ in range(rng.randint(1, 200)))
        try:
            out = pk.hpack.Decoder().decode(blob)
        except pk.hpack.HPACKError:
            continue
        assert isinstance(out, list)


def test_hpack_truncation_is_loud(pk):
    rng = random.Random(0x7A7A)
    for _ in range(40):
        enc = pk.hpack.Encoder()
        headers = [(n.lower().encode(), v.encode())
                   for n, v in _fuzz_headers(rng)]
        block = bytes(enc.encode(headers))
        for cut in range(len(block)):
            try:
                got = pk.hpack.Decoder().decode(block[:cut])
            except pk.hpack.HPACKError:
                continue
            assert got == headers[:len(got)]


def test_huffman_roundtrip_fuzz(pk):
    rng = random.Random(0x48554646)
    for _ in range(300):
        data = bytes(rng.getrandbits(8) for _ in range(rng.randint(0, 80)))
        assert pk.hpack.huffman_decode(pk.hpack.huffman_encode(data)) == data


def test_h2_frame_roundtrip_fuzz(pk):
    rng = random.Random(0xF8A3E)
    a, b = socket.socketpair()
    wio, rio = pk.h2.FrameIO(a), pk.h2.FrameIO(b)
    try:
        for i in range(150):
            frame = (rng.randint(0, 9), rng.randint(0, 255),
                     rng.randint(0, 0x7FFFFFFF),
                     bytes(rng.getrandbits(8)
                           for _ in range(rng.randint(0, 512))))
            wio.send_frame(*frame)
            f = rio.recv_frame()
            assert (f.type, f.flags, f.stream_id, f.payload) == frame, i
    finally:
        a.close()
        b.close()


def test_h2_oversize_and_truncated_frames_fail_clean(pk):
    a, b = socket.socketpair()
    rio = pk.h2.FrameIO(b, max_frame=1024)
    try:
        a.sendall((4096).to_bytes(3, "big") + bytes([0, 0, 0, 0, 0, 1]))
        with pytest.raises((pk.h2.ConnectionError_, OSError, EOFError)):
            rio.recv_frame()
    finally:
        a.close()
        b.close()
    a, b = socket.socketpair()
    rio = pk.h2.FrameIO(b)
    result = []

    def reader():
        try:
            result.append(rio.recv_frame())
        except Exception as e:  # noqa: BLE001
            result.append(e)

    t = threading.Thread(target=reader)
    t.start()
    a.sendall((100).to_bytes(3, "big") + bytes([0, 0, 0, 0, 0, 1]) + b"xy")
    a.close()  # EOF mid-payload
    t.join(timeout=10)
    assert not t.is_alive(), "recv_frame hung on a truncated frame"
    assert isinstance(result[0], Exception)
    b.close()


def test_h2_settings_codec_fuzz(pk):
    rng = random.Random(0x5E771)
    for _ in range(200):
        settings = {rng.randint(1, 6): rng.randint(0, 2**31 - 1)
                    for _ in range(rng.randint(0, 6))}
        assert pk.h2.decode_settings(pk.h2.encode_settings(settings)) == \
            settings


def test_h2_frame_roundtrip_fuzz_vectored_scheduler(pk):
    rng = random.Random(0x5CED41)
    a, b = socket.socketpair()
    a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 8192)
    wio, rio = pk.h2.FrameIO(a), pk.h2.FrameIO(b)
    sent, parsed = [], []

    def reader():
        try:
            while True:
                f = rio.recv_frame()
                parsed.append((f.type, f.flags, f.stream_id, f.payload))
        except (EOFError, OSError):
            pass

    t = threading.Thread(target=reader)
    t.start()
    try:
        for _ in range(120):
            batch = []
            for _ in range(rng.randint(1, 6)):
                frame = (rng.randint(0, 9), rng.randint(0, 255),
                         rng.randint(0, 0x7FFFFFFF),
                         bytes(rng.getrandbits(8)
                               for _ in range(rng.randint(0, 700))))
                batch.append(frame)
                sent.append(frame)
            wio.send_frames(batch, block=rng.random() < 0.5)
        wio.flush()
        a.shutdown(socket.SHUT_WR)
        t.join(timeout=20)
        assert not t.is_alive(), "reader hung: the scheduler lost frames"
        assert parsed == sent
    finally:
        a.close()
        b.close()
        t.join(timeout=5)
