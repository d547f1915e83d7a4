"""Disaggregated prefill/decode serving on the port (gofr_tpu_torch/pd and
the generator's ``kv_sink`` / ``ingest`` halves) against the JAX package's
(gofr_tpu/pd), on ``tiny`` with an int8 KV cache on the CPU.

Four layers:

  - every case of tests/test_pd_serve.py on both packages, with the same
    body and assertions, each package's coordinator, ingest server and
    engines together (the port's with ``device="cpu"``): the protocol
    units, the prefill-only and the ingest admissions (contiguous and
    paged), the socket path, the eight corrupt-transfer cases, the
    typed faults across the wire, a killed peer. Where the port has no
    surface of the JAX case (the wide event of an expiry, the observe
    bundle) the case reads what the port has (the expiry counted by
    where), and the ingest stage lease is sized from each package's own
    upload (JAX pads it to ``max_seq``, the port stages ``[L, plen]``);
  - tests/test_resume.py's decode-death re-handoff on both packages;
  - the cross-package pairs: a JAX prefill worker shipping to a port
    decode worker (contiguous and paged) and a port prefill worker
    shipping to a JAX decode worker, each greedy token-exact against the
    JAX fused engine at prompts of 10, 40 and 100 tokens (a bucket and
    two lattices on tiny's buckets 16 and 32);
  - the frames the port's shipper cuts decode to its own slot row byte
    for byte, and agree with the JAX shipper's for the same prompt
    within one int8 code and 1e-5 relative on the scales.

The weights are JAX's seeded ``init`` carried into torch
(``from_jax_params``). Every socket is bound to port 0; a case closes
its coordinators, servers and engines, whose threads end there.
"""

from __future__ import annotations

import io
import json
import socket
import struct
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu import chaos as jchaos
from gofr_tpu import errors as jerrors
from gofr_tpu import pd as jpd
from gofr_tpu.glog import Logger, LogLevel
from gofr_tpu.metrics import Manager, register_framework_metrics
from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.observe import Observe, Timeline
from gofr_tpu.pd import prefill as jprefill
from gofr_tpu.pd import protocol as jpdp
from gofr_tpu.resilience import Deadline as JDeadline
from gofr_tpu.tpu import GenerationEngine as JaxEngine
from gofr_tpu.tpu import GenerationError as JaxError
from gofr_tpu.tpu import hbm as jhbm
from gofr_tpu.tpu.kvcache import KVLayout as JLayout
from gofr_tpu.tpu.kvcache import model_fingerprint as jfingerprint
from gofr_tpu.tpu.kvcache import quant as jquant
from gofr_tpu_torch import chaos, errors, pd
from gofr_tpu_torch.models import LLAMA_CONFIGS
from gofr_tpu_torch.pd import prefill as pprefill
from gofr_tpu_torch.pd import protocol as pdp
from gofr_tpu_torch.resilience import Deadline
from gofr_tpu_torch.tpu import (GenerationEngine, GenerationError,
                                from_jax_params, hbm)
from gofr_tpu_torch.tpu.kvcache import KVLayout, model_fingerprint
from gofr_tpu_torch.tpu.kvcache import quant

JCFG = JAX_CONFIGS["tiny"]
TINY = LLAMA_CONFIGS["tiny"]
MAX_NEW = 10


@pytest.fixture(autouse=True)
def _clean_arbiter():
    jhbm.reset()
    hbm.reset()
    yield
    jhbm.reset()
    hbm.reset()
    import gc

    gc.collect()


def _weights(key: int):
    jparams = jllama.init(JCFG, jax.random.PRNGKey(key))
    return jparams, from_jax_params(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


@pytest.fixture(scope="module")
def weights():
    return _weights(0)


def _jax_engine(params, observe=False, **kw):
    if observe:
        kw.setdefault("observe", Observe(timeline=Timeline(capacity=256)))
    return JaxEngine(JCFG, params, **kw)


def _port_engine(params, observe=False, **kw):
    # the port's engine has no observe bundle yet (item 13c); its trace
    # fields and expiry counts are on the stream and in stats()
    return GenerationEngine(TINY, params, device="cpu", **kw)


def _jax_expiries(dec, buf):
    """The JAX engine's expiry records: its wide events with a where."""
    wide = []
    for line in buf.getvalue().splitlines():
        try:
            msg = json.loads(line).get("message")
        except ValueError:
            continue
        if isinstance(msg, dict) and msg.get("event") == "request":
            wide.append(msg)
    expired = [w for w in wide if w.get("where")]
    assert all(w["outcome"] == "failed" for w in expired)
    return [w["where"] for w in expired]


def _port_expiries(dec, buf):
    """The port's expiry records: stats()'s count by where."""
    return [w for w, n in dec.stats()["expired"].items() for _ in range(n)]


PACKAGES = {
    "gofr_tpu": SimpleNamespace(
        name="gofr_tpu", side=0, cfg=JCFG, pd=jpd, pdp=jpdp,
        prefill=jprefill, chaos=jchaos, errors=jerrors, hbm=jhbm,
        quant=jquant, Deadline=JDeadline, GenerationError=JaxError,
        int8=jnp.int8, make=_jax_engine, fingerprint=jfingerprint,
        layout=lambda: JLayout(JCFG.n_layers, JCFG.n_kv_heads,
                               JCFG.head_dim, True, np.dtype(np.int8), 128),
        # the JAX ingest pads its upload to max_seq: larger than raw
        stage_bytes=lambda kv: 4 * kv.k.nbytes,
        expiries=_jax_expiries),
    "gofr_tpu_torch": SimpleNamespace(
        name="gofr_tpu_torch", side=1, cfg=TINY, pd=pd, pdp=pdp,
        prefill=pprefill, chaos=chaos, errors=errors, hbm=hbm, quant=quant,
        Deadline=Deadline, GenerationError=GenerationError,
        int8=torch.int8, make=_port_engine, fingerprint=model_fingerprint,
        layout=lambda: KVLayout(TINY.n_layers, TINY.n_kv_heads,
                                TINY.head_dim, True, torch.int8, 128),
        # the port stages the [L, plen] planes the lease covers
        stage_bytes=lambda kv: kv.nbytes,
        expiries=_port_expiries),
}


@pytest.fixture(params=sorted(PACKAGES))
def pk(request):
    return PACKAGES[request.param]


def _engine(pk, weights, **kw):
    """tests/test_pd_serve.py's engine: 2 slots, 128 positions, buckets
    16 and 32, an int8 cache."""
    kw.setdefault("slots", 2)
    kw.setdefault("max_seq", 128)
    kw.setdefault("prompt_buckets", (16, 32))
    kw.setdefault("kv_dtype", pk.int8)
    return pk.make(weights[pk.side], **kw)


def _fp(pk, weights):
    return pk.fingerprint(pk.cfg, weights[pk.side], extra="pd")


def _prompt(n, seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(1, TINY.vocab_size, n).tolist()


_REFS: dict = {}


def _refs(pk, weights) -> dict:
    """A package's fused-engine reference streams (one engine, computed
    once a package)."""
    if pk.name not in _REFS:
        eng = _engine(pk, weights)
        try:
            _REFS[pk.name] = {
                n: eng.generate(_prompt(n), max_new_tokens=MAX_NEW).tokens()
                for n in (10, 40, 100)}
        finally:
            eng.close()
    return _REFS[pk.name]


# -- protocol units -----------------------------------------------------------

def test_protocol_frame_round_trip(pk):
    pdp_ = pk.pdp
    a, b = socket.socketpair()
    try:
        msgs = [pdp_.pack_json(pdp_.REQ, 7, {"prompt": [1, 2], "plen": 2}),
                pdp_.pack_kv(7, 16, b"\x01" * 40),
                pdp_.pack_tok(7, 123, 5, -1.5),
                pdp_.pack_msg(pdp_.CANCEL, 7)]
        a.sendall(b"".join(msgs))
        got = [pdp_.read_msg(b) for _ in msgs]
        assert [g[0] for g in got] == [pdp_.REQ, pdp_.KV, pdp_.TOK,
                                       pdp_.CANCEL]
        assert all(g[1] == 7 for g in got)
        assert json.loads(bytes(got[0][2]))["plen"] == 2
        start, frame = pdp_.unpack_kv(got[1][2])
        assert start == 16 and frame == b"\x01" * 40
        tok, cursor, lp = pdp_.unpack_tok(got[2][2])
        assert tok == 123 and cursor == 5 and abs(lp - (-1.5)) < 1e-6
        a.close()
        assert pdp_.read_msg(b) is None  # EOF
    finally:
        b.close()


def test_protocol_oversized_length_reads_as_eof(pk):
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack("<I", pk.pdp.MAX_MSG + 1) + b"x" * 16)
        assert pk.pdp.read_msg(b) is None
    finally:
        a.close()
        b.close()


def test_typed_errors_survive_the_wire(pk):
    e, pdp_ = pk.errors, pk.pdp
    for err, cls in ((e.TooManyRequests("shed", retry_after=2.5),
                      e.TooManyRequests),
                     (e.DeadlineExceeded("late"), e.DeadlineExceeded),
                     (pdp_.KVTransferError("bad frame"),
                      pk.pd.KVTransferError),
                     (pdp_.DecodePeerUnavailable("down", retry_after=3.0),
                      pk.pd.DecodePeerUnavailable)):
        back = pdp_.error_from_wire(pdp_.error_to_wire(err))
        assert isinstance(back, cls), (err, back)
        assert back.status_code == err.status_code
    shed = pdp_.error_from_wire(pdp_.error_to_wire(
        e.TooManyRequests("x", retry_after=2.5)))
    assert shed.retry_after == 2.5 and "Retry-After" in shed.headers


def test_hello_mismatch_rules(pk, weights):
    pdp_ = pk.pdp
    mine = pdp_.hello_payload(_fp(pk, weights), pk.layout())
    assert pdp_.hello_mismatch(mine, dict(mine)) is None
    assert "fingerprint" in pdp_.hello_mismatch(
        mine, {**mine, "fingerprint": "other"})
    assert "kv_heads" in pdp_.hello_mismatch(
        mine, {**mine, "kv_heads": TINY.n_kv_heads + 1})
    assert "version" in pdp_.hello_mismatch(mine, {**mine, "version": 99})


def test_parse_role_rejects_unknown(pk):
    assert pk.pd.parse_role(None) == "fused"
    assert pk.pd.parse_role(" Decode ") == "decode"
    with pytest.raises(ValueError):
        pk.pd.parse_role("both")


# -- generator: kv_sink (prefill-only) ---------------------------------------

def test_kv_only_ships_row_identical_ranges(pk, weights):
    """The shipped ranges are contiguous, cover the prompt, and are
    bit-identical to the settled slot row, including the final-chunk
    overlap, which on int8 caches is REWRITTEN by the final chunk's
    recompute and must ship in its settled form."""
    eng = _engine(pk, weights)
    try:
        prompt = _prompt(40)
        shipped = []
        s = eng.generate(prompt, max_new_tokens=MAX_NEW, logprobs=True,
                         kv_sink=lambda kv, st, tot: shipped.append((kv, st)))
        toks = list(s)
        assert len(toks) == 1  # exactly the sampled first token
        first, lp = toks[0]
        assert isinstance(first, int) and isinstance(lp, float)
        pos = 0
        for kv, st in shipped:
            assert st == pos
            pos += kv.plen
        assert pos == 40
        assert len(shipped) >= 2  # chunked: mid ranges + settled tail
        time.sleep(0.2)  # let the loop settle the row
        whole = pk.quant.concat_blocks([kv for kv, _ in shipped])
        row = eng._kv_row_get(eng.cache, 0, 40)
        assert np.array_equal(whole.k, row.k)
        assert np.array_equal(whole.v, row.v)
        assert np.array_equal(whole.k_scale, row.k_scale)
        # the slot retired: a second request admits into a free slot
        assert eng.stats()["active"] == 0
    finally:
        eng.close()


def test_kv_only_rejected_on_paged_and_with_ingest(pk, weights):
    eng = _engine(pk, weights, paged_blocks=24, paged_block_size=16)
    try:
        with pytest.raises(pk.GenerationError):
            eng.generate(_prompt(10), kv_sink=lambda *a: None)
    finally:
        eng.close()


def test_kv_sink_failure_fails_request_not_engine(pk, weights):
    """A sink that raises (peer died, window stalled) fails THAT request
    through the cancel-retire path; the engine keeps serving the next
    request token-exact, never loop recovery."""
    eng = _engine(pk, weights)
    try:
        def bad_sink(kv, st, tot):
            raise OSError("peer vanished")

        s = eng.generate(_prompt(40), max_new_tokens=4, kv_sink=bad_sink)
        with pytest.raises(Exception, match="kv ship failed"):
            s.tokens()
        out = eng.generate(_prompt(40), max_new_tokens=MAX_NEW).tokens()
        ref = _engine(pk, weights)
        try:
            want = ref.generate(_prompt(40), max_new_tokens=MAX_NEW).tokens()
        finally:
            ref.close()
        assert out == want
        assert eng.down is None
    finally:
        eng.close()


# -- generator: ingest (decode-side install) ---------------------------------

def _prefill_kv(pk, weights, prompt):
    """Run a real prefill-only pass and return (HostKV, first, lp)."""
    pre = _engine(pk, weights)
    try:
        shipped = []
        s = pre.generate(prompt, max_new_tokens=MAX_NEW, logprobs=True,
                         kv_sink=lambda kv, st, tot: shipped.append(kv))
        first, lp = list(s)[0]
        return pk.quant.concat_blocks(shipped), first, lp
    finally:
        pre.close()


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_ingest_token_exact_vs_fused(pk, weights, paged):
    kw = {"paged_blocks": 24, "paged_block_size": 16} if paged else {}
    refs = _refs(pk, weights)
    dec = _engine(pk, weights, **kw)
    try:
        for n in (10, 40, 100):
            kv, first, lp = _prefill_kv(pk, weights, _prompt(n))
            out = dec.generate(_prompt(n), max_new_tokens=MAX_NEW,
                               ingest=(kv, first, lp)).tokens()
            assert out == refs[n], (n, out, refs[n])
    finally:
        dec.close()


def test_ingest_validation_rejects_mismatched_payloads(pk, weights):
    dec = _engine(pk, weights)
    try:
        kv, first, lp = _prefill_kv(pk, weights, _prompt(20))
        with pytest.raises(pk.GenerationError, match="incomplete"):
            dec.generate(_prompt(21), ingest=(kv, first, lp))
        bad = kv._replace(k=kv.k[:1])  # wrong layer count
        with pytest.raises(pk.GenerationError, match="layout"):
            dec.generate(_prompt(20), ingest=(bad, first, lp))
        noscale = kv._replace(k_scale=None, v_scale=None)
        with pytest.raises(pk.GenerationError, match="scale"):
            dec.generate(_prompt(20), ingest=(noscale, first, lp))
    finally:
        dec.close()


def test_ingest_promotes_into_t0_pool_row(pk, weights):
    """Ingested KV rides the normal prefix-store: a repeat of the same
    prompt on the decode worker hits the LOCAL T0 pool (one row copy, no
    second ship needed)."""
    dec = _engine(pk, weights, prefix_cache_slots=2, prefix_store_min=16)
    try:
        prompt = _prompt(40)
        kv, first, lp = _prefill_kv(pk, weights, prompt)
        s1 = dec.generate(prompt, max_new_tokens=MAX_NEW,
                          ingest=(kv, first, lp))
        out1 = s1.tokens()
        assert s1.cache_tier == "pd-ship" and s1.cache_tokens == 40
        s2 = dec.generate(prompt, max_new_tokens=MAX_NEW)
        out2 = s2.tokens()
        assert out2 == out1
        assert s2.cache_tier == "t0" and s2.cache_tokens > 0
    finally:
        dec.close()


def test_ingest_deadline_expiry_is_post_handoff(pk, weights):
    """A shipped request whose deadline dies on the decode worker is
    recorded there with where=post-handoff: the JAX engine's wide event,
    the port's expiry count (it has no wide events yet)."""
    buf = io.StringIO()
    kw = {}
    if pk.name == "gofr_tpu":
        m = Manager()
        register_framework_metrics(m)
        kw = dict(metrics=m, logger=Logger(level=LogLevel.INFO, out=buf,
                                           err=buf, pretty=False),
                  observe=Observe(metrics=m, timeline=Timeline(capacity=512)))
    dec = _engine(pk, weights, **kw)
    try:
        kv, first, lp = _prefill_kv(pk, weights, _prompt(20))
        # blockade: both slots busy with long local streams, so the
        # shipped request deterministically waits out its deadline in
        # the queue (the transfer burned it) and expires DECODE-side
        busy = [dec.generate(_prompt(20, seed=s), max_new_tokens=100)
                for s in (1, 2)]
        for b in busy:
            next(iter(b))  # both admitted and streaming
        s = dec.generate(_prompt(20), max_new_tokens=MAX_NEW,
                         ingest=(kv, first, lp),
                         deadline=pk.Deadline.after(0.005))
        with pytest.raises(pk.errors.DeadlineExceeded):
            s.tokens()
        for b in busy:
            b.cancel()
        time.sleep(0.3)  # the wide event lands after the stream's error
        assert s.where == "post-handoff"
        assert pk.expiries(dec, buf) == ["post-handoff"]
    finally:
        dec.close()


def test_ingest_joins_the_shippers_trace(pk, weights):
    """traceparent propagation: the decode-side stream adopts the prefill
    worker's trace id, so both processes' spans join one distributed
    trace."""
    dec = _engine(pk, weights, observe=True)
    try:
        kv, first, lp = _prefill_kv(pk, weights, _prompt(10))
        tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
        s = dec.generate(_prompt(10), max_new_tokens=4,
                         ingest=(kv, first, lp), traceparent=tp)
        s.tokens()
        assert s.trace_id == "ab" * 16
        assert s.traceparent == tp
    finally:
        dec.close()


def test_ingest_hbm_exhaustion_sheds_429(pk, weights):
    """Decode-side memory pressure at the ingest stage lease degrades the
    ONE request to a 429 + Retry-After (HBMExhausted IS TooManyRequests);
    the engine keeps serving. The budget leaves an eighth of the
    package's own stage upload (``stage_bytes``)."""
    dec = _engine(pk, weights)
    try:
        kv, first, lp = _prefill_kv(pk, weights, _prompt(40))
        stage = pk.stage_bytes(kv)
        pk.hbm.set_budget(pk.hbm.arbiter_stats()["in_use_bytes"]
                          + stage // 8)
        s = dec.generate(_prompt(40), max_new_tokens=4,
                         ingest=(kv, first, lp))
        with pytest.raises(pk.errors.TooManyRequests) as ei:
            s.tokens()
        assert ei.value.status_code == 429
        assert ei.value.retry_after is not None
        pk.hbm.set_budget(None)
        out = dec.generate(_prompt(40), max_new_tokens=4,
                           ingest=(kv, first, lp)).tokens()
        assert len(out) == 4 and dec.down is None
    finally:
        pk.hbm.set_budget(None)
        dec.close()


# -- the socket path ----------------------------------------------------------

@pytest.fixture()
def pd_pair(pk, weights):
    """A live (prefill worker, decode worker) pair over localhost."""
    fp = _fp(pk, weights)
    dec = _engine(pk, weights)
    srv = pk.pd.KVIngestServer(dec, fp, "127.0.0.1", 0)
    pre = _engine(pk, weights)
    coord = pk.pd.PDPrefill(pre, fp, "127.0.0.1", srv.port, ship_block=16)
    yield coord, pre, srv, dec
    coord.close()
    srv.close()
    pre.close()
    dec.close()


def test_socket_end_to_end_token_exact(pk, weights, pd_pair):
    refs = _refs(pk, weights)
    coord = pd_pair[0]
    for n in (10, 40, 100):
        out = coord.generate(_prompt(n), max_new_tokens=MAX_NEW).tokens()
        assert out == refs[n], (n, out, refs[n])
    assert coord.stats()["relayed"] == 3


def test_chaos_ingest_fault_rejects_typed_then_recovers(pk, weights,
                                                        pd_pair):
    """The pd.ingest seam (chaos.PD_INGEST): an injected fault at the
    decode worker's kv-frame boundary fails THAT transfer with the typed
    502 reject, never the worker, and the same pair serves token-exact
    once the injection budget is spent."""
    refs = _refs(pk, weights)
    coord, _, srv, _ = pd_pair
    pk.chaos.install(pk.chaos.ChaosSchedule(seed=0).on(
        pk.chaos.PD_INGEST, error=lambda: OSError("chaos: ingest torn"),
        every=1, limit=1))
    try:
        rs = coord.generate(_prompt(40), max_new_tokens=MAX_NEW)
        with pytest.raises(pk.pd.KVTransferError,
                           match="injected ingest fault"):
            rs.tokens()
        assert srv.frame_rejects >= 1
        out = coord.generate(_prompt(40), max_new_tokens=MAX_NEW).tokens()
        assert out == refs[40]
    finally:
        pk.chaos.uninstall()


def test_relay_stream_supports_transport_sinks(pk, weights, pd_pair):
    """RelayStream is a PushStream: a transport's zero-handoff sink sees
    every token."""
    refs = _refs(pk, weights)
    coord = pd_pair[0]
    got = []
    rs = coord.generate(_prompt(10), max_new_tokens=MAX_NEW)
    rs.set_sink(lambda item: (got.append(item), True)[1])
    for _ in rs:   # the terminal rides the queue
        pass
    assert got == refs[10]


def test_peer_kill_sheds_typed_and_recovers(pk, weights):
    """Kill the decode worker mid-run: the in-flight relay sheds typed
    503 + Retry-After (its re-handoff finds no peer within the wait), the
    prefill worker keeps serving, and a restarted decode pool serves
    token-exact again."""
    refs = _refs(pk, weights)
    fp = _fp(pk, weights)
    dec = _engine(pk, weights)
    srv = pk.pd.KVIngestServer(dec, fp, "127.0.0.1", 0)
    pre = _engine(pk, weights)
    coord = pk.pd.PDPrefill(pre, fp, "127.0.0.1", srv.port, ship_block=16)
    try:
        assert coord.generate(_prompt(40),
                              max_new_tokens=MAX_NEW).tokens() == refs[40]
        rs = coord.generate(_prompt(40), max_new_tokens=64)
        it = iter(rs)
        next(it)          # streaming...
        srv.close()
        dec.close()       # decode worker dies mid-stream
        with pytest.raises(pk.pd.DecodePeerUnavailable) as ei:
            for _ in it:
                pass
        assert ei.value.status_code == 503
        assert "Retry-After" in ei.value.headers
        assert pre.down is None
        local = pre.generate(_prompt(10), max_new_tokens=MAX_NEW,
                             logprobs=True, kv_sink=lambda *a: None)
        assert len(list(local)) == 1
        dec2 = _engine(pk, weights)
        srv2 = pk.pd.KVIngestServer(dec2, fp, "127.0.0.1", 0)
        try:
            coord.peer = ("127.0.0.1", srv2.port)
            coord._reconnect.reset()
            out = coord.generate(_prompt(40),
                                 max_new_tokens=MAX_NEW).tokens()
            assert out == refs[40]
            assert coord.stats()["peer_losses"] == 1
        finally:
            srv2.close()
            dec2.close()
    finally:
        coord.close()
        srv.close()
        pre.close()
        dec.close()


def test_decode_shed_relays_429_over_the_wire(pk, weights):
    """Decode-side HBMExhausted crosses the boundary typed: the client on
    the prefill worker sees 429 + Retry-After, and the next request
    (pressure cleared) serves."""
    fp = _fp(pk, weights)
    dec = _engine(pk, weights)
    srv = pk.pd.KVIngestServer(dec, fp, "127.0.0.1", 0)
    pre = _engine(pk, weights)
    coord = pk.pd.PDPrefill(pre, fp, "127.0.0.1", srv.port, ship_block=16)
    try:
        assert len(coord.generate(_prompt(40),
                                  max_new_tokens=4).tokens()) == 4
        pk.hbm.set_budget(pk.hbm.arbiter_stats()["in_use_bytes"] + 1024)
        rs = coord.generate(_prompt(40), max_new_tokens=4)
        with pytest.raises(pk.errors.TooManyRequests) as ei:
            rs.tokens()
        assert ei.value.status_code == 429
        pk.hbm.set_budget(None)
        assert len(coord.generate(_prompt(40),
                                  max_new_tokens=4).tokens()) == 4
    finally:
        pk.hbm.set_budget(None)
        coord.close()
        srv.close()
        pre.close()
        dec.close()


# -- transfer-boundary corruption ---------------------------------------------

class _RawClient:
    """A hand-rolled protocol speaker for injecting malformed frames."""

    def __init__(self, pdp_, port: int, hello: dict):
        self.pdp = pdp_
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=5)
        self.sock.sendall(pdp_.pack_json(pdp_.HELLO, 0, hello))
        mtype, _, _ = pdp_.read_msg(self.sock)
        assert mtype == pdp_.HELLO_OK

    def send(self, msg: bytes) -> None:
        self.sock.sendall(msg)

    def expect(self, want_type: int, req_id: int):
        while True:
            msg = self.pdp.read_msg(self.sock)
            assert msg is not None, "connection died awaiting reply"
            mtype, rid, payload = msg
            if rid == req_id and mtype == want_type:
                return payload
            assert mtype in (self.pdp.TOK, self.pdp.END, self.pdp.ERR), mtype

    def close(self):
        self.sock.close()


def _req_meta(prompt, deadline_s=None):
    return {"prompt": list(map(int, prompt)), "plen": len(prompt),
            "max_new": 4, "temperature": 0.0, "top_k": 0, "eos": None,
            "adapter": 0, "slo_class": "latency", "deadline_s": deadline_s,
            "traceparent": None}


def _good_frames(pk, weights, prompt, block=16):
    kv, first, lp = _prefill_kv(pk, weights, prompt)
    frames = [(st, pk.quant.encode_block(
        kv.slice_tokens(st, min(st + block, kv.plen))))
        for st in range(0, kv.plen, block)]
    return frames, first, lp


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("fault", ["truncated", "corrupt", "out_of_order",
                                   "incomplete"])
def test_corrupt_transfer_fails_one_request_typed(pk, weights, paged, fault):
    """Every malformed-transfer class fails exactly ONE request with a
    typed 502 and never poisons the worker: the SAME connection then
    serves a clean request token-exact."""
    refs = _refs(pk, weights)
    pdp_ = pk.pdp
    kw = {"paged_blocks": 24, "paged_block_size": 16} if paged else {}
    dec = _engine(pk, weights, **kw)
    srv = pk.pd.KVIngestServer(dec, _fp(pk, weights), "127.0.0.1", 0)
    client = None
    try:
        client = _RawClient(pdp_, srv.port, pdp_.hello_payload(
            _fp(pk, weights), pk.layout()))
        prompt = _prompt(40)
        frames, first, lp = _good_frames(pk, weights, prompt)
        client.send(pdp_.pack_json(pdp_.REQ, 1, _req_meta(prompt)))
        if fault == "truncated":
            st, frame = frames[0]
            client.send(pdp_.pack_kv(1, st, frame[:len(frame) // 2]))
        elif fault == "corrupt":
            st, frame = frames[0]
            bad = bytearray(frame)
            bad[len(bad) // 2] ^= 0xFF
            client.send(pdp_.pack_kv(1, st, bytes(bad)))
        elif fault == "out_of_order":
            st, frame = frames[1]
            client.send(pdp_.pack_kv(1, st, frame))
        else:  # incomplete: EOF before all frames landed
            st, frame = frames[0]
            client.send(pdp_.pack_kv(1, st, frame))
            client.send(pdp_.pack_json(pdp_.KV_EOF, 1, {
                "first_token": int(first), "first_lp": float(lp),
                "plen": len(prompt)}))
        err = json.loads(bytes(client.expect(pdp_.ERR, 1)))
        assert err["code"] == 502, err
        assert srv.frame_rejects >= 1
        client.send(pdp_.pack_json(pdp_.REQ, 2, _req_meta(prompt)))
        for st, frame in frames:
            client.send(pdp_.pack_kv(2, st, frame))
        client.send(pdp_.pack_json(pdp_.KV_EOF, 2, {
            "first_token": int(first), "first_lp": float(lp),
            "plen": len(prompt)}))
        toks = []  # tokens 2+ relay; the first is the shipper's
        while True:
            msg = pdp_.read_msg(client.sock)
            assert msg is not None
            mtype, rid, payload = msg
            if mtype == pdp_.TOK and rid == 2:
                toks.append(pdp_.unpack_tok(payload)[0])
            elif mtype == pdp_.END and rid == 2:
                break
            elif mtype == pdp_.ERR:
                pytest.fail(f"clean request failed: {bytes(payload)}")
        assert [int(first)] + toks == refs[40][:4]
        assert dec.down is None
    finally:
        if client is not None:
            client.close()
        srv.close()
        dec.close()


def test_hello_refused_on_fingerprint_mismatch(pk, weights):
    pdp_ = pk.pdp
    dec = _engine(pk, weights)
    srv = pk.pd.KVIngestServer(dec, _fp(pk, weights), "127.0.0.1", 0)
    try:
        sock = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        sock.sendall(pdp_.pack_json(pdp_.HELLO, 0, pdp_.hello_payload(
            "someone-elses-model", pk.layout())))
        mtype, _, payload = pdp_.read_msg(sock)
        assert mtype == pdp_.ERR
        assert "fingerprint" in json.loads(bytes(payload))["message"]
        assert pdp_.read_msg(sock) is None  # server closed the conn
        sock.close()
        assert srv.refused_hellos == 1
    finally:
        srv.close()
        dec.close()


# -- tests/test_resume.py's decode-death re-handoff ---------------------------

@pytest.fixture(scope="module")
def weights1():
    return _weights(1)


def test_pd_rehandoff_decode_death_resumes_token_exact(pk, weights1):
    """Kill the decode worker mid-stream; the prefill coordinator re-hands
    the relay off to a restarted decode pool (re-shipping KV for
    prompt+emitted) and the SAME RelayStream finishes token-exact: the
    consumer never sees the death."""
    def _eng():
        return pk.make(weights1[pk.side], slots=2, max_seq=128,
                       prompt_buckets=(16, 32))

    fingerprint = pk.fingerprint(pk.cfg, weights1[pk.side], extra="pd")
    dec, dec2 = _eng(), _eng()
    srv = pk.pd.KVIngestServer(dec, fingerprint, "127.0.0.1", 0)
    srv2 = pk.pd.KVIngestServer(dec2, fingerprint, "127.0.0.1", 0)
    pre = _eng()
    coord = pk.pd.PDPrefill(pre, fingerprint, "127.0.0.1", srv.port,
                            ship_block=16, resume_wait_s=30.0)
    try:
        prompt = _prompt(24, seed=51)
        ref = coord.generate(prompt, max_new_tokens=16).tokens()
        rs = coord.generate(prompt, max_new_tokens=16)
        it = iter(rs)
        got = [next(it) for _ in range(3)]
        assert got == ref[:3]
        srv.close()
        dec.close()           # the decode worker dies mid-stream
        coord.peer = ("127.0.0.1", srv2.port)  # "restarted" pool
        coord._reconnect.reset()
        rest = list(it)       # the re-handoff finishes the stream
        assert got + rest == ref
        st = coord.stats()
        assert st["resumed"] == 1
        assert st["peer_losses"] == 1
        assert rs.resumes == 1
    finally:
        coord.close()
        srv.close()
        srv2.close()
        pre.close()
        dec.close()
        dec2.close()


# -- across the packages ------------------------------------------------------

@pytest.mark.parametrize("pre_pkg,dec_pkg,paged", [
    ("gofr_tpu", "gofr_tpu_torch", False),
    ("gofr_tpu", "gofr_tpu_torch", True),
    ("gofr_tpu_torch", "gofr_tpu", False),
], ids=["jax-to-port", "jax-to-port-paged", "port-to-jax"])
def test_a_prefill_worker_ships_to_the_other_package(weights, pre_pkg,
                                                     dec_pkg, paged):
    """One package's coordinator against the other's ingest server: the
    hello agrees (version, fingerprint, geometry), every frame decodes on
    the other side, and each stream equals the JAX fused engine's."""
    want = _refs(PACKAGES["gofr_tpu"], weights)
    p_pk, d_pk = PACKAGES[pre_pkg], PACKAGES[dec_pkg]
    assert _fp(p_pk, weights) == _fp(d_pk, weights)
    kw = {"paged_blocks": 24, "paged_block_size": 16} if paged else {}
    dec = _engine(d_pk, weights, **kw)
    srv = d_pk.pd.KVIngestServer(dec, _fp(d_pk, weights), "127.0.0.1", 0)
    pre = _engine(p_pk, weights)
    coord = p_pk.pd.PDPrefill(pre, _fp(p_pk, weights), "127.0.0.1",
                              srv.port, ship_block=16)
    try:
        for n in (10, 40, 100):
            out = coord.generate(_prompt(n), max_new_tokens=MAX_NEW).tokens()
            assert out == want[n], (n, out, want[n])
        assert srv.stats()["ingests"] == 3
        assert srv.stats()["frame_rejects"] == 0
    finally:
        coord.close()
        srv.close()
        pre.close()
        dec.close()


class _FrameTap:
    """A stand-in connection for a package's ``_Shipper``: keeps every KV
    message it is asked to send."""

    def __init__(self, pdp_):
        self.pdp = pdp_
        self.frames: list[tuple[int, bytes]] = []

    def send_windowed(self, msg: bytes, deadline_s: float = 30.0) -> None:
        mtype, _, payload = self.pdp.read_msg(_Bytes(msg))
        assert mtype == self.pdp.KV
        self.frames.append(self.pdp.unpack_kv(payload))

    def pending_bytes(self) -> int:
        return 0


class _Bytes:
    """``recv`` over one buffer, for ``read_msg``."""

    def __init__(self, data: bytes):
        self.data = data

    def recv(self, n: int) -> bytes:
        out, self.data = self.data[:n], self.data[n:]
        return out


def _shipped_frames(pk, weights, n):
    """The frames a package's shipper cuts (``TPU_PD_BLOCK`` 16) from a
    prefill-only pass of an n-token prompt, and the settled slot row."""
    eng = _engine(pk, weights)
    try:
        tap = _FrameTap(pk.pdp)
        ship = pk.prefill._Shipper(tap, 1, 16)
        s = eng.generate(_prompt(n), max_new_tokens=MAX_NEW, kv_sink=ship.ship)
        s.tokens()
        ship.finish()
        time.sleep(0.1)
        return tap.frames, eng._kv_row_get(eng.cache, 0, n)
    finally:
        eng.close()


@pytest.mark.parametrize("n", [10, 40, 100])
def test_the_port_ships_its_own_row_and_jax_s_frames(weights, n):
    """The port's frames decode to its own slot row byte for byte (one
    frame per 16 positions, in order), and agree with the JAX shipper's
    frames for the same prompt within one int8 code and 1e-5 relative on
    the scales (XLA's K/V can part from the port's by an ulp)."""
    port = PACKAGES["gofr_tpu_torch"]
    frames, row = _shipped_frames(port, weights, n)
    jframes, _ = _shipped_frames(PACKAGES["gofr_tpu"], weights, n)
    layout = port.layout()
    assert [st for st, _ in frames] == list(range(0, n, 16))
    kv = quant.concat_blocks([quant.decode_block(f, layout)
                              for _, f in frames])
    for got, want in zip(kv, row):
        assert torch.equal(got, want)
    assert [st for st, _ in jframes] == [st for st, _ in frames]
    jlayout = PACKAGES["gofr_tpu"].layout()
    for (_, f), (_, jf) in zip(frames, jframes):
        a, b = quant.decode_block(f, layout), jquant.decode_block(jf, jlayout)
        for plane in (0, 1):
            diff = np.abs(a[plane].numpy().astype(np.int32)
                          - b[plane].astype(np.int32))
            assert diff.max() <= 1
        for plane in (2, 3):
            np.testing.assert_allclose(a[plane].numpy(), b[plane],
                                       rtol=1e-5, atol=0)


def test_threads_end_with_close(pk, weights, pd_pair):
    """After one relayed request, closing the pair leaves no P/D thread
    (``gofr-pd-*``) alive."""
    coord, pre, srv, dec = pd_pair
    assert coord.generate(_prompt(10), max_new_tokens=4).tokens()
    coord.close()
    srv.close()
    end = time.monotonic() + 5
    while time.monotonic() < end and any(
            t.name.startswith("gofr-pd-") for t in threading.enumerate()):
        time.sleep(0.01)
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith("gofr-pd-")]


def test_a_paged_engine_with_no_lattice_installs_an_ingest(weights):
    """A paged engine with no lattice and no prefix index still holds the
    scratch row and its write-back graph from construction (every paged
    engine does), so an ingest installs token-exact against its fused
    answer."""
    port = PACKAGES["gofr_tpu_torch"]
    kv, first, lp = _prefill_kv(port, weights, _prompt(10))
    dec = _engine(port, weights, max_seq=32, prompt_buckets=(16, 32),
                  paged_blocks=8, paged_block_size=16)
    try:
        assert not dec._lattice and dec._scratch is not None
        want = dec.generate(_prompt(10), max_new_tokens=8).tokens()
        assert dec.generate(_prompt(10), max_new_tokens=8,
                            ingest=(kv, first, lp)).tokens() == want
    finally:
        dec.close()


def test_a_paged_ingest_waits_for_the_lattice_s_scratch_row(weights):
    """A paged decode worker serving a local 100-token prompt (the chunk
    lattice on tiny's buckets, interleave on) while an ingest is queued:
    the lattice's admission pass between mid chunks must not install the
    ingest, whose rows would land in the scratch row the lattice is
    filling. The ingest is deferred until the lattice lands, and both
    streams equal their fused answers. (The JAX engine admits it there;
    ROADMAP section 3.)"""
    port = PACKAGES["gofr_tpu_torch"]
    refs = _refs(port, weights)
    kv, first, lp = _prefill_kv(port, weights, _prompt(40, seed=9))
    dec = _engine(port, weights, paged_blocks=24, paged_block_size=16)
    seen = []
    install = dec._ingest_install

    def watched(*a):
        seen.append((dec._scratch_busy, dec._lattice_deferred))
        return install(*a)

    dec._ingest_install = watched
    try:
        assert dec._chunk_interleave
        want = dec.generate(_prompt(40, seed=9),
                            max_new_tokens=MAX_NEW).tokens()
        with dec._device_lock:
            local = dec.generate(_prompt(100), max_new_tokens=MAX_NEW)
            shipped = dec.generate(_prompt(40, seed=9),
                                   max_new_tokens=MAX_NEW,
                                   ingest=(kv, first, lp))
        assert local.tokens() == refs[100]
        assert shipped.tokens() == want
        # installed once, after the lattice had deferred it
        assert seen == [(False, True)]
    finally:
        dec.close()
