"""The port's memory arbiter (gofr_tpu_torch.tpu.hbm) against the JAX
package's (gofr_tpu.tpu.hbm): the cases of tests/test_hbm_arbiter.py that
need no mesh and no tenants, on the CPU.

- Units, run on both packages where the call is the same: budget
  enforcement at lease time and the 429 with ``Retry-After``, SET
  semantics through ``account``, reclaim order by priority (scratch,
  then caches), a dead owner's callback purged, the out-of-memory
  classifier, ``check``'s overshoot reclaim, ``alloc``'s one retry on
  ``torch.OutOfMemoryError`` and its rollback, the leased size checked
  against the allocation, atomic check-and-reserve, the metrics face,
  the seeded ``HBM_ALLOC`` seam, ``configure``, and ``arbiter_stats``
  with JAX's keys.
- The engine: T0 shrinks toward the host tier when a second lease needs
  the room, and the streams stay JAX's tokens; a shrink whose smaller
  pool cannot be allocated disables the tiers; a seeded ``HBM_ALLOC``
  storm sheds exactly the requests JAX's engine sheds, through the
  gate's shed surface; a recovery re-settles the same leases.
- The batcher's reclaim: a transient device OOM reclaims and retries, a
  persistent one sheds with 429 counted as the arbiter's ``batcher``
  shed, a chaos injection recovers through the retry, other errors pass.
- The two Apps' health (``device_memory``, ``hbm_arbiter``) and
  ``/debug/vars`` sections have the same keys.
"""

import contextlib
import gc
import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

import gofr_tpu
from gofr_tpu import chaos as jchaos
from gofr_tpu import metrics as jmetrics
from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu.errors import TooManyRequests as JTooMany
from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.resilience import AdmissionGate as JGate
from gofr_tpu.tpu import GenerationEngine as JaxEngine
from gofr_tpu.tpu import hbm as jhbm
from gofr_tpu.tpu.batcher import CoalescingBatcher as JBatcher
from gofr_tpu.tpu.checkpoint import save_npz
from gofr_tpu.tpu.kvcache import KVCacheOptions as JOptions
import gofr_tpu_torch
from gofr_tpu_torch import chaos as pchaos
from gofr_tpu_torch import metrics as pmetrics
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.errors import TooManyRequests as PTooMany
from gofr_tpu_torch.models import LLAMA_CONFIGS
from gofr_tpu_torch.models import llama as pllama
from gofr_tpu_torch.resilience import AdmissionGate as PGate
from gofr_tpu_torch.tpu import GenerationEngine, from_jax_params
from gofr_tpu_torch.tpu import hbm as phbm
from gofr_tpu_torch.tpu.batcher import CoalescingBatcher as PBatcher
from gofr_tpu_torch.tpu.kvcache import KVCacheOptions

JCFG = JAX_CONFIGS["tiny"]
CFG = LLAMA_CONFIGS["tiny"]

# (arbiter, chaos, TooManyRequests) per package
SIDES = {"jax": (jhbm, jchaos, JTooMany), "port": (phbm, pchaos, PTooMany)}


@pytest.fixture(autouse=True)
def _clean_arbiters():
    for h in (jhbm, phbm):
        h.reset()
    yield
    for c in (jchaos, pchaos):
        c.uninstall()
    for h in (jhbm, phbm):
        h.reset()
        h.set_metrics(None)
    gc.collect()


@pytest.fixture(params=list(SIDES))
def side(request):
    return SIDES[request.param]


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init(JCFG, jax.random.PRNGKey(0))
    return jparams, from_jax_params(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def _engine(name, weights, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_seq", 128)
    kw.setdefault("prompt_buckets", (16, 32))
    opts = kw.pop("host_mb", None)
    if name == "jax":
        if opts is not None:
            kw["kvcache"] = JOptions(host_mb=opts)
        return JaxEngine(JCFG, weights[0], **kw)
    if opts is not None:
        kw["kvcache"] = KVCacheOptions(host_mb=opts)
    return GenerationEngine(CFG, weights[1], device="cpu", **kw)


def _prompts(seed=0, n=24):
    rng = np.random.default_rng(seed)
    return lambda: rng.integers(1, JCFG.vocab_size, size=n).tolist()


# -- arbiter units ------------------------------------------------------------

def test_lease_enforces_budget_and_sheds_429(side):
    hbm, _, too_many = side
    o = object()
    hbm.set_budget(100)
    hbm.lease("engine", 80, owner=o, tag="cache")
    with pytest.raises(hbm.HBMExhausted) as ei:
        hbm.lease("kvcache-t0", 40, owner=o, tag="pool")
    e = ei.value
    assert isinstance(e, too_many) and e.status_code == 429
    assert "Retry-After" in e.headers and e.headers["X-Shed-Reason"] == "hbm"
    st = hbm.arbiter_stats()
    assert st["sheds"] == {"kvcache-t0": 1}
    assert st["in_use_bytes"] == 80  # the failed lease reserved nothing


def test_lease_settles_via_account_set_semantics():
    o = object()
    phbm.set_budget(1 << 20)
    phbm.lease("engine", 512, owner=o, tag="cache")
    assert phbm.live_bytes() == {"engine": 512}
    # the real allocation replaces the reservation (same key): numpy and
    # torch leaves alike, and a KV cache's dataclass leaves
    phbm.account("engine", np.zeros((16,), np.float32), owner=o, tag="cache")
    assert phbm.live_bytes() == {"engine": 64}
    cache = pllama.init_cache(CFG, 2, 16, dtype=torch.int8, device="cpu")
    phbm.account("engine", cache, owner=o, tag="cache")
    vec = CFG.n_layers * 2 * 16 * CFG.n_kv_heads
    assert phbm.live_bytes() == {"engine": 2 * vec * CFG.head_dim
                                 + 2 * vec * 4 + 2 * 4}
    phbm.lease("engine", 128, owner=o, tag="cache")
    assert phbm.live_bytes() == {"engine": 128}


def test_reclaim_priority_order_scratch_before_cache(side):
    hbm = side[0]
    o = object()
    order = []

    def make_cb(name, freed, key_tag):
        def cb(need):
            order.append(name)
            hbm.release(owner=o, tag=key_tag)
            return freed
        return cb

    hbm.set_budget(300)
    hbm.lease("engine", 100, owner=o, tag="serving",
              priority=hbm.PRI_SERVING)
    hbm.lease("kvcache-t0", 100, owner=o, tag="pool", priority=hbm.PRI_CACHE,
              reclaim=make_cb("cache", 100, "pool"))
    hbm.lease("engine", 100, owner=o, tag="scratch",
              priority=hbm.PRI_SCRATCH,
              reclaim=make_cb("scratch", 100, "scratch"))
    hbm.lease("lora", 100, owner=o, tag="l")
    assert order == ["scratch"]
    hbm.lease("lora", 100, owner=o, tag="l2")
    assert order == ["scratch", "cache"]
    st = hbm.arbiter_stats()
    assert st["reclaims"] == {"engine": 1, "kvcache-t0": 1}
    assert st["reclaimed_bytes"] == 200


def test_dead_owner_reclaim_callback_is_purged(side):
    hbm = side[0]

    class Owner:
        def cb(self, need):  # pragma: no cover — must never run
            raise AssertionError("dead owner's reclaimer invoked")

    o = Owner()
    hbm.set_budget(200)
    hbm.lease("engine", 150, owner=o, tag="x", reclaim=o.cb)
    del o
    gc.collect()
    assert hbm.live_bytes() == {}
    hbm.lease("engine", 180, owner=object(), tag="y")


def test_an_owner_collected_while_the_registry_lock_is_held_is_released():
    """An owner's finalizer may run inside the garbage collector while
    this very thread holds the port registry's lock (any allocation in a
    registry call can collect): it must not wait for that lock (a
    deadlock that hung a whole test run) and the owner's entries go at
    the registry's next call."""
    class Owner:
        pass

    phbm.reset()
    o = Owner()
    phbm.account("engine", np.zeros(16, np.int64), owner=o, tag="x")
    reg = phbm._registry
    done = threading.Event()

    def collect_under_the_lock():
        nonlocal o
        with reg._locked():
            o = None
            gc.collect()
        done.set()

    t = threading.Thread(target=collect_under_the_lock, daemon=True)
    t.start()
    assert done.wait(10), "a finalizer waited for the registry lock"
    assert phbm.live_bytes() == {}
    phbm.reset()


def test_two_leases_on_one_device_cannot_both_pass_its_budget(monkeypatch):
    """The per-device budget is checked and the lease recorded under one
    hold of the registry lock: a second lease on the device that runs the
    moment the first one's lock hold ends (here inline, on the first
    release) sees the first one's bytes and is refused."""
    phbm.reset()
    reg = phbm._registry
    phbm.set_device_budget(100)
    locked = reg._locked
    owner = type("Owner", (), {})()
    second: list = []

    @contextlib.contextmanager
    def then_the_second_lease():
        with locked():
            yield
        if not second:
            second.append(None)
            try:
                second[0] = phbm.lease("engine", 60, owner=owner, tag="b",
                                       device="cuda:0", rank=1)
            except phbm.HBMExhausted as e:
                second[0] = e

    monkeypatch.setattr(reg, "_locked", then_the_second_lease)
    try:
        phbm.lease("engine", 60, owner=owner, tag="a", device="cuda:0",
                   rank=0)
        assert isinstance(second[0], phbm.HBMExhausted)
        assert "cuda:0" in str(second[0])
        assert sum(r["bytes"] for r in phbm.arbiter_stats()["leases"]
                   if r.get("device") == "cuda:0") == 60
    finally:
        monkeypatch.undo()
        phbm.reset()


def test_is_oom_error_classification():
    for hbm, chaos, _ in SIDES.values():
        assert hbm.is_oom_error(chaos.ResourceExhausted())
        assert hbm.is_oom_error(hbm.HBMExhausted("engine", 4))
        assert hbm.is_oom_error(RuntimeError("RESOURCE_EXHAUSTED: alloc"))
        assert hbm.is_oom_error(RuntimeError("Out of memory while trying"))
        assert not hbm.is_oom_error(RuntimeError("device tunnel dropped"))
        assert not hbm.is_oom_error(ValueError("RESOURCE_EXHAUSTED"))
        assert not hbm.is_oom_error(chaos.DeviceLost("gone"))
    # the caching allocator's own type, whatever its message
    assert phbm.is_oom_error(torch.OutOfMemoryError("CUDA: 20 MiB"))


def test_check_reclaims_budget_overshoot_then_sheds(side):
    hbm = side[0]
    o = object()
    calls = []

    def cb(need):
        calls.append(need)
        return 0

    hbm.lease("engine", 100, owner=o, tag="c", reclaim=cb)
    hbm.check("engine")  # no budget: free pass
    hbm.set_budget(60)
    with pytest.raises(hbm.HBMExhausted):
        hbm.check("engine")
    assert calls == [40]  # asked for exactly the overshoot


def test_alloc_retries_once_after_a_device_oom_then_sheds():
    o = object()
    attempts = {"n": 0}

    def flaky():
        attempts["n"] += 1
        if attempts["n"] == 1:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return torch.zeros((4,), dtype=torch.float32)

    out = phbm.alloc("engine", flaky, nbytes=16, owner=o, tag="c")
    assert out.numel() == 4 and attempts["n"] == 2
    assert phbm.arbiter_stats()["oom_retries"] == {"engine": 1}

    def dead():
        raise torch.OutOfMemoryError("CUDA out of memory")

    with pytest.raises(phbm.HBMExhausted):
        phbm.alloc("engine", dead, nbytes=8, owner=o, tag="d")
    with pytest.raises(ValueError):
        phbm.alloc("engine", lambda: (_ for _ in ()).throw(ValueError("x")),
                   owner=o, tag="e")
    assert phbm.live_bytes() == {"engine": 16}


def test_alloc_failure_rolls_back_the_reservation():
    o = object()
    phbm.set_budget(1000)
    with pytest.raises(ValueError):
        phbm.alloc("engine", lambda: (_ for _ in ()).throw(ValueError("x")),
                   nbytes=400, owner=o, tag="a")
    assert phbm.live_bytes() == {}

    def dead():
        raise torch.OutOfMemoryError("CUDA out of memory")

    with pytest.raises(phbm.HBMExhausted):
        phbm.alloc("engine", dead, nbytes=400, owner=o, tag="b")
    assert phbm.live_bytes() == {}
    # an existing key keeps its settled figure and its lease class
    phbm.alloc("engine", lambda: torch.zeros((8,)), nbytes=32, owner=o,
               tag="cache", priority=phbm.PRI_SERVING)
    with pytest.raises(ValueError):
        phbm.alloc("engine", lambda: (_ for _ in ()).throw(ValueError("x")),
                   nbytes=32, owner=o, tag="cache")
    assert phbm.live_bytes() == {"engine": 32}
    rows = {r["tag"]: r for r in phbm.arbiter_stats()["leases"]}
    assert rows["cache"]["priority"] == "serving"
    phbm.lease("engine", 968, owner=o, tag="c")   # the headroom is intact


def test_alloc_holds_the_allocation_to_its_leased_size():
    """A torch thunk is sized from its shapes by the caller: an
    allocation that holds other bytes than leased is refused, and its
    reservation rolled back."""
    o = object()
    with pytest.raises(ValueError, match="leased 64 bytes"):
        phbm.alloc("engine", lambda: torch.zeros((8,)), nbytes=64, owner=o,
                   tag="x")
    assert phbm.live_bytes() == {}
    got = phbm.alloc("engine", lambda: torch.zeros((16,)), nbytes=64,
                     owner=o, tag="x")
    assert phbm.tree_nbytes(got) == 64 == phbm.live_bytes()["engine"]


def test_concurrent_leases_never_jointly_overcommit(side):
    hbm = side[0]
    hbm.set_budget(1000)
    results = []
    barrier = threading.Barrier(4)

    def one(i):
        o = object()
        barrier.wait()
        try:
            hbm.lease("engine", 400, owner=o, tag=f"t{i}")
            results.append(("ok", o))
        except hbm.HBMExhausted:
            results.append(("shed", None))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert sum(hbm.live_bytes().values()) <= 1000
    assert sum(1 for kind, _ in results if kind == "ok") == 2


def test_the_metrics_face():
    m = pmetrics.Manager()
    pmetrics.register_framework_metrics(m)
    phbm.set_metrics(m)
    o = object()
    phbm.set_budget(100)
    phbm.lease("engine", 60, owner=o, tag="c",
               reclaim=lambda need: phbm.release("engine", owner=o,
                                                 tag="c") and 60 or 60)
    with pytest.raises(phbm.HBMExhausted):
        phbm.lease("kvcache-t0", 200, owner=o, tag="p")  # reclaim + shed
    text = m.render_prometheus()
    assert 'app_tpu_hbm_budget_bytes 100' in text
    assert 'app_tpu_hbm_reclaims_total{subsystem="engine"} 1' in text
    assert 'app_tpu_hbm_shed_total{subsystem="kvcache-t0"} 1' in text
    assert 'app_tpu_device_bytes{subsystem="engine"} 0' in text


def test_the_seam_kills_allocation_n_deterministically(side):
    hbm, chaos, _ = side

    def run():
        out = []
        with chaos.scope(chaos.ChaosSchedule(seed=11).on(
                chaos.HBM_ALLOC, error=chaos.ResourceExhausted, every=3)):
            for _ in range(9):
                try:
                    hbm.check("engine")
                    out.append(True)
                except hbm.HBMExhausted:
                    out.append(False)
        return out

    assert run() == run() == [True, True, False] * 3
    assert hbm.arbiter_stats()["sheds"] == {"engine": 6}


def test_configure_and_the_stats_keys(monkeypatch):
    assert phbm.configure(budget_mb=64) == 64 << 20
    phbm.reset()
    assert phbm.configure(headroom=0.25, device="cpu") is None
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (10 << 30, 80 << 30))
    assert phbm.configure(headroom=0.25, device="cuda") == 60 << 30
    phbm.reset()
    # the same sequence on both arbiters: the same table, key for key
    outs = []
    for hbm, _, _ in SIDES.values():
        o = object()
        hbm.set_budget(1000)
        hbm.lease("engine", 10, owner=o, tag="cache",
                  priority=hbm.PRI_SERVING)
        hbm.lease("engine", 20, owner=o, tag="scratch",
                  priority=hbm.PRI_SCRATCH, reclaim=lambda n: 0)
        hbm.note_shed("batcher")
        st = hbm.arbiter_stats()
        for row in st["leases"]:
            row.pop("owner")
        outs.append(st)
    assert outs[0] == outs[1]
    by_tag = {r["tag"]: r for r in outs[1]["leases"]}
    assert by_tag["cache"]["reclaimable"] is False
    assert by_tag["scratch"]["priority"] == "scratch"


# -- the engine ---------------------------------------------------------------

def test_t0_shrinks_toward_the_host_tier_and_streams_stay_exact(weights):
    """The JAX coexistence case on each engine: a contiguous engine with
    a 4-row T0 and a host tier stores a prompt; a second subsystem's
    lease needs the room of about two rows under a budget that covers
    the engine alone, so the arbiter shrinks T0 (spilling to T1), the
    lease proceeds, and the stored prompt is served back from T1 with
    the engine's own unconstrained tokens."""
    outs = {}
    for name, (hbm, _, _) in SIDES.items():
        p_a, p_b = _prompts(1)(), _prompts(2, 20)()
        eng = _engine(name, weights, prefix_cache_slots=4,
                      prefix_store_min=16, host_mb=8)
        try:
            ref = eng.generate(p_a, max_new_tokens=6).tokens()
            pool_bytes = hbm.live_bytes()["kvcache-t0"]
            row = pool_bytes // 4
            total = sum(hbm.live_bytes().values())
            hbm.set_budget(total + row // 2)
            o = object()
            hbm.lease("spec-decode", 2 * row, owner=o, tag="x",
                      priority=hbm.PRI_SCRATCH)
            st = hbm.arbiter_stats()
            s = eng.generate(p_a, max_new_tokens=6)
            toks = s.tokens()
            other = eng.generate(p_b, max_new_tokens=4).tokens()
            outs[name] = (ref, toks, s.cache_tier, eng._kvc.slots,
                          eng._kvc.host.spills, st["reclaims"],
                          st["in_use_bytes"] <= st["budget_bytes"], other)
            hbm.release(owner=o)
        finally:
            eng.close()
    assert outs["port"] == outs["jax"]
    ref, toks, tier, slots, spills, reclaims, fits, _ = outs["port"]
    assert toks == ref and tier == "t1" and slots == 2 and spills >= 1
    assert reclaims == {"kvcache-t0": 1} and fits


def test_a_failed_shrink_disables_the_tiers_not_the_engine(weights,
                                                           monkeypatch):
    eng = _engine("port", weights, prefix_cache_slots=4, prefix_store_min=16)
    next_p = _prompts(8)
    try:
        assert len(eng.generate(next_p(), max_new_tokens=4).tokens()) == 4
        real = pllama.init_cache

        def failing(cfg, batch, *a, **kw):
            if batch < 4:   # only the shrink's smaller pool fails
                raise torch.OutOfMemoryError("CUDA out of memory")
            return real(cfg, batch, *a, **kw)

        monkeypatch.setattr(pllama, "init_cache", failing)
        assert eng._hbm_pool_reclaim(1) > 0   # the whole pool counts
        assert eng._kvc is None and eng._pool is None
        assert "kvcache-t0" not in phbm.live_bytes()
        monkeypatch.setattr(pllama, "init_cache", real)
        assert len(eng.generate(next_p(), max_new_tokens=4).tokens()) == 4
        assert eng.kvcache_stats() is None
    finally:
        eng.close()


def test_a_seeded_storm_sheds_what_jax_sheds_through_the_gate(weights):
    """tests/test_hbm_arbiter.py's storm and gate cases on both engines:
    every=2 on sequential admissions alternates served and shed; each
    shed is a 429 with Retry-After counted by the gate and by the
    arbiter's engine shed; the engine stays up and token-exact."""
    outs = {}
    for name, (hbm, chaos, too_many) in SIDES.items():
        mmod = jmetrics if name == "jax" else pmetrics
        m = mmod.Manager()
        mmod.register_framework_metrics(m)
        gate = (JGate if name == "jax" else PGate)(
            max_queue_depth=64, name="generate", metrics=m)
        eng = _engine(name, weights, prefix_cache_slots=2,
                      prefix_store_min=16, gate=gate, metrics=m)
        next_p = _prompts(3)
        p0 = next_p()
        try:
            ref = eng.generate(p0, max_new_tokens=6).tokens()
            got = []
            with chaos.scope(chaos.ChaosSchedule(seed=5).on(
                    chaos.HBM_ALLOC, error=chaos.ResourceExhausted,
                    every=2)):
                for _ in range(8):
                    s = eng.generate(next_p(), max_new_tokens=4)
                    try:
                        got.append(s.tokens())
                    except too_many as e:
                        assert e.status_code == 429
                        assert "Retry-After" in e.headers
                        got.append("shed")
            text = m.render_prometheus()
            outs[name] = (got, eng.down, hbm.arbiter_stats()["sheds"],
                          gate.stats()["sheds"],
                          'app_tpu_hbm_shed_total{subsystem="engine"} 4'
                          in text,
                          eng.generate(p0, max_new_tokens=6).tokens() == ref)
        finally:
            eng.close()
    assert outs["port"] == outs["jax"]
    got, down, sheds, gate_sheds, counted, exact = outs["port"]
    assert [g == "shed" for g in got] == [False, True] * 4
    assert down is None and sheds == {"engine": 4} and gate_sheds == 4
    assert counted and exact


def test_a_recovery_resettles_the_same_leases(weights):
    eng = _engine("port", weights, prefix_cache_slots=2, prefix_store_min=16)
    next_p = _prompts(7)
    try:
        before = phbm.live_bytes()
        assert set(before) == {"engine", "kvcache-t0"}
        with pchaos.scope(pchaos.ChaosSchedule(seed=2).on(
                pchaos.GENERATOR_STEP, error=pchaos.DeviceLost, every=1,
                limit=1)):
            with pytest.raises(Exception):
                eng.generate(next_p(), max_new_tokens=4).tokens()
        assert len(eng.generate(next_p(), max_new_tokens=4).tokens()) == 4
        assert eng.down is None and phbm.live_bytes() == before
        rows = {r["tag"]: r for r in phbm.arbiter_stats()["leases"]}
        assert rows["pool"]["priority"] == "cache" \
            and rows["pool"]["reclaimable"]
        assert rows["cache"]["priority"] == "serving"
    finally:
        eng.close()
    assert phbm.live_bytes() == {}   # close released the engine's bytes


# -- the batcher --------------------------------------------------------------

def test_the_batcher_reclaims_and_retries_a_transient_oom():
    reclaimed = []
    o = object()
    phbm.lease("kvcache-t0", 64, owner=o, tag="p", priority=phbm.PRI_CACHE,
               reclaim=lambda need: reclaimed.append(need) or 64)
    calls = {"n": 0}

    def runner(items):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return [x * 2 for x in items]

    b = PBatcher(runner, max_batch=2, max_delay=0.001)
    try:
        assert b.submit(3, timeout=5) == 6
    finally:
        b.close()
    assert calls["n"] == 2 and reclaimed == [64]


def test_the_batcher_sheds_a_persistent_oom_as_the_arbiter_s():
    outs = []
    for name, (hbm, _, too_many) in SIDES.items():
        def runner(items):
            raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")

        b = (JBatcher(runner, max_batch=2, max_delay=0.001,
                      use_native=False) if name == "jax" else
             PBatcher(runner, max_batch=2, max_delay=0.001))
        try:
            with pytest.raises(too_many) as ei:
                b.submit(1, timeout=5)
        finally:
            b.close()
        outs.append((ei.value.status_code, ei.value.retry_after,
                     hbm.arbiter_stats()["sheds"]))
    assert outs[0] == outs[1] == (429, 1.0, {"batcher": 1})


def test_the_batcher_absorbs_an_injected_oom_and_passes_other_errors():
    b = PBatcher(lambda items: [x + 1 for x in items], max_batch=2,
                 max_delay=0.001)
    try:
        with pchaos.scope(pchaos.ChaosSchedule(seed=1).on(
                pchaos.BATCHER_DISPATCH, error=pchaos.ResourceExhausted,
                every=1)):
            assert b.submit(5, timeout=5) == 6
    finally:
        b.close()

    def runner(items):
        raise ValueError("boom")

    b = PBatcher(runner, max_batch=2, max_delay=0.001)
    try:
        with pytest.raises(ValueError):
            b.submit(1, timeout=5)
    finally:
        b.close()


# -- the Apps -----------------------------------------------------------------

def _get_json(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return json.loads(resp.read())


def test_health_and_debug_vars_carry_the_arbiter_on_both_apps(tmp_path):
    """Both Apps from the same rows (a contiguous engine with T0 and T1,
    TPU_HBM_BUDGET_MB): health's ``device_memory`` and ``hbm_arbiter``
    and ``/debug/vars``' sections have the same keys, the same
    subsystems and the same budget."""
    path = str(tmp_path / "tiny.npz")
    save_npz(path, jax.tree.map(np.asarray,
                                jllama.init(JCFG, jax.random.PRNGKey(1))))
    rows = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR",
            "TPU_MODEL": "tiny", "TPU_SLOTS": "2", "TPU_MAX_SEQ": "128",
            "TPU_SEQ_BUCKETS": "16,32", "TPU_PREFIX_CACHE": "2",
            "TPU_KVCACHE_HOST_MB": "4", "TPU_HBM_BUDGET_MB": "64",
            "TPU_HBM_HEADROOM": "0.2", "TPU_WEIGHTS": path}
    outs = {}
    for name in ("jax", "port"):
        if name == "jax":
            app = gofr_tpu.App(JMapConfig(rows))
        else:
            app = gofr_tpu_torch.App(MapConfig(rows), device="cpu")
        app.get("/ping")(lambda ctx: "pong")   # the HTTP server's route
        app.run(block=False)
        try:
            health = _get_json(app.http_port, "/.well-known/health")
            details = health["data"]["tpu"]["details"]
            dvars = _get_json(app.metrics_port, "/debug/vars")
            outs[name] = (
                details["device_memory"] == dvars["device_memory"],
                sorted(details["device_memory"]),
                sorted(details["hbm_arbiter"]),
                details["hbm_arbiter"]["budget_bytes"],
                sorted(dvars["hbm_arbiter"]),
                sorted(dvars["hbm_arbiter"]["leases"][0]),
                sorted((r["subsystem"], r["tag"], r["priority"])
                       for r in dvars["hbm_arbiter"]["leases"]))
        finally:
            app.stop()
    assert outs["port"] == outs["jax"]
    same, subs, _, budget, _, _, leases = outs["port"]
    assert same and subs == ["engine", "kvcache-t0"] and budget == 64 << 20
    assert ("kvcache-t0", "pool", "cache") in leases
