"""Disaggregated prefill/decode serving (the port's own copy of
gofr_tpu/pd; docs/advanced-guide/disaggregated-serving.md).

Prefill is compute-bound and bursty; decode is memory-bound and steady.
``TPU_SERVING_ROLE`` splits them into dedicated pools that scale
independently: **prefill workers** compute prompt KV and ship it as
checksummed int8 block frames (the ``tpu/kvcache/quant.py`` codec) over
one ``wire.py``-backed TCP connection per peer to **decode workers**,
which install the rows with no prefill work and own the token stream.
Deadlines, SLO classes, seeds and W3C trace context cross the boundary
with the request; faults stay typed (502 for a bad transfer, 429 for a
decode-side shed, 504 for a deadline, 503 for a lost peer), and a decode
worker's death mid-stream is re-handed off as a continuation.

The role x engine-kind rule: a prefill worker is contiguous only (it
ships slot rows); a decode worker may be contiguous or paged (a paged
one stages each shipped row in its scratch row and lands it in its
blocks through the write-back graph).

``wire_role`` is the config seam: called by ``new_engine_from_config``
when ``TPU_SERVING_ROLE`` is ``prefill`` or ``decode`` (``fused``, the
default, wires nothing and serves exactly as before).
"""

from __future__ import annotations

from .ingest import KVIngestServer
from .prefill import PDPrefill, RelayStream
from .protocol import DecodePeerUnavailable, KVTransferError

__all__ = ["DecodePeerUnavailable", "KVIngestServer", "KVTransferError",
           "PDPrefill", "ROLES", "RelayStream", "parse_role", "wire_role"]

ROLE_FUSED = "fused"
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLES = (ROLE_FUSED, ROLE_PREFILL, ROLE_DECODE)

DEFAULT_LISTEN = "127.0.0.1:9400"


def parse_role(val: str | None) -> str:
    """``TPU_SERVING_ROLE`` -> role. Unknown values raise: a typo'd role
    silently serving fused would be a silently mis-deployed pool, the
    one misconfiguration class that must fail at startup."""
    role = (val or ROLE_FUSED).strip().lower()
    if role not in ROLES:
        raise ValueError(f"TPU_SERVING_ROLE={val!r}: expected one of "
                         f"{ROLES}")
    return role


def _parse_addr(spec: str, what: str) -> tuple[str, int]:
    host, _, port = spec.strip().rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"{what}={spec!r}: expected host:port")
    return host, int(port)


def wire_role(engine, role: str, cfg, *, logger=None, metrics=None):
    """Attach the role's P/D half to a built engine: a decode worker
    grows the KV-ingest listener (``TPU_PD_LISTEN``); a prefill worker
    grows the coordinator against ``TPU_PD_PEER``. Both sides derive the
    handshake identity from the same model fingerprint the Redis tier
    namespaces by, so two pools serving different weights refuse each
    other at hello instead of exchanging wrong attention state.

    Both roles are refused on a tensor-parallel engine, as the JAX
    package refuses them on a mesh: the shipped KV is dense single-device
    rows, which no shard installs yet (ROADMAP item 11b). The App's rows
    are refused before any engine is built (``tpu._check_rows``); an
    engine built with a ``mesh`` and wired here raises too."""
    gen = engine.generator
    if gen is None:
        raise ValueError(f"TPU_SERVING_ROLE={role}: requires a decoder "
                         "model (TPU_MODEL llama family)")
    if role in (ROLE_PREFILL, ROLE_DECODE) and gen.mesh is not None:
        raise ValueError(
            f"TPU_SERVING_ROLE={role} cannot run with TPU_SHARDING="
            f"{gen.mesh.row()!r}: the KV-ship wire format is dense "
            "single-device rows, and no shard installs them yet. Unset "
            "TPU_SHARDING on this pool, or drop TPU_SERVING_ROLE to "
            "serve the shards fused")
    from ..tpu.kvcache import model_fingerprint

    fingerprint = model_fingerprint(gen.cfg, gen.params, extra="pd")
    window = max(1, cfg.get_int("TPU_PD_WINDOW_MB", 8)) << 20
    if role == ROLE_DECODE:
        host, port = _parse_addr(
            cfg.get_or_default("TPU_PD_LISTEN", DEFAULT_LISTEN),
            "TPU_PD_LISTEN")
        engine.pd_ingest = KVIngestServer(
            gen, fingerprint, host, port, logger=logger, metrics=metrics,
            window_bytes=window)
        engine.serving_role = ROLE_DECODE
        if logger is not None:
            logger.info({"event": "pd decode role wired",
                         "listen": f"{host}:{engine.pd_ingest.port}"})
        return engine.pd_ingest
    if role == ROLE_PREFILL:
        if gen._paged:
            raise ValueError("TPU_SERVING_ROLE=prefill requires a "
                             "contiguous engine (set TPU_PAGED_BLOCKS=0 "
                             "on the prefill pool; the DECODE pool may "
                             "be paged)")
        peer = cfg.get("TPU_PD_PEER")
        if not peer:
            raise ValueError("TPU_SERVING_ROLE=prefill requires "
                             "TPU_PD_PEER=host:port (the decode "
                             "worker's TPU_PD_LISTEN address)")
        host, port = _parse_addr(peer, "TPU_PD_PEER")
        engine.pd_prefill = PDPrefill(
            gen, fingerprint, host, port, logger=logger, metrics=metrics,
            ship_block=max(1, cfg.get_int("TPU_PD_BLOCK", 16)),
            window_bytes=window,
            # durable streams: a decode-peer death mid-stream re-hands
            # the relay off as a continuation instead of shedding it
            resume=cfg.get_bool("TPU_RESUME_PD", True),
            resume_max=cfg.get_int("TPU_RESUME_MAX", 3),
            resume_wait_s=cfg.get_float("TPU_RESUME_WAIT_S", 5.0))
        engine.serving_role = ROLE_PREFILL
        if logger is not None:
            logger.info({"event": "pd prefill role wired",
                         "peer": f"{host}:{port}"})
        return engine.pd_prefill
    engine.serving_role = ROLE_FUSED
    return None
