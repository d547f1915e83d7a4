"""The serving datasource of the port (counterpart of gofr_tpu/tpu):
``new_engine_from_config`` reads the ``TPU_*`` rows this slice honours
and builds the engine reachable as ``ctx.tpu``: a BERT engine with the
``embed`` program, a ViT engine with ``classify``, or a Llama engine
with its generator and the ``score`` program.

Rows read:
  TPU_MODEL         bert-base (alias bert; bert-tiny), vit-l-14 (aliases
                    vit, vit-l14; vit-tiny), or a Llama-family name
                    (llama3-8b, llama-1b, tiny, ...; default tiny)
  TPU_WEIGHTS       a ``.npz`` written by the JAX package's ``save_npz``;
                    absent = random init on the device from seed 0
  TPU_QUANT         "int8" to quantize projection weights on load
  TPU_BATCH_BUCKETS  csv of a predict program's batch buckets (default
                    1,2,4,8; the largest is a dispatch's cap)
  TPU_MAX_BATCH_DELAY  seconds the oldest waiting predict item may wait
                    before a partial batch is dispatched (default 0.004)
  TPU_SLO_BATCH_SHARE  > 0: per-class wait lines in every predict
                    batcher, with this share of each full batch reserved
                    for throughput-class items (default 0 = one FIFO line)
  TPU_SLO_BATCH_DELAY  the throughput line's own flush delay in seconds
                    (default 4 x TPU_MAX_BATCH_DELAY)
  TPU_WARMUP        run every predict program once at every bucket shape
                    when the engine is built
  TPU_KV_DTYPE      KV-cache dtype: "int8" (default, float32 per-vector
                    scales) or anything else for the dense model-dtype
                    cache
  TPU_SLOTS         decode batch slots (default 48)
  TPU_MAX_SEQ       serving KV capacity (default min(model max, 2048))
  TPU_DECODE_BLOCK  decode steps fused per dispatch (default 4)
  TPU_DECODE_PIPELINE  decode blocks in flight on the device at once
                    (default 2, as in JAX; a spec engine runs 1)
  TPU_ADMIT_WINDOW_MS  how often (ms) the loop looks for arrivals to
                    admit while a block runs (default 2.0)
  TPU_SEQ_BUCKETS   csv of sequence buckets (default 32,64,128,256,512):
                    a predict item is padded to its bucket (those up to
                    the model's max_seq, or TPU_MAX_SEQ for score); the
                    generator's prompt buckets are those below
                    TPU_MAX_SEQ, as in JAX: a prompt is padded to its
                    bucket and prefilled by one dispatch; a longer one
                    runs the chunk lattice
  TPU_PREFILL_CHUNK  the lattice's chunk budget: unset = the largest
                    bucket with a decode block interleaved between
                    chunks, <= 0 = the same chunks back to back, else
                    snapped up to a bucket
  TPU_PAGED_BLOCKS  > 0 serves from a paged pool of that many KV blocks
                    shared by all slots (block 0 is the reserved trash
                    block, so size it as live tokens // block + 1);
                    0 or unset keeps contiguous [slots, max_seq] rows
  TPU_PAGED_BLOCK   tokens per paged block (default 128)
  TPU_PREFIX_CACHE  > 0 on a paged engine: zero-copy prefix sharing over
                    the pool with that many stored entries; on a
                    contiguous engine: the hierarchical prefix cache
                    (tpu/kvcache) with a T0 pool of that many rows,
                    tuned by the TPU_KVCACHE_* rows (default 0 = off)
  TPU_PREFIX_MIN    the shortest prompt stored as an entry (default: the
                    largest prompt bucket)
  TPU_KVCACHE_BLOCK  radix block size in tokens (default 16)
  TPU_KVCACHE_HOST_MB  the host-RAM tier (T1) budget in MiB: T0's
                    evicted rows spill there (default 0 = off)
  TPU_KVCACHE_REDIS  "true" shares int8 KV blocks through Redis (T2) at
                    REDIS_HOST / REDIS_PORT, read by this tier only
  TPU_KVCACHE_REDIS_TTL_S  shared-block TTL seconds (default 300)
  TPU_KVCACHE_REDIS_TIMEOUT_S  the tier's socket timeout (default 0.25)
  TPU_KVCACHE_EPOCH_REFRESH_S  adapter-epoch staleness bound (default 5)
  TPU_HBM_BUDGET_MB  the memory arbiter's budget (tpu/hbm) in MiB;
                    unset: on the card its total memory less
                    TPU_HBM_HEADROOM, on the CPU off
  TPU_HBM_HEADROOM  the fraction of the card's memory left outside the
                    budget for what the arbiter does not see: weights,
                    graph pools, workspaces (default 0.1)
  TPU_SPEC_DECODE   k > 0: prompt-lookup speculative decoding with k
                    draft tokens (greedy slots; a verify window of k + 1
                    positions, through the paged window kernel on a
                    paged engine, at most 15 there on the card); 0 or
                    unset: off
  TPU_LORA_ADAPTERS  n > 0: multi-LoRA serving with n adapter slots on
                    the attention projections (slot 0 the base model;
                    ``generate(adapter=i)``, ``load_adapter``); 0 or
                    unset: off
  TPU_LORA_RANK     the adapters' rank (default 16)
  TPU_MAX_QUEUE_DEPTH  the admission gates (the generator's, and one a
                    predict program) shed (TooManyRequests, 429) once
                    this many requests wait (default 0 = off)
  TPU_MAX_QUEUE_DELAY  ... or once the estimated queue wait exceeds this
                    many seconds (default 0 = off)
  TPU_BROWNOUT_DELAY  above this estimated wait (seconds) the gate caps
                    max_new_tokens (default 0 = off)
  TPU_BROWNOUT_MAX_NEW  that cap (default 32)
  TPU_SLO_THROUGHPUT_FACTOR  the fraction of each gate bound that holds
                    for throughput-class requests (default 0.5)
  TPU_SLO_THROUGHPUT_SHARE  the throughput line's share of admissions
                    while latency-class requests also wait (default 0.25)
  TPU_SLO_LATENCY_SLOTS  free slots kept from throughput-class requests
                    for latency-class arrivals (default 1)
  TPU_TENANTS       the multi-tenant serving plane (gofr_tpu_torch/tenancy):
                    the path of a hot-reloadable JSON tenant registry
                    mapping tenant id -> LoRA adapter, SLO-class default,
                    fair-share queue weight, rps/concurrency quota and
                    cache-budget share. Unset and no TPU_TENANTS_INLINE:
                    tenancy off (anonymous single-tenant serving). A file
                    that cannot be read raises, naming the row
  TPU_TENANTS_INLINE  the same registry as a literal JSON string (static;
                    TPU_TENANTS wins when both are set); a document that
                    does not parse raises, naming the row
  TPU_TENANTS_RELOAD_S  the registry file's mtime poll throttle in seconds
                    (default 0.5); a malformed edit keeps the last good
                    table
  TPU_TENANT_HEADER  the HTTP header carrying the tenant id (default
                    X-Tenant-Id; gRPC always reads x-tenant-id
                    metadata), read by the App
  TPU_TENANT_TOPIC  the pub/sub topic the async inference lane consumes
                    (default inference-jobs), read by
                    tenancy.install_async_lane(app)
  TPU_TENANT_CHECKPOINT_EVERY  the async lane's resume-checkpoint cadence
                    in tokens (default 8)

  TPU_SERVING_ROLE  fused (the default), gateway, prefill or decode; a
                    gateway App (gofr_tpu_torch/gateway) builds no
                    engine, so a config naming both raises "builds no
                    engine" here; prefill and decode wire the engine's
                    P/D half (gofr_tpu_torch/pd): a prefill worker must
                    be contiguous and name TPU_PD_PEER, a decode worker
                    may be paged (it then holds the scratch row and the
                    write-back graph from construction)
  TPU_PD_LISTEN     a decode worker's KV-ingest listen address, host:port
                    (default 127.0.0.1:9400; port 0 picks a free one)
  TPU_PD_PEER       a prefill worker's decode peer, host:port (required)
  TPU_PD_BLOCK      tokens a shipped KV frame (default 16)
  TPU_PD_WINDOW_MB  the ship window: KV bytes in flight on a connection
                    before the ship blocks the serving loop (default 8)
  TPU_RESUME_PD     a decode peer's death mid-stream re-hands the relay
                    off as a continuation (default true)
  TPU_RESUME_MAX    re-handoffs a stream (default 3; the gateway reads it
                    too)
  TPU_RESUME_WAIT_S  how long a re-handoff waits for the peer to come
                    back (default 5)

  TPU_SHARDING      "tp=N": serve a Llama model as N tensor-parallel
                    ranks (parallel/): this process is rank 0 and starts
                    N - 1 worker processes, each holding its head shard
                    of the weights and caches (rank r on cuda:{r %
                    device_count}, or the CPU). Any other axis above 1,
                    a tp the model's head counts do not take, an encoder
                    model, LoRA, the prefix caches and the P/D roles
                    raise ShardingConfigError naming the row. A TP
                    engine runs its dispatches eagerly (no CUDA
                    graphs); a rank that dies, or a collective past 60
                    s, fails the live streams and takes it down
  TPU_HBM_DEVICE_BUDGET_MB  each TP rank's budget in MiB on its device
                    (ranks sharing a card are checked together); only
                    beside TPU_SHARDING (a one-device engine's budget
                    is TPU_HBM_BUDGET_MB)

Every other ``TPU_*`` row of the JAX package names a feature this port
does not serve yet; a set one raises with its name rather than being
silently ignored (the gateway reads ``TPU_GATEWAY_*``, ``TPU_RESUME``
and ``TPU_RESUME_MAX`` itself).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..errors import ShardingConfigError
from ..models import bert, llama, vit
from ..models.common import BERT_CONFIGS, LLAMA_CONFIGS, VIT_CONFIGS
from ..ops import kernels
from ..parallel.distributed import MULTIHOST_ROWS
from ..parallel.mesh import parse_sharding
from ..parallel.sharding import check_tp, rank_config
from ..resilience import gate_from_config
from ..tenancy import plane_from_config
from . import hbm
from .batcher import (BatcherClosed, ClassPolicy, CoalescingBatcher,
                      pad_bucket)
from .checkpoint import (WeightSource, from_jax_params, load_npz,
                         maybe_quantize)
from .engine import (DEFAULT_BATCH_BUCKETS, Health, Program, TorchEngine)
from .generator import (DEFAULT_SEQ_BUCKETS, GenerationEngine,
                        GenerationError, GenStream)
from .kvcache import options_from_config

__all__ = ["BatcherClosed", "ClassPolicy", "CoalescingBatcher",
           "GenerationEngine", "GenerationError", "GenStream", "Health",
           "Program", "TorchEngine", "from_jax_params", "load_npz",
           "maybe_quantize", "new_engine_from_config", "pad_bucket"]

# rows of the JAX package that name features outside this slice: the
# multi-host ranks (the App's Container refuses them as well)
UNPORTED_ROWS = MULTIHOST_ROWS
# what TPU_SHARDING does not serve yet, each beside it (ROADMAP 11b)
_TP_REFUSED = ("TPU_LORA_ADAPTERS", "TPU_PREFIX_CACHE", "TPU_KVCACHE_REDIS",
               "TPU_KVCACHE_HOST_MB")

# TPU_MODEL aliases, as the JAX package reads them
BERT_ALIASES = {"bert": "bert-base", "bert-tiny": "tiny"}
VIT_ALIASES = {"vit": "vit-l-14", "vit-l14": "vit-l-14", "vit-tiny": "tiny"}


def _opt_int(val: str | None) -> int | None:
    """A row whose unset value means something of its own (None); a
    malformed value reads as unset, as in the JAX reader."""
    if not val:
        return None
    try:
        return int(val)
    except (TypeError, ValueError):
        return None


def _csv_ints(val: str | None, default: tuple[int, ...]) -> tuple[int, ...]:
    if not val:
        return default
    return tuple(int(x) for x in val.split(",") if x.strip())


def _check_rows(cfg) -> None:
    from ..container import SERVING_ROLES, serving_role

    role = serving_role(cfg)
    if role == "gateway":
        # the gateway role (gofr_tpu_torch/gateway) is an App mode, not an
        # engine mode: it fronts replicas and holds no model. A config
        # naming both is two deployments in one file: refuse before
        # building anything rather than guess which one was meant
        raise ValueError(
            "TPU_SERVING_ROLE=gateway builds no engine (the gateway "
            "routes to TPU_GATEWAY_REPLICAS); unset "
            f"TPU_MODEL={cfg.get('TPU_MODEL')!r} on the gateway "
            "process, or drop the gateway role on this serving replica")
    rejected = [row for row in UNPORTED_ROWS
                if (cfg.get(row) or "").strip() != ""]
    if role not in SERVING_ROLES:
        rejected.append("TPU_SERVING_ROLE")
    if rejected:
        raise ValueError(f"config rows not honoured by gofr_tpu_torch yet: "
                         f"{', '.join(rejected)}")
    plan = parse_sharding(cfg.get("TPU_SHARDING"))
    if plan is None or plan.tp == 1:
        if (cfg.get("TPU_HBM_DEVICE_BUDGET_MB") or "").strip():
            raise ValueError(
                "TPU_HBM_DEVICE_BUDGET_MB is a tensor-parallel rank's "
                "budget and needs TPU_SHARDING=tp=N; a one-device "
                "engine's budget is TPU_HBM_BUDGET_MB")
        return None
    row = plan.row()
    beside = [r for r in _TP_REFUSED
              if (cfg.get(r) or "").strip() not in ("", "0", "false")]
    if role in ("prefill", "decode"):
        # as the JAX package refuses a mesh P/D worker: shipped KV is
        # dense single-device rows, which no shard installs yet
        beside.append(f"TPU_SERVING_ROLE={role}")
    if beside:
        raise ShardingConfigError(
            f"TPU_SHARDING={row!r} cannot run with {', '.join(beside)} "
            "yet (ROADMAP item 11b): unset those rows or TPU_SHARDING",
            sharding_row=row)
    return plan


def _known_models() -> list[str]:
    return (sorted(LLAMA_CONFIGS) + sorted(BERT_ALIASES) + sorted(BERT_CONFIGS)
            + sorted(VIT_ALIASES) + sorted(VIT_CONFIGS))


def _model_config(name: str):
    """(family, ModelConfig) for a TPU_MODEL name."""
    if name.startswith("bert"):
        mc = BERT_CONFIGS.get(BERT_ALIASES.get(name, name))
        family = "bert"
    elif name.startswith("vit"):
        mc = VIT_CONFIGS.get(VIT_ALIASES.get(name, name))
        family = "vit"
    else:
        mc = LLAMA_CONFIGS.get(name)
        family = "llama"
    if mc is None:
        raise KeyError(f"unknown TPU_MODEL {name!r} for gofr_tpu_torch; "
                       f"known: {_known_models()}")
    return family, mc


def new_engine_from_config(cfg, device="cuda", logger=None,
                           params: dict | None = None,
                           metrics=None, observe=None) -> TorchEngine:
    """Build the engine from ``TPU_*`` rows on ``device`` (the CUDA card
    unless the caller asks for the CPU; raises when there is no card).
    ``params``: weights already on ``device`` for this model, used
    instead of TPU_WEIGHTS or a random init (engines built one after
    another on the same weights). ``metrics``: what the admission gates
    and the engine count sheds, brownouts, expiries and dispatches into
    (``increment_counter``/``set_gauge``/``record_histogram``), if
    given. ``observe``: the App's observability bundle
    (observe.Observe): its registry lists each ``predict`` and stream
    while it waits, its recorder, timeline and tracer take the engines'
    events, timeline slices and stage spans (``TPU_TIMELINE=0`` leaves
    the engines holding no timeline). With ``TPU_TENANTS`` or
    ``TPU_TENANTS_INLINE`` the tenancy plane is installed on the engine
    and its generator; a registry that cannot be read raises ValueError
    naming its row before anything is built."""
    from ..container import serving_role

    plan = _check_rows(cfg)
    role = serving_role(cfg)
    plane = plane_from_config(cfg, metrics=metrics, logger=logger)
    device = resolve_device(device)
    name = (cfg.get("TPU_MODEL") or "tiny").strip()
    family, mc = _model_config(name)
    if plan is not None:
        if family != "llama":
            raise ShardingConfigError(
                f"TPU_SHARDING={plan.row()!r}: sharded {family} models "
                "are not served yet (ROADMAP item 11b)",
                sharding_row=plan.row())
        check_tp(mc, plan.tp, plan.row())
    if family == "llama" and device.type == "cuda":
        # the score program runs its attention through flash_prefill (on
        # each rank's head shard under TP): refuse a model the kernel
        # does not take now, not at a request
        shard = rank_config(mc, plan.tp if plan else 1, 0)
        try:
            kernels.check_attention_shape(
                "flash_prefill", head_dim=shard.head_dim,
                n_heads=shard.n_heads, n_kv_heads=shard.n_kv_heads,
                dtype=mc.tdtype)
        except (TypeError, ValueError) as e:
            raise ValueError(f"{name} cannot be scored on {device}: "
                             f"{e}") from None
    # the memory arbiter's budget (one per process: the subsystems of
    # every engine built after this lease from it)
    hbm.configure(budget_mb=cfg.get_int("TPU_HBM_BUDGET_MB", 0) or None,
                  headroom=cfg.get_float("TPU_HBM_HEADROOM", 0.1),
                  device=device,
                  device_budget_mb=cfg.get_int("TPU_HBM_DEVICE_BUDGET_MB",
                                               0) or None)
    quant = (cfg.get("TPU_QUANT") or "").lower() == "int8"
    if plan is not None and params is None:
        # each rank makes or reads its own shard (tpu.checkpoint)
        weights = cfg.get("TPU_WEIGHTS")
        if weights and not weights.endswith(".npz"):
            raise ValueError(f"TPU_WEIGHTS={weights!r}: gofr_tpu_torch "
                             "loads .npz checkpoints only")
        params = (WeightSource("npz", path=weights, quant=quant) if weights
                  else WeightSource("seed", seed=0, quant=quant))
    elif params is None:
        weights = cfg.get("TPU_WEIGHTS")
        if weights:
            if not weights.endswith(".npz"):
                raise ValueError(f"TPU_WEIGHTS={weights!r}: gofr_tpu_torch "
                                 "loads .npz checkpoints only")
            params = load_npz(weights, device=device)
        else:
            init = {"bert": bert.init, "vit": vit.init,
                    "llama": llama.init}[family]
            params = init(mc, 0, device=device)
        params = maybe_quantize(params, quant)
    batch_buckets = _csv_ints(cfg.get("TPU_BATCH_BUCKETS"),
                              DEFAULT_BATCH_BUCKETS)
    seq_buckets = _csv_ints(cfg.get("TPU_SEQ_BUCKETS"), DEFAULT_SEQ_BUCKETS)
    batch_share = cfg.get_float("TPU_SLO_BATCH_SHARE", 0.0)
    class_policy = None
    if batch_share > 0:
        class_policy = ClassPolicy(
            throughput_delay=cfg.get_float("TPU_SLO_BATCH_DELAY", 0.0)
            or None, throughput_share=batch_share)
    generator = None
    if family == "llama":
        generator = _generator(cfg, mc, params, seq_buckets, device, logger,
                               metrics, plan, observe)
        params = generator.params   # under TP: rank 0's shard
    engine = TorchEngine(
        generator, name, device, logger=logger, metrics=metrics,
        max_delay=cfg.get_float("TPU_MAX_BATCH_DELAY", 0.004),
        gate=gate_from_config(cfg, "predict", metrics=metrics,
                              tracer=getattr(observe, "tracer", None),
                              logger=logger),
        class_policy=class_policy, observe=observe)
    if family == "bert":
        def embed_fn(p, tokens, lengths):
            mask = (torch.arange(tokens.shape[1], device=tokens.device)[None]
                    < lengths[:, None])
            return bert.embed(p, mc, tokens, mask)

        engine.register("embed", embed_fn, params, kind="tokens",
                        batch_buckets=batch_buckets,
                        seq_buckets=tuple(b for b in seq_buckets
                                          if b <= mc.max_seq)
                        or (mc.max_seq,))
    elif family == "vit":
        def classify_fn(p, images):
            return torch.softmax(vit.forward(p, mc, images), dim=-1)

        engine.register("classify", classify_fn, params, kind="fixed",
                        batch_buckets=batch_buckets,
                        example_item=np.zeros(
                            (mc.image_size, mc.image_size, 3), np.float32))
    else:
        # next-token logits at each prompt's end. The batcher coalesces
        # unrelated requests into one batch, so grouped MoE dispatch is
        # ruled out here as at decode (request isolation).
        score_mc = llama.multi_request_serving_config(generator.cfg)
        max_seq = generator.max_seq
        seq_b = tuple(b for b in seq_buckets if b <= max_seq) or (max_seq,)
        rope = llama.get_rope_tables(score_mc, max(seq_b), device)

        if plan is None:
            def score_fn(p, tokens, lengths):
                return llama.score(p, score_mc, tokens, lengths,
                                   rope_tables=rope, flash=True)
        else:
            def score_fn(p, tokens, lengths):
                # every rank runs K1 on its shard (GenerationEngine.
                # tp_score)
                return generator.tp_score(tokens, lengths, rope,
                                          max(seq_b))

        engine.register("score", score_fn, params, kind="tokens",
                        batch_buckets=batch_buckets, seq_buckets=seq_b)
    if plane is not None:
        # the registry, quotas and fair-share weights on the engine, and
        # in the generator: its pending line fans into per-tenant lines
        # and its prefix cache learns the per-tenant budget shares
        engine.tenancy = plane
        if generator is not None:
            generator.install_tenancy(plane)
    if role in ("prefill", "decode"):
        # the P/D half, after the generator exists: a misconfigured role
        # (no decoder, a paged prefill worker, no peer) fails here
        from ..pd import wire_role

        try:
            wire_role(engine, role, cfg, logger=logger, metrics=metrics)
        except BaseException:
            engine.close()
            raise
    if cfg.get_bool("TPU_WARMUP"):
        engine.warmup()
    if logger is not None:
        logger.info({"event": "torch engine ready", "model": name,
                     "device": str(device),
                     "programs": sorted(engine._programs)})
    return engine


def _generator(cfg, mc, params, seq_buckets, device, logger,
               metrics, plan=None, observe=None) -> GenerationEngine:
    """The Llama generation engine from its rows (under TPU_SHARDING
    rank 0 of the tensor-parallel group)."""
    max_seq = cfg.get_int("TPU_MAX_SEQ", min(mc.max_seq, 2048))
    kv_choice = (cfg.get("TPU_KV_DTYPE") or "int8").lower()
    prompt_b = tuple(b for b in seq_buckets if b < max_seq) \
        or (max_seq // 2,)
    kv_opts = None
    if cfg.get_int("TPU_PREFIX_CACHE", 0) > 0 \
            and cfg.get_int("TPU_PAGED_BLOCKS", 0) == 0:
        # a paged engine keeps its zero-copy shared-prefix index: no
        # Redis connection it would discard at once
        kv_opts = options_from_config(cfg, logger=logger, metrics=metrics)
    return GenerationEngine(
        mc, params, slots=cfg.get_int("TPU_SLOTS", 48), max_seq=max_seq,
        logger=logger, prompt_buckets=prompt_b,
        prefill_chunk=_opt_int(cfg.get("TPU_PREFILL_CHUNK")),
        kv_dtype=torch.int8 if kv_choice == "int8" else None,
        decode_block=cfg.get_int("TPU_DECODE_BLOCK", 4),
        decode_pipeline=cfg.get_int("TPU_DECODE_PIPELINE", 2),
        admit_window_ms=cfg.get_float("TPU_ADMIT_WINDOW_MS", 2.0),
        paged_blocks=cfg.get_int("TPU_PAGED_BLOCKS", 0),
        paged_block_size=cfg.get_int("TPU_PAGED_BLOCK", 128),
        prefix_cache_slots=cfg.get_int("TPU_PREFIX_CACHE", 0),
        prefix_store_min=cfg.get_int("TPU_PREFIX_MIN", 0) or None,
        kvcache=kv_opts,
        spec_decode_k=cfg.get_int("TPU_SPEC_DECODE", 0),
        lora_adapters=cfg.get_int("TPU_LORA_ADAPTERS", 0),
        lora_rank=cfg.get_int("TPU_LORA_RANK", 16),
        gate=gate_from_config(cfg, "generate", metrics=metrics,
                              tracer=getattr(observe, "tracer", None),
                              logger=logger),
        slo_throughput_share=cfg.get_float("TPU_SLO_THROUGHPUT_SHARE", 0.25),
        slo_latency_slots=cfg.get_int("TPU_SLO_LATENCY_SLOTS", 1),
        metrics=metrics, observe=observe, device=device, mesh=plan)
