"""The serving datasource of the port (counterpart of gofr_tpu/tpu):
``new_engine_from_config`` reads the ``TPU_*`` rows this slice honours
and builds a Llama generation engine reachable as ``ctx.tpu``.

Rows read:
  TPU_MODEL         Llama-family name (llama3-8b, llama-1b, tiny, ...;
                    default tiny)
  TPU_WEIGHTS       a ``.npz`` written by the JAX package's ``save_npz``;
                    absent = random init on the device from seed 0
  TPU_QUANT         "int8" to quantize projection weights on load
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
  TPU_SEQ_BUCKETS   csv of prompt buckets (default 32,64,128,256,512;
                    those below TPU_MAX_SEQ are the engine's, as in JAX):
                    a prompt is padded to its bucket and prefilled by one
                    dispatch; a longer one runs the chunk lattice
  TPU_PREFILL_CHUNK  the lattice's chunk budget: unset = the largest
                    bucket with a decode block interleaved between
                    chunks, <= 0 = the same chunks back to back, else
                    snapped up to a bucket
  TPU_PAGED_BLOCKS  > 0 serves from a paged pool of that many KV blocks
                    shared by all slots (block 0 is the reserved trash
                    block, so size it as live tokens // block + 1);
                    0 or unset keeps contiguous [slots, max_seq] rows
  TPU_PAGED_BLOCK   tokens per paged block (default 128)
  TPU_SPEC_DECODE   k > 0: prompt-lookup speculative decoding with k
                    draft tokens (greedy slots; a verify window of k + 1
                    positions, through the paged window kernel on a
                    paged engine, at most 15 there on the card); 0 or
                    unset: off

Every other ``TPU_*`` row of the JAX package names a feature this port
does not serve yet; a set one raises with its name rather than being
silently ignored.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..models import llama
from ..models.common import LLAMA_CONFIGS
from .checkpoint import from_jax_params, load_npz, maybe_quantize
from .engine import Health, TorchEngine
from .generator import (DEFAULT_SEQ_BUCKETS, GenerationEngine,
                        GenerationError, GenStream)

__all__ = ["GenerationEngine", "GenerationError", "GenStream", "Health",
           "TorchEngine", "from_jax_params", "load_npz", "maybe_quantize",
           "new_engine_from_config"]

# rows of the JAX package that name features outside this slice
UNPORTED_ROWS = (
    "TPU_SLO_THROUGHPUT_FACTOR",
    "TPU_SLO_THROUGHPUT_SHARE", "TPU_SLO_LATENCY_SLOTS",
    "TPU_SLO_BATCH_SHARE", "TPU_SLO_BATCH_DELAY", "TPU_PREFIX_CACHE",
    "TPU_PREFIX_MIN", "TPU_KVCACHE_BLOCK", "TPU_KVCACHE_HOST_MB",
    "TPU_KVCACHE_REDIS", "TPU_KVCACHE_REDIS_TTL_S",
    "TPU_KVCACHE_REDIS_TIMEOUT_S", "TPU_KVCACHE_EPOCH_REFRESH_S",
    "TPU_LORA_ADAPTERS", "TPU_LORA_RANK", "TPU_HBM_BUDGET_MB",
    "TPU_HBM_HEADROOM", "TPU_HBM_DEVICE_BUDGET_MB", "TPU_MAX_QUEUE_DEPTH",
    "TPU_MAX_QUEUE_DELAY", "TPU_BROWNOUT_DELAY", "TPU_BROWNOUT_MAX_NEW",
    "TPU_BATCH_BUCKETS", "TPU_MAX_BATCH_DELAY",
    "TPU_SHARDING", "TPU_PD_LISTEN", "TPU_PD_PEER", "TPU_PD_BLOCK",
    "TPU_PD_WINDOW_MB", "TPU_WARMUP", "TPU_TENANTS", "TPU_TENANTS_INLINE",
    "TPU_TENANTS_RELOAD_S", "TPU_TENANT_HEADER", "TPU_TENANT_TOPIC",
    "TPU_TENANT_CHECKPOINT_EVERY",
)


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
    def is_set(row: str) -> bool:
        return (cfg.get(row) or "").strip() != ""

    rejected = [row for row in UNPORTED_ROWS if is_set(row)]
    if is_set("TPU_SERVING_ROLE") and \
            cfg.get("TPU_SERVING_ROLE").strip().lower() != "fused":
        rejected.append("TPU_SERVING_ROLE")
    if rejected:
        raise ValueError(f"config rows not honoured by gofr_tpu_torch yet: "
                         f"{', '.join(rejected)}")


def new_engine_from_config(cfg, device="cuda", logger=None) -> TorchEngine:
    """Build the generation engine from ``TPU_*`` rows on ``device``
    (the CUDA card unless the caller asks for the CPU; raises when
    there is no card)."""
    _check_rows(cfg)
    device = resolve_device(device)
    name = (cfg.get("TPU_MODEL") or "tiny").strip()
    mc = LLAMA_CONFIGS.get(name)
    if mc is None:
        raise KeyError(f"unknown TPU_MODEL {name!r} for gofr_tpu_torch; "
                       f"known: {sorted(LLAMA_CONFIGS)}")
    weights = cfg.get("TPU_WEIGHTS")
    if weights:
        if not weights.endswith(".npz"):
            raise ValueError(f"TPU_WEIGHTS={weights!r}: gofr_tpu_torch "
                             "loads .npz checkpoints only")
        params = load_npz(weights, device=device)
    else:
        params = llama.init(mc, 0, device=device)
    params = maybe_quantize(params,
                            (cfg.get("TPU_QUANT") or "").lower() == "int8")
    max_seq = cfg.get_int("TPU_MAX_SEQ", min(mc.max_seq, 2048))
    kv_choice = (cfg.get("TPU_KV_DTYPE") or "int8").lower()
    seq_buckets = _csv_ints(cfg.get("TPU_SEQ_BUCKETS"), DEFAULT_SEQ_BUCKETS)
    prompt_b = tuple(b for b in seq_buckets if b < max_seq) \
        or (max_seq // 2,)
    generator = GenerationEngine(
        mc, params, slots=cfg.get_int("TPU_SLOTS", 48), max_seq=max_seq,
        logger=logger, prompt_buckets=prompt_b,
        prefill_chunk=_opt_int(cfg.get("TPU_PREFILL_CHUNK")),
        kv_dtype=torch.int8 if kv_choice == "int8" else None,
        decode_block=cfg.get_int("TPU_DECODE_BLOCK", 4),
        decode_pipeline=cfg.get_int("TPU_DECODE_PIPELINE", 2),
        admit_window_ms=cfg.get_float("TPU_ADMIT_WINDOW_MS", 2.0),
        paged_blocks=cfg.get_int("TPU_PAGED_BLOCKS", 0),
        paged_block_size=cfg.get_int("TPU_PAGED_BLOCK", 128),
        spec_decode_k=cfg.get_int("TPU_SPEC_DECODE", 0), device=device)
    if logger is not None:
        logger.info({"event": "torch engine ready", "model": name,
                     "device": str(device)})
    return TorchEngine(generator, name, device)
