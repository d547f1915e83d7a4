#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gofr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from gofr_tpu_torch/ops/csrc (one nvcc per
     source, all started together) and print the build time and what
     ptxas reports per kernel; an instance of flash_prefill, flash_decode,
     paged_decode (every group size) or paged_window (every count of
     16-row tiles, 1 to 8) that spills fails the run;
  3. hold each kernel (bf16 in, bf16 out) against its plain PyTorch
     version, evaluated in float32 on the same input values, on the card
     at the serving shapes, and time kernel, plain version and the
     library yardstick (scaled_dot_product_attention, which the port
     never calls); the paged kernel reads a pool whose block ids are
     shuffled so that no slot's blocks are adjacent, and is also held at
     phase paged's own shapes (32 slots over its 257-block pool, its
     prompt lengths), as flash_prefill is at its longest prompt (1500),
     at phase paged's TPU_MAX_SEQ (4096) and on and around its tile
     edges, and at the score program's batches (8 ragged rows of 512
     with a padded row of length 0, timed, and of 32); both decodes
     also on and around their chunk edges (the split over the cache),
     at capacity and for one slot of 4096, and
     the paged one bit for bit against flash_decode on the gathered
     view; the paged verify window (K3w) at phase paged's shapes with a
     window of 5, at 8 slots x 512 with windows of 2 and 5, on and
     around the chunk edges with an empty slot, at 24 and 128 query rows
     a KV head (G = 8, W = 3 and 16), and at a window of one bit for bit
     against paged_decode;
  4. Llama-3-8B at full width and 4 layers, prefill plus 8 decode steps,
     once through the kernels and once through the plain versions on
     the same inputs: the largest logit difference against a tolerance;
     then the same contents in contiguous rows and in a shuffled pool,
     decoded through flash_decode and through paged_decode: the logits
     must be equal; then, from one prefilled shuffled pool (bf16, then
     int8), 4 greedy paged decode steps against one verify pass over the
     window [last token, the 4 true tokens]: verify logits j against
     decode step j's;
  5. the main path at full width and depth: new_engine_from_config with
     TPU_MODEL=llama3-8b (random weights from seed 0), 8 slots, 2048
     positions, int8 KV, K=4, dispatch depth 2 (the default; each decode
     block one replay of a CUDA graph captured at construction), the
     default prompt buckets (32..512; each admission one replay of its
     bucket's prefill graph), serving 6 concurrent requests; the launch
     counters, which count replays, show both kernels on the path
     (flash_prefill 32 an admission, flash_decode 32 a decode step) and
     the plain versions unused; then one more request under
     torch.profiler gives the device's busy share, by kind of kernel,
     and a bucket-512 admission beside three decoding streams its own
     device time and the window's idle share; a greedy stream killed by
     the GENERATOR_MIDKILL seam after 12 tokens is continued with
     continue_from (a full recompute) and its splice printed; then a
     replay of each
     captured decode graph against an eager call of the same block
     function on a copy of the state, and a 500-token and a 1500-token
     admission (the lattice: two mid chunks, a final chunk) through the
     admission graphs against their functions run eagerly on a copy,
     at the engine's shapes; then the same requests on a
     TPU_DECODE_PIPELINE=1 engine: the streams must be equal;
  5b. (phase ``paged``) the paged path at full width and depth: the
     same model with 32 slots, 4096 positions and a pool of 257 blocks
     of 128 int8 tokens, at depth 2, serving 24 concurrent requests (the
     prompts past 512 through the chunk lattice on the scratch row, a
     decode block between chunks); the counters show flash_prefill (32
     a bucket admission) and paged_decode (32 a decode step, through
     replays) on the path and nothing else, the admission replays are
     one a bucket admission and chunks + 2 a lattice, the pool is whole
     again afterwards; TTFT and the inter-token gap of the streams
     decoding across a lattice; profiler windows as phase 5's, the
     decode and admission replays against their eager functions at
     these shapes; the same burst with TPU_PREFILL_CHUNK=0 (interleave
     off: its gap, streams equal); and the streams equal a contiguous
     engine's on the same weights and requests;
  5c. (phase ``spec``) speculative decoding on the paged path: the same
     rows plus TPU_SPEC_DECODE=4 (the pipeline pinned to depth 1), 24
     greedy requests whose prompts X + S + X (S: the spec-less engine's
     greedy continuation of X) let the prompt-lookup drafts hit; the
     counters show a K3w launch per layer and verify pass, a K3
     launch per layer and decode step and a K1 launch per layer and
     bucket admission (prompts past 512 take the lattice), the pool is
     whole again, and the
     streams that differ from a spec-less paged engine's are printed;
     each verify pass is one replay of the verify graph captured at
     construction (replays = passes), and a replay equals verify_pass
     run eagerly on a copy of the same state, with its device time (CUDA
     events) printed beside the host-clock verify ms; then a contiguous
     spec engine serves a few requests through verify_step, through its
     own verify graph, held against its eager pass the same way;
  5d. (phase ``durable``) durable streaming on the paged path: phase
     paged's rows plus TPU_PREFIX_CACHE=8 on the same weights; a
     request with a seeded 1536-token shared prefix (12 blocks) stores
     an entry, then 15 more with the prefix and their own tails (two
     sampled) and 4 unrelated prompts arrive at once: 15 hits, the
     shared blocks' bytes unchanged, the pool back to its idle count
     less the blocks the entries hold, flash_prefill 32 a bucket
     admission and paged_decode 32 a decode step, the admission replays
     by kind (read-back, mid, final, write-back, prefill); TTFT of hits,
     the storing request and misses, and the read-back graph's device
     time; a greedy and a seeded hit killed by GENERATOR_MIDKILL after
     12 tokens while others decode, continued with continue_from (the
     continuation must hit its stored prompt; the splice is printed);
     then a DeviceLost at the step seam with a block in flight: the 32
     live streams fail, 4 queued requests are served, the engine stays
     up, the index is empty, the pool whole, the graphs kept, and a
     greedy request streams the same tokens before and after;
  5e. (phase ``slo``) deadlines, SLO classes and the admission gate on
     the paged path: phase paged's rows plus TPU_MAX_QUEUE_DEPTH=16,
     TPU_SLO_LATENCY_SLOTS=4 and TPU_SLO_THROUGHPUT_SHARE=0.25 on the
     same weights; a latency request with 400 new tokens and a 1.0 s
     budget and a latency prompt of 3000 tokens whose deadline ends after
     two mid chunks, then 48 throughput prompts of 700-1500 tokens at
     once (4 more with a 20 ms budget right behind the first), 100 ms
     later 8 latency prompts of 64-400 tokens: the gate sheds throughput
     only (429 with
     Retry-After), the expiries land in the queue (4), mid-prefill (1)
     and mid-decode (1), TTFT by class, the pool whole afterwards,
     flash_prefill 32 a bucket admission and paged_decode 32 a decode
     step; then drain(30) with 8 live greedy streams: every stream
     whole, generate refused while draining;
  5f. (phase ``app``) the framework's own main path: the port's App
     (``gofr_tpu_torch.App``), whose Container builds the engine from
     phase slo's rows on "cuda" (phase slo's weights freed first), and
     ``install_generate``; phase slo's burst sent as HTTP from client
     threads (48 throughput prompts with X-SLO-Class, 100 ms later 8
     latency ones, one of them with a traceparent), one latency request
     of 1000 tokens with X-Request-Timeout 50ms right behind the batch
     burst; the 429s (each with Retry-After) by class must equal the
     gate's sheds and app_tpu_shed_total, the budget must answer a
     buffered 504 naming the deadline with one expiry counted, the
     traced stream's trace_id must be the inbound one, every served
     stream whole, the pool whole, flash_prefill 32 a bucket admission
     and paged_decode 32 a decode step; health, /metrics and
     /debug/cache scraped; the HTTP layer's cost (alive round trips,
     send to submit, first delivery to the client's first line) and
     TTFT at the client and at the engine printed; then stop(grace_s=30)
     with 8 live streams: health and a new request answer 503 with
     Retry-After, every stream ends whole over its connection;
  5g. (phase ``predict``) the predict path at full width and depth, each
     request through the port's coalescing batcher: BERT-base ``embed``
     on a ``gofr_tpu_torch.App`` with ``install_embeddings``
     (TPU_BATCH_BUCKETS=1,2,4,8, TPU_WARMUP): 64 clients at once, one
     POST /v1/embeddings of 8-512 tokens each, then 8 requests of 4
     inputs; client latency p50/p99, items/s, the dispatches and their
     batch sizes, app_tpu_batch_fill and app_tpu_batch_wait_duration;
     every embedding of unit norm and equal to the same input sent alone,
     8 equal to bert.embed on the weights in float32 on the card; a
     request with X-Request-Timeout 1ms behind a batch held at the
     BATCHER_DISPATCH seam answers 504 and is counted, never run; an
     unknown program answers 404; a second App with
     TPU_MAX_QUEUE_DEPTH=4 sheds 24 clients' excess as 429s with
     Retry-After, as many as the gate's sheds and app_tpu_shed_total.
     ViT-L/14 ``classify`` (224 x 224, patch 14): 16 images through
     predict_batch and as 16 concurrent predicts, each row a
     distribution, the two equal, 4 against float32 on the card.
     Llama-3-8B ``score`` on phase paged's rows and seed-0 weights
     passed by ``params=``: 16 concurrent score requests of 17-512
     tokens while 8 greedy streams decode; flash_prefill 32 a score
     dispatch and a bucket admission, each row equal to its prompt
     scored alone and, at [8, 512], to the plain attention, the argmax
     equal to each stream's first token where the top-2 gap is over
     twice the tolerance, the streams token-exact against the same
     prompts served with no score traffic;
  5h. (phase ``grpc``) the headline route, Llama-3-8B tokens over the
     port's own HTTP/2 gRPC server: a ``gofr_tpu_torch.App`` whose
     Container builds phase 5's contiguous engine on "cuda" (phase
     predict's engines freed first) behind phase slo's gate rows, with
     ``llm.Generation`` (Generate, Chat) and ``POST /generate`` as
     examples/tpu-token-streaming/main.py defines them; health SERVING;
     16 Generate RPCs at once, 4 on each of 4 connections (17-500
     tokens, 48 new, two sampled), each equal to the same request sent
     to the engine directly, with TTFT at the client and at the engine,
     client send to engine submit, first_put to the first message on
     the wire (the grpc.handoff and grpc.frame-write spans), tok/s and
     the streams served on the producing thread; the HTTP route through
     GenStream.map streams the same tokens; a Chat turn, a turn
     cancelled after its first token (the slot free within 2 s) and a
     fresh call; a 1000-token Generate with grpc-timeout 50m behind 8
     busy slots ends DEADLINE_EXCEEDED and is counted where it expired;
     32 throughput RPCs at once and 4 latency ones 100 ms later: the
     RESOURCE_EXHAUSTED by class equal the gate's sheds and
     app_tpu_shed_total, each with retry-after, no latency RPC shed;
     stop(grace_s=30) with 8 live streams of 160 tokens: health
     NOT_SERVING, a new RPC UNAVAILABLE with retry-after, every stream
     whole, no server thread left; flash_prefill 32 a bucket admission
     and flash_decode 32 a decode step over the whole phase;
  5i. (phase ``tiers``) prefix reuse through the contiguous engine's
     tiers on the same route: a ``gofr_tpu_torch.App`` builds phase 5's
     engine with TPU_PREFIX_CACHE=2 (T0), TPU_KVCACHE_HOST_MB=1024 (T1)
     and TPU_KVCACHE_REDIS=true (T2, on the port's FakeRedisServer on
     localhost), TPU_PREFIX_MIN=1072; six system prompts of 1024 tokens
     with first turns of 48-200 tokens as gRPC Generate RPCs, one after
     another (6 misses: T0 full, 4 rows spilled to T1, all 6 written
     through to T2), then the same systems with follow-ups of 16-32
     tokens (2 T0 hits, 4 T1 hits), then a fresh App (a new replica)
     takes round 2's requests (6 T2 hits); every restore lands the
     stored int8 codes and scales, a request's greedy stream is the
     same from T0, T1 and T2, and an App without tiers streams round
     1's tokens (its round 2 printed beside the hits); TTFT by tier
     against misses, the pool-row copy's
     device time, the host time of spills, promotions, T2 fetches and
     uploads, the T2 bytes written; then the arbiter on the new replica:
     a budget of in-use + half a row and a one-row PRI_SCRATCH lease
     shrink T0 by one row (spilling to T1), a 10 GiB lease sheds with
     HBMExhausted (429, Retry-After) and a burst of 8 is served, and
     with the budget back the seeded HBM_ALLOC seam sheds exactly one
     request of a burst of 8 as RESOURCE_EXHAUSTED; the declared bytes
     beside the growth of torch.cuda.memory_allocated for each App;
     flash_prefill 32 a bucket admission and flash_decode 32 a decode
     step;
  5j. (phase ``lora``) multi-LoRA on examples/tpu-multi-lora's routes
     and rows: a ``gofr_tpu_torch.App`` builds Llama-3-8B with int8
     weights and KV, 48 slots, 1024 positions and 4 adapter slots of
     rank 16 (seed-0 weights); adapters 1-3 installed through ``POST
     /adapters/{idx}`` (seeded npz bodies, B scaled so their greedy
     tokens part from adapter 0's); ``GET /adapters``; 32 concurrent
     ``POST /generate`` of 17-500 tokens, 48 new, 8 an adapter (K1 32 a
     bucket admission, K2 32 a decode step, counted), then the same
     prompts all on adapter 0; adapter-0 prompts alone against an engine
     without LoRA on the same base tensors (equal); adapters 1-3's
     first-token log-probabilities against float32 with the adapter
     merged into the dequantized weights; a decode block's device time
     with and without LoRA; a hot swap (``POST /adapters/3`` with
     adapter 1's body) under 8 live streams, after which adapter 3
     streams adapter 1's tokens; then a paged engine (257 blocks of 128)
     on the same base tensors and adapters: 8 mixed prompts alone,
     token for token the contiguous engine's, K3 32 a decode step;
  5k. (phase ``pubsub``) BASELINE config #4 on one card:
     examples/kafka-vit-classify's handler on a ``gofr_tpu_torch.App``
     whose subscriber loop feeds ViT-L/14 from the MEM broker: 12 jobs
     of 1-8 images and one malformed message published at once; labels
     equal to a direct ``predict_batch``, the subscribe counters 13 and
     12, the malformed message logged and uncommitted, ``stop()``
     joining the subscriber; jobs and images a second, publish to result
     split into the JSON bind and the dispatch;
  6. a ``{"kernels": [...]}`` line (flash_prefill's launches are phase
     5's, the score run's and phases grpc's, tiers' and lora's;
     flash_decode's phase 5's and phases grpc's, tiers' and lora's;
     paged_decode's phase paged's and lora's), then the card line, then
     the ``{"ok": true, "device": {...}}`` line last.

It needs the repository beside it and a CUDA card; without either it
exits non-zero and prints no result.

    python3 chip_smoke.py --prefill-ab TREE [TREE ...]

times flash_prefill alone at S of 512, 1500 and 4096, and the host time
of one call of its wrapper, in each checkout TREE of this repository, in
the order given (name a tree twice to take
it in turns with another), each in a process of its own. A tree whose
kernel disagrees with the plain version (an experiment that leaves work
out to see what it costs) is timed all the same, and marked.

    python3 chip_smoke.py --decode-ab TREE [TREE ...]

does the same for the decodes: flash_decode (int8) at 8 slots x 512,
paged_decode (int8) at 8 slots x 512 and at phase paged's first decode
step (32 slots over its 257-block pool, its prompt lengths), and the
verify window paged_window (int8, W = 5) at 8 slots x 512 and at phase
paged's first-step lengths.

    python3 chip_smoke.py --serve-ab TREE [TREE ...]

times the serving runs of phases 5 (at the default depth and at
TPU_DECODE_PIPELINE=1), paged and spec (the same rows and requests, each
on a fresh engine warmed by one short request) in each tree, one process
a tree in the order given, and prints one ``[ab]`` JSON line a run:
tok/s, the step time, TTFT, the pipeline depth, overlapped reaps, the gap
p50 and the graph replays (a tree that predates a number prints null for
it). Name each tree at least three times, in turns.

    python3 chip_smoke.py --repeat N [HANG_S]

runs the whole script N times, each in a process of its own, and prints
one line a run: its exit code, its time and the last phase that ended.
A run still going after HANG_S seconds (default 300) is sent SIGUSR1,
which makes it print every thread's stack, and is then killed. Each
run's output goes to chiprun_out/repeat/. A hang that a single run can
miss shows here.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): the least time a kernel can
# take is the larger of bytes over the memory rate and operations over
# the peak rate of the unit that does them
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12   # flash prefill's QK^T and PV
FP32_FLOPS = 67e12           # flash decode's dot products (CUDA cores)

# kernel against plain: |got - want| <= ATOL + RTOL * |want|, where the
# plain version runs in float32 on the kernel's own input values (bf16 ->
# float32 is exact; an int8 cache and its scales stay as they are). What
# is left is the kernel's own rounding: its bf16 output (2^-9 relative at
# most) and, in flash_prefill, the bf16 probabilities it feeds the
# tensor cores (2^-9 of a probability, under 0.01 absolute for values of
# unit scale). The plain version in bf16 rounds the scaled query, the
# probabilities and, in the decodes, two partial sums to bf16: where
# those partials cancel, its own error is a step of the partials (0.0156
# at |partial| in [2, 4)) against a small result, which no tolerance
# relative to the result holds; that difference is printed beside
KERNEL_ATOL = 1e-2
KERNEL_RTOL = 2.0 ** -7
TOL = f"tolerance {KERNEL_ATOL} + 2^-7 |plain in float32|"
# random-init logits have unit scale; bf16 activations through 4 layers
# and 8 decode steps drift by a few bf16 steps between the two orders of
# summation
LOGIT_ATOL = 0.1
# A verify pass over an int8 pool attends its window's own K/V in bf16,
# where the decode steps it is held against read them back from the pool
# as int8 codes: a code is within half a step, 1/254 < 2^-7 of its row's
# largest value, of the bf16 value. Where every row of a layer's window
# moved by that much of the largest value, the layer's attention output
# would move by at most 2^-7 of |v|max; four layers, each adding at most
# that share of the logits' own scale, stay within 4 * 2^-7 of max|logit|
# beyond the bf16 tolerance.
INT8_WINDOW_REL = 4 * 2.0 ** -7

LAYERS = 32

# a run that has not ended by then dumps every thread's stack to stderr
# and exits 1, inside the 1200 s the script is given
WATCHDOG_S = 1050


class SmokeFailure(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- timing -------------------------------------------------------------------

def graph_ms(fn, arg_sets, n: int) -> float:
    """Device time of one call: ``n`` calls captured into a CUDA graph,
    cycling through ``arg_sets`` (copies that together exceed the 50 MB
    L2, so each call finds its inputs cold, as the serving loop does),
    replayed once between CUDA events. Host launch overhead is out of
    the number."""
    import torch

    from gofr_tpu_torch.tpu.generator import no_collection

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture stream
        for args in arg_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with no_collection(), torch.cuda.graph(graph):
        for i in range(n):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / n


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2: build -----------------------------------------------------------

def phase_build() -> None:
    from gofr_tpu_torch.ops import kernels

    t0 = time.monotonic()
    logs = kernels.build_all()
    took = time.monotonic() - t0
    print(f"[build] {len(logs)} sources in {took:.1f} s "
          f"(nvcc {kernels.nvcc_path()})", flush=True)
    for source, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "error",
                                       "warning", "Compiling entry")):
                print(f"[build] {source}: {line.strip()}")
    for source in ("flash_prefill.cu", "flash_decode.cu", "paged_decode.cu",
                   "paged_window.cu"):
        spills = ptxas_spills(logs[source])
        require(not logs[source] or spills,
                f"ptxas reported no kernel of {source}")
        require(not any(spills.values()),
                f"{source} instances spill (stack + spill bytes): {spills}")


def ptxas_spills(log: str) -> dict[str, int]:
    """Entry function -> bytes of stack frame, spill stores and spill
    loads together, from what ``ptxas -v`` printed ("" for a library
    that was already built)."""
    import re

    spills: dict[str, int] = {}
    entry = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and entry:
            spills[entry] = sum(int(x) for x in m.groups())
    return spills


# -- phase 3: kernels against their plain versions ----------------------------

def compare(got, want) -> tuple[float, bool]:
    """(max |got - want|, whether every element is within tolerance)."""
    import torch

    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ok = bool(torch.isfinite(g).all()) and bool(
        (diff <= KERNEL_ATOL + KERNEL_RTOL * w.abs()).all())
    return diff.max().item(), ok


def f32(*tensors):
    """The tensors with bf16 ones in float32 (exact), the rest as given:
    the plain version's inputs for the comparison."""
    import torch

    return tuple(t.float() if t is not None and t.dtype == torch.bfloat16
                 else t for t in tensors)


def _rng_bf16(gen, shape):
    import torch

    return torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16)


def prefill_case(gen, b: int, s: int, lengths: list[int], record: dict,
                 h: int = 32, kv: int = 8, d: int = 128,
                 timed: bool = True) -> None:
    import torch
    import torch.nn.functional as F

    from gofr_tpu_torch.ops import flash

    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    # enough input copies to pass 60 MB, more than the L2 (at most 8)
    copies = min(8, int(60e6 // (2 * b * s * (2 * h + 2 * kv) * d)) + 1)
    sets = [(_rng_bf16(gen, (b, s, h, d)), _rng_bf16(gen, (b, s, kv, d)),
             _rng_bf16(gen, (b, s, kv, d)), lens) for _ in range(copies)]
    q, k, v, _ = sets[0]
    got = flash.flash_prefill(q, k, v, lens)
    want = flash.causal_prefill_plain(*f32(q, k, v), lens)
    err_bf16, _ = compare(got, flash.causal_prefill_plain(q, k, v, lens))
    torch.cuda.synchronize()
    err, ok = compare(got, want)

    # the library yardstick: the same attention over H heads (K/V
    # repeated to H heads outside the timed region), causal, with keys
    # past each length masked
    lib_sets = [(x.transpose(1, 2), y.repeat_interleave(h // kv, 2)
                 .transpose(1, 2), z.repeat_interleave(h // kv, 2)
                 .transpose(1, 2)) for x, y, z, _ in sets]
    if all(n == s for n in lengths):
        def lib(qt, kt, vt):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    else:
        pos = torch.arange(s, device="cuda")
        mask = ((pos[None, :] <= pos[:, None])[None]
                & (pos[None, None, :] < lens[:, None, None]))[:, None]

        def lib(qt, kt, vt):
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask)

    live = sum(lengths)
    n_bytes = 2 * (live * (h + 2 * kv) * d + b * s * h * d) + 4 * b
    n_ops = sum(4 * h * d * n * (n + 1) // 2 for n in lengths)
    bound, by = bound_ms(n_bytes, n_ops, BF16_TENSOR_FLOPS)
    times = ""
    if timed:
        few = s >= 2048   # the plain version takes many ms a call
        ms = graph_ms(flash.flash_prefill, sets, 20 if few else 50)
        plain_ms = graph_ms(flash.causal_prefill_plain, sets,
                            3 if few else 10)
        library_ms = graph_ms(lib, lib_sets, 20 if few else 50)
        times = (f"kernel_ms={ms:.5f} ({n_ops / ms / 1e9:.1f} TFLOP/s) "
                 f"plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} ")
    print(f"[kernel] flash_prefill B={b} S={s} H={h} KV={kv} "
          f"lengths={lengths} max_err={err:.3e} ({TOL}; against the "
          f"plain version in bf16 {err_bf16:.3e}) "
          f"{times}bound_ms={bound:.5f} ({by}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    require(ok, f"flash_prefill disagrees with its plain version at "
                f"B={b} S={s} lengths={lengths}: max_err {err}")
    record["max_abs_err"] = max(record.get("max_abs_err", 0.0), err)
    if timed and (b, s) == (1, 512):  # the main path's admission shape
        record.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                      bound_ms=bound, bound_by=by)


def decode_case(gen, lengths: list[int], quant: bool, record: dict,
                smax: int = 2048, h: int = 32, kv: int = 8,
                d: int = 128, main_shape: bool = False) -> None:
    import torch
    import torch.nn.functional as F

    from gofr_tpu_torch.ops import flash_decode
    from gofr_tpu_torch.ops.quant import dequantize_kv, quantize_kv

    b = len(lengths)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    sets = []
    for _ in range(4):  # 4 x 34 MB (int8) of cache: more than the L2
        kc = _rng_bf16(gen, (b, smax, kv, d))
        vc = _rng_bf16(gen, (b, smax, kv, d))
        if quant:
            (kc, ks), (vc, vs) = quantize_kv(kc), quantize_kv(vc)
        else:
            ks = vs = None
        sets.append((_rng_bf16(gen, (b, 1, h, d)), kc, vc,
                     _rng_bf16(gen, (b, 1, kv, d)),
                     _rng_bf16(gen, (b, 1, kv, d)), lens, ks, vs))
    got = flash_decode.flash_decode_appended(*sets[0])
    want = flash_decode.decode_plain(*f32(*sets[0]))
    err_bf16, _ = compare(got, flash_decode.decode_plain(*sets[0]))
    torch.cuda.synchronize()
    err, ok = compare(got, want)

    # yardstick: SDPA of the query over the cache positions < length in
    # bf16 (an int8 cache dequantized outside the timed region; this
    # step's token is not folded in)
    valid = (torch.arange(smax, device="cuda")[None, :]
             < lens[:, None])[:, None, None, :]             # [B,1,1,Smax]
    lib_sets = []
    for q, kc, vc, _, _, _, ks, vs in sets:
        if quant:
            kc, vc = dequantize_kv(kc, ks), dequantize_kv(vc, vs)
        lib_sets.append((q.transpose(1, 2),
                         kc.repeat_interleave(h // kv, 2).transpose(1, 2),
                         vc.repeat_interleave(h // kv, 2).transpose(1, 2)))

    def lib(qt, kt, vt):
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=valid)

    ms = graph_ms(flash_decode.flash_decode_appended, sets, 200)
    plain_ms = graph_ms(flash_decode.decode_plain, sets, 10)
    library_ms = graph_ms(lib, lib_sets, 50)

    live = sum(lengths)
    elem = 1 if quant else 2
    n_bytes = (2 * live * kv * d * elem + (2 * live * kv * 4 if quant else 0)
               + 2 * (2 * b * h * d + 2 * b * kv * d) + 4 * b)
    n_ops = 4 * h * d * (live + b)
    bound, by = bound_ms(n_bytes, n_ops, FP32_FLOPS)
    cache = "int8" if quant else "bf16"
    print(f"[kernel] flash_decode {cache} B={b} Smax={smax} H={h} KV={kv} "
          f"lengths={lengths} max_err={err:.3e} ({TOL}; against the "
          f"plain version in bf16 {err_bf16:.3e}) "
          f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
          f"library_ms={library_ms:.5f} bound_ms={bound:.5f} ({by}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    require(ok, f"flash_decode ({cache}) disagrees with its plain version "
                f"at lengths={lengths}: max_err {err}")
    if quant:
        # an empty slot returns this step's v_new, repeated per group
        v_new = sets[0][4]
        for i, n in enumerate(lengths):
            if n == 0:
                exact = v_new[i, 0].repeat_interleave(h // kv, 0)
                require(torch.equal(got[i, 0], exact),
                        "flash_decode: a slot of length 0 must return v_new")
    record["max_abs_err"] = max(record.get("max_abs_err", 0.0), err)
    if main_shape:
        record.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                      bound_ms=bound, bound_by=by)


SPREAD = 97   # pool stride between consecutive live blocks


def shuffled_table(lengths: list[int], t: int, mb: int, n: int = 0):
    """A clamped block table [B, MB] (a row repeats its last live block;
    a slot of length 0 keeps an all-trash row, block 0) and the pool's
    block count. No slot's consecutive blocks are adjacent in the pool:
    by default the pool holds B*MB + 1 blocks and the ids are
    interleaved and descending; given ``n``, the live blocks, numbered
    slot after slot, take ids 1 + (k * SPREAD) mod (n - 1) in a pool of
    ``n`` blocks, as the serving pool's size gives them."""
    import torch

    b = len(lengths)
    live = [-(-x // t) for x in lengths]
    if n:
        require(sum(live) < n and math.gcd(SPREAD, n - 1) == 1,
                f"{sum(live)} live blocks do not spread over a pool of {n} "
                f"blocks")
    table = torch.zeros((b, mb), dtype=torch.int32)
    k = 0
    for i, nb in enumerate(live):
        for j in range(mb):
            if not nb:
                break
            if n:
                table[i, j] = 1 + ((k + min(j, nb - 1)) * SPREAD) % (n - 1)
            else:
                table[i, j] = 1 + (mb - 1 - min(j, nb - 1)) * b + i
        k += nb
    return table.to("cuda"), n or b * mb + 1


def paged_case(gen, lengths: list[int], quant: bool, record: dict,
               t: int = 128, mb: int = 16, n: int = 0, h: int = 32,
               kv: int = 8, d: int = 128, main_shape: bool = False,
               timed: bool = False) -> None:
    import torch
    import torch.nn.functional as F

    from gofr_tpu_torch.ops import flash_decode, paged_attention
    from gofr_tpu_torch.ops.quant import dequantize_kv, quantize_kv

    b = len(lengths)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    table, n = shuffled_table(lengths, t, mb, n)
    timed = timed or main_shape
    sets = []
    for _ in range(4 if timed else 1):  # 4 pools: more than the L2
        kp = _rng_bf16(gen, (n, t, kv, d))
        vp = _rng_bf16(gen, (n, t, kv, d))
        if quant:
            (kp, ks), (vp, vs) = quantize_kv(kp), quantize_kv(vp)
        else:
            ks = vs = None
        sets.append((_rng_bf16(gen, (b, 1, h, d)), kp, vp,
                     _rng_bf16(gen, (b, 1, kv, d)),
                     _rng_bf16(gen, (b, 1, kv, d)), table, lens, ks, vs))
    got = paged_attention.paged_decode_attention(*sets[0])
    want = paged_attention.paged_attention_reference(*f32(*sets[0]))
    err_bf16, _ = compare(
        got, paged_attention.paged_attention_reference(*sets[0]))
    # the same K/V as a contiguous cache through flash_decode: the two
    # kernels visit positions in one order, so the bits agree
    q, kp, vp, kn, vn, _, _, ks, vs = sets[0]

    def dense(x):
        return None if x is None else \
            paged_attention.gather_blocks(x, table).contiguous()

    contiguous = flash_decode.flash_decode_appended(
        q, dense(kp), dense(vp), kn, vn, lens, dense(ks), dense(vs))
    torch.cuda.synchronize()
    err, ok = compare(got, want)
    same = torch.equal(got, contiguous)

    # yardstick: SDPA of the query over the gathered (and dequantized)
    # dense view, positions < length, gathered outside the timed region;
    # no library call reads a block table, and this step's token is not
    # folded in
    smax = mb * t
    valid = (torch.arange(smax, device="cuda")[None, :]
             < lens[:, None])[:, None, None, :]
    lib_sets = []
    for q, kp, vp, _, _, _, _, ks, vs in sets:
        kc, vc = dense(kp), dense(vp)
        if quant:
            kc, vc = dequantize_kv(kc, dense(ks)), dequantize_kv(vc, dense(vs))
        lib_sets.append((q.transpose(1, 2),
                         kc.repeat_interleave(h // kv, 2).transpose(1, 2),
                         vc.repeat_interleave(h // kv, 2).transpose(1, 2)))

    def lib(qt, kt, vt):
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=valid)

    if timed:
        ms = graph_ms(paged_attention.paged_decode_attention, sets, 200)
        plain_ms = graph_ms(paged_attention.paged_attention_reference, sets,
                            10)
        library_ms = graph_ms(lib, lib_sets, 50)
    live = sum(lengths)
    elem = 1 if quant else 2
    n_bytes = (2 * live * kv * d * elem + (2 * live * kv * 4 if quant else 0)
               + 2 * (2 * b * h * d + 2 * b * kv * d) + 4 * b
               + 4 * sum(-(-x // t) for x in lengths))   # live table words
    n_ops = 4 * h * d * (live + b)
    bound, by = bound_ms(n_bytes, n_ops, FP32_FLOPS)
    pool = "int8" if quant else "bf16"
    times = (f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
             f"library_ms={library_ms:.5f} " if timed else "")
    print(f"[kernel] paged_decode {pool} B={b} T={t} MB={mb} N={n} H={h} "
          f"KV={kv} lengths={lengths} max_err={err:.3e} ({TOL}; against "
          f"the plain version in bf16 {err_bf16:.3e}) "
          f"bit-equal to flash_decode on the gathered view: {same} "
          f"{times}bound_ms={bound:.5f} ({by}) {'ok' if ok else 'FAIL'}",
          flush=True)
    require(ok, f"paged_decode ({pool}, T={t}) disagrees with its plain "
                f"version at lengths={lengths}: max_err {err}")
    require(same, f"paged_decode ({pool}, T={t}) and flash_decode on the "
                  f"gathered view differ at lengths={lengths}")
    for i, x in enumerate(lengths):
        if x == 0:  # an all-trash row returns this step's v_new
            exact = sets[0][4][i, 0].repeat_interleave(h // kv, 0)
            require(torch.equal(got[i, 0], exact),
                    "paged_decode: a slot of length 0 must return v_new")
    record["max_abs_err"] = max(record.get("max_abs_err", 0.0), err)
    if main_shape:
        record.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                      bound_ms=bound, bound_by=by)


def window_case(gen, lengths: list[int], w: int, quant: bool, record: dict,
                t: int = 128, mb: int = 16, n: int = 0, h: int = 32,
                kv: int = 8, d: int = 128, main_shape: bool = False,
                timed: bool = False) -> None:
    """K3w, the paged verify window, against its plain version evaluated
    in float32 on the same inputs; at a window of one also bit for bit
    against paged_decode."""
    import torch
    import torch.nn.functional as F

    from gofr_tpu_torch.ops import paged_attention
    from gofr_tpu_torch.ops.quant import dequantize_kv, quantize_kv

    b = len(lengths)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    table, n = shuffled_table(lengths, t, mb, n)
    timed = timed or main_shape
    sets = []
    for _ in range(4 if timed else 1):  # 4 pools: more than the L2
        kp = _rng_bf16(gen, (n, t, kv, d))
        vp = _rng_bf16(gen, (n, t, kv, d))
        if quant:
            (kp, ks), (vp, vs) = quantize_kv(kp), quantize_kv(vp)
        else:
            ks = vs = None
        sets.append((_rng_bf16(gen, (b, w, h, d)), kp, vp,
                     _rng_bf16(gen, (b, w, kv, d)),
                     _rng_bf16(gen, (b, w, kv, d)), table, lens, ks, vs))
    got = paged_attention.paged_window_attention(*sets[0])
    want = paged_attention.paged_window_reference(*f32(*sets[0]))
    err_bf16, _ = compare(
        got, paged_attention.paged_window_reference(*sets[0]))
    same = (torch.equal(got, paged_attention.paged_decode_attention(
        *sets[0])) if w == 1 else None)
    torch.cuda.synchronize()
    err, ok = compare(got, want)

    # yardstick: SDPA over the gathered (and dequantized) bf16 view with
    # the window's k/v appended, under a boolean mask: positions <
    # length, then window positions t <= w; gathered outside the timed
    # region (no library call reads a block table)
    smax = mb * t
    pos = torch.arange(smax + w, device="cuda")
    row = torch.arange(w, device="cuda")
    mask = torch.where(pos[None, None, :] < smax,
                       pos[None, None, :] < lens[:, None, None],
                       pos[None, None, :] - smax <= row[None, :, None])
    mask = mask[:, None]                                     # [B,1,W,S+W]

    def dense(x):
        return None if x is None else \
            paged_attention.gather_blocks(x, table).contiguous()

    lib_sets = []
    for q, kp, vp, kn, vn, _, _, ks, vs in sets:
        kc, vc = dense(kp), dense(vp)
        if quant:
            kc, vc = dequantize_kv(kc, dense(ks)), dequantize_kv(vc, dense(vs))
        kc, vc = torch.cat([kc, kn], 1), torch.cat([vc, vn], 1)
        lib_sets.append((q.transpose(1, 2),
                         kc.repeat_interleave(h // kv, 2).transpose(1, 2),
                         vc.repeat_interleave(h // kv, 2).transpose(1, 2)))

    def lib(qt, kt, vt):
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    if timed:
        ms = graph_ms(paged_attention.paged_window_attention, sets, 100)
        plain_ms = graph_ms(paged_attention.paged_window_reference, sets, 5)
        library_ms = graph_ms(lib, lib_sets, 50)
    live = sum(lengths)
    elem = 1 if quant else 2
    n_bytes = (2 * live * kv * d * elem + (2 * live * kv * 4 if quant else 0)
               + 2 * (2 * b * w * h * d + 2 * b * w * kv * d) + 4 * b
               + 4 * sum(-(-x // t) for x in lengths))   # live table words
    # two products of 2 FLOP a multiply-add: each query row against the
    # live positions, and against the window positions up to it
    n_ops = 4 * h * d * (w * live + b * w * (w + 1) // 2)
    bound, by = bound_ms(n_bytes, n_ops, BF16_TENSOR_FLOPS)
    pool = "int8" if quant else "bf16"
    times = (f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
             f"library_ms={library_ms:.5f} " if timed else "")
    bits = ("" if same is None else
            f"bit-equal to paged_decode at W=1: {same} ")
    print(f"[kernel] paged_window {pool} B={b} W={w} T={t} MB={mb} N={n} "
          f"H={h} KV={kv} lengths={lengths} max_err={err:.3e} ({TOL}; "
          f"against the plain version in bf16 {err_bf16:.3e}) {bits}"
          f"{times}bound_ms={bound:.5f} ({by}; bytes {n_bytes / 1e6:.2f} MB, "
          f"{n_ops / 1e9:.3f} GFLOP) {'ok' if ok else 'FAIL'}", flush=True)
    require(ok, f"paged_window ({pool}, T={t}, W={w}) disagrees with its "
                f"plain version at lengths={lengths}: max_err {err}")
    require(same is not False, f"paged_window at W=1 and paged_decode "
                               f"({pool}, T={t}) differ at lengths={lengths}")
    record["max_abs_err"] = max(record.get("max_abs_err", 0.0), err)
    if main_shape:
        record.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                      bound_ms=bound, bound_by=by)


def phase_kernels(records: dict) -> None:
    import numpy as np
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    pre = records["flash_prefill"]
    for s in (32, 128, 512):
        for b in (1, 2):
            lengths = [s] if b == 1 else [s, max(1, s // 2 - 5)]
            prefill_case(gen, b, s, lengths, pre)
    prefill_case(gen, 2, 200, [200, 0], pre)    # ragged tile, empty row
    prefill_case(gen, 1, 1500, [1500], pre)     # phase paged's longest
    prefill_case(gen, 1, 4096, [4096], pre)     # its TPU_MAX_SEQ
    for s in (1, 17, 64, 65, 127, 129):         # around the tile edges
        prefill_case(gen, 1, s, [s], pre, timed=False)
    # lengths that end on a tile edge and one past it
    prefill_case(gen, 2, 384, [256, 257], pre, timed=False)
    # the score program's batches (phase predict): 8 ragged rows of a
    # bucket of 512 with a padded row of length 0, and a bucket of 32
    prefill_case(gen, 8, 512, [512, 500, 384, 257, 129, 64, 17, 0], pre)
    prefill_case(gen, 8, 32, [32, 31, 17, 16, 9, 2, 1, 0], pre, timed=False)
    from gofr_tpu_torch.ops.flash_decode import SPLIT_CHUNK as C

    # the decodes split a slot into chunks of C positions: lengths on and
    # around the chunk edges, a slot at capacity, and one slot of 4096
    # (phase paged's TPU_MAX_SEQ), where the split matters most
    chunk_edges = [0, C - 1, C, C + 1, 2 * C, 2048]
    dec = records["flash_decode"]
    edges = [0, 1, 63, 64, 65, 512, 1000, 2047]
    for quant in (True, False):
        decode_case(gen, edges, quant, dec)
        decode_case(gen, chunk_edges, quant, dec)
        decode_case(gen, [512] * 8, quant, dec, main_shape=quant)
    decode_case(gen, [4096], True, dec, smax=4096)
    pag = records["paged_decode"]
    edges = [0, 1, 127, 128, 129, 512, 1000, 2047]
    for quant in (True, False):
        paged_case(gen, edges, quant, pag)
        paged_case(gen, chunk_edges, quant, pag)
        paged_case(gen, [512] * 8, quant, pag, main_shape=quant)
    paged_case(gen, edges, True, pag, t=16, mb=128)  # the CPU tests' T
    paged_case(gen, chunk_edges, True, pag, t=16, mb=128)
    paged_case(gen, [4096], True, pag, mb=32, timed=True)
    # phase paged's shapes: 32 slots of MB=32 over its pool of 257
    # blocks, its prompt lengths at the first and the last of its 40
    # decode steps, 8 slots empty
    for step in (0, PAGED_NEW_TOKENS - 1):
        prompts = paged_prompt_lengths(np.random.default_rng(PAGED_SEED))
        lengths = [x + step for x in prompts] + [0] * 8
        paged_case(gen, lengths, True, pag, mb=32, n=257, timed=step == 0)
    # K3w, the verify window (W = TPU_SPEC_DECODE + 1): phase paged's
    # shapes at W=5, 8 slots x 512 at W = 2 and 5, the chunk edges with
    # an empty slot, 24 and 128 rows a KV head (G = 8: a padded tile, all
    # eight tiles), and W=1 bit for bit against paged_decode
    win = records["paged_window"]
    prompts = paged_prompt_lengths(np.random.default_rng(PAGED_SEED))
    window_case(gen, prompts + [0] * 8, 5, True, win, mb=32, n=257,
                main_shape=True)
    for quant in (True, False):
        for w in (2, 5):
            window_case(gen, [512] * 8, w, quant, win, timed=w == 5)
        window_case(gen, chunk_edges, 5, quant, win)
        window_case(gen, edges, 1, quant, win)
        window_case(gen, chunk_edges, 1, quant, win)
    window_case(gen, edges, 3, True, win, t=16, mb=128)  # the CPU tests' T
    for w in (3, 16):
        window_case(gen, chunk_edges, w, True, win, h=64)


# -- phase 4: kernels against plain versions through the model ----------------

def phase_model_4_layers() -> None:
    import numpy as np
    import torch

    from gofr_tpu_torch.models import LLAMA_CONFIGS, llama

    cfg = LLAMA_CONFIGS["llama3-8b"].with_(n_layers=4)
    params = llama.init(cfg, 0, device="cuda")
    rng = np.random.default_rng(7)
    b, s, smax = 2, 256, 2048
    lengths = torch.tensor([256, 131], dtype=torch.int32, device="cuda")
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).to("cuda")
    steps = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, b))).to("cuda")
    rope = llama.get_rope_tables(cfg, smax, "cuda")

    def run(use_kernels: bool):
        cache = llama.init_cache(cfg, b, smax, dtype=torch.int8,
                                 device="cuda")
        out = []
        with torch.no_grad():
            logits, k, v, _ = llama.prefill_kv(params, cfg, tokens, lengths,
                                               rope_tables=rope,
                                               flash=use_kernels)
            llama.write_kv(cache, k, v, lengths=lengths.clone())
            valid = (torch.arange(s, device="cuda")[None, :]
                     < lengths[:, None])
            out.append(logits[valid])
            for step in steps:
                logits, cache = llama.decode_step(params, cfg, step, cache,
                                                  rope, flash=use_kernels)
                out.append(logits)
        return torch.cat(out)

    plain = run(False)
    kern = run(True)
    torch.cuda.synchronize()
    diff = (kern - plain).abs().max().item()
    scale = plain.abs().max().item()
    agree = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
    ok = diff <= LOGIT_ATOL and bool(torch.isfinite(kern).all())
    print(f"[model] llama3-8b width, 4 layers, B={b} prefill {s} + 8 "
          f"decode steps, int8 KV: max |logit diff| kernels vs plain = "
          f"{diff:.4e} (atol {LOGIT_ATOL}; max |logit| {scale:.3f}; "
          f"argmax agreement {agree:.4f}) {'ok' if ok else 'FAIL'}",
          flush=True)
    require(ok, f"4-layer logits through the kernels differ from the plain "
                f"path by {diff}")
    paged_arm(cfg, params, tokens, lengths, steps, rope, smax)
    for quant in (False, True):
        verify_arm(cfg, params, tokens, lengths, rope, smax, quant)
    del params


def paged_arm(cfg, params, tokens, lengths, steps, rope, smax: int,
              t: int = 128) -> None:
    """The same prefill written once into contiguous rows and once into
    a shuffled pool, then 8 decode steps through llama.decode_step
    (flash_decode) and paged_llama.paged_decode_step (paged_decode).
    The two kernels visit positions in one order, so the logits must
    be equal, bit for bit."""
    import torch

    from gofr_tpu_torch.models import llama, paged_llama

    b = tokens.shape[0]
    mb = smax // t
    lens = lengths.tolist()
    table, n = shuffled_table([x + len(steps) for x in lens], t, mb)
    with torch.no_grad():
        _, k, v, _ = llama.prefill_kv(params, cfg, tokens, lengths,
                                      rope_tables=rope, flash=True)
        rows = llama.init_cache(cfg, b, smax, dtype=torch.int8,
                                device="cuda")
        llama.write_kv(rows, k, v, lengths=lengths.clone())
        pool = paged_llama.init_paged_cache(cfg, b, n, t, dtype=torch.int8,
                                            device="cuda")
        host_table = table.cpu()
        for i, x in enumerate(lens):
            blocks = host_table[i, :-(-x // t)].tolist()
            paged_llama.write_prompt_blocks(pool, k[:, i:i + 1, :x],
                                            v[:, i:i + 1, :x], blocks)
        pool.lengths = lengths.clone()
        diff = 0.0
        for step in steps:
            want, rows = llama.decode_step(params, cfg, step, rows, rope,
                                           flash=True)
            got, pool = paged_llama.paged_decode_step(params, cfg, step, pool,
                                                      table, rope)
            diff = max(diff, (got - want).abs().max().item())
    torch.cuda.synchronize()
    ok = diff == 0.0 and torch.equal(pool.lengths, rows.lengths)
    print(f"[model] paged arm: {len(steps)} decode steps over a shuffled "
          f"pool of {n} blocks of {t} (paged_decode) against contiguous "
          f"rows (flash_decode): max |logit diff| = {diff:.4e} (must be 0) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    require(ok, f"paged and contiguous decode logits differ by {diff}")


def verify_arm(cfg, params, tokens, lengths, rope, smax: int, quant: bool,
               t: int = 128, k: int = 4) -> None:
    """From one prefilled shuffled pool: k greedy paged decode steps
    (paged_decode), and one verify pass (paged_window) over the window
    [last token, the k true tokens]; verify logits j must match decode
    step j's. The window keys are the values the decode steps cached:
    in a bf16 pool the same bf16 values (only the order of summation
    differs), in an int8 pool their int8 codes (INT8_WINDOW_REL)."""
    import torch

    from gofr_tpu_torch.models import llama, paged_llama
    from gofr_tpu_torch.ops import paged_attention
    from gofr_tpu_torch.tpu.generator import verify_epilogue

    b = tokens.shape[0]
    mb = smax // t
    lens = lengths.tolist()
    table, n = shuffled_table([x + k + 1 for x in lens], t, mb)
    host_table = table.cpu()
    dt = torch.int8 if quant else None
    with torch.no_grad():
        logits, kk, vv, _ = llama.prefill_kv(
            params, cfg, tokens, lengths, rope_tables=rope, flash=True,
            logit_pos=lengths.long() - 1)
        pool = paged_llama.init_paged_cache(cfg, b, n, t, dtype=dt,
                                            device="cuda")
        for i, x in enumerate(lens):
            paged_llama.write_prompt_blocks(
                pool, kk[:, i:i + 1, :x], vv[:, i:i + 1, :x],
                host_table[i, :-(-x // t)].tolist())
        pool.lengths = lengths.clone()
        fresh = paged_llama.PagedKVCache(
            pool.k.clone(), pool.v.clone(), lengths.clone(),
            None if dt is None else pool.k_scale.clone(),
            None if dt is None else pool.v_scale.clone())
        tok = logits[:, 0].argmax(-1)
        window, want = [tok], []
        for _ in range(k):
            step, pool = paged_llama.paged_decode_step(params, cfg, window[-1],
                                                       pool, table, rope)
            want.append(step)
            window.append(step.argmax(-1))
        window = torch.stack(window, 1)                           # [B, k+1]
        paged_attention.reset_counts()
        got, fresh = paged_llama.paged_verify_step(params, cfg, window, fresh,
                                                   table, rope)
        launches = paged_attention.window_launches
        want = torch.stack(want, 1)
        _, _, accepted, _ = verify_epilogue(
            got, window, torch.ones(b, dtype=torch.bool, device="cuda"))
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    atol = LOGIT_ATOL + (INT8_WINDOW_REL * scale if quant else 0.0)
    diff = (got[:, :k] - want).abs().max().item()
    ok = (diff <= atol and bool(torch.isfinite(got).all())
          and launches == cfg.n_layers
          and torch.equal(fresh.lengths, lengths))
    print(f"[model] verify arm ({'int8' if quant else 'bf16'} pool of {n} "
          f"blocks of {t}): {k} greedy decode steps (paged_decode) against "
          f"one verify pass over a window of {k + 1} (paged_window, "
          f"{launches} launches): max |logit diff| = {diff:.4e} (atol "
          f"{atol:.4f}; max |logit| {scale:.3f}); accepted drafts "
          f"{accepted.tolist()} of {k} {'ok' if ok else 'FAIL'}", flush=True)
    require(ok, f"verify logits differ from the decode steps' by {diff} "
                f"(atol {atol}), or {launches} window launches for "
                f"{cfg.n_layers} layers")


# -- phase 5: the main path ---------------------------------------------------

def timed_blocks(gen) -> list:
    """Wrap the engine's block dispatch with CUDA events around the
    replay and its output copy: each block's device time, read without
    the profiler. Returns the list the (start, end) pairs go into."""
    import torch

    run = gen._run_block
    spans: list = []

    def timed(draw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run(draw)
        end.record()
        spans.append((start, end))
        return out

    gen._run_block = timed
    return spans


def kernel_kind(name: str) -> str:
    """The profile's three kinds of device work: the port's attention
    kernels, matrix products (cuBLAS/CUTLASS), and the rest, the
    elementwise glue (norms, rope, casts, gathers, sampling)."""
    low = name.lower()
    if any(f"{k}_kernel" in low for k in ("flash_prefill", "decode_split",
                                           "decode_combine", "window_split",
                                           "window_combine")):
        return "attention"
    if any(w in low for w in ("gemm", "gemv", "xmma", "cutlass", "sm90_",
                              "cublas", "splitk", "nvjet")):
        return "matmul"
    return "glue"


@contextlib.contextmanager
def quiet_device(gen):
    """Hold the engine's device lock across a profiler start or stop.
    CUPTI's switch deadlocks against a CUDA graph launched on another
    thread: on the H100 a run hung in the profiler's ``__exit__`` while
    the serving thread sat in a decode graph's ``replay``. Under the lock
    the serving loop dispatches and reaps nothing; the synchronize and
    the short wait after it let a readiness probe in flight (an event
    query, outside the lock) return before the switch. Yields the clock
    at the synchronize: the device is idle from then until the lock is
    let go, so a window that ends there holds all its device work."""
    import torch

    with gen._device_lock:
        torch.cuda.synchronize()
        t = time.monotonic()
        time.sleep(0.02)
        yield t


def profile_decode(engine, prompt, card: str, tag: str = "profile") -> dict:
    """One more request through the running engine (its first token from
    the prefill, then 4 blocks of K=4 decode steps) under torch.profiler:
    the device's busy share of the wall time, by kind of kernel, and the
    kernels that hold it; beside it the blocks' device time from CUDA
    events. Outside the counted run."""
    from torch.profiler import ProfilerActivity, profile

    gen = engine.generator
    run = gen._run_block
    spans = timed_blocks(gen)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with quiet_device(gen):
        prof.start()
        t0 = time.monotonic()
    try:
        toks = engine.generate(prompt, max_new_tokens=17).tokens()
    finally:
        with quiet_device(gen) as t_end:
            prof.stop()
        gen._run_block = run
    wall_ms = 1e3 * (t_end - t0)
    require(len(toks) == 17, f"profiled request gave {len(toks)} tokens")
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in rows)
    block_ms = sum(a.elapsed_time(b) for a, b in spans)
    steps = gen.decode_block * len(spans)
    kinds: dict = {}
    for name, ms, count in rows:
        k = kinds.setdefault(kernel_kind(name), [0.0, 0])
        k[0] += ms
        k[1] += count
    print(f"[{tag}] 1 prefill ({len(prompt)} tokens) + {steps} decode steps "
          f"({len(spans)} blocks): wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% busy, "
          f"{100 - 100 * busy_ms / wall_ms:.1f}% idle); the blocks' device "
          f"time by CUDA events {block_ms:.2f} ms = "
          f"{block_ms / max(1, steps):.3f} ms a step; card: {card}",
          flush=True)
    for kind, (ms, count) in sorted(kinds.items(), key=lambda r: -r[1][0]):
        print(f"[{tag}]   {kind:9s} {ms:9.3f} ms  {count:6d} launches "
              f"({ms / max(1, steps):.3f} ms and {count / max(1, steps):.0f} "
              f"launches a decode step)")
    for name, ms, count in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"[{tag}]   {ms:9.3f} ms  {count:6d} x  {name[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "block_ms": block_ms}


MAIN_ROWS = {"TPU_MODEL": "llama3-8b", "TPU_SLOTS": "8",
             "TPU_MAX_SEQ": "2048", "TPU_KV_DTYPE": "int8",
             "TPU_DECODE_BLOCK": "4"}
MAIN_SEED = 11
MAIN_LENS = [17, 500, 123, 256, 64]
MAIN_NEW_TOKENS = 32
MAIN_SAMPLED = {3: 5}   # request index -> seed (temperature 0.8, top-k 50)
# a replay against the eager block: the same kernels on the same inputs,
# so tokens, emitted mask, cursors, cache bytes and carry are equal; the
# logprobs may part by float32 rounding if a library kernel took another
# algorithm under capture
LOGPROB_ATOL = 1e-3


def serve_line(stats: dict, streams, outs, wall: float) -> str:
    """tok/s, TTFT, the step time and the pipeline's numbers of a
    serving run."""
    import numpy as np

    ttft = [s.trace["first_put"] - s.trace["submit"] for s in streams]
    total = sum(len(t) for t in outs)
    pipe = stats["scheduler"]["pipeline"]
    step = stats["decode_step_ms_mean"]
    return (f"{total} tokens in {wall:.3f} s = {total / wall:.1f} tok/s; "
            f"TTFT mean {1e3 * np.mean(ttft):.1f} ms p50 "
            f"{1e3 * np.median(ttft):.1f} ms max "
            f"{1e3 * max(ttft):.1f} ms; decode step "
            f"{'n/a' if step is None else f'{step:.2f}'} ms (host clock, "
            f"K={stats['decode_block']}); depth {pipe['depth']} (target "
            f"{pipe['target_depth']}), {pipe['reaps']} reaps, "
            f"{pipe['overlapped_reaps']} overlapped, gap p50 "
            f"{pipe['gap_p50_ms']} ms over {pipe['gap_samples']} samples; "
            f"{stats['graph_replays']} graph replays, "
            f"{stats['pack_uploads']} pack uploads, "
            f"{stats['admission_replays']} admission replays")


def replay_vs_eager(gen, lengths: list, seed: int, tag: str) -> None:
    """At the engine's own shapes: a random int8 cache, cursors at
    ``lengths``, every slot live under host_wins (sampling in the draw
    graph; paged: a shuffled table over the pool), written into the
    engine's tensors; replay the captured graph, then run
    fused_decode_block eagerly on a copy of the state it started from.
    Tokens, emitted mask, cursors, cache bytes and carry must be equal,
    logprobs within LOGPROB_ATOL. On a closed engine (its graphs live
    on); launches made here are not counted."""
    import dataclasses

    import numpy as np
    import torch

    from gofr_tpu_torch.tpu.generator import (EOS_MAX, PACK_EXTRA,
                                              fused_decode_block)

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    rng = np.random.default_rng(seed)
    c = gen.cache
    b = gen.n_slots
    for draw in (False, True):
        for t in (c.k, c.v):
            t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                                  device="cuda", dtype=torch.int8))
        for t in (c.k_scale, c.v_scale):
            t.copy_(torch.rand(t.shape, generator=g, device="cuda") * 0.02)
        c.lengths.copy_(torch.tensor(lengths, dtype=torch.int32))
        p = gen._warm_pack()
        p[:, 0] = rng.integers(0, gen.cfg.vocab_size, b)
        p[:, 1] = 1
        p[:, 2] = 1000
        if draw:
            temps = rng.choice([0.0, 0.8, 1.2], b).astype(np.float32)
            p[:, 3] = temps.view(np.int32)
            p[:, 4] = rng.choice([0, 50], b)
        p[:, 7] = rng.integers(0, 2**31 - 1, b)
        p[:, 8] = rng.integers(0, 100, b)
        if gen._paged:
            table, _ = shuffled_table([x + 16 for x in lengths], gen._block_t,
                                      gen._mb, n=c.n_blocks)
            p[:, PACK_EXTRA + EOS_MAX:] = table.cpu().numpy()
        gen._pack.copy_(torch.from_numpy(p))
        cache = dataclasses.replace(
            c, k=c.k.clone(), v=c.v.clone(), lengths=c.lengths.clone(),
            k_scale=c.k_scale.clone(), v_scale=c.v_scale.clone())
        pack = gen._pack.clone()
        carry = tuple(t.clone() for t in gen._carry)
        graph, out, _ = gen._graphs[draw]
        graph.replay()
        got = out.clone()
        with torch.no_grad():
            want = fused_decode_block(
                gen.params, gen.cfg, cache, pack, carry, gen.rope_tables,
                steps=gen.decode_block, capacity=gen.max_seq - 2, draw=draw)
        torch.cuda.synchronize()
        lp = (got[:, 1] - want[:, 1]).abs().max().item()
        same = {"tokens": torch.equal(got[:, 0], want[:, 0]),
                "emitted": torch.equal(got[:, 2], want[:, 2]),
                "all emitted": bool(got[:, 2].all()),
                "lengths": torch.equal(c.lengths, cache.lengths),
                "cache bytes": all(torch.equal(x, y) for x, y in (
                    (c.k, cache.k), (c.v, cache.v), (c.k_scale, cache.k_scale),
                    (c.v_scale, cache.v_scale))),
                "carry": all(torch.equal(x, y)
                             for x, y in zip(gen._carry, carry))}
        ok = all(same.values()) and lp <= LOGPROB_ATOL
        print(f"[{tag}] graph replay vs eager fused_decode_block "
              f"(draw={draw}, {b} slots, lengths {lengths}): {same}, max "
              f"|logprob diff| {lp:.3e} (atol {LOGPROB_ATOL}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        require(ok, f"{tag}: a graph replay differs from the eager block "
                    f"(draw={draw}): {same}, logprob diff {lp}")


def verify_vs_eager(gen, lengths: list, seed: int, tag: str) -> float:
    """At the engine's own shapes: a random int8 cache, cursors at
    ``lengths``, every slot active over a random window (paged: a
    shuffled table over the pool), written into the engine's verify
    inputs; replay the captured verify graph, then run verify_pass
    eagerly on a copy of the state it started from. Tokens, emit,
    cursors and cache bytes must be equal, logprobs within LOGPROB_ATOL.
    Then the pass's device time: 20 replays with no slot active (the same
    work, the cursors stay) between CUDA events. Returns that time (ms).
    On a closed engine (its graphs live on); launches made here are not
    counted."""
    import dataclasses

    import torch

    from gofr_tpu_torch.tpu.generator import verify_pass

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    c = gen.cache
    b, w = gen.n_slots, gen._spec_k + 1
    for t in (c.k, c.v):
        t.copy_(torch.randint(-127, 128, t.shape, generator=g, device="cuda",
                              dtype=torch.int8))
    for t in (c.k_scale, c.v_scale):
        t.copy_(torch.rand(t.shape, generator=g, device="cuda") * 0.02)
    c.lengths.copy_(torch.tensor(lengths, dtype=torch.int32))
    buf = gen._verify_in
    buf[:, :w] = torch.randint(0, gen.cfg.vocab_size, (b, w), generator=g,
                               device="cuda")
    buf[:, w] = 1
    if gen._paged:
        table, _ = shuffled_table([x + w for x in lengths], gen._block_t,
                                  gen._mb, n=c.n_blocks)
        buf[:, w + 1:-1] = table.long()
    inputs = buf.clone()
    cache = dataclasses.replace(
        c, k=c.k.clone(), v=c.v.clone(), lengths=c.lengths.clone(),
        k_scale=c.k_scale.clone(), v_scale=c.v_scale.clone())
    graph, out, _ = gen._verify_graph
    graph.replay()
    got = out.clone()
    with torch.no_grad():
        want = verify_pass(
            gen.params, gen.cfg, cache, inputs[:, :w], inputs[:, w].bool(),
            inputs[:, w + 1:-1].to(torch.int32) if gen._paged else None,
            gen.rope_tables)
    torch.cuda.synchronize()
    lp = (got[:, w:2 * w] - want[:, w:2 * w]).abs().max().item()
    same = {"tokens": torch.equal(got[:, :w], want[:, :w]),
            "emit": torch.equal(got[:, 2 * w], want[:, 2 * w]),
            "all emit": bool((got[:, 2 * w] >= 1).all()),
            "lengths": torch.equal(c.lengths, cache.lengths),
            "cache bytes": all(torch.equal(x, y) for x, y in (
                (c.k, cache.k), (c.v, cache.v), (c.k_scale, cache.k_scale),
                (c.v_scale, cache.v_scale)))}
    ok = all(same.values()) and lp <= LOGPROB_ATOL
    print(f"[{tag}] verify graph replay vs eager verify_pass ({b} slots, "
          f"W={w}, lengths {lengths}): {same}, max |logprob diff| {lp:.3e} "
          f"(atol {LOGPROB_ATOL}) {'ok' if ok else 'FAIL'}", flush=True)
    require(ok, f"{tag}: a verify replay differs from the eager pass: "
                f"{same}, logprob diff {lp}")
    buf[:, w] = 0
    graph.replay()
    torch.cuda.synchronize()
    n = 20
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def admission_vs_eager(gen, seed: int, tag: str) -> None:
    """At the engine's own shapes, from a random int8 cache (and, paged,
    scratch row) with random cursors: one admission of 500 tokens
    (bucket 512, one prefill replay; paged: into shuffled blocks) and
    one of 1500 (the lattice: mid chunks at 0 and 512, a final chunk of
    512 at 988; paged: then the write-back), greedy and sampled, through
    the engine's graph replays; then the same admissions with each
    dispatch's function run eagerly on a copy of the state they started
    from. First token, cursors and cache bytes (a pool's outside its
    trash block) must be equal, the logprob within LOGPROB_ATOL. On a
    closed engine (its graphs live on); launches made here are not
    counted."""
    import dataclasses

    import numpy as np
    import torch

    from gofr_tpu_torch.tpu.generator import GenStream, _Request

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    rng = np.random.default_rng(seed)
    caches = ["cache"] + (["_scratch"] if gen._paged else [])

    def randomize(c):
        for t in (c.k, c.v):
            t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                                  device="cuda", dtype=torch.int8))
        for t in (c.k_scale, c.v_scale):
            t.copy_(torch.rand(t.shape, generator=g, device="cuda") * 0.02)
        c.lengths.copy_(torch.randint(0, 100, c.lengths.shape, generator=g,
                                      device="cuda", dtype=torch.int32))

    def clone(c):
        return dataclasses.replace(
            c, k=c.k.clone(), v=c.v.clone(), lengths=c.lengths.clone(),
            k_scale=c.k_scale.clone(), v_scale=c.v_scale.clone())

    def eager(key):
        with torch.no_grad():
            out = gen._admission_fn(key)()
        return None if out is None else (int(out[0]), float(out[1]))

    slot = 3
    for n, draw in ((500, False), (500, True), (1500, False), (1500, True)):
        for name in caches:
            randomize(getattr(gen, name))
        copies = {name: clone(getattr(gen, name)) for name in caches}
        prompt = rng.integers(0, gen.cfg.vocab_size, n)
        seed_r = int(rng.integers(0, 2**31 - 1))
        blocks = None
        if gen._paged:
            need = -(-n // gen._block_t)
            blocks = rng.choice(np.arange(1, gen.cache.n_blocks), need,
                                replace=False).tolist()

        def request():
            return _Request(GenStream(0), prompt, 4, 0.8 if draw else 0.0,
                            50 if draw else 0, None, seed_r)

        held = blocks and ([], 0, list(blocks))   # (shared, matched, fresh)
        replays0 = gen.admission_replays
        got = gen._prefill(slot, request(), held)
        replays = gen.admission_replays - replays0
        real = {name: getattr(gen, name) for name in caches}
        for name, c in copies.items():
            setattr(gen, name, c)
        gen._run_admission = eager
        try:
            want = gen._prefill(slot, request(), held)
        finally:
            del gen._run_admission
            for name, c in real.items():
                setattr(gen, name, c)
        torch.cuda.synchronize()
        same = {"first token": got[0] == want[0]}
        for name in caches:
            a, b = real[name], copies[name]
            # a pool's trash block 0 takes every write routed nowhere,
            # several to one position in a write-back: its bytes are
            # whichever landed last, and nothing reads them
            live = slice(1 if gen._paged and name == "cache" else 0, None)
            same[f"{name} cursors"] = torch.equal(a.lengths, b.lengths)
            same[f"{name} bytes"] = all(
                torch.equal(x[:, live], y[:, live]) for x, y in (
                    (a.k, b.k), (a.v, b.v), (a.k_scale, b.k_scale),
                    (a.v_scale, b.v_scale)))
        lp = abs(got[1] - want[1])
        ok = all(same.values()) and lp <= LOGPROB_ATOL
        print(f"[{tag}] admission of {n} tokens (draw={draw}) as {replays} "
              f"graph replays vs its functions run eagerly: {same}, "
              f"|logprob diff| {lp:.3e} (atol {LOGPROB_ATOL}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        require(ok, f"{tag}: an admission's replays differ from its eager "
                    f"functions ({n} tokens, draw={draw}): {same}, "
                    f"logprob diff {lp}")
        del copies


def timed_admissions(gen) -> list:
    """Wrap the engine's admission dispatch with CUDA events around the
    replay and its first token's copy (the start event is reached when
    the stream gets there, behind any block in flight): each dispatch's
    (key, start, end). The caller deletes ``gen._run_admission``."""
    import torch

    run = gen._run_admission
    spans: list = []

    def timed(key):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run(key)
        end.record()
        spans.append((key, start, end))
        return out

    gen._run_admission = timed
    return spans


def delivery_clock(gen) -> dict:
    """Wrap the engine's token delivery: each stream's delivery times
    (host clock) by request id. The caller deletes ``gen._deliver``."""
    deliver = gen._deliver
    times: dict = {}

    def clocked(idx, slot, token, lp=None):
        times.setdefault(slot.request.stream.request_id, []).append(
            time.monotonic())
        return deliver(idx, slot, token, lp)

    gen._deliver = clocked
    return times


def lattice_gaps(streams, times: dict) -> list:
    """For each lattice admission (a stream with mid chunks, from its
    admission to the end of its prefill), the longest wait between two
    deliveries of each other stream that was decoding across it, ms."""
    import numpy as np

    gaps = []
    for s in streams:
        if not s.chunks:
            continue
        a, b = s.trace["admit"], s.trace["prefill_done"]
        for o in streams:
            t = times.get(o.request_id, [])
            before = [x for x in t if x <= a]
            after = [x for x in t if x >= b]
            if o is s or not before or not after:
                continue
            inside = [before[-1]] + [x for x in t if a < x < b] + [after[0]]
            gaps.append(1e3 * float(np.max(np.diff(inside))))
    return gaps


def gap_line(streams, times: dict) -> str:
    import numpy as np

    gaps = lattice_gaps(streams, times)
    chunks = [s.chunks for s in streams]
    if not gaps:
        return f"stream.chunks {chunks}; no stream decoded across a lattice"
    return (f"stream.chunks {chunks}; inter-token gap of streams decoding "
            f"across a lattice admission: mean {np.mean(gaps):.1f} ms, p50 "
            f"{np.median(gaps):.1f} ms, max {max(gaps):.1f} ms over "
            f"{len(gaps)} (lattice, stream) pairs")


def dispatch_times(spans) -> dict:
    """Admission dispatches by kind (a bucket's prefill, mid chunk, final
    chunk of a width, write-back): count and mean device time, ms."""
    import numpy as np

    kinds: dict = {}
    for key, start, end in spans:
        name = "/".join(str(k) for k in key if not isinstance(k, bool))
        kinds.setdefault(name, []).append(start.elapsed_time(end))
    return {k: f"{len(v)} x {np.mean(v):.2f}" for k, v in sorted(kinds.items())}


def chunk_attention_case(cfg, smax: int, c: int) -> None:
    """The chunk lattice's attention (ops.attention.chunk_attention, plain
    PyTorch on every device, as it is plain jnp in JAX) at a mid chunk's
    shapes, one layer: its device time, the 32 layers of a chunk, and
    the least time the card could take (bytes: the int8 row and scales,
    q and the chunk's k/v, the output; operations: both products over
    Smax + C positions on bf16 tensor cores). Printed as a record; no
    kernel of the port computes it."""
    import torch

    from gofr_tpu_torch.ops.attention import chunk_attention
    from gofr_tpu_torch.ops.quant import quantize_kv

    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    start = torch.tensor([smax // 4], device="cuda")
    sets = []
    for _ in range(2):
        (kc, ks), (vc, vs) = (quantize_kv(_rng_bf16(g, (1, smax, kv, d)))
                              for _ in range(2))
        sets.append((_rng_bf16(g, (1, c, h, d)), kc, vc,
                     _rng_bf16(g, (1, c, kv, d)), _rng_bf16(g, (1, c, kv, d)),
                     start, ks, vs))
    ms = graph_ms(chunk_attention, sets, 4)
    n_bytes = (2 * smax * kv * (d + 4) + 2 * c * (h + 2 * kv) * d
               + 2 * c * h * d)
    n_ops = 2 * 2 * c * h * d * (smax + c)
    bound, by = bound_ms(n_bytes, n_ops, BF16_TENSOR_FLOPS)
    print(f"[chunk] chunk_attention C={c} Smax={smax} H={h} KV={kv} int8 "
          f"row: {ms:.3f} ms a layer, {LAYERS * ms:.1f} ms a chunk of "
          f"{LAYERS} layers; bound {bound:.4f} ms a layer ({by})",
          flush=True)


def profile_admission(engine, prompt, background, card: str,
                      tag: str) -> None:
    """A running engine (``background`` streams decoding) takes one
    bucket admission under torch.profiler: the device's busy share of
    the window, and the admission's device time by CUDA events around
    its replay. Outside the counted run."""
    from torch.profiler import ProfilerActivity, profile

    gen = engine.generator
    bg = [engine.generate(p, max_new_tokens=48) for p in background]
    heads = [next(iter(s)) for s in bg]
    spans = timed_admissions(gen)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with quiet_device(gen):
        prof.start()
        t0 = time.monotonic()
    try:
        toks = engine.generate(prompt, max_new_tokens=4).tokens()
    finally:
        with quiet_device(gen) as t_end:
            prof.stop()
        del gen._run_admission
    wall_ms = 1e3 * (t_end - t0)
    rest = [s.tokens() for s in bg]
    require(len(toks) == 4 and all(len(r) + 1 == 48 for r in rest)
            and len(heads) == len(bg), "the profiled admission's streams "
            "are short")
    busy_ms = sum(e.self_device_time_total / 1e3
                  for e in prof.key_averages() if e.self_device_time_total > 0)
    adm = [(k, a.elapsed_time(b)) for k, a, b in spans]
    print(f"[{tag}] one admission of {len(prompt)} tokens beside "
          f"{len(bg)} decoding streams: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 - 100 * busy_ms / wall_ms:.1f}% idle); "
          f"its dispatches by CUDA events {adm}; card: {card}", flush=True)


def release_graphs(gen) -> None:
    """Drop a closed engine's graphs, so their pools go back to the card
    before the next engine is built."""
    import torch

    gen._graphs = gen._adm_graphs = None
    gen._verify_graph = None
    torch.cuda.empty_cache()


def phase_main_path(card: str) -> dict:
    import numpy as np
    import torch

    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.ops import flash, flash_decode
    from gofr_tpu_torch.tpu import new_engine_from_config

    t0 = time.monotonic()
    engine = new_engine_from_config(MapConfig(MAIN_ROWS), device="cuda")
    gen = engine.generator
    torch.cuda.synchronize()
    print(f"[main] llama3-8b engine ready (kernels built, decode graphs "
          f"captured) in {time.monotonic() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)
    vocab = gen.cfg.vocab_size
    rng = np.random.default_rng(MAIN_SEED)
    prompts = [rng.integers(0, vocab, n).tolist() for n in MAIN_LENS]
    prompts.append(list(prompts[0]))         # a repeated greedy prompt
    new_tokens = MAIN_NEW_TOKENS
    try:
        # warm the process (cuBLAS handles, first launches) outside the
        # counted run
        warm = engine.generate(prompts[2], max_new_tokens=4).tokens()
        require(len(warm) == 4, f"warm-up gave {len(warm)} tokens")
        adm0, steps0, replays0, adm_replays0 = (
            gen.admissions, gen.decode_steps, gen.graph_replays,
            gen.admission_replays)
        flash.reset_counts()
        flash_decode.reset_counts()
        outs, streams, wall = _serve(engine, prompts, MAIN_SAMPLED,
                                     new_tokens)
        counts = {"flash_prefill": flash.launches,
                  "flash_decode": flash_decode.launches,
                  "prefill_plain": flash.plain_calls,
                  "decode_plain": flash_decode.plain_calls}
        admissions = gen.admissions - adm0
        steps = gen.decode_steps - steps0
        replays = gen.graph_replays - replays0
        adm_replays = gen.admission_replays - adm_replays0
        stats = gen.stats()
        health = engine.health_check()
        # one contiguous continue_from resume (a full recompute of
        # prompt + emitted, then flash_decode), outside the counted run
        (spliced,), _ = kill_and_resume(engine, [(prompts[1], {})],
                                        [prompts[2]], new_tokens)
        profile_decode(engine, prompts[4], card)
        profile_admission(engine, prompts[1], [prompts[i] for i in (0, 2, 4)],
                          card, "main-admission")
    finally:
        engine.close()
    require(not gen._thread.is_alive(),
            "the generation thread outlived close()")
    for i, toks in enumerate(outs):
        require(len(toks) == new_tokens,
                f"request {i} gave {len(toks)} tokens, want {new_tokens}")
        require(all(0 <= t < vocab for t in toks),
                f"request {i} gave a token outside the vocabulary")
    require(outs[0] == outs[5], "a repeated greedy prompt gave other tokens")
    require(health.status == "UP", f"engine health {health.status}")
    require(admissions == len(prompts),
            f"{admissions} admissions for {len(prompts)} requests")
    require(counts["flash_prefill"] == LAYERS * admissions,
            f"flash_prefill launched {counts['flash_prefill']} times for "
            f"{admissions} admissions of {LAYERS} layers")
    require(counts["flash_decode"] == LAYERS * steps,
            f"flash_decode launched {counts['flash_decode']} times for "
            f"{steps} decode steps of {LAYERS} layers")
    require(replays > 0 and replays * gen.decode_block == steps,
            f"{replays} graph replays for {steps} decode steps")
    require(adm_replays == admissions,
            f"{adm_replays} admission replays for {admissions} bucket "
            f"admissions")
    require(counts["prefill_plain"] == 0 and counts["decode_plain"] == 0,
            f"plain versions ran on the main path: {counts}")
    require(stats["scheduler"]["pipeline"]["depth"] == 2,
            f"phase 5 serves at depth {stats['scheduler']['pipeline']}")
    require(len(spliced) == new_tokens,
            f"the resumed stream gave {len(spliced)} tokens")
    print(f"[main] a {len(prompts[1])}-token greedy stream killed by "
          f"GENERATOR_MIDKILL after {KILL_AT} tokens and continued with "
          f"continue_from (contiguous: a full recompute, flash_decode): "
          f"first index where the spliced stream differs from the "
          f"uninterrupted one: {splice_agreement(spliced, outs[1])}",
          flush=True)
    print(f"[main] {len(prompts)} requests, prompts "
          f"{MAIN_LENS + [MAIN_LENS[0]]}, {new_tokens} new tokens each: "
          f"{serve_line(stats, streams, outs, wall)}; {admissions} "
          f"admissions in {adm_replays} replays (buckets "
          f"{stats['prompt_buckets']}), {steps} decode steps in {replays} "
          f"replays; launches {counts}; the admission graphs "
          f"({len(gen._adm_graphs)}) reserved "
          f"{gen.admission_graph_bytes / 2**30:.2f} GiB; card: {card}",
          flush=True)
    replay_vs_eager(gen, MAIN_LENS + [17, 1000, 2000], 101, "main")
    admission_vs_eager(gen, 103, "main")
    release_graphs(gen)

    # the same requests at dispatch depth 1, on the same weights (seed 0)
    t0 = time.monotonic()
    d1 = new_engine_from_config(
        MapConfig(dict(MAIN_ROWS, TPU_DECODE_PIPELINE="1")), device="cuda")
    try:
        d1.generate(prompts[2], max_new_tokens=4).tokens()
        outs1, streams1, wall1 = _serve(d1, prompts, MAIN_SAMPLED,
                                        new_tokens)
        stats1 = d1.generator.stats()
    finally:
        d1.close()
    differ = [i for i in range(len(prompts)) if outs1[i] != outs[i]]
    print(f"[main] TPU_DECODE_PIPELINE=1 (engine ready in "
          f"{time.monotonic() - t0 - wall1:.1f} s, serving included): "
          f"{serve_line(stats1, streams1, outs1, wall1)}; streams that "
          f"differ from depth 2's: {differ}", flush=True)
    require(stats1["scheduler"]["pipeline"]["depth"] == 1,
            f"TPU_DECODE_PIPELINE=1 served at {stats1['scheduler']}")
    require(not differ, f"depth-1 streams differ from depth 2's: {differ}")
    return counts


# -- phase paged: the paged path ---------------------------------------------

PAGED_ROWS = {"TPU_MODEL": "llama3-8b", "TPU_SLOTS": "32",
              "TPU_MAX_SEQ": "4096", "TPU_KV_DTYPE": "int8",
              "TPU_DECODE_BLOCK": "4", "TPU_PAGED_BLOCK": "128",
              "TPU_PAGED_BLOCKS": "257"}
PAGED_SEED = 23
PAGED_NEW_TOKENS = 40


def paged_prompt_lengths(rng) -> list[int]:
    """Phase paged's prompt lengths: 20 drawn from ``rng`` in 64-1500,
    then the block boundaries 127, 128, 129 and 256."""
    return rng.integers(64, 1501, 20).tolist() + [127, 128, 129, 256]


def _serve(engine, prompts, sampled: dict, new_tokens: int):
    """Submit every request, then drain them in order: (token lists,
    streams, wall seconds)."""
    t0 = time.monotonic()
    streams = [engine.generate(
        p, max_new_tokens=new_tokens,
        temperature=0.8 if i in sampled else 0.0,
        top_k=50 if i in sampled else 0, seed=sampled.get(i))
        for i, p in enumerate(prompts)]
    outs = [s.tokens() for s in streams]
    return outs, streams, time.monotonic() - t0


def phase_paged(card: str) -> dict:
    import numpy as np
    import torch

    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.ops import flash, flash_decode, paged_attention
    from gofr_tpu_torch.tpu import GenerationEngine, new_engine_from_config

    t0 = time.monotonic()
    engine = new_engine_from_config(MapConfig(PAGED_ROWS), device="cuda")
    gen = engine.generator
    SHARED["params"] = gen.params   # the later phases' weights
    torch.cuda.synchronize()
    print(f"[paged] llama3-8b paged engine ready (decode graphs captured) "
          f"in {time.monotonic() - t0:.1f} s: {PAGED_ROWS}; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)
    rng = np.random.default_rng(PAGED_SEED)
    vocab = gen.cfg.vocab_size
    lens = paged_prompt_lengths(rng)
    prompts = [rng.integers(0, vocab, n).tolist() for n in lens]
    sampled = {5: 101, 17: 202}   # request index -> seed
    new_tokens = PAGED_NEW_TOKENS
    try:
        warm = engine.generate(prompts[0][:32], max_new_tokens=4).tokens()
        require(len(warm) == 4, f"warm-up gave {len(warm)} tokens")
        adm0, steps0, replays0, adm_replays0 = (
            gen.admissions, gen.decode_steps, gen.graph_replays,
            gen.admission_replays)
        times = delivery_clock(gen)
        spans = timed_admissions(gen)
        for mod in (flash, flash_decode, paged_attention):
            mod.reset_counts()
        try:
            outs, streams, wall = _serve(engine, prompts, sampled,
                                         new_tokens)
        finally:
            del gen._deliver, gen._run_admission
        counts = {"flash_prefill": flash.launches,
                  "paged_decode": paged_attention.launches,
                  "flash_decode": flash_decode.launches,
                  "prefill_plain": flash.plain_calls,
                  "decode_plain": flash_decode.plain_calls,
                  "paged_plain": paged_attention.plain_calls}
        admissions = gen.admissions - adm0
        steps = gen.decode_steps - steps0
        replays = gen.graph_replays - replays0
        adm_replays = gen.admission_replays - adm_replays0
        stats = gen.stats()
        health = engine.health_check()
        profile_decode(engine, prompts[4], card, "paged-profile")
        profile_admission(engine, prompts[lens.index(max(lens))][:500],
                          [p[:100] for p in prompts[:8]], card,
                          "paged-admission")
    finally:
        engine.close()
    lattices = [s for s in streams if s.chunks]
    bucket_admissions = len(streams) - len(lattices)
    require(not gen._thread.is_alive(), "the generation thread outlived "
            "close()")
    for i, toks in enumerate(outs):
        require(len(toks) == new_tokens,
                f"paged request {i} gave {len(toks)} tokens, want "
                f"{new_tokens}")
        require(all(0 <= x < vocab for x in toks),
                f"paged request {i} gave a token outside the vocabulary")
    require(health.status == "UP", f"paged engine health {health.status}")
    require(admissions == len(prompts),
            f"{admissions} admissions for {len(prompts)} requests")
    require(len(lattices) == sum(n > 512 for n in lens),
            f"{len(lattices)} lattice admissions for "
            f"{sum(n > 512 for n in lens)} prompts past the largest bucket")
    require(counts["flash_prefill"] == LAYERS * bucket_admissions,
            f"flash_prefill launched {counts['flash_prefill']} times for "
            f"{bucket_admissions} bucket admissions of {LAYERS} layers")
    # a bucket admission is one replay; a lattice its mid chunks, its
    # final chunk and the write-back
    want_replays = bucket_admissions + sum(s.chunks + 2 for s in lattices)
    require(adm_replays == want_replays,
            f"{adm_replays} admission replays, want {want_replays}")
    require(counts["paged_decode"] == LAYERS * steps,
            f"paged_decode launched {counts['paged_decode']} times for "
            f"{steps} decode steps of {LAYERS} layers")
    require(replays > 0 and replays * gen.decode_block == steps,
            f"{replays} graph replays for {steps} decode steps")
    others = {k: counts[k] for k in ("flash_decode", "prefill_plain",
                                     "decode_plain", "paged_plain")}
    require(not any(others.values()),
            f"other attention paths ran on the paged path: {others}")
    require(stats["scheduler"]["pipeline"]["depth"] == 2,
            f"phase paged serves at depth {stats['scheduler']['pipeline']}")
    paged = stats["paged"]
    require(paged["evictions"] == 0, f"paged evictions: {paged}")
    require(paged["free"] == 256, f"pool not whole after retiring: {paged}")
    print(f"[paged] {len(prompts)} requests, prompts {lens}, {new_tokens} "
          f"new tokens each ({len(sampled)} sampled): "
          f"{serve_line(stats, streams, outs, wall)}; {admissions} "
          f"admissions ({bucket_admissions} in a bucket, {len(lattices)} "
          f"through the lattice) in {adm_replays} admission replays, "
          f"{steps} decode steps in {replays} replays; "
          f"{gap_line(streams, times)}; launches {counts}; pool {paged}; "
          f"the admission graphs ({len(gen._adm_graphs)}) reserved "
          f"{gen.admission_graph_bytes / 2**30:.2f} GiB; card: {card}",
          flush=True)
    print(f"[paged] the burst's admission dispatches, device time by CUDA "
          f"events: {dispatch_times(spans)}", flush=True)
    chunk_attention_case(gen.cfg, gen.max_seq, gen._chunk)
    # phase paged's first-step lengths and 8 empty slots
    replay_vs_eager(gen, lens + [0] * 8, 102, "paged")
    admission_vs_eager(gen, 104, "paged")
    release_graphs(gen)

    # the same burst with interleave off (TPU_PREFILL_CHUNK=0): the
    # lattices' chunks back to back, no decode block between them
    off = GenerationEngine(gen.cfg, gen.params, slots=32, max_seq=4096,
                           kv_dtype=torch.int8, decode_block=4,
                           paged_blocks=257, paged_block_size=128,
                           prefill_chunk=0, device="cuda")
    try:
        off.generate(prompts[0][:32], max_new_tokens=4).tokens()
        off_times = delivery_clock(off)
        off_outs, off_streams, off_wall = _serve(off, prompts, sampled,
                                                 new_tokens)
        off_stats = off.stats()
    finally:
        off.close()
    release_graphs(off)
    off_differ = [i for i in range(len(prompts)) if off_outs[i] != outs[i]]
    print(f"[paged] TPU_PREFILL_CHUNK=0 (interleave off), the same burst: "
          f"{serve_line(off_stats, off_streams, off_outs, off_wall)}; "
          f"{gap_line(off_streams, off_times)}; streams that differ from "
          f"the interleaved run's: {off_differ}", flush=True)
    require(not off_stats["scheduler"]["chunk_interleave"],
            f"TPU_PREFILL_CHUNK=0 ran with {off_stats['scheduler']}")
    require(not off_differ, f"interleave-off streams differ: {off_differ}")

    # the same requests through a contiguous engine on the same weights:
    # each row is computed on its own, so the streams must be equal
    rows = GenerationEngine(gen.cfg, gen.params, slots=32, max_seq=4096,
                            kv_dtype=torch.int8, decode_block=4,
                            device="cuda")
    try:
        want, _, rows_wall = _serve(rows, prompts, sampled, new_tokens)
    finally:
        rows.close()
    greedy = [i for i in range(len(prompts)) if i not in sampled]
    differ = [i for i in range(len(prompts)) if outs[i] != want[i]]
    print(f"[paged] contiguous engine on the same weights and requests "
          f"({rows_wall:.3f} s): streams that differ {differ} (greedy "
          f"{len(greedy)}, sampled {sorted(sampled)})", flush=True)
    require(not [i for i in differ if i in greedy],
            f"greedy paged streams differ from the contiguous engine's: "
            f"{differ}")
    require(not differ, f"sampled paged streams differ from the contiguous "
                        f"engine's: {differ}")
    return counts


# -- phase spec: speculative decoding on the paged path -----------------------

SPEC_ROWS = dict(PAGED_ROWS, TPU_SPEC_DECODE="4")
SPEC_SEED = 29
SPEC_REQUESTS = 24
SPEC_X = (64, 400)        # |X| drawn in this range
SPEC_CONTINUATION = 32    # |S| of the prompts X + S + X


def _first_difference(a: list, b: list):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def phase_spec(card: str) -> dict:
    import numpy as np
    import torch

    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.ops import flash, flash_decode, paged_attention
    from gofr_tpu_torch.tpu import GenerationEngine, new_engine_from_config

    t0 = time.monotonic()
    engine = new_engine_from_config(MapConfig(SPEC_ROWS), device="cuda",
                                    params=SHARED.get("params"))
    gen = engine.generator
    torch.cuda.synchronize()
    print(f"[spec] llama3-8b paged spec engine ready (verify graph "
          f"captured) "
          f"in {time.monotonic() - t0:.1f} s: {SPEC_ROWS}", flush=True)
    # the spec-less paged engine on the same weights: it writes S, then
    # serves the same requests for the record
    n_blocks = int(SPEC_ROWS["TPU_PAGED_BLOCKS"])
    ref = GenerationEngine(gen.cfg, gen.params, slots=gen.n_slots,
                           max_seq=gen.max_seq, kv_dtype=torch.int8,
                           decode_block=gen.decode_block,
                           paged_blocks=n_blocks,
                           paged_block_size=int(SPEC_ROWS["TPU_PAGED_BLOCK"]),
                           device="cuda")
    rng = np.random.default_rng(SPEC_SEED)
    vocab = gen.cfg.vocab_size
    xs = [rng.integers(0, vocab, n).tolist()
          for n in rng.integers(SPEC_X[0], SPEC_X[1] + 1, SPEC_REQUESTS)]
    new_tokens = PAGED_NEW_TOKENS
    try:
        conts, _, _ = _serve(ref, xs, {}, SPEC_CONTINUATION)
        prompts = [x + c + x for x, c in zip(xs, conts)]
        warm = engine.generate(prompts[0][:32], max_new_tokens=4).tokens()
        require(len(warm) == 4, f"warm-up gave {len(warm)} tokens")
        adm0, steps0, passes0, replays0, vreplays0 = (
            gen.admissions, gen.decode_steps, gen.verify_passes,
            gen.graph_replays, gen.verify_replays)
        spec0 = dict(gen.stats()["spec_decode"])
        for mod in (flash, flash_decode, paged_attention):
            mod.reset_counts()
        outs, streams, wall = _serve(engine, prompts, {}, new_tokens)
        counts = {"flash_prefill": flash.launches,
                  "paged_decode": paged_attention.launches,
                  "paged_window": paged_attention.window_launches,
                  "flash_decode": flash_decode.launches,
                  "prefill_plain": flash.plain_calls,
                  "decode_plain": flash_decode.plain_calls,
                  "paged_plain": paged_attention.plain_calls,
                  "window_plain": paged_attention.window_plain_calls}
        admissions = gen.admissions - adm0
        steps = gen.decode_steps - steps0
        passes = gen.verify_passes - passes0
        replays = gen.graph_replays - replays0
        vreplays = gen.verify_replays - vreplays0
        stats = gen.stats()
        health = engine.health_check()
        want, _, ref_wall = _serve(ref, prompts, {}, new_tokens)
    finally:
        engine.close()
        ref.close()
    first_step = paged_prompt_lengths(np.random.default_rng(PAGED_SEED))
    verify_ms = verify_vs_eager(
        gen, first_step + [0] * (gen.n_slots - len(first_step)), SPEC_SEED,
        "spec")
    release_graphs(gen)
    release_graphs(ref)
    require(not gen._thread.is_alive(), "the generation thread outlived "
            "close()")
    spec = stats["spec_decode"]
    windows = spec["windows"] - spec0["windows"]
    emitted = spec["emitted"] - spec0["emitted"]
    for i, toks in enumerate(outs):
        require(len(toks) == new_tokens,
                f"spec request {i} gave {len(toks)} tokens, want "
                f"{new_tokens}")
        require(all(0 <= x < vocab for x in toks),
                f"spec request {i} gave a token outside the vocabulary")
    require(health.status == "UP", f"spec engine health {health.status}")
    require(windows > 0 and emitted >= windows,
            f"verify windows {windows}, emitted {emitted}")
    require(admissions == len(prompts),
            f"{admissions} admissions for {len(prompts)} requests")
    bucket_admissions = sum(not s.chunks for s in streams)
    require(counts["flash_prefill"] == LAYERS * bucket_admissions,
            f"flash_prefill launched {counts['flash_prefill']} times for "
            f"{bucket_admissions} bucket admissions of {LAYERS} layers")
    require(vreplays == passes and passes > 0,
            f"{vreplays} verify graph replays for {passes} verify passes")
    require(counts["paged_window"] == LAYERS * passes,
            f"paged_window launched {counts['paged_window']} times for "
            f"{passes} verify passes of {LAYERS} layers")
    require(counts["paged_decode"] == LAYERS * steps,
            f"paged_decode launched {counts['paged_decode']} times for "
            f"{steps} decode steps of {LAYERS} layers")
    require(replays * gen.decode_block == steps,
            f"{replays} graph replays for {steps} decode steps")
    pipe = stats["scheduler"]["pipeline"]
    require(pipe["depth"] == 2 and pipe["target_depth"] == 1
            and pipe["overlapped_reaps"] == 0,
            f"a spec engine must run at depth 1: {pipe}")
    others = {k: counts[k] for k in ("flash_decode", "prefill_plain",
                                     "decode_plain", "paged_plain",
                                     "window_plain")}
    require(not any(others.values()),
            f"other attention paths ran on the spec path: {others}")
    paged = stats["paged"]
    require(paged["evictions"] == 0, f"paged evictions: {paged}")
    require(paged["free"] == n_blocks - 1,
            f"pool not whole after retiring: {paged}")
    total = sum(len(x) for x in outs)
    differ = {i: _first_difference(outs[i], want[i])
              for i in range(len(prompts)) if outs[i] != want[i]}
    print(f"[spec] {len(prompts)} greedy requests, prompts X + S + X of "
          f"{[len(p) for p in prompts]} tokens, {new_tokens} new tokens "
          f"each: {serve_line(stats, streams, outs, wall)} (PR 9: "
          f"363.9-410.5 tok/s); {passes} verify passes in {vreplays} verify "
          f"graph replays ({spec['verify_ms_mean']:.2f} ms mean dispatch to "
          f"reap, host clock; PR 7's eager pass: 37.05 and 41.36 ms; one "
          f"replay {verify_ms:.3f} ms of device time, CUDA events, at phase "
          f"paged's first-step lengths), "
          f"{steps} decode steps in {replays} replays; {windows} "
          f"slot-windows emitted {emitted} tokens = "
          f"{emitted / windows:.3f} a window; launches {counts}; pool "
          f"{paged}; card: {card}", flush=True)
    print(f"[spec] the spec-less paged engine on the same weights and "
          f"requests: {total} tokens in {ref_wall:.3f} s = "
          f"{total / ref_wall:.1f} tok/s; streams that differ (request: "
          f"first differing index) {differ} of {len(prompts)} (a record: "
          f"bf16 near-ties can flip a greedy token)", flush=True)

    # the contiguous spec engine: verify_step's plain window attention
    rows = GenerationEngine(gen.cfg, gen.params, slots=4, max_seq=2048,
                            kv_dtype=torch.int8, decode_block=4,
                            spec_decode_k=4, device="cuda")
    try:
        couts, _, cwall = _serve(rows, prompts[:4], {}, 16)
        cspec = rows.stats()["spec_decode"]
    finally:
        rows.close()
    cverify_ms = verify_vs_eager(rows, [500, 1200, 64, 0], SPEC_SEED,
                                 "spec contiguous")
    release_graphs(rows)
    require(all(len(x) == 16 for x in couts),
            f"contiguous spec streams of {[len(x) for x in couts]} tokens")
    require(cspec["windows"] > 0, f"contiguous spec engine: {cspec}")
    require(cspec["verify_replays"] == rows.verify_passes,
            f"contiguous spec engine: {cspec['verify_replays']} verify "
            f"replays for {rows.verify_passes} passes")
    print(f"[spec] contiguous spec engine (4 slots, 2048 positions, int8): "
          f"4 requests x 16 tokens in {cwall:.3f} s; {cspec}; one verify "
          f"replay {cverify_ms:.3f} ms of device time (CUDA events)",
          flush=True)
    return counts


# -- phase durable: prefix sharing, resume and recovery on the paged path ----

SHARED: dict = {}   # phase paged's weights, reused by the later phases
DURABLE_ROWS = dict(PAGED_ROWS, TPU_PREFIX_CACHE="8")
DURABLE_SEED = 31
DURABLE_PREFIX = 1536            # the shared system prompt: 12 blocks
DURABLE_TAILS = (17, 400)        # each request's own tail, drawn here
DURABLE_HITS = 15
DURABLE_MISSES = (64, 250, 480, 700)   # unrelated prompts
DURABLE_SAMPLED = {2: 303, 8: 909}     # burst index -> seed
DURABLE_FLOOD = 48               # the recovery's prompts: one bucket each
KILL_AT = 12


def splice_agreement(spliced: list, ref: list):
    """'equal', or the first index where a resumed stream parts from the
    uninterrupted one."""
    return "equal" if spliced == ref else _first_difference(spliced, ref)


def kill_and_resume(engine, targets, others, new_tokens: int):
    """Submit every target ((prompt, sampling kwargs)) and every other
    prompt (greedy) at once; each target stream is killed by the port's
    GENERATOR_MIDKILL seam at its KILL_AT-th token (its delivery runs
    under a schedule that fires once, so the seam's count of the other
    streams' tokens does not move the kill) while the others keep
    decoding (they must stream every token); then each is continued
    with ``continue_from``. Returns (spliced token lists, the
    continuation streams)."""
    from gofr_tpu_torch import chaos
    from gofr_tpu_torch.tpu import GenerationError

    gen = engine.generator
    deliver = gen._deliver
    seen: dict = {}
    ids: set = set()

    def targeted(idx, slot, token, lp=None):
        rid = slot.request.stream.request_id
        seen[rid] = seen.get(rid, 0) + 1
        if rid in ids and seen[rid] == KILL_AT:
            sched = chaos.ChaosSchedule(seed=0).on(
                chaos.GENERATOR_MIDKILL, error=RuntimeError, every=1,
                limit=1)
            with chaos.scope(sched):
                return deliver(idx, slot, token, lp)
        return deliver(idx, slot, token, lp)

    gen._deliver = targeted
    try:
        with gen._device_lock:   # the ids are known before any delivery
            killed = [engine.generate(p, max_new_tokens=new_tokens, **kw)
                      for p, kw in targets]
            ids.update(s.request_id for s in killed)
            rest = [engine.generate(p, max_new_tokens=new_tokens)
                    for p in others]
        got = []
        for s in killed:
            toks = []
            try:
                for t in s:
                    toks.append(int(t))
            except GenerationError as e:
                require("mid-stream kill" in str(e), f"a killed stream "
                        f"failed otherwise: {e!r}")
            require(len(toks) == KILL_AT and s.failed,
                    f"a stream killed at token {KILL_AT} gave {len(toks)} "
                    f"(failed: {s.failed})")
            got.append(toks)
        served = [len(s.tokens()) for s in rest]
    finally:
        del gen._deliver
    require(gen.down is None and served == [new_tokens] * len(rest),
            f"beside the killed streams: down {gen.down}, the others gave "
            f"{served} tokens")
    conts = [engine.generate(p, max_new_tokens=new_tokens,
                             continue_from=(p, g), **kw)
             for (p, kw), g in zip(targets, got)]
    spliced = [g + c.tokens() for g, c in zip(got, conts)]
    return spliced, conts


def shared_bytes(cache, blocks: list) -> list:
    """Copies of the pool's codes and scales at ``blocks``."""
    return [t[:, blocks].clone() for t in (cache.k, cache.v, cache.k_scale,
                                           cache.v_scale)]


def phase_durable(card: str) -> None:
    """Durable streaming on the paged path: prefix sharing (a stored
    system prompt, then a burst of hits and misses), kill-and-resume with
    continue_from, and recovery from a failed step with blocks in
    flight."""
    import collections

    import numpy as np
    import torch

    from gofr_tpu_torch import chaos
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.ops import flash, flash_decode, paged_attention
    from gofr_tpu_torch.tpu import GenerationError, new_engine_from_config

    t0 = time.monotonic()
    engine = new_engine_from_config(MapConfig(DURABLE_ROWS), device="cuda",
                                    params=SHARED.get("params"))
    gen = engine.generator
    torch.cuda.synchronize()
    print(f"[durable] llama3-8b paged engine with prefix sharing ready in "
          f"{time.monotonic() - t0:.1f} s: {DURABLE_ROWS}", flush=True)
    rng = np.random.default_rng(DURABLE_SEED)
    vocab = gen.cfg.vocab_size
    T = gen._block_t
    prefix = rng.integers(0, vocab, DURABLE_PREFIX).tolist()
    tails = rng.integers(DURABLE_TAILS[0], DURABLE_TAILS[1] + 1,
                         DURABLE_HITS + 1).tolist()
    hits = [prefix + rng.integers(0, vocab, n).tolist() for n in tails]
    misses = [rng.integers(0, vocab, n).tolist() for n in DURABLE_MISSES]
    burst = hits[1:] + misses
    new_tokens = PAGED_NEW_TOKENS
    idle_free = gen.stats()["paged"]["free"]
    n_graphs = len(gen._graphs) + len(gen._adm_graphs)
    graphs = (dict(gen._graphs), dict(gen._adm_graphs))
    try:
        warm = engine.generate(misses[0][:32], max_new_tokens=4).tokens()
        require(len(warm) == 4, f"warm-up gave {len(warm)} tokens")
        pc0 = dict(gen.stats()["prefix_cache"])
        adm0, steps0 = gen.admissions, gen.decode_steps
        for mod in (flash, flash_decode, paged_attention):
            mod.reset_counts()
        spans = timed_admissions(gen)
        try:
            store = engine.generate(hits[0], max_new_tokens=new_tokens)
            store_out = store.tokens()
            shared = gen._prefix_idx._entries[0]["blocks"][
                :DURABLE_PREFIX // T]
            before = shared_bytes(gen.cache, shared)
            outs, streams, wall = _serve(engine, burst, DURABLE_SAMPLED,
                                         new_tokens)
        finally:
            del gen._run_admission
        counts = {"flash_prefill": flash.launches,
                  "paged_decode": paged_attention.launches,
                  "flash_decode": flash_decode.launches,
                  "prefill_plain": flash.plain_calls,
                  "decode_plain": flash_decode.plain_calls,
                  "paged_plain": paged_attention.plain_calls}
        admissions = gen.admissions - adm0
        steps = gen.decode_steps - steps0
        stats = gen.stats()
        after = shared_bytes(gen.cache, shared)
        entries = [list(e["blocks"]) for e in gen._prefix_idx._entries]
        rc = gen._alloc._rc.copy()

        # kill-and-resume: a greedy and a seeded hit killed at token
        # KILL_AT while two misses decode, each continued
        targets = [(hits[1], {}),
                   (hits[3], {"temperature": 0.8, "top_k": 50,
                              "seed": DURABLE_SAMPLED[2]})]
        spliced, conts = kill_and_resume(engine, targets, misses[1:3],
                                         new_tokens)

        # recovery: a DeviceLost at the step seam with a block in flight,
        # every slot live and four requests queued
        probe = misses[1][:200]
        probe_before = engine.generate(probe, max_new_tokens=16).tokens()
        flood = [rng.integers(0, vocab, DURABLE_FLOOD).tolist()
                 for _ in range(gen.n_slots + 4)]
        sched = chaos.ChaosSchedule(seed=0).on(
            chaos.GENERATOR_STEP, error=chaos.DeviceLost, every=3, limit=1)
        reset = gen._reset_device
        reset_s: list = []

        def timed_reset():   # the in-place reset and its probe, host clock
            t = time.monotonic()
            reset()
            reset_s.append(time.monotonic() - t)

        gen._reset_device = timed_reset
        try:
            with chaos.scope(sched):
                with gen._device_lock:   # all queued before the loop runs
                    fl = [engine.generate(p, max_new_tokens=16)
                          for p in flood]
                fates = []
                for s in fl:
                    try:
                        fates.append(len(s.tokens()))
                    except GenerationError:
                        fates.append("failed")
        finally:
            del gen._reset_device
        fired = sched.stats()["errors_fired"]
        rec_stats = gen.stats()
        rec_index = len(gen._prefix_idx)
        kept = (len(gen._graphs) + len(gen._adm_graphs) == n_graphs
                and all(gen._graphs[k] is v for k, v in graphs[0].items())
                and all(gen._adm_graphs[k] is v
                        for k, v in graphs[1].items()))
        probe_after = engine.generate(probe, max_new_tokens=16).tokens()
        health = engine.health_check()
    finally:
        engine.close()
    release_graphs(gen)
    require(not gen._thread.is_alive(), "the generation thread outlived "
            "close()")

    # the burst
    everyone = [store] + streams
    for i, toks in enumerate([store_out] + outs):
        require(len(toks) == new_tokens and all(0 <= x < vocab
                                                 for x in toks),
                f"durable request {i}: {len(toks)} tokens, want "
                f"{new_tokens} in the vocabulary")
    pc = stats["prefix_cache"]
    got_hits, got_misses = (pc["hits"] - pc0["hits"],
                            pc["misses"] - pc0["misses"])
    require(got_hits == DURABLE_HITS and got_misses == 1 + len(misses),
            f"prefix cache {pc} from {pc0}: {got_hits} hits, {got_misses} "
            f"misses, want {DURABLE_HITS} and {1 + len(misses)}")
    hit_streams = streams[:DURABLE_HITS]
    require(all(s.cache_tier == "paged" and s.cache_tokens == DURABLE_PREFIX
                for s in hit_streams)
            and store.cache_tokens == 0
            and all(s.cache_tokens == 0 for s in streams[DURABLE_HITS:]),
            "a hit did not cover the stored prefix: "
            f"{[(s.cache_tier, s.cache_tokens) for s in everyone]}")
    require(all(torch.equal(a, b) for a, b in zip(before, after)),
            "the shared blocks' bytes changed under the burst")
    held = collections.Counter(b for e in entries for b in e)
    require(stats["active"] == 0 and stats["paged"]["free"]
            == idle_free - len(held),
            f"pool {stats['paged']} after every stream retired: want "
            f"{idle_free} less the {len(held)} distinct blocks the "
            f"{len(entries)} entries hold")
    require(all(rc[b] == n for b, n in held.items())
            and int(rc.sum()) == sum(held.values()),
            "block references other than the entries' remain")
    kinds = collections.Counter(k[0] for k, _, _ in spans)
    buckets = sum(n <= gen._chunk for n in DURABLE_MISSES)
    lattices = 1 + DURABLE_HITS + len(misses) - buckets
    want_kinds = {"prefill": buckets, "readback": DURABLE_HITS,
                  "mid": sum(s.chunks for s in everyone),
                  "final": lattices, "writeback": lattices}
    require(dict(kinds) == {k: v for k, v in want_kinds.items() if v},
            f"admission replays by kind {dict(kinds)}, want {want_kinds}")
    require(admissions == 1 + len(burst),
            f"{admissions} admissions for {1 + len(burst)} requests")
    require(counts["flash_prefill"] == LAYERS * buckets > 0,
            f"flash_prefill launched {counts['flash_prefill']} times for "
            f"{buckets} bucket admissions of {LAYERS} layers")
    require(counts["paged_decode"] == LAYERS * steps > 0,
            f"paged_decode launched {counts['paged_decode']} times for "
            f"{steps} decode steps of {LAYERS} layers")
    others = {k: counts[k] for k in ("flash_decode", "prefill_plain",
                                     "decode_plain", "paged_plain")}
    require(not any(others.values()),
            f"other attention paths ran on the durable path: {others}")
    ttft = {name: [1e3 * (s.trace["first_put"] - s.trace["submit"])
                   for s in group]
            for name, group in (("storing", [store]), ("hits", hit_streams),
                                ("misses", streams[DURABLE_HITS:]))}
    readback = [a.elapsed_time(b) for k, a, b in spans if k[0] == "readback"]
    print(f"[durable] a {len(hits[0])}-token prompt stored ({DURABLE_PREFIX}"
          f"-token shared prefix), then {DURABLE_HITS} hits (tails "
          f"{tails[1:]}) and {len(misses)} misses {list(DURABLE_MISSES)} at "
          f"once, {new_tokens} new tokens each ({len(DURABLE_SAMPLED)} "
          f"sampled): {serve_line(stats, streams, outs, wall)}; prefix "
          f"cache {pc}; {steps} decode steps; launches {counts}; "
          f"admission replays {dict(kinds)}; the admission graphs "
          f"({len(graphs[1])}) reserved "
          f"{gen.admission_graph_bytes / 2**30:.2f} GiB; card: {card}",
          flush=True)
    print(f"[durable] TTFT ms (submit to first token; the burst's requests "
          f"queue behind each other's admissions): storing "
          f"{ttft['storing'][0]:.1f}; hits mean "
          f"{np.mean(ttft['hits']):.1f} p50 {np.median(ttft['hits']):.1f} "
          f"max {max(ttft['hits']):.1f}; misses mean "
          f"{np.mean(ttft['misses']):.1f} max {max(ttft['misses']):.1f}; "
          f"the read-back graph's device time (CUDA events, {len(readback)} "
          f"replays) mean {np.mean(readback):.4f} ms min "
          f"{min(readback):.4f} ms; dispatches by kind "
          f"{dispatch_times(spans)}; pool {stats['paged']}, "
          f"{len(held)} distinct blocks held by {len(entries)} entries; "
          f"card: {card}", flush=True)

    # the resume
    for (p, kw), sp, c, ref in zip(targets, spliced, conts,
                                   [outs[0], outs[2]]):
        require(len(sp) == new_tokens, f"a resumed stream gave {len(sp)}")
        require(c.cache_tier == "paged" and c.cache_tokens >= DURABLE_PREFIX,
                f"the continuation of a {len(p)}-token prompt did not hit "
                f"its stored blocks: {c.cache_tier} {c.cache_tokens}")
        print(f"[durable] {'seeded' if kw else 'greedy'} {len(p)}-token "
              f"stream killed by GENERATOR_MIDKILL after {KILL_AT} tokens "
              f"while two others decoded, continued with continue_from "
              f"({c.prompt_len} positions, {c.cache_tokens} from the stored "
              f"prompt): first index where the spliced stream differs from "
              f"the uninterrupted one: {splice_agreement(sp, ref)}",
              flush=True)

    # the recovery
    n = gen.n_slots
    require(fired == {chaos.GENERATOR_STEP: 1},
            f"the step seam fired {fired}")
    require(fates[:n] == ["failed"] * n and fates[n:] == [16] * 4,
            f"live streams must fail and queued ones be served: {fates}")
    require(rec_stats["down"] is None and rec_stats["recoveries"] == 1
            and health.status == "UP",
            f"after the failed step: down {rec_stats['down']}, recoveries "
            f"{rec_stats['recoveries']}, health {health.status}")
    require(rec_index == 0, f"{rec_index} prefix entries survived")
    require(rec_stats["paged"]["free"] == idle_free,
            f"pool {rec_stats['paged']} after the recovery, want "
            f"{idle_free} free")
    require(kept, "the recovery changed the captured graphs")
    require(probe_after == probe_before,
            "a greedy request streams other tokens after the recovery")
    print(f"[durable] a DeviceLost at the step seam with a block in "
          f"flight: {n} live streams failed, 4 queued served "
          f"({fates[n:]}), down {rec_stats['down']}, recoveries "
          f"{rec_stats['recoveries']}, prefix entries {rec_index}, pool "
          f"{rec_stats['paged']}, {n_graphs} graphs kept; the in-place "
          f"reset and its synchronize probe took "
          f"{1e3 * sum(reset_s):.2f} ms (host clock); a greedy "
          f"200-token request streams the same 16 tokens before and "
          f"after", flush=True)


# -- phase slo: deadlines, SLO classes and the admission gate -----------------

SLO_ROWS = dict(PAGED_ROWS, TPU_MAX_QUEUE_DEPTH="16",
                TPU_SLO_LATENCY_SLOTS="4", TPU_SLO_THROUGHPUT_SHARE="0.25")
SLO_SEED = 37
SLO_BATCH = 48                  # throughput-class prompts, at once
SLO_BATCH_LENS = (700, 1500)    # each one a lattice admission
SLO_LATE = 4                    # throughput, 20 ms deadline: expire queued
SLO_INTERACTIVE = 8             # latency-class prompts, 100 ms later
SLO_INTERACTIVE_LENS = (64, 400)   # each one a bucket admission (K1)
SLO_LONG = 3000                 # latency; its deadline ends mid-lattice
SLO_DECODE = (128, 400, 1.0)    # latency: prompt, new tokens, budget (s)
SLO_DRAIN = 8                   # live greedy streams through the drain


def ttft_line(streams) -> str:
    import numpy as np

    t = [1e3 * (s.trace["first_put"] - s.trace["submit"]) for s in streams
         if "first_put" in s.trace]
    if not t:
        return "none delivered"
    return (f"mean {np.mean(t):.1f} ms p50 {np.median(t):.1f} ms max "
            f"{max(t):.1f} ms over {len(t)}")


def phase_slo(card: str) -> None:
    """A service whose batch jobs (throughput class) share a replica with
    interactive clients (latency class), behind request budgets: a burst
    the gate sheds from its throughput side, deadlines that run out in
    the queue, between lattice chunks and while decoding, the pool whole
    afterwards; then a graceful drain with live streams."""
    import threading

    import numpy as np
    import torch

    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.errors import DeadlineExceeded, TooManyRequests
    from gofr_tpu_torch.ops import flash, flash_decode, paged_attention
    from gofr_tpu_torch.resilience import (SLO_LATENCY, SLO_THROUGHPUT,
                                           Deadline)
    from gofr_tpu_torch.tpu import GenerationError, new_engine_from_config

    class LatticeDeadline(Deadline):
        """A deadline that runs out once its stream's lattice has run two
        of its mid chunks: it ends mid-prefill on any machine, however
        long the request waited for its slot."""
        __slots__ = ("stream",)

        def __init__(self):
            super().__init__(time.monotonic() + 3600.0)
            self.stream = None

        def expired(self) -> bool:
            return (self.stream is not None and self.stream.chunks >= 2) \
                or super().expired()

    t0 = time.monotonic()
    engine = new_engine_from_config(MapConfig(SLO_ROWS), device="cuda",
                                    params=SHARED.get("params"))
    gen = engine.generator
    torch.cuda.synchronize()
    print(f"[slo] llama3-8b paged engine with the admission gate ready in "
          f"{time.monotonic() - t0:.1f} s: {SLO_ROWS}", flush=True)
    rng = np.random.default_rng(SLO_SEED)
    vocab = gen.cfg.vocab_size

    def prompts(n, lens):
        return [rng.integers(0, vocab, k).tolist()
                for k in rng.integers(lens[0], lens[1] + 1, n)]

    batch = prompts(SLO_BATCH, SLO_BATCH_LENS)
    late = prompts(SLO_LATE, SLO_BATCH_LENS)
    inter = prompts(SLO_INTERACTIVE, SLO_INTERACTIVE_LENS)
    long_prompt = rng.integers(0, vocab, SLO_LONG).tolist()
    decode_prompt = rng.integers(0, vocab, SLO_DECODE[0]).tolist()
    new_tokens = PAGED_NEW_TOKENS
    submitted, sheds = [], []

    def submit(tag, prompt, cls, new, deadline=None):
        try:
            s = engine.generate(prompt, max_new_tokens=new, slo_class=cls,
                                deadline=deadline)
        except TooManyRequests as e:
            sheds.append((tag, cls, e.status_code, dict(e.headers)))
            return None
        submitted.append((tag, cls, s))
        return s

    def outcome(stream):
        got = 0
        try:
            for _ in stream:
                got += 1
        except DeadlineExceeded as e:
            return ("DeadlineExceeded", got, stream.where, str(e))
        return ("ok", got, stream.where, "")

    try:
        warm = engine.generate(inter[0][:32], max_new_tokens=4).tokens()
        require(len(warm) == 4, f"warm-up gave {len(warm)} tokens")
        adm0, steps0 = gen.admissions, gen.decode_steps
        for mod in (flash, flash_decode, paged_attention):
            mod.reset_counts()
        t_burst = time.monotonic()
        # the interactive client whose budget ends while it decodes, and
        # the one whose deadline ends mid-lattice (both ahead of the
        # burst: behind it the gate's latency bound, 16 waiting, would
        # shed one of the interactive requests)
        submit("decode", decode_prompt, SLO_LATENCY, SLO_DECODE[1],
               Deadline.after(SLO_DECODE[2]))
        dl = LatticeDeadline()
        dl.stream = submit("long", long_prompt, SLO_LATENCY, new_tokens, dl)
        # the batch burst at once; 4 more batch requests with a 20 ms
        # budget right behind its first (they wait for a synchronous pass,
        # as every lattice admission does), then its tail, which the gate
        # sheds once 8 requests wait (16 x the throughput factor 0.5)
        submit("batch0", batch[0], SLO_THROUGHPUT, new_tokens)
        for i, p in enumerate(late):
            submit(f"late{i}", p, SLO_THROUGHPUT, new_tokens,
                   Deadline.after(0.02))
        for i, p in enumerate(batch[1:], 1):
            submit(f"batch{i}", p, SLO_THROUGHPUT, new_tokens)
        time.sleep(max(0.0, t_burst + 0.1 - time.monotonic()))
        for i, p in enumerate(inter):
            submit(f"inter{i}", p, SLO_LATENCY, new_tokens)
        fates = {tag: (cls, s, outcome(s)) for tag, cls, s in submitted}
        wall = time.monotonic() - t_burst
        counts = {"flash_prefill": flash.launches,
                  "paged_decode": paged_attention.launches,
                  "paged_window": paged_attention.window_launches,
                  "flash_decode": flash_decode.launches,
                  "prefill_plain": flash.plain_calls,
                  "decode_plain": flash_decode.plain_calls,
                  "paged_plain": paged_attention.plain_calls}
        admissions = gen.admissions - adm0
        steps = gen.decode_steps - steps0
        stats = gen.stats()
        bucket_admissions = sum(
            1 for _, s, f in fates.values()
            if "admit" in s.trace and not s.chunks and f[2] != "queue")

        # the drain: live greedy streams finish, new requests are refused
        live = [engine.generate(p, max_new_tokens=new_tokens)
                for p in prompts(SLO_DRAIN, SLO_INTERACTIVE_LENS)]
        end = time.monotonic() + 60
        while gen.stats()["active"] < SLO_DRAIN and time.monotonic() < end:
            time.sleep(0.002)
        drained = {}
        drainer = threading.Thread(target=lambda: drained.update(
            ok=gen.drain(30.0)))
        t_drain = time.monotonic()
        drainer.start()
        while not gen.stats()["draining"] and time.monotonic() < end:
            time.sleep(0.001)
        draining = gen.stats()["draining"]
        try:
            engine.generate(inter[0], max_new_tokens=4)
            refused = None
        except GenerationError as e:
            refused = str(e)
        live_outs = [len(s.tokens()) for s in live]
        drainer.join(60)
        drain_s = time.monotonic() - t_drain
    finally:
        engine.close()
    release_graphs(gen)

    by_class = {c: [s for cls, s, _ in fates.values() if cls == c]
                for c in (SLO_LATENCY, SLO_THROUGHPUT)}
    shed_by = {c: sum(1 for _, cls, _, _ in sheds if cls == c)
               for c in (SLO_LATENCY, SLO_THROUGHPUT)}
    expired = {tag: f for tag, (_, _, f) in fates.items()
               if f[0] != "ok"}
    served = {tag: f[1] for tag, (_, _, f) in fates.items() if f[0] == "ok"}
    print(f"[slo] {SLO_BATCH + SLO_LATE} throughput and "
          f"{SLO_INTERACTIVE + 2} latency requests in {wall:.3f} s: "
          f"{len(submitted)} queued, {len(sheds)} shed ({shed_by}; first "
          f"{sheds[0] if sheds else None}); TTFT latency class "
          f"{ttft_line(by_class[SLO_LATENCY])}, throughput class "
          f"{ttft_line(by_class[SLO_THROUGHPUT])}; served {served}; "
          f"{admissions} admissions ({bucket_admissions} bucket), {steps} "
          f"decode steps; launches {counts}; card: {card}", flush=True)
    print(f"[slo] expiries by where {stats['expired']}; typed errors "
          f"{expired}; gate {stats['admission']}; scheduler "
          f"{stats['scheduler']}; pool {stats['paged']}", flush=True)
    print(f"[slo] drain with {SLO_DRAIN} live greedy streams: drain(30) "
          f"returned {drained.get('ok')} after {drain_s:.3f} s, streams "
          f"{live_outs}, draining {draining}, a new request refused with "
          f"{refused!r}", flush=True)
    require(shed_by[SLO_THROUGHPUT] >= 1 and shed_by[SLO_LATENCY] == 0,
            f"sheds by class {shed_by}: want throughput >= 1, latency 0")
    require(all(code == 429 and "Retry-After" in h
                for _, _, code, h in sheds), f"sheds {sheds[:3]}")
    require(stats["expired"] == {"pre-queue": 0, "queue": SLO_LATE,
                                 "mid-prefill": 1, "mid-decode": 1},
            f"expiries by where {stats['expired']}")
    require(all(fates[f"late{i}"][2][:3] == ("DeadlineExceeded", 0, "queue")
                for i in range(SLO_LATE)),
            f"the late requests: {[fates[f'late{i}'][2] for i in range(4)]}")
    require(fates["long"][2][0::2] == ("DeadlineExceeded", "mid-prefill")
            and fates["long"][1].chunks >= 2,
            f"the long prompt: {fates['long'][2]}, "
            f"{fates['long'][1].chunks} chunks")
    decode_fate = fates["decode"][2]
    require(decode_fate[0::2] == ("DeadlineExceeded", "mid-decode")
            and 0 < decode_fate[1] < SLO_DECODE[1],
            f"the {SLO_DECODE[1]}-token request: {decode_fate}")
    require(all(n == new_tokens for n in served.values()),
            f"served streams {served}")
    require(stats["paged"]["free"] == int(SLO_ROWS["TPU_PAGED_BLOCKS"]) - 1
            and gen._prefix_idx is None,
            f"pool not whole after the burst: {stats['paged']}")
    require(counts["paged_decode"] == LAYERS * steps and steps > 0,
            f"paged_decode launched {counts['paged_decode']} times for "
            f"{steps} decode steps of {LAYERS} layers")
    require(counts["flash_prefill"] == LAYERS * bucket_admissions
            and bucket_admissions > 0,
            f"flash_prefill launched {counts['flash_prefill']} times for "
            f"{bucket_admissions} bucket admissions")
    others = {k: counts[k] for k in ("paged_window", "flash_decode",
                                     "prefill_plain", "decode_plain",
                                     "paged_plain")}
    require(not any(others.values()),
            f"other attention paths ran on the slo path: {others}")
    require(drained.get("ok") is True and draining
            and refused is not None and "draining" in refused
            and live_outs == [new_tokens] * SLO_DRAIN,
            f"drain: {drained}, draining {draining}, refused {refused!r}, "
            f"streams {live_outs}")


APP_ROWS = dict(SLO_ROWS, HTTP_PORT="0", METRICS_PORT="0", LOG_LEVEL="WARN",
                APP_NAME="chip-smoke")
APP_SEED = 41
APP_BUDGET_LEN = 1000    # the 50 ms budget's prompt: a lattice admission,
#                          so no first token can come inside the budget
APP_DRAIN_NEW = 160      # the drain's streams: still live while it is probed
APP_TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"
APP_RTTS = 50            # GET /.well-known/alive round trips timed
APP_CALL_TIMEOUT_S = 120  # one request's socket wait; a stream takes seconds
APP_JOIN_S = 180         # all client threads of one wave together


def http_call(port: int, method: str, path: str, body=None,
              headers=None) -> dict:
    """One request over its own connection: status, headers, and either
    the JSON body or, for a 200 on POST /generate, the ndjson lines with
    the client's clock at the send, the first line and the end."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=APP_CALL_TIMEOUT_S)
    try:
        t_send = time.monotonic()
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        out = {"status": resp.status, "headers": dict(resp.getheaders()),
               "t_send": t_send}
        if resp.status == 200 and path == "/generate":
            lines = []
            for line in resp:
                if not lines:
                    out["t_first"] = time.monotonic()
                lines.append(json.loads(line))
            out["lines"] = lines
        else:
            raw = resp.read()
            out["body"] = json.loads(raw) if raw.startswith(b"{") else raw
        out["t_end"] = time.monotonic()
        return out
    finally:
        conn.close()


def stats_line(values) -> str:
    import numpy as np

    if not values:
        return "none"
    return (f"mean {np.mean(values):.1f} ms p50 {np.median(values):.1f} ms "
            f"max {max(values):.1f} ms over {len(values)}")


def phase_app(card: str) -> None:
    """The framework's own main path on the card: the port's App, its
    Container wiring the engine from phase slo's TPU_* rows on "cuda",
    POST /generate over HTTP from client threads. Phase slo's burst as
    HTTP requests (sheds as 429s with Retry-After, counted by class
    against the engine's gate), a request whose X-Request-Timeout of
    50 ms runs out (a buffered 504, counted by the engine), a traceparent
    that reaches its stream, the health, metrics and cache scrapes, and
    a graceful stop with live streams."""
    import threading

    import numpy as np
    import torch

    from gofr_tpu_torch import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.ops import flash, flash_decode, paged_attention
    from gofr_tpu_torch.resilience import SLO_LATENCY, SLO_THROUGHPUT
    from gofr_tpu_torch.serving import install_generate

    SHARED.pop("params", None)   # the App's Container makes its own
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    app = App(MapConfig(APP_ROWS))
    tpu = app.container.tpu
    gen = tpu.generator
    torch.cuda.synchronize()
    install_generate(app)
    app.run(block=False)
    print(f"[app] App with the llama3-8b paged engine on "
          f"{gen.device} ready in {time.monotonic() - t0:.1f} s, HTTP "
          f"port {app.http_port}, metrics port {app.metrics_port}",
          flush=True)
    require(gen.device.type == "cuda", f"the engine runs on {gen.device}")
    # each POST /generate's stream, by its prompt, for the engine's clock
    streams, calls, lock = {}, [], threading.Lock()
    generate = tpu.generate

    def tracked(prompt, *args, **kw):
        try:
            s = generate(prompt, *args, **kw)
        except Exception:
            with lock:
                calls.append(None)
            raise
        with lock:
            streams[tuple(prompt)] = s
            calls.append(s)
        return s

    tpu.generate = tracked
    port = app.http_port
    rng = np.random.default_rng(APP_SEED)
    vocab = gen.cfg.vocab_size

    def prompts(n, lens):
        return [rng.integers(0, vocab, k).tolist()
                for k in rng.integers(lens[0], lens[1] + 1, n)]

    results: dict = {}

    def client(tag, tokens, new, headers=None):
        def go():
            results[tag] = http_call(port, "POST", "/generate",
                                     {"tokens": tokens, "max_new": new},
                                     headers)
        t = threading.Thread(target=go, name=f"client-{tag}", daemon=True)
        t.start()
        return t

    def join(threads):
        end = time.monotonic() + APP_JOIN_S
        for t in threads:
            t.join(max(0.0, end - time.monotonic()))
        waiting = [t.name for t in threads if t.is_alive()]
        require(not waiting, f"client threads still waiting after "
                             f"{APP_JOIN_S} s: {waiting}")

    try:
        warm = http_call(port, "POST", "/generate",
                         {"tokens": prompts(1, (32, 32))[0], "max_new": 4})
        require(warm["status"] == 200 and len(warm["lines"]) == 4,
                f"warm-up: {warm['status']}")
        rtts = []
        for _ in range(APP_RTTS):
            r = http_call(port, "GET", "/.well-known/alive")
            rtts.append(1e3 * (r["t_end"] - r["t_send"]))
        batch = prompts(SLO_BATCH, SLO_BATCH_LENS)
        inter = prompts(SLO_INTERACTIVE, SLO_INTERACTIVE_LENS)
        budget = rng.integers(0, vocab, APP_BUDGET_LEN).tolist()
        new_tokens = PAGED_NEW_TOKENS
        for mod in (flash, flash_decode, paged_attention):
            mod.reset_counts()
        adm0, steps0, n0 = gen.admissions, gen.decode_steps, len(calls)
        sheds0 = dict(gen.gate.sheds_by_class)
        expired0 = dict(gen.stats()["expired"])
        t_burst = time.monotonic()
        threads = [client(f"batch{i}", p, new_tokens,
                          {"X-SLO-Class": "throughput"})
                   for i, p in enumerate(batch)]
        # the budget right behind the batch burst, once the gate has seen
        # all of it: a latency request the gate takes (fewer than 16
        # wait), whose deadline runs out before its first token
        end = time.monotonic() + 60
        while len(calls) < SLO_BATCH and time.monotonic() < end:
            time.sleep(0.001)
        threads.append(client("budget", budget, new_tokens,
                              {"X-Request-Timeout": "50ms"}))
        time.sleep(max(0.0, t_burst + 0.1 - time.monotonic()))
        threads += [client(f"inter{i}", p, new_tokens,
                           {"traceparent": f"00-{APP_TRACE_ID}-"
                                           f"00f067aa0ba902b7-01"}
                           if i == 0 else None)
                    for i, p in enumerate(inter)]
        join(threads)
        wall = time.monotonic() - t_burst
        counts = {"flash_prefill": flash.launches,
                  "paged_decode": paged_attention.launches,
                  "paged_window": paged_attention.window_launches,
                  "flash_decode": flash_decode.launches,
                  "prefill_plain": flash.plain_calls,
                  "decode_plain": flash_decode.plain_calls,
                  "paged_plain": paged_attention.plain_calls}
        admissions = gen.admissions - adm0
        steps = gen.decode_steps - steps0
        bucket_admissions = sum(1 for s in calls[n0:] if s is not None
                                and "admit" in s.trace
                                and s.prompt_len <= gen.prompt_buckets[-1])
        stats = gen.stats()
        sheds = {c: n - sheds0[c] for c, n in
                 stats["admission"]["sheds_by_class"].items()}
        expired = {w: n - expired0[w] for w, n in stats["expired"].items()}
        health = http_call(port, "GET", "/.well-known/health")
        metrics = http_call(app.metrics_port, "GET", "/metrics")["body"]
        cache = http_call(app.metrics_port, "GET",
                          "/debug/cache?format=json")

        # the drain: live greedy streams finish over their connections,
        # health and new requests answer 503 with Retry-After
        drain_prompts = prompts(SLO_DRAIN, SLO_INTERACTIVE_LENS)
        live = [client(f"drain{i}", p, APP_DRAIN_NEW)
                for i, p in enumerate(drain_prompts)]
        end = time.monotonic() + 60
        while gen.stats()["active"] < SLO_DRAIN and time.monotonic() < end:
            time.sleep(0.002)
        active = gen.stats()["active"]
        t_drain = time.monotonic()
        stopper = threading.Thread(target=lambda: app.stop(grace_s=30.0),
                                   daemon=True)
        stopper.start()
        while not app._draining and time.monotonic() < end:
            time.sleep(0.001)
        health_draining = http_call(port, "GET", "/.well-known/health")
        refused = http_call(port, "POST", "/generate",
                            {"tokens": inter[0], "max_new": 4})
        join(live)
        stopper.join(60)
        drain_s = time.monotonic() - t_drain
        require(not stopper.is_alive(), "app.stop(grace_s=30) did not end")
    finally:
        if app._running.is_set():
            app.stop()
    release_graphs(gen)

    def cls(tag):
        return SLO_THROUGHPUT if tag.startswith("batch") else SLO_LATENCY

    burst = {t: r for t, r in results.items()
             if t.startswith(("batch", "inter"))}
    shed_http = {c: sum(1 for t, r in burst.items()
                        if r["status"] == 429 and cls(t) == c)
                 for c in (SLO_LATENCY, SLO_THROUGHPUT)}
    served = {t: r for t, r in burst.items() if r["status"] == 200}
    client_ttft = {c: [1e3 * (r["t_first"] - r["t_send"])
                       for t, r in served.items() if cls(t) == c]
                   for c in (SLO_LATENCY, SLO_THROUGHPUT)}
    engine_s = {t: streams[tuple(batch[int(t[5:])] if t.startswith("batch")
                                 else inter[int(t[5:])])]
                for t in served}
    engine_ttft = {c: [1e3 * (s.trace["first_put"] - s.trace["submit"])
                       for t, s in engine_s.items() if cls(t) == c]
                   for c in (SLO_LATENCY, SLO_THROUGHPUT)}
    # one clock (time.monotonic) on both sides: the client's send to the
    # engine's submit is the way in (connect, parse, middleware, route),
    # the engine's first delivery to the client's first line the way out
    ingress = [1e3 * (engine_s[t].trace["submit"] - r["t_send"])
               for t, r in served.items()]
    egress = [1e3 * (r["t_first"] - engine_s[t].trace["first_put"])
              for t, r in served.items()]
    tokens = sum(len(r["lines"]) for r in served.values())
    traced = streams[tuple(inter[0])]
    shed_lines = [line for line in metrics.decode().splitlines()
                  if line.startswith("app_tpu_shed_total{")]
    expired_lines = [line for line in metrics.decode().splitlines()
                     if line.startswith("app_tpu_expired_dropped_total")]
    b = results["budget"]
    drained = [results[f"drain{i}"] for i in range(SLO_DRAIN)]
    drain_outs = [(r["status"], len(r.get("lines", []))) for r in drained]
    print(f"[app] HTTP layer: GET /.well-known/alive round trip "
          f"{stats_line(rtts)}; in the burst, client send to engine "
          f"submit {stats_line(ingress)}, engine first delivery to the "
          f"client's first line {stats_line(egress)}; card: {card}",
          flush=True)
    print(f"[app] burst of {SLO_BATCH} throughput and {SLO_INTERACTIVE} "
          f"latency POST /generate in {wall:.3f} s: {len(served)} served, "
          f"{tokens} tokens ({tokens / wall:.1f} tok/s at the clients), "
          f"429s by class {shed_http}, the gate's sheds {sheds}; TTFT at "
          f"the client: latency {stats_line(client_ttft[SLO_LATENCY])}, "
          f"throughput {stats_line(client_ttft[SLO_THROUGHPUT])}; at the "
          f"engine: latency {stats_line(engine_ttft[SLO_LATENCY])}, "
          f"throughput {stats_line(engine_ttft[SLO_THROUGHPUT])}; "
          f"{admissions} admissions ({bucket_admissions} bucket), {steps} "
          f"decode steps; launches {counts}; card: {card}", flush=True)
    print(f"[app] X-Request-Timeout 50ms: {b['status']} "
          f"{b.get('body')}, expiries by where {expired}; traceparent: "
          f"stream trace_id {traced.trace_id}, X-Correlation-ID "
          f"{results['inter0']['headers'].get('X-Correlation-ID')}; "
          f"health {health['status']} {health['body']['data']['status']}; "
          f"metrics {shed_lines} {expired_lines}; /debug/cache "
          f"{cache['status']} {cache['body']}; pool {stats['paged']}",
          flush=True)
    print(f"[app] stop(grace_s=30) with {active} live streams of "
          f"{APP_DRAIN_NEW} tokens: {drain_s:.3f} s; health while draining "
          f"{health_draining['status']} Retry-After "
          f"{health_draining['headers'].get('Retry-After')}; a new request "
          f"{refused['status']} Retry-After "
          f"{refused['headers'].get('Retry-After')}; streams {drain_outs}",
          flush=True)
    require(all(r["status"] in (200, 429) for r in burst.values()),
            f"burst statuses {sorted({r['status'] for r in burst.values()})}")
    require(all(int(r["headers"].get("Retry-After", 0)) >= 1
                for r in burst.values() if r["status"] == 429),
            "a 429 without Retry-After")
    require(shed_http[SLO_THROUGHPUT] >= 1 and shed_http == sheds,
            f"429s by class {shed_http} against the gate's sheds {sheds}")
    require(sum(float(line.rsplit(" ", 1)[1]) for line in shed_lines)
            == sum(gen.gate.sheds_by_class.values()),
            f"app_tpu_shed_total {shed_lines}")
    require(all([ln.get("cursor") for ln in r["lines"]]
                == list(range(new_tokens)) for r in served.values()),
            "a served stream is not whole")
    require(b["status"] == 504
            and "deadline" in b["body"]["error"]["message"].lower()
            and sum(expired.values()) == 1 and expired["mid-decode"] == 0
            and expired_lines,
            f"the 50 ms budget: {b['status']} {b.get('body')}, expiries "
            f"{expired}, {expired_lines}")
    require(traced.trace_id == APP_TRACE_ID
            and results["inter0"]["headers"].get("X-Correlation-ID")
            == APP_TRACE_ID, f"trace id {traced.trace_id}")
    require(health["status"] == 200
            and health["body"]["data"]["status"] == "UP"
            and "generator" in health["body"]["data"]["tpu"]["details"],
            f"health {health}")
    require(b"app_http_response_bucket" in metrics and cache["status"] == 200
            and "enabled" in cache["body"], "the scrapes")
    require(stats["paged"]["free"] == int(APP_ROWS["TPU_PAGED_BLOCKS"]) - 1,
            f"pool not whole after the burst: {stats['paged']}")
    require(counts["paged_decode"] == LAYERS * steps and steps > 0,
            f"paged_decode launched {counts['paged_decode']} times for "
            f"{steps} decode steps of {LAYERS} layers")
    require(counts["flash_prefill"] == LAYERS * bucket_admissions
            and bucket_admissions > 0,
            f"flash_prefill launched {counts['flash_prefill']} times for "
            f"{bucket_admissions} bucket admissions")
    others = {k: counts[k] for k in ("paged_window", "flash_decode",
                                     "prefill_plain", "decode_plain",
                                     "paged_plain")}
    require(not any(others.values()),
            f"other attention paths ran on the app path: {others}")
    require(active == SLO_DRAIN
            and health_draining["status"] == 503
            and health_draining["headers"].get("Retry-After") == "30"
            and refused["status"] == 503
            and all(r["status"] == 200 and len(r["lines"]) == APP_DRAIN_NEW
                    for r in drained),
            f"drain: {active} live, health {health_draining['status']}, "
            f"new request {refused['status']}, streams {drain_outs}")


# -- phase predict: BERT embed, ViT classify, Llama score ---------------------

PREDICT_BERT_ROWS = {"HTTP_PORT": "0", "METRICS_PORT": "0",
                     "LOG_LEVEL": "WARN", "APP_NAME": "chip-smoke-embed",
                     "TPU_MODEL": "bert-base", "TPU_BATCH_BUCKETS": "1,2,4,8",
                     "TPU_WARMUP": "1"}
PREDICT_SHED_ROWS = dict(PREDICT_BERT_ROWS, TPU_MAX_QUEUE_DEPTH="4",
                         TPU_WARMUP="")
PREDICT_VIT_ROWS = {"TPU_MODEL": "vit-l-14", "TPU_BATCH_BUCKETS": "1,2,4,8"}
PREDICT_SCORE_ROWS = dict(PAGED_ROWS, TPU_BATCH_BUCKETS="1,2,4,8")
PREDICT_SEED = 43
PREDICT_CLIENTS = 64          # one POST /v1/embeddings each, at once
PREDICT_LENS = (8, 512)       # their token counts, drawn here
PREDICT_MULTI = (8, 4)        # then 8 requests of 4 inputs each
PREDICT_SHED_CLIENTS = 24     # against TPU_MAX_QUEUE_DEPTH=4
PREDICT_HOLD_S = 0.3          # BATCHER_DISPATCH latency while they queue
PREDICT_IMAGES = 16
PREDICT_SCORES = 16           # score requests, the streams' 8 prompts first
PREDICT_STREAMS = 8           # greedy generate streams beside them
PREDICT_SCORE_LENS = (17, 512)
# bf16 against bf16 at another bucket shape: the same roundings but for
# the accumulation order of the products (cuBLAS picks its kernels by
# shape), which flips some bf16 roundings (a step is 2^-8 of a value)
# in every one of 12 layers: a few steps, up to 2% of the unit norm. A
# mask or padding fault moves an embedding by tenths of its norm.
EMBED_SOLO_L2 = 0.02
# bf16 engine against the same weights in float32 through 12 layers: a
# bf16 rounding (2^-9) of every activation, a few percent at most of the
# pooled vector
EMBED_F32_L2 = 0.05
# ViT-L/14 in log-probabilities (the logits up to one constant a row):
# against itself at another batch bucket, and against float32 through
# 24 layers (unit-scale logits, as LOGIT_ATOL holds the Llama's 4)
VIT_SOLO_LOGP = 0.05
VIT_F32_LOGP = 0.25


def _threads(fns, join_s: float = APP_JOIN_S) -> list:
    """Run every call at once, one thread each; their results in order."""
    import threading

    out = [None] * len(fns)

    def run(i):
        out[i] = fns[i]()
    ts = [threading.Thread(target=run, args=(i,), daemon=True)
          for i in range(len(fns))]
    for t in ts:
        t.start()
    end = time.monotonic() + join_s
    for t in ts:
        t.join(max(0.0, end - time.monotonic()))
    require(not any(t.is_alive() for t in ts),
            f"threads still waiting after {join_s} s")
    return out


def _scraped(app, name: str) -> list[str]:
    body = http_call(app.metrics_port, "GET", "/metrics")["body"]
    return [line for line in body.decode().splitlines()
            if line.startswith(name)]


def _total(lines) -> float:
    return sum(float(line.rsplit(" ", 1)[1]) for line in lines)


def _f32_tree(tree: dict) -> dict:
    return {k: _f32_tree(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def predict_bert(card: str, rng) -> None:
    """BERT-base ``embed`` over POST /v1/embeddings on the port's App:
    64 clients at once, then 8 requests of 4 inputs; a 1 ms budget behind
    a held batch (a 504, its item never run), an unknown program (404),
    and a second App whose gate holds 4 waiting (429s = the gate's
    sheds = app_tpu_shed_total)."""
    import numpy as np
    import torch

    from gofr_tpu_torch import App, chaos, install_embeddings
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.models import BERT_CONFIGS, bert

    t0 = time.monotonic()
    app = App(MapConfig(PREDICT_BERT_ROWS))
    tpu = app.container.tpu
    install_embeddings(app)
    app.post("/predict/{program}", lambda ctx: ctx.tpu.predict(
        ctx.path_param("program"), np.arange(1, 9, dtype=np.int32)))
    app.run(block=False)
    port = app.http_port
    prog = tpu._programs["embed"]
    print(f"[predict] App with bert-base embed on {tpu.device} ready "
          f"(run at {len(prog.compiled_shapes)} bucket shapes by "
          f"TPU_WARMUP) in {time.monotonic() - t0:.1f} s", flush=True)
    require(tpu.device.type == "cuda", f"the engine runs on {tpu.device}")
    batcher = tpu._batchers["embed"]
    sizes, executed = [], []
    hook, runner = batcher.on_dispatch, batcher.runner

    def seen(n, wait):
        sizes.append(n)
        hook(n, wait)

    def recorded(items):
        executed.extend(tuple(int(t) for t in it) for it in items)
        return runner(items)

    batcher.on_dispatch, batcher.runner = seen, recorded
    vocab = BERT_CONFIGS["bert-base"].vocab_size

    def draw(n):
        return [rng.integers(1, vocab, k).tolist() for k in rng.integers(
            PREDICT_LENS[0], PREDICT_LENS[1] + 1, n)]

    singles = draw(PREDICT_CLIENTS)
    multis = [draw(PREDICT_MULTI[1]) for _ in range(PREDICT_MULTI[0])]
    inputs = singles + [x for m in multis for x in m]

    def post(x):
        return http_call(port, "POST", "/v1/embeddings", {"input": x})

    try:
        d0 = prog.dispatches
        t_burst = time.monotonic()
        burst = _threads([lambda x=x: post(x) for x in singles])
        burst_s = time.monotonic() - t_burst
        burst_dispatches, burst_sizes = prog.dispatches - d0, list(sizes)
        t_multi = time.monotonic()
        multi = _threads([lambda x=x: post(x) for x in multis])
        multi_s = time.monotonic() - t_multi
        multi_sizes = sizes[len(burst_sizes):]
        fill = _scraped(app, "app_tpu_batch_fill{")
        wait = [line for line in _scraped(
            app, "app_tpu_batch_wait_duration_") if "_bucket" not in line]
        solo = [tpu.predict("embed", np.asarray(x, np.int32))
                for x in inputs]
        # a 1 ms budget behind a full batch held at the dispatch seam
        expired0 = _total(_scraped(app, "app_tpu_expired_dropped_total{"))
        doomed = rng.integers(1, vocab, 40).tolist()
        with chaos.scope(chaos.ChaosSchedule(seed=1).on(
                chaos.BATCHER_DISPATCH, latency=PREDICT_HOLD_S)):
            full = _threads([lambda x=x: post(x) for x in singles[:8]] + [
                lambda: (time.sleep(0.05), http_call(
                    port, "POST", "/v1/embeddings", {"input": doomed},
                    {"X-Request-Timeout": "1ms"}))[1]])
        timed_out = full.pop()
        expired = _total(_scraped(app, "app_tpu_expired_dropped_total{")) \
            - expired0
        missing = http_call(port, "POST", "/predict/nope", {})
        # 8 inputs against bert.embed on the same weights in float32
        f32 = _f32_tree(prog.params)
        mc = BERT_CONFIGS["bert-base"].with_(dtype="float32")
        with torch.inference_mode():
            ref = [bert.embed(f32, mc, torch.tensor([x], device="cuda"))[0]
                   .cpu().numpy() for x in inputs[:8]]
        del f32
    finally:
        app.stop()
    statuses = [r["status"] for r in burst + multi]
    require(statuses == [200] * len(statuses), f"statuses {statuses}")
    got = [np.asarray(d["embedding"], np.float32) for r in burst + multi
           for d in r["body"]["data"]["data"]]
    require(len(got) == len(inputs),
            f"{len(got)} embeddings for {len(inputs)} inputs")
    lat = sorted(1e3 * (r["t_end"] - r["t_send"]) for r in burst)
    norms = max(abs(float(np.linalg.norm(v)) - 1.0) for v in got)
    solo_l2 = max(float(np.linalg.norm(a - b)) for a, b in zip(got, solo))
    f32_l2 = max(float(np.linalg.norm(a - b)) for a, b in zip(got, ref))
    print(f"[predict] bert-base: {PREDICT_CLIENTS} clients at once, one "
          f"input of {PREDICT_LENS[0]}-{PREDICT_LENS[1]} tokens each, in "
          f"{burst_s:.3f} s ({PREDICT_CLIENTS / burst_s:.1f} items/s); "
          f"latency at the client p50 {np.percentile(lat, 50):.1f} ms p99 "
          f"{np.percentile(lat, 99):.1f} ms max {lat[-1]:.1f} ms; "
          f"{burst_dispatches} dispatches, batch sizes {burst_sizes}; then "
          f"{PREDICT_MULTI[0]} requests of {PREDICT_MULTI[1]} inputs in "
          f"{multi_s:.3f} s ({len(multi_sizes)} dispatches, sizes "
          f"{multi_sizes}); {fill}; {wait}; card: "
          f"{card}", flush=True)
    print(f"[predict] bert-base checks: |norm - 1| max {norms:.2e}; "
          f"against the same input alone (one dispatch each) L2 max "
          f"{solo_l2:.3e} (tolerance {EMBED_SOLO_L2}); 8 against bert.embed "
          f"in float32 on the card L2 max {f32_l2:.3e} (tolerance "
          f"{EMBED_F32_L2}); X-Request-Timeout 1ms behind a held batch: "
          f"{timed_out['status']} {timed_out.get('body')}, expired counted "
          f"{expired}; unknown program: {missing['status']} "
          f"{missing.get('body')}", flush=True)
    require(norms < 1e-3, f"an embedding off unit norm by {norms}")
    require(solo_l2 <= EMBED_SOLO_L2, f"coalesced against solo: {solo_l2}")
    require(f32_l2 <= EMBED_F32_L2, f"bf16 against float32: {f32_l2}")
    require(burst_dispatches < PREDICT_CLIENTS and max(burst_sizes) > 1,
            f"the burst did not coalesce: {burst_sizes}")
    require(all(r["status"] == 200 for r in full)
            and timed_out["status"] == 504
            and "deadline" in json.dumps(timed_out["body"]).lower()
            and expired == 1 and tuple(doomed) not in executed,
            f"the 1 ms budget: {timed_out['status']}, expired {expired}")
    require(missing["status"] == 404
            and "nope" in missing["body"]["error"]["message"],
            f"unknown program: {missing}")

    app = App(MapConfig(PREDICT_SHED_ROWS))
    install_embeddings(app)
    app.run(block=False)
    try:
        sheds0 = _total(_scraped(app, "app_tpu_shed_total{"))
        with chaos.scope(chaos.ChaosSchedule(seed=2).on(
                chaos.BATCHER_DISPATCH, latency=PREDICT_HOLD_S)):
            shed = _threads([lambda x=x: http_call(
                app.http_port, "POST", "/v1/embeddings", {"input": x})
                for x in singles[:PREDICT_SHED_CLIENTS]])
        counted = _total(_scraped(app, "app_tpu_shed_total{")) - sheds0
        gate_sheds = app.container.tpu._gates["embed"].sheds
    finally:
        app.stop()
    n429 = sum(r["status"] == 429 for r in shed)
    after = sorted({r["headers"].get("Retry-After") for r in shed
                    if r["status"] == 429})
    print(f"[predict] {PREDICT_SHED_CLIENTS} clients against "
          f"TPU_MAX_QUEUE_DEPTH=4, each dispatch held {PREDICT_HOLD_S} s: "
          f"{n429} answered 429 (Retry-After {after}), the gate's sheds "
          f"{gate_sheds}, app_tpu_shed_total {counted}, the rest "
          f"{sorted(r['status'] for r in shed if r['status'] != 429)}",
          flush=True)
    require(all(r["status"] in (200, 429) for r in shed),
            f"shed statuses {sorted({r['status'] for r in shed})}")
    require(n429 >= 1 and n429 == gate_sheds == counted,
            f"429s {n429}, the gate's sheds {gate_sheds}, counted {counted}")
    require(all(int(r["headers"].get("Retry-After", 0)) >= 1
                for r in shed if r["status"] == 429),
            "a 429 without Retry-After")


def predict_vit(card: str, rng) -> None:
    """ViT-L/14 ``classify``: 16 images through predict_batch and as 16
    concurrent predicts; 4 rows against float32 on the card."""
    import numpy as np
    import torch

    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.models import VIT_CONFIGS, vit
    from gofr_tpu_torch.tpu import new_engine_from_config

    t0 = time.monotonic()
    eng = new_engine_from_config(MapConfig(PREDICT_VIT_ROWS), device="cuda")
    prog = eng._programs["classify"]
    try:
        images = [rng.normal(size=(224, 224, 3)).astype(np.float32)
                  for _ in range(PREDICT_IMAGES)]
        eng.predict_batch("classify", images[:1])   # first-call set-up
        t_b = time.monotonic()
        batch = eng.predict_batch("classify", images)
        batch_s = time.monotonic() - t_b
        d0 = prog.dispatches
        t_c = time.monotonic()
        conc = _threads([lambda x=x: eng.predict("classify", x)
                         for x in images])
        conc_s = time.monotonic() - t_c
        dispatches = prog.dispatches - d0
        mc = VIT_CONFIGS["vit-l-14"].with_(dtype="float32")
        f32 = _f32_tree(prog.params)
        with torch.inference_mode():
            ref = torch.log_softmax(vit.forward(
                f32, mc, torch.from_numpy(np.stack(images[:4])).cuda()),
                dim=-1).cpu().numpy()
        del f32
    finally:
        eng.close()
    require(all(p.shape == (1000,) and np.isfinite(p).all() and
                (p > 0).all() for p in batch + conc),
            "a probability row of another shape, or not positive")
    sums = max(abs(float(p.sum()) - 1.0) for p in batch + conc)
    logp = [np.log(p) for p in batch]
    conc_d = max(float(np.abs(np.log(c) - b).max())
                 for c, b in zip(conc, logp))
    f32_d = max(float(np.abs(a - b).max()) for a, b in zip(logp, ref))
    print(f"[predict] vit-l-14 classify: engine ready in {t_b - t0:.1f} s; "
          f"predict_batch of {PREDICT_IMAGES} in {batch_s:.3f} s, "
          f"{PREDICT_IMAGES} concurrent predicts in {conc_s:.3f} s "
          f"({dispatches} dispatches); |sum - 1| max {sums:.2e}; concurrent "
          f"against predict_batch: log-prob max diff {conc_d:.3e} "
          f"(tolerance {VIT_SOLO_LOGP}); 4 against float32 on the card: "
          f"log-prob max diff {f32_d:.3e} (tolerance {VIT_F32_LOGP}); "
          f"card: {card}", flush=True)
    require(sums < 1e-3, f"a probability row sums off 1 by {sums}")
    require(conc_d <= VIT_SOLO_LOGP,
            f"concurrent against predict_batch: {conc_d}")
    require(f32_d <= VIT_F32_LOGP, f"bf16 against float32: {f32_d}")


def predict_score(card: str, rng) -> dict:
    """Llama-3-8B ``score`` through K1 on phase paged's engine rows and
    seed-0 weights: 16 concurrent score requests while 8 greedy streams
    decode; K1 = 32 a score dispatch and a bucket admission, each row
    equal to its prompt scored alone and, at [8, 512], to the plain
    attention, the argmax equal to the stream's first token, and the
    streams equal to the same prompts served with no score traffic.
    Returns the launch counts of that run."""
    import numpy as np
    import torch

    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.models import LLAMA_CONFIGS, llama
    from gofr_tpu_torch.ops import flash, flash_decode, paged_attention
    from gofr_tpu_torch.tpu import new_engine_from_config

    t0 = time.monotonic()
    mc = LLAMA_CONFIGS["llama3-8b"]
    params = llama.init(mc, 0, device="cuda")   # phase paged's weights
    eng = new_engine_from_config(MapConfig(PREDICT_SCORE_ROWS),
                                 device="cuda", params=params)
    gen = eng.generator
    prog = eng._programs["score"]
    torch.cuda.synchronize()
    print(f"[predict] llama3-8b paged engine with its score program ready "
          f"in {time.monotonic() - t0:.1f} s", flush=True)
    prompts = [rng.integers(0, mc.vocab_size, n).tolist() for n in
               rng.integers(PREDICT_SCORE_LENS[0], PREDICT_SCORE_LENS[1] + 1,
                            PREDICT_SCORES)]
    new_tokens = PAGED_NEW_TOKENS
    try:
        eng.predict("score", np.asarray(prompts[0], np.int32))  # set-up
        ref, _, _ = _serve(eng, prompts[:PREDICT_STREAMS], {}, new_tokens)
        for mod in (flash, flash_decode, paged_attention):
            mod.reset_counts()
        d0, adm0 = prog.dispatches, gen.admissions
        t_s = time.monotonic()
        streams = [eng.generate(p, max_new_tokens=new_tokens)
                   for p in prompts[:PREDICT_STREAMS]]
        scores = _threads([lambda x=x: eng.predict(
            "score", np.asarray(x, np.int32)) for x in prompts])
        score_s = time.monotonic() - t_s
        outs = [s.tokens() for s in streams]
        counts = {"flash_prefill": flash.launches,
                  "prefill_plain": flash.plain_calls,
                  "paged_decode": paged_attention.launches,
                  "flash_decode": flash_decode.launches}
        dispatches = prog.dispatches - d0
        admissions = gen.admissions - adm0
        solo = [eng.predict("score", np.asarray(x, np.int32))
                for x in prompts]
        # K1 against the plain attention at [8, 512], ragged, on the card
        tokens = torch.zeros((8, 512), dtype=torch.int32, device="cuda")
        for i, x in enumerate(prompts[:8]):
            tokens[i, :len(x)] = torch.tensor(x, device="cuda")
        lengths = torch.tensor([len(x) for x in prompts[:8]],
                               dtype=torch.int32, device="cuda")
        rope = llama.get_rope_tables(mc, 512, "cuda")
        with torch.inference_mode():
            via_k1 = llama.score(params, mc, tokens, lengths, rope,
                                 flash=True)
            via_plain = llama.score(params, mc, tokens, lengths, rope,
                                    flash=False)
        k1_plain = (via_k1 - via_plain).abs().max().item()
    finally:
        eng.close()
    release_graphs(gen)
    del params
    solo_d = max(float(np.abs(a - b).max()) for a, b in zip(scores, solo))
    top2 = [np.sort(s)[-2:] for s in scores[:PREDICT_STREAMS]]
    checked = [(int(np.argmax(s)), o[0]) for s, t, o in
               zip(scores, top2, outs) if t[1] - t[0] > 2 * LOGIT_ATOL]
    print(f"[predict] llama3-8b score: {PREDICT_SCORES} requests of "
          f"{PREDICT_SCORE_LENS[0]}-{PREDICT_SCORE_LENS[1]} tokens beside "
          f"{PREDICT_STREAMS} greedy streams of {new_tokens} tokens in "
          f"{score_s:.3f} s: {dispatches} score dispatches, {admissions} "
          f"admissions, launches {counts}; against the same prompt scored "
          f"alone max |diff| {solo_d:.3e}, K1 against the plain attention "
          f"at [8, 512] max |diff| {k1_plain:.3e} (tolerance {LOGIT_ATOL}); "
          f"argmax = the stream's first token at {len(checked)} of "
          f"{PREDICT_STREAMS} rows (those with a top-2 gap over "
          f"{2 * LOGIT_ATOL}); card: {card}", flush=True)
    require(counts["flash_prefill"] == LAYERS * (dispatches + admissions)
            and dispatches > 0 and admissions == PREDICT_STREAMS
            and counts["prefill_plain"] == 0,
            f"flash_prefill launched {counts['flash_prefill']} times for "
            f"{dispatches} score dispatches and {admissions} admissions")
    require(all(s.shape == (mc.vocab_size,) and s.dtype == np.float32
                and np.isfinite(s).all() for s in scores),
            "a score row of another shape, or not finite")
    require(solo_d <= LOGIT_ATOL,
            f"score against the same prompt alone: {solo_d}")
    require(k1_plain <= LOGIT_ATOL,
            f"score through K1 against the plain attention: {k1_plain}")
    require(all(a == b for a, b in checked),
            f"score's argmax against the first greedy token: {checked}")
    require(outs == ref, "the greedy streams changed beside score traffic: "
            + str([_first_difference(a, b) for a, b in zip(outs, ref)]))
    return counts


def phase_predict(card: str) -> dict:
    """The predict path at full width and depth: BERT-base embed over
    HTTP, ViT-L/14 classify, Llama-3-8B score through K1 beside greedy
    streams. Returns the score run's launch counts."""
    import gc

    import numpy as np
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(PREDICT_SEED)
    predict_bert(card, rng)
    predict_vit(card, rng)
    gc.collect()
    torch.cuda.empty_cache()
    return predict_score(card, rng)


# -- phase grpc: Llama-3-8B tokens over the port's gRPC transport -------------

GRPC_ROWS = dict(MAIN_ROWS, HTTP_PORT="0", METRICS_PORT="0", GRPC_PORT="0",
                 LOG_LEVEL="WARN", APP_NAME="chip-smoke-grpc",
                 TPU_MAX_QUEUE_DEPTH="16", TPU_SLO_LATENCY_SLOTS="4",
                 TPU_SLO_THROUGHPUT_SHARE="0.25")
GRPC_SEED = 47
GRPC_CHANNELS = 4         # client connections of step 2
GRPC_PER_CHANNEL = 4      # Generate streams multiplexed on each
GRPC_LENS = (17, 500)     # step 2's prompts: each one a bucket admission
GRPC_NEW = 48
GRPC_SAMPLED = (5, 11)    # step 2's sampled requests (temperature 0.8, top-k 50)
GRPC_CHAT = (64, 16)      # Chat turn 1: prompt and new tokens
GRPC_CHAT_LONG = 1000     # Chat turn 2's new tokens, cancelled after one
GRPC_FREED_S = 2.0        # the cancelled turn's slot must be free by then
GRPC_BUSY_NEW = 200       # the 8 streams that keep every slot busy
GRPC_BUDGET_LEN = 1000    # the 50 ms budget's prompt: a lattice admission
GRPC_WAVE = 32            # throughput Generate RPCs at once
GRPC_WAVE_LATENCY = 4     # latency ones, 100 ms later
GRPC_WAVE_NEW = 40
GRPC_DRAIN_NEW = 160
GRPC_METHOD = "/llm.Generation/Generate"


def token_streaming_service(app) -> None:
    """``llm.Generation`` (Generate, Chat) and ``POST /generate`` as
    examples/tpu-token-streaming/main.py defines them, on the port."""
    from gofr_tpu_torch.grpcx import GRPCService, ServerStream

    llm = GRPCService("llm.Generation")

    def token_msg(item):
        if isinstance(item, tuple):
            return {"token": item[0], "logprob": item[1]}
        return {"token": item}

    @llm.server_stream("Generate")
    def generate_grpc(ctx, req):
        stream = ctx.tpu.generate(req["tokens"],
                                  max_new_tokens=req.get("max_new_tokens", 64),
                                  temperature=req.get("temperature", 0.0),
                                  top_k=req.get("top_k", 0),
                                  eos_id=req.get("eos_id"),
                                  logprobs=req.get("logprobs", False))
        return ServerStream(stream, token_msg)

    @llm.bidi_stream("Chat")
    def chat_grpc(ctx, requests):
        for req in requests:
            stream = ctx.tpu.generate(
                req["tokens"], max_new_tokens=req.get("max_new_tokens", 64),
                temperature=req.get("temperature", 0.0),
                top_k=req.get("top_k", 0), eos_id=req.get("eos_id"))
            try:
                for tok in stream:
                    yield {"token": tok}
            finally:
                stream.cancel()
            yield {"turn_done": True}

    app.register_grpc_service(llm)

    @app.post("/generate")
    def generate_http(ctx):
        body = ctx.bind()
        stream = ctx.tpu.generate(body["tokens"],
                                  max_new_tokens=body.get("max_new_tokens", 64),
                                  temperature=body.get("temperature", 0.0),
                                  top_k=body.get("top_k", 0))
        ctx.stream(stream.map(
            lambda t: (json.dumps({"token": t}) + "\n").encode()))
        return None


def grpc_channel(port: int):
    """A client connection whose finished calls' trailers are kept, in
    order, on ``ch.trailers`` (the client raises a call's status, not
    its trailers)."""
    from gofr_tpu_torch.grpcx import dial

    ch = dial(f"127.0.0.1:{port}")
    ch.trailers = []
    finish = ch._finish_call

    def keep(call):
        ch.trailers.append(dict(call.trailers))
        finish(call)

    ch._finish_call = keep
    return ch


def grpc_generate(port_or_channel, body: dict, metadata=None) -> dict:
    """One Generate: the tokens, the status, and the client's clock at
    the send, the first message and the end; on a connection of its own
    (given a port) also the trailers."""
    from gofr_tpu_torch.grpcx import GRPCError

    own = isinstance(port_or_channel, int)
    ch = grpc_channel(port_or_channel) if own else port_or_channel
    out = {"tokens": [], "code": 0, "message": "", "t_send": time.monotonic()}
    try:
        for m in ch.server_stream(GRPC_METHOD, body, metadata=metadata,
                                  timeout=APP_CALL_TIMEOUT_S):
            if not out["tokens"]:
                out["t_first"] = time.monotonic()
            out["tokens"].append(m["token"])
        out["t_end"] = time.monotonic()
    except GRPCError as e:
        out["code"], out["message"] = e.code, e.message
    finally:
        if own:
            end = time.monotonic() + 5
            while not ch.trailers and time.monotonic() < end:
                time.sleep(0.001)
            out["trailers"] = ch.trailers[-1] if ch.trailers else {}
            ch.close()
    return out


def grpc_server_threads() -> list[str]:
    import threading

    return sorted(t.name for t in threading.enumerate() if t.is_alive()
                  and t.name.startswith(("gofr-grpc", "grpc-stream")))


def phase_grpc(card: str) -> dict:
    """The system's headline route on the card: Llama-3-8B tokens
    streamed over the port's own HTTP/2 gRPC server, as
    examples/tpu-token-streaming/main.py serves them, from a
    ``gofr_tpu_torch.App`` whose Container builds the contiguous engine
    of phase 5's rows (K1 a bucket admission, K2 a decode step). Health;
    16 Generate RPCs on 4 connections, each equal to the same request
    sent to the engine directly; the HTTP route through GenStream.map;
    a Chat turn, a cancelled one and a fresh call; a grpc-timeout that
    runs out in the queue; a throughput wave shed as RESOURCE_EXHAUSTED
    with retry-after; a drain with live streams. Returns the launch
    counts of the phase."""
    import gc
    import threading

    import numpy as np
    import torch

    from gofr_tpu_torch import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.grpcx import (DEADLINE_EXCEEDED, OK,
                                      RESOURCE_EXHAUSTED, UNAVAILABLE)
    from gofr_tpu_torch.grpcx import server as grpc_server
    from gofr_tpu_torch.ops import flash, flash_decode, paged_attention
    from gofr_tpu_torch.resilience import SLO_LATENCY, SLO_THROUGHPUT
    from gofr_tpu_torch.tracing import InMemoryExporter

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    app = App(MapConfig(GRPC_ROWS))
    tpu = app.container.tpu
    gen = tpu.generator
    torch.cuda.synchronize()
    spans = InMemoryExporter()   # the first-send spans (grpc.handoff, ...)
    app.container.tracer.exporter = spans
    token_streaming_service(app)
    # each RPC's push sender, to count the streams served on the
    # producing thread against those the worker finished
    senders = []

    class CountedSender(grpc_server._PushSender):
        def __init__(self, *args):
            super().__init__(*args)
            senders.append(self)

    grpc_server._PushSender = CountedSender
    app.run(block=False)
    port = app.grpc_port
    print(f"[grpc] App with the llama3-8b contiguous engine on {gen.device} "
          f"ready in {time.monotonic() - t0:.1f} s, gRPC port {port}, HTTP "
          f"port {app.http_port}", flush=True)
    streams, calls, lock = {}, [], threading.Lock()
    generate = tpu.generate

    def tracked(prompt, *args, **kw):
        try:
            s = generate(prompt, *args, **kw)
        except Exception:
            with lock:
                calls.append(None)
            raise
        with lock:
            streams.setdefault(tuple(prompt), s)
            calls.append(s)
        return s

    tpu.generate = tracked
    rng = np.random.default_rng(GRPC_SEED)
    vocab = gen.cfg.vocab_size

    def prompts(n, lens):
        return [rng.integers(0, vocab, k).tolist()
                for k in rng.integers(lens[0], lens[1] + 1, n)]

    def trace_of(i):
        return f"{i + 1:032x}"

    try:
        require(gen.device.type == "cuda", f"the engine runs on {gen.device}")
        ch = grpc_channel(port)
        health = ch.unary("/grpc.health.v1.Health/Check", {}, timeout=10.0)
        warm = grpc_generate(ch, {"tokens": prompts(1, (32, 32))[0],
                                  "max_new_tokens": 4})
        ch.close()
        require(health == {"status": "SERVING"} and warm["code"] == OK
                and len(warm["tokens"]) == 4,
                f"health {health}, warm-up {warm['code']}")
        # step 2: 16 Generate RPCs at once, 4 on each of 4 connections
        n = GRPC_CHANNELS * GRPC_PER_CHANNEL
        step2 = prompts(n, GRPC_LENS)
        bodies = [{"tokens": p, "max_new_tokens": GRPC_NEW,
                   **({"temperature": 0.8, "top_k": 50}
                      if i in GRPC_SAMPLED else {})}
                  for i, p in enumerate(step2)]
        for mod in (flash, flash_decode, paged_attention):
            mod.reset_counts()
        adm0, steps0, n0 = gen.admissions, gen.decode_steps, len(calls)
        chans = [grpc_channel(port) for _ in range(GRPC_CHANNELS)]
        del senders[:]
        spans.spans.clear()
        t_burst = time.monotonic()
        got = _threads([lambda i=i: grpc_generate(
            chans[i % GRPC_CHANNELS], bodies[i],
            {"traceparent": f"00-{trace_of(i)}-00f067aa0ba902b7-01"})
            for i in range(n)])
        wall = time.monotonic() - t_burst
        end = time.monotonic() + 5
        while (sum(len(c.trailers) for c in chans) < n
               and time.monotonic() < end):
            time.sleep(0.001)
        step2_trailers = [t for c in chans for t in c.trailers]
        for c in chans:
            c.close()
        downgraded = [s.downgraded for s in senders]
        first_spans = list(spans.spans)
        s2 = [streams[tuple(p)] for p in step2]
        direct, _, _ = _serve(tpu, step2,
                              {i: s2[i].seed for i in GRPC_SAMPLED},
                              GRPC_NEW)
        # step 3: the HTTP route of the same App, through GenStream.map
        http = http_call(app.http_port, "POST", "/generate",
                         {"tokens": step2[0], "max_new_tokens": GRPC_NEW})
        # step 4: Chat -- a turn, a cancelled turn, a fresh call
        chat_p = prompts(3, (GRPC_CHAT[0], GRPC_CHAT[0]))
        ch = grpc_channel(port)
        call = ch.bidi_stream("/llm.Generation/Chat",
                              timeout=APP_CALL_TIMEOUT_S)
        it = iter(call)
        call.send({"tokens": chat_p[0], "max_new_tokens": GRPC_CHAT[1]})
        turn1 = [next(it) for _ in range(GRPC_CHAT[1] + 1)]
        call.send({"tokens": chat_p[1], "max_new_tokens": GRPC_CHAT_LONG})
        turn2 = next(it)
        t_cancel = time.monotonic()
        call.cancel()
        while (gen.stats()["active"] and time.monotonic()
               < t_cancel + GRPC_FREED_S + 5):
            time.sleep(0.001)
        freed_s = time.monotonic() - t_cancel
        call3 = ch.bidi_stream("/llm.Generation/Chat",
                               timeout=APP_CALL_TIMEOUT_S)
        call3.send({"tokens": chat_p[2], "max_new_tokens": GRPC_CHAT[1]})
        call3.close_send()
        turn3 = list(call3)
        ch.close()
        # step 5: a 50 ms grpc-timeout behind 8 busy slots
        busy = [tpu.generate(p, max_new_tokens=GRPC_BUSY_NEW)
                for p in prompts(8, SLO_INTERACTIVE_LENS)]
        end = time.monotonic() + 60
        while gen.stats()["active"] < 8 and time.monotonic() < end:
            time.sleep(0.001)
        expired0 = dict(gen.stats()["expired"])
        budget = grpc_generate(
            port, {"tokens": rng.integers(0, vocab, GRPC_BUDGET_LEN).tolist(),
                   "max_new_tokens": GRPC_NEW},
            {"grpc-timeout": "50m"})
        busy_outs = [s.tokens() for s in busy]
        expired = {w: k - expired0[w]
                   for w, k in gen.stats()["expired"].items()}
        # step 6: a throughput wave, then latency RPCs 100 ms later
        sheds0 = dict(gen.gate.sheds_by_class)
        shed_total0 = _total(_scraped(app, "app_tpu_shed_total{"))
        wave = prompts(GRPC_WAVE + GRPC_WAVE_LATENCY, SLO_INTERACTIVE_LENS)
        box = {}

        def wave_rpc(i):
            meta = {"slo-class": "throughput"} if i < GRPC_WAVE else None
            box[i] = grpc_generate(port, {"tokens": wave[i],
                                          "max_new_tokens": GRPC_WAVE_NEW},
                                   meta)

        t_wave = time.monotonic()
        wave_threads = [threading.Thread(target=wave_rpc, args=(i,),
                                         daemon=True)
                        for i in range(GRPC_WAVE)]
        for t in wave_threads:
            t.start()
        time.sleep(max(0.0, t_wave + 0.1 - time.monotonic()))
        late = [threading.Thread(target=wave_rpc, args=(i,), daemon=True)
                for i in range(GRPC_WAVE, GRPC_WAVE + GRPC_WAVE_LATENCY)]
        for t in late:
            t.start()
        for t in wave_threads + late:
            t.join(APP_JOIN_S)
        require(len(box) == GRPC_WAVE + GRPC_WAVE_LATENCY,
                f"wave RPCs still waiting after {APP_JOIN_S} s")
        sheds = {c: k - sheds0[c] for c, k in gen.gate.sheds_by_class.items()}
        shed_total = _total(_scraped(app, "app_tpu_shed_total{")) \
            - shed_total0
        # step 7: stop(grace_s=30) with 8 live Generate streams
        drain_p = prompts(SLO_DRAIN, SLO_INTERACTIVE_LENS)
        drained = {}

        def drain_rpc(i):
            drained[i] = grpc_generate(port, {"tokens": drain_p[i],
                                              "max_new_tokens":
                                              GRPC_DRAIN_NEW})

        live = [threading.Thread(target=drain_rpc, args=(i,), daemon=True)
                for i in range(SLO_DRAIN)]
        for t in live:
            t.start()
        end = time.monotonic() + 60
        while gen.stats()["active"] < SLO_DRAIN and time.monotonic() < end:
            time.sleep(0.002)
        active = gen.stats()["active"]
        probe = grpc_channel(port)
        t_drain = time.monotonic()
        stopper = threading.Thread(target=lambda: app.stop(grace_s=30.0),
                                   daemon=True)
        stopper.start()
        while not gen.stats()["draining"] and time.monotonic() < end:
            time.sleep(0.001)
        health_draining = probe.unary("/grpc.health.v1.Health/Check", {},
                                      timeout=10.0)
        probe.close()
        refused = grpc_generate(port, {"tokens": drain_p[0],
                                       "max_new_tokens": 4})
        for t in live:
            t.join(APP_JOIN_S)
        stopper.join(60)
        drain_s = time.monotonic() - t_drain
        require(not stopper.is_alive(), "app.stop(grace_s=30) did not end")
        end = time.monotonic() + 5
        while grpc_server_threads() and time.monotonic() < end:
            time.sleep(0.01)
        left = grpc_server_threads()
        counts = {"flash_prefill": flash.launches,
                  "flash_decode": flash_decode.launches,
                  "paged_decode": paged_attention.launches,
                  "paged_window": paged_attention.window_launches,
                  "prefill_plain": flash.plain_calls,
                  "decode_plain": flash_decode.plain_calls,
                  "paged_plain": paged_attention.plain_calls}
        admissions = gen.admissions - adm0
        steps = gen.decode_steps - steps0
        bucket_admissions = sum(1 for s in calls[n0:] if s is not None
                                and "admit" in s.trace
                                and s.prompt_len <= gen.prompt_buckets[-1])
    finally:
        grpc_server._PushSender = CountedSender.__mro__[1]
        if app._running.is_set():
            app.stop()
    release_graphs(gen)

    # step 2's numbers, on one clock (time.monotonic) on both sides
    client_ttft = [1e3 * (r["t_first"] - r["t_send"]) for r in got
                   if r["tokens"]]
    engine_ttft = [1e3 * (s.trace["first_put"] - s.trace["submit"])
                   for s in s2]
    ingress = [1e3 * (s.trace["submit"] - r["t_send"])
               for s, r in zip(s2, got)]
    by_trace: dict = {}
    for sp in first_spans:
        by_trace.setdefault(sp.trace_id, {})[sp.name] = sp
    handoff = [1e-6 * (d["grpc.handoff"].end_ns - d["grpc.handoff"].start_ns)
               for d in by_trace.values() if "grpc.handoff" in d]
    to_wire = [1e-6 * (d["grpc.frame-write"].end_ns
                       - d["grpc.handoff"].start_ns)
               for d in by_trace.values()
               if "grpc.handoff" in d and "grpc.frame-write" in d]
    tokens = sum(len(r["tokens"]) for r in got)
    zero_handoff = downgraded.count(False)
    mism = [i for i in range(n) if got[i]["tokens"] != direct[i]]
    print(f"[grpc] {n} Generate RPCs on {GRPC_CHANNELS} connections "
          f"({len(GRPC_SAMPLED)} sampled), prompts of {GRPC_LENS[0]}-"
          f"{GRPC_LENS[1]} tokens, {GRPC_NEW} new each, in {wall:.3f} s: "
          f"{tokens} tokens, {tokens / wall:.1f} tok/s at the clients; TTFT "
          f"at the client {stats_line(client_ttft)}, at the engine "
          f"{stats_line(engine_ttft)}; client send to engine submit "
          f"{stats_line(ingress)}; first_put to the transport (grpc.handoff) "
          f"{stats_line(handoff)}, first_put to the first message on the "
          f"wire {stats_line(to_wire)}; push senders {len(downgraded)}: "
          f"{zero_handoff} served on the producing thread, "
          f"{len(downgraded) - zero_handoff} downgraded to the worker; equal to "
          f"the engine called directly: {n - len(mism)} of {n}; card: {card}",
          flush=True)
    http_toks = [ln.get("token") for ln in http.get("lines", [])]
    print(f"[grpc] POST /generate through GenStream.map: {http['status']}, "
          f"{len(http_toks)} lines, equal to the gRPC stream: "
          f"{http_toks == got[0]['tokens']}; Chat: turn 1 {len(turn1) - 1} "
          f"tokens then {turn1[-1]}, turn 2 cancelled after {turn2}, slot "
          f"free {1e3 * freed_s:.1f} ms after the cancel, a fresh call "
          f"{len(turn3) - 1} tokens then {turn3[-1]}", flush=True)
    shed_codes = {c: sum(1 for i, r in box.items()
                         if r["code"] == RESOURCE_EXHAUSTED
                         and (i < GRPC_WAVE) == (c == SLO_THROUGHPUT))
                  for c in (SLO_LATENCY, SLO_THROUGHPUT)}
    shed_trailers = [r["trailers"] for r in box.values()
                     if r["code"] == RESOURCE_EXHAUSTED]
    wave_served = [r for r in box.values() if r["code"] == OK]
    print(f"[grpc] grpc-timeout 50m behind 8 busy slots: status "
          f"{budget['code']} {budget['message']!r}, trailers "
          f"{budget['trailers']}, expiries by where {expired}; wave of "
          f"{GRPC_WAVE} throughput and {GRPC_WAVE_LATENCY} latency RPCs: "
          f"RESOURCE_EXHAUSTED by class {shed_codes}, the gate's sheds "
          f"{sheds}, app_tpu_shed_total {shed_total}, retry-after "
          f"{sorted({t.get('retry-after') for t in shed_trailers})}, "
          f"{len(wave_served)} served", flush=True)
    drain_outs = [(drained[i]["code"], len(drained[i]["tokens"]))
                  for i in range(SLO_DRAIN)]
    print(f"[grpc] stop(grace_s=30) with {active} live streams of "
          f"{GRPC_DRAIN_NEW} tokens: {drain_s:.3f} s; health while draining "
          f"{health_draining}; a new Generate {refused['code']} "
          f"retry-after {refused['trailers'].get('retry-after')}; streams "
          f"{drain_outs}; server threads after the stop {left}", flush=True)
    print(f"[grpc] {admissions} admissions ({bucket_admissions} bucket), "
          f"{steps} decode steps; launches {counts}; card: {card}",
          flush=True)
    require(all(r["code"] == OK and len(r["tokens"]) == GRPC_NEW
                for r in got)
            and len(step2_trailers) == n
            and all(t.get("grpc-status") == "0" for t in step2_trailers),
            f"step 2: {[(r['code'], len(r['tokens'])) for r in got]}, "
            f"trailers {step2_trailers}")
    require(not mism, f"gRPC streams differ from the engine called "
                      f"directly at {mism}: " + str(
                          [_first_difference(got[i]["tokens"], direct[i])
                           for i in mism]))
    require(all(s.trace_id == trace_of(i) for i, s in enumerate(s2)),
            "a traceparent did not reach its stream")
    require(len(downgraded) == n and len(handoff) == n and len(to_wire) == n,
            f"{len(downgraded)} push senders, {len(handoff)} handoff spans, "
            f"{len(to_wire)} first writes for {n} streams")
    require(http["status"] == 200 and http_toks == got[0]["tokens"],
            f"POST /generate: {http['status']}, {http_toks}")
    require(len(turn1) == GRPC_CHAT[1] + 1 and turn1[-1] == {"turn_done": True}
            and all("token" in m for m in turn1[:-1]) and "token" in turn2
            and freed_s <= GRPC_FREED_S
            and len(turn3) == GRPC_CHAT[1] + 1
            and turn3[-1] == {"turn_done": True},
            f"Chat: {turn1}, {turn2}, freed in {freed_s:.3f} s, {turn3}")
    require(budget["code"] == DEADLINE_EXCEEDED
            and budget["trailers"].get("grpc-status") == "4"
            and sum(expired.values()) == 1
            and all(len(o) == GRPC_BUSY_NEW for o in busy_outs),
            f"the 50 ms grpc-timeout: {budget['code']} {budget['message']}, "
            f"expiries {expired}")
    require(shed_codes[SLO_THROUGHPUT] >= 1 and shed_codes[SLO_LATENCY] == 0
            and shed_codes == sheds
            and shed_total == sum(sheds.values())
            and all(int(t.get("retry-after", 0)) >= 1
                    and t.get("grpc-status") == "8" for t in shed_trailers)
            and all(r["code"] in (OK, RESOURCE_EXHAUSTED)
                    for r in box.values())
            and all(len(r["tokens"]) == GRPC_WAVE_NEW for r in wave_served),
            f"the wave: RESOURCE_EXHAUSTED {shed_codes}, sheds {sheds}, "
            f"app_tpu_shed_total {shed_total}, trailers {shed_trailers}")
    require(active == SLO_DRAIN
            and health_draining == {"status": "NOT_SERVING"}
            and refused["code"] == UNAVAILABLE
            and refused["trailers"].get("retry-after") == "30"
            and drain_outs == [(OK, GRPC_DRAIN_NEW)] * SLO_DRAIN
            and not left,
            f"drain: {active} live, health {health_draining}, new RPC "
            f"{refused['code']} {refused['trailers']}, streams {drain_outs}, "
            f"threads {left}")
    require(counts["flash_prefill"] == LAYERS * bucket_admissions
            and bucket_admissions == admissions and admissions > 0,
            f"flash_prefill launched {counts['flash_prefill']} times for "
            f"{bucket_admissions} bucket admissions of {admissions}")
    require(counts["flash_decode"] == LAYERS * steps and steps > 0,
            f"flash_decode launched {counts['flash_decode']} times for "
            f"{steps} decode steps of {LAYERS} layers")
    others = {k: counts[k] for k in ("paged_decode", "paged_window",
                                     "prefill_plain", "decode_plain",
                                     "paged_plain")}
    require(not any(others.values()),
            f"other attention paths ran on the gRPC path: {others}")
    return {k: counts[k] for k in ("flash_prefill", "flash_decode")}


# TPU_KVCACHE_REDIS_TIMEOUT_S: the shared tier here is an in-process
# Python server, which takes about 0.3 s to take in a prompt's 70 MB of
# frames; at the default 0.25 s the tier's fail-open path would skip
# most writes
TIERS_ROWS = dict(MAIN_ROWS, HTTP_PORT="0", METRICS_PORT="0", GRPC_PORT="0",
                  LOG_LEVEL="WARN", APP_NAME="chip-smoke-tiers",
                  TPU_PREFIX_CACHE="2", TPU_PREFIX_MIN="1072",
                  TPU_KVCACHE_HOST_MB="1024", TPU_KVCACHE_REDIS="true",
                  TPU_KVCACHE_REDIS_TIMEOUT_S="10")
# the reference: the same model and rows without the tiers
TIERS_REF_ROWS = {k: v for k, v in TIERS_ROWS.items()
                  if not k.startswith(("TPU_PREFIX", "TPU_KVCACHE"))}
TIERS_SEED = 53
TIERS_SYSTEMS = 6          # system prompts: one request each a round
TIERS_SYSTEM_LEN = 1024
TIERS_TURN1 = (48, 200)    # round 1's user turns: stored (past PREFIX_MIN)
TIERS_TURN2 = (16, 32)     # round 2's follow-up turns: not stored
TIERS_NEW = 32
TIERS_BURST = 8
TIERS_BURST_LENS = (64, 400)   # bucket admissions (K1)
TIERS_HUGE = 10 << 30          # a lease no reclaim can cover
TIERS_SEAM_EVERY = 3           # the burst admission the HBM_ALLOC seam kills
TIERS_COPY_REPS = 20
TIERS_LIVE_NEW = 1000          # a live stream decoding through round 1


def _tiers_instrument(app, timers: dict) -> dict:
    """Wrap one App's engine to record, per request, its stream and what
    its restore moved, and to time the tier paths on the host clock:
    spills (a T0 row to host RAM), promotions (a T1 or T2 snapshot into
    a pool row, spill of the displaced row included), T2 fetches (MGET,
    checksum and decode of the frames), T2 writes (encode and the SET
    pipeline; the row's copy to the host before it is the caller's) and
    uploads (staging and queueing the host-to-device copies)."""
    from gofr_tpu_torch.tpu.generator import GenerationEngine

    tpu = app.container.tpu
    gen = tpu.generator
    state = {"streams": [], "upload": None, "load": None}
    generate = tpu.generate

    def tracked(prompt, *args, **kw):
        s = generate(prompt, *args, **kw)
        state["streams"].append(s)
        return s

    tpu.generate = tracked
    if gen._kvc is None:
        return state

    def timed(name, fn, when=lambda *a: True):
        def run(*args):
            if not when(*args):
                return fn(*args)
            t = time.perf_counter()
            try:
                return fn(*args)
            finally:
                timers[name].append(1e3 * (time.perf_counter() - t))
        return run

    gen._offload_victim = timed("spill", gen._offload_victim,
                                lambda victim: victim is not None)
    promote = gen._promote_hostkv
    gen._promote_hostkv = lambda mt: timed(f"promote_{mt.tier}",
                                           promote)(mt)
    upload = timed("upload", gen._upload_row)

    def recorded_upload(kv, row):
        state["upload"] = (kv, row)
        return upload(kv, row)

    gen._upload_row = recorded_upload
    if gen._kvc.redis is not None:
        gen._kvc.redis.match = timed("t2_fetch", gen._kvc.redis.match)
        gen._kvc.store_shared = timed("t2_write", gen._kvc.store_shared)

    def recorded_copy(dst, dst_row, src, src_row, n):
        if dst is gen.cache:
            state["load"] = (dst_row, src_row, n)
        return GenerationEngine._pool_copy(gen, dst, dst_row, src, src_row,
                                           n)

    gen._pool_copy = recorded_copy
    return state


def _tiers_restored_equal(gen, state: dict, prompt_len: int):
    """Did the restore land exactly the stored bytes? A promotion: the
    pool row's int8 codes and scales against the host snapshot it was
    uploaded from; a load: the slot's positions up to its final chunk
    (which recomputes its own window) against the pool row. None when
    the request restored nothing. Run with the engine idle."""
    import torch

    from gofr_tpu_torch.tpu.generator import pad_bucket

    ok = []
    if state["upload"] is not None:
        kv, row = state["upload"]
        ok += [torch.equal(d[:, row, :kv.plen].cpu(), s)
               for d, s in zip(gen._planes(gen._pool), gen._planes(kv))]
    if state["load"] is not None:
        idx, row, n = state["load"]
        stop = min(n, prompt_len - pad_bucket(prompt_len - n,
                                              gen.prompt_buckets))
        ok += [torch.equal(d[:, idx, :stop], s[:, row, :stop])
               for d, s in zip(gen._planes(gen.cache),
                               gen._planes(gen._pool))]
    return all(ok) if ok else None


def _tiers_round(app, state: dict, prompts) -> list:
    """One round: each prompt a gRPC Generate of its own, one after
    another (a round's tiers depend on its order), greedy; per request
    the tokens, the status, the serving tier and restored positions, the
    engine's TTFT and the restored-bytes check."""
    gen = app.container.tpu.generator
    out = []
    for p in prompts:
        state["upload"] = state["load"] = None
        r = grpc_generate(app.grpc_port, {"tokens": p,
                                          "max_new_tokens": TIERS_NEW})
        s = state["streams"][-1]
        same = None
        if state["upload"] is not None or state["load"] is not None:
            with quiet_device(gen):
                same = _tiers_restored_equal(gen, state, len(p))
        out.append({"tokens": r["tokens"], "code": r["code"],
                    "tier": s.cache_tier, "cached": s.cache_tokens,
                    "ttft": 1e3 * (s.trace["first_put"] - s.trace["submit"]),
                    "client_ttft": 1e3 * (r["t_first"] - r["t_send"])
                    if r["tokens"] else None,
                    "restored_equal": same})
    return out


def _tiers_app(rows: dict, timers: dict):
    """A gofr_tpu_torch.App from ``rows`` with the token-streaming
    service, running; (app, its state, build seconds, the bytes the
    arbiter was declared over the construction, the growth of
    torch.cuda.memory_allocated over it)."""
    import gc

    import torch

    from gofr_tpu_torch import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.tpu import hbm

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    decl0 = sum(hbm.live_bytes().values())
    t0 = time.monotonic()
    app = App(MapConfig(rows))
    token_streaming_service(app)
    app.run(block=False)
    torch.cuda.synchronize()
    built = time.monotonic() - t0
    state = _tiers_instrument(app, timers)
    return (app, state, built, sum(hbm.live_bytes().values()) - decl0,
            torch.cuda.memory_allocated() - alloc0)


def _tiers_close(app) -> None:
    gen = app.container.tpu.generator
    if app._running.is_set():
        app.stop()
    release_graphs(gen)


def _launches() -> dict:
    from gofr_tpu_torch.ops import flash, flash_decode, paged_attention

    return {"flash_prefill": flash.launches,
            "flash_decode": flash_decode.launches,
            "paged_decode": paged_attention.launches,
            "paged_window": paged_attention.window_launches,
            "prefill_plain": flash.plain_calls,
            "decode_plain": flash_decode.plain_calls,
            "paged_plain": paged_attention.plain_calls}


def _reset_launches() -> None:
    from gofr_tpu_torch.ops import flash, flash_decode, paged_attention

    for mod in (flash, flash_decode, paged_attention):
        mod.reset_counts()


def _tiers_burst(app, prompts, metadata=None) -> list:
    return _threads([lambda p=p: grpc_generate(
        app.grpc_port, {"tokens": p, "max_new_tokens": TIERS_NEW}, metadata)
        for p in prompts])


def phase_tiers(card: str) -> dict:
    """Prefix reuse through the tiers on the headline route: services
    that put one of a few system prompts before every request, over
    gRPC, and a replica that restarts and warms from Redis. A
    ``gofr_tpu_torch.App`` builds phase 5's contiguous Llama-3-8B engine
    with TPU_PREFIX_CACHE=2 (T0: two pool rows), TPU_KVCACHE_HOST_MB=1024
    (T1) and TPU_KVCACHE_REDIS=true (T2, on the port's FakeRedisServer
    on localhost). TPU_PREFIX_MIN=1072 stores a system prompt with its
    first, longer turn (48-200 tokens) and not each short follow-up
    (16-32 tokens), so a follow-up does not evict another system
    prompt's row. Round 1: six system prompts of 1024 tokens with their
    first turns, misses that fill T0, spill 4 rows to T1 and write all 6
    through to T2. Round 2: the same systems with follow-up turns, the
    two in T0 first: 2 T0 hits, then 4 T1 hits (promotions). Round 3: a
    fresh App (a new replica, T0 and T1 empty) takes round 2's requests:
    6 T2 hits. Every hit restores the same bytes, the system prompt's
    1024 positions as round 1 stored them, and runs one final chunk
    over the turn, so a request's greedy stream is the same from T0, T1
    and T2, and the restored int8 codes and scales equal the stored
    ones. An App without tiers (the reference, built last) serves the
    same requests: its misses must equal round 1's; against the hits it
    is printed (a hit reads the positions round 1's final chunk
    recomputed, the reference its own mid chunk's). Then the arbiter on the fresh
    replica: a budget of its in-use bytes plus half a T0 row and a
    one-row lease at PRI_SCRATCH shrink T0 by a row (spilling to T1);
    a 10 GiB lease sheds with HBMExhausted and a burst of 8 is served;
    with the budget back, the seeded HBM_ALLOC seam sheds exactly one of
    a burst of 8 as RESOURCE_EXHAUSTED with retry-after. Returns the
    phase's launch counts (rounds and bursts; the reference not)."""
    import gc
    import threading

    import numpy as np
    import torch

    from gofr_tpu_torch import chaos
    from gofr_tpu_torch.grpcx import OK, RESOURCE_EXHAUSTED
    from gofr_tpu_torch.testutil.redisfake import FakeRedisServer
    from gofr_tpu_torch.tpu import hbm
    from gofr_tpu_torch.tpu.generator import GenerationEngine

    gc.collect()
    torch.cuda.empty_cache()
    redis = FakeRedisServer()
    rows = dict(TIERS_ROWS, REDIS_HOST=redis.host, REDIS_PORT=str(redis.port))
    timers = {k: [] for k in ("spill", "promote_t1", "promote_t2",
                              "t2_fetch", "t2_write", "upload")}
    apps = []
    try:
        app, state, built, declared, grown = _tiers_app(rows, timers)
        apps.append(app)
        gen = app.container.tpu.generator
        require(gen.device.type == "cuda" and gen._kvc is not None
                and gen._kvc.redis is not None,
                f"the tiers engine: {gen.device}, {gen.kvcache_stats()}")
        builds = [("tiers", built, declared, grown)]
        rng = np.random.default_rng(TIERS_SEED)
        vocab = gen.cfg.vocab_size
        systems = [rng.integers(0, vocab, TIERS_SYSTEM_LEN).tolist()
                   for _ in range(TIERS_SYSTEMS)]
        turns1 = [rng.integers(0, vocab, k).tolist() for k in
                  rng.integers(TIERS_TURN1[0], TIERS_TURN1[1] + 1,
                               TIERS_SYSTEMS)]
        turns2 = [rng.integers(0, vocab, k).tolist() for k in
                  rng.integers(TIERS_TURN2[0], TIERS_TURN2[1] + 1,
                               TIERS_SYSTEMS)]
        for t1, t2 in zip(turns1, turns2):
            t2[0] = (t1[0] + 1) % vocab   # a follow-up parts at its first token
        round1 = [s + t for s, t in zip(systems, turns1)]
        # T0 holds the last two systems after round 1: ask for them first
        order = [4, 5, 0, 1, 2, 3]
        round2 = [systems[i] + turns2[i] for i in order]
        # the launches are counted while each App serves (a construction
        # runs every graph's function once before capturing it)
        _reset_launches()
        steps = [gen.decode_steps]
        # a live stream decodes through round 1: what the stores (spill,
        # write-through), run on the serving loop's thread before a
        # miss's first token, cost a stream already delivering
        live_p = rng.integers(0, vocab, 64).tolist()
        live_times = []

        def live_stream():
            ch = grpc_channel(app.grpc_port)
            try:
                for _ in ch.server_stream(
                        GRPC_METHOD, {"tokens": live_p,
                                      "max_new_tokens": TIERS_LIVE_NEW},
                        timeout=APP_CALL_TIMEOUT_S):
                    live_times.append(time.monotonic())
            finally:
                ch.close()

        live = threading.Thread(target=live_stream, daemon=True)
        live.start()
        end = time.monotonic() + 60
        while len(live_times) < 8 and time.monotonic() < end:
            time.sleep(0.001)
        t_round1 = time.monotonic()
        r1 = _tiers_round(app, state, round1)
        t_round1 = (t_round1, time.monotonic())
        live.join(APP_JOIN_S)
        require(not live.is_alive() and len(live_times) == TIERS_LIVE_NEW,
                f"the live stream: {len(live_times)} tokens")
        st1 = gen.kvcache_stats()
        r2 = _tiers_round(app, state, round2)
        st2 = gen.kvcache_stats()
        # round 3: a fresh replica warms from Redis
        steps[0] = gen.decode_steps - steps[0]
        streams = state["streams"]
        counts = _launches()
        _tiers_close(app)
        del gen, app
        app, state, built, declared, grown = _tiers_app(rows, timers)
        apps.append(app)
        builds.append(("fresh replica", built, declared, grown))
        gen = app.container.tpu.generator
        steps.append(gen.decode_steps)
        _reset_launches()
        r3 = _tiers_round(app, state, round2)
        st3 = gen.kvcache_stats()
        # the pool-row copy on the card: T0 row 0 into idle slot 0, the
        # system prompt's 1024 positions (CUDA events)
        kvc = gen._kvc
        row_bytes = hbm.tree_nbytes(gen._pool) // kvc.slots
        copy_bytes = 2 * sum(hbm.tree_nbytes(t[:, 0, :TIERS_SYSTEM_LEN])
                             for t in gen._planes(gen._pool))
        with quiet_device(gen):
            e0, e1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            GenerationEngine._pool_copy(gen, gen.cache, 0, gen._pool, 0,
                                        TIERS_SYSTEM_LEN)
            e0.record()
            for _ in range(TIERS_COPY_REPS):
                GenerationEngine._pool_copy(gen, gen.cache, 0, gen._pool, 0,
                                            TIERS_SYSTEM_LEN)
            e1.record()
            torch.cuda.synchronize()
        copy_ms = e0.elapsed_time(e1) / TIERS_COPY_REPS
        copy_bound = 1e3 * copy_bytes / HBM_BYTES_PER_S
        # the arbiter, part 1: one more T0 row's worth leased by another
        # subsystem under a budget of in-use + half a row
        budget0 = hbm.budget()
        slots0, spills0 = kvc.slots, kvc.host.spills
        in_use0 = hbm.arbiter_stats()["in_use_bytes"]
        hbm.set_budget(in_use0 + row_bytes // 2)
        owner = object()
        t0 = time.perf_counter()
        hbm.lease("smoke-subsystem", row_bytes, owner=owner, tag="row",
                  priority=hbm.PRI_SCRATCH)
        shrink_ms = 1e3 * (time.perf_counter() - t0)
        arb1 = hbm.arbiter_stats()
        part1 = (slots0, gen._kvc.slots, gen._kvc.host.spills - spills0,
                 hbm.tree_nbytes(gen._pool))
        # part 2: a lease no reclaim can cover sheds; serving goes on
        try:
            hbm.lease("smoke-huge", TIERS_HUGE, owner=owner, tag="huge")
            huge = None
        except hbm.HBMExhausted as e:
            huge = e
        burst_p = [rng.integers(0, vocab, k).tolist() for k in
                   rng.integers(TIERS_BURST_LENS[0],
                                TIERS_BURST_LENS[1] + 1, TIERS_BURST)]
        after_huge = _tiers_burst(app, burst_p)
        arb2 = hbm.arbiter_stats()
        hbm.release(owner=owner)
        hbm.set_budget(budget0)
        # part 3: the seeded HBM_ALLOC seam at one admission of a burst
        seam_p = [rng.integers(0, vocab, k).tolist() for k in
                  rng.integers(TIERS_BURST_LENS[0],
                               TIERS_BURST_LENS[1] + 1, TIERS_BURST)]
        sheds0 = dict(hbm.arbiter_stats()["sheds"])
        sched = chaos.ChaosSchedule(seed=TIERS_SEED).on(
            chaos.HBM_ALLOC, error=chaos.ResourceExhausted,
            every=TIERS_SEAM_EVERY, limit=1)
        with chaos.scope(sched):
            seamed = _tiers_burst(app, seam_p)
        arb3 = hbm.arbiter_stats()
        steps[1] = gen.decode_steps - steps[1]
        counts = {k: n + counts[k] for k, n in _launches().items()}
        admitted = [s for s in streams + state["streams"]
                    if "admit" in s.trace]
        bucket_admissions = sum(1 for s in admitted
                                if s.prompt_len <= gen.prompt_buckets[-1])
        t2_put = st1["tiers"]["t2"]["bytes_put"]
        _tiers_close(app)
        del gen, app, kvc
        # the reference: the same requests on an App without tiers
        app, state, built, declared, grown = _tiers_app(
            dict(TIERS_REF_ROWS), timers)
        apps.append(app)
        builds.append(("reference", built, declared, grown))
        ref1 = _tiers_round(app, state, round1)
        ref2 = _tiers_round(app, state, round2)
        _tiers_close(app)
    finally:
        for a in apps:
            if a._running.is_set():
                a.stop()
        redis.close()

    def ttfts(rows_, tier):
        return [r["ttft"] for r in rows_ if r["tier"] == tier]

    misses = [r["ttft"] for r in r1]
    # the live stream's gaps between deliveries (a block's K tokens
    # arrive together: gaps under 1 ms are within a block)
    gaps = [1e3 * (b - a) for a, b in zip(live_times, live_times[1:])
            if t_round1[0] <= a and b <= t_round1[1] and b - a > 1e-3]
    quiet = [1e3 * (b - a) for a, b in zip(live_times, live_times[1:])
             if (b < t_round1[0] or a > t_round1[1]) and b - a > 1e-3]
    for name, built, declared, grown in builds:
        print(f"[tiers] App ({name}) built in {built:.1f} s: the arbiter "
              f"was declared {declared} bytes ({declared / 2**20:.1f} MiB), "
              f"torch.cuda.memory_allocated grew {grown} bytes "
              f"({grown / 2**20:.1f} MiB), the gap (weights, rope tables, "
              f"graph pools) {grown - declared} bytes "
              f"({(grown - declared) / 2**30:.3f} GiB)", flush=True)
    print(f"[tiers] round 1 (misses) tiers {[r['tier'] for r in r1]}; round "
          f"2 tiers {[r['tier'] for r in r2]} restoring "
          f"{[r['cached'] for r in r2]}; round 3 (fresh replica) tiers "
          f"{[r['tier'] for r in r3]} restoring {[r['cached'] for r in r3]}",
          flush=True)
    print(f"[tiers] TTFT at the engine: misses {stats_line(misses)}; T0 hits "
          f"{stats_line(ttfts(r2, 't0'))}; T1 hits "
          f"{stats_line(ttfts(r2, 't1'))}; T2 hits "
          f"{stats_line(ttfts(r3, 't2'))}; at the client: misses "
          f"{stats_line([r['client_ttft'] for r in r1])}, T0 "
          f"{stats_line([r['client_ttft'] for r in r2 if r['tier'] == 't0'])}"
          f", T1 "
          f"{stats_line([r['client_ttft'] for r in r2 if r['tier'] == 't1'])}"
          f", T2 {stats_line([r['client_ttft'] for r in r3])}; card: {card}",
          flush=True)
    print(f"[tiers] a live stream through round 1 ({TIERS_LIVE_NEW} tokens): "
          f"its gaps between blocks while round 1's six misses were "
          f"admitted and stored {stats_line(gaps)}, "
          f"{sum(g > 100 for g in gaps)} over 100 ms; outside round 1 "
          f"{stats_line(quiet)}; card: {card}", flush=True)
    print(f"[tiers] pool-row copy of {TIERS_SYSTEM_LEN} positions (4 planes, "
          f"{copy_bytes} bytes moved): {copy_ms:.5f} ms of device time, bound "
          f"{copy_bound:.5f} ms (bytes); host time: spill "
          f"{stats_line(timers['spill'])}; T1 promotion (its spill "
          f"included) {stats_line(timers['promote_t1'])}; T2 fetch (MGET, "
          f"checksum, decode) {stats_line(timers['t2_fetch'])}, T2 promotion "
          f"{stats_line(timers['promote_t2'])}, upload (staging + queued "
          f"copies) {stats_line(timers['upload'])}; T2 write (encode, SET "
          f"pipeline) {stats_line(timers['t2_write'])}, bytes written in "
          f"round 1: {t2_put}; card: {card}", flush=True)
    print(f"[tiers] tier stats after round 1 {json.dumps(st1)}", flush=True)
    print(f"[tiers] tier stats after round 2 {json.dumps(st2)}", flush=True)
    print(f"[tiers] tier stats after round 3 {json.dumps(st3)}", flush=True)
    print(f"[tiers] arbiter part 1: budget in-use {in_use0} + half a row "
          f"({row_bytes} bytes), a one-row PRI_SCRATCH lease took "
          f"{shrink_ms:.1f} ms: T0 {part1[0]} -> {part1[1]} rows, "
          f"{part1[2]} rows spilled to T1, pool {part1[3]} bytes; "
          f"arbiter_stats {json.dumps(arb1)}", flush=True)
    print(f"[tiers] arbiter part 2: a {TIERS_HUGE >> 30} GiB lease: "
          f"{type(huge).__name__} {huge} (status "
          f"{getattr(huge, 'status_code', None)}, Retry-After "
          f"{getattr(huge, 'headers', {}).get('Retry-After')}); then "
          f"{TIERS_BURST} requests: "
          f"{[(r['code'], len(r['tokens'])) for r in after_huge]}; sheds "
          f"{arb2['sheds']}", flush=True)
    shed_rpcs = [r for r in seamed if r["code"] == RESOURCE_EXHAUSTED]
    print(f"[tiers] arbiter part 3: HBM_ALLOC every={TIERS_SEAM_EVERY} "
          f"limit=1 over a burst of {TIERS_BURST}: "
          f"{[(r['code'], len(r['tokens'])) for r in seamed]}, retry-after "
          f"{[r['trailers'].get('retry-after') for r in shed_rpcs]}; sheds "
          f"{sheds0} -> {arb3['sheds']}", flush=True)
    print(f"[tiers] {bucket_admissions} bucket admissions of "
          f"{len(admitted)}, {sum(steps)} decode steps; launches {counts}; "
          f"card: {card}", flush=True)
    tiers_seen = ([r["tier"] for r in r1], [r["tier"] for r in r2],
                  [r["tier"] for r in r3])
    require(all(r["code"] == OK and len(r["tokens"]) == TIERS_NEW
                for r in r1 + r2 + r3 + ref1 + ref2),
            "a round's stream failed or came short")
    require(tiers_seen == ([None] * 6, ["t0"] * 2 + ["t1"] * 4, ["t2"] * 6),
            f"tiers by round {tiers_seen}")
    require(st1["tiers"]["t1"]["spills"] == TIERS_SYSTEMS - 2
            and st1["tiers"]["t2"]["blocks_put"]
            == sum(len(p) // st1["block"] for p in round1),
            f"round 1 spills and write-through: {st1['tiers']}")
    require(all(r["cached"] == TIERS_SYSTEM_LEN for r in r2 + r3),
            "a hit restored other than the system prompt")
    require(all(r["restored_equal"] is True for r in r2 + r3),
            f"restored bytes differ: {[r['restored_equal'] for r in r2 + r3]}")
    print(f"[tiers] round 2's streams against the reference (no tiers): "
          f"first difference by request "
          f"{[_first_difference(r2[i]['tokens'], ref2[i]['tokens']) for i in range(TIERS_SYSTEMS)]}"
          f" (None: equal); a hit reads the stored row's last positions "
          f"as round 1's final chunk wrote them, where the reference's "
          f"mid chunk wrote its own", flush=True)
    same = [r2[i]["tokens"] == r3[i]["tokens"] for i in range(TIERS_SYSTEMS)]
    require(all(same), f"a request's streams differ between its T0/T1 "
            f"and its T2 hit: {same}")
    require([r["tokens"] for r in r1] == [r["tokens"] for r in ref1],
            "round 1's misses differ from the reference's")
    require(part1[:3] == (2, 1, 2) and isinstance(huge, hbm.HBMExhausted)
            and huge.status_code == 429
            and "Retry-After" in huge.headers
            and arb1["reclaims"].get("kvcache-t0", 0) >= 1,
            f"arbiter parts 1-2: {part1}, {huge!r}, {arb1['reclaims']}")
    require(all(r["code"] == OK and len(r["tokens"]) == TIERS_NEW
                for r in after_huge),
            "the burst after the shed lease was not served")
    require(len(shed_rpcs) == 1
            and all(r["code"] == OK and len(r["tokens"]) == TIERS_NEW
                    for r in seamed if r["code"] != RESOURCE_EXHAUSTED)
            and int(shed_rpcs[0]["trailers"].get("retry-after", 0)) >= 1
            and arb3["sheds"].get("engine", 0)
            == sheds0.get("engine", 0) + 1,
            f"the seam: {[r['code'] for r in seamed]}, sheds {arb3['sheds']}")
    require(counts["flash_prefill"] == LAYERS * bucket_admissions
            and bucket_admissions > 0,
            f"flash_prefill launched {counts['flash_prefill']} times for "
            f"{bucket_admissions} bucket admissions")
    require(counts["flash_decode"] == LAYERS * sum(steps) and sum(steps) > 0,
            f"flash_decode launched {counts['flash_decode']} times for "
            f"{sum(steps)} decode steps of {LAYERS} layers")
    others = {k: counts[k] for k in ("paged_decode", "paged_window",
                                     "prefill_plain", "decode_plain",
                                     "paged_plain")}
    require(not any(others.values()),
            f"other attention paths ran on the tiers' path: {others}")
    return {k: counts[k] for k in ("flash_prefill", "flash_decode")}


# -- running the phases -------------------------------------------------------

# -- phase lora: multi-LoRA on the example's rows ----------------------------

# examples/tpu-multi-lora/configs/.env's engine rows
LORA_ROWS = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "WARN",
             "TPU_MODEL": "llama3-8b", "TPU_QUANT": "int8",
             "TPU_KV_DTYPE": "int8", "TPU_SLOTS": "48", "TPU_MAX_SEQ": "1024",
             "TPU_LORA_ADAPTERS": "4", "TPU_LORA_RANK": "16"}
LORA_PAGED_ROWS = dict(LORA_ROWS, TPU_PAGED_BLOCKS="257",
                       TPU_PAGED_BLOCK="128")
LORA_SEED = 59
LORA_PER_ADAPTER = 8         # burst requests a adapter (adapters 0-3)
LORA_LENS = (17, 500)        # their prompt lengths: bucket admissions (K1)
LORA_NEW = 48
LORA_B_SCALE = 0.1           # B ~ N(0, scale^2): parts greedy tokens from
                             # adapter 0's (A ~ N(0, 1/in), as init_lora)
LORA_SWAP_NEW = 160          # the 8 streams live through the hot swap
LORA_F32_PROMPTS = 2         # a adapter, first-token logits against f32
LORA_BLOCK_REPS = 20         # decode-block replays timed, with and without
# first-token log-probabilities of the bf16 engine path (int8 weights,
# LoRA deltas) against float32 on the same weights with the adapter
# merged, through 32 layers (as VIT_F32_LOGP holds ViT's 24); on an H100
# the right merge read 0.0756 and the controls (a wrong adapter merged,
# none merged) 5.31 and 4.63, so the limit parts them
LORA_F32_LOGP = 0.25


def multi_lora_routes(app) -> None:
    """examples/tpu-multi-lora/main.py's three routes, on the port."""
    import io

    import numpy as np

    from gofr_tpu_torch.models.llama import LORA_TARGETS

    @app.post("/generate")
    def generate(ctx):
        body = ctx.bind()
        stream = ctx.tpu.generate(body["tokens"],
                                  max_new_tokens=body.get("max_new_tokens", 32),
                                  temperature=body.get("temperature", 0.0),
                                  adapter=body.get("adapter", 0))
        return {"tokens": stream.tokens(), "adapter": body.get("adapter", 0)}

    @app.get("/adapters")
    def list_adapters(ctx):
        return ctx.tpu.generator.stats().get("lora", {})

    @app.post("/adapters/{idx}")
    def install_adapter(ctx):
        idx = int(ctx.path_param("idx"))
        with np.load(io.BytesIO(ctx.request.body)) as f:
            tree = {name: (f[f"{name}.a"], f[f"{name}.b"])
                    for name in LORA_TARGETS if f"{name}.a" in f.files}
        ctx.tpu.generator.load_adapter(idx, tree)
        return {"installed": idx, "targets": sorted(tree)}


def http_raw(port: int, method: str, path: str, data: bytes) -> dict:
    """One request with a raw body: status and the JSON reply."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=APP_CALL_TIMEOUT_S)
    try:
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        return {"status": resp.status, "body": json.loads(resp.read())}
    finally:
        conn.close()


def adapter_npz(cfg, rank: int, seed: int) -> bytes:
    """An adapter as the example's install route reads it: '<target>.a'
    [L, in, r] drawn N(0, 1/in) and '<target>.b' [L, r, out] drawn
    N(0, LORA_B_SCALE^2), float16, from ``seed``."""
    import io

    import numpy as np

    from gofr_tpu_torch.models import llama

    rng = np.random.default_rng(seed)
    arrays = {}
    for name, (din, dout) in llama._lora_dims(cfg).items():
        L = cfg.n_layers
        arrays[f"{name}.a"] = (rng.standard_normal((L, din, rank), np.float32)
                               * din ** -0.5).astype(np.float16)
        arrays[f"{name}.b"] = (rng.standard_normal((L, rank, dout),
                                                   np.float32)
                               * LORA_B_SCALE).astype(np.float16)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def f32_merged_logits(params: dict, cfg, prompt, adapter: int):
    """Next-token log-probabilities [V] at the prompt's end in float32:
    the int8 weights dequantized and adapter ``adapter`` merged into
    them (W + A B), one layer at a time, plain attention. The reference
    the engine's bf16 path is held against."""
    import torch

    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.models.common import layer_weights
    from gofr_tpu_torch.ops import flash
    from gofr_tpu_torch.ops.norms import rms_norm
    from gofr_tpu_torch.ops.quant import QuantizedLinear

    def deq(w):
        if isinstance(w, QuantizedLinear):
            return w.w.float() * w.scale.float()
        return w.float()

    mc = cfg.with_(dtype="float32")
    n = len(prompt)
    dev = params["embedding"].device
    tokens = torch.tensor([prompt], device=dev)
    lengths = torch.tensor([n], dtype=torch.int32, device=dev)
    cos, sin = llama.get_rope_tables(mc, n, dev)
    positions = torch.arange(n, device=dev)[None]

    def attend(q, k, v):
        return flash.causal_prefill_plain(q, k, v, lengths)

    with torch.inference_mode():
        x = params["embedding"][tokens].float()
        for i in range(cfg.n_layers):
            w = layer_weights(params["layers"], i)
            f = {k: deq(v) for k, v in w.items() if not k.startswith("lora_")}
            for name in llama.LORA_TARGETS:
                f[name] = f[name] + (w[f"lora_a_{name}"][adapter].float()
                                     @ w[f"lora_b_{name}"][adapter].float())
            x, _ = llama._layer(x, f, mc, cos, sin, positions, attend)
            del f
        x = rms_norm(x[:, -1], params["final_norm"].float(), cfg.norm_eps)
        logits = x @ deq(params["lm_head"])
    return torch.log_softmax(logits[0], dim=-1)


def engine_first_logp(gen, prompt, adapter: int):
    """The engine's bucket admission path run eagerly on the card
    (prefill_kv through K1 at the prompt's bucket, the adapter's
    deltas): next-token log-probabilities [V] at the prompt's end."""
    import torch

    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.tpu.generator import pad_bucket

    n = len(prompt)
    width = pad_bucket(n, gen.prompt_buckets)
    dev = gen.device
    tokens = torch.zeros((1, width), dtype=torch.long, device=dev)
    tokens[0, :n] = torch.tensor(prompt)
    with torch.inference_mode():
        logits, _, _, _ = llama.prefill_kv(
            gen.params, gen.cfg, tokens,
            torch.tensor([n], dtype=torch.int32, device=dev),
            rope_tables=gen.rope_tables, flash=True,
            logit_pos=torch.tensor([n - 1], device=dev),
            adapter=torch.tensor([adapter], device=dev))
    return torch.log_softmax(logits[0, 0].float(), dim=-1)


def block_device_ms(gen, lengths: list, adapters: list, reps: int) -> float:
    """The median device time of one decode-block replay (CUDA events)
    with every slot live at ``lengths`` on ``adapters``, the cursors and
    the pack put back before each replay; the engine is idle, and is
    left as an idle engine finds it."""
    import numpy as np
    import torch

    b = gen.n_slots
    p = gen._warm_pack()
    p[:, 0] = np.arange(b) + 7
    p[:, 1] = 1
    p[:, 2] = 10_000
    p[:, 5] = adapters
    p[:, 8] = lengths
    pack = torch.from_numpy(p).to(gen.device)
    cursors = torch.tensor(lengths, dtype=torch.int32, device=gen.device)
    graph = gen._graphs[False][0]
    times = []
    with quiet_device(gen):
        for _ in range(reps + 1):
            gen._pack.copy_(pack)
            gen.cache.lengths.copy_(cursors)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        gen.cache.lengths.zero_()
        gen._host_wins[:] = True
        gen._touch()
    return float(np.median(times[1:]))


def _lora_generate(port: int, prompt, adapter: int, new: int) -> list:
    out = http_call(port, "POST", "/generate",
                    {"tokens": prompt, "adapter": adapter,
                     "max_new_tokens": new})
    require(out["status"] == 200, f"POST /generate: {out['status']} "
                                  f"{out.get('body')}")
    data = out["lines"][0]["data"]
    require(data["adapter"] == adapter, f"the route answered {data}")
    return data["tokens"]


def _first_split(a: list, b: list):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def phase_lora(card: str) -> dict:
    """Multi-LoRA serving at full width and depth, on
    examples/tpu-multi-lora's routes and rows: a ``gofr_tpu_torch.App``
    builds Llama-3-8B (int8 weights and KV, 48 slots, 1024 positions,
    4 adapter slots of rank 16; seed-0 weights); adapters 1-3 installed
    through ``POST /adapters/{idx}`` (seeded npz bodies); 32 concurrent
    ``POST /generate`` (8 an adapter, greedy) with K1 a bucket admission
    and K2 a decode step counted, then the same prompts all on adapter
    0; adapter-0 streams against an engine without LoRA on the same base
    tensors, prompts alone on each; first-token log-probabilities of
    adapters 1-3 against float32 with the adapter merged; a hot swap
    (``POST /adapters/3`` with adapter 1's body) under 8 live streams,
    after which adapter 3 streams adapter 1's tokens; ``GET /adapters``;
    a decode block's device time with and without LoRA; the stacks'
    bytes in the arbiter; then a paged engine (257 blocks of 128) on the
    same base weights and adapters serving 8 mixed prompts alone
    through K3, token for token the contiguous engine's. Returns the
    launch counts of the contiguous burst and the paged run."""
    import gc
    import threading

    import numpy as np
    import torch

    from gofr_tpu_torch import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.tpu import GenerationEngine, hbm, new_engine_from_config

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    app = App(MapConfig(LORA_ROWS))
    multi_lora_routes(app)
    app.run(block=False)
    tpu = app.container.tpu
    gen = tpu.generator
    cfg = gen.cfg
    layers = cfg.n_layers
    torch.cuda.synchronize()
    built_s = time.monotonic() - t0
    lora_bytes = hbm.live_bytes().get("lora", 0)
    rank = int(gen.params["layers"]["lora_a_wq"].shape[-1])
    port = app.http_port
    streams, lock = [], threading.Lock()
    generate = tpu.generate

    def tracked(*args, **kw):
        s = generate(*args, **kw)
        with lock:
            streams.append(s)
        return s

    tpu.generate = tracked
    plain = None
    try:
        # adapters 1-3 through the install route
        bodies = {k: adapter_npz(cfg, rank, LORA_SEED * 100 + k)
                  for k in (1, 2, 3)}
        t_inst = time.monotonic()
        installed = [http_raw(port, "POST", f"/adapters/{k}", bodies[k])
                     for k in (1, 2, 3)]
        inst_s = (time.monotonic() - t_inst) / 3
        require(all(r["status"] == 200 and r["body"]["data"]["targets"]
                    == ["wk", "wo", "wq", "wv"] for r in installed),
                f"adapter installs: {installed}")
        listed = http_call(port, "GET", "/adapters")
        want = {"adapters": int(LORA_ROWS["TPU_LORA_ADAPTERS"]),
                "rank": int(LORA_ROWS["TPU_LORA_RANK"])}
        require(listed["status"] == 200 and listed["body"]["data"] == want,
                f"GET /adapters: {listed}")
        rng = np.random.default_rng(LORA_SEED)
        vocab = cfg.vocab_size
        lens = rng.integers(LORA_LENS[0], LORA_LENS[1] + 1,
                            4 * LORA_PER_ADAPTER)
        prompts = [rng.integers(0, vocab, int(n)).tolist() for n in lens]
        adapters = [i % 4 for i in range(len(prompts))]

        def burst(which) -> tuple:
            del streams[:]
            t_b = time.monotonic()
            outs = _threads([lambda p=p, a=a: _lora_generate(
                port, p, a, LORA_NEW) for p, a in zip(prompts, which)])
            wall = time.monotonic() - t_b
            ttft = [1e3 * (s.trace["first_put"] - s.trace["submit"])
                    for s in streams]
            return outs, wall, ttft

        # the main path: the mixed burst, counted
        adm0, steps0 = gen.admissions, gen.decode_steps
        _reset_launches()
        mixed, mixed_s, mixed_ttft = burst(adapters)
        counts = _launches()
        admissions = gen.admissions - adm0
        steps = gen.decode_steps - steps0
        require(all(len(t) == LORA_NEW for t in mixed),
                f"burst lengths {[len(t) for t in mixed]}")
        require(admissions == len(prompts),
                f"{admissions} admissions for {len(prompts)} requests")
        require(counts["flash_prefill"] == layers * admissions,
                f"flash_prefill launches {counts['flash_prefill']} for "
                f"{admissions} bucket admissions of {layers} layers")
        require(counts["flash_decode"] == layers * steps,
                f"flash_decode launches {counts['flash_decode']} for "
                f"{steps} decode steps of {layers} layers")
        require(counts["prefill_plain"] == counts["decode_plain"] == 0,
                f"plain versions ran on the card: {counts}")
        base0, base_s, base_ttft = burst([0] * len(prompts))
        require(all(len(t) == LORA_NEW for t in base0), "adapter-0 burst")
        # (a) adapter 0 against an engine without LoRA, prompts alone
        base_params = {**gen.params, "layers": {
            k: v for k, v in gen.params["layers"].items()
            if not k.startswith("lora_")}}
        plain = GenerationEngine(
            cfg, base_params, slots=gen.n_slots, max_seq=gen.max_seq,
            kv_dtype=torch.int8, prompt_buckets=gen.prompt_buckets,
            device=gen.device)
        zero = [i for i, a in enumerate(adapters) if a == 0]
        alone0 = [_lora_generate(port, prompts[i], 0, LORA_NEW) for i in zero]
        plain0 = [plain.generate(prompts[i], max_new_tokens=LORA_NEW).tokens()
                  for i in zero]
        splits_a = [(i, _first_split(a, b)) for i, a, b in
                    zip(zero, alone0, plain0) if a != b]
        in_burst = sum(mixed[i] == a for i, a in zip(zero, alone0))
        # adapters part from adapter 0: the first prompt of each, alone
        parted = {}
        for k in (1, 2, 3):
            i = adapters.index(k)
            parted[k] = (_lora_generate(port, prompts[i], 0, LORA_NEW)
                         != _lora_generate(port, prompts[i], k, LORA_NEW))
        block_plain = block_device_ms(
            plain, [int(n) for n in np.resize(lens, plain.n_slots)],
            [0] * plain.n_slots, LORA_BLOCK_REPS)
        plain.close()
        release_graphs(plain)
        plain = None
        block_lora = block_device_ms(
            gen, [int(n) for n in np.resize(lens, gen.n_slots)],
            [i % 4 for i in range(gen.n_slots)], LORA_BLOCK_REPS)
        # (b) first-token log-probabilities against float32, merged
        # and, as controls, against float32 with the wrong adapter merged
        # (k's neighbour) and with none: the tolerance must part the
        # right reference from both
        f32_d, agree = 0.0, 0
        ctl_d = {"wrong": float("inf"), "off": float("inf")}
        for k in (1, 2, 3):
            for i in [j for j, a in enumerate(adapters)
                      if a == k][:LORA_F32_PROMPTS]:
                got = engine_first_logp(gen, prompts[i], k)
                ref = f32_merged_logits(gen.params, cfg, prompts[i], k)
                f32_d = max(f32_d, float((got - ref).abs().max()))
                agree += int(torch.argmax(ref)) == mixed[i][0]
                for ctl, other in (("wrong", k % 3 + 1), ("off", 0)):
                    ref = f32_merged_logits(gen.params, cfg, prompts[i],
                                            other)
                    ctl_d[ctl] = min(ctl_d[ctl],
                                     float((got - ref).abs().max()))
                del ref
                torch.cuda.empty_cache()
        # (c) the hot swap under 8 live streams
        live_idx = [i for i, a in enumerate(adapters) if a == 3][:4] + \
            [i for i, a in enumerate(adapters) if a != 3][:4]
        live_out = [None] * len(live_idx)

        def live(j, i):
            live_out[j] = _lora_generate(port, prompts[i], adapters[i],
                                         LORA_SWAP_NEW)

        threads = [threading.Thread(target=live, args=(j, i), daemon=True)
                   for j, i in enumerate(live_idx)]
        for t in threads:
            t.start()
        end = time.monotonic() + 60
        while gen.stats()["active"] < len(live_idx) and \
                time.monotonic() < end:
            time.sleep(0.005)
        active_at_swap = gen.stats()["active"]
        t_swap = time.monotonic()
        swap = http_raw(port, "POST", "/adapters/3", bodies[1])
        swap_s = time.monotonic() - t_swap
        for t in threads:
            t.join(APP_JOIN_S)
        require(swap["status"] == 200, f"the swap: {swap}")
        require(all(o is not None and len(o) == LORA_SWAP_NEW
                    for o in live_out), "a live stream did not finish")
        require(active_at_swap == len(live_idx),
                f"{active_at_swap} streams live at the swap")
        probe = prompts[adapters.index(1)]
        after3 = _lora_generate(port, probe, 3, LORA_NEW)
        as1 = _lora_generate(port, probe, 1, LORA_NEW)
        # the paged half: the same base tensors and adapters, 8 alone
        picks = [i for k in range(4)
                 for i in [j for j, a in enumerate(adapters) if a == k][:2]]
        contig = [_lora_generate(port, prompts[i], adapters[i], LORA_NEW)
                  for i in picks]
        stats = gen.stats()
    finally:
        if plain is not None:
            plain.close()
            release_graphs(plain)
        app.stop()
        release_graphs(gen)
    paged_params = gen.params
    del gen, tpu, app
    gc.collect()
    torch.cuda.empty_cache()
    t_p = time.monotonic()
    peng = new_engine_from_config(MapConfig(LORA_PAGED_ROWS), device="cuda",
                                  params=paged_params)
    pgen = peng.generator
    try:
        paged_built = time.monotonic() - t_p
        adm0, steps0 = pgen.admissions, pgen.decode_steps
        _reset_launches()
        paged = [pgen.generate(prompts[i], max_new_tokens=LORA_NEW,
                               adapter=adapters[i]).tokens() for i in picks]
        pcounts = _launches()
        p_adm = pgen.admissions - adm0
        p_steps = pgen.decode_steps - steps0
        pool_whole = pgen.stats()["paged"]["free"] == pgen._alloc.n_blocks - 1
    finally:
        peng.close()
        release_graphs(pgen)
    del paged_params, pgen, peng
    splits_p = [(adapters[i], _first_split(a, b)) for i, a, b in
                zip(picks, paged, contig) if a != b]
    toks = len(prompts) * LORA_NEW
    rows = LORA_ROWS
    print(f"[lora] App with {rows['TPU_MODEL']} ({rows['TPU_QUANT']} "
          f"weights, {rows['TPU_KV_DTYPE']} KV, {rows['TPU_SLOTS']} slots, "
          f"{rows['TPU_MAX_SEQ']} positions, {rows['TPU_LORA_ADAPTERS']} "
          f"adapters of rank {rank}) ready in {built_s:.1f} s; "
          f"LoRA stacks held by the arbiter {lora_bytes} bytes "
          f"({lora_bytes / 2**20:.2f} MiB); an adapter install through POST "
          f"/adapters/{{idx}} {inst_s:.3f} s; GET /adapters "
          f"{listed['body']['data']}; card: {card}", flush=True)
    print(f"[lora] mixed burst: {len(prompts)} requests of "
          f"{LORA_LENS[0]}-{LORA_LENS[1]} tokens, {LORA_NEW} new each, "
          f"{LORA_PER_ADAPTER} an adapter: {toks / mixed_s:.1f} tok/s in "
          f"{mixed_s:.3f} s, TTFT {stats_line(mixed_ttft)}; the same prompts "
          f"on adapter 0: {toks / base_s:.1f} tok/s in {base_s:.3f} s, TTFT "
          f"{stats_line(base_ttft)}; launches flash_prefill "
          f"{counts['flash_prefill']} = {layers} x {admissions} admissions, "
          f"flash_decode {counts['flash_decode']} = {layers} x {steps} decode "
          f"steps; card: {card}", flush=True)
    print(f"[lora] decode block (K={stats['decode_block']}, {stats['slots']} "
          f"slots live at "
          f"the burst's lengths, CUDA events, median of {LORA_BLOCK_REPS}): "
          f"{block_lora:.3f} ms on 4 adapters against {block_plain:.3f} ms "
          f"on the engine without LoRA, LoRA's gather and thin products "
          f"{block_lora - block_plain:.3f} ms "
          f"({100 * (block_lora / block_plain - 1):.1f} %); card: {card}",
          flush=True)
    print(f"[lora] adapter 0 alone against the engine without LoRA: "
          f"{len(zero) - len(splits_a)}/{len(zero)} equal "
          f"{'(splits ' + str(splits_a) + ')' if splits_a else ''}; in the "
          f"mixed burst {in_burst}/{len(zero)} equal to alone; adapters "
          f"1-3 part from adapter 0 on their first prompt: {parted}; "
          f"first-token log-probs of adapters 1-3 against float32 merged: "
          f"max |diff| {f32_d:.3e} (tolerance {LORA_F32_LOGP}), argmax = "
          f"the burst's first token at {agree}/{3 * LORA_F32_PROMPTS}; "
          f"controls (least max |diff| over the same prompts): the wrong "
          f"adapter merged {ctl_d['wrong']:.3e}, no adapter "
          f"{ctl_d['off']:.3e}", flush=True)
    print(f"[lora] hot swap: POST /adapters/3 (adapter 1's body) with "
          f"{active_at_swap} streams live in {swap_s:.3f} s; the live streams "
          f"finished ({LORA_SWAP_NEW} tokens each); adapter 3 after the swap "
          f"{'equals' if after3 == as1 else 'differs from'} adapter 1 on the "
          f"same prompt (first split {_first_split(after3, as1)})",
          flush=True)
    print(f"[lora] paged ({LORA_PAGED_ROWS['TPU_PAGED_BLOCKS']} blocks of "
          f"{LORA_PAGED_ROWS['TPU_PAGED_BLOCK']}, the same base tensors and "
          f"adapters) ready in {paged_built:.1f} s: {len(picks)} mixed prompts "
          f"alone, {len(picks) - len(splits_p)}/{len(picks)} token for token "
          f"the contiguous engine's"
          f"{' (splits: adapter, first position ' + str(splits_p) + ')' if splits_p else ''}; "
          f"launches paged_decode {pcounts['paged_decode']} = {layers} x "
          f"{p_steps} decode steps, flash_prefill {pcounts['flash_prefill']} "
          f"= {layers} x {p_adm} admissions; the pool whole afterwards: "
          f"{pool_whole}", flush=True)
    require(not splits_a, f"adapter 0 against no LoRA: {splits_a}")
    require(all(parted.values()), f"an adapter streams adapter 0: {parted}")
    require(f32_d <= LORA_F32_LOGP, f"LoRA first token against float32: "
                                    f"{f32_d}")
    require(agree == 3 * LORA_F32_PROMPTS,
            f"float32's argmax is the burst's first token at {agree}/"
            f"{3 * LORA_F32_PROMPTS}")
    require(min(ctl_d.values()) > LORA_F32_LOGP,
            f"the float32 check cannot tell a wrong adapter: {ctl_d} within "
            f"{LORA_F32_LOGP}")
    require(after3 == as1, "adapter 3 after the swap is not adapter 1: the "
                           "graphs read stale stacks")
    require(pcounts["paged_decode"] == layers * p_steps and p_steps > 0,
            f"paged_decode launches {pcounts['paged_decode']} for {p_steps} "
            "decode steps")
    require(pcounts["flash_prefill"] == layers * p_adm,
            f"flash_prefill {pcounts['flash_prefill']} for {p_adm} admissions")
    require(pcounts["paged_plain"] == 0, "the paged plain version ran")
    require(pool_whole, "the paged pool is not whole after the run")
    return {"flash_prefill": counts["flash_prefill"]
            + pcounts["flash_prefill"],
            "flash_decode": counts["flash_decode"],
            "paged_decode": pcounts["paged_decode"]}


# -- phase pubsub: BASELINE config #4 (Kafka -> batched ViT-L/14) -------------

# examples/kafka-vit-classify/configs/.env with the in-process broker
PUBSUB_ROWS = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "WARN",
               "PUBSUB_BACKEND": "MEM", "CONSUMER_ID": "vit-classifier",
               "TPU_MODEL": "vit-l-14", "TPU_BATCH_BUCKETS": "1,2,4,8"}
PUBSUB_SEED = 61
PUBSUB_JOBS = 12
PUBSUB_IMAGES = (1, 8)       # images a job, drawn here
PUBSUB_POOL = 16             # distinct images the jobs draw from
PUBSUB_WAIT_S = 240
PUBSUB_STOP_S = 2.0          # SubscriptionManager.stop's join timeout
FILL_UNSET = ("unset (predict_batch bypasses the coalescing batcher, as in "
              "JAX)")


def vit_classify(ctx):
    """examples/kafka-vit-classify/main.py's handler, on the port."""
    import numpy as np

    job = ctx.bind()
    batch = [np.asarray(img, np.float32) for img in job["images"]]
    probs = ctx.tpu.predict_batch("classify", batch)
    ctx.get_publisher().publish("classifications", {
        "job_id": job.get("job_id"),
        "labels": [int(np.argmax(p)) for p in probs],
    })
    return None  # commit


def phase_pubsub(card: str) -> None:
    """BASELINE config #4 on one card: a ``gofr_tpu_torch.App`` whose
    subscriber loop feeds ViT-L/14 (``classify``, batch buckets 1-8)
    from the ``images`` topic of the in-process broker, the example's
    handler publishing each job's labels on ``classifications``. 12 jobs
    of 1-8 images (224 x 224 x 3 float32 as JSON lists, as the example
    takes them) and one malformed message are published at once; each
    job's labels must equal a direct ``predict_batch`` on the card, the
    subscribe counters read 13 and 12, the malformed message is logged
    and left uncommitted, and ``stop()`` joins the subscriber thread.
    Jobs and images a second, and each job's publish-to-result latency
    split into the JSON bind and the dispatch. No attention kernel runs
    here: ViT's attention is plain, in JAX as in the port."""
    import gc
    import threading

    import numpy as np
    import torch

    from gofr_tpu_torch import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.tpu.batcher import pad_bucket

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    app = App(MapConfig(PUBSUB_ROWS))
    app.subscribe("images")(vit_classify)
    tpu = app.container.tpu
    prog = tpu._programs["classify"]
    size = prog.example_item.shape[0]
    rng = np.random.default_rng(PUBSUB_SEED)
    pool = [rng.standard_normal((size, size, 3), np.float32)
            for _ in range(PUBSUB_POOL)]
    encoded = [json.dumps(img.tolist()) for img in pool]
    jobs = [rng.integers(0, PUBSUB_POOL, int(n)).tolist()
            for n in rng.integers(PUBSUB_IMAGES[0], PUBSUB_IMAGES[1] + 1,
                                  PUBSUB_JOBS)]
    bodies = [('{"job_id": "job-%d", "images": [' % j
               + ", ".join(encoded[i] for i in job) + "]}").encode()
              for j, job in enumerate(jobs)]
    bad_at = PUBSUB_JOBS // 2
    bodies.insert(bad_at, b"{not json")
    errors, recv, calls, results = [], {}, [], []
    log_error = app.container.logger.error

    def note_error(*a, **k):
        errors.append(a[0])
        log_error(*a, **k)

    app.container.logger.error = note_error
    client = app.container.pubsub
    subscribe, publish = client.subscribe, client.publish
    delivered = []

    def timed_subscribe(topic, timeout=None):
        msg = subscribe(topic, timeout)
        if msg is not None:
            recv[int(msg.metadata["offset"])] = time.monotonic()
            delivered.append(msg)
        return msg

    def timed_publish(topic, message):
        publish(topic, message)
        if topic == "classifications":
            results.append((time.monotonic(), json.loads(
                json.dumps(message))))

    client.subscribe, client.publish = timed_subscribe, timed_publish
    predict_batch = tpu.predict_batch

    def timed_predict(program, items):
        t = time.monotonic()
        out = predict_batch(program, items)
        torch.cuda.synchronize()
        calls.append((t, time.monotonic(), len(items)))
        return out

    tpu.predict_batch = timed_predict
    tpu.predict_batch("classify", pool[:1])   # first-call set-up
    del calls[:]
    d0 = prog.dispatches
    built_s = time.monotonic() - t0
    app.run(block=False)
    sent = []
    for body in bodies:
        sent.append(time.monotonic())
        publish("images", body)
    end = time.monotonic() + PUBSUB_WAIT_S
    while len(results) < PUBSUB_JOBS and time.monotonic() < end:
        time.sleep(0.01)
    time.sleep(0.2)   # the last commit lands
    require(len(results) == PUBSUB_JOBS,
            f"{len(results)} results of {PUBSUB_JOBS} jobs")
    dispatches = prog.dispatches - d0
    # the direct call, with the subscriber idle: the same images through
    # the engine's own predict_batch
    want = [[int(np.argmax(p)) for p in predict_batch(
        "classify", [pool[i] for i in job])] for job in jobs]
    t_stop = time.monotonic()
    app.stop()
    stop_s = time.monotonic() - t_stop
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith("subscriber-") and t.is_alive()]
    m = app.container.metrics.render_prometheus().splitlines()

    def metric(name):
        return [line for line in m if line.startswith(name)]

    total = _total(metric("app_pubsub_subscribe_total_count"))
    success = _total(metric("app_pubsub_subscribe_success_count"))
    fill = metric("app_tpu_batch_fill")
    got = {r["job_id"]: r["labels"] for _, r in results}
    good = [i for i in range(len(bodies)) if i != bad_at]
    bind = [1e3 * (c[0] - recv[o]) for c, o in zip(calls, good)]
    disp = [1e3 * (c[1] - c[0]) for c in calls]
    lat = [1e3 * (r[0] - sent[o]) for r, o in zip(results, good)]
    span = results[-1][0] - sent[0]
    images = sum(len(j) for j in jobs)
    sizes = [c[2] for c in calls]
    fills = [n / pad_bucket(n, prog.batch_buckets) for n in sizes]
    mb = sum(len(b) for b in bodies) / 2**20
    print(f"[pubsub] App with {PUBSUB_ROWS['TPU_MODEL']} (batch buckets "
          f"{prog.batch_buckets}) and the MEM broker ready in {built_s:.1f} "
          f"s; {PUBSUB_JOBS} jobs of "
          f"{PUBSUB_IMAGES[0]}-{PUBSUB_IMAGES[1]} images ({images} in all, "
          f"{mb:.1f} MiB of JSON) and one malformed message published at "
          f"once: {PUBSUB_JOBS / span:.2f} jobs/s, {images / span:.2f} "
          f"images/s over {span:.3f} s; publish-to-result p50 "
          f"{np.percentile(lat, 50):.1f} ms p99 {np.percentile(lat, 99):.1f} "
          f"ms; a job's bind (JSON to arrays) p50 "
          f"{np.percentile(bind, 50):.1f} ms p99 {np.percentile(bind, 99):.1f} "
          f"ms, its dispatch p50 {np.percentile(disp, 50):.1f} ms p99 "
          f"{np.percentile(disp, 99):.1f} ms; {dispatches} dispatches of "
          f"sizes {sizes} (bucket fill mean {np.mean(fills):.3f}); "
          f"app_tpu_batch_fill {fill or FILL_UNSET}; subscribe counters total "
          f"{total:.0f} success {success:.0f}; stop() in {stop_s:.3f} s; "
          f"card: {card}", flush=True)
    require(got == {f"job-{j}": w for j, w in enumerate(want)},
            f"labels differ from a direct predict_batch: {got} {want}")
    require((total, success) == (PUBSUB_JOBS + 1, PUBSUB_JOBS),
            f"subscribe counters {total} {success}")
    require(any(e.get("event") == "subscriber handler error"
                and e.get("topic") == "images" for e in errors),
            "the malformed job was not logged")
    require([msg.committed for msg in delivered] ==
            [i != bad_at for i in range(len(bodies))],
            "the commits: only the malformed message may stay uncommitted")
    require(not alive and stop_s < PUBSUB_STOP_S + 1.0,
            f"subscriber threads after stop(): {alive} ({stop_s:.3f} s)")


RECORD_KEYS = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
               "bound_by", "library_ms")


def run(phases=("build", "kernels", "model", "main", "paged", "spec",
                "durable", "slo", "app", "predict", "grpc", "tiers", "lora",
                "pubsub")) -> dict:
    import torch

    card = card_line()
    print(f"[card] {card}", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    records = {
        "flash_prefill": {
            "name": "flash_prefill", "route": "cuda",
            "source": "gofr_tpu_torch/ops/csrc/flash_prefill.cu",
            "replaces": "gofr_tpu/ops/flash.py:177"},
        "flash_decode": {
            "name": "flash_decode", "route": "cuda",
            "source": "gofr_tpu_torch/ops/csrc/flash_decode.cu",
            "replaces": "gofr_tpu/ops/flash_decode.py:171"},
        "paged_decode": {
            "name": "paged_decode", "route": "cuda",
            "source": "gofr_tpu_torch/ops/csrc/paged_decode.cu",
            "replaces": "gofr_tpu/ops/paged_attention.py:96"},
        "paged_window": {
            "name": "paged_window", "route": "cuda",
            "source": "gofr_tpu_torch/ops/csrc/paged_window.cu",
            "replaces": "gofr_tpu/ops/paged_attention.py:256"},
    }
    for phase in phases:
        t0 = time.monotonic()
        if phase == "build":
            phase_build()
        elif phase == "kernels":
            phase_kernels(records)
        elif phase == "model":
            phase_model_4_layers()
        elif phase == "main":
            counts = phase_main_path(card)
            records["flash_prefill"]["launches"] = counts["flash_prefill"]
            records["flash_decode"]["launches"] = counts["flash_decode"]
        elif phase == "paged":
            counts = phase_paged(card)
            records["paged_decode"]["launches"] = counts["paged_decode"]
        elif phase == "spec":
            counts = phase_spec(card)
            records["paged_window"]["launches"] = counts["paged_window"]
        elif phase == "durable":
            phase_durable(card)
        elif phase == "slo":
            phase_slo(card)
        elif phase == "app":
            phase_app(card)
        elif phase == "predict":
            counts = phase_predict(card)
            # K1's count: phase 5's main path plus the score run
            rec = records["flash_prefill"]
            rec["launches"] = rec.get("launches", 0) + counts["flash_prefill"]
        elif phase in ("grpc", "tiers", "lora"):
            counts = {"grpc": phase_grpc, "tiers": phase_tiers,
                      "lora": phase_lora}[phase](card)
            # K1's, K2's (and K3's) counts: the earlier phases' plus this
            # run's
            for name, n in counts.items():
                rec = records[name]
                rec["launches"] = rec.get("launches", 0) + n
        elif phase == "pubsub":
            phase_pubsub(card)
        else:
            raise SmokeFailure(f"unknown phase {phase!r}")
        torch.cuda.empty_cache()
        print(f"[phase] {phase} done in {time.monotonic() - t0:.1f} s",
              flush=True)
    return {"card": card, "records": records}


# one arm of --prefill-ab, run inside a tree with that tree's own
# chip_smoke and kernels; it uses only what every version of this script
# has had
AB_ARM = """
import time, torch, chip_smoke as c
from gofr_tpu_torch.ops import flash
print("[card]", c.card_line(), flush=True)
c.phase_build()
g = torch.Generator(device="cuda")
g.manual_seed(1234)
for s in (512, 1500, 4096):
    try:
        c.prefill_case(g, 1, s, [s], {})
    except c.SmokeFailure as e:   # an experiment that gives up the result
        print("[ab] times only:", e, flush=True)
q, k, v = (torch.randn((1, 512, n, 128), generator=g, device="cuda")
           .to(torch.bfloat16) for n in (32, 8, 8))
lens = torch.tensor([512], dtype=torch.int32, device="cuda")
for n in (20, 1000):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        flash.flash_prefill(q, k, v, lens)
    us = 1e6 * (time.perf_counter() - t0) / n
torch.cuda.synchronize()
print(f"[host] flash_prefill B=1 S=512: {us:.2f} us of host time per call",
      flush=True)
"""


# one arm of --decode-ab: K2 int8 at 8 x 512, K3 int8 at 8 x 512 and at
# phase paged's first decode step, K3w int8 at W = 5 at the same lengths
DECODE_AB_ARM = """
import numpy as np, torch, chip_smoke as c
print("[card]", c.card_line(), flush=True)
c.phase_build()
g = torch.Generator(device="cuda")
g.manual_seed(1234)
prompts = c.paged_prompt_lengths(np.random.default_rng(c.PAGED_SEED))
for case, args, kw in (
        (c.decode_case, ([512] * 8, True, {}), {}),
        (c.paged_case, ([512] * 8, True, {}), {"timed": True}),
        (c.paged_case, (prompts + [0] * 8, True, {}),
         {"mb": 32, "n": 257, "timed": True}),
        (c.window_case, ([512] * 8, 5, True, {}), {"timed": True}),
        (c.window_case, (prompts + [0] * 8, 5, True, {}),
         {"mb": 32, "n": 257, "timed": True})):
    try:
        case(g, *args, **kw)
    except c.SmokeFailure as e:   # an experiment that gives up the result
        print("[ab] times only:", e, flush=True)
"""


# one arm of --serve-ab: the serving runs of phases 5 (at the default
# depth, then with TPU_DECODE_PIPELINE=1), paged and spec, each on a fresh
# engine from new_engine_from_config (random weights from seed 0), warmed
# by one short request, then its requests timed; one JSON line a run. It
# uses only what every version of this script has had and the engine's
# public surface, so a parent tree runs it too
SERVE_AB_ARM = """
import json, numpy as np, torch, chip_smoke as c
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.tpu import GenerationEngine, new_engine_from_config
card = c.card_line()
print("[card]", card, flush=True)
c.phase_build()


def report(phase, eng, prompts, sampled, new_tokens):
    gen = eng.generator
    eng.generate(prompts[0][:32], max_new_tokens=4).tokens()
    outs, streams, wall = c._serve(eng, prompts, sampled, new_tokens)
    st = gen.stats()
    ttft = [s.trace["first_put"] - s.trace["submit"] for s in streams]
    pipe = st.get("scheduler", {}).get("pipeline", {})
    total = sum(len(x) for x in outs)
    print("[ab] " + json.dumps({
        "phase": phase, "tok_s": total / wall, "wall_s": wall,
        "step_ms": st["decode_step_ms_mean"],
        "ttft_mean_ms": 1e3 * float(np.mean(ttft)),
        "ttft_max_ms": 1e3 * max(ttft), "depth": pipe.get("depth", 1),
        "overlapped_reaps": pipe.get("overlapped_reaps"),
        "gap_p50_ms": pipe.get("gap_p50_ms"),
        "graph_replays": st.get("graph_replays"), "card": card}), flush=True)


rows5 = {"TPU_MODEL": "llama3-8b", "TPU_SLOTS": "8", "TPU_MAX_SEQ": "2048",
         "TPU_KV_DTYPE": "int8", "TPU_DECODE_BLOCK": "4"}
for phase, rows in (("main", rows5),
                    ("main-depth1", dict(rows5, TPU_DECODE_PIPELINE="1"))):
    eng = new_engine_from_config(MapConfig(rows), device="cuda")
    vocab = eng.generator.cfg.vocab_size
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, vocab, n).tolist()
               for n in (17, 500, 123, 256, 64)]
    try:
        report(phase, eng, prompts + [list(prompts[0])], {3: 5}, 32)
    finally:
        eng.close()
    del eng
    torch.cuda.empty_cache()
eng = new_engine_from_config(MapConfig(c.PAGED_ROWS), device="cuda")
rng = np.random.default_rng(c.PAGED_SEED)
lens = c.paged_prompt_lengths(rng)
try:
    report("paged", eng, [rng.integers(0, vocab, n).tolist() for n in lens],
           {5: 101, 17: 202}, c.PAGED_NEW_TOKENS)
finally:
    eng.close()
del eng
torch.cuda.empty_cache()
eng = new_engine_from_config(MapConfig(c.SPEC_ROWS), device="cuda")
gen = eng.generator
ref = GenerationEngine(gen.cfg, gen.params, slots=gen.n_slots,
                       max_seq=gen.max_seq, kv_dtype=torch.int8,
                       decode_block=gen.decode_block, paged_blocks=257,
                       paged_block_size=128, device="cuda")
rng = np.random.default_rng(c.SPEC_SEED)
xs = [rng.integers(0, vocab, n).tolist()
      for n in rng.integers(c.SPEC_X[0], c.SPEC_X[1] + 1, c.SPEC_REQUESTS)]
try:
    conts, _, _ = c._serve(ref, xs, {}, c.SPEC_CONTINUATION)
    report("spec", eng, [x + s + x for x, s in zip(xs, conts)], {},
           c.PAGED_NEW_TOKENS)
finally:
    eng.close()
    ref.close()
"""


def tree_ab(arm: str, trees: list[str]) -> int:
    for tree in trees:
        print(f"[ab] {tree}", flush=True)
        subprocess.run([sys.executable, "-c", arm], cwd=tree, check=True,
                       timeout=900)
    return 0


def repeat(n: int, hang_s: float) -> int:
    import signal

    out = os.path.join(ROOT, "chiprun_out", "repeat")
    os.makedirs(out, exist_ok=True)
    failed = 0
    for i in range(n):
        t0 = time.monotonic()
        with open(os.path.join(out, f"run{i}.out"), "w") as so, \
                open(os.path.join(out, f"run{i}.err"), "w") as se:
            proc = subprocess.Popen([sys.executable, __file__], cwd=ROOT,
                                    stdout=so, stderr=se,
                                    stdin=subprocess.DEVNULL)
            try:
                rc = proc.wait(hang_s)
            except subprocess.TimeoutExpired:
                proc.send_signal(signal.SIGUSR1)   # every thread's stack
                time.sleep(3)
                proc.kill()
                proc.wait()
                rc = "hung"
        with open(os.path.join(out, f"run{i}.out")) as f:
            phases = [ln.strip() for ln in f if ln.startswith("[phase]")]
        failed += rc != 0
        print(f"[repeat] run {i}: exit {rc} after "
              f"{time.monotonic() - t0:.1f} s; last "
              f"{phases[-1] if phases else None}", flush=True)
    return 1 if failed else 0


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "gofr_tpu_torch", "ops", "csrc")):
        print("chip_smoke: gofr_tpu_torch is not beside this script",
              file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    arms = {"--prefill-ab": AB_ARM, "--decode-ab": DECODE_AB_ARM,
            "--serve-ab": SERVE_AB_ARM}
    if len(sys.argv) > 2 and sys.argv[1] in arms:
        return tree_ab(arms[sys.argv[1]], sys.argv[2:])
    if len(sys.argv) > 2 and sys.argv[1] == "--repeat":
        return repeat(int(sys.argv[2]),
                      float(sys.argv[3]) if len(sys.argv) > 3 else 300.0)
    import faulthandler
    import signal

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    t0 = time.monotonic()
    out = run()
    kernels = []
    for rec in out["records"].values():
        missing = [k for k in RECORD_KEYS if k not in rec]
        require(not missing, f"{rec['name']}: no {missing} measured")
        require(rec["launches"] > 0,
                f"{rec['name']} never launched on the main path")
        kernels.append({k: rec[k] for k in ("name", "route", "source",
                                            "replaces", *RECORD_KEYS)})
    print(f"[done] all phases passed in {time.monotonic() - t0:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(out["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
