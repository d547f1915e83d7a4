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
     edges; both decodes also on and around their chunk edges (the
     split over the cache), at capacity and for one slot of 4096, and
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
     device time and the window's idle share; then a replay of each
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
     then a contiguous spec engine serves a few requests through
     verify_step;
  6. a ``{"kernels": [...]}`` line, then the card line, then the
     ``{"ok": true, "device": {...}}`` line last.

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
"""

from __future__ import annotations

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

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture stream
        for args in arg_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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


def profile_decode(engine, prompt, card: str, tag: str = "profile") -> dict:
    """One more request through the running engine (its first token from
    the prefill, then 4 blocks of K=4 decode steps) under torch.profiler:
    the device's busy share of the wall time, by kind of kernel, and the
    kernels that hold it; beside it the blocks' device time from CUDA
    events. Outside the counted run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = engine.generator
    run = gen._run_block
    spans = timed_blocks(gen)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            toks = engine.generate(prompt, max_new_tokens=17).tokens()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.monotonic() - t0)
    finally:
        gen._run_block = run
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

        replays0 = gen.admission_replays
        got = gen._prefill(slot, request(), blocks and list(blocks))
        replays = gen.admission_replays - replays0
        real = {name: getattr(gen, name) for name in caches}
        for name, c in copies.items():
            setattr(gen, name, c)
        gen._run_admission = eager
        try:
            want = gen._prefill(slot, request(), blocks and list(blocks))
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
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = engine.generator
    bg = [engine.generate(p, max_new_tokens=48) for p in background]
    heads = [next(iter(s)) for s in bg]
    spans = timed_admissions(gen)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            toks = engine.generate(prompt, max_new_tokens=4).tokens()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.monotonic() - t0)
    finally:
        del gen._run_admission
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
    engine = new_engine_from_config(MapConfig(SPEC_ROWS), device="cuda")
    gen = engine.generator
    torch.cuda.synchronize()
    print(f"[spec] llama3-8b paged spec engine ready (verify pass warmed) "
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
        adm0, steps0, passes0, replays0 = (gen.admissions, gen.decode_steps,
                                           gen.verify_passes,
                                           gen.graph_replays)
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
        stats = gen.stats()
        health = engine.health_check()
        want, _, ref_wall = _serve(ref, prompts, {}, new_tokens)
    finally:
        engine.close()
        ref.close()
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
          f"each: {serve_line(stats, streams, outs, wall)}; {passes} verify "
          f"passes ({spec['verify_ms_mean']:.2f} ms mean, host clock), "
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
    require(all(len(x) == 16 for x in couts),
            f"contiguous spec streams of {[len(x) for x in couts]} tokens")
    require(cspec["windows"] > 0, f"contiguous spec engine: {cspec}")
    print(f"[spec] contiguous spec engine (4 slots, 2048 positions, int8): "
          f"4 requests x 16 tokens in {cwall:.3f} s; {cspec}", flush=True)
    return counts


# -- running the phases -------------------------------------------------------

RECORD_KEYS = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
               "bound_by", "library_ms")


def run(phases=("build", "kernels", "model", "main", "paged", "spec")
        ) -> dict:
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
