#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gofr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from gofr_tpu_torch/ops/csrc (one nvcc per
     source, all started together) and print the build time and what
     ptxas reports per kernel;
  3. hold each kernel against its plain PyTorch version on the card at
     the serving shapes (bf16), and time kernel, plain version and the
     library yardstick (scaled_dot_product_attention, which the port
     never calls);
  4. Llama-3-8B at full width and 4 layers, prefill plus 8 decode steps,
     once through the kernels and once through the plain versions on
     the same inputs: the largest logit difference against a tolerance;
  5. the main path at full width and depth: new_engine_from_config with
     TPU_MODEL=llama3-8b (random weights from seed 0), 8 slots, 2048
     positions, int8 KV, K=4, serving 6 concurrent requests; the launch
     counters show both kernels on the path and the plain versions
     unused; then one more request under torch.profiler gives the
     device's busy share and the kernels that hold it;
  6. a ``{"kernels": [...]}`` line, then the card line, then the
     ``{"ok": true, "device": {...}}`` line last.

It needs the repository beside it and a CUDA card; without either it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
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

# kernel against plain, both bf16: |got - want| <= ATOL + RTOL * |want|.
# Each side rounds its output to bf16 (a step of 2^-7 relative at most),
# and the two round the probabilities to bf16 at different points
# (kernel: per tile, unnormalised; plain: normalised), so they may part
# by about one output step plus a small absolute term
KERNEL_ATOL = 1e-2
KERNEL_RTOL = 2.0 ** -7
TOL = f"tolerance {KERNEL_ATOL} + 2^-7 |plain|"
# random-init logits have unit scale; bf16 activations through 4 layers
# and 8 decode steps drift by a few bf16 steps between the two orders of
# summation
LOGIT_ATOL = 0.1

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
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[build] {source}: {line.strip()}")


# -- phase 3: kernels against their plain versions ----------------------------

def compare(got, want) -> tuple[float, bool]:
    """(max |got - want|, whether every element is within tolerance)."""
    import torch

    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ok = bool(torch.isfinite(g).all()) and bool(
        (diff <= KERNEL_ATOL + KERNEL_RTOL * w.abs()).all())
    return diff.max().item(), ok


def _rng_bf16(gen, shape):
    import torch

    return torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16)


def prefill_case(gen, b: int, s: int, lengths: list[int], record: dict,
                 h: int = 32, kv: int = 8, d: int = 128) -> None:
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
    want = flash.causal_prefill_plain(q, k, v, lens)
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

    ms = graph_ms(flash.flash_prefill, sets, 50)
    plain_ms = graph_ms(flash.causal_prefill_plain, sets, 10)
    library_ms = graph_ms(lib, lib_sets, 50)

    live = sum(lengths)
    n_bytes = 2 * (live * (h + 2 * kv) * d + b * s * h * d) + 4 * b
    n_ops = sum(4 * h * d * n * (n + 1) // 2 for n in lengths)
    bound, by = bound_ms(n_bytes, n_ops, BF16_TENSOR_FLOPS)
    print(f"[kernel] flash_prefill B={b} S={s} H={h} KV={kv} "
          f"lengths={lengths} max_err={err:.3e} ({TOL}) "
          f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
          f"library_ms={library_ms:.5f} bound_ms={bound:.5f} ({by}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    require(ok, f"flash_prefill disagrees with its plain version at "
                f"B={b} S={s} lengths={lengths}: max_err {err}")
    record["max_abs_err"] = max(record.get("max_abs_err", 0.0), err)
    if (b, s) == (1, 512):  # the main path's admission shape
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
    want = flash_decode.decode_plain(*sets[0])
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
          f"lengths={lengths} max_err={err:.3e} ({TOL}) "
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


def phase_kernels(records: dict) -> None:
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    pre = records["flash_prefill"]
    for s in (32, 128, 512):
        for b in (1, 2):
            lengths = [s] if b == 1 else [s, max(1, s // 2 - 5)]
            prefill_case(gen, b, s, lengths, pre)
    prefill_case(gen, 2, 200, [200, 0], pre)    # ragged tile, empty row
    dec = records["flash_decode"]
    edges = [0, 1, 63, 64, 65, 512, 1000, 2047]
    for quant in (True, False):
        decode_case(gen, edges, quant, dec)
        decode_case(gen, [512] * 8, quant, dec, main_shape=quant)


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
    del params


# -- phase 5: the main path ---------------------------------------------------

def profile_decode(engine, prompt, card: str) -> None:
    """One more request through the running engine (its first token from
    the prefill, then 4 blocks of K=4 decode steps) under torch.profiler:
    the device's busy share of the wall time and the kernels that hold
    it. Outside the counted run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        toks = engine.generate(prompt, max_new_tokens=17).tokens()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0)
    require(len(toks) == 17, f"profiled request gave {len(toks)} tokens")
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in rows)
    print(f"[profile] 1 prefill ({len(prompt)} tokens) + 16 decode steps: "
          f"wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}% busy, "
          f"{100 - 100 * busy_ms / wall_ms:.1f}% idle); card: {card}",
          flush=True)
    for name, ms, count in sorted(rows, key=lambda r: -r[1])[:10]:
        print(f"[profile]   {ms:9.3f} ms  {count:6d} x  {name[:90]}")


def phase_main_path(card: str) -> dict:
    import numpy as np
    import torch

    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.ops import flash, flash_decode
    from gofr_tpu_torch.tpu import new_engine_from_config

    cfg = MapConfig({"TPU_MODEL": "llama3-8b", "TPU_SLOTS": "8",
                     "TPU_MAX_SEQ": "2048", "TPU_KV_DTYPE": "int8",
                     "TPU_DECODE_BLOCK": "4"})
    t0 = time.monotonic()
    engine = new_engine_from_config(cfg, device="cuda")
    torch.cuda.synchronize()
    print(f"[main] llama3-8b engine ready in {time.monotonic() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)
    rng = np.random.default_rng(11)
    vocab = engine.generator.cfg.vocab_size
    lens = [17, 500, 123, 256, 64]
    prompts = [rng.integers(0, vocab, n).tolist() for n in lens]
    prompts.append(list(prompts[0]))         # a repeated greedy prompt
    new_tokens = 32
    try:
        # warm the process (cuBLAS handles, first launches) outside the
        # counted run
        warm = engine.generate(prompts[2], max_new_tokens=4).tokens()
        require(len(warm) == 4, f"warm-up gave {len(warm)} tokens")
        gen = engine.generator
        adm0, steps0 = gen.admissions, gen.decode_steps
        flash.reset_counts()
        flash_decode.reset_counts()
        t_start = time.monotonic()
        streams = []
        for i, p in enumerate(prompts):
            sampled = i == 3
            streams.append(engine.generate(
                p, max_new_tokens=new_tokens,
                temperature=0.8 if sampled else 0.0,
                top_k=50 if sampled else 0, seed=5 if sampled else None))
        outs = [s.tokens() for s in streams]
        wall = time.monotonic() - t_start
        counts = {"flash_prefill": flash.launches,
                  "flash_decode": flash_decode.launches,
                  "prefill_plain": flash.plain_calls,
                  "decode_plain": flash_decode.plain_calls}
        admissions = gen.admissions - adm0
        steps = gen.decode_steps - steps0
        stats = gen.stats()
        health = engine.health_check()
        profile_decode(engine, prompts[4], card)
    finally:
        engine.close()
    require(not engine.generator._thread.is_alive(),
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
    require(counts["prefill_plain"] == 0 and counts["decode_plain"] == 0,
            f"plain versions ran on the main path: {counts}")
    ttft = [s.trace["first_put"] - s.trace["submit"] for s in streams]
    total = sum(len(t) for t in outs)
    print(f"[main] {len(prompts)} requests, prompts {lens + [lens[0]]}, "
          f"{new_tokens} new tokens each: {total} tokens in {wall:.3f} s = "
          f"{total / wall:.1f} tok/s; TTFT mean {1e3 * np.mean(ttft):.1f} ms "
          f"max {1e3 * max(ttft):.1f} ms; decode step "
          f"{stats['decode_step_ms_mean']:.2f} ms (host clock, K=4 blocks); "
          f"{admissions} admissions, {steps} decode steps; launches "
          f"{counts}; card: {card}", flush=True)
    return counts


# -- running the phases -------------------------------------------------------

RECORD_KEYS = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
               "bound_by", "library_ms")


def run(phases=("build", "kernels", "model", "main")) -> dict:
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
        else:
            raise SmokeFailure(f"unknown phase {phase!r}")
        torch.cuda.empty_cache()
        print(f"[phase] {phase} done in {time.monotonic() - t0:.1f} s",
              flush=True)
    return {"card": card, "records": records}


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
