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
     the plain versions unused, and so does the engine's serving
     timeline (an ``Observe`` bundle's: its decode events' steps and its
     prefill events, 32 launches each; phases ``paged`` and ``spec``
     hold their rings against paged_decode and paged_window the same
     way); then one more request under
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
  5l. (phase ``tenancy``) the multi-tenant serving plane on a
     ``gofr_tpu_torch.App``: Llama-3-8B (phase lora's rows at 16 slots,
     T0 of 4 rows with host RAM behind it, the in-process Redis as
     ``ctx.redis``, the MEM broker, a registry of tenants A, B and C of
     weights 2:1:1 routed to adapters 1-3 and ``capped``, 2 requests a
     second and 2 at once); ``X-Tenant-Id`` and gRPC's ``x-tenant-id``
     routing a request to its tenant and adapter (greedy tokens equal to
     the adapter's untenanted); a burst of 64 + 32 + 32 requests whose
     decode tokens split 2:1:1 (+-15%) while all three wait; A and B
     served while ``capped`` sends 40 at once (its sheds typed 429s,
     none of A's or B's, its concurrency at most 2); T0 budgets (every
     eviction A's own, B's re-query a T0 hit, the ``tenant:A`` lease
     and its reclaim); the async lane (4 jobs, one killed after its
     first checkpoint and resumed with ``continue_from`` after a
     restart); K1 32 a bucket admission and K2 32 a decode step;
  5m. (phase ``gateway``) service clients, auth and the prefix-affinity
     gateway: two replica Apps of Llama-3-8B at phase 5's rows (full
     width and depth, seed-0 weights each, POST /generate, replica B
     with ``enable_apikey_auth``) behind a port gateway App
     (``TPU_SERVING_ROLE=gateway``, block 16, ``enable_basic_auth``, no
     engine): its health lists both replicas UP and a request without
     credentials is a 401 that reaches no replica; 8 sessions of two
     turns (prompts of 17-500 tokens, two sampled with seeds) each
     served by its ring owner and equal to the owner's direct answer,
     with the hop's TTFT overhead; a first attempt lost at the
     GATEWAY_RELAY seam served by the other replica; a 64-token greedy
     stream cut after token 16 at the GATEWAY_MIDSTREAM seam and resumed
     on the ring successor (one stream, equal to the first 16 plus the
     successor's own ``continue_from`` answer; the resume gap and the
     first index parting from the uninterrupted stream printed); a retry
     budget of one token spent on an hbm shed's failover (HBM_ALLOC
     seam), then typed 503s with ``Retry-After`` that reach no replica;
     BASELINE config #5's ``/chat`` (examples/tpu-sharded-70b/gateway.py
     against the port) over B through ``CircuitBreakerOption(3, 2 s)``,
     ``HealthOption`` and ``APIKeyAuthOption``: B's tokens, then B
     stopped, 3 transport failures, the breaker open and its 503s timed,
     a fresh B on B's port and the recovery probe closing it; then
     ``stop(60)`` of replica A with 8 live streams through the gateway:
     every stream complete, new requests served by B; K1 32 a bucket
     admission and K2 32 a decode step over the three replica engines;
  5n. (phase ``pd``) disaggregated prefill/decode serving: two
     ``gofr_tpu_torch.App``s of Llama-3-8B at phase 5's rows (full width
     and depth, seed-0 weights each, POST /generate), P with
     ``TPU_SERVING_ROLE=prefill`` (``TPU_PD_BLOCK=16``,
     ``TPU_RESUME_WAIT_S=60``) shipping int8 prompt KV to D, a
     contiguous ``decode`` worker on a free loopback port: both roles in
     their health, a HELLO with another model's fingerprint refused; 8
     prompts of 17-500 tokens (bucket admissions on P) and 2 of 700 and
     1500 (the lattice on P, shipped mid-chunk), 32 new tokens, two
     seeded sampled, to P one at a time and as a burst of 10, each equal
     to the same request on D's own (fused) POST /generate, with TTFT,
     the handoff gap, ``kv_transfer_s``, bytes and frames shipped, the
     install's device time (its copies alone, on a stream of their own)
     and the loop's stall in the ship window; the typed faults after the
     handoff (a frame torn at the PD_INGEST seam:
     502; the ``pd-ingest`` lease killed at the HBM_ALLOC seam: a 429
     line after token 0; a deadline that ends during D's decode: a 504
     line, counted post-handoff on D), each failing one request only; a
     64-token greedy stream whose decode worker is stopped after token
     16 and re-handed off onto a paged decode worker (129 blocks of 128)
     started on the same address: one stream, equal to the tokens before
     the re-handoff plus that worker's own ``continue_from`` answer; the
     burst again through it, each stream equal to its fused answer; K1
     32 a bucket admission (P's, the re-handoff's included, and D's and
     Dp's fused references), K2 32 a decode step of D, K3 32 a decode
     step of Dp, none on P;
  5o. (phase ``tp``) tensor-parallel serving on the one card: K1, K2,
     K3 and K3w (int8) at the per-rank head counts (16, 4), (8, 2),
     (4, 1) and (8, 1) held against their plain versions and timed;
     then Llama-3-8B at phase 5's rows (full width and depth, seed-0
     weights) at tp=1 (8 greedy streams of 32 tokens, X + S + X prompts'
     first tokens, score logits), freed; then a ``gofr_tpu_torch.App``
     with TPU_SHARDING=tp=2 (this process rank 0, one worker process,
     both on cuda:0, the device group over gloo, dispatches eager): 8
     POST /generate streams and a score of each prompt, the score logits
     within TP_LOGIT_ATOL of tp=1's and every first token equal, each
     stream's first index parting from tp=1's printed, both ranks' carry
     and cursors equal, K1 32 an admission or score dispatch and K2 32 a
     decode step on each rank (counted through ``tp_probe``), the
     leased bytes and building peak of each rank, tok/s, TTFT, the step
     and one all_reduce's time by shape; the App's stop ends the worker;
     then a paged tp=2 engine with TPU_SPEC_DECODE=4 serving 4 X + S + X
     streams: K1, K3 and K3w on both ranks, the same counts on each, a
     first token that differs from tp=1's only at a near tie (within
     TP_TIE_ATOL of the winner in the logits the tp=2 admission sampled
     it from and in tp=1's score logits);
  5p. (phase ``cmd``) the CLI entry point to the main path:
     ``gofr_tpu_torch.new_cmd`` with phase 5's rows (Llama-3-8B at full
     width and depth, seed-0 weights), DB_DIALECT=sqlite with DB_NAME a
     file in a temporary directory, and CMD_LOGS_FILE there too; migration
     1 creates a table and 2 records the model in the model-version
     ledger (``ds.tpu.register_model``): the ledger holds versions 1 and
     2, a second migrate applies nothing, a third that creates a table
     and raises gives MigrationError and leaves no table and 2 ledger
     rows; 8 ``generate`` sub-commands through ``run_command`` (17-500
     tokens, 32 new greedy tokens each, a row in the table through
     ``ctx.sql``): exit code 0, each JSON result on stdout, each stream
     equal to the same prompt through ``engine.generate`` on the same
     engine, 8 rows, flash_prefill 32 a bucket admission and
     flash_decode 32 a decode step, no plain call; an unknown command
     exits 1 with "No Command Found!" and the help on stderr, a raising
     handler exits 1 with its message on stderr; the log file holds log
     lines only, the migration events among them; then the CLI as a
     process of its own (CMD_CLI: Llama-3-8B's width at 2 layers, one
     ``generate`` command) exits 0 by itself with the engine's thread
     still live, inside CMD_PROC_S, its result on stdout; a
     ``{"cmd": {...}}`` line with the migrations applied, the CLI's tok/s
     and TTFT mean, the launches and the subprocess's wall time;
  5q. (phase ``observe``) observability on the main path: a
     ``gofr_tpu_torch.App`` replica of phase 5's rows with the timeline
     on, DEBUG_EVENT_BUFFER, TRACER_HOST/TRACER_PORT on an in-process
     Zipkin collector (localhost) and TPU_TRACE_SAMPLE=0.5, and a gateway
     App naming it in TPU_OBS_PEERS. 16 POST /generate streams with
     traceparents on a TPU_TIMELINE=0 App, then on this one: their tok/s
     and the idle share (the timeline's dispatch gaps over the burst);
     then the 16 under new traceparents with a /debug/pprof/profile
     running and a 17th whose X-Request-Timeout runs out in the queue
     (504): /debug/timeline's decode steps and prefills x 32 equal
     flash_decode's and flash_prefill's launches, slot tracks (8 at
     most) and the hbm:engine counter track; /debug/events holds one
     wide request event a stream, its tokens the stream's and its
     breakdown summing to duration_s, and the 17th's (where "queue");
     /debug/request, /debug/vars (the card's device_kind, timeline,
     trace_sampler, fleet_clock), the profile's stacks of the serving
     loop (gofr-torch-gen), the collector's spans against the tail
     sampler's verdicts (tpu.admit-wait, tpu.prefill, tpu.decode under
     each kept trace id, the expired trace kept), /metrics' dispatch-gap,
     pipeline-depth and segment series, and the gateway's
     /debug/timeline?fleet=1 holding the replica's process, its decode
     slices and its clock aligned; a ``{"observe": {...}}`` line;
  6. a ``{"kernels": [...]}`` line (flash_prefill's launches are phase
     5's, the score run's and phases grpc's, tiers', lora's, tenancy's,
     gateway's, pd's, tp's, cmd's and observe's; flash_decode's phase
     5's and phases grpc's, tiers', lora's, tenancy's, gateway's, pd's,
     tp's, cmd's and observe's;
     paged_decode's phase paged's, lora's, pd's and tp's; paged_window's
     phase spec's and tp's; phase tp's summed over its two ranks),
     then the card line, then the ``{"ok": true, "device": {...}}`` line
     last.

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


def timeline_mark(gen) -> int:
    """The seq the engine's timeline gives its next event."""
    return gen._tl.stats()["total_recorded"]


def timeline_window(gen, seq0: int, steps: int, passes: int = 0,
                    wait_s: float = 5.0, clip=None) -> dict:
    """The engine's timeline since ``seq0``, read once the reaps of the
    ``steps`` decode steps and ``passes`` verify passes dispatched in
    the window have landed (a block is counted at its dispatch and its
    event appended at its reap): the decode events' steps, the verify
    events, the prefill events and the seconds of the dispatch gaps
    (the device stream's idle time between blocks) inside ``clip`` =
    (t0, t1) on the monotonic clock, when given."""
    lo, hi = clip if clip is not None else (-math.inf, math.inf)
    end = time.monotonic() + wait_s
    while True:
        events = [e for e in gen._tl.events() if e[0] >= seq0]
        got = {"decode_steps": sum(e[5] for e in events
                                   if e[3] == "decode"),
               "verify": sum(e[3] == "verify" for e in events),
               "prefill": sum(e[3] == "prefill" for e in events),
               "gap_s": sum(max(0.0, min(e[1] + e[2], hi) - max(e[1], lo))
                            for e in events if e[3] == "gap")}
        if (got["decode_steps"] >= steps and got["verify"] >= passes) \
                or time.monotonic() > end:
            return got
        time.sleep(0.01)


def phase_main_path(card: str) -> dict:
    import numpy as np
    import torch

    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.observe import Observe
    from gofr_tpu_torch.ops import flash, flash_decode
    from gofr_tpu_torch.tpu import new_engine_from_config

    t0 = time.monotonic()
    engine = new_engine_from_config(MapConfig(MAIN_ROWS), device="cuda",
                                    observe=Observe())
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
        seq0 = timeline_mark(gen)
        outs, streams, wall = _serve(engine, prompts, MAIN_SAMPLED,
                                     new_tokens)
        counts = {"flash_prefill": flash.launches,
                  "flash_decode": flash_decode.launches,
                  "prefill_plain": flash.plain_calls,
                  "decode_plain": flash_decode.plain_calls}
        admissions = gen.admissions - adm0
        steps = gen.decode_steps - steps0
        ring = timeline_window(gen, seq0, steps)
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
    print(f"[main] the engine's timeline over the counted run: {ring}; "
          f"card: {card}", flush=True)
    require(counts["flash_decode"] == LAYERS * ring["decode_steps"]
            and counts["flash_prefill"] == LAYERS * ring["prefill"],
            f"the timeline's decode steps and prefills {ring} against the "
            f"launches {counts}")
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

    from gofr_tpu_torch.observe import Observe

    t0 = time.monotonic()
    engine = new_engine_from_config(MapConfig(PAGED_ROWS), device="cuda",
                                    observe=Observe())
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
        seq0 = timeline_mark(gen)
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
        ring = timeline_window(gen, seq0, steps)
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
    print(f"[paged] the engine's timeline over the counted run: {ring}; "
          f"card: {card}", flush=True)
    require(counts["paged_decode"] == LAYERS * ring["decode_steps"]
            and ring["prefill"] == admissions,
            f"the timeline's decode steps and prefills {ring} against "
            f"{counts['paged_decode']} paged_decode launches and "
            f"{admissions} admissions")
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
    from gofr_tpu_torch.observe import Observe
    from gofr_tpu_torch.tpu import GenerationEngine, new_engine_from_config

    t0 = time.monotonic()
    engine = new_engine_from_config(MapConfig(SPEC_ROWS), device="cuda",
                                    params=SHARED.get("params"),
                                    observe=Observe())
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
        seq0 = timeline_mark(gen)
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
        ring = timeline_window(gen, seq0, steps, passes)
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
    print(f"[spec] the engine's timeline over the counted run: {ring}; "
          f"card: {card}", flush=True)
    require(counts["paged_window"] == LAYERS * ring["verify"]
            and counts["paged_decode"] == LAYERS * ring["decode_steps"],
            f"the timeline's verify passes and decode steps {ring} against "
            f"the launches {counts}")
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
                                 "mid-prefill": 1, "mid-decode": 1,
                                 "post-handoff": 0},
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


# -- phase tenancy: the multi-tenant serving plane -----------------------------

TENANCY_DOC = {"tenants": [
    {"id": "A", "weight": 2, "adapter": 1, "cache_share": 0.5},
    {"id": "B", "weight": 1, "adapter": 2, "cache_share": 0.5},
    {"id": "C", "weight": 1, "adapter": 3},
    {"id": "capped", "weight": 1, "adapter": 0, "rps": 2,
     "max_concurrency": 2, "slo_class": "throughput"}]}
# phase lora's rows, with a burst that saturates 16 slots, T0 of 4 rows
# over host RAM, the lane's broker and registry; a gate far above every
# burst, so that any shed it counts but the tenant quota's shows
TENANCY_ROWS = dict(LORA_ROWS, GRPC_PORT="0", TPU_SLOTS="16",
                    TPU_PREFIX_CACHE="4", TPU_PREFIX_MIN="256",
                    TPU_KVCACHE_HOST_MB="256", PUBSUB_BACKEND="MEM",
                    CONSUMER_ID="tenancy-lane",
                    TPU_TENANT_CHECKPOINT_EVERY="8",
                    TPU_MAX_QUEUE_DEPTH="512",
                    TPU_TENANTS_INLINE=json.dumps(TENANCY_DOC))
TENANCY_SEED = 67
TENANCY_BURST = {"A": 64, "B": 32, "C": 32}   # requests a tenant, at once
TENANCY_LENS = (64, 128)      # the burst's prompts: one bucket each (K1)
TENANCY_NEW = 48
TENANCY_SHARE_TOL = 0.15      # relative, tools/tenant_bench.py's
TENANCY_QUOTA_EACH = 8        # A's and B's requests a round
TENANCY_CAPPED = 40           # capped's requests, at once
TENANCY_STORE_LEN = 300       # a stored prompt (>= TPU_PREFIX_MIN)
TENANCY_JOBS = 4              # async-lane jobs (tenants A, B, A, B)
TENANCY_JOB_LEN = 200
TENANCY_JOB_NEW = 64
TENANCY_KILL_AT = 9           # the last job's handler dies at this token
TENANCY_WAIT_S = 120


def tenancy_routes(app) -> None:
    """The phase's HTTP route and gRPC method: each reports the tenant
    the handler sees (``ctx.tenant``) beside its stream's tenant, adapter
    and class."""
    from gofr_tpu_torch.grpcx import GRPCService

    @app.post("/generate")
    def generate(ctx):
        body = ctx.bind()
        s = ctx.tpu.generate(body["tokens"],
                             max_new_tokens=body.get("max_new_tokens", 16),
                             adapter=body.get("adapter", 0))
        return {"tokens": s.tokens(), "tenant": ctx.tenant,
                "stream_tenant": s.tenant, "adapter": s.adapter,
                "slo_class": s.slo_class}

    svc = GRPCService("tenancy.Generation")

    @svc.server_stream("Generate")
    def generate_grpc(ctx, req):
        s = ctx.tpu.generate(req["tokens"],
                             max_new_tokens=req.get("max_new_tokens", 16))
        yield {"tenant": ctx.tenant, "stream_tenant": s.tenant,
               "adapter": s.adapter}
        for t in s:
            yield {"token": int(t)}

    app.register_grpc_service(svc)


def _tenant_generate(port: int, prompt, tenant=None, new: int = 16,
                     adapter: int = 0) -> dict:
    """POST /generate with ``X-Tenant-Id`` (when given): the route's
    answer, or status and headers of a refusal."""
    out = http_call(port, "POST", "/generate",
                    {"tokens": prompt, "max_new_tokens": new,
                     "adapter": adapter},
                    {"X-Tenant-Id": tenant} if tenant else None)
    if out["status"] == 200:
        return {"status": 200, **out["lines"][0]["data"]}
    return {"status": out["status"], "headers": out["headers"]}


def _tenant_grpc(port: int, prompt, tenant: str, new: int = 16) -> list:
    ch = grpc_channel(port)
    try:
        return list(ch.server_stream(
            "/tenancy.Generation/Generate",
            {"tokens": prompt, "max_new_tokens": new},
            metadata={"x-tenant-id": tenant}, timeout=APP_CALL_TIMEOUT_S))
    finally:
        ch.close()


class _KillOnce:
    """The lane's engine: the first stream of ``prompt`` dies after
    ``n`` tokens (the worker's crash after its first checkpoint), its
    stream cancelled; everything else passes through."""

    def __init__(self, engine, prompt, n: int):
        self.engine = engine
        self.prompt = list(prompt)
        self.n = n
        self.armed = True
        self.fired = False

    def generate(self, tokens, **kw):
        stream = self.engine.generate(tokens, **kw)
        if not self.armed or list(tokens) != self.prompt:
            return stream
        self.armed = False

        def die():
            for i, item in enumerate(stream):
                if i >= self.n:
                    stream.cancel()
                    self.fired = True
                    raise RuntimeError("lane worker killed mid-job")
                yield item
        return die()


def _pctl(values, q):
    import numpy as np

    return float(np.percentile(values, q)) if values else float("nan")


def phase_tenancy(card: str) -> dict:
    """The multi-tenant serving plane on ``gofr_tpu_torch.App`` at full
    width and depth (Llama-3-8B int8, 16 slots, adapters 1-3 installed
    with ``load_adapter`` from seeded tensors): routing by
    ``X-Tenant-Id`` and ``x-tenant-id``; the weighted fair share of a
    saturating burst; quota isolation of ``capped``; per-tenant T0
    budgets with the ``tenant:A`` lease; the async lane's kill and
    resume over the MEM broker with checkpoints in the in-process
    Redis. K1 32 a bucket admission, K2 32 a decode step, no plain
    version. Returns the launch counts."""
    import gc
    import threading

    import numpy as np
    import torch

    from gofr_tpu_torch import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.datasource.pubsub import mem, new_pubsub_client
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.resilience import SLO_THROUGHPUT, slo_scope
    from gofr_tpu_torch.subscriber import SubscriptionManager
    from gofr_tpu_torch.tenancy import install_async_lane, tenant_scope
    from gofr_tpu_torch.testutil.redisfake import FakeRedisServer
    from gofr_tpu_torch.tpu import hbm

    gc.collect()
    torch.cuda.empty_cache()
    mem.reset()
    redis = FakeRedisServer()
    rows = dict(TENANCY_ROWS, REDIS_HOST=redis.host,
                REDIS_PORT=str(redis.port))
    t0 = time.monotonic()
    app = App(MapConfig(rows))
    tenancy_routes(app)
    tpu = app.container.tpu
    gen = tpu.generator
    plane = tpu.tenancy
    kvc = gen._kvc
    cfg = gen.cfg
    layers = cfg.n_layers
    rank = int(gen.params["layers"]["lora_a_wq"].shape[-1])
    rng = np.random.default_rng(TENANCY_SEED)
    for k in (1, 2, 3):
        arng = np.random.default_rng(TENANCY_SEED * 100 + k)
        gen.load_adapter(k, {
            name: ((arng.standard_normal((layers, din, rank), np.float32)
                    * din ** -0.5).astype(np.float16),
                   (arng.standard_normal((layers, rank, dout), np.float32)
                    * LORA_B_SCALE).astype(np.float16))
            for name, (din, dout) in llama._lora_dims(cfg).items()})
    lane = install_async_lane(app)
    app.run(block=False)
    torch.cuda.synchronize()
    built_s = time.monotonic() - t0
    port = app.http_port
    vocab = cfg.vocab_size

    def prompt(n):
        return rng.integers(0, vocab, int(n)).tolist()

    kinds: dict = {}
    run_admission = gen._run_admission

    def counted(key):
        kinds[key[0]] = kinds.get(key[0], 0) + 1
        return run_admission(key)

    gen._run_admission = counted
    streams, lock = [], threading.Lock()
    generate = tpu.generate

    def tracked(*args, **kw):
        s = generate(*args, **kw)
        with lock:
            streams.append(s)
        return s

    tpu.generate = tracked
    steps0 = gen.decode_steps
    _reset_launches()
    restarted = None
    try:
        # 1. routing
        p1 = prompt(40)
        via_a = _tenant_generate(port, p1, "A")
        plain_1 = _tenant_generate(port, p1, None, adapter=1)
        explicit = _tenant_generate(port, p1, "A", adapter=2)
        unknown = _tenant_generate(port, p1, "nobody")
        g_a = _tenant_grpc(app.grpc_port, p1, "A")
        g_unknown = _tenant_grpc(app.grpc_port, p1, "nobody")
        routing = {
            "http_A": (via_a["tenant"], via_a["stream_tenant"],
                       via_a["adapter"]),
            "grpc_A": (g_a[0]["tenant"], g_a[0]["stream_tenant"],
                       g_a[0]["adapter"]),
            "http_unknown": (unknown["tenant"], unknown["adapter"]),
            "grpc_unknown": (g_unknown[0]["tenant"], g_unknown[0]["adapter"]),
            "explicit": explicit["adapter"],
            "A_equals_adapter_1": via_a["tokens"] == plain_1["tokens"],
            "grpc_equals_http": [m["token"] for m in g_a[1:]]
            == via_a["tokens"],
            "adapter_1_parts_from_0": plain_1["tokens"]
            != unknown["tokens"]}
        print(f"[tenancy] App with {rows['TPU_MODEL']} ({rows['TPU_SLOTS']} "
              f"slots, {rows['TPU_MAX_SEQ']} positions, adapters 1-3 of rank "
              f"{rank} installed with load_adapter, T0 of "
              f"{rows['TPU_PREFIX_CACHE']} rows, tenants "
              f"{[t['id'] for t in TENANCY_DOC['tenants']]}) ready in "
              f"{built_s:.1f} s; routing {routing}; card: {card}",
              flush=True)
        require(routing["http_A"] == ("A", "A", 1)
                and routing["grpc_A"] == ("A", "A", 1)
                and routing["http_unknown"] == ("default", 0)
                and routing["grpc_unknown"] == ("default", 0)
                and routing["explicit"] == 2,
                f"tenant routing: {routing}")
        require(routing["A_equals_adapter_1"] and routing["grpc_equals_http"]
                and routing["adapter_1_parts_from_0"],
                f"tenant A's tokens: {routing}")

        # 2. the weighted fair share of a saturating burst
        deliveries, admits = [], []
        deliver, start = gen._deliver, gen._start

        def logged_deliver(idx, slot, token, lp=None):
            deliveries.append((time.monotonic(), slot.request.tenant))
            return deliver(idx, slot, token, lp)

        def logged_start(idx, slot, req, blocks=None):
            admits.append((time.monotonic(), req.tenant))
            return start(idx, slot, req, blocks)

        order = ["A", "B", "A", "C"] * (TENANCY_BURST["B"])
        lens = rng.integers(TENANCY_LENS[0], TENANCY_LENS[1] + 1,
                            len(order))
        burst_prompts = [prompt(n) for n in lens]
        gen._deliver, gen._start = logged_deliver, logged_start
        try:
            with gen._device_lock:
                burst = []
                for t, p in zip(order, burst_prompts):
                    with tenant_scope(t):
                        burst.append(tpu.generate(
                            p, max_new_tokens=TENANCY_NEW))
                queued_by_tenant = gen.stats()["scheduler"][
                    "queued_by_tenant"]
                gauges = [ln for ln in app.container.metrics
                          .render_prometheus().splitlines()
                          if ln.startswith("app_tpu_queue_depth")
                          and "tenant=" in ln]
            t_burst = time.monotonic()
            outs = [s.tokens() for s in burst]
            burst_s = time.monotonic() - t_burst
        finally:
            del gen._deliver, gen._start
        require(all(len(o) == TENANCY_NEW for o in outs),
                "a burst stream came short")
        last_admit = {t: max(a for a, tt in admits if tt == t)
                      for t in TENANCY_BURST}
        w0 = min(a for a, _ in admits)
        w1 = min(last_admit.values())
        window = [t for a, t in deliveries if w0 <= a <= w1]
        weights = {t["id"]: t["weight"] for t in TENANCY_DOC["tenants"]}
        wsum = sum(weights[t] for t in TENANCY_BURST)
        shares = {t: window.count(t) / len(window) for t in TENANCY_BURST}
        rel = {t: abs(shares[t] / (weights[t] / wsum) - 1.0)
               for t in TENANCY_BURST}
        first16 = [t for _, t in admits[:gen.n_slots]]
        print(f"[tenancy] fair share: {len(burst)} requests "
              f"({TENANCY_BURST}) of {TENANCY_LENS[0]}-{TENANCY_LENS[1]} "
              f"tokens, {TENANCY_NEW} new, queued at once; at the window's "
              f"start queued_by_tenant {queued_by_tenant}, gauges {gauges}; "
              f"first {gen.n_slots} admissions {''.join(first16)}; "
              f"{len(window)} decode tokens in {w1 - w0:.3f} s while all "
              f"three waited: shares "
              f"{ {t: round(v, 4) for t, v in shares.items()} } against "
              f"{ {t: round(weights[t] / wsum, 4) for t in TENANCY_BURST} } "
              f"(relative error "
              f"{ {t: round(v, 4) for t, v in rel.items()} }); the burst "
              f"{len(burst) * TENANCY_NEW / burst_s:.1f} tok/s in "
              f"{burst_s:.3f} s; card: {card}", flush=True)
        require(queued_by_tenant == TENANCY_BURST,
                f"queued_by_tenant {queued_by_tenant}")
        require(max(rel.values()) <= TENANCY_SHARE_TOL,
                f"fair shares {shares} outside "
                f"{TENANCY_SHARE_TOL:.0%} of 2:1:1")

        # 3. quota isolation
        def round_ab(extra_capped: int) -> dict:
            del streams[:]
            jobs = [("A", prompt(40)) for _ in range(TENANCY_QUOTA_EACH)] + \
                [("B", prompt(40)) for _ in range(TENANCY_QUOTA_EACH)] + \
                [("capped", prompt(40)) for _ in range(extra_capped)]
            peak = [0]
            stop = threading.Event()

            def watch():
                while not stop.is_set():
                    peak[0] = max(peak[0], plane.quotas.active("capped"))
                    time.sleep(0.0005)

            w = threading.Thread(target=watch, daemon=True)
            w.start()
            try:
                res = _threads([lambda t=t, p=p: (t, _tenant_generate(
                    port, p, t)) for t, p in jobs])
            finally:
                stop.set()
                w.join(5)
            ttft = {t: [1e3 * (s.trace["first_put"] - s.trace["submit"])
                        for s in list(streams) if s.tenant == t]
                    for t in ("A", "B")}
            return {"res": res, "ttft": ttft, "peak": peak[0]}

        shed0 = gen.gate.stats()["sheds"]
        calm = round_ab(0)
        busy = round_ab(TENANCY_CAPPED)
        capped = [r for t, r in busy["res"] if t == "capped"]
        c429 = [r for r in capped if r["status"] == 429]
        c200 = [r for r in capped if r["status"] == 200]
        typed = all(r["headers"].get("X-Shed-Reason") == "tenant_quota"
                    and float(r["headers"].get("Retry-After", 0)) > 0
                    for r in c429)
        ab_bad = [r["status"] for t, r in calm["res"] + busy["res"]
                  if t != "capped" and r["status"] != 200]
        tstats = plane.stats()["tenants"]
        shed_lines = _scraped(app, "app_tpu_shed_total{")
        tenant_gauge = _total(_scraped(app,
                                       'app_tpu_tenant_shed{tenant="capped"}'))
        gate_sheds = gen.gate.stats()["sheds"] - shed0
        end = time.monotonic() + 10
        while any(v["active"] for v in plane.stats()["tenants"].values()) \
                and time.monotonic() < end:
            time.sleep(0.01)
        active_after = {t: v["active"]
                        for t, v in plane.stats()["tenants"].items()}

        def tt(r, t):
            return (f"p50 {_pctl(r['ttft'][t], 50):.1f} ms p95 "
                    f"{_pctl(r['ttft'][t], 95):.1f} ms")

        print(f"[tenancy] quota: A and B {TENANCY_QUOTA_EACH} requests each "
              f"over HTTP, alone then beside {TENANCY_CAPPED} of capped "
              f"(rps 2, 2 at once) at once: capped {len(c200)} served, "
              f"{len(c429)} 429 (all typed tenant_quota with Retry-After: "
              f"{typed}), its live concurrency at most {busy['peak']}; "
              f"app_tpu_tenant_shed{{tenant=capped}} {tenant_gauge:.0f}; the "
              f"gate's sheds {gate_sheds} ({shed_lines}); A and B refused "
              f"{ab_bad}; plane sheds A {tstats['A']['shed']} B "
              f"{tstats['B']['shed']}; live after {active_after}; TTFT "
              f"alone A {tt(calm, 'A')}, B {tt(calm, 'B')}; beside capped A "
              f"{tt(busy, 'A')}, B {tt(busy, 'B')}; card: {card}", flush=True)
        require(len(c429) + len(c200) == TENANCY_CAPPED and c429 and typed,
                f"capped's answers: {[r['status'] for r in capped]}")
        require(tenant_gauge == len(c429) == tstats["capped"]["shed"],
                f"capped's sheds: gauge {tenant_gauge}, 429s {len(c429)}, "
                f"plane {tstats['capped']['shed']}")
        require(not ab_bad and tstats["A"]["shed"] == tstats["B"]["shed"]
                == 0, f"A or B shed: {ab_bad}")
        require(gate_sheds == len(c429) and all(
            'tenant="capped"' in ln for ln in shed_lines),
            f"the gate shed other than capped's quota: {gate_sheds} "
            f"{shed_lines}")
        require(busy["peak"] <= 2 and not any(active_after.values()),
                f"live concurrency: peak {busy['peak']}, after "
                f"{active_after}")

        # 4. the T0 budgets
        stored = {"A": [prompt(TENANCY_STORE_LEN) for _ in range(7)],
                  "B": [prompt(TENANCY_STORE_LEN) for _ in range(2)]}
        victims = []
        offload = gen._offload_victim

        def seen(victim):
            if victim is not None:
                victims.append(victim.key.tolist())
            return offload(victim)

        def store(t, i):
            r = _tenant_generate(port, stored[t][i], t, new=1)
            require(r["status"] == 200, f"store {t}{i}: {r}")

        gen._offload_victim = seen
        try:
            for i in range(3):
                store("A", i)
            over = dict(kvc.tenant_rows())
            lease = [r for r in hbm.arbiter_stats()["leases"]
                     if r["tag"] == "tenant:A"]
            reg = hbm._registry
            (key,) = [k for k in reg._meta if k[2] == "tenant:A"]
            reg._deref_reclaim(reg._meta[key][1])(1)
            after_reclaim = dict(kvc.tenant_rows())
            reclaimed = list(victims)
            lease_after = [r for r in hbm.arbiter_stats()["leases"]
                           if r["tag"] == "tenant:A"]
            for i in range(2):
                store("B", i)
            ev0 = kvc.t0.evictions
            del victims[:]
            for i in range(3, 7):
                store("A", i)
            evictions = kvc.t0.evictions - ev0
        finally:
            del gen._offload_victim
        a_keys = stored["A"]
        b_indexed = [kvc.covered(np.asarray(p, np.int32),
                                 plane.resolve("B").adapter)
                     for p in stored["B"]]
        hit = _tenant_generate(port, stored["B"][0] + prompt(24), "B", new=4)
        hit_stream = streams[-1]
        print(f"[tenancy] T0 budgets (4 rows, A and B a half each): A stored "
              f"3 -> rows {over}, lease {lease}; the lease's reclaim evicted "
              f"{len(reclaimed)} row(s), A's: "
              f"{all(v in a_keys for v in reclaimed)} -> rows "
              f"{after_reclaim}, lease {lease_after}; B stored 2, A 4 more: "
              f"{evictions} evictions, all A's: "
              f"{all(v in a_keys for v in victims)}; rows "
              f"{kvc.tenant_rows()}; B's rows indexed {b_indexed}; B's "
              f"re-query tier {hit_stream.cache_tier}, cache_tokens "
              f"{hit_stream.cache_tokens}; card: {card}", flush=True)
        require(over == {"A": 3} and len(lease) == 1
                and lease[0]["reclaimable"], f"A over its share: {over} "
                f"{lease}")
        require(after_reclaim == {"A": 2} and len(reclaimed) == 1
                and reclaimed[0] == stored["A"][0] and not lease_after,
                f"the reclaim: {after_reclaim}, {len(reclaimed)} victims")
        require(evictions == 4 and len(victims) == 4
                and all(v in a_keys for v in victims)
                and kvc.tenant_rows() == {"A": 2, "B": 2},
                f"evictions {evictions}: A's {victims}")
        require(all(b_indexed) and hit["status"] == 200
                and hit_stream.cache_tier == "t0"
                and hit_stream.cache_tokens >= TENANCY_STORE_LEN - 16,
                f"B's re-query: {b_indexed} {hit_stream.cache_tier} "
                f"{hit_stream.cache_tokens}")

        # 5. the async lane
        jobs = [{"job_id": f"job-{j}", "tenant": "AB"[j % 2],
                 "tokens": prompt(TENANCY_JOB_LEN),
                 "max_new": TENANCY_JOB_NEW} for j in range(TENANCY_JOBS)]
        killed = jobs[-1]
        killer = lane.engine = _KillOnce(tpu, killed["tokens"],
                                         TENANCY_KILL_AT)
        client = app.container.redis

        def doc(j):
            raw = client.get(f"async:{j['job_id']}")
            return json.loads(raw) if raw else None

        t_pub = time.monotonic()
        for j in jobs:
            app.container.pubsub.publish("inference-jobs", j)
        end = time.monotonic() + TENANCY_WAIT_S
        while time.monotonic() < end and not (
                killer.fired and all((doc(j) or {}).get("status") == "done"
                                     for j in jobs[:-1])):
            time.sleep(0.01)
        t_first = time.monotonic()
        # the worker restarts (its thread joined after the failed job's
        # checkpoint): a fresh client of the same consumer group resumes
        # from the committed offset, which the kill left behind
        app.subscription_manager.stop()
        mid = doc(killed)
        app.container.pubsub = new_pubsub_client(
            "MEM", app.config, app.logger, app.container.metrics)
        restarted = SubscriptionManager(app.container)
        restarted.register("inference-jobs", lane.handle)
        restarted.start()
        while time.monotonic() < end and \
                (doc(killed) or {}).get("status") != "done":
            time.sleep(0.01)
        t_done = time.monotonic()
        docs = [doc(j) for j in jobs]
        with tenant_scope(killed["tenant"]), slo_scope(SLO_THROUGHPUT):
            ref = tpu.generate(killed["tokens"],
                               max_new_tokens=TENANCY_JOB_NEW).tokens()
        spliced = docs[-1]["tokens"] if docs[-1] else []
        print(f"[tenancy] async lane: {TENANCY_JOBS} jobs of "
              f"{TENANCY_JOB_LEN} tokens, {TENANCY_JOB_NEW} new (tenants "
              f"{[j['tenant'] for j in jobs]}), checkpoints every "
              f"{rows['TPU_TENANT_CHECKPOINT_EVERY']}; the last job's worker "
              f"killed at token {TENANCY_KILL_AT}: its checkpoint "
              f"{mid and (mid['status'], len(mid['tokens']))}; "
              f"{TENANCY_JOBS - 1} done and the killed one checkpointed in "
              f"{t_first - t_pub:.3f} s "
              f"({(TENANCY_JOBS - 1) / (t_first - t_pub):.2f} jobs/s), the "
              f"resumed one done {t_done - t_first:.3f} s after the kill "
              f"({TENANCY_JOBS / (t_done - t_pub):.2f} jobs/s over all "
              f"{TENANCY_JOBS}); "
              f"lane {lane.stats()}; the spliced stream against the "
              f"uninterrupted one: {splice_agreement(spliced, ref)}; card: "
              f"{card}", flush=True)
        require(all(d is not None and d["status"] == "done"
                    and len(d["tokens"]) == TENANCY_JOB_NEW for d in docs),
                f"lane documents {docs}")
        require(lane.stats()["done"] == TENANCY_JOBS
                and lane.stats()["resumed"] == 1,
                f"lane counters {lane.stats()}")
        require(mid is not None and mid["status"] == "running"
                and len(mid["tokens"]) >= 8,
                f"the killed job's checkpoint {mid}")
        require(docs[-1]["tokens"][:len(mid["tokens"])] == mid["tokens"],
                "the resumed job lost its emitted prefix")

        counts = _launches()
        bucket = kinds.get("prefill", 0)
        steps = gen.decode_steps - steps0
        # the burst's decode step on the idle engine: every slot live at
        # the burst's lengths, on the tenants' adapters in its mix
        routed = {t["id"]: t["adapter"] for t in TENANCY_DOC["tenants"]}
        block_ms = block_device_ms(
            gen, [int(n) + TENANCY_NEW // 2
                  for n in np.resize(lens, gen.n_slots)],
            [routed[t] for t in np.resize(order, gen.n_slots)],
            LORA_BLOCK_REPS)
        print(f"[tenancy] {bucket} bucket admissions, admission dispatches "
              f"by kind {kinds}, {steps} decode steps; launches {counts}; a "
              f"decode block (K={gen.decode_block}, {gen.n_slots} slots live "
              f"at the burst's lengths on its adapters, CUDA events, median "
              f"of {LORA_BLOCK_REPS}) {block_ms:.3f} ms; card: {card}",
              flush=True)
        require(counts["flash_prefill"] == layers * bucket and bucket > 0,
                f"flash_prefill launched {counts['flash_prefill']} times for "
                f"{bucket} bucket admissions of {layers} layers")
        require(counts["flash_decode"] == layers * steps and steps > 0,
                f"flash_decode launched {counts['flash_decode']} times for "
                f"{steps} decode steps of {layers} layers")
        require(counts["prefill_plain"] == counts["decode_plain"]
                == counts["paged_decode"] == counts["paged_plain"] == 0,
                f"a plain version or another kernel ran: {counts}")
    finally:
        if restarted is not None:
            restarted.stop()
        app.stop()
        release_graphs(gen)
        redis.close()
        mem.reset()
    return {"flash_prefill": counts["flash_prefill"],
            "flash_decode": counts["flash_decode"]}


GATEWAY_ROWS = dict(MAIN_ROWS, HTTP_PORT="0", METRICS_PORT="0",
                    LOG_LEVEL="WARN", TPU_KVCACHE_BLOCK="16")
GATEWAY_BLOCK = 16            # TPU_GATEWAY_BLOCK == the replicas' block
GATEWAY_SEED = 71
GATEWAY_PROMPTS = 8           # sessions, two turns each
GATEWAY_LENS = (17, 500)      # turn 1's prompt lengths: bucket admissions
GATEWAY_TAIL = 8              # turn 2 = turn 1 + its answer + this many
GATEWAY_NEW = 32
GATEWAY_SAMPLED = {2: 701, 5: 705}   # session -> seed (temperature 0.8,
#                                      top-k 50), both turns
GATEWAY_RESUME = (300, 64, 16)       # prompt, new tokens, the cut
GATEWAY_SHED_LEN = 200        # cache-heavy (>= 4 blocks): the hbm hold
GATEWAY_BREAKER = (3, 2.0)    # config #5: threshold, recovery interval
GATEWAY_OPEN_CALLS = 20       # /chat calls timed while the breaker is open
GATEWAY_DRAIN_NEW = 160       # the drain's 8 streams
GATEWAY_DRAIN_LENS = (64, 400)   # their prompts and the late ones
GATEWAY_LATE = 4              # new requests sent while it drains
GATEWAY_KEY = "chip-smoke-key"            # replica B's X-API-KEY
GATEWAY_USER = ("smoke", "chip-smoke-pw")  # the gateway's basic auth
GATEWAY_RECOVER_S = 60


def _hit_counter(app) -> dict:
    """Count the POST /generate requests that reach ``app``'s handler
    (innermost middleware: a drain 503 or a 401 is not a hit)."""
    hits = {"n": 0}

    def mw(next_h):
        def wrapped(req, w):
            if req.method == "POST" and req.path == "/generate":
                hits["n"] += 1
            next_h(req, w)
        return wrapped

    app.router.use(mw)
    return hits


def _timed_generate(port: int, body: dict, headers=None,
                    on_first=None, on_line=None) -> dict:
    """POST /generate over its own connection: status, headers, the
    ndjson lines and the client's clock at the send and at each line;
    ``on_first()`` is called when the first line arrives, ``on_line(n)``
    after the n-th."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=APP_CALL_TIMEOUT_S)
    try:
        t_send = time.monotonic()
        conn.request("POST", "/generate", body=json.dumps(body),
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        out = {"status": resp.status, "headers": dict(resp.getheaders()),
               "t_send": t_send, "lines": [], "times": []}
        if resp.status != 200:
            raw = resp.read()
            out["body"] = json.loads(raw) if raw.startswith(b"{") else raw
            return out
        for line in resp:
            if line.strip():
                out["times"].append(time.monotonic())
                out["lines"].append(json.loads(line))
                if on_first is not None and len(out["lines"]) == 1:
                    on_first()
                if on_line is not None:
                    on_line(len(out["lines"]))
        return out
    finally:
        conn.close()


def _tokens(res: dict) -> list:
    return [ln["token"] for ln in res["lines"] if "token" in ln]


def _replica_app(rows: dict, apikey: bool):
    """A replica: a gofr_tpu_torch.App with POST /generate on "cuda",
    its hit counter, running."""
    from gofr_tpu_torch import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.serving import install_generate

    app = App(MapConfig(rows))
    install_generate(app)
    if apikey:
        app.enable_apikey_auth(GATEWAY_KEY)
    hits = _hit_counter(app)
    app.run(block=False)
    return app, hits


def chat_routes(app) -> None:
    """examples/tpu-sharded-70b/gateway.py's /chat, against the port."""
    from gofr_tpu_torch.errors import HTTPError, ServiceUnavailable
    from gofr_tpu_torch.service import CircuitOpenError

    @app.post("/chat")
    def chat(ctx):
        body = ctx.bind()
        try:
            r = ctx.get_http_service("llm").post("/generate", body=body)
        except CircuitOpenError:
            raise ServiceUnavailable("model backend circuit open")
        except Exception as e:  # transport failure (counts toward the breaker)
            raise HTTPError(f"model backend unreachable: {type(e).__name__}",
                            status_code=502)
        if not r.ok:
            raise HTTPError(f"model backend {r.status_code}", status_code=502)
        tokens = [json.loads(line)["token"]
                  for line in r.body.decode().splitlines() if line]
        return {"tokens": tokens}


def phase_gateway(card: str) -> dict:
    """Service clients, auth and the prefix-affinity gateway on the card:
    two full-width Llama-3-8B replica Apps (phase 5's contiguous int8
    engine, seed-0 weights each, POST /generate; B with
    enable_apikey_auth) behind a gofr_tpu_torch gateway App
    (TPU_SERVING_ROLE=gateway, enable_basic_auth, no engine): health and
    a 401, affinity with direct-equal streams, failover before the first
    token, a mid-stream resume on the ring successor, the retry budget's
    typed 503, BASELINE config #5's /chat behind a circuit breaker while
    B dies and a fresh B starts on its port, and a rolling drain with 8
    live streams. K1 32 a bucket admission, K2 32 a decode step, no plain
    version. Returns the launch counts."""
    import base64
    import gc
    import threading

    import numpy as np
    import torch

    from gofr_tpu_torch import App, chaos
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.gateway.router import RetryBudget
    from gofr_tpu_torch.service import (APIKeyAuthOption,
                                        CircuitBreakerOption, HealthOption)
    from gofr_tpu_torch.tpu.kvcache import first_block_hash

    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(GATEWAY_SEED)
    kinds: dict = {}
    engines: list = []

    def counted_engine(app):
        gen = app.container.tpu.generator
        run_admission = gen._run_admission

        def counted(key):
            kinds[key[0]] = kinds.get(key[0], 0) + 1
            return run_admission(key)

        gen._run_admission = counted
        engines.append((gen, gen.decode_steps))
        return gen

    t0 = time.monotonic()
    a, hits_a = _replica_app(dict(GATEWAY_ROWS, APP_NAME="replica-a"), False)
    b = gw = chat = None
    apps = [a]
    try:
        b, hits_b = _replica_app(dict(GATEWAY_ROWS, APP_NAME="replica-b"),
                                 True)
        apps.append(b)
        for app in (a, b):
            counted_engine(app)
        torch.cuda.synchronize()
        built_s = time.monotonic() - t0
        # the gateway's and /chat's clients log each transport failure
        # at ERROR: the phase provokes them and counts them itself
        gw = App(MapConfig({
            "HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "FATAL",
            "APP_NAME": "gateway", "TPU_SERVING_ROLE": "gateway",
            "TPU_GATEWAY_BLOCK": str(GATEWAY_BLOCK),
            "TPU_GATEWAY_HEALTH_INTERVAL_S": "0.5",
            "TPU_GATEWAY_REPLICAS": f"127.0.0.1:{a.http_port},"
                                    f"127.0.0.1:{b.http_port}"}))
        gw.enable_basic_auth({GATEWAY_USER[0]: GATEWAY_USER[1]})
        gw.run(block=False)
        apps.append(gw)
        g = gw._gateway
        reps = [a, b]
        hits = [hits_a, hits_b]
        creds = base64.b64encode(":".join(GATEWAY_USER).encode()).decode()
        auth = {"Authorization": f"Basic {creds}", "X-API-KEY": GATEWAY_KEY}
        direct_h = {"X-API-KEY": GATEWAY_KEY}
        vocab = a.container.tpu.generator.cfg.vocab_size
        layers = a.container.tpu.generator.cfg.n_layers

        def prompt(n):
            return rng.integers(0, vocab, int(n)).tolist()

        def owners(p):
            return g.router.ring.order(first_block_hash(p, GATEWAY_BLOCK))

        def hit_counts():
            return [h["n"] for h in hits]

        def through(body, headers=auth):
            before = hit_counts()
            res = _timed_generate(gw.http_port, body, headers)
            res["served"] = [x - y for x, y in zip(hit_counts(), before)]
            return res

        _reset_launches()

        # 1. health and auth
        health = http_call(gw.http_port, "GET", "/.well-known/health")
        services = health["body"]["data"].get("services", {})
        before = hit_counts()
        denied = _timed_generate(gw.http_port,
                                 {"tokens": prompt(40), "max_new": 4})
        print(f"[gateway] two replica Apps of {GATEWAY_ROWS['TPU_MODEL']} "
              f"({GATEWAY_ROWS['TPU_SLOTS']} slots, "
              f"{GATEWAY_ROWS['TPU_MAX_SEQ']} positions, int8 KV, K="
              f"{GATEWAY_ROWS['TPU_DECODE_BLOCK']}) ready in {built_s:.1f} s, "
              f"behind the port's gateway (block {GATEWAY_BLOCK}, no engine: "
              f"{gw.container.tpu is None}); health services "
              f"{ {k: v['status'] for k, v in services.items()} }; no "
              f"credentials: {denied['status']}, replica hits "
              f"{before} -> {hit_counts()}; card: {card}", flush=True)
        require(gw.container.tpu is None, "the gateway App built an engine")
        require(sorted(services) == ["gateway-replica-0", "gateway-replica-1"]
                and all(v["status"] == "UP" for v in services.values()),
                f"gateway health services {services}")
        require(denied["status"] == 401 and hit_counts() == before,
                f"an unauthenticated request: {denied['status']}, hits "
                f"{before} -> {hit_counts()}")

        # 2. affinity: 8 sessions of two turns, each against the same
        # request sent to its owner directly
        lens = rng.integers(GATEWAY_LENS[0], GATEWAY_LENS[1] + 1,
                            GATEWAY_PROMPTS)
        ttft_gw, ttft_direct, rows_ = [], [], []
        for i, n in enumerate(lens):
            p = prompt(n)
            for turn in range(2):
                body = {"tokens": p, "max_new": GATEWAY_NEW}
                if i in GATEWAY_SAMPLED:
                    body.update(temperature=0.8, top_k=50,
                                seed=GATEWAY_SAMPLED[i])
                own = owners(p)[0]
                via = through(body)
                direct = _timed_generate(reps[own].http_port, body, direct_h)
                require(via["status"] == 200 and direct["status"] == 200,
                        f"session {i} turn {turn}: {via['status']} "
                        f"{direct['status']}")
                want = [0, 0]
                want[own] = 1
                rows_.append((i, turn, len(p), own, via["served"],
                              _tokens(via) == _tokens(direct)))
                require(via["served"] == want,
                        f"session {i} turn {turn} (owner {own}) served by "
                        f"{via['served']}")
                require(_tokens(via) == _tokens(direct)
                        and len(_tokens(via)) == GATEWAY_NEW,
                        f"session {i} turn {turn}: gateway "
                        f"{_tokens(via)[:8]} direct {_tokens(direct)[:8]}")
                ttft_gw.append(1e3 * (via["times"][0] - via["t_send"]))
                ttft_direct.append(1e3 * (direct["times"][0]
                                          - direct["t_send"]))
                p = p + _tokens(via) + prompt(GATEWAY_TAIL)
        over = [x - y for x, y in zip(ttft_gw, ttft_direct)]
        st = g.stats()
        print(f"[gateway] affinity: {len(rows_)} requests (8 sessions x 2 "
              f"turns, prompts {sorted(int(x) for x in lens)} then + answer "
              f"+ {GATEWAY_TAIL}; sessions {sorted(GATEWAY_SAMPLED)} sampled "
              f"with seeds), each served by its ring owner and equal to the "
              f"owner's direct answer; owners {[r[3] for r in rows_[::2]]}; "
              f"picks {st['router']['picks']}; TTFT through the gateway "
              f"{stats_line(ttft_gw)}, direct {stats_line(ttft_direct)}, the "
              f"hop's overhead {stats_line(over)}; card: {card}", flush=True)
        require(st["router"]["picks"]["hit"] == len(rows_),
                f"affinity picks {st['router']['picks']}")

        # 3. failover before the first token
        p = prompt(120)
        own, other = owners(p)[0], owners(p)[1]
        body = {"tokens": p, "max_new": GATEWAY_NEW}
        direct = _timed_generate(reps[other].http_port, body, direct_h)
        f0 = g.stats()["failovers"]["transport"]
        with chaos.scope(chaos.ChaosSchedule(seed=1).on(
                chaos.GATEWAY_RELAY, error=ConnectionError, every=1,
                limit=1)):
            via = through(body)
        f1 = g.stats()["failovers"]["transport"]
        print(f"[gateway] failover: attempt 1 on replica {own} lost at the "
              f"GATEWAY_RELAY seam, served by replica {other} "
              f"({via['served']}), equal to its direct answer: "
              f"{_tokens(via) == _tokens(direct)}; transport failovers "
              f"{f0} -> {f1}; TTFT {1e3 * (via['times'][0] - via['t_send']):.1f}"
              f" ms; card: {card}", flush=True)
        require(via["status"] == 200 and via["served"][other] == 1
                and via["served"][own] == 0
                and _tokens(via) == _tokens(direct) and f1 == f0 + 1,
                f"failover: {via['status']} served {via['served']} "
                f"failovers {f0} -> {f1}")
        g.table.poll_once()   # the lost replica answers health: ready

        # 4. mid-stream resume on the ring successor
        n, new, cut = GATEWAY_RESUME
        p = prompt(n)
        own, succ = owners(p)[0], owners(p)[1]
        body = {"tokens": p, "max_new": new}
        whole = _timed_generate(reps[own].http_port, body, direct_h)
        r0 = g.stats()["resumes"]
        with chaos.scope(chaos.ChaosSchedule(seed=2).on(
                chaos.GATEWAY_MIDSTREAM, error=ConnectionError, every=cut,
                limit=1)):
            via = through(body)
        toks = _tokens(via)
        cont = _timed_generate(reps[succ].http_port, dict(
            body, resume_from=cut, emitted=toks[:cut]), direct_h)
        cursors = [ln.get("cursor") for ln in via["lines"]]
        gap_ms = 1e3 * (via["times"][cut] - via["times"][cut - 1])
        # tokens arrive a decode block (K of them) at a time: the mean
        # over the tokens before the cut is the steady gap
        steady_ms = 1e3 * (via["times"][cut - 1] - via["times"][0]) \
            / (cut - 1)
        print(f"[gateway] mid-stream resume: a {n}-token prompt, {new} greedy "
              f"tokens, the relay from replica {own} cut after token {cut} at "
              f"the GATEWAY_MIDSTREAM seam, resumed on replica {succ} "
              f"(served {via['served']}, resumes {r0} -> "
              f"{g.stats()['resumes']}): cursors 0..{new - 1} without gap "
              f"{cursors == list(range(new))}, errors "
              f"{sum('error' in ln for ln in via['lines'])}; equal to the "
              f"first {cut} + the successor's continue_from answer "
              f"{toks == toks[:cut] + _tokens(cont)}; the resume gap "
              f"(token {cut - 1} to {cut}, client clock) {gap_ms:.1f} ms "
              f"against a mean inter-token gap of {steady_ms:.2f} ms before "
              f"the cut; "
              f"against the uninterrupted stream: "
              f"{splice_agreement(toks, _tokens(whole))}; card: {card}",
              flush=True)
        require(via["status"] == 200 and cursors == list(range(new))
                and not any("error" in ln for ln in via["lines"]),
                f"the resumed stream: {via['status']} cursors {cursors}")
        require(toks == toks[:cut] + _tokens(cont) and len(toks) == new,
                "the spliced stream is not the first tokens plus the "
                "successor's continuation")
        require(g.stats()["resumes"] == r0 + 1 and via["served"][succ] == 1,
                f"resumes {g.stats()['resumes']} served {via['served']}")
        g.table.poll_once()

        # 5. the retry budget: one token, spent on a shed failover; the
        # next losses meet the empty bucket and answer a typed 503
        g.budget = RetryBudget(ratio=0.0, burst=1.0)
        p = prompt(GATEWAY_SHED_LEN)
        own, other = owners(p)[0], owners(p)[1]
        body = {"tokens": p, "max_new": 8}
        sched = chaos.ChaosSchedule(seed=3).on(
            chaos.HBM_ALLOC, error=chaos.ResourceExhausted, every=1, limit=1)
        with chaos.scope(sched):
            shed = through(body)
        rep_stats = g.table.replicas[own].stats()
        budget_1 = g.budget.stats()
        typed, exhausted_hits = [], []
        with chaos.scope(chaos.ChaosSchedule(seed=4).on(
                chaos.GATEWAY_RELAY, error=ConnectionError, every=1)):
            for _ in range(3):
                g.table.poll_once()   # both ready: each request attempts
                res = through({"tokens": prompt(GATEWAY_SHED_LEN),
                               "max_new": 8})
                typed.append((res["status"],
                              res["headers"].get("Retry-After")))
                exhausted_hits.append(res["served"])
        print(f"[gateway] retry budget of 1: replica {own} shed an hbm 429 "
              f"(HBM_ALLOC seam; its table row {rep_stats}), the one "
              f"failover served it on replica {other} ({shed['status']}, "
              f"served {shed['served']}); budget then {budget_1}; three "
              f"requests whose first attempt is lost (GATEWAY_RELAY seam): "
              f"{typed}, replica hits {exhausted_hits}, budget "
              f"{g.budget.stats()}; card: {card}", flush=True)
        require(shed["status"] == 200 and shed["served"] == [
            int(own == i) + int(other == i) for i in range(2)]
            and rep_stats["sheds_hbm"] == 1 and budget_1["spent"] == 1,
            f"the shed failover: {shed['status']} {shed['served']} "
            f"{rep_stats} {budget_1}")
        require(all(s == 503 and ra for s, ra in typed)
                and all(h == [0, 0] for h in exhausted_hits)
                and g.budget.stats()["denied"] == 3,
                f"the exhausted budget: {typed} {exhausted_hits} "
                f"{g.budget.stats()}")
        g.budget = RetryBudget()
        for r in g.table.replicas:
            r._hold_until = 0.0
        g.table.poll_once()

        # 6. BASELINE config #5's gateway half: /chat over replica B
        # through a circuit breaker, while B dies and a fresh B starts
        threshold, interval = GATEWAY_BREAKER
        chat = App(MapConfig({"HTTP_PORT": "0", "METRICS_PORT": "0",
                              "LOG_LEVEL": "FATAL", "APP_NAME": "chat"}))
        chat.add_http_service(
            "llm", f"http://127.0.0.1:{b.http_port}",
            CircuitBreakerOption(threshold=threshold, interval=interval),
            HealthOption("/.well-known/health"),
            APIKeyAuthOption(GATEWAY_KEY))
        chat_routes(chat)
        chat.run(block=False)
        apps.append(chat)
        llm = chat.container.get_http_service("llm")
        p = prompt(64)
        body = {"tokens": p, "max_new": GATEWAY_NEW}
        served = http_call(chat.http_port, "POST", "/chat", body)
        direct = _timed_generate(b.http_port, body, direct_h)
        require(served["status"] == 200
                and served["body"]["data"]["tokens"] == _tokens(direct),
                f"/chat: {served['status']} against B's direct answer")
        b_port = b.http_port
        b_gen = b.container.tpu.generator
        b.stop()
        release_graphs(b_gen)
        failures = [http_call(chat.http_port, "POST", "/chat", body)["status"]
                    for _ in range(threshold)]
        opened = llm.is_open
        open_ms, open_status = [], []
        for _ in range(GATEWAY_OPEN_CALLS):
            res = http_call(chat.http_port, "POST", "/chat", body)
            open_ms.append(1e3 * (res["t_end"] - res["t_send"]))
            open_status.append(res["status"])
        gc.collect()
        torch.cuda.empty_cache()
        t_b = time.monotonic()
        # the fresh engine's construction (its graphs' captures count
        # their launches) is not the path's: taken out below
        pre = _launches()
        b, hits_b = _replica_app(dict(GATEWAY_ROWS, APP_NAME="replica-b2",
                                      HTTP_PORT=str(b_port)), True)
        built_launches = {k: v - pre[k] for k, v in _launches().items()}
        apps.append(b)
        reps[1], hits[1] = b, hits_b
        counted_engine(b)
        rebuilt_s = time.monotonic() - t_b
        end = time.monotonic() + GATEWAY_RECOVER_S
        while llm.is_open and time.monotonic() < end:
            time.sleep(0.05)
        closed_s = time.monotonic() - t_b - rebuilt_s
        again = http_call(chat.http_port, "POST", "/chat", body)
        print(f"[gateway] config #5 /chat over replica B (breaker threshold "
              f"{threshold}, interval {interval} s, HealthOption, "
              f"APIKeyAuthOption): served B's direct tokens "
              f"{served['body']['data']['tokens'] == _tokens(direct)}; B "
              f"stopped: {failures} then open {opened}, {GATEWAY_OPEN_CALLS} "
              f"calls answered {sorted(set(open_status))} in "
              f"{stats_line(open_ms)}; a fresh B on port {b_port} built in "
              f"{rebuilt_s:.1f} s, the recovery probe closed the breaker "
              f"{closed_s:.2f} s later; /chat again {again['status']}, equal "
              f"to the first answer "
              f"{again.get('body', {}).get('data', {}).get('tokens') == _tokens(direct)}"
              f"; card: {card}", flush=True)
        require(failures == [502] * threshold and opened
                and set(open_status) == {503},
                f"the breaker: {failures} open {opened} {set(open_status)}")
        require(not llm.is_open and again["status"] == 200
                and again["body"]["data"]["tokens"] == _tokens(direct),
                f"after recovery: open {llm.is_open} {again['status']}")
        # the gateway's health breaker on B opened while B was down; it
        # lets a probe through once its interval has passed
        t_ready = time.monotonic()
        end = t_ready + GATEWAY_RECOVER_S
        while time.monotonic() < end and not all(
                r.state() == "ready" for r in g.table.replicas):
            g.table.poll_once()
            time.sleep(0.05)
        print(f"[gateway] the gateway's table saw the fresh B ready "
              f"{time.monotonic() - t_ready:.2f} s after /chat recovered; "
              f"card: {card}", flush=True)
        require(all(r.state() == "ready" for r in g.table.replicas),
                f"table after B's restart {g.table.stats()}")

        # 7. rolling drain: 8 live streams on replica A, A.stop(grace_s)
        drain_prompts = []
        while len(drain_prompts) < int(GATEWAY_ROWS["TPU_SLOTS"]):
            p = prompt(rng.integers(*GATEWAY_DRAIN_LENS))
            if owners(p)[0] == 0:
                drain_prompts.append(p)
        late_prompts = []
        while len(late_prompts) < GATEWAY_LATE:
            p = prompt(rng.integers(*GATEWAY_DRAIN_LENS))
            if owners(p)[0] == 0:
                late_prompts.append(p)
        first = threading.Semaphore(0)
        results: list = [None] * len(drain_prompts)

        def live(i):
            results[i] = _timed_generate(
                gw.http_port, {"tokens": drain_prompts[i],
                               "max_new": GATEWAY_DRAIN_NEW}, auth,
                on_first=first.release)

        a_hits0, b_hits0 = hits_a["n"], hits[1]["n"]
        ts = [threading.Thread(target=live, args=(i,), daemon=True)
              for i in range(len(drain_prompts))]
        for t in ts:
            t.start()
        for _ in ts:
            require(first.acquire(timeout=APP_CALL_TIMEOUT_S),
                    "a drain stream never got its first token")
        a_gen = a.container.tpu.generator
        live_n = a_gen.stats()["active"]
        t_stop = time.monotonic()
        stopper = threading.Thread(target=a.stop, args=(60.0,), daemon=True)
        stopper.start()
        time.sleep(0.2)
        late = _threads([lambda q=q: through(
            {"tokens": q, "max_new": GATEWAY_NEW}) for q in late_prompts])
        for t in ts:
            t.join(APP_JOIN_S)
        stopper.join(APP_JOIN_S)
        drain_s = time.monotonic() - t_stop
        complete = [r is not None and r.get("status") == 200
                    and [ln.get("cursor") for ln in r["lines"]]
                    == list(range(GATEWAY_DRAIN_NEW)) for r in results]
        st = g.stats()
        print(f"[gateway] rolling drain: {live_n} live streams on replica A "
              f"through the gateway, A.stop(60) took {drain_s:.2f} s; streams "
              f"complete {sum(complete)}/{len(complete)} "
              f"({GATEWAY_DRAIN_NEW} tokens each); {GATEWAY_LATE} new requests "
              f"owned by A sent 0.2 s into the drain: statuses "
              f"{[r['status'] for r in late]}, served by B "
              f"{hits[1]['n'] - b_hits0} (A's hits {hits_a['n'] - a_hits0}); "
              f"gateway outcomes {st['outcomes']} failovers "
              f"{st['failovers']}; card: {card}", flush=True)
        require(live_n == len(drain_prompts) and all(complete),
                f"drain: {live_n} live, complete {complete}")
        require(all(r["status"] == 200 and len(_tokens(r)) == GATEWAY_NEW
                    for r in late)
                and hits[1]["n"] - b_hits0 == GATEWAY_LATE
                and hits_a["n"] - a_hits0 == len(drain_prompts),
                f"the drain's new requests: {[r['status'] for r in late]}")
        require(st["outcomes"]["midstream"] == 0,
                f"a stream was lost: {st['outcomes']}")

        counts = {k: v - built_launches[k] for k, v in _launches().items()}
        bucket = kinds.get("prefill", 0)
        steps = sum(gen.decode_steps - s0 for gen, s0 in engines)
        print(f"[gateway] {bucket} bucket admissions, admission dispatches "
              f"by kind {kinds}, {steps} decode steps over the three replica "
              f"engines; launches {counts} (the fresh B's construction, "
              f"taken out: {built_launches}); card: {card}", flush=True)
        require(counts["flash_prefill"] == layers * bucket and bucket > 0,
                f"flash_prefill launched {counts['flash_prefill']} times for "
                f"{bucket} bucket admissions of {layers} layers")
        require(counts["flash_decode"] == layers * steps and steps > 0,
                f"flash_decode launched {counts['flash_decode']} times for "
                f"{steps} decode steps of {layers} layers")
        require(counts["prefill_plain"] == counts["decode_plain"]
                == counts["paged_decode"] == counts["paged_plain"] == 0,
                f"a plain version or another kernel ran: {counts}")
    finally:
        for app in reversed(apps):
            if app._running.is_set():
                app.stop()
        for gen, _ in engines:
            release_graphs(gen)
    return {"flash_prefill": counts["flash_prefill"],
            "flash_decode": counts["flash_decode"]}


PD_ROWS = dict(MAIN_ROWS, HTTP_PORT="0", METRICS_PORT="0", LOG_LEVEL="WARN")
PD_SEED = 73
PD_BUCKET_LENS = (17, 500)     # 8 prompts: bucket admissions on P (K1)
PD_LATTICE = (700, 1500)       # 2 prompts: the lattice on P, shipped mid-chunk
PD_NEW = 32
PD_SAMPLED = {2: 801, 6: 805}  # request index -> seed (temperature 0.8,
#                                top-k 50)
PD_BLOCK = 16                  # TPU_PD_BLOCK: positions a KV frame
PD_WAIT_S = 60                 # TPU_RESUME_WAIT_S: the re-handoff's wait
PD_DEATH = (300, 64, 16)       # prompt, new tokens, D stopped after this one
PD_DEADLINE = (300, 1000, "1500ms")   # prompt, new tokens, X-Request-Timeout
PD_FAULT_LENS = (700, 200)     # the torn frame's prompt (a lattice: the
#                                reject lands before token 0), the shed's
PD_NEXT = 64                   # the request after each fault
PD_PAGED_ROWS = {"TPU_PAGED_BLOCKS": "129", "TPU_PAGED_BLOCK": "128"}


def _pd_app(rows: dict):
    """A P/D App: a gofr_tpu_torch.App with POST /generate on "cuda",
    running."""
    from gofr_tpu_torch import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.serving import install_generate

    app = App(MapConfig(rows))
    install_generate(app)
    app.run(block=False)
    return app


def _gaps_ms(res: dict) -> tuple:
    """(TTFT, token 0 to token 1, the mean gap over tokens 1..) of one
    client read, in ms on the client's clock."""
    t = res["times"]
    steady = (t[-1] - t[1]) / (len(t) - 2) if len(t) > 2 else float("nan")
    return (1e3 * (t[0] - res["t_send"]), 1e3 * (t[1] - t[0]),
            1e3 * steady)


def phase_pd(card: str) -> dict:
    """Disaggregated prefill/decode serving on the card: a prefill-role
    App (P) ships Llama-3-8B's int8 prompt KV to a contiguous decode
    worker (D) and, after D dies mid-stream, to a paged one (Dp) started
    on the same address; every stream is held against the decode
    worker's own fused answer. K1 32 a bucket admission (P's and the
    decode workers' fused references), K2 32 a decode step of D, K3 32 a
    decode step of Dp, no plain version. Returns the launch counts."""
    import gc
    import socket
    import threading

    import numpy as np
    import torch

    from gofr_tpu_torch import chaos
    from gofr_tpu_torch.pd import protocol as pdp
    from gofr_tpu_torch.tpu import hbm

    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(PD_SEED)
    kinds: dict = {}
    engines: list = []
    apps: list = []
    installs: list = []     # (HostKV, start, end event) of each ingest
    ingested: list = []     # D's and Dp's ingest streams
    ships: list = []        # (positions, host s) of each _ship_range call
    reads: list = []        # host s of each row read a ship makes
    stalls: list = []       # seconds in each send_windowed call
    resubmits: list = []    # emitted count of each re-handoff submit

    def instrument(app, label: str):
        gen = app.container.tpu.generator
        run_admission = gen._run_admission
        kinds[label] = {}

        def counted(key):
            kinds[label][key[0]] = kinds[label].get(key[0], 0) + 1
            return run_admission(key)

        gen._run_admission = counted
        engines.append((label, gen, gen.decode_steps))
        if label == "P":
            ship_range = gen._ship_range

            def timed_ship(row, req, upto):
                t0 = time.monotonic()
                n0 = req.kv_shipped
                try:
                    return ship_range(row, req, upto)
                finally:
                    ships.append((max(0, upto - n0),
                                  time.monotonic() - t0))

            row_get = gen._kv_row_get

            def timed_read(*a, **kw):
                t0 = time.monotonic()
                try:
                    return row_get(*a, **kw)
                finally:
                    reads.append(time.monotonic() - t0)

            gen._ship_range = timed_ship
            gen._kv_row_get = timed_read
            return gen
        install = gen._ingest_install
        generate = gen.generate

        def timed_install(idx, req, blocks):
            # P and D share the default stream, so events there would also
            # bracket the other engine's queued work: the install runs on
            # a stream of its own that waits for the serving stream first
            # (it still lands behind the blocks in flight) and that the
            # serving stream then waits for, so the events hold only the
            # install's span: its host staging and its copies (and Dp's
            # write-back replay). ``copies_ms`` times the copies alone
            serving = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(serving)
            t0, t1 = torch.cuda.Event(True), torch.cuda.Event(True)
            with torch.cuda.stream(side):
                t0.record(side)
                out = install(idx, req, blocks)
                t1.record(side)
            serving.wait_stream(side)
            installs.append((req.ingest[0], t0, t1))
            return out

        def watched(*a, **kw):
            s = generate(*a, **kw)
            if kw.get("ingest") is not None:
                ingested.append(s)
            return s

        gen._ingest_install = timed_install
        gen.generate = watched
        return gen

    def copies_ms(gen, kvs, target) -> list:
        """Device time of each shipped row's install copies alone: the
        engine's own ``_upload_row`` into ``target`` (D's serving cache at
        a free slot, or Dp's scratch row) while the engine is idle, on a
        stream that a spin kernel holds until every copy is queued, so the
        events bracket the copies and none of the host's staging; the
        spin grows until it covers the staging."""
        out = []
        side = torch.cuda.Stream()
        end = time.monotonic() + 10
        while time.monotonic() < end and not all(sl.free
                                                 for sl in gen._slots):
            time.sleep(0.05)   # the last slots retire after their lines
        with gen._device_lock:
            require(all(sl.free for sl in gen._slots)
                    and not gen._scratch_busy,
                    "copies_ms needs an idle engine")
            row = 0   # a free slot's row, rewritten at its next admission
            for kv in kvs:
                spin = 1 << 25
                while True:
                    t0, t1 = torch.cuda.Event(True), torch.cuda.Event(True)
                    with torch.cuda.stream(side):
                        torch.cuda._sleep(spin)
                        t0.record(side)
                        gen._upload_row(kv, row, target)
                        t1.record(side)
                    covered = not t0.query()
                    side.synchronize()
                    if covered:
                        out.append((kv.plen, t0.elapsed_time(t1)))
                        break
                    spin *= 4
        return out

    send_windowed = pdp.Conn.send_windowed

    def timed_send(self, msg, deadline_s=30.0):
        t0 = time.monotonic()
        try:
            return send_windowed(self, msg, deadline_s)
        finally:
            stalls.append(time.monotonic() - t0)

    pdp.Conn.send_windowed = timed_send
    t0 = time.monotonic()
    try:
        d = _pd_app(dict(PD_ROWS, APP_NAME="decode",
                         TPU_SERVING_ROLE="decode",
                         TPU_PD_LISTEN="127.0.0.1:0"))
        apps.append(d)
        srv = d.container.tpu.pd_ingest
        pd_port = srv.port
        p = _pd_app(dict(PD_ROWS, APP_NAME="prefill",
                         TPU_SERVING_ROLE="prefill",
                         TPU_PD_PEER=f"127.0.0.1:{pd_port}",
                         TPU_PD_BLOCK=str(PD_BLOCK),
                         TPU_RESUME_WAIT_S=str(PD_WAIT_S)))
        apps.append(p)
        coord = p.container.tpu.pd_prefill
        p_gen = instrument(p, "P")
        d_gen = instrument(d, "D")
        torch.cuda.synchronize()
        built_s = time.monotonic() - t0
        cfg = p_gen.cfg
        layers = cfg.n_layers
        position_bytes = layers * cfg.n_kv_heads * (2 * cfg.head_dim + 2 * 4)

        def prompt(n):
            return rng.integers(0, cfg.vocab_size, int(n)).tolist()

        _reset_launches()

        # 1. the handshake
        p_h0 = p.container.tpu.health_check()
        d_h = d.container.tpu.health_check()
        sock = socket.create_connection(("127.0.0.1", pd_port), timeout=10)
        try:
            refused0 = srv.refused_hellos
            sock.sendall(pdp.pack_json(pdp.HELLO, 0, pdp.hello_payload(
                "another-model", srv.layout)))
            reply = pdp.read_msg(sock)
        finally:
            sock.close()
        warm = _timed_generate(p.http_port, {"tokens": prompt(64),
                                             "max_new": 4})
        p_h1 = p.container.tpu.health_check()
        print(f"[pd] D (decode, contiguous) and P (prefill) Apps of "
              f"{PD_ROWS['TPU_MODEL']} ({PD_ROWS['TPU_SLOTS']} slots, "
              f"{PD_ROWS['TPU_MAX_SEQ']} positions, int8 KV, K="
              f"{PD_ROWS['TPU_DECODE_BLOCK']}) ready in {built_s:.1f} s; D "
              f"health {d_h.status} role {d_h.details.get('serving_role')} "
              f"listening {d_h.details['pd']['listening']} on {pd_port}; P "
              f"health before its first request {p_h0.status} (connected "
              f"{p_h0.details['pd']['connected']}), after {p_h1.status} "
              f"(connected {p_h1.details['pd']['connected']}); a HELLO "
              f"with another fingerprint: type {reply and reply[0]} req "
              f"{reply and reply[1]}, refused_hellos {refused0} -> "
              f"{srv.refused_hellos}; card: {card}", flush=True)
        require(d_h.details.get("serving_role") == "decode"
                and d_h.details["pd"]["listening"] and d_h.status == "UP",
                f"D's health {d_h.status} {d_h.details.get('pd')}")
        require(p_h1.details.get("serving_role") == "prefill"
                and p_h1.details["pd"]["connected"] and p_h1.status == "UP"
                and warm["status"] == 200,
                f"P's health {p_h1.status} {p_h1.details.get('pd')}")
        require(reply is not None and reply[0] == pdp.ERR and reply[1] == 0
                and srv.refused_hellos == refused0 + 1,
                f"the wrong-fingerprint HELLO: {reply}")

        # 2. token-exact against fused serving, one at a time, then a burst
        lens = [int(x) for x in rng.integers(PD_BUCKET_LENS[0],
                                             PD_BUCKET_LENS[1] + 1, 8)]
        lens = lens[:4] + [PD_LATTICE[0]] + lens[4:] + [PD_LATTICE[1]]
        bodies = []
        for i, n in enumerate(lens):
            body = {"tokens": prompt(n), "max_new": PD_NEW}
            if i in PD_SAMPLED:
                body.update(temperature=0.8, top_k=50, seed=PD_SAMPLED[i])
            bodies.append(body)
        n_ship0, n_inst0 = len(ships), len(installs)
        stall0, read0 = len(stalls), len(reads)
        conn = coord._conn
        bytes0, frames0 = conn.bytes_sent, conn.kv_frames
        via, fused = [], []
        for body in bodies:
            via.append(_timed_generate(p.http_port, body))
            fused.append(_timed_generate(d.http_port, body))
        seq_ok = [v["status"] == 200 and f["status"] == 200
                  and _tokens(v) == _tokens(f) and len(_tokens(v)) == PD_NEW
                  for v, f in zip(via, fused)]
        g_pd = [_gaps_ms(v) for v in via]
        g_fu = [_gaps_ms(f) for f in fused]
        seq_bytes = conn.bytes_sent - bytes0
        seq_frames = conn.kv_frames - frames0
        burst = _threads([lambda b=b: _timed_generate(p.http_port, b)
                          for b in bodies])
        burst_ok = [r["status"] == 200 and _tokens(r) == _tokens(f)
                    for r, f in zip(burst, fused)]
        torch.cuda.synchronize()
        ship_rows = ships[n_ship0:]
        ship_s = sum(s for _, s in ship_rows)
        ship_pos = sum(n for n, _ in ship_rows)
        inst = [(kv.plen, a.elapsed_time(b))
                for kv, a, b in installs[n_inst0:]]
        d_gen = d.container.tpu.generator
        copies = copies_ms(d_gen, [kv for kv, _, _ in
                                   installs[n_inst0:n_inst0 + len(bodies)]],
                           d_gen.cache)
        copy_rate = (sum(n for n, _ in copies) * position_bytes
                     / max(sum(ms for _, ms in copies), 1e-9) / 1e6)
        kv_s = [1e3 * s.trace["kv_transfer_s"] for s in ingested
                if "kv_transfer_s" in s.trace]
        all_bytes = conn.bytes_sent - bytes0
        all_frames = conn.kv_frames - frames0
        print(f"[pd] {len(bodies)} requests to P (prompts {lens}; "
              f"{sorted(PD_SAMPLED)} sampled with seeds) equal to D's fused "
              f"answer: {sum(seq_ok)}/{len(seq_ok)} one at a time, "
              f"{sum(burst_ok)}/{len(burst_ok)} as a burst of {len(burst)}; "
              f"TTFT through P {stats_line([g[0] for g in g_pd])} against "
              f"fused {stats_line([g[0] for g in g_fu])}; the handoff gap "
              f"(token 0 to 1) {stats_line([g[1] for g in g_pd])} against "
              f"fused {stats_line([g[1] for g in g_fu])}; the steady gap "
              f"{stats_line([g[2] for g in g_pd])}; card: {card}",
              flush=True)
        print(f"[pd] shipped one at a time: {seq_bytes} bytes in "
              f"{seq_frames} KV frames for {sum(lens)} positions "
              f"({position_bytes} bytes a position in int8 + scales); with "
              f"the burst {all_bytes} bytes, {all_frames} frames; P's ship "
              f"calls {len(ship_rows)} ({ship_pos} positions) took "
              f"{1e3 * ship_s:.1f} ms on P's serving loop, "
              f"{ship_pos * position_bytes / max(ship_s, 1e-9) / 1e9:.2f} GB/s"
              f" (the row reads to the host {1e3 * sum(reads[read0:]):.1f} "
              f"ms, the rest framing and sending); the loop's stall in "
              f"send_windowed "
              f"{1e3 * sum(stalls[stall0:]):.2f} ms over "
              f"{len(stalls) - stall0} frames (max "
              f"{1e3 * max(stalls[stall0:] or [0]):.3f} ms); kv_transfer_s "
              f"(REQ receipt to the installed rows accepted) "
              f"{stats_line(kv_s)}; the install's span on a stream of its "
              f"own (host staging and copies) "
              f"{stats_line([ms for _, ms in inst])} for "
              f"{min(n for n, _ in inst)}-{max(n for n, _ in inst)} "
              f"positions; its copies alone (device time, D idle) "
              f"{stats_line([ms for _, ms in copies])}, "
              f"{', '.join(f'{n}: {ms:.3f} ms' for n, ms in copies)}, "
              f"{copy_rate:.1f} GB/s; "
              f"card: {card}", flush=True)
        require(all(seq_ok), f"P's streams against D's fused: {seq_ok}")
        require(all(burst_ok), f"the burst against D's fused: {burst_ok}")
        require(kinds["P"].get("mid", 0) >= 3,
                f"the lattice prompts ran no mid chunk on P: {kinds['P']}")
        require(seq_frames == sum(-(-n // PD_BLOCK) for n in lens),
                f"{seq_frames} frames of {PD_BLOCK} positions for prompts "
                f"{lens}")

        # 3. typed faults after the handoff, each one request's
        def next_equal(n):
            body = {"tokens": prompt(n), "max_new": 8}
            a = _timed_generate(p.http_port, body)
            b = _timed_generate(d.http_port, body)
            return a["status"] == 200 and _tokens(a) == _tokens(b) \
                and len(_tokens(a)) == 8

        rejects0 = srv.frame_rejects
        with chaos.scope(chaos.ChaosSchedule(seed=5).on(
                chaos.PD_INGEST, error=lambda: OSError("chaos: frame torn"),
                every=1, limit=1)):
            torn = _timed_generate(p.http_port, {
                "tokens": prompt(PD_FAULT_LENS[0]), "max_new": 8})
        torn_next = next_equal(PD_NEXT)
        sheds0 = dict(hbm.arbiter_stats()["sheds"])
        # per request the seam fires at P's admission check, D's, then
        # D's pd-ingest lease: the third call is the lease
        with chaos.scope(chaos.ChaosSchedule(seed=6).on(
                chaos.HBM_ALLOC, error=chaos.ResourceExhausted, every=3,
                limit=1)):
            shed = _timed_generate(p.http_port, {
                "tokens": prompt(PD_FAULT_LENS[1]), "max_new": 8})
        sheds1 = dict(hbm.arbiter_stats()["sheds"])
        shed_next = next_equal(PD_NEXT)
        n, new, timeout = PD_DEADLINE
        expired0 = d_gen.stats()["expired"]["post-handoff"]
        late = _timed_generate(p.http_port, {"tokens": prompt(n),
                                             "max_new": new},
                               {"X-Request-Timeout": timeout})
        expired1 = d_gen.stats()["expired"]["post-handoff"]
        late_next = next_equal(PD_NEXT)
        shed_err = [ln["error"] for ln in shed["lines"] if "error" in ln]
        late_err = [ln["error"] for ln in late["lines"] if "error" in ln]
        torn_msg = torn.get("body")
        print(f"[pd] a frame torn at the PD_INGEST seam: {torn['status']} "
              f"{str(torn_msg)[:160]}, D's frame_rejects {rejects0} -> "
              f"{srv.frame_rejects}, the next request equal "
              f"{torn_next}; the pd-ingest lease killed at the HBM_ALLOC "
              f"seam: status {shed['status']}, {len(_tokens(shed))} token "
              f"line(s) then {shed_err}, arbiter sheds {sheds0} -> {sheds1}, "
              f"the next equal {shed_next}; a {timeout} deadline over "
              f"{new} new tokens: {len(_tokens(late))} tokens then "
              f"{late_err}, D's post-handoff expiries {expired0} -> "
              f"{expired1}, the next equal {late_next}; card: {card}",
              flush=True)
        require(torn["status"] == 502 and srv.frame_rejects == rejects0 + 1
                and torn_next, f"the torn frame: {torn['status']} "
                f"{torn_msg}")
        require(shed["status"] == 200 and len(_tokens(shed)) == 1
                and len(shed_err) == 1 and shed_err[0]["status"] == 429
                and shed_err[0].get("retry_after")
                and sheds1.get("pd-ingest", 0)
                == sheds0.get("pd-ingest", 0) + 1 and shed_next,
                f"the pd-ingest shed: {shed['lines'][-2:]} {sheds1}")
        require(late["status"] == 200 and 0 < len(_tokens(late)) < new
                and len(late_err) == 1 and late_err[0]["status"] == 504
                and expired1 == expired0 + 1 and late_next,
                f"the deadline after the handoff: {late['lines'][-1:]} "
                f"{expired0} -> {expired1}")

        # 4. D dies mid-stream; the relay is re-handed off to a paged
        # decode worker started on D's address
        n, new, cut = PD_DEATH
        body = {"tokens": prompt(n), "max_new": new}
        whole = _timed_generate(d.http_port, body)
        submit = coord._submit

        def recorded(rs, emitted):
            if emitted:
                resubmits.append(len(emitted))
            return submit(rs, emitted)

        coord._submit = recorded
        reached = threading.Event()
        box: dict = {}

        def read():
            box["res"] = _timed_generate(
                p.http_port, body,
                on_line=lambda k: k == cut and reached.set())

        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        require(reached.wait(APP_CALL_TIMEOUT_S),
                f"the stream never reached token {cut}")
        t_kill = time.monotonic()
        # abruptly: the ingest listener and its connections first (the
        # App's servers take a poll interval to stop), then the engine,
        # no drain
        srv.close()
        d.stop()
        release_graphs(d_gen)
        apps.remove(d)
        gc.collect()
        torch.cuda.empty_cache()
        pre = _launches()
        dp = _pd_app(dict(PD_ROWS, **PD_PAGED_ROWS, APP_NAME="decode-paged",
                          TPU_SERVING_ROLE="decode",
                          TPU_PD_LISTEN=f"127.0.0.1:{pd_port}"))
        built_launches = {k: v - pre[k] for k, v in _launches().items()}
        apps.append(dp)
        dp_gen = instrument(dp, "Dp")
        dp_built_s = time.monotonic() - t_kill
        reader.join(APP_CALL_TIMEOUT_S + PD_WAIT_S)
        res = box.get("res") or {"status": None, "lines": [], "times": []}
        toks = _tokens(res)
        cursors = [ln.get("cursor") for ln in res["lines"]]
        k = resubmits[-1] if resubmits else 0
        cont = _timed_generate(dp.http_port, dict(
            body, resume_from=k, emitted=toks[:k]))
        t = res["times"]
        gaps = [b - a for a, b in zip(t, t[1:])]
        at = int(np.argmax(gaps)) + 1 if gaps else 0
        steady = 1e3 * (t[cut - 1] - t[1]) / (cut - 2) if len(t) >= cut \
            else float("nan")
        st = coord.stats()
        print(f"[pd] D stopped after token {cut} of a {n}-token prompt's "
              f"{new}-token greedy stream; Dp (paged, "
              f"{PD_PAGED_ROWS['TPU_PAGED_BLOCKS']} blocks of "
              f"{PD_PAGED_ROWS['TPU_PAGED_BLOCK']}, scratch row and "
              f"write-back graph built: "
              f"{('writeback',) in dp_gen._adm_graphs}) ready on port "
              f"{pd_port} {dp_built_s:.1f} s after the stop; P re-handed "
              f"off at {k} emitted tokens (resubmits {resubmits}, resumed "
              f"{st['resumed']}, peer losses {st['peer_losses']}); the "
              f"client's stream: status {res['status']}, cursors 0..{new - 1}"
              f" without gap {cursors == list(range(new))}, errors "
              f"{sum('error' in ln for ln in res['lines'])}; equal to the "
              f"first {k} + Dp's continue_from answer "
              f"{toks == toks[:k] + _tokens(cont)}; the resume gap "
              f"{1e3 * max(gaps or [0]):.1f} ms before token {at} against a "
              f"steady {steady:.2f} ms a token; against the uninterrupted "
              f"stream: {splice_agreement(toks, _tokens(whole))}; card: "
              f"{card}", flush=True)
        require(res["status"] == 200 and cursors == list(range(new))
                and not any("error" in ln for ln in res["lines"]),
                f"the re-handed-off stream: {res['status']} {cursors}")
        require(k >= cut and toks == toks[:k] + _tokens(cont)
                and len(toks) == new,
                f"the stream is not its {k} tokens plus Dp's continuation")
        require(st["resumed"] == 1 and st["peer_losses"] == 1
                and ("writeback",) in dp_gen._adm_graphs,
                f"P's coordinator {st}")

        # the burst again, through the paged decode worker
        n_inst1 = len(installs)
        burst_p = _threads([lambda b=b: _timed_generate(p.http_port, b)
                            for b in bodies])
        fused_p = [_timed_generate(dp.http_port, b) for b in bodies]
        paged_ok = [r["status"] == 200 and _tokens(r) == _tokens(f)
                    and len(_tokens(r)) == PD_NEW
                    for r, f in zip(burst_p, fused_p)]
        as_d = [_tokens(f) == _tokens(g) for f, g in zip(fused_p, fused)]
        torch.cuda.synchronize()
        inst_p = [a.elapsed_time(b) for _, a, b in installs[n_inst1:]]
        copies_p = copies_ms(dp_gen, [kv for kv, _, _ in installs[n_inst1:]],
                             dp_gen._scratch)
        print(f"[pd] the burst of {len(bodies)} through P to Dp: statuses "
              f"{sorted({r['status'] for r in burst_p})}, equal to "
              f"Dp's fused answer {sum(paged_ok)}/{len(paged_ok)}; Dp's "
              f"fused answers equal to D's {sum(as_d)}/{len(as_d)}; Dp's "
              f"install's span on a stream of its own (host staging, the "
              f"scratch upload and the write-back replay) "
              f"{stats_line(inst_p)}; the scratch upload's copies alone "
              f"(device time, Dp idle) "
              f"{stats_line([ms for _, ms in copies_p])}; card: "
              f"{card}", flush=True)
        require(all(paged_ok), f"the burst through Dp: {paged_ok}")

        # 5. the launch counts
        counts = {k2: v - built_launches[k2] for k2, v in _launches().items()}
        steps = {label: gen.decode_steps - s0 for label, gen, s0 in engines}
        bucket = {label: kk.get("prefill", 0) for label, kk in kinds.items()}
        print(f"[pd] admission dispatches by engine {kinds}; decode steps "
              f"{steps}; launches {counts} (Dp's construction, taken out: "
              f"{built_launches}); the phase {time.monotonic() - t0:.1f} s; "
              f"card: {card}", flush=True)
        require(steps["P"] == 0, f"P decoded {steps['P']} steps")
        require(counts["flash_prefill"] == layers * sum(bucket.values())
                and bucket["P"] > 0,
                f"flash_prefill launched {counts['flash_prefill']} times for "
                f"bucket admissions {bucket} of {layers} layers")
        require(counts["flash_decode"] == layers * steps["D"]
                and steps["D"] > 0,
                f"flash_decode launched {counts['flash_decode']} times for "
                f"{steps['D']} decode steps of D")
        require(counts["paged_decode"] == layers * steps["Dp"]
                and steps["Dp"] > 0,
                f"paged_decode launched {counts['paged_decode']} times for "
                f"{steps['Dp']} decode steps of Dp")
        require(counts["prefill_plain"] == counts["decode_plain"]
                == counts["paged_plain"] == counts["paged_window"] == 0,
                f"a plain version or another kernel ran: {counts}")
    finally:
        pdp.Conn.send_windowed = send_windowed
        for app in reversed(apps):
            if app._running.is_set():
                app.stop()
        for _, gen, _ in engines:
            release_graphs(gen)
    return {"flash_prefill": counts["flash_prefill"],
            "flash_decode": counts["flash_decode"],
            "paged_decode": counts["paged_decode"]}


# -- phase tp: tensor-parallel serving (TPU_SHARDING=tp=2) --------------------

TP_ROWS = {"TPU_MODEL": "llama3-8b", "TPU_SLOTS": "8", "TPU_MAX_SEQ": "2048",
           "TPU_KV_DTYPE": "int8", "TPU_DECODE_BLOCK": "4"}
TP_APP_ROWS = dict(TP_ROWS, TPU_SHARDING="tp=2", HTTP_PORT="0",
                   METRICS_PORT="0", LOG_LEVEL="WARN",
                   APP_NAME="chip-smoke-tp")
TP_PAGED_ROWS = dict(TP_ROWS, TPU_SHARDING="tp=2", TPU_PAGED_BLOCK="128",
                     TPU_PAGED_BLOCKS="65", TPU_SPEC_DECODE="4")
TP_SEED = 61
TP_LENS = [17, 500, 123, 256, 64, 300, 40, 200]   # each a bucket admission
TP_NEW = 32
# the paged prompts are X + S + X, S tp=1's greedy continuation of X, so
# the prompt-lookup drafts find S after the second X
TP_PAGED_X = [150, 90, 200, 60]
TP_PAGED_NEW = 48   # long enough for the streams to fall into drafts
# the per-rank head counts (H, KV) the kernels are held at: Llama-3-8B at
# tp = 2, 4, 8 and Llama-3-70B at tp = 8
TP_SHAPES = [(16, 4), (8, 2), (4, 1), (8, 1)]
# tp=2 against tp=1 score logits: both bf16 through 32 layers, the two
# sum the same products in another order (each rank's partial rounded to
# bf16, the sum in float32): a few bf16 steps of unit-scale logits per
# layer, as phase 4's kernels against plain (LOGIT_ATOL over 4 layers)
TP_LOGIT_ATOL = 0.25
# a near tie: two candidates within four bf16 steps of logits below 16
# (0.0625 is one step from 8 to 16); a first token may differ from tp=1's
# only there, read from the tp=2 engine's own admission logits
TP_TIE_ATOL = 0.0625


def tp_kernel_shapes(card: str) -> dict:
    """K1, K2 (int8), K3 (int8) and K3w (int8, W = 5) at each per-rank
    head count of TP_SHAPES: held against their plain versions in float32
    and timed (prefill B=1 S=512; the decodes 8 slots x 512). Returns
    {(h, kv): {kernel: ms}}."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(TP_SEED)
    out = {}
    for h, kv in TP_SHAPES:
        recs = {k: {} for k in ("flash_prefill", "flash_decode",
                                "paged_decode", "paged_window")}
        prefill_case(g, 1, 512, [512], recs["flash_prefill"], h=h, kv=kv)
        decode_case(g, [512] * 8, True, recs["flash_decode"], h=h, kv=kv,
                    main_shape=True)
        paged_case(g, [512] * 8, True, recs["paged_decode"], h=h, kv=kv,
                   main_shape=True, timed=True)
        window_case(g, [512] * 8, 5, True, recs["paged_window"], h=h, kv=kv,
                    main_shape=True, timed=True)
        out[(h, kv)] = {k: r.get("ms") for k, r in recs.items()}
        print(f"[tp] per-rank shape H={h} KV={kv}: kernel ms "
              f"{ {k: round(v, 5) for k, v in out[(h, kv)].items()} }; "
              f"card: {card}", flush=True)
    return out


def phase_tp(card: str) -> dict:
    """Tensor-parallel serving on the one card: Llama-3-8B at full width
    and depth as two ranks of ``TPU_SHARDING=tp=2`` (this process and one
    worker process, both on cuda:0, the activations summed over gloo),
    against a tp=1 engine on the same seed-0 weights built first and
    freed. Holds the score logits (each prompt's prefill logits) within
    TP_LOGIT_ATOL of tp=1's and the first token of every stream equal;
    K1, K2, K3 and K3w launched on both ranks, the same count on each.
    Returns the launch counts summed over the ranks."""
    import gc
    import threading

    import numpy as np
    import torch

    from gofr_tpu_torch import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.models.common import LLAMA_CONFIGS
    from gofr_tpu_torch.ops import flash, flash_decode, paged_attention
    from gofr_tpu_torch.serving import install_generate
    from gofr_tpu_torch.tpu import generator as pgen_mod
    from gofr_tpu_torch.tpu import hbm, new_engine_from_config
    from gofr_tpu_torch.tpu.generator import _COUNTERS

    gc.collect()
    torch.cuda.empty_cache()
    tp_kernel_shapes(card)
    rng = np.random.default_rng(TP_SEED)
    vocab = LLAMA_CONFIGS[TP_ROWS["TPU_MODEL"]].vocab_size
    prompts = [rng.integers(0, vocab, n).tolist() for n in TP_LENS]
    xs = [rng.integers(0, vocab, n).tolist() for n in TP_PAGED_X]

    def ttft(streams):
        return [1e3 * (s.trace["first_put"] - s.trace["submit"])
                for s in streams]

    # tp=1: the reference, on seed-0 weights (CUDA graphs, depth 2)
    t0 = time.monotonic()
    ref = new_engine_from_config(MapConfig(TP_ROWS), device="cuda")
    ready1 = time.monotonic() - t0
    try:
        ref.generate(prompts[2], max_new_tokens=4).tokens()
        outs1, streams1, wall1 = _serve(ref, prompts, {}, TP_NEW)
        conts, _, _ = _serve(ref, xs, {}, TP_NEW)
        paged_prompts = [x + s + x for x, s in zip(xs, conts)]
        paged1, _, _ = _serve(ref, paged_prompts, {}, 1)
        score1 = [ref.predict("score", np.asarray(p, np.int32))
                  for p in prompts]
        pscore1 = [ref.predict("score", np.asarray(p, np.int32))
                   for p in paged_prompts]
        step1 = ref.generator.stats()["decode_step_ms_mean"]
    finally:
        ref.close()
    release_graphs(ref.generator)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    tok_s1 = sum(map(len, outs1)) / wall1
    print(f"[tp] tp=1 (ready in {ready1:.1f} s): {len(prompts)} streams of "
          f"{TP_NEW} tokens at {tok_s1:.1f} tok/s, TTFT "
          f"{stats_line(ttft(streams1))}; card: {card}", flush=True)

    # tp=2: the App, its engine rank 0 of two ranks on cuda:0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    app = App(MapConfig(TP_APP_ROWS))
    tpu = app.container.tpu
    gen = tpu.generator
    install_generate(app)
    app.run(block=False)
    ready2 = time.monotonic() - t0
    mesh = gen.stats()["mesh"]
    leases = {r["rank"]: r["bytes"] for r in hbm.arbiter_stats()["leases"]
              if r["subsystem"] == "engine" and "rank" in r}
    peaks = {r["rank"]: r["peak_bytes"] for r in gen._tp.ready}
    print(f"[tp] tp=2 App ready in {ready2:.1f} s: ranks on "
          f"{mesh['ranks']}, device group {mesh['backend']}, graphs "
          f"{mesh['graphs']}, leased bytes by rank {leases}, peak "
          f"allocated bytes by rank while building {peaks}, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated by "
          f"rank 0", flush=True)
    streams2, lock = [], threading.Lock()
    generate = tpu.generate

    def tracked(prompt, *args, **kw):
        s = generate(prompt, *args, **kw)
        with lock:
            streams2.append(s)
        return s

    tpu.generate = tracked
    results: dict = {}
    try:
        warm = http_call(app.http_port, "POST", "/generate",
                         {"tokens": prompts[2], "max_new": 4})
        require(warm["status"] == 200 and len(warm["lines"]) == 4,
                f"tp=2 warm-up: {warm['status']}")
        streams2.clear()
        for mod in (flash, flash_decode, paged_attention):
            mod.reset_counts()
        gen.tp_zero_counts()
        adm0, steps0 = gen.admissions, gen.decode_steps

        def client(i):
            results[i] = http_call(app.http_port, "POST", "/generate",
                                   {"tokens": prompts[i], "max_new": TP_NEW})

        t_burst = time.monotonic()
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(APP_JOIN_S)
        wall2 = time.monotonic() - t_burst
        require(all(not t.is_alive() for t in threads),
                "tp=2 clients still waiting")
        score2 = [tpu.predict("score", np.asarray(p, np.int32))
                  for p in prompts]
        dispatches = tpu._programs["score"].dispatches
        probe = gen.tp_probe()
        admissions = gen.admissions - adm0
        steps = gen.decode_steps - steps0
        step2 = gen.stats()["decode_step_ms_mean"]
        alive = gen.tp_alive()
        health = tpu.health_check()
        # where a tp=2 step goes: one float32 sum of a decode step's
        # partials, of a 512-token admission's, and of the logits
        reduce_ms = {shape: gen.tp_time_all_reduce(shape, n) for shape, n
                     in (((8, 1, 4096), 50), ((1, 512, 4096), 20),
                         ((8, vocab), 20))}
    finally:
        app.stop()
    require(not gen.tp_alive() and all(p.poll() is not None
                                       for p in gen._tp.procs),
            "a tp=2 worker outlived the App's stop")
    require(alive and health.status == "UP",
            f"tp=2 health {health.status}, ranks alive {alive}")
    require(mesh["backend"] == "gloo",
            f"two ranks on one card over {mesh['backend']}")
    outs2 = []
    for i in range(len(prompts)):
        r = results.get(i, {})
        require(r.get("status") == 200, f"tp=2 request {i}: {r.get('status')}")
        outs2.append([line["token"] for line in r["lines"]])
    tok_s2 = sum(map(len, outs2)) / wall2
    t_first = [1e3 * (results[i]["t_first"] - results[i]["t_send"])
               for i in range(len(prompts))]
    names = [f"{mod.__name__.rsplit('.', 1)[1]}.{name}"
             for mod, name in _COUNTERS]
    per_rank = [dict(zip(names, (int(x) for x in row[-len(_COUNTERS):])))
                for row in probe]
    B = gen.n_slots
    require((probe[:, :5 * B] == probe[0, :5 * B]).all(),
            "a worker's carry or cursors differ from rank 0's")
    require(per_rank[0] == per_rank[1],
            f"the ranks launched different kernels: {per_rank}")
    k1, k2 = (per_rank[0]["flash.launches"],
              per_rank[0]["flash_decode.launches"])
    require(k1 == LAYERS * (admissions + dispatches),
            f"K1 launched {k1} times a rank for {admissions} admissions and "
            f"{dispatches} score dispatches of {LAYERS} layers")
    require(k2 == LAYERS * steps,
            f"K2 launched {k2} times a rank for {steps} decode steps")
    require(per_rank[0]["flash.plain_calls"] == 0
            and per_rank[0]["flash_decode.plain_calls"] == 0,
            f"plain versions ran on a rank: {per_rank}")
    diffs = [float(np.abs(a - b).max()) for a, b in zip(score2, score1)]
    scale = max(float(np.abs(s).max()) for s in score1)
    firsts1 = [o[0] for o in outs1]
    firsts2 = [o[0] for o in outs2]
    parts = [_first_difference(a, b) for a, b in zip(outs2, outs1)]
    print(f"[tp] tp=2 {len(prompts)} POST /generate streams of {TP_NEW} "
          f"tokens at {tok_s2:.1f} tok/s (tp=1 {tok_s1:.1f}), TTFT at the "
          f"engine {stats_line(ttft(streams2))} (tp=1 "
          f"{stats_line(ttft(streams1))}), at the client "
          f"{stats_line(t_first)}; decode step {step2:.2f} ms (tp=1 "
          f"{step1:.2f} ms); one all_reduce over the device group, ms by "
          f"shape: { {k: round(v, 4) for k, v in reduce_ms.items()} } "
          f"({2 * LAYERS + 2} a decode step); "
          f"{admissions} admissions, {steps} decode "
          f"steps, {dispatches} score dispatches; launches a rank "
          f"{per_rank}; score logits against tp=1: max |diff| "
          f"{max(diffs):.4e} (atol {TP_LOGIT_ATOL}; max |logit| "
          f"{scale:.3f}); first index where each stream parts from tp=1's: "
          f"{parts}; card: {card}", flush=True)
    require(max(diffs) <= TP_LOGIT_ATOL,
            f"tp=2 score logits differ from tp=1's by {max(diffs)}")
    require([int(np.argmax(s)) for s in score2] == firsts1,
            "a tp=2 score argmax is not tp=1's first token")
    require(firsts2 == firsts1,
            f"first tokens differ: tp=2 {firsts2}, tp=1 {firsts1}")
    counts = {"flash_prefill": k1 * 2, "flash_decode": k2 * 2}
    del app, tpu, gen
    gc.collect()
    torch.cuda.empty_cache()

    # the paged engine at tp=2, with spec decode: K1, K3 and K3w
    t0 = time.monotonic()
    eng = new_engine_from_config(MapConfig(TP_PAGED_ROWS), device="cuda")
    pgen = eng.generator
    try:
        eng.generate(paged_prompts[0][:40], max_new_tokens=4).tokens()
        for mod in (flash, flash_decode, paged_attention):
            mod.reset_counts()
        pgen.tp_zero_counts()
        adm0, steps0, passes0 = (pgen.admissions, pgen.decode_steps,
                                 pgen.verify_passes)
        # rank 0's summed logits at each admission's first token (a TP
        # engine dispatches eagerly, so the module function runs each
        # time): what a paged first token was sampled from
        first_logits = []
        first_token = pgen_mod._first_token

        def recording(logits, inp, draw):
            first_logits.append((int(inp.length.item()),
                                 logits[0].float().cpu().numpy()))
            return first_token(logits, inp, draw)

        pgen_mod._first_token = recording
        try:
            outs3, streams3, wall3 = _serve(eng, paged_prompts, {},
                                            TP_PAGED_NEW)
        finally:
            pgen_mod._first_token = first_token
        probe = pgen.tp_probe()
        pscore2 = [eng.predict("score", np.asarray(p, np.int32))
                   for p in paged_prompts]
        admissions = pgen.admissions - adm0
        steps = pgen.decode_steps - steps0
        passes = pgen.verify_passes - passes0
        pstats = pgen.stats()
    finally:
        eng.close()
    require(all(p.poll() is not None for p in pgen._tp.procs),
            "a paged tp=2 worker outlived close()")
    per_rank = [dict(zip(names, (int(x) for x in row[-len(_COUNTERS):])))
                for row in probe]
    require(per_rank[0] == per_rank[1],
            f"the paged ranks launched different kernels: {per_rank}")
    pk1 = per_rank[0]["flash.launches"]
    k3 = per_rank[0]["paged_attention.launches"]
    k3w = per_rank[0]["paged_attention.window_launches"]
    print(f"[tp] paged tp=2 + TPU_SPEC_DECODE=4 (ready and served in "
          f"{time.monotonic() - t0:.1f} s): {len(paged_prompts)} streams "
          f"of {TP_PAGED_NEW} tokens at {sum(map(len, outs3)) / wall3:.1f} tok/s, "
          f"TTFT {stats_line(ttft(streams3))}; {admissions} admissions, "
          f"{steps} decode steps, {passes} verify passes "
          f"({pstats['spec_decode']['tokens_per_window']} tokens a "
          f"window); launches a rank {per_rank}; first tokens "
          f"{[o[0] for o in outs3]} (tp=1 {[o[0] for o in paged1]}); "
          f"card: {card}", flush=True)
    # a first token may differ from tp=1's only at a near tie: within
    # TP_TIE_ATOL of the winner in the logits the tp=2 engine sampled it
    # from, and in tp=1's score logits
    pdiff = max(float(np.abs(a - b).max()) for a, b in zip(pscore2, pscore1))
    own = []
    for p, o in zip(paged_prompts, outs3):
        hits = [lg for n, lg in first_logits
                if n == len(p) and int(np.argmax(lg)) == o[0]]
        require(hits, f"no admission of length {len(p)} sampled the paged "
                f"tp=2 first token {o[0]}")
        own.append(hits[0])
    ties = [(i, float(l2.max() - l2[t1[0]]),
             float(pscore1[i].max() - pscore1[i][t2[0]]))
            for i, (l2, t1, t2) in enumerate(zip(own, paged1, outs3))
            if t1[0] != t2[0]]
    print(f"[tp] paged prompts' score logits against tp=1: max |diff| "
          f"{pdiff:.4e}; first tokens that differ from tp=1's (prompt, "
          f"tp=1's token below tp=2's in tp=2's admission logits, tp=2's "
          f"below tp=1's in tp=1's score logits): {ties} (tie limit "
          f"{TP_TIE_ATOL})", flush=True)
    require(pdiff <= TP_LOGIT_ATOL,
            f"paged tp=2 score logits differ from tp=1's by {pdiff}")
    require(all(g2 <= TP_TIE_ATOL and g1 <= TP_TIE_ATOL
                for _, g2, g1 in ties),
            f"a paged tp=2 first token differs from tp=1's past a near "
            f"tie: {ties}")
    require(pk1 == LAYERS * admissions and k3 == LAYERS * steps
            and k3w == LAYERS * passes,
            f"paged tp=2 launches {per_rank[0]} for {admissions} "
            f"admissions, {steps} decode steps, {passes} verify passes")
    require(k3 > 0 and k3w > 0, "K3 or K3w never ran on the paged ranks")
    require(per_rank[0]["paged_attention.plain_calls"] == 0
            and per_rank[0]["paged_attention.window_plain_calls"] == 0,
            f"plain versions ran on a paged rank: {per_rank}")
    counts["flash_prefill"] += 2 * pk1
    counts["paged_decode"] = 2 * k3
    counts["paged_window"] = 2 * k3w
    del eng, pgen
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# -- phase cmd: the CLI App (new_cmd), migrations and SQL ----------------------

CMD_ROWS = dict(MAIN_ROWS, LOG_LEVEL="INFO")
CMD_SEED = 79
CMD_PROMPTS = 8
CMD_LENS = (17, 500)      # the prompts' lengths: bucket admissions (K1)
CMD_NEW = 32
CMD_MODEL = "llama-3-8b"  # the name the migration's model ledger records
# the CLI run as a process of its own: Llama-3-8B's width at this depth,
# inside its own limit
CMD_PROC_LAYERS = 2
CMD_PROC_S = 180

# a CLI program as a user writes one: new_cmd, a generate sub-command,
# run_command's code as the process's; argv[1] is a JSON spec (the rows,
# the device, the model and depth it registers), the rest the command.
# It exits while the engine's threads are still live, and reports the
# launch counts of its one command on stderr
CMD_CLI = """
import json, sys, threading
from gofr_tpu_torch import new_cmd
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.models.common import LLAMA_CONFIGS
from gofr_tpu_torch.ops import flash, flash_decode

spec = json.loads(sys.argv[1])
LLAMA_CONFIGS[spec["rows"]["TPU_MODEL"]] = LLAMA_CONFIGS[
    spec["base"]].with_(n_layers=spec["layers"])
app = new_cmd(MapConfig(spec["rows"]), device=spec["device"])


@app.sub_command("generate", description="-prompt 1,2,3 -max N -seed S")
def generate(ctx):
    prompt = [int(t) for t in ctx.param("prompt").split(",")]
    return {"prompt_len": len(prompt), "tokens": ctx.tpu.generate(
        prompt, max_new_tokens=int(ctx.param("max")),
        seed=int(ctx.param("seed", "0"))).tokens()}


gen = app.container.tpu.generator
flash.reset_counts()
flash_decode.reset_counts()
adm0, steps0 = gen.admissions, gen.decode_steps
code = app.run_command(sys.argv[2:])
live = [t.name for t in threading.enumerate()
        if t.name == "gofr-torch-gen" and t.is_alive()]
print("[cli] " + json.dumps({
    "code": code, "live": live, "admissions": gen.admissions - adm0,
    "steps": gen.decode_steps - steps0, "flash_prefill": flash.launches,
    "flash_decode": flash_decode.launches,
    "plain": flash.plain_calls + flash_decode.plain_calls}),
    file=sys.stderr, flush=True)
raise SystemExit(code)
"""


def cmd_routes(app, traces: list) -> None:
    """The ``generate`` sub-command: ``-prompt`` (comma-separated token
    ids), ``-max`` new tokens and ``-seed``; the stream through
    ``ctx.tpu.generate``, a row in ``generations`` through ``ctx.sql``,
    its result as JSON on stdout. Each stream's ``trace`` is appended to
    ``traces``."""
    import json

    @app.sub_command("generate", description="-prompt 1,2,3 -max N -seed S")
    def generate(ctx):
        prompt = [int(t) for t in ctx.param("prompt").split(",")]
        n = int(ctx.param("max", "16"))
        seed = int(ctx.param("seed", "0"))
        stream = ctx.tpu.generate(prompt, max_new_tokens=n, seed=seed)
        tokens = stream.tokens()
        traces.append(stream.trace)
        ctx.sql.execute("INSERT INTO generations (prompt_len, max_new, "
                        "seed, tokens) VALUES (?, ?, ?, ?)", len(prompt), n,
                        seed, json.dumps(tokens))
        return {"prompt_len": len(prompt), "tokens": tokens}

    @app.sub_command("fail", description="raises")
    def fail(ctx):
        raise ValueError(f"refused: {ctx.param('why', 'always')}")


def run_command_captured(app, argv: list) -> tuple:
    """(exit code, stdout, stderr, seconds) of ``app.run_command(argv)``."""
    import io

    out, err = io.StringIO(), io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = app.run_command(argv)
    return code, out.getvalue(), err.getvalue(), time.monotonic() - t0


def cmd_migrations(mig, registered: list) -> dict:
    """Migration 1 creates the generations table, 2 records the model in
    the model-version ledger."""
    def register(ds):
        ds.tpu.register_model(CMD_MODEL, revision="seed0")
        registered.extend(ds.tpu.registered)

    return {1: mig.Migrate(up=lambda ds: ds.sql.execute(
                "CREATE TABLE generations (id INTEGER PRIMARY KEY, "
                "prompt_len INTEGER, max_new INTEGER, seed INTEGER, "
                "tokens TEXT)")),
            2: mig.Migrate(up=register)}


def phase_cmd(card: str, device: str = "cuda") -> dict:
    """The CLI entry point to the main path: ``new_cmd`` with Llama-3-8B
    at full width and depth (seed-0 weights, phase 5's rows), a sqlite
    file (``DB_DIALECT``, ``DB_NAME``) and ``CMD_LOGS_FILE``; the
    migrations (ledger, re-run, rollback); 8 ``generate`` sub-commands
    of 17-500 tokens, each equal to ``engine.generate`` on the same
    engine, K1 32 a bucket admission and K2 32 a decode step, no plain
    call; the failure paths; the log file; then the CLI as a process of
    its own at 2 layers, which must exit 0 by itself. Returns the launch
    counts of the 8 commands."""
    import gc
    import json
    import tempfile

    import numpy as np
    import torch

    from gofr_tpu_torch import migration as mig
    from gofr_tpu_torch import new_cmd
    from gofr_tpu_torch.config import MapConfig

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.monotonic()
    tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-cmd-")
    db, log = (os.path.join(tmp.name, n) for n in ("cmd.db", "cmd.log"))
    rows = dict(CMD_ROWS, DB_DIALECT="sqlite", DB_NAME=db,
                CMD_LOGS_FILE=log)
    t0 = time.monotonic()
    app = new_cmd(MapConfig(rows), device=device)
    gen = app.container.tpu.generator
    ready_s = time.monotonic() - t0
    traces: list = []
    cmd_routes(app, traces)
    rng = np.random.default_rng(CMD_SEED)
    vocab = gen.cfg.vocab_size
    prompts = [rng.integers(0, vocab, int(n)).tolist() for n in
               rng.integers(CMD_LENS[0], CMD_LENS[1] + 1, CMD_PROMPTS)]
    try:
        # 1. the migrations: applied once, in order; a failing one rolls
        # its DDL back and leaves the ledger as it was
        registered: list = []
        sql = app.container.sql
        app.migrate(cmd_migrations(mig, registered))
        ledger = [r["version"] for r in sql.query(
            "SELECT version FROM gofr_migrations ORDER BY version")]
        app.migrate(cmd_migrations(mig, registered))
        again = [r["version"] for r in sql.query(
            "SELECT version FROM gofr_migrations ORDER BY version")]

        def doomed(ds):
            ds.sql.execute("CREATE TABLE doomed (x INTEGER)")
            raise RuntimeError("the third migration fails")

        try:
            app.migrate({3: doomed})
            raised = None
        except mig.MigrationError as e:
            raised = str(e)
        left = sql.query("SELECT name FROM sqlite_master "
                         "WHERE name = 'doomed'")
        after = sql.query_row("SELECT COUNT(*) AS n FROM gofr_migrations")
        print(f"[cmd] CLI App ready in {ready_s:.1f} s (kernels built, "
              f"graphs captured); ledger {ledger}, after a second migrate "
              f"{again}, the model ledger {registered}; a failing third "
              f"migration: {raised!r}, table left {left}, ledger rows "
              f"{after['n']}; card: {card}", flush=True)
        require(ledger == [1, 2] and again == [1, 2],
                f"the ledger {ledger}, then {again}")
        require(registered == [{"name": CMD_MODEL, "weights_path": "",
                                 "revision": "seed0"}],
                f"the model ledger {registered}")
        require(raised is not None and "migration 3 failed" in raised
                and left == [] and after["n"] == 2,
                f"the failing migration: {raised!r}, {left}, {after}")

        # 2. the generate sub-commands, counted
        run_command_captured(app, ["generate", "-prompt", ",".join(
            map(str, prompts[0][:32])), "-max", "4"])   # warm, uncounted
        traces.clear()
        sql.execute("DELETE FROM generations")
        _reset_launches()
        adm0, steps0, replays0 = (gen.admissions, gen.decode_steps,
                                  gen.admission_replays)
        runs = [run_command_captured(
            app, ["generate", "-prompt", ",".join(map(str, p)), "-max",
                  str(CMD_NEW), "-seed", str(i)])
            for i, p in enumerate(prompts)]
        counts = _launches()
        admissions = gen.admissions - adm0
        steps = gen.decode_steps - steps0
        replays = gen.admission_replays - replays0
        results = [json.loads(out) if code == 0 else None
                   for code, out, _, _ in runs]
        n_rows = sql.query_row("SELECT COUNT(*) AS n FROM generations")["n"]
        stored = [json.loads(r["tokens"]) for r in sql.query(
            "SELECT tokens FROM generations ORDER BY id")]
        # 3. the same prompts through engine.generate, called directly
        direct = [app.container.tpu.generate(p, max_new_tokens=CMD_NEW,
                                             seed=i).tokens()
                  for i, p in enumerate(prompts)]
        # 4. the failure paths
        unknown = run_command_captured(app, ["translate", "-prompt", "1"])
        failing = run_command_captured(app, ["fail", "-why", "on purpose"])
    finally:
        app.stop()
        release_graphs(gen)
    wall = sum(s for _, _, _, s in runs)
    tokens = sum(len(r["tokens"]) for r in results if r)
    ttft = [1e3 * (t["first_put"] - t["submit"]) for t in traces]
    equal = [r is not None and r["tokens"] == d
             for r, d in zip(results, direct)]
    print(f"[cmd] {CMD_PROMPTS} generate commands, prompts "
          f"{[len(p) for p in prompts]}, {CMD_NEW} new tokens each: exit "
          f"codes {[c for c, _, _, _ in runs]}, stderr "
          f"{sorted({e for _, _, e, _ in runs})}; {tokens / wall:.1f} tok/s "
          f"over the commands' {wall:.3f} s; TTFT mean "
          f"{float(np.mean(ttft)):.1f} ms (max {max(ttft):.1f}); equal to "
          f"engine.generate {sum(equal)}/{len(equal)}; rows {n_rows}; "
          f"{admissions} admissions in {replays} replays, {steps} decode "
          f"steps; launches {counts}; card: {card}", flush=True)
    require(all(c == 0 and e == "" for c, _, e, _ in runs),
            f"a generate command failed: {[(c, e) for c, _, e, _ in runs]}")
    require(all(equal), f"CLI streams equal to engine.generate: {equal}")
    require(all(len(r["tokens"]) == CMD_NEW and r["prompt_len"] == len(p)
                for r, p in zip(results, prompts)),
            "a command's result has the wrong shape")
    require(n_rows == CMD_PROMPTS and stored == [r["tokens"]
                                                 for r in results],
            f"{n_rows} rows in generations for {CMD_PROMPTS} commands")
    require(admissions == replays == CMD_PROMPTS,
            f"{admissions} admissions in {replays} replays for "
            f"{CMD_PROMPTS} commands")
    require(counts["flash_prefill"] == LAYERS * admissions
            and counts["flash_decode"] == LAYERS * steps and steps > 0,
            f"launches {counts} for {admissions} bucket admissions and "
            f"{steps} decode steps of {LAYERS} layers")
    require(counts["prefill_plain"] == counts["decode_plain"]
            == counts["paged_plain"] == counts["paged_decode"]
            == counts["paged_window"] == 0,
            f"a plain version or another kernel ran: {counts}")
    print(f"[cmd] an unknown command: exit {unknown[0]}, stdout "
          f"{unknown[1]!r}, stderr {unknown[2]!r}; a raising handler: exit "
          f"{failing[0]}, stdout {failing[1]!r}, stderr {failing[2]!r}",
          flush=True)
    require(unknown[0] == 1 and unknown[1] == ""
            and unknown[2].startswith("No Command Found!\n")
            and "generate" in unknown[2] and "-prompt 1,2,3" in unknown[2],
            f"the unknown command: {unknown}")
    require(failing[:3] == (1, "", "refused: on purpose\n"),
            f"the raising handler: {failing}")
    del app, gen
    gc.collect()
    torch.cuda.empty_cache()

    # 5. the log file: log lines only, the migration events among them
    with open(log) as f:
        lines = f.read().splitlines()
    entries = [json.loads(ln) for ln in lines]
    events = [e["message"].get("event") for e in entries
              if isinstance(e.get("message"), dict)]
    print(f"[cmd] the log file: {len(lines)} lines, events "
          f"{sorted(set(events))}", flush=True)
    require(all(set(e) >= {"level", "time", "message"} for e in entries),
            "a line of the log file is not a log entry")
    require(events.count("migration applied") == 2
            and events.count("migration failed") == 1,
            f"the log file's migration events: {events}")

    # 6. the CLI as a process of its own, at 2 layers
    spec = {"rows": dict(rows, TPU_MODEL=f"llama3-8b-{CMD_PROC_LAYERS}l",
                         DB_NAME=os.path.join(tmp.name, "proc.db"),
                         CMD_LOGS_FILE=os.path.join(tmp.name, "proc.log")),
            "base": MAIN_ROWS["TPU_MODEL"], "layers": CMD_PROC_LAYERS,
            "device": device}
    argv = ["generate", "-prompt", ",".join(map(str, prompts[0])), "-max",
            str(CMD_NEW)]
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-c", CMD_CLI, json.dumps(spec), *argv], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=CMD_PROC_S, stdin=subprocess.DEVNULL)
    proc_s = time.monotonic() - t0
    report = [json.loads(ln[len("[cli] "):]) for ln in
              proc.stderr.splitlines() if ln.startswith("[cli] ")]
    print(f"[cmd] the CLI as a process of its own ({CMD_PROC_LAYERS} "
          f"layers): exit {proc.returncode} in {proc_s:.1f} s, stdout "
          f"{len(proc.stdout)} bytes, its report {report}; card: {card}",
          flush=True)
    require(proc.returncode == 0 and len(report) == 1,
            f"the CLI process: exit {proc.returncode}, stderr "
            f"{proc.stderr[-2000:]}")
    out = json.loads(proc.stdout)
    rep = report[0]
    require(len(out["tokens"]) == CMD_NEW
            and all(0 <= t < vocab for t in out["tokens"]),
            f"the CLI process's result {out}")
    require(rep["live"] == ["gofr-torch-gen"] and rep["admissions"] == 1
            and rep["flash_prefill"] == CMD_PROC_LAYERS
            and rep["flash_decode"] == CMD_PROC_LAYERS * rep["steps"] > 0
            and rep["plain"] == 0, f"the CLI process's report {rep}")
    tmp.cleanup()
    summary = {"migrations_applied": len(ledger),
               "commands": CMD_PROMPTS, "equal": sum(equal),
               "tok_s": tokens / wall,
               "ttft_mean_ms": float(np.mean(ttft)),
               "launches": {"flash_prefill": counts["flash_prefill"],
                            "flash_decode": counts["flash_decode"]},
               "admissions": admissions, "decode_steps": steps,
               "subprocess_s": proc_s, "phase_s": time.monotonic() - t_phase,
               "card": card}
    print(json.dumps({"cmd": summary}), flush=True)
    return {"flash_prefill": counts["flash_prefill"],
            "flash_decode": counts["flash_decode"]}


# -- phase observe: the flight recorder, the timeline, the fleet, Zipkin -----

OBSERVE_ROWS = dict(MAIN_ROWS, HTTP_PORT="0", METRICS_PORT="0",
                    LOG_LEVEL="WARN", APP_NAME="replica", TPU_TIMELINE="1",
                    DEBUG_EVENT_BUFFER="4096", TPU_TRACE_SAMPLE="0.5",
                    TPU_TRACE_TAIL_LINGER_S="2")
OBSERVE_SEED = 83
OBSERVE_STREAMS = 16          # POST /generate streams with a traceparent
OBSERVE_LENS = (17, 500)      # their prompts: bucket admissions (K1)
OBSERVE_NEW = 32
OBSERVE_EXPIRE = (64, "150ms")  # the 17th: its prompt, X-Request-Timeout
OBSERVE_EXPIRE_AFTER_S = 0.05   # sent this long after the 16
OBSERVE_GATEWAY = 2           # streams through the gateway, for the joins
OBSERVE_WAIT_S = 20


class ZipkinCollector:
    """An in-process Zipkin collector on localhost: the spans of every
    ``POST /api/v2/spans`` body it was sent."""

    def __init__(self):
        import http.server
        import threading

        spans = self.spans = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                spans.extend(json.loads(self.rfile.read(n)))
                self.send_response(202)
                self.end_headers()

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       name="zipkin-collector", daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(5.0)


def _observe_app(rows: dict):
    """A replica App with POST /generate on "cuda", running, its logs
    (the per-request wide lines among them) kept in a buffer."""
    import io

    from gofr_tpu_torch import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.glog import Logger, LogLevel
    from gofr_tpu_torch.serving import install_generate

    buf = io.StringIO()
    app = App(MapConfig(rows), logger=Logger(level=LogLevel.WARN, out=buf,
                                             err=buf, pretty=False))
    if rows.get("TPU_SERVING_ROLE") != "gateway":
        install_generate(app)
    app.run(block=False)
    return app, buf


def _observe_burst(port: int, prompts, traceparents, expire=None) -> tuple:
    """The 16 streams at once, each with its traceparent, and, with
    ``expire`` = (prompt, traceparent), a 17th with a short
    X-Request-Timeout sent right behind them: (results, the 16's start
    and end on the monotonic clock)."""
    import threading

    late = {}

    def late_call():
        time.sleep(OBSERVE_EXPIRE_AFTER_S)
        late["res"] = _timed_generate(
            port, {"tokens": expire[0], "max_new": OBSERVE_NEW},
            {"traceparent": expire[1],
             "X-Request-Timeout": OBSERVE_EXPIRE[1]})

    t = None
    if expire is not None:
        t = threading.Thread(target=late_call, daemon=True)
        t.start()
    t0 = time.monotonic()
    res = _threads([lambda p=p, tp=tp: _timed_generate(
        port, {"tokens": p, "max_new": OBSERVE_NEW}, {"traceparent": tp})
        for p, tp in zip(prompts, traceparents)])
    t1 = time.monotonic()
    if t is not None:
        t.join(APP_JOIN_S)
        res.append(late.get("res"))
    return res, t0, t1


def phase_observe(card: str) -> dict:
    """Observability on the main path: a replica App of phase 5's rows
    (Llama-3-8B, contiguous int8 KV, 8 slots) with the timeline on,
    DEBUG_EVENT_BUFFER, TRACER_HOST/TRACER_PORT on an in-process Zipkin
    collector and TPU_TRACE_SAMPLE=0.5, a gateway App naming it in
    TPU_OBS_PEERS. The burst (16 POST /generate streams with
    traceparents) on an App with TPU_TIMELINE=0, then on this one, for
    tok/s and the idle share (the timeline's dispatch gaps over the
    burst); then the checked burst: the 16 again under new traceparents
    with a profile running and a 17th whose deadline runs out in the
    queue. Checks the timeline against the launch counters (K2 32 a
    decode step, K1 32 a prefill), its slot and HBM counter tracks, one
    wide event a stream and its breakdown, /debug/request, /debug/vars,
    the profile's samples of the serving loop, the spans the collector
    kept, fault 13's series and the gateway's fleet merge. Returns the
    launch counts of the checked burst."""
    import gc
    import threading

    import numpy as np
    import torch

    from gofr_tpu_torch.models import LLAMA_CONFIGS

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.monotonic()
    rng = np.random.default_rng(OBSERVE_SEED)
    vocab = LLAMA_CONFIGS[OBSERVE_ROWS["TPU_MODEL"]].vocab_size
    lens = rng.integers(OBSERVE_LENS[0], OBSERVE_LENS[1] + 1,
                        OBSERVE_STREAMS).tolist()
    prompts = [rng.integers(0, vocab, n).tolist() for n in lens]
    # the timed bursts' traceparents, then the checked burst's, the
    # 17th's and the gateway streams'
    tps_timed = [f"00-{rng.bytes(16).hex()}-{rng.bytes(8).hex()}-01"
                 for _ in range(OBSERVE_STREAMS)]
    tps = [f"00-{rng.bytes(16).hex()}-{rng.bytes(8).hex()}-01"
           for _ in range(OBSERVE_STREAMS + 1 + OBSERVE_GATEWAY)]
    tids = [tp.split("-")[1] for tp in tps]
    expire = (rng.integers(0, vocab, OBSERVE_EXPIRE[0]).tolist(),
              tps[OBSERVE_STREAMS])
    collector = ZipkinCollector()
    tracer_rows = {"TRACER_HOST": "127.0.0.1",
                   "TRACER_PORT": str(collector.port)}

    def streamed(res) -> int:
        return len(_tokens(res)) if res and res["status"] == 200 else 0

    # 1. the same burst with TPU_TIMELINE=0: no ring, the engine holds None
    t0 = time.monotonic()
    off, _ = _observe_app(dict(OBSERVE_ROWS, TPU_TIMELINE="0",
                               **tracer_rows))
    off_gen = off.container.tpu.generator
    try:
        require(off_gen._tl is None and off.container.tpu._tl is None,
                "TPU_TIMELINE=0 left the engine a timeline")
        _timed_generate(off.http_port, {"tokens": prompts[0][:32],
                                        "max_new": 4})
        off_res, b0, b1 = _observe_burst(off.http_port, prompts, tps_timed)
        off_wall = b1 - b0
        off_stats = http_call(off.metrics_port, "GET",
                              "/debug/timeline?format=stats")["body"]
    finally:
        off.stop()
        release_graphs(off_gen)
    off_ready_s = time.monotonic() - t0 - off_wall
    del off, off_gen
    gc.collect()
    torch.cuda.empty_cache()
    off_tok_s = sum(streamed(r) for r in off_res) / off_wall
    require(not off_stats["enabled"] and off_stats["buffered"] == 0,
            f"the off App's ring: {off_stats}")
    collector.spans.clear()

    # 2. the replica with the timeline on, and a gateway in front
    t0 = time.monotonic()
    rep, rep_log = _observe_app(dict(OBSERVE_ROWS, **tracer_rows))
    gw = None
    try:
        gen = rep.container.tpu.generator
        tl = rep.container.observe.timeline
        require(gen._tl is tl and tl.enabled and tl.capacity == 65536,
                "the replica's engine does not hold the App's timeline")
        peer = f"replica:127.0.0.1:{rep.http_port}"
        gw, _ = _observe_app({
            "HTTP_PORT": "0", "METRICS_PORT": "0",
            "APP_NAME": "gateway", "TPU_SERVING_ROLE": "gateway",
            "TPU_GATEWAY_REPLICAS": f"127.0.0.1:{rep.http_port}",
            "TPU_GATEWAY_HEALTH_INTERVAL_S": "0.5",
            "TPU_OBS_PEERS": f"{peer}=http://127.0.0.1:{rep.metrics_port}",
            "TPU_OBS_FLEET_TIMEOUT_S": "10", **tracer_rows})
        _timed_generate(rep.http_port, {"tokens": prompts[0][:32],
                                        "max_new": 4})
        ready_s = time.monotonic() - t0
        clock = gw.container.observe.clock
        end = time.monotonic() + OBSERVE_WAIT_S
        while not clock.peer(peer).aligned and time.monotonic() < end:
            time.sleep(0.05)
        require(clock.peer(peer).aligned,
                f"the gateway never sampled {peer}'s clock")

        # 3. the same burst as the off App's, nothing else running
        seq_t = timeline_mark(gen)
        steps_t = gen.decode_steps
        timed, t0, t1 = _observe_burst(rep.http_port, prompts, tps_timed)
        wall = t1 - t0
        timed_ring = timeline_window(gen, seq_t, gen.decode_steps - steps_t,
                                     clip=(t0, t1))

        # 4. the checked burst, a profile of it, the expiring 17th
        _reset_launches()
        steps0, adm0 = gen.decode_steps, gen.admissions
        seq0 = timeline_mark(gen)
        prof = {}

        def profile():
            prof["res"] = http_call(rep.metrics_port, "GET",
                                    "/debug/pprof/profile?seconds=1")

        pt = threading.Thread(target=profile, daemon=True)
        pt.start()
        res, b0, b1 = _observe_burst(rep.http_port, prompts, tps, expire)
        pt.join(30.0)
        steps = gen.decode_steps - steps0
        admissions = gen.admissions - adm0
        ring = timeline_window(gen, seq0, steps, clip=(b0, b1))
        counts = _launches()
        trace = http_call(rep.metrics_port, "GET", "/debug/timeline")["body"]
        events = http_call(rep.metrics_port, "GET",
                           "/debug/events?event=request&n=4096")["body"]
        story = http_call(rep.metrics_port, "GET",
                          f"/debug/request?trace_id={tids[0]}")["body"]
        rep_vars = http_call(rep.metrics_port, "GET", "/debug/vars")["body"]
        metrics = http_call(rep.metrics_port, "GET",
                            "/metrics")["body"].decode()

        # 5. two streams through the gateway, then its fleet merge
        via_gw = [_timed_generate(gw.http_port, {
            "tokens": prompts[i], "max_new": 8},
            {"traceparent": tps[OBSERVE_STREAMS + 1 + i]})
            for i in range(OBSERVE_GATEWAY)]
        time.sleep(0.2)
        t_merge = time.monotonic()
        merged = http_call(gw.metrics_port, "GET",
                           "/debug/timeline?fleet=1")["body"]
        merge_ms = 1e3 * (time.monotonic() - t_merge)
        gw_vars = http_call(gw.metrics_port, "GET", "/debug/vars")["body"]
        sampler = rep.container.tracer.exporter.stats()
        verdicts = dict(rep.container.tracer.exporter._verdicts)
    finally:
        if gw is not None:
            gw.stop()
        rep.stop()     # the Container's close flushes the exporter
        release_graphs(rep.container.tpu.generator)
    collector.close()
    card_name = torch.cuda.get_device_name(0)

    # the streams: 16 whole (three times), the 17th a 504 before any token
    out = res[:OBSERVE_STREAMS]
    late = res[OBSERVE_STREAMS]
    on_tok_s = sum(streamed(r) for r in timed) / wall
    idle_share = timed_ring["gap_s"] / wall
    print(f"[observe] two replica Apps of {OBSERVE_ROWS['TPU_MODEL']} "
          f"({OBSERVE_ROWS['TPU_SLOTS']} slots, int8 KV): TPU_TIMELINE=0 "
          f"ready in {off_ready_s:.1f} s, TPU_TIMELINE=1 beside a gateway "
          f"ready in {ready_s:.1f} s; the burst ({OBSERVE_STREAMS} streams, "
          f"prompts {lens}, {OBSERVE_NEW} new tokens each): TPU_TIMELINE=0 "
          f"{off_tok_s:.1f} tok/s over {off_wall:.3f} s, TPU_TIMELINE=1 "
          f"{on_tok_s:.1f} tok/s over {wall:.3f} s; dispatch gaps on the "
          f"timeline {1e3 * timed_ring['gap_s']:.3f} ms, idle share "
          f"{idle_share:.4f} (the checked burst, beside a profile: "
          f"{1e3 * ring['gap_s']:.3f} ms over {b1 - b0:.3f} s); card: "
          f"{card}", flush=True)
    require(all(r["status"] == 200 and streamed(r) == OBSERVE_NEW
                for r in out + off_res + timed),
            f"a stream failed: "
            f"{[r['status'] for r in out + off_res + timed]}")
    require(late is not None and late["status"] == 504,
            f"the expiring request: {late and late['status']}")

    # the timeline against the launch counters, over HTTP
    body = [e for e in trace["traceEvents"]
            if e.get("args", {}).get("seq", -1) >= seq0]
    decode_seqs = {e["args"]["seq"]: e["args"]["steps"] for e in body
                   if e.get("cat") == "decode"}
    prefills = [e for e in body if e.get("cat") == "prefill"]
    slots = sorted(e["args"]["name"] for e in trace["traceEvents"]
                   if e.get("name") == "thread_name"
                   and e["args"]["name"].startswith("slot "))
    hbm_tracks = sorted({e["name"] for e in trace["traceEvents"]
                         if e.get("ph") == "C"
                         and e["name"].startswith("hbm:")})
    print(f"[observe] /debug/timeline over the burst: "
          f"{len(decode_seqs)} decode blocks of {sum(decode_seqs.values())} "
          f"steps, {len(prefills)} prefills, slot tracks {slots}, counter "
          f"tracks {hbm_tracks}; {steps} decode steps and {admissions} "
          f"admissions dispatched; launches {counts}; card: {card}",
          flush=True)
    require(counts["flash_decode"] == LAYERS * sum(decode_seqs.values())
            == LAYERS * steps > 0,
            f"K2 launches {counts['flash_decode']} for the timeline's "
            f"{sum(decode_seqs.values())} decode steps of {LAYERS} layers")
    require(counts["flash_prefill"] == LAYERS * len(prefills)
            == LAYERS * admissions
            and admissions == OBSERVE_STREAMS,
            f"K1 launches {counts['flash_prefill']} for the timeline's "
            f"{len(prefills)} prefills of {LAYERS} layers")
    require(counts["prefill_plain"] == counts["decode_plain"]
            == counts["paged_decode"] == counts["paged_window"] == 0,
            f"a plain version or another kernel ran: {counts}")
    require(0 < len(slots) <= int(OBSERVE_ROWS["TPU_SLOTS"])
            and "hbm:engine" in hbm_tracks,
            f"slot tracks {slots}, counter tracks {hbm_tracks}")

    # one wide event a stream: its tokens, its breakdown
    wide = {}
    for e in events["events"]:
        wide.setdefault(e.get("trace_id"), []).append(e)
    bad = []
    for i, r in enumerate(out):
        (e,) = wide.get(tids[i], [None])
        if e is None or e["outcome"] != "finished" \
                or e["tokens"] != streamed(r) \
                or abs(sum(e["breakdown"].values()) - e["duration_s"]) \
                > 1e-3:
            bad.append((i, e))
    (late_ev,) = wide.get(tids[OBSERVE_STREAMS], [None])
    log_lines = [m for m in (json.loads(ln).get("message") for ln in
                             rep_log.getvalue().splitlines())
                 if isinstance(m, dict) and m.get("event") == "request"]
    print(f"[observe] /debug/events: {len(events['events'])} request "
          f"events; the expiring request's: {late_ev}; the log's wide "
          f"lines {len(log_lines)}; /debug/request: {story['found']} "
          f"event(s) for {tids[0]}; card: {card}", flush=True)
    require(not bad, f"streams without one matching wide event: {bad}")
    require(late_ev is not None and late_ev["outcome"] == "failed"
            and late_ev.get("where") == "queue",
            f"the expiring request's wide event: {late_ev}")
    require(len(log_lines) >= OBSERVE_STREAMS + 2,
            f"{len(log_lines)} wide lines in the replica's log")
    require(story["found"] >= 1 and story["stories"][0]["events"][0][
        "trace_id"] == tids[0], f"/debug/request: {story}")

    # /debug/vars
    print(f"[observe] /debug/vars: the replica's devices "
          f"{rep_vars['devices']}, the gateway's fleet_clock "
          f"{gw_vars.get('fleet_clock')}; card: {card}", flush=True)
    for v in (rep_vars, gw_vars):
        require(v["devices"].get("device_kind") == card_name
                and v["devices"].get("platform") == "gpu",
                f"/debug/vars devices: {v['devices']}")
        require("timeline" in v and "trace_sampler" in v,
                f"/debug/vars sections: {sorted(v)}")
    require("fleet_clock" in gw_vars and peer in gw_vars["fleet_clock"],
            f"the gateway's /debug/vars: {sorted(gw_vars)}")

    # the profile taken during the burst
    prof_res = prof.get("res") or {}
    lines = (prof_res.get("body") or b"").decode().splitlines()
    loop = [ln for ln in lines if ln.startswith("gofr-torch-gen;")]
    print(f"[observe] /debug/pprof/profile?seconds=1 during the burst: "
          f"status {prof_res.get('status')}, "
          f"{prof_res.get('headers', {}).get('X-Profile-Samples')} samples, "
          f"{len(loop)} stacks of the serving loop; card: {card}",
          flush=True)
    require(prof_res.get("status") == 200 and loop,
            "the profile has no sample of the serving loop")

    # the spans the collector received, against the tail sampler's
    # verdicts: every trace id at a hash fraction under 0.5 is kept, the
    # others only as interesting or slow (above the rolling p99 of the
    # replica's roots, the gateway's health polls among them)
    def sampled(tid):
        return int(tid[:13], 16) / float(16 ** 13) < 0.5

    by_trace = {}
    for z in collector.spans:
        if z["localEndpoint"]["serviceName"] == "replica":
            by_trace.setdefault(z["traceId"], set()).add(z["name"])
    kept = [t for t in tids[:OBSERVE_STREAMS] if verdicts.get(t)]
    received = [t for t in tids[:OBSERVE_STREAMS] if t in by_trace]
    stages = {"tpu.admit-wait", "tpu.prefill", "tpu.decode"}
    print(f"[observe] the Zipkin collector: {len(collector.spans)} spans, "
          f"the burst's traces kept {len(kept)} of {OBSERVE_STREAMS} "
          f"({sum(map(sampled, tids[:OBSERVE_STREAMS]))} under the 0.5 "
          f"hash fraction), received {len(received)}, the expired trace "
          f"{'kept' if tids[OBSERVE_STREAMS] in by_trace else 'dropped'}; "
          f"sampler {sampler}; card: {card}", flush=True)
    require(all(t in verdicts for t in tids[:OBSERVE_STREAMS + 1]),
            "the sampler never judged a trace of the burst")
    require(received == kept and kept, f"received {received}, kept {kept}")
    require(all(verdicts[t] for t in tids[:OBSERVE_STREAMS] if sampled(t)),
            "a trace under the hash fraction was dropped")
    require(all(stages <= by_trace[t] for t in kept),
            f"a kept trace lacks a stage span: "
            f"{[sorted(by_trace[t]) for t in kept]}")
    require(tids[OBSERVE_STREAMS] in by_trace
            and sampler["kept_by_reason"]["interesting"] >= 1,
            "the expired trace was not kept")

    # fault 13's series
    def series(name):
        return [ln for ln in metrics.splitlines() if ln.startswith(name)
                and 'program="generate"' in ln]

    gap_n = sum(float(ln.rsplit(" ", 1)[1])
                for ln in series("app_tpu_dispatch_gap_duration_count"))
    seg_n = sum(float(ln.rsplit(" ", 1)[1])
                for ln in series("app_tpu_request_segment_duration_count"))
    depth = series("app_tpu_pipeline_depth")
    print(f"[observe] /metrics: app_tpu_dispatch_gap_duration {gap_n:.0f} "
          f"samples, app_tpu_request_segment_duration {seg_n:.0f}, "
          f"app_tpu_pipeline_depth {depth}; card: {card}", flush=True)
    require(gap_n > 0 and seg_n > 0 and depth,
            "fault 13's series have no samples")

    # the gateway's fleet merge
    fleet = merged["otherData"]["fleet"]
    proc = next((p for p in fleet["processes"] if p["name"] == peer), None)
    peer_decodes = [e for e in merged["traceEvents"]
                    if proc is not None and e.get("pid") == proc["pid"]
                    and e.get("cat") == "decode"]
    print(f"[observe] the gateway's /debug/timeline?fleet=1 in "
          f"{merge_ms:.1f} ms: processes {fleet['processes']}, degraded "
          f"{fleet['degraded']}, {len(peer_decodes)} decode slices of "
          f"the replica, traces joined {fleet['traces_joined']}, flow "
          f"events {fleet['flow_events']}; the gateway's streams "
          f"{[r['status'] for r in via_gw]}; card: {card}", flush=True)
    require(proc is not None and proc["offset_s"] is not None
            and not any(d["peer"] == peer for d in fleet["degraded"])
            and peer_decodes,
            f"the fleet merge lacks the aligned replica: {fleet}")
    require(all(r["status"] == 200 for r in via_gw)
            and fleet["traces_joined"] >= OBSERVE_GATEWAY,
            f"the gateway's streams {[r['status'] for r in via_gw]}, "
            f"traces joined {fleet['traces_joined']}")
    summary = {"tok_s_timeline_off": off_tok_s, "tok_s_timeline_on": on_tok_s,
               "burst_s_off": off_wall, "burst_s_on": wall,
               "gap_ms": 1e3 * timed_ring["gap_s"], "idle_share": idle_share,
               "decode_steps": steps, "admissions": admissions,
               "launches": {"flash_prefill": counts["flash_prefill"],
                            "flash_decode": counts["flash_decode"]},
               "kept_traces": len(kept), "merge_ms": merge_ms,
               "phase_s": time.monotonic() - t_phase, "card": card}
    print(json.dumps({"observe": summary}), flush=True)
    return {"flash_prefill": counts["flash_prefill"],
            "flash_decode": counts["flash_decode"]}


RECORD_KEYS = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
               "bound_by", "library_ms")


def run(phases=("build", "kernels", "model", "main", "paged", "spec",
                "durable", "slo", "app", "predict", "grpc", "tiers", "lora",
                "pubsub", "tenancy", "gateway", "pd", "tp", "cmd",
                "observe")) -> dict:
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
        elif phase in ("grpc", "tiers", "lora", "tenancy", "gateway", "pd",
                       "tp", "cmd", "observe"):
            counts = {"grpc": phase_grpc, "tiers": phase_tiers,
                      "lora": phase_lora, "tenancy": phase_tenancy,
                      "gateway": phase_gateway, "pd": phase_pd,
                      "tp": phase_tp, "cmd": phase_cmd,
                      "observe": phase_observe}[phase](card)
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
