// Causal GQA flash attention for prefill, bf16, head_dim 128, sm_90a.
//
// Replaces the TPU kernel gofr_tpu/ops/flash.py::_flash_kernel (the
// pallas_call in flash_causal_prefill). Same function: q [B, S, H, D],
// k/v [B, S, KV, D], query head h reads KV head h*KV/H, keys at or past
// lengths[b] are masked, query rows at or past lengths[b] come out as
// zeros, softmax is the online (running max / running sum) recurrence
// in float32 with the probabilities rounded to bf16 for the second
// product, so the [S, S] score matrix never reaches device memory.
//
// What bounds it on an H100: at B=1, S=512, H=32, KV=8 one launch moves
// about 10.5 MB of Q/K/V/O (3.1 us at 3.35 TB/s) and does 2.1 GFLOP on
// the causal half (2.2 us at 989 TFLOP/s bf16): bytes, and in practice
// the latency of the longest block's chain of four key tiles. From S of
// about 750 on the operations bound it (18.4 GFLOP at S=1500, 137.5
// GFLOP at S=4096), so the tensor cores have to be kept fed: the
// softmax must run beside the products, and the K/V tiles, which every
// query tile reads again from L2, must arrive without the math waiting.
//
// Design:
//  - a block is three warpgroups: two consumers that each own 64 of the
//    block's 128 query rows, and a producer that only copies. setmaxnreg
//    moves registers from the producer (40) to the consumers (232 each);
//  - both products run on wgmma m64n128k16 against 128-key tiles: Q K^T
//    with both operands in shared memory, P V with P in registers. The
//    scores, the probabilities, the running max / sum and the float32
//    output accumulator live in registers for the whole loop. A row sits
//    in one quad of lanes, so the row max is two shuffles; the row sum is
//    reduced once, at the end;
//  - Q, K and V tiles are [128, 128] bf16 stored as two [128, 64] panels
//    in the 128-byte swizzle that wgmma descriptors read. K is K-major
//    for Q K^T as it lies; V is the MN-major B operand of P V (transpose
//    bit set, k-steps advance by rows), so nothing is transposed;
//  - K tiles and V tiles arrive by 16-byte cp.async (zero-filled past
//    the last key) in two rings of two stages. The producer waits for an
//    entry's `empty` mbarrier, copies, and lets the copies' completion
//    arrive on its `full` mbarrier; a consumer warp arrives on `empty`
//    when its wgmma has read the entry. No block barrier inside the loop:
//    the consumers drift apart, so one's softmax runs beside the other's
//    products;
//  - inside a consumer, tile t's Q K^T and tile t - 1's P V are started
//    together, and tile t's softmax runs while the second is in flight;
//    the output is rescaled before the next P V starts;
//  - blocks are numbered so that the last query tiles, which have the
//    longest key loops, start first, across all heads and sequences;
//  - the loop over key tiles stops at the diagonal AND at lengths[b]:
//    keys past the prompt are neither read nor computed, and a tile
//    whose rows are all past the length writes zeros and reads nothing.
//    The causal and the length compare run only on a tile that crosses
//    the diagonal or holds lengths[b];
//  - exp2 with scale * log2(e) folded into one multiply-add per score;
//  - any S works: a ragged last tile is zero-filled and masked, rows at
//    or past S are never written;
//  - the epilogue stages O / l as bf16 in the warpgroup's own Q rows
//    (free by then) and writes 16 bytes per lane, rows coalesced.

#include "common.cuh"

namespace {

constexpr int BK = 128;                  // keys per tile
constexpr int D = 128;                   // head_dim
constexpr int WG = 128;                  // threads of a warpgroup
constexpr int NWG = 2;                   // consumer warpgroups of a block
constexpr int BQ = NWG * 64;             // query rows per block
constexpr int NT = (NWG + 1) * WG;       // the consumers, then the producer
constexpr int STAGES = 2;                // of the K ring and of the V ring
constexpr int ROW_BYTES = 128;           // a panel row: 64 bf16, one swizzle row
constexpr int Q_PANEL = BQ * ROW_BYTES;  // [BQ, 64] bf16
constexpr int KV_PANEL = BK * ROW_BYTES; // [BK, 64] bf16
constexpr int KV_TILE = 2 * KV_PANEL;    // [BK, 128] bf16 as two panels
constexpr float LOG2E = 1.4426950408889634f;
constexpr int CONSUMER_REGS = 232;       // 2 x 128 x 232 + 128 x 40 <= 65536
constexpr int PRODUCER_REGS = 40;

// shared memory: Q, the K ring, the V ring (all aligned to the 1 KB
// swizzle period, hence 1 KB of slack), then the barriers
constexpr int OFF_K = 2 * Q_PANEL;
constexpr int OFF_V = OFF_K + STAGES * KV_TILE;
constexpr int OFF_BAR = OFF_V + STAGES * KV_TILE;
constexpr int N_BARS = 1 + 4 * STAGES;   // Q full; K, V full and empty
constexpr int SMEM_BYTES = 1024 + OFF_BAR + 8 * N_BARS;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive once every cp.async this thread has started so far has landed
// (counted in the barrier's expected arrivals, not added to them).
__device__ __forceinline__ void mbar_arrive_after_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// -- copies ------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Byte offset of 16-byte chunk c16 (0..15) of row r in a [rows, 128]
// bf16 tile stored as two swizzled panels of panel_bytes each.
__device__ __forceinline__ uint32_t tile_offset(int r, int c16,
                                                int panel_bytes) {
  return (c16 >> 3) * panel_bytes + r * ROW_BYTES +
         (((c16 & 7) ^ (r & 7)) << 4);
}

// The producer warpgroup starts the copy of a [128, 128] tile, rows
// `stride` elements apart in device memory, into its swizzled panels:
// lane `tid` of 128 copies chunk tid % 16 of rows tid / 16 + 8 i. Rows at
// or past `limit` are zero-filled and not read.
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          size_t stride, int row0, int limit,
                                          int tid) {
  const int r = tid >> 4;
  const int c = tid & 15;
  const __nv_bfloat16* g = src + (size_t)(row0 + r) * stride + c * 8;
  dst += tile_offset(r, c, 128 * ROW_BYTES);
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const bool live = row0 + r + 8 * i < limit;
    cp_async16(dst + i * 8 * ROW_BYTES, live ? g + (size_t)(8 * i) * stride : src,
               live ? 16 : 0);
  }
}

// -- wgmma -------------------------------------------------------------------

// Shared-memory operand descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving uses of wgmma's registers across the
// asynchronous window.
__device__ __forceinline__ void fence_regs(float (&x)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

#define GOFR_ACC8(d, i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define GOFR_ACC64(d)                                                     \
  GOFR_ACC8(d, 0), GOFR_ACC8(d, 8), GOFR_ACC8(d, 16), GOFR_ACC8(d, 24),   \
      GOFR_ACC8(d, 32), GOFR_ACC8(d, 40), GOFR_ACC8(d, 48), GOFR_ACC8(d, 56)
#define GOFR_D64                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                  \
  "%8, %9, %10, %11, %12, %13, %14, %15, "             \
  "%16, %17, %18, %19, %20, %21, %22, %23, "           \
  "%24, %25, %26, %27, %28, %29, %30, %31, "           \
  "%32, %33, %34, %35, %36, %37, %38, %39, "           \
  "%40, %41, %42, %43, %44, %45, %46, %47, "           \
  "%48, %49, %50, %51, %52, %53, %54, %55, "           \
  "%56, %57, %58, %59, %60, %61, %62, %63}, "

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared
// memory; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a,
                                                    uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " GOFR_D64
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : GOFR_ACC64(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A in registers (each warp's
// m16n8k16 A fragment), B MN-major in shared memory (transpose bit).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t* a,
                                                    uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " GOFR_D64
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : GOFR_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// s = Q K^T for one warpgroup's 64 rows against a 128-key tile: 8 steps
// of 16 along head_dim, 4 to a panel.
__device__ __forceinline__ void start_qk(float (&s)[64], uint64_t desc_q,
                                         uint32_t k_tile) {
  const uint64_t desc_k = make_desc(k_tile, 16, 8 * ROW_BYTES);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n128k16_ss(
        s, desc_q + (((kk & 3) * 32 + (kk >> 2) * Q_PANEL) >> 4),
        desc_k + (((kk & 3) * 32 + (kk >> 2) * KV_PANEL) >> 4), kk != 0);
  wgmma_commit();
}

// o += P V for the same rows and tile: 8 steps of 16 keys (V's rows are
// the k dimension), P from registers.
__device__ __forceinline__ void start_pv(float (&o)[64],
                                         const uint32_t (&p)[32],
                                         uint32_t v_tile) {
  const uint64_t desc_v = make_desc(v_tile, KV_PANEL, 8 * ROW_BYTES);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_m64n128k16_rs(o, p + 4 * kk, desc_v + ((kk * 16 * ROW_BYTES) >> 4));
  wgmma_commit();
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- softmax -----------------------------------------------------------------

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The running state of this lane's two rows: their max so far (in score
// units) and this lane's share of their sums.
struct Rows {
  float m0, m1, l0, l1;
};

// One tile's online-softmax step. s[4j + e] is the score of row
// (e < 2 ? row0 : row0 + 8) against key k0 + 8j + 2 quad + (e & 1). Leaves
// the probabilities in s, updates the rows' state and returns the factors
// that bring the output accumulated so far to the new max.
__device__ __forceinline__ void softmax_tile(float (&s)[64], Rows& st,
                                             float& corr0, float& corr1,
                                             float sl2, bool masked, int k0,
                                             int quad, int row0, int length) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int key = k0 + 8 * (i >> 2) + 2 * quad + (i & 1);
      const int row = (i & 2) ? row0 + 8 : row0;
      if (key > row || key >= length) s[i] = gofr::kNegInf;
    }
  }
  float mx0 = gofr::kNegInf, mx1 = gofr::kNegInf;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  const float mn0 = fmaxf(st.m0, quad_max(mx0));
  const float mn1 = fmaxf(st.m1, quad_max(mx1));
  corr0 = fast_exp2((st.m0 - mn0) * sl2);
  corr1 = fast_exp2((st.m1 - mn1) * sl2);
  st.m0 = mn0;
  st.m1 = mn1;
  // a row with no key yet keeps max kNegInf: subtract 0, so that its
  // masked scores give exp2(-huge) = 0 and not exp2(0)
  const float sub0 = mn0 == gofr::kNegInf ? 0.f : -mn0 * sl2;
  const float sub1 = mn1 == gofr::kNegInf ? 0.f : -mn1 * sl2;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    s[4 * j] = fast_exp2(fmaf(s[4 * j], sl2, sub0));
    s[4 * j + 1] = fast_exp2(fmaf(s[4 * j + 1], sl2, sub0));
    s[4 * j + 2] = fast_exp2(fmaf(s[4 * j + 2], sl2, sub1));
    s[4 * j + 3] = fast_exp2(fmaf(s[4 * j + 3], sl2, sub1));
    rs0 += s[4 * j] + s[4 * j + 1];
    rs1 += s[4 * j + 2] + s[4 * j + 3];
  }
  st.l0 = st.l0 * corr0 + rs0;
  st.l1 = st.l1 * corr1 + rs1;
}

// The probabilities as the bf16 A fragments of the second product: 4
// registers per 16 keys, (row0, row0 + 8) x (keys 0-7, keys 8-15).
__device__ __forceinline__ void pack_probabilities(const float (&s)[64],
                                                   uint32_t (&p)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

__device__ __forceinline__ void rescale(float (&o)[64], float corr0,
                                        float corr1) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    o[4 * j] *= corr0;
    o[4 * j + 1] *= corr0;
    o[4 * j + 2] *= corr1;
    o[4 * j + 3] *= corr1;
  }
}

// -- the kernel --------------------------------------------------------------

// One block: query rows [q0, q0 + 128) of head h of sequence b against
// the key tiles up to the diagonal and lengths[b]. Warpgroups 0 and 1
// each own 64 of the rows; warpgroup 2 copies.
__global__ void __launch_bounds__(NT, 1)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ lengths,
                     __nv_bfloat16* __restrict__ out,
                     int S, int H, int KV, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  unsigned char* const smem = smem_raw + pad;
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_bar = s_q + OFF_BAR;
  // barrier i of: Q full, then per stage K full, V full, K empty, V empty
  auto full_k = [&](int t) { return s_bar + 8 * (1 + (t % STAGES)); };
  auto full_v = [&](int t) { return s_bar + 8 * (1 + STAGES + (t % STAGES)); };
  auto empty_k = [&](int t) {
    return s_bar + 8 * (1 + 2 * STAGES + (t % STAGES));
  };
  auto empty_v = [&](int t) {
    return s_bar + 8 * (1 + 3 * STAGES + (t % STAGES));
  };
  auto tile_k = [&](int t) { return s_q + OFF_K + (t % STAGES) * KV_TILE; };
  auto tile_v = [&](int t) { return s_q + OFF_V + (t % STAGES) * KV_TILE; };
  // the parity of a ring entry's use number t / STAGES
  auto parity = [](int t) { return (uint32_t)((t / STAGES) & 1); };

  // heaviest first: the last query tile of every head and sequence
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = ((int)gridDim.z - 1 - (int)blockIdx.z) * BQ;
  const int kvh = h * KV / H;
  int length = lengths[b];
  length = length < 0 ? 0 : (length > S ? S : length);

  const size_t q_stride = (size_t)H * D;
  const size_t kv_stride = (size_t)KV * D;
  const __nv_bfloat16* qb = q + (size_t)b * S * q_stride + (size_t)h * D;
  const __nv_bfloat16* kb = k + (size_t)b * S * kv_stride + (size_t)kvh * D;
  const __nv_bfloat16* vb = v + (size_t)b * S * kv_stride + (size_t)kvh * D;
  __nv_bfloat16* ob = out + (size_t)b * S * q_stride + (size_t)h * D;

  if (q0 >= length) {  // every row of the tile is padding: zeros
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int i = threadIdx.x; i < BQ * 16; i += NT) {
      const int r = i >> 4;
      if (q0 + r < S)
        *reinterpret_cast<uint4*>(ob + (size_t)(q0 + r) * q_stride +
                                  (i & 15) * 8) = zero;
    }
    return;
  }

  if (threadIdx.x == 0) {
    mbar_init(s_bar, WG);  // Q full: every producer lane's copies
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full_k(i), WG);
      mbar_init(full_v(i), WG);
      mbar_init(empty_k(i), NWG * 4);  // one arrival per consumer warp
      mbar_init(empty_v(i), NWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int kend = min(q0 + BQ, length);  // keys [0, kend) are needed
  const int n_tiles = (kend + BK - 1) / BK;
  const int wg = threadIdx.x / WG;
  const int tid = threadIdx.x % WG;

  if (wg == NWG) {
    // ---- producer: Q, then K and V tile by tile as their ring entries
    // come free
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    load_tile(s_q, qb, q_stride, q0, S, tid);
    mbar_arrive_after_copies(s_bar);
    for (int t = 0; t < n_tiles; ++t) {
      mbar_wait(empty_k(t), parity(t) ^ 1);  // passes at a first use
      load_tile(tile_k(t), kb, kv_stride, t * BK, kend, tid);
      mbar_arrive_after_copies(full_k(t));
      mbar_wait(empty_v(t), parity(t) ^ 1);
      load_tile(tile_v(t), vb, kv_stride, t * BK, kend, tid);
      mbar_arrive_after_copies(full_v(t));
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    // ---- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int lane = tid & 31;
    const int quad = tid & 3;
    const int r0 = (tid >> 5) * 16 + (lane >> 2);  // this lane's rows are
    const int wg_q0 = q0 + wg * 64;                // r0 and r0 + 8
    const int row0 = wg_q0 + r0;
    const float sl2 = scale * LOG2E;
    auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
    };
    auto needs_mask = [&](int t) {  // the diagonal, or the tile of lengths[b]
      return t * BK + BK - 1 > wg_q0 || t * BK + BK > length;
    };

    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    Rows st = {gofr::kNegInf, gofr::kNegInf, 0.f, 0.f};

    if (wg_q0 >= length) {
      // all 64 rows are padding: pass every ring entry on unread
      for (int t = 0; t < n_tiles; ++t) {
        mbar_wait(full_k(t), parity(t));
        release(empty_k(t));
        mbar_wait(full_v(t), parity(t));
        release(empty_v(t));
      }
    } else {
      const uint64_t desc_q =
          make_desc(s_q + wg * 64 * ROW_BYTES, 16, 8 * ROW_BYTES);
      float s[64];
      uint32_t p[32];
      float corr0, corr1;

      mbar_wait(s_bar, 0);
      mbar_wait(full_k(0), 0);
      fence_proxy_async();
      start_qk(s, desc_q, tile_k(0));
      wgmma_wait<0>();
      fence_regs(s);
      release(empty_k(0));
      softmax_tile(s, st, corr0, corr1, sl2, needs_mask(0), 0, quad, row0,
                   length);
      pack_probabilities(s, p);

      // tile t's scores and tile t - 1's P V go to the tensor cores
      // together, and tile t's softmax runs under the second
      for (int t = 1; t < n_tiles; ++t) {
        mbar_wait(full_k(t), parity(t));
        fence_proxy_async();
        start_qk(s, desc_q, tile_k(t));
        rescale(o, corr0, corr1);  // by tile t - 1's factors
        mbar_wait(full_v(t - 1), parity(t - 1));
        fence_proxy_async();
        fence_regs(o);
        start_pv(o, p, tile_v(t - 1));
        wgmma_wait<1>();
        fence_regs(s);
        release(empty_k(t));
        softmax_tile(s, st, corr0, corr1, sl2, needs_mask(t), t * BK, quad,
                     row0, length);
        wgmma_wait<0>();
        fence_regs(o);
        release(empty_v(t - 1));
        pack_probabilities(s, p);
      }
      rescale(o, corr0, corr1);
      mbar_wait(full_v(n_tiles - 1), parity(n_tiles - 1));
      fence_proxy_async();
      fence_regs(o);
      start_pv(o, p, tile_v(n_tiles - 1));
      wgmma_wait<0>();
      fence_regs(o);
      release(empty_v(n_tiles - 1));
    }

    // O / l as bf16 into this warpgroup's own Q rows (its last wgmma has
    // read them), then out by rows, 16 bytes a lane
    const float l0 = quad_sum(st.l0);
    const float l1 = quad_sum(st.l1);
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    unsigned char* const stage_o = smem + wg * 64 * ROW_BYTES;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      unsigned char* at = stage_o + tile_offset(r0, j, Q_PANEL) + quad * 4;
      *reinterpret_cast<uint32_t*>(at) =
          pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      *reinterpret_cast<uint32_t*>(at + 8 * ROW_BYTES) =
          pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(WG) : "memory");
#pragma unroll
    for (int i = 0; i < 64 * 16 / WG; ++i) {
      const int id = i * WG + tid;
      const int r = id >> 4;
      const int c = id & 15;
      const int row = wg_q0 + r;
      if (row < S) {
        uint4 val = make_uint4(0, 0, 0, 0);  // rows in [length, S) are zeros
        if (row < length)
          val = *reinterpret_cast<const uint4*>(stage_o +
                                                tile_offset(r, c, Q_PANEL));
        *reinterpret_cast<uint4*>(ob + (size_t)row * q_stride + c * 8) = val;
      }
    }
  }
}

}  // namespace

// One-time set-up, run once when the library is loaded
// (gofr_tpu_torch/ops/kernels.py), never at a launch: it raises the
// kernel's dynamic shared memory limit, so a launch holds nothing but the
// launch itself and can sit inside a captured CUDA graph.
extern "C" int gofr_flash_prefill_init() {
  return cudaFuncSetAttribute(flash_prefill_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_BYTES);
}

// q/out [B, S, H, 128] bf16, k/v [B, S, KV, 128] bf16, lengths [B] int32,
// all contiguous on the current device; scale = 1/sqrt(128).
extern "C" int gofr_flash_prefill_bf16(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, int B, int S, int H, int KV,
                                       float scale, void* stream) {
  const dim3 grid(H, B, (S + BQ - 1) / BQ);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  flash_prefill_kernel<<<grid, NT, SMEM_BYTES,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), S, H, KV, scale);
  return cudaGetLastError();
}
