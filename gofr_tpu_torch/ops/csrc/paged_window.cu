// The verify window of speculative decoding over a paged KV pool (K3w),
// head_dim 128, sm_90a: W query positions a slot attend the pool below
// lengths[b], then the window's own k/v causally.
//
// Replaces the TPU kernel gofr_tpu/ops/paged_attention.py::
// _paged_decode_cache as paged_window_attention calls it: W*G query rows
// a KV head flattened through the same pallas_call (bf16 operands on the
// MXU, float32 accumulation), then the W x W causal in-window scores
// folded in with the flash rule. Function: q [B, W, H, D] bf16 against
// pools [N, T, KV, D] -- int8 with float32 per-vector scales [N, T, KV],
// or dense bf16 -- where position t of slot b lives at block
// table[b, t / T] (clamped into [0, N)), offset t % T, over positions <
// lengths[b] (clamped to MB*T); then k_new / v_new [B, W, KV, D], query
// position w attending window positions t <= w; bf16 out [B, W, H, D].
// A slot of length 0 attends its window alone.
//
// What bounds it on an H100: the pool stream. At phase paged's lengths
// (24 live slots of 115-1290 tokens) a launch must read about 29.9 MB of
// int8 K/V and scales (8.9 us at 3.35 TB/s) plus q, k_new, v_new and the
// output, 32.5 MB in all (9.7 us). Its arithmetic, W*G = 20 query rows
// against every live position at W = 5, G = 4, is 1.14 GFLOP: 1.2 us on
// bf16 tensor cores, 17 us on fp32 CUDA cores.
//
// Design:
//  - One K/V read for all rows. A work item is (KV head, slot, chunk of
//    kChunk = 256 positions) and carries all R = W*G query rows of the
//    KV head (row r = w*G + g is q[b, w, kvh*G + g], read in place),
//    padded to RT whole 16-row tiles (20 -> 32 at W = 5, G = 4; 128 at
//    W = 16, G = 8). The grid is fixed from shapes (KV x NB blocks; no
//    host read of lengths, so CUDA-graph capture works): block (kvh, y)
//    walks the live items y, y + NB, ..., slot after slot (a warp steps
//    over up to 32 slots at once), and no item exists for an empty chunk.
//  - Both products on tensor cores: mma.sync m16n8k16 with bf16
//    operands and float32 accumulation; Q and K fragments by ldmatrix, V
//    (the B operand of P.V) by ldmatrix.trans, P straight from the score
//    accumulators' registers. wgmma is not used: its 64-row tiles pay
//    only where R >= 64, and at phase spec's 20 rows 44 of 64 would be
//    padding, where the 16-row tiles of mma.sync pad 12 of 32.
//  - Warp roles. One producer warp walks the block's items and keeps the
//    ring of 64-position sub-tiles full (K, V and, for an int8 pool,
//    their scales, by 16-byte cp.async, zero-filled past the chunk's
//    end; 2 stages int8, 3 bf16), across items, a stage as soon as the
//    consumers release it (full / empty mbarriers, as flash_prefill.cu).
//    Its copy stalls hold up no arithmetic. The consumer warps are (row
//    tile, position slice): 1 or 2 tiles take 4 warps that split each
//    sub-tile's positions 4 or 2 ways, more tiles a warp each (8 at R =
//    128). A warp keeps its 16 rows' accumulators (16 x 128 float32, 64
//    registers) for the whole item and reads its query fragments from
//    the item's query tile in shared memory, so no instance spills.
//  - int8 to bf16: the consumers convert each int8 sub-tile once into a
//    bf16 slot (two slots, so the stage goes back to the producer at
//    once); exact, since every code fits bf16's significand (the byte
//    becomes an exact float by the 0x4B0000xx magic, whose high half is
//    its bf16). A bf16 pool's ring stage is the bf16 tile itself. bf16
//    rows are 256 bytes whose 16-byte segments are XOR-swizzled by the
//    row's low 3 bits, so the 8 rows of an ldmatrix hit 8 distinct bank
//    groups. Shared memory: 108 KB (int8), 104 KB (bf16) at RT <= 2,
//    two blocks an SM.
//  - Numerics, as the TPU kernel: q x 1/sqrt(128) is rounded to bf16 (q
//    times the float32 scale, as the plain version's q * d**-0.5); the k
//    scale multiplies the float32 scores per position; the softmax is
//    tile-wise (one max per row and step of 32 positions -- 16 in a
//    block of more than 256 threads, where ptxas allows 168 registers --
//    and one rescale of the accumulators a step); the v scale multiplies
//    the probabilities per position before they are rounded to bf16 for
//    P.V.
//  - Each warp writes its position slice's partial (acc[16][128], m, l
//    for its rows < R) in float32 to a workspace the wrapper allocates
//    (rows of kRow floats; PS partials a chunk). A second launch, a warp
//    a row, takes the row's largest partial max, sums the partials
//    weighted by it in chunk and slice order, then folds in the row's
//    window positions t <= w (their max first, as the TPU kernel's fold;
//    q x scale rounded as above, the probabilities rounded to bf16
//    before P.V as JAX's fold does), and writes bf16. No atomics: the
//    bits do not vary between runs.
//  - Where the time goes, measured with clock64 marks on an NVIDIA H100
//    80GB HBM3 at 700 W: the consumers' instruction latency, not the
//    copies -- a sub-tile's decode and its products take about 1.8 and
//    2.3 thousand cycles with one or two warps a scheduler, while the
//    producer's loads are waited for about 300.
//
// A window of one position is a decode step: the wrapper launches
// paged_decode.cu's kernel for it, so W = 1 returns K3's bits.

#include "decode_attention.cuh"

namespace gofr {
namespace window {

using decode::cp16;
using decode::cp4;
using decode::live_length;
using decode::n_chunks;
using decode::PagedRows;
using decode::smem_addr;

constexpr int D = 128;
constexpr int kChunk = decode::kChunk;  // positions a work item
constexpr int P = 64;                   // positions a sub-tile
constexpr int kRow = D + 4;   // floats a row in a partial: acc, m, l, pad
constexpr int kMaxWindow = 16;
constexpr int kCombineThreads = 128;
constexpr unsigned FULL = 0xffffffffu;
static_assert(kChunk % P == 0, "sub-tiles");

// consumer warps that split a sub-tile's positions, for RT row tiles: 4
// warps in all for 1 or 2 tiles, a warp a tile beyond
__host__ __device__ constexpr int pos_split(int rt) {
  return rt >= 3 ? 1 : 4 / rt;
}

template <typename T, int RT>
struct Layout {
  static constexpr bool QUANT = sizeof(T) == 1;
  static constexpr int PS = pos_split(RT);
  static constexpr int NW = RT * PS;          // consumer warps
  static constexpr int NC = 32 * NW;          // consumer threads
  static constexpr int NT = NC + 32;          // and the producer warp
  static constexpr int NP = P / PS;           // positions a warp a sub-tile
  static constexpr int RB = D * (int)sizeof(T);  // pool bytes a row
  static constexpr int TILE = P * RB;            // bytes of K (or V) a stage
  static constexpr int STAGE = 2 * TILE + (QUANT ? 2 * P * 4 : 0);
  static constexpr int STAGES = QUANT ? 2 : 3;   // ring stages
  static constexpr int RING = STAGES * STAGE;
  static constexpr int BF_TILE = P * D * 2;      // a bf16 sub-tile
  // int8: two slots of bf16 K and V and their scales
  static constexpr int SLOT = 2 * BF_TILE + 2 * P * 4;
  static constexpr int CONV = QUANT ? 2 * SLOT : 0;
  static constexpr int QT = RT * 16 * D * 2;     // the query tile
  static constexpr int BARS = 2 * STAGES * 8;    // full, empty mbarriers
  static constexpr int BYTES = RING + CONV + QT + BARS;
  // two blocks an SM where the accumulators leave room (RT <= 2)
  static constexpr int MIN_BLOCKS = RT <= 2 ? 2 : 1;
  static_assert(NP % 16 == 0, "layout");
};

// byte offset of 16-byte segment `seg` (0..15) of bf16 row r, swizzled
__device__ __forceinline__ int bf_at(int r, int seg) {
  return r * (D * 2) + ((seg ^ (r & 7)) << 4);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// the 2 bf16 of word w, times scale, rounded back to bf16
__device__ __forceinline__ unsigned scaled_pair(unsigned w, float scale) {
  return pack_bf16(__uint_as_float(w << 16) * scale,
                   __uint_as_float(w & 0xffff0000u) * scale);
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -- mbarriers (as flash_prefill.cu) ----------------------------------------

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive once every cp.async this thread has started so far has landed
// (counted in the barrier's expected arrivals, not added to them).
__device__ __forceinline__ void mbar_arrive_after_copies(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
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

// Wait until the phase of `parity` has completed; a wait that never ends
// (a fault) traps, and the launch reports an error, instead of a hang
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  for (unsigned n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 24)) __trap();
}

// the consumer warps' own barrier (the producer warp does not take part)
template <int N>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

// element offset of query row r of KV head kvh of slot b in q/out
__device__ __forceinline__ size_t q_row(int b, int kvh, int r, int wn, int g,
                                        int h) {
  const int w = r / g;
  return ((size_t)(b * wn + w) * h + kvh * g + (r - w * g)) * D;
}

// The producer warp fills a ring stage with positions [t0, t0 + P) of
// slot b (those past `end` zero-filled): bf16 rows swizzled (they are
// the ldmatrix tile), int8 rows as they are (the consumers convert them)
// plus scales. A lane looks up the pool rows of 2 positions; the copies
// go out in row order, 8 or 16 lanes a row, so each is coalesced.
template <typename T, int RT>
__device__ __forceinline__ void fill_stage(unsigned char* kst,
                                           const PagedRows& rows, int b,
                                           int t0, int end, const T* kp,
                                           const T* vp, const float* ks,
                                           const float* vs, int KV, int kvh,
                                           int lane) {
  using L = Layout<T, RT>;
  constexpr int SEGS = L::RB / 16;
  constexpr int EPS = 16 / (int)sizeof(T);
  static_assert(P == 64, "two positions a lane");
  unsigned char* vst = kst + L::TILE;
  // the pool row (row * KV + kvh) of positions lane and lane + 32, or
  // ~0u past the end
  unsigned at[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int t = t0 + lane + 32 * j;
    at[j] = t < end ? (unsigned)(rows.row(b, t) * KV + kvh) : ~0u;
  }
#pragma unroll
  for (int k = 0; k < P * SEGS / 32; ++k) {
    const int c = lane + 32 * k;
    const int r = c / SEGS;
    const int seg = c % SEGS;
    const unsigned row = __shfl_sync(FULL, at[k / SEGS], r % 32);
    const bool valid = row != ~0u;
    const size_t off = valid ? (size_t)row * D + seg * EPS : 0;
    const int dst = L::QUANT ? r * L::RB + seg * 16 : bf_at(r, seg);
    cp16(kst + dst, kp + off, valid);
    cp16(vst + dst, vp + off, valid);
  }
  if (L::QUANT) {
    float* sc = reinterpret_cast<float*>(vst + L::TILE);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool valid = at[j] != ~0u;
      const int r = lane + 32 * j;
      cp4(sc + r, ks + (valid ? at[j] : 0), valid);
      cp4(sc + P + r, vs + (valid ? at[j] : 0), valid);
    }
  }
}

// the 4 signed bytes of word w as 2 words of 2 bf16 (lo: bytes 0, 1;
// hi: bytes 2, 3), exactly: each byte becomes an exact float by the
// 0x4B0000xx magic (decode_attention.cuh's Conv), whose low 16 bits are
// zero, so its bf16 is its high half
__device__ __forceinline__ uint2 bf16_of_int8(unsigned w) {
  const float4 f = decode::Conv<int8_t>::word(w);
  return make_uint2(
      __byte_perm(__float_as_uint(f.x), __float_as_uint(f.y), 0x7632),
      __byte_perm(__float_as_uint(f.z), __float_as_uint(f.w), 0x7632));
}

// int8 K and V of one ring stage into a slot of bf16 K and V tiles
// (exact), swizzled (the 8 lanes of a store phase write 8 distinct bank
// groups), and the stage's scales after them
template <int NT>
__device__ __forceinline__ void decode_to_bf16(const unsigned char* src,
                                               unsigned char* dst) {
  if (threadIdx.x < 2 * P / 4)
    reinterpret_cast<float4*>(dst + 2 * P * D * 2)[threadIdx.x] =
        reinterpret_cast<const float4*>(src + 2 * P * D)[threadIdx.x];
  // unrolled, so that the shared loads of all units are in flight at once
#pragma unroll
  for (int k = 0; k < (2 * P * 8 + NT - 1) / NT; ++k) {
    const int u = threadIdx.x + k * NT;
    if (u >= 2 * P * 8) break;
    const int which = u / (P * 8);  // 0: K, 1: V
    const int r = (u / 8) % P;
    const int s = u % 8;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(src + which * P * D + r * D + s * 16);
    const uint2 a = bf16_of_int8(raw.x);
    const uint2 b = bf16_of_int8(raw.y);
    const uint2 c = bf16_of_int8(raw.z);
    const uint2 d = bf16_of_int8(raw.w);
    const uint4 lo = make_uint4(a.x, a.y, b.x, b.y);
    const uint4 hi = make_uint4(c.x, c.y, d.x, d.y);
    unsigned char* t = dst + which * (P * D * 2);
    const bool odd_first = s >= 4;
    *reinterpret_cast<uint4*>(t + bf_at(r, 2 * s + odd_first)) =
        odd_first ? hi : lo;
    *reinterpret_cast<uint4*>(t + bf_at(r, 2 * s + !odd_first)) =
        odd_first ? lo : hi;
  }
}

// Advance (b, base, len) -- a slot, the index of its first item, its live
// length -- to the slot that holds item `item` (b = B past the last).
// Each warp walks on its own, with the same result: its lanes read the
// next 32 slots' lengths at once and scan their chunk counts, so a step
// over many slots is one round trip, not one a slot.
__device__ __forceinline__ void walk_to(int item, int& b, int& base, int& len,
                                        const int* lengths, int B, int cap,
                                        int lane) {
  while (b < B && item >= base + n_chunks(len)) {
    const int s = b + 1 + lane;
    const int ls = s < B ? live_length(lengths, s, cap) : 0;
    int cum = n_chunks(ls);  // chunks of slots b+1 .. s
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const int v = __shfl_up_sync(FULL, cum, off);
      if (lane >= off) cum += v;
    }
    const int start = base + n_chunks(len);  // slot b+1's first item
    const unsigned past = __ballot_sync(FULL, s >= B || item < start + cum);
    const int k = past ? __ffs(past) - 1 : 31;
    const int before = __shfl_sync(FULL, cum - n_chunks(ls), k);
    len = __shfl_sync(FULL, ls, k);
    base = start + before;
    b += 1 + k;
  }
}

// The item's query rows into the query tile: x scale, rounded to bf16,
// swizzled as the K/V tiles; padding rows are zero. Unrolled, so that
// every row's load is in flight at once.
template <int NT, int ROWS>
__device__ __forceinline__ void load_queries(unsigned char* qt,
                                             const __nv_bfloat16* q, int b,
                                             int kvh, int R, int Wn, int G,
                                             int H, float scale) {
  constexpr int N = (ROWS * 16 + NT - 1) / NT;
  uint4 x[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int u = threadIdx.x + k * NT;
    const int r = u / 16;
    x[k] = make_uint4(0u, 0u, 0u, 0u);
    if (u < ROWS * 16 && r < R)
      x[k] = *reinterpret_cast<const uint4*>(
          q + q_row(b, kvh, r, Wn, G, H) + (u % 16) * 8);
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int u = threadIdx.x + k * NT;
    if (u < ROWS * 16)
      *reinterpret_cast<uint4*>(qt + bf_at(u / 16, u % 16)) = make_uint4(
          scaled_pair(x[k].x, scale), scaled_pair(x[k].y, scale),
          scaled_pair(x[k].z, scale), scaled_pair(x[k].w, scale));
  }
}

// One sub-tile of the warp's 16 rows against its NP positions: scores on
// tensor cores, the k scale and the chunk's edge (nv live positions),
// the tile-wise softmax, P.V into acc. qaddr: the query tile at the
// warp's first row; kaddr/vaddr: the bf16 K and V tiles; kscale/vscale:
// the int8 pool's scales (unused for bf16).
template <bool QUANT, int NP>
__device__ __forceinline__ void attend_tile(
    unsigned qaddr, unsigned kaddr, unsigned vaddr, const float* kscale,
    const float* vscale, int pbase, int nv, int lane, float (&m_run)[2],
    float (&l_run)[2], float (&acc)[16][4]) {
  const int tig = lane % 4;
  // scores S = Q K^T over the warp's NP positions: NP / 8 tiles of 8, a
  // 32-dim step at a time (the query's A fragments by ldmatrix from the
  // query tile, so they hold no registers between sub-tiles)
  float s[NP / 8][4];
#pragma unroll
  for (int nt = 0; nt < NP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  const int qrow = ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
  for (int kb2 = 0; kb2 < 4; ++kb2) {
    unsigned qa[2][4];
    ldsm_x4(qa[0], qaddr + bf_at(qrow, 4 * kb2 + (lane >> 4)));
    ldsm_x4(qa[1], qaddr + bf_at(qrow, 4 * kb2 + 2 + (lane >> 4)));
#pragma unroll
    for (int nt = 0; nt < NP / 8; ++nt) {
      unsigned kb[4];
      ldsm_x4(kb, kaddr + bf_at(pbase + nt * 8 + (lane & 7),
                                4 * kb2 + (lane >> 3)));
      mma(s[nt], qa[0], kb[0], kb[1]);
      mma(s[nt], qa[1], kb[2], kb[3]);
    }
  }

  // k scale, the chunk's edge, each row's max over the slice
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int nt = 0; nt < NP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = pbase + nt * 8 + 2 * tig + (e & 1);
      float x = s[nt][e];
      if (QUANT) x *= kscale[p];
      s[nt][e] = x;
      if (p < nv) mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float corr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
    const float mn = fmaxf(m_run[h], mx[h]);
    corr[h] = __expf(m_run[h] - mn);
    m_run[h] = mn;
  }

  // probabilities: float32 into the running sum; x v scale, rounded to
  // bf16, straight into P.V's A fragments
  unsigned pa[NP / 16][4];
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NP / 8; ++nt) {
    float pr[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = pbase + nt * 8 + 2 * tig + (e & 1);
      const float x = p < nv ? __expf(s[nt][e] - m_run[e >> 1]) : 0.f;
      sum[e >> 1] += x;
      pr[e] = QUANT ? x * vscale[p] : x;
    }
    pa[nt / 2][(nt & 1) * 2] = pack_bf16(pr[0], pr[1]);
    pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(pr[2], pr[3]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * corr[h] + sum[h];
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    acc[n][0] *= corr[0];
    acc[n][1] *= corr[0];
    acc[n][2] *= corr[1];
    acc[n][3] *= corr[1];
  }

  // P.V: k = the slice's positions in steps of 16, n = 16 tiles of 8
  // dims; V by ldmatrix.trans
#pragma unroll
  for (int kt16 = 0; kt16 < NP / 16; ++kt16) {
    const int row = pbase + kt16 * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
    for (int dt2 = 0; dt2 < 8; ++dt2) {
      unsigned vb[4];
      ldsm_x4_t(vb, vaddr + bf_at(row, 2 * dt2 + (lane >> 4)));
      mma(acc[2 * dt2], pa[kt16], vb[0], vb[1]);
      mma(acc[2 * dt2 + 1], pa[kt16], vb[2], vb[3]);
    }
  }
}

// Pass 1: grid (KV, NB), 32 * (NW + 1) threads, Layout::BYTES of
// dynamic shared memory. Partials of every live item: for each position
// slice, all R rows of the KV head. The last warp produces: it walks the
// block's items and fills the ring, a stage as soon as the consumers
// have released it, across items; the other warps consume.
template <typename T, int RT>
__global__ void __launch_bounds__(Layout<T, RT>::NT, Layout<T, RT>::MIN_BLOCKS)
window_split_kernel(const __nv_bfloat16* __restrict__ q,
                    const T* __restrict__ kp, const T* __restrict__ vp,
                    const float* __restrict__ ks,
                    const float* __restrict__ vs, PagedRows rows,
                    const int* __restrict__ lengths,
                    float* __restrict__ work, int B, int Wn, int H, int KV,
                    int NC, float scale) {
  using L = Layout<T, RT>;
  constexpr int ST = L::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* conv = smem + L::RING;          // int8: 2 slots (K, V) bf16
  unsigned char* qtile = conv + L::CONV;
  const unsigned bars = smem_addr(qtile + L::QT);
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (ST + st); };
  auto stage = [&](int st) { return ring + st * L::STAGE; };
  const int kvh = blockIdx.x;
  const int NB = gridDim.y;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int G = H / KV;
  const int R = Wn * G;
  const int cap = rows.capacity();

  if (threadIdx.x == 0) {
    for (int st = 0; st < ST; ++st) {
      mbar_init(full(st), 32);     // every producer lane's copies
      mbar_init(empty(st), L::NW);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int b = 0, base = 0;
  int len = live_length(lengths, 0, cap);
  int g = 0;  // sub-tiles so far: ring stage g % ST, its use g / ST

  if (warp == L::NW) {
    // ---- producer
#pragma unroll 1
    for (int item = blockIdx.y;; item += NB) {
      walk_to(item, b, base, len, lengths, B, cap, lane);
      if (b >= B) break;
      const int t_begin = (item - base) * kChunk;
      const int t_end = min(len, t_begin + kChunk);
#pragma unroll 1
      for (int t0 = t_begin; t0 < t_end; t0 += P, ++g) {
        const int st = g % ST;
        mbar_wait(empty(st), ((g / ST) & 1) ^ 1);  // passes at a first use
        fill_stage<T, RT>(stage(st), rows, b, t0, t_end, kp, vp, ks, vs, KV,
                          kvh, lane);
        mbar_arrive_after_copies(full(st));
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- consumers: warp = (row tile, position slice); a slice is taken
  // 32 positions at a time (16 in a block of more than 256 threads, where
  // ptxas allows 168 registers a thread), which bounds the registers of
  // its scores
  constexpr int NPS = L::NP < (L::NT > 256 ? 16 : 32) ? L::NP
                                                     : (L::NT > 256 ? 16 : 32);
  const int rt = warp / L::PS;
  const int ps = warp % L::PS;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int pbase = ps * L::NP;
#pragma unroll 1
  for (int item = blockIdx.y;; item += NB) {
    walk_to(item, b, base, len, lengths, B, cap, lane);
    if (b >= B) return;
    const int c = item - base;
    const int t_begin = c * kChunk;
    const int t_end = min(len, t_begin + kChunk);
    const int ntiles = (t_end - t_begin + P - 1) / P;

    // the item's query tile (A of the scores)
    consumers_sync<L::NC>();  // every warp is done with the last one
    load_queries<L::NC, RT * 16>(qtile, q, b, kvh, R, Wn, G, H, scale);
    consumers_sync<L::NC>();
    const unsigned qaddr = smem_addr(qtile) + rt * 16 * (D * 2);

    float m_run[2] = {kNegInf, kNegInf};
    float l_run[2] = {0.f, 0.f};  // this thread's positions only
    float acc[16][4];
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

#pragma unroll 1
    for (int i = 0; i < ntiles; ++i, ++g) {
      const int st = g % ST;
      const int nv = min(P, t_end - (t_begin + i * P));  // live positions
      mbar_wait(full(st), (g / ST) & 1);
      if (L::QUANT) {
        // to bf16 in a slot of its own, so the stage goes back to the
        // producer at once
        unsigned char* kt = conv + (g & 1) * L::SLOT;
        decode_to_bf16<L::NC>(stage(st), kt);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st));
        consumers_sync<L::NC>();
        const float* kscale =
            reinterpret_cast<const float*>(kt + 2 * L::BF_TILE);
#pragma unroll 1
        for (int h = 0; h < L::NP / NPS; ++h)
          attend_tile<true, NPS>(qaddr, smem_addr(kt),
                                 smem_addr(kt + L::BF_TILE), kscale,
                                 kscale + P, pbase + h * NPS, nv, lane, m_run,
                                 l_run, acc);
      } else {
        const unsigned char* kt = stage(st);
#pragma unroll 1
        for (int h = 0; h < L::NP / NPS; ++h)
          attend_tile<false, NPS>(qaddr, smem_addr(kt),
                                  smem_addr(kt + L::TILE), nullptr, nullptr,
                                  pbase + h * NPS, nv, lane, m_run, l_run,
                                  acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st));
      }
    }

    // the slice's partial: R rows of kRow floats (acc, m, l)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_run[h] += __shfl_xor_sync(FULL, l_run[h], 1);
      l_run[h] += __shfl_xor_sync(FULL, l_run[h], 2);
      const int r = rt * 16 + gid + 8 * h;
      if (r < R) {
        float* o = work +
                   (((((size_t)b * KV + kvh) * NC + c) * L::PS + ps) * R + r) *
                       kRow;
#pragma unroll
        for (int n = 0; n < 16; ++n)
          *reinterpret_cast<float2*>(o + n * 8 + 2 * tig) =
              make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
        if (tig == 0) {
          o[D] = m_run[h];
          o[D + 1] = l_run[h];
        }
      }
    }
  }
}

// Pass 2: grid (KV, B, ceil(R / 4)), 128 threads, a warp a row (lane =
// 4 dims). Fold the row's partials, then its window positions t <= w;
// write bf16. The loads a row needs go out side by side, not in a chain:
// once the slot's length is known, the first 32 partials' maxima and
// sums (a lane each) and the first 4 partials' accumulators together;
// the window's keys and values t <= w together. Few registers, so that
// the whole grid is resident at once.
__global__ void __launch_bounds__(kCombineThreads, 6)
window_combine_kernel(const __nv_bfloat16* __restrict__ q,
                      const int* __restrict__ lengths,
                      const float* __restrict__ work,
                      const __nv_bfloat16* __restrict__ k_new,
                      const __nv_bfloat16* __restrict__ v_new,
                      __nv_bfloat16* __restrict__ out, int Wn, int H, int KV,
                      int NC, int PS, int cap, float scale) {
  constexpr int NWARPS = kCombineThreads / 32;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int G = H / KV;
  const int R = Wn * G;
  const int r = blockIdx.z * NWARPS + threadIdx.x / 32;
  if (r >= R) return;
  const int w = r / G;

  // the row's scores against the window's keys t <= w: its q x scale
  // rounded to bf16 as in pass 1
  const uint2 qw = *reinterpret_cast<const uint2*>(
      q + q_row(b, kvh, r, Wn, G, H) + 4 * lane);
  const unsigned qs0 = scaled_pair(qw.x, scale);
  const unsigned qs1 = scaled_pair(qw.y, scale);
  const size_t wstride = (size_t)KV * D;
  const __nv_bfloat16* kn = k_new + ((size_t)b * Wn * KV + kvh) * D + 4 * lane;
  float sw[kMaxWindow];
  float smax = kNegInf;
#pragma unroll
  for (int t = 0; t < kMaxWindow; ++t) {
    float d = 0.f;
    if (t <= w) {  // w is uniform over the warp
      const uint2 kw = *reinterpret_cast<const uint2*>(kn + t * wstride);
      d = __uint_as_float(qs0 << 16) * __uint_as_float(kw.x << 16);
      d = fmaf(__uint_as_float(qs0 & 0xffff0000u),
               __uint_as_float(kw.x & 0xffff0000u), d);
      d = fmaf(__uint_as_float(qs1 << 16), __uint_as_float(kw.y << 16), d);
      d = fmaf(__uint_as_float(qs1 & 0xffff0000u),
               __uint_as_float(kw.y & 0xffff0000u), d);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        d += __shfl_xor_sync(FULL, d, off);
      smax = fmaxf(smax, d);
    }
    sw[t] = d;
  }

  // the partials, PS a chunk (one a position slice): partial c's row at
  // rp + c * cs; lane c holds partial c's max and sum (and c + 32, ...)
  const int nc = n_chunks(live_length(lengths, b, cap)) * PS;
  const size_t cs = (size_t)R * kRow;
  const float* rp =
      work + ((size_t)b * KV + kvh) * NC * PS * cs + (size_t)r * kRow;
  const float2 ml = lane < nc
                        ? *reinterpret_cast<const float2*>(rp + lane * cs + D)
                        : make_float2(kNegInf, 0.f);
  constexpr int FIRST = 4;
  float4 a0[FIRST];
#pragma unroll
  for (int j = 0; j < FIRST; ++j)
    a0[j] = j < nc ? *reinterpret_cast<const float4*>(rp + j * cs + 4 * lane)
                   : make_float4(0.f, 0.f, 0.f, 0.f);

  // the row's largest partial max; each partial's weight and the sum
  float M = ml.x;
  for (int c = lane + 32; c < nc; c += 32) M = fmaxf(M, rp[c * cs + D]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    M = fmaxf(M, __shfl_xor_sync(FULL, M, off));
  float Lsum = 0.f;
  float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += 32) {
    const int cl = c0 + lane;
    float e_l = 0.f;
    if (cl < nc) {
      const float2 mlc =
          c0 == 0 ? ml : *reinterpret_cast<const float2*>(rp + cl * cs + D);
      e_l = __expf(mlc.x - M);
      Lsum = fmaf(mlc.y, e_l, Lsum);
    }
    const int n = min(32, nc - c0);
    int j = 0;
    if (c0 == 0) {
#pragma unroll
      for (; j < FIRST; ++j) {
        const float e = __shfl_sync(FULL, e_l, j);  // 0 past nc
        A = make_float4(fmaf(a0[j].x, e, A.x), fmaf(a0[j].y, e, A.y),
                        fmaf(a0[j].z, e, A.z), fmaf(a0[j].w, e, A.w));
      }
    }
#pragma unroll 4
    for (; j < n; ++j) {
      const float e = __shfl_sync(FULL, e_l, j);
      const float4 a =
          *reinterpret_cast<const float4*>(rp + (c0 + j) * cs + 4 * lane);
      A = make_float4(fmaf(a.x, e, A.x), fmaf(a.y, e, A.y),
                      fmaf(a.z, e, A.z), fmaf(a.w, e, A.w));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    Lsum += __shfl_xor_sync(FULL, Lsum, off);

  // the window: its max first, then the flash rule; the probabilities
  // rounded to bf16 for P.V
  const float mt = fmaxf(M, smax);
  const float alpha = __expf(M - mt);
  float psum = 0.f;
  float4 pv = make_float4(0.f, 0.f, 0.f, 0.f);
  const __nv_bfloat16* vn = v_new + ((size_t)b * Wn * KV + kvh) * D + 4 * lane;
#pragma unroll
  for (int t = 0; t < kMaxWindow; ++t) {
    if (t <= w) {
      const float pt = __expf(sw[t] - mt);
      psum += pt;
      const float pb = bf16_round(pt);
      const uint2 vw = *reinterpret_cast<const uint2*>(vn + t * wstride);
      pv.x = fmaf(pb, __uint_as_float(vw.x << 16), pv.x);
      pv.y = fmaf(pb, __uint_as_float(vw.x & 0xffff0000u), pv.y);
      pv.z = fmaf(pb, __uint_as_float(vw.y << 16), pv.z);
      pv.w = fmaf(pb, __uint_as_float(vw.y & 0xffff0000u), pv.w);
    }
  }
  const float lt = Lsum * alpha + psum;
  const uint2 o = make_uint2(
      pack_bf16((A.x * alpha + pv.x) / lt, (A.y * alpha + pv.y) / lt),
      pack_bf16((A.z * alpha + pv.z) / lt, (A.w * alpha + pv.w) / lt));
  *reinterpret_cast<uint2*>(out + q_row(b, kvh, r, Wn, G, H) + 4 * lane) = o;
}

template <typename T, int RT>
cudaError_t launch_split(const void* q, const void* kp, const void* vp,
                         const void* ks, const void* vs,
                         const PagedRows& rows, const int* lengths,
                         float* work, int B, int Wn, int H, int KV, int NB,
                         int NC, float scale, cudaStream_t st) {
  using L = Layout<T, RT>;
  auto kernel = window_split_kernel<T, RT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(KV, NB), L::NT, L::BYTES, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), rows, lengths, work, B, Wn, H, KV, NC,
      scale);
  return cudaGetLastError();
}

// Both passes on `stream`. `work` holds B*KV*NC*PS*R*kRow floats, NC =
// ceil(MB*T / kChunk), R = Wn*H/KV, PS = pos_split(ceil(R / 16)); NB
// blocks per KV head walk the items;
// `chunk` is the wrapper's idea of kChunk, checked.
template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const void* table, const void* lengths,
           const void* k_new, const void* v_new, void* out, void* work,
           int B, int MB, int T_, int N, int Wn, int H, int KV, int NB,
           int chunk, float scale, void* stream) {
  if (T_ <= 0 || N <= 0 || MB <= 0 || KV <= 0 || H % KV != 0 || B <= 0 ||
      NB <= 0 || Wn < 1 || Wn > kMaxWindow || chunk != kChunk)
    return cudaErrorInvalidValue;
  const int G = H / KV;
  if (G != 1 && G != 2 && G != 4 && G != 8) return cudaErrorInvalidValue;
  const PagedRows rows{static_cast<const int*>(table), MB, T_, N};
  const int cap = rows.capacity();
  const int NC = (cap + kChunk - 1) / kChunk;
  const int RT = (Wn * G + 15) / 16;
  const int* lens = static_cast<const int*>(lengths);
  float* wk = static_cast<float*>(work);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (RT) {
#define GOFR_WINDOW_CASE(RTV)                                                  \
  case RTV:                                                                    \
    err = launch_split<T, RTV>(q, kp, vp, ks, vs, rows, lens, wk, B, Wn, H,   \
                               KV, NB, NC, scale, st);                        \
    break;
    GOFR_WINDOW_CASE(1)
    GOFR_WINDOW_CASE(2)
    GOFR_WINDOW_CASE(3)
    GOFR_WINDOW_CASE(4)
    GOFR_WINDOW_CASE(5)
    GOFR_WINDOW_CASE(6)
    GOFR_WINDOW_CASE(7)
    GOFR_WINDOW_CASE(8)
#undef GOFR_WINDOW_CASE
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const int rows_per_block = kCombineThreads / 32;
  window_combine_kernel<<<dim3(KV, B, (Wn * G + rows_per_block - 1) /
                                          rows_per_block),
                          kCombineThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), lens, wk,
      static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new),
      static_cast<__nv_bfloat16*>(out), Wn, H, KV, NC, pos_split(RT), cap,
      scale);
  return cudaGetLastError();
}

}  // namespace window
}  // namespace gofr

// q/out [B, Wn, H, 128] bf16 (1 <= Wn <= 16); k_pool/v_pool
// [N, T, KV, 128] int8 with k_scale/v_scale [N, T, KV] float32; table
// [B, MB] int32 block ids; lengths [B] int32 (the window excluded);
// k_new/v_new [B, Wn, KV, 128] bf16; work: B*KV*ceil(MB*T/chunk)*S*R*132
// floats of scratch, R = Wn*H/KV rows and S position slices (4 for R <=
// 16, 2 for R <= 32, else 1); NB blocks per KV head; all contiguous on
// the current device.
extern "C" int gofr_paged_window_int8(const void* q, const void* kp,
                                      const void* vp, const void* ks,
                                      const void* vs, const void* table,
                                      const void* lengths, const void* k_new,
                                      const void* v_new, void* out, void* work,
                                      int B, int MB, int T, int N, int Wn,
                                      int H, int KV, int NB, int chunk,
                                      float scale, void* stream) {
  return gofr::window::launch<int8_t>(q, kp, vp, ks, vs, table, lengths,
                                      k_new, v_new, out, work, B, MB, T, N,
                                      Wn, H, KV, NB, chunk, scale, stream);
}

// The dense bf16 pool: as above without scales (ks/vs are ignored).
extern "C" int gofr_paged_window_bf16(const void* q, const void* kp,
                                      const void* vp, const void* ks,
                                      const void* vs, const void* table,
                                      const void* lengths, const void* k_new,
                                      const void* v_new, void* out, void* work,
                                      int B, int MB, int T, int N, int Wn,
                                      int H, int KV, int NB, int chunk,
                                      float scale, void* stream) {
  return gofr::window::launch<__nv_bfloat16>(
      q, kp, vp, ks, vs, table, lengths, k_new, v_new, out, work, B, MB, T,
      N, Wn, H, KV, NB, chunk, scale, stream);
}
