// The decode-attention kernel body that flash_decode.cu (a contiguous
// [B, Smax, KV, 128] cache) and paged_decode.cu (a block pool
// [N, T, KV, 128] read through a block table) both instantiate. The two
// differ only in their address policy, `Rows`: the pool or cache row of
// position t of slot b. Everything else -- the split, the tiles, the
// float operations and their order -- is this one body, so on the same
// K/V the two kernels return the same bits by construction.
//
// Function: q [B, H, 128] bf16 against int8 K/V with float32 per-vector
// scales (the k scale multiplies the scores, the v scale the
// probabilities) or dense bf16 K/V, over positions < lengths[b] (clamped
// to the capacity), then this step's k_new / v_new [B, KV, 128] join with
// the exact flash combination; bf16 out. A slot of length 0 returns v_new.
//
// What bounds it on an H100: the K/V stream (about 4 FLOP per byte). At
// 8 slots of 512 live tokens a launch reads 8.8 MB (2.6 us at 3.35
// TB/s); at 24 live slots of 115-1290 tokens, 29.9 MB (8.9 us).
//
// Design:
//  - Split over the cache. A work item is (KV head, slot, chunk of
//    kChunk positions); kChunk does not depend on the pool's block size,
//    so the paged and contiguous kernels cut a slot identically. The grid
//    is fixed from shapes alone (KV x W blocks; the wrapper may run
//    inside CUDA-graph capture, so it never reads lengths on the host):
//    block (kvh, y) walks the live items y, y + W, ... of the list that
//    the lengths give, slot after slot, and no item exists for an empty
//    chunk. A slot's time is no longer the kernel's time.
//  - Inside an item, 128 threads take the chunk in sub-tiles of 8 KB of
//    K (64 int8 or 32 bf16 rows). K and V rows and their scales arrive by
//    16-byte (scales 4-byte) cp.async copies into a 2-stage ring in
//    shared memory; a tile past the chunk's end is zero-filled. The 16-
//    byte segments of a row are XOR-swizzled by the row's low 3 bits, so
//    lanes that read one segment of 8 rows hit 8 distinct bank groups.
//  - Scores: each warp takes a quarter of the 128 dims, each lane one or
//    two positions; the query, pre-scaled by 1/sqrt(128), sits in shared
//    memory and is read as a broadcast. The four quarters' partial dots
//    are summed in a fixed order.
//  - Tile-wise softmax: one max per head per sub-tile, one exp per
//    (position, head), the running sum and the accumulator rescaled once
//    per sub-tile, not once per position.
//  - P.V: each lane owns 4 adjacent dims of the 128, each warp a quarter
//    of the sub-tile's positions; G*4 accumulators a thread, so no
//    instance spills. The warps' accumulators share the running max and
//    are summed (fixed order) once per item.
//  - int8 becomes float without I2F (a quarter-rate conversion on sm_90):
//    the byte, XOR'd with 0x80, is permuted into 0x4B0000xx and
//    8388736.0f subtracted: exact, at full issue rate.
//  - Each item writes (acc[G][128], m[G], l[G]) in float32 to a workspace
//    the wrapper allocates. A second launch, one block per (KV head,
//    slot), folds a slot's partials in chunk order with the flash rule,
//    then k_new / v_new, and writes bf16. No atomics: the bits do not vary
//    between runs. A slot of length 0 has no partials; its result is the
//    new token alone. The second launch costs one more launch of host
//    time per layer, a few us of a decode step of tens of ms.
#pragma once

#include "common.cuh"

namespace gofr {
namespace decode {

constexpr int D = 128;
constexpr int kChunk = 256;      // positions per work item
constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int kTileBytes = 8192; // K bytes per sub-tile
constexpr int kWork = D + 2;     // floats per head in a partial: acc, m, l
constexpr unsigned FULL = 0xffffffffu;

// the address policies: the element row of position t of slot b

struct ContiguousRows {
  int smax;
  __host__ __device__ int capacity() const { return smax; }
  __device__ __forceinline__ size_t row(int b, int t) const {
    return (size_t)b * smax + t;
  }
};

// block table[b*MB + t/T], clamped into [0, N) so a bad table can
// misread but never fault, then offset t % T
struct PagedRows {
  const int* __restrict__ table;
  int mb, tb, n;
  __host__ __device__ int capacity() const { return mb * tb; }
  __device__ __forceinline__ size_t row(int b, int t) const {
    const int j = t / tb;
    int blk = __ldg(table + (size_t)b * mb + j);
    blk = blk < 0 ? 0 : (blk >= n ? n - 1 : blk);
    return (size_t)blk * tb + (size_t)(t - j * tb);
  }
};

// 4 elements of a 16-byte segment as floats
template <typename T>
struct Conv;

template <>
struct Conv<int8_t> {
  // the 4 signed bytes of word w: 0x4B0000xx is 8388608 + xx, and with
  // xx = byte ^ 0x80 the difference to 8388736 is the byte's value
  __device__ __forceinline__ static float4 word(unsigned w) {
    const unsigned x = w ^ 0x80808080u;
    return make_float4(
        __uint_as_float(__byte_perm(x, 0x4B00u, 0x5440)) - 8388736.0f,
        __uint_as_float(__byte_perm(x, 0x4B00u, 0x5441)) - 8388736.0f,
        __uint_as_float(__byte_perm(x, 0x4B00u, 0x5442)) - 8388736.0f,
        __uint_as_float(__byte_perm(x, 0x4B00u, 0x5443)) - 8388736.0f);
  }
  __device__ __forceinline__ static float4 quad(const uint4& s, int k) {
    return word(k == 0 ? s.x : k == 1 ? s.y : k == 2 ? s.z : s.w);
  }
  // 4 elements at a 4-byte-aligned shared address
  __device__ __forceinline__ static float4 load4(const unsigned char* p) {
    return word(*reinterpret_cast<const unsigned*>(p));
  }
};

template <>
struct Conv<__nv_bfloat16> {
  __device__ __forceinline__ static float4 pair(unsigned a, unsigned b) {
    return make_float4(__uint_as_float(a << 16),
                       __uint_as_float(a & 0xffff0000u),
                       __uint_as_float(b << 16),
                       __uint_as_float(b & 0xffff0000u));
  }
  __device__ __forceinline__ static float4 quad(const uint4& s, int k) {
    return k == 0 ? pair(s.x, s.y) : pair(s.z, s.w);
  }
  __device__ __forceinline__ static float4 load4(const unsigned char* p) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    return pair(r.x, r.y);
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// copy `bytes` (16, or 4 with .ca) from global to shared, or zero-fill
// when !valid (nothing is read then)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// a slot's live length and chunk count
__device__ __forceinline__ int live_length(const int* lengths, int b,
                                           int cap) {
  const int n = __ldg(lengths + b);
  return n < 0 ? 0 : (n > cap ? cap : n);
}
__device__ __forceinline__ int n_chunks(int length) {
  return (length + kChunk - 1) / kChunk;
}

template <typename T, int G, bool QUANT>
struct Tiles {
  static constexpr int RB = D * (int)sizeof(T);       // bytes a row
  static constexpr int P = kTileBytes / RB;           // rows a sub-tile
  static constexpr int SEGS = RB / 16;                // 16-byte segments
  static constexpr int EPS = 16 / (int)sizeof(T);     // elements a segment
  static constexpr int QSEGS = 32 / EPS;              // segments a quarter
  static constexpr int PPT = P / 32;                  // score rows a lane
  static constexpr int PPW = P / NWARPS;              // P.V rows a warp
  static constexpr int HPW = (G + NWARPS - 1) / NWARPS;  // heads a warp
  static_assert(P % 32 == 0 && PPW % 4 == 0 && kChunk % P == 0, "tiles");

  unsigned char k[2][P * RB];
  unsigned char v[2][P * RB];
  float ks[2][QUANT ? P : 1];
  float vs[2][QUANT ? P : 1];
  float part[NWARPS][G][P];  // the quarters' partial scores; part[0]
                             // then holds the probabilities (x v scale)
  float q[G][D];             // query x 1/sqrt(D)
  float corr[G];

  // byte offset of segment `seg` of row r, swizzled
  __device__ __forceinline__ static int at(int r, int seg) {
    return r * RB + ((seg ^ (r & 7)) << 4);
  }
};

// Fill stage `st` with sub-tile rows [t0, t0 + P) of slot b (rows past
// `end` zero-filled).
template <typename T, int G, bool QUANT, class Rows>
__device__ __forceinline__ void load_tile(Tiles<T, G, QUANT>& sm, int st,
                                          const Rows& rows, int b, int t0,
                                          int end, const T* kbase,
                                          const T* vbase, const float* ks,
                                          const float* vs, int KV, int kvh) {
  using S = Tiles<T, G, QUANT>;
  constexpr int COPIES = S::P * S::SEGS;
  const int tid = threadIdx.x;
#pragma unroll
  for (int c = tid; c < COPIES; c += NTHREADS) {
    const int r = c / S::SEGS;
    const int seg = c % S::SEGS;
    const int t = t0 + r;
    const bool valid = t < end;
    const size_t off =
        valid ? (rows.row(b, t) * KV + kvh) * D + seg * S::EPS : 0;
    cp16(sm.k[st] + S::at(r, seg), kbase + off, valid);
    cp16(sm.v[st] + S::at(r, seg), vbase + off, valid);
  }
  if (QUANT) {
    for (int r = tid; r < S::P; r += NTHREADS) {
      const int t = t0 + r;
      const bool valid = t < end;
      const size_t off = valid ? rows.row(b, t) * KV + kvh : 0;
      cp4(&sm.ks[st][r], ks + off, valid);
      cp4(&sm.vs[st][r], vs + off, valid);
    }
  }
  cp_commit();
}

// Pass 1: grid (KV, W), 128 threads. Partials of every live item. (The
// explicit minimum of one block an SM: without it ptxas spilled a few
// registers in three instances to reach a lower register count.)
template <typename T, int G, bool QUANT, class Rows>
__global__ void __launch_bounds__(NTHREADS, 1)
decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                    const T* __restrict__ kc, const T* __restrict__ vc,
                    const float* __restrict__ ks,
                    const float* __restrict__ vs, Rows rows,
                    const int* __restrict__ lengths,
                    float* __restrict__ work, int B, int H, int KV,
                    int NC, float scale) {
  using S = Tiles<T, G, QUANT>;
  constexpr int P = S::P;
  __shared__ __align__(128) S sm;
  const int kvh = blockIdx.x;
  const int W = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int cap = rows.capacity();

  // walk the item list (slot after slot, chunk after chunk) to item y
  int b = 0, base = 0;
  int len = B > 0 ? live_length(lengths, 0, cap) : 0;
#pragma unroll 1
  for (int item = blockIdx.y;; item += W) {
    while (b < B && item >= base + n_chunks(len)) {
      base += n_chunks(len);
      if (++b < B) len = live_length(lengths, b, cap);
    }
    if (b >= B) return;
    const int c = item - base;
    const int t_begin = c * kChunk;
    const int t_end = min(len, t_begin + kChunk);
    const int ntiles = (t_end - t_begin + P - 1) / P;

    // the query of this KV head's G heads (h = kvh*G + g)
    const __nv_bfloat16* qh = q + ((size_t)b * H + (size_t)kvh * G) * D;
#pragma unroll
    for (int g = 0; g < G; ++g)
      sm.q[g][tid] = __bfloat162float(qh[g * D + tid]) * scale;
    load_tile(sm, 0, rows, b, t_begin, t_end, kc, vc, ks, vs, KV, kvh);

    float m[S::HPW], l[S::HPW];
#pragma unroll
    for (int j = 0; j < S::HPW; ++j) {
      m[j] = kNegInf;
      l[j] = 0.f;
    }
    float acc[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[g][i] = 0.f;

#pragma unroll 1
    for (int i = 0; i < ntiles; ++i) {
      const int st = i & 1;
      const int t0 = t_begin + i * P;
      cp_wait_all();
      __syncthreads();
      if (i + 1 < ntiles)
        load_tile(sm, st ^ 1, rows, b, t0 + P, t_end, kc, vc, ks, vs, KV,
                  kvh);

      // scores: warp = a quarter of the dims, lane = positions
      {
        float s[S::PPT][G];
#pragma unroll
        for (int j = 0; j < S::PPT; ++j)
#pragma unroll
          for (int g = 0; g < G; ++g) s[j][g] = 0.f;
#pragma unroll
        for (int qs = 0; qs < S::QSEGS; ++qs) {
          const int seg = warp * S::QSEGS + qs;
          uint4 raw[S::PPT];
#pragma unroll
          for (int j = 0; j < S::PPT; ++j)
            raw[j] = *reinterpret_cast<const uint4*>(
                sm.k[st] + S::at(lane + 32 * j, seg));
#pragma unroll
          for (int k = 0; k < S::EPS / 4; ++k) {
            float4 kf[S::PPT];
#pragma unroll
            for (int j = 0; j < S::PPT; ++j) kf[j] = Conv<T>::quad(raw[j], k);
            const int d0 = seg * S::EPS + 4 * k;
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const float4 qv = *reinterpret_cast<const float4*>(&sm.q[g][d0]);
#pragma unroll
              for (int j = 0; j < S::PPT; ++j) {
                float a = s[j][g];
                a = fmaf(qv.x, kf[j].x, a);
                a = fmaf(qv.y, kf[j].y, a);
                a = fmaf(qv.z, kf[j].z, a);
                a = fmaf(qv.w, kf[j].w, a);
                s[j][g] = a;
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < S::PPT; ++j)
#pragma unroll
          for (int g = 0; g < G; ++g) sm.part[warp][g][lane + 32 * j] = s[j][g];
      }
      __syncthreads();

      // softmax over the sub-tile: warp w keeps heads w, w + 4
      const int nv = min(P, t_end - t0);
#pragma unroll
      for (int jh = 0; jh < S::HPW; ++jh) {
        const int g = warp + NWARPS * jh;
        if (g < G) {
          float sc[S::PPT];
          float mx = kNegInf;
#pragma unroll
          for (int j = 0; j < S::PPT; ++j) {
            const int p = lane + 32 * j;
            float x = sm.part[0][g][p];
#pragma unroll
            for (int w = 1; w < NWARPS; ++w) x += sm.part[w][g][p];
            if (QUANT) x *= sm.ks[st][p];
            sc[j] = x;
            if (p < nv) mx = fmaxf(mx, x);
          }
#pragma unroll
          for (int off = 16; off > 0; off /= 2)
            mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
          const float mn = fmaxf(m[jh], mx);
          const float cr = __expf(m[jh] - mn);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < S::PPT; ++j) {
            const int p = lane + 32 * j;
            const float e = p < nv ? __expf(sc[j] - mn) : 0.f;
            sum += e;
            sm.part[0][g][p] = QUANT ? e * sm.vs[st][p] : e;
          }
#pragma unroll
          for (int off = 16; off > 0; off /= 2)
            sum += __shfl_xor_sync(FULL, sum, off);
          l[jh] = l[jh] * cr + sum;
          m[jh] = mn;
          if (lane == 0) sm.corr[g] = cr;
        }
      }
      __syncthreads();

      // P.V: lane = 4 adjacent dims, warp = a quarter of the positions
      {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float cr = sm.corr[g];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[g][i] *= cr;
        }
        constexpr int BPL = 4 * (int)sizeof(T);  // bytes of 4 dims
#pragma unroll
        for (int p4 = 0; p4 < S::PPW; p4 += 4) {
          const int p0 = warp * S::PPW + p4;
          float4 vf[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int byte = lane * BPL;
            vf[j] = Conv<T>::load4(sm.v[st] + S::at(p0 + j, byte >> 4) +
                                   (byte & 15));
          }
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float4 pr =
                *reinterpret_cast<const float4*>(&sm.part[0][g][p0]);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float pj = j == 0 ? pr.x : j == 1 ? pr.y
                                             : j == 2 ? pr.z : pr.w;
              acc[g][0] = fmaf(pj, vf[j].x, acc[g][0]);
              acc[g][1] = fmaf(pj, vf[j].y, acc[g][1]);
              acc[g][2] = fmaf(pj, vf[j].z, acc[g][2]);
              acc[g][3] = fmaf(pj, vf[j].w, acc[g][3]);
            }
          }
        }
      }
    }

    // the item's partial: the warps' accumulators summed in warp order
    __syncthreads();
    float* red = reinterpret_cast<float*>(sm.k);  // [NWARPS][G][D]
#pragma unroll
    for (int g = 0; g < G; ++g)
      *reinterpret_cast<float4*>(&red[(warp * G + g) * D + 4 * lane]) =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
    float* wp = work + (((size_t)b * KV + kvh) * NC + c) * (G * kWork);
#pragma unroll
    for (int jh = 0; jh < S::HPW; ++jh) {
      const int g = warp + NWARPS * jh;
      if (g < G && lane == 0) {
        wp[G * D + g] = m[jh];
        wp[G * D + G + g] = l[jh];
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float a = red[g * D + tid];
#pragma unroll
      for (int w = 1; w < NWARPS; ++w) a += red[(w * G + g) * D + tid];
      wp[g * D + tid] = a;
    }
    __syncthreads();
  }
}

// Pass 2: grid (KV, B), 128 threads (thread = dim). Fold the slot's
// partials in chunk order, then this step's k_new / v_new; write bf16.
template <int G>
__global__ void __launch_bounds__(NTHREADS)
decode_combine_kernel(const __nv_bfloat16* __restrict__ q,
                      const int* __restrict__ lengths,
                      const float* __restrict__ work,
                      const __nv_bfloat16* __restrict__ k_new,
                      const __nv_bfloat16* __restrict__ v_new,
                      __nv_bfloat16* __restrict__ out, int H, int KV,
                      int NC, int cap, float scale) {
  __shared__ float snew[G];
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const __nv_bfloat16* qh = q + ((size_t)b * H + (size_t)kvh * G) * D;
  const __nv_bfloat16* kn = k_new + ((size_t)b * KV + kvh) * D;

  // this step's score for each head against k_new
  for (int g = warp; g < G; g += NWARPS) {
    const __nv_bfloat16* qp = qh + g * D;
    float d = 0.f;
#pragma unroll
    for (int i = lane; i < D; i += 32)
      d = fmaf(__bfloat162float(qp[i]) * scale, __bfloat162float(kn[i]), d);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) d += __shfl_xor_sync(FULL, d, off);
    if (lane == 0) snew[g] = d;
  }
  __syncthreads();

  const int nc = n_chunks(live_length(lengths, b, cap));
  const float* wp = work + ((size_t)b * KV + kvh) * NC * (G * kWork);
  const float vn = __bfloat162float(v_new[((size_t)b * KV + kvh) * D + tid]);
  __nv_bfloat16* o = out + ((size_t)b * H + (size_t)kvh * G) * D;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float M = kNegInf, L = 0.f, A = 0.f;
    for (int c = 0; c < nc; ++c) {
      const float* it = wp + (size_t)c * (G * kWork);
      const float mc = it[G * D + g];
      const float mn = fmaxf(M, mc);
      const float a = __expf(M - mn);
      const float e = __expf(mc - mn);
      L = L * a + it[G * D + G + g] * e;
      A = A * a + it[g * D + tid] * e;
      M = mn;
    }
    const float sn = snew[g];
    const float mt = fmaxf(M, sn);
    const float alpha = __expf(M - mt);
    const float beta = __expf(sn - mt);
    const float lt = L * alpha + beta;
    o[g * D + tid] = __float2bfloat16((A * alpha + beta * vn) / lt);
  }
}

// Both passes on `stream`. `work` holds B*KV*NC*G*(D+2) floats, NC =
// ceil(capacity / kChunk); W blocks per KV head walk the items; `chunk`
// is the wrapper's idea of kChunk, checked.
template <typename T, bool QUANT, class Rows>
int launch(const void* q, const void* kc, const void* vc, const void* ks,
           const void* vs, const Rows& rows, const void* lengths,
           const void* k_new, const void* v_new, void* out, void* work,
           int B, int H, int KV, int W, int chunk, float scale,
           void* stream) {
  const int cap = rows.capacity();
  if (KV <= 0 || H % KV != 0 || B <= 0 || W <= 0 || cap < 0 ||
      chunk != kChunk)
    return cudaErrorInvalidValue;
  const int NC = (cap + kChunk - 1) / kChunk;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(q);
  const int* lens = static_cast<const int*>(lengths);
  float* wk = static_cast<float*>(work);
#define GOFR_DECODE_CASE(GV)                                                   \
  case GV:                                                                     \
    decode_split_kernel<T, GV, QUANT, Rows><<<dim3(KV, W), NTHREADS, 0, st>>>( \
        qb, static_cast<const T*>(kc), static_cast<const T*>(vc),             \
        static_cast<const float*>(ks), static_cast<const float*>(vs), rows,   \
        lens, wk, B, H, KV, NC, scale);                                       \
    decode_combine_kernel<GV><<<dim3(KV, B), NTHREADS, 0, st>>>(              \
        qb, lens, wk, static_cast<const __nv_bfloat16*>(k_new),               \
        static_cast<const __nv_bfloat16*>(v_new),                             \
        static_cast<__nv_bfloat16*>(out), H, KV, NC, cap, scale);             \
    break;
  switch (H / KV) {
    GOFR_DECODE_CASE(1)
    GOFR_DECODE_CASE(2)
    GOFR_DECODE_CASE(4)
    GOFR_DECODE_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef GOFR_DECODE_CASE
  return cudaGetLastError();
}

}  // namespace decode
}  // namespace gofr
