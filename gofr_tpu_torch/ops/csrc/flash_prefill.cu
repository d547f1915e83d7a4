// Causal GQA flash attention for prefill, bf16, head_dim 128, sm_90a.
//
// Replaces the TPU kernel gofr_tpu/ops/flash.py::_flash_kernel (the
// pallas_call in flash_causal_prefill). Same function: q [B, S, H, D],
// k/v [B, S, KV, D], query head h reads KV head h*KV/H, keys at or past
// lengths[b] are masked, query rows at or past lengths[b] come out as
// zeros, softmax is the online (running max / running sum) recurrence
// in float32, so the [S, S] score matrix never reaches device memory.
//
// What bounds it on an H100: at the serving shapes (B=1, S=512, H=32,
// KV=8) one launch moves about 10.5 MB of Q/K/V/O (3.1 us at 3.35 TB/s)
// and does about 2.1 GFLOP on the causal half (2.2 us at 989 TFLOP/s
// bf16), so it is bound by bytes, with the tensor cores close behind.
//
// Design:
//  - one block of 4 warps per (64-row query tile, head, batch); the Q
//    tile stays in shared memory for the block's life, and each warp
//    owns 16 query rows of the scores, probabilities and accumulator,
//    so only the K/V tile loads need block-wide barriers;
//  - the loop over 64-key tiles stops at the diagonal AND at
//    lengths[b]: keys past the prompt are neither read nor computed (the
//    TPU kernel streamed those tiles and skipped only the math), and a
//    tile whose rows are all past the length writes zeros and reads
//    nothing;
//  - Q K^T and P V run on the tensor cores through WMMA 16x16x16 bf16
//    fragments with float32 accumulation; the running m / l stay in
//    registers and the output accumulator in float32 shared memory;
//  - any S works: the ragged last tile is zero-filled and masked rather
//    than required to divide 128 as the TPU kernel's gate does;
//  - shared memory is 110 KB (Q, K, V tiles, float32 scores, bf16
//    probabilities, float32 accumulator), above the 48 KB static limit,
//    so it is dynamic and the launcher raises the kernel's limit first.
// wgmma, TMA and a K/V pipeline are later work.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr int D = 128;           // head_dim
constexpr int NTHREADS = 128;    // 4 warps x 16 query rows
constexpr int LDQ = D + 8;       // bf16 pitch of the Q/K/V tiles
constexpr int LDS = BK + 4;      // float32 pitch of the score tile
constexpr int LDP = BK + 8;      // bf16 pitch of the probability tile
constexpr int LDO = D + 4;       // float32 pitch of the accumulator
constexpr int VEC = 8;           // bf16 values per 16-byte access

struct Smem {
  __nv_bfloat16 q[BQ * LDQ];
  __nv_bfloat16 k[BK * LDQ];
  __nv_bfloat16 v[BK * LDQ];
  float s[BQ * LDS];
  __nv_bfloat16 p[BQ * LDP];
  float o[BQ * LDO];
};

// Copy a [rows, D] tile whose rows are `stride` elements apart into
// shared memory; rows at or past `limit` are zero-filled.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t stride, int row0, int limit) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < BQ * (D / VEC); i += NTHREADS) {
    const int r = i / (D / VEC);
    const int c = (i % (D / VEC)) * VEC;
    uint4 val = zero;
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LDQ + c) = val;
  }
}

__global__ void __launch_bounds__(NTHREADS)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ lengths,
                     __nv_bfloat16* __restrict__ out,
                     int S, int H, int KV, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h * KV / H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
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
    for (int i = threadIdx.x; i < BQ * (D / VEC); i += NTHREADS) {
      const int r = i / (D / VEC);
      const int c = (i % (D / VEC)) * VEC;
      if (q0 + r < S)
        *reinterpret_cast<uint4*>(ob + (size_t)(q0 + r) * q_stride + c) = zero;
    }
    return;
  }

  load_tile(sm.q, qb, q_stride, q0, S);

  // this lane's row (two lanes per row, each owning half of its columns)
  const int r = warp * 16 + lane / 2;
  const int half = lane & 1;
  const int qpos = q0 + r;
  float* o_row = sm.o + r * LDO + half * (D / 2);
#pragma unroll 8
  for (int c = 0; c < D / 2; ++c) o_row[c] = 0.f;
  float m_i = gofr::kNegInf;
  float l_i = 0.f;

  const int kend = min(q0 + BQ, length);  // keys [0, kend) are needed
  const int n_tiles = (kend + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(sm.k, kb, kv_stride, k0, S);
    load_tile(sm.v, vb, kv_stride, k0, S);
    __syncthreads();

    // scores of this warp's 16 rows against the 64 keys of the tile
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> fb;  // K^T read from row-major K
        wmma::load_matrix_sync(fa, sm.q + (warp * 16) * LDQ + kk * 16, LDQ);
        wmma::load_matrix_sync(fb, sm.k + (j * 16) * LDQ + kk * 16, LDQ);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sm.s + (warp * 16) * LDS + j * 16, acc, LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this lane's 32 columns of its row
    const int c0 = half * (BK / 2);
    const float* s_row = sm.s + r * LDS + c0;
    __nv_bfloat16* p_row = sm.p + r * LDP + c0;
    float mx = gofr::kNegInf;
#pragma unroll 8
    for (int c = 0; c < BK / 2; ++c) {
      const int kpos = k0 + c0 + c;
      if (kpos <= qpos && kpos < length) mx = fmaxf(mx, s_row[c] * scale);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float corr = __expf(m_i - m_new);
    float rs = 0.f;
#pragma unroll 8
    for (int c = 0; c < BK / 2; ++c) {
      const int kpos = k0 + c0 + c;
      float p = 0.f;
      if (kpos <= qpos && kpos < length) p = __expf(s_row[c] * scale - m_new);
      rs += p;
      p_row[c] = __float2bfloat16(p);
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    l_i = l_i * corr + rs;
    m_i = m_new;
#pragma unroll 8
    for (int c = 0; c < D / 2; ++c) o_row[c] *= corr;
    __syncwarp();

    // accumulator += P V for this warp's rows
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* o_tile = sm.o + (warp * 16) * LDO + n * 16;
      wmma::load_matrix_sync(acc, o_tile, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sm.p + (warp * 16) * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(fb, sm.v + (kk * 16) * LDQ + n * 16, LDQ);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(o_tile, acc, LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (qpos < S) {
    const bool live = qpos < length;
    const float inv = (l_i == 0.f) ? 1.f : 1.f / l_i;
    __nv_bfloat16* dst = ob + (size_t)qpos * q_stride + half * (D / 2);
    for (int c = 0; c < D / 2; c += VEC) {
      float f[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] = live ? o_row[c + i] * inv : 0.f;
      gofr::store8(dst + c, f);
    }
  }
}

}  // namespace

// q/out [B, S, H, 128] bf16, k/v [B, S, KV, 128] bf16, lengths [B] int32,
// all contiguous on the current device; scale = 1/sqrt(128).
extern "C" int gofr_flash_prefill_bf16(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, int B, int S, int H, int KV,
                                       float scale, void* stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sizeof(Smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_prefill_kernel<<<grid, NTHREADS, sizeof(Smem),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), S, H, KV, scale);
  return cudaGetLastError();
}
