// What the two decode-attention kernels share: flash_decode.cu (a
// contiguous [B, Smax, KV, 128] cache) and paged_decode.cu (a block pool
// [N, T, KV, 128] read through a block table). Both run one block of 256
// threads per (KV head, slot), 8 lanes per 128-wide row with one 16-byte
// load each, and fold every cache position into a group's running
// (max, sum, accumulator) with `fold` below -- so, visiting positions in
// the same order, they do the same float operations and return the same
// bits on the same K/V. (The TPU side shares
// gofr_tpu/ops/flash_decode.py::_decode_kernel the same way.)
//
// The prologue (`start`) and the combine and epilogue (`finish`), which
// run once per block, are shared too; the position loop stays in each
// kernel's own source. Shared as one inlined function with the
// epilogue, the loop cost the contiguous kernel's int8 instance 14% at
// 8 slots x 512 live tokens (0.0207 against 0.0182 ms); sharing only
// `start` and `finish` costs nothing measurable (int8 0.0175 ms either
// way; chip_smoke.py phase 3 on an H100 80GB HBM3 at 700 W, the two
// builds run in turns in one call). The G=4 instances that serve
// Llama-3-8B do not spill; the G=8 instances of both kernels keep a
// 376-408 byte stack frame with about 400 bytes of spill stores.
#pragma once

#include "common.cuh"

namespace gofr {
namespace decode {

constexpr int D = 128;
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int LANES_PER_ROW = 8;
constexpr int EPT = D / LANES_PER_ROW;            // 16 elements per lane
constexpr int GROUPS = NTHREADS / LANES_PER_ROW;  // positions per step
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct Row;

template <>
struct Row<int8_t> {
  __device__ __forceinline__ static void load(const int8_t* p, float* f) {
    const int4 raw = *reinterpret_cast<const int4*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < EPT; ++i) f[i] = static_cast<float>(c[i]);
  }
};

template <>
struct Row<__nv_bfloat16> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* f) {
    load8(p, f);
    load8(p + 8, f + 8);
  }
};

// Fold one cache position into a group's running (m, l, acc) for the G
// query heads. `kf`/`vf` are this lane's 16 elements of the K/V row.
template <int G>
__device__ __forceinline__ void fold(const float (&qf)[G][EPT],
                                     const float (&kf)[EPT],
                                     const float (&vf)[EPT], float ksc,
                                     float vsc, unsigned gmask, float (&m)[G],
                                     float (&l)[G], float (&acc)[G][EPT]) {
  float s[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < EPT; ++i) d = fmaf(qf[g][i], kf[i], d);
    s[g] = d;
  }
#pragma unroll
  for (int off = LANES_PER_ROW / 2; off > 0; off /= 2) {
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] += __shfl_xor_sync(gmask, s[g], off);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float sg = s[g] * ksc;
    const float mn = fmaxf(m[g], sg);
    const float corr = __expf(m[g] - mn);
    const float p = __expf(sg - mn);
    l[g] = l[g] * corr + p;
    const float pv = p * vsc;
#pragma unroll
    for (int i = 0; i < EPT; ++i) acc[g][i] = fmaf(acc[g][i], corr, pv * vf[i]);
    m[g] = mn;
  }
}

// Before the position loop: this lane's 16 elements of each of the G
// query heads at `qh` (h = kvh*G + g), pre-scaled by 1/sqrt(D), and the
// empty running state.
template <int G>
__device__ __forceinline__ void start(const __nv_bfloat16* qh, float scale,
                                      float (&qf)[G][EPT], float (&m)[G],
                                      float (&l)[G], float (&acc)[G][EPT]) {
  const int d0 = (threadIdx.x % LANES_PER_ROW) * EPT;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load8(qh + g * D + d0, qf[g]);
    load8(qh + g * D + d0 + 8, qf[g] + 8);
#pragma unroll
    for (int i = 0; i < EPT; ++i) qf[g][i] *= scale;
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < EPT; ++i) acc[g][i] = 0.f;
  }
}

// After the position loop: combine the groups' running state within each
// warp, then across the warps with this step's k_new / v_new rows `kn` /
// `vn` [D] (the exact flash combination), and write the G heads' bf16
// rows to `out` [G, D]. Runs once per block, outside the hot loop.
template <int G>
__device__ __forceinline__ void finish(float (&m)[G], float (&l)[G],
                                       float (&acc)[G][EPT],
                                       const __nv_bfloat16* qh,
                                       const __nv_bfloat16* kn,
                                       const __nv_bfloat16* vn,
                                       __nv_bfloat16* out, float scale) {
  __shared__ float sm_m[NWARPS][G];
  __shared__ float sm_l[NWARPS][G];
  __shared__ float sm_acc[NWARPS][G][D];
  __shared__ float sm_snew[G];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int d0 = (tid % LANES_PER_ROW) * EPT;

  // combine the warp's 4 groups (lanes 8 and 16 apart)
#pragma unroll
  for (int off = LANES_PER_ROW; off < 32; off *= 2) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(FULL, m[g], off);
      const float lo = __shfl_xor_sync(FULL, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float cs = __expf(m[g] - mn);
      const float co = __expf(mo - mn);
      l[g] = l[g] * cs + lo * co;
#pragma unroll
      for (int i = 0; i < EPT; ++i)
        acc[g][i] = acc[g][i] * cs + __shfl_xor_sync(FULL, acc[g][i], off) * co;
      m[g] = mn;
    }
  }
  if (lane < LANES_PER_ROW) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < EPT; ++i) sm_acc[warp][g][d0 + i] = acc[g][i];
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  // this step's score for query head `warp` against k_new
  if (warp < G) {
    const __nv_bfloat16* qp = qh + warp * D;
    float d = 0.f;
#pragma unroll
    for (int i = lane; i < D; i += 32)
      d = fmaf(__bfloat162float(qp[i]) * scale, __bfloat162float(kn[i]), d);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) d += __shfl_xor_sync(FULL, d, off);
    if (lane == 0) sm_snew[warp] = d;
  }
  __syncthreads();

  for (int o = tid; o < G * D; o += NTHREADS) {
    const int g = o / D;
    const int d = o % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float c = __expf(sm_m[w][g] - M);
      L = fmaf(sm_l[w][g], c, L);
      A = fmaf(sm_acc[w][g][d], c, A);
    }
    const float sn = sm_snew[g];
    const float mt = fmaxf(M, sn);
    const float alpha = __expf(M - mt);
    const float beta = __expf(sn - mt);
    const float lt = L * alpha + beta;
    const float res = (A * alpha + beta * __bfloat162float(vn[d])) / lt;
    out[o] = __float2bfloat16(res);
  }
}

}  // namespace decode
}  // namespace gofr
