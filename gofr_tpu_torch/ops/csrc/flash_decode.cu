// One-token decode attention over the KV cache, with this step's k/v
// folded in, head_dim 128, sm_90a.
//
// Replaces the TPU kernel gofr_tpu/ops/flash_decode.py::_decode_kernel
// (the pallas_call in _flash_decode_cache) together with the jnp
// append-fold of flash_decode_appended. Same function: q [B, H, D]
// against caches [B, Smax, KV, D] -- int8 with float32 per-vector
// scales [B, Smax, KV] (the k scale multiplies the scores, the v scale
// the probabilities), or dense bf16 -- over positions < lengths[b], then
// the not-yet-written token's k_new / v_new [B, KV, D] join with the
// exact flash combination, so a slot of length 0 returns v_new.
//
// What bounds it on an H100: the cache stream. At 8 slots of 512 live
// tokens one launch reads about 8.7 MB of int8 K/V and scales (2.6 us
// at 3.35 TB/s) and does about 4 FLOP per byte, far below the point
// where arithmetic matters.
//
// Design:
//  - one block per (KV head, slot): one pass over that head's int8 K/V
//    rows serves all G = H/KV query heads of the head (the TPU kernel's
//    block-diagonal [H, KV*D] query was a matrix-unit workaround and is
//    not carried over);
//  - the block reads exactly lengths[b] positions -- the TPU kernel's
//    clamped index map made per-slot traffic track the live length;
//    here it is the loop bound;
//  - 8 lanes cover one 128-wide row with one 16-byte load each (int8),
//    so a warp reads 4 positions and the block 32 per step, two steps
//    unrolled to keep more loads in flight; each 8-lane group keeps its
//    own running max / sum / accumulator in registers, and the groups
//    then the warps combine with the flash rule at the end;
//  - scales are read in the cache's own [B, Smax, KV] layout, no
//    transpose;
//  - the epilogue folds in k_new / v_new and writes bf16.
// Splitting S across blocks, to fill more than B*KV SMs at small batch,
// is later work.

#include "common.cuh"

namespace {

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
    gofr::load8(p, f);
    gofr::load8(p + 8, f + 8);
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

template <typename T, int G, bool QUANT>
__global__ void __launch_bounds__(NTHREADS)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const T* __restrict__ kc, const T* __restrict__ vc,
                    const float* __restrict__ ks, const float* __restrict__ vs,
                    const int* __restrict__ lengths,
                    const __nv_bfloat16* __restrict__ k_new,
                    const __nv_bfloat16* __restrict__ v_new,
                    __nv_bfloat16* __restrict__ out, int Smax, int H, int KV,
                    float scale) {
  __shared__ float sm_m[NWARPS][G];
  __shared__ float sm_l[NWARPS][G];
  __shared__ float sm_acc[NWARPS][G][D];
  __shared__ float sm_snew[G];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int grp = tid / LANES_PER_ROW;
  const int d0 = (tid % LANES_PER_ROW) * EPT;
  const unsigned gmask = 0xffu << (lane & ~(LANES_PER_ROW - 1));
  int length = lengths[b];
  length = length < 0 ? 0 : (length > Smax ? Smax : length);

  // this KV head's G query heads (h = kvh*G + g), this lane's slice,
  // pre-scaled by 1/sqrt(D)
  const __nv_bfloat16* qh = q + ((size_t)b * H + (size_t)kvh * G) * D;
  float qf[G][EPT];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    gofr::load8(qh + g * D + d0, qf[g]);
    gofr::load8(qh + g * D + d0 + 8, qf[g] + 8);
#pragma unroll
    for (int i = 0; i < EPT; ++i) qf[g][i] *= scale;
  }
  float m[G], l[G], acc[G][EPT];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = gofr::kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < EPT; ++i) acc[g][i] = 0.f;
  }

  const size_t row = (size_t)KV * D;  // elements between positions
  const T* kb = kc + (size_t)b * Smax * row + (size_t)kvh * D + d0;
  const T* vb = vc + (size_t)b * Smax * row + (size_t)kvh * D + d0;
  const size_t srow0 = (size_t)b * Smax * KV + kvh;  // scale of position 0
  for (int t0 = grp; t0 < length; t0 += 2 * GROUPS) {
    const int t1 = t0 + GROUPS;
    const bool has1 = t1 < length;
    float kf0[EPT], vf0[EPT], kf1[EPT], vf1[EPT];
    Row<T>::load(kb + (size_t)t0 * row, kf0);
    Row<T>::load(vb + (size_t)t0 * row, vf0);
    if (has1) {
      Row<T>::load(kb + (size_t)t1 * row, kf1);
      Row<T>::load(vb + (size_t)t1 * row, vf1);
    }
    float ks0 = 1.f, vs0 = 1.f, ks1 = 1.f, vs1 = 1.f;
    if (QUANT) {
      ks0 = ks[srow0 + (size_t)t0 * KV];
      vs0 = vs[srow0 + (size_t)t0 * KV];
      if (has1) {
        ks1 = ks[srow0 + (size_t)t1 * KV];
        vs1 = vs[srow0 + (size_t)t1 * KV];
      }
    }
    fold<G>(qf, kf0, vf0, ks0, vs0, gmask, m, l, acc);
    if (has1) fold<G>(qf, kf1, vf1, ks1, vs1, gmask, m, l, acc);
  }

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
    const __nv_bfloat16* kp = k_new + ((size_t)b * KV + kvh) * D;
    float d = 0.f;
#pragma unroll
    for (int i = lane; i < D; i += 32)
      d = fmaf(__bfloat162float(qp[i]) * scale, __bfloat162float(kp[i]), d);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) d += __shfl_xor_sync(FULL, d, off);
    if (lane == 0) sm_snew[warp] = d;
  }
  __syncthreads();

  const __nv_bfloat16* vn = v_new + ((size_t)b * KV + kvh) * D;
  for (int o = tid; o < G * D; o += NTHREADS) {
    const int g = o / D;
    const int d = o % D;
    float M = gofr::kNegInf;
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
    out[((size_t)b * H + (size_t)kvh * G + g) * D + d] = __float2bfloat16(res);
  }
}

template <typename T, bool QUANT>
int launch(const void* q, const void* kc, const void* vc, const void* ks,
           const void* vs, const void* lengths, const void* k_new,
           const void* v_new, void* out, int B, int Smax, int H, int KV,
           float scale, void* stream) {
  if (KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  const dim3 grid(KV, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GOFR_DECODE_CASE(GV)                                                   \
  case GV:                                                                     \
    flash_decode_kernel<T, GV, QUANT><<<grid, NTHREADS, 0, st>>>(              \
        static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(kc),      \
        static_cast<const T*>(vc), static_cast<const float*>(ks),             \
        static_cast<const float*>(vs), static_cast<const int*>(lengths),      \
        static_cast<const __nv_bfloat16*>(k_new),                             \
        static_cast<const __nv_bfloat16*>(v_new),                             \
        static_cast<__nv_bfloat16*>(out), Smax, H, KV, scale);                \
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

}  // namespace

// q/out [B, H, 128] bf16; k_cache/v_cache [B, Smax, KV, 128] int8 with
// k_scale/v_scale [B, Smax, KV] float32; lengths [B] int32; k_new/v_new
// [B, KV, 128] bf16; all contiguous on the current device.
extern "C" int gofr_flash_decode_int8(const void* q, const void* kc,
                                      const void* vc, const void* ks,
                                      const void* vs, const void* lengths,
                                      const void* k_new, const void* v_new,
                                      void* out, int B, int Smax, int H,
                                      int KV, float scale, void* stream) {
  return launch<int8_t, true>(q, kc, vc, ks, vs, lengths, k_new, v_new, out,
                              B, Smax, H, KV, scale, stream);
}

// The dense bf16 cache: as above without scales (ks/vs are ignored).
extern "C" int gofr_flash_decode_bf16(const void* q, const void* kc,
                                      const void* vc, const void* ks,
                                      const void* vs, const void* lengths,
                                      const void* k_new, const void* v_new,
                                      void* out, int B, int Smax, int H,
                                      int KV, float scale, void* stream) {
  return launch<__nv_bfloat16, false>(q, kc, vc, ks, vs, lengths, k_new,
                                      v_new, out, B, Smax, H, KV, scale,
                                      stream);
}
