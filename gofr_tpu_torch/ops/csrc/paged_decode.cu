// One-token decode attention over a paged KV pool, with this step's k/v
// folded in, head_dim 128, sm_90a.
//
// Replaces the TPU kernel gofr_tpu/ops/paged_attention.py::
// _paged_decode_cache (its pallas_call runs flash_decode's
// _decode_kernel with the K/V/scale index maps reading table[b, si])
// together with the jnp append-fold of paged_decode_attention. Same
// function: q [B, H, D] against pools [N, T, KV, D] -- int8 with float32
// per-vector scales [N, T, KV], or dense bf16 -- where position t of
// slot b lives at block table[b, t / T], offset t % T, over positions <
// lengths[b], then this step's k_new / v_new [B, KV, D] join with the
// exact flash combination, so a slot of length 0 returns v_new.
//
// What bounds it on an H100: the pool stream, as for flash_decode. At 8
// slots of 512 live tokens one launch reads about 8.7 MB of int8 K/V and
// scales (2.6 us at 3.35 TB/s) plus the table; about 4 FLOP per byte.
//
// Design: flash_decode's, with each row found through the table
// (decode_attention.cuh holds the per-position fold, the prologue, and
// the combine and epilogue, which the two kernels share):
//  - one block per (KV head, slot) serves the head's G query heads;
//  - the row of position t is table[b*MB + t/T]*T + t%T; block ids are
//    clamped into [0, N) so a bad table can misread but never fault;
//  - the loop bound is lengths[b] (clamped to MB*T), so table entries
//    past the live range -- which the engine clamps to the last live
//    block, the TPU kernel's DMA skip -- are never read at all;
//  - the table row is read through the read-only cache: all 8 lanes of
//    a group ask for the same word, and a slot's row is MB ints;
//  - scales are read in the pool's own [N, T, KV] layout;
//  - positions are visited in flash_decode's order with its group
//    stride and unrolled pair, and the rest is shared code, so the
//    paged and contiguous kernels do the same float operations
//    and agree bit for bit on the same K/V.
// Splitting S across blocks and TMA block loads are later work.

#include "decode_attention.cuh"

namespace {

using namespace gofr::decode;

// the pool row of position t: block table[t / T] (clamped into [0, N)),
// offset t % T, with `table` at the slot's own row of block ids
__device__ __forceinline__ size_t pool_row(const int* __restrict__ table,
                                           int t, int T, int N) {
  const int j = t / T;
  int blk = __ldg(table + j);
  blk = blk < 0 ? 0 : (blk >= N ? N - 1 : blk);
  return (size_t)blk * T + (size_t)(t - j * T);
}

template <typename T, int G, bool QUANT>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const T* __restrict__ kp, const T* __restrict__ vp,
                    const float* __restrict__ ks, const float* __restrict__ vs,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths,
                    const __nv_bfloat16* __restrict__ k_new,
                    const __nv_bfloat16* __restrict__ v_new,
                    __nv_bfloat16* __restrict__ out, int MB, int Tb, int N,
                    int H, int KV, float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int grp = tid / LANES_PER_ROW;
  const int d0 = (tid % LANES_PER_ROW) * EPT;
  const unsigned gmask = 0xffu << (lane & ~(LANES_PER_ROW - 1));
  const int cap = MB * Tb;
  int length = lengths[b];
  length = length < 0 ? 0 : (length > cap ? cap : length);
  const int* trow = table + (size_t)b * MB;

  // this KV head's G query heads (h = kvh*G + g)
  const __nv_bfloat16* qh = q + ((size_t)b * H + (size_t)kvh * G) * D;
  float qf[G][EPT], m[G], l[G], acc[G][EPT];
  start<G>(qh, scale, qf, m, l, acc);

  const size_t row = (size_t)KV * D;  // elements between pool rows
  const T* kb = kp + (size_t)kvh * D + d0;
  const T* vb = vp + (size_t)kvh * D + d0;
  for (int t0 = grp; t0 < length; t0 += 2 * GROUPS) {
    const int t1 = t0 + GROUPS;
    const bool has1 = t1 < length;
    const size_t r0 = pool_row(trow, t0, Tb, N);
    float kf0[EPT], vf0[EPT], kf1[EPT], vf1[EPT];
    Row<T>::load(kb + r0 * row, kf0);
    Row<T>::load(vb + r0 * row, vf0);
    size_t r1 = r0;
    if (has1) {
      r1 = pool_row(trow, t1, Tb, N);
      Row<T>::load(kb + r1 * row, kf1);
      Row<T>::load(vb + r1 * row, vf1);
    }
    float ks0 = 1.f, vs0 = 1.f, ks1 = 1.f, vs1 = 1.f;
    if (QUANT) {
      ks0 = ks[r0 * KV + kvh];
      vs0 = vs[r0 * KV + kvh];
      if (has1) {
        ks1 = ks[r1 * KV + kvh];
        vs1 = vs[r1 * KV + kvh];
      }
    }
    fold<G>(qf, kf0, vf0, ks0, vs0, gmask, m, l, acc);
    if (has1) fold<G>(qf, kf1, vf1, ks1, vs1, gmask, m, l, acc);
  }

  finish<G>(m, l, acc, qh, k_new + ((size_t)b * KV + kvh) * D,
            v_new + ((size_t)b * KV + kvh) * D,
            out + ((size_t)b * H + (size_t)kvh * G) * D, scale);
}

template <typename T, bool QUANT>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const void* table, const void* lengths,
           const void* k_new, const void* v_new, void* out, int B, int MB,
           int Tb, int N, int H, int KV, float scale, void* stream) {
  if (KV <= 0 || H % KV != 0 || Tb <= 0 || N <= 0 || MB <= 0)
    return cudaErrorInvalidValue;
  const dim3 grid(KV, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GOFR_PAGED_CASE(GV)                                                    \
  case GV:                                                                     \
    paged_decode_kernel<T, GV, QUANT><<<grid, NTHREADS, 0, st>>>(              \
        static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(kp),      \
        static_cast<const T*>(vp), static_cast<const float*>(ks),             \
        static_cast<const float*>(vs), static_cast<const int*>(table),        \
        static_cast<const int*>(lengths),                                     \
        static_cast<const __nv_bfloat16*>(k_new),                             \
        static_cast<const __nv_bfloat16*>(v_new),                             \
        static_cast<__nv_bfloat16*>(out), MB, Tb, N, H, KV, scale);           \
    break;
  switch (H / KV) {
    GOFR_PAGED_CASE(1)
    GOFR_PAGED_CASE(2)
    GOFR_PAGED_CASE(4)
    GOFR_PAGED_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef GOFR_PAGED_CASE
  return cudaGetLastError();
}

}  // namespace

// q/out [B, H, 128] bf16; k_pool/v_pool [N, T, KV, 128] int8 with
// k_scale/v_scale [N, T, KV] float32; table [B, MB] int32 block ids;
// lengths [B] int32; k_new/v_new [B, KV, 128] bf16; all contiguous on
// the current device.
extern "C" int gofr_paged_decode_int8(const void* q, const void* kp,
                                      const void* vp, const void* ks,
                                      const void* vs, const void* table,
                                      const void* lengths, const void* k_new,
                                      const void* v_new, void* out, int B,
                                      int MB, int T, int N, int H, int KV,
                                      float scale, void* stream) {
  return launch<int8_t, true>(q, kp, vp, ks, vs, table, lengths, k_new,
                              v_new, out, B, MB, T, N, H, KV, scale, stream);
}

// The dense bf16 pool: as above without scales (ks/vs are ignored).
extern "C" int gofr_paged_decode_bf16(const void* q, const void* kp,
                                      const void* vp, const void* ks,
                                      const void* vs, const void* table,
                                      const void* lengths, const void* k_new,
                                      const void* v_new, void* out, int B,
                                      int MB, int T, int N, int H, int KV,
                                      float scale, void* stream) {
  return launch<__nv_bfloat16, false>(q, kp, vp, ks, vs, table, lengths,
                                      k_new, v_new, out, B, MB, T, N, H, KV,
                                      scale, stream);
}
