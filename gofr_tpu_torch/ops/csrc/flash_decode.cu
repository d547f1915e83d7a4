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
// Row, fold, start (the prologue), finish (the combine and epilogue) and
// the constants are decode_attention.cuh, shared with the paged kernel,
// which visits positions in this kernel's order. Splitting
// S across blocks, to fill more than B*KV SMs at small batch, is later
// work.

#include "decode_attention.cuh"

namespace {

using namespace gofr::decode;

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
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int grp = tid / LANES_PER_ROW;
  const int d0 = (tid % LANES_PER_ROW) * EPT;
  const unsigned gmask = 0xffu << (lane & ~(LANES_PER_ROW - 1));
  int length = lengths[b];
  length = length < 0 ? 0 : (length > Smax ? Smax : length);

  // this KV head's G query heads (h = kvh*G + g)
  const __nv_bfloat16* qh = q + ((size_t)b * H + (size_t)kvh * G) * D;
  float qf[G][EPT], m[G], l[G], acc[G][EPT];
  start<G>(qh, scale, qf, m, l, acc);

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

  finish<G>(m, l, acc, qh, k_new + ((size_t)b * KV + kvh) * D,
            v_new + ((size_t)b * KV + kvh) * D,
            out + ((size_t)b * H + (size_t)kvh * G) * D, scale);
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
