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
// tokens one launch reads about 8.8 MB of int8 K/V and scales (2.6 us
// at 3.35 TB/s) and does about 4 FLOP per byte, far below the point
// where arithmetic matters.
//
// Design: decode_attention.cuh's body (a split over the cache into
// chunks of 256 positions, tile-wise softmax, a combine pass), shared
// with the paged kernel; here the row of position t of slot b is
// b*Smax + t. Scales are read in the cache's own [B, Smax, KV] layout.

#include "decode_attention.cuh"

using gofr::decode::ContiguousRows;
using gofr::decode::launch;

// q/out [B, H, 128] bf16; k_cache/v_cache [B, Smax, KV, 128] int8 with
// k_scale/v_scale [B, Smax, KV] float32; lengths [B] int32; k_new/v_new
// [B, KV, 128] bf16; work: B*KV*ceil(Smax/chunk)*(H/KV)*130 floats of
// scratch; W blocks per KV head; all contiguous on the current device.
extern "C" int gofr_flash_decode_int8(const void* q, const void* kc,
                                      const void* vc, const void* ks,
                                      const void* vs, const void* lengths,
                                      const void* k_new, const void* v_new,
                                      void* out, void* work, int B, int Smax,
                                      int H, int KV, int W, int chunk,
                                      float scale, void* stream) {
  return launch<int8_t, true>(q, kc, vc, ks, vs, ContiguousRows{Smax},
                              lengths, k_new, v_new, out, work, B, H, KV, W,
                              chunk, scale, stream);
}

// The dense bf16 cache: as above without scales (ks/vs are ignored).
extern "C" int gofr_flash_decode_bf16(const void* q, const void* kc,
                                      const void* vc, const void* ks,
                                      const void* vs, const void* lengths,
                                      const void* k_new, const void* v_new,
                                      void* out, void* work, int B, int Smax,
                                      int H, int KV, int W, int chunk,
                                      float scale, void* stream) {
  return launch<__nv_bfloat16, false>(q, kc, vc, ks, vs,
                                      ContiguousRows{Smax}, lengths, k_new,
                                      v_new, out, work, B, H, KV, W, chunk,
                                      scale, stream);
}
