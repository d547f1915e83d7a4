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
// What bounds it on an H100: the pool stream, as for flash_decode. At
// phase paged's first decode step (24 live slots of 115-1290 tokens) one
// launch reads about 29.9 MB of int8 K/V and scales (8.9 us at 3.35
// TB/s) plus the live table words; about 4 FLOP per byte.
//
// Design: decode_attention.cuh's body (a split over the cache into
// chunks of 256 positions, independent of T, tile-wise softmax, a
// combine pass), shared with flash_decode.cu, so on the same K/V the two
// return the same bits. Here the row of position t is
// table[b*MB + t/T]*T + t%T, with block ids clamped into [0, N) so a bad
// table can misread but never fault. Only positions < lengths[b]
// (clamped to MB*T) are visited, so table entries past the live range --
// which the engine clamps to the last live block, the TPU kernel's DMA
// skip -- are never read. Scales are read in the pool's own [N, T, KV]
// layout.

#include "decode_attention.cuh"

using gofr::decode::launch;
using gofr::decode::PagedRows;

// q/out [B, H, 128] bf16; k_pool/v_pool [N, T, KV, 128] int8 with
// k_scale/v_scale [N, T, KV] float32; table [B, MB] int32 block ids;
// lengths [B] int32; k_new/v_new [B, KV, 128] bf16; work:
// B*KV*ceil(MB*T/chunk)*(H/KV)*130 floats of scratch; W blocks per KV
// head; all contiguous on the current device.
extern "C" int gofr_paged_decode_int8(const void* q, const void* kp,
                                      const void* vp, const void* ks,
                                      const void* vs, const void* table,
                                      const void* lengths, const void* k_new,
                                      const void* v_new, void* out, void* work,
                                      int B, int MB, int T, int N, int H,
                                      int KV, int W, int chunk, float scale,
                                      void* stream) {
  if (T <= 0 || N <= 0 || MB <= 0) return cudaErrorInvalidValue;
  const PagedRows rows{static_cast<const int*>(table), MB, T, N};
  return launch<int8_t, true>(q, kp, vp, ks, vs, rows, lengths, k_new,
                              v_new, out, work, B, H, KV, W, chunk, scale,
                              stream);
}

// The dense bf16 pool: as above without scales (ks/vs are ignored).
extern "C" int gofr_paged_decode_bf16(const void* q, const void* kp,
                                      const void* vp, const void* ks,
                                      const void* vs, const void* table,
                                      const void* lengths, const void* k_new,
                                      const void* v_new, void* out, void* work,
                                      int B, int MB, int T, int N, int H,
                                      int KV, int W, int chunk, float scale,
                                      void* stream) {
  if (T <= 0 || N <= 0 || MB <= 0) return cudaErrorInvalidValue;
  const PagedRows rows{static_cast<const int*>(table), MB, T, N};
  return launch<__nv_bfloat16, false>(q, kp, vp, ks, vs, rows,
                                      lengths, k_new, v_new, out, work, B, H,
                                      KV, W, chunk, scale, stream);
}
