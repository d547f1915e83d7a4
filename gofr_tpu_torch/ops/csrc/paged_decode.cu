// Decode attention over a paged KV pool, head_dim 128, sm_90a: one
// token with this step's k/v folded in (gofr_paged_decode_*), or a
// window of Wn query positions with the window's own k/v folded in
// causally (gofr_paged_window_*, speculative decoding's verify pass).
//
// Replaces the TPU kernel gofr_tpu/ops/paged_attention.py::
// _paged_decode_cache (its pallas_call runs flash_decode's
// _decode_kernel with the K/V/scale index maps reading table[b, si])
// for both of its callers: paged_decode_attention with its jnp
// append-fold, and paged_window_attention, which flattens W*G query rows
// per KV head through the same pallas_call and then folds the W x W
// causal in-window scores in with the flash rule. The decode's
// function: q [B, H, D] against pools [N, T, KV, D] -- int8 with float32
// per-vector scales [N, T, KV], or dense bf16 -- where position t of
// slot b lives at block table[b, t / T], offset t % T, over positions <
// lengths[b], then this step's k_new / v_new [B, KV, D] join with the
// exact flash combination, so a slot of length 0 returns v_new.
//
// The window: q [B, Wn, H, D] against the same pool, then k_new / v_new
// [B, Wn, KV, D], query position w attending window positions t <= w.
//
// What bounds it on an H100: the pool stream, as for flash_decode. At
// phase paged's first decode step (24 live slots of 115-1290 tokens) one
// launch reads about 29.9 MB of int8 K/V and scales (8.9 us at 3.35
// TB/s) plus the live table words; about 4 FLOP per byte and query row.
// A window of Wn = 5 at G = 4 does 20 rows' arithmetic on CUDA cores
// (about 18 us at 67 TFLOP/s) and reads the pool once per row group of
// 8 (3 times): its bound is the bytes, its design is not there yet.
//
// Design: decode_attention.cuh's body (a split over the cache into
// chunks of 256 positions, independent of T, tile-wise softmax, a
// combine pass), shared with flash_decode.cu, so on the same K/V the two
// return the same bits; the window is the same body with Wn query
// positions read in place through the query-row policy, cut into groups
// of at most 8 rows, so at Wn = 1 it returns the decode's bits. Here the
// row of position t is table[b*MB + t/T]*T + t%T, with block ids clamped
// into [0, N) so a bad table can misread but never fault. Only positions
// < lengths[b] (clamped to MB*T) are visited, so table entries past the
// live range -- which the engine clamps to the last live block, the TPU
// kernel's DMA skip -- are never read. Scales are read in the pool's own
// [N, T, KV] layout.

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
                              v_new, out, work, B, H, KV, 1, W, chunk, scale,
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
                                      KV, 1, W, chunk, scale, stream);
}

// The verify window: q/out [B, Wn, H, 128] bf16 and k_new/v_new
// [B, Wn, KV, 128] bf16 (1 <= Wn <= 16), the pool, scales, table and
// lengths as above; work: B*KV*ceil(MB*T/chunk)*ngr*RG*130 floats, RG =
// row_group(Wn*H/KV), ngr = ceil(Wn*H/KV / RG); NB blocks per KV head.
extern "C" int gofr_paged_window_int8(const void* q, const void* kp,
                                      const void* vp, const void* ks,
                                      const void* vs, const void* table,
                                      const void* lengths, const void* k_new,
                                      const void* v_new, void* out, void* work,
                                      int B, int MB, int T, int N, int Wn,
                                      int H, int KV, int NB, int chunk,
                                      float scale, void* stream) {
  if (T <= 0 || N <= 0 || MB <= 0) return cudaErrorInvalidValue;
  const PagedRows rows{static_cast<const int*>(table), MB, T, N};
  return launch<int8_t, true>(q, kp, vp, ks, vs, rows, lengths, k_new,
                              v_new, out, work, B, H, KV, Wn, NB, chunk,
                              scale, stream);
}

// The dense bf16 pool's window: as above without scales (ignored).
extern "C" int gofr_paged_window_bf16(const void* q, const void* kp,
                                      const void* vp, const void* ks,
                                      const void* vs, const void* table,
                                      const void* lengths, const void* k_new,
                                      const void* v_new, void* out, void* work,
                                      int B, int MB, int T, int N, int Wn,
                                      int H, int KV, int NB, int chunk,
                                      float scale, void* stream) {
  if (T <= 0 || N <= 0 || MB <= 0) return cudaErrorInvalidValue;
  const PagedRows rows{static_cast<const int*>(table), MB, T, N};
  return launch<__nv_bfloat16, false>(q, kp, vp, ks, vs, rows, lengths,
                                      k_new, v_new, out, work, B, H, KV, Wn,
                                      NB, chunk, scale, stream);
}
