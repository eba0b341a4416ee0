// K1 and K6a on Hopper: fused decoder-concat + pad(1,1) packed 2x2 conv +
// bias, bf16, on TMA-fed shared memory and wgmma.
//
// Replaces the TPU kernel rehrseg_tpu/ops/pallas_pconv.py pconv_pad11_cat
// (:889, body _pad11_cat_kernel :641), the plain form and the form with
// statistics (want_stats=True: _offset_mask :625, _stats16 :600). With
// x = concat([xa, xb], -1):
//
//   y[n, i, j, co] = bias[co] + sum_{s,t in {0,1}} sum_c x[n, i+s-1, j+t-1, c]
//                                                      * W[s, t, c, co]
//   for i in [0, h], j in [0, w];  y[n, i, j, :] = 0 for j in (w, wp8)
//
// xa (N, h, w, Ca), xb (N, h, w, Cb), W (2, 2, Ca+Cb, Co), bias (Co), y
// (N, h+1, wp8, Co), contiguous channels-last bf16; x outside the image is
// zero; fp32 accumulation, the bias added in fp32, one rounding. Needs Ca,
// Cb, Co % 128 == 0.
//
// K6a, the producer of pallas_conv="fused", is the same conv whose epilogue
// zeroes the rounded output by the FULL offset rim mask (row, column and
// channel group g = co / (Co/4), dy = g/2, dx = g%2, over h+1 rows and the
// true width w+1: ops/pack2d.py offset_rim_mask), not only the columns > w,
// and adds the sum and the sum of squares of every stored value, per image
// and channel, to stats (N, 16, Co) fp32, zeroed by the caller: rows 0:8 sum
// to the sum, rows 8:16 to the sum of squares (sm90_pipeline.cuh,
// store_tile_fused: summed per tile in registers, by shuffles and in shared
// memory, then one vector red per four channels, kind and tile).
//
// What bounds it on the H100: at the served shape (N 128, h 160, w 192,
// Ca = Cb = Co = 128) it does 1.04 TFLOP and must move 3.07 GB (0.92 ms at
// the memory rate), so the tensor cores bound it, just; with K only 1024
// deep the feed from L2 into shared memory matters more: with one box per
// tap, L2's rate caps the kernel below the tensor cores'. The design
// (sm90_pipeline.cuh) is an implicit GEMM whose A tile is a rectangle of
// output pixels: xa and xb each get a tensor map over (N, h, w, C), and
// taps (0, t) and (1, t) of the tile at (n, i0, j0) are one box of TH + 1
// rows at (n, i0-1, j0+t-1) of xa (channel chunks below Ca) or of xb (the
// rest), read twice from shared memory: the concatenated tensor never
// exists, and the pad(1, 1) rim is the hardware's zero fill for
// coordinates outside the map. Output columns > w see only zero-filled
// input; the epilogue stores them as exact zeros, without the bias. A
// block computes 256 pixels x 128 channels from the same weight tiles
// through a ring of three 72 KB stages, and the two column taps of a
// channel chunk run back to back, so they re-read the same input rows
// while they are hot in L2. Sharing the weight tiles across a cluster of
// two blocks by multicast is a timed variant, not the default.

#include "sm90_pipeline.cuh"

namespace {

using namespace sm90;

// named so that a profile tells K1's launches from K6a's
struct Pad11Cat {
  int ca, cb;

  __device__ __forceinline__ int ksteps(int) const {
    return 2 * ((ca + cb) / BK);
  }

  // K step ks: column tap t = ks % 2 of channel chunk ks / 2
  __device__ __forceinline__ void load_a(const CUtensorMap* map_a,
                                         const CUtensorMap* map_b, int ks,
                                         int img, int i0, int j0,
                                         uint32_t dst, uint32_t bar) const {
    const int c0 = (ks >> 1) * BK;
    const int jj = j0 + (ks & 1) - 1, ii = i0 - 1;
    if (c0 < ca)
      tma_load_4d(dst, map_a, bar, c0, jj, ii, img);
    else
      tma_load_4d(dst, map_b, bar, c0 - ca, jj, ii, img);
  }

  // W is (2, 2, Ca+Cb, Co): tap (s, t) starts at row (s*2 + t)*(Ca+Cb)
  __device__ __forceinline__ int w_row(int ks, int, int s) const {
    return (s * 2 + (ks & 1)) * (ca + cb) + (ks >> 1) * BK;
  }
};

// K6a: FORM_STATS | FORM_RIM; FORM_RIM alone is a measuring form (what the
// statistics cost)
template <int F>
struct K6aPad11Cat : Pad11Cat {
  static constexpr int FORM = F;
  StatsOut so;
};

// Conv = Pad11Cat: K1, with its variant (cluster, stages); a K6aPad11Cat:
// one block per cluster, the sums going to `so`
template <class Conv>
int launch(const void* xa, const void* xb, const void* w, const void* b,
           void* y, StatsOut so, int n, int h, int w_in, int ca, int cb,
           int co, int wp8, int cluster, int stages, int log_tw,
           void* stream) {
  if (ca % 128 || cb % 128 || co % 128 || ca < 128 || cb < 128 ||
      wp8 < w_in + 1 || h < 1 || w_in < 1)
    return (int)cudaErrorInvalidValue;
  TileGeo g;
  int err = make_geo(&g, n, h + 1, wp8, w_in + 1, co, cluster, log_tw);
  if (err) return err;
  CUtensorMap ma, mb, mw;
  const uint32_t box[4] = {BK, 1u << g.log_tw, (uint32_t)g.th + 1, 1};
  const void* src[2] = {xa, xb};
  const int chan[2] = {ca, cb};
  CUtensorMap* maps[2] = {&ma, &mb};
  for (int k = 0; k < 2; ++k) {
    const uint64_t px = (uint64_t)chan[k] * 2;
    const uint64_t dims[4] = {(uint64_t)chan[k], (uint64_t)w_in, (uint64_t)h,
                              (uint64_t)n};
    const uint64_t strides[3] = {px, px * w_in, px * w_in * h};
    if ((err = make_map(maps[k], src[k], 4, dims, strides, box))) return err;
  }
  if ((err = make_weight_map(&mw, w, (int64_t)4 * (ca + cb), co))) return err;
  Conv conv;
  conv.ca = ca;
  conv.cb = cb;
  if constexpr (form_of<Conv>::value == 0) {
    return launch_variant(cluster, stages, ma, mb, mw, conv, g, b, y,
                          (cudaStream_t)stream);
  } else {
    conv.so = so;
    if (cluster != 1) return (int)cudaErrorInvalidValue;
    if constexpr ((form_of<Conv>::value & FORM_STATS) != 0)
      return launch_fused(stages, ma, mb, mw, conv, g, b, y,
                          (cudaStream_t)stream);
    else  // the measuring form: the default ring only
      return stages != 3 ? (int)cudaErrorInvalidValue
                         : launch_conv<Conv, 1, 3>(ma, mb, mw, conv, g, b, y,
                                                   (cudaStream_t)stream);
  }
}

// K6a (measure 0) and its measuring forms, which leave stats wrong: 1 the
// sums stored without atomics, 2 the rim mask alone (nothing is summed)
int launch_stats(const void* xa, const void* xb, const void* w,
                 const void* b, void* y, void* stats, int n, int h, int w_in,
                 int ca, int cb, int co, int wp8, int measure, int stages,
                 int log_tw, void* stream) {
  if (!stats || measure < 0 || measure > 2) return (int)cudaErrorInvalidValue;
  const StatsOut so{(float*)stats, measure == 1};
  if (measure == 2)
    return launch<K6aPad11Cat<FORM_RIM>>(xa, xb, w, b, y, so, n, h, w_in, ca,
                                         cb, co, wp8, 1, stages, log_tw,
                                         stream);
  return launch<K6aPad11Cat<FORM_STATS | FORM_RIM>>(
      xa, xb, w, b, y, so, n, h, w_in, ca, cb, co, wp8, 1, stages, log_tw,
      stream);
}

}  // namespace

// K1, plain form: xa (n, h, w_in, ca), xb (n, h, w_in, cb), w (2, 2, ca+cb,
// co), b (co) -> y (n, h+1, wp8, co). Returns 0, or the CUDA error of the
// launch (or of the tensor map's encoding, above 20000).
extern "C" int pconv_pad11_cat_sm90_bf16(const void* xa, const void* xb,
                                         const void* w, const void* b,
                                         void* y, int n, int h, int w_in,
                                         int ca, int cb, int co, int wp8,
                                         void* stream) {
  return launch<Pad11Cat>(xa, xb, w, b, y, StatsOut{}, n, h, w_in, ca, cb, co,
                          wp8, 1, 3, -1, stream);
}

// the same with the variant named: blocks per cluster (1, 2), ring stages
// (2, 3), log2 of the tile width (3..5, or -1 for the fewest tiles)
extern "C" int pconv_pad11_cat_sm90_bf16_variant(
    const void* xa, const void* xb, const void* w, const void* b, void* y,
    int n, int h, int w_in, int ca, int cb, int co, int wp8, int cluster,
    int stages, int log_tw, void* stream) {
  return launch<Pad11Cat>(xa, xb, w, b, y, StatsOut{}, n, h, w_in, ca, cb, co,
                          wp8, cluster, stages, log_tw, stream);
}

// K6a: the same operands and stats (n, 16, co) fp32, zeroed by the caller ->
// y with the full offset rim mask, and the moment partials added to stats.
// Returns as above.
extern "C" int pconv_pad11_cat_stats_sm90_bf16(
    const void* xa, const void* xb, const void* w, const void* b, void* y,
    void* stats, int n, int h, int w_in, int ca, int cb, int co, int wp8,
    void* stream) {
  return launch_stats(xa, xb, w, b, y, stats, n, h, w_in, ca, cb, co, wp8, 0,
                      3, -1, stream);
}

// the same with the variant named: a measuring form (0 none: K6a; with stats
// left wrong, 1 the sums stored without atomics, 2 the rim mask alone), ring
// stages (2, 3; 3 for the rim mask alone), log2 of the tile width (3..5, or
// -1 for the fewest tiles)
extern "C" int pconv_pad11_cat_stats_sm90_bf16_variant(
    const void* xa, const void* xb, const void* w, const void* b, void* y,
    void* stats, int n, int h, int w_in, int ca, int cb, int co, int wp8,
    int measure, int stages, int log_tw, void* stream) {
  return launch_stats(xa, xb, w, b, y, stats, n, h, w_in, ca, cb, co, wp8,
                      measure, stages, log_tw, stream);
}
