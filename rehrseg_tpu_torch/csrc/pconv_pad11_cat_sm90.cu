// K1 on Hopper: fused decoder-concat + pad(1,1) packed 2x2 conv + bias,
// bf16, on TMA-fed shared memory and wgmma.
//
// Replaces the TPU kernel rehrseg_tpu/ops/pallas_pconv.py pconv_pad11_cat
// (:889, body _pad11_cat_kernel :641), plain form (no statistics). With
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

int launch(const void* xa, const void* xb, const void* w, const void* b,
           void* y, int n, int h, int w_in, int ca, int cb, int co, int wp8,
           int cluster, int stages, int log_tw, void* stream) {
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
  return launch_variant(cluster, stages, ma, mb, mw, Pad11Cat{ca, cb}, g, b,
                        y, (cudaStream_t)stream);
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
  return launch(xa, xb, w, b, y, n, h, w_in, ca, cb, co, wp8, 1, 3, -1,
                stream);
}

// the same with the variant named: blocks per cluster (1, 2), ring stages
// (2, 3), log2 of the tile width (3..5, or -1 for the fewest tiles)
extern "C" int pconv_pad11_cat_sm90_bf16_variant(
    const void* xa, const void* xb, const void* w, const void* b, void* y,
    int n, int h, int w_in, int ca, int cb, int co, int wp8, int cluster,
    int stages, int log_tw, void* stream) {
  return launch(xa, xb, w, b, y, n, h, w_in, ca, cb, co, wp8, cluster,
                stages, log_tw, stream);
}
