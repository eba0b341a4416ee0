// K5 on Hopper: offset -> aligned VALID 2x2 packed conv + bias, kd = 3 with
// z-SAME, bf16, on TMA-fed shared memory and wgmma.
//
// Replaces the TPU kernel rehrseg_tpu/ops/pallas_pconv.py pconv3_valid
// (:1117, body _valid3_kernel :930), plain form (no pre, no statistics):
//
//   y[b, z, i, j, co] = bias[co] + sum_{u < 3} sum_{s,t in {0,1}} sum_c
//                       x[b, z+u-1, i+s, j+t, c] * W[u, s, t, c, co]
//   for i in [0, hp-1), j in [0, w_out); x outside [0, D) in z is zero
//
// x (B, D, hp, wp8, Ci) offset-packed, stored wp8 wide: only its true
// columns 0..w_out are read, whatever the pad columns hold. W (3, 2, 2, Ci,
// Co), bias (Co), y (B, D, hp-1, w_out, Co), contiguous channels-last bf16;
// fp32 accumulation, the bias added in fp32, one rounding. Needs Ci, Co %
// 128 == 0 and w_out + 1 <= wp8.
//
// What bounds it on the H100: at the path's shape (8, 16, 81, 104, 256 ->
// 256) it does 1.48 TFLOP on about 1.06 GB, so the tensor-core rate bounds
// it, and what a kernel must watch is the feed from L2 into shared memory:
// with one box per tap, every 128-pixel x 128-channel product of 64
// channels needs 16 KB of input and 16 KB of weights, and L2's rate would
// cap the kernel below the tensor cores'. The design (sm90_pipeline.cuh)
// is an implicit GEMM whose A tile is a rectangle of output pixels: the
// tensor map over x is (B, D, hp, w_out + 1, Ci) with the stored row
// stride, so taps (u, 0, t) and (u, 1, t) of the tile at (b, z, i0, j0)
// are one box of TH + 1 rows at (b, z+u-1, i0, j0+t), read twice from
// shared memory; the pad columns lie outside the map and are never read,
// and a z plane outside [0, D) is a tap that is skipped (its K steps do
// not run). A block computes 256 pixels x 128 channels from the same
// weight tiles (two consumer warpgroups, 128 fp32 accumulators a thread)
// through a ring of three 72 KB stages, and K steps run with the channel
// chunk outermost, so the six (u, t) slabs of a chunk re-read the same few
// input rows while they are hot in L2. Sharing the weight tiles across a
// cluster of two blocks by multicast is a timed variant, not the default.

#include "sm90_pipeline.cuh"

namespace {

using namespace sm90;

struct Valid3 {
  int nd, ci;  // planes per batch element, input channels

  // the z taps of plane z that fall inside [0, D): u in [u_lo, u_lo + nu)
  __device__ __forceinline__ void z_taps(int img, int& z, int& u_lo,
                                         int& nu) const {
    z = img % nd;
    u_lo = z == 0 ? 1 : 0;
    nu = 3 - u_lo - (z == nd - 1 ? 1 : 0);
  }

  __device__ __forceinline__ int ksteps(int img) const {
    int z, u_lo, nu;
    z_taps(img, z, u_lo, nu);
    return (ci / BK) * 2 * nu;
  }

  // K step ks -> (z tap u, column tap t, first channel), chunk outermost
  __device__ __forceinline__ void decode(int ks, int img, int& z, int& u,
                                         int& t, int& c0) const {
    int u_lo, nu;
    z_taps(img, z, u_lo, nu);
    const int r = ks % (2 * nu);
    u = u_lo + (r >> 1);
    t = r & 1;
    c0 = (ks / (2 * nu)) * BK;
  }

  __device__ __forceinline__ void load_a(const CUtensorMap* map,
                                         const CUtensorMap*, int ks, int img,
                                         int i0, int j0, uint32_t dst,
                                         uint32_t bar) const {
    int z, u, t, c0;
    decode(ks, img, z, u, t, c0);
    tma_load_5d(dst, map, bar, c0, j0 + t, i0, z + u - 1, img / nd);
  }

  // W is (3, 2, 2, Ci, Co): tap (u, s, t) starts at row ((u*2 + s)*2 + t)*Ci
  __device__ __forceinline__ int w_row(int ks, int img, int s) const {
    int z, u, t, c0;
    decode(ks, img, z, u, t, c0);
    return ((u * 2 + s) * 2 + t) * ci + c0;
  }
};

int launch(const void* x, const void* w, const void* b, void* y, int nb,
           int nd, int hp, int wp8, int ci, int co, int w_out, int cluster,
           int stages, int log_tw, void* stream) {
  if (ci % 128 || co % 128 || w_out + 1 > wp8 || hp < 2 || w_out < 1)
    return (int)cudaErrorInvalidValue;
  TileGeo g;
  int err = make_geo(&g, nb * nd, hp - 1, w_out, w_out, co, cluster, log_tw);
  if (err) return err;
  CUtensorMap mx, mw;
  const uint64_t row = (uint64_t)wp8 * ci * 2;
  const uint64_t dims[5] = {(uint64_t)ci, (uint64_t)w_out + 1, (uint64_t)hp,
                            (uint64_t)nd, (uint64_t)nb};
  const uint64_t strides[4] = {(uint64_t)ci * 2, row, row * hp,
                               row * hp * nd};
  const uint32_t box[5] = {BK, 1u << g.log_tw, (uint32_t)g.th + 1, 1, 1};
  if ((err = make_map(&mx, x, 5, dims, strides, box))) return err;
  if ((err = make_weight_map(&mw, w, (int64_t)12 * ci, co))) return err;
  return launch_variant(cluster, stages, mx, mx, mw, Valid3{nd, ci}, g, b, y,
                        (cudaStream_t)stream);
}

}  // namespace

// K5, plain form: x (nb, nd, hp, wp8, ci), w (3, 2, 2, ci, co), b (co) -> y
// (nb, nd, hp-1, w_out, co). Returns 0, or the CUDA error of the launch (or
// of the tensor map's encoding, above 20000).
extern "C" int pconv3_valid_sm90_bf16(const void* x, const void* w,
                                      const void* b, void* y, int nb, int nd,
                                      int hp, int wp8, int ci, int co,
                                      int w_out, void* stream) {
  return launch(x, w, b, y, nb, nd, hp, wp8, ci, co, w_out, 1, 3, -1, stream);
}

// the same with the variant named: blocks per cluster (1, 2), ring stages
// (2, 3), log2 of the tile width (3..5, or -1 for the fewest tiles)
extern "C" int pconv3_valid_sm90_bf16_variant(
    const void* x, const void* w, const void* b, void* y, int nb, int nd,
    int hp, int wp8, int ci, int co, int w_out, int cluster, int stages,
    int log_tw, void* stream) {
  return launch(x, w, b, y, nb, nd, hp, wp8, ci, co, w_out, cluster, stages,
                log_tw, stream);
}
