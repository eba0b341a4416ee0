// K5 and K6c on Hopper: offset -> aligned VALID 2x2 packed conv + bias, kd =
// 3 with z-SAME, on TMA-fed shared memory and wgmma; bf16, and fp32 by
// 3xTF32 (sm90_pipeline.cuh's fp32 operand path).
//
// Replaces the TPU kernel rehrseg_tpu/ops/pallas_pconv.py pconv3_valid
// (:1117, body _valid3_kernel :930), the plain form and the deferred-norm
// forms (pre=, want_stats=, or both):
//
//   y[b, z, i, j, co] = bias[co] + sum_{u < 3} sum_{s,t in {0,1}} sum_c
//                       x[b, z+u-1, i+s, j+t, c] * W[u, s, t, c, co]
//   for i in [0, hp-1), j in [0, w_out); x outside [0, D) in z is zero
//
// x (B, D, hp, wp8, Ci) offset-packed, stored wp8 wide: only its true
// columns 0..w_out are read, whatever the pad columns hold. W (3, 2, 2, Ci,
// Co), bias (Co), y (B, D, hp-1, w_out, Co), contiguous channels-last;
// fp32 accumulation, the bias added in fp32. bf16: one rounding at the
// store; fp32: none, the products fp32-accurate (3xTF32), W given split and
// K-major (ops/pconv.py tf32x3_weights, column ((u*2 + s)*2 + t)*Ci + c).
// Needs Ci, Co % 128 == 0 and w_out + 1 <= wp8.
//
// K6c. With pre (the producer deferred its instance norm) the conv reads
// xin = leaky(x * sa[b] + ta[b]) * rim_mask in place of x, computed in x's
// type with a rounding after the multiply, the add and the leaky product;
// rim_mask is the offset rim mask of the input's true width w_out + 1 (row,
// column and channel group g = c / (Ci/4), dy = g/2, dx = g%2); sa, ta are
// (B, Ci), one row per batch element; z planes outside [0, D) stay zero
// (their K steps do not run). The warpgroup that owns a slab rewrites it in
// place in shared memory once it has landed (K6cValid3::transform, through
// sm90_pipeline.cuh's PreSlab, which K6b shares), while the wgmmas of the K
// step before run; what it costs is its 2 x 18 KB of shared-memory traffic
// a slab, beside wgmma's operand reads and TMA's writes, which already fill
// most of what shared memory can move. In fp32 the transform is applied in
// registers as each consumer thread loads A from the slab (PreF32), and the
// slab is never rewritten. With stats the epilogue adds the sum and the sum
// of squares of every stored output, per (b, z) image and channel, to stats
// (B*D, 16, Co) fp32, zeroed by the caller: rows 0:8 sum to the sum, rows
// 8:16 to the sum of squares (sm90_pipeline.cuh, store_tile_fused /
// store_tile_f32).
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
//
// In fp32 the three TF32 products bound it: 3 x 1.48 TFLOP at 495 TFLOP/s
// is 8.98 ms, against 22.1 ms at fp32's FMA rate; it moves about 2.1 GB
// (0.63 ms). A K step is 32 channels (one 128-byte row of fp32) of one (u,
// t) tap pair, a block 2 x 64 pixels x 128 channels, two 88 KB stages
// (sm90_pipeline.cuh). K = 12 Ci is three times K1's at the path's shape,
// so three times as many K steps' sums are flushed into the fp32 sums; the
// flush every K step is what keeps the tensor cores' truncating
// accumulation within the 2e-5 the kernel is held to.

#include "sm90_pipeline.cuh"

namespace {

using namespace sm90;

// The tap geometry, KC channels a K step (64 bf16, 32 fp32)
template <int KC>
struct Valid3Taps {
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
    return (ci / KC) * 2 * nu;
  }

  // K step ks -> (z tap u, column tap t, first channel), chunk outermost
  __device__ __forceinline__ void decode(int ks, int img, int& z, int& u,
                                         int& t, int& c0) const {
    int u_lo, nu;
    z_taps(img, z, u_lo, nu);
    const int r = ks % (2 * nu);
    u = u_lo + (r >> 1);
    t = r & 1;
    c0 = (ks / (2 * nu)) * KC;
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
  // (fp32: column, of the split K-major matrix)
  __device__ __forceinline__ int w_row(int ks, int img, int s) const {
    int z, u, t, c0;
    decode(ks, img, z, u, t, c0);
    return ((u * 2 + s) * 2 + t) * ci + c0;
  }
};

// named so that a profile tells K5's launches from K6c's (and fp32's from
// bf16's)
struct Valid3 : Valid3Taps<BK> {};

// K6c: F of FORM_PRE, FORM_STATS; sa, ta (B, Ci), one row per batch element
template <int F>
struct K6cValid3 : Valid3, PreSlab {
  static constexpr int FORM = F;
  StatsOut so;

  __device__ __forceinline__ Operands pre_operands(int ks, int img,
                                                   int t) const {
    int z, u, tap, c0;
    decode(ks, img, z, u, tap, c0);
    return operands(img / nd, ci, c0, t);
  }

  __device__ __forceinline__ void transform(const Operands& o, int ks,
                                            int img, int i0, int j0,
                                            uint32_t slab, int log_tw,
                                            int t) const {
    int z, u, tap, c0;
    decode(ks, img, z, u, tap, c0);
    rewrite_slab(o, i0, j0 + tap, slab, log_tw, t);
  }
};

// fp32 K5; K6c: F of FORM_PRE, FORM_STATS, the transform in registers;
// with FORM_STATS the exact high product (sm90_pipeline.cuh
// tf32x3_exact_step)
struct Valid3F32 : Valid3Taps<BK_F32> {
  static constexpr bool TF32X3 = true;
};
template <int F>
struct K6cValid3F32 : Valid3F32, PreF32 {
  static constexpr int FORM = F;
  StatsOut so;

  __device__ __forceinline__ Operands pre_operands(int ks, int img,
                                                   int t) const {
    int z, u, tap, c0;
    decode(ks, img, z, u, tap, c0);
    return operands(img / nd, ci, c0, tap, t);
  }
};

// Conv = Valid3: K5, with its variant (cluster, stages); a K6cValid3: one
// block per cluster, `fz` carrying its operands; an fp32 Conv (Valid3F32,
// K6cValid3F32): one block per cluster, two stages, w3 the third weight
// part of the forms with stats
template <class Conv>
int launch(const void* x, const void* w, const void* b, void* y,
           const Conv& fz, int nb, int nd, int hp, int wp8, int ci, int co,
           int w_out, int cluster, int stages, int log_tw, void* stream,
           const void* w3 = nullptr) {
  constexpr bool F32 = tf32x3_of<Conv>::value;
  if (ci % 128 || co % 128 || w_out + 1 > wp8 || hp < 2 || w_out < 1)
    return (int)cudaErrorInvalidValue;
  TileGeo g;
  int err = make_geo(&g, nb * nd, hp - 1, w_out, w_out, co, cluster, log_tw,
                     F32 ? TILE_PIX_F32 : TILE_PIX);
  if (err) return err;
  CUtensorMap mx, mw;
  const uint64_t px = (uint64_t)ci * sizeof(elem_of<Conv>);
  const uint64_t row = (uint64_t)wp8 * px;
  const uint64_t dims[5] = {(uint64_t)ci, (uint64_t)w_out + 1, (uint64_t)hp,
                            (uint64_t)nd, (uint64_t)nb};
  const uint64_t strides[4] = {px, row, row * hp, row * hp * nd};
  const uint32_t box[5] = {(uint32_t)(F32 ? BK_F32 : BK), 1u << g.log_tw,
                           (uint32_t)g.th + 1, 1, 1};
  if ((err = make_map(&mx, x, 5, dims, strides, box,
                      F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16)))
    return err;
  err = F32 ? make_weight_map_f32(&mw, w, (int64_t)12 * ci, co)
            : make_weight_map(&mw, w, (int64_t)12 * ci, co);
  if (err) return err;
  CUtensorMap m3;
  if (w3 && (err = make_third_map(&m3, w3, (int64_t)12 * ci, co))) return err;
  Conv conv = fz;
  conv.nd = nd;
  conv.ci = ci;
  if constexpr (F32)
    return cluster != 1 || stages != STAGES_F32
               ? (int)cudaErrorInvalidValue
               : launch_conv<Conv, 1, STAGES_F32>(mx, mx, mw, conv, g, b, y,
                                                  (cudaStream_t)stream,
                                                  w3 ? &m3 : nullptr);
  else if constexpr (form_of<Conv>::value == 0)
    return launch_variant(cluster, stages, mx, mx, mw, conv, g, b, y,
                          (cudaStream_t)stream);
  else if (cluster != 1)
    return (int)cudaErrorInvalidValue;
  else if constexpr (form_of<Conv>::value == (FORM_PRE | FORM_STATS))
    return launch_fused(stages, mx, mx, mw, conv, g, b, y,
                        (cudaStream_t)stream);
  else  // the forms the "fused" forward does not use: the default ring only
    return stages != 3 ? (int)cudaErrorInvalidValue
                       : launch_conv<Conv, 1, 3>(mx, mx, mw, conv, g, b, y,
                                                 (cudaStream_t)stream);
}

// K6c: sa, ta (both or neither) and stats may be null; the form follows from
// what is given. measure 1: the sums stored without atomics (stats wrong);
// 2 and 3: PreSlab's measuring forms (y and stats wrong).
int launch_fused_form(const void* x, const void* w, const void* b, void* y,
                      const void* sa, const void* ta, void* stats, int nb,
                      int nd, int hp, int wp8, int ci, int co, int w_out,
                      float slope, int measure, int stages, int log_tw,
                      void* stream) {
  if ((sa == nullptr) != (ta == nullptr) || (!sa && !stats) || measure < 0 ||
      measure > 3)
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto conv) {
    set_pre(conv, sa, ta, slope, hp, w_out + 1, measure);
    conv.so = StatsOut{(float*)stats, measure == 1};
    return launch(x, w, b, y, conv, nb, nd, hp, wp8, ci, co, w_out, 1, stages,
                  log_tw, stream);
  };
  if (sa && stats) return run(K6cValid3<FORM_PRE | FORM_STATS>{});
  return sa ? run(K6cValid3<FORM_PRE>{}) : run(K6cValid3<FORM_STATS>{});
}

// fp32: K5 when sa, ta and stats are null, else K6c; the form follows from
// what is given (sa and ta both or neither, stats and w3 both or neither)
int launch_f32(const void* x, const void* w, const void* w3, const void* b,
               void* y, const void* sa, const void* ta, void* stats, int nb,
               int nd, int hp, int wp8, int ci, int co, int w_out,
               float slope, void* stream) {
  if ((sa == nullptr) != (ta == nullptr) ||
      (stats == nullptr) != (w3 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!sa && !stats)
    return launch(x, w, b, y, Valid3F32{}, nb, nd, hp, wp8, ci, co, w_out, 1,
                  STAGES_F32, -1, stream);
  auto run = [&](auto conv) {
    set_pre_f32(conv, sa, ta, slope, hp, w_out + 1);
    conv.so = StatsOut{(float*)stats, 0};
    return launch(x, w, b, y, conv, nb, nd, hp, wp8, ci, co, w_out, 1,
                  STAGES_F32, -1, stream, w3);
  };
  if (sa && stats) return run(K6cValid3F32<FORM_PRE | FORM_STATS>{});
  return sa ? run(K6cValid3F32<FORM_PRE>{}) : run(K6cValid3F32<FORM_STATS>{});
}

}  // namespace

// K5, plain form: x (nb, nd, hp, wp8, ci), w (3, 2, 2, ci, co), b (co) -> y
// (nb, nd, hp-1, w_out, co). Returns 0, or the CUDA error of the launch (or
// of the tensor map's encoding, above 20000).
extern "C" int pconv3_valid_sm90_bf16(const void* x, const void* w,
                                      const void* b, void* y, int nb, int nd,
                                      int hp, int wp8, int ci, int co,
                                      int w_out, void* stream) {
  return launch(x, w, b, y, Valid3{}, nb, nd, hp, wp8, ci, co, w_out, 1, 3,
                -1, stream);
}

// the same with the variant named: blocks per cluster (1, 2), ring stages
// (2, 3), log2 of the tile width (3..5, or -1 for the fewest tiles)
extern "C" int pconv3_valid_sm90_bf16_variant(
    const void* x, const void* w, const void* b, void* y, int nb, int nd,
    int hp, int wp8, int ci, int co, int w_out, int cluster, int stages,
    int log_tw, void* stream) {
  return launch(x, w, b, y, Valid3{}, nb, nd, hp, wp8, ci, co, w_out, cluster,
                stages, log_tw, stream);
}

// K6c: the same operands and, each or both, sa, ta (nb, ci) bf16 for the pre
// transform with its leaky slope (a bf16 value), and stats (nb * nd, 16, co)
// fp32, zeroed by the caller, for the moment partials; null for the part
// that is not wanted. Returns as above.
extern "C" int pconv3_valid_fused_sm90_bf16(
    const void* x, const void* w, const void* b, void* y, const void* sa,
    const void* ta, void* stats, int nb, int nd, int hp, int wp8, int ci,
    int co, int w_out, float slope, void* stream) {
  return launch_fused_form(x, w, b, y, sa, ta, stats, nb, nd, hp, wp8, ci, co,
                           w_out, slope, 0, 3, -1, stream);
}

// the same with the variant named: a measuring form (0 none: K6c; 1 the sums
// stored without atomics, stats left wrong; with y wrong too, 2 the pre
// rewrite skipped, 3 its loads and stores alone), ring stages (2, 3; 3 unless
// both pre and stats are given), log2 of the tile width (3..5, or -1 for the
// fewest tiles)
extern "C" int pconv3_valid_fused_sm90_bf16_variant(
    const void* x, const void* w, const void* b, void* y, const void* sa,
    const void* ta, void* stats, int nb, int nd, int hp, int wp8, int ci,
    int co, int w_out, float slope, int measure, int stages, int log_tw,
    void* stream) {
  return launch_fused_form(x, w, b, y, sa, ta, stats, nb, nd, hp, wp8, ci, co,
                           w_out, slope, measure, stages, log_tw, stream);
}

// fp32 by 3xTF32: K5 (sa, ta, stats and w3 null) and K6c (sa, ta (nb, ci)
// fp32 for the pre transform with its leaky slope, and / or stats (nb * nd,
// 16, co) fp32, zeroed by the caller, with w3, as for K6b in
// pconv2d_sm90.cu): x (nb, nd, hp, wp8, ci), w the split weights (2, co, 12
// ci) fp32 and w3 the third part (12 ci, co) bf16 of ops/pconv.py
// tf32x3_weights, b (co) fp32 -> y (nb, nd, hp-1, w_out, co) fp32. Returns
// as above.
extern "C" int pconv3_valid_sm90_f32(const void* x, const void* w,
                                     const void* w3, const void* b, void* y,
                                     const void* sa, const void* ta,
                                     void* stats, int nb, int nd, int hp,
                                     int wp8, int ci, int co, int w_out,
                                     float slope, void* stream) {
  return launch_f32(x, w, w3, b, y, sa, ta, stats, nb, nd, hp, wp8, ci, co,
                    w_out, slope, stream);
}
