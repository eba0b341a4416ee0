// K5 and K6c on Hopper: offset -> aligned VALID 2x2 packed conv + bias, kd =
// 3 with z-SAME, bf16, on TMA-fed shared memory and wgmma.
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
// Co), bias (Co), y (B, D, hp-1, w_out, Co), contiguous channels-last bf16;
// fp32 accumulation, the bias added in fp32, one rounding. Needs Ci, Co %
// 128 == 0 and w_out + 1 <= wp8.
//
// K6c. With pre (the producer deferred its instance norm) the conv reads
// xin = leaky(x * sa[b] + ta[b]) * rim_mask in place of x, computed in bf16
// with a rounding after the multiply, the add and the leaky product;
// rim_mask is the offset rim mask of the input's true width w_out + 1 (row,
// column and channel group g = c / (Ci/4), dy = g/2, dx = g%2); sa, ta are
// (B, Ci), one row per batch element; z planes outside [0, D) stay zero
// (their K steps do not run). The warpgroup that owns a slab rewrites it in
// place in shared memory once it has landed (K6cValid3::transform), while
// the wgmmas of the K step before run. A slab row is one pixel's 64
// channels, stored under the 128-byte swizzle: its logical 16-byte chunk k
// sits at physical chunk k ^ (row & 7). Thread t takes physical chunk t % 8
// of rows t / 8, t / 8 + 16, ..., whose row & 7 never changes, so its eight
// channels, and with them its sa, ta and mask group, are fixed for the K
// step. What TMA zero-filled (past row hp - 1 or column w_out) is outside
// the mask and stays zero. The rewrite is kept to few instructions (a slab
// inside the rim skips the mask; a slope in [0, 1] takes leaky as one max):
// what it costs is its 2 x 18 KB of shared-memory traffic a slab, beside
// wgmma's operand reads and TMA's writes, which already fill most of what
// shared memory can move. With stats the epilogue adds the sum and the sum
// of squares of every stored (rounded) output, per (b, z) image and channel,
// to stats (B*D, 16, Co) fp32, zeroed by the caller: rows 0:8 sum to the
// sum, rows 8:16 to the sum of squares (sm90_pipeline.cuh, store_tile_fused).
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

// named so that a profile tells K5's launches from K6c's
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

// K6c: F of FORM_PRE, FORM_STATS
template <int F>
struct K6cValid3 : Valid3 {
  static constexpr int FORM = F;
  const bf16* sa;   // (B, Ci)
  const bf16* ta;
  uint32_t slope2;  // the leaky slope, bf16, twice
  int hp, tw;       // the input's rows and true width w_out + 1
  int max_form;     // the slope lies in [0, 1]: leaky(v) = max(v, v * slope)
  StatsOut so;

  // thread t's scale and shift: it takes physical chunk t % 8 of slab rows
  // t / 8 (mod 16), which is logical chunk (t % 8) ^ (row % 8), and row % 8
  // == (t / 8) % 8 on all of them, so its 8 channels are fixed for a K step
  struct Operands {
    uint4 sv, tv;
    int grp;  // the channels' rim-mask group
  };

  __device__ __forceinline__ Operands pre_operands(int ks, int img,
                                                   int t) const {
    int z, u, tap, c0;
    decode(ks, img, z, u, tap, c0);
    const int c = c0 + 8 * ((t & 7) ^ ((t >> 3) & 7));
    const int64_t off = (int64_t)(img / nd) * ci + c;
    return Operands{__ldg(reinterpret_cast<const uint4*>(sa + off)),
                    __ldg(reinterpret_cast<const uint4*>(ta + off)),
                    c / (ci >> 2)};
  }

  template <bool MAX_FORM, bool MASKED>
  __device__ __forceinline__ void rewrite(const Operands& o, uint32_t addr,
                                          int p, int rows, int log_tw,
                                          int r_lo, int r_hi, int c_lo,
                                          int c_hi) const {
    const int tw_mask = (1 << log_tw) - 1;
    for (; p < rows; p += 16, addr += 16 * ROW_BYTES) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (!MASKED || (in_range(p >> log_tw, r_lo, r_hi) &&
                      in_range(p & tw_mask, c_lo, c_hi))) {
        v = lds128(addr);
        v.x = pre_bf16x2<MAX_FORM>(v.x, o.sv.x, o.tv.x, slope2);
        v.y = pre_bf16x2<MAX_FORM>(v.y, o.sv.y, o.tv.y, slope2);
        v.z = pre_bf16x2<MAX_FORM>(v.z, o.sv.z, o.tv.z, slope2);
        v.w = pre_bf16x2<MAX_FORM>(v.w, o.sv.w, o.tv.w, slope2);
      }
      sts128(addr, v);
    }
  }

  __device__ __forceinline__ void transform(const Operands& o, int ks,
                                            int img, int i0, int j0,
                                            uint32_t slab, int log_tw,
                                            int t) const {
    int z, u, tap, c0;
    decode(ks, img, z, u, tap, c0);
    // the slab's rows [r_lo, r_hi) and columns [c_lo, c_hi) that lie inside
    // the rim mask of this thread's channel group: input rows from i0,
    // columns from j0 + tap (rim_ok, as ranges)
    const int dy = o.grp >> 1, dx = o.grp & 1, th1 = (TILE_PIX >> log_tw) + 1;
    // (an empty range has hi == lo: a tile past the ragged edge)
    const int r_lo = max(0, 1 - dy - i0);
    const int r_hi = max(r_lo, min(th1, hp - dy - i0));
    const int c_lo = max(0, 1 - dx - (j0 + tap));
    const int c_hi = max(c_lo, min(1 << log_tw, tw - dx - (j0 + tap)));
    const bool inside = r_lo == 0 && r_hi == th1 && c_lo == 0 &&
                        c_hi == (1 << log_tw);
    const int rows = TILE_PIX + (1 << log_tw), p = t >> 3;
    const uint32_t addr = slab + p * ROW_BYTES + (t & 7) * 16;
    if (max_form) {
      if (inside)
        rewrite<true, false>(o, addr, p, rows, log_tw, 0, 0, 0, 0);
      else
        rewrite<true, true>(o, addr, p, rows, log_tw, r_lo, r_hi, c_lo,
                            c_hi);
    } else {
      rewrite<false, true>(o, addr, p, rows, log_tw, r_lo, r_hi, c_lo, c_hi);
    }
  }
};

// Conv = Valid3: K5, with its variant (cluster, stages); a K6cValid3: one
// block per cluster, `fz` carrying its operands
template <class Conv>
int launch(const void* x, const void* w, const void* b, void* y,
           const Conv& fz, int nb, int nd, int hp, int wp8, int ci, int co,
           int w_out, int cluster, int stages, int log_tw, void* stream) {
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
  Conv conv = fz;
  conv.nd = nd;
  conv.ci = ci;
  if constexpr (form_of<Conv>::value == 0)
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
// what is given. measure 1: the sums stored without atomics (stats wrong).
int launch_fused_form(const void* x, const void* w, const void* b, void* y,
                      const void* sa, const void* ta, void* stats, int nb,
                      int nd, int hp, int wp8, int ci, int co, int w_out,
                      float slope, int measure, int stages, int log_tw,
                      void* stream) {
  if ((sa == nullptr) != (ta == nullptr) || (!sa && !stats) || measure < 0 ||
      measure > 1)
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto conv) {
    conv.sa = (const bf16*)sa;
    conv.ta = (const bf16*)ta;
    conv.slope2 = bf16x2_bits(slope);
    conv.hp = hp;
    conv.tw = w_out + 1;
    conv.max_form = slope >= 0.0f && slope <= 1.0f;
    conv.so = StatsOut{(float*)stats, measure};
    return launch(x, w, b, y, conv, nb, nd, hp, wp8, ci, co, w_out, 1, stages,
                  log_tw, stream);
  };
  if (sa && stats) return run(K6cValid3<FORM_PRE | FORM_STATS>{});
  return sa ? run(K6cValid3<FORM_PRE>{}) : run(K6cValid3<FORM_STATS>{});
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
// stored without atomics, stats left wrong), ring stages (2, 3; 3 unless
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
