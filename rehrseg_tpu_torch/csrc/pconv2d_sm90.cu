// K4, K3, K7 and K6b on Hopper: the kd = 1 packed 2x2 convs + bias on one
// input, on TMA-fed shared memory and wgmma: bf16 with the whole weight
// tensor resident in shared memory, and K3, K7 and K6b in fp32 by 3xTF32
// (fp32 K4 is pconv_pad11_cat_sm90.cu's).
//
// Replaces the TPU kernels of rehrseg_tpu/ops/pallas_pconv.py pconv_pad11
// (:576, body _pad11_kernel :272; K4) and pconv_valid (:519, body
// _valid_kernel :75; K3; the deferred-norm forms, body _valid_fused_kernel
// :148; K6b), and of rehrseg_tpu/ops/pallas_conv.py conv2x2_valid_bias
// (:126, body _kernel :34; K7), which is K3's function on an input stored
// at its exact width:
//
//   K4  y[n, i, j, co] = bias[co] + sum_{s,t in {0,1}} sum_c
//                        x[n, i+s-1, j+t-1, c] * W[s, t, c, co]
//       for i in [0, h], j in [0, w]; x outside the image is zero;
//       y[n, i, j, :] = 0 (no bias) for j in (w, wp8)
//       x (N, h, w, Ci) aligned -> y (N, h+1, wp8, Co) offset
//   K3  y[n, i, j, co] = bias[co] + sum_{s,t} sum_c x[n, i+s, j+t, c]
//                                                   * W[s, t, c, co]
//       for i in [0, hp-1), j in [0, w_out)
//       x (N, hp, wp8, Ci) offset, stored wp8 >= w_out + 1 wide: only its
//       columns 0..w_out are read, whatever the others hold
//       -> y (N, hp-1, w_out, Co) aligned
//
// W (2, 2, Ci, Co), bias (Co), contiguous channels-last; fp32
// accumulation, the bias added in fp32. bf16: one rounding at the store;
// fp32: none, the products fp32-accurate (3xTF32), W given split and
// K-major (ops/pconv.py tf32x3_weights). Needs Ci, Co % 128 == 0 (so every
// row of channels is a multiple of 16 bytes, whatever the width: K7's odd
// widths need nothing more).
//
// K6b is K3 with either or both of sm90_pipeline.cuh's deferred-norm parts
// (K6bValid2): with pre the conv reads leaky(x * sa[n] + ta[n]) * rim_mask
// (sa, ta (N, Ci), one row per image; rim_mask of the input's true width
// w_out + 1), each slab rewritten in shared memory by the warpgroup that
// reads it; with stats the epilogue adds the sum and the sum of squares of
// every stored (rounded) output to stats (N, 16, Co) fp32, zeroed by the
// caller, from 4 KB of scratch a warpgroup past the barriers.
//
// What bounds them on the H100: at the path's shapes (N 128, 160 x 192
// output pixels, Ci = Co = 128; K6b's the same) each does 0.52 TFLOP on
// about 2.03 GB, so the memory rate bounds it, just, and the tensor cores
// are two thirds busy at that rate: input and output must stream at nearly
// the memory rate and nothing may stall either. K is only 4 * Ci = 512
// deep, so a kernel that streams its weights with the input
// (sm90_pipeline.cuh's conv_wgmma_kernel) reads the whole 128 KB weight
// tensor from L2 again for every pair of tiles, as many bytes as the input
// itself, and its epilogue, as long here as a tile's four K steps, leaves
// the tensor cores idle. The design here (conv_resident_kernel):
//
// - The weights are resident. A persistent block keeps one block of 128
//   output channels: its producer thread loads the (4 Ci, 128) weight tile
//   once, by TMA, as 4 Ci / 64 tiles of 64 k-rows in wgmma's N-major
//   swizzled layout (128 KB at Ci = 128), and no K step loads weights.
// - The ring holds single input slabs. A stage is one slab of TH + 1 image
//   rows x TW pixels x 64 channels (at most 20 KB; both row taps read it,
//   as in sm90_pipeline.cuh); the two consumer warpgroups share one ring,
//   four deep (up to five fit beside the weights), and each slab is read by
//   one warpgroup only. A stage has one empty mbarrier and a full mbarrier per
//   warpgroup: a waiter can tell a barrier's phase only from the one before
//   it, so each barrier must have one waiter that sees every phase, and a
//   warpgroup sees only the rounds of a stage that carry its own slabs.
// - The store overlaps the next tile. A block's tiles go to its two
//   consumer warpgroups in turn, and the producer fills the ring tile after
//   tile: while one warpgroup adds the bias and stores its 128 x 128 tile
//   from registers, the slabs that land are the other's, whose wgmmas keep
//   the tensor cores busy. The ring's order is what orders the two (a
//   warpgroup cannot start before its slabs land, and they land after the
//   other's), so no named barrier is needed. The timed variant without the
//   overlap fills the ring K step by K step for both warpgroups' tiles, so
//   that both compute and then both store.
//
// A tile is a rectangle of 128 output pixels, so a tap is one TMA box: K4's
// map is (N, h, w, Ci) and its box sits at (i0 - 1, j0 + t - 1), the pad
// rim being the hardware's zero fill; K3's map is (N, hp, w_out + 1, Ci)
// with the stored row pitch, its box at (i0, j0 + t): the pad columns lie
// outside the map and are never read. Blocks running at one time work on
// neighbouring tiles (and, with several channel blocks, on the same tile),
// so the rows and columns their boxes share are hot in L2.
//
// Where the weights leave no room for the ring (Ci >= 256: 256 KB), the
// same geometry runs sm90_pipeline.cuh's streamed-weights kernel, which is
// also the first timed variant.
//
// fp32 K3, K7 and K6b (Valid2F32, K6bValid2F32) run that streamed kernel
// on its fp32 operand path (sm90_pipeline.cuh: 3xTF32, 32 channels a K
// step, the K6b transform applied to A in registers): split into W_hi and
// W_lo, the weights are 512 KB at Ci = 128 and cannot stay resident. The
// three TF32 products bound them: 3 x 0.515 TFLOP at 495 TFLOP/s is 3.12
// ms at the path's shape, against 7.7 ms at fp32's FMA rate; they move
// about 4.1 GB (1.23 ms).

#include "sm90_pipeline.cuh"

namespace {

using namespace sm90;

// The taps of a 2x2 conv on one input. K step ks is column tap t = ks % 2
// of channel chunk ks / 2 (KC channels: 64 bf16, 32 fp32), both row taps
// (the two column taps of a chunk run back to back and re-read the same
// rows while they are hot in L2); OFF is the coordinate of tap 0 against
// the output pixel: -1 with the pad(1, 1) rim (K4), 0 for VALID (K3, K7).
template <int OFF, int KC = BK>
struct Taps {
  int ci;

  __device__ __forceinline__ int ksteps(int) const { return 2 * (ci / KC); }

  __device__ __forceinline__ void load_a(const CUtensorMap* map,
                                         const CUtensorMap*, int ks, int img,
                                         int i0, int j0, uint32_t dst,
                                         uint32_t bar) const {
    tma_load_4d(dst, map, bar, (ks >> 1) * KC, j0 + (ks & 1) + OFF, i0 + OFF,
                img);
  }

  // W is (2, 2, Ci, Co): tap (s, t) starts at row (s*2 + t)*Ci (fp32:
  // column, of the split K-major matrix)
  __device__ __forceinline__ int w_row(int ks, int, int s) const {
    return (s * 2 + (ks & 1)) * ci + (ks >> 1) * KC;
  }
};

// named so that a profile tells K4's launches from K3's (and fp32's from
// bf16's)
struct Pad11 : Taps<-1> {};
struct Valid2 : Taps<0> {};
struct Valid2F32 : Taps<0, BK_F32> {
  static constexpr bool TF32X3 = true;
};

// K6b: F of FORM_PRE, FORM_STATS; K3's taps on leaky(x * sa + ta) *
// rim_mask, sa, ta (N, Ci), one row per image
template <int F>
struct K6bValid2 : Valid2, PreSlab {
  static constexpr int FORM = F;
  StatsOut so;

  // K step ks is column tap ks % 2 of channel chunk ks / 2 (Taps::load_a)
  __device__ __forceinline__ Operands pre_operands(int ks, int img,
                                                   int t) const {
    return operands(img, ci, (ks >> 1) * BK, t);
  }

  __device__ __forceinline__ void transform(const Operands& o, int ks, int,
                                            int i0, int j0, uint32_t slab,
                                            int log_tw, int t) const {
    rewrite_slab(o, i0, j0 + (ks & 1), slab, log_tw, t);
  }
};

// fp32 K6b: F of FORM_PRE, FORM_STATS, the transform in registers; with
// FORM_STATS the exact high product (sm90_pipeline.cuh
// tf32x3_exact_step)
template <int F>
struct K6bValid2F32 : Valid2F32, PreF32 {
  static constexpr int FORM = F;
  StatsOut so;

  __device__ __forceinline__ Operands pre_operands(int ks, int img,
                                                   int t) const {
    return operands(img, ci, (ks >> 1) * BK_F32, ks & 1, t);
  }
};

constexpr int MAX_SMEM = 232448;   // what a block may ask for on sm_90
constexpr int MAX_STAGES = 5;
// the default ring depth: four and five stages time the same (a third costs
// 4 %), and four fit beside the weights at every tile width, with or
// without the statistics' scratch
constexpr int DEFAULT_STAGES = 4;

// the barriers' bytes: per stage a full one for each warpgroup and an empty
// one, then the weights'
__host__ __device__ constexpr int barrier_bytes(int stages) {
  return (3 * stages + 1) * 8;
}

// the offset of FORM_STATS's scratch from the barriers: past them, on the
// 16-byte boundary its vector loads and stores need
__host__ __device__ constexpr int scratch_offset(int stages) {
  return (barrier_bytes(stages) + 15) & ~15;
}

// 1024 bytes of slack to align, the weights, the ring, then the barriers
// and, for FORM_STATS, the two consumer warpgroups' 4 KB of scratch
constexpr int resident_smem(int ci, int stages, int log_tw, int form) {
  return 1024 + 4 * ci * BN * 2 +
         stages * (A_BOX_BYTES + (ROW_BYTES << log_tw)) +
         ((form & FORM_STATS) ? scratch_offset(stages) + STATS_SCRATCH_BYTES
                              : barrier_bytes(stages));
}

// A block's tiles are numbered lane, lane + lanes, ... over all images
// (lane = blockIdx / n_blocks; the block's channel block is blockIdx %
// n_blocks), and its k-th tile goes to consumer warpgroup k % 2. The ring's
// slots are filled in the order `alternate` names: tile after tile (slot
// k * ks_n + ks), or, without the overlap, K step by K step for a pair of
// tiles (slot ((k / 2) * ks_n + ks) * 2 + k % 2; an odd tile count is
// rounded up by a tile past the last, computed on zero fill, not stored).
//
// A deferred-norm Conv (K6b) adds sm90_pipeline.cuh's parts: FORM_PRE, the
// warpgroup that reads a slab rewrites it after its full-barrier wait
// (land_and_transform, on the warpgroup's named barrier 1 + wg); FORM_STATS,
// store_tile_fused with the warpgroup's 4 KB of scratch past the barriers.
// The tile past the last has no image: its operands are image 0's, and it
// neither stores nor sums.
template <class Conv>
__global__ void __launch_bounds__(THREADS, 1)
conv_resident_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_w,
                     const Conv conv, const TileGeo g, const int stages,
                     const int alternate, const bf16* __restrict__ bias,
                     bf16* __restrict__ y) {
  constexpr int FORM = form_of<Conv>::value;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align everything to it
  const uint32_t wres = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int ks_n = conv.ksteps(0);
  // 4 Ci k-rows = 2 * ks_n tiles of 64 k-rows x 128 channels
  const uint32_t w_bytes = (uint32_t)(2 * ks_n) * B_TAP_BYTES;
  // bytes of one slab's box, and the offset of row tap 1 within it
  const uint32_t tap_shift = (uint32_t)ROW_BYTES << g.log_tw;
  const uint32_t slab_bytes = A_BOX_BYTES + tap_shift;
  const uint32_t ring = wres + w_bytes;
  const uint32_t bars = ring + (uint32_t)stages * slab_bytes;
  // full(w, s): stage s holds a slab of warpgroup w
  auto full = [&](int w, int s) { return bars + 8u * (w * stages + s); };
  auto empty = [&](int s) { return bars + 8u * (2 * stages + s); };
  const uint32_t wbar = bars + 24u * stages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(0, s), 1);  // the producer's expect_tx
      mbar_init(full(1, s), 1);
      mbar_init(empty(s), 4);    // the warps of the one warpgroup that reads
    }
    mbar_init(wbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int n0 = (int)(blockIdx.x % g.n_blocks) * BN;
  const int lane_b = blockIdx.x / g.n_blocks;
  const int lanes = gridDim.x / g.n_blocks;
  const int tiles_per_img = ((g.out_h + g.th - 1) / g.th) * g.tiles_w;
  const int64_t total = (int64_t)g.n_img * tiles_per_img;
  const int n_mine =
      lane_b < total ? (int)((total - lane_b + lanes - 1) / lanes) : 0;
  const int n_k = alternate ? n_mine : (n_mine + 1) & ~1;
  // the block's k-th tile: image and first output pixel
  auto locate = [&](int k, int& img, int& i0, int& j0) {
    const int64_t t = lane_b + (int64_t)k * lanes;
    const int r = (int)(t % tiles_per_img);
    img = (int)(t / tiles_per_img);
    i0 = (r / g.tiles_w) * g.th;
    j0 = (r % g.tiles_w) << g.log_tw;
    return t < total;
  };

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    reg_dealloc<56>();
    if (tid == 256) {
      mbar_expect_tx(wbar, w_bytes);
      for (int kb = 0; kb < 2 * ks_n; ++kb) {
        const uint32_t st = wres + (uint32_t)kb * B_TAP_BYTES;
        tma_load_2d(st, &map_w, wbar, n0, kb * BK);
        tma_load_2d(st + B_HALF_BYTES, &map_w, wbar, n0 + 64, kb * BK);
      }
      const int group = alternate ? 1 : 2;
      int stage = 0;
      uint32_t phase = 0;
      for (int k0 = 0; k0 < n_k; k0 += group) {
        int img[2], i0[2], j0[2];
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (u < group) locate(k0 + u, img[u], i0[u], j0[u]);
        for (int ks = 0; ks < ks_n; ++ks) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (u < group) {
              const uint32_t bar = full((k0 + u) & 1, stage);
              mbar_wait(empty(stage), phase ^ 1u);
              mbar_expect_tx(bar, slab_bytes);
              conv.load_a(&map_a, &map_a, ks, img[u], i0[u], j0[u],
                          ring + (uint32_t)stage * slab_bytes, bar);
              if (++stage == stages) { stage = 0; phase ^= 1u; }
            }
          }
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    reg_alloc<224>();
    const int warp = (tid % 128) / 32, lane = tid % 32;
    float acc[2][64];
    // bit s: the parity of this warpgroup's next wait on its full barrier
    // of stage s (its own count of the slabs it has had there)
    uint32_t seen = 0;
    mbar_wait(wbar, 0);
    for (int k = wg; k < n_k; k += 2) {
      int img, i0, j0;
      const bool valid = locate(k, img, i0, j0);
      int prev = 0;
      for (int ks = 0; ks < ks_n; ++ks) {
        const int slot =
            alternate ? k * ks_n + ks : ((k >> 1) * ks_n + ks) * 2 + (k & 1);
        const int stage = slot % stages;
        const uint32_t parity = (seen >> stage) & 1u;
        seen ^= 1u << stage;
        const uint32_t sa = ring + (uint32_t)stage * slab_bytes;
        if constexpr ((FORM & FORM_PRE) != 0)
          land_and_transform(conv, ks, valid ? img : 0, i0, j0,
                             full(wg, stage), parity, sa, g.log_tw, wg,
                             tid % 128);
        else
          mbar_wait(full(wg, stage), parity);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const uint32_t sb =
              wres + (uint32_t)(conv.w_row(ks, img, s) / BK) * B_TAP_BYTES;
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            // 16 channels on: 32 bytes along A's rows, 16 k-rows down B
            const uint64_t db = desc_at(DESC_B, sb + kk * 16 * 128);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
              wgmma_m64n128k16(
                  acc[mi],
                  desc_at(DESC_A, sa + s * tap_shift + mi * 64 * ROW_BYTES +
                                      kk * 32),
                  db, (ks | s | kk) != 0);
          }
        }
        wgmma_commit();
        if (ks > 0) {  // the step before has been read: hand its stage back
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty(prev));
        }
        prev = stage;
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty(prev));
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      if constexpr ((FORM & (FORM_STATS | FORM_RIM)) != 0) {
        // valid is the same for the whole warpgroup: its named barrier
        // inside is met by all 128 threads or by none
        if (valid)
          store_tile_fused<FORM>(
              acc, g, img, i0, j0, n0, lane_b + k * lanes, bias, y, conv.so,
              bars + scratch_offset(stages) + wg * 4096u, 1 + wg, warp, lane);
      } else {
        store_tile(acc, g, img, i0, j0, n0, valid, bias, y, warp, lane);
      }
    }
  }
}

template <class Conv>
int launch_resident(const CUtensorMap& ma, const CUtensorMap& mw,
                    const Conv& conv, const TileGeo& g, int stages,
                    int alternate, const void* bias, void* y,
                    cudaStream_t stream) {
  auto kern = conv_resident_kernel<Conv>;
  const int smem =
      resident_smem(conv.ci, stages, g.log_tw, form_of<Conv>::value);
  // in step, each warpgroup holds a slab while it waits for its next
  if (stages < (alternate ? 2 : 3) || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles =
      (int64_t)g.n_img * ((g.out_h + g.th - 1) / g.th) * g.tiles_w;
  // a block's slot numbers stay below tiles * K steps
  if (tiles * (conv.ci / 32) >= (1ll << 31)) return ERR_TOO_LARGE;
  if (tiles < 1) return 0;  // nothing to compute
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int64_t lanes = sm_count() / g.n_blocks;
  if (lanes < 1) lanes = 1;
  if (lanes > tiles) lanes = tiles;
  kern<<<(unsigned)(lanes * g.n_blocks), THREADS, smem, stream>>>(
      ma, mw, conv, g, stages, alternate, (const bf16*)bias, (bf16*)y);
  return (int)cudaGetLastError();
}

// The variants: mode 0 streams the weights with the input (sm90_pipeline's
// kernel, three stages); 1 keeps them resident and fills the ring for both
// warpgroups' tiles K step by K step (no overlapped store); 2 keeps them
// resident and fills it tile after tile (the store overlaps the other
// warpgroup's wgmmas); -1 is 2 where the weights leave room for a ring, else
// 0. stages: the resident ring's depth (up to MAX_STAGES where they fit), 0
// for DEFAULT_STAGES or the deepest below it that fits. log_tw: log2 of the
// tile width (3..5), -1 for the fewest tiles.
//
// x is read through a map of (n, map_h, map_w, ci) whose rows are pitch_w
// pixels apart; y is (n, out_h, out_w, co), its columns >= live_w zeros.
// proto carries a deferred-norm form's operands.
template <class Conv>
int launch(const Conv& proto, const void* x, const void* w, const void* b,
           void* y, int n, int map_h, int map_w, int pitch_w, int ci, int co,
           int out_h, int out_w, int live_w, int mode, int stages, int log_tw,
           void* stream) {
  if (ci % 128 || co % 128 || ci < 128 || co < 128 || n < 1 || map_h < 1 ||
      map_w < 1 || pitch_w < map_w || out_h < 1 || out_w < 1 || mode > 2)
    return (int)cudaErrorInvalidValue;
  TileGeo g;
  int err = make_geo(&g, n, out_h, out_w, live_w, co, 1, log_tw);
  if (err) return err;
  CUtensorMap mx, mw;
  const uint64_t px = (uint64_t)ci * 2;
  const uint64_t dims[4] = {(uint64_t)ci, (uint64_t)map_w, (uint64_t)map_h,
                            (uint64_t)n};
  const uint64_t strides[3] = {px, px * pitch_w, px * pitch_w * map_h};
  const uint32_t box[4] = {BK, 1u << g.log_tw, (uint32_t)g.th + 1, 1};
  if ((err = make_map(&mx, x, 4, dims, strides, box))) return err;
  if ((err = make_weight_map(&mw, w, (int64_t)4 * ci, co))) return err;
  Conv conv = proto;
  conv.ci = ci;
  if (stages > MAX_STAGES) return (int)cudaErrorInvalidValue;
  int fit = stages > 0 ? stages : DEFAULT_STAGES;
  while (fit >= 2 &&
         resident_smem(ci, fit, g.log_tw, form_of<Conv>::value) > MAX_SMEM)
    --fit;
  if (mode < 0) mode = fit >= 2 ? 2 : 0;
  if (mode == 0)
    return stages > 0 && stages != 3
               ? (int)cudaErrorInvalidValue
               : launch_conv<Conv, 1, 3>(mx, mx, mw, conv, g, b, y,
                                         (cudaStream_t)stream);
  if (stages > 0 && fit != stages) return (int)cudaErrorInvalidValue;
  return launch_resident(mx, mw, conv, g, fit, mode == 2, b, y,
                         (cudaStream_t)stream);
}

// K6b: sa, ta (both or neither) and stats may be null; the form follows from
// what is given. measure 1: the sums stored without atomics (stats wrong);
// 2 and 3: PreSlab's measuring forms (y and stats wrong).
int launch_k6b(const void* x, const void* w, const void* b, void* y,
               const void* sa, const void* ta, void* stats, int n, int hp,
               int wp8, int ci, int co, int w_out, float slope, int measure,
               int mode, int stages, int log_tw, void* stream) {
  if (hp < 2 || (sa == nullptr) != (ta == nullptr) || (!sa && !stats) ||
      measure < 0 || measure > 3)
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto conv) {
    set_pre(conv, sa, ta, slope, hp, w_out + 1, measure);
    conv.so = StatsOut{(float*)stats, measure == 1};
    return launch(conv, x, w, b, y, n, hp, w_out + 1, wp8, ci, co, hp - 1,
                  w_out, w_out, mode, stages, log_tw, stream);
  };
  if (sa && stats) return run(K6bValid2<FORM_PRE | FORM_STATS>{});
  return sa ? run(K6bValid2<FORM_PRE>{}) : run(K6bValid2<FORM_STATS>{});
}

// fp32 (3xTF32) on the streamed kernel: x read as for launch (a map of (n,
// map_h, map_w, ci) with rows pitch_w pixels apart), w the split weights
// (2, co, 4 ci) and, for the forms with stats, w3 their bf16 third part (4
// ci, co), y (n, out_h, out_w, co) fp32
template <class Conv>
int launch_f32(const Conv& proto, const void* x, const void* w,
               const void* w3, const void* b, void* y, int n, int map_h,
               int map_w, int pitch_w, int ci, int co, int out_h, int out_w,
               void* stream) {
  if (ci % 128 || co % 128 || ci < 128 || co < 128 || n < 1 || map_h < 1 ||
      map_w < 1 || pitch_w < map_w || out_h < 1 || out_w < 1)
    return (int)cudaErrorInvalidValue;
  TileGeo g;
  int err = make_geo(&g, n, out_h, out_w, out_w, co, 1, -1, TILE_PIX_F32);
  if (err) return err;
  CUtensorMap mx, mw;
  const uint64_t px = (uint64_t)ci * 4;
  const uint64_t dims[4] = {(uint64_t)ci, (uint64_t)map_w, (uint64_t)map_h,
                            (uint64_t)n};
  const uint64_t strides[3] = {px, px * pitch_w, px * pitch_w * map_h};
  const uint32_t box[4] = {BK_F32, 1u << g.log_tw, (uint32_t)g.th + 1, 1};
  if ((err = make_map(&mx, x, 4, dims, strides, box,
                      CU_TENSOR_MAP_DATA_TYPE_FLOAT32)))
    return err;
  if ((err = make_weight_map_f32(&mw, w, (int64_t)4 * ci, co))) return err;
  CUtensorMap m3;
  if (w3 && (err = make_third_map(&m3, w3, (int64_t)4 * ci, co))) return err;
  Conv conv = proto;
  conv.ci = ci;
  return launch_conv<Conv, 1, STAGES_F32>(mx, mx, mw, conv, g, b, y,
                                          (cudaStream_t)stream,
                                          w3 ? &m3 : nullptr);
}

// fp32 K3 / K7 when sa, ta and stats are null, else K6b; the form follows
// from what is given (sa and ta both or neither, stats and w3 both or
// neither)
int launch_valid_f32(const void* x, const void* w, const void* w3,
                     const void* b, void* y, const void* sa, const void* ta,
                     void* stats, int n, int hp, int wp8, int ci, int co,
                     int w_out, float slope, void* stream) {
  if (hp < 2 || (sa == nullptr) != (ta == nullptr) ||
      (stats == nullptr) != (w3 == nullptr))
    return (int)cudaErrorInvalidValue;
  auto run = [&](const auto& conv) {
    return launch_f32(conv, x, w, w3, b, y, n, hp, w_out + 1, wp8, ci, co,
                      hp - 1, w_out, stream);
  };
  auto run_fused = [&](auto conv) {
    set_pre_f32(conv, sa, ta, slope, hp, w_out + 1);
    conv.so = StatsOut{(float*)stats, 0};
    return run(conv);
  };
  if (!sa && !stats) return run(Valid2F32{});
  if (sa && stats) return run_fused(K6bValid2F32<FORM_PRE | FORM_STATS>{});
  return sa ? run_fused(K6bValid2F32<FORM_PRE>{})
            : run_fused(K6bValid2F32<FORM_STATS>{});
}

}  // namespace

// K4: x (n, h, w_in, ci), w (2, 2, ci, co), b (co) -> y (n, h+1, wp8, co),
// wp8 >= w_in + 1, columns > w_in zeros. Returns 0, or the CUDA error of the
// launch (or of the tensor map's encoding, above 20000).
extern "C" int pconv_pad11_sm90_bf16(const void* x, const void* w,
                                     const void* b, void* y, int n, int h,
                                     int w_in, int ci, int co, int wp8,
                                     void* stream) {
  if (wp8 < w_in + 1) return (int)cudaErrorInvalidValue;
  return launch(Pad11{}, x, w, b, y, n, h, w_in, w_in, ci, co, h + 1, wp8,
                w_in + 1, -1, 0, -1, stream);
}

// the same with the variant named (mode, stages, log_tw: see launch)
extern "C" int pconv_pad11_sm90_bf16_variant(const void* x, const void* w,
                                             const void* b, void* y, int n,
                                             int h, int w_in, int ci, int co,
                                             int wp8, int mode, int stages,
                                             int log_tw, void* stream) {
  if (wp8 < w_in + 1) return (int)cudaErrorInvalidValue;
  return launch(Pad11{}, x, w, b, y, n, h, w_in, w_in, ci, co, h + 1, wp8,
                w_in + 1, mode, stages, log_tw, stream);
}

// K3 (and K7 with wp8 = w_out + 1): x (n, hp, wp8, ci), w (2, 2, ci, co), b
// (co) -> y (n, hp-1, w_out, co), w_out + 1 <= wp8. Returns as above.
extern "C" int pconv_valid_sm90_bf16(const void* x, const void* w,
                                     const void* b, void* y, int n, int hp,
                                     int wp8, int ci, int co, int w_out,
                                     void* stream) {
  if (hp < 2) return (int)cudaErrorInvalidValue;
  return launch(Valid2{}, x, w, b, y, n, hp, w_out + 1, wp8, ci, co, hp - 1,
                w_out, w_out, -1, 0, -1, stream);
}

extern "C" int pconv_valid_sm90_bf16_variant(const void* x, const void* w,
                                             const void* b, void* y, int n,
                                             int hp, int wp8, int ci, int co,
                                             int w_out, int mode, int stages,
                                             int log_tw, void* stream) {
  if (hp < 2) return (int)cudaErrorInvalidValue;
  return launch(Valid2{}, x, w, b, y, n, hp, w_out + 1, wp8, ci, co, hp - 1,
                w_out, w_out, mode, stages, log_tw, stream);
}

// K6b: the same operands and, each or both, sa, ta (n, ci) bf16 for the pre
// transform with its leaky slope (a bf16 value), and stats (n, 16, co) fp32,
// zeroed by the caller, for the moment partials; null for the part that is
// not wanted. Returns as above.
extern "C" int pconv_valid_fused_sm90_bf16(
    const void* x, const void* w, const void* b, void* y, const void* sa,
    const void* ta, void* stats, int n, int hp, int wp8, int ci, int co,
    int w_out, float slope, void* stream) {
  return launch_k6b(x, w, b, y, sa, ta, stats, n, hp, wp8, ci, co, w_out,
                    slope, 0, -1, 0, -1, stream);
}

// the same with the variant named: a measuring form (0 none: K6b; 1 the sums
// stored without atomics, stats left wrong; with y wrong too, 2 the pre
// rewrite skipped, 3 its loads and stores alone), then mode, stages, log_tw
// as for K3 (see launch)
extern "C" int pconv_valid_fused_sm90_bf16_variant(
    const void* x, const void* w, const void* b, void* y, const void* sa,
    const void* ta, void* stats, int n, int hp, int wp8, int ci, int co,
    int w_out, float slope, int measure, int mode, int stages, int log_tw,
    void* stream) {
  return launch_k6b(x, w, b, y, sa, ta, stats, n, hp, wp8, ci, co, w_out,
                    slope, measure, mode, stages, log_tw, stream);
}

// fp32 by 3xTF32: K3 (and K7 with wp8 = w_out + 1) when sa, ta, stats and
// w3 are null, K6b with sa, ta (n, ci) fp32 for the pre transform with its
// leaky slope and / or stats (n, 16, co) fp32, zeroed by the caller, with
// w3: x (n, hp, wp8, ci), w the split weights (2, co, 4 ci) fp32 and w3
// the third part (4 ci, co) bf16 of ops/pconv.py tf32x3_weights (exact for
// the form with stats), b (co) fp32 -> y (n, hp-1, w_out, co) fp32.
// Returns as above.
extern "C" int pconv_valid_sm90_f32(const void* x, const void* w,
                                    const void* w3, const void* b, void* y,
                                    const void* sa, const void* ta,
                                    void* stats, int n, int hp, int wp8,
                                    int ci, int co, int w_out, float slope,
                                    void* stream) {
  return launch_valid_f32(x, w, w3, b, y, sa, ta, stats, n, hp, wp8, ci, co,
                          w_out, slope, stream);
}
