// Hopper (sm_90a) building blocks of the packed 2x2 conv kernels, and the
// kernel they share: TMA tensor maps and loads, mbarriers, wgmma with its
// shared-memory descriptors, register reallocation, and a persistent,
// warp-specialised implicit-GEMM conv (conv_wgmma_kernel) that
// pconv3_valid_sm90.cu (K5) and pconv_pad11_cat_sm90.cu (K1) instantiate
// with their own tap geometry. pconv2d_sm90.cu (K3, K4, K7) builds its
// weights-resident kernel from the same parts (the tile geometry, the slab
// shared by the two row taps, store_tile), and instantiates this one where
// its weights do not fit in shared memory.
//
// The conv: M = output pixels, N = Co, K = taps x Ci. The A operand of one
// (tap, 64-channel chunk) for a rectangle of TH x TW = 128 output pixels is
// a TMA box of the input at the tap's shifted coordinates: the tensor map
// carries the image geometry, so no thread computes an address, and
// coordinates outside the tensor (the pad rim, z planes outside [0, D), the
// ragged last tile) are zero-filled by the hardware. The box lands as rows
// of 128 bytes (one pixel's 64 channels) under the 128-byte swizzle, which
// is wgmma's K-major operand layout. The two row taps s = 0, 1 of a 2x2
// window share one box of TH + 1 image rows: tap s reads the 128 pixel rows
// that start TW rows in, and TW * 128 bytes is a multiple of the swizzle's
// 1024-byte period (TW >= 8), so the shifted operand is as well formed as
// the first. A K step is therefore (column tap, chunk) with both row taps:
// a slab of 128 + TW rows feeds two products, which nearly halves the input
// traffic from L2. The weights (taps*Ci, Co) are K x N with N contiguous: a
// box of 64 k-rows x 64 channels lands as wgmma's N-major ("transposed B")
// swizzled layout, so nothing repacks them.
//
// A block is three warpgroups: warpgroup 2 gives its registers away
// (setmaxnreg) and one of its threads starts every TMA load into a ring of
// STAGES stages, each guarded by a full / empty mbarrier pair; warpgroups 0
// and 1 each own one 128-pixel tile and accumulate 128 x 128 outputs in
// registers (2 x m64n128k16 per 16 channels and tap, fp32), sharing the
// stage's weight tiles. A stage is two input slabs (at most 20 KB each) and
// 2 x 16 KB of weights for 8.4 MFLOP. What the design watches is this feed:
// L2 delivers about 7.8 TB/s of such boxes to the SMs, and one box per tap
// (85 FLOP per byte fed) would cap both kernels below the tensor cores'
// rate. With CLUSTER = 2 (a timed variant, not the default), two
// neighbouring blocks of one image form a thread block cluster: each loads
// one half of the weight tiles and multicasts it to both. Blocks are
// persistent (one per SM) and walk the work items in an order that keeps
// the blocks running at one time on neighbouring tiles of the same images
// (their taps overlap in L2); the producer runs ahead into the next item
// while the consumers store. The epilogue adds the bias in fp32, rounds
// once to bf16, transposes 4 x 4 across each lane quad so that a thread
// owns 8 consecutive channels, and stores 16 bytes, guarded at the ragged
// edge.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace sm90 {

typedef __nv_bfloat16 bf16;

constexpr int TILE_PIX = 128;  // output pixels per consumer warpgroup
constexpr int BN = 128;        // output channels per block
constexpr int BK = 64;         // channels per K step: 128-byte rows
constexpr int ROW_BYTES = BK * 2;                // one pixel's chunk
constexpr int A_BOX_BYTES = TILE_PIX * ROW_BYTES;    // one tap's rows: 16 KB
constexpr int MIN_LOG_TW = 3, MAX_LOG_TW = 5;    // tiles 8, 16, 32 wide
// an input slab: TH + 1 image rows of TW pixels, at most 128 + 32 rows
constexpr int SLAB_BYTES = (TILE_PIX + (1 << MAX_LOG_TW)) * ROW_BYTES;
constexpr int B_HALF_BYTES = 64 * BK * 2;        // 64 k-rows x 64 channels
constexpr int B_TAP_BYTES = 2 * B_HALF_BYTES;    // one tap's 64 x 128 tile
// two slabs (one per consumer warpgroup), two taps of weights: 72 KB
constexpr int STAGE_BYTES = 2 * SLAB_BYTES + 2 * B_TAP_BYTES;
constexpr int THREADS = 384;

constexpr int smem_bytes(int stages) {
  // 1024 bytes of slack to align the ring, then the barriers
  return stages * STAGE_BYTES + 1024 + 2 * stages * 8;
}

// ------------------------------------------------------------ device side

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic for this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// arrive on the barrier at the same shared-memory offset in block `cta` of
// this cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

// spin until the phase of parity `parity` has completed; a wait that never
// ends (a lost arrival: a bug) traps after some seconds instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, spins = 0;
  do {
    if (++spins == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// TMA tile loads: one thread asks, the hardware copies the box (zero fill
// outside the tensor) and reports its bytes to the mbarrier
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// the same, delivered to every block of the cluster named in `mask`, at the
// same shared-memory offset and barrier in each
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst,
                                                      const CUtensorMap* map,
                                                      uint32_t bar, int c0,
                                                      int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(
          dst),
      "l"((uint64_t)map), "r"(bar), "h"(mask), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
}

template <int REGS>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory operand descriptors (address, leading and stride byte
// offsets in 16-byte units, layout type 1 = 128-byte swizzle at bits 62-63).
// A, K-major: rows of 64 channels, 8-row swizzle groups 1024 bytes apart
// (stride offset; the leading offset is unused). B, N-major: rows are k,
// 64 channels wide; 8 k-rows form a group, groups 1024 bytes apart (stride
// offset); channels 64..127 are the second box, 8192 bytes on (leading
// offset).
constexpr uint64_t DESC_A =
    (1ull << 62) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 16);
constexpr uint64_t DESC_B = (1ull << 62) | ((uint64_t)(1024 >> 4) << 32) |
                            ((uint64_t)(B_HALF_BYTES >> 4) << 16);

__device__ __forceinline__ uint64_t desc_at(uint64_t base, uint32_t addr) {
  return base | (uint64_t)((addr & 0x3FFFF) >> 4);
}

// D (64 x 128, fp32, in registers) = A (64 x 16, K-major) * B (16 x 128,
// N-major: the transposed-B form) [+ D when scale_d != 0], bf16 inputs.
// Thread t of the warpgroup holds, for each 8-channel chunk j, d[4j], d[4j+1]
// = row 16*(t/32) + (t%32)/4, channels 8j + 2*(t%4) + {0, 1}, and d[4j+2],
// d[4j+3] = the same channels 8 rows down.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// keep the compiler from moving reads of the accumulators above the wait
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 4 x 4 transpose across a lane quad: lane q gives v[k] (its value for
// column k) and ends with v[k] = lane k's value for column q
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int q) {
  const bool odd = q & 1, hi = q & 2;
#pragma unroll
  for (int k1 = 0; k1 < 2; ++k1) {
    const uint32_t send = odd ? v[2 * k1] : v[2 * k1 + 1];
    const uint32_t recv = __shfl_xor_sync(0xffffffffu, send, 1);
    if (odd) v[2 * k1] = recv; else v[2 * k1 + 1] = recv;
  }
#pragma unroll
  for (int k0 = 0; k0 < 2; ++k0) {
    const uint32_t send = hi ? v[k0] : v[2 + k0];
    const uint32_t recv = __shfl_xor_sync(0xffffffffu, send, 2);
    if (hi) v[k0] = recv; else v[2 + k0] = recv;
  }
}

// The output side of a conv and its tiling. Outputs are (n_img, out_h, out_w,
// co) channels-last; columns >= live_w are stored as exact zeros (no bias).
// A tile is th rows x (1 << log_tw) columns = 128 pixels (the input maps'
// boxes are th + 1 rows of as many columns); tiles of an image
// are numbered row-major, tiles_w to a row; a work item is one run of
// 2 * CLUSTER consecutive tiles of one image (one per consumer warpgroup of
// each block of the cluster; tile numbers past the image's last are computed
// on zero-filled input and not stored) times one block of 128 channels.
struct TileGeo {
  int n_img, out_h, out_w, live_w, co;
  int log_tw, th, tiles_w;
  int units_per_img, n_blocks, n_items;
};

// The epilogue of one tile: a consumer warpgroup holds the 128 pixels x 128
// channels (from n0) of the tile whose first output pixel is (i0, j0) of
// image img as acc[2][64] in wgmma's accumulator layout. Adds the bias in
// fp32, rounds once to bf16, transposes 4 x 4 across each lane quad so that
// a thread owns 8 consecutive channels, and stores 16 bytes, guarded at the
// ragged edge; columns >= live_w are stored as exact zeros. Nothing is
// stored unless `valid` (false for a tile number past the last).
__device__ __forceinline__ void store_tile(float (&acc)[2][64],
                                           const TileGeo& g, int img, int i0,
                                           int j0, int n0, bool valid,
                                           const bf16* __restrict__ bias,
                                           bf16* __restrict__ y, int warp,
                                           int lane) {
  const int q = lane & 3, rq = lane >> 2;
  const int tw_mask = (1 << g.log_tw) - 1;
  float2 bv[16];
#pragma unroll
  for (int j = 0; j < 16; ++j)
    bv[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        bias + n0 + 8 * j + 2 * q));
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = mi * 64 + warp * 16 + half * 8 + rq;
      const int i = i0 + (row >> g.log_tw), j = j0 + (row & tw_mask);
      const bool stored = valid && i < g.out_h && j < g.out_w;
      const bool live = j < g.live_w;
      bf16* const yp =
          y + (((int64_t)img * g.out_h + i) * g.out_w + j) * g.co + n0;
#pragma unroll
      for (int grp = 0; grp < 4; ++grp) {
        uint32_t v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = grp * 4 + k;
          const __nv_bfloat162 o = __floats2bfloat162_rn(
              acc[mi][4 * c + 2 * half] + bv[c].x,
              acc[mi][4 * c + 2 * half + 1] + bv[c].y);
          v[k] = live ? *reinterpret_cast<const uint32_t*>(&o) : 0u;
        }
        quad_transpose(v, q);
        if (stored)
          *reinterpret_cast<uint4*>(yp + 8 * (grp * 4 + q)) =
              make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// Conv supplies the tap geometry:
//   int ksteps(int img) const            K steps (column tap and the other
//                                        tap axes, 64-channel chunk) of an
//                                        image's tiles;
//   void load_a(map0, map1, ks, img, i0, j0, dst, bar) const
//                                        the TMA load of K step ks's slab
//                                        (row tap s = 0 and, one image row
//                                        down, s = 1) for the tile whose
//                                        first output pixel is (i0, j0) of
//                                        image img;
//   int w_row(int ks, int img, int s) const
//                                        first row of the (taps*Ci, Co)
//                                        weight matrix for row tap s of the
//                                        K step.
template <class Conv, int CLUSTER, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap map_a0,
                  const __grid_constant__ CUtensorMap map_a1,
                  const __grid_constant__ CUtensorMap map_w, const Conv conv,
                  const TileGeo g, const bf16* __restrict__ bias,
                  bf16* __restrict__ y) {
  static_assert(CLUSTER == 1 || CLUSTER == 2, "each block loads 1/CLUSTER "
                                              "of the weight tile's 2 boxes");
  extern __shared__ unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the ring to it
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = ring + STAGES * STAGE_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const uint32_t rank = CLUSTER > 1 ? cluster_rank() : 0u;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);               // the producer's expect_tx
      mbar_init(empty(s), 8 * CLUSTER);    // every consumer warp, each block
    }
    fence_barrier_init();
  }
  if constexpr (CLUSTER > 1) cluster_sync(); else __syncthreads();

  const int first = blockIdx.x / CLUSTER, step = gridDim.x / CLUSTER;
  // bytes of one slab's box, and the offset of row tap 1 within it
  const uint32_t tap_shift = (uint32_t)ROW_BYTES << g.log_tw;
  const uint32_t slab_bytes = A_BOX_BYTES + tap_shift;

  if (wg == 2) {
    // ---------------------------------------------------------- producer
    reg_dealloc<56>();
    if (tid == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int item = first; item < g.n_items; item += step) {
        const int nb = item % g.n_blocks;
        const int rest = item / g.n_blocks;
        const int unit = rest % g.units_per_img;
        const int img = rest / g.units_per_img;
        const int t0 = (unit * CLUSTER + (int)rank) * 2;
        const int i0a = (t0 / g.tiles_w) * g.th;
        const int j0a = (t0 % g.tiles_w) << g.log_tw;
        const int i0b = ((t0 + 1) / g.tiles_w) * g.th;
        const int j0b = ((t0 + 1) % g.tiles_w) << g.log_tw;
        const int n0 = nb * BN;
        const int ks_n = conv.ksteps(img);
        for (int ks = 0; ks < ks_n; ++ks) {
          mbar_wait(empty(stage), phase ^ 1u);
          const uint32_t bar = full(stage);
          const uint32_t sa = ring + stage * STAGE_BYTES;
          const uint32_t sb = sa + 2 * SLAB_BYTES;
          mbar_expect_tx(bar, 2 * slab_bytes + 2 * B_TAP_BYTES);
          conv.load_a(&map_a0, &map_a1, ks, img, i0a, j0a, sa, bar);
          conv.load_a(&map_a0, &map_a1, ks, img, i0b, j0b, sa + SLAB_BYTES,
                      bar);
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const int wr = conv.w_row(ks, img, s);
            const uint32_t st = sb + s * B_TAP_BYTES;
            if constexpr (CLUSTER == 1) {
              tma_load_2d(st, &map_w, bar, n0, wr);
              tma_load_2d(st + B_HALF_BYTES, &map_w, bar, n0 + 64, wr);
            } else {
              tma_load_2d_multicast(st + rank * B_HALF_BYTES, &map_w, bar,
                                    n0 + 64 * (int)rank, wr,
                                    (uint16_t)((1 << CLUSTER) - 1));
            }
          }
          if (++stage == STAGES) { stage = 0; phase ^= 1u; }
        }
      }
    }
    // no block may leave while its peer can still reach its shared memory
    // (the consumers end on the same barrier)
    if constexpr (CLUSTER > 1) cluster_sync();
  } else {
    // --------------------------------------------------------- consumers
    reg_alloc<224>();
    const int warp = (tid % 128) / 32, lane = tid % 32;
    float acc[2][64];
    int stage = 0;
    uint32_t phase = 0;
    auto release = [&](int s) {
      if constexpr (CLUSTER == 1) {
        if (lane == 0) mbar_arrive(empty(s));
      } else {
        if (lane < CLUSTER) mbar_arrive_cluster(empty(s), (uint32_t)lane);
      }
    };
    for (int item = first; item < g.n_items; item += step) {
      const int nb = item % g.n_blocks;
      const int rest = item / g.n_blocks;
      const int unit = rest % g.units_per_img;
      const int img = rest / g.units_per_img;
      const int tile = (unit * CLUSTER + (int)rank) * 2 + wg;
      const int i0 = (tile / g.tiles_w) * g.th;
      const int j0 = (tile % g.tiles_w) << g.log_tw;
      const int n0 = nb * BN;
      const int ks_n = conv.ksteps(img);
      int prev = 0;
      for (int ks = 0; ks < ks_n; ++ks) {
        mbar_wait(full(stage), phase);
        const uint32_t sa = ring + stage * STAGE_BYTES + wg * SLAB_BYTES;
        const uint32_t sb = ring + stage * STAGE_BYTES + 2 * SLAB_BYTES;
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 2; ++s) {
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            // 16 channels on: 32 bytes along A's rows, 16 k-rows down B
            const uint64_t db =
                desc_at(DESC_B, sb + s * B_TAP_BYTES + kk * 16 * 128);
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
          release(prev);
        }
        prev = stage;
        if (++stage == STAGES) { stage = 0; phase ^= 1u; }
      }
      wgmma_wait<0>();
      release(prev);
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      store_tile(acc, g, img, i0, j0, n0, true, bias, y, warp, lane);
    }
    if constexpr (CLUSTER > 1) cluster_sync();
  }
}

// ------------------------------------------------------------ host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime library the
// kernels link, so it is looked up in the libcuda the process has loaded
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (!h) h = dlopen("libcuda.so", RTLD_NOW | RTLD_GLOBAL);
    return h ? (EncodeTiledFn)dlsym(h, "cuTensorMapEncodeTiled") : nullptr;
  }();
  return fn;
}

constexpr int ERR_NO_ENCODE_ENTRY = 20001;   // cuTensorMapEncodeTiled missing
constexpr int ERR_ENCODE = 21000;            // + the CUresult of the encode
constexpr int ERR_TOO_LARGE = 20002;         // more work items than an int

// a bf16 tensor map with the 128-byte swizzle: dims and box innermost
// first, strides in bytes for dims 1.. (dim 0 is contiguous)
inline int make_map(CUtensorMap* map, const void* ptr, int rank,
                    const uint64_t* dims, const uint64_t* strides,
                    const uint32_t* box) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (!fn) return ERR_NO_ENCODE_ENTRY;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
         const_cast<void*>(ptr), (const cuuint64_t*)dims,
         (const cuuint64_t*)strides, (const cuuint32_t*)box, ones,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

// the (taps*Ci, Co) weight matrix in boxes of 64 k-rows x 64 channels
inline int make_weight_map(CUtensorMap* map, const void* w, int64_t k_rows,
                           int co) {
  const uint64_t dims[2] = {(uint64_t)co, (uint64_t)k_rows};
  const uint64_t strides[1] = {(uint64_t)co * 2};
  const uint32_t box[2] = {64, BK};
  return make_map(map, w, 2, dims, strides, box);
}

inline int sm_count() {
  static int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

// Tile an (out_h, out_w) output image by 128-pixel rectangles 8, 16 or 32
// wide; log_tw < 0 picks the width that covers it with the fewest tiles.
inline int make_geo(TileGeo* g, int n_img, int out_h, int out_w, int live_w,
                    int co, int cluster, int log_tw) {
  auto tiles = [&](int l) {
    const int tw = 1 << l, th = TILE_PIX >> l;
    return (int64_t)((out_h + th - 1) / th) * ((out_w + tw - 1) / tw);
  };
  if (log_tw < 0) {
    const int order[3] = {4, 3, 5};  // ties go to 16 x 8
    log_tw = order[0];
    for (int k = 1; k < 3; ++k)
      if (tiles(order[k]) < tiles(log_tw)) log_tw = order[k];
  }
  if (log_tw < MIN_LOG_TW || log_tw > MAX_LOG_TW)
    return (int)cudaErrorInvalidValue;
  const int tw = 1 << log_tw;
  const int64_t per_unit = 2 * cluster;
  const int64_t units = (tiles(log_tw) + per_unit - 1) / per_unit;
  const int64_t items = (int64_t)n_img * units * (co / BN);
  if (items >= (1ll << 31)) return ERR_TOO_LARGE;
  *g = TileGeo{n_img, out_h, out_w, live_w, co, log_tw, TILE_PIX >> log_tw,
               (out_w + tw - 1) / tw, (int)units, co / BN, (int)items};
  return 0;
}

template <class Conv, int CLUSTER, int STAGES>
int launch_conv(const CUtensorMap& a0, const CUtensorMap& a1,
                const CUtensorMap& w, const Conv& conv, const TileGeo& g,
                const void* bias, void* y, cudaStream_t stream) {
  auto kern = conv_wgmma_kernel<Conv, CLUSTER, STAGES>;
  constexpr int smem = smem_bytes(STAGES);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int clusters = sm_count() / CLUSTER;
  if (g.n_items < clusters) clusters = g.n_items;
  if (clusters < 1) return 0;  // nothing to compute
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * CLUSTER));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a0, a1, w, conv, g, (const bf16*)bias,
                         (bf16*)y);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// (cluster, stages) -> the instantiation; 0 picks the default of the caller
template <class Conv>
int launch_variant(int cluster, int stages, const CUtensorMap& a0,
                   const CUtensorMap& a1, const CUtensorMap& w,
                   const Conv& conv, const TileGeo& g, const void* bias,
                   void* y, cudaStream_t stream) {
  if (cluster == 1 && stages == 2)
    return launch_conv<Conv, 1, 2>(a0, a1, w, conv, g, bias, y, stream);
  if (cluster == 1 && stages == 3)
    return launch_conv<Conv, 1, 3>(a0, a1, w, conv, g, bias, y, stream);
  if (cluster == 2 && stages == 2)
    return launch_conv<Conv, 2, 2>(a0, a1, w, conv, g, bias, y, stream);
  if (cluster == 2 && stages == 3)
    return launch_conv<Conv, 2, 3>(a0, a1, w, conv, g, bias, y, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace sm90
