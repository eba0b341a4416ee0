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
//
// The deferred-norm forms (K6a in pconv_pad11_cat_sm90.cu, K6c in
// pconv3_valid_sm90.cu) are the same kernel with a Conv whose FORM names
// compile-time parts; a Conv without FORM compiles to the plain kernel:
// - FORM_PRE: the conv reads leaky(x * sa + ta) * rim_mask. The warpgroup
//   that owns a slab rewrites it in place in shared memory (Conv::transform)
//   once it has landed, then fences the async proxy and meets on a named
//   barrier before its wgmmas read it. The wgmmas of the K step before are
//   still running then (they are asynchronous), so the rewrite overlaps
//   them; what it costs is shared-memory traffic beside wgmma's operand
//   reads and a longer hold on the stage (a form that rewrote the slab of
//   step ks + 1 after issuing step ks, holding one more stage, timed the
//   same or slower).
// - FORM_RIM: the epilogue zeroes the output by the full offset rim mask.
// - FORM_STATS: the epilogue also sums the stored (rounded) values and
//   their squares per channel over the tile's stored pixels, in registers,
//   across lanes by a halving butterfly, across the warpgroup's four warps
//   in shared memory, and adds them to the image's (16, Co) fp32 partials
//   with one vector red per four channels, kind and tile
//   (store_tile_fused).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

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

// The compile-time parts of a deferred-norm form: Conv::FORM is a sum of
// these (a Conv without the member is the plain form, 0).
constexpr int FORM_PRE = 1;    // transform the input slabs in shared memory
constexpr int FORM_STATS = 2;  // moment partials of the stored output
constexpr int FORM_RIM = 4;    // the full offset rim mask on the output

template <class Conv, class = void>
struct form_of {
  static constexpr int value = 0;
};
template <class Conv>
struct form_of<Conv, std::void_t<decltype(Conv::FORM)>> {
  static constexpr int value = Conv::FORM;
};

// FORM_STATS: 256 floats for each warp of the two consumer warpgroups
constexpr int STATS_SCRATCH_BYTES = 2 * 4 * 256 * 4;

constexpr int smem_bytes(int stages, int form = 0) {
  // 1024 bytes of slack to align the ring, then the barriers, then the
  // statistics' scratch
  return stages * STAGE_BYTES + 1024 + 2 * stages * 8 +
         ((form & FORM_STATS) ? STATS_SCRATCH_BYTES : 0);
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

// generic-proxy writes to shared memory become visible to the async proxy
// (wgmma's operand reads, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1..15; 0 is __syncthreads') among `threads` threads
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ float4 lds_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts_f2(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a),
               "f"(b)
               : "memory");
}

// one atomic add of four consecutive floats (16-byte aligned), no return
__device__ __forceinline__ void red_add_f4(float* p, float4 v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// leaky(x * s + t) on a pair of bf16 values, rounded to bf16 after the
// multiply, the add and the leaky product (the _rn forms are never
// contracted into one fma, which would round once); slope2 holds the slope
// twice. MAX_FORM (a slope in [0, 1]): leaky(v) = max(v, v * slope), one
// instruction where the select by sign takes four; instructions count here,
// because they run beside the wgmmas. A negative zero takes the product's
// branch in the select form, which gives a zero too.
template <bool MAX_FORM>
__device__ __forceinline__ uint32_t pre_bf16x2(uint32_t x, uint32_t s,
                                               uint32_t t, uint32_t slope2) {
  const __nv_bfloat162 v = __hadd2_rn(
      __hmul2_rn(*reinterpret_cast<const __nv_bfloat162*>(&x),
                 *reinterpret_cast<const __nv_bfloat162*>(&s)),
      *reinterpret_cast<const __nv_bfloat162*>(&t));
  const __nv_bfloat162 m =
      __hmul2_rn(v, *reinterpret_cast<const __nv_bfloat162*>(&slope2));
  if constexpr (MAX_FORM) {
    const __nv_bfloat162 r = __hmax2(v, m);
    return *reinterpret_cast<const uint32_t*>(&r);
  } else {
    const uint32_t vb = *reinterpret_cast<const uint32_t*>(&v);
    const uint32_t mb = *reinterpret_cast<const uint32_t*>(&m);
    const uint32_t neg = ((vb >> 15) & 0x00010001u) * 0xffffu;
    return (mb & neg) | (vb & ~neg);
  }
}

// lo <= v < hi, for lo <= hi
__device__ __forceinline__ bool in_range(int v, int lo, int hi) {
  return (unsigned)(v - lo) < (unsigned)(hi - lo);
}

// ops/pack2d.py offset_rim_mask: is (row, col) of channel group grp (dy =
// grp / 2, dx = grp % 2) inside the image, for an offset tensor hp rows high
// and tw columns true width? Positions past the tensor are outside.
__device__ __forceinline__ bool rim_ok(int row, int col, int hp, int tw,
                                       int grp) {
  return ((grp & 2) ? row < hp - 1 : (row > 0 && row < hp)) &&
         ((grp & 1) ? col < tw - 1 : (col > 0 && col < tw));
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

// Where a FORM_STATS epilogue adds its sums: stats (n_img, 16, co) fp32,
// zeroed by the caller; rows 0:8 of an image take the sums, rows 8:16 the
// sums of squares, a tile adding to row tile % 8 of each half so that
// neighbouring tiles' atomics land on different addresses. no_atomics is
// for measuring what the atomics cost (tune_sm90): the sums are stored
// plainly, a wrong result.
struct StatsOut {
  float* stats;
  int no_atomics;
};

// store_tile for the deferred-norm forms. FORM_RIM: a value is stored as an
// exact zero where the full offset rim mask of (out_h rows, live_w true
// columns, channel group c / (co / 4)) is zero, not only at columns >=
// live_w. FORM_STATS: the sum and the sum of squares, in fp32, of the
// rounded values as stored, over the tile's stored pixels, go to
// so.stats[img] (tile numbers past the image's last and the ragged edge stay
// out: nothing of them is stored). `scratch` is this warpgroup's 4 KB of
// shared memory and `bar` its named barrier.
//
// A thread holds 4 pixels x 32 channels. Channels go in four groups of 32
// (grp; the 16 bytes a thread stores after the quad transpose lie in one
// group, and so does a rim-mask channel group, co / 4 being a multiple of
// 32), outermost, so that only 16 partial sums are live beside the 128
// accumulators: 4 pixels are summed in registers, the 8 lanes that share a
// quad position by a halving butterfly (each round sends half of what is
// left: 8 + 4 + 2 shuffles), after which lane (rq, q) holds kind rq / 4 of
// the two channels 32 grp + 8 (rq % 4) + 2 q + {0, 1}. The four warps'
// values meet in shared memory, and 64 threads add four channels each with
// one vector red (scalar atomics there, or from every warp without the
// shared-memory sum, timed the same within the spread of the timings).
template <int FORM>
__device__ __forceinline__ void store_tile_fused(
    float (&acc)[2][64], const TileGeo& g, int img, int i0, int j0, int n0,
    int tile, const bf16* __restrict__ bias, bf16* __restrict__ y,
    const StatsOut& so, uint32_t scratch, int bar, int warp, int lane) {
  constexpr bool STATS = (FORM & FORM_STATS) != 0;
  const int q = lane & 3, rq = lane >> 2;
  const int tw_mask = (1 << g.log_tw) - 1;
  int pi[4], pj[4];
  bool stored[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = (r >> 1) * 64 + warp * 16 + (r & 1) * 8 + rq;
    pi[r] = i0 + (row >> g.log_tw);
    pj[r] = j0 + (row & tw_mask);
    stored[r] = pi[r] < g.out_h && pj[r] < g.out_w;
  }
#pragma unroll
  for (int grp = 0; grp < 4; ++grp) {
    const int rim_grp = (n0 + 32 * grp) / (g.co >> 2);
    float2 bv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      bv[k] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          bias + n0 + 8 * (grp * 4 + k) + 2 * q));
    float e[16];  // [kind * 8 + 2 k + {0, 1}]
#pragma unroll
    for (int i = 0; i < 16; ++i) e[i] = 0.0f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int mi = r >> 1, half = r & 1;
      bool live = pj[r] < g.live_w;
      if constexpr ((FORM & FORM_RIM) != 0)
        live = rim_ok(pi[r], pj[r], g.out_h, g.live_w, rim_grp);
      uint32_t v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = grp * 4 + k;
        const __nv_bfloat162 o = __floats2bfloat162_rn(
            acc[mi][4 * c + 2 * half] + bv[k].x,
            acc[mi][4 * c + 2 * half + 1] + bv[k].y);
        v[k] = live ? *reinterpret_cast<const uint32_t*>(&o) : 0u;
        if constexpr (STATS) {
          if (stored[r]) {  // the value as stored: bf16 is fp32's top half
            const float lo = __uint_as_float(v[k] << 16);
            const float hi = __uint_as_float(v[k] & 0xffff0000u);
            e[2 * k] += lo;
            e[2 * k + 1] += hi;
            e[8 + 2 * k] = fmaf(lo, lo, e[8 + 2 * k]);
            e[8 + 2 * k + 1] = fmaf(hi, hi, e[8 + 2 * k + 1]);
          }
        }
      }
      quad_transpose(v, q);
      if (stored[r])
        *reinterpret_cast<uint4*>(
            y + (((int64_t)img * g.out_h + pi[r]) * g.out_w + pj[r]) * g.co +
            n0 + 8 * (grp * 4 + q)) = make_uint4(v[0], v[1], v[2], v[3]);
    }
    if constexpr (STATS) {
      const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
      float a8[8], a4[4], a2[2];
#pragma unroll
      for (int i = 0; i < 8; ++i) {  // keep kind b4
        const float recv =
            __shfl_xor_sync(0xffffffffu, b4 ? e[i] : e[8 + i], 16);
        a8[i] = (b4 ? e[8 + i] : e[i]) + recv;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // keep k / 2 == b3
        const float recv =
            __shfl_xor_sync(0xffffffffu, b3 ? a8[i] : a8[4 + i], 8);
        a4[i] = (b3 ? a8[4 + i] : a8[i]) + recv;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // keep k % 2 == b2
        const float recv =
            __shfl_xor_sync(0xffffffffu, b2 ? a4[i] : a4[2 + i], 4);
        a2[i] = (b2 ? a4[2 + i] : a4[i]) + recv;
      }
      // [warp][kind = rq / 4][128 channels]
      sts_f2(scratch + 4u * (warp * 256 + (rq >> 2) * 128 + 32 * grp +
                             8 * (rq & 3) + 2 * q),
             a2[0], a2[1]);
    }
  }
  if constexpr (STATS) {
    named_barrier(bar, 128);
    const int t = warp * 32 + lane;
    if (t < 64) {  // kind t / 32, channels 4 (t % 32) + 0..3, over the warps
      float4 v = lds_f4(scratch + 16u * t);
#pragma unroll
      for (int w = 1; w < 4; ++w) {
        const float4 u = lds_f4(scratch + 16u * t + 1024u * w);
        v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
      }
      float* const p =
          so.stats + ((int64_t)img * 16 + (t >> 5) * 8 + (tile & 7)) * g.co +
          n0 + 4 * (t & 31);
      if (so.no_atomics)
        *reinterpret_cast<float4*>(p) = v;
      else
        red_add_f4(p, v);
    }
    named_barrier(bar, 128);  // the scratch is free for the next tile
  }
}

// FORM_PRE: thread t of warpgroup wg's 128 waits for the slab of K step ks
// and rewrites its share of it (Conv::transform). The writes reach the async
// proxy, and every thread of the warpgroup has made its own, before any
// wgmma reads the slab: a proxy fence, then the warpgroup's named barrier.
template <class Conv>
__device__ __forceinline__ void land_and_transform(
    const Conv& conv, int ks, int img, int i0, int j0, uint32_t full_bar,
    uint32_t phase, uint32_t slab, int log_tw, int wg, int t) {
  const auto operands = conv.pre_operands(ks, img, t);  // in flight early
  mbar_wait(full_bar, phase);
  conv.transform(operands, ks, img, i0, j0, slab, log_tw, t);
  fence_proxy_async();
  named_barrier(1 + wg, 128);
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
// and, for a deferred-norm form, static constexpr int FORM and
//   StatsOut so                          (FORM_STATS) where the sums go;
//   auto pre_operands(ks, img, t) const  (FORM_PRE) what thread t of the
//                                        128 of the warpgroup needs from
//                                        device memory for K step ks,
//                                        asked for before the slab's wait;
//   void transform(operands, ks, img, i0, j0, slab, log_tw, t) const
//                                        (FORM_PRE) thread t rewrites its
//                                        share of the landed slab.
template <class Conv, int CLUSTER, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap map_a0,
                  const __grid_constant__ CUtensorMap map_a1,
                  const __grid_constant__ CUtensorMap map_w, const Conv conv,
                  const TileGeo g, const bf16* __restrict__ bias,
                  bf16* __restrict__ y) {
  static_assert(CLUSTER == 1 || CLUSTER == 2, "each block loads 1/CLUSTER "
                                              "of the weight tile's 2 boxes");
  constexpr int FORM = form_of<Conv>::value;
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
        if constexpr ((FORM & FORM_PRE) != 0)
          land_and_transform(conv, ks, img, i0, j0, full(stage), phase,
                             ring + stage * STAGE_BYTES + wg * SLAB_BYTES,
                             g.log_tw, wg, tid % 128);
        else
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
      if constexpr ((FORM & (FORM_STATS | FORM_RIM)) != 0)
        store_tile_fused<FORM>(acc, g, img, i0, j0, n0, tile, bias, y,
                               conv.so,
                               bars + 16u * STAGES + wg * 4096u, 1 + wg,
                               warp, lane);
      else
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

// the SMs of the current device (the one the launch goes to), looked up once
// for each device
inline int sm_count() {
  constexpr int MAX_DEV = 64;
  static int known[MAX_DEV] = {};
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < MAX_DEV && known[dev]) return known[dev];
  cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
  if (dev >= 0 && dev < MAX_DEV) known[dev] = v;
  return v;
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
  constexpr int smem = smem_bytes(STAGES, form_of<Conv>::value);
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

// the deferred-norm forms: one block per cluster, 2 or 3 ring stages
template <class Conv>
int launch_fused(int stages, const CUtensorMap& a0, const CUtensorMap& a1,
                 const CUtensorMap& w, const Conv& conv, const TileGeo& g,
                 const void* bias, void* y, cudaStream_t stream) {
  if (stages == 2)
    return launch_conv<Conv, 1, 2>(a0, a1, w, conv, g, bias, y, stream);
  if (stages == 3)
    return launch_conv<Conv, 1, 3>(a0, a1, w, conv, g, bias, y, stream);
  return (int)cudaErrorInvalidValue;
}

// a bf16 value (a float that is exactly one) twice in 32 bits
inline uint32_t bf16x2_bits(float v) {
  uint32_t f;
  memcpy(&f, &v, 4);
  const uint32_t h = (f + 0x7fffu + ((f >> 16) & 1u)) >> 16;
  return h | (h << 16);
}

}  // namespace sm90
