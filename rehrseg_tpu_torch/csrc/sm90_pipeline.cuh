// Hopper (sm_90a) building blocks of the packed 2x2 conv kernels, and the
// kernel they share: TMA tensor maps and loads, mbarriers, wgmma with its
// shared-memory descriptors, register reallocation, and a persistent,
// warp-specialised implicit-GEMM conv (conv_wgmma_kernel) that
// pconv3_valid_sm90.cu (K5, K6c) and pconv_pad11_cat_sm90.cu (K1, K6a)
// instantiate with their own tap geometry. pconv2d_sm90.cu (K3, K4, K7,
// K6b) builds its weights-resident kernel from the same parts (the tile
// geometry, the slab shared by the two row taps, store_tile and the
// deferred-norm parts below), and instantiates this one where its weights
// do not fit in shared memory.
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
// pconv3_valid_sm90.cu: this kernel; K6b in pconv2d_sm90.cu: its
// weights-resident kernel, or this one where the weights do not fit) are
// the plain kernels with a Conv whose FORM names compile-time parts; a Conv
// without FORM compiles to the plain kernel:
// - FORM_PRE: the conv reads leaky(x * sa + ta) * rim_mask. In bf16 the
//   warpgroup that owns a slab rewrites it in place in shared memory
//   (Conv::transform, PreSlab's rewrite_slab) once it has landed, then
//   fences the async proxy and meets on a named barrier before its wgmmas
//   read it (fp32 transforms A in registers: PreF32). The wgmmas of
//   the K step before are still running then (they are asynchronous), so
//   the rewrite overlaps them; what it costs is shared-memory traffic beside
//   wgmma's operand reads and a longer hold on the stage (a form that
//   rewrote the slab of step ks + 1 after issuing step ks, holding one more
//   stage, timed the same or slower).
// - FORM_RIM: the epilogue zeroes the output by the full offset rim mask.
// - FORM_STATS: the epilogue also sums the stored (rounded) values and
//   their squares per channel over the tile's stored pixels, in registers,
//   across lanes by a halving butterfly, across the warpgroup's four warps
//   in shared memory, and adds them to the image's (16, Co) fp32 partials
//   with one vector red per four channels, kind and tile
//   (store_tile_fused).
//
// The fp32 operand path (a Conv with TF32X3: pconv_pad11_cat_sm90.cu's fp32
// K1, K4 and K6a, pconv3_valid_sm90.cu's fp32 K5 and K6c, pconv2d_sm90.cu's
// fp32 K3, K7 and K6b) computes fp32-accurate products on the tensor cores by
// 3xTF32: each operand is split into a TF32 high part and a TF32 low part,
// and the accumulators take hi * lo + lo * hi + hi * hi (lo * lo, below
// 2^-22 of the product, is dropped). TF32 wgmma reads both operands K-major
// (no transposed B for 32-bit types), so the weights come split and K-major
// from the host (one pass a call, a few microseconds), and A comes from
// registers: each consumer thread loads its pixels' fp32 channels from the
// landed slab and splits them itself, so no second slab holds A's low
// part. The tensor cores' fp32 accumulation truncates (round toward zero),
// and with three products a k its error grows with K: summed over K = 1024
// it reached 5e-5 of the output, over the 2e-5 the kernel is held to. So
// the accumulators start afresh every K step (64 k) and are added to a
// second set of sums in registers, which leaves room for 64 pixels x 128
// channels a consumer warpgroup (2 x 64 floats a thread), not 128 x 128:
// a block is 128 pixels, its slabs TH + 1 rows of TW pixels with TH x TW =
// 64 (32 fp32 channels fill a 128-byte row, as 64 bf16 do), and a stage
// holds the two slabs and a tap's W_hi and W_lo twice, 88 KB, two stages.
// The epilogue adds the bias in fp32 and stores without rounding
// (store_tile_f32). What bounds it is the tensor cores' TF32 rate, three
// products for one: 3 x 1.03 TFLOP at 495 TFLOP/s is 6.25 ms at K1's
// served shape, against 15.4 ms for the same work at fp32's FMA rate. Its
// FORM_PRE (fp32 K6b, K6c) is not a rewrite of the slab: the transform is
// applied to A in registers as each consumer thread loads its channels
// from the landed slab, before the split (PreF32), so shared memory
// carries no more traffic than the plain form's; each element is
// transformed twice, once for each row tap that reads it.
//
// The fp32 forms with moment sums (K6a, K6b, K6c: exact_of) need more than
// fp32-accurate outputs. The truncation of the tensor cores' fp32
// accumulation shortens every partial sum toward zero, and where a
// channel's inputs are mostly positive (a deferred norm's leaky output) it
// does so alike in every pixel: an image's sum of the stored output adds it
// up, ten times past the sums' tolerance at K6b's path shape, where each
// output stays within 2e-5. And W_hi + W_lo hold only 22 of the weights'
// 24 bits, an error every pixel shares. So these forms make the large
// product exact and the weights whole (tf32x3_exact_step): A_hi is A on a
// grid of 2^-9 of the pixel row's largest power of two over a row tap's 32
// channels (11 bits), W_hi is W on a grid of 2^-8 of the largest of the
// same 32 k of a column (10 bits), so a row tap's 32 products A_hi W_hi
// are multiples of one grid step, each at most 2^19 of them, and their
// sum, at most 2^24 steps, is exact in fp32: what the tensor cores return.
// The rest, A_lo W_hi + A W_lo (about 2^-9 of it), goes to an accumulator
// of its own with a third, bf16, part of W (the bits W_hi and W_lo leave,
// a K step's 16 KB of shared memory) times bf16 A (two m64n128k16 a row
// tap). The products cost 3.5 TF32 products where the other forms take 3,
// and two flushes a row tap where they take one half.

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
// The fp32 operand path (3xTF32): a K step takes 32 channels (128-byte rows
// of fp32), a consumer warpgroup's tile is 64 pixels (so a slab is TH + 1
// rows of TW pixels, TH x TW = 64), and a tap's weights are two K-major
// tiles of 128 channels x 32 k, W_hi then W_lo: an 88 KB stage, two of
// them.
constexpr int BK_F32 = 32;
constexpr int TILE_PIX_F32 = 64;
constexpr int SLAB_F32_BYTES = (TILE_PIX_F32 + (1 << MAX_LOG_TW)) * ROW_BYTES;
constexpr int B_TILE_F32_BYTES = BN * BK_F32 * 4;       // 16 KB
constexpr int B_TAP_F32_BYTES = 2 * B_TILE_F32_BYTES;   // W_hi, W_lo
constexpr int STAGE_F32_BYTES = 2 * SLAB_F32_BYTES + 2 * B_TAP_F32_BYTES;
constexpr int STAGES_F32 = 2;

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

// A Conv with static constexpr bool TF32X3 = true takes fp32 operands, the
// 3xTF32 path: y and the bias are fp32, and the weights the split (2 Co,
// taps * Ci) K-major matrix of ops/pconv.py tf32x3_weights.
template <class Conv, class = void>
struct tf32x3_of {
  static constexpr bool value = false;
};
template <class Conv>
struct tf32x3_of<Conv, std::void_t<decltype(Conv::TF32X3)>> {
  static constexpr bool value = Conv::TF32X3;
};
template <class Conv>
using elem_of = std::conditional_t<tf32x3_of<Conv>::value, float, bf16>;
// The fp32 forms with moment sums (fp32 K6a, K6b, K6c) make their large
// product exact (tf32x3_exact_step) and take a third, bf16, part of the
// weights: a K step's 64 k x 128 channels, N-major in two 64-channel boxes
// as the bf16 path's weights (DESC_B), after the stage's W_hi and W_lo.
template <class Conv>
constexpr bool exact_of = tf32x3_of<Conv>::value &&
                          (form_of<Conv>::value & FORM_STATS) != 0;
constexpr int W3_BYTES = 2 * B_HALF_BYTES;  // 16 KB
template <class Conv>
constexpr int stage_bytes_of =
    tf32x3_of<Conv>::value ? STAGE_F32_BYTES + (exact_of<Conv> ? W3_BYTES : 0)
                           : STAGE_BYTES;

// FORM_STATS: 256 floats for each warp of the two consumer warpgroups
constexpr int STATS_SCRATCH_BYTES = 2 * 4 * 256 * 4;

constexpr int smem_bytes(int stages, int form = 0,
                         int stage_bytes = STAGE_BYTES) {
  // 1024 bytes of slack to align the ring, then the barriers, then the
  // statistics' scratch
  return stages * stage_bytes + 1024 + 2 * stages * 8 +
         ((form & FORM_STATS) ? STATS_SCRATCH_BYTES : 0);
}
// a block may have 227 KB (232,448 bytes) of shared memory
static_assert(smem_bytes(STAGES_F32, FORM_STATS, STAGE_F32_BYTES + W3_BYTES) <=
                  232448,
              "the fp32 ring does not fit");

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

// D (64 x 128, fp32) = A (64 x 8, TF32, in registers) * B (8 x 128, TF32,
// K-major in shared memory: tf32 has no transposed B) [+ D], D laid out as
// wgmma_m64n128k16's. Warp w of the warpgroup gives rows 16w..16w+15: lane
// l holds a[0] = (row l/4, k l%4), a[1] = 8 rows down, a[2] and a[3] the
// same rows at k + 4. The tensor cores read the top 19 bits of each
// operand.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64],
                                                     const uint32_t (&a)[4],
                                                     uint64_t db,
                                                     int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 128, fp32) = A (64 x 16, bf16, in registers) * B (16 x 128,
// N-major in shared memory, DESC_B) [+ D], D laid out as wgmma_m64n128k16's.
// Lane l of warp w holds a[0] = (row 16w + l/4, k 2(l%4) + {0, 1}) as a bf16
// pair (the lower k in the low half), a[1] the same 8 rows down, a[2] and
// a[3] the same rows at k + 8.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// x split into two TF32 values, hi + lo = x within 2^-22 |x| (ops/pconv.py
// split_tf32): hi rounds x to nearest, ties away from zero, and lo rounds
// the exact remainder x - hi the same way. hi's low 13 bits are cleared, so
// that the remainder is taken from the value the tensor cores read.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x));
  h &= 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;\n"
      : "=r"(l)
      : "f"(__fsub_rn(x, __uint_as_float(h))));
  hi = h;
  lo = l;
}

// two floats as a bf16 pair, rounded to nearest, lo in the low half
__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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
// FORM_STATS, one channel group of a tile: e holds this thread's partials
// of the group's channels 8 (grp * 4 + k) + 2 q + {0, 1} (kind * 8 + 2 k +
// {0, 1}); the halving butterfly leaves lane (rq, q) kind rq / 4 of the two
// channels 32 grp + 8 (rq % 4) + 2 q + {0, 1}, which go to the warp's row of
// the scratch.
__device__ __forceinline__ void stats_to_scratch(const float (&e)[16],
                                                 int grp, uint32_t scratch,
                                                 int warp, int lane) {
  const int q = lane & 3, rq = lane >> 2;
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

// FORM_STATS, once the four channel groups are in the scratch: the four
// warps' values summed, and added to so.stats[img] (row tile % 8 of each
// half) by 64 threads with one vector red each
__device__ __forceinline__ void stats_flush(const TileGeo& g, int img,
                                            int n0, int tile,
                                            const StatsOut& so,
                                            uint32_t scratch, int bar,
                                            int warp, int lane) {
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
    if constexpr (STATS) stats_to_scratch(e, grp, scratch, warp, lane);
  }
  if constexpr (STATS)
    stats_flush(g, img, n0, tile, so, scratch, bar, warp, lane);
}

// The epilogue of the fp32 operand path, every form (FORM 0: columns >=
// live_w exact zeros; FORM_RIM, FORM_STATS as store_tile_fused's, the sums
// over the fp32 values as stored), for a tile of 64 pixels x 128 channels
// (from n0) in sums[64], laid out as one wgmma accumulator: the bias added
// in fp32, no rounding. A thread holds two consecutive channels of a pixel
// and its partner lane (q ^ 1) the next two; the pair swaps halves with two
// shuffles, so that the even lane stores four channels of row half 0 and
// the odd lane four of row half 1, 16 bytes each.
template <int FORM>
__device__ __forceinline__ void store_tile_f32(
    float (&sums)[64], const TileGeo& g, int img, int i0, int j0, int n0,
    int tile, const float* __restrict__ bias, float* __restrict__ y,
    const StatsOut& so, uint32_t scratch, int bar, int warp, int lane) {
  constexpr bool STATS = (FORM & FORM_STATS) != 0;
  const int q = lane & 3, rq = lane >> 2, odd = q & 1;
  const int tw_mask = (1 << g.log_tw) - 1;
  int pi[2], pj[2];
  bool stored[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = warp * 16 + half * 8 + rq;
    pi[half] = i0 + (row >> g.log_tw);
    pj[half] = j0 + (row & tw_mask);
    stored[half] = pi[half] < g.out_h && pj[half] < g.out_w;
  }
#pragma unroll
  for (int grp = 0; grp < 4; ++grp) {
    const int rim_grp = (n0 + 32 * grp) / (g.co >> 2);
    bool live[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      live[half] = pj[half] < g.live_w;
      if constexpr ((FORM & FORM_RIM) != 0)
        live[half] = rim_ok(pi[half], pj[half], g.out_h, g.live_w, rim_grp);
    }
    float e[16];  // [kind * 8 + 2 k + {0, 1}]
#pragma unroll
    for (int i = 0; i < 16; ++i) e[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = grp * 4 + k;
      const float2 bv =
          *reinterpret_cast<const float2*>(bias + n0 + 8 * c + 2 * q);
      float2 o[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        o[half] = live[half]
                      ? make_float2(sums[4 * c + 2 * half] + bv.x,
                                    sums[4 * c + 2 * half + 1] + bv.y)
                      : make_float2(0.0f, 0.0f);
        if constexpr (STATS) {
          if (stored[half]) {
            e[2 * k] += o[half].x;
            e[2 * k + 1] += o[half].y;
            e[8 + 2 * k] = fmaf(o[half].x, o[half].x, e[8 + 2 * k]);
            e[8 + 2 * k + 1] = fmaf(o[half].y, o[half].y, e[8 + 2 * k + 1]);
          }
        }
      }
      const float2 send = odd ? o[0] : o[1];
      const float rx = __shfl_xor_sync(0xffffffffu, send.x, 1);
      const float ry = __shfl_xor_sync(0xffffffffu, send.y, 1);
      if (stored[odd])
        *reinterpret_cast<float4*>(
            y + (((int64_t)img * g.out_h + pi[odd]) * g.out_w + pj[odd]) *
                    g.co +
            n0 + 8 * c + 2 * (q & 2)) =
            odd ? make_float4(rx, ry, o[1].x, o[1].y)
                : make_float4(o[0].x, o[0].y, rx, ry);
    }
    if constexpr (STATS) stats_to_scratch(e, grp, scratch, warp, lane);
  }
  if constexpr (STATS)
    stats_flush(g, img, n0, tile, so, scratch, bar, warp, lane);
}

// FORM_PRE's operands and its rewrite of a landed slab, shared by the
// deferred-norm Convs (K6b, K6c), which add the K step's tap and channels
// and the row of sa / ta (an image for K6b, a batch element for K6c).
//
// A slab row is one pixel's 64 channels, stored under the 128-byte
// swizzle: its logical 16-byte chunk k sits at physical chunk k ^ (row & 7).
// Thread t of the warpgroup's 128 takes physical chunk t % 8 of rows t / 8,
// t / 8 + 16, ..., whose row & 7 never changes, so its eight channels, and
// with them its sa, ta and rim-mask group, are fixed for a K step. What TMA
// zero-filled (past row hp - 1 or column tw - 1) is outside the mask and
// stays zero. The rewrite is kept to few instructions (a slab inside the
// rim skips the mask; a slope in [0, 1] takes leaky as one max): what it
// costs is its 2 x 18 KB of shared-memory traffic a slab, beside wgmma's
// operand reads and TMA's writes.
struct PreSlab {
  const bf16* sa;   // (rows, Ci)
  const bf16* ta;
  uint32_t slope2;  // the leaky slope, bf16, twice
  int hp, tw;       // the input's rows and true width w_out + 1
  int max_form;     // the slope lies in [0, 1]: leaky(v) = max(v, v * slope)
  // measuring forms (tune_sm90), the conv's output wrong: 2 the rewrite
  // skipped (its wait, fence and barrier alone), 3 its loads and stores
  // alone; 0 the transform
  int measure;

  struct Operands {
    uint4 sv, tv;
    int grp;  // the channels' rim-mask group
  };

  // thread t's scale and shift for channels c0 .. c0 + 63 of sa / ta row
  // `row` (of ci channels)
  __device__ __forceinline__ Operands operands(int64_t row, int ci, int c0,
                                               int t) const {
    const int c = c0 + 8 * ((t & 7) ^ ((t >> 3) & 7));
    const int64_t off = row * ci + c;
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

  // thread t of the warpgroup's 128 rewrites its share of the landed slab
  // whose first row is input row i0 and first column input column jc (the
  // tap's)
  __device__ __forceinline__ void rewrite_slab(const Operands& o, int i0,
                                               int jc, uint32_t slab,
                                               int log_tw, int t) const {
    // the slab's rows [r_lo, r_hi) and columns [c_lo, c_hi) that lie inside
    // the rim mask of this thread's channel group (rim_ok, as ranges; an
    // empty range has hi == lo: a tile past the ragged edge)
    const int dy = o.grp >> 1, dx = o.grp & 1, th1 = (TILE_PIX >> log_tw) + 1;
    const int r_lo = max(0, 1 - dy - i0);
    const int r_hi = max(r_lo, min(th1, hp - dy - i0));
    const int c_lo = max(0, 1 - dx - jc);
    const int c_hi = max(c_lo, min(1 << log_tw, tw - dx - jc));
    const bool inside = r_lo == 0 && r_hi == th1 && c_lo == 0 &&
                        c_hi == (1 << log_tw);
    const int rows = TILE_PIX + (1 << log_tw), p = t >> 3;
    uint32_t addr = slab + p * ROW_BYTES + (t & 7) * 16;
    if (measure == 2) return;
    if (measure == 3) {
      for (int q = p; q < rows; q += 16, addr += 16 * ROW_BYTES)
        sts128(addr, lds128(addr));
      return;
    }
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

// FORM_PRE on the fp32 operand path (fp32 K6b, K6c): the transform
// leaky(x * sa + ta) * rim_mask applied to A in registers, inside the
// step (tf32x3_step, tf32x3_exact_step), to the channels a consumer thread
// has loaded from the landed slab and before it splits them, with the
// roundings of pre_plain (after the multiply, the add and the leaky
// product; the _rn forms are never contracted into one fma). The slab is
// never rewritten, so FORM_PRE adds no shared-memory traffic; each element
// is transformed once for each row tap that reads it. What TMA zero-filled
// (past row hp - 1 or column tw - 1) lies outside the rim mask and gives
// zero.
struct PreF32 {
  const float* sa;  // (rows, Ci)
  const float* ta;
  float slope;
  int hp, tw;       // the input's rows and true width w_out + 1

  // thread t's scale and shift for the K step's channels c0 + 8 q .. c0 +
  // 8 q + 7 of sa / ta row `row` (q = t % 4: the channels tf32x3_step gives
  // it), their rim-mask group (a 32-channel chunk lies in one: Ci / 4 is a
  // multiple of 32) and the K step's column tap
  struct Operands {
    float4 s[2], t[2];
    int grp, tap;
  };

  __device__ __forceinline__ Operands operands(int64_t row, int ci, int c0,
                                               int tap, int t) const {
    const int64_t off = row * ci + c0 + 8 * (t & 3);
    const float4* ps = reinterpret_cast<const float4*>(sa + off);
    const float4* pt = reinterpret_cast<const float4*>(ta + off);
    return Operands{{__ldg(ps), __ldg(ps + 1)}, {__ldg(pt), __ldg(pt + 1)},
                    c0 / (ci >> 2), tap};
  }

  __device__ __forceinline__ float leaky(float x, float s, float t) const {
    const float v = __fadd_rn(__fmul_rn(x, s), t);
    return v >= 0.0f ? v : __fmul_rn(v, slope);
  }

  // v: the thread's 8 channels of slab row p of the tile whose first output
  // pixel is (i0, j0): input pixel (i0 + p / TW, j0 + tap + p % TW)
  __device__ __forceinline__ void apply(const Operands& o, int i0, int j0,
                                        int log_tw, int p,
                                        float4 (&v)[2]) const {
    const bool in = rim_ok(i0 + (p >> log_tw),
                           j0 + o.tap + (p & ((1 << log_tw) - 1)), hp, tw,
                           o.grp);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float4 s = o.s[c], t = o.t[c];
      v[c] = in ? make_float4(leaky(v[c].x, s.x, t.x), leaky(v[c].y, s.y, t.y),
                              leaky(v[c].z, s.z, t.z), leaky(v[c].w, s.w, t.w))
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
};

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

// The products of one K step on the fp32 operand path (3xTF32), for the
// consumer warpgroup whose slab is at sa, the stage's weights at sb: each
// row tap s and 8-channel slice kk takes A_hi * W_lo, A_lo * W_hi, then
// A_hi * W_hi (the small terms first) into acc. A comes from registers: the
// thread reads its pixels' fp32 channels from the landed slab (16 bytes at
// a time) and splits them (split_tf32); W_hi and W_lo were split once a
// call on the host side. The fragment's k order is the slab's permuted: a
// thread holds channels 8q .. 8q + 7 of a row (q = lane % 4), and slice
// kk's k columns q and q + 4 are channels 8q + kk and 8q + 4 + kk, the
// order in which tf32x3_weights lays out each 32-channel chunk of W. The
// three products of one (s, kk) are one wgmma group, and a group waits for
// the one before it, so that A's registers are live for two groups only.
// At its end the accumulator is waited for, added to the fp32 sums and left
// to start afresh, so all of the step's products are in sums when it
// returns. xform(s, half, v) sees (and FORM_PRE rewrites: PreF32::apply)
// the thread's 8 channels v of its pixel row `half` (of two) under row tap
// s before the split.
template <class Xform>
__device__ __forceinline__ void tf32x3_step(float (&acc)[64],
                                            float (&sums)[64], uint32_t sa,
                                            uint32_t sb, uint32_t tap_shift,
                                            int warp, int lane,
                                            const Xform& xform) {
  const int q = lane & 3, rq = lane >> 2;
  // row rq of warp `warp`'s 16, chunks 2q and 2q + 1 under the swizzle (rows
  // sit 128 bytes apart, every tile offset is a multiple of 8 rows)
  const uint32_t row0 = sa + (uint32_t)(warp * 16 + rq) * ROW_BYTES;
  const uint32_t ch0 = (uint32_t)(((2 * q) ^ rq) * 16);
  const uint32_t ch1 = (uint32_t)(((2 * q + 1) ^ rq) * 16);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    float4 v[2][2];  // [row half][chunk]
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t row = row0 + s * tap_shift + half * 8 * ROW_BYTES;
      v[half][0] = lds_f4(row + ch0);
      v[half][1] = lds_f4(row + ch1);
      xform(s, half, v[half]);
    }
#pragma unroll
    for (int kk = 0; kk < BK_F32 / 8; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // a[i]: row half i % 2, chunk i / 2 (k column q or q + 4)
        const float4& c = v[i & 1][i >> 1];
        const float x = kk == 0 ? c.x : kk == 1 ? c.y : kk == 2 ? c.z : c.w;
        split_tf32(x, hi[i], lo[i]);
      }
      const uint32_t tap = sb + s * B_TAP_F32_BYTES + kk * 32;
      const uint64_t dhi = desc_at(DESC_A, tap);
      const uint64_t dlo = desc_at(DESC_A, tap + B_TILE_F32_BYTES);
      wgmma_fence();  // the A registers were written by the split
      wgmma_m64n128k8_tf32(acc, hi, dlo, s | kk);
      wgmma_m64n128k8_tf32(acc, lo, dhi, 1);
      wgmma_m64n128k8_tf32(acc, hi, dhi, 1);
      wgmma_commit();
      wgmma_wait<1>();
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
#pragma unroll
  for (int i = 0; i < 64; ++i) sums[i] += acc[i];
}

// The products of one K step of an fp32 form with moment sums (exact_of),
// for the consumer warpgroup whose slab is at sa, the stage's W_hi / W_lo at
// sb and W's bf16 third part at sw3, a row tap at a time. The thread loads
// its channels as tf32x3_step does (xform as there) and splits each x
// three ways: A_hi, x rounded to the grid of its pixel row (2^-9 of the
// power of two of the row's largest magnitude over the 32 channels, which
// the row's 4 lanes share; adding and taking away 1.5 x 2^23 steps rounds
// to it, to nearest even), A_lo = x - A_hi in TF32, and x in TF32 itself
// (both rounded to nearest, ties away: a tie's sign follows a remainder's,
// which is as often negative as positive). A_lo * W_hi and x * W_lo of the
// 4 slices, with bf16 x times W's third part in the last group (two k16:
// slice t gives the thread's channels 8 q + 4 t + {0..3} for k 2 q, 2 q +
// 1, 2 q + 8, 2 q + 9, the order of tf32x3_exact_weights' third part), go
// to acc, which is added to the fp32 sums; then the 4 slices' A_hi * W_hi,
// exact on their grids (at most 2^10 x 2^9 steps each, 32 of them below
// 2^24), start acc afresh in one group, added to the sums once the next
// row tap has loaded. All of the step's products are in sums when it
// returns.
template <class Xform>
__device__ __forceinline__ void tf32x3_exact_step(
    float (&acc)[64], float (&sums)[64], uint32_t sa, uint32_t sb,
    uint32_t sw3, uint32_t tap_shift, int warp, int lane,
    const Xform& xform) {
  const int q = lane & 3, rq = lane >> 2;
  const uint32_t row0 = sa + (uint32_t)(warp * 16 + rq) * ROW_BYTES;
  const uint32_t ch0 = (uint32_t)(((2 * q) ^ rq) * 16);
  const uint32_t ch1 = (uint32_t)(((2 * q + 1) ^ rq) * 16);
  auto flush = [&] {
    wgmma_wait<0>();
    fence_acc(acc);
#pragma unroll
    for (int i = 0; i < 64; ++i) sums[i] += acc[i];
  };
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    float4 v[2][2];   // [row half][chunk]
    float magic[2];   // [row half]: 1.5 x 2^23 grid steps
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t row = row0 + s * tap_shift + half * 8 * ROW_BYTES;
      v[half][0] = lds_f4(row + ch0);
      v[half][1] = lds_f4(row + ch1);
      xform(s, half, v[half]);
      float m = 0.0f;
#pragma unroll
      for (int c = 0; c < 2; ++c)
        m = fmaxf(fmaxf(m, fmaxf(fabsf(v[half][c].x), fabsf(v[half][c].y))),
                  fmaxf(fabsf(v[half][c].z), fabsf(v[half][c].w)));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      magic[half] = __uint_as_float(
          ((__float_as_uint(m) & 0x7f800000u) + (14u << 23)) | 0x400000u);
    }
    // the row tap before's A_hi * W_hi ran while this one loaded
    if (s == 1) flush();
    // x of fragment element i of slice kk, and its A_hi
    auto elem = [&](int kk, int i) {
      const float4& c = v[i & 1][i >> 1];
      return kk == 0 ? c.x : kk == 1 ? c.y : kk == 2 ? c.z : c.w;
    };
    auto grid = [&](float x, int i) {
      return __fsub_rn(__fadd_rn(x, magic[i & 1]), magic[i & 1]);
    };
#pragma unroll
    for (int kk = 0; kk < BK_F32 / 8; ++kk) {
      uint32_t lo[4], x32[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = elem(kk, i);
        asm("cvt.rna.tf32.f32 %0, %1;\n"
            : "=r"(lo[i])
            : "f"(__fsub_rn(x, grid(x, i))));
        asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(x32[i]) : "f"(x));
      }
      const uint32_t tap = sb + s * B_TAP_F32_BYTES + kk * 32;
      wgmma_fence();
      wgmma_m64n128k8_tf32(acc, lo, desc_at(DESC_A, tap), kk);
      wgmma_m64n128k8_tf32(acc, x32, desc_at(DESC_A, tap + B_TILE_F32_BYTES),
                           1);
      if (kk == BK_F32 / 8 - 1) {
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const uint32_t ab[4] = {bf16x2_rn(v[0][t].x, v[0][t].y),
                                  bf16x2_rn(v[1][t].x, v[1][t].y),
                                  bf16x2_rn(v[0][t].z, v[0][t].w),
                                  bf16x2_rn(v[1][t].z, v[1][t].w)};
          wgmma_m64n128k16_rs(
              acc, ab,
              desc_at(DESC_B, sw3 + (uint32_t)(32 * s + 16 * t) * 128), 1);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
    }
    uint32_t hi[BK_F32 / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK_F32 / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        hi[kk][i] = __float_as_uint(grid(elem(kk, i), i));
    flush();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK_F32 / 8; ++kk)
      wgmma_m64n128k8_tf32(
          acc, hi[kk], desc_at(DESC_A, sb + s * B_TAP_F32_BYTES + kk * 32),
          kk);
    wgmma_commit();
  }
  flush();
}

// Conv supplies the tap geometry:
//   int ksteps(int img) const            K steps (column tap and the other
//                                        tap axes, channel chunk: 64, 32 on
//                                        the fp32 path) of an image's tiles;
//   void load_a(map0, map1, ks, img, i0, j0, dst, bar) const
//                                        the TMA load of K step ks's slab
//                                        (row tap s = 0 and, one image row
//                                        down, s = 1) for the tile whose
//                                        first output pixel is (i0, j0) of
//                                        image img;
//   int w_row(int ks, int img, int s) const
//                                        first row of the (taps*Ci, Co)
//                                        weight matrix for row tap s of the
//                                        K step (on the fp32 path, the first
//                                        column of the split (2 Co, taps*Ci)
//                                        matrix).
// and, for a deferred-norm form, static constexpr int FORM and
//   StatsOut so                          (FORM_STATS) where the sums go;
//   auto pre_operands(ks, img, t) const  (FORM_PRE) what thread t of the
//                                        128 of the warpgroup needs from
//                                        device memory for K step ks,
//                                        asked for before the slab's wait;
//   void transform(operands, ks, img, i0, j0, slab, log_tw, t) const
//                                        (FORM_PRE, bf16) thread t rewrites
//                                        its share of the landed slab;
//   void apply(operands, i0, j0, log_tw, p, v) const
//                                        (FORM_PRE, fp32: PreF32) the
//                                        transform of the thread's channels
//                                        v of slab row p, in registers;
// and, for the fp32 operand path, static constexpr bool TF32X3 = true.
template <class Conv, int CLUSTER, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap map_a0,
                  const __grid_constant__ CUtensorMap map_a1,
                  const __grid_constant__ CUtensorMap map_w,
                  const __grid_constant__ CUtensorMap map_w3, const Conv conv,
                  const TileGeo g, const elem_of<Conv>* __restrict__ bias,
                  elem_of<Conv>* __restrict__ y) {
  static_assert(CLUSTER == 1 || CLUSTER == 2, "each block loads 1/CLUSTER "
                                              "of the weight tile's 2 boxes");
  constexpr int FORM = form_of<Conv>::value;
  constexpr bool F32 = tf32x3_of<Conv>::value;
  static_assert(!F32 || CLUSTER == 1, "fp32: one block per cluster");
  constexpr bool EXACT = exact_of<Conv>;
  // a consumer warpgroup's pixels; a tap's weights: two boxes, the two
  // 64-channel halves of the N-major tile (bf16) or W_hi and W_lo (fp32)
  constexpr int TPIX = F32 ? TILE_PIX_F32 : TILE_PIX;
  constexpr int SLAB = F32 ? SLAB_F32_BYTES : SLAB_BYTES;
  constexpr int B_TAP = F32 ? B_TAP_F32_BYTES : B_TAP_BYTES;
  constexpr int B_BOX = B_TAP / 2;
  constexpr int STAGE = stage_bytes_of<Conv>;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the ring to it
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = ring + STAGES * STAGE;
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
  const uint32_t slab_bytes = TPIX * ROW_BYTES + tap_shift;

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
          const uint32_t sa = ring + stage * STAGE;
          const uint32_t sb = sa + 2 * SLAB;
          mbar_expect_tx(bar,
                         2 * slab_bytes + 2 * B_TAP + (EXACT ? W3_BYTES : 0));
          conv.load_a(&map_a0, &map_a1, ks, img, i0a, j0a, sa, bar);
          conv.load_a(&map_a0, &map_a1, ks, img, i0b, j0b, sa + SLAB, bar);
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const int wr = conv.w_row(ks, img, s);
            const uint32_t st = sb + s * B_TAP;
            // box h of the tap: (channel, k row) n0 + 64 h, wr of the
            // N-major matrix; (k, row) wr, h co + n0 of the split one
            auto c0 = [&](int h) { return F32 ? wr : n0 + 64 * h; };
            auto c1 = [&](int h) { return F32 ? h * g.co + n0 : wr; };
            if constexpr (CLUSTER == 1) {
              tma_load_2d(st, &map_w, bar, c0(0), c1(0));
              tma_load_2d(st + B_BOX, &map_w, bar, c0(1), c1(1));
            } else {
              tma_load_2d_multicast(st + rank * B_BOX, &map_w, bar,
                                    c0((int)rank), c1((int)rank),
                                    (uint16_t)((1 << CLUSTER) - 1));
            }
            if constexpr (EXACT) {
              // W's third part: row tap s's 32 k-rows of each 64-channel box
              const uint32_t w3 = sb + 2 * B_TAP + s * BK_F32 * 128;
              tma_load_2d(w3, &map_w3, bar, n0, wr);
              tma_load_2d(w3 + B_HALF_BYTES, &map_w3, bar, n0 + 64, wr);
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
    // bf16: the tile's sums, 128 pixels in two halves; fp32: the sums of
    // one K step, 64 pixels, added to `sums` after it (the tensor cores'
    // fp32 accumulation truncates: summed over all of K = 1024 the products
    // lost up to 5e-5 of the output; flushed every step, 1.1e-5)
    float acc[F32 ? 1 : 2][64];
    float sums[F32 ? 64 : 1];
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
      if constexpr (F32) {
#pragma unroll
        for (int i = 0; i < 64; ++i) sums[i] = 0.0f;
      }
      for (int ks = 0; ks < ks_n; ++ks) {
        if constexpr ((FORM & FORM_PRE) != 0 && !F32)
          land_and_transform(conv, ks, img, i0, j0, full(stage), phase,
                             ring + stage * STAGE + wg * SLAB, g.log_tw, wg,
                             tid % 128);
        else if constexpr (!F32)
          mbar_wait(full(stage), phase);
        const uint32_t sa = ring + stage * STAGE + wg * SLAB;
        const uint32_t sb = ring + stage * STAGE + 2 * SLAB;
        if constexpr (F32) {
          auto step = [&](const auto& xform) {
            if constexpr (EXACT)
              tf32x3_exact_step(acc[0], sums, sa, sb, sb + 2 * B_TAP,
                                tap_shift, warp, lane, xform);
            else
              tf32x3_step(acc[0], sums, sa, sb, tap_shift, warp, lane,
                          xform);
          };
          if constexpr ((FORM & FORM_PRE) != 0) {
            // the transform in registers, as the step loads A
            const auto o = conv.pre_operands(ks, img, tid % 128);
            mbar_wait(full(stage), phase);
            step([&](int s, int half, float4(&v)[2]) {
              conv.apply(o, i0, j0, g.log_tw,
                         warp * 16 + half * 8 + (lane >> 2) + (s << g.log_tw),
                         v);
            });
          } else {
            mbar_wait(full(stage), phase);
            step([](int, int, float4(&)[2]) {});
          }
          release(stage);  // the step has waited for all its products
        } else {
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
                    desc_at(DESC_A, sa + s * tap_shift +
                                        mi * 64 * ROW_BYTES + kk * 32),
                    db, (ks | s | kk) != 0);
            }
          }
          wgmma_commit();
          if (ks > 0) {  // the step before has been read: hand its stage back
            wgmma_wait<1>();
            release(prev);
          }
        }
        prev = stage;
        if (++stage == STAGES) { stage = 0; phase ^= 1u; }
      }
      wgmma_wait<0>();
      if constexpr (!F32) release(prev);
      const uint32_t scratch = bars + 16u * STAGES + wg * 4096u;
      if constexpr (F32) {
        StatsOut so{};
        if constexpr (FORM != 0) so = conv.so;
        store_tile_f32<FORM>(sums, g, img, i0, j0, n0, tile, bias, y, so,
                             scratch, 1 + wg, warp, lane);
      } else {
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        if constexpr ((FORM & (FORM_STATS | FORM_RIM)) != 0)
          store_tile_fused<FORM>(acc, g, img, i0, j0, n0, tile, bias, y,
                                 conv.so, scratch, 1 + wg, warp, lane);
        else
          store_tile(acc, g, img, i0, j0, n0, true, bias, y, warp, lane);
      }
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

// a tensor map (bf16 unless named) with the 128-byte swizzle: dims and box
// innermost first, strides in bytes for dims 1.. (dim 0 is contiguous)
inline int make_map(
    CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
    const uint64_t* strides, const uint32_t* box,
    CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (!fn) return ERR_NO_ENCODE_ENTRY;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r =
      fn(map, dtype, (cuuint32_t)rank,
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

// the fp32 operand path's split weights, (2 co, k_cols) fp32 K-major (W_hi
// rows 0..co, W_lo rows co..2 co), in boxes of 128 rows x 32 k
inline int make_weight_map_f32(CUtensorMap* map, const void* w,
                               int64_t k_cols, int co) {
  const uint64_t dims[2] = {(uint64_t)k_cols, (uint64_t)co * 2};
  const uint64_t strides[1] = {(uint64_t)k_cols * 4};
  const uint32_t box[2] = {BK_F32, BN};
  return make_map(map, w, 2, dims, strides, box,
                  CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// the exact fp32 forms' third weight part, (k_rows, co) bf16 N-major (rows
// of a 32-channel chunk in the order of tf32x3_exact_step's bf16 A
// fragments), in boxes of 32 k-rows x 64 channels
inline int make_third_map(CUtensorMap* map, const void* w3, int64_t k_rows,
                          int co) {
  const uint64_t dims[2] = {(uint64_t)co, (uint64_t)k_rows};
  const uint64_t strides[1] = {(uint64_t)co * 2};
  const uint32_t box[2] = {64, BK_F32};
  return make_map(map, w3, 2, dims, strides, box);
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

// Tile an (out_h, out_w) output image by rectangles of tile_pix (128, or 64
// on the fp32 path) pixels 8, 16 or 32 wide; log_tw < 0 picks the width
// that covers it with the fewest tiles.
inline int make_geo(TileGeo* g, int n_img, int out_h, int out_w, int live_w,
                    int co, int cluster, int log_tw,
                    int tile_pix = TILE_PIX) {
  auto tiles = [&](int l) {
    const int tw = 1 << l, th = tile_pix >> l;
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
  *g = TileGeo{n_img, out_h, out_w, live_w, co, log_tw, tile_pix >> log_tw,
               (out_w + tw - 1) / tw, (int)units, co / BN, (int)items};
  return 0;
}

// w3: W's bf16 third part (make_third_map), for the exact fp32 forms only
template <class Conv, int CLUSTER, int STAGES>
int launch_conv(const CUtensorMap& a0, const CUtensorMap& a1,
                const CUtensorMap& w, const Conv& conv, const TileGeo& g,
                const void* bias, void* y, cudaStream_t stream,
                const CUtensorMap* w3 = nullptr) {
  if (exact_of<Conv> != (w3 != nullptr)) return (int)cudaErrorInvalidValue;
  auto kern = conv_wgmma_kernel<Conv, CLUSTER, STAGES>;
  constexpr int smem =
      smem_bytes(STAGES, form_of<Conv>::value, stage_bytes_of<Conv>);
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
  const CUtensorMap none = {};
  e = cudaLaunchKernelEx(&cfg, kern, a0, a1, w, w3 ? *w3 : none, conv, g,
                         (const elem_of<Conv>*)bias, (elem_of<Conv>*)y);
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

// the fp32 operand path's FORM_PRE operands: sa, ta (rows, Ci) fp32, the
// leaky slope, the input's rows and true width
inline void set_pre_f32(PreF32& p, const void* sa, const void* ta,
                        float slope, int hp, int tw) {
  p.sa = (const float*)sa;
  p.ta = (const float*)ta;
  p.slope = slope;
  p.hp = hp;
  p.tw = tw;
}

// a deferred-norm form's FORM_PRE operands: sa, ta (rows, Ci) bf16, the
// leaky slope (a bf16 value), the input's rows and true width, and the
// measuring form (PreSlab::measure; 0 none)
inline void set_pre(PreSlab& p, const void* sa, const void* ta, float slope,
                    int hp, int tw, int measure) {
  p.sa = (const bf16*)sa;
  p.ta = (const bf16*)ta;
  p.slope2 = bf16x2_bits(slope);
  p.hp = hp;
  p.tw = tw;
  p.max_form = slope >= 0.0f && slope <= 1.0f;
  p.measure = measure;
}

}  // namespace sm90
