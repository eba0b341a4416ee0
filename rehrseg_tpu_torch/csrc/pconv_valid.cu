// K3 and K5: offset -> aligned VALID 2x2 packed conv + bias, kd in {1, 3};
// K6b and K6c: their deferred-norm forms; K7: the same conv on exact widths.
// (The bf16 forms of K3, K5, K6c and K7 run the Hopper kernels of
// pconv2d_sm90.cu and pconv3_valid_sm90.cu; the bf16 kernel here runs K6b,
// the kd = 1 deferred-norm forms, alone; the fp32 kernel every form.)
//
// Replaces the TPU kernels rehrseg_tpu/ops/pallas_pconv.py pconv_valid
// (:519, body _valid_kernel :75; deferred-norm body _valid_fused_kernel
// :148) for kd = 1, pconv3_valid (:1117, body _valid3_kernel :930) for
// kd = 3, and rehrseg_tpu/ops/pallas_conv.py conv2x2_valid_bias (:126, body
// _kernel :34). With du = u - kd/2:
//
//   y[b, z, i, j, co] = b[co] + sum_{u < kd} sum_{s,t in {0,1}} sum_c
//                       xin[b, z+du, i+s, j+t, c] * W[u, s, t, c, co]
//   for i in [0, hp-1), j in [0, w_out); xin outside [0, D) in z is zero
//
// where xin = x, or with PRE (K6b, K6c: the producer deferred its instance
// norm) xin = leaky(x * sa[b] + ta[b]) * rim_mask, computed in x's type
// with a rounding after the multiply, the add and the leaky product;
// rim_mask is the offset rim mask of the input's true width w_out + 1
// (row, column and channel group g = c / (Ci/4), dy = g/2, dx = g%2). z taps
// outside [0, D) stay zero: the transform runs only on loaded data. sa, ta
// are (B, Ci), one row per batch element (the wrapper passes row 0 of
// JAX's (., 8, Ci) layout; for kd = 1, D is folded into B, so one row per
// image). With STATS the kernel also accumulates the sum and the sum of
// squares of every stored (rounded) output over each (b, z) image into
// stats (B*D, 16, Co) fp32, zeroed by the wrapper: rows 0:8 sums, rows 8:16
// squares, row (block % 8) of each half, so that atomics from neighbouring
// blocks land on different addresses.
//
// x (B, D, hp, wp8, Ci) offset-packed, stored wp8 wide: only its true
// columns 0..w_out are read, whatever the pad columns hold. W (kd, 2, 2,
// Ci, Co), b (Co), y (B, D, hp-1, w_out, Co), all contiguous channels-last.
// kd = 1 is the same kernel with D folded into B by the caller. What the
// kernels need: w_out + 1 <= wp8 and Ci, Co % 128 == 0 (16-byte rows of
// channels). The K3/K5/K6 wrappers also keep JAX's wp8 % 8 == 0 and
// w_out % 8 == 0; K7 (conv2x2_valid_bias_*) launches the kd = 1 kernel on
// an exact-width input, wp8 = w + 1 and w_out = w, which need no alignment.
//
// What bounds it on the H100: at the served shapes K3/K6b (128, 161, 200,
// 128 -> 128, kd 1) do 0.52 TFLOP and must move about 2.03 GB (bytes bound
// it, just); K5/K6c (8, 16, 81, 104, 256 -> 256, kd 3) do 1.48 TFLOP on
// about 1.06 GB (the tensor-core rate bounds it). The design is an implicit
// GEMM: M = output pixels on a virtual grid w_out + 1 columns wide (the
// extra column is computed and dropped), N = Co, K = kd x 2 kernel rows x
// Ci. A block computes 128 pixels x 128 channels; a K step is one
// 32-channel slice of one (z tap, kernel row) pair. Both column taps t
// share one input slab in shared memory: slab row q holds virtual pixel
// m0 + q, and tap t of output row r is slab row r + t, because the virtual
// row is one column wider than the output, so pixel r + 1 is always column
// j + 1 of the same image row for every pixel that is stored. Slabs and
// weights arrive by cp.async (zero fill for z taps outside [0, D): z-SAME)
// through a 3-stage pipeline; with PRE each thread transforms the slab
// chunks it copied, in shared memory, once they land and before the
// barrier that hands the stage to the tensor cores, so the normalize pass
// over device memory never happens. WMMA (mma.sync, bf16 in, fp32
// accumulate) consumes the slabs. Weights stream through the K loop (K5's
// 1.5 MB never sit in shared memory at once). The bias is added in fp32
// before the one rounding to bf16. STATS reduces each warp's 16 x 16
// output fragment column by column in shared memory into a per-block
// (2 images x Co) sum, flushed with one atomic per value. 64 accumulators a
// thread and two blocks per SM (at most 128 registers). The plain bf16 forms
// (no PRE, no STATS) and every bf16 kd = 3 form have their own wgmma / TMA
// kernels, kd = 3 in pconv3_valid_sm90.cu and kd = 1 (K3, K7) in
// pconv2d_sm90.cu, and are not instantiated here.
//
// fp32 inputs take a plain FMA kernel (64 x 64 tiles, one tap per step),
// with the same PRE and STATS forms.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

struct Geo {
  int nb, nd, hp, wp8, ci, co, w_out;
};

// The deferred-norm operands: sa, ta (B, Ci) in x's type, stats (B*D, 16,
// Co) fp32, the leaky slope (already rounded to x's type by the wrapper).
template <typename T>
struct Fused {
  const T* sa;
  const T* ta;
  float* stats;
  float slope;
};

// ops/pack2d.py offset_rim_mask: is (row, col) of channel group g inside
// the image, for an offset tensor hp rows high and tw columns true width?
__device__ __forceinline__ bool rim_ok(int row, int col, int hp, int tw,
                                       int g) {
  const int dy = g >> 1, dx = g & 1;
  return (row > 0 || dy == 1) && (row < hp - 1 || dy == 0) &&
         (col > 0 || dx == 1) && (col < tw - 1 || dx == 0) && col < tw;
}

// leaky(x * s + t) with a rounding to bf16 after each operation
__device__ __forceinline__ bf16 pre_bf16(bf16 x, bf16 s, bf16 t,
                                         float slope) {
  const float p = __bfloat162float(__float2bfloat16_rn(
      __fmul_rn(__bfloat162float(x), __bfloat162float(s))));
  const float q = __bfloat162float(
      __float2bfloat16_rn(__fadd_rn(p, __bfloat162float(t))));
  return __float2bfloat16_rn(q >= 0.0f ? q : __fmul_rn(q, slope));
}

__device__ __forceinline__ float pre_f32(float x, float s, float t,
                                         float slope) {
  const float q = __fadd_rn(__fmul_rn(x, s), t);
  return q >= 0.0f ? q : __fmul_rn(q, slope);
}

// ------------------------------------------------------------ bf16 / WMMA

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int A_LD = 48;                  // 96 B pitch: row offsets stay 32 B aligned
constexpr int A_STAGE = (BM + 8) * A_LD;  // >= BM + 1 slab rows (elements)
constexpr int B_LD = BN + 8;              // 272 B pitch
constexpr int B_STAGE = 2 * BK * B_LD;    // both column taps
constexpr int SMEM = STAGES * (A_STAGE + B_STAGE) * (int)sizeof(bf16);
constexpr int MI = BM / 4 / 16;           // warp tile rows / 16
constexpr int LOADS = ((BM + 1) * 4 + THREADS - 1) / THREADS;
// epilogue scratch, as floats from the start of shared memory: 8 warps x
// one 16 x 16 fragment, then the per-block stats (2 image slots x {sum,
// square} x BN), then each warp's 16 row slots (ints)
constexpr int ST_OFF = 8 * 256;
constexpr int RS_OFF = ST_OFF + 2 * 2 * BN;
static_assert((RS_OFF + 8 * 16) * 4 <= SMEM, "epilogue scratch");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  int n = valid ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int KD, bool PRE, bool STATS>
__global__ void __launch_bounds__(THREADS, 2)
valid_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ W,
                  const bf16* __restrict__ bias, bf16* __restrict__ y,
                  Geo g, Fused<bf16> fz) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = As + STAGES * A_STAGE;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp % 4, wn = warp / 4;  // warp tile: BM/4 rows x 64 cols
  const int ho = g.hp - 1, wv = g.w_out + 1;
  const int64_t M = (int64_t)g.nb * g.nd * ho * wv;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int kchunks = g.ci / BK;
  const int KT = KD * 2 * kchunks;  // (z tap, kernel row s, channel chunk)
  const int64_t row_stride = (int64_t)g.wp8 * g.ci;
  const int64_t z_stride = (int64_t)g.hp * row_stride;

  // this thread's slab rows, decoded once: load l covers slab row
  // q = (tid + l*THREADS) / 4 (virtual pixel m0 + q), 16-byte chunk tid % 4
  const int a_chunk = tid % 4;
  int64_t a_base[LOADS];
  int a_z[LOADS];
  bool a_ok[LOADS];
  // PRE: the row's batch element, and its rim mask as bits s * 4 + group
  // (input row i + s, column jv, channel group 0..3)
  int a_b[LOADS], a_rim[LOADS];
#pragma unroll
  for (int l = 0; l < LOADS; ++l) {
    const int q = (tid + l * THREADS) / 4;
    const int64_t m = m0 + q;
    a_ok[l] = q <= BM && m < M;
    const int64_t mm = a_ok[l] ? m : 0;
    const int jv = (int)(mm % wv);
    const int64_t r = mm / wv;
    const int i = (int)(r % ho);
    const int64_t img = r / ho;  // b * D + z
    a_z[l] = (int)(img % g.nd);
    a_base[l] = ((img * g.hp + i) * g.wp8 + jv) * g.ci + a_chunk * 8;
    if constexpr (PRE) {
      a_b[l] = (int)(img / g.nd);
      int bits = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b)
        if (rim_ok(i + b / 4, jv, g.hp, g.w_out + 1, b % 4)) bits |= 1 << b;
      a_rim[l] = bits;
    }
  }

  auto load = [&](int stage, int kt) {
    const int c0 = (kt % kchunks) * BK;
    const int us = kt / kchunks;
    const int u = us / 2, s = us % 2;
    const int du = u - KD / 2;
    bf16* as = As + stage * A_STAGE;
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      const int q = (tid + l * THREADS) / 4;
      if (q <= BM) {
        const int zz = a_z[l] + du;
        const bool ok = a_ok[l] && zz >= 0 && zz < g.nd;
        const bf16* p =
            ok ? x + a_base[l] + du * z_stride + s * row_stride + c0 : x;
        cp_async16(as + q * A_LD + a_chunk * 8, p, ok);
      }
    }
    bf16* bs = Bs + stage * B_STAGE;
#pragma unroll
    for (int l = 0; l < 4; ++l) {  // 2 taps x 32 rows x 16 chunks
      const int idx = tid + l * THREADS;
      const int t = idx / (BK * 16);
      const int kr = (idx / 16) % BK;
      const int ch = idx % 16;
      const bf16* p =
          W + ((int64_t)((u * 2 + s) * 2 + t) * g.ci + c0 + kr) * g.co + n0 +
          ch * 8;
      cp_async16(bs + (t * BK + kr) * B_LD + ch * 8, p, true);
    }
  };

  // PRE: transform the slab chunks this thread copied into stage kt (its
  // own cp.async copies are complete after the wait); rows that were zero
  // filled stay zero
  auto transform = [&](int stage, int kt) {
    const int c0 = (kt % kchunks) * BK;
    const int us = kt / kchunks;
    const int u = us / 2, s = us % 2;
    const int du = u - KD / 2;
    const int c = c0 + a_chunk * 8;
    const int grp = c / (g.ci / 4);
    bf16* as = As + stage * A_STAGE;
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      const int q = (tid + l * THREADS) / 4;
      const int zz = a_z[l] + du;
      if (q > BM || !a_ok[l] || zz < 0 || zz >= g.nd) continue;
      uint4* p = reinterpret_cast<uint4*>(as + q * A_LD + a_chunk * 8);
      if (!((a_rim[l] >> (s * 4 + grp)) & 1)) {
        *p = make_uint4(0u, 0u, 0u, 0u);
        continue;
      }
      uint4 v = *p;
      const uint4 sv = *reinterpret_cast<const uint4*>(
          fz.sa + (int64_t)a_b[l] * g.ci + c);
      const uint4 tv = *reinterpret_cast<const uint4*>(
          fz.ta + (int64_t)a_b[l] * g.ci + c);
      bf16* xe = reinterpret_cast<bf16*>(&v);
      const bf16* se = reinterpret_cast<const bf16*>(&sv);
      const bf16* te = reinterpret_cast<const bf16*>(&tv);
#pragma unroll
      for (int e = 0; e < 8; ++e) xe[e] = pre_bf16(xe[e], se[e], te[e], fz.slope);
      *p = v;
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) wmma::fill_fragment(acc[mi][ni], 0.0f);

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < KT) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    if constexpr (PRE) transform(kt % STAGES, kt);
    __syncthreads();  // stage kt landed; stage kt-1 is free for reuse
    const int nxt = kt + STAGES - 1;
    if (nxt < KT) load(nxt % STAGES, nxt);
    cp_async_commit();
    const bf16* as = As + (kt % STAGES) * A_STAGE;
    const bf16* bs = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
            bfr[4];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          wmma::load_matrix_sync(
              bfr[ni], bs + (t * BK + kk) * B_LD + wn * 64 + ni * 16, B_LD);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
              af;
          wmma::load_matrix_sync(
              af, as + (wm * (BM / 4) + mi * 16 + t) * A_LD + kk, A_LD);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            wmma::mma_sync(acc[mi][ni], af, bfr[ni], acc[mi][ni]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the pipeline's smem becomes epilogue scratch

  float* const smem_f = reinterpret_cast<float*>(smem_raw);
  float* cs = smem_f + warp * 256;
  float* st = smem_f + ST_OFF;  // [slot][sum, square][BN]
  int* rs = reinterpret_cast<int*>(smem_f + RS_OFF) + warp * 16;
  const int64_t n_img = (int64_t)g.nb * g.nd;
  const int64_t img_lo = (m0 / wv) / ho;
  if constexpr (STATS) {
    for (int i = tid; i < 2 * 2 * BN; i += THREADS) st[i] = 0.0f;
    __syncthreads();
  }
  const int r = lane / 2, cpart = (lane % 2) * 8;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      wmma::store_matrix_sync(cs, acc[mi][ni], 16, wmma::mem_row_major);
      __syncwarp();
      const int64_t m = m0 + wm * (BM / 4) + mi * 16 + r;
      const int co = n0 + wn * 64 + ni * 16 + cpart;
      int slot = -1;  // STATS: the row's image - img_lo, -1 if not stored
      if (m < M) {
        const int jv = (int)(m % wv);
        if (jv < g.w_out) {  // the virtual column w_out is dropped
          const int64_t o = ((m / wv) * g.w_out + jv) * g.co + co;
          __align__(16) __nv_bfloat162 out[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v0 = cs[r * 16 + cpart + 2 * e] +
                             __bfloat162float(bias[co + 2 * e]);
            const float v1 = cs[r * 16 + cpart + 2 * e + 1] +
                             __bfloat162float(bias[co + 2 * e + 1]);
            out[e] = __floats2bfloat162_rn(v0, v1);
            if constexpr (STATS) {  // the stored, rounded values
              cs[r * 16 + cpart + 2 * e] = __low2float(out[e]);
              cs[r * 16 + cpart + 2 * e + 1] = __high2float(out[e]);
            }
          }
          *reinterpret_cast<uint4*>(y + o) =
              *reinterpret_cast<const uint4*>(out);
          slot = (int)((m / wv) / ho - img_lo);
        }
      }
      if constexpr (STATS) {
        if (cpart == 0) rs[r] = slot;
        __syncwarp();
        // lanes 0-15 sum column lane, lanes 16-31 sum its squares
        const int c = lane & 15, kind = lane >> 4;
        const int col = wn * 64 + ni * 16 + c;
        float a0 = 0.0f, a1 = 0.0f;
        for (int rr = 0; rr < 16; ++rr) {
          const int sl = rs[rr];
          if (sl < 0) continue;
          float v = cs[rr * 16 + c];
          if (kind) v *= v;
          if (sl == 0) {
            a0 += v;
          } else if (sl == 1) {
            a1 += v;
          } else {  // a block over more than two images (small shapes)
            atomicAdd(fz.stats +
                          ((img_lo + sl) * 16 + kind * 8) * g.co + n0 + col,
                      v);
          }
        }
        atomicAdd(st + kind * BN + col, a0);
        atomicAdd(st + (2 + kind) * BN + col, a1);
      }
      __syncwarp();
    }
  }
  if constexpr (STATS) {
    __syncthreads();
    for (int i = tid; i < 2 * 2 * BN; i += THREADS) {
      const int64_t img = img_lo + i / (2 * BN);
      const int kind = (i / BN) % 2;
      if (img < n_img && st[i] != 0.0f)
        atomicAdd(fz.stats + (img * 16 + kind * 8 + blockIdx.x % 8) * g.co +
                      n0 + i % BN,
                  st[i]);
    }
  }
}

// ------------------------------------------------------------ fp32 / FMA

constexpr int FBM = 64, FBN = 64, FBK = 16;

template <int KD, bool PRE, bool STATS>
__global__ void __launch_bounds__(256)
valid_f32_kernel(const float* __restrict__ x, const float* __restrict__ W,
                 const float* __restrict__ bias, float* __restrict__ y,
                 Geo g, Fused<float> fz) {
  __shared__ __align__(16) float As[FBK][FBM + 4];  // k-major: broadcast rows
  __shared__ __align__(16) float Bs[FBK][FBN];
  __shared__ float st[2][2][FBN];  // STATS: [slot][sum, square][column]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // 4x4 outputs per thread
  const int ho = g.hp - 1;
  const int64_t M = (int64_t)g.nb * g.nd * ho * g.w_out;
  const int64_t m0 = (int64_t)blockIdx.x * FBM;
  const int n0 = blockIdx.y * FBN;
  const int kchunks = g.ci / FBK;
  const int KT = KD * 4 * kchunks;  // (tap, channel chunk)
  const int64_t row_stride = (int64_t)g.wp8 * g.ci;
  const int64_t z_stride = (int64_t)g.hp * row_stride;

  const int ar = tid / 4, ak = (tid % 4) * 4;
  const int64_t am = m0 + ar;
  const bool a_ok = am < M;
  const int64_t amm = a_ok ? am : 0;
  const int a_j = (int)(amm % g.w_out);
  const int64_t a_r = amm / g.w_out;
  const int a_i = (int)(a_r % ho);
  const int64_t a_img = a_r / ho;
  const int a_z = (int)(a_img % g.nd);
  const int64_t a_base = ((a_img * g.hp + a_i) * g.wp8 + a_j) * g.ci + ak;
  const int bk = tid / 16, bc = (tid % 16) * 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int kt = 0; kt < KT; ++kt) {
    const int tap = kt / kchunks;  // (u * 2 + s) * 2 + t
    const int du = tap / 4 - KD / 2, s = (tap / 2) % 2, t = tap % 2;
    const int c0 = (kt % kchunks) * FBK;
    const int zz = a_z + du;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a_ok && zz >= 0 && zz < g.nd) {
      v = *reinterpret_cast<const float4*>(
          x + a_base + du * z_stride + s * row_stride + t * g.ci + c0);
      if constexpr (PRE) {
        const int c = c0 + ak;
        if (rim_ok(a_i + s, a_j + t, g.hp, g.w_out + 1, c / (g.ci / 4))) {
          const int64_t sb = (a_img / g.nd) * g.ci + c;
          v.x = pre_f32(v.x, fz.sa[sb], fz.ta[sb], fz.slope);
          v.y = pre_f32(v.y, fz.sa[sb + 1], fz.ta[sb + 1], fz.slope);
          v.z = pre_f32(v.z, fz.sa[sb + 2], fz.ta[sb + 2], fz.slope);
          v.w = pre_f32(v.w, fz.sa[sb + 3], fz.ta[sb + 3], fz.slope);
        } else {
          v = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
    As[ak + 0][ar] = v.x;
    As[ak + 1][ar] = v.y;
    As[ak + 2][ar] = v.z;
    As[ak + 3][ar] = v.w;
    *reinterpret_cast<float4*>(&Bs[bk][bc]) = *reinterpret_cast<const float4*>(
        W + ((int64_t)tap * g.ci + c0 + bk) * g.co + n0 + bc);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int64_t n_img = (int64_t)g.nb * g.nd;
  const int64_t img_lo = (m0 / g.w_out) / ho;
  if constexpr (STATS) {
    for (int i = tid; i < 2 * 2 * FBN; i += 256) (&st[0][0][0])[i] = 0.0f;
    __syncthreads();
  }
  const int co = n0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
    if (m >= M) continue;
    const float4 o =
        make_float4(acc[i][0] + bias[co], acc[i][1] + bias[co + 1],
                    acc[i][2] + bias[co + 2], acc[i][3] + bias[co + 3]);
    *reinterpret_cast<float4*>(y + m * g.co + co) = o;
    if constexpr (STATS) {
      const int64_t sl = (m / g.w_out) / ho - img_lo;
      const float vals[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (sl < 2) {
          atomicAdd(&st[sl][0][tx * 4 + j], vals[j]);
          atomicAdd(&st[sl][1][tx * 4 + j], vals[j] * vals[j]);
        } else {
          float* p = fz.stats + (img_lo + sl) * 16 * g.co + co + j;
          atomicAdd(p, vals[j]);
          atomicAdd(p + 8 * g.co, vals[j] * vals[j]);
        }
      }
    }
  }
  if constexpr (STATS) {
    __syncthreads();
    for (int i = tid; i < 2 * 2 * FBN; i += 256) {
      const int64_t img = img_lo + i / (2 * FBN);
      const int kind = (i / FBN) % 2;
      const float v = (&st[0][0][0])[i];
      if (img < n_img && v != 0.0f)
        atomicAdd(fz.stats + (img * 16 + kind * 8 + blockIdx.x % 8) * g.co +
                      n0 + i % FBN,
                  v);
    }
  }
}

template <int KD, bool PRE, bool STATS>
int launch_bf16(const void* x, const void* w, const void* b, void* y, Geo g,
                Fused<bf16> fz, cudaStream_t stream) {
  // above 48 KB, dynamic shared memory has to be asked for
  cudaError_t e = cudaFuncSetAttribute(
      valid_bf16_kernel<KD, PRE, STATS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const int64_t M = (int64_t)g.nb * g.nd * (g.hp - 1) * (g.w_out + 1);
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(g.co / BN));
  valid_bf16_kernel<KD, PRE, STATS><<<grid, THREADS, SMEM, stream>>>(
      (const bf16*)x, (const bf16*)w, (const bf16*)b, (bf16*)y, g, fz);
  return (int)cudaGetLastError();
}

template <int KD, bool PRE, bool STATS>
int launch_f32(const void* x, const void* w, const void* b, void* y, Geo g,
               Fused<float> fz, cudaStream_t stream) {
  const int64_t M = (int64_t)g.nb * g.nd * (g.hp - 1) * g.w_out;
  dim3 grid((unsigned)((M + FBM - 1) / FBM), (unsigned)(g.co / FBN));
  valid_f32_kernel<KD, PRE, STATS><<<grid, 256, 0, stream>>>(
      (const float*)x, (const float*)w, (const float*)b, (float*)y, g, fz);
  return (int)cudaGetLastError();
}

// the kernel for (kd, pre, stats): each combination is its own
// instantiation, so a profile tells the plain and the deferred-norm
// forms apart
template <typename T, int KD>
int launch_any(const void* x, const void* w, const void* b, void* y, Geo g,
               Fused<T> fz, bool pre, bool stats, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    // bf16 kd = 3 is pconv3_valid_sm90.cu's, the bf16 plain forms are its
    // and pconv2d_sm90.cu's
    if constexpr (KD == 1) {
      if (pre && stats)
        return launch_bf16<1, true, true>(x, w, b, y, g, fz, stream);
      if (pre)
        return launch_bf16<1, true, false>(x, w, b, y, g, fz, stream);
      if (stats)
        return launch_bf16<1, false, true>(x, w, b, y, g, fz, stream);
    }
    return (int)cudaErrorInvalidValue;
  } else {
    if (pre && stats) return launch_f32<KD, true, true>(x, w, b, y, g, fz, stream);
    if (pre) return launch_f32<KD, true, false>(x, w, b, y, g, fz, stream);
    if (stats) return launch_f32<KD, false, true>(x, w, b, y, g, fz, stream);
    return launch_f32<KD, false, false>(x, w, b, y, g, fz, stream);
  }
}

template <typename T>
int launch_kd(const void* x, const void* w, const void* b, void* y, Geo g,
              int kd, Fused<T> fz, bool pre, bool stats, void* stream) {
  if (kd == 1)
    return launch_any<T, 1>(x, w, b, y, g, fz, pre, stats, (cudaStream_t)stream);
  if (kd == 3)
    return launch_any<T, 3>(x, w, b, y, g, fz, pre, stats, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K3 / K5, and K6b / K6c: x (nb, nd, hp, wp8, ci), w (kd, 2, 2, ci, co), b
// (co) -> y (nb, nd, hp-1, w_out, co); kd 1 or 3. With sa, ta (nb, ci) in
// x's type the pre transform applies (null: none); with stats (nb * nd, 16,
// co) fp32, zeroed by the caller, the moment partials accumulate (null:
// none). The bf16 entry takes K6b alone, the kd = 1 deferred-norm forms:
// kd = 3, or neither sa, ta nor stats, is invalid (pconv3_valid_sm90.cu's and
// pconv2d_sm90.cu's).
// Returns cudaGetLastError() after the launch.
extern "C" int pconv_valid_bf16(const void* x, const void* w, const void* b,
                                void* y, const void* sa, const void* ta,
                                void* stats, int nb, int nd, int hp, int wp8,
                                int ci, int co, int w_out, int kd, float slope,
                                void* stream) {
  return launch_kd<bf16>(
      x, w, b, y, Geo{nb, nd, hp, wp8, ci, co, w_out}, kd,
      Fused<bf16>{(const bf16*)sa, (const bf16*)ta, (float*)stats, slope},
      sa != nullptr, stats != nullptr, stream);
}

extern "C" int pconv_valid_f32(const void* x, const void* w, const void* b,
                               void* y, const void* sa, const void* ta,
                               void* stats, int nb, int nd, int hp, int wp8,
                               int ci, int co, int w_out, int kd, float slope,
                               void* stream) {
  return launch_kd<float>(
      x, w, b, y, Geo{nb, nd, hp, wp8, ci, co, w_out}, kd,
      Fused<float>{(const float*)sa, (const float*)ta, (float*)stats, slope},
      sa != nullptr, stats != nullptr, stream);
}

// K7, fp32: x (n, hp, wp, ci) at its exact width, w (2, 2, ci, co), b (co)
// -> y (n, hp-1, wp-1, co): the kd = 1 kernel with wp8 = wp and w_out =
// wp - 1. (bf16 K7 is pconv2d_sm90.cu's pconv_valid_sm90_bf16.)
extern "C" int conv2x2_valid_bias_f32(const void* x, const void* w,
                                      const void* b, void* y, int n, int hp,
                                      int wp, int ci, int co, void* stream) {
  return launch_kd<float>(x, w, b, y, Geo{n, 1, hp, wp, ci, co, wp - 1}, 1,
                          Fused<float>{nullptr, nullptr, nullptr, 0.0f},
                          false, false, stream);
}
