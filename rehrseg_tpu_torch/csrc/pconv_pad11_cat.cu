// K1: fused decoder-concat + pad(1,1) packed 2x2 conv + bias.
//
// Replaces the TPU kernel rehrseg_tpu/ops/pallas_pconv.py pconv_pad11_cat
// (:889, body _pad11_cat_kernel :641). With x = concat([xa, xb], -1):
//
//   y[n, i, j, co] = b[co] + sum_{s,t in {0,1}} sum_c x[n, i+s-1, j+t-1, c]
//                                                   * W[s, t, c, co]
//   for i in [0, h], j in [0, w];  y[n, i, j, :] = 0 for j in (w, wp8)
//
// xa (N, h, w, Ca), xb (N, h, w, Cb), W (2, 2, Ca+Cb, Co), b (Co), y
// (N, h+1, wp8, Co), all contiguous channels-last; x outside the image is
// zero. The wrapper guarantees w % 8 == 0 and Ca, Cb, Co % 128 == 0.
//
// What bounds it on the H100: at the serving shape (N 128, h 160, w 192,
// Ca = Cb = Co = 128) it does 1.04 TFLOP of bf16 products and must move
// about 3.07 GB, so tensor-core rate and memory rate bound it about
// equally. The design is an implicit GEMM, M = N*(h+1)*wp8 output pixels,
// N = Co, K = 4 taps x (Ca+Cb). A block computes 256 output pixels x 128
// output channels; a K step is one 32-channel slice of one kernel row s,
// read from xa or from xb (the fused concat: the concatenated tensor never
// exists). Both column taps t of that row share one input slab in shared
// memory (tap t is the slab shifted by t rows, see below), which halves
// the input traffic of a one-tap-per-step loop. Slabs and weights arrive
// by cp.async (zero fill at the image rim) through a 3-stage pipeline with
// one barrier per step, and WMMA (mma.sync, bf16 in, fp32 accumulate)
// consumes them. Rows of the pad columns read only zeros and are written
// as exact zeros in the epilogue, which also adds the bias in fp32 before
// the one rounding to bf16. wgmma and TMA are later work.
//
// fp32 inputs take a plain FMA kernel (64 x 64 tiles, one tap per step).
//
// K4, pconv_pad11 (rehrseg_tpu/ops/pallas_pconv.py:576, body _pad11_kernel
// :272), is the same conv on one input: the pconv_pad11_* entry points run
// these kernels with CAT = false and Cb = 0, so every K step reads xa (the
// K loop runs over Ca / 32 chunks and never reaches xb). The template
// argument only gives K4's launches their own kernel name.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

struct Geo {
  int n, h, w, ca, cb, co, wp8;
};

// ------------------------------------------------------------ bf16 / WMMA

constexpr int BN = 128;
constexpr int B_LD = BN + 8;  // smem row pitch in elements (272 B)
constexpr int THREADS = 256;

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

// One K step = one 32-channel chunk of one kernel row s, both column taps
// t = 0, 1. Slab row q holds the input pixel (i+s-1, j) of output row
// m0+q-1, so tap t of output row r is slab row r+t: the previous output
// pixel's column is this one's column - 1, and where the previous output
// pixel sits in another image row its column is >= w, outside the image,
// so its slab row is zero exactly where tap t = 0 needs the left pad.
constexpr int BM = 256, BK = 32, STAGES = 3;
constexpr int A_LD = 48;  // 96 B pitch: every row offset stays 32 B aligned
constexpr int A_STAGE = (BM + 8) * A_LD;  // >= BM + 1 slab rows (elements)
constexpr int B_STAGE = 2 * BK * B_LD;    // both column taps
constexpr int SMEM = STAGES * (A_STAGE + B_STAGE) * (int)sizeof(bf16);
constexpr int MI = BM / 4 / 16;           // warp tile rows / 16
constexpr int LOADS = ((BM + 1) * 4 + THREADS - 1) / THREADS;

template <bool CAT>
__global__ void __launch_bounds__(THREADS, 1)
pad11_cat_bf16_kernel(const bf16* __restrict__ xa,
                      const bf16* __restrict__ xb,
                      const bf16* __restrict__ W,
                      const bf16* __restrict__ bias, bf16* __restrict__ y,
                      Geo g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = As + STAGES * A_STAGE;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp % 4, wn = warp / 4;  // warp tile: BM/4 rows x 64 cols
  const int64_t M = (int64_t)g.n * (g.h + 1) * g.wp8;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int cin = g.ca + g.cb;
  const int kchunks = cin / BK;
  const int KT = 2 * kchunks;  // (chunk, kernel row s)

  // this thread's slab rows, decoded once: load l covers slab row
  // q = (tid + l*THREADS) / 4, 16-byte chunk (tid % 4)
  const int a_chunk = tid % 4;
  int a_n[LOADS], a_i[LOADS], a_j[LOADS];
  bool a_ok[LOADS];
#pragma unroll
  for (int l = 0; l < LOADS; ++l) {
    const int q = (tid + l * THREADS) / 4;
    const int64_t m = m0 + q - 1;
    a_ok[l] = q <= BM && m >= 0 && m < M;
    const int64_t mm = a_ok[l] ? m : 0;
    a_j[l] = (int)(mm % g.wp8);
    const int64_t t = mm / g.wp8;
    a_i[l] = (int)(t % (g.h + 1));
    a_n[l] = (int)(t / (g.h + 1));
    a_ok[l] = a_ok[l] && a_j[l] < g.w;
  }

  auto load = [&](int stage, int kt) {
    const int s = kt % 2;
    const int c0 = (kt / 2) * BK;
    const bf16* src;
    int cs, coff;
    if (!CAT || c0 < g.ca) {
      src = xa; cs = g.ca; coff = c0;
    } else {
      src = xb; cs = g.cb; coff = c0 - g.ca;
    }
    bf16* as = As + stage * A_STAGE;
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      const int q = (tid + l * THREADS) / 4;
      if (q <= BM) {
        const int ii = a_i[l] + s - 1;
        const bool ok = a_ok[l] && ii >= 0 && ii < g.h;
        const bf16* p =
            ok ? src + (((int64_t)a_n[l] * g.h + ii) * g.w + a_j[l]) * cs +
                     coff + a_chunk * 8
               : src;
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
          W + ((int64_t)(s * 2 + t) * cin + c0 + kr) * g.co + n0 + ch * 8;
      cp_async16(bs + (t * BK + kr) * B_LD + ch * 8, p, true);
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

  float* cs = reinterpret_cast<float*>(smem_raw) + warp * 256;
  const int r = lane / 2, cpart = (lane % 2) * 8;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      wmma::store_matrix_sync(cs, acc[mi][ni], 16, wmma::mem_row_major);
      __syncwarp();
      const int64_t m = m0 + wm * (BM / 4) + mi * 16 + r;
      const int co = n0 + wn * 64 + ni * 16 + cpart;
      if (m < M) {
        const bool live = (int)(m % g.wp8) <= g.w;
        __align__(16) __nv_bfloat162 out[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v0 = 0.0f, v1 = 0.0f;
          if (live) {
            v0 = cs[r * 16 + cpart + 2 * e] + __bfloat162float(bias[co + 2 * e]);
            v1 = cs[r * 16 + cpart + 2 * e + 1] +
                 __bfloat162float(bias[co + 2 * e + 1]);
          }
          out[e] = __floats2bfloat162_rn(v0, v1);
        }
        *reinterpret_cast<uint4*>(y + m * g.co + co) =
            *reinterpret_cast<const uint4*>(out);
      }
      __syncwarp();
    }
  }
}

template <bool CAT>
int launch_bf16(const void* xa, const void* xb, const void* w, const void* b,
                void* y, Geo g, cudaStream_t stream) {
  // above 48 KB, dynamic shared memory has to be asked for
  cudaError_t e = cudaFuncSetAttribute(
      pad11_cat_bf16_kernel<CAT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (e != cudaSuccess) return (int)e;
  const int64_t M = (int64_t)g.n * (g.h + 1) * g.wp8;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(g.co / BN));
  pad11_cat_bf16_kernel<CAT><<<grid, THREADS, SMEM, stream>>>(
      (const bf16*)xa, (const bf16*)xb, (const bf16*)w, (const bf16*)b,
      (bf16*)y, g);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ fp32 / FMA

constexpr int FBM = 64, FBN = 64, FBK = 16;

template <bool CAT>
__global__ void __launch_bounds__(256)
pad11_cat_f32_kernel(const float* __restrict__ xa, const float* __restrict__ xb,
                     const float* __restrict__ W,
                     const float* __restrict__ bias, float* __restrict__ y,
                     Geo g) {
  __shared__ __align__(16) float As[FBK][FBM + 4];  // k-major: broadcast rows
  __shared__ __align__(16) float Bs[FBK][FBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // 4x4 outputs per thread
  const int64_t M = (int64_t)g.n * (g.h + 1) * g.wp8;
  const int64_t m0 = (int64_t)blockIdx.x * FBM;
  const int n0 = blockIdx.y * FBN;
  const int cin = g.ca + g.cb;
  const int kchunks = cin / FBK;
  const int KT = 4 * kchunks;

  const int ar = tid / 4, ak = (tid % 4) * 4;
  const int64_t am = m0 + ar;
  const bool a_ok = am < M;
  const int64_t amm = a_ok ? am : 0;
  const int a_j = (int)(amm % g.wp8);
  const int a_i = (int)((amm / g.wp8) % (g.h + 1));
  const int a_n = (int)((amm / g.wp8) / (g.h + 1));
  const int bk = tid / 16, bc = (tid % 16) * 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int kt = 0; kt < KT; ++kt) {
    const int tap = kt / kchunks;
    const int s = tap / 2, t = tap % 2;
    const int c0 = (kt % kchunks) * FBK;
    const float* src;
    int cs, coff;
    if (!CAT || c0 < g.ca) {
      src = xa; cs = g.ca; coff = c0;
    } else {
      src = xb; cs = g.cb; coff = c0 - g.ca;
    }
    const int ii = a_i + s - 1, jj = a_j + t - 1;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a_ok && ii >= 0 && ii < g.h && jj >= 0 && jj < g.w)
      v = *reinterpret_cast<const float4*>(
          src + (((int64_t)a_n * g.h + ii) * g.w + jj) * cs + coff + ak);
    As[ak + 0][ar] = v.x;
    As[ak + 1][ar] = v.y;
    As[ak + 2][ar] = v.z;
    As[ak + 3][ar] = v.w;
    *reinterpret_cast<float4*>(&Bs[bk][bc]) = *reinterpret_cast<const float4*>(
        W + ((int64_t)tap * cin + c0 + bk) * g.co + n0 + bc);
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

  const int co = n0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
    if (m >= M) continue;
    const bool live = (int)(m % g.wp8) <= g.w;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live)
      o = make_float4(acc[i][0] + bias[co], acc[i][1] + bias[co + 1],
                      acc[i][2] + bias[co + 2], acc[i][3] + bias[co + 3]);
    *reinterpret_cast<float4*>(y + m * g.co + co) = o;
  }
}

template <bool CAT>
int launch_f32(const void* xa, const void* xb, const void* w, const void* b,
               void* y, Geo g, cudaStream_t stream) {
  const int64_t M = (int64_t)g.n * (g.h + 1) * g.wp8;
  dim3 grid((unsigned)((M + FBM - 1) / FBM), (unsigned)(g.co / FBN));
  pad11_cat_f32_kernel<CAT><<<grid, 256, 0, stream>>>(
      (const float*)xa, (const float*)xb, (const float*)w, (const float*)b,
      (float*)y, g);
  return (int)cudaGetLastError();
}

}  // namespace

// K1: xa (n, h, w_in, ca), xb (n, h, w_in, cb), w (2, 2, ca+cb, co), b (co)
// -> y (n, h+1, wp8, co). Returns cudaGetLastError() after the launch.
extern "C" int pconv_pad11_cat_bf16(const void* xa, const void* xb,
                                    const void* w, const void* b, void* y,
                                    int n, int h, int w_in, int ca, int cb,
                                    int co, int wp8, void* stream) {
  return launch_bf16<true>(xa, xb, w, b, y, Geo{n, h, w_in, ca, cb, co, wp8},
                           (cudaStream_t)stream);
}

extern "C" int pconv_pad11_cat_f32(const void* xa, const void* xb,
                                   const void* w, const void* b, void* y,
                                   int n, int h, int w_in, int ca, int cb,
                                   int co, int wp8, void* stream) {
  return launch_f32<true>(xa, xb, w, b, y, Geo{n, h, w_in, ca, cb, co, wp8},
                          (cudaStream_t)stream);
}

// K4: x (n, h, w_in, ci), w (2, 2, ci, co), b (co) -> y (n, h+1, wp8, co).
extern "C" int pconv_pad11_bf16(const void* x, const void* w, const void* b,
                                void* y, int n, int h, int w_in, int ci,
                                int co, int wp8, void* stream) {
  return launch_bf16<false>(x, x, w, b, y, Geo{n, h, w_in, ci, 0, co, wp8},
                            (cudaStream_t)stream);
}

extern "C" int pconv_pad11_f32(const void* x, const void* w, const void* b,
                               void* y, int n, int h, int w_in, int ci,
                               int co, int wp8, void* stream) {
  return launch_f32<false>(x, x, w, b, y, Geo{n, h, w_in, ci, 0, co, wp8},
                           (cudaStream_t)stream);
}
