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
// the one rounding to bf16. The plain bf16 forms have their own wgmma / TMA
// kernels (K1 in pconv_pad11_cat_sm90.cu, K4 in pconv2d_sm90.cu) and are
// not instantiated here: in bf16 only K6a runs this one.
//
// fp32 inputs take a plain FMA kernel (64 x 64 tiles, one tap per step).
//
// K4, pconv_pad11 (rehrseg_tpu/ops/pallas_pconv.py:576, body _pad11_kernel
// :272), is the same conv on one input: the pconv_pad11_* entry points run
// the fp32 kernel with CAT = false and Cb = 0, so every K step reads xa (the
// K loop never reaches xb). The template argument only gives K4's launches
// their own kernel name. bf16 K4 is pconv2d_sm90.cu's.
//
// K6a, pconv_pad11_cat(want_stats=True) (the same TPU kernel's fused form,
// the producer of pallas_conv="fused"), is K1 with STATS = true: the
// epilogue zeroes the output by the FULL offset rim mask (row, column and
// channel group g = co / (Co/4), dy = g/2, dx = g%2, over h+1 rows and the
// true width w+1: ops/pack2d.py offset_rim_mask), not only the columns > w,
// and accumulates the sum and the sum of squares of every stored (rounded)
// value over each image into stats (N, 16, Co) fp32, zeroed by the caller:
// rows 0:8 sums, rows 8:16 squares, row (block % 8) of each half, so that
// atomics from neighbouring blocks land on different addresses. Each warp
// reduces its 16 x 16 fragment column by column in shared memory into a
// per-block (2 images x Co) sum, flushed with one atomic per value.

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

// ops/pack2d.py offset_rim_mask: is (row, col) of channel group g inside
// the image, for an offset tensor hp rows high and tw columns true width?
__device__ __forceinline__ bool rim_ok(int row, int col, int hp, int tw,
                                       int g) {
  const int dy = g >> 1, dx = g & 1;
  return (row > 0 || dy == 1) && (row < hp - 1 || dy == 0) &&
         (col > 0 || dx == 1) && (col < tw - 1 || dx == 0) && col < tw;
}

// is output (row, col, channel co) stored nonzero: the full rim mask with
// STATS (K6a), else only the columns 0..w
template <bool STATS>
__device__ __forceinline__ bool live_at(int row, int col, int co,
                                        const Geo& g) {
  if constexpr (STATS)
    return rim_ok(row, col, g.h + 1, g.w + 1, co / (g.co / 4));
  else
    return col <= g.w;
}

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
// epilogue scratch, as floats from the start of shared memory: 8 warps x
// one 16 x 16 fragment, then the per-block stats (2 image slots x {sum,
// square} x BN), then each warp's 16 row slots (ints)
constexpr int ST_OFF = 8 * 256;
constexpr int RS_OFF = ST_OFF + 2 * 2 * BN;
static_assert((RS_OFF + 8 * 16) * 4 <= SMEM, "epilogue scratch");

template <bool CAT, bool STATS>
__global__ void __launch_bounds__(THREADS, 1)
pad11_cat_bf16_kernel(const bf16* __restrict__ xa,
                      const bf16* __restrict__ xb,
                      const bf16* __restrict__ W,
                      const bf16* __restrict__ bias, bf16* __restrict__ y,
                      float* __restrict__ stats, Geo g) {
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

  float* const smem_f = reinterpret_cast<float*>(smem_raw);
  float* cs = smem_f + warp * 256;
  float* st = smem_f + ST_OFF;  // STATS: [slot][sum, square][BN]
  int* rs = reinterpret_cast<int*>(smem_f + RS_OFF) + warp * 16;
  const int64_t img_px = (int64_t)(g.h + 1) * g.wp8;
  const int64_t img_lo = m0 / img_px;
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
      int slot = -1;  // STATS: the row's image - img_lo, -1 past the end
      if (m < M) {
        const bool live = live_at<STATS>((int)((m / g.wp8) % (g.h + 1)),
                                         (int)(m % g.wp8), co, g);
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
          if constexpr (STATS) {  // the stored, rounded values
            cs[r * 16 + cpart + 2 * e] = __low2float(out[e]);
            cs[r * 16 + cpart + 2 * e + 1] = __high2float(out[e]);
          }
        }
        *reinterpret_cast<uint4*>(y + m * g.co + co) =
            *reinterpret_cast<const uint4*>(out);
        slot = (int)(m / img_px - img_lo);
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
            atomicAdd(stats + ((img_lo + sl) * 16 + kind * 8) * g.co + n0 + col,
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
      if (img < g.n && st[i] != 0.0f)
        atomicAdd(stats + (img * 16 + kind * 8 + blockIdx.x % 8) * g.co + n0 +
                      i % BN,
                  st[i]);
    }
  }
}

template <bool CAT, bool STATS>
int launch_bf16(const void* xa, const void* xb, const void* w, const void* b,
                void* y, void* stats, Geo g, cudaStream_t stream) {
  // above 48 KB, dynamic shared memory has to be asked for
  cudaError_t e = cudaFuncSetAttribute(
      pad11_cat_bf16_kernel<CAT, STATS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const int64_t M = (int64_t)g.n * (g.h + 1) * g.wp8;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(g.co / BN));
  pad11_cat_bf16_kernel<CAT, STATS><<<grid, THREADS, SMEM, stream>>>(
      (const bf16*)xa, (const bf16*)xb, (const bf16*)w, (const bf16*)b,
      (bf16*)y, (float*)stats, g);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ fp32 / FMA

constexpr int FBM = 64, FBN = 64, FBK = 16;

template <bool CAT, bool STATS>
__global__ void __launch_bounds__(256)
pad11_cat_f32_kernel(const float* __restrict__ xa, const float* __restrict__ xb,
                     const float* __restrict__ W,
                     const float* __restrict__ bias, float* __restrict__ y,
                     float* __restrict__ stats, Geo g) {
  __shared__ __align__(16) float As[FBK][FBM + 4];  // k-major: broadcast rows
  __shared__ __align__(16) float Bs[FBK][FBN];
  __shared__ float st[2][2][FBN];  // STATS: [slot][sum, square][column]

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

  const int64_t img_px = (int64_t)(g.h + 1) * g.wp8;
  const int64_t img_lo = m0 / img_px;
  if constexpr (STATS) {
    for (int i = tid; i < 2 * 2 * FBN; i += 256) (&st[0][0][0])[i] = 0.0f;
    __syncthreads();
  }
  const int co = n0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
    if (m >= M) continue;
    const bool live = live_at<STATS>((int)((m / g.wp8) % (g.h + 1)),
                                     (int)(m % g.wp8), co, g);
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live)
      o = make_float4(acc[i][0] + bias[co], acc[i][1] + bias[co + 1],
                      acc[i][2] + bias[co + 2], acc[i][3] + bias[co + 3]);
    *reinterpret_cast<float4*>(y + m * g.co + co) = o;
    if constexpr (STATS) {
      const int64_t sl = m / img_px - img_lo;
      const float vals[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (sl < 2) {
          atomicAdd(&st[sl][0][tx * 4 + j], vals[j]);
          atomicAdd(&st[sl][1][tx * 4 + j], vals[j] * vals[j]);
        } else {
          float* p = stats + (img_lo + sl) * 16 * g.co + co + j;
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
      if (img < g.n && v != 0.0f)
        atomicAdd(stats + (img * 16 + kind * 8 + blockIdx.x % 8) * g.co + n0 +
                      i % FBN,
                  v);
    }
  }
}

template <bool CAT, bool STATS>
int launch_f32(const void* xa, const void* xb, const void* w, const void* b,
               void* y, void* stats, Geo g, cudaStream_t stream) {
  const int64_t M = (int64_t)g.n * (g.h + 1) * g.wp8;
  dim3 grid((unsigned)((M + FBM - 1) / FBM), (unsigned)(g.co / FBN));
  pad11_cat_f32_kernel<CAT, STATS><<<grid, 256, 0, stream>>>(
      (const float*)xa, (const float*)xb, (const float*)w, (const float*)b,
      (float*)y, (float*)stats, g);
  return (int)cudaGetLastError();
}

}  // namespace

// K1, and K6a with stats: xa (n, h, w_in, ca), xb (n, h, w_in, cb), w (2, 2,
// ca+cb, co), b (co) -> y (n, h+1, wp8, co). stats (n, 16, co) fp32, zeroed
// by the caller, or null for K1 (fp32 only: the bf16 entry takes K6a alone).
// Returns cudaGetLastError() after the launch.
extern "C" int pconv_pad11_cat_bf16(const void* xa, const void* xb,
                                    const void* w, const void* b, void* y,
                                    void* stats, int n, int h, int w_in,
                                    int ca, int cb, int co, int wp8,
                                    void* stream) {
  const Geo g{n, h, w_in, ca, cb, co, wp8};
  if (stats)
    return launch_bf16<true, true>(xa, xb, w, b, y, stats, g,
                                   (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;  // pconv_pad11_cat_sm90.cu's
}

extern "C" int pconv_pad11_cat_f32(const void* xa, const void* xb,
                                   const void* w, const void* b, void* y,
                                   void* stats, int n, int h, int w_in,
                                   int ca, int cb, int co, int wp8,
                                   void* stream) {
  const Geo g{n, h, w_in, ca, cb, co, wp8};
  if (stats)
    return launch_f32<true, true>(xa, xb, w, b, y, stats, g,
                                  (cudaStream_t)stream);
  return launch_f32<true, false>(xa, xb, w, b, y, nullptr, g,
                                 (cudaStream_t)stream);
}

// K4, fp32: x (n, h, w_in, ci), w (2, 2, ci, co), b (co) -> y (n, h+1, wp8,
// co). (bf16 K4 is pconv2d_sm90.cu's pconv_pad11_sm90_bf16.)
extern "C" int pconv_pad11_f32(const void* x, const void* w, const void* b,
                               void* y, int n, int h, int w_in, int ci,
                               int co, int wp8, void* stream) {
  return launch_f32<false, false>(x, x, w, b, y, nullptr,
                                  Geo{n, h, w_in, ci, 0, co, wp8},
                                  (cudaStream_t)stream);
}
