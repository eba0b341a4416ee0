// K3 and K5: offset -> aligned VALID 2x2 packed conv + bias, kd in {1, 3}.
//
// Replaces the TPU kernels rehrseg_tpu/ops/pallas_pconv.py pconv_valid
// (:519, body _valid_kernel :75) for kd = 1 and pconv3_valid (:1117, body
// _valid3_kernel :930) for kd = 3. With du = u - kd/2:
//
//   y[b, z, i, j, co] = b[co] + sum_{u < kd} sum_{s,t in {0,1}} sum_c
//                       x[b, z+du, i+s, j+t, c] * W[u, s, t, c, co]
//   for i in [0, hp-1), j in [0, w_out); x outside [0, D) in z is zero
//
// x (B, D, hp, wp8, Ci) offset-packed, stored 8-aligned wide: only its true
// columns 0..w_out are read, whatever the pad columns hold. W (kd, 2, 2,
// Ci, Co), b (Co), y (B, D, hp-1, w_out, Co), all contiguous channels-last.
// kd = 1 is the same kernel with D folded into B by the caller. The wrapper
// guarantees wp8 % 8 == 0, w_out % 8 == 0, w_out < wp8, Ci, Co % 128 == 0.
//
// What bounds it on the H100: at the served shapes K3 (128, 161, 200, 128
// -> 128, kd 1) does 0.52 TFLOP and must move about 2.06 GB (bytes bound
// it, just); K5 (8, 16, 81, 104, 256 -> 256, kd 3) does 1.55 TFLOP on
// about 1.06 GB (the tensor-core rate bounds it). The design is an implicit GEMM:
// M = output pixels on a virtual grid w_out + 1 columns wide (the extra
// column is computed and dropped), N = Co, K = kd x 2 kernel rows x Ci. A
// block computes 128 pixels x 128 channels; a K step is one 32-channel
// slice of one (z tap, kernel row) pair. Both column taps t share one
// input slab in shared memory: slab row q holds virtual pixel m0 + q, and
// tap t of output row r is slab row r + t, because the virtual row is one
// column wider than the output, so pixel r + 1 is always column j + 1 of
// the same image row for every pixel that is stored. Slabs and weights
// arrive by cp.async (zero fill for z taps outside [0, D): z-SAME) through
// a 3-stage pipeline; WMMA (mma.sync, bf16 in, fp32 accumulate) consumes
// them. Weights stream through the K loop (K5's 1.5 MB never sit in shared
// memory at once). The bias is added in fp32 before the one rounding to
// bf16. 64 accumulators a thread and two blocks per SM (at most 128
// registers); wgmma and TMA are later work.
//
// fp32 inputs take a plain FMA kernel (64 x 64 tiles, one tap per step).

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

// ------------------------------------------------------------ bf16 / WMMA

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int A_LD = 48;                  // 96 B pitch: row offsets stay 32 B aligned
constexpr int A_STAGE = (BM + 8) * A_LD;  // >= BM + 1 slab rows (elements)
constexpr int B_LD = BN + 8;              // 272 B pitch
constexpr int B_STAGE = 2 * BK * B_LD;    // both column taps
constexpr int SMEM = STAGES * (A_STAGE + B_STAGE) * (int)sizeof(bf16);
constexpr int MI = BM / 4 / 16;           // warp tile rows / 16
constexpr int LOADS = ((BM + 1) * 4 + THREADS - 1) / THREADS;

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

template <int KD>
__global__ void __launch_bounds__(THREADS, 2)
valid_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ W,
                  const bf16* __restrict__ bias, bf16* __restrict__ y,
                  Geo g) {
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
          }
          *reinterpret_cast<uint4*>(y + o) =
              *reinterpret_cast<const uint4*>(out);
        }
      }
      __syncwarp();
    }
  }
}

// ------------------------------------------------------------ fp32 / FMA

constexpr int FBM = 64, FBN = 64, FBK = 16;

template <int KD>
__global__ void __launch_bounds__(256)
valid_f32_kernel(const float* __restrict__ x, const float* __restrict__ W,
                 const float* __restrict__ bias, float* __restrict__ y,
                 Geo g) {
  __shared__ __align__(16) float As[FBK][FBM + 4];  // k-major: broadcast rows
  __shared__ __align__(16) float Bs[FBK][FBN];

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
    if (a_ok && zz >= 0 && zz < g.nd)
      v = *reinterpret_cast<const float4*>(
          x + a_base + du * z_stride + s * row_stride + t * g.ci + c0);
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

  const int co = n0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
    if (m >= M) continue;
    *reinterpret_cast<float4*>(y + m * g.co + co) =
        make_float4(acc[i][0] + bias[co], acc[i][1] + bias[co + 1],
                    acc[i][2] + bias[co + 2], acc[i][3] + bias[co + 3]);
  }
}

template <int KD>
int launch_bf16(const void* x, const void* w, const void* b, void* y, Geo g,
                cudaStream_t stream) {
  // above 48 KB, dynamic shared memory has to be asked for
  cudaError_t e = cudaFuncSetAttribute(
      valid_bf16_kernel<KD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (e != cudaSuccess) return (int)e;
  const int64_t M = (int64_t)g.nb * g.nd * (g.hp - 1) * (g.w_out + 1);
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(g.co / BN));
  valid_bf16_kernel<KD><<<grid, THREADS, SMEM, stream>>>(
      (const bf16*)x, (const bf16*)w, (const bf16*)b, (bf16*)y, g);
  return (int)cudaGetLastError();
}

template <int KD>
int launch_f32(const void* x, const void* w, const void* b, void* y, Geo g,
               cudaStream_t stream) {
  const int64_t M = (int64_t)g.nb * g.nd * (g.hp - 1) * g.w_out;
  dim3 grid((unsigned)((M + FBM - 1) / FBM), (unsigned)(g.co / FBN));
  valid_f32_kernel<KD><<<grid, 256, 0, stream>>>(
      (const float*)x, (const float*)w, (const float*)b, (float*)y, g);
  return (int)cudaGetLastError();
}

}  // namespace

// x (nb, nd, hp, wp8, ci), w (kd, 2, 2, ci, co), b (co) -> y (nb, nd,
// hp-1, w_out, co); kd 1 or 3. Returns cudaGetLastError() after the launch.
extern "C" int pconv_valid_bf16(const void* x, const void* w, const void* b,
                                void* y, int nb, int nd, int hp, int wp8,
                                int ci, int co, int w_out, int kd,
                                void* stream) {
  Geo g{nb, nd, hp, wp8, ci, co, w_out};
  if (kd == 1) return launch_bf16<1>(x, w, b, y, g, (cudaStream_t)stream);
  if (kd == 3) return launch_bf16<3>(x, w, b, y, g, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int pconv_valid_f32(const void* x, const void* w, const void* b,
                               void* y, int nb, int nd, int hp, int wp8,
                               int ci, int co, int w_out, int kd,
                               void* stream) {
  Geo g{nb, nd, hp, wp8, ci, co, w_out};
  if (kd == 1) return launch_f32<1>(x, w, b, y, g, (cudaStream_t)stream);
  if (kd == 3) return launch_f32<3>(x, w, b, y, g, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
