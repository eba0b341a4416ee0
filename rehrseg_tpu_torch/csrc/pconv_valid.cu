// K3, K5, K6b, K6c and K7 in fp32: offset -> aligned VALID 2x2 packed conv
// + bias, kd in {1, 3}, with the deferred-norm forms, and the same conv on
// exact widths. (Every bf16 form runs a Hopper kernel: K3, K6b and K7 in
// pconv2d_sm90.cu, K5 and K6c in pconv3_valid_sm90.cu.) fp32 is the port's
// checking dtype, held to 2e-5 against the JAX kernels, not to a time.
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
// norm) xin = leaky(x * sa[b] + ta[b]) * rim_mask, with a rounding after
// the multiply and the add (__fmul_rn, __fadd_rn); rim_mask is the offset
// rim mask of the input's true width w_out + 1 (row, column and channel
// group g = c / (Ci/4), dy = g/2, dx = g%2). z taps outside [0, D) stay
// zero: the transform runs only on loaded data. sa, ta are (B, Ci), one row
// per batch element (the wrapper passes row 0 of JAX's (., 8, Ci) layout;
// for kd = 1, D is folded into B, so one row per image). With STATS the
// kernel also accumulates the sum and the sum of squares of every stored
// output over each (b, z) image into stats (B*D, 16, Co) fp32, zeroed by
// the wrapper: rows 0:8 sums, rows 8:16 squares, row (block % 8) of each
// half, so that atomics from neighbouring blocks land on different
// addresses.
//
// x (B, D, hp, wp8, Ci) offset-packed, stored wp8 wide: only its true
// columns 0..w_out are read, whatever the pad columns hold. W (kd, 2, 2,
// Ci, Co), b (Co), y (B, D, hp-1, w_out, Co), all contiguous channels-last.
// kd = 1 is the same kernel with D folded into B by the caller. What the
// kernel needs: w_out + 1 <= wp8 and Ci, Co % 128 == 0. K7
// (conv2x2_valid_bias_f32) launches the kd = 1 kernel on an exact-width
// input, wp8 = w + 1 and w_out = w.
//
// A plain FMA implicit GEMM: 64 x 64 output tiles, one (tap, 16-channel
// chunk) a step through shared memory, 4 x 4 outputs a thread, the bias
// added in fp32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Geo {
  int nb, nd, hp, wp8, ci, co, w_out;
};

// The deferred-norm operands: sa, ta (B, Ci), stats (B*D, 16, Co), the
// leaky slope.
struct Fused {
  const float* sa;
  const float* ta;
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

__device__ __forceinline__ float pre_f32(float x, float s, float t,
                                         float slope) {
  const float q = __fadd_rn(__fmul_rn(x, s), t);
  return q >= 0.0f ? q : __fmul_rn(q, slope);
}

constexpr int FBM = 64, FBN = 64, FBK = 16;

template <int KD, bool PRE, bool STATS>
__global__ void __launch_bounds__(256)
valid_f32_kernel(const float* __restrict__ x, const float* __restrict__ W,
                 const float* __restrict__ bias, float* __restrict__ y,
                 Geo g, Fused fz) {
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
int launch_f32(const void* x, const void* w, const void* b, void* y, Geo g,
               Fused fz, cudaStream_t stream) {
  const int64_t M = (int64_t)g.nb * g.nd * (g.hp - 1) * g.w_out;
  dim3 grid((unsigned)((M + FBM - 1) / FBM), (unsigned)(g.co / FBN));
  valid_f32_kernel<KD, PRE, STATS><<<grid, 256, 0, stream>>>(
      (const float*)x, (const float*)w, (const float*)b, (float*)y, g, fz);
  return (int)cudaGetLastError();
}

// the kernel for (kd, pre, stats): each combination is its own
// instantiation, so a profile tells the plain and the deferred-norm forms
// apart
template <int KD>
int launch_any(const void* x, const void* w, const void* b, void* y, Geo g,
               Fused fz, bool pre, bool stats, cudaStream_t stream) {
  if (pre && stats)
    return launch_f32<KD, true, true>(x, w, b, y, g, fz, stream);
  if (pre) return launch_f32<KD, true, false>(x, w, b, y, g, fz, stream);
  if (stats) return launch_f32<KD, false, true>(x, w, b, y, g, fz, stream);
  return launch_f32<KD, false, false>(x, w, b, y, g, fz, stream);
}

int launch_kd(const void* x, const void* w, const void* b, void* y, Geo g,
              int kd, Fused fz, bool pre, bool stats, void* stream) {
  if (kd == 1)
    return launch_any<1>(x, w, b, y, g, fz, pre, stats, (cudaStream_t)stream);
  if (kd == 3)
    return launch_any<3>(x, w, b, y, g, fz, pre, stats, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K3 / K5, and K6b / K6c, fp32: x (nb, nd, hp, wp8, ci), w (kd, 2, 2, ci,
// co), b (co) -> y (nb, nd, hp-1, w_out, co); kd 1 or 3. With sa, ta (nb,
// ci) the pre transform applies (null: none); with stats (nb * nd, 16, co),
// zeroed by the caller, the moment partials accumulate (null: none).
// Returns cudaGetLastError() after the launch.
extern "C" int pconv_valid_f32(const void* x, const void* w, const void* b,
                               void* y, const void* sa, const void* ta,
                               void* stats, int nb, int nd, int hp, int wp8,
                               int ci, int co, int w_out, int kd, float slope,
                               void* stream) {
  return launch_kd(x, w, b, y, Geo{nb, nd, hp, wp8, ci, co, w_out}, kd,
                   Fused{(const float*)sa, (const float*)ta, (float*)stats,
                         slope},
                   sa != nullptr, stats != nullptr, stream);
}

// K7, fp32: x (n, hp, wp, ci) at its exact width, w (2, 2, ci, co), b (co)
// -> y (n, hp-1, wp-1, co): the kd = 1 kernel with wp8 = wp and w_out =
// wp - 1. (bf16 K7 is pconv2d_sm90.cu's pconv_valid_sm90_bf16.)
extern "C" int conv2x2_valid_bias_f32(const void* x, const void* w,
                                      const void* b, void* y, int n, int hp,
                                      int wp, int ci, int co, void* stream) {
  return launch_kd(x, w, b, y, Geo{n, 1, hp, wp, ci, co, wp - 1}, 1,
                   Fused{nullptr, nullptr, nullptr, 0.0f}, false, false,
                   stream);
}
