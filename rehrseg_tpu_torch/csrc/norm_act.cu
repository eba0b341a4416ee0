// A ConvNormAct's instance-norm tail in two passes: norm_stats (the
// per-image moments) and norm_act_apply (bias, normalize, affine, leaky
// ReLU, rim), for the packed forward (models/segnet_packed.py
// _conv_norm_act, _skip_branch; wrapper ops/norm_act.py).
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA, which
// fuses it into the passes around the convs (rehrseg_tpu/models/
// segnet_packed.py _conv_norm_act; the norm is ops/pack2d.py
// instance_norm_packed). Run eagerly in PyTorch the same chain is eight to
// twelve passes over the conv output (bias add, rim mask, fp32 copy, sums,
// squares, broadcast subtract, multiplies, adds, leaky ReLU, rim mask),
// about 25 bytes moved per byte of tensor; here it moves 3.
//
// What bounds it on the H100: bytes. A handful of flops an element against
// 3 bytes moved per byte of tensor (one read for the moments, one read and
// one write to apply them). The design:
//
// - y is contiguous (B, D, H, W, C4), bf16 or fp32, C4 split into `groups`
//   of csize channels: the four (dy, dx) groups of a packed tensor, or one
//   group for an unpacked tensor. Each thread owns one 16-byte vector of
//   channels (8 bf16 or 4 fp32, inside one group) and walks pixels with
//   its lane index: `lanes` threads per vector, 4 loads in flight before
//   any arithmetic. Rows (d, h) are walked in order, so no per-element
//   division: the rim test is (h, w, group) against the row's h, the
//   column w and true_w, derived from indices (no mask tensor).
// - norm_stats: grid (slabs, B). Each CTA sums a slab of rows of one image
//   as shifted sums (x - K, (x - K)^2 with K one sample of the image per
//   channel, the same for the CTA) in fp32, adding the conv bias in
//   registers with the rounding of the eager `y + b` (bf16x2), skipping rim
//   positions and columns at or past true_w. It writes its partial
//   (count, mean, M2) per channel; the last CTA of the image (a ticket
//   counter that resets itself) merges the slabs with Chan's formula in
//   fp64, then the groups, and writes the image's mean m and inverse std
//   k = rsqrt(var + eps) per channel (repeated over the groups). The
//   moments stay centred (two-pass accuracy) on every form.
// - norm_act_apply: grid (CTAs, B), about 1 MB of rows a CTA, one
//   16-byte read and one write per vector, the channels' parameters in
//   registers. It repeats the eager chain's roundings in the working
//   dtype: t = r(y + b); t = t * rim; t = r(t - r(m)); t = r(t * r(k));
//   affine: t = r(t * g); t = r(t + beta); leaky: t > 0 ? t : r(t * slope)
//   (fp32 opmath, the slope not rounded to bf16); t = t * rim. bf16 runs
//   on bf16x2 instructions (Apply below), fp32 on _rn intrinsics that the
//   compiler cannot contract into FMAs, so, given the same m and k, the
//   output is bit-equal to the eager chain (signed zeros at the rim
//   included).
//
// Kernel symbols contain "norm" and none of the conv, copy or layout name
// fragments, so a profiler's breakdown counts them as reductions.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMaxC4 = 1024;
// the block reduction's scratch: lanes * C4 <= threads * V <= 2048 floats
constexpr int kRed = 2048;

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 t) {
  return *reinterpret_cast<const uint32_t*>(&t);
}

// 16-byte vectors of T: loads, the bias add, fp32 lanes
template <typename T>
struct Traits;

template <>
struct Traits<__nv_bfloat16> {
  static constexpr int V = 8;
  using Raw = uint4;
  __device__ static __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static __forceinline__ Raw load_last(const __nv_bfloat16* p) {
    return __ldcs(reinterpret_cast<const uint4*>(p));
  }
  __device__ static __forceinline__ Raw zero() {
    return make_uint4(0u, 0u, 0u, 0u);
  }
  // y + b rounded to bf16, as the eager add (see Apply)
  __device__ static __forceinline__ Raw add(const Raw& a, const Raw& c) {
    return make_uint4(
        as_u32(__hadd2_rn(as_bf162(a.x), as_bf162(c.x))),
        as_u32(__hadd2_rn(as_bf162(a.y), as_bf162(c.y))),
        as_u32(__hadd2_rn(as_bf162(a.z), as_bf162(c.z))),
        as_u32(__hadd2_rn(as_bf162(a.w), as_bf162(c.w))));
  }
  __device__ static __forceinline__ void unpack(const Raw& r, float (&v)[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static __forceinline__ void store(__nv_bfloat16* p,
                                               const Raw& r) {
    *reinterpret_cast<uint4*>(p) = r;
  }
};

template <>
struct Traits<float> {
  static constexpr int V = 4;
  using Raw = float4;
  __device__ static __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static __forceinline__ Raw load_last(const float* p) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  }
  __device__ static __forceinline__ Raw zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ static __forceinline__ Raw add(const Raw& a, const Raw& c) {
    return make_float4(__fadd_rn(a.x, c.x), __fadd_rn(a.y, c.y),
                       __fadd_rn(a.z, c.z), __fadd_rn(a.w, c.w));
  }
  __device__ static __forceinline__ void unpack(const Raw& r, float (&v)[4]) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  __device__ static __forceinline__ void store(float* p, const Raw& r) {
    *reinterpret_cast<float4*>(p) = r;
  }
};

// The apply pass's arithmetic of one 16-byte vector, with its channels'
// parameters held in registers. bf16 runs on bf16x2 instructions: an add,
// subtract or multiply of two bf16 values rounded once to bf16 equals the
// eager chain's fp32 operation rounded to bf16 (a product of two 8-bit
// significands is exact in fp32; a sum that fp32 must round lies within
// 2^-15 of its larger operand, far from a bf16 rounding boundary). The
// leaky product takes the fp32 slope in fp32, as F.leaky_relu does. The
// _rn forms keep the compiler from contracting a multiply and an add into
// one bf16x2 FMA (one rounding where the chain has two).
template <typename T>
struct Apply;

template <>
struct Apply<__nv_bfloat16> {
  __nv_bfloat162 b[4], m[4], k[4], g[4], be[4];

  __device__ __forceinline__ void init(const __nv_bfloat16* bias,
                                       const float* mp, const float* kp,
                                       const __nv_bfloat16* gamma,
                                       const __nv_bfloat16* beta, int c0,
                                       int gc0) {
    const uint4 ub = bias != nullptr
        ? __ldg(reinterpret_cast<const uint4*>(bias + c0))
        : make_uint4(0u, 0u, 0u, 0u);
    // 1.0 and 0.0 in both halves where there is no affine
    const uint4 ug = gamma != nullptr
        ? __ldg(reinterpret_cast<const uint4*>(gamma + gc0))
        : make_uint4(0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u);
    const uint4 ue = beta != nullptr
        ? __ldg(reinterpret_cast<const uint4*>(beta + gc0))
        : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t wb[4] = {ub.x, ub.y, ub.z, ub.w};
    const uint32_t wg[4] = {ug.x, ug.y, ug.z, ug.w};
    const uint32_t we[4] = {ue.x, ue.y, ue.z, ue.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      b[i] = as_bf162(wb[i]);
      g[i] = as_bf162(wg[i]);
      be[i] = as_bf162(we[i]);
      const float2 mm = *reinterpret_cast<const float2*>(mp + c0 + 2 * i);
      const float2 kk = *reinterpret_cast<const float2*>(kp + c0 + 2 * i);
      m[i] = __floats2bfloat162_rn(mm.x, mm.y);
      k[i] = __floats2bfloat162_rn(kk.x, kk.y);
    }
  }

  __device__ __forceinline__ uint4 run(const uint4& r, bool has_bias,
                                       bool affine, bool zero, bool has_slope,
                                       float slope) const {
    uint32_t w[4] = {r.x, r.y, r.z, r.w};
    const __nv_bfloat162 z2 = as_bf162(0u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 t = as_bf162(w[i]);
      if (has_bias) t = __hadd2_rn(t, b[i]);
      if (zero) t = __hmul2_rn(t, z2);
      t = __hmul2_rn(__hsub2_rn(t, m[i]), k[i]);
      if (affine) t = __hadd2_rn(__hmul2_rn(t, g[i]), be[i]);
      if (has_slope) {
        float2 f = __bfloat1622float2(t);
        if (!(f.x > 0.f)) f.x = __fmul_rn(f.x, slope);
        if (!(f.y > 0.f)) f.y = __fmul_rn(f.y, slope);
        t = __floats2bfloat162_rn(f.x, f.y);
      }
      if (zero) t = __hmul2_rn(t, z2);
      w[i] = as_u32(t);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Apply<float> {
  float b[4], m[4], k[4], g[4], be[4];

  __device__ __forceinline__ void init(const float* bias, const float* mp,
                                       const float* kp, const float* gamma,
                                       const float* beta, int c0, int gc0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = bias != nullptr ? bias[c0 + j] : 0.f;
      m[j] = mp[c0 + j];
      k[j] = kp[c0 + j];
      g[j] = gamma != nullptr ? gamma[gc0 + j] : 1.f;
      be[j] = beta != nullptr ? beta[gc0 + j] : 0.f;
    }
  }

  __device__ __forceinline__ float4 run(const float4& r, bool has_bias,
                                        bool affine, bool zero,
                                        bool has_slope, float slope) const {
    float v[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float t = v[j];
      if (has_bias) t = __fadd_rn(t, b[j]);
      if (zero) t = __fmul_rn(t, 0.f);
      t = __fmul_rn(__fsub_rn(t, m[j]), k[j]);
      if (affine) t = __fadd_rn(__fmul_rn(t, g[j]), be[j]);
      if (has_slope && !(t > 0.f)) t = __fmul_rn(t, slope);
      if (zero) t = __fmul_rn(t, 0.f);
      v[j] = t;
    }
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

// The rim of an offset-packed tensor (ops/pack2d.py offset_rim_mask): group
// (dy, dx) holds real pixels at rows 1..H-1 (dy = 0) or 0..H-2 (dy = 1) and
// columns 1..true_w-1 or 0..true_w-2; columns >= true_w are padding.
__device__ __forceinline__ bool row_real(int h, int H, int dy) {
  return (h > 0 || dy) && (h < H - 1 || !dy);
}

__device__ __forceinline__ bool col_real(int w, int true_w, int dx) {
  return (w > 0 || dx) && (w < true_w - 1 || !dx) && w < true_w;
}

// Chan's merge of (nb, mb, qb) into (n, mean, m2)
__device__ __forceinline__ void chan_merge(double& n, double& mean,
                                           double& m2, double nb, double mb,
                                           double qb) {
  if (nb <= 0.0) return;
  const double tot = n + nb;
  const double d = mb - mean;
  mean += d * (nb / tot);
  m2 += qb + d * d * (n * nb / tot);
  n = tot;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
norm_stats_kernel(const T* __restrict__ y, const T* __restrict__ bias,
                  float* __restrict__ part, unsigned int* __restrict__ tickets,
                  float* __restrict__ m_out, float* __restrict__ k_out,
                  int rows, int H, int W, int C4, int csize, int offset,
                  int true_w, int rows_per_slab, double eps) {
  using Tr = Traits<T>;
  constexpr int V = Tr::V;
  __shared__ float red[2 * kRed];
  __shared__ int red_n[kMaxThreads];
  __shared__ float shift[kMaxC4];
  __shared__ unsigned int last;

  const int nvec = C4 / V;
  const int nthreads = blockDim.x;
  const int lanes = nthreads / nvec;
  const int tid = threadIdx.x;
  const int cv = tid % nvec, lane = tid / nvec;
  const int c0 = cv * V;
  const int b = blockIdx.y;
  const int slabs = gridDim.x;
  const int g = c0 / csize;
  const int dy = (g >> 1) & 1, dx = g & 1;
  const T* yb = y + (size_t)b * rows * W * C4 + c0;

  typename Tr::Raw braw = Tr::zero();
  if (bias != nullptr) braw = Tr::load(bias + c0);

  const int r0 = blockIdx.x * rows_per_slab;
  const int r1 = min(rows, r0 + rows_per_slab);

  // the shift: one sample of the image (a real pixel where the image has
  // one: h in [1, H-2], w = 1 for an offset tensor), the same for the CTA
  float K[V];
  {
    int hs = r0 % H, ws = 0;
    if (offset) {
      hs = max(0, min(max(hs, 1), H - 2));
      ws = min(1, W - 1);
    }
    const int rs = r0 - r0 % H + hs;
    float v[V];
    Tr::unpack(Tr::add(Tr::load(yb + ((size_t)rs * W + ws) * C4), braw), v);
    const bool real = !offset || (row_real(hs, H, dy)
                                  && col_real(ws, true_w, dx));
#pragma unroll
    for (int j = 0; j < V; ++j) K[j] = real ? v[j] : 0.f;
  }

  float s1[V], s2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0.f;
  int n = 0;
  for (int r = r0; r < r1; ++r) {
    if (offset && !row_real(r % H, H, dy)) continue;
    const T* yr = yb + (size_t)r * W * C4;
    for (int w0 = lane; w0 < W; w0 += kUnroll * lanes) {
      typename Tr::Raw raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int w = w0 + u * lanes;
        if (w < W) raw[u] = Tr::load(yr + (size_t)w * C4);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int w = w0 + u * lanes;
        if (w < W && (!offset || col_real(w, true_w, dx))) {
          float v[V];
          Tr::unpack(Tr::add(raw[u], braw), v);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float d = v[j] - K[j];
            s1[j] += d;
            s2[j] = fmaf(d, d, s2[j]);
          }
          ++n;
        }
      }
    }
  }

  // the CTA's sums per channel: lanes of one vector side by side
#pragma unroll
  for (int j = 0; j < V; ++j) {
    red[lane * C4 + c0 + j] = s1[j];
    red[kRed + lane * C4 + c0 + j] = s2[j];
  }
  red_n[tid] = n;
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < V; ++j) shift[c0 + j] = K[j];
  }
  __syncthreads();
  float* pb = part + ((size_t)b * slabs + blockIdx.x) * 3 * C4;
  for (int c = tid; c < C4; c += nthreads) {
    float S1 = 0.f, S2 = 0.f;
    int N = 0;
    for (int l = 0; l < lanes; ++l) {
      S1 += red[l * C4 + c];
      S2 += red[kRed + l * C4 + c];
      N += red_n[l * nvec + c / V];
    }
    float mean = 0.f, m2 = 0.f;
    if (N > 0) {
      const float q = S1 / (float)N;
      mean = shift[c] + q;
      m2 = fmaxf(S2 - S1 * q, 0.f);
    }
    pb[c] = (float)N;
    pb[C4 + c] = mean;
    pb[2 * C4 + c] = m2;
  }

  // the last CTA of the image merges the slabs
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(tickets + b, 1u) == (unsigned int)(slabs - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid == 0) tickets[b] = 0u;

  // tpc threads per channel, each over every tpc-th slab (4 loads in
  // flight), then the tpc partials and the groups per channel
  const int tpc = max(1, nthreads / C4);
  for (int t = tid; t < tpc * C4; t += nthreads) {
    const int jj = t / C4, c = t % C4;
    double dn = 0.0, dmean = 0.0, dm2 = 0.0;
    for (int s0 = jj; s0 < slabs; s0 += kUnroll * tpc) {
      float pn[kUnroll], pm[kUnroll], pq[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = s0 + u * tpc;
        pn[u] = pm[u] = pq[u] = 0.f;
        if (s < slabs) {
          const float* p = part + ((size_t)b * slabs + s) * 3 * C4 + c;
          pn[u] = __ldcg(p);
          pm[u] = __ldcg(p + C4);
          pq[u] = __ldcg(p + 2 * C4);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        chan_merge(dn, dmean, dm2, pn[u], pm[u], pq[u]);
    }
    red[t] = (float)dn;
    red[kMaxC4 + t] = (float)dmean;
    red[2 * kMaxC4 + t] = (float)dm2;
  }
  __syncthreads();
  const int groups = C4 / csize;
  for (int c = tid; c < C4; c += nthreads) {
    const int ci = c % csize;
    double dn = 0.0, dmean = 0.0, dm2 = 0.0;
    for (int gi = 0; gi < groups; ++gi)
      for (int jj = 0; jj < tpc; ++jj) {
        const int t = jj * C4 + gi * csize + ci;
        chan_merge(dn, dmean, dm2, red[t], red[kMaxC4 + t],
                   red[2 * kMaxC4 + t]);
      }
    const double var = dn > 0.0 ? dm2 / dn : 0.0;
    m_out[(size_t)b * C4 + c] = (float)dmean;
    k_out[(size_t)b * C4 + c] = (float)(1.0 / sqrt(var + eps));
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
norm_act_apply_kernel(const T* __restrict__ y, const T* __restrict__ bias,
                      const float* __restrict__ m, const float* __restrict__ k,
                      const T* __restrict__ gamma, const T* __restrict__ beta,
                      T* __restrict__ out, int rows, int H, int W, int C4,
                      int csize, int offset, int true_w, int rows_per_cta,
                      int has_slope, float slope) {
  using Tr = Traits<T>;
  constexpr int V = Tr::V;
  const int nvec = C4 / V;
  const int lanes = blockDim.x / nvec;
  const int cv = threadIdx.x % nvec, lane = threadIdx.x / nvec;
  const int c0 = cv * V;
  const int b = blockIdx.y;
  const int g = c0 / csize;
  const int dy = (g >> 1) & 1, dx = g & 1;
  const bool has_bias = bias != nullptr, affine = gamma != nullptr;

  Apply<T> op;
  op.init(bias, m + (size_t)b * C4, k + (size_t)b * C4, gamma, beta, c0,
          c0 % csize);
  const size_t img = (size_t)b * rows * W * C4 + c0;
  const int r0 = blockIdx.x * rows_per_cta;
  const int r1 = min(rows, r0 + rows_per_cta);
  for (int r = r0; r < r1; ++r) {
    const bool rreal = !offset || row_real(r % H, H, dy);
    const size_t row = img + (size_t)r * W * C4;
    for (int w0 = lane; w0 < W; w0 += kUnroll * lanes) {
      typename Tr::Raw raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int w = w0 + u * lanes;
        if (w < W) raw[u] = Tr::load_last(y + row + (size_t)w * C4);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int w = w0 + u * lanes;
        if (w >= W) continue;
        const bool zero = offset && !(rreal && col_real(w, true_w, dx));
        Tr::store(out + row + (size_t)w * C4,
                  op.run(raw[u], has_bias, affine, zero, has_slope != 0,
                         slope));
      }
    }
  }
}

// threads of a CTA: `lanes` whole vectors of C4 channels, at most 256
template <typename T>
bool shape_ok(int C4, int csize) {
  constexpr int V = Traits<T>::V;
  return C4 > 0 && csize > 0 && C4 <= kMaxC4 && C4 % csize == 0
         && csize % V == 0 && (C4 / csize == 1 || C4 / csize == 4);
}

template <typename T>
int threads_for(int C4) {
  const int nvec = C4 / Traits<T>::V;
  return nvec * (nvec >= kMaxThreads ? 1 : kMaxThreads / nvec);
}

template <typename T>
int launch_stats(const void* y, const void* bias, void* part, void* tickets,
                 void* m, void* k, int B, int rows, int H, int W, int C4,
                 int csize, int offset, int true_w, int slabs,
                 int rows_per_slab, double eps, void* stream) {
  if (!shape_ok<T>(C4, csize) || B < 1 || rows < 1 || H < 1 || W < 1
      || slabs < 1 || rows_per_slab < 1
      || (long long)slabs * rows_per_slab < rows)
    return (int)cudaErrorInvalidValue;
  dim3 grid(slabs, B);
  norm_stats_kernel<T><<<grid, threads_for<T>(C4), 0,
                         (cudaStream_t)stream>>>(
      (const T*)y, (const T*)bias, (float*)part, (unsigned int*)tickets,
      (float*)m, (float*)k, rows, H, W, C4, csize, offset, true_w,
      rows_per_slab, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_apply(const void* y, const void* bias, const void* m,
                 const void* k, const void* gamma, const void* beta,
                 void* out, int B, int rows, int H, int W, int C4, int csize,
                 int offset, int true_w, int rows_per_cta, int has_slope,
                 float slope, void* stream) {
  if (!shape_ok<T>(C4, csize) || B < 1 || rows < 1 || H < 1 || W < 1
      || rows_per_cta < 1 || (gamma == nullptr) != (beta == nullptr))
    return (int)cudaErrorInvalidValue;
  dim3 grid((rows + rows_per_cta - 1) / rows_per_cta, B);
  norm_act_apply_kernel<T><<<grid, threads_for<T>(C4), 0,
                             (cudaStream_t)stream>>>(
      (const T*)y, (const T*)bias, (const float*)m, (const float*)k,
      (const T*)gamma, (const T*)beta, (T*)out, rows, H, W, C4, csize,
      offset, true_w, rows_per_cta, has_slope, slope);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int norm_stats_bf16(const void* y, const void* bias, void* part,
                               void* tickets, void* m, void* k, int B,
                               int rows, int H, int W, int C4, int csize,
                               int offset, int true_w, int slabs,
                               int rows_per_slab, double eps, void* stream) {
  return launch_stats<__nv_bfloat16>(y, bias, part, tickets, m, k, B, rows,
                                     H, W, C4, csize, offset, true_w, slabs,
                                     rows_per_slab, eps, stream);
}

extern "C" int norm_stats_f32(const void* y, const void* bias, void* part,
                              void* tickets, void* m, void* k, int B,
                              int rows, int H, int W, int C4, int csize,
                              int offset, int true_w, int slabs,
                              int rows_per_slab, double eps, void* stream) {
  return launch_stats<float>(y, bias, part, tickets, m, k, B, rows, H, W,
                             C4, csize, offset, true_w, slabs, rows_per_slab,
                             eps, stream);
}

extern "C" int norm_act_apply_bf16(const void* y, const void* bias,
                                   const void* m, const void* k,
                                   const void* gamma, const void* beta,
                                   void* out, int B, int rows, int H, int W,
                                   int C4, int csize, int offset, int true_w,
                                   int rows_per_cta, int has_slope,
                                   float slope, void* stream) {
  return launch_apply<__nv_bfloat16>(y, bias, m, k, gamma, beta, out, B,
                                     rows, H, W, C4, csize, offset, true_w,
                                     rows_per_cta, has_slope, slope, stream);
}

extern "C" int norm_act_apply_f32(const void* y, const void* bias,
                                  const void* m, const void* k,
                                  const void* gamma, const void* beta,
                                  void* out, int B, int rows, int H, int W,
                                  int C4, int csize, int offset, int true_w,
                                  int rows_per_cta, int has_slope,
                                  float slope, void* stream) {
  return launch_apply<float>(y, bias, m, k, gamma, beta, out, B, rows, H, W,
                             C4, csize, offset, true_w, rows_per_cta,
                             has_slope, slope, stream);
}
