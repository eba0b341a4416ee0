// K2: fused mirror-TTA unmirror + mean + gaussian weight + accumulate.
//
// Replaces the TPU kernel rehrseg_tpu/ops/pallas_tail.py accumulate_tta_tile
// (:222, body _kernel :71). For one tile:
//
//   logits[c, zo+d, sy+y, sz+x] += (g[d,y,x] * valid * 0.125) * u
//   u = sum over the 8 z-grouped combos i of unflip_i(preds[i, c])[d, y, x]
//
// What bounds it on the H100: bytes. Per output element it reads 8 preds,
// one gaussian value and the fp32 accumulator, and writes the accumulator
// back; there is no matrix work, so no TMA and no wgmma: 16-byte loads with
// enough of them in flight reach the memory rate. The design:
//
// - A 3-D grid with no per-element division: blockIdx.z walks the C x od
//   output planes (one division by od per plane), blockIdx.y / threadIdx.y
//   the rows, blockIdx.x / threadIdx.x the chunks of a row. Every address
//   comes from these indices and the strides.
// - The vector instance (V lanes of 16 bytes: 8 bf16 or 4 fp32) gives each
//   thread one chunk of a row: nine 16-byte loads (the chunk of plane d for
//   combos 0-3, of plane od-1-d for combos 4-7, and the gaussian's), then
//   the accumulator as float4s, all issued before any arithmetic (about
//   176 bytes a thread in bf16; a block of 240 threads, eight blocks an SM,
//   keeps some 300 KB in flight per SM). The unflips are index arithmetic:
//   an h-flip reads row ph-1-y, a w-flip the mirrored chunk at pw-V-x0,
//   whose lanes the thread then takes in reverse order; the lanes are
//   registers named at compile time, so the reversal costs no instruction.
//   Preds and the gaussian are read once (streaming loads); the
//   accumulator is read and written through L2 only.
// - The general instance (V = 1, one element a thread, the same grid)
//   takes what the vector one cannot: a row width that is not a whole
//   number of chunks, an accumulator row or start that is not a multiple
//   of 4, or base pointers that are not 16-byte aligned. The launcher
//   (ops/tail.py _k2_vector_ok) chooses; the vector entry refuses operands
//   it cannot take.
// - No atomics: an output element belongs to one thread, and launches on
//   a stream are serialized.
//
// Numerics follow the TPU kernel: the sum runs in fp32 in its order
// (a0+b0, +a1, +b1, +a2, +b2, +a3, +b3 with a = combos 0..3 at plane d and
// b = combos 4..7 at plane od-1-d), then u * (g * scale), then the add; the
// _rn intrinsics keep the compiler from contracting these into FMAs, so
// both instances are bit-equal to the plain PyTorch version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// V lanes of T as loaded: raw registers, lane j read as an fp32 value
// (j is a compile-time constant once the lane loops are unrolled)
template <typename T, int V>
struct Lanes;

template <>
struct Lanes<__nv_bfloat16, 8> {
  uint4 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = __ldcs(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ float operator[](int j) const {
    const uint32_t w = j < 2 ? r.x : j < 4 ? r.y : j < 6 ? r.z : r.w;
    return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

template <>
struct Lanes<float, 4> {
  float4 r;
  __device__ __forceinline__ void load(const float* p) {
    r = __ldcs(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ float operator[](int j) const {
    return j == 0 ? r.x : j == 1 ? r.y : j == 2 ? r.z : r.w;
  }
};

template <>
struct Lanes<__nv_bfloat16, 1> {
  __nv_bfloat16 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = __ldcs(p);
  }
  __device__ __forceinline__ float operator[](int) const {
    return __bfloat162float(r);
  }
};

template <>
struct Lanes<float, 1> {
  float r;
  __device__ __forceinline__ void load(const float* p) { r = __ldcs(p); }
  __device__ __forceinline__ float operator[](int) const { return r; }
};

// V fp32 accumulator values: float4s when V is a multiple of 4
template <int V>
__device__ __forceinline__ void load_acc(const float* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = __ldcg(p);
  } else {
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const float4 q = __ldcg(reinterpret_cast<const float4*>(p) + k);
      v[4 * k] = q.x;
      v[4 * k + 1] = q.y;
      v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
  }
}

template <int V>
__device__ __forceinline__ void store_acc(float* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    __stcg(p, v[0]);
  } else {
#pragma unroll
    for (int k = 0; k < V / 4; ++k)
      __stcg(reinterpret_cast<float4*>(p) + k,
             make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]));
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    accumulate_kernel(float* __restrict__ logits, const T* __restrict__ preds,
                      const T* __restrict__ g, int C, int D, int H, int W,
                      int od, int ph, int pw, int zo, int sy, int sz,
                      float scale) {
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (x0 >= pw) return;
  const int xr = pw - V - x0;  // the w-flip's mirrored chunk
  const int64_t plane = (int64_t)ph * pw;
  const int64_t combo = (int64_t)C * od * plane;  // stride between combos
  for (int cd = blockIdx.z; cd < C * od; cd += gridDim.z) {
    const int c = cd / od;
    const int d = cd - c * od;
    const T* pa = preds + (int64_t)cd * plane;                   // plane d
    const T* pb = preds + 4 * combo + (int64_t)(cd + od - 1 - 2 * d) * plane;
    const T* gd = g + (int64_t)d * plane;
    float* acc = logits + ((int64_t)c * D + zo + d) * H * (int64_t)W + sz + x0;
    for (int y = blockIdx.y * blockDim.y + threadIdx.y; y < ph;
         y += gridDim.y * blockDim.y) {
      const int64_t r = (int64_t)y * pw;
      const int64_t rh = (int64_t)(ph - 1 - y) * pw;  // the h-flip's row
      Lanes<T, V> a0, b0, a1, b1, a2, b2, a3, b3, gv;
      a0.load(pa + r + x0);
      b0.load(pb + r + x0);
      a1.load(pa + combo + rh + x0);
      b1.load(pb + combo + rh + x0);
      a2.load(pa + 2 * combo + r + xr);
      b2.load(pb + 2 * combo + r + xr);
      a3.load(pa + 3 * combo + rh + xr);
      b3.load(pb + 3 * combo + rh + xr);
      gv.load(gd + r + x0);
      float* out = acc + (int64_t)(sy + y) * W;
      float v[V];
      load_acc<V>(out, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int m = V - 1 - j;  // lane j of a w-flipped chunk
        float u = __fadd_rn(a0[j], b0[j]);
        u = __fadd_rn(u, a1[j]);
        u = __fadd_rn(u, b1[j]);
        u = __fadd_rn(u, a2[m]);
        u = __fadd_rn(u, b2[m]);
        u = __fadd_rn(u, a3[m]);
        u = __fadd_rn(u, b3[m]);
        v[j] = __fadd_rn(v[j], __fmul_rn(u, __fmul_rn(gv[j], scale)));
      }
      store_acc<V>(out, v);
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T, int V>
int launch(float* logits, const void* preds, const void* g, int C, int D,
           int H, int W, int od, int ph, int pw, int zo, int sy, int sz,
           int valid, void* stream) {
  if (V > 1 && (pw % V != 0 || W % 4 != 0 || sz % 4 != 0 ||
                !aligned16(logits) || !aligned16(preds) || !aligned16(g)))
    return (int)cudaErrorInvalidValue;
  const int chunks = pw / V + (pw % V != 0);
  const int bx = chunks < kThreads ? chunks : kThreads;
  const int by = kThreads / bx;
  const dim3 block(bx, by);
  const int gy = (ph + by - 1) / by;
  const int planes = C * od;
  const dim3 grid((chunks + bx - 1) / bx, gy < 65535 ? gy : 65535,
                  planes < 65535 ? planes : 65535);
  const float scale = (float)valid * 0.125f;
  accumulate_kernel<T, V><<<grid, block, 0, (cudaStream_t)stream>>>(
      logits, (const T*)preds, (const T*)g, C, D, H, W, od, ph, pw, zo, sy,
      sz, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// vec = 1: the vector instance (16-byte chunks; refuses operands it cannot
// take); vec = 0: the general one
extern "C" int accumulate_tta_tile_bf16(void* logits, const void* preds,
                                        const void* g, int C, int D, int H,
                                        int W, int od, int ph, int pw, int zo,
                                        int sy, int sz, int valid, int vec,
                                        void* stream) {
  return vec ? launch<__nv_bfloat16, 8>((float*)logits, preds, g, C, D, H, W,
                                        od, ph, pw, zo, sy, sz, valid, stream)
             : launch<__nv_bfloat16, 1>((float*)logits, preds, g, C, D, H, W,
                                        od, ph, pw, zo, sy, sz, valid, stream);
}

extern "C" int accumulate_tta_tile_f32(void* logits, const void* preds,
                                       const void* g, int C, int D, int H,
                                       int W, int od, int ph, int pw, int zo,
                                       int sy, int sz, int valid, int vec,
                                       void* stream) {
  return vec ? launch<float, 4>((float*)logits, preds, g, C, D, H, W, od, ph,
                                pw, zo, sy, sz, valid, stream)
             : launch<float, 1>((float*)logits, preds, g, C, D, H, W, od, ph,
                                pw, zo, sy, sz, valid, stream);
}
