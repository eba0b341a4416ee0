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
// back; there is no matrix work. The design keeps that to one pass: one
// thread per output element (x fastest, so a warp touches 32 neighbouring
// addresses, or reverse-neighbouring ones for a flipped read), the unflips
// as index arithmetic, and no atomics, because an element belongs to one
// thread and launches on a stream are serialized.
//
// Numerics follow the TPU kernel: the sum runs in fp32 in its order
// (a0+b0, +a1, +b1, +a2, +b2, +a3, +b3 with a = combos 0..3 at plane d and
// b = combos 4..7 at plane od-1-d), then u * (g * scale), then the add; the
// _rn intrinsics keep the compiler from contracting these into FMAs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void accumulate_kernel(float* __restrict__ logits,
                                  const T* __restrict__ preds,
                                  const T* __restrict__ g, int C, int D, int H,
                                  int W, int od, int ph, int pw, int zo, int sy,
                                  int sz, float scale) {
  const int64_t plane = (int64_t)ph * pw;
  const int64_t vol = (int64_t)od * plane;
  const int64_t total = (int64_t)C * vol;
  const int64_t combo = total;  // stride between combos in preds
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int x = (int)(e % pw);
    const int y = (int)((e / pw) % ph);
    const int d = (int)((e / plane) % od);
    const int c = (int)(e / vol);
    const int64_t base = (int64_t)c * vol;
    const int64_t pa = base + (int64_t)d * plane;            // plane d
    const int64_t pb = base + (int64_t)(od - 1 - d) * plane;  // plane od-1-d
    const int64_t yx = (int64_t)y * pw + x;
    const int64_t hy = (int64_t)(ph - 1 - y) * pw + x;
    const int64_t wx = (int64_t)y * pw + (pw - 1 - x);
    const int64_t hw = (int64_t)(ph - 1 - y) * pw + (pw - 1 - x);
    float u = __fadd_rn(to_f32(preds[pa + yx]), to_f32(preds[4 * combo + pb + yx]));
    u = __fadd_rn(u, to_f32(preds[1 * combo + pa + hy]));
    u = __fadd_rn(u, to_f32(preds[5 * combo + pb + hy]));
    u = __fadd_rn(u, to_f32(preds[2 * combo + pa + wx]));
    u = __fadd_rn(u, to_f32(preds[6 * combo + pb + wx]));
    u = __fadd_rn(u, to_f32(preds[3 * combo + pa + hw]));
    u = __fadd_rn(u, to_f32(preds[7 * combo + pb + hw]));
    const float gs = __fmul_rn(to_f32(g[(int64_t)d * plane + yx]), scale);
    float* out = logits +
                 (((int64_t)c * D + (zo + d)) * H + (sy + y)) * (int64_t)W +
                 (sz + x);
    *out = __fadd_rn(*out, __fmul_rn(u, gs));
  }
}

template <typename T>
int launch(float* logits, const void* preds, const void* g, int C, int D,
           int H, int W, int od, int ph, int pw, int zo, int sy, int sz,
           int valid, void* stream) {
  const int64_t total = (int64_t)C * od * ph * pw;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  const float scale = (float)valid * 0.125f;
  accumulate_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      logits, (const T*)preds, (const T*)g, C, D, H, W, od, ph, pw, zo, sy, sz,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int accumulate_tta_tile_bf16(void* logits, const void* preds,
                                        const void* g, int C, int D, int H,
                                        int W, int od, int ph, int pw, int zo,
                                        int sy, int sz, int valid,
                                        void* stream) {
  return launch<__nv_bfloat16>((float*)logits, preds, g, C, D, H, W, od, ph,
                               pw, zo, sy, sz, valid, stream);
}

extern "C" int accumulate_tta_tile_f32(void* logits, const void* preds,
                                       const void* g, int C, int D, int H,
                                       int W, int od, int ph, int pw, int zo,
                                       int sy, int sz, int valid,
                                       void* stream) {
  return launch<float>((float*)logits, preds, g, C, D, H, W, od, ph, pw, zo,
                       sy, sz, valid, stream);
}
