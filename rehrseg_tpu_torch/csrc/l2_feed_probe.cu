// A measuring probe, on no path of the port: how fast TMA boxes shaped like
// the conv kernels' input tiles arrive in shared memory, from L2 (a region
// that fits in it) or from device memory (one that does not).
//
// The region is a (rows, ci) bf16 matrix. Every block keeps a ring of 4
// stages of three 16 KB boxes (128 rows x 64 channels, the 128-byte swizzle:
// one input tile of sm90_pipeline.cuh) in flight and asks for a stage again as
// soon as it has landed; nothing reads the data. One block per SM, one
// thread working. bytes = blocks * iters * 48 KB.

#include "sm90_pipeline.cuh"

namespace {

using namespace sm90;

constexpr int PROBE_STAGES = 4;
constexpr int PROBE_STAGE_BYTES = 3 * A_BOX_BYTES;

__global__ void __launch_bounds__(32, 1)
l2_feed_kernel(const __grid_constant__ CUtensorMap map, int rows, int ci,
               int iters) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = ring + PROBE_STAGES * PROBE_STAGE_BYTES;
  if (threadIdx.x != 0) return;
  for (int s = 0; s < PROBE_STAGES; ++s) mbar_init(bars + 8u * s, 1);
  fence_barrier_init();
  const int row_blocks = rows / TILE_PIX, chunks = ci / BK;
  auto refill = [&](int it) {
    const int s = it % PROBE_STAGES;
    const uint32_t bar = bars + 8u * s;
    mbar_expect_tx(bar, PROBE_STAGE_BYTES);
    for (int k = 0; k < 3; ++k) {
      // neighbouring blocks read neighbouring boxes, each box once a sweep
      const long long box =
          ((long long)it * gridDim.x + blockIdx.x) * 3 + k;
      const int c0 = (int)(box % chunks) * BK;
      const int r0 = (int)((box / chunks) % row_blocks) * TILE_PIX;
      tma_load_2d(ring + s * PROBE_STAGE_BYTES + k * A_BOX_BYTES, &map, bar,
                  c0, r0);
    }
  };
  for (int it = 0; it < PROBE_STAGES && it < iters; ++it) refill(it);
  for (int it = 0; it < iters; ++it) {
    mbar_wait(bars + 8u * (it % PROBE_STAGES),
              (uint32_t)(it / PROBE_STAGES) & 1u);
    if (it + PROBE_STAGES < iters) refill(it + PROBE_STAGES);
  }
}

}  // namespace

// buf: (rows, ci) bf16, rows % 128 == 0, ci % 64 == 0. Launches one block
// per SM, each pulling iters stages of 48 KB; writes the block count to
// *blocks. Returns the CUDA error of the launch.
extern "C" int l2_feed_probe(const void* buf, int rows, int ci, int iters,
                             int* blocks, void* stream) {
  if (rows % TILE_PIX || ci % BK || rows < TILE_PIX) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const uint64_t dims[2] = {(uint64_t)ci, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)ci * 2};
  const uint32_t box[2] = {BK, TILE_PIX};
  int err = make_map(&map, buf, 2, dims, strides, box);
  if (err) return err;
  constexpr int smem = PROBE_STAGES * PROBE_STAGE_BYTES + 1024 + 64;
  cudaError_t e = cudaFuncSetAttribute(
      l2_feed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  *blocks = sm_count();
  l2_feed_kernel<<<*blocks, 32, smem, (cudaStream_t)stream>>>(map, rows, ci,
                                                              iters);
  return (int)cudaGetLastError();
}
