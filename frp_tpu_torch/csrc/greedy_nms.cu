// Greedy NMS keep mask from a precomputed effective-overlap matrix, one block
// per frame.
//
// Replaces the TPU kernel frp_tpu/ops/nms_pallas.py::_suppress_kernel.
// Input overlap [B, K, K] f32 (rows in rank order) and above [B, K] uint8;
// output keep [B, K] uint8. K <= 1024.
//
// Bound on the H100: the keep mask depends only on the overlaps above the
// diagonal (j > i), which it reads once: 1.04 MB per batch of 8 at K=256 and
// 4.19 MB at K=512, so about 0.31 us and 1.25 us at 3.35 TB/s; what holds it
// back is that one block per frame reads on 8 of the 132 SMs
// (measured on the H100: the read is most of its time, the sequential walk
// over the ranks the rest). Design: each warp reads 32 consecutive
// overlaps of a row (one 128-byte load), eight such loads in flight before it
// turns each "> threshold and j > i" test into a bitmask word with a ballot,
// and skips the segments at or below the diagonal (half the bytes); the K x K
// bitmask sits in dynamic shared memory (128 KB at K=1024); one warp then
// runs the greedy walk shared with the detection head (greedy.cuh).
#include <cuda_runtime.h>

#include <cstdint>

#include "greedy.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxK = 1024;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads) greedy_nms_kernel(
    const float* __restrict__ overlap, const uint8_t* __restrict__ above,
    uint8_t* __restrict__ keep, int k, float thresh) {
  extern __shared__ uint32_t smem[];
  const int words = (k + 31) >> 5;
  uint32_t* mask = smem;                   // k * words
  uint32_t* above_w = mask + k * words;    // words
  uint32_t* keep_w = above_w + 32;         // words

  const int f = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* ov = overlap + (size_t)f * k * k;
  const uint8_t* ab = above + (size_t)f * k;

  // word q = (i, w) of the bitmask: lane b tests overlap[i][32w + b]; each
  // warp issues kUnroll row segments before it ballots, so that many loads
  // are in flight, and reads nothing at or below the diagonal
  const int total = k * words;
  for (int q0 = warp; q0 < total; q0 += nwarps * kUnroll) {
    float v[kUnroll];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = q0 + u * nwarps;
      const int i = q / words;
      const int j = (q - i * words) * 32 + lane;
      live[u] = q < total && j < k && j > i;
      v[u] = live[u] ? ov[(size_t)i * k + j] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = q0 + u * nwarps;
      const uint32_t bits = __ballot_sync(0xffffffffu, live[u] && v[u] > thresh);
      if (lane == 0 && q < total) mask[q] = bits;
    }
  }
  for (int w = warp; w < words; w += nwarps) {
    const int j = w * 32 + lane;
    const uint32_t bits = __ballot_sync(0xffffffffu, j < k && ab[j] != 0);
    if (lane == 0) above_w[w] = bits;
  }
  __syncthreads();

  if (warp == 0) warp_greedy_suppress(mask, above_w, keep_w, words);
  __syncthreads();

  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    keep[(size_t)f * k + j] = (uint8_t)((keep_w[j >> 5] >> (j & 31)) & 1u);
  }
}

}  // namespace

extern "C" int frp_greedy_nms(const void* overlap, const void* above,
                              void* keep, int b, int k, float thresh,
                              void* stream) {
  if (b <= 0 || k <= 0) return 0;
  if (k > kMaxK) return (int)cudaErrorInvalidValue;
  const int words = (k + 31) >> 5;
  const size_t smem = ((size_t)k * words + 64) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        greedy_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  greedy_nms_kernel<<<b, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)overlap, (const uint8_t*)above, (uint8_t*)keep, k, thresh);
  return (int)cudaGetLastError();
}
