// Fused RetinaFace detection head: decode + effective overlap + greedy
// suppression + rank-order slot compaction, one block per frame.
//
// Replaces the TPU kernel frp_tpu/ops/detection_pallas.py::_fused_head_kernel.
// Input payload [B, K, 19] f32 (loc 0:4, ldm 4:14, prior cx cy w h 14:18,
// score 18), rows sorted by score, K <= 256. Output [B, M, 16] f32: box xyxy,
// 10 landmark coords, score, valid flag; empty slots are zero.
//
// Bound on the H100: it moves ~164 KB per batch of 8 at K=256, M=16, so
// bytes bound it below a microsecond; what holds it back is that one block
// per frame puts the K^2/2 pair tests and the sequential greedy walk of up
// to K ranks on 8 of the 132 SMs (measured on the H100: the pair tests are
// most of its time, the walk a few us). Design: thread t decodes candidate t into
// shared memory (column-major, so the overlap pass reads it without bank
// conflicts); the K x K overlap is thresholded straight into a 256 x 8 word
// bitmask (8 KB; a K x K f32 matrix would be 256 KB, more than a block's
// 227 KB), one warp ballot per word, words at or below the diagonal skipped,
// 32 warps a block to hide the latency; one warp runs the greedy walk
// (greedy.cuh), which stops after the last candidate above the score
// threshold; a prefix popcount places each kept rank in its slot.
//
// Build with -fmad=false: every product and sum rounds on its own, in the
// order of the plain version (ops/nms.py::overlap_matrix, ops/decode.py), so
// no contracted FMA can move a "> 1.0" overlap decision.
#include <cuda_runtime.h>

#include <cstdint>

#include "greedy.cuh"

namespace {

constexpr int kPayload = 19;
constexpr int kOutCols = 16;
constexpr int kVals = 15;  // box xyxy, 10 landmark coords, score
constexpr int kMaxK = 256;
constexpr int kMaxWords = kMaxK / 32;
constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads) detection_head_kernel(
    const float* __restrict__ payload, float* __restrict__ out, int k, int m,
    float conf, float iou_t, float iom_t, float image_size) {
  // column-major, so a warp reading 32 consecutive candidates hits 32 banks
  __shared__ float vals[kVals][kMaxK];
  __shared__ float area[kMaxK];
  __shared__ uint32_t mask[kMaxK * kMaxWords];
  __shared__ uint32_t above[kMaxWords];
  __shared__ uint32_t keep[kMaxWords];

  const int f = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const int words = (k + 31) >> 5;
  const float v0 = 0.1f, v1 = 0.2f;

  if (t < kMaxK) {  // whole warps: kMaxK is a multiple of 32
    bool is_above = false;
    if (t < k) {
      const float* r = payload + ((size_t)f * k + t) * kPayload;
      const float px = r[14], py = r[15], pw = r[16], ph = r[17];
      const float cx = px + r[0] * v0 * pw;
      const float cy = py + r[1] * v0 * ph;
      const float w = pw * expf(r[2] * v1);
      const float h = ph * expf(r[3] * v1);
      const float x1 = (cx - w / 2.0f) * image_size;
      const float y1 = (cy - h / 2.0f) * image_size;
      const float x2 = (cx + w / 2.0f) * image_size;
      const float y2 = (cy + h / 2.0f) * image_size;
      vals[0][t] = x1;
      vals[1][t] = y1;
      vals[2][t] = x2;
      vals[3][t] = y2;
      for (int p = 0; p < 5; ++p) {
        vals[4 + 2 * p][t] = (px + r[4 + 2 * p] * v0 * pw) * image_size;
        vals[5 + 2 * p][t] = (py + r[5 + 2 * p] * v0 * ph) * image_size;
      }
      vals[14][t] = r[18];
      area[t] = fmaxf(x2 - x1, 0.0f) * fmaxf(y2 - y1, 0.0f);
      is_above = r[18] >= conf;
    }
    const uint32_t ballot = __ballot_sync(0xffffffffu, is_above);
    if (lane == 0 && warp < words) above[warp] = ballot;
  }
  __syncthreads();

  // word (i, w) of the bitmask, one warp per word: lane b tests candidate
  // j = 32w + b against i; words wholly at or below the diagonal are 0
  for (int q = warp; q < k * words; q += nwarps) {
    const int i = q / words;
    const int w = q - i * words;
    uint32_t bits = 0u;
    if (w * 32 + 31 > i) {
      const int j = w * 32 + lane;
      bool hit = false;
      if (j > i && j < k) {
        const float ia = area[i];
        const float iw = fmaxf(fminf(vals[2][i], vals[2][j]) - fmaxf(vals[0][i], vals[0][j]), 0.0f);
        const float ih = fmaxf(fminf(vals[3][i], vals[3][j]) - fmaxf(vals[1][i], vals[1][j]), 0.0f);
        const float inter = iw * ih;
        if (inter > 0.0f) {  // no intersection: the overlap is 0, no divisions
          const float uni = ia + area[j] - inter;
          float eff = inter / fmaxf(uni, 1e-12f) / iou_t;
          if (iom_t > 0.0f) {
            const float iom = inter / fmaxf(fminf(ia, area[j]), 1e-12f);
            eff = fmaxf(eff, iom / iom_t);
          }
          hit = eff > 1.0f;
        }
      }
      bits = __ballot_sync(0xffffffffu, hit);
    }
    if (lane == 0) mask[q] = bits;
  }
  __syncthreads();

  if (warp == 0) warp_greedy_suppress(mask, above, keep, words);
  __syncthreads();

  int count = 0;
  for (int w = 0; w < words; ++w) count += __popc(keep[w]);
  float* o = out + (size_t)f * m * kOutCols;
  if (t < k && ((keep[t >> 5] >> (t & 31)) & 1u)) {
    int slot = __popc(keep[t >> 5] & ((1u << (t & 31)) - 1u));
    for (int w = 0; w < (t >> 5); ++w) slot += __popc(keep[w]);
    if (slot < m) {
      float* row = o + slot * kOutCols;
      for (int c = 0; c < kVals; ++c) row[c] = vals[c][t];
      row[15] = 1.0f;
    }
  }
  if (t < m && t >= count) {
    float* row = o + t * kOutCols;
    for (int c = 0; c < kOutCols; ++c) row[c] = 0.0f;
  }
}

}  // namespace

extern "C" int frp_detection_head(const void* payload, void* out, int b, int k,
                                  int m, float conf, float iou_t, float iom_t,
                                  float image_size, void* stream) {
  if (b <= 0) return 0;
  if (k <= 0 || k > kMaxK || m <= 0 || m > k) return (int)cudaErrorInvalidValue;
  detection_head_kernel<<<b, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)payload, (float*)out, k, m, conf, iou_t, iom_t, image_size);
  return (int)cudaGetLastError();
}
