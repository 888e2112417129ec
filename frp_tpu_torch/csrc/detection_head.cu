// Fused RetinaFace detection head: decode + effective overlap + greedy
// suppression + rank-order slot compaction, one thread-block cluster of 8
// blocks per frame.
//
// Replaces the TPU kernel frp_tpu/ops/detection_pallas.py::_fused_head_kernel.
// Input payload [B, K, 19] f32 (loc 0:4, ldm 4:14, prior cx cy w h 14:18,
// score 18), K <= 256. Rows come sorted by score; the keep mask does not rely
// on it (it reads the score bits, not a prefix length), the slots are filled
// in row order. Output [B, M, 16] f32: box xyxy, 10 landmark coords, score,
// valid flag; empty slots are zero.
//
// Bound on the H100: it moves ~164 KB per batch of 8 at K=256, M=16, so
// bytes bound it below a microsecond; what it costs is the pair tests (up to
// K^2/2, each a chain of min/max/mul and two quotients against a threshold)
// and the greedy pass, whose steps depend on each other. Design:
// - Each block of the cluster copies its frame's payload into shared memory
//   with asynchronous 4-byte copies, all in flight at once (19 KB; seven of
//   the eight reads hit L2), and decodes the K boxes there, one thread a
//   candidate, column-major so that the overlap pass reads them without bank
//   conflicts. Only block 0 decodes the landmarks: only it writes the output.
// - The K x K overlap is thresholded straight into a bitmask (8 KB) that
//   lives in block 0's shared memory. Its rows are dealt to the cluster's 128
//   warps in turn (row i has K-1-i pairs, so dealing them round-robin balances
//   the triangle); a warp builds one 32-candidate word per ballot, all words
//   of a row in one straight line of code, and writes the row into block 0
//   through distributed shared memory.
// - Only what the greedy pass can read is tested: it ORs in row i only when
//   rank i is above the score threshold, and keep = above & ~suppressed, so
//   bit (i, j) matters only when both i and j are above. Rows not above are
//   written as zeros, and a lane whose candidate is below sets no bit. With
//   few candidates above (the usual scan) almost no pair counts.
// - The two quotients of a pair are decided from a fast estimate where that
//   is safe and by the plain version's IEEE divisions only inside a margin
//   around the threshold (estimate_above_one), so the bits stay exact.
// - After one cluster barrier block 0 runs the greedy pass in one warp
//   (greedy.cuh), a word of 32 ranks at a time, and a prefix popcount places
//   each kept rank in its slot.
//
// Build with -fmad=false: every product and sum rounds on its own, in the
// order of the plain version (ops/nms.py::overlap_matrix, ops/decode.py), so
// no contracted FMA can move a "> 1.0" overlap decision.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "greedy.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kPayload = 19;
constexpr int kOutCols = 16;
constexpr int kVals = 15;  // box xyxy, 10 landmark coords, score
constexpr int kMaxK = 256;
constexpr int kMaxWords = kMaxK / 32;
constexpr int kCluster = 8;  // blocks a frame: the portable maximum
constexpr int kThreads = 512;

// Whether num / den / thresh > 1, as the plain version's two IEEE divisions
// decide it, without paying for them where the answer is clear. The quotient
// is first estimated with the fast division and a multiply by the threshold's
// reciprocal, within 4 ulp of the exact value (under 5e-7 relative). An
// estimate further than 1e-5 from 1 decides: *sure says so. A pair inside
// that margin, or with a denominator outside the fast division's range, or a
// NaN, is left to exact_above_one.
__device__ __forceinline__ bool estimate_above_one(float num, float den,
                                                   float inv_thresh, bool* sure) {
  const float est = __fdividef(num, den) * inv_thresh;
  const bool hi = est > 1.00001f;
  *sure = den < 1e30f && (hi || est < 0.99999f);
  return hi;
}

__device__ __forceinline__ bool exact_above_one(float num, float den, float thresh) {
  return num / den / thresh > 1.0f;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
detection_head_kernel(const float* __restrict__ payload, float* __restrict__ out,
                      int k, int m, float conf, float iou_t, float iom_t,
                      float image_size) {
  __shared__ float stage[kMaxK * kPayload];
  // column-major, so a warp reading 32 consecutive candidates hits 32 banks
  __shared__ float vals[kVals][kMaxK];
  __shared__ float area[kMaxK];
  __shared__ uint32_t mask[kMaxK * kMaxWords];  // used in block 0 only
  __shared__ uint32_t above[kMaxWords];
  __shared__ uint32_t keep[kMaxWords];

  cg::cluster_group cluster = cg::this_cluster();
  // every block of the cluster must be running before one writes into
  // another's shared memory: arrive now, wait just before the first write
  cluster.barrier_arrive();
  const int rank = (int)cluster.block_rank();
  const int f = blockIdx.x / kCluster;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const int words = (k + 31) >> 5;
  const float v0 = 0.1f, v1 = 0.2f;
  const float inv_iou = 1.0f / iou_t, inv_iom = 1.0f / iom_t;
  const bool iom_on = iom_t > 0.0f;

  const float* src = payload + (size_t)f * k * kPayload;
  // asynchronous 4-byte copies: all of a thread's loads are in flight at once
  for (int idx = t; idx < k * kPayload; idx += blockDim.x) {
    __pipeline_memcpy_async(stage + idx, src + idx, sizeof(float));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int c = t; c < words * 32; c += blockDim.x) {  // whole warps
    bool is_above = false;
    if (c < k) {
      const float* r = stage + c * kPayload;  // odd stride: no bank conflicts
      const float px = r[14], py = r[15], pw = r[16], ph = r[17];
      const float cx = px + r[0] * v0 * pw;
      const float cy = py + r[1] * v0 * ph;
      const float w = pw * expf(r[2] * v1);
      const float h = ph * expf(r[3] * v1);
      const float x1 = (cx - w / 2.0f) * image_size;
      const float y1 = (cy - h / 2.0f) * image_size;
      const float x2 = (cx + w / 2.0f) * image_size;
      const float y2 = (cy + h / 2.0f) * image_size;
      vals[0][c] = x1;
      vals[1][c] = y1;
      vals[2][c] = x2;
      vals[3][c] = y2;
      if (rank == 0) {
        for (int p = 0; p < 5; ++p) {
          vals[4 + 2 * p][c] = (px + r[4 + 2 * p] * v0 * pw) * image_size;
          vals[5 + 2 * p][c] = (py + r[5 + 2 * p] * v0 * ph) * image_size;
        }
        vals[14][c] = r[18];
      }
      area[c] = fmaxf(x2 - x1, 0.0f) * fmaxf(y2 - y1, 0.0f);
      is_above = r[18] >= conf;
    }
    const uint32_t ballot = __ballot_sync(0xffffffffu, is_above);
    if (lane == 0) above[c >> 5] = ballot;
  }
  __syncthreads();
  cluster.barrier_wait();

  // Row i of the bitmask, one warp per row, rows dealt round-robin over the
  // cluster's warps. Lane b of word w tests candidate j = 32w + b against i;
  // lane w keeps word w, and the row goes to block 0 in one store.
  uint32_t* mask0 = cluster.map_shared_rank(mask, 0);
  for (int i = rank * nwarps + warp; i < k; i += kCluster * nwarps) {
    uint32_t mine = 0u;
    if ((above[i >> 5] >> (i & 31)) & 1u) {
      const float ix1 = vals[0][i], iy1 = vals[1][i];
      const float ix2 = vals[2][i], iy2 = vals[3][i];
      const float ia = area[i];
      // Every word in one straight line of code, so that the loads and the
      // arithmetic of the row's words overlap; words before the diagonal's
      // and words with nobody above test nothing.
#pragma unroll
      for (int w = 0; w < kMaxWords; ++w) {
        const uint32_t aw = (w >= (i >> 5) && w < words) ? above[w] : 0u;
        const int j = w * 32 + lane;
        const bool test = j > i && ((aw >> lane) & 1u);
        const float aj = area[j];
        const float iw = fmaxf(fminf(ix2, vals[2][j]) - fmaxf(ix1, vals[0][j]), 0.0f);
        const float ih = fmaxf(fminf(iy2, vals[3][j]) - fmaxf(iy1, vals[1][j]), 0.0f);
        const float inter = iw * ih;
        // max(IoU / iou_t, IoM / iom_t) > 1 is either term above 1
        const float uni = fmaxf(ia + aj - inter, 1e-12f);
        const float small = fmaxf(fminf(ia, aj), 1e-12f);
        bool sure_iou, sure_iom;
        const bool est_iou = estimate_above_one(inter, uni, inv_iou, &sure_iou);
        const bool est_iom = estimate_above_one(inter, small, inv_iom, &sure_iom);
        bool hit = est_iou || (iom_on && est_iom);
        if (test && inter > 0.0f && !(sure_iou && (sure_iom || !iom_on))) {  // rare
          hit = exact_above_one(inter, uni, iou_t) ||
                (iom_on && exact_above_one(inter, small, iom_t));
        }
        // no intersection: the overlap is 0 whatever the divisions give
        const uint32_t bits = __ballot_sync(0xffffffffu, test && inter > 0.0f && hit);
        if (lane == w) mine = bits;
      }
    }
    if (lane < words) mask0[i * words + lane] = mine;
  }
  cluster.sync();  // every row has landed in block 0
  if (rank != 0) return;

  if (warp == 0) warp_greedy_suppress(mask, above, keep, words);
  __syncthreads();

  int count = 0;
  for (int w = 0; w < words; ++w) count += __popc(keep[w]);
  float* o = out + (size_t)f * m * kOutCols;
  for (int c = t; c < k; c += blockDim.x) {
    if (!((keep[c >> 5] >> (c & 31)) & 1u)) continue;
    int slot = __popc(keep[c >> 5] & ((1u << (c & 31)) - 1u));
    for (int w = 0; w < (c >> 5); ++w) slot += __popc(keep[w]);
    if (slot < m) {
      float* row = o + slot * kOutCols;
      for (int v = 0; v < kVals; ++v) row[v] = vals[v][c];
      row[15] = 1.0f;
    }
  }
  for (int r = t; r < m; r += blockDim.x) {
    if (r < count) continue;
    float* row = o + r * kOutCols;
    for (int v = 0; v < kOutCols; ++v) row[v] = 0.0f;
  }
}

}  // namespace

extern "C" int frp_detection_head(const void* payload, void* out, int b, int k,
                                  int m, float conf, float iou_t, float iom_t,
                                  float image_size, void* stream) {
  if (b <= 0) return 0;
  if (k <= 0 || k > kMaxK || m <= 0 || m > k) return (int)cudaErrorInvalidValue;
  detection_head_kernel<<<b * kCluster, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)payload, (float*)out, k, m, conf, iou_t, iom_t, image_size);
  return (int)cudaGetLastError();
}
