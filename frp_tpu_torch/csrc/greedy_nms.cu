// Greedy NMS keep mask from a precomputed effective-overlap matrix, one
// thread-block cluster per frame.
//
// Replaces the TPU kernel frp_tpu/ops/nms_pallas.py::_suppress_kernel.
// Input overlap [B, K, K] f32 (rows in rank order) and above [B, K] uint8;
// output keep [B, K] uint8 (0 or 1). K <= 1024, any B >= 1.
//
// Bound on the H100: the keep mask depends only on the overlaps above the
// diagonal (j > i), read once: 1.04 MB per batch of 8 at K=256, 4.19 MB at
// K=512 and 16.8 MB at K=1024, so about 0.31, 1.25 and 5.0 us at 3.35 TB/s.
// The kernel reads less than that bound counts (below), so a share of it is
// no efficiency; what its time is made of is a launch, two cluster barriers,
// one round trip to memory and the greedy walk's chain of dependent steps.
// Design:
// - A cluster of 8 blocks per frame, 64 SMs for a batch of 8. Of clusters of
//   16 (the non-portable size) the card runs only 7 at once, so a batch of 8
//   takes two turns: it measured slower at every K, as did 4 blocks and one.
//   Every block turns the above flags into bitmask words for itself.
// - The rows are dealt to the cluster's warps round-robin, a warp a row, so
//   neighbouring rows go to different SMs and the triangle is balanced. Only
//   what the greedy pass can read is loaded: row i only when rank i is above
//   the score threshold (the pass lets no other rank suppress), and of that
//   row only the 32-column words at or right of the diagonal in which some
//   candidate is above (keep = above & ~suppressed, so a bit of a column
//   below is never read). With the usual few candidates above, almost
//   nothing is read.
// - A lane takes 16 bytes a load (K a multiple of 4 and a 16-byte aligned
//   base; else 4 bytes), every load of two rows sent off before the first
//   compare, all index arithmetic compile-time. "> threshold" is the plain
//   version's compare, so NaN and values at the threshold set no bit; the
//   4-bit results of 8 lanes are ORed into a word with three shuffles.
// - The thresholded words go into block 0's shared memory through
//   distributed shared memory, column-major: word w of row i at
//   mask[w * R + i], R = 32 * words + 1 (odd, so the 32 stores of a row hit
//   32 banks). Rows of candidates below and words the walk cannot read are
//   never written; the walk may load such a word but always discards it.
// - After one cluster barrier block 0 walks the ranks a word of 32 at a time
//   in one warp. Lane l keeps one register: bit w set when rank 32w + l was
//   kept. For word w the suppressed bits are gathered lazily, one column of
//   the mask: lane l ORs mask[w * R + 32v + l] over the earlier words v in
//   which its rank was kept (consecutive lanes, consecutive addresses), and
//   one warp-wide OR (redux) joins the lanes. So a step's chain is a load, a
//   redux and the fixed point below, not the OR of 32 whole rows, and half
//   the words are loaded. Within the word, the kept set is the fixed point
//   of "candidate and no kept suppressor" (a ballot a round, see
//   greedy.cuh); the 32 x 32 transposes that tell each lane who suppresses
//   it do not depend on the chain, so all warps compute them for all words
//   at once before the walk starts.
// The mask is dynamic shared memory (128 KB at K=1024); every block of a
// cluster is launched with the same size though only block 0 uses it, and
// the card still runs 15 clusters at once.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, B=8, 60 % of
// the candidates above): 10.5 us at K=256, 15.2 us at K=512, 27.0 us at
// K=1024, of which a launch and the events around it are 5.1 us.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // blocks a frame
constexpr int kThreads = 512;
constexpr int kMaxK = 1024;
constexpr int kMaxWords = kMaxK / 32;
constexpr unsigned kFull = 0xffffffffu;

// One row of the overlap in a warp's registers: what the greedy pass can read
// of it, all loads in flight together. With 16-byte loads, chunk c is columns
// 128c .. 128c+127 and lane l holds 128c + 4l .. +3, so lanes 8g .. 8g+7 hold
// word 4c + g; with 4-byte loads, lane l holds column 32w + l of word w.
// above_w has kMaxWords words, zero past K.
template <bool kVec>
struct Row {
  static constexpr int kLoads = kVec ? kMaxWords / 4 : kMaxWords;
  typename std::conditional<kVec, float4, float>::type v[kLoads];
  uint32_t live;  // bit c: load c was made

  __device__ __forceinline__ void load(const float* __restrict__ row, int i, int k,
                                       const uint32_t* above_w, int lane) {
    const int wi = i >> 5;  // the diagonal's word
    live = 0u;
#pragma unroll
    for (int c = 0; c < kLoads; ++c) {
      if constexpr (kVec) {
        const int w = 4 * c + (lane >> 3);
        const bool on = w >= wi && above_w[w] != 0u && 128 * c + 4 * lane < k;
        v[c] = on ? __ldg(reinterpret_cast<const float4*>(row) + 32 * c + lane)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
        live |= (uint32_t)on << c;
      } else {
        const bool on = c >= wi && above_w[c] != 0u && 32 * c + lane < k;
        v[c] = on ? __ldg(row + 32 * c + lane) : 0.f;
        live |= (uint32_t)on << c;
      }
    }
  }

  // Lane w returns word w of the row's bitmask (bit b: overlap[i][32w + b] >
  // thresh and 32w + b > i); zero for words left of the diagonal, past K, or
  // with no candidate above.
  __device__ __forceinline__ uint32_t words(int i, int k, float thresh, int lane) const {
    const int wi = i >> 5;
    uint32_t mine = 0u;
#pragma unroll
    for (int c = 0; c < kLoads; ++c) {
      const bool on = (live >> c) & 1u;
      if constexpr (kVec) {
        if (4 * c + 3 < wi || 128 * c >= k) continue;  // the same in every lane
        uint32_t word = 0u;
        if (on) {
          word = (uint32_t)(v[c].x > thresh) | (uint32_t)(v[c].y > thresh) << 1 |
                 (uint32_t)(v[c].z > thresh) << 2 | (uint32_t)(v[c].w > thresh) << 3;
          word <<= 4 * (lane & 7);
        }
        word |= __shfl_xor_sync(kFull, word, 1);
        word |= __shfl_xor_sync(kFull, word, 2);
        word |= __shfl_xor_sync(kFull, word, 4);
        // lane l takes word l: chunk l / 4, held by lanes 8 (l % 4) ..
        const uint32_t got = __shfl_sync(kFull, word, 8 * (lane & 3));
        if ((lane >> 2) == c) mine = got;
      } else {
        if (c < wi || 32 * c >= k) continue;  // the same in every lane
        const uint32_t bits = __ballot_sync(kFull, on && v[c] > thresh);
        if (lane == c) mine = bits;
      }
    }
    // nothing at or left of the diagonal
    if (lane == wi) mine &= ~((2u << (i & 31)) - 1u);
    return mine;
  }
};

// Words of shared memory for the mask of `words` words a row.
__host__ __device__ constexpr int mask_stride(int words) { return 32 * words + 1; }

// For each word w with two candidates or more: by[32w + l] = the ranks of
// word w that suppress rank 32w + l (the transpose of the word's 32 x 32
// diagonal block, five butterfly stages over the lanes). Rows never written
// put undefined bits at the positions of ranks that are not above; the walk
// masks them with its candidates.
__device__ __forceinline__ void transpose_diagonals(const uint32_t* mask,
                                                    const uint32_t* above_w,
                                                    uint32_t* by, int words, int warp,
                                                    int warps, int lane) {
  const int stride = mask_stride(words);
  for (int w = warp; w < words; w += warps) {
    const uint32_t aw = above_w[w];
    if ((aw & (aw - 1u)) == 0u) continue;
    uint32_t t = mask[w * stride + 32 * w + lane];
    uint32_t m = 0x0000ffffu;
#pragma unroll
    for (int j = 16; j != 0; j >>= 1, m ^= m << j) {
      const uint32_t other = __shfl_xor_sync(kFull, t, j);
      t = (lane & j) ? (t & ~m) | ((other >> j) & m) : (t & m) | ((other << j) & ~m);
    }
    by[32 * w + lane] = t;
  }
}

// The greedy walk, one warp. Returns nothing; keep_w[w] gets the kept ranks
// of word w.
__device__ __forceinline__ void walk_columns(const uint32_t* mask, const uint32_t* above_w,
                                             const uint32_t* by, uint32_t* keep_w,
                                             int words, int lane) {
  const int stride = mask_stride(words);
  uint32_t kept_in = 0u;  // bit w: rank 32w + lane was kept
  for (int w = 0; w < words; ++w) {
    const uint32_t aw = above_w[w];
    // loaded before it is known to be needed: off the chain (undefined, and
    // unused, for a word with fewer than two candidates above)
    const uint32_t suppressors = by[32 * w + lane];
    uint32_t kept = 0u;
    if (aw != 0u) {  // the same in every lane
      const uint32_t* col = mask + w * stride + lane;
      uint32_t sup = 0u;
#pragma unroll 4
      for (int v = 0; v < w; ++v) {
        const uint32_t word = col[32 * v];
        sup |= ((kept_in >> v) & 1u) ? word : 0u;
      }
      const uint32_t cand = aw & ~__reduce_or_sync(kFull, sup);
      kept = cand;
      if (cand & (cand - 1u)) {  // two candidates or more
        const bool mine = (cand >> lane) & 1u;
        uint32_t prev;
        do {
          prev = kept;
          kept = __ballot_sync(kFull, mine && (suppressors & prev) == 0u);
        } while (kept != prev);
      }
      kept_in |= ((kept >> lane) & 1u) << w;
    }
    if (lane == 0) keep_w[w] = kept;
  }
}

template <bool kVec>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
greedy_nms_kernel(const float* __restrict__ overlap, const uint8_t* __restrict__ above,
                  uint8_t* __restrict__ keep, int k, float thresh) {
  extern __shared__ uint32_t mask[];  // used in block 0 only
  __shared__ uint32_t above_w[kMaxWords];
  __shared__ uint32_t keep_w[kMaxWords];
  __shared__ uint32_t by[kMaxK];

  cg::cluster_group cluster = cg::this_cluster();
  // every block of the cluster must be running before one writes into
  // another's shared memory: arrive now, wait just before the first write
  cluster.barrier_arrive();
  const int rank = (int)cluster.block_rank();
  const int f = blockIdx.x / kCluster;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kThreads / 32;
  const int words = (k + 31) >> 5;
  const float* ov = overlap + (size_t)f * k * k;
  const uint8_t* ab = above + (size_t)f * k;

  for (int w = warp; w < kMaxWords; w += kWarps) {
    const int j = w * 32 + lane;
    const uint32_t bits = __ballot_sync(kFull, j < k && ab[j] != 0);
    if (lane == 0) above_w[w] = bits;
  }
  __syncthreads();
  cluster.barrier_wait();

  uint32_t* mask0 = cluster.map_shared_rank(mask, 0);
  auto is_above = [&](int i) { return i < k && ((above_w[i >> 5] >> (i & 31)) & 1u); };
  auto store = [&](int i, uint32_t mine) {
    // the walk reads word w of row i only for w >= i / 32 with a candidate above
    if (lane >= (i >> 5) && above_w[lane] != 0u) mask0[lane * mask_stride(words) + i] = mine;
  };
  // two rows a turn, so that the second row's loads are in flight while the
  // first is thresholded
  constexpr int kDeal = kCluster * kWarps;
  for (int i = warp * kCluster + rank; i < k; i += 2 * kDeal) {
    const bool on0 = is_above(i), on1 = is_above(i + kDeal);
    Row<kVec> r0, r1;
    if (on0) r0.load(ov + (size_t)i * k, i, k, above_w, lane);
    if (on1) r1.load(ov + (size_t)(i + kDeal) * k, i + kDeal, k, above_w, lane);
    if (on0) store(i, r0.words(i, k, thresh, lane));
    if (on1) store(i + kDeal, r1.words(i + kDeal, k, thresh, lane));
  }
  cluster.sync();  // every row has landed in block 0; nobody writes after it
  if (rank != 0) return;

  transpose_diagonals(mask, above_w, by, words, warp, kWarps, lane);
  __syncthreads();
  if (warp == 0) walk_columns(mask, above_w, by, keep_w, words, lane);
  __syncthreads();

  for (int j = threadIdx.x; j < k; j += kThreads) {
    keep[(size_t)f * k + j] = (uint8_t)((keep_w[j >> 5] >> (j & 31)) & 1u);
  }
}

// Bytes of dynamic shared memory at K.
size_t mask_bytes(int k) {
  const int words = (k + 31) >> 5;
  return (size_t)words * mask_stride(words) * sizeof(uint32_t);
}

template <bool kVec>
cudaError_t launch(const float* overlap, const uint8_t* above, uint8_t* keep, int b,
                   int k, float thresh, cudaStream_t stream) {
  const size_t smem = mask_bytes(k);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(greedy_nms_kernel<kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  greedy_nms_kernel<kVec><<<b * kCluster, kThreads, smem, stream>>>(overlap, above, keep,
                                                                   k, thresh);
  return cudaGetLastError();
}

}  // namespace

extern "C" int frp_greedy_nms(const void* overlap, const void* above,
                              void* keep, int b, int k, float thresh,
                              void* stream) {
  if (b <= 0 || k <= 0) return 0;
  if (k > kMaxK) return (int)cudaErrorInvalidValue;
  // 16-byte loads need every row to start on a 16-byte boundary
  const bool vec = k % 4 == 0 && (uintptr_t)overlap % 16 == 0;
  const auto fn = vec ? launch<true> : launch<false>;
  return (int)fn((const float*)overlap, (const uint8_t*)above, (uint8_t*)keep, b, k,
                 thresh, (cudaStream_t)stream);
}
