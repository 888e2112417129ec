// Greedy NMS suppression over a bitmask, shared by the fused detection head
// (detection_head.cu) and the stand-alone greedy pass (greedy_nms.cu).
//
// Layout: mask[i * words + w] holds bit b set when candidate j = 32*w + b
// ranks below i (j > i) and overlaps i above the threshold. above[w] holds
// bit b set when candidate 32*w + b passes the score threshold; bits of
// candidates past K are clear.
//
// One warp walks the ranks in order. Lane w owns word w of the suppressed
// set, so words <= 32 and K <= 1024. At rank i the owner lane's word is
// broadcast; when rank i is above and not yet suppressed, every lane ORs in
// its word of row i (lanes >= words hold zeros). Row i is read one rank
// ahead, so no memory access sits on the chain of dependent steps. The walk
// stops after the last above rank: a rank that is not above suppresses
// nothing, and none after it can be alive.
#pragma once

#include <cstdint>

__device__ __forceinline__ void warp_greedy_suppress(
    const uint32_t* __restrict__ mask, const uint32_t* __restrict__ above,
    uint32_t* __restrict__ keep, int words) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const uint32_t my_above = lane < words ? above[lane] : 0u;
  int last = my_above ? lane * 32 + 31 - __clz(my_above) : -1;
  for (int off = 16; off > 0; off >>= 1) {
    last = max(last, __shfl_xor_sync(full, last, off));
  }
  uint32_t suppressed = 0u;
  uint32_t row = (last >= 0 && lane < words) ? mask[lane] : 0u;
  for (int i = 0; i <= last; ++i) {
    const uint32_t next =
        (i < last && lane < words) ? mask[(i + 1) * words + lane] : 0u;
    const int w = i >> 5;
    const uint32_t bit = 1u << (i & 31);
    const uint32_t sup_w = __shfl_sync(full, suppressed, w);
    const uint32_t above_w = __shfl_sync(full, my_above, w);
    if ((above_w & bit) && !(sup_w & bit)) suppressed |= row;
    row = next;
  }
  if (lane < words) keep[lane] = my_above & ~suppressed;
}
