// Greedy NMS suppression over a row-major bitmask: the walk of the fused
// detection head (detection_head.cu). The stand-alone greedy pass
// (greedy_nms.cu) has a walk of its own over a column-major mask.
//
// Layout: mask[i * words + w] holds bit b set when candidate j = 32*w + b
// ranks below i (j > i) and overlaps i above the threshold; no bit at or
// before the diagonal is ever set. above[w] holds bit b set when candidate
// 32*w + b passes the score threshold; bits of candidates past K are clear.
// Only rows of candidates above are read.
//
// One warp walks the ranks a word of 32 at a time, so the chain of dependent
// steps is a few per word and not one per rank. Lane w owns word w of the
// suppressed set, so words <= 32 and K <= 1024. For word w:
// - The owner's word is broadcast; the ranks of the word that are above and
//   not suppressed from earlier words are its candidates.
// - Lane b holds the diagonal word of rank 32w + b (whom b suppresses within
//   this word); a butterfly transpose of the 32 x 32 bits over the lanes
//   tells lane b who suppresses b.
// - The kept set is the one set K with "b in K iff b is a candidate and no
//   rank of K suppresses b". It is found by iterating that rule from K = all
//   candidates, one ballot a round: after n rounds every rank whose chain of
//   suppressors is shorter than n is right, and a round that changes nothing
//   ends it. Two to four rounds in practice, 33 at most.
// - The rows of the kept ranks are ORed into the suppressed set. The lanes
//   split into 32 / wpad groups (wpad: words rounded up to 8, 16 or 32); a
//   lane ORs word lane % wpad of every kept rank of its group, all loads in
//   flight together, and a butterfly of shuffles joins the groups.
// A word with no candidate costs two shuffles.
#pragma once

#include <cstdint>

__device__ __forceinline__ void warp_greedy_suppress(
    const uint32_t* __restrict__ mask, const uint32_t* __restrict__ above,
    uint32_t* __restrict__ keep, int words) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int wpad = words <= 8 ? 8 : words <= 16 ? 16 : 32;
  const int groups = 32 / wpad;
  const int my_word = lane & (wpad - 1);
  const int my_group = lane / wpad;
  const uint32_t my_above = lane < words ? above[lane] : 0u;
  uint32_t suppressed = 0u;
  for (int w = 0; w < words; ++w) {
    const uint32_t aw = __shfl_sync(full, my_above, w);
    const uint32_t cand = aw & ~__shfl_sync(full, suppressed, w);
    if (cand == 0u) continue;  // the same in every lane
    const int base = w * 32;
    const bool mine = (cand >> lane) & 1u;
    uint32_t kept = cand;
    if (cand & (cand - 1u)) {  // two candidates or more
      const uint32_t diag = mine ? mask[(base + lane) * words + w] & cand : 0u;
      // transpose the 32 x 32 bits over the lanes, five butterfly stages:
      // by = the candidates that suppress this lane's rank
      uint32_t by = diag;
      uint32_t m = 0x0000ffffu;
#pragma unroll
      for (int j = 16; j != 0; j >>= 1, m ^= m << j) {
        const uint32_t other = __shfl_xor_sync(full, by, j);
        by = (lane & j) ? (by & ~m) | ((other >> j) & m) : (by & m) | ((other << j) & ~m);
      }
      uint32_t prev;
      do {
        prev = kept;
        kept = __ballot_sync(full, mine && (by & prev) == 0u);
      } while (kept != prev);
    }
    uint32_t rows = 0u;
    if (my_word < words) {
#pragma unroll 8
      for (int b = my_group; b < 32; b += groups) {
        // no branch, so that the loads go out together; a rank not kept
        // reads row 0 for nothing (its own row may lie past K)
        const bool on = (kept >> b) & 1u;
        const uint32_t row = mask[on ? (base + b) * words + my_word : my_word];
        rows |= on ? row : 0u;
      }
    }
    for (int off = wpad; off < 32; off <<= 1) rows |= __shfl_xor_sync(full, rows, off);
    suppressed |= rows;  // lanes past `words` gather words nobody reads
  }
  if (lane < words) keep[lane] = my_above & ~suppressed;
}
