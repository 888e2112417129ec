// Exact bilinear warp of aligned face crops: 16 x 16 output tiles, a warp per
// 16 x 8 pixels, taps read as aligned words, 16-byte stores.
//
// Replaces the TPU kernel frp_tpu/ops/align_pallas.py::_warp_kernel, and
// computes what frp_tpu/ops/align.py::warp_crops_batched computes: for each
// (frame, face) an S x S x 3 crop sampled through the inverse similarity at
// pixel centres (+0.5), coordinates clamped to [0, w-1] in float space before
// floor, x0 = min(floor, w-2), weights taken against the clamped index.
// Input frames [B, H, W, 3] uint8 (read directly: uint8 -> f32 is exact, so
// no f32 copy of the frame batch is made), inverse matrices [B, M, 2, 3] f32;
// output [B, M, S, S, 3] f32.
//
// Bound on the H100: at B=8, M=16, S=112, 640x640 frames it writes 19.3 MB
// of f32 crops and reads at most 9.8 MB of frames, about 8.7 us at 3.35 TB/s.
// What costs more than the bytes is the load/store path and the instructions
// around it: a tap is 6 bytes of each of two source rows, and a warp's loads
// touch as many cache lines as its pixels reach over source rows. Design:
// - No window or shear passes (the TPU kernel's workaround for its gather
//   limits). A block owns a 16 x 16 tile of one face's crop and a warp 16 x 8
//   pixels of it, so a warp's taps fall in a compact patch of the frame
//   whatever the rotation (a warp of 32 pixels of one row reaches over
//   32 * sin(angle) * scale source rows). 16 lanes lie along a row of the
//   tile, so that one load of the warp reads neighbouring source pixels, and
//   a thread takes 4 pixels of its column. The warps of a block share
//   nothing: there is no barrier.
// - A tap row is read as two or three aligned 32-bit words and shifted into
//   place, not as six single bytes: a quarter of the load instructions.
// - The taps come straight from global memory, through L1. Copying each
//   tile's footprint into shared memory first (16-byte asynchronous copies of
//   the exact bounding box of the tile's taps) was built and timed on the
//   H100 at several budgets and never won: the copy puts a second round trip
//   and a barrier before the taps, and shared memory that a block reserves is
//   L1 that every block loses.
// - The pixels go through the warp's shared memory so that consecutive lanes
//   store consecutive float4: each 16-pixel row is 192 contiguous, 16-byte
//   aligned bytes of the crop. When S is not a multiple of 4 the rows are not
//   aligned and each thread stores its floats.
// Built with -fmad=false so that the coordinate arithmetic rounds like the
// plain version and floor() ties land on the same side.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kTile = 16;                    // a block's tile: 16 x 16 output pixels
constexpr int kPx = 4;                       // pixels of a column a thread
constexpr int kThreads = kTile * kTile / kPx;
constexpr int kWarps = kThreads / 32;        // a warp owns 8 rows of the tile
constexpr int kVecs = 32 * kPx * 3 / 4;      // float4 a warp stores

struct Tap {  // where one output pixel samples the frame
  int x0, y0;
  float wx, wy;
};

__device__ __forceinline__ float blend(float a, float b, float c, float d,
                                       float wx, float wy) {
  const float top = a * (1.0f - wx) + b * wx;
  const float bot = c * (1.0f - wx) + d * wx;
  return top * (1.0f - wy) + bot * wy;
}

// One output pixel's three channels from the 6 consecutive bytes (R G B of
// x0, then of x0 + 1) of its two tap rows, each given as the 4 bytes from the
// first on (lo) and the 4 after (hi).
__device__ __forceinline__ void sample(const uint32_t lo[2], const uint32_t hi[2],
                                       float wx, float wy, float r[3]) {
  r[0] = blend((float)(lo[0] & 255u), (float)(lo[0] >> 24),
               (float)(lo[1] & 255u), (float)(lo[1] >> 24), wx, wy);
  r[1] = blend((float)((lo[0] >> 8) & 255u), (float)(hi[0] & 255u),
               (float)((lo[1] >> 8) & 255u), (float)(hi[1] & 255u), wx, wy);
  r[2] = blend((float)((lo[0] >> 16) & 255u), (float)((hi[0] >> 8) & 255u),
               (float)((lo[1] >> 16) & 255u), (float)((hi[1] >> 8) & 255u), wx, wy);
}

__global__ void __launch_bounds__(kThreads) warp_crops_kernel(
    const uint8_t* __restrict__ frames, const float* __restrict__ inv,
    float* __restrict__ out, int h, int w, int m, int s, int tiles, int vec) {
  // the warps' float4 on their way out
  __shared__ float4 stores[kWarps][kVecs];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile_y = blockIdx.x / tiles;
  const int tile_x = blockIdx.x - tile_y * tiles;
  // a warp's 16 x 8 pixels: 16 lanes along a row, so that one load of the
  // warp reads neighbouring source pixels; a thread's kPx pixels are every
  // second row of its column
  const int col = lane & 15;
  const int x = tile_x * kTile + col;
  const int y0w = tile_y * kTile + warp * 8;  // the warp's first row
  const int row0 = lane >> 4;                 // the thread's: row0, row0 + 2, ...
  const int face = blockIdx.y;
  const int f = blockIdx.z;

  const float* mi = inv + ((size_t)f * m + face) * 6;
  const float m0 = mi[0], m1 = mi[1], m2 = mi[2], m3 = mi[3], m4 = mi[4], m5 = mi[5];
  const float gx = (float)x + 0.5f;
  Tap tap[kPx];
#pragma unroll
  for (int p = 0; p < kPx; ++p) {
    const float gy = (float)(y0w + row0 + 2 * p) + 0.5f;
    float sx = m0 * gx + m1 * gy + m2;
    float sy = m3 * gx + m4 * gy + m5;
    sx = fminf(fmaxf(sx - 0.5f, 0.0f), (float)(w - 1));
    sy = fminf(fmaxf(sy - 0.5f, 0.0f), (float)(h - 1));
    tap[p].x0 = min((int)floorf(sx), w - 2);
    tap[p].y0 = min((int)floorf(sy), h - 2);
    tap[p].wx = sx - (float)tap[p].x0;
    tap[p].wy = sy - (float)tap[p].y0;
  }

  const uint8_t* frame = frames + (size_t)f * h * w * 3;
  // a byte of the frame as a 32-bit offset from the aligned address below it
  const int align = (int)((uintptr_t)frame & 3);
  float r[kPx][3];
#pragma unroll
  for (int p = 0; p < kPx; ++p) {
    // the 6 bytes of a tap row lie in two aligned words, or in three when the
    // first byte is a word's last; the third is read only then, so no word is
    // read that holds no byte of the frames
    uint32_t lo[2], hi[2];
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int o = align + ((tap[p].y0 + v) * w + tap[p].x0) * 3;
      const uint32_t* q = reinterpret_cast<const uint32_t*>(frame - align + (o & ~3));
      const int sh = (o & 3) * 8;
      const uint32_t q2 = sh == 24 ? q[2] : 0u;
      lo[v] = __funnelshift_r(q[0], q[1], sh);
      hi[v] = __funnelshift_r(q[1], q2, sh);
    }
    sample(lo, hi, tap[p].wx, tap[p].wy, r[p]);
  }

  float* crop = out + ((size_t)f * m + face) * s * s * 3;
  if (vec) {
    // s is a multiple of 4, so every 16-pixel row of the tile is whole float4
    // of the crop. The pixels go through shared memory, so that consecutive
    // lanes store consecutive float4: a row is 192 contiguous bytes.
    float* mine = reinterpret_cast<float*>(stores[warp]);
#pragma unroll
    for (int p = 0; p < kPx; ++p) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) mine[((row0 + 2 * p) * kTile + col) * 3 + ch] = r[p][ch];
    }
    __syncwarp();
    const int rows = min(8, s - y0w);
    const int vecs = min(kTile, s - tile_x * kTile) * 3 / 4;
#pragma unroll
    for (int i = lane; i < kVecs; i += 32) {
      const int row = i / 12;
      const int v = i - row * 12;
      if (row < rows && v < vecs) {
        float* o = crop + ((size_t)(y0w + row) * s + tile_x * kTile) * 3;
        reinterpret_cast<float4*>(o)[v] = stores[warp][i];
      }
    }
  } else if (x < s) {
#pragma unroll
    for (int p = 0; p < kPx; ++p) {
      const int y = y0w + row0 + 2 * p;
      if (y < s) {
        float* o = crop + ((size_t)y * s + x) * 3;
        for (int ch = 0; ch < 3; ++ch) o[ch] = r[p][ch];
      }
    }
  }
}

}  // namespace

extern "C" int frp_warp_crops(const void* frames, const void* inv, void* out,
                              int b, int h, int w, int m, int s, void* stream) {
  if (b <= 0 || m <= 0 || s <= 0) return 0;
  if (h < 2 || w < 2 || m > 65535 || b > 65535) return (int)cudaErrorInvalidValue;
  if ((long long)h * w * 3 > INT_MAX - 16) return (int)cudaErrorInvalidValue;
  const int tiles = (s + kTile - 1) / kTile;
  const int vec = s % 4 == 0 && (uintptr_t)out % 16 == 0;
  const dim3 grid(tiles * tiles, m, b);
  warp_crops_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const float*)inv, (float*)out, h, w, m, s, tiles, vec);
  return (int)cudaGetLastError();
}
