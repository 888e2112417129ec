// Exact bilinear warp of aligned face crops, one thread per output pixel.
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
// Design: no window or shear passes (the TPU kernel's workaround for its
// gather limits); each thread does the 4-tap gather for its pixel from the
// uint8 frame (the taps of one face stay in L1/L2) and writes its 3 channels,
// so a warp stores 384 contiguous bytes. Built with -fmad=false so that the
// coordinate arithmetic rounds like the plain version and floor() ties land
// on the same side.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) warp_crops_kernel(
    const uint8_t* __restrict__ frames, const float* __restrict__ inv,
    float* __restrict__ out, int h, int w, int m, int s) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= s * s) return;
  const int face = blockIdx.y;
  const int f = blockIdx.z;
  const int y = p / s;
  const int x = p - y * s;
  const float* mi = inv + ((size_t)f * m + face) * 6;
  const float gx = (float)x + 0.5f;
  const float gy = (float)y + 0.5f;
  float sx = mi[0] * gx + mi[1] * gy + mi[2];
  float sy = mi[3] * gx + mi[4] * gy + mi[5];
  sx = fminf(fmaxf(sx - 0.5f, 0.0f), (float)(w - 1));
  sy = fminf(fmaxf(sy - 0.5f, 0.0f), (float)(h - 1));
  const int x0 = min((int)floorf(sx), w - 2);
  const int y0 = min((int)floorf(sy), h - 2);
  const float wx = sx - (float)x0;
  const float wy = sy - (float)y0;
  const uint8_t* a = frames + (((size_t)f * h + y0) * w + x0) * 3;
  const uint8_t* c = a + (size_t)w * 3;
  float* o = out + (((size_t)f * m + face) * s * s + p) * 3;
  for (int ch = 0; ch < 3; ++ch) {
    const float top = (float)a[ch] * (1.0f - wx) + (float)a[ch + 3] * wx;
    const float bot = (float)c[ch] * (1.0f - wx) + (float)c[ch + 3] * wx;
    o[ch] = top * (1.0f - wy) + bot * wy;
  }
}

}  // namespace

extern "C" int frp_warp_crops(const void* frames, const void* inv, void* out,
                              int b, int h, int w, int m, int s, void* stream) {
  if (b <= 0 || m <= 0 || s <= 0) return 0;
  if (h < 2 || w < 2 || m > 65535 || b > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((s * s + kThreads - 1) / kThreads, m, b);
  warp_crops_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const float*)inv, (float*)out, h, w, m, s);
  return (int)cudaGetLastError();
}
