// One pass over the ViT embedder's residual stream for each residual add and
// the LayerNorm after it:
//
//   r  = round(x + d)
//   ln = round(LN_{gamma, beta, eps}(r))   statistics in f32 from r as stored
//
// Replaces no TPU kernel. The JAX package leaves the ViT's adds and
// LayerNorms to XLA, which fuses each into the ops around it. The port's
// forward is eager, so each was a kernel of its own: the add one pass over
// the [K x 144, 768] residual stream, the LayerNorm another (and the final
// LN a cast to f32 before it and a cast back after it). In bf16 at 1664
// faces each such pass moves 0.74-1.1 GB; one pass an add and its LN reads
// x and d once and writes r and ln once.
//
// Every row is one LayerNorm of W elements. x, d, r and ln are of one
// element type (f32 or bf16); gamma and beta [W] are of that type or f32
// (the ViT's final LN, whose statistics and affine map eager took in f32
// from the stored r and rounded once to the compute dtype). d is either
// x's shape or broadcast over x's leading axes: row i adds row i % d_rows
// of d (the pos_embed [T, W] over the batch). r is stored when its pointer
// is not null. The arithmetic is f32: r rounds once to the element type and
// the statistics are taken from r as rounded, as eager's LN reads the stored
// sum. Mean and variance are two passes over the row held in registers (a
// sum, then the sum of squares about the mean), each a lane's own sum in
// the order of its elements and then a warp's butterfly (xor 16, 8, 4, 2,
// 1); mean = sum / W, var = squares / W and rstd = 1 / sqrtf(var + eps),
// each correctly rounded (PyTorch's kernel takes an approximate rsqrtf).
// Built with -fmad=false, so ln = (r - mean) * rstd * gamma + beta rounds
// after each operation. So the plain version ``add_ln_f32`` repeats the
// arithmetic bit for bit: nothing but the final rounding to bf16 is left
// between the two (a LayerNorm output near 0 is the difference of terms of
// order 1, so another order of the sums would move it by many bf16 ulps).
//
// Bound on the H100: about 1 FLOP a byte, so HBM traffic alone: x and d
// read once, r and ln written once (d of a broadcast site stays in L2).
// Design:
// - A warp takes a row: each lane 16-byte vectors at lane, lane + 32, ...
//   of the row's W / lanes vectors, so a warp's loads and stores of one
//   vector index are 512 contiguous bytes. At W = 768 that is 3 vectors a
//   lane in bf16, 6 in f32. At most kMaxElems elements a lane are held (the
//   row in f32, gamma and beta beside it, all in registers): W up to 1024
//   in either type. A wider row is refused.
// - gamma and beta go into registers once a warp, before the row loop.
// - A grid-strided loop over the rows, with as many blocks of 8 warps as
//   the card holds at once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // rows of a block at a time
constexpr int kMaxElems = 32;          // elements a lane holds: W <= 32 x 32

// element types by the wrapper's code: 0 float32, 1 bfloat16
template <int D>
struct Elem;

template <>
struct Elem<0> {
  static constexpr int kLanes = 4;
  __device__ static void unpack(const uint4 q, float (&f)[4]) {
    f[0] = __uint_as_float(q.x);
    f[1] = __uint_as_float(q.y);
    f[2] = __uint_as_float(q.z);
    f[3] = __uint_as_float(q.w);
  }
  __device__ static uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <>
struct Elem<1> {
  static constexpr int kLanes = 8;
  // a bf16 is the high half of the f32 it widens to
  __device__ static void unpack(const uint4 q, float (&f)[8]) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ static uint32_t two(float lo, float hi) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
  }
  __device__ static uint4 pack(const float (&f)[8]) {
    return make_uint4(two(f[0], f[1]), two(f[2], f[3]), two(f[4], f[5]), two(f[6], f[7]));
  }
};

// L parameters of type G from element c * L on, widened to f32
template <int G, int L>
__device__ void load_param(const void* p, int c, float (&f)[L]) {
  if constexpr (G == 1 || L == 4) {
    // the parameter's own vector: one 16-byte load
    using E = Elem<G>;
    static_assert(E::kLanes == L, "a parameter vector of the row's type");
    E::unpack(__ldg((const uint4*)p + c), f);
  } else {
    // f32 parameters beside a bf16 row: two 16-byte loads a vector
    const float4* q = (const float4*)p + 2 * c;
    const float4 lo = __ldg(q), hi = __ldg(q + 1);
    f[0] = lo.x, f[1] = lo.y, f[2] = lo.z, f[3] = lo.w;
    f[4] = hi.x, f[5] = hi.y, f[6] = hi.z, f[7] = hi.w;
  }
}

__device__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

struct Args {
  const uint4* x;      // [rows, W]
  const uint4* d;      // [d_rows, W]
  const void* gamma;   // [W]
  const void* beta;    // [W]
  uint4* r;            // [rows, W], or null
  uint4* ln;           // [rows, W]
  long long rows;
  long long d_rows;    // divides rows
  int nvec;            // 16-byte vectors a row
  float width;         // W
  float eps;
};

template <int D, int G, int V>
__global__ void __launch_bounds__(kThreads) add_ln_kernel(const Args a) {
  using E = Elem<D>;
  constexpr int L = E::kLanes;
  const int lane = threadIdx.x & 31;
  float g[V][L], b[V][L];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = lane + 32 * j;
    if (c < a.nvec) {
      load_param<G, L>(a.gamma, c, g[j]);
      load_param<G, L>(a.beta, c, b[j]);
    }
  }

  const long long stride = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); row < a.rows;
       row += stride) {
    const uint4* xr = a.x + row * a.nvec;
    const uint4* dr = a.d + (row % a.d_rows) * a.nvec;
    uint4 xq[V], dq[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = lane + 32 * j;
      if (c < a.nvec) {
        xq[j] = xr[c];
        dq[j] = dr[c];
      }
    }
    // r, rounded to the element type and read back: the LN's input
    float v[V][L];
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = lane + 32 * j;
      if (c >= a.nvec) continue;
      float dv[L];
      E::unpack(xq[j], v[j]);
      E::unpack(dq[j], dv);
#pragma unroll
      for (int k = 0; k < L; ++k) v[j][k] = v[j][k] + dv[k];
      xq[j] = E::pack(v[j]);
      E::unpack(xq[j], v[j]);
#pragma unroll
      for (int k = 0; k < L; ++k) s += v[j][k];
    }
    const float mean = warp_sum(s) / a.width;
    float q = 0.0f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (lane + 32 * j >= a.nvec) continue;
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const float t = v[j][k] - mean;
        q += t * t;
      }
    }
    const float rstd = 1.0f / sqrtf(warp_sum(q) / a.width + a.eps);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = lane + 32 * j;
      if (c >= a.nvec) continue;
      if (a.r != nullptr) a.r[row * a.nvec + c] = xq[j];
      float o[L];
#pragma unroll
      for (int k = 0; k < L; ++k) o[k] = (v[j][k] - mean) * rstd * g[j][k] + b[j][k];
      a.ln[row * a.nvec + c] = E::pack(o);
    }
  }
}

template <int D, int G, int V>
int launch(const Args& a, cudaStream_t stream) {
  // resident blocks a SM, asked once for each instance
  static const int per_sm = [] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, add_ln_kernel<D, G, V>, kThreads, 0);
    return n > 0 ? n : 1;
  }();
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long want = (a.rows + kWarps - 1) / kWarps;
  const long long most = (long long)sms * per_sm;
  add_ln_kernel<D, G, V><<<(int)(want < most ? want : most), kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// V: vectors a lane, 1 to kMaxElems / lanes
template <int D, int G>
int dispatch(int v, const Args& a, cudaStream_t stream) {
  constexpr int kMaxV = kMaxElems / Elem<D>::kLanes;
  switch (v) {
    case 1:
      return launch<D, G, 1>(a, stream);
    case 2:
      return launch<D, G, 2>(a, stream);
    case 3:
      return launch<D, G, 3>(a, stream);
    case 4:
      return launch<D, G, 4>(a, stream);
    default:
      break;
  }
  if constexpr (kMaxV == 8) {
    switch (v) {
      case 5:
        return launch<D, G, 5>(a, stream);
      case 6:
        return launch<D, G, 6>(a, stream);
      case 7:
        return launch<D, G, 7>(a, stream);
      case 8:
        return launch<D, G, 8>(a, stream);
      default:
        break;
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: x, d, r and ln, 0 float32 or 1 bfloat16; param_dtype: gamma and
// beta, 0 float32, or 1 bfloat16 with a bf16 row. rows: x's rows of width
// W; d_rows: d's, dividing rows. r may be null. Every pointer 16-byte aligned.
extern "C" int frp_add_ln(int dtype, int param_dtype, const void* x, const void* d,
                          const void* gamma, const void* beta, void* r, void* ln,
                          long long rows, long long d_rows, int width, float eps, void* stream) {
  if (rows <= 0) return 0;
  if (dtype < 0 || dtype > 1 || param_dtype < 0 || param_dtype > dtype || d_rows <= 0 ||
      rows % d_rows != 0)
    return (int)cudaErrorInvalidValue;
  const int lanes = dtype == 0 ? Elem<0>::kLanes : Elem<1>::kLanes;
  if (width <= 0 || width % lanes != 0 || width > 32 * kMaxElems) return (int)cudaErrorInvalidValue;
  const int nvec = width / lanes;
  const Args args{(const uint4*)x, (const uint4*)d, gamma, beta, (uint4*)r, (uint4*)ln,
                  rows, d_rows, nvec, (float)width, eps};
  const int v = (nvec + 31) / 32;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<0, 0>(v, args, st);
  return param_dtype == 1 ? dispatch<1, 1>(v, args, st) : dispatch<1, 0>(v, args, st);
}
