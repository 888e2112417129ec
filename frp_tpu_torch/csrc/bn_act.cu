// One pass over a channels-last activation for each BN-activation and
// BN-add-BN chain of an inference forward: iresnet's BN-PReLU and BN-add-BN
// chains (the embed stage), and RetinaFace's BN and leaky ReLU or PReLU
// after each activated conv (the detect stage).
//
// Replaces no TPU kernel. The JAX package leaves these element-wise chains
// to XLA, which fuses each into the ops around it. The port's forward is
// eager, so each op of a chain was a kernel of its own: a BN two passes over
// the activation (x * s, + t), a PReLU or leaky ReLU three (compare,
// multiply, where), the residual add one, a stride-2 conv's padding a copy.
// In bf16 that is about 130 MB of traffic a face in iresnet50; one pass a
// chain moves about 31 MB.
//
// Modes (bits of `mode`):
//   kPrelu     y = prelu_a(x * s + t): a conv's BN and PReLU (iresnet's stem
//              and every block's bn2 after conv1; RetinaFace's activated
//              convs where the weights carry learned slopes).
//   kLeaky     y = leaky(x * s + t): y >= 0 ? y : slope * y, slope one f32
//              scalar (0.1, as nn.leaky_relu computes it): RetinaFace's
//              activated convs with the in-repo weights.
//   kAddId     r = x * s + t + sc: a block's bn3 after conv2, plus its input.
//   kAddDown   r = x * s + t + (sc * sd + td): the shortcut is the down
//              conv's output through down_bn.
//   kWriteR    store y (or r): with kPrelu and kLeaky always, with an add
//              but after the last block.
//   kNext      store u = y * s1 + t1 (or r * s1 + t1): the next block's bn1,
//              or head_bn after the last block; always with an add.
//   kPad       (with kPrelu or kLeaky) store y into [B, H + ph, W + pw, C],
//              the rows below and the columns right of it zero: the input of
//              a stride-2 conv under XLA SAME padding, which would otherwise
//              be copied by F.pad.
// Instances built (`dispatch`): iresnet's kPrelu | kWriteR [| kPad | kNext],
// kAdd* | kNext [| kWriteR]; RetinaFace's kLeaky | kWriteR [| kPad] and
// kPrelu | kWriteR [| kPad].
// Every tensor is [B, H, W, C] in memory (channels-last), of one element
// type (f32 or bf16); s, t, a, sd, td, s1 and t1 are [C] of that type:
// the folded BN scale and shift and the PReLU slope as the plain version
// casts them. The arithmetic is f32, rounded once at each store: u is taken
// from y or r before its rounding. Built with -fmad=false, so x * s + t
// rounds after the multiply and after the add, as two separate ops do.
//
// Bound on the H100: about 1 FLOP a byte, so HBM traffic alone: each input
// read once, each output written once. At iresnet50's rung of 1664 faces the
// smallest activation (7 x 7 x 512) is 83 MB, above the 50 MB L2. Design:
// - A thread moves 16 bytes a load and a store (8 bf16 lanes, 4 f32), over
//   the flat channels-last memory. C / lanes (the vectors a pixel) is a power
//   of two dividing the 256 threads of a block, and the grid's stride is a
//   multiple of 256, so every vector a thread visits starts at the same
//   channel: its scales, shifts and slopes are loaded once, into registers.
// - A grid-strided loop over as many blocks as the card holds at once, four
//   vectors a thread in flight: the loads of the four go out before the
//   first store.
// - kPad indexes the padded output and reads the input pixel under it (two
//   32-bit divisions a vector), writing zeros on the border.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // vectors of a thread in flight

enum : int {
  kPrelu = 1,
  kAddId = 2,
  kAddDown = 4,
  kWriteR = 8,
  kNext = 16,
  kPad = 32,
  kLeaky = 64
};

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

struct Args {
  const uint4* x;   // the conv's output, [B, H, W, C]
  const uint4* sc;  // the shortcut, [B, Ho, Wo, C]: the block input, or the down conv's output
  uint4* r;         // y or r, [B, Ho, Wo, C]
  uint4* u;         // the next BN of y or r, [B, Ho, Wo, C]
  const uint4* s;
  const uint4* t;
  const uint4* a;
  const uint4* sd;
  const uint4* td;
  const uint4* s1;
  const uint4* t1;
  float slope;   // the leaky slope (kLeaky)
  long long nv;  // 16-byte vectors of an output
  int cv;        // vectors a pixel, a power of two dividing kThreads
  int cv_shift;  // log2(cv)
  int h, w;      // the input's height and width (kPad)
  int ho, wo;    // the output's (kPad)
};

template <int D, int M>
__global__ void __launch_bounds__(kThreads) bn_act_kernel(const Args a) {
  using E = Elem<D>;
  constexpr int L = E::kLanes;
  constexpr bool kAdd = (M & (kAddId | kAddDown)) != 0;
  // the channel vector of every index this thread visits
  const int c = threadIdx.x & (a.cv - 1);
  float s[L], t[L], al[L], sd[L], td[L], s1[L], t1[L];
  E::unpack(__ldg(a.s + c), s);
  E::unpack(__ldg(a.t + c), t);
  if constexpr ((M & kPrelu) != 0) E::unpack(__ldg(a.a + c), al);
  if constexpr ((M & kAddDown) != 0) {
    E::unpack(__ldg(a.sd + c), sd);
    E::unpack(__ldg(a.td + c), td);
  }
  if constexpr ((M & kNext) != 0) {
    E::unpack(__ldg(a.s1 + c), s1);
    E::unpack(__ldg(a.t1 + c), t1);
  }

  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i0 = (long long)blockIdx.x * kThreads + threadIdx.x; i0 < a.nv;
       i0 += stride * kUnroll) {
    uint4 xq[kUnroll], dq[kUnroll];
    bool border[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = i0 + k * stride;
      border[k] = false;
      if (i >= a.nv) continue;
      long long src = i;
      if constexpr ((M & kPad) != 0) {
        const unsigned p = (unsigned)(i >> a.cv_shift);  // the output pixel
        const unsigned q = p / (unsigned)a.wo;
        const unsigned col = p - q * (unsigned)a.wo;
        const unsigned b = q / (unsigned)a.ho;
        const unsigned row = q - b * (unsigned)a.ho;
        border[k] = row >= (unsigned)a.h || col >= (unsigned)a.w;
        if (border[k]) continue;
        src = (((long long)b * a.h + row) * a.w + col) * a.cv + c;
      }
      xq[k] = a.x[src];
      if constexpr (kAdd) dq[k] = a.sc[i];
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = i0 + k * stride;
      if (i >= a.nv) continue;
      if constexpr ((M & kPad) != 0) {
        if (border[k]) {
          a.r[i] = make_uint4(0u, 0u, 0u, 0u);
          continue;
        }
      }
      float v[L];
      E::unpack(xq[k], v);
#pragma unroll
      for (int j = 0; j < L; ++j) v[j] = v[j] * s[j] + t[j];
      if constexpr ((M & kPrelu) != 0) {
#pragma unroll
        for (int j = 0; j < L; ++j) v[j] = v[j] >= 0.0f ? v[j] : al[j] * v[j];
      }
      if constexpr ((M & kLeaky) != 0) {
#pragma unroll
        for (int j = 0; j < L; ++j) v[j] = v[j] >= 0.0f ? v[j] : a.slope * v[j];
      }
      if constexpr (kAdd) {
        float d[L];
        E::unpack(dq[k], d);
        if constexpr ((M & kAddDown) != 0) {
#pragma unroll
          for (int j = 0; j < L; ++j) d[j] = d[j] * sd[j] + td[j];
        }
#pragma unroll
        for (int j = 0; j < L; ++j) v[j] = d[j] + v[j];
      }
      if constexpr ((M & kWriteR) != 0) a.r[i] = E::pack(v);
      if constexpr ((M & kNext) != 0) {
#pragma unroll
        for (int j = 0; j < L; ++j) v[j] = v[j] * s1[j] + t1[j];
        a.u[i] = E::pack(v);
      }
    }
  }
}

template <int D, int M>
int launch(const Args& a, cudaStream_t stream) {
  // resident blocks a SM, asked once for each instance
  static const int per_sm = [] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bn_act_kernel<D, M>, kThreads, 0);
    return n > 0 ? n : 1;
  }();
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long want = (a.nv + kThreads - 1) / kThreads;
  const long long most = (long long)sms * per_sm;
  bn_act_kernel<D, M><<<(int)(want < most ? want : most), kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch(int mode, const Args& a, cudaStream_t stream) {
  switch (mode) {
#define FRP_BN_ACT_MODE(m) \
  case (m):                \
    return launch<D, (m)>(a, stream);
    FRP_BN_ACT_MODE(kPrelu | kWriteR)
    FRP_BN_ACT_MODE(kPrelu | kWriteR | kPad)
    FRP_BN_ACT_MODE(kPrelu | kWriteR | kNext)
    FRP_BN_ACT_MODE(kAddId | kNext)
    FRP_BN_ACT_MODE(kAddId | kWriteR | kNext)
    FRP_BN_ACT_MODE(kAddDown | kNext)
    FRP_BN_ACT_MODE(kAddDown | kWriteR | kNext)
    FRP_BN_ACT_MODE(kLeaky | kWriteR)
    FRP_BN_ACT_MODE(kLeaky | kWriteR | kPad)
#undef FRP_BN_ACT_MODE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. nv: 16-byte vectors of an output;
// cv: vectors a pixel; h, w: the input's spatial size and ho, wo the output's
// (equal unless kPad); slope: the leaky slope (read by kLeaky alone).
// Pointers a mode does not read or write may be null.
extern "C" int frp_bn_act(int dtype, int mode, const void* x, const void* sc, void* r, void* u,
                          const void* s, const void* t, const void* a, const void* sd,
                          const void* td, const void* s1, const void* t1, long long nv, int cv,
                          int h, int w, int ho, int wo, float slope, void* stream) {
  if (nv <= 0) return 0;
  if (cv <= 0 || (cv & (cv - 1)) != 0 || kThreads % cv != 0) return (int)cudaErrorInvalidValue;
  int shift = 0;
  while ((1 << shift) < cv) ++shift;
  const Args args{(const uint4*)x, (const uint4*)sc, (uint4*)r, (uint4*)u,
                  (const uint4*)s, (const uint4*)t, (const uint4*)a, (const uint4*)sd,
                  (const uint4*)td, (const uint4*)s1, (const uint4*)t1, slope, nv, cv,
                  shift, h, w, ho, wo};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return dispatch<0>(mode, args, st);
    case 1:
      return dispatch<1>(mode, args, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
