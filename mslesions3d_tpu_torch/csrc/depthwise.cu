// Fused depthwise 3x3x3 conv + folded BN + ReLU for Hopper (sm_90a): kernel K2 of the port.
//
// Replaces mslesions3d_tpu/kernels/depthwise.py::fused_depthwise_bn_relu
// (body _dw_kernel). Same function: for x (B, D, H, W, C) in memory (the
// model's channels_last_3d views), stride 1 and zero padding 1,
//   out = round(relu(acc * gamma + beta)),
//   acc = sum_{kd,kh,kw} x[d+kd-1, h+kh-1, w+kw-1] * w[kd,kh,kw]
// with the 27 taps summed in float32 in (kd, kh, kw) order from 0, the BN
// affine and ReLU in float32, and one rounding to x's dtype (nearest even).
//
// What bounds it on this card: bytes. Each element is read once and written
// once (in the ideal); the 27 taps are ~57 float32 operations per element,
// far below the ~20 operations per byte where float32 arithmetic would bound.
//
// Design. The TPU kernel takes one depth row per grid step with its two
// neighbour rows as three VMEM views. Here one thread owns one pair of
// channels: it keeps its 27 weight pairs and its gamma/beta pair in
// registers and walks a strip of voxels. Neighbouring threads own
// neighbouring pairs, so each tap is one coalesced 4-byte (bf16) or 8-byte
// (float32) load; the 27-fold reuse of an input element between voxels is
// left to L1 and L2. A tap outside the volume reads 0 and still adds
// 0 * w, as the plain version's zero padding does, so the two agree bit for
// bit (the build passes -fmad=false, and the sums use round-to-nearest
// intrinsics). ReLU keeps NaN, as torch.relu does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kVoxelsPerThread = 4;  // voxel strip a thread walks, on average

template <typename T>
struct Pair;

template <>
struct Pair<float> {
  using V = float2;
  static __device__ __forceinline__ float2 load(const float2* p) { return __ldg(p); }
  static __device__ __forceinline__ float2 store(float2 v) { return v; }
};

template <>
struct Pair<__nv_bfloat16> {
  using V = __nv_bfloat162;
  static __device__ __forceinline__ float2 load(const __nv_bfloat162* p) {
    return __bfloat1622float2(*p);
  }
  static __device__ __forceinline__ __nv_bfloat162 store(float2 v) {
    return __floats2bfloat162_rn(v.x, v.y);
  }
};

// torch.relu: negative to 0, NaN stays NaN
__device__ __forceinline__ float relu(float y) { return (y > 0.f || y != y) ? y : 0.f; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
dw_bn_relu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ gamma, const float* __restrict__ beta,
                  T* __restrict__ out, int nvox, int D, int H, int W, int P) {
  using V = typename Pair<T>::V;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;  // channel pair
  if (p >= P) return;
  const V* xv = reinterpret_cast<const V*>(x);
  const V* wv = reinterpret_cast<const V*>(w);
  V* ov = reinterpret_cast<V*>(out);

  float2 wt[27];
#pragma unroll
  for (int t = 0; t < 27; ++t) wt[t] = Pair<T>::load(wv + static_cast<size_t>(t) * P + p);
  const float2 g = reinterpret_cast<const float2*>(gamma)[p];
  const float2 b = reinterpret_cast<const float2*>(beta)[p];

  for (int v = blockIdx.y * blockDim.y + threadIdx.y; v < nvox; v += gridDim.y * blockDim.y) {
    int r = v;
    const int wi = r % W;
    r /= W;
    const int hi = r % H;
    r /= H;
    const int di = r % D;
    const int bi = r / D;
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int kd = 0; kd < 3; ++kd) {
      const int dd = di + kd - 1;
      const bool okd = dd >= 0 && dd < D;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        const int hh = hi + kh - 1;
        const bool okh = okd && hh >= 0 && hh < H;
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const int ww = wi + kw - 1;
          float2 xin = make_float2(0.f, 0.f);
          if (okh && ww >= 0 && ww < W) {
            const size_t voxel = ((static_cast<size_t>(bi) * D + dd) * H + hh) * W + ww;
            xin = Pair<T>::load(xv + voxel * P + p);
          }
          const float2 wk = wt[(kd * 3 + kh) * 3 + kw];
          acc.x = __fadd_rn(acc.x, __fmul_rn(xin.x, wk.x));
          acc.y = __fadd_rn(acc.y, __fmul_rn(xin.y, wk.y));
        }
      }
    }
    float2 y;
    y.x = relu(__fadd_rn(__fmul_rn(acc.x, g.x), b.x));
    y.y = relu(__fadd_rn(__fmul_rn(acc.y, g.y), b.y));
    ov[static_cast<size_t>(v) * P + p] = Pair<T>::store(y);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* gamma, const void* beta, void* out,
           int b, int d, int h, int wd, int c, cudaStream_t s) {
  const int P = c / 2;
  const int nvox = b * d * h * wd;
  const int bx = P < 64 ? P : 64;
  const int by = kThreads / bx;
  const int gx = (P + bx - 1) / bx;
  int gy = (nvox + by * kVoxelsPerThread - 1) / (by * kVoxelsPerThread);
  if (gy > 65535) gy = 65535;
  dw_bn_relu_kernel<T><<<dim3(gx, gy), dim3(bx, by), 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(out), nvox, d, h, wd, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x and out (b, d, h, w, c) in memory, weights (3, 3, 3, c), all of one
// dtype (0 float32, 1 bfloat16); gamma, beta (c,) float32; c even; every
// pointer aligned to a channel pair. Launches on `stream` and does not
// synchronise. Returns a cudaError_t.
int msl_depthwise_bn_relu(const void* x, const void* w, const void* gamma, const void* beta,
                          void* out, int dtype, int b, int d, int h, int wd, int c,
                          void* stream) {
  if (b <= 0 || d <= 0 || h <= 0 || wd <= 0 || c <= 0 || c % 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, gamma, beta, out, b, d, h, wd, c, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, gamma, beta, out, b, d, h, wd, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* msl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
