// int8 3D convolution with int32 accumulation and a fused float32 epilogue
// for Hopper (sm_90a): kernel Q1 of the port.
//
// Q1 is not a TPU kernel. It replaces the int8 convs of
// mslesions3d_tpu/quant.py::_qconv (:212-220), which XLA runs as
// conv_general_dilated on int8 operands with preferred_element_type=int32;
// torch on CUDA has no int8 conv3d. Same function: for q (B, D, H, W, Cin)
// int8 and weights (k, k, k, Cin / groups, Cout) int8, zero padding k / 2,
//   out[n, o, oc] = relu?(float(acc) * scale[oc] + bias[oc]),
//   acc = sum over the taps and the group's input channels of q * w (int32),
// out (B, Do, Ho, Wo, Cout) float32. The integer sum is exact in any order
// (the wrapper asserts from the shapes that it stays below 2^31), and the
// epilogue rounds twice with round-to-nearest intrinsics (the build also
// passes -fmad=false), as the plain version's `acc.float() * scale + bias`
// does, so the two agree bit for bit.
//
// What bounds it on this card: at the model's sizes, bytes and the latency
// of a wave; the int8 operations (2 per multiply-add) are far below the
// tensor cores' int8 rate. This first version runs them on the CUDA cores:
//  - dense (groups 1: the stem, the pointwise convs, the heads): one thread
//    per output element, output channel fastest, so the threads of a warp
//    share the input voxel (one broadcast read per channel quad) and store
//    contiguously. The wrapper repacks the weights to (Cout, k, k, k, Cin),
//    so a thread's channel quad is one aligned 4-byte word, summed with
//    __dp4a (4 multiply-adds an instruction). Where Cin is not a multiple
//    of 4 (the stem, Cin = 1) or a pointer is not 4-byte aligned, a scalar
//    loop takes every channel;
//  - depthwise (groups = Cin = Cout, stride 1 or 2): one thread per output
//    element, channel fastest (coalesced reads and stores), a scalar
//    multiply-add per tap: each output has one input channel per tap, so
//    there is no quad to pack.
// Tensor-core int8 products (IMMA / wgmma) are the next step.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct Geometry {
  int b, d, h, w, cin;      // input
  int od, oh, ow, cout;     // output
  int k, sd, sh, sw, pad;   // kernel side, strides, padding
};

// out[idx] = relu?(float(acc) * scale + bias), or the int32 sum itself when `raw`.
__device__ __forceinline__ void store(void* out, long long idx, int acc, float scale, float bias,
                                      bool relu, bool raw) {
  if (raw) {
    static_cast<int*>(out)[idx] = acc;
    return;
  }
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
  static_cast<float*>(out)[idx] = relu ? (y > 0.0f ? y : 0.0f) : y;
}

// Output element `idx` (n, od, oh, ow, c) of (B, Do, Ho, Wo, C), C fastest.
__device__ __forceinline__ void unravel(long long idx, int c_dim, const Geometry& g, int& n,
                                       int& z, int& y, int& x, int& c) {
  c = static_cast<int>(idx % c_dim);
  long long v = idx / c_dim;
  x = static_cast<int>(v % g.ow);
  v /= g.ow;
  y = static_cast<int>(v % g.oh);
  v /= g.oh;
  z = static_cast<int>(v % g.od);
  n = static_cast<int>(v / g.od);
}

// w: (Cout, k, k, k, Cin). QUAD: Cin % 4 == 0 and both pointers 4-byte aligned.
template <bool QUAD>
__global__ void __launch_bounds__(kThreads)
qconv_dense_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   void* __restrict__ out, Geometry g, long long total, bool relu, bool raw) {
  long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  int n, oz, oy, ox, oc;
  unravel(idx, g.cout, g, n, oz, oy, ox, oc);
  int acc = 0;
  for (int kd = 0; kd < g.k; ++kd) {
    int iz = oz * g.sd - g.pad + kd;
    if (iz < 0 || iz >= g.d) continue;
    for (int kh = 0; kh < g.k; ++kh) {
      int iy = oy * g.sh - g.pad + kh;
      if (iy < 0 || iy >= g.h) continue;
      for (int kw = 0; kw < g.k; ++kw) {
        int ix = ox * g.sw - g.pad + kw;
        if (ix < 0 || ix >= g.w) continue;
        const int8_t* xp = q + (((static_cast<long long>(n) * g.d + iz) * g.h + iy) * g.w + ix) *
                                   g.cin;
        const int8_t* wp = w + (((static_cast<long long>(oc) * g.k + kd) * g.k + kh) * g.k + kw) *
                                   g.cin;
        if (QUAD) {
          const int* xq = reinterpret_cast<const int*>(xp);
          const int* wq = reinterpret_cast<const int*>(wp);
          for (int c = 0; c < g.cin / 4; ++c) acc = __dp4a(xq[c], wq[c], acc);
        } else {
          for (int c = 0; c < g.cin; ++c) acc += static_cast<int>(xp[c]) * static_cast<int>(wp[c]);
        }
      }
    }
  }
  store(out, idx, acc, raw ? 0.0f : scale[oc], raw ? 0.0f : bias[oc], relu, raw);
}

// w: (k, k, k, C): the DHWIO weights of a depthwise conv (I = 1), as they are.
__global__ void __launch_bounds__(kThreads)
qconv_depthwise_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ w,
                       const float* __restrict__ scale, const float* __restrict__ bias,
                       void* __restrict__ out, Geometry g, long long total, bool relu,
                       bool raw) {
  long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  int n, oz, oy, ox, c;
  unravel(idx, g.cout, g, n, oz, oy, ox, c);
  int acc = 0;
  for (int kd = 0; kd < g.k; ++kd) {
    int iz = oz * g.sd - g.pad + kd;
    if (iz < 0 || iz >= g.d) continue;
    for (int kh = 0; kh < g.k; ++kh) {
      int iy = oy * g.sh - g.pad + kh;
      if (iy < 0 || iy >= g.h) continue;
      for (int kw = 0; kw < g.k; ++kw) {
        int ix = ox * g.sw - g.pad + kw;
        if (ix < 0 || ix >= g.w) continue;
        long long xi = (((static_cast<long long>(n) * g.d + iz) * g.h + iy) * g.w + ix) * g.cin + c;
        acc += static_cast<int>(q[xi]) * static_cast<int>(w[((kd * g.k + kh) * g.k + kw) * g.cin + c]);
      }
    }
  }
  store(out, idx, acc, raw ? 0.0f : scale[c], raw ? 0.0f : bias[c], relu, raw);
}

}  // namespace

extern "C" {

// q (b, d, h, w, cin) int8; w int8, (cout, k, k, k, cin) when `depthwise`
// is 0 and (k, k, k, cin) with cout == cin when it is 1; scale, bias (cout,)
// float32; out (b, od, oh, ow, cout) float32, or the int32 sums when `raw`
// is 1 (scale and bias unread); padding k / 2. `quad` 1 sums channel quads
// with __dp4a (cin % 4 == 0, q and w 4-byte aligned; dense only). Launches on
// `stream` and does not synchronise. Returns a cudaError_t.
int msl_qconv(const void* q, const void* w, const void* scale, const void* bias, void* out,
              int b, int d, int h, int wd, int cin, int od, int oh, int ow, int cout, int k,
              int sd, int sh, int sw, int depthwise, int quad, int relu, int raw,
              void* stream) {
  if (b <= 0 || d <= 0 || h <= 0 || wd <= 0 || cin <= 0 || od <= 0 || oh <= 0 || ow <= 0 ||
      cout <= 0 || (k != 1 && k != 3) || (depthwise && (cout != cin || quad)) ||
      (quad && cin % 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geometry g{b, d, h, wd, cin, od, oh, ow, cout, k, sd, sh, sw, k / 2};
  long long total = static_cast<long long>(b) * od * oh * ow * cout;
  unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  bool rl = relu != 0, rw = raw != 0;
  if (depthwise) {
    qconv_depthwise_kernel<<<blocks, kThreads, 0, s>>>(qp, wp, sp, bp, out, g, total, rl, rw);
  } else if (quad) {
    qconv_dense_kernel<true><<<blocks, kThreads, 0, s>>>(qp, wp, sp, bp, out, g, total, rl, rw);
  } else {
    qconv_dense_kernel<false><<<blocks, kThreads, 0, s>>>(qp, wp, sp, bp, out, g, total, rl, rw);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* msl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
