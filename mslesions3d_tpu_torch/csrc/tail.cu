// One depthwise-separable block of the fused MobileNet tail for Hopper (sm_90a):
// kernel K3 of the port, launched once per block of the chain.
//
// Replaces mslesions3d_tpu/kernels/tail.py::fused_tail (body _tail_kernel,
// _dw_block). Same function and the same rounding points, for input x
// (B, D, H, W, C_in) in memory and output (B, Do, Ho, Wo, C_out):
//   acc = sum_{kd,kh,kw} x[s*o + k - 1] * dw_w[k]       float32, (kd,kh,kw) order, zero pad
//   y   = round_to_w(relu(acc * dw_gamma + dw_beta))      the weights' dtype
//   z   = sum_c y[c] * pw_w[c, :]                          float32, c ascending
//   out = relu(z * pw_gamma + pw_beta)                     float32 for the next block;
//                                                         rounded to x's dtype if emitted
// Stride 2 is a plain stride-2 convolution: output o samples input 2o-1..2o+1.
// (The TPU kernel computes every stride-1 tap and keeps the even positions;
// that is a workaround for its compiler, not the function.)
//
// What bounds it on this card: bytes and launch latency. At the 96^3
// headline the whole chain moves a few MB at batch 8 and its pointwise
// products are ~0.5 GFLOP, so each launch is short.
//
// Design. The TPU kernel holds four samples and the whole chain in VMEM;
// one 12^3 x 128 bf16 sample (442 KB) does not fit a block's 227 KB of
// shared memory, so the chain is one launch per block and the float32
// activations between blocks go through device memory (they stay in L2).
// A CUDA block of 256 threads owns 8 output voxels x 128 output channels:
//   1. it computes the depthwise result of its 8 voxels for every input
//      channel (neighbouring threads on neighbouring channels: coalesced
//      loads) into shared memory, rounded to the weights' dtype;
//   2. thread (row, col) multiplies the 4 voxels of its row by column col of
//      pw_w (read coalesced along C_out), summing in float32 in registers;
//   3. it applies the folded BN and ReLU and writes its 4 outputs.
// The depthwise tile is recomputed by each of the C_out / 128 blocks that
// share its voxels; at these sizes that costs less than a second pass
// through device memory. ReLU keeps NaN, as torch.relu does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTileVoxels = 8;
constexpr int kTileChannels = 128;
constexpr int kThreads = 256;
constexpr int kRows = kThreads / kTileChannels;         // 2
constexpr int kVoxelsPerThread = kTileVoxels / kRows;  // 4
constexpr int kMaxSmem = 48 * 1024;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// torch.relu: negative to 0, NaN stays NaN
__device__ __forceinline__ float relu(float y) { return (y > 0.f || y != y) ? y : 0.f; }

// TIn: the block's input (x's dtype for the first block, float32 after);
// TW: x's dtype, which is the weights' and the emitted maps' dtype.
template <typename TIn, typename TW>
__global__ void __launch_bounds__(kThreads)
tail_block_kernel(const TIn* __restrict__ x, const TW* __restrict__ dw_w,
                  const float* __restrict__ dw_gamma, const float* __restrict__ dw_beta,
                  const TW* __restrict__ pw_w, const float* __restrict__ pw_gamma,
                  const float* __restrict__ pw_beta, float* __restrict__ out_f32,
                  TW* __restrict__ out_emit, int D, int H, int W, int Do, int Ho, int Wo,
                  int cin, int cout, int stride, int nout) {
  extern __shared__ float ys[];  // [kTileVoxels][cin]
  const int v0 = blockIdx.x * kTileVoxels;

  // 1. depthwise + BN + ReLU of the tile's voxels, every input channel
  for (int idx = threadIdx.x; idx < kTileVoxels * cin; idx += kThreads) {
    const int j = idx / cin, c = idx - j * cin;
    const int v = v0 + j;
    float y = 0.f;
    if (v < nout) {
      int r = v;
      const int ow = r % Wo;
      r /= Wo;
      const int oh = r % Ho;
      r /= Ho;
      const int od = r % Do;
      const int b = r / Do;
      float acc = 0.f;
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
        const int id = od * stride + kd - 1;
        const bool okd = id >= 0 && id < D;
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          const int ih = oh * stride + kh - 1;
          const bool okh = okd && ih >= 0 && ih < H;
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            const int iw = ow * stride + kw - 1;
            float xin = 0.f;
            if (okh && iw >= 0 && iw < W) {
              const size_t voxel = ((static_cast<size_t>(b) * D + id) * H + ih) * W + iw;
              xin = to_float(x[voxel * cin + c]);
            }
            const float wk = to_float(dw_w[((kd * 3 + kh) * 3 + kw) * cin + c]);
            acc = __fadd_rn(acc, __fmul_rn(xin, wk));
          }
        }
      }
      y = to_float(from_float<TW>(relu(__fadd_rn(__fmul_rn(acc, dw_gamma[c]), dw_beta[c]))));
    }
    ys[j * cin + c] = y;
  }
  __syncthreads();

  // 2. pointwise product for 4 voxels x 1 output channel per thread
  const int col = threadIdx.x % kTileChannels, row = threadIdx.x / kTileChannels;
  const int co = blockIdx.y * kTileChannels + col;
  if (co >= cout) return;
  float acc[kVoxelsPerThread];
#pragma unroll
  for (int k = 0; k < kVoxelsPerThread; ++k) acc[k] = 0.f;
  for (int c = 0; c < cin; ++c) {
    const float wv = to_float(pw_w[static_cast<size_t>(c) * cout + co]);
#pragma unroll
    for (int k = 0; k < kVoxelsPerThread; ++k) {
      acc[k] = __fadd_rn(acc[k], __fmul_rn(ys[(row + k * kRows) * cin + c], wv));
    }
  }

  // 3. BN + ReLU, then the float32 activation and/or the emitted map
  const float g = pw_gamma[co], bb = pw_beta[co];
#pragma unroll
  for (int k = 0; k < kVoxelsPerThread; ++k) {
    const int v = v0 + row + k * kRows;
    if (v >= nout) break;
    const float z = relu(__fadd_rn(__fmul_rn(acc[k], g), bb));
    const size_t o = static_cast<size_t>(v) * cout + co;
    if (out_f32) out_f32[o] = z;
    if (out_emit) out_emit[o] = from_float<TW>(z);
  }
}

template <typename TIn, typename TW>
int launch(const void* x, const void* dw_w, const void* dw_g, const void* dw_b,
           const void* pw_w, const void* pw_g, const void* pw_b, void* out_f32,
           void* out_emit, int b, int d, int h, int w, int cin, int cout, int stride,
           cudaStream_t s) {
  const int dout = (d - 1) / stride + 1, hout = (h - 1) / stride + 1,
            wout = (w - 1) / stride + 1;
  const int nout = b * dout * hout * wout;
  const dim3 grid((nout + kTileVoxels - 1) / kTileVoxels,
                  (cout + kTileChannels - 1) / kTileChannels);
  const size_t smem = static_cast<size_t>(kTileVoxels) * cin * sizeof(float);
  tail_block_kernel<TIn, TW><<<grid, kThreads, smem, s>>>(
      static_cast<const TIn*>(x), static_cast<const TW*>(dw_w),
      static_cast<const float*>(dw_g), static_cast<const float*>(dw_b),
      static_cast<const TW*>(pw_w), static_cast<const float*>(pw_g),
      static_cast<const float*>(pw_b), static_cast<float*>(out_f32),
      static_cast<TW*>(out_emit), d, h, w, dout, hout, wout, cin, cout, stride, nout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One block of the chain. x (b, d, h, w, cin) in memory, float32 if in_f32
// else in `dtype` (0 float32, 1 bfloat16); dw_w (3, 3, 3, cin) and pw_w
// (cin, cout) in `dtype`; the four BN vectors float32. Writes the float32
// activation to out_f32 and the map in `dtype` to out_emit, either of which
// may be null. Launches on `stream` and does not synchronise. Returns a
// cudaError_t.
int msl_tail_block(const void* x, const void* dw_w, const void* dw_g, const void* dw_b,
                   const void* pw_w, const void* pw_g, const void* pw_b, void* out_f32,
                   void* out_emit, int in_f32, int dtype, int b, int d, int h, int w, int cin,
                   int cout, int stride, void* stream) {
  if (b <= 0 || d <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 ||
      (stride != 1 && stride != 2) ||
      static_cast<size_t>(kTileVoxels) * cin * sizeof(float) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float, float>(x, dw_w, dw_g, dw_b, pw_w, pw_g, pw_b, out_f32, out_emit, b,
                                d, h, w, cin, cout, stride, s);
  }
  if (dtype == 1 && in_f32) {
    return launch<float, __nv_bfloat16>(x, dw_w, dw_g, dw_b, pw_w, pw_g, pw_b, out_f32,
                                        out_emit, b, d, h, w, cin, cout, stride, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, __nv_bfloat16>(x, dw_w, dw_g, dw_b, pw_w, pw_g, pw_b,
                                                 out_f32, out_emit, b, d, h, w, cin, cout,
                                                 stride, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* msl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
