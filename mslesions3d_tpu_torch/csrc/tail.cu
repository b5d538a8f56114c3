// The fused MobileNet tail for Hopper (sm_90a): kernel K3 of the port.
//
// Replaces mslesions3d_tpu/kernels/tail.py::fused_tail (body _tail_kernel,
// _dw_block). Same function and the same rounding points, for input x
// (B, D, H, W, C_in) in memory and each block's output (B, Do, Ho, Wo, C_out):
//   acc = sum_{kd,kh,kw} x[s*o + k - 1] * dw_w[k]       float32, (kd,kh,kw) order, zero pad
//   y   = round_to_w(relu(acc * dw_gamma + dw_beta))      the weights' dtype
//   z   = sum_c y[c] * pw_w[c, :]                          float32 sums
//   out = relu(z * pw_gamma + pw_beta)                     float32 for the next block;
//                                                         rounded to x's dtype if emitted
// Stride 2 is a plain stride-2 convolution: output o samples input 2o-1..2o+1.
// (The TPU kernel computes every stride-1 tap and keeps the even positions;
// that is a workaround for its compiler, not the function.) ReLU keeps NaN,
// as torch.relu does.
//
// What bounds it on this card: latency, not bytes or operations. At the
// 96^3 headline (x (B, 12^3, 128) bf16, layers 4-7) the chain moves ~0.5 MB
// a sample and its pointwise products are ~64 MFLOP a sample: microseconds
// for the memory and the tensor cores. What costs is the chain of dependent
// steps (four blocks, each a depthwise then a product over all channels),
// the depthwise taps on CUDA cores (float32, no FMA, for exactness), and
// moving each block's depthwise output to every CTA that multiplies it.
//
// Three kernels, chosen by the wrapper from the shapes (kernels/tail.py,
// plan_tail):
//
// 1. tail_cluster_kernel (bf16, whenever a sample's chain fits a cluster's
//    shared memory, as at the headline): ONE launch for the whole chain.
//    One cluster of 8 CTAs per sample; CTA r owns channel slice r of every
//    block's activation, for every voxel of the sample, in shared memory, as
//    the TPU kernel keeps a sample in VMEM. Per block:
//      a. depthwise + BN + ReLU of the CTA's slice, rounded to bf16 into a
//         slice buffer. The input slice (x for the first block, staged from
//         memory; later the float32 activation the CTA wrote) sits in a
//         zero halo, so no tap needs a bounds check; each thread keeps one
//         channel's 27 weights in registers; no integer division per tap;
//      b. cluster.sync(); each CTA copies every CTA's bf16 slice through
//         distributed shared memory into A (voxels x C_in, K padded with
//         zeros to 16), all 8 neighbours in flight and each CTA starting at
//         its own, and its own C_out slice of pw_w into B;
//      c. the product on the tensor cores (mma.sync m16n8k16 bf16, float32
//         accumulators, 16 x 16 per warp so two mma share each A fragment);
//         BN + ReLU; the float32 result is the CTA's slice of the next
//         block's input, and an emitted map goes to memory in bf16.
//    Only x and the weights are read from memory and only the emitted maps
//    are written; each depthwise output is computed once. The slice buffers
//    alternate, so one cluster.sync per block orders every read of a
//    neighbour's buffer before its next write. The copy in (b) is the price
//    of channel slices: each CTA pulls all of A, 8 times what the cluster
//    holds.
// 2. tail_block_mma_kernel (bf16, when the chain does not fit a cluster):
//    one launch per block. A CTA computes the depthwise of 32 output voxels
//    for every input channel into shared memory (once), then walks C_out in
//    chunks of 32 with the same tensor-core product, B staged per chunk.
//    Activations between blocks go through memory in float32.
// 3. tail_block_kernel (float32): one launch per block, the product in
//    float32 on CUDA cores (TF32 would change the function). A CTA owns 8
//    output voxels x 128 output channels.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kSmemMax = 232448;  // a Hopper block's opt-in maximum

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// torch.relu: negative to 0, NaN stays NaN
__device__ __forceinline__ float relu(float y) { return (y > 0.f || y != y) ? y : 0.f; }

__host__ __device__ __forceinline__ int round_up(int n, int m) { return (n + m - 1) / m * m; }

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The ordered 27-tap sum of one output voxel (od, oh, ow) and channel c of
// an input laid out [voxel][ld], with the channel's 27 weights w; zero taps
// outside, added as 0 * w.
template <typename T>
__device__ __forceinline__ float dw_taps(const T* in, size_t ld, const float (&w)[27], int c,
                                         int od, int oh, int ow, int d, int h, int wd,
                                         int stride) {
  float acc = 0.f;
#pragma unroll
  for (int kd = 0; kd < 3; ++kd) {
    const int id = od * stride + kd - 1;
    const bool okd = id >= 0 && id < d;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const int ih = oh * stride + kh - 1;
      const bool okh = okd && ih >= 0 && ih < h;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int iw = ow * stride + kw - 1;
        float xin = 0.f;
        if (okh && iw >= 0 && iw < wd) {
          xin = to_float(in[((static_cast<size_t>(id) * h + ih) * wd + iw) * ld + c]);
        }
        acc = __fadd_rn(acc, __fmul_rn(xin, w[(kd * 3 + kh) * 3 + kw]));
      }
    }
  }
  return acc;
}

// Channel c's 27 depthwise weights of dw_w (3, 3, 3, ld), as float32.
template <typename W>
__device__ __forceinline__ void load_taps(float (&w)[27], const W* dw_w, int ld, int c) {
#pragma unroll
  for (int tap = 0; tap < 27; ++tap) w[tap] = to_float(dw_w[tap * ld + c]);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One 16 x 16 tile of C = A B, as two 16 x 8 mma tiles that share each A
// fragment. A (rows x kpad) row-major with leading dimension lda, B (kpad x
// cols) row-major with ldb, both bf16 in shared memory; kpad a multiple of
// 16, lda and ldb multiples of 8. d[h] holds C[m0 + g][n0 + 8h + 2t .. +1]
// and C[m0 + g + 8][n0 + 8h + 2t .. +1], g = lane / 4, t = lane % 4 (the
// mma accumulator layout).
struct Frags {
  unsigned a[4], b[4];
};

__device__ __forceinline__ void load_frags(Frags& f, unsigned pa, unsigned pb) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(f.a[0]), "=r"(f.a[1]), "=r"(f.a[2]), "=r"(f.a[3])
               : "r"(pa));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(f.b[0]), "=r"(f.b[1]), "=r"(f.b[2]), "=r"(f.b[3])
               : "r"(pb));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tile(float (&d)[2][4], const bf16* a, int lda, const bf16* b,
                                         int ldb, int m0, int n0, int kpad, int lane) {
#pragma unroll
  for (int e = 0; e < 4; ++e) d[0][e] = d[1][e] = 0.f;
  // lanes 0-15 address rows 0-15 of the first 8 columns, lanes 16-31 of the next 8
  const unsigned pa = smem_u32(a + (m0 + (lane & 15)) * lda + (lane >> 4) * 8);
  const unsigned pb = smem_u32(b + (lane & 15) * ldb + n0 + (lane >> 4) * 8);
  for (int k0 = 0; k0 < kpad; k0 += 16) {
    Frags f;
    load_frags(f, pa + k0 * 2, pb + k0 * ldb * 2);
    mma_bf16(d[0], f.a, f.b[0], f.b[1]);
    mma_bf16(d[1], f.a, f.b[2], f.b[3]);
  }
}

// The (row, column) within a 16 x 16 tile of accumulator e of half h.
__device__ __forceinline__ int acc_row(int lane, int e) { return (lane >> 2) + (e >> 1) * 8; }
__device__ __forceinline__ int acc_col(int lane, int h, int e) {
  return 8 * h + 2 * (lane & 3) + (e & 1);
}

// B[k][n] = pw_w[k][n_lo + n] for k < cin and n < width, else 0; kpad x npad.
__device__ __forceinline__ void stage_b(bf16* b, int ldb, const bf16* __restrict__ pw_w,
                                        int cin, int cout, int n_lo, int width, int kpad,
                                        int npad) {
  if (cout % 8 == 0 && n_lo % 8 == 0 && width % 8 == 0 && aligned16(pw_w)) {
    const int chunks = npad / 8;
    for (int idx = threadIdx.x; idx < kpad * chunks; idx += blockDim.x) {
      const int k = idx / chunks, n = (idx - k * chunks) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k < cin && n < width) {
        v = *reinterpret_cast<const uint4*>(pw_w + static_cast<size_t>(k) * cout + n_lo + n);
      }
      *reinterpret_cast<uint4*>(b + k * ldb + n) = v;
    }
  } else {
    for (int idx = threadIdx.x; idx < kpad * npad; idx += blockDim.x) {
      const int k = idx / npad, n = idx - k * npad;
      b[k * ldb + n] = (k < cin && n < width)
                           ? pw_w[static_cast<size_t>(k) * cout + n_lo + n]
                           : __float2bfloat16_rn(0.f);
    }
  }
}

// ---------------------------------------------------------------- 1. cluster

constexpr int kCluster = 8;
constexpr int kClusterThreads = 512;
constexpr int kMaxLayers = 16;

struct ChainLayer {
  const bf16* dw_w;
  const float* dw_g;
  const float* dw_b;
  const bf16* pw_w;
  const float* pw_g;
  const float* pw_b;
  bf16* emit;  // the emitted map (B, Do, Ho, Wo, C_out), or null
  int cin, cout, stride, din, hin, win, dout, hout, wout;
  int s_in, s_out;  // channel slice widths: ceil(C / kCluster)
};

// Byte offsets in dynamic shared memory (kernels/tail.py, plan_tail):
// act the float32 slice [d + 2][h + 2][w + 2][s] of the running activation,
// with a zero halo; y0/y1 the alternating bf16 depthwise slices
// [voxel][s_in]; work the first block's x slice [d + 2][h + 2][w + 2][s_in]
// with a zero halo, then each block's A [mpad][kpad + 8] and B
// [kpad][npad + 8] (mpad, kpad, npad rounded up to 16).
struct Chain {
  ChainLayer layer[kMaxLayers];
  int n_layers;
  int act, y0, y1, work;
};

// Depthwise + BN + ReLU of this CTA's channels [lo, lo + wd) from `in`
// into y ([voxel][s], bf16). `in` is [din + 2][hin + 2][win + 2][s] in shared
// memory with a zero halo, so every tap is a plain load (a padded tap adds
// 0 * w, as the plain version does). Thread t keeps channel t % wd with its
// 27 weights in registers and walks every (blockDim / wd)-th voxel; wd <= 192
// (C_in <= MAX_C_IN), so every channel has a thread.
template <typename T>
__device__ __forceinline__ void depthwise_slice(const T* in, bf16* y, int s, int lo, int wd,
                                                const ChainLayer& L) {
  if (wd == 0) return;
  const int step = blockDim.x / wd;
  if (static_cast<int>(threadIdx.x) >= step * wd) return;
  const int c = threadIdx.x % wd;
  float w[27];
  load_taps(w, L.dw_w, L.cin, lo + c);
  const float g = L.dw_g[lo + c], bt = L.dw_b[lo + c];
  const int wp = L.win + 2, sh = wp * s, sd = (L.hin + 2) * sh, st = L.stride;
  const int nout = L.dout * L.hout * L.wout;
  // voxel v = (od, oh, ow) advances by `step` with carries, not divisions
  const int v0 = threadIdx.x / wd;
  int ow = v0 % L.wout, oh = (v0 / L.wout) % L.hout, od = v0 / (L.wout * L.hout);
  const int sw_ = step % L.wout, sh_ = (step / L.wout) % L.hout, sd_ = step / (L.wout * L.hout);
  for (int v = v0; v < nout; v += step) {
    const T* p = in + od * st * sd + oh * st * sh + ow * st * s + c;  // tap (0, 0, 0)
    float acc = 0.f;
#pragma unroll
    for (int kd = 0; kd < 3; ++kd) {
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          acc = __fadd_rn(acc, __fmul_rn(to_float(p[kd * sd + kh * sh + kw * s]),
                                         w[(kd * 3 + kh) * 3 + kw]));
        }
      }
    }
    y[v * s + c] = __float2bfloat16_rn(relu(__fadd_rn(__fmul_rn(acc, g), bt)));
    ow += sw_;
    if (ow >= L.wout) {
      ow -= L.wout;
      ++oh;
    }
    oh += sh_;
    if (oh >= L.hout) {
      oh -= L.hout;
      ++od;
    }
    od += sd_;
  }
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kClusterThreads)
tail_cluster_kernel(const bf16* __restrict__ x, const __grid_constant__ Chain chain) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kCluster;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  float* act = reinterpret_cast<float*>(smem + chain.act);
  bf16* work = reinterpret_cast<bf16*>(smem + chain.work);
  constexpr int kBatch = 8;  // independent loads in flight per thread

  for (int i = 0; i < chain.n_layers; ++i) {
    const ChainLayer& L = chain.layer[i];
    bf16* y = reinterpret_cast<bf16*>(smem + ((i & 1) ? chain.y1 : chain.y0));
    const int s_in = L.s_in, lo_in = rank * s_in, wd_in = max(0, min(s_in, L.cin - lo_in));
    const int vout = L.dout * L.hout * L.wout;

    // a. the first block stages this CTA's slice of x with a zero halo;
    // then the depthwise of the slice
    if (i == 0) {
      const int hp = L.hin + 2, wp = L.win + 2, np = (L.din + 2) * hp * wp;
      const int vin = L.din * L.hin * L.win;
      const bf16* xb = x + static_cast<size_t>(b) * vin * L.cin + lo_in;
      for (int idx = threadIdx.x; idx < (np * s_in + 7) / 8; idx += blockDim.x) {
        reinterpret_cast<uint4*>(work)[idx] = make_uint4(0u, 0u, 0u, 0u);  // the halo
      }
      __syncthreads();
      const bool vec = s_in % 8 == 0 && L.cin % 8 == 0 && aligned16(x);  // wd_in % 8 == 0
      const int per = vec ? wd_in / 8 : wd_in;  // copies per voxel
      if (per > 0) {
        // thread (ty, tx): copy tx of voxels ty, ty + lanes, ...
        const int lanes = blockDim.x / per, tx = threadIdx.x % per, ty = threadIdx.x / per;
        for (int v0 = ty; ty < lanes && v0 < vin; v0 += kBatch * lanes) {
          uint4 v[kBatch];
          bf16 e[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int vx = v0 + u * lanes;
            if (vx < vin && vec) {
              v[u] = *reinterpret_cast<const uint4*>(xb + static_cast<size_t>(vx) * L.cin + tx * 8);
            } else if (vx < vin) {
              e[u] = xb[static_cast<size_t>(vx) * L.cin + tx];
            }
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int vx = v0 + u * lanes;
            if (vx >= vin) break;
            const int iw = vx % L.win, ih = (vx / L.win) % L.hin, id = vx / (L.win * L.hin);
            bf16* dst = work + (((id + 1) * hp + ih + 1) * wp + iw + 1) * s_in;
            if (vec) {
              reinterpret_cast<uint4*>(dst)[tx] = v[u];
            } else {
              dst[tx] = e[u];
            }
          }
        }
      }
      __syncthreads();
      depthwise_slice(work, y, s_in, lo_in, wd_in, L);
    } else {
      depthwise_slice(act, y, s_in, lo_in, wd_in, L);
    }

    // b. every CTA's slice is ready: gather A through DSMEM, stage B, and
    // clear the activation buffer (its halo must be zero)
    cluster.sync();
    const int s_out = L.s_out, lo_out = rank * s_out;
    const int wd_out = max(0, min(s_out, L.cout - lo_out));
    const int kpad = round_up(L.cin, 16), mpad = round_up(vout, 16), npad = round_up(s_out, 16);
    const int lda = kpad + 8, ldb = npad + 8;
    bf16* A = work;
    bf16* B = work + mpad * lda;
    const bool next = i + 1 < chain.n_layers;
    const int hq = L.hout + 2, wq = L.wout + 2;
    if (next) {
      const int n4 = ((L.dout + 2) * hq * wq * s_out + 3) / 4;  // float4s; the region is 16-byte padded
      for (int idx = threadIdx.x; idx < n4; idx += blockDim.x) {
        reinterpret_cast<float4*>(act)[idx] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    if (s_in % 8 == 0 && L.cin % 8 == 0) {
      // thread (ty, tx) copies 16 bytes tx of rows ty, ty + lanes, ... from
      // every neighbour, all 8 in flight, each CTA starting at its own
      const int per = s_in / 8, lanes = blockDim.x / per;
      const int tx = threadIdx.x % per, ty = threadIdx.x / per;
      for (int m = ty; ty < lanes && m < vout; m += lanes) {
        uint4 v[kCluster];
#pragma unroll
        for (int u = 0; u < kCluster; ++u) {
          const int q = (u + rank) % kCluster;
          v[u] = make_uint4(0u, 0u, 0u, 0u);
          if (q * s_in < L.cin) {
            v[u] = reinterpret_cast<const uint4*>(cluster.map_shared_rank(y, q))[m * per + tx];
          }
        }
#pragma unroll
        for (int u = 0; u < kCluster; ++u) {
          const int k = ((u + rank) % kCluster) * s_in + tx * 8;
          if (k < L.cin) *reinterpret_cast<uint4*>(A + m * lda + k) = v[u];
        }
      }
      // the zero padding: K columns cin .. kpad-1, rows vout .. mpad-1
      const int kc = (kpad - L.cin) / 8;
      for (int idx = threadIdx.x; idx < vout * kc; idx += blockDim.x) {
        const int m = idx / kc, k = L.cin + (idx - m * kc) * 8;
        *reinterpret_cast<uint4*>(A + m * lda + k) = make_uint4(0u, 0u, 0u, 0u);
      }
      for (int idx = threadIdx.x; idx < (mpad - vout) * (kpad / 8); idx += blockDim.x) {
        const int m = vout + idx / (kpad / 8), k = (idx % (kpad / 8)) * 8;
        *reinterpret_cast<uint4*>(A + m * lda + k) = make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      for (int idx = threadIdx.x; idx < mpad * kpad; idx += blockDim.x) {
        const int m = idx / kpad, k = idx - m * kpad;
        bf16 v = __float2bfloat16_rn(0.f);
        if (m < vout && k < L.cin) {
          const int q = k / s_in;
          v = cluster.map_shared_rank(y, q)[m * s_in + (k - q * s_in)];
        }
        A[m * lda + k] = v;
      }
    }
    stage_b(B, ldb, L.pw_w, L.cin, L.cout, lo_out, wd_out, kpad, npad);
    __syncthreads();

    // c. the product on the tensor cores, BN + ReLU; the float32 result is
    // this CTA's slice of the next block's input (inside its halo)
    const int nt = npad / 16, tiles = (mpad / 16) * nt;
    for (int tile = warp; tile < tiles; tile += nwarps) {
      const int m0 = (tile / nt) * 16, n0 = (tile - (tile / nt) * nt) * 16;
      float gam[2][2], bet[2][2];  // this lane's 4 columns, loaded before the product
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = min(n0 + acc_col(lane, h, e), max(wd_out - 1, 0));
          gam[h][e] = L.pw_g[min(lo_out + n, L.cout - 1)];
          bet[h][e] = L.pw_b[min(lo_out + n, L.cout - 1)];
        }
      }
      // this lane's two rows m0 + g and m0 + g + 8: their places inside the halo
      int pos[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = m0 + acc_row(lane, 2 * r);
        const int ow = m % L.wout, oh = (m / L.wout) % L.hout, od = m / (L.wout * L.hout);
        pos[r] = (((od + 1) * hq + oh + 1) * wq + ow + 1) * s_out;
      }
      float d[2][4];
      mma_tile(d, A, lda, B, ldb, m0, n0, kpad, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + acc_row(lane, e), n = n0 + acc_col(lane, h, e);
          if (m < vout && n < wd_out) {
            const float z = relu(__fadd_rn(__fmul_rn(d[h][e], gam[h][e & 1]), bet[h][e & 1]));
            if (next) act[pos[e >> 1] + n] = z;
            if (L.emit) {
              L.emit[(static_cast<size_t>(b) * vout + m) * L.cout + lo_out + n] =
                  __float2bfloat16_rn(z);
            }
          }
        }
      }
    }
    __syncthreads();
  }
  cluster.sync();  // no CTA leaves while a neighbour may still read its slice
}

// ---------------------------------------------------------------- 2. block, mma

constexpr int kMmaVoxels = 32;    // output voxels per CTA
constexpr int kMmaChannels = 32;  // output channels per chunk
constexpr int kMmaThreads = 256;  // 8 warps for the depthwise, 4 for the product

__host__ __device__ __forceinline__ size_t mma_smem_bytes(int cin) {
  const int kpad = round_up(cin, 16);
  return (static_cast<size_t>(kMmaVoxels) * (kpad + 8) + static_cast<size_t>(kpad) *
          (kMmaChannels + 8)) * sizeof(bf16);
}

template <typename TIn>
__global__ void __launch_bounds__(kMmaThreads)
tail_block_mma_kernel(const TIn* __restrict__ x, const bf16* __restrict__ dw_w,
                      const float* __restrict__ dw_gamma, const float* __restrict__ dw_beta,
                      const bf16* __restrict__ pw_w, const float* __restrict__ pw_gamma,
                      const float* __restrict__ pw_beta, float* __restrict__ out_f32,
                      bf16* __restrict__ out_emit, int D, int H, int W, int Do, int Ho, int Wo,
                      int cin, int cout, int stride, int nout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kpad = round_up(cin, 16), lda = kpad + 8, ldb = kMmaChannels + 8;
  bf16* A = reinterpret_cast<bf16*>(smem);
  bf16* B = A + kMmaVoxels * lda;
  const int v0 = blockIdx.x * kMmaVoxels;

  // depthwise + BN + ReLU of the tile's voxels, every input channel, once
  for (int idx = threadIdx.x; idx < kMmaVoxels * kpad; idx += blockDim.x) {
    const int j = idx / kpad, c = idx - j * kpad;
    const int v = v0 + j;
    float y = 0.f;
    if (v < nout && c < cin) {
      const int ow = v % Wo, oh = (v / Wo) % Ho, od = (v / (Wo * Ho)) % Do, b = v / (Wo * Ho * Do);
      float wk[27];
      load_taps(wk, dw_w, cin, c);
      const float acc = dw_taps(x + static_cast<size_t>(b) * D * H * W * cin, cin, wk, c, od, oh,
                                ow, D, H, W, stride);
      y = relu(__fadd_rn(__fmul_rn(acc, dw_gamma[c]), dw_beta[c]));
    }
    A[j * lda + c] = __float2bfloat16_rn(y);
  }

  // warps 0-3 each take one 16 x 16 unit of the 32 x 32 output chunk
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = (warp >> 1) * 16, n0 = (warp & 1) * 16;
  for (int c0 = 0; c0 < cout; c0 += kMmaChannels) {
    const int width = min(kMmaChannels, cout - c0);
    __syncthreads();  // A is complete; the previous chunk's B is no longer read
    stage_b(B, ldb, pw_w, cin, cout, c0, width, kpad, kMmaChannels);
    __syncthreads();
    if (warp >= 4) continue;
    float d[2][4];
    mma_tile(d, A, lda, B, ldb, m0, n0, kpad, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int v = v0 + m0 + acc_row(lane, e), n = n0 + acc_col(lane, h, e);
        if (v < nout && n < width) {
          const float z = relu(__fadd_rn(__fmul_rn(d[h][e], pw_gamma[c0 + n]), pw_beta[c0 + n]));
          const size_t o = static_cast<size_t>(v) * cout + c0 + n;
          if (out_f32) out_f32[o] = z;
          if (out_emit) out_emit[o] = __float2bfloat16_rn(z);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- 3. block, float32

constexpr int kTileVoxels = 8;
constexpr int kTileChannels = 128;
constexpr int kThreads = 256;
constexpr int kRows = kThreads / kTileChannels;         // 2
constexpr int kVoxelsPerThread = kTileVoxels / kRows;  // 4
constexpr int kMaxSmem = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
tail_block_kernel(const float* __restrict__ x, const float* __restrict__ dw_w,
                  const float* __restrict__ dw_gamma, const float* __restrict__ dw_beta,
                  const float* __restrict__ pw_w, const float* __restrict__ pw_gamma,
                  const float* __restrict__ pw_beta, float* __restrict__ out, int D, int H,
                  int W, int Do, int Ho, int Wo, int cin, int cout, int stride, int nout) {
  extern __shared__ float ys[];  // [kTileVoxels][cin]
  const int v0 = blockIdx.x * kTileVoxels;

  // 1. depthwise + BN + ReLU of the tile's voxels, every input channel
  for (int idx = threadIdx.x; idx < kTileVoxels * cin; idx += kThreads) {
    const int j = idx / cin, c = idx - j * cin;
    const int v = v0 + j;
    float y = 0.f;
    if (v < nout) {
      const int ow = v % Wo, oh = (v / Wo) % Ho, od = (v / (Wo * Ho)) % Do, b = v / (Wo * Ho * Do);
      float wk[27];
      load_taps(wk, dw_w, cin, c);
      const float acc = dw_taps(x + static_cast<size_t>(b) * D * H * W * cin, cin, wk, c, od, oh,
                                ow, D, H, W, stride);
      y = relu(__fadd_rn(__fmul_rn(acc, dw_gamma[c]), dw_beta[c]));
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
    const float wv = pw_w[static_cast<size_t>(c) * cout + co];
#pragma unroll
    for (int k = 0; k < kVoxelsPerThread; ++k) {
      acc[k] = __fadd_rn(acc[k], __fmul_rn(ys[(row + k * kRows) * cin + c], wv));
    }
  }

  // 3. BN + ReLU, the float32 activation (which is also the emitted map)
  const float g = pw_gamma[co], bb = pw_beta[co];
#pragma unroll
  for (int k = 0; k < kVoxelsPerThread; ++k) {
    const int v = v0 + row + k * kRows;
    if (v >= nout) break;
    out[static_cast<size_t>(v) * cout + co] = relu(__fadd_rn(__fmul_rn(acc[k], g), bb));
  }
}

template <typename TIn>
void launch_mma(const TIn* x, const void* dw_w, const void* dw_g, const void* dw_b,
                const void* pw_w, const void* pw_g, const void* pw_b, void* out_f32,
                void* out_emit, int d, int h, int w, int dout, int hout, int wout, int cin,
                int cout, int stride, int nout, int grid, size_t smem, cudaStream_t s) {
  tail_block_mma_kernel<TIn><<<grid, kMmaThreads, smem, s>>>(
      x, static_cast<const bf16*>(dw_w), static_cast<const float*>(dw_g),
      static_cast<const float*>(dw_b), static_cast<const bf16*>(pw_w),
      static_cast<const float*>(pw_g), static_cast<const float*>(pw_b),
      static_cast<float*>(out_f32), static_cast<bf16*>(out_emit), d, h, w, dout, hout, wout, cin,
      cout, stride, nout);
}

bool g_smem_opted_in = false;  // the attributes are set once per process

cudaError_t opt_in_smem() {
  if (g_smem_opted_in) return cudaSuccess;
  const void* kernels[] = {reinterpret_cast<const void*>(tail_cluster_kernel),
                           reinterpret_cast<const void*>(tail_block_mma_kernel<bf16>),
                           reinterpret_cast<const void*>(tail_block_mma_kernel<float>)};
  for (const void* k : kernels) {
    const cudaError_t err =
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
  }
  g_smem_opted_in = true;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// One block of the chain, per-block kernels. x (b, d, h, w, cin) in memory,
// float32 if in_f32 else in `dtype` (0 float32, 1 bfloat16); dw_w (3, 3, 3,
// cin) and pw_w (cin, cout) in `dtype`; the four BN vectors float32. Writes
// the float32 activation to out_f32 and, for bfloat16, the map in bf16 to
// out_emit; either may be null (for float32 the map is out_f32). Launches
// on `stream` and does not synchronise. Returns a cudaError_t.
int msl_tail_block(const void* x, const void* dw_w, const void* dw_g, const void* dw_b,
                   const void* pw_w, const void* pw_g, const void* pw_b, void* out_f32,
                   void* out_emit, int in_f32, int dtype, int b, int d, int h, int w, int cin,
                   int cout, int stride, void* stream) {
  if (b <= 0 || d <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 ||
      (stride != 1 && stride != 2) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dout = (d - 1) / stride + 1, hout = (h - 1) / stride + 1, wout = (w - 1) / stride + 1;
  const int nout = b * dout * hout * wout;
  if (dtype == 0) {
    const size_t smem = static_cast<size_t>(kTileVoxels) * cin * sizeof(float);
    if (smem > kMaxSmem || out_f32 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((nout + kTileVoxels - 1) / kTileVoxels,
                    (cout + kTileChannels - 1) / kTileChannels);
    tail_block_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dw_w),
        static_cast<const float*>(dw_g), static_cast<const float*>(dw_b),
        static_cast<const float*>(pw_w), static_cast<const float*>(pw_g),
        static_cast<const float*>(pw_b), static_cast<float*>(out_f32), d, h, w, dout, hout,
        wout, cin, cout, stride, nout);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = mma_smem_bytes(cin);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (nout + kMmaVoxels - 1) / kMmaVoxels;
  if (in_f32) {
    launch_mma(static_cast<const float*>(x), dw_w, dw_g, dw_b, pw_w, pw_g, pw_b, out_f32,
               out_emit, d, h, w, dout, hout, wout, cin, cout, stride, nout, grid, smem, s);
  } else {
    launch_mma(static_cast<const bf16*>(x), dw_w, dw_g, dw_b, pw_w, pw_g, pw_b, out_f32,
               out_emit, d, h, w, dout, hout, wout, cin, cout, stride, nout, grid, smem, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The whole chain in one launch of tail_cluster_kernel, bfloat16. x (b, d,
// h, w, cin); ptrs holds 7 pointers per layer (dw_w, dw_g, dw_b, pw_w, pw_g,
// pw_b, the emitted map or null); dims 11 ints per layer (cin, cout, stride,
// din, hin, win, dout, hout, wout, s_in, s_out); offsets the shared-memory
// layout (act, y0, y1, work, total bytes). Launches on `stream` and does
// not synchronise. Returns a cudaError_t.
int msl_tail_cluster(const void* x, const void* const* ptrs, const int* dims, int n_layers,
                     const int* offsets, int b, void* stream) {
  if (b <= 0 || n_layers <= 0 || n_layers > kMaxLayers || offsets[4] > kSmemMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Chain chain = {};
  for (int i = 0; i < n_layers; ++i) {
    const void* const* p = ptrs + 7 * i;
    const int* q = dims + 11 * i;
    chain.layer[i] = ChainLayer{
        static_cast<const bf16*>(p[0]), static_cast<const float*>(p[1]),
        static_cast<const float*>(p[2]), static_cast<const bf16*>(p[3]),
        static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
        static_cast<bf16*>(const_cast<void*>(p[6])),
        q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7], q[8], q[9], q[10]};
  }
  chain.n_layers = n_layers;
  chain.act = offsets[0];
  chain.y0 = offsets[1];
  chain.y1 = offsets[2];
  chain.work = offsets[3];
  cudaError_t err = opt_in_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  tail_cluster_kernel<<<b * kCluster, kClusterThreads, offsets[4],
                        static_cast<cudaStream_t>(stream)>>>(static_cast<const bf16*>(x), chain);
  return static_cast<int>(cudaGetLastError());
}

const char* msl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
