// Fused depthwise 3x3x3 conv + folded BN + ReLU for Hopper (sm_90a): kernel K2 of the port.
//
// Replaces mslesions3d_tpu/kernels/depthwise.py::fused_depthwise_bn_relu
// (body _dw_kernel). Same function: for x (B, D, H, W, C) in memory (the
// model's channels_last_3d views), stride 1 and zero padding 1,
//   out = round(relu(acc * gamma + beta)),
//   acc = sum_{kd,kh,kw} x[d+kd-1, h+kh-1, w+kw-1] * w[kd,kh,kw]
// with the 27 taps summed in float32 in (kd, kh, kw) order from 0, the BN
// affine and ReLU in float32, and one rounding to x's dtype (nearest even).
// A padded tap still adds 0 * w, as the plain version's zero padding does,
// so the two agree bit for bit (the build passes -fmad=false, and the sums
// use round-to-nearest intrinsics). ReLU keeps NaN, as torch.relu does.
//
// What bounds it on this card: bytes in the ideal (each element read once
// and written once; the 27 taps are ~57 float32 operations per element, far
// below the ~20 operations per byte where float32 arithmetic would bound).
// At the model's sizes (a few MB) what costs is the work per element the
// card issues and the latency of one wave. The first version (kept below as
// the "direct" kernel) issued 27 bounds-checked global loads and a chain of
// integer divisions per voxel, held 54 weight registers per thread at 25%
// occupancy, and left the 27-fold reuse of each input element to L1/L2.
//
// Design of the "tiled" kernel. The TPU kernel takes one depth row per grid
// step with its two neighbour rows as three VMEM views. Here a CTA owns one
// sample, a slab of `td` output depths, a band of `th` output rows, all of W,
// and a slice of `cs` channels:
//  - its input planes d0-1 .. d0+td, rows h0-1 .. h0+th and columns -1 .. W
//    go into shared memory with cp.async, one commit group per plane, every
//    position outside the volume written as zeros (the zero halo), so the tap
//    loop has no bounds check. Output plane i computes as soon as planes i ..
//    i+2 have landed, while the later planes are still streaming in;
//  - each thread owns one channel pair, with its 27 weight pairs and its
//    gamma/beta pair in registers. Lanes are neighbouring pairs, so a
//    shared-memory read of a warp is 128 contiguous bytes (bf16) and
//    conflict-free, and each output store is coalesced;
//  - a thread walks a row along W with a register window: the 9 (kd, kh)
//    values of columns w-1, w and w+1. Each step reads one new column of 9
//    values from shared memory, where the first version read 27 from global
//    memory; the per-output sum order does not change;
//  - indices come from blockIdx once per CTA and per row; the loader
//    advances with carries.
// kernels/depthwise.py::plan_depthwise picks the tile from the shapes and
// passes it here; shapes whose smallest tile (one depth, one row, one
// channel pair) does not fit a block's shared memory take the direct kernel.
//
// What holds the tiled kernel now: the instructions it issues. Exactness
// forbids FMA, so an output pair costs 54 FMUL and 54 FADD before the
// shared-memory reads, the bf16 unpacking and the epilogue, and each output
// is a chain of 27 dependent adds. At the model's few thousand rows a layer
// the split of rows over the 132 SMs matters as much, and the first three
// planes' copies come before any sum: the planner's tile choice weighs both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxThreads = 256;   // the tiled kernel: walkers x channel pairs of a slice
constexpr int kMaxDepths = 8;      // output depths of a slab: cp.async groups in flight, less 2
constexpr int kSmemMax = 232448;   // a Hopper block's opt-in maximum of shared memory
constexpr int kDirectThreads = 256;
constexpr int kVoxelsPerThread = 4;  // direct kernel: voxel strip a thread walks, on average

template <typename T>
struct Pair;

template <>
struct Pair<float> {
  using V = float2;
  static __device__ __forceinline__ float2 f2(float2 v) { return v; }
  static __device__ __forceinline__ float2 store(float2 v) { return v; }
};

template <>
struct Pair<__nv_bfloat16> {
  using V = __nv_bfloat162;
  // exact: a bf16 is the high half of a float. Two integer operations a
  // pair, where __bfloat1622float2 takes three (the walk unpacks 9 a step)
  static __device__ __forceinline__ float2 f2(__nv_bfloat162 v) {
    const unsigned u = *reinterpret_cast<const unsigned*>(&v);
    return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
  }
  static __device__ __forceinline__ __nv_bfloat162 store(float2 v) {
    return __floats2bfloat162_rn(v.x, v.y);
  }
};

// torch.relu: negative to 0, NaN stays NaN
__device__ __forceinline__ float relu(float y) { return (y > 0.f || y != y) ? y : 0.f; }

__device__ __forceinline__ float2 bn_relu(float2 acc, float2 g, float2 b) {
  return make_float2(relu(__fadd_rn(__fmul_rn(acc.x, g.x), b.x)),
                     relu(__fadd_rn(__fmul_rn(acc.y, g.y), b.y)));
}

__device__ __forceinline__ void tap(float2& acc, float2 x, float2 w) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(x.x, w.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(x.y, w.y));
}

// ---------------------------------------------------------------- tiled kernel
// `vec` bytes from global to shared memory: 16, 8 or 4 (the widest that
// divides a voxel's channels, the slice and x's alignment)
__device__ __forceinline__ void cp_async(void* dst, const void* src, int vec) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  } else if (vec == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
  }
}

__device__ __forceinline__ void zero(void* dst, int vec) {
  if (vec == 16) {
    *static_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  } else if (vec == 8) {
    *static_cast<uint2*>(dst) = make_uint2(0u, 0u);
  } else {
    *static_cast<unsigned*>(dst) = 0u;
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most n of this thread's groups are pending (n < kMaxDepths)
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 7: cp_async_wait<7>(); break;
    case 6: cp_async_wait<6>(); break;
    case 5: cp_async_wait<5>(); break;
    case 4: cp_async_wait<4>(); break;
    case 3: cp_async_wait<3>(); break;
    case 2: cp_async_wait<2>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<0>(); break;
  }
}

struct Tile {
  int d, h, w, c;            // x's sizes (the batch is in the grid)
  int cs, td, th;            // channels, output depths and output rows of a CTA
  int ns, nbands, nslabs;    // slices, bands and slabs
  int vec;                   // bytes per cp.async copy
};

// The 9 (kd, kh) values of one padded column, as float pairs.
template <typename T>
__device__ __forceinline__ void load_column(float2 (&v)[9], const T* p, int sd, int sh) {
  using V = typename Pair<T>::V;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    v[k] = Pair<T>::f2(*reinterpret_cast<const V*>(p + (k / 3) * sd + (k % 3) * sh));
  }
}

// One output of the register window: columns a, b (held) and c (read from
// `col` here, value by value as the sum reaches it, so a's values die as c's
// arrive), summed in (kd, kh, kw) order.
template <typename T>
__device__ __forceinline__ float2 window_step(const float2 (&a)[9], const float2 (&b)[9],
                                              float2 (&c)[9], const T* col, int sd, int sh,
                                              const float2 (&wt)[27]) {
  using V = typename Pair<T>::V;
  float2 acc = make_float2(0.f, 0.f);
#pragma unroll
  for (int k = 0; k < 9; ++k) {  // (kd, kh) = (k / 3, k % 3), then kw = 0, 1, 2
    c[k] = Pair<T>::f2(*reinterpret_cast<const V*>(col + (k / 3) * sd + (k % 3) * sh));
    tap(acc, a[k], wt[3 * k]);
    tap(acc, b[k], wt[3 * k + 1]);
    tap(acc, c[k], wt[3 * k + 2]);
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
dw_tiled_kernel(const T* __restrict__ x, const T* __restrict__ wts,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                T* __restrict__ out, const Tile t) {
  using V = typename Pair<T>::V;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int e = sizeof(T);

  // this CTA's tile, from blockIdx once: slice fastest, then band, slab, sample
  int r = blockIdx.x;
  const int slice = r % t.ns;
  r /= t.ns;
  const int band = r % t.nbands;
  r /= t.nbands;
  const int slab = r % t.nslabs;
  const int bi = r / t.nslabs;
  const int c0 = slice * t.cs, csv = min(t.cs, t.c - c0);
  const int h0 = band * t.th, d0 = slab * t.td;
  const int td = min(t.td, t.d - d0);
  const int wp = t.w + 2, hp = t.th + 2, npix = hp * wp;  // padded columns, rows, pixels a plane
  const int tid = threadIdx.x;

  // 1. the input planes d0-1 .. d0+td into shared memory, one group each.
  // Thread tid copies chunk q of pixels p0, p0 + pstep, ...; a pixel is the
  // slice's csv channels of one (row, column), cs * e bytes apart.
  const int nch = csv * e / t.vec;
  const int q = tid % nch, p0 = tid / nch, pstep = blockDim.x / nch;
  const int step_r = pstep / wp, step_c = pstep - step_r * wp;
  const int row0 = p0 / wp, col0 = p0 - row0 * wp;
  const size_t vox = static_cast<size_t>(t.c) * e;  // bytes per voxel of x
  const unsigned char* xs = reinterpret_cast<const unsigned char*>(x) +
                            static_cast<size_t>(bi) * t.d * t.h * t.w * vox +
                            static_cast<size_t>(c0) * e + q * t.vec;
  const int pix = t.cs * e;
  for (int pl = 0; pl < td + 2; ++pl) {
    const int gd = d0 - 1 + pl;
    const bool d_ok = gd >= 0 && gd < t.d;
    unsigned char* sp = smem + static_cast<size_t>(pl) * npix * pix + q * t.vec;
    if (tid < pstep * nch) {
      int row = row0, col = col0;
      for (int p = p0; p < npix; p += pstep) {
        const int gh = h0 - 1 + row, gw = col - 1;
        if (d_ok && gh >= 0 && gh < t.h && gw >= 0 && gw < t.w) {
          cp_async(sp + p * pix, xs + ((static_cast<size_t>(gd) * t.h + gh) * t.w + gw) * vox,
                   t.vec);
        } else {
          zero(sp + p * pix, t.vec);
        }
        col += step_c;
        row += step_r;
        if (col >= wp) {
          col -= wp;
          ++row;
        }
      }
    }
    cp_async_commit();
  }

  // 2. this thread's channel pair: weights and BN affine in registers
  const int pairs = t.cs / 2;
  const int pair = tid % pairs, walker = tid / pairs, walkers = blockDim.x / pairs;
  const bool active = 2 * pair < csv;
  const int P = t.c / 2, gp = c0 / 2 + pair;
  float2 wt[27];
  float2 g = make_float2(0.f, 0.f), b = make_float2(0.f, 0.f);
  if (active) {
    const V* wv = reinterpret_cast<const V*>(wts);
#pragma unroll
    for (int k = 0; k < 27; ++k) wt[k] = Pair<T>::f2(wv[static_cast<size_t>(k) * P + gp]);
    g = reinterpret_cast<const float2*>(gamma)[gp];
    b = reinterpret_cast<const float2*>(beta)[gp];
  }

  // 3. output plane by output plane, as its three input planes land
  const int sh = wp * t.cs, sd = hp * sh;  // elements between padded rows and planes
  const T* tile = reinterpret_cast<const T*>(smem) + 2 * pair;
  V* ov = reinterpret_cast<V*>(out);
  for (int i = 0; i < td; ++i) {
    cp_async_wait_pending(td - 1 - i);  // planes 0 .. i + 2 have landed
    __syncthreads();
    if (!active) continue;
    for (int hl = walker; hl < t.th && h0 + hl < t.h; hl += walkers) {
      // padded column j of output row (i, hl), tap (0, 0): output w reads j = w .. w + 2
      const T* p = tile + i * sd + hl * sh;
      // the window's three columns rotate roles, three outputs a turn
      float2 c0v[9], c1v[9], c2v[9];
      load_column(c0v, p, sd, sh);
      load_column(c1v, p + t.cs, sd, sh);
      V* o = ov + ((static_cast<size_t>(bi) * t.d + d0 + i) * t.h + h0 + hl) * t.w * P + gp;
      const T* col = p + 2 * t.cs;
      // output w + k from the held columns a0, a1 and the new column a2
      auto out_k = [&](int k, const float2(&a0)[9], const float2(&a1)[9], float2(&a2)[9]) {
        o[k * P] = Pair<T>::store(
            bn_relu(window_step(a0, a1, a2, col + k * t.cs, sd, sh, wt), g, b));
      };
      int w = 0;
      for (; w + 3 <= t.w; w += 3, col += 3 * t.cs, o += 3 * P) {
        out_k(0, c0v, c1v, c2v);
        out_k(1, c1v, c2v, c0v);
        out_k(2, c2v, c0v, c1v);
      }
      if (w < t.w) out_k(0, c0v, c1v, c2v);
      if (w + 1 < t.w) out_k(1, c1v, c2v, c0v);
    }
  }
}

// ---------------------------------------------------------------- direct kernel
// The first version, for shapes no tile fits: one thread per channel pair
// walks a strip of voxels, each tap a bounds-checked global load.
template <typename T>
__global__ void __launch_bounds__(kDirectThreads)
dw_direct_kernel(const T* __restrict__ x, const T* __restrict__ w,
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
  for (int k = 0; k < 27; ++k) wt[k] = Pair<T>::f2(wv[static_cast<size_t>(k) * P + p]);
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
            xin = Pair<T>::f2(xv[voxel * P + p]);
          }
          tap(acc, xin, wt[(kd * 3 + kh) * 3 + kw]);
        }
      }
    }
    ov[static_cast<size_t>(v) * P + p] = Pair<T>::store(bn_relu(acc, g, b));
  }
}

bool g_smem_opted_in = false;  // the attribute is set once per process

cudaError_t opt_in_smem() {
  if (g_smem_opted_in) return cudaSuccess;
  const void* kernels[] = {reinterpret_cast<const void*>(dw_tiled_kernel<float>),
                           reinterpret_cast<const void*>(dw_tiled_kernel<__nv_bfloat16>)};
  for (const void* k : kernels) {
    const cudaError_t err =
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
  }
  g_smem_opted_in = true;
  return cudaSuccess;
}

template <typename T>
int launch_tiled(const void* x, const void* w, const void* gamma, const void* beta, void* out,
                 int b, int d, int h, int wd, int c, int cs, int td, int th, int threads,
                 int smem, int vec, cudaStream_t s) {
  const int e = static_cast<int>(sizeof(T));
  const long need = static_cast<long>(td + 2) * (th + 2) * (wd + 2) * cs * e;
  if (cs < 2 || cs % 2 || td < 1 || td > kMaxDepths || th < 1 || threads < cs / 2 ||
      threads % (cs / 2) || threads > kMaxThreads || (vec != 4 && vec != 8 && vec != 16) ||
      vec < 2 * e || (c * e) % vec || (cs * e) % vec || smem < need || smem > kSmemMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Tile t{d, h, wd, c, cs, td, th, (c + cs - 1) / cs, (h + th - 1) / th, (d + td - 1) / td, vec};
  const long grid = static_cast<long>(b) * t.nslabs * t.nbands * t.ns;
  if (grid > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = opt_in_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  dw_tiled_kernel<T><<<static_cast<unsigned>(grid), threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(out), t);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_direct(const void* x, const void* w, const void* gamma, const void* beta, void* out,
                  int b, int d, int h, int wd, int c, cudaStream_t s) {
  const int P = c / 2;
  const int nvox = b * d * h * wd;
  const int bx = P < 64 ? P : 64;
  const int by = kDirectThreads / bx;
  const int gx = (P + bx - 1) / bx;
  int gy = (nvox + by * kVoxelsPerThread - 1) / (by * kVoxelsPerThread);
  if (gy > 65535) gy = 65535;
  dw_direct_kernel<T><<<dim3(gx, gy), dim3(bx, by), 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(out), nvox, d, h, wd, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x and out (b, d, h, w, c) in memory, weights (3, 3, 3, c), all of one
// dtype (0 float32, 1 bfloat16); gamma, beta (c,) float32; c even; every
// pointer aligned to a channel pair, x to `vec` bytes. `variant` 0 runs the
// tiled kernel with the tile (cs, td, th), `threads` a CTA and `smem`
// bytes of dynamic shared memory; 1 runs the direct kernel and ignores the
// tile. kernels/depthwise.py::plan_depthwise chooses them. Launches on
// `stream` and does not synchronise. Returns a cudaError_t.
int msl_depthwise_bn_relu(const void* x, const void* w, const void* gamma, const void* beta,
                          void* out, int dtype, int b, int d, int h, int wd, int c, int variant,
                          int cs, int td, int th, int threads, int smem, int vec,
                          void* stream) {
  if (b <= 0 || d <= 0 || h <= 0 || wd <= 0 || c <= 0 || c % 2 || (dtype != 0 && dtype != 1) ||
      (variant != 0 && variant != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (dtype == 0) return launch_direct<float>(x, w, gamma, beta, out, b, d, h, wd, c, s);
    return launch_direct<__nv_bfloat16>(x, w, gamma, beta, out, b, d, h, wd, c, s);
  }
  if (dtype == 0) {
    return launch_tiled<float>(x, w, gamma, beta, out, b, d, h, wd, c, cs, td, th, threads, smem,
                               vec, s);
  }
  return launch_tiled<__nv_bfloat16>(x, w, gamma, beta, out, b, d, h, wd, c, cs, td, th, threads,
                                     smem, vec, s);
}

const char* msl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
