// 3x3x3 weight gradient of a conv with one input channel a group, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this gradient to XLA (the
// vjp of jax.lax.conv_general_dilated), and the port's training backward left
// it to cuDNN (aten.convolution_backward), whose grouped kernel
// (wgrad2d_grouped_direct) ran at about 0.37% of its byte bound on an H100
// and, over the depthwise convs and the stem, took about half of a batch-64
// MobileNet train step. Function: for x (N, D, H, W, CX) and gz (N, OD, OH,
// OW, C) in memory (the model's channels_last_3d views), CX = C (a depthwise
// conv) or CX = 1 (a conv of one input channel, as the stem: every output
// channel reads it), stride s and zero padding p per dimension,
//   grad_w[c, kd, kh, kw] += sum_{n, od, oh, ow} gz[n, od, oh, ow, c]
//                            * x[n, s*od + kd - p, s*oh + kh - p, s*ow + kw - p, c or 0]
// with every product added in float32 (an FMA), whatever the input dtype.
//
// What bounds it on this card: bytes, in the ideal. Each element of x and gz
// is needed once; the 27 multiply-adds per element of gz are far below the
// card's operations-per-byte balance, but they are not free: at the stem's
// 32 channels of one input channel they take as long to execute as the bytes
// take to arrive. Design:
//  - a tile is `tn` samples, `td` output depths, `th` output rows, `tw`
//    output columns and a slice of `cs` channels; its input region, with the
//    halo its taps reach, and its gz tile are staged in shared memory, what
//    lies outside the volume written as zeros, so the tap loop has no bounds
//    check;
//  - each CTA takes every gridDim.x-th tile of its channel slice, in order,
//    through two buffers: it issues the next tile's copies (cp.async, 16
//    bytes a copy along the contiguous channels where C allows, a warp a row
//    of positions) before it sums the one that has landed;
//  - each summing thread owns `cpt` channels (a float4, or four bf16; one
//    where the slice is not a multiple of 4), one kd and a strided share of
//    a tile's positions, with its 9 x cpt float32 sums in registers across
//    the CTA's tiles; a one-channel x is one value a tap, read by the lanes
//    of a position at once;
//  - the CTA adds its threads' sums in shared memory in a fixed order and
//    writes its 27 x cs sums to a workspace row of its own; a second kernel
//    adds the rows in a fixed order into grad_w. No float atomics: a launch
//    repeats bit for bit.
// kernels/dw_wgrad.py::plan_dw_wgrad picks the tile and the CTAs.
//
// What holds it now (an H100, at the MobileNet recipe's shapes: 23-33% of
// the byte bound on the stem and the two largest depthwise convs): a CTA's
// copies and its sums do not overlap. Builds with either part cut out each
// take about half a launch, and the whole launch takes their sum; a pair of
// producer warps handing buffers over by named barriers kept too few copies
// in flight and ran slower. Whole rows by TMA bulk copies are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kSmemMax = 232448;    // a Hopper block's opt-in maximum of shared memory
constexpr int kFinishColumns = 32;  // the finishing kernel: columns of 27 x C a CTA ...
constexpr int kFinishRows = 8;      // ... and workspace rows summed side by side

struct Geometry {
  int n, d, h, w, c;          // x's extents, gz's channels
  int cx;                     // x's channels: c, or 1 (every output channel reads it)
  int od, oh, ow;             // gz
  int sd, sh, sw, pd, ph, pw;  // stride, padding
  int cs, tn, td, th, tw;     // the tile
  int rd, rh, rw;             // its input region: s * (t - 1) + 3 a dimension
  int ndt, nht, nwt;          // tiles along OD, OH, OW
  int tiles;                  // tiles of a channel slice
  int p;                      // position workers: 3 * (cs / cpt) * p threads sum
  int vec, xvec;              // bytes a copy of gz, of x
  int gs_offset;              // bytes from the start of a buffer to its gz tile
  int buf_bytes;              // bytes of a buffer: a tile's input region and gz tile
};

// cpt (4 or 1) consecutive channels from shared memory, as float32
template <typename T, int CPT>
__device__ __forceinline__ void load(const T* p, float (&v)[CPT]) {
  if constexpr (std::is_same_v<T, float>) {
    if constexpr (CPT == 4) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
      v[0] = *p;
    }
  } else {  // exact: a bf16 is the high half of a float
    if constexpr (CPT == 4) {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      v[0] = __uint_as_float(q.x << 16); v[1] = __uint_as_float(q.x & 0xffff0000u);
      v[2] = __uint_as_float(q.y << 16); v[3] = __uint_as_float(q.y & 0xffff0000u);
    } else {
      v[0] = __uint_as_float(static_cast<unsigned>(*reinterpret_cast<const unsigned short*>(p))
                             << 16);
    }
  }
}

// `vec` bytes from global to shared memory: 16, 8 or 4 by cp.async, 2 (a
// single bf16 channel) by a plain load and store
__device__ __forceinline__ void copy(unsigned char* dst, const unsigned char* src, int vec) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  } else if (vec == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  } else if (vec == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
  } else {
    *reinterpret_cast<unsigned short*>(dst) = *reinterpret_cast<const unsigned short*>(src);
  }
}

__device__ __forceinline__ void zero(unsigned char* dst, int vec) {
  if (vec == 16) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  } else if (vec == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
  } else if (vec == 4) {
    *reinterpret_cast<unsigned*>(dst) = 0u;
  } else {
    *reinterpret_cast<unsigned short*>(dst) = 0;
  }
}

// One row of `len` positions into shared memory at `dst` (`pos_bytes` a
// position): position i reads the source's position i - off of `limit`
// (`pitch` bytes apart), or zeros outside [0, limit) or when the row lies
// outside the volume. A lane copies chunk k of positions first, first +
// step, ... (its warp covers step positions a pass).
__device__ __forceinline__ void stage_row(unsigned char* dst, const unsigned char* src, bool in,
                                          int len, int off, int limit, int pitch, int pos_bytes,
                                          int vec, int first, int step) {
  for (int i = first; i < len; i += step) {
    const int j = i - off;
    if (in && j >= 0 && j < limit) {
      copy(dst + i * pos_bytes, src + static_cast<long>(j) * pitch, vec);
    } else {
      zero(dst + i * pos_bytes, vec);
    }
  }
}

// A tile's place: its first sample, output depth, row and column, and its
// outputs inside the volume
struct Tile {
  int n0, od0, oh0, ow0, vn, vd, vh, vw;
};

__device__ __forceinline__ Tile tile_at(const Geometry& g, int t) {
  Tile r;
  const int wi = t % g.nwt;
  t /= g.nwt;
  const int hi = t % g.nht;
  t /= g.nht;
  const int di = t % g.ndt;
  const int ni = t / g.ndt;
  r.n0 = ni * g.tn; r.od0 = di * g.td; r.oh0 = hi * g.th; r.ow0 = wi * g.tw;
  r.vn = min(g.tn, g.n - r.n0); r.vd = min(g.td, g.od - r.od0);
  r.vh = min(g.th, g.oh - r.oh0); r.vw = min(g.tw, g.ow - r.ow0);
  return r;
}

// Issues the copies of tile t's input region and gz tile into `buf`, a warp
// a row of positions (rows no output reads are skipped), and writes the
// zeros outside the volume
template <typename T, bool ONE>
__device__ __forceinline__ void stage(const T* __restrict__ x, const T* __restrict__ gz,
                                      const Geometry& g, const Tile& t, int c0,
                                      unsigned char* buf) {
  constexpr int e = static_cast<int>(sizeof(T));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  {
    const int pos_bytes = (ONE ? 1 : g.cs) * e, pitch = g.cx * e;
    const int cpp = pos_bytes / g.xvec;  // copies a position, at most 32
    const int step = 32 / cpp;
    const int first = lane / cpp, k = lane % cpp;
    const unsigned char* xb = reinterpret_cast<const unsigned char*>(x) +
                              static_cast<long>(ONE ? 0 : c0) * e + k * g.xvec;
    unsigned char* dst = buf + k * g.xvec;
    const int ud = g.sd * (t.vd - 1) + 3, uh = g.sh * (t.vh - 1) + 3;
    const int rows = first < step ? g.tn * g.rd * g.rh : 0;
    for (int row = warp; row < rows; row += warps) {
      const int ih = row % g.rh, id = (row / g.rh) % g.rd, nn = row / (g.rh * g.rd);
      if (nn >= t.vn || id >= ud || ih >= uh) continue;
      const int dd = t.od0 * g.sd - g.pd + id, hh = t.oh0 * g.sh - g.ph + ih;
      const bool in = dd >= 0 && dd < g.d && hh >= 0 && hh < g.h;
      const long base = in ? ((static_cast<long>(t.n0 + nn) * g.d + dd) * g.h + hh) * g.w : 0;
      stage_row(dst + row * g.rw * pos_bytes, xb + base * pitch, in, g.rw,
                g.pw - t.ow0 * g.sw, g.w, pitch, pos_bytes, g.xvec, first, step);
    }
  }
  {
    const int pos_bytes = g.cs * e, pitch = g.c * e;
    const int cpp = pos_bytes / g.vec;
    const int step = 32 / cpp;
    const int first = lane / cpp, k = lane % cpp;
    const unsigned char* gb = reinterpret_cast<const unsigned char*>(gz) +
                              static_cast<long>(c0) * e + k * g.vec;
    unsigned char* dst = buf + g.gs_offset + k * g.vec;
    const int rows = first < step ? g.tn * g.td * g.th : 0;
    for (int row = warp; row < rows; row += warps) {
      const int b = row % g.th, a = (row / g.th) % g.td, nn = row / (g.th * g.td);
      if (nn >= t.vn || a >= t.vd || b >= t.vh) continue;
      const long base =
          ((static_cast<long>(t.n0 + nn) * g.od + t.od0 + a) * g.oh + t.oh0 + b) * g.ow;
      stage_row(dst + row * g.tw * pos_bytes, gb + base * pitch, true, t.vw, -t.ow0, g.ow,
                pitch, pos_bytes, g.vec, first, step);
    }
  }
}

// Adds a worker's products of tile t (staged in `buf`) to its sums: channel
// group gi, tap depth kd, positions p, p + P, ... of the tile in order
template <typename T, int CPT, bool ONE>
__device__ __forceinline__ void accumulate(const Geometry& g, const Tile& t,
                                           const unsigned char* buf, int gi, int p, int kd,
                                           float (&acc)[9][CPT]) {
  const int xcs = ONE ? 1 : g.cs;  // x's channels a position of the tile
  const T* xs = reinterpret_cast<const T*>(buf) + (ONE ? 0 : gi * CPT);
  const T* gs = reinterpret_cast<const T*>(buf + g.gs_offset) + gi * CPT;
  const int xrow = g.rw * xcs;
  int o = p, nn = 0, a = 0, b = 0;  // position (nn, a, b, o) of the tile, o < vw
  for (;;) {
    while (o >= t.vw) {
      o -= t.vw;
      if (++b == t.vh) {
        b = 0;
        if (++a == t.vd) {
          a = 0;
          ++nn;
        }
      }
    }
    if (nn >= t.vn) break;
    float gv[CPT];
    load<T, CPT>(gs + (((nn * g.td + a) * g.th + b) * g.tw + o) * g.cs, gv);
    const T* xp = xs + (((nn * g.rd + g.sd * a + kd) * g.rh + g.sh * b) * g.rw + g.sw * o) * xcs;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        float xv[CPT];
        if constexpr (ONE) {
          float one[1];
          load<T, 1>(xp + kh * xrow + kw, one);
#pragma unroll
          for (int j = 0; j < CPT; ++j) xv[j] = one[0];
        } else {
          load<T, CPT>(xp + kh * xrow + kw * g.cs, xv);
        }
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          acc[kh * 3 + kw][j] = __fmaf_rn(gv[j], xv[j], acc[kh * 3 + kw][j]);
        }
      }
    }
    o += g.p;
  }
}

// A CTA takes the tiles blockIdx.x, + gridDim.x, ... of its channel slice in
// order, two buffers in turn: the next tile's copies are in flight while the
// workers sum the one before. Its sums go to workspace row blockIdx.x.
template <typename T, int CPT, bool ONE>  // ONE: x has one channel
__global__ void __launch_bounds__(kMaxThreads)
    dw_wgrad_tiles(const T* __restrict__ x, const T* __restrict__ gz, float* __restrict__ ws,
                   const Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c0 = blockIdx.y * g.cs;
  const int groups = g.cs / CPT;
  const int workers = 3 * groups * g.p;
  const int tid = threadIdx.x;
  const int gi = tid % groups, p = (tid / groups) % g.p, kd = tid / (groups * g.p);
  float acc[9][CPT];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  }
  int t = blockIdx.x;
  Tile cur = tile_at(g, t);
  stage<T, ONE>(x, gz, g, cur, c0, smem);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int k = 0; t < g.tiles; ++k, t += gridDim.x) {
    const Tile next = tile_at(g, t + gridDim.x);
    if (t + gridDim.x < g.tiles) {
      stage<T, ONE>(x, gz, g, next, c0, smem + ((k + 1) & 1) * g.buf_bytes);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this tile's copies have landed
    __syncthreads();
    if (tid < workers) {
      accumulate<T, CPT, ONE>(g, cur, smem + (k & 1) * g.buf_bytes, gi, p, kd, acc);
    }
    __syncthreads();  // the buffer is read: the tile after next may go there
    cur = next;
  }

  // ---- the CTA's sums: red[p][tap][cs], added over p in order
  float* red = reinterpret_cast<float*>(smem);
  if (tid < workers) {
    float* r = red + (p * 27 + kd * 9) * g.cs + gi * CPT;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) r[i * g.cs + j] = acc[i][j];
    }
  }
  __syncthreads();
  float* row = ws + static_cast<long>(blockIdx.x) * 27 * g.c + c0;
  for (int q = tid; q < 27 * g.cs; q += blockDim.x) {
    float s = red[q];
    for (int i = 1; i < g.p; ++i) s = __fadd_rn(s, red[i * 27 * g.cs + q]);
    row[(q / g.cs) * g.c + q % g.cs] = s;
  }
}

// grad_w[c, tap] += the sum over the workspace's rows of row[tap, c], the
// rows r, r + 8, ... in order in each of 8 partial sums, then those in order
__global__ void __launch_bounds__(kFinishColumns* kFinishRows)
    dw_wgrad_finish(const float* __restrict__ ws, float* __restrict__ grad_w, int rows, int c) {
  __shared__ float part[kFinishRows][kFinishColumns + 1];
  const int q = blockIdx.x * kFinishColumns + threadIdx.x;
  const int cols = 27 * c;
  float s = 0.f;
  if (q < cols) {
    for (int r = threadIdx.y; r < rows; r += kFinishRows) {
      s = __fadd_rn(s, ws[static_cast<long>(r) * cols + q]);
    }
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && q < cols) {
    float total = part[0][threadIdx.x];
    for (int i = 1; i < kFinishRows; ++i) total = __fadd_rn(total, part[i][threadIdx.x]);
    const int tap = q / c, ch = q % c;
    grad_w[ch * 27 + tap] = __fadd_rn(grad_w[ch * 27 + tap], total);
  }
}

template <typename T, int CPT, bool ONE>
cudaError_t opt_in_smem() {
  static bool done = false;  // the attribute is set once per process and instance
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      dw_wgrad_tiles<T, CPT, ONE>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err == cudaSuccess) done = true;
  return err;
}

template <typename T, int CPT, bool ONE>
int launch(const void* x, const void* gz, float* ws, const Geometry& g, unsigned ctas,
           unsigned slices, int threads, int smem, cudaStream_t s) {
  const cudaError_t err = opt_in_smem<T, CPT, ONE>();
  if (err != cudaSuccess) return static_cast<int>(err);
  dw_wgrad_tiles<T, CPT, ONE><<<dim3(ctas, slices), threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gz), ws, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool ONE>
int launch_cpt(int cpt, const void* x, const void* gz, float* ws, const Geometry& g,
               unsigned ctas, unsigned slices, int threads, int smem, cudaStream_t s) {
  if (cpt == 4) return launch<T, 4, ONE>(x, gz, ws, g, ctas, slices, threads, smem, s);
  return launch<T, 1, ONE>(x, gz, ws, g, ctas, slices, threads, smem, s);
}

template <typename T>
int launch_x(int cpt, const void* x, const void* gz, float* ws, const Geometry& g,
             unsigned ctas, unsigned slices, int threads, int smem, cudaStream_t s) {
  if (g.cx == 1) return launch_cpt<T, true>(cpt, x, gz, ws, g, ctas, slices, threads, smem, s);
  return launch_cpt<T, false>(cpt, x, gz, ws, g, ctas, slices, threads, smem, s);
}

int out_size(int size, int s, int p) { return (size + 2 * p - 3) / s + 1; }

}  // namespace

extern "C" {

// Adds the 3x3x3 weight gradient of a conv whose groups have one input
// channel each, from x (n, d, h, w, cx) and gz (its output gradient, (n, od,
// oh, ow, c)), both in memory and of one dtype (0 float32, 1 bfloat16), to
// grad_w (c, 27) float32; cx is c (depthwise) or 1. Strides in {1, 2},
// paddings in {0, 1}. The tile (cs, tn, td, th, tw), `p` position workers,
// `threads` a CTA (whole warps), `ctas` CTAs a
// channel slice, `smem` bytes of dynamic shared memory and `vec` / `xvec`
// bytes a copy of gz / x come from kernels/dw_wgrad.py::plan_dw_wgrad; `ws`
// holds 27 * c float32 a CTA of a slice. gz and x are aligned to `vec` and
// `xvec` bytes. Launches two kernels on `stream` and does not synchronise.
// Returns a cudaError_t.
int msl_dw_wgrad(const void* x, const void* gz, void* grad_w, void* ws, int dtype, int n, int d,
                 int h, int w, int c, int cx, int sd, int sh, int sw, int pd, int ph, int pw,
                 int cs, int tn, int td, int th, int tw, int p, int threads, int ctas, int smem,
                 int vec, int xvec, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || d <= 0 || h <= 0 || w <= 0 || c <= 0 || (cx != c && cx != 1) ||
      (dtype != 0 && dtype != 1)) {
    return bad;
  }
  const int strides[] = {sd, sh, sw}, pads[] = {pd, ph, pw};
  for (int i = 0; i < 3; ++i) {
    if ((strides[i] != 1 && strides[i] != 2) || (pads[i] != 0 && pads[i] != 1)) return bad;
  }
  Geometry g{};
  g.n = n; g.d = d; g.h = h; g.w = w; g.c = c; g.cx = cx; g.xvec = xvec;
  g.od = out_size(d, sd, pd); g.oh = out_size(h, sh, ph); g.ow = out_size(w, sw, pw);
  g.sd = sd; g.sh = sh; g.sw = sw; g.pd = pd; g.ph = ph; g.pw = pw;
  g.cs = cs; g.tn = tn; g.td = td; g.th = th; g.tw = tw; g.p = p; g.vec = vec;
  const int e = dtype == 0 ? 4 : 2;
  if (g.od < 1 || g.oh < 1 || g.ow < 1 || cs < 1 || c % cs || tn < 1 || td < 1 || th < 1 ||
      tw < 1 || p < 1 || (vec != 2 && vec != 4 && vec != 8 && vec != 16) || vec < e ||
      (cs * e) % vec || (c * e) % vec || (cs * e) / vec > 32 || threads % 32 ||
      threads > kMaxThreads) {
    return bad;
  }
  const int xcs = cx == 1 ? 1 : cs;
  if ((xvec != 2 && xvec != 4 && xvec != 8 && xvec != 16) || xvec < e || (xcs * e) % xvec ||
      (cx * e) % xvec || (xcs * e) / xvec > 32) {
    return bad;
  }
  const int cpt = cs % 4 == 0 ? 4 : 1;
  if (3 * (cs / cpt) * p > threads) return bad;
  g.rd = sd * (td - 1) + 3; g.rh = sh * (th - 1) + 3; g.rw = sw * (tw - 1) + 3;
  g.ndt = (g.od + td - 1) / td; g.nht = (g.oh + th - 1) / th; g.nwt = (g.ow + tw - 1) / tw;
  const long tiles = static_cast<long>((n + tn - 1) / tn) * g.ndt * g.nht * g.nwt;
  if (tiles > 0x7fffffffL || ctas < 1 || ctas > tiles || c / cs > 65535) return bad;
  g.tiles = static_cast<int>(tiles);
  const long xs = static_cast<long>(tn) * g.rd * g.rh * g.rw * xcs * e;
  const long gs_offset = (xs + 15) / 16 * 16;
  const long buf = (gs_offset + static_cast<long>(tn) * td * th * tw * cs * e + 15) / 16 * 16;
  const long red = static_cast<long>(p) * 27 * cs * 4;
  const long bufs = (ctas < tiles ? 2 : 1) * buf;  // one CTA a tile needs one buffer
  const long need = bufs > red ? bufs : red;
  if (smem < need || smem > kSmemMax) return bad;
  g.gs_offset = static_cast<int>(gs_offset);
  g.buf_bytes = static_cast<int>(buf);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  const int err = dtype == 0
      ? launch_x<float>(cpt, x, gz, wsf, g, ctas, c / cs, threads, smem, s)
      : launch_x<__nv_bfloat16>(cpt, x, gz, wsf, g, ctas, c / cs, threads, smem, s);
  if (err != 0) return err;
  const unsigned blocks = (27 * c + kFinishColumns - 1) / kFinishColumns;
  dw_wgrad_finish<<<blocks, dim3(kFinishColumns, kFinishRows), 0, s>>>(
      wsf, static_cast<float*>(grad_w), ctas, c);
  return static_cast<int>(cudaGetLastError());
}

const char* msl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
