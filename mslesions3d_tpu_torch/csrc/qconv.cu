// int8 3D convolution with int32 accumulation and a fused epilogue for
// Hopper (sm_90a): kernel Q1 of the port.
//
// Q1 is not a TPU kernel. It replaces the int8 convs of
// mslesions3d_tpu/quant.py::_qconv (:212-220), which XLA runs as
// conv_general_dilated on int8 operands with preferred_element_type=int32;
// torch on CUDA has no int8 conv3d. Same function: for q (B, D, H, W, Cin)
// int8 and weights (k, k, k, Cin / groups, Cout) int8, zero padding k / 2,
//   acc[n, o, oc] = sum over the taps and the group's input channels of q * w (int32),
//   y = relu?(float(acc) * scale[oc] + bias[oc])                          (float32),
// out (B, Do, Ho, Wo, Cout). The epilogue writes one of four forms (Mode):
// the int32 sums; y; the next convs' int8 codes clamp(rint(y / sx), -127,
// 127) for one or two scales sx (quant.py's requantize, fused: the next conv
// of the backbone and, at an emitted layer, the heads); or y split by column
// into two tensors (the loc and cls heads of a feature layer, one launch).
// The stem may read the caller's float32 or bf16 image and quantize it as it
// loads (conversion to float32 is exact), which removes the first requantize.
// The integer sums are exact in any order (the wrapper asserts from the
// shapes that they stay below 2^31); y rounds twice with round-to-nearest
// intrinsics (the build also passes -fmad=false) and the codes divide with
// __fdiv_rn and round half to even (rintf), as the plain version's
// `acc.float() * scale + bias` and torch.round(y / sx) do, so the two agree
// bit for bit on finite values.
//
// What bounds it on this card: bytes. One int8 forward of the 96^3 model at
// batch 8 needs ~5e9 int8 operations (~0.003 ms at the tensor cores' int8
// rate) against ~128 MB of operands and outputs (~0.04 ms at 3.35 TB/s) once
// each conv writes the int8 codes its consumer reads. The first version ran
// one thread an output element on the CUDA cores with every operand from
// global memory and wrote float32 that a separate requantize read back. The
// design, variant by variant (kernels/qconv.py::plan_qconv picks one):
//  - igemm (dense convs with Cin % 16 == 0: the pointwise convs and the
//    heads): an implicit GEMM on the tensor cores, M = output voxels, N =
//    Cout, K = taps x Cin, in k-steps of 32 bytes through
//    mma.sync.m16n8k32.s8.s8.s32. A CTA owns a BM x BN tile; its A rows
//    (each output voxel's tap, a 16-byte chunk of channels at a time) and B
//    rows (the packed weights (Cout, k, k, k, Cin)) stream into shared
//    memory with cp.async, zero-filled for padded taps, ragged rows and the
//    K tail, through a ring of stages. Where M is small (the deep layers,
//    the heads at layers 5 and 7) the warps of a CTA split K and their sums
//    add in shared memory in a fixed order. The sums are staged in shared
//    memory and written as 16-byte vectors;
//  - stem (Cin = 1, 3^3): the 27 taps of a voxel, padded with 5 zeros, are
//    exactly one k-step. A CTA quantizes its input patch into shared memory
//    once; each warp gathers its A fragments from the patch and keeps the
//    weights' B fragments in registers for the whole CTA;
//  - depthwise (groups = Cin = Cout, 3^3, Cin % 4 == 0): no sum runs across
//    channels, so it stays on the CUDA cores. A CTA's input patch (a slab
//    of depths, a band of rows, all columns, a slice of channels, with its
//    zero halo) goes into shared memory with cp.async; each thread owns a
//    char4 of channels with its 27 weight words in registers and sums 4
//    outputs along W from a register window of each (kd, kh) row, one
//    __dp4a a channel and tap (the weight word masked to one byte);
//  - direct: the first version, for every other shape (Cin % 16 != 0 and
//    not a stem, a depthwise Cin % 4 != 0, a 1^3 depthwise).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum Mode { kSums = 0, kFloat = 1, kCodes = 2, kHeads = 3 };
enum Variant { kDirect = 0, kIgemm = 1, kStem = 2, kDepthwise = 3 };

constexpr int kThreads = 256;        // direct kernels
constexpr int kStemThreads = 128;    // stem: four warps
constexpr int kDwThreads = 256;      // depthwise: at most
constexpr int kRun = 4;              // depthwise: outputs along W a thread sums at once
constexpr int kSmemDefault = 49152;  // above it a kernel must opt in
constexpr int kSmemMax = 232448;     // a Hopper block's opt-in maximum

struct Conv {
  int b, d, h, w, cin;     // input
  int od, oh, ow, cout;    // output
  int k, sd, sh, sw, pad;  // kernel side, strides, padding
  long long m;             // output voxels: the GEMM's rows
};

struct Epilogue {
  const float* scale;
  const float* bias;
  const float* sx;  // kCodes: the codes' scales sx[0] (and sx[1])
  void* out0;
  void* out1;       // kCodes: the second codes; kHeads: columns split .. cout - 1
  int mode, ncodes, split, relu;
  int vec;          // outputs may be written as 16-byte vectors (see msl_qconv)
};

// ---------------------------------------------------------------- epilogue
__device__ __forceinline__ float affine(int acc, float s, float b, int relu) {
  const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
  return relu ? (y > 0.0f ? y : 0.0f) : y;
}

// clamp(rint(y / sx), -127, 127), round half to even as torch.round, with
// y / sx the correctly rounded quotient. rcp = __frcp_rn(sx): y * rcp lies
// within 4e-5 of y / sx wherever |y / sx| <= 128, so it rounds to the same
// integer unless it lies within 1e-3 of a half-integer, and there the
// quotient is computed exactly (__fdiv_rn). Past 128 both clamp to 127.
__device__ __forceinline__ int code(float y, float sx, float rcp) {
  float q = __fmul_rn(y, rcp);
  if (fabsf(q - floorf(q) - 0.5f) < 1e-3f) q = __fdiv_rn(y, sx);
  return static_cast<int>(fminf(fmaxf(rintf(q), -127.0f), 127.0f));
}

template <typename T>
struct Input;

template <>
struct Input<int8_t> {
  static __device__ __forceinline__ int q(int8_t v, float, float) { return v; }
};

template <>
struct Input<float> {
  static __device__ __forceinline__ int q(float v, float sx, float rcp) {
    return code(v, sx, rcp);
  }
};

template <>
struct Input<__nv_bfloat16> {
  static __device__ __forceinline__ int q(__nv_bfloat16 v, float sx, float rcp) {
    return code(__bfloat162float(v), sx, rcp);
  }
};

// The epilogue's constants for output columns n .. n + V - 1, loaded once
// by a thread whose columns stay fixed (columns past cout read as 0).
template <int V>
struct Columns {
  float s[V], b[V], sx0, sx1, rcp0, rcp1;

  __device__ __forceinline__ void load(const Epilogue& ep, int n, int cout) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const bool in = ep.mode != kSums && n + v < cout;
      s[v] = in ? ep.scale[n + v] : 0.0f;
      b[v] = in ? ep.bias[n + v] : 0.0f;
    }
    sx0 = ep.mode == kCodes ? ep.sx[0] : 1.0f;
    sx1 = ep.mode == kCodes && ep.ncodes == 2 ? ep.sx[1] : 1.0f;
    rcp0 = __frcp_rn(sx0);
    rcp1 = __frcp_rn(sx1);
  }
};

// Output element (row m, column n = n0 + v) of (M, cout), one store.
template <int V>
__device__ __forceinline__ void store_one(const Epilogue& ep, const Columns<V>& col, int v,
                                          long long m, int n, int cout, int acc) {
  const long long i = m * cout + n;
  if (ep.mode == kSums) {
    static_cast<int*>(ep.out0)[i] = acc;
    return;
  }
  const float y = affine(acc, col.s[v], col.b[v], ep.relu);
  if (ep.mode == kFloat) {
    static_cast<float*>(ep.out0)[i] = y;
  } else if (ep.mode == kCodes) {
    static_cast<int8_t*>(ep.out0)[i] = static_cast<int8_t>(code(y, col.sx0, col.rcp0));
    if (ep.ncodes == 2) {
      static_cast<int8_t*>(ep.out1)[i] = static_cast<int8_t>(code(y, col.sx1, col.rcp1));
    }
  } else if (n < ep.split) {
    static_cast<float*>(ep.out0)[m * ep.split + n] = y;
  } else {
    static_cast<float*>(ep.out1)[m * (cout - ep.split) + (n - ep.split)] = y;
  }
}

template <int N>
__device__ __forceinline__ void put_words(int8_t* p, const unsigned (&v)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
    static_assert(N == 1, "16 or 4 codes");
    *reinterpret_cast<unsigned*>(p) = v[0];
  }
}

template <int V>
__device__ __forceinline__ void codes_of(const float (&y)[V], float sx, float rcp,
                                         unsigned (&w)[V / 4]) {
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
    w[q] = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      w[q] |= (static_cast<unsigned>(code(y[4 * q + e], sx, rcp)) & 0xffu) << (8 * e);
    }
  }
}

// Columns n .. n + V - 1 of row m in one store each output: V = 16 codes
// (16 bytes) or V = 4 elements of any mode (codes: 4 bytes; else 16 bytes).
template <int V>
__device__ __forceinline__ void store_vec(const Epilogue& ep, const Columns<V>& col, long long m,
                                          int n, int cout, const int (&a)[V]) {
  const long long i = m * cout + n;
  if (ep.mode == kSums) {
    if constexpr (V == 4) {
      *reinterpret_cast<int4*>(static_cast<int*>(ep.out0) + i) = make_int4(a[0], a[1], a[2], a[3]);
    }
    return;
  }
  float y[V];
#pragma unroll
  for (int v = 0; v < V; ++v) y[v] = affine(a[v], col.s[v], col.b[v], ep.relu);
  if (ep.mode == kCodes) {
    unsigned w[V / 4];
    codes_of(y, col.sx0, col.rcp0, w);
    put_words<V / 4>(static_cast<int8_t*>(ep.out0) + i, w);
    if (ep.ncodes == 2) {
      codes_of(y, col.sx1, col.rcp1, w);
      put_words<V / 4>(static_cast<int8_t*>(ep.out1) + i, w);
    }
    return;
  }
  if constexpr (V == 4) {
    float* dst = ep.mode == kFloat ? static_cast<float*>(ep.out0) + i
                 : n < ep.split    ? static_cast<float*>(ep.out0) + m * ep.split + n
                                   : static_cast<float*>(ep.out1) + m * (cout - ep.split) +
                                      (n - ep.split);
    *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
  }
}

// A tile's staged sums (WK slices of `slice` rows x ROW int32s, added in
// slice order) through the epilogue, V columns a thread at a time. The
// block's size is a multiple of BN / V, so a thread's columns stay fixed.
// row_of(r) is the output row of tile row r, or -1 where it has none.
template <int V, int BN, int WK, int ROW, class RowOf>
__device__ __forceinline__ void store_chunks(const int* sums, int rows, int slice, int n0,
                                             int cout, const Epilogue& ep, RowOf row_of) {
  constexpr int CPR = BN / V;
  const int c = (threadIdx.x % CPR) * V, n = n0 + c;
  if (n >= cout) return;
  Columns<V> col;
  col.load(ep, n, cout);
  for (int r = threadIdx.x / CPR; r < rows; r += blockDim.x / CPR) {
    const long long m = row_of(r);
    if (m < 0) continue;
    int a[V];
    if constexpr (V == 1) {
      int s = 0;
#pragma unroll
      for (int k = 0; k < WK; ++k) s += sums[(k * slice + r) * ROW + c];
      store_one(ep, col, 0, m, n, cout, s);
    } else {  // 16-byte reads: 2-way bank conflicts at most (ROW = BN + 8)
#pragma unroll
      for (int v = 0; v < V; v += 4) {
        int4 s = make_int4(0, 0, 0, 0);
#pragma unroll
        for (int k = 0; k < WK; ++k) {
          const int4 t = *reinterpret_cast<const int4*>(sums + (k * slice + r) * ROW + c + v);
          s.x += t.x;
          s.y += t.y;
          s.z += t.z;
          s.w += t.w;
        }
        a[v] = s.x;
        a[v + 1] = s.y;
        a[v + 2] = s.z;
        a[v + 3] = s.w;
      }
      store_vec<V>(ep, col, m, n, cout, a);
    }
  }
}

template <int BN, int WK, int ROW, class RowOf>
__device__ __forceinline__ void store_tile(const int* sums, int rows, int slice, int n0, int cout,
                                           const Epilogue& ep, RowOf row_of) {
  if (ep.vec && ep.mode == kCodes && BN % 16 == 0) {
    store_chunks<16, BN, WK, ROW>(sums, rows, slice, n0, cout, ep, row_of);
  } else if (ep.vec && ep.mode != kCodes && BN % 4 == 0) {
    store_chunks<4, BN, WK, ROW>(sums, rows, slice, n0, cout, ep, row_of);
  } else {
    store_chunks<1, BN, WK, ROW>(sums, rows, slice, n0, cout, ep, row_of);
  }
}

// ---------------------------------------------------------------- copies and the tensor cores
// 16 (or 4) bytes from global to shared memory; zeros where !valid (src-size 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += a (16 x 32, row) x b (32 x 8, col), int8 in, int32 sums
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two fragments' sums (rows g and g + 8 of an m16n8 tile, columns 2t, 2t + 1) into
// the staged sums at `p`, the row g, column 2t position.
__device__ __forceinline__ void stage_sums(int* p, int row_stride, const int (&c)[4]) {
  *reinterpret_cast<int2*>(p) = make_int2(c[0], c[1]);
  *reinterpret_cast<int2*>(p + 8 * row_stride) = make_int2(c[2], c[3]);
}

// ---------------------------------------------------------------- igemm
// A CTA tile: BM rows x BN columns; WM x WN warps tile it, WK warps split each
// stage's KC bytes of K (k-step s to warp s % WK), STAGES stages in flight.
// kernels/qconv.py's IGEMM_TILES lists the same tiles, in this order.
template <int BM_, int BN_, int WM_, int WN_, int WK_, int KC_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, WK = WK_, KC = KC_;
  static constexpr int STAGES = STAGES_;
  static constexpr int kThreads = 32 * WM * WN * WK;
  static constexpr int MT = BM / WM / 16, NT = BN / WN / 8;  // a warp's m16 and n8 tiles
  static constexpr int kRow = KC + 16;  // bytes between a stage's rows: conflict-free fragments
  static constexpr int kStage = (BM + BN) * kRow;
  static constexpr int kAccRow = BN + 8;  // int32s between the staged sums' rows
  static constexpr int kPipe = STAGES * kStage;
  static constexpr int kSums = WK * BM * kAccRow * 4;
  static constexpr int kSmem = kPipe > kSums ? kPipe : kSums;
  static_assert(MT >= 1 && NT >= 1 && BM == WM * MT * 16 && BN == WN * NT * 8, "warp tiling");
  static_assert((KC / 32) % WK == 0 && KC % 32 == 0 && STAGES >= 2, "k split");
  static_assert(kThreads % (KC / 16) == 0, "copy assignment");
};

using Tile0 = Tile<128, 64, 4, 2, 1, 64, 3>;  // large M, wide N
using Tile1 = Tile<64, 64, 2, 2, 1, 64, 3>;
using Tile2 = Tile<32, 64, 1, 2, 4, 128, 3>;  // small M: four warps split K
using Tile3 = Tile<64, 16, 2, 1, 4, 128, 3>;  // the heads (N = 16), large M
using Tile4 = Tile<16, 16, 1, 1, 8, 512, 3>;  // the heads, small M: eight warps split K

template <class TL>
__global__ void __launch_bounds__(TL::kThreads)
qconv_igemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, const Conv g,
                   const Epilogue ep) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int BM = TL::BM, BN = TL::BN, KC = TL::KC, STAGES = TL::STAGES;
  constexpr int CPR = KC / 16, RSTEP = TL::kThreads / CPR;  // 16-byte chunks a row, rows a pass
  constexpr int AREPS = (BM + RSTEP - 1) / RSTEP, BREPS = (BN + RSTEP - 1) / RSTEP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % TL::WM, wn = (warp / TL::WM) % TL::WN, wk = warp / (TL::WM * TL::WN);
  const int gq = lane >> 2, tq = lane & 3;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int K = g.k * g.k * g.k * g.cin;
  const int ktiles = (K + KC - 1) / KC;

  // this thread copies chunk j of rows r0, r0 + RSTEP, ... of A and of B;
  // for each A row, its sample's first voxel and its tap (0, 0, 0) position
  const int j = tid % CPR, r0 = tid / CPR;
  long long abase[AREPS];
  int az[AREPS], ay[AREPS], ax[AREPS];
#pragma unroll
  for (int i = 0; i < AREPS; ++i) {
    const int r = r0 + i * RSTEP;
    const long long m = m0 + r;
    abase[i] = 0;
    az[i] = ay[i] = ax[i] = -(1 << 29);  // no tap of a missing row is inside the volume
    if (r < BM && m < g.m) {
      long long v = m;
      const int ox = static_cast<int>(v % g.ow);
      v /= g.ow;
      const int oy = static_cast<int>(v % g.oh);
      v /= g.oh;
      const int oz = static_cast<int>(v % g.od);
      abase[i] = (v / g.od) * g.d * g.h * g.w;
      az[i] = oz * g.sd - g.pad;
      ay[i] = oy * g.sh - g.pad;
      ax[i] = ox * g.sw - g.pad;
    }
  }

  auto load = [&](int kt, int s) {
    unsigned char* as = smem + s * TL::kStage;
    unsigned char* bs = as + BM * TL::kRow;
    const int kk = kt * KC + j * 16;  // Cin % 16 == 0: a chunk never crosses a tap
    const bool kin = kk < K;
    const int tap = kin ? kk / g.cin : 0;
    const int c = kk - tap * g.cin;
    const int kd = tap / (g.k * g.k), kh = (tap / g.k) % g.k, kw = tap % g.k;
#pragma unroll
    for (int i = 0; i < AREPS; ++i) {
      const int r = r0 + i * RSTEP;
      if (r < BM) {
        const int iz = az[i] + kd, iy = ay[i] + kh, ix = ax[i] + kw;
        const bool ok = kin && static_cast<unsigned>(iz) < static_cast<unsigned>(g.d) &&
                        static_cast<unsigned>(iy) < static_cast<unsigned>(g.h) &&
                        static_cast<unsigned>(ix) < static_cast<unsigned>(g.w);
        const int8_t* src =
            ok ? x + (abase[i] + (static_cast<long long>(iz) * g.h + iy) * g.w + ix) * g.cin + c
               : x;
        cp_async16(as + r * TL::kRow + j * 16, src, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < BREPS; ++i) {
      const int r = r0 + i * RSTEP;
      if (r < BN) {
        const bool ok = kin && n0 + r < g.cout;
        const int8_t* src = ok ? w + static_cast<long long>(n0 + r) * K + kk : w;
        cp_async16(bs + r * TL::kRow + j * 16, src, ok);
      }
    }
  };

  int acc[TL::MT][TL::NT][4];
#pragma unroll
  for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < TL::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // stage kt has landed
    __syncthreads();              // ... for every thread, and stage kt - 1 is consumed
    const int nk = kt + STAGES - 1;
    if (nk < ktiles) load(nk, nk % STAGES);
    cp_async_commit();
    const unsigned char* as = smem + (kt % STAGES) * TL::kStage;
    const unsigned char* bs = as + BM * TL::kRow;
#pragma unroll
    for (int ks = 0; ks < KC / 32; ++ks) {
      if (ks % TL::WK != wk) continue;
      unsigned a[TL::MT][4], b[TL::NT][2];
#pragma unroll
      for (int mt = 0; mt < TL::MT; ++mt) {
        const unsigned char* p =
            as + (wm * TL::MT * 16 + mt * 16 + gq) * TL::kRow + ks * 32 + tq * 4;
        a[mt][0] = *reinterpret_cast<const unsigned*>(p);
        a[mt][1] = *reinterpret_cast<const unsigned*>(p + 8 * TL::kRow);
        a[mt][2] = *reinterpret_cast<const unsigned*>(p + 16);
        a[mt][3] = *reinterpret_cast<const unsigned*>(p + 8 * TL::kRow + 16);
      }
#pragma unroll
      for (int nt = 0; nt < TL::NT; ++nt) {
        const unsigned char* p =
            bs + (wn * TL::NT * 8 + nt * 8 + gq) * TL::kRow + ks * 32 + tq * 4;
        b[nt][0] = *reinterpret_cast<const unsigned*>(p);
        b[nt][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < TL::NT; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the sums take its place

  int* sums = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < TL::NT; ++nt) {
      const int row = wm * TL::MT * 16 + mt * 16 + gq, col = wn * TL::NT * 8 + nt * 8 + 2 * tq;
      stage_sums(sums + (wk * BM + row) * TL::kAccRow + col, TL::kAccRow, acc[mt][nt]);
    }
  __syncthreads();
  const long long M = g.m;
  store_tile<BN, TL::WK, TL::kAccRow>(sums, BM, BM, n0, g.cout, ep, [m0, M](int r) -> long long {
    return m0 + r < M ? m0 + r : -1;
  });
}

// ---------------------------------------------------------------- stem
struct StemTile {
  int tz, ty, tx;  // output depths, rows and columns a CTA
  int nz, ny, nx;  // CTAs along each axis
  int pz, py, px;  // the input patch: (t - 1) * stride + 3 along each axis
  int vec_in;      // the image's rows (and x) are 16-byte aligned: vector copies
};

template <typename T, int NT>
__global__ void __launch_bounds__(kStemThreads)
qconv_stem_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ sx_in, const Conv g, const Epilogue ep,
                  const StemTile t) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int BN = NT * 8, ROW = BN + 8;
  int r = blockIdx.x;
  const int bx = r % t.nx;
  r /= t.nx;
  const int by = r % t.ny;
  r /= t.ny;
  const int bz = r % t.nz;
  const int n = r / t.nz;
  const int oz0 = bz * t.tz, oy0 = by * t.ty, ox0 = bx * t.tx;
  const int iz0 = oz0 * g.sd - g.pad, iy0 = oy0 * g.sh - g.pad, ix0 = ox0 * g.sw - g.pad;
  const int rows = t.tz * t.ty * t.tx, mtiles = (rows + 15) / 16;
  const int npatch = t.pz * t.py * t.px;
  // shared memory: the patch; per tile row its output row (or -1) and its
  // patch offset, computed once; the staged sums
  int8_t* patch = reinterpret_cast<int8_t*>(smem);
  long long* row_m = reinterpret_cast<long long*>(smem + ((npatch + 15) & ~15));
  int* row_at = reinterpret_cast<int*>(row_m + mtiles * 16);
  int* sums = row_at + mtiles * 16;
  for (int r = threadIdx.x; r < mtiles * 16; r += blockDim.x) {
    long long m = -1;
    int at = 0;
    if (r < rows) {
      const int lz = r / (t.ty * t.tx), ly = (r / t.tx) % t.ty, lx = r % t.tx;
      const int oz = oz0 + lz, oy = oy0 + ly, ox = ox0 + lx;
      at = (lz * g.sd * t.py + ly * g.sh) * t.px + lx * g.sw;
      if (oz < g.od && oy < g.oh && ox < g.ow) {
        m = ((static_cast<long long>(n) * g.od + oz) * g.oh + oy) * g.ow + ox;
      }
    }
    row_m[r] = m;
    row_at[r] = at;
  }

  // 1. the input patch, quantized (or copied: int8 codes), zeros outside the
  //    volume. Where the image's rows are 16-byte aligned, a row of the
  //    patch is copied as 16-byte vectors of the image row, four in flight
  //    a thread, over zeros written first.
  const float s_in = sx_in != nullptr ? *sx_in : 1.0f, r_in = __frcp_rn(s_in);
  const long long plane = static_cast<long long>(g.h) * g.w;
  const T* xs = x + static_cast<long long>(n) * g.d * plane;
  if (t.vec_in) {
    constexpr int E = 16 / sizeof(T);  // elements a vector
    for (int i = threadIdx.x; i < (npatch + 15) / 16; i += blockDim.x) {
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
    const int xa = max(ix0, 0), xb = min(ix0 + t.px, g.w);  // the columns inside the image
    const int c0 = xa / E, nch = xb > xa ? (xb + E - 1) / E - c0 : 0;
    const int total = t.pz * t.py * nch;
    for (int i0 = threadIdx.x; i0 < total; i0 += 4 * blockDim.x) {
      uint4 v[4];
      int at[4], col[4];  // patch offset of the vector's first element, its first column
      bool ok[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * blockDim.x;
        ok[u] = false;
        if (i < total) {
          const int r = i / nch, c = c0 + i - r * nch;
          const int pz = r / t.py, py = r - pz * t.py;
          const int iz = iz0 + pz, iy = iy0 + py;
          if (static_cast<unsigned>(iz) < static_cast<unsigned>(g.d) &&
              static_cast<unsigned>(iy) < static_cast<unsigned>(g.h)) {
            v[u] = __ldg(reinterpret_cast<const uint4*>(
                xs + iz * plane + static_cast<long long>(iy) * g.w + c * E));
            at[u] = r * t.px + c * E - ix0;  // < 0 where the vector starts left of the patch
            col[u] = c * E;
            ok[u] = true;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (!ok[u]) continue;
        const T* e = reinterpret_cast<const T*>(&v[u]);
#pragma unroll
        for (int k = 0; k < E; ++k) {
          if (col[u] + k >= xa && col[u] + k < xb) {
            patch[at[u] + k] = static_cast<int8_t>(Input<T>::q(e[k], s_in, r_in));
          }
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < npatch; i += blockDim.x) {
      const int px = i % t.px, rest = i / t.px;
      const int py = rest % t.py, pz = rest / t.py;
      const int iz = iz0 + pz, iy = iy0 + py, ix = ix0 + px;
      int v = 0;
      if (static_cast<unsigned>(iz) < static_cast<unsigned>(g.d) &&
          static_cast<unsigned>(iy) < static_cast<unsigned>(g.h) &&
          static_cast<unsigned>(ix) < static_cast<unsigned>(g.w)) {
        v = Input<T>::q(xs[iz * plane + static_cast<long long>(iy) * g.w + ix], s_in, r_in);
      }
      patch[i] = static_cast<int8_t>(v);
    }
  }

  // 2. B fragments of the weights (Cout, 27): taps 27-31 and columns >= Cout are 0
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gq = lane >> 2, tq = lane & 3;
  unsigned b[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int oc = nt * 8 + gq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      unsigned word = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tap = half * 16 + tq * 4 + e;
        if (oc < g.cout && tap < 27) {
          word |= static_cast<unsigned>(static_cast<uint8_t>(w[oc * 27 + tap])) << (8 * e);
        }
      }
      b[nt][half] = word;
    }
  }
  // this thread's taps of an A row: tq*4 + e and 16 + tq*4 + e, as patch offsets
  int off[2][4];
  bool live[2][4];
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tap = half * 16 + tq * 4 + e;
      live[half][e] = tap < 27;
      off[half][e] = ((tap / 9) * t.py + (tap / 3) % 3) * t.px + tap % 3;
    }
  __syncthreads();

  // 3. each warp an m16 tile at a time: gather A from the patch, one k-step
  for (int mt = warp; mt < mtiles; mt += kStemThreads / 32) {
    unsigned a[4];
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {  // rows g and g + 8
      const int base = row_at[mt * 16 + gq + 8 * h8];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        unsigned word = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (live[half][e]) {
            word |= static_cast<unsigned>(static_cast<uint8_t>(patch[base + off[half][e]]))
                    << (8 * e);
          }
        }
        a[h8 + 2 * half] = word;
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      int c[4] = {0, 0, 0, 0};
      mma_s8(c, a, b[nt]);
      stage_sums(sums + (mt * 16 + gq) * ROW + nt * 8 + 2 * tq, ROW, c);
    }
  }
  __syncthreads();

  store_tile<BN, 1, ROW>(sums, mtiles * 16, 0, 0, g.cout, ep,
                         [row_m](int row) -> long long { return row_m[row]; });
}

// ---------------------------------------------------------------- depthwise
struct DwTile {
  int tz, ty, cs, walkers;  // output depths, rows, channels a CTA; walkers of cs / 4 threads
  int nz, ny, ns;           // CTAs along depth, rows, channel slices
  int pz, py, px;           // the input patch (px: all columns of kRun-output runs, padded)
  int runs, vec;            // runs of kRun outputs a row; bytes per cp.async copy
};

template <int SW>
__global__ void __launch_bounds__(kDwThreads)
qconv_dw_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, const Conv g,
                const Epilogue ep, const DwTile t) {
  extern __shared__ __align__(16) unsigned char smem[];
  int r = blockIdx.x;
  const int slice = r % t.ns;
  r /= t.ns;
  const int by = r % t.ny;
  r /= t.ny;
  const int bz = r % t.nz;
  const int n = r / t.nz;
  const int c0 = slice * t.cs, csv = min(t.cs, g.cin - c0);
  const int oz0 = bz * t.tz, oy0 = by * t.ty;
  const int iz0 = oz0 * g.sd - 1, iy0 = oy0 * g.sh - 1;

  // 1. the patch: voxels of cs bytes (the slice's csv channels), zeros
  //    outside; a group of up to 32 threads takes a (depth, row) of the
  //    patch at a time, its lanes that row's copies
  const int nch = csv / t.vec, row_copies = t.px * nch;
  const int group = min(32, static_cast<int>(blockDim.x)), groups = blockDim.x / group;
  const int lane = threadIdx.x % group;
  const long long vox0 = static_cast<long long>(n) * g.d * g.h * g.w;
  for (int r = threadIdx.x / group; r < t.pz * t.py && threadIdx.x < groups * group;
       r += groups) {
    const int pz = r / t.py, py = r - pz * t.py;
    const int iz = iz0 + pz, iy = iy0 + py;
    const bool row_ok = static_cast<unsigned>(iz) < static_cast<unsigned>(g.d) &&
                        static_cast<unsigned>(iy) < static_cast<unsigned>(g.h);
    const int8_t* src_row =
        x + (vox0 + (static_cast<long long>(iz) * g.h + iy) * g.w) * g.cin + c0;
    unsigned char* dst_row = smem + static_cast<long long>(r) * t.px * t.cs;
    for (int j = lane; j < row_copies; j += group) {
      const int px = j / nch, q = j - px * nch, ix = px - 1;
      const bool ok = row_ok && static_cast<unsigned>(ix) < static_cast<unsigned>(g.w);
      const int8_t* src = ok ? src_row + static_cast<long long>(ix) * g.cin + q * t.vec : x;
      unsigned char* dst = dst_row + px * t.cs + q * t.vec;
      if (t.vec == 16) {
        cp_async16(dst, src, ok);
      } else {
        cp_async4(dst, src, ok);
      }
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 2. this thread's channel quad: 27 weight words; its items are runs of
  //    kRun outputs along W
  const int quads = t.cs / 4, quad = threadIdx.x % quads, walker = threadIdx.x / quads;
  if (walker >= t.walkers || 4 * quad >= csv) return;
  const int c = c0 + 4 * quad;
  unsigned wt[27];
#pragma unroll
  for (int tap = 0; tap < 27; ++tap) {
    wt[tap] = *reinterpret_cast<const unsigned*>(w + static_cast<long long>(tap) * g.cin + c);
  }
  Columns<4> col;
  col.load(ep, c, g.cout);
  const unsigned* tile = reinterpret_cast<const unsigned*>(smem) + quad;
  const int vs = t.cs / 4;  // words between the patch's voxels
  constexpr int NW = (kRun - 1) * SW + 3;
  const int items = t.tz * t.ty * t.runs;
  for (int it = walker; it < items; it += t.walkers) {
    const int xr = it % t.runs, rest = it / t.runs;
    const int ly = rest % t.ty, lz = rest / t.ty;
    const int oz = oz0 + lz, oy = oy0 + ly;
    if (oz >= g.od || oy >= g.oh) continue;
    int acc[kRun][4];
#pragma unroll
    for (int rr = 0; rr < kRun; ++rr)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[rr][e] = 0;
#pragma unroll
    for (int kd = 0; kd < 3; ++kd)
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        const int row = ((lz * g.sd + kd) * t.py + ly * g.sh + kh) * t.px + xr * kRun * SW;
        unsigned win[NW];  // the register window: this (kd, kh) row's columns of the run
#pragma unroll
        for (int jj = 0; jj < NW; ++jj) win[jj] = tile[(row + jj) * vs];
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const unsigned wv = wt[(kd * 3 + kh) * 3 + kw];
          const int m0 = static_cast<int>(wv & 0xffu), m1 = static_cast<int>(wv & 0xff00u);
          const int m2 = static_cast<int>(wv & 0xff0000u), m3 = static_cast<int>(wv & 0xff000000u);
#pragma unroll
          for (int rr = 0; rr < kRun; ++rr) {
            const int v = static_cast<int>(win[rr * SW + kw]);
            acc[rr][0] = __dp4a(v, m0, acc[rr][0]);
            acc[rr][1] = __dp4a(v, m1, acc[rr][1]);
            acc[rr][2] = __dp4a(v, m2, acc[rr][2]);
            acc[rr][3] = __dp4a(v, m3, acc[rr][3]);
          }
        }
      }
    const long long row0 = ((static_cast<long long>(n) * g.od + oz) * g.oh + oy) * g.ow;
#pragma unroll
    for (int rr = 0; rr < kRun; ++rr) {
      const int ox = xr * kRun + rr;
      if (ox < g.ow) store_vec<4>(ep, col, row0 + ox, c, g.cout, acc[rr]);
    }
  }
}

// ---------------------------------------------------------------- direct (the first version)
// Output element `idx` (n, od, oh, ow, c) of (B, Do, Ho, Wo, C), C fastest.
__device__ __forceinline__ void unravel(long long idx, int c_dim, const Conv& g, int& n, int& z,
                                        int& y, int& x, int& c) {
  c = static_cast<int>(idx % c_dim);
  long long v = idx / c_dim;
  x = static_cast<int>(v % g.ow);
  v /= g.ow;
  y = static_cast<int>(v % g.oh);
  v /= g.oh;
  z = static_cast<int>(v % g.od);
  n = static_cast<int>(v / g.od);
}

// w: (Cout, k, k, k, Cin). QUAD (int8 only): Cin % 4 == 0 and both pointers 4-byte aligned.
template <typename T, bool QUAD>
__global__ void __launch_bounds__(kThreads)
qconv_dense_kernel(const T* __restrict__ q, const int8_t* __restrict__ w,
                   const float* __restrict__ sx_in, const Conv g, long long total,
                   const Epilogue ep) {
  long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  int n, oz, oy, ox, oc;
  unravel(idx, g.cout, g, n, oz, oy, ox, oc);
  const float s_in = sx_in != nullptr ? *sx_in : 1.0f, r_in = __frcp_rn(s_in);
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
        const T* xp = q + (((static_cast<long long>(n) * g.d + iz) * g.h + iy) * g.w + ix) * g.cin;
        const int8_t* wp =
            w + (((static_cast<long long>(oc) * g.k + kd) * g.k + kh) * g.k + kw) * g.cin;
        if constexpr (QUAD) {
          const int* xq = reinterpret_cast<const int*>(xp);
          const int* wq = reinterpret_cast<const int*>(wp);
          for (int c = 0; c < g.cin / 4; ++c) acc = __dp4a(xq[c], wq[c], acc);
        } else {
          for (int c = 0; c < g.cin; ++c) acc += Input<T>::q(xp[c], s_in, r_in) * static_cast<int>(wp[c]);
        }
      }
    }
  }
  Columns<1> col;
  col.load(ep, oc, g.cout);
  store_one(ep, col, 0, idx / g.cout, oc, g.cout, acc);
}

// w: (k, k, k, C): the DHWIO weights of a depthwise conv (I = 1), as they are.
__global__ void __launch_bounds__(kThreads)
qconv_depthwise_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ w, const Conv g,
                       long long total, const Epilogue ep) {
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
  Columns<1> col;
  col.load(ep, c, g.cout);
  store_one(ep, col, 0, idx / g.cout, c, g.cout, acc);
}

// ---------------------------------------------------------------- launches
template <class K>
cudaError_t opt_in(K kernel, int smem) {
  if (smem <= kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <class TL>
int launch_igemm(const void* x, const void* w, const Conv& g, const Epilogue& ep, int threads,
                 int smem, cudaStream_t s) {
  if (threads != TL::kThreads || smem < TL::kSmem || smem > kSmemMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long gx = (g.m + TL::BM - 1) / TL::BM;
  const int gy = (g.cout + TL::BN - 1) / TL::BN;
  if (gx > 0x7fffffffLL || gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = opt_in(qconv_igemm_kernel<TL>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  qconv_igemm_kernel<TL><<<dim3(static_cast<unsigned>(gx), gy), TL::kThreads, smem, s>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), g, ep);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NT>
int launch_stem_nt(const void* x, const void* w, const void* sx_in, const Conv& g,
                   const Epilogue& ep, const StemTile& t, long long grid, int smem,
                   cudaStream_t s) {
  const cudaError_t err = opt_in(qconv_stem_kernel<T, NT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  qconv_stem_kernel<T, NT><<<static_cast<unsigned>(grid), kStemThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(sx_in),
      g, ep, t);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_stem(const void* x, const void* w, const void* sx_in, const Conv& g,
                const Epilogue& ep, int tz, int ty, int tx, int threads, int smem,
                cudaStream_t s) {
  if (g.cin != 1 || g.k != 3 || g.cout > 64 || tz < 1 || ty < 1 || tx < 1 ||
      threads != kStemThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nt = g.cout <= 8 ? 1 : g.cout <= 16 ? 2 : g.cout <= 32 ? 4 : 8;
  const bool vec_in = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      (static_cast<long long>(g.w) * sizeof(T)) % 16 == 0;
  StemTile t{tz, ty, tx, (g.od + tz - 1) / tz, (g.oh + ty - 1) / ty, (g.ow + tx - 1) / tx,
             (tz - 1) * g.sd + 3, (ty - 1) * g.sh + 3, (tx - 1) * g.sw + 3, vec_in ? 1 : 0};
  const long long rows = static_cast<long long>(tz) * ty * tx;
  const long long need = ((static_cast<long long>(t.pz) * t.py * t.px + 15) & ~15LL) +
                         (rows + 15) / 16 * 16 * (12 + (nt * 8 + 8) * 4);
  const long long grid = static_cast<long long>(g.b) * t.nz * t.ny * t.nx;
  if (smem < need || smem > kSmemMax || grid > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (nt) {
    case 1: return launch_stem_nt<T, 1>(x, w, sx_in, g, ep, t, grid, smem, s);
    case 2: return launch_stem_nt<T, 2>(x, w, sx_in, g, ep, t, grid, smem, s);
    case 4: return launch_stem_nt<T, 4>(x, w, sx_in, g, ep, t, grid, smem, s);
    default: return launch_stem_nt<T, 8>(x, w, sx_in, g, ep, t, grid, smem, s);
  }
}

int launch_depthwise(const void* x, const void* w, const Conv& g, const Epilogue& ep, int tz,
                     int ty, int cs, int walkers, int vec, int threads, int smem,
                     cudaStream_t s) {
  if (g.k != 3 || g.cin != g.cout || g.cin % 4 || g.sw > 2 || cs < 4 || cs % 4 || tz < 1 ||
      ty < 1 || walkers < 1 || threads != cs / 4 * walkers || threads > kDwThreads ||
      (vec != 4 && vec != 16) || g.cin % vec || cs % vec) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int runs = (g.ow + kRun - 1) / kRun;
  DwTile t{tz, ty, cs, walkers, (g.od + tz - 1) / tz, (g.oh + ty - 1) / ty,
           (g.cin + cs - 1) / cs, (tz - 1) * g.sd + 3, (ty - 1) * g.sh + 3,
           (runs * kRun - 1) * g.sw + 3, runs, vec};
  const long long need = static_cast<long long>(t.pz) * t.py * t.px * cs;
  const long long grid = static_cast<long long>(g.b) * t.nz * t.ny * t.ns;
  if (smem < need || smem > kSmemMax || grid > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (g.sw == 1) {
    err = opt_in(qconv_dw_kernel<1>, smem);
    if (err == cudaSuccess) {
      qconv_dw_kernel<1><<<static_cast<unsigned>(grid), threads, smem, s>>>(
          static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), g, ep, t);
    }
  } else {
    err = opt_in(qconv_dw_kernel<2>, smem);
    if (err == cudaSuccess) {
      qconv_dw_kernel<2><<<static_cast<unsigned>(grid), threads, smem, s>>>(
          static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), g, ep, t);
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dense_direct(const void* x, const void* w, const void* sx_in, const Conv& g,
                        const Epilogue& ep, bool quad, cudaStream_t s) {
  const long long total = g.m * g.cout;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  const T* xp = static_cast<const T*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(sx_in);
  if constexpr (sizeof(T) == 1) {
    if (quad) {
      qconv_dense_kernel<T, true><<<blocks, kThreads, 0, s>>>(xp, wp, sp, g, total, ep);
      return static_cast<int>(cudaGetLastError());
    }
  }
  qconv_dense_kernel<T, false><<<blocks, kThreads, 0, s>>>(xp, wp, sp, g, total, ep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One launch of Q1.
//  x (b, d, h, wd, cin): int8 codes (in_dtype 0), or a float32 (1) or bf16
//    (2) image quantized as it loads with *sx_in (stem and direct dense only);
//  w int8: (cout, k, k, k, cin) when `depthwise` is 0, (k, k, k, cin) with
//    cout == cin when it is 1; scale, bias (cout,) float32 (unread in mode 0);
//  mode 0: out0 (b, od, oh, ow, cout) int32 sums; 1: float32 y; 2: int8
//    codes of y with the scale sx_out[0] to out0 and, if ncodes is 2, with
//    sx_out[1] to out1; 3: y's columns 0 .. split - 1 to out0 (.., split)
//    and the rest to out1 (.., cout - split), float32;
//  vec 1: every output's rows may be written in 16-byte vectors (the
//    wrapper checks cout, split and the pointers' alignment);
//  variant 0 (direct; quad 1 sums channel quads with __dp4a: int8 x, cin %
//    4 == 0, x and w 4-byte aligned), 1 (igemm: `tile` 0-4 of the Tile table,
//    cin % 16 == 0, x and w 16-byte aligned), 2 (stem: tz, ty, tx outputs a
//    CTA), 3 (depthwise: tz, ty, cs, walkers, vec); `threads` and `smem`
//    are the plan's (kernels/qconv.py::plan_qconv), checked here.
// Zero padding k / 2. Launches on `stream` and does not synchronise.
// Returns a cudaError_t.
int msl_qconv(const void* x, const void* w, const void* scale, const void* bias,
              const void* sx_in, const void* sx_out, void* out0, void* out1, int in_dtype,
              int mode, int ncodes, int split, int relu, int vec, int b, int d, int h, int wd,
              int cin, int od, int oh, int ow, int cout, int k, int sd, int sh, int sw,
              int depthwise, int variant, int tile, int tz, int ty, int tx, int cs, int walkers,
              int copy_vec, int quad, int threads, int smem, void* stream) {
  if (b <= 0 || d <= 0 || h <= 0 || wd <= 0 || cin <= 0 || od <= 0 || oh <= 0 || ow <= 0 ||
      cout <= 0 || (k != 1 && k != 3) || sd < 1 || sd > 2 || sh < 1 || sh > 2 || sw < 1 ||
      sw > 2 || in_dtype < 0 || in_dtype > 2 || mode < 0 || mode > 3 ||
      (mode == kCodes && (ncodes < 1 || ncodes > 2 || sx_out == nullptr)) ||
      (mode == kHeads && (split <= 0 || split >= cout)) ||
      (depthwise && (cout != cin || in_dtype != 0)) || (in_dtype != 0 && sx_in == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Conv g{b, d, h, wd, cin, od, oh, ow, cout, k, sd, sh, sw, k / 2,
               static_cast<long long>(b) * od * oh * ow};
  const Epilogue ep{static_cast<const float*>(scale), static_cast<const float*>(bias),
                    static_cast<const float*>(sx_out), out0, out1, mode, ncodes, split, relu,
                    vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kDirect:
      if (depthwise) {
        const long long total = g.m * g.cout;
        qconv_depthwise_kernel<<<static_cast<unsigned>((total + kThreads - 1) / kThreads),
                                 kThreads, 0, s>>>(static_cast<const int8_t*>(x),
                                                   static_cast<const int8_t*>(w), g, total, ep);
        return static_cast<int>(cudaGetLastError());
      }
      if (quad && (in_dtype != 0 || cin % 4)) return static_cast<int>(cudaErrorInvalidValue);
      if (in_dtype == 0) return launch_dense_direct<int8_t>(x, w, sx_in, g, ep, quad != 0, s);
      if (in_dtype == 1) return launch_dense_direct<float>(x, w, sx_in, g, ep, false, s);
      return launch_dense_direct<__nv_bfloat16>(x, w, sx_in, g, ep, false, s);
    case kIgemm:
      if (depthwise || in_dtype != 0 || cin % 16) return static_cast<int>(cudaErrorInvalidValue);
      switch (tile) {
        case 0: return launch_igemm<Tile0>(x, w, g, ep, threads, smem, s);
        case 1: return launch_igemm<Tile1>(x, w, g, ep, threads, smem, s);
        case 2: return launch_igemm<Tile2>(x, w, g, ep, threads, smem, s);
        case 3: return launch_igemm<Tile3>(x, w, g, ep, threads, smem, s);
        case 4: return launch_igemm<Tile4>(x, w, g, ep, threads, smem, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    case kStem:
      if (depthwise) return static_cast<int>(cudaErrorInvalidValue);
      if (in_dtype == 0) return launch_stem<int8_t>(x, w, sx_in, g, ep, tz, ty, tx, threads, smem, s);
      if (in_dtype == 1) return launch_stem<float>(x, w, sx_in, g, ep, tz, ty, tx, threads, smem, s);
      return launch_stem<__nv_bfloat16>(x, w, sx_in, g, ep, tz, ty, tx, threads, smem, s);
    case kDepthwise:
      if (!depthwise) return static_cast<int>(cudaErrorInvalidValue);
      return launch_depthwise(x, w, g, ep, tz, ty, cs, walkers, copy_vec, threads, smem, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* msl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
