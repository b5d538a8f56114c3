// Exact batched greedy 3D NMS for Hopper (sm_90a): kernel K1 of the port.
//
// Replaces mslesions3d_tpu/kernels/nms.py::greedy_nms_pallas (body
// _nms_kernel). Same function: for each row n of score-sorted candidates,
// keep[n, i] = valid[n, i] and no kept j < i has IoU(j, i) > t.
//
// What bounds it on this card. The work is the IoU of every candidate pair
// below the row's last valid index (L(L-1)/2 pairs, about 18 float32
// operations each), then a greedy walk of L steps in score order. The bytes
// (boxes in, keep out) are tiny, so the pair work bounds the first launch
// and the walk's chain of dependent steps bounds the second.
//
// Design. The TPU kernel keeps a bf16 KxK suppression matrix in VMEM and
// solves a fixpoint with MXU mat-vecs; at K = 1000 that matrix is 2 MiB, far
// beyond the 227 KB of shared memory a block can use. Here the matrix is a
// bitmask of 64-bit words, 8x smaller than bf16:
//   1. nms_mask_kernel: one block of 64 threads per (row, row block of 64,
//      column block of 64). Each thread owns one candidate j and writes one
//      word: bit c set iff i = 64*cb + c > j and IoU(j, i) > t. Blocks below
//      the diagonal, and blocks whose columns lie past the last valid
//      candidate, do nothing (the TPU kernel's data-adaptive bound). Every
//      block on the card works in parallel; the words go to a scratch tensor.
//   2. nms_scan_kernel: one block per row stages the row's words in shared
//      memory (128 KB at K = 1000), then one warp walks the candidates in
//      order. Lane w holds word w of the "removed" bitset; a kept candidate
//      ORs its mask row into it. Words below the diagonal are never read.
// The answer of greedy NMS is unique, so this gives the fixpoint's result.
//
// Exactness. The keep mask must equal the plain torch version bit for bit,
// so the IoU follows ops/boxes.py::pairwise_iou operation by operation with
// round-to-nearest intrinsics (no FMA contraction; the build also passes
// -fmad=false), and min/max/clamp propagate NaN as torch.minimum,
// torch.maximum and torch.clamp do. A pair with zero intersection has IoU 0
// or NaN (0/0), which never exceeds a threshold t >= 0, so it is skipped.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWord = 64;          // candidates per mask word
constexpr int kScanThreads = 256;  // threads that stage a row for the scan

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

// torch.clamp(d, min=0): NaN stays NaN
__device__ __forceinline__ float clamp_min0(float d) { return d < 0.f ? 0.f : d; }

// box_volume: (hx - lx) * (hy - ly) * (hz - lz), left to right
__device__ __forceinline__ float volume(const float* lo, const float* hi) {
  return __fmul_rn(__fmul_rn(__fsub_rn(hi[0], lo[0]), __fsub_rn(hi[1], lo[1])),
                   __fsub_rn(hi[2], lo[2]));
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes,
                                const bool* __restrict__ valid,
                                unsigned long long* __restrict__ mask, int k, int nw,
                                float t) {
  const int n = blockIdx.x, rb = blockIdx.y, cb = blockIdx.z;
  if (cb < rb) return;  // every pair here has j > i
  const int tid = threadIdx.x;
  const bool* v = valid + static_cast<size_t>(n) * k;

  // The columns of this block matter only if a valid candidate lies at or
  // past the first of them: a bound on the data, as in the TPU kernel.
  bool any = false;
  for (int i = cb * kWord + tid; i < k; i += kWord) any |= v[i];
  if (!__syncthreads_or(any)) return;

  __shared__ float col_lo[3][kWord];
  __shared__ float col_hi[3][kWord];
  __shared__ float col_vol[kWord];
  const float* b = boxes + static_cast<size_t>(n) * k * 6;
  const int ci = cb * kWord + tid;
  if (ci < k) {
    float lo[3], hi[3];
    for (int d = 0; d < 3; ++d) {
      lo[d] = b[ci * 6 + d];
      hi[d] = b[ci * 6 + 3 + d];
      col_lo[d][tid] = lo[d];
      col_hi[d][tid] = hi[d];
    }
    col_vol[tid] = volume(lo, hi);
  }
  __syncthreads();

  const int j = rb * kWord + tid;
  if (j >= k) return;
  float lo[3], hi[3];
  for (int d = 0; d < 3; ++d) {
    lo[d] = b[j * 6 + d];
    hi[d] = b[j * 6 + 3 + d];
  }
  const float vol_j = volume(lo, hi);
  const int ncol = min(kWord, k - cb * kWord);
  unsigned long long bits = 0ull;
  for (int c = (cb == rb) ? tid + 1 : 0; c < ncol; ++c) {
    float dims[3];
    for (int d = 0; d < 3; ++d) {
      dims[d] = clamp_min0(
          __fsub_rn(nan_min(hi[d], col_hi[d][c]), nan_max(lo[d], col_lo[d][c])));
    }
    const float inter = __fmul_rn(__fmul_rn(dims[0], dims[1]), dims[2]);
    if (inter == 0.f && t >= 0.f) continue;
    const float uni = __fsub_rn(__fadd_rn(vol_j, col_vol[c]), inter);
    if (__fdiv_rn(inter, uni) > t) bits |= 1ull << c;
  }
  mask[(static_cast<size_t>(n) * k + j) * nw + cb] = bits;
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const bool* __restrict__ valid,
                const unsigned long long* __restrict__ mask, bool* __restrict__ keep,
                int k, int nw) {
  extern __shared__ unsigned long long rows[];  // [k * nw] words, then k flags
  unsigned char* flags = reinterpret_cast<unsigned char*>(rows + static_cast<size_t>(k) * nw);
  __shared__ int last;  // index of the last valid candidate + 1

  const int n = blockIdx.x, tid = threadIdx.x;
  const bool* v = valid + static_cast<size_t>(n) * k;
  const unsigned long long* m = mask + static_cast<size_t>(n) * k * nw;
  bool* out = keep + static_cast<size_t>(n) * k;

  if (tid == 0) last = 0;
  __syncthreads();
  int my_last = 0;
  for (int i = tid; i < k; i += blockDim.x) {
    if (v[i]) my_last = i + 1;
  }
  atomicMax(&last, my_last);
  __syncthreads();
  const int count = last;
  const int words = (count + kWord - 1) / kWord;  // <= nw <= 32

  // Stage the words the walk can read: rows j < count, words on or above
  // the diagonal and below `words`. The mask kernel wrote all of them.
  for (int idx = tid; idx < count * words; idx += blockDim.x) {
    const int j = idx / words, w = idx - j * words;
    if (w >= j / kWord) rows[j * words + w] = m[static_cast<size_t>(j) * nw + w];
  }
  for (int i = tid; i < count; i += blockDim.x) flags[i] = v[i];
  for (int i = count + tid; i < k; i += blockDim.x) out[i] = false;
  __syncthreads();

  if (tid >= 32) return;
  const int lane = tid;
  unsigned long long removed = 0ull;  // bits of candidates 64*lane .. 64*lane+63
  for (int i = 0; i < count; ++i) {
    const int w = i / kWord;
    const unsigned long long word = __shfl_sync(0xffffffffu, removed, w);
    const bool kept = flags[i] && !((word >> (i % kWord)) & 1ull);
    if (kept && lane >= w && lane < words) removed |= rows[i * words + lane];
    if (lane == 0) out[i] = kept;
  }
}

// Shared memory the scan kernel needs for a row of k candidates (the
// wrapper's scan_smem_bytes).
size_t scan_smem_bytes(int k) {
  const size_t nw = (static_cast<size_t>(k) + kWord - 1) / kWord;
  return static_cast<size_t>(k) * nw * sizeof(unsigned long long) + static_cast<size_t>(k);
}

}  // namespace

extern "C" {

// boxes (n, k, 6) float32, valid (n, k) bool, mask (n, k, ceil(k/64)) 64-bit
// scratch, keep (n, k) bool; all contiguous on the current device. Launches
// on `stream` and does not synchronise. Returns a cudaError_t.
int msl_greedy_nms(const void* boxes, const void* valid, void* mask, void* keep, int n,
                   int k, float max_overlap, void* stream) {
  const int nw = (k + kWord - 1) / kWord;
  if (n <= 0 || k <= 0 || nw > 32) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = scan_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(n, nw, nw), kWord, 0, s>>>(
      static_cast<const float*>(boxes), static_cast<const bool*>(valid),
      static_cast<unsigned long long*>(mask), k, nw, max_overlap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_scan_kernel<<<n, kScanThreads, smem, s>>>(
      static_cast<const bool*>(valid), static_cast<const unsigned long long*>(mask),
      static_cast<bool*>(keep), k, nw);
  return static_cast<int>(cudaGetLastError());
}

const char* msl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
