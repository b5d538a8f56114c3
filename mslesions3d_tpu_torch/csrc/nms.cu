// Exact batched greedy 3D NMS for Hopper (sm_90a): kernel K1 of the port.
//
// Replaces mslesions3d_tpu/kernels/nms.py::greedy_nms_pallas (body
// _nms_kernel). Same function: for each row n of score-sorted candidates,
// keep[n, i] = valid[n, i] and no kept j < i has IoU(j, i) > t.
//
// What bounds it on this card. The work is the IoU of every candidate pair
// below the row's last valid index (L(L-1)/2 pairs, about 18 float32
// operations each), then a greedy walk in score order. The bytes (boxes in,
// keep out) are tiny, so the pair work bounds the first launch, and the
// walk's chain of dependent steps bounds the second.
//
// Design. The TPU kernel keeps a bf16 KxK suppression matrix in VMEM and
// solves a fixpoint with MXU mat-vecs; at K = 1000 that matrix is 2 MiB, far
// beyond the 227 KB of shared memory a block can use. Here the matrix is a
// bitmask of 64-bit words, 8x smaller than bf16:
//   1. nms_mask_kernel: one block of 64 threads per (row, row block of 64,
//      column block of 64) on or above the diagonal. Each thread owns one candidate j and writes one
//      word: bit c set iff i = 64*cb + c > j and IoU(j, i) > t. It first
//      marks the columns whose boxes overlap its own on all three axes (a
//      cheap test that never misses a bit when t >= 0) and takes the exact
//      IoU only of those. A block on the diagonal also writes its 64x64 bits
//      transposed (diag_t: word i holds the j < i of the same word that
//      suppress i). Blocks whose columns lie past the last valid candidate
//      do nothing (the TPU kernel's data-adaptive bound).
//   2. nms_walk_kernel (K <= 2048, "warp"): one block of 4 warps per row;
//      warp 0 resolves 64 candidates (one word) at a time. The "removed"
//      bitset has at most 32 words, one per lane. For word w:
//      a. the word's live candidates are the valid ones no earlier kept
//         candidate removed;
//      b. lane l holds the transposed diagonal words of candidates 64w+l and
//         64w+32+l; the greedy order inside the word is the unique fixpoint
//         of kept = live & ~(suppressed by kept), found with two ballots per
//         round from kept = live. Only these rounds are sequential, and they
//         are as many as the longest suppression chain inside the word;
//      c. the 4 warps OR 16 kept rows each into the later words' removed
//         bits, lane c taking word c: independent shared-memory loads, not
//         a chain, then one shared-memory atomicOr per lane.
//      All 4 warps stage the rows and the diagonal block of words w+1 and
//      w+2 into shared memory with 16-byte cp.async while word w resolves
//      (three buffers, 26 KB at K = 1000; mask rows are padded to an even
//      number of words so every copy is aligned). The walk stops at the
//      row's last valid candidate. Its shared-memory limit is raised once
//      per process, not on every call.
//   3. nms_walk_wide_kernel<S> (K > 2048, "wide"): the same walk for any K.
//      The removed bitset, seeded with the invalid candidates, lives in
//      shared memory, nw words long; in step c lane l takes words c = w+1+l,
//      w+1+l+32, ...; the last valid candidate is a block-wide atomicMax
//      over all words. The host
//      plan (plan_nms in kernels/nms.py) picks S, the staged words: 3 while
//      three buffers of 64 rows fit a block's 227 KB (K <= 9472), then 2
//      (K <= 14336), then 1 (K <= 28544); past that S = 0 and the kept rows
//      are ORed straight from global memory (L2-resident), only the rows
//      actually kept. Each S is its own instantiation, since cp.async's
//      wait count is a constant.
//   The mask launch spreads the triangle of blocks over gridDim.y and
//   gridDim.z (each at most 65535), so no grid dimension overflows at any K.
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

constexpr int kWord = 64;      // candidates per mask word
constexpr int kMaxWords = 32;  // one removed word per lane of the walking warp
constexpr unsigned kFull = 0xffffffffu;

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
                                unsigned long long* __restrict__ mask,
                                unsigned long long* __restrict__ diag_t, int k, int nw,
                                int nwp, float t) {
  // blockIdx.y + gridDim.y * blockIdx.z enumerates the blocks on and above
  // the diagonal, row by row; the grid may round the triangle up
  const int n = blockIdx.x;
  int rb = 0, cb = blockIdx.y + gridDim.y * blockIdx.z;
  if (cb >= nw * (nw + 1) / 2) return;  // the same for the whole block
  while (cb >= nw - rb) cb -= nw - rb++;
  cb += rb;
  const int tid = threadIdx.x;
  const bool* v = valid + static_cast<size_t>(n) * k;

  // The columns of this block matter only if a valid candidate lies at or
  // past the first of them: a bound on the data, as in the TPU kernel.
  // Valid candidates are usually a prefix, so the first chunk decides.
  bool any = false;
  for (int i0 = cb * kWord; i0 < k && !any; i0 += kWord) {
    any = __syncthreads_or(i0 + tid < k && v[i0 + tid]);
  }
  if (!any) return;

  __shared__ float col_lo[3][kWord];
  __shared__ float col_hi[3][kWord];
  __shared__ float col_vol[kWord];
  __shared__ unsigned long long diag_rows[kWord];
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
  unsigned long long bits = 0ull;
  if (j < k) {
    float lo[3], hi[3];
    for (int d = 0; d < 3; ++d) {
      lo[d] = b[j * 6 + d];
      hi[d] = b[j * 6 + 3 + d];
    }
    const float vol_j = volume(lo, hi);
    const int ncol = min(kWord, k - cb * kWord);
    const int c0 = (cb == rb) ? tid + 1 : 0;
    // Candidates: with t >= 0 a bit needs IoU > 0, so a positive overlap
    // along each axis, and on non-NaN values the plain fminf/fmaxf give the
    // same differences as the NaN-propagating ones. NaN pairs never set a
    // bit, so skipping them is exact. With t < 0 every pair is a candidate.
    unsigned long long cand = 0ull;
    for (int c = c0; c < ncol; ++c) {
      bool overlap = t < 0.f;
      const float d0 = __fsub_rn(fminf(hi[0], col_hi[0][c]), fmaxf(lo[0], col_lo[0][c]));
      const float d1 = __fsub_rn(fminf(hi[1], col_hi[1][c]), fmaxf(lo[1], col_lo[1][c]));
      const float d2 = __fsub_rn(fminf(hi[2], col_hi[2][c]), fmaxf(lo[2], col_lo[2][c]));
      overlap |= d0 > 0.f && d1 > 0.f && d2 > 0.f;
      cand |= static_cast<unsigned long long>(overlap) << c;
    }
    while (cand) {
      const int c = __ffsll(static_cast<long long>(cand)) - 1;
      cand &= cand - 1;
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
    mask[(static_cast<size_t>(n) * k + j) * nwp + cb] = bits;
  }
  if (cb != rb) return;  // the same for the whole block

  // the diagonal block transposed: thread tid gathers bit tid of every row
  diag_rows[tid] = bits;
  __syncthreads();
  unsigned long long col = 0ull;
  for (int r = 0; r < kWord; ++r) col |= ((diag_rows[r] >> tid) & 1ull) << r;
  diag_t[(static_cast<size_t>(n) * nwp + cb) * kWord + tid] = col;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kWalkThreads = 128;  // 4 warps stage and OR rows; warp 0 resolves
constexpr int kStages = 3;         // word w resolves while words w+1 and w+2 land

// Shared memory of the walk for rows of nwp (even) words: kStages buffers of
// 64 rows, then kStages diagonal blocks of 64 words.
size_t walk_smem_bytes(int nwp) {
  return static_cast<size_t>(kStages) * kWord * (nwp + 1) * sizeof(unsigned long long);
}

__global__ void __launch_bounds__(kWalkThreads)
nms_walk_kernel(const bool* __restrict__ valid, const unsigned long long* __restrict__ mask,
                const unsigned long long* __restrict__ diag_t, bool* __restrict__ keep, int k,
                int nwp) {
  extern __shared__ __align__(16) unsigned long long smem[];
  unsigned long long* rows = smem;                           // [kStages][kWord][nwp]
  unsigned long long* diag = smem + kStages * kWord * nwp;  // [kStages][kWord]
  __shared__ unsigned vbits[2 * kMaxWords];                  // valid bits, 32 per chunk
  const int n = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool* v = valid + static_cast<size_t>(n) * k;
  const unsigned long long* m = mask + static_cast<size_t>(n) * k * nwp;
  const unsigned long long* dt = diag_t + static_cast<size_t>(n) * (nwp * kWord);
  bool* out = keep + static_cast<size_t>(n) * k;

  // the valid bits of chunk c (candidates 32c ..) into vbits[c]
  constexpr int kPerWarp = 2 * kMaxWords / (kWalkThreads / 32);
  bool vals[kPerWarp];
#pragma unroll
  for (int u = 0; u < kPerWarp; ++u) {
    const int i = (warp + u * (kWalkThreads / 32)) * 32 + lane;
    vals[u] = i < k && v[i];
  }
#pragma unroll
  for (int u = 0; u < kPerWarp; ++u) {
    const unsigned bal = __ballot_sync(kFull, vals[u]);
    if (lane == 0) vbits[warp + u * (kWalkThreads / 32)] = bal;
  }
  __syncthreads();
  // count = index of the last valid candidate + 1, the same in every warp
  const unsigned lo_nz = __ballot_sync(kFull, vbits[lane] != 0u);
  const unsigned hi_nz = __ballot_sync(kFull, vbits[32 + lane] != 0u);
  const int last_chunk = hi_nz ? 63 - __clz(static_cast<int>(hi_nz))
                               : (lo_nz ? 31 - __clz(static_cast<int>(lo_nz)) : -1);
  const int count =
      last_chunk < 0 ? 0 : last_chunk * 32 + 32 - __clz(static_cast<int>(vbits[last_chunk]));
  const int words = (count + kWord - 1) / kWord;
  // word w of the removed bitset; invalid candidates count as removed
  __shared__ unsigned long long removed[kMaxWords];
  __shared__ unsigned long long kept_word;
  if (tid < kMaxWords) {
    removed[tid] = ~(static_cast<unsigned long long>(vbits[2 * tid]) |
                     (static_cast<unsigned long long>(vbits[2 * tid + 1]) << 32));
  }

  // Rows of word w (up to `count`), words c0 = (w+1) & ~1 .. nwp-1 of each,
  // and the word's diagonal block, into buffer w % kStages.
  auto stage = [&](int w) {
    if (w < words) {
      const int sb = w % kStages;
      const int c0 = (w + 1) & ~1, pairs = (nwp - c0) / 2, nr = min(kWord, count - w * kWord);
      unsigned long long* dst = rows + sb * kWord * nwp;
      const unsigned long long* src = m + static_cast<size_t>(w) * kWord * nwp;
      // thread -> (row tid / 16 + 8i, word pair tid % 16): at most 16 pairs
      const int c = c0 + 2 * (tid % 16);
      for (int r = tid / 16; tid % 16 < pairs && r < nr; r += kWalkThreads / 16) {
        cp_async16(dst + r * nwp + c, src + static_cast<size_t>(r) * nwp + c);
      }
      if (tid < kWord / 2) cp_async16(diag + sb * kWord + 2 * tid, dt + w * kWord + 2 * tid);
    }
    cp_async_commit();  // one group per word, empty or not
  };

  stage(0);
  stage(1);
  for (int w = 0; w < words; ++w) {
    cp_async_wait<1>();  // word w's group has landed
    __syncthreads();     // its rows, and `removed`, are visible; buffer (w + 2) % 3 is free
    stage(w + 2);
    const int sb = w % kStages;
    if (warp == 0) {
      // b. the word's greedy order: fixpoint rounds from kept = live
      const unsigned long long col_lo = diag[sb * kWord + lane];
      const unsigned long long col_hi = diag[sb * kWord + 32 + lane];
      const unsigned long long live = ~removed[w];
      unsigned long long kept = live;
      while (true) {
        const bool lo = ((live >> lane) & 1ull) && !(col_lo & kept);
        const bool hi = ((live >> (lane + 32)) & 1ull) && !(col_hi & kept);
        const unsigned long long next =
            static_cast<unsigned long long>(__ballot_sync(kFull, lo)) |
            (static_cast<unsigned long long>(__ballot_sync(kFull, hi)) << 32);
        if (next == kept) break;
        kept = next;
      }
      if (lane == 0) kept_word = kept;
      const int i = w * kWord + lane;
      if (i < k) out[i] = (kept >> lane) & 1ull;
      if (i + 32 < k) out[i + 32] = (kept >> (lane + 32)) & 1ull;
    }
    __syncthreads();  // kept_word is visible

    // c. warp q ORs kept rows 16q .. 16q+15 of word w into the later words'
    // removed bits; lane c takes word c
    const unsigned long long kept = kept_word;
    if (lane > w && lane < words) {
      const unsigned long long* src = rows + (sb * kWord + 16 * warp) * nwp + lane;
      const unsigned long long bits = kept >> (16 * warp);
      unsigned long long acc = 0ull;
#pragma unroll
      for (int r = 0; r < 16; ++r) acc |= src[r * nwp] & (0ull - ((bits >> r) & 1ull));
      if (acc) atomicOr(&removed[lane], acc);  // rows past `count` were not staged; kept bit 0
    }
  }
  for (int i = words * kWord + tid; i < k; i += kWalkThreads) out[i] = false;
}

// Shared memory of the wide walk with S staged words: S buffers of 64 rows
// of nwp words and S diagonal blocks, then the removed bitset (nwp words),
// the kept word and the count. kernels/nms.py::plan_nms mirrors this.
size_t wide_smem_bytes(int stages, int nwp) {
  return (static_cast<size_t>(stages) * kWord * (nwp + 1) + nwp + 2) * sizeof(unsigned long long);
}

template <int S>
__global__ void __launch_bounds__(kWalkThreads)
nms_walk_wide_kernel(const bool* __restrict__ valid, const unsigned long long* __restrict__ mask,
                     const unsigned long long* __restrict__ diag_t, bool* __restrict__ keep,
                     int k, int nwp) {
  extern __shared__ __align__(16) unsigned long long smem[];
  unsigned long long* rows = smem;                        // [S][kWord][nwp]
  unsigned long long* diag = rows + S * kWord * nwp;     // [S][kWord]
  unsigned long long* removed = diag + S * kWord;        // [nwp]
  unsigned long long* kept_word = removed + nwp;         // [1]
  int* count_sh = reinterpret_cast<int*>(kept_word + 1);  // [1]
  const int n = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = (k + kWord - 1) / kWord;
  const bool* v = valid + static_cast<size_t>(n) * k;
  const unsigned long long* m = mask + static_cast<size_t>(n) * k * nwp;
  const unsigned long long* dt = diag_t + static_cast<size_t>(n) * nwp * kWord;
  bool* out = keep + static_cast<size_t>(n) * k;

  // word c of the removed bitset = its invalid candidates; count = the last
  // valid candidate + 1, over all words
  if (tid == 0) *count_sh = 0;
  __syncthreads();
  for (int c = warp; c < nw; c += kWalkThreads / 32) {
    const int i = c * kWord + lane;
    const unsigned long long bits =
        static_cast<unsigned long long>(__ballot_sync(kFull, i < k && v[i])) |
        (static_cast<unsigned long long>(__ballot_sync(kFull, i + 32 < k && v[i + 32])) << 32);
    if (lane == 0) {
      removed[c] = ~bits;
      if (bits) atomicMax(count_sh, c * kWord + kWord - __clzll(static_cast<long long>(bits)));
    }
  }
  __syncthreads();
  const int count = *count_sh;
  const int words = (count + kWord - 1) / kWord, words_even = (words + 1) & ~1;

  // Rows of word w (up to `count`), words c0 = (w+1) & ~1 .. words_even-1 of
  // each, and the word's diagonal block, into buffer w % S.
  auto stage = [&](int w) {
    if constexpr (S > 0) {
      if (w < words) {
        const int sb = w % S, c0 = (w + 1) & ~1, pairs = (words_even - c0) / 2;
        const int nr = min(kWord, count - w * kWord);
        unsigned long long* dst = rows + sb * kWord * nwp;
        const unsigned long long* src = m + static_cast<size_t>(w) * kWord * nwp;
        for (int idx = tid; idx < nr * pairs; idx += kWalkThreads) {
          const int r = idx / pairs, c = c0 + 2 * (idx - r * pairs);
          cp_async16(dst + r * nwp + c, src + static_cast<size_t>(r) * nwp + c);
        }
        if (tid < kWord / 2) cp_async16(diag + sb * kWord + 2 * tid, dt + w * kWord + 2 * tid);
      }
      cp_async_commit();  // one group per word, empty or not
    }
  };

  for (int s = 0; s + 1 < S; ++s) stage(s);
  for (int w = 0; w < words; ++w) {
    const int sb = w % (S > 0 ? S : 1);
    if constexpr (S >= 2) {
      cp_async_wait<S - 2>();  // word w's group has landed
      __syncthreads();         // its rows and `removed` are visible; buffer (w - 1) % S is free
      stage(w + S - 1);
    } else if constexpr (S == 1) {
      __syncthreads();  // the one buffer is free; `removed` is visible
      stage(w);
      cp_async_wait<0>();
      __syncthreads();
    } else {
      __syncthreads();  // `removed` is visible
    }
    if (warp == 0) {
      // the word's greedy order: fixpoint rounds from kept = live
      unsigned long long col_lo, col_hi;
      if constexpr (S > 0) {
        col_lo = diag[sb * kWord + lane];
        col_hi = diag[sb * kWord + 32 + lane];
      } else {
        col_lo = dt[w * kWord + lane];
        col_hi = dt[w * kWord + 32 + lane];
      }
      const unsigned long long live = ~removed[w];
      unsigned long long kept = live;
      while (true) {
        const bool lo = ((live >> lane) & 1ull) && !(col_lo & kept);
        const bool hi = ((live >> (lane + 32)) & 1ull) && !(col_hi & kept);
        const unsigned long long next =
            static_cast<unsigned long long>(__ballot_sync(kFull, lo)) |
            (static_cast<unsigned long long>(__ballot_sync(kFull, hi)) << 32);
        if (next == kept) break;
        kept = next;
      }
      if (lane == 0) *kept_word = kept;
      const int i = w * kWord + lane;
      if (i < k) out[i] = (kept >> lane) & 1ull;
      if (i + 32 < k) out[i + 32] = (kept >> (lane + 32)) & 1ull;
    }
    __syncthreads();  // the kept word is visible

    // warp q ORs kept rows 16q .. 16q+15 of word w into the later words'
    // removed bits; lane l takes words w+1+l, w+1+l+32, ...
    const unsigned long long bits = (*kept_word >> (16 * warp)) & 0xffffull;
    if (bits) {
      for (int c = w + 1 + lane; c < words; c += 32) {
        unsigned long long acc = 0ull;
        if constexpr (S > 0) {
          const unsigned long long* src = rows + (sb * kWord + 16 * warp) * nwp + c;
#pragma unroll
          for (int r = 0; r < 16; ++r) acc |= src[r * nwp] & (0ull - ((bits >> r) & 1ull));
        } else {
          const unsigned long long* src = m + (static_cast<size_t>(w) * kWord + 16 * warp) * nwp + c;
          for (unsigned long long b = bits; b; b &= b - 1) {
            acc |= src[static_cast<size_t>(__ffsll(static_cast<long long>(b)) - 1) * nwp];
          }
        }
        if (acc) atomicOr(&removed[c], acc);  // rows past `count` hold kept bit 0
      }
    }
  }
  for (int i = words * kWord + tid; i < k; i += kWalkThreads) out[i] = false;
}

constexpr int kMaxWideStages = 3;
constexpr int kMaxSmem = 232448;  // a Hopper block's opt-in maximum
bool g_wide_opted_in[kMaxWideStages + 1] = {};  // per instantiation, once per process

template <int S>
cudaError_t launch_wide(int n, int k, int nwp, const bool* valid, const unsigned long long* mask,
                        const unsigned long long* diag_t, bool* keep, cudaStream_t s) {
  const size_t smem = wide_smem_bytes(S, nwp);
  if (!g_wide_opted_in[S]) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_walk_wide_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    g_wide_opted_in[S] = true;
  }
  nms_walk_wide_kernel<S><<<n, kWalkThreads, smem, s>>>(valid, mask, diag_t, keep, k, nwp);
  return cudaGetLastError();
}

bool g_walk_opted_in = false;  // the attribute is set once per process

}  // namespace

extern "C" {

// Shared memory of the walk for k candidates: the warp walk (stages < 0)
// or the wide walk with `stages` staged words.
long long msl_nms_walk_smem_bytes(int k, int stages) {
  const int nwp = ((k + kWord - 1) / kWord + 1) & ~1;
  return static_cast<long long>(stages < 0 ? walk_smem_bytes(nwp) : wide_smem_bytes(stages, nwp));
}

// boxes (n, k, 6) float32, valid (n, k) bool, mask (n, k, nwp) and diag_t
// (n, nwp, 64) 64-bit scratch with nwp = ceil(k/64) rounded up to even,
// keep (n, k) bool; all contiguous on the current device. `stages` < 0
// takes the warp walk (k <= 2048), 0-3 the wide walk with that many staged
// words (kernels/nms.py::plan_nms). Launches on `stream` and does not
// synchronise. Returns a cudaError_t.
int msl_greedy_nms(const void* boxes, const void* valid, void* mask, void* diag_t, void* keep,
                   int n, int k, float max_overlap, int stages, void* stream) {
  const int nw = (k + kWord - 1) / kWord, nwp = (nw + 1) & ~1;
  const long long ntri = static_cast<long long>(nw) * (nw + 1) / 2;
  const long long gy = ntri < 65535 ? ntri : 65535, gz = (ntri + gy - 1) / gy;
  if (n <= 0 || k <= 0 || gz > 65535 || stages > kMaxWideStages ||
      (stages < 0 && nw > kMaxWords) ||
      (stages >= 0 && wide_smem_bytes(stages, nwp) > static_cast<size_t>(kMaxSmem))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool* v = static_cast<const bool*>(valid);
  auto* m = static_cast<unsigned long long*>(mask);
  auto* dt = static_cast<unsigned long long*>(diag_t);
  bool* out = static_cast<bool*>(keep);
  nms_mask_kernel<<<dim3(n, static_cast<unsigned>(gy), static_cast<unsigned>(gz)), kWord, 0, s>>>(
      static_cast<const float*>(boxes), v, m, dt, k, nw, nwp, max_overlap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (stages) {
    case 0: return static_cast<int>(launch_wide<0>(n, k, nwp, v, m, dt, out, s));
    case 1: return static_cast<int>(launch_wide<1>(n, k, nwp, v, m, dt, out, s));
    case 2: return static_cast<int>(launch_wide<2>(n, k, nwp, v, m, dt, out, s));
    case 3: return static_cast<int>(launch_wide<3>(n, k, nwp, v, m, dt, out, s));
    default: break;
  }
  if (!g_walk_opted_in) {
    err = cudaFuncSetAttribute(nms_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(walk_smem_bytes(kMaxWords)));
    if (err != cudaSuccess) return static_cast<int>(err);
    g_walk_opted_in = true;
  }
  nms_walk_kernel<<<n, kWalkThreads, walk_smem_bytes(nwp), s>>>(v, m, dt, out, k, nwp);
  return static_cast<int>(cudaGetLastError());
}

const char* msl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
