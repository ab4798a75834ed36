// Fused pairwise-contact sweep for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel repro/kernels/contacts.py::pairwise_contacts
// (body _kernel). For every batch item b and row i it emits, against all N
// columns j:
//   closew[b, i, w]  bit (j % 32) of word w = j / 32 is
//                    d2 <= r_tx2 && (zw_i & zw_j) != 0 && i != j
//                    (LSB-first, pad bits zero);
//   best_j[b, i]     first-minimum argmin of d2 over the candidates
//                    close && !prev && elig_i && elig_j, or -1;
//   has[b, i]        whether a candidate exists.
// d2 = fma(dx, dx, dy*dy), rounded exactly as jitted XLA rounds the
// reference's dx*dx + dy*dy; the intrinsics keep nvcc from choosing.
//
// What bounds it: the launch. Every input is read once and every output
// written once (18 bytes per node plus 8 bytes per packed word of prevw and
// closew), with 5 float32 operations per pair: at the paper's N = 200 that
// is nanoseconds of work on an H100, far below the time the card takes to
// start and retire any kernel (its launch floor, a one-element fill_ in a
// CUDA graph, is about 0.9 us). What a launch costs beyond that floor is
// the chain of dependent steps in one warp: its loads (a round trip to L2),
// then its instructions, one warp issuing them alone on its scheduler.
//
// The first design (one warp a row, 8 rows a block) walked the row's words
// one by one, and each word waited on a global load of its prevw word inside
// a loop of run-time length: 7 round trips to L2 a row at N = 200, 25 at
// N = 800; it staged the columns in chunks of 256 behind two barriers each;
// and it ran 25 blocks at N = 200 on 132 SMs.
//
// This design, still one warp a row, 4 rows a block:
//   - issues every global read of a chunk's first segment before any
//     compute: the row's own node, its first 32 prevw words (coalesced:
//     lane k holds word k of the segment of 1024 columns), and the chunk's
//     columns (x, y, zone word, elig: 13 B a node), staged once into
//     dynamic shared memory behind one barrier. A chunk is all N columns up
//     to kMaxChunk = 16384 (213 KB of the 227 KB a block may hold); only
//     beyond that does the kernel loop over chunks, with one more barrier
//     each. Past 1024 columns each segment loads the next segment's prevw
//     words before it computes, so that load overlaps the segment's work;
//   - takes the words of a segment 8 at a time: the shared loads, d2 and
//     close tests of 8 words first, all independent, then their 8
//     __ballot_sync, each word kept by the lane that owns it, so the row's
//     closew is one coalesced store a segment. The tests combine with &, not
//     &&: a short circuit puts each word's load under a branch, and the warp
//     then waits for the loads word by word. Most
//     groups hold no close pair; only where one does are the candidates
//     tested, word w's prev bits coming from lane w by __shfl_sync;
//   - keeps each lane's first minimum over its own columns (j % 32 == lane,
//     visited in increasing j), then merges the lanes by (d2, j) with a
//     butterfly of shuffles, the smaller j winning on equal d2 (that is the
//     first minimum over the row, whatever the merge order), skipped where
//     no lane has a candidate;
//   - runs a grid of (row tiles, B): 50 blocks at N = 200, 200 at N = 800
//     and 800 for 16 runs at N = 200. The chunk and the shared bytes come
//     from the wrapper (repro_torch.kernels.contacts.contact_geometry).

#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>
#include <cmath>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 4;                  // warps a block, one row each
constexpr int kMaxChunk = 16384;          // columns staged at once
constexpr int kUnroll = 8;                // words computed together
constexpr int kStage = 4;                 // columns a thread stages per pass

// Lane's word of segment s of the chunk's prevw words, 0 past the chunk.
// The index is clamped and the load never skipped: a load under a branch
// would make the warp wait for it before the branch rejoins.
__device__ __forceinline__ unsigned prev_word(const int32_t* prow, int s,
                                              int lane, int cwords) {
  const int k = s * 32 + lane;
  const unsigned v = static_cast<unsigned>(prow[min(k, cwords - 1)]);
  return k < cwords ? v : 0u;
}

__global__ void __launch_bounds__(kRows * 32)
pairwise_contacts_kernel(const float* __restrict__ x,
                         const float* __restrict__ y,
                         const int32_t* __restrict__ zw,
                         const uint8_t* __restrict__ elig,
                         const int32_t* __restrict__ prevw,
                         int32_t* __restrict__ closew,
                         int32_t* __restrict__ best_j,
                         uint8_t* __restrict__ has,
                         int n, int nw, float r_tx2, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* sxy = reinterpret_cast<float2*>(smem);
  int32_t* sz = reinterpret_cast<int32_t*>(sxy + chunk);
  uint8_t* se = reinterpret_cast<uint8_t*>(sz + chunk);

  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kRows + (threadIdx.x >> 5);
  const bool row_ok = i < n;              // uniform across the warp
  const size_t base = static_cast<size_t>(blockIdx.y) * n;
  const size_t row = base + (row_ok ? i : 0);
  const int32_t* prow = prevw + row * nw;
  int32_t* crow = closew + row * nw;

  const float xi = x[row];
  const float yi = y[row];
  const int32_t zi = zw[row];
  const bool ei = elig[row] != 0;

  float best_d2 = INFINITY;
  int best = INT_MAX;
  for (int c0 = 0; c0 < n; c0 += chunk) {
    const int cn = min(chunk, n - c0);
    const int w_base = c0 >> 5;           // chunk is a multiple of 32
    const int cwords = (cn + 31) >> 5;
    const int32_t* pc = prow + w_base;
    unsigned pv = prev_word(pc, 0, lane, cwords);  // lane k: word k
    if (c0 > 0) __syncthreads();          // the previous chunk is consumed
    const float* xc = x + base + c0;
    const float* yc = y + base + c0;
    const int32_t* zc = zw + base + c0;
    const uint8_t* ec = elig + base + c0;
    for (int j0 = threadIdx.x; j0 < cn; j0 += kStage * kRows * 32) {
      float rx[kStage], ry[kStage];
      int32_t rz[kStage];
      uint8_t re[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int j = j0 + u * kRows * 32;
        if (j < cn) {
          rx[u] = xc[j];
          ry[u] = yc[j];
          rz[u] = zc[j];
          re[u] = ec[j];
        }
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int j = j0 + u * kRows * 32;
        if (j < cn) {
          sxy[j] = make_float2(rx[u], ry[u]);
          sz[j] = rz[u];
          se[j] = re[u];
        }
      }
    }
    __syncthreads();
    if (!row_ok) continue;
    for (int s = 0; s * 32 < cwords; ++s) {
      // The next segment's prevw words go out before this one's work.
      const unsigned pv_next = prev_word(pc, s + 1, lane, cwords);
      const int swords = min(32, cwords - s * 32);
      unsigned mine = 0;                  // this lane's word of the segment
      for (int w0 = 0; w0 < swords; w0 += kUnroll) {
        // Eight words at once: their shared loads, d2 and close tests are
        // independent; then one ballot each. The tests combine with & (no
        // short circuit), so no load waits under a branch.
        int lc[kUnroll];
        float d2[kUnroll];
        bool close[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int w = w0 + u;
          const int lj = ((s * 32 + w) << 5) + lane;  // column in the chunk
          const bool in = (w < swords) & (lj < cn);
          lc[u] = in ? lj : 0;
          const float2 p = sxy[lc[u]];
          const int32_t zj = sz[lc[u]];
          const float dx = __fsub_rn(xi, p.x);
          const float dy = __fsub_rn(yi, p.y);
          d2[u] = __fmaf_rn(dx, dx, __fmul_rn(dy, dy));
          close[u] = in & (d2[u] <= r_tx2) & ((zi & zj) != 0) &
                     (c0 + lj != i);
        }
        unsigned any = 0;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const unsigned word = __ballot_sync(kFull, close[u]);
          if (lane == w0 + u) mine = word;
          any |= word;
        }
        if (any == 0) continue;           // uniform: no close pair here
        // Candidates: close, not in contact the slot before, both
        // eligible. Word w's prev bits come from lane w.
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const unsigned prev = __shfl_sync(kFull, pv, (w0 + u) & 31);
          const bool ej = se[lc[u]] != 0;
          const bool cand = close[u] & ei & ej & !((prev >> lane) & 1u);
          if (cand & (d2[u] < best_d2)) {  // strict: keeps the lane's first j
            best_d2 = d2[u];
            best = c0 + ((s * 32 + w0 + u) << 5) + lane;
          }
        }
      }
      if (lane < swords) crow[w_base + s * 32 + lane] =
          static_cast<int32_t>(mine);
      pv = pv_next;
    }
  }
  if (!row_ok) return;
  if (__any_sync(kFull, best != INT_MAX)) {  // uniform: a candidate exists
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(kFull, best_d2, off);
      const int oj = __shfl_xor_sync(kFull, best, off);
      if (od < best_d2 || (od == best_d2 && oj < best)) {
        best_d2 = od;
        best = oj;
      }
    }
  }
  if (lane == 0) {
    const bool h = best != INT_MAX;
    best_j[row] = h ? best : -1;
    has[row] = h ? 1 : 0;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched). The
// wrapper gives `chunk`, the columns staged at once (a multiple of 32
// unless it is all of n), and `smem`, the dynamic shared bytes (13 a
// staged column).
extern "C" int pairwise_contacts_launch(const void* x, const void* y,
                                        const void* zw, const void* elig,
                                        const void* prevw, void* closew,
                                        void* best_j, void* has, int b, int n,
                                        int nw, float r_tx2, int chunk,
                                        int smem, void* stream) {
  if (b == 0 || n == 0) return 0;
  if (chunk < 1 || chunk > kMaxChunk || (chunk < n && chunk % 32 != 0) ||
      smem < 13 * chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  static int granted = 48 * 1024;         // dynamic shared bytes allowed
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        pairwise_contacts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = smem;
  }
  const dim3 grid((n + kRows - 1) / kRows, b);
  pairwise_contacts_kernel<<<grid, kRows * 32, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const int32_t*>(zw), static_cast<const uint8_t*>(elig),
      static_cast<const int32_t*>(prevw), static_cast<int32_t*>(closew),
      static_cast<int32_t*>(best_j), static_cast<uint8_t*>(has), n, nw, r_tx2,
      chunk);
  return static_cast<int>(cudaGetLastError());
}
