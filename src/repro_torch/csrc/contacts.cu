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
// What bounds it: every input is read once and every output written once
// (18 bytes per node plus 8 bytes per packed word of prevw and closew),
// with 5 float32 operations per pair. At the paper's N = 200 that is
// nanoseconds of work on an H100, so the launch latency dominates. The design keeps the
// (N, N) distance and contact matrices out of device memory, as the TPU
// kernel keeps them in VMEM: one warp per row, the column coordinates,
// zone words and eligibility staged through shared memory in chunks of
// 256 that all eight rows of the block reuse, one __ballot_sync per 32
// columns giving exactly one packed word, and a warp-shuffle argmin over
// (d2, j) pairs that takes the smaller j on equal d2.

#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>
#include <cmath>

namespace {

constexpr int kWarps = 8;                 // rows per block, one warp each
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = kThreads;          // columns staged per pass (32-aligned)

__global__ void __launch_bounds__(kThreads)
pairwise_contacts_kernel(const float* __restrict__ x,
                         const float* __restrict__ y,
                         const int32_t* __restrict__ zw,
                         const uint8_t* __restrict__ elig,
                         const int32_t* __restrict__ prevw,
                         int32_t* __restrict__ closew,
                         int32_t* __restrict__ best_j,
                         uint8_t* __restrict__ has,
                         int n, int nw, float r_tx2) {
  __shared__ float sx[kChunk];
  __shared__ float sy[kChunk];
  __shared__ int32_t sz[kChunk];
  __shared__ uint8_t se[kChunk];

  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool row_ok = i < n;              // uniform across the warp
  const size_t base = static_cast<size_t>(blockIdx.y) * n;

  float xi = 0.f, yi = 0.f;
  int32_t zi = 0;
  bool ei = false;
  if (row_ok) {
    xi = x[base + i];
    yi = y[base + i];
    zi = zw[base + i];
    ei = elig[base + i] != 0;
  }

  float best_d2 = INFINITY;
  int best = INT_MAX;
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    __syncthreads();                      // the previous chunk is consumed
    const int jt = c0 + threadIdx.x;
    if (jt < n) {
      sx[threadIdx.x] = x[base + jt];
      sy[threadIdx.x] = y[base + jt];
      sz[threadIdx.x] = zw[base + jt];
      se[threadIdx.x] = elig[base + jt];
    }
    __syncthreads();
    if (!row_ok) continue;
    const int cend = min(kChunk, n - c0);
    const int32_t* prow = prevw + (base + i) * nw;
    int32_t* crow = closew + (base + i) * nw;
    for (int w0 = 0; w0 < cend; w0 += 32) {
      const int lj = w0 + lane;
      const int j = c0 + lj;
      bool close = false;
      bool col_elig = false;
      float d2 = 0.f;
      if (lj < cend) {
        const float dx = __fsub_rn(xi, sx[lj]);
        const float dy = __fsub_rn(yi, sy[lj]);
        d2 = __fmaf_rn(dx, dx, __fmul_rn(dy, dy));
        close = (d2 <= r_tx2) && ((zi & sz[lj]) != 0) && (j != i);
        col_elig = se[lj] != 0;
      }
      const unsigned word = __ballot_sync(0xffffffffu, close);
      const int wi = (c0 + w0) >> 5;
      if (lane == 0) crow[wi] = static_cast<int32_t>(word);
      const unsigned prev = static_cast<unsigned>(prow[wi]);
      const bool cand = close && ei && col_elig && !((prev >> lane) & 1u);
      if (cand && d2 < best_d2) {         // strict: keeps the first j
        best_d2 = d2;
        best = j;
      }
    }
  }
  if (!row_ok) return;
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, best_d2, off);
    const int oj = __shfl_xor_sync(0xffffffffu, best, off);
    if (od < best_d2 || (od == best_d2 && oj < best)) {
      best_d2 = od;
      best = oj;
    }
  }
  if (lane == 0) {
    const bool h = best != INT_MAX;
    best_j[base + i] = h ? best : -1;
    has[base + i] = h ? 1 : 0;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int pairwise_contacts_launch(const void* x, const void* y,
                                        const void* zw, const void* elig,
                                        const void* prevw, void* closew,
                                        void* best_j, void* has, int b, int n,
                                        int nw, float r_tx2, void* stream) {
  if (b == 0 || n == 0) return 0;
  const dim3 grid((n + kWarps - 1) / kWarps, b);
  pairwise_contacts_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const int32_t*>(zw), static_cast<const uint8_t*>(elig),
      static_cast<const int32_t*>(prevw), static_cast<int32_t*>(closew),
      static_cast<int32_t*>(best_j), static_cast<uint8_t*>(has), n, nw, r_tx2);
  return static_cast<int>(cudaGetLastError());
}
