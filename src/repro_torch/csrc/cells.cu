// The cell-list backend's 3x3-cell close pass for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel repro/kernels/contacts.py::cell_close_words
// (body _cell_kernel). The inputs are four cell-major planes of shape
// (B, n_pad_cells, cap) on a padded grid of (ncx + 2) x (ncy + 2) cells
// whose border ring is empty: x, y (float32), the zone word (int32 bits) and
// the node id (int32, -1 for an empty slot). For every batch item b,
// interior cell c (row-major) and row slot i it emits
//   out[b, c, i, w]  bit (k % 32) of word w = k / 32 is candidate k of the
//                    cell's 3x3 neighbourhood (neighbour cell k / cap in
//                    (dx, dy) row-major order, slot k % cap):
//                    d2 <= r_tx2 && (z_i & z_k) != 0 && id_i != id_k
//                    && id_k >= 0   (LSB-first, pad bits zero).
// d2 = fma(dx, dx, dy*dy) with dx = x_i - x_k, rounded exactly as jitted XLA
// rounds the reference's dx*dx + dy*dy; the intrinsics keep nvcc from
// choosing, and the build passes --fmad=false.
//
// What bounds it: each plane is read once and each word written once,
// 16 bytes per padded slot plus 4 per word, with about 5 float32 operations
// per (row, candidate) pair; at the city-scale point (a 319 x 319 grid,
// cap = 9) that is some 26 MB, so device memory bounds it. The design: one
// block per (batch item, interior cell); its 9 * cap candidates of the four
// planes are staged once in shared memory (the border ring keeps every
// neighbour offset in bounds), one warp per row slot walks the candidates
// 32 at a time, and one __ballot_sync gives each packed word, written by
// lane 0. Empty row slots carry zone 0 and give zero words, as in the
// reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;              // row slots in flight per block

__global__ void __launch_bounds__(kMaxWarps * 32)
cell_close_words_kernel(const float* __restrict__ xc,
                        const float* __restrict__ yc,
                        const int32_t* __restrict__ zc,
                        const int32_t* __restrict__ idc,
                        int32_t* __restrict__ out,
                        int ncx, int ncy, int cap, int nwords, float r_tx2) {
  extern __shared__ unsigned char smem[];
  const int ncand = 9 * cap;
  float* sx = reinterpret_cast<float*>(smem);
  float* sy = sx + ncand;
  int32_t* sz = reinterpret_cast<int32_t*>(sy + ncand);
  int32_t* si = sz + ncand;

  const int cell = blockIdx.x;            // interior cell, row-major
  const int b = blockIdx.y;
  const int stride = ncy + 2;
  const int pid = (cell / ncy + 1) * stride + (cell % ncy + 1);
  const size_t n_pad = static_cast<size_t>(ncx + 2) * stride;
  const size_t plane = static_cast<size_t>(b) * n_pad * cap;

  for (int k = threadIdx.x; k < ncand; k += blockDim.x) {
    const int nb = k / cap;               // neighbour cell 0..8
    const int off = (nb / 3 - 1) * stride + (nb % 3 - 1);
    const size_t src = plane + static_cast<size_t>(pid + off) * cap + k % cap;
    sx[k] = xc[src];
    sy[k] = yc[src];
    sz[k] = zc[src];
    si[k] = idc[src];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int center = 4 * cap;             // the cell itself in the 3x3 order
  int32_t* cell_out =
      out + (static_cast<size_t>(b) * ncx * ncy + cell) * cap * nwords;
  for (int i = threadIdx.x >> 5; i < cap; i += warps) {
    const float xi = sx[center + i];
    const float yi = sy[center + i];
    const int32_t zi = sz[center + i];
    const int32_t ii = si[center + i];
    for (int w = 0; w < nwords; ++w) {
      const int k = 32 * w + lane;
      bool close = false;
      if (k < ncand) {
        const float dx = __fsub_rn(xi, sx[k]);
        const float dy = __fsub_rn(yi, sy[k]);
        const float d2 = __fmaf_rn(dx, dx, __fmul_rn(dy, dy));
        const int32_t ik = si[k];
        close = (d2 <= r_tx2) && ((zi & sz[k]) != 0) && (ii != ik) &&
                (ik >= 0);
      }
      const unsigned word = __ballot_sync(0xffffffffu, close);
      if (lane == 0) cell_out[i * nwords + w] = static_cast<int32_t>(word);
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int cell_close_words_launch(const void* xc, const void* yc,
                                       const void* zc, const void* idc,
                                       void* out, int b, int ncx, int ncy,
                                       int cap, int nwords, float r_tx2,
                                       void* stream) {
  if (b == 0 || ncx == 0 || ncy == 0 || cap == 0) return 0;
  const int warps = cap < kMaxWarps ? cap : kMaxWarps;
  const size_t smem = static_cast<size_t>(9) * cap * 16;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(ncx * ncy, b);
  cell_close_words_kernel<<<grid, warps * 32, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xc), static_cast<const float*>(yc),
      static_cast<const int32_t*>(zc), static_cast<const int32_t*>(idc),
      static_cast<int32_t*>(out), ncx, ncy, cap, nwords, r_tx2);
  return static_cast<int>(cudaGetLastError());
}
