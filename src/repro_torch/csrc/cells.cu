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
// cap = 9) that is some 26 MB, so device memory bounds it.
//
// The design: one block per strip of `strip` consecutive interior cells
// along a grid row (cells cx, cy0 .. cy0 + strip - 1). Those cells' 3x3
// neighbourhoods are three runs of strip + 2 consecutive padded cells, one
// per neighbour row (padded id (cx + r) (ncy + 2) + cy0 + [0, strip + 2),
// r = 0, 1, 2), and each plane keeps a cell's cap slots together, so the
// block stages each plane as 3 contiguous runs of (strip + 2) cap values,
// read by consecutive threads. One warp per row slot (cell, slot) walks its
// candidates 32 at a time (candidate k of cell c at a staged offset
// cand[k] + c cap, the table built once a block), and one __ballot_sync
// gives each packed word, kept in shared memory; the strip's words,
// out[b, cx ncy + cy0 .. ][..], are one contiguous run of strip x cap x
// nwords words, written by consecutive threads at the end. Row slots with
// zone word 0 (every empty slot) keep zero words without a pass over the
// candidates, as the reference computes only the others: at the city-scale
// point 12,800 nodes fill about 1.4% of the 916 k slots. strip is 32 (3190 blocks at the
// 319 x 319 grid) unless the staging would pass 96 KB of shared memory,
// then halved until it fits (cap 40: 16), so every cap whose single cell
// fits still runs. The earlier design (one block per interior cell,
// 101,761 blocks of at most 8 warps at that grid, 9 scattered gathers a
// cell and each word stored alone) spent its time on block scheduling and
// scattered accesses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStrip = 32;                  // interior cells a block
constexpr int kBatch = 4;                      // loads a thread has in flight
constexpr size_t kSmemBudget = 96 * 1024;      // staging a block, at most
constexpr size_t kSmemMax = 227 * 1024;        // a block's shared memory

// Shared memory of a strip: four planes x 3 runs of (strip + 2) cap slots,
// the candidates' offsets, the strip's words, and the list of its rows to
// compute with its length.
size_t strip_smem(int strip, int cap, int nwords) {
  return sizeof(float) * 4 * 3 * static_cast<size_t>(strip + 2) * cap +
         sizeof(int32_t) * 9 * static_cast<size_t>(cap) +
         sizeof(int32_t) * static_cast<size_t>(strip) * cap * (nwords + 1) +
         sizeof(int32_t);
}

__global__ void __launch_bounds__(kThreads)
cell_close_words_kernel(const float* __restrict__ xc,
                        const float* __restrict__ yc,
                        const int32_t* __restrict__ zc,
                        const int32_t* __restrict__ idc,
                        int32_t* __restrict__ out,
                        int ncx, int ncy, int cap, int nwords, int strip,
                        float r_tx2) {
  extern __shared__ float4 smem4[];
  const int run = (strip + 2) * cap;      // one neighbour row's slots
  float* sx = reinterpret_cast<float*>(smem4);   // [3][run]
  float* sy = sx + 3 * run;
  int32_t* sz = reinterpret_cast<int32_t*>(sy + 3 * run);
  int32_t* si = sz + 3 * run;
  int32_t* cand = si + 3 * run;           // [9 cap]
  int32_t* sw = cand + 9 * cap;           // [strip][cap][nwords]
  int32_t* live = sw + strip * cap * nwords;  // [strip cap] rows to compute
  int32_t* n_live = live + strip * cap;

  const int cy0 = blockIdx.x * strip, cx = blockIdx.y, b = blockIdx.z;
  const int cells = min(strip, ncy - cy0);
  const int stride = ncy + 2;
  const int len = (cells + 2) * cap;      // slots staged of each row
  const size_t plane =
      static_cast<size_t>(b) * (ncx + 2) * stride * cap;

  const int ncand = 9 * cap;
  const int rows = cells * cap;
  if (threadIdx.x == 0) *n_live = 0;
  // Each thread's loads of a batch issued before it stores any.
  for (int base = 0; base < 3 * len; base += kBatch * kThreads) {
    float vx[kBatch], vy[kBatch];
    int32_t vz[kBatch], vi[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = base + u * kThreads + threadIdx.x;
      if (e < 3 * len) {
        const int r = e / len, k = e - r * len;
        const size_t src =
            plane + (static_cast<size_t>(cx + r) * stride + cy0) * cap + k;
        vx[u] = xc[src];
        vy[u] = yc[src];
        vz[u] = zc[src];
        vi[u] = idc[src];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = base + u * kThreads + threadIdx.x;
      if (e < 3 * len) {
        const int r = e / len, dst = r * run + (e - r * len);
        sx[dst] = vx[u];
        sy[dst] = vy[u];
        sz[dst] = vz[u];
        si[dst] = vi[u];
      }
    }
  }
  // Candidate k of cell c sits at cand[k] + c cap: neighbour row k / cap
  // / 3, cell c + (k / cap) % 3 of that row's run, slot k % cap.
  for (int k = threadIdx.x; k < ncand; k += kThreads) {
    const int nb = k / cap;
    cand[k] = (nb / 3) * run + (nb % 3) * cap + (k - nb * cap);
  }
  for (int e = threadIdx.x; e < rows * nwords; e += kThreads) sw[e] = 0;
  __syncthreads();

  // A row slot with zone word 0 (every empty slot) shares no zone with any
  // candidate: its words stay 0, as the reference leaves them. The others
  // go on a list (in any order: each row's words are its own).
  for (int row = threadIdx.x; row < rows; row += kThreads) {
    const int c = row / cap;
    if (sz[run + (c + 1) * cap + (row - c * cap)] != 0)
      live[atomicAdd(n_live, 1)] = row;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int l = warp; l < *n_live; l += kThreads / 32) {
    const int row = live[l], c = row / cap;
    const int ctr = run + (c + 1) * cap + (row - c * cap);  // row 1, cell c + 1
    const int32_t zi = sz[ctr];
    const float xi = sx[ctr];
    const float yi = sy[ctr];
    const int32_t ii = si[ctr];
    for (int w = 0; w < nwords; ++w) {
      const int j = 32 * w + lane;        // candidate j of the 3x3
      bool close = false;
      if (j < ncand) {
        const int k = cand[j] + c * cap;  // its staged slot
        const float dx = __fsub_rn(xi, sx[k]);
        const float dy = __fsub_rn(yi, sy[k]);
        const float d2 = __fmaf_rn(dx, dx, __fmul_rn(dy, dy));
        const int32_t ik = si[k];
        close = (d2 <= r_tx2) && ((zi & sz[k]) != 0) && (ii != ik) &&
                (ik >= 0);
      }
      const unsigned word = __ballot_sync(0xffffffffu, close);
      if (lane == 0) sw[row * nwords + w] = static_cast<int32_t>(word);
    }
  }
  __syncthreads();

  int32_t* dst = out + (static_cast<size_t>(b) * ncx * ncy +
                        static_cast<size_t>(cx) * ncy + cy0) * cap * nwords;
  for (int e = threadIdx.x; e < rows * nwords; e += kThreads) dst[e] = sw[e];
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue when one cell's staging passes the shared memory.
extern "C" int cell_close_words_launch(const void* xc, const void* yc,
                                       const void* zc, const void* idc,
                                       void* out, int b, int ncx, int ncy,
                                       int cap, int nwords, float r_tx2,
                                       void* stream) {
  if (b == 0 || ncx == 0 || ncy == 0 || cap == 0) return 0;
  int strip = kMaxStrip;
  while (strip > 1 && strip_smem(strip, cap, nwords) > kSmemBudget) strip /= 2;
  const size_t smem = strip_smem(strip, cap, nwords);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool ready[64] = {};
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(cell_close_words_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemMax));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  const dim3 grid((ncy + strip - 1) / strip, ncx, b);
  cell_close_words_kernel<<<grid, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xc), static_cast<const float*>(yc),
      static_cast<const int32_t*>(zc), static_cast<const int32_t*>(idc),
      static_cast<int32_t*>(out), ncx, ncy, cap, nwords, strip, r_tx2);
  return static_cast<int>(cudaGetLastError());
}
