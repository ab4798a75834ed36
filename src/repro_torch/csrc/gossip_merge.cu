// Row-wise gossip merges for Hopper (sm_90a): the Gossip-Learning layer's
// delivery merge.
//
// Replaces the TPU Pallas kernels repro/kernels/gossip_merge.py::
// gossip_merge_rows (body _rows_kernel) and gossip_merge_rows_scaled (body
// _rows_scaled_kernel). Over rows r of own and peer (R, D) float32:
//   rows:   out[r] = s[r] ? fma(1 - w[r], peer[r], w[r] * own[r]) : own[r]
//   scaled: out[r] = s[r] ? fma(1 - w[r], c[r] * peer[r], w[r] * own[r])
//                         : own[r]
//   scaled, fold = 1:
//           out[r] = s[r] ? fma((1 - w[r]) * c[r], peer[r], w[r] * own[r])
//                         : own[r]
// with w, c float32 and s bool per row. The operand orders are the ones
// the reference's jitted simulator contracts w*own + (1-w)*peer and
// w*own + (1-w)*(c*peer) into: the scaled merge is the plain one of the
// rounded c*peer, except under a constant weight (the uniform policy),
// where the simulator folds 1-w into the scale (fold = 1). The intrinsics
// keep nvcc from choosing, and the library is built with --fmad=false. An
// unselected row is own, bit for bit, whatever peer holds (NaN and inf
// included).
//
// What bounds it: bytes. own is read and out written in full; peer, w and
// the scale are needed only on the k selected rows, s on every row:
// 2*R*D*4 + k*D*4 + R + 4k bytes (+ 4k scaled), with 3 or 4 float
// operations per selected element. At the simulator's R = 200, D = 34 that
// is at most about 83 KB (every row selected), some 25 ns at the H100's
// 3.35 TB/s, so the launch latency dominates. The design is the simplest that moves each byte once: one
// thread per element, consecutive threads on consecutive elements of a row
// (coalesced), the per-row scalars read from cache. The TPU kernel's
// (256-row, 128-lane) padded tiles have no counterpart: the kernel masks the
// ragged end itself and pads nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
merge_rows_kernel(const float* __restrict__ own,
                  const float* __restrict__ peer,
                  const float* __restrict__ w,
                  const uint8_t* __restrict__ s,
                  float* __restrict__ out, int64_t total, int d) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= total) return;
  const int64_t r = k / d;
  const float o = own[k];
  if (!s[r]) {
    out[k] = o;
    return;
  }
  const float wr = w[r];
  out[k] = __fmaf_rn(__fsub_rn(1.f, wr), peer[k], __fmul_rn(wr, o));
}

__global__ void __launch_bounds__(kThreads)
merge_rows_scaled_kernel(const float* __restrict__ own,
                         const float* __restrict__ peer,
                         const float* __restrict__ w,
                         const float* __restrict__ scale,
                         const uint8_t* __restrict__ s,
                         float* __restrict__ out, int64_t total, int d,
                         int fold) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= total) return;
  const int64_t r = k / d;
  const float o = own[k];
  if (!s[r]) {
    out[k] = o;
    return;
  }
  const float wr = w[r];
  out[k] = fold ? __fmaf_rn(__fmul_rn(__fsub_rn(1.f, wr), scale[r]), peer[k],
                            __fmul_rn(wr, o))
                : __fmaf_rn(__fsub_rn(1.f, wr), __fmul_rn(scale[r], peer[k]),
                            __fmul_rn(wr, o));
}

unsigned blocks(int64_t total) {
  return static_cast<unsigned>((total + kThreads - 1) / kThreads);
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 = launched).
extern "C" int gossip_merge_rows_launch(const void* own, const void* peer,
                                        const void* w, const void* s,
                                        void* out, long long rows, int d,
                                        void* stream) {
  const int64_t total = static_cast<int64_t>(rows) * d;
  if (total == 0) return 0;
  merge_rows_kernel<<<blocks(total), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(own), static_cast<const float*>(peer),
      static_cast<const float*>(w), static_cast<const uint8_t*>(s),
      static_cast<float*>(out), total, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gossip_merge_rows_scaled_launch(const void* own,
                                               const void* peer,
                                               const void* w,
                                               const void* scale,
                                               const void* s, void* out,
                                               long long rows, int d,
                                               int fold, void* stream) {
  const int64_t total = static_cast<int64_t>(rows) * d;
  if (total == 0) return 0;
  merge_rows_scaled_kernel<<<blocks(total), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(own), static_cast<const float*>(peer),
      static_cast<const float*>(w), static_cast<const float*>(scale),
      static_cast<const uint8_t*>(s), static_cast<float*>(out), total, d,
      fold);
  return static_cast<int>(cudaGetLastError());
}
