// Gossip merges for Hopper (sm_90a): the gossip round's whole-leaf merge
// and the Gossip-Learning layer's row-wise delivery merges.
//
// gossip_merge replaces the TPU Pallas kernel repro/kernels/gossip_merge.py::
// gossip_merge (body _kernel, wrapper _merge_pallas). Over a flat leaf of n
// elements of T = float or __nv_bfloat16, with one float w and one bool s
// read from device memory:
//   out[k] = s ? T(fma(1 - w, float(peer[k]), w * float(own[k]))) : own[k]
// or, with own_first,
//   out[k] = s ? T(fma(w, float(own[k]), (1 - w) * float(peer[k]))) : own[k]
// 1 - w is rounded to float once; the float result is rounded to T once
// (__float2bfloat16_rn: to nearest even). The operand orders are the two
// XLA contracts w*own + (1-w)*peer into inside the reference's jitted gossip
// round: the first for whole leaves, the second for float32 leaves of one
// element and for the segmented round's float32 segments. An unselected
// element is own's bits, copied, and peer is not read.
//
// What bounds it: bytes. With s, own and peer are read and out written once:
// 12 B an element in float32, 6 B in bfloat16; without s, 8 or 4 B. The
// largest leaf of h2o-danube-3-4b, the 32768 x 3840 bfloat16 embedding, is
// 755 MB merged, some 225 us at the H100's 3.35 TB/s. The design moves each
// byte once in 16-byte accesses: a grid-stride loop over 16-byte vectors (4
// float or 8 bfloat16 a thread), then a scalar tail; w and s are read once
// per thread (the TPU kernel prefetches them to SMEM). The TPU kernel's
// 16K-element padded blocks have no counterpart: nothing is padded. A leaf
// whose own, peer or out is not 16-byte aligned takes the scalar loop.
//
// gossip_merge_rows and gossip_merge_rows_scaled replace the TPU Pallas
// kernels repro/kernels/gossip_merge.py::gossip_merge_rows (body
// _rows_kernel) and gossip_merge_rows_scaled (body _rows_scaled_kernel).
// Over rows r of own and peer (R, D) float32:
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
// What bounds the row merges: the launch. own is read and out written in
// full; peer, w and the scale are needed only on the k selected rows, s on
// every row: 2*R*D*4 + k*D*4 + R + 4k bytes (+ 4k scaled), with 3 or 4 float
// operations per selected element. At the simulator's R = 200, D = 34 that
// is at most about 83 KB (every row selected), some 25 ns at the H100's
// 3.35 TB/s, far below the card's floor for starting and retiring a kernel.
// What a launch costs beyond that floor is the chain of dependent loads in
// a thread, and its arithmetic. Both kernels take one thread per element,
// consecutive threads on consecutive elements of a row (coalesced), and pad
// nothing (the TPU kernels' (256-row, 128-lane) tiles have no counterpart).
//
// gossip_merge_rows' first design (still the scaled kernel's) loaded s[r],
// branched on it, and only then loaded w[r] and peer[k]: two rounds of
// loads where one does; and it found the row by a 64-bit division, a chain
// of dependent instructions ahead of every load. Now own[k], peer[k], w[r] and
// s[r] are four independent loads issued together and s selects the result
// (an unselected row is still own's bits: the merged value of a NaN or inf
// peer is computed and dropped); the row is one 64-bit high multiply by a
// reciprocal the host computes (row_of), on 32-bit indices, wherever R*D <
// 2^31 - 256; larger shapes take a second instance with a 64-bit index and
// a division. Blocks of 256 threads make R = 200, D = 34 a grid of 27
// blocks, each on an SM of its own, all in one wave.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

// k / d for k, d < 2^32 by one 64-bit high multiply: magic = ceil(2^64 / d)
// (row_magic), 0 for d = 1. Exact: k * magic / 2^64 = k / d + k * e / 2^64
// with 0 <= e < 1, and k * e / 2^64 < 1 / d since k * d < 2^64.
__device__ __forceinline__ unsigned row_of(unsigned k,
                                           unsigned long long magic) {
  return magic ? static_cast<unsigned>(__umul64hi(k, magic)) : k;
}

unsigned long long row_magic(int d) {
  return d == 1 ? 0ull : ~0ull / static_cast<unsigned>(d) + 1;
}

// Wide: a 64-bit index and a division, for shapes of 2^31 - 256 elements
// or more; otherwise 32-bit indices and row_of.
template <bool Wide>
__global__ void __launch_bounds__(kThreads)
merge_rows_kernel(const float* __restrict__ own,
                  const float* __restrict__ peer,
                  const float* __restrict__ w,
                  const uint8_t* __restrict__ s,
                  float* __restrict__ out, int64_t total, int d,
                  unsigned long long magic) {
  using Idx = typename std::conditional<Wide, int64_t, unsigned>::type;
  const Idx k = static_cast<Idx>(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= total) return;
  Idx r;
  if constexpr (Wide)
    r = k / d;
  else
    r = row_of(k, magic);
  const float o = own[k];
  const float wr = w[r];
  const bool sel = s[r] != 0;
  const float m = __fmaf_rn(__fsub_rn(1.f, wr), peer[k], __fmul_rn(wr, o));
  out[k] = sel ? m : o;
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

template <typename T, bool OwnFirst>
__device__ __forceinline__ T merge_one(T o, T p, float w, float omw) {
  T r;
  if (OwnFirst)
    from_f32(__fmaf_rn(w, to_f32(o), __fmul_rn(omw, to_f32(p))), &r);
  else
    from_f32(__fmaf_rn(omw, to_f32(p), __fmul_rn(w, to_f32(o))), &r);
  return r;
}

// One grid-stride pass: 16-byte vectors first (when vec), then the scalar
// elements after them; each index is written once.
template <typename T, bool OwnFirst>
__global__ void __launch_bounds__(kThreads)
merge_flat_kernel(const T* __restrict__ own, const T* __restrict__ peer,
                  const float* __restrict__ w, const uint8_t* __restrict__ s,
                  T* __restrict__ out, int64_t n, int vec) {
  constexpr int kV = 16 / sizeof(T);
  const bool sel = __ldg(s) != 0;
  const float wr = __ldg(w);
  const float omw = __fsub_rn(1.f, wr);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t nvec = vec ? n / kV : 0;
  const uint4* own4 = reinterpret_cast<const uint4*>(own);
  const uint4* peer4 = reinterpret_cast<const uint4*>(peer);
  uint4* out4 = reinterpret_cast<uint4*>(out);
  for (int64_t i = tid; i < nvec; i += stride) {
    const uint4 ov = own4[i];
    if (!sel) {
      out4[i] = ov;
      continue;
    }
    const uint4 pv = peer4[i];
    uint4 rv;
    const T* oe = reinterpret_cast<const T*>(&ov);
    const T* pe = reinterpret_cast<const T*>(&pv);
    T* re = reinterpret_cast<T*>(&rv);
#pragma unroll
    for (int j = 0; j < kV; ++j)
      re[j] = merge_one<T, OwnFirst>(oe[j], pe[j], wr, omw);
    out4[i] = rv;
  }
  for (int64_t k = nvec * kV + tid; k < n; k += stride) {
    out[k] = sel ? merge_one<T, OwnFirst>(own[k], peer[k], wr, omw)
                 : own[k];
  }
}

// A grid of at most 16 blocks per SM of the H100's 132; each thread then
// walks a few vectors.
template <typename T>
int launch_flat(const void* own, const void* peer, const void* w,
                const void* s, void* out, int64_t n, int vec, int own_first,
                cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const int64_t items = vec ? n / kV + (n % kV) : n;
  const int64_t want = (items + kThreads - 1) / kThreads;
  const unsigned grid =
      static_cast<unsigned>(want < 132 * 16 ? want : 132 * 16);
  const T* o = static_cast<const T*>(own);
  const T* p = static_cast<const T*>(peer);
  const float* wf = static_cast<const float*>(w);
  const uint8_t* sf = static_cast<const uint8_t*>(s);
  T* r = static_cast<T*>(out);
  if (own_first)
    merge_flat_kernel<T, true><<<grid, kThreads, 0, stream>>>(o, p, wf, sf,
                                                               r, n, vec);
  else
    merge_flat_kernel<T, false><<<grid, kThreads, 0, stream>>>(o, p, wf, sf,
                                                                r, n, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int gossip_merge_rows_launch(const void* own, const void* peer,
                                        const void* w, const void* s,
                                        void* out, long long rows, int d,
                                        void* stream) {
  const int64_t total = static_cast<int64_t>(rows) * d;
  if (total == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* o = static_cast<const float*>(own);
  const float* p = static_cast<const float*>(peer);
  const float* wf = static_cast<const float*>(w);
  const uint8_t* sf = static_cast<const uint8_t*>(s);
  float* r = static_cast<float*>(out);
  if (total <= INT32_MAX - kThreads)   // k stays below 2^31
    merge_rows_kernel<false><<<blocks(total), kThreads, 0, st>>>(
        o, p, wf, sf, r, total, d, row_magic(d));
  else
    merge_rows_kernel<true><<<blocks(total), kThreads, 0, st>>>(
        o, p, wf, sf, r, total, d, 0);
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

// dtype: 0 = float32, 1 = bfloat16; vec: own, peer and out are 16-byte
// aligned; own_first: the fma(w, own, (1-w)*peer) order. w: one float, s:
// one bool, both in device memory.
extern "C" int gossip_merge_launch(const void* own, const void* peer,
                                   const void* w, const void* s, void* out,
                                   long long n, int dtype, int vec,
                                   int own_first, void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_flat<float>(own, peer, w, s, out, n, vec, own_first, st);
  if (dtype == 1)
    return launch_flat<__nv_bfloat16>(own, peer, w, s, out, n, vec,
                                      own_first, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
