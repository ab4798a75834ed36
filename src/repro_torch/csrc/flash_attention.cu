// Flash attention for Hopper (sm_90a): online-softmax attention over a
// GQA layout, causal and/or sliding-window, queries right-aligned.
//
// Replaces the TPU Pallas kernel repro/kernels/flash_attention.py::
// flash_attention (body _kernel, wrapper flash_attention, pallas_call),
// which repro's kernels/ops.py::attention_op calls on (B*H, S, D) after
// repeating the KV heads. Over q (B, Sq, H, D) and k, v (B, Skv, Hkv, D)
// of T = float or __nv_bfloat16, with G = H / Hkv and query head h
// reading KV head h / G (what jnp.repeat(k, G, axis=2) means; no repeated
// copy is made), it computes for every (b, i, h):
//   q_pos = i + Skv - Sq, k_pos = j
//   s_j = (float(q) * scale) . float(k_j), scale = float(D ** -0.5)
//   valid_j = k_pos < Skv [&& q_pos >= k_pos if causal]
//             [&& q_pos - k_pos < window if window > 0]
//   s_j = valid_j ? s_j : -1e30
//   out = T(sum_j exp(s_j - m) v_j / max(sum_j exp(s_j - m), 1e-30))
// with the running max m, sum l and accumulator in float32, updated tile
// by tile as the TPU kernel does (corr = exp(m_old - m_new)). The library
// is built without fast math.
//
// Every query row must have a valid key (the wrapper refuses causal with
// Sq > Skv). A tile that is wholly masked for a row while the row's max is
// still -1e30 adds exp(0) = 1 per masked key, as the TPU kernel's does;
// the first valid key's corr = exp(-1e30 - m) = 0 wipes it.
//
// Three forms of the one function, chosen by the wrapper from the shape
// and dtype alone (kernels/flash_attention.py::_form), each replacing the
// same TPU kernel:
//
// * flash_mma_kernel, bf16 with Sq > 1 (prefill). Bound by operations:
//   prefill of h2o-danube-3-4b (B = 1, S = 8192, H = 32, Hkv = 8, D =
//   120, window 4096) has 25,167,872 unmasked pairs a head and 4 D
//   operations a pair, 3.87e11 in all: 0.391 ms at 989 TFLOP/s (bf16
//   tensor cores), against 157 MB moved (0.047 ms). So both products run
//   on the tensor cores (wgmma, float32 accumulators): a block holds 128
//   query rows of one (batch, KV head), the G heads of a position packed
//   together, two warpgroups of 64 rows each, so each K/V tile is read
//   once for all G heads and both warpgroups. S = Q K^T is m64n64k16 from
//   shared memory (Q and K both K-major); scale (times log2 e) is applied
//   to the float32 scores after the product and the softmax uses exp2f;
//   P is rounded to bf16 in registers and is wgmma's A operand for O += P
//   V, V read transposed (MN-major) from the same shared-memory layout as
//   K. Rounding P to bf16 is the one rounding the TPU kernel does not do
//   (SDPA and FlashAttention 2 and 3 do it). Tiles of 64 keys go into a
//   2-stage ring filled by cp.async (16-byte copies, zero-filled past Skv
//   and past D by the src-size operand), tile t + 1 in flight while tile t
//   computes; D is padded to 128 in shared memory only, each 64-column
//   half in the 128-byte swizzle the wgmma descriptors name. Layouts that
//   do not allow 16-byte copies (bf16 D = 67 or 100, a view one element
//   off) fill the same layout by scalar loads staged in registers (the
//   template flag VEC). Only tiles that meet the block's causal and window
//   band are visited, and only tiles at the band's edges are masked per
//   element.
//
// * flash_decode_kernel, float32 or bf16 with Sq = 1 (decode). Bound by
//   bytes: B = 8 requests over 128 valid slots of h2o-danube-3-4b's ring
//   cache move 4.06 MB of K, V, q and out, 1.21 us at 3.35 TB/s. A block
//   per (batch, KV head) holds that KV head's G query rows (4 at a pass);
//   its 8 warps split the valid keys (the window's band) into contiguous
//   slices. A key's D values lie across PL lanes, 16 bytes each (PL = 32
//   for float, 16 for bf16: 128 values, lanes past D load zeros; a
//   compile-time constant, so the shuffle reductions over D unroll and
//   interleave: with PL a runtime value the decode lost to SDPA). A warp
//   issues all the loads of a chunk of its slice (8 steps: 16 keys of D =
//   120 bf16; 16-byte loads where the layout allows, scalar loads
//   otherwise) before using any, scores by a warp reduction over D, and
//   keeps its own m, l and acc; a log-sum-exp merge of the 8 warps'
//   results in shared memory ends the launch (m = max m_w, l = sum l_w
//   exp(m_w - m), acc likewise): one launch, no second pass. An empty
//   slice contributes m = -1e30 and l = 0, which the merge wipes. Only 64
//   blocks run at that shape; splitting one request's keys across blocks
//   (flash-decoding), which long caches need, is left out.
//
// * flash_kernel, float32 with Sq > 1: the port's first design, kept for
//   float32, where the tolerance (2e-5) leaves no room for TF32. Float32
//   on the CUDA cores; a block per (batch, KV head, tile of bq query
//   positions) holds G * bq <= 64 query rows in shared memory (scaled,
//   float32), loops over K/V tiles of 32 keys in the causal and window
//   band (one key a lane in the scores), every load of a tile issued
//   before any store, in 16-byte chunks where the layout allows; D padded
//   to whole lanes in shared memory only; registers capped for two blocks
//   an SM.
//
// All three read q, k and v through their strides (the last dim
// contiguous), so the decode's cache[:, :n_valid] view needs no copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 32;                          // keys a tile: one a lane
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;     // query rows a block
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sqb, sqs, sqh, skb, sks, skh, svb, svs, svh;
  int sq, skv, h, d, g, bq, causal, window, vec;
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 16 bytes of T: loaded raw, stored to shared memory as kVals floats
// (times a scale). Callers keep the loads of a tile in registers and
// store them after, so their latencies overlap.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kVals = 4;
  __device__ static void store(float* dst, uint4 raw, float scale) {
    *reinterpret_cast<float4*>(dst) = make_float4(
        __fmul_rn(__uint_as_float(raw.x), scale),
        __fmul_rn(__uint_as_float(raw.y), scale),
        __fmul_rn(__uint_as_float(raw.z), scale),
        __fmul_rn(__uint_as_float(raw.w), scale));
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kVals = 8;
  __device__ static float2 pair(unsigned int w) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  }
  __device__ static void store(float* dst, uint4 raw, float scale) {
    const float2 a = pair(raw.x), b = pair(raw.y), c = pair(raw.z),
                 d = pair(raw.w);
    reinterpret_cast<float4*>(dst)[0] = make_float4(
        __fmul_rn(a.x, scale), __fmul_rn(a.y, scale),
        __fmul_rn(b.x, scale), __fmul_rn(b.y, scale));
    reinterpret_cast<float4*>(dst)[1] = make_float4(
        __fmul_rn(c.x, scale), __fmul_rn(c.y, scale),
        __fmul_rn(d.x, scale), __fmul_rn(d.y, scale));
  }
};

__device__ __forceinline__ uint4 load16(const void* src, bool in) {
  return in ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

// A butterfly: every lane adds the same partials in the same order, so
// every lane ends with the same sum.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

template <int NI>
__host__ __device__ constexpr int row_stride() { return 32 * NI + 4; }

template <int NI>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * ((kRows + 2 * kBK) * row_stride<NI>() +
                          kWarps * kRowsPerWarp * kBK);
}

template <typename T, int NI>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const Params p) {
  constexpr int DW = 32 * NI;          // head dim padded to whole lanes
  constexpr int DP = row_stride<NI>(); // DP / 4 odd: conflict-free float4
  constexpr int D4 = DW / 4;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [kRows][DP]
  float* k_s = q_s + kRows * DP;                  // [kBK][DP]
  float* v_s = k_s + kBK * DP;                    // [kBK][DP]
  float* p_s = v_s + kBK * DP;                    // [kWarps][kRowsPerWarp][kBK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int i0 = blockIdx.x * p.bq;
  const int i1 = min(p.sq, i0 + p.bq);
  const int nrows = (i1 - i0) * p.g;     // row r: position i0 + r / g,
  const int off = p.skv - p.sq;          // head hk * g + r % g
  const T* q = static_cast<const T*>(p.q) + b * p.sqb;
  const T* k = static_cast<const T*>(p.k) + b * p.skb + hk * p.skh;
  const T* v = static_cast<const T*>(p.v) + b * p.svb + hk * p.svh;

  // Every thread issues all its loads before it stores any, so their
  // latencies overlap: 16-byte chunks where p.vec (pointers 16-byte
  // aligned, strides and D multiples of a chunk), else single values.
  constexpr int QN = kRows * DW / kThreads, KN = kBK * DW / kThreads;
  constexpr int CV = Chunk<T>::kVals, CPR = DW / CV;   // chunks a row
  constexpr int QC = (kRows * CPR + kThreads - 1) / kThreads;
  constexpr int KC = (kBK * CPR + kThreads - 1) / kThreads;
  if (p.vec) {
    uint4 raw[QC];
#pragma unroll
    for (int n = 0; n < QC; ++n) {
      const int e = tid + n * kThreads, r = e / CPR, c = (e - r * CPR) * CV;
      const int i = i0 + r / p.g, h = hk * p.g + r % p.g;
      raw[n] = load16(q + i * p.sqs + h * p.sqh + c,
                      e < kRows * CPR && r < nrows && c < p.d);
    }
#pragma unroll
    for (int n = 0; n < QC; ++n) {
      const int e = tid + n * kThreads, r = e / CPR, c = (e - r * CPR) * CV;
      if (e < kRows * CPR) Chunk<T>::store(q_s + r * DP + c, raw[n], p.scale);
    }
  } else {
    float x[QN];
#pragma unroll
    for (int n = 0; n < QN; ++n) {
      const int e = tid + n * kThreads, r = e / DW, c = e - r * DW;
      const int i = i0 + r / p.g, h = hk * p.g + r % p.g;
      x[n] = r < nrows && c < p.d
                 ? __fmul_rn(to_float(q[i * p.sqs + h * p.sqh + c]), p.scale)
                 : 0.f;
    }
#pragma unroll
    for (int n = 0; n < QN; ++n) {
      const int e = tid + n * kThreads, r = e / DW, c = e - r * DW;
      q_s[r * DP + c] = x[n];
    }
  }

  // The keys the block's rows can see: the causal and window band.
  int klo = 0, khi = p.skv - 1;
  if (p.causal) khi = min(khi, i1 - 1 + off);
  if (p.window > 0) klo = max(klo, i0 + off - p.window + 1);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NI];
  int qpos[kRowsPerWarp];
#pragma unroll
  for (int t = 0; t < kRowsPerWarp; ++t) {
    m[t] = kNegInf;
    l[t] = 0.f;
#pragma unroll
    for (int n = 0; n < NI; ++n) acc[t][n] = 0.f;
    qpos[t] = i0 + (t * kWarps + warp) / p.g + off;
  }
  float* pw = p_s + warp * kRowsPerWarp * kBK;
  // This warp's rows t * kWarps + warp that hold a query (warp-uniform):
  // the others (a decode block has G of its 64) skip their arithmetic.
  const int nlive = max(0, min(kRowsPerWarp,
                               (nrows - warp + kWarps - 1) / kWarps));

  for (int tile = klo / kBK; klo <= khi && tile <= khi / kBK; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();   // q_s written; the last tile's readers are done
    if (p.vec) {
      uint4 rk[KC], rv[KC];
#pragma unroll
      for (int n = 0; n < KC; ++n) {
        const int e = tid + n * kThreads, j = e / CPR;
        const int c = (e - j * CPR) * CV;
        const bool in = e < kBK * CPR && k0 + j < p.skv && c < p.d;
        rk[n] = load16(k + (k0 + j) * p.sks + c, in);
        rv[n] = load16(v + (k0 + j) * p.svs + c, in);
      }
#pragma unroll
      for (int n = 0; n < KC; ++n) {
        const int e = tid + n * kThreads, j = e / CPR;
        const int c = (e - j * CPR) * CV;
        if (e < kBK * CPR) {
          Chunk<T>::store(k_s + j * DP + c, rk[n], 1.f);
          Chunk<T>::store(v_s + j * DP + c, rv[n], 1.f);
        }
      }
    } else {
      float kx[KN], vx[KN];
#pragma unroll
      for (int n = 0; n < KN; ++n) {
        const int e = tid + n * kThreads, j = e / DW, c = e - j * DW;
        const bool in = k0 + j < p.skv && c < p.d;
        kx[n] = in ? to_float(k[(k0 + j) * p.sks + c]) : 0.f;
        vx[n] = in ? to_float(v[(k0 + j) * p.svs + c]) : 0.f;
      }
#pragma unroll
      for (int n = 0; n < KN; ++n) {
        const int e = tid + n * kThreads, j = e / DW, c = e - j * DW;
        k_s[j * DP + c] = kx[n];
        v_s[j * DP + c] = vx[n];
      }
    }
    __syncthreads();

    float s[kRowsPerWarp];
#pragma unroll
    for (int t = 0; t < kRowsPerWarp; ++t) s[t] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(k_s + lane * DP);
#pragma unroll 4
    for (int c4 = 0; c4 < D4; ++c4) {
      const float4 kk = k4[c4];
#pragma unroll
      for (int t = 0; t < kRowsPerWarp; ++t) {
        if (t >= nlive) break;
        const float4 qq = reinterpret_cast<const float4*>(
            q_s + (t * kWarps + warp) * DP)[c4];
        s[t] = __fmaf_rn(qq.x, kk.x, s[t]);
        s[t] = __fmaf_rn(qq.y, kk.y, s[t]);
        s[t] = __fmaf_rn(qq.z, kk.z, s[t]);
        s[t] = __fmaf_rn(qq.w, kk.w, s[t]);
      }
    }

    const int kpos = k0 + lane;
#pragma unroll
    for (int t = 0; t < kRowsPerWarp; ++t) {
      if (t >= nlive) break;
      bool ok = kpos < p.skv;
      if (p.causal) ok = ok && qpos[t] >= kpos;
      if (p.window > 0) ok = ok && qpos[t] - kpos < p.window;
      const float sc = ok ? s[t] : kNegInf;
      const float m_new = fmaxf(m[t], warp_max(sc));
      const float pr = expf(__fsub_rn(sc, m_new));
      const float corr = expf(__fsub_rn(m[t], m_new));
      l[t] = __fadd_rn(__fmul_rn(l[t], corr), warp_sum(pr));
      m[t] = m_new;
      pw[t * kBK + lane] = pr;
#pragma unroll
      for (int n = 0; n < NI; ++n) acc[t][n] = __fmul_rn(acc[t][n], corr);
    }
    __syncwarp();

#pragma unroll 2
    for (int j4 = 0; j4 < kBK / 4; ++j4) {
      float vv[4][NI];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int n = 0; n < NI; ++n)
          vv[jj][n] = v_s[(4 * j4 + jj) * DP + lane + 32 * n];
#pragma unroll
      for (int t = 0; t < kRowsPerWarp; ++t) {
        if (t >= nlive) break;
        const float4 pp = reinterpret_cast<const float4*>(pw + t * kBK)[j4];
#pragma unroll
        for (int n = 0; n < NI; ++n) {
          acc[t][n] = __fmaf_rn(pp.x, vv[0][n], acc[t][n]);
          acc[t][n] = __fmaf_rn(pp.y, vv[1][n], acc[t][n]);
          acc[t][n] = __fmaf_rn(pp.z, vv[2][n], acc[t][n]);
          acc[t][n] = __fmaf_rn(pp.w, vv[3][n], acc[t][n]);
        }
      }
    }
    __syncwarp();
  }

  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int t = 0; t < kRowsPerWarp; ++t) {
    const int r = t * kWarps + warp;
    if (t >= nlive) break;
    const int i = i0 + r / p.g, h = hk * p.g + r % p.g;
    T* row = o + ((static_cast<long long>(b) * p.sq + i) * p.h + h) * p.d;
    const float den = fmaxf(l[t], 1e-30f);
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      const int c = lane + 32 * n;
      if (c < p.d) store(row + c, __fdiv_rn(acc[t][n], den));
    }
  }
}

// ------------------------------------- shared by the mma and decode forms

// 16 bytes of T as floats.
template <typename T>
struct Piece;

template <>
struct Piece<float> {
  static constexpr int kVals = 4;
  __device__ static void unpack(uint4 raw, float (&x)[4]) {
    x[0] = __uint_as_float(raw.x);
    x[1] = __uint_as_float(raw.y);
    x[2] = __uint_as_float(raw.z);
    x[3] = __uint_as_float(raw.w);
  }
};

template <>
struct Piece<__nv_bfloat16> {
  static constexpr int kVals = 8;
  __device__ static void unpack(uint4 raw, float (&x)[8]) {
    const float2 a = Chunk<__nv_bfloat16>::pair(raw.x),
                 b = Chunk<__nv_bfloat16>::pair(raw.y),
                 c = Chunk<__nv_bfloat16>::pair(raw.z),
                 d = Chunk<__nv_bfloat16>::pair(raw.w);
    x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
    x[4] = c.x; x[5] = c.y; x[6] = d.x; x[7] = d.y;
  }
};

// The 16 bytes of row[dim0 ...] as raw bits, zero where !in or past d: one
// 16-byte load (VEC: row 16-byte aligned, d a multiple of the piece) or
// single values. row is not dereferenced when !in.
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_piece(const T* row, int dim0, int d,
                                            bool in) {
  if (VEC) return load16(row + dim0, in && dim0 < d);
  uint32_t w[4];
  if (sizeof(T) == 4) {
    const uint32_t* r = reinterpret_cast<const uint32_t*>(row);
#pragma unroll
    for (int e = 0; e < 4; ++e) w[e] = in && dim0 + e < d ? r[dim0 + e] : 0u;
  } else {
    const uint16_t* r = reinterpret_cast<const uint16_t*>(row);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t lo = in && dim0 + 2 * e < d ? r[dim0 + 2 * e] : 0u;
      const uint32_t hi = in && dim0 + 2 * e + 1 < d ? r[dim0 + 2 * e + 1] : 0u;
      w[e] = lo | (hi << 16);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// ------------------------------------- flash_mma_kernel: bf16, Sq > 1

constexpr int kMmaWarpgroups = 2;
constexpr int kMmaThreads = 128 * kMmaWarpgroups;
constexpr int kMmaRows = 64 * kMmaWarpgroups;    // query rows a block
constexpr int kMmaBK = 64;                        // keys a tile
// A tile of 64 rows x 128 bf16 (D padded): two 64-column halves of 64
// rows x 128 bytes, each 16-byte chunk c of a row r stored at chunk
// c ^ (r % 8) of its row (the 128-byte swizzle).
constexpr int kTileBytes = 64 * 128 * 2;
constexpr int kHalfBytes = kTileBytes / 2;
constexpr int kQBytes = kMmaWarpgroups * kTileBytes;
constexpr size_t kMmaSmem = kQBytes + 4 * kTileBytes + 1024;  // + alignment
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t swizzled(int row, int c) {
  return (c >> 3) * kHalfBytes + row * 128 + (((c & 7) ^ (row & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 x) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w)
               : "memory");
}

// 8 bf16 of row (dims 8c ... 8c + 7) into shared memory at dst, zero past
// d or where !in: one cp.async (src-size 0 or 16; safe is a valid,
// aligned address read nowhere) or single values through registers.
template <bool VEC>
__device__ __forceinline__ void fill_chunk(uint32_t dst,
                                           const __nv_bfloat16* row, int c,
                                           int d, bool in,
                                           const __nv_bfloat16* safe) {
  if (VEC) {
    const bool any = in && 8 * c < d;
    cp_async16(dst, any ? row + 8 * c : safe, any ? 16 : 0);
  } else {
    st_shared16(dst, load_piece<__nv_bfloat16, false>(row, 8 * c, d, in));
  }
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products (they write it after their asm statement).
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, float32) = or += A (64 x 16, K-major in shared memory) *
// B^T (B: 64 x 16, K-major in shared memory).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, float32) += A (64 x 16 bf16 in registers) * B (16 x 64,
// MN-major in shared memory: read transposed).
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// K and V tile `tile` (64 keys from k0 = 64 * tile) into ring stage st.
template <bool VEC>
__device__ __forceinline__ void load_kv(const Params& p,
                                        const __nv_bfloat16* k,
                                        const __nv_bfloat16* v, int tile,
                                        uint32_t ks, uint32_t vs, int tid) {
  const int k0 = tile * kMmaBK;
#pragma unroll
  for (int n = 0; n < kMmaBK * 16 / kMmaThreads; ++n) {
    const int e = tid + n * kMmaThreads, j = e >> 4, c = e & 15;
    const bool in = k0 + j < p.skv;
    const uint32_t at = swizzled(j, c);
    fill_chunk<VEC>(ks + at, k + (k0 + j) * p.sks, c, p.d, in, k);
    fill_chunk<VEC>(vs + at, v + (k0 + j) * p.svs, c, p.d, in, v);
  }
}

// One block: batch blockIdx.z, KV head blockIdx.y, query positions
// [i0, i0 + bq) with bq * G <= 128; block row r is position i0 + r / G,
// head hk * G + r % G; warpgroup w owns rows 64 w ... 64 w + 63.
template <bool VEC>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_mma_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t qs = base;
  const uint32_t ks0 = base + kQBytes, vs0 = ks0 + 2 * kTileBytes;

  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7, wl = (tid >> 5) & 3;    // warpgroup, its warp
  const int b = blockIdx.z, hk = blockIdx.y;
  const int i0 = blockIdx.x * p.bq;
  const int i1 = min(p.sq, i0 + p.bq);
  const int nrows = (i1 - i0) * p.g;
  const int off = p.skv - p.sq;
  using bf16 = __nv_bfloat16;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.sqb;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.skb + hk * p.skh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.svb + hk * p.svh;

  // Q: 128 rows x 16 chunks, with tile t0 in the first copy group.
#pragma unroll
  for (int n = 0; n < kMmaRows * 16 / kMmaThreads; ++n) {
    const int e = tid + n * kMmaThreads, r = e >> 4, c = e & 15;
    const int i = i0 + r / p.g, h = hk * p.g + r % p.g;
    fill_chunk<VEC>(qs + (r >> 6) * kTileBytes + swizzled(r & 63, c),
                    q + i * p.sqs + h * p.sqh, c, p.d, r < nrows,
                    static_cast<const bf16*>(p.q));
  }
  // The keys the block's rows can see: the causal and window band.
  int klo = 0, khi = p.skv - 1;
  if (p.causal) khi = min(khi, i1 - 1 + off);
  if (p.window > 0) klo = max(klo, i0 + off - p.window + 1);
  const int t0 = klo / kMmaBK, t1 = khi / kMmaBK;
  load_kv<VEC>(p, k, v, t0, ks0, vs0, tid);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // This thread's two rows of its warpgroup's 64: ra and ra + 8.
  const int ra = wg * 64 + wl * 16 + (lane >> 2);
  const int qpos_a = i0 + ra / p.g + off, qpos_b = i0 + (ra + 8) / p.g + off;
  // The warpgroup's positions, for the whole-tile test (padding rows
  // included, which only makes it stricter).
  const int plo = i0 + (wg * 64) / p.g + off;
  const int phi = i0 + (wg * 64 + 63) / p.g + off;
  const float sl2 = __fmul_rn(p.scale, kLog2e);
  const uint32_t qa = qs + wg * kTileBytes;

  float o[2][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[0][i] = o[1][i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  for (int t = t0; t <= t1; ++t) {
    const int st = (t - t0) & 1;
    if (t < t1)
      load_kv<VEC>(p, k, v, t + 1, ks0 + (st ^ 1) * kTileBytes,
                   vs0 + (st ^ 1) * kTileBytes, tid);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    // This thread's copies and stores of tile t (and Q) are done; make
    // them visible to the tensor cores' reads, then wait for the others'.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t kt = ks0 + st * kTileBytes, vt = vs0 + st * kTileBytes;

    // S = Q K^T over D padded to 128: 8 steps of 16, 4 in each half.
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t step = (kk >> 2) * kHalfBytes + (kk & 3) * 32;
      wgmma_ss(s, sw128_desc(qa + step, 16, 1024),
               sw128_desc(kt + step, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);

    // Scores in the log2 domain; the mask only at the band's edges.
    const int k0 = t * kMmaBK;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = __fmul_rn(s[i], sl2);
    const bool whole = k0 + kMmaBK - 1 < p.skv &&
                       (!p.causal || k0 + kMmaBK - 1 <= plo) &&
                       (p.window <= 0 || phi - k0 < p.window);
    if (!whole) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kpos = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const int qp = (i & 2) ? qpos_b : qpos_a;
        bool ok = kpos < p.skv;
        if (p.causal) ok = ok && qp >= kpos;
        if (p.window > 0) ok = ok && qp - kpos < p.window;
        if (!ok) s[i] = kNegInf;
      }
    }
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & 2) mx_b = fmaxf(mx_b, s[i]);
      else mx_a = fmaxf(mx_a, s[i]);
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {       // the 4 lanes of a row
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, x));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, x));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float c_a = exp2f(__fsub_rn(m_a, mn_a));
    const float c_b = exp2f(__fsub_rn(m_b, mn_b));
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp2f(__fsub_rn(s[i], (i & 2) ? mn_b : mn_a));
      if (i & 2) sum_b = __fadd_rn(sum_b, s[i]);
      else sum_a = __fadd_rn(sum_a, s[i]);
    }
    l_a = __fadd_rn(__fmul_rn(l_a, c_a), sum_a);   // this thread's keys;
    l_b = __fadd_rn(__fmul_rn(l_b, c_b), sum_b);   // the row's at the end
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      o[0][i] = __fmul_rn(o[0][i], (i & 2) ? c_b : c_a);
      o[1][i] = __fmul_rn(o[1][i], (i & 2) ? c_b : c_a);
    }

    // O += P V: P in bf16 as the A operand (the accumulator layout of S
    // is the A layout of 16 keys at a time), V transposed from shared
    // memory, one product per 64-column half of D.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[8 * kk], s[8 * kk + 1]),
                             pack_bf16(s[8 * kk + 2], s[8 * kk + 3]),
                             pack_bf16(s[8 * kk + 4], s[8 * kk + 5]),
                             pack_bf16(s[8 * kk + 6], s[8 * kk + 7])};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        wgmma_rs_t(o[hf], a,
                   sw128_desc(vt + hf * kHalfBytes + kk * 16 * 128, 1024,
                              1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(o[0]);
    reg_fence(o[1]);
    __syncthreads();   // stage st is free for tile t + 2
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l_a = __fadd_rn(l_a, __shfl_xor_sync(0xffffffffu, l_a, x));
    l_b = __fadd_rn(l_b, __shfl_xor_sync(0xffffffffu, l_b, x));
  }
  bf16* out = static_cast<bf16*>(p.o);
#pragma unroll
  for (int half = 0; half < 2; ++half) {     // rows ra, ra + 8
    const int r = ra + 8 * half;
    if (r >= nrows) continue;
    const int i = i0 + r / p.g, h = hk * p.g + r % p.g;
    bf16* row = out + ((static_cast<long long>(b) * p.sq + i) * p.h + h) * p.d;
    const float den = fmaxf(half ? l_b : l_a, 1e-30f);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 64 * hf + 8 * j + 2 * (lane & 3);
        const float x0 = __fdiv_rn(o[hf][4 * j + 2 * half], den);
        const float x1 = __fdiv_rn(o[hf][4 * j + 2 * half + 1], den);
        if (c + 1 < p.d && !(p.d & 1)) {
          *reinterpret_cast<__nv_bfloat162*>(row + c) =
              __floats2bfloat162_rn(x0, x1);
        } else {
          if (c < p.d) row[c] = __float2bfloat16_rn(x0);
          if (c + 1 < p.d) row[c + 1] = __float2bfloat16_rn(x1);
        }
      }
  }
}

// ----------------------------- flash_decode_kernel: Sq = 1, float32/bf16

constexpr int kDecWarps = 8;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecRows = 4;     // query rows a pass
constexpr int kDecSteps = 8;    // key steps a chunk, loaded before use

// One block: batch blockIdx.y, KV head blockIdx.x, its G query rows
// kDecRows at a time. A key's D values are spread over PL lanes (PL * V =
// 128 >= D; lanes past D load zeros), so a warp takes 32 / PL keys a step;
// warp w takes the w-th contiguous slice of the band's keys. PL is a
// compile-time constant, so the shuffle reductions unroll and interleave.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_kernel(const Params p) {
  constexpr int V = Piece<T>::kVals;
  constexpr int PL = 128 / V;
  constexpr int kps = 32 / PL;
  __shared__ float s_m[kDecWarps][kDecRows], s_l[kDecWarps][kDecRows];
  __shared__ float s_acc[kDecWarps][kDecRows][128];
  __shared__ float s_wt[kDecWarps][kDecRows], s_den[kDecRows];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int piece = lane % PL, sub = lane / PL;
  const int dim0 = piece * V;
  // Sq = 1: the query sits at Skv - 1, so causal masks nothing and the
  // window keeps the last `window` keys; the others are skipped (their
  // exp(-1e30 - m) is 0 in the TPU kernel).
  const int klo = p.window > 0 ? max(0, p.skv - p.window) : 0;
  const int per = (p.skv - klo + kDecWarps - 1) / kDecWarps;
  const int j0 = klo + warp * per, j1 = min(p.skv, j0 + per);
  const T* q = static_cast<const T*>(p.q) + b * p.sqb;
  const T* k = static_cast<const T*>(p.k) + b * p.skb + hk * p.skh;
  const T* v = static_cast<const T*>(p.v) + b * p.svb + hk * p.svh;
  T* out = static_cast<T*>(p.o) + static_cast<long long>(b) * p.h * p.d;

  for (int g0 = 0; g0 < p.g; g0 += kDecRows) {
    float qv[kDecRows][V], m[kDecRows], l[kDecRows], acc[kDecRows][V];
#pragma unroll
    for (int g = 0; g < kDecRows; ++g) {
      const bool live = g0 + g < p.g;
      const T* row = q + (hk * p.g + g0 + g) * p.sqh;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        qv[g][e] = live && dim0 + e < p.d
                       ? __fmul_rn(to_float(row[dim0 + e]), p.scale)
                       : 0.f;
        acc[g][e] = 0.f;
      }
      m[g] = kNegInf;
      l[g] = 0.f;
    }

    for (int c0 = j0; c0 < j1; c0 += kDecSteps * kps) {
      uint4 rk[kDecSteps], rv[kDecSteps];
#pragma unroll
      for (int s = 0; s < kDecSteps; ++s) {
        const int key = c0 + s * kps + sub;
        rk[s] = load_piece<T, VEC>(k + key * p.sks, dim0, p.d, key < j1);
        rv[s] = load_piece<T, VEC>(v + key * p.svs, dim0, p.d, key < j1);
      }
      float sc[kDecSteps][kDecRows];
#pragma unroll
      for (int s = 0; s < kDecSteps; ++s) {
        float kf[V];
        Piece<T>::unpack(rk[s], kf);
#pragma unroll
        for (int g = 0; g < kDecRows; ++g) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < V; ++e) part = __fmaf_rn(qv[g][e], kf[e], part);
#pragma unroll
          for (int x = PL >> 1; x > 0; x >>= 1)
            part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, x));
          sc[s][g] = c0 + s * kps + sub < j1 ? part : kNegInf;
        }
      }
#pragma unroll
      for (int g = 0; g < kDecRows; ++g) {
        float mx = sc[0][g];
#pragma unroll
        for (int s = 1; s < kDecSteps; ++s) mx = fmaxf(mx, sc[s][g]);
#pragma unroll
        for (int x = PL; x < 32; x <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
        const float mn = fmaxf(m[g], mx);
        const float corr = expf(__fsub_rn(m[g], mn));
        m[g] = mn;
        l[g] = __fmul_rn(l[g], corr);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[g][e] = __fmul_rn(acc[g][e], corr);
      }
#pragma unroll
      for (int s = 0; s < kDecSteps; ++s) {
        float vf[V];
        Piece<T>::unpack(rv[s], vf);
#pragma unroll
        for (int g = 0; g < kDecRows; ++g) {
          const float pr = expf(__fsub_rn(sc[s][g], m[g]));
          l[g] = __fadd_rn(l[g], pr);
#pragma unroll
          for (int e = 0; e < V; ++e) acc[g][e] = __fmaf_rn(pr, vf[e], acc[g][e]);
        }
      }
    }

    // The warp's result: its kps lane groups summed (they share m).
#pragma unroll
    for (int g = 0; g < kDecRows; ++g) {
#pragma unroll
      for (int x = PL; x < 32; x <<= 1) {
        l[g] = __fadd_rn(l[g], __shfl_xor_sync(0xffffffffu, l[g], x));
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc[g][e] = __fadd_rn(acc[g][e],
                                __shfl_xor_sync(0xffffffffu, acc[g][e], x));
      }
      if (sub == 0) {
#pragma unroll
        for (int e = 0; e < V; ++e) s_acc[warp][g][dim0 + e] = acc[g][e];
      }
      if (lane == 0) {
        s_m[warp][g] = m[g];
        s_l[warp][g] = l[g];
      }
    }
    __syncthreads();

    // The log-sum-exp merge of the warps: a warp with no key has m = -1e30
    // and l = 0, and its weight exp(-1e30 - m) is 0.
    if (tid < kDecRows) {
      float mm = kNegInf, ll = 0.f;
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) mm = fmaxf(mm, s_m[w][tid]);
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) {
        const float wt = expf(__fsub_rn(s_m[w][tid], mm));
        s_wt[w][tid] = wt;
        ll = __fadd_rn(ll, __fmul_rn(s_l[w][tid], wt));
      }
      s_den[tid] = fmaxf(ll, 1e-30f);
    }
    __syncthreads();
    for (int x = tid; x < kDecRows * p.d; x += kDecThreads) {
      const int g = x / p.d, c = x - g * p.d;
      if (g0 + g >= p.g) break;
      float aa = 0.f;
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w)
        aa = __fadd_rn(aa, __fmul_rn(s_acc[w][g][c], s_wt[w][g]));
      store(out + (hk * p.g + g0 + g) * p.d + c, __fdiv_rn(aa, s_den[g]));
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------ launches

// Lets `kernel` take `bytes` of dynamic shared memory, once a device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool (&ready)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  return cudaSuccess;
}

template <typename T, int NI>
int launch(const Params& p, int batch, int hkv, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<NI>();
  static bool ready[64] = {};
  const cudaError_t err = allow_smem(flash_kernel<T, NI>, smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + p.bq - 1) / p.bq, hkv, batch);
  flash_kernel<T, NI><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int launch_d(const Params& p, int batch, int hkv, cudaStream_t stream) {
  switch ((p.d + 31) / 32) {
    case 1: return launch<T, 1>(p, batch, hkv, stream);
    case 2: return launch<T, 2>(p, batch, hkv, stream);
    case 3: return launch<T, 3>(p, batch, hkv, stream);
    case 4: return launch<T, 4>(p, batch, hkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool VEC>
int launch_mma(const Params& p, int batch, int hkv, cudaStream_t stream) {
  static bool ready[64] = {};
  const cudaError_t err = allow_smem(flash_mma_kernel<VEC>, kMmaSmem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + p.bq - 1) / p.bq, hkv, batch);
  flash_mma_kernel<VEC><<<grid, kMmaThreads, kMmaSmem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int launch_decode(const Params& p, int batch, int hkv, cudaStream_t stream) {
  const dim3 grid(hkv, batch);
  if (p.vec)
    flash_decode_kernel<T, true><<<grid, kDecThreads, 0, stream>>>(p);
  else
    flash_decode_kernel<T, false><<<grid, kDecThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: device pointers; strides in elements (the last dim has
// stride 1; o is contiguous (B, Sq, H, D)). form 0 = flash_kernel
// (float32, g * bq <= 64), 1 = flash_mma_kernel (bfloat16, g * bq <=
// 128), 2 = flash_decode_kernel (sq = 1; bq unused). dtype 0 = float32, 1 =
// bfloat16. window <= 0: none. vec: q, k and v 16-byte aligned, their
// strides and d multiples of 16 bytes' worth of values (the caller
// checks). Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int form,
    int dtype, int batch, int sq, int skv, int h, int hkv, int d, int bq,
    long long sqb, long long sqs, long long sqh,
    long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh,
    int causal, int window, int vec, float scale, void* stream) {
  if (d < 1 || d > 128 || hkv < 1 || h % hkv != 0 || bq < 1 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const int g = h / hkv;
  Params p{q, k, v, o, sqb, sqs, sqh, skb, sks, skh, svb, svs, svh,
           sq, skv, h, d, g, bq, causal, window, vec, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case 0:
      if (dtype != 0 || g * bq > kRows) return cudaErrorInvalidValue;
      return launch_d<float>(p, batch, hkv, s);
    case 1:
      if (dtype != 1 || g * bq > kMmaRows) return cudaErrorInvalidValue;
      return vec ? launch_mma<true>(p, batch, hkv, s)
                 : launch_mma<false>(p, batch, hkv, s);
    case 2:
      if (sq != 1) return cudaErrorInvalidValue;
      return dtype == 0 ? launch_decode<float>(p, batch, hkv, s)
                        : launch_decode<__nv_bfloat16>(p, batch, hkv, s);
    default:
      return cudaErrorInvalidValue;
  }
}
