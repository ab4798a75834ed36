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
// by tile as the TPU kernel does (corr = exp(m_old - m_new)). expf, not
// __expf; the library is built without fast math.
//
// Every query row must have a valid key (the wrapper refuses causal with
// Sq > Skv). A tile that is wholly masked for a row while the row's max is
// still -1e30 adds exp(0) = 1 per masked key, as the TPU kernel's does;
// the first valid key's corr = exp(-1e30 - m) = 0 wipes it.
//
// What bounds it on the H100: operations at the prefill shape, bytes at
// the decode shape. Prefill of h2o-danube-3-4b (B = 1, S = 8192, H = 32,
// Hkv = 8, D = 120, window 4096): 25,167,872 unmasked pairs a head, 4 D
// operations a pair, 3.87e11 in all: 0.391 ms at 989 TFLOP/s (bf16),
// against 157 MB moved (0.047 ms). Decode (Sq = 1, B = 8, 128 valid
// keys): 4.06 MB of K, V, q and out, 1.21 us at 3.35 TB/s.
//
// The design is the simple one that is right: float32 on the CUDA cores,
// no tensor cores, no TMA. One block per (batch, KV head, tile of bq
// query positions) holds the G * bq <= 64 query rows of that KV head's
// G heads in shared memory (scaled, float32), so each K/V tile is read
// once for all G heads. It loops over K/V tiles of 32 keys (one key a
// lane in the scores), and visits only the tiles that meet the block's
// causal and window band: the windowed prefill costs O(S * window), where
// the TPU kernel visits every tile. A thread issues all its loads of a
// tile before it stores any, in 16-byte chunks where the layout allows
// (D = 120 is 15 chunks of 8 bf16): loads one at a time left a bf16 tile
// waiting some 6.5 us on serial round trips. Registers are capped for two
// blocks an SM (a few spills at D > 96), which beat one block of 176
// registers at the prefill shape by 1.6x. Each of 8 warps owns 8 query rows:
// scores from float4 shared-memory reads (rows padded to 32 * NI + 4
// floats, so a warp's float4 reads of 32 rows hit distinct banks), a
// warp-shuffle max and sum per row, probabilities through shared memory,
// and each lane accumulates the output dims lane + 32 i. D = 120 is padded
// with zeros in shared memory only, never in the output. The kernel reads
// q, k and v through their strides (the last dim contiguous), so the
// decode's cache[:, :n_valid] view needs no copy.

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

template <typename T, int NI>
int launch(const Params& p, int batch, int hkv, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<NI>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static bool ready[64] = {};
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(flash_kernel<T, NI>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
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

}  // namespace

// q, k, v, o: device pointers; strides in elements (the last dim has
// stride 1; o is contiguous (B, Sq, H, D)). dtype 0 = float32, 1 =
// bfloat16. bq: query positions a block (g * bq <= 64). window <= 0: none.
// vec: q, k and v 16-byte aligned, their strides and d multiples of 16
// bytes' worth of values (the caller checks). Returns the CUDA error of
// the launch (0 on success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int sq, int skv, int h, int hkv, int d, int bq,
    long long sqb, long long sqs, long long sqh,
    long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh,
    int causal, int window, int vec, float scale, void* stream) {
  if (d < 1 || d > 128 || hkv < 1 || h % hkv != 0 || bq < 1 ||
      (h / hkv) * bq > kRows)
    return cudaErrorInvalidValue;
  Params p{q, k, v, o, sqb, sqs, sqh, skb, sks, skh, svb, svs, svh,
           sq, skv, h, d, h / hkv, bq, causal, window, vec, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(p, batch, hkv, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(p, batch, hkv, s);
  return cudaErrorInvalidValue;
}
