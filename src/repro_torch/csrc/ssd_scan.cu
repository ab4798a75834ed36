// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel repro/kernels/ssd_scan.py::ssd_scan (body
// _kernel, wrapper ssd_scan, pallas_call), which runs one program per
// (batch, head) and carries the (N, P) state over the chunks in VMEM. Over
// x (B, S, H, P) and B_, C_ (B, S, G, N) of T = float or __nv_bfloat16,
// dt (B, S, H) and A, D (H,) of float32, head h reading group
// h / (H / G) of B_ and C_ (no repeated copy), it computes for every chunk
// of Q tokens, with the state St (N, P) in float32 starting at 0:
//   csum_i = dt_0 A + ... + dt_i A            (summed in order)
//   S_ij   = (C_i . B_j) * exp(-(csum_i - csum_j)) * dt_j   for j <= i, else 0
//   y_i    = sum_j S_ij x_j + exp(-csum_i) (C_i St) + D x_i
//   St    <- sum_j (B_j (exp(-(csum_Q - csum_j)) dt_j)) x_j^T + exp(-csum_Q) St
// and writes y in T and, when asked, the final St (B, H, N, P) in float32.
// A ragged last chunk is masked (its missing rows count as dt = 0, which
// is what the TPU wrapper's zero padding gives). expf, not __expf; the
// library is built without fast math and every product and sum is an
// explicit _rn intrinsic.
//
// What bounds it on the H100: at mamba2-130m's prefill (B = 1, S = 8192,
// H = 24, G = 1, N = 128, P = 64, Q = 128, bf16) it moves 55.3 MB (16.5 us
// at 3.35 TB/s) and does 1.61e10 operations (16.3 us at the 989 TFLOP/s
// bf16 tensor-core peak, 240 us at the 67 TFLOP/s float32 CUDA-core peak
// that this kernel runs on): at the bf16 peak the bytes bind, by a hair.
//
// The design is the simple one that is right: float32 on the CUDA cores,
// no tensor cores, no TMA. The TPU's one program per (batch, head) would
// be 24 blocks for 132 SMs, so one block runs per (batch, head, tile of
// 16 of the P columns): a column of the state evolves on its own (y[:, p]
// reads only St[:, p] and x[:, p]), so the tiles need no exchange; each
// recomputes the chunk's C B^T scores, which is the price (4 tiles at
// P = 64, 96 blocks). A block holds a chunk's B and C (as float, rows
// padded to 132 so float4 reads of 8 rows by 8 lanes hit distinct banks),
// the masked scores S (Q x Q) and its x tile in 221 KB of shared memory,
// one block an SM. The scores are a register-tiled product (8 x 8 a
// thread), y and the state 4 x 2 a thread. x, dt, B and C are read
// through their strides (the last dim of x, B and C contiguous), so the
// slices of the model's xBC buffer need no copy; x, B and C in 16-byte
// chunks where the layout allows, each thread's loads of a tile issued
// before it stores any.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 128;        // largest chunk
constexpr int kN = 128;        // largest state size
constexpr int kPT = 16;        // P columns a block
constexpr int kRS = kN + 4;    // row stride of B_s and C_s (floats)
constexpr int kSS = kQ + 4;    // row stride of S_s
constexpr int kBatch = 8;      // loads a thread keeps in flight
constexpr size_t kSmemBytes =
    sizeof(float) * (2 * kQ * kRS + kQ * kSS + kQ * kPT + kN * kPT + 4 * kQ);

struct Params {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  const float* d;
  void* y;
  float* state;
  long long sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbg, scb, scs, scg;
  int s, h, g, n, p, q, vec;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 16 bytes of T as floats into dst (16-byte aligned).
__device__ __forceinline__ void store16(float* dst, uint4 raw, float) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(raw.x), __uint_as_float(raw.y),
                  __uint_as_float(raw.z), __uint_as_float(raw.w));
}
__device__ __forceinline__ float2 bf2(unsigned int w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}
__device__ __forceinline__ void store16(float* dst, uint4 raw,
                                        __nv_bfloat16) {
  const float2 a = bf2(raw.x), b = bf2(raw.y), c = bf2(raw.z), d = bf2(raw.w);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

// Rows j < q of a (rows, n) slab with row stride `stride` into dst (row
// stride ld) as float, columns up to np; zero for j >= rows or col >= n.
// Each thread issues kBatch loads before it stores any: 16-byte chunks
// where vec (the pointer, the stride and n in whole chunks: the wrapper
// checks), else single values.
template <typename T>
__device__ void load_rows(float* dst, int ld, const T* src, long long stride,
                          int rows, int q, int n, int np, int vec) {
  if (vec) {
    constexpr int CV = 16 / sizeof(T);
    const int cpr = n / CV, total = q * cpr;
    for (int base = 0; base < total; base += kThreads * kBatch) {
      uint4 raw[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = base + u * kThreads + threadIdx.x;
        const int j = e / cpr, col = (e - j * cpr) * CV;
        raw[u] = e < total && j < rows
                     ? *reinterpret_cast<const uint4*>(src + j * stride + col)
                     : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = base + u * kThreads + threadIdx.x;
        const int j = e / cpr, col = (e - j * cpr) * CV;
        if (e < total) store16(dst + j * ld + col, raw[u], T());
      }
    }
    return;
  }
  const int total = q * np;
  for (int base = 0; base < total; base += kThreads * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = base + u * kThreads + threadIdx.x;
      const int j = e / np, col = e - j * np;
      v[u] = e < total && j < rows && col < n ? to_float(src[j * stride + col])
                                              : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = base + u * kThreads + threadIdx.x;
      const int j = e / np, col = e - j * np;
      if (e < total) dst[j * ld + col] = v[u];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* b_s = reinterpret_cast<float*>(smem4);   // [kQ][kRS]
  float* c_s = b_s + kQ * kRS;                     // [kQ][kRS]
  float* s_s = c_s + kQ * kRS;                     // [kQ][kSS]
  float* x_s = s_s + kQ * kSS;                     // [kQ][kPT]
  float* st_s = x_s + kQ * kPT;                    // [kN][kPT]
  float* dt_s = st_s + kN * kPT;                   // [kQ]
  float* cs_s = dt_s + kQ;                         // [kQ] csum
  float* w_s = cs_s + kQ;                          // [kQ] exp(-(csum_Q - csum)) dt
  float* din_s = w_s + kQ;                         // [kQ] exp(-csum)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * kPT, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (p.h / p.g);
  const int np = (p.n + 3) & ~3;
  const float a_h = p.a[h], d_h = p.d[h];
  const T* xg = static_cast<const T*>(p.x) + b * p.sxb + h * p.sxh + p0;
  const float* dtg = p.dt + b * p.sdb + h * p.sdh;
  const T* bg = static_cast<const T*>(p.b) + b * p.sbb + grp * p.sbg;
  const T* cg = static_cast<const T*>(p.c) + b * p.scb + grp * p.scg;

  // y: rows yi0 + a (a < 4), columns yp + e (e < 2) of the tile; the
  // state: rows sn0 + a of N, the same columns.
  const int yi0 = 4 * (tid >> 3), yp = 2 * (tid & 7), sn0 = yi0;
  float st[4][2];
#pragma unroll
  for (int a = 0; a < 4; ++a) st[a][0] = st[a][1] = 0.f;
  for (int e = tid; e < kN * kPT; e += kThreads) st_s[e] = 0.f;

  const int n_chunks = (p.s + p.q - 1) / p.q;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int s0 = ch * p.q;
    const int rows = min(p.q, p.s - s0);
    __syncthreads();   // the last chunk's readers are done
    if (tid < kQ) dt_s[tid] = tid < rows ? dtg[(s0 + tid) * p.sds] : 0.f;
    load_rows(b_s, kRS, bg + s0 * p.sbs, p.sbs, rows, p.q, p.n, np, p.vec);
    load_rows(c_s, kRS, cg + s0 * p.scs, p.scs, rows, p.q, p.n, np, p.vec);
    // x: all kQ rows (zero past `rows`), kPT columns (zero past p).
    load_rows(x_s, kPT, xg + s0 * p.sxs, p.sxs, rows, kQ,
              min(kPT, p.p - p0), kPT, p.vec);
    __syncthreads();
    if (tid < p.q) {   // each row sums its prefix in order
      float s = 0.f;
      for (int j = 0; j <= tid; ++j) s = __fadd_rn(s, __fmul_rn(dt_s[j], a_h));
      cs_s[tid] = s;
    }
    __syncthreads();
    const float c_last = cs_s[p.q - 1];
    if (tid < p.q) {
      const float ci = cs_s[tid];
      din_s[tid] = expf(-ci);
      w_s[tid] = __fmul_rn(expf(-__fsub_rn(c_last, ci)), dt_s[tid]);
    }

    // The masked scores: warp (rb, cb) covers rows 32 rb + [0, 32) and
    // columns 64 cb + [0, 64); lane (lr, lc) rows r0 + 4 a, columns
    // c0 + 8 e. A warp above the diagonal or past the valid rows skips the
    // product and writes zeros.
    {
      const int rb = warp & 3, cb = warp >> 2, lr = lane >> 3, lc = lane & 7;
      const int r0 = 32 * rb + lr, c0 = 64 * cb + lc;
      const bool live = 32 * rb < rows && 64 * cb <= 32 * rb + 31;
      float acc[8][8];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[a][e] = 0.f;
      if (live) {
        for (int k = 0; k < np; k += 4) {
          float4 cv[8], bv[8];
#pragma unroll
          for (int a = 0; a < 8; ++a)
            cv[a] = *reinterpret_cast<const float4*>(c_s + (r0 + 4 * a) * kRS + k);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            bv[e] = *reinterpret_cast<const float4*>(b_s + (c0 + 8 * e) * kRS + k);
#pragma unroll
          for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              acc[a][e] = __fmaf_rn(cv[a].x, bv[e].x, acc[a][e]);
              acc[a][e] = __fmaf_rn(cv[a].y, bv[e].y, acc[a][e]);
              acc[a][e] = __fmaf_rn(cv[a].z, bv[e].z, acc[a][e]);
              acc[a][e] = __fmaf_rn(cv[a].w, bv[e].w, acc[a][e]);
            }
        }
      }
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int i = r0 + 4 * a;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int j = c0 + 8 * e;
          float v = 0.f;
          if (live && j <= i && i < rows)
            v = __fmul_rn(__fmul_rn(acc[a][e],
                                    expf(-__fsub_rn(cs_s[i], cs_s[j]))),
                          dt_s[j]);
          s_s[i * kSS + j] = v;
        }
      }
    }
    __syncthreads();

    // y: the scores times x (S_s is 0 above the diagonal), and C times the
    // incoming state.
    float intra[4][2], inter[4][2];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      intra[a][0] = intra[a][1] = inter[a][0] = inter[a][1] = 0.f;
    if (yi0 < rows) {
      const int jend = min(yi0 + 4, rows);
      for (int j = 0; j < jend; j += 4) {
        float4 sv[4];
        float2 xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          sv[a] = *reinterpret_cast<const float4*>(s_s + (yi0 + a) * kSS + j);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          xv[u] = *reinterpret_cast<const float2*>(x_s + (j + u) * kPT + yp);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          intra[a][0] = __fmaf_rn(sv[a].x, xv[0].x, intra[a][0]);
          intra[a][1] = __fmaf_rn(sv[a].x, xv[0].y, intra[a][1]);
          intra[a][0] = __fmaf_rn(sv[a].y, xv[1].x, intra[a][0]);
          intra[a][1] = __fmaf_rn(sv[a].y, xv[1].y, intra[a][1]);
          intra[a][0] = __fmaf_rn(sv[a].z, xv[2].x, intra[a][0]);
          intra[a][1] = __fmaf_rn(sv[a].z, xv[2].y, intra[a][1]);
          intra[a][0] = __fmaf_rn(sv[a].w, xv[3].x, intra[a][0]);
          intra[a][1] = __fmaf_rn(sv[a].w, xv[3].y, intra[a][1]);
        }
      }
      for (int k = 0; k < np; k += 4) {
        float4 cv[4];
        float2 sv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          cv[a] = *reinterpret_cast<const float4*>(c_s + (yi0 + a) * kRS + k);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          sv[u] = *reinterpret_cast<const float2*>(st_s + (k + u) * kPT + yp);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          inter[a][0] = __fmaf_rn(cv[a].x, sv[0].x, inter[a][0]);
          inter[a][1] = __fmaf_rn(cv[a].x, sv[0].y, inter[a][1]);
          inter[a][0] = __fmaf_rn(cv[a].y, sv[1].x, inter[a][0]);
          inter[a][1] = __fmaf_rn(cv[a].y, sv[1].y, inter[a][1]);
          inter[a][0] = __fmaf_rn(cv[a].z, sv[2].x, inter[a][0]);
          inter[a][1] = __fmaf_rn(cv[a].z, sv[2].y, inter[a][1]);
          inter[a][0] = __fmaf_rn(cv[a].w, sv[3].x, inter[a][0]);
          inter[a][1] = __fmaf_rn(cv[a].w, sv[3].y, inter[a][1]);
        }
      }
    }

    // The outgoing state: rows sn0 + a of N (zero-padded past n).
    if (sn0 < np) {
      float ns[4][2];
#pragma unroll
      for (int a = 0; a < 4; ++a) ns[a][0] = ns[a][1] = 0.f;
      for (int j = 0; j < rows; ++j) {
        const float4 bv = *reinterpret_cast<const float4*>(b_s + j * kRS + sn0);
        const float2 xv = *reinterpret_cast<const float2*>(x_s + j * kPT + yp);
        const float wj = w_s[j];
        const float wb[4] = {__fmul_rn(bv.x, wj), __fmul_rn(bv.y, wj),
                             __fmul_rn(bv.z, wj), __fmul_rn(bv.w, wj)};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          ns[a][0] = __fmaf_rn(wb[a], xv.x, ns[a][0]);
          ns[a][1] = __fmaf_rn(wb[a], xv.y, ns[a][1]);
        }
      }
      const float decay = expf(-c_last);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          st[a][e] = __fadd_rn(ns[a][e], __fmul_rn(decay, st[a][e]));
    }
    __syncthreads();   // every reader of st_s is done

#pragma unroll
    for (int a = 0; a < 4; ++a)
      *reinterpret_cast<float2*>(st_s + (sn0 + a) * kPT + yp) =
          make_float2(st[a][0], st[a][1]);
    T* yg = static_cast<T*>(p.y);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = yi0 + a;
      if (i >= rows) break;
      const long long row = (static_cast<long long>(b) * p.s + s0 + i) * p.h + h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = p0 + yp + e;
        if (col >= p.p) continue;
        const float v = __fadd_rn(
            __fadd_rn(intra[a][e], __fmul_rn(din_s[i], inter[a][e])),
            __fmul_rn(d_h, x_s[i * kPT + yp + e]));
        store(yg + row * p.p + col, v);
      }
    }
  }

  if (p.state != nullptr) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int n = sn0 + a;
      if (n >= p.n) break;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = p0 + yp + e;
        if (col < p.p)
          p.state[((static_cast<long long>(b) * p.h + h) * p.n + n) * p.p +
                  col] = st[a][e];
      }
    }
  }
}

template <typename T>
int launch(const Params& p, int batch, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static bool ready[64] = {};
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(ssd_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const dim3 grid((p.p + kPT - 1) / kPT, p.h, batch);
  ssd_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x, b, c: device pointers of dtype (0 = float32, 1 = bfloat16), strides
// in elements over (batch, seq, head or group), the last dim contiguous;
// dt: float32 with strides; a, d: contiguous float32 (H,); y: contiguous
// (B, S, H, P) of dtype; state: contiguous float32 (B, H, N, P), or null.
// q: the chunk, min(chunk, S). vec: x, b and c 16-byte aligned, their
// strides, n and p whole 16-byte chunks (the caller checks). Returns the
// CUDA error of the launch (0 on success).
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* d, void* y, void* state, int dtype,
    int batch, int s, int h, int g, int n, int p, int q,
    long long sxb, long long sxs, long long sxh,
    long long sdb, long long sds, long long sdh,
    long long sbb, long long sbs, long long sbg,
    long long scb, long long scs, long long scg, int vec, void* stream) {
  if (batch < 1 || s < 1 || h < 1 || g < 1 || h % g != 0 || n < 1 ||
      n > kN || p < 1 || q < 1 || q > kQ)
    return cudaErrorInvalidValue;
  Params prm{x, static_cast<const float*>(dt), static_cast<const float*>(a),
             b, c, static_cast<const float*>(d), y,
             static_cast<float*>(state),
             sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbg, scb, scs, scg,
             s, h, g, n, p, q, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(prm, batch, st);
  if (dtype == 1) return launch<__nv_bfloat16>(prm, batch, st);
  return cudaErrorInvalidValue;
}
