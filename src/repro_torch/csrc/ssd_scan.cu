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
// Two forms, picked by the wrapper from the dtype alone.
//
// The simt form (float32, ssd_kernel) is float32 on the CUDA cores, no
// tensor cores, no TMA. The TPU's one program per (batch, head) would
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
// before it stores any. It walks the chunks of a head in series, as the
// TPU's grid does: 1.80 ms at the prefill shape in bf16 on an H100 (109x
// the bound), which is why bfloat16 takes the mma form.
//
// The mma form (bfloat16) takes the chunks in parallel: the only serial
// part of the scan is the state's hand-off from chunk to chunk, which is
// elementwise, so it gets a pass of its own between two passes that run
// over (batch, chunk, tile of heads of one group) at once, all products
// on the tensor cores (mma.sync m16n8k16, bf16 operands, float32 sums,
// fragments through ldmatrix):
//   1. states (ssd_states_kernel, 3 heads a block): csum by a warp-shuffle
//      scan (four warps and their totals, not one serial chain a row),
//      written to `cum` (B, H, chunks, 128) for pass 3; exp(-csum_Q) into
//      `decay` (B, H, chunks); and the chunk's own state contribution
//      (w o B)^T x, w = exp(-(csum_Q - csum)) dt, as an N x Q by Q x P
//      product into the float32 scratch `ns` (B, H, chunks, N, P padded
//      to 64). w is folded into x, and w x (float32) is split into a bf16
//      high part and a bf16 low part, two products, so that the state
//      keeps float32's accuracy (about 2^-16 of each term);
//   2. hand-off (ssd_handoff_kernel): over (batch, head, 1024 values of
//      the state), a loop over the chunks turns the contributions into
//      the state entering each chunk, St <- ns_c + exp(-csum_Q,c) St in
//      float32 (__fadd_rn/__fmul_rn, the simt form's order), eight
//      chunks' loads in flight; it writes St_in rounded to bf16 (`st_in`,
//      the one rounding pass 3 gives it, at half the bytes) and the final
//      state in float32;
//   3. outputs (ssd_outputs_kernel, 6 heads a block): C B^T once a block
//      for its group (the bf16 products are exact in float32), kept in
//      registers: each warp holds 16 query rows and only the column tiles
//      at or below the diagonal; for each head, C St_in scaled by
//      exp(-csum_i); the masked, decayed scores (the mask before the exp,
//      the exp as exp2f of the difference times log2(e)) rounded once to
//      bf16 straight from the C B^T accumulators into A fragments, times
//      x; y = intra + exp(-csum) inter + D x, rounded once to bf16. Warps
//      w and w + 4, which share a scheduler, take row tiles rt and 7 - rt,
//      so that the triangle's work is even across schedulers.
// Passes 1 and 3 walk their (head, 64 columns) items with the next item's
// inputs in flight (cp.async into a second buffer) while one is computed,
// and pass 3 its first item's while C B^T is; x whose layout allows no
// 16-byte copies is loaded in place. Pass 3 holds one block an SM (C B^T
// takes 64 registers a thread), pass 1 two. Block counts at the prefill
// shape: 512, 192 and 256, about two waves each.
// Its roundings beyond the inputs' own: w x to hi + lo (a split, not a
// loss), the scores and St_in to bf16 (one each, as the TPU's MXU rounds
// its operands at default precision), y to bf16; the scores' exp2 (2 ulp)
// is far inside their rounding. The carried state is float32 throughout.
// The scratch at the prefill shape is 50.3 MB of float32 contributions
// (written by pass 1, read by pass 2) and 25.2 MB of bf16 St_in (written
// by pass 2, read by pass 3): 152 MB of traffic with `cum`, 45 us at
// 3.35 TB/s where L2 holds none of it, which rather than the 1.6e10
// operations sets this form's floor above the 16.5 us bound. Measured on
// an H100, pass 3 takes over half the time: its per-warp chains of dependent products
// and exps at eight warps an SM, and the diagonal's uneven work across
// warps, which every item's __syncthreads waits for.

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


// ------------------------------------------------------------ the mma form

using bf16 = __nv_bfloat16;

constexpr int kHT1 = 3;             // heads a block, pass 1
constexpr int kHT3 = 6;             // heads a block, pass 3
constexpr int kMT = 64;             // P columns a tile of the mma form
constexpr int kLB = kN + 8;         // row stride of B and C tiles (272 B)
constexpr int kLX = kMT + 8;        // row stride of x and state tiles (144 B)
constexpr int kHandoff = 4 * kThreads;  // state values a pass-2 block
constexpr int kAhead = 8;           // chunks a pass-2 thread loads at once
// Pass 1: B, x twice (the next tile's copy in flight), w x high and low,
// dt twice, then csum, dt, w and the four warps' totals.
constexpr size_t kStatesSmem =
    sizeof(bf16) * (kQ * kLB + 4 * kQ * kLX) + sizeof(float) * (4 * kQ + 4);
// Pass 3: C, B, x and St_in twice each, dt and csum twice each.
constexpr size_t kOutputsSmem =
    sizeof(bf16) * (2 * kQ * kLB + 2 * kQ * kLX + 2 * kN * kLX) +
    sizeof(float) * 4 * kQ;
constexpr float kLog2e = 1.4426950408889634f;

struct MmaParams {
  const bf16* x;
  const float* dt;
  const float* a;
  const bf16* b;
  const bf16* c;
  const float* d;
  bf16* y;
  float* state;
  float* ns;       // (B, H, chunks, N, pp): each chunk's own contribution
  bf16* st_in;     // (B, H, chunks, N, pp): the state entering each chunk
  float* decay;    // (B, H, chunks): exp(-csum_Q)
  float* cum;      // (B, H, chunks, kQ): the chunk's csum
  long long sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbg, scb, scs, scg;
  int s, h, g, n, p, q, vec, nc, pp;   // nc chunks; pp = p rounded up to kMT
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8 (16 contiguous bytes). With .trans each is transposed.
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr))
      : "memory");
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr))
      : "memory");
}

// Copies of 16 and of 4 bytes into shared memory that complete
// asynchronously (cp.async); `ok` false writes zeros and reads nothing.
__device__ __forceinline__ void copy16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void copy4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until all of this thread's copies are done.
__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16, float32 sums.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One masked, decayed score: (C B^T)_ij exp(-(csum_i - csum_j)) dt_j for
// j <= i (`live`), else 0 without the exp. The exp is exp2f of the
// difference times log2(e) (the hardware's ex2, 2 ulp, and the product's
// rounding: some 2^-22 relative), which the score's rounding to bf16 right
// after (2^-9) swamps.
__device__ __forceinline__ float score(float cb, float ci, float cj, float dj,
                                       bool live) {
  return live ? __fmul_rn(
                    __fmul_rn(cb, exp2f(__fmul_rn(__fsub_rn(cj, ci), kLog2e))),
                    dj)
              : 0.f;
}

// (lo, hi) rounded to bf16 in one 32-bit register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of rows m0 + [0, 16), columns k0 + [0, 16) of a row-major
// tile (row stride ld), and the same of a tile stored transposed ([k][m]).
__device__ __forceinline__ void a_frag(uint32_t (&r)[4], const bf16* t, int ld,
                                       int m0, int k0, int lane) {
  const int mi = lane >> 3;
  ldsm(r, t + (m0 + (lane & 7) + ((mi & 1) << 3)) * ld + k0 + ((mi >> 1) << 3));
}
__device__ __forceinline__ void a_frag_t(uint32_t (&r)[4], const bf16* t,
                                         int ld, int m0, int k0, int lane) {
  const int mi = lane >> 3;
  ldsm_t(r, t + (k0 + (lane & 7) + ((mi >> 1) << 3)) * ld + m0 + ((mi & 1) << 3));
}
// The B fragments of two column tiles n0 + [0, 8) and n0 + [8, 16), rows
// k0 + [0, 16): {b0, b1} of the first in r[0], r[1], of the second in
// r[2], r[3]. b_frag reads a tile stored [n][k], b_frag_t one stored [k][n].
__device__ __forceinline__ void b_frag(uint32_t (&r)[4], const bf16* t, int ld,
                                       int n0, int k0, int lane) {
  const int mi = lane >> 3;
  ldsm(r, t + (n0 + (lane & 7) + ((mi >> 1) << 3)) * ld + k0 + ((mi & 1) << 3));
}
__device__ __forceinline__ void b_frag_t(uint32_t (&r)[4], const bf16* t,
                                         int ld, int n0, int k0, int lane) {
  const int mi = lane >> 3;
  ldsm_t(r, t + (k0 + (lane & 7) + ((mi & 1) << 3)) * ld + n0 + ((mi >> 1) << 3));
}

// Rows j < kRows, columns < kCols (a multiple of 8) of a bf16 slab (row
// stride `stride`) into dst (row stride ld): the source where j < rows and
// col < cols, zero elsewhere. 16-byte loads where vec (cols then a
// multiple of 8: the wrapper checks), all of a thread's loads issued before
// it stores any.
template <int kRows, int kCols>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          long long stride, int rows, int cols,
                                          int vec) {
  constexpr int kC = kCols / 8, kIter = kRows * kC / kThreads;
  static_assert(kRows * kC % kThreads == 0, "whole iterations");
  uint4 v[kIter];
#pragma unroll
  for (int u = 0; u < kIter; ++u) {
    const int e = u * kThreads + threadIdx.x, j = e / kC, col = (e % kC) * 8;
    v[u] = make_uint4(0, 0, 0, 0);
    if (j < rows && col < cols) {
      const bf16* sp = src + j * stride + col;
      if (vec) {
        v[u] = *reinterpret_cast<const uint4*>(sp);
      } else {
        const unsigned short* s16 = reinterpret_cast<const unsigned short*>(sp);
        uint32_t w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t lo = col + 2 * k < cols ? s16[2 * k] : 0u;
          const uint32_t hi = col + 2 * k + 1 < cols ? s16[2 * k + 1] : 0u;
          w[k] = lo | (hi << 16);
        }
        v[u] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kIter; ++u) {
    const int e = u * kThreads + threadIdx.x, j = e / kC, col = (e % kC) * 8;
    *reinterpret_cast<uint4*>(dst + j * ld + col) = v[u];
  }
}

// The same as copies in flight (cp.async) for a 16-byte-aligned slab whose
// row stride and cols are whole 16-byte chunks.
template <int kRows, int kCols>
__device__ __forceinline__ void copy_tile(bf16* dst, int ld, const bf16* src,
                                          long long stride, int rows,
                                          int cols) {
  constexpr int kC = kCols / 8;
#pragma unroll
  for (int e = threadIdx.x; e < kRows * kC; e += kThreads) {
    const int j = e / kC, col = (e % kC) * 8;
    const bool ok = j < rows && col < cols;
    copy16(dst + j * ld + col, ok ? src + j * stride + col : src, ok);
  }
}

// dt_j of the chunk's rows j < kQ (zero past `rows`) as copies in flight.
__device__ __forceinline__ void copy_dt(float* dst, const float* dtg,
                                        long long sds, int rows) {
  const int j = threadIdx.x;
  if (j < kQ) copy4(dst + j, j < rows ? dtg + j * sds : dtg, j < rows);
}

// The chunk's cumulative sums from dt_s (dt_j, zero past the chunk's
// rows): cs_s[j] = dt_0 A + ... + dt_j A for j < kQ (so cs_s[kQ - 1] is
// csum_Q), by a shuffle scan in each of four warps and a sum of the warps
// before. Pass 1 runs it and writes the sums out for pass 3, so both see
// the same bits. Begins and ends with a __syncthreads; the first makes the
// caller's copies into dt_s visible.
__device__ __forceinline__ void chunk_csum(float* cs_s, float* tot_s,
                                           const float* dt_s, float a_h) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();   // dt_s in; the last item's readers of the sums done
  float v = 0.f;
  if (tid < kQ) {
    v = __fmul_rn(dt_s[tid], a_h);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v = __fadd_rn(t, v);
    }
    if (lane == 31) tot_s[warp] = v;
  }
  __syncthreads();
  if (tid < kQ) {
    for (int k = 0; k < warp; ++k) v = __fadd_rn(tot_s[warp - 1 - k], v);
    cs_s[tid] = v;
  }
  __syncthreads();
}

// Pass 1: each chunk's own state contribution and decay. Its work items
// are (head, tile of kMT columns) pairs; the next item's dt and x are in
// flight while one is computed.
__global__ void __launch_bounds__(kThreads, 2)
    ssd_states_kernel(const MmaParams p) {
  extern __shared__ float4 smem4[];
  bf16* b_s = reinterpret_cast<bf16*>(smem4);  // [kQ][kLB]
  bf16* x_s = b_s + kQ * kLB;                   // [2][kQ][kLX]
  bf16* xh_s = x_s + 2 * kQ * kLX;              // [kQ][kLX] hi of w x
  bf16* xl_s = xh_s + kQ * kLX;                 // [kQ][kLX] lo of w x
  float* dtin_s = reinterpret_cast<float*>(xl_s + kQ * kLX);  // [2][kQ]
  float* cs_s = dtin_s + 2 * kQ;
  float* w_s = cs_s + kQ;
  float* tot_s = w_s + kQ;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ch = blockIdx.x, b = blockIdx.z;
  const int rep = p.h / p.g, tiles = (rep + kHT1 - 1) / kHT1;
  const int grp = blockIdx.y / tiles;
  const int h0 = grp * rep + (blockIdx.y % tiles) * kHT1;
  const int h1 = min(h0 + kHT1, (grp + 1) * rep);
  const int s0 = ch * p.q, rows = min(p.q, p.s - s0);
  const int m0 = 16 * warp, g = lane >> 2, c2 = 2 * (lane & 3);
  const long long np = static_cast<long long>(p.n) * p.pp;
  const int ptiles = (p.p + kMT - 1) / kMT, items = (h1 - h0) * ptiles;
  const bf16* xb = p.x + b * p.sxb + s0 * p.sxs;
  const float* dtb = p.dt + b * p.sdb + s0 * p.sds;

  auto prefetch = [&](int it, int buf) {
    const int h = h0 + it / ptiles, p0 = (it % ptiles) * kMT;
    copy_dt(dtin_s + buf * kQ, dtb + h * p.sdh, p.sds, rows);
    if (p.vec)
      copy_tile<kQ, kMT>(x_s + buf * kQ * kLX, kLX, xb + h * p.sxh + p0,
                         p.sxs, rows, min(kMT, p.p - p0));
    copy_commit();
  };
  prefetch(0, 0);
  load_tile<kQ, kN>(b_s, kLB, p.b + b * p.sbb + s0 * p.sbs + grp * p.sbg,
                    p.sbs, rows, p.n, p.vec);
  for (int it = 0; it < items; ++it) {
    const int buf = it & 1, h = h0 + it / ptiles, p0 = (it % ptiles) * kMT;
    bf16* xs = x_s + buf * kQ * kLX;
    copy_wait_all();
    if (!p.vec)
      load_tile<kQ, kMT>(xs, kLX, xb + h * p.sxh + p0, p.sxs, rows,
                         min(kMT, p.p - p0), 0);
    // Its syncs show this item's copies to every thread, and every warp is
    // then done with the last item, whose buffers the next copies refill.
    chunk_csum(cs_s, tot_s, dtin_s + buf * kQ, p.a[h]);
    if (it + 1 < items) prefetch(it + 1, buf ^ 1);
    const float c_last = cs_s[kQ - 1];
    if (tid < kQ)
      w_s[tid] = __fmul_rn(expf(-__fsub_rn(c_last, cs_s[tid])),
                           dtin_s[buf * kQ + tid]);
    const long long bh = static_cast<long long>(b) * p.h + h;
    if (p0 == 0) {
      if (tid < kQ) p.cum[(bh * p.nc + ch) * kQ + tid] = cs_s[tid];
      if (tid == 0) p.decay[bh * p.nc + ch] = expf(-c_last);
    }
    __syncthreads();   // w_s in
    for (int e = tid; e < kQ * kMT / 2; e += kThreads) {
      const int j = e / (kMT / 2), col = 2 * (e % (kMT / 2));
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xs + j * kLX + col));
      const float w = w_s[j];
      const float v0 = __fmul_rn(w, xv.x), v1 = __fmul_rn(w, xv.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
      const float2 hf = __bfloat1622float2(hi);
      *reinterpret_cast<__nv_bfloat162*>(xh_s + j * kLX + col) = hi;
      *reinterpret_cast<__nv_bfloat162*>(xl_s + j * kLX + col) =
          __floats2bfloat162_rn(__fsub_rn(v0, hf.x), __fsub_rn(v1, hf.y));
    }
    __syncthreads();   // w x in; xs free for the copy after next
    if (m0 >= p.n) continue;
    // ns rows m0 + [0, 16) (of N), the tile's kMT columns: B^T (w x).
    float acc[kMT / 8][4];
#pragma unroll
    for (int t = 0; t < kMT / 8; ++t)
      acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    const int kend = (rows + 15) & ~15;
#pragma unroll
    for (int k0 = 0; k0 < kQ; k0 += 16) {
      if (k0 >= kend) continue;
      uint32_t af[4];
      a_frag_t(af, b_s, kLB, m0, k0, lane);
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        const bf16* wx = part ? xl_s : xh_s;
#pragma unroll
        for (int t = 0; t < kMT / 16; ++t) {
          uint32_t bf[4];
          b_frag_t(bf, wx, kLX, 16 * t, k0, lane);
          mma16816(acc[2 * t], af, bf[0], bf[1]);
          mma16816(acc[2 * t + 1], af, bf[2], bf[3]);
        }
      }
    }
    float* nsg = p.ns + (bh * p.nc + ch) * np;
#pragma unroll
    for (int t = 0; t < kMT / 8; ++t) {
      const int col = p0 + 8 * t + c2;
      if (m0 + g < p.n)
        *reinterpret_cast<float2*>(nsg + (m0 + g) * p.pp + col) =
            make_float2(acc[t][0], acc[t][1]);
      if (m0 + g + 8 < p.n)
        *reinterpret_cast<float2*>(nsg + (m0 + g + 8) * p.pp + col) =
            make_float2(acc[t][2], acc[t][3]);
    }
  }
}

// Pass 2: the state hand-off. St_in of each chunk goes out in bf16, the
// one rounding pass 3 gives it; the carried state stays float32.
__global__ void __launch_bounds__(kThreads) ssd_handoff_kernel(
    const MmaParams p) {
  const long long np = static_cast<long long>(p.n) * p.pp;
  const long long e = static_cast<long long>(blockIdx.x) * kHandoff +
                      4 * threadIdx.x;
  if (e >= np) return;
  const long long bh = static_cast<long long>(blockIdx.z) * p.h + blockIdx.y;
  const float* ns = p.ns + bh * p.nc * np + e;
  bf16* st_in = p.st_in + bh * p.nc * np + e;
  const float* dec = p.decay + bh * p.nc;
  float4 st = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < p.nc; c0 += kAhead) {
    float4 v[kAhead];
    float dv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (c0 + u < p.nc) {
        v[u] = *reinterpret_cast<const float4*>(ns + (c0 + u) * np);
        dv[u] = dec[c0 + u];
      }
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (c0 + u < p.nc) {
        *reinterpret_cast<uint2*>(st_in + (c0 + u) * np) =
            make_uint2(pack_bf16(st.x, st.y), pack_bf16(st.z, st.w));
        st.x = __fadd_rn(v[u].x, __fmul_rn(dv[u], st.x));
        st.y = __fadd_rn(v[u].y, __fmul_rn(dv[u], st.y));
        st.z = __fadd_rn(v[u].z, __fmul_rn(dv[u], st.z));
        st.w = __fadd_rn(v[u].w, __fmul_rn(dv[u], st.w));
      }
  }
  if (p.state != nullptr) {
    const int n = static_cast<int>(e / p.pp), col = static_cast<int>(e % p.pp);
    const float sv[4] = {st.x, st.y, st.z, st.w};
    float* out = p.state + (bh * p.n + n) * p.p;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (col + k < p.p) out[col + k] = sv[k];
  }
}

// Pass 3: the outputs of each chunk from its state entering. Work items
// are (head, tile of kMT columns) pairs; the next item's dt, csum, x and
// St_in are in flight while one is computed, the first item's while C B^T
// is. Warp w takes query rows 16 rt + [0, 16), rt = w for w < 4 and
// 11 - w above: the warps that share a scheduler (w and w + 4) then hold
// rows whose causal work sums to the same.
__global__ void __launch_bounds__(kThreads, 1)
    ssd_outputs_kernel(const MmaParams p) {
  extern __shared__ float4 smem4[];
  bf16* c_s = reinterpret_cast<bf16*>(smem4);  // [kQ][kLB]
  bf16* b_s = c_s + kQ * kLB;                   // [kQ][kLB]
  bf16* x_s = b_s + kQ * kLB;                   // [2][kQ][kLX]
  bf16* st_s = x_s + 2 * kQ * kLX;              // [2][kN][kLX] St_in
  float* dtin_s = reinterpret_cast<float*>(st_s + 2 * kN * kLX);  // [2][kQ]
  float* cs_s = dtin_s + 2 * kQ;                                   // [2][kQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ch = blockIdx.x, b = blockIdx.z;
  const int rep = p.h / p.g, tiles = (rep + kHT3 - 1) / kHT3;
  const int grp = blockIdx.y / tiles;
  const int h0 = grp * rep + (blockIdx.y % tiles) * kHT3;
  const int h1 = min(h0 + kHT3, (grp + 1) * rep);
  const int s0 = ch * p.q, rows = min(p.q, p.s - s0);
  const int rt = warp < 4 ? warp : 11 - warp;
  const int m0 = 16 * rt, g = lane >> 2, c2 = 2 * (lane & 3);
  const int i0 = m0 + g, i1 = i0 + 8;
  const int kn = (p.n + 15) & ~15;
  const long long np = static_cast<long long>(p.n) * p.pp;
  const int ptiles = (p.p + kMT - 1) / kMT, items = (h1 - h0) * ptiles;
  const bf16* xb = p.x + b * p.sxb + s0 * p.sxs;
  const float* dtb = p.dt + b * p.sdb + s0 * p.sds;

  auto prefetch = [&](int it, int buf) {
    const int h = h0 + it / ptiles, p0 = (it % ptiles) * kMT;
    const long long bhc = (static_cast<long long>(b) * p.h + h) * p.nc + ch;
    copy_dt(dtin_s + buf * kQ, dtb + h * p.sdh, p.sds, rows);
    if (tid < kQ / 4)
      copy16(cs_s + buf * kQ + 4 * tid, p.cum + bhc * kQ + 4 * tid, true);
    if (p.vec)
      copy_tile<kQ, kMT>(x_s + buf * kQ * kLX, kLX, xb + h * p.sxh + p0,
                         p.sxs, rows, min(kMT, p.p - p0));
    copy_tile<kN, kMT>(st_s + buf * kN * kLX, kLX, p.st_in + bhc * np + p0,
                       p.pp, p.n, kMT);
    copy_commit();
  };
  prefetch(0, 0);
  load_tile<kQ, kN>(c_s, kLB, p.c + b * p.scb + s0 * p.scs + grp * p.scg,
                    p.scs, rows, p.n, p.vec);
  load_tile<kQ, kN>(b_s, kLB, p.b + b * p.sbb + s0 * p.sbs + grp * p.sbg,
                    p.sbs, rows, p.n, p.vec);
  __syncthreads();

  // C B^T, rows m0 + [0, 16), column tiles t (8 columns each) at or below
  // the diagonal: t / 2 <= rt.
  float cb[kQ / 8][4];
#pragma unroll
  for (int t = 0; t < kQ / 8; ++t) cb[t][0] = cb[t][1] = cb[t][2] = cb[t][3] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < kN; k0 += 16) {
    if (k0 >= kn) continue;
    uint32_t af[4];
    a_frag(af, c_s, kLB, m0, k0, lane);
#pragma unroll
    for (int t = 0; t < kQ / 16; ++t) {
      if (t <= rt) {
        uint32_t bf[4];
        b_frag(bf, b_s, kLB, 16 * t, k0, lane);
        mma16816(cb[2 * t], af, bf[0], bf[1]);
        mma16816(cb[2 * t + 1], af, bf[2], bf[3]);
      }
    }
  }

  for (int it = 0; it < items; ++it) {
    const int buf = it & 1, h = h0 + it / ptiles, p0 = (it % ptiles) * kMT;
    bf16* xs = x_s + buf * kQ * kLX;
    const bf16* sts = st_s + buf * kN * kLX;
    const float* dts = dtin_s + buf * kQ;
    const float* css = cs_s + buf * kQ;
    copy_wait_all();
    if (!p.vec)
      load_tile<kQ, kMT>(xs, kLX, xb + h * p.sxh + p0, p.sxs, rows,
                         min(kMT, p.p - p0), 0);
    // This item's copies are in for every thread, and every warp is done
    // with the last item, whose buffers the next copies refill.
    __syncthreads();
    if (it + 1 < items) prefetch(it + 1, buf ^ 1);
    const float d_h = p.d[h];
    const float ci0 = css[i0], ci1 = css[i1];

    float acc[kMT / 8][4];
#pragma unroll
    for (int t = 0; t < kMT / 8; ++t)
      acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    // inter: C St_in, then each row times exp(-csum_i).
#pragma unroll
    for (int k0 = 0; k0 < kN; k0 += 16) {
      if (k0 >= kn) continue;
      uint32_t af[4];
      a_frag(af, c_s, kLB, m0, k0, lane);
#pragma unroll
      for (int t = 0; t < kMT / 16; ++t) {
        uint32_t bf[4];
        b_frag_t(bf, sts, kLX, 16 * t, k0, lane);
        mma16816(acc[2 * t], af, bf[0], bf[1]);
        mma16816(acc[2 * t + 1], af, bf[2], bf[3]);
      }
    }
    const float d0 = expf(-ci0), d1 = expf(-ci1);
#pragma unroll
    for (int t = 0; t < kMT / 8; ++t) {
      acc[t][0] = __fmul_rn(d0, acc[t][0]);
      acc[t][1] = __fmul_rn(d0, acc[t][1]);
      acc[t][2] = __fmul_rn(d1, acc[t][2]);
      acc[t][3] = __fmul_rn(d1, acc[t][3]);
    }
    // intra: the masked, decayed scores (bf16) times x, key tiles at or
    // below the diagonal.
#pragma unroll
    for (int kt = 0; kt < kQ / 16; ++kt) {
      if (kt > rt) continue;
      uint32_t af[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = 2 * kt + half, j = 16 * kt + 8 * half + c2;
        const float cj0 = css[j], cj1 = css[j + 1];
        const float dj0 = dts[j], dj1 = dts[j + 1];
        af[2 * half] = pack_bf16(score(cb[t][0], ci0, cj0, dj0, j <= i0),
                                 score(cb[t][1], ci0, cj1, dj1, j < i0));
        af[2 * half + 1] =
            pack_bf16(score(cb[t][2], ci1, cj0, dj0, j <= i1),
                      score(cb[t][3], ci1, cj1, dj1, j < i1));
      }
#pragma unroll
      for (int t = 0; t < kMT / 16; ++t) {
        uint32_t bf[4];
        b_frag_t(bf, xs, kLX, 16 * t, 16 * kt, lane);
        mma16816(acc[2 * t], af, bf[0], bf[1]);
        mma16816(acc[2 * t + 1], af, bf[2], bf[3]);
      }
    }
    // y = acc + D x, rounded once to bf16.
#pragma unroll
    for (int t = 0; t < kMT / 8; ++t) {
      const int col = 8 * t + c2;
      if (p0 + col >= p.p) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = r ? i1 : i0;
        if (i >= rows) continue;
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xs + i * kLX + col));
        const float y0 = __fadd_rn(acc[t][2 * r], __fmul_rn(d_h, xv.x));
        const float y1 = __fadd_rn(acc[t][2 * r + 1], __fmul_rn(d_h, xv.y));
        bf16* out = p.y + ((static_cast<long long>(b) * p.s + s0 + i) * p.h + h) *
                              p.p + p0 + col;
        if (p.p % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(y0, y1);
        } else {
          out[0] = __float2bfloat16_rn(y0);
          if (p0 + col + 1 < p.p) out[1] = __float2bfloat16_rn(y1);
        }
      }
    }
  }
}

int launch_mma(const MmaParams& p, int batch, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static bool ready[64] = {};
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(ssd_states_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kStatesSmem));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(ssd_outputs_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kOutputsSmem));
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const int rep = p.h / p.g;
  const dim3 states(p.nc, p.g * ((rep + kHT1 - 1) / kHT1), batch);
  const dim3 outputs(p.nc, p.g * ((rep + kHT3 - 1) / kHT3), batch);
  ssd_states_kernel<<<states, kThreads, kStatesSmem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long np = static_cast<long long>(p.n) * p.pp;
  const dim3 handoff(static_cast<unsigned>((np + kHandoff - 1) / kHandoff), p.h,
                     batch);
  ssd_handoff_kernel<<<handoff, kThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_outputs_kernel<<<outputs, kThreads, kOutputsSmem, stream>>>(p);
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

// The mma form's entry: x, b, c bfloat16, the rest as ssd_scan_launch, and
// four scratch buffers from the caller: ns (batch, h, chunks, n, pp)
// float32, st_in of the same shape in bfloat16, decay (batch, h, chunks)
// float32 and cum (batch, h, chunks, 128) float32, chunks = ceil(s / q),
// pp = p rounded up to 64.
// Launches the three passes on `stream`; returns the first CUDA error (0
// on success).
extern "C" int ssd_scan_mma_launch(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* d, void* y, void* state, void* ns,
    void* st_in, void* decay, void* cum, int batch, int s, int h, int g, int n, int p,
    int q, long long sxb, long long sxs, long long sxh,
    long long sdb, long long sds, long long sdh,
    long long sbb, long long sbs, long long sbg,
    long long scb, long long scs, long long scg, int vec, void* stream) {
  if (batch < 1 || s < 1 || h < 1 || g < 1 || h % g != 0 || n < 1 ||
      n > kN || p < 1 || q < 1 || q > kQ || ns == nullptr ||
      st_in == nullptr || decay == nullptr || cum == nullptr)
    return cudaErrorInvalidValue;
  MmaParams prm{static_cast<const bf16*>(x), static_cast<const float*>(dt),
                static_cast<const float*>(a), static_cast<const bf16*>(b),
                static_cast<const bf16*>(c), static_cast<const float*>(d),
                static_cast<bf16*>(y), static_cast<float*>(state),
                static_cast<float*>(ns), static_cast<bf16*>(st_in),
                static_cast<float*>(decay), static_cast<float*>(cum),
                sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbg, scb, scs, scg,
                s, h, g, n, p, q, vec, (s + q - 1) / q,
                (p + kMT - 1) / kMT * kMT};
  return launch_mma(prm, batch, static_cast<cudaStream_t>(stream));
}
