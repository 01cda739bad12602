// The backward of the RWKV-6 time-mix recurrence (the gradient of
// rwkv6_scan.cu's forward).
//
// Replaces no TPU kernel: the reference's Pallas kernel
// src/repro/kernels/linear_scan/kernel.py, rwkv6_scan_bhsd, has no backward
// (its trainer differentiates the model's own time-step scan).  The port's
// train-mode forward runs rwkv6_scan.cu on the card, and no plain version
// may stand in on that path, so the gradient is a kernel too.
//
// The forward, per (batch b, head h), with S_{-1} = state0[b, h]:
//     y_t = r_t (S_{t-1} + u o k_t (x) v_t),  S_t = w_t o S_{t-1} + k_t (x) v_t
// Given dy (B, S, H, hd) and dS_T (B, H, hd, hd), with dS the gradient of
// S_t, a sweep over t downward computes
//     G      = dS + (r_t o u) (x) dy_t        (the gradient of k_t (x) v_t)
//     dr_t   = (S_{t-1} + u o k_t (x) v_t) dy_t
//     dk_t   = G v_t,   dv_t = G^T k_t,   dw_t[i] = sum_j dS[i][j] S_{t-1}[i][j]
//     du    += r_t o k_t (v_t . dy_t)
//     dS     = w_t o dS + r_t (x) dy_t       (the gradient of S_{t-1})
// and the last dS is dstate0.  S_{t-1} is never recovered by dividing by
// w (RWKV-6's decay exp(-exp(.)) can sit at 0): a first sweep runs the
// recurrence forward and saves the state every kT steps; the backward
// sweep then takes the chunks last to first, recomputes each chunk's
// states forward from its saved one into a scratch of kT states, and walks
// them back.  The state step is written as the plain version writes it,
// __fadd_rn(__fmul_rn(w, S), __fmul_rn(k, v)), so the recomputed states
// equal linear_scan/ops.py rwkv6_scan_bwd_plain's bit for bit; the
// gradients' sums run in another order than the plain version's, so they
// agree to f32 rounding.
//
// Layout: r, k, v (bf16 or f32) are read through their (batch, seq, head)
// strides, last dim contiguous; w, dy (B, S, H, hd) and u, state0, dS_T
// contiguous f32; dr, dk, dv, dw (B, S, H, hd), du (B, H, hd, summed over
// the batch by the wrapper) and dstate0 (B, H, hd, hd) f32.  Built for
// hd <= kHd = 64; a narrower head is padded with zeros, which stay zero.
//
// What bounds it on an H100: bytes.  At (B 4, S 4,096, H 40, hd 64) with
// bf16 r, k, v it reads r, k, v, w, dy and writes dr, dk, dv, dw: 1.26 GB,
// 0.38 ms at 3.35 TB/s; its ~18 FLOP a state element a step (2.68e9
// element-steps) take 0.29 ms as 3xTF32 on the tensor cores.
//
// The design, simple first (the per-token body on the CUDA cores; the
// chunked form on the tensor cores is later work): one CTA of 256 threads
// a (batch, head), the 64 x 64 state and its gradient spread over the
// registers, 4 threads a row of 16 columns each.  A chunk's r, k, w, v and
// dy are staged in shared memory once.  The row sums (dr, dk, dw, v . dy)
// reduce over a row's 4 lanes by shuffles; dv's column sums over the 64
// rows reduce a warp's 8 rows by recursive halving (14 shuffles, each lane
// left with 2 columns) and the 8 warps through shared memory, double
// buffered, one barrier a step.  The saved states and a chunk's states sit
// in device memory in each thread's own order (each thread reads back only
// what it wrote), as float4s whose neighbours are neighbouring threads'.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kHd = 64;        // the widest head, ops.MAX_HEAD
constexpr int kT = 64;         // steps between saved states, ops.BWD_CHUNK
constexpr int kThreads = 256;  // 4 a row
constexpr int kCols = 16;      // columns a thread
constexpr int kWarps = kThreads / 32;
constexpr int kQuads = kCols / 4;  // float4s of a thread's state
// a chunk's r, k, w, v, dy, then dv's partial sums (2 buffers x 8 warps)
constexpr size_t kSmemFloats = 5 * kT * kHd + 2 * kWarps * kHd;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;
static_assert(kHd * kHd == kThreads * kCols, "one state element a slot");
static_assert(kSmemBytes <= 232448, "more than a CTA's shared memory");

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s0;
  const float* dy;
  const float* dsT;
  float* dr;
  float* dk;
  float* dv;
  float* dw;
  float* du;
  float* ds0;
  float4* saved;   // (B H, n_saved, kQuads, kThreads)
  float4* states;  // (B H, kT, kQuads, kThreads)
  int S, H, hd, n_saved;
  long long rb, rs, rh, kb, ks, kh, vb, vs, vh;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// dst[u][i] = src[(t0 + u) * st + i] for u < nt, i < hd; 0 for i >= hd
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long st,
                                      int t0, int nt, int hd) {
  for (int idx = threadIdx.x; idx < nt * kHd; idx += kThreads) {
    const int u = idx / kHd, i = idx - u * kHd;
    dst[idx] = i < hd ? to_f(src[(t0 + u) * st + i]) : 0.f;
  }
}

// S = w o S + k (x) v on this thread's row and columns, step u of the chunk
__device__ __forceinline__ void step(float (&st)[kCols], const float* ks,
                                     const float* ws, const float* vs, int u,
                                     int row, int c0) {
  const float kk = ks[u * kHd + row], ww = ws[u * kHd + row];
  const float4* v4 = reinterpret_cast<const float4*>(vs + u * kHd + c0);
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    const float4 vv = v4[q];
    const float vq[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st[4 * q + e] =
          __fadd_rn(__fmul_rn(ww, st[4 * q + e]), __fmul_rn(kk, vq[e]));
  }
}

__device__ __forceinline__ void put(float4* dst, const float (&x)[kCols]) {
#pragma unroll
  for (int q = 0; q < kQuads; ++q)
    dst[q * kThreads] =
        make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
}

__device__ __forceinline__ void get(float (&x)[kCols], const float4* src) {
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    const float4 f = src[q * kThreads];
    x[4 * q] = f.x;
    x[4 * q + 1] = f.y;
    x[4 * q + 2] = f.z;
    x[4 * q + 3] = f.w;
  }
}

// x = this thread's 16 columns of a staged row
__device__ __forceinline__ void row_of(float (&x)[kCols], const float* src) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    const float4 f = s4[q];
    x[4 * q] = f.x;
    x[4 * q + 1] = f.y;
    x[4 * q + 2] = f.z;
    x[4 * q + 3] = f.w;
  }
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rwkv6_scan_bwd_kernel(const Args p) {
  extern __shared__ __align__(16) float sm[];
  float* r_s = sm;
  float* k_s = r_s + kT * kHd;
  float* w_s = k_s + kT * kHd;
  float* v_s = w_s + kT * kHd;
  float* dy_s = v_s + kT * kHd;
  float* part = dy_s + kT * kHd;  // [2][kWarps][kHd]

  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int hd = p.hd, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = tid >> 2, cg = tid & 3, c0 = cg * kCols;
  const T* rp = static_cast<const T*>(p.r) + b * p.rb + h * p.rh;
  const T* kp = static_cast<const T*>(p.k) + b * p.kb + h * p.kh;
  const T* vp = static_cast<const T*>(p.v) + b * p.vb + h * p.vh;
  const long long bhs = static_cast<long long>(b) * p.S * p.H + h;
  const long long st = static_cast<long long>(p.H) * hd;  // w, dy, outputs
  const float* wp = p.w + bhs * hd;
  const float* dyp = p.dy + bhs * hd;
  const long long hd2 = static_cast<long long>(hd) * hd;
  float4* saved = p.saved + static_cast<long long>(bh) * p.n_saved *
                                kQuads * kThreads + tid;
  float4* states =
      p.states + static_cast<long long>(bh) * kT * kQuads * kThreads + tid;
  const bool live_row = row < hd;
  const int n_chunks = (p.S + kT - 1) / kT;

  // the forward sweep: the state before every chunk, saved
  float s[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e)
    s[e] = live_row && c0 + e < hd ? p.s0[bh * hd2 + row * hd + c0 + e] : 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    put(saved + static_cast<long long>(c) * kQuads * kThreads, s);
    if (c == n_chunks - 1) break;
    __syncthreads();
    stage(k_s, kp, p.ks, c * kT, kT, hd);
    stage(w_s, wp, st, c * kT, kT, hd);
    stage(v_s, vp, p.vs, c * kT, kT, hd);
    __syncthreads();
    for (int u = 0; u < kT; ++u) step(s, k_s, w_s, v_s, u, row, c0);
  }

  // the backward sweep, a chunk at a time, last to first
  float dS[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e)
    dS[e] = live_row && c0 + e < hd ? p.dsT[bh * hd2 + row * hd + c0 + e]
                                    : 0.f;
  const float uu = live_row ? p.u[h * hd + row] : 0.f;
  float du = 0.f;
  const int hi = (lane >> 4) & 1, mid = (lane >> 3) & 1, lo = (lane >> 2) & 1;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kT, nt = min(kT, p.S - t0);
    __syncthreads();  // the last step's dv reads are done
    stage(r_s, rp, p.rs, t0, nt, hd);
    stage(k_s, kp, p.ks, t0, nt, hd);
    stage(w_s, wp, st, t0, nt, hd);
    stage(v_s, vp, p.vs, t0, nt, hd);
    stage(dy_s, dyp, st, t0, nt, hd);
    __syncthreads();
    get(s, saved + static_cast<long long>(c) * kQuads * kThreads);
    for (int u = 0; u < nt; ++u) {  // S_{t-1} for every t of the chunk
      put(states + static_cast<long long>(u) * kQuads * kThreads, s);
      if (u + 1 < nt) step(s, k_s, w_s, v_s, u, row, c0);
    }
    for (int u = nt - 1; u >= 0; --u) {
      const long long t = t0 + u;
      float sp[kCols], vv[kCols], dd[kCols], col[kCols];
      get(sp, states + static_cast<long long>(u) * kQuads * kThreads);
      row_of(vv, v_s + u * kHd + c0);
      row_of(dd, dy_s + u * kHd + c0);
      const float rr = r_s[u * kHd + row], kk = k_s[u * kHd + row];
      const float ww = w_s[u * kHd + row];
      const float ru = rr * uu, uk = uu * kk;
      float vdy = 0.f, pr = 0.f, pk = 0.f, pw = 0.f;
#pragma unroll
      for (int e = 0; e < kCols; ++e) {
        const float g = dS[e] + ru * dd[e];
        vdy += vv[e] * dd[e];
        pk += g * vv[e];
        col[e] = g * kk;
        pr += (sp[e] + uk * vv[e]) * dd[e];
        pw += dS[e] * sp[e];
      }
      vdy = row_sum(vdy);
      pr = row_sum(pr);
      pk = row_sum(pk);
      pw = row_sum(pw);
      if (live_row) {
        const long long o = t * st + row;
        if (cg == 0) p.dr[bhs * hd + o] = pr;
        if (cg == 1) p.dk[bhs * hd + o] = pk;
        if (cg == 2) p.dw[bhs * hd + o] = pw;
      }
      du += rr * kk * vdy;
      // dv: the warp's 8 rows by recursive halving over lanes ^16, ^8, ^4
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float send = hi ? col[e] : col[e + 8];
        const float keep = hi ? col[e + 8] : col[e];
        col[e] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float send = mid ? col[e] : col[e + 4];
        const float keep = mid ? col[e + 4] : col[e];
        col[e] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float send = lo ? col[e] : col[e + 2];
        const float keep = lo ? col[e + 2] : col[e];
        col[e] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
      }
      float* pb = part + (u & 1) * kWarps * kHd + warp * kHd;
      const int j = c0 + 8 * hi + 4 * mid + 2 * lo;
      pb[j] = col[0];
      pb[j + 1] = col[1];
#pragma unroll
      for (int e = 0; e < kCols; ++e)
        dS[e] = __fadd_rn(__fmul_rn(ww, dS[e]), __fmul_rn(rr, dd[e]));
      __syncthreads();
      if (tid < hd) {
        const float* pa = part + (u & 1) * kWarps * kHd + tid;
        float x = 0.f;
#pragma unroll
        for (int i = 0; i < kWarps; ++i) x += pa[i * kHd];
        p.dv[bhs * hd + t * st + tid] = x;
      }
    }
  }
  if (live_row) {
#pragma unroll
    for (int e = 0; e < kCols; ++e)
      if (c0 + e < hd) p.ds0[bh * hd2 + row * hd + c0 + e] = dS[e];
    if (cg == 0) p.du[bh * hd + row] = du;
  }
}

template <typename T>
int launch(const Args& p, int B, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv6_scan_bwd_kernel<T><<<B * p.H, kThreads, kSmemBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v: (B, S, H, hd) of dtype 0 = float32, 1 = bfloat16, read through
// the (batch, seq, head) strides given in elements (last dim contiguous);
// w, dy, dr, dk, dv, dw: (B, S, H, hd) float32 contiguous; u (H, hd);
// state0, dS_T, dstate0 (B, H, hd, hd); du (B, H, hd); saved
// (B H, ceil(S / 64), 64 x 64) and states (B H, 64, 64 x 64) float32
// scratch.  Launches on ``stream``, never synchronises; returns
// cudaGetLastError() (or the refused attribute's error).
extern "C" int rwkv6_scan_bwd_launch(
    const void* r, const void* k, const void* v, const float* w,
    const float* u, const float* s0, const float* dy, const float* dsT,
    float* dr, float* dk, float* dv, float* dw, float* du, float* ds0,
    float* saved, float* states, int B, int S, int H, int hd, long long rb,
    long long rs, long long rh, long long kb, long long ks, long long kh,
    long long vb, long long vs, long long vh, int dtype, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (S < 0 || hd <= 0 || hd > kHd || B * static_cast<long long>(H) >
                                           2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args p{r, k, v, w, u, s0, dy, dsT, dr, dk, dv, dw, du, ds0,
               reinterpret_cast<float4*>(saved),
               reinterpret_cast<float4*>(states), S, H, hd,
               (S + kT - 1) / kT > 0 ? (S + kT - 1) / kT : 1, rb, rs, rh, kb,
               ks, kh, vb, vs, vh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, B, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// bytes of dynamic shared memory a CTA: a chunk's inputs and dv's sums
extern "C" int rwkv6_scan_bwd_smem_bytes() {
  return static_cast<int>(kSmemBytes);
}
