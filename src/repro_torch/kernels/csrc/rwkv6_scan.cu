// RWKV-6 time-mix recurrence: a matrix state per (batch, head) with a
// data-dependent per-channel decay (the RWKV-6 mixer's scan).
//
// Replaces the TPU kernel src/repro/kernels/linear_scan/kernel.py,
// rwkv6_scan_bhsd (body _rwkv6_kernel).  Per (batch b, head h), with the
// state S (hd x hd, f32) starting at state0[b, h], for t = 0 .. S_len - 1:
//     y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//     S[i][j] = w_t[i] S[i][j] + k_t[i] v_t[j]
// and S_T = S at the end.  The math is float32 from f32 or bf16 r, k, v and
// an f32 decay w; y and S_T are f32.
//
// The TPU kernel runs the chunked factored form (three matrix products a
// chunk on the MXU, with S carried in VMEM across a sequential grid axis);
// its exp(-cumsum log w) factor bounds it to sum |log w| < ~80 a chunk.
// This kernel runs the exact per-token recurrence, which has no such
// domain: the result equals the reference's exact scan (ref.py) to f32
// rounding, and the chunked plain version within its domain.  CUDA blocks
// run in no order, so the sweep over time is a loop inside one CTA per
// (b, h), the state in registers for the whole sweep.
//
// Layout: r, k, v (bf16 or f32) and w (f32) are (B, S, H, hd) read through
// their batch, sequence and head strides (last dim contiguous): no moveaxis
// and no cast copies.  y is written as (B, S, H, hd) f32 and S_T as
// (B, H, hd, hd) f32.  The kernel is built for hd = HD = 64 (RWKV-6's
// head width); a narrower head is padded past hd with zero r, k, v and S0
// and decay 1, so the padded rows and columns stay zero and add nothing.
//
// Work split: 2 * HD threads; thread (column j, half g) owns column j of S
// for the HD / 2 rows {8 p + 4 g + e}, so a step is, per thread, HD / 2
// independent updates of its state registers and a partial y[j]; the two
// halves of a column are lanes l and l ^ 16 of one warp and add by one
// shuffle.  r, k, w and v of kChunk tokens are staged in shared memory with
// coalesced loads (one token's hd values are contiguous), read back as
// broadcast float4s (the two halves' rows sit in neighbouring banks).
//
// What bounds it on an H100: operations, then latency.  At the scoring
// shape (B 4, S 4,096, H 40, hd 64) the function needs 5 FLOP a state
// element a step (the decay multiply-add and the r . S product), 1.34e10
// FLOP, 0.20 ms at 67 TFLOP/s f32, against 0.18 ms for its bytes (bf16
// r, k, v and f32 w read once, f32 y written once, over 3.35 TB/s).  This
// first kernel is right and simple: it issues 4 FP instructions a state
// element a step from 160 CTAs of 4 warps (about one warp a scheduler),
// and stages each chunk without overlapping its loads with the previous
// chunk's arithmetic.  The chunked form on tensor cores (wgmma), TMA and a
// ring of chunks are the later, faster kernel's work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int HD = 64;      // widest hd: the state is HD x HD
constexpr int kChunk = 32;  // tokens staged in shared memory at a time

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s0;
  float* y;
  float* sT;
  int B, S, H, hd;
  long long rb, rs, rh, kb, ks, kh, vb, vs, vh, wb, ws, wh;  // elements
};

template <typename T>
__global__ void __launch_bounds__(2 * HD) rwkv6_scan_kernel(Args a) {
  constexpr int kRows = HD / 2;  // state rows a thread owns
  __shared__ __align__(16) float r_s[kChunk][HD];
  __shared__ __align__(16) float k_s[kChunk][HD];
  __shared__ __align__(16) float w_s[kChunk][HD];
  __shared__ float v_s[kChunk][HD];
  __shared__ float y_s[kChunk][HD];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const int col = (tid >> 5) * 16 + (lane & 15);  // the state column
  const int g = lane >> 4;                         // which half of the rows
  const int hd = a.hd;
  const T* r = static_cast<const T*>(a.r) + b * a.rb + h * a.rh;
  const T* k = static_cast<const T*>(a.k) + b * a.kb + h * a.kh;
  const T* v = static_cast<const T*>(a.v) + b * a.vb + h * a.vh;
  const float* w = a.w + b * a.wb + h * a.wh;
  float* y = a.y + (static_cast<long long>(b) * a.S * a.H + h) * hd;
  const long long ys = static_cast<long long>(a.H) * hd;
  const long long bh = static_cast<long long>(b) * a.H + h;

  // row of the m-th register: 8 p + 4 g + e with m = 4 p + e
  float st[kRows], uu[kRows];
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int row = 8 * (m / 4) + 4 * g + m % 4;
    const bool ok = row < hd && col < hd;
    st[m] = ok ? a.s0[(bh * hd + row) * hd + col] : 0.f;
    uu[m] = row < hd ? a.u[h * hd + row] : 0.f;
  }

  for (int t0 = 0; t0 < a.S; t0 += kChunk) {
    const int n = min(kChunk, a.S - t0);
    __syncthreads();  // the last chunk's tiles all read, y_s written out
    for (int i = tid; i < kChunk * HD; i += 2 * HD) {
      const int tt = i / HD, d = i - tt * HD;
      const bool ok = tt < n && d < hd;
      const long long t = t0 + tt;
      r_s[tt][d] = ok ? to_f32(r[t * a.rs + d]) : 0.f;
      k_s[tt][d] = ok ? to_f32(k[t * a.ks + d]) : 0.f;
      v_s[tt][d] = ok ? to_f32(v[t * a.vs + d]) : 0.f;
      w_s[tt][d] = ok ? w[t * a.ws + d] : 1.f;
    }
    __syncthreads();

    for (int tt = 0; tt < n; ++tt) {
      const float vj = v_s[tt][col];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int p = 0; p < HD / 8; ++p) {
        const int q = 8 * p + 4 * g;
        const float4 r4 = *reinterpret_cast<const float4*>(&r_s[tt][q]);
        const float4 k4 = *reinterpret_cast<const float4*>(&k_s[tt][q]);
        const float4 w4 = *reinterpret_cast<const float4*>(&w_s[tt][q]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 4 * p + e;
          const float kv = kk[e] * vj;
          acc[e] = fmaf(rr[e], fmaf(uu[m], kv, st[m]), acc[e]);
          st[m] = fmaf(ww[e], st[m], kv);
        }
      }
      float yj = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      yj += __shfl_xor_sync(0xffffffffu, yj, 16);
      if (g == 0) y_s[tt][col] = yj;
    }
    __syncthreads();
    for (int i = tid; i < n * HD; i += 2 * HD) {
      const int tt = i / HD, d = i - tt * HD;
      if (d < hd) y[(t0 + tt) * ys + d] = y_s[tt][d];
    }
  }

#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int row = 8 * (m / 4) + 4 * g + m % 4;
    if (row < hd && col < hd) a.sT[(bh * hd + row) * hd + col] = st[m];
  }
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  rwkv6_scan_kernel<T><<<dim3(a.H, a.B), 2 * HD, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype of r, k and v: 0 float32, 1 bfloat16 (w, u, state0, y and S_T are
// float32).  Strides in elements: batch, sequence, head of r, k, v, w (last
// dim contiguous); u (H, hd), state0 and S_T (B, H, hd, hd) and y
// (B, S, H, hd) contiguous.  Launches on ``stream``, never synchronises;
// returns cudaGetLastError().
extern "C" int rwkv6_scan_launch(
    const void* r, const void* k, const void* v, const float* w,
    const float* u, const float* s0, float* y, float* sT, int B, int S,
    int H, int hd, long long rb, long long rs, long long rh, long long kb,
    long long ks, long long kh, long long vb, long long vs, long long vh,
    long long wb, long long ws, long long wh, int dtype, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (S < 0 || hd <= 0 || hd > HD || B > 65535 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{r,  k,  v,  w,  u,  s0, y,  sT, B,  S,  H,  hd, rb,
               rs, rh, kb, ks, kh, vb, vs, vh, wb, ws, wh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(a, st) : launch<__nv_bfloat16>(a, st);
}
