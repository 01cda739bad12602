// Flash attention, forward: blockwise online softmax over KV tiles, with
// GQA, causal and sliding-window masks, a logit softcap, a valid-KV prefix
// and a query offset (the dense decoder's full-sequence forward).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py,
// flash_attention_bhsd (body _attn_kernel).  Per (batch b, head h, q tile)
// it computes, for every query row r at absolute position q_pos:
//     s_c   = softcap(scale * q_r . k_c)    (cap * tanh(s / cap); 0 = off)
//     s_c   = NEG_INF unless c < kv_len, [causal] c <= q_pos,
//             [window] c > q_pos - window
//     o_r   = sum_c softmax(s)_c v_c             (out in q's dtype)
// with head h reading KV head h / (H / K).  The math is float32 from f32 or
// bf16 inputs, as the Pallas kernel's: p stays f32 for p . v.
//
// The sentinel is the reference's finite NEG_INF = -1e30 with the
// max(l, 1e-30) clamp, not -INFINITY: a tile that is visited but fully
// masked for a row gives p = exp(0) = 1 on its masked entries; the row's
// next tile with an unmasked entry has corr = exp(-1e30 - m) = 0 and wipes
// them.  With -INFINITY the same row would give NaN.
//
// Layout: q (B, Sq, H, hd), k (B, Skv, K, hd), v (B, Skv, K, hd_v) and the
// output (B, Sq, H, hd_v), read and written through their batch, sequence
// and head strides (the last dim contiguous): no moveaxis, no padding copy,
// and no replication of K or V over the group.  The ragged edges are masked
// here: rows past Sq are not stored, KV slots past Skv load as zeros and are
// masked by kv_len <= Skv, as the Pallas wrapper's zero padding is.
//
// The TPU kernel's sequential fourth grid axis (the KV sweep, with m, l and
// acc in VMEM scratch) becomes a loop inside the CTA: one CTA per (q tile of
// kBlockQ rows, head, batch), 256 threads, m and l and the output
// accumulator in registers.  KV tiles are skipped by the reference's rule
// (kernel.py:62-66) on absolute positions: causal k_lo > q_hi; window
// k_hi < q_lo - window + 1.  The tile sizes are the kernel's own (64 x 64),
// not the caller's block_q / block_k.
//
// What bounds it on an H100: operations.  At the model's main shape (B 4,
// S 4,096, H 14, K 2, hd 64, causal, bf16) the function needs 2 (hd + hd_v)
// FLOP for each of the S (S + 1) / 2 unmasked (q, k) pairs of each of the
// 56 (b, h): 1.20e11 FLOP, 0.122 ms at 989 TFLOP/s bf16, against 67 MB of
// q, k, v and o, 20 us at 3.35 TB/s.  This first kernel is right and
// simple: f32 FMAs on the CUDA cores (67 TFLOP/s, so >= 1.8 ms there),
// tiles staged in shared memory as f32 (padded strides: conflict-free
// transposing stores of K and broadcast reads of Q and P), each thread a
// 4 x 4 block of scores and 4 rows of the output, row maxima and sums by
// half-warp shuffles.  The K and V tiles are read once per q tile (the 50 MB
// L2 serves the repeats).  Tensor cores (wgmma), TMA and a ring of tiles
// are the later, faster kernel's work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;          // query rows a CTA
constexpr int kBlockK = 64;          // KV slots a tile
constexpr int kThreads = 256;        // a 16 x 16 grid of threads
constexpr int kRows = kBlockQ / 16;  // query rows a thread
constexpr int kCols = kBlockK / 16;  // score columns a thread
constexpr int kMaxHead = 256;        // widest hd and hd_v
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as astype does
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, KH, Sq, Skv, hd, hd_v;
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;  // elements
  float scale, cap;
  int causal, window, kv_len, q_offset;
};

// NV: output columns a thread holds (hd_v <= 16 * NV).
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(Args a) {
  extern __shared__ float smem[];
  const int hd = a.hd, hd_v = a.hd_v;
  const int ldq = hd + 1;       // Q rows: a warp's two rows in two banks
  const int ldk = kBlockK + 1;  // K^T rows: the transposing store is free
  const int ldv = 16 * NV;      // V rows, zero past hd_v
  const int ldp = kBlockK + 1;  // P rows
  float* Qs = smem;                  // [kBlockQ][ldq]
  float* Kt = Qs + kBlockQ * ldq;    // [hd][ldk]
  float* Vs = Kt + hd * ldk;         // [kBlockK][ldv]
  float* Ps = Vs + kBlockK * ldv;    // [kBlockQ][ldp]

  const int iq = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KH);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* q = static_cast<const T*>(a.q) + b * a.qb + h * a.qh;
  const T* k = static_cast<const T*>(a.k) + b * a.kb + kvh * a.kh;
  const T* v = static_cast<const T*>(a.v) + b * a.vb + kvh * a.vh;
  T* o = static_cast<T*>(a.o) + b * a.ob + h * a.oh;

  const int q0 = iq * kBlockQ;
  for (int i = tid; i < kBlockQ * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    const int row = q0 + r;
    Qs[r * ldq + d] = row < a.Sq ? to_f32(q[row * a.qs + d]) : 0.f;
  }

  // the KV tiles with an unmasked element somewhere in this q tile
  const int q_lo = q0 + a.q_offset, q_hi = q_lo + kBlockQ - 1;
  int j_lo = 0, j_hi = (a.Skv + kBlockK - 1) / kBlockK - 1;
  if (a.causal) j_hi = min(j_hi, q_hi / kBlockK);            // k_lo <= q_hi
  if (a.window) {                                // k_hi >= q_lo - window + 1
    const int t = q_lo - a.window + 2 - kBlockK;
    if (t > 0) j_lo = (t + kBlockK - 1) / kBlockK;
  }

  float m[kRows], l[kRows], acc[kRows][NV];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int n = 0; n < NV; ++n) acc[r][n] = 0.f;
  }

  for (int j = j_lo; j <= j_hi; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();  // Qs stored; the last tile's Kt, Vs, Ps all read
    for (int i = tid; i < kBlockK * hd; i += kThreads) {
      const int c = i / hd, d = i - c * hd;
      const int kp = k0 + c;
      Kt[d * ldk + c] = kp < a.Skv ? to_f32(k[kp * a.ks + d]) : 0.f;
    }
    for (int i = tid; i < kBlockK * ldv; i += kThreads) {
      const int c = i / ldv, d = i - c * ldv;
      const int kp = k0 + c;
      Vs[i] = (kp < a.Skv && d < hd_v) ? to_f32(v[kp * a.vs + d]) : 0.f;
    }
    __syncthreads();

    // scores of rows ty + 16 r against columns tx + 16 c
    float s[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[r][c] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qa[kRows], kc[kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) qa[r] = Qs[(ty + 16 * r) * ldq + d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kc[c] = Kt[d * ldk + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[r][c] = fmaf(qa[r], kc[c], s[r][c]);
    }

    // online softmax: a row's 64 columns lie in the 16 lanes of one
    // half-warp, so xor shuffles below 16 reduce each row on its own
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q_lo + ty + 16 * r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int kp = k0 + tx + 16 * c;
        float x = s[r][c] * a.scale;
        if (a.cap != 0.f) x = a.cap * tanhf(x / a.cap);
        bool ok = kp < a.kv_len;
        if (a.causal) ok = ok && kp <= qp;
        if (a.window) ok = ok && kp > qp - a.window;
        x = ok ? x : kNegInf;
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p = expf(s[r][c] - m_new);
        Ps[(ty + 16 * r) * ldp + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * corr + sum;
#pragma unroll
      for (int n = 0; n < NV; ++n) acc[r][n] *= corr;
      m[r] = m_new;
    }
    __syncthreads();

    // acc[r][n] += sum_c p[r][c] v[c][tx + 16 n]
    for (int c = 0; c < kBlockK; ++c) {
      float vc[NV];
#pragma unroll
      for (int n = 0; n < NV; ++n) vc[n] = Vs[c * ldv + tx + 16 * n];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = Ps[(ty + 16 * r) * ldp + c];
#pragma unroll
        for (int n = 0; n < NV; ++n) acc[r][n] = fmaf(p, vc[n], acc[r][n]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= a.Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int col = tx + 16 * n;
      if (col < hd_v) store(o + row * a.os + col, acc[r][n] / den);
    }
  }
}

template <typename T, int NV>
int launch(const Args& a, cudaStream_t stream) {
  const size_t bytes =
      sizeof(float) * (kBlockQ * (a.hd + 1) + a.hd * (kBlockK + 1) +
                       kBlockK * 16 * NV + kBlockQ * (kBlockK + 1));
  if (bytes > 48 * 1024) {  // above 48 KB only as opted-in dynamic smem
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, NV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((a.Sq + kBlockQ - 1) / kBlockQ, a.H, a.B);
  flash_attention_kernel<T, NV><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_width(const Args& a, cudaStream_t stream) {
  if (a.hd_v <= 64) return launch<T, 4>(a, stream);
  if (a.hd_v <= 128) return launch<T, 8>(a, stream);
  return launch<T, 16>(a, stream);
}

}  // namespace

extern "C" int flash_attention_block_q() { return kBlockQ; }

extern "C" int flash_attention_block_k() { return kBlockK; }

extern "C" int flash_attention_max_head() { return kMaxHead; }

// dtype: 0 float32, 1 bfloat16 (q, k, v and the output alike).  Strides in
// elements: batch, sequence, head of q, k, v, o.  Launches on ``stream``,
// never synchronises; returns cudaGetLastError() (or the refused
// attribute's error).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KH, int Sq, int Skv, int hd, int hd_v, long long qb, long long qs,
    long long qh, long long kb, long long ks, long long kh, long long vb,
    long long vs, long long vh, long long ob, long long os, long long oh,
    float scale, float cap, int causal, int window, int kv_len, int q_offset,
    int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (KH <= 0 || H % KH || hd <= 0 || hd > kMaxHead || hd_v <= 0 ||
      hd_v > kMaxHead || kv_len < 0 || kv_len > Skv || q_offset < 0 ||
      window < 0 || H > 65535 || B > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,  k,  v,  o,  B,  H,  KH, Sq, Skv, hd, hd_v, qb,
               qs, qh, kb, ks, kh, vb, vs, vh, ob,  os, oh,   scale,
               cap, causal, window, kv_len, q_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_width<float>(a, st)
                    : launch_width<__nv_bfloat16>(a, st);
}
