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
// with head h reading KV head h / (H / K).
//
// The sentinel is the reference's finite NEG_INF = -1e30 with the
// max(l, 1e-30) clamp, not -INFINITY: a tile that is visited but fully
// masked for a row gives p = exp(0) = 1 on its masked entries; the row's
// next tile with an unmasked entry has corr = exp(-1e30 - m) = 0 and wipes
// them.  With -INFINITY the same row would give NaN.  KV tiles are visited
// by the reference's rule (kernel.py:62-66) on absolute positions: causal
// k_lo > q_hi and window k_hi < q_lo - window + 1 are skipped, for the
// CTA's rows; the plain version tiled like the kernel of its dtype
// (ops.KERNEL_BLOCKS) visits the same tiles.
//
// Layout: q (B, Sq, H, hd), k (B, Skv, K, hd), v (B, Skv, K, hd_v) and the
// output (B, Sq, H, hd_v), read and written through their batch, sequence
// and head strides (the last dim contiguous): no moveaxis, no padding copy,
// no replication of K or V over the group.  Rows past Sq are not stored,
// KV slots past Skv load as zeros and are masked by kv_len <= Skv, as the
// Pallas wrapper's zero padding is.  The TPU kernel's sequential KV grid
// axis (m, l and acc in VMEM scratch) is a loop inside the CTA, with m, l
// and the output accumulator in registers; causal grids start with the
// longest rows (iq reversed).
//
// Two kernels behind the one entry point, picked by dtype:
//
// bf16 (every timed forward): tensor cores.  What bounds it on an H100:
// operations.  At Qwen2-0.5B's scoring shape (B 4, S 4,096, H 14, K 2,
// hd 64, causal) the function needs 2 (hd + hd_v) FLOP for each of the
// S (S + 1) / 2 unmasked (q, k) pairs of each of the 56 (b, h): 1.20e11
// FLOP, 0.122 ms at 989 TFLOP/s bf16, against 67 MB of q, k, v and o,
// 20 us at 3.35 TB/s.  The design:
//   - wgmma.  A CTA is two warpgroups of 64 query rows (128 rows) over KV
//     tiles of 64 slots; S = Q K^T is wgmma m64n64k16 with Q and K read
//     by descriptor from shared memory, O += P V is wgmma m64n64k16 (one
//     a 64-column block of O) with P from registers and V by descriptor
//     (MN-major, transposed); f32 sums.
//   - P stays in registers: the f32 accumulator of S, after the scale,
//     the softcap, the mask and the exponent, is packed to bf16 pairs and
//     used as the A fragment of P V (a warp's 16 rows of the m64
//     accumulator have the m16n8k16 A layout).  Row maxima reduce over a
//     quad's 4 lanes; row sums stay per lane until the end.
//   - K and V tiles come by 16-byte cp.async into a two-stage ring (tile
//     j + 1 loads while tile j multiplies), rows past Skv and columns past
//     hd zero-filled (src-size 0), into wgmma's 128-byte swizzle (columns
//     in blocks of 64, 16-byte chunks XOR-ed with row % 8).
//   - Instances by head width: D = 64, 128 and 256, hd and hd_v
//     zero-padded in shared memory up to D.  O takes D / 2 registers a
//     thread: D = 64 runs two CTAs an SM, 128 and 256 one (at 128 two
//     would spill; 256 takes 193 KB of shared memory).
//   - The mask runs only on tiles that straddle the diagonal, a window
//     edge or kv_len for a warp's rows.  A tile that is fully masked for
//     every row of a warpgroup whose rows all attend their own position is
//     skipped by it: it would add p = 0 after the row's first unmasked
//     key, or be wiped by corr = 0 before it, exactly.
// Rounding against the reference (which keeps p in f32): P is rounded to
// bf16 before P V (the usual convention of GPU flash attention); the
// exponent is ex2.approx.ftz (MUFU.EX2, ~2 ulp; subnormal p flush to 0)
// with log2(e) folded into the scale, fused into one FMA with the row max
// on tiles without a mask or softcap; the softcap uses tanhf (not
// tanh.approx); l sums the f32 p.
//
// f32 (the checks' path, held at 2e-5: TF32 tensor cores keep ~3 digits):
// f32 FMAs on the CUDA cores (67 TFLOP/s), 64 x 64 tiles staged in shared
// memory as f32, each thread a 4 x 4 block of scores and 4 rows of the
// output, row maxima and sums by half-warp shuffles; p stays f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxHead = 256;  // widest hd and hd_v
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

// the first and last KV tile with an unmasked element for the query rows
// at absolute positions [q_lo, q_lo + bq) (kernel.py:62-66)
__device__ __forceinline__ void tile_range(const Args& a, int q_lo, int bq,
                                           int bk, int& j_lo, int& j_hi) {
  j_lo = 0;
  j_hi = (a.Skv + bk - 1) / bk - 1;
  if (a.causal) j_hi = min(j_hi, (q_lo + bq - 1) / bk);    // k_lo <= q_hi
  if (a.window) {                                // k_hi >= q_lo - window + 1
    const int t = q_lo - a.window + 2 - bk;
    if (t > 0) j_lo = (t + bk - 1) / bk;
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kBlockQ = 64;          // query rows a CTA
constexpr int kBlockK = 64;          // KV slots a tile
constexpr int kThreads = 256;        // a 16 x 16 grid of threads
constexpr int kRows = kBlockQ / 16;  // query rows a thread
constexpr int kCols = kBlockK / 16;  // score columns a thread

// NV: output columns a thread holds (hd_v <= 16 * NV).
template <int NV>
__global__ void __launch_bounds__(kThreads) kernel(Args a) {
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
  const float* q = static_cast<const float*>(a.q) + b * a.qb + h * a.qh;
  const float* k = static_cast<const float*>(a.k) + b * a.kb + kvh * a.kh;
  const float* v = static_cast<const float*>(a.v) + b * a.vb + kvh * a.vh;
  float* o = static_cast<float*>(a.o) + b * a.ob + h * a.oh;

  const int q0 = iq * kBlockQ;
  for (int i = tid; i < kBlockQ * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    const int row = q0 + r;
    Qs[r * ldq + d] = row < a.Sq ? q[row * a.qs + d] : 0.f;
  }

  const int q_lo = q0 + a.q_offset;
  int j_lo, j_hi;
  tile_range(a, q_lo, kBlockQ, kBlockK, j_lo, j_hi);

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
      Kt[d * ldk + c] = kp < a.Skv ? k[kp * a.ks + d] : 0.f;
    }
    for (int i = tid; i < kBlockK * ldv; i += kThreads) {
      const int c = i / ldv, d = i - c * ldv;
      const int kp = k0 + c;
      Vs[i] = (kp < a.Skv && d < hd_v) ? v[kp * a.vs + d] : 0.f;
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
      if (col < hd_v) o[row * a.os + col] = acc[r][n] / den;
    }
  }
}

template <int NV>
int launch(const Args& a, cudaStream_t stream) {
  const size_t bytes =
      sizeof(float) * (kBlockQ * (a.hd + 1) + a.hd * (kBlockK + 1) +
                       kBlockK * 16 * NV + kBlockQ * (kBlockK + 1));
  if (bytes > 48 * 1024) {  // above 48 KB only as opted-in dynamic smem
    const cudaError_t err = cudaFuncSetAttribute(
        kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((a.Sq + kBlockQ - 1) / kBlockQ, a.H, a.B);
  kernel<NV><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const Args& a, cudaStream_t stream) {
  if (a.hd_v <= 64) return launch<4>(a, stream);
  if (a.hd_v <= 128) return launch<8>(a, stream);
  return launch<16>(a, stream);
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
namespace bf16 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 2^x (MUFU.EX2; subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x in low bits
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Byte offset of the 16-byte chunk (row, chunk) of a ROWS-row bf16 tile
// in wgmma's 128-byte swizzle: the columns in blocks of 64 (128 bytes),
// each block a [ROWS][64] array whose chunks are XOR-ed with row % 8
// (tiles 1024-byte aligned).  A K-major operand (Q, K) takes its k-steps
// along the blocks, an MN-major one (V) its 64-column blocks.
template <int ROWS>
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (chunk >> 3) * (ROWS * 128) + row * 128 +
         (((chunk & 7) ^ (row & 7)) << 4);
}

// ROWS x D bf16 tile from rows [row0, row0 + ROWS) of g (stride ld): rows
// at or past n_rows and columns at or past width (a multiple of 8) zero
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* g,
                                          long long ld, int row0, int n_rows,
                                          int width, int tid) {
  constexpr int kChunks = D / 8;
  static_assert(ROWS * kChunks % NT == 0, "tile chunks divide the threads");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / NT; ++i) {
    const int idx = tid + i * NT;
    const int r = idx / kChunks, c = idx % kChunks;
    const int row = row0 + r;
    const bool ok = row < n_rows && c * 8 < width;
    const __nv_bfloat16* src = ok ? g + row * ld + c * 8 : g;
    cp_async16(dst + swz<ROWS>(r, c), src, ok ? 16 : 0);
  }
}

// What a CTA shares: its (b, h) slices, its query tile, the KV tiles it
// visits and the softmax constants.
struct Cta {
  const __nv_bfloat16 *q, *k, *v;
  __nv_bfloat16* o;
  int q0, q_lo, j_lo, j_hi;
  float scale2, cap_in, cap2;

  __device__ __forceinline__ Cta(const Args& a, int bq, int bk) {
    const int iq = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
    const int h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / (a.H / a.KH);
    q = static_cast<const __nv_bfloat16*>(a.q) + b * a.qb + h * a.qh;
    k = static_cast<const __nv_bfloat16*>(a.k) + b * a.kb + kvh * a.kh;
    v = static_cast<const __nv_bfloat16*>(a.v) + b * a.vb + kvh * a.vh;
    o = static_cast<__nv_bfloat16*>(a.o) + b * a.ob + h * a.oh;
    q0 = iq * bq;
    q_lo = q0 + a.q_offset;
    tile_range(a, q_lo, bq, bk, j_lo, j_hi);
    scale2 = a.scale * kLog2e;  // no softcap
    cap_in = a.cap != 0.f ? a.scale / a.cap : 0.f;
    cap2 = a.cap * kLog2e;
  }
};

// Whether rows [lo, lo + n) may skip the KV tile at k0: it is fully
// masked for all of them, and each attends its own position, so the tile
// would add p = 0 after a row's first unmasked key or be wiped by
// corr = 0 before it, exactly (see the header).
__device__ __forceinline__ bool skip_tile(const Args& a, int k0, int bk,
                                          int lo, int n) {
  const int hi = lo + n - 1;
  const bool dead = (a.causal && k0 > hi) ||
                    (a.window && k0 + bk - 1 <= lo - a.window) ||
                    k0 >= a.kv_len;
  return dead && hi < a.kv_len;
}

// One KV tile's scores s of a warp's 16 rows (the m16 accumulator layout:
// rows w_lo + g in e = 0, 1 and w_lo + g + 8 in e = 2, 3, columns
// k0 + 8 n + 2 t4 + e % 2) -> P as bf16 A fragments pf, with the online
// softmax's update of m, l (per lane: summed over the quad at the end)
// and acc.  The softcap and, on tiles that straddle an edge for these
// rows, the mask run in the log2 domain; without either, the scale is
// left to the exponent's FMA (sc).
template <int NS, int NO>
__device__ __forceinline__ void softmax_tile(
    const Args& a, const Cta& c, int k0, int w_lo, int g, int t4,
    float (&s)[NS][4], float (&m)[2], float (&l)[2], float (&acc)[NO][4],
    uint32_t (&pf)[NS][2]) {
  const int pos0 = w_lo + g, pos1 = pos0 + 8;
  const bool edge = (a.causal && k0 + 8 * NS - 1 > w_lo) ||
                    (a.window && k0 <= w_lo + 15 - a.window) ||
                    k0 + 8 * NS > a.kv_len;
  const bool capped = a.cap != 0.f;
  const float sc = capped || edge ? 1.f : c.scale2;
  if (capped || edge) {
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e];
        x = capped ? c.cap2 * tanhf(x * c.cap_in) : x * c.scale2;
        if (edge) {
          const int col = k0 + 8 * n + 2 * t4 + (e & 1);
          const int qp = e < 2 ? pos0 : pos1;
          bool ok = col < a.kv_len;
          if (a.causal) ok = ok && col <= qp;
          if (a.window) ok = ok && col > qp - a.window;
          x = ok ? x : kNegInf;
        }
        s[n][e] = x;
      }
  }
  // rows g (e = 0, 1) and g + 8 (e = 2, 3) span the quad's 4 lanes
  float corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = kNegInf;
#pragma unroll
    for (int n = 0; n < NS; ++n)
      mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx * sc);  // sc > 0 keeps the order
    corr[i] = ex2(m[i] - m_new);
    m[i] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const float p0 = ex2(fmaf(s[n][0], sc, -m[0]));
    const float p1 = ex2(fmaf(s[n][1], sc, -m[0]));
    const float p2 = ex2(fmaf(s[n][2], sc, -m[1]));
    const float p3 = ex2(fmaf(s[n][3], sc, -m[1]));
    sum[0] += p0 + p1;
    sum[1] += p2 + p3;
    pf[n][0] = pack(p0, p1);
    pf[n][1] = pack(p2, p3);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    acc[n][0] *= corr[0];
    acc[n][1] *= corr[0];
    acc[n][2] *= corr[1];
    acc[n][3] *= corr[1];
  }
}

// o rows row0 and row0 + 8 (this lane's) = acc / max(l, 1e-30), in bf16
template <int NO>
__device__ __forceinline__ void store_rows(const Args& a, const Cta& c,
                                           int row0, int t4,
                                           const float (&acc)[NO][4],
                                           float (&l)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // l was summed per lane: add up the quad
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float inv0 = 1.f / fmaxf(l[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l[1], 1e-30f);
  const int row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = 8 * n + 2 * t4;  // hd_v is even: col + 1 < hd_v too
    if (col >= a.hd_v) continue;
    if (row0 < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(c.o + row0 * a.os + col) =
          __floats2bfloat162_rn(acc[n][0] * inv0, acc[n][1] * inv0);
    if (row1 < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(c.o + row1 * a.os + col) =
          __floats2bfloat162_rn(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

// shared-memory matrix descriptor, 128-byte swizzle; lbo and sbo in
// 16-byte units (sbo: from one 8-row group to the next)
__device__ __forceinline__ uint64_t desc(uint32_t addr, int lbo, int sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo) << 16 |
         static_cast<uint64_t>(sbo) << 32 | 1ull << 62;
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x 64, f32) += A (64 x 16, K-major in smem) * B (16 x 64, K-major)
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// d (64 x 64, f32) += A (64 x 16, bf16 fragments) * B (16 x 64, MN-major)
__device__ __forceinline__ void mma_rs(float (&d)[32],
                                       const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// Two warpgroups of 64 query rows a CTA, KV tiles of 64 slots, D the
// padded head width (hd and hd_v <= D).
constexpr int kWarpgroups = 2;
constexpr int kBlockQ = 64 * kWarpgroups, kBlockK = 64;
constexpr int kThreads = 128 * kWarpgroups;

template <int D>
struct Smem {
  static constexpr int kQ = kBlockQ * D * 2;
  static constexpr int kTile = kBlockK * D * 2;  // a K or a V stage
  static constexpr int kBytes = kQ + 4 * kTile + 1024;  // + alignment
};

// Registers: O is D / 2 a thread; two CTAs an SM fit without spilling
// at D = 64 only.
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
    kernel(Args a) {
  constexpr int NS = kBlockK / 8, NO = D / 8;
  constexpr int kTile = Smem<D>::kTile;
  extern __shared__ unsigned char smem[];
  const uint32_t s_q = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t s_k = s_q + Smem<D>::kQ;
  const uint32_t s_v = s_k + 2 * kTile;

  const Cta c(a, kBlockQ, kBlockK);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;  // the accumulator's row group, lane
  const int wgi = warp / 4;
  // the warp's rows: absolute positions [w_lo, w_lo + 16); this lane holds
  // rows g and g + 8 of them; its warpgroup's are [c.q_lo + 64 wgi, + 64)
  const int w_lo = c.q_lo + 16 * warp;

  load_tile<kBlockQ, D, kThreads>(s_q, c.q, a.qs, c.q0, a.Sq, a.hd, tid);
  if (c.j_lo <= c.j_hi) {
    load_tile<kBlockK, D, kThreads>(s_k, c.k, a.ks, c.j_lo * kBlockK, a.Skv,
                                    a.hd, tid);
    load_tile<kBlockK, D, kThreads>(s_v, c.v, a.vs, c.j_lo * kBlockK, a.Skv,
                                    a.hd_v, tid);
  }
  cp_async_commit();

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // this warpgroup's 64 rows of Q: the block of 64 columns holding k-step
  // ks starts at ks / 4 blocks, 32 bytes a k-step into it
  const uint32_t s_qw = s_q + wgi * 64 * 128;

  int stage = 0;
  for (int j = c.j_lo; j <= c.j_hi; ++j) {
    if (j < c.j_hi) {  // tile j + 1 into the other stage, read at j - 1
      load_tile<kBlockK, D, kThreads>(s_k + (stage ^ 1) * kTile, c.k, a.ks,
                                      (j + 1) * kBlockK, a.Skv, a.hd, tid);
      load_tile<kBlockK, D, kThreads>(s_v + (stage ^ 1) * kTile, c.v, a.vs,
                                      (j + 1) * kBlockK, a.Skv, a.hd_v, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // Q and tile j have landed
    // cp.async wrote through the generic proxy; wgmma reads through the
    // async one
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int k0 = j * kBlockK;
    if (!skip_tile(a, k0, kBlockK, c.q_lo + 64 * wgi, 64)) {  // warpgroup
      const uint32_t sk = s_k + stage * kTile;
      const uint32_t sv = s_v + stage * kTile;
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      float(&sd)[32] = reinterpret_cast<float(&)[32]>(s);
      fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = ks / 4 * kBlockK * 128 + ks % 4 * 32;
        mma_ss(sd, desc(s_qw + ks / 4 * kBlockQ * 128 + ks % 4 * 32, 1, 64),
               desc(sk + off, 1, 64));
      }
      commit_and_wait();
      uint32_t pf[NS][2];
      softmax_tile(a, c, k0, w_lo, g, t4, s, m, l, acc, pf);
      fence();
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {  // 16 KV rows (2 KB)
        const uint32_t pa[4] = {pf[2 * kk][0], pf[2 * kk][1],
                                pf[2 * kk + 1][0], pf[2 * kk + 1][1]};
#pragma unroll
        for (int nb = 0; nb < D / 64; ++nb)  // 64 output columns a block
          mma_rs(reinterpret_cast<float(&)[32]>(acc[8 * nb]), pa,
                 desc(sv + nb * kBlockK * 128 + 2048 * kk, 64, 64));
      }
      commit_and_wait();
    }
    __syncthreads();  // the stage is read before tile j + 2 lands in it
    stage ^= 1;
  }
  cp_async_wait<0>();
  store_rows(a, c, c.q0 + 16 * warp + g, t4, acc, l);
}

template <int D>
int launch(const Args& a, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<D>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + kBlockQ - 1) / kBlockQ, a.H, a.B);
  kernel<D><<<grid, kThreads, Smem<D>::kBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the instance by the wider of hd and hd_v
int dispatch(const Args& a, cudaStream_t stream) {
  const int w = a.hd > a.hd_v ? a.hd : a.hd_v;
  if (w <= 64) return launch<64>(a, stream);
  if (w <= 128) return launch<128>(a, stream);
  if (w <= 256) return launch<256>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace bf16

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and the output alike).  Strides in
// elements: batch, sequence, head of q, k, v, o; for bfloat16 every base
// pointer and stride 16-byte aligned and hd, hd_v multiples of 8 (the
// wrapper checks).  Launches on ``stream``, never synchronises; returns
// cudaGetLastError() (or the refused attribute's error).
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
      window < 0 || H > 65535 || B > 65535 || (dtype != 0 && dtype != 1) ||
      (dtype == 1 && (hd % 8 || hd_v % 8)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,  k,  v,  o,  B,  H,  KH, Sq, Skv, hd, hd_v, qb,
               qs, qh, kb, ks, kh, vb, vs, vh, ob,  os, oh,   scale,
               cap, causal, window, kv_len, q_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? f32::dispatch(a, st) : bf16::dispatch(a, st);
}
