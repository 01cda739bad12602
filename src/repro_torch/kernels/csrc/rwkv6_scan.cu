// RWKV-6 time-mix recurrence: a matrix state per (batch, head) with a
// data-dependent per-channel decay (the RWKV-6 mixer's scan).
//
// Replaces the TPU kernel src/repro/kernels/linear_scan/kernel.py,
// rwkv6_scan_bhsd (body _rwkv6_kernel).  Per (batch b, head h), with the
// state S (hd x hd, f32) starting at state0[b, h], for t = 0 .. S_len - 1:
//     y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//     S[i][j] = w_t[i] S[i][j] + k_t[i] v_t[j]
// and S_T = S at the end.  The math is float32 from f32 or bf16 r, k, v and
// an f32 decay w in [0, 1]; y and S_T are f32.
//
// Layout: r, k, v (bf16 or f32) and w (f32) are (B, S, H, hd) read through
// their batch, sequence and head strides (last dim contiguous): no moveaxis
// and no cast copies.  y is written as (B, S, H, hd) f32 and S_T as
// (B, H, hd, hd) f32.  Both bodies are built for hd = HD = 64 (RWKV-6's
// head width); a narrower head is padded past hd with zero r, k, v and S0
// and decay 1, so the padded rows and columns stay zero and add nothing.
// Two bodies, one entry point each; the wrapper (linear_scan/ops.py) sends
// a sequence shorter than SHORT_SEQ = 16 tokens (a decode step) to the
// exact per-token body and a longer one to the chunked body.
//
// What bounds it on an H100: bytes.  At the scoring shape (B 4, S 4,096,
// H 40, hd 64) r, k, v (bf16) and w read once and y written once are
// 592 MB, 0.177 ms at 3.35 TB/s.  The recurrence's arithmetic (5 FLOP a
// state element a step, 1.34e10 FLOP) takes 0.200 ms on the CUDA cores at
// 67 TFLOP/s f32, 0.081 ms as 3xTF32 on the tensor cores.  The chunked
// body is slower than both (PERF.md): each chunk is a chain of dependent
// phases, separated by barriers, run by one warp a scheduler, so latency
// bounds it, not the tensor cores' rate; and 160 CTAs fill 132 SMs
// unevenly (28 SMs run two).
//
// The chunked body.  The TPU kernel's single-level chunked form multiplies
// k by exp(-cumsum log w) and overflows once sum |log w| over a chunk
// passes ~80.  This body uses the two-level ("secondary") chunking of
// gated linear attention (Yang et al. 2023, s. 4): every decay factor is a
// product of w over a range of tokens inside one chunk, so none exceeds 1
// or overflows for any w in [0, 1]; one underflows only where the exact
// product does, and w = 0 gives exact zeros.  The factors are running
// products of w (at most 64 factors, within ~64 ulp; no log, no exp and so
// no clamp).  Chunks of T = 64 tokens, blocks of L = 8 tokens (one n8 tile
// of mma.m16n8k8; two blocks make an m16 tile):
//   - inter-chunk: y_t += (r_t Pf_t P_I) S_c, with Pf_t the product of w
//     over the tokens of t's block I before t and P_I over the blocks
//     before I;
//   - state carry: S_{c+1} = D S_c + sum_s (k_s Pr_s X_J)^T v_s, with Pr_s
//     the product over the tokens of s's block J after s, X_J over the
//     blocks after J and D over the chunk;
//   - pairs in different blocks (s in J < I, t in I): the decay between
//     them splits at the end of J into Pf_t M_IJ and Pr_s, M_IJ the product
//     over the blocks between; a 16 x 64 by 64 x 8 product a (row pair,
//     key block) tile on the tensor cores;
//   - pairs inside one block and the bonus u on the diagonal: each pair
//     directly on the CUDA cores, r_t k_s times a running product of w in
//     f32 (28 pairs and 8 diagonals a block, 64 channels).
// Products run at f32 accuracy on the tensor cores by 3xTF32 (CUTLASS's
// OpMultiplyAddFastF32 scheme): each f32 operand x goes in as big = x,
// which the tensor core reads truncated to TF32, and small = x - trunc(x),
// and small.big + big.small + big.big accumulate in f32 (~2^-20 relative a
// product); a bf16 v is exact in TF32, so its products take two passes.
// One TF32 pass (~1e-3 relative) would miss the checks' 1e-4.
//
// Work split: one CTA of 4 warps per (b, h) (grid (H, B)), two CTAs an SM
// (109 KB of shared memory for bf16).  Warp w owns the value columns
// [16 w, 16 w + 16): its slice of S^T (16 x 64, f32) stays in mma
// accumulator registers for the whole sweep, and y^T = S^T (r Pf P)^T
// reads those accumulators as its A fragments with the k index permuted
// (slot tig <-> channel 2 tig, slot tig + 4 <-> 2 tig + 1), so the state
// never goes through shared memory.  (Eight warps of 8 columns, with the
// state's fragments moved by shuffles, measured slower: every warp splits
// the shared operands, and 128 registers a thread spill.)  The
// column-independent work of a chunk (decay products, the in-block pairs,
// the cross-block tiles) is spread over all four warps; r Pf P and k Pr X
// are formed once a chunk, in place.  r, k, v and w of a chunk come by
// 16-byte cp.async into a two-stage ring: chunk c + 1 loads while chunk c
// computes; tokens past S and channels past hd are zero-filled (src-size
// 0), and the decay products read w as 1 there.  After the products, r Pf
// overwrites w and k Pr overwrites r and k in the stage (XOR-swizzled
// rows: conflict-free for both the row-wise and the column-wise fragment
// reads).  Inputs whose rows are not 16-byte aligned are staged by plain
// loads instead.
//
// The per-token body.  Exact per-token recurrence on the CUDA cores, one
// CTA of 128 threads per (b, h): thread (column j, half g) owns column j of
// S for the HD / 2 rows {8 p + 4 g + e}; the two halves of a column are
// lanes l and l ^ 16 of one warp and add by one shuffle.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;      // widest hd: the state is HD x HD

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

// ---------------------------------------------------------------------------
// The per-token body
// ---------------------------------------------------------------------------
namespace step {

constexpr int kChunk = 32;  // tokens staged in shared memory at a time

template <typename T>
__global__ void __launch_bounds__(2 * HD) kernel(Args a) {
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
  kernel<T><<<dim3(a.H, a.B), 2 * HD, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace step

// ---------------------------------------------------------------------------
// The chunked body
// ---------------------------------------------------------------------------
namespace chunk {

constexpr int T = 64;          // tokens a chunk
constexpr int L = 8;           // tokens a block (one n8 tile)
constexpr int NB = T / L;      // blocks a chunk
constexpr int W = 4;           // warps; warp w owns columns [16 w, 16 w + 16)
constexpr int NT = 32 * W;
constexpr int VROW = HD + 8;   // v's staged row, in elements
constexpr int AROW = T + 4;    // the in-chunk pair matrix's row, in floats
constexpr int NM = 12;         // M_{2a, J} for J < 2a, a = 1 .. 3
constexpr int NTILE = 16;      // cross-block tiles: (row pair a, key block J)

// Bytes of one stage: r then k (Pr k after the products), w (Pf r after
// the products), v; then, once, the pair matrix A and the block tables.
template <typename E>
struct Smem {
  static constexpr int kRK = 2 * T * HD * static_cast<int>(sizeof(E));
  static constexpr int kW = T * HD * 4;
  static constexpr int kV = T * VROW * static_cast<int>(sizeof(E));
  static constexpr int kStage = kRK + kW + kV;
  static constexpr int kA = T * AROW * 4;
  // G (NB), the prefix products (NB + 1: the last is D), the suffix
  // products (NB), M (NM), zeros, ones, u, each HD floats
  static constexpr int kTables = (NB + NB + 1 + NB + NM + 3) * HD * 4;
  static constexpr int kBytes = 2 * kStage + kA + kTables;
};

// element (s, i) of a 64-float row-major tile with 8-float groups XOR-ed by
// row % 4: conflict-free for 64-bit reads along a row (8 rows a half-warp)
// and 32-bit reads down a column (4 rows x 8 columns a warp)
__device__ __forceinline__ int swz(int s, int i) {
  return s * HD + (i ^ ((s & 3) << 3));
}

// x = big + small for the TF32 tensor cores, which read the upper 19 bits
// of each f32 register (truncation): big is x itself (read as trunc(x)),
// small = x - trunc(x) exactly (read as its truncation).  Two integer / FP
// instructions, none on the conversion unit (a quarter of the FP32 rate).
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = __float_as_uint(x);
  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b at f32 accuracy (3xTF32) from the split operands: small.big,
// big.small, big.big; with EXACT_A, a is exact in TF32 and its small
// half's product is dropped
template <bool EXACT_A>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  if (!EXACT_A) mma(c, as, bb[0], bb[1]);
  mma(c, ab, bs[0], bs[1]);
  mma(c, ab, bb[0], bb[1]);
}

// the A fragment of four values, split unless exact
template <bool EXACT>
__device__ __forceinline__ void split4(float x0, float x1, float x2, float x3,
                                       uint32_t (&ab)[4], uint32_t (&as)[4]) {
  if (EXACT) {
    ab[0] = __float_as_uint(x0);
    ab[1] = __float_as_uint(x1);
    ab[2] = __float_as_uint(x2);
    ab[3] = __float_as_uint(x3);
    as[0] = as[1] = as[2] = as[3] = 0u;
  } else {
    split(x0, ab[0], as[0]);
    split(x1, ab[1], as[1]);
    split(x2, ab[2], as[2]);
    split(x3, ab[3], as[3]);
  }
}

// the B fragment of two values, split
__device__ __forceinline__ void split2(float x0, float x1, uint32_t (&bb)[2],
                                       uint32_t (&bs)[2]) {
  split(x0, bb[0], bs[0]);
  split(x1, bb[1], bs[1]);
}

__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// four consecutive elements as f32
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(x.x << 16);
  o[1] = __uint_as_float(x.x & 0xffff0000u);
  o[2] = __uint_as_float(x.y << 16);
  o[3] = __uint_as_float(x.y & 0xffff0000u);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

// one chunk's r, k, v and w into a stage; zeros past S and past hd.  vec:
// every row 16-byte aligned (cp.async; thread tid copies the same 16-byte
// column of rows tid / per_row + NT / per_row * j), else plain loads.
template <typename E>
__device__ __forceinline__ void stage(const Args& a, const E* r, const E* k,
                                      const E* v, const float* w, int t0,
                                      char* buf, bool vec) {
  E* rs = reinterpret_cast<E*>(buf);
  E* ks = rs + T * HD;
  float* ws = reinterpret_cast<float*>(buf + Smem<E>::kRK);
  E* vs = reinterpret_cast<E*>(buf + Smem<E>::kRK + Smem<E>::kW);
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int EC = 16 / static_cast<int>(sizeof(E));  // elements a copy
    constexpr int PR = HD / EC, PW = HD / 4;  // copies a row of r, of w
    {
      const int e = (tid % PR) * EC;
      const bool in_row = e < a.hd;
#pragma unroll
      for (int t = tid / PR; t < T; t += NT / PR) {
        const bool ok = in_row && t0 + t < a.S;
        const long long tt = ok ? t0 + t : 0;
        const int ee = ok ? e : 0;  // no address past the tensors
        cp16(rs + t * HD + e, r + tt * a.rs + ee, ok);
        cp16(ks + t * HD + e, k + tt * a.ks + ee, ok);
        cp16(vs + t * VROW + e, v + tt * a.vs + ee, ok);
      }
    }
    const int e = (tid % PW) * 4;
    const bool in_row = e < a.hd;
#pragma unroll
    for (int t = tid / PW; t < T; t += NT / PW) {
      const bool ok = in_row && t0 + t < a.S;
      cp16(ws + t * HD + e, w + (ok ? t0 + t : 0) * a.ws + (ok ? e : 0), ok);
    }
  } else {
    const E zero = E(0.f);
    for (int c = tid; c < T * HD; c += NT) {
      const int t = c / HD, e = c % HD;
      const bool ok = t0 + t < a.S && e < a.hd;
      const long long tt = t0 + t;
      rs[t * HD + e] = ok ? r[tt * a.rs + e] : zero;
      ks[t * HD + e] = ok ? k[tt * a.ks + e] : zero;
      vs[t * VROW + e] = ok ? v[tt * a.vs + e] : zero;
      ws[t * HD + e] = ok ? w[tt * a.ws + e] : 0.f;
    }
  }
}

// x[e] *= w[e] for the four e, where on
__device__ __forceinline__ void scale_if(bool on, float* x, const float* w) {
  asm("{\n .reg .pred p;\n setp.ne.b32 p, %4, 0;\n"
      " @p mul.f32 %0, %0, %5;\n @p mul.f32 %1, %1, %6;\n"
      " @p mul.f32 %2, %2, %7;\n @p mul.f32 %3, %3, %8;\n}"
      : "+f"(x[0]), "+f"(x[1]), "+f"(x[2]), "+f"(x[3])
      : "r"(static_cast<int>(on)), "f"(w[0]), "f"(w[1]), "f"(w[2]),
        "f"(w[3]));
}

template <typename E>
__global__ void __launch_bounds__(NT, 2) kernel(Args a, int vec) {
  using S_ = Smem<E>;
  constexpr bool kExactV = sizeof(E) == 2;  // bf16 v is exact in TF32
  extern __shared__ __align__(16) char smem[];
  float* A_s = reinterpret_cast<float*>(smem + 2 * S_::kStage);
  float* G_s = A_s + T * AROW;      // [NB][HD]  block totals
  float* P_s = G_s + NB * HD;       // [NB + 1][HD]  prefix products; D last
  float* X_s = P_s + (NB + 1) * HD;  // [NB][HD]  suffix products
  float* M_s = X_s + NB * HD;       // [NM][HD]  M_{2a, J}
  float* Z_s = M_s + NM * HD;       // [HD]  zeros
  float* O_s = Z_s + HD;            // [HD]  ones
  float* u_s = O_s + HD;            // [HD]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int hd = a.hd;
  const E* r = static_cast<const E*>(a.r) + b * a.rb + h * a.rh;
  const E* k = static_cast<const E*>(a.k) + b * a.kb + h * a.kh;
  const E* v = static_cast<const E*>(a.v) + b * a.vb + h * a.vh;
  const float* w = a.w + b * a.wb + h * a.wh;
  float* y = a.y + (static_cast<long long>(b) * a.S * a.H + h) * hd;
  const long long ys = static_cast<long long>(a.H) * hd;
  const long long bh = static_cast<long long>(b) * a.H + h;

  if (tid < HD) {
    u_s[tid] = tid < hd ? a.u[h * hd + tid] : 0.f;
    Z_s[tid] = 0.f;
    O_s[tid] = 1.f;
  }

  // st[n]: S[i][j] for i = 8 n + 2 tig (+1) and j = j0, j1 (the mma
  // accumulator layout of S^T, rows j, columns i); warp w owns columns
  // [16 w, 16 w + 16)
  const int j0 = 16 * warp + g, j1 = j0 + 8;
  float st[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ii = 8 * n + 2 * tig + (e & 1), jj = e < 2 ? j0 : j1;
      st[n][e] = ii < hd && jj < hd ? a.s0[(bh * hd + ii) * hd + jj] : 0.f;
    }
  }

  const int n_chunks = (a.S + T - 1) / T;
  stage(a, r, k, v, w, 0, smem, vec);
  asm volatile("cp.async.commit_group;\n" ::);
  if (n_chunks > 1) stage(a, r, k, v, w, T, smem + S_::kStage, vec);
  asm volatile("cp.async.commit_group;\n" ::);

  for (int c = 0; c < n_chunks; ++c) {
    char* buf = smem + (c & 1) * S_::kStage;
    const E* rs = reinterpret_cast<const E*>(buf);
    const E* ks = rs + T * HD;
    float* ws = reinterpret_cast<float*>(buf + S_::kRK);
    const E* vs = reinterpret_cast<const E*>(buf + S_::kRK + S_::kW);
    float* Qh = ws;                             // r Pf, over w
    float* Kh = reinterpret_cast<float*>(buf);  // k Pr, over r and k
    const int t0 = c * T;
    asm volatile("cp.async.wait_group 1;\n" ::);  // this chunk has landed
    __syncthreads();

    // -- pairs inside a block, on the CUDA cores: warp w takes blocks w and
    //    w + W.  Lane (token tt, quarter q4) holds the 16 channels
    //    16 m + 4 q4 + e of r_t times the product of w since the key.
#pragma unroll 1
    for (int I = warp; I < NB; I += W) {
      const int q4 = lane & 3, tt = lane >> 2, t = L * I + tt;
      float rp[16], part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int ch = 16 * m + 4 * q4;
        float kk[4];
        load4(rs + t * HD + ch, rp + 4 * m);
        load4(ks + t * HD + ch, kk);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[m] = fmaf(rp[4 * m + e] * u_s[ch + e], kk[e], part[m]);
      }
      const float bonus = (part[0] + part[1]) + (part[2] + part[3]);
      float acc[L];
#pragma unroll
      for (int s = L - 1; s >= 0; --s) {
        const int ts = L * I + s;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          float kk[4];
          load4(ks + ts * HD + 16 * m + 4 * q4, kk);
          part[m] = rp[4 * m] * kk[0];
#pragma unroll
          for (int e = 1; e < 4; ++e)
            part[m] = fmaf(rp[4 * m + e], kk[e], part[m]);
        }
        const float dot = (part[0] + part[1]) + (part[2] + part[3]);
        acc[s] = s < tt ? dot : (s == tt ? bonus : 0.f);
#pragma unroll
        for (int m = 0; m < 4; ++m) {  // the key is before this lane's token
          float ww[4];
          load4(ws + ts * HD + 16 * m + 4 * q4, ww);
          scale_if(s < tt, rp + 4 * m, ww);
        }
      }
      float lo = 0.f, hi = 0.f;
#pragma unroll
      for (int s = 0; s < L; ++s) {
        acc[s] += __shfl_xor_sync(0xffffffffu, acc[s], 1);
        acc[s] += __shfl_xor_sync(0xffffffffu, acc[s], 2);
        if (s == 2 * q4) lo = acc[s];
        if (s == 2 * q4 + 1) hi = acc[s];
      }
      *reinterpret_cast<float2*>(A_s + t * AROW + L * I + 2 * q4) =
          make_float2(lo, hi);
    }

    // -- decay products inside each block: thread (channel ci, jq) takes
    //    blocks NJ jq .. NJ jq + NJ - 1; held in registers until every
    //    thread has read r, k and w
    constexpr int NJ = NB * HD / NT;  // blocks a thread
    const int ci = tid & (HD - 1), jq = tid / HD;
    float qh[NJ][L], kh[NJ][L];
#pragma unroll
    for (int q = 0; q < NJ; ++q) {
      const int J = NJ * jq + q;
      float wv[L];
#pragma unroll
      for (int e = 0; e < L; ++e) {
        const int t = L * J + e;
        wv[e] = t0 + t < a.S && ci < hd ? ws[t * HD + ci] : 1.f;
      }
      float p = 1.f;
#pragma unroll
      for (int e = 0; e < L; ++e) {
        qh[q][e] = to_f32(rs[(L * J + e) * HD + ci]) * p;
        p *= wv[e];
      }
      G_s[J * HD + ci] = p;
      p = 1.f;
#pragma unroll
      for (int e = L - 1; e >= 0; --e) {
        kh[q][e] = to_f32(ks[(L * J + e) * HD + ci]) * p;
        p *= wv[e];
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < NJ; ++q) {
#pragma unroll
      for (int e = 0; e < L; ++e) {
        const int t = L * (NJ * jq + q) + e;
        Qh[swz(t, ci)] = qh[q][e];
        Kh[swz(t, ci)] = kh[q][e];
      }
    }
    if (tid < HD) {  // the block tables of channel tid
      float gv[NB];
#pragma unroll
      for (int J = 0; J < NB; ++J) gv[J] = G_s[J * HD + tid];
      float p = 1.f;
#pragma unroll
      for (int I = 0; I < NB; ++I) {
        P_s[I * HD + tid] = p;
        p *= gv[I];
      }
      P_s[NB * HD + tid] = p;
      p = 1.f;
#pragma unroll
      for (int J = NB - 1; J >= 0; --J) {
        X_s[J * HD + tid] = p;
        p *= gv[J];
      }
#pragma unroll
      for (int J = 0; J < NB - 2; ++J) {  // M_{2a, J}: blocks J+1 .. 2a-1
        p = 1.f;
#pragma unroll
        for (int I = J + 1; I < NB - 1; ++I) {
          if (I % 2 == 0) M_s[((I / 2) * (I / 2 - 1) + J) * HD + tid] = p;
          p *= gv[I];
        }
      }
    }
    __syncthreads();

    // -- pairs in different blocks, on the tensor cores: tile (a, J) is
    //    rows 16 a .. 16 a + 15 (blocks 2a, 2a + 1) by the keys of block
    //    J <= 2a, r Pf of a row of block I scaled by M_IJ (the decay splits
    //    at the end of J); rows of block 2a only when J < 2a (scale 0
    //    otherwise).  Warp w takes tiles w, w + W, ..., one accumulator
    //    each.  k slot tig is channel 2 tig and slot tig + 4 channel
    //    2 tig + 1 of each 8 (64-bit reads).
    {
      constexpr int NQ = NTILE / W;
      int pa[NQ], Jt[NQ];
      const float *sl[NQ], *sh[NQ], *sg[NQ];  // the rows' scales, by channel
      float cc[NQ][4];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int tile = warp + W * q;
        pa[q] = tile < 1 ? 0 : tile < 4 ? 1 : tile < 9 ? 2 : 3;
        Jt[q] = tile - pa[q] * pa[q];
        const bool lo = Jt[q] < 2 * pa[q];
        const float* m = M_s + (pa[q] * (pa[q] - 1) + Jt[q]) * HD;
        sl[q] = lo ? m : Z_s;                 // block 2a: M_{2a, J}
        sh[q] = lo ? m : O_s;                 // block 2a + 1: M_{2a, J} G_2a
        sg[q] = lo ? G_s + 2 * pa[q] * HD : O_s;
        cc[q][0] = cc[q][1] = cc[q][2] = cc[q][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        const int i = 8 * kk + 2 * tig;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int tl = 2 * L * pa[q] + g;
          const float2 ql = lds2(Qh + swz(tl, i));
          const float2 qu = lds2(Qh + swz(tl + L, i));
          const float2 kv = lds2(Kh + swz(L * Jt[q] + g, i));
          const float2 ml = lds2(sl[q] + i), mg = lds2(sg[q] + i);
          float2 mh = lds2(sh[q] + i);
          mh = make_float2(mh.x * mg.x, mh.y * mg.y);
          uint32_t ab[4], as[4], bb[2], bs[2];
          split4<false>(ql.x * ml.x, qu.x * mh.x, ql.y * ml.y, qu.y * mh.y,
                        ab, as);
          split2(kv.x, kv.y, bb, bs);
          mma3<false>(cc[q], ab, as, bb, bs);
        }
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int tl = 2 * L * pa[q] + g, col = L * Jt[q] + 2 * tig;
        if (Jt[q] < 2 * pa[q])
          *reinterpret_cast<float2*>(A_s + tl * AROW + col) =
              make_float2(cc[q][0], cc[q][1]);
        *reinterpret_cast<float2*>(A_s + (tl + L) * AROW + col) =
            make_float2(cc[q][2], cc[q][3]);
      }
    }
    __syncthreads();

    // -- once a chunk, in place: r Pf P_I for the inter-chunk term and
    //    k Pr X_J for the state carry (thread (ci, jq), as the products)
#pragma unroll
    for (int q = 0; q < NJ; ++q) {
      const int J = NJ * jq + q;
      const float pq = P_s[J * HD + ci], xq = X_s[J * HD + ci];
#pragma unroll
      for (int e = 0; e < L; ++e) {
        Qh[swz(L * J + e, ci)] *= pq;
        Kh[swz(L * J + e, ci)] *= xq;
      }
    }
    __syncthreads();

    // -- this warp's 16 value columns: y^T = S^T (r Pf P)^T + V^T A^T,
    //    then S^T = D S^T + V^T (k Pr X); n-tile n of y^T is block n.  The
    //    state's accumulators are the A fragments of the first product with
    //    k slot tig as channel 2 tig and slot tig + 4 as 2 tig + 1.
    float yc[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
      yc[n][0] = yc[n][1] = yc[n][2] = yc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
      uint32_t ab[4], as[4];
      split4<false>(st[kk][0], st[kk][2], st[kk][1], st[kk][3], ab, as);
      const int i = 8 * kk + 2 * tig;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const float2 q = lds2(Qh + swz(L * n + g, i));
        uint32_t bb[2], bs[2];
        split2(q.x, q.y, bb, bs);
        mma3<false>(yc[n], ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const float2 d = lds2(P_s + NB * HD + 8 * n + 2 * tig);
      st[n][0] *= d.x;
      st[n][1] *= d.y;
      st[n][2] *= d.x;
      st[n][3] *= d.y;
    }
#pragma unroll
    for (int J = 0; J < NB; ++J) {
      const int s = L * J + tig;
      uint32_t ab[4], as[4];
      split4<kExactV>(to_f32(vs[s * VROW + j0]), to_f32(vs[s * VROW + j1]),
                      to_f32(vs[(s + 4) * VROW + j0]),
                      to_f32(vs[(s + 4) * VROW + j1]), ab, as);
#pragma unroll
      for (int n = 0; n < NB; ++n) {  // pairs: keys of block J
        if (n < J) continue;
        const float* arow = A_s + (L * n + g) * AROW + s;
        uint32_t bb[2], bs[2];
        split2(arow[0], arow[4], bb, bs);
        mma3<kExactV>(yc[n], ab, as, bb, bs);
      }
#pragma unroll
      for (int n = 0; n < NB; ++n) {  // the state: channels 8 n + g
        const int i = 8 * n + g;
        uint32_t bb[2], bs[2];
        split2(Kh[swz(s, i)], Kh[swz(s + 4, i)], bb, bs);
        mma3<kExactV>(st[n], ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + L * n + 2 * tig + (e & 1), j = e < 2 ? j0 : j1;
        if (t < a.S && j < hd) y[t * ys + j] = yc[n][e];
      }
    }
    __syncthreads();  // every read of this stage is done
    if (c + 2 < n_chunks) stage(a, r, k, v, w, t0 + 2 * T, buf, vec);
    asm volatile("cp.async.commit_group;\n" ::);
  }

#pragma unroll
  for (int n = 0; n < NB; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ii = 8 * n + 2 * tig + (e & 1), jj = e < 2 ? j0 : j1;
      if (ii < hd && jj < hd) a.sT[(bh * hd + ii) * hd + jj] = st[n][e];
    }
  }
}

// every row of x starts on 16 bytes: cp.async can stage it
bool rows_aligned(const void* p, long long b, long long s, long long h,
                  int hd, int elem) {
  const long long m = 16 / elem;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && b % m == 0 &&
         s % m == 0 && h % m == 0 && hd % m == 0;
}

template <typename E>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int bytes = Smem<E>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel<E>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int e = static_cast<int>(sizeof(E));
  const bool vec = rows_aligned(a.r, a.rb, a.rs, a.rh, a.hd, e) &&
                   rows_aligned(a.k, a.kb, a.ks, a.kh, a.hd, e) &&
                   rows_aligned(a.v, a.vb, a.vs, a.vh, a.hd, e) &&
                   rows_aligned(a.w, a.wb, a.ws, a.wh, a.hd, 4);
  kernel<E><<<dim3(a.H, a.B), NT, bytes, stream>>>(a, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace chunk

int check_args(int B, int S, int H, int hd, int dtype) {
  if (S < 0 || hd <= 0 || hd > HD || B > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// Both entry points: dtype of r, k and v: 0 float32, 1 bfloat16 (w, u,
// state0, y and S_T are float32).  Strides in elements: batch, sequence,
// head of r, k, v, w (last dim contiguous); u (H, hd), state0 and S_T
// (B, H, hd, hd) and y (B, S, H, hd) contiguous.  Launch on ``stream``,
// never synchronise; return cudaGetLastError().
//
// rwkv6_scan_step_launch: the exact per-token body (any S; the wrapper
// sends S < 16 here).  rwkv6_scan_chunk_launch: the chunked body (S >= 16
// from the wrapper).
#define RWKV6_ARGS                                                           \
  const void *r, const void *k, const void *v, const float *w,              \
      const float *u, const float *s0, float *y, float *sT, int B, int S,    \
      int H, int hd, long long rb, long long rs, long long rh, long long kb, \
      long long ks, long long kh, long long vb, long long vs, long long vh,  \
      long long wb, long long ws, long long wh, int dtype, void *stream

extern "C" int rwkv6_scan_step_launch(RWKV6_ARGS) {
  if (B <= 0 || H <= 0) return 0;
  if (const int bad = check_args(B, S, H, hd, dtype)) return bad;
  const Args a{r,  k,  v,  w,  u,  s0, y,  sT, B,  S,  H,  hd, rb,
               rs, rh, kb, ks, kh, vb, vs, vh, wb, ws, wh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? step::launch<float>(a, st)
                    : step::launch<__nv_bfloat16>(a, st);
}

extern "C" int rwkv6_scan_chunk_launch(RWKV6_ARGS) {
  if (B <= 0 || H <= 0) return 0;
  if (const int bad = check_args(B, S, H, hd, dtype)) return bad;
  const Args a{r,  k,  v,  w,  u,  s0, y,  sT, B,  S,  H,  hd, rb,
               rs, rh, kb, ks, kh, vb, vs, vh, wb, ws, wh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? chunk::launch<float>(a, st)
                    : chunk::launch<__nv_bfloat16>(a, st);
}
