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
// recurrence forward and saves the state before every chunk of kT steps
// but the last; the backward sweep takes the chunks last to first,
// recomputes each chunk's states forward from its saved one and walks
// them back.  The state step is written as the plain version writes it,
// __fadd_rn(__fmul_rn(w, S), __fmul_rn(k, v)), and so is dS's, so the
// recomputed states equal linear_scan/ops.py rwkv6_scan_bwd_plain's bit for
// bit; the gradients' sums run in another order than the plain version's
// (below), so they agree to f32 rounding.
//
// Layout: r, k, v (bf16 or f32) are read through their (batch, seq, head)
// strides, last dim contiguous; w, dy (B, S, H, hd) and u, state0, dS_T
// contiguous f32; dr, dk, dv, dw (B, S, H, hd), du (B, H, hd, summed over
// the batch by the wrapper) and dstate0 (B, H, hd, hd) f32.  Built for
// hd <= kHd = 64; a narrower head is padded with zeros, which stay zero.
//
// What bounds it on an H100.  Bytes: at (B 4, S 4,096, H 40, hd 64) with
// bf16 r, k, v it reads r, k, v, w, dy and writes dr, dk, dv, dw: 1.26 GB,
// 0.38 ms at 3.35 TB/s; its ~18 FLOP a state element a step (2.68e9
// element-steps) take 0.29 ms as 3xTF32 on the tensor cores.  This design
// runs them on the CUDA cores instead: 9 rounded operations an
// element-step (the state recomputed twice, dS stepped) and 4
// multiply-adds, ~20 instructions an element-step with the loads and the
// shuffles, so its floor there is ~2 ms at that shape on 132 SMs, at every
// issue slot filled.  What it loses beyond that (PERF.md) is latency:
// three CTAs an SM (168 registers a thread), so three warps a scheduler,
// and a CTA barrier and a cluster barrier a chunk.  The saved states cost
// bytes too: one 16 KB state a (batch, head) every kT steps, written once
// and read once.
//
// The design.  Row i of S and of dS evolves alone
// (S[i,:] = w_t[i] S[i,:] + k_t[i] v_t, dS[i,:] = w_t[i] dS[i,:] + r_t[i]
// dy_t), and the row sums (dr_t[i], dk_t[i], dw_t[i]) need only that row;
// dv_t is the one sum over rows.  So:
// - The 64 rows are split into kG groups of kRows, one CTA a group, and
//   the kG CTAs of a (batch, head) form one thread-block cluster (grid
//   kG B H: 320 CTAs at (2, 2,048, 40, 64), against 80 before).  A row
//   lies on 8 lanes of one warp, 8 columns a lane: its quad ca = 4 l + 32
//   b (b bit 4 of the lane) and ca ^ 32, so its float4 reads of a staged
//   row are conflict-free.  No CTA barrier runs inside the step loop.
// - A chunk's states never go through device memory.  The chunk's first
//   state and the one after each kSub = 8 steps are kept in shared memory
//   (each thread its own, in thread order); then, sub-chunk by sub-chunk
//   from the last, a lane recomputes its 8 states in registers and walks
//   them back.  Only the saved chunk-boundary states go to device memory,
//   one a chunk but the last (the first sweep leaves that one in
//   registers).
// - The sweep keeps each lane's partial sums pk = G v, pr = S dy and pw =
//   dS S (G = dS + (r u) (x) dy, as the plain version forms it) for the
//   sub-chunk's 8 steps, then one recursive halving of the 24 values over
//   the row's 8 lanes (12 + 6 + 3 shuffles) leaves lane l with the sums of
//   step l: dk = pk, dr = pr + (u k)(v . dy), dw = pw.  The shuffles sit
//   off the dS chain.  v . dy, the same for every row, is summed once a
//   token by each warp for itself (no CTA barrier).
// - dv_t = sum_i k_i G_t[i,:].  Each step, a warp halves its 4 rows of k_i
//   G[i,:] over lanes ^16 (each lane's own quad first, so without selects)
//   and ^8 into its row of a shared-memory tile [kT][warps][64].  At the
//   chunk's end one cluster barrier, split: its arrive (release) follows
//   the last tile write, its wait comes after the next chunk's
//   recomputation; then each CTA sums its kT / kG tokens over the kG
//   CTAs' tiles through distributed shared memory (map_shared_rank), in a
//   fixed order (the same bits every run), and stores dv as rows.  Two
//   tiles, chunk c in tile c & 1, so no CTA overwrites a tile another may
//   still read.
// - Each backward chunk's r, k, w (the group's rows), v and dy (every
//   column) and its saved state come by 16-byte cp.async into a
//   two-stage ring: the next chunk loads while this one computes.  A bf16
//   v is widened to f32 once, by the threads that copied it, before the
//   chunk's barrier.  The forward sweep, light work a chunk, keeps
//   kFwdStages - 1 chunks of k, w, v in flight in a ring of its own over
//   the backward's tiles.  Rows past hd stay zero (the rings are zeroed
//   once; a partial 16-byte copy zero-fills its tail); rows not 16-byte
//   aligned are staged by plain loads instead.
// Narrow heads: a group past hd has no live row; it runs the same loop on
// zeros and arrives at every cluster barrier (no CTA returns early).
// Shared memory a CTA with bf16 r, k, v: 74,048 bytes (three CTAs an SM).
// tools/scan_bwd_ablation.py times other kG and kT.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kHd = 64;  // the widest head, ops.MAX_HEAD
constexpr int kG = 4;    // CTAs a cluster: the row groups of a (batch, head)
constexpr int kT = 16;   // steps a chunk, ops.BWD_CHUNK
constexpr int kRows = kHd / kG;            // state rows a CTA
constexpr int kLanesRow = 8;               // lanes a row
constexpr int kCols = kHd / kLanesRow;     // columns a lane
constexpr int kRowsWarp = 32 / kLanesRow;  // rows a warp
constexpr int kWarps = kRows / kRowsWarp;
constexpr int kThreads = 32 * kWarps;
constexpr int kQuads = kCols / 4;   // float4s of a lane's slice of a row
constexpr int kShare = kT / kG;     // tokens of dv each CTA reduces
constexpr int kStateF4 = kQuads * kThreads;  // float4s of a group's state
// steps whose states a lane holds in registers at once, and whose row
// sums halve together
constexpr int kSub = 8;
constexpr int kSubs = kT / kSub;    // sub-chunks a chunk

static_assert(kCols == 8 && kRowsWarp == 4, "8 lanes a row, 4 rows a warp");
static_assert(kRows % kRowsWarp == 0 && kWarps >= 1, "whole warps a group");
static_assert(kT % kG == 0 && kT % kSub == 0, "dv's tokens split evenly");
static_assert(kG >= 1 && kG <= 8, "a portable cluster");
static_assert(kT == 16 || kT == 32, "a row's lanes halve kT / 4 token sums");

constexpr int kRK = kT * kRows;  // elements of r, k or w a chunk
constexpr int kVD = kT * kHd;    // elements of v or dy a chunk
constexpr int kSubsFloats = kSubs * 4 * kStateF4;  // sub-chunks' first states
constexpr int kTileFloats = kT * kWarps * kHd;     // dv's sums a warp

// One ring stage, in bytes, for r, k, v of type E: the saved state
// [kStateF4] float4, dy and v [kT][kHd] f32, w [kT][kRows] f32, r and k
// [kT][kRows] E, and for bf16 v as staged [kT][kHd] E, which the threads
// that copied it widen into v.
template <typename E>
struct Slot {
  static constexpr int kE = static_cast<int>(sizeof(E));
  static constexpr int kSv = 0, kDy = 16 * kStateF4, kV = kDy + 4 * kVD;
  static constexpr int kW = kV + 4 * kVD, kR = kW + 4 * kRK;
  static constexpr int kK = kR + kE * kRK, kRaw = kK + kE * kRK;
  static constexpr int kBytes = kRaw + (kE == 4 ? 0 : kE * kVD);
  static constexpr size_t kSmem =
      2 * kBytes + sizeof(float) * (kSubsFloats + 2 * kTileFloats +
                                    kWarps * kT + kRows);
  static_assert(kRK * kE % 16 == 0 && kBytes % 16 == 0,
                "16-byte aligned regions");
  static_assert(kSmem <= 232448, "more than a CTA's shared memory");
};

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
  float4* saved;  // (B H, n_chunks - 1, kG, kQuads, kThreads)
  int S, H, hd, n_chunks;
  long long rb, rs, rh, kb, ks, kh, vb, vs, vh;
  int vec;  // every row of r, k, v, w, dy starts on 16 bytes
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, of which the first ``bytes`` are read and the
// rest zero-filled
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// x[e] = row[ca + e] and x[4 + e] = row[(ca ^ 32) + e], e < 4: a lane's
// columns of a staged row, its own quad ca first (16-byte aligned)
__device__ __forceinline__ void lane_cols(float (&x)[kCols], const float* row,
                                          int ca) {
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    const float4 f = *reinterpret_cast<const float4*>(row + (ca ^ (32 * q)));
    x[4 * q] = f.x, x[4 * q + 1] = f.y, x[4 * q + 2] = f.z,
          x[4 * q + 3] = f.w;
  }
}

__device__ __forceinline__ void lane_cols(float (&x)[kCols],
                                          const __nv_bfloat16* row, int ca) {
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    const uint2 h = *reinterpret_cast<const uint2*>(row + (ca ^ (32 * q)));
    // bf16 -> f32 is exact: the high half of the word
    x[4 * q] = __uint_as_float(h.x << 16);
    x[4 * q + 1] = __uint_as_float(h.x & 0xffff0000u);
    x[4 * q + 2] = __uint_as_float(h.y << 16);
    x[4 * q + 3] = __uint_as_float(h.y & 0xffff0000u);
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
    x[4 * q] = f.x, x[4 * q + 1] = f.y, x[4 * q + 2] = f.z,
          x[4 * q + 3] = f.w;
  }
}

// recursive halving step over lanes ^m: of the pairs (x[i], x[i + n]) a
// lane keeps the one its bit selects and adds its partner's
template <int n>
__device__ __forceinline__ void halve(float* x, bool hi, int m) {
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const float keep = hi ? x[i + n] : x[i], send = hi ? x[i] : x[i + n];
    x[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
  }
}

// nt rows of ``live`` (<= kFull) elements from src (rows ``st`` elements
// apart) into dst (rows kFull apart): 16-byte cp.async pieces, the last of
// a row partial, when vec (a whole row: a fixed count of pieces); else
// plain loads
template <int kFull, typename E>
__device__ __forceinline__ void stage_rows(E* dst, const E* src,
                                           long long st, int nt, int live,
                                           bool vec) {
  constexpr int pitch = kFull;
  if (live <= 0) return;
  if (vec && live == kFull) {
    constexpr int kPieces = kFull * static_cast<int>(sizeof(E)) / 16;
    static_assert(kPieces * 16 == kFull * sizeof(E), "whole pieces a row");
    for (int i = threadIdx.x; i < nt * kPieces; i += kThreads) {
      const int u = i / kPieces, p = i % kPieces;
      copy16(reinterpret_cast<char*>(dst + u * pitch) + 16 * p,
             reinterpret_cast<const char*>(src + u * st) + 16 * p, 16);
    }
  } else if (vec) {
    const int bytes = live * static_cast<int>(sizeof(E));
    const int pieces = (bytes + 15) >> 4;
    for (int i = threadIdx.x; i < nt * pieces; i += kThreads) {
      const int u = i / pieces, p = i - u * pieces;
      copy16(reinterpret_cast<char*>(dst + u * pitch) + 16 * p,
             reinterpret_cast<const char*>(src + u * st) + 16 * p,
             min(16, bytes - 16 * p));
    }
  } else {
    for (int i = threadIdx.x; i < nt * live; i += kThreads) {
      const int u = i / live, e = i - u * live;
      dst[u * pitch + e] = src[u * st + e];
    }
  }
}

// One stage of the forward sweep's ring, in bytes: k [kT][kRows] E, w
// [kT][kRows] f32, v [kT][kHd] E.  kFwdStages of them lie over the
// sub-chunks' states and dv's tiles, which only the backward chunks use.
constexpr int kFwdStages = 4;  // chunks of the forward sweep in flight
template <typename E>
struct FwdSlot {
  static constexpr int kE = static_cast<int>(sizeof(E));
  static constexpr int kK = 0, kW = kE * kRK, kV = kW + 4 * kRK;
  static constexpr int kBytes = kV + kE * kVD;
  static_assert(kFwdStages * kBytes <= 4 * (kSubsFloats + 2 * kTileFloats),
                "the forward ring fits over the backward's buffers");
  static_assert(kBytes % 16 == 0, "16-byte aligned stages");
};

// a ring stage's regions
template <typename E>
struct Stage {
  float4* sv;
  float* dy;
  float* v;
  float* w;
  E* r;
  E* k;
  E* raw;  // v as staged (bf16)
  __device__ explicit Stage(unsigned char* base)
      : sv(reinterpret_cast<float4*>(base + Slot<E>::kSv)),
        dy(reinterpret_cast<float*>(base + Slot<E>::kDy)),
        v(reinterpret_cast<float*>(base + Slot<E>::kV)),
        w(reinterpret_cast<float*>(base + Slot<E>::kW)),
        r(reinterpret_cast<E*>(base + Slot<E>::kR)),
        k(reinterpret_cast<E*>(base + Slot<E>::kK)),
        raw(reinterpret_cast<E*>(base + Slot<E>::kRaw)) {}
};

// This CTA's view of the inputs: its rows of r, k, w, every column of v
// and dy, at t = 0
template <typename E>
struct Inputs {
  const E* r;
  const E* k;
  const E* v;
  const float* w;
  const float* dy;
  long long rs, ks, vs, hs;  // row strides in elements; hs of w and dy
  int live, hd, S;           // the group's live rows, hd, S
  bool vec;
};

// v of a chunk: f32 straight into the stage; bf16 by cp.async into its
// staging area (widened by widen_v after the copies land) when vec, else
// loaded and widened here
__device__ __forceinline__ void stage_v(const Stage<float>& s,
                                        const float* src, long long st,
                                        int nt, int hd, bool vec) {
  stage_rows<kHd>(s.v, src, st, nt, hd, vec);
}

__device__ __forceinline__ void stage_v(const Stage<__nv_bfloat16>& s,
                                        const __nv_bfloat16* src,
                                        long long st, int nt, int hd,
                                        bool vec) {
  if (vec) {
    stage_rows<kHd>(s.raw, src, st, nt, hd, true);
  } else {
    for (int i = threadIdx.x; i < nt * hd; i += kThreads) {
      const int u = i / hd, e = i - u * hd;
      s.v[u * kHd + e] = to_f(src[u * st + e]);
    }
  }
}

// After cp.async.wait_group: each thread widens the bf16 pieces of v it
// copied itself (stage_rows' assignment of pieces to threads), zeros past
// hd included, so one barrier then shows all of v to every thread.
__device__ __forceinline__ void widen_v(const Stage<float>&, int, int) {}

__device__ __forceinline__ void widen_v(const Stage<__nv_bfloat16>& s,
                                        int nt, int hd) {
  const int pieces = (hd * 2 + 15) >> 4;  // 8 elements a piece
  for (int i = threadIdx.x; i < nt * pieces; i += kThreads) {
    const int u = i / pieces, p = i - u * pieces;
    const uint4 q = *reinterpret_cast<const uint4*>(s.raw + u * kHd + 8 * p);
    const uint32_t h[4] = {q.x, q.y, q.z, q.w};
    float4* dst = reinterpret_cast<float4*>(s.v + u * kHd + 8 * p);
    // bf16 -> f32 is exact: the high half of the word
    dst[0] = make_float4(__uint_as_float(h[0] << 16),
                         __uint_as_float(h[0] & 0xffff0000u),
                         __uint_as_float(h[1] << 16),
                         __uint_as_float(h[1] & 0xffff0000u));
    dst[1] = make_float4(__uint_as_float(h[2] << 16),
                         __uint_as_float(h[2] & 0xffff0000u),
                         __uint_as_float(h[3] << 16),
                         __uint_as_float(h[3] & 0xffff0000u));
  }
}

// Stage backward chunk c: r, k, w, v, dy and the saved state ``sv``
// (unless null).  One cp.async group.
template <typename E>
__device__ __forceinline__ void load(const Inputs<E>& in, const Stage<E>& s,
                                     int c, const float4* sv) {
  const int t0 = c * kT, nt = min(kT, in.S - t0);
  stage_rows<kRows>(s.r, in.r + t0 * in.rs, in.rs, nt, in.live, in.vec);
  stage_rows<kRows>(s.k, in.k + t0 * in.ks, in.ks, nt, in.live, in.vec);
  stage_rows<kRows>(s.w, in.w + t0 * in.hs, in.hs, nt, in.live, in.vec);
  stage_v(s, in.v + t0 * in.vs, in.vs, nt, in.hd, in.vec);
  stage_rows<kHd>(s.dy, in.dy + t0 * in.hs, in.hs, nt, in.hd, in.vec);
  if (sv) {
#pragma unroll
    for (int q = 0; q < kQuads; ++q)
      copy16(s.sv + q * kThreads + threadIdx.x,
             sv + q * kThreads + threadIdx.x, 16);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Stage forward chunk c (always kT steps): k, w, v.  One cp.async group.
template <typename E>
__device__ __forceinline__ void load_fwd(const Inputs<E>& in,
                                         unsigned char* base, int c) {
  const int t0 = c * kT;
  stage_rows<kRows>(reinterpret_cast<E*>(base + FwdSlot<E>::kK),
                    in.k + t0 * in.ks, in.ks, kT, in.live, in.vec);
  stage_rows<kRows>(reinterpret_cast<float*>(base + FwdSlot<E>::kW),
                    in.w + t0 * in.hs, in.hs, kT, in.live, in.vec);
  stage_rows<kHd>(reinterpret_cast<E*>(base + FwdSlot<E>::kV),
                  in.v + t0 * in.vs, in.vs, kT, in.hd, in.vec);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most ``ahead`` (< kFwdStages) of this thread's cp.async
// groups are pending
__device__ __forceinline__ void wait_pending(int ahead) {
  if (ahead >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (ahead == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// S = w o S + k (x) v on this lane's row li and columns, step u of a
// forward stage
template <typename E>
__device__ __forceinline__ void fwd_step(float (&s)[kCols],
                                         const unsigned char* base, int u,
                                         int li, int ca) {
  const E* k = reinterpret_cast<const E*>(base + FwdSlot<E>::kK);
  const float* w = reinterpret_cast<const float*>(base + FwdSlot<E>::kW);
  const E* v = reinterpret_cast<const E*>(base + FwdSlot<E>::kV);
  const float kk = to_f(k[u * kRows + li]), ww = w[u * kRows + li];
  float vv[kCols];
  lane_cols(vv, v + u * kHd, ca);
#pragma unroll
  for (int e = 0; e < kCols; ++e)
    s[e] = __fadd_rn(__fmul_rn(ww, s[e]), __fmul_rn(kk, vv[e]));
}

// S = w o S + k (x) v on this lane's row li and columns, step u
template <typename E>
__device__ __forceinline__ void step(float (&s)[kCols], const Stage<E>& st,
                                     int u, int li, int ca) {
  const float kk = to_f(st.k[u * kRows + li]), ww = st.w[u * kRows + li];
  float vv[kCols];
  lane_cols(vv, st.v + u * kHd, ca);
#pragma unroll
  for (int e = 0; e < kCols; ++e)
    s[e] = __fadd_rn(__fmul_rn(ww, s[e]), __fmul_rn(kk, vv[e]));
}

template <typename T>
__global__ void __cluster_dims__(kG, 1, 1) __launch_bounds__(kThreads)
    rwkv6_scan_bwd_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char sm[];
  unsigned char* slots = sm;
  float4* subs = reinterpret_cast<float4*>(sm + 2 * Slot<T>::kBytes);
  // dv's sums a warp, [2][kT][kWarps][kHd]: chunk c in tile c & 1
  float* tile = reinterpret_cast<float*>(subs) + kSubsFloats;
  float* vdy_w = tile + 2 * kTileFloats;  // [kWarps][kT]: v . dy a token
  float* u_s = vdy_w + kWarps * kT;

  cg::cluster_group cluster = cg::this_cluster();
  const int g = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / kG, b = bh / p.H, h = bh - b * p.H;
  const int hd = p.hd, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int li = warp * kRowsWarp + (lane >> 3);  // the lane's row, in-group
  const int row = g * kRows + li;
  // the lane's columns: its quad ca .. ca + 3 in registers 0-3, then
  // (ca ^ 32) .., so lanes ^16 hold each other's quads in opposite halves
  const int cl = lane & 7, ca = 4 * cl + 32 * ((lane >> 4) & 1);
  const bool live_row = row < hd;
  const int n = p.n_chunks;

  // the rings' padding (rows past hd, columns past hd) stays zero
  for (int i = tid; i < 2 * Slot<T>::kBytes / 16 + kFwdStages *
                            FwdSlot<T>::kBytes / 16; i += kThreads)
    reinterpret_cast<float4*>(slots)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < kRows; i += kThreads)
    u_s[i] = g * kRows + i < hd ? p.u[h * hd + g * kRows + i] : 0.f;
  __syncthreads();

  const long long bhs = static_cast<long long>(b) * p.S * p.H + h;
  const long long hs = static_cast<long long>(p.H) * hd;  // w, dy, outputs
  Inputs<T> in;
  in.r = static_cast<const T*>(p.r) + b * p.rb + h * p.rh + g * kRows;
  in.k = static_cast<const T*>(p.k) + b * p.kb + h * p.kh + g * kRows;
  in.v = static_cast<const T*>(p.v) + b * p.vb + h * p.vh;
  in.w = p.w + bhs * hd + g * kRows;
  in.dy = p.dy + bhs * hd;
  in.rs = p.rs, in.ks = p.ks, in.vs = p.vs, in.hs = hs;
  in.live = max(0, min(kRows, hd - g * kRows));
  in.hd = hd, in.S = p.S, in.vec = p.vec != 0;
  // the saved state before chunk c (c < n - 1), this CTA's share
  float4* saved = p.saved +
                  static_cast<long long>(bh) * max(n - 1, 0) * kG * kStateF4 +
                  static_cast<long long>(g) * kStateF4;
  auto saved_at = [&](int c) {
    return saved + static_cast<long long>(c) * kG * kStateF4;
  };

  const long long hd2 = static_cast<long long>(hd) * hd;
  float s[kCols], dS[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) {
    const int col = (ca ^ (32 * (e >> 2))) + (e & 3);
    const bool ok = live_row && col < hd;
    s[e] = ok ? p.s0[bh * hd2 + row * hd + col] : 0.f;
    dS[e] = ok ? p.dsT[bh * hd2 + row * hd + col] : 0.f;
  }
  const float uu = u_s[li];
  float du = 0.f;
  const bool b0 = lane & 1, b1 = lane & 2, b2 = lane & 4;
  const bool b3 = lane & 8;

  unsigned char* fring = reinterpret_cast<unsigned char*>(subs);
  auto fslot = [&](int f) {
    return fring + (f % kFwdStages) * FwdSlot<T>::kBytes;
  };
  auto load_bwd = [&](int c) {
    load(in, Stage<T>(slots + (c & 1) * Slot<T>::kBytes), c,
         c < n - 1 ? saved_at(c) : nullptr);
  };
  // dv of chunk c's kShare tokens that fall to this CTA: the sum of the
  // cluster's tiles (CTA, then warp: a fixed order)
  auto reduce = [&](int c) {
    const int t0 = c * kT, nt = min(kT, p.S - t0);
    const float* own = tile + (c & 1) * kTileFloats;
    // lanes 0-15 of every warp, so no warp falls behind the others
    for (int i2 = (lane & 15) + 16 * warp; i2 < kShare * (kHd / 4);
         i2 += 16 * kWarps) {
      const int u = g * kShare + i2 / (kHd / 4), j = 4 * (i2 % (kHd / 4));
      if (lane >= 16 || u >= nt || j >= hd) continue;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int gg = 0; gg < kG; ++gg) {
        const float* t = cluster.map_shared_rank(own, gg);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float4 q = *reinterpret_cast<const float4*>(
              t + (u * kWarps + w) * kHd + j);
          a.x += q.x, a.y += q.y, a.z += q.z, a.w += q.w;
        }
      }
      const float out[4] = {a.x, a.y, a.z, a.w};
      float* dvp = p.dv + (bhs + (t0 + u) * static_cast<long long>(p.H)) *
                              hd + j;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j + e < hd) dvp[e] = out[e];
    }
  };

  // The forward sweep over chunks 0 .. n - 2, kFwdStages - 1 chunks
  // loading ahead (the last chunk's backward stage first, long before it
  // is needed), saving the state before each.
  const int nf = max(n - 1, 0);
  if (n > 0) load_bwd(n - 1);
  for (int f = 0; f < min(nf, kFwdStages - 1); ++f)
    load_fwd(in, fslot(f), f);
  for (int f = 0; f < nf; ++f) {
    wait_pending(min(nf - 1, f + kFwdStages - 2) - f);
    __syncthreads();  // chunk f staged; chunk f - 1's stage free to refill
    if (f + kFwdStages - 1 < nf)
      load_fwd(in, fslot(f + kFwdStages - 1), f + kFwdStages - 1);
    put(saved_at(f) + tid, s);
#pragma unroll 4
    for (int u = 0; u < kT; ++u) fwd_step<T>(s, fslot(f), u, li, ca);
  }
  if (nf) __threadfence();  // the saved states, before their cp.async reads

  // the backward chunks, last to first, chunk c - 1 loading while c runs
  for (int c = n - 1; c >= 0; --c) {
    const Stage<T> st(slots + (c & 1) * Slot<T>::kBytes);
    const int t0 = c * kT, nt = min(kT, p.S - t0);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    if (in.vec) widen_v(st, nt, hd);
    __syncthreads();  // chunk c staged; the forward ring or chunk c + 1's
                      // stage free to reuse
    if (c > 0) load_bwd(c - 1);
    // backward chunk c: the state before each sub-chunk of kSub steps, in
    // thread order in shared memory (each thread reads back its own)
    float x[kCols];
    if (c == n - 1) {
#pragma unroll
      for (int e = 0; e < kCols; ++e) x[e] = s[e];
    } else {
      get(x, st.sv + tid);
    }
    const int nsub = (nt + kSub - 1) / kSub;
    for (int m = 0; m < nsub; ++m) {
      put(subs + m * kStateF4 + tid, x);
      if (m + 1 < nsub) {
#pragma unroll
        for (int j = 0; j < kSub; ++j) step(x, st, m * kSub + j, li, ca);
      }
    }
    // v . dy of the chunk's tokens, the same for every row: each warp sums
    // its own copy (no CTA barrier), a row's 8 lanes on tokens rr + 4 q
    {
      constexpr int kQ = kT / 4;
      float part[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int u = (lane >> 3) + 4 * q;
        float vv[kCols], dd[kCols];
        lane_cols(vv, st.v + u * kHd, ca);
        lane_cols(dd, st.dy + u * kHd, ca);
        part[q] = 0.f;
#pragma unroll
        for (int e = 0; e < kCols; ++e) part[q] += vv[e] * dd[e];
      }
      if constexpr (kQ == 8) {
        halve<4>(part, b2, 4);
        halve<2>(part, b1, 2);
        halve<1>(part, b0, 1);
        vdy_w[warp * kT + (lane >> 3) + 4 * cl] = part[0];
      } else {
        halve<2>(part, b2, 4);
        halve<1>(part, b1, 2);
        part[0] += __shfl_xor_sync(0xffffffffu, part[0], 1);
        if (!b0) vdy_w[warp * kT + (lane >> 3) + 4 * (cl >> 1)] = part[0];
      }
      __syncwarp();
    }
    if (c != n - 1) {  // chunk c + 1's tiles are complete: its dv
      cluster_wait();
      reduce(c + 1);
    }
    float* tl = tile + (c & 1) * kTileFloats;
    for (int m = nsub - 1; m >= 0; --m) {
      const int u0 = m * kSub, ns = min(kSub, nt - u0);
      // the sub-chunk's states S_{t-1}, in registers
      float sp[kSub][kCols];
      get(sp[0], subs + m * kStateF4 + tid);
#pragma unroll
      for (int j = 1; j < kSub; ++j) {
#pragma unroll
        for (int e = 0; e < kCols; ++e) sp[j][e] = sp[j - 1][e];
        if (j < ns) step(sp[j], st, u0 + j - 1, li, ca);
      }
      // its steps last to first; part[.][jj] holds step u0 + kSub - 1 - jj's
      // partial sums pk = G v, pr = S dy, pw = dS S, with G = dS + (r u)
      // (x) dy
      float part[3][kSub];
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const int j = kSub - 1 - jj, u = u0 + j;
        part[0][jj] = part[1][jj] = part[2][jj] = 0.f;
        if (j >= ns) continue;
        float vv[kCols], dd[kCols], col[kCols];
        lane_cols(vv, st.v + u * kHd, ca);
        lane_cols(dd, st.dy + u * kHd, ca);
        const float rr = to_f(st.r[u * kRows + li]);
        const float kk = to_f(st.k[u * kRows + li]);
        const float ww = st.w[u * kRows + li];
        const float ru = rr * uu;
#pragma unroll
        for (int e = 0; e < kCols; ++e) {
          const float gg = dS[e] + ru * dd[e];
          part[0][jj] += gg * vv[e];
          part[1][jj] += sp[j][e] * dd[e];
          part[2][jj] += dS[e] * sp[j][e];
          col[e] = kk * gg;
          dS[e] = __fadd_rn(__fmul_rn(ww, dS[e]), __fmul_rn(rr, dd[e]));
        }
        // dv: the warp's 4 rows of k_i G[i, :] halved over lanes ^16 (each
        // keeps its quad ca, which its partner holds in registers 4-7),
        // then ^8 (2 of those 4)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          col[e] += __shfl_xor_sync(0xffffffffu, col[e + 4], 16);
        halve<2>(col, b3, 8);
        *reinterpret_cast<float2*>(tl + (u * kWarps + warp) * kHd + ca +
                                   2 * b3) = make_float2(col[0], col[1]);
      }
      // the chunk's tile is complete with its last sub-chunk's steps: the
      // release there orders them, and not the global stores below
      if (m == 0) cluster_arrive();
      // lanes ^4 split the steps by bit 2 of jj, ^2 by bit 1, ^1 by bit 0:
      // lane cl is left with the three sums of step u0 + kSub - 1 - cl
#pragma unroll
      for (int k3 = 0; k3 < 3; ++k3) {
        halve<4>(part[k3], b2, 4);
        halve<2>(part[k3], b1, 2);
        halve<1>(part[k3], b0, 1);
      }
      const int u = u0 + kSub - 1 - cl;
      const bool on = kSub - 1 - cl < ns;
      const float rr = on ? to_f(st.r[u * kRows + li]) : 0.f;
      const float kk = on ? to_f(st.k[u * kRows + li]) : 0.f;
      const float vdy = on ? vdy_w[warp * kT + u] : 0.f;
      if (on && live_row) {
        const long long o = (bhs + (t0 + u) * static_cast<long long>(p.H)) *
                                hd + row;
        p.dk[o] = part[0][0];
        p.dr[o] = part[1][0] + uu * kk * vdy;
        p.dw[o] = part[2][0];
      }
      du += rr * kk * vdy;
    }
  }
  if (n > 0) {
    cluster_wait();
    reduce(0);
    cluster_arrive();  // no CTA leaves while its tile is read
    cluster_wait();
  }
  // du: the row's 8 lanes each summed the steps they completed
  du += __shfl_xor_sync(0xffffffffu, du, 4);
  du += __shfl_xor_sync(0xffffffffu, du, 2);
  du += __shfl_xor_sync(0xffffffffu, du, 1);
  if (live_row) {
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const int col = (ca ^ (32 * (e >> 2))) + (e & 3);
      if (col < hd) p.ds0[bh * hd2 + row * hd + col] = dS[e];
    }
    if (cl == 0) p.du[bh * hd + row] = du;
  }
}

// every row of x starts on 16 bytes: cp.async can stage it
bool rows_aligned(const void* x, long long b, long long s, long long h,
                  int elem) {
  const long long m = 16 / elem;
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && b % m == 0 &&
         s % m == 0 && h % m == 0;
}

template <typename T>
int launch(const Args& p, int BH, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Slot<T>::kSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        rwkv6_scan_bwd_kernel<T>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv6_scan_bwd_kernel<T><<<BH * kG, kThreads, Slot<T>::kSmem, stream>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v: (B, S, H, hd) of dtype 0 = float32, 1 = bfloat16, read through
// the (batch, seq, head) strides given in elements (last dim contiguous);
// w, dy, dr, dk, dv, dw: (B, S, H, hd) float32 contiguous; u (H, hd);
// state0, dS_T, dstate0 (B, H, hd, hd); du (B, H, hd); saved: float32
// scratch of saved_floats elements, at least one 64 x 64 state a (batch,
// head) before every kT-step chunk but the last (B H (ceil(S / kT) - 1)
// 4,096; linear_scan/ops.py rwkv6_scan_bwd_scratch_bytes), else the call
// is refused.
// Launches one cluster kernel on ``stream``, never synchronises; returns
// cudaGetLastError() (or the refused attribute's error; a cluster launch
// the card refuses is such an error).
extern "C" int rwkv6_scan_bwd_launch(
    const void* r, const void* k, const void* v, const float* w,
    const float* u, const float* s0, const float* dy, const float* dsT,
    float* dr, float* dk, float* dv, float* dw, float* du, float* ds0,
    float* saved, long long saved_floats, int B, int S, int H, int hd,
    long long rb, long long rs, long long rh, long long kb, long long ks,
    long long kh, long long vb, long long vs, long long vh, int dtype,
    void* stream) {
  if (B <= 0 || H <= 0) return 0;
  const long long BH = static_cast<long long>(B) * H;
  const int n = (S + kT - 1) / kT;
  if (S < 0 || hd <= 0 || hd > kHd || BH * kG > 2147483647LL ||
      saved_floats < BH * (n > 0 ? n - 1 : 0) * kHd * kHd ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int e = dtype == 0 ? 4 : 2;
  const bool vec = rows_aligned(r, rb, rs, rh, e) &&
                   rows_aligned(k, kb, ks, kh, e) &&
                   rows_aligned(v, vb, vs, vh, e) &&
                   rows_aligned(w, 0, 0, 0, 4) &&
                   rows_aligned(dy, 0, 0, 0, 4) && hd % 4 == 0;
  const Args p{r,  k,  v,  w,  u,  s0, dy, dsT, dr, dk, dv, dw, du, ds0,
               reinterpret_cast<float4*>(saved), S, H, hd, n, rb, rs, rh, kb,
               ks, kh, vb, vs, vh, vec ? 1 : 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, static_cast<int>(BH), st);
  return launch<__nv_bfloat16>(p, static_cast<int>(BH), st);
}

// bytes of dynamic shared memory a CTA with bf16 r, k, v (f32 takes
// less): the ring, the sub-chunks' first states, dv's tile
extern "C" int rwkv6_scan_bwd_smem_bytes() {
  return static_cast<int>(Slot<__nv_bfloat16>::kSmem);
}
