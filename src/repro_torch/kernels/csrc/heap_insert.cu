// Phase 4 of the batched heap pass: the collective insert (paper §4 Insert
// phase), the whole level-chunk loop in one launch, in place.
//
// Replaces the TPU kernel src/repro/kernels/heap_insert/kernel.py,
// insert_sharded_vmem (body _insert_kernel), and the chunk loop around it
// (batched_pq._phase4, sharded_pq.py's K-vector twin).  Per shard, the
// m_left sorted values of rem are placed at slots size+1 .. size+m_left,
// chunked at tree-level boundaries exactly as batched_pq._chunk_len does;
// each chunk descends from the root one level at a time.  At level d the
// InsertSet of node v keeps min(S[0], a[v]) at v and the displaced a[v]
// re-enters S after its equals (_replace_head_sorted); a leaf target takes
// S[0]; S is then split by the number of targets under the left child.
// The result equals batched_pq._insert_chunk element for element.
//
// The level in lanes, not rows.  A chunk's m <= C targets lo_c .. hi_c lie
// on one level d_c, so at every level d the InsertSets of the live nodes
// hold exactly m values together: node v's set is as large as the number
// of targets under it, the swap keeps that size, and the split divides it
// between the children.  Element t of the chunk therefore belongs, at
// level d, to node (lo_c + t) >> (d_c - d), and the sets are consecutive
// sorted segments of one array of m values, in node order.  One warp holds
// that array (one value a lane for C <= 32, two for C <= 64): the swap
// compares a segment's head (a shuffle) with its node's value, the
// re-insertion point of a[v] is a masked ballot counted by __popc, and the
// new segment a shift by one lane (a shuffle).  The split moves nothing:
// it only cuts a segment in two.  No (C, C) buffer, no per-row loops, no
// block barrier.
//
// What bounds it on an H100: latency.  It moves a few hundred bytes per
// chunk, but the old design's levels were a chain of dependent global
// loads and barriers (~log2(cap) round trips to memory a chunk).  Every
// node a chunk reads is known before its descent: level d's ancestors are
// lo_c >> (d_c - d) .. hi_c >> (d_c - d), at most m - 1 + 2*d_c < 128 of
// them.  So a launch now takes two dependent round trips for its first
// chunk (the shard's size and values, then all the chunk's ancestors as
// one batch of independent loads into shared memory) and one for each
// further chunk (a batch crossing a level boundary takes two chunks, a
// near-empty heap several); the descent runs on chip.  Each chunk writes
// its changed nodes as it goes (no later level of the chunk reads them)
// and the next chunk loads its ancestors after a __syncwarp(), which
// orders those stores before the loads.
// The design: one warp per shard (grid = K), the m_left <= 0 shards exit
// at once, one launch per pass.  Keys are finite or +inf (the pass refuses
// NaN at entry); for them the result is bit-equal to the plain version.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kPrefetch = 128;            // > m - 1 + 2 * d_c for m <= 64
constexpr int kPerLane = kPrefetch / kWarp;

__device__ __forceinline__ int depth_of(int v) {
  return 31 - __clz(max(v, 1));
}

// element `src` (0 .. VPL*32-1) of the array held as x[i] at lane e % 32
template <int VPL>
__device__ __forceinline__ float lane_get(const float (&x)[VPL], int src) {
  float out = __shfl_sync(kAll, x[0], src & (kWarp - 1));
#pragma unroll
  for (int i = 1; i < VPL; ++i) {
    const float y = __shfl_sync(kAll, x[i], src & (kWarp - 1));
    if ((src >> 5) == i) out = y;
  }
  return out;
}

template <int VPL>
__device__ __forceinline__ void insert_shard(float* __restrict__ a,
                                             const int* __restrict__ size,
                                             const float* __restrict__ rem,
                                             const int* __restrict__ m_left,
                                             int cap, int C,
                                             int* __restrict__ size_out) {
  __shared__ float s_rem[VPL * kWarp];
  __shared__ float s_pf[kPrefetch];
  const int k = blockIdx.x;
  const int lane = threadIdx.x;
  float* ak = a + static_cast<size_t>(k) * cap;
  const float* rem_k = rem + static_cast<size_t>(k) * C;

  // round trip 1: the shard's size, count and values, loaded together
  int sz = size[k];
  int left = min(m_left[k], C);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int e = lane + i * kWarp;
    s_rem[e] = e < C ? rem_k[e] : CUDART_INF_F;
  }
  __syncwarp();
  int off = 0;

  while (left > 0) {  // one level-chunk per iteration (warp-uniform)
    const int lo_c = sz + 1;
    const int d_c = depth_of(lo_c);
    const long long room = (2LL << d_c) - lo_c;
    const int m = static_cast<int>(min(static_cast<long long>(left), room));
    const int hi_c = sz + m;

    // the ancestors: lane d < d_c counts level d's nodes, and an inclusive
    // scan gives each level's end in the prefetch buffer
    const int cnt = lane < d_c ? (hi_c >> (d_c - lane)) -
                                     (lo_c >> (d_c - lane)) + 1
                               : 0;
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int y = __shfl_up_sync(kAll, incl, o);
      if (lane >= o) incl += y;
    }
    const int excl = incl - cnt;
    const int total = __shfl_sync(kAll, incl, kWarp - 1);

    // round trip 2: every ancestor of the chunk as one batch of loads.
    // Entry e lies on level d = the number of levels that end at or before
    // it, at node lo_d + (e - the level's start).
    int lev[kPerLane] = {};
#pragma unroll
    for (int j = 0; j < kWarp; ++j) {
      const int end = __shfl_sync(kAll, incl, j);
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) lev[i] += end <= lane + i * kWarp;
    }
    float pv[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int e = lane + i * kWarp;
      const int d = lev[i];
      const int start = __shfl_sync(kAll, excl, d & (kWarp - 1));
      const int v = (lo_c >> max(d_c - d, 0)) + (e - start);
      pv[i] = (e < total && v < cap) ? ak[v] : CUDART_INF_F;
    }
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int e = lane + i * kWarp;
      if (e < total) s_pf[e] = pv[i];
    }

    float S[VPL];  // element t = lane + 32 i of the chunk, sorted
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int t = lane + i * kWarp;
      S[i] = t < m ? s_rem[min(off + t, C - 1)] : CUDART_INF_F;
    }
    __syncwarp();

    // level d's node, segment and a[v] for each element; set up one level
    // ahead, so the next level's shared loads overlap this level's chain
    int v[VPL], seg_lo[VPL], seg_hi[VPL];
    float av[VPL];
    auto setup = [&](int d, int (&nv)[VPL], int (&nlo)[VPL], int (&nhi)[VPL],
                     float (&nav)[VPL]) {
      const int s = d_c - d;
      const int lo_d = lo_c >> s;
      const int base = __shfl_sync(kAll, excl, d & (kWarp - 1));
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int t = lane + i * kWarp;
        nv[i] = static_cast<int>((static_cast<unsigned>(lo_c) + t) >> s);
        const long long first = static_cast<long long>(nv[i]) << s;
        nlo[i] = static_cast<int>(max(first, static_cast<long long>(lo_c)) -
                                  lo_c);
        nhi[i] = static_cast<int>(
            min(first + (1LL << s) - 1, static_cast<long long>(hi_c)) - lo_c);
        nav[i] = t < m && d < d_c ? s_pf[base + nv[i] - lo_d]
                                  : CUDART_INF_F;
      }
    };
    setup(0, v, seg_lo, seg_hi, av);

    for (int d = 0; d < d_c; ++d) {  // the internal levels, on chip
      int v1[VPL], lo1[VPL], hi1[VPL];
      float av1[VPL];
      setup(d + 1, v1, lo1, hi1, av1);
      // bit t: element t is <= its node's a[v] (masked per segment below)
      unsigned long long le = 0;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int t = lane + i * kWarp;
        const unsigned b = __ballot_sync(kAll, t < m && S[i] <= av[i]);
        le |= static_cast<unsigned long long>(b) << (i * kWarp);
      }
      float next[VPL];  // element t + 1
      {
        float sh[VPL];
#pragma unroll
        for (int i = 0; i < VPL; ++i)
          sh[i] = __shfl_sync(kAll, S[i], (lane + 1) & (kWarp - 1));
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
          const float wrap = i + 1 < VPL ? sh[(i + 1) % VPL] : CUDART_INF_F;
          next[i] = lane < kWarp - 1 ? sh[i] : wrap;
        }
      }
      float head[VPL];
#pragma unroll
      for (int i = 0; i < VPL; ++i) head[i] = lane_get<VPL>(S, seg_lo[i]);
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int t = lane + i * kWarp;
        const bool swap = t < m && head[i] < av[i];
        // the segment's elements after its head: bits seg_lo+1 .. seg_hi
        const unsigned long long seg =
            ((2ULL << seg_hi[i]) - 1) & ~((2ULL << seg_lo[i]) - 1);
        const int ins = __popcll(le & seg);  // a[v]'s slot after the shift
        const int j = t - seg_lo[i];
        if (swap) {
          S[i] = j < ins ? next[i] : (j == ins ? av[i] : S[i]);
          if (j == 0 && v[i] < cap) ak[v[i]] = head[i];
        }
      }
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        v[i] = v1[i];
        seg_lo[i] = lo1[i];
        seg_hi[i] = hi1[i];
        av[i] = av1[i];
      }
    }
#pragma unroll
    for (int i = 0; i < VPL; ++i) {  // the leaves: a[lo_c + t] = S[t]
      const int t = lane + i * kWarp;
      if (t < m && lo_c + t < cap) ak[lo_c + t] = S[i];
    }
    sz += m;
    off += m;
    left -= m;
    __syncwarp();  // this chunk's stores before the next chunk's loads
  }
  if (lane == 0) size_out[k] = sz;
}

// one warp per shard; the width picks the values a lane
__global__ void __launch_bounds__(kWarp)
    heap_insert_w32_kernel(float* a, const int* size, const float* rem,
                           const int* m_left, int cap, int C, int* size_out) {
  insert_shard<1>(a, size, rem, m_left, cap, C, size_out);
}

__global__ void __launch_bounds__(kWarp)
    heap_insert_w64_kernel(float* a, const int* size, const float* rem,
                           const int* m_left, int cap, int C, int* size_out) {
  insert_shard<2>(a, size, rem, m_left, cap, C, size_out);
}

}  // namespace

extern "C" int heap_insert_launch(void* a, const void* size, const void* rem,
                                  const void* m_left, int K, int cap, int C,
                                  void* size_out, void* stream) {
  auto* pa = static_cast<float*>(a);
  auto* ps = static_cast<const int*>(size);
  auto* pr = static_cast<const float*>(rem);
  auto* pm = static_cast<const int*>(m_left);
  auto* po = static_cast<int*>(size_out);
  auto st = static_cast<cudaStream_t>(stream);
  if (C <= kWarp)
    heap_insert_w32_kernel<<<K, kWarp, 0, st>>>(pa, ps, pr, pm, cap, C, po);
  else
    heap_insert_w64_kernel<<<K, kWarp, 0, st>>>(pa, ps, pr, pm, cap, C, po);
  return static_cast<int>(cudaGetLastError());
}
