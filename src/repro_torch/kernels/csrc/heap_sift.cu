// Phase 3 of the batched heap pass: the parallel sift-down wavefront
// (paper §4 ExtractMin phase), updating the heap stack in place.
//
// Replaces the TPU kernel src/repro/kernels/heap_sift/kernel.py,
// sift_sharded_vmem (body _sift_kernel).  c cursors, one per extracted
// node, sift down staggered by start depth: cursor i starts moving at step
// delay_i = d_max - depth(start_i), deepest start first.  Tie rule of
// batched_pq._sift_wavefront: w = l if a[l] <= a[r] else r, swap only if
// a[w] < a[v], children past `size` read as +inf.  The result equals the
// paper's sequential order SE.
//
// k levels per round trip.  At each step a moving cursor loads, as one
// batch of independent loads, its value (first step only: afterwards it
// carries it) and the k levels below its node -- level j of that subtree
// is the contiguous run pos*2^j .. pos*2^j + 2^j - 1 -- and then decides up
// to k levels on chip, writing at most k + 1 nodes (each node it leaves
// takes the smaller child's value, the last takes the carried value).  A
// cursor that stops inside a step is done.
// Why the stagger of one step per start depth still gives SE: while cursor
// i (deeper start) is still moving it is exactly
// (depth_i - depth_j) * (k + 1) >= k + 1 levels below a shallower cursor j,
// so within one step the levels j touches (its node and the k below) and
// the levels i touches are disjoint; i never returns to a level above it,
// so everything j reads there is final, as if i had run to its end first.
// One barrier per step orders the steps.  Cursors starting at one depth
// have disjoint subtrees.
//
// What bounds it on an H100: latency.  A cursor moves ~log2(cap) levels
// (20 at a million slots), and each level used to be a dependent global
// load and two barriers, so a launch took ~(d_max + depth range) round
// trips to memory.  Now it takes ~(levels / k + depth range): ~5 + stagger
// instead of ~20 + stagger at k = 4.  Bytes (a few KiB per pass) and
// operations are far below that.  What is left: the stagger (one step per
// start depth, which SE needs for nested starts) and a step's time, which
// grows with k (its 2^(k+1) - 2 scattered loads a cursor).
// The design: one CTA per shard (grid = K), one thread per cursor (c up to
// 1024, so at most 64 registers a thread), the subtree's values in
// registers (flat loops of constant length keep every index into them
// static; the path picks among them by selects), one __syncthreads_or per
// step, which also ends the loop when no cursor is active.  Shard rows
// start at k*cap floats for any cap, so the loads are scalar: no alignment
// is assumed.  Chosen on the card (PERF.md): k = 4; k = 5 spills at 64
// registers; a warp per cursor (a lane per subtree node) and an L2
// prefetch of the next step's levels were both slower.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kSiftLevels = 4;                  // levels a round trip
constexpr int kSub = (2 << kSiftLevels) - 2;    // nodes below, k levels deep

__device__ __forceinline__ int depth_of(int v) {
  return 31 - __clz(max(v, 1));
}

__global__ void __launch_bounds__(1024)
    heap_sift_kernel(float* __restrict__ a, const int* __restrict__ size,
                     const int* __restrict__ starts,
                     const unsigned char* __restrict__ active, int cap,
                     int c) {
  __shared__ int s_dmax;
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  float* ak = a + static_cast<size_t>(k) * cap;
  const int sz = min(size[k], cap - 1);

  int pos = 0;
  bool act = false;
  if (t < c) {
    pos = starts[static_cast<size_t>(k) * c + t];
    act = active[static_cast<size_t>(k) * c + t] != 0;
  }
  const int dep = depth_of(pos);
  if (t == 0) s_dmax = 0;
  __syncthreads();
  if (act) atomicMax(&s_dmax, dep);
  __syncthreads();
  const int delay = s_dmax - dep;

  float av = CUDART_INF_F;  // the value the cursor carries, once loaded
  bool fresh = true;
  for (int step = 0; __syncthreads_or(act); ++step) {
    if (!act || step < delay) continue;
    // one round trip: the subtree, entry e at level j = log2(e + 2) (the
    // run pos*2^j .. pos*2^j + 2^j - 1), and the node's value (first step)
    float sub[kSub];
#pragma unroll
    for (int e = 0; e < kSub; ++e) {
      const int j = 31 - __clz(e + 2);
      const long long v = (static_cast<long long>(pos) << j) + e + 2 -
                          (1 << j);
      sub[e] = v <= sz ? ak[v] : CUDART_INF_F;
    }
    if (fresh) av = ak[pos];
    fresh = false;

    // up to kSiftLevels levels on chip; u: the path's node within level j
    long long p = pos;
    int u = 0;
    bool go = true;
#pragma unroll
    for (int j = 1; j <= kSiftLevels; ++j) {
      float lv = CUDART_INF_F, rv = CUDART_INF_F;
#pragma unroll
      for (int e = 0; e < kSub; e += 2) {
        if (e + 2 >= (1 << j) && e + 2 < (2 << j) &&
            e + 2 - (1 << j) == 2 * u) {
          lv = sub[e];
          rv = sub[e + 1];
        }
      }
      if (go) {
        const bool go_left = lv <= rv;
        const float wv = go_left ? lv : rv;
        if (wv < av) {
          ak[p] = wv;
          p = 2 * p + (go_left ? 0 : 1);
          u = 2 * u + (go_left ? 0 : 1);
        } else {
          go = false;
        }
      }
    }
    if (p != pos) ak[p] = av;
    pos = static_cast<int>(p);
    act = go;
  }
}

}  // namespace

extern "C" int heap_sift_launch(void* a, const void* size, const void* starts,
                                const void* active, int K, int cap, int c,
                                void* stream) {
  const int threads = ((c + 31) / 32) * 32;
  heap_sift_kernel<<<K, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(a), static_cast<const int*>(size),
      static_cast<const int*>(starts),
      static_cast<const unsigned char*>(active), cap, c);
  return static_cast<int>(cudaGetLastError());
}
