// Phase 1 of the batched heap pass: the frontier search for the k smallest
// nodes of each heap shard (paper §4 combiner phase 1).
//
// Replaces the TPU kernel src/repro/kernels/heap_kmin/kernel.py,
// kmin_sharded_vmem (body _kmin_kernel): same result element for element,
// not the same block structure.  Per shard it returns the ids and values
// of the min(ne, size_k) smallest nodes in ascending order, padded with
// (0, +inf).  Each of the c_max steps takes the frontier's minimum (the
// LOWEST slot on ties, as jnp.argmin and the numpy oracle do: the sharded
// pass reuses these candidates as each shard's phase-1 result, so the tie
// rule is load-bearing), replaces it by its left child and appends its
// right child at the next free slot.
//
// What bounds it on an H100: round trips to memory.  It reads at most
// 2*ne heap nodes and writes K*c_max*(4+4) bytes, a few ns at 3.35 TB/s,
// but a step cannot start before the children of the previous step's node
// are loaded, so a search that loads them step by step pays one dependent
// round trip (L2 or HBM, ~0.5-1 us) a step: ~16 at the pass's c_max.
// What the design does about it: the children come from an on-chip cache.
//   - At launch the warp loads, as one batch of independent loads issued
//     with size[k] and the extract count, the root and the top kTopLevels
//     levels (nodes 1 .. 2^T - 1, at their ids in shared memory), masked
//     by size afterwards.  The extract count is a device int32 read in
//     that same round trip, so a captured CUDA graph replays the launch
//     with whatever count the pass wrote there.
//     The c smallest nodes form a subtree of <= c nodes holding the root,
//     so in a large heap most of their children lie in these levels.
//   - A step that takes a node whose children are not cached (a miss)
//     loads that node's kSubLevels-level subtree (2 + 4 + ... + 2^k
//     nodes, each level a contiguous run) in one batch, one node a lane,
//     into a block of its own; later steps inside that subtree load
//     nothing.  A launch makes 1 + (misses) round trips.
//   - Each frontier slot carries the shared index of its left child (-1:
//     not cached), so a hit is a shared-memory read.
//   - With the loads off the chain, a step's own latency is the chain.
//     The frontier (F = 2*c_max + 1 <= 129 slots) lives in registers, in
//     as few a lane as F needs (S: the kernel is instantiated for 1..5; 2
//     at the pass's c_max of 16), slot s in lane s / S, register s % S.
//     The argmin is each lane's first minimum over an order-preserving
//     integer image of the values (-0.0 and +0.0 map to one image, as the
//     float compare treats them; keys are never NaN), one
//     __reduce_min_sync, and the lowest lane holding the minimum (a
//     ballot): in this layout that lane holds the lowest such slot.
//   - The search stops at the first inactive step instead of running all
//     c_max steps.
// Chosen on the card (PERF.md, tools/kmin_merge_ablation.py): T = 7, the
// fewest levels at which chip_smoke.py's timed 16-extract search makes no
// miss (T = 8 is no faster); k = 4 (k matters only past a miss).
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTopLevels = 7;   // levels cached at launch (nodes 1..2^T-1)
constexpr int kSubLevels = 4;   // levels loaded below a node on a miss
constexpr int kMaxC = 64;
constexpr int kMaxF = 2 * kMaxC + 1;
constexpr int kMaxSlots = (kMaxF + 31) / 32;     // frontier slots a lane
constexpr int kTop = 1 << kTopLevels;            // node v at index v < kTop
constexpr int kSub = 2 << kSubLevels;            // a block: local 2..kSub-1
constexpr int kTopLoads = (kTop + 31) / 32;
constexpr int kSubLoads = (kSub - 2 + 31) / 32;
constexpr unsigned kFull = 0xffffffffu;

// An unsigned image of x ordered as the float compare orders it, with
// -0.0 and +0.0 one value (keys are never NaN).
__device__ __forceinline__ unsigned order_key(float x) {
  unsigned b = __float_as_uint(x);
  if ((b << 1) == 0u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The shared index of the left child of the node cached at index c (its
// right child follows), or -1 when those children are not cached.  Top
// levels: node v at index v.  Miss blocks start at kTop + b*kSub and hold
// the subtree's node of heap-local index u (2 <= u < kSub) at base + u.
__device__ __forceinline__ int child_slot(int c) {
  if (c < kTop) return 2 * c < kTop ? 2 * c : -1;
  const int u = (c - kTop) & (kSub - 1);
  return 2 * u < kSub ? c + u : -1;
}

// kSlots: frontier slots a lane, the fewest that hold 2*c_max + 1
template <int kSlots>
__global__ void __launch_bounds__(32)
    heap_kmin_kernel(const float* __restrict__ a,
                     const int* __restrict__ size, int cap,
                     const int* __restrict__ n_extract, int c_max,
                     int* __restrict__ ids,
                     float* __restrict__ vals) {
  __shared__ float cache[kTop + kMaxC * kSub];
  const int k = blockIdx.x;
  const int lane = threadIdx.x;
  const float* ak = a + static_cast<size_t>(k) * cap;
  int* ids_k = ids + static_cast<size_t>(k) * c_max;
  float* vals_k = vals + static_cast<size_t>(k) * c_max;

  // one round trip: size, the extract count, the root and the top levels,
  // all independent
  const int sz = size[k];
  const int ne = *n_extract;
  const float root = ak[1];
  float top[kTopLoads];
#pragma unroll
  for (int q = 0; q < kTopLoads; ++q) {
    const int v = lane + 32 * q;
    top[q] = (v >= 1 && v < kTop && v < cap) ? ak[v] : CUDART_INF_F;
  }
#pragma unroll
  for (int q = 0; q < kTopLoads; ++q) {
    const int v = lane + 32 * q;
    if (v < kTop) cache[v] = v <= sz ? top[q] : CUDART_INF_F;
  }
  __syncwarp();

  // frontier slot lane * kSlots + r: value, node id, shared index of its
  // left child (-1: not cached)
  float fv[kSlots];
  int fid[kSlots], fcl[kSlots];
#pragma unroll
  for (int r = 0; r < kSlots; ++r) {
    fv[r] = CUDART_INF_F;
    fid[r] = 0;
    fcl[r] = -1;
  }
  if (lane == 0) {
    fv[0] = sz >= 1 ? root : CUDART_INF_F;
    fid[0] = 1;
    fcl[0] = 2 < kTop ? 2 : -1;
  }

  int nfree = 1;  // next free frontier slot
  int nblk = 0;   // miss blocks used
  for (int i = 0; i < c_max; ++i) {
    // argmin over the frontier: smallest value, lowest slot on ties
    unsigned best = order_key(fv[0]);
    int br = 0;
#pragma unroll
    for (int r = 1; r < kSlots; ++r) {
      const unsigned key = order_key(fv[r]);
      if (key < best) {
        best = key;
        br = r;
      }
    }
    const unsigned m = __reduce_min_sync(kFull, best);
    const int owner = __ffs(__ballot_sync(kFull, best == m)) - 1;
    float sv = fv[0];
    int sid = fid[0], scl = fcl[0];
#pragma unroll
    for (int r = 1; r < kSlots; ++r) {
      if (br == r) {
        sv = fv[r];
        sid = fid[r];
        scl = fcl[r];
      }
    }
    const float val = __shfl_sync(kFull, sv, owner);
    const int v = __shfl_sync(kFull, sid, owner);
    int cl = __shfl_sync(kFull, scl, owner);
    const int s = owner * kSlots + __shfl_sync(kFull, br, owner);
    if (i >= ne || !isfinite(val)) {
      // the frontier is exhausted or the extract count reached: every
      // later step is inactive too, so pad the rest and stop
      for (int t = i + lane; t < c_max; t += 32) {
        ids_k[t] = 0;
        vals_k[t] = CUDART_INF_F;
      }
      return;
    }
    if (cl < 0) {
      // a miss: load v's kSubLevels-level subtree as one batch
      const int base = kTop + nblk * kSub;
      ++nblk;
      float got[kSubLoads];
#pragma unroll
      for (int q = 0; q < kSubLoads; ++q) {
        const int u = 2 + lane + 32 * q;
        const int j = 31 - __clz(u);
        const long long g =
            (static_cast<long long>(v) << j) + (u - (1 << j));
        got[q] = (u < kSub && g <= sz && g < cap) ? ak[g] : CUDART_INF_F;
      }
#pragma unroll
      for (int q = 0; q < kSubLoads; ++q) {
        const int u = 2 + lane + 32 * q;
        if (u < kSub) cache[base + u] = got[q];
      }
      __syncwarp();
      cl = base + 2;
    }
    const float lval = cache[cl], rval = cache[cl + 1];
    const int lcl = child_slot(cl), rcl = child_slot(cl + 1);
#pragma unroll
    for (int r = 0; r < kSlots; ++r) {
      if (s == lane * kSlots + r) {
        fv[r] = lval;
        fid[r] = 2 * v;
        fcl[r] = lcl;
      }
      if (nfree == lane * kSlots + r) {
        fv[r] = rval;
        fid[r] = 2 * v + 1;
        fcl[r] = rcl;
      }
    }
    ++nfree;
    if (lane == 0) {
      ids_k[i] = v;
      vals_k[i] = val;
    }
  }
}

template <int kSlots>
void launch(const void* a, const void* size, int K, int cap, const void* ne,
            int c_max, void* ids, void* vals, cudaStream_t stream) {
  heap_kmin_kernel<kSlots><<<K, 32, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const int*>(size), cap,
      static_cast<const int*>(ne), c_max, static_cast<int*>(ids),
      static_cast<float*>(vals));
}

}  // namespace

// ne: a device pointer to the batch's extract count (one int32)
extern "C" int heap_kmin_launch(const void* a, const void* size, int K,
                                int cap, const void* ne, int c_max,
                                void* ids, void* vals, void* stream) {
  if (c_max < 1 || c_max > kMaxC) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((2 * c_max + 1 + 31) / 32) {
    case 1:
      launch<1>(a, size, K, cap, ne, c_max, ids, vals, st);
      break;
    case 2:
      launch<2>(a, size, K, cap, ne, c_max, ids, vals, st);
      break;
    case 3:
      launch<3>(a, size, K, cap, ne, c_max, ids, vals, st);
      break;
    case 4:
      launch<4>(a, size, K, cap, ne, c_max, ids, vals, st);
      break;
    default:
      launch<kMaxSlots>(a, size, K, cap, ne, c_max, ids, vals, st);
  }
  return static_cast<int>(cudaGetLastError());
}
