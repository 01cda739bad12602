// Phase 1 of the batched heap pass: the frontier search for the k smallest
// nodes of each heap shard (paper §4 combiner phase 1).
//
// Replaces the TPU kernel src/repro/kernels/heap_kmin/kernel.py,
// kmin_sharded_vmem (body _kmin_kernel): same result element for element,
// not the same block structure.  Per shard it returns the ids and values
// of the min(ne, size_k) smallest nodes in ascending order, padded with
// (0, +inf).  Each of the c_max steps takes the frontier's minimum (the
// LOWEST lane on ties, as jnp.argmin and the numpy oracle do: the sharded
// pass reuses these candidates as each shard's phase-1 result, so the tie
// rule is load-bearing), replaces it by its left child and appends its
// right child.
//
// What bounds it on an H100: neither bytes nor operations.  It reads at
// most 2*ne heap nodes and writes K*c_max*(4+4) bytes, a few ns at
// 3.35 TB/s; but every step depends on the previous one through a global
// load of the two children (L2 or HBM latency, ~0.5-1 us) and a warp
// reduction, so its floor is c_max dependent load latencies.
// What the design does about it: one warp per shard (grid = K), the
// frontier (F = 2*c_max+1 <= 129 lanes) stays in shared memory, the argmin
// is a register scan plus five shuffles, and the search stops at the first
// inactive step instead of running all c_max steps.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxC = 64;
constexpr int kMaxF = 2 * kMaxC + 1;

__global__ void heap_kmin_kernel(const float* __restrict__ a,
                                 const int* __restrict__ size, int cap,
                                 int ne, int c_max, int* __restrict__ ids,
                                 float* __restrict__ vals) {
  __shared__ int f_ids[kMaxF];
  __shared__ float f_vals[kMaxF];
  const int k = blockIdx.x;
  const int lane = threadIdx.x;
  const float* ak = a + static_cast<size_t>(k) * cap;
  int* ids_k = ids + static_cast<size_t>(k) * c_max;
  float* vals_k = vals + static_cast<size_t>(k) * c_max;
  const int sz = size[k];
  const int F = 2 * c_max + 1;

  for (int t = lane; t < F; t += 32) {
    f_ids[t] = 0;
    f_vals[t] = CUDART_INF_F;
  }
  __syncwarp();
  if (lane == 0) {
    f_ids[0] = 1;
    f_vals[0] = sz >= 1 ? ak[1] : CUDART_INF_F;
  }
  __syncwarp();

  int nfree = 1;  // next free frontier slot (used by lane 0 only)
  for (int i = 0; i < c_max; ++i) {
    // argmin over the frontier: smallest value, lowest lane on ties
    float best = CUDART_INF_F;
    int bj = F;
    for (int t = lane; t < F; t += 32) {
      const float x = f_vals[t];
      if (x < best || (x == best && t < bj)) {
        best = x;
        bj = t;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_down_sync(0xffffffffu, best, off);
      const int oj = __shfl_down_sync(0xffffffffu, bj, off);
      if (ob < best || (ob == best && oj < bj)) {
        best = ob;
        bj = oj;
      }
    }
    const bool active = (i < ne) && isfinite(best);  // valid in lane 0
    if (!__shfl_sync(0xffffffffu, static_cast<int>(active), 0)) {
      // the frontier is exhausted or the extract count reached: every
      // later step is inactive too, so pad the rest and stop
      for (int t = i + lane; t < c_max; t += 32) {
        ids_k[t] = 0;
        vals_k[t] = CUDART_INF_F;
      }
      return;
    }
    if (lane == 0) {
      const int v = f_ids[bj];
      const int l = 2 * v, r = 2 * v + 1;
      const float lval = (l <= sz && l < cap) ? ak[l] : CUDART_INF_F;
      const float rval = (r <= sz && r < cap) ? ak[r] : CUDART_INF_F;
      f_ids[bj] = l;
      f_vals[bj] = lval;
      f_ids[nfree] = r;
      f_vals[nfree] = rval;
      ++nfree;
      ids_k[i] = v;
      vals_k[i] = best;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int heap_kmin_launch(const void* a, const void* size, int K,
                                int cap, int ne, int c_max, void* ids,
                                void* vals, void* stream) {
  heap_kmin_kernel<<<K, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const int*>(size), cap, ne,
      c_max, static_cast<int*>(ids), static_cast<float*>(vals));
  return static_cast<int>(cudaGetLastError());
}
