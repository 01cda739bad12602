// Phase 3 of the batched heap pass: the parallel sift-down wavefront
// (paper §4 ExtractMin phase), updating the heap stack in place.
//
// Replaces the TPU kernel src/repro/kernels/heap_sift/kernel.py,
// sift_sharded_vmem (body _sift_kernel).  c cursors, one per extracted
// node, sift down in a level-synchronous wavefront: at step t the cursors
// with t >= delay_i = d_max - depth(start_i) advance one level, deepest
// start first.  Two active cursors then stay >= 2 levels apart, so one
// step's reads (v, 2v, 2v+1) and writes (v, w) never touch another
// cursor's nodes, and the result equals the paper's sequential order SE.
// Tie rule of batched_pq._sift_wavefront: w = l if a[l] <= a[r] else r,
// swap only if a[w] < a[v].
//
// The TPU kernel starts by copying the whole shard (out_ref[...] = a_ref)
// on every launch; this one updates a in place and touches only the nodes
// on the cursors' paths.
//
// What bounds it on an H100: latency.  Each cursor moves ~log2(cap) levels
// (20 at a million slots), every level a dependent global load, so the
// floor is about (d_max + depth range) load latencies, not bytes (a few
// KiB per pass) or operations.
// What the design does about it: one CTA per shard (grid = K), one thread
// per cursor, two barriers per level (all reads, then the predicated swap
// writes), and the loop ends as soon as no cursor is active
// (__syncthreads_or).
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__device__ __forceinline__ int depth_of(int v) {
  return 31 - __clz(max(v, 1));
}

__global__ void heap_sift_kernel(float* __restrict__ a,
                                 const int* __restrict__ size,
                                 const int* __restrict__ starts,
                                 const unsigned char* __restrict__ active,
                                 int cap, int c) {
  __shared__ int s_dmax;
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  float* ak = a + static_cast<size_t>(k) * cap;
  const int sz = size[k];

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

  for (int step = 0; __syncthreads_or(act); ++step) {
    const bool moving = act && step >= delay;
    float av = CUDART_INF_F, lv = CUDART_INF_F, rv = CUDART_INF_F;
    const int l = 2 * pos, r = 2 * pos + 1;
    if (moving) {
      av = ak[pos];
      if (l <= sz && l < cap) lv = ak[l];
      if (r <= sz && r < cap) rv = ak[r];
    }
    __syncthreads();  // every read of this level before any write
    if (moving) {
      const bool go_left = lv <= rv;
      const float wv = go_left ? lv : rv;
      const int w = go_left ? l : r;
      if (wv < av) {
        ak[pos] = wv;
        ak[w] = av;
        pos = w;
      } else {
        act = false;
      }
    }
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
