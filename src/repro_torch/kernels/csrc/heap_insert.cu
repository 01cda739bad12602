// Phase 4 of the batched heap pass: the collective insert (paper §4 Insert
// phase), the whole level-chunk loop in one launch, in place.
//
// Replaces the TPU kernel src/repro/kernels/heap_insert/kernel.py,
// insert_sharded_vmem (body _insert_kernel), and the chunk loop around it
// (batched_pq._phase4, sharded_pq.py's K-vector twin).  Per shard, the
// m_left sorted values of rem are placed at slots size+1 .. size+m_left,
// chunked at tree-level boundaries exactly as batched_pq._chunk_len does;
// each chunk descends from the root one level at a time.  At level d,
// slot j handles node v = lo_d + j (masked by v <= hi_d): an internal node
// keeps min(S_j[0], a[v]) and the displaced a[v] re-enters S_j keeping it
// sorted (_replace_head_sorted); a leaf target takes S_j[0].  S_j is then
// split by the number of targets under the left child, tcount(2v), and the
// halves go straight into the children's rows of the next level's buffer.
// The result equals batched_pq._insert_chunk element for element.
//
// Dropped TPU workarounds: the one-hot matmul row gather and the (C,C,C)
// selector (rows are indexed directly in shared memory), the finite
// BIG = 1e30 padding (rows are +inf padded, as in the XLA twin, so keys up
// to the f32 max work), the contiguous C-wide block load that made the
// wrappers pad every heap with C slots, and the whole-shard copy
// out_ref[...] = a_ref[...] on every launch.
//
// What bounds it on an H100: latency.  It moves a few hundred bytes per
// level, but the levels of a chunk are a dependent chain of global loads
// and barriers (~log2(cap) levels per chunk, at most two chunks when
// m_left <= c_max fits in two levels), so the floor is that chain, not
// bytes or operations.
// What the design does about it: one CTA per shard (grid = K), C threads
// (one per InsertSet row), the (C, C) InsertSet double-buffered in shared
// memory (2*C*C*4 bytes: 32 KiB at C = 64), and the whole chunk loop in
// the kernel so phase 4 is one launch per pass instead of one per chunk.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__device__ __forceinline__ int depth_of(int v) {
  return 31 - __clz(max(v, 1));
}

// number of targets lo_c..hi_c (all at depth d_c) under node v at depth d
__device__ __forceinline__ long long tcount(long long v, int d, int d_c,
                                            long long lo_c, long long hi_c) {
  const int shift = max(d_c - d, 0);
  const long long vlo = v << shift;
  const long long vhi = vlo + (1LL << shift) - 1;
  const long long cnt = min(hi_c, vhi) - max(lo_c, vlo) + 1;
  return v > 0 ? max(cnt, 0LL) : 0LL;
}

__global__ void heap_insert_kernel(float* __restrict__ a,
                                   const int* __restrict__ size,
                                   const float* __restrict__ rem,
                                   const int* __restrict__ m_left, int cap,
                                   int C, int* __restrict__ size_out) {
  extern __shared__ float smem[];
  float* cur = smem;           // (C, C): row j = InsertSet of slot j
  float* nxt = smem + C * C;   // next level's rows
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  float* ak = a + static_cast<size_t>(k) * cap;
  const float* rem_k = rem + static_cast<size_t>(k) * C;
  int sz = size[k];
  int left = m_left[k];
  int off = 0;

  while (left > 0) {  // one level-chunk per iteration (block-uniform)
    const int lo_c = sz + 1;
    const int d_c = depth_of(lo_c);
    const int level_end = (2 << d_c) - 1;
    const int m = min(left, level_end - lo_c + 1);
    const int hi_c = sz + m;

    // depth 0: the root's row holds the whole chunk, every other row empty
    for (int e = t; e < C * C; e += blockDim.x) {
      const int col = e % C;
      cur[e] = (e < C && col < m) ? rem_k[min(off + col, C - 1)]
                                  : CUDART_INF_F;
    }
    __syncthreads();

    for (int d = 0; d <= d_c; ++d) {
      const bool is_leaf = d == d_c;
      const int lo_d = lo_c >> (d_c - d);
      const int hi_d = hi_c >> (d_c - d);
      const int v = lo_d + t;
      // v < cap: never touch memory past the shard, whatever the caller
      // passed (the host guards refuse batches that would overflow)
      const bool slot_on = t < C && v <= hi_d && v < cap;
      float* S = cur + t * C;

      if (slot_on) {
        const float av = ak[v];
        const float minS = S[0];
        const bool do_swap = !is_leaf && minS < av;
        if (do_swap || is_leaf) ak[v] = minS;
        if (do_swap) {
          // drop S[0], insert av after its equals, keep the row sorted
          int ins = (CUDART_INF_F <= av) ? 1 : 0;
          for (int i = 1; i < C; ++i) ins += (S[i] <= av);
          for (int i = 0; i < ins; ++i) S[i] = (i + 1 < C) ? S[i + 1]
                                                           : CUDART_INF_F;
          if (ins < C) S[ins] = av;
        }
      }
      if (is_leaf) break;

      for (int e = t; e < C * C; e += blockDim.x) nxt[e] = CUDART_INF_F;
      __syncthreads();
      if (slot_on) {
        const int lo_next = lo_c >> (d_c - d - 1);
        const int hi_next = hi_c >> (d_c - d - 1);
        const int lc = static_cast<int>(tcount(2LL * v, d + 1, d_c, lo_c,
                                               hi_c));
        const int lraw = 2 * v - lo_next;
        const int rraw = lraw + 1;
        const int width = hi_next - lo_next;
        if (lraw >= 0 && lraw <= width) {
          float* L = nxt + lraw * C;
          for (int i = 0; i < C; ++i) L[i] = i < lc ? S[i] : CUDART_INF_F;
        }
        if (rraw >= 0 && rraw <= width) {
          float* R = nxt + rraw * C;
          for (int i = 0; i < C; ++i) R[i] = i + lc < C ? S[i + lc]
                                                        : CUDART_INF_F;
        }
      }
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    sz += m;
    off += m;
    left -= m;
    __syncthreads();  // this chunk's heap writes before the next's reads
  }
  if (t == 0) size_out[k] = sz;
}

}  // namespace

extern "C" int heap_insert_launch(void* a, const void* size, const void* rem,
                                  const void* m_left, int K, int cap, int C,
                                  void* size_out, void* stream) {
  const int threads = ((C + 31) / 32) * 32;
  const size_t smem = 2 * static_cast<size_t>(C) * C * sizeof(float);
  heap_insert_kernel<<<K, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(a), static_cast<const int*>(size),
      static_cast<const float*>(rem), static_cast<const int*>(m_left), cap, C,
      static_cast<int*>(size_out));
  return static_cast<int>(cudaGetLastError());
}
