// Sorted merge-compact of K map shards, in ONE cooperative launch (the
// batched ordered map's and the counting sketch's rebuild, DESIGN.md §13,
// §16).
//
// Replaces the TPU kernel src/repro/kernels/sorted_merge/kernel.py,
// merge_sharded_vmem (body _merge_kernel).  Per shard k it writes
//     out = sort(A[keep] ∪ B[:b_count])        (+inf, +inf) past the end
// from ranks alone -- both runs are sorted and share no key:
//     ra_i = #kept-A before i + #valid-B <  A_i      (kept i)
//     rb_j = j                + #kept-A  <  B_j      (j < b_count)
// Preconditions (the map's and the sketch's passes meet them): the kept
// subsequence of A and the valid prefix of B strictly increasing, no key in
// both, finite keys, no NaN values, merged length <= N.  Dropped A slots
// may hold anything: only their keep flag is read.  Keys and values are
// moved, never computed on, so the result equals the plain PyTorch version
// and the numpy oracle bit for bit.
//
// The work is a grid-stride loop over (shard, tile of kTile A slots):
//   phase 0  zero the per-shard histogram hist[k][0..C];
//   phase 1  each tile counts its kept slots (tile_cnt) and, for each kept
//            A_i, m_i = #valid-B < A_i by a binary search of B (staged in
//            shared memory); a shared histogram of m over the tile is added
//            into hist[k] with integer atomics -- order-free, so exact;
//   phase 2  each tile sums the counts of the tiles before it (its offset)
//            and of all tiles (the shard's kept total), block-scans keep
//            (warp ballots) to get ex_i and scatters kept (key, val) to
//            out[offset + ex_i + m_i]; it writes +inf over its own output
//            slots past the merged length L = kept + b_count (no scatter
//            lands there, so no race); the shard's first tile places B_j at
//            j + #kept-A < B_j = j + sum_{m <= j} hist[k][m] (A_i < B_j iff
//            m_i <= j).
// Grid barriers separate the phases.  A is only read and out only written,
// so out must be another buffer (the map passes the body of a fresh state
// row block); row strides let A and out be column slices of (K, N + 1)
// state rows.
//
// What bounds it on an H100: bytes.  The function needs the one-byte keep
// of every A slot, key and value of the kept slots only, the B run, and
// one write of each output slot: at the map's shape (K = 4, N = 253,120,
// C = 16, ~250,000 kept a shard) ~9.0 MB in and ~8.1 MB out, ~5.1 us at
// 3.35 TB/s.  The kernel reads keep and the kept keys twice (phase 1 and
// phase 2; the second read mostly hits the 50 MB L2).  What the design does
// about it: the TPU kernel's (p_chunk, N) masked row-minima (O(N^2) work,
// VMEM-bound near 8K slots a shard) become O(N log C) rank arithmetic and a
// direct scatter, coalesced reads, any N, and one launch with no host sync
// (b_count is read on the device).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4 * kThreads;  // A slots per work item
constexpr int kMaxLanes = 1024;      // widest B run (the wrapper checks)

struct Args {
  int K, N, C, T;  // shards, slots a shard, B lanes, tiles a shard
  const float* __restrict__ ak;
  long long sak;
  const float* __restrict__ av;
  long long sav;
  const unsigned char* __restrict__ keep;
  long long skeep;
  const float* __restrict__ bk;
  long long sbk;
  const float* __restrict__ bv;
  long long sbv;
  const int* __restrict__ bcount;  // (K,) on the device
  float* ok;
  long long sok;
  float* ov;
  long long sov;
  int* tile_cnt;  // (K * T) kept slots per tile
  int* hist;      // (K * (C + 1)) #kept A with m_i = m
};

__device__ __forceinline__ int lower_count(const float* sB, int bc, float x) {
  // #{j < bc : sB[j] < x} for an ascending sB
  int lo = 0, hi = bc;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sB[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ int block_sum(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();  // red's previous readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < kWarps; ++w) total += red[w];
  return total;
}

// exclusive prefix count of `flag` over the block's threads; *all = total
__device__ __forceinline__ int block_rank(bool flag, int* wsum, int* all) {
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int in_warp = __popc(ballot & ((1u << lane) - 1u));
  __syncthreads();
  if (lane == 0) wsum[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int s = wsum[w];
    if (w < warp) before += s;
    total += s;
  }
  *all = total;
  return before + in_warp;
}

__device__ __forceinline__ int valid_b(const Args& a, int k) {
  const int bc = a.bcount[k];
  return bc < 0 ? 0 : (bc > a.C ? a.C : bc);
}

__global__ void __launch_bounds__(kThreads)
sorted_merge_kernel(Args a) {
  __shared__ float sB[kMaxLanes];
  __shared__ int sHist[kMaxLanes + 1];
  __shared__ int red[kWarps];
  __shared__ int wsum[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int items = a.K * a.T;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int gstride = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;

  // phase 0: zero the histograms
  for (int x = gtid; x < a.K * (a.C + 1); x += gstride) a.hist[x] = 0;
  grid.sync();

  // phase 1: kept count and histogram of m_i per tile
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int k = item / a.T;
    const long long base = static_cast<long long>(item % a.T) * kTile;
    const int bc = valid_b(a, k);
    __syncthreads();  // the previous item's readers of sB / sHist are done
    for (int j = threadIdx.x; j < bc; j += kThreads) sB[j] = a.bk[k * a.sbk + j];
    for (int m = threadIdx.x; m <= bc; m += kThreads) sHist[m] = 0;
    __syncthreads();
    int cnt = 0;
    for (int r = 0; r < kTile; r += kThreads) {
      const long long i = base + r + threadIdx.x;
      int m = -1;
      if (i < a.N && a.keep[k * a.skeep + i]) {
        ++cnt;
        m = lower_count(sB, bc, a.ak[k * a.sak + i]);
      }
      // one shared atomic per distinct m in the warp
      const unsigned peers = __match_any_sync(0xffffffffu, m);
      if (m >= 0 && lane == __ffs(peers) - 1) {
        atomicAdd(&sHist[m], __popc(peers));
      }
    }
    const int total = block_sum(cnt, red);  // syncs: sHist complete
    if (threadIdx.x == 0) a.tile_cnt[item] = total;
    for (int m = threadIdx.x; m <= bc; m += kThreads) {
      if (sHist[m]) atomicAdd(&a.hist[k * (a.C + 1) + m], sHist[m]);
    }
  }
  grid.sync();

  // phase 2: scatter kept A, pad with +inf, place B
  const float inf = __int_as_float(0x7f800000);
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int k = item / a.T;
    const int t = item % a.T;
    const long long base = static_cast<long long>(t) * kTile;
    const int bc = valid_b(a, k);
    __syncthreads();
    for (int j = threadIdx.x; j < bc; j += kThreads) sB[j] = a.bk[k * a.sbk + j];
    int before = 0, all = 0;
    for (int u = threadIdx.x; u < a.T; u += kThreads) {
      const int c = a.tile_cnt[k * a.T + u];
      all += c;
      if (u < t) before += c;
    }
    before = block_sum(before, red);
    all = block_sum(all, red);  // syncs: sB staged
    const long long merged = static_cast<long long>(all) + bc;
    int carry = before;
    for (int r = 0; r < kTile; r += kThreads) {
      const long long i = base + r + threadIdx.x;
      const bool kept = i < a.N && a.keep[k * a.skeep + i] != 0;
      int chunk;
      const int ex = block_rank(kept, wsum, &chunk);
      if (kept) {
        const float key = a.ak[k * a.sak + i];
        const long long p = carry + ex + lower_count(sB, bc, key);
        if (p < a.N) {
          a.ok[k * a.sok + p] = key;
          a.ov[k * a.sov + p] = a.av[k * a.sav + i];
        }
      }
      carry += chunk;
      if (i < a.N && i >= merged) {
        a.ok[k * a.sok + i] = inf;
        a.ov[k * a.sov + i] = inf;
      }
    }
    if (t == 0) {
      const int* h = a.hist + k * (a.C + 1);
      for (int j = threadIdx.x; j < bc; j += kThreads) {
        int below = 0;
        for (int m = 0; m <= j; ++m) below += h[m];
        const long long p = static_cast<long long>(j) + below;
        if (p < a.N) {
          a.ok[k * a.sok + p] = a.bk[k * a.sbk + j];
          a.ov[k * a.sov + p] = a.bv[k * a.sbv + j];
        }
      }
    }
  }
}

int g_max_blocks = 0;  // resident blocks on the whole card (0: not known)

int max_cooperative_blocks() {
  if (g_max_blocks > 0) return g_max_blocks;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return -1;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sorted_merge_kernel,
                                                kThreads, 0);
  g_max_blocks = sms * per_sm;
  return g_max_blocks;
}

}  // namespace

extern "C" int sorted_merge_max_lanes() { return kMaxLanes; }

extern "C" int sorted_merge_tile() { return kTile; }

// scratch: (K * T + K * (C + 1)) int32, T = ceil(N / kTile); no zeroing
// needed.  Strides are in elements; every row's last stride is 1.
extern "C" int sorted_merge_launch(int K, int N, int C, const void* ak,
                                   long long sak, const void* av,
                                   long long sav, const void* keep,
                                   long long skeep, const void* bk,
                                   long long sbk, const void* bv,
                                   long long sbv, const void* bcount,
                                   void* okeys, long long sok, void* ovals,
                                   long long sov, void* scratch,
                                   void* stream) {
  if (C > kMaxLanes || C < 0 || K < 1 || N < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int max_blocks = max_cooperative_blocks();
  if (max_blocks <= 0) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? static_cast<int>(err)
                              : static_cast<int>(cudaErrorNotSupported);
  }
  Args a;
  a.K = K;
  a.N = N;
  a.C = C;
  a.T = (N + kTile - 1) / kTile;
  a.ak = static_cast<const float*>(ak);
  a.sak = sak;
  a.av = static_cast<const float*>(av);
  a.sav = sav;
  a.keep = static_cast<const unsigned char*>(keep);
  a.skeep = skeep;
  a.bk = static_cast<const float*>(bk);
  a.sbk = sbk;
  a.bv = static_cast<const float*>(bv);
  a.sbv = sbv;
  a.bcount = static_cast<const int*>(bcount);
  a.ok = static_cast<float*>(okeys);
  a.sok = sok;
  a.ov = static_cast<float*>(ovals);
  a.sov = sov;
  a.tile_cnt = static_cast<int*>(scratch);
  a.hist = a.tile_cnt + static_cast<long long>(K) * a.T;
  int blocks = K * a.T;
  if (blocks > max_blocks) blocks = max_blocks;
  void* params[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(sorted_merge_kernel), dim3(blocks),
      dim3(kThreads), params, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it; the wrapper raises with the code
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
