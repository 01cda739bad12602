// Sorted merge-compact of K map shards, in ONE ordinary launch with no grid
// barrier (the batched ordered map's and the counting sketch's rebuild,
// DESIGN.md §13, §16).
//
// Replaces the TPU kernel src/repro/kernels/sorted_merge/kernel.py,
// merge_sharded_vmem (body _merge_kernel).  Per shard k it writes
//     out = sort(A[keep] ∪ B[:b_count])        (+inf, +inf) past the end
// from ranks alone -- both runs are sorted and share no key:
//     kept A_i goes to  #kept-A before i + m_i,  m_i = #valid-B < A_i
//     B_j goes to       j + #kept-A < B_j
// Preconditions (the map's and the sketch's passes meet them): the kept
// subsequence of A and the valid prefix of B strictly increasing, no key in
// both, finite keys, no NaN values, merged length <= N.  Dropped A slots
// may hold anything: only their keep flag is read.  Keys and values are
// moved, never computed on, so the result equals the plain PyTorch version
// and the numpy oracle bit for bit.  A is only read and out only written,
// so out must be another buffer (the map passes the body of a fresh state
// row block); row strides let A and out be column slices of (K, N + 1)
// state rows, so rows need not be aligned: every load and store is a
// scalar one, a warp's 32 on consecutive slots.
//
// The design: a single-pass scan with decoupled look-back (Merrill and
// Garland, 2016).  One CTA a tile of kTile A slots of one shard, plus
// kPadCtas CTAs for the +inf tails; each CTA draws its role from an atomic
// ticket, so a CTA only ever waits on tiles that started before it.
//   1. A tile stages B (<= 4 KB, from L2 after the first tile) in shared
//      memory and issues its loads at once: the keep flags with the keys
//      (a dropped slot's key is read and not used: ~1 % more bytes at the
//      map's fill, one round trip less), then the values of the kept slots
//      only; thread t holds slots base + j*kThreads + t.  m_i comes from
//      the thread's previous m (a thread's kept keys rise with j, and m
//      with them: one compare, a binary search of B only past a B key);
//      kept counts per (row, warp) by ballots, one barrier, and each
//      thread's exclusive rank from those counts.
//   2. It publishes its aggregate -- a 64-bit status word: kept count, the
//      largest m of its kept slots (m rises with the key), an inclusive
//      flag and the call's epoch -- then one warp looks back over the
//      shard's earlier tiles, 128 words a round trip (4 a lane: the tiles
//      start together, so the nearest inclusive word is often far back),
//      until it meets an inclusive word, and publishes its own.
//   3. Placement, one writer per output slot: kept A_i at P + ex_i + m_i
//      (P the kept count before the tile); each B_j whose successor (the
//      first kept A above it) lies in this tile, i.e. m_prev <= j < m_max
//      of the tile, at P + j + #tile-kept < B_j (a search of the tile's
//      kept keys, compacted in shared memory); the shard's last tile also
//      the B_j above every kept A, at kept + j.
//   4. The pad CTAs wait for each shard's last inclusive word (so L =
//      kept + b_count) and write (+inf, +inf) over [L, N), spread over all
//      of them: keep-none and empty-A rows are a whole row of it.
// Nothing is reset by a launch of its own: the status words carry the
// call's epoch (a word of an earlier call reads as not ready), the
// wrapper keeps one zeroed scratch per stream and numbers the calls, and
// the CTA that draws the last ticket puts the ticket counter back to 0.
//
// What bounds it on an H100: bytes, then latency.  The function needs the
// one-byte keep of every A slot, key and value of the kept slots only, the
// B run, and one write of each output slot: at the map's shape (K = 4,
// N = 253,120, C = 16, ~250,000 kept a shard) ~9.0 MB in and ~8.1 MB out,
// ~5.1 us at 3.35 TB/s.  On top of it: the ticket, the loads under the
// whole grid's traffic, the look-back's status reads through L2, the
// stores' drain and the launch.  The cooperative form it replaces read
// keep and the kept keys twice, ranked each 256-slot row behind two
// barriers and paid two grid barriers.  Chosen on the card (PERF.md,
// tools/kmin_merge_ablation.py): 256 threads of 8 slots (4 spill, 16 and
// 512-thread tiles are slower on the map's pass), no fence on publish.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;               // threads a tile
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                   // A slots a thread
constexpr int kTile = kItems * kThreads;    // A slots a tile
// CTAs an SM must hold: 132 SMs then hold every tile of the map's pass
// (K = 4, N = 253,120) at once, so no tile waits for a second wave
constexpr int kBlocksPerSm = 8192 / (kThreads * kItems);
constexpr int kMaxLanes = 1024;             // widest B run (the wrapper checks)
constexpr int kPadCtas = 64;                // CTAs writing the +inf tails
constexpr int kLook = 4;                    // status words a lane a trip
constexpr unsigned kFull = 0xffffffffu;
// status word: kept count (31 bits) | m max (11) | inclusive (1) | epoch
constexpr int kMShift = 31, kFlagShift = 42, kEpochShift = 43;
static_assert(kMaxLanes < (1 << (kFlagShift - kMShift)), "m field too small");

// Built with -DSORTED_MERGE_TRACE (tools/kmin_merge_ablation.py does),
// thread 0 of the first kTraceCtas CTAs records the global timer at its
// start and end and the SM clock at each phase boundary, for
// sorted_merge_trace to copy out.  Off, the hooks compile to nothing.
#ifdef SORTED_MERGE_TRACE
constexpr int kTraceCtas = 1024;
__device__ long long g_trace[kTraceCtas][8];
__device__ __forceinline__ void trace(int i, bool global_timer = false) {
  if (threadIdx.x == 0 && blockIdx.x < kTraceCtas) {
    long long v;
    if (global_timer) {
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
    } else {
      v = clock64();
    }
    if (i == 0) {
      for (int j = 1; j < 8; ++j) g_trace[blockIdx.x][j] = 0;
    }
    g_trace[blockIdx.x][i] = v;
  }
}
#else
__device__ __forceinline__ void trace(int, bool = false) {}
#endif

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
  unsigned* ticket;              // word 0 of the scratch
  unsigned long long* status;    // (K * T) status words
  unsigned long long epoch;
};

__device__ __forceinline__ unsigned long long word(unsigned long long epoch,
                                                   bool incl, int cnt,
                                                   int m) {
  return (epoch << kEpochShift) |
         (static_cast<unsigned long long>(incl) << kFlagShift) |
         (static_cast<unsigned long long>(m) << kMShift) |
         static_cast<unsigned>(cnt);
}

__device__ __forceinline__ int word_cnt(unsigned long long w) {
  return static_cast<int>(w & 0x7fffffffull);
}

__device__ __forceinline__ int word_m(unsigned long long w) {
  return static_cast<int>((w >> kMShift) & 0x7ffull);
}

__device__ __forceinline__ bool word_incl(unsigned long long w) {
  return (w >> kFlagShift) & 1ull;
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// A status word carries all its reader needs, so it is stored without a
// fence (one would also wait for the tile's outstanding loads).
__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ int lower_count(const float* s, int n, float x) {
  // #{j < n : s[j] < x} for an ascending s
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ int valid_b(const Args& a, int k) {
  const int bc = a.bcount[k];
  return bc < 0 ? 0 : (bc > a.C ? a.C : bc);
}

// One warp's look-back over the shard's status words st[t - 1], st[t - 2],
// ... of this call, kLook*32 a round trip, to the nearest inclusive word
// (the words before it must all be ready): the kept count before tile t
// (the sum of the counts to it) and the largest m before it.  Tiles before
// the first read as an inclusive (0, 0).
__device__ void look_back(const unsigned long long* st, int t,
                          unsigned long long epoch, long long* pc,
                          int* pm) {
  const int lane = threadIdx.x & 31;
  long long c_all = 0;
  int m_all = 0;
  for (int j = t - 1;; j -= kLook * 32) {
    while (true) {
      unsigned long long w[kLook];
#pragma unroll
      for (int q = 0; q < kLook; ++q) {
        const int p = j - kLook * lane - q;
        w[q] = p >= 0 ? load_acquire(st + p) : word(epoch, true, 0, 0);
      }
      int first = kLook;  // this lane's nearest inclusive word
      bool ready = true;  // every word before it (and it) ready
#pragma unroll
      for (int q = 0; q < kLook; ++q) {
        const bool rq = (w[q] >> kEpochShift) == epoch;
        if (first == kLook) {
          ready = ready && rq;
          if (rq && word_incl(w[q])) first = q;
        }
      }
      const unsigned incl = __ballot_sync(kFull, first < kLook);
      const int near = incl ? __ffs(incl) - 1 : 32;  // its lane
      if (__any_sync(kFull, lane <= near && !ready)) {
        __nanosleep(32);
        continue;
      }
      long long c = 0;
      int mm = 0;
#pragma unroll
      for (int q = 0; q < kLook; ++q) {
        if (lane < near || (lane == near && q <= first)) {
          c += word_cnt(w[q]);
          mm = max(mm, word_m(w[q]));
        }
      }
      for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(kFull, c, o);
      c_all += c;
      m_all = max(m_all, static_cast<int>(__reduce_max_sync(kFull, mm)));
      if (incl) {
        *pc = c_all;
        *pm = m_all;
        return;
      }
      break;
    }
  }
}

// A pad CTA: for each shard, wait for its last tile's inclusive word, then
// write (+inf, +inf) over [kept + b_count, N), CTA h of H taking every H-th
// run of kThreads slots.
__device__ void pad_tails(const Args& a, int h, int H) {
  __shared__ long long s_len;
  const float inf = __int_as_float(0x7f800000);
  for (int k = 0; k < a.K; ++k) {
    if (threadIdx.x == 0) {
      const unsigned long long* p =
          a.status + static_cast<long long>(k) * a.T + (a.T - 1);
      unsigned long long w = load_acquire(p);
      while ((w >> kEpochShift) != a.epoch || !word_incl(w)) {
        __nanosleep(64);
        w = load_acquire(p);
      }
      s_len = static_cast<long long>(word_cnt(w)) + valid_b(a, k);
    }
    __syncthreads();
    const long long len = s_len;
    __syncthreads();  // s_len is read before the next shard's write
    float* ok = a.ok + k * a.sok;
    float* ov = a.ov + k * a.sov;
    for (long long p = len + static_cast<long long>(h) * kThreads +
                       threadIdx.x;
         p < a.N; p += static_cast<long long>(H) * kThreads) {
      ok[p] = inf;
      ov[p] = inf;
    }
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
sorted_merge_kernel(Args a) {
  __shared__ float sB[kMaxLanes];
  __shared__ float sA[kTile];           // the tile's kept keys, in order
  __shared__ int sCnt[kItems * kWarps];  // kept count of (row, warp)
  __shared__ int sMax[kWarps];
  __shared__ int s_ticket, s_mprev;
  __shared__ long long s_prefix;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  trace(0, true);
  trace(1);
  if (tid == 0) {
    const unsigned t = atomicAdd(a.ticket, 1u);
    if (t == gridDim.x - 1) atomicExch(a.ticket, 0u);  // the next call's 0
    s_ticket = static_cast<int>(t);
  }
  __syncthreads();
  const int tiles = a.K * a.T;
  trace(2);
  if (s_ticket >= tiles) {
    pad_tails(a, s_ticket - tiles, gridDim.x - tiles);
    trace(6);
    trace(7, true);
    return;
  }
  const int k = s_ticket / a.T;
  const int t = s_ticket % a.T;
  const long long base = static_cast<long long>(t) * kTile;
  const int bc = valid_b(a, k);
  for (int j = tid; j < bc; j += kThreads) sB[j] = a.bk[k * a.sbk + j];

  // the loads, all at once: keep with the keys, then the kept values
  const unsigned char* keep = a.keep + k * a.skeep;
  const float* ak = a.ak + k * a.sak;
  const float* av = a.av + k * a.sav;
  bool kept[kItems];
  float key[kItems], val[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + j * kThreads + tid;
    kept[j] = i < a.N && keep[i] != 0;
    key[j] = i < a.N ? ak[i] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + j * kThreads + tid;
    val[j] = kept[j] ? av[i] : 0.0f;
  }

  __syncthreads();  // sB staged
  trace(3);

  // m_i, and ex_i as the rank within the (row, warp) until the scan.  A
  // thread's kept keys rise with j and m with them, so each m starts from
  // the last: one compare, and a search only past a B key
  const unsigned below = (1u << lane) - 1u;
  int m[kItems], ex[kItems];
  int mmax = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (kept[j] && mmax < bc && sB[mmax] < key[j]) {
      mmax = lower_count(sB + mmax + 1, bc - mmax - 1, key[j]) + mmax + 1;
    }
    m[j] = mmax;
    const unsigned ball = __ballot_sync(kFull, kept[j]);
    ex[j] = __popc(ball & below);
    if (lane == 0) sCnt[j * kWarps + warp] = __popc(ball);
  }
  mmax = __reduce_max_sync(kFull, mmax);
  if (lane == 0) sMax[warp] = mmax;
  __syncthreads();
  trace(4);

  // slot order is (row j, warp, lane): add each (row, warp)'s prefix
  int total = 0;
#pragma unroll
  for (int e = 0; e < kItems * kWarps; ++e) {
    if (e % kWarps == warp) ex[e / kWarps] += total;
    total += sCnt[e];
  }
  int tile_m = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) tile_m = max(tile_m, sMax[w]);

  // publish the aggregate, look back for the exclusive prefix, publish the
  // inclusive prefix
  if (warp == 0) {
    unsigned long long* st = a.status + static_cast<long long>(k) * a.T;
    long long pc = 0;
    int pm = 0;
    if (t == 0) {
      if (lane == 0) publish(st, word(a.epoch, true, total, tile_m));
    } else {
      if (lane == 0) publish(st + t, word(a.epoch, false, total, tile_m));
      look_back(st, t, a.epoch, &pc, &pm);
      if (lane == 0) {
        publish(st + t, word(a.epoch, true, static_cast<int>(pc) + total,
                             max(pm, tile_m)));
      }
    }
    if (lane == 0) {
      s_prefix = pc;
      s_mprev = pm;
    }
  }
  __syncthreads();
  trace(5);
  const long long P = s_prefix;
  const int mprev = s_mprev;
  const int mincl = max(mprev, tile_m);

  // kept A at P + ex + m; the kept keys compacted for the B placement
  float* ok = a.ok + k * a.sok;
  float* ov = a.ov + k * a.sov;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (kept[j]) {
      const long long p = P + ex[j] + m[j];
      if (p < a.N) {
        ok[p] = key[j];
        ov[p] = val[j];
      }
      sA[ex[j]] = key[j];
    }
  }
  __syncthreads();

  // B_j whose successor is in this tile
  for (int j = mprev + tid; j < mincl; j += kThreads) {
    const float b = sB[j];
    const long long p = P + j + lower_count(sA, total, b);
    if (p < a.N) {
      ok[p] = b;
      ov[p] = a.bv[k * a.sbv + j];
    }
  }
  if (t == a.T - 1) {  // B_j above every kept A
    const long long kept_all = P + total;
    for (int j = mincl + tid; j < bc; j += kThreads) {
      const long long p = kept_all + j;
      if (p < a.N) {
        ok[p] = sB[j];
        ov[p] = a.bv[k * a.sbv + j];
      }
    }
  }
  trace(6);
  trace(7, true);
}

}  // namespace

#ifdef SORTED_MERGE_TRACE
// Copy the trace of the last launch (kTraceCtas x 8 int64) to dst.
extern "C" int sorted_merge_trace(void* dst) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace)));
}
#endif

extern "C" int sorted_merge_max_lanes() { return kMaxLanes; }

extern "C" int sorted_merge_tile() { return kTile; }

// The scratch a (K, N) call needs, in 64-bit words: the ticket counter,
// then one status word a tile.  Zero it once when it is made; calls on it
// must come in stream order, each with a larger epoch (1 .. 2^21 - 1).
extern "C" int sorted_merge_scratch_words(int K, int N) {
  return 1 + K * ((N + kTile - 1) / kTile);
}

// Strides are in elements; every row's last stride is 1.
extern "C" int sorted_merge_launch(int K, int N, int C, const void* ak,
                                   long long sak, const void* av,
                                   long long sav, const void* keep,
                                   long long skeep, const void* bk,
                                   long long sbk, const void* bv,
                                   long long sbv, const void* bcount,
                                   void* okeys, long long sok, void* ovals,
                                   long long sov, void* scratch,
                                   long long epoch, void* stream) {
  if (C > kMaxLanes || C < 0 || K < 1 || N < 1 || epoch < 1 ||
      epoch >= (1ll << (64 - kEpochShift))) {
    return static_cast<int>(cudaErrorInvalidValue);
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
  const long long tiles = static_cast<long long>(K) * a.T;
  a.ticket = static_cast<unsigned*>(scratch);
  a.status = static_cast<unsigned long long*>(scratch) + 1;
  a.epoch = static_cast<unsigned long long>(epoch);
  const long long grid = tiles + (tiles < kPadCtas ? tiles : kPadCtas);
  if (grid > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  sorted_merge_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
