// Connected-component labels (the dynamic graph's full rebuild and
// contracted merge, DESIGN.md §11; the batched union-find's relabel,
// DESIGN.md §16): three bodies behind one entry point, one launch a call.
//
// Replaces the TPU kernel src/repro/kernels/label_prop/kernel.py,
// label_step_sharded_vmem (body _label_step_kernel), together with the
// while_loop of ops.py::_fixpoint that iterates it.  The reference computes
// the component-min labelling as the fixpoint of a propagation step from
// the identity; the step body keeps that step, and the two fixpoint bodies
// reach the same fixpoint another way, bit for bit (it is unique: every
// vertex's label is the least vertex of its component).
//
// Body 1, step (label_prop_step_kernel): `init` given or max_iters below
// "to the fixpoint".  One iteration is exactly the reference's step: with l
// the labels and s a copy of them,
//     for every edge (u, v):  m = min(l[u], l[v]);
//                             atomicMin(&s[u], m); atomicMin(&s[v], m)
//     then                    l'[x] = min(s[x], l[s[x]])
// -- the jump reads the OLD labels, so l, s and l' are separate buffers.
// min is order-independent, so the result equals the plain PyTorch version
// element for element whatever order the atomics land in.  It stops after
// the first step that changes nothing, or after max_iters steps, and
// writes the steps run to ctrl[0].  Each step is a hook, two grid barriers
// and an n-wide jump (0.039 ms at n = 10^6 on an NVIDIA H100 80GB HBM3 at
// 700 W, chip_smoke.py), and a fixpoint takes as many steps as
// propagation needs to converge (18-31 on chip_smoke.py's graphs).
//
// Body 2, fixpoint (label_prop_fixpoint_kernel): no `init`, max_iters "to
// the fixpoint", not the small relabel form.  A concurrent union-find with
// link-by-min hooking, as ECL-CC does it (Jaiganesh and Burtscher, HPDC
// 2018): parent[x] = x; grid barrier; every live edge links the roots of
// its endpoints, the larger root under the smaller by atomicCAS from
// itself, and retries from the new roots when the CAS fails; grid barrier;
// io[x] = root(x).  parent[x] <= x holds throughout (a link hangs a root
// under a smaller one, path halving sets parent[x] to its grandparent), so
// the forest stays acyclic and every root is its tree's least vertex: the
// result is the component-min labelling, the same whatever order the
// atomics land in.  Roots are read with volatile loads: a root cached in
// L1 across another SM's link would be a wrong label after the barrier.
// The relabel form hooks the mapped endpoints io[u], io[v] over [0, n) and
// writes io[x] = root(io[x]).  ctrl[0] = 1 when it ran.
//
// Body 3, merge (label_prop_merge_kernel): the relabel form with at most
// kSmallE edge slots (the graph's pending inserts, 2 c_max + 1 slots; the
// union-find's <= c_max unions).  Only labels that are endpoint labels can
// change, so: every block gathers the live slots' endpoint labels io[u],
// io[v] (at most 2 kSmallE), sorts them in shared memory (a label's
// position is the count of labels below it, equal ones by slot order: four
// lanes a label count a stride each), runs the body 2 union-find over the
// positions (each slot's two labels, and equal neighbours), so a root
// holds its contracted component's least label, and sets a bit filter of
// the labels that change; then one n-wide pass rewrites io[x] only where
// the filter and a binary search find io[x] with another root.  The
// filter is wide (16,384 bits) so that a warp rarely diverges into a
// search for a false hit.
// io is both where the endpoint labels are read and the output, so no
// block may rewrite its stripe before every block has read them (a block
// that read p(a) where a stood would miss a, and keep a in its stripe):
// the launch is cooperative and one grid barrier stands between the reads
// and the writes.  When no label changes, every block builds the same
// table and returns before the barrier.  Each thread loads its first
// kMergeVec vectors of io after the gather and before the barrier, so the
// n-wide read overlaps the table and the barrier; loaded before the
// gather, they held it up.  Both pay: at the graph's 33 slots a call
// takes 0.008603 ms as built, 0.009738 with those vectors loaded after the
// barrier, 0.011634 with no filter (every label searched), 0.013023 with
// neither (tools/label_prop_merge_ablation.py, NVIDIA H100 80GB HBM3 at
// 700 W).  The barrier is the faster staging on that card: a one-block
// launch that writes the table to global scratch, then an n-wide launch on
// the same stream, took 0.010991 ms a call at the graph's 33 slots against
// the barrier's 0.008525 (chip_smoke.py, PERF.md), and no barrier with the
// last block to count in writing the endpoint positions was slower too.
//
// All bodies: a slot with valid[e] == 0, or e >= *e_live, is the (0, 0)
// self-loop, a no-op (the reference's padding and invalid-slot rule); the
// launch does nothing unless *when != 0 (when given) and *unless == 0 (when
// given) -- the read pass's full / merge / identity choice is made on the
// device from the graph's dirty_full flag, so the host never reads it; a
// gated-off launch and a relabel launch with no live slot write 0 to
// ctrl[0] and leave io as it is.  Nothing is read on the host.
//
// What bounds it on an H100: bytes, in principle.  The fixpoint reads eu,
// ev and valid once (9 bytes a slot) and writes the labels once (4n): 13
// MB at n = 10^6 and 10^6 slots, 3.9 us at 3.35 TB/s.  In practice the
// hooks are bound by chains of dependent L2 reads and atomics on the
// parent array (4n, resident in the 50 MB L2), the flatten by the same
// reads, and both grid barriers span 1,056 blocks.  The merge reads io
// once (4n, 1.2 us at 3.35 TB/s) and writes the changed labels; its fixed
// costs -- the gates and the endpoint slots, then the gather of their
// labels, the table, the barrier -- are a chain of latencies.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;        // the step and fixpoint bodies
constexpr int kSmallE = 64;          // most edge slots the merge body takes
constexpr int kSlots = 2 * kSmallE;  // its endpoint labels
constexpr int kMergeThreads = 512;
constexpr int kGroup = kMergeThreads / kSlots;  // threads a label sorts with
constexpr int kMergeVec = 4;         // io vectors a merge thread loads
                                     // before its grid barrier
constexpr int kFilterBits = 14;      // the merge's filter: 16,384 bits, so
                                     // that a warp rarely has a false hit
constexpr int kFilterWords = (1 << kFilterBits) / 32;
static_assert(kGroup == 4, "the sort's lane groups are 4 lanes of a warp");

enum Body { kStep = 0, kFixpoint = 1, kMerge = 2 };

struct Args {
  int n;
  const int* __restrict__ eu;
  const int* __restrict__ ev;
  int E;
  const unsigned char* __restrict__ valid;  // null: every slot is live
  const int* __restrict__ e_live;           // null: all E slots
  const int* __restrict__ init;             // null: the identity
  int relabel;
  const unsigned char* __restrict__ when;   // null: no gate
  const unsigned char* __restrict__ unless; // null: no gate
  int* io;         // (n,) labels out; the relabel map in that form
  int* scratch;    // step: (3n,) l, l' and s; fixpoint: (n,) parent
  int* ctrl;       // (4,): [0] the return value, [1..3] the step's flags
  int max_iters;
};

__device__ __forceinline__ bool gated_off(const Args& a) {
  return (a.when != nullptr && *a.when == 0) ||
         (a.unless != nullptr && *a.unless != 0);
}

__device__ __forceinline__ int live_slots(const Args& a) {
  return a.e_live != nullptr ? min(a.E, max(*a.e_live, 0)) : a.E;
}

// the endpoints of slot e; a masked slot is the (0, 0) no-op
__device__ __forceinline__ void endpoints(const Args& a, int e, int& u,
                                          int& v) {
  u = 0;
  v = 0;
  if (a.valid == nullptr || a.valid[e]) {
    u = a.eu[e];
    v = a.ev[e];
  }
}

// ---------------------------------------------------------------------------
// Body 1: the propagation step, iterated
// ---------------------------------------------------------------------------
__global__ void label_prop_step_kernel(Args a) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid == 0) a.ctrl[0] = 0;
  if (gated_off(a)) return;
  const int E = live_slots(a);
  // the contracted graph of no edge relabels nothing: identity
  if (a.relabel && E == 0) return;

  cg::grid_group grid = cg::this_grid();
  const int n = a.n;
  const int stride = gridDim.x * blockDim.x;
  int* l = a.scratch;          // the labels of this iteration (OLD)
  int* l2 = a.scratch + n;     // the next labels
  int* s = a.scratch + 2 * n;  // the hooked labels, s = l before the hook
  int* flags = a.ctrl + 1;

  for (int x = tid; x < n; x += stride) {
    const int v = a.init != nullptr ? a.init[x] : x;
    l[x] = v;
    s[x] = v;
  }
  if (tid == 0) flags[0] = 0;
  grid.sync();

  int it = 0;
  while (it < a.max_iters) {
    // hook: scatter-min of min(l[u], l[v]) into s
    if (tid == 0) flags[(it + 1) % 3] = 0;  // the next iteration's flag
    for (int e = tid; e < E; e += stride) {
      int u, v;
      endpoints(a, e, u, v);
      if (a.relabel) {
        u = a.io[u];
        v = a.io[v];
      }
      const int lu = l[u], lv = l[v];
      const int m = min(lu, lv);
      if (m < lu) atomicMin(&s[u], m);
      if (m < lv) atomicMin(&s[v], m);
    }
    grid.sync();
    // jump through the OLD labels; s becomes the next iteration's copy
    bool changed = false;
    for (int x = tid; x < n; x += stride) {
      const int sx = s[x];
      const int nx = min(sx, l[sx]);
      l2[x] = nx;
      s[x] = nx;
      changed |= nx != l[x];
    }
    if (__syncthreads_or(changed) && threadIdx.x == 0) {
      atomicOr(&flags[it % 3], 1);
    }
    grid.sync();
    int* t = l;
    l = l2;
    l2 = t;
    const bool more = *(volatile int*)&flags[it % 3] != 0;
    ++it;
    if (!more) break;
  }

  if (tid == 0) a.ctrl[0] = it;
  for (int x = tid; x < n; x += stride) {
    a.io[x] = a.relabel ? l[a.io[x]] : l[x];
  }
}

// ---------------------------------------------------------------------------
// The concurrent union-find of bodies 2 and 3 (global or shared memory)
// ---------------------------------------------------------------------------
// The root of x, halving the path on the way: parent[x] becomes its
// grandparent, an ancestor of x no larger than parent[x].  Only a non-root
// is written here, and a non-root never becomes a root again, so this
// store never races with a link; two halvings of one x may land in either
// order, and each leaves an ancestor.
__device__ __forceinline__ int find_root(volatile int* parent, int x) {
  int p = parent[x];
  while (p != x) {
    const int g = parent[p];
    if (g == p) return p;
    parent[x] = g;
    x = g;
    p = parent[x];
  }
  return x;
}

// Join the trees of u and v: the larger root goes under the smaller, by a
// CAS that expects it still to be a root.  A failed CAS means another
// thread hung that root first; retry from the roots as they are now.
__device__ __forceinline__ void link(volatile int* parent, int u, int v) {
  int ru = find_root(parent, u), rv = find_root(parent, v);
  while (ru != rv) {
    const int lo = min(ru, rv), hi = max(ru, rv);
    const int old = atomicCAS(const_cast<int*>(parent + hi), hi, lo);
    if (old == hi) return;
    ru = find_root(parent, lo);
    rv = find_root(parent, old);
  }
}

// ---------------------------------------------------------------------------
// Body 2: the fixpoint as a concurrent union-find
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) label_prop_fixpoint_kernel(Args a) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int E = live_slots(a);
  const bool ran = !gated_off(a) && !(a.relabel && E == 0);
  if (tid == 0) a.ctrl[0] = ran;
  if (!ran) return;

  cg::grid_group grid = cg::this_grid();
  const int n = a.n;
  const int stride = gridDim.x * blockDim.x;
  volatile int* parent = a.scratch;
  for (int x = tid; x < n; x += stride) a.scratch[x] = x;
  grid.sync();
  for (int e = tid; e < E; e += stride) {
    int u, v;
    endpoints(a, e, u, v);
    if (a.relabel) {
      u = a.io[u];
      v = a.io[v];
    }
    if (u != v) link(parent, u, v);
  }
  grid.sync();
  for (int x = tid; x < n; x += stride) {
    a.io[x] = find_root(parent, a.relabel ? a.io[x] : x);
  }
}

// ---------------------------------------------------------------------------
// Body 3: the small contracted merge
// ---------------------------------------------------------------------------
struct Table {
  int lab[kSlots];      // the live slots' endpoint labels, in slot order
  int pos[kSlots];      // lab[i]'s position in sorted
  int sorted[kSlots];   // the labels ascending, equal ones by slot order
  int parent[kSlots];   // the union-find over the positions
  int root[kSlots];     // by position: the least label of its component
  unsigned filter[kFilterWords];  // bit hash(l) set where l changes
  int m;                // labels in the table
};

__device__ __forceinline__ unsigned filter_hash(int l) {
  return (static_cast<unsigned>(l) * 0x9E3779B1u) >> (32 - kFilterBits);
}

// The vertex whose label is endpoint label i (slot i / 2, side i % 2) of
// the first E <= kSmallE slots; read before the gates so that these loads
// are in flight with them.
__device__ __forceinline__ int endpoint_vertex(const Args& a, int i) {
  int u = 0, v = 0;
  if (i < 2 * a.E) endpoints(a, i >> 1, u, v);
  return (i & 1) ? v : u;
}

// Gather the endpoint labels of the first E (1 <= E <= kSmallE) live
// slots, thread i holding the vertex x of endpoint label i; every thread
// of the block calls it, and then build_table.
__device__ __forceinline__ void gather_labels(const Args& a, Table& t, int E,
                                              int x) {
  const int i = threadIdx.x;
  if (i < 2 * E) t.lab[i] = a.io[x];
  for (int w = i; w < kFilterWords; w += blockDim.x) t.filter[w] = 0;
  __syncthreads();
}

// Build the table from the gathered labels.  Returns whether any label
// changes.
__device__ bool build_table(Table& t, int E) {
  const int i = threadIdx.x;
  const int m = 2 * E;
  // sort: label li's position is the count of labels below it, equal ones
  // counted by slot order, so positions are a permutation; the kGroup
  // lanes li * kGroup + g count a stride each and add up by shuffles
  const int li = i / kGroup, g = i % kGroup;
  const int l = li < m ? t.lab[li] : 0;
  int below = 0;
  if (li < m) {
    for (int j = g; j < m; j += kGroup) {
      const int lj = t.lab[j];
      below += lj < l || (lj == l && j < li);
    }
  }
  below += __shfl_xor_sync(0xffffffffu, below, 1);
  below += __shfl_xor_sync(0xffffffffu, below, 2);
  if (li < m && g == 0) {
    t.pos[li] = below;
    t.sorted[below] = l;
    t.parent[below] = below;
  }
  __syncthreads();
  // positions order like labels, so link-by-min on positions is
  // link-by-min on labels and a root holds its component's least label;
  // equal labels sit side by side and are linked too
  if (i < E) link(t.parent, t.pos[2 * i], t.pos[2 * i + 1]);
  if (i > 0 && i < m && t.sorted[i] == t.sorted[i - 1]) {
    link(t.parent, i - 1, i);
  }
  __syncthreads();
  bool changed = false;
  if (i < m) {
    int r = i;
    while (t.parent[r] != r) r = t.parent[r];
    t.root[i] = t.sorted[r];
    changed = t.root[i] != t.sorted[i];
    if (changed) {
      const unsigned h = filter_hash(t.sorted[i]);
      atomicOr(&t.filter[h >> 5], 1u << (h & 31));
    }
  }
  if (i == 0) t.m = m;
  return __syncthreads_or(changed);
}

__device__ __forceinline__ int new_label(const Table& t, int x) {
  const unsigned h = filter_hash(x);
  if (!((t.filter[h >> 5] >> (h & 31)) & 1u)) return x;
  int lo = 0, hi = t.m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t.sorted[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo < t.m && t.sorted[lo] == x ? t.root[lo] : x;
}

__device__ __forceinline__ void rewrite4(const Table& t, int4* io4, int k,
                                         int4 q) {
  const int4 r = make_int4(new_label(t, q.x), new_label(t, q.y),
                           new_label(t, q.z), new_label(t, q.w));
  if (r.x != q.x || r.y != q.y || r.z != q.z || r.w != q.w) io4[k] = r;
}

__device__ __forceinline__ void rewrite1(const Table& t, int* io, int x) {
  const int l = io[x], y = new_label(t, l);
  if (y != l) io[x] = y;
}

// The first index of io on a 16-byte boundary (io is 4-byte aligned).
__device__ __forceinline__ int io_head(const Args& a) {
  return min(a.n, static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(a.io) & 15)) & 15) / 4));
}

__global__ void __launch_bounds__(kMergeThreads)
label_prop_merge_kernel(Args a) {
  __shared__ Table t;
  const int x = endpoint_vertex(a, threadIdx.x);
  const int E = live_slots(a);
  const bool ran = !gated_off(a) && E > 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) a.ctrl[0] = ran;
  if (!ran) return;
  gather_labels(a, t, E, x);
  // this thread's first kMergeVec vectors of io, loaded before the barrier
  // (nothing writes io before it), so that the n-wide read overlaps the
  // table and the barrier; after the gather, which must not queue behind
  // them
  const int head = io_head(a);
  const int n4 = (a.n - head) / 4;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  int4* io4 = reinterpret_cast<int4*>(a.io + head);
  int4 pre[kMergeVec];
#pragma unroll
  for (int j = 0; j < kMergeVec; ++j) {
    const int k = tid + j * stride;
    pre[j] = k < n4 ? io4[k] : make_int4(0, 0, 0, 0);
  }
  // every block reads the same labels (none is written before the
  // barrier), so every block agrees on whether any changes
  if (!build_table(t, E)) return;
  cg::this_grid().sync();  // every block has read its endpoint labels
#pragma unroll
  for (int j = 0; j < kMergeVec; ++j) {
    const int k = tid + j * stride;
    if (k < n4) rewrite4(t, io4, k, pre[j]);
  }
  // the rest of this thread's vectors, then its share of the scalar head
  // and tail
  for (int k = tid + kMergeVec * stride; k < n4; k += stride) {
    rewrite4(t, io4, k, io4[k]);
  }
  for (int y = tid; y < head; y += stride) rewrite1(t, a.io, y);
  for (int y = head + 4 * n4 + tid; y < a.n; y += stride) {
    rewrite1(t, a.io, y);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------
int g_sms = 0;  // the card's SMs (0: not read yet)

// resident blocks of `kernel` on the whole card, or -1 without cooperative
// launches; computed once per kernel (a benign race: every thread computes
// the same value)
int resident_blocks(const void* kernel, int threads, int* cache) {
  if (*cache > 0) return *cache;
  int dev = 0, coop = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return -1;
  if (g_sms == 0) {
    cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
  }
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  *cache = g_sms * per_sm;
  return *cache;
}

int g_resident[3] = {0, 0, 0};

int cooperative(const void* kernel, int body, int threads, int blocks,
                Args& a, cudaStream_t stream) {
  const int max_blocks = resident_blocks(kernel, threads, &g_resident[body]);
  if (max_blocks <= 0) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? static_cast<int>(err)
                              : static_cast<int>(cudaErrorNotSupported);
  }
  if (blocks < 1) blocks = 1;
  if (blocks > max_blocks) blocks = max_blocks;
  void* params[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3(blocks), dim3(threads), params, 0, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it; the wrapper raises with the code
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// int32 words of scratch a body needs at n vertices.
extern "C" int label_prop_scratch_words(int body, int n) {
  switch (body) {
    case kStep: return 3 * n;
    case kFixpoint: return n;
    default: return 0;
  }
}

extern "C" int label_prop_launch(int body, int n, const void* eu,
                                 const void* ev, int E, const void* valid,
                                 const void* e_live, const void* init,
                                 int relabel, const void* when,
                                 const void* unless, void* io, void* scratch,
                                 void* ctrl, int max_iters, void* stream) {
  Args a;
  a.n = n;
  a.eu = static_cast<const int*>(eu);
  a.ev = static_cast<const int*>(ev);
  a.E = E;
  a.valid = static_cast<const unsigned char*>(valid);
  a.e_live = static_cast<const int*>(e_live);
  a.init = static_cast<const int*>(init);
  a.relabel = relabel;
  a.when = static_cast<const unsigned char*>(when);
  a.unless = static_cast<const unsigned char*>(unless);
  a.io = static_cast<int*>(io);
  a.scratch = static_cast<int*>(scratch);
  a.ctrl = static_cast<int*>(ctrl);
  a.max_iters = max_iters;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int work = n > E ? n : E;
  const int wide = (work + kThreads - 1) / kThreads;
  const int merge_blocks = (n + kMergeThreads * 4 * kMergeVec - 1) /
                           (kMergeThreads * 4 * kMergeVec);
  switch (body) {
    case kStep:
      return cooperative(reinterpret_cast<const void*>(label_prop_step_kernel),
                         body, kThreads, wide, a, s);
    case kFixpoint:
      if (init != nullptr) return static_cast<int>(cudaErrorInvalidValue);
      return cooperative(
          reinterpret_cast<const void*>(label_prop_fixpoint_kernel), body,
          kThreads, wide, a, s);
    case kMerge:
      if (!relabel || init != nullptr || E > kSmallE) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      return cooperative(
          reinterpret_cast<const void*>(label_prop_merge_kernel), body,
          kMergeThreads, merge_blocks, a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
