// Connected-component label propagation to its fixpoint, in ONE launch
// (the dynamic graph's full rebuild and union-find fast path, DESIGN.md
// §11; the batched union-find's contracted fixpoint, DESIGN.md §16).
//
// Replaces the TPU kernel src/repro/kernels/label_prop/kernel.py,
// label_step_sharded_vmem (body _label_step_kernel), together with the
// while_loop of ops.py::_fixpoint that iterates it.  One iteration is
// exactly the reference's step: with l the labels and s a copy of them,
//     for every edge (u, v):  m = min(l[u], l[v]);
//                             atomicMin(&s[u], m); atomicMin(&s[v], m)
//     then                    l'[x] = min(s[x], l[s[x]])
// -- the jump reads the OLD labels, so l, s and l' are separate buffers.
// min is order-independent, so the result equals the plain PyTorch version
// element for element whatever order the atomics land in.  The iteration
// stops after the first step that changes nothing, or after max_iters
// steps (max_iters = 1 is one label_step).
//
// Forms, all one kernel:
//   * plain:     start from init (or the identity when init is null), edges
//                (eu, ev); write the labels to io.
//   * relabel:   the contracted graph of merge_labels: endpoints map through
//                io (the current component labels), the fixpoint starts from
//                the identity, and io[x] becomes p[io[x]].
//   * sanitised edges: a slot with valid[e] == 0, or e >= *e_live, is the
//     (0, 0) self-loop, a no-op (the reference's padding and invalid-slot
//     rule).
//   * gates: the launch does nothing unless *when != 0 (when given) and
//     *unless == 0 (when given) -- the read pass's full / merge / identity
//     choice is made here, on the device, from the graph's dirty_full flag,
//     so the host never reads it.
//
// What bounds it on an H100: bytes.  Per iteration about 32 bytes per edge
// (two endpoints, two label gathers, up to two atomics) and 20 per vertex
// (copy, jump gather, write, compare), i.e. about 36 MB at n = 1,000,000
// and E = 500,000: ~11 us at 3.35 TB/s, and the labels (3 x 4 MB) sit in
// the 50 MB L2.  Every iteration also pays two grid-wide barriers.
// What the design does about it: the TPU kernel's broadcast-compare
// gathers and (block, e_chunk) scatter masks are gone -- direct gathers and
// a native int32 atomicMin, grid-stride over edges and vertices; the K-way
// vertex partition is gone (it never changed the result); and the loop is
// inside the kernel as a cooperative launch (grid.sync() between the hook
// and the jump), so a fixpoint costs one launch and no host round trip.
// The grid is as large as the card can hold resident (occupancy x SMs) and
// no larger than the work needs.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

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
  int* scratch;    // (3n,): l, l' and s
  int* ctrl;       // (4,): [0] iterations run, [1..3] rotating change flags
  int max_iters;
};

__global__ void label_prop_kernel(Args a) {
  if (a.when != nullptr && *a.when == 0) return;
  if (a.unless != nullptr && *a.unless != 0) return;
  int E = a.E;
  if (a.e_live != nullptr) E = min(E, max(*a.e_live, 0));
  // the contracted graph of no edge relabels nothing: identity
  if (a.relabel && E == 0) return;

  cg::grid_group grid = cg::this_grid();
  const int n = a.n;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
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
      int u = 0, v = 0;
      if (a.valid == nullptr || a.valid[e]) {
        u = a.eu[e];
        v = a.ev[e];
      }
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

int g_max_blocks = 0;  // resident blocks on the whole card (0: not known)

int max_cooperative_blocks() {
  if (g_max_blocks > 0) return g_max_blocks;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return -1;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, label_prop_kernel,
                                                kThreads, 0);
  g_max_blocks = sms * per_sm;
  return g_max_blocks;
}

}  // namespace

extern "C" int label_prop_launch(int n, const void* eu, const void* ev, int E,
                                 const void* valid, const void* e_live,
                                 const void* init, int relabel,
                                 const void* when, const void* unless,
                                 void* io, void* scratch, void* ctrl,
                                 int max_iters, void* stream) {
  const int max_blocks = max_cooperative_blocks();
  if (max_blocks <= 0) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? static_cast<int>(err)
                              : static_cast<int>(cudaErrorNotSupported);
  }
  const int work = n > E ? n : E;
  int blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > max_blocks) blocks = max_blocks;
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
  void* params[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(label_prop_kernel), dim3(blocks),
      dim3(kThreads), params, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it; the wrapper raises with the code
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
