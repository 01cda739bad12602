// The backward of the RG-LRU diagonal recurrence h_t = a_t * h_{t-1} + b_t
// (the gradient of rglru_scan.cu's forward).
//
// Replaces no TPU kernel: the reference's Pallas kernel
// src/repro/kernels/linear_scan/kernel.py, rglru_scan_bsr, has no backward
// (its trainer differentiates the model's own associative scan).  The
// port's train-mode forward runs rglru_scan.cu on the card, and no plain
// version may stand in on that path, so the gradient is a kernel too.
// Per (batch b, channel c), with the incoming gradients dhs (B, S, R) and
// dhT (B, R), and hs the forward's output:
//     g = dhT;  for t = S-1 .. 0:  g = g + dhs[t];  db[t] = g;
//                                  da[t] = g * h[t-1];  g = a[t] * g
//     dh0 = g            (h[-1] = h0)
// Each sum and product is one rounded operation (__fadd_rn / __fmul_rn,
// so nvcc cannot contract them into an FMA), in the order of the plain
// version (linear_scan/ops.py, rglru_scan_bwd_plain), and the two are
// bit-equal.
//
// What bounds it on an H100: bytes.  It reads a, dhs and hs and writes da
// and db, 5 x 4 bytes an element: at (B 1, S 8,192, R 2,560) 419 MB,
// 0.125 ms at 3.35 TB/s; 3 FLOP an element are nothing.  The chain is
// three dependent rounded operations a step.
//
// The design, simple first: one warp a CTA owns 32 channels of one batch
// row (each row it reads or writes one 128-byte line), one lane a channel.
// It sweeps t downward kU steps at a time: the next block's a, dhs and
// h_{t-1} are loaded into registers before the current block's chain runs,
// so a block's loads are in flight while the chain works.  Inputs and
// outputs are contiguous f32 (the wrapper casts).
#include <cuda_runtime.h>

namespace {

constexpr int kChannels = 32;  // one lane a channel, one warp a CTA
constexpr int kU = 16;         // steps a register block

struct Block {
  float a[kU], d[kU], h[kU];
};

// steps t1 - u (u = 0 .. kU-1, those >= 0) of this lane's channel; h[u] is
// h_{t-1}, h0 at t = 0
__device__ __forceinline__ void load(Block& blk, const float* a,
                                     const float* dhs, const float* hs,
                                     float h0, int t1, long long R) {
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int t = t1 - u;
    if (t >= 0) {
      blk.a[u] = a[t * R];
      blk.d[u] = dhs[t * R];
      blk.h[u] = t > 0 ? hs[(t - 1) * R] : h0;
    }
  }
}

__global__ void __launch_bounds__(kChannels)
    rglru_scan_bwd_kernel(const float* __restrict__ a,
                          const float* __restrict__ h0,
                          const float* __restrict__ hs,
                          const float* __restrict__ dhs,
                          const float* __restrict__ dhT,
                          float* __restrict__ da, float* __restrict__ db,
                          float* __restrict__ dh0, int S, int R) {
  const int c = blockIdx.x * kChannels + threadIdx.x;
  if (c >= R) return;
  const long long bi = blockIdx.y;
  const long long base = bi * S * static_cast<long long>(R) + c;
  const float* ap = a + base;
  const float* dp = dhs + base;
  const float* hp = hs + base;
  float* dap = da + base;
  float* dbp = db + base;
  const float hinit = h0[bi * R + c];
  float g = dhT[bi * R + c];
  Block cur, next;
  if (S > 0) load(cur, ap, dp, hp, hinit, S - 1, R);
  for (int t1 = S - 1; t1 >= 0; t1 -= kU) {
    if (t1 - kU >= 0) load(next, ap, dp, hp, hinit, t1 - kU, R);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = t1 - u;
      if (t >= 0) {
        g = __fadd_rn(g, cur.d[u]);
        dbp[t * static_cast<long long>(R)] = g;
        dap[t * static_cast<long long>(R)] = __fmul_rn(g, cur.h[u]);
        g = __fmul_rn(cur.a[u], g);
      }
    }
    cur = next;
  }
  dh0[bi * R + c] = g;
}

}  // namespace

// a, hs, dhs, da, db: (B, S, R) float32 contiguous; h0, dhT, dh0: (B, R)
// float32 contiguous.  Launches on ``stream``, never synchronises; returns
// cudaGetLastError().
extern "C" int rglru_scan_bwd_launch(const float* a, const float* h0,
                                     const float* hs, const float* dhs,
                                     const float* dhT, float* da, float* db,
                                     float* dh0, int B, int S, int R,
                                     void* stream) {
  if (B <= 0 || R <= 0) return 0;
  if (S < 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((R + kChannels - 1) / kChannels, B);
  rglru_scan_bwd_kernel<<<grid, kChannels, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      a, h0, hs, dhs, dhT, da, db, dh0, S, R);
  return static_cast<int>(cudaGetLastError());
}
