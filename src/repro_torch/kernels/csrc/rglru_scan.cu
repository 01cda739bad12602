// RG-LRU diagonal recurrence: h_t = a_t * h_{t-1} + b_t per channel (the
// RecurrentGemma mixer's scan).
//
// Replaces the TPU kernel src/repro/kernels/linear_scan/kernel.py,
// rglru_scan_bsr (body _rglru_kernel).  Per (batch b, channel c), with h
// starting at h0[b, c]: h = a[b, t, c] * h + b[b, t, c] for t = 0 .. S - 1,
// every h written to hs[b, t, c] and the last to hT[b, c], in float32.
//
// Exactness: the step is written __fadd_rn(__fmul_rn(a, h), b), a rounded
// product then a rounded sum, so nvcc cannot contract it into an FMA
// (-fmad=true is its default).  The plain version (a loop of a * h, then
// + b, two PyTorch ops) rounds the same way, and the two are bit-equal.
//
// The TPU kernel keeps h in VMEM scratch across a sequential chunk axis and
// walks each chunk with an in-register loop.  CUDA blocks run in no order,
// so here the whole sweep over t is one thread's loop, h in a register:
// one thread per (b, c), one warp a CTA (so the CTAs spread over as many
// SMs as there are warps), lanes on neighbouring channels, so each load
// and store of a step is one 128-byte line a warp.  The loads do not depend
// on h: a block of kUnroll steps of a and b is loaded while the previous
// block is computed and stored.
//
// What bounds it on an H100: bytes in the limit, latency here.  At the
// scoring shape (B 1, S 8,192, R 2,560) the function moves a, b and h in
// f32, 3 x 83.9 MB, 0.075 ms at 3.35 TB/s, and does 2 FLOP an element.
// With one thread a channel there are only B * R = 2,560 threads, 80 warps
// on 80 SMs, each with 2 * kUnroll loads in flight: far fewer bytes in
// flight than the memory's latency-bandwidth product, so the kernel is
// bound by load latency, not bandwidth.  A chunk-parallel scan over t
// (more threads, a carry pass) is the later, faster kernel's work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;  // channels a CTA: one warp
constexpr int kUnroll = 32;   // steps of a and b loaded ahead

__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ h0, float* __restrict__ hs,
                      float* __restrict__ hT, int S, int R, long long ab,
                      long long as, long long bb, long long bs) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int bi = blockIdx.y;
  if (c >= R) return;
  const float* ap = a + bi * ab + c;
  const float* bp = b + bi * bb + c;
  float* hp = hs + static_cast<long long>(bi) * S * R + c;
  float h = h0[static_cast<long long>(bi) * R + c];

  float ca[kUnroll], cb[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const bool ok = u < S;
    ca[u] = ok ? ap[u * as] : 1.f;
    cb[u] = ok ? bp[u * bs] : 0.f;
  }
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    float na[kUnroll], nb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long t = static_cast<long long>(t0) + kUnroll + u;
      const bool ok = t < S;
      na[u] = ok ? ap[t * as] : 1.f;
      nb[u] = ok ? bp[t * bs] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < S) {
        h = __fadd_rn(__fmul_rn(ca[u], h), cb[u]);
        hp[static_cast<long long>(t0 + u) * R] = h;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
  }
  hT[static_cast<long long>(bi) * R + c] = h;
}

}  // namespace

// a, b: (B, S, R) float32 with batch and sequence strides ab, as, bb, bs in
// elements (last dim contiguous); h0 and hT (B, R) and hs (B, S, R) float32
// contiguous.  Launches on ``stream``, never synchronises; returns
// cudaGetLastError().
extern "C" int rglru_scan_launch(const float* a, const float* b,
                                 const float* h0, float* hs, float* hT, int B,
                                 int S, int R, long long ab, long long as,
                                 long long bb, long long bs, void* stream) {
  if (B <= 0 || R <= 0) return 0;
  if (S < 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((R + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, h0, hs, hT, S, R, ab, as, bb, bs);
  return static_cast<int>(cudaGetLastError());
}
