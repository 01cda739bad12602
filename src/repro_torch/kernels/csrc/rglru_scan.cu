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
// What bounds it on an H100: bytes.  At the scoring shape (B 1, S 8,192,
// R 2,560) the function reads a and b and writes h in f32, 3 x 83.9 MB,
// 0.075 ms at 3.35 TB/s; its 2 FLOP an element are nothing.  Keeping
// 3.35 TB/s flowing at ~0.6-0.8 us of loaded DRAM latency needs ~2-2.7 MB
// of loads in flight; the ring keeps up to kStages x 16 KB in flight a
// CTA.  The chain itself is one rounded multiply then one rounded add a
// step, ~8 cycles of latency: ~65 K cycles, ~35-40 us, over 8,192 steps,
// about half the byte bound, so the rounding can stay as it is, provided
// the chain's warp does little else.
//
// The design: a CTA owns kChannels = 32 channels of one batch row, so each
// row it reads or writes is one 128-byte line (80 CTAs on 80 SMs at B 1,
// R 2,560; 16 channels, 160 CTAs on 64-byte rows, measured slower:
// tools/rglru_scan_ablation.py), and streams a and b through a ring of
// kStages shared-memory stages of kSteps steps each, in three warps:
// - warp 1, the producer, keeps every free stage in flight: 16-byte
//   cp.async copies (a full tile at fixed pieces a lane, no index
//   arithmetic), each lane's completion signalled on the stage's full
//   mbarrier by cp.async.mbarrier.arrive.noinc;
// - warp 0, the consumer, one lane a channel, waits on the full barrier,
//   reads the stage's a and b into registers kSub steps at a time (they do
//   not depend on h), releases the stage on its empty barrier once the last
//   of them is read, and runs the chain in a register, each h into one of
//   two output stages in shared memory;
// - warp 2, the storer, writes each output stage back to hs as 16-byte
//   stores and releases it to the consumer.
// Every barrier pair carries a phase bit each round of its ring, so a stage
// is refilled only after its release and read only after its fill; the
// chain's warp does nothing but wait, read shared memory and run the chain.
// Measured slower and not built (tools/rglru_scan_ablation.py carries them
// as patches of this file): each h stored from the chain's register, the
// output stage written back by one cp.async.bulk a row, and a and b loaded
// by one cp.async.bulk a row.
//
// Every layout the wrapper passes (any R, (batch, seq) strides with the
// last dim contiguous, any base) runs in the same ring: rows whose base or
// strides are not 16-byte aligned are staged by 4-byte cp.async copies
// (rows_aligned below, mirrored as ops.rglru_rows_aligned), the last
// channel tile copies its nc < kChannels channels (a partial 16-byte copy
// at its end), the last stage its nt < kSteps steps, and hs rows that are
// not 16-byte aligned (R % 4 != 0) are written 4 bytes at a time.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// The tile, mirrored in kernels/linear_scan/ops.py (RGLRU_CHANNELS,
// RGLRU_STEPS, RGLRU_STAGES) for the CPU emulation of the schedule in
// tests/test_torch_rglru_redesign.py, which holds the two equal.
constexpr int kChannels = 32;  // C: channels a CTA, one consumer lane each
constexpr int kSteps = 64;     // T: steps a stage
constexpr int kStages = 6;     // N: stages in the ring
// rows of a and b starting on kAlignBytes take the 16-byte copies
constexpr int kAlignBytes = 16;
// steps of a and b read into registers at once
constexpr int kSub = kSteps < 32 ? kSteps : 32;
// warp 0 consumes, warp 1 produces, warp 2 stores
constexpr int kThreads = 96;

static_assert(kChannels % 4 == 0 && kChannels <= 32, "one lane a channel");
static_assert(kSteps % kSub == 0, "whole register blocks a stage");

constexpr int kStage = kSteps * kChannels;   // floats of one stage
constexpr int kQuads = kChannels / 4;        // 16-byte pieces of a row
constexpr int kRowsAPass = 32 / kQuads;      // whole rows a warp instruction
constexpr int kPasses = (kSteps + kRowsAPass - 1) / kRowsAPass;
constexpr int kOutStages = 2;  // the output ring, stage s in slot s & 1
constexpr size_t kBarBytes = 16 * (kStages + kOutStages);  // full, empty
constexpr size_t kSmemBytes =
    kBarBytes + sizeof(float) * (2 * kStages + kOutStages) * kStage;
static_assert(kSmemBytes <= 232448, "more than a CTA's shared memory");

struct Args {
  const float* a;
  const float* b;
  const float* h0;
  float* hs;
  float* hT;
  int S, R;
  long long ab, as, bb, bs;  // (batch, seq) strides of a and b, elements
  int vec_in;                // a and b rows 16-byte aligned
  int vec_out;               // hs rows 16-byte aligned (R % 4 == 0)
};

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spin until the phase of parity ``parity`` of ``bar`` has completed
__device__ __forceinline__ void wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// 16 bytes global -> shared, of which the first ``bytes`` are read
__device__ __forceinline__ void copy16(uint32_t dst, const float* src,
                                       int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copy4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// one arrival on ``bar`` once this thread's cp.async copies have landed
__device__ __forceinline__ void arrive_on_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// f(u, q, bytes) for this lane's 16-byte pieces of rows 0 .. nt - 1 of a
// tile of nc channels (q: the piece's first channel; bytes < 16 for the
// partial piece ending a row of nc % 4 != 0).  A full tile takes fixed
// pieces a lane, kRowsAPass whole rows an instruction (the lanes past them
// idle when kQuads does not divide 32), no index arithmetic.
template <typename F>
__device__ __forceinline__ void for_pieces(int nt, int nc, int lane, F f) {
  if (nc == kChannels) {
    const int q = 4 * (lane % kQuads);
#pragma unroll
    for (int j = 0; j < kPasses; ++j) {
      const int u = lane / kQuads + j * kRowsAPass;
      if (lane < kRowsAPass * kQuads && u < nt) f(u, q, 16);
    }
  } else {
    const int quads = (nc + 3) / 4;
    for (int i = lane; i < nt * quads; i += 32) {
      const int u = i / quads, q = 4 * (i - u * quads);
      f(u, q, 4 * min(4, nc - q));
    }
  }
}

// f(u, c) for this lane's elements of rows 0 .. nt - 1 of nc channels
template <typename F>
__device__ __forceinline__ void for_elements(int nt, int nc, int lane, F f) {
  for (int i = lane; i < nt * nc; i += 32) {
    const int u = i / nc;
    f(u, i - u * nc);
  }
}

// Warp 1: fill stage after stage, each once the consumer has released it.
__device__ __forceinline__ void produce(const Args& p, float* ring,
                                       uint32_t full, uint32_t empty, int nc,
                                       int lane) {
  const int c0 = blockIdx.x * kChannels;
  const long long bi = blockIdx.y;
  const float* srcs[2] = {p.a + bi * p.ab + c0, p.b + bi * p.bb + c0};
  const long long steps[2] = {p.as, p.bs};
  uint32_t phase = 0;
  for (int t0 = 0, slot = 0; t0 < p.S; t0 += kSteps) {
    const int nt = min(kSteps, p.S - t0);
    wait(empty + 8 * slot, phase ^ 1);
    const uint32_t bar = full + 8 * slot;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float* src = srcs[k] + t0 * steps[k];
      const long long st = steps[k];
      const uint32_t dst = smem(ring + (2 * slot + k) * kStage);
      if (p.vec_in) {
        for_pieces(nt, nc, lane, [&](int u, int q, int bytes) {
          copy16(dst + 4 * (u * kChannels + q), src + u * st + q, bytes);
        });
      } else {
        for_elements(nt, nc, lane, [&](int u, int c) {
          copy4(dst + 4 * (u * kChannels + c), src + u * st + c);
        });
      }
    }
    arrive_on_copies(bar);
    if (++slot == kStages) {
      slot = 0;
      phase ^= 1;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");  // none left at exit
}

// Warp 2: each output stage back to its hs rows, then released to the
// consumer.
__device__ __forceinline__ void write_back(const Args& p, float* outs,
                                     uint32_t out_full, uint32_t out_empty,
                                     int nc, int lane) {
  const int c0 = blockIdx.x * kChannels;
  const long long bi = blockIdx.y;
  float* hp = p.hs + bi * p.S * p.R + c0;
  const long long R = p.R;
  for (int t0 = 0, s = 0; t0 < p.S; t0 += kSteps, ++s) {
    const int nt = min(kSteps, p.S - t0), o = s & 1;
    wait(out_full + 8 * o, (s >> 1) & 1);
    const float* out = outs + o * kStage;
    float* row = hp + t0 * R;
    if (p.vec_out) {
      for_pieces(nt, nc, lane, [&](int u, int q, int) {
        *reinterpret_cast<float4*>(row + u * R + q) =
            *reinterpret_cast<const float4*>(out + u * kChannels + q);
      });
    } else {
      for_elements(nt, nc, lane, [&](int u, int c) {
        row[u * R + c] = out[u * kChannels + c];
      });
    }
    arrive(out_empty + 8 * o);
  }
}

// One stage of the chain for lane ``cl`` (live: lane < nc); kFull: all
// kSteps steps, else the first nt.  Releases the stage once its a and b
// are in registers.
template <bool kFull>
__device__ __forceinline__ float run_stage(const float* sa, const float* sb,
                                           float* out, uint32_t empty, int nt,
                                           int cl, bool live, float h) {
#pragma unroll
  for (int k = 0; k < kSteps / kSub; ++k) {
    float ra[kSub], rb[kSub];
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
      ra[u] = sa[(k * kSub + u) * kChannels + cl];
      rb[u] = sb[(k * kSub + u) * kChannels + cl];
    }
    if (k == kSteps / kSub - 1) arrive(empty);
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
      const int t = k * kSub + u;
      if (kFull || t < nt) {
        h = __fadd_rn(__fmul_rn(ra[u], h), rb[u]);
        if (live) out[t * kChannels + cl] = h;
      }
    }
  }
  return h;
}

// Warp 0: the chain, one lane a channel.
__device__ __forceinline__ void consume(const Args& p, float* ring,
                                       float* outs, uint32_t full,
                                       uint32_t empty, uint32_t out_full,
                                       uint32_t out_empty, int nc, int lane) {
  const int c0 = blockIdx.x * kChannels;
  const long long bi = blockIdx.y;
  const bool live = lane < nc;
  const int cl = live ? lane : 0;
  float h = live ? p.h0[bi * p.R + c0 + lane] : 0.f;
  uint32_t phase = 0;
  for (int t0 = 0, slot = 0, s = 0; t0 < p.S; t0 += kSteps, ++s) {
    const int nt = min(kSteps, p.S - t0), o = s & 1;
    wait(full + 8 * slot, phase);
    wait(out_empty + 8 * o, ((s >> 1) & 1) ^ 1);
    const float* sa = ring + 2 * slot * kStage;
    float* out = outs + o * kStage;
    if (nt == kSteps)
      h = run_stage<true>(sa, sa + kStage, out, empty + 8 * slot, nt, cl,
                          live, h);
    else
      h = run_stage<false>(sa, sa + kStage, out, empty + 8 * slot, nt, cl,
                           live, h);
    arrive(out_full + 8 * o);
    if (++slot == kStages) {
      slot = 0;
      phase ^= 1;
    }
  }
  if (live) p.hT[bi * p.R + c0 + lane] = h;
}

__global__ void __launch_bounds__(kThreads) rglru_scan_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // barriers: kStages full, kStages empty, then kOutStages out_full and
  // kOutStages out_empty
  const uint32_t full = smem(smem_raw), empty = full + 8 * kStages;
  const uint32_t out_full = empty + 8 * kStages;
  const uint32_t out_empty = out_full + 8 * kOutStages;
  float* ring = reinterpret_cast<float*>(smem_raw + kBarBytes);
  float* outs = ring + 2 * kStages * kStage;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      bar_init(full + 8 * i, 32);   // one arrival a producer lane
      bar_init(empty + 8 * i, 32);  // one arrival a consumer lane
    }
    for (int i = 0; i < kOutStages; ++i) {
      bar_init(out_full + 8 * i, 32);   // a consumer lane
      bar_init(out_empty + 8 * i, 32);  // a storer lane
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int nc = min(kChannels, p.R - static_cast<int>(blockIdx.x) *
                                          kChannels);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  if (warp == 0)
    consume(p, ring, outs, full, empty, out_full, out_empty, nc, lane);
  else if (warp == 1)
    produce(p, ring, full, empty, nc, lane);
  else
    write_back(p, outs, out_full, out_empty, nc, lane);
}

// a row of x starts on kAlignBytes at every (batch, step): the 16-byte
// copies can stage it (mirrored as kernels/linear_scan/ops.py
// rglru_rows_aligned)
bool rows_aligned(const float* x, long long batch, long long seq) {
  constexpr long long kAlignFloats = kAlignBytes / sizeof(float);
  return reinterpret_cast<uintptr_t>(x) % kAlignBytes == 0 &&
         batch % kAlignFloats == 0 && seq % kAlignFloats == 0;
}

}  // namespace

// a, b: (B, S, R) float32 with batch and sequence strides ab, as, bb, bs in
// elements (last dim contiguous); h0 and hT (B, R) and hs (B, S, R) float32
// contiguous.  Launches on ``stream``, never synchronises; returns
// cudaGetLastError() (or the refused attribute's error).
extern "C" int rglru_scan_launch(const float* a, const float* b,
                                 const float* h0, float* hs, float* hT, int B,
                                 int S, int R, long long ab, long long as,
                                 long long bb, long long bs, void* stream) {
  if (B <= 0 || R <= 0) return 0;
  if (S < 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (kSmemBytes > 48 * 1024) {  // above 48 KB only as opted-in dynamic smem
    const cudaError_t err = cudaFuncSetAttribute(
        rglru_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Args p{a, b, h0, hs, hT, S, R, ab, as, bb, bs,
               rows_aligned(a, ab, as) && rows_aligned(b, bb, bs),
               R % 4 == 0};
  const dim3 grid((R + kChannels - 1) / kChannels, B);
  rglru_scan_kernel<<<grid, kThreads, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// bytes of dynamic shared memory a CTA: the ring and the output stage
extern "C" int rglru_scan_smem_bytes() {
  return static_cast<int>(kSmemBytes);
}
