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
// 0.125 ms at 3.35 TB/s; 3 FLOP an element are nothing.  Keeping 3.35
// TB/s flowing at ~0.6-0.8 us of loaded DRAM latency needs ~2-2.7 MB of
// loads in flight card-wide (rglru_scan.cu's reckoning); 80 CTAs at B 1
// keep up to kStages x 12 KB each in flight, ~5.8 MB, and two CTAs fit an
// SM (88 KB of shared memory each), so B 2's 160 run in one wave.  The
// chain is three dependent rounded operations a step (add, then multiply
// into the next add; da's multiply is off the chain), ~8 cycles: ~65 K
// cycles, ~37 us over 8,192 steps, well under the byte bound, provided the
// chain's warp does little else.
//
// The design is the forward's (rglru_scan.cu), run in descending t.  A CTA
// owns kChannels = 32 channels of one batch row, so each row it reads or
// writes is one 128-byte line.  Stage s of the ring holds steps [t0, t0 +
// nt) counted from the end (t0 + nt = S - s kSteps): a, dhs and h_{t-1},
// the hs rows t0 - 1 .. t0 + nt - 2 (at t0 = 0, h_{-1} is h0's row).  Three
// warps:
// - warp 1, the producer, keeps every free stage in flight: 16-byte
//   cp.async copies, each lane's completion signalled on the stage's full
//   mbarrier by cp.async.mbarrier.arrive.noinc;
// - warp 0, the consumer, one lane a channel, waits on the full barrier,
//   reads the stage's a, dhs and h into registers kSub steps at a time, from
//   the stage's last step down, releases the stage on its empty barrier
//   once the last of them is read, and runs the chain in a register, each
//   da and db into one of two output stages in shared memory;
// - warp 2, the storer, writes each output stage back to da and db as
//   16-byte stores and releases it to the consumer.
// Every barrier pair carries a phase bit each round of its ring, so a stage
// is refilled only after its release and read only after its fill.
// Rows not 16-byte aligned (R % 4 != 0, or a base off 16 bytes) are staged
// by 4-byte cp.async copies and written back 4 bytes at a time; the last
// channel tile copies its nc < kChannels channels (a partial 16-byte copy
// at its end), and the stage holding t = 0 its nt < kSteps steps.  Inputs
// and outputs are contiguous f32 (the wrapper casts).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChannels = 32;  // C: channels a CTA, one consumer lane each
constexpr int kSteps = 32;     // T: steps a stage
constexpr int kStages = 6;     // N: stages in the ring
constexpr int kAlignBytes = 16;
// steps of a stage read into registers at once
constexpr int kSub = kSteps < 16 ? kSteps : 16;
// warp 0 consumes, warp 1 produces, warp 2 stores
constexpr int kThreads = 96;

static_assert(kChannels % 4 == 0 && kChannels <= 32, "one lane a channel");
static_assert(kSteps % kSub == 0, "whole register blocks a stage");

constexpr int kStage = kSteps * kChannels;  // floats of one array a stage
constexpr int kIn = 3;                      // a, dhs, h_{t-1}
constexpr int kOut = 2;                     // da, db
constexpr int kQuads = kChannels / 4;       // 16-byte pieces of a row
constexpr int kRowsAPass = 32 / kQuads;     // whole rows a warp instruction
constexpr int kPasses = (kSteps + kRowsAPass - 1) / kRowsAPass;
constexpr int kOutStages = 2;  // the output ring, stage s in slot s & 1
constexpr size_t kBarBytes = 16 * (kStages + kOutStages);  // full, empty
constexpr size_t kSmemBytes =
    kBarBytes +
    sizeof(float) * (kIn * kStages + kOut * kOutStages) * kStage;
static_assert(kSmemBytes <= 232448, "more than a CTA's shared memory");

struct Args {
  const float* a;
  const float* h0;
  const float* hs;
  const float* dhs;
  const float* dhT;
  float* da;
  float* db;
  float* dh0;
  int S, R;
  int vec;  // every row of a, h0, hs, dhs, da, db starts on 16 bytes
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
// pieces a lane, kRowsAPass whole rows an instruction.
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

// nt rows of nc channels from src (rows R apart) into dst (rows kChannels
// apart): 16-byte copies when vec, else 4-byte ones
__device__ __forceinline__ void copy_rows(uint32_t dst, const float* src,
                                          long long R, int nt, int nc,
                                          bool vec, int lane) {
  if (vec) {
    for_pieces(nt, nc, lane, [&](int u, int q, int bytes) {
      copy16(dst + 4 * (u * kChannels + q), src + u * R + q, bytes);
    });
  } else {
    for_elements(nt, nc, lane, [&](int u, int c) {
      copy4(dst + 4 * (u * kChannels + c), src + u * R + c);
    });
  }
}

// the steps of stage s: [t0, t0 + nt), counted from the end
__device__ __forceinline__ void stage_steps(int S, int s, int& t0, int& nt) {
  const int t1 = S - s * kSteps;
  t0 = max(0, t1 - kSteps);
  nt = t1 - t0;
}

// Warp 1: fill stage after stage, each once the consumer has released it.
__device__ __forceinline__ void produce(const Args& p, float* ring,
                                       uint32_t full, uint32_t empty, int nc,
                                       int lane) {
  const int c0 = blockIdx.x * kChannels;
  const long long bi = blockIdx.y;
  const long long R = p.R, base = bi * p.S * R + c0;
  const bool vec = p.vec != 0;
  const int n_stages = (p.S + kSteps - 1) / kSteps;
  uint32_t phase = 0;
  for (int s = 0, slot = 0; s < n_stages; ++s) {
    int t0, nt;
    stage_steps(p.S, s, t0, nt);
    wait(empty + 8 * slot, phase ^ 1);
    const uint32_t dst = smem(ring + kIn * slot * kStage);
    copy_rows(dst, p.a + base + t0 * R, R, nt, nc, vec, lane);
    copy_rows(dst + 4 * kStage, p.dhs + base + t0 * R, R, nt, nc, vec,
              lane);
    // h_{t-1} for t in [t0, t0 + nt): hs rows t0 - 1 .., h0 at t = 0
    const uint32_t hdst = dst + 8 * kStage;
    if (t0 > 0) {
      copy_rows(hdst, p.hs + base + (t0 - 1) * R, R, nt, nc, vec, lane);
    } else {
      copy_rows(hdst, p.h0 + bi * R + c0, R, 1, nc, vec, lane);
      copy_rows(hdst + 4 * kChannels, p.hs + base, R, nt - 1, nc, vec,
                lane);
    }
    arrive_on_copies(full + 8 * slot);
    if (++slot == kStages) {
      slot = 0;
      phase ^= 1;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");  // none left at exit
}

// Warp 2: each output stage back to its da and db rows, then released to
// the consumer.
__device__ __forceinline__ void write_back(const Args& p, float* outs,
                                           uint32_t out_full,
                                           uint32_t out_empty, int nc,
                                           int lane) {
  const int c0 = blockIdx.x * kChannels;
  const long long bi = blockIdx.y;
  const long long R = p.R, base = bi * p.S * R + c0;
  const int n_stages = (p.S + kSteps - 1) / kSteps;
  for (int s = 0; s < n_stages; ++s) {
    int t0, nt;
    stage_steps(p.S, s, t0, nt);
    const int o = s & 1;
    wait(out_full + 8 * o, (s >> 1) & 1);
    const float* out = outs + kOut * o * kStage;
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      float* row = (k == 0 ? p.da : p.db) + base + t0 * R;
      const float* src = out + k * kStage;
      if (p.vec) {
        for_pieces(nt, nc, lane, [&](int u, int q, int) {
          *reinterpret_cast<float4*>(row + u * R + q) =
              *reinterpret_cast<const float4*>(src + u * kChannels + q);
        });
      } else {
        for_elements(nt, nc, lane, [&](int u, int c) {
          row[u * R + c] = src[u * kChannels + c];
        });
      }
    }
    arrive(out_empty + 8 * o);
  }
}

// One stage of the chain for lane ``cl`` (live: lane < nc), its steps nt -
// 1 down to 0; kFull: nt == kSteps.  Releases the stage once its a, dhs
// and h are in registers.
template <bool kFull>
__device__ __forceinline__ float run_stage(const float* in, float* out,
                                           uint32_t empty, int nt, int cl,
                                           bool live, float g) {
  if (kFull) nt = kSteps;
#pragma unroll
  for (int k = 0; k < kSteps / kSub; ++k) {
    float ra[kSub], rd[kSub], rh[kSub];
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const int u = max(nt - 1 - (k * kSub + j), 0);
      ra[j] = in[u * kChannels + cl];
      rd[j] = in[kStage + u * kChannels + cl];
      rh[j] = in[2 * kStage + u * kChannels + cl];
    }
    if (k == kSteps / kSub - 1) arrive(empty);
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const int u = nt - 1 - (k * kSub + j);
      if (kFull || u >= 0) {
        g = __fadd_rn(g, rd[j]);
        if (live) {
          out[kStage + u * kChannels + cl] = g;              // db
          out[u * kChannels + cl] = __fmul_rn(g, rh[j]);     // da
        }
        g = __fmul_rn(ra[j], g);
      }
    }
  }
  return g;
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
  float g = live ? p.dhT[bi * p.R + c0 + lane] : 0.f;
  const int n_stages = (p.S + kSteps - 1) / kSteps;
  uint32_t phase = 0;
  for (int s = 0, slot = 0; s < n_stages; ++s) {
    int t0, nt;
    stage_steps(p.S, s, t0, nt);
    const int o = s & 1;
    wait(full + 8 * slot, phase);
    wait(out_empty + 8 * o, ((s >> 1) & 1) ^ 1);
    const float* in = ring + kIn * slot * kStage;
    float* out = outs + kOut * o * kStage;
    if (nt == kSteps)
      g = run_stage<true>(in, out, empty + 8 * slot, nt, cl, live, g);
    else
      g = run_stage<false>(in, out, empty + 8 * slot, nt, cl, live, g);
    arrive(out_full + 8 * o);
    if (++slot == kStages) {
      slot = 0;
      phase ^= 1;
    }
  }
  if (live) p.dh0[bi * p.R + c0 + lane] = g;
}

__global__ void __launch_bounds__(kThreads)
    rglru_scan_bwd_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // barriers: kStages full, kStages empty, then kOutStages out_full and
  // kOutStages out_empty
  const uint32_t full = smem(smem_raw), empty = full + 8 * kStages;
  const uint32_t out_full = empty + 8 * kStages;
  const uint32_t out_empty = out_full + 8 * kOutStages;
  float* ring = reinterpret_cast<float*>(smem_raw + kBarBytes);
  float* outs = ring + kIn * kStages * kStage;
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

bool aligned(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % kAlignBytes == 0;
}

}  // namespace

// a, hs, dhs, da, db: (B, S, R) float32 contiguous; h0, dhT, dh0: (B, R)
// float32 contiguous.  Launches on ``stream``, never synchronises; returns
// cudaGetLastError() (or the refused attribute's error).
extern "C" int rglru_scan_bwd_launch(const float* a, const float* h0,
                                     const float* hs, const float* dhs,
                                     const float* dhT, float* da, float* db,
                                     float* dh0, int B, int S, int R,
                                     void* stream) {
  if (B <= 0 || R <= 0) return 0;
  if (S < 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (kSmemBytes > 48 * 1024) {  // above 48 KB only as opted-in dynamic smem
    const cudaError_t err = cudaFuncSetAttribute(
        rglru_scan_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // contiguous rows start on 16 bytes when every base does and R % 4 == 0
  const bool vec = R % (kAlignBytes / 4) == 0 && aligned(a) && aligned(h0) &&
                   aligned(hs) && aligned(dhs) && aligned(da) && aligned(db);
  const Args p{a, h0, hs, dhs, dhT, da, db, dh0, S, R, vec ? 1 : 0};
  const dim3 grid((R + kChannels - 1) / kChannels, B);
  rglru_scan_bwd_kernel<<<grid, kThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// bytes of dynamic shared memory a CTA: the ring and the output stages
extern "C" int rglru_scan_bwd_smem_bytes() {
  return static_cast<int>(kSmemBytes);
}
