// Fused block-DFT -> phase combine -> 3-tap Hann -> dB waterfall for Hopper
// (sm_90a): a bf16 tensor-core DFT (wgmma) fed by TMA, with an optional
// second output, the boxcar matched-filter power grid.
//
// Replaces the TPU kernels in ft8_demodulator_tpu/ops/waterfall_pallas.py:
//   * `_kernel` (:123, weights resident in VMEM) and `_kernel_strips`
//     (:191, the same grid with the weights streamed in column strips when
//     they overflow VMEM): the instance waterfall_kernel<false>.  Every
//     thread block streams the weight columns of its own tile, so one
//     kernel serves every block geometry;
//   * `_kernel_mf` (:444, entry block_waterfall_mf_tf_fused_batch :507):
//     the instance waterfall_kernel<true>, which also writes the boxcar
//     power grid from the same combine.
//
// Per slot, from audio samples:
//   P[r, c]  = sum_n block[r, n] * (cos[n, c] + i sin[n, c])   r < nb
//              block[r, n] = audio[r*hop + n], both operands rounded to
//              bf16 (round to nearest), products accumulated in f32;
//   u[j, c]  = sum_{s < tau} P[j - lead + s, c] * (wc[s, c] + i ws[s, c]),
//              P of a row outside [0, nb) is zero;
//   x[j, k]  = 0.5 u[j, k+phi] - 0.25 u[j, k] - 0.25 u[j, k+2 phi];
//   db[t, k] = 10 log10(1e-12 + |x[t + lead, k]|^2 * scale), t < num_frames;
//   box[j,k] = |u[j, k+phi]|^2 (the <true> instance only).
// lead is 0 for the dB-only instance (row j is frame j) and tau - 1 for the
// dual-output one: its rows j < num_frames + 2 (tau-1) are the boxcar
// windows starting at block j - (tau-1), so the first and last tau - 1 rows
// are partial sums over zero-padded blocks, and frame t is row t + tau - 1.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s):
//   * 12 kHz osr 2x2, batch 16 (the STANDARD chunk): the DFT's 22.1 GFLOP
//     take 22.3 us on the tensor cores, its 41.8 MB of audio in and dB out
//     12.5 us: compute-bound, 22.3 us;
//   * 12 kHz osr 4x4, batch 8 (the DEEP chunk, both grids): 105 MB, mostly
//     the two f32 grids, take 31.4 us, the 22.2 GFLOP 22.4 us:
//     memory-bound, 31.4 us.
// The design:
//   * operands the TMA can read: the pre-pass waterfall_pack_kernel writes
//     the chunk's audio once as a bf16 block matrix (B, lead + nb + lead,
//     hop_pad), zero rows above and below, hop_pad = hop rounded up to 8 so
//     that every TMA stride is a multiple of 16 bytes; the weights are
//     packed once per geometry (ops/waterfall_cuda.py pack_weights): tile
//     j's BN extended columns, halo included, as 2 BN rows of hop_pad
//     samples, each warpgroup's BN / 2 cos columns then the same sin
//     columns, so one wgmma with N = BN yields a warpgroup's real and
//     imaginary parts together.  Zero rows, zero samples and the TMA's
//     zero fill past hop_pad replace per-element masks;
//   * main loop: a ring of STAGES stages of 64 samples, filled by TMA
//     (cp.async.bulk.tensor, 128-byte swizzle, mbarriers) from one producer
//     warp; a CTA owns 64 block rows (any slot) and one weight tile, and
//     each of its two consumer warpgroups issues wgmma.mma_async
//     m64n128k16 (bf16 x bf16 -> f32) for half of the tile's columns (64
//     cos and the same 64 sin) straight from shared memory.  The operand
//     tiles come from L2, 40 KB per 64 samples, and that feed, not the
//     tensor cores, sets the loop's pace: on the H100 at 12 kHz 2x2,
//     batch 16, the loads alone take 0.069 ms of the kernel's 0.120, the
//     products add 0.016 and the epilogue 0.035.  Two variants that cut
//     the L2 traffic were slower: a two-CTA cluster sharing the weight
//     tile by TMA multicast (0.21 ms against 0.17 without it, one run),
//     and two row tiles per CTA, which spill at the 168 registers a
//     288-thread block gets (0.31 ms);
//   * f32 sums: the tensor cores add in f32 but drop the bits below the
//     sum's last place, and over hop samples that bias reached 4.4e-2 dB
//     against the plain version in the grids' deepest nulls (20 kHz 2x2,
//     one accumulator).  So each pair of k16 products (32 samples) goes
//     into a fresh accumulator, which the warpgroup then adds to a second
//     f32 accumulator with round-to-nearest adds.  Against a float64 sum of
//     the same products the kernel is then as close as the plain float32
//     version (on the H100: 8.7e-4 against 2.3e-3 dB at 12 kHz 2x2, batch
//     16; 4.9e-3 against 1.0e-2 dB at 4x4, batch 8, both in cells below
//     -100 dB);
//   * tile width: BN = 128 extended columns (N = 256), so the 2 phi halo
//     columns cost 3 % (osr 2x2) and 7 % (4x4) extra products; the tau - 1
//     halo rows 2 % and 5 %;
//   * epilogue: the sums land in a shared-memory spectra tile (in the ring,
//     which the products no longer read); a thread then owns an extended
//     column over half of the rows, holds its tau combine phases in
//     registers (loaded once per tile) and writes the combined rows to a
//     second tile; then the Hann taps, |x|^2 and dB, and for <true> the
//     centre tap's |u|^2, one bin per thread, so a warp's stores are 128
//     contiguous bytes.  Nothing between the audio and the grids goes
//     back to device memory.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int BM = 64;            // block rows per tile (wgmma M)
constexpr int BN = 128;           // extended columns per tile: N = 2 BN
constexpr int BK = 64;            // samples per stage: 128 bytes of bf16
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;      // warpgroups, each on BN / 2 columns
constexpr int WG_COLS = BN / CONSUMERS;
constexpr int THREADS = CONSUMERS * 128 + 32;   // and one producer warp
constexpr int MAX_TAU = 8;
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = 2 * BN * BK * 2;
constexpr int WG_B_BYTES = B_BYTES / CONSUMERS;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int PLD = BN + 8;       // padded row of the spectra tile, floats
constexpr int SMEM_BYTES = RING_BYTES + 2 * STAGES * 8 + 1024;
constexpr int PACK_THREADS = 256;

static_assert(4 * BM * PLD * 4 <= RING_BYTES,
              "the spectra tiles P and U must fit in the ring");
static_assert(A_BYTES % 1024 == 0 && WG_B_BYTES % 1024 == 0,
              "swizzled tiles start on 1024-byte boundaries");
static_assert(2 * WG_COLS == 128, "one m64n128k16 per warpgroup and k16");

// cuTensorMapEncodeTiled, taken from the driver through the runtime so that
// the library needs no link against libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
constexpr int ERR_ENCODE = -1;    // cuTensorMapEncodeTiled refused a map
constexpr int ERR_NO_ENCODER = -2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Waits for the phase of `parity` to complete; traps (a launch error, not
// a hang) if it has not after 2^24 polls, which only a fault can cause.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile of 128-byte rows with
// the 128-byte swizzle: 8-row groups 1024 bytes apart (stride byte offset),
// the leading byte offset unused by this layout, layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// D (64 x 128, f32, registers) = A (64 x 16) * B (16 x 128) + (scale_d ? D
// : 0), bf16 operands read K-major from 128-byte-swizzled shared memory
// through descriptors.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The chunk's audio (batch, n) f32 as the bf16 block matrix (batch, rows,
// hop_pad): row lead + r holds block r (samples r*hop ...), rounded to
// nearest; rows outside the blocks and samples past hop are zero.  Each
// thread writes 8 samples (16 bytes).
__global__ void __launch_bounds__(PACK_THREADS)
waterfall_pack_kernel(const float* __restrict__ waves,
                      __nv_bfloat16* __restrict__ blocks, int n, int hop,
                      int hop_pad, int nb, int lead, int rows,
                      long long groups) {
  const long long g = static_cast<long long>(blockIdx.x) * PACK_THREADS +
                      threadIdx.x;
  if (g >= groups) return;
  const long long e = g * 8;
  const int k = static_cast<int>(e % hop_pad);
  const long long row_all = e / hop_pad;
  const int r = static_cast<int>(row_all % rows) - lead;
  const long long slot = row_all / rows;
  const float* src = waves + slot * n + static_cast<long long>(r) * hop;
  alignas(16) __nv_bfloat16 v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool in = r >= 0 && r < nb && k + i < hop;
    v[i] = __float2bfloat16_rn(in ? src[k + i] : 0.f);
  }
  *reinterpret_cast<uint4*>(blocks + e) = *reinterpret_cast<uint4*>(v);
}

template <bool kBox>
__global__ void __launch_bounds__(THREADS, 1)
waterfall_kernel(const __grid_constant__ CUtensorMap a_map,
                 const __grid_constant__ CUtensorMap b_map,
                 const float* __restrict__ wc, const float* __restrict__ ws,
                 float* __restrict__ db, float* __restrict__ box,
                 int k_steps, int row_tiles, int kx, int nbins,
                 int num_frames, int tau, int phi, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + RING_BYTES);
  uint64_t* empty = full + STAGES;

  const int lead = kBox ? tau - 1 : 0;        // zero rows above block 0
  const int rows = num_frames + 2 * lead;     // output rows of the grid
  const int tm = BM - (tau - 1);              // output rows per row tile
  const int tn = BN - 2 * phi;                // output bins per tile
  const int c0 = blockIdx.x * tn;             // first bin == first column
  const int slot = blockIdx.y / row_tiles;
  const int j0 = (blockIdx.y % row_tiles) * tm;   // first output row
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: one thread keeps the ring full: the block rows j0 .. j0 +
    // BM of the padded block matrix (row j0 + i is block j0 + i - lead)
    // and the weight tile
    if (threadIdx.x == CONSUMERS * 128) {
      for (int ks = 0; ks < k_steps; ++ks) {
        const int s = ks % STAGES;
        mbar_wait(smem_u32(&empty[s]), ((ks / STAGES) & 1) ^ 1);
        const uint32_t bar = smem_u32(&full[s]);
        mbar_expect_tx(bar, STAGE_BYTES);
        unsigned char* stage = smem + s * STAGE_BYTES;
        tma_load_3d(smem_u32(stage), &a_map, bar, ks * BK, j0, slot);
        tma_load_2d(smem_u32(stage + A_BYTES), &b_map, bar, ks * BK,
                    blockIdx.x * 2 * BN);
      }
    }
  } else {
    // consumer warpgroup wg: extended columns wg * WG_COLS ... + WG_COLS
    const int t128 = threadIdx.x % 128;
    const int warp = t128 / 32;
    const int lane = t128 % 32;
    float acc[64];
    float sum[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.f;
    for (int ks = 0; ks < k_steps; ++ks) {
      const int s = ks % STAGES;
      mbar_wait(smem_u32(&full[s]), (ks / STAGES) & 1);
      const uint32_t a = smem_u32(smem + s * STAGE_BYTES);
      const uint32_t b = smem_u32(smem + s * STAGE_BYTES + A_BYTES +
                                  wg * WG_B_BYTES);
#pragma unroll
      for (int pair = 0; pair < BK / 32; ++pair) {
        // two k16 products into a fresh accumulator, then one
        // round-to-nearest add into the sum
        wgmma_fence();
        wgmma_m64n128k16(acc, sw128_desc(a + pair * 64),
                         sw128_desc(b + pair * 64), 0);
        wgmma_m64n128k16(acc, sw128_desc(a + pair * 64 + 32),
                         sw128_desc(b + pair * 64 + 32), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] += acc[i];
      }
      // this stage's products are done: release it
      if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
    }

    // every warpgroup is done with the ring: it becomes the spectra tile
    // P and the combined tile U
    bar_sync(1, CONSUMERS * 128);
    float* p_r = reinterpret_cast<float*>(smem);
    float* p_i = p_r + BM * PLD;
    float* u_r = p_i + BM * PLD;
    float* u_i = u_r + BM * PLD;
    {
      // accumulator layout: register 4i + 2h + e holds row 16 warp +
      // lane/4 + 8h, column 8i + 2 (lane % 4) + e; columns < WG_COLS are
      // cos (real)
      const int r0 = warp * 16 + lane / 4;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        float* dst = (i < 8 ? p_r : p_i) + wg * WG_COLS + (i % 8) * 8 +
                     2 * (lane % 4);
        *reinterpret_cast<float2*>(dst + r0 * PLD) =
            make_float2(sum[4 * i], sum[4 * i + 1]);
        *reinterpret_cast<float2*>(dst + (r0 + 8) * PLD) =
            make_float2(sum[4 * i + 2], sum[4 * i + 3]);
      }
    }
    bar_sync(1, CONSUMERS * 128);

    // phase combine: thread (c, wg) takes extended column c, its tau
    // phases in registers, over its warpgroup's half of the rows
    const int half = (tm + 1) / 2;
    const int t0 = wg * half;
    const int t_end = min(tm, t0 + half);
    {
      const int c = t128;
      const int gc = c0 + c;
      float w_r[MAX_TAU];
      float w_i[MAX_TAU];
#pragma unroll
      for (int s = 0; s < MAX_TAU; ++s) {
        const bool in = s < tau && gc < kx;
        w_r[s] = in ? __ldg(wc + s * kx + gc) : 0.f;
        w_i[s] = in ? __ldg(ws + s * kx + gc) : 0.f;
      }
#pragma unroll 4
      for (int t = t0; t < t_end; ++t) {
        float ur = 0.f;
        float ui = 0.f;
#pragma unroll
        for (int s = 0; s < MAX_TAU; ++s) {
          if (s < tau) {
            const float pr = p_r[(t + s) * PLD + c];
            const float pi = p_i[(t + s) * PLD + c];
            ur += pr * w_r[s] - pi * w_i[s];
            ui += pr * w_i[s] + pi * w_r[s];
          }
        }
        u_r[t * PLD + c] = ur;
        u_i[t * PLD + c] = ui;
      }
    }
    bar_sync(1, CONSUMERS * 128);

    // Hann taps, |x|^2, dB (and the boxcar value): one bin per thread, the
    // rows split between the warpgroups
    const int k = t128;
    const int bin = c0 + k;
    if (k < tn && bin < nbins) {
      const int t_out = min(t_end, rows - j0);
#pragma unroll 4
      for (int t = t0; t < t_out; ++t) {
        const int j = j0 + t;
        const float* ur = u_r + t * PLD + k;
        const float* ui = u_i + t * PLD + k;
        const float cr = ur[phi];
        const float ci = ui[phi];
        if (kBox) {
          box[(static_cast<size_t>(slot) * rows + j) * nbins + bin] =
              cr * cr + ci * ci;
        }
        const int frame = j - lead;
        if (frame < 0 || frame >= num_frames) continue;
        const float xr = 0.5f * cr - 0.25f * ur[0] - 0.25f * ur[2 * phi];
        const float xi = 0.5f * ci - 0.25f * ui[0] - 0.25f * ui[2 * phi];
        db[(static_cast<size_t>(slot) * num_frames + frame) * nbins + bin] =
            10.f * __log10f(1e-12f + (xr * xr + xi * xi) * scale);
      }
    }
  }
}

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor map with the 128-byte swizzle over `rank` dimensions
// (innermost first), boxes of `box`.
int encode(CUtensorMap* map, const void* base, int rank,
           const cuuint64_t* dims, const cuuint64_t* strides,
           const cuuint32_t* box) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

template <bool kBox>
int launch(const void* waves, const void* wpack, const void* wc,
           const void* ws, void* blocks, void* db, void* box, int batch, int n,
           int hop, int hop_pad, int kx, int nbins, int num_frames, int tau,
           int phi, float scale, void* stream) {
  if (batch == 0 || num_frames == 0 || nbins == 0) return cudaSuccess;
  if (tau < 1 || tau > MAX_TAU || phi < 0 || 2 * phi >= BN ||
      hop_pad % 8 != 0 || hop_pad < hop) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lead = kBox ? tau - 1 : 0;
  const int rows = num_frames + 2 * lead;
  const int nb = num_frames + tau - 1;
  const int block_rows = nb + 2 * lead;
  const int tm = BM - (tau - 1);
  const int tn = BN - 2 * phi;
  const int row_tiles = (rows + tm - 1) / tm;
  const long long grid_y = static_cast<long long>(batch) * row_tiles;
  const int col_tiles = (nbins + tn - 1) / tn;
  if (grid_y > 65535) return cudaErrorInvalidConfiguration;

  CUtensorMap a_map;
  CUtensorMap b_map;
  const cuuint64_t a_dims[3] = {static_cast<cuuint64_t>(hop_pad),
                                static_cast<cuuint64_t>(block_rows),
                                static_cast<cuuint64_t>(batch)};
  const cuuint64_t a_strides[2] = {
      static_cast<cuuint64_t>(hop_pad) * 2,
      static_cast<cuuint64_t>(hop_pad) * 2 * block_rows};
  const cuuint32_t a_box[3] = {BK, BM, 1};
  const cuuint64_t b_dims[2] = {static_cast<cuuint64_t>(hop_pad),
                                static_cast<cuuint64_t>(col_tiles) * 2 * BN};
  const cuuint64_t b_strides[1] = {static_cast<cuuint64_t>(hop_pad) * 2};
  const cuuint32_t b_box[2] = {BK, 2 * BN};
  int err = encode(&a_map, blocks, 3, a_dims, a_strides, a_box);
  if (err == 0) err = encode(&b_map, wpack, 2, b_dims, b_strides, b_box);
  if (err != 0) return err;

  const long long groups =
      static_cast<long long>(batch) * block_rows * hop_pad / 8;
  waterfall_pack_kernel<<<static_cast<unsigned>(
                              (groups + PACK_THREADS - 1) / PACK_THREADS),
                          PACK_THREADS, 0, st>>>(
      static_cast<const float*>(waves),
      static_cast<__nv_bfloat16*>(blocks), n, hop, hop_pad, nb, lead,
      block_rows, groups);
  cudaError_t cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  cerr = cudaFuncSetAttribute(waterfall_kernel<kBox>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_BYTES);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int k_steps = (hop_pad + BK - 1) / BK;
  waterfall_kernel<kBox><<<dim3(col_tiles, static_cast<unsigned>(grid_y)),
                           THREADS, SMEM_BYTES, st>>>(
      a_map, b_map, static_cast<const float*>(wc),
      static_cast<const float*>(ws), static_cast<float*>(db),
      static_cast<float*>(box), k_steps, row_tiles, kx, nbins, num_frames,
      tau, phi, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The tile, for the wrappers' checks and the weight packing: block rows per
// tile (output rows = BM - (tau - 1)), extended columns per tile (bins =
// BN - 2 phi; the packed weights hold 2 BN rows per tile, BN / 2 cos then
// BN / 2 sin columns per warpgroup), the largest tau.
int ft8_waterfall_tf_tile_rows() { return BM; }
int ft8_waterfall_tf_tile_cols() { return BN; }
int ft8_waterfall_tf_max_tau() { return MAX_TAU; }

// Launches the pack pre-pass and the dB-only kernel on `stream`; returns
// cudaGetLastError() (or a negative code: -1 a tensor map was refused, -2
// no cuTensorMapEncodeTiled).
//   waves (batch, n) f32; wpack (col_tiles * 2 BN, hop_pad) bf16 (packed
//   weights); wc, ws (tau, kx) f32; blocks (batch, num_frames + tau - 1,
//   hop_pad) bf16 scratch; out (batch, num_frames, nbins) f32.  All
//   contiguous on one card.
int ft8_waterfall_tf(const void* waves, const void* wpack, const void* wc,
                     const void* ws, void* blocks, void* out, int batch,
                     int n, int hop, int hop_pad, int kx, int nbins,
                     int num_frames, int tau, int phi, float scale,
                     void* stream) {
  return launch<false>(waves, wpack, wc, ws, blocks, out, nullptr, batch, n,
                       hop, hop_pad, kx, nbins, num_frames, tau, phi, scale,
                       stream);
}

// Launches the pack pre-pass and the dual-output kernel on `stream`.  As
// ft8_waterfall_tf, with blocks (batch, num_frames + 3 (tau - 1), hop_pad)
// and box (batch, num_frames + 2 (tau-1), nbins) f32, the boxcar grid.
int ft8_waterfall_mf_tf(const void* waves, const void* wpack, const void* wc,
                        const void* ws, void* blocks, void* db, void* box,
                        int batch, int n, int hop, int hop_pad, int kx,
                        int nbins, int num_frames, int tau, int phi,
                        float scale, void* stream) {
  return launch<true>(waves, wpack, wc, ws, blocks, db, box, batch, n, hop,
                      hop_pad, kx, nbins, num_frames, tau, phi, scale,
                      stream);
}

const char* ft8_cuda_error_string(int err) {
  if (err == ERR_ENCODE) return "cuTensorMapEncodeTiled refused a tensor map";
  if (err == ERR_NO_ENCODER) return "cuTensorMapEncodeTiled not found";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
