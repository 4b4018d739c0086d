// Fused block-DFT -> phase combine -> 3-tap Hann -> dB waterfall, sm_90a,
// with an optional second output: the boxcar matched-filter power grid.
//
// Replaces the TPU kernels in ft8_demodulator_tpu/ops/waterfall_pallas.py:
//   * `_kernel` (:123, weights resident in VMEM) and `_kernel_strips`
//     (:191, the same grid with the weights streamed in column strips when
//     they overflow VMEM): the instance waterfall_kernel<false>.  Each
//     thread block streams the weight columns it needs through shared
//     memory, so one kernel serves every block geometry;
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
// What bounds it on the card: the DFT.  At 12 kHz, osr 4x4 (the DEEP
// geometry) a slot is 375 x 480 x 3848 x 2 multiply-adds (~2.77 GFLOP)
// against 0.72 MB of audio and 11.5 MB of output grids, ~230 FLOP per byte
// of device memory, so the kernel is compute-bound.  The design keeps
// everything between the audio and the grids on chip:
//   * one thread block owns (slot, BM - (tau-1) output rows, BN - 2 phi
//     output bins) and computes the spectra of the BM block rows and BN
//     extended columns they need; the tau-1 halo rows and 2 phi halo
//     columns are recomputed by the neighbouring tiles (~5 % and ~14 %
//     extra work at osr 4x4);
//   * the products run on the CUDA cores as a register-tiled GEMM: each
//     thread holds a 4 x 4 tile of both the cos and the sin products, fed
//     from BK-deep slices of audio and weights staged in shared memory;
//   * the spectra tile lands in shared memory (reusing the staging
//     buffer) and the combine / Hann / dB epilogue reads it there, so the
//     spectra never reach device memory; the boxcar value is the combine's
//     centre tap, so the second output costs one store per cell;
//   * ragged edges (block rows outside [0, nb), columns >= kx, samples >=
//     hop, rows or frames past the end, bins >= nbins) are masked: zeros
//     in, nothing out.
// Tensor cores (wgmma on bf16) and a pipelined TMA feed are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 64;         // block rows (GEMM M) per tile
constexpr int BN = 64;         // extended columns (GEMM N) per tile
constexpr int BK = 16;         // samples (GEMM K) per staging step
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int ALD = BM + 1;    // padded stride of the transposed audio tile
constexpr int PLD = BN + 1;    // padded stride of the spectra tile
constexpr int SMEM_FLOATS = 2 * BM * PLD;

static_assert(BM == 64 && BN == 64 && BK == 16 && THREADS == 256,
              "the thread mapping assumes 16 x 16 threads, 4 x 4 each");
static_assert(BK * ALD + 2 * BK * BN <= SMEM_FLOATS,
              "staging buffers must fit in the spectra tile's space");

template <bool kBox>
__global__ void __launch_bounds__(THREADS)
waterfall_kernel(const float* __restrict__ waves,
                 const __nv_bfloat16* __restrict__ cos_m,
                 const __nv_bfloat16* __restrict__ sin_m,
                 const float* __restrict__ wc,
                 const float* __restrict__ ws,
                 float* __restrict__ db,
                 float* __restrict__ box,
                 int n, int hop, int kx, int nbins, int num_frames,
                 int tau, int phi, float scale) {
  __shared__ float smem[SMEM_FLOATS];
  float* a_s = smem;                  // [BK][ALD]  audio tile, transposed
  float* bc_s = a_s + BK * ALD;       // [BK][BN]   cos weights
  float* bs_s = bc_s + BK * BN;       // [BK][BN]   sin weights

  const int lead = kBox ? tau - 1 : 0;        // zero blocks above block 0
  const int rows = num_frames + 2 * lead;     // output rows of the grid
  const int tm = BM - (tau - 1);      // output rows per tile
  const int tn = BN - 2 * phi;        // output bins per tile
  const int slot = blockIdx.z;
  const int j0 = blockIdx.y * tm;     // first output row
  const int r0 = j0 - lead;           // its first block row
  const int c0 = blockIdx.x * tn;     // first bin == first extended column
  const int nb = num_frames + tau - 1;
  const float* wave = waves + static_cast<size_t>(slot) * n;

  const int tid = threadIdx.x;
  const int tx = tid % 16;            // columns tx + 16 j
  const int ty = tid / 16;            // rows ty + 16 i

  float acc_r[4][4];
  float acc_i[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc_r[i][j] = 0.f;
      acc_i[i][j] = 0.f;
    }
  }

  for (int k0 = 0; k0 < hop; k0 += BK) {
    // audio: BM rows x BK samples, neighbouring threads on neighbouring
    // samples; rounded to bf16 as the TPU kernel's operand cast
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int row = r0 + r;
      const int k = k0 + tx;
      float v = 0.f;
      if (row >= 0 && row < nb && k < hop) {
        v = __bfloat162float(__float2bfloat16_rn(
            wave[static_cast<size_t>(row) * hop + k]));
      }
      a_s[tx * ALD + r] = v;
    }
    // weights: BK samples x BN columns of each matrix
#pragma unroll
    for (int j = 0; j < BK * BN / THREADS; ++j) {
      const int kk = tid / BN + (THREADS / BN) * j;
      const int col = tid % BN;
      const int k = k0 + kk;
      const int c = c0 + col;
      float vc = 0.f;
      float vs = 0.f;
      if (k < hop && c < kx) {
        const size_t idx = static_cast<size_t>(k) * kx + c;
        vc = __bfloat162float(cos_m[idx]);
        vs = __bfloat162float(sin_m[idx]);
      }
      bc_s[kk * BN + col] = vc;
      bs_s[kk * BN + col] = vs;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4];
      float bc[4];
      float bs[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[kk * ALD + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bc[j] = bc_s[kk * BN + tx + 16 * j];
        bs[j] = bs_s[kk * BN + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_r[i][j] = fmaf(a[i], bc[j], acc_r[i][j]);
          acc_i[i][j] = fmaf(a[i], bs[j], acc_i[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // spectra tile: [BM][PLD] real then imaginary parts
  float* p_r = smem;
  float* p_i = smem + BM * PLD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p_r[(ty + 16 * i) * PLD + tx + 16 * j] = acc_r[i][j];
      p_i[(ty + 16 * i) * PLD + tx + 16 * j] = acc_i[i][j];
    }
  }
  __syncthreads();

  // epilogue: tau-block phase combine at the three Hann taps, |x|^2, dB;
  // the centre tap's |u|^2 is the boxcar value
  for (int e = tid; e < tm * tn; e += THREADS) {
    const int t = e / tn;
    const int k = e % tn;
    const int row = j0 + t;
    const int bin = c0 + k;
    if (row >= rows || bin >= nbins) continue;
    float xr = 0.f;
    float xi = 0.f;
    float br = 0.f;
    float bi = 0.f;
    for (int q = 0; q < 3; ++q) {
      const int c = k + q * phi;      // local extended column of the tap
      const int gc = c0 + c;          // global extended column
      float ur = 0.f;
      float ui = 0.f;
      for (int s = 0; s < tau; ++s) {
        const float pr = p_r[(t + s) * PLD + c];
        const float pi = p_i[(t + s) * PLD + c];
        const float cw = __ldg(wc + s * kx + gc);
        const float sw = __ldg(ws + s * kx + gc);
        ur += pr * cw - pi * sw;
        ui += pr * sw + pi * cw;
      }
      const float h = (q == 1) ? 0.5f : -0.25f;
      xr += h * ur;
      xi += h * ui;
      if (q == 1) {
        br = ur;
        bi = ui;
      }
    }
    if (kBox) {
      box[(static_cast<size_t>(slot) * rows + row) * nbins + bin] =
          br * br + bi * bi;
    }
    const int frame = row - lead;
    if (frame < 0 || frame >= num_frames) continue;
    const float power = xr * xr + xi * xi;
    db[(static_cast<size_t>(slot) * num_frames + frame) * nbins + bin] =
        10.f * log10f(1e-12f + power * scale);
  }
}

template <bool kBox>
int launch(const void* waves, const void* cos_m, const void* sin_m,
           const void* wc, const void* ws, void* db, void* box, int batch,
           int n, int hop, int kx, int nbins, int num_frames, int tau,
           int phi, float scale, void* stream) {
  if (batch == 0 || num_frames == 0 || nbins == 0) return cudaSuccess;
  const int rows = num_frames + (kBox ? 2 * (tau - 1) : 0);
  const int tm = BM - (tau - 1);
  const int tn = BN - 2 * phi;
  const dim3 grid((nbins + tn - 1) / tn, (rows + tm - 1) / tm, batch);
  waterfall_kernel<kBox><<<grid, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(waves),
      static_cast<const __nv_bfloat16*>(cos_m),
      static_cast<const __nv_bfloat16*>(sin_m),
      static_cast<const float*>(wc), static_cast<const float*>(ws),
      static_cast<float*>(db), static_cast<float*>(box), n, hop, kx, nbins,
      num_frames, tau, phi, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Tile shape, for the wrappers' checks: output rows per tile = BM - (tau -
// 1), bins per tile = BN - 2 phi.
int ft8_waterfall_tf_tile_rows() { return BM; }
int ft8_waterfall_tf_tile_cols() { return BN; }

// Launches the dB-only kernel on `stream`; returns cudaGetLastError().
//   waves (batch, n) f32; cos_m, sin_m (hop, kx) bf16; wc, ws (tau, kx)
//   f32; out (batch, num_frames, nbins) f32.  All contiguous on one card.
int ft8_waterfall_tf(const void* waves, const void* cos_m, const void* sin_m,
                     const void* wc, const void* ws, void* out, int batch,
                     int n, int hop, int kx, int nbins, int num_frames,
                     int tau, int phi, float scale, void* stream) {
  return launch<false>(waves, cos_m, sin_m, wc, ws, out, nullptr, batch, n,
                       hop, kx, nbins, num_frames, tau, phi, scale, stream);
}

// Launches the dual-output kernel on `stream`; returns cudaGetLastError().
//   As ft8_waterfall_tf, plus box (batch, num_frames + 2 (tau-1), nbins)
//   f32, the boxcar power grid.
int ft8_waterfall_mf_tf(const void* waves, const void* cos_m,
                        const void* sin_m, const void* wc, const void* ws,
                        void* db, void* box, int batch, int n, int hop,
                        int kx, int nbins, int num_frames, int tau, int phi,
                        float scale, void* stream) {
  return launch<true>(waves, cos_m, sin_m, wc, ws, db, box, batch, n, hop,
                      kx, nbins, num_frames, tau, phi, scale, stream);
}

const char* ft8_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
