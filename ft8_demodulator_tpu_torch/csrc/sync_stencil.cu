// Costas sync stencil over a dB waterfall, one thread per score cell,
// sm_90a.  Two instances of one template, by the layout of the grid:
//   * sync_kernel<true>, time-major (grid (B, T, F), scores (B, num_times,
//     num_freqs)): replaces ft8_demodulator_tpu/ops/sync_pallas_tf.py:162
//     `_kernel` (entry `sync_scores_tf_pallas` :190);
//   * sync_kernel<false>, frequency-major (grid (B, F, T), scores (B,
//     num_freqs, num_times)): replaces ft8_demodulator_tpu/ops/
//     sync_pallas.py:154 `_sync_kernel` (entry `sync_scores_padded` :189).
//
// Score cell (t, f), t = t_start + j the candidate's start frame (negative
// in the pre-roll), is the mean over the valid comparisons of [power of a
// Costas cell - power of a neighbour]: for Costas symbol k of sequence m
// (block b = 36 m + k, tone c = costas_tone(k)) with base = floor(t / tau),
//   cell valid  0 <= base + b < num_blocks:
//       +(cur - lo) + (cur - hi)   the frequency neighbours tone c -+ 1
//                                  (one of them at tone 0 and 7);
//   prev valid  cell valid, k > 0, base + b > 0:       +(cur - prev symbol)
//   next valid  cell valid, k < 6, base + b + 1 < num_blocks:
//                                                      +(cur - next symbol)
// where cur = grid[t + b tau, f + c phi], lo/hi the same frame at f + (c -+
// 1) phi, prev/next frames t + (b -+ 1) tau.  count is the number of those
// comparisons (it depends on t only); the score is total * (1 / max(count,
// 1)), -inf where count is 0.  A read of a frame outside [0, num_frames) is
// the zero padding of the plain version (the masks keep valid reads inside
// the grid when num_blocks * tau <= num_frames).
//
// Bit for bit with the plain PyTorch version (ops/sync.py
// `_sync_scores_tf_impl`): the terms are added in its order (the 21 cells
// in (m, k) order; per cell the frequency pair, then the previous, then the
// next symbol), each add and subtract rounded on its own (__fadd_rn /
// __fsub_rn are never fused), then one correctly rounded reciprocal and
// one multiply.  The plain version adds mask * term for every term; a term
// whose mask is 0 adds +-0 there, which leaves the sum unchanged (it starts
// at +0 and a round-to-nearest sum is never -0 unless both operands are),
// so skipping it gives the same bits for finite grids.
//
// What bounds it on the card: reads.  A cell takes up to 84 reads of the
// grid (~100 with the pre-roll masks computed in registers) for ~90 adds;
// neighbouring threads take neighbouring minor-axis cells (frequency for
// the time-major instance, time for the frequency-major one), so a warp's
// reads of one term are one contiguous row segment, and the ~84 row
// offsets a cell needs are shared by its neighbours through L1/L2.  One
// slot's grid is 1.4 MB (12 kHz, osr 2x2) to 5.7 MB (osr 4x4): a batch of
// them stays in the 50 MB L2.  No shared memory in this first version;
// the grid's strides are arguments, so a cropped view is read in place.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int NUM_SEQS = 3;        // Costas sequences per frame
constexpr int COSTAS_LEN = 7;
constexpr int SEQ_STRIDE = 36;     // symbols between sequence starts
constexpr int BX = 32;             // threads along the minor output axis
constexpr int BY = 8;              // threads along the major output axis

struct Geometry {
  int64_t sb, st, sf;     // element strides of the grid: batch, time, freq
  int num_frames;         // grid frames (reads outside are zero)
  int tau, phi, num_blocks, t_start, num_times, num_freqs;
};

// Tone of Costas symbol k (a compile-time constant in the unrolled loop).
__device__ __forceinline__ constexpr int costas_tone(int k) {
  constexpr int tones[COSTAS_LEN] = {3, 1, 4, 0, 6, 5, 2};
  return tones[k];
}

__device__ __forceinline__ int floor_div(int a, int b) {
  // C's / truncates toward zero; pre-roll times are negative
  const int q = a / b;
  return (q * b > a) ? q - 1 : q;
}

template <bool kTimeMajor>
__global__ void __launch_bounds__(BX * BY)
sync_kernel(const float* __restrict__ grid, float* __restrict__ out,
            Geometry g) {
  const int minor = blockIdx.x * BX + threadIdx.x;
  const int major = blockIdx.y * BY + threadIdx.y;
  const int j = kTimeMajor ? major : minor;       // score time index
  const int f = kTimeMajor ? minor : major;       // score frequency index
  if (j >= g.num_times || f >= g.num_freqs) return;

  const float* src = grid + static_cast<int64_t>(blockIdx.z) * g.sb
                     + static_cast<int64_t>(f) * g.sf;
  const int t = g.t_start + j;
  const int base = floor_div(t, g.tau);
  auto power = [&](int frame, int df) -> float {
    if (frame < 0 || frame >= g.num_frames) return 0.0f;
    return src[static_cast<int64_t>(frame) * g.st
               + static_cast<int64_t>(df) * g.sf];
  };

  float total = 0.0f;
  float count = 0.0f;
#pragma unroll
  for (int m = 0; m < NUM_SEQS; ++m) {
#pragma unroll
    for (int k = 0; k < COSTAS_LEN; ++k) {
      const int b = m * SEQ_STRIDE + k;
      const int tone = costas_tone(k);
      const int ba = base + b;
      if (ba < 0 || ba >= g.num_blocks) continue;   // cell invalid
      const int frame = t + b * g.tau;
      const float cur = power(frame, tone * g.phi);
      float freq;
      if (tone > 0 && tone < 7) {
        freq = __fadd_rn(__fsub_rn(cur, power(frame, (tone - 1) * g.phi)),
                         __fsub_rn(cur, power(frame, (tone + 1) * g.phi)));
        count = __fadd_rn(count, 2.0f);
      } else {
        const int other = tone > 0 ? tone - 1 : tone + 1;
        freq = __fsub_rn(cur, power(frame, other * g.phi));
        count = __fadd_rn(count, 1.0f);
      }
      total = __fadd_rn(total, freq);
      if (k > 0 && ba > 0) {
        total = __fadd_rn(total, __fsub_rn(cur, power(frame - g.tau,
                                                      tone * g.phi)));
        count = __fadd_rn(count, 1.0f);
      }
      if (k < COSTAS_LEN - 1 && ba + 1 < g.num_blocks) {
        total = __fadd_rn(total, __fsub_rn(cur, power(frame + g.tau,
                                                      tone * g.phi)));
        count = __fadd_rn(count, 1.0f);
      }
    }
  }

  const float score = count > 0.0f
      ? __fmul_rn(total, __frcp_rn(fmaxf(count, 1.0f)))
      : -INFINITY;
  const int64_t cells = static_cast<int64_t>(g.num_times) * g.num_freqs;
  const int64_t cell = kTimeMajor
      ? static_cast<int64_t>(j) * g.num_freqs + f
      : static_cast<int64_t>(f) * g.num_times + j;
  out[static_cast<int64_t>(blockIdx.z) * cells + cell] = score;
}

template <bool kTimeMajor>
int launch(const void* grid, void* out, int batch, const Geometry& g,
           void* stream) {
  if (batch == 0 || g.num_times == 0 || g.num_freqs == 0) return cudaSuccess;
  const int minor = kTimeMajor ? g.num_freqs : g.num_times;
  const int major = kTimeMajor ? g.num_times : g.num_freqs;
  const dim3 blocks((minor + BX - 1) / BX, (major + BY - 1) / BY, batch);
  sync_kernel<kTimeMajor><<<blocks, dim3(BX, BY), 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grid), static_cast<float*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the stencil on `stream`; returns cudaGetLastError().
//   grid: f32 dB waterfalls read at grid[b * sb + frame * st + bin * sf]
//   (any strides; batch <= 65535 in gridDim.z), with num_frames frames and
//   at least num_freqs + 7 phi bins;
//   out: contiguous f32, (batch, num_times, num_freqs) when time_major is
//   nonzero, else (batch, num_freqs, num_times).  out may not alias grid.
int ft8_sync_scores(const void* grid, void* out, int time_major, int batch,
                    long long sb, long long st, long long sf, int num_frames,
                    int tau, int phi, int num_blocks, int t_start,
                    int num_times, int num_freqs, void* stream) {
  const Geometry g{sb, st, sf, num_frames, tau, phi, num_blocks, t_start,
                   num_times, num_freqs};
  return time_major ? launch<true>(grid, out, batch, g, stream)
                    : launch<false>(grid, out, batch, g, stream);
}

}  // extern "C"
