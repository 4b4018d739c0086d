// Soft-symbol LLRs of candidate rows, sm_90a: the gather, Gray map,
// max-of-4 bit contrasts, mask and variance-24 scaling of a row in one
// kernel, one warp a row (K8).
//
// Replaces no TPU kernel: the JAX package reads these cells through one-hot
// matmuls that XLA fuses (ft8_demodulator_tpu/ops/llr.py
// `extract_llrs_tf`, `extract_llrs_matched_grid`).  Written out in PyTorch
// (ops/llr.py `_hann_llrs_plain`, `_grid_llrs_plain`, `normalize_llrs`) a
// call is ~45 small launches and seven host-to-card copies of index sets,
// each of which blocks the host; this kernel is the card form of both
// routes, one launch a call and no copy.
//
// Per row (candidate at frame t, bin f), for each of the 58 data symbols
// (position p = k + 7, or k + 14 from k = 29 on):
//   * Hann route: the dB grid's frame clamp(t + p * tau, 0, T - 1); the
//     symbol counts where floor(t / tau) + p lies in [0, num_blocks);
//   * matched route: the boxcar power grid's row r = t + p * tau + tau - 1;
//     the symbol counts where r lies in [0, T);
//   * s2[j] = the cell at bin f + gray[j] * phi of that frame or row (the
//     matched route takes 10 * log10(1e-12 + power) of it, float32, each
//     step rounded as PyTorch's elementwise ops round it);
//   * bit b (MSB first) of the symbol: the max of s2 over the j with bit b
//     set minus the max over the j with it clear (NaN propagates, as
//     `amax` does); a symbol that does not count gives three zeros.
// Then the row's 174 LLRs are scaled to variance 24, two passes: mean =
// sum / 174, var = sum((x - mean)^2) / 174, scale = sqrt((1 / max(var,
// 1e-30)) * 24) (PyTorch's `24.0 / var` is a reciprocal and a product).
// The sums run in another order than PyTorch's reductions, so the scale
// may differ from the plain version's by a few ulp; the LLRs before
// scaling are the plain version's bit for bit.  Every float operation is an
// explicitly rounded intrinsic, so nvcc fuses none into an FMA.
//
// The grid is read through its strides: a time-major (T, F) grid has
// (F, 1), the frequency-major one read as its transpose (1, T), a crop
// whatever its parent's are.  A cell is addressed as the plain version's
// flat gather addresses it, frame * F + bin: a bin past F reads the next
// frame's cell, as there; a flat index outside the grid, where the plain
// gather raises, reads NaN.  The grid holds fewer than 2^31 cells (the
// wrapper refuses more), so the divisions run in 32 bits: a 64-bit one is
// a called subroutine, whose frame spilled.
//
// What bounds it on the card: bytes, 1,856 read and 696 written a row
// (320 rows a decode_slots chunk: 0.82 MB, 0.24 us at 3.35 TB/s); the
// work is a launch's worth.  Lane l takes symbols l and l + 32, so a
// warp's loads of one tone are 32 frames of one column (tau frames apart);
// the row's mean and variance are butterfly shuffles; nothing is staged in
// memory.  The symbol positions are compiled in; the Gray map is read from
// the card (the caller's buffer, copied there once).

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int N = 174;             // LLRs a row
constexpr int DATA = 58;           // data symbols
constexpr int TONES = 8;
constexpr int WARPS = 8;           // rows a thread block
constexpr unsigned FULL = 0xffffffffu;

static_assert(3 * DATA == N && DATA <= 64, "two symbols a lane");

// frame position of data symbol k (protocol/constants.py
// DATA_SYMBOL_POSITIONS)
__device__ __forceinline__ int data_symbol(int k) {
  return k + (k < 29 ? 7 : 14);
}

// floor(a / b) for b > 0
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return a % b < 0 ? q - 1 : q;
}

// max that propagates NaN, as torch.amax does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float max4(float a, float b, float c, float d) {
  return nan_max(nan_max(a, b), nan_max(c, d));
}

// the sum over the warp: a butterfly, so every lane holds the same total
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(FULL, v, o));
  }
  return v;
}

// The three bit LLRs of data symbol s of a row at frame t (Hann route:
// block0 = floor(t / tau)); tone j's cell lies `step[j]` frames on and at
// element offset `col[j]` of the frame (the flat gather's address).
template <bool kMatched>
__device__ __forceinline__ float3 symbol_llrs(
    int s, const float* __restrict__ g, long long t, long long block0,
    const int (&step)[TONES], const long long (&col)[TONES], int frames,
    long long s_t, int tau, int num_blocks) {
  const long long p = data_symbol(s);
  long long r;
  bool counts;
  if (kMatched) {
    r = t + p * tau + tau - 1;
    counts = r >= 0 && r < frames;
  } else {
    counts = block0 + p >= 0 && block0 + p < num_blocks;
    r = t + p * tau;
    r = r < 0 ? 0 : (r > frames - 1 ? frames - 1 : r);
  }
  if (!counts) return make_float3(0.0f, 0.0f, 0.0f);
  float v[TONES];
#pragma unroll
  for (int j = 0; j < TONES; ++j) {
    const long long fr = r + step[j];
    float x = NAN;
    if (fr >= 0 && fr < frames) x = g[fr * s_t + col[j]];
    if (kMatched) x = __fmul_rn(10.0f, log10f(__fadd_rn(1e-12f, x)));
    v[j] = x;
  }
  return make_float3(__fsub_rn(max4(v[4], v[5], v[6], v[7]),
                               max4(v[0], v[1], v[2], v[3])),
                     __fsub_rn(max4(v[2], v[3], v[6], v[7]),
                               max4(v[0], v[1], v[4], v[5])),
                     __fsub_rn(max4(v[1], v[3], v[5], v[7]),
                               max4(v[0], v[2], v[4], v[6])));
}

// acc + x + y + z, in that order
__device__ __forceinline__ float add3(float acc, float3 v) {
  return __fadd_rn(__fadd_rn(__fadd_rn(acc, v.x), v.y), v.z);
}

__device__ __forceinline__ float3 minus(float3 v, float m) {
  return make_float3(__fsub_rn(v.x, m), __fsub_rn(v.y, m), __fsub_rn(v.z, m));
}

__device__ __forceinline__ float3 squared(float3 v) {
  return make_float3(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y),
                     __fmul_rn(v.z, v.z));
}

template <bool kMatched>
__global__ void __launch_bounds__(WARPS * 32)
llr_kernel(const float* __restrict__ grid, long long s_lead, long long s_t,
           long long s_f, int frames, int bins,
           const int32_t* __restrict__ abs_time,
           const int32_t* __restrict__ abs_freq, int k, int rows, int tau,
           int phi, int num_blocks, const long long* __restrict__ gray_map,
           float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;            // uniform over the warp
  const float* const g = grid + static_cast<long long>(row / k) * s_lead;
  const long long t = abs_time[row];
  const long long f = abs_freq[row];

  // tone j's bin as (frames to step, element offset in the frame) of the
  // flat gather's address; an offset beyond the grid's cells on either
  // side steps past every frame and reads NaN
  const long long cells = static_cast<long long>(frames) * bins;
  int step[TONES];
  long long col[TONES];
#pragma unroll
  for (int j = 0; j < TONES; ++j) {
    const long long off = f + gray_map[j] * phi;
    const bool inside = off >= -cells && off <= cells;
    const int q = inside ? floor_div(static_cast<int>(off), bins) : 0;
    step[j] = (!inside || q < -frames || q > frames) ? frames : q;
    col[j] = inside ? (off - static_cast<long long>(q) * bins) * s_f : 0;
  }
  const long long block0 = floor_div(static_cast<int>(t), tau);

  // lane l: symbols l and l + 32 (lanes 26-31 have no second)
  const bool second = lane + 32 < DATA;
  const float3 a = symbol_llrs<kMatched>(lane, g, t, block0, step, col,
                                         frames, s_t, tau, num_blocks);
  const float3 b = second
      ? symbol_llrs<kMatched>(lane + 32, g, t, block0, step, col, frames,
                              s_t, tau, num_blocks)
      : make_float3(0.0f, 0.0f, 0.0f);

  float sum = add3(0.0f, a);
  if (second) sum = add3(sum, b);
  const float mean = __fdiv_rn(warp_sum(sum), static_cast<float>(N));
  float squares = add3(0.0f, squared(minus(a, mean)));
  if (second) squares = add3(squares, squared(minus(b, mean)));
  float var = __fdiv_rn(warp_sum(squares), static_cast<float>(N));
  if (var < 1e-30f) var = 1e-30f;     // NaN stays NaN, as torch.clamp
  const float scale = __fsqrt_rn(__fmul_rn(__frcp_rn(var), 24.0f));

  float* const o = out + static_cast<size_t>(row) * N;
  o[3 * lane] = __fmul_rn(a.x, scale);
  o[3 * lane + 1] = __fmul_rn(a.y, scale);
  o[3 * lane + 2] = __fmul_rn(a.z, scale);
  if (second) {
    o[3 * (lane + 32)] = __fmul_rn(b.x, scale);
    o[3 * (lane + 32) + 1] = __fmul_rn(b.y, scale);
    o[3 * (lane + 32) + 2] = __fmul_rn(b.z, scale);
  }
}

}  // namespace

extern "C" {

// Launches the extraction on `stream`; returns cudaGetLastError().
//   grid: float32 cells of (lead, frames, bins) at strides (s_lead, s_t,
//   s_f) in elements; abs_time, abs_freq: (rows,) int32, row i of lead
//   index i / k; matched: 0 the Hann route (num_blocks read), 1 the boxcar
//   route; gray_map: the 8 int64 tones of the Gray order; out (rows, 174)
//   float32, contiguous.  All on one card; k >= 1, frames, bins, tau,
//   phi >= 1.
int ft8_llr_extract(const void* grid, long long s_lead, long long s_t,
                    long long s_f, int frames, int bins, const void* abs_time,
                    const void* abs_freq, int k, int rows, int tau, int phi,
                    int num_blocks, int matched, const void* gray_map,
                    void* out, void* stream) {
  if (rows == 0) return cudaSuccess;
  const dim3 blocks((rows + WARPS - 1) / WARPS);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const float*>(grid);
  const auto* t = static_cast<const int32_t*>(abs_time);
  const auto* f = static_cast<const int32_t*>(abs_freq);
  const auto* gray = static_cast<const long long*>(gray_map);
  auto* o = static_cast<float*>(out);
  if (matched) {
    llr_kernel<true><<<blocks, WARPS * 32, 0, s>>>(
        g, s_lead, s_t, s_f, frames, bins, t, f, k, rows, tau, phi,
        num_blocks, gray, o);
  } else {
    llr_kernel<false><<<blocks, WARPS * 32, 0, s>>>(
        g, s_lead, s_t, s_f, frames, bins, t, f, k, rows, tau, phi,
        num_blocks, gray, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
