// GF(2) Gaussian elimination of OSD bases, one warp per candidate, sm_90a.
//
// Replaces the TPU kernel in ft8_demodulator_tpu/ops/osd.py:212 (the
// kernel of `_reduce_basis_pallas_batch`, :189), which holds 128
// candidates on the lanes of one VMEM tile and walks the pivot steps with
// masked sublane reductions.
//
// Per candidate the input is the column-permuted, syndrome-augmented
// packed basis a[91][6] (bit j of row k in word j / 32, bit j % 32; code
// columns 0..173 in reliability order, CRC syndrome bits 174..187 riding
// along).  For columns j = 0, 1, ... the first row that has bit j and holds
// no pivot yet becomes column j's pivot; every other row with bit j is
// XORed with it.  The loop stops once 91 pivots are placed (the basis has
// rank 91, so later columns change nothing) or after column 173.  Outputs:
// the reduced rows and each row's pivot column (0 for a row without one).
// The result equals ops/osd.py `_reduce_basis_packed` bit for bit.
//
// What bounds it on the card: the sequential pivot chain.  A candidate is
// 2.2 KB in and 2.5 KB out, and at most 174 dependent steps of a few
// dozen integer instructions, so the kernel is latency-bound per
// candidate and needs many candidates in flight.  The design: a warp owns
// one candidate, with the 91 rows in registers (lane l holds rows l,
// l + 32 and l + 64: 18 words); per column, three __ballot_sync calls
// find the free rows with the bit and __ffs the lowest one, six
// __shfl_sync broadcast the pivot row, and each lane XORs it into its rows
// that have the bit.  No shared memory, no block-wide barrier; the word
// index of each column is a compile-time constant (the word loop is
// unrolled), so the rows never leave registers.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int K = 91;          // basis rows
constexpr int N = 174;         // scheduled code columns
constexpr int W = 6;           // 32-bit words per row
constexpr int GROUPS = 3;      // rows lane, lane + 32, lane + 64
constexpr int WARPS = 4;       // candidates per thread block
constexpr unsigned FULL = 0xffffffffu;

static_assert(GROUPS * 32 >= K && W * 32 >= N, "row and column budget");

__global__ void __launch_bounds__(WARPS * 32)
osd_eliminate_kernel(const uint32_t* __restrict__ in,
                     uint32_t* __restrict__ out,
                     int32_t* __restrict__ pcol_out, int count) {
  const int lane = threadIdx.x & 31;
  const int cand = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (cand >= count) return;          // uniform over the warp
  const uint32_t* a = in + static_cast<size_t>(cand) * K * W;

  uint32_t r[GROUPS][W];
  bool used[GROUPS];
  int pc[GROUPS];
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int row = g * 32 + lane;
    const bool valid = row < K;
#pragma unroll
    for (int w = 0; w < W; ++w) r[g][w] = valid ? a[row * W + w] : 0u;
    used[g] = !valid;                 // padding rows never pivot
    pc[g] = 0;
  }

  int pivots = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int nbits = (N - 32 * w < 32) ? N - 32 * w : 32;
    for (int b = 0; b < nbits && pivots < K; ++b) {
      bool bit[GROUPS];
      unsigned free_rows[GROUPS];
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) {
        bit[g] = (r[g][w] >> b) & 1u;
        free_rows[g] = __ballot_sync(FULL, bit[g] && !used[g]);
      }
      int gp;
      if (free_rows[0]) {
        gp = 0;
      } else if (free_rows[1]) {
        gp = 1;
      } else if (free_rows[2]) {
        gp = 2;
      } else {
        continue;                     // no pivot in this column
      }
      const int lp = __ffs(free_rows[gp]) - 1;
      uint32_t prow[W];
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const uint32_t v = gp == 0 ? r[0][k] : (gp == 1 ? r[1][k] : r[2][k]);
        prow[k] = __shfl_sync(FULL, v, lp);
      }
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) {
        const bool is_pivot = g == gp && lane == lp;
        if (is_pivot) {
          used[g] = true;
          pc[g] = 32 * w + b;
        } else if (bit[g]) {
#pragma unroll
          for (int k = 0; k < W; ++k) r[g][k] ^= prow[k];
        }
      }
      ++pivots;
    }
  }

  uint32_t* o = out + static_cast<size_t>(cand) * K * W;
  int32_t* p = pcol_out + static_cast<size_t>(cand) * K;
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int row = g * 32 + lane;
    if (row >= K) continue;
#pragma unroll
    for (int w = 0; w < W; ++w) o[row * W + w] = r[g][w];
    p[row] = pc[g];
  }
}

}  // namespace

extern "C" {

// Launches the elimination on `stream`; returns cudaGetLastError().
//   in, out (count, 91, 6) 32-bit words; pcol (count, 91) int32.  All
//   contiguous on one card; out may not alias in.
int ft8_osd_eliminate(const void* in, void* out, void* pcol, int count,
                      void* stream) {
  if (count == 0) return cudaSuccess;
  const dim3 grid((count + WARPS - 1) / WARPS);
  osd_eliminate_kernel<<<grid, WARPS * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
      static_cast<int32_t*>(pcol), count);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
