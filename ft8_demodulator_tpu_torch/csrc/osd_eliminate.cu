// OSD bases from the reliability order, sm_90a: permute, pack and GF(2)-
// eliminate the code's basis in one kernel, one warp per candidate.
//
// Replaces the TPU kernel in ft8_demodulator_tpu/ops/osd.py:212 (the
// kernel of `_reduce_basis_pallas_batch`, :189) together with the
// permute-pack that feeds it there (`_permute_pack`, :90).  The JAX package
// permutes outside its kernel only because Mosaic ran a per-lane dynamic
// column schedule ~5x slower than a static one; on this card the natural
// basis fits in shared memory, and each warp builds its own permuted rows.
//
// Per candidate the input is its reliability order: order[i] is the code
// column at sorted position i (a permutation of 0..173, int64 as torch.sort
// gives it).  The permuted, syndrome-augmented basis a[91][6] has bit i of
// row k (word i / 32, bit i % 32) equal to basis[k][order[i]] for i < 174,
// and the row's 14 CRC syndrome bits in bits 174..187.  For columns j = 0,
// 1, ... the first row that has bit j and holds no pivot yet becomes column
// j's pivot; every other row with bit j is XORed with it.  The loop stops
// once 91 pivots are placed (the basis has rank 91, so later columns change
// nothing) or after column 173.  Outputs: the reduced rows (count, 91, 6)
// and each row's pivot column (count, 91), 0 for a row without one.  The
// result equals ops/osd_cuda.py `reduce_basis_from_order_plain` bit for
// bit.
//
// What bounds it on the card.  The bytes: 1.4 KB of order in and 2.5 KB out
// per candidate (28.6 MB for the 7,260 rows of a DEEP batch, 8.5 us at
// 3.35 TB/s).  What keeps it above that: the pivot chain, ~105 dependent
// steps per candidate (91 pivots and the columns without one) of ~45-55
// warp instructions each (three ballots, a find-first-set, the pivot row's
// broadcast, the XORs; cuobjdump), ~30-40 of them on the SM's integer pipe,
// which takes two clocks per warp instruction: ~3.7 k integer instructions
// per candidate, ~100 k clocks of the 528 sub-partitions for a DEEP batch.
// The design keeps that pipe fed:
//   * one launch for all of a call's candidates (a DEEP batch is 7,260
//     warps), 4 warps a block; ptxas gives 48 registers and no spills, so
//     10 blocks (40 warps) an SM hide one another's chains;
//   * the table (174 column masks of 3 words of row bits, then the 91 row
//     syndrome words: 2.5 KB) is loaded into shared memory once a block;
//   * building the rows: for word w, lane l reads order[32 w + l]
//     (coalesced) and that column's three mask words (rows 0-31, 32-63,
//     64-90); a 32 x 32 bit transpose across the warp (5 rounds of a
//     shuffle, a rotate and a bit select) turns the lanes' columns into
//     word w of their rows.  Lane l then holds rows l, l + 32 and l + 64 in
//     18 registers;
//   * the elimination: per column three ballots give the rows that have
//     the bit, the pivot flags are warp-uniform lane masks, so the free
//     rows are one AND-NOT and the pivot one find-first-set.  Every free
//     row is zero in all columns before j, the pivot row too, so only its
//     words w .. 5 are broadcast and XORed.  The word loop is unrolled and
//     the pivot's row group selects one of three code paths, so every
//     register index is a compile-time constant;
//   * the output: lane l stores its rows' words (8-byte stores, rows 24
//     bytes apart) and pivot columns (coalesced).  Staging the rows in
//     shared memory for 8-byte stores on consecutive addresses, 8 or 2
//     warps a block, or no minimum of blocks an SM all timed within noise
//     of this (NVIDIA H100 80GB HBM3): the pivot chain sets the time.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int K = 91;          // basis rows
constexpr int N = 174;         // code columns
constexpr int W = 6;           // 32-bit words per row
constexpr int GROUPS = 3;      // rows lane, lane + 32, lane + 64
constexpr int WARPS = 4;       // candidates per thread block
constexpr int MIN_BLOCKS = 8;  // blocks an SM: at most 64 registers a thread
constexpr int TABLE_WORDS = GROUPS * N + K;
constexpr unsigned FULL = 0xffffffffu;

static_assert(GROUPS * 32 >= K && W * 32 >= N + 14, "row and column budget");

// A 32 x 32 bit matrix held one row a lane, transposed: lane l returns the
// word whose bit c is bit l of lane c's word.  Round s swaps the
// off-diagonal s x s blocks: a lane keeps its bits c with (c & s) == (lane
// & s) and takes the others from lane ^ s, rotated by s into place.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const uint32_t hi = s == 16 ? 0xffff0000u : s == 8 ? 0xff00ff00u
                        : s == 4 ? 0xf0f0f0f0u : s == 2 ? 0xccccccccu
                        : 0xaaaaaaaau;               // bits c with c & s
    const bool up = lane & s;
    const uint32_t keep = up ? hi : ~hi;
    const uint32_t y = __shfl_xor_sync(FULL, x, s);
    const uint32_t t = __funnelshift_l(y, y, up ? 32 - s : s);  // rotate
    x = (x & keep) | (t & ~keep);
  }
  return x;
}

__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
osd_eliminate_kernel(const int64_t* __restrict__ order,
                     const uint32_t* __restrict__ table,
                     uint32_t* __restrict__ out,
                     int32_t* __restrict__ pcol_out, int count) {
  __shared__ uint4 s_cols[N];                      // column n's row bits
  __shared__ uint32_t s_synd[K];                   // row syndromes, word 5
  for (int i = threadIdx.x; i < N; i += WARPS * 32) {
    s_cols[i] = make_uint4(table[GROUPS * i], table[GROUPS * i + 1],
                           table[GROUPS * i + 2], 0u);
  }
  for (int i = threadIdx.x; i < K; i += WARPS * 32) {
    s_synd[i] = table[GROUPS * N + i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int cand = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (cand >= count) return;          // uniform over the warp; no barrier
                                      // follows
  // the permuted rows: r[g][w] is word w of row 32 g + lane
  const int64_t* const ord = order + static_cast<size_t>(cand) * N;
  uint64_t col[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int pos = 32 * w + lane;
    col[w] = pos < N ? static_cast<uint64_t>(ord[pos]) : N;
  }
  uint32_t r[GROUPS][W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    // a row of order is a permutation of 0..N-1 (N marks the positions
    // past 173); an index outside it reads as an empty column
    const uint4 m = col[w] < N ? s_cols[col[w]] : make_uint4(0u, 0u, 0u, 0u);
    r[0][w] = transpose32(m.x, lane);
    r[1][w] = transpose32(m.y, lane);
    r[2][w] = transpose32(m.z, lane);
  }
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int row = 32 * g + lane;
    if (row < K) r[g][W - 1] |= s_synd[row];
  }

  // pivot flags as warp-uniform lane masks (rows 91..95 hold no row)
  uint32_t used[GROUPS] = {0u, 0u, FULL << (K - 64)};
  int pc[GROUPS] = {0, 0, 0};
  int pivots = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int nbits = N - 32 * w < 32 ? N - 32 * w : 32;
#pragma unroll 1
    for (int b = 0; b < nbits && pivots < K; ++b) {
      const uint32_t bit = 1u << b;
      bool has[GROUPS];
      uint32_t free_rows[GROUPS];
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) {
        has[g] = r[g][w] & bit;
        free_rows[g] = __ballot_sync(FULL, has[g]) & ~used[g];
      }
      // column 32 w + b's pivot in row group G: broadcast its words w..5
      // and XOR them into every other row that has the bit
      auto pivot = [&](auto group) {
        constexpr int G = decltype(group)::value;
        const int lp = __ffs(free_rows[G]) - 1;
        used[G] |= 1u << lp;
        if (lane == lp) {
          pc[G] = 32 * w + b;
          has[G] = false;
        }
        uint32_t prow[W];
#pragma unroll
        for (int k = w; k < W; ++k) prow[k] = __shfl_sync(FULL, r[G][k], lp);
#pragma unroll
        for (int g = 0; g < GROUPS; ++g) {
          if (has[g]) {
#pragma unroll
            for (int k = w; k < W; ++k) r[g][k] ^= prow[k];
          }
        }
      };
      if (free_rows[0]) {
        pivot(std::integral_constant<int, 0>());
      } else if (free_rows[1]) {
        pivot(std::integral_constant<int, 1>());
      } else if (free_rows[2]) {
        pivot(std::integral_constant<int, 2>());
      } else {
        continue;                     // no pivot in this column
      }
      ++pivots;
    }
  }

  uint32_t* const o = out + static_cast<size_t>(cand) * K * W;
  int32_t* const p = pcol_out + static_cast<size_t>(cand) * K;
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int row = 32 * g + lane;
    if (row >= K) continue;
#pragma unroll
    for (int w = 0; w < W; w += 2) {
      *reinterpret_cast<uint2*>(o + row * W + w) =
          make_uint2(r[g][w], r[g][w + 1]);
    }
    p[row] = pc[g];
  }
}

}  // namespace

extern "C" {

// Launches the reduction on `stream`; returns cudaGetLastError().
//   order (count, 174) int64, each row a permutation of 0..173; table the
//   3 * 174 + 91 32-bit words of OSDTables.basis_cols; out (count, 91, 6)
//   32-bit words; pcol (count, 91) int32.  All contiguous on one card.
int ft8_osd_reduce(const void* order, const void* table, void* out,
                   void* pcol, int count, void* stream) {
  if (count == 0) return cudaSuccess;
  const dim3 grid((count + WARPS - 1) / WARPS);
  osd_eliminate_kernel<<<grid, WARPS * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(order),
      static_cast<const uint32_t*>(table), static_cast<uint32_t*>(out),
      static_cast<int32_t*>(pcol), count);
  return static_cast<int>(cudaGetLastError());
}

// The words of the table the kernel reads (checked by the wrapper).
int ft8_osd_table_words() { return TABLE_WORDS; }

}  // extern "C"
