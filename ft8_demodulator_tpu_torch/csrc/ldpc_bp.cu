// LDPC(174,91) sum-product decode and CRC-14 of each candidate row, sm_90a:
// all of a row's BP iterations and its CRC in one kernel, one warp a row.
//
// Replaces no TPU kernel: the JAX package runs this loop as one jitted
// `lax.while_loop` (ft8_demodulator_tpu/ops/ldpc_decode.py:187,
// `bp_decode_batch`) and the CRC as a matmul (demod/decode.py
// `_crc_of_plain`), which XLA fuses.  Written out in PyTorch the loop is
// ~90 small launches an iteration and a host read of the all-halted flag
// (ops/ldpc_decode.py `bp_decode_batch_plain`); this kernel is its card
// form, and equals it bit for bit.
//
// Per row: check->variable messages tov (522 float32, slot-major: slot j
// of variable n at j * 174 + n) start at 0.  Each iteration
//   1. the variable walk: sum = ((llr + tov[n]) + tov[174 + n]) +
//      tov[348 + n], hard bit = sum > 0 (lane l holds variables l, l + 32,
//      ...; a ballot per group gives every lane the row's 174 bits in six
//      words); the zero-codeword test; the syndrome, one check a lane per
//      group: the parity of (bits AND the check's adjacency words), summed
//      by a ballot and popc (exact, as the plain version's float32 product
//      with 0/1 operands is);
//   2. the exit, where the plain version freezes the row: the all-zero
//      codeword (min_errors untouched), zero parity errors, or the last
//      iteration (whose message update nobody reads);
//   3. the check walk, one check a lane per group: for its <= 7 slots the
//      variable's value without this check, llr[n] + (tov[a] + tov[b])
//      with a < b the variable's two other slots, the Pade tanh of half its
//      negation (clamped at +-4.97, NaN kept), the exclusive prefix and
//      suffix products in the plain version's block order (a missing slot
//      is a factor 1: exact), and -2 * Pade atanh of each product, written
//      to the slot's tov entry after the whole warp has read the old ones.
// Then the epilogue: the last hard bits (plain, int32 0/1), min_errors,
// the CRC-14 of bits 0..76 (each CRC bit the parity of the payload AND
// its generator row) and the CRC-14 embedded in bits 77..90, and the
// row's iterations.  Every float operation is an explicitly rounded
// intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn), so nvcc fuses none into an
// FMA, and each is the same single rounding that PyTorch's elementwise op
// makes in the plain version.
//
// What bounds it on the card.  Operations: per row and iteration ~1,100
// Pade evaluations with a correctly rounded division each and ~40 more
// float32 operations a slot: about 30 k separately rounded operations, so
// 5,120 rows x 20 iterations are ~3 GFLOP, ~0.1 ms at the 33.5 T/s of
// unfused float32 operations.  Bytes are small (696 B of LLRs in, 716 B
// out a row).  The design keeps the chain of iterations on chip:
//   * a row's tov and LLRs live in shared memory (2.8 KB a warp) for all
//     its iterations; the tables (routing, adjacency, CRC: 4.5 KB) are
//     loaded once a block;
//   * each row leaves its loop at its own exit, so a batch where most
//     rows converge early costs what those rows need; the grid follows the
//     row count, 4 rows a block;
//   * everything a warp decides (exit, min_errors) comes from ballots, so
//     the loop is warp-uniform and needs no block barrier.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int M = 83;              // parity checks
constexpr int N = 174;             // code bits
constexpr int CD = 7;              // check slots
constexpr int VD = 3;              // variable slots
constexpr int NMI = M * CD;        // (slot, check) pairs, slot-major
constexpr int NNJ = N * VD;        // (slot, variable) pairs, slot-major
constexpr int VW = (N + 31) / 32;  // words of a row's bits: 6
constexpr int CG = (M + 31) / 32;  // check groups of a warp: 3
constexpr int CRC = 14;
constexpr int PAYLOAD = 77;
constexpr int CRC_W = (PAYLOAD + 31) / 32;   // words of a generator row: 3
// the table: routing words (mi = i * 83 + m: variable in bits 0..7, its
// slot j in bits 8..9, bit 10 set on a real slot), the adjacency (word w of
// check m at w * 83 + m), the CRC generator (row k, weight 2^(13 - k), at
// k * 3)
constexpr int ADJ_AT = NMI;
constexpr int CRC_AT = ADJ_AT + VW * M;
constexpr int TABLE_WORDS = CRC_AT + CRC * CRC_W;
constexpr uint32_t REAL = 1u << 10;
constexpr int WARPS = 4;           // rows a thread block
constexpr unsigned FULL = 0xffffffffu;

static_assert(VW * 32 >= N && CG * 32 >= M && VD == 3, "lane budget");
static_assert(PAYLOAD + CRC <= 3 * 32, "the embedded CRC lies in word 2");

// tanh, the rational form of ft8_lib over x clamped to +-4.97
__device__ __forceinline__ float pade_tanh(float x) {
  if (!isnan(x)) x = fminf(fmaxf(x, -4.97f), 4.97f);
  const float x2 = __fmul_rn(x, x);
  const float a = __fmul_rn(
      x, __fadd_rn(945.0f, __fmul_rn(x2, __fadd_rn(105.0f, x2))));
  const float b = __fadd_rn(
      945.0f, __fmul_rn(x2, __fadd_rn(420.0f, __fmul_rn(x2, 15.0f))));
  return __fdiv_rn(a, b);
}

// atanh, the rational form of ft8_lib
__device__ __forceinline__ float pade_atanh(float x) {
  const float x2 = __fmul_rn(x, x);
  const float a = __fmul_rn(
      x, __fadd_rn(945.0f, __fmul_rn(x2, __fadd_rn(-735.0f,
                                                    __fmul_rn(x2, 64.0f)))));
  const float b = __fadd_rn(
      945.0f, __fmul_rn(x2, __fadd_rn(-1050.0f, __fmul_rn(x2, 225.0f))));
  return __fdiv_rn(a, b);
}

__global__ void __launch_bounds__(WARPS * 32)
ldpc_bp_kernel(const float* __restrict__ llrs,
               const uint32_t* __restrict__ table,
               int32_t* __restrict__ plain_out,
               int32_t* __restrict__ stats, int rows, int max_iterations) {
  __shared__ uint32_t s_table[TABLE_WORDS];
  __shared__ float s_tov[WARPS][NNJ];
  __shared__ float s_llr[WARPS][N];
  for (int i = threadIdx.x; i < TABLE_WORDS; i += WARPS * 32) {
    s_table[i] = table[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= rows) return;            // uniform over the warp; no barrier
                                      // follows
  const uint32_t* const route = s_table;
  const uint32_t* const adj = s_table + ADJ_AT;
  float* const tov = s_tov[warp];
  float* const llr_s = s_llr[warp];

  float llr[VW];
#pragma unroll
  for (int k = 0; k < VW; ++k) {
    const int n = 32 * k + lane;
    llr[k] = 0.0f;
    if (n < N) {
      llr[k] = llrs[static_cast<size_t>(row) * N + n];
      llr_s[n] = llr[k];
#pragma unroll
      for (int j = 0; j < VD; ++j) tov[j * N + n] = 0.0f;
    }
  }
  __syncwarp();

  uint32_t hard[VW] = {0u, 0u, 0u, 0u, 0u, 0u};
  int min_errors = M;
  int it = 0;
  while (it < max_iterations) {
    ++it;
    // 1. the variable walk: hard decisions, zero codeword, syndrome
    uint32_t any = 0u;
#pragma unroll
    for (int k = 0; k < VW; ++k) {
      const int n = 32 * k + lane;
      bool bit = false;
      if (n < N) {
        const float sum = __fadd_rn(
            __fadd_rn(__fadd_rn(llr[k], tov[n]), tov[N + n]), tov[2 * N + n]);
        bit = sum > 0.0f;
      }
      hard[k] = __ballot_sync(FULL, bit);
      any |= hard[k];
    }
    int errors = 0;
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      const int m = 32 * g + lane;
      bool odd = false;
      if (m < M) {
        uint32_t x = 0u;
#pragma unroll
        for (int w = 0; w < VW; ++w) x ^= hard[w] & adj[w * M + m];
        odd = __popc(x) & 1;
      }
      errors += __popc(__ballot_sync(FULL, odd));
    }
    // 2. the exit (warp-uniform)
    if (any == 0u) break;             // the all-zero codeword
    min_errors = min(min_errors, errors);
    if (errors == 0 || it == max_iterations) break;

    // 3. the check walk: new messages into registers, then into tov
    float out[CG][CD];
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      const int m = 32 * g + lane;
      if (m >= M) continue;
      float toc[CD];
#pragma unroll
      for (int i = 0; i < CD; ++i) {
        const uint32_t r = route[i * M + m];
        toc[i] = 1.0f;
        if (r & REAL) {
          const int n = r & 0xff;
          const int j = (r >> 8) & 3;
          const int a = (j == 0 ? 1 : 0) * N + n;
          const int b = (j == 2 ? 1 : 2) * N + n;
          const float tnm = __fadd_rn(llr_s[n], __fadd_rn(tov[a], tov[b]));
          // -tnm / 2: both exact scalings of one rounding
          toc[i] = pade_tanh(__fmul_rn(tnm, -0.5f));
        }
      }
      float pre[CD], suf[CD];
      float acc = 1.0f;
#pragma unroll
      for (int i = 0; i < CD; ++i) {
        pre[i] = acc;
        acc = __fmul_rn(acc, toc[i]);
      }
      acc = 1.0f;
#pragma unroll
      for (int i = CD - 1; i >= 0; --i) {
        suf[i] = acc;
        acc = __fmul_rn(acc, toc[i]);
      }
#pragma unroll
      for (int i = 0; i < CD; ++i) {
        out[g][i] = __fmul_rn(-2.0f, pade_atanh(__fmul_rn(pre[i], suf[i])));
      }
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      const int m = 32 * g + lane;
      if (m >= M) continue;
#pragma unroll
      for (int i = 0; i < CD; ++i) {
        const uint32_t r = route[i * M + m];
        if (r & REAL) tov[((r >> 8) & 3) * N + (r & 0xff)] = out[g][i];
      }
    }
    __syncwarp();
  }

  // the epilogue: bits, min_errors, both CRCs, iterations
  int32_t* const p = plain_out + static_cast<size_t>(row) * N;
#pragma unroll
  for (int k = 0; k < VW; ++k) {
    const int n = 32 * k + lane;
    if (n < N) p[n] = (hard[k] >> lane) & 1u;
  }
  bool crc_bit = false;
  if (lane < CRC) {
    const uint32_t* const gen = s_table + CRC_AT + lane * CRC_W;
    const uint32_t x = (hard[0] & gen[0]) ^ (hard[1] & gen[1])
                       ^ (hard[2] & gen[2]);
    crc_bit = __popc(x) & 1;
  }
  // bit k of the CRC at lane k, weight 2^(13 - k): reversed into place
  const uint32_t crc_bits = __ballot_sync(FULL, crc_bit);
  if (lane == 0) {
    const uint32_t embedded = (hard[2] >> (PAYLOAD - 64)) & ((1u << CRC) - 1);
    stats[row] = min_errors;
    stats[rows + row] = static_cast<int32_t>(__brev(crc_bits) >> (32 - CRC));
    stats[2 * rows + row] =
        static_cast<int32_t>(__brev(embedded) >> (32 - CRC));
    stats[3 * rows + row] = it;
  }
}

}  // namespace

extern "C" {

// Launches the decode on `stream`; returns cudaGetLastError().
//   llrs (rows, 174) float32; table the TABLE_WORDS 32-bit words of
//   ops/ldpc_cuda.py `pack_table`; plain (rows, 174) int32; stats (4, rows)
//   int32: min_errors, computed CRC, embedded CRC, iterations.  All
//   contiguous on one card; max_iterations >= 0.
int ft8_ldpc_bp(const void* llrs, const void* table, void* plain,
                void* stats, int rows, int max_iterations, void* stream) {
  if (rows == 0) return cudaSuccess;
  const dim3 grid((rows + WARPS - 1) / WARPS);
  ldpc_bp_kernel<<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(llrs), static_cast<const uint32_t*>(table),
      static_cast<int32_t*>(plain), static_cast<int32_t*>(stats), rows,
      max_iterations);
  return static_cast<int>(cudaGetLastError());
}

// The words of the table the kernel reads (checked by the wrapper).
int ft8_ldpc_table_words() { return TABLE_WORDS; }

}  // extern "C"
