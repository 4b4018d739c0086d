// Ordered-statistics decoding on the card, sm_90a (K4): one kernel takes a
// call's LLRs and need mask and returns each needed row's OSD codeword and
// its accept flag, one warp per row; a second entry gives the reduced bases
// alone.
//
// Replaces the TPU kernel in ft8_demodulator_tpu/ops/osd.py:276 (the
// pallas_call of `_reduce_basis_pallas_batch`, :189, the GF(2)
// elimination) together with the permute-pack that feeds it there
// (`_permute_pack`, :90), and absorbs the JAX package's search around it
// (`_osd_tail`, :313): the reliability sort, the order-0/1/2/3 candidates
// with their CRC-14 check and soft-distance gate, and the winner's codeword.
// The plain version is ops/osd.py's CPU route (`_osd_rows`: torch.sort,
// ops/osd_cuda.py `reduce_basis_from_order_plain`, `_osd_tail`); the
// reduced bases equal it bit for bit, and the decisions too except where a
// row's float32 distances tie within a few ulp (their sums run in another
// order).
//
// Per row (osd_decode_kernel):
//   * the stable reliability order: position p of the order holds the bit
//     with the p-th largest |LLR|, ties by natural index (torch.sort(-|x|,
//     stable=True), lax.sort).  The keys are the |LLR| bit patterns plus
//     one (unsigned order = float order; +0.0 and -0.0 one key), and 0 for
//     NaN, which torch.sort puts last; lane l ranks
//     its bits l + 32 k by counting the keys above each, and the equal keys
//     of lower index, read from shared memory (a broadcast per key);
//   * the permuted, syndrome-augmented basis a[91][6]: bit p of row k (word
//     p / 32, bit p % 32) is basis[k][order[p]], and the row's 14 CRC
//     syndrome bits sit in bits 174..187; for columns j = 0, 1, ... the
//     first row that has bit j and holds no pivot yet becomes column j's
//     pivot, and every other row with bit j is XORed with it (stops at 91
//     pivots: the basis has rank 91);
//   * the search, with the reduced rows still in the lanes' registers (lane
//     l holds rows l, l + 32, l + 64): the order-0 codeword c0 is the XOR of
//     the rows whose pivot bit is 1 in the hard decision; a flip f (one row,
//     a pair of the `order2` rows with the largest pivot columns, a triple
//     of its first `order3`) gives c0 ^ f.  Its distance is `_osd_tail`'s
//     formula: dist0 + the rows' corrections delta = sum(f * u), u = w (1 -
//     2 d0), minus twice the pairs' overlaps, plus four times the triple's
//     (float32 sums: a row's correction over its set bits in column order,
//     an overlap as lane sums added across the warp); its CRC the XOR of
//     14-bit syndromes; the all-zero guard a
//     popcount of c0 ^ f (`_osd_tail`'s ones counts are exact small
//     integers, equal to it).  A candidate is admissible if its CRC holds,
//     it is not zero and dist <= lam * (sum w - sum of the pivots' w).  The
//     winner is the smallest admissible distance, first in `_osd_tail`'s
//     index order on ties (order 0, rows, pairs (i, j) at i * order2 + j,
//     triples in combinations order); none admissible returns c0 with ok 0;
//   * the codeword goes out in natural bit order (bit i from sorted
//     position rank(i)), 174 int32 a row; an unneeded row writes zeros.
//
// What bounds it on the card.  The bytes: a needed row's 696 B of LLRs in,
// every row's need flag in and 697 B out (9.7 MB for deep.weak's 3,620
// needed rows of 10,240, 2.9 us at 3.35 TB/s).  What keeps it above that
// (177 us there; 46-74 us a call at 40-1,678 rows; NVIDIA H100 80GB HBM3,
// 700 W): each row's chain of dependent steps on one warp:
// the elimination's ~105 pivot steps (three ballots, a find-first-set, the
// pivot row's broadcast, the XORs), the ranking (174 keys x 6 compares a
// lane), and the search's float sums (174 columns for the rows'
// corrections, a butterfly for each of ~120 pairs at order2 16).  The
// design keeps the chains short and many rows in flight, and the host out
// of it:
//   * one launch for all of an OSD call's rows, needed or not; a block is
//     one warp and one row, so an unneeded row (zeros out) frees its slot at
//     once and a needed one holds only its own: ~25 rows an SM at 80
//     registers and 10.6 KB of shared memory (the 2.5 KB basis table, 174
//     column masks of 3 words of row bits and the 91 row syndrome words,
//     then the row's scratch), and the dynamic order3 x order3 overlaps
//     only where triples are searched;
//   * nothing of a row leaves the SM between the LLRs and the codeword: the
//     order, the sorted LLRs, u, the order-2 rows and their overlaps live
//     in shared memory, the reduced rows in registers;
//   * building the rows: for word w, lane l reads its column's three mask
//     words (rows 0-31, 32-63, 64-90); a 32 x 32 bit transpose across the
//     warp (5 rounds of a shuffle, a rotate and a bit select) turns the
//     lanes' columns into word w of their rows;
//   * the elimination keeps the pivot flags as warp-uniform lane masks, so
//     the free rows are one AND-NOT and the pivot one find-first-set; only
//     the pivot row's words w .. 5 are broadcast and XORed (every free row
//     is zero before column j); the pivot's row group selects one of three
//     code paths, so every register index is a compile-time constant;
//   * the ranking reads four keys a shared-memory load;
//   * the corrections: one pass over the 174 columns, u read once a column
//     (a broadcast) and added to each of the lane's three rows' sums where
//     its bit is set (+0.0 elsewhere: the sum in column order);
//   * the overlaps: the order-2 rows transposed into column masks (lane l,
//     bit t: row t has column 32 w + l), so a pair's (or a triple's)
//     overlap is each lane's sum over its six columns and a 5-step
//     butterfly, four pairs interleaved; lane j checks pairs (i, j)'s CRC
//     and guard and offers them, lane k the triples (i, j, k);
//   * each lane keeps its best (distance key, index), and two warp
//     min-reductions pick the winner, whose flip is read back from
//     registers or shared memory.
// The search's limits are compile-time: order2 <= MAX_ORDER2 (32) and
// order3 <= order2; the wrapper refuses more.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int K = 91;          // basis rows
constexpr int N = 174;         // code columns
constexpr int W = 6;           // 32-bit words per row
constexpr int GROUPS = 3;      // rows lane, lane + 32, lane + 64
constexpr int WARPS = 4;       // candidates per block (elimination only)
// the search: a block is one warp, one row; up to 24 blocks an SM (at most
// 85 registers a thread)
constexpr int DECODE_MIN_BLOCKS = 24;
constexpr int TABLE_WORDS = GROUPS * N + K;
constexpr int MAX_ORDER2 = 32;  // one order-2 row a lane
constexpr int SYND_SHIFT = N - 32 * (W - 1);      // syndrome bit 0 in word 5
constexpr uint32_t SYND_MASK = (1u << 14) - 1;
constexpr uint32_t CODE_TAIL = (1u << SYND_SHIFT) - 1;  // code bits, word 5
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NO_KEY = 0xffffffffu;          // not admissible

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

// The basis table in shared memory: column n's row bits, the row syndromes.
struct Table {
  uint4 cols[N];
  uint32_t synd[K];
};

__device__ __forceinline__ void load_table(Table& t,
                                           const uint32_t* __restrict__ g) {
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    t.cols[i] = make_uint4(g[GROUPS * i], g[GROUPS * i + 1],
                           g[GROUPS * i + 2], 0u);
  }
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    t.synd[i] = g[GROUPS * N + i];
  }
}

// The permuted rows, reduced: col[w] is the natural column at sorted
// position 32 w + lane (N past position 173).  On return r[g][w] is word w
// of reduced row 32 g + lane and pc[g] its pivot column (rows 91..95 are
// zero rows without one).
__device__ __forceinline__ void reduce_rows(const Table& t,
                                            const int (&col)[W], int lane,
                                            uint32_t (&r)[GROUPS][W],
                                            int (&pc)[GROUPS]) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint4 m = col[w] < N ? t.cols[col[w]] : make_uint4(0u, 0u, 0u, 0u);
    r[0][w] = transpose32(m.x, lane);
    r[1][w] = transpose32(m.y, lane);
    r[2][w] = transpose32(m.z, lane);
  }
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int row = 32 * g + lane;
    if (row < K) r[g][W - 1] |= t.synd[row];
    pc[g] = 0;
  }

  // pivot flags as warp-uniform lane masks (rows 91..95 hold no row)
  uint32_t used[GROUPS] = {0u, 0u, FULL << (K - 64)};
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
}

// Elimination only: reliability orders in, reduced bases and pivot columns
// out (ops/osd_cuda.py reduce_basis_from_order).
__global__ void __launch_bounds__(WARPS * 32, 8)
osd_eliminate_kernel(const int64_t* __restrict__ order,
                     const uint32_t* __restrict__ table,
                     uint32_t* __restrict__ out,
                     int32_t* __restrict__ pcol_out, int count) {
  __shared__ Table s_t;
  load_table(s_t, table);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int cand = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (cand >= count) return;          // uniform over the warp; no barrier
                                      // follows
  // a row of order is a permutation of 0..N-1; an index outside it reads
  // as an empty column
  const int64_t* const ord = order + static_cast<size_t>(cand) * N;
  int col[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int pos = 32 * w + lane;
    const uint64_t c = pos < N ? static_cast<uint64_t>(ord[pos]) : N;
    col[w] = c < N ? static_cast<int>(c) : N;
  }
  uint32_t r[GROUPS][W];
  int pc[GROUPS];
  reduce_rows(s_t, col, lane, r, pc);

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

// A warp's scratch for one row of the search (and, in dynamic shared
// memory after it, the order3 x order3 overlaps of the triples' pairs).
struct Scratch {
  alignas(16) uint32_t mag[W * 32];   // |LLR| bits, natural order
  float llr[W * 32];                  // LLRs in reliability order
  float u[W * 32];                    // w (1 - 2 d0), reliability order
  uint8_t order[W * 32];              // natural bit at each position
  uint32_t sub[MAX_ORDER2][W];        // order-2 rows, largest pivot first
  float dsub[MAX_ORDER2];             // their corrections delta
  uint32_t win[W];                    // the winner, reliability order
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x = __fadd_rn(x, __shfl_xor_sync(FULL, x, s));
  return x;
}

// Four sums of u over the columns where every order-2 row named in
// rows[e] (a mask of their indices) has a bit: lane l adds its columns l +
// 32 w in order of w from +0.0, then the warp adds the lanes' sums
// (butterfly), the four interleaved.  colbits[w] bit t: order-2 row t has
// column 32 w + lane; uc[w]: u there.
__device__ __forceinline__ void overlaps4(const uint32_t (&colbits)[W],
                                          const float (&uc)[W],
                                          const uint32_t (&rows)[4],
                                          float (&out)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    out[e] = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      out[e] = __fadd_rn(out[e],
                         (colbits[w] & rows[e]) == rows[e] ? uc[w] : 0.f);
    }
  }
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      out[e] = __fadd_rn(out[e], __shfl_xor_sync(FULL, out[e], sh));
    }
  }
}

// code bits set in m (the all-zero guard)
__device__ __forceinline__ int code_weight(const uint32_t (&m)[W]) {
  int n = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) n += __popc(w == W - 1 ? m[w] & CODE_TAIL : m[w]);
  return n;
}

__device__ __forceinline__ uint32_t syndrome(const uint32_t (&m)[W]) {
  return (m[W - 1] >> SYND_SHIFT) & SYND_MASK;
}

// unsigned keys in the floats' order (+0.0 and -0.0 one key); a candidate
// that is not admissible, or not finite, gets NO_KEY
__device__ __forceinline__ unsigned dist_key(float d, bool admissible) {
  if (!admissible || !(fabsf(d) <= 3.402823466e38f)) return NO_KEY;
  const uint32_t b = __float_as_uint(d == 0.f ? 0.f : d);
  return b & 0x80000000u ? ~b : b | 0x80000000u;
}

// The best candidate a lane has seen: its key, index and flip (kind in the
// top byte: 0 none, 1 a row, 2 a pair, 3 a triple; rows or order-2 indices
// in the low bytes).
struct Best {
  unsigned key = NO_KEY;
  int index = INT_MAX;
  uint32_t flip = 0u;
  __device__ __forceinline__ void offer(float d, bool admissible, int i,
                                        uint32_t f) {
    const unsigned k = dist_key(d, admissible);
    if (k < key || (k == key && k != NO_KEY && i < index)) {
      key = k;
      index = i;
      flip = f;
    }
  }
};

__global__ void __launch_bounds__(32, DECODE_MIN_BLOCKS)
osd_decode_kernel(const float* __restrict__ llr,
                  const bool* __restrict__ need,
                  const uint32_t* __restrict__ table,
                  int32_t* __restrict__ plain, bool* __restrict__ ok,
                  float lam, int order2, int order3) {
  __shared__ Table s_t;
  __shared__ Scratch s;
  extern __shared__ float s_ov[];     // [order3][order3]

  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  int32_t* const out = plain + static_cast<size_t>(row) * N;
  if (need != nullptr && !need[row]) {  // the block's one warp leaves
    for (int i = lane; i < N; i += 32) out[i] = 0;
    if (lane == 0) ok[row] = false;
    return;
  }
  load_table(s_t, table);

  // the stable reliability order: rank(i) = #{j: m_j > m_i} + #{j < i: m_j
  // == m_i}, m the |LLR| bits plus one, 0 for NaN (last, as torch.sort)
  const float* const x = llr + static_cast<size_t>(row) * N;
  float v[W];
  uint32_t m[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int i = 32 * k + lane;
    v[k] = i < N ? x[i] : 0.f;
    m[k] = i < N && v[k] == v[k]
               ? (__float_as_uint(v[k]) & 0x7fffffffu) + 1u : 0u;
    s.mag[i] = m[k];
  }
  __syncthreads();                    // the table and the keys
  // four keys a load; the two zero keys past bit 173 come after every bit
  // and are greater than none, so they count for nothing
  const uint4* const mag4 = reinterpret_cast<const uint4*>(s.mag);
  int rank[W] = {0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int jb = 0; jb < W; ++jb) {
    const int nq = jb == W - 1 ? (N - 32 * (W - 1) + 3) / 4 : 8;
#pragma unroll 2
    for (int q = 0; q < nq; ++q) {
      const uint4 kq = mag4[8 * jb + q];
      const uint32_t keys[4] = {kq.x, kq.y, kq.z, kq.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = 4 * q + e;
        const uint32_t mj = keys[e];
#pragma unroll
        for (int k = 0; k < W; ++k) {
          if (jb < k) {
            rank[k] += mj >= m[k];
          } else if (jb > k) {
            rank[k] += mj > m[k];
          } else {
            rank[k] += (mj > m[k]) | ((mj == m[k]) & (jj < lane));
          }
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if (32 * k + lane < N) {
      s.order[rank[k]] = static_cast<uint8_t>(32 * k + lane);
      s.llr[rank[k]] = v[k];
    }
  }
  __syncwarp();

  uint32_t r[GROUPS][W];
  int pc[GROUPS];
  {
    int col[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int p = 32 * w + lane;
      col[w] = p < N ? s.order[p] : N;
    }
    reduce_rows(s_t, col, lane, r, pc);
  }

  // the order-0 codeword, its distance and the gate
  uint32_t base[W], d0[W];
  float dist0 = 0.f, total = 0.f, pivsum = 0.f;
  {
    bool sel[GROUPS];
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      const bool real = 32 * g + lane < K;
      const float pl = s.llr[pc[g]];
      sel[g] = real && pl > 0.f;
      if (real) pivsum = __fadd_rn(pivsum, fabsf(pl));
    }
#pragma unroll
    for (int w = 0; w < W; ++w) {
      uint32_t c = 0u;
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) c ^= sel[g] ? r[g][w] : 0u;
      base[w] = __reduce_xor_sync(FULL, c);
    }
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int p = 32 * w + lane;
      const float lv = s.llr[p < N ? p : 0];
      const float wt = p < N ? fabsf(lv) : 0.f;
      const uint32_t hard = __ballot_sync(FULL, p < N && lv > 0.f);
      d0[w] = (base[w] ^ hard) & (w == W - 1 ? CODE_TAIL : FULL);
      const bool d = (d0[w] >> lane) & 1u;
      total = __fadd_rn(total, wt);
      if (d) dist0 = __fadd_rn(dist0, wt);
      s.u[p] = d ? -wt : wt;
    }
    dist0 = warp_sum(dist0);
    total = warp_sum(total);
    pivsum = warp_sum(pivsum);
  }
  const float gate = __fmul_rn(lam, __fsub_rn(total, pivsum));
  const uint32_t s_base = syndrome(base);
  __syncwarp();

  Best best;
  if (lane == 0) {
    best.offer(dist0, s_base == 0u && code_weight(base) > 0 && dist0 <= gate,
               0, 0u);
  }

  // order 1: the rows; each row's correction delta sums u over its code
  // bits in column order (+0.0 where a bit is clear), the lane's three rows
  // together; the order-2 rows go to shared memory
  float delta[GROUPS] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int nb = w == W - 1 ? N - 32 * (W - 1) : 32;
#pragma unroll
    for (int b = 0; b < nb; ++b) {
      const float uv = s.u[32 * w + b];
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) {
        delta[g] = __fadd_rn(delta[g], (r[g][w] >> b) & 1u ? uv : 0.f);
      }
    }
  }
  uint32_t pmask[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    uint32_t c = 0u;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      if (32 * g + lane < K && (pc[g] >> 5) == w) c |= 1u << (pc[g] & 31);
    }
    pmask[w] = __reduce_or_sync(FULL, c);
  }
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int k = 32 * g + lane;
    if (k >= K) continue;
    const float d1 = __fadd_rn(dist0, delta[g]);
    uint32_t c[W];
#pragma unroll
    for (int w = 0; w < W; ++w) c[w] = base[w] ^ r[g][w];
    best.offer(d1, syndrome(c) == 0u && code_weight(c) > 0 && d1 <= gate,
               1 + k, (1u << 24) | k);
    // pivot columns above this row's: its place among the order-2 rows
    const int pw = pc[g] >> 5, pb = pc[g] & 31;
    int above = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (w > pw) above += __popc(pmask[w]);
      if (w == pw) above += __popc(pmask[w] & ~((2u << pb) - 1u));
    }
    if (above < order2) {
#pragma unroll
      for (int w = 0; w < W; ++w) s.sub[above][w] = r[g][w];
      s.dsub[above] = delta[g];
    }
  }
  __syncwarp();

  // order 2: lane j holds order-2 row j, and which pairs (i, j), i < j,
  // hold their CRC and are not zero; the overlaps come four pairs at a
  // time, every lane adding its columns, and lane j offers pair (i, j)
  uint32_t mine[W];
  float dmine = 0.f;
  uint32_t vpair = 0u;
  if (lane < order2) {
#pragma unroll
    for (int w = 0; w < W; ++w) mine[w] = s.sub[lane][w];
    dmine = s.dsub[lane];
    for (int i = 0; i < lane; ++i) {
      uint32_t c[W];
#pragma unroll
      for (int w = 0; w < W; ++w) c[w] = base[w] ^ s.sub[i][w] ^ mine[w];
      if (syndrome(c) == 0u && code_weight(c) > 0) vpair |= 1u << i;
    }
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) mine[w] = 0u;
  }
  uint32_t colbits[W];
  float uc[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    colbits[w] = transpose32(mine[w], lane);
    uc[w] = s.u[32 * w + lane];
  }
  for (int i = 0; i + 1 < order2; ++i) {
    const float di = __fadd_rn(dist0, s.dsub[i]);
    for (int j0 = i + 1; j0 < order2; j0 += 4) {
      uint32_t rows[4];
      float ov[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        rows[e] = j0 + e < order2 ? (1u << i) | (1u << (j0 + e)) : 0u;
      }
      overlaps4(colbits, uc, rows, ov);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + e;
        if (j >= order2) break;
        if (lane == 0 && j < order3) s_ov[i * order3 + j] = ov[e];
        if (lane == j) {
          const float d2 = __fsub_rn(__fadd_rn(di, dmine),
                                     __fmul_rn(2.f, ov[e]));
          best.offer(d2, ((vpair >> i) & 1u) && d2 <= gate,
                     1 + K + i * order2 + j, (2u << 24) | (j << 8) | i);
        }
      }
    }
  }
  __syncwarp();

  // order 3: for each pair (i, j) of the first order3 rows, lane k > j
  // checks triple (i, j, k)'s CRC and guard, and the overlaps of the three
  // come four triples at a time as the pairs' did
  if (order3 >= 3) {
    int t0 = 1 + K + order2 * order2;   // index of the first triple (i, j)
    for (int i = 0; i + 2 < order3; ++i) {
      for (int j = i + 1; j + 1 < order3; ++j) {
        bool v3 = false;
        if (lane > j && lane < order3) {
          uint32_t c[W];
#pragma unroll
          for (int w = 0; w < W; ++w) {
            c[w] = base[w] ^ s.sub[i][w] ^ s.sub[j][w] ^ mine[w];
          }
          v3 = syndrome(c) == 0u && code_weight(c) > 0;
        }
        const float dij = __fadd_rn(__fadd_rn(dist0, s.dsub[i]), s.dsub[j]);
        const float ovij = s_ov[i * order3 + j];
        for (int k0 = j + 1; k0 < order3; k0 += 4) {
          uint32_t rows[4];
          float tu[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            rows[e] = k0 + e < order3
                          ? (1u << i) | (1u << j) | (1u << (k0 + e)) : 0u;
          }
          overlaps4(colbits, uc, rows, tu);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = k0 + e;
            if (k >= order3) break;
            if (lane == k) {
              const float ovs = __fadd_rn(
                  __fadd_rn(ovij, s_ov[i * order3 + k]),
                  s_ov[j * order3 + k]);
              const float d3 = __fadd_rn(
                  __fsub_rn(__fadd_rn(dij, dmine), __fmul_rn(2.f, ovs)),
                  __fmul_rn(4.f, tu[e]));
              best.offer(d3, v3 && d3 <= gate, t0 + (k - j - 1),
                         (3u << 24) | (k << 16) | (j << 8) | i);
            }
          }
        }
        t0 += order3 - 1 - j;
      }
    }
  }

  // the winner: the smallest key, then the smallest index
  const unsigned key = __reduce_min_sync(FULL, best.key);
  const bool found = key != NO_KEY;
  const unsigned at = __reduce_min_sync(
      FULL, best.key == key ? static_cast<unsigned>(best.index) : UINT_MAX);
  const uint32_t owner = __ballot_sync(
      FULL, found && best.key == key
                && static_cast<unsigned>(best.index) == at);
  const uint32_t flip = __shfl_sync(FULL, best.flip,
                                    owner ? __ffs(owner) - 1 : 0);
  const uint32_t kind = found ? flip >> 24 : 0u;
  uint32_t cw[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    uint32_t f = 0u;
    if (kind == 1u) {
      const int k = flip & 0xff;
      const uint32_t rg = k < 32 ? r[0][w] : k < 64 ? r[1][w] : r[2][w];
      f = __shfl_sync(FULL, rg, k & 31);
    } else if (kind >= 2u) {
      f = s.sub[flip & 0xff][w] ^ s.sub[(flip >> 8) & 0xff][w];
      if (kind == 3u) f ^= s.sub[(flip >> 16) & 0xff][w];
    }
    cw[w] = base[w] ^ f;
  }
  if (lane == 0) {
#pragma unroll
    for (int w = 0; w < W; ++w) s.win[w] = cw[w];
    ok[row] = found;
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int i = 32 * k + lane;
    if (i < N) {
      const int p = rank[k];
      out[i] = static_cast<int32_t>((s.win[p >> 5] >> (p & 31)) & 1u);
    }
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

// Launches the OSD of `count` rows on `stream`; returns cudaGetLastError().
//   llr (count, 174) float32; need (count,) bool, or null for every row;
//   table as above; plain (count, 174) int32 and ok (count,) bool out.  All
//   contiguous on one card; 0 <= order3 <= order2 <= ft8_osd_max_order2().
int ft8_osd_decode(const void* llr, const void* need, const void* table,
                   void* plain, void* ok, int count, float lam, int order2,
                   int order3, void* stream) {
  if (count == 0) return cudaSuccess;
  if (order2 < 0 || order2 > MAX_ORDER2 || order3 < 0 || order3 > order2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t ov_bytes = sizeof(float) * order3 * order3;
  osd_decode_kernel<<<count, 32, ov_bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(llr), static_cast<const bool*>(need),
      static_cast<const uint32_t*>(table), static_cast<int32_t*>(plain),
      static_cast<bool*>(ok), lam, order2, order3);
  return static_cast<int>(cudaGetLastError());
}

// The words of the table the kernels read (checked by the wrapper).
int ft8_osd_table_words() { return TABLE_WORDS; }

// The largest order2 the search takes (checked by the wrapper).
int ft8_osd_max_order2() { return MAX_ORDER2; }

}  // extern "C"
