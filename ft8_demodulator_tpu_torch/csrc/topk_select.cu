// Candidate top-K of a sync score grid, sm_90a: the row screen and the flat
// selection with lax.top_k's tie order, a thread block cluster a slot (K9).
//
// Replaces no TPU kernel: the JAX package selects with lax.top_k, which
// XLA lowers to its own sort (ft8_demodulator_tpu/ops/sync.py
// `find_candidates_tf`).  Written out in PyTorch (ops/sync.py
// `find_candidates_plain`) a call is about twenty small launches and two
// full stable radix sorts; this kernel is the card form of that route, one
// launch a call.
//
// What it computes, a slot at a time, on the grid (num_times, num_freqs):
//   * a cell below min_score (or NaN) is -inf;
//   * screened route (num_freqs > K + 12): each frequency's maximum over
//     time; the R = K + 12 frequencies with the largest maxima, ties to the
//     lower frequency, in that order (the screen); then the K largest of
//     the R x num_times cells at flat index r * num_times + t (r the screen
//     rank), ties to the lower index;
//   * flat route (otherwise): the min(K, cells) largest cells at flat index
//     f * num_times + t, ties to the lower index;
//   * the winners in descending order; out: abs_time = t_start + t,
//     abs_freq = f, the cell's value (read again from the grid, so a -0.0
//     stays -0.0), and whether it is finite.
// Keys are the cells' ordered float bits (sign-flipped), with -0.0 taken
// as +0.0: torch.sort on the card and on the CPU holds the two zeros
// equal, so their order is their index's.  -inf cells keep their index
// order behind every finite one.  A row's maximum is the largest key of
// the row, so it does not matter which zero a row's maximum is.
//
// How.  The slot's blocks form a cluster of up to 8 (fewer when the
// chunk's slots would not fit on the card at 8 blocks a slot; one on the
// flat route).  Each block takes the row maxima of its share of the
// frequencies, its threads split over frequencies (a warp's loads of a
// time-major grid are 32 neighbouring cells) and, where the share has
// fewer rows than threads, over time too; it writes them into the first
// block's shared memory (distributed shared memory) and all but the first
// block leave.  The first block then makes two selections, the screen over
// the num_freqs row maxima and the flat one over the cells: a radix select
// of the M-th largest key, 8 bits a pass from the top in a 256-bin shared
// histogram (warp-aggregated adds, two histograms in turn so a pass needs
// two barriers), stopping once the keys at the chosen prefix are exactly
// those still wanted; a compaction that takes, in index order, every key
// above the threshold and the first keys at it, as a 64-bit composite
// (~key, index); and a bitonic sort of the M composites (unique, so any
// sort gives the one order; up to 64 in one warp's registers).  On the
// screened route the K-th largest row maximum bounds the winners from
// below (the K largest maxima are K cells that reach it), so where at most
// 512 cells reach it, those are sorted whole in place of the second radix
// select (the batch cells' noise: a few dozen).  No step depends on K
// beyond the sorts' lengths.  The cells' keys are cached in shared
// memory when they fit (the batch cells: 2,816 STANDARD, 9,152 DEEP);
// otherwise each pass reads them again through the grid's strides (K near
// 1,024 at DEEP's 176 start times).  The grid is read through its strides,
// so the frequency-major callers' transposed views and crops need no copy.
//
// What bounds it on the card: bytes, the score grid read once (a STANDARD
// slot 0.67 MB, a DEEP one 2.68 MB); the selection's barriers are a fixed
// cost a slot, paid once in a chunk since the slots run side by side.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int RADIX = 256;
constexpr int MAX_K = 1024;
constexpr int ROW_SLACK = 12;              // ops/sync.py _ROW_SLACK
constexpr int MAX_SCREEN_FREQS = 32768;    // row maxima kept in shared memory
constexpr int SMEM_CAP = 200 * 1024;       // dynamic shared memory a block
constexpr int MAX_CLUSTER = 8;             // blocks a slot (portable size)
constexpr int BOUND_CAP = 512;             // cells sorted whole (see kernel)
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long PAD = ~0ull;  // sorts after every composite

// the selection's state, shared by the block
struct Select {
  unsigned prefix;  // the chosen top digits of the threshold key
  unsigned mask;    // which bits of a key they are
  int need;         // keys still wanted among those at the prefix
  int at;           // keys at the prefix
  int taken;        // composites written by the compaction
};

__device__ __forceinline__ float masked(float v, float min_score) {
  return v >= min_score ? v : -INFINITY;
}

// the masked cell's key: unsigned order is the floats' order, both zeros
// one key
__device__ __forceinline__ unsigned cell_key(float v, float min_score) {
  const float w = masked(v, min_score);
  const unsigned b = __float_as_uint(w == 0.0f ? 0.0f : w);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ unsigned long long composite(unsigned key,
                                                        int index) {
  return (static_cast<unsigned long long>(~key) << 32)
      | static_cast<unsigned>(index);
}

__device__ __forceinline__ int index_of(unsigned long long c) {
  return static_cast<int>(static_cast<unsigned>(c));
}

__device__ __forceinline__ int pow2_at_least(int n) {
  return n <= 1 ? 1 : 1 << (32 - __clz(n - 1));
}

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The M-th largest key of key(0..n-1) (1 <= m <= n): on return sel holds
// the prefix and mask that classify a key as above the threshold ((k &
// mask) > prefix) or at it (== prefix), and how many keys at it to take.
// hist: two histograms.
template <class Key>
__device__ void radix_select(const Key& key, int n, int m, Select& sel,
                             int* hist) {
  if (threadIdx.x == 0) sel = Select{0u, 0u, m, n, 0};
  for (int i = threadIdx.x; i < RADIX; i += THREADS) hist[i] = 0;
  __syncthreads();
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    const unsigned prefix = sel.prefix, mask = sel.mask;
    const int need = sel.need;
    if (sel.at == need) break;           // every key at the prefix is in
    int* const h = hist + (pass & 1) * RADIX;
    int* const next = hist + (~pass & 1) * RADIX;
    for (int i = threadIdx.x; i < RADIX; i += THREADS) next[i] = 0;
    for (int j0 = 0; j0 < n; j0 += THREADS) {
      const int j = j0 + threadIdx.x;
      unsigned digit = RADIX;            // not counted
      if (j < n) {
        const unsigned k = key(j);
        if ((k & mask) == prefix) digit = (k >> shift) & (RADIX - 1);
      }
      const unsigned peers = __match_any_sync(FULL, digit);
      if (digit < RADIX && (threadIdx.x & 31) == __ffs(peers) - 1)
        atomicAdd(&h[digit], __popc(peers));
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      // lane l holds digits 255 - 8l down to 248 - 8l: scan from the top
      const int lane = threadIdx.x;
      int c[8], s = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c[i] = h[RADIX - 1 - 8 * lane - i];
        s += c[i];
      }
      int incl = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += v;
      }
      int acc = incl - s;
      if (acc < need && need <= incl) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (acc < need && acc + c[i] >= need) {
            const unsigned d = RADIX - 1 - 8 * lane - i;
            sel.prefix = prefix | (d << shift);
            sel.mask = mask | (static_cast<unsigned>(RADIX - 1) << shift);
            sel.need = need - acc;
            sel.at = c[i];
          }
          acc += c[i];
        }
      }
    }
    __syncthreads();
  }
}

// Writes the m selected composites to out[0..m) (in no order): every key
// above the threshold and the first sel.need keys at it, by index.
template <class Key>
__device__ void compact(const Key& key, int n, Select& sel,
                        unsigned long long* out, int* warp_ties) {
  const unsigned prefix = sel.prefix, mask = sel.mask;
  const int need = sel.need;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                       // every thread has read sel
  if (threadIdx.x == 0) sel.taken = 0;
  __syncthreads();
  int ties_before = 0;                   // the same in every thread
  for (int j0 = 0; j0 < n; j0 += THREADS) {
    const int j = j0 + threadIdx.x;
    unsigned k = 0;
    bool above = false, at = false;
    if (j < n) {
      k = key(j);
      above = (k & mask) > prefix;
      at = (k & mask) == prefix;
    }
    bool take = above;
    if (ties_before < need) {            // ties still wanted: rank them
      const unsigned at_bits = __ballot_sync(FULL, at);
      if (lane == 0) warp_ties[warp] = __popc(at_bits);
      __syncthreads();
      int before = ties_before + __popc(at_bits & lanes_below());
      int total = 0;
      for (int w = 0; w < WARPS; ++w) {
        const int c = warp_ties[w];
        if (w < warp) before += c;
        total += c;
      }
      take = above || (at && before < need);
      ties_before += total;
      __syncthreads();                   // warp_ties is written again
    }
    const unsigned take_bits = __ballot_sync(FULL, take);
    int base = 0;
    if (lane == 0 && take_bits)
      base = atomicAdd(&sel.taken, __popc(take_bits));
    base = __shfl_sync(FULL, base, 0);
    if (take) out[base + __popc(take_bits & lanes_below())] = composite(k, j);
  }
  __syncthreads();
}

// Writes the composites of the keys >= bound to out[0..min(count, cap))
// (in no order); returns their count.
template <class Key>
__device__ int take_at_least(const Key& key, int n, unsigned bound, int cap,
                             Select& sel, unsigned long long* out) {
  if (threadIdx.x == 0) sel.taken = 0;
  __syncthreads();
  for (int j0 = 0; j0 < n; j0 += THREADS) {
    const int j = j0 + threadIdx.x;
    unsigned k = 0;
    bool take = false;
    if (j < n) {
      k = key(j);
      take = k >= bound;
    }
    const unsigned bits = __ballot_sync(FULL, take);
    int base = 0;
    if ((threadIdx.x & 31) == 0 && bits)
      base = atomicAdd(&sel.taken, __popc(bits));
    base = __shfl_sync(FULL, base, 0);
    const int at = base + __popc(bits & lanes_below());
    if (take && at < cap) out[at] = composite(k, j);
  }
  __syncthreads();
  const int count = sel.taken;
  __syncthreads();                       // sel is written again next
  return count;
}

// Ascending bitonic sort of s[0..m), padded to a power of two: up to 64 in
// the first warp's registers (two a lane), more in shared memory.
__device__ void sort_composites(unsigned long long* s, int m) {
  const int n = pow2_at_least(m);
  if (n <= 64) {
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      unsigned long long v[2] = {lane < m ? s[lane] : PAD,
                                 lane + 32 < m ? s[lane + 32] : PAD};
      for (int size = 2; size <= n; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          if (stride == 32) {            // lane against lane + 32, size 64
            const unsigned long long lo = min(v[0], v[1]);
            v[1] = max(v[0], v[1]);
            v[0] = lo;
            continue;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = lane + 32 * h;
            const unsigned long long x = __shfl_xor_sync(FULL, v[h], stride);
            const bool up = (i & size) == 0, lower = (i & stride) == 0;
            v[h] = lower == up ? min(v[h], x) : max(v[h], x);
          }
        }
      }
      if (lane < n) s[lane] = v[0];
      if (lane + 32 < n) s[lane + 32] = v[1];
    }
    __syncthreads();
    return;
  }
  for (int i = m + threadIdx.x; i < n; i += THREADS) s[i] = PAD;
  __syncthreads();
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n / 2; i += THREADS) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = s[lo], b = s[hi];
        if ((a > b) == ((lo & size) == 0)) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// A cluster of blocks a slot (1-D: block rank = blockIdx.x % cluster
// size).  Shared memory, the same in every block: the sort buffer (sort_n
// composites), the screen's rows, the keys (the row maxima, and the
// cells' keys when `cached`), then the block's share of the row maxima.
__global__ void __launch_bounds__(THREADS, 1)
topk_select_kernel(const float* __restrict__ scores, long long s_lead,
                   long long s_t, long long s_f, int num_times,
                   int num_freqs, int rows_n, int m, float min_score,
                   int t_start, int sort_n, int keys_n, int cached,
                   int32_t* __restrict__ abs_time,
                   int32_t* __restrict__ abs_freq,
                   float* __restrict__ score,
                   uint8_t* __restrict__ valid) {
  extern __shared__ unsigned long long smem[];
  __shared__ int hist[2 * RADIX];
  __shared__ int warp_ties[WARPS];
  __shared__ Select sel;
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int slot = blockIdx.x / cl;
  unsigned long long* const sorted = smem;
  int* const rows = reinterpret_cast<int*>(smem + sort_n);
  unsigned* const keys = reinterpret_cast<unsigned*>(rows + (rows_n + 1) / 2
                                                     * 2);
  unsigned* const part = keys + keys_n;
  const float* const g = scores + slot * s_lead;
  const int T = num_times;
  const bool screened = rows_n > 0;
  // the screened route's bound on the winners: the K-th largest row
  // maximum, which at least K cells (those maxima) reach
  unsigned bound = 0u;

  if (screened) {
    // this block's share of the frequencies [f0, f0 + here): each row's
    // largest key, `parts` threads a row splitting time where the share
    // has fewer rows than the block has threads
    const int per = (num_freqs + cl - 1) / cl;
    const int f0 = min(num_freqs, rank * per);
    const int here = min(num_freqs, f0 + per) - f0;
    for (int i = threadIdx.x; i < here; i += THREADS) part[i] = 0u;
    __syncthreads();
    if (here > 0) {
      const int parts = max(1, THREADS / here);
      for (int i = threadIdx.x; i < here * parts; i += THREADS) {
        const int fl = i % here;
        const float* const p = g + (f0 + fl) * s_f;
        unsigned best = 0u;
#pragma unroll 8
        for (int t = i / here; t < T; t += parts)
          best = max(best, cell_key(p[t * s_t], min_score));
        atomicMax(&part[fl], best);
      }
    }
    cluster.sync();                      // every block of the slot runs
    unsigned* const first = cluster.map_shared_rank(keys, 0);
    for (int i = threadIdx.x; i < here; i += THREADS) first[f0 + i] = part[i];
    cluster.sync();                      // the first block has every row
    if (rank != 0) return;
    const auto row_key = [&](int f) { return keys[f]; };
    radix_select(row_key, num_freqs, rows_n, sel, hist);
    compact(row_key, num_freqs, sel, sorted, warp_ties);
    sort_composites(sorted, rows_n);
    for (int r = threadIdx.x; r < rows_n; r += THREADS)
      rows[r] = index_of(sorted[r]);
    bound = ~static_cast<unsigned>(sorted[m - 1] >> 32);
    __syncthreads();
  } else if (rank != 0) {
    return;
  }

  const int n = (screened ? rows_n : num_freqs) * T;
  const auto cell = [&](int j) {
    const int r = j / T;
    const int t = j - r * T;
    const int f = screened ? rows[r] : r;
    return cell_key(g[t * s_t + f * s_f], min_score);
  };
  // the cells at or above the bound, where they are few, sorted whole;
  // else the radix select and its compaction
  const auto cached_key = [&](int j) { return keys[j]; };
  if (cached) {
    for (int j = threadIdx.x; j < n; j += THREADS) keys[j] = cell(j);
    __syncthreads();
  }
  const int few = !screened ? BOUND_CAP + 1
      : cached ? take_at_least(cached_key, n, bound, BOUND_CAP, sel, sorted)
               : take_at_least(cell, n, bound, BOUND_CAP, sel, sorted);
  if (few <= BOUND_CAP) {
    sort_composites(sorted, few);
  } else {
    if (cached) {
      radix_select(cached_key, n, m, sel, hist);
      compact(cached_key, n, sel, sorted, warp_ties);
    } else {
      radix_select(cell, n, m, sel, hist);
      compact(cell, n, sel, sorted, warp_ties);
    }
    sort_composites(sorted, m);
  }

  const size_t out0 = static_cast<size_t>(slot) * m;
  for (int i = threadIdx.x; i < m; i += THREADS) {
    const int j = index_of(sorted[i]);
    const int r = j / T;
    const int t = j - r * T;
    const int f = screened ? rows[r] : r;
    const float v = masked(g[t * s_t + f * s_f], min_score);
    abs_time[out0 + i] = t_start + t;
    abs_freq[out0 + i] = f;
    score[out0 + i] = v;
    valid[4 * out0 + i] = isfinite(v) ? 1 : 0;
  }
}

// the card's SM count, read once
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess)
      sms = 1;
  }
  return sms;
}

}  // namespace

extern "C" {

// Launches the selection on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments beyond the kernel's limits.
//   scores: float32 cells of (lead, num_times, num_freqs) at strides
//   (s_lead, s_t, s_f) in elements; k: the candidates wanted (1..1,024);
//   out: abs_time, abs_freq (int32), score (float32), each (lead, m)
//   contiguous, m = k on the screened route, min(k, cells) on the flat
//   one; valid (uint8) the first m bytes of rows of 4 m bytes, one a slot
//   (the bytes of a fourth (lead, m) int32 plane).  lead >= 1, num_times,
//   num_freqs >= 1, fewer than 2^31 cells a slot.
int ft8_topk_select(const void* scores, long long s_lead, long long s_t,
                    long long s_f, int lead, int num_times, int num_freqs,
                    int k, float min_score, int t_start, void* abs_time,
                    void* abs_freq, void* score, void* valid, void* stream) {
  if (lead < 1 || num_times < 1 || num_freqs < 1 || k < 1 || k > MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool screened = num_freqs > k + ROW_SLACK;
  const long long cells =
      static_cast<long long>(screened ? k + ROW_SLACK : num_freqs) *
      num_times;
  if (cells > 0x7fffffffLL || (screened && num_freqs > MAX_SCREEN_FREQS))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows_n = screened ? k + ROW_SLACK : 0;
  const int m = screened ? k : static_cast<int>(cells < k ? cells : k);
  // blocks a slot: up to 8, while the chunk's blocks fill no more than
  // half the card; one on the flat route, which has no row maxima
  int cl = 1;
  if (screened)
    while (cl < MAX_CLUSTER && 2LL * cl * lead <= sm_count() / 2) cl *= 2;
  if (static_cast<long long>(cl) * lead > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int sort_n = screened ? BOUND_CAP : 1;
  while (sort_n < (rows_n > m ? rows_n : m)) sort_n <<= 1;
  const size_t fixed = static_cast<size_t>(sort_n) * 8
      + static_cast<size_t>((rows_n + 1) / 2 * 2) * 4;
  const size_t per = screened ? (num_freqs + cl - 1) / cl : 0;
  const size_t row_keys = screened ? static_cast<size_t>(num_freqs) : 0;
  const bool cached =
      fixed + (static_cast<size_t>(cells) + per) * 4 <= SMEM_CAP;
  const size_t keys_n =
      cached && static_cast<size_t>(cells) > row_keys
          ? static_cast<size_t>(cells) : row_keys;
  const size_t smem = fixed + (keys_n + per) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      topk_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cl * lead));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cl);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, topk_select_kernel, static_cast<const float*>(scores), s_lead,
      s_t, s_f, num_times, num_freqs, rows_n, m, min_score, t_start, sort_n,
      static_cast<int>(keys_n), cached ? 1 : 0,
      static_cast<int32_t*>(abs_time), static_cast<int32_t*>(abs_freq),
      static_cast<float*>(score), static_cast<uint8_t*>(valid));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
