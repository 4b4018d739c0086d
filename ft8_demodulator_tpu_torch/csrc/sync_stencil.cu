// Costas sync stencil over a dB waterfall, sm_90a: shared-memory tiles and
// difference planes.  Two instances of one template by the layout of the
// grid (each compiled for osr 2x2 and 4x4, and once for any other osr):
//   * sync_kernel<true, ...>, time-major (grid (B, T, F), scores (B,
//     num_times, num_freqs)): replaces ft8_demodulator_tpu/ops/
//     sync_pallas_tf.py:162 `_kernel` (entry `sync_scores_tf_pallas` :190);
//   * sync_kernel<false, ...>, frequency-major (grid (B, F, T), scores (B,
//     num_freqs, num_times)): replaces ft8_demodulator_tpu/ops/
//     sync_pallas.py:154 `_sync_kernel` (entry `sync_scores_padded` :189).
//
// Score cell (t, f), t = t_start + j the candidate's start frame (negative
// in the pre-roll), is the mean over the valid comparisons of [power of a
// Costas cell - power of a neighbour]: for Costas symbol k of sequence m
// (block b = 36 m + k, tone c = costas_tone(k)) with base = floor(t / tau),
//   cell valid  0 <= base + b < num_blocks:
//       +(cur - lo) + (cur - hi)   the frequency neighbours tone c -+ 1
//                                  (only hi at tone 0);
//   prev valid  cell valid, k > 0, base + b > 0:       +(cur - prev symbol)
//   next valid  cell valid, k < 6, base + b + 1 < num_blocks:
//                                                      +(cur - next symbol)
// where cur = grid[t + b tau, f + c phi], lo/hi the same frame at f + (c -+
// 1) phi, prev/next frames t + (b -+ 1) tau.  count is the number of those
// comparisons (it depends on t only); the score is total * (1 / max(count,
// 1)), -inf where count is 0.  A read of a frame outside [0, num_frames) is
// the zero padding of the plain version.
//
// Difference planes.  With H(r, x) = g[r, x] - g[r, x + phi],
// D(r, x) = H(r, x) - H(r, x - phi) and P(r, x) = g[r, x] - g[r - tau, x]
// (every difference rounded once), two identities hold under round to
// nearest for every finite g:
//   (cur - lo) + (cur - hi) = D(fr, f + c phi)   (H(fr, f) at tone 0),
//   cur - prev = P(fr, x),   cur - next = -P(fr + tau, x),
// up to the sign of a zero result (a - b = -(b - a) exactly unless a == b).
// A term is only ever added to `total`, which starts at +0 and is never -0
// (a round-to-nearest sum is -0 only when both operands are), so the sign
// of a zero term never shows, and total - P(fr + tau) has the bits of
// total + (cur - next).  The terms are added in the plain version's order
// (ops/sync.py `_sync_scores_tf_impl`: sequences m, symbols k, per symbol
// the frequency pair, then prev, then next), each add rounded on its own
// (__fadd_rn / __fsub_rn are never fused), then one correctly rounded
// reciprocal and one multiply: the scores equal the plain stencil's bit for
// bit.  A term whose mask is 0 is not added (the plain version adds +-0,
// which leaves a sum that is never -0 unchanged).
//
// Tiles.  A block owns kCells tau start times x kThreads / tau frequencies
// of one slot: lanes along frequency, and each thread scores kCells = 11
// start times tau frames (one symbol) apart.  For each Costas sequence in
// turn it stages the grid region the tile's taps touch, 17 tau frames x
// kThreads / tau + 7 phi bins, into shared memory by cp.async in the
// grid's own layout, 16 or 8
// bytes a copy along the grid's contiguous axis where the strides and the
// region are aligned (else 4; any strides, so a cropped view is read in
// place; a frame outside the grid or a bin no valid cell reads is zero).
// The staged grid is a two-stage ring: sequence m + 1 (and m + 2 once m's
// sum is done) loads while m is built and summed.  The block then builds
// the D plane, frame-major ([frame][bin]), 3 subtractions per staged value:
// time-major from the staged region, which is frame-major already, by 16
// or 8 bytes; frequency-major together with G, the region transposed, at
// an odd pitch, so that the transposing writes hit no bank twice.  From
// there on the two instances run the same code: the arithmetic per cell
// is identical.
//
// The sum.  Per symbol a thread reads the kCells + 1 (or + 2) staged
// values v[q] at its bin f + c phi, frames j0 + tau (k - 1 + q), and forms
// P = v[q + 1] - v[q] once for the previous term of cell q and the next
// term of cell q - 1: the P plane lives in registers.  Per symbol and
// cell that is one read of D, ~1.1 reads of the grid and ~4 adds.  A
// sequence whose taps are valid for all of a thread's cells (all but the
// pre-roll and the tail) takes a branch-free path; the count per start
// time is a table the block fills once.  The osr 2x2 and 4x4 instances
// (the decoders' presets) take the osr as a template parameter, so every
// offset is an immediate; the generic instance reads it at run time and
// idles the kThreads % tau threads past its tile.
//
// Choosing the tile.  A 15-s slot has num_times = 44 tau at any sample rate
// (12 kHz: 176 x 3,812 cells at osr 4x4, 88 x 1,906 at 2x2), so tiles of
// 11 tau start times cover it exactly: 11 cells a thread.  Time-major (a
// decode_slots chunk), 256 threads: 44 x 64 cells at 4x4, 22 x 128 at
// 2x2; shared memory is three arrays (two ring stages and D) of 17 tau x
// (256 / tau + 7 phi) words, 75.3 KB at 4x4 and 58.8 KB at 2x2, so three
// blocks (24 warps) an SM overlap one another's copy waits, builds and
// sums.  Staged values per cell and sequence: 2.2 at 4x4 (68 x 92 for 44 x
// 64), 1.7 at 2x2.  A DEEP chunk of 8 is 60 x 4 x 8 = 1,920 blocks, 4.8
// waves of 396; a STANDARD chunk of 16 is 15 x 4 x 16 = 960, 2.4 waves.
// Frequency-major (one capture): the same tile at 4x4 (240 blocks, 100.9
// KB with G: two an SM), and at 2x2 128 threads, 22 x 64 cells (120
// blocks; 256 threads would leave half the SMs idle).  What bounds it:
// shared-memory traffic (~27 words per cell and sequence at 4x4, 128 B per
// clock an SM), the L2 feeding 2.2x the grid per sequence, and for one
// capture the latency of three staged phases on one or two blocks an SM.
//
// The generic instance shrinks its tile until the block fits in 227 KB of
// shared memory: fewer frequency lanes first (frequency-major osr 10 x 10
// takes 14 of 25), then fewer cells a thread (and fewer, too, while a tile
// would hold more than kThreads start times).  The sums per cell are the
// same, in the same order, whatever the tile.  At osr n x n a tile fits up
// to n = 17 frequency-major and n = 19 time-major; an osr that fits no
// tile (ft8_sync_tile says which; the Python wrapper raises before
// launching) is refused with cudaErrorInvalidValue.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int NUM_SEQS = 3;        // Costas sequences per frame
constexpr int COSTAS_LEN = 7;
constexpr int SEQ_STRIDE = 36;     // symbols between sequence starts
constexpr int COSTAS_TONES = 0x2560413;   // tone of symbol k: nibble k
constexpr int MAX_SMEM = 227 * 1024;

// A tile: each thread scores `cells` start times one symbol apart, at one
// of `lanes` frequencies.
struct TileShape {
  int cells, lanes;
};

struct Geometry {
  int64_t sb, st, sf;     // element strides of the grid: batch, time, freq
  int num_frames;         // grid frames (reads outside are zero)
  int tau, phi, num_blocks, t_start, num_times, num_freqs;
  TileShape tile;         // the generic instance's tile (launch sets it)
};

// The cells of a block; kTau > 0 fixes the osr at compile time (0: any).
template <bool kTimeMajor, int kTau>
struct Tile {
  // a frequency-major launch scores one capture: at 2x2 that is 60 blocks
  // of 256 threads, so it takes 128 (half the frequencies, twice the
  // blocks)
  static constexpr int kThreads = !kTimeMajor && kTau == 2 ? 128 : 256;
  // cells of a thread, one symbol apart: cell q's next term is cell
  // q + 1's previous term
  static constexpr int kCells = 11;
  // the start times the count table holds
  static constexpr int kMaxTimes = kTau > 0 ? kCells * kTau : kThreads;
  // blocks an SM (shared memory allows it at osr 2x2 and 4x4)
  static constexpr int kMinBlocks = kTau > 0 && kTimeMajor ? 3 : 2;
  // the widest tile: kCells cells a thread, kThreads / tau lanes
  __host__ __device__ static constexpr TileShape widest(int tau) {
    return TileShape{kCells, kThreads / tau};
  }
};

// Shared memory of a block: two staged regions in the grid's layout
// (`rp` words a line, 16-byte lines for cp.async) and the frame-major
// planes ([frame][bin], `pw` words a frame): D, and frequency-major G, the
// staged region transposed (odd pitch: the transposing writes hit no bank
// twice).  Time-major the staged region is frame-major already and serves
// as G, at the same pitch.
struct Layout {
  int rows, cols;          // frames, bins
  int rp, raw_words;       // a staged region
  int pw, plane_words;     // a plane
};

__host__ __device__ __forceinline__ int round_up(int x, int to) {
  return (x + to - 1) / to * to;
}

template <bool kTimeMajor>
__host__ __device__ __forceinline__ Layout layout_of(int tau, int phi,
                                                     TileShape t) {
  Layout s;
  s.rows = (t.cells + 6) * tau;
  s.cols = t.lanes + 7 * phi;
  s.rp = round_up(kTimeMajor ? s.cols : s.rows, 4);
  s.raw_words = round_up(s.rp * (kTimeMajor ? s.rows : s.cols), 32);
  s.pw = kTimeMajor ? s.rp : (s.cols | 1);
  s.plane_words = round_up(s.rows * s.pw, 32);
  return s;
}

template <bool kTimeMajor>
__host__ __device__ __forceinline__ int smem_bytes(int tau, int phi,
                                                   TileShape t) {
  const Layout s = layout_of<kTimeMajor>(tau, phi, t);
  return 4 * (2 * s.raw_words + (kTimeMajor ? 1 : 2) * s.plane_words);
}

__device__ __forceinline__ int costas_tone(int k) {
  return (COSTAS_TONES >> (4 * k)) & 0xF;
}

__host__ __device__ __forceinline__ int floor_div(int a, int b) {
  // C's / truncates toward zero; pre-roll times are negative
  const int q = a / b;
  return (q * b > a) ? q - 1 : q;
}

// cp.async of kBytes (4, 8 or 16); the bytes past src_bytes are zeros
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(d), "l"(src), "n"(kBytes), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// One staged region, frames r0 + [0, rows) x bins f0 + [0, cols), into dst
// in the grid's layout, kVec words a copy along its contiguous axis (bins
// time-major, frames frequency-major; the launcher checks that the grid's
// lines and the region start on a multiple of kVec, so a vector lies
// wholly before frame 0), cut at bin_end or the grid's last frame.
template <bool kTimeMajor, int kThreads, int kVec>
__device__ __forceinline__ void stage_region(
    float* dst, const float* src, const Layout& s, const Geometry& g,
    int r0, int f0, int bin_end) {
  // vectors of a line (rp is a multiple of 4), over the lines
  const int per_line = ((kTimeMajor ? s.cols : s.rows) + kVec - 1) / kVec;
  const int count = per_line * (kTimeMajor ? s.rows : s.cols);
#pragma unroll 4
  for (int v = threadIdx.x; v < count; v += kThreads) {
    const int b = v / per_line;
    const int a = (v - b * per_line) * kVec;
    const int row = kTimeMajor ? b : a;
    const int col = kTimeMajor ? a : b;
    const int frame = r0 + row;
    const int bin = f0 + col;
    float* const d = dst + b * s.rp + a;
    int n = 0;                                   // words to copy
    if (frame >= 0 && frame < g.num_frames && bin < bin_end) {
      n = min(kVec, kTimeMajor ? bin_end - bin : g.num_frames - frame);
    }
    if (n > 0) {
      cp_async<4 * kVec>(d, src + static_cast<int64_t>(frame) * g.st
                            + static_cast<int64_t>(bin) * g.sf, 4 * n);
    } else {
#pragma unroll
      for (int w = 0; w < kVec; ++w) d[w] = 0.0f;
    }
  }
}

__device__ __forceinline__ float d_of(float c, float hi, float lo) {
  return __fsub_rn(__fsub_rn(c, hi), __fsub_rn(lo, c));   // H(x) - H(x-phi)
}
__device__ __forceinline__ float2 d_of(float2 c, float2 hi, float2 lo) {
  return make_float2(d_of(c.x, hi.x, lo.x), d_of(c.y, hi.y, lo.y));
}
__device__ __forceinline__ float4 d_of(float4 c, float4 hi, float4 lo) {
  return make_float4(d_of(c.x, hi.x, lo.x), d_of(c.y, hi.y, lo.y),
                     d_of(c.z, hi.z, lo.z), d_of(c.w, hi.w, lo.w));
}

template <int kWords> struct VecOf { using T = float; };
template <> struct VecOf<2> { using T = float2; };
template <> struct VecOf<4> { using T = float4; };

// Time-major: the D plane of a staged region at the bins a tone c >= 1
// reads, [phi, cols - phi), kWords at a time (phi and the pitch are
// multiples of it).
template <int kThreads, int kWords>
__device__ __forceinline__ void build_d(float* dpl, const float* gr,
                                        const Layout& s, int phi) {
  using V = typename VecOf<kWords>::T;
  const int per_row = (s.cols - 2 * phi) / kWords;
#pragma unroll 4
  for (int v = threadIdx.x; v < per_row * s.rows; v += kThreads) {
    const int r = v / per_row;
    const int e = r * s.pw + phi + (v - r * per_row) * kWords;
    *reinterpret_cast<V*>(dpl + e) = d_of(
        *reinterpret_cast<const V*>(gr + e),
        *reinterpret_cast<const V*>(gr + e + phi),
        *reinterpret_cast<const V*>(gr + e - phi));
  }
}

// Frequency-major: G (the staged region [bin][frame] transposed) and D;
// lanes along the frames, so the reads are consecutive and the writes at
// the odd pitch conflict-free.
template <int kThreads>
__device__ __forceinline__ void build_gd(float* gpl, float* dpl,
                                         const float* raw, const Layout& s,
                                         int phi) {
#pragma unroll 4
  for (int v = threadIdx.x; v < s.rows * s.cols; v += kThreads) {
    const int x = v / s.rows;
    const int r = v - x * s.rows;
    const int e = x * s.rp + r;
    const float c = raw[e];
    gpl[r * s.pw + x] = c;
    if (x >= phi && x < s.cols - phi) {
      dpl[r * s.pw + x] = d_of(c, raw[e + phi * s.rp],
                               raw[e - phi * s.rp]);
    }
  }
}

template <bool kTimeMajor, int kTau, int kPhi>
__global__ void __launch_bounds__(Tile<kTimeMajor, kTau>::kThreads,
                                  Tile<kTimeMajor, kTau>::kMinBlocks)
sync_kernel(const float* __restrict__ grid, float* __restrict__ out,
            Geometry g, int vec) {
  using T = Tile<kTimeMajor, kTau>;
  constexpr int kThreads = T::kThreads;
  constexpr int kCells = T::kCells;
  // D by 16 or 8 bytes where phi and the (time-major) pitch allow
  constexpr int kBuildWords = !kTimeMajor || kPhi == 0 ? 1
                              : kPhi % 4 == 0 ? 4 : kPhi % 2 == 0 ? 2 : 1;
  const int tau = kTau > 0 ? kTau : g.tau;
  const int phi = kPhi > 0 ? kPhi : g.phi;
  const TileShape ts = kTau > 0 ? T::widest(kTau > 0 ? kTau : 1)
                                 : g.tile;
  const int cells = ts.cells;                     // start times a thread
  const int lanes = ts.lanes;                     // frequencies of a tile
  const int times = cells * tau;                  // start times of a tile
  const Layout s = layout_of<kTimeMajor>(tau, phi, ts);

  extern __shared__ __align__(16) float smem[];
  float* const dpl = smem + 2 * s.raw_words;
  float* const gpl = dpl + s.plane_words;          // frequency-major
  __shared__ int s_count[T::kMaxTimes];

  const int t_tile = kTimeMajor ? blockIdx.y : blockIdx.x;
  const int f_tile = kTimeMajor ? blockIdx.x : blockIdx.y;
  const int t0 = g.t_start + t_tile * times;       // first start frame
  const int f0 = f_tile * lanes;
  const float* const src = grid + static_cast<int64_t>(blockIdx.z) * g.sb;
  // bins a valid cell reads: f + c phi <= num_freqs - 1 + 7 phi
  const int bin_end = g.num_freqs + 7 * phi;

  // the comparisons counted per start time of the tile
  if (threadIdx.x < times) {
    const int base = floor_div(t0 + static_cast<int>(threadIdx.x), tau);
    int n = 0;
    for (int m = 0; m < NUM_SEQS; ++m) {
#pragma unroll
      for (int k = 0; k < COSTAS_LEN; ++k) {
        const int ba = base + m * SEQ_STRIDE + k;
        if (ba < 0 || ba >= g.num_blocks) continue;
        n += (costas_tone(k) == 0 ? 1 : 2) + (k > 0 && ba > 0)
             + (k < COSTAS_LEN - 1 && ba + 1 < g.num_blocks);
      }
    }
    s_count[threadIdx.x] = n;
  }

  auto stage = [&](int m, float* dst) {
    const int r0 = t0 + m * SEQ_STRIDE * tau;
    if (vec == 4) {
      stage_region<kTimeMajor, kThreads, 4>(dst, src, s, g, r0, f0, bin_end);
    } else if (vec == 2) {
      stage_region<kTimeMajor, kThreads, 2>(dst, src, s, g, r0, f0, bin_end);
    } else {
      stage_region<kTimeMajor, kThreads, 1>(dst, src, s, g, r0, f0, bin_end);
    }
    cp_async_commit();
  };

  // this thread's cells: frequency i, start times j0 + tau q, q < cells (a
  // thread past the tile, j0 >= tau, only stages)
  const int i = threadIdx.x % lanes;
  const int j0 = threadIdx.x / lanes;
  const bool active = kTau > 0 || j0 < tau;
  const int cell0 = j0 * s.pw + i;                // frame j0, bin i
  const int base0 = floor_div(t0 + j0, tau);       // floor(t / tau), cell 0
  float total[kCells];
#pragma unroll
  for (int q = 0; q < kCells; ++q) total[q] = 0.0f;

  // sequence m from the staged region gr and the D plane; kChecked: some
  // tap of some cell is invalid (the pre-roll and the tail), so every
  // term is masked
  auto sum = [&](auto checked, int m, const float* gr) {
    constexpr bool kChecked = decltype(checked)::value;
#pragma unroll
    for (int k = 0; k < COSTAS_LEN; ++k) {
      const int c = costas_tone(k);
      const int off = k * tau * s.pw + c * phi;    // frame j0 + k tau, bin
      // P at frames j0 + tau (k + q), q = 0..kCells, from the staged
      // values there and one symbol before: cell q's previous term and
      // cell q - 1's next term
      float pv[kCells + 1];
      float v = k > 0 ? gr[cell0 + off - tau * s.pw] : 0.0f;
#pragma unroll
      for (int q = 0; q <= kCells; ++q) {
        if (q > cells || (q == cells && k == COSTAS_LEN - 1)) break;
        const float w = gr[cell0 + off + tau * q * s.pw];
        if (k > 0 || q > 0) pv[q] = __fsub_rn(w, v);
        v = w;
      }
#pragma unroll
      for (int q = 0; q < kCells; ++q) {
        if (q == cells) break;
        const int e = cell0 + off + tau * q * s.pw;
        const float freq = c != 0 ? dpl[e]
                                  : __fsub_rn(gr[e], gr[e + phi]);  // H
        const int ba = base0 + q + m * SEQ_STRIDE + k;
        const bool valid = !kChecked || (ba >= 0 && ba < g.num_blocks);
        if (valid) total[q] = __fadd_rn(total[q], freq);
        if (k > 0 && valid && (!kChecked || ba > 0)) {
          total[q] = __fadd_rn(total[q], pv[q]);          // + prev
        }
        if (k < COSTAS_LEN - 1 && valid
            && (!kChecked || ba + 1 < g.num_blocks)) {
          total[q] = __fsub_rn(total[q], pv[q + 1]);      // + next
        }
      }
    }
  };

  stage(0, smem);
  stage(1, smem + s.raw_words);
#pragma unroll 1
  for (int m = 0; m < NUM_SEQS; ++m) {
    if (m + 1 < NUM_SEQS) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();             // region m landed; sum m - 1 is done
    float* const ring = smem + (m & 1) * s.raw_words;   // region m
    const float* gr = ring;                   // region m, frame-major
    if (kTimeMajor) {
      build_d<kThreads, kBuildWords>(dpl, ring, s, phi);
    } else {
      build_gd<kThreads>(gpl, dpl, ring, s, phi);
      gr = gpl;
    }
    __syncthreads();
    // every tap of every cell valid: cell, prev (k >= 1) and next (k <= 5)
    if (active) {
      if (base0 + m * SEQ_STRIDE >= 0
          && base0 + cells - 1 + m * SEQ_STRIDE + COSTAS_LEN - 1
             < g.num_blocks) {
        sum(std::false_type(), m, gr);
      } else {
        sum(std::true_type(), m, gr);
      }
    }
    if (m + 2 < NUM_SEQS) {
      __syncthreads();           // every read of region m is done
      stage(m + 2, ring);
    }
  }
  if (!active) return;

  const int64_t slot_cells = static_cast<int64_t>(g.num_times) * g.num_freqs;
  float* const dst = out + static_cast<int64_t>(blockIdx.z) * slot_cells;
  const int f = f0 + i;
#pragma unroll
  for (int q = 0; q < kCells; ++q) {
    if (q == cells) break;
    const int jt = j0 + tau * q;
    const int j = t_tile * times + jt;
    if (j >= g.num_times || f >= g.num_freqs) continue;
    const int n = s_count[jt];
    const float score = n > 0
        ? __fmul_rn(total[q], __frcp_rn(fmaxf(static_cast<float>(n), 1.0f)))
        : -INFINITY;
    dst[kTimeMajor ? static_cast<int64_t>(j) * g.num_freqs + f
                   : static_cast<int64_t>(f) * g.num_times + j] = score;
  }
}

// The widest copy (16, 8 or 4 bytes) every staged vector can take: the
// grid's contiguous axis (bins time-major, frames frequency-major) of
// stride 1, and the base, the other strides and every region's first
// element along that axis multiples of the vector.
template <bool kTimeMajor>
int vector_words(const void* grid, int batch, const Geometry& g) {
  if ((kTimeMajor ? g.sf : g.st) != 1) return 1;
  const int64_t line = kTimeMajor ? g.st : g.sf;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(grid);
  for (int v = 4; v > 1; v /= 2) {
    const bool start = kTimeMajor
        ? g.tile.lanes % v == 0
        : g.t_start % v == 0 && (g.tile.cells * g.tau) % v == 0
          && (SEQ_STRIDE * g.tau) % v == 0;
    if (start && addr % (4 * v) == 0 && line % v == 0
        && (batch == 1 || g.sb % v == 0)) {
      return v;
    }
  }
  return 1;
}

// The tile of an osr: the instances' own; for the generic one the widest
// that fits (fewer lanes first, then fewer cells).  Returns false if none
// does.
template <bool kTimeMajor, int kTau>
bool choose_tile(int tau, int phi, TileShape* tile, int* bytes) {
  using T = Tile<kTimeMajor, kTau>;
  if (tau < 1 || phi < 1 || tau > T::kThreads) return false;
  TileShape t = T::widest(tau);
  if (kTau == 0) {
    while (t.cells > 1 && t.cells * tau > T::kMaxTimes) --t.cells;
    while (t.lanes > 1 && smem_bytes<kTimeMajor>(tau, phi, t) > MAX_SMEM) {
      --t.lanes;
    }
    while (t.cells > 1 && smem_bytes<kTimeMajor>(tau, phi, t) > MAX_SMEM) {
      --t.cells;
    }
  }
  *tile = t;
  *bytes = smem_bytes<kTimeMajor>(tau, phi, t);
  return t.cells * tau <= T::kMaxTimes && *bytes <= MAX_SMEM;
}

template <bool kTimeMajor, int kTau, int kPhi>
int launch(const void* grid, void* out, int batch, Geometry g,
           void* stream) {
  using T = Tile<kTimeMajor, kTau>;
  int bytes = 0;
  if (!choose_tile<kTimeMajor, kTau>(g.tau, g.phi, &g.tile, &bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int times = g.tile.cells * g.tau, lanes = g.tile.lanes;
  // the dynamic shared memory, and all of L1 as shared memory, so that
  // three blocks fit an SM
  cudaError_t err = cudaFuncSetAttribute(
      sync_kernel<kTimeMajor, kTau, kPhi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(sync_kernel<kTimeMajor, kTau, kPhi>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int t_tiles = (g.num_times + times - 1) / times;
  const int f_tiles = (g.num_freqs + lanes - 1) / lanes;
  const dim3 blocks(kTimeMajor ? f_tiles : t_tiles,
                    kTimeMajor ? t_tiles : f_tiles, batch);
  sync_kernel<kTimeMajor, kTau, kPhi><<<blocks, T::kThreads, bytes,
                                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grid), static_cast<float*>(out), g,
      vector_words<kTimeMajor>(grid, batch, g));
  return static_cast<int>(cudaGetLastError());
}

template <bool kTimeMajor>
int launch_osr(const void* grid, void* out, int batch, const Geometry& g,
               void* stream) {
  if (batch == 0 || g.num_times == 0 || g.num_freqs == 0) return cudaSuccess;
  if (g.tau < 1 || g.phi < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (g.tau == 4 && g.phi == 4) {
    return launch<kTimeMajor, 4, 4>(grid, out, batch, g, stream);
  }
  if (g.tau == 2 && g.phi == 2) {
    return launch<kTimeMajor, 2, 2>(grid, out, batch, g, stream);
  }
  return launch<kTimeMajor, 0, 0>(grid, out, batch, g, stream);
}

}  // namespace

extern "C" {

// The tile a launch at osr tau x phi takes: start times a thread, lanes and
// shared memory of a block.  Returns 0, or cudaErrorInvalidValue for an osr
// below 1 or one that fits no tile.
int ft8_sync_tile(int time_major, int tau, int phi, int* cells, int* lanes,
                  int* smem) {
  TileShape t{0, 0};
  int bytes = 0;
  bool fits;
  if (tau == 4 && phi == 4) {
    fits = time_major ? choose_tile<true, 4>(tau, phi, &t, &bytes)
                      : choose_tile<false, 4>(tau, phi, &t, &bytes);
  } else if (tau == 2 && phi == 2) {
    fits = time_major ? choose_tile<true, 2>(tau, phi, &t, &bytes)
                      : choose_tile<false, 2>(tau, phi, &t, &bytes);
  } else {
    fits = time_major ? choose_tile<true, 0>(tau, phi, &t, &bytes)
                      : choose_tile<false, 0>(tau, phi, &t, &bytes);
  }
  *cells = t.cells;
  *lanes = t.lanes;
  *smem = bytes;
  return fits ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Launches the stencil on `stream`; returns cudaGetLastError() (or
// cudaErrorInvalidValue for an osr below 1 or one that fits no tile: see
// ft8_sync_tile).
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
                   num_times, num_freqs, TileShape{0, 0}};
  return time_major ? launch_osr<true>(grid, out, batch, g, stream)
                    : launch_osr<false>(grid, out, batch, g, stream);
}

}  // extern "C"
