// Everything the device step computes after the coverage pileup, for
// Hopper (sm_90a): the repeat run-length scan, the marker selection and
// fragment spans, the packed per-read output row, and the int8 coverage
// diff of the `diff8` return mode, for one length bucket of reads.
//
// Replaces the device stages of raft_tpu/engine_jax.py that XLA fused into
// one program with the pileup on the TPU: repeat_scan (:277-316),
// chop_markers (:323-374), the diff8 / ok8 branch of device_step_impl
// (:432-437) and its packing concatenate (:446-451). It is not a Pallas
// kernel: the one Pallas kernel (the pileup) is csrc/pileup.cu.
//
// Row for row it is repeat_scan -> chop_markers -> packing, bit-equal in
// every column, unused slots included, with JAX's int32 semantics: floor
// division and modulo, and products and sums that wrap (formed in uint32).
//
// What bounds it on an H100: the bytes. Per window it does a compare and
// a few flag operations; per marker a binary search over the row's repeat
// slots. The least time is the coverage and lengths read once (4*B*W +
// 4*B bytes), the packed rows written once (4*B*(2K+2F+5)) and, in diff8
// mode, the int8 diff (B*W), over 3.35 TB/s.
//
// How the coverage is read. A warp walks its windows in order, a step of
// four 128-window tiles at a time: in each tile lane l loads windows
// 4l..4l+3 as one 16-byte load, so a warp load is 512 contiguous bytes
// and all four loads of a step are in flight together (rows with W % 4 !=
// 0 are not 16-byte aligned and load the same windows as ints). The run
// marks of a tile come from the lane's four windows and the previous
// lane's last window (__shfl_up_sync). Runs are joined across lanes with
// ballots: the start a lane inherits is the last start of the nearest
// lower lane that has one (__ballot_sync, __clz, one shuffle); a lane
// ends at most two runs in four windows, so two ballots of its count of
// qualifying run ends give every run its slot rank (__popc). From tile to
// tile the warp carries the last window's coverage, the last run start
// and the runs counted so far, so each run knows its rank while its tile
// is still in registers. The diff8 row leaves from the same registers, 4
// bytes a lane, 128 contiguous bytes a warp store. Without diff8 only
// the read's own windows (< ceil(len/reso)) are read.
//
// Two regimes, picked by ops/scan_chop_cuda.launch_plan:
//
// 1. Rows (the bench path's widths and flags): a warp per row, 8 rows a
//    block, no block barrier anywhere (__syncwarp only). The row is read
//    once. Each warp builds its packed row and compacts its surviving
//    markers in its slice of shared memory: the binary searches and the
//    fragment gathers read shared memory, and the packed row leaves once,
//    in coalesced stores. The plan takes this regime only where the
//    slices fit and the markers are few (a warp tests 32 at a time).
// 2. Cluster (few very wide rows, e.g. 8 x 2^20 windows, and rows whose
//    slots or markers are too many for a warp): a thread-block
//    cluster of C blocks per row (C = 16 takes 128 of the 132 SMs at 8
//    rows), each warp a contiguous segment of the row. Pass 1 walks each
//    segment and keeps its aggregate: its last run start, the one run end
//    whose start lies before the segment, its qualifying runs inside and
//    their length sum (and the diff8 row). A block folds its warps'
//    aggregates; the blocks read each other's through distributed shared
//    memory (map_shared_rank) after cluster.sync(), which gives each
//    block its carry-in (last start, slot rank) and the row's rep_n and
//    rep_len_sum. Pass 2 walks again, from L2 (8 rows x 4 MB fit the 50
//    MB L2), only the segments that end a qualifying run with a free
//    slot, and writes those slots. A block copies the row's slots to its
//    shared memory for the searches where they fit (else it searches them
//    in global memory). The marker candidates are split over the
//    cluster; each block compacts its survivors in its shared memory (or
//    a global [B, M] scratch where they do not fit), scans the blocks'
//    counts and gathers its share of the fragments from them. Slots and
//    survivors written to global memory by one block are read by the
//    others only after a cluster.sync(): barrier.cluster.arrive is a
//    release and barrier.cluster.wait an acquire at cluster scope, which
//    orders those global writes before the reads. The last cluster.sync()
//    keeps every block's shared memory alive while the others read it.
//    This two-pass design was chosen over a decoupled
//    look-back over a (row, tile) grid because it needs no flag protocol
//    in global memory, and every block of a row is resident at once.
//
// Markers, in both regimes: a candidate is deleted when a repeat slot
// stabs it. Within a row the slots are disjoint runs in window order, so
// s and e are both non-decreasing and a binary search for the last slot
// with s <= v decides it: only a product that wraps int32 can break that
// order, and a row where it broke takes a linear scan of its slots.
// Fragment indices are clipped to [0, M-1] and read 0 past the survivors.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE = 128;      // windows of one 16-byte load per lane
constexpr int UNROLL = 4;      // tiles a warp keeps in flight
constexpr int STEP = TILE * UNROLL;
constexpr int ROWS_WARPS = 8;  // regime 1: rows (warps) per block
constexpr int WIDE_THREADS = 512;  // regime 2: most threads per block
constexpr int WIDE_FIXED = 512;    // regime 2: ints of bookkeeping
constexpr int MAX_CLUSTER = 16;

struct Params {
  int B, W, M, K, F;
  int reso, high_cov, repeat_length, flank;
  int il, div, ov;
  int diff8;       // write the int8 diff and the ok8 flag
  int seg;         // regime 2: windows a warp walks (a multiple of TILE)
  int slice;       // regime 1: ints of a warp's shared slice
  int slot_cap;    // regime 2: slot pairs a block copies to shared memory
  int mc;          // regime 2: marker candidates per block
  int stars_smem;  // regime 2: survivors in shared memory
};

// int32 arithmetic that wraps, as JAX's does (signed overflow is undefined
// in C++).
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// JAX's // and % on int32: the quotient rounds toward minus infinity and
// the remainder takes the divisor's sign (C's / and % truncate). b != 0.
__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
__device__ __forceinline__ int floormod(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

__device__ __forceinline__ int warp_sum(int x) {  // wraps
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = wadd(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// A row's read: its length, the windows that may be high (< lim), and the
// windows walked (< wend: all W in diff8 mode, else lim).
struct Read {
  int len, lim, wend;
};

__device__ __forceinline__ Read read_of(int len, const Params& p) {
  const int n_win = wsub(0, floordiv(wsub(0, len), p.reso));  // ceil
  const int lim = min(p.W, max(n_win, 0));
  return {len, lim, p.diff8 ? p.W : lim};
}

// What a warp carries along its windows. prev, start and rank are the
// same in every lane; open_end, len_sum and bad8 are per lane.
struct Walk {
  int prev;      // coverage of the window before the next tile
  int start;     // the last run start so far, -1 if none
  int rank;      // qualifying runs ended so far
  int open_end;  // a run end whose start was not known (pass 1), else -1
  int len_sum;   // this lane's qualifying run lengths, wrapping
  bool bad8;     // this lane saw a diff outside int8
};

// A qualifying run [rs, re] into its slot: flanked, clamped to [0, len].
__device__ __forceinline__ void put_slot(int* slots, int r, int rs, int re,
                                         int len, const Params& p) {
  slots[r] = max(wsub(wmul(rs, p.reso), p.flank), 0);
  slots[p.K + r] = min(wadd(wmul(re + 1, p.reso), p.flank), len);
}

// Lane l's four windows g..g+3 of a tile; windows at or past wend read 0.
template <bool VEC>
__device__ __forceinline__ void load4(const int* row, int g, int wend,
                                      int (&x)[4]) {
  if (VEC) {  // W % 4 == 0, so g < wend <= W holds all four
    if (g < wend) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(row + g));
      x[0] = v.x;
      x[1] = v.y;
      x[2] = v.z;
      x[3] = v.w;
    } else {
      x[0] = x[1] = x[2] = x[3] = 0;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = g + i < wend ? __ldg(row + g + i) : 0;
  }
}

// One tile: the run marks at this lane's boundaries g..g+3 (boundary w
// lies between windows w-1 and w), the diff8 bytes, the qualifying run
// ends with their slots (WRITE: slots != nullptr, rank < K).
template <bool VEC, bool WRITE>
__device__ __forceinline__ void tile(const int (&x)[4], int g,
                                     const Params& p, const Read& rd,
                                     Walk& s, int* slots, signed char* d8) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int pv = __shfl_up_sync(FULL, x[3], 1);
  if (lane == 0) pv = s.prev;
  s.prev = __shfl_sync(FULL, x[3], 31);
  if (d8 != nullptr) {
    unsigned word = 0;
    int q = pv;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = wsub(x[i], q);
      q = x[i];
      s.bad8 |= d < -128 || d > 127;
      word |= (static_cast<unsigned>(d) & 0xffu) << (8 * i);
    }
    if (VEC) {
      if (g < p.W) *reinterpret_cast<unsigned*>(d8 + g) = word;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (g + i < p.W)
          d8[g + i] = static_cast<signed char>(
              static_cast<unsigned char>(word >> (8 * i)));
    }
  }
  bool hp = g >= 1 && g - 1 < rd.lim && pv >= p.high_cov;
  unsigned st = 0, en = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool h = g + i < rd.lim && x[i] >= p.high_cov;
    if (h && !hp) st |= 1u << i;
    if (!h && hp) en |= 1u << i;
    hp = h;
  }
  const unsigned smask = __ballot_sync(FULL, st != 0);
  const int last = st ? g + 31 - __clz(st) : -1;
  const unsigned lower = smask & below;
  const int from = __shfl_sync(FULL, last, lower ? 31 - __clz(lower) : 0);
  int rs = lower ? from : s.start;
  if (smask) s.start = __shfl_sync(FULL, last, 31 - __clz(smask));
  if (!__any_sync(FULL, en != 0)) return;
  int n = 0, s0 = 0, e0 = 0, s1 = 0, e1 = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (en >> i & 1u) {
      const int re = g + i - 1;
      if (rs < 0) {
        s.open_end = re;
      } else {
        const int span = wmul(re - rs + 1, p.reso);
        if (span >= p.repeat_length) {
          if (n == 0) {
            s0 = rs;
            e0 = re;
          } else {
            s1 = rs;
            e1 = re;
          }
          ++n;
          s.len_sum = wadd(s.len_sum, span);
        }
      }
    }
    if (st >> i & 1u) rs = g + i;
  }
  const unsigned b1 = __ballot_sync(FULL, n & 1);
  const unsigned b2 = __ballot_sync(FULL, n & 2);
  if (WRITE && n) {
    const int r = s.rank + __popc(b1 & below) + 2 * __popc(b2 & below);
    if (r < p.K) put_slot(slots, r, s0, e0, rd.len, p);
    if (n == 2 && r + 1 < p.K) put_slot(slots, r + 1, s1, e1, rd.len, p);
  }
  s.rank += __popc(b1) + 2 * __popc(b2);
}

// A warp walks windows [lo, min(hi, wend)) of its row (lo a multiple of
// TILE) a step at a time, then the boundary at wend when no tile held it:
// a run still open at the last window walked ends there.
template <bool VEC, bool WRITE>
__device__ void walk(const int* row, int lo, int hi, const Params& p,
                     const Read& rd, Walk& s, int* slots, signed char* d8) {
  const int lane = threadIdx.x & 31;
  const int end = min(hi, rd.wend);
  for (int base = lo; base < end; base += STEP) {
    int x[UNROLL][4];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      load4<VEC>(row, base + u * TILE + 4 * lane, rd.wend, x[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (base + u * TILE < end)
        tile<VEC, WRITE>(x[u], base + u * TILE + 4 * lane, p, rd, s, slots,
                         d8);
  }
  const int w = rd.wend - 1;
  if (rd.wend % TILE == 0 && lo <= w && w < hi && w < rd.lim &&
      s.prev >= p.high_cov) {
    if (s.start < 0) {
      s.open_end = w;
    } else {
      const int span = wmul(w - s.start + 1, p.reso);
      if (span >= p.repeat_length) {
        if (WRITE && lane == 0 && s.rank < p.K)
          put_slot(slots, s.rank, s.start, w, rd.len, p);
        if (lane == 0) s.len_sum = wadd(s.len_sum, span);
        ++s.rank;
      }
    }
  }
}

// Does a repeat slot (ss[k], se[k]), k < n, stab marker value v?
__device__ __forceinline__ bool stabbed(int v, const int* ss, const int* se,
                                        int n, bool sorted) {
  if (sorted) {
    int a = 0, z = n;  // a = the number of slots with s <= v
    while (a < z) {
      const int m = (a + z) >> 1;
      if (ss[m] <= v)
        a = m + 1;
      else
        z = m;
    }
    return a > 0 && se[a - 1] >= v;
  }
  for (int k = 0; k < n; ++k)
    if (ss[k] <= v && v <= se[k]) return true;
  return false;
}

// A row's marker candidates: j*il up to the last whole part, then len;
// only j < n_stars can survive.
struct Stars {
  int parts, n_stars, jend;
};

__device__ __forceinline__ Stars stars_of(int len, const Params& p) {
  const int parts = floordiv(len, p.il);
  const int n_stars =
      wadd(wadd(parts, 1), floormod(len, p.il) != 0 ? 1 : 0);
  return {parts, n_stars, min(p.M, max(n_stars, 0))};
}

__device__ __forceinline__ bool keep_star(int j, int len, const Stars& c,
                                          const Params& p, const int* ss,
                                          const int* se, int n_slots,
                                          bool sorted, int* val) {
  *val = j <= c.parts ? wmul(j, p.il) : len;
  return j == 0 || j == wsub(c.n_stars, 1) ||
         !stabbed(*val, ss, se, n_slots, sorted);
}

// The fragment columns and the five scalars of a packed row, from the S
// survivors that star(i) returns; f strides from `first` by `stride`.
template <class Star>
__device__ __forceinline__ void fragments(int* out, int len, int S,
                                          int rep_n, int rep_len_sum,
                                          bool bad8, const Params& p,
                                          Star star, int first, int stride) {
  const int d1 = wadd(p.div, 1);
  const bool whole = S <= d1;
  const int extra = wsub(S, d1);
  const int n_frag =
      whole ? 1
            : wadd(wadd(1, floordiv(extra, p.div)),
                   floormod(extra, p.div) != 0 ? 1 : 0);
  const int last_star = star(wsub(S, 1));
  const int cs = 2 * p.K;
  const int cl = cs + p.F;
  for (int f = first; f < p.F; f += stride) {
    const int pos = wmul(f, p.div);
    const int star_f = star(pos);
    const int last_f =
        f == wsub(n_frag, 1) ? last_star : star(wadd(pos, p.div));
    const int ov_f = f == 0 ? 0 : p.ov;
    out[cs + f] = whole ? 0 : wsub(star_f, ov_f);
    out[cl + f] = whole ? len : wadd(wsub(last_f, star_f), ov_f);
  }
  if (first == 0) {
    int* const sc = out + 2 * p.K + 2 * p.F;
    sc[0] = rep_n;
    sc[1] = rep_len_sum;
    sc[2] = n_frag;
    sc[3] = whole ? 1 : 0;
    sc[4] = bad8 ? 0 : 1;  // always 1 outside diff8 mode
  }
}

// Regime 1: a warp per row. cov [B, W] int32; lens [B] int32; packed [B,
// 2K+2F+5] int32 in engine_torch.unpack_out's column order; diff8 [B, W]
// int8 (diff8 mode only). A warp builds its packed row and compacts its
// survivors in its slice of shared memory (slice = 2K+2F+5+M ints).
template <bool VEC>
__global__ void __launch_bounds__(32 * ROWS_WARPS)
    scan_chop_rows(const int* __restrict__ cov, const int* __restrict__ lens,
                   int* __restrict__ packed, signed char* __restrict__ diff8,
                   int* /*stars: unused*/, Params p) {
  extern __shared__ int4 dyn[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int b = blockIdx.x * ROWS_WARPS + warp;
  if (b >= p.B) return;  // the whole warp: no block barrier follows
  const int P = 2 * p.K + 2 * p.F + 5;
  int* const gout = packed + static_cast<long long>(b) * P;
  int* const prow = reinterpret_cast<int*>(dyn) + warp * p.slice;
  int* const srow = prow + P;
  const Read rd = read_of(lens[b], p);

  Walk s{0, -1, 0, -1, 0, false};
  walk<VEC, true>(cov + static_cast<long long>(b) * p.W, 0, rd.wend, p, rd,
                  s, prow,
                  p.diff8 ? diff8 + static_cast<long long>(b) * p.W : nullptr);
  const int rep_n = s.rank;
  const int rep_len_sum = warp_sum(s.len_sum);
  const bool bad8 = __any_sync(FULL, s.bad8);
  const int n_slots = min(rep_n, p.K);
  for (int k = n_slots + lane; k < p.K; k += 32) {  // empty: s=1 > e=0
    prow[k] = 1;
    prow[p.K + k] = 0;
  }
  __syncwarp();
  bool unsorted = false;
  for (int k = lane; k + 1 < n_slots; k += 32)
    unsorted |= prow[k] > prow[k + 1] || prow[p.K + k] > prow[p.K + k + 1];
  const bool sorted = !__any_sync(FULL, unsorted);

  const Stars c = stars_of(rd.len, p);
  int S = 0;
  for (int j0 = 0; j0 < c.jend; j0 += 32) {
    const int j = j0 + lane;
    int val = 0;
    const bool keep = j < c.jend && keep_star(j, rd.len, c, p, prow,
                                              prow + p.K, n_slots, sorted,
                                              &val);
    const unsigned bal = __ballot_sync(FULL, keep);
    if (keep) srow[S + __popc(bal & below)] = val;
    S += __popc(bal);
  }
  __syncwarp();
  const int M = p.M;
  fragments(prow, rd.len, S, rep_n, rep_len_sum, bad8, p,
            [=](int i) {
              const int k = min(max(i, 0), M - 1);
              return k < S ? srow[k] : 0;
            },
            lane, 32);
  __syncwarp();
  for (int i = lane; i < P; i += 32) gout[i] = prow[i];
}

// Regime 2's aggregate of a stretch of a row: the last run start (-1:
// none), the one run end whose start lies before the stretch (-1: none),
// the qualifying runs that start and end inside it, their length sum
// (wrapping) and whether a diff left int8.
struct Agg {
  int last_start, open_end, n_q, len_sum, bad8;
};

__device__ __forceinline__ Agg agg_identity() { return {-1, -1, 0, 0, 0}; }

// a, then b right after it. If a holds no start, a and b cannot both hold
// an open end: after a's, a stays low to its end.
__device__ __forceinline__ Agg combine(const Agg& a, const Agg& b,
                                       const Params& p) {
  Agg r{b.last_start >= 0 ? b.last_start : a.last_start, a.open_end,
        a.n_q + b.n_q, wadd(a.len_sum, b.len_sum), a.bad8 | b.bad8};
  if (b.open_end >= 0) {
    if (a.last_start >= 0) {
      const int span = wmul(b.open_end - a.last_start + 1, p.reso);
      if (span >= p.repeat_length) {
        ++r.n_q;
        r.len_sum = wadd(r.len_sum, span);
      }
    } else {
      r.open_end = b.open_end;
    }
  }
  return r;
}

// Regime 2: a cluster of C blocks per row (grid B*C); arguments as
// scan_chop_rows, with stars used where survivors do not fit in shared
// memory (block r's at [r*mc, (r+1)*mc) of its row).
template <bool VEC>
__global__ void __launch_bounds__(WIDE_THREADS)
    scan_chop_cluster(const int* __restrict__ cov,
                      const int* __restrict__ lens, int* packed,
                      signed char* __restrict__ diff8, int* stars, Params p) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ int4 dyn[];
  int* const sm = reinterpret_cast<int*>(dyn);
  Agg* const agg = reinterpret_cast<Agg*>(sm);  // [32] warps, [32] block
  Agg* const blk = agg + 32;
  int* const wcar = sm + 5 * 33;   // [32][3]: start, rank, writes
  int* const misc = wcar + 3 * 32; // [0] unsorted [1] kept [2-4] row [5] sorted
  int* const scan = misc + 8;      // [33] per-warp counts
  int* const cbase = scan + 33;    // [16] bases, [16] counts, [32] S
  int* const sl = sm + WIDE_FIXED; // [2 * slot_cap] slots copied
  int* const kept = sl + 2 * p.slot_cap;  // [mc] survivors, if stars_smem

  const int C = static_cast<int>(cluster.num_blocks());
  const int c = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int nw = T >> 5;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;
  const int* const row = cov + static_cast<long long>(b) * p.W;
  int* const out = packed + static_cast<long long>(b) * (2 * p.K + 2 * p.F + 5);
  const Read rd = read_of(lens[b], p);
  const int lo = (c * nw + warp) * p.seg;
  const int first = lo > 0 && lo < rd.wend ? __ldg(row + lo - 1) : 0;

  // pass 1: each warp's aggregate, then the block's
  Walk s{first, -1, 0, -1, 0, false};
  walk<VEC, false>(row, lo, lo + p.seg, p, rd, s, nullptr,
                   p.diff8 ? diff8 + static_cast<long long>(b) * p.W
                           : nullptr);
  const Agg mine{s.start, warp_max(s.open_end), s.rank, warp_sum(s.len_sum),
                 __any_sync(FULL, s.bad8) ? 1 : 0};
  if (lane == 0) agg[warp] = mine;
  __syncthreads();
  if (tid == 0) {
    Agg t = agg_identity();
    for (int w = 0; w < nw; ++w) t = combine(t, agg[w], p);
    *blk = t;
  }
  cluster.sync();  // every block's aggregate is in its shared memory

  // carries: the row before this block from the blocks' aggregates, then
  // before each warp; the row's totals
  if (tid == 0) {
    Agg t = agg_identity(), before = agg_identity();
    for (int r = 0; r < C; ++r) {
      if (r == c) before = t;
      t = combine(t, *cluster.map_shared_rank(blk, r), p);
    }
    misc[2] = t.n_q;
    misc[3] = t.len_sum;
    misc[4] = t.bad8;
    for (int w = 0; w < nw; ++w) {
      const Agg n = combine(before, agg[w], p);
      wcar[3 * w] = before.last_start;
      wcar[3 * w + 1] = before.n_q;
      wcar[3 * w + 2] = n.n_q > before.n_q && before.n_q < p.K;
      before = n;
    }
  }
  __syncthreads();
  const int rep_n = misc[2];
  const int n_slots = min(rep_n, p.K);

  // pass 2: the segments that end a qualifying run with a free slot
  if (wcar[3 * warp + 2]) {
    Walk s2{first, wcar[3 * warp], wcar[3 * warp + 1], -1, 0, false};
    walk<VEC, true>(row, lo, lo + p.seg, p, rd, s2, out, nullptr);
  }
  for (int k = n_slots + c * T + tid; k < p.K; k += C * T) {
    out[k] = 1;
    out[p.K + k] = 0;
  }
  cluster.sync();  // the row's slots are in global memory (release/acquire)

  bool unsorted = false;
  for (int k = c * T + tid; k + 1 < n_slots; k += C * T)
    unsorted |= out[k] > out[k + 1] || out[p.K + k] > out[p.K + k + 1];
  const int any_unsorted = __syncthreads_or(unsorted);
  if (tid == 0) misc[0] = any_unsorted;
  cluster.sync();  // every block's order flag is in its shared memory
  if (warp == 0) {
    const int f = lane < C ? *cluster.map_shared_rank(misc, lane) : 0;
    const unsigned any = __ballot_sync(FULL, f != 0);
    if (lane == 0) misc[5] = any == 0;
  }
  const bool in_smem = n_slots <= p.slot_cap;
  if (in_smem) {
    for (int k = tid; k < n_slots; k += T) {
      sl[k] = out[k];
      sl[p.slot_cap + k] = out[p.K + k];
    }
  }
  __syncthreads();
  const bool sorted = misc[5] != 0;
  const int* const ss = in_smem ? sl : out;
  const int* const se = in_smem ? sl + p.slot_cap : out + p.K;

  // this block's share of the marker candidates, compacted in order
  const Stars cs = stars_of(rd.len, p);
  const int jlo = c * p.mc;
  const int jhi = min(jlo + p.mc, cs.jend);
  int* const kbuf =
      p.stars_smem ? kept : stars + static_cast<long long>(b) * p.M + jlo;
  int cnt = 0;
  for (int j0 = jlo; j0 < jhi; j0 += T) {
    const int j = j0 + tid;
    int val = 0;
    const bool keep =
        j < jhi && keep_star(j, rd.len, cs, p, ss, se, n_slots, sorted, &val);
    const unsigned bal = __ballot_sync(FULL, keep);
    if (lane == 0) scan[warp] = __popc(bal);
    __syncthreads();
    if (warp == 0) {
      const int v = lane < nw ? scan[lane] : 0;
      int incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      scan[lane] = incl - v;
      if (lane == 31) scan[32] = incl;
    }
    __syncthreads();
    if (keep) kbuf[cnt + scan[warp] + __popc(bal & below)] = val;
    cnt += scan[32];
    __syncthreads();  // scan[] is rewritten by the next tile
  }
  if (tid == 0) misc[1] = cnt;
  cluster.sync();  // every block's survivors and count are in place

  {  // survivors' bases, then this block's share of the fragments
    if (warp == 0) {
      const int n = lane < C ? cluster.map_shared_rank(misc, lane)[1] : 0;
      int incl = n;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane < MAX_CLUSTER) {
        cbase[lane] = incl - n;
        cbase[MAX_CLUSTER + lane] = n;
      }
      if (lane == 31) cbase[2 * MAX_CLUSTER] = incl;
    }
    __syncthreads();
    const int S = cbase[2 * MAX_CLUSTER];
    const int M = p.M;
    const int mc = p.mc;
    const bool on_chip = p.stars_smem != 0;
    int* const grow = stars + static_cast<long long>(b) * p.M;
    auto star = [&](int i) {
      const int k = min(max(i, 0), M - 1);
      if (k >= S) return 0;
      int r = C - 1;
      while (cbase[r] > k || cbase[MAX_CLUSTER + r] == 0) --r;
      const int o = k - cbase[r];
      return on_chip ? cluster.map_shared_rank(kept, r)[o]
                     : grow[r * mc + o];
    };
    fragments(out, rd.len, S, rep_n, misc[3], misc[4] != 0, p, star,
              c * T + tid, C * T);
  }
  cluster.sync();  // no block leaves while another reads its survivors
}

// Above 48 KB of dynamic shared memory a kernel must opt in; a cluster of
// more than 8 blocks must be allowed. Both are attributes of the kernel on
// the current device, set before its launch.
template <typename Kern>
cudaError_t prepare(Kern kernel, int smem, int cluster) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

template <typename Kern>
cudaError_t launch_rows(Kern kernel, int grid, int block, int smem,
                        cudaStream_t s, const int* cov, const int* lens,
                        int* packed, signed char* d8, int* stars,
                        const Params& p) {
  const cudaError_t err = prepare(kernel, smem, 1);
  if (err != cudaSuccess) return err;
  kernel<<<grid, block, smem, s>>>(cov, lens, packed, d8, stars, p);
  return cudaGetLastError();
}

template <typename Kern>
cudaError_t launch_cluster(Kern kernel, int grid, int block, int cluster,
                           int smem, cudaStream_t s, const int* cov,
                           const int* lens, int* packed, signed char* d8,
                           int* stars, const Params& p) {
  cudaError_t err = prepare(kernel, smem, cluster);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, cov, lens, packed, d8, stars, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. Pointers are device pointers (diff8 may
// be null outside diff8 mode, stars where the plan keeps the survivors in
// shared memory); stream is a cudaStream_t. The plan comes from
// ops/scan_chop_cuda.launch_plan: regime 1 (a warp per row, `grid` blocks
// of `block` threads, `slice` ints of shared memory a warp) or 2 (a
// cluster of `cluster` blocks per row, grid
// B * cluster, each warp `seg` windows; `slot_cap` slot pairs and, with
// stars_smem, `mc` survivors in a block's shared memory); `smem` dynamic
// shared memory bytes; `vec` 16-byte loads (W % 4 == 0 and cov 16-byte
// aligned). Returns the first CUDA error of the launch (0 = success).
extern "C" int raft_scan_chop(const void* cov, const void* lens, void* packed,
                              void* diff8, void* stars, int B, int W, int M,
                              int K, int F, int reso, int high_cov,
                              int repeat_length, int flank, int il, int div,
                              int ov, int diff8_mode, int regime, int grid,
                              int block, int cluster, int seg, int slice,
                              int slot_cap, int mc, int stars_smem, int smem,
                              int vec, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const Params p{B,   W,  M,          K,     F,    reso,     high_cov,
                 repeat_length, flank, il, div, ov, diff8_mode, seg, slice,
                 slot_cap, mc, stars_smem};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(cov);
  const int* l = static_cast<const int*>(lens);
  int* o = static_cast<int*>(packed);
  signed char* d = static_cast<signed char*>(diff8);
  int* st = static_cast<int*>(stars);
  cudaError_t err;
  if (regime == 1) {
    err = vec ? launch_rows(scan_chop_rows<true>, grid, block, smem, s, c, l,
                            o, d, st, p)
              : launch_rows(scan_chop_rows<false>, grid, block, smem, s, c,
                            l, o, d, st, p);
  } else {
    err = vec ? launch_cluster(scan_chop_cluster<true>, grid, block, cluster,
                               smem, s, c, l, o, d, st, p)
              : launch_cluster(scan_chop_cluster<false>, grid, block,
                               cluster, smem, s, c, l, o, d, st, p);
  }
  return static_cast<int>(err);
}
