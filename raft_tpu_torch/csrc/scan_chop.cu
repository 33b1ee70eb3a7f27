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
// slots. The least time is the bytes the function must move: the coverage
// and lengths read (4*B*W + 4*B bytes), the packed write (4*B*(2K+2F+5))
// and, in diff8 mode, the int8 diff (B*W), over 3.35 TB/s.
//
// Design: one block per row; ops/scan_chop_cuda.launch_plan picks the
// block size from (W, M). The coverage row stays in global memory (a row
// may hold 2^20 windows, 4 MB) and is read twice, from L1/L2 the second
// time:
//
// 1. Each thread takes a contiguous chunk of windows and finds its run
//    start and end marks. A run that began in an earlier chunk is carried
//    in by a block max-scan of each chunk's last start mark; that settles
//    the one run end of the chunk whose start lies before it. A block sum
//    of each chunk's qualifying run ends (runs of at least repeat_length
//    bp) gives each run its slot rank and the row's rep_n. The diff8 row
//    is written in this pass.
// 2. The chunk is scanned again with its carried start and rank: each
//    qualifying run writes its flanked, clamped (s, e) into its slot of the
//    packed row (rank < K), and a block sum gives rep_len_sum.
// 3. Markers: the M candidates, a block-wide tile at a time. A candidate
//    is deleted when a repeat slot stabs it. Within a row the slots are
//    disjoint runs in window order, so s and e are both non-decreasing and
//    a binary search for the last slot with s <= v decides it: only a
//    product that wraps int32 can break that order, and a row where it
//    broke takes a linear scan of its slots. Survivors compact by a block
//    exclusive sum into the row's scratch, zeroed beyond S.
// 4. Fragments: the F span columns, gathered from the scratch row with
//    JAX's clipped indices, then the five scalar columns.
//
// Fusing this into the pileup's warp-per-row regime, so that the coverage
// row never leaves shared memory, is later work; PERF.md has the measured
// share of the bound.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_WARPS = MAX_THREADS / 32;

struct Params {
  int W, M, K, F;
  int reso, high_cov, repeat_length, flank;
  int il, div, ov;
  int chunk;  // windows per thread in passes 1 and 2
  int diff8;  // write the int8 diff and the ok8 flag
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

struct WrapSum {
  __device__ int operator()(int a, int b) const { return wadd(a, b); }
};
struct Max {
  __device__ int operator()(int a, int b) const { return max(a, b); }
};

// Exclusive scan of x over the block's threads in thread order, under op
// with identity id; *total receives the whole block's reduction. Every
// thread of the block calls it (blockDim.x a multiple of 32). sh holds
// MAX_WARPS + 1 ints and may be reused by the next call.
template <class Op>
__device__ int block_scan(int x, int id, Op op, int* sh, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl = op(incl, y);
  }
  int excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = id;
  __syncthreads();  // every thread has read sh in the previous call
  if (lane == 31) sh[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < nwarps ? sh[lane] : id;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v = op(v, y);
    }
    int e = __shfl_up_sync(FULL, v, 1);
    if (lane == 0) e = id;
    if (lane < nwarps) sh[lane] = e;
    if (lane == 31) sh[MAX_WARPS] = v;
  }
  __syncthreads();
  *total = sh[MAX_WARPS];
  return op(sh[warp], excl);
}

// One block per row b. cov [B, W] int32; lens [B] int32; packed [B, 2K+2F+5]
// int32 in engine_torch.unpack_out's column order; diff8 [B, W] int8 (diff8
// mode only); stars [B, M] int32 scratch. packed and stars are read back
// after a barrier, so they are not declared __restrict__ (that would allow
// the non-coherent read-only path).
__global__ void __launch_bounds__(MAX_THREADS)
scan_chop(const int* __restrict__ cov, const int* __restrict__ lens,
          int* packed, signed char* __restrict__ diff8, int* stars,
          Params p) {
  __shared__ int sh[MAX_WARPS + 1];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int* const row = cov + static_cast<long long>(b) * p.W;
  int* const out = packed + static_cast<long long>(b) * (2 * p.K + 2 * p.F + 5);
  int* const srow = stars + static_cast<long long>(b) * p.M;
  const int len = lens[b];
  const int n_win = wsub(0, floordiv(wsub(0, len), p.reso));  // ceil

  // windows outside [0, W) and at or past the read's last window are low
  auto value = [&](int w) { return (w >= 0 && w < p.W) ? row[w] : 0; };
  auto high = [&](int w, int v) {
    return w >= 0 && w < p.W && w < n_win && v >= p.high_cov;
  };
  auto qualifies = [&](int nwin) {
    return wmul(nwin, p.reso) >= p.repeat_length;
  };

  const int lo = min(tid * p.chunk, p.W);
  const int hi = min(lo + p.chunk, p.W);

  // 1. this chunk's last run start, its one run end whose start lies in an
  // earlier chunk, and its qualifying runs that start and end inside it
  int last_start = -1, open_end = -1, n_q = 0;
  bool bad8 = false;
  {
    int vprev = value(lo - 1);
    bool prev = high(lo - 1, vprev);
    int vcur = value(lo);
    bool cur = high(lo, vcur);
    signed char* const d8 = diff8 + static_cast<long long>(b) * p.W;
    for (int w = lo; w < hi; ++w) {
      const int vnext = value(w + 1);
      const bool next = high(w + 1, vnext);
      if (cur && !prev) last_start = w;
      if (cur && !next) {
        if (last_start < 0)
          open_end = w;
        else if (qualifies(wadd(w - last_start, 1)))
          ++n_q;
      }
      if (p.diff8) {
        const int d = wsub(vcur, vprev);  // cov[-1] = 0
        d8[w] = static_cast<signed char>(static_cast<unsigned char>(d));
        bad8 |= d < -128 || d > 127;
      }
      vprev = vcur;
      prev = cur;
      vcur = vnext;
      cur = next;
    }
  }
  int unused;
  const int carry = block_scan(last_start, -1, Max(), sh, &unused);
  if (open_end >= 0 && qualifies(wadd(wsub(open_end, carry), 1))) ++n_q;
  int rep_n;
  int rank = block_scan(n_q, 0, WrapSum(), sh, &rep_n);

  // 2. the qualifying runs into their slots
  int len_sum = 0;
  {
    int rs = carry;
    bool prev = high(lo - 1, value(lo - 1));
    bool cur = high(lo, value(lo));
    for (int w = lo; w < hi; ++w) {
      const bool next = high(w + 1, value(w + 1));
      if (cur && !prev) rs = w;
      if (cur && !next) {
        const int span = wmul(wadd(wsub(w, rs), 1), p.reso);
        if (span >= p.repeat_length) {
          if (rank < p.K) {
            out[rank] = max(wsub(wmul(rs, p.reso), p.flank), 0);
            out[p.K + rank] = min(wadd(wmul(w + 1, p.reso), p.flank), len);
          }
          len_sum = wadd(len_sum, span);
          ++rank;
        }
      }
      prev = cur;
      cur = next;
    }
  }
  int rep_len_sum;
  block_scan(len_sum, 0, WrapSum(), sh, &rep_len_sum);
  const int n_slots = min(rep_n, p.K);
  for (int k = n_slots + tid; k < p.K; k += T) {  // empty slots: s=1 > e=0
    out[k] = 1;
    out[p.K + k] = 0;
  }
  bool unsorted = false;
  __syncthreads();  // the slots are written; every thread reads them below
  for (int k = tid; k + 1 < n_slots; k += T)
    unsorted |= out[k] > out[k + 1] || out[p.K + k] > out[p.K + k + 1];
  const bool sorted = !__syncthreads_or(unsorted);

  // does a repeat slot stab marker value v?
  auto inside = [&](int v) {
    if (sorted) {
      int a = 0, z = n_slots;  // a = the number of slots with s <= v
      while (a < z) {
        const int m = (a + z) >> 1;
        if (out[m] <= v)
          a = m + 1;
        else
          z = m;
      }
      return a > 0 && out[p.K + a - 1] >= v;
    }
    for (int k = 0; k < n_slots; ++k)
      if (out[k] <= v && v <= out[p.K + k]) return true;
    return false;
  };

  // 3. markers: candidate j is j*il up to the last whole part, then len
  const int parts = floordiv(len, p.il);
  const int n_stars = wadd(wadd(parts, 1), floormod(len, p.il) != 0 ? 1 : 0);
  int S = 0;
  for (int j0 = 0; j0 < p.M; j0 += T) {
    const int j = j0 + tid;
    bool keep = false;
    int val = 0;
    if (j < p.M) {
      val = j <= parts ? wmul(j, p.il) : len;
      keep = j < n_stars &&
             (j == 0 || j == wsub(n_stars, 1) || !inside(val));
    }
    int kept;
    const int r = block_scan(keep ? 1 : 0, 0, WrapSum(), sh, &kept);
    if (keep) srow[S + r] = val;
    S += kept;
  }
  for (int j = S + tid; j < p.M; j += T) srow[j] = 0;
  const bool any_bad8 = __syncthreads_or(bad8);  // and srow is written

  // 4. fragments
  const int d1 = wadd(p.div, 1);
  const bool whole = S <= d1;
  const int extra = wsub(S, d1);
  const int n_frag =
      whole ? 1
            : wadd(wadd(1, floordiv(extra, p.div)),
                   floormod(extra, p.div) != 0 ? 1 : 0);
  auto clip = [&](int i) { return min(max(i, 0), p.M - 1); };
  const int last_star = srow[clip(wsub(S, 1))];
  const int cs = 2 * p.K;
  const int cl = cs + p.F;
  for (int f = tid; f < p.F; f += T) {
    const int pos = wmul(f, p.div);
    const int star_f = srow[clip(pos)];
    const int last_f =
        f == wsub(n_frag, 1) ? last_star : srow[clip(wadd(pos, p.div))];
    const int ov_f = f == 0 ? 0 : p.ov;
    out[cs + f] = whole ? 0 : wsub(star_f, ov_f);
    out[cl + f] = whole ? len : wadd(wsub(last_f, star_f), ov_f);
  }
  if (tid == 0) {
    int* const sc = out + 2 * p.K + 2 * p.F;
    sc[0] = rep_n;
    sc[1] = rep_len_sum;
    sc[2] = n_frag;
    sc[3] = whole ? 1 : 0;
    sc[4] = any_bad8 ? 0 : 1;  // always 1 outside diff8 mode
  }
}

}  // namespace

// C entry point, bound with ctypes. Pointers are device pointers (diff8 may
// be null outside diff8 mode); stream is a cudaStream_t. block (a multiple
// of 32, at most 1024) and chunk come from ops/scan_chop_cuda.launch_plan,
// with block * chunk >= W. Returns cudaGetLastError() after the launch
// (0 = success).
extern "C" int raft_scan_chop(const void* cov, const void* lens, void* packed,
                              void* diff8, void* stars, int B, int W, int M,
                              int K, int F, int reso, int high_cov,
                              int repeat_length, int flank, int il, int div,
                              int ov, int diff8_mode, int block, int chunk,
                              void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const Params p{W,    M,  K,  F,     reso,      high_cov,  repeat_length,
                 flank, il, div, ov, chunk, diff8_mode};
  scan_chop<<<B, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cov), static_cast<const int*>(lens),
      static_cast<int*>(packed), static_cast<signed char*>(diff8),
      static_cast<int*>(stars), p);
  return static_cast<int>(cudaGetLastError());
}
