// The device inputs of every bucket of a pass, gathered on the card from
// one copy of the read-grouped event table, in one launch (sm_90a).
//
// Replaces no TPU kernel: raft_tpu gathers each bucket's event slabs and
// packs them on the host (bucketing.iter_buckets, engine_jax.pack_events)
// and copies each bucket over the link. Here the host uploads the table
// once (ev_off int64 [n+1], w0 and w1 int32 [m], lens int32 [n]) with a
// small plan (ops/gather_cuda.GatherPlan), and this kernel writes every
// step's (lens [B], ev_off [B+1], ev_pk) into one int32 arena, element
// for element what engine_torch.host_inputs builds: events of row r at
// ev_off[r] .. ev_off[r+1] in table order, each packed as pack32
// (w0 | span << k) or an int32 (w0, span) pair, valid iff w1 >= w0 and
// 0 <= w0 < W, w1 clamped to W-1, else span 0 and w0 0; window indices
// wrapped to int16 first where the bucket's event columns are int16
// (bucketing.event_dtype); padded rows at length 0 and offset = the
// step's event total, padded event slots 0.
//
// What bounds it: the bytes. Per event 8 read and 4 (pack32) or 8 written,
// no arithmetic to speak of, so the least time is the pass's events times
// 12 bytes over 3.35 TB/s (~10 us for 2.8M HiFi events).
//
// Design: a block of ROWS threads per ROWS rows of a step (the plan lists
// the blocks). Each thread takes one row's event count from the table; a
// block-level exclusive scan of the counts, on top of the sum of the
// step's earlier rows (read by the block itself, so blocks need nothing
// from each other), gives each row's offset. Then a warp per row copies
// and packs its slab: lanes walk consecutive events, so the table's reads
// and the arena's writes are coalesced. The block holding a step's last
// row writes ev_off[B] and zeroes the padded event slots.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int ROWS = 256;  // threads a block, rows of a step a block
constexpr int WARPS = ROWS / 32;
// A step's int64 fields in the plan (ops/gather_cuda.FIELDS).
enum { RID0, N_USED, B_, E_, W_, K_, PAIRS, TRUNC16, LENS_AT, OFF_AT, EV_AT,
       NF };

// Inclusive warp scan of v.
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// Exclusive block scan of v; *total gets the block's sum. Every thread of
// the block calls it.
__device__ __forceinline__ int block_scan(int v, int* total) {
  __shared__ int sums[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int inc = warp_scan(v, lane);
  if (lane == 31) sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int s = lane < WARPS ? sums[lane] : 0;
    const int t = warp_scan(s, lane);
    if (lane < WARPS) sums[lane] = t - s;  // exclusive warp bases
    if (lane == WARPS - 1) *total = t;
  }
  __syncthreads();
  const int out = sums[warp] + inc - v;
  __syncthreads();  // sums is reused by the next call
  return out;
}

__global__ void __launch_bounds__(ROWS)
gather_rows(const long long* __restrict__ off_g, const int* __restrict__ w0s,
            const int* __restrict__ w1s, const int* __restrict__ lens_g,
            const long long* __restrict__ meta, int* __restrict__ arena,
            int blocks_at, int rids_at) {
  __shared__ long long s_src[ROWS];
  __shared__ int s_dst[ROWS], s_cnt[ROWS];
  __shared__ int s_total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long* blk = meta + blocks_at + 2 * (long long)blockIdx.x;
  const long long* st = meta + NF * blk[0];
  const int row0 = static_cast<int>(blk[1]);
  const long long* rids = meta + rids_at + st[RID0];
  const int n_used = static_cast<int>(st[N_USED]);
  const int B = static_cast<int>(st[B_]), E = static_cast<int>(st[E_]);
  const int W = static_cast<int>(st[W_]), k = static_cast<int>(st[K_]);
  const bool pairs = st[PAIRS] != 0, t16 = st[TRUNC16] != 0;
  int* const lens = arena + st[LENS_AT];
  int* const ev_off = arena + st[OFF_AT];
  int* const ev = arena + st[EV_AT];

  // the events of the step's rows before this block's
  int before = 0;
  for (int r = tid; r < min(row0, n_used); r += ROWS) {
    const long long rid = rids[r];
    before += static_cast<int>(off_g[rid + 1] - off_g[rid]);
  }
  block_scan(before, &s_total);
  const int base = s_total;

  const int r = row0 + tid;
  long long src = 0;
  int cnt = 0, len = 0;
  if (r < n_used) {
    const long long rid = rids[r];
    src = off_g[rid];
    cnt = static_cast<int>(off_g[rid + 1] - src);
    len = lens_g[rid];
  }
  const int pre = base + block_scan(cnt, &s_total);
  const int total = base + s_total;
  if (r < B) {
    lens[r] = len;
    ev_off[r] = pre;
  }
  s_src[tid] = src;
  s_dst[tid] = pre;
  s_cnt[tid] = cnt;
  const bool last = row0 + ROWS >= B;
  if (last && tid == 0) ev_off[B] = total;
  __syncthreads();

  for (int i = warp; i < ROWS; i += WARPS) {
    const int c = s_cnt[i];
    const long long s = s_src[i];
    const int d = s_dst[i];
    for (int j = lane; j < c; j += 32) {
      int a = w0s[s + j], b = w1s[s + j];
      if (t16) {
        a = static_cast<short>(a);
        b = static_cast<short>(b);
      }
      const bool ok = b >= a && a >= 0 && a < W;
      const int span = ok ? min(b, W - 1) - a + 1 : 0;
      const int w0 = ok ? a : 0;
      if (pairs)
        reinterpret_cast<int2*>(ev)[d + j] = make_int2(w0, span);
      else
        reinterpret_cast<unsigned*>(ev)[d + j] =
            static_cast<unsigned>(w0) | (static_cast<unsigned>(span) << k);
    }
  }
  if (last) {
    if (pairs) {
      for (int j = total + tid; j < E; j += ROWS)
        reinterpret_cast<int2*>(ev)[j] = make_int2(0, 0);
    } else {
      for (int j = total + tid; j < E; j += ROWS) ev[j] = 0;
    }
  }
}

}  // namespace

// C entry point, bound with ctypes. Pointers are device pointers; stream is
// a cudaStream_t. meta holds the plan (ops/gather_cuda.GatherPlan): each
// step's NF fields, then each block's (step, first row) at blocks_at, then
// the steps' read ids at rids_at. Returns cudaGetLastError() after the
// launch (0 = success).
extern "C" int raft_gather(const void* off_g, const void* w0, const void* w1,
                           const void* lens, const void* meta, void* arena,
                           int n_blocks, int blocks_at, int rids_at,
                           void* stream) {
  if (n_blocks <= 0) return static_cast<int>(cudaGetLastError());
  gather_rows<<<n_blocks, ROWS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(off_g), static_cast<const int*>(w0),
      static_cast<const int*>(w1), static_cast<const int*>(lens),
      static_cast<const long long*>(meta), static_cast<int*>(arena),
      blocks_at, rids_at);
  return static_cast<int>(cudaGetLastError());
}
