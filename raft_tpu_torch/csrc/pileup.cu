// Coverage pileup for Hopper (sm_90a): cov[b, w] = #{events e of row b :
// w0(e) <= w <= w1(e)}, int32, for one length bucket of reads.
//
// Replaces the TPU kernel raft_tpu/ops/pileup_pallas.py (_kernel, driven by
// pileup_pallas), which forms a one-hot-row x interval-mask matmul on the
// MXU and accumulates in f32. It also absorbs two device stages of
// raft_tpu/engine_jax.py: rows_from_offsets (each row's slab bounds come
// from ev_off) and unpack_events (the pack32 / pairs decode).
//
// What bounds it on an H100: the bytes. The pileup is ~2 integer
// operations per event plus one add per window, far below one operation
// per byte, so the least time is the cov write (4*B*W bytes) plus the
// event read (4 or 8 bytes per event) over 3.35 TB/s. At the main bench
// bucket (B=4096, W=512, ~60 events per row) the cov write (8 MiB) is ~90%
// of it. Tensor cores do not help: the TPU kernel used the MXU only
// because the TPU's scatter serialises.
//
// Design: +1 at w0 and -1 after w1 into a shared-memory diff row (integer
// atomics, so exact; the Pallas kernel's f32 sums are exact only below
// 2^24 per cell), an in-place prefix scan, and a store of the scanned row.
// The Python wrapper (ops/pileup_cuda.launch_plan) picks one of two
// regimes from (B, W) and passes the plan in:
//
// 1. Narrow rows (double-buffered rows of 8 warps fit in shared memory,
//    W <= 2048 in powers of two): a warp owns a row at a time; blocks of
//    8 warps loop over rows, with the grid capped at the blocks an SM
//    holds. Lanes stride over the row's events with shared-memory atomics
//    and the warp scans its row alone, so no block barrier is ever taken
//    (__syncwarp only). The scanned row leaves as one 1-D TMA bulk store
//    (cp.async.bulk, W*4 bytes), and each warp double-buffers its row so
//    the store of row i runs while row i+1 is built.
// 2. Wide rows, and a single block's worth (B <= 8) of rows of W >= 2048,
//    which one warp per row scans too slowly: a block of 1024 threads per
//    (row, stripe of windows). Stripes are wide (24K windows at most,
//    measured best at W=2^20), so a row's event slab is re-read 43 times
//    at W=2^20, not 128 as with the 8192-window stripes of the first
//    design, but narrow enough that the blocks fill the card. Each warp
//    scans its contiguous share of the stripe, and one block-level scan
//    of the 32 warp totals joins them: two barriers per stripe. The
//    stripe leaves as one TMA bulk store.
//
// PERF.md has the measured share of the bound per shape; a small
// bucket's time is mostly the ~2 us any launch costs.
//
// Scans read shared memory as int4: lane l of a warp takes int4 l of each
// 128-window tile (conflict-free, 16 bytes a lane), scans its 4 windows in
// registers and the 32 lane totals with __shfl_up_sync, four tiles a step
// with their shuffle chains interleaved; each thread keeps four event
// loads in flight before its atomics. Both shorten the chain of latencies
// a warp walks per row, which sets the time of small buckets. Rows with
// W % 4 != 0 are not 16-byte aligned in cov and take coalesced int stores
// inside the same kernels instead of TMA. Any B >= 1 and W >= 1 launch.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int R1_WARPS = 8;             // regime 1: rows in flight per block
constexpr int R1_THREADS = 32 * R1_WARPS;
constexpr int R2_THREADS = 1024;        // regime 2: threads per (row, stripe)
constexpr int R2_WARPS = R2_THREADS / 32;
constexpr int MAX_DEVICES = 64;
// Regime 1: events, and 128-window tiles, a thread keeps in flight per
// step. Regime 2 keeps one: at 1024 threads a block, the registers of four
// would halve the blocks an SM holds (measured slower).
constexpr int R1_UNROLL = 4;

__device__ __forceinline__ void fence_proxy_async() {
  // this thread's shared-memory writes become visible to the TMA unit
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bulk_store(int* gdst, const int* ssrc,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(ssrc));
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;" ::"l"(gdst), "r"(s), "r"(bytes)
      : "memory");
}

// All but the newest N bulk groups of this thread have read their source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// Every bulk group of this thread has read its shared-memory source, which
// may then go; the writes to global memory finish by the end of the grid.
__device__ __forceinline__ void bulk_wait_read_all() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// pairs != 0: ev is int32 [E, 2] (w0, span); else uint32 [E] words holding
// w0 in the low k bits (1 <= k <= 15) and span above them. span 0 marks an
// invalid or padding event; w0 outside [0, W) is invalid; w1 clamps to W-1.
__device__ __forceinline__ bool decode(const void* __restrict__ ev, int e,
                                       int pairs, int k, int W, int& w0,
                                       int& w1) {
  long long a, span;
  if (pairs) {
    const int2 p = reinterpret_cast<const int2*>(ev)[e];
    a = p.x;
    span = p.y;
  } else {
    const unsigned v = reinterpret_cast<const unsigned*>(ev)[e];
    a = v & ((1u << k) - 1u);
    span = v >> k;
  }
  if (span < 1 || a < 0 || a >= W) return false;
  w0 = static_cast<int>(a);
  w1 = static_cast<int>(min(a + span - 1, static_cast<long long>(W) - 1));
  return true;
}

// +1 at max(w0, lo) and -1 after min(w1, lo + n - 1) into diff (indexed
// from lo; slot n is the sink) for each event of [e0, e1) that reaches
// windows [lo, lo + n). NT threads stride over the events, thread t
// keeping UNROLL loads in flight before its atomics.
template <int NT, int UNROLL>
__device__ __forceinline__ void scatter_events(const void* __restrict__ ev,
                                               int e0, int e1, int t,
                                               int pairs, int k, int W,
                                               int lo, int n, int* diff) {
  for (int e = e0 + t; e < e1; e += UNROLL * NT) {
    int w0[UNROLL], w1[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      ok[u] = e + u * NT < e1 &&
              decode(ev, e + u * NT, pairs, k, W, w0[u], w1[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      const int a = max(w0[u], lo);
      const int z = min(w1[u], lo + n - 1);
      if (a > z) continue;  // the event does not reach these windows
      atomicAdd(&diff[a - lo], 1);
      atomicAdd(&diff[z + 1 - lo], -1);
    }
  }
}

// The int4 at vector index v of a segment of n windows, with the windows
// at or past n read as 0.
__device__ __forceinline__ int4 load4(const int4* seg, int v, int n) {
  const int i = 4 * v;
  int4 x = make_int4(0, 0, 0, 0);
  if (i < n) {
    x = seg[v];
    if (i + 1 >= n) x.y = 0;
    if (i + 2 >= n) x.z = 0;
    if (i + 3 >= n) x.w = 0;
  }
  return x;
}

// Sum of seg[0, n), by one whole warp.
__device__ __forceinline__ int warp_total(const int4* seg, int n, int lane) {
  int s = 0;
  for (int v = lane; 4 * v < n; v += 32) {
    const int4 x = load4(seg, v, n);
    s += x.x + x.y + x.z + x.w;
  }
  return __reduce_add_sync(FULL, s);
}

// In-place inclusive prefix sum of seg[0, n), plus carry, by one whole
// warp, UNROLL 128-window tiles a step whose shuffle scans interleave. The
// int4 that holds window n-1 is written whole: its slots past n are
// scratch in both regimes.
template <int UNROLL>
__device__ __forceinline__ void warp_scan(int4* seg, int n, int lane,
                                          int carry) {
  for (int base = 0; 4 * base < n; base += 32 * UNROLL) {
    int4 x[UNROLL];
    int incl[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      x[u] = load4(seg, base + 32 * u + lane, n);
      x[u].y += x[u].x;
      x[u].z += x[u].y;
      x[u].w += x[u].z;
      incl[u] = x[u].w;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int t = __shfl_up_sync(FULL, incl[u], o);
        if (lane >= o) incl[u] += t;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = base + 32 * u + lane;
      const int add = carry + incl[u] - x[u].w;
      if (4 * v < n)
        seg[v] = make_int4(x[u].x + add, x[u].y + add, x[u].z + add,
                           x[u].w + add);
      carry += __shfl_sync(FULL, incl[u], 31);
    }
  }
}

// Regime 1. Shared memory: R1_WARPS x 2 row buffers of `stride` ints
// (stride = W+1 rounded up to a multiple of 4: the W windows, the sink
// slot W for events that end on the last window, 16-byte alignment).
__global__ void __launch_bounds__(R1_THREADS)
pileup_rows(const int* __restrict__ ev_off, const void* __restrict__ ev,
            int* __restrict__ cov, int B, int W, int E, int k, int pairs,
            int tma) {
  extern __shared__ int4 smem4[];
  const int stride = (W + 4) / 4 * 4;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* const bufs = reinterpret_cast<int*>(smem4) + warp * 2 * stride;
  const int step = gridDim.x * R1_WARPS;
  int slot = 0;
  for (int b = blockIdx.x * R1_WARPS + warp; b < B; b += step, slot ^= 1) {
    int* const buf = bufs + slot * stride;
    int4* const buf4 = reinterpret_cast<int4*>(buf);
    const int e0 = max(ev_off[b], 0);  // loads in flight while zeroing
    const int e1 = min(ev_off[b + 1], E);
    // the store issued from this buffer two rows ago has read it
    if (tma && lane == 0) bulk_wait_read<1>();
    __syncwarp();
    for (int v = lane; v < stride / 4; v += 32)
      buf4[v] = make_int4(0, 0, 0, 0);
    __syncwarp();
    scatter_events<32, R1_UNROLL>(ev, e0, e1, lane, pairs, k, W, 0, W, buf);
    __syncwarp();
    warp_scan<R1_UNROLL>(buf4, W, lane, 0);
    int* const out = cov + static_cast<long long>(b) * W;
    if (tma) {
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) bulk_store(out, buf, W * 4);
    } else {
      __syncwarp();
      for (int i = lane; i < W; i += 32) out[i] = buf[i];
    }
  }
  if (tma && lane == 0) bulk_wait_read_all();
}

// Regime 2. Block (b, y) builds windows [y*stripe, y*stripe + n) of row b;
// stripe is a multiple of 32*4, so each warp's share starts 16-byte
// aligned. Shared memory: stripe + 4 ints (the sink slot n, alignment).
__global__ void __launch_bounds__(R2_THREADS)
pileup_stripes(const int* __restrict__ ev_off, const void* __restrict__ ev,
               int* __restrict__ cov, int B, int W, int E, int k, int pairs,
               int stripe, int tma) {
  extern __shared__ int4 smem4[];
  __shared__ int warp_base[R2_WARPS];
  int* const diff = reinterpret_cast<int*>(smem4);
  const int b = blockIdx.x;
  const int s0 = blockIdx.y * stripe;
  const int n = min(W - s0, stripe);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int e0 = max(ev_off[b], 0);  // loads in flight while zeroing
  const int e1 = min(ev_off[b + 1], E);

  for (int v = tid; 4 * v <= n; v += R2_THREADS)
    smem4[v] = make_int4(0, 0, 0, 0);
  __syncthreads();

  scatter_events<R2_THREADS, 1>(ev, e0, e1, tid, pairs, k, W, s0, n, diff);
  __syncthreads();

  const int share = stripe / R2_WARPS;
  const int lo = warp * share;
  const int len = max(0, min(n - lo, share));
  int4* const mine = smem4 + lo / 4;
  const int tot = warp_total(mine, len, lane);
  if (lane == 0) warp_base[warp] = tot;
  __syncthreads();
  if (warp == 0) {
    const int t = warp_base[lane];
    int incl = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += u;
    }
    warp_base[lane] = incl - t;
  }
  __syncthreads();
  warp_scan<1>(mine, len, lane, warp_base[warp]);

  int* const out = cov + static_cast<long long>(b) * W + s0;
  if (tma) {
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      bulk_store(out, diff, n * 4);
      bulk_wait_read_all();  // the shared source must outlive the copy
    }
  } else {
    __syncthreads();
    for (int i = tid; i < n; i += R2_THREADS) out[i] = diff[i];
  }
}

// Opt `kernel` into all the dynamic shared memory a block of it may have:
// the device's opt-in limit less the kernel's static shared memory.
template <typename K>
cudaError_t allow_all_smem(K kernel, int optin) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      optin - static_cast<int>(attr.sharedSizeBytes));
}

// Above 48 KB of dynamic shared memory a kernel must opt in, once per
// device: the attribute belongs to the device the launch runs on.
int allow_smem(int smem) {
  static bool done[MAX_DEVICES];
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < MAX_DEVICES && done[dev]) return 0;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err == cudaSuccess) err = allow_all_smem(pileup_rows, optin);
  if (err == cudaSuccess) err = allow_all_smem(pileup_stripes, optin);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return static_cast<int>(err);
}

}  // namespace

// C entry point, bound with ctypes. Pointers are device pointers; stream is
// a cudaStream_t. The launch plan (regime 1 or 2, grid, block, stripe of
// regime 2, dynamic shared memory bytes, TMA store or not) comes from
// ops/pileup_cuda.launch_plan. Returns cudaGetLastError() after the launch
// (0 = success), or the error of the shared-memory opt-in.
extern "C" int raft_pileup(const void* ev_off, const void* ev, void* cov,
                           int B, int W, int E, int k, int pairs, int regime,
                           int grid_x, int grid_y, int block, int stripe,
                           int smem, int tma, void* stream) {
  if (B <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  const int err = allow_smem(smem);
  if (err) return err;
  const dim3 grid(grid_x, grid_y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (regime == 1) {
    pileup_rows<<<grid, block, smem, s>>>(
        static_cast<const int*>(ev_off), ev, static_cast<int*>(cov), B, W, E,
        k, pairs, tma);
  } else {
    pileup_stripes<<<grid, block, smem, s>>>(
        static_cast<const int*>(ev_off), ev, static_cast<int*>(cov), B, W, E,
        k, pairs, stripe, tma);
  }
  return static_cast<int>(cudaGetLastError());
}
