// Coverage pileup for Hopper (sm_90a): cov[b, w] = #{events e of row b :
// w0(e) <= w <= w1(e)}, int32, for one length bucket of reads.
//
// Replaces the TPU kernel raft_tpu/ops/pileup_pallas.py (_kernel, driven by
// pileup_pallas), which forms a one-hot-row x interval-mask matmul on the
// MXU and accumulates in f32. It also absorbs two device stages of
// raft_tpu/engine_jax.py: rows_from_offsets (each block reads its own row's
// slab bounds from ev_off) and unpack_events (the pack32 / pairs decode).
//
// What bounds it on an H100: the pileup is ~2 integer operations per
// event, so it is memory-bound. Per bucket it reads 4 (pack32) or 8 (pairs)
// bytes per event plus the B+1 offsets, and writes 4*B*W bytes of cov; at
// the main bench bucket (B=4096, W=512, ~60 events per row) the cov write
// (8 MiB) dominates the event read (~1 MiB). Inside a block the cost is
// shared-memory atomics, one or two per event, contended only where many
// intervals of one read start on the same window.
//
// Design: one block per (row b, W-stripe of at most STRIPE_MAX windows).
// The block walks its row's slab [ev_off[b], ev_off[b+1]), decodes each
// event, clamps it to the stripe [s0, s1) and adds +1 at max(w0, s0) and -1
// after min(w1, s1-1) in a shared-memory diff array (integer, so exact; the
// Pallas kernel's f32 sums are exact only below 2^24 per cell). A block
// prefix scan over the stripe then writes cov with coalesced stores. The
// stripe keeps shared memory at (STRIPE_MAX + 1) * 4 bytes whatever W is
// (up to 2^20 windows on the ultralong tiers), and no grid tile constraint
// is inherited from the TPU kernel: any B >= 1 and W >= 1 launch.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STRIPE_MAX = 8192;

// pairs != 0: ev is int32 [E, 2] (w0, span); else uint32 [E] words holding
// w0 in the low k bits (1 <= k <= 15) and span above them. span 0 marks an
// invalid or padding event; w0 outside [0, W) is invalid; w1 clamps to W-1.
__global__ void __launch_bounds__(THREADS)
pileup_kernel(const int* __restrict__ ev_off, const void* __restrict__ ev,
              int* __restrict__ cov, int B, int W, int E, int k, int pairs,
              int stripe) {
  extern __shared__ int diff[];  // stripe slots + 1 sink slot
  __shared__ int warp_sums[WARPS];

  const int b = blockIdx.x;
  const int s0 = blockIdx.y * stripe;
  const int n = min(W - s0, stripe);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i <= n; i += THREADS) diff[i] = 0;
  __syncthreads();

  const int e0 = max(ev_off[b], 0);
  const int e1 = min(ev_off[b + 1], E);
  const unsigned mask = (1u << k) - 1u;
  for (int e = e0 + tid; e < e1; e += THREADS) {
    long long w0, span;
    if (pairs) {
      const int2 p = reinterpret_cast<const int2*>(ev)[e];
      w0 = p.x;
      span = p.y;
    } else {
      const unsigned v = reinterpret_cast<const unsigned*>(ev)[e];
      w0 = v & mask;
      span = v >> k;
    }
    if (span < 1 || w0 < 0 || w0 >= W) continue;
    const long long w1 = min(w0 + span - 1, (long long)W - 1);
    const long long a = max(w0, (long long)s0);
    const long long z = min(w1, (long long)(s0 + n - 1));
    if (a > z) continue;  // the event does not reach this stripe
    atomicAdd(&diff[a - s0], 1);
    atomicAdd(&diff[z + 1 - s0], -1);  // slot n is the sink
  }
  __syncthreads();

  // inclusive scan of diff[0, n) in tiles of THREADS, carrying the sum
  int* out = cov + (long long)b * W + s0;
  int carry = 0;
  for (int base = 0; base < n; base += THREADS) {
    const int i = base + tid;
    int v = i < n ? diff[i] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += t;
    }
    if (lane == 31) warp_sums[warp] = v;
    __syncthreads();
    if (warp == 0) {
      int w = lane < WARPS ? warp_sums[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += t;
      }
      if (lane < WARPS) warp_sums[lane] = w;
    }
    __syncthreads();
    v += carry + (warp > 0 ? warp_sums[warp - 1] : 0);
    if (i < n) out[i] = v;
    carry += warp_sums[WARPS - 1];
    __syncthreads();  // warp_sums is rewritten by the next tile
  }
}

}  // namespace

// C entry point, bound with ctypes. Pointers are device pointers; stream is
// a cudaStream_t. Returns cudaGetLastError() after the launch (0 = success).
extern "C" int raft_pileup(const void* ev_off, const void* ev, void* cov,
                           int B, int W, int E, int k, int pairs,
                           void* stream) {
  if (B <= 0 || W <= 0) return (int)cudaGetLastError();
  const int stripe = W < STRIPE_MAX ? W : STRIPE_MAX;
  const dim3 grid(B, (W + stripe - 1) / stripe);
  const size_t smem = (size_t)(stripe + 1) * sizeof(int);
  pileup_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)ev_off, ev, (int*)cov, B, W, E, k, pairs, stripe);
  return (int)cudaGetLastError();
}
