// Segment plan of the deterministic scatter-add, built on the card.
//
// Part of the port of the TPU kernel situation3d_tpu/ops/pallas/gather.py's
// backward _gather_bwd (a plain XLA scatter-add there): scatter_add_rows sums
// each destination row's sources in ascending source order, and this kernel
// computes that order. With key[r] = idx[r] if 0 <= idx[r] < V, else V:
//
//   perm[b, :]    = the stable argsort of key[b, :]     (int32 [B, R])
//   offsets[b, v] = the first sorted position whose key is >= v
//                                                         (int32 [B, V+1])
//
// so destination v's sources are perm[b, offsets[b, v] : offsets[b, v+1]] in
// ascending r, and the dropped entries (key V) form the tail of perm, also in
// ascending r. The plain version is sort_segments in ops/cuda/gather_rows.py.
//
// Bound on this card: bytes (read idx once, write perm and offsets once) in
// principle; in practice the latency of the passes each entry takes
// (count, place, order), and how many SMs share them.
//
// Design: a thread-block cluster of PLAN_CLUSTER (8) blocks a sample, one
// launch, no library sort. Block c owns the counters of destinations
// [c*vpb, (c+1)*vpb) in its shared memory (vpb = ceil(V / 8): 5,000 for the
// detector's 40,000 points), and 1/8 of the entries, cut into one contiguous
// range a warp.
//   1. count: each warp walks its range in 32-wide coalesced chunks; the
//      kept entries of a chunk that share a destination (__match_any_sync)
//      add their number to its counter in the owning block with ONE atomic
//      (distributed shared memory, integer atomics: exact whatever the
//      order; the detector's ball-query indices repeat a centre's first
//      neighbour up to 63 times, and remote atomics on one address
//      serialize); dropped ones add to the warp's own count (ballot + popc).
//   2. scan: each block scans its counters; the blocks' kept and dropped
//      totals go to every block of the cluster, so each block knows where
//      its destinations start; offsets are written out (coalesced) and the
//      counters become cursors.
//   3. place: the kept entries take slots of their segment through the
//      owner's cursor, one atomicAdd per destination and chunk (the order
//      within a segment is arbitrary across chunks), and are written to a
//      scratch copy; each dropped entry goes straight to
//      its final place in the tail (warp ranges in order, ballot prefix
//      inside a chunk): stable without any sort.
//   4. order: each segment is put in ascending r by rank: an entry's place
//      is the segment start plus the number of the segment's entries smaller
//      than it (the r are distinct, so the ranks are a permutation).
//      Segments of up to 16 entries: by their owner, one thread each, from a
//      shared-memory copy of the owner's entries (contiguous in the scratch
//      copy). Longer ones: each block lists its own, and the cluster's 256
//      warps share the lists out, a warp a segment, each lane holding as
//      many entries as the segment needs (1, 2, 4 or 8 a lane, up to 256 a
//      pass) while the segment streams past as broadcast loads. Sharing
//      matters: the ball query pads a centre's list with its lowest-index
//      neighbour, so the long segments are the lowest point indices, all in
//      block 0 and, there, in one warp's range. O(L^2) for a segment of L
//      entries: slow for a segment of thousands, never wrong.
// Cluster barriers separate the phases; a last one keeps every block alive
// while others read its list. When a block's counters and list do not fit in
// shared memory (V above ~204,800) both live in a global scratch the wrapper
// hands over (s3d_segment_plan_scratch_ints ints; the same code, slower
// atomics), so any V and R plan.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

#define PLAN_THREADS 1024
#define PLAN_WARPS (PLAN_THREADS / 32)
#define PLAN_CLUSTER 8
#define PLAN_SHORT 16
#define PLAN_GROUP 8
#define PLAN_SMEM_MAX_BYTES (200 * 1024)

namespace {

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// rank of x among seg[0, L): number of entries smaller than x
__device__ __forceinline__ int rank_in(const int* seg, int L, int x) {
  int rank = 0;
  int j = 0;
  for (; j + 4 <= L; j += 4) {
    int a = seg[j], b = seg[j + 1], c = seg[j + 2], d = seg[j + 3];
    rank += (a < x) + (b < x) + (c < x) + (d < x);
  }
  for (; j < L; ++j) rank += seg[j] < x;
  return rank;
}

// One warp puts seg[0, L) in ascending order into out[0, L), by rank: each
// lane holds NG of the entries (32 * NG a pass) while the whole segment
// streams past as broadcast loads.
template <int NG>
__device__ void warp_order_n(const int* seg, int* out, int L, int lane) {
  for (int g0 = 0; g0 < L; g0 += 32 * NG) {
    int x[NG], rk[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int i = g0 + g * 32 + lane;
      x[g] = i < L ? seg[i] : INT_MAX;
      rk[g] = 0;
    }
#pragma unroll 4
    for (int j = 0; j < L; ++j) {
      const int y = seg[j];
#pragma unroll
      for (int g = 0; g < NG; ++g) rk[g] += y < x[g];
    }
#pragma unroll
    for (int g = 0; g < NG; ++g)
      if (g0 + g * 32 + lane < L) out[rk[g]] = x[g];
  }
}

// ... with only as many entries a lane as the segment needs
__device__ void warp_order(const int* seg, int* out, int L, int lane) {
  if (L <= 32) warp_order_n<1>(seg, out, L, lane);
  else if (L <= 64) warp_order_n<2>(seg, out, L, lane);
  else if (L <= 128) warp_order_n<4>(seg, out, L, lane);
  else warp_order_n<PLAN_GROUP>(seg, out, L, lane);
}

template <bool SMEM>
__global__ void __launch_bounds__(PLAN_THREADS, 1)
segment_plan_kernel(const int* __restrict__ idx, int* __restrict__ perm,
                    int* __restrict__ offsets, int* __restrict__ scratch,
                    int* __restrict__ gcount, int R, int V, int vpb, int list_cap,
                    int stage_cap) {
  extern __shared__ int smem_cnt[];
  __shared__ int warp_sum[PLAN_WARPS];
  __shared__ int drop_w[PLAN_WARPS];
  __shared__ int blk_kept[PLAN_CLUSTER];
  __shared__ int blk_drop[PLAN_CLUSTER];
  __shared__ int blk_long[PLAN_CLUSTER];
  __shared__ int n_long;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int b = blockIdx.x / PLAN_CLUSTER, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int* ix = idx + (long long)b * R;
  int* pm = perm + (long long)b * R;
  int* tp = scratch + (long long)b * R;
  int* off = offsets + (long long)b * (V + 1);
  // global scratch (when !SMEM): every sample's V+1 counters, then every
  // block's list of long segments, list_cap entries each
  int* gsample = SMEM ? nullptr : gcount + (long long)b * (V + 1);
  int* glists = SMEM ? nullptr
                     : gcount + (long long)(gridDim.x / PLAN_CLUSTER) * (V + 1)
                           + (long long)b * PLAN_CLUSTER * list_cap;
  const int vpb_pad = (vpb + 3) / 4 * 4;
  int* cnt = SMEM ? smem_cnt : gsample + c * vpb;
  auto counters_of = [&](int owner) -> int* {
    return SMEM ? cluster.map_shared_rank(smem_cnt, owner) : gsample + owner * vpb;
  };
  auto list_of = [&](int owner) -> int* {
    return SMEM ? cluster.map_shared_rank(smem_cnt + vpb_pad, owner)
                : glists + owner * list_cap;
  };
  const int v0 = min(V, c * vpb), nv = min(V, v0 + vpb) - v0;

  for (int k = tid; k < nv; k += PLAN_THREADS) cnt[k] = 0;
  cluster.sync();

  // 1. count; global warp gw owns r in [w0, w1), walked in 32-wide chunks
  const int n_gw = PLAN_CLUSTER * PLAN_WARPS;
  const int per_warp = ((R + n_gw - 1) / n_gw + 31) / 32 * 32;
  const int w0 = min(R, (c * PLAN_WARPS + warp) * per_warp);
  const int w1 = min(R, w0 + per_warp);
  int dropped = 0;
  for (int r0 = w0; r0 < w1; r0 += 32) {
    const int r = r0 + lane;
    bool drop = false;
    int v = -1;
    if (r < w1) {
      v = ix[r];
      drop = v < 0 || v >= V;
    }
    const bool keep = r < w1 && !drop;
    const unsigned kept = __ballot_sync(0xffffffffu, keep);
    if (keep) {            // one atomic per distinct destination in the chunk
      const unsigned peers = __match_any_sync(kept, v);
      if (lane == __ffs(peers) - 1) {
        const int owner = v / vpb;
        atomicAdd(counters_of(owner) + (v - owner * vpb), __popc(peers));
      }
    }
    dropped += __popc(__ballot_sync(0xffffffffu, drop));
  }
  if (lane == 0) drop_w[warp] = dropped;
  cluster.sync();

  // 2. scan: thread t scans a contiguous chunk of this block's counters,
  //    the chunks' sums are scanned across the block, the blocks' totals
  //    across the cluster
  const int chunk = (nv + PLAN_THREADS - 1) / PLAN_THREADS;
  const int c0 = min(nv, tid * chunk), c1 = min(nv, c0 + chunk);
  int local = 0;
  for (int k = c0; k < c1; ++k) local += cnt[k];
  int incl = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int sk = warp_sum[lane], sd = drop_w[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int yk = __shfl_up_sync(0xffffffffu, sk, d);
      int yd = __shfl_up_sync(0xffffffffu, sd, d);
      if (lane >= d) { sk += yk; sd += yd; }
    }
    warp_sum[lane] = sk - warp_sum[lane];          // exclusive
    drop_w[lane] = sd - drop_w[lane];              // exclusive
    const int kept_blk = __shfl_sync(0xffffffffu, sk, 31);
    const int drop_blk = __shfl_sync(0xffffffffu, sd, 31);
    if (lane < PLAN_CLUSTER) {                     // to every block
      *cluster.map_shared_rank(&blk_kept[c], lane) = kept_blk;
      *cluster.map_shared_rank(&blk_drop[c], lane) = drop_blk;
    }
  }
  cluster.sync();
  int kept_base = 0, kept_all = 0, drop_base = 0;
#pragma unroll
  for (int q = 0; q < PLAN_CLUSTER; ++q) {
    kept_all += blk_kept[q];
    if (q < c) { kept_base += blk_kept[q]; drop_base += blk_drop[q]; }
  }
  int run = kept_base + warp_sum[warp] + incl - local;
  for (int k = c0; k < c1; ++k) {
    const int n = cnt[k];
    cnt[k] = run;                                  // cursor
    run += n;
  }
  __syncthreads();
  for (int k = tid; k < nv; k += PLAN_THREADS) off[v0 + k] = cnt[k];
  if (c == 0 && tid == 0) off[V] = kept_all;
  cluster.sync();

  // 3. place
  int tail = kept_all + drop_base + drop_w[warp];
  for (int r0 = w0; r0 < w1; r0 += 32) {
    const int r = r0 + lane;
    bool drop = false;
    int v = 0;
    if (r < w1) {
      v = ix[r];
      drop = v < 0 || v >= V;
    }
    const unsigned m = __ballot_sync(0xffffffffu, drop);
    const bool keep = r < w1 && !drop;
    const unsigned kept = __ballot_sync(0xffffffffu, keep);
    if (drop) pm[tail + __popc(m & lanemask_lt())] = r;
    if (keep) {            // the chunk's entries of one destination: one atomic
      const unsigned peers = __match_any_sync(kept, v);
      const int leader = __ffs(peers) - 1;
      int at = 0;
      if (lane == leader) {
        const int owner = v / vpb;
        at = atomicAdd(counters_of(owner) + (v - owner * vpb), __popc(peers));
      }
      at = __shfl_sync(peers, at, leader);
      tp[at + __popc(peers & lanemask_lt())] = r;
    }
    tail += __popc(m);
  }
  cluster.sync();        // every entry placed; cnt[k] is now the END of segment v0+k

  // 4. order the segments. Short ones (up to PLAN_SHORT entries): by their
  //    owner, one thread each, from a shared-memory copy of the owner's
  //    entries tp[kept_base, +n_mine) (staged when it fits: every shape of the
  //    two paths). Long ones: listed, then shared out among all the warps
  //    of the cluster; the ball query's padding makes the long segments the
  //    lowest point indices, which one block (and, in it, one warp) owns.
  const int n_mine = blk_kept[c];
  int* long_list = SMEM ? smem_cnt + vpb_pad : glists + c * list_cap;
  int* stage = smem_cnt + (SMEM ? vpb_pad + list_cap : 0);
  const bool staged = n_mine <= stage_cap;
  if (tid == 0) n_long = 0;
  if (staged)
    for (int i = tid; i < n_mine; i += PLAN_THREADS) stage[i] = tp[kept_base + i];
  __syncthreads();
  const int* seg_base = staged ? stage : tp + kept_base;   // position kept_base + i
  for (int k = tid; k < nv; k += PLAN_THREADS) {
    const int s = k ? cnt[k - 1] : kept_base;
    const int L = cnt[k] - s;
    const int* seg = seg_base + (s - kept_base);
    if (L == 1) {
      pm[s] = seg[0];
    } else if (L > PLAN_SHORT) {
      long_list[atomicAdd(&n_long, 1)] = v0 + k;
    } else {
      for (int i = 0; i < L; ++i) {
        const int x = seg[i];
        pm[s + rank_in(seg, L, x)] = x;
      }
    }
  }
  __syncthreads();
  if (warp == 0 && lane < PLAN_CLUSTER)
    *cluster.map_shared_rank(&blk_long[c], lane) = n_long;
  cluster.sync();
  // item q of the cluster's list (the blocks' lists one after the other)
  // goes to global warp q % (8 * 32)
  for (int q = c * PLAN_WARPS + warp, base = 0, owner = 0;; q += n_gw) {
    while (owner < PLAN_CLUSTER && q >= base + blk_long[owner]) base += blk_long[owner++];
    if (owner == PLAN_CLUSTER) break;
    const int v = list_of(owner)[q - base];
    const int s = off[v];
    warp_order(tp + s, pm + s, off[v + 1] - s, lane);
  }
  cluster.sync();        // no block leaves while another reads its list
}

}  // namespace

// Counters a block holds: ceil(V / PLAN_CLUSTER), at least 1.
static int plan_vpb(int V) { return V > 0 ? (V + PLAN_CLUSTER - 1) / PLAN_CLUSTER : 1; }

// Entries of a block's list of long segments: a block has at most
// min(vpb, R / (PLAN_SHORT + 1)) of them.
static int plan_list_cap(int R, int V) {
  return (std::min(plan_vpb(V), R / (PLAN_SHORT + 1) + 1) + 3) / 4 * 4;
}

// int32 entries of the global scratch s3d_segment_plan needs for B samples:
// 0 when a block's counters and its list fit in shared memory (list_cap <=
// vpb, so both fit together when twice the counters do), else every sample's
// V+1 counters and every block's list.
extern "C" long long s3d_segment_plan_scratch_ints(int B, int R, int V) {
  const size_t vpb_pad = (size_t)(plan_vpb(V) + 3) / 4 * 4;
  if (2 * vpb_pad * sizeof(int) <= PLAN_SMEM_MAX_BYTES) return 0;
  return (long long)B * (V + 1) + (long long)B * PLAN_CLUSTER * plan_list_cap(R, V);
}

// idx int32 [B, R]; perm int32 [B, R] out; offsets int32 [B, V+1] out;
// scratch int32 [B, R]; counters: s3d_segment_plan_scratch_ints(B, R, V)
// int32 of scratch, or null when that is 0. A cluster of 8 blocks of 1024
// threads per sample. Returns cudaGetLastError() after the launch.
extern "C" int s3d_segment_plan(const void* idx, void* perm, void* offsets,
                                void* scratch, void* counters, int B, int R,
                                int V, void* stream) {
  if (B <= 0) return 0;
  if (R < 0 || V < 0) return (int)cudaErrorInvalidValue;
  const int vpb = plan_vpb(V);
  const bool smem = s3d_segment_plan_scratch_ints(B, R, V) == 0;
  if (smem != (counters == nullptr)) return (int)cudaErrorInvalidValue;
  // shared memory: the counters and the list of long segments (when they
  // fit), then the staging area of phase 4, as large as the remaining room
  const int list_cap = plan_list_cap(R, V);
  const size_t counter_bytes =
      smem ? ((size_t)(vpb + 3) / 4 * 4 + list_cap) * sizeof(int) : 0;
  const size_t room = PLAN_SMEM_MAX_BYTES - counter_bytes;
  const int stage_cap = (int)std::min<size_t>((size_t)R, room / sizeof(int));
  const size_t bytes = counter_bytes + (size_t)stage_cap * sizeof(int);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = PLAN_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)(B * PLAN_CLUSTER));
  cfg.blockDim = dim3(PLAN_THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e;
  if (smem) {
    e = cudaFuncSetAttribute(segment_plan_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaLaunchKernelEx(&cfg, segment_plan_kernel<true>, (const int*)idx,
                           (int*)perm, (int*)offsets, (int*)scratch,
                           (int*)counters, R, V, vpb, list_cap, stage_cap);
  } else {
    e = cudaFuncSetAttribute(segment_plan_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaLaunchKernelEx(&cfg, segment_plan_kernel<false>, (const int*)idx,
                           (int*)perm, (int*)offsets, (int*)scratch,
                           (int*)counters, R, V, vpb, list_cap, stage_cap);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
