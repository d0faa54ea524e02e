// Farthest point sampling.
//
// Replaces the TPU kernel situation3d_tpu/ops/pallas/fps.py (_fps_kernel /
// fps_pallas) and carries what the reference's XLA furthest_point_sample
// (ops/pointnet2.py) computes, its optional `valid` mask included:
//
//   out[b, 0] = 0
//   temp[i]   = 1e10;  selectable[i] = |p_i|^2 > 1e-3  (and valid[b, i])
//   for j = 1 .. npoint-1:
//     d[i]    = (x_i-xo)^2 + (y_i-yo)^2 + (z_i-zo)^2     (o = out[b, j-1])
//     temp[i] = min(temp[i], d[i])
//     out[b, j] = argmax_i (selectable[i] ? temp[i] : -1), lowest i on ties
//
// Bound on this card: neither bytes nor operations but latency. The npoint-1
// steps depend on each other (a step needs the point the step before chose),
// so a launch takes (npoint-1) x (one pass over a row's share of points + an
// argmax across everything that holds the row); the roofline of bytes (xyz
// once, indices once) and operations (~10 a point a step) lies orders of
// magnitude below that. Two things set the time of a step: how many points
// one SM walks, and what the argmax costs to agree on.
//
// Design: a row's state (x, y, z and the running minimum of each point)
// lives in REGISTERS for the whole launch, PPT points a thread, never in
// shared or global memory (rows of up to 65,536 points). The layout (blocks
// a row, threads a block, PPT) is chosen by ops/cuda/fps.py:fps_layout and
// passed in:
//   - WARP mode (N <= 512): one warp a row; no barrier at all.
//   - BLOCK mode (N <= 8,192): one block a row, one barrier a step.
//   - CLUSTER mode (longer rows; 40,000 points on the detector's first
//     level): a thread-block cluster of blocks_per_row blocks a row (8, the
//     portable cluster size: 8 rows x 8 = 64 SMs busy, not 8), each block
//     owning a contiguous share of ~5,000 points; a block barrier and one
//     CLUSTER barrier a step.
// Block c of a row, thread t, slot k owns point c*T*PPT + k*T + t (loads at
// the start are coalesced); a thread scans its slots in ascending order.
// Rows longer than the registers hold (8 x 1,024 x 8 = 65,536 points) take
// the SPILL instance of the cluster mode: point REG + m*8*T + c*T + t (REG =
// 65,536, m = 0, 1, ...) belongs to block c, thread t, which scans these
// after its register slots (still ascending), reading the point from xyz in
// L2 and its running minimum from a global scratch [B, N - REG] each step:
// slower, as every point was before the state went to registers, but any N.
//
// A step: each thread updates its points and keeps its best (v, i) with the
// point's coordinates, which travel with it, so the next step needs no
// dependent load of xyz[old]. A warp agrees on its winner with two redux.sync
// reductions (largest v, then lowest i among those lanes) instead of ten
// shuffles; lane 0 writes it into the warp's slot. After one __syncthreads
// the block's winner is the reduction of the warps' slots: every warp does it
// in BLOCK mode (no second barrier to broadcast it); in CLUSTER mode warp 0
// does it and its lanes 0 .. blocks_per_row-1 write it into entry [rank] of
// every block of the cluster (distributed shared memory, st.shared::cluster),
// then one cluster barrier (barrier.cluster arrive.release / wait.acquire,
// cluster.sync()), after which every warp of every block reduces the same
// blocks_per_row entries to the same winner. What costs the time of a step is
// the number of warps that take part in it (their reductions and barrier
// arrivals), more than the points: hence 8 points a thread and few warps.
// Slots and entries alternate between two buffers by step parity: a warp may
// write step j+1's slot while another still reads step j's, and nothing can
// be written for step j+2 before every warp has passed step j+1's barrier,
// i.e. finished reading step j.
//
// Ties: every level takes the largest v and, among equal v, the lowest i
// (within a thread, whose points come in ascending i, a strict > does that).
// That is a total order on (v, i) pairs, so the result does not depend on how
// the points are split among threads, warps and blocks, and every warp's
// redundant final reduction agrees.
//
// Exact indices: the plain PyTorch version rounds every product and sum, so
// the distance is written with __fmul_rn / __fadd_rn / __fsub_rn, which the
// compiler never contracts into fused multiply-adds. One ulp on a near-tie
// would change an index and every later one with it.
//
// The mask: an unselectable point's running minimum is set to -1 at the start
// and stays there (min(-1, d) = -1), so the candidate value IS the running
// minimum and `valid` and |p|^2 are read once. A slot past the end of the row
// holds -3, below every real point's value, so it never wins. When nothing is
// selectable, index 0 (the lowest with value -1) repeats.
//
// The TPU kernel's lane padding of N to a multiple of 128, its 3 -> 8 sublane
// padding, its one-hot fetch of the chosen point and its [B, 8, m_pad] output
// have no counterpart here.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define FPS_MAX_CLUSTER 8
#define FPS_MAX_WARPS 32

namespace {

enum { MODE_WARP = 0, MODE_BLOCK = 1, MODE_CLUSTER = 2 };

struct Best {
  float v;
  int i;
};

__device__ __forceinline__ float sqdist(float x, float y, float z, float xo,
                                        float yo, float zo) {
  float dx = __fsub_rn(x, xo), dy = __fsub_rn(y, yo), dz = __fsub_rn(z, zo);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// A float as an unsigned key of the same order (no NaN here; -0 is made +0
// first, so equal floats give equal keys).
__device__ __forceinline__ unsigned ordered(float v) {
  const unsigned u = __float_as_uint(__fadd_rn(v, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The winner of a warp by the tie rule: the largest v, then the lowest i
// among lanes holding it, by two warp-wide reductions (redux.sync); all
// lanes get (v, i) and the coordinates that travel with it, taken from the
// lane whose candidate it is.
__device__ __forceinline__ Best warp_winner(Best mine, float mx, float my,
                                            float mz, float& wx, float& wy,
                                            float& wz) {
  const unsigned key = ordered(mine.v);
  const unsigned top = __reduce_max_sync(0xffffffffu, key);
  const int wi = (int)__reduce_min_sync(
      0xffffffffu, key == top ? (unsigned)mine.i : 0xffffffffu);
  const unsigned m = __ballot_sync(0xffffffffu, key == top && mine.i == wi);
  const int src = m ? __ffs(m) - 1 : 0;
  wx = __shfl_sync(0xffffffffu, mx, src);
  wy = __shfl_sync(0xffffffffu, my, src);
  wz = __shfl_sync(0xffffffffu, mz, src);
  Best w;
  w.v = __shfl_sync(0xffffffffu, mine.v, src);
  w.i = wi;
  return w;
}

// Stores into another block's shared memory (distributed shared memory).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ uint32_t remote(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_remote(uint32_t f, uint32_t i, float4 v,
                                          int idx) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "r"(f), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
  asm volatile("st.shared::cluster.s32 [%0], %1;" :: "r"(i), "r"(idx)
               : "memory");
}
template <int PPT, int MODE, bool SPILL>
__global__ void __launch_bounds__(MODE == MODE_WARP ? 32 : 1024)
fps_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ valid,
           int* __restrict__ out, float* __restrict__ spill, int N, int npoint,
           int bpr) {
  // slot_*[q][w]: warp w's winner of a step with parity q, (v, x, y, z) and i;
  // xch_*[q][c]: the winner of block c of the cluster, written by block c
  __shared__ float4 slot_f[2][FPS_MAX_WARPS];
  __shared__ int slot_i[2][FPS_MAX_WARPS];
  __shared__ float4 xch_f[2][FPS_MAX_CLUSTER];
  __shared__ int xch_i[2][FPS_MAX_CLUSTER];
  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = T >> 5;
  const int rank = MODE == MODE_CLUSTER ? (int)(blockIdx.x % bpr) : 0;
  const int b = MODE == MODE_CLUSTER ? (int)(blockIdx.x / bpr) : blockIdx.x;
  const float* p = xyz + (long long)b * N * 3;
  const uint8_t* ok = valid ? valid + (long long)b * N : nullptr;
  const int base = rank * T * PPT + tid;
  // SPILL: the points past the registers' share, their minimum in scratch
  const int reg = bpr * T * PPT;
  const int s0 = reg + rank * T + tid, s_step = bpr * T;
  float* sp = SPILL ? spill + (long long)b * (N - reg) : nullptr;

  float px[PPT], py[PPT], pz[PPT], run[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = base + k * T;
    px[k] = py[k] = pz[k] = 0.f;
    run[k] = -3.0f;                       // past the end: never chosen
    if (i < N) {
      float x = p[3 * i], y = p[3 * i + 1], z = p[3 * i + 2];
      float mag = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                            __fmul_rn(z, z));
      bool sel = mag > 1e-3f && (!ok || ok[i]);
      px[k] = x; py[k] = y; pz[k] = z;
      run[k] = sel ? 1e10f : -1.0f;
    }
  }
  if (SPILL)
    for (int i = s0; i < N; i += s_step) {
      float x = p[3 * i], y = p[3 * i + 1], z = p[3 * i + 2];
      float mag = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                            __fmul_rn(z, z));
      sp[i - reg] = mag > 1e-3f && (!ok || ok[i]) ? 1e10f : -1.0f;
    }
  int* o = out + (long long)b * npoint;
  const bool writer = rank == 0 && tid == 0;
  if (writer) o[0] = 0;
  if (npoint <= 1) return;
  if (MODE == MODE_CLUSTER) cg::this_cluster().sync();   // every block runs
  float xo = p[0], yo = p[1], zo = p[2];      // point 0 opens the sample

  for (int j = 1; j < npoint; ++j) {
    Best best = {-2.0f, INT_MAX};
    float bx = 0.f, by = 0.f, bz = 0.f;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const float t = fminf(run[k], sqdist(px[k], py[k], pz[k], xo, yo, zo));
      run[k] = t;
      // ascending index within a thread: a tie keeps the earlier point
      const bool take = t > best.v;
      best.v = take ? t : best.v;
      best.i = take ? base + k * T : best.i;
      bx = take ? px[k] : bx;
      by = take ? py[k] : by;
      bz = take ? pz[k] : bz;
    }
    if (SPILL)                           // after the registers: still ascending
      for (int i = s0; i < N; i += s_step) {
        const float x = p[3 * i], y = p[3 * i + 1], z = p[3 * i + 2];
        const float t = fminf(sp[i - reg], sqdist(x, y, z, xo, yo, zo));
        sp[i - reg] = t;
        const bool take = t > best.v;
        best.v = take ? t : best.v;
        best.i = take ? i : best.i;
        bx = take ? x : bx;
        by = take ? y : by;
        bz = take ? z : bz;
      }
    float wx, wy, wz;
    Best w = warp_winner(best, bx, by, bz, wx, wy, wz);
    if (MODE != MODE_WARP) {
      const int buf = j & 1;
      if (lane == 0) {
        slot_f[buf][warp] = make_float4(w.v, wx, wy, wz);
        slot_i[buf][warp] = w.i;
      }
      __syncthreads();
      if (MODE == MODE_BLOCK || warp == 0) {   // the block's winner
        Best c = {-2.0f, INT_MAX};
        float cx = 0.f, cy = 0.f, cz = 0.f;
        if (lane < n_warps) {
          const float4 f = slot_f[buf][lane];
          c.v = f.x; c.i = slot_i[buf][lane]; cx = f.y; cy = f.z; cz = f.w;
        }
        w = warp_winner(c, cx, cy, cz, wx, wy, wz);
      }
      if (MODE == MODE_CLUSTER) {
        if (warp == 0 && lane < bpr)           // to every block of the row
          st_remote(remote(&xch_f[buf][rank], lane),
                    remote(&xch_i[buf][rank], lane),
                    make_float4(w.v, wx, wy, wz), w.i);
        cg::this_cluster().sync();
        Best c = {-2.0f, INT_MAX};
        float cx = 0.f, cy = 0.f, cz = 0.f;
        if (lane < bpr) {
          const float4 f = xch_f[buf][lane];
          c.v = f.x; c.i = xch_i[buf][lane]; cx = f.y; cy = f.z; cz = f.w;
        }
        w = warp_winner(c, cx, cy, cz, wx, wy, wz);
      }
    }
    xo = wx; yo = wy; zo = wz;
    if (writer) o[j] = w.i;
  }
}

template <int PPT, int MODE, bool SPILL = false>
int launch_fps(const void* xyz, const void* valid, void* out, void* spill,
               int B, int N, int npoint, int bpr, int threads,
               cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3((unsigned)(B * bpr));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  if (MODE == MODE_CLUSTER) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = bpr;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  cudaError_t e = cudaLaunchKernelEx(&cfg, fps_kernel<PPT, MODE, SPILL>,
                                     (const float*)xyz, (const uint8_t*)valid,
                                     (int*)out, (float*)spill, N, npoint, bpr);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// xyz float32 [B, N, 3] contiguous; valid uint8 [B, N] or null; out int32
// [B, npoint]; spill float32 [B, N - blocks_per_row * threads * ppt] scratch
// when the layout holds fewer than N points in registers, else null. The
// layouts ops/cuda/fps.py:fps_layout gives, and no other: one warp a row
// (threads 32, ppt 1, 2, 4, 8 or 16), one block a row (ppt 8), or a cluster
// of FPS_MAX_CLUSTER blocks a row (ppt 8; the spill only at 1,024 threads).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a layout the kernel does not take.
extern "C" int s3d_fps(const void* xyz, const void* valid, void* out,
                       void* spill, int B, int N, int npoint,
                       int blocks_per_row, int threads, int ppt, void* stream) {
  if (B <= 0 || npoint <= 0) return 0;
  if (N <= 0 || threads < 32 || threads > 1024 || threads % 32)
    return (int)cudaErrorInvalidValue;
  const long long reg = (long long)blocks_per_row * threads * ppt;
  cudaStream_t s = (cudaStream_t)stream;
  if (blocks_per_row == FPS_MAX_CLUSTER && ppt == 8) {
    if (reg >= N && !spill)
      return launch_fps<8, MODE_CLUSTER>(xyz, valid, out, nullptr, B, N, npoint,
                                         blocks_per_row, threads, s);
    if (reg < N && spill && threads == 1024)
      return launch_fps<8, MODE_CLUSTER, true>(xyz, valid, out, spill, B, N,
                                               npoint, blocks_per_row, threads, s);
    return (int)cudaErrorInvalidValue;
  }
  if (blocks_per_row != 1 || reg < N || spill) return (int)cudaErrorInvalidValue;
  if (threads > 32)
    return ppt == 8 ? launch_fps<8, MODE_BLOCK>(xyz, valid, out, nullptr, B, N,
                                                npoint, 1, threads, s)
                    : (int)cudaErrorInvalidValue;
  switch (ppt) {                        // one warp a row
#define S3D_FPS_CASE(K)                                                        \
  case K:                                                                      \
    return launch_fps<K, MODE_WARP>(xyz, valid, out, nullptr, B, N, npoint, 1, \
                                    32, s);
    S3D_FPS_CASE(1) S3D_FPS_CASE(2) S3D_FPS_CASE(4) S3D_FPS_CASE(8)
    S3D_FPS_CASE(16)
#undef S3D_FPS_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
