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
// so a launch takes (npoint-1) x (one pass over the row + one block-wide
// argmax); the roofline of bytes (xyz once, indices once) and operations
// (~10 a point a step) lies orders of magnitude below that.
//
// Design: one block per batch row; the row's state stays with the block for
// the whole launch. Rows of up to FPS_SMEM_POINTS points keep x, y, z and the
// running minimum in shared memory (structure of arrays, conflict-free);
// longer rows (a 40,000-point scene is 640 KB of state against 227 KB of
// shared memory) read the coordinates from global memory, where they stay in
// L2, and keep the running minimum in a scratch buffer the wrapper hands
// over. Thread t owns points t, t+T, t+2T, ... and is the only one to touch
// their running minimum, so a step needs no barrier for the state. An
// unselectable point's running minimum is set to -1 at the start and stays
// there (min(-1, d) = -1), so the candidate value IS the running minimum and
// the mask is read once.
//
// Argmax with the lowest index on ties: every level compares
// (v > best) || (v == best && i < best_i). A thread scans its points in
// ascending order; lanes combine by xor-shuffles; lane 0 of each warp writes
// the warp's pair to shared memory; after ONE barrier every warp reduces the
// warps' pairs again (redundantly, to the same result), so no second barrier
// broadcasts the winner. The pair buffers alternate between steps: a warp may
// write step j+1's pair while another still reads step j's.
//
// Exact indices: the plain PyTorch version rounds every product and sum, so
// the distance is written with __fmul_rn / __fadd_rn / __fsub_rn, which the
// compiler never contracts into fused multiply-adds. One ulp on a near-tie
// would change an index and every later one with it.
//
// The TPU kernel's lane padding of N to a multiple of 128, its 3 -> 8 sublane
// padding, its one-hot fetch of the chosen point and its [B, 8, m_pad] output
// have no counterpart here.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define FPS_SMEM_POINTS 8192

namespace {

struct Best {
  float v;
  int i;
};

__device__ __forceinline__ bool better(float v, int i, const Best& b) {
  return v > b.v || (v == b.v && i < b.i);
}

__device__ __forceinline__ Best warp_argmax(Best b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float v = __shfl_xor_sync(0xffffffffu, b.v, off);
    int i = __shfl_xor_sync(0xffffffffu, b.i, off);
    if (better(v, i, b)) { b.v = v; b.i = i; }
  }
  return b;
}

__device__ __forceinline__ float sqdist(float x, float y, float z, float xo,
                                        float yo, float zo) {
  float dx = __fsub_rn(x, xo), dy = __fsub_rn(y, yo), dz = __fsub_rn(z, zo);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// SMEM: x, y, z and the running minimum live in dynamic shared memory
// (4 * N floats); otherwise coordinates come from `xyz` and the running
// minimum lives in `temp` (global scratch, [B, N]).
template <bool SMEM>
__global__ void fps_kernel(const float* __restrict__ xyz,
                           const uint8_t* __restrict__ valid,
                           float* __restrict__ temp, int* __restrict__ out,
                           int N, int npoint) {
  extern __shared__ float smem[];
  __shared__ float pair_v[2][32];
  __shared__ int pair_i[2][32];
  const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = T >> 5;
  const float* p = xyz + (long long)b * N * 3;
  const uint8_t* ok = valid ? valid + (long long)b * N : nullptr;
  float* sx = smem;
  float* sy = smem + N;
  float* sz = smem + 2 * N;
  float* run = SMEM ? smem + 3 * N : temp + (long long)b * N;
  int* o = out + (long long)b * npoint;

  for (int i = tid; i < N; i += T) {
    float x = p[3 * i], y = p[3 * i + 1], z = p[3 * i + 2];
    float mag = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                          __fmul_rn(z, z));
    bool sel = mag > 1e-3f && (!ok || ok[i]);
    run[i] = sel ? 1e10f : -1.0f;
    if (SMEM) { sx[i] = x; sy[i] = y; sz[i] = z; }
  }
  if (tid == 0) o[0] = 0;
  if (SMEM) __syncthreads();      // the chosen point is read from any thread's part

  int old = 0;
  for (int j = 1; j < npoint; ++j) {
    float xo, yo, zo;
    if (SMEM) { xo = sx[old]; yo = sy[old]; zo = sz[old]; }
    else { xo = p[3 * old]; yo = p[3 * old + 1]; zo = p[3 * old + 2]; }
    Best best = {-2.0f, INT_MAX};
    for (int i = tid; i < N; i += T) {          // ascending: first maximum kept
      float d = SMEM ? sqdist(sx[i], sy[i], sz[i], xo, yo, zo)
                     : sqdist(p[3 * i], p[3 * i + 1], p[3 * i + 2], xo, yo, zo);
      float t = fminf(run[i], d);
      run[i] = t;
      if (better(t, i, best)) { best.v = t; best.i = i; }
    }
    best = warp_argmax(best);
    const int buf = j & 1;
    if (lane == 0) { pair_v[buf][warp] = best.v; pair_i[buf][warp] = best.i; }
    __syncthreads();
    Best w = {-2.0f, INT_MAX};
    if (lane < n_warps) { w.v = pair_v[buf][lane]; w.i = pair_i[buf][lane]; }
    w = warp_argmax(w);
    old = w.i;
    if (tid == 0) o[j] = old;
  }
}

}  // namespace

// xyz float32 [B, N, 3] contiguous; valid uint8 [B, N] or null; temp float32
// [B, N] scratch (read only when N > FPS_SMEM_POINTS, may be null otherwise);
// out int32 [B, npoint]. One block per batch row, about four points a thread.
// Returns cudaGetLastError() after the launch.
extern "C" int s3d_fps(const void* xyz, const void* valid, void* temp,
                       void* out, int B, int N, int npoint, void* stream) {
  if (B <= 0 || npoint <= 0) return 0;
  if (N <= 0) return (int)cudaErrorInvalidValue;
  int threads = ((N + 3) / 4 + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  if (N <= FPS_SMEM_POINTS) {
    size_t bytes = (size_t)4 * N * sizeof(float);
    if (bytes > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          fps_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)bytes);
      if (e != cudaSuccess) return (int)e;
    }
    fps_kernel<true><<<B, threads, bytes, (cudaStream_t)stream>>>(
        (const float*)xyz, (const uint8_t*)valid, nullptr, (int*)out, N,
        npoint);
  } else {
    if (!temp) return (int)cudaErrorInvalidValue;
    fps_kernel<false><<<B, threads, 0, (cudaStream_t)stream>>>(
        (const float*)xyz, (const uint8_t*)valid, (float*)temp, (int*)out, N,
        npoint);
  }
  return (int)cudaGetLastError();
}
