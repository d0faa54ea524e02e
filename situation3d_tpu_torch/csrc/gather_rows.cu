// Row gather and its deterministic scatter-add.
//
// Replaces the TPU kernel situation3d_tpu/ops/pallas/gather.py
// (_gather_kernel / vmem_gather_rows) and its backward _gather_bwd (a plain
// XLA scatter-add there, a kernel here):
//
//   gather:       out[b, r, :]      = table[b, idx[b, r], :]
//   scatter-add:  out[b, v, :]      = sum over r with idx[b, r] == v of
//                                     src[b, r, :]      (f32, in order of r)
//
// Bound on this card: bytes, both. Neither does arithmetic to speak of.
//
// Gather design: a row is cut into 16-byte vectors (4-byte ones when the row
// is not a multiple of 16 bytes); one thread moves one vector, neighbouring
// threads move neighbouring vectors of one row and then the next row, so
// loads within a row and all stores are contiguous. The threads of a row read
// the same index word (one broadcast load). The TPU kernel's VMEM-resident
// table, 32-bit-only sublane indexing, SMEM index blocks and R % block_rows
// rule have no counterpart. An index outside [0, V) writes a zero row; it
// never reads out of bounds.
//
// Scatter-add design: no float atomics. The wrapper sorts each sample's
// indices (stable) and hands over the permutation and, per destination row,
// the start of its segment in the sorted order. One warp owns one
// destination row: it walks the segment in sorted order (ascending r among
// equal indices) and adds in f32 registers, lanes across channels (4
// consecutive channels a lane when C % 4 == 0), then writes the row once.
// Two runs add the same numbers in the same order, so they are bit-equal.
// Empty segments write zeros, so the output needs no memset.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename VecT>
__global__ void gather_rows_kernel(const VecT* __restrict__ table,
                                   const int* __restrict__ idx,
                                   VecT* __restrict__ out, long long n_vec,
                                   int R, int V, int vecs) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_vec) return;
  long long row = t / vecs;                 // b*R + r
  int part = (int)(t - row * vecs);
  long long b = row / R;
  int i = idx[row];
  VecT v = VecT();
  if (i >= 0 && i < V) v = table[(b * V + i) * (long long)vecs + part];
  out[t] = v;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void add4(const float* p, float* acc) {
  float4 v = *reinterpret_cast<const float4*>(p);
  acc[0] += v.x; acc[1] += v.y; acc[2] += v.z; acc[3] += v.w;
}
__device__ __forceinline__ void add4(const __nv_bfloat16* p, float* acc) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo = *reinterpret_cast<__nv_bfloat162*>(&raw.x);
  __nv_bfloat162 hi = *reinterpret_cast<__nv_bfloat162*>(&raw.y);
  acc[0] += __bfloat162float(lo.x); acc[1] += __bfloat162float(lo.y);
  acc[2] += __bfloat162float(hi.x); acc[3] += __bfloat162float(hi.y);
}

template <typename T, bool VEC4>
__global__ void scatter_add_rows_kernel(const T* __restrict__ src,
                                        const long long* __restrict__ perm,
                                        const int* __restrict__ offsets,
                                        float* __restrict__ out,
                                        long long n_dst, int R, int V, int C) {
  const int warps = blockDim.x >> 5;
  long long w = (long long)blockIdx.x * warps + (threadIdx.x >> 5);
  if (w >= n_dst) return;
  const int lane = threadIdx.x & 31;
  long long b = w / V;
  int v = (int)(w - b * V);
  const int* off = offsets + b * (long long)(V + 1);
  const int r0 = off[v], r1 = off[v + 1];
  const long long* p = perm + b * (long long)R;
  const T* s = src + b * (long long)R * C;
  float* o = out + w * (long long)C;
  if (VEC4) {
    for (int c = lane * 4; c < C; c += 128) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int r = r0; r < r1; ++r) add4(s + p[r] * (long long)C + c, acc);
      *reinterpret_cast<float4*>(o + c) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      float acc = 0.f;
      for (int r = r0; r < r1; ++r) acc += to_f32(s[p[r] * (long long)C + c]);
      o[c] = acc;
    }
  }
}

template <typename T>
int launch_scatter(const void* src, const void* perm, const void* offsets,
                   void* out, long long n_dst, int R, int V, int C,
                   cudaStream_t stream) {
  const int threads = 256, warps = threads / 32;
  long long blocks = (n_dst + warps - 1) / warps;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  if (C % 4 == 0) {
    scatter_add_rows_kernel<T, true><<<(unsigned)blocks, threads, 0, stream>>>(
        (const T*)src, (const long long*)perm, (const int*)offsets,
        (float*)out, n_dst, R, V, C);
  } else {
    scatter_add_rows_kernel<T, false><<<(unsigned)blocks, threads, 0, stream>>>(
        (const T*)src, (const long long*)perm, (const int*)offsets,
        (float*)out, n_dst, R, V, C);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// table [B, V, row_bytes] bytes; idx int32 [B, R]; out [B, R, row_bytes].
// row_bytes is a multiple of 4; rows that are a multiple of 16 bytes need
// 16-byte aligned table and out pointers (the wrapper sees to it).
// Returns cudaGetLastError() after the launch.
extern "C" int s3d_gather_rows(const void* table, const void* idx, void* out,
                               int B, int V, int R, int row_bytes,
                               void* stream) {
  if ((long long)B * R == 0 || row_bytes == 0) return 0;
  if (row_bytes % 4) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const bool wide = row_bytes % 16 == 0;
  const int vecs = wide ? row_bytes / 16 : row_bytes / 4;
  long long n_vec = (long long)B * R * vecs;
  long long blocks = (n_vec + threads - 1) / threads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  if (wide) {
    gather_rows_kernel<uint4><<<(unsigned)blocks, threads, 0,
                                (cudaStream_t)stream>>>(
        (const uint4*)table, (const int*)idx, (uint4*)out, n_vec, R, V, vecs);
  } else {
    gather_rows_kernel<uint32_t><<<(unsigned)blocks, threads, 0,
                                   (cudaStream_t)stream>>>(
        (const uint32_t*)table, (const int*)idx, (uint32_t*)out, n_vec, R, V,
        vecs);
  }
  return (int)cudaGetLastError();
}

// src [B, R, C] float32 or bfloat16; perm int64 [B, R] (stable argsort of the
// sample's indices); offsets int32 [B, V+1] (offsets[b, v] = first position
// in the sorted order whose index is >= v); out float32 [B, V, C].
// With C % 4 == 0 src rows and out must be 8-byte (bf16) / 16-byte (f32)
// aligned. Returns cudaGetLastError() after the launch.
extern "C" int s3d_scatter_add_rows(const void* src, const void* perm,
                                    const void* offsets, void* out, int B,
                                    int R, int V, int C, int src_is_bf16,
                                    void* stream) {
  long long n_dst = (long long)B * V;
  if (n_dst == 0 || C == 0) return 0;
  if (src_is_bf16)
    return launch_scatter<__nv_bfloat16>(src, perm, offsets, out, n_dst, R, V,
                                         C, (cudaStream_t)stream);
  return launch_scatter<float>(src, perm, offsets, out, n_dst, R, V, C,
                               (cudaStream_t)stream);
}
