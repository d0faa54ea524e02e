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
// Scatter-add design: no float atomics. The segment plan (csrc/segment_plan.cu,
// its own launch, shareable by several sums over one index array) gives each
// destination row its source rows in ascending r. One warp owns one
// destination row and adds in f32 registers, then writes the row once; two
// runs add the same numbers in the same order, so they are bit-equal, and
// empty segments write zeros, so the output needs no memset. What bounds a
// warp is the latency of its loads: a segment of 200 rows walked one
// dependent load (perm, then row) at a time costs 200 round trips to L2. So
// the warp loads 32 perm entries at once (one a lane) and then keeps
// SCATTER_UNROLL rows' loads in flight before it adds them, in order. Rows
// of at most 8 channels that are not a multiple of 4 (the 12-byte coordinate
// rows of the detector, the counts of the token pooling) get one thread a
// destination instead, so that 32 destinations share a warp rather than 29
// of its 32 lanes idling.
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

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo = *reinterpret_cast<__nv_bfloat162*>(&raw.x);
  __nv_bfloat162 hi = *reinterpret_cast<__nv_bfloat162*>(&raw.y);
  return make_float4(__bfloat162float(lo.x), __bfloat162float(lo.y),
                     __bfloat162float(hi.x), __bfloat162float(hi.y));
}

#define SCATTER_UNROLL 8     // rows in flight per lane in the channel modes
#define SCATTER_ROW_MAX_C 8  // widest row the lanes-across-rows mode takes

// One warp owns one destination row w = b*V + v and walks its segment
// perm[off[v] : off[v+1]] (source rows in ascending r) in batches of 32:
// the batch's perm entries are loaded at once, one a lane, then the rows.
// Lanes run across channels: 4 consecutive channels a lane when C % 4 == 0
// (VEC4), else one; SCATTER_UNROLL rows' loads are issued before their adds.
// Rows of at most SCATTER_ROW_MAX_C channels that are not a multiple of 4 go
// to scatter_add_narrow_kernel below. Every channel's sum starts at 0 and
// adds the rows in ascending r, the order of the plain version, so the
// result does not depend on the kernel that computes it.
template <typename T, bool VEC4>
__global__ void scatter_add_rows_kernel(const T* __restrict__ src,
                                        const int* __restrict__ perm,
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
  const int* p = perm + b * (long long)R;
  const T* s = src + b * (long long)R * C;
  float* o = out + w * (long long)C;
  const int step = VEC4 ? 128 : 32;
  const int width = VEC4 ? 4 : 1;
  for (int c = lane * width; c - lane * width < C; c += step) {
    const bool live = c < C;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int base = r0; base < r1; base += 32) {
      const int n = min(32, r1 - base);
      const int mine = lane < n ? p[base + lane] : 0;
      for (int j = 0; j < n; j += SCATTER_UNROLL) {
        float4 val[SCATTER_UNROLL];
#pragma unroll
        for (int u = 0; u < SCATTER_UNROLL; ++u) {
          const int r = __shfl_sync(0xffffffffu, mine, (j + u) & 31);
          val[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (live && j + u < n) {
            const T* q = s + (long long)r * C + c;
            if (VEC4) val[u] = load4(q);
            else val[u].x = to_f32(*q);
          }
        }
#pragma unroll
        for (int u = 0; u < SCATTER_UNROLL; ++u) {
          if (j + u < n) {
            acc[0] += val[u].x;
            if (VEC4) {
              acc[1] += val[u].y; acc[2] += val[u].z; acc[3] += val[u].w;
            }
          }
        }
      }
    }
    if (live) {
      if (VEC4) *reinterpret_cast<float4*>(o + c) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
      else o[c] = acc[0];
    }
  }
}

// Rows of at most SCATTER_ROW_MAX_C channels that are not a multiple of 4
// (the 12-byte coordinate rows of the detector, the 4-byte counts of the
// token pooling): one THREAD owns one destination row, so a warp covers 32
// destinations instead of leaving most lanes idle, and keeps SCATTER_UNROLL
// rows' loads in flight (their perm entries first, then the rows) before it
// adds them in ascending r.
template <typename T>
__global__ void scatter_add_narrow_kernel(const T* __restrict__ src,
                                          const int* __restrict__ perm,
                                          const int* __restrict__ offsets,
                                          float* __restrict__ out,
                                          long long n_dst, int R, int V,
                                          int C) {
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= n_dst) return;
  const long long b = w / V;
  const int v = (int)(w - b * V);
  const int* off = offsets + b * (long long)(V + 1);
  const int r0 = off[v], r1 = off[v + 1];
  const int* p = perm + b * (long long)R;
  const T* s = src + b * (long long)R * C;
  float acc[SCATTER_ROW_MAX_C];
#pragma unroll
  for (int c = 0; c < SCATTER_ROW_MAX_C; ++c) acc[c] = 0.f;
  for (int base = r0; base < r1; base += SCATTER_UNROLL) {
    int rows[SCATTER_UNROLL];
#pragma unroll
    for (int u = 0; u < SCATTER_UNROLL; ++u)
      rows[u] = base + u < r1 ? p[base + u] : -1;
    float val[SCATTER_UNROLL][SCATTER_ROW_MAX_C];
#pragma unroll
    for (int u = 0; u < SCATTER_UNROLL; ++u) {
#pragma unroll
      for (int c = 0; c < SCATTER_ROW_MAX_C; ++c)
        val[u][c] = (rows[u] >= 0 && c < C)
                        ? to_f32(s[(long long)rows[u] * C + c]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < SCATTER_UNROLL; ++u) {
      if (rows[u] >= 0) {
#pragma unroll
        for (int c = 0; c < SCATTER_ROW_MAX_C; ++c) acc[c] += val[u][c];
      }
    }
  }
  float* o = out + w * (long long)C;
#pragma unroll
  for (int c = 0; c < SCATTER_ROW_MAX_C; ++c)
    if (c < C) o[c] = acc[c];
}

template <typename T>
int launch_scatter(const void* src, const void* perm, const void* offsets,
                   void* out, long long n_dst, int R, int V, int C,
                   cudaStream_t stream) {
  const int threads = 256, warps = threads / 32;
  long long blocks = (n_dst + warps - 1) / warps;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  if (C % 4 != 0 && C <= SCATTER_ROW_MAX_C) {     // one thread a destination
    const long long nb = (n_dst + threads - 1) / threads;
    if (nb > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
    scatter_add_narrow_kernel<T><<<(unsigned)nb, threads, 0, stream>>>(
        (const T*)src, (const int*)perm, (const int*)offsets, (float*)out,
        n_dst, R, V, C);
  } else if (C % 4 == 0) {                        // one warp a destination
    scatter_add_rows_kernel<T, true><<<(unsigned)blocks, threads, 0, stream>>>(
        (const T*)src, (const int*)perm, (const int*)offsets, (float*)out,
        n_dst, R, V, C);
  } else {
    scatter_add_rows_kernel<T, false><<<(unsigned)blocks, threads, 0, stream>>>(
        (const T*)src, (const int*)perm, (const int*)offsets, (float*)out,
        n_dst, R, V, C);
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

// src [B, R, C] float32 or bfloat16; perm int32 [B, R] and offsets int32
// [B, V+1], the segment plan of csrc/segment_plan.cu (destination v's source
// rows are perm[b, offsets[b, v] : offsets[b, v+1]], ascending); out float32
// [B, V, C].
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
