// Fused sparse convolution: gather + miss mask + per-offset product, summed
// over the kernel offsets in f32.
//
// Replaces the TPU kernel situation3d_tpu/ops/pallas/fused_conv.py
// (_fused_kernel / fused_sparse_conv, forward).
//
//   out[b, v, :] = sum_k [0 <= idx[b,v,k] < V_in] * feats[b, idx[b,v,k], :] @ W[k]
//
// feats [B, V_in, C_in] and W [K, C_in, C_out] in float or bf16 (same type),
// idx int32 [B, V_out, K], out float [B, V_out, C_out]. Both miss conventions
// (V_in and -1) read as a zero row. The gathered [B, V_out, K, C_in] windows
// never exist in device memory.
//
// What bounds it on this card: conv0 (C_in = 3), the k2 down convs and the
// narrow k3 convs by the map and output bytes; the k3 convs at C_in >= 64 by
// the operations (chip_smoke.py works the bound out per shape).
//
// Design. The sum over offsets and channels is ONE contraction of length
// J = K*C_in over the flattened index j = k*C_in + c: row v of the left
// operand is A[v, j] = feats[idx[v, j / C_in], j % C_in], and W viewed as
// [J, C_out] is already the right operand. So the kernel is a tiled GEMM
// whose A tile is gathered: a block owns TM output voxels of one sample and
// TN output channels (no atomics), and walks j in chunks of TK inside the
// block, skipping what is all misses (most of it on sparse scenes).
//
// Two kernels share that design:
//  * fused_conv_mma_kernel — bf16 with C_in % 32 == 0, C_out % 8 == 0 and
//    K <= 32 (every k2 and k3 conv of the encoder): the block first loads its
//    [TM, K] tile of the map into shared memory and lists the offsets that
//    hit a voxel anywhere in the tile; then, per (listed offset, 32-channel
//    chunk), each thread stages one 16-byte vector of a gathered row and of W
//    (the next chunk's loads are started before this chunk's product, so they
//    overlap it) and the warps multiply on the tensor cores (mma.sync through
//    the wmma API, bf16 in, f32 accumulators in registers).
//  * fused_conv_kernel — every other case (float32 inputs, conv0's C_in = 3
//    with K = 125): f32 FMAs on the CUDA cores, inputs converted when they
//    are staged (products of bf16 values are exact in f32). Flattening j
//    makes every C_in work: at C_in = 3 a chunk spans ~10 offsets instead of
//    wasting 29 of 32 lanes. Before a chunk is staged the block votes
//    (__syncthreads_or) on whether any of its TM x TK entries hits a voxel;
//    the vote doubles as the barrier between the previous chunk's reads of
//    shared memory and this chunk's writes.
// wgmma, TMA and cp.async pipelines are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;    // output voxels per block
constexpr int TK = 32;    // contraction chunk
constexpr int NT = 256;   // threads per block, a 16 x 16 grid of micro-tiles

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int TN>
__global__ void __launch_bounds__(NT)
fused_conv_kernel(const T* __restrict__ feats, const int* __restrict__ idx,
                  const T* __restrict__ w, float* __restrict__ out, int V_in,
                  int V_out, int K, int C_in, int C_out) {
  constexpr int RM = TM / 16;            // rows per thread
  constexpr int RN = TN / 16;            // columns per thread
  constexpr int A_PER = TM * TK / NT;    // staged A elements per thread
  constexpr int B_PER = TK * TN / NT;    // staged W elements per thread
  __shared__ float As[TK][TM + 1];       // [j][row], +1 against bank conflicts
  __shared__ float Bs[TK][TN];           // [j][col]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int v0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  const int b = blockIdx.z;
  const int J = K * C_in;
  const T* feats_b = feats + (size_t)b * V_in * C_in;
  const int* idx_b = idx + (size_t)b * V_out * K;

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int n = 0; n < RN; ++n) acc[i][n] = 0.f;

  for (int j0 = 0; j0 < J; j0 += TK) {
    // which input row feeds each A element this thread stages (-1: zero)
    int src[A_PER];
    int any = 0;
#pragma unroll
    for (int t = 0; t < A_PER; ++t) {
      const int e = tid + t * NT;
      const int r = e / TK, j = j0 + e % TK, v = v0 + r;
      int s = -1;
      if (j < J && v < V_out) {
        const int i = idx_b[(size_t)v * K + j / C_in];
        if (i >= 0 && i < V_in) s = i;
      }
      src[t] = s;
      any |= (s >= 0);
    }
    // block-wide vote; also the barrier before shared memory is overwritten
    if (!__syncthreads_or(any)) continue;

#pragma unroll
    for (int t = 0; t < A_PER; ++t) {
      const int e = tid + t * NT;
      const int r = e / TK, cj = e % TK;
      float a = 0.f;
      if (src[t] >= 0)
        a = to_float(feats_b[(size_t)src[t] * C_in + (j0 + cj) % C_in]);
      As[cj][r] = a;
    }
#pragma unroll
    for (int t = 0; t < B_PER; ++t) {
      const int e = tid + t * NT;
      const int kk = e / TN, n = e % TN;
      const int j = j0 + kk, col = n0 + n;
      Bs[kk][n] = (j < J && col < C_out)
                      ? to_float(w[(size_t)j * C_out + col]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[RM], bb[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = As[kk][ty * RM + i];
#pragma unroll
      for (int n = 0; n < RN; ++n) bb[n] = Bs[kk][tx * RN + n];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int n = 0; n < RN; ++n) acc[i][n] = fmaf(a[i], bb[n], acc[i][n]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int v = v0 + ty * RM + i;
    if (v >= V_out) continue;
    float* o = out + ((size_t)b * V_out + v) * C_out;
#pragma unroll
    for (int n = 0; n < RN; ++n) {
      const int col = n0 + tx * RN + n;
      if (col < C_out) o[col] = acc[i][n];
    }
  }
}


// ---- tensor-core kernel (bf16, C_in % 32 == 0, C_out % 8 == 0, K <= MAXK) --

constexpr int MAXK = 32;  // offsets whose map tile is kept in shared memory

template <int TN>
__global__ void __launch_bounds__(NT)
fused_conv_mma_kernel(const __nv_bfloat16* __restrict__ feats,
                      const int* __restrict__ idx,
                      const __nv_bfloat16* __restrict__ w,
                      float* __restrict__ out, int V_in, int V_out, int K,
                      int C_in, int C_out) {
  using namespace nvcuda;
  constexpr int FN = TN / 32;            // 16-wide column fragments per warp
  constexpr int LDA = TK + 8;            // padded rows: conflict-free, 16 B aligned
  constexpr int LDB = TN + 8;
  constexpr int BV = TK * TN / 8;        // 16-byte vectors in a W chunk
  constexpr int B_PER = (BV + NT - 1) / NT;
  __shared__ __align__(32) __nv_bfloat16 As[TM * LDA];
  __shared__ __align__(32) __nv_bfloat16 Bs[TK * LDB];
  __shared__ __align__(32) float stage[NT / 32][256];
  __shared__ int idx_s[TM * MAXK];       // input row per (voxel, offset); -1: miss
  __shared__ int active[MAXK];           // offsets that hit a voxel in this tile
  __shared__ int n_active_s;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int v0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  const int b = blockIdx.z;
  const __nv_bfloat16* feats_b = feats + (size_t)b * V_in * C_in;
  const int* idx_b = idx + (size_t)b * V_out * K;
  const int rows = min(TM, V_out - v0);

  // the tile's rows of the map are contiguous in memory: one coalesced read
  for (int e = tid; e < TM * K; e += NT) {
    const int r = e / K;
    int i = -1;
    if (r < rows) {
      i = idx_b[(size_t)v0 * K + e];
      if (i < 0 || i >= V_in) i = -1;
    }
    idx_s[e] = i;
  }
  __syncthreads();
  if (warp == 0) {
    int hit = 0;
    if (lane < K)
      for (int r = 0; r < TM; ++r) hit |= (idx_s[r * K + lane] >= 0);
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (hit) active[__popc(m & ((1u << lane) - 1u))] = lane;
    if (lane == 0) n_active_s = __popc(m);
  }
  __syncthreads();
  const int chunks = C_in / TK;
  const int n_items = n_active_s * chunks;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FN];
#pragma unroll
  for (int f = 0; f < FN; ++f) wmma::fill_fragment(acc[f], 0.f);

  // this thread's share of a chunk: one vector of a gathered row, B_PER of W
  const int ar = tid / 4, av = tid % 4;
  uint4 pa, pb[B_PER];
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  auto prefetch = [&](int item) {
    const int k = active[item / chunks];
    const int c0 = (item % chunks) * TK;
    const int src = idx_s[ar * K + k];
    pa = zero4;
    if (src >= 0)
      pa = *reinterpret_cast<const uint4*>(feats_b + (size_t)src * C_in + c0 + av * 8);
#pragma unroll
    for (int t = 0; t < B_PER; ++t) {
      const int q = tid + t * NT;
      const int kk = q / (TN / 8), col = n0 + (q % (TN / 8)) * 8;
      pb[t] = zero4;
      if (q < BV && col < C_out)
        pb[t] = *reinterpret_cast<const uint4*>(
            w + ((size_t)k * C_in + c0 + kk) * C_out + col);
    }
  };

  const int rf = warp / 2;               // row fragment of this warp (0..3)
  const int cg = (warp % 2) * FN;        // its first column fragment
  if (n_items > 0) prefetch(0);
  for (int item = 0; item < n_items; ++item) {
    __syncthreads();                     // the previous product has read As/Bs
    *reinterpret_cast<uint4*>(As + ar * LDA + av * 8) = pa;
#pragma unroll
    for (int t = 0; t < B_PER; ++t) {
      const int q = tid + t * NT;
      if (q < BV)
        *reinterpret_cast<uint4*>(Bs + (q / (TN / 8)) * LDB + (q % (TN / 8)) * 8) = pb[t];
    }
    if (item + 1 < n_items) prefetch(item + 1);   // in flight during the product
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < TK / 16; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, As + rf * 16 * LDA + ks * 16, LDA);
#pragma unroll
      for (int f = 0; f < FN; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Bs + ks * 16 * LDB + (cg + f) * 16, LDB);
        wmma::mma_sync(acc[f], fa, fb, acc[f]);
      }
    }
  }

  // each warp writes its fragments; a ragged edge goes through shared memory
#pragma unroll
  for (int f = 0; f < FN; ++f) {
    const int r0 = rf * 16, c0 = n0 + (cg + f) * 16;
    if (c0 >= C_out) continue;
    float* o = out + ((size_t)b * V_out + v0 + r0) * C_out + c0;
    if (r0 + 16 <= rows && c0 + 16 <= C_out) {
      wmma::store_matrix_sync(o, acc[f], C_out, wmma::mem_row_major);
    } else {
      wmma::store_matrix_sync(stage[warp], acc[f], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16, c = e % 16;
        if (r0 + r < rows && c0 + c < C_out) o[(size_t)r * C_out + c] = stage[warp][e];
      }
      __syncwarp();
    }
  }
}

template <int TN>
int launch_mma(const void* feats, const void* idx, const void* w, void* out,
               int B, int V_in, int V_out, int K, int C_in, int C_out,
               cudaStream_t stream) {
  dim3 grid((V_out + TM - 1) / TM, (C_out + TN - 1) / TN, B);
  fused_conv_mma_kernel<TN><<<grid, NT, 0, stream>>>(
      (const __nv_bfloat16*)feats, (const int*)idx, (const __nv_bfloat16*)w,
      (float*)out, V_in, V_out, K, C_in, C_out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* feats, const void* idx, const void* w, void* out, int B,
           int V_in, int V_out, int K, int C_in, int C_out,
           cudaStream_t stream) {
  if (B == 0 || V_out == 0 || C_out == 0) return 0;
  const int tn = C_out <= 32 ? 32 : 64;
  dim3 grid((V_out + TM - 1) / TM, (C_out + tn - 1) / tn, B);
  if (tn == 32)
    fused_conv_kernel<T, 32><<<grid, NT, 0, stream>>>(
        (const T*)feats, (const int*)idx, (const T*)w, (float*)out, V_in,
        V_out, K, C_in, C_out);
  else
    fused_conv_kernel<T, 64><<<grid, NT, 0, stream>>>(
        (const T*)feats, (const int*)idx, (const T*)w, (float*)out, V_in,
        V_out, K, C_in, C_out);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int s3d_fused_sparse_conv(const void* feats, const void* idx,
                                     const void* w, void* out, int B, int V_in,
                                     int V_out, int K, int C_in, int C_out,
                                     int is_bf16, void* stream) {
  if (B == 0 || V_out == 0 || C_out == 0) return 0;
  const bool aligned = (((uintptr_t)feats | (uintptr_t)w | (uintptr_t)out) & 31) == 0;
  if (is_bf16 && aligned && C_in % TK == 0 && C_out % 8 == 0 && K <= MAXK) {
    cudaStream_t s = (cudaStream_t)stream;
    if (C_out <= 32)
      return launch_mma<32>(feats, idx, w, out, B, V_in, V_out, K, C_in, C_out, s);
    if (C_out <= 64)
      return launch_mma<64>(feats, idx, w, out, B, V_in, V_out, K, C_in, C_out, s);
    return launch_mma<128>(feats, idx, w, out, B, V_in, V_out, K, C_in, C_out, s);
  }
  if (is_bf16)
    return launch<__nv_bfloat16>(feats, idx, w, out, B, V_in, V_out, K, C_in,
                                 C_out, (cudaStream_t)stream);
  return launch<float>(feats, idx, w, out, B, V_in, V_out, K, C_in, C_out,
                       (cudaStream_t)stream);
}
