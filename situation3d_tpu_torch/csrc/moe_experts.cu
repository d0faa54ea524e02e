// The expert layer's grouped products: every expert's segment of
// (token, expert) assignments, as the segment plan (csrc/segment_plan.cu)
// groups them, through that expert's feed-forward, a SwiGLU (LFM2) or a
// non-gated relu^2 (Nemotron-H):
//
//   gate-up:  h[p, :]  = silu(w1[e] x[t]) * (w3[e] x[t])      (bf16 [A, M])
//     or up:  h[p, :]  = relu(w1[e] x[t])^2                   (RELU2)
//   down:     y[a, :]  = weight[a] * (w2[e] h[p])              (f32 [A, D])
//
// for every sorted position p in expert e's segment offsets[e] ..
// offsets[e+1], a = perm[p] the assignment there and t = a / K its token.
// Rows of dropped assignments are left as the caller made them.
//
// Replaces no TPU kernel (the JAX package has no experts); added for LFM2's
// expert layers (ops/cuda/moe_experts.py, whose plain version repeats this
// arithmetic). Bound on this card: bytes. A decode step sends a handful of
// rows to each chosen expert, and each of its 18.9 MB of weights serves only
// those rows; a prefill's ~40 rows an expert stay below the ridge (295
// operations a byte).
//
// Design: one block of 4 warps per (column tile, expert); the grid is fixed
// by the shapes, and a block whose expert has no rows returns at once, so a
// step never reads the plan on the host and can be captured in a graph. A
// warp owns 4 tiles of 8 weight rows (gate-up: 16 columns of w1 and the same
// 16 of w3, so silu(gate) * up is formed in registers; the relu^2 up: 32
// columns of w1, a warp past the last column idle; down: 32 output
// columns) and walks the reduction axis 64 at a time with mma.sync
// m16n8k16 (bf16 in, f32 sums), for up to 64 segment rows at once; longer
// segments take further passes. No shared memory: each lane loads 16 bytes
// of a weight row (8 consecutive k) straight into its fragment registers,
// and the A fragment takes the same 8 k of its rows, so the k order inside
// an mma is a permutation shared by both operands and the sum is unchanged.
// Weight loads bypass L1 (each byte is read by one warp once per pass);
// token rows are read through L1/L2. Pad rows of the last m16 tile repeat the
// segment's first row and are not stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MOE_WARPS = 4;
constexpr int MOE_MT = 4;    // m16 tiles a pass: 64 segment rows
constexpr int MOE_NT = 4;    // n8 tiles a warp
constexpr int MOE_KSTEP = 64;

__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 load_stream(const __nv_bfloat16* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

// GATE: a_src = x [N, D], wa = w1, wb = w3 (unread with RELU2), out h; else
// a_src = h [A, M], wa = w2, out y.
template <bool GATE, bool RELU2 = false>
__global__ void __launch_bounds__(MOE_WARPS * 32)
    moe_grouped_kernel(const __nv_bfloat16* __restrict__ a_src,
                       const int* __restrict__ perm,
                       const int* __restrict__ offsets,
                       const float* __restrict__ weight,
                       const __nv_bfloat16* __restrict__ wa,
                       const __nv_bfloat16* __restrict__ wb,
                       __nv_bfloat16* __restrict__ h_out,
                       float* __restrict__ y_out, int K, int D, int M) {
  const int e = blockIdx.y;
  const int s = offsets[e];
  const int seg = offsets[e + 1] - s;
  if (seg <= 0) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int kdim = GATE ? D : M;
  const int col0 = (blockIdx.x * MOE_WARPS + warp) * (GATE && !RELU2 ? 16 : 32);
  if (RELU2 && col0 >= M) return;
  const __nv_bfloat16* bp[MOE_NT];
#pragma unroll
  for (int nt = 0; nt < MOE_NT; ++nt) {
    if (RELU2)
      bp[nt] = wa + ((size_t)e * M + col0 + nt * 8 + g) * (size_t)D + 8 * c;
    else if (GATE)
      bp[nt] = (nt < 2 ? wa : wb) +
               ((size_t)e * M + col0 + (nt & 1) * 8 + g) * (size_t)D + 8 * c;
    else
      bp[nt] = wa + ((size_t)e * D + col0 + nt * 8 + g) * (size_t)M + 8 * c;
  }
  for (int r0 = 0; r0 < seg; r0 += MOE_MT * 16) {
    const int nmt = (min(seg - r0, MOE_MT * 16) + 15) >> 4;
    const __nv_bfloat16* ap[MOE_MT][2];
#pragma unroll
    for (int mt = 0; mt < MOE_MT; ++mt)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        int r = r0 + mt * 16 + hi * 8 + g;
        int pos = s + (r < seg ? r : 0);
        ap[mt][hi] = GATE ? a_src + (size_t)(perm[pos] / K) * D + 8 * c
                          : a_src + (size_t)pos * M + 8 * c;
      }
    float acc[MOE_MT][MOE_NT][4];
#pragma unroll
    for (int mt = 0; mt < MOE_MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < MOE_NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
    for (int k0 = 0; k0 < kdim; k0 += MOE_KSTEP) {
      uint4 bv[MOE_NT][2];
#pragma unroll
      for (int nt = 0; nt < MOE_NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) bv[nt][j] = load_stream(bp[nt] + k0 + 32 * j);
#pragma unroll
      for (int mt = 0; mt < MOE_MT; ++mt) {
        if (mt < nmt) {
          uint4 av[2][2];
#pragma unroll
          for (int hi = 0; hi < 2; ++hi)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              av[hi][j] = __ldg(reinterpret_cast<const uint4*>(ap[mt][hi] + k0 + 32 * j));
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int nt = 0; nt < MOE_NT; ++nt) {
              mma_bf16(acc[mt][nt], av[0][j].x, av[1][j].x, av[0][j].y,
                       av[1][j].y, bv[nt][j].x, bv[nt][j].y);
              mma_bf16(acc[mt][nt], av[0][j].z, av[1][j].z, av[0][j].w,
                       av[1][j].w, bv[nt][j].z, bv[nt][j].w);
            }
        }
      }
    }
    // C fragment: acc[..][q] is row g + 8 * (q >> 1), column 2c + (q & 1)
#pragma unroll
    for (int mt = 0; mt < MOE_MT; ++mt) {
      if (mt >= nmt) continue;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = r0 + mt * 16 + hi * 8 + g;
        if (r >= seg) continue;
        const int pos = s + r;
        if (RELU2) {
#pragma unroll
          for (int nt = 0; nt < MOE_NT; ++nt) {
            float v0 = fmaxf(acc[mt][nt][2 * hi], 0.f);
            float v1 = fmaxf(acc[mt][nt][2 * hi + 1], 0.f);
            *reinterpret_cast<__nv_bfloat162*>(h_out + (size_t)pos * M + col0 + nt * 8 +
                                               2 * c) = __floats2bfloat162_rn(v0 * v0, v1 * v1);
          }
        } else if (GATE) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float v0 = silu(acc[mt][half][2 * hi]) * acc[mt][half + 2][2 * hi];
            float v1 = silu(acc[mt][half][2 * hi + 1]) * acc[mt][half + 2][2 * hi + 1];
            *reinterpret_cast<__nv_bfloat162*>(h_out + (size_t)pos * M + col0 +
                                               half * 8 + 2 * c) =
                __floats2bfloat162_rn(v0, v1);
          }
        } else {
          const int a = perm[pos];
          const float w = weight[a];
#pragma unroll
          for (int nt = 0; nt < MOE_NT; ++nt)
            *reinterpret_cast<float2*>(y_out + (size_t)a * D + col0 + nt * 8 + 2 * c) =
                make_float2(w * acc[mt][nt][2 * hi], w * acc[mt][nt][2 * hi + 1]);
        }
      }
    }
  }
}

}  // namespace

// x bf16 [N, D]; perm / offsets int32: the segment plan of the N*K expert ids
// over E experts; weight f32 [N*K]; w1, w3 bf16 [E, M, D]; w2 bf16 [E, D, M];
// h bf16 [N*K, M] scratch; y f32 [N*K, D].
// D a multiple of 128, M of 64. Returns cudaGetLastError().
extern "C" int s3d_moe_experts(const void* x, const void* perm, const void* offsets,
                               const void* weight, const void* w1, const void* w3,
                               const void* w2, void* h, void* y, int N, int K,
                               int E, int D, int M, void* stream) {
  if (N <= 0 || K <= 0 || E <= 0 || D % 128 != 0 || M % 64 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 block(MOE_WARPS * 32);
  moe_grouped_kernel<true><<<dim3(M / (MOE_WARPS * 16), E), block, 0, st>>>(
      (const __nv_bfloat16*)x, (const int*)perm, (const int*)offsets,
      (const float*)weight, (const __nv_bfloat16*)w1, (const __nv_bfloat16*)w3,
      (__nv_bfloat16*)h, (float*)y, K, D, M);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  moe_grouped_kernel<false><<<dim3(D / (MOE_WARPS * 32), E), block, 0, st>>>(
      (const __nv_bfloat16*)h, (const int*)perm, (const int*)offsets,
      (const float*)weight, (const __nv_bfloat16*)w2, nullptr, nullptr, (float*)y,
      K, D, M);
  return (int)cudaGetLastError();
}

// The non-gated form: h = relu(w1[e] x)^2, then the same down product.
// w1 bf16 [E, M, D]; w2 bf16 [E, D, M]; D a multiple of 128, M of 64.
extern "C" int s3d_moe_experts_relu2(const void* x, const void* perm, const void* offsets,
                                     const void* weight, const void* w1, const void* w2,
                                     void* h, void* y, int N, int K, int E, int D, int M,
                                     void* stream) {
  if (N <= 0 || K <= 0 || E <= 0 || D % 128 != 0 || M % 64 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 block(MOE_WARPS * 32);
  moe_grouped_kernel<true, true><<<dim3((M + MOE_WARPS * 32 - 1) / (MOE_WARPS * 32), E), block,
                                   0, st>>>(
      (const __nv_bfloat16*)x, (const int*)perm, (const int*)offsets,
      (const float*)weight, (const __nv_bfloat16*)w1, nullptr, (__nv_bfloat16*)h,
      (float*)y, K, D, M);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  moe_grouped_kernel<false><<<dim3(D / (MOE_WARPS * 32), E), block, 0, st>>>(
      (const __nv_bfloat16*)h, (const int*)perm, (const int*)offsets,
      (const float*)weight, (const __nv_bfloat16*)w2, nullptr, nullptr, (float*)y,
      K, D, M);
  return (int)cudaGetLastError();
}
