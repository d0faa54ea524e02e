// Fused sparse convolution: gather + miss mask + per-offset product, summed
// over the kernel offsets in f32.
//
// Replaces the TPU kernel situation3d_tpu/ops/pallas/fused_conv.py
// (_fused_kernel / fused_sparse_conv, forward; the port reuses it for dx).
//
//   out[b, v, :] = sum_k [0 <= idx[b,v,k] < V_in] * feats[b, idx[b,v,k], :] @ W[k]
//
// feats [B, V_in, C_in] in float or bf16, idx int32 [B, V_out, K], out float
// [B, V_out, C_out]. Both miss conventions (V_in and -1) read as a zero row.
// The gathered [B, V_out, K, C_in] windows never exist in device memory.
// Every output element is summed by one thread in a fixed order (offsets
// ascending, then channels): no split of the contraction, no float atomics,
// so two runs give the same bits.
//
// The sum over offsets and channels is ONE contraction over (offset,
// channel) whose left operand is gathered. Three kernels, chosen by the
// wrapper (ops/cuda/fused_conv.py:conv_route) and passed in as `route`:
//
//  * ROUTE_WGMMA, conv_wgmma_kernel — bf16, C_in % 32 == 0, C_out % 8 == 0,
//    C_out <= 256, K <= 32: every k2, k3 and transposed conv of the UNet.
//    Its bound on an H100: the f32 output bytes (levels 0-2) or the tensor
//    cores (levels 3-4). A block owns 128 output voxels of one sample and
//    every output channel (so a gathered row is read once per tile). It first
//    lists the offsets that hit a voxel anywhere in its [128, K] map tile;
//    each (listed offset, BK-channel chunk) is one item of the contraction.
//    Warp specialisation over a 3-stage ring of shared-memory stages with
//    mbarriers: producer warps (one or two warpgroups) gather the item's 128
//    feature rows with cp.async (16 B a thread, src-size 0 zero-fills a miss)
//    straight into the 128-byte (BK = 64) or 64-byte (BK = 32) swizzled
//    layout that wgmma reads, and one of their threads brings the item's
//    [BNP, BK] slice of W^T ([C_out, K*C_in], made by the wrapper) by TMA
//    into the same swizzle; two consumer warpgroups (64 rows each) run
//    wgmma.mma_async (bf16 in, f32 accumulators in registers) and release
//    the stage. f32
//    rows are written straight from the accumulators, ragged V_out masked.
//    TMA cannot gather rows on Hopper, hence cp.async for A. Measured on an
//    H100, the rate at which the producers issue the gathers (misses
//    included: they zero-fill) is what holds it back: 32 producer threads
//    run at half the speed of 128, 256 is faster again at 64 and 128
//    output columns, and deeper rings, bigger stages, a cluster that
//    multicasts W, or polling waits did not help (PERF.md, PR 6). Three
//    stages let more blocks share an SM.
//  * ROUTE_STREAM, conv_stream_kernel — C_in <= 4, C_out <= 32, K <= 128
//    (conv0: C_in = 3, K = 125), bf16 or f32. Bound by the map's bytes
//    (196.6 MB at B = 8): its operations are a few hundred MFLOP even if
//    every entry hit, so it stays on the CUDA cores. Persistent blocks
//    stream [64, K] map tiles into shared memory by 1-D bulk copies (two in
//    flight a block), W sits in shared memory, each warp takes 4 rows at a
//    time: every lane reads its map entries, loads the features
//    of its hits (all loads in flight at once), then ballots compact each
//    row's hits and one lane per output channel accumulates
//    f0*W[k,0,c] + f1*W[k,1,c] + f2*W[k,2,c] over them in ascending k and
//    writes the row's C_out floats at once.
//  * ROUTE_FMA, fused_conv_kernel — everything else (f32 inputs at wide
//    channels): the first version of the port, f32 FMAs on the CUDA cores,
//    a block votes (__syncthreads_or) per 32-wide chunk of the contraction
//    and skips what is all misses.
#include <cuda.h>   // CUtensorMap; the driver's encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { ROUTE_FMA = 0, ROUTE_WGMMA = 1, ROUTE_STREAM = 2 };

constexpr int TM = 64;    // FMA kernel: output voxels per block
constexpr int TK = 32;    // FMA kernel: contraction chunk
constexpr int NT = 256;   // FMA kernel: threads per block, a 16 x 16 grid of micro-tiles

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// ---- PTX helpers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

// Waits for the completion of the barrier's phase of this parity. A wait
// that outlasts any real copy by orders of magnitude means a lost arrival:
// trap (a launch error the caller sees) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t spins = 0;
  while (!mbar_try_wait(bar, parity))
    if (++spins == (1u << 26)) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes) : "memory");
}

// the barrier counts one arrival when all of this thread's earlier cp.async
// copies have landed
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

// 16 bytes global -> shared; src_bytes = 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst), "l"((uint64_t)map), "r"(bar), "r"(c0),
      "r"(c1) : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile whose rows are ROW_BYTES
// (128: 128-byte swizzle, 64: 64-byte swizzle) and whose 8-row groups follow
// each other (stride 8 * ROW_BYTES)
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t smem_desc(uint32_t saddr) {
  constexpr uint64_t layout = ROW_BYTES == 128 ? 1 : 2;
  constexpr uint64_t sbo = (8 * ROW_BYTES) >> 4;
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | (1ull << 16) | (sbo << 32) | (layout << 62);
}

// byte offset of 16-byte chunk `chunk` of row `row` in that swizzled tile
// (the address bits [4, 7) or [4, 6) XOR the row's bits above the line)
template <int ROW_BYTES>
__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
  if (ROW_BYTES == 128) return row * 128 + ((chunk ^ (row & 7)) << 4);
  return row * 64 + ((chunk ^ ((row >> 1) & 3)) << 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}


// ---- ROUTE_WGMMA: gathered-A GEMM on wgmma ---------------------------------

constexpr int WG_BM = 128;       // output voxels a block (two consumer warpgroups)
constexpr int WG_STAGES = 3;     // ring of shared-memory stages
constexpr int WG_MAXK = 32;      // offsets whose map tile is kept in shared memory
constexpr int WG_CONSUMERS = 256;    // two consumer warpgroups, warps 0-7

template <int BK, int NF64, int HAS32>
struct WgShape {
  static constexpr int BNP = 64 * NF64 + 32 * HAS32;   // C_out rounded up
  static constexpr int ROW = BK * 2;                   // bytes of a tile row
  static constexpr int A_BYTES = WG_BM * ROW;
  static constexpr int B_BYTES = BNP * ROW;
  static constexpr int STAGE = A_BYTES + B_BYTES;      // multiples of 1024
  static constexpr int MAP_OFF = WG_STAGES * STAGE;
  static constexpr int LIST_OFF = MAP_OFF + WG_BM * WG_MAXK * 4;
  static constexpr int BAR_OFF = LIST_OFF + (WG_MAXK + 2) * 4;
  static constexpr int SMEM = 1024 + BAR_OFF + 2 * WG_STAGES * 8;   // + alignment slack
  // producer threads after the consumers: the gathers' issue rate sets the
  // pace, so 256 where 64 or 128 accumulator columns leave the registers
  // (measured faster there, slower at 32 / 96 columns); 128 at 256 columns
  static constexpr int PRODUCERS = (BNP == 64 || BNP == 128) ? 256 : 128;
  static constexpr int THREADS = WG_CONSUMERS + PRODUCERS;
};

template <int BK, int NF64, int HAS32>
__global__ void __launch_bounds__(WgShape<BK, NF64, HAS32>::THREADS, 1)
conv_wgmma_kernel(const __nv_bfloat16* __restrict__ feats, const int* __restrict__ idx,
                  const __grid_constant__ CUtensorMap w_map, float* __restrict__ out,
                  int V_in, int V_out, int K, int C_in, int C_out) {
  using S = WgShape<BK, NF64, HAS32>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  int* idx_s = (int*)(smem + S::MAP_OFF);         // input row per (voxel, offset); -1: miss
  int* active = (int*)(smem + S::LIST_OFF);       // offsets that hit a voxel of the tile
  uint64_t* full = (uint64_t*)(smem + S::BAR_OFF);
  uint64_t* empty = full + WG_STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int v0 = blockIdx.x * WG_BM, b = blockIdx.y;
  const int rows = min(WG_BM, V_out - v0);
  const __nv_bfloat16* feats_b = feats + (size_t)b * V_in * C_in;
  const int* idx_b = idx + ((size_t)b * V_out + v0) * K;

  // the tile's rows of the map are contiguous in memory: one coalesced read
  // with every load of a thread in flight at once, and a column mask of hits
  constexpr int PER = (WG_BM * WG_MAXK + S::THREADS - 1) / S::THREADS;
  unsigned* hitmask = (unsigned*)(active + WG_MAXK);
  if (tid == 0) {
    *hitmask = 0u;
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(smem_u32(full + s), S::PRODUCERS + 1);   // cp.async arrivals + the TMA's
      mbar_init(smem_u32(empty + s), WG_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  int v[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = tid + j * S::THREADS;
    v[j] = e < rows * K ? idx_b[e] : -1;
  }
  __syncthreads();
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = tid + j * S::THREADS;
    if (e < WG_BM * K) {
      const int i = (v[j] >= 0 && v[j] < V_in) ? v[j] : -1;
      idx_s[e] = i;
      if (i >= 0) m |= 1u << (e % K);
    }
  }
  m = __reduce_or_sync(0xffffffffu, m);
  if (lane == 0 && m) atomicOr(hitmask, m);
  __syncthreads();
  if (warp == 0) {
    const unsigned mask = *hitmask;
    if ((mask >> lane) & 1u) active[__popc(mask & ((1u << lane) - 1u))] = lane;
  }
  __syncthreads();
  const int chunks = C_in / BK;
  const int n_items = __popc(*hitmask) * chunks;   // item = (listed offset, chunk)

  if (warp >= WG_CONSUMERS / 32) {
    // ---- producer warps ------------------------------------------------------
    const int ptid = tid - WG_CONSUMERS;
    constexpr int CPR = S::ROW / 16;                 // 16-byte chunks a row
    constexpr int RSTEP = S::PRODUCERS / CPR;        // rows a pass
    const int chunk = ptid % CPR, row0 = ptid / CPR;
    for (int it = 0; it < n_items; ++it) {
      const int s = it % WG_STAGES, round = it / WG_STAGES;
      if (round > 0) mbar_wait(smem_u32(empty + s), (round - 1) & 1);
      const int k = active[it / chunks];
      const int c0 = (it % chunks) * BK;
      uint8_t* a_s = smem + s * S::STAGE;
      if (ptid == 0) {
        mbar_arrive_expect_tx(smem_u32(full + s), S::B_BYTES);
        tma_load_2d(smem_u32(a_s + S::A_BYTES), &w_map, smem_u32(full + s), k * C_in + c0, 0);
      }
#pragma unroll
      for (int p = 0; p < WG_BM / RSTEP; ++p) {
        const int row = row0 + p * RSTEP;
        const int src = idx_s[row * K + k];
        const __nv_bfloat16* g = src >= 0 ? feats_b + (size_t)src * C_in + c0 + chunk * 8 : feats;
        cp_async_16(smem_u32(a_s) + swizzled<S::ROW>(row, chunk), g, src >= 0 ? 16 : 0);
      }
      cp_async_arrive_noinc(smem_u32(full + s));
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  } else {
    // ---- consumer warpgroups: 64 rows each -----------------------------------
    const int g = warp / 4;                          // 0 or 1
    float acc[NF64 > 0 ? NF64 : 1][32];
    float acc32[16];
#pragma unroll
    for (int j = 0; j < NF64; ++j)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) acc32[e] = 0.f;

    for (int it = 0; it < n_items; ++it) {
      const int s = it % WG_STAGES, round = it / WG_STAGES;
      mbar_wait(smem_u32(full + s), round & 1);
      // the A rows were written by cp.async (generic proxy); wgmma reads
      // through the async proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      const uint8_t* a_s = smem + s * S::STAGE;
      const uint64_t da = smem_desc<S::ROW>(smem_u32(a_s + g * 64 * S::ROW));
      const uint64_t db = smem_desc<S::ROW>(smem_u32(a_s + S::A_BYTES));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < NF64; ++j)
          wgmma_m64n64k16(acc[j], da + 2 * kk, db + ((j * 64 * S::ROW) >> 4) + 2 * kk);
        if (HAS32)
          wgmma_m64n32k16(acc32, da + 2 * kk, db + ((NF64 * 64 * S::ROW) >> 4) + 2 * kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(empty + s));
    }

    // accumulator layout (wgmma D, f32): n8 block q of a 64-column fragment
    // holds rows (warp % 4) * 16 + lane / 4 (+ 8) and columns q * 8 + (lane % 4) * 2 (+ 1)
    const int r0 = g * 64 + (warp % 4) * 16 + lane / 4;
    const int cl = (lane % 4) * 2;
    float* out_b = out + ((size_t)b * V_out + v0) * C_out;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= rows) continue;
      float* o = out_b + (size_t)r * C_out;
#pragma unroll
      for (int j = 0; j < NF64; ++j)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int c = j * 64 + q * 8 + cl;
          if (c < C_out)
            *reinterpret_cast<float2*>(o + c) = make_float2(acc[j][q * 4 + 2 * h],
                                                            acc[j][q * 4 + 2 * h + 1]);
        }
      if (HAS32)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = NF64 * 64 + q * 8 + cl;
          if (c < C_out)
            *reinterpret_cast<float2*>(o + c) = make_float2(acc32[q * 4 + 2 * h],
                                                            acc32[q * 4 + 2 * h + 1]);
        }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = (EncodeTiledFn)p;
  }
  return fn;
}

template <int BK, int NF64, int HAS32>
int launch_wgmma(const void* feats, const void* idx, const void* wt, void* out, int B,
                 int V_in, int V_out, int K, int C_in, int C_out, cudaStream_t stream) {
  using S = WgShape<BK, NF64, HAS32>;
  EncodeTiledFn encode = encode_tiled();
  if (!encode) return (int)cudaErrorSymbolNotFound;
  // W^T [C_out, K*C_in] bf16: rows of the box past C_out read as zeros
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)K * C_in, (cuuint64_t)C_out};
  const cuuint64_t strides[1] = {(cuuint64_t)K * C_in * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)S::BNP};
  const cuuint32_t estr[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(wt), dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             BK == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  auto kern = conv_wgmma_kernel<BK, NF64, HAS32>;
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         S::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  dim3 grid((V_out + WG_BM - 1) / WG_BM, B);
  kern<<<grid, S::THREADS, S::SMEM, stream>>>((const __nv_bfloat16*)feats, (const int*)idx,
                                              map, (float*)out, V_in, V_out, K, C_in, C_out);
  return (int)cudaGetLastError();
}

template <int BK>
int dispatch_wgmma(const void* feats, const void* idx, const void* wt, void* out, int B,
                   int V_in, int V_out, int K, int C_in, int C_out, cudaStream_t s) {
  const int bnp = (C_out + 31) / 32 * 32;
  if (bnp <= 32)
    return launch_wgmma<BK, 0, 1>(feats, idx, wt, out, B, V_in, V_out, K, C_in, C_out, s);
  if (bnp <= 64)
    return launch_wgmma<BK, 1, 0>(feats, idx, wt, out, B, V_in, V_out, K, C_in, C_out, s);
  if (bnp <= 96)
    return launch_wgmma<BK, 1, 1>(feats, idx, wt, out, B, V_in, V_out, K, C_in, C_out, s);
  if (bnp <= 128)
    return launch_wgmma<BK, 2, 0>(feats, idx, wt, out, B, V_in, V_out, K, C_in, C_out, s);
  return launch_wgmma<BK, 4, 0>(feats, idx, wt, out, B, V_in, V_out, K, C_in, C_out, s);
}

// ---- ROUTE_STREAM: conv0, the map streamed at bandwidth ----------------------

constexpr int ST_BM = 64;        // map rows a tile
constexpr int ST_WARPS = 8;
constexpr int ST_R = 4;          // rows a warp takes at once
constexpr int ST_MAXK = 128;     // four 32-entry chunks of a map row

template <typename T, int CIN>
__global__ void __launch_bounds__(ST_WARPS * 32)
conv_stream_kernel(const T* __restrict__ feats, const int* __restrict__ idx,
                   const T* __restrict__ w, float* __restrict__ out, int B, int V_in,
                   int V_out, int K, int C_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  T* w_s = (T*)smem;                                          // [K][CIN][32]
  const int w_bytes = (K * CIN * 32 * (int)sizeof(T) + 15) / 16 * 16;
  int* map_s = (int*)(smem + w_bytes);                         // [2][ST_BM * K]
  uint64_t* bar = (uint64_t*)(smem + w_bytes + 2 * ST_BM * K * 4);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long total = (long long)B * V_out;                // flat map rows
  const int n_tiles = (int)((total + ST_BM - 1) / ST_BM);
  const bool aligned = ((uintptr_t)idx & 15) == 0;

  for (int e = tid; e < K * CIN * 32; e += blockDim.x) {
    const int c = e % 32, kc = e / 32;
    w_s[e] = c < C_out ? w[(size_t)kc * C_out + c] : from_float<T>(0.f);
  }
  if (tid == 0) {
    mbar_init(smem_u32(bar), 1);
    mbar_init(smem_u32(bar + 1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // a tile goes by one bulk copy when its byte count is a multiple of 16
  // (every tile but perhaps the last: 64 rows of K int32 are)
  auto tile_bytes = [&](int t) {
    const long long g0 = (long long)t * ST_BM;
    return (int)(min((long long)ST_BM, total - g0) * K * 4);
  };
  auto bulk_ok = [&](int t) { return aligned && tile_bytes(t) % 16 == 0; };
  auto issue = [&](int t, int buf) {
    const uint32_t bytes = tile_bytes(t);
    mbar_arrive_expect_tx(smem_u32(bar + buf), bytes);
    bulk_load(smem_u32(map_s + buf * ST_BM * K), idx + (size_t)t * ST_BM * K, bytes,
              smem_u32(bar + buf));
  };

  uint32_t phase[2] = {0, 0};
  int t = blockIdx.x;
  if (tid == 0 && t < n_tiles && bulk_ok(t)) issue(t, 0);
  for (int i = 0; t < n_tiles; ++i, t += gridDim.x) {
    const int buf = i & 1;
    const int tn = t + gridDim.x;
    // the other buffer was last read by tile i - 1, which ended in a barrier
    if (tid == 0 && tn < n_tiles && bulk_ok(tn)) issue(tn, buf ^ 1);
    int* m = map_s + buf * ST_BM * K;
    const long long g0 = (long long)t * ST_BM;
    const int rows = (int)min((long long)ST_BM, total - g0);
    if (bulk_ok(t)) {
      mbar_wait(smem_u32(bar + buf), phase[buf]);
      phase[buf] ^= 1;
    } else {
      for (int e = tid; e < rows * K; e += blockDim.x) m[e] = idx[(size_t)g0 * K + e];
      __syncthreads();
    }

    for (int r0 = warp * (ST_BM / ST_WARPS); r0 < (warp + 1) * (ST_BM / ST_WARPS); r0 += ST_R) {
      // every lane: its map entries of ST_R rows, and the features of its hits
      int src[ST_R][4];
      float f[ST_R][4][CIN];
#pragma unroll
      for (int r = 0; r < ST_R; ++r) {
        const int row = r0 + r;
        const long long g = g0 + row;
        const T* fb = feats + (size_t)(g / V_out) * V_in * CIN;
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
          const int k = ch * 32 + lane;
          int s = -1;
          if (row < rows && k < K) {
            s = m[row * K + k];
            if (s < 0 || s >= V_in) s = -1;
          }
          src[r][ch] = s;
#pragma unroll
          for (int c = 0; c < CIN; ++c)
            f[r][ch][c] = s >= 0 ? to_float(fb[(size_t)s * CIN + c]) : 0.f;
        }
      }
      // per row: ballots list its hits in ascending k; lane = output channel
#pragma unroll
      for (int r = 0; r < ST_R; ++r) {
        float acc = 0.f;
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
          unsigned hits = __ballot_sync(0xffffffffu, src[r][ch] >= 0);
          while (hits) {
            const int j = __ffs(hits) - 1;
            hits &= hits - 1;
            const T* wk = w_s + (ch * 32 + j) * CIN * 32 + lane;
#pragma unroll
            for (int c = 0; c < CIN; ++c)
              acc = fmaf(__shfl_sync(0xffffffffu, f[r][ch][c], j), to_float(wk[c * 32]), acc);
          }
        }
        const int row = r0 + r;
        if (row < rows && lane < C_out) out[(size_t)(g0 + row) * C_out + lane] = acc;
      }
    }
    __syncthreads();   // every warp is done with this buffer before it is refilled
  }
}

int n_sms() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

template <typename T, int CIN>
int launch_stream(const void* feats, const void* idx, const void* w, void* out, int B,
                  int V_in, int V_out, int K, int C_out, cudaStream_t stream) {
  const int smem = (K * CIN * 32 * (int)sizeof(T) + 15) / 16 * 16 + 2 * ST_BM * K * 4 + 16;
  auto kern = conv_stream_kernel<T, CIN>;
  static int attr = 0;        // the largest size set so far
  if (smem > attr) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr = smem;
  }
  const long long tiles = ((long long)B * V_out + ST_BM - 1) / ST_BM;
  int per_sm = 1;    // persistent: as many blocks as fit on the SMs at once
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, ST_WARPS * 32, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (int)min(tiles, (long long)n_sms() * max(per_sm, 1));
  kern<<<grid, ST_WARPS * 32, smem, stream>>>((const T*)feats, (const int*)idx, (const T*)w,
                                              (float*)out, B, V_in, V_out, K, C_out);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_stream(const void* feats, const void* idx, const void* w, void* out, int B,
                    int V_in, int V_out, int K, int C_in, int C_out, cudaStream_t s) {
  switch (C_in) {
    case 1: return launch_stream<T, 1>(feats, idx, w, out, B, V_in, V_out, K, C_out, s);
    case 2: return launch_stream<T, 2>(feats, idx, w, out, B, V_in, V_out, K, C_out, s);
    case 3: return launch_stream<T, 3>(feats, idx, w, out, B, V_in, V_out, K, C_out, s);
    default: return launch_stream<T, 4>(feats, idx, w, out, B, V_in, V_out, K, C_out, s);
  }
}


// ---- ROUTE_FMA: f32 FMAs on the CUDA cores -----------------------------------

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


template <typename T>
int launch_fma(const void* feats, const void* idx, const void* w, void* out, int B,
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

// route: ROUTE_FMA / ROUTE_WGMMA / ROUTE_STREAM (ops/cuda/fused_conv.py:conv_route).
// w is W^T [C_out, K*C_in] bf16 for ROUTE_WGMMA, else W [K, C_in, C_out] in
// the type of feats. Returns cudaGetLastError() after the launch (or the
// error that kept it from launching).
extern "C" int s3d_fused_sparse_conv(const void* feats, const void* idx, const void* w,
                                     void* out, int B, int V_in, int V_out, int K, int C_in,
                                     int C_out, int is_bf16, int route, void* stream) {
  if (B == 0 || V_out == 0 || C_out == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == ROUTE_WGMMA) {
    const bool ok = is_bf16 && C_in % 32 == 0 && C_out % 8 == 0 && C_out <= 256 &&
                    K <= WG_MAXK && (((uintptr_t)feats | (uintptr_t)w | (uintptr_t)out) & 15) == 0;
    if (!ok) return (int)cudaErrorInvalidValue;
    if (C_in % 64 == 0)
      return dispatch_wgmma<64>(feats, idx, w, out, B, V_in, V_out, K, C_in, C_out, s);
    return dispatch_wgmma<32>(feats, idx, w, out, B, V_in, V_out, K, C_in, C_out, s);
  }
  if (route == ROUTE_STREAM) {
    if (C_in < 1 || C_in > 4 || C_out > 32 || K > ST_MAXK) return (int)cudaErrorInvalidValue;
    if (is_bf16)
      return dispatch_stream<__nv_bfloat16>(feats, idx, w, out, B, V_in, V_out, K, C_in, C_out, s);
    return dispatch_stream<float>(feats, idx, w, out, B, V_in, V_out, K, C_in, C_out, s);
  }
  if (route != ROUTE_FMA) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_fma<__nv_bfloat16>(feats, idx, w, out, B, V_in, V_out, K, C_in, C_out, s);
  return launch_fma<float>(feats, idx, w, out, B, V_in, V_out, K, C_in, C_out, s);
}
