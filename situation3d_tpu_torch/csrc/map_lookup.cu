// Kernel map from a dense int32 level grid, for the k3 offsets (levels 2-4)
// and the k5 offsets (level 0, which also gets its k3 map in the same pass).
//
// Replaces the TPU kernel situation3d_tpu/ops/pallas/map_lookup.py
// (_lookup_kernel / k3_map_lookup_pallas), INCLUDING the bounds and mask pass
// that file runs outside its kernel: the output is the finished map; and, for
// K = 125, the reference's XLA lookup_kernel_map_dense at level 0
// (situation3d_tpu/sparse/kernel_map.py, in_stride == offset_stride == 1).
//
//   out[b, v, k] = grid[b, flat(cells[b, v] + off_k)]  if mask[b, v] and the
//                  neighbour cell lies inside [0,X) x [0,Y) x [0,Z)
//                = v_in                                otherwise
//   flat(x, y, z) = (x*Y + y)*Z + z ; off_k in kernel_offsets(KS) order.
//
// Bound on this card: bytes. Design (map_tile.cuh): a block stages the rows
// of 64 voxels; a thread reads one z-run of KS consecutive grid ints (one or
// two 32-byte sectors) for one (voxel, dx, dy) column; rows leave in 16-byte
// stores. No 64-bit division anywhere; one 32-bit division a voxel.
#include "map_tile.cuh"

namespace {

struct GridProbe {
  const int* __restrict__ grid;
  long long cells_per_sample;
  int Y, Z, v_in;

  template <int KS>
  __device__ __forceinline__ void column(int b, int x, int y, int z0,
                                         int* dst) const {
    const int* row = grid + b * cells_per_sample +
                     ((unsigned)x * (unsigned)Y + (unsigned)y) * (unsigned)Z;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int z = z0 + i;
      dst[i] = (unsigned)z < (unsigned)Z ? __ldg(row + z) : v_in;
    }
  }
};

template <int KS, bool K3_TOO>
__global__ void __launch_bounds__(32 * KS * KS)
grid_map_kernel(const int* __restrict__ grid, const int* __restrict__ cells,
                const uint8_t* __restrict__ mask, int* __restrict__ out,
                int* __restrict__ out_k3, int n_vox, int V, int X, int Y,
                int Z, int v_in) {
  const GridProbe probe{grid, (long long)X * Y * Z, Y, Z, v_in};
  s3d_map::map_tile<KS, K3_TOO>(probe, cells, mask, out, out_k3, n_vox, V, X,
                                Y, v_in);
}

template <int KS, bool K3_TOO>
void launch(const void* grid, const void* cells, const void* mask, void* out,
            void* out_k3, int n_vox, int V, int X, int Y, int Z, int v_in,
            cudaStream_t stream) {
  const int blocks = (n_vox + s3d_map::TILE - 1) / s3d_map::TILE;
  grid_map_kernel<KS, K3_TOO><<<blocks, s3d_map::block_threads<KS>(), 0, stream>>>(
      (const int*)grid, (const int*)cells, (const uint8_t*)mask, (int*)out,
      (int*)out_k3, n_vox, V, X, Y, Z, v_in);
}

}  // namespace

// grid int32 [B, X*Y*Z]; cells int32 [B, V, 3]; mask uint8 [B, V];
// out int32 [B, V, KS^3], 16-byte aligned; kernel_size 3 (out_k3 null), or 5
// with out_k3 int32 [B, V, 27], 16-byte aligned. B*V and X*Y*Z below 2^31.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int s3d_map_lookup(const void* grid, const void* cells,
                              const void* mask, void* out, void* out_k3, int B,
                              int V, int X, int Y, int Z, int kernel_size,
                              int v_in, void* stream) {
  const long long n_vox = (long long)B * V;
  if (n_vox >= (1LL << 31) || (long long)X * Y * Z >= (1LL << 31) ||
      !((kernel_size == 3 && !out_k3) || (kernel_size == 5 && out_k3)))
    return (int)cudaErrorInvalidValue;
  if (n_vox == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (kernel_size == 3)
    launch<3, false>(grid, cells, mask, out, nullptr, (int)n_vox, V, X, Y, Z, v_in, s);
  else
    launch<5, true>(grid, cells, mask, out, out_k3, (int)n_vox, V, X, Y, Z, v_in, s);
  return (int)cudaGetLastError();
}
