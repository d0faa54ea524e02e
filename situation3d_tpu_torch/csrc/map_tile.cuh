// The tile loop shared by the two kernel-map kernels (map_lookup.cu: dense
// int32 grid, k3 and k5; map_bits.cu: occupancy bits + prefix popcounts, k3).
//
// A map row holds K = KS^3 entries in kernel_offsets(KS) order (x slowest):
// k = c*KS + (dz + R) with column c = (dx + R)*KS + (dy + R), R = KS/2. So
// the KS entries of one (dx, dy) column are one z-run of KS neighbouring
// cells, consecutive in the grid's (x*Y + y)*Z + z order AND in the map row.
//
// Bound on an H100: bytes (the map written once, one probe per entry read).
// Work split, per block of TILE consecutive voxels of the flattened [B*V]:
//   1. the tile's cells and mask are read once, coalesced, into shared memory
//      (the sample of each voxel is found here, one 32-bit division a voxel);
//   2. one thread a (voxel, dx, dy) column: bounds of x and y checked once,
//      then the probe policy reads the z-run (KS grid ints in one or two
//      32-byte sectors, or one bit word + prefix, two where the run crosses
//      a word) and writes KS entries into the tile's staged rows;
//   3. the tile's rows are one contiguous run of the [B*V, K] map: written
//      with 16-byte stores (v0*K*4 is a multiple of 16 since TILE % 4 == 0).
// Every coordinate is bounds-checked before it is flattened (an unsigned
// compare also rejects a negative one); flat ids within a sample are 32-bit
// (the wrapper checks X*Y*Z < 2^31), the sample's base is 64-bit.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace s3d_map {

constexpr int TILE = 64;   // voxels a block; a multiple of 4 (16-byte stores)

// Threads of a block: 32 per column of the offset cube, so every thread
// takes TILE / 32 = 2 columns (288 threads for k3, 800 for k5).
template <int KS>
constexpr int block_threads() { return 32 * KS * KS; }

// Writes map rows [v0, v0 + TILE) of out [n_vox, KS^3] and, with K3_TOO (KS
// == 5), the same rows of out_k3 [n_vox, 27]: the k3 sub-cube of each k5 row.
template <int KS, bool K3_TOO, class Probe>
__device__ __forceinline__ void map_tile(const Probe& probe,
                                         const int* __restrict__ cells,
                                         const uint8_t* __restrict__ mask,
                                         int* __restrict__ out,
                                         int* __restrict__ out_k3, int n_vox,
                                         int V, int X, int Y, int v_in) {
  constexpr int R = KS / 2, C = KS * KS, K = C * KS;
  __shared__ __align__(16) int s_out[TILE * K];
  __shared__ int s_cell[TILE * 3];
  __shared__ int s_b[TILE];   // the voxel's sample, -1 when it is masked

  const int v0 = blockIdx.x * TILE;
  const int nv = min(TILE, n_vox - v0);
  const long long cell0 = (long long)v0 * 3;
  for (int i = threadIdx.x; i < nv * 3; i += blockDim.x) s_cell[i] = cells[cell0 + i];
  for (int t = threadIdx.x; t < nv; t += blockDim.x)
    s_b[t] = mask[v0 + t] ? (v0 + t) / V : -1;
  __syncthreads();

  for (int j = threadIdx.x; j < nv * C; j += blockDim.x) {
    const int t = j / C, c = j - t * C;
    const int x = s_cell[3 * t] + c / KS - R;
    const int y = s_cell[3 * t + 1] + c % KS - R;
    const int z0 = s_cell[3 * t + 2] - R;
    const int b = s_b[t];
    int* dst = s_out + j * KS;   // == t*K + c*KS: KS odd, so no bank conflict
    if (b >= 0 && (unsigned)x < (unsigned)X && (unsigned)y < (unsigned)Y) {
      probe.template column<KS>(b, x, y, z0, dst);
    } else {
#pragma unroll
      for (int i = 0; i < KS; ++i) dst[i] = v_in;
    }
  }
  __syncthreads();

  const int n = nv * K;
  int4* o4 = reinterpret_cast<int4*>(out + (long long)v0 * K);
  const int4* s4 = reinterpret_cast<const int4*>(s_out);
  for (int q = threadIdx.x; q < n / 4; q += blockDim.x) o4[q] = s4[q];
  for (int i = (n & ~3) + threadIdx.x; i < n; i += blockDim.x)
    out[(long long)v0 * K + i] = s_out[i];

  if constexpr (K3_TOO) {
    static_assert(KS == 5, "the k3 sub-map is cut from a k5 row");
    // k3 entry k3 = (a*3 + b)*3 + c (each in 0..2) sits at k5 entry
    // ((a+1)*5 + (b+1))*5 + (c+1) = 25a + 5b + c + 31
    const int n3 = nv * 27;
    int* o3 = out_k3 + (long long)v0 * 27;
    auto entry = [&](int e) {
      const int t = e / 27, k3 = e - t * 27;
      return s_out[t * K + 25 * (k3 / 9) + 5 * ((k3 / 3) % 3) + k3 % 3 + 31];
    };
    for (int q = threadIdx.x; q < n3 / 4; q += blockDim.x)
      reinterpret_cast<int4*>(o3)[q] =
          make_int4(entry(4 * q), entry(4 * q + 1), entry(4 * q + 2), entry(4 * q + 3));
    for (int i = (n3 & ~3) + threadIdx.x; i < n3; i += blockDim.x) o3[i] = entry(i);
  }
}

}  // namespace s3d_map
