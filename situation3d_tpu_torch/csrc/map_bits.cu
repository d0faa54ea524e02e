// k3 kernel map from a bit-packed occupancy grid plus prefix popcounts.
//
// Replaces the TPU kernel situation3d_tpu/ops/pallas/map_bits.py
// (_bits_kernel / k3_map_lookup_bits), INCLUDING the bounds and mask pass
// that file runs outside its kernel: the output is the finished map.
//
// Valid for levels whose voxel rows are the occupied cells in ascending flat
// order (what the dense downsample produces): then the row id of an occupied
// cell is its rank among occupied cells,
//
//   w = flat >> 5 ; bit = flat & 31
//   out[b, v, k] = pfx[b, w] + popc(bits[b, w] & ((1u << bit) - 1))
//                      if mask[b, v], the neighbour is in the extent and
//                      bit `bit` of bits[b, w] is set
//                = v_in otherwise
//
// with 1 occupancy bit per cell and one exclusive prefix popcount per 32-cell
// word. The tables are 1/16 of the int32 grid's bytes.
//
// Bound on this card: bytes. Design (map_tile.cuh): a block stages the rows
// of 64 voxels; a thread takes one (voxel, dx, dy) column, a z-run of 3
// cells, which lies in one word, or two where it crosses a word boundary:
// it reads that word and its prefix once (twice across a boundary) and
// ranks each in-extent cell with one __popc. Words are read as uint32_t, so
// bit 31 and the shift need no sign care.
#include "map_tile.cuh"

namespace {

struct BitsProbe {
  const uint32_t* __restrict__ bits;
  const int* __restrict__ pfx;
  int Wp, Y, Z, v_in;

  template <int KS>
  __device__ __forceinline__ void column(int b, int x, int y, int z0,
                                         int* dst) const {
    const int zlo = max(z0, 0), zhi = min(z0 + KS - 1, Z - 1);
    if (zlo > zhi) {            // the whole run lies outside [0, Z)
#pragma unroll
      for (int i = 0; i < KS; ++i) dst[i] = v_in;
      return;
    }
    const unsigned row = ((unsigned)x * (unsigned)Y + (unsigned)y) * (unsigned)Z;
    const long long base = (long long)b * Wp;
    const unsigned wlo = (row + zlo) >> 5, whi = (row + zhi) >> 5;
    const uint32_t word_lo = __ldg(bits + base + wlo);
    const int pfx_lo = __ldg(pfx + base + wlo);
    uint32_t word_hi = word_lo;
    int pfx_hi = pfx_lo;
    if (whi != wlo) {           // KS <= 32 cells: at most one boundary
      word_hi = __ldg(bits + base + whi);
      pfx_hi = __ldg(pfx + base + whi);
    }
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int z = z0 + i;
      int r = v_in;
      if (z >= zlo && z <= zhi) {
        const unsigned f = row + z;
        const bool lo = (f >> 5) == wlo;
        const uint32_t word = lo ? word_lo : word_hi;
        const unsigned bit = f & 31u;
        if ((word >> bit) & 1u)
          r = (lo ? pfx_lo : pfx_hi) + __popc(word & ((1u << bit) - 1u));
      }
      dst[i] = r;
    }
  }
};

__global__ void __launch_bounds__(32 * 3 * 3)
bits_map_kernel(const uint32_t* __restrict__ bits, const int* __restrict__ pfx,
                const int* __restrict__ cells, const uint8_t* __restrict__ mask,
                int* __restrict__ out, int n_vox, int V, int Wp, int X, int Y,
                int Z, int v_in) {
  const BitsProbe probe{bits, pfx, Wp, Y, Z, v_in};
  s3d_map::map_tile<3, false>(probe, cells, mask, out, nullptr, n_vox, V, X, Y,
                              v_in);
}

}  // namespace

// bits, pfx int32 [B, Wp]; cells int32 [B, V, 3]; mask uint8 [B, V];
// out int32 [B, V, 27], 16-byte aligned. B*V and X*Y*Z below 2^31.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int s3d_k3_map_lookup_bits(const void* bits, const void* pfx,
                                      const void* cells, const void* mask,
                                      void* out, int B, int V, int Wp, int X,
                                      int Y, int Z, int v_in, void* stream) {
  const long long n_vox = (long long)B * V;
  if (n_vox >= (1LL << 31) || (long long)X * Y * Z >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (n_vox == 0) return 0;
  const int blocks = (int)((n_vox + s3d_map::TILE - 1) / s3d_map::TILE);
  bits_map_kernel<<<blocks, s3d_map::block_threads<3>(), 0, (cudaStream_t)stream>>>(
      (const uint32_t*)bits, (const int*)pfx, (const int*)cells,
      (const uint8_t*)mask, (int*)out, (int)n_vox, V, Wp, X, Y, Z, v_in);
  return (int)cudaGetLastError();
}
