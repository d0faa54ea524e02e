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
// Bound on this card: bytes (two 4-byte table reads and one 4-byte store per
// entry; __popc is one instruction). Design: one thread per (b, v, k), k
// fastest, so stores are contiguous and the three z-neighbours of a column
// share one word (two at a word boundary). Words are read as uint32_t, so
// bit 31 and the shift need no sign care; the neighbour is bounds-checked
// before it is flattened, so no shift sees a negative coordinate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void k3_map_bits_kernel(const uint32_t* __restrict__ bits,
                                   const int* __restrict__ pfx,
                                   const int* __restrict__ cells,
                                   const uint8_t* __restrict__ mask,
                                   int* __restrict__ out, long long n_entries,
                                   int V, int Wp, int X, int Y, int Z,
                                   int v_in) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_entries) return;
  int k = (int)(e % 27);
  long long bv = e / 27;            // b*V + v
  int result = v_in;
  if (mask[bv]) {
    const int* c = cells + bv * 3;
    int x = c[0] + k / 9 - 1;
    int y = c[1] + (k / 3) % 3 - 1;
    int z = c[2] + k % 3 - 1;
    if (x >= 0 && x < X && y >= 0 && y < Y && z >= 0 && z < Z) {
      long long flat = ((long long)x * Y + y) * Z + z;
      long long w = (bv / V) * Wp + (flat >> 5);
      uint32_t bit = (uint32_t)(flat & 31);
      uint32_t word = bits[w];
      if ((word >> bit) & 1u)
        result = pfx[w] + __popc(word & ((1u << bit) - 1u));
    }
  }
  out[e] = result;
}

}  // namespace

// bits, pfx int32 [B, Wp]; cells int32 [B, V, 3]; mask uint8 [B, V];
// out int32 [B, V, 27]. Returns cudaGetLastError() after the launch.
extern "C" int s3d_k3_map_lookup_bits(const void* bits, const void* pfx,
                                      const void* cells, const void* mask,
                                      void* out, int B, int V, int Wp, int X,
                                      int Y, int Z, int v_in, void* stream) {
  long long n = (long long)B * V * 27;
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  k3_map_bits_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)bits, (const int*)pfx, (const int*)cells,
      (const uint8_t*)mask, (int*)out, n, V, Wp, X, Y, Z, v_in);
  return (int)cudaGetLastError();
}
