// k3 kernel map from a dense int32 level grid.
//
// Replaces the TPU kernel situation3d_tpu/ops/pallas/map_lookup.py
// (_lookup_kernel / k3_map_lookup_pallas), INCLUDING the bounds and mask pass
// that file runs outside its kernel: the output is the finished map.
//
//   out[b, v, k] = grid[b, flat(cells[b, v] + off_k)]  if mask[b, v] and the
//                  neighbour cell lies inside [0,X) x [0,Y) x [0,Z)
//                = v_in                                otherwise
//   flat(x, y, z) = (x*Y + y)*Z + z ; off_k in kernel_offsets(3) order
//   (x slowest): k = (dx+1)*9 + (dy+1)*3 + (dz+1).
//
// Bound on this card: bytes. Each entry is one 4-byte probe of the grid and
// one 4-byte store; there is no arithmetic to speak of. Design: one thread
// per (b, v, k) with k fastest, so a warp's stores are contiguous and its 32
// probes fall into a handful of z-runs of the grid (3 consecutive cells per
// (dx, dy) column). The neighbour is bounds-checked BEFORE it is flattened:
// no divide, modulo or shift ever sees a negative coordinate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void k3_map_lookup_kernel(const int* __restrict__ grid,
                                     const int* __restrict__ cells,
                                     const uint8_t* __restrict__ mask,
                                     int* __restrict__ out,
                                     long long n_entries, int V, int X, int Y,
                                     int Z, int v_in) {
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
      long long b = bv / V;
      long long cells_per_sample = (long long)X * Y * Z;
      result = grid[b * cells_per_sample + ((long long)x * Y + y) * Z + z];
    }
  }
  out[e] = result;
}

}  // namespace

// grid int32 [B, X*Y*Z]; cells int32 [B, V, 3]; mask uint8 [B, V];
// out int32 [B, V, 27]. Returns cudaGetLastError() after the launch.
extern "C" int s3d_k3_map_lookup(const void* grid, const void* cells,
                                 const void* mask, void* out, int B, int V,
                                 int X, int Y, int Z, int v_in, void* stream) {
  long long n = (long long)B * V * 27;
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  k3_map_lookup_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)grid, (const int*)cells, (const uint8_t*)mask, (int*)out, n,
      V, X, Y, Z, v_in);
  return (int)cudaGetLastError();
}
