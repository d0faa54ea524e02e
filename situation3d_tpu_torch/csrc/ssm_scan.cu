// Mamba-2's selective state-space recurrence, per (row, head):
//
//   S_t = exp(dt_t * A) * S_{t-1} + dt_t * x_t B_t^T      S: [P, N] float32
//   y_t = S_t C_t + D * x_t
//
// with x_t the head's P = 64 channels, B_t and C_t its group's N = 128 state
// inputs and outputs, dt_t the head's step size (0 at a pad position, which
// leaves S as it was) and A < 0, D the head's scalars.
//
//   ssm_scan_kernel    the prefill: S_0 = 0, every position of the batch's
//                      rows, the last S written to the decode state;
//   ssm_update_kernel  the decode step: one position, S read from the decode
//                      state and written back in place.
//
// Replaces no TPU kernel (the JAX package has no state-space layer); added
// for Nemotron-H's Mamba-2 mixers (ops/cuda/ssm_scan.py, whose plain
// versions are the chunked form of the same recurrence and one step of it).
// Bound on this card: bytes (4 * P * N operations a (position, head) against
// the position's x, B, C, dt and y; a decode step reads and writes the whole
// state once).
//
// Design: one block of 8 warps per (head, row). The state lives in
// registers: warp w owns rows p = 8w .. 8w + 7, lane l columns n = 4l ..
// 4l + 3, so a lane holds 8 x 4 floats and a warp's load or store of a state
// row is one 512-byte transaction. y's 8 sums over n are one reduce-scatter
// over the lanes (9 shuffles, not 8 butterflies of 5: shuffles bound a
// position's cost). The prefill walks its positions in order, staging
// SCAN_T of them (x, B, C, dt) in shared memory at a time, so every global
// load of a stage is issued at once; a position costs the block a few hundred
// cycles. At
// the lengths served here (one chunk of Mamba-2's 128 or less a row) the
// chunked matrix form would add L^2 N products and buy no parallelism the
// (head, row) grid does not already give. Nothing reads the device from the
// host: both launches can be captured in a CUDA graph.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SSM_P = 64;        // head_dim
constexpr int SSM_N = 128;       // state size
constexpr int SSM_WARPS = 8;     // 8 rows of the head each
constexpr int SSM_ROWS = SSM_P / SSM_WARPS;
constexpr int SCAN_T = 24;       // positions staged at a time

// One position: the state update, then y of this warp's 8 rows.
// x8: the warp's 8 x values; b4 / c4: this lane's 4 B / C values.
__device__ __forceinline__ void ssm_position(float (&s)[SSM_ROWS][4], const float* x8,
                                             float4 b4, float4 c4, float dt, float a,
                                             float d, float* y_row, int lane) {
  const float decay = expf(dt * a);
  const float b[4] = {b4.x, b4.y, b4.z, b4.w};
  const float c[4] = {c4.x, c4.y, c4.z, c4.w};
  float part[SSM_ROWS];
#pragma unroll
  for (int i = 0; i < SSM_ROWS; ++i) {
    const float dx = dt * x8[i];
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = s[i][j] * decay + dx * b[j];
      acc += s[i][j] * c[j];
    }
    part[i] = acc;
  }
  // reduce-scatter of the 8 sums over the 32 lanes: at each of the first
  // three steps a lane keeps half of its values and sends the other half,
  // so 4 + 2 + 1 + 2 shuffles leave lane l the whole sum of row
  // 4 (l>>4 & 1) + 2 (l>>3 & 1) + (l>>2 & 1)
  {
    const bool hi = (lane >> 4) & 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float send = hi ? part[i] : part[i + 4];
      const float keep = hi ? part[i + 4] : part[i];
      part[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
    }
  }
  {
    const bool hi = (lane >> 3) & 1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float send = hi ? part[i] : part[i + 2];
      const float keep = hi ? part[i + 2] : part[i];
      part[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
    }
  }
  {
    const bool hi = (lane >> 2) & 1;
    const float send = hi ? part[0] : part[1];
    const float keep = hi ? part[1] : part[0];
    part[0] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
  part[0] += __shfl_xor_sync(0xffffffffu, part[0], 2);
  part[0] += __shfl_xor_sync(0xffffffffu, part[0], 1);
  if ((lane & 3) == 0) {
    const int row = 4 * ((lane >> 4) & 1) + 2 * ((lane >> 3) & 1) + ((lane >> 2) & 1);
    y_row[row] = part[0] + d * x8[row];
  }
}

// xbc [B*L, conv_dim] float32: x at column h*P, B at H*P + g*N, C at
// H*P + G*N + g*N; dt [B*L, H]; y [B*L, H*P]; state [B, H, P, N].
__global__ void __launch_bounds__(SSM_WARPS * 32)
    ssm_scan_kernel(const float* __restrict__ xbc, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Dv,
                    float* __restrict__ y, float* __restrict__ state, int L, int H,
                    int G, int conv_dim) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int HP = H * SSM_P;
  __shared__ __align__(16) float sx[SCAN_T][SSM_P];
  __shared__ __align__(16) float sb[SCAN_T][SSM_N];
  __shared__ __align__(16) float sc[SCAN_T][SSM_N];
  __shared__ float sdt[SCAN_T];
  const float a = A[h], d = Dv[h];
  float s[SSM_ROWS][4];
#pragma unroll
  for (int i = 0; i < SSM_ROWS; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int t0 = 0; t0 < L; t0 += SCAN_T) {
    const int nt = min(SCAN_T, L - t0);
    __syncthreads();
    // stage: per position 16 float4 of x, 32 of B, 32 of C, and dt
    for (int q = threadIdx.x; q < nt * 80; q += blockDim.x) {
      const int t = q / 80, k = q % 80;
      const float* row = xbc + (size_t)(b * L + t0 + t) * conv_dim;
      float4 v;
      if (k < 16) {
        v = *reinterpret_cast<const float4*>(row + h * SSM_P + 4 * k);
        *reinterpret_cast<float4*>(&sx[t][4 * k]) = v;
      } else if (k < 48) {
        v = *reinterpret_cast<const float4*>(row + HP + g * SSM_N + 4 * (k - 16));
        *reinterpret_cast<float4*>(&sb[t][4 * (k - 16)]) = v;
      } else {
        v = *reinterpret_cast<const float4*>(row + HP + G * SSM_N + g * SSM_N + 4 * (k - 48));
        *reinterpret_cast<float4*>(&sc[t][4 * (k - 48)]) = v;
      }
    }
    for (int t = threadIdx.x; t < nt; t += blockDim.x)
      sdt[t] = dt[(size_t)(b * L + t0 + t) * H + h];
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      const float4 b4 = *reinterpret_cast<const float4*>(&sb[t][4 * lane]);
      const float4 c4 = *reinterpret_cast<const float4*>(&sc[t][4 * lane]);
      ssm_position(s, &sx[t][warp * SSM_ROWS], b4, c4, sdt[t], a, d,
                   y + (size_t)(b * L + t0 + t) * HP + h * SSM_P + warp * SSM_ROWS, lane);
    }
  }
  float* st = state + ((size_t)(b * H + h) * SSM_P + warp * SSM_ROWS) * SSM_N + 4 * lane;
#pragma unroll
  for (int i = 0; i < SSM_ROWS; ++i)
    *reinterpret_cast<float4*>(st + i * SSM_N) = make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
}

// xbc [B, conv_dim]; dt [B, H]; y [B, H*P]; state [B, H, P, N] in place.
__global__ void __launch_bounds__(SSM_WARPS * 32)
    ssm_update_kernel(const float* __restrict__ xbc, const float* __restrict__ dt,
                      const float* __restrict__ A, const float* __restrict__ Dv,
                      float* __restrict__ y, float* __restrict__ state, int H, int G,
                      int conv_dim) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int HP = H * SSM_P;
  const float* row = xbc + (size_t)b * conv_dim;
  float* st = state + ((size_t)(b * H + h) * SSM_P + warp * SSM_ROWS) * SSM_N + 4 * lane;
  float s[SSM_ROWS][4];
#pragma unroll
  for (int i = 0; i < SSM_ROWS; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(st + i * SSM_N);
    s[i][0] = v.x; s[i][1] = v.y; s[i][2] = v.z; s[i][3] = v.w;
  }
  float x8[SSM_ROWS];
#pragma unroll
  for (int i = 0; i < SSM_ROWS; ++i) x8[i] = row[h * SSM_P + warp * SSM_ROWS + i];
  const float4 b4 = *reinterpret_cast<const float4*>(row + HP + g * SSM_N + 4 * lane);
  const float4 c4 = *reinterpret_cast<const float4*>(row + HP + G * SSM_N + g * SSM_N + 4 * lane);
  ssm_position(s, x8, b4, c4, dt[(size_t)b * H + h], A[h], Dv[h],
               y + (size_t)b * HP + h * SSM_P + warp * SSM_ROWS, lane);
#pragma unroll
  for (int i = 0; i < SSM_ROWS; ++i)
    *reinterpret_cast<float4*>(st + i * SSM_N) = make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
}

}  // namespace

// The prefill: xbc float32 [B*L, conv_dim] (x, B, C side by side), dt
// float32 [B*L, H], A, D float32 [H], y float32 [B*L, H*64], state float32
// [B, H, 64, 128] written. head_dim 64, state size 128, H a multiple of G,
// conv_dim = H*64 + 2*G*128. Returns cudaGetLastError().
extern "C" int s3d_ssm_scan(const void* xbc, const void* dt, const void* A, const void* D,
                            void* y, void* state, int B, int L, int H, int G, int conv_dim,
                            void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 ||
      conv_dim != H * SSM_P + 2 * G * SSM_N)
    return (int)cudaErrorInvalidValue;
  ssm_scan_kernel<<<dim3(H, B), SSM_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)xbc, (const float*)dt, (const float*)A, (const float*)D, (float*)y,
      (float*)state, L, H, G, conv_dim);
  return (int)cudaGetLastError();
}

// The decode step: xbc [B, conv_dim], dt [B, H], y [B, H*64]; state read and
// written in place.
extern "C" int s3d_ssm_update(const void* xbc, const void* dt, const void* A, const void* D,
                              void* y, void* state, int B, int H, int G, int conv_dim,
                              void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || H % G != 0 || conv_dim != H * SSM_P + 2 * G * SSM_N)
    return (int)cudaErrorInvalidValue;
  ssm_update_kernel<<<dim3(H, B), SSM_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)xbc, (const float*)dt, (const float*)A, (const float*)D, (float*)y,
      (float*)state, H, G, conv_dim);
  return (int)cudaGetLastError();
}
