"""The sparse conv's least time on its map: the larger of its operations
over the bf16 peak and its bytes over HBM bandwidth. Operations are
``2 * C_in * C_out`` per map entry that finds a voxel; bytes read each input
once (the bf16 features, the int32 map, the bf16 weights) and write the
float32 output once."""
from __future__ import annotations

from benchmarks.flops.peaks import BF16_FLOPS, HBM_BYTES_PER_S


def conv_ops(hits: int, c_in: int, c_out: int) -> float:
    return 2.0 * hits * c_in * c_out


def conv_bytes(B: int, v_in: int, v_out: int, K: int, c_in: int, c_out: int) -> float:
    return B * v_in * c_in * 2 + B * v_out * K * 4 + K * c_in * c_out * 2 + B * v_out * c_out * 4


def conv_least_s(hits: int, B: int, v_in: int, v_out: int, K: int, c_in: int, c_out: int) -> float:
    return max(conv_ops(hits, c_in, c_out) / BF16_FLOPS,
               conv_bytes(B, v_in, v_out, K, c_in, c_out) / HBM_BYTES_PER_S)
