"""The bookkeeping of ``csrc/fused_conv.cu``'s kernels, mirrored in numpy
and held against ``fused_sparse_conv_plain`` (the kernels themselves run only
on the card, where ``chip_smoke.py`` holds them against the same plain
version): which kernel a shape takes; the wgmma kernel's per-tile list of
offsets that hit, its item order, the swizzled shared-memory address of each
gathered 16-byte chunk and of the TMA-loaded weights, and the accumulator
layout of its epilogue; the stream kernel's tiles, bulk copies and per-row
hit compaction by ballots. float32 sums, atol 1e-5: the mirrors add the same
products in the kernels' order, the plain version per offset."""
import numpy as np
import pytest
import torch

from situation3d_tpu_torch.ops.cuda import fused_conv as fc
from situation3d_tpu_torch.ops.cuda.fused_conv import (conv_route,
                                                       fused_sparse_conv_plain,
                                                       wgmma_bk)
from situation3d_tpu_torch.sparse.minkunet import build_unet_plan

torch.set_num_threads(1)
ATOL = 1e-5
B, CAPS, EXTENT = 2, (384, 192, 96, 48, 24), (32, 32, 16)


def swizzled_offset(row, chunk, row_bytes):
    """Byte offset of 16-byte chunk ``chunk`` of ``row`` in a wgmma operand
    tile (``csrc/fused_conv.cu:swizzled``): the chunk index XOR the row's
    address bits above the swizzle line (128-byte rows: ``row % 8``; 64-byte
    rows: ``(row // 2) % 4``), as TMA's 128- / 64-byte swizzle lays a tile."""
    if row_bytes == 128:
        return row * 128 + ((chunk ^ (row & 7)) << 4)
    return row * 64 + ((chunk ^ ((row >> 1) & 3)) << 4)


@pytest.fixture(scope="module")
def levels():
    r = np.random.RandomState(0)
    coords = np.zeros((B, CAPS[0], 3), np.int32)
    mask = np.zeros((B, CAPS[0]), bool)
    for b in range(B):
        c = np.unique(np.stack([r.randint(0, s, 400) for s in (24, 20, 12)], 1),
                      axis=0)[:300 - 40 * b]
        coords[b, :len(c)], mask[b, :len(c)] = c, True
    return build_unet_plan(coords, mask, CAPS, EXTENT, device="cpu")["levels"]


def test_routes_of_the_unet_classes():
    bf, f32 = torch.bfloat16, torch.float32
    assert conv_route(bf, 125, 3, 32) == conv_route(f32, 125, 3, 32) == "stream"
    for K, ci, co in [(8, 32, 32), (27, 32, 32), (8, 256, 256), (27, 256, 256),
                      (8, 256, 128), (27, 192, 128), (8, 128, 96), (27, 96, 96),
                      (27, 128, 96), (27, 64, 40)]:
        assert conv_route(bf, K, ci, co) == "wgmma", (K, ci, co)
        assert conv_route(f32, K, ci, co) == "fma"
    for K, ci, co in [(27, 48, 64), (27, 64, 36), (27, 64, 512), (64, 64, 64), (27, 5, 64)]:
        assert conv_route(bf, K, ci, co) == "fma", (K, ci, co)
    assert [wgmma_bk(c) for c in (32, 64, 96, 128, 192, 256)] == [32, 64, 32, 64, 64, 64]


@pytest.mark.parametrize("row_bytes", [128, 64])
def test_swizzle_is_a_permutation_that_spreads_a_column_over_the_banks(row_bytes):
    chunks = row_bytes // 16
    rows = 16
    offs = [[swizzled_offset(r, c, row_bytes) for c in range(chunks)] for r in range(rows)]
    flat = sorted(o for row in offs for o in row)
    assert flat == list(range(0, rows * row_bytes, 16))          # a permutation
    for r in range(rows):                                        # a row stays in its line
        assert all(r * row_bytes <= o < (r + 1) * row_bytes for o in offs[r])
    # one chunk column of the 8 rows that share 128 bytes x 8 of banks: no two
    # rows in one 16-byte bank group
    group = 8 if row_bytes == 128 else 4
    for c in range(chunks):
        banks = [(offs[r][c] % 128) // 16 for r in range(0, group)]
        if row_bytes == 128:
            assert len(set(banks)) == 8


def _unswizzle(tile, rows, row_bytes):
    """What the wgmma descriptor reads: element (r, c) of a K-major bf16
    tile at swizzled_offset(r, c // 8) + 2 * (c % 8)."""
    cols = row_bytes // 2
    out = np.zeros((rows, cols), np.float32)
    for r in range(rows):
        for c in range(cols):
            out[r, c] = tile[(swizzled_offset(r, c // 8, row_bytes) + 2 * (c % 8)) // 2]
    return out


def wgmma_mirror(feats, idx, w):
    """The wgmma kernel's arithmetic, block by block: active offsets of a
    128-row tile, items (offset, chunk) in order, A gathered chunk by chunk
    into the swizzled stage (a miss writes zeros), W^T's [BNP, BK] box by
    TMA into the same swizzle (rows past C_out zero), f32 accumulation in
    item order, the epilogue's accumulator layout, ragged rows masked."""
    Bn, V_in, C_in = feats.shape
    V_out, K = idx.shape[1], idx.shape[2]
    C_out = w.shape[2]
    BK = wgmma_bk(C_in)
    row_bytes = 2 * BK
    BNP = -(-C_out // 32) * 32
    wt = np.zeros((BNP, K * C_in), np.float32)
    wt[:C_out] = w.transpose(2, 0, 1).reshape(C_out, K * C_in)
    out = np.zeros((Bn, V_out, C_out), np.float32)
    for b in range(Bn):
        for v0 in range(0, V_out, fc.WG_BM):
            rows = min(fc.WG_BM, V_out - v0)
            tile = np.full((fc.WG_BM, K), -1, np.int64)
            t = idx[b, v0:v0 + rows].astype(np.int64)
            tile[:rows] = np.where((t >= 0) & (t < V_in), t, -1)
            active = [k for k in range(K) if (tile[:rows, k] >= 0).any()]
            acc = np.zeros((fc.WG_BM, BNP), np.float32)
            for k in active:
                for c0 in range(0, C_in, BK):
                    a_tile = np.zeros(fc.WG_BM * BK, np.float32)
                    for row in range(fc.WG_BM):
                        src = tile[row, k]
                        for chunk in range(row_bytes // 16):
                            vals = (feats[b, src, c0 + 8 * chunk:c0 + 8 * chunk + 8]
                                    if src >= 0 else np.zeros(8, np.float32))
                            o = swizzled_offset(row, chunk, row_bytes) // 2
                            a_tile[o:o + 8] = vals
                    b_tile = np.zeros(BNP * BK, np.float32)
                    for n in range(BNP):
                        for chunk in range(row_bytes // 16):
                            o = swizzled_offset(n, chunk, row_bytes) // 2
                            j = k * C_in + c0 + 8 * chunk
                            b_tile[o:o + 8] = wt[n, j:j + 8]
                    A = _unswizzle(a_tile, fc.WG_BM, row_bytes)
                    Bt = _unswizzle(b_tile, BNP, row_bytes)
                    acc += A @ Bt.T
            # epilogue: warpgroup g, warp w, lane l, 64-column fragment j,
            # n8 block q, half h -> row g*64 + w*16 + l//4 + 8h, column
            # j*64 + q*8 + (l%4)*2 (+1)
            seen = np.zeros((fc.WG_BM, BNP), int)
            for g in range(2):
                for wp in range(4):
                    for lane in range(32):
                        for h in range(2):
                            r = g * 64 + wp * 16 + lane // 4 + 8 * h
                            for c in range(lane % 4 * 2, BNP, 8):
                                seen[r, c:c + 2] += 1
                                if r < rows and c < C_out:
                                    out[b, v0 + r, c:c + 2] = acc[r, c:c + 2]
            assert (seen == 1).all()
    return out


def stream_mirror(feats, idx, w, blocks=3):
    """The stream kernel: persistent blocks over 64-row tiles of the flat
    [B * V_out] map rows (bulk copy when the tile's bytes are a multiple of
    16); a warp takes 4 rows at a time, its lanes read 4 chunks of 32 map
    entries; a ballot per chunk lists the hits in ascending k, and lane c
    adds f0*W[k,0,c] + f1*W[k,1,c] + ... over them in that order."""
    Bn, V_in, C_in = feats.shape
    V_out, K = idx.shape[1], idx.shape[2]
    C_out = w.shape[2]
    total = Bn * V_out
    flat = idx.reshape(total, K)
    out = np.zeros((total, C_out), np.float32)
    n_tiles = -(-total // 64)
    bulk = []
    for blk in range(blocks):
        for t in range(blk, n_tiles, blocks):
            g0 = t * 64
            rows = min(64, total - g0)
            bulk.append((rows * K * 4) % 16 == 0)
            for warp in range(8):
                for r0 in range(warp * 8, warp * 8 + 8, 4):
                    for row in range(r0, r0 + 4):
                        if row >= rows:
                            continue
                        g = g0 + row
                        b = g // V_out
                        acc = np.zeros(32, np.float32)
                        for ch in range(4):
                            ks = [ch * 32 + lane for lane in range(32)]
                            src = [flat[g, k] if k < K else -1 for k in ks]
                            hits = [0 <= s < V_in for s in src]
                            for j in [j for j in range(32) if hits[j]]:   # __ffs order
                                k = ch * 32 + j
                                for c in range(C_in):
                                    wk = np.zeros(32, np.float32)
                                    wk[:C_out] = w[k, c]
                                    acc = (np.float32(feats[b, src[j], c]) * wk
                                           + acc).astype(np.float32)
                        out[g] = acc[:C_out]
    return out.reshape(Bn, V_out, C_out), bulk


def _case(levels, key, lvl_map, lvl_in, c_in, c_out, seed):
    r = np.random.RandomState(seed)
    nbr = levels[lvl_map][key]
    v_in = levels[lvl_in]["mask"].shape[1]
    feats = r.randn(B, v_in, c_in).astype(np.float32) * levels[lvl_in]["mask"].numpy()[..., None]
    feats = torch.from_numpy(feats).bfloat16().float().numpy()       # bf16 values
    w = torch.from_numpy((r.randn(nbr.shape[2], c_in, c_out) / np.sqrt(nbr.shape[2] * c_in))
                         .astype(np.float32)).bfloat16().float().numpy()
    want = fused_sparse_conv_plain(torch.from_numpy(feats), nbr, torch.from_numpy(w)).numpy()
    return feats, nbr.numpy(), w, want


@pytest.mark.parametrize("key,lvl_map,lvl_in,c_in,c_out", [
    ("map_k3", 1, 1, 32, 40),        # BK = 32 (64-byte swizzle), a ragged C_out
    ("map_k3", 2, 2, 64, 64),        # BK = 64 (128-byte swizzle)
    ("map_up", 0, 1, 96, 32),        # a transposed conv: one hit among 8 columns
], ids=["k3_bk32", "k3_bk64", "transposed_k2"])
def test_wgmma_mirror_equals_plain_version(levels, key, lvl_map, lvl_in, c_in, c_out):
    feats, nbr, w, want = _case(levels, key, lvl_map, lvl_in, c_in, c_out, seed=1)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(wgmma_mirror(feats, nbr, w), want, atol=ATOL, rtol=0)


def test_stream_mirror_equals_plain_version(levels):
    feats, nbr, w, want = _case(levels, "map_k5", 0, 0, 3, 32, seed=2)
    nbr = nbr.copy()
    nbr[0, 5, :7] = -1                          # the -1 miss convention too
    want = fused_sparse_conv_plain(torch.from_numpy(feats), torch.from_numpy(nbr),
                                   torch.from_numpy(w)).numpy()
    got, bulk = stream_mirror(feats, nbr, w)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # 64 rows of 125 int32 are 32,000 bytes: every tile but a ragged last one
    # goes by one bulk copy
    n_tiles = -(-B * CAPS[0] // 64)
    assert len(bulk) == n_tiles and all(bulk[:-1])
