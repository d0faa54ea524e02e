"""The two kernel-map modules: plain PyTorch versions against the
reference's Pallas kernels run in interpret mode (exact), the k5 plain
version against both packages' dense lookup (exact), the bit tables against
``build_level_bits`` (exact, bit 31 included), numpy mirrors of the CUDA
kernels' work split (``csrc/map_tile.cuh`` with the grid and the bits probe)
against the plain versions, the routing rules, and the wrappers' argument
checks. The CUDA kernels themselves are held against these plain versions
on the card by ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation3d_tpu.ops.pallas import map_bits as jmb
from situation3d_tpu.ops.pallas import map_lookup as jml
from situation3d_tpu.sparse import kernel_map as jkm
from situation3d_tpu_torch.ops.cuda import map_bits as tmb
from situation3d_tpu_torch.ops.cuda import map_lookup as tml
from situation3d_tpu_torch.sparse import kernel_map as tkm

from torch_port_util import t2n

torch.set_num_threads(1)

CASES = [((64, 64, 128), 1), ((64, 64, 64), 2), ((32, 48, 32), 1)]


def _level(extent, stride, B=1, V=128, n=110, seed=7):
    """Sorted-unique voxels (ascending flat order) with the extent's corners
    and word-boundary cells (bit 0 and bit 31 of a word) occupied."""
    cells = tuple(e // stride for e in extent)
    coords = np.zeros((B, V, 3), np.int32)
    mask = np.zeros((B, V), bool)
    for b in range(B):
        r = np.random.RandomState(seed + b)
        c = np.stack([r.randint(0, cells[i], n) for i in range(3)], 1)
        c[0] = (0, 0, 0)
        c[1] = (cells[0] - 1, cells[1] - 1, cells[2] - 1)
        c[2:6] = [(3, 3, 31), (3, 3, 30), (3, 4, 0), (3, 3, 29)]
        c = np.unique(c, axis=0)
        coords[b, :len(c)], mask[b, :len(c)] = c * stride, True
    return cells, coords, mask


@pytest.mark.parametrize("extent,stride", CASES + [((16, 16, 16), 1)])
def test_k3_map_lookup_plain_matches_pallas_interpret(extent, stride):
    cells, coords, mask = _level(extent, stride)
    V = mask.shape[1]
    tc, tm = torch.from_numpy(coords), torch.from_numpy(mask)
    grid, _ = tkm.build_level_grid(tc, tm, stride, extent)
    out_cells = torch.div(tc, stride, rounding_mode="floor")
    got = tml.k3_map_lookup(grid, out_cells, tm, cells, V)    # CPU -> plain
    want = jml.k3_map_lookup_pallas(
        jnp.asarray(t2n(grid)), jnp.asarray(coords // stride), jnp.asarray(mask),
        cells, V, interpret=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(t2n(got), np.asarray(want))
    dense = tkm.lookup_kernel_map_dense(grid, V, tc, tm, tkm.kernel_offsets(3),
                                        stride, stride, extent)
    assert torch.equal(got, dense)
    assert tml.launches == 0                       # no kernel ran on the CPU


@pytest.mark.parametrize("extent,stride", CASES)
def test_build_level_bits_and_plain_lookup_match_pallas_interpret(extent, stride):
    cells, coords, mask = _level(extent, stride)
    V = mask.shape[1]
    tc, tm = torch.from_numpy(coords), torch.from_numpy(mask)
    bits, pfx = tmb.build_level_bits(tc, tm, stride, extent)
    jbits, jpfx = jax.vmap(lambda c, m: jmb.build_level_bits(c, m, stride, extent))(
        jnp.asarray(coords), jnp.asarray(mask))
    assert bits.dtype == torch.int32 and pfx.dtype == torch.int32
    np.testing.assert_array_equal(t2n(bits), np.asarray(jbits))
    np.testing.assert_array_equal(t2n(pfx), np.asarray(jpfx))
    assert (t2n(bits) < 0).any(), "bit 31 is not exercised"
    out_cells = torch.div(tc, stride, rounding_mode="floor")
    got = tmb.k3_map_lookup_bits(bits, pfx, out_cells, tm, cells, V)
    want = jmb.k3_map_lookup_bits(jbits, jpfx, jnp.asarray(coords // stride),
                                  jnp.asarray(mask), cells, V, interpret=True)
    np.testing.assert_array_equal(t2n(got), np.asarray(want))
    grid, _ = tkm.build_level_grid(tc, tm, stride, extent)
    assert torch.equal(got, tml.k3_map_lookup_plain(grid, out_cells, tm, cells, V))
    assert tmb.launches == 0


@pytest.mark.parametrize("capacity", [256, 96])               # 96 forces overflow
def test_bits_lookup_on_downsampled_level(capacity):
    """A level PRODUCED by the dense downsample (overflow included: the last
    slot holds the largest cell) satisfies rank == row id."""
    extent = (64, 64, 64)
    fine = np.random.RandomState(3).randint(0, 64, (1, 600, 3)).astype(np.int32)
    fmask = np.ones((1, 600), bool)
    fmask[:, 550:] = False
    c, m, dropped, _, _ = tkm.downsample_with_down_map(
        torch.from_numpy(fine), torch.from_numpy(fmask), 1, 2, capacity, extent)
    if capacity == 96:
        assert int(dropped) > 0
    cells = (32, 32, 32)
    bits, pfx = tmb.build_level_bits(c, m, 2, extent)
    got = tmb.k3_map_lookup_bits(bits, pfx, c // 2, m, cells, capacity)
    jc, jm = jnp.asarray(t2n(c[0])), jnp.asarray(t2n(m[0]))
    jgrid, _ = jkm.build_level_grid(jc, jm, 2, extent)
    want = jkm.lookup_kernel_map_dense(jgrid, capacity, jc, jm,
                                       jnp.asarray(jkm.kernel_offsets(3)), 2, 2, extent)
    np.testing.assert_array_equal(t2n(got[0]), np.asarray(want))


def test_degenerate_inputs():
    """All-masked batch and a single voxel: every entry is the sentinel
    except the centre of the single voxel."""
    extent, cells, V = (32, 32, 32), (32, 32, 32), 8
    coords = torch.zeros(2, V, 3, dtype=torch.int32)
    mask = torch.zeros(2, V, dtype=torch.bool)
    mask[1, 0] = True
    grid, _ = tkm.build_level_grid(coords, mask, 1, extent)
    bits, pfx = tmb.build_level_bits(coords, mask, 1, extent)
    for got in (tml.k3_map_lookup(grid, coords, mask, cells, V),
                tmb.k3_map_lookup_bits(bits, pfx, coords, mask, cells, V)):
        assert bool((got[0] == V).all())
        want = torch.full((27,), V, dtype=torch.int32)
        want[13] = 0
        assert torch.equal(got[1, 0], want) and bool((got[1, 1:] == V).all())


@pytest.mark.parametrize("cells", [(256, 256, 128), (128, 128, 64), (64, 64, 32),
                                   (32, 32, 16), (512, 512, 256), (64, 64, 48),
                                   (8, 8, 4), (160, 160, 64)])
def test_fits_rules_equal_the_reference(cells):
    n = cells[0] * cells[1] * cells[2]
    assert tml.map_lookup_fits(n, cells[2]) == jml.map_lookup_fits(n, cells[2])
    assert tmb.map_bits_fits(n, cells[2]) == jmb.map_bits_fits(n, cells[2])


def test_wrappers_check_their_arguments():
    V, cells = 4, (8, 8, 8)
    grid = torch.full((1, 512), V, dtype=torch.int32)
    c = torch.zeros(1, V, 3, dtype=torch.int32)
    m = torch.ones(1, V, dtype=torch.bool)
    with pytest.raises(TypeError):
        tml.k3_map_lookup(grid.long(), c, m, cells, V)
    with pytest.raises(ValueError):
        tml.k3_map_lookup(grid[:, :100], c, m, cells, V)
    with pytest.raises(TypeError):
        tml.k5_map_lookup(grid, c.long(), m, cells, V)
    with pytest.raises(ValueError):
        tml.k5_map_lookup(grid, c[:, :2], m, cells, V)
    bits = torch.zeros(1, 128, dtype=torch.int32)
    with pytest.raises(TypeError):
        tmb.k3_map_lookup_bits(bits, bits.long(), c, m, cells, V)
    with pytest.raises(ValueError):
        tmb.k3_map_lookup_bits(bits[:, :8], bits[:, :8], c, m, cells, V)


# ---- numpy mirrors of the CUDA kernels' work split ------------------------

TILE = 64    # csrc/map_tile.cuh: voxels a block


def _tile_mirror(ks, cells, mask, extent_cells, v_in, column, k3_too=False):
    """``csrc/map_tile.cuh`` in numpy: blocks of TILE consecutive voxels of
    the flattened [B*V]; the tile's cells and samples staged once; one task
    a (voxel, dx, dy) column, x and y bounds-checked before the probe policy
    ``column(b, x, y, z0)`` reads the z-run; the staged rows stored as one
    contiguous run (16-byte aligned); with ``k3_too`` the k3 sub-cube of
    each k5 row as a second map. Returns (map [B, V, ks^3], k3 map or None)."""
    B, V = mask.shape
    X, Y, _ = extent_cells
    R, C, K = ks // 2, ks * ks, ks ** 3
    n_vox = B * V
    flat_cells, flat_mask = cells.reshape(-1), mask.reshape(-1)
    out = np.full(n_vox * K, -7, np.int64)          # poison: all must be written
    out3 = np.full(n_vox * 27, -7, np.int64)
    for v0 in range(0, n_vox, TILE):
        nv = min(TILE, n_vox - v0)
        s_cell = [int(v) for v in flat_cells[v0 * 3:(v0 + nv) * 3]]
        s_b = np.where(flat_mask[v0:v0 + nv], (v0 + np.arange(nv)) // V, -1)
        s_out = np.full(TILE * K, -9, np.int64)
        for j in range(nv * C):
            t, c = divmod(j, C)
            x = s_cell[3 * t] + c // ks - R
            y = s_cell[3 * t + 1] + c % ks - R
            z0 = s_cell[3 * t + 2] - R
            b = s_b[t]
            ok = b >= 0 and 0 <= x < X and 0 <= y < Y
            s_out[j * ks:(j + 1) * ks] = column(b, x, y, z0, ks) if ok else v_in
        assert (v0 * K * 4) % 16 == 0                # the rows' 16-byte stores
        out[v0 * K:(v0 + nv) * K] = s_out[:nv * K]
        if k3_too:
            e = np.arange(nv * 27)
            t, k3 = e // 27, e % 27
            out3[v0 * 27:(v0 + nv) * 27] = s_out[
                t * K + 25 * (k3 // 9) + 5 * ((k3 // 3) % 3) + k3 % 3 + 31]
    assert (out != -7).all()
    return out.reshape(B, V, K), (out3.reshape(B, V, 27) if k3_too else None)


def _grid_column(grid, extent_cells, v_in):
    """``csrc/map_lookup.cu:GridProbe``: KS consecutive ints of the grid."""
    X, Y, Z = extent_cells

    def column(b, x, y, z0, ks):
        row = (x * Y + y) * Z
        return [grid[b, row + z] if 0 <= z < Z else v_in for z in range(z0, z0 + ks)]
    return column


def _bits_column(bits, pfx, extent_cells, v_in, straddles):
    """``csrc/map_bits.cu:BitsProbe``: the run's word and prefix read once,
    twice where the run crosses a word; each in-extent cell ranked by a
    popcount. Appends (bit, occupied) of every cell of a crossing run."""
    X, Y, Z = extent_cells
    words = bits.astype(np.int64) & 0xFFFFFFFF

    def column(b, x, y, z0, ks):
        zlo, zhi = max(z0, 0), min(z0 + ks - 1, Z - 1)
        if zlo > zhi:
            return [v_in] * ks
        row = (x * Y + y) * Z
        wlo, whi = (row + zlo) >> 5, (row + zhi) >> 5
        assert whi - wlo <= 1
        read = {w: (int(words[b, w]), int(pfx[b, w])) for w in (wlo, whi)}
        res = []
        for z in range(z0, z0 + ks):
            if not zlo <= z <= zhi:
                res.append(v_in)
                continue
            f = row + z
            word, base = read[f >> 5]
            bit = f & 31
            occupied = (word >> bit) & 1
            if whi != wlo:
                straddles.append((bit, bool(occupied)))
            res.append(base + bin(word & ((1 << bit) - 1)).count("1") if occupied else v_in)
        return res
    return column


def _edge_voxels(cells_ext, B=3, V=50, seed=11):
    """Unique in-extent voxels, then (sample 0) voxels at negative cells and
    beyond the extent, the extent's corners, masked rows (sample 1) and an
    all-masked sample (sample 2). B*V is no multiple of TILE, and a tile
    spans two samples."""
    X, Y, Z = cells_ext
    r = np.random.RandomState(seed)
    coords = np.zeros((B, V, 3), np.int32)
    mask = np.zeros((B, V), bool)
    odd = [[-1, 0, 0], [-2, -3, -1], [0, Y, 0], [X, Y, Z], [X + 3, 1, 1], [1, 1, -1],
           [X - 1, Y - 1, Z - 1], [0, 0, 0], [0, Y - 1, Z - 1], [X - 1, 0, 0]]
    for b in range(B):
        c = np.unique(np.stack([r.randint(1, e - 1, 3 * V) for e in cells_ext], 1), axis=0)
        r.shuffle(c)
        c = c[:V - len(odd)]
        if b == 0:
            c = np.concatenate([np.asarray(odd, np.int32), c])
        coords[b, :len(c)], mask[b, :len(c)] = c, True
    mask[1, 5:25] = False
    mask[2] = False
    return coords, mask


@pytest.mark.parametrize("ks", [3, 5])
@pytest.mark.parametrize("cells_ext", [(12, 10, 16), (7, 9, 5)])
def test_grid_kernel_mirror_equals_plain(ks, cells_ext):
    """The grid kernel's work split (k3 and k5, with the k5 route's second
    k3 map) equals the plain versions, every entry."""
    coords, mask = _edge_voxels(cells_ext)
    V = mask.shape[1]
    tc, tm = torch.from_numpy(coords), torch.from_numpy(mask)
    grid, _ = tkm.build_level_grid(tc, tm, 1, cells_ext)
    got, got3 = _tile_mirror(ks, coords, mask, cells_ext, V,
                             _grid_column(t2n(grid), cells_ext, V), k3_too=ks == 5)
    want = (tml.k3_map_lookup_plain(grid, tc, tm, cells_ext, V) if ks == 3
            else tml.k5_map_lookup_plain(grid, tc, tm, cells_ext, V)[0])
    np.testing.assert_array_equal(got, t2n(want))
    if ks == 5:
        map_k5, map_k3 = tml.k5_map_lookup(grid, tc, tm, cells_ext, V)   # CPU -> plain
        assert torch.equal(map_k5, want)
        np.testing.assert_array_equal(got3, t2n(map_k3))
        np.testing.assert_array_equal(got3, t2n(tml.k3_map_lookup_plain(
            grid, tc, tm, cells_ext, V)))
        assert tml.k5_launches == 0
    hits = (got < V).sum()
    assert 0 < hits < got.size


@pytest.mark.parametrize("extent,stride", CASES)
def test_bits_kernel_mirror_equals_plain(extent, stride):
    """The bits kernel's work split equals the plain version, every entry,
    with z-runs that cross a word at an occupied bit 31 and bit 0 (where Z
    exceeds a word), and negative, out-of-extent and masked voxels."""
    cells, coords, mask = _level(extent, stride)
    V = mask.shape[1]
    X, Y, Z = cells
    extra = np.asarray([[-1, 3, 3], [3, 3, -2], [X, 0, 0], [X - 1, Y - 1, Z], [3, 3, 32],
                        [3, 4, 31], [3, 4, 33]], np.int32) * stride
    n = int(mask[0].sum())
    coords[0, n:n + len(extra)], mask[0, n:n + len(extra)] = extra, True
    mask[0, 10:14] = False
    tc, tm = torch.from_numpy(coords), torch.from_numpy(mask)
    bits, pfx = tmb.build_level_bits(tc, tm, stride, extent)
    out_cells = torch.div(tc, stride, rounding_mode="floor")
    straddles = []
    got, _ = _tile_mirror(3, t2n(out_cells), mask, cells, V,
                          _bits_column(t2n(bits), t2n(pfx), cells, V, straddles))
    want = tmb.k3_map_lookup_bits_plain(bits, pfx, out_cells, tm, cells, V)
    np.testing.assert_array_equal(got, t2n(want))
    if Z > 32:            # at Z == 32 a column is one word: no run crosses
        assert (31, True) in straddles and (0, True) in straddles


def test_k5_plain_equals_dense_lookup():
    """The k5 route's plain version equals the port's and the reference's
    ``lookup_kernel_map_dense`` at ``in_stride == offset_stride == 1`` (the
    level-0 k5 map), out-of-extent voxels keeping their in-extent
    neighbours."""
    extent = (12, 10, 16)
    coords, mask = _edge_voxels(extent)
    V = mask.shape[1]
    tc, tm = torch.from_numpy(coords), torch.from_numpy(mask)
    grid, misses = tkm.build_level_grid(tc, tm, 1, extent)
    assert int(misses[0]) == 6
    got, _ = tml.k5_map_lookup_plain(grid, tc, tm, extent, V)
    offs = tkm.kernel_offsets(5)
    assert torch.equal(got, tkm.lookup_kernel_map_dense(grid, V, tc, tm, offs, 1, 1, extent))
    want = jax.vmap(lambda g, c, m: jkm.lookup_kernel_map_dense(
        g, V, c, m, jnp.asarray(offs), 1, 1, extent))(
        jnp.asarray(t2n(grid)), jnp.asarray(coords), jnp.asarray(mask))
    np.testing.assert_array_equal(t2n(got), np.asarray(want))
    assert bool((got[0, 0] < V).any())      # (-1, 0, 0) sees in-extent cells
