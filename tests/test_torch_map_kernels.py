"""The two k3-map kernel modules: plain PyTorch versions against the
reference's Pallas kernels run in interpret mode (exact), the bit tables
against ``build_level_bits`` (exact, bit 31 included), the routing rules,
and the wrappers' argument checks. The CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``."""
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
    bits = torch.zeros(1, 128, dtype=torch.int32)
    with pytest.raises(TypeError):
        tmb.k3_map_lookup_bits(bits, bits.long(), c, m, cells, V)
    with pytest.raises(ValueError):
        tmb.k3_map_lookup_bits(bits[:, :8], bits[:, :8], c, m, cells, V)
