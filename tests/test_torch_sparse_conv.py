"""The fused sparse conv's plain version and the port's conv modules against
the reference: ``fused_sparse_conv`` in interpret mode and
``sparse_conv_apply``. float32, atol 1e-5: the two sides only sum the same
products in another order. The CUDA kernel is held against the plain version
on the card by ``chip_smoke.py``."""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation3d_tpu.ops.pallas.fused_conv import fused_sparse_conv as jax_fused
from situation3d_tpu.sparse import conv as jconv
from situation3d_tpu.sparse.tensor import SparseVoxels as JSparseVoxels
from situation3d_tpu_torch.ops.cuda import fused_conv as tfc
from situation3d_tpu_torch.sparse import conv as tconv
from situation3d_tpu_torch.sparse.tensor import SparseVoxels

from torch_port_util import t2n

torch.set_num_threads(1)
ATOL = 1e-5


def _case(K, C_in, C_out, miss, seed=0, B=2, V_in=96, V_out=80):
    r = np.random.RandomState(seed)
    feats = r.randn(B, V_in, C_in).astype(np.float32)
    feats[:, 70:] = 0                                   # padding rows are zero
    idx = r.randint(0, 70, (B, V_out, K)).astype(np.int32)
    idx[r.rand(B, V_out, K) < 0.4] = V_in if miss == "v_in" else -1
    w = (r.randn(K, C_in, C_out) / np.sqrt(K * C_in)).astype(np.float32)
    return feats, idx, w


@pytest.mark.parametrize("miss", ["v_in", "minus_one"])
@pytest.mark.parametrize("C_in", [3, 32])
@pytest.mark.parametrize("K", [8, 27, 125])
def test_fused_conv_plain_matches_reference(K, C_in, miss):
    feats, idx, w = _case(K, C_in, 16, miss)
    got = tfc.fused_sparse_conv(torch.from_numpy(feats), torch.from_numpy(idx),
                                torch.from_numpy(w))      # CPU -> plain version
    assert got.dtype == torch.float32 and tfc.launches == 0
    with jax.default_matmul_precision("highest"):
        want = jconv.sparse_conv_apply(jnp.asarray(feats), jnp.asarray(idx),
                                       jnp.asarray(w))
        np.testing.assert_allclose(t2n(got), np.asarray(want), atol=ATOL, rtol=0)
        # the "+flat" gather form of the reference treats -1 like V_in too
        flat = jconv.sparse_conv_apply(jnp.asarray(feats), jnp.asarray(idx),
                                       jnp.asarray(w), pallas_gather="+flat")
        np.testing.assert_allclose(t2n(got), np.asarray(flat), atol=ATOL, rtol=0)
        if C_in == 32 and K < 125:  # the Pallas kernel declines C_in = 3
            # (and K = 125 only adds interpret-mode time)
            pal = jax_fused(jnp.asarray(feats), jnp.asarray(idx), jnp.asarray(w),
                            128, True)
            np.testing.assert_allclose(t2n(got), np.asarray(pal), atol=ATOL, rtol=0)


def test_fused_conv_bf16_inputs_accumulate_in_f32():
    feats, idx, w = _case(27, 32, 16, "v_in", seed=1)
    f16 = torch.from_numpy(feats).bfloat16()
    got = tfc.fused_sparse_conv(f16, torch.from_numpy(idx), torch.from_numpy(w))
    assert got.dtype == torch.float32
    want = tfc.fused_sparse_conv_plain(
        f16.float(), torch.from_numpy(idx), torch.from_numpy(w).bfloat16().float())
    np.testing.assert_allclose(t2n(got), t2n(want), atol=ATOL, rtol=0)
    assert tconv.sparse_conv_apply(f16, torch.from_numpy(idx),
                                   torch.from_numpy(w)).dtype == torch.bfloat16


def test_fused_conv_wrapper_checks_its_arguments():
    feats, idx, w = (torch.from_numpy(a) for a in _case(8, 4, 4, "v_in"))
    with pytest.raises(TypeError):
        tfc.fused_sparse_conv(feats, idx.long(), w)
    with pytest.raises(TypeError):
        tfc.fused_sparse_conv(feats.double(), idx, w)
    with pytest.raises(ValueError):
        tfc.fused_sparse_conv(feats, idx, w[:, :2])
    with pytest.raises(ValueError):
        tfc.fused_sparse_conv(feats[0], idx, w)


def _voxels(r, B=2, V=64, C=8):
    mask = r.rand(B, V) < 0.7
    feats = r.randn(B, V, C).astype(np.float32) * mask[..., None]
    coords = (r.randint(0, 16, (B, V, 3)) * mask[..., None]).astype(np.int32)
    return coords, feats, mask


def test_sparse_conv_module_matches_reference():
    r = np.random.RandomState(2)
    coords, feats, mask = _voxels(r)
    idx = r.randint(0, 65, (2, 64, 27)).astype(np.int32)
    w = (r.randn(27, 8, 12) / 15).astype(np.float32)
    mod = tconv.SparseConv(8, 12, 27)
    assert tuple(mod.kernel.shape) == (27, 8, 12)
    with torch.no_grad():
        mod.kernel.copy_(torch.from_numpy(w))
        x = SparseVoxels(torch.from_numpy(coords), torch.from_numpy(feats),
                         torch.from_numpy(mask), 2)
        got = mod(x, torch.from_numpy(idx), x.coords, x.mask, 2)
    jx = JSparseVoxels(jnp.asarray(coords), jnp.asarray(feats), jnp.asarray(mask), 2)
    with jax.default_matmul_precision("highest"):
        want = jconv.SparseConv(12, 27).apply(
            {"params": {"kernel": jnp.asarray(w)}}, jx, jnp.asarray(idx),
            jx.coords, jx.mask, 2)
    np.testing.assert_allclose(t2n(got.feats), np.asarray(want.feats), atol=ATOL, rtol=0)
    assert got.stride == 2 and bool((got.feats[~got.mask] == 0).all())


def test_sparse_conv1x1_matches_reference():
    r = np.random.RandomState(3)
    coords, feats, mask = _voxels(r)
    w = (r.randn(8, 12) / 3).astype(np.float32)
    mod = tconv.SparseConv1x1(8, 12)
    with torch.no_grad():
        mod.kernel.copy_(torch.from_numpy(w))
        got = mod(SparseVoxels(torch.from_numpy(coords), torch.from_numpy(feats),
                               torch.from_numpy(mask), 1))
    jx = JSparseVoxels(jnp.asarray(coords), jnp.asarray(feats), jnp.asarray(mask), 1)
    with jax.default_matmul_precision("highest"):
        want = jconv.SparseConv1x1(12).apply({"params": {"kernel": jnp.asarray(w)}}, jx)
    np.testing.assert_allclose(t2n(got.feats), np.asarray(want.feats), atol=1e-4, rtol=0)


def test_sparse_batchnorm_eval_matches_reference():
    r = np.random.RandomState(4)
    coords, feats, mask = _voxels(r)
    p = {k: r.randn(8).astype(np.float32) for k in ("scale", "bias", "mean")}
    p["var"] = (0.5 + r.rand(8)).astype(np.float32)
    mod = tconv.SparseBatchNorm(8)
    with torch.no_grad():
        for k, v in p.items():
            getattr(mod, k).copy_(torch.from_numpy(v))
        got = mod(SparseVoxels(torch.from_numpy(coords), torch.from_numpy(feats),
                               torch.from_numpy(mask), 1))
    jx = JSparseVoxels(jnp.asarray(coords), jnp.asarray(feats), jnp.asarray(mask), 1)
    want = jconv.SparseBatchNorm().apply(
        {"params": {"scale": jnp.asarray(p["scale"]), "bias": jnp.asarray(p["bias"])},
         "batch_stats": {"mean": jnp.asarray(p["mean"]), "var": jnp.asarray(p["var"])}},
        jx, use_running_average=True)
    np.testing.assert_allclose(t2n(got.feats), np.asarray(want.feats), atol=1e-4, rtol=0)
    assert bool((got.feats[~got.mask] == 0).all())
    np.testing.assert_array_equal(t2n(tconv.sparse_relu(got).feats),
                                  np.maximum(t2n(got.feats), 0))


def test_sparse_voxels_dataclass():
    r = np.random.RandomState(5)
    coords, feats, mask = (torch.from_numpy(a) for a in _voxels(r))
    x = SparseVoxels(coords, feats, mask, 4)
    assert (x.batch_size, x.capacity, x.num_channels, x.stride) == (2, 64, 8, 4)
    y = x.cat(x.replace(feats=feats * 2))
    assert y.num_channels == 16 and torch.equal(y.feats[..., 8:], feats * 2)
    with pytest.raises(ValueError):
        x.cat(x.replace(stride=2))
