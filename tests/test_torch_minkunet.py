"""The port's MinkUNet (plan + sparse convs + eval batch norms: the encoder
to ``feat_bottleneck``, the decoder to ``feat_layer5`` / ``feat_layer6`` and,
under ``sparse.final_result``, to the 1x1 head's ``openscene_out``) against
the reference with its weights carried across. float32, atol 1e-4: the same
products summed in another order through up to 41 convs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation3d_tpu.sparse.minkunet import MinkUNet as JMinkUNet
from situation3d_tpu.sparse.minkunet import build_unet_plan as jax_build_unet_plan
from situation3d_tpu.sparse.tensor import SparseVoxels as JSparseVoxels
from situation3d_tpu_torch.ckpt_compat.from_jax import load_jax_variables
from situation3d_tpu_torch.ops.cuda import fused_conv
from situation3d_tpu_torch.sparse.minkunet import MinkUNet, build_unet_plan
from situation3d_tpu_torch.sparse.tensor import SparseVoxels

from torch_port_util import (randomize_variables, scene_batch, t2n, tiny_cfgs,
                             to_numpy_tree)

torch.set_num_threads(1)
ATOL = 1e-4
OUTPUTS = ("feat_bottleneck", "feat_layer5", "feat_layer6")
STRIDE = {"feat_bottleneck": 16, "feat_layer5": 8, "feat_layer6": 4, "openscene_out": 1}


def _run(extra, seed, B, n_vox):
    jcfg, tcfg = tiny_cfgs(extra)
    rng = np.random.RandomState(seed)
    b = scene_batch(rng, tcfg, B, n_vox=n_vox)
    js, ts = jcfg.sparse, tcfg.sparse

    names = OUTPUTS + (("openscene_out",) if js.final_result else ())

    def jforward(v, coords, mask, feats):
        plan = jax_build_unet_plan(
            coords, mask, js.capacities, js.dense_lookup, js.grid_extent,
            need_k5=True, dense_downsample=js.dense_downsample,
            pallas_map=js.pallas_map, pallas_map_bits=js.pallas_map_bits)
        x = JSparseVoxels(coords=coords, feats=feats, mask=mask, stride=1)
        out = JMinkUNet(js, final_result=js.final_result).apply(v, x, plan, train=False)
        return {k: (out[k].feats, out[k].coords, out[k].mask) for k in names}

    args = (jnp.asarray(b["voxel_coords"]), jnp.asarray(b["voxel_mask"]),
            jnp.asarray(b["voxel_feats"]))
    def jinit(coords, mask, feats):
        plan = jax_build_unet_plan(coords, mask, js.capacities, True,
                                   js.grid_extent, need_k5=True,
                                   dense_downsample=True)
        x = JSparseVoxels(coords=coords, feats=feats, mask=mask, stride=1)
        return JMinkUNet(js, final_result=js.final_result).init(
            jax.random.PRNGKey(0), x, plan, train=False)

    shapes = jax.eval_shape(jinit, *args)
    v = jax.tree_util.tree_map(
        lambda s: jnp.asarray((rng.randn(*s.shape) / np.sqrt(max(np.prod(s.shape[:-1]), 1))
                               ).astype(np.float32)), shapes)
    v = randomize_variables(v, rng)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jforward)(v, *args)

    net = MinkUNet(ts)
    unused = load_jax_variables(net, to_numpy_tree(v["params"]),
                                to_numpy_tree(v["batch_stats"]))
    plan = build_unet_plan(b["voxel_coords"], b["voxel_mask"], ts.capacities,
                           ts.grid_extent, pallas_map=ts.pallas_map,
                           pallas_map_bits=ts.pallas_map_bits, device="cpu")
    x = SparseVoxels(torch.from_numpy(b["voxel_coords"]),
                     torch.from_numpy(b["voxel_feats"]),
                     torch.from_numpy(b["voxel_mask"]), 1)
    fused_conv.launches = 0
    with torch.no_grad():
        got = net.eval()(x, plan)
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(v["params"]))
    return got, want, unused, (n_ref, sum(p.numel() for p in net.parameters()))


@pytest.mark.parametrize("extra,seed,B,n_vox", [
    ((), 0, 2, 300),                                 # reference on its XLA conv path
    (("sparse.pallas_map=force", "sparse.conv_flat_gather=false",
      "sparse.capacities=256,128,64,32,16"), 1, 1, 200),
    (("sparse.final_result=true", "sparse.out_channels=16"), 2, 2, 250),
], ids=["xla_convs", "pallas_interpret_maps", "final_result"])
def test_minkunet_feat_bottleneck(extra, seed, B, n_vox):
    """Every output of the UNet: the encoder's bottleneck, the decoder's two
    layers and, under ``final_result``, the 1x1 head with its bias. Second
    case: the reference builds its k3 maps with the Pallas kernel in
    interpret mode and gathers with batched ``take_along_axis``. (Its fused
    conv kernel is held against the port's plain version op by op in
    ``test_torch_sparse_conv.py``: a whole UNet of interpret-mode convs
    takes minutes to trace.)"""
    got, want, unused, (n_ref, n_port) = _run(extra, seed, B, n_vox)
    assert set(got) == set(want)
    for name, (wf, wc, wm) in want.items():
        g = got[name]
        assert g.stride == STRIDE[name] and g.feats.dtype == torch.float32, name
        np.testing.assert_array_equal(t2n(g.coords), np.asarray(wc), err_msg=name)
        np.testing.assert_array_equal(t2n(g.mask), np.asarray(wm), err_msg=name)
        assert float(np.abs(np.asarray(wf)).max()) > 1e-2, name   # not a comparison of zeros
        np.testing.assert_allclose(t2n(g.feats), np.asarray(wf), atol=ATOL, rtol=0,
                                   err_msg=name)
    assert fused_conv.launches == 0                        # CPU: plain version only
    # the converter uses every reference leaf: the port has the whole UNet
    assert unused == [] and n_port == n_ref


def test_minkunet_bottleneck_only_stops_at_the_bottleneck():
    """``bottleneck_only`` (SIG3D's scene encoder) runs the encoder alone and
    gives the same bottleneck as the whole UNet."""
    _, tcfg = tiny_cfgs(("sparse.final_result=true", "sparse.out_channels=16"))
    rng = np.random.RandomState(3)
    b = scene_batch(rng, tcfg, 1, n_vox=200)
    ts = tcfg.sparse
    net = MinkUNet(ts).eval()
    plan = build_unet_plan(b["voxel_coords"], b["voxel_mask"], ts.capacities,
                           ts.grid_extent, device="cpu")
    x = SparseVoxels(torch.from_numpy(b["voxel_coords"]),
                     torch.from_numpy(b["voxel_feats"]),
                     torch.from_numpy(b["voxel_mask"]), 1)
    with torch.no_grad():
        short = net(x, plan, bottleneck_only=True)
        whole = net(x, plan)
    assert set(short) == {"feat_bottleneck"}
    assert set(whole) == {"feat_bottleneck", "feat_layer5", "feat_layer6", "openscene_out"}
    assert torch.equal(short["feat_bottleneck"].feats, whole["feat_bottleneck"].feats)
    assert whole["openscene_out"].feats.shape == (1, ts.capacities[0], 16)


def test_minkunet_refuses_unported_options():
    """Nothing is refused any more: the sort-based plan options build the
    UNet, and in extent its outputs on their plans equal the dense plan's."""
    _, tcfg = tiny_cfgs()
    ts = tcfg.sparse
    b = scene_batch(np.random.RandomState(4), tcfg, 2, n_vox=200)
    x = SparseVoxels(torch.from_numpy(b["voxel_coords"]),
                     torch.from_numpy(b["voxel_feats"]),
                     torch.from_numpy(b["voxel_mask"]), 1)
    net = MinkUNet(ts).eval()
    with torch.no_grad():
        dense = net(x, build_unet_plan(x.coords, x.mask, ts.capacities, ts.grid_extent,
                                       device="cpu"))
        for option in ("sparse.dense_lookup=false", "sparse.dense_downsample=false"):
            _, ocfg = tiny_cfgs((option,))
            os_ = ocfg.sparse
            other = MinkUNet(os_).eval()
            other.load_state_dict(net.state_dict())
            plan = build_unet_plan(x.coords, x.mask, os_.capacities, os_.grid_extent,
                                   device="cpu", dense_lookup=os_.dense_lookup,
                                   dense_downsample=os_.dense_downsample)
            for k, v in other(x, plan).items():
                assert torch.equal(v.feats, dense[k].feats), (option, k)
