"""Training-form batch norms of the port against the reference:
``SparseBatchNorm(use_running_average=False)`` (statistics of the valid
voxels of the whole batch, the two-pass biased variance, the running update
``mom * ra + (1 - mom) * batch``) and the tiny MinkUNet with
``train=True, momentum=...`` against ``MinkUNet.apply(..., train=True,
mutable=["batch_stats"])`` and ``jax.grad``. float32: outputs within 1e-5,
updated running statistics within 1e-6, gradients within 1e-4 (relative to
the largest where it is above 1: random cotangents through batch statistics
give gradients in the hundreds). The same
statistics over two ranks are held in ``tests/test_torch_parallel.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation3d_tpu.sparse.conv import SparseBatchNorm as JSparseBatchNorm
from situation3d_tpu.sparse.minkunet import MinkUNet as JMinkUNet
from situation3d_tpu.sparse.tensor import SparseVoxels as JSparseVoxels
from situation3d_tpu.train.optim import bn_momentum_schedule as jbn_momentum_schedule
from situation3d_tpu_torch.sparse.conv import SparseBatchNorm
from situation3d_tpu_torch.sparse.minkunet import MinkUNet, build_unet_plan
from situation3d_tpu_torch.sparse.tensor import SparseVoxels
from situation3d_tpu_torch.train.optim import bn_momentum_schedule

from torch_port_util import (flax_paths, load_into_port, port_batch_stats,
                             random_variables_of, scene_batch, t2n, tiny_cfgs, tree_get)

torch.set_num_threads(1)
OUT_ATOL, STATS_ATOL, GRAD_ATOL = 1e-5, 1e-6, 1e-4


def _bn_case(seed, B=3, V=40, C=5, valid=0.7):
    """Features with non-zero padding rows (the statistics must skip them)."""
    rng = np.random.RandomState(seed)
    feats = (rng.randn(B, V, C) * 2 + 1).astype(np.float32)
    mask = rng.rand(B, V) < valid
    variables = {"params": {"scale": (1 + 0.1 * rng.randn(C)).astype(np.float32),
                            "bias": (0.1 * rng.randn(C)).astype(np.float32)},
                 "batch_stats": {"mean": (0.1 * rng.randn(C)).astype(np.float32),
                                 "var": (0.5 + rng.rand(C)).astype(np.float32)}}
    R = rng.randn(B, V, C).astype(np.float32)
    return feats, mask, variables, R


def jax_batchnorm_step(feats, mask, variables, R, momentum):
    """The reference's training-form forward, updated statistics and the
    gradients of ``sum(out * R)`` in (feats, scale, bias)."""
    def loss(f, params):
        x = JSparseVoxels(coords=jnp.zeros(f.shape[:2] + (3,), jnp.int32), feats=f,
                          mask=jnp.asarray(mask), stride=1)
        out, upd = JSparseBatchNorm().apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x,
            use_running_average=False, momentum=momentum, mutable=["batch_stats"])
        return jnp.sum(out.feats * R), (out.feats, upd["batch_stats"])
    (_, (out, stats)), (gf, gp) = jax.jit(jax.value_and_grad(loss, (0, 1), has_aux=True))(
        jnp.asarray(feats), variables["params"])
    return (np.asarray(out), {k: np.asarray(v) for k, v in stats.items()}, np.asarray(gf),
            {k: np.asarray(v) for k, v in gp.items()})


def port_batchnorm(variables, C):
    bn = SparseBatchNorm(C)
    with torch.no_grad():
        for k, v in {**variables["params"], **variables["batch_stats"]}.items():
            getattr(bn, k).copy_(torch.from_numpy(v))
    return bn


@pytest.mark.parametrize("momentum,valid", [(None, 0.7), (0.7, 0.7), (0.25, 0.0)],
                         ids=["default_momentum", "momentum_0.7", "all_masked"])
def test_sparse_batchnorm_training_form(momentum, valid):
    feats, mask, variables, R = _bn_case(0, valid=valid)
    want_out, want_stats, want_gf, want_gp = jax_batchnorm_step(feats, mask, variables, R,
                                                                momentum)
    bn = port_batchnorm(variables, feats.shape[-1])
    f = torch.from_numpy(feats).requires_grad_(True)
    x = SparseVoxels(torch.zeros(*feats.shape[:2], 3, dtype=torch.int32), f,
                     torch.from_numpy(mask), 1)
    out = bn(x, use_running_average=False, momentum=momentum)
    (out.feats * torch.from_numpy(R)).sum().backward()
    np.testing.assert_allclose(t2n(out.feats), want_out, atol=OUT_ATOL, rtol=0)
    for k in ("mean", "var"):
        np.testing.assert_allclose(t2n(getattr(bn, k)), want_stats[k], atol=STATS_ATOL, rtol=0)
    np.testing.assert_allclose(t2n(f.grad), want_gf, atol=GRAD_ATOL, rtol=0)
    for k in ("scale", "bias"):
        np.testing.assert_allclose(t2n(getattr(bn, k).grad), want_gp[k], atol=GRAD_ATOL, rtol=0)
    if valid == 0.0:        # no voxel: n = 1, zero statistics; every row masked
        assert not out.feats.any()
        np.testing.assert_allclose(t2n(bn.mean), 0.25 * variables["batch_stats"]["mean"],
                                   atol=1e-7)


def test_sparse_batchnorm_is_not_torch_batchnorm():
    """The running variance is the biased one and ``momentum`` weighs the old
    value (torch's ``BatchNorm1d`` does neither); the evaluation form reads
    the running statistics and leaves them alone."""
    feats, mask, variables, _ = _bn_case(1, B=1, V=30, C=3, valid=1.0)
    bn = port_batchnorm(variables, 3)
    x = SparseVoxels(torch.zeros(1, 30, 3, dtype=torch.int32), torch.from_numpy(feats),
                     torch.from_numpy(mask), 1)
    before = bn.var.clone()
    bn(x, use_running_average=False, momentum=0.9)
    f = feats[0].astype(np.float64)
    biased = f.var(0)
    np.testing.assert_allclose(t2n(bn.var), 0.9 * t2n(before) + 0.1 * biased, rtol=1e-5)
    ref = torch.nn.BatchNorm1d(3, momentum=0.9)
    ref.running_var.copy_(before)
    ref.train()(torch.from_numpy(feats[0]))
    assert not np.allclose(t2n(ref.running_var), t2n(bn.var), rtol=1e-4)
    stats = (bn.mean.clone(), bn.var.clone())
    out = bn(x)                                            # evaluation form
    assert torch.equal(bn.mean, stats[0]) and torch.equal(bn.var, stats[1])
    want = (feats - t2n(stats[0])) / np.sqrt(t2n(stats[1]) + 1e-5) \
        * variables["params"]["scale"] + variables["params"]["bias"]
    np.testing.assert_allclose(t2n(out.feats), want * mask[..., None], atol=1e-5)


@pytest.mark.parametrize("epoch", [0, 25, 200])
def test_bn_momentum_schedule_matches_reference(epoch):
    jcfg, tcfg = tiny_cfgs()
    assert bn_momentum_schedule(tcfg.train, epoch) == pytest.approx(
        float(jbn_momentum_schedule(jcfg.train, epoch)), abs=1e-12)


# the parameters whose gradients are held against jax.grad: every level of
# the encoder and the decoder up to the loss's last output, all but the k5
# conv0 and its batch norm, so the reference's backward (a gather loop a
# conv offset) stops short of conv0 and stays within the file's time
GRAD_MODULES = ("conv1p1s2", "bn1", "block1", "conv2p2s2", "bn2", "block2",
                "conv3p4s2", "bn3", "block3", "conv4p8s2", "bn4", "block4",
                "convtr4p16s2", "bntr4", "block5", "convtr5p8s2", "bntr5", "block6")


def test_minkunet_training_form():
    """The tiny UNet in training form (every batch norm, the decoder's and
    the blocks' included) at the schedule's momentum of epoch 25: the
    bottleneck and decoder outputs and every updated running statistic, and
    the gradients of every encoder level's and the decoder's parameters up
    to ``feat_layer6`` (``GRAD_MODULES``: all but conv0 and ``bn0``) through
    their training-form batch statistics."""
    jcfg, tcfg = tiny_cfgs()
    js, ts = jcfg.sparse, tcfg.sparse
    momentum = bn_momentum_schedule(tcfg.train, 25)
    rng = np.random.RandomState(2)
    b = scene_batch(rng, tcfg, 2, n_vox=250)
    plan = build_unet_plan(b["voxel_coords"], b["voxel_mask"], ts.capacities, ts.grid_extent,
                           device="cpu")
    # the plans are bit-equal (tests/test_torch_kernel_map.py): the reference
    # runs on the port's, which spares it a compile
    jplan = jax.tree_util.tree_map(lambda t: jnp.asarray(t2n(t)), plan)
    x = JSparseVoxels(coords=jnp.asarray(b["voxel_coords"]),
                      feats=jnp.asarray(b["voxel_feats"]),
                      mask=jnp.asarray(b["voxel_mask"]), stride=1)
    jnet = JMinkUNet(js)
    v = random_variables_of(lambda: jnet.init(jax.random.PRNGKey(0), x, jplan, train=False),
                            rng)
    level = {"feat_bottleneck": (4, ts.planes[3]), "feat_layer5": (3, ts.planes[4]),
             "feat_layer6": (2, ts.planes[5])}
    R = {k: rng.randn(2, ts.capacities[i], c).astype(np.float32) for k, (i, c) in level.items()}

    def loss(sub, x, p):
        out, upd = jnet.apply({"params": {**v["params"], **sub},
                               "batch_stats": v["batch_stats"]}, x, p,
                              train=True, momentum=momentum, mutable=["batch_stats"])
        feats = {k: out[k].feats for k in level}
        return sum(jnp.sum(feats[k] * R[k]) for k in level), (feats, upd["batch_stats"])

    with jax.default_matmul_precision("highest"):
        (_, (want, want_stats)), want_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            {k: v["params"][k] for k in GRAD_MODULES}, x, jplan)

    net = load_into_port(MinkUNet(ts), v)
    xt = SparseVoxels(*(torch.from_numpy(b[k]) for k in
                        ("voxel_coords", "voxel_feats", "voxel_mask")), 1)
    out = net(xt, plan, train=True, momentum=momentum)
    sum((out[k].feats * torch.from_numpy(R[k])).sum() for k in level).backward()
    for k in level:
        np.testing.assert_allclose(t2n(out[k].feats), np.asarray(want[k]), atol=OUT_ATOL,
                                   rtol=0, err_msg=k)
    got_stats = port_batch_stats(net)
    n_stats = 0
    for path, w in jax.tree_util.tree_leaves_with_path(want_stats):
        keys = [p.key for p in path]
        np.testing.assert_allclose(tree_get(got_stats, keys), np.asarray(w), atol=STATS_ATOL,
                                   rtol=0, err_msg="/".join(keys))
        n_stats += 1
    assert n_stats == sum(1 for _ in net.named_buffers())
    paths = flax_paths(net)
    held = set()
    for name, p in net.named_parameters():
        path, transposed = paths[name]
        if path[0] not in GRAD_MODULES:
            continue
        w = np.asarray(tree_get(want_grads, path))
        g = t2n(p.grad).T if transposed else t2n(p.grad)
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL * max(1.0, float(np.abs(w).max())),
                                   rtol=0, err_msg=name)
        held.add(path[0])
    assert held == set(GRAD_MODULES)
