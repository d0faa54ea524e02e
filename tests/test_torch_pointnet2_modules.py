"""Every class of the port's ``models/pointnet2_modules.py`` against the
reference's flax class with the same (converted) weights and the same
numpy-seeded inputs, in evaluation and in training form.

Tolerances: float outputs within 1e-5 absolute (float32, activations of order
one, products over at most a few hundred channels); index outputs equal;
running batch statistics after one training-form call within 1e-6. The
modules that interpolate (``PointnetFPModule`` with ``known`` given, and
``PointNet2SSG`` which ends in two of them) are held to 5e-5: the expanded
form ``|a|^2 - 2ab + |b|^2`` carries an absolute rounding error of about 7e-7
in either framework (each is that far from float64), which the square root
and the inverse-distance weights of a near neighbour (d ~ 0.05) enlarge to a
few 1e-5 relative in a weight. ``PointNet2SSG`` in training form is held to
1e-3: eighteen batch norms deep, each taking batch statistics over thousands
of rows. One training-form batch norm of the reference is 4e-6 off the
float64 result on [2, 48, 64, 64] inputs (the port's 9e-7: the two sum in
another order), and each layer enlarges what it is handed by the inverse of
its channels' standard deviations; the difference reaches 3e-4 at the end."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation3d_tpu.models import pointnet2_modules as jm
from situation3d_tpu_torch.models import pointnet2_modules as tm
from situation3d_tpu_torch.models.layers import BatchNorm, Dense

from torch_port_util import (flax_apply, load_into_port, port_batch_stats,
                             port_grads_as_tree, random_variables_of, t2n,
                             to_numpy_tree)

torch.set_num_threads(1)
ATOL = 1e-5
ATOL_INTERPOLATED = 5e-5
INTERPOLATED = {"fp", "fp_no_unknown_feats", "ssg"}
ATOL_SSG_TRAIN = 1e-3
STATS_ATOL = 1e-6
B, N, C = 2, 96, 6


def _inputs(seed=0):
    r = np.random.RandomState(seed)
    xyz = (r.rand(B, N, 3) * 1.2 + 0.1).astype(np.float32)
    feats = r.randn(B, N, C).astype(np.float32)
    valid = r.rand(B, N) > 0.15
    return xyz, feats, valid


def _sa_votes(pooling, **kw):
    return (lambda: jm.PointnetSAModuleVotes(npoint=16, radius=0.4, nsample=8, mlp=(11, 16),
                                             pooling=pooling, normalize_xyz=True, **kw),
            lambda: tm.PointnetSAModuleVotes(npoint=16, radius=0.4, nsample=8, mlp=(11, 16),
                                             in_channels=C, pooling=pooling,
                                             normalize_xyz=True, **kw))


def _cases():
    xyz, feats, valid = _inputs()
    r = np.random.RandomState(1)
    xyz2 = (r.rand(B, 24, 3) * 1.2 + 0.1).astype(np.float32)
    f2 = r.randn(B, 24, 4).astype(np.float32)
    fixed = np.tile(np.arange(16, dtype=np.int32)[None] * 3, (B, 1))
    msg = dict(radii=(0.3, 0.6), nsamples=(4, 8), mlps=((7, 12), (9, 12)))
    return {
        "shared_mlp_bn": (lambda: jm.SharedMLP((8, 5)), lambda: tm.SharedMLP(C, (8, 5)),
                          (feats,), {}),
        "shared_mlp_bias": (lambda: jm.SharedMLP((8, 5), use_bn=False),
                            lambda: tm.SharedMLP(C, (8, 5), use_bn=False), (feats,), {}),
        "sa_max": (lambda: jm.PointnetSAModule(16, 0.4, 8, (9, 12)),
                   lambda: tm.PointnetSAModule(16, 0.4, 8, (9, 12), in_channels=C),
                   (xyz, feats, valid), {}),
        "sa_avg_no_feats": (lambda: jm.PointnetSAModule(16, 0.4, 8, (9, 12), pooling="avg"),
                            lambda: tm.PointnetSAModule(16, 0.4, 8, (9, 12), pooling="avg"),
                            (xyz,), {}),
        "sa_no_use_xyz": (lambda: jm.PointnetSAModule(16, 0.4, 8, (9, 12), use_xyz=False),
                          lambda: tm.PointnetSAModule(16, 0.4, 8, (9, 12), in_channels=C,
                                                      use_xyz=False), (xyz, feats), {}),
        "sa_msg": (lambda: jm.PointnetSAModuleMSG(16, **msg),
                   lambda: tm.PointnetSAModuleMSG(16, in_channels=C, **msg),
                   (xyz, feats, valid), {}),
        "votes_max": (*_sa_votes("max"), (xyz, feats), {}),
        "votes_avg": (*_sa_votes("avg"), (xyz, feats), {}),
        "votes_rbf": (*_sa_votes("rbf"), (xyz, feats), {}),
        "votes_rbf_sigma_valid": (*_sa_votes("rbf", sigma=0.3), (xyz, feats),
                                  {"valid": valid}),
        "votes_inds_passthrough": (*_sa_votes("max"), (xyz, feats), {"inds": fixed}),
        "msg_votes": (lambda: jm.PointnetSAModuleMSGVotes(16, **msg),
                      lambda: tm.PointnetSAModuleMSGVotes(16, in_channels=C, **msg),
                      (xyz, feats), {}),
        "msg_votes_inds": (lambda: jm.PointnetSAModuleMSGVotes(16, **msg),
                           lambda: tm.PointnetSAModuleMSGVotes(16, in_channels=C, **msg),
                           (xyz, feats), {"inds": fixed}),
        "lfp_msg": (lambda: jm.PointnetLFPModuleMSG(post_mlp=(20, 12), **msg),
                    lambda: tm.PointnetLFPModuleMSG(post_mlp=(20, 12), in_channels=C,
                                                    in_channels2=4, **msg),
                    (xyz2, xyz, f2, feats, valid), {}),
        "lfp_msg_no_set2_feats": (lambda: jm.PointnetLFPModuleMSG(post_mlp=(20, 12), **msg),
                                  lambda: tm.PointnetLFPModuleMSG(post_mlp=(20, 12),
                                                                  in_channels=C, **msg),
                                  (xyz2, xyz, None, feats), {}),
        "fp": (lambda: jm.PointnetFPModule((10, 7)),
               lambda: tm.PointnetFPModule((10, 7), in_channels=C + 4),
               (xyz2, xyz, f2, feats, valid), {}),
        "fp_no_unknown_feats": (lambda: jm.PointnetFPModule((10, 7)),
                                lambda: tm.PointnetFPModule((10, 7), in_channels=C),
                                (xyz2, xyz, None, feats), {}),
        "fp_known_is_none": (lambda: jm.PointnetFPModule((10, 7)),
                             lambda: tm.PointnetFPModule((10, 7), in_channels=C + 4),
                             (xyz2, None, f2, feats[:, :1]), {}),
        "ssg": (lambda: jm.PointNet2SSG(npoints=(48, 24, 12, 6)),
                lambda: tm.PointNet2SSG(npoints=(48, 24, 12, 6), in_channels=C),
                (xyz, feats, valid), {}),
    }


CASES = _cases()


def _tensors(args):
    return tuple(None if a is None else torch.from_numpy(a) for a in args)


def _jaxed(args):
    return tuple(None if a is None else jnp.asarray(a) for a in args)


def _flatten(out):
    if isinstance(out, dict):
        return [(k, out[k]) for k in sorted(out)]
    if isinstance(out, (tuple, list)):
        return [(str(i), o) for i, o in enumerate(out)]
    return [("out", out)]


def _compare(got, want, what, atol=ATOL):
    got, want = _flatten(got), _flatten(want)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        g, w = t2n(g), np.asarray(w)
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.integer):
            assert g.dtype == np.int32, (what, k, g.dtype)
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=f"{what} {k}")


def _tree_close(got, want, atol, prefix=""):
    assert set(got) == set(want), (prefix, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            _tree_close(got[k], want[k], atol, f"{prefix}{k}.")
        else:
            np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0,
                                       err_msg=prefix + k)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_module_matches_reference(name, train):
    jctor, tctor, args, kwargs = CASES[name]
    jmodel, tmodel = jctor(), tctor()
    jargs = _jaxed(args)
    jkw = {k: jnp.asarray(v) for k, v in kwargs.items()}
    variables = random_variables_of(
        lambda: jmodel.init(jax.random.PRNGKey(0), *jargs, **jkw),
        np.random.RandomState(2))
    load_into_port(tmodel, variables)
    want, want_stats = flax_apply(jmodel, variables, *jargs, train=train, **jkw)
    tkw = {k: torch.from_numpy(v) for k, v in kwargs.items()}
    with torch.no_grad():
        got = tmodel(*_tensors(args), train=train, **tkw)
    atol = ATOL_INTERPOLATED if name in INTERPOLATED else ATOL
    if name == "ssg" and train:
        atol = ATOL_SSG_TRAIN
    _compare(got, want, f"{name} train={train}", atol)
    stats = port_batch_stats(tmodel)
    before = to_numpy_tree(variables.get("batch_stats", {}))
    if train:
        _tree_close(stats, want_stats, atol / 10 if name == "ssg" else STATS_ATOL)
        if before:       # the statistics did move
            flat = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                lambda a, b: float(np.abs(a - b).max()), want_stats, before))
            assert max(flat) > 1e-4
    else:
        _tree_close(stats, before, 0.0)


@pytest.mark.parametrize("name", ["sa_max", "votes_rbf", "fp", "lfp_msg"])
def test_training_form_gradients_of_one_module(name):
    """Parameter gradients of a scalar of the module's float output, batch
    statistics in use, against ``jax.grad``: within 1e-5 of the largest
    gradient (2e-5 where the module interpolates)."""
    jctor, tctor, args, kwargs = CASES[name]
    jmodel, tmodel = jctor(), tctor()
    jargs = _jaxed(args)
    variables = random_variables_of(
        lambda: jmodel.init(jax.random.PRNGKey(0), *jargs), np.random.RandomState(4))
    load_into_port(tmodel, variables)
    pick = (lambda o: o[1]) if name in ("sa_max", "votes_rbf") else (lambda o: o)
    shape = jax.eval_shape(lambda: pick(jmodel.apply(variables, *jargs))).shape
    ct = np.random.RandomState(5).randn(*shape).astype(np.float32)

    def loss(params):
        out, _ = jmodel.apply({**variables, "params": params}, *jargs, train=True,
                              mutable=["batch_stats"])
        return jnp.sum(pick(out) * jnp.asarray(ct))
    with jax.default_matmul_precision("highest"):
        want = to_numpy_tree(jax.jit(jax.grad(loss))(variables["params"]))
    out = pick(tmodel(*_tensors(args), train=True))
    (out * torch.from_numpy(ct)).sum().backward()
    got = port_grads_as_tree(tmodel, {n: p.grad for n, p in tmodel.named_parameters()}, want)
    gmax = max(float(np.abs(v).max()) for v in jax.tree_util.tree_leaves(want))
    tol = (2e-5 if name == "fp" else 1e-5) * max(1.0, gmax)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, w, atol=tol, rtol=0), got, want)
    assert gmax > 1e-2


def test_batch_norm_is_flax_batch_norm():
    """Momentum 0.99 keeps 99% of the running value; the variance is the
    biased one, for the normalization and for the running update; statistics
    run over every axis but the last."""
    r = np.random.RandomState(3)
    x = (r.randn(3, 5, 7, 4) * 2 + 1).astype(np.float32)
    bn = BatchNorm(4)
    with torch.no_grad():
        y = bn(torch.from_numpy(x), train=True)
    flat = x.reshape(-1, 4).astype(np.float64)
    np.testing.assert_allclose(t2n(bn.mean), 0.01 * flat.mean(0), atol=1e-6)
    np.testing.assert_allclose(t2n(bn.var), 0.99 + 0.01 * flat.var(0), atol=1e-6)
    np.testing.assert_allclose(t2n(y).reshape(-1, 4),
                               (flat - flat.mean(0)) / np.sqrt(flat.var(0) + 1e-5), atol=1e-5)
    with torch.no_grad():
        z = bn(torch.from_numpy(x))                       # evaluation form: running stats
    np.testing.assert_allclose(
        t2n(z).reshape(-1, 4),
        (flat - t2n(bn.mean)) / np.sqrt(t2n(bn.var) + 1e-5), atol=1e-5)


def test_dense_without_bias_has_no_bias_key():
    with_bias, without = Dense(3, 5), Dense(3, 5, bias=False)
    assert set(with_bias.state_dict()) == {"weight", "bias"}
    assert set(without.state_dict()) == {"weight"}
    x = torch.randn(2, 3)
    assert torch.equal(without(x), x @ without.weight.T)


def test_max_pool_gradient_splits_among_ties_like_the_reference():
    """Ball query pads a group with copies of its first hit, so tied maxima
    are the normal case; the gradient is split evenly among them in both."""
    h = np.zeros((1, 2, 4, 3), np.float32)
    h[0, 0, :, 0] = [1, 1, 0, 1]
    h[0, 1, :, 1] = [2, 2, 2, 2]
    want = jax.grad(lambda a: jnp.sum(jnp.max(a, axis=2) * 3.0))(jnp.asarray(h))
    t = torch.from_numpy(h).requires_grad_()
    (got,) = torch.autograd.grad((t.amax(dim=2) * 3.0).sum(), t)
    np.testing.assert_allclose(t2n(got), np.asarray(want), atol=1e-7)
    assert t2n(got)[0, 0, :, 0].tolist() == [1.0, 1.0, 0.0, 1.0]
