"""The multiview path of the port (``ops/projection.py``, ``models/enet.py``)
against the reference's: ``project_points`` pixels and validity equal
(frustum, depth test, pixels on a half, a zero depth);
``multiview_backproject`` (``mean`` and ``max``, with and without depth
maps) within 1e-6 and its gradient into the feature maps within 1e-6 of
``jax.grad``; ``ENetForMultiview`` on odd image sizes (SAME padding's
(0, 1) pads) with its weights carried across: features and logits within
1e-4 in evaluation form (relative to the largest value where it is above 1:
33 residual bottlenecks of random weights reach tens), updated running
statistics within 1e-5 in training form and its features within 1e-3 of the
largest (dropout off on both sides: the frameworks' draws cannot agree)."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation3d_tpu.models import enet as jenet
from situation3d_tpu.ops import projection as jproj
from situation3d_tpu_torch.models import enet as tenet
from situation3d_tpu_torch.ops import projection as tproj
from situation3d_tpu_torch.train.optim import mask_from_predicate

from torch_port_util import load_into_port, port_batch_stats, random_variables_of, t2n

torch.set_num_threads(1)
ATOL, ENET_ATOL, STATS_ATOL = 1e-6, 1e-4, 1e-5
HW = (8, 10)
INTR = (6.0, 5.5, 4.5, 3.5)


def _scene(seed, n=300, views=3):
    """Points in front of cameras that turn about the vertical axis, depth
    maps from the nearest point a pixel (with noise), and a few special
    points: behind a camera, at zero depth, on a pixel's half."""
    rng = np.random.RandomState(seed)
    pts = (rng.rand(n, 3) * [4.0, 4.0, 2.0] - [2.0, 2.0, 0.0]).astype(np.float32)
    pts[:3] = [[0.0, 0.0, 0.0], [2.5 / 6.0, 0.25, 1.0], [0.0, -3.0, 1.0]]
    w2c = []
    for i in range(views):
        a = 0.4 * i
        R = np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]])
        m = np.eye(4)
        m[:3, :3], m[:3, 3] = R, [0.1 * i, 0.0, 2.0 if i else 0.0]
        w2c.append(m)
    w2c = np.stack(w2c).astype(np.float32)
    depths = (rng.rand(views, *HW) * 4).astype(np.float32)
    depths[:, 0, 0] = 0.0
    return pts, w2c, depths


def _j(x):
    return jnp.asarray(x)


def test_project_points_equals_reference():
    pts, w2c, depths = _scene(0)
    intr_j, intr_t = jproj.CameraIntrinsics(*INTR), tproj.CameraIntrinsics(*INTR)
    n_valid = 0
    for i in range(len(w2c)):
        for depth in (None, depths[i]):
            want = jproj.project_points(_j(pts), _j(w2c[i]), intr_j, HW,
                                        None if depth is None else _j(depth))
            got = tproj.project_points(torch.from_numpy(pts), torch.from_numpy(w2c[i]), intr_t,
                                       HW, None if depth is None else torch.from_numpy(depth))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(t2n(g), np.asarray(w))
            n_valid += int(t2n(got[1]).sum())
    assert n_valid > 50


def _multiview_inputs(seed, C=5):
    pts, w2c, depths = _scene(seed)
    rng = np.random.RandomState(seed + 1)
    feats = rng.randn(len(w2c), *HW, C).astype(np.float32)
    R = rng.randn(len(pts), C).astype(np.float32)
    # depths near the points' own depth, so some points pass the test
    return pts, w2c, depths, feats, R


@pytest.mark.parametrize("reduce", ["mean", "max"])
@pytest.mark.parametrize("use_depth", [False, True], ids=["frustum", "depth"])
def test_multiview_backproject_and_gradient(reduce, use_depth):
    pts, w2c, depths, feats, R = _multiview_inputs(1)
    intr_j, intr_t = jproj.CameraIntrinsics(*INTR), tproj.CameraIntrinsics(*INTR)
    if use_depth:       # the depth each view sees at each pixel: the nearest point, often
        z = np.stack([(np.c_[pts, np.ones(len(pts))] @ m.T)[:, 2] for m in w2c])
        pix = [np.asarray(jproj.project_points(_j(pts), _j(m), intr_j, HW)[0]) for m in w2c]
        for v in range(len(w2c)):
            order = np.argsort(-z[v])
            depths[v][pix[v][order, 0], pix[v][order, 1]] = z[v][order]
    d = depths if use_depth else None

    def jloss(f):
        out = jproj.multiview_backproject(_j(pts), f, _j(w2c), intr_j,
                                          None if d is None else _j(d), reduce)
        return jnp.sum(out * R), out
    (_, want), want_grad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(_j(feats))
    f = torch.from_numpy(feats).requires_grad_(True)
    out = tproj.multiview_backproject(torch.from_numpy(pts), f, torch.from_numpy(w2c), intr_t,
                                      None if d is None else torch.from_numpy(d), reduce)
    (out * torch.from_numpy(R)).sum().backward()
    np.testing.assert_allclose(t2n(out), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(t2n(f.grad), np.asarray(want_grad), atol=ATOL, rtol=0)
    assert (t2n(out) != 0).any(1).sum() > 20 and (t2n(f.grad) != 0).any()
    if reduce == "max":     # the clip at 0 applies to real negative features too
        assert (t2n(out) >= 0).all()


def test_backproject_features_equals_reference():
    pts, w2c, depths, feats, _ = _multiview_inputs(2)
    pix, valid = jproj.project_points(_j(pts), _j(w2c[0]), jproj.CameraIntrinsics(*INTR), HW,
                                      _j(depths[0]))
    want = jproj.backproject_features(_j(feats[0]), pix, valid)
    got = tproj.backproject_features(torch.from_numpy(feats[0]), torch.from_numpy(
        np.array(pix)), torch.from_numpy(np.array(valid)))
    np.testing.assert_array_equal(t2n(got), np.asarray(want))


# odd sizes after the first and the second halving; 176 values a channel at
# the last stages keep the training form's batch statistics well enough
# conditioned for the 1e-5 check (E[x^2] - E[x]^2 cancels; with 48 the two
# frameworks' rounding grew to 3e-5 over the 33 bottlenecks)
IMAGE = (62, 82)
TRAIN_RTOL = 1e-3       # training-form features: that rounding, 1.8e-4 measured


@pytest.fixture(scope="module")
def enet():
    rng = np.random.RandomState(3)
    images = rng.rand(2, *IMAGE, 3).astype(np.float32)
    jm = jenet.ENetForMultiview(num_classes=7)
    v = random_variables_of(lambda: jm.init(jax.random.PRNGKey(0), _j(images)), rng)
    tm = load_into_port(tenet.ENetForMultiview(num_classes=7, device="cpu"), v).eval()
    return jm, v, tm, images


def test_enet_evaluation_form_equals_reference(enet):
    jm, v, tm, images = enet
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, x: jm.apply(v, x))(v, _j(images))
    with torch.no_grad():
        got = tm(torch.from_numpy(images))
    assert got[0].shape == (2, 8, 11, 128) and got[1].shape == (2, 8, 11, 7)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert float(np.abs(w).max()) > 1e-2
        np.testing.assert_allclose(t2n(g), w, atol=ENET_ATOL * max(1.0, np.abs(w).max()),
                                   rtol=0)


def test_enet_training_form_running_statistics(enet, monkeypatch):
    """Batch statistics (flax's ``E[x^2] - E[x]^2``) and running statistics
    moved by momentum 0.99, every batch norm of the network."""
    jm, v, tm, images = enet
    dropout = fnn.Dropout
    monkeypatch.setattr(fnn, "Dropout", lambda rate: dropout(0.0))
    with jax.default_matmul_precision("highest"):
        (want, _), upd = jax.jit(lambda v, x: jm.apply(v, x, train=True,
                                                       mutable=["batch_stats"]))(v, _j(images))
    for m in tm.modules():
        if isinstance(m, tenet.Bottleneck):
            m.pdrop = 0.0
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(images), train=True)
    want = np.asarray(want)
    np.testing.assert_allclose(t2n(got), want, atol=TRAIN_RTOL * np.abs(want).max(), rtol=0)
    got_stats = port_batch_stats(tm)
    n = 0
    for path, w in jax.tree_util.tree_leaves_with_path(upd["batch_stats"]):
        node = got_stats
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(w), atol=STATS_ATOL, rtol=0)
        n += 1
    assert n == sum(1 for _ in tm.buffers()) == 2 * (1 + 3 * 22)    # initial + 22 bottlenecks


def test_enet_parts_and_trainable_split():
    """The trunk / tail / classifier split as the optimizer's mask, the
    element-wise dropout of training, the SAME pads."""
    tm = tenet.ENetForMultiview(device="cpu")
    same, other = (tenet.ENetForMultiview(device="cpu", seed=s) for s in (0, 1))
    k = tm.trainable.bottleneck3_0.Conv_1.kernel
    assert torch.equal(k, same.trainable.bottleneck3_0.Conv_1.kernel)
    assert not torch.equal(k, other.trainable.bottleneck3_0.Conv_1.kernel)
    assert tm.fixed.initial.PReLU_0.negative_slope.item() == pytest.approx(0.01)
    assert torch.equal(tm.fixed.initial.BatchNorm_0.var, torch.ones(16))
    mask = mask_from_predicate(tm, tenet.enet_trainable_paths)
    assert all(not v for n, v in mask.items() if n.startswith("fixed."))
    assert all(v for n, v in mask.items() if not n.startswith("fixed."))
    assert tenet.enet_trainable_paths(("fixed", "x")) == jenet.enet_trainable_paths(("fixed",
                                                                                   "x"))
    x = torch.zeros(1, 5, 6, 2)
    assert tenet._same_pads(x, (3, 3), (2, 2)) == (0, 0, 0, 1, 1, 1)
    assert tenet._same_pads(x, (2, 2), (2, 2)) == (0, 0, 0, 0, 0, 1)
    assert tenet._same_pads(x, (3, 3), (1, 1), (4, 4)) == (0, 0, 4, 4, 4, 4)
    b = tenet.Bottleneck(8, 8, pdrop=0.5).train()
    h = torch.randn(1, 6, 6, 8)
    with torch.no_grad():
        a1 = b(h, train=True, generator=torch.Generator().manual_seed(1))
        a2 = b(h, train=True, generator=torch.Generator().manual_seed(2))
    assert not torch.equal(a1, a2)


def test_enet_conversion_raises_on_a_missing_or_misshapen_leaf(enet):
    """``load_jax_variables`` on ENet's leaves (HWIO kernels, the PReLU
    slope, flax batch norms) still raises on a missing leaf and on a shape
    mismatch."""
    from situation3d_tpu_torch.ckpt_compat.from_jax import load_jax_variables
    from torch_port_util import to_numpy_tree
    _, v, _, _ = enet
    params, stats = to_numpy_tree(v["params"]), to_numpy_tree(v["batch_stats"])
    block = params["trainable"]["bottleneck3_2"]
    slope = block["PReLU_1"].pop("negative_slope")
    with pytest.raises(KeyError, match="PReLU_1/negative_slope"):
        load_jax_variables(tenet.ENetForMultiview(num_classes=7, device="cpu"), params, stats)
    block["PReLU_1"]["negative_slope"] = slope
    block["Conv_1"]["kernel"] = block["Conv_1"]["kernel"].transpose(3, 2, 0, 1)   # OIHW
    with pytest.raises(ValueError, match="shape mismatch"):
        load_jax_variables(tenet.ENetForMultiview(num_classes=7, device="cpu"), params, stats)
