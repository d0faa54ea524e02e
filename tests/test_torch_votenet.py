"""The detection slice as a whole: the port's ``VoteNet``, detection loss,
box parser and AP calculator against the reference's, with converted weights
and the same numpy-made batch (``data/synthetic.py:make_detection_arrays``).

Tolerances. Evaluation form, against the reference in float32: every float
output within 1e-4 absolute (float32 through 24 layers, values of order one),
``seed_inds`` equal; every loss term within rtol 1e-5 when both loss
functions read the SAME outputs, and within rtol 1e-4 end to end; every
parameter gradient within 1e-4 absolute, scaled by the largest gradient where
that exceeds one (measured: 5e-7).

Training form (batch statistics in 23 batch norms), against the reference run
in FLOAT64 with the same weights and inputs: outputs within 2e-4 (measured
9e-5), running statistics within 1e-5, every loss term within rtol 1e-5
(measured 1e-6), every gradient within 5e-3 of the largest gradient (measured
2.1e-3). Float64 is the yardstick there because the float32 reference is
itself farther from it than the port is: outputs 6e-4 to 9e-4, loss 6.5e-6,
gradients 4.6e-3 of the largest. One training-form batch norm of the
reference is 4e-6 off float64 in float32 (the port's 9e-7; the two sum in
another order), every layer enlarges what it is handed, and the votes, which
the network computes, then pass a sampling and a radius query. The training
form of one module, where nothing is enlarged, is held to 1e-5 against the
float32 reference by ``tests/test_torch_pointnet2_modules.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation3d_tpu.data.scannet_preprocess import ScannetDatasetConfig as JConfig
from situation3d_tpu.eval import detection as jdet
from situation3d_tpu.models.pointnet2_modules import PointnetSAModule as JSA
from situation3d_tpu.models.votenet import VoteNet as JVoteNet
from situation3d_tpu.train import detection_losses as jloss
from situation3d_tpu_torch.ckpt_compat.from_jax import load_jax_variables
from situation3d_tpu_torch.data.scannet_preprocess import ScannetDatasetConfig
from situation3d_tpu_torch.data.synthetic import (make_detection_arrays,
                                                  make_detection_batch)
from situation3d_tpu_torch.eval import detection as tdet
from situation3d_tpu_torch.models.pointnet2_modules import PointnetSAModule
from situation3d_tpu_torch.models.votenet import VoteNet
from situation3d_tpu_torch.train import detection_losses as tloss

from torch_port_util import (flax_apply, load_into_port, port_batch_stats,
                             port_grads_as_tree, random_variables_of, t2n,
                             to_numpy_tree)

torch.set_num_threads(1)
B, N, K2 = 2, 256, 4
LABELS = ["vote_label", "vote_label_mask", "center_label", "box_label_mask",
          "heading_class_label", "heading_residual_label", "size_class_label",
          "size_residual_label", "sem_cls_label"]
TOL = {False: dict(out=1e-4, loss=1e-4, grad=1e-4),
       True: dict(out=2e-4, loss=1e-5, grad=5e-3, stats=1e-5)}


def _mean_sizes():
    return (0.3 + np.random.RandomState(5).rand(18, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    msa = _mean_sizes()
    jcfg, tcfg = JConfig(msa), ScannetDatasetConfig(msa)
    arrays = make_detection_arrays(B, N, np.random.RandomState(0), mean_size_arr=msa,
                                   room=(1.6, 1.2, 0.8), max_boxes=K2, num_boxes=(2, 3))
    kw = dict(num_class=18, num_heading_bin=1, num_size_cluster=18, mean_size_arr=msa,
              num_proposal=8, backbone_npoints=(64, 32, 16, 8))
    jmodel = JVoteNet(**kw)
    tmodel = VoteNet(**kw, device="cpu")
    xyz = jnp.asarray(arrays["point_clouds"])
    variables = random_variables_of(lambda: jmodel.init(jax.random.PRNGKey(0), xyz),
                                    np.random.RandomState(1))
    load_into_port(tmodel, variables)
    return dict(jcfg=jcfg, tcfg=tcfg, arrays=arrays, jmodel=jmodel, tmodel=tmodel,
                variables=variables, xyz=xyz, kw=kw)


def _labels(arrays, as_torch):
    conv = torch.from_numpy if as_torch else jnp.asarray
    return {k: conv(arrays[k]) for k in LABELS}


def test_detection_arrays_have_the_labels_the_loss_reads(setup):
    a = setup["arrays"]
    assert a["point_clouds"].shape == (B, N, 3) and a["vote_label"].shape == (B, N, 9)
    assert set(LABELS) | {"point_clouds"} == set(a)
    on_box = a["vote_label_mask"].astype(bool)
    assert 0.2 < on_box.mean() < 0.5
    assert (a["vote_label"][~on_box] == 0).all()
    # a vote points from a box's surface to that box's centre
    target = a["point_clouds"] + a["vote_label"][..., :3]
    for b in range(B):
        centres = a["center_label"][b][a["box_label_mask"][b] > 0]
        d = np.abs(target[b][on_box[b]][:, None] - centres[None]).max(-1).min(-1)
        assert d.max() < 1e-5
    again = make_detection_arrays(B, N, np.random.RandomState(0), mean_size_arr=_mean_sizes(),
                                  room=(1.6, 1.2, 0.8), max_boxes=K2, num_boxes=(2, 3))
    assert all(np.array_equal(a[k], again[k]) for k in a)
    t = make_detection_batch(1, 64, np.random.RandomState(1), device="cpu", max_boxes=K2)
    assert t["point_clouds"].dtype == torch.float32 and t["sem_cls_label"].shape == (1, K2)


def _reference(setup, train, dtype=None):
    """Outputs, loss, loss terms, parameter gradients (and, in training form,
    updated running statistics) of the reference: by default the evaluation
    form in float32 and the training form, with the same weights and inputs,
    in float64 (``dtype=jnp.float64`` under ``jax.enable_x64``)."""
    dtype = dtype or (jnp.float64 if train else jnp.float32)
    arrays = setup["arrays"]

    def run():
        model = JVoteNet(**setup["kw"], dtype=dtype)
        cast = lambda a: (jnp.asarray(np.asarray(a), dtype)          # noqa: E731
                          if np.issubdtype(np.asarray(a).dtype, np.floating)
                          else jnp.asarray(a))
        variables = jax.tree_util.tree_map(cast, setup["variables"])
        labels = {name: cast(arrays[name]) for name in LABELS}
        xyz = cast(arrays["point_clouds"])

        def loss_fn(params):
            v = {**variables, "params": params}
            if train:
                dd, upd = model.apply(v, xyz, train=True, mutable=["batch_stats"])
            else:
                dd, upd = model.apply(v, xyz), {}
            total, parts = jloss.get_detection_loss({**dd, **labels}, setup["jcfg"])
            return total, (parts, dd, upd)

        with jax.default_matmul_precision("highest"):
            (total, (parts, dd, upd)), grads = jax.jit(
                jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
        return dict(loss=float(total), parts={n: float(v) for n, v in parts.items()},
                    grads=to_numpy_tree(grads), out=to_numpy_tree(dd),
                    stats=to_numpy_tree(upd.get("batch_stats", {})))

    if dtype == jnp.float64:
        with jax.enable_x64(True):
            return run()
    return run()


def _case(setup, train):
    """(train, reference results, the port's model after one forward +
    backward in that form, its outputs, loss and loss terms); made once."""
    if ("case", train) in setup:
        return setup[("case", train)]
    ref = _reference(setup, train)
    tmodel = VoteNet(**setup["kw"], device="cpu")
    tmodel.load_state_dict(setup["tmodel"].state_dict())
    out = tmodel(setup["arrays"]["point_clouds"], train=train)
    loss, parts = tloss.get_detection_loss({**out, **_labels(setup["arrays"], True)},
                                           setup["tcfg"])
    loss.backward()
    setup[("case", train)] = (train, ref, tmodel, out, loss, parts)
    return setup[("case", train)]


@pytest.fixture(params=[False, True], ids=["eval", "train"])
def case(request, setup):
    return _case(setup, request.param)


def test_votenet_outputs_match_reference(setup, case):
    train, ref, tmodel, got, _, _ = case
    want = ref["out"]
    assert set(got) == set(want)
    np.testing.assert_array_equal(t2n(got["seed_inds"]), want["seed_inds"])
    assert got["seed_inds"].dtype == torch.int32
    assert got["size_residuals"].shape == (B, 8, 18, 3)
    for k in sorted(want):
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_allclose(t2n(got[k]), want[k], atol=TOL[train]["out"], rtol=0,
                                   err_msg=k)
    before = setup["tmodel"].state_dict()
    moved = [n for n, b in tmodel.named_buffers()
             if n in before and not torch.equal(b, before[n])]
    assert len(moved) == (2 * 23 if train else 0), len(moved)   # every mean and var
    if train:
        stats = port_batch_stats(tmodel)
        jax.tree_util.tree_map(
            lambda g, w: np.testing.assert_allclose(g, w, atol=TOL[train]["stats"], rtol=0),
            stats, ref["stats"])


def test_loss_terms_match_on_the_same_outputs(setup):
    """The loss port alone: both read the reference's outputs. rtol 1e-5."""
    out, _ = flax_apply(setup["jmodel"], setup["variables"], setup["xyz"])
    arrays = setup["arrays"]
    with jax.default_matmul_precision("highest"):
        wt, wparts = jax.jit(lambda d: jloss.get_detection_loss(d, setup["jcfg"]))(
            {**out, **_labels(arrays, False)})
    dd = {k: torch.from_numpy(np.array(v)) for k, v in out.items()}
    gt, gparts = tloss.get_detection_loss({**dd, **_labels(arrays, True)}, setup["tcfg"])
    assert set(gparts) == set(wparts)
    np.testing.assert_allclose(float(gt), float(wt), rtol=1e-5)
    for k in wparts:
        np.testing.assert_allclose(float(gparts[k]), float(wparts[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    # the integer intermediates: objectness labels, masks and assignments
    jl, jlabel, jmask, jassign = jloss.compute_objectness_loss({**out, **_labels(arrays, False)})
    tl, tlabel, tmask, tassign = tloss.compute_objectness_loss({**dd, **_labels(arrays, True)})
    np.testing.assert_array_equal(t2n(tlabel), np.asarray(jlabel))
    np.testing.assert_array_equal(t2n(tmask), np.asarray(jmask))
    np.testing.assert_array_equal(t2n(tassign), np.asarray(jassign))
    assert float(np.asarray(jmask).sum()) > 0
    assert (tloss.FAR_THRESHOLD, tloss.NEAR_THRESHOLD, tloss.GT_VOTE_FACTOR,
            tloss.OBJECTNESS_CLS_WEIGHTS) == (jloss.FAR_THRESHOLD, jloss.NEAR_THRESHOLD,
                                              jloss.GT_VOTE_FACTOR,
                                              jloss.OBJECTNESS_CLS_WEIGHTS)


def test_loss_and_every_gradient_match_reference(case):
    train, ref, tmodel, _, gt, gparts = case
    tol = TOL[train]
    np.testing.assert_allclose(gt.item(), ref["loss"], rtol=tol["loss"])
    assert set(gparts) == set(ref["parts"])
    for k, w in ref["parts"].items():
        np.testing.assert_allclose(gparts[k].item(), w, rtol=tol["loss"],
                                   atol=tol["loss"] * 1e-2, err_msg=k)
    named = dict(tmodel.named_parameters())
    assert all(p.grad is not None for p in named.values())
    got = port_grads_as_tree(tmodel, {n: p.grad for n, p in named.items()}, ref["grads"])
    flat_w = {"/".join(str(k.key) for k in path): v
              for path, v in jax.tree_util.tree_leaves_with_path(ref["grads"])}
    flat_g = {"/".join(str(k.key) for k in path): v
              for path, v in jax.tree_util.tree_leaves_with_path(got)}
    assert len(flat_w) == len(named)
    gmax = max(float(np.abs(v).max()) for v in flat_w.values())
    assert gmax > 1e-3
    for k, w in flat_w.items():
        np.testing.assert_allclose(flat_g[k], w, atol=tol["grad"] * max(1.0, gmax), rtol=0,
                                   err_msg=k)
    zero = [k for k, v in flat_g.items() if not np.abs(v).max() > 0]
    assert zero == [k for k, v in flat_w.items() if not np.abs(v).max() > 0]


def _worst(a, b):
    return max(float(np.abs(np.asarray(x, np.float64) - y).max())
               for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))


def test_training_form_port_is_nearer_float64_than_the_float32_reference(setup):
    """Why float64 is the training form's yardstick: measured against it, the
    reference's own float32 run is farther off than the port, in the outputs,
    the loss and the gradients."""
    _, ref64, tmodel, out, loss, _ = _case(setup, True)
    ref32 = _reference(setup, True, jnp.float32)
    floats = [k for k, v in ref64["out"].items() if np.issubdtype(v.dtype, np.floating)]
    port_out = _worst([t2n(out[k]) for k in floats], [ref64["out"][k] for k in floats])
    ref_out = _worst([ref32["out"][k] for k in floats], [ref64["out"][k] for k in floats])
    grads = port_grads_as_tree(tmodel, {n: p.grad for n, p in tmodel.named_parameters()},
                               ref64["grads"])
    port_grad, ref_grad = _worst(grads, ref64["grads"]), _worst(ref32["grads"], ref64["grads"])
    port_loss = abs(loss.item() - ref64["loss"])
    ref_loss = abs(ref32["loss"] - ref64["loss"])
    assert port_out < ref_out and port_loss < ref_loss and port_grad < ref_grad, (
        port_out, ref_out, port_loss, ref_loss, port_grad, ref_grad)
    np.testing.assert_array_equal(ref32["out"]["seed_inds"], ref64["out"]["seed_inds"])


def test_parse_predictions_and_ap_match_reference(setup):
    out, _ = flax_apply(setup["jmodel"], setup["variables"], setup["xyz"])
    dd = {k: np.asarray(v) for k, v in out.items()}
    # move two proposals onto ground-truth boxes so that the AP is not trivially zero
    a = setup["arrays"]
    dd["center"] = dd["center"].copy()
    dd["size_scores"] = dd["size_scores"].copy()
    dd["size_residuals"] = dd["size_residuals"].copy()
    dd["sem_cls_scores"] = dd["sem_cls_scores"].copy()
    dd["objectness_scores"] = dd["objectness_scores"].copy()
    for b in range(B):
        for j in range(2):
            c = int(a["size_class_label"][b, j])
            dd["center"][b, j] = a["center_label"][b, j]
            dd["size_scores"][b, j, c] = 50.0
            dd["size_residuals"][b, j, c] = a["size_residual_label"][b, j]
            dd["sem_cls_scores"][b, j, c] = 50.0
            dd["objectness_scores"][b, j] = (0.0, 9.0)
    results = {}
    for name, det, cfg in (("reference", jdet, setup["jcfg"]), ("port", tdet, setup["tcfg"])):
        preds = det.parse_predictions(dd, cfg, conf_thresh=0.05)
        gts = det.parse_groundtruths(a, cfg)
        calc = det.APCalculator(0.25, cfg.class2type)
        calc.step(preds, gts)
        results[name] = (preds, gts, calc.compute_metrics())
    (jp_, jg, jm_), (tp_, tg, tm_) = results["reference"], results["port"]
    assert [len(p) for p in tp_] == [len(p) for p in jp_]
    for ps, qs in zip(tp_, jp_):
        for (c1, k1, s1), (c2, k2, s2) in zip(ps, qs):
            assert c1 == c2 and s1 == s2
            np.testing.assert_array_equal(k1, k2)
    assert tm_ == jm_
    assert 0.0 < tm_["mAP"] <= 1.0
    assert tdet.box3d_iou(tg[0][0][1], tg[0][0][1])[0] == pytest.approx(1.0)


def test_converter_fills_votenet_and_a_lone_module_and_raises(setup):
    params = to_numpy_tree(setup["variables"]["params"])
    stats = to_numpy_tree(setup["variables"]["batch_stats"])
    fresh = VoteNet(**setup["kw"], device="cpu")
    assert load_jax_variables(fresh, params, stats) == []       # no unused leaf
    for n, t in fresh.state_dict().items():
        assert torch.equal(t, setup["tmodel"].state_dict()[n]), n
    assert "backbone.sa1.mlp.conv0.weight" in fresh.state_dict()
    assert "backbone.sa1.mlp.conv0.bias" not in fresh.state_dict()
    assert "pnet.vote_aggregation.mlp.bn2.var" in fresh.state_dict()
    assert "vgen.out.bias" in fresh.state_dict()

    sa = PointnetSAModule(64, 0.2, 64, (64, 64, 128))
    assert load_jax_variables(sa, params["backbone"]["sa1"], stats["backbone"]["sa1"]) == []
    np.testing.assert_array_equal(t2n(sa.mlp.conv1.weight),
                                  params["backbone"]["sa1"]["mlp"]["conv1"]["kernel"].T)
    jsa = JSA(64, 0.2, 64, (64, 64, 128))
    want, _ = flax_apply(jsa, {"params": setup["variables"]["params"]["backbone"]["sa1"],
                               "batch_stats": setup["variables"]["batch_stats"]["backbone"]["sa1"]},
                         setup["xyz"])
    with torch.no_grad():
        got = sa(torch.from_numpy(setup["arrays"]["point_clouds"]))
    np.testing.assert_allclose(t2n(got[1]), np.asarray(want[1]), atol=1e-5)

    import copy
    missing = copy.deepcopy(stats)
    del missing["pnet"]["vote_aggregation"]["mlp"]["bn1"]["var"]
    with pytest.raises(KeyError, match="batch_stats/pnet/vote_aggregation/mlp/bn1/var"):
        load_jax_variables(VoteNet(**setup["kw"], device="cpu"), params, missing)
    wrong = copy.deepcopy(params)
    wrong["vgen"]["out"]["kernel"] = wrong["vgen"]["out"]["kernel"][:, :-1]
    with pytest.raises(ValueError, match="vgen.out.weight"):
        load_jax_variables(VoteNet(**setup["kw"], device="cpu"), wrong, stats)
    extra = copy.deepcopy(params)
    extra["backbone"]["sa1"]["mlp"]["conv0"]["bias"] = np.zeros(64, np.float32)
    assert load_jax_variables(VoteNet(**setup["kw"], device="cpu"), extra, stats) == [
        "params/backbone/sa1/mlp/conv0/bias"]

