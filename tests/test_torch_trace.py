"""The port's spans (``utils/trace.py``): no profiler range opens while no
profiler records; the outputs of a training step, scene-cache serving and
greedy answering are bit-identical with a CPU profiler recording and
without; under the profiler each path yields its spans, nested where they
are called, with a request id on the top-level span of each batch."""
import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from situation3d_tpu_torch.config import Config, apply_overrides
from situation3d_tpu_torch.eval.serving import SceneCache
from situation3d_tpu_torch.models.blip2_t5 import Blip2T5, predict_answers
from situation3d_tpu_torch.models.sig3d import SIG3D, init_random_weights
from situation3d_tpu_torch.train.trainer import create_train_state, train_step
from situation3d_tpu_torch.utils import trace

from torch_port_util import BLIP2_TINY, TINY, blip2_batch, scene_batch, with_targets

torch.set_num_threads(1)
STEP_CHILDREN = ("sig3d.input", "sig3d.language", "sig3d.plan", "sig3d.encoder", "sig3d.pool",
                 "sig3d.fusion", "train.loss", "train.backward", "train.nan_guard",
                 "train.optimizer", "train.metrics")
MAX_LEN = 8
EOS = Config().blip2.t5.eos_token_id


@pytest.fixture(scope="module")
def sig3d():
    cfg = apply_overrides(Config(), TINY)
    rng = np.random.RandomState(0)
    model = SIG3D(cfg, 12, device="cpu")
    init_random_weights(model, 0)
    batch = with_targets(rng, scene_batch(rng, cfg, 2), 12)
    return cfg, model, batch


@pytest.fixture(scope="module")
def blip2():
    cfg = apply_overrides(Config(), BLIP2_TINY)
    model = Blip2T5(cfg.blip2, device="cpu", seed=1)
    batch = blip2_batch(np.random.RandomState(2), cfg.blip2)
    return model, batch


def _spans(prof):
    """The recorded spans as FunctionEvents, in start order."""
    return sorted((e for e in prof.events() if e.is_user_annotation
                   and not e.name.startswith(("ProfilerStep", "Optimizer."))),
                  key=lambda e: e.time_range.start)


def _parent_span(e):
    p = e.cpu_parent
    while p is not None and not (p.is_user_annotation and not p.name.startswith("Optimizer.")):
        p = p.cpu_parent
    return p


def _children(spans, top):
    return [e.name for e in spans if _parent_span(e) is top]


def _request(e):
    return e.concrete_inputs[0]


def _step(cfg, model, batch):
    """A fresh train state on a copy of ``model``; one step's metrics and
    the parameters after it."""
    m = copy.deepcopy(model)
    state = create_train_state(cfg, m, steps_per_epoch=10, seed=0)
    metrics = train_step(cfg, state, batch)
    return metrics, {n: p.detach().clone() for n, p in m.named_parameters()}


def _serve(model, batch):
    cache = SceneCache(model, device="cpu")
    scene = {k: v[:1] for k, v in batch.items() if k.startswith("voxel_")}
    cache.encode("s", scene, generator=torch.Generator().manual_seed(3))
    questions = {k: v for k, v in batch.items() if not k.startswith("voxel_")}
    return cache.answer("s", questions)


def _run(sig3d, blip2):
    """Each path once: a training step, a scene encode and its answers, an
    evaluation forward, greedy answering to ``MAX_LEN`` and to 3 tokens."""
    cfg, model, batch = sig3d
    m, b = blip2
    with torch.no_grad():
        forward = model(batch, generator=torch.Generator().manual_seed(4))
    return {"step": _step(cfg, model, batch), "serve": _serve(model, batch),
            "forward": forward,
            "predict": (predict_answers(m, b, MAX_LEN), predict_answers(m, b, 3))}


@pytest.fixture(scope="module")
def plain(sig3d, blip2):
    """The paths' outputs with no profiler, where opening a profiler range
    would raise."""
    def refuse(*a, **k):
        raise AssertionError("a profiler range opened with no profiler recording")
    with pytest.MonkeyPatch.context() as mp:
        # the optimizer's own ``record_function`` is torch's, and opens regardless
        mp.setattr(torch.autograd, "_record_function_with_args_enter", refuse)
        return _run(sig3d, blip2)


@pytest.fixture(scope="module")
def recorded(sig3d, blip2):
    """The paths' outputs and spans under one recording CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        out = _run(sig3d, blip2)
    return out, _spans(prof)


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    else:
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)


def test_no_profiler_range_opens_while_none_records(plain):
    assert trace.span("x") is trace.span("y", request=trace.BATCH)
    assert set(plain) == {"step", "serve", "forward", "predict"}


def test_outputs_are_bit_identical_under_the_profiler(plain, recorded):
    _equal(plain, recorded[0])


def test_a_train_step_yields_its_spans_nested(recorded):
    _, spans = recorded
    top, = (e for e in spans if e.name == "train.step")
    assert _request(top) == 1        # the step a fresh state takes
    names = [e.name for e in spans if e.time_range.start < top.time_range.end
             and e.time_range.end > top.time_range.start and e is not top]
    assert set(names) == set(STEP_CHILDREN) and "sig3d.forward" not in names
    assert _children(spans, top) == names
    assert all(names.count(n) == 1 for n in STEP_CHILDREN if n != "sig3d.input")
    inputs = [e for e in spans if _parent_span(e) is top and e.name == "sig3d.input"]
    assert len(inputs) in (1, 2)
    # the forward's own pass over the batch finds it on the device already
    assert all(c.name != "aten::_to_copy" for c in inputs[-1].cpu_children)
    assert names.index("train.backward") < names.index("train.optimizer")


def test_serving_and_the_forward_yield_their_spans(recorded):
    _, spans = recorded
    fwd, enc, ans = (next(e for e in spans if e.name == n)
                     for n in ("sig3d.forward", "serving.encode", "serving.answer"))
    assert set(_children(spans, fwd)) == {"sig3d.input", "sig3d.language", "sig3d.plan",
                                          "sig3d.encoder", "sig3d.pool", "sig3d.fusion"}
    assert set(_children(spans, enc)) == {"sig3d.input", "sig3d.plan", "sig3d.encoder",
                                          "sig3d.pool"}
    assert set(_children(spans, ans)) == {"sig3d.input", "sig3d.language", "sig3d.fusion"}


def test_greedy_answering_yields_one_span_a_decoded_step(recorded):
    out, spans = recorded
    tops = [e for e in spans if e.name == "blip2.predict"]
    assert len(tops) == 2
    for top, toks, max_len in zip(tops, out["predict"], (MAX_LEN, 3)):
        done = ((toks == EOS).cumsum(1) > 0).all(0)
        steps = int(done.int().argmax()) + 1 if bool(done.any()) else max_len
        want = ["blip2.qformer", "t5.encoder"] + ["t5.decode_step"] * steps
        assert _children(spans, top) == want


def test_successive_batches_carry_different_request_ids(recorded):
    _, spans = recorded
    tops = [e for e in spans if _parent_span(e) is None and e.name != "train.step"]
    assert [e.name for e in tops] == ["sig3d.forward", "serving.encode", "serving.answer",
                                      "blip2.predict", "blip2.predict"]
    ids = [_request(e) for e in tops]
    assert ids == list(range(ids[0], ids[0] + len(ids)))
