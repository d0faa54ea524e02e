"""Scene-text retrieval in the port (``eval/retrieval.py``, the ``retrieval``
task) against the JAX package: the stage-1 Q-Former at a tiny width
(2 layers at 64, 4 queries, 48-d scene features, 64 scene tokens), float32,
weights carried over by ``load_jax_variables``; 7 scenes x 7 captions so the
encode batches wrap and the rerank chunks pad.

Tolerances: scores within 1e-5 of the largest, with the same entries
reranked (the same top-k) and the same ``FILL`` elsewhere; recall metrics
exactly equal on the same matrices, ties included (the ranking is numpy's in
both).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation3d_tpu.eval import retrieval as jret
from situation3d_tpu.models import blip2_qformer as jq
from situation3d_tpu.train import tasks as jtasks
from situation3d_tpu_torch.eval import retrieval as tret
from situation3d_tpu_torch.models import blip2_qformer as tq
from situation3d_tpu_torch.train import tasks as ttasks
from torch_port_util import blip2_cfgs, load_into_port, random_variables_of

torch.set_num_threads(1)
RTOL = 1e-5
STAGE1 = ["blip2.qformer.vocab_size=96", "blip2.qformer.max_position=40", "train.bf16=false"]
K_TEST = 4


@pytest.fixture(scope="module")
def ref():
    jcfg, tcfg = blip2_cfgs(STAGE1)
    qcfg = jcfg.blip2.qformer
    rng = np.random.RandomState(11)
    n, N, L = 7, qcfg.scene_token_capacity, 9
    im = (np.arange(N)[None] < rng.randint(10, N + 1, (n, 1))).astype(np.int32)
    tm = (np.arange(L)[None] < rng.randint(2, L + 1, (n, 1))).astype(np.int32)
    data = {"image_embeds": (rng.randn(n, N, qcfg.encoder_width) * im[..., None]).astype(np.float32),
            "image_mask": im,
            "text_ids": (rng.randint(4, qcfg.vocab_size - 2, (n, L)) * tm).astype(np.int32),
            "text_mask": tm}
    jm = jq.Blip2Qformer(qcfg)
    jb = {k: jnp.asarray(v) for k, v in data.items()}
    v = random_variables_of(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                             "sample": jax.random.PRNGKey(1)}, jb), rng)
    variables = {"params": {**v["params"], "temp": jnp.asarray(np.float32(0.1))}}
    args = (data["image_embeds"], data["image_mask"], data["text_ids"], data["text_mask"])
    with jax.default_matmul_precision("highest"):
        i2t, t2i = jret.compute_sim_matrix(jm, variables, *args, k_test=K_TEST,
                                           encode_batch=4, rerank_chunk=3)
    tm_ = load_into_port(tq.Blip2Qformer(tcfg.blip2.qformer, device="cpu"), variables)
    return {"jcfg": jcfg, "tcfg": tcfg, "jm": jm, "variables": variables, "args": args,
            "i2t": i2t, "t2i": t2i, "tm": tm_}


def test_compute_sim_matrix_matches_reference(ref):
    got = tret.compute_sim_matrix(ref["tm"], *ref["args"], k_test=K_TEST, encode_batch=4,
                                  rerank_chunk=3)
    for g, w in zip(got, (ref["i2t"], ref["t2i"])):
        assert g.dtype == np.float32 and g.shape == w.shape == (7, 7)
        np.testing.assert_array_equal(g == tret.FILL, w == jret.FILL)   # the same top-k
        assert ((w != jret.FILL).sum(axis=1) == K_TEST).all()
        assert np.abs(g - w).max() <= RTOL * np.abs(w[w != jret.FILL]).max()
    # a row range of a 3-process split: other rows FILL, this range equal
    part = tret.compute_sim_matrix(ref["tm"], *ref["args"], k_test=K_TEST, encode_batch=4,
                                   rerank_chunk=3, rank=1, world=3)
    assert (part[0][:3] == tret.FILL).all() and (part[0][6:] == tret.FILL).all()
    np.testing.assert_array_equal(part[0][3:6], got[0][3:6])


def test_retrieval_metrics_equal_reference(ref):
    """On the reference's matrices, and on integer matrices full of ties."""
    img2txt = [[i, (i + 3) % 7] for i in range(7)]
    txt2img = list(range(7))
    rng = np.random.RandomState(2)
    ties = rng.randint(0, 3, (7, 7)).astype(np.float32)
    for i2t, t2i in ((ref["i2t"], ref["t2i"]), (ties, ties.T.copy())):
        assert tret.retrieval_metrics(i2t, t2i, img2txt, txt2img) == \
            jret.retrieval_metrics(i2t, t2i, img2txt, txt2img)


def test_retrieval_task_end_to_end(ref):
    """``setup_task("retrieval")`` on the CPU: its model, and its evaluation
    with the reference's weights giving the reference's metrics."""
    task = ttasks.setup_task("retrieval", ref["tcfg"], device="cpu")
    jtask = jtasks.setup_task("retrieval", ref["jcfg"])
    assert isinstance(task, ttasks.RetrievalTask) and task.k_test == jtask.k_test == 16
    model = task.build_model()
    assert isinstance(model, tq.Blip2Qformer) and model.device.type == "cpu"
    assert model.dtype == torch.float32 and model.temp.item() == pytest.approx(0.07)
    img2txt, txt2img = [[i] for i in range(7)], list(range(7))
    got = task.evaluation(ref["tm"], *ref["args"], img2txt, txt2img)
    with jax.default_matmul_precision("highest"):
        want = jtask.evaluation(ref["jm"], ref["variables"], *ref["args"], img2txt, txt2img)
    assert got == want
