"""BLIP-2 stage 1 in the port (``train/contrastive.py``,
``models/blip2_qformer.py``, ``data/threedvqa.py:stage1_batches``, ``cli.train
--task stage1``) against the JAX package at a tiny width (Q-Former 2 layers
at 64 with 4 queries, 48-d scene features, 64 scene tokens, vocabulary 96),
float32, weights carried over by ``load_jax_variables``; the JAX side under
``jax.jit`` at full float32 matmul precision, its hard-negative draws (the
Gumbel noise of ``jax.random.categorical``) injected into the port.

Tolerances: the four losses within 1e-5 (relative); every gradient within
1e-4 of the tensor's largest value, or 1e-7 where that is smaller (a
self-attention key bias's gradient is zero in exact arithmetic, float32
noise in both); the ITM / ITC heads within 1e-5 of their largest value;
batches and the ``.npz`` keys equal.
"""
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation3d_tpu.data import threedvqa as jdata
from situation3d_tpu.models import blip2_qformer as jq
from situation3d_tpu.train import contrastive as jc
from situation3d_tpu_torch.cli import train as cli_train
from situation3d_tpu_torch.data import threedvqa as tdata
from situation3d_tpu_torch.models import blip2_qformer as tq
from situation3d_tpu_torch.train import contrastive as tc
from situation3d_tpu_torch.ckpt_compat.from_jax import reference_paths
from torch_port_util import (BLIP2_TINY, blip2_cfgs, load_into_port,
                             random_variables_of, t2n, tree_get)

torch.set_num_threads(1)
LOSS_RTOL = 1e-5
RTOL = 1e-4
STAGE1 = ["blip2.qformer.vocab_size=96", "blip2.qformer.max_position=40", "train.bf16=false"]


def _jit(fn, *args):
    with jax.default_matmul_precision("highest"):
        return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(*args))


def _close(got, want, rtol, what="", atol=0.0):
    err, scale = np.abs(np.asarray(got) - want).max(), np.abs(want).max()
    assert err <= max(rtol * scale, atol), (what, err, scale)


def stage1_batch(rng, qcfg, B=4, L=10):
    """Scenes of several lengths (the rest masked), captions of several
    lengths (pad 0), ids below the two reserved top ids."""
    N, W = qcfg.scene_token_capacity, qcfg.encoder_width
    n_img, n_txt = [64, 40, 23, 51][:B], [10, 6, 3, 8][:B]
    im = (np.arange(N)[None] < np.array(n_img)[:, None]).astype(np.int32)
    tm = (np.arange(L)[None] < np.array(n_txt)[:, None]).astype(np.int32)
    return {"image_embeds": (rng.randn(B, N, W) * im[..., None]).astype(np.float32),
            "image_mask": im,
            "text_ids": (rng.randint(4, qcfg.vocab_size - 2, (B, L)) * tm).astype(np.int32),
            "text_mask": tm}


@pytest.fixture(scope="module")
def ref():
    jcfg, tcfg = blip2_cfgs(STAGE1)
    qcfg = jcfg.blip2.qformer
    rng = np.random.RandomState(0)
    batch = stage1_batch(rng, qcfg)
    jb = {k: jnp.asarray(x) for k, x in batch.items()}     # the model indexes its inputs
    jm = jq.Blip2Qformer(qcfg)
    v = random_variables_of(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                             "sample": jax.random.PRNGKey(1)}, jb), rng)
    params = {**v["params"], "temp": jnp.asarray(np.float32(0.1))}
    key = jax.random.PRNGKey(5)
    # the Gumbel noise behind the model's two categorical draws
    sample = fnn.apply(lambda m: m.make_rng("sample"), jm)({"params": params},
                                                            rngs={"sample": key})
    r1, r2 = jax.random.split(sample)
    B = batch["text_ids"].shape[0]
    gumbel = tuple(np.array(jax.random.gumbel(r, (B, B))) for r in (r1, r2))

    def loss_fn(p):
        out = jm.apply({"params": p}, jb, train=True, rngs={"sample": key})
        return out["loss"], out

    jitm = jq.Blip2ITM(qcfg)
    ((_, out), grads), heads = _jit(lambda p: (
        jax.value_and_grad(loss_fn, has_aux=True)(p),
        {h: jitm.apply({"params": p}, jb, match_head=h) for h in ("itm", "itc")}), params)
    return {"jcfg": jcfg, "tcfg": tcfg, "batch": batch, "params": params, "out": out,
            "grads": grads, "gumbel": gumbel, "heads": heads}


def _port(ref, cls=tq.Blip2Qformer):
    m = cls(ref["tcfg"].blip2.qformer, device="cpu")
    return load_into_port(m, {"params": ref["params"]})


def test_contrastive_losses_match_reference():
    rng = np.random.RandomState(3)
    img, img2 = rng.randn(5, 4, 16).astype(np.float32), rng.randn(5, 16).astype(np.float32)
    txt, temp = rng.randn(5, 16).astype(np.float32), np.float32(0.07)
    logits, labels = rng.randn(9, 2).astype(np.float32), rng.randint(0, 2, 9)
    lg = rng.randn(3, 7, 11).astype(np.float32)
    lab = rng.randint(-1, 11, (3, 7)).astype(np.int32)
    mask = (rng.rand(3, 7) > 0.3).astype(np.int32)
    want = _jit(lambda: ([jc.itc_loss(im, txt, temp) for im in (img, img2)],
                         jc.itm_loss(logits, labels), jc.lm_loss(lg, lab, mask)))
    for im, w in zip((img, img2), want[0]):
        _close(t2n(tc.itc_loss(torch.from_numpy(im), torch.from_numpy(txt), torch.tensor(temp))),
               w, LOSS_RTOL, "itc")
    _close(t2n(tc.itm_loss(torch.from_numpy(logits), torch.from_numpy(labels))),
           want[1], LOSS_RTOL, "itm")
    _close(t2n(tc.lm_loss(*map(torch.from_numpy, (lg, lab, mask)))), want[2], LOSS_RTOL, "lm")
    # the data axis of a one-process run is the whole batch (world 2: test_torch_parallel.py)
    _close(t2n(tc.itc_loss(torch.from_numpy(img), torch.from_numpy(txt), torch.tensor(temp),
                           axis="data")), want[0][0], LOSS_RTOL, "itc over one process")


def test_stage1_losses_match_reference(ref):
    m = _port(ref)
    got = m(ref["batch"], gumbel=tuple(map(torch.from_numpy, ref["gumbel"])))
    for k in ("loss", "loss_itc", "loss_itm", "loss_lm"):
        _close(t2n(got[k]), ref["out"][k], LOSS_RTOL, k)
    neg = m.draw_negatives(*_feats(m, ref["batch"]), gumbel=tuple(
        map(torch.from_numpy, ref["gumbel"])))
    assert all(bool((n != torch.arange(4)).all()) for n in neg)     # never the pair itself


def _feats(m, batch):
    b = m._to_device(batch)
    img = m.vision_proj(m.encode_image(b["image_embeds"], b["image_mask"]))
    txt = m.text_proj(m.encode_text(b["text_ids"], b["text_mask"])[:, 0])
    return img, txt, m.temp.clamp(min=1e-3)


def test_stage1_gradients_match_reference(ref):
    """Every parameter's gradient, the tied word embeddings (input and LM
    head) and the clamped temperature included."""
    m = _port(ref)
    m.train()
    m(ref["batch"], gumbel=tuple(map(torch.from_numpy, ref["gumbel"])))["loss"].backward()
    paths = reference_paths(m)
    assert len(paths) == len(list(m.parameters())) == len(jax.tree_util.tree_leaves(ref["grads"]))
    for name, p in m.named_parameters():
        path, tr = paths[name]
        want = np.asarray(tree_get(ref["grads"], path))
        _close(t2n(p.grad), want.T if tr else want, RTOL, name, atol=1e-7)
    assert abs(float(m.temp.grad)) > 1e-3 and np.abs(t2n(m.word_embeddings.weight.grad)).max() > 1e-3


def test_negative_draws_come_from_the_generator(ref):
    m = _port(ref)
    feats = _feats(m, ref["batch"])
    a = m.draw_negatives(*feats, generator=torch.Generator().manual_seed(7))
    b = m.draw_negatives(*feats, generator=torch.Generator().manual_seed(7))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(bool((n != torch.arange(4)).all()) for n in a)


def test_blip2_itm_heads_match_reference(ref):
    """Both heads of one model; it owns every parameter of the stage-1
    model whichever head it is asked for."""
    m = _port(ref, tq.Blip2ITM)
    for head in ("itm", "itc"):
        _close(t2n(m(ref["batch"], match_head=head)), ref["heads"][head], LOSS_RTOL, head)
    assert m(ref["batch"]).shape == (4, 2)
    with pytest.raises(ValueError, match="itm|itc"):
        m(ref["batch"], match_head="both")


def test_stage1_batches_equal_reference(tmp_path):
    """On the same feature files and seed: scenes above the scene-token
    capacity (a random subset drawn a sample), two epochs, the
    hash-tokenized captions, bit for bit."""
    jcfg, tcfg = blip2_cfgs(STAGE1)
    rng = np.random.RandomState(4)
    records = []
    for s in range(3):
        sid = f"scene{s:04d}_00"
        torch.save(torch.from_numpy(rng.randn(90 - 20 * s, 48).astype(np.float32)),
                   tmp_path / f"{sid}.pt")
        np.save(tmp_path / f"{sid}.npy", rng.randint(0, 256, (90 - 20 * s, 3)).astype(np.int32))
        records += [{"scene_id": sid, "question_id": f"{sid}-q{k}", "answers": ["chair"],
                     "question": f"What is on the table number {k}, near the window?"}
                    for k in range(3)]
    jds = jdata.ThreeDVQADataset(jcfg.blip2, records, feature_dir=str(tmp_path), seed=4)
    tds = tdata.ThreeDVQADataset(tcfg.blip2, records, feature_dir=str(tmp_path), seed=4)
    got = list(tdata.stage1_batches(tds, 4, tcfg.blip2.qformer, seed=2, epochs=2))
    want = list(jdata.stage1_batches(jds, 4, jcfg.blip2.qformer, seed=2, epochs=2))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert got[0]["text_ids"].shape == (4, 32) and got[0]["text_ids"].max() < 94


def test_cli_train_stage1_on_the_cpu(tmp_path):
    """Two steps on the synthetic 3D-VQA datasets; the ``.npz`` holds every
    parameter under the reference's tree paths and shapes. The model is
    float32 whatever ``train.bf16`` says, as the reference's entry point
    builds it: both settings log the same losses."""
    def run(name, bf16):
        opts = [*BLIP2_TINY, *STAGE1, f"train.bf16={bf16}", "train.batch_size=4",
                "train.log_every_steps=1", f"log.log_dir={tmp_path / name / 'logs'}",
                f"train.ckpt_dir={tmp_path / name / 'ckpt'}"]
        out = cli_train.main(["--task", "stage1", "--synthetic", "--max-steps", "2",
                              "--device", "cpu", "--output", str(tmp_path / name / "run"),
                              "--options", *opts])
        return out, [json.loads(x) for x in open(tmp_path / name / "logs" / "metrics.jsonl")]

    out, rows = run("f32", "false")
    assert [r["step"] for r in rows] == [1, 2] and out["step"] == 2
    assert all(np.isfinite(r[k]) for r in rows for k in ("loss", "loss_itc", "loss_itm",
                                                         "loss_lm"))
    assert run("bf16", "true")[1] == rows
    jcfg, _ = blip2_cfgs(STAGE1)
    jm = jq.Blip2Qformer(jcfg.blip2.qformer)
    b = {k: jnp.asarray(x) for k, x in stage1_batch(np.random.RandomState(0),
                                                      jcfg.blip2.qformer).items()}
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                             "sample": jax.random.PRNGKey(1)}, b))["params"]
    want = {"/".join(k.key for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    with np.load(out["npz"]) as npz:
        got = {k: npz[k].shape for k in npz.files}
    assert got == want and out["tensors"] == len(want)
