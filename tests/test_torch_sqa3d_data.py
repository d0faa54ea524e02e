"""The port's SQA3D data pipeline against the reference's, numpy on both
sides: on SQA3D-layout files written on the spot, ``load_scene``,
``SQA3DDataset[i]`` (train with its augmentation draws, and val) and
``batch_iterator`` (shuffled, the last batch padded and flagged in
``sample_valid``) give the same arrays bit for bit, and so do the synthetic
datasets; token ids, answer vocabularies, answer scores, question types,
situation targets and answer normalization are equal; ``masked_softmax``
and ``gelu_new`` agree within 1e-6; the port's registry and misc helpers
behave as the reference's."""
import logging
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from situation3d_tpu.data import sqa3d as jsqa
from situation3d_tpu.data import synthetic as jsyn
from situation3d_tpu.data import tokenizer as jtok
from situation3d_tpu.data import vocab as jvocab
from situation3d_tpu.utils import misc as jmisc
from situation3d_tpu.utils import qa as jqa
from situation3d_tpu_torch.data import sqa3d as tsqa
from situation3d_tpu_torch.data import synthetic as tsyn
from situation3d_tpu_torch.data import tokenizer as ttok
from situation3d_tpu_torch.data import vocab as tvocab
from situation3d_tpu_torch.utils import misc as tmisc
from situation3d_tpu_torch.utils import qa as tqa
from situation3d_tpu_torch.utils.registry import Registry

from torch_port_util import (SQA_ANSWERS, SQA_SCENES, assert_batches_equal, tiny_cfgs,
                             write_small_sqa3d)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_small_sqa3d(tmp_path_factory.mktemp("sqa3d"))


def _cfgs(files, extra=()):
    return tiny_cfgs(("data.voxel_capacity=512", *files, *extra))


def _datasets(files, split):
    jcfg, tcfg = _cfgs(files)
    out = []
    for cfg, sqa, vocab in ((jcfg, jsqa, jvocab), (tcfg, tsqa, tvocab)):
        counter = vocab.load_answer_counter(cfg.data.answer_counter)
        voc = vocab.build_answer_vocab(counter, cfg.data.answer_min_freq,
                                       cfg.data.num_answers)
        out.append(sqa.SQA3DDataset(cfg, split, voc, counter,
                                    include_labels=split == "val"))
    return out


@pytest.mark.parametrize("scene_id", sorted(SQA_SCENES))
def test_load_scene_is_bit_equal(files, scene_id):
    jcfg, tcfg = _cfgs(files)
    want = jsqa.load_scene(jcfg.data.scene_dir, jcfg.data.scans_dir, scene_id)
    got = tsqa.load_scene(tcfg.data.scene_dir, tcfg.data.scans_dir, scene_id)
    for field in ("points", "colors", "labels", "bs_center", "axis_align"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert not np.array_equal(want.axis_align, np.eye(4))      # the meta file was read
    assert (got.labels == 255).sum() == 7                       # -100 -> 255


@pytest.mark.parametrize("split", ["train", "val"])
def test_dataset_items_are_bit_equal(files, split):
    """train: the rot-z augmentation and the overflow subset draw from the
    dataset's generator; val: the subset only, labels kept."""
    jds, tds = _datasets(files, split)
    assert len(jds) == len(tds) == {"train": 8, "val": 4}[split]
    # twice over, so the second pass sees the generators where the first left them
    for i in list(range(len(jds))) * 2:
        item = tds[i]
        assert_batches_equal(item, jds[i])
        # every overflowing scene keeps a random subset of the capacity
        assert item["voxel_mask"].all()
    assert ("voxel_labels" in item) == (split == "val")


def test_batch_iterator_is_bit_equal(files):
    """Shuffled, two epochs, B=3 over 4 records: the second batch of each
    epoch is padded with repeats and flagged in ``sample_valid``."""
    jds, tds = _datasets(files, "val")
    jit = jsqa.batch_iterator(jds, 3, shuffle=True, seed=3, drop_last=False, epochs=2)
    tit = tsqa.batch_iterator(tds, 3, shuffle=True, seed=3, drop_last=False, epochs=2)
    n = 0
    for got, want in zip(tit, jit, strict=True):
        assert_batches_equal(got, want)
        n += 1
    assert n == 4 and got["sample_valid"].tolist() == [True, False, False]
    dropped = list(tsqa.batch_iterator(tds, 3, shuffle=False, drop_last=True))
    assert len(dropped) == 1


@pytest.mark.parametrize("split,extra", [
    ("train", ()),
    # the mirror draw before rot-z; mirroring a pose is a rotation only for a
    # yaw-only quaternion, which the synthetic records have (both packages
    # raise in scipy for others)
    ("train", ("data.aug_mirror=true",)),
    ("val", ()),
])
def test_synthetic_dataset_batches_are_bit_equal(split, extra):
    jcfg, tcfg = tiny_cfgs(("data.voxel_capacity=512", *extra))
    kw = dict(n_scenes=2, per_scene=3, split=split, n_points=3000, seed=4,
              include_labels=split == "val")
    jds = jsyn.make_synthetic_dataset(jcfg, **kw)
    tds = tsyn.make_synthetic_dataset(tcfg, **kw)
    assert tds.vocab.itos_list == jds.vocab.itos_list and len(tds) == 6
    for got, want in zip(tsqa.batch_iterator(tds, 4, seed=1, drop_last=False),
                         jsqa.batch_iterator(jds, 4, seed=1, drop_last=False), strict=True):
        assert_batches_equal(got, want)


TEXTS = ["What is on the table?", "I am standing next to the door, facing it.",
         "", "how many chairs are there on my left-hand side?", "don't go",
         "Ünïcode wörds 42 and #symbols!"]


def test_token_ids_are_equal(tmp_path):
    for n in (12, 100):
        for vocab_size in (128, 30527):
            j, t = jtok.HashTokenizer(vocab_size), ttok.HashTokenizer(vocab_size)
            for text in TEXTS:
                for got, want in zip(t.encode(text, n), j.encode(text, n)):
                    assert got.dtype == want.dtype
                    np.testing.assert_array_equal(got, want)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["<s>", "<pad>", "</s>", "<unk>", "what", "is", "on",
                                "the", "tab", "##le", "?", "i", "am", "stand", "##ing",
                                "chair", "##s", "how", "many", ",", "door"]) + "\n")
    j, t = jtok.WordPieceTokenizer(str(vocab)), ttok.WordPieceTokenizer(str(vocab))
    for text in TEXTS:
        for n in (6, 24):
            for got, want in zip(t.encode(text, n), j.encode(text, n)):
                np.testing.assert_array_equal(got, want)
    assert 8 in t.encode("the table", 8)[0] and 9 in t.encode("the table", 8)[0]
    # no cached HF tokenizer here: both packages fall back to the same strategy
    jt = jtok.make_tokenizer("sentence-transformers/all-mpnet-base-v2", vocab_size=128)
    tt = ttok.make_tokenizer("sentence-transformers/all-mpnet-base-v2", vocab_size=128)
    assert type(jt).__name__ == type(tt).__name__ == "HashTokenizer"
    assert type(ttok.make_tokenizer("x", str(vocab))).__name__ == "WordPieceTokenizer"
    assert type(ttok.make_tokenizer("x", str(tmp_path / "none.txt"))).__name__ \
        == "HashTokenizer"


def test_vocab_scores_and_question_types_are_equal(tmp_path):
    counter = {a: 5 - (i % 4) for i, a in enumerate(SQA_ANSWERS)}
    for min_freq, max_size in ((1, None), (3, None), (1, 5), (2, 7)):
        j = jvocab.build_answer_vocab(counter, min_freq, max_size)
        t = tvocab.build_answer_vocab(counter, min_freq, max_size)
        assert t.itos_list == j.itos_list
        assert [t.stoi(a) for a in SQA_ANSWERS + ["nope"]] == \
            [j.stoi(a) for a in SQA_ANSWERS + ["nope"]]
    j, t = jvocab.AnswerVocab(["a", "b"], "<unk>"), tvocab.AnswerVocab(["a", "b"], "<unk>")
    assert (t.itos_list, t.stoi("zz"), len(t)) == (j.itos_list, j.stoi("zz"), len(j))
    assert [tvocab.answer_score(f) for f in (0, 1, 7)] == \
        [jvocab.answer_score(f) for f in (0, 1, 7)]
    path = tmp_path / "answers.json"
    path.write_text('["yes", "no", "yes", "left"]')
    assert tvocab.load_answer_counter(str(path)) == jvocab.load_answer_counter(str(path))
    for q in ["What is it?", "is it", "Are they", "how many", "Can I", "which one",
              "If I turn", "where", "Am I", "describe", "", "  "]:
        assert tsqa.question_type_id(q) == jsqa.question_type_id(q)


def test_situation_targets_are_equal():
    rng = np.random.RandomState(5)
    for _ in range(6):
        quat = R.random(random_state=rng).as_quat()
        coord = rng.randn(3)
        for tag in ("__quat__", "__angle__", "__6d__", "mse__quat__"):
            got, want = tsqa.situation_target(coord, quat, tag), \
                jsqa.situation_target(coord, quat, tag)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    for axis in range(3):
        np.testing.assert_array_equal(tsqa._rot(axis, 0.3), jsqa._rot(axis, 0.3))
    with pytest.raises(NotImplementedError):
        tsqa.situation_target(coord, quat, "__euler__")


def test_answer_normalization_is_equal():
    for a in ["Two", "the red chair.", "a lamp", "3.5", "1,000", "dont know",
              "Yes!", "left/right", "it's (maybe) a TV", "none", "  ten\tchairs\n",
              "isnt it", "x-ray", "the end."]:
        assert tqa.normalize_answer(a) == jqa.normalize_answer(a)


def test_masked_softmax_and_gelu_new_within_1e_6():
    rng = np.random.RandomState(6)
    x = (rng.randn(3, 5, 7) * 4).astype(np.float32)
    mask = rng.rand(3, 5, 7) > 0.4
    mask[0, 0] = False                                  # a fully masked row
    for m in (None, mask):
        got = tqa.masked_softmax(torch.from_numpy(x),
                                 None if m is None else torch.from_numpy(m))
        want = jqa.masked_softmax(jnp.asarray(x), None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tqa.gelu_new(torch.from_numpy(x)).numpy(),
                               np.asarray(jqa.gelu_new(jnp.asarray(x))), atol=1e-6, rtol=0)


def test_registry_and_misc_helpers():
    reg = Registry()

    @reg.register_task("t_port_only")
    class Task:
        pass

    assert reg.get_task("t_port_only") is Task and "t_port_only" in reg.list("task")
    with pytest.raises(KeyError):
        reg.register_task("t_port_only")(object)
    with pytest.raises(KeyError, match="Unknown task"):
        reg.get_task("t_missing")
    for s in (0, 59, 3600, 90061.7):
        assert tmisc.decode_eta(s) == jmisc.decode_eta(s)
    tmisc.set_seed(11)
    draws = (random.random(), np.random.rand(), torch.rand(1).item())
    tmisc.set_seed(11)
    assert draws == (random.random(), np.random.rand(), torch.rand(1).item())
    assert tmisc.count_parameters(torch.nn.Linear(3, 4)) == 16
    from situation3d_tpu_torch.train import logging as tlog
    assert tmisc.SmoothedValue is tlog.SmoothedValue and tmisc.MetricLogger is tlog.MetricLogger
    logger = tmisc.setup_logger("situation3d_tpu_torch.test_misc")
    assert logger.level == logging.INFO and len(logger.handlers) == 1
