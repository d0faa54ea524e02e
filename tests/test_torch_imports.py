"""The port stands alone: it imports torch/numpy/stdlib only, keeps the
reference's configuration fields, and its entry points refuse to run on a
card that is not there."""
import dataclasses
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import situation3d_tpu_torch
from situation3d_tpu import config as jconfig
from situation3d_tpu_torch import config as tconfig

torch.set_num_threads(1)

PORT_MODULES = sorted(
    m.name for m in pkgutil.walk_packages(situation3d_tpu_torch.__path__,
                                          "situation3d_tpu_torch."))


def test_port_imports_nothing_of_jax():
    """Import every port module in a fresh interpreter and look at
    ``sys.modules``: no jax, flax, optax, orbax, transformers, yaml, nor the
    JAX package."""
    assert len(PORT_MODULES) >= 30, PORT_MODULES
    assert {"situation3d_tpu_torch.cli.train", "situation3d_tpu_torch.ops.cuda.gather_rows",
            *(f"situation3d_tpu_torch.train.{m}" for m in (
                "checkpoint", "logging", "losses", "metrics", "optim", "trainer"))
            } <= set(PORT_MODULES)
    code = (
        "import importlib, sys\n"
        f"mods = {PORT_MODULES!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'transformers', 'yaml', 'triton', "
        "'wandb', 'tensorboard', 'situation3d_tpu'))\n"
        "print('BAD=' + ','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=str(__import__("pathlib").Path(__file__).parents[1]))
    assert out.returncode == 0, out.stderr[-2000:]
    bad = out.stdout.strip().splitlines()[-1]
    assert bad == "BAD=", bad


@pytest.mark.parametrize("group", ["DataConfig", "SparseConfig", "ModelConfig",
                                   "LangConfig", "LossConfig", "TrainConfig",
                                   "LogConfig"])
def test_config_groups_match_reference(group):
    """Same field names, order and defaults as the reference's groups, so one
    set of overrides configures both packages."""
    jf = dataclasses.fields(getattr(jconfig, group))
    tf = dataclasses.fields(getattr(tconfig, group))
    assert [f.name for f in jf if f.name in {t.name for t in tf}] \
        == [f.name for f in jf], "port lacks a field"
    jd, td = dataclasses.asdict(getattr(jconfig, group)()), \
        dataclasses.asdict(getattr(tconfig, group)())
    assert jd == td


def test_apply_overrides_matches_reference_without_yaml():
    opts = ["sparse.planes=4,8,12,24,12,12,8,8", "sparse.grid_extent=(128,128,64)",
            "sparse.capacities=[64,32,16,8,4]", "data.voxel_size=0.08",
            "sparse.pallas_map=force", "sparse.pallas_map_bits=false",
            "model.situated_reencode=true", "lang.num_layers=1",
            "model.lang_model=mpnet", "sparse.fused_conv=true",
            "train.frozen_prefixes=", "train.lr_decay_steps=2,3", "train.lr=1e-3",
            "loss.answer_loss=ce", "log.profile_steps=(2,4)", "train.nan_guard=full"]
    j = jconfig.apply_overrides(jconfig.Config(), opts)
    t = tconfig.apply_overrides(tconfig.Config(), opts)
    for g in ("data", "sparse", "model", "lang", "loss", "train", "log"):
        assert dataclasses.asdict(getattr(j, g)) == dataclasses.asdict(getattr(t, g)), g
    with pytest.raises(KeyError):
        tconfig.apply_overrides(tconfig.Config(), ["sparse.no_such_key=1"])


_TINY = ["lang.num_layers=1", "lang.hidden_size=32", "lang.num_heads=2",
         "lang.intermediate_size=64", "lang.vocab_size=64", "model.hidden_size=32",
         "model.mcan_num_heads=2", "model.mcan_num_layers=1",
         "sparse.capacities=64,32,16,8,4", "sparse.grid_extent=(32,32,32)",
         "data.max_text_len=6", "data.num_answers=5"]


def _tiny(extra=()):
    return tconfig.apply_overrides(tconfig.Config(), [*_TINY, *extra])


ENTRY_POINTS = {
    "SIG3D": lambda kw: __import__(
        "situation3d_tpu_torch.models.sig3d", fromlist=["SIG3D"]).SIG3D(_tiny(), 5, **kw),
    "build_unet_plan": lambda kw: __import__(
        "situation3d_tpu_torch.sparse.minkunet", fromlist=["x"]).build_unet_plan(
            np.zeros((1, 64, 3), np.int32), np.zeros((1, 64), bool),
            (64, 32, 16, 8, 4), (32, 32, 32), **kw),
    "make_scene_batch": lambda kw: __import__(
        "situation3d_tpu_torch.data.synthetic", fromlist=["x"]).make_scene_batch(
            _tiny(), 1, np.random.RandomState(0), **kw),
    "SceneCache": lambda kw: __import__(
        "situation3d_tpu_torch.eval.serving", fromlist=["x"]).SceneCache(
            ENTRY_POINTS["SIG3D"]({"device": "cpu"}), **kw),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_cuda_and_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="cuda"):
        ENTRY_POINTS[name]({})
    assert ENTRY_POINTS[name]({"device": "cpu"}) is not None


@pytest.mark.parametrize("name", ["Trainer", "cli.train"])
def test_training_entry_point_defaults_to_cuda_and_raises_without_a_card(name, tmp_path):
    """The trainer runs where its model lives and the model defaults to the
    card; the command line asks for the card unless told ``--device cpu``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    from situation3d_tpu_torch.cli import train as cli_train
    from situation3d_tpu_torch.train.trainer import Trainer
    dirs = [f"train.ckpt_dir={tmp_path / 'ckpt'}", f"log.log_dir={tmp_path / 'logs'}"]

    def run(**kw):
        if name == "Trainer":
            cfg = _tiny(dirs)
            return Trainer(cfg, ENTRY_POINTS["SIG3D"](kw), steps_per_epoch=10)
        argv = ["--synthetic", "--max-steps", "1", "--output", str(tmp_path / "run"),
                "--options", *_TINY, "train.batch_size=1", *dirs]
        cli_train.main(argv + [x for k, v in kw.items() for x in (f"--{k}", v)])
        return (tmp_path / "ckpt" / "step_1.pt").exists()

    with pytest.raises(RuntimeError, match="cuda"):
        run()
    assert run(device="cpu")


def test_unported_options_say_so():
    from situation3d_tpu_torch.models.sig3d import SIG3D
    for opt, word in (("model.lang_model=lstm", "lstm"),
                      ("sparse.final_result=true", "final_result"),
                      ("sparse.dense_downsample=false", "sort-based")):
        cfg = tconfig.apply_overrides(_tiny(), [opt])
        with pytest.raises(NotImplementedError, match=word):
            SIG3D(cfg, 5, device="cpu")
