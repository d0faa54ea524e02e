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
    assert len(PORT_MODULES) >= 90, PORT_MODULES
    assert {"situation3d_tpu_torch.cli.train", "situation3d_tpu_torch.ops.cuda.gather_rows",
            "situation3d_tpu_torch.ops.cuda.fps", "situation3d_tpu_torch.ops.pointnet2",
            "situation3d_tpu_torch.ops.nn_distance",
            "situation3d_tpu_torch.models.pointnet2_modules",
            "situation3d_tpu_torch.models.votenet",
            "situation3d_tpu_torch.train.detection_losses",
            "situation3d_tpu_torch.eval.detection",
            "situation3d_tpu_torch.data.scannet_preprocess",
            *(f"situation3d_tpu_torch.train.{m}" for m in (
                "checkpoint", "logging", "losses", "metrics", "optim", "trainer", "tasks")),
            *(f"situation3d_tpu_torch.{m}" for m in (
                "utils.registry", "utils.misc", "utils.qa", "data.vocab", "data.tokenizer",
                "data.sqa3d", "data.prefetch", "ops.native", "sparse.host_plan",
                "cli.eval", "eval.segmentation", "eval.visualization",
                # the 3D-LLM
                "models.positional", "models.qformer", "models.t5", "models.blip2_t5",
                "ckpt_compat.common", "ckpt_compat.t5", "ckpt_compat.blip2",
                "data.threedvqa", "data.builders", "train.blip2_trainer",
                "eval.scorers", "eval.sqa3d_scoring", "cli.score", "cli.infer",
                # BLIP-2 stage 1, retrieval and the model zoo
                "train.contrastive", "models.blip2_qformer", "eval.retrieval",
                "models.opt", "models.blip2_opt", "ckpt_compat.opt", "models.med",
                "ckpt_compat.med", "models.vit", "ckpt_compat.vit", "ckpt_compat.from_jax",
                # data parallelism
                "parallel", "parallel.collectives", "parallel.mesh",
                # the last slice: reference checkpoints, OpenScene data, multiview
                "ckpt_compat.minkunet", "ckpt_compat.mpnet", "data.augmentation",
                "data.openscene_loader", "models.enet", "ops.projection"))
            } <= set(PORT_MODULES)
    code = (
        "import importlib, sys\n"
        f"mods = {PORT_MODULES!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'transformers', 'yaml', 'triton', "
        "'wandb', 'tensorboard', 'situation3d_tpu'))\n"
        "print('BAD=' + ','.join(bad))\n"
        "from situation3d_tpu_torch.ops.cuda import _build\n"
        "from situation3d_tpu_torch.ops import native\n"
        "print('BUILT=%s,%s,%s' % (_build._lib is not None, _build.build_seconds,\n"
        "                          native._lib is not None))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=str(__import__("pathlib").Path(__file__).parents[1]))
    assert out.returncode == 0, out.stderr[-2000:]
    bad, built = out.stdout.strip().splitlines()[-2:]
    assert bad == "BAD=", bad
    assert built == "BUILT=False,0.0,False", built  # importing builds nothing


def test_every_cuda_source_has_a_signature_and_a_wrapper():
    """One C entry point per kernel, each declared to ``ctypes`` with a
    pointer-sized type for every pointer and the stream, and named by the
    wrapper that launches it."""
    import ctypes
    import re
    from situation3d_tpu_torch.ops.cuda import _build
    exported = set()
    for src in sorted(_build.CSRC.glob("*.cu")):
        exported |= set(re.findall(r'extern "C" (?:int|long long) (s3d_\w+)\(',
                                   src.read_text()))
    assert exported == set(_build._SIGNATURES)
    assert "s3d_fps" in exported and (_build.CSRC / "fps.cu").exists()
    # xyz, valid, out, spill scratch; B, N, npoint and the layout (blocks a
    # row, threads, points a thread); the stream
    assert _build._SIGNATURES["s3d_fps"] == [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    wrappers = "".join(p.read_text() for p in
                       (_build.CSRC.parent / "ops" / "cuda").glob("*.py"))
    for name in exported:
        assert f"lib.{name}(" in wrappers, name
    # the C side's parameter list has as many entries as the declaration
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" (?:int|long long) (s3d_\w+)\(([^)]*)\)',
                                       src.read_text()):
            assert len(params.split(",")) == len(_build._SIGNATURES[name]), name


@pytest.mark.parametrize("group", ["DataConfig", "SparseConfig", "ModelConfig",
                                   "LangConfig", "LossConfig", "TrainConfig",
                                   "LogConfig", "EvalConfig", "QFormerConfig",
                                   "T5Config", "Blip2Config", "MeshConfig"])
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
            "loss.answer_loss=ce", "log.profile_steps=(2,4)", "train.nan_guard=full",
            "eval.batch_size=4", "eval.rot_thresholds=(10,20)"]
    j = jconfig.apply_overrides(jconfig.Config(), opts)
    t = tconfig.apply_overrides(tconfig.Config(), opts)
    for g in ("data", "sparse", "model", "lang", "loss", "train", "log", "eval"):
        assert dataclasses.asdict(getattr(j, g)) == dataclasses.asdict(getattr(t, g)), g
    with pytest.raises(KeyError):
        tconfig.apply_overrides(tconfig.Config(), ["sparse.no_such_key=1"])


def test_load_config_raises_on_an_unknown_group_as_the_reference(tmp_path):
    """A misspelt group raises the reference's error in both packages (the
    port used to drop it and load ``train.batch_size`` 32)."""
    path = tmp_path / "typo.yaml"
    path.write_text("trian:\n  batch_size: 3\n")
    errors = []
    for load in (jconfig.load_config, tconfig.load_config):
        with pytest.raises(KeyError, match="Unknown config key 'trian'") as e:
            load(str(path))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_every_config_file_loads_in_both_packages():
    """Every ``configs/*.yaml`` loads in both packages with the same groups
    the port has, the ``mesh`` group included."""
    import pathlib
    paths = sorted((pathlib.Path(__file__).parents[1] / "configs").glob("*.yaml"))
    assert len(paths) >= 7
    for path in paths:
        j, t = jconfig.load_config(str(path)), tconfig.load_config(str(path))
        for g in (f.name for f in dataclasses.fields(t)):
            assert dataclasses.asdict(getattr(j, g)) == dataclasses.asdict(getattr(t, g)), \
                (path.name, g)
    assert tconfig.load_config(options=["mesh.model_parallel=2"]).mesh.model_parallel == 2


def test_blip2_overrides_match_reference_without_yaml():
    opts = ["blip2.t5.d_model=64", "blip2.t5.dense_act_fn=gelu_new",
            "blip2.qformer.cross_attention_freq=1", "blip2.pos_scale=0.5",
            "blip2.freeze_t5_except_embeddings=false", "blip2.prompt={}",
            "train.max_iters=7", "train.iters_per_inner_epoch=3"]
    j = jconfig.apply_overrides(jconfig.Config(), opts)
    t = tconfig.apply_overrides(tconfig.Config(), opts)
    for g in ("blip2", "train"):
        assert dataclasses.asdict(getattr(j, g)) == dataclasses.asdict(getattr(t, g)), g


_TINY = ["lang.num_layers=1", "lang.hidden_size=32", "lang.num_heads=2",
         "lang.intermediate_size=64", "lang.vocab_size=64", "model.hidden_size=32",
         "model.mcan_num_heads=2", "model.mcan_num_layers=1",
         "sparse.capacities=64,32,16,8,4", "sparse.grid_extent=(32,32,32)",
         "data.max_text_len=6", "data.num_answers=5"]


def _tiny(extra=()):
    return tconfig.apply_overrides(tconfig.Config(), [*_TINY, *extra])


_TINY_BLIP2 = ["blip2.t5.vocab_size=32", "blip2.t5.d_model=16", "blip2.t5.d_kv=4",
               "blip2.t5.d_ff=16", "blip2.t5.num_layers=1", "blip2.t5.num_decoder_layers=1",
               "blip2.t5.num_heads=4", "blip2.qformer.hidden_size=16",
               "blip2.qformer.num_heads=2", "blip2.qformer.num_layers=1",
               "blip2.qformer.intermediate_size=16", "blip2.qformer.encoder_width=24",
               "blip2.pc_feat_dim=24"]

def _zoo(module, name):
    return getattr(__import__(f"situation3d_tpu_torch.models.{module}", fromlist=["x"]), name)


_TINY_OPT = dict(vocab_size=32, hidden_size=16, num_layers=1, num_heads=2, ffn_dim=16,
                 max_position=16)
_TINY_MED = dict(vocab_size=32, hidden_size=16, num_layers=1, num_heads=2,
                 intermediate_size=16, max_position_embeddings=16, encoder_width=8)
_TINY_VIT = dict(img_size=14, patch_size=7, embed_dim=8, depth=1, num_heads=2)

ENTRY_POINTS = {
    "Blip2T5": lambda kw: __import__(
        "situation3d_tpu_torch.models.blip2_t5", fromlist=["x"]).Blip2T5(
            _tiny(_TINY_BLIP2).blip2, **kw),
    "Blip2Qformer": lambda kw: _zoo("blip2_qformer", "Blip2Qformer")(
        _tiny(_TINY_BLIP2).blip2.qformer, embed_dim=8, **kw),
    "Blip2ITM": lambda kw: _zoo("blip2_qformer", "Blip2ITM")(
        _tiny(_TINY_BLIP2).blip2.qformer, embed_dim=8, **kw),
    "Blip2OPT": lambda kw: _zoo("blip2_opt", "Blip2OPT")(
        _tiny(_TINY_BLIP2).blip2.qformer, _zoo("opt", "OPTConfig")(**_TINY_OPT),
        pc_feat_dim=24, **kw),
    "OPTForCausalLM": lambda kw: _zoo("opt", "OPTForCausalLM")(
        _zoo("opt", "OPTConfig")(**_TINY_OPT), **kw),
    "MedBertModel": lambda kw: _zoo("med", "MedBertModel")(
        _zoo("med", "MedConfig")(**_TINY_MED), **kw),
    "MedBertLMHeadModel": lambda kw: _zoo("med", "MedBertLMHeadModel")(
        _zoo("med", "MedConfig")(**_TINY_MED), **kw),
    "EvaViT": lambda kw: _zoo("vit", "EvaViT")(_zoo("vit", "ViTConfig")(**_TINY_VIT), **kw),
    "ClipViT": lambda kw: _zoo("vit", "ClipViT")(
        _zoo("vit", "ViTConfig")(model_name="clip_L", **_TINY_VIT), **kw),
    "ENetForMultiview": lambda kw: _zoo("enet", "ENetForMultiview")(num_classes=7, **kw),
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
    "VoteNet": lambda kw: __import__(
        "situation3d_tpu_torch.models.votenet", fromlist=["x"]).VoteNet(
            18, 1, 18, np.ones((18, 3), np.float32), num_proposal=4,
            backbone_npoints=(8, 4, 2, 2), **kw),
    "make_detection_batch": lambda kw: __import__(
        "situation3d_tpu_torch.data.synthetic", fromlist=["x"]).make_detection_batch(
            1, 32, np.random.RandomState(0), **kw),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_cuda_and_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="cuda"):
        ENTRY_POINTS[name]({})
    assert ENTRY_POINTS[name]({"device": "cpu"}) is not None


@pytest.mark.parametrize("name", ["Trainer", "cli.train", "cli.eval", "cli.train stage1"])
def test_training_entry_point_defaults_to_cuda_and_raises_without_a_card(name, tmp_path):
    """The trainer runs where its model lives and the model defaults to the
    card; the command lines ask for the card unless told ``--device cpu``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    from situation3d_tpu_torch.cli import eval as cli_eval
    from situation3d_tpu_torch.cli import train as cli_train
    from situation3d_tpu_torch.train.trainer import Trainer
    dirs = [f"train.ckpt_dir={tmp_path / 'ckpt'}", f"log.log_dir={tmp_path / 'logs'}"]
    # the synthetic datasets' 12 answers, voxels padded to the first capacity
    synthetic = ["data.num_answers=12", "data.voxel_capacity=64", "eval.batch_size=4"]

    def run(**kw):
        if name == "Trainer":
            cfg = _tiny(dirs)
            return Trainer(cfg, ENTRY_POINTS["SIG3D"](kw), steps_per_epoch=10)
        argv = [x for k, v in kw.items() for x in (f"--{k}", v)]
        argv += ["--synthetic", "--output", str(tmp_path / "run"),
                 "--options", *_TINY, "train.batch_size=1", *synthetic, *dirs]
        if name == "cli.train stage1":
            argv = ["--task", "stage1", "--max-steps", "1", *argv, *_TINY_BLIP2,
                    "blip2.qformer.vocab_size=64", "blip2.qformer.scene_token_capacity=64"]
            return cli_train.main(argv)["tensors"] > 0
        if name == "cli.eval":
            return cli_eval.main(argv)["num_questions"] == 8
        cli_train.main(["--max-steps", "1", *argv])
        return (tmp_path / "ckpt" / "step_1.pt").exists()

    with pytest.raises(RuntimeError, match="cuda"):
        run()
    assert run(device="cpu")


def test_unported_options_say_so():
    """The options earlier slices refused build now (the GloVe + LSTM
    encoder, the sort-based plans); what stays unported, T5 tensor
    parallelism, says so."""
    from situation3d_tpu_torch.models.sig3d import SIG3D
    from situation3d_tpu_torch.parallel.mesh import make_mesh
    for opt in ("model.lang_model=lstm", "sparse.dense_lookup=false",
                "sparse.dense_downsample=false"):
        cfg = tconfig.apply_overrides(_tiny(), [opt])
        assert isinstance(SIG3D(cfg, 5, device="cpu"), SIG3D)
    with pytest.raises(NotImplementedError, match="model_parallel"):
        make_mesh(tconfig.MeshConfig(model_parallel=2), "cpu")
