"""The benchmark's own tests: ``python -m pytest benchmarks/tests -q`` from
the repository's root. Tests that need the CUDA card carry the ``chip``
marker and skip without one; on the card:
``python3 -m pytest benchmarks/tests -q -m chip``."""
import copy

import pytest
import torch

from benchmarks.harness.cell import cell_files


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs the CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size runs only there")
    return torch.device("cuda:0")


TINY_SIG3D = {
    "data.max_text_len": 16, "data.num_answers": 10, "data.voxel_capacity": 1024,
    "sparse.planes": [8, 8, 16, 16, 16, 16, 8, 8], "sparse.init_dim": 8,
    "sparse.capacities": [1024, 512, 256, 128, 64], "sparse.grid_extent": [64, 64, 32],
    "lang.vocab_size": 100, "lang.hidden_size": 32, "lang.num_layers": 2, "lang.num_heads": 2,
    "lang.intermediate_size": 64, "lang.max_position": 40,
    "model.hidden_size": 32, "model.mcan_flat_mlp_size": 16, "model.mcan_flat_out_size": 24,
    "model.mcan_num_heads": 2, "model.num_scene_tokens": 16, "model.scene_feat_dim": 16,
    "train.batch_size": 4,
}
TINY_SIG3D_MIX = {"room": [0.8, 0.6, 0.3], "points": 3000, "rooms": 12, "pool_batches": 3,
                  "batch_size": 4, "situation_words": [3, 8], "question_words": [2, 6],
                  "questions_per_scene": [5, 9], "check_batches": 2}
TINY_BLIP2 = {
    "qformer.num_query_tokens": 4, "qformer.hidden_size": 32, "qformer.num_layers": 2,
    "qformer.num_heads": 2, "qformer.intermediate_size": 64, "qformer.encoder_width": 24,
    "qformer.scene_token_capacity": 64, "pc_feat_dim": 24,
    "t5.vocab_size": 512, "t5.d_model": 32, "t5.d_kv": 8, "t5.d_ff": 48, "t5.num_layers": 2,
    "t5.num_decoder_layers": 2, "t5.num_heads": 4, "max_txt_len": 48,
}
TINY_BLIP2_MIX = {"batch_size": 3, "pool_batches": 3, "words": [3, 20], "check_batches": 2}


def tiny_files(workload: str) -> dict:
    """The cell's files at a size the CPU runs in seconds, float32 compute
    (the program's plain versions stand in for its kernels)."""
    f = copy.deepcopy(cell_files(workload))
    if f["config"]["model"] == "sig3d":
        f["config"]["settings"].update(TINY_SIG3D)
        f["traffic"].update(TINY_SIG3D_MIX)
    else:
        f["config"]["settings"].update(TINY_BLIP2)
        f["config"]["tokenizer_vocab"] = 500
        f["traffic"].update(TINY_BLIP2_MIX)
    f["config"]["compute_dtype"] = "float32"
    return f
