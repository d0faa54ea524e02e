"""The generators make the same inputs from the same seed, and others from
another seed."""
import numpy as np
import torch

from benchmarks.drivers.blip2_t5_answer import prompts
from benchmarks.harness.scenes import make_rooms, questions, voxelize_rooms
from benchmarks.tests.conftest import TINY_SIG3D, TINY_SIG3D_MIX

S = dict(TINY_SIG3D, **{"data.voxel_size": 0.02})
SEED = 2 ** 31 + 12345        # past 32 signed bits, as a run's seed may be


def _rooms(seed):
    g = torch.Generator().manual_seed(seed)
    pts = make_rooms(5, 4000, (0.8, 0.6, 0.3), (4, 10), g)
    return voxelize_rooms(pts, 0.02, 1024, g)


def test_rooms_repeat_from_the_seed():
    a, b, c = _rooms(SEED), _rooms(SEED), _rooms(SEED + 1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])


def test_rooms_hold_unique_voxels_inside_the_room():
    coords, feats, mask, counts = _rooms(SEED)
    for r in range(coords.shape[0]):
        valid = coords[r][mask[r]]
        assert len(torch.unique(valid, dim=0)) == len(valid) == min(int(counts[r]), 1024)
        assert int(valid.min()) >= 0 and int(valid[:, 0].max()) <= 40
        assert float(feats[r][mask[r]].abs().max()) <= 1.0
        assert not feats[r][~mask[r]].any()


def test_questions_repeat_from_the_seed():
    a, b = questions(SEED, 3, 7, TINY_SIG3D_MIX, S), questions(SEED, 3, 7, TINY_SIG3D_MIX, S)
    c = questions(SEED + 1, 3, 7, TINY_SIG3D_MIX, S)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["s_ids"], c["s_ids"])
    n = a["s_mask"].sum(1)
    assert (n >= 3 + 2).all() and (n <= 8 + 2).all()
    assert (a["s_ids"][np.arange(7), n - 1] == 2).all() and (a["s_ids"][:, 0] == 0).all()


def test_prompts_repeat_from_the_seed():
    mix = {"words": [3, 9]}
    a = prompts(SEED, 4, mix, "Question: {} Answer:", 32, 500)
    b = prompts(SEED, 4, mix, "Question: {} Answer:", 32, 500)
    c = prompts(SEED + 1, 4, mix, "Question: {} Answer:", 32, 500)
    assert np.array_equal(a[0], b[0]) and not np.array_equal(a[0], c[0])
    n = a[1].sum(1)
    assert (a[0][np.arange(4), n - 1] == 1).all()              # </s> last
    assert (n >= 3 + 4 + 1).all() and (n <= 9 + 4 + 1).all()   # template: 2 + 2 words
