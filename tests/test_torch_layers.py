"""``Dense``'s compute-dtype copy (``situation3d_tpu_torch/models/layers.py``):
where no gradient reaches the weight it multiplies with a bfloat16 copy made
once, bit for bit the per-call cast; the copy follows in-place updates and
swapped storages of the float32 master, is made outside inference mode, is
no part of the module's state, and a trainable weight is still cast at
every call. ``GraphCache.lookup`` refreshes the copies that replayed steps
read, without a forward."""
import copy
import io

import pytest
import torch
import torch.nn.functional as F

from situation3d_tpu_torch.models import layers
from situation3d_tpu_torch.models.layers import Dense
from situation3d_tpu_torch.models.step_graphs import GraphCache

torch.set_num_threads(1)
BF16 = torch.bfloat16


def _dense(seed=0, bias=True, dtype=BF16):
    torch.manual_seed(seed)
    d = Dense(24, 16, dtype, bias=bias)
    if bias:
        with torch.no_grad():
            d.bias.normal_()
    return d


def _cast_linear(d, x):
    """The per-call cast: the arithmetic ``Dense`` ran before it kept a copy."""
    b = None if d.bias is None else d.bias.detach().to(d.dtype)
    return F.linear(x.to(d.dtype), d.weight.detach().to(d.dtype), b)


def _x(seed=1, rows=5):
    return torch.randn(rows, 24, generator=torch.Generator().manual_seed(seed))


def _bits(t):
    return t.detach().view(torch.int16)


@pytest.mark.parametrize("how", ["no_grad", "frozen_weight", "inference_mode"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_a_weight_no_gradient_reaches_reads_a_copy_equal_to_the_cast(how, bias):
    d, x = _dense(bias=bias), _x()
    if how == "frozen_weight":
        d.requires_grad_(False)
    ctx = {"no_grad": torch.no_grad, "frozen_weight": torch.enable_grad,
           "inference_mode": torch.inference_mode}[how]
    n0 = layers.weight_copies
    with ctx():
        first = d(x)
        second = d(_x(2))
    assert layers.weight_copies == n0 + 1        # made once, not again
    assert torch.equal(_bits(first), _bits(_cast_linear(d, x)))
    assert torch.equal(_bits(second), _bits(_cast_linear(d, _x(2))))
    c = d.compute_copy
    assert c.weight.dtype == BF16 and not c.weight.is_inference()
    assert (c.bias is None) == (not bias)


@pytest.mark.parametrize("update", ["mul_", "adamw"])
def test_the_copy_follows_an_in_place_update_of_the_master(update):
    d, x = _dense(), _x()
    with torch.no_grad():
        d(x)
    address = d.compute_copy.weight.data_ptr()
    if update == "mul_":
        with torch.no_grad():
            d.weight.mul_(1.5)
            d.bias.add_(0.25)
    else:
        opt = torch.optim.AdamW(d.parameters(), lr=0.1)
        F.linear(x, d.weight, d.bias).square().sum().backward()
        opt.step()
    n0 = layers.weight_copies
    with torch.no_grad():
        got = d(x)
    assert layers.weight_copies == n0 + 1
    assert torch.equal(_bits(got), _bits(_cast_linear(d, x)))
    assert d.compute_copy.weight.data_ptr() == address      # refreshed in place


@pytest.mark.parametrize("swap", ["data", "load_state_dict_assign"])
def test_the_copy_is_rebuilt_after_a_swapped_storage(swap):
    d, x = _dense(), _x()
    with torch.no_grad():
        d(x)
    new = {k: v.detach().clone() * 2 for k, v in d.state_dict().items()}
    if swap == "data":
        d.weight.data = new["weight"]
        d.bias.data = new["bias"]
    else:
        d.load_state_dict(new, assign=True)
    n0 = layers.weight_copies
    with torch.no_grad():
        got = d(x)
    assert layers.weight_copies == n0 + 1
    assert torch.equal(_bits(got), _bits(_cast_linear(d, x)))


def test_a_trainable_weight_is_cast_per_call_and_its_gradient_reaches_the_master():
    d, x = _dense(), _x()
    n0 = layers.weight_copies
    out = d(x)
    assert layers.weight_copies == n0 and d.compute_copy.weight is None
    assert torch.equal(_bits(out), _bits(_cast_linear(d, x)))
    out.float().square().sum().backward()
    w = d.weight.detach().clone().requires_grad_(True)
    b = d.bias.detach().clone().requires_grad_(True)
    F.linear(x.to(BF16), w.to(BF16), b.to(BF16)).float().square().sum().backward()
    assert d.weight.grad.dtype == torch.float32
    assert torch.equal(d.weight.grad, w.grad) and torch.equal(d.bias.grad, b.grad)


def test_a_copy_made_in_inference_mode_serves_a_later_forward_with_grad():
    """Evaluation under inference mode, then training goes on with the
    layer frozen: the copy is saved for the backward to the input."""
    d = _dense().requires_grad_(False)
    with torch.inference_mode():
        d(_x())
    n0 = layers.weight_copies
    x = _x(3).requires_grad_(True)
    d(x).float().sum().backward()
    assert layers.weight_copies == n0
    x2 = _x(3).requires_grad_(True)
    _cast_linear(d, x2).float().sum().backward()
    assert torch.equal(x.grad, x2.grad)


def test_the_copy_is_no_state_and_a_copy_of_the_module_shares_none():
    d, x = _dense(), _x()
    keys = list(d.state_dict())
    with torch.no_grad():
        d(x)
    assert list(d.state_dict()) == keys == ["weight", "bias"]
    assert len(list(d.parameters())) == 2 and not list(d.buffers())
    twin = copy.deepcopy(d)
    assert twin.compute_copy.weight is None and twin.compute_copy.key is None
    buf = io.BytesIO()
    torch.save(d, buf)
    buf.seek(0)
    loaded = torch.load(buf, weights_only=False)
    assert loaded.compute_copy.weight is None
    with torch.no_grad():
        twin.weight.mul_(3.0)
        assert torch.equal(_bits(d(x)), _bits(_cast_linear(d, x)))
        assert torch.equal(_bits(twin(x)), _bits(_cast_linear(twin, x)))


def test_no_copy_where_the_weight_has_the_compute_dtype():
    """A float32 layer, and a bfloat16 weight computing in bfloat16 (LFM2's
    parameters), read their own weight."""
    n0 = layers.weight_copies
    f32 = _dense(dtype=torch.float32)
    held = _dense().to(BF16)
    with torch.no_grad():
        f32(_x())
        held(_x())
    assert layers.weight_copies == n0
    assert f32.compute_copy.weight is None and held.compute_copy.weight is None


def test_graph_lookup_refreshes_stale_copies_without_a_forward():
    """A replayed graph runs no Python: the cache's lookup brings every copy
    of the modules the steps read up to date first, in place."""
    model = torch.nn.Sequential(_dense(0), torch.nn.ReLU(), _dense(1, bias=False))
    cache = GraphCache()
    with torch.no_grad():
        cache.lookup("key", [model], lambda: "captured")
        assert all(m.compute_copy.weight is not None for m in (model[0], model[2]))
        address = model[0].compute_copy.weight.data_ptr()
        model[0].weight.mul_(2.0)
        n0 = layers.weight_copies
        assert cache.lookup("key", [model], lambda: "again") == "captured"
    assert layers.weight_copies == n0 + 1
    c = model[0].compute_copy
    assert c.weight.data_ptr() == address
    assert torch.equal(c.weight, model[0].weight.to(BF16))
