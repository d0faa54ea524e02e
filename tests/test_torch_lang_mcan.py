"""Language encoder and MCAN fusion blocks of the port against the
reference, with the reference's weights carried across. float32, atol 1e-4:
same arithmetic, other summation order and ``erf``/``exp`` implementations."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation3d_tpu.config import LangConfig as JLangConfig
from situation3d_tpu.models import lang as jlang
from situation3d_tpu.models import mcan as jmcan
from situation3d_tpu.models import relpos as jrelpos
from situation3d_tpu_torch.ckpt_compat.from_jax import load_jax_variables
from situation3d_tpu_torch.config import LangConfig
from situation3d_tpu_torch.models import lang as tlang
from situation3d_tpu_torch.models import mcan as tmcan
from situation3d_tpu_torch.models import relpos as trelpos

from torch_port_util import randomize_variables, t2n, to_numpy_tree

torch.set_num_threads(1)
ATOL = 1e-4
H, B, L = 32, 2, 10


def _init(module, *args, seed=0):
    """Reference variables: flax init, then every scale/bias randomized."""
    v = module.init(jax.random.PRNGKey(seed), *args)
    return randomize_variables(v, np.random.RandomState(seed))


def _carry(port_module, variables):
    unused = load_jax_variables(port_module, to_numpy_tree(variables["params"]), {})
    assert unused == []
    return port_module.eval()


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(t2n(got), np.asarray(want), atol=atol, rtol=0)


def _pad_mask(r, length):
    m = np.zeros((B, length), bool)
    m[0, length - 3:] = True
    return m


@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_position_bucket(bidirectional):
    rp = trelpos.relative_position_matrix(140, 140)
    np.testing.assert_array_equal(t2n(rp), np.asarray(jrelpos.relative_position_matrix(140, 140)))
    got = trelpos.relative_position_bucket(rp, bidirectional, 32, 128)
    want = jrelpos.relative_position_bucket(jnp.asarray(t2n(rp), jnp.int32), bidirectional, 32, 128)
    np.testing.assert_array_equal(t2n(got), np.asarray(want))


def test_mpnet_encoder_and_lang_module():
    kw = dict(vocab_size=64, hidden_size=H, num_layers=2, num_heads=4,
              intermediate_size=48, max_position=40)
    r = np.random.RandomState(0)
    ids = r.randint(2, 64, (2, B, L)).astype(np.int32)
    mask = np.ones((2, B, L), np.int32)
    mask[0, 0, 7:] = 0
    mask[1, 1, 4:] = 0
    jm = jlang.LangModule(JLangConfig(**kw))
    with jax.default_matmul_precision("highest"):
        v = _init(jm, ids[0], mask[0], ids[1], mask[1])
        want = jm.apply(v, ids[0], mask[0], ids[1], mask[1])
    tm = _carry(tlang.LangModule(LangConfig(**kw)), v)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (ids[0], mask[0], ids[1], mask[1])))
    for g, w in zip(got[:2], want[:2]):
        _close(g, w)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(t2n(g), np.asarray(w))
    with pytest.raises(NotImplementedError, match="lstm"):
        tlang.LangModule(LangConfig(**kw), model="lstm")


def test_mcan_layernorm_is_not_nn_layernorm():
    x = np.random.RandomState(1).randn(B, L, H).astype(np.float32) * 3
    jm = jmcan.MCANLayerNorm()
    v = _init(jm, x)
    got = _carry(tmcan.MCANLayerNorm(H), v)(torch.from_numpy(x)).detach()
    _close(got, jm.apply(v, x), 1e-5)
    plain = torch.nn.functional.layer_norm(torch.from_numpy(x), (H,))
    assert float((got - plain).abs().max()) > 1e-3


def test_mhatt():
    r = np.random.RandomState(2)
    q, kv = r.randn(B, 6, H).astype(np.float32), r.randn(B, L, H).astype(np.float32)
    pad = _pad_mask(r, L)
    jm = jmcan.MHAtt(H, 4)
    with jax.default_matmul_precision("highest"):
        v = _init(jm, kv, kv, q, pad)
        want = jm.apply(v, kv, kv, q, pad)
        want_nomask = jm.apply(v, kv, kv, q, None)
    tm = _carry(tmcan.MHAtt(H, 4), v)
    with torch.no_grad():
        tq, tkv = torch.from_numpy(q), torch.from_numpy(kv)
        _close(tm(tkv, tkv, tq, torch.from_numpy(pad)), want)
        _close(tm(tkv, tkv, tq, None), want_nomask)


def test_sa_block():
    r = np.random.RandomState(3)
    x, pad = r.randn(B, L, H).astype(np.float32), _pad_mask(r, L)
    jm = jmcan.SA(H, 4)
    with jax.default_matmul_precision("highest"):
        v = _init(jm, x, pad)
        want = jm.apply(v, x, pad)
    with torch.no_grad():
        _close(_carry(tmcan.SA(H, 4), v)(torch.from_numpy(x), torch.from_numpy(pad)), want)


def test_sga_block():
    r = np.random.RandomState(4)
    x, y = r.randn(B, 6, H).astype(np.float32), r.randn(B, L, H).astype(np.float32)
    pad = _pad_mask(r, L)
    jm = jmcan.SGA(H, 4)
    with jax.default_matmul_precision("highest"):
        v = _init(jm, x, y, None, pad)
        want = jm.apply(v, x, y, None, pad)
    with torch.no_grad():
        got = _carry(tmcan.SGA(H, 4), v)(torch.from_numpy(x), torch.from_numpy(y),
                                         None, torch.from_numpy(pad))
    _close(got, want)


@pytest.mark.parametrize("glimpses", [1, 2])
def test_attflat_softmaxes_over_the_sequence(glimpses):
    r = np.random.RandomState(5)
    x, pad = r.randn(B, L, H).astype(np.float32), _pad_mask(r, L)
    jm = jmcan.AttFlat(16, glimpses, 24)
    with jax.default_matmul_precision("highest"):
        v = _init(jm, x, pad)
        want, want_att = jm.apply(v, x, pad)
        want_nomask, _ = jm.apply(v, x, None)
    tm = _carry(tmcan.AttFlat(H, 16, glimpses, 24), v)
    with torch.no_grad():
        got, att = tm(torch.from_numpy(x), torch.from_numpy(pad))
        _close(got, want)
        _close(att, want_att)
        np.testing.assert_allclose(t2n(att.sum(dim=1)), 1.0, atol=1e-5)
        assert float(att[0, L - 3:].abs().max()) == 0.0       # pads get no weight
        _close(tm(torch.from_numpy(x), None)[0], want_nomask)


def test_ffn_and_mlp():
    x = np.random.RandomState(6).randn(B, L, H).astype(np.float32)
    jm = jmcan.FFN(H)
    with jax.default_matmul_precision("highest"):
        v = _init(jm, x)
        want = jm.apply(v, x)
    with torch.no_grad():
        _close(_carry(tmcan.FFN(H), v)(torch.from_numpy(x)), want)
