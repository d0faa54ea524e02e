"""The port's sparse conv backward (``sparse/conv.py``: the fused kernel on
the transpose map for ``dx``, ``gather_rows`` + one product for ``dW``)
against ``jax.grad`` of the reference's ``sparse_conv_apply`` with its
gather-only VJP, on the maps of a real plan: the same-coords k3 and k5 maps
(``symmetric_bwd``) and the k2 pair (``transpose_map``), both directions:
the decoder's transposed convs run on ``map_up`` with ``map_down`` as their
transpose map.

float32, atol 1e-5 on gradients scaled to O(1): the two sides add the same
products in another order. bfloat16 inputs: 2e-2 relative to the largest
gradient (``dx`` is rounded to bf16, 2^-8). The CUDA path is held against
plain autograd on the card by ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation3d_tpu.sparse import conv as jconv
from situation3d_tpu_torch.ops.cuda.fused_conv import fused_sparse_conv_plain
from situation3d_tpu_torch.sparse import conv as tconv
from situation3d_tpu_torch.sparse.minkunet import build_unet_plan
from situation3d_tpu_torch.sparse.tensor import SparseVoxels

from torch_port_util import t2n

torch.set_num_threads(1)
ATOL = 1e-5
B, CAPS, EXTENT = 2, (256, 128, 64, 32, 16), (32, 32, 16)


@pytest.fixture(scope="module")
def levels():
    r = np.random.RandomState(0)
    coords = np.zeros((B, CAPS[0], 3), np.int32)
    mask = np.zeros((B, CAPS[0]), bool)
    for b in range(B):
        c = np.unique(np.stack([r.randint(0, s, 260) for s in (24, 20, 12)], 1),
                      axis=0)[:200 - 30 * b]
        coords[b, :len(c)], mask[b, :len(c)] = c, True
    return build_unet_plan(coords, mask, CAPS, EXTENT, device="cpu")["levels"]


def _maps(L, case):
    """(nbr_idx, transpose map or None, symmetric, input mask, output mask)."""
    if case == "k3":
        return L[1]["map_k3"], None, True, L[1]["mask"], L[1]["mask"]
    if case == "k5":
        return L[0]["map_k5"], None, True, L[0]["mask"], L[0]["mask"]
    if case == "k2_down":
        return L[1]["map_down"], L[0]["map_up"], False, L[0]["mask"], L[1]["mask"]
    if case == "k2_up":      # the transpose direction: coarse -> fine
        return L[0]["map_up"], L[1]["map_down"], False, L[1]["mask"], L[0]["mask"]
    if case == "k2_up_level2":   # the decoder's convtr6 pair: level 2 -> level 1
        return L[1]["map_up"], L[2]["map_down"], False, L[2]["mask"], L[1]["mask"]
    raise KeyError(case)


def _inputs(L, case, seed, c_in=5, c_out=7):
    nbr, tmap, sym, m_in, m_out = _maps(L, case)
    r = np.random.RandomState(seed)
    K = nbr.shape[2]
    feats = r.randn(B, m_in.shape[1], c_in).astype(np.float32) * t2n(m_in)[..., None]
    w = (r.randn(K, c_in, c_out) / np.sqrt(K * c_in)).astype(np.float32)
    # the conv module masks dy before the conv's backward sees it
    cot = (r.randn(B, m_out.shape[1], c_out) / 8).astype(np.float32) * t2n(m_out)[..., None]
    return nbr, tmap, sym, feats, w, cot


def _jax_grads(nbr, tmap, sym, feats, w, cot):
    def loss(f, k):
        out = jconv.sparse_conv_apply(
            f, jnp.asarray(t2n(nbr)), k, symmetric_bwd=sym,
            transpose_map=None if tmap is None else jnp.asarray(t2n(tmap)))
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(cot))
    with jax.default_matmul_precision("highest"):
        return jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(feats), jnp.asarray(w))


def _port_grads(nbr, tmap, sym, feats, w, cot, dtype=torch.float32):
    f = torch.from_numpy(feats).to(dtype).requires_grad_()
    k = torch.from_numpy(w).requires_grad_()
    out = tconv.sparse_conv_apply(f, nbr, k, symmetric_bwd=sym, transpose_map=tmap)
    assert out.dtype == dtype
    return torch.autograd.grad(out, (f, k), torch.from_numpy(cot).to(dtype))


@pytest.mark.parametrize("case", ["k3", "k5", "k2_down", "k2_up", "k2_up_level2"])
def test_conv_backward_matches_reference_vjp(levels, case):
    args = _inputs(levels, case, seed=1)
    want_dx, want_dw = (np.asarray(g) for g in _jax_grads(*args))
    dx, dw = _port_grads(*args)
    assert dx.dtype == torch.float32 and dw.dtype == torch.float32
    assert float(np.abs(want_dx).max()) > 0.05 and float(np.abs(want_dw).max()) > 0.05
    np.testing.assert_allclose(t2n(dx), want_dx, atol=ATOL, rtol=0)
    np.testing.assert_allclose(t2n(dw), want_dw, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["k3", "k5", "k2_down", "k2_up"])
def test_conv_backward_matches_plain_autograd(levels, case):
    """The gather-only backward and plain autograd through the plain conv
    agree."""
    nbr, tmap, sym, feats, w, cot = _inputs(levels, case, seed=2)
    f = torch.from_numpy(feats).requires_grad_()
    k = torch.from_numpy(w).requires_grad_()
    want = torch.autograd.grad(fused_sparse_conv_plain(f, nbr, k), (f, k),
                               torch.from_numpy(cot))
    for g, x in zip(_port_grads(nbr, tmap, sym, feats, w, cot), want):
        np.testing.assert_allclose(t2n(g), t2n(x), atol=ATOL, rtol=0)


def test_conv_without_a_backward_map_raises(levels):
    """A conv given neither ``symmetric_bwd`` nor a ``transpose_map`` has no
    backward to run: it raises, through the function and the module."""
    nbr, _, _, feats, w, _ = _inputs(levels, "k2_down", seed=8)
    with pytest.raises(ValueError, match="symmetric_bwd.*transpose_map"):
        tconv.sparse_conv_apply(torch.from_numpy(feats), nbr, torch.from_numpy(w))
    L = levels
    x = SparseVoxels(L[0]["coords"], torch.from_numpy(feats), L[0]["mask"], 1)
    with pytest.raises(ValueError, match="symmetric_bwd.*transpose_map"):
        tconv.SparseConv(5, 7, 8)(x, nbr, L[1]["coords"], L[1]["mask"], 2)


@pytest.mark.parametrize("case", ["k3", "k2_down", "k2_up"])
def test_conv_backward_bf16_inputs(levels, case):
    """bf16 activations: dy is cast to bf16, dx comes back in bf16, dW in the
    kernel's float32, both accumulated in float32."""
    args = _inputs(levels, case, seed=3, c_in=6 if case == "k3" else 5, c_out=8
                   if case == "k3" else 7)     # odd bf16 rows take the f32 gather
    nbr, tmap, sym, feats, w, cot = args
    r16 = lambda a: torch.from_numpy(a).bfloat16().float().numpy()
    want_dx, want_dw = (np.asarray(g) for g in _jax_grads(
        nbr, tmap, sym, r16(feats), r16(w), r16(cot)))
    dx, dw = _port_grads(*args, dtype=torch.bfloat16)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    np.testing.assert_allclose(dx.float().numpy(), want_dx, rtol=0,
                               atol=2e-2 * float(np.abs(want_dx).max()))
    np.testing.assert_allclose(t2n(dw), want_dw, atol=1e-4, rtol=0)


def test_padding_and_all_miss_rows_get_zero_gradient(levels):
    nbr, tmap, sym, feats, w, cot = _inputs(levels, "k5", seed=4)
    m = t2n(levels[0]["mask"])
    assert (~m).any() and bool((nbr[~levels[0]["mask"]] == nbr.shape[1]).all())
    dx, dw = _port_grads(nbr, tmap, sym, feats, w, cot)
    assert float(dx[~levels[0]["mask"]].abs().max()) == 0.0
    # padding rows of feats are zero, so nothing of them enters dW: garbage
    # in the cotangent's padding rows (never the case after the module's mask
    # multiply) cannot leak through an all-miss row either
    noisy = cot + (~m)[..., None] * 7.0
    _, dw2 = _port_grads(nbr, tmap, sym, feats, w, noisy)
    np.testing.assert_array_equal(t2n(dw), t2n(dw2))
    assert not bool(torch.isnan(dx).any() | torch.isnan(dw).any())


def test_conv_skips_dx_when_the_input_needs_no_gradient(levels, monkeypatch):
    nbr, tmap, sym, feats, w, cot = _inputs(levels, "k5", seed=5)
    calls = []
    real = tconv.fused_sparse_conv
    monkeypatch.setattr(tconv, "fused_sparse_conv",
                        lambda *a: calls.append(a[1].shape) or real(*a))
    k = torch.from_numpy(w).requires_grad_()
    out = tconv.sparse_conv_apply(torch.from_numpy(feats), nbr, k, symmetric_bwd=True)
    (dw,) = torch.autograd.grad(out, k, torch.from_numpy(cot))
    assert len(calls) == 1 and dw.shape == k.shape     # forward only: no dx launch


def test_offset_chunks_keep_the_gathered_rows_under_the_budget():
    chunks = tconv._offset_chunks(125, 8 * 49152 * 32 * 2)
    assert chunks[0][0] == 0 and chunks[-1][1] == 125 and len(chunks) == 3
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert max(j1 - j0 for j0, j1 in chunks) * 8 * 49152 * 32 * 2 <= tconv.GATHER_CHUNK_BYTES
    assert tconv._offset_chunks(27, 8 * 24576 * 32 * 2) == [(0, 27)]
    assert len(tconv._offset_chunks(4, tconv.GATHER_CHUNK_BYTES * 2)) == 4


def test_chunked_weight_gradient_equals_unchunked(levels, monkeypatch):
    args = _inputs(levels, "k5", seed=6)
    _, whole = _port_grads(*args)
    monkeypatch.setattr(tconv, "GATHER_CHUNK_BYTES", 40 * 1024)
    _, parts = _port_grads(*args)
    np.testing.assert_allclose(t2n(parts), t2n(whole), atol=1e-6, rtol=0)


def test_sparse_conv_module_backward_masks_dy_first(levels):
    """Through the module: the mask multiply sits outside the Function, so a
    loss that reads padding rows still gives the masked gradient."""
    L = levels
    r = np.random.RandomState(7)
    mod = tconv.SparseConv(4, 6, 8)
    x = SparseVoxels(L[0]["coords"], torch.from_numpy(
        r.randn(B, CAPS[0], 4).astype(np.float32)) * L[0]["mask"][..., None],
        L[0]["mask"], 1)
    out = mod(x, L[1]["map_down"], L[1]["coords"], L[1]["mask"], 2,
              transpose_map=L[0]["map_up"])
    cot = torch.from_numpy(r.randn(*out.feats.shape).astype(np.float32))
    (dw,) = torch.autograd.grad(out.feats, mod.kernel, cot)
    ref = fused_sparse_conv_plain(x.feats, L[1]["map_down"], mod.kernel) \
        * L[1]["mask"][..., None]
    (want,) = torch.autograd.grad(ref, mod.kernel, cot)
    np.testing.assert_allclose(t2n(dw), t2n(want), atol=ATOL, rtol=0)
