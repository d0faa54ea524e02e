"""Mamba-2's selective state-space recurrence (Dao and Gu, "Transformers are
SSMs", ICML 2024), per row and head ``h`` of group ``g = h // (H / G)``:

    S_t = exp(dt_t A_h) S_{t-1} + dt_t x_t B_t^T,    y_t = S_t C_t + D_h x_t

``S`` a [head_dim, state] float32 matrix, ``x_t`` the head's channels,
``B_t`` / ``C_t`` the group's state inputs and outputs, ``dt_t`` the step
size (0 at a pad position: ``S`` stays as it was). The CUDA route and its
plain versions.

Replaces no TPU kernel: the JAX package holds no state-space layer. It was
added for Nemotron-H's Mamba-2 mixers (``models/nemotron_h.py``).

- :func:`ssm_scan`, the prefill: ``S_0 = 0`` over every position of a
  left-padded batch, the last ``S`` into the decode state. On the card
  ``ssm_scan_kernel`` (``csrc/ssm_scan.cu``) walks the positions in order
  with the state in registers; the plain version is Mamba-2's chunked form
  (``chunk`` positions a chunk: the products within a chunk, the state
  carried between chunks), an independent arithmetic of the same
  recurrence.
- :func:`ssm_update`, the decode step: one position, the state read and
  written in place; ``ssm_update_kernel`` on the card, one step of the
  recurrence in the plain version.

Inputs arrive as the mixer makes them: ``xbc`` [..., H*P + 2*G*N] float32,
x, B and C side by side after the conv, and ``dt`` [..., H] float32.
Nothing reads the device from the host, so a decode step can be captured.

Counters: ``launches`` (host, +1 a call on the card), and on each device two
int64 counters added in place (:func:`device_counters`): the real positions
a prefill scanned and the rows a decode step updated, summed over layers.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from situation3d_tpu_torch.ops.cuda import _build

HEAD_DIM, STATE = 64, 128       # the sizes the kernels are built for

launches = 0    # +1 per mixer's scan or update run on the card, nowhere else

_COUNTERS: Dict[str, torch.Tensor] = {}


def device_counters(device) -> torch.Tensor:
    """int64 [2] on ``device``: (positions scanned, rows updated), summed
    over every SSM layer that ran there."""
    dev = torch.device(device)
    key = str(dev)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(2, dtype=torch.int64, device=dev)
    return _COUNTERS[key]


def _split(xbc: torch.Tensor, H: int, G: int, N: int):
    """x [..., H, P], B and C [..., H, N] (each head its group's) of ``xbc``."""
    HP = xbc.shape[-1] - 2 * G * N
    x = xbc[..., :HP].unflatten(-1, (H, HP // H))
    B = xbc[..., HP:HP + G * N].unflatten(-1, (G, N)).repeat_interleave(H // G, -2)
    C = xbc[..., HP + G * N:].unflatten(-1, (G, N)).repeat_interleave(H // G, -2)
    return x, B, C


def ssm_scan_plain(xbc: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                   groups: int, state_size: int, state: Optional[torch.Tensor] = None,
                   chunk: int = 128) -> torch.Tensor:
    """Plain version of :func:`ssm_scan`: the chunked form. Within a chunk
    ``y_t = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s`` plus the
    state carried in, ``C_t exp(cum_t) S_in``, where ``cum`` is the running
    sum of ``dt A`` in the chunk; the state carried out is ``exp(cum_last)
    S_in + sum_s exp(cum_last - cum_s) dt_s x_s B_s^T``."""
    Bsz, L, H = dt.shape
    x, Bm, Cm = _split(xbc.float(), H, groups, state_size)          # [B, L, H, ·]
    n_chunks = -(-L // chunk)
    pad = n_chunks * chunk - L

    def chunks(t):
        t = torch.nn.functional.pad(t, (0,) * (2 * (t.dim() - 2)) + (0, pad))
        return t.view(Bsz, n_chunks, chunk, *t.shape[2:])
    x, Bm, Cm, dtc = chunks(x), chunks(Bm), chunks(Cm), chunks(dt.float())
    cum = torch.cumsum(dtc * A.float(), 2)                             # [B, c, l, H]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]                # [B, c, t, s, H]
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=xbc.device).tril()
    decay = torch.exp(seg.masked_fill(~causal[None, None, :, :, None], float("-inf")))
    cb = torch.einsum("bcthn,bcshn->bctsh", Cm, Bm)
    y = torch.einsum("bctsh,bcsh,bcshp->bcthp", cb * decay, dtc, x)
    to_end = torch.exp(cum[:, :, -1:] - cum) * dtc                     # [B, c, l, H]
    own = torch.einsum("bclhn,bclh,bclhp->bchpn", Bm, to_end, x)       # [B, c, H, P, N]
    S = x.new_zeros(Bsz, H, x.shape[-1], state_size)
    for c in range(n_chunks):
        y[:, c] += torch.einsum("bthn,bth,bhpn->bthp", Cm[:, c], torch.exp(cum[:, c]), S)
        S = torch.exp(cum[:, c, -1])[..., None, None] * S + own[:, c]
    y = y.reshape(Bsz, n_chunks * chunk, H, -1)[:, :L] + D.float()[:, None] * x.reshape(
        Bsz, n_chunks * chunk, H, -1)[:, :L]
    if state is not None:
        state.copy_(S)
    return y.reshape(Bsz, L, -1)


def ssm_update_plain(xbc: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                     groups: int, state_size: int, state: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`ssm_update`: one step of the recurrence."""
    H = dt.shape[-1]
    x, Bm, Cm = _split(xbc.float(), H, groups, state_size)             # [B, H, ·]
    dt = dt.float()
    S = (torch.exp(dt * A.float())[..., None, None] * state
         + (dt[..., None] * x)[..., None] * Bm[:, :, None, :])
    state.copy_(S)
    y = torch.einsum("bhpn,bhn->bhp", S, Cm) + D.float()[:, None] * x
    return y.reshape(x.shape[0], -1)


def _on_card(name: str, xbc, dt, A, D, state) -> None:
    for t, what in ((xbc, "xbc"), (dt, "dt"), (A, "A"), (D, "D"), (state, "state")):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name} on the card takes contiguous float32 {what}, got "
                            f"{t.dtype} {tuple(t.stride())}")


def _launched(code: int, name: str) -> None:
    global launches
    _build.check_launch(code, name)
    launches += 1


def _check(xbc, dt, groups, state_size, state) -> None:
    H = dt.shape[-1]
    HP = xbc.shape[-1] - 2 * groups * state_size
    if (H % groups or HP <= 0 or HP % H or xbc.shape[:-1] != dt.shape[:-1]
            or (state is not None and tuple(state.shape) != (dt.shape[0], H, HP // H,
                                                             state_size))):
        raise ValueError(f"ssm: xbc {tuple(xbc.shape)}, dt {tuple(dt.shape)}, groups {groups}, "
                         f"state {None if state is None else tuple(state.shape)}")


def ssm_scan(xbc: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
             groups: int, state_size: int, state: torch.Tensor, keep: torch.Tensor,
             chunk: int = 128, counters: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The prefill's recurrence from a zero state.

    Args:
      xbc: float32 [B, L, H*P + 2*G*N]: x, B and C after the conv.
      dt: float32 [B, L, H] step sizes, 0 at pad positions.
      A, D: float32 [H] (A negative).
      state: float32 [B, H, P, N], written with the state after position L-1.
      keep: bool [B, L], the real positions (counted, not read otherwise).
      chunk: the plain version's chunk length.
      counters: int64 [2]; its first is added the real positions.
    Returns float32 [B, L, H*P]. CPU tensors run the plain version; CUDA
    tensors launch ``ssm_scan_kernel`` (or raise).
    """
    _check(xbc, dt, groups, state_size, state)
    if counters is not None:
        counters[0].add_(keep.sum())
    if not xbc.is_cuda:
        return ssm_scan_plain(xbc, dt, A, D, groups, state_size, state, chunk)
    Bsz, L, H = dt.shape
    if xbc.shape[-1] != H * HEAD_DIM + 2 * groups * STATE or state_size != STATE:
        raise ValueError(f"ssm_scan on the card: head_dim {HEAD_DIM} and state {STATE} only")
    _on_card("ssm_scan", xbc, dt, A, D, state)
    y = torch.empty(Bsz, L, H * HEAD_DIM, dtype=torch.float32, device=xbc.device)
    lib = _build.load_library()
    with torch.cuda.device(xbc.device):
        code = lib.s3d_ssm_scan(xbc.data_ptr(), dt.data_ptr(), A.data_ptr(), D.data_ptr(),
                                y.data_ptr(), state.data_ptr(), Bsz, L, H, groups,
                                xbc.shape[-1], torch.cuda.current_stream().cuda_stream)
    _launched(code, "ssm_scan")
    return y


def ssm_update(xbc: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
               groups: int, state_size: int, state: torch.Tensor,
               counters: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode position a row: ``xbc`` float32 [B, H*P + 2*G*N], ``dt``
    [B, H]; ``state`` [B, H, P, N] updated in place; ``counters[1]`` added
    the B rows. Returns float32 [B, H*P]."""
    _check(xbc, dt, groups, state_size, state)
    if counters is not None:
        counters[1].add_(dt.shape[0])
    if not xbc.is_cuda:
        return ssm_update_plain(xbc, dt, A, D, groups, state_size, state)
    Bsz, H = dt.shape
    if xbc.shape[-1] != H * HEAD_DIM + 2 * groups * STATE or state_size != STATE:
        raise ValueError(f"ssm_update on the card: head_dim {HEAD_DIM} and state {STATE} only")
    _on_card("ssm_update", xbc, dt, A, D, state)
    y = torch.empty(Bsz, H * HEAD_DIM, dtype=torch.float32, device=xbc.device)
    lib = _build.load_library()
    with torch.cuda.device(xbc.device):
        code = lib.s3d_ssm_update(xbc.data_ptr(), dt.data_ptr(), A.data_ptr(), D.data_ptr(),
                                  y.data_ptr(), state.data_ptr(), Bsz, H, groups,
                                  xbc.shape[-1], torch.cuda.current_stream().cuda_stream)
    _launched(code, "ssm_update")
    return y
