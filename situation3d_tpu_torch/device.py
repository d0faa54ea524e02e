"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; a CUDA device that is not
    there raises instead of falling back to the CPU (a port that silently
    ran on the CPU would report CPU numbers as the card's)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run the plain versions")
    return dev


def tree_to_device(tree, device):
    """Nested dicts and lists of arrays or tensors as tensors on ``device``,
    the structure kept (a batch, or a UNet plan inside one)."""
    if isinstance(tree, dict):
        return {k: tree_to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_device(v, device) for v in tree]
    return torch.as_tensor(tree).to(device)
