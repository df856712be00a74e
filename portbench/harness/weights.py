"""The initial parameters of a training cell, made from the seed on the
device: one uniform draw for every matrix in a single call, then the
port's own init rule (``init_lm_params``): Glorot-uniform matrices, unit
LayerNorm gains, zero biases, in float32, the type the masters are kept in.

The same seed on the same device gives the same tensors bit for bit, so
the harness draws them again instead of keeping a copy: for the program's
initial tree, for the change of the parameters after the checked steps,
and for the reference.
"""

from __future__ import annotations

import math

import torch

from ..reference.lm import Dims, leaf_shapes


def _is_matrix(shape) -> bool:
    return len(shape) == 2


def device_leaves(d: Dims, seed: int, device) -> dict[str, torch.Tensor]:
    """Every leaf by its path, float32 on ``device``. The matrices are
    views of one flat buffer, in path order."""
    return _draw(d, seed, device)[1]


def _draw(d: Dims, seed: int, device) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    shapes = leaf_shapes(d)
    total = sum(math.prod(s) for s in shapes.values() if _is_matrix(s))
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for path, shape in shapes.items():
        if _is_matrix(shape):
            n = math.prod(shape)
            limit = math.sqrt(6.0 / (shape[0] + shape[1]))
            out[path] = flat[at:at + n].view(shape).mul_(2.0).sub_(1.0).mul_(limit)
            at += n
        elif path.rsplit(".", 1)[-1].endswith("_g"):
            out[path] = torch.ones(shape, device=device)
        else:
            out[path] = torch.zeros(shape, device=device)
    return flat, out


def numpy_tree(d: Dims, seed: int, device) -> dict:
    """The same parameters as the port's nested numpy tree (``embed``,
    ``blocks`` [{name: array}], ``lnf_g``, ``lnf_b``, ``head``), copied to
    the host in one transfer of the flat buffer."""
    flat, leaves = _draw(d, seed, device)
    host = flat.cpu().numpy()
    tree: dict = {"blocks": [{} for _ in range(d.num_layers)]}
    for path, t in leaves.items():
        if _is_matrix(t.shape):
            off = t.storage_offset()
            arr = host[off:off + t.numel()].reshape(t.shape)
        else:
            arr = t.cpu().numpy()
        parts = path.split(".")
        if parts[0] == "blocks":
            tree["blocks"][int(parts[1])][parts[2]] = arr
        else:
            tree[path] = arr
    return tree


def leaf(params: dict, path: str):
    """The leaf at ``path`` of the port's nested tree."""
    parts = path.split(".")
    return params["blocks"][int(parts[1])][parts[2]] if parts[0] == "blocks" else params[path]
