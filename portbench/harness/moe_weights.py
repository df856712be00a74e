"""The initial parameters of a cell of the latent-attention and expert
block (``reference/mla_moe.py``), made from the seed on the device as
``weights.py`` makes the dense tree's: one uniform draw for every matrix
(the stacked experts' too) in a single call, then the port's init rule:
Glorot-uniform over each matrix's own fan-in and fan-out (an expert's,
for the stacks), unit RMSNorm gains, in float32.

The same seed on the same device gives the same tensors bit for bit, so
the harness draws them again instead of keeping a copy.
"""

from __future__ import annotations

import math

import torch

from ..reference.mla_moe import MoEDims, leaf_shapes


def _draw(d: MoEDims, seed: int, device) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    shapes = leaf_shapes(d)
    total = sum(math.prod(s) for s in shapes.values() if len(s) >= 2)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for path, shape in shapes.items():
        if len(shape) >= 2:
            n = math.prod(shape)
            limit = math.sqrt(6.0 / (shape[-2] + shape[-1]))
            out[path] = flat[at:at + n].view(shape).mul_(2.0).sub_(1.0).mul_(limit)
            at += n
        else:
            out[path] = torch.ones(shape, device=device)  # the RMSNorm gains
    return flat, out


def device_leaves(d: MoEDims, seed: int, device) -> dict[str, torch.Tensor]:
    """Every leaf by its path, float32 on ``device``; the matrices are views
    of one flat buffer, in path order."""
    return _draw(d, seed, device)[1]


def numpy_tree(d: MoEDims, seed: int, device) -> dict:
    """The same parameters as the port's nested numpy tree (``embed``,
    ``blocks`` [{name: array}], ``lnf_g``, ``head``), copied to the host in
    one transfer of the flat buffer."""
    flat, leaves = _draw(d, seed, device)
    host = flat.cpu().numpy()
    tree: dict = {"blocks": [{} for _ in range(d.num_layers)]}
    for path, t in leaves.items():
        if t.dim() >= 2:
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
