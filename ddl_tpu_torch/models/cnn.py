"""The MNIST CNN in PyTorch — the port of ``ddl_tpu/models/cnn.py``.

Architecture parity with the reference graph (mnist_sync/model/model.py:17-106):
four 5x5 SAME convs (1->32->64->128->256 channels), each ReLU + 2x2 SAME
maxpool (spatial 28->14->7->4->2), then FC 1024 (ReLU) -> dropout -> FC 512
(**no activation**, as in model.py:79) -> dropout -> FC 10 logits; loss is
mean softmax cross-entropy (model.py:91-92); dropout uses TF semantics
(keep with prob ``keep_prob``, scale kept values by ``1/keep_prob``,
model.py:73-82); all 14 variables are glorot-uniform initialized.

Storage layout is the JAX package's: HWIO conv weights and ``[in, out]``
FC weights, names ``v0..v13``. So the flat parameter vector, the sharded
Adam moments and every layout offset are element-for-element the JAX
package's; the weights are permuted to OIHW inside :func:`apply_fn`. The
NHWC flatten order before FC1 is kept too (``permute(0, 2, 3, 1)``).

Convs and matmuls go to cuDNN/cuBLAS: XLA lowered them outside any Pallas
kernel. ``conv_matmul`` runs chosen conv stages as an explicit im2col
(``F.unfold``) and one matmul instead (:func:`_patches_block`), as JAX's
patches-matmul does. ``compute_dtype=torch.bfloat16`` casts parameters and
activations inside the forward while the logits and the loss stay fp32.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

Specs = tuple[tuple[str, tuple[int, ...]], ...]
Params = Mapping[str, torch.Tensor]


def make_param_specs(
    conv_channels: tuple[int, int, int, int] = (32, 64, 128, 256),
    fc_sizes: tuple[int, int] = (1024, 512),
    num_classes: int = 10,
) -> Specs:
    """(name, shape) for the 14 trainable variables, in the reference's
    creation order (mnist_sync/model/model.py:24-86)."""
    c1, c2, c3, c4 = conv_channels
    f1, f2 = fc_sizes
    return (
        ("v0", (5, 5, 1, c1)),  # w_conv1
        ("v1", (c1,)),  # b_conv1
        ("v2", (5, 5, c1, c2)),  # w_conv2
        ("v3", (c2,)),  # b_conv2
        ("v4", (5, 5, c2, c3)),  # w_conv3
        ("v5", (c3,)),  # b_conv3
        ("v6", (5, 5, c3, c4)),  # w_conv4
        ("v7", (c4,)),  # b_conv4
        ("v8", (2 * 2 * c4, f1)),  # w_fc1
        ("v9", (f1,)),  # b_fc1
        ("v10", (f1, f2)),  # w_fc2
        ("v11", (f2,)),  # b_fc2
        ("v12", (f2, num_classes)),  # w_fc3
        ("v13", (num_classes,)),  # b_fc3
    )


# The reference model (2,656,010 params).
PARAM_SPECS: Specs = make_param_specs()

# Narrow-width instance of the same 14-variable family: the CLI --tiny
# preset and the test suite's SMALL_SPECS.
TINY_CONV_CHANNELS: tuple[int, int, int, int] = (4, 8, 8, 8)
TINY_FC_SIZES: tuple[int, int] = (32, 16)

def param_sizes(specs: Specs = PARAM_SPECS) -> dict[str, int]:
    """Element count per variable — the quantity every layout policy
    balances."""
    return {name: math.prod(shape) for name, shape in specs}


def param_shapes(params: Params) -> dict[str, tuple[int, ...]]:
    """Static shapes of a concrete param dict."""
    return {k: tuple(v.shape) for k, v in params.items()}


def _fans(shape: tuple[int, ...]) -> tuple[float, float]:
    """TF/Keras ``_compute_fans``: rank-1 -> (n, n); rank-2 -> (in, out);
    rank-4 conv (HWIO) -> receptive field x channels."""
    if len(shape) == 1:
        return float(shape[0]), float(shape[0])
    if len(shape) == 2:
        return float(shape[0]), float(shape[1])
    receptive = math.prod(shape[:-2])
    return float(shape[-2] * receptive), float(shape[-1] * receptive)


def init_params(
    generator: torch.Generator,
    device: torch.device | str,
    specs: Specs = PARAM_SPECS,
) -> dict[str, torch.Tensor]:
    """Glorot-uniform init for all 14 vars (the TF1 ``get_variable``
    default), biases included. Draws from ``generator`` (a CPU generator,
    so the values do not depend on the device) and places the result on
    ``device``. It does not reproduce ``jax.random``: parity with the JAX
    package goes through ``ddl_tpu_torch.convert``."""
    params = {}
    for name, shape in specs:
        fan_in, fan_out = _fans(shape)
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        params[name] = (u * (2.0 * limit) - limit).to(device)
    return params


def dropout_generator(
    seed: int, step: int, worker: int, device: torch.device
) -> torch.Generator:
    """The dropout stream of one step of one worker: a pure function of
    ``(seed, global step, worker)``, so how the steps are chunked into
    spans never changes the masks (the role of ``jax.random.fold_in`` in
    the JAX package)."""
    state = np.random.SeedSequence([seed, step, worker]).generate_state(
        2, np.uint32
    )
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)
    return gen


def _dropout(
    x: torch.Tensor, gen: torch.Generator | None, keep_prob: float
) -> torch.Tensor:
    """TF-semantics dropout (model.py:73-74): keep with prob ``keep_prob``,
    scale kept values by ``1/keep_prob``. ``gen=None`` is eval mode."""
    if gen is None:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def _conv_block(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """5x5 SAME conv + bias + ReLU + 2x2 SAME maxpool, NCHW activations,
    HWIO weight. SAME 2x2/2 pooling is ``ceil_mode=True`` (the 7->4 stage
    needs the end padding)."""
    y = F.relu(F.conv2d(h, w.permute(3, 2, 0, 1), b, padding=2))
    return F.max_pool2d(y, 2, 2, ceil_mode=True)


def _patches_block(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`_conv_block` as patches @ matmul (any cin), JAX's
    ``_patches_block``: the SAME 5x5 patches (``F.unfold``, feature order
    ``(cin, kh, kw)``, as ``lax.conv_general_dilated_patches`` gives them)
    times the HWIO weight reordered to ``(cin, kh, kw)`` rows, as one
    ``[N*H*W, cin*kh*kw] @ [cin*kh*kw, cout]`` product. NCHW in and out."""
    n, _, hh, ww = h.shape
    kh, kw, _, cout = w.shape
    patches = F.unfold(h, (kh, kw), padding=(kh // 2, kw // 2))  # [N, cin*kh*kw, H*W]
    wmat = w.permute(2, 0, 1, 3).reshape(-1, cout)
    y = patches.transpose(1, 2).reshape(n * hh * ww, -1) @ wmat + b  # NHWC rows
    y = F.relu(y).reshape(n, hh, ww, cout).permute(0, 3, 1, 2)
    return F.max_pool2d(y, 2, 2, ceil_mode=True)


# Which conv stages run as patches-matmuls, per mode (index = stage).
CONV_MATMUL_MODES: dict[str, tuple[bool, bool, bool, bool]] = {
    "none": (False, False, False, False),
    "first": (True, False, False, False),  # the cin = 1 stage
    "tail": (False, False, True, True),  # the small-spatial stages (7x7, 4x4)
    "first+tail": (True, False, True, True),
    "all": (True, True, True, True),
}


def apply_fn(
    params: Params,
    x: torch.Tensor,
    *,
    dropout_gen: torch.Generator | None = None,
    keep_prob: float = 0.5,
    compute_dtype: torch.dtype | None = None,
    first_conv_matmul: bool = False,
    conv_matmul: str | None = None,
) -> torch.Tensor:
    """Forward pass: ``[N, 784]`` -> fp32 logits ``[N, 10]``.

    ``dropout_gen=None`` disables dropout (eval). With a generator the two
    dropout sites draw two independent masks from it, matching the
    reference's two ``tf.nn.dropout`` calls (model.py:74,82).
    ``compute_dtype`` casts the parameters and ``x`` (their gradients come
    back in the parameters' own dtype). ``conv_matmul`` names which conv
    stages run as patches-matmuls (:data:`CONV_MATMUL_MODES`);
    ``first_conv_matmul=True`` is the older alias of ``"first"``.
    """
    if conv_matmul is None:
        conv_matmul = "first" if first_conv_matmul else "none"
    as_matmul = CONV_MATMUL_MODES[conv_matmul]
    if compute_dtype is not None:
        params = {k: p.to(compute_dtype) for k, p in params.items()}
        x = x.to(compute_dtype)
    h = x.reshape(-1, 1, 28, 28)  # NHWC with C=1 is NCHW with C=1
    for stage, (wn, bn) in enumerate((("v0", "v1"), ("v2", "v3"), ("v4", "v5"), ("v6", "v7"))):
        block = _patches_block if as_matmul[stage] else _conv_block
        h = block(h, params[wn], params[bn])
    # JAX flattens NHWC: channels fastest.
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], params["v8"].shape[0])
    h = F.relu(h @ params["v8"] + params["v9"])
    h = _dropout(h, dropout_gen, keep_prob)
    h = h @ params["v10"] + params["v11"]  # no activation (model.py:79)
    h = _dropout(h, dropout_gen, keep_prob)
    return (h @ params["v12"] + params["v13"]).float()


def loss_fn(
    params: Params,
    x: torch.Tensor,
    y_onehot: torch.Tensor,
    *,
    dropout_gen: torch.Generator | None = None,
    keep_prob: float = 0.5,
    compute_dtype: torch.dtype | None = None,
    first_conv_matmul: bool = False,
    conv_matmul: str | None = None,
) -> torch.Tensor:
    """Mean softmax cross-entropy (model.py:91-92)."""
    logits = apply_fn(params, x, dropout_gen=dropout_gen, keep_prob=keep_prob,
                      compute_dtype=compute_dtype, first_conv_matmul=first_conv_matmul,
                      conv_matmul=conv_matmul)
    logprobs = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(y_onehot * logprobs, dim=-1))


def correct_count(params: Params, x: torch.Tensor, y_onehot: torch.Tensor) -> torch.Tensor:
    """Number of top-1 hits, as a device tensor (eval mode, no dropout)."""
    logits = apply_fn(params, x)
    return torch.sum(torch.argmax(logits, dim=-1) == torch.argmax(y_onehot, dim=-1))


class MnistCNN(nn.Module):
    """The CNN as an ``nn.Module`` over a ``ParameterDict`` ``v0..v13`` in
    the JAX storage layout; ``forward`` is :func:`apply_fn`."""

    def __init__(self, params: Params):
        super().__init__()
        # A list of pairs keeps v0..v13 in creation order (a plain dict
        # would be sorted by name).
        self.params = nn.ParameterDict(
            [(k, nn.Parameter(v.detach().clone())) for k, v in params.items()]
        )

    def forward(
        self,
        x: torch.Tensor,
        dropout_gen: torch.Generator | None = None,
        keep_prob: float = 0.5,
    ) -> torch.Tensor:
        return apply_fn(self.params, x, dropout_gen=dropout_gen, keep_prob=keep_prob)
