"""Decoder-LM training — the port of ``ddl_tpu/strategies/seq.py`` for one
device and scheme ``full``.

The JAX trainer runs the decoder LM (``models/transformer.py``) over a 2-D
``[data_parallel, num_workers]`` mesh with the sequence sharded across it
(ring or Ulysses attention), tensor and pipeline parallelism and ZeRO-1.
This slice ports its single-device form: ``scheme="full"``,
``num_workers=1``, the replicated TF1-Adam update (``_step_body``), with
``attn_impl="xla"`` (plain attention, ``parallel/ring.py``) or ``"flash"``
(the hand-written CUDA flash kernels, ``ops/flash_attention.py``; their
plain version on the CPU). The span loop, eval cadence and early stop are
the JAX trainer's (``train/trainer.py::eval_spans``); each span is a host
loop of eager steps closed by a device barrier.

``SeqConfig`` keeps every JAX field and default. A value that needs what is
not ported raises ``NotImplementedError`` naming its ROADMAP item, and the
JAX trainer's own checks raise the same ``ValueError``s.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Literal

import numpy as np
import torch

from .. import precision as _precision
from ..convert import lm_params_from_numpy, lm_params_to_numpy
from ..data.lm import LMDataset
from ..models import transformer
from ..models.transformer import LMSpec
from ..ops import flash_attention
from ..ops.optimizers import AdamState, adam_init, adam_update
from ..parallel.mesh import default_device
from ..parallel.ring import full_attention
from ..train.trainer import eval_spans, hit_target
from ..utils import tree
from ..utils.metrics import StepStats, StepTimer, barrier

Scheme = Literal["ring", "ulysses", "full"]

# What is left of the LM trainer, in ROADMAP.md.
ROADMAP_LM = "ROADMAP queue 1, item 3 (LM training beyond one card)"


@dataclasses.dataclass(frozen=True)
class SeqConfig:
    """The JAX package's ``SeqConfig``: same fields, same defaults (the
    default scheme ``ring`` is not ported yet; pass ``scheme="full"``)."""

    epochs: int = 1
    batch_size: int = 8  # sequences per global batch
    learning_rate: float = 1e-3
    eval_every: int = 10  # batches between test-set evals (0 = end only)
    seed: int = 0
    num_workers: int = 1  # sequence-parallel degree
    data_parallel: int = 1
    tensor_parallel: int = 1
    scheme: Scheme = "ring"
    compute_dtype: str | None = None  # None = fp32; "bfloat16" = bf16 compute
    precision: str | None = None  # "fp32"; "bf16" is not ported yet
    target_accuracy: float | None = None
    zero1: bool = False
    # Local attention: "xla" = plain attention (materialises [B, H, T, T]
    # scores); "flash" = the CUDA flash kernels (their plain version on the
    # CPU).
    attn_impl: Literal["xla", "flash"] = "xla"
    # Recompute each block in the backward pass (torch.utils.checkpoint).
    remat: bool = False
    seq_layout: Literal["contiguous", "zigzag"] = "contiguous"
    pipeline_parallel: int = 1
    microbatches: int = 1
    pipeline_schedule: Literal["gpipe", "1f1b"] = "gpipe"
    spec: LMSpec = LMSpec()

    def policy(self) -> _precision.PrecisionPolicy:
        return _precision.resolve(self.precision, self.compute_dtype)

    def dtype(self) -> torch.dtype | None:
        return self.policy().compute_dtype


@dataclasses.dataclass
class LMResult:
    """The JAX ``LMResult`` without the fields of features not ported yet
    (resume, preemption, the non-finite guard), plus the span losses."""

    params: dict  # numpy tree, JAX layout
    final_accuracy: float  # weighted next-token accuracy on the test set
    final_loss: float
    wall_time_s: float
    train_time_s: float  # span time only; evals and warm-up excluded
    history: list[tuple[int, int, float]]  # (epoch, batch, accuracy)
    tokens_per_sec: float  # scored + unscored tokens (B * T) / train_time_s
    compile_time_s: float = 0.0  # warm-up before the clock, kernel build included
    step_stats: StepStats | None = None
    span_losses: list[float] = dataclasses.field(default_factory=list)  # last loss per span


def _attn_for(config: SeqConfig) -> Callable:
    """The attention closure for this config — always causal (decoder LM)."""
    if config.attn_impl not in ("xla", "flash"):
        raise ValueError(f"unknown attn_impl {config.attn_impl!r}")
    flash = config.attn_impl == "flash"
    if flash and config.scheme == "ring":
        raise ValueError(
            "attn_impl='flash' supports schemes full and ulysses; the ring's "
            "travelling-block softmax state cannot route through the flash kernel"
        )
    if config.scheme == "full":
        if config.num_workers != 1:
            raise ValueError("scheme='full' cannot shard the sequence; "
                             "use ring or ulysses for num_workers > 1")
        if flash:
            return functools.partial(flash_attention.flash_attention_bthd, causal=True)
        return functools.partial(full_attention, causal=True)
    if config.scheme in ("ring", "ulysses"):
        raise NotImplementedError(
            f"scheme={config.scheme!r} is not ported yet ({ROADMAP_LM}); "
            "use scheme='full' on one device"
        )
    raise ValueError(f"unknown scheme {config.scheme!r}")


def _check_slice(config: SeqConfig) -> None:
    """Raise for what the JAX trainer supports and the port does not yet."""
    for name in ("num_workers", "data_parallel", "tensor_parallel", "pipeline_parallel",
                 "microbatches"):
        if getattr(config, name) < 1:
            raise ValueError(f"{name} must be >= 1, got {getattr(config, name)}")
    todo = [
        (config.num_workers > 1, f"num_workers={config.num_workers} (sequence parallelism)"),
        (config.data_parallel > 1, f"data_parallel={config.data_parallel}"),
        (config.tensor_parallel > 1, f"tensor_parallel={config.tensor_parallel}"),
        (config.pipeline_parallel > 1 or config.microbatches > 1,
         f"pipeline_parallel={config.pipeline_parallel}, microbatches={config.microbatches}"),
        (config.zero1, "zero1 (the ZeRO-1 LM update)"),
        (config.seq_layout != "contiguous", f"seq_layout={config.seq_layout!r}"),
    ]
    for bad, what in todo:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet ({ROADMAP_LM})")


def _local_loss_fn(config: SeqConfig, attn, tokens, targets, weights):
    """The loss the train step differentiates: the batch's scored-token CE
    sum over its weight total."""

    def local_loss(p):
        num, den = transformer.lm_loss_sums(
            p, tokens, targets, weights, config.spec, attn_fn=attn,
            compute_dtype=config.dtype(), remat=config.remat,
        )
        return num / den

    return local_loss


def _step_body(config: SeqConfig) -> Callable:
    """One train step: ``(params, opt_state, tokens, targets, weights) ->
    (params', opt_state', loss)`` — loss and the gradient of every leaf by
    autograd, then TF1 Adam over the tree."""
    attn = _attn_for(config)

    def step(params, opt_state: AdamState, tokens, targets, weights):
        leaves = tree.map(lambda t: t.detach().requires_grad_(True), params)
        loss = _local_loss_fn(config, attn, tokens, targets, weights)(leaves)
        grads = tree.unflatten(leaves, torch.autograd.grad(loss, tree.leaves(leaves)))
        with torch.no_grad():
            params, opt_state = adam_update(params, opt_state, grads, lr=config.learning_rate)
        return params, opt_state, loss.detach()

    return step


class SeqTrainer:
    """LM trainer on one device (``cuda`` unless ``device="cpu"``). ``init``
    is a numpy parameter tree in the JAX layout (e.g. a JAX init); without
    it, a glorot init from ``config.seed``."""

    def __init__(
        self,
        config: SeqConfig,
        dataset: LMDataset,
        init: dict | None = None,
        device: str | torch.device | None = None,
    ):
        _attn_for(config)  # unknown attn_impl / scheme; full with sharding
        _check_slice(config)
        config.policy()  # precision="bf16" raises; unknown dtypes are ValueErrors
        # Both splits: an out-of-range id would index past the embedding.
        for name, toks in (("train", dataset.tokens), ("test", dataset.test_tokens)):
            if toks.size and toks.max() >= config.spec.vocab:
                raise ValueError(
                    f"{name} vocab {toks.max() + 1} exceeds model vocab {config.spec.vocab}"
                )
        if dataset.num_train // config.batch_size == 0:
            raise ValueError(
                f"batch_size {config.batch_size} exceeds {dataset.num_train} train sequences"
            )
        self.config = config
        self.dataset = dataset
        self.device = default_device(device)
        if init is not None:
            self.params = lm_params_from_numpy(init, config.spec, self.device)
        else:
            self.params = transformer.init_lm_params(
                torch.Generator().manual_seed(config.seed), config.spec, self.device
            )
        self.opt_state = adam_init(self.params)

    def stage_batches(self, arr: np.ndarray, batches: int, bs: int) -> torch.Tensor:
        """``batches`` x ``bs`` rows of ``arr`` as a ``[nb, B, T]`` tensor on
        the device (token ids as int64)."""
        shaped = np.asarray(arr[: batches * bs]).reshape(batches, bs, arr.shape[1])
        t = torch.as_tensor(shaped)
        return (t.long() if not t.is_floating_point() else t).to(self.device)

    def span_program(self, k: int) -> Callable:
        """``(params, opt, xs, ys, ws, first) -> (params, opt, last_loss)``:
        ``k`` consecutive steps over the staged batches ``first ..
        first + k - 1``."""
        step = _step_body(self.config)

        def run(params, opt_state, xs, ys, ws, first: int):
            loss = None
            for i in range(first, first + k):
                params, opt_state, loss = step(params, opt_state, xs[i], ys[i], ws[i])
            return params, opt_state, loss

        return run

    @torch.no_grad()
    def evaluate(self, params, tokens, targets, weights) -> float:
        """Weighted next-token accuracy over the test set, in chunks of
        ``batch_size`` sequences; the ``(hits, weight)`` sums add up on the
        device and reach the host in one fetch."""
        cfg = self.config
        attn = _attn_for(cfg)
        num = torch.zeros((), device=tokens.device)
        den = torch.zeros((), device=tokens.device)
        for i in range(0, tokens.shape[0], cfg.batch_size):
            n, d = transformer.lm_correct_sums(
                params, tokens[i:i + cfg.batch_size], targets[i:i + cfg.batch_size],
                weights[i:i + cfg.batch_size], cfg.spec, attn_fn=attn,
                compute_dtype=cfg.dtype(),
            )
            num += n
            den += d
        return float(num / den)

    def _warm_up(self, params, opt_state, xs, ys, ws) -> None:
        """Outside the clock (where the JAX trainer compiles): one discarded
        train step of this config on the first batch, which builds the
        flash kernels (flash on CUDA), loads cuBLAS and PyTorch's kernels
        and sizes the allocator. It launches each flash kernel once per
        layer. The step is functional: ``params`` and ``opt_state`` are not
        changed."""
        _step_body(self.config)(params, opt_state, xs[0], ys[0], ws[0])
        barrier(self.device)

    def train(self, log: Callable[[str], None] = print) -> LMResult:
        cfg, ds, dev = self.config, self.dataset, self.device
        bs = cfg.batch_size
        batch_num = ds.num_train // bs
        xs = self.stage_batches(ds.tokens, batch_num, bs)
        ys = self.stage_batches(ds.targets, batch_num, bs)
        ws = self.stage_batches(ds.weights, batch_num, bs)
        n_test = ds.test_tokens.shape[0]
        xte, yte, wte = (self.stage_batches(a, 1, n_test)[0]
                         for a in (ds.test_tokens, ds.test_targets, ds.test_weights))
        params = tree.map(torch.clone, self.params)
        opt_state = AdamState(step=self.opt_state.step.clone(),
                              m=tree.map(torch.clone, self.opt_state.m),
                              v=tree.map(torch.clone, self.opt_state.v))
        spans = eval_spans(batch_num, cfg.eval_every)
        fns = {k: self.span_program(k) for k in {k for _, k, _ in spans}}
        t0 = time.perf_counter()
        self._warm_up(params, opt_state, xs, ys, ws)
        warmup = time.perf_counter() - t0

        timer = StepTimer()
        history: list[tuple[int, int, float]] = []
        span_losses: list[float] = []
        accuracy = loss = float("nan")
        tokens_per_batch = bs * ds.seq_len
        hit = False
        epoch = 0  # epochs=0: eval-only run
        start = time.perf_counter()
        for epoch in range(cfg.epochs):
            for first, k, eval_after in spans:
                with timer.step(images=k * tokens_per_batch):
                    params, opt_state, l_dev = fns[k](params, opt_state, xs, ys, ws, first)
                    barrier(dev)
                loss = float(l_dev)
                span_losses.append(loss)
                if eval_after:
                    accuracy = self.evaluate(params, xte, yte, wte)
                    history.append((epoch, first + k - 1, accuracy))
                    log(f"epoch {epoch} batch {first + k - 1} "
                        f"loss {loss:.4f} test_accuracy {accuracy:.4f}")
                    hit = hit_target(cfg, accuracy)
                if hit:
                    break
            if hit:
                log(f"target accuracy {cfg.target_accuracy} reached")
                break
        wall = time.perf_counter() - start
        if not (history and history[-1][:2] == (epoch, batch_num - 1)) and not hit:
            accuracy = self.evaluate(params, xte, yte, wte)
            history.append((epoch, batch_num - 1, accuracy))
        stats = timer.stats()
        log(f"final test_accuracy {accuracy:.4f} loss {loss:.4f} "
            f"({stats.tokens_per_sec:.0f} tokens/s)")
        self.params, self.opt_state = params, opt_state
        return LMResult(
            params=lm_params_to_numpy(params),
            final_accuracy=accuracy,
            final_loss=loss,
            wall_time_s=wall,
            train_time_s=stats.total_s,
            history=history,
            tokens_per_sec=stats.tokens_per_sec,
            compile_time_s=warmup,
            step_stats=stats,
            span_losses=span_losses,
        )
