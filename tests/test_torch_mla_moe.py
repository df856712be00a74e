"""The latent-attention and expert block (``models/mla_moe.py``) on the CPU
at a tiny size (d 64, 4 heads of 24 + 8 q.k and 16 v dims, kv latent 16,
2 layers: one dense, one of 8 experts with 4 held, top-2, one shared),
against the benchmark's plain reference (``portbench/reference/mla_moe.py``,
written apart from the port). No JAX counterpart exists.

- Logits, loss and every leaf's gradient against the reference in fp32:
  the same mathematics in another order (the port's custom RMSNorm, SwiGLU
  and gate backward, grouped rows), so within 1e-5 relative.
- Three steps of ``SeqTrainer.step_fn`` under the bf16 policy against the
  reference's three fp32 steps taking the program's routes: losses within
  2e-2 relative, each leaf's update within 0.1 of the reference's in
  norm (bf16 activations keep about 3 digits; a step moves a leaf by
  lr-sized Adam steps whose sign flips where a gradient is near 0).
- The share: disjoint held sets' routed outputs, summed, with the shared
  expert once, are the uncut reference's layer.
- The router picks by ``s + bias`` and weighs by ``s``; skewed routing
  drops no token; the counter counts every assignment to a held expert.
- The trainer's other schemes refuse the spec; the spans appear under a
  profiler, the backward's ``moe/experts`` too, and add no node without one.
- The plain flash path at ``(192, 128)`` against materialised attention,
  and the wrapper's pair rules.
- The card (``cuda`` marker, skipped here): the flash ``(192, 128)`` bf16
  instance against the plain version, and a bf16 step of the port against
  its CPU run; on the card ``python -m pytest --noconftest -m cuda
  tests/test_torch_mla_moe.py``.
"""

import dataclasses
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from ddl_tpu_torch.data.lm import LMDataset  # noqa: E402
from ddl_tpu_torch.models import mla_moe  # noqa: E402
from ddl_tpu_torch.ops import flash_attention as fa  # noqa: E402
from ddl_tpu_torch.strategies.seq import SeqConfig, SeqTrainer, _FlatPlan  # noqa: E402
from portbench.reference import mla_moe as ref  # noqa: E402

SPEC = dataclasses.replace(mla_moe.TINY_SPEC, bias_seed=2**31 + 7, bias_range=0.05)
SEED = 2**31 + 19


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dims(spec: mla_moe.MLAMoESpec) -> ref.MoEDims:
    return ref.MoEDims(vocab=spec.vocab, d_model=spec.d_model, num_heads=spec.num_heads,
                       num_layers=spec.num_layers, qk_nope_dim=spec.qk_nope_dim,
                       qk_rope_dim=spec.qk_rope_dim, v_head_dim=spec.v_head_dim,
                       kv_lora_rank=spec.kv_lora_rank, d_ff=spec.d_ff,
                       first_dense=spec.first_dense, n_experts=spec.n_experts,
                       held=spec.experts_held, top_k=spec.top_k, d_expert=spec.d_expert,
                       n_shared=spec.n_shared, routed_scale=spec.routed_scale,
                       rope_base=spec.rope_base, norm_eps=spec.norm_eps)


def init(spec, seed=SEED):
    return mla_moe.init_params(torch.Generator().manual_seed(seed), spec)


def paths(params) -> dict:
    return mla_moe._paths(params)


def batch(spec, b=2, t=24, seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, spec.vocab, size=(b, t + 1))
    return torch.as_tensor(ids[:, :-1]), torch.as_tensor(ids[:, 1:])


def bias(spec):
    return torch.from_numpy(ref.router_bias(dims(spec), spec.bias_seed, spec.bias_range))


def attn(q, k, v):
    return fa.flash_attention_bthd(q, k, v, causal=True)


def test_the_spec_counts_and_the_moonlight_share():
    assert mla_moe.MOONLIGHT_EP8.num_params() == 2_777_411_072
    assert mla_moe.MOONLIGHT_EP8.qk_dim == 192 and mla_moe.MOONLIGHT_EP8.num_moe_layers == 26
    assert sum(math.prod(s) for s in ref.leaf_shapes(dims(mla_moe.MOONLIGHT_EP8)).values()) \
        == 2_777_411_072
    assert list(ref.leaf_shapes(dims(SPEC)).items()) == list(mla_moe.leaf_paths(SPEC).items())
    assert list(mla_moe.param_shapes(SPEC)["blocks"][0]) == [*mla_moe.ATTN_LEAVES,
                                                             *mla_moe.DENSE_LEAVES]
    assert set(mla_moe.param_shapes(SPEC)["blocks"][1]) == {*mla_moe.ATTN_LEAVES,
                                                            *mla_moe.EXPERT_LEAVES}
    with pytest.raises(ValueError):
        dataclasses.replace(SPEC, experts_held=(0, 0))
    with pytest.raises(ValueError):
        dataclasses.replace(SPEC, experts_held=(8,))
    with pytest.raises(ValueError, match="does not match"):
        mla_moe.params_from_numpy({"embed": np.zeros((1, 1))}, SPEC, "cpu")


def test_logits_loss_and_every_gradient_against_the_reference_fp32():
    params = init(SPEC)
    tokens, targets = batch(SPEC)
    leaves = {k: v.clone().requires_grad_(True) for k, v in paths(params).items()}
    tree = {"embed": leaves["embed"], "lnf_g": leaves["lnf_g"], "head": leaves["head"],
            "blocks": [{k: leaves[f"blocks.{i}.{k}"] for k in blk}
                       for i, blk in enumerate(params["blocks"])]}
    logits = mla_moe.apply_lm(tree, tokens, SPEC, attn_fn=attn)
    weights = torch.ones(tokens.shape)
    num, den = mla_moe.lm_loss_sums(tree, tokens, targets, weights, SPEC, attn_fn=attn)
    got = torch.autograd.grad(num / den, list(leaves.values()))

    rp = {k: v.clone().requires_grad_(True) for k, v in paths(params).items()}
    d, b = dims(SPEC), bias(SPEC)
    want, total = [], 0.0
    for i in range(tokens.shape[0]):
        lg, _ = ref.forward(rp, tokens[i], d, b)
        want.append(lg)
        part, _ = ref.loss_sum(rp, tokens[i], targets[i], weights[i], d, b)
        (part / tokens.numel()).backward()
        total += float(part.detach()) / tokens.numel()
    torch.testing.assert_close(logits, torch.stack(want).detach(), rtol=1e-5, atol=1e-5)
    assert float(num / den) == pytest.approx(total, rel=1e-6)
    for (name, r), g in zip(rp.items(), got):
        torch.testing.assert_close(g, r.grad, rtol=1e-4, atol=1e-6, msg=name)
        assert float(g.norm()) > 0, name


def test_three_bf16_steps_of_the_trainer_against_the_reference():
    spec, d = SPEC, dims(SPEC)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, spec.vocab, size=(6, 33)).astype(np.int32)
    ones = np.ones((6, 32), np.float32)
    ds = LMDataset(tokens=ids[:, :-1], targets=ids[:, 1:], weights=ones, test_tokens=ids[:1, :-1],
                   test_targets=ids[:1, 1:], test_weights=ones[:1])
    lr = 3e-3
    cfg = SeqConfig(batch_size=2, learning_rate=lr, eval_every=0, scheme="full", attn_impl="flash",
                    precision="bf16", spec=spec)
    tr = SeqTrainer(cfg, ds, init=mla_moe.tree.map(lambda t: t.numpy(), init(spec)),
                    device="cpu")
    step = tr.step_fn()
    xs, ys, ws = (tr.stage_batches(a, 3, 2) for a in (ds.tokens, ds.targets, ds.weights))
    p, o, losses, routes = tr.params, tr.opt_state, [], []
    for i in range(3):
        with mla_moe.recording_routes() as chosen:
            p, o, loss = step(p, o, xs[i], ys[i], ws[i])[:3]
        routes.append(torch.stack(chosen))
        losses.append(float(loss))
    batches = [(xs[i], ys[i], ws[i]) for i in range(3)]
    follow, agreement = ref.follow(lambda: {k: v.clone() for k, v in paths(init(spec)).items()},
                                   batches, d, lr, bias(spec), routes=routes)
    assert losses == pytest.approx(follow.losses, rel=2e-2)
    assert len(agreement) == spec.num_moe_layers and 0.9 <= min(agreement) <= 1.0
    p0 = paths(init(spec))
    for name, leaf in paths(p).items():
        moved = float((leaf - p0[name]).norm())
        assert moved == pytest.approx(follow.change_norms[name], rel=0.1), name


def expert_inputs(spec, n=40, seed=11):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, spec.d_model, generator=g)
    blk = init(spec)["blocks"][spec.first_dense]
    return x, blk


def test_disjoint_shares_add_up_to_the_uncut_layer():
    full = dataclasses.replace(SPEC, experts_held=tuple(range(8)))
    x, blk = expert_inputs(full)
    shared = mla_moe.swiglu(x @ blk["sw1"], x @ blk["sw3"]) @ blk["sw2"]
    total = -shared
    for held in ((0, 2, 5, 7), (1, 3, 4, 6)):
        part = dataclasses.replace(full, experts_held=held)
        pblk = dict(blk, **{k: blk[k][list(held)] for k in ("w1", "w3", "w2")})
        total = total + mla_moe.expert_layer(x, pblk, part, 0)
    want, _ = ref._experts(x, blk, dims(full), bias(full)[0], None, False)
    torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-5)


def test_the_router_picks_by_score_plus_bias_and_weighs_by_score():
    spec = dataclasses.replace(SPEC, top_k=3)
    x, blk = expert_inputs(spec, n=64)
    s = torch.sigmoid(x @ blk["router"])
    b = torch.zeros(spec.n_experts)
    b[5] = 2.0  # expert 5 always chosen by the bias, never by its score alone
    chosen, w = mla_moe.route(x, blk["router"], b, spec)
    assert (chosen == 5).any(-1).all()
    torch.testing.assert_close(torch.sort(chosen, -1).values,
                               torch.sort(torch.topk(s + b, 3, -1).indices, -1).values)
    want = s.gather(-1, chosen)
    torch.testing.assert_close(w, spec.routed_scale * want / want.sum(-1, keepdim=True))
    assert not torch.equal(torch.sort(chosen, -1).values,
                           torch.sort(torch.topk(s, 3, -1).indices, -1).values)


def test_recorded_router_rows_route_again_to_the_same_choices():
    params = init(SPEC)
    tokens, _ = batch(SPEC, b=4, t=32)
    rows: list = []
    with mla_moe.recording_routes(rows) as chosen:
        mla_moe.apply_lm(params, tokens, SPEC, attn_fn=attn, compute_dtype=torch.bfloat16)
    assert len(rows) == len(chosen) == SPEC.num_moe_layers
    assert rows[0].dtype == torch.bfloat16 and rows[0].shape == (4 * 32, SPEC.d_model)
    routers = [blk["router"] for blk in params["blocks"][SPEC.first_dense:]]
    d, b = dims(SPEC), bias(SPEC)
    assert ref.router_replay(rows, routers, b, chosen, d) == [1.0] * SPEC.num_moe_layers
    assert min(ref.router_replay(rows, routers, torch.zeros_like(b), chosen, d)) < 0.99
    with mla_moe.recording_routes() as again:  # rows only when asked for
        mla_moe.apply_lm(params, tokens, SPEC, attn_fn=attn, compute_dtype=torch.bfloat16)
    assert len(again) == SPEC.num_moe_layers and len(rows) == SPEC.num_moe_layers


def test_skewed_routing_drops_no_token_and_is_counted():
    spec = dataclasses.replace(SPEC, bias_seed=2**31 + 99, bias_range=0.0)
    x, blk = expert_inputs(spec, n=50)
    b = torch.zeros(spec.n_experts)
    b[[0, 1]] = 10.0  # every token on held experts 0 and 1
    counter = mla_moe.assignment_counter(spec, "cpu")
    counter.zero_()
    mla_moe._BUFFERS[("bias", spec.bias_seed, 0.0, spec.num_moe_layers, spec.n_experts,
                      "cpu")] = b[None]
    try:
        out = mla_moe.expert_layer(x, blk, spec, 0)
    finally:
        del mla_moe._BUFFERS[("bias", spec.bias_seed, 0.0, spec.num_moe_layers,
                              spec.n_experts, "cpu")]
    assert counter[0].tolist() == [50, 50, 0, 0]
    want, _ = ref._experts(x, blk, dims(spec), b, None, False)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", [dict(tensor_parallel=2), dict(pipeline_parallel=2, microbatches=2),
                                 dict(scheme="ring"), dict(scheme="ulysses"),
                                 dict(num_workers=2, scheme="ring"), dict(zero1=True),
                                 dict(zero1=True, tensor_parallel=2)],
                         ids=["tp", "pp", "ring", "ulysses", "sp2", "zero1", "hybrid"])
def test_other_schemes_refuse_the_spec(bad):
    ids = np.zeros((4, 16), np.int32)
    ds = LMDataset(tokens=ids, targets=ids, weights=np.ones((4, 16), np.float32),
                   test_tokens=ids[:1], test_targets=ids[:1],
                   test_weights=np.ones((1, 16), np.float32))
    with pytest.raises(ValueError, match="MLA \\+ MoE block"):
        SeqTrainer(SeqConfig(batch_size=2, spec=SPEC, **{"scheme": "full", **bad}), ds,
                   device="cpu")


def test_spans_under_a_profiler_and_none_without():
    from torch.profiler import profile

    params = init(SPEC)
    tokens, targets = batch(SPEC, b=1, t=16)
    leaves = [v.requires_grad_(True) for v in paths(params).values()]

    def step():
        num, den = mla_moe.lm_loss_sums(params, tokens, targets, torch.ones(tokens.shape), SPEC,
                                        attn_fn=attn)
        torch.autograd.grad(num / den, leaves)
        return num

    num = step()
    seen, fn = [], num.grad_fn
    stack = [fn]
    while stack:  # no span edge in the graph outside a session
        f = stack.pop()
        if f is None or f in seen:
            continue
        seen.append(f)
        assert "SpanEdge" not in type(f).__name__
        stack.extend(g for g, _ in f.next_functions)
    with profile() as prof:
        step()
    names = [e.name for e in prof.events()]
    assert names.count("moe/route") == SPEC.num_moe_layers
    assert names.count("moe/experts") == 2 * SPEC.num_moe_layers  # forward and backward


@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_at_192_128_against_materialised_attention(causal):
    g = torch.Generator().manual_seed(int(causal))
    q, k = (torch.randn(2, 20, 3, 192, generator=g).requires_grad_(True) for _ in range(2))
    v = torch.randn(2, 20, 3, 128, generator=g).requires_grad_(True)
    r = torch.randn(2, 20, 3, 128, generator=g)
    out = fa.flash_attention_bthd(q, k, v, causal=causal)
    assert out.shape == (2, 20, 3, 128)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(192)
    if causal:
        s = s.masked_fill(torch.ones(20, 20, dtype=torch.bool).triu(1), float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    grads = torch.autograd.grad((out * r).sum(), (q, k, v))
    wgrads = torch.autograd.grad((want * r).sum(), (q, k, v))
    for a, b in zip(grads, wgrads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    scale = 1 / math.sqrt(192)
    o, lse = fa.flash_fwd_reference(q, k, v, causal, scale)
    delta = fa.attention_delta(o, r)
    dk, dv = fa.flash_bwd_dkv_reference(q, k, v, r, lse, delta, causal, scale)
    dq = fa.flash_bwd_dq_reference(q, k, v, r, lse, delta, causal, scale)
    for a, b in zip((dq, dk, dv), wgrads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_the_wrapper_takes_unequal_v_and_refuses_other_shapes():
    q = torch.zeros(1, 4, 2, 192)
    with pytest.raises(ValueError, match="q and k alike"):
        fa.flash_attention_bthd(q, torch.zeros(1, 4, 2, 128), torch.zeros(1, 4, 2, 128))
    with pytest.raises(ValueError, match="q and k alike"):
        fa.flash_attention_bthd(q, q, torch.zeros(1, 5, 2, 128))
    assert (192, 128) in fa.DIM_PAIRS and fa.DIM_PAIRS[(192, 128)] == (torch.bfloat16,)
    with pytest.raises(ValueError, match="no torch.float32 instance|take"):
        fa._launch("fwd", "ddl_flash_fwd", (), q, torch.zeros(1, 4, 2, 128), True, 1.0)


def test_the_flat_plan_keeps_no_parameter_memory():
    plan = _FlatPlan(init(SPEC))
    assert all(t.device.type == "meta" for t in mla_moe.tree.leaves(plan.like))
    flat = torch.arange(plan.total, dtype=torch.float32)
    back = plan.unflatten(flat)
    assert back["blocks"][1]["w1"].shape == (4, 64, 32)


@pytest.mark.cuda
def test_card_flash_192_128_against_the_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the (192, 128) instance is a CUDA kernel")
    dev = torch.device("cuda")
    for shape, causal in (((1, 200, 2), True), ((2, 1000, 4), False), ((1, 2048, 16), True)):
        g = torch.Generator(device=dev).manual_seed(sum(shape))
        q, k = (torch.randn(*shape, 192, generator=g, device=dev).bfloat16() for _ in range(2))
        v, r = (torch.randn(*shape, 128, generator=g, device=dev).bfloat16() for _ in range(2))
        got = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fa.flash_attention_bthd(*got, causal=causal)
        (out.float() * r.float()).sum().backward()
        want = [t.float().requires_grad_(True) for t in (q, k, v)]
        wout = fa.flash_attention_reference(*want, causal=causal)
        (wout * r.float()).sum().backward()
        torch.testing.assert_close(out.float(), wout, atol=2e-3, rtol=1e-2)
        for a, b in zip(got, want):
            torch.testing.assert_close(a.grad.float(), b.grad, atol=1e-2, rtol=1e-2)


@pytest.mark.cuda
def test_card_bf16_steps_against_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = dataclasses.replace(SPEC, d_model=128, num_heads=2, qk_nope_dim=128, qk_rope_dim=64,
                               v_head_dim=128, kv_lora_rank=64, d_ff=256, d_expert=64)
    tokens, targets = batch(spec, b=2, t=64)
    losses = {}
    for dev in ("cpu", "cuda"):
        params = mla_moe.params_from_numpy(mla_moe.tree.map(lambda t: t.numpy(), init(spec)),
                                           spec, dev)
        num, den = mla_moe.lm_loss_sums(params, tokens.to(dev), targets.to(dev),
                                        torch.ones(tokens.shape, device=dev), spec,
                                        attn_fn=attn, compute_dtype=torch.bfloat16)
        losses[dev] = float(num / den)
    assert losses["cuda"] == pytest.approx(losses["cpu"], rel=2e-2)
