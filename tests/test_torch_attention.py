"""Attention in the port against the JAX package.

- ``flash_attention_bthd`` on the CPU (the plain version: materialised fp32
  scores, autograd gradients) against
  ``ddl_tpu.ops.attention.flash_attention_bthd``, which off the TPU runs the
  bundled kernel's pure-JAX reference, as tests/test_lm.py runs it, at
  ``[2, 64, 4, 16]`` and a ragged ``[2, 72, 2, 32]``, causal and not. Both
  sides do the same fp32 arithmetic in another order: forward within atol
  2e-6 / rtol 1e-5, dq/dk/dv of ``sum(O * R)`` within atol 1e-5 / rtol 1e-4.
  bf16 inputs keep their type and stay within 5e-2 of the fp32 oracle (bf16
  keeps about 3 significant digits).
- The plain versions of the three kernels (``flash_fwd_reference``,
  ``flash_bwd_dkv_reference``, ``flash_bwd_dq_reference``) against autograd
  of the plain attention: the kernels' function, checked where it can run.
- ``full_attention`` (``attn_impl="xla"``) against
  ``ddl_tpu.parallel.ring.full_attention``, with shard offsets.
- The wrapper's rules: the CPU path never builds or launches, an
  unsupported head dim and a non-CUDA tensor raise at the kernel.
- The backward kernels' arithmetic, rehearsed in torch: dK/dV/dQ from
  products split into TF32 parts ("3xTF32", as the kernels run them on the
  tensor cores) hold the fp32 gradient tolerance; one TF32 pass is at
  least 10x further off. In bf16 (one bf16 pass a product, P through exp2
  with one fma, P and dS rounded to bf16, a fresh fp32 accumulator an
  inner tile) they hold chip_smoke.py's bf16 gradient tolerance.
- The forward kernel's arithmetic, rehearsed in torch: key tiles of 64, an
  online softmax in base 2 with a running max and sum, each tile's P V in a
  fresh accumulator added to the rescaled O in fp32; fp32 products in 3
  TF32 passes (one pass at least 10x further off), bf16 with S in one pass
  and P in two bf16 parts. O and LSE hold chip_smoke.py's O tolerance.
- Every kernel wrapper hands its kernel 16-byte aligned operands.
- The CUDA kernels against their plain versions on the card, and the
  kernels bit-equal on a repeat: marked
  ``cuda``, skipped without a card. They need no JAX, so on the card they
  run with ``python -m pytest --noconftest -m cuda tests/test_torch_attention.py``.
"""

import math
import shutil
import types

import numpy as np
import pytest
import torch

from ddl_tpu_torch.ops import build, flash_attention as fa
from ddl_tpu_torch.parallel.ring import full_attention

FWD_TOL = dict(atol=2e-6, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)
# The kernels' gradients against their plain versions in fp32 (the card's
# gate; chip_smoke.py's flash_kernel phase uses the same).
KERNEL_GRAD_TOL = dict(atol=1e-4, rtol=1e-3)
# The same in bf16 (chip_smoke.py's FLASH_TOL["bfloat16"] for the gradients).
KERNEL_GRAD_TOL_BF16 = dict(atol=1e-2, rtol=1e-2)
# The forward kernel's O (and LSE) against the plain version, by input type
# (chip_smoke.py's FLASH_TOL).
KERNEL_O_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-4),
                torch.bfloat16: dict(atol=2e-3, rtol=1e-2)}
SHAPES = [(2, 64, 4, 16), (2, 72, 2, 32)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported here so that the card-only tests need no JAX."""
    import jax
    import jax.numpy as jnp

    from ddl_tpu.ops.attention import flash_attention_bthd
    from ddl_tpu.parallel import ring

    return types.SimpleNamespace(jax=jax, jnp=jnp, flash=flash_attention_bthd, ring=ring)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]  # q, k, v, R


def _torch_value_and_grads(fn, q, k, v, r):
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in (q, k, v)]
    out = fn(*ts)
    (out.float() * torch.from_numpy(r)).sum().backward()
    return out.detach(), [t.grad for t in ts]


def _jax_value_and_grads(jx, fn, q, k, v, r):
    loss = lambda q, k, v: (fn(q, k, v).astype(jx.jnp.float32) * r).sum()  # noqa: E731
    # jit: one compile instead of one per op (seconds on the CPU).
    out, grads = jx.jax.jit(
        lambda q, k, v: (fn(q, k, v), jx.jax.grad(loss, argnums=(0, 1, 2))(q, k, v)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_attention_matches_jax(shape, causal, jx):
    q, k, v, r = _inputs(shape, seed=shape[1] + causal)
    got, got_g = _torch_value_and_grads(
        lambda q, k, v: fa.flash_attention_bthd(q, k, v, causal=causal), q, k, v, r)
    want, want_g = _jax_value_and_grads(
        jx, lambda q, k, v: jx.flash(q, k, v, causal=causal), q, k, v, r)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    for name, a, b in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(a.numpy(), b, err_msg=f"d{name}", **GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_keeps_dtype_near_fp32_oracle(causal, jx):
    q, k, v, _ = _inputs(SHAPES[0], seed=3)
    oracle = np.asarray(jx.ring.full_attention(q, k, v, causal=causal))
    got = fa.flash_attention_bthd(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), oracle, **BF16_TOL)


@pytest.mark.parametrize("offsets", [(0, 0), (16, 0), (0, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_full_attention_matches_jax(causal, offsets, jx):
    q, k, v, r = _inputs((2, 32, 2, 16), seed=7)
    qo, ko = offsets
    got, got_g = _torch_value_and_grads(
        lambda q, k, v: full_attention(q, k, v, causal=causal, q_offset=qo, k_offset=ko),
        q, k, v, r)
    want, want_g = _jax_value_and_grads(
        jx, lambda q, k, v: jx.ring.full_attention(
            q, k, v, causal=causal, q_offset=qo, k_offset=ko), q, k, v, r)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    for name, a, b in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(a.numpy(), b, err_msg=f"d{name}", **GRAD_TOL)


def _kernel_inputs(shape, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device).to(dtype) for _ in range(4)]


def _check_kernel_functions(q, k, v, do, causal, fwd, bwd_dkv, bwd_dq, tol):
    """``fwd``/``bwd_*`` (kernels or plain versions) against autograd of the
    plain attention, in fp32 on the same values."""
    scale = 1.0 / q.shape[-1] ** 0.5
    leaves = [t.float().clone().requires_grad_(True) for t in (q, k, v)]
    want = fa.flash_attention_reference(*leaves, causal=causal)
    want_g = torch.autograd.grad(want, leaves, do.float())
    o, lse = fwd(q, k, v, causal, scale)
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    delta = fa.attention_delta(o, do)
    dk, dv = bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    dq = bwd_dq(q, k, v, do, lse, delta, causal, scale)
    fwd_tol, grad_tol = tol
    torch.testing.assert_close(o.float(), want.detach(), **fwd_tol)
    for name, a, b in zip("qkv", (dq, dk, dv), want_g):
        assert a.dtype == q.dtype
        torch.testing.assert_close(a.float(), b, msg=f"d{name}", **grad_tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES + [(1, 33, 1, 8)])
def test_plain_kernel_functions_match_autograd(shape, causal):
    q, k, v, do = _kernel_inputs(shape, torch.float32, "cpu", seed=shape[1])
    _check_kernel_functions(
        q, k, v, do, causal, fa.flash_fwd_reference, fa.flash_bwd_dkv_reference,
        fa.flash_bwd_dq_reference, (FWD_TOL, GRAD_TOL))


def test_cpu_path_never_builds_or_launches(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU path must not build or load the CUDA kernels")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(build, "nvcc_path", refuse)
    before = dict(fa.launches)
    q, k, v, _ = _kernel_inputs((1, 16, 2, 8), torch.float32, "cpu", seed=0)
    q.requires_grad_(True)
    fa.flash_attention_bthd(q, k, v, causal=True).sum().backward()
    assert fa.launches == before
    assert torch.isfinite(q.grad).all()


@pytest.mark.parametrize("shape", [(0, 16, 2, 16), (1, 0, 2, 16), (1, 16, 0, 16)])
def test_empty_tensors_launch_and_count_nothing(shape, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("nothing to compute: no kernel may be loaded or launched")

    # Past the device check, as on a card; an empty operand never reaches the library.
    monkeypatch.setattr(fa, "_device_and_stream", lambda t: (0, 0))
    monkeypatch.setattr(fa, "load_kernel", refuse)
    before = dict(fa.launches)
    q = torch.zeros(shape)
    o, lse = fa.flash_fwd(q, q, q, True, 1.0)
    delta = torch.zeros_like(lse)
    dk, dv = fa.flash_bwd_dkv(q, q, q, q, lse, delta, True, 1.0)
    dq = fa.flash_bwd_dq(q, q, q, q, lse, delta, True, 1.0)
    assert fa.launches == before
    assert o.shape == dk.shape == dv.shape == dq.shape == shape
    assert lse.shape == (shape[0], shape[2], shape[1])


def test_kernels_refuse_what_they_do_not_take():
    q, k, v, _ = _kernel_inputs((1, 16, 2, 8), torch.float32, "cpu", seed=0)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q, k, v, True, 1.0)  # D = 8 has no kernel instance
    q, k, v, _ = _kernel_inputs((1, 16, 2, 16), torch.float32, "cpu", seed=0)
    with pytest.raises(RuntimeError, match="no kernel for device cpu"):
        fa.flash_fwd(q, k, v, True, 1.0)
    with pytest.raises(ValueError, match="alike"):
        fa.flash_attention_bthd(q, k[:, :8], v)
    with pytest.raises(TypeError):
        fa.flash_attention_bthd(q.double(), k.double(), v.double())


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    if shutil.which("nvcc") or build.pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has nvcc")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, by integer ops on the bits: the kernels' rounding."""
    bits = (x.contiguous().view(torch.int32) + 0x1000) & -0x2000  # clear the low 13 bits
    return bits.view(torch.float32)


def _tf32_einsum(eq: str, a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """``einsum(eq, a, b)`` as the tensor cores take it: 3 passes, a_lo b_hi
    + a_hi b_lo + a_hi b_hi with x_hi = tf32(x), x_lo = tf32(x - x_hi); or 1
    pass, a_hi b_hi. Products of TF32 values are exact in fp32."""
    a_hi, b_hi = _tf32_rna(a), _tf32_rna(b)
    out = torch.einsum(eq, a_hi, b_hi)
    if passes == 3:
        a_lo, b_lo = _tf32_rna(a - a_hi), _tf32_rna(b - b_hi)
        out = torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo) + out
    return out


def _tf32_backward(q, k, v, do, lse, delta, causal, scale, passes):
    """(dq, dk, dv) with every product of the backward kernels split as they
    split it: S, dP, then dV, dK, dQ from P and dS."""
    t = q.shape[1]
    s = _tf32_einsum("bqhd,bkhd->bhqk", q, k, passes) * scale
    keep = torch.ones(t, t, dtype=torch.bool).tril() if causal else torch.ones(t, t).bool()
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    dp = _tf32_einsum("bqhd,bkhd->bhqk", do, v, passes)
    ds = p * (dp - delta[..., None])
    dv = _tf32_einsum("bhqk,bqhd->bkhd", p, do, passes)
    dk = _tf32_einsum("bhqk,bqhd->bkhd", ds, q, passes) * scale
    dq = _tf32_einsum("bhqk,bkhd->bqhd", ds, k, passes) * scale
    return dq, dk, dv


def test_tf32_rna_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 2**-10 + 2**-11, -(1 + 2**-11), 1 + 2**-12, 3e38],
                     dtype=torch.float32)
    want = [1.0, 1 + 2**-10, 1 + 2**-9, -(1 + 2**-10), 1.0]
    assert _tf32_rna(x)[:5].tolist() == want  # ties (1 + 2^-11) go away from zero
    assert (_tf32_rna(x).view(torch.int32) & 0x1FFF == 0).all()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 72, 2, 32), (1, 128, 2, 64)])
def test_three_tf32_passes_hold_fp32_gradients_one_does_not(shape, causal):
    q, k, v, do = _kernel_inputs(shape, torch.float32, "cpu", seed=shape[1] + causal)
    scale = 1.0 / shape[-1] ** 0.5
    o, lse = fa.flash_fwd_reference(q, k, v, causal, scale)
    delta = fa.attention_delta(o, do)
    wk, wv = fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal, scale)
    want = (fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal, scale), wk, wv)
    three = _tf32_backward(q, k, v, do, lse, delta, causal, scale, passes=3)
    one = _tf32_backward(q, k, v, do, lse, delta, causal, scale, passes=1)
    for name, a3, a1, w in zip(("dq", "dk", "dv"), three, one, want):
        torch.testing.assert_close(a3, w, msg=lambda m: f"{name}: {m}", **KERNEL_GRAD_TOL)
        err3, err1 = float((a3 - w).abs().max()), float((a1 - w).abs().max())
        assert err1 >= 10 * err3, f"{name}: one pass {err1:.2e}, three {err3:.2e}"


def _fwd_emulated(q, k, v, causal, scale, passes=3, block=64):
    """``(o, lse)`` computed as the forward kernel computes them: key tiles
    of ``block``, an online softmax in base 2 (running max m of S c and sum
    l, P = 2^(S c - m), alpha = 2^(m_old - m), c = scale log2 e), each
    tile's P V in a fresh accumulator added to
    alpha O in fp32, O / l and LSE = m ln 2 + log l at the end. fp32: S and
    P V from TF32 parts (``passes`` 3 or 1). bf16: S in one pass (products
    of bf16 values are exact), P V with P as bf16 hi + lo."""
    t = q.shape[1]
    bf16 = q.dtype == torch.bfloat16
    qf, kf, vf = (x.float() for x in (q, k, v))
    c = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    m = torch.full((q.shape[0], q.shape[2], t), -math.inf)
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape[0], q.shape[2], t, q.shape[3])
    for n0 in range(0, t, block):
        ks, vs = kf[:, n0:n0 + block], vf[:, n0:n0 + block]
        if bf16:
            s = torch.einsum("bqhd,bkhd->bhqk", qf, ks)
        else:
            s = _tf32_einsum("bqhd,bkhd->bhqk", qf, ks, passes)
        if causal:
            keys = torch.arange(n0, n0 + ks.shape[1])
            s = s.masked_fill(keys[None, :] > torch.arange(t)[:, None], -math.inf)
        m_new = torch.maximum(m, (s * c).amax(-1))
        ref = torch.where(m_new == -math.inf, 0.0, m_new)
        alpha = torch.exp2(m - ref)
        # The kernel's fma: S c - m with one rounding.
        p = torch.exp2((s.double() * c.double() - ref.double()[..., None]).float())
        l = alpha * l + p.sum(-1)
        if bf16:
            p_hi = p.bfloat16().float()
            p_lo = (p - p_hi).bfloat16().float()
            x = (torch.einsum("bhqk,bkhd->bhqd", p_lo, vs)
                 + torch.einsum("bhqk,bkhd->bhqd", p_hi, vs))
        else:
            x = _tf32_einsum("bhqk,bkhd->bhqd", p, vs, passes)
        o = alpha[..., None] * o + x
        m = m_new
    o = o / l[..., None]
    return o.transpose(1, 2).to(q.dtype), m * math.log(2) + torch.log(l)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 72, 2, 32), (1, 160, 2, 64)])
def test_forward_kernel_arithmetic_holds_the_o_tolerance(shape, causal, dtype):
    q, k, v, _ = _kernel_inputs(shape, dtype, "cpu", seed=shape[1] + causal)
    scale = 1.0 / shape[-1] ** 0.5
    want_o, want_lse = fa.flash_fwd_reference(q.float(), k.float(), v.float(), causal, scale)
    o, lse = _fwd_emulated(q, k, v, causal, scale)
    assert o.dtype == dtype
    tol = KERNEL_O_TOL[dtype]
    torch.testing.assert_close(o.float(), want_o, **tol)
    torch.testing.assert_close(lse, want_lse, **tol)
    if dtype == torch.float32:
        one, _ = _fwd_emulated(q, k, v, causal, scale, passes=1)
        err3, err1 = float((o - want_o).abs().max()), float((one - want_o).abs().max())
        assert err1 >= 10 * err3, f"one pass {err1:.2e}, three {err3:.2e}"


def _bf16_backward_emulated(q, k, v, do, lse, delta, causal, scale):
    """(dq, dk, dv) computed as the bf16 backward kernels compute them: S
    and dP from the bf16 inputs in one pass (products of bf16 values are
    exact, sums fp32); P = 2^(S c - lse log2 e) with c = scale log2 e and
    one fma; P and dS rounded to bf16 before their products; each inner
    tile (dK/dV: chunks of 64 queries at D = 64, else 32; dQ: tiles of 64
    keys) summed in a fresh fp32 accumulator added to the running one; the
    gradients stored in bf16."""
    t, d = q.shape[1], q.shape[3]
    kv_inner, q_inner = (64 if d == 64 else 32), 64
    qf, kf, vf, of = (x.float() for x in (q, k, v, do))
    log2e = torch.tensor(math.log2(math.e), dtype=torch.float32)
    c = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    dp = torch.einsum("bqhd,bkhd->bhqk", of, vf)
    # The kernels' fma: S c - lse log2 e with one rounding.
    p = torch.exp2((s.double() * c.double() - (lse * log2e).double()[..., None]).float())
    if causal:
        p = torch.where(torch.ones(t, t, dtype=torch.bool).tril(), p, 0.0)
    ds = p * (dp - delta[..., None])
    p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()
    dq, dk, dv = (torch.zeros_like(qf) for _ in range(3))
    for i in range(0, t, kv_inner):
        rows = slice(i, i + kv_inner)
        dv = dv + torch.einsum("bhqk,bqhd->bkhd", p16[:, :, rows], of[:, rows])
        dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds16[:, :, rows], qf[:, rows])
    for i in range(0, t, q_inner):
        rows = slice(i, i + q_inner)
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds16[..., rows], kf[:, rows])
    return (dq * scale).bfloat16(), (dk * scale).bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 72, 2, 32), (1, 160, 2, 64), (1, 128, 2, 128)])
def test_bf16_backward_arithmetic_holds_the_bf16_gradient_tolerance(shape, causal):
    q, k, v, do = _kernel_inputs(shape, torch.bfloat16, "cpu", seed=shape[1] + causal)
    scale = 1.0 / shape[-1] ** 0.5
    qf, kf, vf, of = (x.float() for x in (q, k, v, do))
    o, lse = fa.flash_fwd_reference(qf, kf, vf, causal, scale)
    delta = fa.attention_delta(o, of)
    wk, wv = fa.flash_bwd_dkv_reference(qf, kf, vf, of, lse, delta, causal, scale)
    want = (fa.flash_bwd_dq_reference(qf, kf, vf, of, lse, delta, causal, scale), wk, wv)
    got = _bf16_backward_emulated(q, k, v, do, lse, delta, causal, scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), w, msg=lambda m: f"{name}: {m}",
                                   **KERNEL_GRAD_TOL_BF16)


@pytest.mark.parametrize("kernel", ["backward", "forward"])
def test_backward_operands_are_realigned_to_16_bytes(kernel, monkeypatch):
    x = torch.zeros(1 + 2 * 16 * 2 * 16)[1:].view(2, 16, 2, 16)  # 4 bytes past a boundary
    assert x.data_ptr() % 16 != 0
    y = fa._aligned16(x)
    assert y.data_ptr() % 16 == 0 and torch.equal(x, y)
    z = torch.zeros(2, 16, 2, 16)
    assert fa._aligned16(z) is z
    # What each wrapper hands its kernel: the q, k, v (and dO) it staged.
    staged = []
    monkeypatch.setattr(fa, "_launch",
                        lambda key, name, tensors, *rest: staged.append(tensors[:4]))
    if kernel == "forward":
        fa.flash_fwd(x, x, x, True, 1.0)
        staged = [ts[:3] for ts in staged]
    else:
        lse = torch.zeros(2, 2, 16)
        fa.flash_bwd_dkv(x, x, x, x, lse, lse, True, 1.0)
        fa.flash_bwd_dq(x, x, x, x, lse, lse, True, 1.0)
    assert len(staged) == (1 if kernel == "forward" else 2)
    for ts in staged:
        assert all(t.data_ptr() % 16 == 0 and torch.equal(t, x) for t in ts)


def test_kernel_library_is_built_with_the_others():
    assert "flash_attention" in build.KERNEL_SOURCES
    assert (build.CSRC / "flash_attention.cu").is_file()
    assert build.library_path("flash_attention").name.startswith("libflash_attention-")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CUDA_SHAPES = [(1, 64, 2, 16), (2, 200, 4, 32), (2, 256, 4, 64), (1, 512, 2, 128)]
# The benchmark cells' per-layer shapes (16 heads of 64 and of 128), cut in
# T to keep the tests fast; bf16, the cells' type.
CELL_SHAPES = [(1, 512, 16, 64), (1, 512, 16, 128)]
TYPES = [torch.float32, torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape, dtype", [(s, d) for s in CUDA_SHAPES for d in TYPES]
                         + [(s, torch.bfloat16) for s in CELL_SHAPES])
def test_cuda_kernels_match_plain(shape, causal, dtype, cuda_device):
    q, k, v, do = _kernel_inputs(shape, dtype, cuda_device, seed=shape[1])
    before = dict(fa.launches)
    tol = ((dict(atol=1e-5, rtol=1e-4), dict(atol=1e-4, rtol=1e-3)) if dtype == torch.float32
           else (dict(atol=2e-3, rtol=1e-2), dict(atol=1e-2, rtol=1e-2)))
    _check_kernel_functions(q, k, v, do, causal, fa.flash_fwd, fa.flash_bwd_dkv,
                            fa.flash_bwd_dq, tol)
    torch.cuda.synchronize()
    assert {key: fa.launches[key] - before[key] for key in before} == {
        "fwd": 1, "bwd_dkv": 1, "bwd_dq": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("shape, dtype", [(s, d) for s in CUDA_SHAPES[2:] for d in TYPES]
                         + [(s, torch.bfloat16) for s in CELL_SHAPES])
def test_cuda_backward_kernels_bit_equal_on_repeat(shape, dtype, cuda_device):
    q, k, v, do = _kernel_inputs(shape, dtype, cuda_device, seed=11)
    scale = 1.0 / shape[-1] ** 0.5
    o, lse = fa.flash_fwd(q, k, v, True, scale)
    delta = fa.attention_delta(o, do)
    runs = [(*fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, scale),
             fa.flash_bwd_dq(q, k, v, do, lse, delta, True, scale)) for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(("dk", "dv", "dq"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [CUDA_SHAPES[2], CUDA_SHAPES[3]])
def test_cuda_forward_kernel_bit_equal_on_repeat(shape, dtype, cuda_device):
    q, k, v, _ = _kernel_inputs(shape, dtype, cuda_device, seed=12)
    scale = 1.0 / shape[-1] ** 0.5
    (o1, lse1), (o2, lse2) = (fa.flash_fwd(q, k, v, True, scale) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


@pytest.mark.cuda
def test_cuda_autograd_path_and_head_dim_rule(cuda_device):
    q, k, v, do = _kernel_inputs((2, 96, 2, 32), torch.float32, cuda_device, seed=5)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(fa.launches)
    out = fa.flash_attention_bthd(*leaves, causal=True)
    out.backward(do)
    assert {key: fa.launches[key] - before[key] for key in before} == {
        "fwd": 1, "bwd_dkv": 1, "bwd_dq": 1}
    want = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa.flash_attention_reference(*want, causal=True).backward(do)
    for a, b in zip(leaves, want):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=1e-3)
    q8 = torch.zeros(1, 16, 2, 8, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_bthd(q8, q8, q8)
