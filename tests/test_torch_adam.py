"""TF1 Adam in the port (ddl_tpu_torch/ops) against the JAX package.

- ``adam_update``: three steps against ``ddl_tpu.ops.adam_update``.
- ``adam_flat_reference`` and ``adam_flat_fused`` on the CPU (which runs
  the plain version) against the Pallas kernel
  ``ddl_tpu.ops.pallas_adam.adam_flat_fused(..., interpret=True)`` at the
  sizes of tests/test_pallas_adam.py, atol 2e-7 (both sides apply the same
  IEEE float32 operations; values are O(1)).
- The CUDA kernel against its plain version: marked ``cuda``, skipped
  without a card. It imports nothing of JAX, so on the card it runs with
  ``python -m pytest --noconftest -m cuda tests/test_torch_adam.py``.
"""

import types

import numpy as np
import pytest
import torch

from ddl_tpu_torch.ops import fused_adam
from ddl_tpu_torch.ops.optimizers import adam_init, adam_update

ATOL = 2e-7
SIZES = [5, 1024, 512 * 128, 512 * 128 + 17]


@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported here so that the card-only test below needs
    no JAX."""
    import jax
    import jax.numpy as jnp

    from ddl_tpu.ops import adam_init as j_init, adam_update as j_update
    from ddl_tpu.ops.pallas_adam import adam_flat_fused as j_fused

    return types.SimpleNamespace(jax=jax, jnp=jnp, init=j_init, update=j_update, fused=j_fused)


def _flat_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    p, m, g = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    v = np.abs(rng.standard_normal(n)).astype(np.float32)
    return p, m, v, g


def test_adam_update_three_steps_match_jax(jx):
    rng = np.random.default_rng(1)
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 2, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    jp = {k: jx.jnp.asarray(v) for k, v in params.items()}
    jst = jx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tst = adam_init(tp)
    for g in grads:
        jp, jst = jx.update(jp, jst, {k: jx.jnp.asarray(v) for k, v in g.items()}, lr=1e-3)
        tp, tst = adam_update(tp, tst, {k: torch.from_numpy(v) for k, v in g.items()}, lr=1e-3)
    assert int(tst.step) == int(jst.step) == 3
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=ATOL, err_msg=k)
        np.testing.assert_allclose(tst.m[k].numpy(), np.asarray(jst.m[k]), atol=ATOL)
        np.testing.assert_allclose(tst.v[k].numpy(), np.asarray(jst.v[k]), atol=ATOL)


@pytest.mark.parametrize("n", SIZES)
def test_flat_reference_and_cpu_fused_match_pallas(n, jx):
    p, m, v, g = _flat_inputs(n)
    lr = np.float32(3e-4)
    want = jx.fused(*(jx.jnp.asarray(a) for a in (p, m, v, g)), jx.jnp.float32(lr),
                    interpret=True)
    want = [np.asarray(a) for a in want]
    t = [torch.from_numpy(a.copy()) for a in (p, m, v, g)]
    lr_t = torch.tensor([lr])
    ref = fused_adam.adam_flat_reference(*t, lr_t)
    for a, b in zip(ref, want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL)
    launches = fused_adam.launches
    out = fused_adam.adam_flat_fused(*t, lr_t)
    assert fused_adam.launches == launches  # the CPU path launches no kernel
    assert all(o is i for o, i in zip(out, t[:3]))  # in place
    for a, b in zip(out, want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL)
    np.testing.assert_array_equal(t[3].numpy(), g)  # g untouched


def test_tail_not_leaked():
    """Elements past n never reach the results: updating a prefix leaves
    the rest of the buffer alone and equals updating the prefix alone."""
    p, m, v, g = (torch.from_numpy(a) for a in _flat_inputs(300, seed=2))
    lr_t = torch.tensor([1e-3])
    full = [a.clone() for a in (p, m, v)]
    fused_adam.adam_flat_fused(full[0][:257], full[1][:257], full[2][:257], g[:257], lr_t)
    alone = fused_adam.adam_flat_reference(p[:257], m[:257], v[:257], g[:257], lr_t)
    for a, b, orig in zip(full, alone, (p, m, v)):
        assert a.shape == (300,)
        np.testing.assert_array_equal(a[:257].numpy(), b.numpy())
        np.testing.assert_array_equal(a[257:].numpy(), orig[257:].numpy())


def test_fused_rejects_bad_inputs():
    p, m, v, g = (torch.from_numpy(a) for a in _flat_inputs(16))
    lr_t = torch.tensor([1e-3])
    with pytest.raises(TypeError):
        fused_adam.adam_flat_fused(p.double(), m, v, g, lr_t)
    with pytest.raises(ValueError):
        fused_adam.adam_flat_fused(p, m, v, g[:8], lr_t)
    with pytest.raises(ValueError):
        fused_adam.adam_flat_fused(p.view(4, 4), m, v, g, lr_t)
    with pytest.raises(ValueError):
        fused_adam.adam_flat_fused(p, m, v, g, torch.tensor([1e-3, 2e-3]))
    with pytest.raises(ValueError):
        fused_adam.adam_flat_fused(p, p, v, g, lr_t)
    with pytest.raises(ValueError):
        fused_adam.adam_flat_fused(p[::2], m[:8], v[:8], g[:8], lr_t)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(n, 0) for n in SIZES] + [(65_553, 1)])
def test_cuda_kernel_matches_plain(n, offset, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    bufs = [torch.randn(n + offset, generator=gen, device=cuda_device) for _ in range(4)]
    bufs[2] = bufs[2].abs()
    lr_t = torch.tensor([3e-4], device=cuda_device)
    want = fused_adam.adam_flat_reference(*(b[offset:] for b in bufs), lr_t)
    p, m, v = (b.clone()[offset:] for b in bufs[:3])
    launches = fused_adam.launches
    fused_adam.adam_flat_fused(p, m, v, bufs[3][offset:], lr_t)
    torch.cuda.synchronize()
    assert fused_adam.launches == launches + 1
    for a, b in zip((p, m, v), want):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
