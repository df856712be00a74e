"""The plain reference against the port's LM step, on the CPU at small
sizes (``attn_impl="flash"`` takes its plain version there), and on the
card where there is one (``cuda`` marker).

Under the port's float32 policy the two compute the same mathematics, so
they agree to float32 round-off; under the bf16 policy the cells run they
differ by bf16 round-off; the control (the reference with float8 products)
lies further off."""

import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

from portbench.harness import spec, traffic, verdict, weights  # noqa: E402
from portbench.reference import lm as reference  # noqa: E402
from portbench.runners import lm_train  # noqa: E402


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def small_cell(vocab=512, d_model=128, heads=2, layers=2, seq_len=64, batch=4,
               limits=None) -> spec.Cell:
    config = {"vocab_size": vocab, "hidden_size": d_model, "num_attention_heads": heads,
              "num_hidden_layers": layers, "intermediate_size": 4 * d_model,
              "rotary_emb_base": 10000, "assumed": {"learning_rate": 3e-4}}
    mix = {"kind": "lm_train", "seq_len": seq_len, "ids": "uniform",
           "distinct_batches": 4, "checked_steps": 3}
    workload = {"config": "small", "traffic": "small", "chips": 1, "batch": batch,
                "limits": limits or {}}
    return spec.Cell("small", workload, config, mix)


def readings(cell, seed, device, precision="bf16"):
    data = traffic.generate(cell.traffic, cell.batch, cell.dims().vocab, seed)
    ref = lm_train.reference_follow(cell, seed, device, data)
    prog = lm_train.build(cell, seed, device, data, precision=precision)
    got = lm_train.checked_steps(prog, cell, seed, device)
    return got, ref, data


@pytest.mark.parametrize("seed", [3, 2**31 + 17])
def test_the_port_in_float32_is_the_reference(seed):
    got, ref, _ = readings(small_cell(), seed, torch.device("cpu"), precision="fp32")
    g = verdict.gaps(got, ref)
    assert g["loss_gap"] < 1e-6 and g["grad_gap"] < 1e-5 and g["update_gap"] < 1e-4, g


def test_the_port_in_bf16_is_off_by_bf16_round_off():
    got, ref, _ = readings(small_cell(), 5, torch.device("cpu"))
    g = verdict.gaps(got, ref)
    assert 1e-7 < g["loss_gap"] < 1e-3 and 1e-5 < g["grad_gap"] < 1e-2, g


def test_the_initial_parameters_follow_the_ports_init_rule():
    d = reference.Dims(vocab=64, d_model=32, num_heads=2, num_layers=2, d_ff=64)
    a = weights.device_leaves(d, 2**40 + 3, "cpu")
    b = weights.device_leaves(d, 2**40 + 3, "cpu")
    tree = weights.numpy_tree(d, 2**40 + 3, "cpu")
    assert list(a) == list(reference.leaf_shapes(d))
    for path, t in a.items():
        assert torch.equal(t, b[path])
        assert (weights.leaf(tree, path) == t.numpy()).all()
    limit = (6.0 / (32 + 64)) ** 0.5
    assert a["embed"].abs().max() <= limit and a["embed"].std() > limit / 3
    assert (a["blocks.0.ln1_g"] == 1).all() and (a["blocks.1.b1"] == 0).all()
    assert not torch.equal(a["head"], weights.device_leaves(d, 2**40 + 4, "cpu")["head"])


def test_the_reference_loss_is_log_vocab_at_a_small_init():
    d = reference.Dims(vocab=256, d_model=32, num_heads=2, num_layers=1, d_ff=64)
    p = weights.device_leaves(d, 1, "cpu")
    tokens = torch.randint(0, 256, (2, 16), generator=torch.Generator().manual_seed(0))
    loss, grads = reference.loss_and_grads(p, tokens, tokens, torch.ones(2, 16), d,
                                           rows_per_block=1)
    assert abs(loss - torch.log(torch.tensor(256.0)).item()) < 0.5
    whole, _ = reference.loss_and_grads(p, tokens, tokens, torch.ones(2, 16), d,
                                        rows_per_block=2)
    assert loss == pytest.approx(whole, rel=1e-6)
    assert set(grads) == set(p) and all(torch.isfinite(g).all() for g in grads.values())


@pytest.mark.cuda
def test_the_port_on_the_card_against_the_reference():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels build and run only there")
    cell = small_cell(vocab=4096, d_model=256, heads=4, seq_len=256)
    dev = torch.device("cuda", 0)
    got, ref, _ = readings(cell, 7, dev, precision="fp32")
    g = verdict.gaps(got, ref)
    assert g["loss_gap"] < 1e-5 and g["grad_gap"] < 1e-3, g
    got, ref, _ = readings(cell, 7, dev)
    g = verdict.gaps(got, ref)
    assert g["loss_gap"] < 1e-3 and g["grad_gap"] < 2e-2, g
