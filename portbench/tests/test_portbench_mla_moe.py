"""The latent-attention and expert cell on the CPU: its files load and agree
with ``BENCHMARK.json``; a whole run of ``run.py`` (the look for a card
skipped) at a small size of the same block, under the cell's own limits,
comes out correct, and not correct with each planted fault of
``harness/faults.py`` or with a wrong router; the control (the reference
with float8 products) is not correct; the cost functions against a hand
count; the readers on a trace and on nothing; the span split's rule."""

import dataclasses
import json
import math
import pathlib
import sys

import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(BENCH))

import run  # noqa: E402
from portbench.harness import cost_mla_moe, faults, moe_spans, spec  # noqa: E402
from portbench.reference import mla_moe as reference  # noqa: E402
from portbench.runners import mla_moe_train  # noqa: E402

CELL = "moonlight-16b-a3b-ep8.pretrain-t8192"
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
SEEDS = (2**31 + 111, 2**31 + 222)
KIND = "NVIDIA H100 80GB HBM3"


def test_the_cell_loads_and_agrees_with_the_benchmark():
    c = spec.load_cell(CELL)
    entry = next(w for w in BENCHMARK["workloads"] if w["name"] == CELL)
    assert (c.workload["config"], c.workload["traffic"], c.chips, c.workload["why"]) == (
        entry["config"], entry["traffic"], entry["chips"], entry["why"])
    assert c.traffic["kind"] == "mla_moe_train" and c.traffic["seq_len"] == 8192
    assert set(c.limits) <= {"loss_gap", "grad_gap", "update_gap"}
    assert 0 < c.workload["route_agreement_min"] < c.workload["route_replay_min"] < 1
    d = mla_moe_train.dims(c)
    assert sum(math.prod(s) for s in reference.leaf_shapes(d).values()) == \
        c.config["parameters"] == 2_777_411_072
    assert (d.d_model, d.qk_dim, d.v_head_dim, d.kv_lora_rank, d.d_ff, d.d_expert) == (
        2048, 192, 128, 512, 11264, 1408)
    assert (d.num_layers, d.n_experts, d.held, d.top_k, d.vocab) == (
        27, 64, tuple(range(8)), 6, 20480)
    for m in BENCHMARK["per_layer"] + BENCHMARK["end_to_end"]:
        assert CELL in m.get("workloads", [CELL]) or not m["name"].startswith(
            ("moe_", "mla_")), m["name"]


def test_the_configuration_keeps_the_catalog_but_the_cut():
    c = json.loads((ROOT / "portbench/configs/moonlight-16b-a3b-ep8.json").read_text())
    assert c["published"] == {"n_routed_experts": 64, "vocab_size": 163840}
    assert c["reduced"] == sorted(c["published"]) and c["n_routed_experts"] == 8
    assert c["vocab_size"] * 8 == 163840 and c["router_experts"] == 64
    assert c["num_hidden_layers"] == 27 and c["first_k_dense_replace"] == 1


def test_the_step_flops_and_the_flash_bound_by_hand():
    d = mla_moe_train.dims(spec.load_cell(CELL))
    b, t = 2, 8192
    e, h = 2048, 16
    attn_proj = 2 * (e * h * 192 + e * 576 + 512 * h * 256 + h * 128 * e)
    moe = 2 * e * 64 + 6 * e * 2816 + 6 * e * 1408 * 6 * 8 / 64
    per_token = 27 * attn_proj + 6 * e * 11264 + 26 * moe + 2 * e * 20480
    attention = 27 * b * h * (t * t // 2) * 2 * (192 + 128)
    by_hand = 3 * (b * t * per_token + attention)
    assert cost_mla_moe.train_step_flops(d, b, t) == pytest.approx(by_hand, rel=1e-12)
    assert by_hand == pytest.approx(1.643e14, rel=1e-3)
    least = cost_mla_moe.flash_least_seconds(d, b, t, KIND)
    pairs = b * h * t * t  # B H T^2
    assert least["fwd"] == pytest.approx(27 * pairs * 320 / 989.4e12)
    assert least["bwd_dkv"] == pytest.approx(27 * pairs * 640 / 989.4e12)
    assert least["bwd_dq"] == pytest.approx(27 * pairs * 192 / 989.4e12)
    assert sum(least.values()) == pytest.approx(0.0675, rel=2e-3)
    assert cost_mla_moe.expert_flops(d, 1000, 10) == 3 * (1000 * 6 * e * 1408
                                                          + 10 * 26 * 6 * e * 2816)


def small_cell() -> spec.Cell:
    real = spec.load_cell(CELL)
    config = dict(real.config, vocab_size=512, hidden_size=128, num_attention_heads=4,
                  num_hidden_layers=3, qk_nope_head_dim=32, qk_rope_head_dim=16,
                  v_head_dim=32, kv_lora_rank=32, intermediate_size=256,
                  moe_intermediate_size=32, router_experts=64, experts_held=list(range(8)),
                  num_experts_per_tok=6, n_shared_experts=1)
    mix = dict(real.traffic, seq_len=64, distinct_batches=4)
    return spec.Cell(CELL, dict(real.workload, batch=4), config, mix)


@pytest.fixture
def small(monkeypatch):
    cell = small_cell()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setattr(spec, "load_cell", lambda name: cell)
    yield cell
    torch.set_num_threads(threads)


def drive(capsys, seed, monkeypatch, fault=None, router=None) -> dict:
    if fault is not None:
        from ddl_tpu_torch.strategies.seq import SeqTrainer

        step_fn = SeqTrainer.step_fn
        monkeypatch.setattr(SeqTrainer, "step_fn",
                            lambda self, *a, **k: faults.FAULTS[fault](step_fn(self, *a, **k)))
    if router is not None:
        from ddl_tpu_torch.models import mla_moe

        monkeypatch.setattr(mla_moe, "route", router)
    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds", "0.2", "--trace", "0"],
                  device=torch.device("cpu"))
    out = capsys.readouterr()
    assert rc == 0
    result = json.loads(out.out.strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    assert {"route_agreement", "route_replay"} <= set(result["checks"])
    assert "expert_load" in out.err
    return result


def test_a_sound_run_is_correct(small, capsys, monkeypatch):
    result = drive(capsys, SEEDS[0], monkeypatch)
    assert result["correct"] is True and result["failed"] == 0, result["checks"]
    assert set(result["metrics"]) == {"train_tokens_per_s", "setup_s"}


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_each_fault_makes_the_run_not_correct(small, capsys, monkeypatch, fault):
    result = drive(capsys, SEEDS[1], monkeypatch, fault=fault)
    assert result["correct"] is False and result["failed"] >= 1


def bias_only_router(x, router, bias, spec):
    """Chooses by the bias alone (the scores only weigh)."""
    from ddl_tpu_torch.models import mla_moe

    s = torch.sigmoid(mla_moe._Gate.apply(x, router))
    chosen = torch.topk(bias.expand_as(s), spec.top_k, dim=-1).indices
    w = s.gather(-1, chosen)
    return chosen, w * (spec.routed_scale / w.sum(-1, keepdim=True))


def test_a_wrong_router_fails_the_route_agreement(small, capsys, monkeypatch):
    result = drive(capsys, SEEDS[1], monkeypatch, router=bias_only_router)
    assert result["correct"] is False
    assert result["checks"]["route_agreement"]["value"] < result["checks"]["route_agreement"][
        "limit"]


def test_a_router_without_its_bias_fails_the_route_replay(small, capsys, monkeypatch):
    from ddl_tpu_torch.models import mla_moe

    sound = mla_moe.route

    def bias_ignored(x, router, bias, spec):
        return sound(x, router, torch.zeros_like(bias), spec)

    result = drive(capsys, SEEDS[1], monkeypatch, router=bias_ignored)
    replay = result["checks"]["route_replay"]
    assert result["correct"] is False and replay["value"] < replay["limit"]


def test_the_control_is_not_correct(small):
    cell, dev = small, torch.device("cpu")
    data = mla_moe_train.generate(cell, SEEDS[0])
    prog = mla_moe_train.build(cell, SEEDS[0], dev, data)
    _, routes, rows = mla_moe_train.checked_steps(prog, cell, SEEDS[0], dev)
    ref, agreement = mla_moe_train.reference_follow(cell, SEEDS[0], dev, data, routes=routes)
    ctl, ctl_agreement = mla_moe_train.reference_follow(cell, SEEDS[0], dev, data, routes=routes,
                                                        quant=True)
    replay = mla_moe_train.router_replay(cell, SEEDS[0], dev, rows, routes[0], quant=True)
    correct, checks, failed = mla_moe_train.judge(cell, ctl, ref, ctl_agreement, replay)
    assert not correct and failed >= 1, checks
    assert len(agreement) == 2 and agreement[0] > ctl_agreement[0]


def fake_events():
    """A session's events: the window; a launch inside moe/route, one inside
    the backward's moe/experts (another thread), one in neither."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    def ev(name, dev, start, end, cid=-1):
        return NS(name=name, device_type=dev, time_range=NS(start=start, end=end), id=cid,
                  cpu_parent=None)

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    return [ev("portbench_window", cpu, 100.0, 1000.0),
            ev("step/forward", cpu, 100.0, 400.0), ev("moe/route", cpu, 110.0, 130.0),
            ev("cudaLaunchKernel", cpu, 120.0, 121.0, 1),
            ev("step/backward", cpu, 400.0, 900.0), ev("moe/experts", cpu, 500.0, 600.0),
            ev("cudaLaunchKernel", cpu, 550.0, 551.0, 2),
            ev("cudaLaunchKernel", cpu, 700.0, 701.0, 3),
            ev("topk_kernel", cuda, 5000.0, 5010.0, 1),
            ev("nvjet_tst_grouped", cuda, 5100.0, 5400.0, 2),
            ev("vectorized_elementwise_kernel", cuda, 5500.0, 5600.0, 3)]


def test_the_span_split_and_the_readers():
    from portbench.harness.trace import Trace, reduce

    events = fake_events()
    spans = moe_spans.device_seconds(events)
    assert spans == {"moe/route": pytest.approx(10e-6), "moe/experts": pytest.approx(300e-6)}
    assert moe_spans.device_seconds(events[:1] + events[8:]) is None
    d = mla_moe_train.dims(spec.load_cell(CELL))
    r = mla_moe_train.Reading(dims=d, batch=2, seq_len=8192, kind=KIND, step_s=1.0,
                              trace=reduce(events, steps=2, window_s=1e-3), moe_spans=spans,
                              assignments=26 * 8 * 1536.0)
    assert run.reader("moe_route_ms_per_step")(r) == pytest.approx(5e-3)
    flops = cost_mla_moe.expert_flops(d, 26 * 8 * 1536.0, 16384)
    assert run.reader("moe_experts_roofline_share")(r) == pytest.approx(
        100 * 2 * flops / 989.4e12 / 300e-6)
    assert run.reader("moe_train_mfu")(r) == pytest.approx(
        100 * cost_mla_moe.train_step_flops(d, 2, 8192) / 989.4e12)
    assert run.reader("mla_flash_roofline_share")(r) is None  # no flash kernel in the trace
    empty = dataclasses.replace(r, step_s=0.0, moe_spans=None, assignments=0.0,
                                trace=Trace(steps=1, window_s=0.0, ops=[], launches=0, gaps=[]))
    for m in BENCHMARK["per_layer"]:
        if CELL in m["workloads"]:
            assert run.reader(m["name"])(empty) is None, m["name"]
