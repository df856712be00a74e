"""A whole run of ``run.py`` on the CPU (the look for a card skipped), at a
small size under a cell's own limits, with the timed path broken
underneath: ``correct`` has to come out false for each fault a one-chip
training cell can have, and true with none. The exchange between chips is
not among them: every cell runs on one chip. Also the control, the
reference with float8 products, has to come out not correct."""

import json
import pathlib
import sys

import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH.parent))
sys.path.insert(0, str(BENCH))

import run  # noqa: E402
from portbench.harness import faults, spec, traffic, verdict  # noqa: E402
from portbench.runners import lm_train  # noqa: E402

CELL = "pythia-410m.pretrain-t2048"  # whose limits the small run is held to
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


def small_cell() -> spec.Cell:
    real = spec.load_cell(CELL)
    config = dict(real.config, vocab_size=8192, hidden_size=256, num_attention_heads=4,
                  num_hidden_layers=4, intermediate_size=1024)
    mix = dict(real.traffic, seq_len=128, distinct_batches=4)
    return spec.Cell(CELL, dict(real.workload, batch=4), config, mix)


@pytest.fixture
def small(monkeypatch):
    cell = small_cell()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setattr(spec, "load_cell", lambda name: cell)
    yield cell
    torch.set_num_threads(threads)


def drive(capsys, seed: int, fault: str | None, monkeypatch) -> dict:
    if fault is not None:
        from ddl_tpu_torch.strategies.seq import SeqTrainer

        step_fn = SeqTrainer.step_fn
        monkeypatch.setattr(SeqTrainer, "step_fn",
                            lambda self, *a, **k: faults.FAULTS[fault](step_fn(self, *a, **k)))
    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds", "0.2", "--trace", "0"],
                  device=torch.device("cpu"))
    out = capsys.readouterr()
    assert rc == 0
    result = json.loads(out.out.strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    tail = out.err.strip().splitlines()[-len(result["checks"]):]
    assert [line.split()[1] for line in tail] == list(result["checks"])
    return result


def test_a_sound_run_is_correct(small, capsys, monkeypatch):
    result = drive(capsys, SEEDS[0], None, monkeypatch)
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert result["attempted"] > 3


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_each_fault_makes_the_run_not_correct(small, capsys, monkeypatch, fault):
    result = drive(capsys, SEEDS[1], fault, monkeypatch)
    assert result["correct"] is False and result["failed"] >= 1


@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_is_not_correct(small, seed):
    cell, dev = small, torch.device("cpu")
    data = traffic.generate(cell.traffic, cell.batch, cell.dims().vocab, seed)
    ref = lm_train.reference_follow(cell, seed, dev, data)
    ctl = lm_train.reference_follow(cell, seed, dev, data, quant=True)
    correct, checks = verdict.judge(verdict.gaps(ctl, ref), cell.limits)
    assert not correct, checks
