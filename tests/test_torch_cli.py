"""The port's CLI subset (ddl_tpu_torch/cli.py): the flag-to-config mapping
of the JAX CLI, its --fused-adam validation, loud refusal of what is not
ported, and one tiny end-to-end run on the CPU."""

import dataclasses
import json

import pytest

from ddl_tpu.cli import build_parser as j_parser, config_from_args as j_config
from ddl_tpu_torch import cli


def _configs(argv, num_workers):
    t_args = cli.build_parser().parse_args(argv)
    j_args = j_parser().parse_args(argv + ["--num-workers", str(num_workers), "--fp32"])
    return cli.config_from_args(t_args, num_workers), j_config(j_args)


@pytest.mark.parametrize("argv,workers", [
    (["sync_sharding", "--num-ps", "2", "--layout", "flat", "--fused-adam"], 1),
    (["sync_sharding_greedy", "--num-ps", "3", "--tiny", "--seed", "4"], 2),
    (["sync", "--reference-compat", "--batch-size", "50", "--lr", "3e-4"], 4),
    (["single", "--keep-prob", "0.7", "--eval-every", "5", "--epochs", "2"], 1),
    (["sync_sharding", "--batch-size", "96"], 3),
])
def test_flags_map_to_the_same_config(argv, workers):
    got, want = _configs(argv, workers)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("argv", [
    ["sync", "--fused-adam"],
    ["single", "--fused-adam"],
    ["sync_sharding", "--num-ps", "1", "--fused-adam"],
])
def test_fused_adam_validation(argv):
    args = cli.build_parser().parse_args(argv)
    with pytest.raises(SystemExit, match="--fused-adam applies"):
        cli.config_from_args(args, 1)


def test_batch_must_divide_over_workers():
    args = cli.build_parser().parse_args(["sync", "--batch-size", "10"])
    with pytest.raises(SystemExit, match="not divisible"):
        cli.config_from_args(args, 3)


def test_async_variants_are_refused():
    with pytest.raises(SystemExit, match="not ported yet"):
        cli.main(["async", "--device", "cpu"])


def test_multiworker_needs_torchrun(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="torchrun"):
        cli.main(["sync", "--device", "cpu", "--num-workers", "2", "--tiny",
                  "--synthetic-train", "8", "--synthetic-test", "8"])


def test_sync_sharding_end_to_end_on_cpu(capsys, monkeypatch, tmp_path):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    rc = cli.main([
        "sync_sharding", "--device", "cpu", "--num-workers", "1", "--num-ps", "2",
        "--layout", "flat", "--fused-adam", "--tiny", "--synthetic-train", "300",
        "--synthetic-test", "50", "--eval-every", "2", "--data", str(tmp_path / "absent.pkl"),
        "--json",
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["variant"] == "sync_sharding" and out["device"] == "cpu"
    assert out["config"]["fused_adam"] and out["config"]["layout"] == "flat"
    assert [b for _, b, _ in out["history"]] == [0, 2]
    assert 0.0 <= out["final_accuracy"] <= 1.0
    assert out["step_stats"]["steps"] == 2  # spans [0], [1, 2]
