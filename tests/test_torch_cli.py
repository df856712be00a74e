"""The port's CLI subset (ddl_tpu_torch/cli.py): the flag-to-config mapping
of the JAX CLI, its --fused-adam validation, loud refusal of what is not
ported, and tiny end-to-end runs on the CPU (sync_sharding, the three async
variants and lm)."""

import dataclasses
import json

import numpy as np
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
    (["async", "--keep-prob", "0.7"], 1),
    (["async_sharding", "--num-ps", "3", "--staleness-seed", "5"], 3),
    (["async_sharding_greedy", "--tiny", "--batch-size", "50"], 4),
    (["async", "--reference-compat", "--epochs", "2"], 2),
])
def test_flags_map_to_the_same_config(argv, workers):
    got, want = _configs(argv, workers)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("argv", [
    ["sync", "--fused-adam"],
    ["single", "--fused-adam"],
    ["sync_sharding", "--num-ps", "1", "--fused-adam"],
    ["async", "--fused-adam"],
])
def test_fused_adam_validation(argv):
    args = cli.build_parser().parse_args(argv)
    with pytest.raises(SystemExit, match="--fused-adam applies"):
        cli.config_from_args(args, 1)


def test_batch_must_divide_over_workers():
    args = cli.build_parser().parse_args(["sync", "--batch-size", "10"])
    with pytest.raises(SystemExit, match="not divisible"):
        cli.config_from_args(args, 3)


@pytest.mark.parametrize("variant,num_ps,layout", [
    ("async", 1, "block"),
    ("async_sharding", 2, "block"),
    ("async_sharding_greedy", 2, "zigzag"),
])
def test_async_variants_end_to_end_on_cpu(variant, num_ps, layout, capsys, monkeypatch,
                                          tmp_path):
    """Each async variant trains on the CPU at W = 1 and prints its
    per-worker history beside the PS history."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    rc = cli.main([
        variant, "--device", "cpu", "--tiny", "--synthetic-train", "256",
        "--synthetic-test", "64", "--batch-size", "32", "--eval-every", "4",
        "--data", str(tmp_path / "absent.pkl"), "--json",
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["variant"] == variant and out["device"] == "cpu"
    assert (out["config"]["num_ps"], out["config"]["layout"]) == (num_ps, layout)
    assert out["config"]["batch_size"] == 32 and not out["config"]["fused_adam"]
    assert [r for _, r, _ in out["history"]] == [0, 4]  # 8 rounds, chunks of 4
    assert [(e, r) for e, r, _ in out["worker_history"]] == [(e, r) for e, r, _ in out["history"]]
    assert all(len(accs) == 1 and 0.0 <= accs[0] <= 1.0 for _, _, accs in out["worker_history"])
    assert 0.0 <= out["final_accuracy"] <= 1.0 and out["images_per_sec"] > 0
    assert out["step_stats"]["steps"] == 2


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
    assert out["worker_history"] is None


LM_SMOKE = ["lm", "--device", "cpu", "--seq-scheme", "full", "--attn-impl", "flash",
            "--seq-len", "32", "--vocab", "16", "--d-model", "32", "--heads", "2",
            "--layers", "2", "--d-ff", "64", "--train-seqs", "64", "--test-seqs", "16",
            "--batch-size", "16"]


def test_lm_flags_keep_the_jax_spellings_and_defaults():
    ours, theirs = cli.build_parser(), j_parser()
    for dest in cli._LM_ONLY + ("epochs", "eval_every", "seed", "lr", "batch_size", "bf16"):
        assert ours.get_default(dest) == theirs.get_default(dest), dest
    args = ours.parse_args(LM_SMOKE + ["--remat", "--bf16", "--lr", "3e-3", "--seed", "5"])
    cfg = cli.lm_config_from_args(args)
    assert (cfg.scheme, cfg.attn_impl, cfg.remat, cfg.compute_dtype) == (
        "full", "flash", True, "bfloat16")
    assert (cfg.learning_rate, cfg.seed, cfg.batch_size, cfg.spec.d_ff) == (3e-3, 5, 16, 64)
    default = cli.lm_config_from_args(ours.parse_args(["lm", "--seq-scheme", "full"]))
    assert (default.batch_size, default.learning_rate, default.compute_dtype) == (32, 1e-3, None)


@pytest.mark.parametrize("argv,match", [
    (["lm"], "pass --seq-scheme full"),
    (["lm", "--seq-scheme", "ulysses"], "pass --seq-scheme full"),
    (["lm", "--seq-scheme", "full", "--keep-prob", "0.7"], "--keep-prob does not apply"),
    (["sync", "--attn-impl", "flash"], "--attn-impl does not apply"),
    (["single", "--bf16"], "ROADMAP"),
])
def test_lm_flag_refusals(argv, match):
    args = cli.build_parser().parse_args(argv)
    convert = cli.lm_config_from_args if argv[0] == "lm" else (lambda a: cli.config_from_args(a, 1))
    with pytest.raises(SystemExit, match=match):
        convert(args)


def test_lm_end_to_end_on_cpu(capsys):
    assert cli.main(LM_SMOKE + ["--json", "--eval-every", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["variant"] == "lm" and out["device"] == "cpu"
    assert out["config"]["attn_impl"] == "flash" and out["config"]["scheme"] == "full"
    assert out["config"]["seq_len"] == 32 and out["config"]["spec"]["d_model"] == 32
    assert np.isfinite(out["final_loss"]) and 0.0 <= out["final_accuracy"] <= 1.0
    assert [b for _, b, _ in out["history"]] == [0, 2, 3]
    assert out["step_stats"]["steps"] == 3 and out["tokens_per_sec"] > 0


@pytest.mark.parametrize("extra,match", [
    (["--num-workers", "2"], "cannot shard"),
    (["--batch-size", "128"], "exceeds 64 train sequences"),
    (["--vocab", "2"], "too small"),
])
def test_lm_config_errors_exit_cleanly(extra, match):
    with pytest.raises(SystemExit, match=f"lm config error.*{match}"):
        cli.main(LM_SMOKE + extra)
