"""The port's CLI subset (ddl_tpu_torch/cli.py): the flag-to-config mapping
of the JAX CLI (the precision flags --precision, --bf16 and --fp32, the
CNN's --conv-matmul, --conv1-matmul, --conv-channels and --fc-sizes
included, with JAX's exits for their conflicts and bad widths), its
--fused-adam validation, loud refusal of what is not ported, and tiny
end-to-end runs on the CPU (sync_sharding, the three async variants, lm:
full, the default ring, and Ulysses with ZeRO-1, and the bf16 policy on
the CNN and the LM). A multi-rank grid (sequence, data or tensor parallel)
needs torchrun."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from ddl_tpu.cli import build_parser as j_parser, config_from_args as j_config
from ddl_tpu_torch import cli

PRECISION_FLAGS = ("--precision", "--bf16", "--fp32")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(argv, num_workers):
    """The port's and JAX's config for ``argv``; JAX's CLI defaults to bf16
    on a TPU only, so it is pinned to fp32 where ``argv`` names no
    precision."""
    t_args = cli.build_parser().parse_args(argv)
    pin = [] if any(f in argv for f in PRECISION_FLAGS) else ["--fp32"]
    j_args = j_parser().parse_args(argv + ["--num-workers", str(num_workers)] + pin)
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
    (["single", "--precision", "bf16", "--conv-matmul", "tail"], 1),
    (["sync_sharding", "--bf16", "--conv1-matmul", "--fused-adam"], 1),
    (["async", "--precision", "fp32", "--conv-matmul", "all"], 2),
    (["single", "--fp32", "--conv1-matmul", "--conv-matmul", "tail"], 1),
    (["sync", "--conv-channels", "8,8,16,16", "--fc-sizes", "64,32"], 2),
    (["single", "--tiny", "--fc-sizes", "20,10"], 1),
])
def test_flags_map_to_the_same_config(argv, workers):
    got, want = _configs(argv, workers)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.policy().name == want.policy().name
    assert got.conv_matmul_mode() == want.conv_matmul_mode()


@pytest.mark.parametrize("argv", [
    ["single", "--precision", "bf16", "--bf16"],
    ["sync", "--precision", "fp32", "--fp32"],
    ["single", "--bf16", "--fp32"],
    ["single", "--conv-channels", "4,8,8"],
    ["single", "--conv-channels", "4,8,8,0"],
    ["async", "--fc-sizes", "32"],
    ["single", "--tiny", "--fc-sizes", "16,-1"],
])
def test_precision_and_width_flags_exit_as_jax(argv):
    """A precision flag beside another, or a bad width, exits with JAX's
    message."""
    with pytest.raises(SystemExit) as ours:
        cli.config_from_args(cli.build_parser().parse_args(argv), 1)
    with pytest.raises(SystemExit) as theirs:
        j_config(j_parser().parse_args(argv))
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("argv", [
    ["lm", "--precision", "bf16", "--bf16"],
    ["lm", "--bf16", "--fp32"],
])
def test_lm_precision_flag_conflicts_exit_as_jax(argv):
    from ddl_tpu.cli import _resolve_dtype as j_resolve_dtype

    with pytest.raises(SystemExit) as ours:
        cli.lm_config_from_args(cli.build_parser().parse_args(argv))
    with pytest.raises(SystemExit) as theirs:
        j_resolve_dtype(j_parser().parse_args(argv))
    assert str(ours.value) == str(theirs.value)


def test_precision_flags_keep_the_jax_spellings():
    ours, theirs = cli.build_parser(), j_parser()
    for flag in ("--precision", "--conv-matmul"):
        assert (ours._option_string_actions[flag].choices
                == theirs._option_string_actions[flag].choices), flag
    for dest in ("precision", "fp32", "bf16", "conv1_matmul", "conv_matmul", "conv_channels",
                 "fc_sizes"):
        assert ours.get_default(dest) == theirs.get_default(dest), dest
    lm = cli.lm_config_from_args(ours.parse_args(["lm", "--precision", "bf16"]))
    assert (lm.precision, lm.compute_dtype, lm.policy().reduces_in_bf16) == ("bf16", None, True)


@pytest.mark.parametrize("variant,extra", [
    ("sync_sharding", ["--num-ps", "2", "--layout", "flat", "--fused-adam",
                       "--conv-matmul", "first+tail"]),
    ("async_sharding", ["--conv1-matmul"]),
])
def test_cnn_bf16_end_to_end_on_cpu(variant, extra, capsys, monkeypatch, tmp_path):
    """The bf16 policy and the patches-matmul stages train the CNN from the
    CLI at one worker."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    rc = cli.main([
        variant, "--device", "cpu", "--tiny", "--precision", "bf16", "--synthetic-train", "256",
        "--synthetic-test", "64", "--batch-size", "32", "--eval-every", "4",
        "--data", str(tmp_path / "absent.pkl"), "--json", *extra,
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg = out["config"]
    assert cfg["precision"] == "bf16" and cfg["compute_dtype"] is None
    assert (cfg["conv_matmul"], cfg["conv1_matmul"]) == (
        ("first+tail", False) if variant == "sync_sharding" else ("none", True))
    assert 0.0 <= out["final_accuracy"] <= 1.0 and out["images_per_sec"] > 0


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
    grid = cli.lm_config_from_args(ours.parse_args([
        "lm", "--num-workers", "2", "--data-parallel", "2", "--zero1", "--seq-layout", "zigzag"]))
    assert (grid.scheme, grid.num_workers, grid.data_parallel, grid.zero1, grid.seq_layout) == (
        "ring", 2, 2, True, "zigzag")
    assert grid.tensor_parallel == 1
    tp = cli.lm_config_from_args(ours.parse_args(["lm", "--tensor-parallel", "2", "--zero1"]))
    assert (tp.tensor_parallel, tp.num_workers, tp.zero1) == (2, 1, True)


@pytest.mark.parametrize("argv,match", [
    (["lm", "--data-parallel", "0"], "--data-parallel must be >= 1"),
    (["sync", "--zero1"], "--zero1 does not apply"),
    (["lm", "--seq-scheme", "full", "--keep-prob", "0.7"], "--keep-prob does not apply"),
    (["sync", "--attn-impl", "flash"], "--attn-impl does not apply"),
    # The CNN's bf16 compute is ported (the id is the case's name from when
    # it still raised); --bf16 beside --fp32 is JAX's refusal.
    pytest.param(["single", "--bf16", "--fp32"], "mutually exclusive", id="argv4-ROADMAP"),
    (["lm", "--tensor-parallel", "0"], "--tensor-parallel must be >= 1"),
    (["sync", "--tensor-parallel", "2"], "--tensor-parallel does not apply"),
    (["lm", "--pipeline-parallel", "0"], "--pipeline-parallel must be >= 1"),
    (["sync", "--pipeline-schedule", "1f1b"], "--pipeline-schedule does not apply"),
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


@pytest.mark.parametrize("extra", [["--precision", "bf16"], ["--bf16", "--remat"]])
def test_lm_bf16_end_to_end_on_cpu(extra, capsys):
    assert cli.main(LM_SMOKE + ["--json", "--eval-every", "2"] + extra) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    policy = (out["config"]["precision"], out["config"]["compute_dtype"])
    assert policy == (("bf16", None) if "--precision" in extra else (None, "bfloat16"))
    assert np.isfinite(out["final_loss"]) and [b for _, b, _ in out["history"]] == [0, 2, 3]


@pytest.mark.parametrize("extra,match", [
    (["--num-workers", "2"], "cannot shard"),
    (["--batch-size", "128"], "exceeds 64 train sequences"),
    (["--vocab", "2"], "too small"),
    (["--seq-scheme", "ulysses", "--num-workers", "4"], "ulysses needs per-device num_heads"),
    (["--seq-layout", "zigzag"], "balances the RING"),
    (["--data-parallel", "3"], "not divisible by data_parallel 3"),
    (["--tensor-parallel", "3"], r"tensor_parallel needs num_heads \(2\) divisible by tp \(3\)"),
])
def test_lm_config_errors_exit_cleanly(extra, match):
    with pytest.raises(SystemExit, match=f"lm config error.*{match}"):
        cli.main(LM_SMOKE + extra)


@pytest.mark.parametrize("extra,scheme", [
    ([], "ring"),
    (["--seq-scheme", "ring", "--seq-layout", "zigzag"], "ring"),
    (["--seq-scheme", "ulysses", "--attn-impl", "flash", "--zero1"], "ulysses"),
])
def test_lm_sequence_schemes_end_to_end_on_cpu(extra, scheme, capsys, monkeypatch):
    """The JAX CLI's default scheme (ring), the zigzag ring and Ulysses with
    ZeRO-1 train at one rank on the CPU."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    argv = [a for a in LM_SMOKE if a not in ("--seq-scheme", "full", "--attn-impl", "flash")]
    assert cli.main(argv + extra + ["--json", "--eval-every", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["config"]["scheme"] == scheme and out["config"]["num_workers"] == 1
    assert np.isfinite(out["final_loss"]) and 0.0 <= out["final_accuracy"] <= 1.0
    assert [b for _, b, _ in out["history"]] == [0, 2, 3]


def test_lm_multirank_needs_torchrun(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 4"):
        cli.main(LM_SMOKE + ["--seq-scheme", "ulysses", "--num-workers", "2",
                             "--data-parallel", "2"])


@pytest.mark.parametrize("flags,outcome", [
    # Tensor and pipeline parallelism are ported (the ids are the cases'
    # names from when they still raised): tp 2 is a world of 2 ranks, which
    # needs torchrun; each pipeline flag alone is JAX's config error, both
    # together a world of 2 ranks.
    pytest.param(["--tensor-parallel", "2"], "torchrun --nproc-per-node 2",
                 id="--tensor-parallel-tensor parallelism"),
    pytest.param(["--pipeline-parallel", "2"],
                 r"lm config error.*pipeline_parallel \(2\) > 1 requires microbatches > 1",
                 id="--pipeline-parallel-the pipeline"),
    pytest.param(["--microbatches", "2"],
                 r"lm config error.*microbatches \(2\) > 1 requires pipeline_parallel > 1",
                 id="--microbatches-the pipeline"),
    (["--pipeline-parallel", "2", "--microbatches", "2"], "torchrun --nproc-per-node 2"),
    (["--pipeline-parallel", "2", "--microbatches", "2", "--data-parallel", "2",
      "--pipeline-schedule", "1f1b"], "torchrun --nproc-per-node 4"),
])
def test_lm_out_of_slice_flags_name_their_item(flags, outcome, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match=outcome):
        cli.main(LM_SMOKE + flags)


@pytest.mark.parametrize("extra,schedule", [([], "gpipe"), (["--pipeline-schedule", "1f1b"],
                                                            "1f1b")])
def test_lm_pipeline_defaults_as_jax(extra, schedule, capsys, monkeypatch):
    """Under --pipeline-parallel the CLI defaults as JAX's: --num-workers
    1 whatever the world, and the parser's ring default mapped to full with
    JAX's printed line; --pipeline-schedule takes JAX's choices."""
    monkeypatch.setenv("WORLD_SIZE", "4")
    argv = [a for a in LM_SMOKE if a not in ("--seq-scheme", "full")]
    argv += ["--pipeline-parallel", "2", "--microbatches", "4", "--data-parallel", "2"] + extra
    cfg = cli.lm_config_from_args(cli.build_parser().parse_args(argv))
    assert capsys.readouterr().out.splitlines() == [
        "[ddl_tpu] --pipeline-parallel: sequence is whole per stage; using --seq-scheme full"]
    assert (cfg.scheme, cfg.num_workers, cfg.data_parallel) == ("full", 1, 2)
    assert (cfg.pipeline_parallel, cfg.microbatches, cfg.pipeline_schedule) == (2, 4, schedule)
    choices = lambda p: p._option_string_actions["--pipeline-schedule"].choices  # noqa: E731
    assert choices(cli.build_parser()) == choices(j_parser())
    explicit = cli.lm_config_from_args(cli.build_parser().parse_args(
        argv + ["--seq-scheme", "ulysses"]))
    assert explicit.scheme == "ulysses" and capsys.readouterr().out == ""
