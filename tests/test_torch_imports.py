"""Boundaries of the PyTorch port.

- An AST audit: no file under ``ddl_tpu_torch/``, nor ``chip_smoke.py``,
  imports ``jax``, ``jaxlib``, ``ml_dtypes`` or ``ddl_tpu`` (whose
  ``__init__`` pulls in JAX).
- The device rule: without a card, entry points raise unless the CPU is
  asked for; they never fall back quietly.
- The fused-Adam wrapper on a CPU tensor runs the plain version and never
  tries to build the CUDA kernel.
"""

import ast
import pathlib

import pytest
import torch

from ddl_tpu_torch.ops import build, fused_adam
from ddl_tpu_torch.parallel import mesh

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "ddl_tpu")


def imported_modules(tree: ast.AST) -> list[str]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append(node.module)
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            out.append(str(node.args[0].value))
    return out


def forbidden_imports(tree: ast.AST) -> list[str]:
    return [m for m in imported_modules(tree) if m.split(".")[0] in FORBIDDEN]


def test_port_imports_no_jax_and_no_ddl_tpu():
    files = sorted((ROOT / "ddl_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = {}
    for path in files:
        found = forbidden_imports(ast.parse(path.read_text(), filename=str(path)))
        if found:
            bad[str(path.relative_to(ROOT))] = found
    assert not bad, f"the port must not import JAX or ddl_tpu: {bad}"


def test_audit_detector_self_pinned():
    tree = ast.parse(
        "import jax\nimport jax.numpy as jnp\nfrom ddl_tpu.models import cnn\n"
        "from jaxlib import xla_client\nimport ml_dtypes\n__import__('ddl_tpu')\n"
        "def f():\n    from jax import lax\n"
        "import ddl_tpu_torch\nfrom ddl_tpu_torch.ops import build\nfrom . import x\n"
        "s = 'import jax'\n"
    )
    assert forbidden_imports(tree) == [
        "jax", "jax.numpy", "ddl_tpu.models", "jaxlib", "ml_dtypes", "ddl_tpu", "jax",
    ]


def test_default_device_never_falls_back():
    assert mesh.default_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert mesh.default_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.default_device("cuda")
    with pytest.raises(ValueError):
        mesh.default_device("meta")


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from ddl_tpu_torch.data.mnist import load_mnist
    from ddl_tpu_torch.train import SingleChipTrainer, TrainConfig

    ds = load_mnist(None, synthetic_train=10, synthetic_test=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SingleChipTrainer(TrainConfig(), ds)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.init_world(1, 0, "file:///nonexistent/never-used", "cuda")
    from ddl_tpu_torch import cli

    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["lm", "--seq-scheme", "full", "--seq-len", "32", "--vocab", "16",
                  "--train-seqs", "8", "--test-seqs", "4", "--batch-size", "4"])
    for variant in ("async", "async_sharding", "async_sharding_greedy"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([variant, "--tiny", "--synthetic-train", "8", "--synthetic-test", "8"])


def test_cpu_fused_adam_never_builds_the_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU path must not build or load the CUDA kernel")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(build, "nvcc_path", refuse)
    p, m, v, g = (torch.ones(9) for _ in range(4))
    launches = fused_adam.launches
    fused_adam.adam_flat_fused(p, m, v, g, torch.tensor([1e-3]))
    assert fused_adam.launches == launches
    assert torch.isfinite(p).all() and not torch.equal(p, torch.ones(9))


def test_unsupported_options_raise():
    from ddl_tpu_torch.train import TrainConfig

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TrainConfig(precision="bf16")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TrainConfig(compute_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TrainConfig(conv_matmul="tail")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TrainConfig(conv1_matmul=True)


def test_kernel_library_named_by_source_hash():
    path = build.library_path("fused_adam")
    assert path.parent == build.BUILD_DIR and path.name.startswith("libfused_adam-")
    assert (build.CSRC / "fused_adam.cu").is_file()
    assert "-gencode=arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert not any("fast_math" in f or "fast-math" in f for f in build.NVCC_FLAGS)


def test_kernel_library_hash_covers_included_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include <stdint.h>\n#include "a.cuh"\nint x;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    first = build.library_path("k")
    (tmp_path / "other.cuh").write_text("// edited, still not included\n")
    assert build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")  # included through a.cuh
    second = build.library_path("k")
    assert second != first and second.name.startswith("libk-")
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint y;\n')
    assert build.library_path("k") not in (first, second)
    # The real flash source includes its tensor-core header.
    monkeypatch.undo()
    assert b'#include "tf32_mma.cuh"' in (build.CSRC / "flash_attention.cu").read_bytes()


def test_kernel_report_parses_ptxas_and_sass():
    from ddl_tpu_torch.tools import kernel_report

    name = "_ZN51_GLOBAL__N__c930_18_flash_attention_cu_ac2619flash_bwd_dq_kernelIfLi64EEEvPKT_"
    ptxas = (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
             f"ptxas info    : Function properties for {name}\n"
             "    8 bytes stack frame, 4 bytes spill stores, 2 bytes spill loads\n"
             "ptxas info    : Used 128 registers, used 1 barriers\n")
    assert kernel_report.parse_ptxas(ptxas) == {name: dict(
        stack_bytes=8, spill_stores=4, spill_loads=2, registers=128)}
    sass = (f"\t\tFunction : {name}\n"
            "        /*06f0*/                   LDGSTS.E.BYPASS.128 [R13], desc[UR4][R4.64], !P3 ;\n"
            "        /*0700*/              @!P0 HMMA.1688.F32.TF32 R4, R8, R12, R4 ;\n"
            "        /*0710*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;\n"
            "        /*0720*/                   LDS R3, [R2] ;\n"
            "        /*0730*/                   LDG.E.EF.128 R4, desc[UR4][R2.64] ;\n"
            "        /*0740*/              @P1 LDG.E.128 R8, desc[UR4][R6.64] ;\n"
            "        /*0750*/                   STG.E.EF.128 desc[UR4][R2.64], R4 ;\n"
            "        /*0760*/                   STG.E.128 desc[UR4][R6.64], R8 ;\n"
            "        /*0770*/                   STG.E desc[UR4][R6.64], R9 ;\n"
            "        /*0780*/                   UBLKCP.S.G [UR8], [UR4], UR6 ;\n")
    assert kernel_report.parse_sass(sass) == {name: dict(
        HMMA=2, LDGSTS=1, UBLKCP=1, FFMA=0, LDS=1, LDG=2, STG=3, LDG_EF=1, STG_EF=1)}
    assert kernel_report._FLASH.search(name).groups() == ("flash_bwd_dq_kernel", "f", "64")
