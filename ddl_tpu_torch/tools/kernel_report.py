"""What the compiler made of the port's CUDA kernels.

    python -m ddl_tpu_torch.tools.kernel_report [--out FILE]

Builds each ``csrc/<name>.cu`` of ``build.KERNEL_SOURCES`` once more with the port's own ``nvcc`` flags plus ``-Xptxas -v``,
into a temporary directory, and prints one JSON line per kernel instance:

- ``registers``, ``spill_stores``, ``spill_loads``, ``stack_bytes`` as
  ``ptxas`` reports them;
- ``sass``: how many ``HMMA`` (tensor-core products), ``LDGSTS``
  (``cp.async`` copies), ``UBLKCP`` (``cp.async.bulk`` copies by the
  Tensor Memory Accelerator), ``FFMA``, ``LDS``, ``LDG`` and ``STG`` (global
  loads and stores) instructions ``cuobjdump -sass`` shows in the kernel's
  code, and how many of the loads and stores carry the evict-first hint
  (``LDG_EF``, ``STG_EF``: ``ld.global.cs``/``st.global.cs``) (``null``
  where the toolkit has no ``cuobjdump``);
- ``dynamic_smem_bytes``: for the flash-attention kernels, the shared
  memory one block asks for at launch (``ddl_flash_smem_bytes`` of the
  built library).

Needs ``nvcc``; the shared-memory query also needs the CUDA runtime (run
it on the card).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import tempfile

from ..ops import build

_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_FLASH = re.compile(r"(flash_(?:fwd|bwd_dkv|bwd_dq)_kernel)I(f|13__nv_bfloat16)Li(\d+)E")
_SASS_OPS = ("HMMA", "LDGSTS", "UBLKCP", "FFMA", "LDS", "LDG", "STG")
_EVICT_FIRST = ("LDG", "STG")  # also counted as LDG_EF / STG_EF when .EF


def _demangle(names: list[str]) -> dict[str, str]:
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return dict(zip(names, out))


def parse_ptxas(log: str) -> dict[str, dict]:
    """Registers, spills and stack per mangled kernel name."""
    info: dict[str, dict] = {}
    current = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            current = info.setdefault(m.group(1), {})
            continue
        if current is None:
            continue
        m = _STACK.search(line)
        if m:
            current.update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = _REGS.search(line)
        if m:
            current["registers"] = int(m.group(1))
    return info


def parse_sass(text: str) -> dict[str, dict[str, int]]:
    """Counts of :data:`_SASS_OPS` per mangled kernel name, and of the
    loads and stores among them with the evict-first (``.EF``) hint."""
    keys = _SASS_OPS + tuple(f"{op}_EF" for op in _EVICT_FIRST)
    counts: dict[str, dict[str, int]] = {}
    current = None
    for line in text.splitlines():
        if "Function :" in line:
            current = counts.setdefault(line.split("Function :")[1].strip(),
                                        dict.fromkeys(keys, 0))
        elif current is not None:
            m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\S*)", line)
            if m and m.group(1) in _SASS_OPS:
                current[m.group(1)] += 1
                if m.group(1) in _EVICT_FIRST and "EF" in m.group(2).split("."):
                    current[f"{m.group(1)}_EF"] += 1
    return counts


def _cuobjdump(nvcc: str) -> str | None:
    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = pathlib.Path(nvcc).parent / "cuobjdump"
    return str(cand) if cand.is_file() else None


def report(name: str, workdir: pathlib.Path) -> list[dict]:
    nvcc = build.nvcc_path()
    lib = workdir / f"lib{name}.so"
    proc = subprocess.run([nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
                           str(build.CSRC / f"{name}.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{proc.stdout}{proc.stderr}")
    ptxas = parse_ptxas(proc.stdout + proc.stderr)
    dump = _cuobjdump(nvcc)
    sass = (parse_sass(subprocess.run([dump, "-sass", str(lib)], capture_output=True,
                                      text=True, check=True).stdout) if dump else {})
    smem = None
    if name == "flash_attention":
        smem = ctypes.CDLL(str(lib)).ddl_flash_smem_bytes
        smem.argtypes = [ctypes.c_int] * 3
        smem.restype = ctypes.c_int
    pretty = _demangle(sorted(ptxas))
    rows = []
    for mangled, info in sorted(ptxas.items()):
        row = {"source": f"csrc/{name}.cu", "kernel": pretty[mangled], **info,
               "sass": next((c for f, c in sass.items() if f.endswith(mangled) or mangled in f),
                            None)}
        m = _FLASH.search(mangled)
        if smem is not None and m:
            which = ("flash_fwd_kernel", "flash_bwd_dkv_kernel",
                     "flash_bwd_dq_kernel").index(m.group(1))
            row["dynamic_smem_bytes"] = smem(which, 0 if m.group(2) == "f" else 1,
                                             int(m.group(3)))
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ddl_tpu_torch.tools.kernel_report")
    ap.add_argument("--out", help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        for name in build.KERNEL_SOURCES:
            for row in report(name, pathlib.Path(tmp)):
                lines.append(json.dumps(row))
                print(lines[-1], flush=True)
    if args.out:
        pathlib.Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
