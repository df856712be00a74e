"""Finds a cell's files by name: ``workloads/<cell>.json`` names its
configuration (``configs/<config>.json``) and traffic mix
(``traffic/<mix>.json``), and ``BENCHMARK.json`` at the checkout's root
names the metrics each cell reports. Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import re

from ..reference.lm import Dims

HERE = pathlib.Path(__file__).resolve().parent.parent  # the benchmark's folder
ROOT = HERE.parent  # the checkout
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _read(kind: str, name: str) -> dict:
    if not NAME.fullmatch(name):
        raise ValueError(f"{name!r} is not a name")
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path.relative_to(ROOT)})")
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    @property
    def batch(self) -> int:
        return int(self.workload["batch"])

    @property
    def limits(self) -> dict[str, float]:
        return self.workload["limits"]

    @property
    def learning_rate(self) -> float:
        return float(self.config["assumed"]["learning_rate"])

    def dims(self) -> Dims:
        c = self.config
        return Dims(vocab=c["vocab_size"], d_model=c["hidden_size"],
                    num_heads=c["num_attention_heads"], num_layers=c["num_hidden_layers"],
                    d_ff=c["intermediate_size"], rope_base=float(c["rotary_emb_base"]))


def load_cell(name: str) -> Cell:
    workload = _read("workloads", name)
    return Cell(name=name, workload=workload, config=_read("configs", workload["config"]),
                traffic=_read("traffic", workload["traffic"]))


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def metrics_for(bench: dict, section: str, cell: str) -> list[dict]:
    """The entries of ``section`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: those that list it, and those that list no cells."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]
