"""The port's ``serve --replicas`` CLI (ddl_tpu_torch/cli.py,
``_run_serve_router``) against JAX's on the CPU, at a tiny width (vocab 32,
d_model 32, 2 heads, 2 layers, d_ff 64), both serving one checkpoint that
JAX's ``save_checkpoint`` wrote from JAX's init.

Each case runs JAX's CLI once and the port's once (the module fixture
``cli_runs``), and is pinned against JAX's on the same flags:

- ``router``: 2 paged replicas with a prefix cache, a shed threshold, per
  class SLOs and a bulk burst over two chat families: completions, per
  class tallies, placements, sheds, the printed router and class lines;
- ``autoscale_crash``: ``--autoscale ... --inject-fault replica_crash@2:1``
  (replica 1 of 2 crashes at tick 2 with requests in flight and the
  controller heals the fleet): tokens, statuses, placements, the fleet
  digest and its printed line;
- ``roles``: ``--roles prefill=1,decode=1`` (serve_bench's disagg_compare
  fleet at this width): tokens, statuses, the disagg digest (hand-offs,
  hand-off pages) and its printed line;
- ``speculate``: ``--speculate 4`` on a 2-replica paged fleet, and
  ``int8_disagg``: the roles fleet with ``--kv-dtype int8``: tokens,
  statuses, the digests and the ``speculate`` digest.

Serve telemetry (``test_cli_serve_telemetry_matches_jax``): JAX's
bulk_burst fleet as flags, with ``--metrics-out``, ``--prom-port 0``,
``--peak-flops``, ``--slo-rules`` (a TTFT rule every bulk first token
misses, a shed-burn rule), ``--anomaly-rules`` (``backlog``,
``shed_rate``) and ``--autoscale ...,burn=`` naming the TTFT rule: the
``slo_rules`` and ``anomaly_rules`` digests, the fleet digest (a burn
scale-out), tokens and the printed slo/anomaly/fleet lines equal JAX's.

The twin (``test_cli_sim_matches_jax``): ``sim --scenario X --json`` for each
of the six scenarios prints JAX's lines and JSON (the router digest's
wall-clock fields aside); ``--fit`` with a serve run's metrics file prints
the fitted costs. Each bad ``sim`` flag exits with JAX's text
(``test_cli_sim_flags_fail_as_jax``); ``--device``, which JAX's CLI lacks,
is refused too.

Port-only: the crashed and the disaggregated runs' tokens equal the plain
fleet's (the same flags without the fault, or colocated), and the
speculating fleet's equal the same fleet's without --speculate. Each bad
combination of the fleet flags exits with JAX's text.

Greedy comparisons against JAX keep the top-2 margin gate (1e-5, the cached
logits' tolerance): a near-tie fails loudly instead of passing by luck.
"""

import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch

from ddl_tpu import cli as jcli
from ddl_tpu.models import transformer as jt
from ddl_tpu.utils import checkpoint as jck
from ddl_tpu_torch import cli
from test_torch_fleet import MARGIN, recording

JSPEC = jt.LMSpec(vocab=32, d_model=32, num_heads=2, num_layers=2, d_ff=64)
MODEL = ["--vocab", "32", "--d-model", "32", "--heads", "2", "--layers", "2", "--d-ff", "64"]
CLI_CASES = {
    "router": ["--replicas", "2", "--slots", "2", "--capacity", "48", "--page-size", "8",
               "--prefix-cache", "2", "--shed-threshold", "4", "--traffic",
               "horizon=8;seed=4;burst=2:3:3.0:bulk;chat:rate=0.6,pmin=8,pmax=16,new=6,"
               "families=2,fprefix=5;bulk:rate=0.5,pmin=8,pmax=16,new=6",
               "--slo", "chat:ttft=5,priority=0;bulk:ttft=60,priority=2,margin=2"],
    # Replica 1 of a 2-replica paged fleet crashes at tick 2 with 2 requests
    # in flight; the controller heals the fleet with a third engine.
    "autoscale_crash": ["--replicas", "2", "--slots", "2", "--capacity", "16", "--page-size",
                        "8", "--traffic", "horizon=4;seed=1;chat:rate=0.8,pmin=4,pmax=8,new=4;"
                        "bulk:rate=1.0,pmin=4,pmax=8,new=4", "--autoscale",
                        "backlog=2,sustain=1,idle=3", "--max-replicas", "2", "--inject-fault",
                        "replica_crash@2:1"],
    # serve_bench's disagg_compare fleet, at this width.
    "roles": ["--replicas", "2", "--roles", "prefill=1,decode=1", "--slots", "4", "--capacity",
              "64", "--page-size", "8", "--traffic",
              "horizon=12;seed=5;max_requests=6;chat:rate=0.4,pmin=8,pmax=16,new=8"],
    # Speculation behind the router: few requests a replica leave free
    # slots for the draft lanes.
    "speculate": ["--replicas", "2", "--page-size", "8", "--speculate", "4", "--capacity", "64",
                  "--traffic", "horizon=6;seed=3;max_requests=5;chat:rate=0.6,pmin=8,pmax=16,"
                  "new=10"],
    # The roles fleet on the int8 pool: the hand-off moves (payload, scale)
    # pairs.
    "int8_disagg": ["--replicas", "2", "--roles", "prefill=1,decode=1", "--kv-dtype", "int8",
                    "--slots", "4", "--capacity", "64", "--page-size", "8", "--traffic",
                    "horizon=12;seed=5;max_requests=6;chat:rate=0.4,pmin=8,pmax=16,new=8"],
}
FLEET_CASES = ["autoscale_crash", "roles"]
POOL_CASES = ["speculate", "int8_disagg"]
# The flag (with its value) whose removal gives a case's plain fleet.
PLAIN_WITHOUT = {"autoscale_crash": "--inject-fault", "roles": "--roles",
                 "speculate": "--speculate"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    weights = jax.tree.map(np.asarray, jt.init_lm_params(jax.random.PRNGKey(0), JSPEC))
    d = tmp_path_factory.mktemp("fleet_ckpt")
    jck.save_checkpoint(d / "ckpt.npz", {"params": weights})
    return str(d)


def _cli_json(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    lines = buf.getvalue().strip().splitlines()
    return json.loads(lines[-1]), lines[:-1]


@contextlib.contextmanager
def _jax_cli():
    """JAX's CLI in this process: its ``main`` sets the virtual CPU device
    count before any backend starts; here the backend already runs with the
    8 devices tests/conftest.py asks for, so that call is skipped."""
    from ddl_tpu.parallel import mesh as jmesh

    saved = jmesh.set_cpu_device_count
    jmesh.set_cpu_device_count = lambda n: None
    try:
        yield
    finally:
        jmesh.set_cpu_device_count = saved


@pytest.fixture(scope="module")
def cli_runs(ckpt_dir):
    """Each case's (JAX's JSON and lines, the port's, the port's top-2
    margins, the argv), run once."""
    cache = {}

    def get(name):
        if name not in cache:
            argv = ["serve", *MODEL, "--checkpoint-dir", ckpt_dir, *CLI_CASES[name], "--json"]
            with _jax_cli():
                theirs = _cli_json(jcli.main, argv + ["--platform", "cpu"])
            with recording() as rec:
                ours = _cli_json(cli.main, argv + ["--device", "cpu"])
            cache[name] = (theirs, ours, rec["margins"], argv)
        return cache[name]

    return get


@pytest.fixture(scope="module")
def plain_runs(ckpt_dir):
    """The port's JSON for each case's plain fleet (the case's flags without
    its ``PLAIN_WITHOUT`` flag), run once."""
    cache = {}

    def get(name):
        if name not in cache:
            plain = list(CLI_CASES[name])
            i = plain.index(PLAIN_WITHOUT[name])
            del plain[i:i + 2]
            argv = ["serve", *MODEL, "--checkpoint-dir", ckpt_dir, *plain, "--json", "--device",
                    "cpu"]
            cache[name] = _cli_json(cli.main, argv)[0]
        return cache[name]

    return get


def test_cli_router_matches_jax(cli_runs):
    (theirs, tlines), (ours, olines), margins, _ = cli_runs("router")
    assert ours["completions"] == theirs["completions"]
    assert ours["per_class"] == theirs["per_class"]
    for key in ("per_replica_requests", "affinity_placements", "load_placements",
                "router_sheds", "prefix_hit_rate", "ticks", "replicas"):
        assert ours["router"][key] == theirs["router"][key], key
    for name, row in theirs["router"]["per_class"].items():
        assert {k: ours["router"]["per_class"][name][k] for k in ("requests", "ok", "shed")} == \
            {k: row[k] for k in ("requests", "ok", "shed")}
    assert [x for x in olines if x.startswith("router:")] == \
        [x for x in tlines if x.startswith("router:")]
    assert [x.split("|")[0] for x in olines if x.startswith("class ")] == \
        [x.split("|")[0] for x in tlines if x.startswith("class ")]
    assert ours["router"]["router_sheds"] > 0 and ours["device"] == "cpu"
    assert ours["speculate"] == theirs["speculate"]
    assert (ours["speculate"], ours["slo_rules"], ours["anomaly_rules"]) == (None, None, None)
    assert min(margins) > MARGIN


def _strip_times(summary):
    """The router digest without its wall-clock fields."""
    out = json.loads(json.dumps(summary))
    for row in out["per_class"].values():
        for key in ("ttft_ms", "itl_ms", "ttft_slo_attained", "itl_slo_attained"):
            row.pop(key)
    return out


@pytest.mark.parametrize("name", FLEET_CASES)
def test_cli_fleet_matches_jax(cli_runs, name):
    """Tokens, statuses, placements, sheds, the per-class tallies and the
    fleet and disagg digests equal JAX's CLI on the same flags; the printed
    fleet and disagg lines too."""
    (theirs, tlines), (ours, olines), margins, _ = cli_runs(name)
    assert ours["completions"] == theirs["completions"]
    assert ours["per_class"] == theirs["per_class"]
    assert _strip_times(ours["router"]) == _strip_times(theirs["router"])
    assert ours["config"] == {**theirs["config"], "spec": ours["config"]["spec"]}
    assert min(margins) > MARGIN
    for prefix in ("fleet:", "disagg:", "router:"):
        assert [x for x in olines if x.startswith(prefix)] == \
            [x for x in tlines if x.startswith(prefix)]
    statuses = {c["status"] for c in ours["completions"].values()}
    if name == "autoscale_crash":
        fleet = ours["router"]["fleet"]
        assert fleet["crashes"] == 1 and fleet["requeues"] >= 1 and statuses == {"ok"}
        crash = [e for e in fleet["events"] if e["kind"] == "replica_crash"]
        assert crash[0]["inflight"] >= 1 and fleet["scale_outs"] >= 1
    else:
        dg = ours["router"]["disagg"]
        assert dg["handoffs"] == len(ours["completions"]) and dg["handoff_pages"] > 0
        assert dg["roles"] == {"decode": 1, "prefill": 1} and statuses == {"ok"}


@pytest.mark.parametrize("name", FLEET_CASES)
def test_cli_fleet_tokens_equal_the_plain_fleet(cli_runs, plain_runs, name):
    """A crash (every request completes exactly once) and the prefill ->
    decode hand-off leave every request's tokens as the plain fleet's (the
    same flags without the fault, or colocated)."""
    _, (ours, _), _, _ = cli_runs(name)
    ref = plain_runs(name)
    assert sorted(ours["completions"], key=int) == sorted(ref["completions"], key=int)
    for i, c in ours["completions"].items():
        assert c["tokens"] == ref["completions"][i]["tokens"] and c["status"] == "ok", i


@pytest.mark.parametrize("name", POOL_CASES)
def test_cli_speculate_and_int8_match_jax(cli_runs, plain_runs, name):
    """``--speculate`` and ``--kv-dtype int8`` behind the router: tokens,
    statuses, the router and disagg digests, the config and the printed
    lines equal JAX's CLI on the same flags, and so does the ``speculate``
    digest (None on both: without a telemetry flag neither router has
    replica registries). Speculation's tokens equal the same fleet's
    without it."""
    (theirs, tlines), (ours, olines), margins, _ = cli_runs(name)
    assert ours["completions"] == theirs["completions"]
    assert ours["per_class"] == theirs["per_class"]
    assert _strip_times(ours["router"]) == _strip_times(theirs["router"])
    assert ours["config"] == {**theirs["config"], "spec": ours["config"]["spec"]}
    assert ours["speculate"] == theirs["speculate"]
    assert min(margins) > MARGIN
    for prefix in ("disagg:", "router:", "speculate:"):
        assert [x for x in olines if x.startswith(prefix)] == \
            [x for x in tlines if x.startswith(prefix)]
    assert {c["status"] for c in ours["completions"].values()} == {"ok"}
    if name == "speculate":
        assert ours["config"]["speculate_k"] == 4
        assert ours["completions"] == plain_runs(name)["completions"]
    else:
        assert ours["config"]["kv_dtype"] == "int8"
        dg = ours["router"]["disagg"]
        assert dg["handoffs"] == len(ours["completions"]) and dg["handoff_pages"] > 0


FLAG_CASES = [
    ["--traffic", "chat:rate=1"], ["--slo", "chat:ttft=1"], ["--autoscale", ""],
    ["--replicas", "2", "--max-replicas", "3"], ["--roles", "prefill=1,decode=1"],
    ["--replicas", "2", "--roles", "prefill=1,decode=1"],
    ["--replicas", "0"], ["--replicas", "2", "--num-prompts", "3"],
    ["--replicas", "2", "--page-size", "8", "--roles", "prefill=2"],
    ["--replicas", "2", "--traffic", "chat:speed=1"],
    ["--replicas", "2", "--traffic", "c:rate=0"],
    ["--replicas", "2", "--traffic", "c:rate=1,pmax=200"],
    ["--replicas", "2", "--slo", "nope:ttft=1"],
    ["--replicas", "2", "--autoscale", "speed=1"],
    ["--replicas", "2", "--autoscale", "backlog=2"],
    ["--replicas", "3", "--autoscale", "", "--max-replicas", "2"],
    ["--replicas", "2", "--inject-fault", "replica_crash@2:1"],
    ["--inject-fault", "replica_crash@2:1"],
    ["--replicas", "2", "--prefill-chunk", "12"],
]


@pytest.mark.parametrize("flags", FLAG_CASES, ids=lambda f: " ".join(f))
def test_cli_fleet_flags_fail_as_jax(flags):
    """Each bad combination of the fleet flags exits with JAX's text
    before any engine is built."""
    argv = ["serve", *MODEL, "--capacity", "64", *flags]
    with pytest.raises(SystemExit) as ours:
        cli.main(argv + ["--device", "cpu"])
    with _jax_cli(), pytest.raises(SystemExit) as theirs:
        jcli.main(argv + ["--platform", "cpu"])
    assert str(ours.value) == str(theirs.value)


# JAX's BULK_BURST fleet (serve.scenarios) as serve flags, on real engines.
TELEMETRY_CASE = [
    "--replicas", "1", "--slots", "1", "--capacity", "64", "--shed-threshold", "2",
    "--traffic", "horizon=16;seed=0;max_requests=16;burst=4:6:6.0:bulk;"
    "chat:rate=0.3,pmin=4,pmax=8,new=2;bulk:rate=0.4,pmin=4,pmax=8,new=2",
    "--slo", "chat:priority=0;bulk:priority=1,margin=1",
    "--autoscale", "max=2,min=1,backlog=2,sustain=8,idle=4,preempt=0,burn=bulk_ttft",
    "--slo-rules", "bulk_ttft:metric=router_ttft_seconds,label.class=bulk,target=1e-9,"
    "objective=0.5,fast=2,slow=4;bulk_shed:metric=router_shed_total,"
    "total=router_requests_total,label.class=bulk,objective=0.5,fast=3,slow=6",
    "--anomaly-rules", "backlog:window=4,min=2,threshold=1;shed_rate:window=4,min=2,"
    "threshold=1",
    "--peak-flops", "1e12",
]


def test_cli_serve_telemetry_matches_jax(ckpt_dir, tmp_path):
    """The router path with every serve telemetry flag: the SLO and
    anomaly digests (counts only: the TTFT rule's 1 ns target makes every
    bulk first token a miss), a burn scale-out, tokens and the printed
    lines equal JAX's; each metrics file ends in a snapshot."""
    argv = ["serve", *MODEL, "--checkpoint-dir", ckpt_dir, *TELEMETRY_CASE, "--json"]
    with _jax_cli():
        theirs, tlines = _cli_json(jcli.main, argv + ["--platform", "cpu", "--metrics-out",
                                                      str(tmp_path / "j.jsonl")])
    ours, olines = _cli_json(cli.main, argv + ["--device", "cpu", "--prom-port", "0",
                                               "--metrics-out", str(tmp_path / "t.jsonl")])
    assert ours["completions"] == theirs["completions"]
    assert ours["slo_rules"] == theirs["slo_rules"] and ours["slo_rules"]["bulk_ttft"]["alerts"]
    assert ours["anomaly_rules"] == theirs["anomaly_rules"]
    assert ours["anomaly_rules"]["backlog"]["fired_ticks"]
    assert _strip_times(ours["router"]) == _strip_times(theirs["router"])
    reasons = [e.get("reason") for e in ours["router"]["fleet"]["events"]]
    assert "burn" in reasons
    for prefix in ("slo rule", "anomaly signal", "fleet:", "router:"):
        assert [x for x in olines if x.startswith(prefix)] == \
            [x for x in tlines if x.startswith(prefix)], prefix
    assert any(x.startswith("[ddl_tpu] metrics endpoint: http://") for x in olines)
    for name in ("j.jsonl", "t.jsonl"):
        recs = [json.loads(x) for x in open(tmp_path / name)]
        assert recs[0]["record"] == "manifest" and recs[-1]["record"] == "snapshot"


def _sim_strip(out):
    out = dict(out)
    out["router"] = _strip_times(out["router"])
    return out


def test_cli_sim_matches_jax(tmp_path):
    """``sim --scenario X --json`` for each scenario: JAX's printed lines
    and JSON, the router digest's wall-clock fields aside; ``--fit`` with a
    serve run's metrics file fits the costs it prints."""
    for name in ("bulk_burst", "replica_crash", "diurnal", "crash_storm", "role_mix",
                 "longtail_prefix"):
        argv = ["sim", "--scenario", name, "--json"]
        with _jax_cli():
            theirs, tlines = _cli_json(jcli.main, argv + ["--platform", "cpu"])
        ours, olines = _cli_json(cli.main, argv)
        assert olines == tlines, name
        assert _sim_strip(ours) == _sim_strip(theirs), name
        assert ours["engine_kind"] == "sim" and ours["virtual_time"]["total"] > 0
    metrics = tmp_path / "serve.jsonl"
    assert cli.main(["serve", "--device", "cpu", "--vocab", "16", "--d-model", "16", "--heads",
                     "2", "--layers", "1", "--d-ff", "32", "--slots", "2", "--capacity", "32",
                     "--max-new-tokens", "3", "--num-prompts", "3", "--prompt-max", "10",
                     "--metrics-out", str(metrics)]) == 0
    argv = ["sim", "--scenario", "diurnal:horizon=8", "--json", "--fit", str(metrics)]
    with _jax_cli():
        theirs, tlines = _cli_json(jcli.main, argv + ["--platform", "cpu"])
    ours, olines = _cli_json(cli.main, argv)
    assert ours["cost_model"] == theirs["cost_model"]
    assert ours["cost_model"]["decode_s_per_tick"] != 4.0e-3
    assert _sim_strip(ours) == _sim_strip(theirs) and olines == tlines


SIM_FLAG_CASES = [
    [], ["--scenario", "rush_hour"], ["--scenario", "diurnal:frobs=1"],
    ["--scenario", "replica_crash:rate_scale=2"], ["--scenario", "bulk_burst", "--slots", "2"],
    ["--scenario", "bulk_burst", "--max-replicas", "3"],
    ["--scenario", "bulk_burst", "--autoscale", "speed=1"],
    ["--scenario", "bulk_burst", "--fit", "absent.jsonl"],
    ["--scenario", "bulk_burst", "--inject-fault", "stall@1"],
    ["--scenario", "bulk_burst", "--seq-len", "64"], ["--scenario", "bulk_burst", "--profile",
                                                      "p"],
    ["--scenario", "bulk_burst", "--traffic", "chat:rate=1"],
    ["--scenario", "bulk_burst", "--slo-rules", "a:metric=m,target=1"],
    ["--scenario", "bulk_burst", "--anomaly-rules", "backlog"],
    ["--scenario", "bulk_burst", "--metrics-interval", "2"],
    ["--scenario", "bulk_burst", "--num-ps", "3"],
]


def test_cli_sim_flags_fail_as_jax():
    """Each bad sim flag exits with JAX's text before the twin runs; the
    port also refuses ``--device`` (the twin touches no device); and
    ``--slo-rules`` does not apply to a training variant, as in JAX's."""
    for flags in SIM_FLAG_CASES:
        with pytest.raises(SystemExit) as ours:
            cli.main(["sim", *flags])
        with _jax_cli(), pytest.raises(SystemExit) as theirs:
            jcli.main(["sim", *flags, "--platform", "cpu"])
        assert str(ours.value) == str(theirs.value), flags
    with pytest.raises(SystemExit, match="^--device does not apply to the sim variant$"):
        cli.main(["sim", "--scenario", "bulk_burst", "--device", "cuda", "--device", "cpu"])
    for variant in ("lm", "sync"):
        argv = [variant, "--slo-rules", "a:metric=m,target=1"]
        with pytest.raises(SystemExit) as ours:
            cli.main(argv + ["--device", "cpu"])
        with _jax_cli(), pytest.raises(SystemExit) as theirs:
            jcli.main(argv + ["--platform", "cpu"])
        assert str(ours.value) == str(theirs.value) == \
            f"--slo-rules does not apply to the {variant} variant"
