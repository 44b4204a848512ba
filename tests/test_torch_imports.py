"""Import hygiene of the PyTorch port: no module of ``deepgo_tpu_torch``,
and not ``chip_smoke.py``, imports ``jax`` or anything of ``deepgo_tpu``."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "deepgo_tpu")


def port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "deepgo_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_sources_found():
    rel = {os.path.relpath(p, REPO) for p in port_sources()}
    assert "chip_smoke.py" in rel
    for module in (("ops", "cuda_expand.py"), ("serving", "fleet.py"),
                   ("serving", "supervisor.py"), ("serving", "cache.py"),
                   ("obs", "tracing.py"), ("obs", "workload.py"),
                   ("models", "value_cnn.py"), ("go", "board.py"),
                   ("go", "native.py"), ("sgf.py",),
                   ("data", "transcribe.py"), ("data", "split.py"),
                   ("selfplay.py",), ("agents.py",), ("match.py",),
                   ("arena.py",), ("search", "mcts.py"),
                   ("serving", "replay.py"), ("loop", "learner.py"),
                   ("loop", "service.py"), ("sessions", "store.py"),
                   ("sessions", "child.py"), ("training", "value.py"),
                   ("data", "winners.py"), ("utils", "watchdog.py"),
                   ("parallel", "__init__.py"), ("parallel", "mesh.py"),
                   ("parallel", "distributed.py"),
                   ("parallel", "deadlines.py"),
                   ("parallel", "liveness.py"), ("parallel", "tensor.py"),
                   ("parallel", "zero.py"), ("parallel", "reshard.py"),
                   ("parallel", "shard_map_step.py"),
                   ("parallel", "elastic.py"),
                   ("analysis", "__init__.py"), ("analysis", "lockcheck.py"),
                   ("analysis", "cudacheck.py"), ("utils", "profiling.py"),
                   ("obs", "attribution.py"), ("obs", "report.py"),
                   ("obs", "costmodel.py"), ("obs", "slo.py"),
                   ("obs", "timeseries.py"), ("obs", "anomaly.py"),
                   ("obs", "federate.py"), ("obs", "dash.py"),
                   ("chaos", "__init__.py"), ("chaos", "scenario.py"),
                   ("chaos", "canary.py"), ("chaos", "campaign.py"),
                   ("cli.py",), ("graft_entry.py",),
                   ("analysis", "config.py"), ("analysis", "grammar.py"),
                   ("analysis", "linter.py"), ("experiments", "plot.py"),
                   ("experiments", "repeated.py"), ("obs", "exporter.py")):
        assert os.path.join("deepgo_tpu_torch", *module) in rel


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_package_import(path):
    bad = sorted({r for r in imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"
