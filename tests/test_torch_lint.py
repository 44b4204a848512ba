"""The port's invariant linter (``deepgo_tpu_torch/analysis/{linter,
grammar,config}.py``) against the JAX package's, on the CPU.

* The port lints clean: ``run_lint`` over ``deepgo_tpu_torch/`` and
  ``chip_smoke.py`` gives 0 strict findings (grammar drift included), and
  ``cli lint`` exits 0.
* Parity: on the repo's fixtures of the rules both packages share
  (``tests/lint_fixtures/``, read only) the port's linter reports the same
  rule@line set as the JAX linter; the grammar checker gives the same
  findings on the same synthetic trees.
* ``hot-sync`` in torch: a fixture written here pins the exact lines.
"""

import json
import os

import pytest
import torch

from conftest import REPO_ROOT
from deepgo_tpu.analysis import grammar as jax_grammar
from deepgo_tpu.analysis import linter as jax_linter
from deepgo_tpu.analysis.config import RULES as JAX_RULES
from deepgo_tpu.analysis.config import LintConfig as JaxLintConfig
from deepgo_tpu.obs import registry as jax_registry

from deepgo_tpu_torch import cli
from deepgo_tpu_torch.analysis import config, grammar, linter
from deepgo_tpu_torch.analysis.config import LintConfig

torch.set_num_threads(2)

FIXTURES = os.path.join("tests", "lint_fixtures")
# the fixtures of the rules both packages share; the XLA contract rules
# (jit-boundary, donation, constant-upload, and the JAX hot-sync calls)
# are not rules of the port
SHARED_FIXTURES = ("bad_atomic.py", "bad_bare_sleep.py",
                   "bad_determinism.py", "bad_pragma.py", "bad_thread.py",
                   "bad_typed_error.py", "clean_ok.py")


@pytest.fixture(scope="module", autouse=True)
def private_jax_registry():
    saved = jax_registry._default
    jax_registry._default = jax_registry.MetricsRegistry()
    yield
    jax_registry._default = saved


def keyed(findings):
    return sorted((f.rule, f.line) for f in findings)


def test_port_lints_clean_strict():
    findings = linter.run_lint(REPO_ROOT)
    strict = [f for f in findings if f.level == "strict"]
    assert strict == [], "\n" + linter.format_report(strict)
    assert findings == []  # no warn roots either


def test_port_grammar_has_no_drift():
    findings = grammar.lint_grammar(REPO_ROOT)
    assert findings == [], "\n" + linter.format_report(findings)
    code = grammar.extract_code_grammar(REPO_ROOT, LintConfig())
    # the port emits the documented names: metrics, events, fault sites
    assert len(code["metrics"]) > 50 and len(code["sites"]) > 5


def test_policy_points_at_the_port():
    cfg = LintConfig()
    assert cfg.strict_roots == ("deepgo_tpu_torch", "chip_smoke.py")
    assert cfg.warn_roots == ()
    assert cfg.grammar_code_roots == ("deepgo_tpu_torch",)
    assert cfg.grammar_docs == JaxLintConfig().grammar_docs
    for scope in (cfg.determinism_scope, cfg.sleep_scope, cfg.assert_scope,
                  cfg.atomic_exempt):
        for path in scope:
            assert path.startswith("deepgo_tpu_torch/")
            assert os.path.exists(os.path.join(REPO_ROOT, path)), path
    for path, fn in cfg.hot_sync_scope:
        with open(os.path.join(REPO_ROOT, path)) as f:
            assert f"def {fn}(" in f.read(), (path, fn)
    assert set(config.RULES) == set(JAX_RULES) - {
        "jit-boundary", "donation", "constant-upload"}
    assert not hasattr(cfg, "traced_scope")


@pytest.mark.parametrize("name", SHARED_FIXTURES)
def test_fixture_findings_like_jax(name):
    path = os.path.join(FIXTURES, name)
    got = linter.run_lint(REPO_ROOT, paths=[path])
    want = jax_linter.run_lint(REPO_ROOT, paths=[path])
    assert keyed(got) == keyed(want)
    assert [f.to_dict() for f in got] == [f.to_dict() for f in want]
    assert bool(got) == (name != "clean_ok.py")


HOT_SYNC = '''"""torch hot-sync fixture: every function is hot in explicit-path mode."""
import numpy as np
import torch


def peek(loss):
    return loss.item()  # line 7


def rows(out):
    return out.cpu().numpy()  # line 11: two syncs


def listed(losses):
    return losses.tolist()  # line 15


def fence(x):
    torch.cuda.synchronize()  # line 19
    return x


def timed(start, end):
    end.synchronize()  # line 24: an Event
    return start.elapsed_time(end)


def fold(step, model, batch):
    return float(step(model, batch))  # line 29


def host_math(samples):
    return float(np.percentile(samples, 50))  # host numpy: fine


def nested(fn):
    def inner(x):
        return x.item()  # line 38: nested defs inherit the scope
    return inner


def declared(forward, batch):
    # lint: allow[hot-sync] fixture: the declared materialization point
    return forward(batch).cpu()
'''


def test_torch_hot_sync_fixture(tmp_path):
    (tmp_path / "hot.py").write_text(HOT_SYNC)
    got = linter.run_lint(str(tmp_path), paths=["hot.py"])
    assert keyed(got) == [("hot-sync", 7), ("hot-sync", 11),
                          ("hot-sync", 11), ("hot-sync", 15),
                          ("hot-sync", 19), ("hot-sync", 24),
                          ("hot-sync", 29), ("hot-sync", 38)]
    assert all(f.hint for f in got)


def test_hot_sync_binds_only_in_scope(tmp_path):
    """Outside explicit-path mode only the configured functions are hot."""
    (tmp_path / "pkg").mkdir()
    (tmp_path / "pkg" / "eng.py").write_text(
        "def _dispatch(x):\n    return x.item()\n\n\n"
        "def report(x):\n    return x.item()\n")
    cfg = LintConfig(strict_roots=("pkg",),
                     hot_sync_scope=(("pkg/eng.py", "_dispatch"),))
    got = linter.run_lint(str(tmp_path), cfg, grammar=False)
    assert keyed(got) == [("hot-sync", 2)]


def test_xla_rule_pragmas_are_unknown_rules(tmp_path):
    (tmp_path / "p.py").write_text(
        "def f(x):\n"
        "    # lint: allow[jit-boundary] the XLA rule\n"
        "    return x\n")
    got = linter.run_lint(str(tmp_path), paths=["p.py"])
    assert keyed(got) == [("pragma", 2)]
    assert "names no known rule" in got[0].message


CODE = """
def setup(reg, metrics, faults):
    c = reg.counter("deepgo_widget_spins_total", "spins")
    reg.gauge("deepgo_widget_depth", "depth")
    metrics.write("loop_widget_turn", n=1)
    metrics.write("obs_widget_orphan", n=2)
    faults.check("widget_io")
    return c
"""

DOCS = """
| metric | kind |
|---|---|
| `deepgo_widget_spins_total` / `_stops_total` | counter |
| `deepgo_widget_depth` | gauge |
| `deepgo_widget_gone` | gauge |

Events: `loop_widget_turn` is emitted per turn.

| site | location |
|---|---|
| `widget_io` | the widget gather |
| `widget_lost` | nowhere |
"""


@pytest.mark.parametrize("case", ["both", "clean_code", "no_docs"])
def test_grammar_findings_like_jax(tmp_path, case):
    code = {"both": CODE, "clean_code": CODE.replace(
        'metrics.write("obs_widget_orphan", n=2)\n', ""),
        "no_docs": CODE}[case]
    docs = "" if case == "no_docs" else DOCS
    (tmp_path / "pkg").mkdir()
    (tmp_path / "pkg" / "mod.py").write_text(code)
    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "grammar.md").write_text(docs)
    spec = dict(grammar_code_roots=("pkg",),
                grammar_docs=("docs/grammar.md",))
    got = grammar.lint_grammar(str(tmp_path), LintConfig(**spec))
    want = jax_grammar.lint_grammar(str(tmp_path), JaxLintConfig(**spec))
    assert [f.to_dict() for f in got] == [f.to_dict() for f in want]
    assert got  # every case has drift in one direction or both


def test_cli_lint_clean_tree_exits_zero(capsys):
    cli.main(["lint", "--root", REPO_ROOT])  # no SystemExit(1)
    assert "lint: 0 finding(s), 0 warning(s)" in capsys.readouterr().out


def test_cli_lint_json_exit_code(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["lint", "--root", REPO_ROOT, "--json", "--no-grammar",
                  os.path.join(FIXTURES, "bad_atomic.py")])
    assert exc.value.code == 1
    out = json.loads(capsys.readouterr().out)
    assert out["strict"] == 3 and out["warn"] == 0
    assert {f["rule"] for f in out["findings"]} == {"atomic-write"}
    assert all(f["hint"] for f in out["findings"])
