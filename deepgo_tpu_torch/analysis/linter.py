"""AST invariant linter of the port (``cli lint``).

The port's copy of ``deepgo_tpu/analysis/linter.py``, with the policy of
``analysis/config.py``. Six per-file rules, each guarding a convention the
system's headline guarantees rest on (docs/static_analysis.md has the
full table):

  * ``atomic-write`` — durable artifacts go through ``utils/atomicio``:
    a raw ``open(path, "w")`` destroys the previous contents the moment
    it runs, so a crash mid-write leaves a torn file where the recovery
    artifact used to be. Write-mode ``open`` and ``np.save``/``np.savez``
    straight to a path are findings; append-mode streams (JSONL sinks,
    torn-tail tolerant by design) are not.
  * ``determinism`` — step-indexed / replay / serving-dispatch modules
    must be pure functions of (seed, step): ``time.time()``, module-level
    ``random.*``, unseeded ``random.Random()``, and ``np.random`` global
    state are findings there (injectable ``clock=``/``rng=`` is the fix;
    ``np.random.default_rng(seed)`` and friends are fine).
  * ``thread-discipline`` — every ``threading.Thread`` carries ``name=``
    (leak reports and the lock sanitizer attribute by thread name) and
    is either ``daemon=`` or joined somewhere in its module.
  * ``typed-error`` — no bare ``except:`` anywhere; no ``assert`` in the
    service layers (typed errors must survive ``python -O``).
  * ``bare-sleep`` — no direct ``time.sleep`` in ``serving/``: a bare
    sleep in a dispatcher/router thread is an invisible stall — no span,
    no fault site, uninjectable under test. Delays go through an
    injected ``sleep=`` hook or a waitable event; chaos brownouts go
    through ``utils/faults.maybe_slow`` (the one legal sleep).
  * ``hot-sync`` — ``.item()`` / ``.tolist()`` / ``.cpu()`` /
    ``.numpy()`` / ``synchronize()`` / ``float(<call>)`` in a dispatcher
    thread, train-step loop, or per-request path waits for the card;
    legal only at the declared materialization points (reasoned pragmas).

Findings carry file:line, rule id, and a fix hint. A narrow pragma
allowlist (``# lint: allow[RULE] reason`` — reason mandatory) admits
the rare legitimate exception without widening the rule.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re

from .config import NP_RANDOM_OK, PRAGMA_RE, RULES, LintConfig

_HINTS = {
    "atomic-write": "route the write through utils/atomicio.atomic_write",
    "determinism": "inject clock=/rng= (or np.random.default_rng(seed))",
    "thread-discipline": "threading.Thread(..., name=..., daemon=True) "
                         "or join() it",
    "typed-error": "raise a typed error (survives `python -O`); "
                   "catch specific exceptions",
    "bare-sleep": "inject a sleep= hook / wait on an Event; brownout "
                  "delays go through utils/faults.maybe_slow",
    "pragma": "pragmas need a reason: # lint: allow[RULE] why",
    "hot-sync": "keep device values on the device; materialize once at the "
                "declared point (pragma it with the reason)",
}


@dataclasses.dataclass
class Finding:
    rule: str
    path: str
    line: int
    level: str  # "strict" | "warn"
    message: str

    @property
    def hint(self) -> str:
        return _HINTS.get(self.rule, "")

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "level": self.level, "message": self.message,
                "hint": self.hint}

    def format(self) -> str:
        return (f"{self.path}:{self.line}: [{self.level}] {self.rule}: "
                f"{self.message}")


def _const_str(node) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _dotted(node) -> str:
    """'np.random.seed' for an Attribute chain, '' when not a pure chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class _FileChecker(ast.NodeVisitor):
    def __init__(self, rel: str, source: str, config: LintConfig):
        self.rel = rel
        self.source = source
        self.config = config
        self.findings: list[Finding] = []
        self._has_join = ".join(" in source
        self._det = config.in_scope(rel, config.determinism_scope)
        self._assert = config.in_scope(rel, config.assert_scope)
        self._atomic = rel not in config.atomic_exempt
        self._sleep = config.in_scope(rel, config.sleep_scope)
        self._sleep_aliases: set[str] = set()  # from time import sleep [as x]

    def _add(self, rule: str, node, message: str) -> None:
        self.findings.append(Finding(rule, self.rel, node.lineno,
                                     "strict", message))

    # -- atomic-write ------------------------------------------------------

    def _check_open(self, node: ast.Call) -> None:
        mode = None
        if len(node.args) >= 2:
            mode = _const_str(node.args[1])
        for kw in node.keywords:
            if kw.arg == "mode":
                mode = _const_str(kw.value)
        if mode and any(c in mode for c in "wx"):
            self._add("atomic-write", node,
                      f'raw open(..., "{mode}") on a durable path '
                      "outside utils/atomicio")

    def _check_np_save(self, node: ast.Call, fn: str) -> None:
        if not node.args:
            return
        dst = node.args[0]
        # np.save(f, ...) into a handle (atomic_write body) is fine; a
        # path expression or literal bypasses the atomic writer
        if isinstance(dst, (ast.Name, ast.Attribute)):
            return
        self._add("atomic-write", node,
                  f"np.{fn} straight to a path bypasses utils/atomicio")

    # -- determinism -------------------------------------------------------

    def _check_determinism(self, node: ast.Call, dotted: str) -> None:
        if dotted == "time.time":
            self._add("determinism", node,
                      "wall clock time.time() in a step-indexed/replay "
                      "module")
        elif dotted == "random.Random" and not node.args:
            self._add("determinism", node,
                      "unseeded random.Random() — hidden nondeterminism "
                      "in a replay-bearing module")
        elif dotted.startswith("random.") and dotted.count(".") == 1 \
                and dotted != "random.Random":
            self._add("determinism", node,
                      f"global-state {dotted}() in a step-indexed/replay "
                      "module")
        elif dotted.startswith(("np.random.", "numpy.random.")):
            fn = dotted.rsplit(".", 1)[1]
            if fn not in NP_RANDOM_OK:
                self._add("determinism", node,
                          f"np.random.{fn} uses the global numpy RNG "
                          "state")

    # -- thread-discipline -------------------------------------------------

    def _check_thread(self, node: ast.Call) -> None:
        kwargs = {kw.arg for kw in node.keywords}
        if None in kwargs:  # **kw — can't see through it
            return
        if "name" not in kwargs:
            self._add("thread-discipline", node,
                      "anonymous threading.Thread — leak reports and "
                      "the lock sanitizer cannot attribute it")
        if "daemon" not in kwargs and not self._has_join:
            self._add("thread-discipline", node,
                      "thread is neither daemon= nor joined in this "
                      "module")

    # -- bare-sleep --------------------------------------------------------

    def _check_sleep(self, node: ast.Call, dotted: str) -> None:
        # time.sleep(...) by attribute, or a from-import alias call.
        # `sleep=time.sleep` default args are references, not calls, and
        # an injected `sleep(...)` parameter is a Name the import scan
        # never saw — both stay legal (that IS the prescribed fix).
        bare = dotted == "time.sleep" or (
            isinstance(node.func, ast.Name)
            and node.func.id in self._sleep_aliases)
        if bare:
            self._add("bare-sleep", node,
                      "direct time.sleep in serving code — an invisible "
                      "stall with no span, no fault site, and no test "
                      "injection point")

    # -- visitors ----------------------------------------------------------

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module == "time":
            for alias in node.names:
                if alias.name == "sleep":
                    self._sleep_aliases.add(alias.asname or alias.name)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Name) and func.id == "open" and self._atomic:
            self._check_open(node)
        dotted = _dotted(func)
        if dotted in ("threading.Thread",) or (
                isinstance(func, ast.Name) and func.id == "Thread"):
            self._check_thread(node)
        if self._atomic and dotted.startswith(("np.", "numpy.")):
            fn = dotted.split(".", 1)[1]
            if fn in ("save", "savez", "savez_compressed"):
                self._check_np_save(node, fn)
        if self._det and dotted:
            self._check_determinism(node, dotted)
        if self._sleep:
            self._check_sleep(node, dotted)
        self.generic_visit(node)

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        if node.type is None:
            self._add("typed-error", node,
                      "bare except: swallows SystemExit/KeyboardInterrupt "
                      "and hides the fault type")
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        if self._assert:
            self._add("typed-error", node,
                      "assert in service-layer code vanishes under "
                      "`python -O`")
        self.generic_visit(node)


# host-side numeric namespaces float() may materialize from without a sync
_HOST_FLOAT_OK = ("np.", "numpy.", "math.", "len", "round", "int", "str",
                  "min", "max", "sum", "abs")

# tensor methods that copy a device value to the host (or wait for it)
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy", "synchronize")


def _child_functions(fn):
    """Function defs whose nearest enclosing function is ``fn``."""
    out = []
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(node)
            continue
        stack.extend(ast.iter_child_nodes(node))
    return out


def _scoped_walk(fn):
    """Every node lexically inside ``fn`` EXCLUDING nested function
    subtrees (those get their own pass, with the inherited hot context)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


class _HotSyncChecker:
    """``hot-sync``: a host<->device synchronization inside a hot scope
    (config ``hot_sync_scope``; every function in explicit-path mode) —
    ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``torch.cuda.synchronize()`` / ``Event.synchronize()``, and
    ``float(<call>)`` on anything but host numerics. Nested functions
    inherit their enclosing function's scope."""

    def __init__(self, rel: str, config: LintConfig):
        self.rel = rel
        self.config = config
        self.findings: list[Finding] = []
        self._hot_fns = {fn for path, fn in config.hot_sync_scope
                         if path == rel}

    def check(self, tree: ast.Module) -> None:
        for stmt in tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_function(stmt, self._is_hot(stmt.name))
            elif isinstance(stmt, ast.ClassDef):
                for sub in stmt.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        self._check_function(sub, self._is_hot(sub.name))

    def _is_hot(self, name: str) -> bool:
        return self.config.all_scopes or name in self._hot_fns

    def _check_function(self, fn, hot: bool) -> None:
        if hot:
            for node in _scoped_walk(fn):
                if isinstance(node, ast.Call):
                    self._check_call(node)
        for sub in _child_functions(fn):
            self._check_function(sub, hot)

    def _add(self, node, message: str) -> None:
        self.findings.append(Finding("hot-sync", self.rel, node.lineno,
                                     "strict", message))

    def _check_call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in _SYNC_METHODS \
                and (func.attr == "synchronize" or not node.args):
            what = _dotted(func) or f".{func.attr}"
            self._add(node, f"{what}() in a hot path waits for the card "
                            "(a host<->device sync per call)")
        elif isinstance(func, ast.Name) and func.id == "float" \
                and len(node.args) == 1 \
                and isinstance(node.args[0], ast.Call):
            inner = _dotted(node.args[0].func)
            if inner and not inner.startswith(_HOST_FLOAT_OK):
                self._add(node, f"float({inner}(...)) materializes a device "
                                "value per call in a hot path")


def _collect_pragmas(rel: str, source: str) -> tuple[dict, list[Finding]]:
    """line -> (rule, reason) for every pragma; malformed ones (missing
    reason, unknown rule) are findings themselves."""
    pragmas: dict[int, tuple[str, str]] = {}
    findings: list[Finding] = []
    for i, text in enumerate(source.splitlines(), start=1):
        m = PRAGMA_RE.search(text)
        if not m:
            continue
        rule, reason = m.group(1), m.group(2)
        if rule not in RULES:
            findings.append(Finding("pragma", rel, i, "strict",
                                    f"allow[{rule}] names no known rule"))
            continue
        if not reason:
            findings.append(Finding("pragma", rel, i, "strict",
                                    f"allow[{rule}] without a reason"))
            continue
        pragmas[i] = (rule, reason)
    return pragmas, findings


def lint_file(path: str, rel: str, config: LintConfig) -> list[Finding]:
    with open(path, encoding="utf-8") as f:
        source = f.read()
    pragmas, findings = _collect_pragmas(rel, source)
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError as e:
        findings.append(Finding("typed-error", rel, e.lineno or 1,
                                "strict", f"file does not parse: {e.msg}"))
        return findings
    checker = _FileChecker(rel, source, config)
    checker.visit(tree)
    hot = _HotSyncChecker(rel, config)
    hot.check(tree)
    checker.findings.extend(hot.findings)
    lines = source.splitlines()
    for f_ in checker.findings:
        allowed = False
        for at in (f_.line, f_.line - 1):
            entry = pragmas.get(at)
            if entry and entry[0] == f_.rule:
                # a standalone pragma line covers the NEXT line; an
                # end-of-line pragma covers its own
                if at == f_.line or lines[at - 1].lstrip().startswith("#"):
                    allowed = True
                    break
        if not allowed:
            findings.append(f_)
    return findings


def _iter_py(root: str, sub: str, config: LintConfig):
    top = os.path.join(root, sub)
    if os.path.isfile(top):
        yield top, sub.replace(os.sep, "/")
        return
    for dirpath, dirnames, filenames in os.walk(top):
        dirnames[:] = [d for d in dirnames if d not in config.skip_parts]
        for name in sorted(filenames):
            if name.endswith(".py"):
                full = os.path.join(dirpath, name)
                yield full, os.path.relpath(full, root).replace(os.sep, "/")


def run_lint(root: str, config: LintConfig | None = None,
             paths: list[str] | None = None,
             grammar: bool = True) -> list[Finding]:
    """Lint the repo at ``root`` (or just ``paths``, repo-relative).

    Explicit paths open every rule's scope gate (``all_scopes``) and skip
    the repo-level grammar check — that is the fixture-testing mode."""
    config = config or LintConfig()
    findings: list[Finding] = []
    if paths is not None:
        config = dataclasses.replace(config, all_scopes=True)
        targets = [(os.path.join(root, p), p.replace(os.sep, "/"))
                   for p in paths]
        for full, rel in targets:
            findings.extend(lint_file(full, rel, config))
        return findings

    for sub in config.strict_roots:
        for full, rel in _iter_py(root, sub, config):
            findings.extend(lint_file(full, rel, config))
    for sub in config.warn_roots:
        for full, rel in _iter_py(root, sub, config):
            for f_ in lint_file(full, rel, config):
                f_.level = "warn"
                findings.append(f_)
    if grammar:
        from .grammar import lint_grammar

        findings.extend(lint_grammar(root, config))
    findings.sort(key=lambda f_: (f_.path, f_.line, f_.rule))
    return findings


def format_report(findings: list[Finding], files: int | None = None) -> str:
    out = [f.format() for f in findings]
    strict = sum(1 for f in findings if f.level == "strict")
    warn = len(findings) - strict
    tail = f"lint: {strict} finding(s), {warn} warning(s)"
    if files is not None:
        tail += f" over {files} file(s)"
    if strict:
        hints = {f.rule: f.hint for f in findings
                 if f.level == "strict" and f.hint}
        for rule, hint in sorted(hints.items()):
            out.append(f"  fix[{rule}]: {hint}")
    out.append(tail)
    return "\n".join(out)
