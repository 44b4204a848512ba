"""Code <-> docs grammar drift checker (rule id ``grammar-drift``).

The port's copy of ``deepgo_tpu/analysis/grammar.py``, run with the port's
policy (``analysis/config.py``): the port's code against the repo's docs,
which it emits the same names as.

The observability story only works if the grammar is closed: every
``deepgo_*`` metric, ``obs_*``/``loop_*``/``fleet_*`` event, and
``DEEPGO_FAULTS`` site the code emits must be documented (dashboards and
runbooks are built off the tables in docs/observability.md,
docs/robustness.md, docs/loop.md), and every token those tables promise
must still be emitted (a renamed metric silently orphans every alert
built on the old name). This module checks both directions.

Code side (AST, never regex-over-source):

  * metrics — the first string argument of ``registry.counter/gauge/
    histogram(...)`` calls;
  * events — the first string argument of ``*.write(...)`` calls with a
    grammar prefix;
  * fault sites — the first string argument of ``faults.check(...)``.

Docs side: backticked tokens with a grammar prefix anywhere in the
designated docs, plus the fault-site table (the ``| site | location |``
table in robustness.md). Two docs idioms are understood:

  * label sets are stripped — ``deepgo_fleet_shed_total{tier,reason}``
    documents ``deepgo_fleet_shed_total``;
  * suffix continuations expand against the preceding full token on the
    same line — ``deepgo_serving_boards_total`` / ``_dispatches_total``
    documents ``deepgo_serving_dispatches_total`` (matched by shared
    2-part prefix + suffix, so the compression the tables already use
    keeps working).
"""

from __future__ import annotations

import ast
import os
import re

from .config import LintConfig

# the checked-in policy owns the prefix list (analysis/config.py); this
# module-level alias keeps the historical import surface working
GRAMMAR_PREFIXES = LintConfig().grammar_prefixes

_BACKTICK_RE = re.compile(r"`([^`]+)`")
_TOKEN_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


# ---------------------------------------------------------------------------
# code side

def _first_str(node: ast.Call) -> str | None:
    if node.args and isinstance(node.args[0], ast.Constant) \
            and isinstance(node.args[0].value, str):
        return node.args[0].value
    return None


class _CodeGrammar(ast.NodeVisitor):
    """tokens -> (rel, line) of the first emission site."""

    def __init__(self, rel: str, prefixes: tuple = GRAMMAR_PREFIXES):
        self.rel = rel
        # every prefix except the metric namespace is an event namespace
        self._event_prefixes = tuple(p for p in prefixes
                                     if p != "deepgo_")
        self.metrics: dict[str, tuple] = {}
        self.events: dict[str, tuple] = {}
        self.sites: dict[str, tuple] = {}

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute):
            arg = _first_str(node)
            if arg:
                where = (self.rel, node.lineno)
                if func.attr in ("counter", "gauge", "histogram") \
                        and arg.startswith("deepgo_"):
                    self.metrics.setdefault(arg, where)
                elif func.attr == "write" \
                        and arg.startswith(self._event_prefixes):
                    self.events.setdefault(arg, where)
                elif func.attr == "check" \
                        and isinstance(func.value, ast.Name) \
                        and func.value.id in ("faults", "faults_mod"):
                    self.sites.setdefault(arg, where)
        self.generic_visit(node)


def _walk_py(root: str, sub: str, config: LintConfig):
    top = os.path.join(root, sub)
    if os.path.isfile(top):
        yield top, sub
        return
    for dirpath, dirnames, filenames in os.walk(top):
        dirnames[:] = [d for d in dirnames if d not in config.skip_parts]
        for name in sorted(filenames):
            if name.endswith(".py"):
                full = os.path.join(dirpath, name)
                yield full, os.path.relpath(full, root)


def extract_code_grammar(root: str, config: LintConfig) -> dict:
    metrics: dict[str, tuple] = {}
    events: dict[str, tuple] = {}
    sites: dict[str, tuple] = {}
    for sub in config.grammar_code_roots:
        for full, rel in _walk_py(root, sub, config):
            rel = rel.replace(os.sep, "/")
            try:
                with open(full, encoding="utf-8") as f:
                    tree = ast.parse(f.read(), filename=rel)
            except (OSError, SyntaxError):
                continue  # the linter proper reports parse failures
            v = _CodeGrammar(rel, config.grammar_prefixes)
            v.visit(tree)
            for src, dst in ((v.metrics, metrics), (v.events, events),
                             (v.sites, sites)):
                for tok, where in src.items():
                    dst.setdefault(tok, where)
    return {"metrics": metrics, "events": events, "sites": sites}


# ---------------------------------------------------------------------------
# docs side

def _clean(token: str) -> str | None:
    """`deepgo_x_total{a,b}` -> deepgo_x_total; None for non-tokens
    (wildcards, dotted paths, flags)."""
    token = token.split("{")[0]
    if not _TOKEN_RE.match(token):
        return None
    return token


def extract_doc_grammar(root: str, config: LintConfig) -> dict:
    """full tokens, (full, continuation) pairs, fault-site table tokens —
    each mapped to (doc, line) — plus the concatenated raw text."""
    full: dict[str, tuple] = {}
    conts: list[tuple] = []  # (full_token, continuation, doc, line)
    sites: dict[str, tuple] = {}
    raw_parts = []
    for doc in config.grammar_docs:
        path = os.path.join(root, doc)
        try:
            with open(path, encoding="utf-8") as f:
                text = f.read()
        except OSError:
            continue
        raw_parts.append(text)
        in_site_table = False
        for lineno, line in enumerate(text.splitlines(), start=1):
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            if line.lstrip().startswith("|"):
                header = [c.strip("` *").lower() for c in cells]
                if header[:2] == ["site", "location"]:
                    in_site_table = True
                    continue
                if in_site_table:
                    if set(cells[0]) <= {"-", " ", ":"}:
                        continue  # the |---|---| separator row
                    m = _BACKTICK_RE.search(cells[0])
                    tok = _clean(m.group(1)) if m else None
                    if tok:
                        sites.setdefault(tok, (doc, lineno))
                    continue
            else:
                in_site_table = False
            last_full = None
            for m in _BACKTICK_RE.finditer(line):
                tok = _clean(m.group(1))
                if tok is None:
                    continue
                if tok.startswith(config.grammar_prefixes):
                    full.setdefault(tok, (doc, lineno))
                    last_full = tok
                elif tok.startswith("_") and last_full is not None:
                    conts.append((last_full, tok, doc, lineno))
    return {"full": full, "continuations": conts, "sites": sites,
            "raw": "\n".join(raw_parts)}


def _shared_parts(a: str, b: str) -> int:
    pa, pb = a.split("_"), b.split("_")
    n = 0
    for x, y in zip(pa, pb):
        if x != y:
            break
        n += 1
    return n


def _continuation_covers(token: str, conts: list[tuple]) -> bool:
    return any(token.endswith(cont) and _shared_parts(token, base) >= 2
               for base, cont, _doc, _line in conts)


def _word_in(token: str, text: str) -> bool:
    return re.search(rf"(?<![A-Za-z0-9_]){re.escape(token)}(?![A-Za-z0-9_])",
                     text) is not None


# ---------------------------------------------------------------------------
# the check

def lint_grammar(root: str, config: LintConfig | None = None) -> list:
    from .linter import Finding

    config = config or LintConfig()
    code = extract_code_grammar(root, config)
    docs = extract_doc_grammar(root, config)
    findings: list[Finding] = []
    doc_names = ", ".join(os.path.basename(d) for d in config.grammar_docs)

    # code -> docs: everything emitted must be documented
    for kind, label in (("metrics", "metric"), ("events", "event"),
                        ("sites", "fault site")):
        for token, (rel, line) in sorted(code[kind].items()):
            documented = (
                token in docs["full"]
                or token in docs["sites"]
                or _continuation_covers(token, docs["continuations"])
                or _word_in(token, docs["raw"])
            )
            if not documented:
                findings.append(Finding(
                    "grammar-drift", rel, line, "strict",
                    f"{label} {token!r} is emitted here but appears in "
                    f"none of the grammar docs ({doc_names})"))

    # docs -> code: everything promised must still be emitted
    code_all = set(code["metrics"]) | set(code["events"]) | set(code["sites"])
    for token, (doc, line) in sorted(docs["full"].items()):
        if token in config.grammar_ignore:
            continue
        if token not in code_all:
            findings.append(Finding(
                "grammar-drift", doc, line, "strict",
                f"documented token {token!r} is never emitted in code "
                "(renamed or removed without a doc update?)"))
    for base, cont, doc, line in docs["continuations"]:
        if any(t.endswith(cont) and _shared_parts(t, base) >= 2
               for t in code_all):
            continue
        findings.append(Finding(
            "grammar-drift", doc, line, "strict",
            f"documented continuation {base!r} / {cont!r} expands to no "
            "emitted token"))
    for token, (doc, line) in sorted(docs["sites"].items()):
        if token in config.grammar_ignore:
            continue
        if token not in code["sites"]:
            findings.append(Finding(
                "grammar-drift", doc, line, "strict",
                f"documented fault site {token!r} has no faults.check() "
                "in code"))
    return findings
