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
    assert os.path.join("deepgo_tpu_torch", "ops", "cuda_expand.py") in rel


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_package_import(path):
    bad = sorted({r for r in imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"
