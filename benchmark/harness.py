"""One run of one cell: find its files, drive it, judge it, print its line.

Everything a cell needs is found by name from ``BENCHMARK.json``:

- ``configs/<config>.json``: the network's sizes (``file`` in the config's
  entry);
- ``traffic/<traffic>.json``: the mix's parameters; its ``kind`` names the
  driver, ``drivers/<kind>.py``, which builds the cell's inputs, drives the
  program through its window and judges what the program produced against
  ``reference/``;
- ``limits/<workload>.json``: the limit of each number the judgement
  compares;
- ``metrics/<metric>.py``: one reader per per-layer metric, ``read(run)``,
  returning the metric or None where it finds nothing to read.

A cell, a mix or a metric is added by adding files and entries; no file
here changes.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "deepgo_tpu")


class CellError(RuntimeError):
    """The cell cannot run: a missing file, entry or device."""


def load_spec(repo: Path) -> dict:
    return json.loads((repo / "BENCHMARK.json").read_text())


def cell_files(spec: dict, workload: str, repo: Path) -> dict:
    """The cell's entry and the parsed files it names."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    bench = Path(__file__).resolve().parent
    return {
        "cell": cell,
        "config": json.loads((repo / config["file"]).read_text()),
        "traffic": json.loads((bench / "traffic" / f"{cell['traffic']}.json")
                              .read_text()),
        "limits": json.loads((bench / "limits" / f"{workload}.json")
                             .read_text()),
    }


def _listed(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def end_to_end(spec: dict, workload: str) -> list[dict]:
    return [m for m in spec["end_to_end"] if _listed(m, workload)]


def per_layer(spec: dict, workload: str) -> list[dict]:
    """The per-layer metrics this cell reports: those that list it, or
    that list no cells and move an end-to-end metric it reports."""
    mine = {m["name"] for m in end_to_end(spec, workload)}
    return [m for m in spec["per_layer"]
            if workload in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in mine)]


def load_reader(name: str):
    """``metrics/<name>.py`` (a name may hold dots, so by path)."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_driver(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, compared
    whole (``deepgo_tpu_torch`` is not ``deepgo_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_info(device: str, chips: int) -> dict:
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def run(argv, t_start: float, device: str = "cuda", patch: str | None = None,
        overrides: dict | None = None, control: bool = False) -> dict:
    """Drive one run; returns the result line as a dict. ``device="cpu"``,
    ``patch`` ("module:function", called before the run builds anything)
    and ``overrides`` (merged over the config, traffic and limits files)
    serve the CPU tests only. ``control=True`` adds ``control``: the
    compared numbers of the reference computed in the precision below the
    configuration's, in the program's place, and its own ``correct``,
    judged by the same limits as the program's (``control.py``)."""
    args = parse(argv)
    repo = ROOT.parent
    spec = load_spec(repo)
    files = cell_files(spec, args.workload, repo)
    for key, extra in (overrides or {}).items():
        files[key] = {**files[key], **extra}
    chips = files["cell"]["chips"]
    if device == "cuda":
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            count = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
            raise CellError(f"{args.workload} needs {chips} CUDA device(s); "
                            f"this machine has {count}")
    if patch:
        call_patch(patch)
    driver = load_driver(files["traffic"]["kind"])
    ctx = types.SimpleNamespace(
        workload=args.workload, seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), device=device, chips=chips, t_start=t_start,
        cfg=files["config"], traffic=files["traffic"],
        limits=files["limits"], patch=patch, control=control)
    out = driver.run(ctx)
    found = forbidden_modules()
    if found:
        raise CellError(f"modules loaded in the run: {', '.join(found)}")
    if args.trace:
        from . import cost, trace

        reading = types.SimpleNamespace(
            summary=out["trace"], counters=out["counters"], cfg=ctx.cfg,
            traffic=ctx.traffic, cards=chips, cost=cost,
            peak=cost.peak(device_info(device, chips)["kind"])
            if device == "cuda" else None)
        metrics = {}
        for m in per_layer(spec, args.workload):
            value = load_reader(m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {}
        for m in end_to_end(spec, args.workload):
            value = out["setup_s"] if m["name"] == "setup_s" \
                else out["e2e"][m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {**device_info(device, chips),
           "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace:
        dev["busy_s"] = out["trace"]["device"]["busy_s"]
        dev["window_s"] = out["trace"]["device"]["window_s"]
    checks = {k: {"value": v, "limit": lim}
              for k, (v, lim) in out["checks"].items()}
    correct = all(v <= lim for v, lim in out["checks"].values())
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    if args.trace:
        from . import trace

        line["breakdown"] = trace.breakdown(out["trace"])
    if control:
        low = out["control"]["control"]
        judged = [k for k in files["limits"] if k in low]
        line["control"] = {**out["control"], "correct": all(
            low[k] <= files["limits"][k] for k in judged)}
    line["checks"] = checks
    return line


_patched: set[str] = set()


def call_patch(patch: str) -> None:
    """Plant a fault once in this process (later runs in it reuse it)."""
    if patch in _patched:
        return
    _patched.add(patch)
    module, fn = patch.split(":")
    getattr(importlib.import_module(module), fn)()


def main(argv, t_start: float) -> int:
    try:
        line = run(argv, t_start)
    except CellError as e:
        print(f"benchmark: {e}", file=sys.stderr, flush=True)
        return 2
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def prepare_environment(repo: Path) -> None:
    """Caches at fixed paths inside the checkout, and no flight records of
    the program's on disk."""
    cache = repo / ".bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(cache / "torch_extensions"))
    os.environ["DEEPGO_FLIGHT"] = "0"
