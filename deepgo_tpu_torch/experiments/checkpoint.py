"""The JAX package's checkpoint format (v1 and v2 ``.npz``), read and write.

The port's own copy of ``deepgo_tpu/experiments/checkpoint.py``: a ``.npz``
of flat leaves (``params_0000``, ..., ``opt_0000``, ...) plus a JSON
``meta`` member. Format v2's meta carries an ``integrity`` block — a CRC32
per stored array and a SHA-256 digest over all array payloads — that
``load_checkpoint(verify=True)`` checks, and may carry a ``mesh`` manifest
that is validated structurally. Every failure raises ``CheckpointError``.
Writes are atomic (``utils.atomicio``) and pass the ``ckpt_write`` fault
point; run directories hold rolling ``checkpoint-{step:08d}.npz`` files.

Leaves are stored in ``jax.tree.leaves`` order, which sorts dict keys
(``tree_leaves`` here): for the policy tree ``{"layers": [{"b", "w"},
...]}`` that is, per layer in order, the bias ``(19, 19, c_out)`` then the
weight ``(k, k, c_in, c_out)``; an SGD state stores ``rate`` then its
``velocity`` tree, an Adagrad state its ``accum`` tree then ``rate``. The
port writes the JAX layout (``models/convert.py``), so a file it writes
holds the arrays, CRC32s and digest the JAX package would write for the
same state, and either package loads the other's files.
``policy_state_dict`` rebuilds a ``PolicyCNN`` state dict from the leaves;
``load_model_like`` reads a checkpoint into a fresh ``PolicyCNN`` or
``ValueCNN`` shaped like a given one (the fleet's reload from a path).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import sys
import zipfile
import zlib

import numpy as np
import torch

from .. import BOARD_SIZE
from ..models.convert import params_from_jax
from ..models.policy_cnn import ModelConfig
from ..utils import faults
from ..utils.atomicio import atomic_write

FORMAT_VERSION = 2
SUPPORTED_VERSIONS = (1, 2)
MANIFEST_VERSION = 1

_CKPT_RE = re.compile(r"^checkpoint-(\d+)\.npz$")

# Model-shaping fields of the JAX package's ExperimentConfig and their
# defaults (experiments/experiment.py), for metas that omit some of them.
_EXPERIMENT_MODEL_DEFAULTS = {
    "num_layers": 3,
    "channels": 64,
    "channel_schedule": "",
    "first_kernel": 5,
    "kernel": 3,
    "final_relu": False,
    "compute_dtype": "bfloat16",
    "remat": False,
}


class CheckpointError(RuntimeError):
    """A checkpoint that cannot be trusted: missing, truncated, corrupt,
    from an unknown format, or shaped for a different model. Carries the
    path and a reason."""

    def __init__(self, path: str, reason: str):
        self.path = path
        self.reason = reason
        super().__init__(f"checkpoint {path}: {reason}")


def checkpoint_name(step: int) -> str:
    """Rolling per-step artifact name; zero-padded so lexicographic and
    numeric order agree for any run shorter than 10^8 steps."""
    return f"checkpoint-{step:08d}.npz"


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists in ``jax.tree.leaves``
    order: dict keys sorted, lists in order, None holds no leaf."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [] if tree is None else [tree]


def _rebuild(template, leaves):
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(item, leaves) for item in template)
    return None if template is None else next(leaves)


def unflatten_like(template, leaves, path: str = "<checkpoint>"):
    """Rebuild a tree with ``template``'s structure from flat ``leaves``;
    raises ``CheckpointError`` when their count or shapes disagree."""
    t_leaves = tree_leaves(template)
    if len(t_leaves) != len(leaves):
        raise CheckpointError(
            path, f"has {len(leaves)} leaves, template needs "
                  f"{len(t_leaves)} — checkpoint config and model "
                  f"architecture disagree")
    for i, (a, b) in enumerate(zip(t_leaves, leaves)):
        if tuple(np.shape(a)) != tuple(np.shape(b)):
            raise CheckpointError(
                path, f"leaf {i}: checkpoint shape {tuple(np.shape(b))} != "
                      f"template {tuple(np.shape(a))} — checkpoint config "
                      f"and model architecture disagree")
    return _rebuild(template, iter(leaves))


def manifest(params, opt_state, *, zero_opt: bool) -> dict:
    """The ``mesh`` manifest of a state on one device, as the JAX
    package's ``parallel.reshard.manifest`` writes it for a 1 x 1 mesh:
    params replicated; with ``zero_opt`` each optimizer leaf of rank >= 1
    placed on "data" along its first dimension."""
    def spec(leaf, zero):
        if zero and np.ndim(leaf) >= 1:
            return "PartitionSpec('data'" + ", None" * (np.ndim(leaf) - 1) + ")"
        return "PartitionSpec()"

    return {
        "version": MANIFEST_VERSION, "data": 1, "model": 1, "devices": 1,
        "zero_opt": bool(zero_opt),
        "params": [spec(leaf, False) for leaf in tree_leaves(params)],
        "opt_state": [spec(leaf, zero_opt)
                      for leaf in tree_leaves(opt_state)],
    }


def _leaf_bytes(arr: np.ndarray) -> bytes:
    return np.ascontiguousarray(arr).tobytes()


def _integrity(arrays: dict) -> dict:
    """Per-array CRC32s plus a whole-checkpoint SHA-256 over every array
    payload (sorted key order), stored in the JSON meta."""
    crcs = {}
    digest = hashlib.sha256()
    for key in sorted(arrays):
        data = _leaf_bytes(arrays[key])
        crcs[key] = zlib.crc32(data)
        digest.update(key.encode())
        digest.update(str(arrays[key].dtype).encode())
        digest.update(repr(tuple(arrays[key].shape)).encode())
        digest.update(data)
    return {"arrays": crcs, "digest": digest.hexdigest()}


def _verify_integrity(path: str, meta: dict, arrays: dict) -> None:
    if meta.get("format_version", 1) < 2:
        return  # v1 predates the integrity block: loadable, unverifiable
    integ = meta.get("integrity")
    if not isinstance(integ, dict) or "arrays" not in integ:
        raise CheckpointError(
            path, "format v2 without an integrity block in meta "
                  "(truncated meta, or written by a broken tool)")
    expected = integ["arrays"]
    if set(expected) != set(arrays):
        missing = sorted(set(expected) - set(arrays))
        extra = sorted(set(arrays) - set(expected))
        raise CheckpointError(
            path, f"array set mismatch vs meta (missing {missing}, "
                  f"unexpected {extra}) — partial or spliced file")
    got = _integrity(arrays)
    for key in sorted(arrays):
        if got["arrays"][key] != expected[key]:
            raise CheckpointError(
                path, f"CRC32 mismatch for array {key!r} — bit corruption")
    if got["digest"] != integ.get("digest"):
        raise CheckpointError(path, "whole-file digest mismatch — bit "
                                    "corruption")


def validate_manifest(manifest, path: str, *, n_params: int | None = None,
                      n_opt: int | None = None) -> None:
    """Structural validation of the ``mesh`` manifest a v2 meta may carry:
    the integrity block covers array payloads, not the meta itself."""
    if not isinstance(manifest, dict):
        raise CheckpointError(
            path, f"mesh manifest is {type(manifest).__name__}, not a dict "
                  f"— corrupt meta")
    for key in ("data", "model", "devices"):
        val = manifest.get(key)
        if not isinstance(val, int) or isinstance(val, bool) or val < 1:
            raise CheckpointError(
                path, f"mesh manifest {key}={val!r} is not a positive int "
                      f"— corrupt meta")
    if manifest["data"] * manifest["model"] != manifest["devices"]:
        raise CheckpointError(
            path, f"mesh manifest inconsistent: data={manifest['data']} × "
                  f"model={manifest['model']} != devices="
                  f"{manifest['devices']}")
    for key, want in (("params", n_params), ("opt_state", n_opt)):
        specs = manifest.get(key)
        if (not isinstance(specs, list)
                or not all(isinstance(s, str) for s in specs)):
            raise CheckpointError(
                path, f"mesh manifest {key} specs are not a list of "
                      f"partition-spec strings — corrupt meta")
        if want is not None and len(specs) != want:
            raise CheckpointError(
                path, f"mesh manifest lists {len(specs)} {key} specs but "
                      f"the checkpoint stores {want} arrays — spliced or "
                      f"corrupt meta")


def _open_npz(path: str):
    try:
        size = os.path.getsize(path)
    except OSError as e:
        raise CheckpointError(path, f"unreadable: {e}") from e
    if size == 0:
        raise CheckpointError(
            path, "zero-length file — crash before any bytes were written")
    try:
        return np.load(path, allow_pickle=False)
    except (zipfile.BadZipFile, ValueError, OSError, EOFError) as e:
        raise CheckpointError(
            path, f"not a readable npz ({e}) — truncated or corrupt") from e


def _read_member(z, key: str, path: str) -> np.ndarray:
    """npz members decompress lazily; a flipped byte or truncated tail
    surfaces here as a zip/zlib error, not at np.load time."""
    try:
        return z[key]
    except (zipfile.BadZipFile, zlib.error, ValueError, OSError, EOFError) as e:
        raise CheckpointError(
            path, f"array {key!r} unreadable ({e}) — truncated or corrupt") from e


def _read_meta(z, path: str) -> dict:
    if "meta" not in z.files:
        raise CheckpointError(
            path, "no meta entry — not a deepgo checkpoint, or the write "
                  "was torn before the meta member landed")
    try:
        meta = json.loads(bytes(_read_member(z, "meta", path)).decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise CheckpointError(path, f"meta entry is not valid JSON: {e}") from e
    if not isinstance(meta, dict):
        raise CheckpointError(path, "meta entry is not a JSON object")
    version = meta.get("format_version")
    if version not in SUPPORTED_VERSIONS:
        raise CheckpointError(
            path, f"format_version {version!r} not in supported "
                  f"{SUPPORTED_VERSIONS}")
    return meta


def save_checkpoint(path: str, params, opt_state, meta: dict) -> None:
    """Write ``params`` and ``opt_state`` (JAX-layout trees of arrays,
    ``models/convert.py``) and ``meta`` atomically: a crash, or an
    injected ``ckpt_write`` fault, leaves the previous file intact."""
    arrays = {}
    for i, leaf in enumerate(tree_leaves(params)):
        arrays[f"params_{i:04d}"] = np.asarray(leaf)
    for i, leaf in enumerate(tree_leaves(opt_state)):
        arrays[f"opt_{i:04d}"] = np.asarray(leaf)
    meta_json = json.dumps({
        "format_version": FORMAT_VERSION,
        "integrity": _integrity(arrays),
        **meta,
    })
    arrays["meta"] = np.frombuffer(meta_json.encode(), dtype=np.uint8)
    with atomic_write(path) as f:
        faults.check("ckpt_write")
        np.savez(f, **arrays)


def load_checkpoint(path: str, verify: bool = True):
    """Returns (meta dict, params_leaves list, opt_leaves list).

    ``verify=True`` (the default) checks every array against the meta's
    CRC32s and the whole-file digest, and the mesh manifest if present."""
    with _open_npz(path) as z:
        meta = _read_meta(z, path)
        p_keys = sorted(k for k in z.files if k.startswith("params_"))
        o_keys = sorted(k for k in z.files if k.startswith("opt_"))
        arrays = {k: _read_member(z, k, path) for k in (*p_keys, *o_keys)}
    if verify:
        _verify_integrity(path, meta, arrays)
        if "mesh" in meta:
            validate_manifest(meta["mesh"], path,
                              n_params=len(p_keys), n_opt=len(o_keys))
    return meta, [arrays[k] for k in p_keys], [arrays[k] for k in o_keys]


def verify_checkpoint(path: str) -> dict:
    """Full integrity pass; returns the meta, raises CheckpointError."""
    meta, _, _ = load_checkpoint(path, verify=True)
    return meta


def list_checkpoints(run_dir: str) -> list[tuple[int, str]]:
    """(step, path) of every rolling checkpoint in ``run_dir``, ascending
    by step. Temp files and the ``checkpoint.npz`` alias are not listed."""
    try:
        names = os.listdir(run_dir)
    except (FileNotFoundError, NotADirectoryError):
        return []
    out = []
    for name in names:
        m = _CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(run_dir, name)))
    out.sort()
    return out


def find_latest_valid(run_dir: str, log=None) -> str | None:
    """Newest checkpoint in ``run_dir`` that passes full verification:
    rolling files newest first, then a plain ``checkpoint.npz`` that is not
    the alias symlink. Corrupt candidates are skipped with a logged
    reason; None when nothing valid exists."""
    if log is None:
        def log(msg):
            print(msg, file=sys.stderr, flush=True)
    candidates = [p for _, p in reversed(list_checkpoints(run_dir))]
    legacy = os.path.join(run_dir, "checkpoint.npz")
    if os.path.lexists(legacy) and not os.path.islink(legacy):
        candidates.append(legacy)
    for path in candidates:
        try:
            verify_checkpoint(path)
            return path
        except CheckpointError as e:
            log(f"auto-resume: skipping {e.path}: {e.reason}")
    return None


def model_config_from_meta(meta: dict, path: str = "<checkpoint>"
                           ) -> ModelConfig:
    """The policy ``ModelConfig`` of a training checkpoint's
    ``meta["config"]``, as the JAX package's
    ``ExperimentConfig.from_dict(...).model_config()`` builds it."""
    config = meta.get("config")
    if not isinstance(config, dict):
        raise CheckpointError(path, "meta has no config object")
    c = {k: config.get(k, v) for k, v in _EXPERIMENT_MODEL_DEFAULTS.items()}
    channels = c["channels"]
    if c["channel_schedule"]:
        channels = tuple(int(w) for w in c["channel_schedule"].split(",")
                         if w.strip())
    try:
        return ModelConfig(
            num_layers=c["num_layers"], channels=channels,
            first_kernel=c["first_kernel"], kernel=c["kernel"],
            final_relu=c["final_relu"], compute_dtype=c["compute_dtype"],
            remat=c["remat"])
    except ValueError as e:
        raise CheckpointError(path, f"config does not build a model: {e}"
                              ) from e


def load_model_like(template, path: str):
    """A fresh module of ``template``'s class and config (a ``PolicyCNN``
    or a ``ValueCNN``) on ``template``'s device, holding the parameters of
    the checkpoint at ``path``. ``template`` itself is never written.
    Raises ``CheckpointError`` for a corrupt file or one whose leaves do
    not fit the config."""
    from ..models import convert
    from ..models.value_cnn import ValueCNN

    to_jax, from_jax = ((convert.value_to_jax, convert.value_from_jax)
                        if isinstance(template, ValueCNN) else
                        (convert.params_to_jax, convert.params_from_jax))
    _, leaves, _ = load_checkpoint(path)
    model = type(template)(template.cfg)
    model.load_state_dict(from_jax(unflatten_like(to_jax(model), leaves,
                                                  path)))
    return model.to(next(template.parameters()).device)


def policy_state_dict(leaves, cfg: ModelConfig, path: str = "<checkpoint>"
                      ) -> dict[str, torch.Tensor]:
    """A ``PolicyCNN`` state dict from the checkpoint's parameter leaves.
    Raises ``CheckpointError`` when their count or shapes disagree with
    ``cfg``."""
    template = {"layers": [
        {"b": np.broadcast_to(np.float32(0), (BOARD_SIZE, BOARD_SIZE, c_out)),
         "w": np.broadcast_to(np.float32(0), (k, k, c_in, c_out))}
        for k, c_in, c_out in cfg.layer_shapes()]}
    return params_from_jax(unflatten_like(template, leaves, path))
