"""Read side of the JAX package's checkpoint format (v1 and v2 ``.npz``).

The port's own copy of the reader in ``deepgo_tpu/experiments/checkpoint.py``:
a ``.npz`` of flat leaves (``params_0000``, ..., ``opt_0000``, ...) plus a
JSON ``meta`` member. Format v2's meta carries an ``integrity`` block — a
CRC32 per stored array and a SHA-256 digest over all array payloads — that
``load_checkpoint(verify=True)`` checks, and may carry a ``mesh`` manifest
that is validated structurally. Every failure raises ``CheckpointError``.

Leaves are stored in ``jax.tree.leaves`` order, which sorts dict keys: for
the policy tree ``{"layers": [{"b", "w"}, ...]}`` that is, per layer in
order, the bias ``(19, 19, c_out)`` then the weight ``(k, k, c_in, c_out)``.
``policy_state_dict`` rebuilds a ``PolicyCNN`` state dict from them.

The write side comes with the training port.
"""

from __future__ import annotations

import hashlib
import json
import os
import zipfile
import zlib

import numpy as np
import torch

from .. import BOARD_SIZE
from ..models.convert import params_from_jax
from ..models.policy_cnn import ModelConfig

SUPPORTED_VERSIONS = (1, 2)

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


def _leaf_bytes(arr: np.ndarray) -> bytes:
    return np.ascontiguousarray(arr).tobytes()


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
    digest = hashlib.sha256()
    for key in sorted(arrays):
        data = _leaf_bytes(arrays[key])
        if zlib.crc32(data) != expected[key]:
            raise CheckpointError(
                path, f"CRC32 mismatch for array {key!r} — bit corruption")
        digest.update(key.encode())
        digest.update(str(arrays[key].dtype).encode())
        digest.update(repr(tuple(arrays[key].shape)).encode())
        digest.update(data)
    if digest.hexdigest() != integ.get("digest"):
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


def policy_state_dict(leaves, cfg: ModelConfig, path: str = "<checkpoint>"
                      ) -> dict[str, torch.Tensor]:
    """A ``PolicyCNN`` state dict from the checkpoint's parameter leaves.
    Raises ``CheckpointError`` when their count or shapes disagree with
    ``cfg``, as the JAX package's ``unflatten_like`` does."""
    shapes = cfg.layer_shapes()
    if len(leaves) != 2 * len(shapes):
        raise CheckpointError(
            path, f"has {len(leaves)} leaves, the model needs "
                  f"{2 * len(shapes)} — checkpoint config and model "
                  f"architecture disagree")
    layers = []
    for i, (k, c_in, c_out) in enumerate(shapes):
        b, w = leaves[2 * i], leaves[2 * i + 1]
        for j, (leaf, want) in enumerate(
                ((b, (BOARD_SIZE, BOARD_SIZE, c_out)), (w, (k, k, c_in, c_out)))):
            if tuple(leaf.shape) != want:
                raise CheckpointError(
                    path, f"leaf {2 * i + j}: checkpoint shape "
                          f"{tuple(leaf.shape)} != model {want} — checkpoint "
                          f"config and model architecture disagree")
        layers.append({"b": b, "w": w})
    return params_from_jax({"layers": layers})
