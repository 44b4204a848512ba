"""Content digests and dihedral-symmetry tables for packed positions.

The port's copy of ``deepgo_tpu/utils/digest.py``, kept as its own so the
port imports nothing of the JAX package; ``tests/test_torch_variants.py``
holds the two equal. In the port, ``ops/augment.py`` takes its gather
tables from here, and through it the fused symmetric expansion (plain and
CUDA) and the dihedral ensembles (``models/quant.py``,
``models/serving.py``). The digests serve the position cache and workload
capture of later slices.

Numpy + hashlib only.

Geometry and conventions (fixed by ``ops/augment._dihedral_tables``):

  * ``PERMS[k]`` is a gather table — ``view_flat[:, p] = flat[:, PERMS[k, p]]``
    produces dihedral view ``k`` of a flattened ``(C, 361)`` record.
  * ``INV_PERMS[k]`` is its inverse — a stone (or per-point model output)
    at old position ``p`` lands at new index ``INV_PERMS[k, p]``; augment
    calls the same table ``TARGET_MAP``.
  * For a symmetry-equivariant forward ``f`` over per-point outputs,
    ``f(view_k(x)) == f(x)[PERMS[k]]``, hence
    ``f(x) == f(view_k(x))[INV_PERMS[k]]`` — the remap the cache applies
    on a canonical hit (``remap_from_canonical``).
"""

from __future__ import annotations

import hashlib

import numpy as np

BOARD_SIZE = 19
NUM_POINTS = BOARD_SIZE * BOARD_SIZE

# packed-record geometry (features.py), kept as plain ints so digest math
# stays explicit and jax-free
PACKED_SHAPE = (9, BOARD_SIZE, BOARD_SIZE)

NUM_SYMMETRIES = 8

DIGEST_HEX = 16  # 64-bit keys: ample for any real capture corpus


def dihedral_perms() -> np.ndarray:
    """(8, 361) int32 gather table: ``view_flat[:, p] = flat[:, PERM[k, p]]``.

    Variant k = (r, f) with r quarter-turn rotations (0..3) and f
    horizontal flip (0..1), applied to the (x, y) grid as numpy
    rot90/fliplr — byte-for-byte the construction in
    ``ops/augment._dihedral_tables``.
    """
    base = np.arange(NUM_POINTS).reshape(BOARD_SIZE, BOARD_SIZE)
    perms = []
    for flip in (False, True):
        for rot in range(4):
            grid = np.rot90(base, rot)
            if flip:
                grid = np.fliplr(grid)
            perms.append(grid.reshape(-1))
    out = np.stack(perms).astype(np.int32)
    out.setflags(write=False)
    return out


def inverse_dihedral_perms() -> np.ndarray:
    """(8, 361) int32 inverse tables (augment's ``TARGET_MAP``):
    ``INV[k, PERMS[k, p]] == p`` — where an old position lands under
    view k, and the gather that maps a canonical-view per-point output
    row back to the requested view."""
    perms = dihedral_perms()
    out = np.empty_like(perms)
    for k in range(NUM_SYMMETRIES):
        inv = np.empty(NUM_POINTS, dtype=np.int64)
        inv[perms[k]] = np.arange(NUM_POINTS)
        out[k] = inv
    out.setflags(write=False)
    return out


PERMS = dihedral_perms()
INV_PERMS = inverse_dihedral_perms()


def digest_bytes(payload: bytes, player: int, rank: int) -> str:
    # sha256 (truncated to 64 bits) over blake2b: measurably faster on
    # this container's OpenSSL for the 3.2KB packed record, and the
    # recorder hashes every request on its writer thread
    h = hashlib.sha256(payload)
    h.update(bytes((int(player) & 0xFF, int(rank) & 0xFF)))
    return h.hexdigest()[:DIGEST_HEX]


def _as_packed(packed: np.ndarray) -> np.ndarray:
    arr = np.ascontiguousarray(np.asarray(packed, dtype=np.uint8))
    if arr.shape != PACKED_SHAPE:
        raise ValueError(
            f"packed record shape {arr.shape} != {PACKED_SHAPE}")
    return arr


def exact_digest(packed: np.ndarray, player: int, rank: int) -> str:
    """Content digest of one forward input: the packed planes plus the
    (player, rank) scalars the forward also consumes — two requests
    share a digest iff their dispatch rows are identical."""
    return digest_bytes(_as_packed(packed).tobytes(), player, rank)


def canonical_digest(packed: np.ndarray, player: int, rank: int) -> str:
    """The 8-fold-symmetry canonical key: the lexicographic MINIMUM of
    the exact digests of all eight dihedral views. Go is equivariant
    under the board symmetries and every packed channel is a spatial
    map, so all eight views cost one forward in a symmetry-aware cache;
    the min over a group orbit is view-invariant — every view of a
    position lands on the same key (the canonicalization tests pin
    this orbit property and that distinct positions never collide)."""
    flat = _as_packed(packed).reshape(PACKED_SHAPE[0], NUM_POINTS)
    return min(digest_bytes(np.ascontiguousarray(flat[:, PERMS[k]])
                            .tobytes(), player, rank)
               for k in range(NUM_SYMMETRIES))


def canonicalize(packed: np.ndarray, player: int, rank: int
                 ) -> tuple[str, np.ndarray, int]:
    """(canonical_digest, canonical_view, k): the orbit-minimum digest,
    the packed view that produced it, and its symmetry index.

    Every dihedral view of one position returns the same digest AND the
    same canonical-view bytes (the orbit is view-set-invariant), so a
    cache keyed on the digest can dispatch the canonical view and later
    serve any view via ``remap_from_canonical(row, k)``.
    """
    flat = _as_packed(packed).reshape(PACKED_SHAPE[0], NUM_POINTS)
    best_digest, best_view, best_k = None, None, 0
    for k in range(NUM_SYMMETRIES):
        view = np.ascontiguousarray(flat[:, PERMS[k]])
        d = digest_bytes(view.tobytes(), player, rank)
        if best_digest is None or d < best_digest:
            best_digest, best_view, best_k = d, view, k
    return best_digest, best_view.reshape(PACKED_SHAPE), best_k


def remap_from_canonical(row: np.ndarray, k: int) -> np.ndarray:
    """Map a per-point output row computed on the CANONICAL view back to
    the view that canonicalized with symmetry index ``k``.

    With ``c = view_k(x)`` and an equivariant forward ``f``,
    ``f(x) == f(c)[INV_PERMS[k]]`` — a pure gather, so parity with an
    uncached forward of ``x`` is bitwise (``tests/test_cache.py``
    property-tests this against the ``ops/augment`` tables for all
    eight views).
    """
    arr = np.asarray(row)
    if arr.shape[-1] != NUM_POINTS:
        raise ValueError(
            f"per-point output row has last dim {arr.shape[-1]}, "
            f"expected {NUM_POINTS}; canonical-key remap only applies "
            "to per-point (361-way) outputs")
    if k == 0:
        return arr
    return np.ascontiguousarray(arr[..., INV_PERMS[k]])


def dihedral_views(packed: np.ndarray) -> list[np.ndarray]:
    """All eight dihedral views of one packed record (tests + tools)."""
    arr = np.ascontiguousarray(np.asarray(packed, dtype=np.uint8))
    flat = arr.reshape(PACKED_SHAPE[0], NUM_POINTS)
    return [np.ascontiguousarray(flat[:, PERMS[k]]).reshape(PACKED_SHAPE)
            for k in range(NUM_SYMMETRIES)]
