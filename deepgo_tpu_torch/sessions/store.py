"""Write-ahead-logged session store: acked == durable, resume == replay.

The port's copy of ``deepgo_tpu/sessions/store.py``: the WAL records and
the checkpoint JSON are the JAX package's format, so a store written by
either package recovers in the other.

The contract mirrors the replay buffer (loop/replay.py): a move is
acknowledged to the client ONLY after its WAL record is fsync'd, so a
SIGKILL at any instant loses nothing that was acked. Recovery is a pure
function of the directory:

  1. checkpoints ``ckpt-<seq>.json`` are whole-file atomic
     (utils/atomicio) with an embedded content digest; recovery walks
     them newest-first and takes the first VALID one (the checkpoint
     ``find_latest_valid`` discipline) — corrupt files are skipped and
     counted, never fatal while an older one or the WAL remains;
  2. WAL segments ``wal-<startseq>.jsonl`` are per-record fsync'd
     appends (append-mode streams are torn-TAIL-tolerant by design:
     only the final line can be incomplete, and it is dropped);
  3. records with ``seq`` beyond the checkpoint replay through the SAME
     ``GoGame`` legality methods that produced them, so the recovered
     state is bit-identical — a record that fails to apply marks that
     session corrupt and FALLS BACK to its last checkpointed snapshot
     (``SessionCorrupt`` surfaces only when no good state exists at
     all).

Checkpointing compacts: after an ``atomic_write`` checkpoint at seq N,
every WAL segment is fully covered by N (segments rotate at checkpoint
boundaries) and is deleted; WAL lag — records accumulated since the
last checkpoint, the recovery-replay cost — rides the
``deepgo_session_wal_lag_records`` gauge.

Transient WAL write faults (site ``session_wal``) are absorbed by the
bounded full-jitter retry exactly like loop ingest; a hard fault
surfaces typed with the record UN-acked and the in-memory state
untouched.
"""

from __future__ import annotations

import hashlib
import json
import os
import time

from ..analysis.lockcheck import make_lock
from ..obs.registry import get_registry
from ..utils import faults
from ..utils.atomicio import atomic_write
from ..utils.retry import retry_with_backoff
from .game import GoGame, IllegalMove, SessionError


class SessionNotFound(SessionError):
    """No live session under this id (never opened, or closed)."""

    def __init__(self, session_id: str):
        super().__init__(f"no live session {session_id!r}")
        self.session_id = session_id


class SessionCorrupt(SessionError):
    """A session whose durable state is damaged beyond every fallback:
    its WAL tail failed to apply AND no checkpoint holds it."""

    def __init__(self, session_id: str, reason: str):
        super().__init__(
            f"session {session_id!r} is corrupt: {reason}")
        self.session_id = session_id
        self.reason = reason


class _WalSegment:
    """One fsync'd append-only JSONL stream. ``write`` returns only
    after the bytes are durable — this is the ack barrier."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "ab")

    def write(self, kind: str, **fields) -> None:
        line = json.dumps({"kind": kind, **fields},
                          separators=(",", ":")) + "\n"
        self._f.write(line.encode("utf-8"))
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def _seq_of(name: str, prefix: str, suffix: str) -> int | None:
    if not (name.startswith(prefix) and name.endswith(suffix)):
        return None
    try:
        return int(name[len(prefix):-len(suffix)])
    except ValueError:
        return None


class SessionStore:
    """Durable home of every live game in one directory."""

    def __init__(self, root: str, checkpoint_every: int = 64,
                 keep_checkpoints: int = 3):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.checkpoint_every = int(checkpoint_every)
        self.keep_checkpoints = int(keep_checkpoints)
        self._lock = make_lock("sessions.store")
        self.games: dict[str, GoGame] = {}
        self.corrupt: dict[str, str] = {}      # irrecoverable, by reason
        self.restored_from_checkpoint: list[str] = []
        self.seq = 0
        self.ckpt_seq = 0
        self.wal_retries = 0
        self.closed_sessions = 0
        self._segment: _WalSegment | None = None
        reg = get_registry()
        self._obs_open = reg.gauge(
            "deepgo_session_open_sessions",
            "live interactive game sessions in the store")
        self._obs_lag = reg.gauge(
            "deepgo_session_wal_lag_records",
            "WAL records accumulated since the last compacted "
            "checkpoint (the recovery-replay cost)")
        self._obs_resumes = reg.counter(
            "deepgo_session_resumes_total",
            "live sessions reconstructed from checkpoint + WAL replay "
            "at store startup")
        self.recovery = self._recover()
        self._obs_open.set(len(self.games))
        self._obs_lag.set(self.seq - self.ckpt_seq)

    # -- recovery ----------------------------------------------------------

    def _ckpt_paths(self) -> list[tuple[int, str]]:
        out = []
        for name in os.listdir(self.root):
            seq = _seq_of(name, "ckpt-", ".json")
            if seq is not None:
                out.append((seq, os.path.join(self.root, name)))
        return sorted(out, reverse=True)

    def _wal_paths(self) -> list[tuple[int, str]]:
        out = []
        for name in os.listdir(self.root):
            seq = _seq_of(name, "wal-", ".jsonl")
            if seq is not None:
                out.append((seq, os.path.join(self.root, name)))
        return sorted(out)

    @staticmethod
    def _read_checkpoint(path: str) -> dict:
        with open(path, encoding="utf-8") as f:
            wrapped = json.load(f)
        payload = wrapped["payload"]
        body = json.dumps(payload, sort_keys=True, separators=(",", ":"))
        digest = hashlib.sha256(body.encode()).hexdigest()
        if digest != wrapped.get("digest"):
            raise ValueError(f"checkpoint {path} digest mismatch")
        return payload

    def _recover(self) -> dict:
        report = {"checkpoint_seq": 0, "checkpoints_skipped": 0,
                  "wal_records_applied": 0, "torn_tail": False,
                  "restored_from_checkpoint": [], "corrupt": [],
                  "sessions": 0}
        base_snapshots: dict[str, dict] = {}
        for seq, path in self._ckpt_paths():
            try:
                payload = self._read_checkpoint(path)
            except (OSError, ValueError, KeyError, TypeError):
                report["checkpoints_skipped"] += 1
                continue
            base_snapshots = dict(payload.get("sessions", {}))
            self.ckpt_seq = self.seq = int(payload.get("seq", seq))
            report["checkpoint_seq"] = self.ckpt_seq
            break
        for sid, snap in base_snapshots.items():
            try:
                self.games[sid] = GoGame.from_snapshot(snap)
            except (ValueError, KeyError, TypeError) as e:
                self.corrupt[sid] = f"checkpoint snapshot unusable: {e}"
        frozen: set[str] = set()

        def freeze(sid: str, reason: str) -> None:
            """WAL tail for ``sid`` failed to apply: fall back to the
            checkpointed snapshot (find_latest_valid style) or, with no
            checkpoint to fall back to, mark the session corrupt."""
            frozen.add(sid)
            snap = base_snapshots.get(sid)
            if snap is not None:
                try:
                    self.games[sid] = GoGame.from_snapshot(snap)
                    self.restored_from_checkpoint.append(sid)
                    return
                except (ValueError, KeyError, TypeError):
                    pass
            self.games.pop(sid, None)
            self.corrupt[sid] = reason

        wal_paths = self._wal_paths()
        for i, (_, path) in enumerate(wal_paths):
            last_file = i == len(wal_paths) - 1
            try:
                with open(path, "rb") as f:
                    lines = f.read().split(b"\n")
            except OSError:
                continue
            for j, raw in enumerate(lines):
                if not raw.strip():
                    continue
                try:
                    rec = json.loads(raw.decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    # torn tail of the newest segment is the expected
                    # crash artifact; a bad line anywhere else means the
                    # rest of this segment cannot be trusted either
                    if last_file and j == len(lines) - 1:
                        report["torn_tail"] = True
                    break
                seq = int(rec.get("seq", 0))
                if seq <= self.seq:
                    continue  # retried duplicate or pre-checkpoint
                self.seq = seq
                sid = str(rec.get("session"))
                if sid in frozen or sid in self.corrupt:
                    continue
                self._apply(rec, sid, freeze)
                report["wal_records_applied"] += 1
        report["restored_from_checkpoint"] = \
            list(self.restored_from_checkpoint)
        report["corrupt"] = sorted(self.corrupt)
        report["sessions"] = len(self.games)
        if self.games:
            self._obs_resumes.inc(len(self.games))
        return report

    def _apply(self, rec: dict, sid: str, freeze) -> None:
        kind = rec.get("kind")
        if kind == "session_open":
            self.games[sid] = GoGame(
                sid, tuple(tuple(h) for h in rec.get("handicaps", ())))
            return
        if kind == "session_close":
            self.games.pop(sid, None)
            self.closed_sessions += 1
            return
        if kind != "session_move":
            return  # unknown kinds are forward-compatible no-ops
        game = self.games.get(sid)
        if game is None:
            freeze(sid, f"move record at seq {rec['seq']} for a session "
                        "never opened")
            return
        try:
            if rec.get("pass"):
                game.play_pass(int(rec["player"]),
                               float(rec.get("elapsed_s", 0.0)))
            else:
                game.play_move(int(rec["x"]), int(rec["y"]),
                               int(rec["player"]),
                               float(rec.get("elapsed_s", 0.0)))
        except (IllegalMove, KeyError, ValueError, TypeError) as e:
            freeze(sid, f"WAL replay failed at seq {rec['seq']}: {e}")

    # -- the durable append (the ack barrier) ------------------------------

    def _wal(self) -> _WalSegment:
        if self._segment is None:
            path = os.path.join(self.root, f"wal-{self.seq + 1:012d}.jsonl")
            self._segment = _WalSegment(path)
        return self._segment

    def _count_retry(self, exc, attempt, delay) -> None:
        self.wal_retries += 1

    def _durable(self, emit) -> None:
        """Run ``emit(segment)`` with the ``session_wal`` fault site
        armed and the loop-ingest retry policy: transients absorbed,
        hard faults surface with nothing acked."""

        def write() -> None:
            faults.check("session_wal")
            emit(self._wal())

        retry_with_backoff(write, attempts=5, base_delay=0.01,
                           jitter=True, on_retry=self._count_retry)

    # -- session lifecycle -------------------------------------------------

    def get(self, session_id: str) -> GoGame:
        with self._lock:
            reason = self.corrupt.get(session_id)
            if reason is not None:
                raise SessionCorrupt(session_id, reason)
            game = self.games.get(session_id)
        if game is None:
            raise SessionNotFound(session_id)
        return game

    def open_session(self, session_id: str,
                     handicaps: tuple = ()) -> GoGame:
        with self._lock:
            if session_id in self.games or session_id in self.corrupt:
                raise SessionError(
                    f"session {session_id!r} already exists")
            seq = self.seq + 1
            hs = [list(map(int, h)) for h in handicaps]
            self._durable(lambda seg: seg.write(
                "session_open", seq=seq, session=session_id, t=time.time(),
                handicaps=hs))
            self.seq = seq
            game = GoGame(session_id, tuple(tuple(h) for h in handicaps))
            self.games[session_id] = game
            self._obs_open.set(len(self.games))
            self._after_append()
        return game

    def append_move(self, session_id: str, player: int,
                    x: int | None = None, y: int | None = None,
                    is_pass: bool = False,
                    elapsed_s: float = 0.0) -> int:
        """Validate -> WAL (fsync) -> apply -> return the acked seq.
        The record is durable BEFORE the in-memory board mutates, so a
        crash between the two replays the move instead of losing it."""
        with self._lock:
            reason = self.corrupt.get(session_id)
            if reason is not None:
                raise SessionCorrupt(session_id, reason)
            game = self.games.get(session_id)
            if game is None:
                raise SessionNotFound(session_id)
            if not is_pass:
                refusal = game.check_move(int(x), int(y), int(player))
                if refusal is not None:
                    raise IllegalMove(session_id, refusal)
            elif game.over or int(player) != game.to_play:
                raise IllegalMove(
                    session_id, "game is over" if game.over
                    else f"out of turn pass by player {player}")
            seq = self.seq + 1
            if is_pass:
                self._durable(lambda seg: seg.write(
                    "session_move", seq=seq, session=session_id,
                    player=int(player), elapsed_s=float(elapsed_s),
                    t=time.time(), **{"pass": True}))
            else:
                self._durable(lambda seg: seg.write(
                    "session_move", seq=seq, session=session_id,
                    player=int(player), x=int(x), y=int(y),
                    elapsed_s=float(elapsed_s), t=time.time()))
            self.seq = seq
            if is_pass:
                game.play_pass(int(player), float(elapsed_s))
            else:
                game.play_move(int(x), int(y), int(player),
                               float(elapsed_s))
            self._after_append()
        return seq

    def close_session(self, session_id: str) -> int:
        with self._lock:
            if session_id not in self.games:
                raise SessionNotFound(session_id)
            seq = self.seq + 1
            self._durable(lambda seg: seg.write(
                "session_close", seq=seq, session=session_id,
                t=time.time()))
            self.seq = seq
            self.games.pop(session_id)
            self.closed_sessions += 1
            self._obs_open.set(len(self.games))
            self._after_append()
        return seq

    def _after_append(self) -> None:
        lag = self.seq - self.ckpt_seq
        self._obs_lag.set(lag)
        if lag >= self.checkpoint_every:
            self._checkpoint_locked()

    # -- compaction --------------------------------------------------------

    def checkpoint(self) -> str:
        with self._lock:
            return self._checkpoint_locked()

    def _checkpoint_locked(self) -> str:
        payload = {
            "seq": self.seq,
            "sessions": {sid: g.snapshot()
                         for sid, g in sorted(self.games.items())},
        }
        body = json.dumps(payload, sort_keys=True, separators=(",", ":"))
        digest = hashlib.sha256(body.encode()).hexdigest()
        path = os.path.join(self.root, f"ckpt-{self.seq:012d}.json")
        with atomic_write(path, "w") as f:
            json.dump({"digest": digest, "payload": payload}, f)
        self.ckpt_seq = self.seq
        self._obs_lag.set(0)
        # compaction: every WAL record is now covered by this checkpoint
        # (segments rotate here), so the segments can go
        if self._segment is not None:
            self._segment.close()
            self._segment = None
        for _, wal_path in self._wal_paths():
            try:
                os.unlink(wal_path)
            except OSError:
                pass
        for seq, ckpt_path in self._ckpt_paths()[self.keep_checkpoints:]:
            try:
                os.unlink(ckpt_path)
            except OSError:
                pass
        return path

    # -- lifecycle ---------------------------------------------------------

    def wal_lag(self) -> int:
        with self._lock:
            return self.seq - self.ckpt_seq

    def stats(self) -> dict:
        with self._lock:
            return {
                "open_sessions": len(self.games),
                "seq": self.seq,
                "checkpoint_seq": self.ckpt_seq,
                "wal_lag_records": self.seq - self.ckpt_seq,
                "wal_retries": self.wal_retries,
                "closed_sessions": self.closed_sessions,
                "corrupt_sessions": sorted(self.corrupt),
                "restored_from_checkpoint":
                    list(self.restored_from_checkpoint),
            }

    def close(self, final_checkpoint: bool = True) -> None:
        with self._lock:
            if final_checkpoint and self.seq > self.ckpt_seq:
                self._checkpoint_locked()
            if self._segment is not None:
                self._segment.close()
                self._segment = None
