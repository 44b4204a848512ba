"""Bulk SGF analysis: a corpus streamed through the fleet's batch tier.

The port's copy of ``deepgo_tpu/sessions/analysis.py``, over the port's
fleet.

The scan produces one policy annotation per recorded move — log-prob
and rank of the move actually played under the serving policy, plus a
blunder flag when the played move is both low-rank and low-probability
— and is built to coexist with interactive traffic rather than win
against it: every position rides the BATCH tier (headroom 0.3, the
first to shed), door-sheds are absorbed with one bounded-jitter retry
and then recorded as ``shed`` (the scan keeps walking; a surge replica
may pick the load up instead), and progress is a durable per-file
cursor (``cursor.json`` via utils/atomicio) so a killed scan resumes
at the file+move it had finished, never re-annotating and never
skipping.

Positions come from ``go/replay.replay_positions`` — the same pre-move
boards the training pipeline sees — and requests carry a
``session="scan:<file>"`` workload label so captures distinguish
scan-shaped from session-shaped traffic. Annotations stream to
``annotations.jsonl`` (``session_annotation`` records, one
``session_scan`` summary per file).
"""

from __future__ import annotations

import os
import random
import time

import numpy as np

from ..obs.exporter import JsonlSink
from ..obs.registry import get_registry
from ..serving.resilience import full_jitter_delay
from ..utils.atomicio import atomic_write
from .game import SessionError

_SHED = ("EngineOverloaded", "CircuitOpen", "EngineBusy",
         "FleetUnavailable")


class AnalysisCursorError(SessionError):
    """The cursor file exists but is not a cursor."""


class SgfAnalysisService:
    """Resumable corpus scan on the batch tier."""

    def __init__(self, fleet, out_dir: str, tier: str = "batch",
                 timeout_s: float = 0.5, attempts: int = 2,
                 collect_timeout_s: float = 30.0,
                 blunder_top: int = 10, blunder_logp: float = -4.0,
                 sleep=time.sleep, rng: random.Random | None = None,
                 search_sims: int = 0, search_config=None):
        self.fleet = fleet
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.tier = tier
        self.timeout_s = float(timeout_s)
        self.attempts = max(1, int(attempts))
        self.collect_timeout_s = float(collect_timeout_s)
        self.blunder_top = int(blunder_top)
        self.blunder_logp = float(blunder_logp)
        self._sleep = sleep
        self._rng = rng or random.Random(0)
        # search_sims > 0 adds a second-opinion PUCT search on every
        # blunder-flagged move: the annotation gains the search's
        # preferred point and visit count, still on the batch tier so
        # deep verdicts coexist with interactive traffic the same way
        # the plain scan does
        self._searcher = None
        if search_sims > 0 or search_config is not None:
            from ..search import Search, SearchConfig

            cfg = search_config or SearchConfig(
                simulations=search_sims, tier=tier,
                eval_timeout_s=collect_timeout_s)
            self._searcher = Search(fleet, cfg)
        self.cursor_path = os.path.join(out_dir, "cursor.json")
        self.sink = JsonlSink(os.path.join(out_dir, "annotations.jsonl"),
                              buffering=1 << 16)
        self._obs_positions = get_registry().counter(
            "deepgo_session_analysis_positions_total",
            "bulk-scan positions submitted on the batch tier, by "
            "outcome (annotated / shed / timeout / failed)")

    # -- the durable cursor ------------------------------------------------

    def _load_cursor(self) -> dict:
        import json

        try:
            with open(self.cursor_path, encoding="utf-8") as f:
                cur = json.load(f)
        except OSError:
            return {"files": {}}
        except ValueError as e:
            raise AnalysisCursorError(
                f"unreadable cursor {self.cursor_path!r}: {e}") from e
        if not isinstance(cur, dict) or "files" not in cur:
            raise AnalysisCursorError(
                f"{self.cursor_path!r} is not an analysis cursor")
        return cur

    def _save_cursor(self, cursor: dict) -> None:
        import json

        with atomic_write(self.cursor_path, "w") as f:
            json.dump(cursor, f)

    # -- submission --------------------------------------------------------

    def _submit(self, packed, player: int, rank: int, session: str):
        """(future, outcome) — a None future with outcome 'shed' when
        the door refused through every bounded-backoff attempt."""
        last_outcome = "shed"
        for attempt in range(1, self.attempts + 1):
            try:
                return self.fleet.submit(
                    packed, player, rank, tier=self.tier,
                    timeout_s=self.timeout_s, session=session), "ok"
            except Exception as e:  # noqa: BLE001 — classified below
                if type(e).__name__ not in _SHED:
                    raise
                last_outcome = "shed"
            if attempt < self.attempts:
                self._sleep(full_jitter_delay(attempt, 0.01, 0.1,
                                              self._rng))
        return None, last_outcome

    def _search_verdict(self, packed, player: int) -> dict:
        """Search fields for a blunder annotation, or a marker when the
        search itself was shed — the scan never stalls on a verdict."""
        from ..search import game_from_packed

        try:
            res = self._searcher.search(game_from_packed(packed, player))
        except Exception:  # noqa: BLE001 — verdicts are best-effort
            return {"search_move": None}
        if res.move < 0:
            return {"search_move": None,
                    "search_value": round(float(res.value), 4)}
        sx, sy = divmod(int(res.move), 19)
        return {"search_move": [sx, sy],
                "search_value": round(float(res.value), 4),
                "search_simulations": res.simulations}

    # -- the scan ----------------------------------------------------------

    def run(self, sgf_dir: str, limit_files: int | None = None,
            limit_positions: int | None = None) -> dict:
        """Scan ``sgf_dir`` (sorted walk, resumable). Returns the
        report; annotations and per-file summaries are on disk."""
        from ..go.replay import replay_positions
        from ..sgf import parse_file

        cursor = self._load_cursor()
        files = cursor["files"]
        paths: list[str] = []
        for dirpath, dirnames, filenames in os.walk(sgf_dir):
            dirnames.sort()
            paths.extend(os.path.join(dirpath, n)
                         for n in sorted(filenames) if n.endswith(".sgf"))
        report = {"files_seen": len(paths), "files_done": 0,
                  "files_resumed_past": 0, "positions": 0,
                  "annotated": 0, "blunders": 0, "outcomes": {},
                  "stopped_early": False}

        def count(outcome: str) -> None:
            report["outcomes"][outcome] = \
                report["outcomes"].get(outcome, 0) + 1
            self._obs_positions.inc(outcome=outcome)

        scanned_files = 0
        for path in paths:
            rel = os.path.relpath(path, sgf_dir)
            entry = files.get(rel, {"moves": 0, "done": False})
            if entry.get("done"):
                report["files_resumed_past"] += 1
                continue
            if limit_files is not None and scanned_files >= limit_files:
                report["stopped_early"] = True
                break
            scanned_files += 1
            try:
                game = parse_file(path)
            except (OSError, ValueError):
                files[rel] = {"moves": 0, "done": True, "error": "parse"}
                continue
            positions = list(replay_positions(game))
            start = int(entry.get("moves", 0))
            pending = []
            session = f"scan:{rel}"
            budget_hit = False
            for i in range(start, len(positions)):
                if (limit_positions is not None
                        and report["positions"] >= limit_positions):
                    budget_hit = True
                    break
                packed, move = positions[i]
                report["positions"] += 1
                rank = (game.ranks or (5, 5))[move.player - 1]
                fut, outcome = self._submit(packed, int(move.player),
                                            int(rank), session)
                pending.append((i, move, fut, outcome))
            annotated = shed = blunders = 0
            last_move = start - 1
            for i, move, fut, outcome in pending:
                row = None
                if fut is None:
                    pass
                else:
                    try:
                        row = np.asarray(
                            fut.result(timeout=self.collect_timeout_s),
                            dtype=np.float64).reshape(-1)
                        outcome = "ok"
                    except TimeoutError:
                        outcome = "timeout"
                    except Exception as e:  # noqa: BLE001 — an outcome
                        outcome = ("shed" if type(e).__name__ in _SHED
                                   else "failed")
                last_move = i
                if row is None:
                    count(outcome)
                    shed += outcome == "shed"
                    continue
                idx = int(move.x) * 19 + int(move.y)
                logp = float(row[idx])
                move_rank = int((row > logp).sum()) + 1
                blunder = (move_rank > self.blunder_top
                           and logp < self.blunder_logp)
                record = dict(
                    file=rel, move=i, player=int(move.player),
                    x=int(move.x), y=int(move.y), logp=round(logp, 6),
                    rank=move_rank, blunder=blunder)
                if blunder and self._searcher is not None:
                    record.update(self._search_verdict(positions[i][0],
                                                       int(move.player)))
                self.sink.write("session_annotation", **record)
                count("annotated")
                annotated += 1
                blunders += blunder
            done = not budget_hit
            files[rel] = {"moves": last_move + 1, "done": done}
            self.sink.write("session_scan", file=rel,
                            moves=last_move + 1 - start,
                            annotated=annotated, shed=shed,
                            blunders=blunders, done=done)
            report["annotated"] += annotated
            report["blunders"] += blunders
            report["files_done"] += done
            self._save_cursor(cursor)
            if budget_hit:
                report["stopped_early"] = True
                break
        self.sink.flush()
        return report

    def close(self) -> None:
        self.sink.close()
