"""Arena gatekeeper: challengers earn the serving fleet, they don't get it.

The port's copy of ``deepgo_tpu/loop/gatekeeper.py``: the challenger plays
as a ``PolicyAgent`` on the direct path on ``device``, the incumbent
through the fleet when one is given.

The expert-iteration failure mode RESULTS.md measured is distribution
collapse: a learner can minimize its loss on its own games while getting
*weaker*. The gate is the loop's only defense — a challenger checkpoint
reaches the serving fleet exclusively by beating the incumbent champion
in a pinned arena match (``match.standard_gate``: the same opening /
seed / pairing discipline every RESULTS.md strength number used) at
``threshold`` (default 55%) or better. On a pass the gatekeeper:

  1. verifies the challenger file end-to-end (format v2 CRC/SHA — a torn
     or corrupt publish is REJECTED before it can touch serving);
  2. atomically publishes it as the champion checkpoint
     (``utils.atomicio`` — a watcher never observes a partial file);
  3. rolls it through the fleet in place (``FleetRouter.reload``: zero
     dropped futures, capacity never below N-1), which
     retargets every selfplay actor's next ply at once.

On a miss it raises a typed ``GateRejected`` carrying the full match
stats — a normal loop outcome the service counts, not a crash. Fault
site ``loop_gate`` fires at evaluation start (docs/robustness.md).
"""

from __future__ import annotations

import time

from .. import match, resolve_device
from ..agents import PolicyAgent
from ..experiments import checkpoint as ckpt
from ..models.serving import load_policy
from ..obs import get_registry
from ..utils import faults
from ..utils.atomicio import atomic_write
from .learner import LoopError


class GateRejected(LoopError):
    """The challenger did not clear the arena gate. Carries ``win_rate``,
    ``threshold``, and the full match ``stats``; the incumbent keeps
    serving and the loop moves on to the next window."""

    def __init__(self, win_rate: float, threshold: float, stats: dict):
        self.win_rate = win_rate
        self.threshold = threshold
        self.stats = stats
        super().__init__(
            f"challenger won {win_rate:.1%} < gate threshold "
            f"{threshold:.1%} ({stats.get('games')} games)")


def publish_checkpoint(src: str, dst: str) -> None:
    """Atomically copy a verified checkpoint into the champion slot.

    Read fully, then ``atomic_write`` — watchers (``cli serve --watch``,
    a peer gatekeeper) only ever see old-complete or new-complete, never
    a torn champion. The source must already be verified by the caller."""
    with open(src, "rb") as f:
        data = f.read()
    with atomic_write(dst) as f:
        f.write(data)


class ArenaGatekeeper:
    """Challenger-vs-incumbent gate over the pinned arena protocol.

    ``fleet`` (optional) is the live FleetRouter serving the champion;
    on a gate pass its weights are hot-reloaded in place. ``engine``
    (optional) routes the *incumbent's* match inference through the
    serving fleet — the gate then measures exactly the policy the users
    are getting, QoS tiers included — while the challenger plays through
    its own direct ladder path (it has no serving presence yet, by
    definition)."""

    def __init__(self, champion_path: str, games: int = 64,
                 threshold: float = 0.55, max_moves: int = 450,
                 komi: float = 7.5, fleet=None, engine=None,
                 metrics=None, clock=time.time, device="cuda"):
        self.champion_path = champion_path
        self.device = resolve_device(device)
        self.games = games
        self.threshold = threshold
        self.max_moves = max_moves
        self.komi = komi
        self.fleet = fleet
        self.engine = engine
        self._metrics = metrics
        self._clock = clock
        self.gates_passed = 0
        self.gates_rejected = 0
        self._champion_since = clock()
        reg = get_registry()
        self._obs_passed = reg.counter(
            "deepgo_loop_gates_passed_total",
            "challengers promoted to champion by the arena gate")
        self._obs_rejected = reg.counter(
            "deepgo_loop_gates_rejected_total",
            "challengers rejected by the arena gate")
        self._obs_age = reg.gauge(
            "deepgo_loop_champion_age_s",
            "seconds since the serving champion last changed")

    def champion_age_s(self) -> float:
        age = self._clock() - self._champion_since
        self._obs_age.set(age)
        return age

    def evaluate(self, challenger_path: str) -> dict:
        """Gate one challenger. Returns the pass record (win_rate, stats,
        reload report); raises GateRejected on a miss and CheckpointError
        on an unverifiable challenger file."""
        faults.check("loop_gate")
        t0 = self._clock()
        # full integrity pass FIRST: a corrupt challenger must fail here,
        # not after a 1,000-game match or mid-reload
        ckpt.verify_checkpoint(challenger_path)
        _, c_params, c_cfg = load_policy(challenger_path,
                                         device=self.device)
        _, i_params, i_cfg = load_policy(self.champion_path,
                                         device=self.device)
        # the challenger's bitwise identity — the key the lineage chain
        # joins on (it equals the learner's lineage_window digest for the
        # window that published this challenger)
        from .learner import params_digest

        challenger_digest = params_digest(c_params)
        challenger = PolicyAgent(c_params, c_cfg, name="challenger",
                                 rank=match.GATE_RANK, device=self.device)
        incumbent = PolicyAgent(i_params, i_cfg, name="champion",
                                rank=match.GATE_RANK, engine=self.engine,
                                device=self.device)
        _, _, stats = match.standard_gate(
            challenger, incumbent, n_games=self.games, komi=self.komi,
            max_moves=self.max_moves)
        win_rate = stats["win_rate_a"]
        if win_rate < self.threshold:
            self.gates_rejected += 1
            self._obs_rejected.inc(1)
            if self._metrics is not None:
                self._metrics.write("loop_gate", outcome="rejected",
                                    win_rate=round(win_rate, 4),
                                    threshold=self.threshold,
                                    games=self.games,
                                    seconds=round(self._clock() - t0, 3))
                self._metrics.write("lineage_gate", outcome="rejected",
                                    digest=challenger_digest,
                                    win_rate=round(win_rate, 4),
                                    games=self.games)
            raise GateRejected(win_rate, self.threshold, stats)
        publish_checkpoint(challenger_path, self.champion_path)
        reload_report = None
        if self.fleet is not None:
            reload_report = self.fleet.reload(self.champion_path)
        self.gates_passed += 1
        self._champion_since = self._clock()
        self._obs_passed.inc(1)
        self._obs_age.set(0.0)
        record = {
            "outcome": "passed",
            "win_rate": round(win_rate, 4),
            "threshold": self.threshold,
            "games": self.games,
            "champion": self.champion_path,
            "champion_step": ckpt.load_meta(self.champion_path).get("step"),
            "reload": reload_report,
            "seconds": round(self._clock() - t0, 3),
        }
        if self._metrics is not None:
            self._metrics.write("loop_gate", **{
                k: v for k, v in record.items() if k != "reload"})
            self._metrics.write("lineage_gate", outcome="passed",
                                digest=challenger_digest,
                                win_rate=round(win_rate, 4),
                                games=self.games)
            # the chain's root: what the fleet serves NOW, and the
            # digest that walks back to its training window
            self._metrics.write("lineage_champion",
                                digest=challenger_digest,
                                step=record["champion_step"],
                                path=self.champion_path,
                                source="gate")
        record["stats"] = stats
        return record
