"""Canary integrity probes: known-answer sentinels against every replica.

The port's copy of ``deepgo_tpu/chaos/canary.py``.

A corrupt replica is the gray failure that latency defenses cannot
see — it answers fast, stays "healthy", and is simply *wrong*. The
``CanaryProber`` closes that gap: it holds a small set of sentinel
positions whose correct outputs were computed before chaos started,
and periodically submits one to EACH replica's engine directly
(``FleetRouter.probe_targets`` — pinned placement, bypassing the
router, because a canary must test the replica it aimed at). A probe
whose answer drifts past tolerance ejects the replica through the
fleet's standard recycle path (``eject_replica(reason="canary")``),
so detection and remediation share one counter and one respawn
machinery with the latency-outlier defense.

Probes ride the ordinary dispatch path inside each replica, so an
injected ``serving_corrupt.<name>`` window corrupts canary answers
exactly as it corrupts user answers — which is the point.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..obs.registry import get_registry


def make_sentinels(positions: list[dict], expected: dict,
                   limit: int = 4) -> list[dict]:
    """Sentinels from trace positions + a digest->known-good-answer
    map: the first ``limit`` distinct digests that have an answer.
    Each sentinel is ``{packed, player, rank, digest, expected}``."""
    out: list[dict] = []
    seen: set[str] = set()
    for item in positions:
        digest = item.get("digest")
        if digest is None or digest in seen or digest not in expected:
            continue
        seen.add(digest)
        out.append({"packed": item["packed"], "player": item["player"],
                    "rank": item["rank"], "digest": digest,
                    "expected": np.asarray(expected[digest])})
        if len(out) >= limit:
            break
    return out


class CanaryProber:
    """Background sentinel prober over a fleet's replicas.

    One daemon thread; every ``interval_s`` it walks the current
    ``probe_targets()`` and submits one sentinel (round-robin over the
    sentinel set, so a replica that only corrupts SOME positions is
    still caught) to each replica, blocking on the answer with a
    bounded timeout. Wrong answer -> eject. Probe *errors* (replica
    mid-respawn, timeout) are not integrity failures — the latency
    and failover defenses own those — so they only tick the probe
    counter, never the failure counter."""

    def __init__(self, fleet, sentinels: list[dict],
                 interval_s: float = 0.25, timeout_s: float = 2.0,
                 rtol: float = 1e-4, atol: float = 1e-5,
                 eject: bool = True, clock=time.monotonic):
        if not sentinels:
            raise ValueError("canary prober needs at least one sentinel")
        self.fleet = fleet
        self.sentinels = list(sentinels)
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.rtol = float(rtol)
        self.atol = float(atol)
        self.eject = eject
        self._clock = clock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._cursor = 0
        self.probes = 0
        self.failures = 0
        self.detected: list[dict] = []
        reg = get_registry()
        self._obs_probes = reg.counter(
            "deepgo_fleet_canary_probes_total",
            "sentinel integrity probes submitted to fleet replicas")
        self._obs_failures = reg.counter(
            "deepgo_fleet_canary_failures_total",
            "canary probes answered wrong (replica ejected)")

    # -- one probe round -----------------------------------------------------

    def probe_once(self) -> int:
        """Probe every current replica once; returns how many probes
        FAILED this round. Public so tests and the campaign's final
        sweep can force a deterministic round."""
        failed = 0
        for idx, engine in self.fleet.probe_targets():
            s = self.sentinels[self._cursor % len(self.sentinels)]
            self._cursor += 1
            self.probes += 1
            self._obs_probes.inc(fleet=self.fleet.name, replica=str(idx))
            try:
                f = engine.submit(s["packed"], s["player"], s["rank"],
                                  timeout_s=self.timeout_s)
                got = np.asarray(f.result(timeout=self.timeout_s))
            except Exception:  # noqa: BLE001 — availability, not integrity
                continue
            if np.allclose(got, s["expected"], rtol=self.rtol,
                           atol=self.atol, equal_nan=True):
                continue
            failed += 1
            self.failures += 1
            self._obs_failures.inc(fleet=self.fleet.name,
                                   replica=str(idx))
            self.detected.append({"replica": idx, "digest": s["digest"],
                                  "t": self._clock()})
            if self.eject:
                try:
                    self.fleet.eject_replica(idx, reason="canary")
                except Exception:  # noqa: BLE001 — already respawning
                    pass
        return failed

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "CanaryProber":
        if self._thread is not None:
            raise RuntimeError("prober already started")
        self._thread = threading.Thread(
            target=self._run, name=f"canary-{self.fleet.name}",
            daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.probe_once()
            except Exception:  # noqa: BLE001 — a closing fleet mid-round
                if self._stop.is_set():
                    return

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def report(self) -> dict:
        return {"probes": self.probes, "failures": self.failures,
                "detected": [{"replica": d["replica"],
                              "digest": d["digest"]}
                             for d in self.detected]}
