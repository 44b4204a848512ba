"""Durable game sessions: crash-resumable interactive play plus bulk
SGF analysis, both riding the serving fleet's QoS tiers.

The port of ``deepgo_tpu/sessions``: copies of the jax-free modules over
the port's fleet and rules, and the crash-resume child on the port's net.

The package turns the serving stack into a product surface:

  * ``game``      — full-legality per-session Go state (positional
                    superko, suicide refusal, pass-pass end) over the
                    ``go/`` capture primitives, with a canonical
                    ``digest()`` for bit-identical-resume grading;
  * ``store``     — write-ahead-logged session store: per-move fsync'd
                    ack barrier, compacted atomic checkpoints,
                    find_latest_valid recovery with per-session
                    checkpoint fallback;
  * ``service``   — interactive engine replies on the INTERACTIVE tier
                    with deadline-tiered budgets and typed errors;
  * ``analysis``  — resumable batch-tier corpus scans producing policy
                    annotations and blunder flags;
  * ``child``     — the scripted crash-resume client that a parent
                    SIGKILLs and resumes.
"""

from .analysis import AnalysisCursorError, SgfAnalysisService
from .game import GoGame, IllegalMove, SessionError
from .service import DEFAULT_BUDGETS_S, GameService, ReplyExhausted
from .store import SessionCorrupt, SessionNotFound, SessionStore

__all__ = [
    "AnalysisCursorError",
    "DEFAULT_BUDGETS_S",
    "GameService",
    "GoGame",
    "IllegalMove",
    "ReplyExhausted",
    "SessionCorrupt",
    "SessionError",
    "SessionNotFound",
    "SessionStore",
    "SgfAnalysisService",
]
