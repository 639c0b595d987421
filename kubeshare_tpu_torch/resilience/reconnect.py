"""Reconnect budget and backoff, copied from
``kubeshare_tpu/resilience/reconnect.py`` (lines 57-92).

The pod manager re-dials its token scheduler with these. The resumable
connection and its replay cache (the rest of that module, and the
policy's ``request_timeout_s`` and ``seed`` that only they read) are not
ported yet.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from ..isolation import protocol


class SessionLost(protocol.ProtocolError):
    """The reconnect budget is exhausted (or the peer refused the resume
    token): the session's server-side state must be presumed gone."""


@dataclass(frozen=True)
class ReconnectPolicy:
    """Backoff/budget knobs of a re-dial loop."""

    #: dial attempts before giving up with SessionLost
    max_attempts: int = 8
    #: first retry delay; doubles per attempt (the first attempt is
    #: immediate — the common case is a peer that is already back)
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    #: fraction of the delay randomized (0.5 -> delay * [1.0, 1.5)) so a
    #: herd of clients does not re-dial a restarted peer in lockstep
    jitter: float = 0.5
    dial_timeout_s: float = 2.0


def backoff_delays(policy: ReconnectPolicy, rng: random.Random):
    """Yield the sleep before each attempt: 0 first, then exponential
    with multiplicative jitter, capped at ``max_delay_s``."""
    yield 0.0
    delay = policy.base_delay_s
    while True:
        yield delay * (1.0 + policy.jitter * rng.random())
        delay = min(delay * 2.0, policy.max_delay_s)
