"""Admission control for the tile-serving engine.

Interactive tile traffic is bursty (a map pan fans one viewport move into
dozens of tile requests); the paper's batch drivers simply queue unbounded
work, which a serving front end cannot — queueing delay IS the latency.  The
controller bounds the number of requests admitted-but-not-completed:

  * ``shed`` policy (default): a request arriving at ``max_depth`` in-flight
    is rejected immediately with :class:`Shed` — the client re-requests the
    tile on its next pan frame, which beats queueing behind a storm;
  * ``block`` policy: the caller waits (bounded by ``max_wait_s``) for depth
    to drop, then sheds — the backpressure mode for trusted bulk clients.

The controller is a pure gatekeeper: it never touches the request payload,
so it sits in front of any engine.  Counters come out of
:meth:`AdmissionController.snapshot` as a plain dict, mirroring
``PlanCache.stats_snapshot``.

Counterpart of ``repro.serve.admission``, copied: it touches no device.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional


class Shed(RuntimeError):
    """Raised to the caller when admission control rejects a request."""


@dataclasses.dataclass
class AdmissionStats:
    admitted: int = 0
    shed: int = 0
    completed: int = 0
    depth: int = 0
    high_water: int = 0

    def snapshot(self) -> Dict[str, int]:
        return {
            "admitted": self.admitted,
            "shed": self.shed,
            "completed": self.completed,
            "depth": self.depth,
            "high_water": self.high_water,
        }


class AdmissionController:
    """Bounded-depth admission gate (thread-safe).

    ``admit()`` raises :class:`Shed` when the bound cannot be honored;
    ``try_admit()`` is the bool-returning variant.  Every successful admit
    must be paired with exactly one ``release()`` (use :meth:`held` for a
    context-managed pairing).
    """

    def __init__(
        self,
        max_depth: int = 64,
        policy: str = "shed",
        max_wait_s: float = 0.5,
    ):
        if max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        if policy not in ("shed", "block"):
            raise ValueError(f"unknown admission policy {policy!r}")
        self.max_depth = int(max_depth)
        self.policy = policy
        self.max_wait_s = float(max_wait_s)
        self.stats = AdmissionStats()
        self._cond = threading.Condition()

    def try_admit(self, timeout: Optional[float] = None) -> bool:
        """Admit one request, or return False when the engine is saturated.
        Under ``block`` the call waits up to ``timeout`` (default
        ``max_wait_s``) for depth to drop before giving up."""
        deadline = None
        with self._cond:
            while self.stats.depth >= self.max_depth:
                if self.policy == "shed":
                    self.stats.shed += 1
                    return False
                wait = self.max_wait_s if timeout is None else timeout
                if deadline is None:
                    deadline = time.monotonic() + wait
                    remaining = wait
                else:
                    remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(timeout=remaining):
                    self.stats.shed += 1
                    return False
            self.stats.depth += 1
            self.stats.admitted += 1
            self.stats.high_water = max(self.stats.high_water, self.stats.depth)
            return True

    def admit(self, timeout: Optional[float] = None) -> None:
        if not self.try_admit(timeout=timeout):
            raise Shed(
                f"admission shed: {self.stats.depth}/{self.max_depth} in "
                f"flight (policy={self.policy})"
            )

    def release(self) -> None:
        with self._cond:
            if self.stats.depth <= 0:
                raise RuntimeError("release() without a matching admit()")
            self.stats.depth -= 1
            self.stats.completed += 1
            self._cond.notify()

    class _Held:
        def __init__(self, ctl: "AdmissionController"):
            self._ctl = ctl

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self._ctl.release()
            return False

    def held(self, timeout: Optional[float] = None) -> "_Held":
        """``with controller.held(): ...`` — admit (raising :class:`Shed` on
        saturation) and release on exit, error paths included."""
        self.admit(timeout=timeout)
        return AdmissionController._Held(self)

    def snapshot(self) -> Dict[str, int]:
        with self._cond:
            return self.stats.snapshot()
