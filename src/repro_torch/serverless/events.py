"""Discrete-event loop for the serverless runtime.

A minimal virtual-clock scheduler: handlers are plain callables scheduled at
absolute virtual times and executed in (time, insertion) order. Real
computation (attribute filtering, the batched data plane) runs *inside*
handlers; its wall-clock duration — or a configured constant — is then used
to schedule downstream events, so the virtual timeline models a fleet of
concurrent FaaS workers while the host executes them one at a time.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Callable, List, Tuple

__all__ = ["EventLoop"]


class EventLoop:
    """Priority-queue event loop over a virtual clock (seconds)."""

    def __init__(self):
        self.now: float = 0.0
        self._seq = itertools.count()
        self._queue: List[Tuple[float, int, Callable[[], None]]] = []

    def at(self, when: float, fn: Callable[[], None]) -> None:
        """Schedule ``fn`` at absolute virtual time ``when`` (>= now)."""
        if when < self.now:
            raise ValueError(f"cannot schedule into the past: {when} < {self.now}")
        heapq.heappush(self._queue, (when, next(self._seq), fn))

    def after(self, delay: float, fn: Callable[[], None]) -> None:
        self.at(self.now + max(delay, 0.0), fn)

    def run(self) -> float:
        """Drain the queue; returns the final virtual time (the makespan)."""
        while self._queue:
            self.now, _, fn = heapq.heappop(self._queue)
            fn()
        return self.now
