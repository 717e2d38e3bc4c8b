"""Fault tolerance: graceful preemption, straggler detection, retries —
the port's own copy of the JAX package's ``repro.launch.fault`` (the
module uses neither framework; the port imports nothing of the JAX
package).

On a 1000+-node deployment the coordinator composes these primitives:
  * ``GracefulShutdown`` — SIGTERM/SIGINT => finish the current step,
    checkpoint, exit 0 (preemption-safe training; tested by sending the
    signal to a live training process);
  * ``StragglerWatchdog`` — per-step wall-clock EWMA; a step slower than
    ``threshold x EWMA`` is flagged. On multi-host this feeds the control
    plane (evict/replace the slow host and resume from the latest
    checkpoint); in one process the detection logic itself is what is
    tested;
  * ``retry`` — transient-failure wrapper (e.g. DCN hiccups during
    checkpoint writes).
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field

import numpy as np

__all__ = ["GracefulShutdown", "StragglerWatchdog", "retry"]


class GracefulShutdown:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self._prev = {}
        for s in signals:
            self._prev[s] = signal.signal(s, self._handler)

    def _handler(self, signum, frame):
        self.requested = True

    def restore(self):
        for s, h in self._prev.items():
            signal.signal(s, h)


@dataclass
class StragglerWatchdog:
    threshold: float = 3.0
    alpha: float = 0.1
    ewma: float | None = None
    flagged_steps: list = field(default_factory=list)
    _t0: float | None = None

    def start_step(self):
        # measuring real step duration is this class's whole job
        self._t0 = time.monotonic()  # lint: allow-wall-clock

    def end_step(self, step: int) -> bool:
        dt = time.monotonic() - self._t0  # lint: allow-wall-clock
        slow = self.ewma is not None and dt > self.threshold * self.ewma
        if slow:
            self.flagged_steps.append((step, dt, self.ewma))
        # slow steps should not poison the baseline
        if self.ewma is None:
            self.ewma = dt
        elif not slow:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow

    def observe(self, step: int, duration_s: float) -> bool:
        """Clock-free variant for tests."""
        self._t0 = time.monotonic() - duration_s  # lint: allow-wall-clock
        return self.end_step(step)


def retry(fn, *args, attempts: int = 3, backoff_s: float = 0.1,
          jitter_s: float = 0.0, exceptions=(OSError, IOError),
          rng: np.random.Generator | None = None, sleep=time.sleep,
          **kwargs):
    """Call ``fn`` up to ``attempts`` times with exponential backoff.

    ``attempts < 1`` raises ``ValueError`` (it used to fall through the
    empty loop and silently return ``None`` — indistinguishable from a
    successful call returning ``None``). ``jitter_s`` adds a uniform
    random extra sleep in ``[0, jitter_s]`` per retry so a fleet of
    workers retrying the same failed resource doesn't thunder back in
    lockstep. The jitter draws from ``rng`` (any
    ``numpy.random.Generator``; a fresh ``default_rng()`` per call when
    omitted) so callers that need a reproducible backoff trajectory pass
    ``rng=np.random.default_rng(seed)`` — this used to be module-level
    ``random.uniform``, unseedable from outside. ``sleep=`` is
    injectable for the same reason (tests assert the trajectory without
    actually sleeping)."""
    if attempts < 1:
        raise ValueError(f"retry needs attempts >= 1, got {attempts}")
    if backoff_s < 0 or jitter_s < 0:
        raise ValueError("backoff_s and jitter_s must be >= 0")
    if rng is None:
        rng = np.random.default_rng()
    for i in range(attempts):
        try:
            return fn(*args, **kwargs)
        except exceptions:
            if i == attempts - 1:
                raise
            sleep(backoff_s * (2 ** i) + float(rng.uniform(0.0, jitter_s)))
