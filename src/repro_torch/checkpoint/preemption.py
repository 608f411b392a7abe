"""Preemption handling: SIGTERM -> checkpoint-at-next-step-boundary.

Port of ``repro/checkpoint/preemption.py`` (stdlib ``signal`` code).

Cloud preemptions deliver SIGTERM with a grace window; the guard
flips a flag the train loop polls each step, triggering a final blocking
checkpoint + clean exit (tests simulate via ``guard.trigger()``)."""

from __future__ import annotations

import signal
import threading
from typing import Optional


class PreemptionGuard:
    def __init__(self, install_handler: bool = True):
        self._event = threading.Event()
        self._prev = None
        if install_handler:
            try:
                self._prev = signal.signal(signal.SIGTERM, self._on_sigterm)
            except ValueError:
                # not on the main thread (tests) -- manual trigger only
                self._prev = None

    def _on_sigterm(self, signum, frame):
        self._event.set()

    def trigger(self):
        """Manual trigger (tests / external watchdogs)."""
        self._event.set()

    @property
    def preempted(self) -> bool:
        return self._event.is_set()

    def uninstall(self):
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)
            self._prev = None
