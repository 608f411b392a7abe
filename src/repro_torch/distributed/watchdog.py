"""Straggler / failure detection.

Port of ``repro/distributed/watchdog.py`` (pure Python, copied so that the
port imports nothing of the reference).

``StepWatchdog`` tracks per-step wall time with a robust (median + MAD)
model and flags stragglers -- on a real pod this feeds the controller's
decision to checkpoint-and-reschedule a slow host.  ``Heartbeat`` is the
cross-host liveness primitive: each host touches its heartbeat file every
step; the controller treats a host whose beat is older than ``timeout`` as
failed and triggers an elastic restart from the last committed checkpoint
(the reference's tests/test_fault_tolerance.py and the port's
tests/test_torch_optim.py simulate both paths)."""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Deque, List, Optional


class StepWatchdog:
    def __init__(self, window: int = 50, threshold: float = 3.0,
                 min_steps: int = 10):
        self.window: Deque[float] = deque(maxlen=window)
        self.threshold = threshold
        self.min_steps = min_steps
        self.stragglers: List[int] = []
        self._step = 0
        self._t0: Optional[float] = None

    def start_step(self):
        self._t0 = time.monotonic()

    def end_step(self) -> bool:
        """Record the step; True if it was a straggler."""
        dt = time.monotonic() - self._t0
        is_straggler = False
        if len(self.window) >= self.min_steps:
            med = sorted(self.window)[len(self.window) // 2]
            mad = sorted(abs(x - med) for x in self.window)[
                len(self.window) // 2]
            if dt > med + self.threshold * max(mad, 0.05 * med, 1e-4):
                is_straggler = True
                self.stragglers.append(self._step)
        # stragglers poison the baseline -- only admit normal steps
        if not is_straggler:
            self.window.append(dt)
        self._step += 1
        return is_straggler

    def observe(self, dt: float) -> bool:
        """Test hook: feed a duration directly."""
        self._t0 = time.monotonic() - dt
        return self.end_step()


class Heartbeat:
    """File-based liveness: ``beat()`` each step; ``dead_hosts()`` on the
    controller returns hosts whose last beat exceeds the timeout."""

    def __init__(self, root: str, host_id: int, timeout: float = 60.0):
        self.root = root
        self.host_id = host_id
        self.timeout = timeout
        os.makedirs(root, exist_ok=True)

    def _path(self, host: int) -> str:
        return os.path.join(self.root, f"host_{host:04d}.beat")

    def beat(self, step: int):
        with open(self._path(self.host_id), "w") as f:
            f.write(f"{step} {time.time()}")

    def dead_hosts(self, n_hosts: int, now: Optional[float] = None):
        now = time.time() if now is None else now
        dead = []
        for h in range(n_hosts):
            try:
                with open(self._path(h)) as f:
                    _, t = f.read().split()
                if now - float(t) > self.timeout:
                    dead.append(h)
            except FileNotFoundError:
                dead.append(h)
        return dead
