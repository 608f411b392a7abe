"""Runtime helpers of training: the straggler watchdog and the
heartbeat-based failure detector.  The sharding rules of the reference's
``repro.distributed`` (a mesh of several devices) are not ported yet
(ROADMAP A3.4)."""

from .watchdog import Heartbeat, StepWatchdog

__all__ = ["StepWatchdog", "Heartbeat"]
