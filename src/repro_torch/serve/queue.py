"""Priority admission queue for reconstruction jobs.

Port of ``repro/serve/queue.py`` (pure Python).

Ordering: higher ``priority`` first; within a priority level, submission
order (FIFO).  A preempted job re-enters the queue with its *original*
submission sequence number, so it goes back ahead of later arrivals of the
same priority instead of losing its place.

The queue is thread-safe (a single lock around the heap) so that client
threads can submit while a scheduler thread drains.
"""

from __future__ import annotations

import heapq
import threading
from typing import Dict, List, Optional, Tuple

from .job import JobRecord, JobStatus


class PriorityJobQueue:
    """Max-priority / FIFO-tiebreak job queue with lazy cancellation."""

    def __init__(self):
        self._heap: List[Tuple[int, int, str]] = []   # (-prio, seq, job_id)
        self._records: Dict[str, JobRecord] = {}
        self._lock = threading.Lock()

    def push(self, record: JobRecord) -> None:
        with self._lock:
            self._records[record.job.job_id] = record
            heapq.heappush(self._heap,
                           (-record.job.priority, record.seq,
                            record.job.job_id))

    def pop(self) -> Optional[JobRecord]:
        """Highest-priority pending record, or None if empty."""
        with self._lock:
            while self._heap:
                _, _, job_id = heapq.heappop(self._heap)
                rec = self._records.pop(job_id, None)
                if rec is not None and rec.status != JobStatus.CANCELLED:
                    return rec
            return None

    def peek_priority(self) -> Optional[int]:
        """Priority of the next job that ``pop`` would return."""
        with self._lock:
            while self._heap:
                neg_prio, _, job_id = self._heap[0]
                rec = self._records.get(job_id)
                if rec is not None and rec.status != JobStatus.CANCELLED:
                    return -neg_prio
                heapq.heappop(self._heap)   # drop cancelled/stale entry
            return None

    def pending_records(self) -> List[JobRecord]:
        """Thread-safe snapshot of the queued (non-cancelled) records in
        pop order — the scheduler persists exactly these on a snapshot."""
        with self._lock:
            live = [(entry, self._records[entry[2]])
                    for entry in self._heap
                    if entry[2] in self._records
                    and self._records[entry[2]].status != JobStatus.CANCELLED]
            return [rec for _, rec in sorted(live, key=lambda t: t[0])]

    def remove(self, job_id: str) -> Optional[JobRecord]:
        """Take a queued record out *without* cancelling it (the work
        stealing path: the record moves to another pod's queue intact).
        The heap entry goes stale and is dropped lazily on pop/peek.
        Returns the record, or None if the job is not queued here."""
        with self._lock:
            return self._records.pop(job_id, None)

    def cancel(self, job_id: str) -> bool:
        """Mark a queued job cancelled (lazily removed on pop)."""
        with self._lock:
            rec = self._records.pop(job_id, None)
            if rec is None:
                return False
            rec.status = JobStatus.CANCELLED
            return True

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def __bool__(self) -> bool:
        return len(self) > 0
