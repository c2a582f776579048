"""Prioritized (de)compression job queue.

Four strict-priority classes, FIFO inside each class (paper §IV: the
controller services latency-critical traffic first and lets the compression
engine soak up slack cycles):

* ``DECODE_FETCH`` — partial-plane KV fetches on the decode critical path.
* ``WEIGHT_FETCH`` — weight-stream layer decompresses fetched ahead of
  compute: latency-critical for the NEXT layer's matmuls, so they beat
  writes, but they prefetch a whole lane window ahead and therefore yield
  to the decode-critical KV fetches of the CURRENT step.
* ``KV_WRITE`` — prefill-page and filled-decode-page compress-and-store.
* ``BACKGROUND`` — re-compression of evicted pages (re-activation) and
  eviction write-back to the capacity tier.

Jobs carry *logical* (decompressed-side) bytes — the side the 512 Gb/s lane
rating applies to — plus a ``fn`` thunk run when the job completes, so the
store/controller bookkeeping happens at modeled service time, stamped with
the service cycle.
"""

from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Callable, Deque, Dict, Hashable, Optional


class JobClass(enum.IntEnum):
    DECODE_FETCH = 0
    WEIGHT_FETCH = 1
    KV_WRITE = 2
    BACKGROUND = 3


@dataclasses.dataclass
class Job:
    klass: JobClass
    nbytes: int  # logical bytes the engine must move
    #: runs at service time (store put / fetch accounting); may be None for
    #: occupancy-only jobs (eviction write-back)
    fn: Optional[Callable[[], object]] = None
    #: page key / identity — dedupes pending work and supports cancellation
    key: Hashable = None
    #: cancellation scope for cancel-on-retire (None = never cancelled).
    #: Single-tier backends use the bare request id; sharded backends use a
    #: ``(shard, rid)`` tuple so retiring a request's work on one shard can
    #: never cancel a same-rid job queued on another shard.
    seq_id: Optional[Hashable] = None
    #: deferred sizing: when set, the runtime calls it ONCE — at service
    #: start, not submit time — to resolve ``nbytes``.  Decode fetches use
    #: this so a ladder re-assignment between submit and service cannot make
    #: the lane-pool bytes and the controller's kv_read charge disagree.
    size_fn: Optional[Callable[[], int]] = None
    submit_step: int = 0
    submit_cycle: int = 0
    remaining: int = 0  # bytes still to service (partial-service carryover)
    deferrals: int = 0  # step boundaries this job waited across

    def __post_init__(self):
        self.remaining = self.nbytes


class PriorityJobQueue:
    """Strict-priority deques with a pending-key refcount index.

    The index is a count, not a single slot: the scheduler legitimately
    queues the same fetch key once per step while the engine is backlogged,
    and ``pending()`` must keep answering True until the LAST duplicate is
    popped or cancelled."""

    def __init__(self):
        self._queues: Dict[JobClass, Deque[Job]] = {
            k: deque() for k in JobClass
        }
        self._pending_keys: Dict[Hashable, int] = {}

    def _index_drop(self, klass: JobClass, key: Hashable) -> None:
        kk = (klass, key)
        n = self._pending_keys.get(kk, 0) - 1
        if n > 0:
            self._pending_keys[kk] = n
        else:
            self._pending_keys.pop(kk, None)

    def push(self, job: Job) -> None:
        self._queues[job.klass].append(job)
        if job.key is not None:
            kk = (job.klass, job.key)
            self._pending_keys[kk] = self._pending_keys.get(kk, 0) + 1

    def peek(self) -> Optional[Job]:
        for k in JobClass:
            if self._queues[k]:
                return self._queues[k][0]
        return None

    def pop(self) -> Optional[Job]:
        for k in JobClass:
            if self._queues[k]:
                job = self._queues[k].popleft()
                if job.key is not None:
                    self._index_drop(job.klass, job.key)
                return job
        return None

    def pending(self, key: Hashable, klass: JobClass | None = None) -> bool:
        """Is work for ``key`` already queued (any class by default)?"""
        if klass is not None:
            return (klass, key) in self._pending_keys
        return any((k, key) in self._pending_keys for k in JobClass)

    def cancel_seq(self, seq_id: Hashable) -> int:
        """Drop every queued job whose cancellation scope equals ``seq_id``.

        The match is exact: a sharded backend that scopes jobs with
        ``(shard, rid)`` tuples cancels one shard's work only — a bare-rid
        cancel cannot reach a tuple-scoped job and vice versa."""
        dropped = 0
        for k, q in self._queues.items():
            keep = deque()
            for job in q:
                if job.seq_id == seq_id:
                    if job.key is not None:
                        self._index_drop(k, job.key)
                    dropped += 1
                else:
                    keep.append(job)
            self._queues[k] = keep
        return dropped

    def depth(self, klass: JobClass | None = None) -> int:
        if klass is not None:
            return len(self._queues[klass])
        return sum(len(q) for q in self._queues.values())

    def remaining_bytes(self) -> int:
        """Unserviced logical bytes across all queued jobs — the backlog the
        lane pool still has to move.  Service-time-sized jobs (decode
        fetches, ``size_fn`` pending) count as 0 until sized; write and
        background traffic dominates a real backlog, so this stays a sound
        admission-pressure signal."""
        return sum(job.remaining for q in self._queues.values() for job in q)

    def mark_deferred(self) -> int:
        """A step window closed with these jobs still queued."""
        n = 0
        for q in self._queues.values():
            for job in q:
                job.deferrals += 1
                n += 1
        return n

    def __len__(self) -> int:
        return self.depth()
