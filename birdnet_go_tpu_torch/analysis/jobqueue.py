"""Bounded async job queue with per-action retry policies and
priority-aware shedding.

Reference: internal/analysis/jobqueue/ — capacity 1000, job lifecycle
pending → running → completed/failed, per-action RetryConfig with
exponential backoff, stats counters (queue.go:59-204). Drops (queue full)
are the designed overload behavior and are counted, never blocking the
producer.

Beyond the reference, overload shedding is *ordered*: every job carries an
action category (the analogue of the per-action-type RetryConfig table at
processor/actions_types.go:92-339), categories map to priority bands, and
when the queue is full an incoming high-priority job (database save, clip
export) evicts the newest low-priority pending job (log line, MQTT
publish, alert evaluation) instead of being dropped itself. Workers drain
higher bands first, so under a detection burst clip saves and DB writes
run ahead of notification fan-out. Every drop — incoming or evicted — is
counted per category so a soak can prove *which* actions shed, in order.

A copy of ``birdnet_go_tpu/analysis/jobqueue.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_detection.py``
holds it to the original.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import logging
import threading
import time
from typing import Any, Callable

from birdnet_go_tpu_torch.utils import tracing

log = logging.getLogger("birdnet_tpu.jobqueue")

DEFAULT_CAPACITY = 1000               # jobqueue/queue.go:59

# Priority bands: 0 drains first and sheds last. The assignment mirrors
# the reference's action ordering contract (CompositeAction runs
# Database→SSE→MQTT; SaveAudio retries hardest — actions_types.go:92-339):
# data-bearing actions are never shed while telemetry-ish ones remain.
PRIORITY_CRITICAL = 0      # database save, composite (DB→SSE→MQTT), clip
PRIORITY_NORMAL = 1        # spectrogram prerender, birdweather, commands
PRIORITY_LOW = 2           # log lines, bare MQTT, alerts, notifications

CATEGORY_PRIORITY: dict[str, int] = {
    "database": PRIORITY_CRITICAL,
    "composite": PRIORITY_CRITICAL,
    "clip": PRIORITY_CRITICAL,
    "spectrogram": PRIORITY_NORMAL,
    "birdweather": PRIORITY_NORMAL,
    "command": PRIORITY_NORMAL,
    "other": PRIORITY_NORMAL,
    "log": PRIORITY_LOW,
    "mqtt": PRIORITY_LOW,
    "sse": PRIORITY_LOW,
    "alert": PRIORITY_LOW,
    "notify": PRIORITY_LOW,
}


class JobStatus(str, enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"


@dataclasses.dataclass(frozen=True)
class RetryConfig:
    enabled: bool = False
    max_retries: int = 3
    initial_delay: float = 5.0
    backoff_multiplier: float = 2.0
    max_delay: float = 300.0

    def delay_for(self, attempt: int) -> float:
        return min(self.initial_delay * self.backoff_multiplier ** attempt,
                   self.max_delay)


@dataclasses.dataclass
class Job:
    action: Callable[[], Any]
    description: str
    retry: RetryConfig = dataclasses.field(default_factory=RetryConfig)
    category: str = "other"
    priority: int = PRIORITY_NORMAL
    status: JobStatus = JobStatus.PENDING
    attempts: int = 0
    enqueued_at: float = dataclasses.field(default_factory=time.monotonic)
    # the spans' clock (utils/tracing.py): job.wait runs from here to start
    enqueued_ns: int = dataclasses.field(default_factory=time.perf_counter_ns)
    not_before: float = 0.0
    last_error: str | None = None


def _category_counters() -> dict[str, int]:
    # first_drop_t pre-seeded as None: readers serialize these dicts
    # without the stats lock, so no key may ever be INSERTED after
    # creation (value updates are safe; size changes race iterators)
    return {"enqueued": 0, "completed": 0, "failed": 0, "retried": 0,
            "dropped": 0, "shed": 0, "first_drop_t": None}


@dataclasses.dataclass
class JobQueueStats:
    enqueued: int = 0
    completed: int = 0
    failed: int = 0
    retried: int = 0
    dropped: int = 0
    shed: int = 0              # drops that were priority evictions
    by_category: dict = dataclasses.field(default_factory=dict)

    def _cat(self, category: str) -> dict[str, int]:
        c = self.by_category.get(category)
        if c is None:
            c = self.by_category[category] = _category_counters()
        return c

    def bump(self, category: str, counter: str, n: int = 1) -> None:
        setattr(self, counter, getattr(self, counter) + n)
        c = self._cat(category)
        c[counter] += n
        # shed-order forensics: stamp each category's first drop so an
        # overload run can prove which action types shed, in what order
        if counter == "dropped" and c["first_drop_t"] is None:
            c["first_drop_t"] = round(time.monotonic(), 3)


class JobQueue:
    """Bounded worker-pool job queue (non-blocking enqueue, drop-counted,
    priority-banded shedding)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, workers: int = 4):
        self.capacity = capacity
        self.stats = JobQueueStats()
        # Pre-seed every known category: API threads serialize stats
        # (vars()/asdict) WITHOUT the stats lock, and a first-ever bump of
        # a new category would otherwise insert a dict key mid-iteration
        # (RuntimeError in the reader). Unknown custom categories are
        # folded into "other" at enqueue for the same reason.
        for cat in CATEGORY_PRIORITY:
            self.stats._cat(cat)
        self._bands: dict[int, collections.deque[Job]] = {
            PRIORITY_CRITICAL: collections.deque(),
            PRIORITY_NORMAL: collections.deque(),
            PRIORITY_LOW: collections.deque(),
        }
        self._size = 0
        self._inflight = 0   # popped but not yet terminal/requeued
        self._cv = threading.Condition()
        self._workers = workers
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._stats_lock = threading.Lock()

    def start(self) -> None:
        if self._threads:
            return
        self._stop.clear()
        for i in range(self._workers):
            t = threading.Thread(target=self._worker, name=f"jobq-{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self, drain: bool = True, timeout: float = 10.0) -> None:
        if drain:
            # Drain on queued + in-flight, not pending() alone: a popped
            # job is invisible to pending() while it executes, and if it
            # fails with retry enabled it re-enters the queue AFTER a
            # pending()==0 sample — stop would then strand it (ledger off
            # by one; the r4 stress flake).
            deadline = time.monotonic() + timeout
            while self.outstanding() and time.monotonic() < deadline:
                time.sleep(0.01)
            if self.outstanding():
                log.warning("jobqueue stop: drain deadline hit with %d "
                            "jobs outstanding", self.outstanding())
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=2)
        self._threads.clear()

    def enqueue(self, action: Callable[[], Any], description: str,
                retry: RetryConfig | None = None,
                category: str = "other") -> bool:
        """Non-blocking; returns False (and counts a drop) when full.

        When full and the incoming job outranks a pending lower-priority
        job, the newest such pending job is evicted (counted as
        dropped+shed under ITS category) and the incoming one is accepted
        — clip saves and DB writes survive bursts at the expense of
        log/MQTT/alert fan-out (VERDICT r3 #1; reference treats drops as
        accounted overload behavior, jobqueue/queue.go:59-204).
        """
        if category not in CATEGORY_PRIORITY:
            category = "other"
        priority = CATEGORY_PRIORITY[category]
        job = Job(action=action, description=description,
                  retry=retry or RetryConfig(),
                  category=category, priority=priority)
        with self._cv:
            if self._size >= self.capacity:
                victim = self._shed_locked(priority)
                if victim is None:
                    with self._stats_lock:
                        self.stats.bump(category, "dropped")
                    log.warning("job queue full, dropped: %s", description)
                    return False
                with self._stats_lock:
                    self.stats.bump(victim.category, "dropped")
                    self.stats.bump(victim.category, "shed")
                log.warning("job queue full, shed %r (%s) for %r",
                            victim.description, victim.category,
                            description)
            self._bands[priority].append(job)
            self._size += 1
            self._cv.notify()
        with self._stats_lock:
            self.stats.bump(category, "enqueued")
        return True

    def _shed_locked(self, incoming_priority: int) -> Job | None:
        """Evict the newest pending job from the lowest band that is
        strictly lower-priority than the incoming job. Caller holds _cv."""
        for band in (PRIORITY_LOW, PRIORITY_NORMAL):
            if band > incoming_priority and self._bands[band]:
                victim = self._bands[band].pop()
                self._size -= 1
                return victim
        return None

    def _requeue_locked(self, job: Job) -> bool:
        """Re-add a retried/not-due job to its band (front, preserving its
        original order ahead of newer work). Caller holds _cv."""
        if self._size >= self.capacity:
            return False
        self._bands[job.priority].appendleft(job)
        self._size += 1
        self._cv.notify()
        return True

    def pending(self) -> int:
        with self._cv:
            return self._size

    def outstanding(self) -> int:
        """Queued + in-flight work; drain is complete only at zero."""
        with self._cv:
            return self._size + self._inflight

    def pending_by_band(self) -> dict[int, int]:
        with self._cv:
            return {band: len(q) for band, q in self._bands.items()}

    def _pop(self) -> Job | None:
        """Block for the next runnable job, honoring band order and
        not_before retry timers; None on shutdown."""
        while True:
            with self._cv:
                while self._size == 0 and not self._stop.is_set():
                    self._cv.wait(0.1)
                if self._stop.is_set():
                    return None
                now = time.monotonic()
                for band in (PRIORITY_CRITICAL, PRIORITY_NORMAL,
                             PRIORITY_LOW):
                    q = self._bands[band]
                    for _ in range(len(q)):
                        job = q.popleft()
                        if job.not_before <= now:
                            self._size -= 1
                            self._inflight += 1
                            return job
                        q.append(job)       # not due yet, rotate
                # only delayed retries pending: nap until one comes due
                self._cv.wait(0.02)

    def _worker(self) -> None:
        while not self._stop.is_set():
            job = self._pop()
            if job is None:
                return
            try:
                self._execute(job)
            finally:
                # decrement only after the job is terminal-counted or
                # requeued (where _size sees it again)
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()

    def _execute(self, job: Job) -> None:
        job.status = JobStatus.RUNNING
        job.attempts += 1
        tracing.add("job.wait", job.enqueued_ns, time.perf_counter_ns(),
                    category=job.category)
        try:
            with tracing.span("job.run", category=job.category):
                job.action()
        except Exception as e:  # noqa: BLE001 — actions are arbitrary
            job.last_error = f"{type(e).__name__}: {e}"
            if job.retry.enabled and job.attempts <= job.retry.max_retries:
                delay = job.retry.delay_for(job.attempts - 1)
                job.not_before = time.monotonic() + delay
                job.enqueued_ns = time.perf_counter_ns()
                job.status = JobStatus.PENDING
                with self._stats_lock:
                    self.stats.bump(job.category, "retried")
                log.info("job %r failed (%s), retry %d/%d in %.1fs",
                         job.description, job.last_error, job.attempts,
                         job.retry.max_retries, delay)
                with self._cv:
                    ok = self._requeue_locked(job)
                if not ok:
                    with self._stats_lock:
                        self.stats.bump(job.category, "dropped")
                return
            job.status = JobStatus.FAILED
            with self._stats_lock:
                self.stats.bump(job.category, "failed")
            log.error("job %r failed permanently: %s", job.description,
                      job.last_error)
            return
        job.status = JobStatus.COMPLETED
        with self._stats_lock:
            self.stats.bump(job.category, "completed")
