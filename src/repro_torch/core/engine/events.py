"""In-process pub/sub event bus (the paper's Redis stand-in, §4.2).

A copy of ``repro/core/engine/events.py``, with its imports
in ``repro_torch.core``.

Three topics: ``container_status`` (published by the launcher watching the
cluster), ``job_progress`` (published by the in-container agent:
downloading, running, uploading...), and ``scheduler_metrics`` (cluster
utilization / queue-depth snapshots from the capacity scheduler).
Synchronous delivery keeps the engine deterministic for tests; a real
deployment swaps this for Redis without changing publishers/subscribers.

``history`` is a bounded ring buffer (``history_limit`` most recent
messages) — a long-lived engine publishes one event per state transition
per job, so an unbounded log would grow O(total events) for the life of
the process. Each publish snapshots the message exactly once; the same
frozen dict is appended to history and handed to every subscriber, so
messages must be treated as immutable after publish (subscribers that
need a private mutable copy make their own).

Publish/subscribe are thread-safe for the ThreadPoolRunner's workers;
handlers are invoked outside the bus lock (handlers take their own locks,
and holding the bus lock across them would invert lock order).
"""
from __future__ import annotations

import threading
from collections import defaultdict, deque
from typing import Callable

TOPIC_CONTAINER_STATUS = "container_status"
TOPIC_JOB_PROGRESS = "job_progress"
TOPIC_SCHEDULER = "scheduler_metrics"

DEFAULT_HISTORY_LIMIT = 10_000


class EventBus:
    def __init__(self, history_limit: int = DEFAULT_HISTORY_LIMIT, *,
                 store=None, stream: str = "events"):
        """``store`` (a durable ``StateStore``) persists every published
        message to ``stream`` — the Redis-stream half of the paper's bus:
        a fresh process (CLI ``status``/``logs``) reads the stream
        instead of needing to have been subscribed when events fired."""
        self._subs: dict[str, list[Callable[[dict], None]]] = defaultdict(list)  # guarded-by: _lock
        self.history: deque[tuple[str, dict]] = deque(maxlen=history_limit)
        self._store = store
        self._stream = stream
        # handlers are invoked OUTSIDE this lock (they take their own —
        # holding it across them inverts lock order), hence no bare
        # calls and no nested publish under it
        self._lock = threading.RLock()  # acailint: lock(forbid: bare-calls, publish)

    def subscribe(self, topic: str, fn: Callable[[dict], None]) -> None:
        with self._lock:
            self._subs[topic].append(fn)

    def publish(self, topic: str, msg: dict) -> None:
        # one defensive copy per publish (the caller may reuse/mutate its
        # dict); history and every subscriber share that copy instead of
        # re-copying per consumer
        msg = dict(msg)
        with self._lock:
            self.history.append((topic, msg))
            if self._store is not None:
                self._store.append(self._stream, {"topic": topic, **msg})
            subs = list(self._subs[topic])
        for fn in subs:
            fn(msg)
