"""Per-selection scheduler pools: route by ``calib_key``.

A continuous-batching ``Scheduler`` is frozen to ONE layer selection —
its slot table's partitioned cache geometry is selection-static, which
is what makes the ragged step a single compile (and why the scheduler
asserts when a share arrives with different layers).  That was the
ROADMAP's "one frozen selection per scheduler" known limit.

``SchedulerPool`` lifts it the obvious way: a mixed-task request stream
is partitioned by ``calib_key`` and each key gets its own lazily-built
scheduler over the SAME session — per-key calibration state, transport
log, and page store all stay shared, only the slot table (and its
compiled steps) is per-selection.  Completions merge back in rid order,
so callers see one stream in, one stream out, whatever the key mix.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.core.types import KVCommConfig
from repro_torch.serving.scheduler import (Completion, Request, Scheduler,
                                     SchedulerConfig)


class SchedulerPool:
    """One ``Scheduler`` per ``calib_key`` over a shared ``CommSession``.

    ``submit`` queues a request under its key; ``run`` drains every
    queue — keys in deterministic order (None first, then sorted), each
    through its own scheduler — and returns the merged completions plus
    per-key metrics.  Schedulers persist across ``run`` calls, so a
    steady-state serving loop pays each selection's compiles once."""

    def __init__(self, session, kvcfg: KVCommConfig, *,
                 config: Optional[SchedulerConfig] = None) -> None:
        self.session = session
        self.kvcfg = kvcfg
        self.config = config
        self._schedulers: Dict[Optional[str], Scheduler] = {}
        self._queues: Dict[Optional[str], List[Request]] = {}

    def scheduler(self, calib_key: Optional[str] = None) -> Scheduler:
        """The (lazily-built) scheduler frozen to ``calib_key``'s
        selection.  Distinct keys with distinct calibrated scores get
        distinct slot-table geometries — the whole point."""
        if calib_key not in self._schedulers:
            self._schedulers[calib_key] = Scheduler(
                self.session, self.kvcfg, calib_key=calib_key,
                config=self.config)
        return self._schedulers[calib_key]

    def submit(self, request: Request,
               calib_key: Optional[str] = None) -> None:
        self._queues.setdefault(calib_key, []).append(request)

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def run(self) -> Tuple[List[Completion], Dict]:
        """Drain every per-key queue.  Returns completions in rid order
        and ``{"pools": n, "tokens": total, "per_key": {key: metrics}}``."""
        completions: List[Completion] = []
        per_key: Dict[Optional[str], Dict] = {}
        for key in sorted(self._queues, key=lambda k: (k is not None, k)):
            reqs = self._queues[key]
            if not reqs:
                continue
            comps, m = self.scheduler(key).run(reqs)
            completions.extend(comps)
            per_key[key] = m
        self._queues.clear()
        completions.sort(key=lambda c: c.rid)
        return completions, {
            "pools": len(per_key),
            "tokens": int(sum(len(c.tokens) for c in completions)),
            "per_key": per_key,
        }
