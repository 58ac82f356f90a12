"""Fault tolerance of the remote KV stack (port).

A dropped socket, a stalled KV server or a corrupt frame degrades one
request instead of the serving loop. The pieces the rest of the stack
threads through:

  RetryPolicy     — bounded attempts, exponential backoff with seeded
                    jitter, a deadline over the whole call.
                    ``RemoteTransport(policy=...)`` and ``KVClient`` run
                    their exchanges under it; a paged retry re-asks
                    ``page_query``, so it ships only the pages the
                    receiver's pool never got.
  CircuitBreaker  — a per-peer closed -> open -> half-open gate over
                    consecutive failures; while open the peer is
                    quarantined and callers go straight to their
                    fallback.
  Resilience +    — the ladder a ``CommSession`` walks when retries are
  DegradationEvent  exhausted: remote -> serialized in process -> baseline
                    (text only, zero KV bytes). Each downgrade is a
                    ``DegradationEvent`` on the transfer record and the
                    scheduler's ``Completion``.
  FaultSchedule + — the chaos harness: drop / truncate / corrupt / delay /
  FaultyChannel     disconnect faults fired at exact frame boundaries
                    (every ``write`` is one frame), scripted or drawn from
                    a seed.

Host-side control flow only. Jitter and random schedules come from
``random.Random(seed)``, so a run replays exactly, and the same seed gives
the reference package's faults at the same frames.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.comm.remote import (ChannelClosedError, FrameCorruptError,
                                     FrameTruncatedError, HeaderCorruptError,
                                     RemoteChannel, RemoteProtocolError)

# what a retry over a reset channel can fix; version skew and payload
# mismatches are permanent (the peer answers the same way every time)
RETRIABLE_ERRORS: Tuple[type, ...] = (
    ChannelClosedError, FrameTruncatedError, FrameCorruptError,
    HeaderCorruptError, OSError)


class RetriesExhaustedError(RemoteProtocolError):
    """Every attempt a ``RetryPolicy`` allowed failed; carries the attempt
    count and the last error (also its ``__cause__``)."""

    def __init__(self, describe: str, attempts: int,
                 last: BaseException) -> None:
        super().__init__(
            f"{describe}: {attempts} attempt(s) exhausted; "
            f"last error: {type(last).__name__}: {last}")
        self.attempts = attempts
        self.last = last


class CircuitOpenError(RemoteProtocolError):
    """The peer's breaker is open: the call was never attempted."""


@dataclass(frozen=True)
class RetryPolicy:
    """``run(fn)`` calls ``fn(attempt)`` up to ``max_attempts`` times,
    sleeping ``backoff(attempt)`` between retriable failures; other errors
    propagate untouched. ``deadline_s`` bounds the whole call: once spent,
    the next failure raises instead of sleeping."""

    max_attempts: int = 3
    backoff_s: float = 0.02        # first sleep
    backoff_mult: float = 2.0
    max_backoff_s: float = 1.0
    jitter: float = 0.25           # +/- fraction of the base backoff
    deadline_s: Optional[float] = None
    seed: int = 0

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")

    def backoff(self, attempt: int, rng: random.Random) -> float:
        """Sleep before attempt ``attempt + 1`` (attempts count from 0)."""
        base = min(self.backoff_s * (self.backoff_mult ** attempt),
                   self.max_backoff_s)
        if self.jitter <= 0:
            return base
        return max(0.0, base * (1.0 + self.jitter * rng.uniform(-1, 1)))

    def run(self, fn: Callable[[int], Any], *,
            retriable: Tuple[type, ...] = RETRIABLE_ERRORS,
            describe: str = "remote op",
            on_retry: Optional[Callable[[int, BaseException], None]] = None,
            sleep: Callable[[float], None] = time.sleep,
            clock: Callable[[], float] = time.monotonic) -> Any:
        """Drive ``fn(attempt)`` under this policy; ``on_retry(attempt,
        err)`` fires before each re-attempt."""
        rng = random.Random(self.seed)
        deadline = (None if self.deadline_s is None
                    else clock() + self.deadline_s)
        for attempt in range(self.max_attempts):
            try:
                return fn(attempt)
            except retriable as e:       # noqa: PERF203 — retry loop
                out_of_time = deadline is not None and clock() >= deadline
                if attempt == self.max_attempts - 1 or out_of_time:
                    raise RetriesExhaustedError(
                        describe, attempt + 1, e) from e
                if on_retry is not None:
                    on_retry(attempt, e)
                pause = self.backoff(attempt, rng)
                if deadline is not None:
                    pause = min(pause, max(0.0, deadline - clock()))
                if pause > 0:
                    sleep(pause)
        raise AssertionError("unreachable")     # pragma: no cover


class CircuitBreaker:
    """``failure_threshold`` consecutive failures open the circuit; while
    open ``allow()`` is False. After ``reset_timeout_s`` it goes half-open
    and lets exactly one trial through: its success closes the circuit,
    its failure re-opens it. The clock is injectable."""

    def __init__(self, failure_threshold: int = 3,
                 reset_timeout_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self._clock = clock
        self.state = "closed"
        self.failures = 0              # consecutive failures
        self._opened_at = 0.0
        self._probing = False          # the half-open trial is in flight

    def allow(self) -> bool:
        """May the caller attempt the peer now?"""
        if self.state == "open":
            if self._clock() - self._opened_at >= self.reset_timeout_s:
                self.state = "half-open"
                self._probing = False
            else:
                return False
        if self.state == "half-open":
            if self._probing:
                return False           # one trial at a time
            self._probing = True
        return True

    def peek(self) -> str:
        """The current state, applying the open -> half-open timeout but
        not taking the half-open trial slot (the router ranks by it)."""
        if self.state == "open" and \
                self._clock() - self._opened_at >= self.reset_timeout_s:
            self.state = "half-open"
            self._probing = False
        return self.state

    def record_success(self) -> None:
        self.state = "closed"
        self.failures = 0
        self._probing = False

    def record_failure(self) -> None:
        self.failures += 1
        self._probing = False
        if self.state == "half-open" \
                or self.failures >= self.failure_threshold:
            self.state = "open"
            self._opened_at = self._clock()


@dataclass
class DegradationEvent:
    """One request's downgrade: the rung that served it, the stage that
    failed, and why."""
    stage: str                     # rung that served: "serialized"|"baseline"
    from_stage: str = "remote"     # rung that failed
    reason: str = ""               # the last error
    attempts: int = 1              # attempts the failing stage burned
    rid: Optional[int] = None      # request id, when known

    def __str__(self) -> str:
        tag = "" if self.rid is None else f"rid={self.rid} "
        return (f"DegradationEvent({tag}{self.from_stage} -> {self.stage} "
                f"after {self.attempts} attempt(s): {self.reason})")


@dataclass
class Resilience:
    """A ``CommSession``'s ladder and optional peer breaker: ``fallbacks``
    are (stage, Transport or None) rungs tried in order once the primary
    transport gives up; a None transport is the terminal ``baseline`` rung
    (text only, ``shared=None``). The retry policy lives on the transport."""
    fallbacks: Sequence[Tuple[str, Optional[Any]]] = \
        field(default_factory=lambda: [("baseline", None)])
    breaker: Optional[CircuitBreaker] = None


def default_resilience(wire_dtype: str = "float16",
                       breaker: Optional[CircuitBreaker] = None
                       ) -> Resilience:
    """remote -> an in-process ``SerializedTransport`` at the same wire
    dtype -> text only."""
    from repro_torch.comm.transport import SerializedTransport
    return Resilience(
        fallbacks=[("serialized", SerializedTransport(wire_dtype)),
                   ("baseline", None)],
        breaker=breaker if breaker is not None else CircuitBreaker())


# ---------------------------------------------------------------------------
# the chaos harness
# ---------------------------------------------------------------------------
FAULT_KINDS = ("drop", "truncate", "corrupt", "delay", "disconnect")


@dataclass(frozen=True)
class Fault:
    """A fault fired on the ``op``-th frame written through a
    ``FaultyChannel``:

      drop       — the frame never lands; the channel breaks.
      truncate   — ``frac`` of the frame lands, then the channel breaks.
      corrupt    — the byte at relative offset ``frac`` is flipped.
      delay      — the frame lands after ``delay_s`` of wall clock.
      disconnect — the write raises ``ChannelClosedError``; the channel
                   breaks.
    """
    op: int
    kind: str
    frac: float = 0.5
    delay_s: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}")


class FaultSchedule:
    """Write index -> Fault, scripted (``FaultSchedule([Fault(0,
    "truncate")])``) or seeded (``FaultSchedule.random(seed=7, n_ops=12,
    rate=0.3)``)."""

    def __init__(self, faults: Sequence[Fault] = ()) -> None:
        self._by_op: Dict[int, Fault] = {}
        for f in faults:
            if f.op in self._by_op:
                raise ValueError(f"two faults scripted for op {f.op}")
            self._by_op[f.op] = f
        self.fired: List[Fault] = []

    @classmethod
    def random(cls, seed: int, n_ops: int, rate: float,
               kinds: Sequence[str] = FAULT_KINDS,
               delay_s: float = 0.0) -> "FaultSchedule":
        """Each of the first ``n_ops`` writes faults with probability
        ``rate``; the draws are the reference's, in its order."""
        rng = random.Random(seed)
        faults = []
        for op in range(n_ops):
            if rng.random() < rate:
                kind = rng.choice(list(kinds))
                faults.append(Fault(op=op, kind=kind,
                                    frac=rng.uniform(0.1, 0.9),
                                    delay_s=delay_s))
        return cls(faults)

    def pop(self, op: int) -> Optional[Fault]:
        f = self._by_op.pop(op, None)
        if f is not None:
            self.fired.append(f)
        return f

    def __len__(self) -> int:
        return len(self._by_op)


class FaultyChannel(RemoteChannel):
    """Wraps a ``RemoteChannel`` and fires the schedule's faults. After a
    breaking fault (truncate, disconnect, drop) writes raise and reads
    return b"" until ``reset()`` reconnects, which is what a retrying
    ``RemoteTransport`` with no channel factory calls. ``writes`` and
    ``bytes_written`` count every attempt, failed ones included."""

    def __init__(self, inner: RemoteChannel,
                 schedule: Optional[FaultSchedule] = None) -> None:
        self.inner = inner
        self.schedule = schedule if schedule is not None else FaultSchedule()
        self.writes = 0                # frames attempted, faulted included
        self.bytes_written = 0         # bytes handed to inner
        self.resets = 0
        self._broken = False

    def _write_inner(self, data: bytes) -> None:
        self.inner.write(data)
        self.bytes_written += len(data)

    def write(self, data: bytes) -> None:
        op = self.writes
        self.writes += 1
        if self._broken:
            raise ChannelClosedError(
                "faulty channel is down (awaiting reset/reconnect)")
        fault = self.schedule.pop(op)
        if fault is None:
            self._write_inner(data)
            return
        if fault.kind == "drop":
            self._broken = True
            return
        if fault.kind == "truncate":
            cut = max(1, min(len(data) - 1, int(len(data) * fault.frac)))
            self._write_inner(data[:cut])
            self._broken = True
            return
        if fault.kind == "corrupt":
            i = min(len(data) - 1, max(0, int(len(data) * fault.frac)))
            bad = bytearray(data)
            bad[i] ^= 0xFF
            self._write_inner(bytes(bad))
            return
        if fault.kind == "delay":
            if fault.delay_s > 0:
                time.sleep(fault.delay_s)
            self._write_inner(data)
            return
        self._broken = True            # disconnect
        raise ChannelClosedError("fault injected: peer disconnected")

    def read(self, n: int) -> bytes:
        if self._broken:
            return b""                 # Closed or Truncated by position
        return self.inner.read(n)

    def reset(self) -> None:
        """Reconnect: heal the broken state and drain any half-written
        frame left in the inner buffer."""
        self._broken = False
        self.resets += 1
        if hasattr(self.inner, "__len__"):
            while len(self.inner):     # type: ignore[arg-type]
                self.inner.read(1 << 16)

    def close(self) -> None:
        self.inner.close()
