"""Retry pacing: capped exponential backoff with decorrelated jitter.

Counterpart of yugabyte_tpu/utils/backoff.py, with the imports renamed.

Capability parity with the reference's retry waiters (ref:
src/yb/util/backoff_waiter.h BackoffWaiter; rpc/rpc.cc
RpcRetrier::DelayMillis adds jitter the same way): every retry loop in the
stack — client master lookup, tablet-call replica walks, the heartbeater's
master hunt, and the maintenance manager's background-error recovery —
draws its sleeps from here instead of hard-coding a fixed interval.

Two shapes:

- `Backoff`: an iterator of delays for one bounded retry *attempt*
  (deadline-aware; decorrelated jitter so a thundering herd of retriers
  de-synchronizes: delay_n = uniform(base, prev * 3), clamped to cap).
  A server-provided `retry_after_ms` hint (the overload-shedding
  response extra) floors the next delay — the server measured its own
  queue drain, so the client must not return before that.
- `RetrySchedule`: open-ended pacing for a long-lived background retrier
  (the maintenance manager's flush-recovery op): `ready()` gates the next
  attempt, `record_failure()` doubles the spacing up to a cap,
  `reset()` re-arms after success.
- `RetryBudget`: a per-client token bucket every retry loop draws from
  (ref: rpc/rpc.cc RpcRetrier + the reference's server-side call budget):
  first attempts are free, each RETRY spends one token, tokens refill at
  a bounded rate — so a saturated cluster's rejections can never make
  the client multiply its own offered load unboundedly (the retry-storm
  amplifier the overload-protection design exists to break).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional

from yugabyte_tpu_torch.utils import flags
from yugabyte_tpu_torch.utils.status import Code, Status, StatusError

flags.define_flag("client_retry_budget_tokens", 120,
                  "burst capacity of the per-client retry token bucket; "
                  "every retry (never a first attempt) spends one token")
flags.define_flag("client_retry_budget_refill_per_s", 30.0,
                  "sustained retry rate the per-client budget allows; "
                  "caps retry amplification under overload at roughly "
                  "this many extra attempts per second per client")

__all__ = ["Backoff", "RetrySchedule", "RetryBudget",
           "RetryBudgetExhausted"]


class Backoff:
    """Decorrelated-jitter delay source for one retry loop.

    next_delay() never exceeds cap_s nor the remaining deadline;
    sleep() performs the wait and returns False once the deadline is
    exhausted (callers break their loop and surface the last error).
    """

    def __init__(self, base_s: float = 0.05, cap_s: float = 2.0,
                 deadline_s: Optional[float] = None, rng=None):
        self.base_s = base_s
        self.cap_s = cap_s
        self._prev = base_s
        self._deadline = (None if deadline_s is None
                          else time.monotonic() + deadline_s)
        self._rng = rng if rng is not None else random
        self.attempts = 0
        self._hint_s = 0.0  # pending server retry_after floor

    @property
    def expired(self) -> bool:
        return (self._deadline is not None
                and time.monotonic() >= self._deadline)

    def note_server_hint(self, retry_after_ms) -> None:
        """Record a server-sent `retry_after_ms` overload hint: the NEXT
        delay will be at least this long (the server measured its own
        queue drain; coming back sooner is a wasted, load-amplifying
        attempt). Consumed by one next_delay(); the hint may exceed
        cap_s — the server's measurement wins — but never the
        deadline."""
        if retry_after_ms:
            self._hint_s = max(self._hint_s, float(retry_after_ms) / 1e3)

    def remaining_s(self) -> Optional[float]:
        """Seconds left until the deadline; None when unbounded. Callers
        clamp per-attempt RPC timeouts to this so one slow attempt
        cannot blow the whole op budget."""
        if self._deadline is None:
            return None
        return max(0.0, self._deadline - time.monotonic())

    def next_delay(self) -> float:
        """Draw the next delay (decorrelated jitter), floored by any
        pending server retry_after hint, deadline-clamped."""
        self.attempts += 1
        d = min(self.cap_s, self._rng.uniform(self.base_s, self._prev * 3))
        self._prev = d
        if self._hint_s:
            d = max(d, self._hint_s)
            self._hint_s = 0.0
        if self._deadline is not None:
            d = min(d, max(0.0, self._deadline - time.monotonic()))
        return d

    def sleep(self) -> bool:
        """Sleep for the next delay; False when the deadline is spent
        (no sleep happens in that case)."""
        if self.expired:
            return False
        time.sleep(self.next_delay())
        return not self.expired


class RetrySchedule:
    """Open-ended capped-exponential pacing for a background retrier.

    Unlike Backoff (one bounded loop), this survives across scheduler
    polls: the maintenance manager asks ready() each round, performs the
    recovery attempt when it fires, and records the outcome.

    deadline_s bounds the WHOLE schedule to an overall per-op budget:
    record_failure clamps each delay to the remaining budget (never
    scheduling an attempt past the deadline), and once the budget is
    spent `expired` turns True / ready() turns False — the owner must
    surface DeadlineExceeded instead of retrying forever."""

    def __init__(self, initial_s: float = 0.5, max_s: float = 30.0,
                 deadline_s: Optional[float] = None, rng=None):
        self.initial_s = initial_s
        self.max_s = max_s
        self._deadline = (None if deadline_s is None
                          else time.monotonic() + deadline_s)
        self._rng = rng if rng is not None else random
        self.failures = 0
        self._next_attempt = 0.0  # monotonic time; 0 = immediately ready

    @property
    def expired(self) -> bool:
        return (self._deadline is not None
                and time.monotonic() >= self._deadline)

    def remaining_s(self) -> Optional[float]:
        """Seconds left in the overall budget; None when unbounded."""
        if self._deadline is None:
            return None
        return max(0.0, self._deadline - time.monotonic())

    def ready(self) -> bool:
        if self.expired:
            return False  # budget spent: surface, don't retry
        return time.monotonic() >= self._next_attempt

    def record_failure(self) -> float:
        """Push the next attempt out by initial * 2^n (capped), with a
        +-25% jitter so many parked tablets don't retry in lockstep;
        clamped to the remaining per-op budget so the schedule never
        waits past its deadline. Returns the chosen delay."""
        delay = min(self.max_s, self.initial_s * (2 ** self.failures))
        delay *= self._rng.uniform(0.75, 1.25)
        rem = self.remaining_s()
        if rem is not None:
            delay = min(delay, rem)
        self.failures += 1
        self._next_attempt = time.monotonic() + delay
        return delay

    def reset(self) -> None:
        self.failures = 0
        self._next_attempt = 0.0


class RetryBudgetExhausted(StatusError):
    """The per-client retry budget ran dry: surfacing (typed, with the
    last underlying error in the message) instead of retrying is what
    keeps a saturated cluster's retries from amplifying its own
    collapse. Carries the same `overloaded` extra shape as server-side
    shedding so callers classify both identically."""

    def __init__(self, msg: str):
        super().__init__(Status(Code.BUSY, msg))
        self.extra = {"overloaded": True, "retry_budget_exhausted": True}


class RetryBudget:
    """Token bucket bounding a client's RETRY rate (first attempts are
    free). Thread-safe: one instance is shared by every retry loop of a
    client, so concurrent sessions draw from one budget.

    spend() refills by elapsed-time * refill rate (capped at the burst
    capacity), then takes one token; an empty bucket means the caller
    must surface its last error instead of retrying."""

    def __init__(self, capacity: Optional[int] = None,
                 refill_per_s: Optional[float] = None):
        self.capacity = float(capacity if capacity is not None
                              else flags.get_flag(
                                  "client_retry_budget_tokens"))
        self.refill_per_s = float(
            refill_per_s if refill_per_s is not None
            else flags.get_flag("client_retry_budget_refill_per_s"))
        self._tokens = self.capacity
        self._last_refill = time.monotonic()
        self._lock = threading.Lock()
        self.exhausted_total = 0  # budget denials (observability)
        self.spent_total = 0      # retries the budget admitted

    def _refill_locked(self, now: float) -> None:
        self._tokens = min(self.capacity, self._tokens
                           + (now - self._last_refill) * self.refill_per_s)
        self._last_refill = now

    def try_spend(self) -> bool:
        with self._lock:
            self._refill_locked(time.monotonic())
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self.spent_total += 1
                return True
            self.exhausted_total += 1
            return False

    def tokens(self) -> float:
        with self._lock:
            self._refill_locked(time.monotonic())
            return self._tokens

    def spend_or_raise(self, what: str, last_err=None) -> None:
        """Charge one retry; raises the typed RetryBudgetExhausted —
        carrying the last underlying error — when the bucket is dry."""
        if not self.try_spend():
            raise RetryBudgetExhausted(
                f"{what}: client retry budget exhausted "
                f"({self.capacity:.0f} tokens, "
                f"{self.refill_per_s}/s refill); last error: {last_err}")
