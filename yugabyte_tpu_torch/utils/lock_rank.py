"""Runtime lock-order tracker: acquisition edges + cycle detection.

A static pass can prove accesses happen under the right lock; it cannot
prove locks are acquired in a consistent ORDER. This module records the
actual acquisition graph at runtime and reports a cycle — the classic
deadlock precondition (ref: the reference's yb::RWC lock-rank debugging
and absl's deadlock detector).

Usage — wrap a lock at construction:

    self._lock = lock_rank.tracked(threading.RLock(), "db._lock")

`tracked()` is a pass-through until `enable()`: the port's tests of the
DB and the compaction pool enable it and call `assert_no_cycles()` after
each test. When enabled, each acquire records edges
(every-currently-held-lock -> acquired-lock) into a process-global graph;
a NEW edge triggers a cycle check whose result is latched (raising
inside a pool thread would vanish).

All tracked locks sharing one `name` are one graph node: per-instance
locks of one class/field (every DB's `_lock`) collapse to their rank,
which is the granularity deadlock ordering is defined over.

The port's copy of yugabyte_tpu/utils/lock_rank.py, without the JAX
package's environment switch, sanitizer hooks and race latch: the port's
DB, thread pool and compaction pool take their locks through `tracked`.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set

_enabled = False
_edges_lock = threading.Lock()
_edges: Dict[str, Set[str]] = {}          # name -> set of names acquired
                                          # while `name` was held
_violations: List[str] = []
_held = threading.local()


def enable(on: bool = True) -> None:
    """Track the locks that `tracked` wraps from now on."""
    global _enabled
    _enabled = on


def tracked(lock, name: str):
    """Wrap `lock` for order tracking; passthrough when tracking is off."""
    if not _enabled:
        return lock
    return TrackedLock(lock, name)


class TrackedLock:
    """Duck-types threading.Lock (acquire/release/context manager), so it
    also works as the inner lock of a threading.Condition. Non-blocking
    probe acquires (Condition._is_owned's `acquire(False)`) that fail do
    not record edges or held state."""

    __slots__ = ("_lock", "name")

    def __init__(self, lock, name: str):
        self._lock = lock
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            _record_acquire(self.name)
        return got

    def release(self) -> None:
        _record_release(self.name)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def _held_stack() -> List[str]:
    stack = getattr(_held, "stack", None)
    if stack is None:
        stack = _held.stack = []
    return stack


def _record_acquire(name: str) -> None:
    stack = _held_stack()
    for holder in stack:
        if holder == name:
            continue
        with _edges_lock:
            known = _edges.setdefault(holder, set())
            if name in known:
                continue
            known.add(name)
            cycle = _find_cycle_unlocked()
            if cycle is not None:
                _violations.append(
                    "[lock-rank/lock-order-cycle] " + " -> ".join(cycle)
                    + f"; closing edge {holder} -> {name} on thread "
                    + threading.current_thread().name)
    stack.append(name)


def _record_release(name: str) -> None:
    stack = _held_stack()
    # release order may not be LIFO (rare but legal): drop the last
    # matching entry
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] == name:
            del stack[i]
            return


def _find_cycle_unlocked() -> Optional[List[str]]:
    """DFS over the edge graph; returns one cycle as a node list (first
    node repeated at the end) or None. Caller holds _edges_lock."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict[str, int] = {}
    parent: Dict[str, str] = {}

    def dfs(u: str) -> Optional[List[str]]:
        color[u] = GRAY
        for v in sorted(_edges.get(u, ())):
            c = color.get(v, WHITE)
            if c == GRAY:
                path = [v, u]
                cur = u
                while cur != v:
                    cur = parent[cur]
                    path.append(cur)
                path.reverse()
                return path
            if c == WHITE:
                parent[v] = u
                found = dfs(v)
                if found is not None:
                    return found
        color[u] = BLACK
        return None

    for node in sorted(_edges):
        if color.get(node, WHITE) == WHITE:
            found = dfs(node)
            if found is not None:
                return found
    return None


def edges() -> Dict[str, Set[str]]:
    with _edges_lock:
        return {k: set(v) for k, v in _edges.items()}


def assert_no_cycles() -> None:
    """Fail (AssertionError) if any acquisition-order cycle was observed
    in this process."""
    with _edges_lock:
        problems = list(_violations)
    assert not problems, "\n".join(problems)
