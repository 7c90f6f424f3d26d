"""Network nemesis: programmable per-(src, dst) fault rules.

Counterpart of yugabyte_tpu/rpc/nemesis.py, with the imports renamed: the
same rules and seed give the same verdicts in both packages.

The Jepsen-style fault fabric for the RPC and consensus layers: a
`NemesisRules` table holds link rules keyed by (src, dst) endpoint
names — symmetric and ONE-WAY partitions, probabilistic drops,
latency/reorder injection, duplicate delivery — and the two transports
consult it at their send points:

  - `Messenger.call` (rpc/messenger.py): every outbound RPC — client
    writes/reads, master heartbeats, raft AppendEntries/RequestVote over
    `RpcTransport` — checks the link (messenger name -> destination
    endpoint name) before the wire send.
  - `LocalTransport._check_link` (consensus/transport.py): the in-process
    raft fabric applies the same rule semantics, so RaftHarness tests and
    MiniCluster clusters express faults identically.

Faults fire at the CALLER, which covers both directions of a link with
one hook: a one-way partition src->dst blocks requests in that direction
only (the reverse link consults its own (dst, src) rule), and response
loss is modeled by `drop_response` — the request IS delivered and
executed, then the caller sees a timeout, exactly the ambiguity a real
lost response produces (the retryable-request dedup layer is what makes
that survivable).

Zero overhead when idle: the process-global table is None until a test
or a NemesisController installs one, and every hook starts with that
None check.

Time semantics: a dropped request surfaces as an immediate RpcTimeout
rather than sleeping out the caller's full timeout — the caller-visible
outcome (timeout, op fate unknown) is identical and chaos cycles stay
fast enough to run in CI.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Set, Tuple


class LinkBlocked(Exception):
    """Raised by check_link when the (src, dst) link is partitioned or the
    destination is down. Transports translate it to their own unreachable
    error (ServiceUnavailable / PeerUnreachable)."""


class LinkDropped(Exception):
    """Raised when a rule drops this request. The caller translates it to
    its timeout error (op fate unknown, like a real lost datagram)."""


@dataclass
class LinkRule:
    """Faults applied to messages src->dst. Endpoint names match exactly,
    by server prefix ("ts0" matches "ts0/tablet1"), or as the wildcard
    "*". All probabilities are independent per message."""
    src: str
    dst: str
    block: bool = False            # partition: nothing gets through
    drop_prob: float = 0.0         # request lost -> caller timeout
    drop_response_prob: float = 0.0  # delivered+executed, response lost
    latency_s: float = 0.0         # fixed delay before the send
    jitter_s: float = 0.0          # + uniform(0, jitter): reorders
    duplicate_prob: float = 0.0    # deliver the request twice


def _match(pattern: str, name: str) -> bool:
    if pattern == "*" or pattern == name:
        return True
    # server-level pattern matches every channel of that server
    # ("ts0" matches "ts0/t1"), mirroring LocalTransport's semantics
    return name.startswith(pattern + "/")


@dataclass
class LinkVerdict:
    """What check_link decided for one message (after raising for
    block/drop): the caller applies these on its send path."""
    duplicate: bool = False
    drop_response: bool = False


class NemesisRules:
    """Thread-safe fault-rule table. One per process while a chaos test
    runs (installed via `install()`); transports consult the singleton
    through `active()`."""

    def __init__(self, seed: int = 0):
        from yugabyte_tpu_torch.utils import lock_rank
        self._lock = lock_rank.tracked(threading.Lock(),
                                       "nemesis.rules_lock")
        self._rules: list = []                  # guarded-by: _lock
        self._down: Set[str] = set()            # guarded-by: _lock
        self._names: Dict[str, str] = {}        # guarded-by: _lock
        self._rng = random.Random(seed)         # guarded-by: _lock
        self._injected: Dict[str, int] = {}     # guarded-by: _lock

    # ------------------------------------------------------------- naming
    def register_endpoint(self, addr: str, name: str) -> None:
        """Bind a wire address ('host:port') to a nemesis endpoint name
        ('ts0', 'm0') so messenger-level rules can be written in terms of
        server ids."""
        with self._lock:
            self._names[addr] = name

    def name_of(self, addr_or_name: str) -> str:
        with self._lock:
            return self._names.get(addr_or_name, addr_or_name)

    # -------------------------------------------------------------- rules
    def add_rule(self, rule: LinkRule) -> LinkRule:
        with self._lock:
            self._rules.append(rule)
        return rule

    def partition(self, a: str, b: str, one_way: bool = False) -> None:
        """Cut the a->b link; symmetric (both directions) unless one_way."""
        self.add_rule(LinkRule(a, b, block=True))
        if not one_way:
            self.add_rule(LinkRule(b, a, block=True))

    def isolate(self, name: str) -> None:
        """Cut `name` off from everyone (crash-failure emulation)."""
        with self._lock:
            self._down.add(name)

    def drop(self, src: str, dst: str, prob: float,
             response: bool = False) -> None:
        self.add_rule(LinkRule(src, dst,
                               drop_response_prob=prob if response else 0.0,
                               drop_prob=0.0 if response else prob))

    def latency(self, src: str, dst: str, delay_s: float,
                jitter_s: float = 0.0) -> None:
        self.add_rule(LinkRule(src, dst, latency_s=delay_s,
                               jitter_s=jitter_s))

    def duplicate(self, src: str, dst: str, prob: float) -> None:
        self.add_rule(LinkRule(src, dst, duplicate_prob=prob))

    def heal(self) -> None:
        """Remove every rule and isolation (the end of a fault window)."""
        with self._lock:
            self._rules.clear()
            self._down.clear()

    def remove_rule(self, rule: LinkRule) -> None:
        with self._lock:
            try:
                self._rules.remove(rule)
            except ValueError:  # yblint: contained(rule already removed by heal() — removal is idempotent)
                pass

    # ---------------------------------------------------------- inspection
    def injected_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._injected)

    def _count(self, kind: str) -> None:  # guarded-by: _lock
        self._injected[kind] = self._injected.get(kind, 0) + 1
        _nemesis_counter(kind).increment()

    # ------------------------------------------------------------ the hook
    def check_link(self, src: str, dst: str) -> LinkVerdict:
        """Consulted by a transport immediately before sending src->dst.

        Raises LinkBlocked (partition / peer down) or LinkDropped
        (probabilistic request loss); may SLEEP for latency/reorder
        rules; returns a verdict carrying the duplicate / drop-response
        decisions the caller must apply around its send."""
        delay = 0.0
        verdict = LinkVerdict()
        with self._lock:
            src = self._names.get(src, src)
            dst = self._names.get(dst, dst)
            src_srv = src.split("/", 1)[0]
            dst_srv = dst.split("/", 1)[0]
            if src_srv in self._down or dst_srv in self._down \
                    or src in self._down or dst in self._down:
                self._count("blocked")
                raise LinkBlocked(f"{src}->{dst}: peer down (nemesis)")
            for r in self._rules:
                if not (_match(r.src, src) or _match(r.src, src_srv)):
                    continue
                if not (_match(r.dst, dst) or _match(r.dst, dst_srv)):
                    continue
                if r.block:
                    self._count("blocked")
                    raise LinkBlocked(f"{src}->{dst}: partitioned (nemesis)")
                if r.drop_prob and self._rng.random() < r.drop_prob:
                    self._count("dropped")
                    raise LinkDropped(f"{src}->{dst}: dropped (nemesis)")
                if r.drop_response_prob and \
                        self._rng.random() < r.drop_response_prob:
                    self._count("response_dropped")
                    verdict.drop_response = True
                if r.duplicate_prob and \
                        self._rng.random() < r.duplicate_prob:
                    self._count("duplicated")
                    verdict.duplicate = True
                if r.latency_s or r.jitter_s:
                    self._count("delayed")
                    delay += r.latency_s + (self._rng.random() * r.jitter_s
                                            if r.jitter_s else 0.0)
        if delay:
            time.sleep(delay)  # outside the lock: never stall other links
        return verdict


def _nemesis_counter(kind: str):
    from yugabyte_tpu_torch.utils.metrics import ROOT_REGISTRY
    return ROOT_REGISTRY.entity("server", "nemesis").counter(
        f"nemesis_faults_{kind}_total",
        f"nemesis-injected {kind} network faults")


# Process-global installation (one chaos run at a time; tests install in
# a fixture and uninstall in teardown).
_active: Optional[NemesisRules] = None  # guarded-by: _active_lock
_active_lock = threading.Lock()


def install(rules: Optional[NemesisRules] = None,
            seed: int = 0) -> NemesisRules:
    """Install (and return) the process-global rule table. Idempotent:
    installing over an existing table replaces it."""
    global _active
    rules = rules if rules is not None else NemesisRules(seed=seed)
    with _active_lock:
        _active = rules
    return rules


def uninstall() -> None:
    global _active
    with _active_lock:
        _active = None


def active() -> Optional[NemesisRules]:
    # benign racy read: installation happens before the chaos window
    # opens and the reference is either None or a complete table
    return _active  # yblint: disable=lock-discipline
