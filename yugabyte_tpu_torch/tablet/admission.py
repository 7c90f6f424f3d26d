"""Write admission: one unified write-pressure state machine per tablet.

Counterpart of yugabyte_tpu/tablet/admission.py, with the imports renamed.

Capability parity with the reference's write throttling (ref:
tserver/tablet_service.cc:1510 the SST-file rejection score,
tserver/tserver.cc memstore soft-limit rejection via the MemTracker
tree, and the reference's "leader side backpressure" WAL gating), but
unified: where only the SST-file count once gated writes, the
memstore MemTracker and the WAL appender queue could grow without
bound under sustained overload.

Three measured signals feed one state machine, evaluated at every
write entry point (tablet.py write / write_transactional /
apply_external_batch):

- **sst**: live SST files between ``--sst_files_soft_limit`` and
  ``--sst_files_hard_limit`` (compactions need bandwidth to catch up);
- **memstore**: the server-wide memstore MemTracker
  (tserver/tablet_memory_manager.py binds it onto every hosted
  tablet) — pressure starts at the soft percentage
  (``--memory_limit_soft_percentage``) and rejects at
  ``--memstore_reject_fraction`` of the limit, BELOW 1.0 on purpose:
  admission sees consumption before the incoming batch lands, so the
  headroom between the reject fraction and the limit is what keeps
  in-flight admitted writes from pushing the tracker past its limit
  while flushes catch up;
- **wal**: the group-commit appender's queued-entry backlog
  (consensus/log.py backlog(); tablet_peer.py binds it) between
  ``--wal_backlog_soft_entries`` and ``--wal_backlog_hard_entries`` —
  appends arriving faster than fsync drains them.

States: HEALTHY admits immediately; SOFT delays each write
proportionally to the worst signal's score (up to
``--write_backpressure_max_delay_ms``); HARD rejects retryably with a
typed Overloaded error whose extras carry the throttling signal and a
score-scaled ``retry_after_ms`` hint the client backoff honors.
Snapshots surface as the per-tablet write_pressure arm of the /servez
overload block.
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Callable, List, Optional

from yugabyte_tpu_torch.utils import flags
from yugabyte_tpu_torch.utils.trace import TRACE

flags.define_flag("memstore_reject_fraction", 0.95,
                  "hard write rejection when the memstore MemTracker "
                  "reaches this fraction of its limit; kept under 1.0 "
                  "so in-flight admitted writes cannot push consumption "
                  "past the tracker limit")
flags.define_flag("wal_backlog_soft_entries", 512,
                  "writes start delaying when this many WAL entries are "
                  "queued behind the appender's fsync")
flags.define_flag("wal_backlog_hard_entries", 4096,
                  "writes are rejected (retryably) at this many queued "
                  "WAL entries")


class PressureState(enum.Enum):
    HEALTHY = "healthy"
    SOFT = "soft"
    HARD = "hard"


class _Signal:
    __slots__ = ("name", "hard", "score", "detail")

    def __init__(self, name: str, hard: bool, score: float, detail: str):
        self.name = name
        self.hard = hard
        self.score = score
        self.detail = detail


class WriteAdmission:
    """Per-tablet write-pressure evaluator. Construction binds the SST
    signal; the WAL and memstore signals are bound by the layers that
    own them (TabletPeer / TabletMemoryManager) — an unbound signal
    simply reads healthy, so a bare Tablet in a unit test behaves
    exactly like the old SST-only backpressure."""

    def __init__(self, tablet_id: str,
                 sst_files_fn: Callable[[], int],
                 rejection_counter=None):
        self.tablet_id = tablet_id
        self._sst_files_fn = sst_files_fn
        self._memstore_tracker = None
        self._wal_backlog_fn: Optional[Callable[[], int]] = None
        # the tablet's write_rejections_total counter (kept for metric
        # continuity with the pre-unification SST backpressure)
        self._rejection_counter = rejection_counter
        self._lock = threading.Lock()
        self._state = PressureState.HEALTHY  # guarded-by: _lock
        self._state_signal = ""              # guarded-by: _lock
        self.delays_total = 0                # guarded-by: _lock
        self.rejections_total = 0            # guarded-by: _lock
        self._rejections_by: dict = {}       # guarded-by: _lock

    # ------------------------------------------------------------- binding
    def bind_memstore(self, tracker) -> None:
        """TabletMemoryManager hands the server-wide memstore MemTracker
        to every hosted tablet (idempotent, re-applied each arbiter
        round so late-created tablets get bound too)."""
        self._memstore_tracker = tracker

    def bind_wal(self, backlog_fn: Callable[[], int]) -> None:
        self._wal_backlog_fn = backlog_fn

    # ------------------------------------------------------------- signals
    def signals(self) -> List[_Signal]:
        out = [self._sst_signal()]
        mem = self._memstore_signal()
        if mem is not None:
            out.append(mem)
        wal = self._wal_signal()
        if wal is not None:
            out.append(wal)
        return out

    def _sst_signal(self) -> _Signal:
        soft = flags.get_flag("sst_files_soft_limit")
        hard = flags.get_flag("sst_files_hard_limit")
        files = self._sst_files_fn()
        if files < soft:
            return _Signal("sst", False, 0.0, f"{files} live SST files")
        score = (files - soft + 1) / max(1, hard - soft)
        return _Signal("sst", files >= hard, score,
                       f"{files} live SST files (soft {soft} hard {hard})")

    def _memstore_signal(self) -> Optional[_Signal]:
        tracker = self._memstore_tracker
        if tracker is None or tracker.limit <= 0:
            return None
        pct = tracker.consumption() / tracker.limit
        soft_pct = flags.get_flag("memory_limit_soft_percentage") / 100.0
        reject_pct = flags.get_flag("memstore_reject_fraction")
        if pct < soft_pct:
            return _Signal("memstore", False, 0.0,
                           f"memstore at {pct:.0%} of tracker limit")
        score = (pct - soft_pct) / max(1e-9, reject_pct - soft_pct)
        return _Signal(
            "memstore", pct >= reject_pct, score,
            f"memstore at {pct:.0%} of tracker limit "
            f"(soft {soft_pct:.0%} reject {reject_pct:.0%})")

    def _wal_signal(self) -> Optional[_Signal]:
        fn = self._wal_backlog_fn
        if fn is None:
            return None
        soft = flags.get_flag("wal_backlog_soft_entries")
        hard = flags.get_flag("wal_backlog_hard_entries")
        backlog = fn()
        if backlog < soft:
            return _Signal("wal", False, 0.0,
                           f"{backlog} WAL entries awaiting fsync")
        score = (backlog - soft + 1) / max(1, hard - soft)
        return _Signal("wal", backlog >= hard, score,
                       f"{backlog} WAL entries awaiting fsync "
                       f"(soft {soft} hard {hard})")

    # ----------------------------------------------------------- admission
    def _worst(self) -> _Signal:
        worst = None
        for s in self.signals():
            if worst is None or (s.hard, s.score) > (worst.hard,
                                                     worst.score):
                worst = s
        return worst

    def _set_state(self, state: PressureState, signal_name: str) -> None:
        with self._lock:
            prev = self._state
            self._state = state
            self._state_signal = (signal_name
                                  if state is not PressureState.HEALTHY
                                  else "")
        if prev is not state:
            TRACE("tablet %s write pressure %s -> %s (%s)",
                  self.tablet_id, prev.value, state.value,
                  signal_name or "-")

    def admit(self) -> None:
        """Gate one write: no-op when healthy, proportional delay under
        soft pressure, typed retryable rejection under hard pressure.
        Raises Overloaded (Code.BUSY, retryable, throttle extras) —
        message keeps the historical 'retry later' phrasing."""
        worst = self._worst()
        if worst.hard:
            self._note_rejection(worst)
            from yugabyte_tpu_torch.rpc.messenger import Overloaded
            raise Overloaded(
                f"tablet {self.tablet_id} write-pressure hard limit "
                f"({worst.name}: {worst.detail}); retry later",
                retry_after_ms=self._retry_after_ms(worst),
                throttle=worst.name)
        if worst.score <= 0.0:
            self._set_state(PressureState.HEALTHY, "")
            return
        self._set_state(PressureState.SOFT, worst.name)
        with self._lock:
            self.delays_total += 1
        delay = min(1.0, worst.score) * flags.get_flag(
            "write_backpressure_max_delay_ms") / 1000.0
        if delay > 0:
            time.sleep(delay)

    def _note_rejection(self, worst: _Signal) -> None:
        self._set_state(PressureState.HARD, worst.name)
        with self._lock:
            self.rejections_total += 1
            self._rejections_by[worst.name] = \
                self._rejections_by.get(worst.name, 0) + 1
        if self._rejection_counter is not None:
            self._rejection_counter.increment()
        from yugabyte_tpu_torch.utils.metrics import serve_path_metrics
        m = serve_path_metrics()
        m.counter("write_throttle_rejections_total",
                  "writes rejected retryably by the write-pressure "
                  "state machine").increment()
        m.counter(f"write_throttle_{worst.name}_rejections_total",
                  f"writes rejected by {worst.name} pressure"
                  ).increment()

    @staticmethod
    def _retry_after_ms(worst: _Signal) -> int:
        """Score-scaled hint: deeper overshoot past the hard line means
        flushes/compactions need longer to relieve it. Derived from the
        measured score, clamped to [50ms, 2s]."""
        base = flags.get_flag("write_backpressure_max_delay_ms")
        return int(min(2000.0, max(50.0, base * (1.0 + worst.score))))

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> dict:
        sigs = self.signals()
        with self._lock:
            state, state_sig = self._state, self._state_signal
            delays, rejections = self.delays_total, self.rejections_total
            by = dict(self._rejections_by)
        return {
            "tablet_id": self.tablet_id,
            "state": state.value,
            "signal": state_sig,
            "signals": {s.name: {"hard": s.hard,
                                 "score": round(s.score, 3),
                                 "detail": s.detail} for s in sigs},
            "write_throttle_delays_total": delays,
            "write_throttle_rejections_total": rejections,
            "rejections_by_signal": by,
        }
