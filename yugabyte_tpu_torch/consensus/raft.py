"""Raft consensus: the exceptions the tablet layer raises.

Counterpart of yugabyte_tpu/consensus/raft.py (:103-106), holding only
what tablet/tablet.py raises and catches today. The rest of raft
(RaftConsensus, leader leases, the transport, the multi-raft batcher)
comes with the consensus part of ROADMAP queue A item 7, together with
tablet_peer.
"""

from __future__ import annotations


class OperationOutcomeUnknown(Exception):
    """Surfaced to clients when a write timed out without a known fate
    (the reference returns a timeout status for the same situation)."""
