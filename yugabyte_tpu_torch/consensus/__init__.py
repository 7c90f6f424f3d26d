"""Consensus layer: segmented WAL + Raft replication + leader leases.

Counterpart of yugabyte_tpu/consensus (ref: src/yb/consensus
RaftConsensus, Log, PeerMessageQueue, LeaderElection), with the imports
renamed. The WAL doubles as Raft storage exactly like the reference (ref:
consensus/log.h:104-113) — there is no separate RocksDB WAL; the Raft
index becomes the storage frontier. Device-free: a replicated tablet
reaches the card through the Tablet and DB each replica holds.
"""

from yugabyte_tpu_torch.consensus.log import Log, LogEntry, LogReader
from yugabyte_tpu_torch.consensus.raft import (
    NotLeader, OperationOutcomeUnknown, OpId, RaftConsensus, RaftConfig,
    ReplicationAborted, ReplicationTimedOut, Role)
from yugabyte_tpu_torch.consensus.transport import LocalTransport
