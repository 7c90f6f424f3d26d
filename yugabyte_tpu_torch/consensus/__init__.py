"""Consensus layer: the segmented WAL (the rest of raft comes later).

Counterpart of yugabyte_tpu/consensus (ref: src/yb/consensus). The WAL
doubles as Raft storage exactly like the reference (ref:
consensus/log.h:104-113); the Raft index becomes the storage frontier.
raft.py holds only the exceptions the tablet layer raises until the
consensus part of ROADMAP queue A item 7 brings RaftConsensus.
"""

from yugabyte_tpu_torch.consensus.log import Log, LogEntry, LogReader
from yugabyte_tpu_torch.consensus.raft import OperationOutcomeUnknown
