"""Tablet layer: Tablet, MvccManager, the WriteQuery pipeline.

Counterpart of yugabyte_tpu/tablet (ref: tablet/tablet.h:124,
tablet/write_query.cc, tablet/mvcc.h). One Tablet = one shard, holding TWO
LSM instances — regular and intents (ref: tablet/tablet.h:856-857) — plus
the MVCC safe-time machinery that makes snapshot reads consistent.
tablet_peer.TabletPeer is the raft-replicated tablet: a Tablet (on the
card by default), a RaftConsensus and its WAL.
"""
