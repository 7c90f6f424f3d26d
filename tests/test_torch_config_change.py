"""The port's Raft membership changes against the JAX package's, on the CPU.

Twins of the 5 cases of tests/test_config_change.py: each scenario runs
once in each package (tests/test_torch_consensus.twin) after a forced
leader, its clocks on one StepTime (chip_smoke's), and the end states
are compared: each node's applied entries, WAL entries (term, index, op
type, payload) and cmeta.json (term, vote, the durable config). Where
the reference's case is timing-dependent (the first of two concurrent
changes may commit or time out), only the deterministic outcome is
compared. Every wait has its own deadline. Tolerance: exact.
"""

import threading
import time

import pytest

from tests.test_torch_consensus import (applied_entries, cmeta, fast_raft,
                                        step_time, twin, wait_for,
                                        wal_entries)

assert fast_raft  # the autouse fixture of the consensus twins, here too


class Group:
    """tests/test_config_change.py's `group` fixture in package P: a, b, c
    with a elected; d may join later."""

    def __init__(self, P, root):
        self.P, self.root = P, root
        self.time = step_time()
        self.transport = P.transport.LocalTransport()
        self.members = ["a/t", "b/t", "c/t"]
        self.applied = {p: [] for p in ["a/t", "b/t", "c/t", "d/t"]}
        self.nodes = {p: self.make_node(p, self.members)
                      for p in self.members}
        self.nodes["a/t"].start_election(ignore_lease=True)
        wait_for(self.nodes["a/t"].is_leader, msg="leader election")

    def make_node(self, peer, members):
        d = self.root / peer.replace("/", "_")
        d.mkdir(exist_ok=True)
        P = self.P
        node = P.raft.RaftConsensus(
            P.raft.RaftConfig(peer_id=peer, peer_ids=tuple(members)),
            P.log.Log(str(d / "wal")), self.transport,
            apply_cb=lambda m, p=peer: self.applied[p].append(m),
            meta_path=str(d / "meta.json"),
            clock=P.ht.HybridClock(self.time))
        self.transport.register(peer, node)
        node.start(election_timer=False)
        return node

    def replicate(self, node, payload, **kw):
        self.time.arm()
        return node.replicate(self.P.raft.OP_WRITE, self.time(), payload,
                              **kw)

    def quiesce(self, peers):
        leader = next(n for n in self.nodes.values() if n.is_leader())
        wait_for(lambda: all(
            self.nodes[p].last_op_id == leader.last_op_id
            and self.nodes[p].last_applied == leader.commit_index
            for p in peers), msg="the group to quiesce")

    def shutdown(self):
        for n in self.nodes.values():
            n.shutdown()
            n.log.close()

    def state(self, peers):
        out = {}
        for p in peers:
            d = self.root / p.replace("/", "_")
            out[p] = {"applied": applied_entries(self.applied[p]),
                      "wal": wal_entries(self.P, d / "wal"),
                      "cmeta": cmeta(d / "meta.json")}
        return out


def test_add_server(tmp_path):
    def run(P, root):
        g = Group(P, root)
        try:
            leader = g.nodes["a/t"]
            for i in range(5):
                g.replicate(leader, b"w%d" % i)
            g.nodes["d/t"] = g.make_node("d/t", ["a/t", "b/t", "c/t"])
            leader.change_config(add=["d/t"])
            config = sorted(leader.config.peer_ids)
            g.replicate(leader, b"after-add")
            wait_for(lambda: len(g.applied["d/t"]) == 6,
                     msg="new peer catch-up")
            with pytest.raises(P.raft.ConfigAlreadyApplied):
                leader.change_config(add=["d/t"])
            g.quiesce(["a/t", "b/t", "c/t", "d/t"])
            d_config = sorted(g.nodes["d/t"].config.peer_ids)
        finally:
            g.shutdown()
        return config, d_config, g.state(["a/t", "b/t", "c/t", "d/t"])
    config, d_config, state = twin(tmp_path, run)
    assert config == d_config == ["a/t", "b/t", "c/t", "d/t"]
    assert [e[3] for e in state["d/t"]["applied"]] == \
        [b"w0", b"w1", b"w2", b"w3", b"w4", b"after-add"]


def test_remove_server_and_majority(tmp_path):
    def run(P, root):
        g = Group(P, root)
        try:
            leader = g.nodes["a/t"]
            leader.change_config(remove=["c/t"])
            config = sorted(leader.config.peer_ids)
            g.transport.isolate("c/t")
            g.replicate(leader, b"post-remove", timeout_s=10)
            wait_for(lambda: len(g.applied["b/t"]) == 1, msg="b apply")
            g.quiesce(["a/t", "b/t"])
        finally:
            g.shutdown()
        return config, g.state(["a/t", "b/t"])
    config, _state = twin(tmp_path, run)
    assert config == ["a/t", "b/t"]


def test_leader_self_removal_steps_down(tmp_path):
    def run(P, root):
        g = Group(P, root)
        try:
            leader = g.nodes["a/t"]
            g.replicate(leader, b"w")
            leader.change_config(remove=["a/t"])
            wait_for(lambda: not leader.is_leader(), msg="leader step-down")
            g.nodes["b/t"].start_election(ignore_lease=True)
            wait_for(lambda: g.nodes["b/t"].is_leader()
                     or g.nodes["c/t"].is_leader(),
                     msg="new leader among remaining")
            name = "b/t" if g.nodes["b/t"].is_leader() else "c/t"
            new_leader = g.nodes[name]
            g.replicate(new_leader, b"after", timeout_s=10)
            config = sorted(new_leader.config.peer_ids)
            g.quiesce(["b/t", "c/t"])
        finally:
            g.shutdown()
        return name, config, g.state(["b/t", "c/t"])
    name, config, _state = twin(tmp_path, run)
    assert name == "b/t" and config == ["b/t", "c/t"]


def test_only_one_pending_change(tmp_path):
    """The first change is in flight while the second is refused with
    ConfigChangeInProgress; whether the first then commits or times out
    depends on timing, as in the reference, and is not compared."""
    def run(P, root):
        g = Group(P, root)
        try:
            leader = g.nodes["a/t"]
            g.transport.partition("a/t", "b/t")
            g.transport.partition("a/t", "c/t")
            outcome = {}

            def attempt_first_change():
                try:
                    leader.change_config(remove=["c/t"], timeout_s=2)
                    outcome["result"] = "committed"
                except Exception as e:  # noqa: BLE001 — either way is fine
                    outcome["result"] = f"raised {type(e).__name__}"

            t = threading.Thread(target=attempt_first_change, daemon=True)
            t.start()
            time.sleep(0.3)
            with pytest.raises(P.raft.ConfigChangeInProgress) as ei:
                leader.change_config(remove=["b/t"], timeout_s=1)
            g.transport.heal()
            t.join(timeout=10)
            return type(ei.value).__name__, "result" in outcome
        finally:
            g.shutdown()
    assert twin(tmp_path, run) == ("ConfigChangeInProgress", True)


def test_config_survives_restart(tmp_path):
    def run(P, root):
        g = Group(P, root)
        try:
            leader = g.nodes["a/t"]
            g.nodes["d/t"] = g.make_node("d/t", ["a/t", "b/t", "c/t"])
            leader.change_config(add=["d/t"])
            g.replicate(leader, b"x")
            wait_for(lambda: len(g.applied["d/t"]) == 1, msg="d caught up")
            g.quiesce(["a/t", "b/t", "c/t", "d/t"])
            g.nodes["d/t"].shutdown()
            g.transport.heal()
            g.applied["d/t"] = []
            g.nodes["d/t"] = g.make_node("d/t", ["a/t", "b/t", "c/t"])
            config = sorted(g.nodes["d/t"].config.peer_ids)
            g.quiesce(["a/t", "b/t", "c/t", "d/t"])
        finally:
            g.shutdown()
        return config, g.state(["a/t", "b/t", "c/t", "d/t"])
    config, _state = twin(tmp_path, run)
    assert config == ["a/t", "b/t", "c/t", "d/t"]
