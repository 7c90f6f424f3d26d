"""The port's MultiRaftBatcher and RPC compression against the JAX
package's, on the CPU.

Twins of tests/test_multi_raft_and_compression.py's TestBatcherUnit (3)
and TestCompression (2). The batcher cases run on each package's
batcher and compare what is deterministic: every submit's answer, the
items the send function saw (the split into RPCs depends on the batch
window's timing, as in the reference, and only its bounds are checked),
the per-item failure and the fan-out. The compression cases call across
the wire between a port and a JAX Messenger in both directions, and
between two port ones: compressed frames, frames below the threshold and
incompressible ones (sent raw), with compression on and off.

What waits: test_heartbeat_messages_scale_with_peers_not_tablets needs
the port's MiniCluster (ROADMAP queue A item 7g). Every wait has its own
deadline. Tolerance: exact.
"""

import importlib
import os
import threading

import jax  # noqa: F401 (the conftest pins JAX to the CPU)
import pytest

PKGS = ("yugabyte_tpu", "yugabyte_tpu_torch")


def mod(root, name):
    return importlib.import_module(f"{root}.{name}")


class TestBatcherUnit:
    def test_batches_within_window(self):
        got = {}
        for root in PKGS:
            sent = []

            def send(addr, items, sent=sent):
                sent.append((addr, list(items)))
                return [{"ok": i} for i in range(len(items))]

            b = mod(root, "consensus.multi_raft_batcher").MultiRaftBatcher(
                send)
            out = {}

            def go(i, b=b, out=out):
                out[i] = b.submit("a:1", f"s/{i}", {"n": i})
            ts = [threading.Thread(target=go, args=(i,)) for i in range(8)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=10)
            b.stop()
            assert 1 <= len(sent) <= 3, [len(s[1]) for s in sent]
            # each answer is its position in its batch; the items seen
            got[root] = (sorted(out), sorted(
                (addr, dst, req["n"]) for addr, items in sent
                for dst, req in items))
        assert got[PKGS[0]] == got[PKGS[1]]
        assert got[PKGS[1]][1] == [("a:1", f"s/{i}", i) for i in range(8)]

    def test_per_item_failure_isolated(self):
        got = {}
        for root in PKGS:
            unreachable = mod(root, "consensus.transport").PeerUnreachable

            def send(addr, items):
                return [{"err": "gone"} if d == "s/bad" else {"ok": 1}
                        for d, _r in items]

            b = mod(root, "consensus.multi_raft_batcher").MultiRaftBatcher(
                send)
            errs, oks = [], []

            def good(b=b, oks=oks):
                oks.append(b.submit("a:1", "s/good", {}))

            def bad(b=b, errs=errs, unreachable=unreachable):
                try:
                    b.submit("a:1", "s/bad", {})
                except unreachable as e:
                    errs.append(type(e).__name__)
            t1 = threading.Thread(target=good)
            t2 = threading.Thread(target=bad)
            t1.start()
            t2.start()
            t1.join(timeout=10)
            t2.join(timeout=10)
            b.stop()
            got[root] = (oks, errs)
        assert got[PKGS[0]] == got[PKGS[1]] == ([{"ok": 1}],
                                                ["PeerUnreachable"])

    def test_batch_send_failure_fans_out(self):
        for root in PKGS:
            unreachable = mod(root, "consensus.transport").PeerUnreachable

            def send(addr, items, unreachable=unreachable):
                raise unreachable("down")
            b = mod(root, "consensus.multi_raft_batcher").MultiRaftBatcher(
                send)
            with pytest.raises(unreachable):
                b.submit("a:1", "s/x", {})
            b.stop()


# (server package, client package)
COMBOS = [("yugabyte_tpu_torch", "yugabyte_tpu_torch"),
          ("yugabyte_tpu_torch", "yugabyte_tpu"),
          ("yugabyte_tpu", "yugabyte_tpu_torch")]
IDS = ["port-port", "port-ref", "ref-port"]


class TestCompression:
    @pytest.mark.parametrize("combo", COMBOS, ids=IDS)
    def test_large_frames_roundtrip_compressed(self, combo):
        m1 = mod(combo[0], "rpc.messenger").Messenger("srv")

        class Echo:
            def echo(self, blob: bytes) -> dict:
                return {"blob": blob, "n": len(blob)}
        m1.register_service("echo", Echo())
        m2 = mod(combo[1], "rpc.messenger").Messenger("cli")
        try:
            blob = b"the quick brown fox " * 8192   # ~160KB, compressible
            resp = m2.call(m1.address, "echo", "echo", blob=blob)
            assert resp["blob"] == blob and resp["n"] == len(blob)
            small = b"x" * 100
            assert m2.call(m1.address, "echo", "echo",
                           blob=small)["blob"] == small
            rnd = os.urandom(200_000)
            assert m2.call(m1.address, "echo", "echo",
                           blob=rnd)["blob"] == rnd
        finally:
            m2.shutdown()
            m1.shutdown()

    @pytest.mark.parametrize("combo", COMBOS, ids=IDS)
    def test_disabled_by_flag(self, combo):
        flag_mods = [mod(root, "utils.flags") for root in PKGS]
        for f in flag_mods:
            f.set_flag("rpc_compression_min_bytes", 0)
        try:
            m1 = mod(combo[0], "rpc.messenger").Messenger("srv2")

            class Echo:
                def echo(self, blob: bytes) -> dict:
                    return {"blob": blob}
            m1.register_service("echo", Echo())
            m2 = mod(combo[1], "rpc.messenger").Messenger("cli2")
            try:
                blob = b"z" * 100_000
                assert m2.call(m1.address, "echo", "echo",
                               blob=blob)["blob"] == blob
            finally:
                m2.shutdown()
                m1.shutdown()
        finally:
            for f in flag_mods:
                f.set_flag("rpc_compression_min_bytes", 32 << 10)
