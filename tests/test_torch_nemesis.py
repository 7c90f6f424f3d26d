"""The port's network nemesis against the JAX package's, on the CPU.

The same rules and seed give the same sequence of verdicts in both
packages: `NemesisRules.check_link` over a seeded stream of messages on
named links, under partitions (symmetric and one-way), an isolated
server, probabilistic request and response drops, duplicate delivery and
a small latency, with endpoint names bound to wire addresses; the
injected counts; `install` / `uninstall` / `active`; and LocalTransport,
which consults the same engine, dispatching the same stream to stub
peers. Tolerance: exact (every verdict, in order).
"""

import importlib

import jax  # noqa: F401 (the conftest pins JAX to the CPU)
import numpy as np
import pytest

PKGS = ("yugabyte_tpu", "yugabyte_tpu_torch")
ENDPOINTS = ("ts0", "ts1", "ts2", "m0", "ts0/t1", "ts1/t1", "ts2/t1",
             "127.0.0.1:7100", "127.0.0.1:7101")


def nemesis(root):
    return importlib.import_module(f"{root}.rpc.nemesis")


def rules_of(root, seed):
    """One rule table, built the same way in each package."""
    N = nemesis(root)
    r = N.NemesisRules(seed=seed)
    r.register_endpoint("127.0.0.1:7100", "ts0")
    r.register_endpoint("127.0.0.1:7101", "ts1")
    r.partition("ts0", "ts2", one_way=True)
    r.drop("ts1", "ts0", 0.3)
    r.drop("ts1", "*", 0.2, response=True)
    r.duplicate("*", "ts1/t1", 0.25)
    r.latency("m0", "ts2", 0.0001, jitter_s=0.0002)
    r.add_rule(N.LinkRule("ts2", "m0", drop_prob=0.1, duplicate_prob=0.5,
                          drop_response_prob=0.1))
    return N, r


def verdicts(root, seed, n, isolate_at=None, heal_at=None):
    """The verdict of each of n seeded messages: 'blocked', 'dropped' or
    (duplicate, drop_response); then the injected counts."""
    N, r = rules_of(root, seed)
    rng = np.random.default_rng(seed)
    picks = rng.integers(0, len(ENDPOINTS), size=(n, 2))
    out = []
    for i, (a, b) in enumerate(picks):
        if i == isolate_at:
            r.isolate("ts1")
        if i == heal_at:
            r.heal()
        try:
            v = r.check_link(ENDPOINTS[a], ENDPOINTS[b])
            out.append((v.duplicate, v.drop_response))
        except N.LinkBlocked:
            out.append("blocked")
        except N.LinkDropped:
            out.append("dropped")
    return out, r.injected_counts()


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_same_rules_and_seed_same_verdicts(seed):
    got = {root: verdicts(root, seed, 600, isolate_at=300, heal_at=500)
           for root in PKGS}
    assert got[PKGS[0]] == got[PKGS[1]]
    out, counts = got[PKGS[1]]
    kinds = set(x if isinstance(x, str) else "passed" for x in out)
    assert {"blocked", "dropped", "passed"} <= kinds
    assert counts["blocked"] and counts["dropped"] and counts["duplicated"]


def test_name_binding_and_heal():
    for root in PKGS:
        N, r = rules_of(root, 0)
        assert r.name_of("127.0.0.1:7100") == "ts0"
        with pytest.raises(N.LinkBlocked):
            r.check_link("127.0.0.1:7100", "ts2/t1")   # ts0 -> ts2 cut
        r.check_link("ts2", "ts0/t1")                  # one way only
        r.heal()
        r.check_link("127.0.0.1:7100", "ts2/t1")


def test_install_uninstall_active():
    for root in PKGS:
        N = nemesis(root)
        try:
            assert N.active() is None
            r = N.install(seed=3)
            assert N.active() is r
            r2 = N.install(N.NemesisRules(seed=4))
            assert N.active() is r2 and r2 is not r
        finally:
            N.uninstall()
        assert N.active() is None


class _Stub:
    """A consensus peer that records what reaches it."""

    def __init__(self):
        self.updates = 0
        self.votes = 0

    def handle_update(self, request):
        self.updates += 1
        return ("update", request)

    def handle_vote_request(self, request):
        self.votes += 1
        return ("vote", request)


def test_local_transport_same_deliveries():
    """LocalTransport over each package's engine: the same faults set on
    the same seed deliver, drop and duplicate the same messages."""
    got = {}
    for root in PKGS:
        T = importlib.import_module(f"{root}.consensus.transport")
        t = T.LocalTransport(seed=11)
        peers = {f"ts{i}/t1": _Stub() for i in range(3)}
        for name, p in peers.items():
            t.register(name, p)
        t.partition("ts0", "ts2", one_way=True)
        t.set_drop_probability(0.2)
        t.set_duplicate_probability("ts1", "ts0", 0.5)
        rng = np.random.default_rng(5)
        names = sorted(peers)
        out = []
        for i, (a, b, kind) in enumerate(rng.integers(0, 3, size=(400, 3))):
            if i == 200:
                t.set_drop_probability(0.0)
            call = t.update_consensus if kind else t.request_vote
            try:
                out.append(call(names[a], names[b], i)[0])
            except T.PeerUnreachable:
                out.append("unreachable")
        got[root] = (out, {n: (p.updates, p.votes)
                           for n, p in peers.items()},
                     t.rules.injected_counts())
    assert got[PKGS[0]] == got[PKGS[1]]
    assert "unreachable" in got[PKGS[1]][0]
