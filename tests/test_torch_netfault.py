"""`NetFault.from_env` of the port's bus against the reference's, on the
same spec strings: unset and empty give no fault, a full spec parses to
the same fields and the same fault schedule for its seed, an unknown key
raises in both; and a ReplicaServer built under the variable carries
it."""

from types import SimpleNamespace

import pytest

from tigerbeetle_tpu.net.bus import NetFault as RefNetFault
from tigerbeetle_tpu_torch.net.bus import NetFault, ReplicaServer

VAR = "TIGERBEETLE_TPU_NET_FAULT"
FIELDS = ("drop", "dup", "corrupt", "delay_s", "delay_to", "blackhole")


@pytest.mark.parametrize("spec", [None, "", "   "])
def test_unset_or_empty_is_none(spec, monkeypatch):
    if spec is None:
        monkeypatch.delenv(VAR, raising=False)
    else:
        monkeypatch.setenv(VAR, spec)
    assert NetFault.from_env() is None
    assert RefNetFault.from_env() is None


@pytest.mark.parametrize("spec", [
    "drop=0.1",
    "drop=0.02,dup=0.01,corrupt=0.005,delay_ms=2,blackhole=1|2,seed=7",
    "delay_ms=40,delay_to=0,seed=7",
    " delay_ms=2.5 , delay_to=1|2 ,",
])
def test_full_spec_parses_as_the_reference(spec, monkeypatch):
    monkeypatch.setenv(VAR, spec)
    got, want = NetFault.from_env(), RefNetFault.from_env()
    assert got is not None and want is not None
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    # The same seed gives the same fault schedule.
    assert [got.rng.random() for _ in range(32)] == [want.rng.random() for _ in range(32)]


def test_unknown_key_raises_in_both(monkeypatch):
    monkeypatch.setenv(VAR, "dorp=0.5")
    with pytest.raises(ValueError, match=VAR):
        NetFault.from_env()
    with pytest.raises(ValueError):
        RefNetFault.from_env()


def test_replica_server_takes_its_fault_from_the_environment(monkeypatch):
    replica = SimpleNamespace(replica=1)
    monkeypatch.delenv(VAR, raising=False)
    assert ReplicaServer(replica, [("127.0.0.1", 1)] * 3).net_fault is None
    monkeypatch.setenv(VAR, "delay_ms=30,delay_to=0,seed=7")
    nf = ReplicaServer(replica, [("127.0.0.1", 1)] * 3).net_fault
    assert nf is not None and nf.delay_s == 0.03 and nf.delay_to == frozenset((0,))
