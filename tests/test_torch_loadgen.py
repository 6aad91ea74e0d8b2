"""The port's open-loop load harness (testing/loadgen.py).

Its batch and query factories make the reference's bytes for a seed, and
a short open-loop run against a real `cli start --device=cpu` process
(spawned through the port's `spawn_front_door`) at TEST_MIN, writes and
queries on the same sessions through a disconnect storm and an identity
rotation, passes its durability and liveness audit, and every sampled
concurrent query reply equals its serial re-issue byte for byte.
"""

import asyncio
import tempfile

import numpy as np
import pytest

from frontdoor_servers import PORT, REFERENCE, mod


@pytest.mark.parametrize("zipf_s", [0.0, 1.1])
def test_factories_match_reference(zipf_s):
    ref = mod(REFERENCE, "testing.loadgen")._BatchFactory(500, 64, zipf_s, seed=0x77, first_id=9)
    port = mod(PORT, "testing.loadgen")._BatchFactory(500, 64, zipf_s, seed=0x77, first_id=9)
    for _ in range(5):
        assert port.make() == ref.make()
        assert port.make_query(limit=32) == ref.make_query(limit=32)
    vals = sorted(np.random.default_rng(1).random(37).tolist())
    for q in (0.0, 0.5, 0.99, 1.0):
        assert (mod(PORT, "testing.loadgen").percentile(vals, q)
                == mod(REFERENCE, "testing.loadgen").percentile(vals, q))


def test_open_loop_run_passes_its_audit():
    loadgen = mod(PORT, "testing.loadgen")
    types = mod(PORT, "types")
    with tempfile.TemporaryDirectory(prefix="tbtorch-loadgen-") as tmp:
        proc, port, mport, _path = loadgen.spawn_front_door(
            tmp, config="test_min", device="cpu", clients_max=128,
        )
        try:
            assert proc.poll() is None, "the replica exited at boot"
            addrs = [("127.0.0.1", port)]
            # TEST_MIN takes 64 events a request (create_accounts sends
            # 8190): the accounts go in 50 at a time.
            client = mod(PORT, "client").Client(addrs)
            for first in range(1, 201, 50):
                ev = np.zeros(50, dtype=types.ACCOUNT_DTYPE)
                ev["id_lo"] = np.arange(first, first + 50, dtype=np.uint64)
                ev["ledger"], ev["code"] = 1, 10
                assert len(client.create_accounts(ev)) == 0
            client.close()
            lg = loadgen.LoadGen(
                addrs, sessions=24, accounts=200, batch=32,
                offered_rate=1000.0, duration_s=1.5, ramp_s=0.4,
                slow_readers=1, seed=0x51, read_fraction=0.25, query_limit=32,
                churn=((0.7, "disconnect", 0.2), (1.0, "rotate", 0.1)),
            )
            res = asyncio.run(lg.run())
            assert res["sessions_failed"] == 0, res
            assert res["accepted_tx"] > 0 and res["perceived_p50_ms"] > 0, res
            assert res["reconnects"] > 0, res  # the disconnect storm happened
            assert res["queries_ok"] > 0, res
            aud = loadgen.audit(addrs, lg.stats.acked_sample, mport)
            assert aud["ok"] == 1 and aud["acked_checked"] > 0, aud
            qaud = loadgen.audit_queries(addrs, lg.stats.query_sample)
            assert qaud["ok"] == 1 and qaud["queries_checked"] > 0, qaud
        finally:
            proc.kill()
            proc.wait()
