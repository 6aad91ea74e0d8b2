"""The replica imports its serving path at open (vsr/replica.py
SERVING_MODULES, Replica._warm).

A module's first import compiles and runs it under the interpreter lock.
On the card, the first store jobs of each replica imported the query
index and the scans that way and held the replica's event loop for
10-20 ms, which is what made the cluster-plane separation check unsteady
(PERF.md section 7). Here a fresh interpreter opens replicas and drives
the profiler's stream on both query-index routes and one VOPR seed (every
operation kind, crashes, a view change); no module of the package may be
imported after the first replica opened, the harness's own modules
aside."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import json, sys
from tigerbeetle_tpu_torch.vsr import replica as rmod

snap = {}
open_ = rmod.Replica.open
init_ = rmod.Replica.__init__


def spy_open(self):
    open_(self)
    snap.setdefault("mods", set(sys.modules))


def device_route(self, *a, **kw):
    kw["device_query_index"] = ROUTE[0]
    init_(self, *a, **kw)


ROUTE = [None]
rmod.Replica.open = spy_open
rmod.Replica.__init__ = device_route
from tigerbeetle_tpu_torch import profile_e2e, simulator

for route in (None, True):
    ROUTE[0] = route
    profile_e2e.run(device="cpu", config="test_min", batches=20,
                    out=lambda s: None)
ROUTE[0] = None
assert simulator.run_seed(3, 300, False, device="cpu") == 0
harness = ("tigerbeetle_tpu_torch.testing", "tigerbeetle_tpu_torch.simulator",
           "tigerbeetle_tpu_torch.profile_e2e")
new = sorted(m for m in set(sys.modules) - snap["mods"]
             if m.startswith("tigerbeetle_tpu_torch") and not m.startswith(harness))
print(json.dumps(new))
"""


def test_serving_path_imports_nothing_after_open():
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True,
        text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_serving_modules_are_importable_and_listed_once():
    from tigerbeetle_tpu_torch.vsr.replica import SERVING_MODULES

    assert len(set(SERVING_MODULES)) == len(SERVING_MODULES)
    for name in SERVING_MODULES:
        __import__(name)
