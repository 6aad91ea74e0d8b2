"""The port stands alone: it imports neither jax nor the reference package,
and its state machine never falls back to the CPU on its own."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=REPO, env=env,
    )


def test_port_imports_without_jax_or_reference():
    out = _run(
        "import sys\n"
        "sys.modules['jax'] = None\n"  # any `import jax` now raises
        "import tigerbeetle_tpu_torch\n"
        "import tigerbeetle_tpu_torch.models.state_machine\n"
        "import tigerbeetle_tpu_torch.ops.commit, tigerbeetle_tpu_torch.ops.commit_exact\n"
        "sys.path.insert(0, 'tests')\n"
        "import chip_smoke, exact_batches\n"
        "import tigerbeetle_tpu_torch.lsm.scan, tigerbeetle_tpu_torch.lsm.groove\n"
        "import tigerbeetle_tpu_torch.ops.qindex, tigerbeetle_tpu_torch.ops.merge\n"
        "import tigerbeetle_tpu_torch.ops.scanops, tigerbeetle_tpu_torch.lsm.tree\n"
        "import tigerbeetle_tpu_torch.parallel, tigerbeetle_tpu_torch.parallel.sharded_ops\n"
        "import tigerbeetle_tpu_torch.simulator, tigerbeetle_tpu_torch.fuzz\n"
        "import tigerbeetle_tpu_torch.testing.chaos, tigerbeetle_tpu_torch.tidy.protomodel\n"
        "import tigerbeetle_tpu_torch.tidy.findings\n"
        # A storm through the tree's device fold (the plain versions on the
        # CPU) loads the compaction path's modules too.
        "import numpy as np, torch\n"
        "from tigerbeetle_tpu_torch.io.grid import MemGrid\n"
        "from tigerbeetle_tpu_torch.lsm.store import pack_keys\n"
        "t = tigerbeetle_tpu_torch.lsm.tree.DurableIndex(\n"
        "    MemGrid(512, 4096), memtable_max=64, device=torch.device('cpu'))\n"
        "for i in range(4):\n"
        "    lo = np.arange(i * 64 + 1, i * 64 + 65, dtype=np.uint64)\n"
        "    t.insert_batch(pack_keys(lo, lo), np.arange(64, dtype=np.uint32))\n"
        "assert t.request_major() == 256\n"
        "while t.compact_step(100):\n"
        "    pass\n"
        "assert [len(lvl) for lvl in t.levels] == [0, 1]\n"
        "bad = [m for m in sys.modules if m == 'tigerbeetle_tpu'"
        " or m.startswith('tigerbeetle_tpu.')]\n"
        "print('reference modules:', bad)\n"
        "assert not bad\n"
    )
    assert out.returncode == 0, out.stderr + out.stdout


def test_tidy_modules_import_and_run_without_jax_or_reference():
    """Every module of the port's static-analysis gate imports with jax
    blocked, and its passes (the native layout pass imports the port's
    dtypes lazily) run without loading the reference package."""
    out = _run(
        "import sys, pathlib\n"
        "sys.modules['jax'] = None\n"
        "from tigerbeetle_tpu_torch import tidy\n"
        "from tigerbeetle_tpu_torch.tidy import (annotations, cparse, determinism,\n"
        "    findings, manifest, markers, nativecheck, ownership, protomodel,\n"
        "    runtime, synclint, vsrlint)\n"
        "import tigerbeetle_tpu_torch.tidy.__main__\n"
        "fs = tidy.run_passes(pathlib.Path('.'), ['native-layout', 'host-sync', 'quorum'])\n"
        "assert fs == [], fs\n"
        "bad = [m for m in sys.modules if m == 'tigerbeetle_tpu'"
        " or m.startswith('tigerbeetle_tpu.')]\n"
        "assert not bad, bad\n"
    )
    assert out.returncode == 0, out.stderr + out.stdout


def test_no_port_module_imports_the_reference_package():
    """No source of the port (nor chip_smoke.py, nor the port's tools)
    names the reference package in an import statement."""
    import re

    pat = re.compile(r"^\s*(from|import)\s+tigerbeetle_tpu(\.|\s|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    files += [os.path.join(REPO, "tools", n) for n in sorted(os.listdir(os.path.join(REPO, "tools")))
              if n.startswith("torch_") and n.endswith(".py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "tigerbeetle_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = []
    for f in files:
        with open(f) as fh:
            if pat.search(fh.read()):
                bad.append(os.path.relpath(f, REPO))
    assert len(files) > 20 and not bad, bad


def test_device_plane_tools_and_harnesses_run_without_jax_or_reference():
    """The port's readers of /device, /cluster and /trace
    (tools/torch_device_top.py, torch_cluster_top.py,
    torch_cluster_trace.py, torch_cluster_plane_runs.py) and the harness code (the overload and
    cluster-plane benches, the device plane) import with jax blocked,
    render a CPU machine's /device payload and merge a trace, and load no
    module of the reference package."""
    out = _run(
        "import sys, importlib.util\n"
        "sys.modules['jax'] = None\n"
        "from tigerbeetle_tpu_torch import devicestats, tracer\n"
        "from tigerbeetle_tpu_torch.testing import chaos, loadgen\n"
        "from tigerbeetle_tpu_torch.testing.chaos import run_cluster_plane_bench\n"
        "from tigerbeetle_tpu_torch.testing.loadgen import run_overload_bench\n"
        "from tigerbeetle_tpu_torch.net.bus import NetFault\n"
        "from tigerbeetle_tpu_torch.ops.merge import device_merge_pays\n"
        "tools = {}\n"
        "for name in ('torch_device_top', 'torch_cluster_top', 'torch_cluster_trace',\n"
        "             'torch_cluster_plane_runs'):\n"
        "    spec = importlib.util.spec_from_file_location(name, f'tools/{name}.py')\n"
        "    tools[name] = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(tools[name])\n"
        "import numpy as np\n"
        "from tigerbeetle_tpu_torch.constants import TEST_MIN\n"
        "from tigerbeetle_tpu_torch.models.state_machine import StateMachine\n"
        "from tigerbeetle_tpu_torch import types\n"
        "tracer.enable()\n"
        "sm = StateMachine(TEST_MIN, device='cpu')\n"
        "acc = np.zeros(4, dtype=types.ACCOUNT_DTYPE)\n"
        "acc['id_lo'] = np.arange(1, 5); acc['ledger'] = 1; acc['code'] = 1\n"
        "assert len(sm.create_accounts(acc)) == 0\n"
        "class R: state_machine = sm; commit_depth = 1\n"
        "st = devicestats.device_status(R())\n"
        "assert st['backend'] == 'cpu' and st['entries'], st\n"
        "assert 'register_accounts' in tools['torch_device_top'].render([st], [1])\n"
        "merged = tools['torch_cluster_trace'].merge_traces([tracer.export_trace()])\n"
        "assert merged['traceEvents']\n"
        "assert tools['torch_cluster_top'].render([None], [1])\n"
        "assert tools['torch_cluster_plane_runs'].largest_ack(tracer.export_trace(), 1) == {'acks': 0}\n"
        "bad = [m for m in sys.modules if m == 'tigerbeetle_tpu'"
        " or m.startswith('tigerbeetle_tpu.')]\n"
        "assert not bad, bad\n"
    )
    assert out.returncode == 0, out.stderr + out.stdout


def test_state_machine_without_device_raises_without_cuda():
    out = _run(
        "import torch\n"
        "from tigerbeetle_tpu_torch.constants import TEST_MIN\n"
        "from tigerbeetle_tpu_torch.models.state_machine import StateMachine\n"
        "assert not torch.cuda.is_available()\n"
        "try:\n"
        "    StateMachine(TEST_MIN)\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n"
        "StateMachine(TEST_MIN, device='cpu')\n"  # the explicit CPU run works
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("raised:")


def test_replica_slice_runs_without_jax_or_reference():
    """The replica, the cluster, the codec and the runtime checks import
    with jax blocked, and a one-replica cluster commits a few ops without
    loading any module of the reference package."""
    out = _run(
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import tigerbeetle_tpu_torch.vsr.replica, tigerbeetle_tpu_torch.testing.cluster\n"
        "import tigerbeetle_tpu_torch.net.codec, tigerbeetle_tpu_torch.tidy.runtime\n"
        "import numpy as np\n"
        "from tigerbeetle_tpu_torch import types\n"
        "from tigerbeetle_tpu_torch.testing.cluster import (\n"
        "    Cluster, account_batch, parse_results, transfer_batch)\n"
        "from tigerbeetle_tpu_torch.vsr.header import Operation\n"
        "cl = Cluster(replica_count=1, device='cpu')\n"
        "c = cl.clients[100]\n"
        "c.register()\n"
        "cl.run_until(lambda: c.registered)\n"
        "def do(op, body):\n"
        "    c.request(op, body)\n"
        "    cl.run_until(lambda: c.idle)\n"
        "    return c.replies[-1]\n"
        "assert len(parse_results(do(Operation.CREATE_ACCOUNTS, account_batch([1, 2])))) == 0\n"
        "r = do(Operation.CREATE_TRANSFERS, transfer_batch([dict(id=9, debit_account_id=1,\n"
        "    credit_account_id=2, amount=3, ledger=1, code=1)]))\n"
        "assert len(parse_results(r)) == 0\n"
        "ids = np.zeros(1, dtype=types.ID_DTYPE)\n"
        "ids['lo'] = [2]\n"
        "acc = np.frombuffer(bytearray(do(Operation.LOOKUP_ACCOUNTS, ids.tobytes()).body),\n"
        "    dtype=types.ACCOUNT_DTYPE)\n"
        "assert types.u128_of(acc[0], 'credits_posted') == 3\n"
        "assert cl.check_state_convergence() >= 3\n"
        "bad = [m for m in sys.modules if m == 'tigerbeetle_tpu'"
        " or m.startswith('tigerbeetle_tpu.')]\n"
        "print('reference modules:', bad)\n"
        "assert not bad\n"
    )
    assert out.returncode == 0, out.stderr + out.stdout


def test_cluster_and_replica_without_device_raise_without_cuda():
    """No fallback: a cluster or a replica asked for no device needs the
    card, and raises where there is none."""
    out = _run(
        "import torch\n"
        "from tigerbeetle_tpu_torch.constants import TEST_MIN\n"
        "from tigerbeetle_tpu_torch.io.storage import MemStorage, Zone\n"
        "from tigerbeetle_tpu_torch.testing.cluster import Cluster\n"
        "from tigerbeetle_tpu_torch.vsr.replica import Replica\n"
        "assert not torch.cuda.is_available()\n"
        "for make in (\n"
        "    lambda: Cluster(replica_count=1),\n"
        "    lambda: Replica(cluster=1, replica_index=0, replica_count=1,\n"
        "        storage=MemStorage(zone.total_size), zone=zone, config=TEST_MIN, bus=None),\n"
        "):\n"
        "    zone = Zone.for_config(TEST_MIN.journal_slot_count, TEST_MIN.message_size_max,\n"
        "        grid_block_count=TEST_MIN.grid_block_count,\n"
        "        grid_block_size=TEST_MIN.lsm_block_size)\n"
        "    try:\n"
        "        make()\n"
        "    except RuntimeError as e:\n"
        "        assert 'no CUDA device' in str(e), e\n"
        "        print('raised')\n"
        "    else:\n"
        "        raise SystemExit('no error without a device')\n"
    )
    assert out.returncode == 0, out.stderr + out.stdout
    assert out.stdout.split() == ["raised", "raised"]


def test_front_door_runs_without_jax_or_reference():
    """The bus, the clients, the CLI, the AOF, the load harness, the
    scrape surface and the environment profile import with jax blocked,
    and a one-replica server on the CPU answers the Python client over
    TCP without loading any module of the reference package."""
    out = _run(
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import tigerbeetle_tpu_torch.net.bus, tigerbeetle_tpu_torch.net.scrape\n"
        "import tigerbeetle_tpu_torch.client, tigerbeetle_tpu_torch.cli\n"
        "import tigerbeetle_tpu_torch.vsr.aof, tigerbeetle_tpu_torch.envprofile\n"
        "import tigerbeetle_tpu_torch.testing.loadgen, tigerbeetle_tpu_torch.testing.chaos\n"
        "import tigerbeetle_tpu_torch.vsr.peerstats\n"
        "import asyncio, threading, time\n"
        "from tigerbeetle_tpu_torch import envprofile, native, tracer, types\n"
        "from tigerbeetle_tpu_torch.client import Client\n"
        "from tigerbeetle_tpu_torch.constants import TEST_MIN as C\n"
        "from tigerbeetle_tpu_torch.io.storage import MemStorage, Zone\n"
        "from tigerbeetle_tpu_torch.net.bus import ReplicaServer\n"
        "from tigerbeetle_tpu_torch.testing.chaos import probe_free_port\n"
        "from tigerbeetle_tpu_torch.vsr.replica import Replica\n"
        "native.tb_client()\n"
        "assert envprofile.fingerprint()['accel_backend'] == 'none'\n"
        "zone = Zone.for_config(C.journal_slot_count, C.message_size_max,\n"
        "    grid_block_count=C.grid_block_count, grid_block_size=C.lsm_block_size)\n"
        "st = MemStorage(zone.total_size)\n"
        "Replica.format(st, zone, 0, 0, 1)\n"
        "r = Replica(cluster=0, replica_index=0, replica_count=1, storage=st, zone=zone,\n"
        "    config=C, bus=None, device='cpu')\n"
        "port = probe_free_port()\n"
        "server = ReplicaServer(r, [('127.0.0.1', port)])\n"
        "r.open()\n"
        "loop = asyncio.new_event_loop()\n"
        "t = threading.Thread(target=loop.run_until_complete, args=(server.serve_forever(),),\n"
        "    daemon=True)\n"
        "t.start()\n"
        "time.sleep(0.2)\n"
        "c = Client([('127.0.0.1', port)])\n"
        "assert len(c.create_accounts(types.batch([types.account(id=5, ledger=1, code=1)],\n"
        "    types.ACCOUNT_DTYPE))) == 0\n"
        "assert len(c.lookup_accounts([5])) == 1\n"
        "tracer.prometheus_text(), tracer.lifecycle_summary(), tracer.export_trace()\n"
        "loop.call_soon_threadsafe(server.stop)\n"
        "t.join(10)\n"
        "bad = [m for m in sys.modules if m == 'tigerbeetle_tpu'"
        " or m.startswith('tigerbeetle_tpu.')]\n"
        "print('reference modules:', bad)\n"
        "assert not bad\n"
    )
    assert out.returncode == 0, out.stderr + out.stdout


def test_profiler_and_absint_run_without_jax_or_reference():
    """The pipeline profiler (a small CPU run, its trace dumped) and the
    absint pass over every target load neither jax nor the reference
    package."""
    out = _run(
        "import sys, pathlib, tempfile, os\n"
        "sys.modules['jax'] = None\n"
        "from tigerbeetle_tpu_torch import profile_e2e\n"
        "from tigerbeetle_tpu_torch.tidy import absint\n"
        "d = tempfile.mkdtemp()\n"
        "rec = profile_e2e.run(device='cpu', config='test_min', batches=3,\n"
        "    trace_path=os.path.join(d, 't.json'), out=lambda s: None)\n"
        "assert rec['kernel_builds'] == 0 and os.path.exists(rec['trace'])\n"
        "assert absint.run(pathlib.Path('.')) == []\n"
        "bad = [m for m in sys.modules if m == 'tigerbeetle_tpu'"
        " or m.startswith('tigerbeetle_tpu.')]\n"
        "assert not bad, bad\n"
    )
    assert out.returncode == 0, out.stderr + out.stdout
