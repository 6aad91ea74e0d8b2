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


def test_no_port_module_imports_the_reference_package():
    """No source of the port (nor chip_smoke.py) names the reference
    package in an import statement."""
    import re

    pat = re.compile(r"^\s*(from|import)\s+tigerbeetle_tpu(\.|\s|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "tigerbeetle_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = []
    for f in files:
        with open(f) as fh:
            if pat.search(fh.read()):
                bad.append(os.path.relpath(f, REPO))
    assert len(files) > 20 and not bad, bad


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
