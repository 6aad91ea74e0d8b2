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
        "bad = [m for m in sys.modules if m == 'tigerbeetle_tpu'"
        " or m.startswith('tigerbeetle_tpu.')]\n"
        "print('reference modules:', bad)\n"
        "assert not bad\n"
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
