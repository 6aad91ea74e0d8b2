"""Real-process replica management for the front-door harnesses.

The two helpers of the reference package's chaos harness that the load
harness (testing/loadgen.py) and chip_smoke.py's front-door phase use:
`probe_free_port` and `_spawn_replica`, which starts `python -m
tigerbeetle_tpu_torch.cli start` and returns once the replica announces
its listener. The scenario runner itself (crashes, partitions, net
faults on real processes) is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence


def probe_free_port(base: int = 0, tries: int = 32) -> int:
    """Bind-probe for a free TCP port: with base=0 the OS assigns an
    ephemeral port; otherwise probe base, base+1, … and skip ports a
    lingering TIME_WAIT socket (killed previous run) still holds."""
    import socket

    if base:
        for p in range(base, base + tries):
            try:
                with socket.socket() as s:
                    s.bind(("127.0.0.1", p))
                return p
            except OSError:
                continue
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_replica(
    path: str, port: int, mport: int, config: str, device: str,
    extra_args: Sequence[str] = (),
    addresses: Optional[str] = None,
    replica: int = 0,
    log_path: Optional[str] = None,
) -> "object":
    """Start `cli.py start` detached on `device` ("cuda" or "cpu");
    returns the Popen once the replica announces its listener (after
    open(), i.e. after WAL replay — or at EOF, when the process died and
    the caller's connect will fail). A daemon thread drains stdout
    afterwards so a chatty replica can never block on a full pipe.
    `extra_args` rides extra `start` flags; `addresses`/`replica` spawn
    one member of a multi-replica cluster (default: a single replica on
    its own port); `log_path` keeps the child's stderr in a file (else it is discarded)."""
    import subprocess
    import sys
    import threading

    if addresses is None:
        addresses = f"127.0.0.1:{port}"
    stderr = open(log_path, "ab") if log_path else subprocess.DEVNULL
    try:
        proc = subprocess.Popen(
            [
                sys.executable, "-m", "tigerbeetle_tpu_torch.cli", "start",
                f"--addresses={addresses}", f"--replica={replica}",
                f"--config={config}", f"--device={device}",
                f"--metrics-port={mport}", *extra_args, path,
            ],
            stdout=subprocess.PIPE, stderr=stderr,
        )
    finally:
        if log_path:
            stderr.close()
    for _ in range(256):  # boot chatter (warnings, logging) before the announce
        line = proc.stdout.readline()
        if not line or b"listening" in line:
            break
    threading.Thread(target=proc.stdout.read, daemon=True).start()
    return proc
