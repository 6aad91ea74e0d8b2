"""hash_log: pinpoint nondeterminism between two runs.

The analog of upstream src/testing/hash_log.zig:1-5 (build modes
-Dhash-log-mode=create|check): a run in `create` mode records every hashed
checkpoint of interest (commit checksums, state digests) to a file; a
second run in `check` mode asserts each value as it is produced, so the
FIRST divergent event is caught at its source instead of surfacing later
as a distant state-checker failure.
"""

from __future__ import annotations

import json
from typing import List, Optional


class HashLog:
    def __init__(self, path: str, mode: str) -> None:
        assert mode in ("create", "check")
        self.path = path
        self.mode = mode
        self._recorded: List[list] = []
        self._pos = 0
        if mode == "check":
            with open(path) as f:
                self._recorded = [json.loads(line) for line in f]

    def log(self, stream: str, value: int) -> None:
        """Record (create) or verify (check) the next hash of `stream`."""
        if self.mode == "create":
            self._recorded.append([stream, int(value)])
            return
        assert self._pos < len(self._recorded), (
            f"hash_log: run produced MORE events than recorded "
            f"(extra: {stream}={value:#x} at index {self._pos})"
        )
        want_stream, want_value = self._recorded[self._pos]
        assert stream == want_stream and int(value) == want_value, (
            f"hash_log: first divergence at index {self._pos}: "
            f"got {stream}={int(value):#x}, recorded {want_stream}={want_value:#x}"
        )
        self._pos += 1

    def close(self) -> None:
        if self.mode == "create":
            with open(self.path, "w") as f:
                for rec in self._recorded:
                    f.write(json.dumps(rec) + "\n")
        else:
            assert self._pos == len(self._recorded), (
                f"hash_log: run produced FEWER events than recorded "
                f"({self._pos} of {len(self._recorded)})"
            )


def attach_to_cluster(cluster, hash_log: Optional[HashLog]) -> None:
    """Feed every replica-0 commit checksum through the hash log (the
    cluster's commit_checksums chain is the determinism fingerprint)."""
    if hash_log is None:
        return
    r0 = cluster.replicas[0]
    orig = r0.on_event

    def hook(kind, replica):
        if kind == "commit" and replica.replica == 0:
            op = replica.last_committed_op
            hash_log.log("commit", replica.commit_checksums[op])
        orig(kind, replica)

    r0.on_event = hook
