"""The port's static-analysis gate: every tidy pass, one report, one
baseline (tidy/baseline.json, empty).

    python -m tigerbeetle_tpu_torch.tidy            # report; exit 1 on findings
    python -m tigerbeetle_tpu_torch.tidy --json     # the report as JSON
    python -m tigerbeetle_tpu_torch.tidy --passes host-sync native

Exit 0 only when no finding is outside the baseline and the baseline has
no stale key. The report has the reference package's tools/check.py
schema: root, passes, findings, new, suppressed, stale_baseline_keys,
ok, timings, parallel, devhub, codec. `codec` is the native codec's
golden-vector probe (net/codec.golden_check), which fails the gate when
the built codec disagrees with the Python encoding; `devhub` is not run
(the port keeps no perf series of its own).
"""

from __future__ import annotations

import argparse
import json
import sys

from tigerbeetle_tpu_torch import tidy


def check_codec() -> dict:
    """The native codec's build probe and golden vectors: a host that
    cannot build the shim skips; a built codec that drifts fails."""
    try:
        from tigerbeetle_tpu_torch.net import codec

        if not codec.enabled():
            return {"ran": False, "failures": [],
                    "note": "codec unavailable (pure-Python bus)"}
        return {"ran": True, "failures": [
            f"codec golden vector: {f}" for f in codec.golden_check()
        ]}
    except Exception as e:  # noqa: BLE001 — a probe error fails closed
        err = f"{type(e).__name__}: {e}"
        return {"ran": False, "note": err,
                "failures": [f"codec build probe errored ({err})"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=None,
                    help="repo root (default: this checkout)")
    ap.add_argument("--json", action="store_true",
                    help="the report as JSON on stdout")
    ap.add_argument("--passes", nargs="+", default=None,
                    choices=tuple(tidy.all_pass_names()) + ("native",),
                    help="a subset of passes ('native' is the three "
                         "native-* passes)")
    ap.add_argument("--baseline", default=None, help="baseline file override")
    args = ap.parse_args(argv)

    report = tidy.check(args.root, args.passes, args.baseline)
    report["devhub"] = {"ran": False, "failures": [], "steps": 0,
                        "note": "the port keeps no devhub series"}
    report["codec"] = (
        check_codec() if args.root is None
        else {"ran": False, "failures": [], "note": "root override"}
    )
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        for f in report["new"]:
            print(f"NEW  {f['file']}:{f['line']}: [{f['pass']}/{f['code']}] "
                  f"{f['scope']}: {f['message']}")
        for k in report["stale_baseline_keys"]:
            print(f"stale baseline entry: {k}")
        for f in report["codec"]["failures"]:
            print(f"codec: {f}")
        print(f"tidy: {len(report['new'])} new, "
              f"{len(report['suppressed'])} baselined, "
              f"{len(report['stale_baseline_keys'])} stale "
              f"(passes: {', '.join(report['passes'])})")
    failed = (report["new"] or report["stale_baseline_keys"]
              or report["codec"]["failures"])
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
