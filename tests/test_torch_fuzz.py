"""The port's component fuzzer registry against the reference
package's: every registered fuzzer runs seeds 0 and 1 at the reference
test's iteration counts on the port's components (LSM tree and log,
grid free set, EWAH codec, journal), and reports what the reference's
run of the same seed reports; plus the registry CLI. No fuzzer launches
a kernel."""

import pytest

from tigerbeetle_tpu import fuzz as ref_fuzz
from tigerbeetle_tpu_torch import fuzz


def test_registry_matches_reference():
    assert sorted(fuzz.REGISTRY) == sorted(ref_fuzz.REGISTRY)
    assert fuzz.DEFAULT_ITERS == ref_fuzz.DEFAULT_ITERS


@pytest.mark.parametrize("name", sorted(fuzz.REGISTRY))
def test_fuzzer_smoke_matches_reference(name, capsys):
    iters = max(50, fuzz.DEFAULT_ITERS[name] // 4)
    for seed in (0, 1):
        fuzz.REGISTRY[name](seed, iters)
        port_out = capsys.readouterr().out
        ref_fuzz.REGISTRY[name](seed, iters)
        ref_out = capsys.readouterr().out
        assert port_out == ref_out
        assert f"{name} seed={seed}" in port_out


def test_registry_cli(capsys):
    assert fuzz.main(["--list"]) == 0
    assert capsys.readouterr().out.split() == sorted(fuzz.REGISTRY)
    assert fuzz.main(["ewah", "--seed", "3", "--iters", "20"]) == 0
    assert "ewah seed=3: 20 round-trips OK" in capsys.readouterr().out
