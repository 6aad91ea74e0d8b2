"""Fixture: banned markers for the marker scan, and one allowed.
tests/test_torch_tidy.py holds the port's scan to the reference's here."""


def stub():
    raise NotImplementedError  # line 6


# TODO: line 9
# FIXME: line 10
def debug():
    breakpoint()  # line 12
    return "TODO"  # tidy: allow=marker — fixture: the inline escape
