"""Fixture: a cost table whose one row reads the slot values (a sync),
called from a hot function next to a launch, beside a row that counts
from shapes alone. tests/test_torch_tidy.py asserts the findings
exactly: edit both together."""


def _landed(slots, a):
    """Counts the rows that land: reads every slot off the card."""
    return ((slots >= 0) & (slots < a)).sum().item()


def _rows(slots, a):
    """Bounds the rows that land from the shape alone."""
    return slots.shape[0]


COSTS = {
    "write_balances_sharded": lambda slots, a: (64 * _landed(slots, a), 0),
    "write_balances": lambda slots, a: (64 * _rows(slots, a), 0),
}


def note_call(entry, args):
    """Hot: runs beside every launch."""
    return COSTS[entry](*args)
