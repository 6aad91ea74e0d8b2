"""The dynamic leg of the reference package's tidy checks: thread-role
stamps, `assert_role` and lock-order tracking (runtime.py)."""
