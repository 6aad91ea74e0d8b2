"""The accounting state machine and its serial oracle."""
