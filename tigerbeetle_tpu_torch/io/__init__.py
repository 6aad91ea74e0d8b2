"""Grid storage (in-memory and file-backed blocks) for the LSM tier."""
