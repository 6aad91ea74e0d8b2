"""The parts of the replication layer the port carries so far: the
block checksum."""
