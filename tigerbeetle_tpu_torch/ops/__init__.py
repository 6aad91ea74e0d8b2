"""Device ops: u128 limb arithmetic and the commit kernels."""
