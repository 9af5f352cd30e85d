"""Contract workloads: the ERC-20 token and the shared-slot swap pool."""
