"""Algorithm 1's partition state and the DNNG workload abstraction."""
