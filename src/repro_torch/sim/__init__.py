"""The paper's Table-1 workloads."""
