"""Partition policies (the part the tenancy manager calls)."""
