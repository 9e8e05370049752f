"""Continuous-batching decode sessions and the multi-tenant engine."""
