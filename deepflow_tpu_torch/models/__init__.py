"""Workloads under observation."""
