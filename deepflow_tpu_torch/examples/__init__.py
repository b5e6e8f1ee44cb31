"""Workloads to run under the port's agent."""
