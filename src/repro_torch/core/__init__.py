"""Workload generation shared by the serving driver and the CLI."""
