"""Metrics registry and static backend decisions."""
