"""Observability of the port: the metric registry and the quality monitor."""
