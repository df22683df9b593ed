"""Serving path of the port: host stage and engine."""
