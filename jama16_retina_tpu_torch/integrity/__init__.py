"""Sealed artifacts: the integrity envelope the quality profile and canary share with the JAX package."""
