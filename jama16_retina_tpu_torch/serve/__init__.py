"""Serving path of the port: host stage, engine, cascade and router."""

from jama16_retina_tpu_torch.serve.router import (EscalationPool,
                                                  NoReplicasLeft, Router)

__all__ = ["EscalationPool", "NoReplicasLeft", "Router"]
