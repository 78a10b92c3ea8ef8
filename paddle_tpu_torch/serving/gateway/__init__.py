"""Serving gateway: the OpenAI-style HTTP/SSE front door over a fleet
of in-process engine replicas (the port's copy of
``paddle_tpu/serving/gateway``).

Three layers (one module each):

* :mod:`.protocol` — stdlib-threaded HTTP server, ``/v1/completions``
  with SSE streaming, structured OpenAI-style errors.
* :mod:`.admission` — per-tenant token-bucket quotas (429) and the SLO
  load-shed decision (503 + Retry-After).
* :mod:`.router` — :class:`EngineWorker` replica threads,
  prefix-affinity (rendezvous-hashed radix-cache-block) routing, and
  the :class:`FleetSupervisor` watchdog that condemns dead/hung
  replicas and fails their in-flight streams over (bitwise-seamless
  resume on a surviving replica; see ``paddle_tpu_torch.serving.faults``
  for the deterministic chaos layer that tests it).
"""

from .admission import TenantQuotas, TokenBucket
from .protocol import Gateway, GatewayConfig
from .router import (EngineWorker, FleetSupervisor,
                     PrefixAffinityRouter, StreamHandle)

__all__ = [
    "Gateway",
    "GatewayConfig",
    "TenantQuotas",
    "TokenBucket",
    "EngineWorker",
    "FleetSupervisor",
    "PrefixAffinityRouter",
    "StreamHandle",
]
