"""``distributed.fleet``, single card so far: ``DistributedStrategy``
and the static meta-optimizer (``meta_optimizers``).  ``fleet.init``,
``fleet.distributed_optimizer`` and the mesh paths wait for ROADMAP.md's
Queue 1 item 8."""

from .base.distributed_strategy import DistributedStrategy
from .meta_optimizers.static_meta_optimizer import StaticMetaOptimizer

__all__ = ["DistributedStrategy", "StaticMetaOptimizer"]
