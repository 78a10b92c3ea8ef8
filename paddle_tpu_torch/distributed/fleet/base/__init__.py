from .distributed_strategy import DistributedStrategy

__all__ = ["DistributedStrategy"]
