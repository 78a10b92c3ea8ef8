from .static_meta_optimizer import StaticMetaOptimizer, amp_rewrite

__all__ = ["StaticMetaOptimizer", "amp_rewrite"]
