from .rules import DEFAULT_RULES, ShardingRules, batch_spec

__all__ = ["DEFAULT_RULES", "ShardingRules", "batch_spec"]
