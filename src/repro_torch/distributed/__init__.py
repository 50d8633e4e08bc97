"""repro_torch.distributed — the logical-axis sharding rules as DTensor
placements (:mod:`.sharding`) and the hierarchical cross-pod gradient
reduction (:mod:`.collectives`); ports of ``repro.distributed``."""

from .sharding import (ShardingRules, BASELINE_RULES, DECODE_RULES,
                       logical_to_sharding, constrain, adapt_rules_for,
                       divisible)

__all__ = ["BASELINE_RULES", "DECODE_RULES", "ShardingRules",
           "adapt_rules_for", "constrain", "divisible",
           "logical_to_sharding"]
