"""Layouts of a model over a device mesh (the port of
``repro.sharding``)."""

from repro_torch.sharding.rules import (NamedSharding, P, PartitionSpec,
                                        ShardingRules, dp_axes_of,
                                        opt_state_specs, placements,
                                        scale_spec)

__all__ = ["NamedSharding", "P", "PartitionSpec", "ShardingRules",
           "dp_axes_of", "opt_state_specs", "placements", "scale_spec"]
