"""Logical-axis sharding rules: tensor axes → mesh axes (reference
``sharding/``).  Shape logic over a mesh — an ordered mapping from axis
name to size, such as ``{"data": 16, "model": 16}`` — and, on a
:class:`GroupMesh` of ranks, the placement of state dicts
(``shard_params`` / ``gather_params``)."""
from .axes import (DEFAULT_RULES, GroupMesh, constrain, current_mesh,
                   divisible, embed_lookup, logical_binding, spec_for)
from .partition import (batch_spec, cache_specs, gather_params, param_spec,
                        param_specs, shard_params)
