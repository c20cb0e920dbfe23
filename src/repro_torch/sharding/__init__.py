"""Logical-axis sharding rules: tensor axes → mesh axes (reference
``sharding/``).  Pure shape logic over an abstract mesh — an ordered
mapping from axis name to size, such as ``{"data": 16, "model": 16}``."""
from .axes import (DEFAULT_RULES, constrain, current_mesh, divisible,
                   embed_lookup, logical_binding, spec_for)
from .partition import batch_spec, cache_specs, param_spec, param_specs
