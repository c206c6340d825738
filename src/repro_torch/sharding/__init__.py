"""Sharding rules (DP/TP/EP/SP) as DTensor placements, and the helpers
that put a model, a train state, a batch and caches onto a mesh."""

from .partition import (  # noqa: F401
    batch_specs,
    cache_specs,
    data_axes,
    mesh_sizes,
    opt_state_specs,
    param_specs,
    to_placements,
    to_spec,
)
