"""Sharded state: the :class:`ShardedTensor` laid out on a virtual-device
mesh, the partition rules that give each leaf its spec, their ``DTensor``
layout (``placements_for``, ``distribute_tree``) and the ambient mesh of
the model's activation constraints (:mod:`.context`)."""

from .partition import (batch_pspecs, cache_pspecs, distribute_tree,
                        opt_pspecs, param_pspecs, placements_for)
from .sharded import Shard, ShardedTensor, shard_tree, spec_indices, unshard

__all__ = ["Shard", "ShardedTensor", "batch_pspecs", "cache_pspecs",
           "distribute_tree", "opt_pspecs", "param_pspecs",
           "placements_for", "shard_tree", "spec_indices", "unshard"]
