"""Sharded state: the :class:`ShardedTensor` laid out on a virtual-device
mesh, and the partition rules that give each leaf its spec."""

from .partition import (batch_pspecs, cache_pspecs, opt_pspecs,
                        param_pspecs)
from .sharded import Shard, ShardedTensor, shard_tree, spec_indices, unshard

__all__ = ["Shard", "ShardedTensor", "batch_pspecs", "cache_pspecs",
           "opt_pspecs", "param_pspecs", "shard_tree", "spec_indices",
           "unshard"]
