"""Fleet warm-start distribution fabric for serving replicas.

When a new checkpoint step lands, N serving replicas naively issue N
identical full reads against the slowest storage tier. This package is
the shared surface that avoids it, layered on the
:class:`~repro_torch.storage.repository.CheckpointRepository`:

``cache``    :class:`FleetCache` — shared read-through cache tier
             (capacity-bound ``MemoryBackend``) with single-flight
             de-duplication: K concurrent restorers of one object cause
             exactly one remote read;
``peer``     :class:`PeerExchange` — slice exchange: each replica reads a
             disjoint shard slice from remote and swaps with its peers,
             every exchanged slice digested on the device, so remote-tier
             bytes stay ~1x the checkpoint size regardless of replica
             count;
``fabric``   :class:`FleetFabric` — picks cache vs. peer vs. delta-chain
             transfer per object, funnels admission through the
             repository's verified atomic publish, and persists per-step
             transfer accounting for ``storage.cli stats --fleet``.

Usage (serving)::

    from repro_torch.fleet import FleetFabric

    fabric = FleetFabric(device="cuda")    # one per host, shared
    params, stats = load_params_for_serving(
        root, template, repository=repo, fleet=fabric)
"""

from .cache import FleetCache
from .fabric import FLEET_STATS_KEY, FleetFabric
from .peer import ExchangeStats, PeerExchange

__all__ = ["FleetCache", "PeerExchange", "ExchangeStats", "FleetFabric",
           "FLEET_STATS_KEY"]
