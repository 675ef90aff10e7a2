"""repro_torch.sim — the fleet simulator's numerics on the card: cohort
training (``fleet``), sync/async aggregation with the exact int64 fold
(``async_agg``) and floating-root placement (``agg_tree``). The event and
timing engine of ``repro.sim`` is not ported yet."""
from __future__ import annotations

from repro_torch.sim.agg_tree import group_homes, link_cost, place_root
from repro_torch.sim.async_agg import (AsyncAggregator, SyncAggregator,
                                       constant_staleness, group_coeffs,
                                       hinge_staleness, keep_coeff,
                                       poly_staleness, sync_coeffs)
from repro_torch.sim.fleet import (ClientSpec, Cohort, CohortSpec, Fleet,
                                   PrunedEpochError, SimClient,
                                   make_fleet_specs, tree_nbytes)

__all__ = ["AsyncAggregator", "ClientSpec", "Cohort", "CohortSpec", "Fleet",
           "PrunedEpochError", "SimClient", "SyncAggregator",
           "constant_staleness", "group_coeffs", "group_homes",
           "hinge_staleness", "keep_coeff", "link_cost", "make_fleet_specs",
           "place_root", "poly_staleness", "sync_coeffs", "tree_nbytes"]
