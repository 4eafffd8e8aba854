"""repro_torch.dist — distributed execution: sharding plans and pod
collectives, ported from the reference's ``repro.dist``.

    plan           ShardingPlan + registry (bsp / futurized / optimized /
                   serve) — logical-axis → mesh-axis resolution against a
                   torch DeviceMesh, DTensor placements, constraints
    collectives    pod-axis manual collectives (bf16 gradient reduction
                   over the pod group) + error-feedback compression

The reference's ``hlo_analysis`` (static analysis of compiled HLO) comes
with the dry run.
"""

from repro_torch.dist import collectives, plan
from repro_torch.dist.plan import (
    ShardingPlan,
    bsp_plan,
    futurized_plan,
    get_plan,
    optimized_plan,
    serve_plan,
)

__all__ = [
    "collectives", "plan",
    "ShardingPlan", "bsp_plan", "futurized_plan", "get_plan",
    "optimized_plan", "serve_plan",
]
