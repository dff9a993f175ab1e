from repro_torch.distributed.fault import PreemptionHandler, StragglerMonitor, elastic_restore
from repro_torch.distributed.pipeline import bubble_fraction, pipeline_apply
from repro_torch.distributed.sharding import (
    activation_sharding,
    batch_shardings,
    fsdp_axes,
    logits_sharding,
    moe_expert_parallel,
    opt_state_shardings,
    param_spec,
    param_shardings,
)

__all__ = [
    "PreemptionHandler",
    "StragglerMonitor",
    "activation_sharding",
    "batch_shardings",
    "bubble_fraction",
    "elastic_restore",
    "fsdp_axes",
    "logits_sharding",
    "moe_expert_parallel",
    "opt_state_shardings",
    "param_spec",
    "param_shardings",
    "pipeline_apply",
]
