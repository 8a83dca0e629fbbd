from repro_torch.distributed.sharding import (  # noqa: F401
    AxisRules,
    batch_sharding,
    cache_shardings,
    constrain,
    current_mesh,
    default_rules,
    param_shardings,
    placements,
    replicated,
    use_sharding,
)
