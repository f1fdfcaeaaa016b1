from multimodal_rare_disease_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    create_mesh,
    describe_devices,
    replicated_sharding,
    shard_batch,
)
from multimodal_rare_disease_tpu_torch.parallel.tp import (  # noqa: F401
    describe_tp,
    shard_model,
    tp_spec,
)
