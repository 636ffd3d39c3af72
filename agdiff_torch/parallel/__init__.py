"""Parallelism over torch.distributed (port of agdiff_tpu/parallel): named
meshes and their collectives (mesh.py), data parallelism over a 1-D or
('dcn', 'dp') mesh (data_parallel.py), FSDP and tensor-parallel training
layouts (sharded.py) and GPipe pipelines (pipeline.py)."""

from agdiff_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_sharding,
    launch,
    make_hybrid_mesh,
    make_mesh,
    replicated,
)
from agdiff_torch.parallel.data_parallel import (  # noqa: F401
    make_parallel_sampler,
    make_parallel_train_step,
    shard_graph_batch,
)
from agdiff_torch.parallel.pipeline import (  # noqa: F401
    make_pp_mesh,
    pipeline_apply,
    schnet_pipeline,
    stack_stage_params,
)
from agdiff_torch.parallel.sharded import (  # noqa: F401
    make_sharded_train_step,
    shard_graph_batch_nodes,
    shard_train_state,
)
