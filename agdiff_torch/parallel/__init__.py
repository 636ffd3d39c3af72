"""Data parallelism over torch.distributed (port of agdiff_tpu/parallel,
its data-parallel part; parallel/sharded.py and parallel/pipeline.py are
ROADMAP.md queue 1)."""

from agdiff_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_sharding,
    launch,
    make_mesh,
    replicated,
)
from agdiff_torch.parallel.data_parallel import (  # noqa: F401
    make_parallel_sampler,
    make_parallel_train_step,
    shard_graph_batch,
)
