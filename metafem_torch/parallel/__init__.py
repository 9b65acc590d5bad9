"""Multi-device parallelism over a ``torch.distributed`` DeviceMesh:
explicit SPMD, one process per rank, local tensors and named
collectives.  Port of ``metafem/parallel/``: element-axis data
parallelism (dataparallel.py) and the row-sharded solver layout
(rowshard.py), over the collectives of comm.py; ``dryrun.py`` runs them
against the unsharded steps.
"""

from .dataparallel import (shard_domain_state, element_sharding,  # noqa: F401
                           replicated_sharding)
from .rowshard import (rowblock_sharding, constrain,  # noqa: F401
                       RowShardedOp)
