"""The distributed layer (`mmgt_tpu/parallel/`): the ("dp", "tp") mesh on
`torch.distributed` (`mesh.py`) and the collectives that carry it
(`collectives.py`)."""
from mmgt_tpu_torch.parallel.mesh import (
    Mesh,
    TPShard,
    create_mesh,
    opt_state_shardings,
    param_shardings,
    shard_,
    shard_batch,
)
