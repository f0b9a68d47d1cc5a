from acezero_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    broadcast_,
    gather_rows,
    make_mesh,
    reduce_sum,
    replicate,
    shard_rows,
    split_positions,
)

__all__ = ["DATA_AXIS", "Mesh", "make_mesh", "shard_rows", "replicate", "gather_rows", "reduce_sum", "broadcast_",
           "split_positions"]
