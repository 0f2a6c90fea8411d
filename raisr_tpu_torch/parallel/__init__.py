from raisr_tpu_torch.parallel.sharding import (
    Mesh,
    make_mesh,
    process_batch_dp,
    process_plane_row_sharded,
    process_batch_2d,
    HR_HALO,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "process_batch_dp",
    "process_plane_row_sharded",
    "process_batch_2d",
    "HR_HALO",
]
