from raisr_tpu_torch.train.trainer import (
    TrainConfig,
    accumulate_pair,
    solve_filters,
    train_filterbank,
    train_filterbank_ct,
    train_step_sharded,
)
from raisr_tpu_torch.train.export import save_filter_folder

__all__ = [
    "TrainConfig",
    "accumulate_pair",
    "solve_filters",
    "train_filterbank",
    "train_filterbank_ct",
    "train_step_sharded",
    "save_filter_folder",
]
