from raisr_tpu_torch.train.export import save_filter_folder

__all__ = ["save_filter_folder"]
