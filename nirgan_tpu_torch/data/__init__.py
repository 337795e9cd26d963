from nirgan_tpu_torch.data.select_dataset import DataModule, dataset_selector

__all__ = ["DataModule", "dataset_selector"]
