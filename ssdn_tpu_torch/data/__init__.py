from ssdn_tpu_torch.data.datasets import (
    ArrayDataset,
    FolderDataset,
    HDF5Dataset,
    StreamingSyntheticDataset,
    bundled_dataset,
    open_dataset,
    synthetic_dataset,
    to_grayscale,
)
from ssdn_tpu_torch.data.sampler import (
    PatchSampler,
    Prefetcher,
    StreamingPatchSampler,
    to_device,
)
from ssdn_tpu_torch.data.synthetic import make_images

__all__ = [
    "ArrayDataset",
    "FolderDataset",
    "HDF5Dataset",
    "StreamingSyntheticDataset",
    "bundled_dataset",
    "open_dataset",
    "synthetic_dataset",
    "to_grayscale",
    "PatchSampler",
    "Prefetcher",
    "StreamingPatchSampler",
    "make_images",
    "to_device",
]
