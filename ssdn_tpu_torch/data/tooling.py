"""Dataset packing tool (the PyTorch port's own copy of
``ssdn_tpu/data/tooling.py``; reference ``dataset_tool_h5.py`` [R]): pack an
image folder into an HDF5 file for fast training-time access."""

from __future__ import annotations

import numpy as np

from ssdn_tpu_torch.utils.images import list_images, load_image


def pack_folder(folder: str, out_path: str, grayscale: bool = False,
                uniform: bool = False) -> int:
    """Pack every image in `folder` into `out_path`.

    uniform=True writes one (N, H, W, C) dataset (all images must share a
    shape); otherwise a group of per-image datasets handles mixed sizes.
    Returns the number of images packed.
    """
    import h5py

    paths = list_images(folder)
    if not paths:
        raise FileNotFoundError(f"no images in {folder}")
    with h5py.File(out_path, "w") as f:
        if uniform:
            imgs = np.stack(
                [load_image(p, grayscale=grayscale) for p in paths]
            )
            f.create_dataset("images", data=imgs, compression="gzip")
        else:
            g = f.create_group("images")
            for i, p in enumerate(paths):
                g.create_dataset(
                    str(i),
                    data=load_image(p, grayscale=grayscale),
                    compression="gzip",
                )
    return len(paths)
