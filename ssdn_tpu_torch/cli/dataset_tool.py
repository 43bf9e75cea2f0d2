"""Pack an image folder into HDF5 (port of ``ssdn_tpu/cli/dataset_tool.py``;
reference ``dataset_tool_h5.py`` [R]).

Example:
  python -m ssdn_tpu_torch.cli.dataset_tool --input /data/bsds300/train \
      --output /data/bsds300_train.h5
"""

from __future__ import annotations

import argparse

from ssdn_tpu_torch.data.tooling import pack_folder


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", required=True, help="image folder")
    p.add_argument("--output", required=True, help="output .h5 path")
    p.add_argument("--grayscale", action="store_true")
    p.add_argument("--uniform", action="store_true",
                   help="single (N,H,W,C) dataset; requires equal sizes")
    args = p.parse_args(argv)
    n = pack_folder(args.input, args.output, grayscale=args.grayscale,
                    uniform=args.uniform)
    print(f"packed {n} images -> {args.output}")


if __name__ == "__main__":
    main()
