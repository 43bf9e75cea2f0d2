"""Pretrained model zoo: read the bundled ``.npz`` artifacts (params +
TrainConfig + provenance) without a training workdir.

The artifacts are data shared with the JAX package: they stay in
``ssdn_tpu/pretrained/`` and are found by path, relative to the repo. Their
``__config__`` JSON is parsed with the port's own copy of the config. The
params come back as the same host-numpy ``{layer: {"w": HWIO, "b": ...}}``
tree the JAX package's ``zoo.load`` returns;
``models.blindspot_unet.params_from_jax`` turns it into the port's tensors.
``save`` writes the same layout from the port's tensors (conv weights back
to HWIO), so either package loads what the other writes;
``tools/export_pretrained.py`` makes one from a training workdir.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np

from ssdn_tpu_torch.config import TrainConfig, to_json, train_config_from_json

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRETRAINED_DIR = os.path.join(_REPO, "ssdn_tpu", "pretrained")

_CONFIG_KEY = "__config__"
_META_KEY = "__meta__"


def available() -> Dict[str, dict]:
    """name -> meta for every bundled model."""
    out = {}
    if os.path.isdir(PRETRAINED_DIR):
        for f in sorted(os.listdir(PRETRAINED_DIR)):
            if f.endswith(".npz"):
                with np.load(os.path.join(PRETRAINED_DIR, f)) as z:
                    meta = (json.loads(str(z[_META_KEY]))
                            if _META_KEY in z else {})
                out[f[:-4]] = meta
    return out


def _resolve(name_or_path: str) -> str:
    if os.path.exists(name_or_path):
        return name_or_path
    path = os.path.join(PRETRAINED_DIR, name_or_path + ".npz")
    if os.path.exists(path):
        return path
    raise FileNotFoundError(
        f"no pretrained model {name_or_path!r}; bundled: "
        f"{sorted(available()) or '(none)'}"
    )


def load(name_or_path: str) -> Tuple[TrainConfig, Any, dict]:
    """Load a pretrained artifact -> (cfg, params tree of host numpy
    arrays in the checkpoint layout, meta dict)."""
    path = _resolve(name_or_path)
    with np.load(path) as z:
        if _CONFIG_KEY not in z:
            raise ValueError(f"{path} is not a ssdn_tpu pretrained artifact "
                             f"(missing {_CONFIG_KEY})")
        cfg = train_config_from_json(str(z[_CONFIG_KEY]))
        meta = json.loads(str(z[_META_KEY])) if _META_KEY in z else {}
        params: Dict[str, Any] = {}
        for key in z.files:
            if key.startswith("__"):
                continue
            node = params
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return cfg, params, meta


def save(path: str, cfg: TrainConfig, params: Any,
         meta: dict | None = None) -> None:
    """Write a pretrained artifact (inverse of load) from the port's
    ``{layer: {leaf: tensor}}`` params: ``<layer>/<leaf>`` arrays in the
    JAX layout (``params_to_jax``), ``__config__`` and ``__meta__`` JSON."""
    from ssdn_tpu_torch.models.blindspot_unet import params_to_jax

    for layer, leaf in params.items():
        if str(layer).startswith("__") or not isinstance(leaf, dict):
            raise ValueError(f"unsupported params path {layer!r}")
    flat: Dict[str, np.ndarray] = {
        f"{layer}/{key}": v
        for layer, leaf in params_to_jax(params).items()
        for key, v in leaf.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(
        path,
        **flat,
        **{_CONFIG_KEY: np.str_(to_json(cfg)),
           _META_KEY: np.str_(json.dumps(meta or {}))},
    )
