"""The port's ``zoo.save`` against the JAX package's ``zoo.load`` and
``zoo.save``, both ways, on the CPU: an artifact either package writes is
read by the other with the same params bit for bit (conv weights HWIO in
the file, OIHW in the port), the same config and the same meta."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdn_tpu import zoo as jzoo
from ssdn_tpu.config import ModelConfig as JModelConfig
from ssdn_tpu.config import TrainConfig as JTrainConfig
from ssdn_tpu.config import parse_noise_style as jparse_noise_style
from ssdn_tpu.config import to_json as jto_json
from ssdn_tpu.train.step import init_state as jinit_state
from ssdn_tpu_torch import zoo
from ssdn_tpu_torch.config import ModelConfig, TrainConfig, parse_noise_style
from ssdn_tpu_torch.config import to_json
from ssdn_tpu_torch.models.blindspot_unet import params_from_jax, params_to_jax
from ssdn_tpu_torch.train.step import init_state

TINY = dict(enc_features=8, dec_features=16, nin_a_features=32,
            nin_b_features=16)
META = {"step": 7, "noise": "x", "note": "round trip", "eval": {"a": 1.5}}
# a known-noise model, and a constant-blind one (its learned scalar is a
# 0-d leaf, ``noise_scalar/raw``)
STYLES = [("gauss25", False), ("gauss25", "const")]


def _same_tree(a, b):
    assert sorted(a) == sorted(b)
    for layer in a:
        assert sorted(a[layer]) == sorted(b[layer]), layer
        for leaf in a[layer]:
            x, y = np.asarray(a[layer][leaf]), np.asarray(b[layer][leaf])
            assert x.dtype == y.dtype and x.shape == y.shape, (layer, leaf)
            np.testing.assert_array_equal(x, y, err_msg=f"{layer}/{leaf}")


def _same_file(p, q):
    with np.load(p) as a, np.load(q) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("style,blind", STYLES)
def test_port_save_is_read_by_the_jax_package(tmp_path, style, blind):
    cfg = TrainConfig(noise=parse_noise_style(style, blind=blind),
                      model=ModelConfig(**TINY), seed=3)
    params = init_state(cfg, device="cpu").params
    path = str(tmp_path / "port.npz")
    zoo.save(path, cfg, params, META)
    jcfg, jtree, meta = jzoo.load(path)
    _same_tree(jtree, params_to_jax(params))
    assert jto_json(jcfg) == to_json(cfg)
    assert meta == META
    # and the port reads its own file back to the same tensors
    cfg2, tree2, meta2 = zoo.load(path)
    assert to_json(cfg2) == to_json(cfg) and meta2 == META
    back = params_from_jax(tree2, device="cpu")
    _same_tree({k: {n: t.numpy() for n, t in v.items()} for k, v in
                back.items()},
               {k: {n: t.numpy() for n, t in v.items()} for k, v in
                params.items()})


@pytest.mark.parametrize("style,blind", STYLES)
def test_jax_save_is_read_and_rewritten_by_the_port(tmp_path, style, blind):
    jcfg = JTrainConfig(noise=jparse_noise_style(style, blind=blind),
                        model=JModelConfig(**TINY), seed=5)
    jparams = jinit_state(jcfg).params
    theirs = str(tmp_path / "jax.npz")
    jzoo.save(theirs, jcfg, jparams, META)
    cfg, tree, meta = zoo.load(theirs)
    _same_tree(tree, {k: {n: np.asarray(v) for n, v in leaf.items()}
                      for k, leaf in jparams.items()})
    assert to_json(cfg) == jto_json(jcfg) and meta == META
    ours = str(tmp_path / "port.npz")
    zoo.save(ours, cfg, params_from_jax(tree, device="cpu"), meta)
    _same_file(theirs, ours)


@pytest.mark.parametrize("name", sorted(zoo.available()))
def test_bundled_artifact_round_trips_through_the_port(tmp_path, name):
    """load -> the port's tensors -> save: the same arrays bit for bit and
    the same config and meta (the JSON is the port's serialisation of the
    same config)."""
    cfg, tree, meta = zoo.load(name)
    path = str(tmp_path / f"{name}.npz")
    zoo.save(path, cfg, params_from_jax(tree, device="cpu"), meta)
    cfg2, tree2, meta2 = jzoo.load(path)
    _same_tree(tree2, tree)
    assert jto_json(cfg2) == to_json(cfg) and meta2 == meta
    with np.load(zoo._resolve(name)) as a, np.load(path) as b:
        assert sorted(a.files) == sorted(b.files)


@pytest.mark.parametrize("path", ["top-level-leaf", "reserved-name"])
def test_save_refuses_what_the_jax_package_refuses(tmp_path, path):
    def tree(leaf):
        return {"w": leaf} if path == "top-level-leaf" else {"__x": {"w": leaf}}

    with pytest.raises(ValueError, match="unsupported params path"):
        jzoo.save(str(tmp_path / "j.npz"), JTrainConfig(), tree(jnp.ones(3)))
    with pytest.raises(ValueError, match="unsupported params path"):
        zoo.save(str(tmp_path / "p.npz"), TrainConfig(), tree(torch.ones(3)))
