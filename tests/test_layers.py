"""Plain-JAX layers (models/layers.py) against flax.linen: same parameter
tree, same output. The whole-network cases compare against outputs recorded
from the flax.linen implementation of the same networks
(tests/data/flax_golden.npz: params, inputs and outputs at a small width)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from himo_tpu.models import layers as L

GOLDEN = Path(__file__).parent / "data" / "flax_golden.npz"


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)


def _init_and_compare(flax_module, fn, *args, atol=0.0):
    """Init the flax module, run ``fn(Params(tree), *args)`` with its params,
    and compare trees + outputs; also check our own init builds the same
    tree."""
    variables = flax_module.init(jax.random.PRNGKey(0), *args)
    tree = jax.tree_util.tree_map(jnp.asarray, dict(variables["params"]))
    want = flax_module.apply(variables, *args)
    got = fn(L.Params(tree), *args)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(
            np.asarray(a, np.float32), np.asarray(b, np.float32), atol=atol, rtol=0
        )
    mine: dict = {}
    fn(L.Params(mine, jax.random.PRNGKey(1)), *args)
    assert _shapes(mine) == _shapes(tree)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("use_bias", [True, False])
def test_dense_matches_flax(rng, dtype, use_bias):
    nn = pytest.importorskip("flax.linen")
    x = jnp.asarray(rng.normal(size=(7, 5)), jnp.float32)
    _init_and_compare(
        nn.Dense(6, dtype=dtype, use_bias=use_bias),
        lambda p, x: L.dense(p, x, 6, dtype, use_bias=use_bias),
        x,
    )


@pytest.mark.parametrize(
    "shape,kernel,stride,dtype",
    [
        ((16, 16, 4), (3, 3), 1, jnp.float32),  # unbatched image
        ((16, 16, 4), (3, 3), 2, jnp.float32),  # strided: SAME pads (0, 1)
        ((2, 12, 10, 3), (1, 1), 1, jnp.float32),  # batched, 1x1 head
        ((2, 3, 8, 8, 4), (3, 3), 2, jnp.bfloat16),  # two batch dims, bf16
    ],
)
def test_conv_matches_flax(rng, shape, kernel, stride, dtype):
    nn = pytest.importorskip("flax.linen")
    x = jnp.asarray(rng.normal(size=shape), jnp.float32)
    _init_and_compare(
        nn.Conv(8, kernel, strides=(stride, stride), dtype=dtype),
        lambda p, x: L.conv(p, x, 8, kernel, (stride, stride), dtype),
        x,
    )


@pytest.mark.parametrize(
    "shape,dtype",
    [
        ((9, 16), jnp.float32),
        ((6, 10, 16), jnp.float32),  # leading axis is the "batch" axis
        ((2, 6, 10, 32), jnp.float32),
        ((6, 10, 16), jnp.bfloat16),
    ],
)
def test_group_norm_matches_flax(rng, shape, dtype):
    nn = pytest.importorskip("flax.linen")
    x = jnp.asarray(rng.normal(loc=0.5, size=shape), dtype)
    _init_and_compare(
        nn.GroupNorm(num_groups=8, dtype=dtype),
        lambda p, x: L.group_norm(p, x, 8, dtype),
        x,
    )


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_gru_cell_matches_flax(rng, dtype):
    nn = pytest.importorskip("flax.linen")
    h = jnp.asarray(rng.normal(size=(5, 8)), jnp.float32)
    x = jnp.asarray(rng.normal(size=(5, 8)), jnp.float32)
    _init_and_compare(
        nn.GRUCell(features=8, dtype=dtype),
        lambda p, h, x: (lambda o: (o, o))(L.gru_cell(p, h, x, dtype)),
        h,
        x,
    )


def test_params_reads_without_key_and_creates_with_one():
    tree: dict = {}
    p = L.Params(tree, jax.random.PRNGKey(0))
    k = p["Dense_0"].param("kernel", L.lecun_normal, (3, 4))
    assert tree["Dense_0"]["kernel"] is k
    again = L.Params(tree)["Dense_0"].param("kernel", L.zeros, (3, 4))
    assert again is k  # apply mode never re-initializes
    with pytest.raises(KeyError):
        L.Params(tree)["Dense_1"]


def _golden_tree(g, prefix):
    tree: dict = {}
    for key in g.files:
        if key.startswith(prefix):
            node = tree
            *parents, leaf = key[len(prefix):].split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = jnp.asarray(g[key])
    return tree


def _small_model(name):
    from himo_tpu.models.feedforward import make_model
    from himo_tpu.ops.refine import RefineConfig
    from himo_tpu.ops.voxelize import PillarConfig

    extra = {}
    if name == "seflowpp":
        extra["refine"] = RefineConfig(num_query=128, num_ref=256)
    return make_model(
        name,
        pillar=PillarConfig(
            x_range=(-8.0, 8.0), y_range=(-8.0, 8.0), voxel_size=(0.5, 0.5)
        ),
        depths=(8, 16), base_channels=8, point_feat_dim=8, **extra,
    )


@pytest.mark.parametrize("name", ["seflowpp", "fastflow3d"])
def test_scene_flow_net_matches_flax_golden(name):
    from himo_tpu.models.feedforward import init_params

    g = np.load(GOLDEN)
    model, config = _small_model(name)
    params = {"params": _golden_tree(g, f"{name}:params:")}
    mine = init_params(model, jax.random.PRNGKey(3), num_points=512)
    assert _shapes(mine) == _shapes(params)
    sweeps = (g["pc0"], g["pc1"], g["pch"])[: config.num_frames]
    valids = tuple(g["valid"][: config.num_frames])
    if name == "seflowpp":
        flow, aux = model.apply(
            params, sweeps, valids, with_aux=True, dts=(g["dt0"], g["dt1"])
        )
        for key, value in aux.items():
            np.testing.assert_allclose(
                np.asarray(value), g[f"{name}:aux:{key}"], atol=1e-6
            )
        soft = model.apply(params, sweeps, valids, soft_gate=True)
        np.testing.assert_allclose(np.asarray(soft), g[f"{name}:flow_soft"], atol=1e-6)
    else:
        flow = model.apply(params, sweeps, valids)
    np.testing.assert_allclose(np.asarray(flow), g[f"{name}:flow"], atol=1e-6)
