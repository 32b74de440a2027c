"""Runtime plumbing: compile cache location, chip_smoke.py's refusal to run
without a GPU, in-memory scenes, checkpoint round trips, the fleet pipeline
on a 4-device mesh, and main-path imports without the optional packages."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


class TestCompileCache:
    def test_env_var_wins_and_config_is_untouched(self, tmp_path):
        from himo_tpu.utils.compile_cache import enable_compile_cache

        before = jax.config.jax_compilation_cache_dir
        got = enable_compile_cache({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
        assert got == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_is_fixed_ignored_dir_in_checkout(self):
        from himo_tpu.utils.compile_cache import DEFAULT_DIR, enable_compile_cache

        before = jax.config.jax_compilation_cache_dir
        try:
            got = enable_compile_cache({})
            assert got == str(REPO / ".jax_cache") == str(DEFAULT_DIR)
            assert jax.config.jax_compilation_cache_dir == got
        finally:
            jax.config.update("jax_compilation_cache_dir", before)
        ignored = (REPO / ".gitignore").read_text().split()
        assert ".jax_cache/" in ignored, ".jax_cache must be git-ignored"


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """On a CPU-only host (and, a fortiori, outside the repo) the smoke test
    exits non-zero and prints no result line."""
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_in_memory_scenes_match_h5(tmp_path):
    from himo_tpu.data.dataset import SceneFlowDataset
    from himo_tpu.data.synthetic import make_dataset, scene_frames

    root = tmp_path / "av2_mem"
    make_dataset(root, num_scenes=2, num_frames=4, seed=3, num_background=300)
    scenes = {
        f"scene_{i:03d}": scene_frames(num_frames=4, seed=3 + i, num_background=300)
        for i in range(2)
    }
    kw = dict(eval=True, with_pc1=True, with_history=True, next_keys=("lidar_dt",))
    disk = SceneFlowDataset(root, **kw)
    mem = SceneFlowDataset(None, scenes=scenes, **kw)
    assert len(mem) == len(disk) == 6
    for i in range(len(disk)):
        a, b = mem[i], disk[i]
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]))


def test_checkpoint_roundtrip_with_optax_target(tmp_path):
    import optax

    from himo_tpu.training.checkpoints import load_checkpoint, save_checkpoint

    params = {"Dense_0": {"kernel": jnp.arange(6.0).reshape(2, 3), "bias": jnp.ones(3)}}
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    state = opt.update(params, opt.init(params), params)[1]
    tree = {"params": params, "opt_state": state, "step": 7}
    save_checkpoint(tmp_path / "ck", tree)
    back = load_checkpoint(tmp_path / "ck", target=tree)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    plain = load_checkpoint(tmp_path / "ck")
    np.testing.assert_array_equal(plain["params"]["Dense_0"]["bias"], np.ones(3))


def test_fleet_on_four_devices_matches_one(tmp_path):
    """The mesh-sharded fleet step spreads each batch over the data axis and
    returns the same flow as one device (4 virtual CPU devices)."""
    from himo_tpu.data.dataset import SceneFlowDataset
    from himo_tpu.data.synthetic import scene_frames
    from himo_tpu.models.feedforward import init_params, make_model
    from himo_tpu.ops.voxelize import PillarConfig
    from himo_tpu.parallel import fleet
    from himo_tpu.parallel.mesh import make_mesh, replicated

    scenes = {"scene_000": scene_frames(num_frames=5, seed=4, num_background=400)}
    ds = SceneFlowDataset(None, scenes=scenes, eval=True, with_pc1=True,
                          with_history=True, next_keys=("lidar_dt",))
    model, _ = make_model(
        "seflowpp_noprior",
        pillar=PillarConfig(x_range=(-51.2, 51.2), y_range=(-51.2, 51.2),
                            voxel_size=(3.2, 3.2)),
        depths=(8, 16), base_channels=8, point_feat_dim=8,
    )
    params = init_params(model, jax.random.PRNGKey(0), num_points=256)
    cfg = fleet.FleetConfig(num_points=1024, batch_per_device=1)
    seen = []
    step_factory = fleet.make_fleet_step

    def spying_factory(*a, **k):
        step = step_factory(*a, **k)

        def spy(p, batch):
            seen.append({d.id for d in batch["pc0"].sharding.device_set})
            return step(p, batch)

        return spy

    flows = {}
    for n in (4, 1):
        mesh = make_mesh(n)
        got = {}
        fleet.make_fleet_step = spying_factory
        try:
            fleet.run_fleet(
                ds, model, jax.device_put(params, replicated(mesh)), mesh=mesh,
                config=cfg, outputs=("flow",),
                consumer=lambda i, h, o, got=got: got.__setitem__(i, o["flow"]),
            )
        finally:
            fleet.make_fleet_step = step_factory
        flows[n] = got
    assert seen[0] == {0, 1, 2, 3}  # the 4-device batch spans every device
    assert sorted(flows[4]) == sorted(flows[1]) == [0, 1, 2, 3]
    for i in flows[1]:
        np.testing.assert_allclose(flows[4][i], flows[1][i], atol=1e-5)


def test_main_path_imports_without_optional_packages():
    """The model, de-skew, train step and smoke test import with flax, h5py,
    orbax and sklearn absent (as on the GPU machine)."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('flax', 'h5py', 'orbax', 'sklearn'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import himo_tpu.models.feedforward, himo_tpu.training.trainer\n"
        "import himo_tpu.parallel.fleet, himo_tpu.training.checkpoints\n"
        "import himo_tpu.data.synthetic, himo_tpu.cli.train, himo_tpu.cli.save\n"
        "import chip_smoke, bench\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]


def test_dp_gradient_check_catches_a_missing_all_reduce(monkeypatch):
    """chip_smoke.py's 4-card gradient check on 4 virtual CPU devices: the
    train step's all-reduced gradient, read back through the gradient probe,
    matches one device within the limits, and the gradient of one quarter of
    the batch (what a missing all-reduce leaves) fails them."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke

    from himo_tpu.data.synthetic import scene_frames
    from himo_tpu.models.feedforward import init_params, make_model
    from himo_tpu.ops.voxelize import PillarConfig
    from himo_tpu.parallel.mesh import make_mesh, replicated, shard_batch
    from himo_tpu.training.trainer import TrainConfig, make_train_step

    scenes = {"scene_000": scene_frames(num_frames=5, seed=5, num_background=600)}
    ds = chip_smoke.fleet_dataset(scenes)
    model, _ = make_model(
        "seflowpp", pillar=PillarConfig(voxel_size=(3.2, 3.2)),
        depths=(8, 16), base_channels=8, point_feat_dim=8,
    )
    config = TrainConfig(num_points=1024, loss_points=256, warmup_steps=0, grad_clip=0.0)
    params = init_params(model, jax.random.PRNGKey(0), num_points=256)
    batch = chip_smoke.train_batch(ds, 1024, 256, 8, seed=1)
    probe = chip_smoke.gradient_probe()
    step = make_train_step(model, config, probe)
    grads = {}
    with jax.default_matmul_precision("highest"):
        for n in (4, 1):
            mesh = make_mesh(n)
            p = jax.device_put(params, replicated(mesh))
            new_p, g, _ = step(p, probe.init(p), shard_batch(mesh, batch))
            for a, b in zip(jax.tree.leaves(new_p), jax.tree.leaves(params)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            grads[n] = jax.tree.map(np.asarray, g)
        quarter = {k: v[:2] for k, v in batch.items()}
        p = jax.device_put(params)
        alone = jax.tree.map(np.asarray, step(p, probe.init(p), quarter)[1])
    total, worst, _ = chip_smoke.grad_agreement(grads[4], grads[1])
    assert total <= chip_smoke.GRAD_REL_LIMIT and worst <= chip_smoke.GRAD_LEAF_LIMIT
    total, worst, _ = chip_smoke.grad_agreement(alone, grads[1])
    assert total > chip_smoke.GRAD_REL_LIMIT and worst > chip_smoke.GRAD_LEAF_LIMIT
