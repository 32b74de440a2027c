"""Flow estimator tests on small synthetic frame pairs (CPU)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from himo_tpu.models.fastnsf import FastNSFConfig, fastnsf_flow
from himo_tpu.models.nsfp import NSFPConfig, nsfp_flow
from himo_tpu.ops.dt import DTConfig


def _toy_pair(rng, n_static=600, n_obj=200, obj_shift=(1.5, 0.0, 0.0)):
    """Static scatter + one rigidly moving blob; pads to 1024.

    The static clutter lives in the x < 0 half-space so the nearest pc1
    structure to the (displaced) blob is unambiguously the blob itself —
    chamfer/DT losses are only well-posed when correspondence is."""
    static = rng.uniform(-12, 0, size=(n_static, 3)).astype(np.float32)
    static[:, 1] = rng.uniform(-10, 10, size=n_static)
    static[:, 2] = rng.uniform(0, 2, size=n_static)
    blob0 = (rng.normal(scale=0.8, size=(n_obj, 3)) + [6.0, 3.0, 1.0]).astype(
        np.float32
    )
    blob1 = blob0 + np.asarray(obj_shift, dtype=np.float32)
    pc0 = np.concatenate([static, blob0])
    pc1 = np.concatenate([static, blob1])
    n = len(pc0)
    target = 1024
    p0 = np.zeros((target, 3), np.float32)
    p1 = np.zeros((target, 3), np.float32)
    p0[:n] = pc0
    p1[:n] = pc1
    v = np.zeros(target, bool)
    v[:n] = True
    gt = np.zeros((target, 3), np.float32)
    gt[n_static:n] = obj_shift
    return p0, p1, v, gt, n_static, n


SMALL_DT = DTConfig(
    x_range=(-16.0, 16.0),
    y_range=(-16.0, 16.0),
    z_range=(-2.0, 4.0),
    voxel_size=(0.25, 0.25, 0.25),
)


class TestFastNSF:
    def test_recovers_object_motion(self, rng):
        p0, p1, v, gt, n_static, n = _toy_pair(rng)
        cfg = FastNSFConfig(hidden=64, layers=4, iterations=200, lr=0.01, dt=SMALL_DT)
        flow, loss = fastnsf_flow(p0, p1, v, v, jax.random.PRNGKey(0), config=cfg)
        flow = np.asarray(flow)
        obj_flow = flow[n_static:n]
        err = np.linalg.norm(obj_flow - gt[n_static:n], axis=1)
        # Mean EPE on the moving blob well below the 1.5 m motion.
        assert err.mean() < 0.5
        assert float(loss) < 0.2
        # Padded rows must get zero flow.
        np.testing.assert_allclose(flow[n:], 0.0)

    def test_loss_decreases(self, rng):
        p0, p1, v, gt, _, _ = _toy_pair(rng)
        short = FastNSFConfig(hidden=32, layers=2, iterations=5, dt=SMALL_DT)
        longer = FastNSFConfig(hidden=32, layers=2, iterations=120, dt=SMALL_DT)
        _, l0 = fastnsf_flow(p0, p1, v, v, jax.random.PRNGKey(0), config=short)
        _, l1 = fastnsf_flow(p0, p1, v, v, jax.random.PRNGKey(0), config=longer)
        assert float(l1) < float(l0)


class TestNSFP:
    def test_recovers_object_motion(self, rng):
        p0, p1, v, gt, n_static, n = _toy_pair(rng)
        cfg = NSFPConfig(hidden=64, layers=4, iterations=120, lr=0.01)
        flow, loss = nsfp_flow(p0, p1, v, v, jax.random.PRNGKey(0), config=cfg)
        obj_err = np.linalg.norm(
            np.asarray(flow)[n_static:n] - gt[n_static:n], axis=1
        )
        assert obj_err.mean() < 0.6


class TestFeedForward:
    @pytest.mark.parametrize("name", ["fastflow3d", "deflow", "seflowpp"])
    def test_forward_shapes(self, name, rng):
        from himo_tpu.models.feedforward import init_params, make_model
        from himo_tpu.ops.voxelize import PillarConfig

        small_pillar = PillarConfig(
            x_range=(-12.8, 12.8), y_range=(-12.8, 12.8), voxel_size=(0.4, 0.4)
        )
        model, config = make_model(name, pillar=small_pillar, depths=(16, 32))
        params = init_params(model, jax.random.PRNGKey(0), num_points=512)
        sweeps = tuple(
            jnp.asarray(rng.uniform(-10, 10, size=(512, 3)), jnp.float32)
            for _ in range(config.num_frames)
        )
        valids = tuple(jnp.ones((512,), bool) for _ in range(config.num_frames))
        flow = model.apply(params, sweeps, valids)
        assert flow.shape == (512, 3)
        assert np.all(np.isfinite(np.asarray(flow)))

    def test_gate_head_gates_flow(self, rng):
        """seflowpp's gate head: forcing the gate logit saturated-closed via
        the decoder's output bias zeroes the flow; saturated-open restores
        it — proving flow = sigmoid(gate) * raw end to end (incl. the
        sorted-mode unsort path carrying the logit column)."""
        from himo_tpu.models.feedforward import init_params, make_model
        from himo_tpu.ops.voxelize import PillarConfig

        small_pillar = PillarConfig(
            x_range=(-12.8, 12.8), y_range=(-12.8, 12.8), voxel_size=(0.4, 0.4)
        )
        model, config = make_model("seflowpp", pillar=small_pillar, depths=(16, 32))
        assert config.gate_head
        params = init_params(model, jax.random.PRNGKey(0), num_points=512)
        sweeps = tuple(
            jnp.asarray(rng.uniform(-10, 10, size=(512, 3)), jnp.float32)
            for _ in range(config.num_frames)
        )
        valids = tuple(jnp.ones((512,), bool) for _ in range(config.num_frames))
        flow, logits = model.apply(params, sweeps, valids, with_gate=True)
        assert flow.shape == (512, 3) and logits.shape == (512,)

        def with_gate_bias(value):
            p = jax.tree_util.tree_map(lambda a: a, params)

            def visit(tree):
                for k, v in tree.items():
                    if isinstance(v, dict):
                        if (
                            "bias" in v
                            and getattr(v["bias"], "shape", None) == (4,)
                            and "kernel" in v
                        ):
                            v["bias"] = v["bias"].at[3].set(value)
                        else:
                            visit(v)

            visit(p)
            return p

        closed = np.asarray(model.apply(with_gate_bias(-40.0), sweeps, valids))
        opened = np.asarray(model.apply(with_gate_bias(40.0), sweeps, valids))
        np.testing.assert_allclose(closed, 0.0, atol=1e-6)
        assert np.abs(opened).max() > np.abs(closed).max()
        assert np.all(np.isfinite(opened))

    def test_invalid_points_get_zero_flow(self, rng):
        from himo_tpu.models.feedforward import init_params, make_model
        from himo_tpu.ops.voxelize import PillarConfig

        model, config = make_model(
            "fastflow3d",
            pillar=PillarConfig(
                x_range=(-12.8, 12.8), y_range=(-12.8, 12.8), voxel_size=(0.4, 0.4)
            ),
            depths=(16, 32),
        )
        params = init_params(model, jax.random.PRNGKey(0), num_points=256)
        sweeps = tuple(
            jnp.asarray(rng.uniform(-10, 10, size=(256, 3)), jnp.float32)
            for _ in range(2)
        )
        valid0 = jnp.asarray(np.arange(256) < 100)
        valids = (valid0, jnp.ones((256,), bool))
        flow = np.asarray(model.apply(params, sweeps, valids))
        np.testing.assert_allclose(flow[100:], 0.0)


def test_runner_end_to_end(tmp_path, rng):
    """save(model=fastnsf) -> eval(res_name=fastnsf) beats raw."""
    from himo_tpu.cli.eval import main as eval_main
    from himo_tpu.models.runner import estimate_scene_flow
    from himo_tpu.data.synthetic import make_dataset

    root = tmp_path / "av2_mini"
    make_dataset(root, num_scenes=1, num_frames=3, seed=11, num_background=1500)
    stats = estimate_scene_flow(
        str(root),
        model="fastnsf",
        iterations=150,
        dt=SMALL_DT,
        hidden=64,
        layers=4,
        verbose=False,
    )
    assert stats["frames"] == 2
    import os

    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        est = eval_main(data_dir=str(root), res_name="fastnsf").total_summary()
        raw = eval_main(data_dir=str(root), res_name="raw").total_summary()
    finally:
        os.chdir(cwd)
    assert est is not None and raw is not None
    assert est["mpe"] < raw["mpe"]


def test_runner_subsample_upsample(tmp_path, rng):
    """max_estimation_points caps the estimator cloud; flow still improves."""
    from himo_tpu.cli.eval import main as eval_main
    from himo_tpu.models.runner import estimate_scene_flow
    from himo_tpu.data.synthetic import make_dataset

    root = tmp_path / "av2_sub"
    make_dataset(root, num_scenes=1, num_frames=3, seed=13, num_background=3000)
    # Full-range DT (the scene spans +-40 m) at a coarser voxel to stay fast.
    full_dt = DTConfig(voxel_size=(0.8, 0.8, 0.8))
    stats = estimate_scene_flow(
        str(root),
        model="fastnsf",
        iterations=150,
        dt=full_dt,
        hidden=64,
        layers=4,
        max_estimation_points=2048,  # forces subsample (clouds ~3800 pts)
        output_key="fastnsf_sub",
        verbose=False,
    )
    assert stats["frames"] == 2
    import os

    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        est = eval_main(data_dir=str(root), res_name="fastnsf_sub").total_summary()
        raw = eval_main(data_dir=str(root), res_name="raw").total_summary()
    finally:
        os.chdir(cwd)
    assert est["mpe"] < raw["mpe"]


def test_run_adam_early_stop_and_cosine():
    """The shared optimizer loop stops early once the loss plateaus and
    returns the best parameters; the cosine schedule also converges."""
    import jax.numpy as jnp

    from himo_tpu.models.opt_loop import run_adam

    def loss_fn(p):
        return jnp.sum((p - 3.0) ** 2)

    p0 = jnp.zeros((4,))
    p_fix, loss_fix, steps_fix = run_adam(
        loss_fn, p0, iterations=2000, lr=0.1, patience=0
    )
    assert int(steps_fix) == 2000
    p_es, loss_es, steps_es = run_adam(
        loss_fn, p0, iterations=2000, lr=0.1, patience=30
    )
    assert int(steps_es) < 2000, "plateaued loss must stop the loop early"
    assert float(loss_es) < 1e-3
    np.testing.assert_allclose(np.asarray(p_es), 3.0, atol=0.05)
    p_cos, loss_cos, _ = run_adam(
        loss_fn, p0, iterations=500, lr=0.1, schedule="cosine", patience=50
    )
    assert float(loss_cos) < 1e-2


class TestPriorConditioned:
    def test_forward_and_prior_sensitivity(self, rng):
        """seflowpp_prior consumes the prior channel: same inputs with a
        different prior must change the flow (the conditioning is live)."""
        from himo_tpu.models.feedforward import init_params, make_model
        from himo_tpu.ops.voxelize import PillarConfig

        model, config = make_model(
            "seflowpp_prior",
            pillar=PillarConfig(
                x_range=(-12.8, 12.8), y_range=(-12.8, 12.8), voxel_size=(0.4, 0.4)
            ),
            depths=(16, 32),
        )
        assert config.prior_feat
        params = init_params(model, jax.random.PRNGKey(0), num_points=512)
        sweeps = tuple(
            jnp.asarray(rng.uniform(-10, 10, size=(512, 3)), jnp.float32)
            for _ in range(3)
        )
        valids = tuple(jnp.ones((512,), bool) for _ in range(3))
        f_zero = np.asarray(model.apply(params, sweeps, valids, None))
        prior = jnp.asarray(
            np.tile(np.float32([3.0, 0, 0]), (512, 1))
        )
        f_prior = np.asarray(model.apply(params, sweeps, valids, prior))
        assert f_zero.shape == (512, 3)
        assert np.abs(f_prior - f_zero).max() > 1e-4

    def test_registry_prior_estimator(self, rng):
        """The registry wrapper computes priors host-side and runs."""
        from himo_tpu.models.feedforward import init_params, make_model
        from himo_tpu.models.registry import get_estimator
        from himo_tpu.ops.voxelize import PillarConfig

        pillar = PillarConfig(
            x_range=(-12.8, 12.8), y_range=(-12.8, 12.8), voxel_size=(0.4, 0.4)
        )
        model, config = make_model("seflowpp_prior", pillar=pillar, depths=(16, 32))
        params = init_params(model, jax.random.PRNGKey(0), num_points=256)
        est = get_estimator(
            "seflowpp_prior", params=params, pillar=pillar, depths=(16, 32)
        )
        pc = rng.uniform(-10, 10, size=(256, 3)).astype(np.float32)
        valid = np.ones(256, bool)
        flow, _ = est(pc, pc + 0.1, valid, valid)
        assert np.asarray(flow).shape == (256, 3)


def test_runner_scene_start_repair(tmp_path):
    """After a scene completes, the runner re-estimates its first TWO pairs
    with the estimator's confirmed tracks rolled back
    (ClusterTracker.backcast) — offline flow writing can borrow velocity
    continuity from the future exactly like the label writers do (tracks
    only confirm from pair 2 onward, so pairs 0-1 ran track-less)."""
    import numpy as np

    from himo_tpu.data.dataset import SceneFlowDataset
    from himo_tpu.data.synthetic import make_dataset
    from himo_tpu.models.icp_flow import ClusterTracker
    from himo_tpu.models.registry import register_estimator
    from himo_tpu.models.runner import estimate_scene_flow

    root = tmp_path / "av2_repair"
    make_dataset(root, num_scenes=1, num_frames=5, seed=3, num_background=200)

    calls = []  # (scene_id, had_confirmed_track)

    @register_estimator("_test_repair")
    def _factory(**overrides):
        trackers = {}

        def estimate(pc0, pc1, valid0, valid1, key, dt0=None, dt1=None,
                     scene_id=None, pose1=None):
            tracker = trackers.setdefault(scene_id, ClusterTracker())
            confirmed = any(
                conf for _, _, conf in tracker.predict(np.asarray(pose1))
            )
            calls.append((scene_id, confirmed))
            # Feed the tracker one consistent moving object per pair so
            # confirmation builds up across the scene.
            tracker.update(
                [(np.array([5.0, 0, 1.0]), np.array([2.0, 0, 0]))],
                np.asarray(pose1),
            )
            import jax.numpy as jnp

            return jnp.zeros((len(pc0), 3)), 0.0

        estimate.trackers = trackers
        return estimate

    stats = estimate_scene_flow(str(root), model="_test_repair", verbose=False)
    assert stats["frames"] == 4  # 5 frames -> 4 pairs; repairs not counted
    assert len(calls) == 6  # 4 forward + repairs of pairs 0 and 1
    # The repair calls see a CONFIRMED track (backcast), where the original
    # pair-0 call saw none.
    assert calls[0][1] is False
    assert calls[-2][1] is True
    assert calls[-1][1] is True
