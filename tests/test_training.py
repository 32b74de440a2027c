"""SSL losses, pseudo-labels, and the data-parallel trainer (8-dev CPU mesh)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from himo_tpu.training.losses import SSLLossWeights, seflowpp_loss


class TestLoss:
    def _inputs(self, rng, n=256):
        pc0 = jnp.asarray(rng.uniform(-10, 10, size=(n, 3)), jnp.float32)
        pc1 = pc0 + jnp.asarray([0.1, 0.0, 0.0])
        valid = jnp.ones((n,), bool)
        dynamic = jnp.asarray(np.arange(n) < n // 4)
        cluster = jnp.asarray(
            np.where(np.arange(n) < n // 4, 1 + (np.arange(n) % 3), 0), jnp.int32
        )
        return pc0, pc1, valid, dynamic, cluster

    def test_zero_residual_on_aligned_clouds(self, rng):
        pc0, _, valid, dynamic, cluster = self._inputs(rng)
        flow = jnp.zeros_like(pc0)
        losses = seflowpp_loss(
            flow, pc0, pc0, valid, valid, dynamic, dynamic, cluster
        )
        assert float(losses["chamfer_dis"]) < 1e-3
        assert float(losses["static_flow_loss"]) == 0.0
        assert float(losses["cluster_based_pc0pc1"]) == 0.0

    def test_static_loss_penalizes_flow_on_static_points(self, rng):
        pc0, pc1, valid, dynamic, cluster = self._inputs(rng)
        flow = jnp.ones_like(pc0) * 0.5
        losses = seflowpp_loss(flow, pc0, pc1, valid, valid, dynamic, dynamic, cluster)
        assert float(losses["static_flow_loss"]) == pytest.approx(0.75, rel=1e-5)

    def test_cluster_loss_zero_for_rigid_flow(self, rng):
        pc0, pc1, valid, dynamic, cluster = self._inputs(rng)
        # Same flow within each cluster -> rigidity term must vanish.
        flow = jnp.asarray(np.asarray(cluster)[:, None] * 0.1, jnp.float32).repeat(3, 1)
        losses = seflowpp_loss(flow, pc0, pc1, valid, valid, dynamic, dynamic, cluster)
        assert float(losses["cluster_based_pc0pc1"]) < 1e-9

    def test_cluster_loss_positive_for_nonrigid_flow(self, rng):
        pc0, pc1, valid, dynamic, cluster = self._inputs(rng)
        flow = jnp.asarray(rng.normal(size=pc0.shape), jnp.float32)
        losses = seflowpp_loss(flow, pc0, pc1, valid, valid, dynamic, dynamic, cluster)
        assert float(losses["cluster_based_pc0pc1"]) > 0.1

    def test_gradient_finite(self, rng):
        pc0, pc1, valid, dynamic, cluster = self._inputs(rng)

        def total(flow):
            return seflowpp_loss(
                flow, pc0, pc1, valid, valid, dynamic, dynamic, cluster
            )["total"]

        g = jax.grad(total)(jnp.zeros_like(pc0))
        assert np.all(np.isfinite(np.asarray(g)))

    def test_gate_bce_matches_labels(self, rng):
        from himo_tpu.training.losses import gate_bce_loss

        n = 128
        dynamic = jnp.asarray(np.arange(n) < n // 2)
        valid = jnp.ones((n,), bool)
        # Logits agreeing with the labels at high confidence -> ~0 loss;
        # disagreeing -> ~|logit| per point.
        agree = jnp.where(dynamic, 20.0, -20.0)
        assert float(gate_bce_loss(agree, dynamic, valid)) < 1e-6
        disagree = jnp.where(dynamic, -20.0, 20.0)
        assert float(gate_bce_loss(disagree, dynamic, valid)) == pytest.approx(
            20.0, rel=1e-3
        )
        # Invalid rows are excluded.
        half = jnp.asarray(np.arange(n) < n // 2)
        assert float(gate_bce_loss(disagree, dynamic, valid & half)) == pytest.approx(
            20.0, rel=1e-3
        )

    def test_gate_term_enters_total(self, rng):
        pc0, pc1, valid, dynamic, cluster = self._inputs(rng)
        flow = jnp.zeros_like(pc0)
        logits = jnp.zeros((pc0.shape[0],))
        base = seflowpp_loss(flow, pc0, pc1, valid, valid, dynamic, dynamic, cluster)
        gated = seflowpp_loss(
            flow, pc0, pc1, valid, valid, dynamic, dynamic, cluster,
            gate_logit0=logits,
        )
        assert "gate_loss" not in base
        assert float(gated["gate_loss"]) == pytest.approx(np.log(2.0), rel=1e-4)
        assert float(gated["total"]) == pytest.approx(
            float(base["total"]) + np.log(2.0), rel=1e-4
        )


class TestSSLLabels:
    def test_dynamic_and_cluster_labels(self, rng):
        from himo_tpu.training.ssl_labels import (
            cluster_dynamic_points,
            dynamic_mask_from_nn,
        )

        static = rng.uniform(-10, 0, size=(500, 3)).astype(np.float32)
        blob = (rng.normal(scale=0.5, size=(60, 3)) + [5, 5, 1]).astype(np.float32)
        pc0 = np.concatenate([static, blob])
        pc1 = np.concatenate([static, blob + 2.0])  # blob moved 2m
        dyn = dynamic_mask_from_nn(pc0, pc1, threshold=0.3)
        assert dyn[500:].mean() > 0.9  # blob flagged dynamic
        assert dyn[:500].mean() < 0.05  # static mostly clean
        clusters = cluster_dynamic_points(pc0, dyn, eps=0.8, min_samples=5)
        assert clusters[500:].max() >= 1
        assert (clusters[:500] == 0).all()

    def test_shell_clusters_whole_and_neighbors_separate(self, rng):
        """A hollow box shell (a vehicle's one-sided LiDAR return) must
        come back as ONE cluster — HDBSCAN alone splits it at the creases
        into face fragments whose per-face rigid ICP slides — while two
        boxes a real gap apart stay separate."""
        from himo_tpu.data.synthetic import _sample_box_points
        from himo_tpu.training.ssl_labels import cluster_dynamic_points

        box = _sample_box_points(rng, 150, np.array([4.5, 2.0, 1.6]))
        a = (box + [6, 3, 1]).astype(np.float32)
        b = (box + [6, 6.3, 1]).astype(np.float32)  # 1.3 m face gap
        pts = np.concatenate([a, b])
        labels = cluster_dynamic_points(
            pts, np.ones(len(pts), bool), eps=1.2, min_samples=5
        )
        la, ca = np.unique(labels[:150][labels[:150] > 0], return_counts=True)
        lb, cb = np.unique(labels[150:][labels[150:] > 0], return_counts=True)
        # Each box: one dominant cluster covering >=80% of its points.
        assert ca.max() >= 0.8 * 150 and cb.max() >= 0.8 * 150
        # And they are different clusters.
        assert la[np.argmax(ca)] != lb[np.argmax(cb)]

    def test_single_object_clusters(self, rng):
        """One lone dynamic object must still cluster (HDBSCAN's eom never
        selects the root — the allow_single_cluster retry covers it)."""
        from himo_tpu.training.ssl_labels import cluster_dynamic_points

        blob = (rng.normal(scale=0.5, size=(60, 3)) + [5, 5, 1]).astype(
            np.float32
        )
        labels = cluster_dynamic_points(
            blob, np.ones(60, bool), eps=0.8, min_samples=5
        )
        assert (labels > 0).mean() > 0.9

    def test_coherence_prune_kills_isolated_flags(self, rng):
        """Scattered false-dynamic flags (subsample dropouts) are pruned by
        the 5-NN coherence vote; a coherent moving blob survives."""
        from himo_tpu.training.ssl_labels import dynamic_mask_from_nn

        static = rng.uniform(-20, 20, size=(2000, 3)).astype(np.float32)
        blob = (rng.normal(scale=0.5, size=(80, 3)) + [25, 0, 1]).astype(
            np.float32
        )
        pc0 = np.concatenate([static, blob])
        # pc1: drop 5% of statics (isolated dropouts) and move the blob.
        keep = rng.uniform(size=2000) > 0.05
        pc1 = np.concatenate([static[keep], blob + 2.5])
        dyn = dynamic_mask_from_nn(pc0, pc1, threshold=0.3)
        assert dyn[2000:].mean() > 0.9  # blob kept
        assert dyn[:2000].mean() < 0.01  # dropout scatter pruned

    def test_write_labels_roundtrip(self, tmp_path):
        import h5py

        from himo_tpu.data.synthetic import make_dataset
        from himo_tpu.training.ssl_labels import write_ssl_labels

        root = tmp_path / "av2_ssl"
        make_dataset(root, num_scenes=1, num_frames=3, seed=2, num_background=1000)
        n = write_ssl_labels(root, verbose=False)
        assert n == 3
        with h5py.File(next(root.glob("*.h5")), "r") as f:
            key = sorted(f.keys())[0]
            assert "ssl_dynamic" in f[key]
            assert "ssl_cluster" in f[key]
            # The two 15-22 m/s objects must be flagged dynamic.
            dyn = f[key]["ssl_dynamic"][()]
            inst = f[key]["flow_instance_id"][()]
            assert dyn[inst > 0].mean() > 0.5


def test_train_smoke_on_mesh(tmp_path, monkeypatch):
    """Two epochs of tiny SeFlow++ on the virtual 8-device mesh."""
    import jax

    from himo_tpu.data.synthetic import make_dataset
    from himo_tpu.ops.voxelize import PillarConfig
    from himo_tpu.training.ssl_labels import write_ssl_labels
    from himo_tpu.training.trainer import TrainConfig, train

    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    root = tmp_path / "av2_train"
    make_dataset(root, num_scenes=2, num_frames=6, seed=4, num_background=800)
    write_ssl_labels(root, verbose=False)

    config = TrainConfig(
        model="seflowpp",
        batch_size=8,
        epochs=2,
        num_points=2048,
        log_every=1,
        lr=1e-3,
    )
    result = train(
        str(root),
        config,
        run_dir=str(tmp_path / "run"),
        model_overrides=dict(
            pillar=PillarConfig(
                x_range=(-25.6, 25.6), y_range=(-25.6, 25.6), voxel_size=(0.8, 0.8)
            ),
            depths=(16, 32),
            point_feat_dim=8,
            base_channels=8,
        ),
    )
    assert result["steps"] == 2 * (10 // 8)
    assert np.isfinite(result["final_metrics"]["total"])
    # Checkpoints + metrics written.
    assert (tmp_path / "run" / "metrics.jsonl").exists()
    assert any((tmp_path / "run" / "ckpts").iterdir())


def test_trainer_resume_from_checkpoint(tmp_path):
    """A second train() call with resume=True continues from the saved step."""
    from himo_tpu.data.synthetic import make_dataset
    from himo_tpu.ops.voxelize import PillarConfig
    from himo_tpu.training.trainer import TrainConfig, train

    root = tmp_path / "av2_resume"
    make_dataset(root, num_scenes=2, num_frames=6, seed=3, num_background=600)
    overrides = dict(
        pillar=PillarConfig(
            x_range=(-25.6, 25.6), y_range=(-25.6, 25.6), voxel_size=(0.8, 0.8)
        ),
        depths=(16, 32),
        point_feat_dim=8,
        base_channels=8,
    )
    config = TrainConfig(
        model="seflowpp", batch_size=8, epochs=2, num_points=1024, log_every=1
    )
    run_dir = str(tmp_path / "run")
    first = train(str(root), config, run_dir=run_dir, model_overrides=overrides)
    assert first["steps"] == 2  # 10 frames -> 1 batch/epoch x 2 epochs
    # Resuming a COMPLETED run is a no-op (start epoch == epochs).
    same = train(str(root), config, run_dir=run_dir, model_overrides=overrides)
    assert same["steps"] == 2
    # Extending the budget resumes at the saved step/opt state and trains
    # only the remaining epochs.
    import dataclasses

    longer = dataclasses.replace(config, epochs=4)
    second = train(str(root), longer, run_dir=run_dir, model_overrides=overrides)
    assert second["steps"] == 4


def test_checkpoint_retention_tracks_best_metric(tmp_path):
    """Top-k retention keeps the BEST val-metric checkpoints, not the latest
    (reference: save_top_model=3 with val_every=3)."""
    import jax.numpy as jnp

    from himo_tpu.training.checkpoints import CheckpointManager

    mgr = CheckpointManager(tmp_path / "ck", keep=2, best_metric="val_total")
    vals = {1: 5.0, 2: 1.0, 3: 4.0, 4: 0.5, 5: 3.0}
    for step, v in vals.items():
        mgr.save(
            step,
            {"params": {"w": jnp.full((2,), float(step))}},
            metrics={"val_total": v},
        )
    kept = sorted(mgr.all_steps())
    mgr.close()
    assert kept == [2, 4], f"expected the two best-val steps, got {kept}"


def test_train_validation_loop_and_split(tmp_path):
    """With enough frames, train() holds out a val split, computes val
    SSL-loss + EPE, and retains checkpoints by val metric."""
    import json

    from himo_tpu.data.synthetic import make_dataset
    from himo_tpu.ops.voxelize import PillarConfig
    from himo_tpu.training.trainer import TrainConfig, split_train_val, train

    # unit: split is deterministic, disjoint, whole batches
    tr, va = split_train_val(34, 8, 0.1)
    assert len(va) == 8 and len(tr) == 26
    assert set(tr).isdisjoint(va)

    root = tmp_path / "av2_val"
    make_dataset(root, num_scenes=2, num_frames=18, seed=5, num_background=500)
    config = TrainConfig(
        model="seflowpp",
        batch_size=8,
        epochs=1,
        num_points=1024,
        log_every=1,
        val_every=1,
    )
    result = train(
        str(root),
        config,
        run_dir=str(tmp_path / "run"),
        model_overrides=dict(
            pillar=PillarConfig(
                x_range=(-25.6, 25.6), y_range=(-25.6, 25.6), voxel_size=(0.8, 0.8)
            ),
            depths=(16, 32),
            point_feat_dim=8,
            base_channels=8,
        ),
    )
    fm = result["final_metrics"]
    assert np.isfinite(fm["val_total"]) and np.isfinite(fm["val_epe"])
    assert fm["val_epe"] > 0.0  # untrained model cannot have 0 error
    lines = [
        json.loads(line)
        for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()
    ]
    assert any("val/val_epe" in ln for ln in lines)


def test_dufo_labels_beat_nn(tmp_path):
    """Occupancy-change (DUFOMap-style) fused labels keep perfect precision
    and beat the NN-residual labels' F1 against GT dynamic masks."""
    import h5py

    from himo_tpu.core.transforms import rigid_flow
    from himo_tpu.data.dataset import SceneFlowDataset
    from himo_tpu.data.synthetic import make_dataset
    from himo_tpu.training.ssl_labels import (
        label_frame,
        write_ssl_labels_dufo,
    )

    root = tmp_path / "av2_dufo"
    make_dataset(root, num_scenes=1, num_frames=6, seed=9, num_background=3000)
    write_ssl_labels_dufo(root, verbose=False)

    def prf(pred, gt):
        tp = (pred & gt).sum()
        fp = (pred & ~gt).sum()
        fn = (~pred & gt).sum()
        p = tp / max(tp + fp, 1)
        r = tp / max(tp + fn, 1)
        return p, r, 2 * p * r / max(p + r, 1e-9)

    ds = SceneFlowDataset(root, with_pc1=True, extra_keys=("ssl_dynamic",))
    f1s = {"nn": [], "dufo": []}
    precs = []
    for i in range(len(ds)):
        d = ds[i]
        pflow = rigid_flow(d["pc0"][:, :3], d["pose0"], d["pose1"])
        res = d["flow"][:, :3] - pflow
        gt = (np.linalg.norm(res, axis=1) / 0.1 > 0.5) & ~np.asarray(d["gm0"], bool)
        nn_dyn, _ = label_frame(d)
        du_dyn = np.asarray(d["ssl_dynamic"], bool)
        f1s["nn"].append(prf(nn_dyn, gt)[2])
        p, _, f1 = prf(du_dyn, gt)
        precs.append(p)
        f1s["dufo"].append(f1)
    assert np.mean(f1s["dufo"]) > np.mean(f1s["nn"]), f1s
    assert np.mean(precs) > 0.95


def test_async_checkpointing_overlaps_and_drains(tmp_path):
    """Async saves return before the write is durable, drain on the next
    save/close, and every checkpoint restores intact."""
    import time

    import jax.numpy as jnp

    from himo_tpu.training.checkpoints import CheckpointManager

    big = {"params": {"w": jnp.arange(2_000_000, dtype=jnp.float32)}}
    mgr = CheckpointManager(tmp_path / "ck", keep=5, async_save=True)
    t0 = time.perf_counter()
    mgr.save(1, big)
    async_return = time.perf_counter() - t0
    mgr.save(2, {"params": {"w": big["params"]["w"] * 2}})
    mgr.close()

    sync = CheckpointManager(tmp_path / "ck_sync", keep=5, async_save=False)
    t0 = time.perf_counter()
    sync.save(1, big)
    sync_return = time.perf_counter() - t0
    sync.close()
    # The async call should give control back faster than the durable one
    # (not asserted strictly — filesystems vary — but both must restore).
    del async_return, sync_return

    mgr2 = CheckpointManager(tmp_path / "ck", keep=5)
    step, tree = mgr2.restore_latest()
    mgr2.close()
    assert step == 2
    np.testing.assert_allclose(
        np.asarray(tree["params"]["w"][:5]), np.arange(5) * 2.0
    )


def test_resume_uses_latest_not_best(tmp_path):
    """With best-metric retention pruning recent steps, resume still picks
    up from the most recent save (the ckpts_latest manager)."""
    import jax.numpy as jnp

    from himo_tpu.training.checkpoints import CheckpointManager

    run = tmp_path / "run"
    best = CheckpointManager(run / "ckpts", keep=1, best_metric="val_total")
    latest = CheckpointManager(run / "ckpts_latest", keep=1)
    # step 100 has the BEST val; step 200 is newest but worse.
    for step, v in ((100, 0.1), (200, 5.0)):
        tree = {"params": {"w": jnp.full((2,), float(step))}, "step": step}
        best.save(step, tree, metrics={"val_total": v})
        latest.save(step, tree)
    best.close()
    latest.close()
    # best-k retention kept only step 100...
    b = CheckpointManager(run / "ckpts", keep=1, best_metric="val_total")
    assert b.all_steps() == [100]
    b.close()
    # ...but the resume manager returns the true latest.
    l2 = CheckpointManager(run / "ckpts_latest", keep=1)
    step, tree = l2.restore_latest()
    l2.close()
    assert step == 200 and float(tree["params"]["w"][0]) == 200.0
