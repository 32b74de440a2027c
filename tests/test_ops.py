"""Device ops: NN search, pillar voxelization, points-in-boxes."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from himo_tpu.ops.nn import (
    chamfer_distance,
    nn_distance_sq,
    nn_distance_sq_reference,
    truncated_chamfer,
)
from himo_tpu.ops.points_in_boxes import points_in_boxes
from himo_tpu.ops.voxelize import (
    PillarConfig,
    gather_pillars,
    scatter_max,
    scatter_mean,
    voxelize_pillars,
)


class TestNN:
    def test_matches_dense_reference(self, rng):
        q = rng.normal(scale=10, size=(300, 3)).astype(np.float32)
        r = rng.normal(scale=10, size=(700, 3)).astype(np.float32)
        got = np.asarray(nn_distance_sq(q, r))
        want = np.asarray(nn_distance_sq_reference(q, r))
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-3)

    def test_exact_zero_for_identical_clouds(self, rng):
        pts = rng.normal(scale=5, size=(256, 3)).astype(np.float32)
        d2 = np.asarray(nn_distance_sq(pts, pts))
        assert d2.max() < 1e-3

    def test_respects_ref_valid_mask(self, rng):
        q = np.zeros((4, 3), dtype=np.float32)
        r = np.array([[0.0, 0, 0], [5.0, 0, 0]], dtype=np.float32)
        ref_valid = np.array([False, True])
        d2 = np.asarray(nn_distance_sq(q, r, ref_valid=ref_valid))
        np.testing.assert_allclose(d2, 25.0, rtol=1e-4)

    def test_query_valid_masks_output(self, rng):
        q = rng.normal(size=(10, 3)).astype(np.float32)
        r = rng.normal(size=(20, 3)).astype(np.float32)
        qv = np.arange(10) < 5
        d2 = np.asarray(nn_distance_sq(q, r, query_valid=qv))
        assert np.all(d2[5:] == 0.0)

    def test_chamfer_symmetric_and_zero_on_self(self, rng):
        pc = rng.normal(scale=3, size=(200, 3)).astype(np.float32)
        assert float(chamfer_distance(pc, pc)) < 1e-2
        pc2 = pc + np.array([0.5, 0, 0], dtype=np.float32)
        c12 = float(chamfer_distance(pc, pc2))
        c21 = float(chamfer_distance(pc2, pc))
        assert c12 == pytest.approx(c21, rel=1e-5)

    def test_truncated_chamfer_caps_outliers(self, rng):
        pc1 = rng.normal(size=(50, 3)).astype(np.float32)
        pc2 = pc1 + 1000.0  # everything far away
        loss = float(truncated_chamfer(pc1, pc2, max_dist=2.0))
        assert loss == pytest.approx(2 * 4.0, rel=1e-5)  # both directions capped

    def test_gradient_flows(self, rng):
        import jax

        pc1 = jnp.asarray(rng.normal(size=(64, 3)), dtype=jnp.float32)
        pc2 = pc1 + jnp.asarray([1.0, 0.0, 0.0])

        def loss(flow):
            return truncated_chamfer(pc1 + flow, pc2, max_dist=5.0)

        g = jax.grad(loss)(jnp.zeros_like(pc1))
        assert np.all(np.isfinite(np.asarray(g)))
        # Moving toward pc2 (+x) decreases the loss -> gradient points to -x.
        assert np.asarray(g)[:, 0].mean() < 0


class TestVoxelize:
    def test_pillar_assignment(self):
        cfg = PillarConfig(
            x_range=(-2.0, 2.0), y_range=(-2.0, 2.0), voxel_size=(1.0, 1.0)
        )
        pts = np.array(
            [
                [-1.5, -1.5, 0.0],  # pillar (0, 0)
                [1.5, 1.5, 0.0],  # pillar (3, 3)
                [0.1, 0.1, 0.0],  # pillar (2, 2)
                [5.0, 0.0, 0.0],  # out of range
                [0.0, 0.0, 10.0],  # out of z range
            ],
            dtype=np.float32,
        )
        grid = voxelize_pillars(pts, config=cfg)
        assert grid.grid_shape == (4, 4)
        ids = np.asarray(grid.pillar_ids)
        assert ids[0] == 0
        assert ids[1] == 3 * 4 + 3
        assert ids[2] == 2 * 4 + 2
        assert np.asarray(grid.in_range).tolist() == [True, True, True, False, False]

    def test_scatter_mean_and_max(self, rng):
        cfg = PillarConfig(
            x_range=(0.0, 2.0), y_range=(0.0, 1.0), voxel_size=(1.0, 1.0)
        )
        pts = np.array(
            [[0.5, 0.5, 0.0], [0.6, 0.5, 0.0], [1.5, 0.5, 0.0]], dtype=np.float32
        )
        feats = np.array([[1.0], [3.0], [10.0]], dtype=np.float32)
        grid = voxelize_pillars(pts, config=cfg)
        mean_img = np.asarray(scatter_mean(feats, grid))
        max_img = np.asarray(scatter_max(feats, grid))
        assert mean_img.shape == (1, 2, 1)
        assert mean_img[0, 0, 0] == pytest.approx(2.0)
        assert mean_img[0, 1, 0] == pytest.approx(10.0)
        assert max_img[0, 0, 0] == pytest.approx(3.0)

    def test_gather_roundtrip(self, rng):
        cfg = PillarConfig(
            x_range=(-8.0, 8.0), y_range=(-8.0, 8.0), voxel_size=(0.5, 0.5)
        )
        pts = rng.uniform(-7.9, 7.9, size=(500, 3)).astype(np.float32)
        pts[:, 2] = 0.0
        grid = voxelize_pillars(pts, config=cfg)
        feats = np.ones((500, 4), dtype=np.float32)
        img = scatter_mean(feats, grid)
        back = np.asarray(gather_pillars(img, grid))
        np.testing.assert_allclose(back, 1.0, rtol=1e-6)

    def test_default_config_matches_reference_training(self):
        cfg = PillarConfig()
        assert cfg.grid_shape == (512, 512)


class TestPointsInBoxes:
    def test_axis_aligned(self):
        boxes = np.array([[0.0, 0.0, 0.0, 4.0, 2.0, 2.0, 0.0]], dtype=np.float32)
        pts = np.array(
            [
                [0.0, 0.0, 1.0],  # inside
                [1.9, 0.9, 1.9],  # inside near corner
                [2.1, 0.0, 1.0],  # outside x
                [0.0, 0.0, -0.1],  # below bottom
                [0.0, 0.0, 2.1],  # above top
            ],
            dtype=np.float32,
        )
        got = np.asarray(points_in_boxes(pts, boxes))
        np.testing.assert_array_equal(got, [0, 0, -1, -1, -1])

    def test_rotated_box(self):
        # 4x2 box rotated 90deg: now long along y.
        boxes = np.array(
            [[0.0, 0.0, 0.0, 4.0, 2.0, 2.0, np.pi / 2]], dtype=np.float32
        )
        pts = np.array(
            [[0.0, 1.9, 1.0], [1.9, 0.0, 1.0]], dtype=np.float32
        )
        got = np.asarray(points_in_boxes(pts, boxes))
        np.testing.assert_array_equal(got, [0, -1])

    def test_first_match_and_valid_mask(self):
        boxes = np.array(
            [
                [0.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.0],
                [0.0, 0.0, 0.0, 4.0, 4.0, 4.0, 0.0],
            ],
            dtype=np.float32,
        )
        pts = np.array([[0.0, 0.0, 1.0], [1.5, 1.5, 1.0]], dtype=np.float32)
        got = np.asarray(points_in_boxes(pts, boxes))
        np.testing.assert_array_equal(got, [0, 1])
        got_masked = np.asarray(
            points_in_boxes(pts, boxes, boxes_valid=np.array([False, True]))
        )
        np.testing.assert_array_equal(got_masked, [1, 1])


class TestNNGradients:
    def test_custom_vjp_matches_dense_autodiff(self, rng):
        import jax
        import jax.numpy as jnp
        from himo_tpu.ops.nn import nn_distance_sq, nn_distance_sq_reference

        q = jnp.asarray(rng.normal(scale=3, size=(40, 3)), jnp.float32)
        r = jnp.asarray(rng.normal(scale=3, size=(70, 3)), jnp.float32)

        def loss_custom(q, r):
            return jnp.sum(nn_distance_sq(q, r))

        def loss_dense(q, r):
            return jnp.sum(nn_distance_sq_reference(q, r))

        gq_c, gr_c = jax.grad(loss_custom, argnums=(0, 1))(q, r)
        gq_d, gr_d = jax.grad(loss_dense, argnums=(0, 1))(q, r)
        np.testing.assert_allclose(np.asarray(gq_c), np.asarray(gq_d), atol=1e-3)
        np.testing.assert_allclose(np.asarray(gr_c), np.asarray(gr_d), atol=1e-3)

    def test_masked_points_get_zero_grad(self, rng):
        import jax
        import jax.numpy as jnp
        from himo_tpu.ops.nn import nn_distance_sq

        q = jnp.asarray(rng.normal(size=(20, 3)), jnp.float32)
        r = jnp.asarray(rng.normal(size=(30, 3)), jnp.float32)
        qv = jnp.asarray(np.arange(20) < 10)
        rv = jnp.asarray(np.arange(30) < 15)

        def loss(q, r):
            return jnp.sum(nn_distance_sq(q, r, qv, rv))

        gq, gr = jax.grad(loss, argnums=(0, 1))(q, r)
        np.testing.assert_allclose(np.asarray(gq)[10:], 0.0)
        np.testing.assert_allclose(np.asarray(gr)[15:], 0.0)


class TestFusedChamfer:
    """fused_masked_nn == two separate truncated_chamfer calls (fwd + grad)."""

    def _clouds(self, rng, n=300, m=420):
        import jax.numpy as jnp

        q = jnp.asarray(rng.normal(scale=10, size=(n, 3)), jnp.float32)
        r = jnp.asarray(rng.normal(scale=10, size=(m, 3)), jnp.float32)
        v0 = jnp.asarray(rng.random(n) < 0.9)
        v1 = jnp.asarray(rng.random(m) < 0.9)
        d0 = jnp.asarray(rng.random(n) < 0.3)
        d1 = jnp.asarray(rng.random(m) < 0.3)
        return q, r, v0, v1, d0, d1

    def _ref_terms(self, q, r, v0, v1, d0, d1, max_dist=2.0):
        from himo_tpu.ops.nn import truncated_chamfer

        all_t = truncated_chamfer(q, r, valid1=v0, valid2=v1, max_dist=max_dist)
        dyn_t = truncated_chamfer(
            q, r, valid1=v0 & d0, valid2=v1 & d1, max_dist=max_dist
        )
        return all_t, dyn_t

    def test_forward_matches_separate_calls(self, rng):
        from himo_tpu.ops.nn import fused_chamfer_terms

        q, r, v0, v1, d0, d1 = self._clouds(rng)
        got = fused_chamfer_terms(q, r, v0, v1, d0, d1)
        want = self._ref_terms(q, r, v0, v1, d0, d1)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5)

    def test_gradients_match_separate_calls(self, rng):
        import jax

        from himo_tpu.ops.nn import fused_chamfer_terms

        q, r, v0, v1, d0, d1 = self._clouds(rng, n=200, m=260)

        def loss_fused(q, r):
            a, d = fused_chamfer_terms(q, r, v0, v1, d0, d1)
            return a + 0.5 * d

        def loss_sep(q, r):
            a, d = self._ref_terms(q, r, v0, v1, d0, d1)
            return a + 0.5 * d

        gf = jax.grad(loss_fused, argnums=(0, 1))(q, r)
        gs = jax.grad(loss_sep, argnums=(0, 1))(q, r)
        np.testing.assert_allclose(np.asarray(gf[0]), np.asarray(gs[0]), atol=1e-4)
        np.testing.assert_allclose(np.asarray(gf[1]), np.asarray(gs[1]), atol=1e-4)

    def test_all_masked_side_is_finite(self, rng):
        import jax

        from himo_tpu.ops.nn import fused_chamfer_terms

        q, r, v0, v1, _, _ = self._clouds(rng, n=130, m=140)
        zeros_d = jnp.zeros(130, bool), jnp.zeros(140, bool)
        a, d = fused_chamfer_terms(q, r, v0, v1, *zeros_d)
        assert np.isfinite(float(a)) and np.isfinite(float(d))
        g = jax.grad(lambda q: fused_chamfer_terms(q, r, v0, v1, *zeros_d)[1])(q)
        assert np.isfinite(np.asarray(g)).all()


class TestUpsampleNearest:
    def test_matches_resize(self):
        from himo_tpu.models.feedforward import _upsample_nearest

        rng = np.random.default_rng(13)
        x = jnp.asarray(rng.normal(size=(2, 8, 8, 5)).astype(np.float32))
        fast = _upsample_nearest(x, 16, 16)
        ref = jax.image.resize(x, (2, 16, 16, 5), "nearest")
        np.testing.assert_allclose(np.asarray(fast), np.asarray(ref), atol=0)

    def test_non_integer_ratio_falls_back(self):
        from himo_tpu.models.feedforward import _upsample_nearest

        x = jnp.ones((4, 6, 3))
        out = _upsample_nearest(x, 9, 9)
        assert out.shape == (9, 9, 3)
