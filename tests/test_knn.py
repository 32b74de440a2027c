"""k-NN distances vs brute force + loss consumer."""

import numpy as np
import jax
import jax.numpy as jnp

from himo_tpu.ops.knn import knn_distance_sq, knn_smoothed_chamfer


class TestKNNDistances:
    def test_matches_bruteforce(self, rng):
        q = rng.normal(scale=5, size=(200, 3)).astype(np.float32)
        r = rng.normal(scale=5, size=(600, 3)).astype(np.float32)
        k = 4
        d2 = np.asarray(knn_distance_sq(q, r, k))
        brute = np.sort(((q[:, None, :] - r[None, :, :]) ** 2).sum(-1), axis=1)[:, :k]
        np.testing.assert_allclose(d2, brute, rtol=1e-3, atol=2e-3)

    def test_masks(self, rng):
        q = np.zeros((3, 3), np.float32)
        r = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0]], np.float32)
        d2 = np.asarray(
            knn_distance_sq(
                q, r, 2, ref_valid=np.array([False, True, True])
            )
        )
        np.testing.assert_allclose(d2, [[1.0, 4.0]] * 3, atol=1e-5)
        d2q = np.asarray(
            knn_distance_sq(q, r, 2, query_valid=np.array([True, False, True]))
        )
        np.testing.assert_allclose(d2q[1], 0.0)

    def test_ascending(self, rng):
        q = rng.normal(size=(130, 3)).astype(np.float32)
        r = rng.normal(size=(520, 3)).astype(np.float32)
        d2 = np.asarray(knn_distance_sq(q, r, 8))
        assert np.all(np.diff(d2, axis=1) >= -1e-6)


class TestSmoothedChamfer:
    def test_value_and_gradient(self, rng):
        a = rng.normal(size=(128, 3)).astype(np.float32)
        b = rng.normal(size=(512, 3)).astype(np.float32)
        va = np.ones(128, bool)
        vb = np.ones(512, bool)

        def loss(offset):
            return knn_smoothed_chamfer(
                jnp.asarray(a) + offset, jnp.asarray(b), k=4,
                valid1=jnp.asarray(va), valid2=jnp.asarray(vb),
            )

        val, grad = jax.value_and_grad(loss)(jnp.zeros(3))
        assert np.isfinite(float(val)) and val > 0
        assert np.all(np.isfinite(np.asarray(grad)))
        # k-mean value is >= the single-NN chamfer (extra neighbors farther).
        from himo_tpu.ops.nn import truncated_chamfer

        nn_val = truncated_chamfer(a, b, va, vb)
        assert float(val) >= float(nn_val) - 1e-5
