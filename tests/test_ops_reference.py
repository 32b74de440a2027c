"""Public NN / k-NN / pillar ops against float64 and numpy references:
query chunking and padding, masks and penalties, ties, gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from himo_tpu.ops import nn as NN
from himo_tpu.ops.knn import knn_distance_sq
from himo_tpu.ops.voxelize import (
    PillarGrid,
    gather_pillars,
    scatter_max,
    scatter_mean,
)


def brute_d2(q, r):
    q = np.asarray(q, np.float64)[:, :3]
    r = np.asarray(r, np.float64)[:, :3]
    return ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1)


def assert_nn(d2, idx, ref):
    """Distances within 1e-5 relative of float64; indices equal wherever the
    best and second-best reference distances differ by > 1e-4 m^2."""
    best = np.sort(ref, axis=1)
    d2 = np.asarray(d2, np.float64)
    assert (np.abs(d2 - best[:, 0]) <= 1e-5 * np.maximum(best[:, 0], 1.0)).all()
    if idx is not None:
        sep = best[:, 1] - best[:, 0] > 1e-4
        assert (np.asarray(idx)[sep] == ref.argmin(1)[sep]).all()


@pytest.fixture
def small_chunks(monkeypatch):
    """Force the query chunking (and its padding) at test sizes."""
    monkeypatch.setattr(NN, "_PAIR_BUDGET", 1 << 12)


class TestNNSearch:
    @pytest.mark.parametrize("n,m", [(1, 5), (37, 300), (300, 37), (513, 129)])
    def test_matches_float64_bruteforce_chunked(self, rng, small_chunks, n, m):
        q = rng.normal(scale=30, size=(n, 3)).astype(np.float32)
        r = rng.normal(scale=30, size=(m, 3)).astype(np.float32)
        d2, idx = NN.nn_search(jnp.asarray(q), jnp.asarray(r))
        assert d2.shape == (1, n) and idx.shape == (1, n)
        assert d2.dtype == jnp.float32 and idx.dtype == jnp.int32
        assert_nn(d2[0], idx[0], brute_d2(q, r))

    def test_penalty_rows_match_masked_bruteforce(self, rng, small_chunks):
        q = rng.normal(scale=20, size=(200, 3)).astype(np.float32)
        r = rng.normal(scale=20, size=(150, 3)).astype(np.float32)
        masks = rng.random((2, 150)) < np.array([[0.9], [0.3]])
        pens = jnp.where(jnp.asarray(masks), 0.0, NN._MASK_BIG)
        d2, idx = NN.nn_search(jnp.asarray(q), jnp.asarray(r), pens)
        full = brute_d2(q, r)
        for p in range(2):
            ref = np.where(masks[p][None, :], full, np.inf)
            assert_nn(d2[p], idx[p], ref)

    def test_ties_pick_the_first_reference(self):
        r = np.array([[1, 0, 0], [5, 5, 5], [1, 0, 0], [-1, 0, 0]], np.float32)
        q = np.zeros((3, 3), np.float32)
        d2, idx = NN.nn_argmin(q, r)
        np.testing.assert_array_equal(np.asarray(idx), [0, 0, 0])
        np.testing.assert_array_equal(np.asarray(d2), [1.0, 1.0, 1.0])

    def test_nn_argmin_masks(self, rng):
        q = rng.normal(size=(40, 3)).astype(np.float32)
        r = rng.normal(size=(60, 3)).astype(np.float32)
        qv = np.arange(40) % 3 != 0
        rv = np.arange(60) % 2 == 0
        d2, idx = NN.nn_argmin(q, r, qv, rv)
        ref = np.where(rv[None, :], brute_d2(q, r), np.inf)
        assert_nn(np.asarray(d2)[qv], np.asarray(idx)[qv], ref[qv])
        assert (np.asarray(d2)[~qv] == 0).all() and (np.asarray(idx)[~qv] == 0).all()
        assert rv[np.asarray(idx)[qv]].all()

    def test_lidar_scale_coordinates_stay_exact(self, rng):
        """Difference form: no |q|^2+|r|^2-2qr cancellation at 50 m."""
        base = np.array([48.0, -37.0, 1.5], np.float32)
        q = base + rng.normal(scale=0.05, size=(64, 3)).astype(np.float32)
        r = base + rng.normal(scale=0.05, size=(64, 3)).astype(np.float32)
        d2 = NN.nn_distance_sq(q, r)
        assert_nn(d2, None, brute_d2(q, r))

    def test_gradient_matches_dense_autodiff_chunked(self, rng, small_chunks):
        q = jnp.asarray(rng.normal(scale=3, size=(90, 3)), jnp.float32)
        r = jnp.asarray(rng.normal(scale=3, size=(70, 3)), jnp.float32)
        g = jax.grad(lambda q, r: jnp.sum(NN.nn_distance_sq(q, r)), (0, 1))(q, r)
        gd = jax.grad(
            lambda q, r: jnp.sum(NN.nn_distance_sq_reference(q, r)), (0, 1)
        )(q, r)
        for a, b in zip(g, gd):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)

    def test_fused_masked_nn_matches_bruteforce(self, rng, small_chunks):
        q = rng.normal(scale=10, size=(120, 3)).astype(np.float32)
        r = rng.normal(scale=10, size=(90, 3)).astype(np.float32)
        qm = rng.random((2, 120)) < np.array([[0.9], [0.4]])
        rm = rng.random((2, 90)) < np.array([[0.9], [0.4]])
        pen = lambda m: jnp.where(jnp.asarray(m), 0.0, NN._MASK_BIG)  # noqa: E731
        outs = NN.fused_masked_nn(
            jnp.asarray(q), jnp.asarray(r), pen(qm[0]), pen(qm[1]), pen(rm[0]),
            pen(rm[1]),
        )
        full = brute_d2(q, r)
        refs = (
            np.where(rm[0][None], full, np.inf),
            np.where(rm[1][None], full, np.inf),
            np.where(qm[0][None], full.T, np.inf),
            np.where(qm[1][None], full.T, np.inf),
        )
        for out, ref in zip(outs, refs):
            assert_nn(out, None, ref)


class TestKNN:
    @pytest.mark.parametrize("k", [1, 4, 8])
    def test_matches_float64_bruteforce_chunked(self, rng, small_chunks, k):
        q = rng.normal(scale=8, size=(130, 3)).astype(np.float32)
        r = rng.normal(scale=8, size=(77, 3)).astype(np.float32)
        got = np.asarray(knn_distance_sq(q, r, k), np.float64)
        want = np.sort(brute_d2(q, r), axis=1)[:, :k]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_masks_with_chunking(self, rng, small_chunks):
        q = rng.normal(size=(100, 3)).astype(np.float32)
        r = rng.normal(size=(80, 3)).astype(np.float32)
        qv = rng.random(100) < 0.8
        rv = rng.random(80) < 0.5
        got = np.asarray(knn_distance_sq(q, r, 3, qv, rv), np.float64)
        want = np.sort(np.where(rv[None], brute_d2(q, r), np.inf), axis=1)[:, :3]
        np.testing.assert_allclose(got[qv], want[qv], rtol=1e-5, atol=1e-6)
        assert (got[~qv] == 0).all()


# ----------------------------------------------------------- pillar ops


def _grid(rng, n, num_rows):
    """A PillarGrid over ``num_rows`` pillars (1 x num_rows image) with ~10%
    of the points out of range (trash segment)."""
    pids = rng.integers(0, num_rows, size=n).astype(np.int32)
    in_range = rng.random(n) < 0.9
    pids = np.where(in_range, pids, num_rows).astype(np.int32)
    grid = PillarGrid(
        jnp.asarray(pids), jnp.asarray(in_range), jnp.zeros((n, 3)), (1, num_rows)
    )
    return grid, pids, in_range


def _ref_scatter(pids, inr, feats, num_rows, combine):
    live = pids[inr]
    if combine == "max":
        out = np.full((num_rows, feats.shape[1]), -np.inf)
        np.maximum.at(out, live, feats[inr])
        return np.where(np.isfinite(out), out, 0.0)
    sums = np.zeros((num_rows, feats.shape[1]))
    np.add.at(sums, live, feats[inr].astype(np.float64))
    cnt = np.bincount(live, minlength=num_rows)
    return sums / np.maximum(cnt, 1)[:, None]


class TestPillarOps:
    @pytest.mark.parametrize("combine", ["max", "mean"])
    @pytest.mark.parametrize("num_rows", [1000, 7003])
    def test_scatter_matches_numpy(self, rng, combine, num_rows):
        grid, pids, inr = _grid(rng, 900, num_rows)
        feats = rng.normal(size=(900, 5)).astype(np.float32)
        op = scatter_max if combine == "max" else scatter_mean
        got = np.asarray(op(jnp.asarray(feats), grid)).reshape(num_rows, 5)
        want = _ref_scatter(pids, inr, feats, num_rows, combine)
        if combine == "max":
            np.testing.assert_array_equal(got, want.astype(np.float32))
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("combine", ["max", "mean"])
    @pytest.mark.parametrize("num_rows", [1002, 7007])
    def test_scatter_gradients_match_numpy(self, rng, combine, num_rows):
        grid, pids, inr = _grid(rng, 600, num_rows)
        feats = rng.normal(size=(600, 4)).astype(np.float32)
        w = rng.normal(size=(1, num_rows, 4)).astype(np.float32)
        op = scatter_max if combine == "max" else scatter_mean
        g = np.asarray(jax.grad(lambda f: jnp.sum(op(f, grid) * w))(jnp.asarray(feats)))
        safe = np.minimum(pids, num_rows - 1)
        wf = w.reshape(num_rows, 4)[safe]
        if combine == "max":
            img = _ref_scatter(pids, inr, feats, num_rows, "max")
            want = np.where((feats == img[safe]) & inr[:, None], wf, 0.0)
        else:
            cnt = np.bincount(pids[inr], minlength=num_rows)[safe]
            want = np.where(inr[:, None], wf / np.maximum(cnt, 1)[:, None], 0.0)
        np.testing.assert_allclose(g, want, rtol=1e-6, atol=1e-7)

    @pytest.mark.parametrize("num_rows", [1001, 7005])
    def test_gather_and_gradient_match_numpy(self, rng, num_rows):
        grid, pids, inr = _grid(rng, 700, num_rows)
        image = rng.normal(size=(1, num_rows, 6)).astype(np.float32)
        flat = image.reshape(num_rows, 6)
        got = np.asarray(gather_pillars(jnp.asarray(image), grid))
        safe = np.minimum(pids, num_rows - 1)
        np.testing.assert_array_equal(got, np.where(inr[:, None], flat[safe], 0.0))
        gout = rng.normal(size=(700, 6)).astype(np.float32)
        g = jax.grad(lambda i: jnp.sum(gather_pillars(i, grid) * gout))(jnp.asarray(image))
        want = np.zeros((num_rows, 6))
        np.add.at(want, pids[inr], gout[inr].astype(np.float64))
        np.testing.assert_allclose(
            np.asarray(g).reshape(num_rows, 6), want, rtol=1e-5, atol=1e-6
        )

    def test_batched_public_api_matches_loop(self, rng):
        from himo_tpu.ops.voxelize import PillarConfig, voxelize_pillars

        cfg = PillarConfig(
            x_range=(-16.0, 16.0), y_range=(-16.0, 16.0), voxel_size=(0.25, 0.25)
        )
        pts = rng.uniform(-17, 17, size=(2, 768, 3)).astype(np.float32)
        pts[..., 2] *= 0.1
        valid = rng.random((2, 768)) < 0.9
        feats = rng.normal(size=(2, 768, 3)).astype(np.float32)

        def one(p, v, f):
            grid = voxelize_pillars(p, v, cfg)
            img = scatter_max(f, grid)
            return img, gather_pillars(img, grid)

        imgs, backs = jax.vmap(one)(pts, valid, feats)
        for b in range(2):
            img, back = one(pts[b], valid[b], feats[b])
            np.testing.assert_array_equal(np.asarray(imgs[b]), np.asarray(img))
            np.testing.assert_array_equal(np.asarray(backs[b]), np.asarray(back))
