"""Corner-selected 2x2x2 gather: identical 5-NN recall to the 27-cell gather
within the LOAM search radius (the property registration correctness rests
on after the transaction-count optimization)."""

import numpy as np
import jax.numpy as jnp

from simpleslam_tpu.ops import pointcloud as pcops
from simpleslam_tpu.ops import voxel as vox


def test_corner_covers_search_ball(rng):
    pts = rng.uniform(-20, 20, size=(20000, 3)).astype(np.float32)
    pc = pcops.from_numpy(pts, 32768)
    queries = rng.uniform(-18, 18, size=(512, 3)).astype(np.float32)
    q = jnp.asarray(queries)
    q_mask = jnp.ones((512,), bool)

    dm = vox.build_dense_voxel_map(pc, 2.0, jnp.zeros(3, jnp.float32),
                                   (32, 32, 32), slab_size=64)
    cand, ok = vox.gather_neighbors_corner(dm, q, q_mask)
    d2 = np.asarray(jnp.where(ok, jnp.sum((cand - q[:, None, :]) ** 2, -1),
                              np.inf))
    got = np.sort(d2, axis=1)[:, :5]

    # brute-force 5-NN limited to the 1.0 m radius
    ref = np.full((512, 5), np.inf)
    for i, p in enumerate(queries):
        dd = np.sum((pts - p) ** 2, axis=1)
        dd = dd[dd <= 1.0]
        dd.sort()
        ref[i, :min(5, len(dd))] = dd[:5]

    inside = ref < 1.0
    np.testing.assert_allclose(np.where(inside, got, 0.0),
                               np.where(inside, ref, 0.0), rtol=1e-5)


def test_merged_vs_corner_candidate_parity(rng):
    """Merged one-row gather returns the SAME candidate set as the 8-row
    corner gather for every query — including the low half-voxel shell
    (base = -1), where an unpadded merged grid silently returned zero
    candidates while corner still served the 4 in-bounds voxels."""
    pts = rng.uniform(-16, 16, size=(8000, 3)).astype(np.float32)
    pc = pcops.from_numpy(pts, 8192)
    # queries spanning the whole window INCLUDING its edge shells
    queries = np.concatenate([
        rng.uniform(-16, 16, size=(256, 3)),
        rng.uniform(-16, -15.2, size=(64, 3)),          # low shell, all axes
        np.stack([rng.uniform(-16, -15.2, 64),          # low-x band only
                  rng.uniform(-14, 14, 64),
                  rng.uniform(-14, 14, 64)], axis=1),
    ]).astype(np.float32)
    q = jnp.asarray(queries)
    q_mask = jnp.ones((len(queries),), bool)

    dm = vox.build_dense_voxel_map(pc, 2.0, jnp.zeros(3, jnp.float32),
                                   (16, 16, 16), slab_size=64)
    mm = vox.build_merged_dense_voxel_map(pc, 2.0, jnp.zeros(3, jnp.float32),
                                          (16, 16, 16), slab_size=64)
    c_cor, ok_cor = vox.gather_neighbors_corner(dm, q, q_mask)
    c_mrg, ok_mrg = vox.gather_neighbors_merged(mm, q, q_mask)

    c_cor, ok_cor = np.asarray(c_cor), np.asarray(ok_cor)
    c_mrg, ok_mrg = np.asarray(c_mrg), np.asarray(ok_mrg)
    for i in range(len(queries)):
        a, b = c_cor[i][ok_cor[i]], c_mrg[i][ok_mrg[i]]
        assert len(a) == len(b), (i, queries[i], len(a), len(b))
        if len(a):
            # merged rows are int16-quantized (~6 mm): set-match each
            # corner candidate to its nearest merged candidate
            d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
            assert d.min(axis=1).max() < 0.02, (i, d.min(axis=1).max())
            assert d.min(axis=0).max() < 0.02, (i, d.min(axis=0).max())


def test_corner_vs_27cell_same_candidates_in_ball(rng):
    pts = rng.uniform(-10, 10, size=(5000, 3)).astype(np.float32)
    pc = pcops.from_numpy(pts, 8192)
    q = jnp.asarray(rng.uniform(-8, 8, size=(128, 3)).astype(np.float32))
    q_mask = jnp.ones((128,), bool)

    dm2 = vox.build_dense_voxel_map(pc, 2.0, jnp.zeros(3, jnp.float32),
                                    (16, 16, 16), slab_size=64)
    dm1 = vox.build_dense_voxel_map(pc, 1.0, jnp.zeros(3, jnp.float32),
                                    (32, 32, 32), slab_size=64)
    c_cor, ok_cor = vox.gather_neighbors_corner(dm2, q, q_mask)
    c_27, ok_27 = vox.gather_neighbors_dense(dm1, q, q_mask, radius=1)

    def in_ball_count(cand, ok):
        d2 = jnp.sum((cand - q[:, None, :]) ** 2, -1)
        return np.asarray(jnp.sum(ok & (d2 <= 1.0), axis=1))

    np.testing.assert_array_equal(in_ball_count(c_cor, ok_cor),
                                  in_ball_count(c_27, ok_27))
