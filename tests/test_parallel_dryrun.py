"""Driver dryrun entrypoints (split from test_parallel.py so the two
heavy dryruns land on their own xdist worker)."""

"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from simpleslam_tpu.ops import loam, pointcloud as pcops, voxel as vox
from simpleslam_tpu.parallel.mesh import make_mesh
from simpleslam_tpu.parallel.dist_registration import sharded_scan2map
from simpleslam_tpu.pipeline import simulate as sim


@pytest.fixture(scope="module")
def reg_fixture():
    rng = np.random.default_rng(7)
    world = sim.make_world(seed=11)
    T = np.eye(4)
    scan = sim.simulate_scan(world, sim.sensor_from_body(T), rng=rng)
    pc_map = pcops.transform(pcops.from_numpy(scan, 32768), jnp.eye(4))
    ds = pcops.compact(vox.voxel_downsample(pc_map, 0.5), 16384)
    vm = vox.build_voxel_map(ds, 1.0, jnp.zeros(3, jnp.float32),
                             num_voxels=32768, slab_size=8)
    scan2 = sim.simulate_scan(world, sim.sensor_from_body(T), rng=rng)
    src = pcops.compact(vox.voxel_downsample(pcops.from_numpy(scan2, 32768), 0.5), 8192)
    guess = np.eye(4)
    guess[:3, 3] = [0.1, -0.1, 0.0]
    return src, vm, jnp.asarray(guess.astype(np.float32))


def test_dryrun_multichip_entrypoint():
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert np.isfinite(np.asarray(out)).all()
    ge.dryrun_multichip(8)


def test_sharded_posegraph_matches_single_device():
    """Edge-sharded BA must agree with the single-device solve."""
    import jax
    from jax.sharding import Mesh
    from simpleslam_tpu.parallel import dist_posegraph as dpg
    from simpleslam_tpu.ops import posegraph as pgo

    devs = np.array(jax.devices()[:8])
    mesh = Mesh(devs, ("kf",))
    g = dpg._ring_graph(k=24, k_cap=32, e_cap=64, drift=0.05)

    single = pgo.solve(g, max_iters=8, cg_iters=48)
    fn = dpg.sharded_solve(mesh, axis="kf", max_iters=8, cg_iters=48)
    sharded = fn(g)

    assert float(sharded.cost) < float(sharded.cost0) * 1e-2
    np.testing.assert_allclose(np.asarray(sharded.poses)[:24, :3, 3],
                               np.asarray(single.poses)[:24, :3, 3], atol=1e-2)


def test_dist_posegraph_dryrun():
    import jax
    from jax.sharding import Mesh
    from simpleslam_tpu.parallel import dist_posegraph as dpg

    mesh = Mesh(np.array(jax.devices()[:8]), ("kf",))
    dpg.dryrun(mesh)
