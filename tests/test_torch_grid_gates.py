"""tests/test_grid.py's gates on the port's grids (ops/grid.py): trilinear
lookups at voxel centres, outside the grid and halfway, the majorant's
conservativeness, the on-device majorant build against the host build and
against the JAX package's build_majorant_grid_jax, the homogeneous case;
max_value_range against the majorant of one cell."""
import jax.numpy as jnp
import numpy as np
import torch

from acceleratedvolrenderer_tpu.ops import grid as jgrid
from acceleratedvolrenderer_tpu_torch.ops import grid as gridops


def test_trilerp_voxel_centers():
    rng = np.random.default_rng(0)
    g = rng.random((4, 5, 6)).astype(np.float32)
    nz, ny, nx = g.shape
    xs, ys, zs = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    p = np.stack([(xs + 0.5) / nx, (ys + 0.5) / ny, (zs + 0.5) / nz],
                 axis=-1).reshape(-1, 3)
    v = gridops.trilerp(torch.as_tensor(g),
                        torch.as_tensor(p, dtype=torch.float32)).numpy()
    expect = g[zs.reshape(-1), ys.reshape(-1), xs.reshape(-1)]
    np.testing.assert_allclose(v, expect, rtol=1e-5)


def test_trilerp_outside_zero():
    p = torch.tensor([[-0.5, 0.5, 0.5], [1.5, 0.5, 0.5], [0.5, 0.5, 2.0]])
    np.testing.assert_allclose(gridops.trilerp(torch.ones((4, 4, 4)),
                                               p).numpy(), 0.0)


def test_trilerp_interpolates():
    g = torch.zeros((1, 1, 2))
    g[0, 0, 1] = 1.0
    v = float(gridops.trilerp(g, torch.tensor([[0.5, 0.5, 0.5]]))[0])
    np.testing.assert_allclose(v, 0.5, atol=1e-6)


def test_majorant_conservative():
    rng = np.random.default_rng(1)
    dens = rng.random((33, 47, 29)).astype(np.float32)
    maj = gridops.build_majorant_grid(dens, res=(8, 8, 8))
    assert maj.shape == (8, 8, 8)
    p = rng.random((20000, 3)).astype(np.float32)
    d = gridops.trilerp(torch.as_tensor(dens), torch.as_tensor(p)).numpy()
    cell = np.clip((p * 8).astype(int), 0, 7)
    m = maj[cell[:, 2], cell[:, 1], cell[:, 0]]
    assert np.all(d <= m + 1e-5)
    # max_value_range over one cell's bounds is that cell's majorant
    lo, hi = np.array([0.25, 0.5, 0.125]), np.array([0.375, 0.625, 0.25])
    assert gridops.max_value_range(dens, lo, hi) == maj[1, 4, 2]


def test_majorant_torch_matches_host_and_jax():
    rng = np.random.default_rng(2)
    dens = rng.random((20, 17, 25)).astype(np.float32)
    host = gridops.build_majorant_grid(dens, res=(4, 4, 4))
    dev = gridops.build_majorant_grid_torch(torch.as_tensor(dens),
                                            res=(4, 4, 4)).numpy()
    np.testing.assert_allclose(host, dev, rtol=1e-6)
    ref = np.asarray(jgrid.build_majorant_grid_jax(jnp.asarray(dens),
                                                   res=(4, 4, 4)))
    np.testing.assert_allclose(dev, ref, rtol=1e-6)


def test_majorant_homogeneous():
    maj = gridops.build_majorant_grid(np.ones((1, 1, 1), np.float32),
                                      res=(1, 1, 1))
    np.testing.assert_allclose(maj, 1.0)
