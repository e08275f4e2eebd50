"""The SPPM gate of tests/test_sppm.py:73 (|m - m_ref| < 0.05 m_ref + 0.01,
luminance means) on chip_smoke.py's room, rendered by the JAX package on
the CPU at a small size: render_sppm at 2 iterations of H*W photons
(max_candidates 64, its default) against render() by `path`.

    JAX_PLATFORMS=cpu python scripts/sppm_room_gate.py 160x90 [WxH ...]

Prints, per size, both means, the gap beside the gate and the truncated
candidates.  The room is chip_smoke.cornell_room's, built here with the
JAX package's classes (the UV-sphere mesh by the same numpy code as
chip_smoke.uv_sphere_mesh); chip_smoke phase 29 holds the port's SPPM
frame of the same size on the card to the JAX mean this prints.
"""
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

PATH_SPP = 16


def uv_sphere_mesh(n_theta, n_phi, radius, center):
    th = np.linspace(0.0, np.pi, n_theta + 1)[1:-1]
    ph = np.linspace(0.0, 2.0 * np.pi, n_phi, endpoint=False)
    t, p = np.meshgrid(th, ph, indexing="ij")
    ring = np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p),
                     np.cos(t)], -1).reshape(-1, 3)
    v = np.concatenate([[[0.0, 0.0, 1.0]], ring, [[0.0, 0.0, -1.0]]])
    last = len(v) - 1
    tris = []
    for j in range(n_phi):
        k = (j + 1) % n_phi
        tris.append([0, 1 + j, 1 + k])
        for i in range(n_theta - 2):
            a, b = 1 + i * n_phi + j, 1 + i * n_phi + k
            tris += [[a, a + n_phi, b], [b, a + n_phi, b + n_phi]]
        tris.append([1 + (n_theta - 2) * n_phi + j, last,
                     1 + (n_theta - 2) * n_phi + k])
    v = v * radius + np.asarray(center, np.float64)
    return v.astype(np.float32), np.asarray(tris, np.int32)


def cornell_room(width, height, spp):
    from acceleratedvolrenderer_tpu.models import materials, shapes, textures
    from acceleratedvolrenderer_tpu.models.cameras import PerspectiveCamera
    from acceleratedvolrenderer_tpu.models.film import BoxFilter
    from acceleratedvolrenderer_tpu.scene import Scene
    from acceleratedvolrenderer_tpu.utils.spectrum import constant_spectrum
    from acceleratedvolrenderer_tpu.utils.vecmath import look_at

    def quad(o, e1, e2, reflectance, emission=None):
        return shapes.Quad(
            origin=np.array(o, np.float64), e1=np.array(e1, np.float64),
            e2=np.array(e2, np.float64),
            material=materials.DiffuseMaterial(reflectance=reflectance,
                                               emission=emission))

    rgb = textures.ConstantRGBTexture
    verts, tris = uv_sphere_mesh(20, 24, 0.3, (0.1, 0.3, 1.45))
    prims = [
        quad([-0.45, 2, 0.55], [0.9, 0, 0], [0, 0, 0.9], 0.0,
             emission=constant_spectrum(8.0)),
        quad([-1, 0, 0], [0, 0, 2], [2, 0, 0], 0.7),
        quad([-1, 2, 0], [2, 0, 0], [0, 0, 2], 0.7),
        quad([-1, 0, 2], [0, 2, 0], [2, 0, 0], 0.7),
        quad([-1, 0, 0], [0, 2, 0], [0, 0, 2], rgb((0.63, 0.06, 0.05))),
        quad([1, 0, 0], [0, 0, 2], [0, 2, 0], rgb((0.14, 0.45, 0.09))),
        shapes.Sphere(center=np.array([-0.5, 0.38, 0.9]), radius=0.38,
                      material=materials.DielectricMaterial(eta=1.5)),
        shapes.Sphere(center=np.array([0.55, 0.28, 0.5]), radius=0.28,
                      material=materials.ConductorMaterial(
                          eta=0.2, k=3.0, roughness=0.2)),
        shapes.TriangleMesh(vertices=verts, indices=tris,
                            material=materials.DiffuseMaterial(
                                reflectance=0.6)),
    ]
    cam = PerspectiveCamera(c2w=look_at((0.0, 1.0, -2.8), (0.0, 1.0, 1.0),
                                        (0, 1, 0)),
                            fov_deg=40.0, width=width, height=height)
    return Scene(camera=cam, medium=None, lights=[], primitives=prims,
                 max_depth=6, spp=spp, scene_radius=20.0, filter=BoxFilter(),
                 light_sampler="bvh", integrator="path")


def main(sizes):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from acceleratedvolrenderer_tpu.models.integrators import sppm
    from acceleratedvolrenderer_tpu.parallel import render

    lum = np.array([0.2126, 0.7152, 0.0722])
    for size in sizes:
        w, h = (int(v) for v in size.split("x"))
        t0 = time.time()
        # a scene each: the JAX mesh keeps the grid its first jit built
        ref, _ = render.render(cornell_room(w, h, PATH_SPP))
        img, st = sppm.render_sppm(cornell_room(w, h, PATH_SPP),
                                   n_iterations=2, photons_per_iter=w * h)
        m, m_ref = float((img @ lum).mean()), float((ref @ lum).mean())
        gate = 0.05 * m_ref + 0.01
        print(f"JAX package, CPU, room {w}x{h}: sppm (2 iterations of "
              f"{w * h} photons) luminance mean {m:.6f}, path spp "
              f"{PATH_SPP} {m_ref:.6f}, |diff| {abs(m - m_ref):.4e} against "
              f"the gate {gate:.4e} ({'passes' if abs(m - m_ref) < gate else 'fails'}), "
              f"truncated candidates {st['truncated_candidates']}, "
              f"{time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["160x90"])
