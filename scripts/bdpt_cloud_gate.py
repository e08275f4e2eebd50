"""The BDPT gate of tests/test_bdpt.py:113 (luminance means within 12% of
render()'s) on presets.cloud, rendered by the JAX package on the CPU at a
small size: render_bdpt at max_depth 4, spp 1 (its wave outside jit)
against render() of the same scene at max_depth 4, spp 1.

    JAX_PLATFORMS=cpu python scripts/bdpt_cloud_gate.py 64x36 [WxH ...]

Prints, per size, both means and their relative difference beside the
gate.  The cloud is lit by a sun and a uniform sky; the reference's BDPT
connects to the distant light only (render_bdpt l. 367-370), so the sky
that render() adds is absent from its frame.  chip_smoke phase 29 holds
the port's BDPT frame of the same size on the card to the JAX mean this
prints.
"""
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

GRID_RES = 32
DEPTH = 4


def main(sizes):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from acceleratedvolrenderer_tpu.models.integrators import bdpt
    from acceleratedvolrenderer_tpu.parallel import render
    from acceleratedvolrenderer_tpu.scene import presets

    lum = np.array([0.2126, 0.7152, 0.0722])
    for size in sizes:
        w, h = (int(v) for v in size.split("x"))
        scene = presets.cloud(w, h, spp=1, max_depth=DEPTH,
                              grid_res=GRID_RES)
        t0 = time.time()
        with jax.disable_jit():
            img, _, _ = bdpt.render_bdpt(scene, max_depth=DEPTH, spp=1,
                                         keep_strategies=False)
        ref, _ = render.render(scene, spp=1)
        m, m_ref = float((img @ lum).mean()), float((ref @ lum).mean())
        rel = abs(m - m_ref) / m_ref
        print(f"JAX package, CPU, cloud {w}x{h} grid {GRID_RES}^3: bdpt "
              f"max_depth {DEPTH} spp 1 luminance mean {m:.6f}, render() "
              f"{m_ref:.6f}, rel diff {rel:.4e} against the gate 0.12 "
              f"({'passes' if rel < 0.12 else 'fails'}), "
              f"{time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["64x36"])
