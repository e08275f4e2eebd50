"""chip_smoke.py's phase 29 (the light path, SPPM, BDPT and MLT) alone on
the CUDA card, with the frames it compares with built first: phase 24's
room by `path` and phase 15's fog box by render() at spp 32, and phase
8's 1280x720 cloud over its 256³ grid.  Then the four `cuda` cases of
tests/test_torch_cuda.py that run the CLI on the card against the CPU.

    python3 scripts/phase29_alone.py

Needs one CUDA card; about four minutes on an NVIDIA H100 80GB HBM3 at
700 W (with the card tests).
"""
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    from acceleratedvolrenderer_tpu_torch import kernels
    from acceleratedvolrenderer_tpu_torch.parallel import render
    from acceleratedvolrenderer_tpu_torch.scene import presets

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    kernels.library()
    t0 = time.time()
    room = replace(cs.cornell_room(*cs.FULL, cs.ROOM_SPP, dev),
                   integrator="path")
    cs.FRAMES[("room", "path")] = render.render(room, device=dev)[0]
    fog = presets.fog_box(res=256, device=dev)
    cs.FRAMES[("fog box", "render")] = render.render(fog, spp=cs.FOG_SPP,
                                                     device=dev)[0]
    scene = presets.cloud(1280, 720, grid_res=256, device=dev)
    print(f"setup {time.time() - t0:.1f} s", flush=True)
    print(cs.timed("other integrators", cs.phase_integrators, dev, scene,
                   card))
    cs.timed("other integrators, small", cs.phase_integrators_small, dev,
             card)
    r = subprocess.run([sys.executable, "-m", "pytest", "--noconftest",
                        "-q", "-m", "cuda", "tests/test_torch_cuda.py", "-k",
                        "other_integrators", "-p", "no:cacheprovider"],
                       cwd=ROOT)
    return r.returncode


if __name__ == "__main__":
    sys.exit(main())
