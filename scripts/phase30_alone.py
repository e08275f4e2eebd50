"""chip_smoke.py's phase 30 (the MIP map, the subsurface and measured
materials, hair, imgtool, plytool, cyhair2pbrt and rgb2spec_opt) alone on
the CUDA card, then the `cuda` cases of tests/test_torch_cuda.py that hold
those modules on the card to the CPU.

    python3 scripts/phase30_alone.py

Needs one CUDA card; it builds the kernels (phase 30's cloud leg runs the
march kernel).
"""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    from acceleratedvolrenderer_tpu_torch import kernels

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    kernels.library()
    print(cs.timed("item1", cs.phase_item1, dev, card))
    r = subprocess.run([sys.executable, "-m", "pytest", "--noconftest",
                        "-q", "-m", "cuda", "tests/test_torch_cuda.py", "-k",
                        "item1", "-p", "no:cacheprovider"], cwd=ROOT)
    return r.returncode


if __name__ == "__main__":
    sys.exit(main())
