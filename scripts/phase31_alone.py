"""chip_smoke.py's phase 31 (sharded rendering and gradients over
torch.distributed) alone on the CUDA card, with the phases it compares
with (8: the regen frame, 14: the wave frame, 9: the gradient), then the
`cuda` cases of tests/test_torch_cuda.py that hold the sharding and the
Threefry keys on the card.

    python3 scripts/phase31_alone.py

Needs one CUDA card; it builds the kernels.
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
    _, scene, slice_rec = cs.timed("slice", cs.phase_slice, dev, card)
    cs.timed("wave full", cs.phase_wave_full, dev, scene, slice_rec[0], card)
    cs.timed("grad full", cs.phase_grad_full, dev, scene, card)
    print(cs.timed("sharding", cs.phase_sharding, dev, scene, card))
    r = subprocess.run([sys.executable, "-m", "pytest", "--noconftest",
                        "-q", "-m", "cuda", "tests/test_torch_cuda.py", "-k",
                        "sharding or threefry", "-p", "no:cacheprovider"],
                       cwd=ROOT)
    return r.returncode


if __name__ == "__main__":
    sys.exit(main())
