#!/usr/bin/env python
"""Run chip_smoke.py's kernel phases of two trees in turns on one card.

    python scripts/alternate_kernel_phases.py OTHER_TREE [--phases ...]

OTHER_TREE is another checkout of the repository, for example the parent
commit unpacked with `git archive` into the gitignored `out/`.  The phases
(by default phase_kernel, phase_gather, phase_dma and phase_gather_designs:
chip_smoke's phases 3, 4, 10 and 11) run from OTHER_TREE, this tree, this
tree and OTHER_TREE, in that order, each in a fresh process that builds its
own tree's kernels into that tree's build/kernels/.  Host speed on a card's
machine varies between calls, so two trees are compared only within one
call, in turns.  Each run's output is printed under a header naming its
tree, after the card's name and power limit.
"""
import argparse
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
PHASES = ["phase_kernel", "phase_gather", "phase_dma", "phase_gather_designs"]
RUN = """
import sys, time
import torch
sys.path.insert(0, '.')
import chip_smoke
from acceleratedvolrenderer_tpu_torch import kernels
kernels.library()
dev = torch.device('cuda', 0)
for name in sys.argv[1:]:
    t0 = time.time()
    rec = getattr(chip_smoke, name)(dev)
    print(f'[{name}: {time.time() - t0:.1f} s] {rec}', flush=True)
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--phases", nargs="+", default=PHASES)
    args = ap.parse_args()
    other = args.other.resolve()
    if not (other / "chip_smoke.py").exists():
        raise SystemExit(f"{other} holds no chip_smoke.py")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    failed = []
    for tree, label in ((other, "other"), (HERE, "this"), (HERE, "this"),
                        (other, "other")):
        print(f"=== {label} tree: {tree}", flush=True)
        rc = subprocess.run([sys.executable, "-c", RUN, *args.phases],
                            cwd=tree).returncode
        if rc != 0:
            failed.append((label, rc))
    if failed:
        raise SystemExit(f"runs failed: {failed}")


if __name__ == "__main__":
    main()
