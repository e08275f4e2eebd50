"""Hold the port's image writers to PIL's on one frame: the EXR a card run
rendered (e.g. phase 32's map frame, which `scripts/phase32_alone.py
--frame-out PATH` keeps), tonemapped as write_png tonemaps, written by
PIL and by utils/image_write.py to each format the port writes byte for
byte, and the pixels of imgtool falsecolor's PNG of it to JPEG the same
way.  Prints, per
format, both files' sizes and whether they are the same bytes, and for
each JPEG its PSNR against its pixels as PIL decodes it and as the port
decodes it.  Needs PIL (the machine with the card has none).

    python3 scripts/compare_frame_writers.py frame.exr
"""
import contextlib
import io
import sys
import tempfile
from pathlib import Path

import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from acceleratedvolrenderer_tpu_torch.cli import imgtool  # noqa: E402
from acceleratedvolrenderer_tpu_torch.utils import (  # noqa: E402
    image, image_write)

EXTS = (".jpg", ".bmp", ".tga", ".tif", ".ppm", ".pcx", ".sgi", ".im",
        ".dds", ".qoi")


def psnr(a, b):
    err = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if err == 0 else float(10 * np.log10(255.0 ** 2 / err))


def compare(name, px, exts, tmp):
    same = True
    for ext in exts:
        path = Path(tmp) / f"frame{ext}"        # SGI and IM embed the name
        Image.fromarray(px).save(path)
        pil = path.read_bytes()
        port = image_write.encode(str(path), px)
        same &= port == pil
        line = (f"{name} {ext}: port {len(port)} bytes, PIL {len(pil)} bytes, "
                f"{'same' if port == pil else 'DIFFERENT'}")
        if ext == ".jpg":
            line += (f"; PSNR {psnr(np.asarray(Image.open(path)), px):.4f} dB "
                     f"(PIL's decode), {psnr(image.decode_jpeg(port), px):.4f}"
                     " dB (the port's)")
        print(line, flush=True)
    return same


def main():
    frame = image.read_exr(sys.argv[1])[0][:, :, :3]
    with tempfile.TemporaryDirectory() as tmp:
        ok = compare("frame", image.to_8bit(frame), EXTS, tmp)
        png = str(Path(tmp) / "falsecolor.png")
        with contextlib.redirect_stdout(io.StringIO()):
            imgtool.main(["falsecolor", sys.argv[1], png])
        ok &= compare("falsecolor", image.read_png(png), (".jpg",), tmp)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
