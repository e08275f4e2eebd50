"""Host seconds of utils/image.py's numpy JPEG decoder on a 2048x1024
4:2:0 baseline JPEG (an environment map's size), the cost a scene with such
an image map pays once when it loads.

    python3 scripts/time_image_decode.py [--width 2048 --height 1024]

The file is written here, without PIL: a procedural image (sinusoids and
noise) through a small baseline encoder (float DCT, the JPEG standard's
example quantization tables scaled to quality 90 as libjpeg scales them, flat Huffman tables of 4- and
5-bit (DC) and 8- and 9-bit (AC) codes), so its coefficient and symbol
counts are a photograph's kind.  The decoded image's PSNR against the
source must exceed 20 dB (a check of both ends).  Prints the host's CPU
model, the file size, the encode seconds and each of three decodes'
seconds.
"""
import argparse
import os
import platform
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from acceleratedvolrenderer_tpu_torch.utils import image  # noqa: E402

Q_LUMA = [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
          14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
          18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
          49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103,
          99]
Q_CHROMA = [17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4 + [
    24, 26, 56] + [99] * 5 + [47, 66] + [99] * 38
# libjpeg's quality scaling at quality 90: 20% of the example tables
Q_LUMA, Q_CHROMA = ([max(1, (q * 20 + 50) // 100) for q in t]
                    for t in (Q_LUMA, Q_CHROMA))
# canonical tables without an all-ones code: DC symbols 0-14 in 4 bits and
# 15 in 5 (libjpeg takes DC symbols up to 15); AC 0-253 in 8 bits, 254-255
# in 9
DC_COUNTS = [0, 0, 0, 15, 1] + [0] * 11
DC_CODES = {s: (s, 4) for s in range(15)}
DC_CODES[15] = (30, 5)
AC_COUNTS = [0] * 7 + [254, 2] + [0] * 7
AC_CODES = {s: (s, 8) for s in range(254)}
AC_CODES.update({254: (508, 9), 255: (509, 9)})


def scene(w, h, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(xx / 7.0),
                    128 + 90 * np.cos(yy / 5.0 + xx / 11.0),
                    (xx * 3 + yy * 5) % 256], -1)
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(
        np.uint8)


def blocks(plane, q):
    """(by, bx, 64) zigzag-ordered quantized DCT coefficients."""
    h, w = plane.shape
    u = np.arange(8)
    c = np.sqrt(np.where(u == 0, 1 / 8, 2 / 8))[:, None] * np.cos(
        (2 * u[None, :] + 1) * u[:, None] * np.pi / 16)
    b = plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3) - 128.0
    f = c @ b @ c.T
    coef = np.round(f.reshape(h // 8, w // 8, 64) / np.asarray(q))
    return coef[:, :, image._JPEG_NATURAL].astype(np.int64)


class BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code, length):
        self.acc = (self.acc << length) | code
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def put_value(bw, codes, sym_base, v):
    s = abs(v).bit_length()
    bw.put(*codes[sym_base | s])
    if s:
        bw.put(v if v > 0 else v + (1 << s) - 1, s)


def encode(rgb):
    h, w, _ = rgb.shape
    x = rgb.astype(np.float64)
    y = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    cb = -0.168736 * x[..., 0] - 0.331264 * x[..., 1] + 0.5 * x[..., 2] + 128
    cr = 0.5 * x[..., 0] - 0.418688 * x[..., 1] - 0.081312 * x[..., 2] + 128
    sub = lambda p: p.reshape(h // 2, 2, w // 2, 2).mean((1, 3))
    planes = [blocks(np.clip(np.round(y), 0, 255), Q_LUMA),
              blocks(np.clip(np.round(sub(cb)), 0, 255), Q_CHROMA),
              blocks(np.clip(np.round(sub(cr)), 0, 255), Q_CHROMA)]
    bw = BitWriter()
    pred = [0, 0, 0]
    for my in range(h // 16):
        for mx in range(w // 16):
            units = [(0, 2 * my + i, 2 * mx + j) for i in (0, 1)
                     for j in (0, 1)] + [(1, my, mx), (2, my, mx)]
            for ci, by, bx in units:
                blk = planes[ci][by, bx].tolist()
                put_value(bw, DC_CODES, 0, blk[0] - pred[ci])
                pred[ci] = blk[0]
                run = 0
                last = max([k for k in range(1, 64) if blk[k]], default=0)
                for k in range(1, last + 1):
                    if not blk[k]:
                        run += 1
                        continue
                    while run > 15:
                        bw.put(*AC_CODES[0xF0])
                        run -= 16
                    put_value(bw, AC_CODES, run << 4, blk[k])
                    run = 0
                if last < 63:
                    bw.put(*AC_CODES[0x00])
    seg = lambda m, body: bytes([0xFF, m]) + (len(body) + 2).to_bytes(
        2, "big") + body
    zz = lambda q: bytes(np.asarray(q)[image._JPEG_NATURAL].tolist())
    dc = bytes(DC_COUNTS) + bytes(range(16))
    ac = bytes(AC_COUNTS) + bytes(range(256))
    return (b"\xff\xd8"
            + seg(0xDB, b"\x00" + zz(Q_LUMA) + b"\x01" + zz(Q_CHROMA))
            + seg(0xC0, b"\x08" + h.to_bytes(2, "big") + w.to_bytes(2, "big")
                  + b"\x03\x01\x22\x00\x02\x11\x01\x03\x11\x01")
            + seg(0xC4, b"\x00" + dc + b"\x10" + ac)
            + seg(0xDA, b"\x03\x01\x00\x02\x00\x03\x00\x00\x3f\x00")
            + bw.flush() + b"\xff\xd9")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=2048)
    ap.add_argument("--height", type=int, default=1024)
    a = ap.parse_args()
    model = next((ln.split(":", 1)[1].strip() for ln in
                  Path("/proc/cpuinfo").read_text().splitlines()
                  if ln.startswith("model name")), "model not reported")
    cpu = f"{model}, {platform.machine()}, {os.cpu_count()} cores"
    rgb = scene(a.width, a.height)
    t0 = time.time()
    data = encode(rgb)
    enc = time.time() - t0
    secs = []
    for _ in range(3):
        t0 = time.time()
        got = image.decode_jpeg(data)
        secs.append(time.time() - t0)
    mse = float(np.mean((got.astype(float) - rgb) ** 2))
    psnr = 10 * np.log10(255 ** 2 / mse)
    print(f"host CPU: {cpu}")
    print(f"JPEG {a.width}x{a.height} 4:2:0 baseline, {len(data)} bytes, "
          f"encoded in {enc:.2f} s; utils/image.py decode_jpeg "
          f"{', '.join(f'{s:.3f}' for s in secs)} s; PSNR against the "
          f"source {psnr:.2f} dB")
    if got.shape != rgb.shape or psnr < 20:
        raise SystemExit("decode does not match the source")


if __name__ == "__main__":
    main()
