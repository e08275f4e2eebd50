"""GIF writing as PIL 12.1.0 writes an 8-bit RGB image (GifImagePlugin's
_save under its defaults), byte for byte the same, without PIL.

PIL first converts the image to a palette by convert("P",
palette=ADAPTIVE): libImaging's Quant.c median cut without k-means and
without dithering.  quantize() is that algorithm:

  - the colours are counted in a hash that keeps at most 65,536 of them:
    while more are distinct, every colour is shifted right one bit more
    (the scale), so boxes hold scaled colours;
  - the median cut starts from one box of every colour and splits, up to
    255 times, the box of the most pixels (a binary max-heap on the pixel
    count, QuantHeap.c's) that spans more than one colour, along the axis
    of the largest range weighted 77, 150, 29 (R, G, B); the split walks
    the colours from the highest value down, counting pixels until more
    than half the box's are passed, then takes the rest of that value too;
    if nothing is left for the second box, the lowest value goes to it;
  - the palette is the boxes in the tree's order (the higher half first),
    each the rounded mean of the unscaled pixels it holds;
  - each colour then maps to its box's entry, or to the nearest entry by
    squared distance among those no farther from that entry than twice
    the colour's distance to it, the first in order of that distance
    (then of index) where several are nearest.

Then the file: PIL drops unused palette entries where the image has fewer
than 512 x 512 pixels and some entry below the last used one is unused;
the global colour table is the palette padded with black to a power of
two (4 at least); the image is interlaced unless a side is under 16; the
indices go through GifEncode.c's LZW (8-bit minimum code size, a clear
code first and whenever the 4,096-entry table is full, the code width
grown as the code is assigned), packed LSB first into sub-blocks of 255
bytes; a GIF87a with no extensions.
"""
from __future__ import annotations

import math
import struct

import numpy as np

MAX_HASH_ENTRIES = 65536
_WEIGHTS = (77, 150, 29)


class _Box:
    __slots__ = ("keys", "count", "pixels", "l", "r")

    def __init__(self, keys, count):
        self.keys = keys            # (n, 3) int64 scaled colours
        self.count = count          # (n,) pixel counts
        self.pixels = int(count.sum())
        self.l = self.r = None

    def volume(self):
        span = self.keys.max(0) - self.keys.min(0) + 1
        return int(np.prod(span))


def _split(box: _Box):
    """Quant.c's split of a box of more than one colour."""
    lo, hi = box.keys.min(0), box.keys.max(0)
    f = [(int(hi[i]) - int(lo[i])) * _WEIGHTS[i] for i in range(3)]
    axis = 0
    for i in (1, 2):
        if f[axis] < f[i]:
            axis = i
    v = box.keys[:, axis]
    values, inv = np.unique(v, return_inverse=True)
    per = np.bincount(inv, weights=box.count).astype(np.int64)[::-1]
    values = values[::-1]                       # highest value first
    total = box.pixels
    # the first value at which the running count passes half the box's;
    # every colour of that value and above goes left
    cut = int(np.argmax(np.cumsum(per) * 2 > total))
    if cut == len(values) - 1:                  # nothing left for the right
        cut -= 1
    left = v >= values[cut]
    box.l = _Box(box.keys[left], box.count[left])
    box.r = _Box(box.keys[~left], box.count[~left])
    return box.l, box.r


class _Heap:
    """QuantHeap.c's binary max-heap (1-based) on the boxes' pixel
    counts."""

    def __init__(self):
        self.h = [None]

    def add(self, box):
        self.h.append(box)
        k = len(self.h) - 1
        while k != 1:
            if box.pixels - self.h[k // 2].pixels <= 0:
                break
            self.h[k] = self.h[k // 2]
            k >>= 1
        self.h[k] = box

    def remove(self):
        if len(self.h) == 1:
            return None
        top = self.h[1]
        v = self.h.pop()
        n = len(self.h) - 1
        if n == 0:
            return top
        k = 1
        while k * 2 <= n:
            c = k * 2
            if c < n and self.h[c].pixels - self.h[c + 1].pixels < 0:
                c += 1
            if v.pixels - self.h[c].pixels > 0:
                break
            self.h[k] = self.h[c]
            k = c
        self.h[k] = v
        return top


def _leaves(box):
    if box.l is None:
        return [box]
    return _leaves(box.l) + _leaves(box.r)


def quantize(px: np.ndarray, colors: int = 256):
    """PIL's convert("P", palette=ADAPTIVE) of uint8 RGB px (H, W, 3):
    (palette (n, 3) uint8, indices (H, W) uint8)."""
    h, w = px.shape[:2]
    flat = px.reshape(-1, 3).astype(np.int64)
    scale = 0
    while True:
        packed = ((flat[:, 0] >> scale) << 16) | ((flat[:, 1] >> scale) << 8) \
            | (flat[:, 2] >> scale)
        uniq, inv, count = np.unique(packed, return_inverse=True,
                                     return_counts=True)
        if len(uniq) <= MAX_HASH_ENTRIES:
            break
        scale += 1
    keys = np.stack([uniq >> 16, (uniq >> 8) & 255, uniq & 255], 1)
    root = _Box(keys, count)
    heap = _Heap()
    heap.add(root)
    for _ in range(colors - 1):
        while True:
            box = heap.remove()
            if box is None or box.volume() != 1:
                break
        if box is None:
            break
        for child in _split(box):
            heap.add(child)
    leaves = _leaves(root)
    # the box of each distinct scaled colour, then of each pixel
    box_of = np.empty(len(uniq), np.int64)
    for i, leaf in enumerate(leaves):
        k = (leaf.keys[:, 0] << 16) | (leaf.keys[:, 1] << 8) | leaf.keys[:, 2]
        box_of[np.searchsorted(uniq, k)] = i
    pix_box = box_of[inv.reshape(-1)]
    n = len(leaves)
    cnt = np.bincount(pix_box, minlength=n)
    pal = np.stack([np.bincount(pix_box, weights=flat[:, c], minlength=n)
                    for c in range(3)], 1)
    pal = np.floor(0.5 + pal / cnt[:, None]).astype(np.int64)
    # the nearest entry of each distinct (unscaled) colour
    full = (flat[:, 0] << 16) | (flat[:, 1] << 8) | flat[:, 2]
    colours, cinv = np.unique(full, return_inverse=True)
    first = np.zeros(len(colours), np.int64)
    first[cinv.reshape(-1)[::-1]] = np.arange(len(full))[::-1]
    cbox = pix_box[first]
    crgb = flat[first]
    # Quant.c's search, all colours at once: each colour walks its box's
    # entries in order of their distance from the box's entry (then of
    # index) while that distance is at most 4 x its own to the box's
    # entry, keeping the first strictly nearer one
    avg = ((pal[:, None, :] - pal[None, :, :]) ** 2).sum(-1)
    order = np.argsort(avg, axis=1, kind="stable")
    avg_sorted = np.take_along_axis(avg, order, 1)
    best = cbox.copy()
    bestd = ((crgb - pal[cbox]) ** 2).sum(-1)
    reach = np.minimum(4 * bestd, 1 << 21)
    big = np.int64(1) << 22
    ncand = np.searchsorted((avg_sorted + np.arange(n)[:, None] * big).ravel(),
                            reach + cbox * big, side="right") - cbox * n
    live = np.argsort(-ncand, kind="stable")
    for k in range(int(ncand.max(initial=0))):
        live = live[:np.searchsorted(-ncand[live], -k, side="left")]
        j = order[cbox[live], k]
        d = ((crgb[live] - pal[j]) ** 2).sum(-1)
        hit = d < bestd[live]
        best[live[hit]] = j[hit]
        bestd[live[hit]] = d[hit]
    idx = best[cinv.reshape(-1)].reshape(h, w).astype(np.uint8)
    return pal.astype(np.uint8), idx


def lzw_codes(data: bytes):
    """GifEncode.c's LZW of the 8-bit indices data: (codes, widths)."""
    clear, end = 256, 257
    codes, widths = [clear], [9]
    table = {}
    next_code, max_code, width = 258, 511, 9
    head = data[0]
    for tail in data[1:]:
        key = (head << 8) | tail
        code = table.get(key)
        if code is not None:
            head = code
            continue
        codes.append(head)
        widths.append(width)
        if next_code < 4096:
            table[key] = next_code
            if next_code > max_code:
                max_code = 2 * max_code + 1
                width += 1
            next_code += 1
        else:
            codes.append(clear)
            widths.append(width)
            table.clear()
            next_code, max_code, width = 258, 511, 9
        head = tail
    codes += [head, end]
    widths += [width, width]
    return np.array(codes, np.int64), np.array(widths, np.int64)


def _pack_lsb(codes: np.ndarray, widths: np.ndarray) -> bytes:
    """The codes' bits, each code LSB first, in bytes filled from their
    low bit."""
    owner = np.repeat(np.arange(len(codes)), widths)
    pos = np.arange(owner.size) - (np.cumsum(widths) - widths)[owner]
    bits = ((codes[owner] >> pos) & 1).astype(np.uint8)
    return np.packbits(bits, bitorder="little").tobytes()


def _interlaced(idx: np.ndarray) -> np.ndarray:
    """The rows in GIF's interlaced order: every 8th from 0, every 8th
    from 4, every 4th from 2, every 2nd from 1."""
    return np.concatenate([idx[0::8], idx[4::8], idx[2::4], idx[1::2]])


def encode_gif(px: np.ndarray) -> bytes:
    """The GIF PIL writes for uint8 RGB px (H, W, 3)."""
    h, w = px.shape[:2]
    pal, idx = quantize(px)
    if w * h < 512 * 512:                       # PIL's palette optimization
        used = np.flatnonzero(np.bincount(idx.reshape(-1), minlength=256))
        if used.max() >= len(used):
            remap = np.zeros(256, np.uint8)
            remap[used] = np.arange(len(used))
            pal, idx = pal[used], remap[idx]
    n = len(pal)
    size = 1 if n * 3 < 9 else math.ceil(math.log(n, 2)) - 1
    table = pal.tobytes() + b"\0" * 3 * max(0, (2 << size) - n)
    interlace = min(w, h) >= 16
    rows = _interlaced(idx) if interlace else idx
    data = _pack_lsb(*lzw_codes(rows.tobytes()))
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    return (b"GIF87a" + struct.pack("<HHBBB", w, h, 128 + size, 0, 0) + table
            + b"," + struct.pack("<HHHHB", 0, 0, w, h, 64 if interlace else 0)
            + b"\x08" + blocks + b"\0;")
