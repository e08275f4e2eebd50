"""Minimal BLOSC-1 chunk codec, decode and encoder (port of
acceleratedvolrenderer_tpu/utils/blosc.py, numpy and python only).

NanoVDB IO compresses grids with blosc (LZ4 + byte shuffle); this is the
chunk format from the published spec (BLOSC.txt, chunk format v1):

  header (16 B): version, versionlz, flags, typesize,
                 nbytes u32, blocksize u32, cbytes u32
  flags: bit0 byte-shuffle, bit1 memcpy (stored raw), bit2 bit-shuffle,
         bits 5-7 compressor code (0 blosclz, 1 lz4/lz4hc)
  body: u32 bstarts[nblocks] (absolute offsets into the chunk), then per
        block a sequence of splits — when byte-shuffle is on the block is
        split into `typesize` streams — each stored as
        [i32 csize][payload]; csize == split size means the split is
        stored verbatim, otherwise the payload is an LZ4 block.

The LZ4 block codec is native/lz4.cpp when it builds, else the
pure-Python one below, chosen exactly as the reference chooses; only what
NanoVDB emits is supported (lz4 compressor, byte shuffle or none).
"""
from __future__ import annotations

import struct

import numpy as np

FLAG_SHUFFLE = 0x1
FLAG_MEMCPY = 0x2
FLAG_BITSHUFFLE = 0x4
COMPRESSOR_LZ4 = 1


def lz4_decompress_block(src: bytes, dst_size: int) -> bytes:
    """LZ4 *block* format decode (not the frame format).

    Dispatches to the native codec (native/lz4.cpp) when built — the
    production path for real WDAS-scale grids; the pure-Python decode
    below is the no-toolchain fallback and the executable spec."""
    try:
        from .. import native

        out = native.lz4_decompress_block(bytes(src), dst_size)
        if out is not None:
            return out
    except ImportError:
        pass
    return _lz4_decompress_block_py(src, dst_size)


def _lz4_decompress_block_py(src: bytes, dst_size: int) -> bytes:
    src = memoryview(src)
    dst = bytearray(dst_size)
    si, di = 0, 0
    n = len(src)
    while si < n:
        token = src[si]
        si += 1
        # literals
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[si]
                si += 1
                lit += b
                if b != 255:
                    break
        dst[di:di + lit] = src[si:si + lit]
        si += lit
        di += lit
        if si >= n:
            break       # last literals-only sequence
        # match
        offset = src[si] | (src[si + 1] << 8)
        si += 2
        if offset == 0:
            raise ValueError("lz4: zero match offset")
        mlen = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                b = src[si]
                si += 1
                mlen += b
                if b != 255:
                    break
        ms = di - offset
        if ms < 0:
            raise ValueError("lz4: match before start")
        if offset >= mlen:
            dst[di:di + mlen] = dst[ms:ms + mlen]
            di += mlen
        else:
            # overlapping match: byte-accurate copy
            for _ in range(mlen):
                dst[di] = dst[di - offset]
                di += 1
    if di != dst_size:
        raise ValueError(f"lz4: decoded {di} bytes, expected {dst_size}")
    return bytes(dst)


def lz4_compress_block(src: bytes) -> bytes:
    """LZ4 block encode: native codec when built, pure-Python fallback."""
    try:
        from .. import native

        out = native.lz4_compress_block(bytes(src))
        if out is not None:
            return out
    except ImportError:
        pass
    return _lz4_compress_block_py(src)


def _lz4_compress_block_py(src: bytes) -> bytes:
    """Greedy LZ4 block encoder (executable spec; small inputs)."""
    src = bytes(src)
    n = len(src)
    out = bytearray()
    table = {}
    i = 0
    anchor = 0

    def emit(lit_start, lit_end, offset, mlen):
        lit = lit_end - lit_start
        ml = mlen - 4 if mlen else 0
        token = (min(lit, 15) << 4) | (min(ml, 15) if mlen else 0)
        out.append(token)
        if lit >= 15:
            rest = lit - 15
            while rest >= 255:
                out.append(255)
                rest -= 255
            out.append(rest)
        out.extend(src[lit_start:lit_end])
        if mlen:
            out.append(offset & 0xFF)
            out.append(offset >> 8)
            if ml >= 15:
                rest = ml - 15
                while rest >= 255:
                    out.append(255)
                    rest -= 255
                out.append(rest)

    # spec: the last 5 bytes are always literals; last match must start
    # at least 12 bytes before the end
    while i < n - 12:
        key = src[i:i + 4]
        j = table.get(key, -1)
        table[key] = i
        if j >= 0 and i - j <= 0xFFFF and src[j:j + 4] == key:
            mlen = 4
            limit = n - 5
            while i + mlen < limit and src[j + mlen] == src[i + mlen]:
                mlen += 1
            emit(anchor, i, i - j, mlen)
            i += mlen
            anchor = i
        else:
            i += 1
    emit(anchor, n, 0, 0)
    return bytes(out)


def shuffle(data: bytes, typesize: int) -> bytes:
    a = np.frombuffer(data, np.uint8)
    n = len(a) // typesize * typesize
    head = a[:n].reshape(-1, typesize).T.reshape(-1)
    return head.tobytes() + a[n:].tobytes()


def unshuffle(data: bytes, typesize: int) -> bytes:
    a = np.frombuffer(data, np.uint8)
    n = len(a) // typesize * typesize
    head = a[:n].reshape(typesize, -1).T.reshape(-1)
    return head.tobytes() + a[n:].tobytes()


def decompress(chunk: bytes) -> bytes:
    """Decode one BLOSC chunk to its raw bytes."""
    if len(chunk) < 16:
        raise ValueError("blosc: truncated header")
    version, versionlz, flags, typesize = chunk[0], chunk[1], chunk[2], chunk[3]
    nbytes, blocksize, cbytes = struct.unpack_from("<III", chunk, 4)
    if flags & FLAG_BITSHUFFLE:
        raise NotImplementedError("blosc: bit-shuffle not supported")
    if flags & FLAG_MEMCPY:
        return bytes(chunk[16:16 + nbytes])
    compressor = (flags >> 5) & 0x7
    if compressor not in (0, COMPRESSOR_LZ4):
        raise NotImplementedError(f"blosc: compressor code {compressor}")
    do_shuffle = bool(flags & FLAG_SHUFFLE) and typesize > 1
    nblocks = (nbytes + blocksize - 1) // blocksize
    bstarts = struct.unpack_from(f"<{nblocks}I", chunk, 16)
    out = bytearray()
    for b in range(nblocks):
        bsize = min(blocksize, nbytes - b * blocksize)
        pos = bstarts[b]
        # split streams: typesize pieces when shuffled (blosc's split
        # mode for lz4/blosclz), one otherwise
        nsplits = typesize if (do_shuffle and bsize % typesize == 0) else 1
        ssize = bsize // nsplits
        block = bytearray()
        for s in range(nsplits):
            this = ssize if s < nsplits - 1 else bsize - ssize * (nsplits - 1)
            (csize,) = struct.unpack_from("<i", chunk, pos)
            pos += 4
            payload = chunk[pos:pos + abs(csize)]
            pos += abs(csize)
            if csize == this:
                block += payload
            else:
                block += lz4_decompress_block(payload, this)
        if do_shuffle:
            block = unshuffle(bytes(block), typesize)
        out += block
    if len(out) != nbytes:
        raise ValueError(f"blosc: decoded {len(out)}, expected {nbytes}")
    return bytes(out)


def compress(data: bytes, typesize: int = 1, blocksize: int = 1 << 16,
             do_shuffle: bool = True) -> bytes:
    """Encode bytes as one BLOSC chunk (LZ4 + optional byte shuffle).

    Fixture/roundtrip encoder — real exports come from the blosc library;
    this produces spec-conformant chunks our decoder (and blosc) read.
    """
    nbytes = len(data)
    do_shuffle = do_shuffle and typesize > 1
    nblocks = max((nbytes + blocksize - 1) // blocksize, 1)
    flags = (COMPRESSOR_LZ4 << 5) | (FLAG_SHUFFLE if do_shuffle else 0)
    header = bytearray(struct.pack("<BBBBIII", 2, 1, flags, typesize,
                                   nbytes, blocksize, 0))
    bstarts = []
    body = bytearray()
    base = 16 + 4 * nblocks
    for b in range(nblocks):
        raw = data[b * blocksize: b * blocksize + blocksize]
        bsize = len(raw)
        if do_shuffle:
            raw = shuffle(raw, typesize)
        nsplits = typesize if (do_shuffle and bsize % typesize == 0) else 1
        ssize = bsize // nsplits
        bstarts.append(base + len(body))
        for s in range(nsplits):
            this = raw[s * ssize: (s + 1) * ssize] if s < nsplits - 1 \
                else raw[ssize * (nsplits - 1):]
            comp = lz4_compress_block(bytes(this))
            if len(comp) >= len(this):
                body += struct.pack("<i", len(this)) + this
            else:
                body += struct.pack("<i", len(comp)) + comp
    chunk = (bytes(header) + struct.pack(f"<{nblocks}I", *bstarts)
             + bytes(body))
    # patch cbytes
    chunk = chunk[:12] + struct.pack("<I", len(chunk)) + chunk[16:]
    return chunk
