"""JPEG 2000 tier 1 (EBCOT block decoding, ITU-T T.800 Annexes C and D) in
numpy: the MQ arithmetic decoder with its 47 states and the three coding
passes over 19 contexts (significance propagation, magnitude refinement,
cleanup with run-length mode), for code-blocks of style 0 (no mode
switches).  utils/jpeg2000.py calls it through decode_blocks, and through
native/j2k_t1.cpp (the same algorithm in C++) where that builds; the CPU
tests hold the two to each other.

Every code-block of an image runs in lockstep: the blocks are sorted by
their number of coding passes, so the blocks still coding at pass k are a
prefix of the batch, and each step decodes one scan position (stripe of
four rows, column, row) of that prefix at once, with a per-block MQ state
(A, C, CT, byte pointer) and per-block context states.  The refinement
pass needs no scan: its contexts are fixed before it starts, so it steps
through each block's list of significant coefficients instead.

A coefficient's value is kept as OpenJPEG keeps it: twice its magnitude,
with half the step of the last bit-plane decoded for it added (so a value
truncated by quality layers sits in the middle of its interval), signed.
"""
from __future__ import annotations

import numpy as np

# (Qe, NMPS, NLPS, SWITCH) of the 47 states (T.800 Table C.2)
_QE_TABLE = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0))
QE = np.array([t[0] for t in _QE_TABLE], np.uint32)
NMPS = np.array([t[1] for t in _QE_TABLE], np.uint8)
NLPS = np.array([t[2] for t in _QE_TABLE], np.uint8)
SWITCH = np.array([t[3] for t in _QE_TABLE], np.uint8)

N_CTX = 19
CTX_RL, CTX_UNI = 17, 18
# initial states (T.800 Table D.7): all 0 but these
CTX_INIT = {0: 4, CTX_RL: 3, CTX_UNI: 46}

# neighbour bits of the significance map: W, E, N, S, NW, NE, SW, SE
_W, _E, _N, _S, _NW, _NE, _SW, _SE = (1 << i for i in range(8))
# (dy, dx, bit the neighbour at (y + dy, x + dx) sets for a coefficient at
# (y, x) becoming significant): the neighbour sees it from the other side
_NEIGHBOURS = ((0, -1, _E), (0, 1, _W), (-1, 0, _S), (1, 0, _N),
               (-1, -1, _SE), (-1, 1, _SW), (1, -1, _NE), (1, 1, _NW))
_SIGN_NEIGHBOURS = ((0, -1, 1 << 1), (0, 1, 1 << 0), (-1, 0, 1 << 3),
                    (1, 0, 1 << 2))       # W, E, N, S negative bits

SIG, PI, REF, OUT = 1, 2, 4, 8        # coefficient state bits


def _zc_table() -> np.ndarray:
    """Zero-coding context (T.800 Table D.1) by orientation (0 LL, 1 HL,
    2 LH, 3 HH) and the 8 neighbour bits."""
    out = np.zeros((4, 256), np.uint8)
    for nb in range(256):
        h = (nb & _W > 0) + (nb & _E > 0)
        v = (nb & _N > 0) + (nb & _S > 0)
        d = sum(nb & b > 0 for b in (_NW, _NE, _SW, _SE))
        for orient in range(4):
            if orient == 3:
                hv = h + v
                if d >= 3:
                    c = 8
                elif d == 2:
                    c = 7 if hv >= 1 else 6
                elif d == 1:
                    c = 5 if hv >= 2 else 4 if hv == 1 else 3
                else:
                    c = 2 if hv >= 2 else hv
            else:
                a, b = (v, h) if orient == 1 else (h, v)
                if a == 2:
                    c = 8
                elif a == 1:
                    c = 7 if b >= 1 else 6 if d >= 1 else 5
                elif b == 2:
                    c = 4
                elif b == 1:
                    c = 3
                else:
                    c = 2 if d >= 2 else d
            out[orient, nb] = c
    return out


def _sc_table() -> np.ndarray:
    """Sign-coding context and XOR bit (T.800 Tables D.2, D.3), indexed by
    the W, E, N, S significance bits | their negative bits << 4:
    context | xor << 7."""
    out = np.zeros(256, np.uint8)
    for i in range(256):
        contrib = []
        for k in range(4):
            s = (i >> k) & 1
            n = (i >> (4 + k)) & 1
            contrib.append(0 if not s else (-1 if n else 1))
        h = max(-1, min(1, contrib[0] + contrib[1]))
        v = max(-1, min(1, contrib[2] + contrib[3]))
        if h < 0 or (h == 0 and v < 0):
            h, v, xor = -h, -v, 1
        else:
            xor = 0
        ctx = {(1, 1): 13, (1, 0): 12, (1, -1): 11, (0, 1): 10,
               (0, 0): 9}[(h, v)]
        out[i] = ctx | (xor << 7)
    return out


ZC = _zc_table()
SC = _sc_table()


class _MQ:
    """The MQ decoders of a batch of code-blocks (T.800 C.3, in the
    register convention of OpenJPEG's mqc.c): A, C, CT and a byte pointer
    into one buffer holding every block's bytes, each followed by
    0xFF 0xFF so that reading on past a block's end feeds 1-bits."""

    def __init__(self, buf: np.ndarray, starts: np.ndarray):
        self.buf = buf
        n = len(starts)
        self.bp = starts.astype(np.int64)
        self.c = buf[self.bp].astype(np.uint32) << 16
        self.ct = np.zeros(n, np.int32)
        self.a = np.full(n, 0x8000, np.uint32)
        self._bytein(np.arange(n))
        self.c <<= 7
        self.ct -= 7
        self.state = np.zeros((n, N_CTX), np.uint8)
        self.mps = np.zeros((n, N_CTX), np.uint8)
        for cx, s in CTX_INIT.items():
            self.state[:, cx] = s

    def _bytein(self, idx: np.ndarray):
        """BYTEIN for the blocks idx."""
        bp = self.bp[idx]
        b0 = self.buf[bp]
        b1 = self.buf[bp + 1].astype(np.uint32)
        ff = b0 == 0xFF
        marker = ff & (b1 > 0x8F)
        adv = ~marker
        bp = bp + adv
        self.bp[idx] = bp
        add = np.where(marker, np.uint32(0xFF00),
                       np.where(ff, b1 << 9, b1 << 8)).astype(np.uint32)
        self.c[idx] += add
        self.ct[idx] = np.where(ff & ~marker, 7, 8)

    def decode(self, idx: np.ndarray, cx: np.ndarray) -> np.ndarray:
        """One decision for each block idx (distinct) in its context cx."""
        st = self.state[idx, cx]
        mps = self.mps[idx, cx]
        qe = QE[st]
        a = self.a[idx] - qe
        c = self.c[idx]
        lps = (c >> 16) < qe
        c = np.where(lps, c, c - (qe << 16))
        renorm = lps | ((a & 0x8000) == 0)
        small = a < qe
        # the LPS symbol comes out of the LPS path when A >= Qe, and out
        # of the MPS path (conditional exchange) when A < Qe
        lps_sym = renorm & (small != lps)
        d = mps ^ lps_sym
        a = np.where(lps, qe, a)
        self.c[idx] = c
        self.a[idx] = a
        if renorm.any():
            r = np.flatnonzero(renorm)
            ri, rc, rs = idx[r], cx[r], st[r]
            ls = lps_sym[r]
            self.state[ri, rc] = np.where(ls, NLPS[rs], NMPS[rs])
            self.mps[ri, rc] = mps[r] ^ (ls & (SWITCH[rs] == 1))
            self._renorm(ri)
        return d

    def _renorm(self, idx: np.ndarray):
        """RENORMD: shift A and C left until A >= 0x8000, reading a byte
        whenever CT runs out."""
        a = self.a[idx]
        need = 15 - np.floor(np.log2(a.astype(np.float64))).astype(np.int32)
        while idx.size:
            ct = self.ct[idx]
            empty = ct == 0
            if empty.any():
                self._bytein(idx[empty])
                ct = self.ct[idx]
            s = np.minimum(need, ct)
            self.a[idx] <<= s.astype(np.uint32)
            self.c[idx] <<= s.astype(np.uint32)
            self.ct[idx] = ct - s
            need = need - s
            left = need > 0
            idx, need = idx[left], need[left]


def pack(blocks):
    """(every block's bytes in one uint8 buffer, each followed by
    0xFF 0xFF; the int64 start of each; the passes to decode of each:
    those down to bit-plane 0, as OpenJPEG stops there too)."""
    chunks, starts, pos = [], [], 0
    for b in blocks:
        chunks.append(bytes(b[0]) + b"\xff\xff")
        starts.append(pos)
        pos += len(chunks[-1])
    npass = np.array([min(n, 3 * nb - 2) if nb > 0 else 0
                      for (_, n, nb, _, _, _) in blocks], np.int32)
    return (np.frombuffer(b"".join(chunks), np.uint8),
            np.array(starts, np.int64), npass)


class _Batch:
    """The state of a batch of code-blocks decoded in lockstep, sorted by
    their number of passes (the first m of them still coding): the MQ
    decoders and, per coefficient, padded by one on every side so that
    neighbour updates need no bounds, the state bits, the neighbours'
    significance bits (nbz) and negative W, E, N, S bits (nbneg), the
    doubled magnitude (val) and the sign (neg).  Positions outside a
    block are SIG | OUT: never coded, never a neighbour."""

    def __init__(self, buf, starts, sizes, orient):
        n = len(sizes)
        self.h = max(h for h, _ in sizes)
        self.w = max(w for _, w in sizes)
        self.mq = _MQ(buf, starts)
        self.orient = np.asarray(orient, np.int64) * 256
        self.state = np.zeros((n, self.h + 2, self.w + 2), np.uint8)
        for k, (h, w) in enumerate(sizes):
            self.state[k, h + 1:, :] = SIG | OUT
            self.state[k, :, w + 1:] = SIG | OUT
        self.nbz = np.zeros_like(self.state)
        self.nbneg = np.zeros_like(self.state)
        self.val = np.zeros(self.state.shape, np.int32)
        self.neg = np.zeros(self.state.shape, bool)
        self.order = np.array([(y0 + r, x) for y0 in range(0, self.h, 4)
                               for x in range(self.w)
                               for r in range(min(4, self.h - y0))])

    def _zc(self, ids, Y, X):
        return ZC.ravel()[self.orient[ids] + self.nbz[ids, Y, X]].astype(
            np.int64)

    def significant(self, ids, y, x, plane):
        """Decode the signs of blocks ids at (y, x) and make them
        significant at bit-plane `plane` (per block)."""
        Y, X = y + 1, x + 1
        sc = SC[(self.nbz[ids, Y, X] & 15) | (self.nbneg[ids, Y, X] << 4)]
        negative = (self.mq.decode(ids, (sc & 127).astype(np.int64))
                    ^ (sc >> 7)).astype(bool)
        self.state[ids, Y, X] |= SIG
        self.val[ids, Y, X] = 3 << plane
        self.neg[ids, Y, X] = negative
        for dy, dx, bit in _NEIGHBOURS:
            self.nbz[ids, Y + dy, X + dx] |= bit
        nids = ids[negative]
        if nids.size:
            for dy, dx, bit in _SIGN_NEIGHBOURS:
                self.nbneg[nids, Y + dy, X + dx] |= bit

    def spp(self, m, plane):
        """Significance propagation: each insignificant coefficient with
        a significant neighbour, in scan order."""
        for y, x in self.order.tolist():
            Y, X = y + 1, x + 1
            nb = self.nbz[:m, Y, X]
            ids = np.flatnonzero(((self.state[:m, Y, X] & SIG) == 0)
                                 & (nb != 0))
            if ids.size:
                d = self.mq.decode(ids, self._zc(ids, Y, X))
                self.state[ids, Y, X] |= PI
                hit = ids[d == 1]
                if hit.size:
                    self.significant(hit, y, x, plane[hit])

    def mrp(self, m, plane):
        """Magnitude refinement of the coefficients significant before
        this bit-plane: their contexts (14 / 15 by the neighbours at a
        first refinement, else 16) are fixed before the pass, so step j
        decodes each block's j-th refinement."""
        ys, xs = self.order[:, 0] + 1, self.order[:, 1] + 1
        s = self.state[:m, ys, xs]
        want = (s & (SIG | PI | OUT)) == SIG
        b_idx, p_idx = np.nonzero(want)
        rank = (np.cumsum(want, 1) - 1)[b_idx, p_idx]
        ctx = np.where(s[b_idx, p_idx] & REF, 16, np.where(
            self.nbz[b_idx, ys[p_idx], xs[p_idx]] != 0, 15, 14))
        by_rank = np.argsort(rank, kind="stable")
        b_idx, p_idx, ctx = b_idx[by_rank], p_idx[by_rank], ctx[by_rank]
        steps = int(want.sum(1).max()) if want.size else 0
        bounds = np.searchsorted(rank[by_rank], np.arange(steps + 1))
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            ids, pp = b_idx[lo:hi], p_idx[lo:hi]
            d = self.mq.decode(ids, ctx[lo:hi].astype(np.int64))
            Y, X = ys[pp], xs[pp]
            self.val[ids, Y, X] += np.where(d == 1, 1, -1) << plane[ids]
            self.state[ids, Y, X] |= REF

    def cup(self, m, plane):
        """Cleanup: the coefficients the propagation pass did not code,
        a column of four insignificant ones with insignificant
        neighbours in run-length mode."""
        for y0 in range(0, self.h, 4):
            rows = min(4, self.h - y0)
            for x in range(self.w):
                X = x + 1
                start = np.zeros(m, np.int32)
                if rows == 4:
                    run = ((self.state[:m, y0 + 1:y0 + 5, X] & (SIG | PI))
                           == 0).all(1) & (
                        self.nbz[:m, y0 + 1:y0 + 5, X] == 0).all(1)
                    ids = np.flatnonzero(run)
                    if ids.size:
                        d = self.mq.decode(ids, np.full(ids.size, CTX_RL))
                        start[ids[d == 0]] = 4      # four stay insignificant
                        hit = ids[d == 1]
                        if hit.size:
                            uni = np.full(hit.size, CTX_UNI)
                            r = self.mq.decode(hit, uni).astype(np.int32) << 1
                            r |= self.mq.decode(hit, uni)
                            start[hit] = r + 1
                            for rr in range(4):
                                at = hit[r == rr]
                                if at.size:
                                    self.significant(at, y0 + rr, x,
                                                     plane[at])
                for r in range(rows):
                    Y = y0 + r + 1
                    ids = np.flatnonzero(
                        ((self.state[:m, Y, X] & (SIG | PI)) == 0)
                        & (start <= r))
                    if ids.size:
                        d = self.mq.decode(ids, self._zc(ids, Y, X))
                        hit = ids[d == 1]
                        if hit.size:
                            self.significant(hit, y0 + r, x, plane[hit])
        self.state[:m] &= ~np.uint8(PI)


def decode_blocks(blocks) -> list[np.ndarray]:
    """Decode code-blocks given as (data bytes, number of coding passes,
    number of coded bit-planes, orientation 0 LL / 1 HL / 2 LH / 3 HH,
    height, width).  Returns one (height, width) int32 array each: the
    signed coefficient, twice its magnitude plus half the step of its
    last decoded bit-plane (0 where it stayed insignificant)."""
    out = [np.zeros((h, w), np.int32) for (_, _, _, _, h, w) in blocks]
    buf, starts, npass = pack(blocks)
    live = sorted((i for i, b in enumerate(blocks)
                   if npass[i] > 0 and b[4] > 0 and b[5] > 0),
                  key=lambda i: -npass[i])
    if not live:
        return out
    batch = _Batch(buf, starts[live], [blocks[i][4:6] for i in live],
                   [blocks[i][3] for i in live])
    npasses = npass[live]
    top = np.array([blocks[i][2] - 1 for i in live], np.int32)
    for k in range(int(npasses[0])):
        m = int(np.count_nonzero(npasses > k))
        # CUP at the top bit-plane, then SPP, MRP, CUP per lower one
        kind = 2 if k == 0 else (k - 1) % 3
        plane = top[:m] - (0 if k == 0 else 1 + (k - 1) // 3)
        (batch.spp, batch.mrp, batch.cup)[kind](m, plane)
    for k, i in enumerate(live):
        h, w = blocks[i][4], blocks[i][5]
        v = batch.val[k, 1:h + 1, 1:w + 1]
        out[i] = np.where(batch.neg[k, 1:h + 1, 1:w + 1], -v, v)
    return out


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------


class _MQEncoder:
    """One MQ encoder as OpenJPEG's mqc.c runs it (T.800 C.2): out[0] is a
    dummy 0 byte before the block's first, so that the first BYTEOUT may
    look at the byte before it."""

    def __init__(self):
        self.out = bytearray(1)
        self.bp = 0
        self.a, self.c, self.ct = 0x8000, 0, 12
        self.st = [0] * N_CTX
        self.mps = [0] * N_CTX
        for cx, s in CTX_INIT.items():
            self.st[cx] = s

    def _put(self, v):
        v &= 0xFF                               # the C byte cast
        self.bp += 1
        if self.bp == len(self.out):
            self.out.append(v)
        else:
            self.out[self.bp] = v

    def _byteout(self):
        if self.out[self.bp] == 0xFF:
            self._put(self.c >> 20)
            self.c &= 0xFFFFF
            self.ct = 7
        elif not self.c & 0x8000000:
            self._put(self.c >> 19)
            self.c &= 0x7FFFF
            self.ct = 8
        else:
            self.out[self.bp] += 1
            if self.out[self.bp] == 0xFF:
                self.c &= 0x7FFFFFF
                self._put(self.c >> 20)
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                self._put(self.c >> 19)
                self.c &= 0x7FFFF
                self.ct = 8

    def _renorme(self):
        while True:
            self.a <<= 1
            self.c = (self.c << 1) & 0xFFFFFFFF  # a 32-bit register
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                return

    def encode(self, cx, d):
        s = self.st[cx]
        qe = _QE_TABLE[s][0]
        self.a -= qe
        if d == self.mps[cx]:
            if self.a & 0x8000:
                self.c += qe
                return
            if self.a < qe:
                self.a = qe
            else:
                self.c += qe
            self.st[cx] = _QE_TABLE[s][1]
        else:
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if _QE_TABLE[s][3]:
                self.mps[cx] = 1 - self.mps[cx]
            self.st[cx] = _QE_TABLE[s][2]
        self._renorme()

    def flush(self) -> bytes:
        """FLUSH (T.800 Figure C.10); the block's bytes, a last 0xFF
        dropped."""
        t = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= t:
            self.c -= 0x8000
        for _ in range(2):
            self.c = (self.c << self.ct) & 0xFFFFFFFF
            self._byteout()
        if self.out[self.bp] != 0xFF:
            self.bp += 1
        return bytes(self.out[1:self.bp])


def encode_block(coef: np.ndarray, orient: int) -> tuple[int, bytes]:
    """Tier 1 of one code-block of signed coefficients (h, w), orientation
    0 LL / 1 HL / 2 LH / 3 HH, as OpenJPEG codes it in its lossless single
    layer: every pass of every bit-plane, ended by the MQ flush.  Returns
    (number of coded bit-planes, bytes); (0, b"") for a block of zeros.
    Plain Python, one coefficient at a time: native/j2k_t1.cpp's
    avrt_j2k_encode_blocks is its twin."""
    h, w = coef.shape
    pw = w + 2
    mag = [0] * ((h + 2) * pw)
    neg = [0] * len(mag)
    for y in range(h):
        for x in range(w):
            v = int(coef[y, x])
            mag[(y + 1) * pw + x + 1] = abs(v)
            neg[(y + 1) * pw + x + 1] = int(v < 0)
    planes = max(mag).bit_length()
    if not planes:
        return 0, b""
    state = [0] * len(mag)
    nbz = [0] * len(mag)
    nbneg = [0] * len(mag)
    zc = [int(c) for c in ZC[orient]]
    sc = [int(c) for c in SC]
    mq = _MQEncoder()

    def significant(i):
        c = sc[(nbz[i] & 15) | (nbneg[i] << 4)]
        mq.encode(c & 127, neg[i] ^ (c >> 7))
        state[i] |= SIG
        for d, b in ((-1, _E), (1, _W), (-pw, _S), (pw, _N), (-pw - 1, _SE),
                     (-pw + 1, _SW), (pw - 1, _NE), (pw + 1, _NW)):
            nbz[i + d] |= b
        if neg[i]:
            for d, b in ((-1, _E), (1, _W), (-pw, _S), (pw, _N)):
                nbneg[i + d] |= b

    def scan():
        for y0 in range(0, h, 4):
            for x in range(w):
                yield y0, x, [(y0 + r + 1) * pw + x + 1
                              for r in range(min(4, h - y0))]

    for p in range(3 * planes - 2):
        kind = 2 if p == 0 else (p - 1) % 3
        plane = planes - 1 - (0 if p == 0 else 1 + (p - 1) // 3)
        for y0, x, col in scan():
            if kind == 0:                       # significance propagation
                for i in col:
                    if state[i] & SIG or not nbz[i]:
                        continue
                    state[i] |= PI
                    b = mag[i] >> plane & 1
                    mq.encode(zc[nbz[i]], b)
                    if b:
                        significant(i)
            elif kind == 1:                     # magnitude refinement
                for i in col:
                    if state[i] & (SIG | PI) != SIG:
                        continue
                    mq.encode(16 if state[i] & REF else 15 if nbz[i] else 14,
                              mag[i] >> plane & 1)
                    state[i] |= REF
            else:                               # cleanup
                start = 0
                if len(col) == 4 and all(
                        not state[i] & (SIG | PI) and not nbz[i] for i in col):
                    bits = [mag[i] >> plane & 1 for i in col]
                    if not any(bits):
                        mq.encode(CTX_RL, 0)
                        continue
                    r = bits.index(1)
                    mq.encode(CTX_RL, 1)
                    mq.encode(CTX_UNI, r >> 1)
                    mq.encode(CTX_UNI, r & 1)
                    significant(col[r])
                    start = r + 1
                for i in col[start:]:
                    if state[i] & (SIG | PI):
                        continue
                    b = mag[i] >> plane & 1
                    mq.encode(zc[nbz[i]], b)
                    if b:
                        significant(i)
        if kind == 2:
            state = [s & ~PI for s in state]
    return planes, mq.flush()


def encode_blocks(blocks) -> list[tuple[int, bytes]]:
    """encode_block of each (coefficients, orientation) in blocks."""
    return [encode_block(c, o) for c, o in blocks]
