"""NanoVDB `.nvdb` file reader and writer (port of
acceleratedvolrenderer_tpu/utils/nvdb.py, numpy only).

The on-disk format that pbrt's `nanovdb2pbrt` converter and NanoVDBMedium
read:

  FileHeader | per-grid FileMetaData + name | grid blob (raw or zlib)

with the standard float-grid tree: GridData(672B) -> TreeData(64B) ->
RootData + root tiles -> upper internal nodes (32^3) -> lower internal
nodes (16^3) -> leaf nodes (8^3, 512 float values each).

Layout constants follow NanoVDB ABI version 32.3:
  * masks are little-endian uint64 words, bit i of word w = entry w*64+i;
  * in-node offsets are x-major: leaf offset = (x&7)<<6 | (y&7)<<3 | (z&7);
  * internal-table and root-tile `child` entries are byte offsets relative
    to the holding node's start;
  * the root uses the single-uint64 key (ijk>>12 packed 21 bits/axis).

Codecs NONE, ZIP and BLOSC (utils/blosc.py: LZ4 block format + byte
shuffle, the combination NanoVDB IO emits).  The writer produces files
this reader round-trips bit-exactly; the reader also takes grids whose
stats / checksum fields are unset.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np

MAGIC = 0x304244566F6E614E          # "NanoVDB0" little-endian
SUPPORTED_MAJOR = 32

# GridType (NanoVDB.h enum GridType)
GRID_TYPE_FLOAT = 1
# GridClass (NanoVDB.h enum GridClass)
GRID_CLASS_UNKNOWN = 0
GRID_CLASS_LEVEL_SET = 1
GRID_CLASS_FOG_VOLUME = 3
# Codec (util/IO.h enum Codec)
CODEC_NONE, CODEC_ZIP, CODEC_BLOSC = 0, 1, 2

GRID_DATA_SIZE = 672
TREE_DATA_SIZE = 64
ROOT_HEADER_SIZE = 64      # RootData<float> padded to 32B alignment
ROOT_TILE_SIZE = 32        # {u64 key; i64 child; u32 state; f32 value} + pad
UPPER_HEADER = 8256        # bbox24+flags8+masks(2*4096)+stats16 pad->32
UPPER_TABLE = 32768 * 8
UPPER_SIZE = UPPER_HEADER + UPPER_TABLE
LOWER_HEADER = 1088        # bbox24+flags8+masks(2*512)+stats16 pad->32
LOWER_TABLE = 4096 * 8
LOWER_SIZE = LOWER_HEADER + LOWER_TABLE
LEAF_HEADER = 96           # bboxmin12+dif3+flags1+mask64+stats16
LEAF_SIZE = LEAF_HEADER + 512 * 4

FILE_HEADER = struct.Struct("<QIHH")                 # magic, version, n, codec
# gridSize fileSize nameKey voxelCount gridType gridClass worldBBox[6]d
# indexBBox[6]i voxelSize[3]d nameSize nodeCount[4] tileCount[3] codec pad ver
FILE_META = struct.Struct("<QQQQ II 6d 6i 3d I 4I 3I HH I")


def _version(major=32, minor=3, patch=0):
    return (major << 21) | (minor << 10) | patch


def _version_major(v):
    return v >> 21


@dataclass
class NvdbGrid:
    """A densified NanoVDB float grid."""
    name: str
    data: np.ndarray          # (nz, ny, nx) float32 over the index bbox
    index_min: tuple          # (ix, iy, iz) of data[0,0,0]
    world_bbox: np.ndarray    # (2, 3) float64
    voxel_size: np.ndarray    # (3,) float64
    grid_class: int = GRID_CLASS_FOG_VOLUME
    background: float = 0.0

    @property
    def is_fog_volume(self):
        return self.grid_class == GRID_CLASS_FOG_VOLUME


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _mask_indices(words: np.ndarray) -> np.ndarray:
    """Set-bit entry indices of a little-endian uint64 mask array."""
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return np.nonzero(bits)[0]


def read_nvdb(path: str, grid_name: str | None = None) -> NvdbGrid:
    """Read one float grid from a .nvdb file, densified over its index
    bounding box (cmd/nanovdb2pbrt.cpp getValue semantics: leaf-stored
    values where leaves exist, tile/background values elsewhere)."""
    with open(path, "rb") as f:
        raw = f.read()
    magic, version, grid_count, codec = FILE_HEADER.unpack_from(raw, 0)
    if magic != MAGIC:
        raise ValueError(f"{path}: not a NanoVDB file (bad magic "
                         f"{magic:#x})")
    if _version_major(version) != SUPPORTED_MAJOR:
        raise ValueError(
            f"{path}: unsupported NanoVDB ABI major "
            f"{_version_major(version)} (supported: {SUPPORTED_MAJOR})")
    pos = FILE_HEADER.size
    names, metas, blobs = [], [], []
    for _ in range(grid_count):
        meta = FILE_META.unpack_from(raw, pos)
        pos += FILE_META.size
        grid_size, file_size = meta[0], meta[1]
        name_size = meta[21]
        g_codec = meta[29]
        name = raw[pos: pos + name_size].split(b"\0")[0].decode()
        pos += name_size
        blob = raw[pos: pos + file_size]
        pos += file_size
        if g_codec == CODEC_ZIP:
            blob = zlib.decompress(blob)
        elif g_codec == CODEC_BLOSC:
            # real WDAS exports use blosc (LZ4 + byte shuffle); decoded by
            # the from-scratch chunk codec (utils/blosc.py)
            from . import blosc as blosc_mod

            blob = blosc_mod.decompress(blob)
        if len(blob) != grid_size:
            raise ValueError(f"{path}: grid '{name}' decodes to "
                             f"{len(blob)} bytes, expected {grid_size}")
        names.append(name)
        metas.append(meta)
        blobs.append(blob)
    if grid_name is None:
        idx = 0
    else:
        if grid_name not in names:
            raise KeyError(f"{path}: no grid named '{grid_name}' "
                           f"(grids: {names})")
        idx = names.index(grid_name)
    return _parse_grid(np.frombuffer(blobs[idx], np.uint8), names[idx])


def list_grids(path: str) -> list[str]:
    with open(path, "rb") as f:
        raw = f.read()
    magic, version, grid_count, _ = FILE_HEADER.unpack_from(raw, 0)
    if magic != MAGIC:
        raise ValueError(f"{path}: not a NanoVDB file")
    pos, names = FILE_HEADER.size, []
    for _ in range(grid_count):
        meta = FILE_META.unpack_from(raw, pos)
        pos += FILE_META.size
        names.append(raw[pos: pos + meta[21]].split(b"\0")[0].decode())
        pos += meta[21] + meta[1]
    return names


def _parse_grid(buf: np.ndarray, name: str) -> NvdbGrid:
    b = buf.tobytes()
    (g_magic, _checksum, g_version, _flags, _gidx, _gcnt,
     _gsize) = struct.unpack_from("<QQIIIIQ", b, 0)
    if g_magic != MAGIC:
        raise ValueError("grid blob: bad GridData magic")
    if _version_major(g_version) != SUPPORTED_MAJOR:
        raise ValueError(f"grid blob: unsupported ABI major "
                         f"{_version_major(g_version)}")
    world_bbox = np.frombuffer(b, np.float64, 6, 560).reshape(2, 3).copy()
    voxel_size = np.frombuffer(b, np.float64, 3, 608).copy()
    grid_class, grid_type = struct.unpack_from("<II", b, 632)
    if grid_type != GRID_TYPE_FLOAT:
        raise NotImplementedError(f"grid type {grid_type} (only float "
                                  "grids are supported)")

    toff = GRID_DATA_SIZE
    node_off = struct.unpack_from("<4Q", b, toff)           # leaf,lower,upper,root
    _node_cnt = struct.unpack_from("<3I", b, toff + 32)
    root = toff + node_off[3]

    ibb = np.array(struct.unpack_from("<6i", b, root)).reshape(2, 3)
    (table_size,) = struct.unpack_from("<I", b, root + 24)
    background = struct.unpack_from("<f", b, root + 28)[0]

    imin, imax = ibb[0], ibb[1]
    if np.any(imax < imin):   # empty grid
        return NvdbGrid(name, np.zeros((1, 1, 1), np.float32),
                        (0, 0, 0), world_bbox, voxel_size, grid_class,
                        background)
    shape = (imax - imin + 1)[::-1]          # (nz, ny, nx)
    dense = np.full(shape, background, np.float32)

    f32 = np.frombuffer(b, np.float32)
    u64 = np.frombuffer(b, np.uint64)

    def fill_region(zyx0, side, value):
        """Fill a tile cube clipped against the index bbox."""
        z0, y0, x0 = zyx0
        sl = []
        for lo, n in ((z0 - imin[2], shape[0]), (y0 - imin[1], shape[1]),
                      (x0 - imin[0], shape[2])):
            a, bnd = max(lo, 0), min(lo + side, n)
            if a >= bnd:
                return
            sl.append(slice(a, bnd))
        dense[sl[0], sl[1], sl[2]] = value

    def read_leaf(off, origin):
        vals = f32[(off + LEAF_HEADER) // 4:][:512].reshape(8, 8, 8)
        # mValues is x-major (x<<6|y<<3|z) -> transpose to (z, y, x)
        vals = vals.transpose(2, 1, 0)
        x0, y0, z0 = origin
        zs, ys, xs = z0 - imin[2], y0 - imin[1], x0 - imin[0]
        # leaves are bbox-aligned only to 8; clip against dense extent
        za, zb = max(zs, 0), min(zs + 8, shape[0])
        ya, yb = max(ys, 0), min(ys + 8, shape[1])
        xa, xb = max(xs, 0), min(xs + 8, shape[2])
        if za >= zb or ya >= yb or xa >= xb:
            return
        dense[za:zb, ya:yb, xa:xb] = vals[za - zs:zb - zs,
                                          ya - ys:yb - ys,
                                          xa - xs:xb - xs]

    def read_internal(off, origin, level):
        """level 2 = upper (32^3 of 128-voxel children), 1 = lower."""
        if level == 2:
            log2, header, child_side = 5, UPPER_HEADER, 128
            mask_words = 512
        else:
            log2, header, child_side = 4, LOWER_HEADER, 8
            mask_words = 64
        n = 1 << (3 * log2)
        vmask = u64[(off + 32) // 8:][:mask_words]
        cmask = u64[(off + 32 + mask_words * 8) // 8:][:mask_words]
        table_off = off + header
        table_u64 = u64[table_off // 8:][:n]
        table_f32 = f32[table_off // 4:][: 2 * n: 2]   # value = low 4 bytes
        child_idx = _mask_indices(cmask)
        dim = 1 << log2
        for e in child_idx:
            x = int(e) >> (2 * log2)
            y = (int(e) >> log2) & (dim - 1)
            z = int(e) & (dim - 1)
            corigin = (origin[0] + x * child_side,
                       origin[1] + y * child_side,
                       origin[2] + z * child_side)
            coff = off + int(table_u64[e].astype(np.int64))
            if level == 2:
                read_internal(coff, corigin, 1)
            else:
                read_leaf(coff, corigin)
        # active value tiles
        cset = set(int(v) for v in child_idx)
        for e in _mask_indices(vmask):
            if int(e) in cset:
                continue
            x = int(e) >> (2 * log2)
            y = (int(e) >> log2) & (dim - 1)
            z = int(e) & (dim - 1)
            fill_region((origin[2] + z * child_side,
                         origin[1] + y * child_side,
                         origin[0] + x * child_side), child_side,
                        table_f32[e])

    tile0 = root + ROOT_HEADER_SIZE
    for t in range(table_size):
        off = tile0 + t * ROOT_TILE_SIZE
        key, child = struct.unpack_from("<qq", b, off)
        state, value = struct.unpack_from("<If", b, off + 16)
        # unpack single-root-key: 21 bits per axis of (ijk >> 12)
        kz = (key & 0x1FFFFF) << 12
        ky = ((key >> 21) & 0x1FFFFF) << 12
        kx = ((key >> 42) & 0x1FFFFF) << 12
        # sign-extend from the 21-bit field (coords / 4096)
        def sext(v):
            return v - (1 << 33) if v & (1 << 32) else v
        origin = (sext(kx), sext(ky), sext(kz))
        if child >= 0:
            read_internal(root + child, origin, 2)
        elif state:
            fill_region((origin[2], origin[1], origin[0]), 4096, value)

    return NvdbGrid(name, dense, tuple(int(v) for v in imin), world_bbox,
                    voxel_size, grid_class, background)


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _pack_mask(bits: np.ndarray) -> bytes:
    """bool array (n,) -> little-endian uint64 mask words."""
    return np.packbits(bits.astype(np.uint8), bitorder="little").tobytes()


def write_nvdb(path: str, grids, codec: str = "none"):
    """Write float grid(s) to a .nvdb file.

    `grids` is an NvdbGrid or dict name -> (data, kwargs-like NvdbGrid).
    All-background leaves are pruned (that is the point of the format);
    the tree mirrors what nanovdb::createFogVolume produces structurally.
    """
    if isinstance(grids, NvdbGrid):
        grids = [grids]
    codec_id = {"none": CODEC_NONE, "zip": CODEC_ZIP,
                "blosc": CODEC_BLOSC}[codec]
    out = [FILE_HEADER.pack(MAGIC, _version(), len(grids), codec_id)]
    for g in grids:
        blob = _build_grid(g, len(grids))
        if codec_id == CODEC_ZIP:
            stored = zlib.compress(blob)
        elif codec_id == CODEC_BLOSC:
            from . import blosc as blosc_mod

            stored = blosc_mod.compress(bytes(blob), typesize=4)
        else:
            stored = blob
        name_b = g.name.encode() + b"\0"
        dense = np.asarray(g.data, np.float32)
        nz, ny, nx = dense.shape
        ix, iy, iz = g.index_min
        n_leaf, n_lower, n_upper = _count_nodes(dense, g.index_min,
                                                g.background)
        meta = FILE_META.pack(
            len(blob), len(stored), 0, int((dense != g.background).sum()),
            GRID_TYPE_FLOAT, g.grid_class,
            *np.asarray(g.world_bbox, np.float64).reshape(-1),
            ix, iy, iz, ix + nx - 1, iy + ny - 1, iz + nz - 1,
            *np.asarray(g.voxel_size, np.float64),
            len(name_b), n_leaf, n_lower, n_upper, 1, 0, 0, 0,
            codec_id, 0, _version())
        out += [meta, name_b, stored]
    with open(path, "wb") as f:
        f.write(b"".join(out))


def _leaf_blocks(dense, index_min, background):
    """Yield (leaf_origin_xyz, (8,8,8) values) for non-empty leaves."""
    nz, ny, nx = dense.shape
    ix, iy, iz = index_min
    x0 = (ix // 8) * 8
    y0 = (iy // 8) * 8
    z0 = (iz // 8) * 8
    x1 = -(-(ix + nx) // 8) * 8
    y1 = -(-(iy + ny) // 8) * 8
    z1 = -(-(iz + nz) // 8) * 8
    pad = np.full(((z1 - z0), (y1 - y0), (x1 - x0)), background, np.float32)
    pad[iz - z0: iz - z0 + nz, iy - y0: iy - y0 + ny,
        ix - x0: ix - x0 + nx] = dense
    for lz in range(z0, z1, 8):
        for ly in range(y0, y1, 8):
            for lx in range(x0, x1, 8):
                blk = pad[lz - z0: lz - z0 + 8, ly - y0: ly - y0 + 8,
                          lx - x0: lx - x0 + 8]
                if np.any(blk != background):
                    yield (lx, ly, lz), blk


def _count_nodes(dense, index_min, background):
    leaves = list(_leaf_blocks(dense, index_min, background))
    lowers = {(o[0] // 128, o[1] // 128, o[2] // 128) for o, _ in leaves}
    uppers = {(o[0] // 4096, o[1] // 4096, o[2] // 4096) for o, _ in leaves}
    return len(leaves), len(lowers), len(uppers)


def _build_grid(g: NvdbGrid, grid_count: int) -> bytes:
    dense = np.asarray(g.data, np.float32)
    bg = float(g.background)
    leaves = list(_leaf_blocks(dense, g.index_min, bg))
    if not leaves:
        leaves = [((g.index_min[0] // 8 * 8, g.index_min[1] // 8 * 8,
                    g.index_min[2] // 8 * 8),
                   np.full((8, 8, 8), bg, np.float32))]

    # group leaves under lower nodes, lowers under uppers, uppers under root
    lowers: dict = {}
    for origin, blk in leaves:
        lkey = (origin[0] // 128 * 128, origin[1] // 128 * 128,
                origin[2] // 128 * 128)
        lowers.setdefault(lkey, []).append((origin, blk))
    uppers: dict = {}
    for lkey in lowers:
        ukey = (lkey[0] // 4096 * 4096, lkey[1] // 4096 * 4096,
                lkey[2] // 4096 * 4096)
        uppers.setdefault(ukey, []).append(lkey)

    upper_keys = sorted(uppers)
    lower_keys = sorted(lowers)
    leaf_keys = [o for o, _ in leaves]

    root_off = GRID_DATA_SIZE + TREE_DATA_SIZE
    root_size = ROOT_HEADER_SIZE + len(upper_keys) * ROOT_TILE_SIZE
    upper_off = root_off + root_size
    lower_off = upper_off + len(upper_keys) * UPPER_SIZE
    leaf_off = lower_off + len(lower_keys) * LOWER_SIZE
    total = leaf_off + len(leaves) * LEAF_SIZE

    upper_pos = {k: upper_off + i * UPPER_SIZE
                 for i, k in enumerate(upper_keys)}
    lower_pos = {k: lower_off + i * LOWER_SIZE
                 for i, k in enumerate(lower_keys)}
    leaf_pos = {k: leaf_off + i * LEAF_SIZE
                for i, k in enumerate(leaf_keys)}

    buf = bytearray(total)

    nz, ny, nx = dense.shape
    ix, iy, iz = g.index_min
    ibb = (ix, iy, iz, ix + nx - 1, iy + ny - 1, iz + nz - 1)
    act = dense[dense != bg]
    vmin = float(act.min()) if act.size else bg
    vmax = float(act.max()) if act.size else bg

    # ---- GridData -------------------------------------------------------
    name_b = g.name.encode()[:255]
    struct.pack_into("<QQIIIIQ", buf, 0, MAGIC, 0, _version(), 0, 0,
                     grid_count, total)
    buf[40:40 + len(name_b)] = name_b
    # Map: float mat/inv/vec/taper then double mat/inv/vec/taper
    vs = np.asarray(g.voxel_size, np.float64)
    trans = np.asarray(g.world_bbox, np.float64)[0] - \
        np.array([ix, iy, iz]) * vs
    matf = np.zeros(9, np.float32)
    matf[[0, 4, 8]] = vs
    invf = np.zeros(9, np.float32)
    invf[[0, 4, 8]] = 1.0 / vs
    m = 296
    buf[m:m + 36] = matf.tobytes()
    buf[m + 36:m + 72] = invf.tobytes()
    buf[m + 72:m + 84] = np.asarray(trans, np.float32).tobytes()
    struct.pack_into("<f", buf, m + 84, 0.0)      # taper
    matd = np.zeros(9, np.float64)
    matd[[0, 4, 8]] = vs
    invd = np.zeros(9, np.float64)
    invd[[0, 4, 8]] = 1.0 / vs
    buf[m + 88:m + 160] = matd.tobytes()
    buf[m + 160:m + 232] = invd.tobytes()
    buf[m + 232:m + 256] = trans.tobytes()
    struct.pack_into("<d", buf, m + 256, 0.0)
    buf[560:608] = np.asarray(g.world_bbox, np.float64).tobytes()
    buf[608:632] = vs.tobytes()
    struct.pack_into("<IIqI", buf, 632, g.grid_class, GRID_TYPE_FLOAT, 0, 0)

    # ---- TreeData (offsets relative to TreeData start) -------------------
    t = GRID_DATA_SIZE
    struct.pack_into("<4Q3I3IQ", buf, t,
                     leaf_off - t, lower_off - t, upper_off - t,
                     root_off - t,
                     len(leaves), len(lower_keys), len(upper_keys),
                     0, 0, 0, int((dense != bg).sum()))

    # ---- RootData + tiles -------------------------------------------------
    struct.pack_into("<6iIfffff", buf, root_off, *ibb, len(upper_keys),
                     bg, vmin, vmax, 0.0, 0.0)
    for i, k in enumerate(upper_keys):
        key = (((k[0] >> 12) & 0x1FFFFF) << 42) | \
              (((k[1] >> 12) & 0x1FFFFF) << 21) | ((k[2] >> 12) & 0x1FFFFF)
        off = root_off + ROOT_HEADER_SIZE + i * ROOT_TILE_SIZE
        struct.pack_into("<QqIf", buf, off, key,
                         upper_pos[k] - root_off, 0, bg)

    # ---- upper internal nodes --------------------------------------------
    for k in upper_keys:
        off = upper_pos[k]
        struct.pack_into("<6iQ", buf, off, *ibb, 0)
        cmask = np.zeros(32768, bool)
        children = {}
        for lkey in uppers[k]:
            e = (((lkey[0] - k[0]) // 128) << 10) | \
                (((lkey[1] - k[1]) // 128) << 5) | ((lkey[2] - k[2]) // 128)
            cmask[e] = True
            children[e] = lkey
        buf[off + 32 + 4096: off + 32 + 8192] = _pack_mask(cmask)
        struct.pack_into("<ffff", buf, off + 32 + 8192, vmin, vmax, 0, 0)
        table = np.zeros(32768, np.int64)
        fval = np.full(32768, bg, np.float32)
        for e, lkey in children.items():
            table[e] = lower_pos[lkey] - off
        tb = off + UPPER_HEADER
        np.copyto(np.frombuffer(memoryview(buf)[tb:tb + UPPER_TABLE],
                                np.int64), table)
        # value-tile floats live in the union's low word; inactive
        # (bg == 0) tiles can stay zeroed
        if bg != 0.0:
            u = np.frombuffer(memoryview(buf)[tb:tb + UPPER_TABLE],
                              np.float32).reshape(-1, 2)
            keep = table == 0
            u[keep, 0] = fval[keep]

    # ---- lower internal nodes --------------------------------------------
    for k in lower_keys:
        off = lower_pos[k]
        struct.pack_into("<6iQ", buf, off, *ibb, 0)
        cmask = np.zeros(4096, bool)
        children = {}
        for lorigin, _blk in lowers[k]:
            e = (((lorigin[0] - k[0]) // 8) << 8) | \
                (((lorigin[1] - k[1]) // 8) << 4) | ((lorigin[2] - k[2]) // 8)
            cmask[e] = True
            children[e] = lorigin
        buf[off + 32 + 512: off + 32 + 1024] = _pack_mask(cmask)
        struct.pack_into("<ffff", buf, off + 32 + 1024, vmin, vmax, 0, 0)
        table = np.zeros(4096, np.int64)
        for e, lorigin in children.items():
            table[e] = leaf_pos[lorigin] - off
        tb = off + LOWER_HEADER
        np.copyto(np.frombuffer(memoryview(buf)[tb:tb + LOWER_TABLE],
                                np.int64), table)
        if bg != 0.0:
            u = np.frombuffer(memoryview(buf)[tb:tb + LOWER_TABLE],
                              np.float32).reshape(-1, 2)
            keep = table == 0
            u[keep, 0] = bg

    # ---- leaves ------------------------------------------------------------
    for origin, blk in leaves:
        off = leaf_pos[origin]
        struct.pack_into("<3i3BB", buf, off, *origin, 7, 7, 7, 0)
        vmask = (blk != bg).transpose(2, 1, 0).reshape(-1)  # x-major order
        buf[off + 16: off + 80] = _pack_mask(vmask)
        struct.pack_into("<ffff", buf, off + 80,
                         float(blk.min()), float(blk.max()), 0, 0)
        vals = blk.transpose(2, 1, 0).astype(np.float32)     # (x, y, z)
        buf[off + LEAF_HEADER: off + LEAF_SIZE] = vals.tobytes()

    return bytes(buf)
