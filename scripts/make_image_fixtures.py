"""Write the lossy WebP fixtures under tests/data/images/ and the SHA-256 of
PIL's decode of each (images.json).  Needs PIL with WebP support (the
machine that runs chip_smoke.py has no PIL, so phase 32 reads these files
and holds the port's decode to the hashes).

    python3 scripts/make_image_fixtures.py

  - sky_2048x1024_q90.webp: a 2048x1024 sky of sinusoids
    (time_image_decode.sky), quality 90: an environment map's size, timed
    by chip_smoke.py phase 32 (d) and scripts/time_image_decode.py;
  - ground_1024x512_q90.webp: a 1024x512 ground texture (tiles, grout and
    noise), quality 90: the imagemap of phase 32's ground quad.  Its
    record also holds the SHA-256 of the files PIL writes of its first
    128x96 decoded pixels, one per format the port writes byte for byte
    (`sha256_of_pil_files`, named fixture.<ext>): chip_smoke.py phase 33
    holds the port's files to them.  Phase 36's formats are recorded
    beside them: `sha256_of_pil_files_exact` for EPS, PS, PDF (written
    with time.gmtime fixed at `pdf_gmtime`), GIF and the six JPEG 2000
    extensions, and `pil_icon_files` for ICO and ICNS: each file's length
    and SHA-256, and the SHA-256 of each PNG entry's decompressed IDAT
    stream.  `pil_png_files` records PIL's PNG of the ground's first
    128x96 and 37x23 samples and of the whole ground the same way (length,
    SHA-256, SHA-256 of the IDAT stream), and `pil_zlib` the zlib version
    PIL deflates with: chip_smoke.py phases 33 and 36 assert the streams'
    hashes always, the files' where the host's zlib is that version.

It also records, without committing them, the block-compressed DDS files
scripts/block_maps.py rebuilds on any host (integer encoders), each under
its name with `rebuilt_by` and the SHA-256 of its bytes: the 2048x1024
sky in BC1, BC3, BC4, BC5, BC6H and BC7 (chip_smoke.py phase 34's sky map
and its timed decodes) and the ground's decoded samples in BC7
(ground_1024x512_bc7.dds, phase 34's ground texture).  Phase 34 holds the
rebuilt files and the port's decodes of them to these hashes.

It writes the JPEG 2000 fixtures of chip_smoke.py phase 35 from the WebP
fixtures' samples (PIL's decode), with their SHA-256 and that of PIL's
decode of each (`sha256_of_bytes`, `sha256_of_pil_samples`):
  - sky_2048x1024_97.jp2: JP2, irreversible 9/7, quality layers at rates
    80 and 40, RPCL, 512x512 tiles, 32x32 code-blocks, 128x128 precincts
    (phase 35's sky map);
  - ground_1024x512_53.j2k: a raw codestream, reversible 5/3, one layer
    at rate 20, LRCP, default code-blocks (phase 35's ground texture);
  - sky_512x256_lossless.jp2: the sky's first 512x256 pixels, lossless
    5/3 (timed by phase 35 and scripts/time_image_decode.py).
tests/test_torch_image_formats_j2k.py::test_committed_fixtures_hashes
holds them to the recorded hashes.

It records, under each WebP fixture's `pil_webp_files`, the file PIL
writes (Image.save's defaults: lossy, quality 80, method 4) of the
fixture's decoded samples cropped to each size named there from the top
left (ground: 128x96, 37x23 and the whole 1024x512; sky: 1280x720 and the
whole 2048x1024): its length, SHA-256, RGB PSNR of PIL's decode against
the crop, and the VP8 header's fields (utils/webp_write.py's
header_fields: segments, quantizers, filter levels, filter type,
sharpness, partitions and the rest).  chip_smoke.py phase 36 (b) holds
the port's files of the ground's crops to them on the card's machine;
tests/test_torch_image_write_webp.py holds the records to PIL.

It writes the committed fixtures of the formats utils/image_read_more.py
reads (more_read_files: XBM, MSP v1 and v2, SPIDER, BLP1 palette and
JPEG, BLP2 palette and DXT1 / DXT3 / DXT5, SUN raster, XPM, each of the
ground's first 128x96 samples; PIL's files where PIL writes the kind,
scripts/more_read_formats.py's writers elsewhere), each recorded with
`read_by`, the SHA-256 of its bytes and of PIL's samples (colours for
bilevel and palette images, as the port reads them), PIL's mode and the
shape; tests/test_torch_image_formats_pil_more.py and chip_smoke.py's
side process hold the port's decodes to them.

It writes the committed fixtures of the formats utils/image_read_pil.py
reads (pil_only_files: DCX, PIXAR, FTEX raw and DXT1, GBR v1 and v2,
XV thumbnail, McIDAS, IMT, FITS, IPTC and FLC, each of the ground's first
128x96 samples, by scripts/pil_only_formats.py's writers; PIL writes none
of these), recorded as more_read_files's are.  It also records, without
committing them, chip_smoke.py phase 38's maps (pil_only_formats.
phase38_files: phase 32's sinusoid sky at 768x512 as PhotoCD, the
ground's decoded samples as FTEX DXT1), each under its name with
`rebuilt_by` and the SHA-256 of its bytes and of PIL's samples.

It writes the AVIF fixtures of scripts/avif_maps.py (chip_smoke.py phase
39's sky and ground and six 128x96 crops for phase 37; phase 40's grid
sky and 4:2:2 ground and eight crops of one tool each), each of PIL's
AVIF writer on the WebP fixtures' decoded samples (phase 40's composed
into a grid, given another matrix or saved as a sequence by the
script), recorded with `read_by` (utils/avif.py), `pil_save` (the save
parameters) and what the script did (`grid`, `nclx_matrix`, `frames`),
the SHA-256 of its bytes and of PIL's samples and the shape; phase
41's grain sky and screen content ground and four crops likewise.  With
--avif it writes only these and merges their records into the existing
images.json:

    python3 scripts/make_image_fixtures.py --avif

Rerunning it rewrites both WebP files (the same bytes with PIL 12.1.0's
libwebp); the CPU tests tests/test_torch_image_formats_webp.py::
test_committed_fixtures_hashes and tests/test_torch_image_formats_bcn.py::
test_rebuilt_block_maps_hashes hold the files to the recorded hashes.
"""
import hashlib
import io
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "data" / "images"
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT))

import block_maps  # noqa: E402
import time_image_decode as tid  # noqa: E402
from chip_smoke import (PDF_GMTIME, icon_entries, pdf_clock,  # noqa: E402
                        png_idat_stream, psnr_rgb)
import avif_maps  # noqa: E402
import more_read_formats as mrf  # noqa: E402
import pil_only_formats as pof  # noqa: E402

GROUND_BC7 = "ground_1024x512_bc7.dds"
MORE_READ_CROP = (128, 96)
# the crops (width, height; from the top left) of each WebP fixture whose
# PIL WebP files images.json records
WEBP_WRITE_CROPS = {"ground_1024x512_q90.webp": ((128, 96), (37, 23),
                                                 (1024, 512)),
                    "sky_2048x1024_q90.webp": ((1280, 720), (2048, 1024))}


def ground(w, h, seed=7):
    """Tiles of varying tone with grout lines and fine noise, uint8 RGB."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    tone = rng.uniform(0.55, 1.0, (h // 64 + 1, w // 64 + 1))[yy // 64,
                                                              xx // 64]
    grout = ((xx % 64) < 3) | ((yy % 64) < 3)
    base = np.stack([170 * tone, 140 * tone, 100 * tone], -1)
    base[grout] = 60
    base += 18 * np.sin(xx / 5.0 + yy / 9.0)[..., None]
    return np.clip(base + rng.normal(0, 6, base.shape), 0, 255).astype(
        np.uint8)


def decoded_hash(path):
    a = np.ascontiguousarray(np.asarray(Image.open(path)))
    return hashlib.sha256(a.tobytes()).hexdigest(), list(a.shape)


# the formats whose files phase 33 holds to PIL's, and the crop
WRITTEN_EXTS = (".bmp", ".dds", ".im", ".jpg", ".pcx", ".ppm", ".qoi",
                ".sgi", ".tga", ".tif")
WRITTEN_CROP = (128, 96)


def written_hashes(px, tmp):
    """SHA-256 of PIL's file of px for each of WRITTEN_EXTS, written as
    tmp/fixture.<ext> (SGI and IM files hold their name)."""
    out = {}
    for ext in WRITTEN_EXTS:
        path = Path(tmp) / f"fixture{ext}"
        Image.fromarray(px).save(path)
        out[ext] = hashlib.sha256(path.read_bytes()).hexdigest()
    return out


# phase 36's formats: byte for byte, ICO / ICNS also by their PNG entries'
# IDAT streams (PDF files under chip_smoke.PDF_GMTIME's clock)
EXACT_EXTS = (".eps", ".ps", ".pdf", ".gif", ".jp2", ".j2k", ".jpc", ".jpf",
              ".jpx", ".j2c")
ICON_EXTS = (".ico", ".icns")
# the ground's crops (width, height; from the top left) whose PIL PNG files
# images.json records
PNG_CROPS = ((128, 96), (37, 23), (1024, 512))


def png_record(data):
    """A PNG file's length, SHA-256 and the SHA-256 of its decompressed IDAT
    stream (chip_smoke.png_idat_stream)."""
    return {"bytes": len(data), "sha256": hashlib.sha256(data).hexdigest(),
            "sha256_of_idat_stream": hashlib.sha256(
                png_idat_stream(data)).hexdigest()}


def icon_record(ext, data):
    """An ICO or ICNS file's length, SHA-256 and the SHA-256 of each PNG
    entry's decompressed IDAT stream, in the file's order."""
    return {"bytes": len(data), "sha256": hashlib.sha256(data).hexdigest(),
            "idat_streams": [hashlib.sha256(png_idat_stream(png)).hexdigest()
                             for png in icon_entries(data)[1]]}


def png_records(ground_px):
    """`pil_png_files`: PIL's PNG of each of PNG_CROPS of the ground's
    samples, and the zlib PIL deflates with."""
    from PIL import features

    out = {}
    for w, h in PNG_CROPS:
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(ground_px[:h, :w])).save(
            buf, "PNG")
        out[f"{w}x{h}"] = png_record(buf.getvalue())
        print(f"ground {w}x{h} as PNG: {out[f'{w}x{h}']['bytes']} bytes")
    return {"pil_png_files": out, "pil_zlib": features.version("zlib")}


def new_writer_records(px, tmp):
    """Phase 36's records of PIL's files of px (see the docstring)."""
    exact = {}
    for ext in EXACT_EXTS:
        path = Path(tmp) / f"fixture{ext}"
        with pdf_clock():
            Image.fromarray(px).save(path)
        exact[ext] = hashlib.sha256(path.read_bytes()).hexdigest()
    icons = {}
    for ext in ICON_EXTS:
        path = Path(tmp) / f"fixture{ext}"
        Image.fromarray(px).save(path)
        icons[ext] = icon_record(ext, path.read_bytes())
    return {"sha256_of_pil_files_exact": exact,
            "pdf_gmtime": list(PDF_GMTIME), "pil_icon_files": icons}


def webp_write_records(path):
    """`pil_webp_files` of one WebP fixture (see the docstring)."""
    from acceleratedvolrenderer_tpu_torch.utils.webp_write import \
        header_fields

    px = np.asarray(Image.open(path).convert("RGB"))
    out = {}
    for w, h in WEBP_WRITE_CROPS[Path(path).name]:
        crop = np.ascontiguousarray(px[:h, :w])
        buf = io.BytesIO()
        Image.fromarray(crop).save(buf, "WEBP")
        data = buf.getvalue()
        back = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        out[f"{w}x{h}"] = {"bytes": len(data),
                           "sha256": hashlib.sha256(data).hexdigest(),
                           "psnr_rgb": psnr_rgb(back, crop),
                           "header": header_fields(data)}
        print(f"{Path(path).name} {w}x{h} as WebP: {len(data)} bytes, "
              f"PSNR {out[f'{w}x{h}']['psnr_rgb']:.2f} dB")
    return out


def block_map_records(ground_webp):
    """images.json's records of the rebuilt block-compressed files."""
    ground_px = np.asarray(Image.open(ground_webp).convert("RGB"))
    files = dict(block_maps.block_files())
    files[GROUND_BC7] = block_maps.encode_dds("BC7", ground_px)
    out = {}
    for name, data in sorted(files.items()):
        digest, shape = decoded_hash(io.BytesIO(data))
        out[name] = {"rebuilt_by": "scripts/block_maps.py",
                     "sha256_of_bytes": hashlib.sha256(data).hexdigest(),
                     "sha256_of_pil_samples": digest, "shape": shape,
                     "bytes": len(data)}
        print(f"{name}: {len(data)} bytes, PIL samples {shape} sha256 "
              f"{digest}")
    return out


J2K_FILES = {
    "sky_2048x1024_97.jp2": ("sky", None, dict(
        irreversible=True, quality_layers=[80, 40], progression="RPCL",
        tile_size=(512, 512), codeblock_size=(32, 32),
        precinct_size=(128, 128))),
    "ground_1024x512_53.j2k": ("ground", None, dict(
        quality_layers=[20], progression="LRCP")),
    "sky_512x256_lossless.jp2": ("sky", (512, 256), {}),
}


def jpeg2000_records(sky_webp, ground_webp):
    """Write the JPEG 2000 fixtures; their images.json records."""
    src = {"sky": np.asarray(Image.open(sky_webp).convert("RGB")),
           "ground": np.asarray(Image.open(ground_webp).convert("RGB"))}
    out = {}
    for name, (which, crop, kw) in J2K_FILES.items():
        px = src[which] if crop is None else src[which][:crop[1], :crop[0]]
        Image.fromarray(px).save(OUT / name, **kw)
        data = (OUT / name).read_bytes()
        digest, shape = decoded_hash(OUT / name)
        out[name] = {"sha256_of_bytes": hashlib.sha256(data).hexdigest(),
                     "sha256_of_pil_samples": digest, "shape": shape,
                     "bytes": len(data)}
        print(f"{name}: {len(data)} bytes, PIL samples {shape} sha256 "
              f"{digest}")
    return out


def _pil_bytes(im, fmt, **kw):
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def more_read_files(ground_px):
    """{name: bytes} of the committed fixtures of the formats
    utils/image_read_more.py reads, made of the ground's first 128x96
    samples: PIL's XBM, MSP (v1), SPIDER (its luminance as floats) and
    BLP1 / BLP2 (256-colour palette) files, and the writers' MSP v2, BLP1
    JPEG (PIL's JPEG at quality 90 as its payload), BLP2 DXT1 / DXT3 /
    DXT5 (alpha a diagonal ramp), SUN (24-bit run-length coded, 8-bit
    with a colour map, 1-bit) and XPM (64 colours, 1 character each)."""
    w, h = MORE_READ_CROP
    px = np.ascontiguousarray(ground_px[:h, :w])
    im = Image.fromarray(px)
    bilevel = im.convert("1")
    bits = np.asarray(bilevel).astype(np.uint8)
    pal = im.quantize(256)
    few = im.quantize(64)
    idx64 = np.asarray(few)
    pal64 = np.array(few.getpalette()[:192], np.uint8).reshape(64, 3)
    yy, xx = np.mgrid[0:h, 0:w]
    rgba = np.concatenate([px, ((xx + yy) * 255 // (w + h - 2)).astype(
        np.uint8)[..., None]], -1)
    files = {
        "ground_128x96.xbm": _pil_bytes(bilevel, "XBM"),
        "ground_128x96_v1.msp": _pil_bytes(bilevel, "MSP"),
        "ground_128x96_v2.msp": mrf.msp_v2(bits),
        "ground_128x96.spider": _pil_bytes(im.convert("F"), "SPIDER"),
        "ground_128x96_blp1.blp": _pil_bytes(pal, "BLP", blp_version="BLP1"),
        "ground_128x96_blp2.blp": _pil_bytes(pal, "BLP"),
        "ground_128x96_blp1_jpeg.blp": mrf.blp1_jpeg(
            _pil_bytes(im, "JPEG", quality=90), w, h),
        "ground_128x96_rle.ras": mrf.sun_file(px, 24, rle=True),
        "ground_128x96_palette.ras": mrf.sun_file(idx64, 8, palette=pal64),
        "ground_128x96_1bit.ras": mrf.sun_file(bits, 1),
        "ground_128x96.xpm": mrf.xpm_file(idx64, pal64),
    }
    for kind in ("DXT1", "DXT3", "DXT5"):
        files[f"ground_128x96_{kind.lower()}.blp"] = mrf.blp2_blocks(
            mrf.dxt_blocks(rgba, kind), w, h, kind)
    return files


def more_read_records(ground_px):
    """Write the fixtures of more_read_files; their images.json records:
    `read_by`, the SHA-256 of the bytes and of PIL's samples as the port
    gives them (colours for mode 1 and P), PIL's mode and the samples'
    shape (a channel axis for gray)."""
    out = {}
    for name, data in more_read_files(ground_px).items():
        (OUT / name).write_bytes(data)
        im = Image.open(io.BytesIO(data))
        mode = im.mode
        if mode in ("1", "P"):
            im = im.convert("L" if mode == "1" else "RGB")
        a = np.ascontiguousarray(np.asarray(im))
        a = a[..., None] if a.ndim == 2 else a
        out[name] = {"read_by": "utils/image_read_more.py",
                     "sha256_of_bytes": hashlib.sha256(data).hexdigest(),
                     "sha256_of_pil_samples": hashlib.sha256(
                         a.tobytes()).hexdigest(),
                     "pil_mode": mode, "shape": list(a.shape),
                     "bytes": len(data)}
        print(f"{name}: {len(data)} bytes, PIL mode {mode}, samples "
              f"{list(a.shape)}")
    return out


def pil_only_files(ground_px):
    """{name: bytes} of the committed fixtures of the formats
    utils/image_read_pil.py reads, made of the ground's first 128x96
    samples (its gray: PIL's convert("L")), by pil_only_formats's writers:
    a DCX of two RGB PCX pages (the crop, then upside down), PIXAR, FTEX
    raw and DXT1, GBR v1 (gray) and v2 (RGBA, alpha a diagonal ramp), an
    XV thumbnail, McIDAS of 2-byte (gray times 257, 4-byte line prefixes)
    and 4-byte samples (gray times 2**23, less 2**30), IMT, FITS of
    BITPIX 16 (gray times 257), -32 (gray over 7) and GZIP_1 (ZBITPIX 32),
    IPTC raw (3 layers, the gray in band 1) and JPEG (PIL's gray JPEG at
    quality 90), and FLC frames over PIL's 256-colour quantization: a
    COLOR_256 and BRUN frame, and a COLOR_64, BLACK and SS2 one."""
    from acceleratedvolrenderer_tpu_torch.utils.image_write import \
        encode_pcx

    w, h = MORE_READ_CROP
    px = np.ascontiguousarray(ground_px[:h, :w])
    im = Image.fromarray(px)
    gray = np.asarray(im.convert("L"))
    pal = im.quantize(256)
    idx = np.asarray(pal)
    colours = np.array(pal.getpalette()[:768], np.uint8).reshape(-1, 3)
    yy, xx = np.mgrid[0:h, 0:w]
    rgba = np.concatenate([px, ((xx + yy) * 255 // (w + h - 2)).astype(
        np.uint8)[..., None]], -1)
    g = gray.astype(np.int64)
    blank = np.zeros_like(idx)
    return {
        "ground_128x96.dcx": pof.dcx_file([encode_pcx(px),
                                           encode_pcx(px[::-1])]),
        "ground_128x96.pxr": pof.pixar_file(px),
        "ground_128x96_rgb.ftu": pof.ftex_rgb(px),
        "ground_128x96_dxt1.ftc": pof.ftex_dxt1(px),
        "ground_128x96_v1.gbr": pof.gbr_file(gray, version=1),
        "ground_128x96_rgba.gbr": pof.gbr_file(rgba, version=2),
        "ground_128x96.xvthumb": pof.xvthumb_file(pof.rgb_to_332(px)),
        "ground_128x96_2byte.area": pof.mcidas_file(g * 257, 2, prefix=4),
        "ground_128x96_4byte.area": pof.mcidas_file(g * 2 ** 23 - 2 ** 30,
                                                    4),
        "ground_128x96.imt": pof.imt_file(gray),
        "ground_128x96_16.fits": pof.fits_file(g * 257, 16),
        "ground_128x96_float.fits": pof.fits_file(g / 7.0, -32),
        "ground_128x96_gzip.fits": pof.fits_gzip_file(g, 32),
        "ground_128x96_raw.iim": pof.iptc_file(gray.tobytes(), w, h,
                                               layers=3, band=1),
        "ground_128x96_jpeg.iim": pof.iptc_file(_pil_bytes(
            Image.fromarray(gray), "JPEG", quality=90), w, h,
            compression=5),
        "ground_128x96_brun.flc": pof.fli_file(w, h, [[
            pof.fli_color(colours), pof.fli_brun(idx)]]),
        "ground_128x96_ss2.flc": pof.fli_file(w, h, [[
            pof.fli_color(colours, shift=2, kind=11), pof.fli_black(),
            pof.fli_ss2(blank, idx)]]),
    }


def pil_samples(data):
    """PIL's samples of a file as the port gives them (colours for mode 1
    and P, a channel axis for one band, native byte order) and PIL's
    mode."""
    im = Image.open(io.BytesIO(data))
    mode = im.mode
    if mode in ("1", "P"):
        im = im.convert("L" if mode == "1" else "RGB")
    a = np.asarray(im)
    a = a[..., None] if a.ndim == 2 else a
    return np.ascontiguousarray(a.astype(a.dtype.newbyteorder("="))), mode


def pil_only_records(ground_px):
    """Write the fixtures of pil_only_files; their images.json records, as
    more_read_records's; and the records of phase 38's maps (not
    written), with `rebuilt_by`."""
    out = {}
    files = {name: (pof.READ_BY, data)
             for name, data in pil_only_files(ground_px).items()}
    files.update((name, (None, data)) for name, data in pof.phase38_files(
        tid.sky(768, 512, 255), ground_px).items())
    for name, (read_by, data) in files.items():
        a, mode = pil_samples(data)
        rec = {"sha256_of_bytes": hashlib.sha256(data).hexdigest(),
               "sha256_of_pil_samples": hashlib.sha256(
                   a.tobytes()).hexdigest(),
               "pil_mode": mode, "shape": list(a.shape), "bytes": len(data)}
        if read_by:
            (OUT / name).write_bytes(data)
            out[name] = dict(read_by=read_by, **rec)
        else:
            out[name] = dict(rebuilt_by="scripts/pil_only_formats.py", **rec)
        print(f"{name}: {len(data)} bytes, PIL mode {mode}, samples "
              f"{list(a.shape)}")
    return out


def avif_records(sky_webp, ground_webp):
    """Write the AVIF fixtures; their images.json records."""
    files = avif_maps.make_files(
        np.asarray(Image.open(sky_webp).convert("RGB")),
        np.asarray(Image.open(ground_webp).convert("RGB")))
    out = {}
    for name, data in files.items():
        (OUT / name).write_bytes(data)
        a = np.asarray(Image.open(io.BytesIO(data)))
        out[name] = {"read_by": avif_maps.READ_BY,
                     **avif_maps.recipe(name),
                     "sha256_of_bytes": hashlib.sha256(data).hexdigest(),
                     "sha256_of_pil_samples": hashlib.sha256(
                         np.ascontiguousarray(a).tobytes()).hexdigest(),
                     "shape": list(a.shape), "bytes": len(data)}
        print(f"{name}: {len(data)} bytes, PIL samples {list(a.shape)}")
    return out


def main():
    if sys.argv[1:] == ["--avif"]:
        path = OUT / "images.json"
        record = json.loads(path.read_text())
        record.update(avif_records(OUT / "sky_2048x1024_q90.webp",
                                   OUT / "ground_1024x512_q90.webp"))
        path.write_text(json.dumps(record, indent=1) + "\n")
        return
    OUT.mkdir(parents=True, exist_ok=True)
    files = {"sky_2048x1024_q90.webp": tid.sky(2048, 1024, 255),
             "ground_1024x512_q90.webp": ground(1024, 512)}
    record = {}
    for name, px in files.items():
        buf = io.BytesIO()
        Image.fromarray(px).save(buf, "WEBP", quality=90)
        (OUT / name).write_bytes(buf.getvalue())
        digest, shape = decoded_hash(OUT / name)
        record[name] = {"sha256_of_pil_samples": digest, "shape": shape,
                        "bytes": len(buf.getvalue())}
        print(f"{name}: {len(buf.getvalue())} bytes, PIL samples {shape} "
              f"sha256 {digest}")
        if name.startswith("ground"):
            w, h = WRITTEN_CROP
            crop = np.asarray(Image.open(OUT / name))[:h, :w]
            with tempfile.TemporaryDirectory() as tmp:
                record[name].update(
                    written_crop=list(WRITTEN_CROP),
                    sha256_of_pil_files=written_hashes(crop, tmp))
                record[name].update(new_writer_records(crop, tmp))
            ground_px = np.asarray(Image.open(OUT / name).convert("RGB"))
            record[name].update(png_records(ground_px))
        record[name]["pil_webp_files"] = webp_write_records(OUT / name)
    record.update(block_map_records(OUT / "ground_1024x512_q90.webp"))
    record.update(jpeg2000_records(OUT / "sky_2048x1024_q90.webp",
                                   OUT / "ground_1024x512_q90.webp"))
    ground_px = np.asarray(Image.open(
        OUT / "ground_1024x512_q90.webp").convert("RGB"))
    record.update(more_read_records(ground_px))
    record.update(pil_only_records(ground_px))
    record.update(avif_records(OUT / "sky_2048x1024_q90.webp",
                               OUT / "ground_1024x512_q90.webp"))
    (OUT / "images.json").write_text(json.dumps(record, indent=1) + "\n")


if __name__ == "__main__":
    main()
