"""Image tool CLI, pbrt's `imgtool` (port of
acceleratedvolrenderer_tpu/cli/imgtool.py; src/pbrt/cmd/imgtool.cpp).

Subcommands: diff (MSE, MRSE, L1 and FLIP), convert, falsecolor, average,
assemble, info, cat, whitebalance, bloom, splitn, error-report, makesky,
makeequiarea, scalenormalmap, denoise.  Host work on numpy arrays, as in
the reference; images are read and written by utils/image.py (EXR, PFM,
QOI, and through write_png the 8-bit formats the output's extension
names, as the reference's PIL does; no PIL).

    python -m acceleratedvolrenderer_tpu_torch.cli.imgtool diff a.exr b.exr
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _load(path):
    """(rgb (H, W, 3), attrs) of an EXR, PFM or QOI file by its extension
    (a .qoi linearized, as the reference's read_qoi does), else of any file
    utils/image.py's read_image decodes (PNG, JPEG, BMP, DIB, TIFF, WebP,
    GIF, netpbm, PCX, SGI, IM, DDS, PSD, ICO, CUR, ICNS, JPEG 2000, BLP,
    MSP, SPIDER, SUN, XBM, XPM, TGA): its colours scaled to [0, 1] (a float
    TIFF's or SPIDER image's values as stored) and not linearized,
    as the reference's loader does.  write_png's .qoi (PIL's QOI) is read back
    linearized by the first rule and its .pfm (P6 bytes) refused by
    read_pfm, as in the reference."""
    from ..utils.image import _decode_image, png_unit, read_exr, read_pfm, \
        read_qoi

    if path.endswith(".exr"):
        img, _, attrs = read_exr(path)
        return img[:, :, :3], attrs
    if path.endswith(".pfm"):
        img = read_pfm(path)
        if img.ndim == 2:
            img = np.repeat(img[:, :, None], 3, axis=2)
        return img[:, :, :3], {}
    if path.endswith(".qoi"):
        return read_qoi(path), {}
    with open(path, "rb") as f:
        px = _decode_image(path, f.read())
    arr = px if px.dtype == np.float32 else png_unit(px)
    if arr.shape[2] < 3:                # gray (+ alpha)
        arr = np.repeat(arr[:, :, :1], 3, axis=2)
    return arr[:, :, :3], {}


def cmd_diff(args):
    from ..utils.flip import flip_mean
    from ..utils.image import mae, mrse, mse

    a, _ = _load(args.image)
    b, _ = _load(args.reference)
    if a.shape != b.shape:
        print(f"error: size mismatch {a.shape} vs {b.shape}", file=sys.stderr)
        return 1
    out = {
        "MSE": mse(a, b),
        "MRSE": mrse(a, b),
        "L1": mae(a, b),
        "FLIP": flip_mean(b, a),
    }
    print(json.dumps(out))
    if args.outfile:
        from ..utils.image import write_exr

        write_exr(args.outfile, np.abs(a - b))
    if args.metric and args.threshold is not None:
        return 0 if out[args.metric] <= args.threshold else 1
    return 0


def cmd_convert(args):
    img, attrs = _load(args.input)
    scale = args.scale
    img = img * scale
    if args.tonemap or args.output.endswith(".png"):
        from ..utils.image import write_png

        write_png(args.output, img)
    elif args.output.endswith(".pfm"):
        from ..utils.image import write_pfm

        write_pfm(args.output, img)
    elif args.output.endswith(".qoi"):
        from ..utils.image import write_qoi

        write_qoi(args.output, img)
    else:
        from ..utils.image import write_exr

        write_exr(args.output, img)
    print(f"wrote {args.output}")
    return 0


def cmd_falsecolor(args):
    img, _ = _load(args.input)
    lum = img @ np.array([0.2126, 0.7152, 0.0722])
    lo = lum.min() if args.minvalue is None else args.minvalue
    hi = lum.max() if args.maxvalue is None else args.maxvalue
    t = np.clip((lum - lo) / max(hi - lo, 1e-12), 0, 1)
    # viridis-ish 3-stop ramp
    stops = np.array([[0.267, 0.005, 0.329], [0.128, 0.567, 0.551], [0.993, 0.906, 0.144]])
    idx = t * 2.0
    i0 = np.clip(idx.astype(int), 0, 1)
    f = idx - i0
    rgb = stops[i0] * (1 - f[..., None]) + stops[i0 + 1] * f[..., None]
    from ..utils.image import write_png

    write_png(args.output, rgb, tonemap=False)
    print(f"wrote {args.output} (range {lo:.4g}..{hi:.4g})")
    return 0


def cmd_average(args):
    imgs = [(_load(p))[0] for p in args.inputs]
    avg = np.mean(np.stack(imgs), axis=0)
    from ..utils.image import write_exr

    write_exr(args.output, avg)
    print(f"wrote {args.output}")
    return 0


def cmd_assemble(args):
    """Assemble cropped renders into one image (imgtool assemble)."""
    from ..utils.image import read_exr, write_exr

    tiles = []
    for p in args.inputs:
        img, _, attrs = read_exr(p)
        tiles.append((img, attrs))
    H = max(t[1].get("fullHeight", t[0].shape[0]) for t in tiles)
    W = max(t[1].get("fullWidth", t[0].shape[1]) for t in tiles)
    out = np.zeros((H, W, tiles[0][0].shape[2]), np.float32)
    for img, attrs in tiles:
        y0 = attrs.get("cropY", 0)
        x0 = attrs.get("cropX", 0)
        out[y0: y0 + img.shape[0], x0: x0 + img.shape[1]] = img
    write_exr(args.output, out)
    print(f"wrote {args.output}")
    return 0


def cmd_info(args):
    img, attrs = _load(args.input)
    print(json.dumps({
        "resolution": [img.shape[1], img.shape[0]],
        "channels": img.shape[2],
        "min": float(img.min()), "max": float(img.max()),
        "mean": float(img.mean()),
        **{k: (v if isinstance(v, (int, float, str)) else str(v))
           for k, v in attrs.items() if k in
           ("renderTimeSeconds", "samplesPerPixel", "MSE")},
    }))
    return 0


def cmd_cat(args):
    img, _ = _load(args.input)
    np.set_printoptions(precision=4, suppress=True)
    print(img if args.all else img[:: max(img.shape[0] // 8, 1), :: max(img.shape[1] // 8, 1)])
    return 0


def cmd_whitebalance(args):
    """Chromatic adaptation between illuminants (imgtool whitebalance)."""
    from ..models.film import white_balance_matrix
    from ..utils import colorspace as cs

    import torch

    img, attrs = _load(args.input)
    src = tuple(float(x) for x in args.primaries.split(","))
    m = white_balance_matrix(src, (0.3127, 0.3290))
    xyz = cs.rgb_to_xyz(torch.as_tensor(img, dtype=torch.float32)).numpy()
    out = cs.xyz_to_rgb(torch.as_tensor(
        (xyz @ m.T).astype(np.float32))).numpy()
    from ..utils.image import write_exr

    write_exr(args.output, np.clip(out, 0, None))
    return 0


def cmd_bloom(args):
    """Add bloom around bright pixels (imgtool bloom): pixels above
    --level spread through --iterations box blurs of --width, scaled."""
    img, _ = _load(args.input)
    bright = np.where(img.max(-1, keepdims=True) > args.level, img, 0.0)
    w = max(int(args.width), 1)
    blur = bright.copy()
    for _ in range(args.iterations):
        acc = np.zeros_like(blur)
        for ax in (0, 1):
            for off in range(-w, w + 1):
                acc += np.roll(blur, off, axis=ax)
        blur = acc / (2 * (2 * w + 1))
    out = img + args.scale * blur
    from ..utils.image import write_exr

    write_exr(args.output, out)
    return 0


def cmd_splitn(args):
    """Split an image into n x n crops (imgtool splitn)."""
    img, _ = _load(args.input)
    n = args.n
    h, w = img.shape[:2]
    base = args.input.rsplit(".", 1)[0]
    from ..utils.image import write_exr

    for j in range(n):
        for i in range(n):
            crop = img[j * h // n:(j + 1) * h // n,
                       i * w // n:(i + 1) * w // n]
            write_exr(f"{base}-{j}-{i}.exr", crop)
    print(f"wrote {n * n} crops")
    return 0


def cmd_error_report(args):
    """MSE/MRSE vs a reference for several test images, sorted
    (imgtool error-report)."""
    from ..utils.image import mrse, mse

    ref, _ = _load(args.reference)
    rows = []
    for path in args.images:
        a, _ = _load(path)
        if a.shape != ref.shape:
            print(f"{path}: size mismatch", file=sys.stderr)
            continue
        rows.append((mse(a, ref), mrse(a, ref), path))
    rows.sort()
    for m, mr, path in rows:
        print(f"{path}: MSE {m:.6g} MRSE {mr:.6g}")
    return 0


def cmd_scalenormalmap(args):
    """Scale tangent-space normal map strength (imgtool scalenormalmap,
    cmd/imgtool.cpp:693): decode [0,1] -> [-1,1], scale xy, rebuild z as
    sqrt(1 - x^2 - y^2), re-encode."""
    from ..utils.image import write_exr

    img, _ = _load(args.input)
    n = 2.0 * img - 1.0
    n[..., 0] *= args.scale
    n[..., 1] *= args.scale
    n[..., 2] = np.sqrt(np.maximum(1.0 - n[..., 0] ** 2 - n[..., 1] ** 2,
                                   0.0))
    write_exr(args.outfile, (n + 1.0) * 0.5)
    print(f"wrote {args.outfile}")
    return 0


def cmd_denoise(args):
    """Denoise a render using its G-buffer aux channels (imgtool
    denoise-optix, cmd/imgtool.cpp:2243).  The OptiX neural denoiser is
    CUDA-only; the equivalent here is an edge-aware à-trous wavelet filter
    (Dammertz et al. 2010, the SVGF spatial pass) guided by the same
    Albedo.{R,G,B} and Ns.{X,Y,Z} channels the reference feeds OptiX."""
    from ..utils.image import read_exr, write_exr

    img, names, attrs = read_exr(args.input)

    def channels(prefixes):
        idx = []
        for want in prefixes:
            for i, nm in enumerate(names):
                if nm == want:
                    idx.append(i)
                    break
        return img[:, :, idx] if len(idx) == 3 else None

    rgb = channels(["R", "G", "B"])
    if rgb is None:
        print(f"error: {args.input} has no R,G,B channels", file=sys.stderr)
        return 1
    albedo = channels(["Albedo.R", "Albedo.G", "Albedo.B"])
    normal = channels(["Ns.X", "Ns.Y", "Ns.Z"])
    if normal is None:
        normal = channels(["Nsx", "Nsy", "Nsz"])

    # demodulate albedo so texture detail survives the blur
    if albedo is not None:
        demod = rgb / np.maximum(albedo, 1e-3)
    else:
        demod = rgb

    h, w = rgb.shape[:2]
    kern = np.array([1, 4, 6, 4, 1], np.float64) / 16.0  # B3 spline
    out = demod.astype(np.float64)
    lum = out.mean(-1)
    sigma_c2 = max(1e-6, float(np.var(lum))) * args.sigma_color ** 2

    for level in range(args.levels):
        step = 1 << level
        acc = np.zeros_like(out)
        wacc = np.zeros((h, w), np.float64)
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                kw = kern[dy + 2] * kern[dx + 2]
                sy, sx = dy * step, dx * step
                sh = np.roll(np.roll(out, sy, 0), sx, 1)
                wgt = np.full((h, w), kw)
                dc = ((out - sh) ** 2).mean(-1)
                wgt *= np.exp(-dc / sigma_c2)
                if normal is not None:
                    nsh = np.roll(np.roll(normal, sy, 0), sx, 1)
                    ndot = np.clip((normal * nsh).sum(-1), 0.0, 1.0)
                    wgt *= ndot ** args.sigma_normal
                if albedo is not None:
                    ash = np.roll(np.roll(albedo, sy, 0), sx, 1)
                    da = ((albedo - ash) ** 2).mean(-1)
                    wgt *= np.exp(-da / 0.01)
                acc += sh * wgt[..., None]
                wacc += wgt
        out = acc / np.maximum(wacc, 1e-12)[..., None]

    if albedo is not None:
        out = out * np.maximum(albedo, 1e-3)
    write_exr(args.outfile, out.astype(np.float32))
    print(f"wrote {args.outfile}")
    return 0


def cmd_makesky(args):
    """Analytic daylight sky environment map (imgtool makesky; Preetham
    model standing in for the vendored Hosek-Wilkie dataset)."""
    from ..utils.image import write_exr
    from ..utils.sky import make_sky_image

    img = make_sky_image(resolution=args.resolution,
                         elevation_deg=args.elevation,
                         turbidity=args.turbidity)
    write_exr(args.outfile, img)
    print(f"wrote {args.outfile}")
    return 0


def cmd_makeequiarea(args):
    """Equirect -> equal-area octahedral env map (imgtool makeequiarea)."""
    from ..utils.image import write_exr
    from ..utils.sky import lat_long_to_equal_area

    img, _ = _load(args.input)
    out = lat_long_to_equal_area(img, args.resolution)
    write_exr(args.outfile, out)
    print(f"wrote {args.outfile}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="avrt-torch-imgtool")
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("diff", help="MSE/MRSE/L1 between two images")
    d.add_argument("image")
    d.add_argument("reference")
    d.add_argument("--outfile", default=None, help="write |a-b| EXR")
    d.add_argument("--metric", choices=["MSE", "MRSE", "L1", "FLIP"],
                   default=None)
    d.add_argument("--threshold", type=float, default=None)
    d.set_defaults(fn=cmd_diff)

    c = sub.add_parser("convert", help="EXR <-> PNG, scaling")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--scale", type=float, default=1.0)
    c.add_argument("--tonemap", action="store_true")
    c.set_defaults(fn=cmd_convert)

    f = sub.add_parser("falsecolor", help="luminance false-color PNG")
    f.add_argument("input")
    f.add_argument("output")
    f.add_argument("--minvalue", type=float, default=None)
    f.add_argument("--maxvalue", type=float, default=None)
    f.set_defaults(fn=cmd_falsecolor)

    a = sub.add_parser("average", help="average N images")
    a.add_argument("inputs", nargs="+")
    a.add_argument("--output", "-o", required=True)
    a.set_defaults(fn=cmd_average)

    asm = sub.add_parser("assemble", help="assemble crops into a full frame")
    asm.add_argument("inputs", nargs="+")
    asm.add_argument("--output", "-o", required=True)
    asm.set_defaults(fn=cmd_assemble)

    i = sub.add_parser("info", help="print image metadata")
    i.add_argument("input")
    i.set_defaults(fn=cmd_info)

    cat = sub.add_parser("cat", help="print pixel values")

    wb = sub.add_parser("whitebalance", help="adapt illuminant to D65")
    wb.add_argument("input")
    wb.add_argument("output")
    wb.add_argument("--primaries", default="0.3127,0.3290",
                    help="source white xy")

    bl = sub.add_parser("bloom", help="bloom bright pixels")
    bl.add_argument("input")
    bl.add_argument("output")
    bl.add_argument("--level", type=float, default=1.0)
    bl.add_argument("--width", type=int, default=8)
    bl.add_argument("--iterations", type=int, default=3)
    bl.add_argument("--scale", type=float, default=0.3)

    sn = sub.add_parser("splitn", help="split into n x n crops")
    sn.add_argument("input")
    sn.add_argument("-n", type=int, default=2, dest="n")

    er = sub.add_parser("error-report", help="rank images by error vs ref")
    er.add_argument("reference")
    er.add_argument("images", nargs="+")

    mk = sub.add_parser("makesky", help="analytic daylight sky EXR")
    mk.add_argument("--outfile", default="sky.exr")
    mk.add_argument("--elevation", type=float, default=10.0)
    mk.add_argument("--turbidity", type=float, default=3.0)
    mk.add_argument("--resolution", type=int, default=512)
    mk.set_defaults(fn=cmd_makesky)

    me = sub.add_parser("makeequiarea", help="equirect -> equal-area octahedral")
    me.add_argument("input")
    me.add_argument("--outfile", default="equiarea.exr")
    me.add_argument("--resolution", type=int, default=None)
    me.set_defaults(fn=cmd_makeequiarea)

    snm = sub.add_parser("scalenormalmap", help="scale normal map strength")
    snm.add_argument("input")
    snm.add_argument("--scale", type=float, default=1.0)
    snm.add_argument("--outfile", required=True)
    snm.set_defaults(fn=cmd_scalenormalmap)

    dn = sub.add_parser("denoise",
                        help="G-buffer-guided a-trous denoise (denoise-optix)")
    dn.add_argument("input")
    dn.add_argument("--outfile", required=True)
    dn.add_argument("--levels", type=int, default=5)
    dn.add_argument("--sigma-color", type=float, default=4.0,
                    dest="sigma_color")
    dn.add_argument("--sigma-normal", type=float, default=128.0,
                    dest="sigma_normal")
    dn.set_defaults(fn=cmd_denoise)
    wb.set_defaults(fn=cmd_whitebalance)
    bl.set_defaults(fn=cmd_bloom)
    sn.set_defaults(fn=cmd_splitn)
    er.set_defaults(fn=cmd_error_report)
    cat.add_argument("input")
    cat.add_argument("--all", action="store_true")
    cat.set_defaults(fn=cmd_cat)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
