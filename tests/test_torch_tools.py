"""The port's tools against the JAX package's on the same numpy-seeded
images and files: cli/imgtool.py (every subcommand), utils/flip.py,
cli/plytool.py, cli/cyhair2pbrt.py, the sigmoid-polynomial fit and
cli/rgb2spec_opt.py (utils/spectrum.py), the colorspace functions and
utils/image.py's PNG codec (held to PIL, which only the tests import).  And
the reference's gates of these tools (tests/test_cli.py l. 26-66, 158,
213-318; tests/test_flip.py; tests/test_spectrum.py:87, :108) on the port.

Tolerances: host numpy tools give equal outputs (EXR pixels and printed
numbers equal; FLIP to rel 1e-6); the fit at resolution 4 to rtol 1e-4
(float32 Levenberg-Marquardt steps in another order); the colorspace
functions to rtol 1e-6 / atol 1e-7.
"""
import io
import json
import os
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.cli import cyhair2pbrt as jcyhair
from acceleratedvolrenderer_tpu.cli import imgtool as jimgtool
from acceleratedvolrenderer_tpu.cli import plytool as jplytool
from acceleratedvolrenderer_tpu.utils import colorspace as jcs
from acceleratedvolrenderer_tpu.utils import flip as jflip
from acceleratedvolrenderer_tpu.utils import spectrum as jsp
from acceleratedvolrenderer_tpu_torch.cli import cyhair2pbrt, imgtool, plytool
from acceleratedvolrenderer_tpu_torch.cli import rgb2spec_opt
from acceleratedvolrenderer_tpu_torch.utils import colorspace as cs
from acceleratedvolrenderer_tpu_torch.utils import ply
from acceleratedvolrenderer_tpu_torch.utils import spectrum as sp
from acceleratedvolrenderer_tpu_torch.utils.flip import flip_ldr, flip_mean
from acceleratedvolrenderer_tpu_torch.utils.image import (decode_png,
                                                          encode_png,
                                                          read_exr,
                                                          read_image,
                                                          write_exr,
                                                          write_png)

import chip_smoke

torch.set_num_threads(2)


def _exr(path, img, **kw):
    write_exr(str(path), img, **kw)
    return str(path)


@pytest.fixture
def imgs(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.random((16, 20, 3)).astype(np.float32)
    b = a + 0.1
    return _exr(tmp_path / "a.exr", a), _exr(tmp_path / "b.exr", b), a, b


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


# ---- parity with the JAX package's tools ----

def test_imgtool_diff_info_cat_match_jax(imgs, tmp_path, capsys):
    pa, pb, *_ = imgs
    for argv in (["diff", pa, pb], ["info", pa], ["cat", pa],
                 ["diff", pa, pb, "--metric", "FLIP", "--threshold", "0.1"],
                 ["error-report", pa, pb, pa]):
        got = _run(imgtool.main, argv, capsys)
        want = _run(jimgtool.main, argv, capsys)
        assert got == want, argv


@pytest.mark.parametrize("argv", [
    ["average", "{a}", "{b}", "-o", "{out}"],
    ["assemble", "{a}", "-o", "{out}"],
    ["whitebalance", "{a}", "{out}", "--primaries", "0.4476,0.4074"],
    ["bloom", "{a}", "{out}", "--level", "0.5", "--width", "2"],
    ["scalenormalmap", "{a}", "--scale", "0.5", "--outfile", "{out}"],
    ["makesky", "--outfile", "{out}", "--resolution", "32"],
    ["makeequiarea", "{a}", "--outfile", "{out}", "--resolution", "16"],
    ["convert", "{a}", "{out}", "--scale", "2"],
    ["diff", "{a}", "{b}", "--outfile", "{out}"],
])
def test_imgtool_exr_outputs_match_jax(imgs, tmp_path, capsys, argv):
    pa, pb, *_ = imgs
    outs = []
    for i, main in enumerate((imgtool.main, jimgtool.main)):
        out = str(tmp_path / f"out{i}.exr")
        assert main([s.format(a=pa, b=pb, out=out) for s in argv]) == 0
        outs.append(read_exr(out)[0])
    capsys.readouterr()
    np.testing.assert_array_equal(*outs)


def test_imgtool_splitn_and_denoise_match_jax(tmp_path, capsys):
    rng = np.random.default_rng(1)
    img = rng.random((16, 16, 9)).astype(np.float32)
    names = ("R", "G", "B", "Albedo.R", "Albedo.G", "Albedo.B", "Ns.X",
             "Ns.Y", "Ns.Z")
    for i, main in enumerate((imgtool.main, jimgtool.main)):
        d = tmp_path / str(i)
        d.mkdir()
        src = _exr(d / "n.exr", img, channel_names=names)
        assert main(["denoise", src, "--outfile", str(d / "dn.exr"),
                     "--levels", "2"]) == 0
        assert main(["splitn", _exr(d / "s.exr", img[..., :3]), "-n",
                     "2"]) == 0
    capsys.readouterr()
    for name in ("dn.exr", "s-0-0.exr", "s-1-1.exr"):
        np.testing.assert_array_equal(read_exr(str(tmp_path / "0" / name))[0],
                                      read_exr(str(tmp_path / "1" / name))[0])


def test_imgtool_png_outputs_match_jax(imgs, tmp_path, capsys):
    """convert to PNG and falsecolor: the port's PNG decodes (by PIL) to
    the JAX package's PNG pixels."""
    from PIL import Image

    pa, *_ = imgs
    for cmd in ("convert", "falsecolor"):
        got, want = str(tmp_path / "p.png"), str(tmp_path / "j.png")
        assert imgtool.main([cmd, pa, got]) == 0
        assert jimgtool.main([cmd, pa, want]) == 0
        np.testing.assert_array_equal(np.asarray(Image.open(got)),
                                      np.asarray(Image.open(want)))
    # and the port's loader reads a PNG as the JAX one does
    capsys.readouterr()
    assert _run(imgtool.main, ["info", got], capsys) == _run(
        jimgtool.main, ["info", got], capsys)


def test_flip_matches_jax():
    rng = np.random.default_rng(2)
    a = rng.random((40, 56, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1.5).astype(np.float32)
    np.testing.assert_array_equal(flip_ldr(a, b), jflip.flip_ldr(a, b))
    want = jflip.flip_mean(a, b, ppd=40.0)
    assert abs(flip_mean(a, b, ppd=40.0) - want) <= 1e-6 * want


def test_plytool_matches_jax(tmp_path, capsys):
    rng = np.random.default_rng(3)
    v = rng.random((30, 3)).astype(np.float32)
    f = rng.integers(0, 30, (40, 3)).astype(np.int32)
    n = rng.normal(size=(30, 3)).astype(np.float32)
    uv = rng.random((30, 2)).astype(np.float32)
    src = tmp_path / "m.ply"
    ply.write_ply(str(src), v, f, normals=n, uvs=uv)
    disp = _exr(tmp_path / "d.exr", rng.random((8, 8, 3)).astype(np.float32))
    for argv in (["info", str(src)], ["cat", str(src)]):
        assert _run(plytool.main, argv, capsys) == _run(jplytool.main, argv,
                                                        capsys)
    for i, main in enumerate((plytool.main, jplytool.main)):
        out = str(tmp_path / f"o{i}.ply")
        assert main(["displace", str(src), "--image", disp, "--scale", "0.5",
                     "--outfile", out]) == 0
    capsys.readouterr()
    a, b = ply.read_ply(str(tmp_path / "o0.ply")), ply.read_ply(
        str(tmp_path / "o1.ply"))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert (tmp_path / "o0.ply").read_bytes() == (tmp_path / "o1.ply").read_bytes()


def test_cyhair2pbrt_matches_jax(tmp_path):
    path = tmp_path / "t.hair"
    chip_smoke.write_cyhair(path)
    outs = []
    for i, main in enumerate((cyhair2pbrt.main, jcyhair.main)):
        out = tmp_path / f"h{i}.pbrt"
        assert main([str(path), str(out), "--user-thickness", "0.02"]) == 0
        outs.append(out.read_text())
    assert outs[0] == outs[1] and outs[0].count('Shape "curve"') == 4


def test_sigmoid_fit_matches_jax():
    got = sp.make_rgb2spec_table(res=4, iters=60, device="cpu")
    want = jsp.make_rgb2spec_table(res=4, iters=60)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    lam = np.linspace(360, 830, 50).astype(np.float32)
    c = got.reshape(-1, 3)[:, None, :]
    np.testing.assert_allclose(
        sp.sigmoid_polynomial_eval(torch.as_tensor(c),
                                   torch.as_tensor(lam)[None]).numpy(),
        np.asarray(jsp.sigmoid_polynomial_eval(jnp.asarray(c),
                                               jnp.asarray(lam)[None])),
        rtol=1e-6, atol=1e-7)
    f, jf = (sp.rgb_albedo_spectrum_sigmoid([0.6, 0.3, 0.2]),
             jsp.rgb_albedo_spectrum_sigmoid([0.6, 0.3, 0.2]))
    np.testing.assert_allclose(f(torch.as_tensor(lam)).numpy(),
                               np.asarray(jf(jnp.asarray(lam))), rtol=1e-4)


def test_colorspace_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.uniform(-0.2, 1.3, (4096, 3)).astype(np.float32)
    for fn in ("rgb_to_xyz", "xyz_to_rgb", "linear_to_srgb",
               "srgb_to_linear"):
        np.testing.assert_allclose(
            getattr(cs, fn)(torch.as_tensor(np.abs(x))).numpy(),
            np.asarray(getattr(jcs, fn)(jnp.asarray(np.abs(x)))),
            rtol=1e-6, atol=1e-7, err_msg=fn)


def test_rgb2spec_opt_cli_needs_cuda_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rgb2spec_opt.main(["2", str(tmp_path / "t.npz"), "--iters", "2"])


# ---- the PNG codec, held to PIL ----

def _filtered_png(pixels, ftypes):
    """A PNG whose row y is written with filter type ftypes[y % 5]."""
    h, w, c = pixels.shape
    raw = pixels.reshape(h, w * c).astype(np.int64)
    rows = []
    prev = np.zeros(w * c, np.int64)
    for y in range(h):
        ft = ftypes[y % len(ftypes)]
        cur = raw[y]
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if ft == 0:
            out = cur
        elif ft == 1:
            out = cur - left
        elif ft == 2:
            out = cur - prev
        elif ft == 3:
            out = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
            out = cur - pred
        rows.append(bytes([ft]) + (out % 256).astype(np.uint8).tobytes())
        prev = cur
    png = encode_png(pixels)
    start = png.index(b"IDAT") - 4
    end = png.index(b"IEND") - 4
    body = zlib.compress(b"".join(rows))
    import struct
    chunk = (struct.pack(">I", len(body)) + b"IDAT" + body
             + struct.pack(">I", zlib.crc32(b"IDAT" + body) & 0xFFFFFFFF))
    return png[:start] + chunk + png[end:]


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_codec_matches_pil(channels, tmp_path):
    from PIL import Image

    rng = np.random.default_rng(channels)
    px = rng.integers(0, 256, (11, 13, channels)).astype(np.uint8)
    squeeze = px[..., 0] if channels == 1 else px
    # ours -> PIL
    got = np.asarray(Image.open(io.BytesIO(encode_png(px))))
    np.testing.assert_array_equal(got.reshape(px.shape), px)
    # every filter type -> both decoders
    data = _filtered_png(px, [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(decode_png(data), px)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(data))).reshape(px.shape), px)
    # PIL's own (adaptive filters) -> ours
    buf = io.BytesIO()
    Image.fromarray(squeeze).save(buf, format="PNG", optimize=True)
    np.testing.assert_array_equal(decode_png(buf.getvalue()), px)


def _raw_png(px, depth, ctype, interlace):
    """A PNG of samples px (H, W, C) at depth 8 or 16, every row
    unfiltered, plain or Adam7-interlaced (the passes cut by slicing)."""
    import struct

    h, w, c = px.shape
    passes = ([(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
               (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)] if interlace
              else [(0, 0, 1, 1)])
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = px[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        flat = sub.reshape(sub.shape[0], -1).astype(">u2" if depth == 16
                                                   else np.uint8)
        for row in flat:
            raw += b"\0" + row.tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                         interlace))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["palette8", "palette4_trns", "gray1",
                                  "gray16", "rgb8_adam7", "rgba16_adam7"])
def test_png_decode_other_kinds_matches_pil(kind, tmp_path):
    """Palette (with and without transparency), sub-byte gray, 16-bit and
    Adam7-interlaced PNGs: decode_png against PIL's decoding of the same
    bytes; read_image's [0, 1] scale for 16 bits."""
    from PIL import Image

    rng = np.random.default_rng(len(kind))
    h, w = 13, 11
    buf = io.BytesIO()
    if kind.startswith("palette"):
        n = 16 if kind == "palette4_trns" else 256
        im = Image.fromarray(rng.integers(0, n, (h, w)).astype(np.uint8), "P")
        im.putpalette(rng.integers(0, 256, 3 * n).astype(np.uint8).tobytes())
        if kind == "palette4_trns":
            im.save(buf, format="PNG", bits=4,
                    transparency=bytes(rng.integers(0, 256, 9).tolist()))
        else:
            im.save(buf, format="PNG")
        data = buf.getvalue()
        mode = "RGBA" if kind == "palette4_trns" else "RGB"
        want = np.asarray(Image.open(io.BytesIO(data)).convert(mode))
    elif kind == "gray1":
        Image.fromarray(rng.random((h, w)) < 0.5).save(buf, format="PNG")
        data = buf.getvalue()
        want = np.asarray(Image.open(io.BytesIO(data)).convert("L"))[..., None]
    elif kind == "gray16":
        px = rng.integers(0, 65536, (h, w)).astype(np.uint16)
        Image.fromarray(px).save(buf, format="PNG")
        data = buf.getvalue()
        want = np.asarray(Image.open(io.BytesIO(data))).astype(
            np.uint16)[..., None]
        np.testing.assert_array_equal(want[..., 0], px)
    else:
        c, depth = (3, 8) if kind == "rgb8_adam7" else (4, 16)
        want = rng.integers(0, 256 ** (depth // 8), (h, w, c)).astype(
            np.uint8 if depth == 8 else np.uint16)
        data = _raw_png(want, depth, {3: 2, 4: 6}[c], 1)
        # PIL reads 16-bit RGBA at 8 bits: the high byte
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(data))),
            want if depth == 8 else (want >> 8).astype(np.uint8))
    # the IHDR's bit depth: the case is the one named
    depths = {"palette8": 8, "palette4_trns": 4, "gray1": 1, "gray16": 16,
              "rgb8_adam7": 8, "rgba16_adam7": 16}
    assert data[24] == depths[kind]
    got = decode_png(data)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    path = tmp_path / "x.png"
    path.write_bytes(data)
    rgb = read_image(str(path))[0]
    scale = 65535.0 if want.dtype == np.uint16 else 255.0
    x = want[..., :3].astype(np.float32) / scale
    if want.shape[2] == 1:
        x = np.repeat(x, 3, axis=2)
    np.testing.assert_allclose(rgb, np.where(
        x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4), rtol=1e-6)


def test_write_png_and_read_image_match_jax(tmp_path):
    from acceleratedvolrenderer_tpu.utils import image as jimage

    rng = np.random.default_rng(5)
    img = rng.uniform(-0.1, 1.2, (9, 7, 3)).astype(np.float32)
    for tonemap in (True, False):
        a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
        write_png(a, img, tonemap=tonemap)
        jimage.write_png(b, img, tonemap=tonemap)
        np.testing.assert_array_equal(read_image(a)[0], read_image(b)[0])
        np.testing.assert_array_equal(read_image(a)[0],
                                      jimage.read_image(b)[0])
    with pytest.raises(ValueError, match="JPEG: truncated"):
        (tmp_path / "x.jpg").write_bytes(b"\xff\xd8\xff")
        read_image(str(tmp_path / "x.jpg"))


# ---- the reference's gates on the port ----

def test_imgtool_diff(imgs, capsys):
    pa, pb, a, b = imgs
    assert imgtool.main(["diff", pa, pb]) == 0
    out = json.loads(capsys.readouterr().out)
    np.testing.assert_allclose(out["MSE"], 0.01, rtol=1e-4)
    np.testing.assert_allclose(out["L1"], 0.1, rtol=1e-4)


def test_imgtool_diff_threshold(imgs, capsys):
    pa, pb, *_ = imgs
    assert imgtool.main(["diff", pa, pb, "--metric", "MSE", "--threshold",
                         "0.02"]) == 0
    capsys.readouterr()
    assert imgtool.main(["diff", pa, pb, "--metric", "MSE", "--threshold",
                         "0.001"]) == 1


def test_imgtool_info(imgs, capsys):
    pa, *_ = imgs
    assert imgtool.main(["info", pa]) == 0
    assert json.loads(capsys.readouterr().out)["resolution"] == [20, 16]


def test_imgtool_convert_png(imgs, tmp_path):
    pa, *_ = imgs
    out = str(tmp_path / "o.png")
    assert imgtool.main(["convert", pa, out]) == 0
    assert os.path.exists(out)


def test_imgtool_falsecolor(imgs, tmp_path):
    pa, *_ = imgs
    out = str(tmp_path / "f.png")
    assert imgtool.main(["falsecolor", pa, out]) == 0
    assert os.path.exists(out)


def test_imgtool_average(imgs, tmp_path):
    pa, pb, a, b = imgs
    out = str(tmp_path / "avg.exr")
    assert imgtool.main(["average", pa, pb, "-o", out]) == 0
    np.testing.assert_allclose(read_exr(out)[0], (a + b) / 2, atol=1e-6)


def test_plytool_roundtrip(tmp_path, capsys):
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    path = tmp_path / "quad.ply"
    ply.write_ply(str(path), v, f)
    m = ply.read_ply(str(path))
    assert np.allclose(m["vertices"], v)
    assert np.array_equal(m["faces"], f)
    assert plytool.main(["info", str(path)]) == 0
    assert "4 vertices, 2 triangles" in capsys.readouterr().out


def test_imgtool_new_subcommands(tmp_path):
    img = np.zeros((16, 16, 3), np.float32)
    img[8, 8] = 5.0
    src = _exr(tmp_path / "a.exr", img)
    out = str(tmp_path / "b.exr")
    assert imgtool.main(["bloom", src, out, "--level", "1"]) == 0
    assert read_exr(out)[0][7, 7].sum() > 0      # energy spread
    assert imgtool.main(["whitebalance", src, out,
                         "--primaries", "0.4476,0.4074"]) == 0
    assert np.isfinite(read_exr(out)[0]).all()
    assert imgtool.main(["splitn", src, "-n", "2"]) == 0
    assert read_exr(str(tmp_path / "a-0-0.exr"))[0].shape[:2] == (8, 8)


def test_makesky_and_mapping(tmp_path):
    from acceleratedvolrenderer_tpu_torch.utils.sky import (
        equal_area_sphere_to_square, equal_area_square_to_sphere)

    rng = np.random.default_rng(0)
    uv = rng.random((256, 2))
    d = equal_area_square_to_sphere(uv)
    assert np.allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-6)
    assert np.allclose(uv, equal_area_sphere_to_square(d), atol=1e-5)
    out = str(tmp_path / "sky.exr")
    assert imgtool.main(["makesky", "--outfile", out, "--resolution", "64",
                         "--elevation", "30"]) == 0
    img = read_exr(out)[0]
    assert np.isfinite(img).all() and img.max() > 0
    d = equal_area_square_to_sphere(
        np.stack(np.meshgrid(*[(np.arange(64) + .5) / 64] * 2), -1))
    assert img[d[..., 2] < -0.1].max() < 1e-6


def test_denoise_gbuffer_guided(tmp_path):
    """The a-trous filter guided by Albedo / Ns channels cuts the noise
    tenfold and keeps the albedo edge."""
    rng = np.random.default_rng(0)
    H = W = 64
    clean = np.zeros((H, W, 3), np.float32)
    clean[:, : W // 2] = [0.8, 0.4, 0.2]
    clean[:, W // 2:] = [0.1, 0.3, 0.7]
    noisy = np.clip(clean + rng.normal(0, 0.25, (H, W, 3)), 0,
                    None).astype(np.float32)
    normal = np.zeros((H, W, 3), np.float32)
    normal[..., 2] = 1.0
    src = _exr(tmp_path / "noisy.exr",
               np.concatenate([noisy, clean, normal], -1),
               channel_names=("R", "G", "B", "Albedo.R", "Albedo.G",
                              "Albedo.B", "Ns.X", "Ns.Y", "Ns.Z"))
    out = str(tmp_path / "dn.exr")
    assert imgtool.main(["denoise", src, "--outfile", out]) == 0
    dn = read_exr(out)[0]
    mse_before = ((noisy - clean) ** 2).mean()
    assert ((dn[:, :, :3] - clean) ** 2).mean() < mse_before / 10


def test_scalenormalmap(tmp_path):
    rng = np.random.default_rng(1)
    nm = np.concatenate([rng.random((8, 8, 2)).astype(np.float32) * 0.4
                         + 0.3, np.full((8, 8, 1), 0.9, np.float32)], -1)
    src = _exr(tmp_path / "nm.exr", nm)
    out = str(tmp_path / "nm2.exr")
    assert imgtool.main(["scalenormalmap", src, "--scale", "0.5",
                         "--outfile", out]) == 0
    dec = 2 * read_exr(out)[0] - 1
    inp = 2 * nm - 1
    assert np.allclose(dec[..., :2], inp[..., :2] * 0.5, atol=1e-3)
    assert np.allclose((dec ** 2).sum(-1), 1.0, atol=1e-3)


def _flip_img(seed=0, h=48, w=64):
    return np.random.default_rng(seed).random((h, w, 3)).astype(
        np.float32) * 0.8


def test_flip_identical_images_zero():
    a = _flip_img()
    e = flip_ldr(a, a)
    assert e.shape == a.shape[:2] and float(e.max()) < 1e-6


def test_flip_range_and_monotonicity():
    a = _flip_img()
    e_small = flip_mean(a, np.clip(a + 0.02, 0, 1))
    e_big = flip_mean(a, np.clip(a + 0.3, 0, 1))
    assert 0.0 < e_small < e_big <= 1.0


def test_flip_localized_error_localized_map():
    a = np.full((64, 64, 3), 0.5, np.float32)
    b = a.copy()
    b[28:36, 28:36] = 0.9
    e = flip_ldr(a, b)
    assert e[32, 32] > 0.2 and e[4, 4] < 0.02


def test_flip_black_white_extreme():
    a = np.zeros((32, 32, 3), np.float32)
    assert flip_mean(a, np.ones((32, 32, 3), np.float32)) > 0.8


def test_sigmoid_polynomial_roundtrip():
    """Fitted spectra integrate back to the target RGB under D65 and stay
    in [0, 1]."""
    rng = np.random.default_rng(42)
    rgb = rng.random((128, 3)).astype(np.float32)
    c = sp.fit_sigmoid_polynomial(rgb, device="cpu")
    _, basis = sp._sigmoid_fit_basis()
    lam_nm = torch.as_tensor(np.linspace(sp.LAMBDA_MIN, sp.LAMBDA_MAX, 95),
                             dtype=torch.float32)
    s = sp.sigmoid_polynomial_eval(c[:, None, :], lam_nm[None, :])
    assert np.abs((s @ basis).numpy() - rgb).max() < 1e-3
    assert float(s.min()) >= 0.0 and float(s.max()) <= 1.0


def test_rgb2spec_table_cli(tmp_path):
    """rgb2spec_opt writes a coefficient lattice whose entries reproduce
    their lattice RGB."""
    out = tmp_path / "t.npz"
    assert rgb2spec_opt.main(["4", str(out), "--iters", "40", "--cpu"]) == 0
    coeffs = np.load(out)["coeffs"]
    assert coeffs.shape == (3, 4, 4, 4, 3)
    zs = (np.arange(4) + 0.5) / 4
    target = np.array([zs[3], zs[2] * zs[3], zs[1] * zs[3]], np.float32)
    _, basis = sp._sigmoid_fit_basis()
    s = sp.sigmoid_polynomial_eval(
        torch.as_tensor(coeffs[0, 3, 1, 2]),
        torch.as_tensor(np.linspace(sp.LAMBDA_MIN, sp.LAMBDA_MAX, 95),
                        dtype=torch.float32))
    assert np.abs((s @ basis).numpy() - target).max() < 2e-3
