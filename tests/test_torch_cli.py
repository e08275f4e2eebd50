"""The port's command line (cli/pbrt.py, cli/graph_maker.py) against the JAX
package's, on the CPU: `pbrt.main(... --cpu)` of both packages on the same
scene file gives EXRs that read_exr reads back within the earlier slices'
frame tolerances (means to 1e-3, 99% of pixels to rtol 1e-3 / atol 1e-5;
the JAX surface frame outside jit, as tests/test_torch_fused_surfaces.py
renders it), also with --pixelbounds; --format and --toply give the same
text and PLY bytes; the other flags work (--checkpoint, --pixelstats,
--write-partial-images, --mse-reference-image / --mse-reference-out,
--debugstart, --disable-*-jitter, --integrator function / graph /
analyzer); the light path, BDPT, SPPM and MLT give the JAX CLI's frames
(MLT by the reference's mean gate); without CUDA and without --cpu the CLI
raises; graph_maker builds the same graph from a
.pbrt sphere scene as the JAX tool."""
import contextlib
import io
import json
import time
import warnings

import jax
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.cli import graph_maker as jgm
from acceleratedvolrenderer_tpu.cli import pbrt as jpbrt
from acceleratedvolrenderer_tpu.graph.model import Graph as JGraph
from acceleratedvolrenderer_tpu_torch.cli import graph_maker as tgm
from acceleratedvolrenderer_tpu_torch.cli import pbrt as tpbrt
from acceleratedvolrenderer_tpu_torch.graph.config import (
    GraphBuilderConfig, GraphConfig, LightingCalculatorConfig)
from acceleratedvolrenderer_tpu_torch.graph.model import Graph
from acceleratedvolrenderer_tpu_torch.utils.image import read_exr

from test_cli import SCENE_TXT
from test_torch_scene_parser import CLI_SCENE, grid_scene
from torch_graph_util import _sphere_density

torch.set_num_threads(2)

GRID_SCENE = grid_scene(16).replace("[64]", "[10]").replace("[48]", "[6]")
SCENES = {"env": CLI_SCENE, "mesh": SCENE_TXT, "grid": GRID_SCENE}


def _frames_close(img, ref):
    assert img.shape == ref.shape
    assert np.isfinite(img).all() and img.mean() > 0
    assert abs(img.mean() - ref.mean()) / ref.mean() < 1e-3
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-5).all(-1)
    assert close.mean() >= 0.99, close.mean()


def _run(main, argv, unjitted=False):
    """main(argv) with its stdout; returns (rc, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if unjitted:
            with jax.disable_jit():
                rc = main(argv)
        else:
            rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("name,bounds", [
    ("env", None), ("mesh", None), ("grid", None), ("env", "2,7,1,5"),
    ("grid", "2,7,1,5")])
def test_cli_frames_match_jax(tmp_path, name, bounds):
    scene = tmp_path / "s.pbrt"
    scene.write_text(SCENES[name])
    extra = ["--pixelbounds", bounds] if bounds else []
    outs = []
    for tag, main in (("j", jpbrt.main), ("t", tpbrt.main)):
        out = str(tmp_path / f"{tag}.exr")
        rc, text = _run(main, [str(scene), "-o", out, "--cpu", "--stats",
                               *extra], unjitted=tag == "j" and name == "mesh")
        assert rc == 0
        stats = json.loads(text.strip().splitlines()[-1])
        assert stats["outfile"] == out
        outs.append(read_exr(out))
    (ref, _, jattrs), (img, _, tattrs) = outs
    assert tattrs["samplesPerPixel"] == jattrs["samplesPerPixel"]
    if bounds:
        x0, x1, y0, y1 = (int(v) for v in bounds.split(","))
        inside = np.zeros(img.shape[:2], bool)
        inside[y0:y1, x0:x1] = True
        assert (img[~inside] == 0).all() and (ref[~inside] == 0).all()
        img, ref = img[inside][None], ref[inside][None]
    _frames_close(img, ref)


def test_pixel_bounds_match_the_full_frame(tmp_path):
    scene = tmp_path / "s.pbrt"
    scene.write_text(SCENE_TXT)
    full, one = str(tmp_path / "full.exr"), str(tmp_path / "one.exr")
    assert _run(tpbrt.main, [str(scene), "-o", full, "--cpu", "--quiet"])[0] == 0
    assert _run(tpbrt.main, [str(scene), "-o", one, "--cpu", "--quiet",
                             "--pixel", "5,5"])[0] == 0
    a, b = read_exr(full)[0], read_exr(one)[0]
    assert np.array_equal(a[5, 5], b[5, 5])
    mask = np.ones((8, 12), bool)
    mask[5, 5] = False
    assert (b.sum(-1)[mask] == 0).all()
    with pytest.raises(ValueError, match="do not intersect"):
        tpbrt.main([str(scene), "-o", one, "--cpu", "--quiet",
                    "--pixel", "20,20"])


def test_cropwindow_and_jitter_flags(tmp_path):
    scene = tmp_path / "s.pbrt"
    txt = "\n".join(line for line in SCENE_TXT.splitlines()
                    if "trianglemesh" not in line and "Attribute" not in line)
    scene.write_text(txt.replace('"halton"', '"independent"'))
    outs = []
    for spp in (1, 2):
        out = str(tmp_path / f"{spp}.exr")
        assert _run(tpbrt.main, [str(scene), "-o", out, "--cpu", "--quiet",
                                 "--spp", str(spp), "--disable-pixel-jitter",
                                 "--disable-wavelength-jitter"])[0] == 0
        outs.append(read_exr(out)[0])
    assert np.allclose(outs[0], outs[1], atol=1e-6)
    out = str(tmp_path / "crop.exr")
    assert _run(tpbrt.main, [str(scene), "-o", out, "--cpu", "--quiet",
                             "--cropwindow", "0,0.5,0,0.5"])[0] == 0
    img = read_exr(out)[0]
    assert img[:4, :6].min() > 0 and (img[4:] == 0).all()


def test_format_and_toply_match_jax(tmp_path):
    scene = tmp_path / "s.pbrt"
    scene.write_text(SCENE_TXT)
    texts = [_run(m, [str(scene), "--format"])[1]
             for m in (jpbrt.main, tpbrt.main)]
    assert texts[0] == texts[1]
    assert '"float fov" [ 30 ]' in texts[1]
    for tag, main in (("j", jpbrt.main), ("t", tpbrt.main)):
        d = tmp_path / tag
        d.mkdir()
        assert _run(main, [str(scene), "--toply", str(d / "o.pbrt")])[0] == 0
    jt, tt = (tmp_path / "j" / "o.pbrt").read_text(), (
        tmp_path / "t" / "o.pbrt").read_text()
    assert tt == jt.replace(str(tmp_path / "j"), str(tmp_path / "t"))
    assert "plymesh" in tt and "trianglemesh" not in tt
    assert ((tmp_path / "t" / "o_000.ply").read_bytes()
            == (tmp_path / "j" / "o_000.ply").read_bytes())
    from acceleratedvolrenderer_tpu_torch.scene.parser import load_scene

    assert len(load_scene(str(tmp_path / "t" / "o.pbrt"),
                          device="cpu").primitives) == 1


# CLI_SCENE with a point light, a diffuse floor and a sphere (the light
# path, SPPM and MLT need a finite light and surfaces), and CLI_SCENE with
# a sun over a fog sphere (BDPT needs a medium and a distant light)
SURFACE_ADDITIONS = (
    'LightSource "point" "point3 from" [0.5 2 0.5] "rgb I" [8 8 8]\n'
    'AttributeBegin\n'
    'Material "diffuse" "rgb reflectance" [0.6 0.6 0.6]\n'
    'Shape "trianglemesh" "point3 P" [-2 0 -2  3 0 -2  3 0 3  -2 0 3]\n'
    '    "integer indices" [0 1 2 0 2 3]\n'
    'AttributeEnd\n'
    'AttributeBegin\n'
    'Translate 0.5 0.6 0.8\n'
    'Shape "sphere" "float radius" [0.35]\n'
    'AttributeEnd\n')
FOG_ADDITIONS = (
    'LightSource "distant" "rgb L" [1 1 1] "float scale" [3]\n'
    '    "point3 from" [0 0 0] "point3 to" [0.3 -1 0.4]\n'
    'AttributeBegin\n'
    'MakeNamedMedium "fog" "string type" "homogeneous"\n'
    '    "rgb sigma_a" [0.5 0.5 0.5] "rgb sigma_s" [2 2 2]\n'
    'MediumInterface "fog" ""\n'
    'Material ""\n'
    'Translate 0.5 0.5 0.5\n'
    'Shape "sphere" "float radius" [0.5]\n'
    'AttributeEnd\n')


@pytest.mark.parametrize("integ", ["lightpath", "bdpt", "sppm", "mlt"])
def test_unported_integrators_raise(tmp_path, integ):
    """The reference's four other integrators through both CLIs on the
    CPU (this test's name is kept from when the port refused them).  The
    JAX side runs outside jit (its jitted light path, BDPT and SPPM take
    a minute or more to compile here) and draws the same numbers: the
    means to 1e-3 and at least 97% of pixels to rtol 1e-3 / atol 1e-5 (a
    splat may land across a pixel edge on an ulp).  MLT's chains draw
    from different generators: the means within 15%, the reference's
    gate (tests/test_mlt.py:49).  A scene file naming the integrator
    renders as the flag does (the reference renders it with volpath)."""
    text = CLI_SCENE + (FOG_ADDITIONS if integ == "bdpt"
                        else SURFACE_ADDITIONS)
    scene = tmp_path / "s.pbrt"
    scene.write_text(text)
    outs = []
    for tag, main in (("j", jpbrt.main), ("t", tpbrt.main)):
        out = str(tmp_path / f"{tag}.exr")
        rc, out_text = _run(main, [str(scene), "--cpu", "--integrator", integ,
                                   "--stats", "-o", out],
                            unjitted=tag == "j" and integ != "mlt")
        assert rc == 0
        stats = json.loads(out_text.strip().splitlines()[-1])
        assert stats["outfile"] == out and stats["render_time"] > 0
        outs.append(read_exr(out)[0])
    ref, img = outs
    assert img.shape == ref.shape == (8, 8, 3) and np.isfinite(img).all()
    assert img.mean() > 0
    if integ == "mlt":
        assert abs(img.mean() - ref.mean()) / ref.mean() < 0.15
    else:
        assert abs(img.mean() - ref.mean()) / ref.mean() < 1e-3
        close = np.isclose(img, ref, rtol=1e-3, atol=1e-5).all(-1)
        assert close.mean() >= 0.97, close.mean()
    scene.write_text(text.replace('"volpath"', f'"{integ}"'))
    out = str(tmp_path / "file.exr")
    assert _run(tpbrt.main, [str(scene), "--cpu", "--quiet", "-o", out])[0] == 0
    np.testing.assert_array_equal(read_exr(out)[0], img)


def test_cli_needs_cuda_unless_cpu(tmp_path, monkeypatch):
    scene = tmp_path / "s.pbrt"
    scene.write_text(CLI_SCENE)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--gpu-device", "0"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpbrt.main([str(scene), "-o", str(tmp_path / "o.exr"), *extra])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgm.main(["preset:sphere", "--quiet"])
    assert _run(tpbrt.main, [str(scene), "--format"])[0] == 0


def test_cli_help():
    for main in (tpbrt.main, tgm.main):
        with pytest.raises(SystemExit) as e:
            with contextlib.redirect_stdout(io.StringIO()):
                main(["--help"])
        assert e.value.code == 0


def test_quick_partial_images_pixelstats_and_checkpoint(tmp_path):
    out = tmp_path / "r.exr"
    assert _run(tpbrt.main, ["preset:fog_box", "--res", "16x16", "--spp", "8",
                             "--quick", "--cpu", "--write-partial-images",
                             "-o", str(out)])[0] == 0
    assert out.exists() and (tmp_path / "r_partial_s1.exr").exists()
    assert read_exr(str(out))[2]["samplesPerPixel"] == 2
    out2 = tmp_path / "p.exr"
    assert _run(tpbrt.main, ["preset:fog_box", "--res", "16x16", "--spp", "2",
                             "--cpu", "--pixelstats", "-o", str(out2)])[0] == 0
    assert (tmp_path / "p_variance.exr").exists()
    assert (tmp_path / "p_relative_variance.exr").exists()
    ck = tmp_path / "ck.npz"
    rc, text = _run(tpbrt.main, ["preset:fog_box", "--res", "16x16", "--spp",
                                 "4", "--cpu", "--checkpoint", str(ck),
                                 "--checkpoint-every", "2", "--stats",
                                 "-o", str(tmp_path / "c.exr")])
    assert rc == 0 and not ck.exists()
    assert json.loads(text.strip().splitlines()[-1])["resumed_from"] == 0


def test_mse_reference_flags(tmp_path):
    scene = tmp_path / "s.pbrt"
    scene.write_text(CLI_SCENE)
    ref = str(tmp_path / "ref.exr")
    assert _run(tpbrt.main, [str(scene), "-o", ref, "--cpu", "--quiet",
                             "--spp", "4"])[0] == 0
    out = str(tmp_path / "o.exr")
    rc, text = _run(tpbrt.main, [str(scene), "-o", out, "--cpu", "--stats",
                                 "--mse-reference-image", ref])
    stats = json.loads(text.strip().splitlines()[-1])
    assert rc == 0 and stats["mse"] > 0
    assert read_exr(out)[2]["MSE"] == pytest.approx(stats["mse"], rel=1e-6)
    log = tmp_path / "mse.txt"
    assert _run(tpbrt.main, [str(scene), "-o", out, "--cpu", "--quiet",
                             "--spp", "4", "--mse-reference-image", ref,
                             "--mse-reference-out", str(log)])[0] == 0
    rows = [line.split() for line in log.read_text().splitlines()]
    assert [int(r[0]) for r in rows] == [1, 2, 4]
    assert float(rows[-1][1]) == 0.0      # the same frame as the reference


def test_debugstart_and_function(tmp_path, monkeypatch):
    scene = tmp_path / "s.pbrt"
    scene.write_text(CLI_SCENE)
    rc, text = _run(tpbrt.main, [str(scene), "--cpu", "--debugstart",
                                 "3,2,1"])
    rec = json.loads(text)
    assert rc == 0 and rec["pixel"] == [3, 2] and rec["sample"] == 1
    full = str(tmp_path / "f.exr")
    _run(tpbrt.main, [str(scene), "-o", full, "--cpu", "--quiet"])
    np.testing.assert_allclose(rec["rgb_mean_up_to_sample"],
                               read_exr(full)[0][2, 3], rtol=1e-6)
    monkeypatch.chdir(tmp_path)
    assert _run(tpbrt.main, [str(scene), "--cpu", "--integrator", "function",
                             "--function", "step", "--spp", "4",
                             "-o", "fn.exr"])[0] == 0
    assert (tmp_path / "step-mse.txt").exists()
    assert read_exr("fn.exr")[0].shape == (8, 8, 3)


def sphere_scene_text(res=16):
    """tests/torch_graph_util.py's 32^3 sphere as a .pbrt file: a
    uniformgrid over the unit box, a distant light from above."""
    from acceleratedvolrenderer_tpu_torch.cli import nanovdb2pbrt

    buf = io.StringIO()
    nanovdb2pbrt.emit_pbrt(_sphere_density(), [0, 0, 0], [1, 1, 1],
                           "density", buf)
    return (
        "LookAt 0.5 0.5 -2.2  0.5 0.5 0.5  0 1 0\n"
        'Camera "perspective" "float fov" [30]\n'
        f'Film "rgb" "integer xresolution" [{res}] '
        f'"integer yresolution" [{res}]\n'
        'PixelFilter "box"\n'
        'Sampler "independent" "integer pixelsamples" [2]\n'
        'Integrator "volpath" "integer maxdepth" [4]\n'
        "WorldBegin\n"
        'LightSource "distant" "rgb L" [1 1 1] "float scale" [3]\n'
        '    "point3 from" [0 0 0] "point3 to" [0 -1 0]\n'
        "AttributeBegin\n"
        'MakeNamedMedium "sphere" "string type" "uniformgrid"\n'
        + buf.getvalue() +
        '    "float sigma_a" [0.1] "float sigma_s" [0.9] "float scale" [3]\n'
        'MediumInterface "sphere" ""\n'
        'Shape "sphere" "float radius" [2]\n'
        "AttributeEnd\n")


@pytest.fixture(scope="module")
def sphere_graphs(tmp_path_factory):
    """graph_maker of both packages on the sphere scene file, at a small
    configuration read from <scene>.json beside it."""
    d = tmp_path_factory.mktemp("graph")
    (d / "sphere.pbrt").write_text(sphere_scene_text())
    # tests/test_graph.py::test_build_and_light_and_render's configuration
    GraphConfig(builder=GraphBuilderConfig(
        dimension_steps=24, iterations_per_step=2, radius_modifier=20.0,
        max_depth=4), lighting=LightingCalculatorConfig(
        light_rays=8, bounces=2)).to_json(str(d / "sphere.json"))
    for tag, main in (("j", jgm.main), ("t", tgm.main)):
        assert _run(main, [str(d / "sphere.pbrt"), "--cpu", "--quiet",
                           "--out", str(d / tag)])[0] == 0
    return d


def test_graph_maker_pbrt_scene_matches_jax(sphere_graphs):
    d = sphere_graphs
    jg = JGraph.read_npz(str(d / "j_d2.npz"))
    tg = Graph.read_npz(str(d / "t_d2.npz"))
    assert (tg.n_vertices, tg.n_edges) == (jg.n_vertices, jg.n_edges)
    assert tg.n_vertices > 50 and tg.n_edges > 20
    np.testing.assert_allclose(tg.positions, jg.positions, atol=1e-6)
    np.testing.assert_array_equal(tg.edges, jg.edges)
    assert np.isclose(tg.light_scalar, jg.light_scalar,
                      rtol=1e-4).mean() >= 0.99
    stats = json.loads((d / "t_stats.json").read_text())
    assert stats["vertices"] == tg.n_vertices and len(stats["files"]) == 2


@pytest.mark.parametrize("integ", ["graph", "graph-debug", "analyzer"])
def test_graph_integrators_through_the_cli(sphere_graphs, integ):
    d = sphere_graphs
    argv = [str(d / "sphere.pbrt"), "--cpu", "--graph-data",
            str(d / "t_d2.npz"), "-o", str(d / f"{integ}.exr"), "--stats"]
    if integ == "analyzer":
        argv += ["--integrator", "analyzer", "--analyze-pixels", "8,8;4,9"]
    else:
        argv += ["--integrator", "graph"]
        if integ == "graph-debug":
            argv.append("--graph-debug")
    rc, text = _run(tpbrt.main, argv)
    assert rc == 0
    if integ == "analyzer":
        assert "analysis" in json.loads(text.strip().splitlines()[-1])
        return
    img = read_exr(str(d / f"{integ}.exr"))[0]
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.max() > 0
    if integ == "graph-debug":
        # the voxel view is deterministic: the JAX tool's, on its graph
        out = str(d / "j_debug.exr")
        argv[argv.index(str(d / "t_d2.npz"))] = str(d / "j_d2.npz")
        argv[argv.index(str(d / f"{integ}.exr"))] = out
        assert _run(jpbrt.main, argv)[0] == 0
        np.testing.assert_allclose(img, read_exr(out)[0], atol=1e-6)


class _Listener:
    """A TCP server on localhost that keeps every byte it receives."""

    def __init__(self):
        import socket
        import threading

        self.srv = socket.socket()
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(4)
        self.port = self.srv.getsockname()[1]
        self.data = []
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        while True:
            try:
                conn, _ = self.srv.accept()
            except OSError:
                return
            chunks = []
            while True:
                b = conn.recv(1 << 16)
                if not b:
                    break
                chunks.append(b)
            conn.close()
            self.data.append(b"".join(chunks))

    def close(self):
        self.srv.close()
        self.thread.join(timeout=5)


def _packets(raw):
    out, i = [], 0
    while i < len(raw):
        (n,) = np.frombuffer(raw[i:i + 4], "<u4")
        out.append(raw[i + 4:i + n])
        i += int(n)
    return out


def test_tev_display_packets_match_jax():
    from acceleratedvolrenderer_tpu.utils.display import TevDisplay as JTev
    from acceleratedvolrenderer_tpu_torch.utils.display import TevDisplay

    img = np.random.default_rng(0).random((5, 7, 3)).astype(np.float32)
    lst = _Listener()
    try:
        for cls in (JTev, TevDisplay):
            d = cls("127.0.0.1", lst.port)
            assert d.connected
            d.create("render", 7, 5)
            d.update("render", img, x=1, y=2)
            d.close_image("render")
            d.close()
        deadline = time.time() + 10
        while len(lst.data) < 2 and time.time() < deadline:
            time.sleep(0.01)
    finally:
        lst.close()
    assert len(lst.data) == 2 and lst.data[0] == lst.data[1]
    assert len(_packets(lst.data[1])) == 3
    assert not TevDisplay("127.0.0.1", 1).connected   # no viewer: no-ops


def test_display_server_streams_the_waves():
    lst = _Listener()
    try:
        assert _run(tpbrt.main, ["preset:fog_box", "--res", "8x8", "--spp",
                                 "5", "--cpu", "--quiet", "--display-server",
                                 f"127.0.0.1:{lst.port}", "-o",
                                 "/dev/null"])[0] == 0
        deadline = time.time() + 10
        while not lst.data and time.time() < deadline:
            time.sleep(0.01)
    finally:
        lst.close()
    # waves 1, 2 and 4 (powers of two) and the last, 5
    pk = _packets(lst.data[0])
    assert len(pk) == 4 and all(p[0] == 6 for p in pk)


def test_stats_and_utilization_match_jax(tmp_path):
    from acceleratedvolrenderer_tpu.utils import stats as jstats
    from acceleratedvolrenderer_tpu_torch.utils import stats as tstats

    reports = []
    for tag, mod in (("j", jstats), ("t", tstats)):
        acc = mod.StatsAccumulator()
        acc.count("Integrator/Camera rays", 1234)
        acc.percent("Media/Null collisions", 3, 12)
        acc.distribution("Integrator/Path length", np.arange(10))
        acc.pixel_counter("Pixel/time", np.ones((4, 5)))
        acc.pixel_counter("Pixel/time", np.ones((4, 5)))
        acc.write_pixel_stats(str(tmp_path / tag))
        reports.append(acc.report())
    assert reports[0] == reports[1]
    assert ((tmp_path / "t_Pixel_time.exr").read_bytes()
            == (tmp_path / "j_Pixel_time.exr").read_bytes())
    log = tstats.UtilizationLogger(interval=0.05, stream=io.StringIO())
    log.start()
    time.sleep(0.3)
    log.stop()
    assert log.samples and "utilization: cpu avg" in log.report()
    assert tstats.UtilizationLogger().report() == "utilization: no samples"
