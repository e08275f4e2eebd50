"""The port's NanoVDB reader and writer (utils/nvdb.py), BLOSC chunk codec
(utils/blosc.py), LZ4 block codec (native/lz4.cpp, built with g++ into
build/native/, and the pure-Python one) and nanovdb2pbrt
(cli/nanovdb2pbrt.py) against the JAX package's, on tests/test_nvdb.py's
cases: files written by either package are byte-identical and each reads
the other's bit for bit; the converter's text is character for character
the reference's, from a .nvdb and from dense arrays; the 24^3 ingestion
leg renders through both packages (frame means to 1e-3, 99% of pixels to
rtol 1e-3 / atol 1e-5)."""
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu import native as jnative
from acceleratedvolrenderer_tpu.cli import nanovdb2pbrt as jconv
from acceleratedvolrenderer_tpu.parallel import render as jrender
from acceleratedvolrenderer_tpu.scene import parser as jparser
from acceleratedvolrenderer_tpu.utils import blosc as jblosc
from acceleratedvolrenderer_tpu.utils import nvdb as jnvdb
from acceleratedvolrenderer_tpu_torch import native as tnative
from acceleratedvolrenderer_tpu_torch.cli import nanovdb2pbrt as tconv
from acceleratedvolrenderer_tpu_torch.parallel import render as trender
from acceleratedvolrenderer_tpu_torch.scene import parser as tparser
from acceleratedvolrenderer_tpu_torch.utils import blosc as tblosc
from acceleratedvolrenderer_tpu_torch.utils import nvdb as tnvdb

torch.set_num_threads(2)


def _grid(mod, kind):
    if kind == "sparse":
        rs = np.random.RandomState(0)
        dense = np.zeros((20, 30, 40), np.float32)
        dense[3:12, 5:25, 10:35] = rs.rand(9, 20, 25).astype(np.float32)
        dense[dense < 0.4] = 0.0
        origin, vs = (5, -3, 2), 0.1
    elif kind == "root tiles":
        dense = np.ones((4, 4, 16), np.float32)
        origin, vs = (-8, 0, 0), 0.1
    else:
        rng = np.random.default_rng(3)
        dense = ((rng.random((24, 20, 16)) < 0.3).astype(np.float32)
                 * rng.random((24, 20, 16)).astype(np.float32))
        origin, vs = (0, 0, 0), 1 / 16
    lo = np.array(origin, np.float64) * vs
    hi = lo + np.array(dense.shape[::-1], np.float64) * vs
    return mod.NvdbGrid(name="density", data=dense, index_min=origin,
                        world_bbox=np.stack([lo, hi]),
                        voxel_size=np.full(3, vs))


@pytest.mark.parametrize("codec", ["none", "zip", "blosc"])
@pytest.mark.parametrize("kind", ["sparse", "root tiles", "random"])
def test_nvdb_files_byte_identical(tmp_path, codec, kind):
    pj, pt = str(tmp_path / "j.nvdb"), str(tmp_path / "t.nvdb")
    jnvdb.write_nvdb(pj, _grid(jnvdb, kind), codec=codec)
    tnvdb.write_nvdb(pt, _grid(tnvdb, kind), codec=codec)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    want = _grid(tnvdb, kind)
    for got in (tnvdb.read_nvdb(pj), jnvdb.read_nvdb(pt)):
        assert got.name == "density" and got.is_fog_volume
        assert tuple(got.index_min) == tuple(want.index_min)
        np.testing.assert_array_equal(np.asarray(got.data), want.data)
        np.testing.assert_array_equal(got.world_bbox, want.world_bbox)
        np.testing.assert_array_equal(got.voxel_size, want.voxel_size)


def test_nvdb_multigrid_and_selection(tmp_path):
    g = _grid(tnvdb, "sparse")
    g2 = tnvdb.NvdbGrid(name="temperature", data=g.data * 2.0,
                        index_min=g.index_min, world_bbox=g.world_bbox,
                        voxel_size=g.voxel_size)
    p = str(tmp_path / "m.nvdb")
    tnvdb.write_nvdb(p, [g, g2], codec="zip")
    assert tnvdb.list_grids(p) == jnvdb.list_grids(p) == ["density",
                                                          "temperature"]
    np.testing.assert_array_equal(tnvdb.read_nvdb(p, "temperature").data,
                                  g.data * 2.0)
    with pytest.raises(KeyError):
        tnvdb.read_nvdb(p, "velocity")


def test_nvdb_rejects_garbage(tmp_path):
    p = tmp_path / "bad.nvdb"
    p.write_bytes(b"not a nanovdb file at all........")
    with pytest.raises(ValueError, match="magic"):
        tnvdb.read_nvdb(str(p))


def _blob(n=24):
    z, y, x = np.meshgrid(*(np.linspace(-1, 1, n),) * 3, indexing="ij")
    dense = np.exp(-4.0 * (x ** 2 + y ** 2 + z ** 2)).astype(np.float32) * 3
    dense[dense < 0.05] = 0.0
    return dense


@pytest.mark.parametrize("codec", ["none", "zip", "blosc"])
def test_nanovdb2pbrt_text_matches_jax(tmp_path, codec):
    n = 24
    nv = str(tmp_path / "blob.nvdb")
    tnvdb.write_nvdb(nv, tnvdb.NvdbGrid(
        name="density", data=_blob(n), index_min=(0, 0, 0),
        world_bbox=np.array([[0.0] * 3, [1.0] * 3]),
        voxel_size=np.full(3, 1.0 / n)), codec=codec)
    outs = []
    for tag, conv in (("j", jconv), ("t", tconv)):
        out = str(tmp_path / f"{tag}.txt")
        assert conv.main([nv, "-o", out]) == 0
        outs.append(open(out).read())
    assert outs[0] == outs[1]
    assert f'"integer nx" {n + 1}' in outs[1]
    assert '"point3 p0" [ 0.000000 0.000000 0.000000 ]' in outs[1]


@pytest.mark.parametrize("src", ["npy", "npz", "raw", "downsample"])
def test_nanovdb2pbrt_dense_inputs_match_jax(tmp_path, src):
    rng = np.random.default_rng(4)
    dens = rng.random((5, 3, 7)).astype(np.float32)
    dens[0] = 0.0
    dens[1, 1, 1] = -0.0
    dens[2, 2, 2] = 1234.5678
    args = ["--p0=-1,-1,-1", "--p1", "1,2,3"]
    if src == "npy":
        path = tmp_path / "d.npy"
        np.save(path, dens)
    elif src == "raw":
        path = tmp_path / "d.raw"
        dens.tofile(path)
        args += ["--dims", "7,3,5"]
    else:
        path = tmp_path / "d.npz"
        np.savez(path, density=dens, other=dens)
        if src == "downsample":
            args += ["--downsample", "1"]
    outs = []
    for tag, conv in (("j", jconv), ("t", tconv)):
        out = str(tmp_path / f"{tag}.txt")
        assert conv.main([str(path), *args, "-o", out]) == 0
        outs.append(open(out).read())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("count", [0, 1, 19, 20, 21, 40, 1000])
def test_emit_pbrt_value_text_matches_jax(count):
    """The bulk formatter against the reference's per-value loop, at
    counts around its 20-value lines, with zeros, -0, tiny, huge and
    non-finite values."""
    import io

    rng = np.random.default_rng(count)
    vals = (rng.standard_normal(count)
            * 10.0 ** rng.integers(-9, 9, count)).astype(np.float32)
    special = np.float32([0.0, -0.0, 1e-30, 3e38, np.inf, -np.inf, np.nan,
                          0.5, 1e-7, 5e-7])
    vals[:min(count, len(special))] = special[:count]
    arr = vals.reshape(1, 1, count)
    a, b = io.StringIO(), io.StringIO()
    jconv.emit_pbrt(arr, [0, 0, 0], [1, 1, 1], "density", a)
    tconv.emit_pbrt(arr, [0, 0, 0], [1, 1, 1], "density", b)
    assert a.getvalue() == b.getvalue()


def test_nvdb_ingestion_renders_like_jax(tmp_path):
    """tests/test_nvdb.py's ingestion leg, .nvdb -> converter -> .pbrt ->
    parse -> render, at 8x8 spp 4 through both packages."""
    n = 24
    nv = str(tmp_path / "blob.nvdb")
    tnvdb.write_nvdb(nv, tnvdb.NvdbGrid(
        name="density", data=_blob(n), index_min=(0, 0, 0),
        world_bbox=np.array([[0.0] * 3, [1.0] * 3]),
        voxel_size=np.full(3, 1.0 / n)), codec="zip")
    block = str(tmp_path / "grid.pbrt")
    assert tconv.main([nv, "-o", block]) == 0
    f = tmp_path / "s.pbrt"
    f.write_text(f'''
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
Sampler "independent" "integer pixelsamples" [4]
Integrator "volpath" "integer maxdepth" [5]
WorldBegin
LightSource "distant" "rgb L" [3 3 3] "point3 from" [0 5 0] "point3 to" [0.5 0.5 0.5]
AttributeBegin
MakeNamedMedium "cloud" "string type" "uniformgrid"
    "rgb sigma_a" [0.2 0.2 0.2] "rgb sigma_s" [1.5 1.5 1.5]
    {open(block).read()}
MediumInterface "cloud" ""
Material ""
Shape "sphere" "float radius" [10]
AttributeEnd
''')
    js = jparser.load_scene(str(f))
    ts = tparser.load_scene(str(f), device="cpu")
    assert ts.medium.density.shape == (n + 1,) * 3
    np.testing.assert_array_equal(ts.medium.density.numpy(),
                                  np.asarray(js.medium.density))
    ref, _ = jrender.render(js)
    img, _ = trender.render(ts, device="cpu")
    assert np.isfinite(img).all() and img.max() > 0
    assert abs(img.mean() - ref.mean()) / ref.mean() < 1e-3
    assert np.isclose(img, ref, rtol=1e-3, atol=1e-5).all(-1).mean() >= 0.99


LZ4_CASES = {
    "empty": b"",
    "short": b"short",
    "sine": np.sin(np.linspace(0, 30, 1 << 16)).astype(np.float32).tobytes(),
    "matches": np.random.default_rng(7).integers(0, 3, 50000,
                                                 np.uint8).tobytes(),
    "noise": np.random.default_rng(8).bytes(50000),
    "overlap": b"abcabcabcabcabcabcabcabcXYZ" * 10 + b"tail-bytes",
}


@pytest.mark.parametrize("case", sorted(LZ4_CASES))
def test_lz4_native_matches_reference(case):
    """The port's native codec (its own library) against the reference's
    native codec and both pure-Python codecs: the same blocks, each
    decoding the others'."""
    data = LZ4_CASES[case]
    if tnative.lz4_library() is None or not jnative.is_available():
        pytest.skip("no g++ to build the native codec")
    c_t = tnative.lz4_compress_block(data)
    assert c_t == jnative.lz4_compress_block(data)
    c_py = tblosc._lz4_compress_block_py(data)
    assert c_py == jblosc._lz4_compress_block_py(data)
    assert tnative.lz4_decompress_block(c_py, len(data)) == data
    assert tblosc._lz4_decompress_block_py(c_t, len(data)) == data
    assert tblosc.lz4_decompress_block(c_t, len(data)) == data
    assert tblosc.lz4_compress_block(data) == c_t


def test_lz4_malformed_input_raises():
    if tnative.lz4_library() is None:
        pytest.skip("no g++ to build the native codec")
    with pytest.raises(ValueError):
        tnative.lz4_decompress_block(b"\xff\xff\xff", 100)


def test_lz4_without_the_library_runs_the_python_codec(monkeypatch):
    """As the reference chooses: when the native library cannot be built,
    the LZ4 entries give None and blosc runs its pure-Python codec."""
    monkeypatch.setattr(tnative, "lz4_library", lambda: None)
    data = LZ4_CASES["overlap"]
    assert tnative.lz4_compress_block(data) is None
    comp = tblosc.lz4_compress_block(data)
    assert comp == jblosc._lz4_compress_block_py(data)
    assert tblosc.lz4_decompress_block(comp, len(data)) == data


def test_blosc_chunks_byte_identical():
    rng = np.random.default_rng(0)
    data = np.sin(np.linspace(0, 20, 5000)).astype(np.float32).tobytes()
    big = (np.arange(100000, dtype=np.uint32) % 251).astype(
        np.uint8).tobytes()
    cases = [(data, dict(typesize=4, do_shuffle=True)),
             (data, dict(typesize=4, do_shuffle=False)),
             (data, dict(typesize=1, do_shuffle=False)),
             (rng.bytes(3000), dict(typesize=4)),
             (big, dict(typesize=4, blocksize=1 << 14))]
    for raw, kw in cases:
        chunk = tblosc.compress(raw, **kw)
        assert chunk == jblosc.compress(raw, **kw)
        assert tblosc.decompress(chunk) == raw
    memcpy = (bytes([2, 1, tblosc.FLAG_MEMCPY, 1]) + np.uint32(5).tobytes()
              + np.uint32(5).tobytes() + np.uint32(21).tobytes() + b"hello")
    assert tblosc.decompress(memcpy) == b"hello"
    assert tblosc.shuffle(data, 4) == jblosc.shuffle(data, 4)
    assert tblosc.unshuffle(tblosc.shuffle(data, 4), 4) == data
