"""The port's render checkpoints (parallel/checkpoint.py) on
tests/test_checkpoint.py's cases: a render resumed from a checkpoint equals
the uninterrupted one bit for bit (and the JAX package's frame at the
earlier slices' tolerances: means to 1e-3, 99% of pixels to rtol 1e-3 /
atol 1e-5); the CLI killed once its first checkpoint lands and run again
resumes to the same EXR bit for bit (a subprocess with a timeout);
save / load round-trip; and load and render_with_checkpoints run on the
CUDA card unless asked for the CPU."""
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.parallel import render as jrender
from acceleratedvolrenderer_tpu.scene import presets as jpresets
from acceleratedvolrenderer_tpu_torch.models.film import Film
from acceleratedvolrenderer_tpu_torch.parallel import checkpoint as ckpt
from acceleratedvolrenderer_tpu_torch.parallel import render as trender
from acceleratedvolrenderer_tpu_torch.scene import presets as tpresets
from acceleratedvolrenderer_tpu_torch.utils.image import read_exr

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    return tpresets.fog_box(res=24, spp=8, device="cpu")


def test_resume_bitwise_equal(tmp_path, scene):
    path = str(tmp_path / "ck.npz")
    img_ref, _ = trender.render(scene, device="cpu")
    # a completed render leaves no checkpoint
    ckpt.render_with_checkpoints(scene, spp=5, checkpoint_path=path,
                                 checkpoint_every=4, device="cpu")
    assert not os.path.exists(path)
    # a checkpoint after 4 of the 8 waves
    render_wave, density, majorant = trender.make_wave_renderer(
        scene, device="cpu")
    film = Film.create(scene.height, scene.width, "cpu")
    for s in range(4):
        film, _ = render_wave(film, density, majorant, s)
    ckpt.save(path, film, 4, {"spp_target": scene.spp})
    img, stats = ckpt.render_with_checkpoints(scene, checkpoint_path=path,
                                              device="cpu")
    assert stats["resumed_from"] == 4 and stats["iterations"] > 0
    np.testing.assert_array_equal(img, img_ref)
    assert not os.path.exists(path)


def test_checkpointed_render_matches_jax(scene):
    ref, _ = jrender.render(jpresets.fog_box(res=24, spp=8))
    img, stats = ckpt.render_with_checkpoints(scene, device="cpu")
    assert stats["resumed_from"] == 0
    assert abs(img.mean() - ref.mean()) / ref.mean() < 1e-3
    assert np.isclose(img, ref, rtol=1e-3, atol=1e-5).all(-1).mean() >= 0.99


def test_checkpoint_written_every_n_samples(tmp_path, scene, monkeypatch):
    saved = []
    monkeypatch.setattr(ckpt, "save", lambda p, f, n, m: saved.append(n))
    ckpt.render_with_checkpoints(scene, checkpoint_path=str(
        tmp_path / "c.npz"), checkpoint_every=3, device="cpu")
    assert saved == [3, 6]


def test_cli_kill_and_resume(tmp_path):
    """cli/pbrt.py --checkpoint as a subprocess, SIGKILLed once the first
    checkpoint lands, run again with the same command: the resumed EXR
    equals an uninterrupted run's bit for bit."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")

    def cmd(out, ck):
        return [sys.executable, "-m", "acceleratedvolrenderer_tpu_torch.cli.pbrt",
                "preset:fog_box", "--res", "24x24", "--spp", "16", "--cpu",
                "--checkpoint", ck, "--checkpoint-every", "1", "-o", out]

    ref = str(tmp_path / "ref.exr")
    subprocess.run(cmd(ref, str(tmp_path / "ck_ref.npz")), env=env,
                   check=True, timeout=300, capture_output=True)
    out, ck = str(tmp_path / "resumed.exr"), str(tmp_path / "ck.npz")
    for _ in range(3):
        p = subprocess.Popen(cmd(out, ck), env=env, stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
        try:
            deadline = time.time() + 300
            while time.time() < deadline and p.poll() is None:
                if os.path.exists(ck):
                    break
                time.sleep(0.01)
            killed_midway = p.poll() is None and not os.path.exists(out)
            if p.poll() is None:
                p.send_signal(signal.SIGKILL)
            p.wait(timeout=60)
        finally:
            if p.poll() is None:
                p.kill()
        if killed_midway and os.path.exists(ck):
            break
        for f in (out, ck):
            if os.path.exists(f):
                os.remove(f)
    else:
        pytest.fail("the render completed before the kill landed (3 tries)")
    assert not os.path.exists(out)
    done = subprocess.run(cmd(out, ck), env=env, check=True, timeout=300,
                          capture_output=True, text=True)
    assert not os.path.exists(ck), done.stdout
    np.testing.assert_array_equal(read_exr(out)[0], read_exr(ref)[0])


def test_save_load_roundtrip(tmp_path):
    film = Film(torch.arange(48, dtype=torch.float32).reshape(4, 4, 3),
                torch.full((4, 4), 2.0))
    p = str(tmp_path / "f.npz")
    ckpt.save(p, film, 7, {"spp_target": 16})
    f2, nxt, meta = ckpt.load(p, "cpu")
    assert nxt == 7 and int(meta["spp_target"]) == 16
    assert torch.equal(f2.rgb_sum, film.rgb_sum)
    assert torch.equal(f2.weight_sum, film.weight_sum)
    # the JAX package reads the port's checkpoint
    from acceleratedvolrenderer_tpu.parallel import checkpoint as jckpt

    jf, jn, _ = jckpt.load(p)
    assert jn == 7
    np.testing.assert_array_equal(np.asarray(jf.rgb_sum),
                                  film.rgb_sum.numpy())


def test_checkpoint_entries_need_cuda_unless_asked(tmp_path, scene,
                                                   monkeypatch):
    p = str(tmp_path / "f.npz")
    ckpt.save(p, Film.create(2, 2, "cpu"), 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.load(p)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.render_with_checkpoints(scene, checkpoint_path=p)
