"""render()'s loop at a chosen chunk size, for the tests of the port's wave
renderer.  Imports no JAX (tests/test_torch_cuda.py uses it on the card)."""
from acceleratedvolrenderer_tpu_torch.models.film import Film
from acceleratedvolrenderer_tpu_torch.parallel import render


def wave_frame(scene, rays_per_wave, device):
    """make_wave_renderer in chunks of `rays_per_wave` rays and a Film over
    scene.spp waves: ((H, W, 3) numpy image, loop iterations of each chunk
    in wave order)."""
    render_wave, density, majorant = render.make_wave_renderer(
        scene, rays_per_wave=rays_per_wave, device=device)
    film = Film.create(scene.height, scene.width, device)
    chunk_iterations = []
    for s in range(scene.spp):
        film, its = render_wave(film, density, majorant, s)
        chunk_iterations += its
    return film.to_image().cpu().numpy(), chunk_iterations
