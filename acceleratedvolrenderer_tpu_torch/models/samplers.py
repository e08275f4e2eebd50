"""Pixel-sample generation (port of acceleratedvolrenderer_tpu/models/samplers.py;
the independent sampler only)."""
from __future__ import annotations

from ..ops import dda


def film_sample(kind: str, pixel_index, sample_index, spp: int, seed: int = 0):
    """((N,) u1, (N,) u2) film-jitter uniforms plus the advanced PCG stream
    for the sample's later draws.  Streams are keyed by (pixel, sample)."""
    if kind != "independent":
        raise NotImplementedError(f"sampler {kind!r}: only 'independent' is "
                                  "ported")
    rng = dda.seed_stream(pixel_index, sample_index, salt=seed)
    rng, ua = dda.pcg_uniform(rng)
    rng, ub = dda.pcg_uniform(rng)
    return ua, ub, rng
