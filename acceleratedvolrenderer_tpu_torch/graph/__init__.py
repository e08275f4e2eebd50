"""Graph-based radiance caching (port of acceleratedvolrenderer_tpu/graph):
model.py (the graph and its files), config.py (the precompute's
configuration), builder.py (light-path tracing and the vertex merge),
lighting.py (the light vector and the transport power iteration),
analyzer.py (the cache's coverage of camera-path scatters) and voxels.py
(boundary voxel shells).  The render-time lookup is
models/integrators/graph.py."""
