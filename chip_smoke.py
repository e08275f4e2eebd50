#!/usr/bin/env python
"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero).  Phases 1-4,
10, 11 and phase 15's timed gather run first, alone on the card; then the
phases that need neither phase 8's scene nor its frames (5-7, 12, 13,
15-17, 19-22, 24, 26, 29's small legs, 30 and 37, in that order from 24,
15 and 37)
run in a second process, this script with --side (side_main), beside the
rest (8, 9, 14, 18, 23, 25, 28, 29's full-size legs, 27, 31-36 and 38, in
that order), which waits for the side's phase 24 and 15 frames before phase 29
and for its end before the record.  The side's output is printed when it
ends, and the wall line says how long after it the parent's phases
ended; a failure in either process fails the script and ends the other.
  1. device: requires CUDA; prints the card and its power limit;
  2. build: compiles the CUDA kernels from acceleratedvolrenderer_tpu_torch/csrc
     with nvcc into build/kernels/ and prints the build time;
  3. kernel vs plain: the march kernel against its eager PyTorch version on
     random lanes (N 16384 and 1000, K 1/8/16, 16^3/32^3/64^3 tables,
     residual mode off and on; N 262144, K 8, 16^3, the lane count of the
     wave path's chunks; N 65536, K 8, 16^3, render()'s one chunk of a
     256x256 frame; and N 1, 31, 127, 129, 16383, 16385): integers and
     flags equal, floats to rtol 1e-6, every output of the plain version's
     dtype and shape and contiguous.  At the main-path shapes (N 16384,
     65536 and 262144, K 8, 16^3): the wrapper's ms per call, the kernel alone by
     its name in torch.profiler warm (back to back) and cold (after a
     256 MB flush), everything one call launches, and the bound; the plain
     version at N 16384; the launch floor (a one-element zero_) and the
     floor with one round trip to device memory (a one-element neg_ after
     the flush);
  4. gather kernel vs plain: the table gather against its eager version,
     V 128 / 1000 / 4096 / 32768 / 64^3 and n 100 / 96*8 / 208*8 /
     1000*8 / 16384*8 random indices (a few out of range), and index views
     0-3 elements past a 16-byte boundary with n 1 .. 9 and 16384*8 + 5,
     bitwise equal, one launch each; at n 16384*8, V 4096 the kernel and
     table[idx] timed in turns (wrapper ms by CUDA events, device us by
     torch.profiler) and the plain version; the window route of the march
     step on the card against the plain march (N 1000, 208 and 16384, K 8,
     16^3), as phase 3 compares, one gather launch each;
  5. small frame: the 32x24 test cloud rendered through the port on the GPU
     and on the CPU must agree (frame means to 1e-3 relative, >= 99% of
     pixels to rtol 1e-3 / atol 1e-5: transcendental functions differ by
     ulps between the two, and one flipped choice reroutes a sample);
  6. window frame: the same cloud at 208 lanes (208 % 128 != 0: the window
     route) on the GPU.  The gather kernel must launch once per loop
     iteration and the march kernel never; the frame must agree, at phase
     5's tolerances, with the CPU render at 208 lanes and with phase 5's
     GPU frame at 256 lanes (the fused route): per-sample estimates do not
     depend on the lane count.  Then the two routes at the same 208 lanes,
     alternated twice (the fused route forced by patching march.available):
     frames agree at phase 5's tolerances, and the host ms per loop
     iteration of each;
  7. gradient FD gate: d(mean film)/d(density) of a 16x12 cloud (16^3
     grid, spp 2, max_depth 4) at 96 lanes (window route) and 128 lanes
     (fused route); central differences on the 3 largest-gradient voxels
     equal the gradient to 1%;
  8. slice: the 1280x720 cloud over the 256^3 grid, WIDE_LANES lanes
     (16384 before phase 31 came), the bench knobs, spp SPP 1 (16 before
     phase 28, 8 before phase 29, 2 before phase 31 came): one
     timed render (the earlier phases have run every
     kernel and code path of it).  The film must be finite with a positive
     mean, and the march kernel must have launched exactly once per loop
     iteration;
  9. full-frame gradient: the same scene at spp GRAD_SPP 1 (bench.py's
     backward leg takes spp 4): diff.size_fixed_steps (a record_alive
     forward under the gradient's own majorant) gives the iterations, then
     the gradient over int(1.12 * iterations) + 16 checkpointed steps in
     windows of max(sqrt(steps), 16).  Loss finite and positive, gradient finite with
     a nonzero maximum, and the march kernel launched twice per step run
     (forward sweep and recompute); prints the seconds, Mrays/s and peak
     device memory;
 10. dma kernel vs plain: the tile-DMA gather against its eager version
     over the 256^3 table, chunk 1 / 16 / 17 / 100 / 1000 / 2112 / 16384 /
     65536 random in-range tile ids, one chunk with out-of-range ids and
     one of repeated ids, bitwise equal, one launch each; at chunk 16384
     the kernel warm (back to back: wrapper ms by CUDA events, 200 calls,
     and device us by torch.profiler) and cold (a 256 MB buffer rewritten
     before each launch: device us, and ms by each launch's own events;
     and device us after a flush that only reads the buffer),
     its device time at chunk 16 warm and cold (the time follows the
     fetches), the plain version, the one PyTorch call that returns the
     same tile, t3[tile_idx[j*]]; prints the bound of the design's
     fetches and that of the output alone;
 11. gather designs: scripts/measure_gather_designs_torch.py's measure(16384,
     200), the dma kernel's path: ns per element of the baseline gather,
     the tile-DMA design and the argsort bound; the wrapper is called
     1 + 200 times (warm-up and graph capture) and the kernel runs
     1 + 3 * 200 times (the graph is replayed three times);
 12. wave frame, small: the 32x24 cloud through make_wave_renderer and Film
     (render()'s loop) on the GPU and the CPU at 256 rays per chunk (fused
     route: one march launch per loop iteration) and 200 (window route: one
     gather launch per iteration), compared at phase 5's tolerances;
 13. wave gradient FD gate: make_diff_renderer_multi on the 6x6 scene of
     tests/test_diff.py (window route) and on a 16x16 cloud with a 16^3
     grid, absorption and emission (256 lanes, fused route): all four
     DIFF_PARAMS families finite and nonzero, central differences equal
     the gradient to test_diff's tolerances (density 2e-3, sigma_a /
     sigma_s and Le_grid 5e-3), two launches per step per sample;
 14. wave frame, full width: phase 8's scene through render() at spp 1 in
     chunks of 262144 rays: finite, positive mean within 2% of phase 8's
     regen frame mean (both estimate one image), march launches equal to
     the loop iterations summed over the chunks;
 15. fog box (homogeneous medium, a 1^3 majorant: the window route): a
     24x24 frame on the GPU and the CPU at phase 5's tolerances; the
     gather kernel at the route's shapes (V 1, n 16384*8 in regen and
     65536*8 in render(), 1% of the ids out of range) against its plain
     version, each timed with table[idx] and its bound (phase_gather_v1,
     after phase 11, alone on the card); then 256x256 through
     render() at spp 32 and render_regen at spp 8 with the bench knobs:
     films finite with positive means within 2% of each other, one gather
     launch per loop iteration and no march launch; seconds and Mrays/s;
 16. emissive volume (96^3 grid, blackbody emission): a 24x24 frame on the
     GPU and the CPU at phase 5's tolerances; 256x256 through render() at
     spp 16 (32 before phase 31 came) and regen at spp 8, means within
     2%, one march launch per
     iteration (fused route);
 17. explosion (RGB grids), 256x256: render() at spp 8 (16 before phase
     31) and regen at spp 4,
     means within 2%, one march launch per iteration; and a 12x12 frame on
     the GPU and the CPU at phase 5's tolerances;
 18. residual shadow: phase 8's scene by regen at spp RESIDUAL_SPP 1
     with the bench knobs at WIDE_LANES lanes and residual_shadow: every
     march launch the residual instance, one per iteration, film finite
     with a mean within 2% of phase 8's; seconds and Mrays/s beside phase
     8's; the frame's march call RESIDUAL_CAPTURE_CALL (N WIDE_LANES, K 8,
     16^3) through the kernel and its plain version, timed as phase 3
     times the plain instance, with its bound; then the 32x24 cloud at 208
     lanes (the window route, two gather launches per iteration) on the
     GPU and the CPU, compared;
 19. knobs: the 32x24 cloud with event_groups 2, with retire_every 2
     (per-sample retire, one retire group) and with per-sample retire
     alone (accum_spp off), each on the GPU and the CPU, compared at
     phase 5's tolerances;
 20. tracking: delta_track (without and with emission) and ratio_track on
     4096 rays over the 32^3 test sphere of tests/test_graph.py, on the
     GPU and the CPU: delta_track's events equal for >= 99% of rays and,
     where equal, t_event / beta / r_u / r_l / L_emit to rtol 1e-5 / atol
     1e-6; ratio_track's T_ray the same on >= 99% of rays, r_l / r_u where
     T_ray != 0; then tests/test_twin.py's fog box and density grid: the
     staged li against the fused li on the card at rtol 2e-4 / atol 2e-5;
 21. graph, small: a graph built on the CPU with test_graph.py's sphere
     and configuration; its light vector on the GPU against the CPU (>= 99%
     of vertices to rtol 1e-4 / atol 1e-7, means to 1e-4), the final light's
     index_add_ path on the GPU and the CPU against the host path (rtol
     1e-5), render_graph at 16x16 (free and uniform graph) and debug_image
     on the GPU against the CPU (phase 5's tolerances; the debug image to
     rtol 1e-6); no kernel of phases 3-4 and 10 launches;
 22. graph, full width: graph_maker preset:sphere with the default
     GraphConfig on the card into a temporary directory (vertices, edges,
     build and lighting seconds, delta_track iterations, peak device
     memory), then render_graph of presets.sphere_medium() at 640x480, spp
     GRAPH_SPP (307,200 rays per wave) and render() of the same scene at
     the same spp: finite images, graph / path mean ratio in (0.5, 2), the
     relative MSE, seconds, rays per second, delta_track iterations per
     wave, peak device memory; the graph path launches none of the three
     kernels (`graph_launches` in the kernels' record);
 23. cloud + surfaces: phase 8's scene with a ground quad, a rough
     conductor sphere and a glass sphere (cloud_with_surfaces), by
     render_regen with the bench knobs at WIDE_LANES lanes and spp
     SURF_REGEN_SPP and by render()
     at spp 1: films finite, positive, means within 2%, one march launch per
     loop iteration (`cloud_surfaces_regen_launches`,
     `cloud_surfaces_render_launches`), seconds, iterations, Mrays/s, mean
     and peak device memory; the regen frame's march_block call
     SURF_CAPTURE_CALL (segments cut at the surface hits) through the
     kernel and its plain version; the 32x24 cloud with the same surfaces
     on the GPU and the CPU, pixels at phase 5's tolerances, means to
     SURF_MEAN_TOL (1e-2: see its comment);
 24. room: cornell_room (five diffuse quads, an emissive quad, a glass and
     a rough conductor sphere, a 912-triangle mesh) at 1280x720 through
     render() with integrator path, simplepath and volpath (an empty
     medium: the window route, one gather launch per iteration,
     `room_volpath_launches`) at spp ROOM_SPP and the bvh light sampler:
     path and simplepath means within 2%, volpath's within
     ROOM_VOLPATH_TOL; the 32x24 room by each at spp ROOM_SMALL_SPP on
     the GPU and the CPU at phase 5's tolerances;
 25. sky: phase 8's scene with its sun and a 512x1024 sky map
     (cloud_under_sky: utils/sky.py's Preetham sky at the sun's elevation,
     as an ImageInfiniteLight) through render() at spp 1 with pmj02bn
     (chunks of 262144 rays) and regen at spp 1 with zsobol and the bench
     knobs at WIDE_LANES lanes: films finite, positive, means within
     FULL_MEAN_TOL, one march launch per iteration (`sky_*_launches`),
     seconds, iterations, Mrays/s, peak memory, the regen ms per iteration
     beside phase 8's; the regen frame's march call SKY_CAPTURE_CALL
     through the kernel and its plain version; film_sample of all seven
     kinds over the 921,600 pixels at sample indices 0, 1 and 1023 on the
     card equal to the CPU bit for bit; the 32x24 frames (pmj02bn render(),
     zsobol regen) on the GPU and the CPU at phase 5's tolerances; the
     pmj02bn tables' generation time (cold on a fresh checkout);
 26. room samplers: phase 24's room through path with halton at spp 1 (a
     PathSampler per chunk), no kernel launched, its mean within
     FULL_MEAN_TOL of phase 24's path frame; the room with a goniometric
     light and a projector (room_with_projectors) at 320x180 spp 4, and at
     32x24 on the GPU and the CPU at phase 5's tolerances;
 27. portal and entries: a PortalImageInfiniteLight over the 512^2 sky
     map, sample_li and pdf_li at 262144 points on the card against the
     CPU (see the tolerance at the check), test_portal_light.py's gates on
     the card (portal_checks), sample_li's ms per call; render_spectral of
     phase 25's scene at spp 1 (RGB mean equal to render()'s to 1e-6,
     bucket images finite); render_gbuffer of the room and of phase 23's
     cloud with surfaces at 1280x720, the 32x24 room's on the GPU and the
     CPU; render_with_aovs of the room through path at spp 2, its mean
     within FULL_MEAN_TOL of phase 24's path frame;
 28. scene file: phase 8's 256^3 density written to a .nvdb
     (utils/nvdb.py), converted by cli/nanovdb2pbrt.py to a "uniformgrid"
     block (257^3: the converter adds a layer of background, as pbrt's
     does) and wrapped in a .pbrt file stating the preset's 1280x720
     scene (scene_file_text), rendered by the CLI (`cli/pbrt.py --spp 1
     --stats --mse-reference-image` phase 14's frame `--write-png`):
     seconds of each step (nvdb write, conversion, parse, render, EXR
     write and read back), the MSE against phase 14's frame, iterations,
     march launches (one per iteration), Mrays/s and peak memory; the PNG
     (encode_png, PIL's bytes) decoded equal to to_8bit of the run's EXR
     frame and to encode_png's file of it, its bytes, the CLI's write and
     encode_png's seconds, its rows' filter types, and the bytes and
     seconds of the unfiltered level-6 encoder the port had before
     (old_png_bytes); the parsed grid equal
     bit for bit to the values its text states (the converter prints six
     decimals: within GRID_TEXT_TOL of the preset's) and its extra layer
     zero; the
     mean within FULL_MEAN_TOL of phase 14's; the same scene at 32x24 on
     the GPU and the CPU at phase 5's tolerances; then a 256x256 fog box
     file (fog_box_file_text) through `--checkpoint` at spp 8 and
     `--checkpoint-every 4`, stopped once the first checkpoint lands and
     resumed: the EXR equal bit for bit to an uninterrupted render, the
     gather launched once per loop iteration of each run.
 29. other integrators: cornell_room at 1280x720 through render_lightpath
     at spp 1 (921,600 light paths; luminance mean within 15% of phase
     24's path frame, tests/test_lightpath.py:40) and render_sppm (2
     iterations of 921,600 photons; tests/test_sppm.py:73's |m - m_ref| <
     0.05 m_ref + 0.01; truncated candidates printed).  The SPPM and BDPT
     gates fail at full size in the reference too (SPPM_SMALL,
     BDPT_SMALL): those legs print their gap, and the port's frames at
     the small sizes are held to the JAX package's means there; phase 8's
     cloud through render_bdpt at max_depth 4, spp 1 against render() of
     the same scene at max_depth 4 (tests/test_bdpt.py:113's 12%);
     render_mlt on the room with MLT_CHAINS x MLT_MUTATIONS mutations
     (mean within 15% of phase 24's frame, and the luminance
     correlation of the two frames averaged over 32x32-pixel blocks above
     0.8) and render_mlt_vol on phase 15's 256x256 fog box (mean within
     15% of its render() frame, 60th-percentile overlap above 0.5,
     tests/test_mlt.py:94-98); each leg's seconds, paths per second, peak
     device memory and launches (none of the three kernels); the four
     through cli/pbrt.py at max depth 1 on 32x24 scene files
     (room_file_text; fog_box_file_text, 24x24) on the GPU and with
     --cpu, and through their
     entries on the 32x24 room and cloud on the GPU and the CPU, to
     INTEG_MEAN_TOL / INTEG_PIXEL_SHARE (MLT by the 15% gate).
 30. item1 (the MIP map, the subsurface and measured materials, hair and
     the tools), each leg's seconds, rate, peak device memory and launches
     beside the card: (a) room_file_text with the glass sphere subsurface
     and the diffuse one measured (a .bsdf that measured.synthesize_ggx
     writes; item1_file_text) by the pbrt CLI at 1280x720 spp 1, the
     subsurface sphere's pixels not black, the 32x24 file on the GPU and
     with --cpu to INTEG_MEAN_TOL / INTEG_PIXEL_SHARE; (b)
     tests/test_bssrdf.py's subsurface ball at 1280x720 spp 1 by render()
     with the Burley and the tabulated profile, means within 12%, the beam
     diffusion table's host seconds; (c) the light path, SPPM and BDPT
     (with a distant light and a thin fog) through the CLI on (a)'s file
     at 32x24 on the GPU and the CPU; (d) the 32x24 cloud over 32^3 with a
     subsurface and a measured sphere by render() on the GPU and the CPU
     (the reference's Lambert-fallback warning, SURF_MEAN_TOL, one march
     launch per iteration, call ITEM1_CAPTURE_CALL against plain); (e)
     262,144 trilinear and EWA lookups into a 1024^2 RGB MIP map, card
     against CPU at rtol 1e-5 / atol 1e-6, ms per call; (f) hair_sample at
     1,048,576 lanes, the white furnace (0.85-1.15) from the card's
     numbers, 65,536 lanes against the CPU; (g) imgtool diff of (b)'s
     frames (MSE, MRSE, L1, FLIP), convert to PNG and falsecolor (no PIL),
     plytool info on the room's mesh, cyhair2pbrt parsed back (4 curves),
     rgb2spec_opt at resolution 64 (786,432 fits) with 64 lattice points
     held to the CPU fit at rtol 1e-4.
 31. sharding (parallel/mesh.py, parallel/diff.py over torch.distributed):
     (a) a world of one over NCCL in this process: render_sharded_regen of
     phase 8's scene with phase 8's knobs, its film within SHARD_REGEN_TOL
     3e-5 of phase 8's, one march launch per iteration; then SHARD_WORLD 2
     ranks, this script with --shard-rank, in a gloo group on the one card
     (NCCL refuses two ranks on one device), each building phase 8's scene
     from the parent's grid: (b) render_sharded_regen, the all-reduced film
     within 3e-5 of (a)'s, march launches in each rank (one per
     iteration), rank 0's march call SHARD_CAPTURE_CALL equal to plain,
     each rank's render and all-reduce seconds; (c) render_sharded at spp
     1, within rtol / atol 1e-5 of phase 14's frame; (d)
     make_sharded_regen_grad with overlap, phase 9's knobs and
     SHARD_MICROBATCHES 2 per rank (fixed_steps from diff.size_fixed_steps
     over each rank's microbatches): the loss within
     rtol 1e-5 of phase 9's, the shards, joined and cut to the grid,
     within rtol 1e-4 / atol 1e-8 of phase 9's gradient, each
     microbatch's compute seconds and the seconds its reduce-scatter held
     up the compute stream (CUDA events); and, in two
     more gloo ranks beside those, tests/test_diff.py's sharded cases at
     their 8x8 size on the card (make_sharded_loss,
     make_sharded_regen_grad with overlap off) against the port's
     single-device gradients on the CPU at that test's tolerances.  A
     failed group, rank or collective fails the phase.
 32. image formats (utils/tiff.py, utils/webp.py, the GIF, QOI and netpbm
     decoders of utils/image.py): a .pbrt file that Includes phase 28's
     converted 256^3 cloud (image_formats_file_text), under an infinite
     light whose map is a 2048x1024 16-bit RGB LZW TIFF with the
     horizontal predictor (scripts/time_image_decode.py's sky and
     writer), over a ground quad whose imagemap texture is the committed
     1024x512 lossy WebP (tests/data/images/), rendered by the CLI at
     1280x720 spp 1 with the parser's warnings made errors (no fallback
     to a uniform sky).  (a) The frame equals, max |diff| 0, the same file
     with both maps rewritten as PNG (16- and 8-bit) from the port's own
     decoded samples, and its mean differs from the file's with the map's
     filename removed (a uniform sky); (b) each render's march launches
     (one per loop iteration, no gather or dma launch) and the map
     frame's march call IMAGE_CAPTURE_CALL held equal to plain; (c) the
     32x24 version on the card and the CPU within SURF_MEAN_TOL; (d) the
     host seconds of one decode each (three before phase 34 came) of the
     committed 2048x1024 lossy WebP (held to its hash of PIL's samples,
     as the ground's is), an 8-bit and a 16-bit LZW TIFF, a GIF, a QOI
     and a binary PPM at 2048x1024 (and a 4:2:0 JPEG), each equal to its
     written samples, and the parse and render seconds and peak device
     memory.  It keeps the medium file, the ground's decoded samples and
     (d)'s 8-bit TIFF for phase 34 and returns the uniform-sky frame's
     mean.
 33. image writers (utils/image_write.py, the PCX, SGI, IM and DDS readers
     of utils/image_read.py, the DIB reader of utils/image.py): phase
     32's map frame (1280x720, rendered on the card; it launches no
     kernel here) through the port's `imgtool convert --tonemap` to each
     of WRITER_EXTS (.dib among them) and `imgtool falsecolor` to .png
     and .jpg, each file read back through read_image and imgtool's
     loader: the lossless ones equal the frame's tonemapped 8-bit samples
     (max |diff| 0), the JPEGs' decodes reach WRITER_MIN_PSNR against
     them (the falsecolor one against its PNG); the files of the
     committed ground fixture's first 128x96 pixels hash as PIL's do
     (images.json; this machine has no PIL); and encode_png's files of
     the ground's 128x96, 37x23 and whole 1024x512 samples held to PIL's
     (png_hashes_held): the decompressed IDAT stream's SHA-256 always, the
     file's where this host's zlib is images.json's pil_zlib (else both
     versions printed).  Each file's bytes and seconds (the CLI call and
     the encode alone).
 34. block-compressed maps (utils/bcn.py; the palette DDS, PSD, ICO and
     BigTIFF readers): (a) scripts/block_maps.py's integer encoders
     rebuild phase 32's sinusoid sky at 2048x1024 as BC6H UF16 (mode 11)
     and the ground's decoded samples (kept by phase 32) as BC7 (mode 6),
     each file's bytes and the port's decode held to images.json's
     SHA-256 of the bytes and of PIL's samples; (b) phase 32's file with
     the BC6H DDS as the infinite light's map and the BC7 DDS as the
     ground's imagemap (image_formats_file_text), rendered by the CLI at
     1280x720 spp 1 with the parser's warnings made errors: the parsed
     scene's two maps equal read_image's of the files bit for bit, one
     march launch per loop iteration and no gather or dma launch, the
     frame's march call BCN_CAPTURE_CALL held equal to plain, its mean
     apart from phase 32's uniform-sky frame's, the 32x24 version on the
     card and the CPU within SURF_MEAN_TOL; (c) one decode each, host
     seconds printed, of the sky as BC1, BC3, BC4, BC5 and BC7 DDS (with
     (a)'s BC6H: each at its PIL hash), and of a palette DDS, a PackBits
     RGB PSD, an LZW BigTIFF (phase 32 (d)'s 8-bit TIFF's strips) and an
     ICO of a 256x256 32-bit bitmap and a 256x256 PNG entry, each equal
     to its written samples; each step's seconds and the frame's peak
     device memory.
 35. JPEG 2000 maps (utils/jpeg2000.py, tier 1 in native/j2k_t1.cpp,
     built by g++ here): (a) the committed fixtures (J2K_SKY: the
     2048x1024 sky as a 9/7 JP2 at rates 80 and 40, RPCL, 512x512 tiles;
     J2K_GROUND: the 1024x512 ground as a 5/3 codestream at rate 20;
     J2K_CROP: a lossless 512x256 crop of the sky) decoded once each,
     held to images.json's SHA-256 of the bytes and of PIL's samples,
     host seconds and us per pixel printed, and the sky and the crop
     decoded once more by the numpy tier 1 (utils/j2k_t1.py), equal,
     seconds printed; (b) phase 32's file with the JP2 as the infinite
     light's map and the codestream as the ground's imagemap, rendered by
     the CLI at 1280x720 spp 1 with the parser's warnings made errors,
     held as phase 34's frame is (maps_frame): the parsed maps equal
     read_image's bit for bit, one march launch per loop iteration and
     no gather or dma launch, the march call BCN_CAPTURE_CALL equal to
     plain, the mean apart from phase 32's uniform-sky frame's, the 32x24
     version on the card and the CPU within SURF_MEAN_TOL.  The frame is
     kept for phase 36.
 36. more image writers (utils/gif_write.py, utils/jpeg2000_write.py with
     the C++ tier-1 encoder built by g++ here, utils/webp_write.py with
     the C++ VP8 encoder native/vp8_enc.cpp built by g++ here,
     utils/resample.py, the EPS, PDF, ICO and ICNS encoders of
     utils/image_write.py and the ICNS reader of utils/image_read.py): (a)
     phase 35's frame (1280x720, rendered on the card; no kernel here)
     through the port's `imgtool convert --tonemap` to each of
     MORE_WRITER_EXTS (PDF under a fixed clock), each file write_png's
     encoding: the .jp2 and .j2k read back by read_image and imgtool's
     loader equal to the tonemapped 8-bit frame, the other JPEG 2000
     extensions the .jp2's bytes, the .webp read back by read_image and
     imgtool's loader equal to webp.decode_webp's samples (PIL's decode,
     which the CPU tests hold it to) with its RGB PSNR against the 8-bit
     frame printed, the GIF read back as the palette's colours of
     gif_write.quantize's indices, the ICO's 256x144 entry equal to
     resample.thumbnail's and the ICNS's 1024x1024 one to
     resample.resize's (read_image giving the reference's regrouped
     RGBX), the EPS's hex samples the frame's, the PDF holding
     encode_jpeg's stream; each encode under MORE_WRITER_BAR_S host
     seconds, its bytes and seconds printed; (b) the committed ground
     fixture's first 128x96 pixels written to each extension, held to
     images.json's SHA-256 of PIL's files (PDF at its recorded clock; ICO
     and ICNS by png_hashes_held: each PNG entry's IDAT stream always, the
     file where this host's zlib is PIL's), and the
     ground's crops that images.json's pil_webp_files records (128x96,
     37x23 and the whole 1024x512) written as WebP, each held to PIL's
     file there: its VP8 header's fields, its size within 10%, its PSNR
     (decode_webp) at most 0.5 dB under PIL's and its SHA-256 (the CPU
     tests find the bytes equal).
 37. read formats (utils/image_read_more.py and utils/image_read_pil.py,
     in the side process): each committed fixture of XBM, MSP (v1, v2),
     SPIDER, BLP (BLP1 palette and JPEG, BLP2 palette and DXT1 / DXT3 /
     DXT5), SUN raster and XPM, and of DCX, PIXAR, FTEX (raw, DXT1), GBR
     (v1, v2), XV thumbnail, McIDAS (2- and 4-byte), IMT, FITS (BITPIX 16,
     -32, GZIP_1), IPTC (raw, JPEG) and FLC (BRUN, SS2)
     (tests/data/images/, images.json's entries read by those modules),
     and the eighteen small AVIF crops of scripts/avif_maps.py (RGBA
     with premultiplied alpha, 4:4:4, 4:0:0, limited range, lossless,
     speed 10; CDEF, quantizer matrices, block-level delta q, 4:2:2,
     BT.709, BT.2020 limited range, a 2x2 grid of 64x64 tiles, frame 0 of
     a two-frame sequence; palette, intra block copy (384x96), a binary
     cut-out alpha, film grain; utils/avif.py with the C++ AV1 decoder
     native/av1_dec.cpp built by g++ here) decoded once through image.py's
     _decode_image, held to
     the SHA-256 of its bytes and of PIL's samples (colours for bilevel
     and palette images), its host seconds printed
     (scripts/more_read_formats.py, scripts/pil_only_formats.py and
     scripts/avif_maps.py), as many as images.json records.
 38. PIL-only maps (utils/image_read_pil.py: PhotoCD through PIL's YCC;P
     tables, FTEX through utils/bcn.py's BC1): (a) scripts/
     pil_only_formats.py writes phase 32's sinusoid sky at PhotoCD's
     768x512 (PIL_ONLY_SKY) as a PCD and the ground's decoded samples
     (kept by phase 32) as a 1024x512 FTEX of DXT1 blocks, each file's
     bytes and the port's decode held to images.json's SHA-256 of the
     bytes and of PIL's samples, one decode each, host seconds printed;
     (b) phase 32's file with the PCD as the infinite light's map and the
     FTEX as the ground's imagemap, rendered by the CLI at 1280x720 spp 1
     with the parser's warnings made errors, held as phase 34's frame is
     (maps_frame): the parsed maps equal read_image's bit for bit, one
     march launch per loop iteration and no gather or dma launch, the
     march call BCN_CAPTURE_CALL equal to plain, the mean apart from
     phase 32's uniform-sky frame's, the 32x24 version on the card and
     the CPU within SURF_MEAN_TOL.
 39. AVIF maps (utils/avif.py, the AV1 intra decoder native/av1_dec.cpp
     built by g++ here, its tables from native/av1_tables.h): (a) the
     committed AVIF_SKY (PIL's defaults on the WebP sky's samples: 4x2
     tiles of 128x128 superblocks) and AVIF_GROUND (speed 4 on the WebP
     ground's: self-guided and Wiener restoration) decoded once each,
     held to images.json's SHA-256 of the bytes, the shape and the
     SHA-256 of PIL's samples, host seconds and us per pixel printed,
     the sky under AVIF_SKY_BAR_S; (b) phase 32's file with the sky as
     the infinite light's map and the ground as the ground's imagemap,
     rendered by the CLI at 1280x720 spp 1 with the parser's warnings
     made errors, held as phase 34's frame is (maps_frame): the parsed
     maps equal read_image's bit for bit, one march launch per loop
     iteration and no gather or dma launch, the march call
     BCN_CAPTURE_CALL equal to plain, the mean apart from phase 32's
     uniform-sky frame's, the 32x24 version on the card and the CPU
     within SURF_MEAN_TOL.
 40. AVIF tools maps (avif_maps_phase, as phase 39): (a) the committed
     TOOLS_SKY (a 2x1 grid of 1024x1024 tiles, each PIL's file at
     quality 75, speed 6, with CDEF, quantizer matrices and block-level
     delta q, composed by scripts/avif_maps.py) and TOOLS_GROUND (4:2:2
     with CDEF, its colr matrix BT.709) decoded once each, held to
     images.json's hashes, host seconds and us per pixel printed, the sky
     under AVIF_SKY_BAR_S; (b) phase 32's file with them as the infinite
     light's map and the ground's imagemap, rendered by the CLI at
     1280x720 spp 1 with the parser's warnings made errors, held through
     maps_frame as phase 39's frame is.
 41. AVIF screen and grain maps (avif_maps_phase, as phase 39): (a) the
     committed GRAIN_SKY (PIL's save of the WebP sky's samples with
     denoise-noise-level 20: libaom's noise model as film grain, which
     the decoder applies) and SCREEN_GROUND (PIL's defaults on a 1024x512
     flat-colour checker with labels: allow_screen_content_tools and
     allow_intrabc, palette and intra block copy blocks) decoded once
     each, held to images.json's hashes, host seconds and us per pixel
     printed, the sky under AVIF_SKY_BAR_S; the sky's grain and the
     ground's header bits and palette and intra block copy counts, taken
     from that decode, shown and held to scripts/avif_maps.py's
     TOOLS_ON; (b) phase 32's file with
     them as the infinite light's map and the ground's imagemap, rendered
     by the CLI at 1280x720 spp 1 with the parser's warnings made errors,
     held through maps_frame as phase 39's frame is.
Each phase prints its seconds.  The last two lines are the kernels' JSON
record (with each kernel's bound: bytes read once plus written once over
3.35 TB/s, against operations over 67 TFLOP/s float32; the device times
of the kernel and of its library call; the march kernel's times at its
main-path shapes (the N 262144 ones under `wave_`, the N 65536 ones under
`chunk65536_` beside the render() launches of phases 16 and 17, the
residual instance's under `residual_`, at phase 18's captured call's
lane count `residual_lanes` beside its launches there),
beside everything one call launches and the launch floor, and the sky
frames' launches and captured call under `sky_`; the gather's
fog-box launches (regen, and render() under `fog_render_launches`) and its
times at V 1 (under `v1_`, and `v1_n65536_` at n 65536*8); the dma
kernel's cold times, and its launches, which are its runs on the card in
phase 11, beside its wrapper calls; `integrators_launches`, each kernel's
launches in phase 29's full-size legs; `item1_launches`, in phase 30's
legs; `sharding_world1_launches` and `sharding_rank_launches`, each rank's
(regen, wave, gradient) launches in phase 31; `image_formats_launches`,
the march launches of phase 32's three CLI frames, and its captured
call's `image_formats_max_abs_err`; `image_writers_max_abs_err`, phase
33's largest read-back |diff| of a lossless file, no kernel's;
`bcn_maps_launches`, the march launches of phase 34's frame, and its
captured call's `bcn_maps_max_abs_err`; `j2k_maps_launches` and
`j2k_maps_max_abs_err`, the same of phase 35's frame;
`pil_only_maps_launches` and `pil_only_maps_max_abs_err`, the same of
phase 38's frame; `avif_maps_launches` and `avif_maps_max_abs_err`, the
same of phase 39's frame; `avif_tools_maps_launches` and
`avif_tools_maps_max_abs_err`, the same of phase 40's frame;
`avif_screen_grain_maps_launches` and `avif_screen_grain_maps_max_abs_err`,
the same of phase 41's frame;
`more_image_writers_max_abs_err`, phase 36's largest read-back |diff| of
a lossless file, no kernel's) and the result JSON.
"""
import hashlib
import json
import os
import pickle
import shutil
import struct
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path
from unittest import mock

import numpy as np
import torch

# phases 8, 9, 23 and 24 pay for phase 29 (128-139 s on an NVIDIA H100
# 80GB HBM3 at 700 W): the script took 821-825 s there before it; with it
# and phases 8 and 9 at spp 4 and 1, 859 s on one host and 1,069 s on a
# slower one.  Phase 8 cut from 16 to 8 (phase 28), 4 and 2; phase 9 from 2
# to 1 (bench.py's backward leg takes 4); spp is traffic, not width.
# Phase 31 (sharding) is paid for by phase 8: spp 1 at WIDE_LANES lanes
# since then (304 iterations against 2,112 at spp 2 and 16,384 lanes), the
# film phase 31 (a) and (b) hold the sharded renders to
SPP = 1
GRAD_SPP = 1
SMALL = dict(width=32, height=24, spp=4, max_depth=8, grid_res=32)
SMALL_KNOBS = dict(n_lanes=256, k_substeps=8, stochastic_filter=True,
                   accum_spp=True, retire_groups=4, work_stride="auto")
WINDOW_LANES = 208
BENCH_KNOBS = dict(k_substeps=8, stochastic_filter=True, accum_spp=True,
                   work_stride="auto", retire_groups=32, n_lanes=16384)
GRAD_SMALL = dict(width=16, height=12, spp=2, max_depth=4, grid_res=16)
GRAD_SMALL_KW = dict(fixed_steps=96, spp=2, accum_spp=True, retire_groups=2,
                     k_substeps=8, stochastic_filter=True, remat_window=16,
                     work_stride="auto")
WAVE_LANES = (256, 200)          # fused and window route of the 32x24 cloud
WAVE_GRAD_KW = dict(fixed_steps=96, spp=1)     # phase 13, cut from spp 2
DMA_CHUNKS = (16, 100, 1000, 16384)
MARCH_RAGGED = (1, 31, 127, 129, 16383, 16385)
# phases 15-18: spp cut (spp is traffic, not width) to keep the script
# within ~800 s on a slow host; phases 16 and 17's render() halved again
# (from 32 and 16) with phase 8's cut to pay for phase 31 and phase 9's
# longer loop.  Phase 15's stays: phase 29 holds the MLT fog box to it
FOG_SPP, FOG_REGEN_SPP = 32, 8            # phase 15
EMISSIVE_SPP, EMISSIVE_REGEN_SPP = 16, 8   # phase 16
EXPLOSION_SPP, EXPLOSION_REGEN_SPP = 8, 4  # phase 17
RESIDUAL_SPP = 1                           # phase 18, cut from spp 2
# phase 19.  retire_every needs retire_groups coprime with it: a retire
# group whose index the ticks n % retire_every == retire_every - 1 never
# reach would never splat, in the reference as here
KNOB_CASES = (dict(event_groups=2),
              dict(accum_spp=False, retire_every=2, retire_groups=1),
              dict(accum_spp=False))
# phases 20-22
TRACK_RAYS = 4096
GRAPH_SPP = 16
# phases 23-24: surfaces.  Phase 24's room cut from spp 4 to 1 (spp is
# traffic, not width) to make room for phases 25-27's 122-159 s: with it at
# spp 2 the script took 902 s on an H100 host, over 1,050 s projected on a
# slow one (limit 1200 s).  Phase 23's regen at spp 1 since phase 29 came
# (1,904 iterations against spp 2's 2,048: the tail sets the count), and
# phase 24's 32x24 frames on the GPU and the CPU at ROOM_SMALL_SPP 2 (was 4)
SURF_REGEN_SPP = 1
# phases 18, 23 and 25 run phase 8's scene and its variants (residual
# shadow, surfaces, the sky map) by regen at WIDE_LANES lanes (phase 8
# too since phase 31), phase 9's gradient at bench.py's 16,384: with all
# at 16,384 the whole script
# took 1,198.7 s on one NVIDIA H100 80GB HBM3 host at 700 W (limit 1200
# s).  A regen loop's iterations grow with the pixels over the lanes
# (1,904-2,112 at 1280x720 and 16,384 lanes) and not with max_depth (a
# CPU check on a 160x90 cloud: 240 iterations at depth 16, 8 and 4), and
# an iteration's time is host bound, so the lanes are what these legs can
# give without cutting the frame or its noise (a regen frame's pixels are
# equal at any lane count: each pixel draws from its own streams).  Cutting
# spp instead would not have paid: at spp 1 the tail sets the count.  The
# march calls these legs launch are N WIDE_LANES, so each leg holds one of
# its own captured calls to plain (phase 18 also times and bounds it)
WIDE_LANES = 131072
WIDE_KNOBS = dict(BENCH_KNOBS, n_lanes=WIDE_LANES)
ROOM_SMALL_SPP = 2
# the 32x24 cloud with surfaces, GPU against CPU: means to 1e-2, not phase
# 5's 1e-3.  The card and the CPU reroute 0.2% of its samples (6 of 3,072
# camera samples in a wave-mode diagnostic, each at a branch whose
# threshold the two devices' roundings straddle), and a rerouted sample
# through the glass or off the ground moves the 3,072-sample mean by up
# to 1e-3 alone; pixels keep phase 5's rule
SURF_MEAN_TOL = 1e-2
SURF_CAPTURE_CALL = 150          # the regen frame's march call held to plain
RESIDUAL_CAPTURE_CALL = 150      # phase 18's, the residual instance
ROOM_SPP = 1
ROOM_VOLPATH_TOL = 0.02
# phases 25-27: the samplers, the image lights and the render entries
SKY_RES = 512                    # the sky map: 512^2 equal-area, 512x1024
SKY_SPP = 1
SKY_CAPTURE_CALL = 150
SKY_SAMPLE_INDICES = (0, 1, 1023)
PORTAL_POINTS = 262144
FULL = (1280, 720)               # the room's and the G-buffers' frame
# two full-width frames of one image by other samplers, spp or entries:
# means within 2%, as phase 14 holds render() to regen
FULL_MEAN_TOL = 0.02
# nanovdb2pbrt prints six decimals: a parsed value is within half a unit of
# the sixth decimal of the grid's, plus its own float32 rounding
GRID_TEXT_TOL = 5e-7 + float(np.finfo(np.float32).eps) / 2
# phase 29: the other integrators.  render_bdpt's own default depth, cut
# from the preset's 16 (a depth cut: BDPT's strategies grow as
# max_depth^2 / 2, each a host-looped ratio track)
BDPT_DEPTH = 4
# BDPT's gate (tests/test_bdpt.py:113, within 12% of render()) fails on the
# cloud: the reference's BDPT connects to the distant light only, and the
# preset's uniform sky, which render() adds, is absent from its frame (88.5%
# under render()'s mean at 1280x720).  The JAX package shows the same gap
# on the CPU at BDPT_SMALL (`python scripts/bdpt_cloud_gate.py 64x36`: BDPT
# 0.003141 against render()'s 0.030440, rel diff 0.8968; ROADMAP Queue 3),
# and the port's frame of that size is held to its mean
BDPT_SMALL = (64, 36)
BDPT_SMALL_GRID = 32
BDPT_JAX_MEAN = 0.003141
SPPM_ITERATIONS = 2
# SPPM's gate (tests/test_sppm.py:73) fails on the 1280x720 room: at H*W
# photons the initial radius puts thousands of visible points in a photon's
# cell run, the scan is capped at 64 (render_sppm's default), the photons
# deposit a fraction of their flux and the mean falls ~16% short.  The
# reference's code does the same (ROADMAP Queue 3); at SPPM_SMALL the JAX
# package passes the gate on the CPU (`python scripts/sppm_room_gate.py
# 160x90`: SPPM 0.247027 against path's 0.238606, |diff| 8.42e-3 < 2.19e-2,
# 1,593 truncated candidates), and the port is held to its mean
SPPM_SMALL = (160, 90)
SPPM_JAX_MEAN = 0.247027
MLT_CHAINS, MLT_MUTATIONS, MLT_BOOTSTRAP = 131072, 8, 65536   # 1,048,576
MLT_VOL_CHAINS, MLT_VOL_MUTATIONS = 65536, 32     # 32 per fog-box pixel
MLT_BLOCK = 32
# the four on the GPU against the CPU at 32x24: means to 1e-2 and 95% of
# pixels to rtol 1e-3 / atol 1e-5, not phase 5's 1e-3 and 99%.  A splat
# or a photon lands in a pixel of its own: an ulp that moves one across a
# pixel edge, or reroutes a lobe or a collision (0.2% of samples in phase
# 23), moves whole splats between pixels, and a 32x24 frame holds few
INTEG_MEAN_TOL = 1e-2
INTEG_PIXEL_SHARE = 0.95
LUM = np.array([0.2126, 0.7152, 0.0722])
# frames later phases compare with: phase 15's fog-box render() frame and
# phase 24's path frame of the room
FRAMES = {}
HBM_BYTES_PER_MS = 3.35e9        # H100 SXM device memory, 3.35 TB/s
F32_OPS_PER_MS = 67e9            # H100 SXM float32 outside the tensor cores


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def to_dev(lanes, dev):
    return {k: torch.as_tensor(v, device=dev) for k, v in lanes.items()}


def compare_march(a, b):
    """Equal integers / flags, floats to rtol 1e-6; returns max |a - b|."""
    err = 0.0
    for k in a:
        x, y = a[k].cpu().numpy(), b[k].cpu().numpy()
        if x.dtype.kind in "biu":
            if not np.array_equal(x, y):
                raise AssertionError(f"march {k}: {int((x != y).sum())} "
                                     "lanes differ")
            continue
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=0, err_msg=k)
        fin = np.isfinite(x) & np.isfinite(y)
        if fin.any():
            err = max(err, float(np.abs(x[fin] - y[fin]).max()))
    return err


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_us(fn, reps, name=None):
    """Device time per call (us) of the kernels fn() launches, by
    torch.profiler (as scripts/profile_port.py takes it): every kernel, or
    only those whose name holds `name`.  Late in a long process the
    profiler has recorded fewer launches than were made (none of 200, or
    185 of 200 twice running): a short window is profiled again, up to
    three windows, each opened by a synchronize and a 20 ms pause.  With
    no complete window the time is the mean per launch of those recorded
    in the fullest one, and a line says so; a window recording none
    raises, so no time is ever 0."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(0.02)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        run = [(e.count, e.self_device_time_total) for e in prof.key_averages()
               if e.self_device_time_total > 0
               and (name is None or name in e.key)]
        seen = sum(c for c, _ in run)
        if seen >= reps:
            return sum(t for _, t in run) / reps
        if run and (best is None or seen > best[0]):
            best = (seen, run)
    what = name or "any kernel"
    if best is None:
        raise RuntimeError(f"torch.profiler recorded no launch of {what} "
                           f"in three windows of {reps} calls")
    print(f"torch.profiler recorded at most {best[0]} launches of {what} "
          f"in three windows of {reps} calls: the time is the mean of "
          "those recorded", flush=True)
    return sum(t / c * max(1, round(c / reps)) for c, t in best[1])


def cold_ms(fn, reps, flush):
    """Median ms of fn() timed by its own pair of CUDA events, each call
    after flush() has rewritten a buffer larger than the 50 MB L2 (the
    flush runs longer than the host takes to enqueue fn, so the first
    event does not wait on the host)."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate."""
    b, o = n_bytes / HBM_BYTES_PER_MS, n_ops / F32_OPS_PER_MS
    return (b, "bytes") if b >= o else (o, "operations")


def check_march_layout(out, ref):
    """The kernel's outputs have the plain version's keys, dtypes, shapes and
    a contiguous layout."""
    if list(out) != list(ref):
        raise AssertionError(f"march outputs {list(out)}, plain {list(ref)}")
    for k in ref:
        a, b = out[k], ref[k]
        if (a.dtype, a.shape) != (b.dtype, b.shape) or not a.is_contiguous():
            raise AssertionError(f"march {k}: {a.dtype} {tuple(a.shape)} "
                                 f"contiguous {a.is_contiguous()}, plain "
                                 f"{b.dtype} {tuple(b.shape)}")


def phase_kernel(dev):
    """Phase 3.  Uses only what every tree's ops/march.py has (march_block,
    march_block_plain, random_lanes), so that scripts/alternate_kernel_phases.py
    can run it on an older tree too."""
    from acceleratedvolrenderer_tpu_torch.ops import march

    max_err = 0.0
    cases = 0
    grid = [(n, res, residual, K) for n in (16384, 1000)
            for res in ((16, 16, 16), (32, 32, 32), (64, 64, 64))
            for residual in (False, True) for K in (1, 8, 16)]
    # the wave path's chunks: 262144 lanes, K 8 over the 16^3 majorant, and
    # 65536, render()'s one chunk of a 256x256 frame (phases 16 and 17)
    grid += [(262144, (16, 16, 16), residual, 8) for residual in (False, True)]
    grid.append((65536, (16, 16, 16), False, 8))
    # lane counts around the block size: the kernel's masked last block
    grid += [(n, (16, 16, 16), residual, 8) for n in MARCH_RAGGED
             for residual in (False, True)]
    for n, res, residual, K in grid:
        lanes = to_dev(march.random_lanes(n, res, seed=n + res[0],
                                          residual=residual), dev)
        out = march.march_block(K=K, maj_res=res, **lanes)
        ref = march.march_block_plain(K=K, maj_res=res, **lanes)
        torch.cuda.synchronize()
        check_march_layout(out, ref)
        max_err = max(max_err, compare_march(out, ref))
        cases += 1
    name = "march_kernel"                  # the kernel alone, by its name
    scratch = torch.empty(64 * 2 ** 20, device=dev)     # 256 MB > L2
    flush = scratch.zero_
    rec, lines = {}, []
    for n, key in ((16384, ""), (65536, "chunk65536_"), (262144, "wave_")):
        lanes = to_dev(march.random_lanes(n, (16, 16, 16), seed=7), dev)
        kw = dict(K=8, maj_res=(16, 16, 16), **lanes)
        call = lambda: march.march_block(**kw)
        ms = time_ms(call, 200)
        warm_us = device_us(call, 200, name)
        call_us = device_us(call, 200)        # everything one call launches
        cold_us = device_us(lambda: (flush(), call()), 200, name)
        # bytes: the inputs (table and lane registers) and the outputs once;
        # operations: about 30 float32 operations per voxel step of a
        # hunting lane (DDA advance, majorant product, target test)
        b = bound(nbytes(*lanes.values()) + nbytes(*call().values()),
                  30 * 8 * int(lanes["hunting"].sum()))
        rec.update({f"{key}ms": ms, f"{key}device_us": warm_us,
                    f"{key}call_device_us": call_us,
                    f"{key}cold_device_us": cold_us, f"{key}bound_ms": b[0],
                    f"{key}bound_by": b[1]})
        lines.append(f"N {n}: wrapper {ms:.4f} ms, kernel alone {warm_us:.2f} "
                     f"us warm / {cold_us:.2f} us cold, all kernels of a call "
                     f"{call_us:.2f} us, bound {b[0]:.6f} ms ({b[1]}, "
                     f"{100 * b[0] * 1e3 / cold_us:.1f}% of cold)")
        if key == "":
            plain_ms = time_ms(lambda: march.march_block_plain(**kw), 20)
    # the launch floor: a one-element zero_, taken the same way; and a
    # one-element neg_ after the flush: the floor plus one round trip to
    # device memory
    one = torch.zeros(1, device=dev)
    floor_us = device_us(one.zero_, 200)
    trip_us = device_us(lambda: (flush(), one.neg_()), 200, "neg_kernel")
    print(f"kernel vs plain: {cases} cases equal (N 16384 / 1000, 65536, "
          f"262144 and {MARCH_RAGGED}), outputs of the plain version's dtypes, shapes "
          f"and contiguous, max |err| {max_err:.3e}; K 8 16^3: "
          + "; ".join(lines) + f"; plain {plain_ms:.4f} ms at N 16384; "
          f"launch floor {floor_us:.2f} us (one-element zero_), with one "
          f"round trip {trip_us:.2f} us (one-element neg_ after a flush)",
          flush=True)
    return dict(max_abs_err=max_err, plain_ms=plain_ms, library_ms=None,
                library_device_us=None, launch_floor_us=floor_us,
                launch_trip_us=trip_us, **rec)


def phase_gather(dev):
    from acceleratedvolrenderer_tpu_torch.ops import gather, march

    cases, err = 0, 0.0
    grid = [(v, n, 0) for v in (128, 1000, 4096, 32768, 64 ** 3)
            for n in (100, 96 * 8, 208 * 8, 1000 * 8, 16384 * 8)]
    # idx views 1-3 elements past a 16-byte boundary, and the tails of n
    # 1 .. 9 (the kernel's scalar head and tail around its 16-byte body)
    grid += [(4096, n, off) for off in (0, 1, 2, 3)
             for n in (*range(1, 10), 16384 * 8 + 5)]
    for v, n, off in grid:
        rng = np.random.default_rng(v + n + off)
        table = torch.as_tensor(
            rng.uniform(0.0, 2.0, v).astype(np.float32), device=dev)
        idx = rng.integers(0, v, n + off).astype(np.int32)
        idx[off:off + 3] = [-1, v, v + 77][:min(3, n)]
        idx = torch.as_tensor(idx, device=dev)[off:]
        if n % 8 == 0:
            idx = idx.view(-1, 8)
        before = gather.launches
        out = gather.table_gather(table, idx)
        ref = gather.table_gather_plain(table, idx)
        torch.cuda.synchronize()
        if gather.launches != before + 1 or not torch.equal(out, ref):
            raise AssertionError(f"gather V {v} n {n} offset {off}: kernel "
                                 "and plain disagree or the kernel did not "
                                 "launch")
        err = max(err, float((out - ref).abs().max()))
        cases += 1
    rng = np.random.default_rng(0)
    table = torch.as_tensor(rng.uniform(0.0, 2.0, 4096).astype(np.float32),
                            device=dev)
    idx = torch.as_tensor(rng.integers(0, 4096, (16384, 8)).astype(np.int32),
                          device=dev)
    # yardstick: the one PyTorch call that computes the same gather on
    # these in-range indices; timed in turns with the kernel
    kernel = lambda: gather.table_gather(table, idx)
    library = lambda: table[idx]
    lib_ms = [time_ms(library, 200)]
    ms = [time_ms(kernel, 200), time_ms(kernel, 200)]
    lib_ms.append(time_ms(library, 200))
    dev_us = device_us(kernel, 200)
    lib_us = device_us(library, 200)
    plain_ms = time_ms(lambda: gather.table_gather_plain(table, idx), 200)
    b = bound(nbytes(table, idx) + 4 * idx.numel(), 0)   # + the output
    win_err = 0.0
    for n in (1000, WINDOW_LANES, 16384):
        lanes = to_dev(march.random_lanes(n, (16, 16, 16), seed=n), dev)
        kw = dict(K=8, maj_res=(16, 16, 16), **lanes)
        before = (march.launches, gather.launches)
        out = march.march_window(**kw)
        if (march.launches, gather.launches) != (before[0], before[1] + 1):
            raise AssertionError(f"window route N {n}: the gather kernel "
                                 "must launch once and the march kernel "
                                 "never")
        win_err = max(win_err, compare_march(out,
                                             march.march_block_plain(**kw)))
    print(f"gather vs plain: {cases} cases bitwise equal (idx views at "
          f"offsets 0-3, n 1-9 tails); n 16384*8 V 4096, in turns: table[idx] "
          f"{lib_ms[0]:.4f} ms, kernel {ms[0]:.4f} / {ms[1]:.4f} ms, "
          f"table[idx] {lib_ms[1]:.4f} ms; device {dev_us:.2f} us, table[idx] "
          f"{lib_us:.2f} us; plain {plain_ms:.4f} ms, bound {b[0]:.6f} ms "
          f"({b[1]}); window route vs plain march (N 1000, {WINDOW_LANES} and "
          f"16384, K 8): equal, one gather launch each, max |err| "
          f"{win_err:.3e}", flush=True)
    return dict(max_abs_err=err, ms=float(np.mean(ms)), plain_ms=plain_ms,
                bound_ms=b[0], bound_by=b[1],
                library_ms=float(np.mean(lib_ms)), device_us=dev_us,
                library_device_us=lib_us)


def compare_frames(what, a, b, mean_tol=1e-3):
    """Frame means to mean_tol relative (1e-3, see phase 5) and >= 99% of
    pixels to rtol 1e-3 / atol 1e-5."""
    rel = abs(a.mean() - b.mean()) / b.mean()
    close = np.isclose(a, b, rtol=1e-3, atol=1e-5).all(-1).mean()
    print(f"{what}: mean {a.mean():.7f} vs {b.mean():.7f} (rel diff "
          f"{rel:.3e}), max |diff| {np.abs(a - b).max():.3e}, pixels close "
          f"{close:.4f}", flush=True)
    if not (rel < mean_tol and close >= 0.99):
        raise AssertionError(f"{what}: frames disagree")


def phase_small_frame(dev):
    from acceleratedvolrenderer_tpu_torch.ops import march
    from acceleratedvolrenderer_tpu_torch.parallel import render
    from acceleratedvolrenderer_tpu_torch.scene import presets

    imgs, runs = [], []
    for d in (dev, torch.device("cpu")):
        scene = presets.cloud(**SMALL, device=d)
        before = march.launches
        img, st = render.render_regen(scene, device=d, **SMALL_KNOBS)
        imgs.append(img)
        runs.append((st["iterations"], march.launches - before))
    gpu, cpu = imgs
    if gpu.shape != (24, 32, 3) or not np.isfinite(gpu).all():
        raise AssertionError("small frame: bad shape or non-finite pixels")
    print(f"small frame: (iterations, launches) gpu {runs[0]} cpu "
          f"{runs[1]}", flush=True)
    if runs[0][1] != runs[0][0] or runs[1][1] != 0:
        raise AssertionError(f"small frame: (iterations, launches) {runs}")
    compare_frames("small frame gpu vs cpu", gpu, cpu)
    return gpu


def phase_window_frame(dev, fused_gpu):
    from acceleratedvolrenderer_tpu_torch.ops import gather, march
    from acceleratedvolrenderer_tpu_torch.parallel import render
    from acceleratedvolrenderer_tpu_torch.scene import presets

    knobs = dict(SMALL_KNOBS, n_lanes=WINDOW_LANES)
    march.launches = gather.launches = 0
    img, st = render.render_regen(presets.cloud(**SMALL, device=dev),
                                  device=dev, **knobs)
    counts = (march.launches, gather.launches)
    cpu, _ = render.render_regen(
        presets.cloud(**SMALL, device=torch.device("cpu")),
        device=torch.device("cpu"), **knobs)
    print(f"window frame ({WINDOW_LANES} lanes): {st['iterations']} "
          f"iterations, (march, gather) launches {counts}", flush=True)
    if img.shape != (24, 32, 3) or not np.isfinite(img).all():
        raise AssertionError("window frame: bad shape or non-finite pixels")
    if counts != (0, st["iterations"]):
        raise AssertionError("window frame: the gather kernel must launch "
                             "once per iteration and the march kernel never")
    compare_frames("window frame gpu vs cpu", img, cpu)
    compare_frames("window frame vs fused frame (256 lanes, gpu)", img,
                   fused_gpu)
    scene = presets.cloud(**SMALL, device=dev)
    ms = {"window": [], "fused": []}
    for route in ("window", "fused", "window", "fused"):
        with mock.patch.object(march, "available",
                               lambda v, n: route == "fused"):
            march.launches = gather.launches = 0
            img_r, st_r = render.render_regen(scene, device=dev, **knobs)
        it = st_r["iterations"]
        want = (0, it) if route == "window" else (it, 0)
        if (march.launches, gather.launches) != want:
            raise AssertionError(f"{route} route at {WINDOW_LANES} lanes: "
                                 f"(march, gather) launches "
                                 f"{(march.launches, gather.launches)}")
        compare_frames(f"{route} route at {WINDOW_LANES} lanes vs window "
                       "frame", img_r, img)
        ms[route].append(st_r["render_time"] * 1e3 / it)
    print(f"routes at {WINDOW_LANES} lanes (equal frames; host ms per "
          f"iteration, alternated): window {ms['window']}, fused "
          f"{ms['fused']}", flush=True)
    return counts[1]


def phase_grad_fd(dev):
    from acceleratedvolrenderer_tpu_torch.ops import gather, march
    from acceleratedvolrenderer_tpu_torch.parallel import diff
    from acceleratedvolrenderer_tpu_torch.scene import presets

    eps = 2e-3
    steps = GRAD_SMALL_KW["fixed_steps"]
    for n_lanes, route in ((96, "window"), (128, "fused")):
        scene = presets.cloud(**GRAD_SMALL, device=dev)
        loss_fn, grad_fn = diff.make_diff_regen_renderer(
            scene, device=dev, n_lanes=n_lanes, **GRAD_SMALL_KW)
        dens = scene.medium.density
        march.launches = gather.launches = 0
        g = grad_fn(dens)
        counts = (march.launches, gather.launches)
        want = (0, 2 * steps) if route == "window" else (2 * steps, 0)
        if counts != want:
            raise AssertionError(f"grad fd {route}: (march, gather) "
                                 f"launches {counts}, expected {want}")
        g = g.cpu().numpy()
        if not (np.isfinite(g).all() and np.abs(g).max() > 0):
            raise AssertionError(f"grad fd {route}: gradient not finite or "
                                 "identically zero")
        rows = []
        for fi in np.argsort(np.abs(g).reshape(-1))[::-1][:3]:
            e = torch.zeros(dens.numel(), device=dev)
            e[int(fi)] = eps
            e = e.reshape(dens.shape)
            with torch.no_grad():
                fd = (float(loss_fn(dens + e))
                      - float(loss_fn(dens - e))) / (2 * eps)
            ad = float(g.reshape(-1)[fi])
            rows.append(f"voxel {int(fi)} fd {fd:.6e} ad {ad:.6e}")
            if abs(fd - ad) > 1e-2 * max(abs(fd), abs(ad), 1e-3):
                raise AssertionError(f"grad fd {route}: {rows[-1]}")
        print(f"grad fd == ad ({route} route, {n_lanes} lanes, (march, "
              f"gather) launches {counts}): " + "; ".join(rows), flush=True)


def phase_slice(dev, card):
    from acceleratedvolrenderer_tpu_torch.ops import march
    from acceleratedvolrenderer_tpu_torch.parallel import render
    from acceleratedvolrenderer_tpu_torch.scene import presets

    t0 = time.time()
    scene = presets.cloud(1280, 720, spp=SPP, max_depth=16, grid_res=256,
                          device=dev)
    scene.max_march_steps = 4096
    print(f"scene built in {time.time() - t0:.1f} s", flush=True)
    march.launches = 0
    img, st = render.render_regen(scene, device=dev, record_alive=True,
                                  **WIDE_KNOBS)
    FRAMES[("cloud", "regen")] = img
    launches = march.launches
    if img.shape != (720, 1280, 3) or not np.isfinite(img).all():
        raise AssertionError("slice: bad shape or non-finite film")
    if not img.mean() > 0:
        raise AssertionError("slice: film mean is not positive")
    if not (st["iterations"] > 0 and launches == st["iterations"]):
        raise AssertionError(f"slice: {launches} march launches for "
                             f"{st['iterations']} loop iterations")
    mrays = 1280 * 720 * SPP / st["render_time"] / 1e6
    print(f"slice 1280x720 spp {SPP} grid 256^3 lanes {WIDE_LANES}: "
          f"{st['iterations']} iterations, occupancy {st['occupancy']:.4f}, "
          f"{st['render_time']:.3f} s, {mrays:.4f} Mrays/s, film mean "
          f"{img.mean():.6f} on {card}", flush=True)
    return launches, scene, (float(img.mean()), st["render_time"], mrays)


def phase_grad_full(dev, scene, card):
    from acceleratedvolrenderer_tpu_torch.ops import gather, march
    from acceleratedvolrenderer_tpu_torch.parallel import diff

    H, W = scene.height, scene.width
    groups = min(32, 2 * GRAD_SPP)
    knobs = dict(n_lanes=16384, k_substeps=8, stochastic_filter=True,
                 accum_spp=True, retire_groups=groups, work_stride="auto")
    steps, iters = diff.size_fixed_steps(scene, device=dev, spp=GRAD_SPP,
                                         **knobs)
    density = torch.as_tensor(scene.medium.density, dtype=torch.float32,
                              device=dev)
    window = max(int(np.sqrt(steps)), 16)
    n_win = -(-steps // window)
    loss_fn, grad_fn = diff.make_diff_regen_renderer(
        scene, device=dev, fixed_steps=steps, spp=GRAD_SPP,
        remat_window=window, **knobs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    march.launches = gather.launches = 0
    t0 = time.time()
    g = grad_fn(density)
    torch.cuda.synchronize()
    dt = time.time() - t0
    counts = (march.launches, gather.launches)
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        loss = float(loss_fn(density))
    g_max = float(g.abs().max())
    mrays = H * W * GRAD_SPP / dt / 1e6
    print(f"grad full frame {W}x{H} spp {GRAD_SPP} grid 256^3 lanes 16384 "
          f"groups {groups}: forward {iters} live iterations, fixed_steps "
          f"{steps}, remat_window {window} ({n_win} windows), grad step "
          f"{dt:.3f} s, {mrays:.4f} Mrays/s (grad_density), peak device "
          f"memory {peak / 2**30:.3f} GiB, loss {loss:.6e}, max |grad| "
          f"{g_max:.4e}, (march, gather) launches {counts} on {card}",
          flush=True)
    if not (np.isfinite(loss) and loss > 0):
        raise AssertionError("grad full frame: loss not finite and positive")
    if not (bool(torch.isfinite(g).all()) and g_max > 0):
        raise AssertionError("grad full frame: gradient not finite or zero")
    if counts != (2 * n_win * window, 0):
        raise AssertionError(f"grad full frame: (march, gather) launches "
                             f"{counts}, expected ({2 * n_win * window}, 0)")
    FRAMES[("cloud", "grad")] = dict(grad=g.cpu().numpy(), loss=loss,
                                     knobs=knobs)
    return counts[0]


def phase_dma(dev):
    from acceleratedvolrenderer_tpu_torch.ops import dma_gather as dma

    v = 256 ** 3
    n_tiles = v // dma.TILE_ELEMS
    table = torch.rand(v, generator=torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    cases = [(c, np.random.default_rng(c).integers(0, n_tiles, c))
             for c in DMA_CHUNKS]
    oob = np.random.default_rng(5).integers(-40, n_tiles + 40, 1000)
    oob[dma.last_slot0(1000)] = n_tiles + 3        # slot 0 ends as zeros
    cases.append(("1000 out of range", oob))
    # slices of one block and of 16 ids per block; repeated ids
    cases += [(c, np.random.default_rng(c).integers(0, n_tiles, c))
              for c in (1, 17, 132 * 16, 65536)]
    cases.append(("4096 repeated", np.repeat(
        np.random.default_rng(6).integers(0, n_tiles, 64), 64)))
    for what, ids in cases:
        idx = torch.as_tensor(ids.astype(np.int32), device=dev)
        before = dma.launches
        out = dma.dma_gather(table, idx)
        ref = dma.dma_gather_plain(table, idx)
        torch.cuda.synchronize()
        if dma.launches != before + 1 or not torch.equal(out, ref):
            raise AssertionError(f"dma chunk {what}: kernel and plain "
                                 "disagree or the kernel did not launch")
        if what == "1000 out of range" and bool(out.any()):
            raise AssertionError("dma: an out-of-range last id must give "
                                 "zeros")
    idx16k = torch.as_tensor(cases[3][1].astype(np.int32), device=dev)
    idx16 = torch.as_tensor(cases[0][1].astype(np.int32), device=dev)
    name = "dma_gather_kernel"
    scratch = torch.empty(64 * 2 ** 20, device=dev)     # 256 MB > L2
    flush = scratch.zero_
    kernel = lambda: dma.dma_gather(table, idx16k)
    cold = lambda: (flush(), kernel())
    ms = time_ms(kernel, 200)
    warm_us = device_us(kernel, 200, name)
    c_ms = cold_ms(kernel, 200, flush)
    cold_us = device_us(cold, 200, name)
    small = lambda: dma.dma_gather(table, idx16)
    small_us = device_us(small, 200, name)
    small_cold_us = device_us(lambda: (flush(), small()), 200, name)
    # cold after a flush that reads the buffer: the L2 then holds clean
    # lines, and the kernel's misses write nothing back
    read_cold_us = device_us(lambda: (scratch.amax(), kernel()), 200, name)
    plain_ms = time_ms(lambda: dma.dma_gather_plain(table, idx16k), 200)
    # yardstick: the one PyTorch call that returns the output tile; it does
    # none of the design's 16384 fetches, which are what the kernel measures
    t3, j = table.view(-1, *dma.TILE), dma.last_slot0(idx16k.shape[0])
    library = lambda: t3[idx16k[j]]
    library_ms = time_ms(library, 200)
    lib_us = device_us(library, 200)
    # bytes: every distinct tile fetched once, the ids and the output tile;
    # beside it, the output alone: one id read, one tile read and written
    distinct = int(torch.unique(idx16k).numel())
    b = bound(distinct * 4 * dma.TILE_ELEMS + nbytes(idx16k) + 4 * 1024, 0)
    b16 = bound(int(torch.unique(idx16).numel()) * 4 * dma.TILE_ELEMS
                + nbytes(idx16) + 4 * 1024, 0)
    b_out = bound(4 + 2 * 4 * 1024, 0)
    print(f"dma kernel vs plain: {len(cases)} cases bitwise equal (chunks "
          f"{DMA_CHUNKS}, 1, 17, {132 * 16}, 65536, 1000 with out-of-range "
          f"ids, 4096 repeated ids), one launch each; chunk 16384 over 256^3 "
          f"({distinct} distinct tiles): kernel {ms:.4f} ms per call, device "
          f"warm {warm_us:.2f} us, cold {cold_us:.2f} us (per-launch events "
          f"cold {c_ms:.4f} ms; cold after a read-only flush "
          f"{read_cold_us:.2f} us); chunk 16: device warm {small_us:.2f} us, "
          f"cold {small_cold_us:.2f} us, bound {b16[0] * 1e3:.4f} us; plain "
          f"{plain_ms:.4f} ms, t3[tile_idx[j*]] {library_ms:.4f} ms (device "
          f"{lib_us:.2f} us), bound of the fetches {b[0]:.6f} ms ({b[1]}), "
          f"of the output alone {b_out[0]:.6f} ms", flush=True)
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b[0],
                bound_by=b[1], library_ms=library_ms,
                bound_output_ms=b_out[0], device_us=warm_us,
                library_device_us=lib_us, cold_ms=c_ms,
                cold_device_us=cold_us)


def phase_gather_designs(dev):
    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
    import measure_gather_designs_torch as designs
    from acceleratedvolrenderer_tpu_torch.ops import dma_gather as dma

    iters = 200
    dma.launches = 0
    out = designs.measure(16384, iters, device=dev)
    calls, runs = dma.launches, out["dma_kernel_runs"]
    print(f"gather designs (N 16384, {iters} dependent steps, 256^3 table, "
          f"best of {designs.REPLAYS} CUDA-graph replays): baseline "
          f"table[idx] {out['xla_gather_ns_per_el']:.4f} ns/element, tile "
          f"DMA {out['dma_tile_ns_per_el']:.4f}, argsort bound "
          f"{out['argsort_ns_per_el']:.4f}; dma wrapper calls {calls}, "
          f"kernel runs {runs}", flush=True)
    if (calls, out["dma_wrapper_calls"], runs) != (
            1 + iters, 1 + iters, 1 + designs.REPLAYS * iters):
        raise AssertionError(f"gather designs: dma wrapper calls {calls}, "
                             f"kernel runs {runs}, expected {1 + iters} and "
                             f"{1 + designs.REPLAYS * iters}")
    return runs, calls


def wave_frame(scene, rays_per_wave, dev):
    """render()'s loop at a chosen chunk size: make_wave_renderer and a
    Film over scene.spp waves; ((H, W, 3) numpy image, loop iterations)."""
    from acceleratedvolrenderer_tpu_torch.models.film import Film
    from acceleratedvolrenderer_tpu_torch.parallel import render

    render_wave, density, majorant = render.make_wave_renderer(
        scene, rays_per_wave=rays_per_wave, device=dev)
    film, iterations = Film.create(scene.height, scene.width, dev), 0
    for s in range(scene.spp):
        film, its = render_wave(film, density, majorant, s)
        iterations += sum(its)
    return film.to_image().cpu().numpy(), iterations


def phase_wave_small(dev):
    from acceleratedvolrenderer_tpu_torch.ops import gather, march
    from acceleratedvolrenderer_tpu_torch.scene import presets

    for lanes, route in zip(WAVE_LANES, ("fused", "window")):
        imgs = []
        for d in (dev, torch.device("cpu")):
            march.launches = gather.launches = 0
            img, it = wave_frame(presets.cloud(**SMALL, device=d), lanes, d)
            counts = (march.launches, gather.launches)
            if d.type != "cuda":
                want = (0, 0)                 # the CPU launches nothing
            else:
                want = (it, 0) if route == "fused" else (0, it)
            if counts != want:
                raise AssertionError(f"wave {route} on {d}: (march, gather) "
                                     f"launches {counts}, expected {want}")
            imgs.append((img, it))
        gpu, cpu = imgs[0][0], imgs[1][0]
        if gpu.shape != (24, 32, 3) or not np.isfinite(gpu).all():
            raise AssertionError("wave small: bad shape or non-finite pixels")
        print(f"wave frame ({lanes} rays per chunk, {route} route): "
              f"iterations gpu {imgs[0][1]} cpu {imgs[1][1]}, one "
              f"{'march' if route == 'fused' else 'gather'} launch each on "
              "the gpu", flush=True)
        compare_frames(f"wave frame {route} gpu vs cpu", gpu, cpu)


def diff_small_scene(dev, sigma_a=0.6, sigma_s=0.9, le=1.5, size=6):
    """tests/test_diff.py's small_scene(sigma_a, sigma_s, le), built
    through the port: a random 4^3 density in the unit cube, a 2^3
    majorant, a size x size look_at camera, sun and sky, a box filter."""
    from acceleratedvolrenderer_tpu_torch.models import lights as lm
    from acceleratedvolrenderer_tpu_torch.models.cameras import (
        PerspectiveCamera)
    from acceleratedvolrenderer_tpu_torch.models.film import BoxFilter
    from acceleratedvolrenderer_tpu_torch.models.media import MediumSpec
    from acceleratedvolrenderer_tpu_torch.scene.types import Scene
    from acceleratedvolrenderer_tpu_torch.utils.spectrum import (
        constant_spectrum as flat)
    from acceleratedvolrenderer_tpu_torch.utils.vecmath import look_at

    rng = np.random.default_rng(0)
    dens = (0.5 + 0.5 * rng.random((4, 4, 4))).astype(np.float32)
    med = MediumSpec(sigma_a_spec=flat(sigma_a), sigma_s_spec=flat(sigma_s),
                     g=0.0, scale=1.0,
                     density=torch.as_tensor(dens, device=dev),
                     Le_spec=flat(le) if le else None,
                     majorant_res=(2, 2, 2))
    cam = PerspectiveCamera(
        c2w=look_at((0.5, 0.5, -2.5), (0.5, 0.5, 0.5), (0, 1, 0), dev),
        fov_deg=30.0, width=size, height=size)
    lights = [lm.DistantLight(direction=torch.tensor([0.0, -1.0, 0.0],
                                                     device=dev),
                              spectrum=flat(5.0), scene_radius=10.0),
              lm.UniformInfiniteLight(spectrum=flat(0.3), scene_radius=10.0)]
    return Scene(camera=cam, medium=med, lights=lights, max_depth=3,
                 filter=BoxFilter(), spp=2, scene_radius=10.0)


def wave_cloud16(dev):
    """A 16x16 cloud over a 16^3 grid (256 lanes: the fused route), with
    absorption and emission so that every DIFF_PARAMS family has a
    gradient."""
    import dataclasses

    from acceleratedvolrenderer_tpu_torch.scene import presets
    from acceleratedvolrenderer_tpu_torch.utils.spectrum import (
        constant_spectrum as flat)

    scene = presets.cloud(16, 16, spp=2, max_depth=4, grid_res=16,
                          device=dev)
    scene.medium = dataclasses.replace(scene.medium, sigma_a_spec=flat(0.3),
                                       Le_spec=flat(1.5))
    return scene


def phase_wave_grad_fd(dev):
    from acceleratedvolrenderer_tpu_torch.ops import gather, march
    from acceleratedvolrenderer_tpu_torch.parallel import diff

    steps, spp = WAVE_GRAD_KW["fixed_steps"], WAVE_GRAD_KW["spp"]
    for route, scene in (("window", diff_small_scene(dev)),
                         ("fused", wave_cloud16(dev))):
        loss_fn, grad_fn = diff.make_diff_renderer_multi(
            scene, device=dev, **WAVE_GRAD_KW)
        dens = scene.medium.density
        shape = tuple(dens.shape)
        le_grid = torch.as_tensor(
            (0.5 + np.random.default_rng(1).random(shape)).astype(np.float32),
            device=dev)
        params = {"density": dens, "sigma_a": 1.0, "sigma_s": 1.0,
                  "Le_grid": le_grid}
        march.launches = gather.launches = 0
        g = grad_fn(params)
        counts = (march.launches, gather.launches)
        n = 2 * spp * steps          # forward sweep and recompute
        want = (0, n) if route == "window" else (n, 0)
        if counts != want:
            raise AssertionError(f"wave grad {route}: (march, gather) "
                                 f"launches {counts}, expected {want}")
        g = {k: v.cpu().numpy() for k, v in g.items()}
        for k, v in g.items():
            if not (np.isfinite(v).all() and np.abs(v).max() > 0):
                raise AssertionError(f"wave grad {route}: {k} gradient not "
                                     "finite or identically zero")

        def fd(key, delta, eps):
            with torch.no_grad():
                p1 = dict(params, **{key: params[key] + delta})
                p2 = dict(params, **{key: params[key] - delta})
                return (float(loss_fn(p1)) - float(loss_fn(p2))) / (2 * eps)

        def voxel(key, eps, flat_idx):
            e = torch.zeros(int(np.prod(shape)), device=dev)
            e[int(flat_idx)] = eps
            return fd(key, e.reshape(shape), eps)

        rows = []
        checks = [("density", 2e-3, 2e-3, 1e-3, fi) for fi in
                  np.argsort(np.abs(g["density"]).reshape(-1))[::-1][:2]]
        checks += [(k, 1e-3, 5e-3, 1e-3, None) for k in ("sigma_a",
                                                          "sigma_s")]
        checks.append(("Le_grid", 2e-3, 5e-3, 1e-4,
                       int(np.argmax(np.abs(g["Le_grid"])))))
        for key, eps, tol, floor, fi in checks:
            if fi is None:
                f, a = fd(key, eps, eps), float(g[key])
            else:
                f, a = voxel(key, eps, fi), float(g[key].reshape(-1)[fi])
            rows.append(f"{key}{'' if fi is None else f' voxel {int(fi)}'} "
                        f"fd {f:.6e} ad {a:.6e}")
            if abs(f - a) > tol * max(abs(f), abs(a), floor):
                raise AssertionError(f"wave grad {route}: {rows[-1]}")
        print(f"wave grad fd == ad ({route} route, {scene.width}x"
              f"{scene.height}, (march, gather) launches {counts}): "
              + "; ".join(rows), flush=True)


def phase_wave_full(dev, scene, regen_mean, card):
    from acceleratedvolrenderer_tpu_torch.ops import march
    from acceleratedvolrenderer_tpu_torch.parallel import render

    march.launches = 0
    img, st = render.render(scene, spp=1, device=dev)
    launches = march.launches
    FRAMES[("cloud", "render")] = img
    rel = abs(float(img.mean()) - regen_mean) / regen_mean
    mrays = scene.width * scene.height / st["render_time"] / 1e6
    print(f"wave frame {scene.width}x{scene.height} spp 1 grid 256^3, "
          f"{len(st['chunk_iterations'])} chunks of 262144 rays: iterations "
          f"{st['chunk_iterations']} (sum {st['iterations']}), march "
          f"launches {launches}, {st['render_time']:.3f} s, {mrays:.4f} "
          f"Mrays/s, film mean {img.mean():.6f} vs regen {regen_mean:.6f} "
          f"(rel diff {rel:.4e}) on {card}", flush=True)
    if img.shape != (scene.height, scene.width, 3) or not np.isfinite(
            img).all() or not img.mean() > 0:
        raise AssertionError("wave full: bad shape, non-finite film or "
                             "non-positive mean")
    if launches != st["iterations"]:
        raise AssertionError(f"wave full: {launches} march launches for "
                             f"{st['iterations']} loop iterations")
    if rel > 0.02:
        raise AssertionError(f"wave full: mean {img.mean()} is not within "
                             f"2% of the regen frame's {regen_mean}")
    return img


def small_gpu_cpu(what, make_scene, dev, mean_tol=1e-3, **knobs):
    """One small frame by render_regen on the GPU and on the CPU, compared
    at phase 5's tolerances; returns the GPU frame's (iterations, (march,
    gather) launches)."""
    from acceleratedvolrenderer_tpu_torch.ops import gather, march
    from acceleratedvolrenderer_tpu_torch.parallel import render

    imgs, runs = [], []
    for d in (dev, torch.device("cpu")):
        march.launches = gather.launches = 0
        img, st = render.render_regen(make_scene(d), device=d, **knobs)
        if not (np.isfinite(img).all() and img.mean() > 0):
            raise AssertionError(f"{what} on {d}: non-finite pixels or "
                                 "non-positive mean")
        imgs.append(img)
        runs.append((st["iterations"], (march.launches, gather.launches)))
    if runs[1][1] != (0, 0):
        raise AssertionError(f"{what}: the CPU run launched a kernel")
    compare_frames(f"{what} gpu vs cpu", *imgs, mean_tol=mean_tol)
    return runs[0]


def full_frame_pair(what, scene, dev, card, spp, regen_spp, route):
    """render() at spp and render_regen at regen_spp with the bench knobs on
    a full-width scene: finite films, positive means within 2% of each
    other, and on the given route one launch per loop iteration of its
    kernel and none of the other.  Returns the (march, gather) launches of
    the render() run and of the regen run."""
    from acceleratedvolrenderer_tpu_torch.ops import gather, march
    from acceleratedvolrenderer_tpu_torch.parallel import render

    out = []
    for entry in ("render", "regen"):
        march.launches = gather.launches = 0
        if entry == "render":
            img, st = render.render(scene, spp=spp, device=dev)
        else:
            img, st = render.render_regen(scene, spp=regen_spp, device=dev,
                                          **BENCH_KNOBS)
        counts = (march.launches, gather.launches)
        it = st["iterations"]
        want = (it, 0) if route == "fused" else (0, it)
        rays = scene.width * scene.height * st["spp"]
        print(f"{what} {scene.width}x{scene.height} {entry} spp "
              f"{st['spp']}: {it} iterations, (march, gather) launches "
              f"{counts}, {st['render_time']:.3f} s, "
              f"{rays / st['render_time'] / 1e6:.4f} Mrays/s, film mean "
              f"{img.mean():.6f} on {card}", flush=True)
        if img.shape != (scene.height, scene.width, 3) or not (
                np.isfinite(img).all() and img.mean() > 0):
            raise AssertionError(f"{what} {entry}: bad shape, non-finite "
                                 "film or non-positive mean")
        if counts != want:
            raise AssertionError(f"{what} {entry}: (march, gather) "
                                 f"launches {counts}, expected {want}")
        FRAMES[(what, entry)] = img
        out.append((float(img.mean()), counts))
    rel = abs(out[0][0] - out[1][0]) / out[1][0]
    print(f"{what}: render mean vs regen mean rel diff {rel:.4e}",
          flush=True)
    if rel > 0.02:
        raise AssertionError(f"{what}: render and regen means differ by "
                             f"more than 2%")
    return out[0][1], out[1][1]


def gather_v1(dev, n, key):
    """The gather at the fog box's shape: a 1-entry table and n x 8
    indices (n 16384 in regen, 65536 in render()'s one chunk of a 256x256
    frame), 1% of them out of range, against its plain version; then
    timed on in-range indices beside table[idx], with its bound."""
    from acceleratedvolrenderer_tpu_torch.ops import gather

    rng = np.random.default_rng(n)
    table = torch.as_tensor(np.float32([1.0]), device=dev)
    idx = torch.zeros((n, 8), dtype=torch.int32, device=dev)
    oob = rng.random((n, 8)) < 0.01                # out of range: read 0
    idx[torch.as_tensor(oob, device=dev)] = torch.as_tensor(
        rng.choice(np.int32([-1, 1, 7]), int(oob.sum())), device=dev)
    before = gather.launches
    out = gather.table_gather(table, idx)
    ref = gather.table_gather_plain(table, idx)
    torch.cuda.synchronize()
    if gather.launches != before + 1 or not torch.equal(out, ref):
        raise AssertionError(f"gather V 1 n {n}*8: kernel and plain "
                             "disagree or the kernel did not launch")
    err = float((out - ref).abs().max())
    idx.zero_()             # the library call's yardstick needs in-range
    kernel = lambda: gather.table_gather(table, idx)
    library = lambda: table[idx]
    ms, lib_ms = time_ms(kernel, 200), time_ms(library, 200)
    dev_us, lib_us = device_us(kernel, 200), device_us(library, 200)
    plain_ms = time_ms(lambda: gather.table_gather_plain(table, idx), 200)
    b = bound(nbytes(table, idx) + 4 * idx.numel(), 0)
    print(f"gather V 1, n {n}*8: equal to plain (max |err| {err:.3e}); "
          f"kernel {ms:.4f} ms, device {dev_us:.2f} us; table[idx] "
          f"{lib_ms:.4f} ms, device {lib_us:.2f} us; plain {plain_ms:.4f} "
          f"ms; bound {b[0]:.6f} ms ({b[1]})", flush=True)
    return {f"{key}ms": ms, f"{key}device_us": dev_us,
            f"{key}plain_ms": plain_ms, f"{key}library_ms": lib_ms,
            f"{key}library_device_us": lib_us, f"{key}bound_ms": b[0],
            f"{key}bound_by": b[1]}


def phase_fog(dev, card):
    from acceleratedvolrenderer_tpu_torch.scene import presets

    small_gpu_cpu("fog box 24x24",
                  lambda d: presets.fog_box(res=24, spp=4, device=d), dev,
                  **SMALL_KNOBS)
    scene = presets.fog_box(res=256, device=dev)
    render_counts, regen_counts = full_frame_pair(
        "fog box", scene, dev, card, FOG_SPP, FOG_REGEN_SPP, "window")
    return dict(fog_launches=regen_counts[1],
                fog_render_launches=render_counts[1])


def phase_gather_v1(dev):
    """Phase 15's gather at the fog box's shapes (V 1, n 16384*8 and
    65536*8) against its plain version, timed with table[idx] and bounded;
    run before the side process starts, so that no other process shares
    the card while it is timed."""
    rec = gather_v1(dev, 16384, "v1_")
    rec.update(gather_v1(dev, 65536, "v1_n65536_"))
    return rec


def phase_emissive(dev, card):
    """Returns the march launches of render() (N 65536)."""
    from acceleratedvolrenderer_tpu_torch.scene import presets

    small_gpu_cpu("emissive 24x24",
                  lambda d: presets.emissive_volume(res=24, spp=2, device=d),
                  dev, **dict(SMALL_KNOBS, n_lanes=128))
    scene = presets.emissive_volume(res=256, device=dev)
    return full_frame_pair("emissive volume", scene, dev, card, EMISSIVE_SPP,
                           EMISSIVE_REGEN_SPP, "fused")[0][0]


def phase_explosion(dev, card):
    """Returns the march launches of render() (N 65536)."""
    from acceleratedvolrenderer_tpu_torch.scene import presets

    small_gpu_cpu("explosion 12x12",
                  lambda d: presets.explosion(res=12, spp=8, device=d), dev,
                  **dict(SMALL_KNOBS, n_lanes=128))
    scene = presets.explosion(res=256, device=dev)
    return full_frame_pair("explosion", scene, dev, card, EXPLOSION_SPP,
                           EXPLOSION_REGEN_SPP, "fused")[0][0]


def phase_residual(dev, scene, slice_rec, card):
    """Phase 18; slice_rec is phase 8's (film mean, seconds, Mrays/s)."""
    from acceleratedvolrenderer_tpu_torch.ops import gather, march
    from acceleratedvolrenderer_tpu_torch.parallel import render
    from acceleratedvolrenderer_tpu_torch.scene import presets

    captured, capture = march_capture(RESIDUAL_CAPTURE_CALL)
    march.launches = march.residual_launches = gather.launches = 0
    with mock.patch.object(march, "march_block", capture):
        img, st = render.render_regen(scene, spp=RESIDUAL_SPP, device=dev,
                                      residual_shadow=True, **WIDE_KNOBS)
    counts = (march.launches, march.residual_launches, gather.launches)
    mean0, secs0, mrays0 = slice_rec
    rel = abs(float(img.mean()) - mean0) / mean0
    mrays = scene.width * scene.height * RESIDUAL_SPP / st["render_time"] / 1e6
    print(f"residual shadow {scene.width}x{scene.height} spp {RESIDUAL_SPP} "
          f"at {WIDE_LANES} lanes: "
          f"{st['iterations']} iterations, (march, residual, gather) "
          f"launches {counts}, {st['render_time']:.3f} s, {mrays:.4f} "
          f"Mrays/s (phase 8, spp {SPP}: {secs0:.3f} s, {mrays0:.4f} "
          f"Mrays/s), film mean {img.mean():.6f} vs phase 8's {mean0:.6f} "
          f"(rel diff {rel:.4e}) on {card}", flush=True)
    if not (np.isfinite(img).all() and img.mean() > 0):
        raise AssertionError("residual shadow: non-finite film or "
                             "non-positive mean")
    if counts != (st["iterations"], st["iterations"], 0):
        raise AssertionError(f"residual shadow: (march, residual, gather) "
                             f"launches {counts} for {st['iterations']} "
                             "iterations")
    if rel > 0.02:
        raise AssertionError("residual shadow: mean not within 2% of phase "
                             "8's")

    # the frame's residual march call RESIDUAL_CAPTURE_CALL: held to its
    # plain version, timed as phase 3 times the plain instance, bounded
    err = check_captured_march("residual shadow", captured,
                               RESIDUAL_CAPTURE_CALL)
    args, kw = captured["args"], captured["kw"]
    if kw.get("control") is None:
        raise AssertionError("residual shadow: the captured march call is "
                             "not the residual instance")
    call = lambda: march.march_block(*args, **kw)
    n, K = args[6].shape[0], args[11]
    flush = torch.empty(64 * 2 ** 20, device=dev).zero_
    ms = time_ms(call, 200)
    warm_us = device_us(call, 200, "march_kernel")
    cold_us = device_us(lambda: (flush(), call()), 200, "march_kernel")
    inputs = [a for a in (*args, *kw.values()) if torch.is_tensor(a)]
    b = bound(nbytes(*inputs) + nbytes(*call().values()),
              30 * K * int(args[10].sum()))
    print(f"march residual instance N {n} K {K} (call "
          f"{RESIDUAL_CAPTURE_CALL} of the frame): wrapper {ms:.4f} ms, "
          f"kernel alone {warm_us:.2f} us warm / {cold_us:.2f} us cold, "
          f"bound {b[0]:.6f} ms ({b[1]})", flush=True)

    it, small = small_gpu_cpu(
        f"residual shadow 32x24 at {WINDOW_LANES} lanes",
        lambda d: presets.cloud(**SMALL, device=d), dev,
        residual_shadow=True, **dict(SMALL_KNOBS, n_lanes=WINDOW_LANES))
    if small != (0, 2 * it):
        raise AssertionError(f"residual window route: (march, gather) "
                             f"launches {small}, expected (0, {2 * it})")
    return dict(residual_launches=counts[1], residual_lanes=n,
                residual_max_abs_err=err, residual_ms=ms,
                residual_device_us=warm_us,
                residual_cold_device_us=cold_us, residual_bound_ms=b[0],
                residual_bound_by=b[1])


def phase_knobs(dev):
    from acceleratedvolrenderer_tpu_torch.scene import presets

    for knob in KNOB_CASES:
        it, counts = small_gpu_cpu(
            f"32x24 cloud {knob}",
            lambda d: presets.cloud(**SMALL, device=d), dev,
            **dict(SMALL_KNOBS, **knob))
        if counts != (it, 0):
            raise AssertionError(f"knobs {knob}: (march, gather) launches "
                                 f"{counts} for {it} iterations")


def kernel_counts():
    """(march, gather, dma) launch counters."""
    from acceleratedvolrenderer_tpu_torch.ops import dma_gather, gather, march

    return march.launches, gather.launches, dma_gather.launches


def zero_kernel_counts():
    from acceleratedvolrenderer_tpu_torch.ops import dma_gather, gather, march

    march.launches = gather.launches = dma_gather.launches = 0


def graph_util():
    """tests/torch_graph_util.py: the 32^3 test sphere's tracking inputs
    and scene, shared with the card tests."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import torch_graph_util

    return torch_graph_util


def phase_tracking(dev):
    """delta_track and ratio_track on the card against the CPU on the same
    rays; the staged integrator against the fused one on the card."""
    from acceleratedvolrenderer_tpu_torch.models import lights
    from acceleratedvolrenderer_tpu_torch.models.cameras import (
        PerspectiveCamera)
    from acceleratedvolrenderer_tpu_torch.models.integrators import (
        volpath as staged, volpath_fused as fused)
    from acceleratedvolrenderer_tpu_torch.models.media import (
        MediumSpec, homogeneous_box)
    from acceleratedvolrenderer_tpu_torch.ops import dda, transmittance
    from acceleratedvolrenderer_tpu_torch.utils import spectrum as sp
    from acceleratedvolrenderer_tpu_torch.utils.vecmath import look_at

    inputs = graph_util().sphere_tracking_inputs
    n = TRACK_RAYS
    for emission in (False, True):
        out = []
        for d in (dev, torch.device("cpu")):
            med, o, dirs, active, rng = inputs(n, emission, d)
            one = torch.ones((n, 4), device=d)
            t0 = time.time()
            before = dda.delta_track_iterations
            out.append(dda.delta_track(
                med, o, dirs, torch.full((n,), torch.inf, device=d), one,
                one, one, rng, active, (8, 8, 8),
                collect_emission=emission))
            its = dda.delta_track_iterations - before
            _sync(d)
            print(f"delta_track N {n} emission {emission} on {d}: {its} "
                  f"iterations, {time.time() - t0:.3f} s", flush=True)
        gpu, cpu = out
        ev = (gpu.event.cpu() == cpu.event).numpy()
        err = 0.0
        for k in ("t_event", "beta", "r_u", "r_l", "L_emit"):
            a = getattr(gpu, k).cpu().numpy()[ev]
            b = getattr(cpu, k).numpy()[ev]
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                       err_msg=f"delta_track {k}")
            err = max(err, float(np.abs(a - b).max()))
        print(f"delta_track gpu vs cpu: events equal {ev.mean():.5f}, "
              f"events {np.bincount(cpu.event.numpy(), minlength=4)}, "
              f"max |diff| where equal {err:.3e}", flush=True)
        if ev.mean() < 0.99:
            raise AssertionError("delta_track: events differ on > 1% of rays")

    out = []
    for d in (dev, torch.device("cpu")):
        med, o, dirs, active, rng = inputs(n, False, d, 3)
        out.append(transmittance.ratio_track(
            med, o, dirs, torch.full((n,), 2.5, device=d), rng, active,
            (8, 8, 8)))
    gpu, cpu = out
    tg, tc = gpu.T_ray.cpu().numpy(), cpu.T_ray.numpy()
    close = np.isclose(tg, tc, rtol=1e-5, atol=1e-6).all(-1).mean()
    live = (tg != 0).any(-1) | (tc != 0).any(-1)
    close_r = min(np.isclose(getattr(gpu, k).cpu().numpy()[live],
                             getattr(cpu, k).numpy()[live], rtol=1e-5,
                             atol=1e-6).all(-1).mean() for k in ("r_l", "r_u"))
    print(f"ratio_track gpu vs cpu: T_ray close {close:.5f}, r_l / r_u close "
          f"where T_ray != 0 {close_r:.5f} ({live.mean():.3f} of rays)",
          flush=True)
    if close < 0.99 or close_r < 0.99:
        raise AssertionError("ratio_track: gpu and cpu disagree")

    # tests/test_twin.py's two gates: staged li against fused li
    flat = sp.constant_spectrum
    dens = np.random.RandomState(7).rand(12, 12, 12).astype(np.float32) * 2
    twins = {
        "fog box": lambda: (homogeneous_box(
            flat(0.3), flat(0.8), lo=(0, 0, 0), hi=(1, 1, 1), g=0.4,
            Le_spec=flat(0.2)), [lights.UniformInfiniteLight(
                spectrum=flat(1.0))]),
        "density grid": lambda: (MediumSpec(
            sigma_a_spec=flat(0.4), sigma_s_spec=flat(1.2),
            density=torch.as_tensor(dens, device=dev), g=-0.2),
            [lights.DistantLight(direction=torch.tensor(
                [0.3, -1.0, 0.2], device=dev), spectrum=flat(3.0))])}
    cam = PerspectiveCamera(c2w=look_at((0.5, 0.5, -2.0), (0.5, 0.5, 0.5),
                                        (0, 1, 0), dev),
                            fov_deg=30.0, width=8, height=8)
    ys, xs = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    pix = torch.as_tensor(np.stack([xs.reshape(-1), ys.reshape(-1)], -1),
                          device=dev)
    o, dirs = cam.generate_rays(pix, torch.full((64, 2), 0.5, device=dev))
    rng = (torch.arange(64, device=dev) * 2654435761 + 12345) & 0xFFFFFFFF
    rng, ul = dda.pcg_uniform(rng)
    lam = sp.sample_wavelengths_visible(ul).lam
    for name, make in twins.items():
        spec, lts = make()
        kw = dict(maj_res=spec.maj_res(), homogeneous=spec.homogeneous,
                  max_depth=6)
        med = spec.build_arrays(lam)
        a = staged.li(med, lts, o, dirs, lam, rng, **kw).L.cpu().numpy()
        b = fused.li(med, lts, o, dirs, lam, rng, **kw).L.cpu().numpy()
        print(f"twin {name} on the card: staged mean {a.mean():.7f}, fused "
              f"mean {b.mean():.7f}, max |diff| {np.abs(a - b).max():.3e}",
              flush=True)
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5,
                                   err_msg=f"twin {name}")
        if not (np.isfinite(a).all() and a.mean() > 0):
            raise AssertionError(f"twin {name}: bad radiance")


def phase_graph_small(dev):
    """A graph built on the CPU (test_graph.py's configuration); its light
    vector, final light and renders on the card against the CPU."""
    from acceleratedvolrenderer_tpu_torch.graph import lighting
    from acceleratedvolrenderer_tpu_torch.graph.builder import FreeGraphBuilder
    from acceleratedvolrenderer_tpu_torch.graph.config import (
        GraphBuilderConfig)
    from acceleratedvolrenderer_tpu_torch.models.integrators import graph as gi
    from acceleratedvolrenderer_tpu_torch.parallel import render

    test_scene = graph_util().graph_test_scene
    cpu = torch.device("cpu")
    scene = test_scene(16, cpu)
    light = np.array([0.0, -1.0, 0.0])
    t0 = time.time()
    graph = FreeGraphBuilder(scene.medium, light, GraphBuilderConfig(
        dimension_steps=24, iterations_per_step=2, radius_modifier=20.0,
        max_depth=4), seed=1, device=cpu).build()
    print(f"graph small: built on the CPU in {time.time() - t0:.2f} s: "
          f"{graph.n_vertices} vertices, {graph.n_edges} edges", flush=True)
    zero_kernel_counts()
    L0 = []
    for d in (dev, cpu):
        t0 = time.time()
        L0.append(lighting.light_vector(graph, scene.medium, light, 8,
                                        seed=1, device=d))
        _sync(d)
        print(f"light_vector on {d}: {time.time() - t0:.3f} s", flush=True)
    a, b = L0
    close = np.isclose(a, b, rtol=1e-4, atol=1e-7).mean()
    rel = abs(a.mean() - b.mean()) / b.mean()
    print(f"light_vector gpu vs cpu: vertices close {close:.5f}, mean rel "
          f"diff {rel:.3e}", flush=True)
    if close < 0.99 or rel > 1e-4:
        raise AssertionError("light_vector: gpu and cpu disagree")
    host = lighting.compute_final_light(graph, b, 3, on_device=False)
    for d in (dev, cpu):
        got = lighting.compute_final_light(graph, b, 3, on_device=True,
                                           device=d)
        np.testing.assert_allclose(got, host, rtol=1e-5, atol=1e-9,
                                   err_msg=f"final light on {d}")
    print(f"compute_final_light: device path on the card and the CPU equal "
          f"the host path to rtol 1e-5 (mean {host.mean():.7f})", flush=True)
    graph.light_scalar = host

    imgs = [render.render_graph(test_scene(16, d), graph, device=d)[0]
            for d in (dev, cpu)]
    compare_frames("render_graph 16x16 gpu vs cpu", *imgs)
    ug = graph.to_uniform(0.05)
    imgs = [render.render_graph(test_scene(16, d), ug, device=d)[0]
            for d in (dev, cpu)]
    compare_frames("render_graph uniform 16x16 gpu vs cpu", *imgs)
    dbg = []
    for d in (dev, cpu):
        uindex = gi.build_uniform_index(ug, d)
        dbg.append(gi.debug_image(uindex, test_scene(16, d).camera, 16, 16))
    np.testing.assert_allclose(dbg[0], dbg[1], rtol=1e-6)
    if not (dbg[0].max() > 0 and np.isfinite(dbg[0]).all()):
        raise AssertionError("debug_image: empty or non-finite")
    print(f"debug_image 16x16 on the card equals the CPU's (max "
          f"{dbg[0].max():.6f}); uniform graph {ug.n_vertices} voxels",
          flush=True)
    counts = kernel_counts()
    if counts != (0, 0, 0):
        raise AssertionError(f"graph small: (march, gather, dma) launches "
                             f"{counts}, the graph path launches none")


def graph_wave_split(scene, graph, dev):
    """One wave of the graph render (sample 1) split by stage, each stage
    timed by the host clock between synchronizes: the delta-tracking march,
    the cache lookup and the rest (sampling, the film); then a wave alone
    and one under torch.profiler: device busy time against the wall time of
    each (the profiler lengthens the wall)."""
    from acceleratedvolrenderer_tpu_torch.models.film import Film
    from acceleratedvolrenderer_tpu_torch.models.integrators import graph as gi
    from acceleratedvolrenderer_tpu_torch.ops import dda
    from acceleratedvolrenderer_tpu_torch.parallel import render

    render_wave, density, majorant = render.make_graph_wave_renderer(
        scene, graph, device=dev)
    spent = {"delta_track": 0.0, "connect_to_graph": 0.0}

    def timed_stage(name, fn):
        def wrapper(*args, **kwargs):
            _sync(dev)
            t0 = time.time()
            out = fn(*args, **kwargs)
            _sync(dev)
            spent[name] += time.time() - t0
            return out
        return wrapper

    film = Film.create(scene.height, scene.width, dev)
    render_wave(film, density, majorant, 0)
    with mock.patch.object(dda, "delta_track", timed_stage(
            "delta_track", dda.delta_track)), mock.patch.object(
                gi, "connect_to_graph", timed_stage(
                    "connect_to_graph", gi.connect_to_graph)):
        _sync(dev)
        t0 = time.time()
        before = dda.delta_track_iterations
        render_wave(film, density, majorant, 1)
        _sync(dev)
        wall = time.time() - t0
    its = dda.delta_track_iterations - before
    rest = wall - sum(spent.values())
    print(f"graph wave split (sample 1, host clock): delta_track "
          f"{spent['delta_track'] * 1e3:.3f} ms ({its} iterations, "
          f"{spent['delta_track'] * 1e3 / max(its, 1):.3f} ms each), "
          f"connect_to_graph {spent['connect_to_graph'] * 1e3:.3f} ms, rest "
          f"{rest * 1e3:.3f} ms, wave {wall * 1e3:.3f} ms", flush=True)
    from torch.profiler import ProfilerActivity, profile

    _sync(dev)
    t0 = time.time()
    render_wave(film, density, majorant, 2)
    _sync(dev)
    plain_wall = (time.time() - t0) * 1e3
    # device activity only, as scripts/profile_port.py takes it: with CPU
    # activity too, each kernel's time would also count on its aten op
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _sync(dev)
        t0 = time.time()
        render_wave(film, density, majorant, 3)
        _sync(dev)
        wall = (time.time() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    kernels = sum(e.count for e in prof.key_averages())
    print(f"graph wave (sample 3) under torch.profiler: device busy "
          f"{busy:.3f} ms, {kernels} device kernels; wall {wall:.3f} ms "
          f"profiled (idle share {1 - busy / wall:.4f}), {plain_wall:.3f} "
          f"ms unprofiled (sample 2; idle share {1 - busy / plain_wall:.4f})",
          flush=True)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def phase_graph_full(dev, card):
    """graph_maker preset:sphere with the default configuration on the
    card, then render_graph of presets.sphere_medium() at 640x480, spp
    GRAPH_SPP, against render() of the same scene."""
    import tempfile

    from acceleratedvolrenderer_tpu_torch.cli import graph_maker
    from acceleratedvolrenderer_tpu_torch.graph.model import Graph
    from acceleratedvolrenderer_tpu_torch.ops import dda
    from acceleratedvolrenderer_tpu_torch.parallel import render
    from acceleratedvolrenderer_tpu_torch.scene import presets

    zero_kernel_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        dda.delta_track_iterations = 0
        if graph_maker.main(["preset:sphere", "--quiet", "--out",
                             f"{tmp}/sphere"]) != 0:
            raise AssertionError("graph_maker failed")
        t_make = time.time() - t0
        build_its = dda.delta_track_iterations
        stats = json.loads(Path(f"{tmp}/sphere_stats.json").read_text())
        graph = Graph.read_npz(f"{tmp}/sphere_d4.npz")
        text = Graph.read_text(f"{tmp}/sphere_d4.txt")
    np.testing.assert_array_equal(text.edges, graph.edges)
    make_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"graph_maker preset:sphere (default GraphConfig) on {card}: "
          f"{stats['vertices']} vertices, {stats['edges']} edges, build "
          f"{stats['build_seconds']:.3f} s, lighting "
          f"{stats['lighting_seconds']:.3f} s, {t_make:.3f} s in all, "
          f"delta_track iterations {build_its}, mean light "
          f"{stats['mean_light']:.6g}, peak device memory {make_peak:.3f} "
          "GiB", flush=True)
    if not (graph.n_vertices > 0 and graph.n_edges > 0
            and np.isfinite(graph.light_scalar).all()
            and graph.light_scalar.max() > 0):
        raise AssertionError("graph_maker: empty graph or bad light")

    scene = presets.sphere_medium(spp=GRAPH_SPP, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    img, st = render.render_graph(scene, graph, device=dev)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    counts = kernel_counts()
    rays = scene.width * scene.height * GRAPH_SPP
    print(f"render_graph {scene.width}x{scene.height} spp {GRAPH_SPP} "
          f"({rays} camera rays, {scene.width * scene.height} per wave): "
          f"{st['render_time']:.3f} s, {st['rays_per_sec'] / 1e6:.4f} "
          f"Mrays/s, delta_track iterations per wave {st['iterations']}, "
          f"peak device memory {peak:.3f} GiB, (march, gather, dma) "
          f"launches {counts}, film mean {img.mean():.6f} on {card}",
          flush=True)
    if counts != (0, 0, 0):
        raise AssertionError("graph full: the graph path launched a kernel")
    graph_wave_split(scene, graph, dev)
    ref, rst = render.render(scene, spp=GRAPH_SPP, device=dev)
    print(f"render() {scene.width}x{scene.height} spp {GRAPH_SPP}: "
          f"{rst['render_time']:.3f} s, {rst['rays_per_sec'] / 1e6:.4f} "
          f"Mrays/s, {rst['iterations']} iterations, film mean "
          f"{ref.mean():.6f}", flush=True)
    if not (np.isfinite(img).all() and np.isfinite(ref).all()):
        raise AssertionError("graph full: non-finite image")
    ratio = float(img.mean() / max(ref.mean(), 1e-9))
    diff = (img - ref).astype(np.float64)
    rel_mse = float((diff * diff).mean()
                    / max((ref.astype(np.float64) ** 2).mean(), 1e-12))
    print(f"graph vs path: mean ratio {ratio:.5f}, relative MSE "
          f"{rel_mse:.5f}; graph render {rst['render_time'] / st['render_time']:.2f}x "
          "the speed of render()", flush=True)
    if not 0.5 < ratio < 2.0:
        raise AssertionError(f"graph full: graph/path mean ratio {ratio}")
    return counts


def uv_sphere_mesh(n_theta, n_phi, radius, center):
    """A closed UV-sphere triangle mesh, built with numpy: (vertices (V, 3)
    float32, indices (2 * n_phi * (n_theta - 1), 3) int32)."""
    th = np.linspace(0.0, np.pi, n_theta + 1)[1:-1]
    ph = np.linspace(0.0, 2.0 * np.pi, n_phi, endpoint=False)
    t, p = np.meshgrid(th, ph, indexing="ij")
    ring = np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p),
                     np.cos(t)], -1).reshape(-1, 3)
    v = np.concatenate([[[0.0, 0.0, 1.0]], ring, [[0.0, 0.0, -1.0]]])
    last = len(v) - 1
    tris = []
    for j in range(n_phi):
        k = (j + 1) % n_phi
        tris.append([0, 1 + j, 1 + k])
        for i in range(n_theta - 2):
            a, b = 1 + i * n_phi + j, 1 + i * n_phi + k
            tris += [[a, a + n_phi, b], [b, a + n_phi, b + n_phi]]
        tris.append([1 + (n_theta - 2) * n_phi + j, last,
                     1 + (n_theta - 2) * n_phi + k])
    v = v * radius + np.asarray(center, np.float64)
    return v.astype(np.float32), np.asarray(tris, np.int32)


def cloud_with_surfaces(scene):
    """Phase A's scene: the cloud analog (its sun and sky as they are) with
    a diffuse ground quad through the centre of the medium box's lower face
    (y -100), a rough conductor sphere and a smooth glass sphere, each half
    inside the box's face toward the camera.  The camera's eye lies 17.5
    above that face and every camera ray climbs, so a level ground there
    would be out of view: the ground tilts 10 degrees up away from the
    camera (about z), rising out of the box behind the cloud."""
    from acceleratedvolrenderer_tpu_torch.models import materials, shapes

    half = 100.0
    tilt = np.deg2rad(10.0)
    # the ground's edges: across the view (z) and along the slope, which
    # climbs toward -x (away from the camera)
    across = np.array([0.0, 0.0, 1600.0])
    slope = 1600.0 * np.array([-np.cos(tilt), np.sin(tilt), 0.0])
    centre = np.array([0.0, -half, 0.0])
    ground = shapes.Quad(origin=centre - 0.5 * across - 0.25 * slope,
                         e1=across, e2=slope,
                         material=materials.DiffuseMaterial(reflectance=0.4))
    metal = shapes.Sphere(center=np.array([half, -30.0, -80.0]),
                          radius=45.0,
                          material=materials.ConductorMaterial(
                              eta=0.2, k=3.0, roughness=0.3))
    glass = shapes.Sphere(center=np.array([half, -20.0, 70.0]), radius=40.0,
                          material=materials.DielectricMaterial(eta=1.5))
    return replace(scene, primitives=[ground, metal, glass])


def cornell_room(width, height, spp, device):
    """Phase 24's scene, without a medium: a 2 x 2 x 2 room open toward the
    camera, five diffuse quads (floor, ceiling and back white, the left
    wall red and the right one green), an emissive diffuse quad in the
    ceiling's plane facing down (listed before the ceiling, so the exact
    tie of the two planes goes to the light, and its back faces out of the
    room), a glass sphere, a rough conductor sphere and a 912-triangle
    diffuse mesh sphere built with numpy (the trigrid route); the bvh light
    sampler.  No light but the emitter: the path integrators sample it as
    an area light, volpath only by path sampling, as the reference."""
    from acceleratedvolrenderer_tpu_torch.models import materials, shapes
    from acceleratedvolrenderer_tpu_torch.models import textures
    from acceleratedvolrenderer_tpu_torch.models.cameras import (
        PerspectiveCamera)
    from acceleratedvolrenderer_tpu_torch.models.film import BoxFilter
    from acceleratedvolrenderer_tpu_torch.scene.types import Scene
    from acceleratedvolrenderer_tpu_torch.utils.spectrum import (
        constant_spectrum)
    from acceleratedvolrenderer_tpu_torch.utils.vecmath import look_at

    def quad(o, e1, e2, reflectance, emission=None):
        return shapes.Quad(
            origin=np.array(o, np.float64), e1=np.array(e1, np.float64),
            e2=np.array(e2, np.float64),
            material=materials.DiffuseMaterial(reflectance=reflectance,
                                               emission=emission))

    rgb = textures.ConstantRGBTexture
    verts, tris = uv_sphere_mesh(20, 24, 0.3, (0.1, 0.3, 1.45))
    prims = [
        quad([-0.45, 2, 0.55], [0.9, 0, 0], [0, 0, 0.9], 0.0,
             emission=constant_spectrum(8.0)),                   # light
        quad([-1, 0, 0], [0, 0, 2], [2, 0, 0], 0.7),             # floor
        quad([-1, 2, 0], [2, 0, 0], [0, 0, 2], 0.7),             # ceiling
        quad([-1, 0, 2], [0, 2, 0], [2, 0, 0], 0.7),             # back
        quad([-1, 0, 0], [0, 2, 0], [0, 0, 2], rgb((0.63, 0.06, 0.05))),
        quad([1, 0, 0], [0, 0, 2], [0, 2, 0], rgb((0.14, 0.45, 0.09))),
        shapes.Sphere(center=np.array([-0.5, 0.38, 0.9]), radius=0.38,
                      material=materials.DielectricMaterial(eta=1.5)),
        shapes.Sphere(center=np.array([0.55, 0.28, 0.5]), radius=0.28,
                      material=materials.ConductorMaterial(
                          eta=0.2, k=3.0, roughness=0.2)),
        shapes.TriangleMesh(vertices=verts, indices=tris,
                            material=materials.DiffuseMaterial(
                                reflectance=0.6)),
    ]
    cam = PerspectiveCamera(
        c2w=look_at((0.0, 1.0, -2.8), (0.0, 1.0, 1.0), (0, 1, 0), device),
        fov_deg=40.0, width=width, height=height)
    return Scene(camera=cam, medium=None, lights=[], primitives=prims,
                 max_depth=6, spp=spp, scene_radius=20.0, filter=BoxFilter(),
                 light_sampler="bvh")


def sky_env_map(res, elevation_deg, turbidity=3.0):
    """The Preetham sky (utils/sky.py::make_sky_image, an equal-area
    octahedral res x res map with the sun at elevation_deg) turned into a
    res x 2 res equirect map the way the reference's scene parser turns a
    square environment map (acceleratedvolrenderer_tpu/scene/parser.py
    l. 412-426): nearest texel per equirect texel centre."""
    from acceleratedvolrenderer_tpu_torch.utils import sky

    img = sky.make_sky_image(res, elevation_deg=elevation_deg,
                             turbidity=turbidity)
    th = (np.arange(res) + 0.5) / res * np.pi
    ph = (np.arange(2 * res) + 0.5) / (2 * res) * 2 * np.pi
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    st = np.sin(tt)
    uv = sky.equal_area_sphere_to_square(
        np.stack([st * np.cos(pp), st * np.sin(pp), np.cos(tt)], -1))
    sx = np.clip((uv[..., 0] * res).astype(np.int64), 0, res - 1)
    sy = np.clip((uv[..., 1] * res).astype(np.int64), 0, res - 1)
    return img[sy, sx]


def sun_elevation_deg(scene):
    """The elevation, in degrees above the y = 0 plane, of the direction
    toward the scene's sun (its first delta light)."""
    sun = next(lt for lt in scene.lights if lt.is_delta)
    d = -sun.direction.detach().cpu().numpy().astype(np.float64)
    return float(np.degrees(np.arcsin(d[1] / np.linalg.norm(d))))


def cloud_under_sky(scene, res=512):
    """Phase 25's scene: `scene` (the cloud analog) with its sun kept and
    its uniform sky replaced by an ImageInfiniteLight of sky_env_map(res)
    at the sun's elevation, scaled so that the map's mean luminance equals
    the uniform sky's radiance it replaces."""
    from acceleratedvolrenderer_tpu_torch.models import lights

    sun = next(lt for lt in scene.lights if lt.is_delta)
    sky_l = next(lt for lt in scene.lights
                 if isinstance(lt, lights.UniformInfiniteLight))
    level = float(sky_l.spectrum(torch.full((1,), 550.0))[0]) * sky_l.scale
    env = sky_env_map(res, sun_elevation_deg(scene))
    lum = (0.2126 * env[..., 0] + 0.7152 * env[..., 1]
           + 0.0722 * env[..., 2]).mean()
    image_light = lights.ImageInfiniteLight(
        env, scale=level / float(lum), scene_radius=sky_l.scene_radius)
    return replace(scene, lights=[sun, image_light])


def first_hit_ids(scene):
    """(H, W) the primitive index of each pixel-centre camera ray's first
    hit (-1: none), on the CPU."""
    from acceleratedvolrenderer_tpu_torch.models import shapes

    H, W = scene.height, scene.width
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    pix = torch.as_tensor(np.stack([xs.ravel(), ys.ravel()], -1))
    o, d = scene.camera.to("cpu").generate_rays(
        pix, torch.full((H * W, 2), 0.5))
    hit = shapes.intersect_all(scene.primitives, o, d, torch.inf)
    return hit.prim_id.reshape(H, W).numpy()


def first_hit_fractions(scene):
    """The share of pixel-centre camera rays whose first hit is each of the
    scene's primitives, on the CPU."""
    ids = first_hit_ids(scene)
    return [float((ids == i).mean()) for i in range(len(scene.primitives))]


def _frame_line(what, img, st, counts, peak, card):
    rays = img.shape[0] * img.shape[1] * st["spp"]
    return (f"{what} {img.shape[1]}x{img.shape[0]} spp {st['spp']}: "
            f"{st['render_time']:.3f} s, {st['iterations']} iterations, "
            f"{rays / st['render_time'] / 1e6:.4f} Mrays/s, film mean "
            f"{img.mean():.6f}, peak device memory {peak:.3f} GiB, (march, "
            f"gather, dma) launches {counts} on {card}")


def _check_frame(what, img, shape):
    if img.shape != shape or not np.isfinite(img).all() or not img.mean() > 0:
        raise AssertionError(f"{what}: bad shape, non-finite film or "
                             "non-positive mean")


def march_capture(n_call):
    """(captured, capture): capture stands in for march.march_block (patch
    it in), counts the calls and keeps clones of call n_call's inputs in
    the dict captured."""
    from acceleratedvolrenderer_tpu_torch.ops import march

    captured = {}
    kernel = march.march_block

    def capture(*args, **kw):
        captured["n"] = captured.get("n", 0) + 1
        if captured["n"] == n_call:
            captured["args"] = [a.clone() if torch.is_tensor(a) else a
                                for a in args]
            captured["kw"] = {k: v.clone() if torch.is_tensor(v) else v
                              for k, v in kw.items()}
        return kernel(*args, **kw)

    return captured, capture


def check_captured_march(what, captured, n_call):
    """The captured march_block call through the kernel and its plain
    version: the same layout, integers and flags equal, floats to rtol
    1e-6; returns the max |diff|."""
    from acceleratedvolrenderer_tpu_torch.ops import march

    if "args" not in captured:
        raise AssertionError(f"{what}: the frame made {captured.get('n', 0)}"
                             f" march calls, fewer than {n_call}")
    args, kw = captured["args"], captured["kw"]
    hunting = args[10]
    out = march.march_block(*args, **kw)
    ref = march.march_block_plain(*args, **kw)
    torch.cuda.synchronize()
    check_march_layout(out, ref)
    err = compare_march(out, ref)
    print(f"{what}: march_block call {n_call} of the frame "
          f"({int(hunting.sum())} of {hunting.numel()} lanes hunting, "
          f"{int(out['landed'].sum())} landed, {int(out['escaped'].sum())} "
          f"escaped) equals march_block_plain, max |diff| {err:.3e}",
          flush=True)
    return err


def phase_cloud_surfaces(dev, scene, card):
    """Phase 23: phase 8's baked scene with a ground quad, a rough conductor
    sphere and a glass sphere (cloud_with_surfaces).  render_regen with the
    bench knobs at spp SURF_REGEN_SPP, capturing one loop iteration's
    march_block inputs (segments cut at the surface hits); render() at spp
    1; then the captured inputs through the kernel and its plain version,
    and the 32x24 cloud with the same surfaces on the GPU and the CPU."""
    from acceleratedvolrenderer_tpu_torch.ops import march
    from acceleratedvolrenderer_tpu_torch.parallel import render
    from acceleratedvolrenderer_tpu_torch.scene import presets

    sc = cloud_with_surfaces(scene)
    H, W = sc.height, sc.width
    maj_size = sc.medium.majorant.numel()
    captured, capture = march_capture(SURF_CAPTURE_CALL)

    frames, rec = [], {}
    for entry in ("regen", "render"):
        torch.cuda.reset_peak_memory_stats(dev)
        zero_kernel_counts()
        if entry == "regen":
            with mock.patch.object(march, "march_block", capture):
                img, st = render.render_regen(sc, spp=SURF_REGEN_SPP,
                                              device=dev, **WIDE_KNOBS)
        else:
            img, st = render.render(sc, spp=1, device=dev)
        counts = kernel_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        print(_frame_line(f"cloud + surfaces {entry}", img, st, counts,
                          peak, card), flush=True)
        _check_frame(f"cloud + surfaces {entry}", img, (H, W, 3))
        # one launch per loop iteration: the march kernel on the fused
        # route (WIDE_LANES, render()'s chunks of 262144 rays), the gather
        # on the window route
        lanes = (min(WIDE_LANES, H * W * SURF_REGEN_SPP)
                 if entry == "regen" else min(262144, H * W))
        it = st["iterations"]
        want = ((it, 0, 0) if march.available(maj_size, lanes)
                else (0, it, 0))
        if counts != want:
            raise AssertionError(f"cloud + surfaces {entry}: launches "
                                 f"{counts}, expected {want}")
        frames.append(float(img.mean()))
        rec[f"cloud_surfaces_{entry}_launches"] = counts[0]
    rel = abs(frames[0] - frames[1]) / frames[0]
    print(f"cloud + surfaces: regen mean vs render() mean rel diff "
          f"{rel:.4e}", flush=True)
    if rel > 0.02:
        raise AssertionError("cloud + surfaces: regen and render() means "
                             "differ by more than 2%")
    err = check_captured_march("cloud + surfaces", captured,
                               SURF_CAPTURE_CALL)
    small_gpu_cpu("cloud + surfaces 32x24", lambda d: cloud_with_surfaces(
        presets.cloud(**SMALL, device=d)), dev, mean_tol=SURF_MEAN_TOL,
        **SMALL_KNOBS)
    rec["cloud_surfaces_max_abs_err"] = err
    return rec


def phase_room(dev, card):
    """Phase 24: cornell_room at 1280x720 through render() with the path,
    simplepath and (empty-medium) volpath integrators at spp ROOM_SPP and
    the bvh light sampler; the path and simplepath means within 2% (the
    reference's gate, tests/test_path.py:159), volpath's mean beside them;
    then the 32x24 room by each integrator on the GPU and the CPU."""
    from acceleratedvolrenderer_tpu_torch.parallel import render

    room = cornell_room(1280, 720, ROOM_SPP, dev)
    means, rec = {}, {}
    for integ in ("path", "simplepath", "volpath"):
        torch.cuda.reset_peak_memory_stats(dev)
        zero_kernel_counts()
        img, st = render.render(replace(room, integrator=integ), device=dev)
        counts = kernel_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        print(_frame_line(f"room {integ}", img, st, counts, peak, card),
              flush=True)
        _check_frame(f"room {integ}", img, (room.height, room.width, 3))
        # volpath over the empty medium's 1^3 majorant takes the window
        # route: one gather launch per iteration; the path integrators
        # launch no kernel
        want = (0, st["iterations"], 0) if integ == "volpath" else (0, 0, 0)
        if counts != want:
            raise AssertionError(f"room {integ}: launches {counts}, "
                                 f"expected {want}")
        means[integ] = float(img.mean())
        rec[f"room_{integ}_launches"] = counts[1]
        FRAMES[("room", integ)] = img
    rel = abs(means["path"] - means["simplepath"]) / means["path"]
    rel_v = abs(means["volpath"] - means["path"]) / means["path"]
    print(f"room: path mean {means['path']:.6f}, simplepath "
          f"{means['simplepath']:.6f} (rel diff {rel:.4e}), volpath "
          f"{means['volpath']:.6f} (rel diff to path {rel_v:.4e})",
          flush=True)
    if rel > 0.02:
        raise AssertionError("room: path and simplepath means differ by "
                             "more than 2%")
    if rel_v > ROOM_VOLPATH_TOL:
        raise AssertionError(f"room: volpath mean not within "
                             f"{ROOM_VOLPATH_TOL:.0%} of path's")
    for integ in ("path", "simplepath", "volpath"):
        imgs = []
        for d in (dev, torch.device("cpu")):
            small = replace(cornell_room(32, 24, ROOM_SMALL_SPP, d),
                            integrator=integ)
            imgs.append(render.render(small, device=d)[0])
        compare_frames(f"room 32x24 {integ} gpu vs cpu", *imgs)
    return rec, means


def phase_sky(dev, scene, slice_rec, card):
    """Phase 25: phase 8's scene with its sun and, for its uniform sky, an
    ImageInfiniteLight of the sky map (cloud_under_sky): render() at spp 1
    with pmj02bn and regen at spp 1 with zsobol and the bench knobs (march
    call SKY_CAPTURE_CALL held to plain); film_sample on the card against
    the CPU; the 32x24 version on the card and the CPU.  slice_rec is phase
    8's (film mean, seconds, Mrays/s, iterations).  Returns the kernels'
    record and (the scene, its render() mean)."""
    from acceleratedvolrenderer_tpu_torch.models import pmj02, samplers
    from acceleratedvolrenderer_tpu_torch.ops import march
    from acceleratedvolrenderer_tpu_torch.parallel import render
    from acceleratedvolrenderer_tpu_torch.scene import presets

    t0 = time.time()
    pmj02.get_tables(0)
    t1 = time.time()
    sc = cloud_under_sky(scene, SKY_RES)
    print(f"sky: pmj02bn tables {t1 - t0:.1f} s, sky map {SKY_RES}x"
          f"{2 * SKY_RES} at the sun's elevation "
          f"{sun_elevation_deg(scene):.2f} deg {time.time() - t1:.1f} s",
          flush=True)
    H, W = sc.height, sc.width
    captured, capture = march_capture(SKY_CAPTURE_CALL)
    means, rec, per_it = {}, {}, None
    for entry, kind in (("render", "pmj02bn"), ("regen", "zsobol")):
        s = replace(sc, sampler=kind)
        torch.cuda.reset_peak_memory_stats(dev)
        zero_kernel_counts()
        if entry == "regen":
            with mock.patch.object(march, "march_block", capture):
                img, st = render.render_regen(s, spp=SKY_SPP, device=dev,
                                              **WIDE_KNOBS)
            per_it = 1e3 * st["render_time"] / st["iterations"]
        else:
            img, st = render.render(s, spp=SKY_SPP, device=dev)
        counts = kernel_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        print(_frame_line(f"cloud under the sky map, {entry} {kind}", img,
                          st, counts, peak, card), flush=True)
        _check_frame(f"sky {entry}", img, (H, W, 3))
        if counts != (st["iterations"], 0, 0):
            raise AssertionError(f"sky {entry}: launches {counts}, expected "
                                 f"({st['iterations']}, 0, 0)")
        means[entry] = float(img.mean())
        rec[f"sky_{entry}_launches"] = counts[0]
    mean8, secs8, _, it8 = slice_rec
    rel = abs(means["render"] - means["regen"]) / means["regen"]
    print(f"sky: render() (pmj02bn) mean vs regen (zsobol) mean rel diff "
          f"{rel:.4e}; regen {per_it:.3f} ms per iteration at {WIDE_LANES} "
          f"lanes against phase 8's {1e3 * secs8 / it8:.3f} at "
          f"{WIDE_LANES} (independent sampler, uniform sky)",
          flush=True)
    if rel > FULL_MEAN_TOL:
        raise AssertionError("sky: render() and regen means differ by more "
                             "than 2%")
    rec["sky_max_abs_err"] = check_captured_march("sky", captured,
                                                  SKY_CAPTURE_CALL)
    # film_sample of every kind over the frame's pixels, card against CPU
    idx = torch.arange(H * W, dtype=torch.int64)
    pix = torch.stack([idx % W, idx // W], -1).to(torch.int32)
    t0 = time.time()
    for kind in samplers.KINDS:
        for s_i in SKY_SAMPLE_INDICES:
            sidx = torch.full_like(idx, s_i)
            cpu = samplers.film_sample(kind, idx, sidx, SKY_SPP,
                                       seed=sc.seed, pix=pix)
            card = samplers.film_sample(kind, idx.to(dev), sidx.to(dev),
                                        SKY_SPP, seed=sc.seed,
                                        pix=pix.to(dev))
            for a, b in zip(card, cpu):
                if a.device.type != dev.type or not torch.equal(a.cpu(), b):
                    raise AssertionError(f"film_sample {kind} sample {s_i}: "
                                         "card and CPU differ")
    print(f"film_sample, 7 kinds x samples {SKY_SAMPLE_INDICES} over "
          f"{H * W} pixels: card equals CPU bit for bit "
          f"({time.time() - t0:.1f} s)", flush=True)

    def small(d, kind):
        return replace(cloud_under_sky(presets.cloud(**SMALL, device=d),
                                       res=64), sampler=kind)

    imgs = [render.render(small(d, "pmj02bn"), device=d)[0]
            for d in (dev, torch.device("cpu"))]
    compare_frames("sky 32x24 render() pmj02bn gpu vs cpu", *imgs)
    small_gpu_cpu("sky 32x24 regen zsobol", lambda d: small(d, "zsobol"),
                  dev, **SMALL_KNOBS)
    return rec, (replace(sc, sampler="pmj02bn"), means["render"])


def room_with_projectors(width, height, spp, device):
    """cornell_room with a goniometric light (an 8x16 RGB image over its
    directions) in the room and a projector (an 8x8 RGB checker) aimed at
    the back wall, beside the emissive quad."""
    from acceleratedvolrenderer_tpu_torch.models import lights, textures
    from acceleratedvolrenderer_tpu_torch.utils.spectrum import (
        constant_spectrum)

    g = np.linspace(0.2, 1.0, 16, dtype=np.float32)
    gonio = np.stack(np.broadcast_arrays(g[None, :], g[::-1, None][:8],
                                         np.float32(0.5)), -1)
    checker = np.where((np.add.outer(np.arange(8), np.arange(8)) % 2)[..., None]
                       == 1, np.float32([1.0, 0.8, 0.3]),
                       np.float32([0.2, 0.4, 1.0]))
    room = cornell_room(width, height, spp, device)
    return replace(room, lights=[
        lights.GoniometricLight(
            position=np.array([0.3, 1.5, 0.8]),
            image=textures.ImageTexture(np.ascontiguousarray(gonio)),
            spectrum=constant_spectrum(0.6)),
        lights.ProjectionLight(
            position=np.array([0.0, 1.8, 0.1]),
            direction=np.array([0.0, -0.4, 1.0]),
            image=textures.ImageTexture(checker.astype(np.float32)),
            spectrum=constant_spectrum(1.5), fov_deg=40.0)])


def phase_room_samplers(dev, room_means, card):
    """Phase 26: phase 24's room at 1280x720 through path with the halton
    sampler at spp 1 (a PathSampler per chunk), its mean within 2% of phase
    24's independent path frame (spp ROOM_SPP); the room with a
    goniometric light and a projector beside its area light at 320x180,
    spp 4, and at 32x24 on the card and the CPU."""
    from acceleratedvolrenderer_tpu_torch.parallel import render

    room = replace(cornell_room(*FULL, 1, dev), integrator="path",
                   sampler="halton")
    torch.cuda.reset_peak_memory_stats(dev)
    zero_kernel_counts()
    img, st = render.render(room, device=dev)
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(_frame_line("room path halton", img, st, counts, peak, card),
          flush=True)
    _check_frame("room halton", img, (FULL[1], FULL[0], 3))
    rel = abs(float(img.mean()) - room_means["path"]) / room_means["path"]
    print(f"room: halton spp 1 mean {img.mean():.6f} vs phase 24's "
          f"independent spp {ROOM_SPP} {room_means['path']:.6f} (rel diff "
          f"{rel:.4e})", flush=True)
    if counts != (0, 0, 0) or rel > FULL_MEAN_TOL:
        raise AssertionError("room halton: a kernel launched or the mean is "
                             "not within 2% of phase 24's")
    lit = replace(room_with_projectors(320, 180, 4, dev), integrator="path")
    zero_kernel_counts()
    img, st = render.render(lit, device=dev)
    print(_frame_line("room + goniometric + projector path", img, st,
                      kernel_counts(), 0.0, card), flush=True)
    _check_frame("room + projectors", img, (180, 320, 3))
    imgs = [render.render(replace(room_with_projectors(32, 24, 4, d),
                                  integrator="path"), device=d)[0]
            for d in (dev, torch.device("cpu"))]
    compare_frames("room + projectors 32x24 gpu vs cpu", *imgs)


def portal_checks(light, dev):
    """test_portal_light.py's gates on the card: a sample's own pdf equals
    pdf_li of its direction (rel 1e-4), the pdf integrates to 1 over the
    sphere (6%), E[L / pdf] equals the integrated radiance (10%), no sample
    from behind the portal, Le zero outside the window."""
    rng = np.random.default_rng(3)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    n = 8192
    s = light.sample_li(torch.zeros((n, 3), device=dev),
                        f32(rng.random((n, 2))), torch.full((n, 4), 550.0,
                                                            device=dev))
    ok = s.valid.cpu().numpy()
    pdf = s.pdf.cpu().numpy()
    pl = light.pdf_li(torch.zeros((n, 3), device=dev), s.wi).cpu().numpy()
    consistency = float((np.abs(pl[ok] - pdf[ok]) / pdf[ok]).max())
    d = rng.standard_normal((200000, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    integral = float(light.pdf_li(torch.zeros((len(d), 3), device=dev),
                                  f32(d)).mean()) * 4 * np.pi
    est = float((s.L[:, 0] / s.pdf)[s.valid].mean())
    le = light.le_escaped(f32(d), torch.full((len(d), 4), 550.0, device=dev))
    ref = float(le[:, 0].mean()) * 4 * np.pi
    back = light.sample_li(f32([[0.0, 0.0, 20.0]] * 4),
                           f32(rng.random((4, 2))),
                           torch.full((4, 4), 550.0, device=dev)).valid
    win = light.le_escaped(f32([[0, 0, 1.0], [0, 0, -1.0]]),
                           torch.full((2, 4), 550.0, device=dev))
    print(f"portal gates on the card: valid {ok.mean():.4f}, pdf "
          f"consistency {consistency:.2e}, pdf integral {integral:.4f}, "
          f"E[L/pdf] {est:.5f} vs {ref:.5f}", flush=True)
    if not (ok.mean() > 0.99 and consistency < 1e-4
            and abs(integral - 1.0) < 0.06 and abs(est - ref) / ref < 0.1
            and not bool(back.any()) and float(win[0].sum()) > 0
            and float(win[1].sum()) == 0.0):
        raise AssertionError("portal light: a gate of test_portal_light.py "
                             "failed on the card")


def phase_portal_entries(dev, sky, room_means, card):
    """Phase 27: a PortalImageInfiniteLight over the 512^2 sky map, its
    sample_li and pdf_li on PORTAL_POINTS points on the card against the
    CPU, test_portal_light.py's gates on the card and sample_li's ms per
    call; render_spectral of phase 25's scene (its RGB mean equal to
    render()'s to 1e-6); render_gbuffer of the room and of phase 23's
    cloud with surfaces at 1280x720 (and the room at 32x24 on the card
    against the CPU); render_with_aovs of the room through path at
    1280x720, spp 2, its mean within 2% of phase 24's path frame."""
    from acceleratedvolrenderer_tpu_torch.models import lights
    from acceleratedvolrenderer_tpu_torch.parallel import render
    from acceleratedvolrenderer_tpu_torch.utils import sky as sky_mod

    sky_scene, sky_mean = sky
    portal = np.array([[-1, -1, 5], [-1, 1, 5], [1, 1, 5], [1, -1, 5]],
                      np.float32)
    light = lights.PortalImageInfiniteLight(
        sky_mod.make_sky_image(SKY_RES, elevation_deg=30.0), portal)
    rng = np.random.default_rng(27)
    n = PORTAL_POINTS
    host = [torch.as_tensor(a) for a in (
        (rng.normal(size=(n, 3)) * 0.5).astype(np.float32),
        rng.random((n, 2), dtype=np.float32),
        rng.uniform(360, 830, (n, 4)).astype(np.float32))]
    card_in = [a.to(dev) for a in host]
    cpu_s, card_s = light.sample_li(*host), light.sample_li(*card_in)
    got = [a.cpu().numpy() for a in card_s]
    want = [a.numpy() for a in cpu_s]
    # the card's atan2 and tan differ from the CPU's by an ulp on some
    # inputs; the window's edges move by that ulp, and a flipped late
    # comparison of the 24-step bisections moves a sample by up to a
    # tenth of a texel: pdf to rtol 1e-4, wi to atol 5e-4 (the map's texel
    # spans 6e-3 rad), radiance to rtol 1e-5, on 99.9% of the lanes
    ok = (np.isclose(got[3], want[3], rtol=1e-4, atol=0)
          & np.isclose(got[0], want[0], rtol=1e-5, atol=1e-6).all(-1)
          & np.isclose(got[1], want[1], rtol=0, atol=5e-4).all(-1)
          & (got[4] == want[4]))
    pdf_card = light.pdf_li(card_in[0], cpu_s.wi.to(dev)).cpu().numpy()
    pdf_cpu = light.pdf_li(host[0], cpu_s.wi).numpy()
    pdf_ok = np.isclose(pdf_card, pdf_cpu, rtol=1e-5, atol=0).mean()
    ms = time_ms(lambda: light.sample_li(*card_in), 20)
    print(f"portal light {SKY_RES}^2, {n} points: sample_li card vs CPU "
          f"{ok.mean():.5f} of lanes equal, pdf_li of the CPU samples "
          f"{pdf_ok:.5f}; sample_li {ms:.3f} ms per call on {card}",
          flush=True)
    if ok.mean() < 0.999 or pdf_ok < 0.999:
        raise AssertionError("portal light: card and CPU disagree")
    portal_checks(light, dev)

    zero_kernel_counts()
    film, st = render.render_spectral(sky_scene, spp=1, device=dev)
    img = film.to_image().cpu().numpy()
    buckets = film.bucket_images().cpu().numpy()
    rel = abs(float(img.mean()) - sky_mean) / sky_mean
    print(f"render_spectral {sky_scene.width}x{sky_scene.height} spp 1, 16 "
          f"buckets: {st['render_time']:.3f} s, march launches "
          f"{kernel_counts()[0]}, RGB mean {img.mean():.7f} vs render()'s "
          f"{sky_mean:.7f} (rel diff {rel:.3e}), bucket mean "
          f"{buckets.mean():.6f}", flush=True)
    if rel > 1e-6 or not (np.isfinite(buckets).all() and buckets.max() > 0):
        raise AssertionError("render_spectral: RGB differs from render() or "
                             "non-finite buckets")

    room = cornell_room(*FULL, 2, dev)
    for what, sc in (("room", room),
                     ("cloud + surfaces", cloud_with_surfaces(sky_scene))):
        aovs, st = render.render_gbuffer(sc, device=dev)
        hit = np.isfinite(aovs["depth"])
        nrm = np.linalg.norm(aovs["N"][hit], axis=-1)
        print(f"render_gbuffer {what} {sc.width}x{sc.height}: "
              f"{st['render_time']:.3f} s, "
              f"{hit.mean():.4f} of pixels hit, albedo mean "
              f"{aovs['albedo'][hit].mean():.4f}", flush=True)
        if not (hit.any() and np.allclose(nrm, 1.0, atol=1e-3)
                and np.isfinite(aovs["P"]).all()):
            raise AssertionError(f"render_gbuffer {what}: bad channels")
    small = [render.render_gbuffer(cornell_room(32, 24, 1, d), device=d)[0]
             for d in (dev, torch.device("cpu"))]
    for k in small[0]:
        close = np.isclose(small[0][k], small[1][k], rtol=1e-5, atol=1e-5)
        if close.reshape(24, 32, -1).all(-1).mean() < 0.99:
            raise AssertionError(f"render_gbuffer 32x24 {k}: card and CPU "
                                 "disagree")
    img, aovs, st = render.render_with_aovs(replace(room, integrator="path"),
                                            device=dev)
    var = aovs["variance"]
    rel = abs(float(img.mean()) - room_means["path"]) / room_means["path"]
    print(f"render_with_aovs room {room.width}x{room.height} spp 2: "
          f"{st['render_time']:.3f} s, mean {img.mean():.6f} vs phase 24's "
          f"path {room_means['path']:.6f} (rel diff {rel:.4e}), variance "
          f"mean {var.mean():.4e}", flush=True)
    if not (np.isfinite(var).all() and var.mean() > 0
            and rel < FULL_MEAN_TOL):
        raise AssertionError("render_with_aovs: bad variance, or the mean "
                             "is not within 2% of phase 24's")


def scene_file_text(block, width, height):
    """A .pbrt file stating presets.cloud's scene at width x height, spp 1,
    max depth 16 (phase 8's), around the "uniformgrid" parameter `block`
    that nanovdb2pbrt printed: the camera's world-to-camera matrix, fov
    31.07 and the Gaussian filter; the medium's p0 / p1 (in the block),
    scale, g, sigma_a 0 and sigma_s 1; the sun (scale 2.6, the preset's
    direction) and the uniform sky (scale 0.03)."""
    from acceleratedvolrenderer_tpu_torch.scene import presets

    w2c = " ".join(repr(float(v)) for v in presets.CLOUD_W2C.T.reshape(-1))
    sun = " ".join(repr(float(v)) for v in presets.CLOUD_SUN_DIR)
    return (
        "# presets.cloud: the disney-cloud 720p analog\n"
        f"Transform [ {w2c} ]\n"
        'Camera "perspective" "float fov" [31.07]\n'
        f'Film "rgb" "integer xresolution" [{width}] '
        f'"integer yresolution" [{height}] "string filename" "cloud.exr"\n'
        'PixelFilter "gaussian"\n'
        'Sampler "independent" "integer pixelsamples" [1]\n'
        'Integrator "volpath" "integer maxdepth" [16]\n'
        "WorldBegin\n"
        'LightSource "distant" "rgb L" [1 1 1] "float scale" [2.6]\n'
        f'    "point3 from" [0 0 0] "point3 to" [{sun}]\n'
        'LightSource "infinite" "rgb L" [1 1 1] "float scale" [0.03]\n'
        "AttributeBegin\n"
        'MakeNamedMedium "cloud" "string type" "uniformgrid"\n'
        + block +
        '    "rgb sigma_a" [0 0 0] "rgb sigma_s" [1 1 1]\n'
        '    "float scale" [0.2] "float g" [0.877]\n'
        'MediumInterface "cloud" ""\n'
        'Material ""\n'
        'Shape "sphere" "float radius" [174]\n'
        "AttributeEnd\n")


def fog_box_file_text(res, spp):
    """A .pbrt file stating presets.fog_box's scene (a homogeneous unit box,
    sigma_a 0.5, sigma_s 2, a distant light of 3 and a sky of 0.1) at
    res x res and spp."""
    return (
        "LookAt 0.5 0.5 -2.6  0.5 0.5 0.5  0 1 0\n"
        'Camera "perspective" "float fov" [35]\n'
        f'Film "rgb" "integer xresolution" [{res}] '
        f'"integer yresolution" [{res}]\n'
        f'Sampler "independent" "integer pixelsamples" [{spp}]\n'
        'Integrator "volpath" "integer maxdepth" [5]\n'
        "WorldBegin\n"
        'LightSource "distant" "rgb L" [1 1 1] "float scale" [3]\n'
        '    "point3 from" [0 0 0] "point3 to" [0.3 -1 0.4]\n'
        'LightSource "infinite" "rgb L" [1 1 1] "float scale" [0.1]\n'
        "AttributeBegin\n"
        'MakeNamedMedium "fog" "string type" "homogeneous"\n'
        '    "rgb sigma_a" [0.5 0.5 0.5] "rgb sigma_s" [2 2 2]\n'
        'MediumInterface "fog" ""\n'
        'Material ""\n'
        'Shape "sphere" "float radius" [1]\n'
        "AttributeEnd\n")


class _Interrupt(Exception):
    """Stops a checkpointed render once its first checkpoint has landed."""


def run_cli(argv):
    """cli/pbrt.py's main(argv); returns the JSON of its --stats line."""
    import contextlib
    import io

    from acceleratedvolrenderer_tpu_torch.cli import pbrt

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = pbrt.main(argv)
    if rc != 0:
        raise AssertionError(f"pbrt {argv}: exit code {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def checkpoint_leg(dev, work, card):
    """Phase 28's fog box file through `--checkpoint`: an uninterrupted
    render at spp 8, then the checkpointed one stopped once its first
    checkpoint lands (after 4 samples) and resumed by the same command;
    the two EXRs equal bit for bit, the gather launched once per loop
    iteration of each run.  Returns the gather launches of both runs."""
    from acceleratedvolrenderer_tpu_torch.parallel import checkpoint
    from acceleratedvolrenderer_tpu_torch.utils.image import read_exr

    path = work / "fog.pbrt"
    path.write_text(fog_box_file_text(256, 8))
    ref, out, ck = (str(work / n) for n in ("fog_ref.exr", "fog.exr",
                                             "fog_ck.npz"))
    launches = 0
    zero_kernel_counts()
    st = run_cli([str(path), "-o", ref, "--stats"])
    counts = kernel_counts()
    if counts != (0, st["iterations"], 0):
        raise AssertionError(f"fog box file: launches {counts} for "
                             f"{st['iterations']} iterations")
    launches += counts[1]
    argv = [str(path), "-o", out, "--stats", "--checkpoint", ck,
            "--checkpoint-every", "4"]
    save = checkpoint.save

    def save_then_stop(*args, **kw):
        save(*args, **kw)
        raise _Interrupt

    t0 = time.time()
    with mock.patch.object(checkpoint, "save", save_then_stop):
        try:
            run_cli(argv)
        except _Interrupt:
            pass
        else:
            raise AssertionError("fog box file: no checkpoint was written")
    if not Path(ck).exists() or Path(out).exists():
        raise AssertionError("fog box file: the stopped run left no "
                             "checkpoint, or an image")
    t1 = time.time()
    zero_kernel_counts()
    st = run_cli(argv)
    counts = kernel_counts()
    a, b = read_exr(out)[0], read_exr(ref)[0]
    print(f"fog box file 256x256 spp 8: uninterrupted, stopped after its "
          f"first checkpoint ({t1 - t0:.1f} s) and resumed from sample "
          f"{st['resumed_from']} ({st['render_time']:.3f} s, "
          f"{st['iterations']} iterations, (march, gather, dma) launches "
          f"{counts}): resumed EXR equals the uninterrupted one bit for "
          f"bit: {np.array_equal(a, b)}, checkpoint removed: "
          f"{not Path(ck).exists()}, on {card}", flush=True)
    if not (np.array_equal(a, b) and st["resumed_from"] == 4
            and not Path(ck).exists()):
        raise AssertionError("fog box file: the resumed render differs from "
                             "the uninterrupted one")
    if counts != (0, st["iterations"], 0):
        raise AssertionError(f"fog box file resumed: launches {counts} for "
                             f"{st['iterations']} iterations")
    return launches + counts[1]


def phase_scene_file(dev, scene, wave_img, card, keep=None):
    """Phase 28: phase 8's density through a .nvdb, nanovdb2pbrt and a
    .pbrt file to the CLI's 1280x720 frame (see the module docstring);
    scene is phase 8's, wave_img phase 14's frame; nanovdb2pbrt's block
    is kept as keep / "grid.txt" when keep (a directory) is given.
    Returns the march launches of the CLI frame and the gather launches
    of the fog-box leg."""
    import contextlib
    import tempfile

    from acceleratedvolrenderer_tpu_torch.cli import nanovdb2pbrt
    from acceleratedvolrenderer_tpu_torch.models import film
    from acceleratedvolrenderer_tpu_torch.parallel import render
    from acceleratedvolrenderer_tpu_torch.scene import parser
    from acceleratedvolrenderer_tpu_torch.utils import image, nvdb

    tmp = tempfile.TemporaryDirectory()
    work = Path(tmp.name)
    density = scene.medium.density.cpu().numpy()
    n = density.shape[0]
    half = 100.0
    t0 = time.time()
    nvdb.write_nvdb(str(work / "cloud.nvdb"), nvdb.NvdbGrid(
        name="density", data=density, index_min=(-n // 2,) * 3,
        world_bbox=np.array([[-half] * 3, [half] * 3]),
        voxel_size=np.full(3, 2 * half / n)))
    t1 = time.time()
    nanovdb2pbrt.main([str(work / "cloud.nvdb"), "-o",
                       str(work / "grid.txt")])
    block = (work / "grid.txt").read_text()
    t2 = time.time()
    path = work / "cloud.pbrt"
    path.write_text(scene_file_text(block, scene.width, scene.height))
    ref = str(work / "phase14.exr")
    image.write_exr(ref, wave_img)
    print(f"scene file: nvdb write {t1 - t0:.2f} s "
          f"({(work / 'cloud.nvdb').stat().st_size / 2 ** 20:.1f} MiB), "
          f"nanovdb2pbrt {t2 - t1:.2f} s ({len(block) / 2 ** 20:.1f} MiB of "
          f"text), scene file {path.stat().st_size / 2 ** 20:.1f} MiB",
          flush=True)

    # time the CLI's parse, EXR write and PNG write by wrapping what it
    # calls
    steps, parsed = {}, []
    load_scene, write_film = parser.load_scene, film.write_film
    write_png = image.write_png

    def timed_load(*args, **kw):
        t = time.time()
        parsed.append(load_scene(*args, **kw))
        steps["parse"] = time.time() - t
        return parsed[-1]

    def timed_write(*args, **kw):
        t = time.time()
        write_film(*args, **kw)
        steps["exr write"] = time.time() - t

    def timed_png(*args, **kw):
        t = time.time()
        write_png(*args, **kw)
        steps["png write"] = time.time() - t

    out = str(work / "cloud.exr")
    torch.cuda.reset_peak_memory_stats(dev)
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(parser, "load_scene",
                                              timed_load))
        stack.enter_context(mock.patch.object(film, "write_film",
                                              timed_write))
        stack.enter_context(mock.patch.object(image, "write_png", timed_png))
        zero_kernel_counts()
        t3 = time.time()
        st = run_cli([str(path), "-o", out, "--spp", "1", "--stats",
                      "--mse-reference-image", ref, "--write-png"])
        t4 = time.time()
        counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    t5 = time.time()
    img = image.read_exr(out)[0]
    t6 = time.time()
    mean14 = float(wave_img.mean())
    rel = abs(float(img.mean()) - mean14) / mean14
    print(f"scene file: pbrt {scene.width}x{scene.height} spp 1: parse "
          f"{steps['parse']:.2f} s, render {st['render_time']:.3f} s "
          f"({st['iterations']} iterations, {st['chunk_iterations']} per "
          f"chunk, {st['rays_per_sec'] / 1e6:.4f} Mrays/s), EXR write "
          f"{steps['exr write']:.2f} s, read back {t6 - t5:.2f} s, the "
          f"CLI call {t4 - t3:.2f} s; (march, gather, dma) launches "
          f"{counts}; peak device memory {peak:.3f} GiB; MSE against phase "
          f"14's frame {st['mse']:.6e}; film mean {img.mean():.6f} vs phase "
          f"14's {mean14:.6f} (rel diff {rel:.4e}) on {card}", flush=True)
    _check_frame("scene file", img, (scene.height, scene.width, 3))
    if counts != (st["iterations"], 0, 0):
        raise AssertionError(f"scene file: launches {counts} for "
                             f"{st['iterations']} iterations")
    cli_png_check(work / "cloud.png", img, steps["png write"], card)
    if rel > FULL_MEAN_TOL:
        raise AssertionError("scene file: mean not within 2% of phase 14's")

    # the parsed grid: the values its text states, bit for bit
    sc = parsed[0]
    grid = sc.medium.density.cpu().numpy()
    start = block.index('"float density" [') + len('"float density" [')
    stated = np.array(block[start:block.rindex("]")].split(),
                      np.float64).astype(np.float32).reshape(grid.shape)
    err = float(np.abs(grid[:n, :n, :n] - density).max())
    print(f"scene file: parsed grid {grid.shape}, equal to its text bit for "
          f"bit: {np.array_equal(grid, stated)}, extra layer zero: "
          f"{not grid[n:].any() and not grid[:, n:].any() and not grid[..., n:].any()}"
          f", max |parsed - preset| {err:.3e}, bounds {sc.medium.bounds_lo} "
          f"{sc.medium.bounds_hi}", flush=True)
    if not (np.array_equal(grid, stated) and grid.shape == (n + 1,) * 3
            and not grid[n:].any() and not grid[:, n:].any()
            and not grid[..., n:].any() and err <= GRID_TEXT_TOL):
        raise AssertionError("scene file: the parsed grid is not the one "
                             "the file states")
    small = replace(sc, camera=sc.camera._replace(width=32, height=24))
    imgs = [render.render(small, device=dev)[0],
            render.render(small.to("cpu"), device="cpu")[0]]
    compare_frames("scene file 32x24 gpu vs cpu", *imgs)
    del parsed[:], sc, small
    gather_n = checkpoint_leg(dev, work, card)
    if keep is not None:
        shutil.move(str(work / "grid.txt"), str(Path(keep) / "grid.txt"))
    tmp.cleanup()
    return counts[0], gather_n


def old_png_bytes(px):
    """The PNG encoder the port had before it took PIL's recipe: every row
    unfiltered, zlib.compress at level 6, one IDAT; (its bytes, seconds)."""
    import zlib

    t = time.time()
    raw = np.concatenate([np.zeros((px.shape[0], 1), np.uint8),
                          px.reshape(px.shape[0], -1)], 1)
    n = len(zlib.compress(raw.tobytes(), 6)) + 8 + 25 + 12 + 12
    return n, time.time() - t


def cli_png_check(path, img, write_s, card):
    """Phase 28's --write-png frame: decode_png of the CLI's PNG equals
    to_8bit of the same run's EXR frame; its bytes, the CLI's write and
    encode_png's seconds, the rows' filter types, and the old encoder's
    bytes and seconds beside them."""
    import zlib

    from acceleratedvolrenderer_tpu_torch.utils import image

    data = Path(path).read_bytes()
    want = image.to_8bit(img)
    if not np.array_equal(image.decode_png(data), want):
        raise AssertionError("scene file: the CLI's PNG is not the frame's "
                             "8-bit samples")
    t = time.time()
    again = image.encode_png(want)
    enc = time.time() - t
    if again != data:
        raise AssertionError("scene file: the CLI's PNG is not encode_png's")
    stream = np.frombuffer(png_idat_stream(data), np.uint8)
    types = stream[::1 + want.shape[1] * want.shape[2]]
    hist = {int(k): int(v) for k, v in zip(*np.unique(types,
                                                      return_counts=True))}
    old, old_s = old_png_bytes(want)
    print(f"scene file: --write-png {want.shape[1]}x{want.shape[0]}: "
          f"{len(data)} bytes (the unfiltered level-6 encoder: {old} bytes, "
          f"{old / len(data):.3f}x; {old_s:.3f} s), CLI write {write_s:.3f} "
          f"s, encode_png {enc:.3f} s, rows by filter type {hist}, equal to "
          f"the EXR frame's to_8bit; zlib {zlib.ZLIB_RUNTIME_VERSION}; "
          f"{card}", flush=True)


def room_file_text(width, height, spp=1):
    """A .pbrt file of a small room: a diffuse floor, back wall and ceiling
    of 0.7, a red left wall, a two-sided emissive quad under the ceiling,
    a glass sphere and a diffuse one, a point light; max depth 5."""
    quad = lambda p: ('Shape "trianglemesh" "point3 P" [' + p
                      + '] "integer indices" [0 1 2 0 2 3]\n')
    return (
        "LookAt 0 1 -2.8  0 1 1  0 1 0\n"
        'Camera "perspective" "float fov" [40]\n'
        f'Film "rgb" "integer xresolution" [{width}] '
        f'"integer yresolution" [{height}]\n'
        f'Sampler "independent" "integer pixelsamples" [{spp}]\n'
        'Integrator "path" "integer maxdepth" [5]\n'
        "WorldBegin\n"
        'LightSource "point" "point3 from" [0.5 1.6 0.6] "rgb I" [1 1 1]\n'
        "AttributeBegin\n"
        'Material "diffuse" "rgb reflectance" [0.7 0.7 0.7]\n'
        + quad("-1 0 0  1 0 0  1 0 2  -1 0 2")
        + quad("-1 0 2  1 0 2  1 2 2  -1 2 2")
        + quad("-1 2 0  1 2 0  1 2 2  -1 2 2") +
        "AttributeEnd\n"
        "AttributeBegin\n"
        'Material "diffuse" "rgb reflectance" [0.63 0.06 0.05]\n'
        + quad("-1 0 0  -1 2 0  -1 2 2  -1 0 2") +
        "AttributeEnd\n"
        "AttributeBegin\n"
        'AreaLightSource "diffuse" "rgb L" [8 8 8] "bool twosided" [true]\n'
        + quad("-0.45 1.98 0.55  0.45 1.98 0.55  0.45 1.98 1.45  "
               "-0.45 1.98 1.45") +
        "AttributeEnd\n"
        "AttributeBegin\n"
        'Material "dielectric" "float eta" [1.5]\n'
        "Translate -0.4 0.35 0.9\n"
        'Shape "sphere" "float radius" [0.35]\n'
        "AttributeEnd\n"
        "AttributeBegin\n"
        'Material "diffuse" "rgb reflectance" [0.5 0.5 0.5]\n'
        "Translate 0.45 0.3 1.3\n"
        'Shape "sphere" "float radius" [0.3]\n'
        "AttributeEnd\n")


def lum_mean(img):
    return float((img @ LUM).mean())


def block_corr(a, b):
    """The luminance correlation of two frames averaged over MLT_BLOCK x
    MLT_BLOCK pixels (the whole blocks: a 1280x720 frame gives 22 x 40)."""
    block = MLT_BLOCK
    H, W = a.shape[0] // block * block, a.shape[1] // block * block
    pool = lambda img: (img[:H, :W] @ LUM).reshape(
        H // block, block, W // block, block).mean((1, 3)).reshape(-1)
    return float(np.corrcoef(pool(a), pool(b))[0, 1])


def check_close(what, a, b, mean_tol=INTEG_MEAN_TOL,
                share=INTEG_PIXEL_SHARE):
    """Two frames of one integrator: means to mean_tol relative and a share
    of the pixels to rtol 1e-3 / atol 1e-5."""
    rel = abs(a.mean() - b.mean()) / b.mean()
    close = np.isclose(a, b, rtol=1e-3, atol=1e-5).all(-1).mean()
    print(f"{what}: mean {a.mean():.7f} vs {b.mean():.7f} (rel diff "
          f"{rel:.3e}), max |diff| {np.abs(a - b).max():.3e}, pixels close "
          f"{close:.4f}", flush=True)
    if not (np.isfinite(a).all() and b.mean() > 0 and rel < mean_tol
            and close >= share):
        raise AssertionError(f"{what}: frames disagree")


LEG_COUNTS = []      # each full-size leg's (march, gather, dma) launches


def integrator_leg(what, fn, dev, card, n_work, unit):
    """One full-size render of phase 29: its seconds, work per second, peak
    device memory and launches (none of the three kernels)."""
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_kernel_counts()
    t0 = time.time()
    img, st = fn()[:2]
    torch.cuda.synchronize(dev)
    wall = time.time() - t0
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"{what} {img.shape[1]}x{img.shape[0]}: {wall:.3f} s wall "
          f"({st.get('render_time', 0.0):.3f} s in its loop), "
          f"{n_work / wall / 1e6:.4f} M{unit}/s, luminance mean "
          f"{lum_mean(img):.6f}, peak device memory {peak:.3f} GiB, (march, "
          f"gather, dma) launches {counts} on {card}", flush=True)
    _check_frame(what, img, img.shape)
    if counts != (0, 0, 0):
        raise AssertionError(f"{what}: launched a kernel {counts}")
    LEG_COUNTS.append(counts)
    return img, st


def integrators_gpu_cpu(dev):
    """The four through their entries at 32x24 on the GPU and the CPU: the
    room (light path, SPPM, MLT; MLT's chain numbers from the same seeded
    CPU generator on both) and the 32^3 cloud (BDPT)."""
    from acceleratedvolrenderer_tpu_torch.models.integrators import (
        bdpt, mlt, sppm)
    from acceleratedvolrenderer_tpu_torch.parallel import render
    from acceleratedvolrenderer_tpu_torch.scene import presets

    legs = {
        "lightpath": lambda d: render.render_lightpath(
            cornell_room(32, 24, 1, d), device=d),
        "sppm": lambda d: sppm.render_sppm(
            cornell_room(32, 24, 1, d), n_iterations=SPPM_ITERATIONS,
            device=d),
        "bdpt": lambda d: bdpt.render_bdpt(
            presets.cloud(**SMALL, device=d), max_depth=BDPT_DEPTH, spp=1,
            keep_strategies=False, device=d),
        "mlt": lambda d: mlt.render_mlt(
            cornell_room(32, 24, 1, d), n_chains=1024, n_mutations=2,
            n_bootstrap=2048, device=d),
    }
    for name, fn in legs.items():
        imgs, secs = [], []
        for d in (dev, torch.device("cpu")):
            t0 = time.time()
            imgs.append(fn(d)[0])
            secs.append(time.time() - t0)
        print(f"{name} 32x24: gpu {secs[0]:.2f} s, cpu {secs[1]:.2f} s",
              flush=True)
        check_close(f"{name} 32x24 gpu vs cpu", *imgs,
                    **(dict(mean_tol=0.15, share=0.0) if name == "mlt"
                       else {}))


def integrators_cli(dev, card):
    """The four through cli/pbrt.py on 32x24 files on the card and with
    --cpu: the room file (light path, SPPM, MLT) and the fog box (BDPT)."""
    import tempfile

    from acceleratedvolrenderer_tpu_torch.utils import image

    tmp = tempfile.TemporaryDirectory()
    work = Path(tmp.name)
    (work / "room.pbrt").write_text(room_file_text(32, 24))
    (work / "fog.pbrt").write_text(fog_box_file_text(24, 1))
    for integ in ("lightpath", "sppm", "bdpt", "mlt"):
        scene = work / ("fog.pbrt" if integ == "bdpt" else "room.pbrt")
        imgs = []
        for extra in ([], ["--cpu"]):
            out = str(work / f"{integ}{len(extra)}.exr")
            zero_kernel_counts()
            # max depth 1: the CPU side of MLT's default chains (4,096 x
            # 64 mutations) sets this leg's time
            st = run_cli([str(scene), "--integrator", integ, "--stats",
                          "--maxdepth", "1", "-o", out, *extra])
            counts = kernel_counts()
            imgs.append(image.read_exr(out)[0][..., :3])
            print(f"cli {integ} {'cpu' if extra else 'gpu'}: "
                  f"{st['render_time']:.3f} s, launches {counts}"
                  + ("" if extra else f" on {card}"), flush=True)
            if counts != (0, 0, 0):
                raise AssertionError(f"cli {integ}: launched a kernel")
        check_close(f"cli {integ} 32x24 gpu vs cpu", *imgs,
                    **(dict(mean_tol=0.15, share=0.0) if integ == "mlt"
                       else {}))
    tmp.cleanup()


def sppm_small(dev, card):
    """The room at SPPM_SMALL by render_sppm (2 iterations of H*W photons)
    on the card: its luminance mean within INTEG_MEAN_TOL of the JAX
    package's on the CPU (SPPM_JAX_MEAN), and within the reference's gate
    of render() by path at spp 16 of the same size."""
    from acceleratedvolrenderer_tpu_torch.models.integrators import sppm
    from acceleratedvolrenderer_tpu_torch.parallel import render

    room = cornell_room(*SPPM_SMALL, 16, dev)
    img, st = sppm.render_sppm(room, n_iterations=SPPM_ITERATIONS,
                               device=dev)
    m = lum_mean(img)
    m_path = lum_mean(render.render(replace(room, integrator="path"),
                                    device=dev)[0])
    rel = abs(m - SPPM_JAX_MEAN) / SPPM_JAX_MEAN
    gate = 0.05 * m_path + 0.01
    print(f"sppm {SPPM_SMALL[0]}x{SPPM_SMALL[1]}: luminance mean {m:.6f} "
          f"({st['render_time']:.3f} s, truncated candidates "
          f"{st['truncated_candidates']}) vs the JAX package's "
          f"{SPPM_JAX_MEAN:.6f} (rel diff {rel:.4e}, tol {INTEG_MEAN_TOL}) "
          f"and path spp 16 {m_path:.6f} (|diff| {abs(m - m_path):.4e}, "
          f"gate {gate:.4e}) on {card}", flush=True)
    if rel >= INTEG_MEAN_TOL or abs(m - m_path) >= gate:
        raise AssertionError("sppm: the small room fails its checks")


def bdpt_small(dev, card):
    """presets.cloud at BDPT_SMALL over a BDPT_SMALL_GRID^3 grid by
    render_bdpt at BDPT_DEPTH, spp 1, on the card: its luminance mean
    within INTEG_MEAN_TOL of the JAX package's on the CPU
    (BDPT_JAX_MEAN)."""
    from acceleratedvolrenderer_tpu_torch.models.integrators import bdpt
    from acceleratedvolrenderer_tpu_torch.scene import presets

    sc = presets.cloud(*BDPT_SMALL, spp=1, max_depth=BDPT_DEPTH,
                       grid_res=BDPT_SMALL_GRID, device=dev)
    img, st, _ = bdpt.render_bdpt(sc, max_depth=BDPT_DEPTH, spp=1,
                                  keep_strategies=False, device=dev)
    m = lum_mean(img)
    rel = abs(m - BDPT_JAX_MEAN) / BDPT_JAX_MEAN
    print(f"bdpt {BDPT_SMALL[0]}x{BDPT_SMALL[1]}: luminance mean {m:.6f} "
          f"({st['render_time']:.3f} s) vs the JAX package's "
          f"{BDPT_JAX_MEAN:.6f} (rel diff {rel:.4e}, tol {INTEG_MEAN_TOL}) "
          f"on {card}", flush=True)
    if rel >= INTEG_MEAN_TOL:
        raise AssertionError("bdpt: the small cloud is off the JAX mean")


def phase_integrators(dev, scene, card):
    """Phase 29's full-size legs (see the module docstring); scene is phase
    8's, and FRAMES holds the side process's room and fog-box frames.
    Returns the (march, gather, dma) launches of the five legs, summed,
    and the march launches of the depth-4 render() frame."""
    from acceleratedvolrenderer_tpu_torch.models.integrators import (
        bdpt, mlt, sppm)
    from acceleratedvolrenderer_tpu_torch.parallel import render
    from acceleratedvolrenderer_tpu_torch.scene import presets

    room = cornell_room(*FULL, 1, dev)
    ref = FRAMES[("room", "path")]
    m_ref = lum_mean(ref)
    n_pix = room.width * room.height

    img, _ = integrator_leg("lightpath", lambda: render.render_lightpath(
        room, device=dev), dev, card, n_pix, "paths")
    rel = abs(lum_mean(img) - m_ref) / m_ref
    print(f"lightpath: luminance mean vs phase 24's path frame "
          f"{m_ref:.6f}: rel diff {rel:.4e} (gate 0.15)", flush=True)
    if rel >= 0.15:
        raise AssertionError("lightpath: mean not within 15% of path's")

    img, st = integrator_leg("sppm", lambda: sppm.render_sppm(
        room, n_iterations=SPPM_ITERATIONS, device=dev), dev, card,
        SPPM_ITERATIONS * 2 * n_pix, "rays")
    m = lum_mean(img)
    gate = 0.05 * m_ref + 0.01
    print(f"sppm: {SPPM_ITERATIONS} iterations of {n_pix} photons, "
          f"truncated candidates {st['truncated_candidates']}; luminance "
          f"mean {m:.6f} vs {m_ref:.6f}: |diff| {abs(m - m_ref):.4e} "
          f"(gate {gate:.4e}: {'passes' if abs(m - m_ref) < gate else 'fails'}"
          "; a gap the reference shares, see SPPM_SMALL)", flush=True)
    if st["truncated_candidates"] <= 0:
        raise AssertionError("sppm: the cap is not reached, so the gap is "
                             "not the reference's")

    img, _ = integrator_leg("mlt", lambda: mlt.render_mlt(
        room, n_chains=MLT_CHAINS, n_mutations=MLT_MUTATIONS,
        n_bootstrap=MLT_BOOTSTRAP, device=dev), dev, card,
        MLT_CHAINS * MLT_MUTATIONS, "mutations")
    rel = abs(lum_mean(img) - m_ref) / m_ref
    corr = block_corr(img, ref)
    print(f"mlt: luminance mean rel diff to phase 24's path frame "
          f"{rel:.4e} (gate 0.15), {MLT_BLOCK}x{MLT_BLOCK}-block "
          f"luminance correlation {corr:.4f} (gate 0.8)", flush=True)
    if rel >= 0.15 or corr <= 0.8:
        raise AssertionError("mlt: the room frame fails the gates")

    fog = presets.fog_box(res=256, device=dev)
    fog_ref = FRAMES[("fog box", "render")]
    img, _ = integrator_leg("mlt vol", lambda: mlt.render_mlt(
        fog, n_chains=MLT_VOL_CHAINS, n_mutations=MLT_VOL_MUTATIONS,
        n_bootstrap=MLT_VOL_CHAINS, device=dev), dev, card,
        MLT_VOL_CHAINS * MLT_VOL_MUTATIONS, "mutations")
    m_f = lum_mean(fog_ref)
    rel = abs(lum_mean(img) - m_f) / m_f
    lm, lr = img @ LUM, fog_ref @ LUM
    bm, br = lm > np.percentile(lm, 60), lr > np.percentile(lr, 60)
    overlap = float((bm & br).sum() / max(br.sum(), 1))
    print(f"mlt vol: luminance mean rel diff to phase 15's render() frame "
          f"{rel:.4e} (gate 0.15), 60th-percentile overlap {overlap:.4f} "
          f"(gate 0.5)", flush=True)
    if rel >= 0.15 or overlap <= 0.5:
        raise AssertionError("mlt vol: the fog box fails the gates")

    deep = replace(scene, max_depth=BDPT_DEPTH)
    img, _ = integrator_leg("bdpt", lambda: bdpt.render_bdpt(
        deep, max_depth=BDPT_DEPTH, spp=1, keep_strategies=False,
        device=dev), dev, card, n_pix, "camera paths")
    zero_kernel_counts()
    img_r, st_r = render.render(deep, spp=1, device=dev)
    counts = kernel_counts()
    if counts != (st_r["iterations"], 0, 0):
        raise AssertionError(f"bdpt: the render() frame launched {counts}")
    m_b, m_r = lum_mean(img), lum_mean(img_r)
    rel = abs(m_b - m_r) / m_r
    print(f"bdpt: luminance mean {m_b:.6f} vs render() at max_depth "
          f"{BDPT_DEPTH}, spp 1 {m_r:.6f} ({st_r['render_time']:.3f} s, "
          f"{counts[0]} march launches): rel diff {rel:.4e} (gate 0.12: "
          f"{'passes' if rel < 0.12 else 'fails'}; a gap the reference "
          "shares, see BDPT_SMALL)", flush=True)
    return tuple(int(sum(c)) for c in zip(*LEG_COUNTS)), counts[0]


def phase_integrators_small(dev, card):
    """Phase 29's small legs, in the side process: SPPM and BDPT at their
    small sizes against the JAX package's means, and the four through the
    CLI and through their entries at 32x24 on the GPU and the CPU."""
    sppm_small(dev, card)
    bdpt_small(dev, card)
    integrators_cli(dev, card)
    integrators_gpu_cpu(dev)


# ---------------------------------------------------------------------------
# Phase 30: the MIP map, the subsurface and measured materials, hair and the
# tools (imgtool with FLIP, plytool, cyhair2pbrt, rgb2spec_opt)
# ---------------------------------------------------------------------------

ITEM1_BSDF_ALPHA = 0.3
SUBSURFACE_MATERIAL = ('Material "subsurface" "rgb reflectance" [0.8 0.5 0.3]'
                       ' "rgb mfp" [0.05 0.05 0.05] "float eta" [1.33]\n')
BURLEY_GATE = 0.12              # tests/test_bssrdf.py's tabulated-vs-Burley
MIP_RES = 1024
MIP_LOOKUPS = 262144
HAIR_LANES = 1 << 20
HAIR_CHECK_LANES = 65536
RGB2SPEC_RES = 64               # pbrt's own build setting
RGB2SPEC_CHECKS = 64
ITEM1_COUNTS = []               # each leg's (march, gather, dma) launches


def item1_file_text(width, height, bsdf, spp=1, bdpt=False):
    """room_file_text with the glass sphere subsurface (reflectance 0.8 0.5
    0.3, mfp 0.05, eta 1.33) and the diffuse sphere measured (the .bsdf
    file `bsdf`).  bdpt: with a distant light and a thin homogeneous fog
    sphere over the room, which BDPT needs."""
    text = room_file_text(width, height, spp)
    for old, new in (
            ('Material "dielectric" "float eta" [1.5]\n',
             SUBSURFACE_MATERIAL),
            ('Material "diffuse" "rgb reflectance" [0.5 0.5 0.5]\n',
             f'Material "measured" "string filename" ["{bsdf}"]\n')):
        if text.count(old) != 1:
            raise AssertionError(f"room_file_text: {old!r} not once")
        text = text.replace(old, new)
    if bdpt:
        text += (
            'LightSource "distant" "rgb L" [1 1 1] "float scale" [3]\n'
            '    "point3 from" [0 0 0] "point3 to" [0.3 -1 0.4]\n'
            "AttributeBegin\n"
            'MakeNamedMedium "fog" "string type" "homogeneous"\n'
            '    "rgb sigma_a" [0.05 0.05 0.05] "rgb sigma_s" [0.2 0.2 0.2]\n'
            'MediumInterface "fog" ""\n'
            'Material ""\n'
            "Translate 0 1 1\n"
            'Shape "sphere" "float radius" [1.8]\n'
            "AttributeEnd\n")
    return text


def write_ggx_bsdf(path):
    """measured.synthesize_ggx(alpha=ITEM1_BSDF_ALPHA) saved as a .bsdf."""
    from acceleratedvolrenderer_tpu_torch.models import measured

    measured.write_tensor_file(str(path), measured.tensors_of(
        measured.synthesize_ggx(alpha=ITEM1_BSDF_ALPHA)))


def item1_leg(what, fn, dev, card, n_work, unit):
    """One leg of phase 30 on the card: its seconds, work per second and
    peak device memory beside the card, and its (march, gather, dma)
    launches, kept in ITEM1_COUNTS."""
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_kernel_counts()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize(dev)
    wall = time.time() - t0
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"{what}: {wall:.3f} s wall, {n_work / wall / 1e6:.4f} M{unit}/s, "
          f"peak device memory {peak:.3f} GiB, (march, gather, dma) "
          f"launches {counts} on {card}", flush=True)
    ITEM1_COUNTS.append(counts)
    return out


def subsurface_ball(width, height, profile, device):
    """tests/test_bssrdf.py::test_tabulated_profile_render_matches_burley's
    scene: a unit subsurface sphere (reflectance 0.6 0.5 0.4, mfp 0.05)
    under a uniform sky of 1, by `path` at max depth 5."""
    from acceleratedvolrenderer_tpu_torch.models import lights, materials
    from acceleratedvolrenderer_tpu_torch.models import shapes
    from acceleratedvolrenderer_tpu_torch.models.cameras import (
        PerspectiveCamera)
    from acceleratedvolrenderer_tpu_torch.models.film import BoxFilter
    from acceleratedvolrenderer_tpu_torch.scene.types import Scene
    from acceleratedvolrenderer_tpu_torch.utils.spectrum import (
        constant_spectrum)
    from acceleratedvolrenderer_tpu_torch.utils.vecmath import look_at

    ball = shapes.Sphere(center=np.zeros(3), radius=1.0,
                         material=materials.SubsurfaceMaterial(
                             reflectance_rgb=(0.6, 0.5, 0.4),
                             mfp_rgb=(0.05, 0.05, 0.05), profile=profile))
    cam = PerspectiveCamera(c2w=look_at((0, 0.4, -3.2), (0, 0, 0), (0, 1, 0),
                                        device),
                            fov_deg=36.0, width=width, height=height)
    return Scene(camera=cam, medium=None,
                 lights=[lights.UniformInfiniteLight(
                     spectrum=constant_spectrum(1.0), scene_radius=30.0)],
                 primitives=[ball], max_depth=5, filter=BoxFilter(), spp=1,
                 scene_radius=30.0, integrator="path")


def item1_frame(dev, work, card):
    """(a): the room file with a subsurface and a measured sphere by the
    CLI at 1280x720 spp 1; its subsurface sphere not black; the 32x24 file
    on the GPU and with --cpu."""
    from acceleratedvolrenderer_tpu_torch.models import materials
    from acceleratedvolrenderer_tpu_torch.scene.parser import load_scene
    from acceleratedvolrenderer_tpu_torch.utils import image

    bsdf = work / "ggx.bsdf"
    t0 = time.time()
    write_ggx_bsdf(bsdf)
    print(f"item1: ggx.bsdf (synthesize_ggx alpha {ITEM1_BSDF_ALPHA}, "
          f"64^2 x 16) written in {time.time() - t0:.3f} s", flush=True)
    path = work / "item1.pbrt"
    path.write_text(item1_file_text(*FULL, bsdf))
    out = str(work / "item1.exr")
    st = item1_leg(f"item1 room {FULL[0]}x{FULL[1]} spp 1 (pbrt CLI)",
                   lambda: run_cli([str(path), "--spp", "1", "--stats",
                                    "-o", out]),
                   dev, card, FULL[0] * FULL[1], "rays")
    img = image.read_exr(out)[0][..., :3]
    _check_frame("item1 room", img, (FULL[1], FULL[0], 3))
    sc = load_scene(str(path), device="cpu")
    ss = [i for i, p in enumerate(sc.primitives)
          if isinstance(p.material, materials.SubsurfaceMaterial)]
    mask = first_hit_ids(sc) == ss[0]
    lum = img[mask] @ LUM
    lit = float((lum > 0).mean())
    print(f"item1 room: render {st['render_time']:.3f} s, luminance mean "
          f"{lum_mean(img):.6f}; the subsurface sphere's {int(mask.sum())} "
          f"pixels: luminance mean {lum.mean():.6f}, {lit:.4f} of them "
          f"non-black", flush=True)
    if not (mask.sum() > 0 and lum.mean() > 0 and lit >= 0.5):
        raise AssertionError("item1 room: the subsurface sphere is black")
    small = work / "item1_small.pbrt"
    small.write_text(item1_file_text(32, 24, bsdf))
    imgs = []
    for extra in ([], ["--cpu"]):
        o = str(work / f"item1_small{len(extra)}.exr")
        run_cli([str(small), "--stats", "-o", o, *extra])
        imgs.append(image.read_exr(o)[0][..., :3])
    check_close("item1 room 32x24 gpu vs cpu", *imgs)
    return bsdf


def item1_burley(dev, work, card):
    """(b): the subsurface ball at 1280x720 spp 1 by render() with each
    profile; the tabulated mean within BURLEY_GATE of Burley's.  Returns
    the two EXR paths."""
    from acceleratedvolrenderer_tpu_torch.models import bssrdf
    from acceleratedvolrenderer_tpu_torch.parallel import render
    from acceleratedvolrenderer_tpu_torch.utils import image

    bssrdf._beam_diffusion_table.cache_clear()
    t0 = time.time()
    bssrdf.compute_beam_diffusion_table(g=0.0, eta=1.33)
    print(f"item1 beam diffusion table (40 rho x 64 radii, host numpy): "
          f"{time.time() - t0:.3f} s", flush=True)
    means, paths = {}, []
    for profile in ("burley", "tabulated"):
        sc = subsurface_ball(*FULL, profile, dev)
        img, st = item1_leg(f"item1 ball {profile} {FULL[0]}x{FULL[1]} spp 1",
                            lambda: render.render(sc, spp=1, device=dev),
                            dev, card, FULL[0] * FULL[1], "rays")
        _check_frame(f"item1 ball {profile}", img, (FULL[1], FULL[0], 3))
        means[profile] = float(img.mean())
        paths.append(str(work / f"ball_{profile}.exr"))
        image.write_exr(paths[-1], img)
    rel = abs(means["tabulated"] - means["burley"]) / means["burley"]
    print(f"item1 ball: tabulated mean {means['tabulated']:.6f} vs burley "
          f"{means['burley']:.6f}: rel diff {rel:.4e} (gate {BURLEY_GATE})",
          flush=True)
    if rel >= BURLEY_GATE:
        raise AssertionError("item1 ball: the profiles disagree")
    return paths


def item1_integrators(dev, work, bsdf, card):
    """(c): the light path, SPPM and BDPT through the CLI on (a)'s file at
    32x24 (BDPT's with a distant light and a thin fog), on the GPU and
    with --cpu, at INTEG_MEAN_TOL and INTEG_PIXEL_SHARE."""
    from acceleratedvolrenderer_tpu_torch.utils import image

    for integ in ("lightpath", "sppm", "bdpt"):
        path = work / f"item1_{integ}.pbrt"
        path.write_text(item1_file_text(32, 24, bsdf, bdpt=integ == "bdpt"))
        imgs = []
        for extra in ([], ["--cpu"]):
            out = str(work / f"item1_{integ}{len(extra)}.exr")
            if extra:
                st = run_cli([str(path), "--integrator", integ, "--stats",
                              "-o", out, *extra])
            else:
                st = item1_leg(f"item1 {integ} 32x24 (pbrt CLI)",
                               lambda: run_cli([str(path), "--integrator",
                                                integ, "--stats", "-o", out]),
                               dev, card, 32 * 24, "pixels")
            imgs.append(image.read_exr(out)[0][..., :3])
        check_close(f"item1 {integ} 32x24 gpu vs cpu", *imgs)


def cloud_with_item1(scene):
    """presets.cloud's scene with a subsurface sphere and a measured sphere
    half inside the medium box's face toward the camera (where
    cloud_with_surfaces puts its glass and metal spheres)."""
    from acceleratedvolrenderer_tpu_torch.models import materials, measured
    from acceleratedvolrenderer_tpu_torch.models import shapes

    ss = shapes.Sphere(center=np.array([100.0, -20.0, 70.0]), radius=40.0,
                       material=materials.SubsurfaceMaterial(
                           reflectance_rgb=(0.8, 0.5, 0.3),
                           mfp_rgb=(0.05, 0.05, 0.05)))
    me = shapes.Sphere(center=np.array([100.0, -30.0, -80.0]), radius=45.0,
                       material=materials.MeasuredMaterial(
                           brdf=measured.synthesize_ggx(
                               alpha=ITEM1_BSDF_ALPHA, res=16, n_theta=4)))
    return replace(scene, primitives=[ss, me])


ITEM1_FUSED_WARNING = ("fused volpath: material kind(s) MeasuredMaterial, "
                       "SubsurfaceMaterial approximate to a Lambert albedo "
                       "lobe in medium-bearing scenes")
ITEM1_CAPTURE_CALL = 20


def item1_fused(dev, card):
    """(d): presets.cloud at 32x24 over a 32^3 grid with cloud_with_item1's
    spheres by render() on the GPU and the CPU: the reference's warning,
    the frames to SURF_MEAN_TOL, the march launches, and one captured
    march call against its plain version."""
    import warnings

    from acceleratedvolrenderer_tpu_torch.ops import march
    from acceleratedvolrenderer_tpu_torch.parallel import render
    from acceleratedvolrenderer_tpu_torch.scene import presets

    captured, capture = march_capture(ITEM1_CAPTURE_CALL)
    imgs = []
    for d in (dev, torch.device("cpu")):
        sc = cloud_with_item1(presets.cloud(**SMALL, device=d))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if not imgs:
                with mock.patch.object(march, "march_block", capture):
                    img, st = item1_leg(
                        "item1 fused cloud 32x24 render()",
                        lambda: render.render(sc, device=d), dev, card,
                        32 * 24 * SMALL["spp"], "rays")
                counts = ITEM1_COUNTS[-1]
                if counts != (st["iterations"], 0, 0):
                    raise AssertionError(f"item1 fused: launches {counts}, "
                                         f"{st['iterations']} iterations")
            else:
                img, _ = render.render(sc, device=d)
        msgs = sorted({str(w.message) for w in caught
                       if "fused volpath" in str(w.message)})
        print(f"item1 fused on {d}: warnings {msgs}", flush=True)
        if msgs != [ITEM1_FUSED_WARNING]:
            raise AssertionError(f"item1 fused: warned {msgs}")
        imgs.append(img)
    compare_frames("item1 fused cloud 32x24 gpu vs cpu", *imgs,
                   mean_tol=SURF_MEAN_TOL)
    return check_captured_march("item1 fused", captured, ITEM1_CAPTURE_CALL)


def item1_mipmap(dev, card):
    """(e): a MIP_RES^2 RGB image's MIP map, MIP_LOOKUPS trilinear and EWA
    lookups on the card against the CPU at rtol 1e-5 / atol 1e-6, ms per
    call."""
    from acceleratedvolrenderer_tpu_torch.models.mipmap import MIPMap

    rng = np.random.default_rng(30)
    t0 = time.time()
    mip = MIPMap(rng.random((MIP_RES, MIP_RES, 3)).astype(np.float32))
    build = time.time() - t0
    n = MIP_LOOKUPS
    host = dict(uv=rng.uniform(-1, 2, (n, 2)),
                width=np.exp(rng.uniform(-9, 0, n)),
                duv0=rng.normal(size=(n, 2)) * np.exp(rng.uniform(-6, -1,
                                                               (n, 1))),
                duv1=rng.normal(size=(n, 2)) * np.exp(rng.uniform(-8, -2,
                                                               (n, 1))))
    host = {k: v.astype(np.float32) for k, v in host.items()}
    calls = dict(
        trilinear=lambda a: mip.lookup_trilinear(a["uv"], a["width"]),
        ewa=lambda a: mip.lookup_ewa(a["uv"], a["duv0"], a["duv1"]))
    for name, fn in calls.items():
        on = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
        cpu = {k: torch.as_tensor(v) for k, v in host.items()}
        got = item1_leg(f"item1 mipmap {name} {n} lookups", lambda: fn(on),
                        dev, card, n, "lookups").cpu().numpy()
        want = fn(cpu).numpy()
        err = float(np.abs(got - want).max())
        ms = time_ms(lambda: fn(on), 10)
        print(f"item1 mipmap {name}: {ms:.4f} ms per call of {n} lookups "
              f"({MIP_RES}^2 RGB, {mip.n_levels} levels, pyramid built in "
              f"{build:.3f} s on the host), card vs cpu max |diff| "
              f"{err:.3e} on {card}", flush=True)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=f"item1 mipmap {name}")


def item1_hair(dev, card):
    """(f): hair_sample (with its hair_f and hair_pdf) at HAIR_LANES lanes
    on the card with sigma_a 0: tests/test_hair.py's white furnace (albedo
    in 0.85-1.15) from the card's numbers; the first HAIR_CHECK_LANES
    against the CPU."""
    from acceleratedvolrenderer_tpu_torch.models import hair

    rng = np.random.default_rng(31)
    n = HAIR_LANES
    v = rng.normal(size=(n, 3))
    host = dict(wo=(v / np.linalg.norm(v, axis=1, keepdims=True)),
                h=rng.uniform(-1, 1, n), u=rng.random((n, 4)))
    host = {k: x.astype(np.float32) for k, x in host.items()}
    prm = hair.HairParams(beta_m=0.4, beta_n=0.4)

    def run(d, m):
        a = {k: torch.as_tensor(x[:m], device=d) for k, x in host.items()}
        return hair.hair_sample(a["wo"], a["h"], torch.zeros((m, 3),
                                                               device=d),
                                prm, a["u"])

    wi, f, pdf = item1_leg(f"item1 hair_sample {n} lanes",
                           lambda: run(dev, n), dev, card, n, "lanes")
    ok = pdf > 1e-7
    alb = float((f[:, 0] * wi[:, 2].abs() / pdf.clamp(min=1e-9))[ok].mean())
    ms = time_ms(lambda: run(dev, n), 3)
    print(f"item1 hair: {ms:.3f} ms per hair_sample of {n} lanes, white "
          f"furnace albedo {alb:.5f} (gate 0.85-1.15) on {card}", flush=True)
    if not 0.85 < alb < 1.15:
        raise AssertionError("item1 hair: white furnace albedo off")
    m = HAIR_CHECK_LANES
    got = [x[:m].cpu().numpy() for x in (wi, f, pdf)]
    want = [x.numpy() for x in run(torch.device("cpu"), m)]
    close = np.ones(m, bool)
    for a, b in zip(got, want):
        close &= np.isclose(a, b, rtol=1e-5, atol=1e-6).reshape(m, -1).all(-1)
    # every lane: the card's f and pdf are the CPU's hair_f and hair_pdf at
    # the card's own direction (scripts/card_ulp_diag.py shows where the
    # rest part: ulps of the card's transcendentals)
    a = {k: torch.as_tensor(x[:m]) for k, x in host.items()}
    args = (a["wo"], torch.as_tensor(got[0]), a["h"], torch.zeros((m, 3)),
            prm)
    worst = max(float(np.max(np.abs(g - e.numpy()) / (
        1e-6 + 1e-3 * np.abs(e.numpy())))) for g, e in (
            (got[1], hair.hair_f(*args)), (got[2], hair.hair_pdf(*args))))
    print(f"item1 hair: card vs cpu on {m} lanes, {close.mean():.5f} of the "
          f"lanes close (rtol 1e-5 / atol 1e-6); the card's f and pdf "
          f"against the CPU's at the card's directions, over every lane: "
          f"largest |diff| / (1e-6 + 1e-3 |cpu|) {worst:.3e} (gate 1)",
          flush=True)
    if close.mean() < 0.99 or worst > 1:
        raise AssertionError("item1 hair: the card and the CPU disagree")


def item1_tools(dev, work, ball_exrs, card):
    """(g): imgtool diff of (b)'s two frames, convert to PNG and
    falsecolor; plytool info on the room's mesh; cyhair2pbrt parsed back;
    rgb2spec_opt at RGB2SPEC_RES on the card, RGB2SPEC_CHECKS lattice
    points held to the CPU fit."""
    import contextlib
    import io

    from acceleratedvolrenderer_tpu_torch.cli import (cyhair2pbrt, imgtool,
                                                      plytool, rgb2spec_opt)
    from acceleratedvolrenderer_tpu_torch.models import shapes
    from acceleratedvolrenderer_tpu_torch.scene.parser import load_scene
    from acceleratedvolrenderer_tpu_torch.utils import image, ply
    from acceleratedvolrenderer_tpu_torch.utils import spectrum as sp

    def tool(main, argv):
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        if rc != 0:
            raise AssertionError(f"{argv[0]}: exit code {rc}")
        return buf.getvalue(), time.time() - t0

    out, secs = tool(imgtool.main, ["diff", *ball_exrs])
    print(f"item1 imgtool diff tabulated vs burley {FULL[0]}x{FULL[1]}: "
          f"{out.strip()} in {secs:.3f} s", flush=True)
    if not set(json.loads(out)) >= {"MSE", "MRSE", "L1", "FLIP"}:
        raise AssertionError("item1 imgtool diff: missing metrics")
    for cmd in ("convert", "falsecolor"):
        png = str(work / f"{cmd}.png")
        _, secs = tool(imgtool.main, [cmd, ball_exrs[0], png])
        shape = image.read_png(png).shape
        print(f"item1 imgtool {cmd} -> PNG {shape} in {secs:.3f} s",
              flush=True)
        if shape != (FULL[1], FULL[0], 3):
            raise AssertionError(f"item1 imgtool {cmd}: PNG {shape}")
    mesh = [p for p in cornell_room(8, 8, 1, "cpu").primitives
            if isinstance(p, shapes.TriangleMesh)][0]
    ply.write_ply(str(work / "mesh.ply"), mesh.vertices, mesh.indices)
    out, secs = tool(plytool.main, ["info", str(work / "mesh.ply")])
    print(f"item1 plytool info: {out.strip()} ({secs:.3f} s)", flush=True)
    if f"{len(mesh.indices)} triangles" not in out:
        raise AssertionError("item1 plytool info: wrong triangle count")
    write_cyhair(work / "t.hair")
    with contextlib.redirect_stderr(io.StringIO()):
        tool(cyhair2pbrt.main, [str(work / "t.hair"), str(work / "hair.pbrt")])
    (work / "hairs.pbrt").write_text(
        'Camera "perspective" "float fov" [45]\n'
        'Film "rgb" "integer xresolution" [8] "integer yresolution" [8]\n'
        'WorldBegin\nLightSource "point" "rgb I" [5 5 5]\n'
        + (work / "hair.pbrt").read_text())
    curves = [p for p in load_scene(str(work / "hairs.pbrt"),
                                    device=dev).primitives
              if isinstance(p, shapes.Curve)]
    print(f"item1 cyhair2pbrt: {len(curves)} curves parsed back", flush=True)
    if len(curves) != 4:
        raise AssertionError("item1 cyhair2pbrt: expected 4 curves")
    res = RGB2SPEC_RES
    npz = str(work / "rgb2spec.npz")
    coeffs = item1_leg(f"item1 rgb2spec_opt {res} ({3 * res ** 3} fits)",
                       lambda: (tool(rgb2spec_opt.main, [str(res), npz]),
                                np.load(npz)["coeffs"])[1],
                       dev, card, 3 * res ** 3, "fits")
    rng = np.random.default_rng(32)
    idx = np.stack([rng.integers(0, n, RGB2SPEC_CHECKS)
                    for n in (3, res, res, res)], -1)    # (l, z, y, x)
    zs = (np.arange(res) + 0.5) / res
    rgb = np.zeros((RGB2SPEC_CHECKS, 3), np.float32)
    for i, (l, z, y, x) in enumerate(idx):
        rgb[i, l] = zs[z]
        rgb[i, (l + 1) % 3] = zs[x] * zs[z]
        rgb[i, (l + 2) % 3] = zs[y] * zs[z]
    want = sp.fit_sigmoid_polynomial(rgb, device="cpu").numpy()
    got = coeffs[idx[:, 0], idx[:, 1], idx[:, 2], idx[:, 3]]
    rel = float((np.abs(got - want) / np.abs(want)).max())
    print(f"item1 rgb2spec: {RGB2SPEC_CHECKS} lattice points card vs cpu "
          f"fit, max rel diff {rel:.3e} (rtol 1e-4)", flush=True)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0,
                               err_msg="item1 rgb2spec")


def phase_item1(dev, card):
    """Phase 30 (see the module docstring).  Returns the (march, gather,
    dma) launches of its legs, summed, and the captured march call's max
    |diff| against plain."""
    import tempfile

    ITEM1_COUNTS.clear()
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        bsdf = item1_frame(dev, work, card)
        ball_exrs = item1_burley(dev, work, card)
        item1_integrators(dev, work, bsdf, card)
        err = item1_fused(dev, card)
        item1_mipmap(dev, card)
        item1_hair(dev, card)
        item1_tools(dev, work, ball_exrs, card)
    return tuple(int(sum(c)) for c in zip(*ITEM1_COUNTS)), err


def write_cyhair(path):
    """tests/test_hair.py's synthetic CyHair file: two strands of 3 points
    (2 segments each), with a segments and a thickness array."""
    import struct

    pts = np.array([[0, 0, 0], [0, 1, 0], [0, 2, 0.3],
                    [1, 0, 0], [1, 1, 0.2], [1, 2, 0]], np.float32)
    with open(path, "wb") as f:
        f.write(b"HAIR")
        f.write(struct.pack("<IIII", 2, 6, 0b111, 0))
        f.write(struct.pack("<ff", 0.1, 0.0))
        f.write(struct.pack("<fff", 0.2, 0.1, 0.05))
        f.write(b"\0" * 88)
        f.write(struct.pack("<2H", 2, 2))
        f.write(pts.tobytes())
        f.write(np.full(6, 0.05, np.float32).tobytes())


SHARD_WORLD = 2                  # phase 31's ranks, gloo, on the one card
SHARD_CAPTURE_CALL = 50          # rank 0's regen march call held to plain
SHARD_MICROBATCHES = 2
SHARD_TIMEOUT = 300              # seconds the ranks may take in all
SHARD_REGEN_TOL = 3e-5           # tests/test_multichip.py's
# tests/test_diff.py's sharded cases at their sizes (8x8 film)
SHARD_LOSS_KW = dict(fixed_steps=96, spp=2)
SHARD_REGEN_KW = dict(fixed_steps=192, n_lanes=16, spp=2, accum_spp=True,
                      microbatches=2, remat_window=48)
SHARD_SINGLE_KW = dict(fixed_steps=448, n_lanes=16, spp=2, accum_spp=True,
                       remat_window=48)


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def shard_cloud(work, dev):
    """Phase 8's scene in a rank: presets.cloud at the parent's frame size
    (work/frame.json) over the grid the parent baked (work/density.npy,
    not baked again)."""
    from acceleratedvolrenderer_tpu_torch.scene import presets

    density = np.load(work / "density.npy")
    width, height = json.loads((work / "frame.json").read_text())
    with mock.patch.object(presets, "bake_cloud_density",
                           return_value=density):
        scene = presets.cloud(width, height, spp=SPP, max_depth=16,
                              grid_res=density.shape[0], device=dev)
    scene.max_march_steps = 4096
    return scene


def shard_small(mesh, dev):
    """tests/test_diff.py's two sharded cases at their sizes on the card
    (the 8x8 small scene): make_sharded_loss and make_sharded_regen_grad
    with overlap off ((d) runs it with overlap at full size).  Returns
    their losses and gradients (numpy)."""
    from acceleratedvolrenderer_tpu_torch.parallel import diff

    scene = diff_small_scene(dev, sigma_a=0.5, sigma_s=1.0, le=None, size=8)
    loss_fn, grad_fn = diff.make_sharded_loss(scene, mesh, **SHARD_LOSS_KW)
    params = {"density": scene.medium.density, "sigma_a": 1.0}
    g = grad_fn(params)
    out = {"loss": float(loss_fn(params)),
           "loss_grad": {k: v.cpu().numpy() for k, v in g.items()}}
    lg = diff.make_sharded_regen_grad(scene, mesh, overlap=False,
                                      **SHARD_REGEN_KW)
    loss, grad = lg(scene.medium.density)
    out["regen"] = (float(loss), grad.cpu().numpy())
    return out


def shard_rank(rank, world, port, work, device, part):
    """One rank of phase 31 in a gloo group of `world` ranks on the
    parent's device (the one card).  part "main": (b)-(d), its numbers to
    work/rank{rank}.json and its frames and gradient shard to work/*.npy;
    part "small": tests/test_diff.py's sharded cases (shard_small) to
    work/small{rank}.pkl."""
    import torch.distributed as dist

    from acceleratedvolrenderer_tpu_torch import kernels
    from acceleratedvolrenderer_tpu_torch.ops import march
    from acceleratedvolrenderer_tpu_torch.parallel import diff, distributed
    from acceleratedvolrenderer_tpu_torch.parallel import mesh as pmesh

    work = Path(work)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    t0 = time.time()
    distributed.initialize(f"tcp://127.0.0.1:{port}", world, rank,
                           backend="gloo")
    kernels.library()
    mesh = pmesh.make_mesh(device=dev)
    if part == "small":
        small = shard_small(mesh, dev)
        small["seconds"] = time.time() - t0
        with open(work / f"small{rank}.pkl", "wb") as f:
            pickle.dump(small, f)
        dist.destroy_process_group()
        return 0
    scene = shard_cloud(work, dev)
    rec = {"setup_s": time.time() - t0}

    # (b) the sharded regen frame; rank 0 keeps one march call
    captured, capture = march_capture(SHARD_CAPTURE_CALL)
    march.launches = 0
    with mock.patch.object(march, "march_block", capture):
        img, st = pmesh.render_sharded_regen(scene, mesh, spp=SPP,
                                             **WIDE_KNOBS)
    rec["regen"] = dict(launches=march.launches, iterations=st["iterations"],
                        render_s=st["render_time"],
                        allreduce_s=st["allreduce_time"])
    # the film's all-reduce alone: the one above waits for the slower rank
    film = torch.zeros((3 * (scene.height * scene.width + 1),),
                       dtype=torch.float32, device=dev)
    dist.barrier()
    rec["regen"]["allreduce_alone_s"] = pmesh.all_reduce(mesh, film)
    if rank == 0:
        np.save(work / "regen.npy", img)
        rec["regen"]["max_abs_err"] = check_captured_march(
            f"sharding rank 0", captured, SHARD_CAPTURE_CALL)

    # (c) the sharded wave frame
    march.launches = 0
    img, st = pmesh.render_sharded(scene, mesh, spp=1)
    rec["wave"] = dict(launches=march.launches, render_s=st["render_time"],
                       allreduce_s=st["allreduce_time"])
    if rank == 0:
        np.save(work / "wave.npy", img)

    # (d) the overlapped sharded gradient, phase 9's knobs
    knobs = dict(n_lanes=16384, k_substeps=8, stochastic_filter=True,
                 accum_spp=True, retire_groups=min(32, 2 * GRAD_SPP),
                 work_stride="auto")
    t1 = time.time()
    steps, _ = diff.size_fixed_steps(scene, mesh, spp=GRAD_SPP,
                                     microbatches=SHARD_MICROBATCHES, **knobs)
    window = max(int(np.sqrt(steps)), 16)
    rec["grad_sizing_s"] = time.time() - t1
    lg = diff.make_sharded_regen_grad(
        scene, mesh, fixed_steps=steps, spp=GRAD_SPP,
        microbatches=SHARD_MICROBATCHES, remat_window=window, overlap=True,
        **knobs)
    march.launches = 0
    _sync(dev)
    t1 = time.time()
    loss, shard = lg(scene.medium.density)
    _sync(dev)
    rec["grad"] = dict(launches=march.launches, seconds=time.time() - t1,
                       loss=float(loss), steps=steps, window=window,
                       microbatches=lg.timings[-1],
                       shard_len=int(shard.numel()),
                       peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    np.save(work / f"grad{rank}.npy", shard.cpu().numpy())
    # one microbatch's reduce-scatter alone: the waits above include the
    # other rank's compute
    flat = torch.zeros(mesh.size * shard.numel(), device=dev)
    dist.barrier()
    _sync(dev)
    t1 = time.time()
    dist.reduce_scatter_tensor(torch.empty_like(shard), flat)
    _sync(dev)
    rec["grad"]["reduce_scatter_alone_s"] = time.time() - t1

    (work / f"rank{rank}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()
    return 0


def shard_small_reference():
    """The port's single-device results of tests/test_diff.py's sharded
    cases on the CPU: (loss, gradients) of make_diff_renderer_multi and
    (loss, gradient) of make_diff_regen_renderer, numpy."""
    from acceleratedvolrenderer_tpu_torch.parallel import diff

    cpu = torch.device("cpu")
    scene = diff_small_scene(cpu, sigma_a=0.5, sigma_s=1.0, le=None, size=8)
    loss_fn, grad_fn = diff.make_diff_renderer_multi(scene, device=cpu,
                                                     **SHARD_LOSS_KW)
    params = {"density": scene.medium.density, "sigma_a": 1.0}
    with torch.no_grad():
        loss1 = float(loss_fn(params))
    g1 = {k: v.numpy() for k, v in grad_fn(params).items()}
    loss_fn, grad_fn = diff.make_diff_regen_renderer(scene, device=cpu,
                                                     **SHARD_SINGLE_KW)
    dens = scene.medium.density
    with torch.no_grad():
        l1 = float(loss_fn(dens))
    return (loss1, g1), (l1, grad_fn(dens).numpy())


def shard_check_small(work, reference):
    """Phase 31's small-scene results of every rank against the port's
    single-device ones on the CPU (shard_small_reference), at
    tests/test_diff.py's tolerances."""
    ranks = []
    for r in range(SHARD_WORLD):
        with open(work / f"small{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    (loss1, g1), (l1, gr) = reference
    close = np.testing.assert_allclose
    for r in ranks:
        close(r["loss"], loss1, rtol=1e-5, err_msg="sharding: loss")
        close(r["loss_grad"]["density"], g1["density"], rtol=1e-4,
              atol=1e-7, err_msg="sharding: sharded loss density gradient")
        close(r["loss_grad"]["sigma_a"], g1["sigma_a"], rtol=1e-4,
              err_msg="sharding: sharded loss sigma_a gradient")
        close(r["regen"][0], l1, rtol=1e-5, err_msg="sharding: regen loss")
        close(r["regen"][1], gr, rtol=1e-4, atol=1e-8,
              err_msg="sharding: regen gradient, one all-reduce")
    print(f"sharding: tests/test_diff.py's sharded cases at 8x8 on the card "
          f"at world {SHARD_WORLD} ({[round(r['seconds'], 2) for r in ranks]}"
          f" s per rank): make_sharded_loss {ranks[0]['loss']:.6e} (CPU "
          f"single device {loss1:.6e}), make_sharded_regen_grad overlap off "
          f"{ranks[0]['regen'][0]:.6e} (CPU {l1:.6e}); gradients within "
          f"rtol 1e-4 / atol 1e-7 and 1e-8", flush=True)


def phase_sharding(dev, scene, card):
    """Phase 31 (see the module docstring).  Returns the march launches of
    (a) and of each rank's (b), (c), (d)."""
    import subprocess
    import tempfile

    import torch.distributed as dist

    from acceleratedvolrenderer_tpu_torch.ops import march
    from acceleratedvolrenderer_tpu_torch.parallel import distributed
    from acceleratedvolrenderer_tpu_torch.parallel import mesh as pmesh

    H, W = scene.height, scene.width
    ref = FRAMES[("cloud", "regen")]
    # (a) a world of one over NCCL in this process
    distributed.initialize(f"tcp://127.0.0.1:{_free_port()}", 1, 0,
                           backend="nccl")
    try:
        march.launches = 0
        img_a, st = pmesh.render_sharded_regen(
            scene, pmesh.make_mesh(device=dev), spp=SPP, **WIDE_KNOBS)
        launches_a = march.launches
    finally:
        dist.destroy_process_group()
    err_a = float(np.abs(img_a - ref).max())
    print(f"sharding (a) world 1, nccl: {W}x{H} spp {SPP} at {WIDE_LANES} "
          f"lanes, {st['iterations']} iterations, {launches_a} march "
          f"launches, render {st['render_time']:.3f} s (all-reduce "
          f"{st['allreduce_time']:.4f} s), max |diff| against phase 8's "
          f"render_regen frame {err_a:.3e} (tol {SHARD_REGEN_TOL}) on "
          f"{card}", flush=True)
    if err_a > SHARD_REGEN_TOL:
        raise AssertionError("sharding (a): world 1 differs from render_regen")
    if launches_a != st["iterations"]:
        raise AssertionError(f"sharding (a): {launches_a} march launches for "
                             f"{st['iterations']} iterations")

    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        np.save(work / "density.npy", scene.medium.density.cpu().numpy())
        (work / "frame.json").write_text(json.dumps([W, H]))
        t0 = time.time()
        # two groups at once: (b)-(d), and the small cases beside them
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--shard-rank",
             str(r), str(SHARD_WORLD), str(port), tmp, str(dev), part])
            for part, port in (("main", _free_port()),
                               ("small", _free_port()))
            for r in range(SHARD_WORLD)]
        try:
            t1 = time.time()
            reference = shard_small_reference()     # while the ranks run
            small_cpu = time.time() - t1
            # a rank that fails leaves the others blocked in a collective:
            # stop waiting at the first failure or at the time limit
            while (any(p.poll() is None for p in procs)
                   and not any(p.poll() for p in procs)
                   and time.time() - t0 < SHARD_TIMEOUT):
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        rcs = [p.returncode for p in procs]
        wall = time.time() - t0
        if any(rcs):
            raise AssertionError(f"sharding: rank exit codes {rcs}")
        recs = [json.loads((work / f"rank{r}.json").read_text())
                for r in range(SHARD_WORLD)]
        img_b = np.load(work / "regen.npy")
        img_c = np.load(work / "wave.npy")
        grad = np.concatenate([np.load(work / f"grad{r}.npy")
                               for r in range(SHARD_WORLD)])
        shard_check_small(work, reference)

    print(f"sharding: {SHARD_WORLD} ranks (gloo, one card) for (b)-(d) and "
          f"{SHARD_WORLD} for the small cases, all at once, in {wall:.1f} s "
          f"wall; (b)-(d) ranks' set-up after start (group, kernels, scene "
          f"from the parent's grid) {[round(r['setup_s'], 2) for r in recs]}"
          f" s; the small cases' CPU references {small_cpu:.1f} s", flush=True)
    # (b)
    err_b = float(np.abs(img_b - img_a).max())
    for r, rec in enumerate(recs):
        b = rec["regen"]
        print(f"sharding (b) rank {r}: regen {b['iterations']} iterations, "
              f"{b['launches']} march launches, render {b['render_s']:.3f} s "
              f"of which all-reduce {b['allreduce_s']:.4f} s (waiting for "
              f"the other rank included; after a barrier "
              f"{b['allreduce_alone_s']:.4f} s for the film's "
              f"{3 * (H * W + 1) * 4} B) on {card}", flush=True)
        if not 0 < b["launches"] == b["iterations"]:
            raise AssertionError(f"sharding (b) rank {r}: march launches "
                                 f"{b['launches']} for {b['iterations']} "
                                 "iterations")
    print(f"sharding (b) world {SHARD_WORLD}: film max |diff| against (a)'s "
          f"{err_b:.3e} (tol {SHARD_REGEN_TOL}); rank 0's march call "
          f"{SHARD_CAPTURE_CALL} equal to plain (max |diff| "
          f"{recs[0]['regen']['max_abs_err']:.3e})", flush=True)
    if err_b > SHARD_REGEN_TOL or not np.isfinite(img_b).all():
        raise AssertionError("sharding (b): world 2 differs from world 1")
    # (c)
    wave_ref = FRAMES[("cloud", "render")]
    err_c = float(np.abs(img_c - wave_ref).max())
    print(f"sharding (c) render_sharded world {SHARD_WORLD} spp 1: "
          + "; ".join(f"rank {r} {x['wave']['launches']} march launches, "
                      f"{x['wave']['render_s']:.3f} s (all-reduce "
                      f"{x['wave']['allreduce_s']:.4f} s)"
                      for r, x in enumerate(recs))
          + f"; max |diff| against phase 14's frame {err_c:.3e}", flush=True)
    np.testing.assert_allclose(img_c, wave_ref, rtol=1e-5, atol=1e-5,
                               err_msg="sharding (c): sharded wave frame")
    if not all(x["wave"]["launches"] > 0 for x in recs):
        raise AssertionError("sharding (c): a rank launched no march")
    # (d)
    g9 = FRAMES[("cloud", "grad")]
    g1 = g9["grad"]
    got = grad[:g1.size].reshape(g1.shape)
    err_d = float(np.abs(got - g1).max())
    for r, x in enumerate(recs):
        d = x["grad"]
        mbs = ", ".join(f"compute {m['compute']:.3f} s / held up by its "
                        f"reduce-scatter {m['wait']:.4f} s"
                        for m in d["microbatches"])
        print(f"sharding (d) rank {r}: make_sharded_regen_grad overlap "
              f"{SHARD_MICROBATCHES} microbatches x fixed_steps {d['steps']} "
              f"(window {d['window']}; sized in {x['grad_sizing_s']:.2f} s): "
              f"{d['seconds']:.3f} s, {d['launches']} march launches, loss "
              f"{d['loss']:.6e}, shard {d['shard_len']} voxels, peak "
              f"{d['peak_gib']:.3f} GiB; per microbatch ({4 * g1.size} B "
              f"reduce-scattered each; CUDA events on the rank's compute "
              f"stream): {mbs}; one reduce-scatter alone "
              f"after a barrier {d['reduce_scatter_alone_s']:.4f} s on "
              f"{card}", flush=True)
        np.testing.assert_allclose(d["loss"], g9["loss"], rtol=1e-5,
                                   err_msg="sharding (d): loss")
        if d["launches"] <= 0:
            raise AssertionError(f"sharding (d) rank {r}: no march launch")
    print(f"sharding (d): gradient max |diff| against phase 9's {err_d:.3e} "
          f"(max |grad| {float(np.abs(g1).max()):.4e}), loss "
          f"{recs[0]['grad']['loss']:.6e} against {g9['loss']:.6e}",
          flush=True)
    np.testing.assert_allclose(got, g1, rtol=1e-4, atol=1e-8,
                               err_msg="sharding (d): gradient")
    return dict(world1=launches_a,
                ranks=[[x["regen"]["launches"], x["wave"]["launches"],
                        x["grad"]["launches"]] for x in recs],
                max_abs_err=recs[0]["regen"]["max_abs_err"])


IMAGE_SKY = (2048, 1024)           # phase 32's TIFF sky map
IMAGE_SKY_SCALE = 0.05
IMAGE_CAPTURE_CALL = 20            # the map frame's march call held to plain
IMAGE_FIXTURES = Path(__file__).resolve().parent / "tests/data/images"
IMAGE_GROUND = "ground_1024x512_q90.webp"
IMAGE_SKY_WEBP = "sky_2048x1024_q90.webp"
IMAGE_MAP_FRAME = "map_frame.exr"     # phase 32's map frame, for phase 33
# phase 32's medium file, ground samples and 8-bit LZW sky TIFF, for 34
IMAGE_MEDIUM = "medium.pbrt"
IMAGE_GROUND_SAMPLES = "ground.npy"
IMAGE_TIFF8 = "sky8.tif"
# phase 33: imgtool convert --tonemap writes the map frame to each of these
# (PNG and JPEG, then the lossless formats write_png writes byte for byte)
WRITER_EXTS = (".png", ".jpg", ".bmp", ".dib", ".tga", ".tif", ".ppm",
               ".pcx", ".sgi", ".im", ".dds", ".qoi")
# dB, the JPEGs' decodes against their pixels: a floor against a broken
# encode or decode, the files' bytes being held to PIL's by the fixture
# hashes.  What a JPEG at PIL's quality 75 keeps depends on the frame's
# noise: the spp-1 map frame rendered on an NVIDIA H100 80GB HBM3 at 700 W
# comes out at 28.04 dB, its falsecolor at 47.74, and PIL's files of both
# are the port's byte for byte (scripts/compare_frame_writers.py)
WRITER_MIN_PSNR = 25.0


def image_formats_file_text(width, height, medium, sky=None, ground=None):
    """A .pbrt file of phase 8's cloud (the medium statement in the file
    `medium`, Included), its sun, an infinite light (the map `sky`, else
    uniform, both at IMAGE_SKY_SCALE) and phase 23's tilted ground quad
    (cloud_with_surfaces), diffuse, its reflectance the imagemap `ground`
    (else 0.4); volpath, max depth 16, spp 1."""
    from acceleratedvolrenderer_tpu_torch.scene import presets

    w2c = " ".join(repr(float(v)) for v in presets.CLOUD_W2C.T.reshape(-1))
    sun = " ".join(repr(float(v)) for v in presets.CLOUD_SUN_DIR)
    tilt = np.deg2rad(10.0)
    across = np.array([0.0, 0.0, 1600.0])
    slope = 1600.0 * np.array([-np.cos(tilt), np.sin(tilt), 0.0])
    o = np.array([0.0, -100.0, 0.0]) - 0.5 * across - 0.25 * slope
    quad = " ".join(repr(float(v)) for v in np.concatenate(
        [o, o + across, o + slope, o + across + slope]))
    sky_line = (f'LightSource "infinite" "string filename" "{sky}"'
                if sky else 'LightSource "infinite" "rgb L" [1 1 1]')
    if ground:
        tex = (f'Texture "ground" "spectrum" "imagemap" "string filename" '
               f'"{ground}"\n')
        mat = 'Material "diffuse" "texture reflectance" "ground"\n'
    else:
        tex, mat = "", 'Material "diffuse" "rgb reflectance" [0.4 0.4 0.4]\n'
    return (
        "# presets.cloud over a textured ground under a sky map\n"
        f"Transform [ {w2c} ]\n"
        'Camera "perspective" "float fov" [31.07]\n'
        f'Film "rgb" "integer xresolution" [{width}] '
        f'"integer yresolution" [{height}] "string filename" "frame.exr"\n'
        'PixelFilter "gaussian"\n'
        'Sampler "independent" "integer pixelsamples" [1]\n'
        'Integrator "volpath" "integer maxdepth" [16]\n'
        "WorldBegin\n"
        'LightSource "distant" "rgb L" [1 1 1] "float scale" [2.6]\n'
        f'    "point3 from" [0 0 0] "point3 to" [{sun}]\n'
        f'{sky_line} "float scale" [{IMAGE_SKY_SCALE}]\n'
        + tex +
        "AttributeBegin\n" + mat +
        f'Shape "trianglemesh" "point3 P" [ {quad} ]\n'
        '    "point2 uv" [0 0 1 0 0 1 1 1] "integer indices" [0 1 2 2 1 3]\n'
        "AttributeEnd\n"
        "AttributeBegin\n"
        f'Include "{medium}"\n'
        'MediumInterface "cloud" ""\n'
        'Material ""\n'
        'Shape "sphere" "float radius" [174]\n'
        "AttributeEnd\n")


def image_fixture_checks():
    """The committed lossy WebP fixtures decoded by the port, each held to
    the SHA-256 of PIL's samples in images.json (whose entries with
    `rebuilt_by` are phase 34's, not committed, and whose JPEG 2000 files
    are phase 35's); returns the decoded ground texture."""
    import hashlib

    from acceleratedvolrenderer_tpu_torch.utils import webp

    record = json.loads((IMAGE_FIXTURES / "images.json").read_text())
    out = {}
    for name, rec in sorted(record.items()):
        if "rebuilt_by" in rec or not name.endswith(".webp"):
            continue
        px = webp.decode_webp((IMAGE_FIXTURES / name).read_bytes())
        digest = hashlib.sha256(np.ascontiguousarray(px).tobytes()).hexdigest()
        ok = list(px.shape) == rec["shape"] and \
            digest == rec["sha256_of_pil_samples"]
        print(f"image formats: {name} {px.shape} decoded, sha256 {digest} "
              f"{'equals' if ok else 'DIFFERS FROM'} PIL's", flush=True)
        if not ok:
            raise AssertionError(f"image formats: {name} differs from PIL's "
                                 "decode")
        out[name] = px
    return out[IMAGE_GROUND]


def phase_image_formats(dev, keep, card):
    """Phase 32 (see the module docstring); keep holds phase 28's grid
    block, and gains the medium file, the ground's decoded samples and
    (d)'s 8-bit LZW TIFF for phase 34.  Returns the march launches of the
    three CLI frames, the captured call's max |diff| and the uniform-sky
    frame's mean."""
    import contextlib
    import tempfile
    import warnings

    from acceleratedvolrenderer_tpu_torch.ops import march
    from acceleratedvolrenderer_tpu_torch.parallel import render
    from acceleratedvolrenderer_tpu_torch.scene import parser
    from acceleratedvolrenderer_tpu_torch.utils import image

    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
    import time_image_decode as tid

    tmp = tempfile.TemporaryDirectory()
    work = Path(tmp.name)
    t0 = time.time()
    ground_px = image_fixture_checks()
    t1 = time.time()
    sky_data = tid.sky_tiff(*IMAGE_SKY)
    sky_write = time.time() - t1
    (work / "sky.tif").write_bytes(sky_data)
    (work / "ground.webp").write_bytes(
        (IMAGE_FIXTURES / IMAGE_GROUND).read_bytes())
    sky_px = image._decode_image("sky.tif", sky_data)
    if not np.array_equal(sky_px, tid.sky(*IMAGE_SKY)):
        raise AssertionError("image formats: the TIFF sky does not decode "
                             "to its written samples")
    (work / "sky.png").write_bytes(image.encode_png(sky_px))
    (work / "ground.png").write_bytes(image.encode_png(ground_px))
    np.save(Path(keep) / IMAGE_GROUND_SAMPLES, ground_px)
    medium = Path(keep) / IMAGE_MEDIUM
    with open(medium, "w") as f:
        f.write('MakeNamedMedium "cloud" "string type" "uniformgrid"\n')
        with open(Path(keep) / "grid.txt") as g:
            while True:
                chunk = g.read(1 << 24)
                if not chunk:
                    break
                f.write(chunk)
        f.write('    "rgb sigma_a" [0 0 0] "rgb sigma_s" [1 1 1]\n'
                '    "float scale" [0.2] "float g" [0.877]\n')
    W, H = FULL
    files = {
        "maps": dict(sky=work / "sky.tif", ground="ground.webp"),
        "png maps": dict(sky=work / "sky.png", ground="ground.png"),
        "uniform sky": dict(ground="ground.webp")}
    for name, kw in files.items():
        (work / f"{name.replace(' ', '_')}.pbrt").write_text(
            image_formats_file_text(W, H, medium, **kw))
    print(f"image formats: fixtures checked and files written in "
          f"{time.time() - t0:.2f} s (the sky TIFF, 16-bit LZW, "
          f"{len(sky_data)} bytes, in {sky_write:.2f} s)", flush=True)

    steps, parsed = {}, []
    load_scene = parser.load_scene

    def strict_load(*args, **kw):
        t = time.time()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            parsed.append(load_scene(*args, **kw))
        steps["parse"] = time.time() - t
        return parsed[-1]

    captured, capture = march_capture(IMAGE_CAPTURE_CALL)
    frames, launches = {}, []
    for name in files:
        out = str(work / f"{name.replace(' ', '_')}.exr")
        torch.cuda.reset_peak_memory_stats(dev)
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(parser, "load_scene",
                                                  strict_load))
            if name == "maps":
                stack.enter_context(mock.patch.object(march, "march_block",
                                                      capture))
            zero_kernel_counts()
            t = time.time()
            st = run_cli([str(work / f"{name.replace(' ', '_')}.pbrt"), "-o",
                          out, "--spp", "1", "--stats"])
            cli = time.time() - t
            counts = kernel_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        img = image.read_exr(out)[0]
        frames[name] = img
        launches.append(counts[0])
        print(f"image formats: {name}: pbrt {W}x{H} spp 1: parse "
              f"{steps['parse']:.2f} s, render {st['render_time']:.3f} s "
              f"({st['iterations']} iterations), the CLI call {cli:.2f} s; "
              f"(march, gather, dma) launches {counts}; peak device memory "
              f"{peak:.3f} GiB; film mean {img.mean():.6f} on {card}",
              flush=True)
        _check_frame(f"image formats {name}", img, (H, W, 3))
        if counts != (st["iterations"], 0, 0):
            raise AssertionError(f"image formats {name}: launches {counts} "
                                 f"for {st['iterations']} iterations")
        if name == "maps":
            sc = parsed[-1]
        parsed.clear()
    diff = float(np.abs(frames["maps"] - frames["png maps"]).max())
    rel = abs(float(frames["maps"].mean()) - float(
        frames["uniform sky"].mean())) / float(frames["uniform sky"].mean())
    print(f"image formats: (a) TIFF / WebP frame vs PNG twin max |diff| "
          f"{diff:.3e}; mean vs the uniform sky's rel diff {rel:.4e}",
          flush=True)
    if diff != 0.0:
        raise AssertionError("image formats: the TIFF / WebP frame differs "
                             "from its PNG twin")
    if rel < 1e-3:
        raise AssertionError("image formats: the map frame's mean equals "
                             "the uniform sky's (map dropped?)")
    err = check_captured_march("image formats (b)", captured,
                               IMAGE_CAPTURE_CALL)
    small = replace(sc, camera=sc.camera._replace(width=32, height=24))
    imgs = [render.render(small, device=dev)[0],
            render.render(small.to("cpu"), device="cpu")[0]]
    compare_frames("image formats (c) 32x24 gpu vs cpu", *imgs,
                   mean_tol=SURF_MEAN_TOL)
    del sc, small
    shutil.copy(work / "maps.exr", Path(keep) / IMAGE_MAP_FRAME)
    tmp.cleanup()
    print(f"image formats (d): host CPU {tid.cpu_line()}; {card}",
          flush=True)
    bad, written = [], {}
    for name, size, write, secs, ok in tid.time_formats(
            *IMAGE_SKY, webp_path=IMAGE_FIXTURES / IMAGE_SKY_WEBP, reps=1,
            sky16=sky_data, files=written):
        print(f"image formats (d): {name} {IMAGE_SKY[0]}x{IMAGE_SKY[1]}: "
              f"{size} bytes, written in {write:.2f} s; decode "
              f"{', '.join(f'{x:.3f}' for x in secs)} s; "
              f"{'equal to the source' if ok else 'WRONG'}", flush=True)
        if not ok:
            bad.append(name)
    if bad:
        raise AssertionError(f"image formats (d): wrong decodes {bad}")
    (Path(keep) / IMAGE_TIFF8).write_bytes(written["tiff 8-bit"])
    return launches, err, float(frames["uniform sky"].mean())


BCN_SKY = "sky_2048x1024_bc6h.dds"         # phase 34's maps (images.json)
BCN_GROUND = "ground_1024x512_bc7.dds"
BCN_CAPTURE_CALL = 20              # the frame's march call held to plain


def _instances(obj, cls, out=None, seen=None, depth=0):
    """The objects of class cls reachable from obj through attributes,
    dataclass fields, lists, tuples and dicts (arrays and tensors not
    entered)."""
    out = [] if out is None else out
    seen = set() if seen is None else seen
    if id(obj) in seen or depth > 8 or isinstance(
            obj, (np.ndarray, torch.Tensor, str, bytes, int, float)):
        return out
    seen.add(id(obj))
    if isinstance(obj, cls):
        out.append(obj)
    if isinstance(obj, dict):
        items = list(obj.values())
    elif isinstance(obj, (list, tuple)):
        items = list(obj)
    else:
        items = list(getattr(obj, "__dict__", {}).values())
    for item in items:
        _instances(item, cls, out, seen, depth + 1)
    return out


def phase_block_maps(dev, keep, uniform_mean, card):
    """Phase 34 (see the module docstring); keep holds phase 32's medium
    file, ground samples and 8-bit LZW TIFF.  Returns the frame's march
    launches and its captured call's max |diff|."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
    import block_maps as bm
    import time_image_decode as tid

    record = json.loads((IMAGE_FIXTURES / "images.json").read_text())
    work = Path(tempfile.mkdtemp())
    try:
        # (a) and (c): the block-compressed files rebuilt, held to the
        # recorded hashes of their bytes and of PIL's samples
        print(f"block maps: host CPU {tid.cpu_line()}; {card}", flush=True)
        t0 = time.time()
        files = bm.block_files(*IMAGE_SKY)
        ground_px = np.load(Path(keep) / IMAGE_GROUND_SAMPLES)
        files[BCN_GROUND] = bm.encode_dds("BC7", ground_px)
        print(f"block maps (a): {len(files)} block-compressed files written "
              f"in {time.time() - t0:.2f} s", flush=True)
        t0 = time.time()
        lossless = bm.lossless_files(
            *IMAGE_SKY, tiff8=(Path(keep) / IMAGE_TIFF8).read_bytes())
        print(f"block maps (c): lossless files written in "
              f"{time.time() - t0:.2f} s", flush=True)
        bad = []
        for name, size, secs, shape, ok in bm.decode_all(files, lossless,
                                                         record):
            what = ("bytes and samples at PIL's hashes" if name in files
                    else "equal to the source")
            print(f"block maps (a, c): {name} {shape[1]}x{shape[0]}: {size} "
                  f"bytes, decode {secs:.3f} s; "
                  f"{what if ok else 'WRONG: not ' + what}", flush=True)
            if not ok:
                bad.append(name)
        if bad:
            raise AssertionError(f"block maps: wrong files or decodes {bad}")

        # (b) the frame: the BC6H sky and the BC7 ground by the CLI
        (work / "sky.dds").write_bytes(files[BCN_SKY])
        (work / "ground.dds").write_bytes(files[BCN_GROUND])
        return maps_frame("block maps (b)", dev, keep, work, "sky.dds",
                          "ground.dds", uniform_mean, card)
    finally:
        shutil.rmtree(work)


def maps_frame(what, dev, keep, work, sky, ground, uniform_mean, card):
    """Phase 32's file (keep holds its medium file) with the map work/sky
    as the infinite light's and work/ground as the ground's imagemap,
    rendered by the CLI at FULL spp 1 with the parser's warnings made
    errors: the parsed maps equal read_image's bit for bit, one march
    launch per loop iteration and no gather or dma launch, the march call
    BCN_CAPTURE_CALL equal to plain, the mean apart from phase 32's
    uniform-sky frame's, the 32x24 version on the card and the CPU within
    SURF_MEAN_TOL.  Returns the march launches and the captured call's
    max |diff|."""
    import contextlib
    import warnings

    from acceleratedvolrenderer_tpu_torch.models import lights, textures
    from acceleratedvolrenderer_tpu_torch.ops import march
    from acceleratedvolrenderer_tpu_torch.parallel import render
    from acceleratedvolrenderer_tpu_torch.scene import parser
    from acceleratedvolrenderer_tpu_torch.utils import image

    W, H = FULL
    path = work / "maps.pbrt"
    path.write_text(image_formats_file_text(
        W, H, Path(keep) / IMAGE_MEDIUM, sky=work / sky, ground=ground))
    steps, parsed = {}, []
    load_scene = parser.load_scene

    def strict_load(*args, **kw):
        t = time.time()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            parsed.append(load_scene(*args, **kw))
        steps["parse"] = time.time() - t
        return parsed[-1]

    captured, capture = march_capture(BCN_CAPTURE_CALL)
    out = str(work / "maps.exr")
    torch.cuda.reset_peak_memory_stats(dev)
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(parser, "load_scene",
                                              strict_load))
        stack.enter_context(mock.patch.object(march, "march_block",
                                              capture))
        zero_kernel_counts()
        t = time.time()
        st = run_cli([str(path), "-o", out, "--spp", "1", "--stats"])
        cli = time.time() - t
        counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    img = image.read_exr(out)[0]
    rel = abs(float(img.mean()) - uniform_mean) / uniform_mean
    print(f"{what}: pbrt {W}x{H} spp 1: parse "
          f"{steps['parse']:.2f} s, render {st['render_time']:.3f} s "
          f"({st['iterations']} iterations), the CLI call {cli:.2f} s; "
          f"(march, gather, dma) launches {counts}; peak device memory "
          f"{peak:.3f} GiB; film mean {img.mean():.6f}, rel diff "
          f"{rel:.4e} from phase 32's uniform sky's; {card}", flush=True)
    _check_frame(what, img, (H, W, 3))
    if counts != (st["iterations"], 0, 0):
        raise AssertionError(f"{what}: launches {counts} for "
                             f"{st['iterations']} iterations")
    if rel < 1e-3:
        raise AssertionError(f"{what}: the frame's mean equals "
                             "the uniform sky's (map dropped?)")
    sc = parsed[-1]
    sky_maps = [x.image for x in _instances(sc, lights.ImageInfiniteLight)]
    ground_maps = [x.image for x in _instances(sc, textures.ImageTexture)]
    want_sky = image.read_image(str(work / sky))[0]
    want_ground = image.read_image(str(work / ground))[0]
    same = (len(sky_maps) == 1 and len(ground_maps) == 1
            and np.array_equal(sky_maps[0], want_sky)
            and np.array_equal(ground_maps[0].reshape(want_ground.shape),
                               want_ground))
    print(f"{what}: the parsed sky {want_sky.shape} and ground "
          f"{want_ground.shape} maps {'equal' if same else 'DIFFER FROM'}"
          f" read_image's, bit for bit", flush=True)
    if not same:
        raise AssertionError(f"{what}: parsed maps differ from "
                             "read_image's")
    err = check_captured_march(what, captured, BCN_CAPTURE_CALL)
    small = replace(sc, camera=sc.camera._replace(width=32, height=24))
    t = time.time()
    imgs = [render.render(small, device=dev)[0],
            render.render(small.to("cpu"), device="cpu")[0]]
    compare_frames(f"{what} 32x24 gpu vs cpu", *imgs,
                   mean_tol=SURF_MEAN_TOL)
    print(f"{what}: the 32x24 frames in {time.time() - t:.2f} s", flush=True)
    del sc, small, parsed
    return counts[0], err


J2K_MAP_FRAME = "j2k_frame.exr"   # phase 35's frame, for phase 36
J2K_SKY = "sky_2048x1024_97.jp2"            # phase 35's maps (images.json)
J2K_GROUND = "ground_1024x512_53.j2k"
J2K_CROP = "sky_512x256_lossless.jp2"


def phase_j2k_maps(dev, keep, uniform_mean, card):
    """Phase 35 (see the module docstring); keep holds phase 32's medium
    file.  Returns the frame's march launches and its captured call's
    max |diff|."""
    from acceleratedvolrenderer_tpu_torch import native

    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
    import time_image_decode as tid

    record = json.loads((IMAGE_FIXTURES / "images.json").read_text())
    print(f"JPEG 2000 maps: host CPU {tid.cpu_line()}; {card}", flush=True)
    t0 = time.time()
    native.j2k_library(required=True)
    print(f"JPEG 2000 maps: C++ tier 1 built or loaded in "
          f"{time.time() - t0:.2f} s", flush=True)
    # (a) each fixture decoded once, held to the hashes of its bytes and of
    # PIL's samples; the sky and the lossless crop once more by the numpy
    # tier 1
    bad = []
    paths = [IMAGE_FIXTURES / n for n in (J2K_SKY, J2K_GROUND, J2K_CROP)]
    for name, size, shape, secs, twin, ok in tid.time_jpeg2000(
            paths, record, (J2K_SKY, J2K_CROP)):
        data = (IMAGE_FIXTURES / name).read_bytes()
        ok = ok and hashlib.sha256(data).hexdigest() == record[name][
            "sha256_of_bytes"]
        px = shape[0] * shape[1]
        line = (f"JPEG 2000 maps (a): {name} {shape[1]}x{shape[0]}: {size} "
                f"bytes, decode {secs:.3f} s ({1e6 * secs / px:.3f} "
                f"us/pixel, C++ tier 1)")
        if twin is not None:
            line += (f", {twin:.3f} s ({1e6 * twin / px:.3f} us/pixel) "
                     "with the numpy tier 1")
        print(f"{line}; {'at' if ok else 'NOT at'} images.json's hashes",
              flush=True)
        if not ok:
            bad.append(name)
    if bad:
        raise AssertionError(f"JPEG 2000 maps: wrong files or decodes {bad}")
    # (b) the frame: the JP2 sky and the J2K ground by the CLI; the frame
    # kept for phase 36
    work = Path(tempfile.mkdtemp())
    try:
        for name in (J2K_SKY, J2K_GROUND):
            shutil.copy(IMAGE_FIXTURES / name, work / name)
        out = maps_frame("JPEG 2000 maps (b)", dev, keep, work, J2K_SKY,
                         J2K_GROUND, uniform_mean, card)
        shutil.copy(work / "maps.exr", Path(keep) / J2K_MAP_FRAME)
        return out
    finally:
        shutil.rmtree(work)


def psnr(a, b):
    """PSNR in dB of two uint8 images."""
    err = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if err == 0 else float(10 * np.log10(255.0 ** 2 / err))


def _srgb_to_linear(u8):
    """read_image's linear values of uint8 sRGB samples."""
    x = u8.astype(np.float32) / 255.0
    return np.where(x <= 0.04045, x / 12.92,
                    ((x + 0.055) / 1.055) ** 2.4).astype(np.float32)


def phase_image_writers(keep, card):
    """Phase 33 (see the module docstring); keep holds phase 32's map
    frame.  Returns the largest |diff| of a lossless file's samples."""
    import contextlib
    import hashlib
    import io

    from acceleratedvolrenderer_tpu_torch.cli import imgtool
    from acceleratedvolrenderer_tpu_torch.utils import image, image_write, webp

    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
    import time_image_decode as tid

    src = str(Path(keep) / IMAGE_MAP_FRAME)
    frame = image.read_exr(src)[0][:, :, :3]
    want = image.to_8bit(frame)
    H, W = want.shape[:2]
    print(f"image writers: host CPU {tid.cpu_line()}; {card}", flush=True)
    work = Path(tempfile.mkdtemp())
    err = 0
    try:
        for ext in WRITER_EXTS:
            out = work / f"frame{ext}"
            t = time.time()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = imgtool.main(["convert", "--tonemap", src, str(out)])
            cli = time.time() - t
            if rc != 0:
                raise AssertionError(f"image writers: imgtool convert to "
                                     f"{ext}: exit code {rc}")
            t = time.time()
            data = image_write.encode(str(out), want)
            enc = time.time() - t
            if data != out.read_bytes():
                raise AssertionError(f"image writers: {ext}: imgtool's file "
                                     "is not write_png's encoding")
            px = image._decode_image(str(out), data)
            # read_image linearises the samples; imgtool's loader keeps
            # them, but reads a .qoi through read_qoi and linearises it, as
            # the reference does
            loaded = imgtool._load(str(out))[0]
            ok = np.array_equal(image.read_image(str(out))[0],
                                _srgb_to_linear(px)) and np.array_equal(
                loaded, _srgb_to_linear(px) if ext == ".qoi"
                else px.astype(np.float32) / 255)
            if ext == ".jpg":
                db = psnr(px, want)
                ok &= db >= WRITER_MIN_PSNR
                what = f"PSNR {db:.2f} dB (at least {WRITER_MIN_PSNR})"
            else:
                d = int(np.abs(px.astype(int) - want.astype(int)).max())
                err = max(err, d)
                ok &= d == 0
                what = f"max |diff| {d}"
            print(f"image writers: {ext} {W}x{H}: {len(data)} bytes, imgtool "
                  f"convert {cli:.3f} s (encode {enc:.3f} s), read back "
                  f"{what}{'' if ok else ' WRONG'}", flush=True)
            if not ok:
                raise AssertionError(f"image writers: {ext} read back wrong")
        fc = {}
        for ext in (".png", ".jpg"):
            out = work / f"falsecolor{ext}"
            t = time.time()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = imgtool.main(["falsecolor", src, str(out)])
            if rc != 0:
                raise AssertionError(f"image writers: imgtool falsecolor to "
                                     f"{ext}: exit code {rc}")
            fc[ext] = (image._decode_image(str(out), out.read_bytes()),
                       time.time() - t, out.stat().st_size)
        db = psnr(fc[".jpg"][0], fc[".png"][0])
        print(f"image writers: falsecolor .jpg {fc['.jpg'][2]} bytes in "
              f"{fc['.jpg'][1]:.3f} s, PSNR {db:.2f} dB against its .png",
              flush=True)
        if db < WRITER_MIN_PSNR:
            raise AssertionError("image writers: the falsecolor JPEG's PSNR "
                                 f"{db:.2f} dB")
        record = json.loads((IMAGE_FIXTURES / "images.json").read_text())[
            IMAGE_GROUND]
        cw, ch = record["written_crop"]
        crop = webp.decode_webp((IMAGE_FIXTURES / IMAGE_GROUND).read_bytes())[
            :ch, :cw]
        bad = []
        for ext, digest in sorted(record["sha256_of_pil_files"].items()):
            got = hashlib.sha256(image_write.encode(
                f"fixture{ext}", crop)).hexdigest()
            if got != digest:
                bad.append(ext)
        print(f"image writers: the ground fixture's {cw}x{ch} files "
              f"({', '.join(sorted(record['sha256_of_pil_files']))}): "
              f"{'all at' if not bad else 'NOT all at'} PIL's hashes",
              flush=True)
        ground = webp.decode_webp((IMAGE_FIXTURES / IMAGE_GROUND).read_bytes())
        for size, rec in record["pil_png_files"].items():
            pw, ph = map(int, size.split("x"))
            t = time.time()
            png = image.encode_png(np.ascontiguousarray(ground[:ph, :pw]))
            enc = time.time() - t
            bad += png_hashes_held(f"image writers: the ground's {size} PNG",
                                   png, rec, record["pil_zlib"], enc)
        if bad:
            raise AssertionError(f"image writers: {bad} differ from PIL's "
                                 "files")
    finally:
        shutil.rmtree(work)
    return err


# phase 36: imgtool convert --tonemap writes phase 35's frame to each of
# these; the fixture's crop is held to PIL's files of each
MORE_WRITER_EXTS = (".eps", ".ps", ".pdf", ".gif", ".jp2", ".j2k", ".jpc",
                    ".jpf", ".jpx", ".j2c", ".ico", ".icns", ".webp")
MORE_WRITER_BAR_S = 10.0    # host seconds, one 1280x720 encode at most


PDF_GMTIME = (2026, 1, 1, 0, 0, 0, 3, 1, 0)   # images.json's pdf_gmtime


def pdf_clock(gmtime=PDF_GMTIME):
    """time.gmtime fixed at gmtime (a 9-tuple): the PDF writer's dates
    (PIL's and the port's both call it at save)."""
    return mock.patch("time.gmtime", return_value=time.struct_time(
        tuple(gmtime)))


def icon_entries(data: bytes):
    """(the directory's fields that do not depend on the entries' lengths,
    the entries' PNG streams) of an ICO or ICNS file: ICO's header and
    the first 8 bytes of each entry (size, colours, planes, bits); ICNS's
    magic and its blocks' types in order (the table of contents first)."""
    entries = []
    if data[:4] == b"icns":
        directory, i = data[:4], 8
        while i < len(data):
            kind, n = struct.unpack_from(">4sI", data, i)
            directory += kind
            if kind != b"TOC ":
                entries.append(data[i + 8:i + n])
            i += n
        return directory, entries
    (n,) = struct.unpack_from("<H", data, 4)
    directory = data[:6]
    for i in range(n):
        e = data[6 + 16 * i:22 + 16 * i]
        directory += e[:8]
        size, at = struct.unpack_from("<II", e, 8)
        entries.append(data[at:at + size])
    return directory, entries


def png_idat_stream(data: bytes) -> bytes:
    """The decompressed IDAT stream of a PNG file (its filtered rows, each
    with its filter type byte): what the encoder chose, whatever the zlib
    that deflated it."""
    import zlib

    i, parts = 8, []
    while i < len(data):
        n, kind = struct.unpack_from(">I4s", data, i)
        if kind == b"IDAT":
            parts.append(data[i + 8:i + 8 + n])
        i += 12 + n
    return zlib.decompress(b"".join(parts))


def png_hashes_held(what, data, rec, pil_zlib, enc=None):
    """Holds a PNG (or ICO / ICNS) file to images.json's record of PIL's:
    its IDAT streams' SHA-256 always (the filters: the port's own choice),
    the whole file's where this host's zlib is PIL's (pil_zlib; deflate's
    bytes are the platform library's), else printing both versions.
    Prints a line; returns [what] if a hash held differs, else []."""
    import hashlib
    import zlib

    if data[:4] in (b"\0\0\1\0", b"icns"):
        streams = [png_idat_stream(e) for e in icon_entries(data)[1]]
        want = rec["idat_streams"]
    else:
        streams, want = [png_idat_stream(data)], [rec["sha256_of_idat_stream"]]
    idat_ok = [hashlib.sha256(x).hexdigest() for x in streams] == want
    file_ok = hashlib.sha256(data).hexdigest() == rec["sha256"]
    same_zlib = zlib.ZLIB_RUNTIME_VERSION == pil_zlib
    held = idat_ok and (file_ok or not same_zlib)
    took = "" if enc is None else f", encode {enc:.3f} s"
    print(f"{what}: {len(data)} bytes (PIL's {rec['bytes']}){took}; "
          f"{len(streams)} IDAT stream(s) {'at' if idat_ok else 'NOT at'} "
          f"PIL's SHA-256; the file's SHA-256 "
          + (f"{'at' if file_ok else 'NOT at'} PIL's (zlib {pil_zlib} here "
             "too)" if same_zlib else
             f"not held: this host's zlib is {zlib.ZLIB_RUNTIME_VERSION}, "
             f"PIL's {pil_zlib} (it is {'at' if file_ok else 'not at'} "
             "PIL's)"), flush=True)
    return [] if held else [what]


def psnr_rgb(a, b):
    """RGB PSNR (dB) of uint8 a against b; inf where they are equal."""
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))


def phase_more_writers(keep, card):
    """Phase 36 (see the module docstring); keep holds phase 35's frame.
    Returns the largest |diff| of a lossless file's read-back samples."""
    import contextlib
    import io

    from acceleratedvolrenderer_tpu_torch import native
    from acceleratedvolrenderer_tpu_torch.cli import imgtool
    from acceleratedvolrenderer_tpu_torch.utils import (
        gif_write, image, image_read, image_write, resample, webp,
        webp_write)

    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
    import time_image_decode as tid

    record = json.loads((IMAGE_FIXTURES / "images.json").read_text())[
        IMAGE_GROUND]
    clock = record["pdf_gmtime"]
    src = str(Path(keep) / J2K_MAP_FRAME)
    frame = image.read_exr(src)[0][:, :, :3]
    want = image.to_8bit(frame)
    H, W = want.shape[:2]
    print(f"more image writers: host CPU {tid.cpu_line()}; {card}",
          flush=True)
    native.j2k_library(required=True)       # the C++ tier-1 encoder
    native.vp8_enc_library()                # the C++ VP8 encoder
    work = Path(tempfile.mkdtemp())
    err, files = 0, {}
    try:
        # (a) the card's frame through the CLI to each format
        for ext in MORE_WRITER_EXTS:
            out = work / f"frame{ext}"
            t = time.time()
            with contextlib.redirect_stdout(io.StringIO()), pdf_clock(clock):
                rc = imgtool.main(["convert", "--tonemap", src, str(out)])
            cli = time.time() - t
            if rc != 0:
                raise AssertionError(f"more image writers: imgtool convert "
                                     f"to {ext}: exit code {rc}")
            t = time.time()
            with pdf_clock(clock):
                data = image_write.encode(str(out), want)
            enc = time.time() - t
            if data != out.read_bytes():
                raise AssertionError(f"more image writers: {ext}: imgtool's "
                                     "file is not write_png's encoding")
            files[ext] = data
            fmt = image_write.EXTENSIONS[ext]
            what, d = "", 0
            if fmt == "JPEG2000" and ext in (".jp2", ".j2k"):
                px = image._decode_image(str(out), data)
                d = int(np.abs(px.astype(int) - want.astype(int)).max())
                ok = (d == 0 and np.array_equal(
                    image.read_image(str(out))[0], _srgb_to_linear(want))
                    and np.array_equal(imgtool._load(str(out))[0],
                                       want.astype(np.float32) / 255))
                what = (f"read back by read_image and imgtool's loader, "
                        f"max |diff| {d}")
            elif fmt == "JPEG2000":
                ok = data == files[".jp2"]
                what = "the .jp2 file's bytes (PIL writes JP2 here too)"
            elif fmt == "WEBP":
                px = webp.decode_webp(data)
                ok = (np.array_equal(image.read_image(str(out))[0],
                                     _srgb_to_linear(px))
                      and np.array_equal(imgtool._load(str(out))[0],
                                         px.astype(np.float32) / 255))
                what = (f"RGB PSNR {psnr_rgb(px, want):.2f} dB against the "
                        "8-bit frame; read back by read_image and imgtool's "
                        "loader equal to decode_webp's samples")
            elif fmt == "GIF":
                pal, idx = gif_write.quantize(want)
                px = image._decode_image(str(out), data)
                ok = np.array_equal(px, pal[idx])
                d = int(np.abs(px.astype(int) - want.astype(int)).max())
                what = (f"{len(pal)} colours, read back equal to the "
                        f"palette's colours of the indices (max |diff| {d} "
                        "from the frame)")
                d = 0
            elif fmt == "ICO":
                big = resample.thumbnail(want, (256, 256))
                px = image._decode_image(str(out), data)
                ok = np.array_equal(px, big) and np.array_equal(
                    image.read_image(str(out))[0], _srgb_to_linear(big))
                n = len(icon_entries(data)[1])
                what = (f"{n} entries, the {big.shape[1]}x{big.shape[0]} "
                        "one read back equal to resample.thumbnail's")
            elif fmt == "ICNS":
                big = resample.resize(want, (1024, 1024))
                px = image_read.decode_icns(data)[0]
                ok = np.array_equal(px, big) and np.array_equal(
                    image.read_image(str(out))[0],
                    _srgb_to_linear(image_read.icns_array(data)))
                what = ("the 1024x1024 entry equal to resample.resize's; "
                        "read_image as the reference's (RGBX regrouped)")
            elif fmt == "EPS":
                hexed = data.split(b"colorimage\n")[-1].split(b"\n%%")[0]
                ok = bytes.fromhex(hexed.replace(b"\n", b"").decode()) == \
                    want.tobytes()
                what = "its hex samples the frame's"
            else:                                   # PDF
                ok = image_write.encode_jpeg(want) in data
                what = "its DCT stream encode_jpeg's"
            err = max(err, d)
            ok = ok and enc < MORE_WRITER_BAR_S
            print(f"more image writers (a): {ext} {W}x{H}: {len(data)} "
                  f"bytes, imgtool convert {cli:.3f} s (encode {enc:.3f} "
                  f"s, at most {MORE_WRITER_BAR_S:.0f}); {what}"
                  f"{'' if ok else ' WRONG'}", flush=True)
            if not ok:
                raise AssertionError(f"more image writers: {ext} wrong or "
                                     "slow")
        # (b) the committed fixture's crop, held to PIL's files
        cw, ch = record["written_crop"]
        crop = webp.decode_webp((IMAGE_FIXTURES / IMAGE_GROUND).read_bytes())[
            :ch, :cw]
        bad = []
        for ext, digest in sorted(record["sha256_of_pil_files_exact"].items()):
            with pdf_clock(clock):
                got = image_write.encode(f"fixture{ext}", crop)
            if hashlib.sha256(got).hexdigest() != digest:
                bad.append(ext)
        exact = sorted(record["sha256_of_pil_files_exact"])
        print(f"more image writers (b): the ground fixture's {cw}x{ch} files "
              f"({', '.join(exact)}): {'all at' if not bad else 'NOT all at'}"
              " PIL's hashes", flush=True)
        for ext, want_rec in sorted(record["pil_icon_files"].items()):
            t = time.time()
            got = image_write.encode(f"fixture{ext}", crop)
            bad += png_hashes_held(
                f"more image writers (b): the ground fixture's {cw}x{ch} "
                f"{ext}", got, want_rec, record["pil_zlib"], time.time() - t)
        whole = webp.decode_webp((IMAGE_FIXTURES / IMAGE_GROUND).read_bytes())
        for size, rec in record["pil_webp_files"].items():
            ww, hh = map(int, size.split("x"))
            px = np.ascontiguousarray(whole[:hh, :ww])
            t = time.time()
            got = image_write.encode("fixture.webp", px)
            enc = time.time() - t
            head = webp_write.header_fields(got)
            q = psnr_rgb(webp.decode_webp(got), px)
            ok = (head == rec["header"]
                  and 0.9 * rec["bytes"] <= len(got) <= 1.1 * rec["bytes"]
                  and q >= rec["psnr_rgb"] - 0.5
                  and hashlib.sha256(got).hexdigest() == rec["sha256"])
            print(f"more image writers (b): the ground fixture's {size} as "
                  f"WebP: {len(got)} bytes (PIL's {rec['bytes']}), RGB PSNR "
                  f"{q:.2f} dB (PIL's {rec['psnr_rgb']:.2f}), header, size, "
                  f"PSNR and SHA-256 {'at' if ok else 'NOT at'} PIL's file's; "
                  f"encode {enc:.3f} s", flush=True)
            if not ok:
                bad.append(f".webp {size}")
        if bad:
            raise AssertionError(f"more image writers: {bad} differ from "
                                 "PIL's files")
    finally:
        shutil.rmtree(work)
    return err


def phase_read_formats(card):
    """Phase 37 (see the module docstring), in the side process."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
    import avif_maps
    import more_read_formats as mrf
    import pil_only_formats as pof
    import time_image_decode as tid

    avif_small = (avif_maps.AVIF_SMALL + avif_maps.TOOL_SMALL
                  + avif_maps.SCREEN_SMALL)
    n_records = (len(mrf.fixture_records()) + len(pof.fixture_records())
                 + len(avif_small))
    rows = (mrf.decode_fixtures() + pof.decode_fixtures()
            + avif_maps.decode_fixtures(avif_small))
    print(f"read formats: host CPU {tid.cpu_line()}; {card}", flush=True)
    for name, secs, shape, ok in rows:
        print(f"read formats: {name} {tuple(shape)} decoded in {secs:.4f} s"
              f", {'at' if ok else 'NOT at'} PIL's SHA-256", flush=True)
    bad = [name for name, *_, ok in rows if not ok]
    if not rows or len(rows) != n_records or bad:
        raise AssertionError(f"read formats: {len(rows)} fixtures of "
                             f"{n_records} recorded, {bad} differ from "
                             "PIL's decode")


PIL_ONLY_SKY = (768, 512)          # phase 38's PCD sky: PhotoCD's base size


def phase_pil_only_maps(dev, keep, uniform_mean, card):
    """Phase 38 (see the module docstring); keep holds phase 32's medium
    file and ground samples.  Returns the frame's march launches and its
    captured call's max |diff|."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
    import pil_only_formats as pof
    import time_image_decode as tid

    from acceleratedvolrenderer_tpu_torch.utils import image

    record = json.loads((IMAGE_FIXTURES / "images.json").read_text())
    print(f"PIL-only maps: host CPU {tid.cpu_line()}; {card}", flush=True)
    files = pof.phase38_files(tid.sky(*PIL_ONLY_SKY, 255),
                              np.load(Path(keep) / IMAGE_GROUND_SAMPLES))
    work = Path(tempfile.mkdtemp())
    try:
        # (a) the files and the port's decodes at PIL's hashes
        bad = []
        for name, data in sorted(files.items()):
            rec = record[name]
            t = time.perf_counter()
            px = image._decode_image(name, data)
            secs = time.perf_counter() - t
            ok = (hashlib.sha256(data).hexdigest() == rec["sha256_of_bytes"]
                  and list(px.shape) == rec["shape"]
                  and hashlib.sha256(np.ascontiguousarray(px).tobytes())
                  .hexdigest() == rec["sha256_of_pil_samples"])
            print(f"PIL-only maps (a): {name} {px.shape[1]}x{px.shape[0]}: "
                  f"{len(data)} bytes, decode {secs:.3f} s; bytes and "
                  f"samples {'at' if ok else 'NOT at'} images.json's "
                  "hashes (PIL's)", flush=True)
            if not ok:
                bad.append(name)
            (work / name).write_bytes(data)
        if bad:
            raise AssertionError(f"PIL-only maps: wrong files or decodes "
                                 f"{bad}")
        # (b) the frame: the PCD sky and the FTEX ground by the CLI
        return maps_frame("PIL-only maps (b)", dev, keep, work, pof.PCD_SKY,
                          pof.FTEX_GROUND, uniform_mean, card)
    finally:
        shutil.rmtree(work)


AVIF_SKY_BAR_S = 10.0     # host seconds a 2048x1024 AVIF sky may take


def avif_maps_phase(what, maps, dev, keep, uniform_mean, card):
    """Phases 39-41: (a) the committed AVIF sky and ground (maps: the
    names of scripts/avif_maps.py's constants that hold their file names)
    decoded once each, held to images.json's hashes, the sky under
    AVIF_SKY_BAR_S, the decode's header bits and block counts printed and
    held to avif_maps.TOOLS_ON; (b) their frame through maps_frame.  Returns the
    frame's march launches and its captured call's max |diff|."""
    from acceleratedvolrenderer_tpu_torch import native

    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
    import avif_maps
    import time_image_decode as tid

    sky, ground = (getattr(avif_maps, m) for m in maps)
    print(f"{what}: host CPU {tid.cpu_line()}; {card}", flush=True)
    t0 = time.time()
    native.av1_library()
    print(f"{what}: C++ AV1 decoder built or loaded in "
          f"{time.time() - t0:.2f} s", flush=True)
    # (a) each map decoded once, held to the hashes of its bytes and of
    # PIL's samples
    records = avif_maps.fixture_records()
    bad = []
    for name in (sky, ground):
        with avif_maps.av1_counts() as c:
            data, px, secs = avif_maps.decode(name)
        ok = avif_maps.held(name, data, px, records[name])
        print(f"{what} (a): {name} {px.shape[1]}x{px.shape[0]}: "
              f"{len(data)} bytes, decode {secs:.3f} s "
              f"({1e6 * secs / (px.shape[0] * px.shape[1]):.3f} us/pixel); "
              f"bytes and samples {'at' if ok else 'NOT at'} images.json's "
              "hashes (PIL's)", flush=True)
        print(f"{what} (a): {name}'s AV1 frames: film grain {c['grain']}, "
              f"allow_screen_content_tools {c['screen']}, allow_intrabc "
              f"{c['intrabc']}; blocks: palette {c['palette_blocks']} "
              f"({c['palette_uv_blocks']} in chroma), intra block copy "
              f"{c['intrabc_blocks']}, delta q {c['delta_q_blocks']}, "
              f"CDEF {c['cdef_blocks']}", flush=True)
        if not ok:
            bad.append(name)
        off = [k for k in avif_maps.TOOLS_ON.get(name, ()) if not c[k]]
        if off:
            bad.append(f"{name} with no {off}")
        if name == sky and secs >= AVIF_SKY_BAR_S:
            bad.append(f"{name} in {secs:.2f} s (bar {AVIF_SKY_BAR_S} s)")
    if bad:
        raise AssertionError(f"{what}: wrong or slow decodes {bad}")
    # (b) the frame: the AVIF sky and ground by the CLI
    work = Path(tempfile.mkdtemp())
    try:
        for name in (sky, ground):
            shutil.copy(IMAGE_FIXTURES / name, work / name)
        return maps_frame(f"{what} (b)", dev, keep, work, sky, ground,
                          uniform_mean, card)
    finally:
        shutil.rmtree(work)


def phase_avif_maps(dev, keep, uniform_mean, card):
    """Phase 39 (see the module docstring); keep holds phase 32's medium
    file."""
    return avif_maps_phase("AVIF maps", ("AVIF_SKY", "AVIF_GROUND"), dev,
                           keep, uniform_mean, card)


def phase_avif_tools_maps(dev, keep, uniform_mean, card):
    """Phase 40 (see the module docstring); keep holds phase 32's medium
    file."""
    return avif_maps_phase("AVIF tools maps", ("TOOLS_SKY", "TOOLS_GROUND"),
                           dev, keep, uniform_mean, card)


def phase_avif_screen_grain_maps(dev, keep, uniform_mean, card):
    """Phase 41 (see the module docstring); keep holds phase 32's medium
    file."""
    return avif_maps_phase("AVIF screen and grain maps",
                           ("GRAIN_SKY", "SCREEN_GROUND"), dev, keep,
                           uniform_mean, card)


def timed(name, fn, *args):
    t0 = time.time()
    out = fn(*args)
    print(f"[phase {name}: {time.time() - t0:.1f} s]", flush=True)
    return out


T0 = time.time()


# ---------------------------------------------------------------------------
# The side process: the phases that need neither phase 8's scene nor its
# frames run in a second process on the same card, beside the parent's
# ---------------------------------------------------------------------------

SIDE_PHASES = ("5-7, 12, 13, 15-17, 19-22, 24, 26, 29's small legs, 30 "
               "and 37")
SIDE_TIMEOUT = 900               # seconds the side process may take in all


def side_main(work):
    """This script with --side WORK: the side phases on the card in this
    order, at half this host's CPU threads (the parent keeps the rest).
    Phase 24's path frame and means and phase 15's render() frame go to
    WORK/handoff.pkl once both exist (the parent's phases 27 and 29 read
    them); the numbers for the kernels' record go to WORK/side.json at the
    end."""
    from acceleratedvolrenderer_tpu_torch import kernels

    work = Path(work)
    dev = torch.device("cuda", 0)
    card = card_line()
    kernels.library()
    torch.set_num_threads(max(1, torch.get_num_threads() // 2))
    room_rec, room_means = timed("room", phase_room, dev, card)
    fog_rec = timed("fog box", phase_fog, dev, card)
    tmp = work / "handoff.pkl.tmp"
    with open(tmp, "wb") as f:
        pickle.dump({"room_means": room_means, "frames": {
            k: FRAMES[k] for k in (("room", "path"),
                                   ("fog box", "render"))}}, f)
    os.replace(tmp, work / "handoff.pkl")
    out = {"gather_rec": dict(fog_rec, **room_rec)}
    timed("read formats", phase_read_formats, card)
    fused_gpu = timed("small frame", phase_small_frame, dev)
    out["window_launches"] = timed("window frame", phase_window_frame, dev,
                                   fused_gpu)
    timed("wave small", phase_wave_small, dev)
    timed("grad fd", phase_grad_fd, dev)
    timed("wave grad fd", phase_wave_grad_fd, dev)
    out["chunk65536_launches"] = (
        timed("emissive", phase_emissive, dev, card)
        + timed("explosion", phase_explosion, dev, card))
    timed("knobs", phase_knobs, dev)
    timed("tracking", phase_tracking, dev)
    timed("graph small", phase_graph_small, dev)
    out["graph_launches"] = timed("graph full", phase_graph_full, dev, card)
    timed("room samplers", phase_room_samplers, dev, room_means, card)
    timed("other integrators, small", phase_integrators_small, dev, card)
    out["item1_counts"], out["item1_max_abs_err"] = timed(
        "item1", phase_item1, dev, card)
    out["ended_at"] = time.time()
    (work / "side.json").write_text(json.dumps(out))
    print(f"side: {time.time() - T0:.1f} s wall", flush=True)
    return 0


class Side:
    """The side process (side_main), started by the parent after phase 11.
    Its output goes to a file, printed when it ends (or, if the parent
    fails first, to stderr once stop has ended it)."""

    def __init__(self):
        self.tmp = tempfile.TemporaryDirectory()
        self.work = Path(self.tmp.name)
        self.log = open(self.work / "side.log", "w")
        self.shown = False
        self.t0 = time.time()
        self.proc = subprocess.Popen(
            [sys.executable, "-u", os.path.abspath(__file__), "--side",
             str(self.work)], stdout=self.log, stderr=subprocess.STDOUT)

    def output(self):
        self.log.flush()
        return (self.work / "side.log").read_text()

    def _left(self):
        return SIDE_TIMEOUT - (time.time() - self.t0)

    def handoff(self):
        """Phase 24's path means, and its path frame and phase 15's
        render() frame into FRAMES, once the side process has them."""
        path = self.work / "handoff.pkl"
        while not path.exists():
            if self.proc.poll() is not None:
                raise RuntimeError(f"side process ended (exit code "
                                   f"{self.proc.returncode}) before its "
                                   "handoff")
            if self._left() < 0:
                raise RuntimeError(f"side process: no handoff after "
                                   f"{SIDE_TIMEOUT} s")
            time.sleep(0.5)
        with open(path, "rb") as f:
            h = pickle.load(f)
        FRAMES.update(h["frames"])
        return h["room_means"]

    def finish(self):
        """Waits for the side process, prints its output and returns its
        side.json; raises if it failed or outlived SIDE_TIMEOUT."""
        try:
            rc = self.proc.wait(timeout=max(1.0, self._left()))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"side process still running after "
                               f"{SIDE_TIMEOUT} s") from None
        print(f"side process (phases {SIDE_PHASES}), exit code {rc}:\n"
              + self.output(), end="", flush=True)
        self.shown = True
        if rc != 0:
            raise RuntimeError(f"side process failed (exit code {rc})")
        return json.loads((self.work / "side.json").read_text())

    def stop(self):
        """Ends the side process if it still runs and removes its files."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if not self.shown:
            print(f"side process (phases {SIDE_PHASES}), exit code "
                  f"{self.proc.returncode}:\n" + self.output(),
                  file=sys.stderr, flush=True)
        self.log.close()
        self.tmp.cleanup()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {name} ({torch.cuda.device_count()} visible)", flush=True)
    print(f"card: {card}", flush=True)

    from acceleratedvolrenderer_tpu_torch import kernels

    kernels.library()
    built = ("reused " + str(kernels.LIB_PATH) if kernels.build_seconds is None
             else f"{kernels.build_seconds:.1f} s")
    print(f"build: {built}\n{kernels.build_log.strip()}", flush=True)

    march_rec = timed("kernel", phase_kernel, dev)
    gather_rec = timed("gather", phase_gather, dev)
    dma_rec = timed("dma", phase_dma, dev)
    dma_runs, dma_calls = timed("gather designs", phase_gather_designs,
                                dev)
    gather_rec.update(timed("gather v1", phase_gather_v1, dev))
    side = Side()
    try:
        launches, scene, slice_rec = timed("slice", phase_slice, dev, card)
        wave_img = timed("wave full", phase_wave_full, dev, scene,
                         slice_rec[0], card)
        timed("grad full", phase_grad_full, dev, scene, card)
        march_rec.update(timed("residual", phase_residual, dev, scene,
                               slice_rec, card))
        march_rec.update(timed("cloud surfaces", phase_cloud_surfaces, dev,
                               scene, card))
        sky_rec, sky = timed("sky", phase_sky, dev, scene,
                             slice_rec + (launches,), card)
        march_rec.update(sky_rec)
        keep = tempfile.TemporaryDirectory()
        march_n, gather_n = timed("scene file", phase_scene_file, dev, scene,
                                  wave_img, card, keep.name)
        room_means = timed("side handoff", side.handoff)
        integ_counts, march_rec["integrators_depth4_render_launches"] = timed(
            "other integrators", phase_integrators, dev, scene, card)
        timed("portal entries", phase_portal_entries, dev, sky, room_means,
              card)
        shard = timed("sharding", phase_sharding, dev, scene, card)
        (march_rec["image_formats_launches"],
         march_rec["image_formats_max_abs_err"], uniform_mean) = timed(
            "image formats", phase_image_formats, dev, keep.name, card)
        march_rec["image_writers_max_abs_err"] = timed(
            "image writers", phase_image_writers, keep.name, card)
        (march_rec["bcn_maps_launches"],
         march_rec["bcn_maps_max_abs_err"]) = timed(
            "block maps", phase_block_maps, dev, keep.name, uniform_mean,
            card)
        (march_rec["j2k_maps_launches"],
         march_rec["j2k_maps_max_abs_err"]) = timed(
            "JPEG 2000 maps", phase_j2k_maps, dev, keep.name, uniform_mean,
            card)
        march_rec["more_image_writers_max_abs_err"] = timed(
            "more image writers", phase_more_writers, keep.name, card)
        (march_rec["pil_only_maps_launches"],
         march_rec["pil_only_maps_max_abs_err"]) = timed(
            "PIL-only maps", phase_pil_only_maps, dev, keep.name,
            uniform_mean, card)
        (march_rec["avif_maps_launches"],
         march_rec["avif_maps_max_abs_err"]) = timed(
            "AVIF maps", phase_avif_maps, dev, keep.name, uniform_mean,
            card)
        (march_rec["avif_tools_maps_launches"],
         march_rec["avif_tools_maps_max_abs_err"]) = timed(
            "AVIF tools maps", phase_avif_tools_maps, dev, keep.name,
            uniform_mean, card)
        (march_rec["avif_screen_grain_maps_launches"],
         march_rec["avif_screen_grain_maps_max_abs_err"]) = timed(
            "AVIF screen and grain maps", phase_avif_screen_grain_maps, dev,
            keep.name, uniform_mean, card)
        parent_end = time.time()
        keep.cleanup()
        side_out = timed("side process", side.finish)
    finally:
        side.stop()
    march_rec["scene_file_launches"] = march_n
    gather_rec["scene_file_launches"] = gather_n
    march_rec["sharding_world1_launches"] = shard["world1"]
    march_rec["sharding_rank_launches"] = shard["ranks"]
    march_rec["sharding_max_abs_err"] = shard["max_abs_err"]
    march_rec["chunk65536_launches"] = side_out["chunk65536_launches"]
    gather_rec.update(side_out["gather_rec"])
    graph_launches = side_out["graph_launches"]
    item1_counts = side_out["item1_counts"]
    march_rec["item1_max_abs_err"] = side_out["item1_max_abs_err"]

    src = "acceleratedvolrenderer_tpu_torch/csrc/"
    print(f"chip_smoke: {time.time() - T0:.1f} s wall; the parent's phases "
          f"ended {parent_end - side_out['ended_at']:.1f} s after the side "
          "process's")
    print(card)
    print(json.dumps({"kernels": [
        dict(name="march_block", route="cuda", source=src + "march.cu",
             replaces="acceleratedvolrenderer_tpu/ops/pallas_march.py:105",
             launches=launches, graph_launches=graph_launches[0],
             integrators_launches=integ_counts[0],
             item1_launches=item1_counts[0], **march_rec),
        dict(name="table_gather", route="cuda", source=src + "gather.cu",
             replaces="acceleratedvolrenderer_tpu/ops/pallas_gather.py:33",
             launches=side_out["window_launches"],
             graph_launches=graph_launches[1],
             integrators_launches=integ_counts[1],
             item1_launches=item1_counts[1], **gather_rec),
        dict(name="dma_gather", route="cuda", source=src + "dma_gather.cu",
             replaces="scripts/measure_gather_designs.py:44",
             launches=dma_runs, wrapper_calls=dma_calls,
             graph_launches=graph_launches[2],
             integrators_launches=integ_counts[2],
             item1_launches=item1_counts[2], **dma_rec)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shard-rank"]:
        sys.exit(shard_rank(int(sys.argv[2]), int(sys.argv[3]),
                            int(sys.argv[4]), sys.argv[5], sys.argv[6],
                            sys.argv[7]))
    if sys.argv[1:2] == ["--side"]:
        sys.exit(side_main(sys.argv[2]))
    sys.exit(main())
