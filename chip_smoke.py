#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (trace_tpu_torch) on one GPU.

    python3 chip_smoke.py [--parent DIR]

(``--parent``: another checkout, e.g. the parent commit unpacked with
``git archive`` into a git-ignored directory, whose cells' images phase
18c holds bit-equal to this checkout's.)

Phases (each prints lines with its seconds; any failure raises):
  0. device: the card's name and power limit, torch and CUDA versions;
  1. build: the sweep, prologue, intersect, walk, splat and Threefry
     kernels (one
     nvcc each, in parallel, sm_90a) with ptxas's registers and spills
     per kernel arm, the sweep's warps per CTA, and the SAH builder (g++);
  2. kernel vs plain, on the main paths' own launches:
     a. the 1M-triangle mesh_heavy scene: every sweep launch of one 256^2
        depth-2 frame (camera, shadow and specular rays, in the frame's
        own 65536-ray chunks that hold a live lane), plus the camera rays
        as any-hit; the prologue kernel's (order, suffix) against its plain
        version on every launched chunk (bit-equal), and every skipped
        chunk checked to hold no live lane;
     b. the same scene with exact_shared_edges=True: every sweep launch of
        its frame, through the certified kernel and the bf16, hi/lo,
        certified-bf16 and certified-hi/lo arms, each against its plain
        version, with step counts; the double-buffered kernel against the
        single-buffered one; certified hit masks against the plain f32 ones;
        the prologue kernel on every launched chunk, bit-equal;
     c. the fused brute-force kernel against its plain version on every
        launch of the 5k-triangle scene's 256^2 frame (bit-equal), timed
        on the camera rays;
  3. correctness of the images and of the edges:
     a. 65536 rays aimed at points on the shared quad diagonals of the 1M
        heightfield: misses with exact edges off and on (on: must be 0);
     b. golden: the 5k-triangle scene at 32^2 -- default, with exact edges,
        and with exact edges through the fused accelerator -- against
        tests/goldens/mesh_heavy5k_32.npy (the JAX package's render),
        MSE < 5e-4 each;
  4. the slices, timed with CUDA events (one warm frame, then three): the
     1M-triangle 256^2 frame by default and with exact_shared_edges=True
     (the PNGs go to the temporary directory, TMPDIR); each sweep option
     (bf16 and hi/lo panels, with and without exact edges; the
     double-buffered copy; step counts) and the fused accelerator on the
     5k-triangle scene, each driven as its own frame with the launch
     counts set to 0 before it and read after it (the prologue kernel
     must launch once per sweep launch; chunks skipped are counted); then
     every sweep launch of the default and exact-edge frames: kernel ms,
     plain ms, bound ms and its share, steps, the busiest block's steps
     and the us per busiest-block step, and the prologue kernel's ms
     against the torch route's (the entry table kernel, torch.argsort and
     a reverse cummin), the plain version's and its bound; the same on
     the camera chunk with every lane dead; then the camera chunk's kernel
     time per arm (block of 32 rays) against the plain version, with
     steps, bound and panel GB/s per launch; blocks of 48 and 1024 rays
     must be refused (ValueError: the kernel serves blocks of 32k rays,
     1 <= k <= 16); the same chunk at each (group, block) of TILINGS --
     (8, 32), (8, 128), (8, 512) and bench config 6's (64, 128), GL 4096
     -- and config 6's own launch shape, 8192 rays at (64, 128) (64 ray
     blocks: the chunk's first, which enter no super, and its first 8192
     that hit), f32 and certified, graph-timed, with plain ms, steps and
     bound, bit-equal to plain, the tiled kernel's cluster
     shape (as the CUDA library computes it, equal to ops.sweep's mirror)
     and ptxas's registers and spills, and the bf16, hi/lo,
     step-counting and double-buffered arms graph-timed; every arm at
     each of ARM_TILINGS on every 32nd ray of the chunk, closest and
     any-hit, t, slot and steps bit-equal to plain, the prologue
     bit-equal at each block;
  5. slice 3, the shadows and Cornell scenes and the path tracer:
     a. goldens on the card: shadows 16^2 (Whitted, 1 spp, seed 11, depth
        3) against tests/goldens/shadows16.npy and Cornell 48^2 (path
        tracer, 8 spp, seed 3, depth 4) against cornell48_planar.npy, MSE
        < 5e-4 each;
     b. bench config 1: shadows, Whitted, 256^2, 4 spp, depth 5, seed 0,
        level_caps (0.5, 0.25, 0.1875, 0.125): queue_drops 0, the capped
        frame equal to the uncapped one (MSE < 1e-8), timed;
     c. bench config 2: Cornell, path tracer, 512^2, 4 spp, depth 5, seed
        0: a finite frame, timed, with useful rays and peak memory;
     d. the path tracer on the 1M-triangle mesh_heavy (256^2, 1 spp, depth
        3): every sweep launch of one frame (camera, diffuse bounces and
        shadow rays, in the frame's own chunks) against the plain version,
        with kernel ms, plain ms, bound ms, steps, the busiest block's
        steps and the us per busiest-block step per launch, and the
        prologue kernel bit-equal and timed on every launched chunk; the
        frame timed.
  6. slice 5, SPPM (details in chiprun_out/slice5.json):
     a. goldens on the card: the 5k-triangle mesh_heavy at 32^2 through the
        sweep (2 iterations, 16384 photons, depth 8, radius 1.0, seed 0)
        against tests/goldens/sppm_mesh5k_32.npy, and shadows at 16^2 (2
        iterations, 1024 photons, depth 4, radius 0.25, seed 1) against
        sppm_shadows16.npy, MSE < 5e-4 each;
     b. every sweep launch of one SPPM iteration on the 1M-triangle mesh
        at 256^2 (65536 photons, depth 8, radius 0.3): camera closest-hit
        and shadow any-hit, photon closest-hit, each against sweep_plain
        (hits, ids, t within T_RTOL, the same steps), the prologue kernel
        bit-equal on every launched chunk, each launch timed as in 5d; and
        the prologue kernel on the mesh packed at group 1 (one cluster a
        super) on the photon depth-1 chunk, at its shared-memory key
        capacity and at half the median row's finite entries (rows with
        more sort in the global workspace), bit-equal to the plain version
        and timed;
     c. the full-width run, bench config 3's settings on the 1M mesh:
        1024^2, 262144 photons an iteration, depth 8, radius 0.075, seed 0;
        one warm iteration and three timed, each with its phases' ms (CUDA
        events: camera pass, grid, photon walk, pair pass, update, the
        last with the counters' host reads), visible points, occupied
        cells, pairs, splat records, sweep and prologue launches, chunks
        skipped; peak
        memory; the pair reduction's ms; a finite image with photons
        gathered,
        its PNG in TMPDIR;
     d. the first 1024^2 iteration run twice gives the same bits; at 256^2,
        two iterations straight give the same bits as one, a checkpoint
        and one resumed.
  7. animated geometry (details in chiprun_out/slice7.json):
     a. the 1M mesh, resident on the card, moved (translate, rotate_y)
        and rebuilt there (transform, Morton clusters of 64, supers of 8):
        ms (CUDA events, median of 5 after a warm one), clusters, supers
        and peak memory; the device-packed tables bit-equal to the host
        packing of the same clusters, and the whole build bit-equal to
        the same build on the CPU; the scene's SAH tables refit to the
        moved mesh (super boxes equal to the moved vertices' own) and
        back (equal to the static tables);
     b. the animated 1M Whitted frame (256^2, 1 spp, depth 2,
        render(geometry=base, geometry_transform=...)), driven with the
        counts set to 0 before it: every sweep launch against sweep_plain
        (hits, ids, t within T_RTOL, the same steps) and the prologue
        kernel bit-equal on every launched chunk; the frame against the
        scene built with the moved terrain (SAH tables), MSE < 5e-4, with
        the lanes whose hit or triangle differs; the sweep's steps, the
        busiest block's steps and kernel ms on Morton supers against the
        SAH supers for the same rays; frames timed (one warm, three);
     c. bench config 5's settings on a stand-in (caustic_glass's floor,
        camera, materials and moving lights around an 88,208-triangle UV
        sphere in place of the absent PLY): 128^2, 2 SPPM iterations a
        frame, 65536 photons, depth 5, radius 0.055, set_frame_lights and
        a translation of the whole scene a frame; after a warm frame,
        four frames each with its rebuild, view and per-phase ms, sweep
        and prologue launches, chunks skipped and pixels with photons
        (> 0, finite); every
        sweep launch of one frame against sweep_plain; render_frames'
        frame k bit-equal to the render of frame k, and pre-moved
        triangles bit-equal to the same frame moved on the card.
  8. environment lights and the pbrt / thin-lens camera (details in
     chiprun_out/slice8.json):
     a. goldens on the card: env_studio 32^2 (path tracer, 4 spp, depth 3,
        seed 0, pbrt camera) against tests/goldens/env_studio32.npy, and
        the 5k-triangle mesh_heavy with its point light and env_studio's
        sky (rotate_x(-90)) at 32^2 (Whitted, 1 spp, depth 2, seed 0)
        against mesh_heavy5k_env_32.npy, MSE < 5e-4 each, and every
        pixel within 1e-3 of its golden (on the 5k frame, outside lane
        630's 3 x 3, ROADMAP C); 65536 rays with
        differentials of the pbrt camera with a thin lens (radius 0.05)
        on the card against the same rays on the CPU (max abs <= 1e-6);
     b. env_studio at its own settings (512^2, path tracer, depth 5,
        Lanczos; spp cut from 64 to 4): one warm frame and three timed,
        useful rays, peak memory; a finite frame whose two top corners (their
        centre rays miss) read the sky along those rays within 5%; no
        kernel (brute-force triangles); its PNG in TMPDIR;
     c. bench config 4's settings with the sky added (1M mesh_heavy,
        Whitted, 256^2, 1 spp, depth 2, seed 0): launches and chunks
        skipped with the counts set to 0 before the frame, every sweep
        launch (camera, point and sky shadow, specular rays) against
        sweep_plain and the prologue kernel bit-equal on every launched
        chunk; frames timed beside the point-lit frame in the same call;
     d. SPPM under the sky alone on the 1M mesh (256^2, 65536 photons,
        depth 5, radius 0.3): one warm iteration and two timed with their
        phases' ms, launches and chunks skipped; every sweep launch of one
        iteration against sweep_plain, the prologue bit-equal; a finite
        image with photons gathered; and test_sppm.py's open box under a
        constant sky (12^2, 8 iterations of 8192 photons): the SPPM/path
        tracer mean ratio in (0.5, 2).
  9. instanced geometry (details in chiprun_out/slice9.json):
     a. sphere_field at n = 6, 32^2 (Whitted, 1 spp, depth 2, seed 0)
        against tests/goldens/sphere_field6_32.npy, MSE < 5e-4;
        test_instances.py's tetrahedron and grid pairs (four placements),
        Whitted 24^2, instanced against flattened on the card, MSE < 1e-6
        (the grid's base through the sweep kernel); the grid pair's
        closest hits of 4096 probe rays on the card against the CPU:
        equal hit masks, t within 1e-6 relative;
     b. sphere_field at its own settings (1024 instances of a clipped
        sphere, Whitted, 512^2, 4 spp, depth 3, Lanczos, pbrt camera,
        seed 0): the camera rays' instance walk at each group size of
        INST_GROUPS (ms, groups visited, the same results), one warm frame
        and three timed, peak memory, useful rays, the walk calls and
        instance groups visited; no sweep launch (spheres and a 2-triangle floor);
     c. 100 copies (10 x 10, rotated, two mirrored) of the 88,208-triangle
        glass stand-in on a floor under a point light, Whitted 256^2, 1
        spp, depth 2, seed 0: launches with the counts set to 0 before the
        frame, every sweep launch against sweep_plain and the prologue
        kernel bit-equal on every launched chunk, skipped chunks dead; the
        camera walk by group size; frames timed, peak memory beside the
        flattened scene's sweep tables and rows (100 x the base's), kernels
        a frame and the busy share; a 3 x 3 grid of the stand-in at 64^2
        against its flattened twin (793,874 triangles): MSE < 5e-4, hit
        masks within 1% of the camera rays;
     d. the path tracer (256^2, 1 spp, depth 3, timed) and SPPM (256^2,
        65536 photons, depth 5, radius 0.3; one warm iteration and two
        timed with their phases' ms and launches) on 9c's scene.
  10. several lights of any kind in one scene, and image textures
     (details in chiprun_out/slice10.json):
     a. goldens on the card: __graft_entry__.py's _dryrun_scene (flat and
        instanced geometry; an area, a point and an environment light),
        built here by dryrun_builder with the port's SceneBuilder, pbrt
        camera, Lanczos: Whitted and the path tracer at 16^2 (1 spp,
        depth 2, seed 0), SPPM at 16^2 (radius 0.2, depth 2, 1 iteration
        of 1024 photons), and Whitted at 32^2 on the scene with a
        mip-mapped image on the floor and a mixed texture on a sphere,
        against tests/goldens/dryrun16_{whitted,path,sppm}.npy and
        dryrun32_tex_whitted.npy, MSE < 5e-4 each; texture lookups on
        65536 seeded lanes on the card against the CPU: max abs <= 1e-6,
        level or texel flips in at most 1 lane in 1000;
     b. the 1M mesh_heavy terrain and glass sphere lit by its point light,
        the sky and a 2 x 2 emissive quad facing down, the terrain's Kd an
        ImageTexture (a procedural 256^2 image written with write_png,
        read back with read_png, mapped from world x, z; repeat, sRGB):
        Whitted (256^2, 1 spp, depth 2), the path tracer (256^2, 1 spp,
        depth 3) and SPPM (256^2, 65536 photons, depth 5, radius 0.3),
        each with its launches counted from 0, every sweep launch against
        sweep_plain and the prologue bit-equal on every launched chunk;
        the path tracer's sweep calls must be one closest hit, one shadow
        and one BSDF-leg call a bounce; frames timed (one warm, three),
        SPPM iterations (one warm, two) with their phases' ms; peak
        memory, useful rays; the
        photons each light emitted in one iteration against the power
        pmf, within 2% absolute.
  11. the render loop's public surface (details in
     chiprun_out/slice11.json):
     a. bench config 4's 1M frame (Whitted 256^2, depth 2, seed 0) with a
        StratifiedSampler(2, 2) (4 spp) and RenderStats: every lane's
        film sample inside its stratum, launches counted from 0, every
        sweep launch against sweep_plain and the prologue bit-equal on
        every launched chunk; frames timed (one warm, three), the
        RenderStats counters, peak memory;
     b. the same frame under a GaussianFilter((2, 2)) film, full and
        cropped to ((0.25, 0.25), (0.75, 0.75)): the crop's pixels equal
        to the full frame's window inside the crop's outer ring (the
        reference's footprint reaches one pixel past the cropped film's
        sample bounds, so the ring is reported), max abs <= 1e-6; one
        BoxFilter and one TriangleFilter frame, finite; launches per frame;
     c. Scene.intersect and intersect_p on 65536 camera rays of the 1M
        mesh through the sweep, timed: intersect_p equal to the sources'
        raw closest-hit masks and holding every hit record (the records
        pass the watertight detail phase, which drops the sweep's hits on
        a few shared edges; counted); on 4096 of them intersect against
        the brute-force intersect.cu route: hits equal, t within T_RTOL,
        ids equal but where both triangles give the same t;
        trace_profile around one query holds the sweep's kernel events;
     d. Film.add_samples of 2^20 samples over a 512^2 film: the same bits
        twice, within 1e-5 relative of the CPU's (whose serial sums
        associate otherwise), against add_samples_grid on the full
        grid within 1e-6 relative, add_splats dropping splats outside the
        film; each splat timed;
     e. python -m trace_tpu_torch.utils.compare on 11b's crop PNG and
        the full frame's window inside the ring: exit 0, MSE <= 1e-6.
 12. the BVH accelerators (details in chiprun_out/slice12.json):
     a. the 1M mesh behind a WBVHAccelerator (Scene.with_geometry; tree
        depth, nodes, MB, host build s); every intersect call of the
        Whitted 256^2 depth-2 frame through the walk kernel and
        walk_plain in both limits ("wbvh", "bvh"), in the accelerator's
        ray order: hits, ids and per-ray counts equal, t within T_RTOL
        (t bits reported); per call the kernel's ms, node visits and
        triangle tests, bound; the camera call's plain ms; the
        coincident-centroid leaf and the on-plane rays, bit-equal and
        right;
     b. 4096 of the frame's camera rays, the walk against the brute-force
        watertight grid: hits equal, t within T_RTOL, ids equal but for
        ties; the walk's hit masks against the sweep's on the frame's
        calls, reported;
     c. the Whitted frame on wbvh and on the sweep (same seed): MSE < 5e-4;
        walk launches a frame (counts set to 0 before the render, read
        after; no sweep launch); frames timed (a warm one, then 3), peak
        GiB, device busy;
     d. SPPM at mesh1m_sppm_256's settings (256^2, 65536 photons, depth
        5, radius 0.3; a warm iteration and two timed) on wbvh and on the
        sweep: finite, pixels gathered within 10% of the sweep's; each
        call of one iteration (camera and photon depths) on the same rays
        through the walk kernel and the sweep's prologue and sweep
        kernels, and each accelerator's whole intersect, device ms;
     e. the 5k mesh at 32^2 on accelerator="clusters" and bvh.attach
        against mesh_heavy5k_32.npy, MSE < 5e-4; 16384 of the 1M camera
        rays through clusters (leaf 64, stage 128): ms, stages, hits
        against the walk's.
 13. the sharded paths, parallel.render.render_sharded and
     SPPMIntegrator(mesh=) (details in chiprun_out/slice13.json); ranks
     are spawned processes that join a process group through a file
     store in TMPDIR, build the 1M scene on cuda:0 and only load the
     kernels phase 1 built:
     a. two gloo ranks sharing cuda:0: bench config 4's Whitted frame
        (256^2, 1 spp, depth 2, seed 0) and mesh1m_path_256 (depth 3),
        then mesh1m_sppm_256's settings (65536 photons, depth 8, radius
        0.3) with shard_camera=True, two iterations; each with its
        launches counted from 0 and timed (CUDA events), run again for
        the same bits; every sweep launch of rank 0 against sweep_plain
        and the prologue bit-equal on every launched chunk; the
        collectives timed in the runs and alone (median of 5 all_reduces
        of each size). Gates: every rank the same bits; frames within
        2e-6 of this process's single-device frames (also reported: equal
        to the two shares' films summed here); SPPM's counters equal to
        the single-device run's (but its self-hit counts, which the
        sharded passes do not keep), n and m equal, ld within 2e-6, tau
        within 1e-5 relative;
     b. the same on one NCCL rank: the film bit-equal to the one-rank
        scatter (render_share) and SPPM bit-equal to one device (where an
        iteration's pairs fit one pair chunk);
     c. two NCCL ranks on cuda:0 try one all_reduce: what the card does
        is recorded (expected: refused, a duplicate GPU), not gated.
 14. SPPM's fused blocks, SPPMIntegrator(fused_iterations=True): a block
     length's first block in a view eager, its second captured as a CUDA
     graph and replayed, each later one replayed (details in
     chiprun_out/slice14.json):
     a. mesh1m_sppm_1024_fused1, bench config 3's settings on the 1M mesh
        (1024^2, 262144 photons, depth 8, radius 0.075, seed 0),
        fused_block=1, four iterations (the first warm) through render,
        with the launch counts set to 0 before it: each block's state
        bit-equal to the stepwise state of the same iteration (run first,
        each iteration timed); each block's ms (CUDA events), the first
        the eager body, the second holding the capture (its host ms), the
        graph's replay alone, pair totals and pair chunks K, launches per
        replay (counted while the graph was captured), peak GiB; every
        32nd captured sweep launch and its prologue, and the last, held
        after the replays against sweep_plain and prologue_plain (the
        prologue bit for bit, the sweep's hits, ids and t bits); the
        host syncs of one more block, counted by torch's sync debug mode
        (one: the pair total's read); the device-busy share of a replay
        (torch.profiler; "not measured" if it sees no device time); a
        dead chunk's traversal captured as a graph of its own and timed
        (the static route launches the chunks the stepwise path skips);
     b. anim_relight_128_standin_fused2, bench config 5's settings on the
        stand-in (as 7c: 128^2, 2 iterations of 65536 photons a frame,
        depth 5, radius 0.055, moving lights and translation),
        fused_block=2: two frames stepwise and fused, each frame bit-equal
        and timed; a frame is a view of its own, run once, so its block
        runs eagerly and captures nothing (none may appear); the fused
        frame's launches, pair totals, K, peak GiB; the device-busy share
        of a fused frame.
 15. the walk kernel on bench config 3's 1M-ray calls (details in
     chiprun_out/slice15.json):
     a. mesh1m_sppm_1024_wbvh, config 3's settings (1024^2, 262144
        photons, depth 8, radius 0.075, seed 0) on the 1M mesh behind
        accelerator="wbvh": a warm iteration and two timed with their
        phases' ms and walk launches (counts set to 0 before each), peak
        GiB; then _fused1, blocks of one iteration (the first eager, the
        second captured, each later one replayed): each block's state
        bit-equal to the stepwise state of the same iteration, its ms, the
        replay alone, walk launches per replay, one host sync a block, the
        busy share of a replay, peak GiB;
     b. every walk call of one such iteration (camera closest and shadow
        at each depth, photons at each depth; 1,048,576 and 262,144 rays)
        and of 12a's Whitted frame: the kernel's device ms (10 launches
        replayed as one CUDA graph, so no host time between launches is
        counted), node visits, triangle tests, the longest walk, bound
        and share; on the fixed 65,536 rays in the middle of each SPPM
        call, the kernel against walk_plain (t bits, ids, per-ray counts,
        marks equal) and the whole call's run on the same rays;
     c. ptxas's registers, stack frame, spills and shared memory for
        each of the walk kernel's eight arms.
16. the last public signatures of the JAX package on the card (details
    in chiprun_out/slice16.json):
     a. bench config 4 with its own arguments (pixel_chunk=1 << 16,
        spp_per_dispatch=1) on the 1M mesh: the 256^2 1-spp frame and the
        512^2 4-spp frame (264,196 lanes in 5 chunks x 4 samples), each a
        warm frame (launches counted from 0) and two timed, peak GiB,
        useful_rays, queue_drops (0), workload Mrays/s; every 32nd sweep
        launch of the 512^2 frame's warm render, and the last, against
        sweep_plain and its prologue against prologue_plain, bit for bit;
        each frame's chunk splats through the gather kernel (the 256^2
        frame's two, the second with 1,028 valid lanes; the 512^2
        frame's 20), launches counted from 0 (one a chunk and sample,
        equal in a replay), each bit-equal to splat_plain and to the
        lane-order serial reference (the card's own footprint entries
        of the chunk's valid lanes through the CPU's deterministic
        scatter); the 256^2 frame's two graph-timed, with the plain
        twin's ms, the byte bound and the parent's scatter route on the
        same lanes;
        the 512^2 frame as one chunk (its ms and peak GiB) against the
        chunked one, MSE < 1e-8;
     b. Whitted sort_materials=True against False on 16a's 256^2 frame:
        bit-equal or MSE < 1e-8, queue_drops 0 for both (phases 5b and 5c
        render bench configs 1 and 2 with bench.py's pixel_chunk);
     c. fused SPPM blocks (fused_block=1, three iterations, 256^2, 65536
        photons, depth 5, radius 0.3) on 9c's 100 instanced stand-ins and
        on the 5k mesh behind clusters.attach (leaf 64, stage 16: several
        stages a call, and the stepwise calls must stop early in some of
        them while the fused ones run them all): each block's state
        bit-equal to the stepwise state of its iteration (the instance
        walk's first block takes its pair buffer at the walk's bound, the
        later ones at the size its counts give), the replay alone,
        launches per replay, one host sync a block, overflow reruns;
        after scene.bump_version() the view's second block captures
        anew;
     d. on row 6's call (66,688 camera rays x 5,000 triangles) the matmul
        route (accel/mxu.py::MXUAccelerator) against csrc/intersect.cu:
        hits and untied ids equal, t within 2e-6 relative, and each
        route's t within t's certified error bound (MT_ERR_EPS) of the
        f64 t; the gap's cause, each route's four dot products on every
        pair redone as a chain of FMAs and as the kernel's sum of rounded
        products, against each route's t bits; both graph-timed (the
        matmul route is intersect's library ms); the 5k golden 32^2
        through mxu.attach, MSE < 5e-4;
     e. SPPMIntegrator.fused_cost_analysis at 14a's settings: flops and
        bytes, and their shares of the FP32 and HBM peaks over 14a's
        replay ms (each <= 100%).
17. bench config 6, mesh16m_whitted_256, with its own arguments
    (bench.py:934-1033; details in chiprun_out/slice17.json):
     a. mesh_heavy at 15,995,168 triangles (use_bvh=False), its SAH
        clusters of 64 in supers of 32 on the host, the sweep's tables at
        group 64 packed and put on the card: bench.py's keys n_tris,
        gen_s, build_s, pack_s, table_mb;
     b. Whitted 256^2, 1 spp, depth 2, seed 0, pixel_chunk 1 << 16,
        each frame render(scene, geometry=, geometry_accel=) with the
        triangles on the card: (a) the sweep at group 64, blocks of 128,
        chunks of 8192 (the scene's anim_block_rays / anim_ray_chunk);
        (b) the clusters, supers of 32, stage 128, chunks of 16384; (c)
        the flat clusters (bench.py's positional ClusterAccel, super 1),
        chunks of 2048; (d) the port's default tiling (group 8, blocks of
        32, chunks of 65536) on the same clusters. Each a warm frame
        (launches counted from 0) and two timed with CUDA events (one for
        (b), whose frames take ~28 s, for the run's time): ms,
        sweep, tiled and prologue launches, the cluster stages, peak GiB,
        useful_rays, workload Mrays/s; (a)'s every sweep launch and its
        prologue recorded and replayed as CUDA graphs: the tiled kernel's
        and the prologue's ms a frame. Gates: every 32nd sweep launch of
        (d) and every 4th of (a), and the last, and its prologue equal to
        plain, bit for bit; the images within MSE 5e-4 of one another
        (the largest reported); queue_drops 0; the tables every call read
        kept their data pointer across the frames;
     c. the prologue kernel at 3,906 supers (group 64) and 31,250 (group
        8), blocks of 128 and 512 rays, on 8192 camera rays that reach
        the terrain, at its shared-memory key capacity and at 64 keys a
        row (most rows sorted in the global workspace): bit-equal to
        plain.
18. the Threefry kernel (csrc/threefry.cu; details in
    chiprun_out/slice18.json):
     a. at the cells' shapes, each bit-equal to the plain twin and one
        launch a call: fold_in of 65,536 and 1,048,576 lanes in the
        callers' three forms (one key and a lane's datum, lane keys and a
        scalar, lane keys and a lane's datum), uniform_lanes of [1M, 1],
        [1M, 2] and [1M, 5], uniform(key, (65536, 2)); kernel (each
        launch on its own copy of the inputs, 150 MB of them, so that
        they come from HBM; and on one copy, from L2) and twin
        graph-timed; the bound, the larger of bytes over 3.35 TB/s and
        integer instructions over 16.7e12/s (THREEFRY_OPS a hash); ptxas's
        registers and spills;
     b. the benchmark cells mesh1m_whitted_256 and mesh1m_sppm_1024_fused
        at seed 1234 through perfbench's drivers: the Threefry calls
        (fold_in and uniform_lanes) of the eager first step against the
        kernel's launches and the threefry_launches counter, the capture's
        launches a replay, and the counter over a replay; the eager
        step's calls replayed through the kernel and through the twin,
        graph-timed (the step's Threefry ms after and before);
     c. both cells' first three steps (eager, capture, replay) rendered by
        scripts/torch_threefry_images.py for this checkout and, with
        --parent, for that one: every output array's SHA-256 equal.
The last three lines are the kernels' JSON line (each kernel with its
launches on the main path, max abs error, ms, plain ms, bound ms and what
bounds it, and the library call's ms: for the prologue, the torch
route's; sweep and prologue also with their launches in one full-width
SPPM iteration, the prologue with the chunks skipped there, both with
their launches in the animated 1M frame and in each config-5 frame, and
in the env-lit 1M Whitted frame (8c) and one env SPPM iteration (8d),
and in the instanced stand-in frame (9c, with its agreement) and one of
its SPPM iterations (9d), and in the three-light textured 1M frames and
SPPM iteration (10b), and in phase 11's stratified frame, filter frames
and Scene queries, and a rank's in phase 13's sharded frames and SPPM
iterations (gloo rank 0 of 2, the NCCL rank), and per replay and in
the whole run of phase 14's fused 1024^2 block and config-5 frames;
intersect with the queries' brute-force oracle's;
bvh_walk with its launches in 12c's frame and one SPPM iteration of 12d,
timed on 12a's camera call, and with its launches in one stepwise 1024^2
iteration and per fused replay of phase 15, the iteration's walk ms and
the 1M camera call's ms and bound; sweep and prologue also with their
launches in 16a's two config-4 frames and in config 6's sweep legs (17b);
splat with its launches in 16a's 256^2 frame, timed on its full chunk
(65,536 lanes) against the scatter route, the tail chunk's row beside,
and its launches in the 512^2 frame;
threefry with its launches in 18b's Whitted frame and fused SPPM
iteration, timed on the [1M, 5] uniform, 18a's cases beside;
sweep_tiled, the tiled kernel at the JAX package's tilings: launches in
config 6's leg (a), ms, plain ms and bound on its 8192-ray launch shape
(phase 4's chunk's first 8192 rays that hit), with phase 4's tiling grid
and leg (a)'s kernel ms a frame),
the card's name and power limit, and
{"ok": true, "device": {...}}. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "goldens", "mesh_heavy5k_32.npy")
SHADOWS_GOLDEN = os.path.join(REPO, "tests", "goldens", "shadows16.npy")
CORNELL_GOLDEN = os.path.join(REPO, "tests", "goldens",
                              "cornell48_planar.npy")
SPPM_MESH_GOLDEN = os.path.join(REPO, "tests", "goldens",
                                "sppm_mesh5k_32.npy")
SPPM_SHADOWS_GOLDEN = os.path.join(REPO, "tests", "goldens",
                                   "sppm_shadows16.npy")
ENV_STUDIO_GOLDEN = os.path.join(REPO, "tests", "goldens",
                                 "env_studio32.npy")
MESH_ENV_GOLDEN = os.path.join(REPO, "tests", "goldens",
                               "mesh_heavy5k_env_32.npy")
MSE_GATE = 5e-4
# Phases 2-15 render each frame as one chunk of lanes: the route they
# timed and gated before the integrators took the JAX package's default
# pixel_chunk of 1 << 16 (phases 5b and 5c pass bench.py's own values,
# which also cover their frames; phase 16a runs bench config 4's).
ONE_CHUNK = 1 << 30
# Kernel vs plain: built with --fmad=false in the plain version's
# association order, so the two should agree bit for bit; the stated
# tolerance on t leaves room for nothing but a last-ulp difference.
T_RTOL = 1e-6
SWEEP_SRC = "trace_tpu_torch/csrc/sweep.cu"
JAX_SWEEP = "trace_tpu/ops/sweep_pallas.py"
# Bounds (H100 SXM): HBM, and FP32 instructions outside the tensor cores.
# Every kernel is built with --fmad=false (ops/nvcc.py) to match its plain
# version bit for bit, so each multiply and each add is an instruction of
# its own: the rate is 132 SMs x 128 FP32 lanes x 1.98 GHz = 33.5e12
# instructions/s, not the 67e12 "FLOP/s" that counts an FMA as two.
PEAK_F32 = 132 * 128 * 1.98e9
PEAK_HBM = 3.35e12
# FP32 operations per (ray, triangle) pair of the sweep (plain, certified;
# csrc/sweep.cu's note) and of the fused kernel, and per (live ray, box)
# pair of the prologue kernel (csrc/entry.cu's note).
SWEEP_OPS = {False: 40, True: 90}
# Phase 18's bound for the Threefry kernel (csrc/threefry.cu's note):
# integer instructions a hash (60 in the rounds, 18 in the key schedule
# and injections) and a uniform's 4 more, at 64 integer instructions a
# clock an SM (half the FP32 rate): 132 x 64 x 1.98 GHz = 16.7e12/s.
THREEFRY_OPS = 78
UNIFORM_OPS = 4
PEAK_INT32 = 132 * 64 * 1.98e9
INTERSECT_OPS = 40
ENTRY_OPS = 30


def log(phase, t0, msg):
    print(f"[{phase}] {time.perf_counter() - t0:8.2f} s  {msg}", flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps):
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps):
    """Device ms of one ``fn()``: ``reps`` calls captured as one CUDA
    graph, replayed once warm and once timed with CUDA events, so that no
    host time between the launches is counted (cuda_ms counts it where a
    launch is shorter than its Python call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def compare(kt, ki, pt, pi):
    """Mismatch counts between kernel and plain (best t, best slot)."""
    kf, pf = ki >= 0, pi >= 0
    both = kf & pf
    dt = (kt - pt).abs()
    bad_t = both & (dt > T_RTOL * pt.abs().clamp_min(1.0))
    tied = both & (kt == pt)
    return {
        "hit_mismatch": int((kf != pf).sum()),
        "t_beyond_tol": int(bad_t.sum()),
        "id_mismatch_untied_t": int((tied & (ki != pi)).sum()),
        "max_abs_err": float(dt[both].max()) if bool(both.any()) else 0.0,
        "n_found": int(kf.sum()),
    }


def bound(ops, nbytes, peak=PEAK_F32):
    """(bound ms, what bounds it): the larger of operations over ``peak``
    (FP32 instructions unless said) and bytes over the HBM rate."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sweep_bound(args, per_block, panel, block_rays, certified):
    """The sweep launch's bound from this run's data: the pairs its steps
    test, and the bytes of the rays, the order/suffix entries walked, each
    distinct super's panel once, and the outputs."""
    import torch

    rays, order, _ = args
    steps = per_block.long()
    walked = int(steps.sum())
    mask = torch.arange(order.shape[1], device=order.device)[None] \
        < steps[:, None]
    distinct = int(torch.unique(order[mask]).numel())
    panel_bytes = panel[0].numel() * panel.element_size()
    ops = walked * block_rays * panel.shape[2] * SWEEP_OPS[certified]
    nbytes = (rays.numel() * 4 + walked * 8 + distinct * panel_bytes
              + rays.shape[1] * 8)
    return bound(ops, nbytes)


# (group, block, cut) of phase 4's tiling grid on the 1M camera chunk
# (cut "": the whole chunk; "cN" its first N rays, "hN" its first N rays
# that hit the mesh): the port's default, blocks of 128 and 512 rays,
# bench config 6's sweep (group 64: GL 4096, staged in tiles), and config
# 6's own launch shape, chunks of 8192 rays (64 blocks of 128): the sorted
# chunk's first 8192, which enter no super (the launch's fixed cost), and
# its first 8192 that hit; ARM_TILINGS for every arm.
CONFIG6_CHUNK = 8192
TILINGS = ((8, 32, ""), (8, 128, ""), (8, 512, ""), (64, 128, ""),
           (64, 128, f"c{CONFIG6_CHUNK}"), (64, 128, f"h{CONFIG6_CHUNK}"))
ARM_TILINGS = ((8, 32), (8, 128), (8, 512), (64, 32), (64, 128), (64, 512))


def regroup_tables(tb, k):
    """SweepTables of the same clusters at k times ``tb``'s group (leaf 64
    x group 8: GL 512, no column padding): k consecutive supers side by
    side, the super count padded with empty supers (zero panel, slot -1,
    the last super's box). Equal to packing the clusters at the larger
    group (tests/test_torch_sweep_tilings.py)."""
    from trace_tpu_torch.ops.sweep import SweepTables

    panel, slot = np.asarray(tb.panel), np.asarray(tb.slot_to_tri)
    s, rows, gl = panel.shape
    assert gl == tb.group * tb.leaf_tris, "regroup needs unpadded columns"
    pad = (-s) % k
    panel = np.concatenate([panel, np.zeros((pad, rows, gl), panel.dtype)])
    slot = np.concatenate([slot, np.full(pad * gl, -1, slot.dtype)])
    lo = np.concatenate([tb.s_lo, np.repeat(tb.s_lo[-1:], pad, 0)])
    hi = np.concatenate([tb.s_hi, np.repeat(tb.s_hi[-1:], pad, 0)])
    n = (s + pad) // k
    out = SweepTables.from_arrays(
        panel.reshape(n, k, rows, gl).transpose(0, 2, 1, 3).reshape(
            n, rows, k * gl), slot, lo.reshape(n, k, 3).min(1),
        hi.reshape(n, k, 3).max(1))
    out.group, out.leaf_tris = tb.group * k, tb.leaf_tris
    return out


def tiling_tables(tb, dev):
    """{group: (SweepTables, {panel kind: device panel})} at groups 8 (tb)
    and 64."""
    from trace_tpu_torch.ops import sweep as TS

    out = {}
    for g, t in ((8, tb), (64, regroup_tables(tb, 8))):
        out[g] = (t, {k: TS.panel_tensor(TS.cast_panel(
            t.panel, k == "bf16", k == "hilo"), dev)
            for k in ("f32", "bf16", "hilo")})
    return out


def tiling_arms(phase, t0, tables, o, d, tm, stride=32):
    """Every arm of the sweep kernel (f32, bf16 and hi/lo panels, plain or
    certified, step counts, double-buffered) at each (group, block) of
    ARM_TILINGS, on every ``stride``-th ray of a sorted chunk, closest-hit
    and any-hit (t_max 2000: most lanes occluded), against sweep_plain:
    t, slot and steps bit for bit; the prologue kernel bit-equal on each
    tiling's chunk. Returns {"GxB": counts}; raises on a mismatch."""
    import torch
    from trace_tpu_torch.ops import sweep as TS

    o, d, tm = o[::stride], d[::stride], tm[::stride]
    rows = {}
    for g, b in ARM_TILINGS:
        tb, panels = tables[g]
        acc = TS.SweepAccelerator(tb, o.device, block_rays=b)
        row = dict(launches=0, mismatches=0, found=0, steps=0, tiled=0)
        pro = {}
        for anyh in (False, True):
            lim = torch.where(tm < 0, tm, 2000.0) if anyh else tm
            check_prologue(acc, o, d, lim, pro)
            args = acc.prologue(o, d, lim)
            for kind, p in panels.items():
                for cert in (False, True):
                    pt, pi, ps = TS.sweep_plain(*args, p, b, anyh,
                                                certified=cert,
                                                collect_stats=True)
                    for pipe in (False, True):
                        for stats in (False, True):
                            n0 = TS.sweep_kernel.tiled_launches
                            out = TS.sweep_kernel(*args, p, b, anyh,
                                                  certified=cert,
                                                  pipeline=pipe,
                                                  collect_stats=stats)
                            torch.cuda.synchronize()
                            row["tiled"] += TS.sweep_kernel.tiled_launches \
                                - n0
                            row["launches"] += 1
                            row["mismatches"] += int(not (
                                torch.equal(out[0], pt)
                                and torch.equal(out[1], pi)
                                and (not stats or torch.equal(out[2], ps))))
                    row["found"] += int((pi >= 0).sum())
                    row["steps"] += int(ps.sum())
        row.update(prologue=pro)
        rows[f"{g}x{b}"] = row
        log(phase, t0, f"every arm at group {g}, block {b} (GL "
            f"{tb.gl_pad}): {o.shape[0]} rays, {row}")
        if row["mismatches"] or prologue_disagrees(pro) or not row["found"] \
                or row["tiled"] != (0 if (g, b) == (8, 32)
                                    else row["launches"]):
            raise AssertionError(f"[{phase}] the kernel at group {g}, block "
                                 f"{b}: {row}")
    return rows


def tiling_name(g, b, cut="") -> str:
    """A tiling's key: "GxB" and its cut ("cN", "hN" or "")."""
    return f"{g}x{b}{cut}"


def cut_rays(cut, hit):
    """The rays of a tiling's cut of a chunk (an index): all (""), the
    first N ("cN"), or the first N of those that hit ("hN"; ``hit``: the
    chunk's hit mask, in its order)."""
    if not cut:
        return slice(None)
    n = int(cut[1:])
    return slice(0, n) if cut[0] == "c" else hit.nonzero()[:n, 0]


def tiled_shape_of(b, regs) -> dict:
    """The tiled kernel's launch shape at block ``b`` as the CUDA library
    computes it, held to ops.sweep's mirror (kernel_cluster), with ptxas's
    (registers, spill stores, spill loads) of its f32 and certified f32
    arms from ``regs`` (ptxas_summary)."""
    from trace_tpu_torch.ops import sweep as TS

    shape = TS.sweep_kernel.tiled_shape(b)
    if (shape["cluster"], shape["cta_rays"], shape["groups"]) \
            != TS.kernel_cluster(b):
        raise AssertionError(f"tiled kernel shape {shape} differs from "
                             f"kernel_cluster({b}) {TS.kernel_cluster(b)}")
    shape["ptxas"] = {n: (r, sp, lo) for n, r, sp, lo in regs
                      if n in ("tiled_f32", "tiled_certified_f32")}
    return shape


def tiling_grid(phase, t0, card, tables, o, d, tm, regs):
    """A sorted chunk through the kernel at each (group, block, cut) of
    TILINGS, f32 and certified: graph-timed ms (10 launches replayed), the
    plain version's ms (once), steps and the busiest block's, the bound
    (sweep_bound); t, slot and steps bit-equal to plain; the tiled
    kernel's cluster shape and registers (tiled_shape_of). Returns
    {"GxB<cut>_arm": row}."""
    import torch
    from trace_tpu_torch.ops import sweep as TS

    rows = {}
    hit = TS.SweepAccelerator(tables[8][0], o.device, sort_rays=False
                              ).intersect(o, d, tm, False)[0]
    for g, b, cut in TILINGS:
        tb, panels = tables[g]
        acc = TS.SweepAccelerator(tb, o.device, block_rays=b)
        sel = cut_rays(cut, hit)
        args = acc.prologue(o[sel], d[sel], tm[sel])
        p = panels["f32"]
        tiled = TS.kernel_tiled(b, tb.gl_pad)
        shape = tiled_shape_of(b, regs) if tiled else None
        key = tiling_name(g, b, cut)
        for cert in (False, True):
            # The plain version once, timed with CUDA events (phase 2's
            # checks have warmed it up).
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            pt, pi, ps = TS.sweep_plain(*args, p, b, False, certified=cert,
                                        collect_stats=True)
            ev[1].record()
            kt, ki, ks = TS.sweep_kernel(*args, p, b, False, certified=cert,
                                         collect_stats=True)
            torch.cuda.synchronize()
            row = dict(group=g, block_rays=b, gl=tb.gl_pad,
                       rays=int(args[0].shape[1]), blocks=int(ks.numel()),
                       certified=cert, steps=int(ks.sum()),
                       max_block_steps=int(ks.max()),
                       equal=bool(torch.equal(kt, pt) and torch.equal(ki, pi)
                                  and torch.equal(ks, ps)),
                       found=int((ki >= 0).sum()),
                       max_abs_err=compare(kt, ki, pt, pi)["max_abs_err"],
                       tiled=tiled, shape=shape)
            row["ms"] = graph_ms(lambda: TS.sweep_kernel(
                *args, p, b, False, certified=cert), 10)
            row["plain_ms"] = ev[0].elapsed_time(ev[1])
            row["bound_ms"], row["bound_by"] = sweep_bound(args, ks, p, b,
                                                           cert)
            name = f"{key}_{'certified' if cert else 'f32'}"
            rows[name] = row
            log(phase, t0, f"chunk of {row['rays']} rays at group {g}, block "
                f"{b}, {'certified' if cert else 'f32'}: kernel "
                f"{row['ms']:.4f} ms graph-timed, plain "
                f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}, {100 * row['bound_ms'] / row['ms']:.1f}"
                f"% of it), steps {row['steps']}, busiest block "
                f"{row['max_block_steps']}, bit-equal {row['equal']}; "
                + (f"tiled kernel: cluster of {shape['cluster']} CTAs x "
                   f"{shape['cta_rays']} rays x {shape['groups']} groups, "
                   f"{shape['smem_bytes']} B shared a CTA, ptxas "
                   f"(registers, spill stores, spill loads) "
                   f"{shape['ptxas']}; " if tiled else "sweep_kernel; ")
                + f"card {card}")
            # (The sorted chunk's first rays enter no super.)
            if not row["equal"] or (cut[:1] != "c" and not row["found"]):
                raise AssertionError(f"[{phase}] {name}: {row}")
        # The other arms' kernel ms at this tiling (tiling_arms holds
        # them to plain); bounds as the f32 and certified rows'.
        for arm, kind, opt in (("bf16", "bf16", {}), ("hilo", "hilo", {}),
                               ("f32_stats", "f32", dict(collect_stats=True)),
                               ("f32_pipelined", "f32",
                                dict(pipeline=True))):
            rows[f"{key}_{arm}"] = dict(
                group=g, block_rays=b, ms=graph_ms(
                    lambda: TS.sweep_kernel(*args, panels[kind], b, False,
                                            **opt), 10))
        log(phase, t0, f"{key}, other arms: "
            + ", ".join(f"{a} {rows[f'{key}_{a}']['ms']:.4f} ms"
                        for a in ("bf16", "hilo", "f32_stats",
                                  "f32_pipelined")) + f"; card {card}")
    return rows


def prologue_bound(t_p, suffix, block_rays):
    """The prologue kernel's bound: the live rays' box tests plus ~log2(k)^2
    compare-exchanges for each of a row's k finite entries (one operation
    each), or the bytes of the rays (o, d, t_lim), the boxes and the two
    [NB, S] outputs, whichever is larger."""
    import torch

    n, (nb, s) = t_p.numel(), suffix.shape
    k = torch.isfinite(suffix).sum(dim=1).double()
    sort = float((k * torch.log2(k.clamp_min(1.0)).ceil() ** 2).sum())
    ops = int((t_p >= 0).sum()) * s * ENTRY_OPS + sort
    return bound(ops, n * 28 + s * 24 + nb * s * 8)


def check_prologue(acc, o, d, tm, tot, timed=None, **kw):
    """The prologue kernel against its plain version on one chunk: order
    and suffix bit for bit, mismatches added to ``tot`` (``kw`` goes to the
    kernel: ``key_capacity``); with ``timed`` (a dict), also the kernel's
    ms, the torch route's (the entry table kernel, torch.argsort and a
    reverse cummin, the route the prologue kernel replaced), the plain
    version's and the bound.
    Returns the plain (order, suffix)."""
    import torch
    from trace_tpu_torch.ops.sweep import (block_entry_kernel,
                                           prologue_plain, prologue_torch)

    a = (acc.s_lo, acc.s_hi, *acc.pad_rays(o, d, tm), acc.block_rays)
    ko, ks = block_entry_kernel(*a, **kw)
    po, ps = prologue_plain(*a)
    torch.cuda.synchronize()
    tot["prologue_chunks"] = tot.get("prologue_chunks", 0) + 1
    tot["order_mismatch"] = tot.get("order_mismatch", 0) + int(
        (ko != po).sum())
    tot["suffix_bits_mismatch"] = tot.get("suffix_bits_mismatch", 0) + int(
        (ks.view(torch.int32) != ps.view(torch.int32)).sum())
    fin = torch.isfinite(ps)
    tot["max_abs_err"] = max(tot.get("max_abs_err", 0.0), float(
        (ks - ps)[fin].abs().max()) if bool(fin.any()) else 0.0)
    tot["max_finite_in_row"] = max(tot.get("max_finite_in_row", 0),
                                   int(fin.sum(dim=1).max()))
    if timed is not None:
        timed["prologue_ms"] = cuda_ms(lambda: block_entry_kernel(*a, **kw), 5)
        timed["prologue_torch_ms"] = cuda_ms(lambda: prologue_torch(*a), 5)
        timed["prologue_plain_ms"] = cuda_ms(lambda: prologue_plain(*a), 1)
        timed["prologue_bound_ms"], timed["prologue_bound_by"] = \
            prologue_bound(a[4], ps, acc.block_rays)
    return po, ps


def prologue_disagrees(tot) -> bool:
    return bool(tot["order_mismatch"] or tot["suffix_bits_mismatch"]
                or tot.get("skipped_live", 0))


def accumulate(tot, cmp):
    for k, v in cmp.items():
        tot[k] = max(tot.get(k, 0.0), v) if k == "max_abs_err" \
            else tot.get(k, 0) + v


def disagrees(tot) -> bool:
    return bool(tot.get("hit_mismatch") or tot.get("t_beyond_tol")
                or tot.get("id_mismatch_untied_t"))


def ptxas_summary(logtext: str) -> list:
    """(kernel, registers, spill stores, spill loads) per compiled entry."""
    from trace_tpu_torch.ops.sweep import arm_name

    out, name, spill = [], None, ("?", "?")
    for line in logtext.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            t = re.search(r"sweep_kernelILb(\d)ELi(\d)ELb(\d)ELb(\d)E", name)
            tl = re.search(r"sweep_tiled_kernelILb(\d)ELi(\d)EE", name)
            if tl:
                c, k = tl.groups()
                name = "tiled_" + arm_name(("f32", "bf16", "hilo")[int(k)],
                                           c == "1", False, False)
            elif t:
                c, k, s, p = t.groups()
                name = arm_name(("f32", "bf16", "hilo")[int(k)], c == "1",
                                p == "1", s == "1")
            elif "intersect_kernel" in name:
                name = "intersect"
            elif "bvh_walk_kernel" in name:
                w = re.search(r"bvh_walk_kernelILb(\d)ELb(\d)ELb(\d)E", name)
                arms = zip(("any_hit", "bvh", "stats"),
                           w.groups() if w else "000")
                name = "_".join(["bvh_walk"] + [k for k, b in arms
                                                if b == "1"])
            elif "prologue_kernel" in name:
                name = "prologue"
            elif "entry_kernel" in name:
                name = "block_entry_table"
            elif "splat_gather_kernel" in name:
                name = "splat"
            elif "threefry_fold_kernel" in name:
                name = "threefry_fold"
            elif "threefry_uniform_kernel" in name:
                name = "threefry_uniform"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append((name, int(m.group(1)), int(spill[0]), int(spill[1])))
    return out


def eager_whitted(*args, **kw):
    """A WhittedIntegrator on the eager route (``frame_graph=False``), for
    the phases that count, record or time launches render by render
    through the host's wrappers (3, 7-13, 15, 17's legs): a graph replay
    issues none of them from the host. Phases 2-4 and 16 drive the
    default route, the frame graph's."""
    from trace_tpu_torch.integrators.whitted import WhittedIntegrator

    return WhittedIntegrator(*args, frame_graph=False, **kw)


def record_calls(integ, scene):
    """Render one frame and return the rays of every accelerator call:
    [(o, d, t_max, any_hit)] (camera, shadow and specular rays). The frame
    is issued eagerly (a graph replay calls no accelerator)."""
    calls = []
    acc = scene.accel
    traced = acc.intersect

    def record(o, d, t_max, any_hit):
        calls.append((o.clone(), d.clone(), t_max.clone(), any_hit))
        return traced(o, d, t_max, any_hit)

    acc.intersect = record
    graph = integ.frame_graph
    integ.frame_graph = False
    try:
        integ.render(scene)
    finally:
        del acc.intersect
        integ.frame_graph = graph
    return calls


def sweep_chunks(acc, calls, pro_tot):
    """[(case name, any_hit, [(chunk start, kernel args) of each chunk the
    accelerator launches])] for the recorded calls, plus the camera rays as
    any-hit. The prologue kernel is held against its plain version on every
    launched chunk, and every chunk the accelerator skips must hold no lane
    the kernels treat as live (mismatches and skips added to ``pro_tot``)."""
    import torch

    cases = [(f"call{i}_{'any_hit' if a else 'closest'}", o, d, tm, a)
             for i, (o, d, tm, a) in enumerate(calls)]
    # The camera rays once more as any-hit: nearly every lane is occluded,
    # so the any-hit early exit runs at full scale.
    o, d, tm, _ = calls[0]
    cases.append(("camera_any_hit", o, d, tm, True))
    out = []
    for name, o, d, tm, anyh in cases:
        perm = acc.coherence_order(o, d, tm)
        o, d, tm = o[perm], d[perm], tm[perm]
        n, c = o.shape[0], acc.ray_chunk
        live = acc.live_chunks(tm)
        chunks = []
        for s in range(0, n, c):
            if s not in live:
                pro_tot["skipped"] = pro_tot.get("skipped", 0) + 1
                pro_tot["skipped_live"] = pro_tot.get("skipped_live", 0) + \
                    int((acc.pad_rays(o[s:s + c], d[s:s + c],
                                      tm[s:s + c])[2] >= 0).sum())
                continue
            check_prologue(acc, o[s:s + c], d[s:s + c], tm[s:s + c],
                           pro_tot)
            chunks.append((s, acc.prologue(o[s:s + c], d[s:s + c],
                                           tm[s:s + c])))
        torch.cuda.synchronize()
        out.append((name, anyh, chunks))
    return out


def time_launches(phase, t0, acc, calls, chunks, panel, certified, card,
                  labels):
    """Every sweep launch of one frame (the recorded calls' launched
    chunks): kernel ms, plain ms, bound, steps, the busiest block's steps
    and the us per busiest-block step, and the prologue kernel's ms
    against the torch route's and the plain version's, and its bound.
    ``labels`` names each call's launches. Returns the rows."""
    from trace_tpu_torch.ops.sweep import sweep_kernel, sweep_plain

    rows = []
    b = acc.block_rays
    for i, ((_, anyh, ch), name) in enumerate(zip(chunks[:len(calls)],
                                                  labels)):
        o, d, tm, _ = calls[i]
        perm = acc.coherence_order(o, d, tm)
        o, d, tm = o[perm], d[perm], tm[perm]
        for c, (start, args) in enumerate(ch):
            sl = slice(start, start + acc.ray_chunk)
            opt = dict(certified=certified)
            per_block = sweep_kernel(*args, panel, b, anyh, collect_stats=True,
                                     **opt)[2]
            k_ms = cuda_ms(lambda: sweep_kernel(*args, panel, b, anyh, **opt),
                           5)
            p_ms = cuda_ms(lambda: sweep_plain(*args, panel, b, anyh, **opt),
                           1)
            b_ms, b_by = sweep_bound(args, per_block, panel, b, certified)
            row = dict(launch=name, chunk=c, lanes=args[0].shape[1],
                       live=int((args[0][9] >= 0).sum()), ms=k_ms,
                       plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                       steps=int(per_block.sum()),
                       max_block_steps=int(per_block.max()))
            row["us_per_busiest_step"] = 1e3 * k_ms / max(
                row["max_block_steps"], 1)
            check_prologue(acc, o[sl], d[sl], tm[sl], {}, row)
            rows.append(row)
            log(phase, t0, f"{name} chunk {c}: {row['lanes']} lanes "
                f"({row['live']} live), kernel {k_ms:.3f} ms, plain "
                f"{p_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}, "
                f"{100 * b_ms / k_ms:.2f}% of it), steps {row['steps']}, "
                f"busiest block {row['max_block_steps']} steps, "
                f"{row['us_per_busiest_step']:.2f} us a busiest-block step; "
                f"prologue kernel {row['prologue_ms']:.3f} ms vs torch route "
                f"{row['prologue_torch_ms']:.3f} ms, plain "
                f"{row['prologue_plain_ms']:.3f} ms, bound "
                f"{row['prologue_bound_ms']:.4f} ms "
                f"({row['prologue_bound_by']}); card {card}")
    return rows


def timed_frames(integ, scene, n=3, **render_kw):
    """One warm frame (two on the frame graph's route: the view's eager
    first frame and its capture), then ``n`` frames timed with CUDA events
    (ms); ``render_kw`` goes to each render (animated geometry)."""
    import torch

    replays = getattr(integ, "replays", None)   # Sampler integrators
    for _ in range(2 if replays and replays(scene, **render_kw) else 1):
        integ.render(scene, **render_kw)
    torch.cuda.synchronize()
    times, state = [], None
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state = integ.render(scene, **render_kw)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return times, state


def image(integ, state) -> np.ndarray:
    return integ.camera.film.to_image(state).cpu().numpy()


def slice3(dev, card, scene, t_all):
    """Phase 5: the shadows and Cornell scenes, and the path tracer through
    the sweep on the 1M-triangle scene (module docstring)."""
    import torch
    from trace_tpu_torch.integrators.path import PathIntegrator
    WhittedIntegrator = eager_whitted
    from trace_tpu_torch.models import cornell, mesh_heavy, spheres
    from trace_tpu_torch.ops.sweep import (block_entry_kernel, sweep_kernel,
                                           sweep_plain)
    from trace_tpu_torch.sampler import uniform as U

    tmp = tempfile.gettempdir()
    # -- 5a: goldens --------------------------------------------------------
    t0 = time.perf_counter()
    shadows = spheres.build_scene(device=dev)
    box = cornell.build_scene(device=dev)
    assert shadows.accel is None and box.accel is None
    for label, sc, mod, integ_cls, res, spp, seed, depth, path in (
            ("shadows", shadows, spheres, WhittedIntegrator, 16, 1, 11, 3,
             SHADOWS_GOLDEN),
            ("cornell", box, cornell, PathIntegrator, 48, 8, 3, 4,
             CORNELL_GOLDEN)):
        cam = mod.build_camera(res, os.path.join(tmp, f"chip_smoke_{label}"
                                                 f"{res}.png"))
        it = integ_cls(cam, U.UniformSampler(spp, seed=seed), max_depth=depth)
        img = image(it, it.render(sc))
        golden = np.load(path)
        mse = float(np.mean((img - golden) ** 2))
        log("5a", t0, f"golden {label} {res}^2 {spp} spp depth {depth}: MSE "
            f"{mse:.3e} (gate {MSE_GATE}), max abs "
            f"{float(np.abs(img - golden).max()):.4f}")
        if not (img.shape == golden.shape and np.isfinite(img).all()
                and mse < MSE_GATE):
            raise AssertionError(f"golden mismatch ({label}): MSE {mse}")
    out = {}

    def bench(label, sc, integ, rays):
        torch.cuda.reset_peak_memory_stats()
        sweep_kernel.reset_counts()
        block_entry_kernel.reset_counts()
        if sc.accel is not None:
            sc.accel.skipped_chunks = 0
        times, state = timed_frames(integ, sc)
        ms = float(np.mean(times))
        img = image(integ, state)
        row = dict(ms=ms, times=times, mrays=rays / ms / 1e3,
                   useful=integ.last_useful_rays,
                   useful_mrays=integ.last_useful_rays / ms / 1e3,
                   drops=integ.last_queue_drops,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   launches=sweep_kernel.launches,
                   entry_launches=block_entry_kernel.launches,
                   skipped_chunks=getattr(sc.accel, "skipped_chunks", 0),
                   nonzero=float((img > 0).any(-1).mean()))
        log(label, t0, f"frames {[round(x, 3) for x in times]} ms, mean "
            f"{ms:.2f} ms, workload {row['mrays']:.3f} Mrays/s, useful "
            f"{row['useful_mrays']:.3f} Mrays/s ({row['useful']} rays), "
            f"queue_drops {row['drops']}, sweep launches {row['launches']}, "
            f"prologue launches {row['entry_launches']}, chunks skipped "
            f"{row['skipped_chunks']}, "
            f"non-zero pixels {row['nonzero']:.3f}, peak mem "
            f"{row['peak_gib']:.2f} GiB; card {card}")
        if not np.isfinite(img).all() or row["nonzero"] < 0.05:
            raise AssertionError(f"bad frame in {label}")
        return row, img, state

    # -- 5b: bench config 1 ---------------------------------------------------
    t0 = time.perf_counter()
    cam = spheres.build_camera(256, os.path.join(tmp, "chip_smoke_shadows"
                                                 "256.png"))
    (x0, y0), (x1, y1) = cam.film.sample_bounds()
    n_pix = (x1 - x0 + 1) * (y1 - y0 + 1)
    n_lights = int(shadows.lights.kind.shape[0])
    capped = WhittedIntegrator(cam, U.UniformSampler(4, seed=0), max_depth=5,
                               pixel_chunk=1 << 17,
                               level_caps=spheres.LEVEL_CAPS)
    row, img, state = bench("5b", shadows, capped,
                            n_pix * 4 * (1 + n_lights) * 5)
    cam.film.save_png(state)
    full = WhittedIntegrator(cam, U.UniformSampler(4, seed=0), max_depth=5,
                             pixel_chunk=1 << 17)
    img_full = image(full, full.render(shadows))
    mse = float(np.mean((img - img_full) ** 2))
    log("5b", t0, f"shadows 256^2 4 spp depth 5, level_caps "
        f"{spheres.LEVEL_CAPS} -> {capped._resolve_caps(n_pix)}: "
        f"queue_drops {row['drops']}, capped "
        f"vs uncapped MSE {mse:.3e}, max abs "
        f"{float(np.abs(img - img_full).max()):.3e}; uncapped useful_rays "
        f"{full.last_useful_rays}")
    if row["drops"] != 0 or mse >= 1e-8 or row["launches"]:
        raise AssertionError(f"config 1: drops {row['drops']}, MSE {mse}")
    out["config1"] = row

    # -- 5c: bench config 2 ---------------------------------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    cam = cornell.build_camera(512, os.path.join(tmp, "chip_smoke_cornell"
                                                 "512.png"))
    (x0, y0), (x1, y1) = cam.film.sample_bounds()
    n_pix = (x1 - x0 + 1) * (y1 - y0 + 1)
    path = PathIntegrator(cam, U.UniformSampler(4, seed=0), max_depth=5,
                          pixel_chunk=1 << 19)
    row, img, state = bench("5c", box, path, n_pix * 4 * 5 * 3)
    cam.film.save_png(state)
    if row["launches"]:
        raise AssertionError("config 2 launched the sweep")
    out["config2"] = row

    # -- 5d: the path tracer through the sweep on the 1M-triangle scene -----
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    acc = scene.accel
    cam = mesh_heavy.build_camera(256, os.path.join(tmp, "chip_smoke_path_"
                                                    "1m.png"))
    depth = 3
    path = PathIntegrator(cam, U.UniformSampler(1, seed=0), max_depth=depth,
                          pixel_chunk=ONE_CHUNK)
    calls = record_calls(path, scene)
    if len(calls) != 2 * depth:
        raise AssertionError(f"unexpected intersect calls: {len(calls)}")
    tot_all, pro_tot = {}, {}
    chunks_1m = sweep_chunks(acc, calls, pro_tot)
    labels = []
    for i, (name, anyh, chunks) in enumerate(chunks_1m):
        bounce = i // 2
        kind = ("camera_any_hit" if name == "camera_any_hit"
                else f"shadow {bounce}" if anyh
                else "camera" if i == 0 else f"bounce {bounce}")
        labels.append(kind)
        for c, (_, args) in enumerate(chunks):
            kt, ki = sweep_kernel(*args, acc.panel, acc.block_rays, anyh)
            pt, pi = sweep_plain(*args, acc.panel, acc.block_rays, anyh)
            torch.cuda.synchronize()
            cmp = compare(kt, ki, pt, pi)
            accumulate(tot_all, cmp)
            log("5d", t0, f"{kind} chunk {c}: {args[0].shape[1]} lanes, "
                f"{cmp}")
            if disagrees(cmp):
                raise AssertionError(f"kernel disagrees with plain: {kind} "
                                     f"chunk {c}: {cmp}")
    log("5d", t0, f"prologue kernel vs plain: {pro_tot}")
    if prologue_disagrees(pro_tot):
        raise AssertionError(f"prologue kernel disagrees: {pro_tot}")
    # A block's steps run one after another: the block with the most steps
    # bounds the launch.
    launches = time_launches("5d", t0, acc, calls, chunks_1m, acc.panel,
                             False, card, labels)
    del chunks_1m
    row, img, state = bench("5d", scene, path,
                            n_pix_of(cam) * 1 * depth * 3)
    cam.film.save_png(state)
    if row["launches"] <= 0 or sweep_kernel.arm_launches["f32"] \
            != row["launches"] or row["entry_launches"] != row["launches"]:
        raise AssertionError("the path frame did not run through the sweep "
                             "and the prologue kernel")
    out["path_1m"] = dict(row, per_launch=launches, agreement=tot_all,
                          prologue_agreement=pro_tot)
    log(5, t0, f"whole run so far {time.perf_counter() - t_all:.1f} s")
    return out


def workspace_case(dev, card, scene, acc, call):
    """The prologue kernel's global-workspace sort on the 1M mesh packed at
    group 1 (one cluster a super), on the first chunk of the photon depth-1
    call: at the default key capacity and at half the median row's finite
    entries, where most rows sort in the workspace; each bit-equal to the
    plain version (computed 256 blocks at a time: the [N, S] table of a
    whole chunk would not fit)."""
    import torch
    from trace_tpu_torch import scene as SC
    from trace_tpu_torch.accel import clusters as TC
    from trace_tpu_torch.ops import sweep as TS

    t0 = time.perf_counter()
    g1 = TS.SweepAccelerator(TS.SweepTables(TC.build_clusters(
        scene.triangles, SC.LEAF_TRIS, SC.MAX_PRIMS_PER_LEAF), 1), dev)
    build_s = time.perf_counter() - t0
    o, d, tm, _ = call
    perm = g1.coherence_order(o, d, tm)
    o, d, tm = (x[perm][:g1.ray_chunk] for x in (o, d, tm))
    a = (g1.s_lo, g1.s_hi, *g1.pad_rays(o, d, tm), g1.block_rays)
    step = 256 * g1.block_rays
    parts = [TS.prologue_plain(g1.s_lo, g1.s_hi, a[2][i:i + step],
                               a[3][i:i + step], a[4][i:i + step],
                               g1.block_rays)
             for i in range(0, a[2].shape[0], step)]
    po, ps = (torch.cat(x) for x in zip(*parts))
    del parts
    k = torch.isfinite(ps).sum(dim=1)
    s_count = g1.tables.n_supers
    out = dict(n_supers=s_count, lanes=int(a[4].numel()),
               live=int((a[4] >= 0).sum()), max_finite_in_row=int(k.max()),
               mean_finite_in_row=float(k.double().mean()),
               torch_route_ms=cuda_ms(lambda: TS.prologue_torch(*a), 3),
               bound=prologue_bound(a[4], ps, g1.block_rays))
    small = max(1, int(k.median()) // 2)
    out["small_capacity"] = small
    for cap in (TS.PROLOGUE_KEYS, small):
        ko, ks = TS.block_entry_kernel(*a, key_capacity=cap)
        torch.cuda.synchronize()
        row = dict(rows_in_workspace=int((k > min(cap, s_count)).sum()),
                   order_mismatch=int((ko != po).sum()),
                   suffix_bits_mismatch=int(
                       (ks.view(torch.int32) != ps.view(torch.int32)).sum()),
                   ms=cuda_ms(lambda: TS.block_entry_kernel(
                       *a, key_capacity=cap), 3))
        out[f"capacity_{cap}"] = row
        if row["order_mismatch"] or row["suffix_bits_mismatch"]:
            raise AssertionError(f"prologue kernel disagrees at group 1, "
                                 f"{cap} keys: {row}")
    log("6b", t0, f"group-1 tables ({s_count} supers, built in "
        f"{build_s:.2f} s), photon depth-1 chunk ({out['live']} live of "
        f"{out['lanes']} lanes; finite entries a row: max "
        f"{out['max_finite_in_row']}, mean {out['mean_finite_in_row']:.1f}): "
        f"prologue kernel bit-equal to plain at {TS.PROLOGUE_KEYS} keys "
        f"({out[f'capacity_{TS.PROLOGUE_KEYS}']}) and at {small} keys "
        f"({out[f'capacity_{small}']}); torch route "
        f"{out['torch_route_ms']:.3f} ms, bound {out['bound'][0]:.4f} ms "
        f"({out['bound'][1]}); card {card}")
    if out[f"capacity_{small}"]["rows_in_workspace"] == 0:
        raise AssertionError("no row sorted in the workspace")
    return out


SPPM_PHASES = ("_camera_pass_all", "_build_grid", "_photon_walk_all",
               "_pair_loop", "_update_pixels")


def time_phases(integ, marks):
    """Wrap the integrator's phase methods so each records a CUDA event in
    ``marks`` when its work is issued; nothing else changes."""
    import torch

    for name in SPPM_PHASES:
        fn = getattr(integ, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            out = _fn(*a, **k)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((_name.strip("_"), ev))
            return out

        setattr(integ, name, wrapped)


# Phases 6c, 7c, 8b, 8d, 9b, 10b, 11a and 16c and 15a's stepwise
# iteration no longer profile their cells (a profile took 10-30 s each,
# taken back for phase 17); their busy shares from earlier runs stand in
# PERF.md §5.
NOT_PROFILED = "not measured in this run"


def device_busy(phase, t0, card, what, run, unprofiled_ms, require=True):
    """Profile one ``run()`` (torch.profiler, the card's activity): its
    wall ms (CUDA events), the device's busy ms and share, the kernels
    launched,
    the top kernels by device time, and the prologue's and the sweep's
    device ms and launches. Raises if the profiler saw no device time,
    unless ``require`` is false (a CUDA graph's replay: the share is then
    reported as not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # The card's activity alone (CUPTI): the host's every tensor op would
    # add hundreds of thousands of events to a frame's trace, and their
    # processing took most of a phase's time.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        a = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        z = torch.cuda.Event(enable_timing=True)
        z.record()
        torch.cuda.synchronize()
    wall = a.elapsed_time(z)
    on_dev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in on_dev) / 1e3
    top = sorted(on_dev, key=lambda e: -e.self_device_time_total)[:8]
    busy = dict(profiled_ms=wall, device_ms=dev_ms, share=dev_ms / wall,
                share_of_unprofiled=dev_ms / unprofiled_ms,
                kernels=int(sum(e.count for e in on_dev)),
                top=[(e.key[:60], e.self_device_time_total / 1e3, e.count)
                     for e in top])
    for name in ("prologue_kernel", "sweep_kernel", "bvh_walk_kernel"):
        mine = [e for e in on_dev if name in e.key]
        busy[name] = (sum(e.self_device_time_total for e in mine) / 1e3,
                      int(sum(e.count for e in mine)))
    log(phase, t0, f"profiled {what} {wall:.2f} ms, device busy "
        f"{dev_ms:.2f} ms ({100 * busy['share']:.1f}%, "
        f"{100 * busy['share_of_unprofiled']:.1f}% of the unprofiled mean) "
        f"in {busy['kernels']} kernels; prologue kernel "
        f"{busy['prologue_kernel'][0]:.2f} ms in "
        f"{busy['prologue_kernel'][1]} launches, sweep "
        f"{busy['sweep_kernel'][0]:.2f} ms in {busy['sweep_kernel'][1]}, "
        f"walk {busy['bvh_walk_kernel'][0]:.2f} ms in "
        f"{busy['bvh_walk_kernel'][1]}; "
        f"top {busy['top']}; card {card}")
    if dev_ms <= 0:
        if require:
            raise AssertionError("the profiler saw no device time")
        busy["share"] = "not measured (the profiler saw no device time)"
    return busy


def states_equal(a, b) -> bool:
    import torch

    return all(torch.equal(getattr(a, k), getattr(b, k))
               for k in ("ld", "tau", "radius", "n", "phi", "m"))


def slice5(dev, card, scene, t_all):
    """Phase 6: SPPM (module docstring)."""
    import torch
    from trace_tpu_torch.integrators import sppm as SP
    from trace_tpu_torch.integrators.sppm import SPPMIntegrator
    from trace_tpu_torch.models import mesh_heavy, spheres
    from trace_tpu_torch.ops.sweep import block_entry_kernel, sweep_kernel
    from trace_tpu_torch.sampler import uniform as U
    from trace_tpu_torch.utils.checkpoint import load_pytree
    from trace_tpu_torch.utils.stats import RenderStats

    tmp = tempfile.gettempdir()
    out = {}
    # -- 6a: goldens on the card --------------------------------------------
    t0 = time.perf_counter()
    for label, mod, res, path, kw in (
            ("mesh5k", mesh_heavy, 32, SPPM_MESH_GOLDEN,
             dict(initial_search_radius=1.0, max_depth=8, n_iterations=2,
                  photons_per_iteration=16384, seed=0)),
            ("shadows", spheres, 16, SPPM_SHADOWS_GOLDEN,
             dict(initial_search_radius=0.25, max_depth=4, n_iterations=2,
                  photons_per_iteration=1024, seed=1))):
        sc = (mod.build_scene(5000, device=dev) if label == "mesh5k"
              else mod.build_scene(device=dev))
        integ = SPPMIntegrator(mod.build_camera(res, os.path.join(
            tmp, f"chip_smoke_sppm_{label}.png")), device=dev, **kw)
        sweep_kernel.reset_counts()
        st = integ.render(sc)
        img = integ.to_image(st, 2).cpu().numpy()
        golden = np.load(path)
        mse = float(np.mean((img - golden) ** 2))
        log("6a", t0, f"golden sppm {label} {res}^2: MSE {mse:.3e} (gate "
            f"{MSE_GATE}), max abs {float(np.abs(img - golden).max()):.4f}, "
            f"pixels with tau > 0: {int((st.tau.sum(-1) > 0).sum())}, "
            f"sweep launches {sweep_kernel.launches}")
        if not (img.shape == golden.shape and np.isfinite(img).all()
                and mse < MSE_GATE):
            raise AssertionError(f"SPPM golden mismatch ({label}): MSE {mse}")
        if (sweep_kernel.launches > 0) != (label == "mesh5k"):
            raise AssertionError(f"{label}: sweep launches "
                                 f"{sweep_kernel.launches}")
        out[f"golden_{label}_mse"] = mse

    # -- 6b: every sweep launch of one 256^2 iteration on the 1M mesh -------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    acc = scene.accel
    kw256 = dict(initial_search_radius=0.3, max_depth=8,
                 photons_per_iteration=65536, seed=0)
    cam256 = mesh_heavy.build_camera(256, os.path.join(tmp, "chip_smoke_"
                                                       "sppm_256.png"))
    integ = SPPMIntegrator(cam256, n_iterations=1, device=dev, **kw256)
    phase = ["camera"]
    for name, label in (("_camera_pass_all", "camera"),
                        ("_photon_walk_all", "photon")):
        def tagged(*a, _fn=getattr(integ, name), _label=label, **k):
            phase[0] = _label
            return _fn(*a, **k)
        setattr(integ, name, tagged)
    calls, tags = [], []
    traced = acc.intersect

    def record(o, d, t_max, any_hit):
        calls.append((o.clone(), d.clone(), t_max.clone(), any_hit))
        tags.append(phase[0])
        return traced(o, d, t_max, any_hit)

    acc.intersect = record
    try:
        integ.render(scene)
    finally:
        del acc.intersect
    labels, depth = [], {"camera": 0, "photon": 0}
    for (*_, anyh), ph in zip(calls, tags):
        if not anyh:
            depth[ph] += 1
        labels.append(f"{ph} {'shadow' if anyh else 'depth'} {depth[ph]}")
    by_call, pro_tot, chunks = check_launches("6b", acc, calls)
    agree = dict(zip(labels + ["camera_any_hit"], by_call.values()))
    log("6b", t0, f"{len(calls)} sweep calls of one 256^2 SPPM iteration "
        f"({', '.join(labels)}): every launch bit-equal to sweep_plain with "
        f"the same steps; prologue kernel vs plain: {pro_tot}")
    if not any(t == "photon" for t in tags) or not any(
            a for *_, a in calls):
        raise AssertionError("the iteration did not trace photons and "
                             "shadow rays through the sweep")
    launches = time_launches("6b", t0, acc, calls, chunks, acc.panel, False,
                             card, labels)
    del chunks
    out["launches_256"] = launches
    out["agreement_256"] = agree
    out["prologue_agreement_256"] = pro_tot
    out["workspace"] = workspace_case(dev, card, scene, acc, calls[
        labels.index("photon depth 1")])
    del calls

    # -- 6c: the full-width run ----------------------------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    png = os.path.join(tmp, "chip_smoke_sppm_1024.png")
    cam = mesh_heavy.build_camera(1024, png)
    n_timed = 3
    integ = SPPMIntegrator(cam, initial_search_radius=0.075, max_depth=8,
                           n_iterations=1 + n_timed,
                           photons_per_iteration=262144, seed=0, device=dev)
    integ.check_scene(scene)
    marks = []
    time_phases(integ, marks)
    captured = []
    scatter = SP._scatter_add

    def capture(dst, idx, val):
        if not captured and dst.dtype == torch.float32:
            captured.append((dst.clone(), idx.clone(), val.clone()))
        return scatter(dst, idx, val)

    SP._scatter_add = capture
    pixels = integ._pixel_grid(dev)
    key = U.key(integ.seed, dev)
    cdf, pmf = integ.light_distribution(scene)
    state = SP.initial_state(integ.n_pixels, integ.initial_search_radius,
                             dev)
    iters = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        for it in range(1, 2 + n_timed):
            integ.stats = RenderStats()
            marks.clear()
            sweep_kernel.reset_counts()
            block_entry_kernel.reset_counts()
            scene.accel.skipped_chunks = 0
            a = torch.cuda.Event(enable_timing=True)
            a.record()
            state = integ.step(scene, state, it, pixels, key, cdf, pmf)
            z = torch.cuda.Event(enable_timing=True)
            z.record()
            torch.cuda.synchronize()
            row = dict(iteration=it, ms=a.elapsed_time(z),
                       sweep_launches=sweep_kernel.launches,
                       entry_launches=block_entry_kernel.launches,
                       skipped_chunks=scene.accel.skipped_chunks,
                       **integ.stats.as_dict())
            prev = a
            for name, ev in marks:
                row[f"{name}_ms"] = prev.elapsed_time(ev)
                prev = ev
            iters.append(row)
            if it == 1:
                state1 = SP.SPPMState(*[x.clone() for x in (
                    state.ld, state.tau, state.radius, state.n, state.phi,
                    state.m)])
            log("6c", t0, f"iteration {it}{' (warm)' if it == 1 else ''}: "
                f"{row['ms']:.2f} ms; " + ", ".join(
                    f"{n.strip('_')} {row[n.strip('_') + '_ms']:.2f}"
                    for n in SPPM_PHASES) + f" ms; visible points "
                f"{row['visible_points']}, occupied cells "
                f"{row['grid_cells_occupied']}, pairs "
                f"{row['photon_vp_pairs']}, splat records with candidates "
                f"{row['splat_records']}, sweep launches "
                f"{row['sweep_launches']}, prologue "
                f"{row['entry_launches']}, chunks skipped "
                f"{row['skipped_chunks']}; card {card}")
            if row["sweep_launches"] <= 0 or row["entry_launches"] \
                    != row["sweep_launches"] \
                    or sweep_kernel.arm_launches["f32"] \
                    != row["sweep_launches"]:
                raise AssertionError("the SPPM iteration did not run through "
                                     "the sweep and the prologue kernel")
    finally:
        SP._scatter_add = scatter
    peak = torch.cuda.max_memory_allocated() / 2**30
    timed = iters[1:]
    img = integ.to_image(state, 1 + n_timed)
    gathered = int((state.tau.sum(-1) > 0).sum())
    finite = bool(torch.isfinite(img).all())
    integ.save(state, 1 + n_timed)
    log("6c", t0, f"1024^2, 262144 photons, depth 8, r0 0.075: timed "
        f"iterations {[round(r['ms'], 2) for r in timed]} ms, mean "
        f"{np.mean([r['ms'] for r in timed]):.2f} ms; peak memory "
        f"{peak:.2f} GiB; pixels with tau > 0: {gathered}; finite {finite}; "
        f"PNG {png}; card {card}")
    if not finite or gathered <= 0:
        raise AssertionError(f"bad SPPM image: finite {finite}, pixels with "
                             f"tau > 0 {gathered}")

    # The pair reduction alone: one pair chunk's scatter-add, the
    # deterministic one against index_add_ (atomics).
    dst, idx, val = captured[0]
    red = dict(pairs=int(idx.shape[0]),
               ms=cuda_ms(lambda: scatter(dst.clone(), idx, val), 5),
               index_add_ms=cuda_ms(
                   lambda: dst.clone().index_add_(0, idx, val), 5),
               clone_ms=cuda_ms(lambda: dst.clone(), 5))
    log("6c", t0, f"pair reduction, {red['pairs']} pairs into "
        f"{dst.shape[0]} pixels: deterministic scatter {red['ms']:.3f} ms, "
        f"index_add_ {red['index_add_ms']:.3f} ms (each with a "
        f"{red['clone_ms']:.3f} ms copy)")
    del captured, dst, idx, val

    for name in SPPM_PHASES:
        delattr(integ, name)
    integ.stats = None
    busy = NOT_PROFILED

    # -- 6d: determinism and resume ------------------------------------------
    t0 = time.perf_counter()
    again = integ.step(scene, SP.initial_state(integ.n_pixels, 0.075, dev),
                       1, pixels, key, cdf, pmf)
    same = states_equal(again, state1)
    del again, state1, state
    torch.cuda.empty_cache()
    integ2 = SPPMIntegrator(cam256, n_iterations=2, device=dev, **kw256)
    full = integ2.render(scene)
    ckpt = os.path.join(tmp, "chip_smoke_sppm_state.npz")
    st1 = integ2.render(scene, n_iterations=1, checkpoint_path=ckpt)
    resumed = integ2.render(scene, state=load_pytree(ckpt, st1),
                            start_iteration=2)
    resume_ok = states_equal(full, resumed)
    log("6d", t0, f"1024^2 iteration 1 twice: same bits {same}; 256^2 two "
        f"iterations straight vs 1 + checkpoint + 1 resumed: same bits "
        f"{resume_ok} (pairs in iteration 2 > 0: "
        f"{bool((full.tau.sum(-1) > 0).any())})")
    if not (same and resume_ok):
        raise AssertionError(f"SPPM not deterministic: rerun {same}, resume "
                             f"{resume_ok}")
    out.update(iterations=iters, peak_gib=peak, pixels_gathered=gathered,
               reduction=red, busy=busy, rerun_same_bits=same,
               resume_same_bits=resume_ok,
               chunks=dict(pixel_chunk=integ.pixel_chunk,
                           pair_chunk=integ.pair_chunk))
    log(6, t0, f"whole run so far {time.perf_counter() - t_all:.1f} s")
    return out


def median_ms(fn, n):
    """``fn`` warm once, then each of ``n`` calls timed alone with CUDA
    events: (median ms, every ms)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times)), times


def record_sweep_calls(render, *args, **kw):
    """Run ``render(*args, **kw)``; return (its result, [(o, d, t_max,
    any_hit)] of every sweep call, the accelerator of each call). An
    animated frame makes its accelerator inside the render, so the class's
    method is wrapped for the call and restored after."""
    from trace_tpu_torch.ops.sweep import SweepAccelerator

    calls, accs = [], []
    traced = SweepAccelerator.intersect

    def record(self, o, d, t_max, any_hit):
        calls.append((o.clone(), d.clone(), t_max.clone(), any_hit))
        accs.append(self)
        return traced(self, o, d, t_max, any_hit)

    SweepAccelerator.intersect = record
    try:
        out = render(*args, **kw)
    finally:
        SweepAccelerator.intersect = traced
    return out, calls, accs


def check_launches(phase, acc, calls):
    """Every sweep launch of the recorded calls (and the camera rays as
    any-hit) against sweep_plain: hits, ids and t within T_RTOL, the same
    steps, and the step-counting arm's results equal to the default arm's;
    the prologue kernel bit-equal to its plain version on every launched
    chunk, and no live lane in a skipped chunk. Returns (the agreement per
    call, the prologue's, sweep_chunks' launches)."""
    import torch
    from trace_tpu_torch.ops.sweep import sweep_kernel, sweep_plain

    pro_tot, agree = {}, {}
    b = acc.block_rays
    chunks = sweep_chunks(acc, calls, pro_tot)
    for name, anyh, ch in chunks:
        tot = {}
        for _, args in ch:
            kt, ki = sweep_kernel(*args, acc.panel, b, anyh)
            st, si, ks = sweep_kernel(*args, acc.panel, b, anyh,
                                      collect_stats=True)
            pt, pi, ps = sweep_plain(*args, acc.panel, b, anyh,
                                     collect_stats=True)
            torch.cuda.synchronize()
            accumulate(tot, compare(kt, ki, pt, pi))
            tot["steps_differ"] = tot.get("steps_differ", 0) + int(
                (ks != ps).sum())
            tot["stats_arm_differs"] = tot.get("stats_arm_differs", 0) + int(
                not (torch.equal(st, kt) and torch.equal(si, ki)))
            tot["launches"] = tot.get("launches", 0) + 1
        agree[name] = tot
        if disagrees(tot) or tot.get("steps_differ") \
                or tot.get("stats_arm_differs"):
            raise AssertionError(f"[{phase}] kernel disagrees with plain: "
                                 f"{name} {tot}")
    if prologue_disagrees(pro_tot):
        raise AssertionError(f"[{phase}] prologue kernel disagrees: "
                             f"{pro_tot}")
    return agree, pro_tot, chunks


def walk_stats(acc, calls):
    """Per recorded call, through ``acc``'s tables (in its own ray order):
    launches, the sweep's steps, the busiest block's steps and the kernel's
    ms (3 launches each, summed over the call's chunks)."""
    from trace_tpu_torch.ops.sweep import sweep_kernel

    rows = []
    for o, d, tm, anyh in calls:
        perm = acc.coherence_order(o, d, tm)
        o, d, tm = o[perm], d[perm], tm[perm]
        row = dict(launches=0, steps=0, busiest=0, ms=0.0)
        for s in acc.live_chunks(tm):
            sl = slice(s, s + acc.ray_chunk)
            args = acc.prologue(o[sl], d[sl], tm[sl])
            steps = sweep_kernel(*args, acc.panel, acc.block_rays, anyh,
                                 collect_stats=True)[2]
            row["launches"] += 1
            row["steps"] += int(steps.sum())
            row["busiest"] = max(row["busiest"], int(steps.max()))
            row["ms"] += cuda_ms(lambda: sweep_kernel(
                *args, acc.panel, acc.block_rays, anyh), 3)
        rows.append(row)
    return rows


def tables_differ(a, b) -> list:
    """The fields in which two SweepTables (host or device) differ."""
    import torch

    def host(x):
        return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

    return [f for f in ("panel", "slot_to_tri", "s_lo", "s_hi")
            if not np.array_equal(host(getattr(a, f)), host(getattr(b, f)))]


def glass_standin(nu=296, nv=150) -> dict:
    """Bench config 5's stand-in for the caustic glass, whose PLY is not in
    the repository: a closed UV sphere of radius 1 at the caustic mesh's box
    centre in the PLY's frame, (-3.75, 2.5, 2.425) (world (1.25, 1.01,
    -97.575), in the moving spot's cone above the floor), 2 nu (nv - 1) =
    88,208 triangles wound outward, with smooth normals, as load_ply's
    dict."""
    centre = np.array([-3.75, 2.5, 2.425], np.float32)
    th = np.linspace(0.0, np.pi, nv + 1)[1:-1]
    ph = np.arange(nu) * (2.0 * np.pi / nu)
    ring = np.stack([np.outer(np.sin(th), np.cos(ph)),
                     np.repeat(np.cos(th)[:, None], nu, 1),
                     np.outer(np.sin(th), np.sin(ph))], -1).reshape(-1, 3)
    unit = np.concatenate([[[0.0, 1.0, 0.0]], ring,
                           [[0.0, -1.0, 0.0]]]).astype(np.float32)
    j = np.arange(nu)[None]
    a = 1 + np.arange(nv - 1)[:, None] * nu + j     # ring i, column j
    b = 1 + np.arange(nv - 1)[:, None] * nu + (j + 1) % nu
    last = unit.shape[0] - 1
    idx = np.concatenate([
        np.stack([np.zeros(nu, np.int64), a[0], b[0]], -1),
        np.stack([a[:-1], a[1:], b[:-1]], -1).reshape(-1, 3),
        np.stack([b[:-1], a[1:], b[1:]], -1).reshape(-1, 3),
        np.stack([np.full(nu, last), b[-1], a[-1]], -1)])
    verts = unit + centre
    p = verts[idx]
    inward = (np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
              * (p.mean(1) - centre)).sum(-1) < 0
    idx[inward] = idx[inward][:, [0, 2, 1]]
    return dict(indices=idx.astype(np.uint32), vertices=verts,
                normals=unit, uv=None)


# Phase 7's motions: the 1M terrain's frame (7b), and bench config 5's
# per-frame translation of the whole scene (bench.py:1059-1063), over the
# frames it times (shifts 0.1, 0.2, ...; shift 0 warms).
ANIM_XF = (0.0, 0.05, 0.0), 2.0
ANIM_SHIFTS = (0.1, 0.2, 0.3, 0.4)


def slice7(dev, card, scene, t_all):
    """Phase 7: animated geometry (module docstring)."""
    import torch
    from trace_tpu_torch.accel import clusters as TC
    from trace_tpu_torch.accel.morton import build_clusters_device
    from trace_tpu_torch.core import transform as T
    from trace_tpu_torch.integrators import common as IC
    from trace_tpu_torch.integrators.sppm import SPPMIntegrator
    WhittedIntegrator = eager_whitted
    from trace_tpu_torch.models import caustic_glass, caustic_moving, \
        mesh_heavy
    from trace_tpu_torch.ops import sweep as TS
    from trace_tpu_torch.ops.sweep import block_entry_kernel, sweep_kernel
    from trace_tpu_torch.sampler import uniform as U
    from trace_tpu_torch.scene import GROUP, LEAF_TRIS
    from trace_tpu_torch.shapes import triangle as tri_mod

    tmp = tempfile.gettempdir()
    out = {}
    # -- 7a: the device rebuild of the 1M mesh against the host packing ----
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    xf = T.compose(T.translate(ANIM_XF[0]), T.rotate_y(ANIM_XF[1]))
    base = tri_mod.to_device(scene.triangles, dev)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tris, tables = IC.prepare_geometry(scene, base, xf)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - mem0) / 2**30
    rebuild_ms, rebuild_all = median_ms(
        lambda: IC.prepare_geometry(scene, base, xf), 5)
    clusters = build_clusters_device(tris, LEAF_TRIS)
    host = TC.to_host(clusters)
    packing = tables_differ(tables, TS.SweepTables(host, GROUP))
    # The same transform and build on the host's CPU: the same bits.
    cpu_tris = tri_mod.transform_triangles(
        tri_mod.to_device(scene.triangles, "cpu"), xf)
    cpu_cl = build_clusters_device(cpu_tris, LEAF_TRIS)
    cpu_differ = [f for f in tri_mod.Triangles._fields if not torch.equal(
        getattr(tris, f).cpu(), getattr(cpu_tris, f))] + [
        f for f in ("c_lo", "c_hi", "packed_mt", "tri_id") if not
        torch.equal(getattr(clusters, f).cpu(), getattr(cpu_cl, f))]
    del host, cpu_tris, cpu_cl
    # Refit the scene's SAH tables to the moved mesh: super boxes against
    # the moved vertices' own, and back to the base mesh: the static
    # tables, bit for bit.
    sah = scene.accel.tables
    racc = scene.sweep(sah)
    t1 = time.perf_counter()
    racc.refit(tris.v0, tris.v1, tris.v2)
    refit_s = time.perf_counter() - t1
    slot = racc.slot_to_tri.reshape(sah.n_supers, -1)
    ok = (slot >= 0)[..., None]
    vlo = torch.minimum(torch.minimum(tris.v0, tris.v1), tris.v2)
    vhi = torch.maximum(torch.maximum(tris.v0, tris.v1), tris.v2)
    s_lo = torch.where(ok, vlo[slot.clamp_min(0)], float("inf")).amin(1)
    s_hi = torch.where(ok, vhi[slot.clamp_min(0)], -float("inf")).amax(1)
    boxes_ok = torch.equal(s_lo, racc.s_lo) and torch.equal(s_hi, racc.s_hi)
    racc.refit(base.v0, base.v1, base.v2)
    refit_back = tables_differ(racc.tables, sah)
    del racc, slot, ok, vlo, vhi, s_lo, s_hi
    out["a"] = dict(n_triangles=scene.n_triangles, rebuild_ms=rebuild_ms,
                    rebuild_all_ms=rebuild_all, peak_gib=peak,
                    morton_supers=tables.n_supers, sah_supers=sah.n_supers,
                    clusters=int(clusters.tri_id.shape[0]), refit_s=refit_s,
                    packing_differs=packing, cpu_build_differs=cpu_differ,
                    refit_boxes_equal=boxes_ok, refit_back_differs=refit_back)
    log("7a", t0, f"1M mesh ({scene.n_triangles} triangles) moved and "
        f"rebuilt on the card: {rebuild_ms:.3f} ms (median of 5: "
        f"{[round(x, 3) for x in rebuild_all]}), {out['a']['clusters']} "
        f"Morton clusters in {tables.n_supers} supers (SAH: "
        f"{sah.n_supers}), peak {peak:.3f} GiB over the resident mesh; "
        f"device tables vs host packing of the same clusters: differ in "
        f"{packing or 'nothing'}; vs the same build on the CPU: differ in "
        f"{cpu_differ or 'nothing'}; refit of the SAH tables {refit_s:.2f} "
        f"s (host), super boxes equal the moved vertices' {boxes_ok}, "
        f"refit back to the base mesh differs from the static build in "
        f"{refit_back or 'nothing'}; card {card}")
    if packing or cpu_differ or refit_back or not boxes_ok:
        raise AssertionError(f"device rebuild or refit mismatch: {out['a']}")
    del clusters, tables, tris

    # -- 7b: the animated 1M Whitted frame ------------------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    png = os.path.join(tmp, "chip_smoke_anim_1m.png")
    integ = WhittedIntegrator(mesh_heavy.build_camera(256, png),
                              U.UniformSampler(1, seed=0), max_depth=2,
                              pixel_chunk=ONE_CHUNK)
    kw = dict(geometry=base, geometry_transform=xf)
    sweep_kernel.reset_counts()
    block_entry_kernel.reset_counts()
    state, calls, accs = record_sweep_calls(integ.render, scene, **kw)
    acc = accs[0]
    launches = dict(sweep=sweep_kernel.launches,
                    f32=sweep_kernel.arm_launches["f32"],
                    prologue=block_entry_kernel.launches,
                    skipped=acc.skipped_chunks)
    img = image(integ, state)
    integ.camera.film.save_png(state)
    if launches["sweep"] <= 0 or launches["f32"] != launches["sweep"] \
            or launches["prologue"] != launches["sweep"] \
            or any(a is not acc for a in accs) or acc is scene.accel \
            or not torch.is_tensor(acc.tables.panel):
        raise AssertionError(f"the animated frame did not run the kernels "
                             f"on device-built tables: {launches}")
    agree, pro, _ = check_launches("7b", acc, calls)
    rebuilt = mesh_heavy.build_scene(1_000_000, device=dev,
                                     terrain_to_world=xf)
    ref_img = image(integ, integ.render(rebuilt))
    mse = float(np.mean((img - ref_img) ** 2))
    lanes_differ = []
    for o, d, tm, anyh in calls:
        h1, _, i1 = acc.intersect(o, d, tm, anyh)
        h2, _, i2 = rebuilt.accel.intersect(o, d, tm, anyh)
        diff = h1 != h2
        if not anyh:
            diff |= h1 & (i1 != i2)
        lanes_differ.append(int(diff.sum()))
    walks = dict(morton=walk_stats(acc, calls),
                 sah=walk_stats(rebuilt.accel, calls))
    times, _ = timed_frames(integ, scene, **kw)
    static_times, _ = timed_frames(integ, rebuilt)
    out["b"] = dict(launches=launches, agreement=agree, prologue=pro,
                    mse=mse, lanes_differ=lanes_differ, walks=walks,
                    frame_ms=times, rebuilt_scene_frame_ms=static_times)
    log("7b", t0, f"animated 256^2 depth-2 frame: {len(calls)} sweep calls, "
        f"launches {launches}; every launch equal to sweep_plain with the "
        f"same steps ({sum(t.get('launches', 0) for t in agree.values())} "
        f"checked), prologue bit-equal ({pro}); vs the scene rebuilt from "
        f"the moved mesh (SAH): MSE {mse:.3e} (gate {MSE_GATE}), lanes whose "
        f"hit or triangle differs per call {lanes_differ}; PNG {png}")
    for label, rows in walks.items():
        log("7b", t0, f"{label} supers, same rays: steps "
            f"{[r['steps'] for r in rows]}, busiest block "
            f"{[r['busiest'] for r in rows]}, kernel ms "
            f"{[round(r['ms'], 3) for r in rows]}")
    log("7b", t0, f"frames {[round(x, 2) for x in times]} ms (mean "
        f"{np.mean(times):.2f}); the rebuilt scene's static frames "
        f"{[round(x, 2) for x in static_times]} ms (mean "
        f"{np.mean(static_times):.2f}); card {card}")
    if not (np.isfinite(img).all() and mse < MSE_GATE):
        raise AssertionError(f"animated 1M frame: MSE {mse}")
    del calls, accs, acc, rebuilt, base, state
    torch.cuda.empty_cache()

    # -- 7c: bench config 5's settings on the stand-in ----------------------
    t0 = time.perf_counter()
    scene5 = caustic_glass.scene_around(glass_standin(), dev)
    base5 = tri_mod.to_device(scene5.triangles, dev)
    png5 = os.path.join(tmp, "chip_smoke_anim_relight.png")
    integ5 = SPPMIntegrator(caustic_glass.build_camera(128, png5),
                            initial_search_radius=0.055, max_depth=5,
                            n_iterations=2, photons_per_iteration=65536,
                            device=dev)

    def move(shift):
        return T.translate([0.0, 0.002 * shift, 0.0])

    def frame(shift):
        caustic_moving.set_frame_lights(scene5, shift)
        return integ5.render(scene5, n_iterations=2, geometry=base5,
                             geometry_transform=move(shift))

    rebuild5_ms, rebuild5_all = median_ms(
        lambda: IC.prepare_geometry(scene5, base5, move(0.1)), 5)
    frame(0.0)   # warm
    marks, views = [], []
    prep, apply_ = IC.prepare_geometry, IC.apply_geometry

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    def prep_timed(*a, **k):
        geom = prep(*a, **k)
        mark("rebuild")
        return geom

    def apply_timed(*a, **k):
        view = apply_(*a, **k)
        views.append(view)
        mark("view")
        return view

    time_phases(integ5, marks)
    IC.prepare_geometry, IC.apply_geometry = prep_timed, apply_timed
    states, rows = {}, []
    try:
        for shift in ANIM_SHIFTS:
            marks.clear()
            views.clear()
            sweep_kernel.reset_counts()
            block_entry_kernel.reset_counts()
            mark("start")
            st = frame(shift)
            mark("end")
            torch.cuda.synchronize()
            states[shift] = st
            row = dict(shift=shift, ms=marks[0][1].elapsed_time(marks[-1][1]),
                       sweep_launches=sweep_kernel.launches,
                       f32_launches=sweep_kernel.arm_launches["f32"],
                       prologue_launches=block_entry_kernel.launches,
                       skipped_chunks=views[0].accel.skipped_chunks,
                       gathered=int((st.tau.sum(-1) > 0).sum()),
                       finite=bool(torch.isfinite(
                           integ5.to_image(st, 2)).all()))
            # Each mark ends a span that starts at the mark before it.
            row["spans"] = [(n, p.elapsed_time(e)) for (_, p), (n, e)
                            in zip(marks[:-1], marks[1:])]
            rows.append(row)
            log("7c", t0, f"frame shift {shift}: {row['ms']:.2f} ms; " +
                ", ".join(f"{n} {ms:.2f}" for n, ms in row["spans"]) +
                f" ms; sweep launches {row['sweep_launches']}, prologue "
                f"{row['prologue_launches']}, chunks skipped "
                f"{row['skipped_chunks']}, pixels with tau > 0 "
                f"{row['gathered']}, finite {row['finite']}; card {card}")
            if row["sweep_launches"] <= 0 or row["f32_launches"] != \
                    row["sweep_launches"] or row["prologue_launches"] != \
                    row["sweep_launches"] or row["gathered"] <= 0 \
                    or not row["finite"]:
                raise AssertionError(f"config-5 frame {shift}: {row}")
    finally:
        IC.prepare_geometry, IC.apply_geometry = prep, apply_
        for name in SPPM_PHASES:
            delattr(integ5, name)
    integ5.save(states[ANIM_SHIFTS[-1]], 2)
    frame_ms = [r["ms"] for r in rows]
    busy = NOT_PROFILED
    # One frame's every sweep launch against the plain version.
    _, calls5, accs5 = record_sweep_calls(frame, 0.5)
    agree5, pro5, _ = check_launches("7c", accs5[0], calls5)
    del calls5, accs5
    # render_frames: frame k is the render of frame k; and a frame of
    # pre-moved triangles is the frame moved on the device.
    stacked = integ5.render_frames(
        scene5, [caustic_moving.frame_lights(s) for s in ANIM_SHIFTS],
        n_iterations=2, geometry=base5,
        frame_transforms=[move(s) for s in ANIM_SHIFTS])
    batch_same = [states_equal(caustic_moving._frame(stacked, k), states[s])
                  for k, s in enumerate(ANIM_SHIFTS)]
    s = ANIM_SHIFTS[0]
    caustic_moving.set_frame_lights(scene5, s)
    moved_same = states_equal(integ5.render(
        scene5, n_iterations=2,
        geometry=tri_mod.transform_triangles(base5, move(s))), states[s])
    out["c"] = dict(n_triangles=scene5.n_triangles, rebuild_ms=rebuild5_ms,
                    rebuild_all_ms=rebuild5_all, frames=rows, busy=busy,
                    agreement=agree5, prologue=pro5,
                    render_frames_same_bits=batch_same,
                    moved_geometry_same_bits=moved_same)
    log("7c", t0, f"stand-in ({scene5.n_triangles} triangles) 128^2, 2 "
        f"iterations of 65536 "
        f"photons a frame, depth 5, r0 0.055: frames "
        f"{[round(x, 2) for x in frame_ms]} ms (mean {np.mean(frame_ms):.2f}"
        f"), rebuild alone {rebuild5_ms:.3f} ms (median of 5); one frame's "
        f"{sum(t.get('launches', 0) for t in agree5.values())} sweep launches "
        f"equal to sweep_plain, prologue bit-equal ({pro5}); render_frames "
        f"frame k == render of frame k: {batch_same}; pre-moved geometry == "
        f"moved on the card: {moved_same}; PNG {png5}; card {card}")
    if not (all(batch_same) and moved_same):
        raise AssertionError("render_frames or pre-moved geometry differs "
                             "from render")
    log(7, t0, f"whole run so far {time.perf_counter() - t_all:.1f} s")
    return out


def env_box(dev):
    """test_sppm.py's open box under a constant sky (radiance 1.5): five
    matte quads, open toward +z, brute-force triangles."""
    from trace_tpu_torch.lights.lights import infinite_light
    from trace_tpu_torch.materials.materials import MatteMaterial
    from trace_tpu_torch.models.cornell import _quad
    from trace_tpu_torch.scene import SceneBuilder

    b = SceneBuilder()
    white = b.material(MatteMaterial(Kd=(0.7, 0.7, 0.7)))
    for q in ([[-1, -1, 1], [1, -1, 1], [1, -1, -1], [-1, -1, -1]],
              [[-1, 1, -1], [1, 1, -1], [1, 1, 1], [-1, 1, 1]],
              [[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1]],
              [[-1, -1, 1], [-1, -1, -1], [-1, 1, -1], [-1, 1, 1]],
              [[1, -1, -1], [1, -1, 1], [1, 1, 1], [1, 1, -1]]):
        _quad(b, q, white)
    b.light(infinite_light(radiance=(1.5, 1.5, 1.5)))
    return b.build(device=dev)


def relit(scene, entries):
    """A view of ``scene`` lit by ``entries`` (Scene.with_lights): the 1M
    mesh's tables are built once."""
    from trace_tpu_torch.lights import lights as L

    return scene.with_lights(L.preprocess(
        L.pack_lights(entries, scene.triangles), *scene.bounding_sphere()))


def mesh_point():
    """mesh_heavy's point light."""
    from trace_tpu_torch.core import transform as T
    from trace_tpu_torch.lights import lights as L

    return L.point_light(T.translate([4.0, 8.0, 4.0]), (400.0, 400.0, 400.0))


def mesh_sky():
    """env_studio's sky over mesh_heavy's y-up terrain: rotate_x(-90) turns
    the env frame's +z (the sky's zenith) to +y."""
    from trace_tpu_torch.core import transform as T
    from trace_tpu_torch.lights import lights as L
    from trace_tpu_torch.models import env_studio

    return L.infinite_light(l2w=T.rotate_x(-90.0),
                            image=env_studio.sky_image())


# The pixels of mesh_heavy5k_env_32 that camera lane 630 reaches (its 3 x 3
# filter stencil around pixel (17, 17)): jitted JAX blocks both of its
# shadow rays, the port clears them (ROADMAP C). Every other pixel agrees
# with the golden within LANE_ATOL.
LANE_630_PIXELS = (slice(16, 19), slice(16, 19))
LANE_ATOL = 1e-3


def slice8(dev, card, scene, t_all):
    """Phase 8: environment lights and the pbrt / thin-lens camera (module
    docstring)."""
    import torch
    from trace_tpu_torch.camera.perspective import PerspectiveCamera
    from trace_tpu_torch.core import transform as T
    from trace_tpu_torch.core.vec import V3
    from trace_tpu_torch.film.film import Film
    from trace_tpu_torch.integrators.path import PathIntegrator
    from trace_tpu_torch.integrators.sppm import SPPMIntegrator
    WhittedIntegrator = eager_whitted
    from trace_tpu_torch.models import env_studio, mesh_heavy
    from trace_tpu_torch.ops.sweep import block_entry_kernel, sweep_kernel
    from trace_tpu_torch.sampler import uniform as U
    from trace_tpu_torch.wavefront import lights as WL
    from trace_tpu_torch.wavefront import whitted as WF

    tmp = tempfile.gettempdir()
    out = {}
    # -- 8a: goldens and the thin-lens camera's rays ------------------------
    t0 = time.perf_counter()
    studio = env_studio.build_scene(device=dev)
    small = relit(mesh_heavy.build_scene(5000, device=dev),
                  [mesh_point(), mesh_sky()])
    for label, sc, mod, make, path in (
            ("env_studio32", studio, env_studio,
             lambda c: PathIntegrator(c, U.UniformSampler(4, seed=0),
                                      max_depth=3, pixel_chunk=ONE_CHUNK),
             ENV_STUDIO_GOLDEN),
            ("mesh_heavy5k_env_32", small, mesh_heavy,
             lambda c: WhittedIntegrator(c, U.UniformSampler(1, seed=0),
                                         max_depth=2, pixel_chunk=ONE_CHUNK),
             MESH_ENV_GOLDEN)):
        sweep_kernel.reset_counts()
        it = make(mod.build_camera(32, os.path.join(
            tmp, f"chip_smoke_{label}.png")))
        img = image(it, it.render(sc))
        golden = np.load(path)
        mse = float(np.mean((img - golden) ** 2))
        diff = np.abs(img - golden).max(-1)
        where = "every pixel"
        if label == "mesh_heavy5k_env_32":
            diff[LANE_630_PIXELS] = 0.0
            where = "outside lane 630's pixels"
        rest = float(diff.max())
        out[f"golden_{label}"] = dict(mse=mse, max_abs=float(
            np.abs(img - golden).max()), max_abs_other_pixels=rest,
            sweep_launches=sweep_kernel.launches)
        log("8a", t0, f"golden {label}: MSE {mse:.3e} (gate {MSE_GATE}), "
            f"max abs {out[f'golden_{label}']['max_abs']:.4f}, {where} "
            f"{rest:.3e} (gate {LANE_ATOL}), sweep "
            f"launches {sweep_kernel.launches}")
        if not (img.shape == golden.shape and np.isfinite(img).all()
                and mse < MSE_GATE and rest <= LANE_ATOL):
            raise AssertionError(f"golden mismatch ({label}): MSE {mse}, "
                                 f"max abs {where} {rest}")
    if out["golden_mesh_heavy5k_env_32"]["sweep_launches"] <= 0:
        raise AssertionError("the 5k env frame did not launch the sweep")
    rng = np.random.default_rng(8)
    n = 65536
    samples = [np.stack([rng.uniform(1.0, 257.0, n), rng.uniform(
        1.0, 257.0, n)], -1), rng.uniform(size=(n, 2)), rng.uniform(size=n)]
    samples = [torch.from_numpy(x.astype(np.float32)) for x in samples]
    lens = PerspectiveCamera(
        T.look_at([3.2, -3.2, 1.6], [0.0, 0.0, 0.35], [0.0, 0.0, 1.0]),
        lens_radius=0.05, focal_distance=4.6, fov=35.0,
        film=Film((256, 256), filename="unused.png"), convention="pbrt")
    rd_gpu, _ = lens.generate_ray_differentials(*[x.to(dev)
                                                  for x in samples])
    rd_cpu, _ = lens.generate_ray_differentials(*samples)
    ray_err = max(float((getattr(rd_gpu, f).cpu() - getattr(rd_cpu, f))
                        .abs().max()) for f in (
        "o", "d", "rx_origin", "ry_origin", "rx_direction", "ry_direction"))
    out["lens_rays_max_abs"] = ray_err
    log("8a", t0, f"pbrt thin-lens camera (radius 0.05, focal 4.6), {n} "
        f"rays with differentials on the card vs the CPU: max abs "
        f"{ray_err:.3e} (gate 1e-6)")
    if ray_err > 1e-6:
        raise AssertionError(f"camera rays differ: {ray_err}")
    del small

    # -- 8b: env_studio_512 ---------------------------------------------------
    t0 = time.perf_counter()
    png = os.path.join(tmp, "chip_smoke_env_studio_512.png")
    cam = env_studio.build_camera(512, png)
    integ = PathIntegrator(cam, U.UniformSampler(4, seed=0), max_depth=5,
                           pixel_chunk=ONE_CHUNK)
    torch.cuda.reset_peak_memory_stats()
    sweep_kernel.reset_counts()
    times, state = timed_frames(integ, studio)
    peak = torch.cuda.max_memory_allocated() / 2**30
    img = image(integ, state)
    cam.film.save_png(state)
    # The top corners' rays miss the scene (they see the sky above the
    # floor's far edge); each corner pixel must read the sky along its
    # centre ray (pixel (x, y), 1-based, is centred at raster (x, y) + 0.5).
    w = cam.film.width
    p = torch.tensor([[1.5, 1.5], [w + 0.5, 1.5]], device=dev)
    rd, _ = cam.generate_ray_differentials(p, torch.zeros(2, 2, device=dev),
                                           torch.zeros(2, device=dev))
    miss = not WF.closest_hit(studio, V3.of(rd.o), V3.of(rd.d), rd.t_max,
                              rd.time).valid.any()
    sky = WL.env_le(studio, V3.of(rd.d)).arr().cpu().numpy()
    sky_ratio = (img[0, [0, -1]] / sky).tolist()
    out["env_studio_512"] = dict(
        frame_ms=times, ms=float(np.mean(times)),
        useful_rays=integ.last_useful_rays, peak_gib=peak,
        sweep_launches=sweep_kernel.launches, corner_sky_ratio=sky_ratio)
    log("8b", t0, f"env_studio 512^2, path tracer, 4 spp (cut from 64), "
        f"depth 5: frames {[round(x, 2) for x in times]} ms, mean "
        f"{np.mean(times):.2f}; useful rays {integ.last_useful_rays} "
        f"({integ.last_useful_rays / np.mean(times) / 1e3:.3f} Mrays/s); "
        f"peak {peak:.3f} GiB; sweep launches {sweep_kernel.launches}; "
        f"top corners / the sky along their centre rays {sky_ratio} (gate "
        f"5%); PNG {png}; card {card}")
    if not (np.isfinite(img).all() and miss and sweep_kernel.launches == 0
            and np.abs(np.asarray(sky_ratio) - 1.0).max() < 0.05):
        raise AssertionError(f"env_studio 512: {out['env_studio_512']}")
    out["env_studio_512"]["busy"] = NOT_PROFILED
    del studio, state

    # -- 8c: mesh1m_whitted_256_env, the kernel path -------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    lit = relit(scene, [mesh_point(), mesh_sky()])
    acc = lit.accel
    png = os.path.join(tmp, "chip_smoke_1m_env.png")
    integ = WhittedIntegrator(mesh_heavy.build_camera(256, png),
                              U.UniformSampler(1, seed=0), max_depth=2,
                              pixel_chunk=ONE_CHUNK)
    sweep_kernel.reset_counts()
    block_entry_kernel.reset_counts()
    acc.skipped_chunks = 0
    state, calls, _ = record_sweep_calls(integ.render, lit)
    launches = dict(sweep=sweep_kernel.launches,
                    f32=sweep_kernel.arm_launches["f32"],
                    prologue=block_entry_kernel.launches,
                    skipped=acc.skipped_chunks)
    integ.camera.film.save_png(state)
    img = image(integ, state)
    if [a for *_, a in calls] != [False, True, True, False, True, True] \
            or launches["sweep"] <= 0 or launches["f32"] != \
            launches["sweep"] or launches["prologue"] != launches["sweep"]:
        raise AssertionError(f"the env frame did not run the kernels: "
                             f"{len(calls)} calls, {launches}")
    agree, pro, _ = check_launches("8c", acc, calls)
    times, _ = timed_frames(integ, lit)
    plain_times, _ = timed_frames(integ, scene)
    out["whitted_1m_env"] = dict(launches=launches, agreement=agree,
                                 prologue=pro, frame_ms=times,
                                 point_only_frame_ms=plain_times)
    log("8c", t0, f"1M + sky, Whitted 256^2 depth 2: {len(calls)} sweep "
        f"calls (camera, point and sky shadows, specular, their shadows), "
        f"launches {launches}; every launch equal to sweep_plain with the "
        f"same steps ({sum(t.get('launches', 0) for t in agree.values())} "
        f"checked, sky shadows included), prologue bit-equal ({pro}); "
        f"frames {[round(x, 2) for x in times]} ms (mean "
        f"{np.mean(times):.2f}), the point-lit frame "
        f"{[round(x, 2) for x in plain_times]} (mean "
        f"{np.mean(plain_times):.2f}); non-zero pixels "
        f"{float((img > 0).any(-1).mean()):.3f}; PNG {png}; card {card}")
    if not np.isfinite(img).all():
        raise AssertionError("the 1M env frame is not finite")
    del calls, state, lit

    # -- 8d: SPPM under the sky alone ----------------------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    lit = relit(scene, [mesh_sky()])
    acc = lit.accel
    png = os.path.join(tmp, "chip_smoke_sppm_1m_env.png")
    integ = SPPMIntegrator(mesh_heavy.build_camera(256, png),
                           initial_search_radius=0.3, max_depth=5,
                           n_iterations=3, photons_per_iteration=65536,
                           seed=0, device=dev)
    integ.check_scene(lit)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, state = sppm_iterations("8d", t0, card, integ, lit, acc, 3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    pixels = integ._pixel_grid(dev)
    key = U.key(integ.seed, dev)
    cdf, pmf = integ.light_distribution(lit)
    img = integ.to_image(state, 3)
    gathered = int((state.tau.sum(-1) > 0).sum())
    finite = bool(torch.isfinite(img).all())
    integ.save(state, 3)
    busy = NOT_PROFILED
    _, calls, _ = record_sweep_calls(integ.render, lit, n_iterations=1)
    agree, pro, _ = check_launches("8d", acc, calls)
    log("8d", t0, f"1M under the sky alone, 256^2, 65536 photons, depth 5, "
        f"r0 0.3: iterations {[round(r['ms'], 2) for r in rows]} ms (the "
        f"first warm); peak {peak:.3f} GiB; pixels with tau > 0 "
        f"{gathered}; finite {finite}; one iteration's {len(calls)} sweep "
        f"calls, {sum(t.get('launches', 0) for t in agree.values())} "
        f"launches equal to sweep_plain with the same steps, prologue "
        f"bit-equal ({pro}); PNG {png}; card {card}")
    if not finite or gathered <= 0:
        raise AssertionError(f"env SPPM image: finite {finite}, pixels "
                             f"with tau > 0 {gathered}")
    out["sppm_1m_env"] = dict(iterations=rows, peak_gib=peak,
                              pixels_gathered=gathered, busy=busy,
                              agreement=agree, prologue=pro)
    del calls, state, lit
    torch.cuda.empty_cache()

    # The open box under a constant sky: SPPM against the path tracer.
    t0 = time.perf_counter()
    box = env_box(dev)

    def box_camera():
        film = Film((12, 12), filename=os.path.join(tmp, "chip_smoke_"
                                                    "env_box.png"))
        return PerspectiveCamera(T.look_at([0.0, 0.0, 140.0],
                                           [0.0, -2.8, 0.0], [0, 1, 0]),
                                 film=film)

    cam = box_camera()
    pt = PathIntegrator(cam, U.UniformSampler(24, seed=0), max_depth=8,
                        rr_depth=5, pixel_chunk=ONE_CHUNK)
    mean_pt = float(image(pt, pt.render(box)).mean())
    sp = SPPMIntegrator(box_camera(), initial_search_radius=0.25,
                        max_depth=8, n_iterations=8,
                        photons_per_iteration=8192, seed=0, device=dev)
    mean_sp = float(sp.to_image(sp.render(box), 8).mean())
    ratio = mean_sp / mean_pt
    out["env_box"] = dict(sppm_mean=mean_sp, path_mean=mean_pt, ratio=ratio)
    log("8d", t0, f"open box under a constant sky, 12^2: SPPM (8 "
        f"iterations of 8192 photons) mean {mean_sp:.4f}, path tracer (24 "
        f"spp) {mean_pt:.4f}, ratio {ratio:.3f} (must be in (0.5, 2))")
    if not 0.5 < ratio < 2.0:
        raise AssertionError(f"env box ratio {ratio}")
    log(8, t0, f"whole run so far {time.perf_counter() - t_all:.1f} s")
    return out


# Phase 9's scenes: test_instances.py's pairs (a tetrahedron and a wavy
# 128-triangle grid, four placements), and 100 copies of the glass
# stand-in, 10 x 10 on a floor, with rotations and two mirrors.
INST_GOLDEN = os.path.join(REPO, "tests", "goldens", "sphere_field6_32.npy")
FLAT_GATE = 1e-6
STANDIN_CENTRE = (-3.75, 2.5, 2.425)   # glass_standin's centre
INST_GROUPS = (16, 32, 128, 1024)


def tetra_mesh():
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
                     np.float32)
    return np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]],
                    np.uint32), verts


def grid_mesh(n=9):
    xs = np.linspace(0.0, 1.0, n, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    gz = 0.1 * np.sin(6.0 * gx) * np.cos(5.0 * gy)
    verts = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    v00 = (ii * n + jj).reshape(-1)
    return np.concatenate(
        [np.stack([v00, v00 + n, v00 + 1], -1),
         np.stack([v00 + 1, v00 + n, v00 + n + 1], -1)], 0).astype(
             np.uint32), verts


def pair_scenes(mesh, dev):
    """(instanced, flattened) scenes of test_instances.py's _build_pair."""
    from trace_tpu_torch.core import transform as T
    from trace_tpu_torch.lights.lights import point_light
    from trace_tpu_torch.materials.materials import MatteMaterial
    from trace_tpu_torch.scene import SceneBuilder

    idx, verts = mesh
    trs = [T.translate([0.0, 0.0, -3.0]),
           T.compose(T.translate([2.0, 0.5, -4.0]), T.rotate_y(40.0)),
           T.compose(T.translate([-2.0, -0.5, -5.0]),
                     T.compose(T.rotate_x(25.0), T.scale(1.5, 0.8, 1.2))),
           T.compose(T.translate([0.5, 2.0, -6.0]), T.rotate_z(70.0))]
    out = []
    for flat in (False, True):
        b = SceneBuilder()
        mat = b.material(MatteMaterial(Kd=(0.7, 0.6, 0.5)))
        if flat:
            for t in trs:
                b.triangle_mesh(t, idx, verts, mat)
        else:
            b.instanced_mesh(idx, verts, trs, mat)
        b.light(point_light(T.translate([0.0, 5.0, 0.0]), (50.0, 50.0, 50.0)))
        out.append(b.build(device=dev))
    return out


def pair_image(scene, res=24):
    from trace_tpu_torch.camera.perspective import PerspectiveCamera
    from trace_tpu_torch.core import transform as T
    from trace_tpu_torch.film.film import Film
    from trace_tpu_torch.film.filters import LanczosSincFilter
    WhittedIntegrator = eager_whitted
    from trace_tpu_torch.sampler.uniform import UniformSampler

    film = Film((res, res), filter=LanczosSincFilter((1.0, 1.0), 3.0),
                filename="unused.png")
    cam = PerspectiveCamera(T.look_at([0.0, 0.3, 4.0], [0.0, 0.0, -4.0],
                                      [0.0, 1.0, 0.0]),
                            film=film, convention="pbrt")
    integ = WhittedIntegrator(cam, UniformSampler(1, seed=2), max_depth=2,
                              pixel_chunk=ONE_CHUNK)
    return image(integ, integ.render(scene))


def probe_rays(n, seed, dev):
    """test_instances.py's probe rays toward the four placements."""
    import torch
    from trace_tpu_torch.core.vec import V3

    rng = np.random.default_rng(seed)
    o = np.array([0.0, 0.3, 4.0], np.float32) + 0.3 * rng.normal(
        size=(n, 3)).astype(np.float32)
    tgt = np.stack([rng.uniform(-3, 3, n), rng.uniform(-1.5, 2.5, n),
                    rng.uniform(-6.5, -2.5, n)], -1).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        dev)
    return V3(*[t(o[:, i]) for i in range(3)]), V3(*[t(d[:, i])
                                                    for i in range(3)])


def standin_transforms(n_side, spacing=2.6):
    """n_side^2 placements of the stand-in (its centre moved to a grid at
    height 1 over the floor): every third turned about y, every third
    tilted about x, and two mirrored by scale(-1, 1, 1)."""
    from trace_tpu_torch.core import transform as T

    home = T.translate([-c for c in STANDIN_CENTRE])
    mirrored = {11, 57} if n_side == 10 else {4}
    out = []
    for k in range(n_side * n_side):
        i, j = divmod(k, n_side)
        place = T.translate([spacing * (i - (n_side - 1) / 2), 1.0,
                             spacing * (j - (n_side - 1) / 2)])
        if k in mirrored:
            turn = T.scale(-1.0, 1.0, 1.0)
        elif k % 3 == 1:
            turn = T.rotate_y(37.0 * k)
        elif k % 3 == 2:
            turn = T.rotate_x(20.0 + k)
        else:
            turn = T.identity()
        out.append(T.compose(place, turn, home))
    return out


def standin_scene(dev, n_side, flat=False):
    """n_side^2 glass stand-ins (instanced, or flattened into one triangle
    table) on a 2-triangle matte floor under a point light."""
    from trace_tpu_torch.core import transform as T
    from trace_tpu_torch.lights.lights import point_light
    from trace_tpu_torch.materials.materials import (GlassMaterial,
                                                     MatteMaterial)
    from trace_tpu_torch.scene import SceneBuilder

    g = glass_standin()
    b = SceneBuilder()
    floor = b.material(MatteMaterial(Kd=(0.6, 0.6, 0.6)))
    glass = b.material(GlassMaterial(Kr=(1.0, 1.0, 1.0), Kt=(1.0, 1.0, 1.0),
                                     index=1.5))
    trs = standin_transforms(n_side)
    if flat:
        for t in trs:
            b.triangle_mesh(t, g["indices"], g["vertices"], glass,
                            normals=g["normals"])
    else:
        b.instanced_mesh(g["indices"], g["vertices"], trs, glass,
                         normals=g["normals"])
    fv = np.array([[-16, 0, 16], [16, 0, 16], [16, 0, -16], [-16, 0, -16]],
                  np.float32)
    b.triangle_mesh(T.identity(), np.array([[0, 1, 2], [0, 2, 3]],
                                           np.uint32), fv, floor)
    b.light(point_light(T.translate([4.0, 14.0, 8.0]), (300.0, 300.0, 300.0)))
    return b.build(device=dev)


def standin_camera(res, png, n_side=10):
    from trace_tpu_torch.camera.perspective import PerspectiveCamera
    from trace_tpu_torch.core import transform as T
    from trace_tpu_torch.film.film import Film
    from trace_tpu_torch.film.filters import LanczosSincFilter

    s = 1.3 * n_side
    film = Film((res, res), filter=LanczosSincFilter((1.0, 1.0), 3.0),
                filename=png)
    return PerspectiveCamera(T.look_at([0.0, s, 1.7 * s], [0.0, 0.0, 0.0],
                                       [0.0, 1.0, 0.0]),
                             fov=50.0, film=film, convention="pbrt")


def camera_rays(cam, dev):
    """One ray through each pixel centre of ``cam``'s film, as V3s."""
    import torch
    from trace_tpu_torch.core.vec import V3

    w, h = cam.film.width, cam.film.height
    yy, xx = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    p = torch.stack([xx.reshape(-1), yy.reshape(-1)], 1).float() + 0.5
    n = p.shape[0]
    rd, _ = cam.generate_ray_differentials(
        p, torch.zeros(n, 2, device=dev), torch.zeros(n, device=dev))
    return V3.of(rd.o), V3.of(rd.d), rd.t_max


def walk_groups(phase, t0, card, geom, o, d, tm):
    """The instance walk of one recorded call at each group size in
    INST_GROUPS: ms (CUDA events, 3 calls after a warm one), groups
    visited a call, and the results equal to the default group's."""
    import torch
    from trace_tpu_torch.accel import instances as TI

    ref = TI.sweep_instances(geom, o, d, tm)
    rows = {}
    for g in INST_GROUPS:
        before = geom.groups_visited
        got = TI.sweep_instances(geom, o, d, tm, group=g)
        visited = geom.groups_visited - before
        same = all(torch.equal(a, b) for a, b in zip(ref, got))
        ms = cuda_ms(lambda: TI.sweep_instances(geom, o, d, tm, group=g), 3)
        rows[g] = dict(ms=ms, groups=visited, same=same)
    log(phase, t0, f"the walk of {o.x.shape[0]} rays over "
        f"{geom.n_instances} instances by group size: " + ", ".join(
            f"{g}: {r['ms']:.2f} ms, {r['groups']} groups"
            for g, r in rows.items()) + f" (default {TI.GROUP}); card {card}")
    if not all(r["same"] for r in rows.values()):
        raise AssertionError(f"[{phase}] the walk depends on its group: "
                             f"{rows}")
    return rows


def record_walks(geom):
    """Wrap ``geom.traverse`` to record each call's rays and any-hit flag;
    returns the list (del geom.traverse restores the method)."""
    calls = []
    traced = geom.traverse

    def record(o, d, t_max, any_hit=False):
        calls.append((o, d, t_max.clone(), any_hit))
        return traced(o, d, t_max, any_hit)

    geom.traverse = record
    return calls


def sppm_iterations(phase, t0, card, integ, scene, acc, n, walk=False,
                    states=None):
    """``n`` SPPM iterations (the first warm), each with its phases' ms
    and its sweep and prologue launches and chunks skipped; with ``walk``
    (a BVH walk accelerator) its walk launches instead, and no sweep;
    with a list ``states``, each iteration's state appended to it."""
    import torch
    from trace_tpu_torch.integrators import sppm as SP
    from trace_tpu_torch.ops.bvh_walk import walk_kernel
    from trace_tpu_torch.ops.sweep import block_entry_kernel, sweep_kernel
    from trace_tpu_torch.sampler import uniform as U

    dev = scene.device
    marks = []
    time_phases(integ, marks)
    pixels = integ._pixel_grid(dev)
    key = U.key(integ.seed, dev)
    cdf, pmf = integ.light_distribution(scene)
    state = SP.initial_state(integ.n_pixels, integ.initial_search_radius,
                             dev)
    rows = []
    try:
        for it in range(1, n + 1):
            marks.clear()
            sweep_kernel.reset_counts()
            block_entry_kernel.reset_counts()
            walk_kernel.reset_counts()
            acc.skipped_chunks = 0
            a = torch.cuda.Event(enable_timing=True)
            a.record()
            state = integ.step(scene, state, it, pixels, key, cdf, pmf)
            z = torch.cuda.Event(enable_timing=True)
            z.record()
            torch.cuda.synchronize()
            if states is not None:
                states.append(state)
            row = dict(iteration=it, ms=a.elapsed_time(z),
                       sweep_launches=sweep_kernel.launches,
                       f32_launches=sweep_kernel.arm_launches["f32"],
                       entry_launches=block_entry_kernel.launches,
                       skipped_chunks=acc.skipped_chunks,
                       walk_launches=walk_kernel.launches)
            prev = a
            for name, ev in marks:
                row[f"{name}_ms"] = prev.elapsed_time(ev)
                prev = ev
            rows.append(row)
            log(phase, t0, f"iteration {it}{' (warm)' if it == 1 else ''}: "
                f"{row['ms']:.2f} ms; " + ", ".join(
                    f"{nm.strip('_')} {row[nm.strip('_') + '_ms']:.2f}"
                    for nm in SPPM_PHASES) + f" ms; sweep launches "
                f"{row['sweep_launches']}, prologue {row['entry_launches']}"
                f", chunks skipped {row['skipped_chunks']}, walk launches "
                f"{row['walk_launches']}; card {card}")
            if walk:
                if row["walk_launches"] <= 0 or row["sweep_launches"] \
                        or row["entry_launches"]:
                    raise AssertionError(f"[{phase}] the SPPM iteration did "
                                         f"not run the walk alone: {row}")
            elif row["sweep_launches"] <= 0 or row["f32_launches"] != \
                    row["sweep_launches"] or row["entry_launches"] != \
                    row["sweep_launches"] or row["walk_launches"]:
                raise AssertionError(f"[{phase}] the SPPM iteration did not "
                                     f"run the kernels: {row}")
    finally:
        for name in SPPM_PHASES:
            delattr(integ, name)
    return rows, state


def slice9(dev, card, t_all):
    """Phase 9: instanced geometry (module docstring)."""
    import torch
    from trace_tpu_torch.integrators.path import PathIntegrator
    from trace_tpu_torch.integrators.sppm import SPPMIntegrator
    WhittedIntegrator = eager_whitted
    from trace_tpu_torch.models import sphere_field
    from trace_tpu_torch.ops.sweep import block_entry_kernel, sweep_kernel
    from trace_tpu_torch.sampler import uniform as U
    from trace_tpu_torch.wavefront import whitted as WF

    tmp = tempfile.gettempdir()
    out = {}
    # -- 9a: the golden, the pairs against their flattened twins ----------
    t0 = time.perf_counter()
    sf6 = sphere_field.build_scene(6, device=dev)
    cam = sphere_field.build_camera(32, os.path.join(tmp, "unused.png"))
    integ = WhittedIntegrator(cam, U.UniformSampler(1, seed=0), max_depth=2,
                              pixel_chunk=ONE_CHUNK)
    img = image(integ, integ.render(sf6))
    golden = np.load(INST_GOLDEN)
    mse = float(np.mean((img - golden) ** 2))
    out["golden_sphere_field6_32"] = dict(mse=mse, max_abs=float(
        np.abs(img - golden).max()))
    log("9a", t0, f"golden sphere_field6_32: MSE {mse:.3e} (gate "
        f"{MSE_GATE}), max abs {out['golden_sphere_field6_32']['max_abs']:.3e}")
    if not (img.shape == golden.shape and np.isfinite(img).all()
            and mse < MSE_GATE):
        raise AssertionError(f"golden mismatch (sphere_field6_32): {mse}")
    for label, mesh in (("tetra", tetra_mesh()), ("grid", grid_mesh())):
        sweep_kernel.reset_counts()
        inst, flat = pair_scenes(mesh, dev)
        img_i = pair_image(inst)
        launches = sweep_kernel.launches
        img_f = pair_image(flat)
        mse = float(np.mean((img_i - img_f) ** 2))
        out[f"pair_{label}"] = dict(mse=mse, inst_sweep_launches=launches)
        log("9a", t0, f"{label} pair, Whitted 24^2: instanced vs flattened "
            f"MSE {mse:.3e} (gate {FLAT_GATE}); the instanced frame's sweep "
            f"launches {launches}")
        if not (np.isfinite(img_i).all() and img_i.max() > 0.01
                and mse < FLAT_GATE) or (label == "grid") != (launches > 0):
            raise AssertionError(f"{label} pair: {out[f'pair_{label}']}")
    # The grid pair's closest hits on the card against the port on the CPU.
    inst_cpu = pair_scenes(grid_mesh(), "cpu")[0]
    o, d = probe_rays(4096, 0, dev)
    tm = torch.full((4096,), float("inf"), device=dev)
    sweep_kernel.reset_counts()
    hc = WF.closest_hit(inst, o, d, tm, torch.zeros_like(tm))
    launches = sweep_kernel.launches
    cpu = lambda v: type(v)(*[x.cpu() for x in v])
    hh = WF.closest_hit(inst_cpu, cpu(o), cpu(d), tm.cpu(),
                        torch.zeros(4096))
    vc, vh = hc.valid.cpu(), hh.valid
    rel = float(((hc.t.cpu() - hh.t).abs() / hh.t.abs())[vh].max())
    out["grid_pair_card_vs_cpu"] = dict(
        hits=int(vh.sum()), mask_mismatch=int((vc != vh).sum()),
        t_max_rel=rel, prim_mismatch=int((hc.prim_id.cpu() != hh.prim_id)[
            vh].sum()), sweep_launches=launches)
    log("9a", t0, f"grid pair, 4096 probe rays: closest hits on the card vs "
        f"the CPU {out['grid_pair_card_vs_cpu']} (t gate 1e-6 relative)")
    if (vc != vh).any() or rel > 1e-6 or launches <= 0:
        raise AssertionError(f"grid pair card vs CPU: "
                             f"{out['grid_pair_card_vs_cpu']}")
    del sf6, inst, flat, inst_cpu

    # -- 9b: sphere_field_512 -------------------------------------------------
    t0 = time.perf_counter()
    field = sphere_field.build_scene(device=dev)
    geom = field.instanced[0]
    png = os.path.join(tmp, "chip_smoke_sphere_field_512.png")
    cam = sphere_field.build_camera(512, png)
    integ = WhittedIntegrator(cam, U.UniformSampler(4, seed=0), max_depth=3,
                              pixel_chunk=ONE_CHUNK)
    walks = record_walks(geom)
    integ.render(field)
    del geom.traverse
    groups = walk_groups("9b", t0, card, geom, *walks[0][:3])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sweep_kernel.reset_counts()
    times, state = timed_frames(integ, field)
    peak = torch.cuda.max_memory_allocated() / 2**30
    geom.groups_visited = 0
    walks = record_walks(geom)
    state = integ.render(field)
    del geom.traverse
    img = image(integ, state)
    cam.film.save_png(state)
    calls = [dict(rays=int(o.x.shape[0]), live=int((t >= 0).sum()),
                  any_hit=a) for o, _, t, a in walks]
    busy = NOT_PROFILED
    out["sphere_field_512"] = dict(
        frame_ms=times, ms=float(np.mean(times)), peak_gib=peak,
        useful_rays=integ.last_useful_rays, walk_calls=calls,
        groups_visited=geom.groups_visited,
        groups_per_call=geom.groups_visited / max(len(calls), 1),
        group_sizes=groups, busy=busy,
        sweep_launches=sweep_kernel.launches)
    log("9b", t0, f"sphere_field 512^2, Whitted, 4 spp, depth 3, 1024 "
        f"instances: frames {[round(x, 2) for x in times]} ms, mean "
        f"{np.mean(times):.2f}; useful rays {integ.last_useful_rays} "
        f"({integ.last_useful_rays / np.mean(times) / 1e3:.3f} Mrays/s); "
        f"peak {peak:.3f} GiB; {len(calls)} walk calls {calls}, instance "
        f"groups visited {geom.groups_visited}; sweep launches "
        f"{sweep_kernel.launches}; PNG {png}; card {card}")
    if not (np.isfinite(img).all() and img.max() > 0.02
            and sweep_kernel.launches == 0):
        raise AssertionError(f"sphere_field 512: {out['sphere_field_512']}")
    del field, geom, walks, state
    torch.cuda.empty_cache()

    # -- 9c: inst100_standin_whitted_256, the mesh path ----------------------
    t0 = time.perf_counter()
    scene = standin_scene(dev, 10)
    geom = scene.instanced[0]
    acc = geom.accel
    build_s = time.perf_counter() - t0
    png = os.path.join(tmp, "chip_smoke_inst100.png")
    integ = WhittedIntegrator(standin_camera(256, png),
                              U.UniformSampler(1, seed=0), max_depth=2,
                              pixel_chunk=ONE_CHUNK)
    sweep_kernel.reset_counts()
    block_entry_kernel.reset_counts()
    acc.skipped_chunks = 0
    geom.groups_visited = 0
    walks = record_walks(geom)
    state, calls, accs = record_sweep_calls(integ.render, scene)
    del geom.traverse
    launches = dict(sweep=sweep_kernel.launches,
                    f32=sweep_kernel.arm_launches["f32"],
                    prologue=block_entry_kernel.launches,
                    skipped=acc.skipped_chunks,
                    sweep_calls=len(calls), walk_calls=len(walks),
                    groups_visited=geom.groups_visited)
    integ.camera.film.save_png(state)
    img = image(integ, state)
    if launches["sweep"] <= 0 or launches["f32"] != launches["sweep"] or \
            launches["prologue"] != launches["sweep"] or \
            any(a is not acc for a in accs):
        raise AssertionError(f"the instanced frame did not run the "
                             f"kernels: {launches}")
    agree, pro, _ = check_launches("9c", acc, calls)
    del calls, accs
    groups = walk_groups("9c", t0, card, geom, *walks[0][:3])
    del walks
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times, _ = timed_frames(integ, scene)
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_copy = (acc.panel.numel() * acc.panel.element_size()
                + acc.slot_to_tri.numel() * 4 + geom.base_rows.numel() * 4)
    flat_gib = geom.n_instances * per_copy / 2**30
    busy = device_busy("9c", t0, card, "frame", lambda: integ.render(scene),
                       np.mean(times))
    out["inst100_whitted_256"] = dict(
        n_base=geom.n_base, n_instances=geom.n_instances,
        swaps=int(geom.table.swaps.sum()), build_s=build_s,
        launches=launches, agreement=agree, prologue=pro, frame_ms=times,
        ms=float(np.mean(times)), peak_gib=peak,
        flattened_tables_gib=flat_gib, group_sizes=groups, busy=busy,
        useful_rays=integ.last_useful_rays)
    log("9c", t0, f"{geom.n_instances} stand-ins of {geom.n_base} triangles "
        f"({geom.n_instances * geom.n_base} instanced, "
        f"{int(geom.table.swaps.sum())} mirrored), Whitted 256^2 depth 2: "
        f"launches {launches}; every launch equal to sweep_plain with the "
        f"same steps ({sum(t.get('launches', 0) for t in agree.values())} "
        f"checked), prologue bit-equal ({pro}); frames "
        f"{[round(x, 2) for x in times]} ms (mean {np.mean(times):.2f}); "
        f"peak {peak:.3f} GiB against {flat_gib:.3f} GiB of sweep tables and "
        f"rows flattened; kernels a frame {busy['kernels']}, device busy "
        f"{100 * busy['share']:.1f}%; non-zero pixels "
        f"{float((img > 0).any(-1).mean()):.3f}; PNG {png}; card {card}")
    if not (np.isfinite(img).all() and geom.table.swaps.sum() == 2):
        raise AssertionError("the instanced stand-in frame")
    # A 3 x 3 grid of the stand-in, instanced against flattened, at 64^2.
    small = standin_scene(dev, 3)
    flat = standin_scene(dev, 3, flat=True)
    ims = []
    for sc in (small, flat):
        it = WhittedIntegrator(standin_camera(64, os.path.join(
            tmp, "unused.png"), 3), U.UniformSampler(1, seed=0), max_depth=2,
                               pixel_chunk=ONE_CHUNK)
        ims.append(image(it, it.render(sc)))
    mse = float(np.mean((ims[0] - ims[1]) ** 2))
    o, d, tm = camera_rays(standin_camera(64, "unused.png", 3), dev)
    zero = torch.zeros_like(tm)
    hi, hf = (WF.closest_hit(sc, o, d, tm, zero) for sc in (small, flat))
    both = hi.valid & hf.valid
    out["flat_3x3_64"] = dict(
        n_flat=flat.n_triangles, mse=mse,
        mask_mismatch=int((hi.valid != hf.valid).sum()), hits=int(both.sum()),
        t_max_rel=float(((hi.t - hf.t).abs() / hf.t)[both].max()))
    log("9c", t0, f"3 x 3 stand-ins, 64^2: instanced vs flattened "
        f"({flat.n_triangles} triangles) {out['flat_3x3_64']} (MSE gate "
        f"{MSE_GATE}, hit masks within 1% of the camera rays)")
    if not (mse < MSE_GATE and out["flat_3x3_64"]["mask_mismatch"]
            <= 0.01 * tm.numel() and both.sum() > 0.1 * tm.numel()):
        raise AssertionError(f"3 x 3 stand-ins: {out['flat_3x3_64']}")
    del small, flat, hi, hf
    torch.cuda.empty_cache()

    # -- 9d: the path tracer and SPPM on 9c's scene -------------------------
    t0 = time.perf_counter()
    png = os.path.join(tmp, "chip_smoke_inst100_path.png")
    integ = PathIntegrator(standin_camera(256, png),
                           U.UniformSampler(1, seed=0), max_depth=3,
                           pixel_chunk=ONE_CHUNK)
    sweep_kernel.reset_counts()
    times, state = timed_frames(integ, scene)
    img = image(integ, state)
    integ.camera.film.save_png(state)
    out["inst100_path_256"] = dict(frame_ms=times, ms=float(np.mean(times)),
                                   sweep_launches_4_frames=sweep_kernel
                                   .launches,
                                   useful_rays=integ.last_useful_rays)
    log("9d", t0, f"path tracer 256^2, 1 spp, depth 3: frames "
        f"{[round(x, 2) for x in times]} ms (mean {np.mean(times):.2f}); "
        f"useful rays {integ.last_useful_rays}; sweep launches in 4 frames "
        f"{sweep_kernel.launches}; PNG {png}; card {card}")
    if not (np.isfinite(img).all() and img.max() > 0.0
            and sweep_kernel.launches > 0):
        raise AssertionError(f"instanced path frame: "
                             f"{out['inst100_path_256']}")
    png = os.path.join(tmp, "chip_smoke_inst100_sppm.png")
    integ = SPPMIntegrator(standin_camera(256, png),
                           initial_search_radius=0.3, max_depth=5,
                           n_iterations=3, photons_per_iteration=65536,
                           seed=0, device=dev)
    integ.check_scene(scene)
    torch.cuda.reset_peak_memory_stats()
    rows, state = sppm_iterations("9d", t0, card, integ, scene, acc, 3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    img = integ.to_image(state, 3)
    gathered = int((state.tau.sum(-1) > 0).sum())
    finite = bool(torch.isfinite(img).all())
    integ.save(state, 3)
    out["inst100_sppm_256"] = dict(iterations=rows, peak_gib=peak,
                                   pixels_gathered=gathered)
    log("9d", t0, f"SPPM 256^2, 65536 photons, depth 5, r0 0.3: iterations "
        f"{[round(r['ms'], 2) for r in rows]} ms (the first warm); peak "
        f"{peak:.3f} GiB; pixels with tau > 0 {gathered}; finite {finite}; "
        f"PNG {png}; card {card}")
    if not finite or gathered <= 0:
        raise AssertionError(f"instanced SPPM image: finite {finite}, "
                             f"pixels with tau > 0 {gathered}")
    log(9, t0, f"whole run so far {time.perf_counter() - t_all:.1f} s")
    return out


DRYRUN_GOLDENS = {k: os.path.join(REPO, "tests", "goldens", f"{k}.npy")
                  for k in ("dryrun16_whitted", "dryrun16_path",
                            "dryrun16_sppm", "dryrun32_tex_whitted")}
DRYRUN_SPPM = dict(initial_search_radius=0.2, max_depth=2, n_iterations=1,
                   photons_per_iteration=1024)
TEX_SEED = 7


def port_modules():
    """The port's modules that dryrun_builder and dryrun_camera read."""
    from types import SimpleNamespace

    from trace_tpu_torch.camera.perspective import PerspectiveCamera
    from trace_tpu_torch.core import transform
    from trace_tpu_torch.film.film import Film
    from trace_tpu_torch.film.filters import LanczosSincFilter
    from trace_tpu_torch.lights import lights
    from trace_tpu_torch.materials import materials, textures
    from trace_tpu_torch.models.env_studio import sky_image
    from trace_tpu_torch.scene import SceneBuilder

    return SimpleNamespace(
        T=transform, L=lights, M=materials, TX=textures,
        SceneBuilder=SceneBuilder, sky_image=sky_image, Film=Film,
        LanczosSincFilter=LanczosSincFilter,
        PerspectiveCamera=PerspectiveCamera)


def floor_image(seed=TEX_SEED, n=16) -> np.ndarray:
    """The seeded [n, n, 3] uint8 image of the textured floor."""
    return np.random.default_rng(seed).integers(0, 256, (n, n, 3), np.uint8)


def dryrun_builder(ns, textured=False):
    """__graft_entry__.py's _dryrun_scene (flat spheres and triangles, an
    instanced tetrahedron mesh, instanced spheres, a point, an area and an
    environment light) as a SceneBuilder of the package whose modules
    ``ns`` holds (port_modules(), or the JAX package's twins in the
    tests). ``textured``: the floor's Kd is a mip-mapped image (floor_image,
    sRGB, repeat) through a UV mapping scaled by 3, and the red sphere's
    Kd mixes red and blue by a bilinear ramp over its u."""
    T, L, M, TX = ns.T, ns.L, ns.M, ns.TX
    b = ns.SceneBuilder()
    grey = b.material(M.MatteMaterial(Kd=(0.6, 0.6, 0.6)))
    red = b.material(M.MatteMaterial(Kd=(0.7, 0.25, 0.2)))
    mirror = b.material(M.MirrorMaterial(Kr=(0.9, 0.9, 0.9)))
    floor, ball = grey, red
    if textured:
        floor = b.material(M.MatteMaterial(Kd=TX.ImageTexture(
            TX.UVMapping2D(3.0, 3.0), TX.MipMap(floor_image(), wrap="repeat",
                                                gamma=True))))
        ball = b.material(M.MatteMaterial(Kd=TX.MixTexture(
            TX.ConstantTexture((0.7, 0.25, 0.2)),
            TX.ConstantTexture((0.2, 0.3, 0.8)),
            TX.BilerpTexture(TX.UVMapping2D(), 0.0, 0.0, 1.0, 1.0))))
    b.sphere(T.translate([0.4, 0.3, -2.4]), 0.3, mirror)
    b.sphere(T.translate([-0.5, 0.25, -2.2]), 0.25, ball)
    quad = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)
    fv = np.array([[-3, 0, 1], [3, 0, 1], [3, 0, -6], [-3, 0, -6]],
                  np.float32)
    b.triangle_mesh(T.identity(), quad, fv, floor)
    lv = np.array([[-0.8, 2.5, -2.0], [0.8, 2.5, -2.0],
                   [0.8, 2.5, -3.4], [-0.8, 2.5, -3.4]], np.float32)
    b.triangle_mesh(T.identity(), quad, lv, grey, emission=(6.0, 6.0, 6.0))
    tv = np.array([[0, 0, 0], [0.5, 0, 0], [0, 0.5, 0], [0, 0, 0.5]],
                  np.float32)
    ti = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]], np.uint32)
    b.instanced_mesh(ti, tv, [T.translate([-1.2, 0.0, -3.0]),
                              T.compose(T.translate([1.2, 0.0, -3.2]),
                                        T.rotate_y(35.0))], red)
    b.instanced_spheres(
        [dict(object_to_world=T.identity(), radius=0.2, material_id=grey)],
        [T.translate([0.0, 0.2, -1.6]), T.translate([-1.4, 0.2, -2.6])])
    b.light(L.point_light(T.translate([0.0, 2.0, 0.0]), (8.0, 8.0, 8.0)))
    b.light(L.infinite_light(image=ns.sky_image(16, 32)))
    return b


def dryrun_camera(ns, res, filename="unused.png"):
    """__graft_entry__.py's _dryrun_camera: pbrt convention, Lanczos."""
    film = ns.Film((res, res), filter=ns.LanczosSincFilter((1.0, 1.0), 3.0),
                   filename=filename)
    return ns.PerspectiveCamera(
        ns.T.look_at([0.0, 0.8, 2.5], [0.0, 0.2, -2.5], [0.0, 1.0, 0.0]),
        film=film, convention="pbrt")


def texture_lanes(dev, n, seed=0):
    """Trilinear lookups of floor_image's mip pyramid (repeat wrap, sRGB)
    on ``n`` seeded lanes whose footprints span every level, on ``dev``
    -> (values [n, 3], level floor [n], level-0 texel index [n] at that
    level)."""
    import torch
    from trace_tpu_torch.materials.textures import MipMap

    rng = np.random.default_rng(seed)
    st = rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    dx = (rng.choice([-1.0, 1.0], (n, 2)) * 2.0 ** rng.uniform(
        -9.0, 0.5, (n, 1))).astype(np.float32)
    dy = (dx * rng.uniform(0.0, 1.0, (n, 2))).astype(np.float32)
    mip = MipMap(floor_image(), wrap="repeat", gamma=True)
    st, dx, dy = (torch.from_numpy(a).to(dev) for a in (st, dx, dy))
    lvl = torch.floor(mip.level(dx, dy))
    dims = mip.tables(dev)[0][lvl.long()]
    x0 = torch.floor(st[:, 0] * dims[:, 1] - 0.5)
    y0 = torch.floor(st[:, 1] * dims[:, 0] - 0.5)
    return mip.lookup(st, dx, dy), lvl, y0 * dims[:, 1] + x0


def terrain_image(n=256) -> np.ndarray:
    """A procedural [n, n, 3] uint8 image: a checker of 8 x 8 tiles under
    diagonal colour bands."""
    y, x = np.mgrid[0:n, 0:n].astype(np.float32) / n
    check = ((np.floor(x * 8) + np.floor(y * 8)) % 2)[..., None]
    bands = 0.5 + 0.5 * np.sin(2 * np.pi * (x + 2 * y)[..., None]
                               * 3.0 + np.array([0.0, 2.1, 4.2]))
    img = 0.25 + 0.45 * check * bands + 0.2 * (1 - check)
    return (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)


# The emissive quad of phase 10b: 2 x 2, facing down, 5 above the terrain's
# centre; its radiance gives it 0.75 of the point light's power (L A pi
# against 4 pi I).
QUAD_RADIANCE = 300.0
QUAD_Y = 5.0


def lights3_scene(dev, png):
    """The 1M mesh_heavy terrain, its glass sphere, mesh_point(), mesh_sky()
    and an emissive quad, the terrain's Kd an ImageTexture of
    terrain_image() written as a PNG, read back and mapped from world
    (x, z) to (s, t) (one tile every 4 units, repeat, sRGB) -> (Scene,
    seconds to build, whether the PNG read back equal)."""
    from trace_tpu_torch.core import transform as T
    from trace_tpu_torch.io.png import read_png, write_png
    from trace_tpu_torch.materials import textures as TX
    from trace_tpu_torch.materials.materials import (GlassMaterial,
                                                     MatteMaterial)
    from trace_tpu_torch.models import mesh_heavy
    from trace_tpu_torch.scene import SceneBuilder

    t0 = time.perf_counter()
    img = terrain_image()
    write_png(png, img)
    back = read_png(png)
    w2t = T.from_matrix(np.array([[0.25, 0, 0, 0], [0, 0, 0.25, 0],
                                  [0, 1, 0, 0], [0, 0, 0, 1]], np.float32))
    tex = TX.ImageTexture(TX.TransformMapping3D(w2t),
                          TX.MipMap(back, wrap="repeat", gamma=True))
    verts, tris = mesh_heavy.heightfield(int(np.sqrt(1_000_000 / 2)) + 1)
    b = SceneBuilder()
    ground = b.material(MatteMaterial(Kd=tex, sigma=20.0))
    glass = b.material(GlassMaterial(index=1.5))
    b.triangle_mesh(T.identity(), tris, verts, ground)
    b.sphere(T.translate([0.0, 2.0, 0.0]), 1.0, glass)
    b.triangle_mesh(T.identity(), np.array([[0, 1, 2], [0, 2, 3]],
                                           np.uint32),
                    np.array([[-1, QUAD_Y, -1], [-1, QUAD_Y, 1],
                              [1, QUAD_Y, 1], [1, QUAD_Y, -1]], np.float32),
                    ground, emission=(QUAD_RADIANCE,) * 3)
    b.light(mesh_point())
    b.light(mesh_sky())
    scene = b.build(device=dev)
    return scene, time.perf_counter() - t0, bool(np.array_equal(back, img))


def count_emitted(photons):
    """Wrap the photon walk's per-lane emission so each call adds its
    lanes' light picks to ``photons`` (a list of bincounts); returns the
    undo."""
    import torch
    from trace_tpu_torch.wavefront import lights as WL

    traced = WL.sample_le_lanes

    def counted(scene, idx, *a):
        photons.append(torch.bincount(idx.long(), minlength=int(
            scene.lights.kind.shape[0])).cpu())
        return traced(scene, idx, *a)

    WL.sample_le_lanes = counted
    return lambda: setattr(WL, "sample_le_lanes", traced)


def shading_kernels(dev, n=65536):
    """Kernels the card runs for one compute_scattering call on ``n``
    shading lanes of a matte (sigma 20) whose Kd is a constant, and whose
    Kd is lights3_scene's image texture (torch.profiler) -> (constant,
    image)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from trace_tpu_torch.core import transform as T
    from trace_tpu_torch.core.vec import V3
    from trace_tpu_torch.materials import textures as TX
    from trace_tpu_torch.materials.materials import MatteMaterial
    from trace_tpu_torch.wavefront import geom as G
    from trace_tpu_torch.wavefront import materials as WM

    g = torch.Generator(device=dev).manual_seed(0)
    f = lambda: torch.rand(n, device=dev, generator=g) * 8.0 - 4.0
    v3 = lambda: V3(f(), f(), f())
    vecs = {"p", "wo", "n", "dpdu", "dpdv", "ns", "s_dpdu", "s_dpdv",
            "s_dndu", "s_dndv", "dpdx", "dpdy"}
    hit = G.HitP(**{k: v3() if k in vecs else f() for k in G.HitP._fields})
    hit = hit._replace(valid=torch.ones(n, dtype=torch.bool, device=dev),
                       material_id=torch.zeros(n, dtype=torch.int32,
                                               device=dev))
    w2t = T.from_matrix(np.array([[0.25, 0, 0, 0], [0, 0, 0.25, 0],
                                  [0, 1, 0, 0], [0, 0, 0, 1]], np.float32))
    tex = TX.ImageTexture(TX.TransformMapping3D(w2t),
                          TX.MipMap(terrain_image(), wrap="repeat",
                                    gamma=True))
    counts = []
    for kd in ((0.55, 0.5, 0.4), tex):
        mats = [MatteMaterial(Kd=kd, sigma=20.0)]
        TX.upload(mats, dev)
        WM.compute_scattering(mats, hit)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            WM.compute_scattering(mats, hit)
            torch.cuda.synchronize()
        counts.append(int(sum(e.count for e in prof.key_averages()
                              if e.device_type == DeviceType.CUDA)))
    return tuple(counts)


def slice10(dev, card, t_all):
    """Phase 10: several lights of any kind in one scene, and image
    textures (module docstring)."""
    import torch
    from trace_tpu_torch.integrators import sppm as SP
    from trace_tpu_torch.integrators.path import PathIntegrator
    from trace_tpu_torch.integrators.sppm import SPPMIntegrator
    WhittedIntegrator = eager_whitted
    from trace_tpu_torch.models import mesh_heavy
    from trace_tpu_torch.ops.sweep import block_entry_kernel, sweep_kernel
    from trace_tpu_torch.sampler import uniform as U

    tmp = tempfile.gettempdir()
    out = {}
    # -- 10a: the dryrun goldens, the texture lookup card vs CPU ------------
    t0 = time.perf_counter()
    ns = port_modules()
    for name, path in sorted(DRYRUN_GOLDENS.items()):
        textured = "tex" in name
        sc = dryrun_builder(ns, textured=textured).build(device=dev)
        cam = dryrun_camera(ns, 32 if textured else 16)
        if name.endswith("sppm"):
            integ = SPPMIntegrator(cam, device=dev, **DRYRUN_SPPM)
            img = integ.to_image(integ.render(sc), 1).cpu().numpy()
        else:
            cls = PathIntegrator if name.endswith("path") \
                else WhittedIntegrator
            integ = cls(cam, U.UniformSampler(1, seed=0), max_depth=2)
            img = image(integ, integ.render(sc))
        golden = np.load(path)
        mse = float(np.mean((img - golden) ** 2))
        off = int((np.abs(img - golden).max(-1) > 1e-3).sum())
        out[f"golden_{name}"] = dict(mse=mse, pixels_off=off)
        log("10a", t0, f"golden {name}: MSE {mse:.3e} (gate {MSE_GATE}), "
            f"pixels off by > 1e-3: {off}")
        if not (img.shape == golden.shape and np.isfinite(img).all()
                and mse < MSE_GATE):
            raise AssertionError(f"golden mismatch ({name}): {mse}")
    n = 65536
    vc, lc, xc = texture_lanes(dev, n)
    vh, lh, xh = texture_lanes(torch.device("cpu"), n)
    flips = (lc.cpu() != lh) | (xc.cpu() != xh)
    err = float((vc.cpu() - vh).abs().max(-1).values[~flips].max())
    out["texture_lanes"] = dict(lanes=n, flips=int(flips.sum()),
                                max_abs=err, levels=int(lh.unique().numel()))
    log("10a", t0, f"texture lookups on {n} lanes, card vs CPU: "
        f"{out['texture_lanes']} (gates: max abs 1e-6, flips 1 in 1000)")
    if err > 1e-6 or int(flips.sum()) > n // 1000:
        raise AssertionError(f"texture lookup: {out['texture_lanes']}")

    # -- 10b: the 1M terrain, three lights, textured -------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    scene, build_s, png_equal = lights3_scene(
        dev, os.path.join(tmp, "chip_smoke_terrain_texture.png"))
    acc = scene.accel
    kinds = [int(k) for k in scene.lights.kind]
    png = os.path.join(tmp, "chip_smoke_lights3_sppm.png")
    sppm = SPPMIntegrator(mesh_heavy.build_camera(256, png),
                          initial_search_radius=0.3, max_depth=5,
                          n_iterations=3, photons_per_iteration=65536,
                          seed=0, device=dev)
    sppm.check_scene(scene)
    cdf, pmf_t = sppm.light_distribution(scene)
    pmf = pmf_t.cpu().numpy()
    log("10b", t0, f"scene built in {build_s:.2f} s: {scene.n_triangles} "
        f"triangles, lights {kinds}, power pmf {pmf.tolist()}; the texture "
        f"PNG read back equal {png_equal}")
    if not png_equal or pmf.min() <= 0:
        raise AssertionError("the lights3 scene")
    runs = {}
    for label, integ in (
            ("mesh1m_whitted_256_lights3", WhittedIntegrator(
                mesh_heavy.build_camera(256, os.path.join(
                    tmp, "chip_smoke_lights3_whitted.png")),
                U.UniformSampler(1, seed=0), max_depth=2,
                pixel_chunk=ONE_CHUNK)),
            ("mesh1m_path_256_lights3", PathIntegrator(
                mesh_heavy.build_camera(256, os.path.join(
                    tmp, "chip_smoke_lights3_path.png")),
                U.UniformSampler(1, seed=0), max_depth=3,
                pixel_chunk=ONE_CHUNK))):
        sweep_kernel.reset_counts()
        block_entry_kernel.reset_counts()
        acc.skipped_chunks = 0
        state, calls, _ = record_sweep_calls(integ.render, scene)
        launches = dict(sweep=sweep_kernel.launches,
                        f32=sweep_kernel.arm_launches["f32"],
                        prologue=block_entry_kernel.launches,
                        skipped=acc.skipped_chunks, sweep_calls=len(calls))
        integ.camera.film.save_png(state)
        img = image(integ, state)
        pattern = [a for *_, a in calls]
        if launches["sweep"] <= 0 or launches["f32"] != launches["sweep"] \
                or launches["prologue"] != launches["sweep"]:
            raise AssertionError(f"{label} did not run the kernels: "
                                 f"{launches}")
        if label.startswith("mesh1m_path") and pattern != \
                [False, True, False] * integ.max_depth:
            raise AssertionError(f"{label}: sweep calls {pattern}, not one "
                                 f"closest hit, one shadow and one BSDF "
                                 f"call a bounce")
        agree, pro, _ = check_launches("10b", acc, calls)
        del calls
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times, _ = timed_frames(integ, scene)
        row = dict(launches=launches, sweep_call_pattern=pattern,
                   sweep_calls_per_bounce=len(pattern) / integ.max_depth,
                   agreement=agree, prologue=pro, frame_ms=times,
                   ms=float(np.mean(times)),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   useful_rays=integ.last_useful_rays,
                   nonzero=float((img > 0).any(-1).mean()))
        runs[label] = row
        log("10b", t0, f"{label}: launches {launches} (sweep calls "
            f"{pattern}, {row['sweep_calls_per_bounce']:.2f} a bounce); "
            f"every launch equal to sweep_plain with the same steps "
            f"({sum(t.get('launches', 0) for t in agree.values())} "
            f"checked), prologue bit-equal ({pro}); frames "
            f"{[round(x, 2) for x in times]} ms (mean {row['ms']:.2f}); "
            f"peak {row['peak_gib']:.3f} GiB; useful rays "
            f"{row['useful_rays']}"
            + (f"; device busy {100 * row['busy']['share']:.1f}%"
               if "busy" in row else "")
            + f"; non-zero pixels {row['nonzero']:.3f}; card {card}")
        if not (np.isfinite(img).all() and row["nonzero"] > 0.05):
            raise AssertionError(f"{label}: the frame")
    # SPPM: one iteration's launches against plain, the photons each light
    # emitted against the power pmf, then one warm iteration and two timed.
    integ = sppm
    key = U.key(integ.seed, dev)
    pixels = integ._pixel_grid(dev)
    state = SP.initial_state(integ.n_pixels, integ.initial_search_radius,
                             dev)
    photons = []
    undo = count_emitted(photons)
    try:
        _, calls, _ = record_sweep_calls(integ.step, scene, state, 1, pixels,
                                         key, cdf, pmf_t)
    finally:
        undo()
    agree, pro, _ = check_launches("10b", acc, calls)
    emitted = torch.stack(photons).sum(0).numpy()
    share = emitted / emitted.sum()
    del calls
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rows, state = sppm_iterations("10b", t0, card, integ, scene, acc, 3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    img = integ.to_image(state, 3)
    gathered = int((state.tau.sum(-1) > 0).sum())
    finite = bool(torch.isfinite(img).all())
    integ.save(state, 3)
    runs["mesh1m_sppm_256_lights3"] = dict(
        iterations=rows, peak_gib=peak, pixels_gathered=gathered,
        agreement=agree, prologue=pro, photons_per_light=emitted.tolist(),
        share=share.tolist(), pmf=pmf.tolist())
    log("10b", t0, f"mesh1m_sppm_256_lights3: iterations "
        f"{[round(r['ms'], 2) for r in rows]} ms (the first warm); one "
        f"iteration's launches equal to sweep_plain "
        f"({sum(t.get('launches', 0) for t in agree.values())} checked), "
        f"prologue bit-equal ({pro}); photons per light {emitted.tolist()}"
        f" ({[round(float(x), 4) for x in share]} against the power pmf "
        f"{[round(float(x), 4) for x in pmf]}, gate 2% absolute); peak "
        f"{peak:.3f} GiB; pixels with tau > 0 {gathered}; finite {finite}; "
        f"PNG {png}; card {card}")
    if not finite or gathered <= 0 or np.abs(share - pmf).max() > 0.02:
        raise AssertionError(f"lights3 SPPM: {runs['mesh1m_sppm_256_lights3']}")
    out.update(runs)
    const, img_k = shading_kernels(dev)
    out["shading_kernels"] = dict(constant=const, image=img_k)
    log("10b", t0, f"kernels of one compute_scattering call on 65536 lanes "
        f"(matte, sigma 20): Kd constant {const}, Kd the image texture "
        f"{img_k}; card {card}")
    log(10, t0, f"whole run so far {time.perf_counter() - t_all:.1f} s")
    return out


# The crop of phase 11b: the middle quarter of the 256^2 frame.
CROP = ((0.25, 0.25), (0.75, 0.75))
SPLAT_SAMPLES = 1 << 20


def film_like(cam, **kw):
    """``cam`` with its film replaced by a Film of the same resolution and
    file (the camera reads only the resolution)."""
    from trace_tpu_torch.film.film import Film

    cam.film = Film(cam.film.resolution, filename=cam.film.filename, **kw)
    return cam


def strata_gate(integ, dev):
    """Wrap ``integ``'s camera so each sample's p_film is checked against
    its stratum; returns (the per-sample results, undo)."""
    import torch

    cam, seen = integ.camera, []
    gen = cam.generate_ray_differentials
    pix = integ.pixel_grid(dev).to(torch.float32)
    xs, ys = integ.sampler.x_samples, integ.sampler.y_samples

    def check(p_film, u_lens, u_time):
        s = len(seen) % (xs * ys)
        sx, sy = s % xs, s // xs
        off = p_film - pix
        ok = ((off[:, 0] >= sx / xs) & (off[:, 0] <= (sx + 1) / xs)
              & (off[:, 1] >= sy / ys) & (off[:, 1] <= (sy + 1) / ys))
        seen.append(dict(sample=s, lanes=int(ok.numel()),
                         outside=int((~ok).sum())))
        return gen(p_film, u_lens, u_time)

    cam.generate_ray_differentials = check
    return seen, lambda: delattr(cam, "generate_ray_differentials")


def slice11(dev, card, scene, t_all):
    """Phase 11: the render loop's public surface (module docstring)."""
    import copy

    import torch
    from trace_tpu_torch import (BoxFilter, GaussianFilter, RenderStats,
                                 StratifiedSampler, TriangleFilter)
    from trace_tpu_torch.core import spectrum as spec
    from trace_tpu_torch.core.vec import V3
    from trace_tpu_torch.film.film import Film
    from trace_tpu_torch.io.png import write_png
    from trace_tpu_torch.models import mesh_heavy
    from trace_tpu_torch.ops import intersect as TI
    from trace_tpu_torch.ops.sweep import block_entry_kernel, sweep_kernel
    from trace_tpu_torch.sampler import uniform as U
    from trace_tpu_torch.utils.stats import trace_profile
    from trace_tpu_torch.wavefront import geom as WG

    # 11a's and 11b's frames count launches per render: eager ones.
    WhittedIntegrator = eager_whitted
    tmp = tempfile.gettempdir()
    acc = scene.accel
    out = {}

    def counts_zero():
        sweep_kernel.reset_counts()
        block_entry_kernel.reset_counts()
        TI.intersect_kernel.reset_counts()
        acc.skipped_chunks = 0

    def counts():
        return dict(sweep=sweep_kernel.launches,
                    f32=sweep_kernel.arm_launches["f32"],
                    prologue=block_entry_kernel.launches,
                    intersect=TI.intersect_kernel.launches,
                    skipped=acc.skipped_chunks)

    # -- 11a: stratified 1M Whitted -----------------------------------------
    t0 = time.perf_counter()
    stats = RenderStats()
    integ = WhittedIntegrator(
        mesh_heavy.build_camera(256, os.path.join(
            tmp, "chip_smoke_strat.png")),
        StratifiedSampler(2, 2, seed=0), max_depth=2, stats=stats,
                              pixel_chunk=ONE_CHUNK)
    strata, undo = strata_gate(integ, dev)
    counts_zero()
    try:
        state, calls, _ = record_sweep_calls(integ.render, scene)
    finally:
        undo()
    launches = counts()
    img = image(integ, state)
    integ.camera.film.save_png(state)
    outside = sum(r["outside"] for r in strata)
    if len(strata) != 4 or outside:
        raise AssertionError(f"11a: film samples outside their strata: "
                             f"{strata}")
    if launches["sweep"] <= 0 or launches["prologue"] != launches["sweep"] \
            or launches["f32"] != launches["sweep"]:
        raise AssertionError(f"11a did not run the kernels: {launches}")
    agree, pro, _ = check_launches("11a", acc, calls)
    n_calls = len(calls)
    del calls
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    integ.stats = None
    times, _ = timed_frames(integ, scene)
    peak = torch.cuda.max_memory_allocated() / 2**30
    nonzero = float((img > 0).any(-1).mean())
    busy = NOT_PROFILED
    out["mesh1m_whitted_256_strat2x2"] = dict(
        launches=launches, sweep_calls=n_calls, strata=strata,
        agreement=agree, prologue=pro, frame_ms=times,
        ms=float(np.mean(times)), peak_gib=peak, stats=stats.as_dict(),
        nonzero=nonzero, busy=busy)
    log("11a", t0, f"mesh1m_whitted_256_strat2x2 (StratifiedSampler(2, 2), "
        f"4 spp): every film sample in its stratum ({strata}); launches "
        f"{launches}, {n_calls} sweep calls, every launch equal to "
        f"sweep_plain with the same steps "
        f"({sum(t.get('launches', 0) for t in agree.values())} checked), "
        f"prologue bit-equal ({pro}); frames "
        f"{[round(x, 2) for x in times]} ms (mean "
        f"{float(np.mean(times)):.2f}); peak {peak:.3f} GiB; RenderStats "
        f"{stats.as_dict()}; non-zero pixels {nonzero:.3f}; card {card}")
    if not (np.isfinite(img).all() and nonzero > 0.05):
        raise AssertionError("11a: the frame")

    # -- 11b: crop and filters ----------------------------------------------
    t0 = time.perf_counter()
    frames = {}
    for label, kw in (
            ("gaussian_full", dict(filter=GaussianFilter((2.0, 2.0)))),
            ("gaussian_crop", dict(filter=GaussianFilter((2.0, 2.0)),
                                   crop=CROP)),
            ("box", dict(filter=BoxFilter((0.5, 0.5)))),
            ("triangle", dict(filter=TriangleFilter((2.0, 2.0))))):
        cam = film_like(mesh_heavy.build_camera(256, os.path.join(
            tmp, f"chip_smoke_{label}.png")), **kw)
        it = WhittedIntegrator(cam, U.UniformSampler(1, seed=0), max_depth=2,
                               pixel_chunk=ONE_CHUNK)
        counts_zero()
        state = it.render(scene)
        c = counts()
        img = cam.film.save_png(state)
        frames[label] = dict(film=cam.film, img=img, launches=c,
                             png=cam.film.filename)
        log("11b", t0, f"{label}: {img.shape[1]}x{img.shape[0]} pixels, "
            f"launches {c}, finite {bool(np.isfinite(img).all())}, max "
            f"{float(img.max()):.4f}")
        if not (np.isfinite(img).all() and img.max() > 0.05
                and c["sweep"] > 0 and c["prologue"] == c["sweep"]):
            raise AssertionError(f"11b {label}: the frame or its launches")
    film = frames["gaussian_crop"]["film"]
    (cx0, cy0), (cx1, cy1) = film.crop_min, film.crop_max
    window = frames["gaussian_full"]["img"][cy0 - 1:cy1, cx0 - 1:cx1]
    crop_img = frames["gaussian_crop"]["img"]
    diff = np.abs(crop_img - window)
    inner, ring = float(diff[1:-1, 1:-1].max()), float(diff.max())
    out["crop"] = dict(crop=CROP, crop_min=film.crop_min,
                       crop_max=film.crop_max, interior_max_abs=inner,
                       ring_max_abs=ring,
                       launches={k: v["launches"] for k, v in frames.items()})
    log("11b", t0, f"the {film.width}x{film.height} crop against the full "
        f"frame's window: interior max abs {inner:.3e} (gate 1e-6), outer "
        f"ring {ring:.3e} (the reference's footprint reaches one pixel past "
        f"the cropped film's sample bounds); card {card}")
    if inner > 1e-6:
        raise AssertionError(f"11b: the crop is not the full frame's window: "
                             f"{inner}")

    # -- 11c: Scene's queries on the 1M mesh --------------------------------
    t0 = time.perf_counter()
    cam = mesh_heavy.build_camera(256, "unused.png")
    o, d, tm = camera_rays(cam, dev)
    o, d = o.arr(), d.arr()
    counts_zero()
    hit = scene.intersect(o, d, tm)
    occ = scene.intersect_p(o, d, tm)
    q_launches = counts()
    torch.cuda.synchronize()
    if q_launches["sweep"] <= 0 or q_launches["intersect"]:
        raise AssertionError(f"11c: the queries' launches {q_launches}")
    # intersect_p is the sources' raw any-hit; intersect's records pass the
    # detail phase's watertight recompute, which (exact edges off) drops a
    # few hits the sweep finds on shared edges. So intersect_p must equal
    # the closest-hit sources' raw masks, and hold every record's hit.
    raw_t = scene.accel.intersect(o, d, tm, False)[0]
    raw_s = WG.spheres_closest(scene.sphere_cols, V3.of(o), V3.of(d), tm)[0]
    occ_differs = int((occ != (raw_t | raw_s)).sum())
    dropped = int((occ & ~hit.valid).sum())
    missing = int((hit.valid & ~occ).sum())
    brute = TI.attach(copy.copy(scene))
    sel = torch.randperm(o.shape[0], generator=torch.Generator().manual_seed(
        0))[:4096].to(dev)
    counts_zero()
    ref = brute.intersect(o[sel], d[sel], tm[sel])
    oracle_launches = counts()["intersect"]
    sub = dict(valid=hit.valid[sel], t=hit.t[sel], prim=hit.prim_id[sel])
    both = sub["valid"] & ref.valid
    t_rel = ((sub["t"] - ref.t).abs() / ref.t.abs().clamp_min(1.0))[both]
    ids_differ = both & (sub["prim"] != ref.prim_id)
    ties = 0
    for lane in torch.nonzero(ids_differ).flatten().tolist():
        # A tie when the sweep's triangle, tested alone by brute force,
        # gives the same t as the brute force's pick.
        tri = int(sub["prim"][lane]) - scene.n_spheres
        if tri < 0:
            continue
        tr = scene.triangles
        panel, ids = TI.pack_tris(tr.v0[tri:tri + 1], tr.v1[tri:tri + 1],
                                  tr.v2[tri:tri + 1])
        rays, _ = TI.pack_rays(o[sel][lane:lane + 1], d[sel][lane:lane + 1],
                               tm[sel][lane:lane + 1])
        bt, _ = TI.intersect_plain(rays, torch.from_numpy(panel).to(dev),
                                   torch.from_numpy(ids).to(dev))
        ties += int(bool(bt[0] == ref.t[lane]))
    q = dict(rays=o.shape[0], hits=int(hit.valid.sum()),
             occluded=int(occ.sum()), occ_differs_from_raw_hit=occ_differs,
             edge_hits_dropped_by_detail=dropped, hit_not_occluded=missing,
             launches=q_launches, oracle_rays=4096,
             oracle_launches=oracle_launches,
             hit_mismatch=int((sub["valid"] != ref.valid).sum()),
             t_max_rel=float(t_rel.max()) if t_rel.numel() else 0.0,
             ids_differ=int(ids_differ.sum()), ids_tied=ties)
    q["untied_id_mismatch"] = q["ids_differ"] - ties
    q["query_ms"] = cuda_ms(lambda: scene.intersect(o, d, tm), 3)
    q["query_p_ms"] = cuda_ms(lambda: scene.intersect_p(o, d, tm), 3)
    # utils.stats.trace_profile around one any-hit query: a Chrome trace
    # holding the card's kernels.
    with trace_profile(os.path.join(tmp, "chip_smoke_trace11")) as prof:
        scene.intersect_p(o, d, tm)
    with open(prof.path) as f:
        events = json.load(f).get("traceEvents", [])
    q["trace_kernel_events"] = sum(1 for e in events
                                   if e.get("cat") == "kernel")
    q["trace_sweep_events"] = sum(1 for e in events
                                  if e.get("cat") == "kernel"
                                  and "sweep_kernel" in e.get("name", ""))
    out["scene_queries"] = q
    log("11c", t0, f"Scene.intersect / intersect_p on {q['rays']} camera "
        f"rays of the 1M mesh: {q['hits']} hits, {q['occluded']} occluded "
        f"(differ from the sources' raw hits: {occ_differs}; occluded "
        f"without a record, the sweep's edge hits the watertight detail "
        f"phase drops: {dropped}; records not occluded: {missing}), "
        f"launches {q_launches}, "
        f"{q['query_ms']:.2f} / {q['query_p_ms']:.2f} ms; on 4096 of them "
        f"against the brute-force intersect.cu route ({oracle_launches} "
        f"launches): hit mismatches {q['hit_mismatch']}, t max rel "
        f"{q['t_max_rel']:.2e} (gate {T_RTOL}), ids differ {q['ids_differ']} "
        f"({ties} ties); trace_profile of intersect_p: "
        f"{q['trace_kernel_events']} kernel events, "
        f"{q['trace_sweep_events']} of the sweep; card {card}")
    if occ_differs or missing or q["hit_mismatch"] \
            or q["t_max_rel"] > T_RTOL \
            or q["untied_id_mismatch"] or oracle_launches <= 0 \
            or q["trace_sweep_events"] <= 0:
        raise AssertionError(f"11c: the queries disagree: {q}")

    # -- 11d: the scatter splat at full width -------------------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    film = Film((512, 512))
    n = SPLAT_SAMPLES
    p = torch.rand((n, 2), generator=gen, device=dev) * 514.0 - 1.0
    L = torch.rand((n, 3), generator=gen, device=dev)
    w = torch.rand(n, generator=gen, device=dev)
    s0 = film.initial_state(dev)
    a = film.add_samples(s0, p, L, w)
    b = film.add_samples(s0, p, L, w)
    torch.cuda.synchronize()
    repeat = torch.equal(a.xyz, b.xyz) and torch.equal(a.weight_sum,
                                                       b.weight_sum)
    cpu = film.add_samples(film.initial_state("cpu"), p.cpu(), L.cpu(),
                           w.cpu())
    card_cpu = bool(torch.equal(a.xyz.cpu(), cpu.xyz)
                    and torch.equal(a.weight_sum.cpu(), cpu.weight_sum))
    # The card sums each pixel's entries in an order of its own (a sort,
    # then a reduction per index), the CPU one after another: equal to
    # the last bits of the sums.
    card_cpu_rel = max(float(((x.cpu() - y).abs() / y.abs().clamp_min(
        1e-30))[y.abs() > 1e-3].max()) for x, y in (
        (a.xyz, cpu.xyz), (a.weight_sum, cpu.weight_sum)))
    (x0, y0), (x1, y1) = film.sample_bounds()
    gw, gh = x1 - x0 + 1, y1 - y0 + 1
    gy, gx = torch.meshgrid(torch.arange(y0, y1 + 1, device=dev),
                            torch.arange(x0, x1 + 1, device=dev),
                            indexing="ij")
    pix = torch.stack([gx.reshape(-1), gy.reshape(-1)], 1).float()
    pg = pix + torch.rand(pix.shape, generator=gen, device=dev)
    Lg = torch.rand((pix.shape[0], 3), generator=gen, device=dev)
    wg = torch.rand(pix.shape[0], generator=gen, device=dev) * 0.5 + 0.5
    sc = film.add_samples(s0, pg, Lg, wg)
    gr = film.add_samples_grid(s0, pg, Lg, wg, (x0, y0), (gh, gw))
    rel = lambda x, y: float(((x - y).abs() / y.abs().clamp_min(1e-30))
                             .max())
    ws_ok = bool(torch.allclose(sc.weight_sum, gr.weight_sum, rtol=2e-6,
                                atol=2e-6))
    xyz_ok = bool(torch.allclose(sc.xyz, gr.xyz, rtol=2e-5, atol=2e-6))
    # Splats, a tenth of them outside the film: dropped, not clamped.
    ps = torch.rand((n, 2), generator=gen, device=dev) * 563.2 - 25.6
    inside = ((ps >= 1.0) & (ps < 513.0)).all(-1)
    sp = film.add_splats(s0, ps, L)
    want = float(spec.rgb_to_xyz(L[inside]).double().sum())
    got = float(sp.splat_xyz.double().sum())
    dropped_ok = abs(got - want) <= 1e-5 * abs(want)
    splat = dict(samples=n, film=(512, 512), repeat_bit_equal=repeat,
                 card_equals_cpu=card_cpu, card_cpu_max_rel=card_cpu_rel,
                 grid_lanes=int(pix.shape[0]),
                 grid_weight_rel=rel(sc.weight_sum, gr.weight_sum),
                 grid_xyz_rel=rel(sc.xyz[gr.xyz > 1e-3],
                                  gr.xyz[gr.xyz > 1e-3]),
                 grid_ok=ws_ok and xyz_ok, splats_inside=int(inside.sum()),
                 splat_sum=got, splat_sum_want=want)
    splat["add_samples_ms"] = cuda_ms(lambda: film.add_samples(s0, p, L, w), 5)
    splat["add_splats_ms"] = cuda_ms(lambda: film.add_splats(s0, ps, L), 5)
    splat["grid_ms"] = cuda_ms(lambda: film.add_samples_grid(
        s0, pg, Lg, wg, (x0, y0), (gh, gw)), 5)
    splat["grid_as_scatter_ms"] = cuda_ms(lambda: film.add_samples(
        s0, pg, Lg, wg), 5)
    out["splat"] = splat
    log("11d", t0, f"add_samples on {n} samples over a 512^2 film: the same "
        f"bits twice {repeat}, equal to the CPU's {card_cpu} (max rel "
        f"{card_cpu_rel:.2e}); "
        f"{splat['add_samples_ms']:.3f} ms; on the {splat['grid_lanes']}-lane "
        f"grid against add_samples_grid: weights rel "
        f"{splat['grid_weight_rel']:.2e}, xyz rel {splat['grid_xyz_rel']:.2e} "
        f"(gates: 1e-6, and test_film_grid.py's: {splat['grid_ok']}), "
        f"{splat['grid_as_scatter_ms']:.3f} ms vs the grid's "
        f"{splat['grid_ms']:.3f} ms; add_splats {splat['add_splats_ms']:.3f} "
        f"ms, {splat['splats_inside']} of {n} inside, xyz sum {got:.3f} "
        f"(want {want:.3f}); card {card}")
    if not (repeat and splat["grid_ok"] and dropped_ok
            and card_cpu_rel <= 1e-5
            and splat["grid_weight_rel"] <= 1e-6
            and splat["grid_xyz_rel"] <= 1e-6):
        raise AssertionError(f"11d: the splats: {splat}")

    # -- 11e: compare.py's CLI on 11b's PNGs -------------------------------
    t0 = time.perf_counter()
    win_png = os.path.join(tmp, "chip_smoke_gaussian_window.png")
    write_png(win_png, window[::-1])
    h, w_ = crop_img.shape[:2]
    res = subprocess.run(
        [sys.executable, "-m", "trace_tpu_torch.utils.compare",
         frames["gaussian_crop"]["png"], win_png, "--crop", "1", "1",
         str(w_ - 1), str(h - 1)], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    metrics = json.loads(res.stdout) if res.returncode == 0 else None
    out["compare_cli"] = dict(rc=res.returncode, metrics=metrics)
    log("11e", t0, f"python -m trace_tpu_torch.utils.compare (crop vs the "
        f"full frame's window, inside the ring): rc {res.returncode}, "
        f"{res.stdout.strip()} {res.stderr.strip()[-300:]}")
    if res.returncode != 0 or metrics["mse"] > 1e-6:
        raise AssertionError(f"11e: compare: {out['compare_cli']}")
    log(11, t0, f"whole run so far {time.perf_counter() - t_all:.1f} s")
    return out


# Phase 12's bound for the walk kernel (csrc/bvh_walk.cu's note): FP32
# instructions a node visit (per slab axis two subtractions, two
# multiplies, two NaN tests, a min and a max; then the tn / tf reductions,
# the pad and three compares) and a triangle test (the watertight test:
# the degenerate cross product, three shears, three edge functions, the
# sign tests, the scaled t and the division), and the bytes of a node row
# and a triangle row: the bound reads each distinct row a launch's walks
# touch once (the kernel's marks), however often the walks revisit it.
WALK_NODE_OPS = 32
WALK_TRI_OPS = 80
WALK_NODE_BYTES = 32
WALK_TRI_BYTES = 48
WALK_SRC = "trace_tpu_torch/csrc/bvh_walk.cu"
WALK_REPLACES = ("trace_tpu/accel/wbvh.py:115, "
                 "trace_tpu/accel/bvh.py:275")


def walk_marked(acc, o, d, tm, any_hit, limit="wbvh", plain=False):
    """One walk of these rays with the counts and the row marks, by the
    kernel or (``plain``) walk_plain: (t, id, stats, seen u8 [M + T])."""
    import torch
    from trace_tpu_torch.accel.wbvh import walk_plain
    from trace_tpu_torch.ops.bvh_walk import walk_kernel

    seen = torch.zeros(acc.nodes.shape[0] + acc.tris.shape[0],
                       dtype=torch.uint8, device=o.device)
    out = (walk_plain if plain else walk_kernel)(
        acc.nodes, acc.tris, o, d, tm, any_hit=any_hit, limit=limit,
        stack_depth=acc.stack_depth, collect_stats=True, seen=seen)
    return (*out, seen)


def walk_bound(stats, seen, n_nodes, n):
    """The walk launch's bound from this run's walks: the node visits' and
    triangle tests' instructions, or the bytes that must come from memory:
    each distinct node row and triangle row the walks touched (``seen``,
    the first ``n_nodes`` entries the nodes') once, the rays (o, d, t_max)
    read and the outputs (t, id) written."""
    visits, tests = int(stats[0].sum()), int(stats[1].sum())
    nodes, rows = int(seen[:n_nodes].sum()), int(seen[n_nodes:].sum())
    ms, by = bound(visits * WALK_NODE_OPS + tests * WALK_TRI_OPS,
                   nodes * WALK_NODE_BYTES + rows * WALK_TRI_BYTES + n * 36)
    return dict(bound_ms=ms, bound_by=by, nodes_touched=nodes,
                rows_touched=rows)


def walk_compare(k, p):
    """The walk kernel's (t, id[, stats]) against the plain version's: hits,
    ids and t bits that differ, t beyond T_RTOL, the max abs t difference,
    the per-ray counts that differ."""
    import torch

    (kt, ki), (pt, pi) = k[:2], p[:2]
    both = (ki >= 0) & (pi >= 0)
    dt = (kt - pt).abs()
    out = dict(hit_mismatch=int(((ki >= 0) != (pi >= 0)).sum()),
               id_mismatch=int((ki != pi).sum()),
               t_bits_mismatch=int((kt.view(torch.int32)
                                    != pt.view(torch.int32)).sum()),
               t_beyond_tol=int((both & (dt > T_RTOL * pt.abs().clamp_min(
                   1.0))).sum()),
               max_abs_err=float(dt[both].max()) if bool(both.any()) else 0.0,
               n_found=int((ki >= 0).sum()))
    if len(k) > 2:
        out["stats_mismatch"] = int((k[2] != p[2]).sum())
    if len(k) > 3:
        out["seen_mismatch"] = int((k[3] != p[3]).sum())
    return out


def walk_disagrees(c) -> bool:
    return bool(c["hit_mismatch"] or c["id_mismatch"] or c["t_beyond_tol"]
                or c.get("stats_mismatch") or c.get("seen_mismatch"))


def walk_orders(acc, o, d, tm):
    """The rays in both orders the walk accelerator can launch them:
    {"arrival": as given, "sorted": by sort_key}, the accelerator's own
    (``sort_rays``) first."""
    import torch
    from trace_tpu_torch.accel.clusters import sort_key

    perm = torch.argsort(sort_key(o, d, acc.world_lo, acc.world_inv_extent),
                         stable=True)
    orders = {"arrival": (o, d, tm),
              "sorted": (o[perm].contiguous(), d[perm].contiguous(),
                         tm[perm].contiguous())}
    first = "sorted" if acc.sort_rays else "arrival"
    return {first: orders[first], **orders}


def walk_sort_ms(acc, o, d, tm, anyh, reps):
    """Device ms of the accelerator's whole intersect on these rays
    without the sort and with it: (unsorted, sorted)."""
    keep = acc.sort_rays
    try:
        out = []
        for flag in (False, True):
            acc.sort_rays = flag
            out.append(cuda_ms(lambda: acc.intersect(o, d, tm, anyh), reps))
    finally:
        acc.sort_rays = keep
    return tuple(out)


def sweep_call_ms(acc, o, d, tm, anyh):
    """Device ms of the sweep accelerator's kernels on one call: the
    prologue kernel's and the sweep kernel's, summed over the chunks it
    launches (3 launches each), and the launches."""
    from trace_tpu_torch.ops.sweep import block_entry_kernel, sweep_kernel

    perm = acc.coherence_order(o, d, tm)
    o, d, tm = o[perm], d[perm], tm[perm]
    pro = swp = 0.0
    starts = acc.live_chunks(tm)
    for s in starts:
        sl = slice(s, s + acc.ray_chunk)
        a = (acc.s_lo, acc.s_hi, *acc.pad_rays(o[sl], d[sl], tm[sl]),
             acc.block_rays)
        pro += cuda_ms(lambda: block_entry_kernel(*a), 3)
        args = acc.prologue(o[sl], d[sl], tm[sl])
        swp += cuda_ms(lambda: sweep_kernel(*args, acc.panel, acc.block_rays,
                                            anyh, certified=acc.certified),
                       3)
    return pro, swp, len(starts)


def tagged_walk_calls(integ, scene):
    """Render with the SPPM integrator ``integ`` on ``scene`` and return
    every intersect call of its accelerator, named by pass and depth:
    [(name, o, d, t_max, any_hit)], names "camera depth 1", "camera
    shadow 1", ..., "photon depth 1", ..."""
    acc = scene.accel
    phase = ["camera"]
    passes = (("_camera_pass_all", "camera"), ("_photon_walk_all", "photon"))
    for name, label in passes:
        def tagged(*a, _fn=getattr(integ, name), _label=label, **k):
            phase[0] = _label
            return _fn(*a, **k)
        setattr(integ, name, tagged)
    calls, depth = [], {"camera": 0, "photon": 0}
    traced = acc.intersect

    def record(o, d, t_max, any_hit):
        ph = phase[0]
        depth[ph] += not any_hit
        calls.append((f"{ph} {'shadow' if any_hit else 'depth'} "
                      f"{depth[ph]}", o.clone(), d.clone(), t_max.clone(),
                      any_hit))
        return traced(o, d, t_max, any_hit)

    acc.intersect = record
    try:
        integ.render(scene)
    finally:
        del acc.intersect
        for name, _ in passes:
            delattr(integ, name)
    return calls


def walk_cases(dev):
    """The walk's two traps on the card (tests/test_torch_wbvh.py's
    inputs): a leaf of 9 triangles sharing one centroid, whose nearest
    triangle along the rays is the last, 8; and rays whose origin lies on
    the node planes x = k of a flat 8 x 8 grid, straight down with +0.0
    and -0.0 components, every one a hit. -> {name: (nodes, tris, o, d,
    check(t, id) -> bool)}."""
    import torch
    from trace_tpu_torch.accel import bvh as B
    from trace_tpu_torch.accel import wbvh as W
    from trace_tpu_torch.core import transform as TT
    from trace_tpu_torch.shapes import triangle as tri_mod

    def packed(idx, verts):
        tt = tri_mod.pack_triangle_mesh(TT.identity(), idx, verts)
        bvh = B.build_bvh(tri_mod.world_bounds_np(tt), 4)
        return (torch.from_numpy(W.pack_nodes(bvh)).to(dev),
                torch.from_numpy(W.pack_leaf_tris(tt, np.asarray(
                    bvh.prim_order, np.int64))).to(dev))

    z = 0.1 * np.arange(1, 10, dtype=np.float32)
    p = np.stack([np.ones(9), np.ones(9), z], -1).astype(np.float32)
    q = np.array([-0.5, 0.5, 0.0], np.float32)
    verts = np.concatenate([p, -p, np.repeat(q[None], 9, 0)], 0)
    idx = np.stack([np.arange(9), np.arange(9) + 9, np.arange(9) + 18], -1)
    rng = np.random.default_rng(4)
    xy = (rng.uniform(0.02, 0.3, 16)[:, None] * np.ones(2)
          + rng.uniform(0.3, 0.6, 16)[:, None] * q[None, :2])
    o = np.concatenate([xy, np.full((16, 1), 10.0)], 1).astype(np.float32)
    d = np.tile(np.float32([0.0, 0.0, -1.0]), (16, 1))
    cases = {"centroid_leaf": (*packed(idx, verts), o, d,
                               lambda t, i: bool((i == 8).all()))}
    n = 8
    xs = np.arange(n + 1, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack([gx, gy, np.zeros_like(gx)], -1).reshape(-1, 3)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    v00 = (ii * (n + 1) + jj).reshape(-1)
    idx = np.concatenate([np.stack([v00, v00 + n + 1, v00 + 1], -1),
                          np.stack([v00 + 1, v00 + n + 1, v00 + n + 2], -1)])
    m = 64
    rng = np.random.default_rng(7)
    o = np.stack([rng.integers(0, n + 1, m).astype(np.float32),
                  np.where(np.arange(m) % 2 == 0, rng.integers(0, n + 1, m),
                           rng.uniform(0, n, m)).astype(np.float32),
                  np.full(m, 5.0, np.float32)], -1)
    d = np.stack([np.where(np.arange(m) % 4 < 2, 0.0, -0.0),
                  np.where(np.arange(m) % 3 == 0, -0.0, 0.0),
                  np.full(m, -1.0)], -1).astype(np.float32)
    cases["on_plane"] = (*packed(idx, verts), o, d, lambda t, i: bool(
        (i >= 0).all() and (t == 5.0).all()))
    return {k: (nd, tr, torch.from_numpy(o_).to(dev),
                torch.from_numpy(d_).to(dev), ok)
            for k, (nd, tr, o_, d_, ok) in cases.items()}


def slice12(dev, card, scene, t_all):
    """Phase 12: the BVH accelerators (module docstring). ``scene`` is the
    1M mesh_heavy scene on its sweep."""
    import torch
    from trace_tpu_torch.accel import bvh as B
    from trace_tpu_torch.accel import wbvh as W
    from trace_tpu_torch.accel.clusters import (ClusterAccelerator,
                                                build_clusters)
    from trace_tpu_torch.core.vec import V3
    from trace_tpu_torch.integrators.sppm import SPPMIntegrator
    WhittedIntegrator = eager_whitted
    from trace_tpu_torch.models import mesh_heavy
    from trace_tpu_torch.ops.bvh_walk import walk_kernel
    from trace_tpu_torch.ops.sweep import block_entry_kernel, sweep_kernel
    from trace_tpu_torch.sampler import uniform as U
    from trace_tpu_torch.shapes import triangle as tri_mod
    from trace_tpu_torch.wavefront import geom as WG

    tmp = tempfile.gettempdir()
    sacc = scene.accel
    out = {}

    def counts_zero():
        sweep_kernel.reset_counts()
        block_entry_kernel.reset_counts()
        walk_kernel.reset_counts()

    # -- 12a: the walk kernel against its plain version ---------------------
    t0 = time.perf_counter()
    view = scene.with_geometry(scene.triangles, None)
    W.attach(view)
    wacc = view.accel
    tree = dict(depth=wacc.depth, nodes=int(wacc.nodes.shape[0]),
                stack_depth=wacc.stack_depth,
                nodes_mb=wacc.nodes.numel() * 4 / 1e6,
                tris_mb=wacc.tris.numel() * 4 / 1e6,
                host_build_s=time.perf_counter() - t0)
    log("12a", t0, f"wbvh over the {scene.n_triangles}-triangle mesh: tree "
        f"{tree}")
    if not isinstance(wacc, W.WBVHAccelerator) or wacc.depth + 2 > \
            wacc.stack_depth:
        raise AssertionError(f"[12a] no walk accelerator: {tree}")
    png = os.path.join(tmp, "chip_smoke_wbvh_256.png")
    integ = WhittedIntegrator(mesh_heavy.build_camera(256, png),
                              U.UniformSampler(1, seed=0), max_depth=2,
                              pixel_chunk=ONE_CHUNK)
    calls = record_calls(integ, view)
    labels = ["camera", "shadow", "specular", "specular shadow"]
    agree, rows = {}, []
    own = "sorted" if wacc.sort_rays else "arrival"
    for (o, d, tm, anyh), name in zip(calls, labels):
        orders = walk_orders(wacc, o, d, tm)
        so, sd, st = orders[own]
        for lim in ("wbvh", "bvh"):
            k = walk_marked(wacc, so, sd, st, anyh, lim)
            p = walk_marked(wacc, so, sd, st, anyh, lim, plain=True)
            torch.cuda.synchronize()
            c = walk_compare(k, p)
            agree[f"{name} {lim}"] = c
            if walk_disagrees(c):
                raise AssertionError(f"[12a] walk kernel disagrees with "
                                     f"plain: {name} {lim} {c}")
            if lim == "wbvh":
                kw = dict(any_hit=anyh, limit=lim,
                          stack_depth=wacc.stack_depth)
                row = dict(launch=name, lanes=o.shape[0], order=own,
                           visits=int(k[2][0].sum()),
                           tests=int(k[2][1].sum()),
                           max_visits=int(k[2][0].max()))
                # The kernel in the accelerator's own order only: phase
                # 15b graph-times the walk on config 3's calls.
                row["ms"] = row[f"{own}_ms"] = cuda_ms(lambda: walk_kernel(
                    wacc.nodes, wacc.tris, so, sd, st, **kw), 10)
                row.update(walk_bound(k[2], k[3], wacc.nodes.shape[0],
                                      o.shape[0]))
                if name == "camera":
                    row["plain_ms"] = cuda_ms(lambda: W.walk_plain(
                        wacc.nodes, wacc.tris, so, sd, st, **kw), 1)
                rows.append(row)
                log("12a", t0, f"{name}: {row}; card {card}")
        log("12a", t0, f"{name} ({o.shape[0]} rays, any_hit {anyh}, "
            f"{own} order): kernel vs plain, both limits: "
            f"{agree[f'{name} wbvh']}, {agree[f'{name} bvh']}")
    for name, (nd, tr, o, d, ok) in walk_cases(dev).items():
        tm = torch.full((o.shape[0],), float("inf"), device=dev)
        for lim in ("wbvh", "bvh"):
            kw = dict(any_hit=False, limit=lim, stack_depth=W.STACK_CAP)
            k = walk_kernel(nd, tr, o, d, tm, **kw)
            p = W.walk_plain(nd, tr, o, d, tm, **kw)
            torch.cuda.synchronize()
            c = walk_compare(k, p)
            agree[f"{name} {lim}"] = c
            log("12a", t0, f"{name} {lim}: {c}")
            if walk_disagrees(c) or c["t_bits_mismatch"] or not ok(*k):
                raise AssertionError(f"[12a] {name} {lim}: {c}")
    out["tree"], out["agreement"], out["launches"] = tree, agree, rows

    # -- 12b: against brute force, and against the sweep -------------------
    t0 = time.perf_counter()
    o, d, tm, _ = calls[0]
    every = torch.arange(4096, device=dev) * (o.shape[0] // 4096)
    o4, d4, t4 = o[every], d[every], tm[every]
    h, t, i = wacc.intersect(o4, d4, t4, False)
    bh, bt, bi = WG.triangles_closest(view.triangle_cols, V3.of(o4),
                                      V3.of(d4), t4, chunk=8192)
    apart = (i != bi) & h
    # An id apart is a tie where the walk's triangle has the brute force's t.
    tri = view.triangles
    vs = [V3.of(torch.as_tensor(getattr(tri, f)).to(dev)[i.long()])
          for f in ("v0", "v1", "v2")]
    _, tw, _, _, _ = WG._watertight(*vs, V3.of(o4), V3.of(d4), t4)
    brute = dict(hit_mismatch=int((h != bh).sum()),
                 t_beyond_tol=int((h & ((t - bt).abs() > T_RTOL * bt.abs()
                                        )).sum()),
                 ids_apart=int(apart.sum()),
                 untied_ids_apart=int((apart & (tw != bt)).sum()),
                 n_found=int(h.sum()))
    log("12b", t0, f"4096 camera rays, walk vs brute force "
        f"(G.triangles_closest): {brute}")
    if brute["hit_mismatch"] or brute["t_beyond_tol"] \
            or brute["untied_ids_apart"] or brute["n_found"] < 100:
        raise AssertionError(f"[12b] walk vs brute force: {brute}")
    vs_sweep = {}
    for (o, d, tm, anyh), name in zip(calls, labels):
        hw = wacc.intersect(o, d, tm, anyh)[0]
        hs = sacc.intersect(o, d, tm, anyh)[0]
        vs_sweep[name] = dict(walk_only=int((hw & ~hs).sum()),
                              sweep_only=int((hs & ~hw).sum()),
                              hits=int(hw.sum()))
    log("12b", t0, f"hit masks, walk (watertight) vs sweep (Moller-"
        f"Trumbore), same calls: {vs_sweep}")
    out["brute"], out["walk_vs_sweep"] = brute, vs_sweep

    # -- 12c: frames ---------------------------------------------------------
    t0 = time.perf_counter()
    counts_zero()
    state = integ.render(view)
    torch.cuda.synchronize()
    frame_launches = walk_kernel.launches
    if frame_launches <= 0 or sweep_kernel.launches \
            or block_entry_kernel.launches:
        raise AssertionError(f"[12c] the wbvh frame ran walk "
                             f"{frame_launches}, sweep "
                             f"{sweep_kernel.launches} launches")
    img_w = image(integ, state)
    integ_s = WhittedIntegrator(mesh_heavy.build_camera(256, os.path.join(
        tmp, "chip_smoke_sweep_256.png")), U.UniformSampler(1, seed=0),
        max_depth=2, pixel_chunk=ONE_CHUNK)
    img_s = image(integ_s, integ_s.render(scene))
    mse = float(np.mean((img_w - img_s) ** 2))
    frames = {}
    for label, it, sc in (("wbvh", integ, view), ("sweep", integ_s, scene)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, _ = timed_frames(it, sc)
        frames[label] = dict(times=times, ms=float(np.mean(times)),
                             peak_gib=torch.cuda.max_memory_allocated()
                             / 2**30)
    busy = device_busy("12c", t0, card, "wbvh frame",
                       lambda: integ.render(view), frames["wbvh"]["ms"])
    integ.camera.film.save_png(state)
    log("12c", t0, f"Whitted 256^2 on wbvh vs the sweep: MSE {mse:.3e} "
        f"(gate {MSE_GATE}); walk launches a frame {frame_launches}; frames "
        f"{frames}; PNG {png}; card {card}")
    if not (np.isfinite(img_w).all() and mse < MSE_GATE):
        raise AssertionError(f"[12c] wbvh frame vs sweep: MSE {mse}")
    out["whitted"] = dict(mse_vs_sweep=mse, walk_launches=frame_launches,
                          frames=frames, busy=busy)

    # -- 12d: SPPM, mesh1m_sppm_256's settings -------------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    kw = dict(initial_search_radius=0.3, max_depth=5, n_iterations=3,
              photons_per_iteration=65536, seed=0, device=dev)
    sppm = {}
    for label, sc in (("wbvh", view), ("sweep", scene)):
        sinteg = SPPMIntegrator(mesh_heavy.build_camera(256, os.path.join(
            tmp, f"chip_smoke_sppm_{label}_256.png")), **kw)
        sinteg.check_scene(sc)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        srows, sstate = sppm_iterations("12d", t0, card, sinteg, sc,
                                        sc.accel, 3, walk=label == "wbvh")
        img = sinteg.to_image(sstate, 3)
        sppm[label] = dict(iterations=srows,
                           pixels_gathered=int((sstate.tau.sum(-1) > 0)
                                               .sum()),
                           finite=bool(torch.isfinite(img).all()),
                           peak_gib=torch.cuda.max_memory_allocated()
                           / 2**30)
    gw, gs = sppm["wbvh"]["pixels_gathered"], sppm["sweep"]["pixels_gathered"]
    brief = {k: (v["pixels_gathered"], v["finite"], v["peak_gib"])
             for k, v in sppm.items()}
    log("12d", t0, f"SPPM 256^2, 65536 photons, depth 5, r0 0.3 (pixels "
        f"gathered, finite, peak GiB): {brief}; card {card}")
    if not sppm["wbvh"]["finite"] or gw <= 0 or abs(gw - gs) > 0.1 * gs:
        raise AssertionError(f"[12d] wbvh SPPM: gathered {gw} vs the "
                             f"sweep's {gs}, finite "
                             f"{sppm['wbvh']['finite']}")
    # One iteration's calls on the walk, by pass and depth; each replayed
    # through both accelerators on the same (o, d, t_max).
    sinteg = SPPMIntegrator(mesh_heavy.build_camera(256, os.path.join(
        tmp, "chip_smoke_sppm_tagged.png")), **dict(kw, n_iterations=1))
    per_depth = []
    scalls = tagged_walk_calls(sinteg, view)
    for name, o, d, tm, anyh in scalls:
        orders = walk_orders(wacc, o, d, tm)
        wk = dict(any_hit=anyh, limit="wbvh", stack_depth=wacc.stack_depth)
        _, _, stats, seen = walk_marked(wacc, *orders[own], anyh)
        row = dict(call=name, lanes=o.shape[0],
                   live=int((tm > 0).sum()), order=own,
                   visits=int(stats[0].sum()), max_visits=int(
                       stats[0].max()), tests=int(stats[1].sum()))
        for order, (xo, xd, xt) in orders.items():
            row[f"walk_{order}_ms"] = cuda_ms(lambda: walk_kernel(
                wacc.nodes, wacc.tris, xo, xd, xt, **wk), 3)
        row["walk_ms"] = row[f"walk_{own}_ms"]
        row.update(walk_bound(stats, seen, wacc.nodes.shape[0], o.shape[0]))
        (row["prologue_ms"], row["sweep_ms"],
         row["sweep_launches"]) = sweep_call_ms(sacc, o, d, tm, anyh)
        (row["walk_intersect_unsorted_ms"],
         row["walk_intersect_sorted_ms"]) = walk_sort_ms(wacc, o, d, tm,
                                                         anyh, 3)
        row["walk_intersect_ms"] = row[
            "walk_intersect_sorted_ms" if wacc.sort_rays
            else "walk_intersect_unsorted_ms"]
        row["sweep_intersect_ms"] = cuda_ms(
            lambda: sacc.intersect(o, d, tm, anyh), 3)
        per_depth.append(row)
        log("12d", t0, f"{row}; card {card}")
    if not any(c[0].startswith("photon") for c in scalls):
        raise AssertionError("[12d] no photon calls through the walk")
    out["sppm"], out["sppm_per_depth"] = sppm, per_depth

    # -- 12e: clusters and bvh ---------------------------------------------
    t0 = time.perf_counter()
    golden = np.load(GOLDEN)
    small = {}
    for label in ("clusters", "bvh"):
        if label == "bvh":
            sc = B.attach(mesh_heavy.build_scene(5000, device=dev))
        else:
            sc = mesh_heavy.build_scene(5000, device=dev,
                                        accelerator="clusters")
        counts_zero()
        cam32 = mesh_heavy.build_camera(32, os.path.join(
            tmp, f"chip_smoke_32_{label}.png"))
        it = WhittedIntegrator(cam32, U.UniformSampler(1, seed=0),
                               max_depth=2, pixel_chunk=ONE_CHUNK)
        img = image(it, it.render(sc))
        small[label] = dict(mse=float(np.mean((img - golden) ** 2)),
                            accel=type(sc.accel).__name__,
                            walk_launches=walk_kernel.launches,
                            sweep_launches=sweep_kernel.launches)
        log("12e", t0, f"golden 32^2 on {label}: {small[label]}")
        if not (np.isfinite(img).all() and small[label]["mse"] < MSE_GATE) \
                or small[label]["sweep_launches"] \
                or (label == "bvh") != (small[label]["walk_launches"] > 0):
            raise AssertionError(f"[12e] {label}: {small[label]}")
    t1 = time.perf_counter()
    cacc = ClusterAccelerator(build_clusters(tri_mod.to_numpy(
        scene.triangles), 64, 4), dev, stage_clusters=128)
    cbuild = time.perf_counter() - t1
    o, d, tm, _ = calls[0]     # 64 rows from the first that sees terrain
    first = int(wacc.intersect(o, d, tm, False)[0].nonzero()[0, 0])
    o16, d16, t16 = (x[first:first + 16384] for x in (o, d, tm))
    torch.cuda.reset_peak_memory_stats()
    cacc.stats = {}
    hc = cacc.intersect(o16, d16, t16, False)
    stages = cacc.stats["stages"]
    c_ms = cuda_ms(lambda: cacc.intersect(o16, d16, t16, False), 1)
    hw = wacc.intersect(o16, d16, t16, False)
    clusters = dict(host_build_s=cbuild, clusters=int(cacc.clusters.c_lo
                                                      .shape[0]),
                    stages=stages, ms=c_ms,
                    walk_ms=cuda_ms(lambda: wacc.intersect(o16, d16, t16,
                                                           False), 3),
                    hits=int(hc[0].sum()),
                    vs_walk_hit_mismatch=int((hc[0] != hw[0]).sum()),
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log("12e", t0, f"clusters (leaf 64, stage 128) on 16384 of the 1M "
        f"camera rays: {clusters}; card {card}")
    if clusters["hits"] < 1000:
        raise AssertionError(f"[12e] clusters found too few hits: "
                             f"{clusters}")
    out["goldens"], out["clusters_1m"] = small, clusters

    # The kernels line's row: the camera call's times, launches per frame
    # and per SPPM iteration.
    cam = rows[0]
    out["entry"] = {
        "name": "bvh_walk", "route": "cuda", "source": WALK_SRC,
        "replaces": WALK_REPLACES, "launches": frame_launches,
        "max_abs_err": max(c["max_abs_err"] for c in agree.values()),
        "ms": cam["ms"], "plain_ms": cam["plain_ms"],
        "bound_ms": cam["bound_ms"], "bound_by": cam["bound_by"],
        "library_ms": None,
        "sppm_launches": sppm["wbvh"]["iterations"][1]["walk_launches"],
        "bvh_limit_5k_frame_launches": small["bvh"]["walk_launches"]}
    log(12, t0, f"whole run so far {time.perf_counter() - t_all:.1f} s")
    return out


# Phase 13: the sharded paths (parallel/render.py, parallel/sppm.py).
SHARD_ATOL = 2e-6          # __graft_entry__.py:243, :264, :317
SHARD_TAU_RTOL = 1e-5
SHARD_FRAMES = (("whitted", 2), ("path", 3))   # config 4, mesh1m_path_256
SHARD_SPPM = dict(initial_search_radius=0.3, max_depth=8, n_iterations=2,
                  photons_per_iteration=65536, seed=0)
SPPM_FIELDS = ("ld", "tau", "radius", "n", "m")
# Counters the single-device SPPM records and the sharded passes do not
# (integrators/sppm.py::SPPMIntegrator.step counts self hits on one device).
ONE_DEVICE_COUNTERS = ("sppm_camera_self_hits", "sppm_photon_self_hits")
RANK_TIMEOUT_S = 600


def shard_camera_of(png):
    from trace_tpu_torch.models import mesh_heavy

    return mesh_heavy.build_camera(256, png)


def timed_collectives(records):
    """Wrap the port's one collective (parallel.render.all_sum, also as
    parallel.sppm imported it): each call's bytes and wall ms (the stream
    drained before and after) go to ``records``. Returns the undo."""
    import torch
    from trace_tpu_torch.parallel import render as PR
    from trace_tpu_torch.parallel import sppm as PS

    plain = PR.all_sum

    def timed(t, group):
        torch.cuda.synchronize()
        s = time.perf_counter()
        plain(t, group)
        torch.cuda.synchronize()
        records.append((t.numel() * t.element_size(),
                        1e3 * (time.perf_counter() - s)))
        return t

    PR.all_sum = PS.all_sum = timed

    def undo():
        PR.all_sum = PS.all_sum = plain
    return undo


def event_ms(fn):
    """(fn's result, its ms between two CUDA events)."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def rank13(rank, world, backend, init, out_dir, check, device):
    """One rank of phase 13, spawned after phase 1 built the kernels (it
    only loads them): the 1M scene on ``device``, a mesh of ``world`` ranks
    over ``backend``; the sharded Whitted and path frames and two SPPM
    iterations, each run twice (counts from 0 before the first); with
    ``check``, rank 0 holds every sweep and prologue launch of the first
    runs against their plain versions. Arrays and a JSON of counts and
    times go to ``out_dir``."""
    import torch
    import torch.distributed as dist
    from trace_tpu_torch.integrators.sppm import SPPMIntegrator
    from trace_tpu_torch.models import mesh_heavy
    from trace_tpu_torch.ops.sweep import block_entry_kernel, sweep_kernel
    from trace_tpu_torch.parallel import render as PR
    from trace_tpu_torch.sampler import uniform as U
    from trace_tpu_torch.integrators import sppm as SP
    from trace_tpu_torch.utils.stats import RenderStats

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    tag = f"13 {backend} r{rank}/{world}"
    t0 = time.perf_counter()
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world,
                            **(dict(device_id=dev) if backend == "nccl"
                               else {}))
    try:
        scene = mesh_heavy.build_scene(1_000_000, device=dev)
        mesh = PR.make_mesh([dev] * world)
        acc = scene.accel
        log(tag, t0, f"scene built, mesh {mesh}")
        coll = []
        undo = timed_collectives(coll)
        out = dict(rank=rank, world=world, backend=backend)

        def counted(label, run, *args, **kw):
            sweep_kernel.reset_counts()
            block_entry_kernel.reset_counts()
            acc.skipped_chunks = 0
            dist.barrier()
            calls = None
            if check and rank == 0:
                (res, calls, _), ms = event_ms(
                    lambda: record_sweep_calls(run, *args, **kw))
            else:
                res, ms = event_ms(lambda: run(*args, **kw))
            counts = dict(sweep=sweep_kernel.launches,
                          f32=sweep_kernel.arm_launches["f32"],
                          prologue=block_entry_kernel.launches,
                          skipped=acc.skipped_chunks)
            if counts["sweep"] <= 0 or counts["f32"] != counts["sweep"] \
                    or counts["prologue"] != counts["sweep"]:
                raise AssertionError(f"[{tag}] {label} did not run the "
                                     f"kernels: {counts}")
            row = dict(launches=counts, counted_ms=ms)
            if calls is not None:
                row["agreement"], row["prologue"], _ = check_launches(
                    tag, acc, calls)
                del calls
            return res, row

        for name, depth in SHARD_FRAMES:
            cam = shard_camera_of("unused.png")
            kw = dict(spp=1, max_depth=depth, seed=0, integrator=name)
            PR.render_sharded(scene, cam, mesh, **kw)   # warm
            del coll[:]
            state, row = counted(name, PR.render_sharded, scene, cam, mesh,
                                 **kw)
            row["collectives"] = list(coll)
            torch.cuda.reset_peak_memory_stats()
            row["frame_ms"], row["rerun_same_bits"] = [], True
            for _ in range(3):
                dist.barrier()
                again, ms = event_ms(
                    lambda: PR.render_sharded(scene, cam, mesh, **kw))
                row["frame_ms"].append(ms)
                row["rerun_same_bits"] &= all(
                    torch.equal(x, y) for x, y in zip(state, again))
            row["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            for f, x in zip(("xyz", "weight_sum", "splat_xyz"), state):
                np.save(os.path.join(out_dir, f"r{rank}_{name}_{f}.npy"),
                        x.cpu().numpy())
            np.save(os.path.join(out_dir, f"r{rank}_{name}_image.npy"),
                    cam.film.to_image(state).cpu().numpy())
            out[name] = row
            checked = sum(t.get("launches", 0)
                          for t in row.get("agreement", {}).values())
            log(tag, t0, f"{name} depth {depth}: frames "
                f"{[round(x, 2) for x in row['frame_ms']]} ms after a warm "
                f"one and the counted one, same bits "
                f"{row['rerun_same_bits']}, launches {row['launches']}, "
                f"collectives "
                f"{[(b, round(ms, 3)) for b, ms in row['collectives']]}, "
                f"peak {row['peak_gib']:.3f} GiB"
                + (f"; every launch equal to plain ({checked} checked), "
                   f"prologue {row['prologue']}" if checked else ""))

        stats = RenderStats()
        integ = SPPMIntegrator(shard_camera_of("unused.png"), mesh=mesh,
                               shard_axis="rays", shard_camera=True,
                               device=dev, stats=stats, **SHARD_SPPM)
        key = U.key(integ.seed, dev)
        pixels = integ._pixel_grid(dev)
        cdf, pmf = integ.light_distribution(scene)
        state = SP.initial_state(integ.n_pixels, integ.initial_search_radius,
                                 dev)
        iters = []
        for it in range(1, SHARD_SPPM["n_iterations"] + 1):
            del coll[:]
            pairs = stats.counters.get("photon_vp_pairs", 0)
            state, row = counted(f"sppm {it}", integ.step, scene, state, it,
                                 pixels, key, cdf, pmf)
            row["collectives"] = list(coll)
            row["pairs"] = stats.counters["photon_vp_pairs"] - pairs
            iters.append(row)
        counters = stats.as_dict()
        torch.cuda.reset_peak_memory_stats()
        again = SP.initial_state(integ.n_pixels, integ.initial_search_radius,
                                 dev)
        iteration_ms = []
        for it in range(1, SHARD_SPPM["n_iterations"] + 1):
            dist.barrier()
            again, ms = event_ms(lambda: integ.step(scene, again, it, pixels,
                                                    key, cdf, pmf))
            iteration_ms.append(ms)
        same = all(torch.equal(getattr(state, f), getattr(again, f))
                   for f in SPPM_FIELDS)
        out["sppm"] = dict(iterations=iters, iteration_ms=iteration_ms,
                           rerun_same_bits=same, stats=counters,
                           peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        for f in SPPM_FIELDS:
            np.save(os.path.join(out_dir, f"r{rank}_sppm_{f}.npy"),
                    getattr(state, f).cpu().numpy())
        log(tag, t0, f"sppm: iterations {[round(x, 2) for x in iteration_ms]}"
            f" ms after the counted ones, launches "
            f"{[r['launches'] for r in iters]}, collectives "
            f"{[len(r['collectives']) for r in iters]} a iteration "
            f"({sum(b for b, _ in iters[0]['collectives'])} B, "
            f"{sum(ms for _, ms in iters[0]['collectives']):.2f} ms in the "
            f"first), same bits again {same}, peak "
            f"{out['sppm']['peak_gib']:.3f} GiB")
        undo()
        # The collectives alone: each size the runs summed, 5 all_reduces
        # after a barrier (the runs' own records include waiting for the
        # slower rank), median wall ms.
        sizes = sorted({b for r in [out["whitted"], out["path"], *iters]
                        for b, _ in r["collectives"]})
        out["collective_ms"] = {}
        for nbytes in sizes:
            t = torch.zeros(nbytes // 4, dtype=torch.float32, device=dev)
            times = []
            for _ in range(5):
                dist.barrier()
                torch.cuda.synchronize()
                s = time.perf_counter()
                PR.all_sum(t, mesh.get_group("rays"))
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - s))
            out["collective_ms"][nbytes] = float(np.median(times))
        log(tag, t0, f"all_reduce alone, median of 5 (bytes: ms): "
            f"{out['collective_ms']}")
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f, indent=1)
    finally:
        dist.destroy_process_group()


def nccl_pair13(rank, init):
    """Two NCCL ranks on cuda:0: one all_reduce of one value (NCCL is
    expected to refuse a GPU shared by two ranks)."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=init, rank=rank,
                            world_size=2)
    try:
        t = torch.ones(1, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        if float(t) != 2.0:
            raise AssertionError(f"NCCL all_reduce gave {float(t)}")
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, args, nprocs):
    """Start ``nprocs`` spawned ranks of ``fn(rank, *args)`` and wait for
    them (RANK_TIMEOUT_S at most, then terminate them and raise); a rank
    that raises fails the call."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.perf_counter() + RANK_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.perf_counter() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            raise TimeoutError(f"ranks of {fn.__name__} still running after "
                               f"{RANK_TIMEOUT_S} s")


def load_rank(out_dir, rank, name):
    return np.load(os.path.join(out_dir, f"r{rank}_{name}.npy"))


def slice13(dev, card, scene, t_all):
    """Phase 13: the sharded renders and SPPM (module docstring)."""
    import torch
    from trace_tpu_torch.integrators.path import PathIntegrator
    from trace_tpu_torch.integrators.sppm import SPPMIntegrator
    WhittedIntegrator = eager_whitted
    from trace_tpu_torch.parallel import render as PR
    from trace_tpu_torch.sampler import uniform as U
    from trace_tpu_torch.utils.stats import RenderStats

    out = {}
    t0 = time.perf_counter()
    # -- the single-device references, in this process ---------------------
    ref = {}
    for name, depth in SHARD_FRAMES:
        cls = WhittedIntegrator if name == "whitted" else PathIntegrator
        cam = shard_camera_of("unused.png")
        integ = cls(cam, U.UniformSampler(1, seed=0), max_depth=depth)
        times, state = timed_frames(integ, scene)
        ref[name] = image(integ, state)
        out[f"single_{name}_frame_ms"] = times
        # The one-device scatter splat (render_sharded's own path on one
        # rank), and the two ranks' shares summed here.
        films = [PR.render_share(integ, scene, *PR.shard_pixels(
            cam.film, r, n, dev)) for n in (1, 2) for r in range(n)]
        ref[f"{name}_one"] = [x.cpu().numpy() for x in films[0]]
        ref[f"{name}_two"] = [(a + b).cpu().numpy()
                              for a, b in zip(films[1], films[2])]
    stats = RenderStats()
    integ = SPPMIntegrator(shard_camera_of("unused.png"), device=dev,
                           stats=stats, **SHARD_SPPM)
    st, out["single_sppm_ms"] = event_ms(lambda: integ.render(scene))
    ref["stats"] = stats.as_dict()
    pair_chunk = integ.pair_chunk
    ref["sppm"] = {f: getattr(st, f).cpu().numpy() for f in SPPM_FIELDS}
    log("13", t0, f"single-device references: Whitted frames "
        f"{[round(x, 2) for x in out['single_whitted_frame_ms']]} ms, path "
        f"{[round(x, 2) for x in out['single_path_frame_ms']]} ms (one warm "
        f"before), the one-rank scatter and the two shares' films, "
        f"{SHARD_SPPM} {out['single_sppm_ms']:.2f} ms (2 iterations); "
        f"card {card}")
    del films, st
    torch.cuda.empty_cache()

    def gates(label, out_dir, world, exact):
        """Every rank the same bits; frames within SHARD_ATOL of the
        single-device frames (exact: the one-rank scatter's film bit for
        bit); SPPM's counters equal to the single-device run's (but
        ONE_DEVICE_COUNTERS), n and m equal, ld within SHARD_ATOL, tau within SHARD_TAU_RTOL relative
        (exact: every field bit for bit where each iteration's pairs fit
        one pair chunk; beyond, one device adds the chunks into the
        running sums and a mesh adds each chunk's own sum)."""
        rows = [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
                for r in range(world)]
        res = dict(ranks=rows)
        for name, _ in SHARD_FRAMES:
            files = [f"{name}_{f}" for f in ("xyz", "weight_sum",
                                             "splat_xyz", "image")]
            same = all(np.array_equal(load_rank(out_dir, r, f),
                                      load_rank(out_dir, 0, f))
                       for r in range(world) for f in files)
            img = load_rank(out_dir, 0, f"{name}_image")
            err = float(np.abs(img - ref[name]).max())
            film = [load_rank(out_dir, 0, f) for f in files[:3]]
            vs_one = all(np.array_equal(a, b)
                         for a, b in zip(film, ref[f"{name}_one"]))
            vs_two = all(np.array_equal(a, b)
                         for a, b in zip(film, ref[f"{name}_two"]))
            res[name] = dict(ranks_same_bits=same, max_abs_err=err,
                             equals_one_rank_scatter=vs_one,
                             equals_two_shares_summed=vs_two,
                             finite=bool(np.isfinite(img).all()))
            log(label, t0, f"{name}: ranks same bits {same}, max |diff| "
                f"against the single-device frame {err:.3e} (gate "
                f"{SHARD_ATOL}), the film equal to the one-rank scatter's "
                f"{vs_one}, to the two shares' films summed {vs_two}")
            bad = not (same and res[name]["finite"] and err <= SHARD_ATOL
                       and all(r[name]["rerun_same_bits"] for r in rows))
            if bad or (exact and not vs_one):
                raise AssertionError(f"[{label}] {name}: {res[name]}")
        st = {f: load_rank(out_dir, 0, f"sppm_{f}") for f in SPPM_FIELDS}
        same = all(np.array_equal(load_rank(out_dir, r, f"sppm_{f}"), st[f])
                   for r in range(world) for f in SPPM_FIELDS)
        s1 = ref["sppm"]
        ld_err = float(np.abs(st["ld"] - s1["ld"]).max())
        tau_rel = float((np.abs(st["tau"] - s1["tau"])
                         / np.maximum(np.abs(s1["tau"]), 1e-30)).max())
        counts_equal = all(np.array_equal(st[f], s1[f]) for f in ("n", "m"))
        bits = all(np.array_equal(st[f], s1[f]) for f in SPPM_FIELDS)
        gathered = int((st["tau"].sum(-1) > 0).sum())
        pairs = [r["pairs"] for r in rows[0]["sppm"]["iterations"]]
        shared = {k: v for k, v in ref["stats"].items()
                  if k not in ONE_DEVICE_COUNTERS}
        stats_equal = all(r["sppm"]["stats"] == shared for r in rows)
        res["sppm"] = dict(ranks_same_bits=same, ld_max_abs_err=ld_err,
                           tau_max_rel_err=tau_rel, n_m_equal=counts_equal,
                           bit_equal=bits, pixels_gathered=gathered,
                           pairs=pairs, stats_equal=stats_equal)
        exact = exact and max(pairs) <= pair_chunk
        log(label, t0, f"sppm: ranks same bits {same}, n and m equal "
            f"{counts_equal}, ld max |diff| {ld_err:.3e} (gate "
            f"{SHARD_ATOL}), tau max rel {tau_rel:.3e} (gate "
            f"{SHARD_TAU_RTOL}), every field bit-equal {bits}, pixels "
            f"gathered {gathered}, pairs {pairs} (chunk {pair_chunk}), "
            f"counters equal to the single-device run's {stats_equal}")
        if not (same and counts_equal and stats_equal
                and ld_err <= SHARD_ATOL and tau_rel <= SHARD_TAU_RTOL
                and gathered > 0
                and all(r["sppm"]["rerun_same_bits"] for r in rows)) \
                or (exact and not bits):
            raise AssertionError(f"[{label}] sppm: {res['sppm']}")
        return res

    base = tempfile.mkdtemp(prefix="chip_smoke13_")
    for label, backend, world in (("13a", "gloo", 2), ("13c", "nccl", 1)):
        t0 = time.perf_counter()
        out_dir = os.path.join(base, f"{backend}{world}")
        os.makedirs(out_dir)
        init = "file://" + os.path.join(base, f"store_{backend}{world}")
        spawn_ranks(rank13, (world, backend, init, out_dir,
                             backend == "gloo", str(dev)), world)
        out[f"{backend}{world}"] = gates(label, out_dir, world,
                                         exact=world == 1)
        log(label, t0, f"{world} {backend} rank(s) on cuda:0: gates held; "
            f"card {card}")

    # -- NCCL with two ranks on one card -------------------------------------
    t0 = time.perf_counter()
    init = "file://" + os.path.join(base, "store_nccl_pair")
    try:
        spawn_ranks(nccl_pair13, (init,), 2)
        outcome = "ran: two NCCL ranks shared cuda:0"
    except Exception as e:   # the recorded experiment, not a gate
        outcome = f"refused: {type(e).__name__}: " + " | ".join(
            line.strip() for line in str(e).splitlines()
            if "Duplicate" in line or "Error" in line)[:400]
    out["nccl_two_ranks_one_card"] = outcome
    log("13c", t0, f"two NCCL ranks on cuda:0: {outcome}")
    log(13, t0, f"whole run so far {time.perf_counter() - t_all:.1f} s")
    return out


# Phase 14: the captured launches held against the plain versions, every
# CAPTURE_STRIDE-th sweep launch of the block (and its prologue) and the
# last. Their tensors stay referenced, so the graph's allocator cannot
# reuse them, and a replay leaves its values in them.
CAPTURE_STRIDE = 32
FUSED_1024_ITERS = 4   # a warm iteration, then three
FUSED_ANIM_SHIFTS = (0.1, 0.2)


class CaptureRecorder:
    """While a CUDA graph is captured (or, with ``capture_only`` false,
    while the block runs), keep the tensors of every ``stride``-th call
    of ops.sweep's prologue and sweep (the accelerator's two launches a
    chunk), and the last: the prologue's inputs and (order, suffix), the
    sweep's inputs and (best t, best slot). With ``keep_all``, ``every``
    also holds each call's (prologue inputs, sweep args, sweep keywords),
    to replay them."""

    def __init__(self, stride, capture_only=True, keep_all=False):
        self.stride = stride
        self.capture_only = capture_only
        self.calls = []
        self.every = [] if keep_all else None
        self.n = 0

    def _keeps(self):
        import torch

        return (not self.capture_only
                or torch.cuda.is_current_stream_capturing())

    def __enter__(self):
        from trace_tpu_torch.ops import sweep as TS

        self.mod, self.fns = TS, (TS.prologue, TS.sweep)
        pro, swp = self.fns

        def prologue(*a):
            res = pro(*a)
            if self._keeps():
                self.pending = (a, res)
            return res

        def sweep(*a, **k):
            res = swp(*a, **k)
            if self._keeps():
                # One record a call: the last is added at exit unless kept.
                self.last = dict(prologue=self.pending, sweep=(a, k, res))
                if self.n % self.stride == 0:
                    self.calls.append(self.last)
                if self.every is not None:
                    self.every.append((self.pending[0], a, k))
                self.n += 1
            return res

        TS.prologue, TS.sweep = prologue, sweep
        return self

    def __exit__(self, *exc):
        self.mod.prologue, self.mod.sweep = self.fns
        if self.n and self.calls[-1] is not self.last:
            self.calls.append(self.last)
        self.pending = self.last = None

    def check(self, piece=None):
        """Each kept launch against its plain version: prologue bit for
        bit, sweep by compare() and t bits. ``piece``: the plain prologue
        runs on that many rays at a time (whole blocks; each block's row
        depends on its own rays only), for tables whose [rays, supers]
        entry table would not fit the card in one piece."""
        import torch
        from trace_tpu_torch.ops.sweep import prologue_plain, sweep_plain

        pro, swp, rows = {}, {}, []
        for c in self.calls:
            pa, (ko, ks) = c["prologue"]
            po, ps = plain_prologue_pieces(pa, piece)
            sa, sk, (kt, ki) = c["sweep"]
            pt, pi = sweep_plain(*sa, certified=sk["certified"],
                                 err_eps=sk["err_eps"])
            torch.cuda.synchronize()
            accumulate(pro, dict(order_mismatch=int((ko != po).sum()),
                                 suffix_bits_mismatch=int((
                                     ks.view(torch.int32)
                                     != ps.view(torch.int32)).sum())))
            cmp = compare(kt, ki, pt, pi)
            cmp["t_bits_mismatch"] = int((kt.view(torch.int32)
                                          != pt.view(torch.int32)).sum())
            accumulate(swp, cmp)
            rows.append(dict(lanes=int(pa[4].numel()),
                             live=int((pa[4] >= 0).sum()),
                             any_hit=bool(sa[5]), found=cmp["n_found"]))
        return pro, swp, rows


def plain_prologue_pieces(args, piece=None):
    """prologue_plain(*args), on ``piece`` rays at a time when given."""
    import torch
    from trace_tpu_torch.ops.sweep import prologue_plain

    s_lo, s_hi, o_p, d_p, t_p, b = args
    if piece is None or piece >= t_p.numel():
        return prologue_plain(*args)
    parts = [prologue_plain(s_lo, s_hi, o_p[i:i + piece], d_p[i:i + piece],
                            t_p[i:i + piece], b)
             for i in range(0, t_p.numel(), piece)]
    return tuple(torch.cat(x) for x in zip(*parts))


def stepwise_iterations(integ, scene, n):
    """``n`` stepwise iterations from a fresh state, each timed with CUDA
    events -> (ms, states after each, sweep launches, chunks skipped)."""
    import torch
    from trace_tpu_torch.integrators import sppm as SP
    from trace_tpu_torch.ops.sweep import sweep_kernel
    from trace_tpu_torch.sampler import uniform as U

    dev = scene.device
    pixels, key = integ._pixel_grid(dev), U.key(integ.seed, dev)
    cdf, pmf = integ.light_distribution(scene)
    state = SP.initial_state(integ.n_pixels, integ.initial_search_radius,
                             dev)
    ms, states, launches, skipped = [], [], [], []
    acc = scene.accel if scene.accel is not None else integ
    for it in range(1, n + 1):
        sweep_kernel.reset_counts()
        acc.skipped_chunks = 0
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        state = integ.step(scene, state, it, pixels, key, cdf, pmf)
        z.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(z))
        states.append(state)
        launches.append(sweep_kernel.launches)
        skipped.append(getattr(acc, "skipped_chunks", 0))
    return ms, states, launches, skipped


def timed_blocks(integ):
    """Wrap ``integ._fused_block``: each block's ms (CUDA events, from its
    call to its return, the host read included), pair totals and K, and
    its state, in the returned list."""
    import torch

    rows = []
    run = integ._fused_block

    def block(scene, state, it, n, *a):
        b = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        b.record()
        res = run(scene, state, it, n, *a)
        e.record()
        torch.cuda.synchronize()
        rows.append(dict(it=it, n=n, ms=b.elapsed_time(e),
                         totals=integ.last_pair_totals.tolist(),
                         pair_chunks=integ.fused_pair_chunks, state=res))
        return res

    integ._fused_block = block
    return rows


def replay_syncs(integ, scene, state, it):
    """Host synchronisations in one more fused block (a replay), counted
    by torch's sync debug mode ("warn")."""
    import warnings

    import torch
    from trace_tpu_torch.sampler import uniform as U

    dev = scene.device
    args = (integ._pixel_grid(dev), U.key(integ.seed, dev),
            *integ.light_distribution(scene))
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            integ._fused_block(scene, state, it, 1, *args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def slice14(dev, card, scene, t_all):
    """Phase 14: SPPM's fused blocks, one CUDA graph a block (module
    docstring)."""
    import torch
    from trace_tpu_torch.core import transform as T
    from trace_tpu_torch.integrators.fused import kernel_counts
    from trace_tpu_torch.integrators.sppm import SPPMIntegrator
    from trace_tpu_torch.models import caustic_glass, caustic_moving
    from trace_tpu_torch.models import mesh_heavy
    from trace_tpu_torch.ops import bvh_walk, intersect
    from trace_tpu_torch.ops.sweep import block_entry_kernel, sweep_kernel
    from trace_tpu_torch.shapes import triangle as tri_mod

    def reset():
        for k in (sweep_kernel, block_entry_kernel, bvh_walk.walk_kernel,
                  intersect.intersect_kernel):
            k.reset_counts()

    tmp = tempfile.gettempdir()
    out = {}
    # -- 14a: mesh1m_sppm_1024_fused1 -------------------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    n_it = FUSED_1024_ITERS
    kw = dict(initial_search_radius=0.075, max_depth=8, n_iterations=n_it,
              photons_per_iteration=262144, seed=0, device=dev)
    cam = mesh_heavy.build_camera(1024, os.path.join(
        tmp, "chip_smoke_fused_1024.png"))
    step_ms, step_states, step_launches, step_skipped = stepwise_iterations(
        SPPMIntegrator(cam, **kw), scene, n_it)
    log("14a", t0, f"stepwise 1024^2 iterations "
        f"{[round(x, 2) for x in step_ms]} ms; sweep launches "
        f"{step_launches}, chunks skipped {step_skipped}; card {card}")
    fz = SPPMIntegrator(cam, fused_iterations=True, fused_block=1, **kw)
    rows = timed_blocks(fz)
    reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with CaptureRecorder(CAPTURE_STRIDE) as rec:
        final = fz.render(scene)
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    del fz._fused_block
    cap = fz.fused_graphs.captures[0]
    same = [states_equal(r["state"], s) for r, s in zip(rows, step_states)]
    blocks_ms = [(r["it"], round(r["ms"], 2)) for r in rows]
    log("14a", t0, f"fused_block=1: blocks {blocks_ms} ms (block 1 runs "
        f"the body eagerly; block 2 holds the capture "
        f"{cap['capture_ms']:.1f} ms, host); pair totals {[r['totals'] for r in rows]}, K "
        f"{rows[-1]['pair_chunks']} of {fz.pair_chunk}; launches per replay "
        f"{cap['launches']}; the run's launches {counts}; peak "
        f"{peak:.2f} GiB; each block's state == stepwise: {same}; card "
        f"{card}")
    if len(rows) != n_it or not all(same) or len(fz.fused_graphs.captures) \
            != 1 or cap["launches"]["sweep"] <= 0 \
            or cap["launches"]["prologue"] != cap["launches"]["sweep"] \
            or counts["sweep"] <= 0:
        raise AssertionError(f"fused 1024^2 blocks: {len(rows)} blocks, "
                             f"same {same}, captures "
                             f"{fz.fused_graphs.captures}")
    blk = next(iter(fz.fused_graphs.graphs.values()))
    replay_ms = cuda_ms(blk.graph.replay, 3)
    pro_tot, swp_tot, kept = rec.check()
    log("14a", t0, f"graph replay alone {replay_ms:.2f} ms (CUDA events, "
        f"mean of 3); {len(kept)} captured launches against the plain "
        f"versions (lanes, live lanes, any-hit, hits: {kept}): prologue "
        f"{pro_tot}, sweep {swp_tot}")
    if prologue_disagrees(pro_tot) or disagrees(swp_tot) \
            or swp_tot["t_bits_mismatch"] or len(kept) < 2:
        raise AssertionError(f"captured launches disagree: {pro_tot} "
                             f"{swp_tot}")
    syncs = replay_syncs(fz, scene, rows[-2]["state"], n_it)
    it_n = torch.full((), n_it, dtype=torch.int64, device=dev)
    busy = device_busy("14a", t0, card, "fused block (replay)",
                       lambda: blk.replay(rows[-2]["state"], it_n),
                       replay_ms, require=False)
    # The cost of launching chunks with no live lane (the fused body's
    # static route): one such chunk's prologue, sweep and tensor ops,
    # captured as a graph of their own and replayed, as in a block.
    acc = scene.accel
    dead = torch.zeros((acc.ray_chunk, 3), device=dev)
    dead_args = (dead, dead + 1.0,
                 torch.full((acc.ray_chunk,), -1.0, device=dev), False)
    acc._traverse_chunk(*dead_args)
    torch.cuda.synchronize()
    dead_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(dead_graph):
        acc._traverse_chunk(*dead_args)
    dead_ms = cuda_ms(dead_graph.replay, 5)
    img = fz.to_image(final, n_it)
    finite = bool(torch.isfinite(img).all())
    fz.save(final, n_it)
    log("14a", t0, f"host syncs in one more block: {syncs} (the pair "
        f"total's read); a dead chunk's traversal as a graph "
        f"{dead_ms:.4f} ms, x {step_skipped[-1]} chunks the stepwise "
        f"iteration skips = {dead_ms * step_skipped[-1]:.2f} ms; "
        f"finite {finite}; card {card}")
    if syncs != 1 or not finite:
        raise AssertionError(f"fused block: {syncs} host syncs, finite "
                             f"{finite}")
    out["mesh1m_sppm_1024_fused1"] = dict(
        stepwise_ms=step_ms, stepwise_sweep_launches=step_launches,
        stepwise_skipped_chunks=step_skipped,
        blocks=[{k: v for k, v in r.items() if k != "state"} for r in rows],
        same_bits=same, capture=cap, run_launches=counts, peak_gib=peak,
        replay_ms=replay_ms, kept_launches=kept, prologue=pro_tot,
        sweep=swp_tot, host_syncs_per_block=syncs, busy=busy,
        dead_chunk_ms=dead_ms)
    del rows, step_states, blk, rec, fz, final, dead, dead_graph
    torch.cuda.empty_cache()

    # -- 14b: anim_relight_128_standin_fused2 -----------------------------
    t0 = time.perf_counter()
    scene5 = caustic_glass.scene_around(glass_standin(), dev)
    base5 = tri_mod.to_device(scene5.triangles, dev)
    kw5 = dict(initial_search_radius=0.055, max_depth=5, n_iterations=2,
               photons_per_iteration=65536, device=dev)
    png5 = os.path.join(tmp, "chip_smoke_fused_anim.png")
    step5 = SPPMIntegrator(caustic_glass.build_camera(128, png5), **kw5)
    fz5 = SPPMIntegrator(caustic_glass.build_camera(128, png5),
                         fused_iterations=True, fused_block=2, **kw5)

    def frame(integ, shift):
        caustic_moving.set_frame_lights(scene5, shift)
        return integ.render(scene5, n_iterations=2, geometry=base5,
                            geometry_transform=T.translate(
                                [0.0, 0.002 * shift, 0.0]))

    def timed(fn):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        res = fn()
        z.record()
        torch.cuda.synchronize()
        return a.elapsed_time(z), res

    frame(step5, 0.0)   # warm
    frames = []
    for shift in FUSED_ANIM_SHIFTS:
        s_ms, s_state = timed(lambda: frame(step5, shift))
        reset()
        torch.cuda.reset_peak_memory_stats()
        f_ms, f_state = timed(lambda: frame(fz5, shift))
        peak5 = torch.cuda.max_memory_allocated() / 2**30
        counts5 = kernel_counts()
        row = dict(shift=shift, stepwise_ms=s_ms, fused_ms=f_ms,
                   captures=len(fz5.fused_graphs.captures),
                   run_launches=counts5,
                   pair_totals=fz5.last_pair_totals.tolist(),
                   pair_chunks=fz5.fused_pair_chunks, peak_gib=peak5,
                   same_bits=states_equal(f_state, s_state),
                   gathered=int((f_state.tau.sum(-1) > 0).sum()))
        frames.append(row)
        log("14b", t0, f"frame {shift}: stepwise {s_ms:.2f} ms, fused "
            f"{f_ms:.2f} ms (the view's one block, run eagerly; captures "
            f"{row['captures']}); the fused frame's launches {counts5}; "
            f"pair totals {row['pair_totals']}, K {row['pair_chunks']}; "
            f"peak {peak5:.2f} GiB; same bits {row['same_bits']}; pixels "
            f"with tau > 0 {row['gathered']}; card {card}")
        if not row["same_bits"] or row["captures"] or row["gathered"] <= 0 \
                or counts5["sweep"] <= 0:
            raise AssertionError(f"config-5 fused frame {shift}: {row}")
    busy5 = device_busy("14b", t0, card, "fused frame (eager)",
                        lambda: frame(fz5, FUSED_ANIM_SHIFTS[-1]), f_ms,
                        require=False)
    fz5.save(f_state, 2)
    out["anim_relight_128_standin_fused2"] = dict(
        n_triangles=scene5.n_triangles, frames=frames, busy=busy5)
    log(14, t0, f"whole run so far {time.perf_counter() - t_all:.1f} s")
    return out


# Phase 15: the walk kernel on config 3's 1M-ray SPPM calls.
WALK_SLICE = 65536    # rays of each call held against walk_plain
SPPM_1024_WALK_ITERS = 3   # a warm iteration, then two


def walk_ptxas(logtext: str) -> dict:
    """ptxas's report of each bvh_walk arm: registers, stack frame (the
    local memory a thread holds), spill stores and loads, static shared
    memory, all in bytes but the registers."""
    out, name, frame = {}, None, {}
    for line in logtext.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            w = re.search(r"bvh_walk_kernelILb(\d)ELb(\d)ELb(\d)E",
                          m.group(1))
            arms = zip(("any_hit", "bvh", "stats"), w.groups()) if w else ()
            name = "_".join(["bvh_walk"] + [k for k, b in arms if b == "1"]) \
                if w else None
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = dict(zip(("stack_frame", "spill_stores", "spill_loads"),
                             map(int, m.groups())))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out[name] = dict(registers=int(m.group(1)), **frame,
                             smem=int(smem.group(1)) if smem else 0)
            name = None
    return out


def walk_call_row(wacc, name, o, d, tm, anyh, reps=10):
    """One walk call through the kernel: device ms (graph_ms, ``reps``
    launches), lanes, live lanes, node visits, triangle tests, the longest
    walk, the bound and its share; and the counted run's (t, id, stats,
    seen)."""
    from trace_tpu_torch.ops.bvh_walk import walk_kernel

    kw = dict(any_hit=anyh, limit=wacc.limit, stack_depth=wacc.stack_depth)
    k = walk_marked(wacc, o, d, tm, anyh, wacc.limit)
    row = dict(call=name, lanes=o.shape[0], live=int((tm > 0).sum()),
               visits=int(k[2][0].sum()), tests=int(k[2][1].sum()),
               max_visits=int(k[2][0].max()),
               ms=graph_ms(lambda: walk_kernel(wacc.nodes, wacc.tris, o, d,
                                               tm, **kw), reps))
    row.update(walk_bound(k[2], k[3], wacc.nodes.shape[0], o.shape[0]))
    row["share"] = row["bound_ms"] / row["ms"]
    return row, k


def walk_slice_check(wacc, o, d, tm, anyh, whole):
    """The kernel against walk_plain on the fixed WALK_SLICE rays in the
    middle of a call: t bits, ids, per-ray counts and marks (a launch of
    the slice alone), and the whole call's counted run (``whole``) on the
    same rays against that launch."""
    import torch

    s = max(0, (o.shape[0] - WALK_SLICE) // 2)
    sl = slice(s, s + WALK_SLICE)
    args = (o[sl], d[sl], tm[sl], anyh, wacc.limit)
    k = walk_marked(wacc, *args)
    t1 = time.perf_counter()
    p = walk_marked(wacc, *args, plain=True)
    torch.cuda.synchronize()
    c = walk_compare(k, p)
    c["plain_s"] = time.perf_counter() - t1
    c["whole_call_differs"] = int(
        (whole[0][sl].view(torch.int32) != k[0].view(torch.int32)).sum()
        + (whole[1][sl] != k[1]).sum() + (whole[2][:, sl] != k[2]).sum())
    c["slice"] = [s, s + o[sl].shape[0]]
    return c


def slice15(dev, card, scene, t_all):
    """Phase 15: the walk kernel on mesh1m_sppm_1024_wbvh (module
    docstring). ``scene`` is the 1M mesh_heavy scene on its sweep."""
    import torch
    from trace_tpu_torch.accel import wbvh as W
    from trace_tpu_torch.integrators.fused import kernel_counts
    from trace_tpu_torch.integrators.sppm import SPPMIntegrator
    WhittedIntegrator = eager_whitted
    from trace_tpu_torch.models import mesh_heavy
    from trace_tpu_torch.ops import bvh_walk, intersect
    from trace_tpu_torch.ops.sweep import block_entry_kernel, sweep_kernel
    from trace_tpu_torch.sampler import uniform as U

    def reset():
        for k in (sweep_kernel, block_entry_kernel, bvh_walk.walk_kernel,
                  intersect.intersect_kernel):
            k.reset_counts()

    tmp = tempfile.gettempdir()
    out = dict(ptxas=walk_ptxas(bvh_walk.walk_kernel.lib.build_log))
    t0 = time.perf_counter()
    log("15c", t0, f"walk kernel arms (registers, stack frame, spills, "
        f"smem): {out['ptxas']}")
    # An earlier process's build leaves no log to read (phase 1 builds
    # from source in a fresh checkout).
    if bvh_walk.walk_kernel.lib.build_log and len(out["ptxas"]) != 8:
        raise AssertionError(f"[15c] ptxas reported {len(out['ptxas'])} "
                             f"walk arms, not 8")
    # -- 15a: mesh1m_sppm_1024_wbvh, stepwise then fused ---------------------
    torch.cuda.empty_cache()
    view = scene.with_geometry(scene.triangles, None)
    W.attach(view)
    wacc = view.accel
    n_it = SPPM_1024_WALK_ITERS
    kw = dict(initial_search_radius=0.075, max_depth=8, n_iterations=n_it,
              photons_per_iteration=262144, seed=0, device=dev)
    cam = mesh_heavy.build_camera(1024, os.path.join(
        tmp, "chip_smoke_wbvh_1024.png"))
    integ = SPPMIntegrator(cam, **kw)
    integ.check_scene(view)
    states = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, state = sppm_iterations("15a", t0, card, integ, view, wacc, n_it,
                                  walk=True, states=states)
    step_peak = torch.cuda.max_memory_allocated() / 2**30
    args = (integ._pixel_grid(dev), U.key(integ.seed, dev),
            *integ.light_distribution(view))
    step_busy = NOT_PROFILED
    fz = SPPMIntegrator(cam, fused_iterations=True, fused_block=1, **kw)
    blocks = timed_blocks(fz)
    reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    final = fz.render(view)
    counts = kernel_counts()
    fused_peak = torch.cuda.max_memory_allocated() / 2**30
    del fz._fused_block
    cap = fz.fused_graphs.captures[0]
    same = [states_equal(r["state"], s) for r, s in zip(blocks, states)]
    blk = next(iter(fz.fused_graphs.graphs.values()))
    replay_ms = cuda_ms(blk.graph.replay, 3)
    syncs = replay_syncs(fz, view, blocks[-2]["state"], n_it)
    it_n = torch.full((), n_it, dtype=torch.int64, device=dev)
    fused_busy = device_busy("15a", t0, card, "fused block (replay)",
                             lambda: blk.replay(blocks[-2]["state"], it_n),
                             replay_ms, require=False)
    img = fz.to_image(final, n_it)
    finite = bool(torch.isfinite(img).all())
    gathered = int((final.tau.sum(-1) > 0).sum())
    fz.save(final, n_it)
    log("15a", t0, f"fused_block=1 on wbvh: blocks "
        f"{[(r['it'], round(r['ms'], 2)) for r in blocks]} ms (block 1 "
        f"runs the body eagerly; block 2 holds the capture "
        f"{cap['capture_ms']:.1f} ms, host); the graph's replay alone "
        f"{replay_ms:.2f} ms; launches per replay {cap['launches']}; the "
        f"run's launches {counts}; pair totals "
        f"{[r['totals'] for r in blocks]}, K {blocks[-1]['pair_chunks']}; "
        f"peak {fused_peak:.2f} GiB (stepwise {step_peak:.2f}); each "
        f"block's state == stepwise: {same}; host syncs a block {syncs}; "
        f"finite {finite}, pixels with tau > 0 {gathered}; card {card}")
    if len(blocks) != n_it or not all(same) or syncs != 1 or not finite \
            or gathered <= 0 or cap["launches"]["bvh_walk"] <= 0 \
            or cap["launches"]["sweep"] or counts["sweep"] \
            or len(fz.fused_graphs.captures) != 1:
        raise AssertionError(f"[15a] fused wbvh blocks: same {same}, syncs "
                             f"{syncs}, finite {finite}, gathered "
                             f"{gathered}, launches {cap['launches']}")
    out["mesh1m_sppm_1024_wbvh"] = dict(
        iterations=rows, peak_gib=step_peak, busy=step_busy,
        walk_launches=rows[-1]["walk_launches"])
    out["mesh1m_sppm_1024_wbvh_fused1"] = dict(
        blocks=[{k: v for k, v in r.items() if k != "state"}
                for r in blocks], same_bits=same, capture=cap,
        run_launches=counts, replay_ms=replay_ms, host_syncs_per_block=syncs,
        busy=fused_busy, peak_gib=fused_peak, pixels_gathered=gathered)
    del blocks, states, blk, fz, final, state
    torch.cuda.empty_cache()

    # -- 15b: every walk call of one iteration, and of 12a's frame ----------
    t0 = time.perf_counter()
    one = SPPMIntegrator(cam, **dict(kw, n_iterations=1))
    calls = tagged_walk_calls(one, view)
    whitted = WhittedIntegrator(mesh_heavy.build_camera(256, os.path.join(
        tmp, "chip_smoke_wbvh_256.png")), U.UniformSampler(1, seed=0),
        max_depth=2, pixel_chunk=ONE_CHUNK)
    frame = [(f"whitted {name}", *c) for name, c in zip(
        ("camera", "shadow", "specular", "specular shadow"),
        record_calls(whitted, view))]
    per_call = []
    for name, o, d, tm, anyh in calls + frame:
        row, k = walk_call_row(wacc, name, o, d, tm, anyh)
        if not name.startswith("whitted"):   # 12a holds the frame's calls
            row["vs_plain"] = c = walk_slice_check(wacc, o, d, tm, anyh, k)
            if walk_disagrees(c) or c["t_bits_mismatch"] \
                    or c["whole_call_differs"]:
                raise AssertionError(f"[15b] {name}: the walk kernel "
                                     f"disagrees with plain: {c}")
        per_call.append(row)
        log("15b", t0, f"{row}; card {card}")
    sppm_ms = sum(r["ms"] for r in per_call
                  if not r["call"].startswith("whitted"))
    log("15b", t0, f"the 1024^2 iteration's {len(calls)} walk calls: "
        f"{sppm_ms:.4f} ms of kernel in all; card {card}")
    if not any(c[0].startswith("photon") for c in calls) \
            or calls[0][1].shape[0] != one.n_pixels:
        raise AssertionError(f"[15b] unexpected calls: "
                             f"{[(c[0], c[1].shape[0]) for c in calls]}")
    out["per_call"], out["sppm_1024_walk_ms"] = per_call, sppm_ms
    log(15, t0, f"whole run so far {time.perf_counter() - t_all:.1f} s")
    return out


def mse_of(a, b) -> float:
    return float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))


class SplatRecorder:
    """While a frame renders, keep every chunk splat of its film that
    takes the gather kernel (``Film.add_samples`` with ``lanes`` on the
    card): the state in, p_film, radiance, weight, the GridLanes and the
    state out."""

    def __init__(self, film):
        self.film, self.calls = film, []

    def __enter__(self):
        add = self.film.add_samples

        def record(state, p_film, L, w, valid=None, lanes=None):
            new = add(state, p_film, L, w, valid=valid, lanes=lanes)
            if lanes is not None:
                self.calls.append(dict(state=state, p=p_film, L=L, w=w,
                                       lanes=lanes, out=new))
            return new

        self.film.add_samples = record
        return self

    def __exit__(self, *exc):
        del self.film.add_samples


def check_splats(film, calls) -> dict:
    """Each recorded chunk splat (SplatRecorder) against splat_plain on
    the card and against the lane-order serial reference (the card's own
    footprint entries of the chunk's valid lanes through the CPU's
    deterministic scatter), bit for bit."""
    import torch
    from trace_tpu_torch.core import spectrum as spec
    from trace_tpu_torch.core.math import scatter_add
    from trace_tpu_torch.ops.splat import splat_plain

    k = film.fp_x * film.fp_y
    plain = serial = True
    err = 0.0
    for c in calls:
        s, nv = c["state"], c["lanes"].n_valid
        xyz = spec.rgb_to_xyz(c["L"]) * c["w"][:, None]
        twin = splat_plain(film, s, c["p"], xyz, c["lanes"])
        flat, wf = film.footprint(c["p"][:nv])
        contrib = wf[:, None] * xyz[:nv].repeat_interleave(k, dim=0)
        ref = (scatter_add(s.xyz.cpu().reshape(-1, 3), flat.cpu(),
                           contrib.cpu()).reshape(s.xyz.shape),
               scatter_add(s.weight_sum.cpu().reshape(-1), flat.cpu(),
                           wf.cpu()).reshape(s.weight_sum.shape))
        for got, tw, r in zip(c["out"][:2], twin, ref):
            plain &= torch.equal(got, tw)
            serial &= torch.equal(got.cpu(), r)
            err = max(err, float((got - tw).abs().max()),
                      float((got.cpu() - r).abs().max()))
    return dict(calls=len(calls),
                valid_lanes=sorted({c["lanes"].n_valid for c in calls}),
                plain_equal=plain, serial_equal=serial, max_abs_err=err)


def splat_times(film, calls, reps=50) -> list:
    """Per recorded chunk splat: the kernel graph-timed on its inputs,
    the plain twin with CUDA events, the parent's route on the same
    lanes graph-timed (Film.add_samples' scatter, the padded lanes'
    radiance and weight zeroed: PyTorch's deterministic index_put_), and
    the byte bound (the valid lanes' p_film and xyz read once, the film's
    xyz and weight sum read and written once, the table)."""
    import torch
    from trace_tpu_torch.core import spectrum as spec
    from trace_tpu_torch.ops.splat import splat_kernel, splat_plain

    rows = []
    for c in calls:
        s, p, lanes = c["state"], c["p"], c["lanes"]
        xyz = spec.rgb_to_xyz(c["L"]) * c["w"][:, None]
        v = torch.arange(p.shape[0], device=p.device) < lanes.n_valid
        L0 = torch.where(v[:, None], c["L"], 0.0)
        w0 = torch.where(v, c["w"], 0.0)
        nbytes = (lanes.n_valid * 5 * 4 + film.width * film.height * 4 * 4
                  * 2 + lanes.table.numel() * 4)
        bound_ms, bound_by = bound(0, nbytes)
        ms = graph_ms(lambda: splat_kernel(film, s, p, xyz, lanes), reps)
        rows.append(dict(
            lanes=p.shape[0], valid_lanes=lanes.n_valid, ms=ms,
            plain_ms=cuda_ms(lambda: splat_plain(film, s, p, xyz, lanes),
                             3),
            library_ms=graph_ms(lambda: film.add_samples(s, p, L0, w0,
                                                         valid=v), reps),
            bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
            bound_share=bound_ms / ms))
    return rows


def frame16(integ, scene, rec, time_splats=False):
    """Phase 16a's frame on the frame graph's route: the view's first
    frame (its body run eagerly) with the sweep, prologue and splat
    launches counted from 0 and its chunk splats recorded (SplatRecorder);
    the second, which captures the body and replays it, under ``rec`` (a
    CaptureRecorder of the capture, whose kept launches then hold the
    replay's values) and held against plain; the graph's launches a
    replay (its capture record) held equal to the first frame's, and the
    replay bit-equal to it; each recorded splat against splat_plain and
    the serial reference (check_splats), and with ``time_splats`` timed
    (splat_times); then the graph and the records dropped (it was
    captured around the recorder's tensors) and the route timed afresh,
    two warm frames and two replays, peak GiB over them -> (row, last
    state)."""
    import torch
    from trace_tpu_torch.ops.splat import splat_kernel
    from trace_tpu_torch.ops.sweep import block_entry_kernel, sweep_kernel

    film = integ.camera.film
    sweep_kernel.reset_counts()
    block_entry_kernel.reset_counts()
    splat_kernel.reset_counts()
    with SplatRecorder(film) as splats:
        first = integ.render(scene)
    eager = dict(sweep=sweep_kernel.launches,
                 prologue=block_entry_kernel.launches,
                 splat=splat_kernel.launches)
    with rec:
        second = integ.render(scene)
    torch.cuda.synchronize()
    pro, swp, kept = rec.check()
    rec.calls = []
    replay = {k: integ.frame_graphs.captures[-1]["launches"][k]
              for k in eager}
    bit_equal = all(torch.equal(x, y) for x, y in zip(first, second))
    del first, second
    integ.frame_graphs = None
    splat = check_splats(film, splats.calls)
    if time_splats:
        splat["times"] = splat_times(film, splats.calls)
    del splats
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times, state = timed_frames(integ, scene, n=2)
    return dict(frame_ms=times, ms=float(np.mean(times)), launches=replay,
                first_frame_launches=eager, replay_bit_equal=bit_equal,
                prologue=pro, sweep=swp, kept_launches=len(kept),
                dead_launches=sum(r["live"] == 0 for r in kept),
                splat=splat, peak_gib=torch.cuda.max_memory_allocated()
                / 2**30, useful_rays=integ.last_useful_rays,
                queue_drops=integ.last_queue_drops), state


def fused16(phase, t0, card, scene, integ_of, n_it, label, stats=None):
    """Phase 16c on one scene: ``n_it`` stepwise iterations, then the same
    through fused blocks of one iteration (a block whose pairs overflow
    an instance walk's buffer runs again stepwise); each block's state
    against the stepwise state of its iteration, one host sync a block,
    the replay's ms and launches; then after a bumped scene version the
    view's second block must capture anew. ``stats``: the clusters
    accelerator's, read over the stepwise run and over the fused one (its
    captures)."""
    import torch
    from trace_tpu_torch.integrators.fused import kernel_counts

    stages = {}
    if stats is not None:
        stats.clear()
    step = integ_of(fused_iterations=False)
    step_ms, step_states, _, _ = stepwise_iterations(step, scene, n_it)
    fz = integ_of(fused_iterations=True, fused_block=1)
    if stats is not None:
        stages["stepwise"] = dict(stats)
        stats.clear()
    rows = timed_blocks(fz)
    final = fz.render(scene)
    if stats is not None:
        stages["fused"] = dict(stats)
    del fz._fused_block
    same = [states_equal(r["state"], s) for r, s in zip(rows, step_states)]
    graphs = fz.fused_graphs
    caps = [dict(c) for c in graphs.captures]
    blk = list(graphs.graphs.values())[-1]
    replay_ms = cuda_ms(blk.graph.replay, 3)
    syncs = replay_syncs(fz, scene, rows[-2]["state"], n_it)
    busy = NOT_PROFILED
    n_caps = len(graphs.captures)
    scene.bump_version()
    fz.render(scene, n_iterations=2)   # eager, then captured
    recaptured = len(graphs.captures) - n_caps
    finite = bool(torch.isfinite(fz.to_image(final, n_it)).all())
    row = dict(stepwise_ms=step_ms,
               blocks=[dict(it=r["it"], ms=r["ms"], totals=r["totals"],
                            pair_chunks=r["pair_chunks"]) for r in rows],
               same_bits=same, captures=caps, replay_ms=replay_ms,
               reruns=fz.fused_reruns,
               pair_capacity=[fz.fused_pair_capacity.get(g)
                              for g in scene.instanced],
               stages=stages, host_syncs_per_block=syncs, busy=busy,
               recaptured_after_bump=recaptured, finite=finite,
               run_launches=kernel_counts())
    log(phase, t0, f"{label}: stepwise {[round(x, 2) for x in step_ms]} "
        f"ms; fused blocks {[(r['it'], round(r['ms'], 2)) for r in rows]} "
        f"ms, overflow reruns {fz.fused_reruns} (instance pair capacity "
        f"{row['pair_capacity']}), cluster stages {stages}, captures "
        f"{[(c['capture_ms'], c['launches']) for c in caps]}"
        f"; the replay alone {replay_ms:.2f} ms; each block == stepwise "
        f"{same}; host syncs a block {syncs}; recaptures after "
        f"bump_version {recaptured}; finite {finite}; card {card}")
    multi = True
    if stats is not None:
        # Several stages a call; stepwise, some call stopped early, and
        # every fused call ran them all.
        st, fu = stages["stepwise"], stages["fused"]
        multi = (st["most_stages"] == fu["most_stages"] > 1
                 and st["stages"] < st["calls"] * st["most_stages"]
                 and fu["stages"] == fu["calls"] * fu["most_stages"])
    if len(rows) != n_it or not all(same) or syncs != 1 \
            or recaptured != 1 or not finite or not caps or not multi:
        raise AssertionError(f"[{phase}] {label}: {row}")
    return row


# Phase 16d: the matmul route's t against intersect.cu's, relative. The
# routes sum the same f32 products in other orders (cuBLAS chains FMAs);
# the gap read 1.147e-6 at most on an H100 80GB HBM3 at 700 W (PERF.md).
REL_T_GATE = 2e-6


def slice16(dev, card, scene, replay_1024_ms, t_all):
    """Phase 16: the last public signatures of the JAX package on the
    card (module docstring). ``scene`` is the 1M mesh_heavy scene on its
    sweep; ``replay_1024_ms`` phase 14a's replay of a config-3 block."""
    import torch
    from trace_tpu_torch.accel import clusters as C
    from trace_tpu_torch.accel import mxu
    from trace_tpu_torch.integrators.sppm import SPPMIntegrator
    from trace_tpu_torch.integrators.whitted import WhittedIntegrator
    from trace_tpu_torch.models import mesh_heavy
    from trace_tpu_torch.ops import intersect as TI
    from trace_tpu_torch.sampler import uniform as U
    from trace_tpu_torch.shapes import triangle as tri_mod

    tmp = tempfile.gettempdir()
    out = {}
    n_lights = int(scene.lights.kind.shape[0])

    # -- 16a: bench config 4 with its own arguments --------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    cfg4 = dict(pixel_chunk=1 << 16, spp_per_dispatch=1)
    frames, states = {}, {}
    for res, spp in ((256, 1), (512, 4)):
        name = f"mesh1m_whitted_{res}_{spp}spp"
        cam = mesh_heavy.build_camera(res, os.path.join(
            tmp, f"chip_smoke_cfg4_{res}.png"))
        integ = WhittedIntegrator(cam, U.UniformSampler(spp, seed=0),
                                  max_depth=2, **cfg4)
        if not integ.replays(scene):
            raise AssertionError(f"[16a] {name}: not the frame graph's "
                                 f"route")
        # Every launch of the 256^2 graph (its dead chunks too), every
        # CAPTURE_STRIDE-th of the 512^2 one.
        stride = 1 if res == 256 else CAPTURE_STRIDE
        row, states[res] = frame16(integ, scene, CaptureRecorder(stride),
                                   time_splats=res == 256)
        n_pix = n_pix_of(cam)
        row["lanes"], row["chunks"] = n_pix, -(-n_pix // (1 << 16))
        row["workload_mrays"] = (n_pix * spp * (1 + n_lights) * 2
                                 / row["ms"] / 1e3)
        frames[name] = row
        log("16a", t0, f"{name} (pixel_chunk 1 << 16, spp_per_dispatch 1: "
            f"{n_pix} lanes in {row['chunks']} chunks x {spp} samples), "
            f"the frame graph's route: replays "
            f"{[round(x, 2) for x in row['frame_ms']]} ms (mean "
            f"{row['ms']:.2f}, after the view's eager frame and its "
            f"capture); launches a replay {row['launches']} (the eager "
            f"first frame's {row['first_frame_launches']}); the capture's "
            f"replay bit-equal to the first frame {row['replay_bit_equal']};"
            f" peak {row['peak_gib']:.3f} GiB; useful_rays "
            f"{row['useful_rays']}, queue_drops {row['queue_drops']}; "
            f"workload {row['workload_mrays']:.3f} Mrays/s; every "
            f"{stride}th captured sweep launch and the last "
            f"({row['kept_launches']}, {row['dead_launches']} with no live "
            f"lane) vs plain: prologue {row['prologue']}, sweep "
            f"{row['sweep']}; card {card}")
        sp = row["splat"]
        log("16a", t0, f"{name}: the first frame's {sp['calls']} chunk "
            f"splats through the gather kernel (valid lanes "
            f"{sp['valid_lanes']}; launches "
            f"{row['first_frame_launches']['splat']}, a replay "
            f"{row['launches']['splat']}): bit-equal "
            f"to splat_plain {sp['plain_equal']}, to the serial reference "
            f"{sp['serial_equal']}, max abs err {sp['max_abs_err']:.3e}"
            + "".join(f"; chunk of {t['valid_lanes']} valid lanes: kernel "
                      f"{t['ms']:.4f} ms graph-timed, plain "
                      f"{t['plain_ms']:.3f}, the scatter {t['library_ms']:.4f}"
                      f", bound {t['bound_ms']:.5f} ({t['bound_by']}, "
                      f"{100 * t['bound_share']:.1f}%)"
                      for t in sp.get("times", ())) + f"; card {card}")
        if row["queue_drops"] != 0 or row["launches"]["sweep"] <= 0 or \
                row["launches"]["prologue"] != row["launches"]["sweep"] or \
                row["launches"] != row["first_frame_launches"] or \
                not row["replay_bit_equal"]:
            raise AssertionError(f"[16a] {name}: {row}")
        if row["launches"]["splat"] != row["chunks"] * spp \
                or sp["calls"] != row["chunks"] * spp \
                or not (sp["plain_equal"] and sp["serial_equal"]):
            raise AssertionError(f"[16a] {name}: chunk splats: {sp}, "
                                 f"launches {row['launches']}")
        if prologue_disagrees(row["prologue"]) or disagrees(row["sweep"]) \
                or row["sweep"]["t_bits_mismatch"] \
                or row["kept_launches"] < min(2, row["launches"]["sweep"]) \
                or (stride == 1 and row["kept_launches"]
                    != row["launches"]["sweep"]):
            raise AssertionError(f"[16a] {name}: captured launches "
                                 f"disagree: {row}")
    # The 512^2 frame as one chunk: the same image but for the splat's
    # summation order (the grid stencil against the scatter).
    cam = mesh_heavy.build_camera(512, os.path.join(tmp, "chip_smoke_"
                                                    "cfg4_512_one.png"))
    one = WhittedIntegrator(cam, U.UniformSampler(4, seed=0), max_depth=2,
                            pixel_chunk=ONE_CHUNK)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    a.record()
    st_one = one.render(scene)
    z.record()
    torch.cuda.synchronize()
    img_c, img_o = image(one, states[512]), image(one, st_one)
    cmp512 = dict(one_chunk_ms=a.elapsed_time(z),
                  one_chunk_peak_gib=torch.cuda.max_memory_allocated()
                  / 2**30, mse=mse_of(img_c, img_o),
                  max_abs=float(np.abs(img_c - img_o).max()),
                  one_chunk_queue_drops=one.last_queue_drops)
    chunked_gib = frames["mesh1m_whitted_512_4spp"]["peak_gib"]
    log("16a", t0, f"512^2 chunked vs one chunk: MSE {cmp512['mse']:.3e} "
        f"(gate 1e-8), max abs {cmp512['max_abs']:.3e}; the one-chunk "
        f"frame {cmp512['one_chunk_ms']:.2f} ms (one, with its first "
        f"use of the shape), peak {cmp512['one_chunk_peak_gib']:.3f} GiB "
        f"against the chunked {chunked_gib:.3f}")
    if not (cmp512["mse"] < 1e-8 and np.isfinite(img_c).all()
            and one.last_queue_drops == 0):
        raise AssertionError(f"[16a] chunked vs one chunk: {cmp512}")
    one.camera.film.save_png(states[512])
    # 16b's Whitted sort_materials on the 256^2 frame.
    cam = mesh_heavy.build_camera(256, "unused.png")
    srt = WhittedIntegrator(cam, U.UniformSampler(1, seed=0), max_depth=2,
                            pixel_chunk=1 << 16, sort_materials=True)
    st_srt = srt.render(scene)
    img_u, img_s = image(srt, states[256]), image(srt, st_srt)
    sort = dict(bit_equal=all(torch.equal(x, y)
                              for x, y in zip(st_srt, states[256])),
                mse=mse_of(img_u, img_s),
                max_abs=float(np.abs(img_u - img_s).max()),
                queue_drops=(frames["mesh1m_whitted_256_1spp"]["queue_drops"],
                             srt.last_queue_drops))
    log("16b", t0, f"256^2 sort_materials=True vs False: bit-equal "
        f"{sort['bit_equal']}, MSE {sort['mse']:.3e} (gate 1e-8), max abs "
        f"{sort['max_abs']:.3e}; queue_drops {sort['queue_drops']}")
    if sort["mse"] >= 1e-8 or any(sort["queue_drops"]):
        raise AssertionError(f"[16b] sort {sort}")
    out.update(frames, chunked_vs_one_chunk_512=cmp512, sort_materials=sort)
    del states, st_one, st_srt
    log("16a", t0, f"whole run so far {time.perf_counter() - t_all:.1f} s")

    # -- 16c: fused SPPM blocks on instanced and clusters scenes -------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    inst = standin_scene(dev, 10)
    png = os.path.join(tmp, "chip_smoke_inst100_fused.png")
    kw = dict(initial_search_radius=0.3, max_depth=5, n_iterations=3,
              photons_per_iteration=65536, seed=0, device=dev)
    out["inst100_sppm_256_fused1"] = fused16(
        "16c", t0, card, inst, lambda **k: SPPMIntegrator(
            standin_camera(256, png), **kw, **k), 3, "inst100_sppm_256")
    del inst
    torch.cuda.empty_cache()
    # Stage 16, so a call sweeps its clusters in several stages.
    clus = C.attach(mesh_heavy.build_scene(5000, device=dev), leaf_tris=64,
                    stage_clusters=16)
    assert isinstance(clus.accel, C.ClusterAccelerator)
    cam = mesh_heavy.build_camera(256, os.path.join(
        tmp, "chip_smoke_clusters_fused.png"))
    out["mesh5k_sppm_256_clusters_fused1"] = fused16(
        "16c", t0, card, clus, lambda **k: SPPMIntegrator(cam, **kw, **k),
        3, "mesh5k_sppm_256 on clusters (stage 16)", stats=clus.accel.stats)
    del clus
    log("16c", t0, f"whole run so far {time.perf_counter() - t_all:.1f} s")

    # -- 16d: mxu.attach beside intersect.cu -------------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    small = TI.attach(mesh_heavy.build_scene(5000, device=dev))
    fa = small.accel
    calls = record_calls(WhittedIntegrator(
        mesh_heavy.build_camera(256, "unused.png"),
        U.UniformSampler(1, seed=0), max_depth=2, pixel_chunk=ONE_CHUNK),
        small)
    o, d, tm, _ = calls[0]
    rays, _ = TI.pack_rays(o, d, tm)
    ro, rd, rt = rays[0:3].T.contiguous(), rays[3:6].T.contiguous(), rays[9]
    macc = mxu.MXUAccelerator(mxu.build_consts(tri_mod.to_numpy(
        small.triangles)), small.n_triangles, device=dev)
    kt, ki = TI.intersect_kernel(rays, fa.tris, fa.ids)
    mh, mt, mi = macc.intersect(ro, rd, rt, False)
    torch.cuda.synchronize()
    kh = ki >= 0
    both = kh & mh
    # t's certified error bound (accel/mxu.py::MT_ERR_EPS, first order):
    # (err_t + |t| err_det) / |det| for the kernel's triangle, in f64.
    # The routes round the cancelling o.n - v0.n in different orders
    # (cuBLAS contracts FMAs, the kernel is built with --fmad=false).
    idx = ki[both].long()
    c = [x.double() for x in macc.consts]
    bo, bd = ro[both].double(), rd[both].double()
    n_t = c[0].T[idx]
    det = -(bd * n_t).sum(1)
    err_t = mxu.MT_ERR_EPS * ((bo.abs() * n_t.abs()).sum(1)
                              + c[5][idx].abs())
    err_det = mxu.MT_ERR_EPS * (bd.abs() * n_t.abs()).sum(1)
    t_ref = ((bo * n_t).sum(1) - c[5][idx]) / det
    bnd = (err_t + t_ref.abs() * err_det) / det.abs()
    gap = (kt[both].double() - mt[both].double()).abs()
    id_apart = both & (ki != mi)
    ties = 0
    # An id apart is a tie when the other triangle's t equals the
    # kernel's best within the bound: either is the closest.
    if bool(id_apart.any()):
        _, t_other = mxu.intersect_grid(macc.consts, ro[id_apart],
                                        rd[id_apart], rt[id_apart])
        t_k = t_other.gather(1, ki[id_apart].long()[:, None])[:, 0]
        ties = int(((t_k - mt[id_apart]).abs().double()
                    <= 2 * bnd[id_apart[both]]).sum())
    # The gap's cause: each route's four dot products on every pair
    # redone on the kernel's triangle, as a chain of FMAs over k = 0, 1,
    # 2 (each step exact in f64 and rounded once to f32: what cuBLAS's
    # f32 GEMM does) and as the kernel's left-to-right sum of rounded
    # products (torch's elementwise ops, one rounding each), then the
    # same epilogue; held to the matmul route's and the kernel's t bits.
    col = lambda x: x.T[idx]
    c32 = macc.consts
    po, pd, pm = ro[both], rd[both], rays[6:9].T[both]

    def dot(a, b, fma):
        if not fma:
            return (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]) + a[:, 2] * b[:, 2]
        acc = a[:, 0] * b[:, 0]
        for k in (1, 2):
            acc = (a[:, k].double() * b[:, k].double()
                   + acc.double()).float()
        return acc

    def t_redone(fma):
        det = -dot(pd, col(c32.n), fma)
        u_det = dot(pm, col(c32.e2), fma) - dot(pd, col(c32.w), fma)
        v_det = -dot(pm, col(c32.e1), fma) - dot(pd, col(c32.q), fma)
        t_det = dot(po, col(c32.n), fma) - c32.v0n[idx]
        return mxu.mt_epilogue(det, u_det, v_det, t_det)[1]

    same_t = lambda a, b: float((a == b).double().mean())
    agree = dict(lanes=int(rays.shape[1]), hits=int(kh.sum()),
                 fma_chain_equals_mxu=same_t(t_redone(True), mt[both]),
                 sum_equals_kernel=same_t(t_redone(False), kt[both]),
                 hit_mismatch=int((kh != mh).sum()),
                 max_rel_t=float((gap / t_ref.abs()).max()),
                 max_gap_over_bound=float((gap / (2 * bnd)).max()),
                 kernel_over_bound=float(((kt[both].double() - t_ref).abs()
                                          / bnd).max()),
                 mxu_over_bound=float(((mt[both].double() - t_ref).abs()
                                       / bnd).max()),
                 ids_apart=int(id_apart.sum()),
                 untied_ids_apart=int(id_apart.sum()) - ties)
    k_ms = graph_ms(lambda: TI.intersect_kernel(rays, fa.tris, fa.ids), 5)
    torch.cuda.empty_cache()
    m_ms = graph_ms(lambda: macc.intersect(ro, rd, rt, False), 2)
    torch.cuda.empty_cache()
    golden = np.load(GOLDEN)
    g_sc = mxu.attach(mesh_heavy.build_scene(5000, device=dev))
    cam32 = mesh_heavy.build_camera(32, os.path.join(tmp, "chip_smoke_32_"
                                                     "mxu.png"))
    it32 = WhittedIntegrator(cam32, U.UniformSampler(1, seed=0), max_depth=2)
    g_img = image(it32, it32.render(g_sc))
    g_mse = mse_of(g_img, golden)
    out["mxu_vs_intersect"] = dict(agreement=agree, intersect_graph_ms=k_ms,
                                   mxu_graph_ms=m_ms, golden_mse=g_mse)
    log("16d", t0, f"row 6's call ({rays.shape[1]} rays x "
        f"{small.n_triangles} triangles): mxu.MXUAccelerator vs "
        f"csrc/intersect.cu {agree} (gates: hits and untied ids equal; "
        f"t within {REL_T_GATE} relative; each route's t within t's "
        f"certified error bound of the f64 t, so the two within twice it; "
        f"the dot products redone as FMA chains give the matmul route's "
        f"t bits on a fma_chain_equals_mxu share of the pairs, and as "
        f"sums of rounded products the kernel's on sum_equals_kernel); "
        f"graph-timed intersect.cu "
        f"{k_ms:.4f} ms, the matmul route {m_ms:.4f} ms (library); the 5k "
        f"golden 32^2 through mxu.attach: MSE {g_mse:.3e} (gate "
        f"{MSE_GATE}); card {card}")
    if agree["hit_mismatch"] or agree["untied_ids_apart"] \
            or agree["max_rel_t"] > REL_T_GATE \
            or agree["kernel_over_bound"] > 1 or agree["mxu_over_bound"] > 1 \
            or not g_mse < MSE_GATE or agree["hits"] < 1000:
        raise AssertionError(f"[16d] {out['mxu_vs_intersect']}")
    del small, g_sc, macc
    torch.cuda.empty_cache()

    # -- 16e: fused_cost_analysis on mesh1m_sppm_1024_fused1 ----------------
    t0 = time.perf_counter()
    fz = SPPMIntegrator(mesh_heavy.build_camera(1024, "unused.png"),
                        initial_search_radius=0.075, max_depth=8,
                        n_iterations=FUSED_1024_ITERS,
                        photons_per_iteration=262144, seed=0,
                        fused_iterations=True, fused_block=1, device=dev)
    ca = fz.fused_cost_analysis(scene, 1)
    sec = replay_1024_ms / 1e3
    shares = dict(flops=ca["flops"] / sec / PEAK_F32,
                  bytes=ca["bytes accessed"] / sec / PEAK_HBM)
    out["fused_cost_analysis_1024"] = dict(cost=ca, replay_ms=replay_1024_ms,
                                           shares=shares)
    log("16e", t0, f"fused_cost_analysis(scene, 1) at config 3's settings: "
        f"flops {ca['flops']:.4e}, bytes {ca['bytes accessed']:.4e} "
        f"(per phase {ca['phases']}); over phase 14a's replay "
        f"{replay_1024_ms:.2f} ms: {100 * shares['flops']:.4f}% of the FP32 "
        f"peak ({PEAK_F32:.3e}/s), {100 * shares['bytes']:.3f}% of HBM "
        f"({PEAK_HBM:.3e} B/s); card {card}")
    if not (0 < shares["flops"] <= 1 and 0 < shares["bytes"] <= 1):
        raise AssertionError(f"[16e] shares of peak {shares}")
    log(16, t0, f"whole run so far {time.perf_counter() - t_all:.1f} s")
    return out


# Phase 17: bench config 6 (bench.py:934-1033), its legs in order: the
# sweep at the JAX package's tiling, clusters in supers of 32, the flat
# clusters, then the port's default tiling on the same clusters.
CONFIG6_TRIS = 16_000_000
CONFIG6_LEGS = (
    ("sweep_g64_b128", dict(anim_block_rays=128, anim_ray_chunk=8192,
                            anim_stage_clusters=None)),
    ("clusters_super32", dict(anim_block_rays=None, anim_ray_chunk=16384,
                              anim_stage_clusters=128)),
    ("clusters_flat_chunk2048", dict(anim_block_rays=None,
                                     anim_ray_chunk=2048,
                                     anim_stage_clusters=128)),
    ("sweep_g8_b32", dict(anim_block_rays=None, anim_ray_chunk=None,
                          anim_stage_clusters=None)),
)
# The plain prologue's rays a piece at 16M (a [4096, 31,250] entry table
# is 512 MB a temporary).
PROLOGUE_PIECE = 4096


class TablePointers:
    """While entered, the data pointers of the tables every accelerator
    call reads (the sweep's panel, the clusters' MT rows)."""

    def __enter__(self):
        from trace_tpu_torch.accel.clusters import ClusterAccelerator
        from trace_tpu_torch.ops.sweep import SweepAccelerator

        self.ptrs = set()
        self.saved = [(c, c.intersect) for c in (SweepAccelerator,
                                                 ClusterAccelerator)]
        ptrs = self.ptrs

        def wrap(fn, table):
            def intersect(acc, *a):
                ptrs.add(table(acc).data_ptr())
                return fn(acc, *a)
            return intersect

        SweepAccelerator.intersect = wrap(SweepAccelerator.intersect,
                                          lambda a: a.panel)
        ClusterAccelerator.intersect = wrap(
            ClusterAccelerator.intersect, lambda a: a.dev_clusters.packed_mt)
        return self

    def __exit__(self, *exc):
        for c, fn in self.saved:
            c.intersect = fn


def leg17(phase, t0, card, scene, tris, accel, knobs, n_rays, stride,
          launch_times=False, n_timed=2):
    """One leg of config 6: the scene's knobs set, one warm frame (with a
    ``stride``, every stride-th sweep launch, and the last, kept with its
    prologue) with the launches counted from 0, then ``n_timed`` frames
    timed with CUDA events; peak GiB over them all; the table pointers
    every call read. With ``launch_times``, the warm frame's sweep launches and
    their prologues replayed, each kind as one CUDA graph: their ms a
    frame (graph_ms). -> (row, image)."""
    import torch
    WhittedIntegrator = eager_whitted
    from trace_tpu_torch.models import mesh_heavy
    from trace_tpu_torch.ops.sweep import (block_entry_kernel, kernel_tiled,
                                           sweep_kernel)
    from trace_tpu_torch.sampler import uniform as U

    for k, v in knobs.items():
        setattr(scene, k, v)
    scene.bump_version()
    cam = mesh_heavy.build_camera(256, os.path.join(
        tempfile.gettempdir(), "chip_smoke_mesh16m.png"))
    integ = WhittedIntegrator(cam, U.UniformSampler(1, seed=0), max_depth=2,
                              pixel_chunk=1 << 16)
    kw = dict(geometry=tris, geometry_accel=accel)
    sweep_kernel.reset_counts()
    block_entry_kernel.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = CaptureRecorder(stride, capture_only=False,
                          keep_all=launch_times) if stride else None
    with TablePointers() as tp:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        if rec is None:
            integ.render(scene, **kw)
        else:
            with rec:
                integ.render(scene, **kw)
        b.record()
        torch.cuda.synchronize()
        warm_ms = a.elapsed_time(b)
        launches = dict(sweep=sweep_kernel.launches,
                        tiled=sweep_kernel.tiled_launches,
                        prologue=block_entry_kernel.launches)
        times, state = [], None
        for _ in range(n_timed):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            state = integ.render(scene, **kw)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
    ms = float(np.mean(times))
    row = dict(warm_ms=warm_ms, frame_ms=times, ms=ms, launches=launches,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               useful_rays=integ.last_useful_rays,
               queue_drops=integ.last_queue_drops,
               workload_mrays=n_rays / ms / 1e3,
               useful_mrays=integ.last_useful_rays / ms / 1e3,
               table_pointers=len(tp.ptrs))
    cached = scene.geometry_cache
    if cached is not None and hasattr(cached[2], "stats"):
        row["cluster_stats"] = dict(cached[2].stats)
    if rec is not None and launch_times:
        every = rec.every
        rec.every = None

        def sweeps():
            for _, a, k in every:
                sweep_kernel(*a, **k)

        def prologues():
            for pa, _, _ in every:
                block_entry_kernel(*pa)

        n_tiled = sum(kernel_tiled(a[4], a[3].shape[2]) for _, a, _ in every)
        row["launch_ms"] = dict(launches=len(every), tiled=n_tiled,
                                sweep_ms=graph_ms(sweeps, 2),
                                prologue_ms=graph_ms(prologues, 2))
        del every
    if rec is not None:
        pro, swp, kept = rec.check(piece=PROLOGUE_PIECE)
        row.update(prologue=pro, sweep=swp, kept_launches=len(kept))
    img = image(integ, state)
    return row, img


def slice17(dev, card, t_all):
    """Phase 17: bench config 6, ``mesh16m_whitted_256``, with its own
    arguments (module docstring). Returns the phase's record."""
    import torch
    from trace_tpu_torch.accel import clusters as TC
    from trace_tpu_torch.models import mesh_heavy
    from trace_tpu_torch.ops import sweep as TS
    from trace_tpu_torch.shapes import triangle as tri_mod

    out = {}
    # -- 17a: the scene and its tables (bench.py's keys) --------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    scene = mesh_heavy.build_scene(CONFIG6_TRIS, device=dev, use_bvh=False)
    gen_s = time.perf_counter() - t0
    tris = scene.triangles_host
    t1 = time.perf_counter()
    acc = TC.build_clusters(tris, leaf_tris=64, super_size=32)
    build_s = time.perf_counter() - t1
    table_mb = sum(np.asarray(x).nbytes for x in (
        acc.packed_mt, acc.tri_id, acc.c_lo, acc.c_hi, acc.s_lo,
        acc.s_hi)) / 1e6
    t1 = time.perf_counter()
    sweep = TS.SweepAccelerator(acc, dev, group=64, block_rays=128,
                                ray_chunk=8192)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t1
    # The triangles go to the card once; every frame's view reads them.
    tris_dev = tri_mod.to_device(tris, dev)
    n_lights = int(scene.lights.kind.shape[0])
    cam = mesh_heavy.build_camera(256, "unused.png")
    n_rays = n_pix_of(cam) * 1 * (1 + n_lights) * 2
    out.update(n_tris=int(scene.n_triangles), gen_s=gen_s, build_s=build_s,
               pack_s=pack_s, table_mb=table_mb,
               n_clusters=int(acc.tri_id.shape[0]),
               n_supers_32=int(acc.s_lo.shape[0]),
               n_supers_g64=int(sweep.tables.n_supers),
               workload_rays=n_rays)
    log("17a", t0, f"mesh_heavy at {scene.n_triangles} triangles: gen "
        f"{gen_s:.2f} s, SAH clusters {acc.tri_id.shape[0]} (supers of 32: "
        f"{acc.s_lo.shape[0]}) build {build_s:.2f} s, sweep tables at group "
        f"64 ({sweep.tables.n_supers} supers, GL {sweep.tables.gl_pad}) "
        f"packed and on the card {pack_s:.2f} s, table_mb {table_mb:.1f}")

    # -- 17b: the legs ----------------------------------------------------
    flat = TC.ClusterAccel(acc.c_lo, acc.c_hi, acc.c_lo, acc.c_hi,
                           acc.packed, acc.packed_mt, acc.tri_id,
                           acc.leaf_tris, 1)
    accels = {"sweep_g64_b128": sweep, "clusters_super32": acc,
              "clusters_flat_chunk2048": flat}
    legs, images = {}, {}
    for name, knobs in CONFIG6_LEGS:
        t0 = time.perf_counter()
        scene.geometry_cache = None
        torch.cuda.empty_cache()
        if name == "sweep_g8_b32":
            del sweep, accels
            accels = {name: TS.SweepAccelerator(acc, dev)}
        sample = name.startswith("sweep")
        # Every 32nd launch; leg (a)'s 20-odd launches every 4th, so that
        # launches with hits are among them (the first chunks of the
        # sorted camera rays miss the terrain).
        stride = (4 if name == "sweep_g64_b128" else CAPTURE_STRIDE) \
            if sample else None
        row, images[name] = leg17("17b", t0, card, scene, tris_dev,
                                  accels[name], knobs, n_rays, stride,
                                  launch_times=name == "sweep_g64_b128",
                                  n_timed=1 if name == "clusters_super32"
                                  else 2)
        row["knobs"] = knobs
        legs[name] = row
        log("17b", t0, f"{name}: frames {row['warm_ms']:.1f} (warm), "
            f"{[round(x, 2) for x in row['frame_ms']]} ms, mean "
            f"{row['ms']:.2f} ms, {row['workload_mrays']:.4f} Mrays/s "
            f"(useful {row['useful_mrays']:.4f}), launches "
            f"{row['launches']}, peak {row['peak_gib']:.2f} GiB, "
            f"useful_rays {row['useful_rays']}, queue_drops "
            f"{row['queue_drops']}, table pointers {row['table_pointers']}"
            + (f", stages {row['cluster_stats']}" if "cluster_stats" in row
               else "")
            + (f"; sampled launches {row['kept_launches']}: prologue "
               f"{row['prologue']}, sweep {row['sweep']}" if sample else "")
            + (f"; its {row['launch_ms']['launches']} sweep launches "
               f"({row['launch_ms']['tiled']} tiled) replayed: "
               f"{row['launch_ms']['sweep_ms']:.3f} ms a frame, their "
               f"prologues {row['launch_ms']['prologue_ms']:.3f} ms"
               if "launch_ms" in row else "")
            + f"; card {card}")
        bad = row["queue_drops"] != 0 or row["table_pointers"] != 1 \
            or not np.isfinite(images[name]).all() \
            or (images[name] > 0).any(-1).mean() < 0.05
        if sample:
            bad = bad or row["launches"]["sweep"] <= 0 \
                or row["launches"]["prologue"] != row["launches"]["sweep"] \
                or prologue_disagrees(row["prologue"]) \
                or disagrees(row["sweep"]) \
                or row["sweep"]["t_bits_mismatch"] \
                or row["kept_launches"] < 2 or row["sweep"]["n_found"] <= 0
            bad = bad or (row["launches"]["tiled"] != (
                row["launches"]["sweep"] if name == "sweep_g64_b128" else 0))
        if bad:
            raise AssertionError(f"[17b] {name}: {row}")
    names = list(images)
    mses = {f"{a}|{b}": mse_of(images[a], images[b])
            for i, a in enumerate(names) for b in names[i + 1:]}
    worst = max(mses.values())
    log("17b", t0, f"legs' images: MSE {mses}; the largest {worst:.3e} "
        f"(gate {MSE_GATE})")
    if worst >= MSE_GATE:
        raise AssertionError(f"[17b] the legs' images differ: {mses}")
    out.update(legs=legs, image_mse=mses, image_mse_max=worst)

    # -- 17c: the prologue at blocks of 128 and 512 rays, 3,906 and ~31,250
    # supers -------------------------------------------------------------
    t0 = time.perf_counter()
    scene.geometry_cache = None
    torch.cuda.empty_cache()
    o, d = (x.arr() for x in camera_rays(cam, dev)[:2])
    tm = torch.full((o.shape[0],), float("inf"), device=dev)
    pro17, hit = {}, None
    for g in (64, 8):
        sa = TS.SweepAccelerator(acc, dev, group=g)
        if hit is None:   # the rays that reach the terrain
            hit = sa.intersect(o, d, tm, False)[0]
        perm = sa.coherence_order(o, d, tm)
        on = perm[hit[perm]]
        mid = on.shape[0] // 2
        sel = on[max(mid - 4096, 0):mid + 4096]
        for b in (128, 512):
            sab = sa.view(block_rays=b)
            args = (sab.s_lo, sab.s_hi, *sab.pad_rays(o[sel], d[sel],
                                                       tm[sel]), b)
            po, ps = plain_prologue_pieces(args, PROLOGUE_PIECE)
            fin = torch.isfinite(ps).sum(dim=1)
            # At its shared-memory capacity, then at 64 keys a row, so
            # that most rows sort in the global workspace.
            for cap in (TS.PROLOGUE_KEYS, 64):
                ko, ks = TS.block_entry_kernel(*args, key_capacity=cap)
                torch.cuda.synchronize()
                row = dict(supers=int(sa.tables.n_supers), key_capacity=cap,
                           order_mismatch=int((ko != po).sum()),
                           suffix_bits_mismatch=int((
                               ks.view(torch.int32)
                               != ps.view(torch.int32)).sum()),
                           max_finite_in_row=int(fin.max()),
                           workspace_rows=int((fin > cap).sum()))
                pro17[f"{sa.tables.n_supers}x{b}_cap{cap}"] = row
                log("17c", t0, f"prologue kernel at {row['supers']} supers, "
                    f"block {b}, {sel.numel()} camera rays: {row}")
                if row["order_mismatch"] or row["suffix_bits_mismatch"] \
                        or not row["max_finite_in_row"]:
                    raise AssertionError(f"[17c] prologue at group {g}, "
                                         f"block {b}: {row}")
        del sa, sab
    out["prologue"] = pro17
    del scene, tris, tris_dev, acc, flat
    torch.cuda.empty_cache()
    log(17, t_all, "phases 0-17 so far")
    return out


# Phase 18: the Threefry kernel (csrc/threefry.cu) at the cells' shapes,
# its launches against the Threefry calls of the cells' steps, and the
# cells' images against another checkout's.


def threefry_cases(dev):
    """Phase 18a's calls: name -> (kernel call, plain call, keys, data,
    hashes, extra instructions a hash, bytes read and written once); a
    call takes (keys, data), data a tensor, a Python int or a column
    count."""
    import torch
    from trace_tpu_torch.sampler import uniform as U

    key = U.key(1234, dev)
    cases = {}
    for n in (65536, 1 << 20):
        ids = torch.arange(n, device=dev) * 977 + 11
        ks = U.fold_in_plain(key, ids)
        path = torch.arange(n, device=dev) % 7
        for name, k, d, nbytes in (
                ("key_lanes", key, ids, 16 + 8 * n + 16 * n),
                ("keys_scalar", ks, 3, 16 * n + 16 * n),
                ("keys_lanes", ks, path, 16 * n + 8 * n + 16 * n)):
            cases[f"fold_{name}_{n}"] = (U.fold_in, U.fold_in_plain, k, d,
                                         n, 0, nbytes)
    ks = U.fold_in_plain(key, torch.arange(1 << 20, device=dev))
    n = ks.shape[0]
    for cols in (1, 2, 5):
        cases[f"uniform_{n}x{cols}"] = (
            U.uniform_lanes, U.uniform_lanes_plain, ks, cols, n * cols,
            UNIFORM_OPS, 16 * n + 4 * n * cols)
    cases["uniform_key_65536x2"] = (
        lambda k, _: U.uniform(k, (65536, 2)),
        lambda k, _: U.uniform_lanes_plain(k[None], 131072).reshape(
            65536, 2), key, None, 131072, UNIFORM_OPS, 16 + 4 * 131072)
    return cases


def cold_ms(fn, keys, data, nbytes, reps=50):
    """graph_ms of ``fn(keys, data)`` with each launch on its own copy of
    the keys and data tensor, as many copies as exceed the 50 MB L2 three
    times over: every launch reads its inputs from HBM, as a bound that
    counts each byte once from HBM assumes."""
    import torch

    copies = [(keys.clone(), data.clone() if torch.is_tensor(data)
               else data) for _ in range(min(reps, -(-150_000_000
                                                     // nbytes)))]
    turn = iter(range(1 << 30))
    return graph_ms(lambda: fn(*copies[next(turn) % len(copies)]), reps)


def threefry_calls(U, record=None):
    """Count U.fold_in and U.uniform_lanes calls (every draw of the port
    goes through one of the two), and those with an empty result, which
    launch nothing -> (counts, undo). ``record``: a list that gets each
    call's (name, arguments), tensors cloned."""
    import torch

    names = ("fold_in", "uniform_lanes")
    calls = dict.fromkeys(names + ("empty",), 0)
    orig = {k: getattr(U, k) for k in names}

    def counted(name):
        def call(*a, **kw):
            calls[name] += 1
            if record is not None:
                record.append((name, [x.clone() if torch.is_tensor(x)
                                      else x for x in a]))
            res = orig[name](*a, **kw)
            calls["empty"] += int(res.numel() == 0)
            return res
        return call

    for k in names:
        setattr(U, k, counted(k))
    return calls, lambda: [setattr(U, k, f) for k, f in orig.items()]


def threefry_steps(cell, seed):
    """Phase 18b on one benchmark cell (perfbench's driver, no warm step):
    the eager first step's Threefry calls, kernel launches and
    threefry_launches counter; the capture's launches a replay (second
    step); the counter over a replay (third step)."""
    import torch
    from perfbench.harness import CellSpec
    from trace_tpu_torch.ops.threefry import threefry_kernel
    from trace_tpu_torch.sampler import uniform as U
    from trace_tpu_torch.utils.stats import collect

    spec = CellSpec(REPO, cell)
    run = spec.driver().Cell(spec.config, dict(spec.traffic, warm_steps=0),
                             seed, "cuda")
    run.setup()
    def graphs():   # made at the first render
        return getattr(run.integ, "frame_graphs", None) \
            or getattr(run.integ, "fused_graphs", None)

    row, recorded = {}, []
    for step in ("eager", "capture", "replay"):
        calls, undo = threefry_calls(U, recorded if step == "eager"
                                     else None)
        before = threefry_kernel.launches
        n_caps = len(graphs().captures) if graphs() else 0
        try:
            with collect() as stats:
                run.step()
            torch.cuda.synchronize()
        finally:
            undo()
        row[step] = dict(calls=dict(calls),
                         launches=threefry_kernel.launches - before,
                         counter=stats.counters.get("threefry_launches", 0))
        caps = graphs().captures if graphs() else []
        if len(caps) > n_caps:
            row[step]["capture_launches"] = caps[-1]["launches"]["threefry"]
    # The step's Threefry device ms: its calls replayed through the kernel
    # and through the plain twin (the parent's route), graph-timed.
    kern = {"fold_in": U.fold_in, "uniform_lanes": U.uniform_lanes}
    twin = {"fold_in": U.fold_in_plain,
            "uniform_lanes": U.uniform_lanes_plain}
    row["kernel_ms"] = graph_ms(
        lambda: [kern[n](*a) for n, a in recorded], 5)
    row["plain_ms"] = graph_ms(
        lambda: [twin[n](*a) for n, a in recorded], 1)
    row["calls_by_lanes"] = {}
    for n, a in recorded:
        k = f"{n} {tuple(a[0].shape)}"
        row["calls_by_lanes"][k] = row["calls_by_lanes"].get(k, 0) + 1
    del recorded
    run.release()
    torch.cuda.empty_cache()
    return row


def slice18(dev, card, t_all, parent=None):
    """Phase 18 (module docstring): the Threefry kernel."""
    import torch
    from trace_tpu_torch.ops.threefry import threefry_kernel

    out = {"card": card}
    # -- 18a: kernel vs twin at the cells' shapes, timed ----------------------
    t0 = time.perf_counter()
    threefry_kernel.lib.load()
    out["ptxas"] = [r for r in ptxas_summary(threefry_kernel.lib.build_log)
                    if r[0].startswith("threefry")]
    rows = {}
    for name, (kern, plain, keys, data, hashes, extra, nbytes) in \
            threefry_cases(dev).items():
        before = threefry_kernel.launches
        k = kern(keys, data)
        torch.cuda.synchronize()
        launched = threefry_kernel.launches - before
        equal = torch.equal(k, plain(keys, data))
        if not equal or launched != 1:
            raise AssertionError(f"threefry {name}: bit-equal {equal}, "
                                 f"{launched} launches")
        bound_ms, bound_by = bound(hashes * (THREEFRY_OPS + extra), nbytes,
                                   PEAK_INT32)
        ms = cold_ms(kern, keys, data, nbytes)
        rows[name] = dict(hashes=hashes, bytes=nbytes, ms=ms,
                          warm_ms=graph_ms(lambda: kern(keys, data), 50),
                          plain_ms=graph_ms(lambda: plain(keys, data), 3),
                          bound_ms=bound_ms, bound_by=bound_by,
                          bound_share=bound_ms / ms)
        log("18a", t0, f"{name}: kernel {ms * 1e3:.2f} us (inputs in L2: "
            f"{rows[name]['warm_ms'] * 1e3:.2f} us), twin "
            f"{rows[name]['plain_ms'] * 1e3:.1f} us, bound "
            f"{bound_ms * 1e3:.2f} us ({bound_by}, "
            f"{100 * bound_ms / ms:.1f}%), bit-equal")
        torch.cuda.empty_cache()
    out["cases"] = rows
    log("18a", t0, f"ptxas (kernel, registers, spill stores, spill loads): "
        f"{out['ptxas']}; card {card}")
    if any(s or l for _, _, s, l in out["ptxas"]):
        print("[18a] note: a Threefry kernel spills registers", flush=True)
    # -- 18b: launches against the cells' Threefry calls ----------------------
    t0 = time.perf_counter()
    out["steps"] = {}
    for cell in ("mesh1m_whitted_256", "mesh1m_sppm_1024_fused"):
        row = threefry_steps(cell, 1234)
        out["steps"][cell] = row
        eager = row["eager"]
        n_calls = eager["calls"]["fold_in"] \
            + eager["calls"]["uniform_lanes"] - eager["calls"]["empty"]
        log("18b", t0, f"{cell}: eager step {eager['calls']} Threefry "
            f"calls, {eager['launches']} launches, counter "
            f"{eager['counter']:.0f}; capture "
            f"{row['capture'].get('capture_launches')} launches a replay; "
            f"a replay counts {row['replay']['counter']:.0f}; the step's "
            f"calls graph-timed: kernel {row['kernel_ms']:.3f} ms, twin "
            f"{row['plain_ms']:.3f} ms; by key shape "
            f"{row['calls_by_lanes']}")
        if not (n_calls > 0 and eager["launches"] == n_calls
                == eager["counter"]
                == row["capture"].get("capture_launches")
                == row["replay"]["counter"]
                and row["replay"]["launches"] == 0):
            raise AssertionError(f"{cell}: Threefry calls and launches "
                                 f"disagree: {row}")
    # -- 18c: the cells' images against another checkout's -------------------
    t0 = time.perf_counter()
    script = os.path.join(REPO, "scripts", "torch_threefry_images.py")
    images = {}
    for label, root in (("change", REPO), ("parent", parent)):
        if root is None:
            continue
        res = subprocess.run(
            [sys.executable, script, "--root", root, "--seed", "1234"],
            check=True, capture_output=True, text=True, timeout=900)
        images[label] = json.loads(res.stdout.strip().splitlines()[-1])
        step_ms = {c: [round(r["ms"], 2) for r in v["steps"]]
                   for c, v in images[label]["cells"].items()}
        log("18c", t0, f"{label} ({root}): step ms {step_ms}")
    out["images"] = images
    ch = images["change"]["cells"]
    frames = [r["digest"] for r in ch["mesh1m_whitted_256"]["steps"]]
    if any(f != frames[0] for f in frames):
        raise AssertionError("the Whitted cell's eager, captured and "
                             "replayed frames differ")
    if parent is not None:
        same = {c: [a["digest"] == b["digest"] for a, b in zip(
            v["steps"], images["parent"]["cells"][c]["steps"])]
            for c, v in ch.items()}
        out["bit_equal_to_parent"] = same
        log("18c", t0, f"bit-equal to the parent, step by step: {same}")
        if not all(all(v) for v in same.values()):
            raise AssertionError(f"images differ from the parent's: {same}")
    log(18, t_all, "the Threefry kernel")
    return out


def n_pix_of(cam) -> int:
    (x0, y0), (x1, y1) = cam.film.sample_bounds()
    return (x1 - x0 + 1) * (y1 - y0 + 1)


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke test of the port on "
                                 "one GPU (module docstring).")
    ap.add_argument("--parent", default=None,
                    help="a checkout whose cells' images phase 18c holds "
                    "bit-equal to this one's")
    opts = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from trace_tpu_torch.accel import native
    from trace_tpu_torch.core.vec import V3
    from trace_tpu_torch.integrators.whitted import WhittedIntegrator
    from trace_tpu_torch.models import mesh_heavy
    from trace_tpu_torch.ops import intersect as TI
    from trace_tpu_torch.ops import sweep as TS
    from trace_tpu_torch.ops.bvh_walk import walk_kernel
    from trace_tpu_torch.ops.splat import splat_kernel
    from trace_tpu_torch.ops.sweep import (block_entry_kernel, sweep_kernel,
                                           sweep_plain)
    from trace_tpu_torch.ops.threefry import threefry_kernel
    from trace_tpu_torch.sampler import uniform as U
    from trace_tpu_torch.wavefront import whitted as WF

    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    card = smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    log(0, t0, f"card {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # -- 1: builds, one nvcc per source, in parallel ------------------------
    t0 = time.perf_counter()
    libs = (sweep_kernel, block_entry_kernel, TI.intersect_kernel,
            walk_kernel, splat_kernel, threefry_kernel)
    with ThreadPoolExecutor() as ex:   # nvcc runs outside the GIL
        list(ex.map(lambda k: k.lib.load(), libs))
    t_nvcc = time.perf_counter() - t0
    native.load()
    regs = ptxas_summary("".join(k.lib.build_log for k in libs))
    log(1, t0, f"built sweep, prologue, intersect, walk, splat and "
        f"Threefry kernels "
        f"(nvcc "
        f"{t_nvcc:.2f} s, in parallel) and SAH builder; sweep CTA: "
        f"{TS.SWEEP_WARPS} warps per {TS.KERNEL_BLOCK_RAYS} rays; "
        f"registers/spill "
        f"stores/spill loads per arm: "
        f"{[f'{n}:{r}/{s}/{l}' for n, r, s, l in regs]}")
    if any(s or l for _, _, s, l in regs):
        print("[1] note: a kernel arm spills registers", flush=True)

    # -- 2a: kernel vs plain on the default path's own launches ------------
    t0 = time.perf_counter()
    scene = mesh_heavy.build_scene(1_000_000, device=dev)
    build_s = time.perf_counter() - t0
    acc = scene.accel
    tb = acc.tables
    log(2, t0, f"host scene build {build_s:.2f} s: n_triangles "
        f"{scene.n_triangles}, n_supers {tb.n_supers}, panel "
        f"{tb.panel.nbytes / 2**20:.1f} MB")
    png = os.path.join(tempfile.gettempdir(), "chip_smoke_256.png")
    cam = mesh_heavy.build_camera(256, png)
    integ = WhittedIntegrator(cam, U.UniformSampler(1, seed=0), max_depth=2,
                              pixel_chunk=ONE_CHUNK)
    calls = record_calls(integ, scene)
    if [a for *_, a in calls] != [False, True, False, True]:
        raise AssertionError(f"unexpected intersect calls: {len(calls)}")
    res, pro_tot = {}, {}
    d_chunks = sweep_chunks(acc, calls, pro_tot)
    for name, anyh, chunks in d_chunks:
        tot = {}
        for _, args in chunks:
            kt, ki = sweep_kernel(*args, acc.panel, acc.block_rays, anyh)
            pt, pi = sweep_plain(*args, acc.panel, acc.block_rays, anyh)
            torch.cuda.synchronize()
            accumulate(tot, compare(kt, ki, pt, pi))
        res[name] = tot
        log("2a", t0, f"{name}: {[a[0].shape[1] for _, a in chunks]} lanes, "
            f"{tot}")
        if disagrees(tot):
            raise AssertionError(f"kernel disagrees with plain: {name} {tot}")
    if res["call0_closest"]["n_found"] <= 0 \
            or res["camera_any_hit"]["n_found"] < 1000:
        raise AssertionError("too few hits to exercise the kernel")
    log("2a", t0, f"prologue kernel vs plain: {pro_tot}")
    if prologue_disagrees(pro_tot):
        raise AssertionError(f"prologue kernel disagrees: {pro_tot}")

    # -- 2b: the exact-edge scene, every arm, on its frame's launches -------
    t0 = time.perf_counter()
    exact = mesh_heavy.build_scene(1_000_000, device=dev,
                                   exact_shared_edges=True)
    eacc = exact.accel
    assert eacc.certified and exact.exact_edges
    png_e = os.path.join(tempfile.gettempdir(), "chip_smoke_256_exact.png")
    cam_e = mesh_heavy.build_camera(256, png_e)
    integ_e = WhittedIntegrator(cam_e, U.UniformSampler(1, seed=0),
                                max_depth=2, pixel_chunk=ONE_CHUNK)
    e_calls = record_calls(integ_e, exact)
    e_pro = {}
    e_chunks = sweep_chunks(eacc, e_calls, e_pro)
    log("2b", t0, f"prologue kernel vs plain: {e_pro}")
    if prologue_disagrees(e_pro):
        raise AssertionError(f"prologue kernel disagrees: {e_pro}")
    panels = {k: TS.panel_tensor(TS.cast_panel(tb.panel, k == "bf16",
                                               k == "hilo"), dev)
              for k in ("f32", "bf16", "hilo")}
    arms = [("certified", "f32", True), ("bf16", "bf16", False),
            ("hilo", "hilo", False), ("certified_bf16", "bf16", True),
            ("certified_hilo", "hilo", True)]
    arm_res = {a: {} for a, _, _ in arms}
    b = eacc.block_rays
    for name, anyh, chunks in e_chunks:
        for _, args in chunks:
            ut, ui = sweep_plain(*args, panels["f32"], b, anyh)
            for arm, kind, cert in arms:
                p = panels[kind]
                opt = dict(certified=cert)
                pt, pi, ps = sweep_plain(*args, p, b, anyh,
                                         collect_stats=True, **opt)
                kt, ki = sweep_kernel(*args, p, b, anyh, **opt)
                st, si, ss = sweep_kernel(*args, p, b, anyh,
                                          collect_stats=True, **opt)
                qt, qi, qs = sweep_kernel(*args, p, b, anyh,
                                          collect_stats=True, pipeline=True,
                                          **opt)
                torch.cuda.synchronize()
                tot = arm_res[arm].setdefault(name, {})
                accumulate(tot, compare(kt, ki, pt, pi))
                tot["stats_arm_differs"] = tot.get("stats_arm_differs", 0) + \
                    int(not (torch.equal(st, kt) and torch.equal(si, ki)))
                tot["steps_differ"] = tot.get("steps_differ", 0) + \
                    int((ss != ps).sum())
                tot["pipelined_differs"] = tot.get("pipelined_differs", 0) + \
                    int(not (torch.equal(qt, kt) and torch.equal(qi, ki)
                             and torch.equal(qs, ss)))
                tot["steps"] = tot.get("steps", 0) + int(ss.sum())
                lost = int(((ui >= 0) & (ki < 0)).sum())
                tot["plain_f32_hits_lost"] = tot.get(
                    "plain_f32_hits_lost", 0) + lost
        for arm, kind, cert in arms:
            if name not in arm_res[arm]:   # no chunk launched
                continue
            tot = arm_res[arm][name]
            log("2b", t0, f"{arm} {name}: {tot}")
            lost_gated = cert and (kind == "f32" or not anyh)
            if disagrees(tot) or tot["stats_arm_differs"] \
                    or tot["steps_differ"] or tot["pipelined_differs"] \
                    or (lost_gated and tot["plain_f32_hits_lost"]):
                raise AssertionError(f"arm {arm} fails on {name}: {tot}")
    log("2b", t0, f"exact-edge frame: {len(e_calls)} calls, every arm "
        f"bit-equal to its plain version, pipelined == single-buffered, "
        f"steps equal; certified hits cover plain f32 hits")

    # -- 2c: the fused brute-force kernel on the 5k scene's frame -----------
    t0 = time.perf_counter()
    small = mesh_heavy.build_scene(5000, device=dev)
    TI.attach(small)
    fcam = mesh_heavy.build_camera(
        256, os.path.join(tempfile.gettempdir(), "chip_smoke_fused.png"))
    finteg = WhittedIntegrator(fcam, U.UniformSampler(1, seed=0), max_depth=2,
                               pixel_chunk=ONE_CHUNK)
    f_calls = record_calls(finteg, small)
    fused = {}
    fa = small.accel
    for i, (o, d, tm, anyh) in enumerate(f_calls):
        rays, _ = TI.pack_rays(o, d, tm)
        kt, ki = TI.intersect_kernel(rays, fa.tris, fa.ids)
        pt, pi = TI.intersect_plain(rays, fa.tris, fa.ids)
        torch.cuda.synchronize()
        name = f"call{i}_{'any_hit' if anyh else 'closest'}"
        accumulate(fused, compare(kt, ki, pt, pi))
        eq = torch.equal(kt, pt) and torch.equal(ki, pi)
        log("2c", t0, f"fused {name}: {rays.shape[1]} lanes, bit-equal "
            f"{eq}, found {int((ki >= 0).sum())}")
        if not eq:
            raise AssertionError(f"fused kernel disagrees: {name}")
        if i == 0:
            fused["bound_ms"], fused["bound_by"] = bound(
                rays.shape[1] * small.n_triangles * INTERSECT_OPS,
                rays.numel() * 4 + fa.tris.numel() * 4 + fa.ids.numel() * 4
                + rays.shape[1] * 8)
            fused["ms"] = cuda_ms(
                lambda: TI.intersect_kernel(rays, fa.tris, fa.ids), 10)
            fused["plain_ms"] = cuda_ms(
                lambda: TI.intersect_plain(rays, fa.tris, fa.ids), 2)
            log("2c", t0, f"fused camera rays ({rays.shape[1]} lanes x "
                f"{small.n_triangles} triangles): kernel {fused['ms']:.3f} "
                f"ms, plain {fused['plain_ms']:.3f} ms, bound "
                f"{fused['bound_ms']:.4f} ms ({fused['bound_by']}, "
                f"{100 * fused['bound_ms'] / fused['ms']:.1f}% of it); card "
                f"{card}")
    if len(f_calls) < 2:
        raise AssertionError("the fused frame made too few calls")

    # -- 3a: shared-edge leaks on the 1M heightfield -------------------------
    t0 = time.perf_counter()
    n_grid = int(np.sqrt(1_000_000 / 2)) + 1
    verts, _ = mesh_heavy.heightfield(n_grid)
    rng = np.random.default_rng(0)
    quad = rng.choice((n_grid - 1) ** 2, 65536, replace=False)
    ii, jj = quad // (n_grid - 1), quad % (n_grid - 1)
    v00 = ii * n_grid + jj
    va, vb = verts[v00 + n_grid], verts[v00 + 1]   # the v10 -- v01 diagonal
    s = rng.uniform(0.05, 0.95, (65536, 1)).astype(np.float32)
    p = (va + s * (vb - va)).astype(np.float32)
    o = p + np.stack([rng.uniform(-0.3, 0.3, 65536),
                      rng.uniform(2.0, 4.0, 65536),
                      rng.uniform(-0.3, 0.3, 65536)], -1).astype(np.float32)
    d = (p - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True).astype(np.float32)
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    inf = torch.full((65536,), float("inf"), device=dev)
    leaks = {}
    for label, sc in (("off", scene), ("on", exact)):
        h, _, _ = sc.accel.intersect(o, d, inf, False)
        hit = WF.closest_hit(sc, V3.of(o), V3.of(d), inf,
                             torch.zeros(65536, device=dev))
        leaks[label] = (int((~h).sum()), int((~hit.valid).sum()))
    log("3a", t0, f"65536 rays at shared diagonals of the 1M heightfield: "
        f"misses through the sweep kernel / through closest_hit: exact "
        f"edges off {leaks['off']}, on {leaks['on']}")
    if leaks["on"] != (0, 0):
        raise AssertionError(f"shared edges leak with exact edges: {leaks}")

    # -- 3b: goldens -------------------------------------------------------
    t0 = time.perf_counter()
    golden = np.load(GOLDEN)
    goldens = {}
    fused_small = mesh_heavy.build_scene(5000, device=dev,
                                         exact_shared_edges=True)
    TI.attach(fused_small)
    for label, sc in (
            ("default", mesh_heavy.build_scene(5000, device=dev)),
            ("exact_edges", mesh_heavy.build_scene(
                5000, device=dev, exact_shared_edges=True)),
            ("exact_edges_fused", fused_small)):
        cam32 = mesh_heavy.build_camera(
            32, os.path.join(tempfile.gettempdir(), f"chip_smoke_32_{label}"
                             ".png"))
        st = WhittedIntegrator(cam32, U.UniformSampler(1, seed=0),
                               max_depth=2, pixel_chunk=ONE_CHUNK).render(sc)
        img = cam32.film.to_image(st).cpu().numpy()
        mse = float(np.mean((img - golden) ** 2))
        goldens[label] = mse
        log("3b", t0, f"golden 32^2 {label}: MSE {mse:.3e} (gate "
            f"{MSE_GATE}), max abs {float(np.abs(img - golden).max()):.4f}")
        if not (img.shape == golden.shape and np.isfinite(img).all()
                and mse < MSE_GATE):
            raise AssertionError(f"golden mismatch ({label}): MSE {mse}")

    # -- 4: the slices, and each option as its own run ---------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    (x0, y0), (x1, y1) = cam.film.sample_bounds()
    n_pix = (x1 - x0 + 1) * (y1 - y0 + 1)
    rays_per_frame = n_pix * 1 * (1 + int(scene.lights.kind.shape[0])) * 2
    tables = {"f32": tb,
              "bf16": TS.SweepTables.from_arrays(
                  TS.cast_panel(tb.panel, bf16=True), tb.slot_to_tri,
                  tb.s_lo, tb.s_hi),
              "hilo": TS.SweepTables.from_arrays(
                  TS.cast_panel(tb.panel, hilo=True), tb.slot_to_tri,
                  tb.s_lo, tb.s_hi)}

    def with_sweep(sc, kind="f32", **kw):
        sc.accel = TS.SweepAccelerator(tables[kind], dev, block_rays=b,
                                       ray_chunk=acc.ray_chunk, **kw)
        return sc

    # (run, arm it must launch, scene, integrator): the default path, the
    # slice (exact edges), then each option on the path it extends.
    runs = [
        ("default", "f32", scene, integ),
        ("exact_edges", "certified_f32", exact, integ_e),
        ("exact_edges+bf16", "certified_bf16", None, integ_e),
        ("exact_edges+hilo", "certified_hilo", None, integ_e),
        ("exact_edges+pipeline", "certified_f32_pipelined", None, integ_e),
        ("exact_edges+stats", "certified_f32_stats", None, integ_e),
        ("bf16", "bf16", None, integ),
        ("hilo", "hilo", None, integ),
        ("fused_5k", "intersect", small, finteg),
    ]
    frames = {}
    for run, arm, sc, it in runs:
        if sc is None:
            base = exact if run.startswith("exact_edges") else scene
            kind = run.split("+")[-1] if run.split("+")[-1] in tables \
                else "f32"
            sc = with_sweep(base, kind, certified=base.exact_edges,
                            pipeline=run.endswith("pipeline"),
                            collect_stats=run.endswith("stats"))
        torch.cuda.reset_peak_memory_stats()
        sweep_kernel.reset_counts()
        block_entry_kernel.reset_counts()
        TI.intersect_kernel.reset_counts()
        if hasattr(sc.accel, "skipped_chunks"):
            sc.accel.skipped_chunks = 0
        if not it.replays(sc):
            raise AssertionError(f"{run}: not the frame graph's route")
        times, state = timed_frames(it, sc)
        # The frame graph's route: the view's eager first frame and its
        # capture issue launches from Python, each the launches of a
        # replay (the capture's record); the replays issue none.
        per = it.frame_graphs.captures[-1]["launches"]
        issued = (TI.intersect_kernel.launches if arm == "intersect"
                  else sweep_kernel.arm_launches[arm])
        launches = per["intersect" if arm == "intersect" else "sweep"]
        others = sweep_kernel.launches - (0 if arm == "intersect"
                                          else issued)
        ms = float(np.mean(times))
        img = it.camera.film.to_image(state).cpu().numpy()
        nonzero = float((img > 0).any(-1).mean())
        extra = ""
        if run.endswith("stats"):
            steps = [int(s.sum()) for s in sc.accel.last_steps]
            extra = (f", sweep steps per launch {steps[:8]}"
                     f"{'...' if len(steps) > 8 else ''}")
            sc.accel.last_steps = []
        entry_launches = per["prologue"]
        skipped = getattr(sc.accel, "skipped_chunks", 0)
        frames[run] = dict(ms=ms, times=times, launches=launches,
                           entry_launches=entry_launches,
                           skipped_chunks=skipped,
                           peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        log(4, t0, f"{run}: replays {[round(x, 3) for x in times]} ms, "
            f"mean {ms:.2f} ms, {rays_per_frame / ms / 1e3:.3f} Mrays/s, "
            f"{arm} launches a replay {launches} (other sweep arms "
            f"{others}), prologue launches a replay {entry_launches}, "
            f"chunks skipped {skipped}, "
            f"queue_drops "
            f"{it.last_queue_drops}, useful_rays {it.last_useful_rays}, "
            f"non-zero pixels {nonzero:.3f}, peak mem "
            f"{frames[run]['peak_gib']:.2f} GiB{extra}")
        if launches <= 0 or others or it.last_queue_drops != 0 \
                or issued != 2 * launches:
            raise AssertionError(f"{run} did not run through {arm} cleanly"
                                 f": {issued} issued, {launches} a replay")
        if entry_launches != per["sweep"] \
                or block_entry_kernel.launches != sweep_kernel.launches:
            raise AssertionError(f"{run}: {entry_launches} prologue "
                                 f"launches for {per['sweep']} sweep "
                                 f"launches a replay")
        if not (np.isfinite(img).all() and nonzero > 0.05):
            raise AssertionError(f"bad frame in {run}: non-zero {nonzero}")
        if run in ("default", "exact_edges"):
            it.camera.film.save_png(state)
    exact.accel, scene.accel = eacc, acc
    log(4, t0, f"1M tris 256^2 1spp depth 2 ({rays_per_frame} rays/frame): "
        f"default {frames['default']['ms']:.2f} ms, exact_shared_edges "
        f"{frames['exact_edges']['ms']:.2f} ms (CUDA events, mean of 3 "
        f"replays); "
        f"PNGs {png}, {png_e}; card {card}")

    # Every sweep launch of the default and exact-edge frames.
    labels = ["camera", "shadow", "specular", "specular shadow"]
    per_launch = {
        "default": time_launches("4 default", t0, acc, calls, d_chunks,
                                 acc.panel, False, card, labels),
        "exact_edges": time_launches("4 exact", t0, eacc, e_calls, e_chunks,
                                     eacc.panel, True, card, labels)}

    # Camera chunk (the exact frame's first 65536 camera rays), per arm, at
    # the shipped block of 32 rays: kernel ms (CUDA events, 10 launches)
    # against plain ms. The kernel refuses blocks of 64 and more rays (16
    # warps per 32 rays: such a CTA needs more registers than an SM has).
    o, d, tm, _ = e_calls[0]
    perm = eacc.coherence_order(o, d, tm)
    o, d, tm = (x[perm][:acc.ray_chunk] for x in (o, d, tm))
    timing = {}
    panel_bytes = {k: p[0].numel() * p.element_size()
                   for k, p in panels.items()}
    blk = TS.KERNEL_BLOCK_RAYS
    args = TS.SweepAccelerator(tb, dev, block_rays=blk).prologue(o, d, tm)
    for other in (48, 1024):   # blocks are 32k rays, 1 <= k <= 16
        a_other = TS.SweepAccelerator(tb, dev, block_rays=other).prologue(
            o[:4096], d[:4096], tm[:4096])
        try:
            sweep_kernel(*a_other, panels["f32"], other, False)
            raise AssertionError(f"the sweep kernel took a block of {other} "
                                 f"rays")
        except ValueError as e:
            log(4, t0, f"block of {other} rays refused: {e}")
        del a_other
    # The prologue on the same chunk with every lane dead: the accelerator
    # skips such chunks, so only this timing launches the kernel on one.
    dead_chunk = {}
    dead_tot = {}
    check_prologue(acc, o, d, torch.full_like(tm, -1.0), dead_tot, dead_chunk)
    log(4, t0, f"all-dead chunk of {o.shape[0]} rays: prologue kernel "
        f"{dead_chunk['prologue_ms']:.4f} ms vs torch route "
        f"{dead_chunk['prologue_torch_ms']:.4f} ms, plain "
        f"{dead_chunk['prologue_plain_ms']:.3f} ms, bound "
        f"{dead_chunk['prologue_bound_ms']:.4f} ms "
        f"({dead_chunk['prologue_bound_by']}); {dead_tot}; card {card}")
    if prologue_disagrees(dead_tot):
        raise AssertionError(f"prologue kernel disagrees: {dead_tot}")
    for arm, kind, cert in [("f32", "f32", False)] + arms:
        for pipe in (False, True):
            p = panels[kind]
            opt = dict(certified=cert, pipeline=pipe)
            per_block = sweep_kernel(*args, p, blk, False, collect_stats=True,
                                     **opt)[2]
            steps = int(per_block.sum())
            ms = cuda_ms(lambda: sweep_kernel(*args, p, blk, False, **opt), 10)
            name = arm + ("_pipelined" if pipe else "")
            row = dict(ms=ms, steps=steps,
                       gbs=steps * panel_bytes[kind] / ms / 1e6)
            row["bound_ms"], row["bound_by"] = sweep_bound(
                args, per_block, p, blk, cert)
            if not pipe:
                row["stats_ms"] = cuda_ms(
                    lambda: sweep_kernel(*args, p, blk, False,
                                         collect_stats=True, **opt), 10)
                row["plain_ms"] = cuda_ms(
                    lambda: sweep_plain(*args, p, blk, False,
                                        certified=cert), 2)
            timing[(name, blk)] = row
            log(4, t0, f"camera chunk {o.shape[0]} rays, block {blk}, "
                f"{name}: kernel {ms:.3f} ms"
                + (f" ({row['stats_ms']:.3f} ms with step counts), "
                   f"plain {row['plain_ms']:.3f} ms" if "plain_ms" in row
                   else "")
                + f", bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                f"steps {steps}, panel {row['gbs']:.1f} GB/s")
    # The same chunk at the JAX package's tilings (group 64 at leaf 64:
    # GL 4096; blocks of 128 and 512 rays), graph-timed, and every arm at
    # each tiling on a sample of it.
    tile_tables = tiling_tables(tb, dev)
    tilings = tiling_grid(4, t0, card, tile_tables, o, d, tm, regs)
    tiling_arm_rows = tiling_arms(4, t0, tile_tables, o, d, tm)
    del tile_tables
    log(4, t0, f"whole run so far {time.perf_counter() - t_all:.1f} s")

    # -- 5: slice 3 ---------------------------------------------------------
    del exact, e_calls, e_chunks, calls, d_chunks
    torch.cuda.empty_cache()
    s3 = slice3(dev, card, scene, t_all)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "slice3.json"), "w") as f:
        json.dump(dict(card=card, **s3), f, indent=1)

    # -- 6: slice 5, SPPM ---------------------------------------------------
    torch.cuda.empty_cache()
    s5 = slice5(dev, card, scene, t_all)
    with open(os.path.join(REPO, "chiprun_out", "slice5.json"), "w") as f:
        json.dump(dict(card=card, **s5), f, indent=1)
    sppm_launches = s5["iterations"][1]

    # -- 7: animated geometry -------------------------------------------------
    del s5
    torch.cuda.empty_cache()
    s7 = slice7(dev, card, scene, t_all)
    with open(os.path.join(REPO, "chiprun_out", "slice7.json"), "w") as f:
        json.dump(dict(card=card, **s7), f, indent=1)
    anim = dict(
        anim_whitted_launches=s7["b"]["launches"]["sweep"],
        anim_sppm_launches_per_frame=[r["sweep_launches"]
                                      for r in s7["c"]["frames"]])
    anim_pro = dict(
        anim_whitted_launches=s7["b"]["launches"]["prologue"],
        anim_sppm_launches_per_frame=[r["prologue_launches"]
                                      for r in s7["c"]["frames"]],
        anim_sppm_skipped_chunks_per_frame=[r["skipped_chunks"]
                                            for r in s7["c"]["frames"]])

    # -- 8: environment lights and the pbrt / thin-lens camera -------------
    del s7
    torch.cuda.empty_cache()
    s8 = slice8(dev, card, scene, t_all)
    with open(os.path.join(REPO, "chiprun_out", "slice8.json"), "w") as f:
        json.dump(dict(card=card, **s8), f, indent=1)
    env = dict(env_whitted_launches=s8["whitted_1m_env"]["launches"]["sweep"],
               env_sppm_launches=s8["sppm_1m_env"]["iterations"][1][
                   "sweep_launches"])
    env_pro = dict(
        env_whitted_launches=s8["whitted_1m_env"]["launches"]["prologue"],
        env_sppm_launches=s8["sppm_1m_env"]["iterations"][1][
            "entry_launches"],
        env_sppm_skipped_chunks=s8["sppm_1m_env"]["iterations"][1][
            "skipped_chunks"])

    # -- 9: instanced geometry ------------------------------------------------
    del s8
    torch.cuda.empty_cache()
    s9 = slice9(dev, card, t_all)
    with open(os.path.join(REPO, "chiprun_out", "slice9.json"), "w") as f:
        json.dump(dict(card=card, **s9), f, indent=1)
    c9 = s9["inst100_whitted_256"]
    inst = dict(inst_whitted_launches=c9["launches"]["sweep"],
                inst_whitted_max_abs_err=max(
                    t.get("max_abs_err", 0.0) for t in
                    c9["agreement"].values()),
                inst_sppm_launches=s9["inst100_sppm_256"]["iterations"][1][
                    "sweep_launches"])
    inst_pro = dict(
        inst_whitted_launches=c9["launches"]["prologue"],
        inst_whitted_skipped_chunks=c9["launches"]["skipped"],
        inst_whitted_max_abs_err=c9["prologue"]["max_abs_err"],
        inst_sppm_launches=s9["inst100_sppm_256"]["iterations"][1][
            "entry_launches"])

    # -- 10: several lights of any kind, image textures ---------------------
    del s9
    torch.cuda.empty_cache()
    s10 = slice10(dev, card, t_all)
    with open(os.path.join(REPO, "chiprun_out", "slice10.json"), "w") as f:
        json.dump(dict(card=card, **s10), f, indent=1)
    l3 = {k: s10[f"mesh1m_{k}_256_lights3"] for k in ("whitted", "path")}
    l3_sppm = s10["mesh1m_sppm_256_lights3"]["iterations"][1]
    lights3 = dict(
        lights3_whitted_launches=l3["whitted"]["launches"]["sweep"],
        lights3_path_launches=l3["path"]["launches"]["sweep"],
        lights3_sppm_launches=l3_sppm["sweep_launches"])
    lights3_pro = dict(
        lights3_whitted_launches=l3["whitted"]["launches"]["prologue"],
        lights3_path_launches=l3["path"]["launches"]["prologue"],
        lights3_sppm_launches=l3_sppm["entry_launches"],
        lights3_sppm_skipped_chunks=l3_sppm["skipped_chunks"])

    # -- 11: the render loop's public surface -------------------------------
    del s10
    torch.cuda.empty_cache()
    s11 = slice11(dev, card, scene, t_all)
    with open(os.path.join(REPO, "chiprun_out", "slice11.json"), "w") as f:
        json.dump(dict(card=card, **s11), f, indent=1)
    s11a = s11["mesh1m_whitted_256_strat2x2"]["launches"]
    s11b = s11["crop"]["launches"]
    s11c = s11["scene_queries"]
    public = dict(
        strat_whitted_launches=s11a["sweep"],
        filter_frame_launches={k: v["sweep"] for k, v in s11b.items()},
        scene_query_launches=s11c["launches"]["sweep"])
    public_pro = dict(
        strat_whitted_launches=s11a["prologue"],
        filter_frame_launches={k: v["prologue"] for k, v in s11b.items()},
        scene_query_launches=s11c["launches"]["prologue"])
    # -- 12: the BVH accelerators -------------------------------------------
    del s11
    torch.cuda.empty_cache()
    s12 = slice12(dev, card, scene, t_all)
    with open(os.path.join(REPO, "chiprun_out", "slice12.json"), "w") as f:
        json.dump(dict(card=card, **s12), f, indent=1)
    # -- 13: the sharded paths ---------------------------------------------
    torch.cuda.empty_cache()
    s13 = slice13(dev, card, scene, t_all)
    with open(os.path.join(REPO, "chiprun_out", "slice13.json"), "w") as f:
        json.dump(dict(card=card, **s13), f, indent=1)
    sharded = {}
    for key, row in (("gloo2_rank0", s13["gloo2"]["ranks"][0]),
                     ("nccl1", s13["nccl1"]["ranks"][0])):
        for part in ("whitted", "path"):
            sharded[f"sharded_{part}_launches_{key}"] = \
                row[part]["launches"]
        sharded[f"sharded_sppm_launches_{key}"] = [
            r["launches"] for r in row["sppm"]["iterations"]]
    shard_sweep = {k: (v["sweep"] if isinstance(v, dict)
                       else [x["sweep"] for x in v])
                   for k, v in sharded.items()}
    shard_pro = {k: (v["prologue"] if isinstance(v, dict)
                     else [x["prologue"] for x in v])
                 for k, v in sharded.items()}
    # -- 14: SPPM's fused blocks -------------------------------------------
    del s13
    torch.cuda.empty_cache()
    s14 = slice14(dev, card, scene, t_all)
    with open(os.path.join(REPO, "chiprun_out", "slice14.json"), "w") as f:
        json.dump(dict(card=card, **s14), f, indent=1)
    c14 = s14["mesh1m_sppm_1024_fused1"]
    a14 = s14["anim_relight_128_standin_fused2"]["frames"]
    f14 = {name: dict(
        fused_sppm_1024_launches_per_replay=c14["capture"]["launches"][name],
        fused_sppm_1024_run_launches=c14["run_launches"][name],
        anim_fused_run_launches=[r["run_launches"][name] for r in a14])
        for name in ("sweep", "prologue")}
    # -- 15: the walk kernel on config 3's 1M-ray calls --------------------
    del s14
    torch.cuda.empty_cache()
    s15 = slice15(dev, card, scene, t_all)
    with open(os.path.join(REPO, "chiprun_out", "slice15.json"), "w") as f:
        json.dump(dict(card=card, **s15), f, indent=1)
    c15 = s15["mesh1m_sppm_1024_wbvh_fused1"]
    walk15 = dict(
        sppm_1024_launches=s15["mesh1m_sppm_1024_wbvh"]["walk_launches"],
        fused_sppm_1024_launches_per_replay=c15["capture"]["launches"][
            "bvh_walk"],
        fused_sppm_1024_run_launches=c15["run_launches"]["bvh_walk"],
        sppm_1024_walk_ms=s15["sppm_1024_walk_ms"],
        camera_1m_ms=s15["per_call"][0]["ms"],
        camera_1m_bound_ms=s15["per_call"][0]["bound_ms"])
    # -- 16: the last public signatures of the JAX package -----------------
    del s15
    torch.cuda.empty_cache()
    s16 = slice16(dev, card, scene, c14["replay_ms"], t_all)
    with open(os.path.join(REPO, "chiprun_out", "slice16.json"), "w") as f:
        json.dump(dict(card=card, **s16), f, indent=1)
    cfg4 = {f"config4_{r}_launches": s16[f"mesh1m_whitted_{r}_{spp}spp"][
        "launches"] for r, spp in ((256, 1), (512, 4))}
    mxu16 = s16["mxu_vs_intersect"]
    splat16 = {r: s16[f"mesh1m_whitted_{r}_{spp}spp"]["splat"]
               for r, spp in ((256, 1), (512, 4))}
    # -- 17: bench config 6 --------------------------------------------------
    del s16
    torch.cuda.empty_cache()
    s17 = slice17(dev, card, t_all)
    with open(os.path.join(REPO, "chiprun_out", "slice17.json"), "w") as f:
        json.dump(dict(card=card, **s17), f, indent=1)
    cfg6 = {name: {f"config6_{leg}_launches": row["launches"][name]
                   for leg, row in s17["legs"].items()
                   if leg.startswith("sweep")}
            for name in ("sweep", "prologue")}
    leg_a = s17["legs"]["sweep_g64_b128"]
    c6_key = tiling_name(64, 128, f"h{CONFIG6_CHUNK}")
    # -- 18: the Threefry kernel --------------------------------------------
    del s17
    torch.cuda.empty_cache()
    s18 = slice18(dev, card, t_all, parent=opts.parent)
    with open(os.path.join(REPO, "chiprun_out", "slice18.json"), "w") as f:
        json.dump(s18, f, indent=1)
    log(18, t_all, "the whole run, phases 0-18")
    with open(os.path.join(REPO, "chiprun_out", "slice4.json"), "w") as f:
        json.dump(dict(card=card, ptxas=regs, warps=TS.SWEEP_WARPS,
                       frames=frames, tilings=tilings,
                       tiling_arms=tiling_arm_rows,
                       per_launch=per_launch, dead_chunk=dead_chunk,
                       prologue_agreement=[pro_tot, e_pro]), f, indent=1)

    def err(arm):
        return max(r["max_abs_err"] for r in arm_res[arm].values())

    def entry(name, replaces, launches, max_abs_err, row, ms_key="ms",
              source=SWEEP_SRC, plain_key="plain_ms", bound_key="bound",
              library_key=None):
        # No single PyTorch call computes a per-ray running (t, id)
        # minimum over a data-dependent walk: library_ms is null but for
        # the prologue, whose yardstick is the torch route (the entry table
        # kernel, torch.argsort and a reverse cummin), and intersect, whose
        # all-pairs test the matmul route computes (accel/mxu.py, 16d).
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max_abs_err, "ms": row[ms_key],
                "plain_ms": row[plain_key],
                "bound_ms": row[bound_key + "_ms"],
                "bound_by": row[bound_key + "_by"],
                "library_ms": row[library_key] if library_key else None}

    t32 = lambda k: timing[(k, 32)]
    cert = t32("certified")
    kernels = [
        dict(entry("sweep", f"{JAX_SWEEP}:213", frames["default"]["launches"],
                   max(r["max_abs_err"] for r in res.values()), t32("f32")),
             sppm_launches=sppm_launches["sweep_launches"], **anim, **env,
             **inst, **lights3, **public, **shard_sweep, **f14["sweep"],
             **{k: v["sweep"] for k, v in cfg4.items()}, **cfg6["sweep"]),
        # The tiled kernel (csrc/sweep.cu::sweep_tiled_kernel) at the JAX
        # package's tilings: launches in config 6's leg (a), timed on that
        # leg's launch shape (8192 rays at group 64, blocks of 128).
        dict(entry("sweep_tiled", f"{JAX_SWEEP}:213",
                   leg_a["launches"]["tiled"],
                   max(r["max_abs_err"] for r in tilings.values()
                       if r.get("tiled") and "max_abs_err" in r),
                   tilings[f"{c6_key}_f32"]),
             shape=tilings[f"{c6_key}_f32"]["shape"],
             config6_frame_ms=leg_a["ms"],
             config6_tiled_ms_a_frame=leg_a["launch_ms"]["sweep_ms"],
             config6_prologue_ms_a_frame=leg_a["launch_ms"]["prologue_ms"],
             tilings={k: {f: r[f] for f in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "steps") if f in r}
                      for k, r in tilings.items()}),
        entry("sweep_certified", f"{JAX_SWEEP}:69",
              frames["exact_edges"]["launches"], err("certified"), cert),
        entry("sweep_bf16", f"{JAX_SWEEP}:253", frames["bf16"]["launches"],
              err("bf16"), t32("bf16")),
        entry("sweep_hilo", f"{JAX_SWEEP}:253", frames["hilo"]["launches"],
              err("hilo"), t32("hilo")),
        entry("sweep_certified_bf16", f"{JAX_SWEEP}:69",
              frames["exact_edges+bf16"]["launches"], err("certified_bf16"),
              t32("certified_bf16")),
        entry("sweep_certified_hilo", f"{JAX_SWEEP}:69",
              frames["exact_edges+hilo"]["launches"], err("certified_hilo"),
              t32("certified_hilo")),
        entry("sweep_stats", f"{JAX_SWEEP}:305",
              frames["exact_edges+stats"]["launches"], err("certified"),
              cert, ms_key="stats_ms"),
        entry("sweep_pipelined", f"{JAX_SWEEP}:313",
              frames["exact_edges+pipeline"]["launches"], err("certified"),
              dict(t32("certified_pipelined"), plain_ms=cert["plain_ms"])),
        dict(entry("prologue", f"{JAX_SWEEP}:527",
                   frames["default"]["entry_launches"],
                   max(pro_tot["max_abs_err"], e_pro["max_abs_err"]),
                   per_launch["default"][0], ms_key="prologue_ms",
                   source="trace_tpu_torch/csrc/entry.cu",
                   plain_key="prologue_plain_ms", bound_key="prologue_bound",
                   library_key="prologue_torch_ms"),
             sppm_launches=sppm_launches["entry_launches"],
             sppm_skipped_chunks=sppm_launches["skipped_chunks"], **anim_pro,
             **env_pro, **inst_pro, **lights3_pro, **public_pro,
             **shard_pro, **f14["prologue"],
             **{k: v["prologue"] for k, v in cfg4.items()},
             **cfg6["prologue"]),
        dict(entry("intersect", "trace_tpu/ops/intersect_pallas.py:94",
                   frames["fused_5k"]["launches"], fused["max_abs_err"],
                   dict(fused, library_ms=mxu16["mxu_graph_ms"]),
                   source="trace_tpu_torch/csrc/intersect.cu",
                   library_key="library_ms"),
             scene_query_oracle_launches=s11c["oracle_launches"],
             graph_ms=mxu16["intersect_graph_ms"]),
        dict(s12["entry"], **walk15),
        # The gather splat: launches in 16a's 256^2 frame (the benchmark
        # cell's two chunks), timed on its full chunk; the tail chunk's
        # row (1,028 valid lanes) and the 512^2 frame's launches beside.
        dict(entry("splat", "trace_tpu/film/film.py:195",
                   cfg4["config4_256_launches"]["splat"],
                   max(v["max_abs_err"] for v in splat16.values()),
                   splat16[256]["times"][0],
                   source="trace_tpu_torch/csrc/splat.cu",
                   library_key="library_ms"),
             config4_512_launches=cfg4["config4_512_launches"]["splat"],
             chunks=splat16[256]["times"]),
        # Threefry: launches in one eager step of each cell (18b), timed
        # on the fused SPPM cell's largest call, the [1M, 5] camera draw;
        # every case of 18a beside it.
        dict(entry("threefry", "none: jax.random's threefry (XLA)",
                   s18["steps"]["mesh1m_whitted_256"]["eager"]["launches"],
                   0, s18["cases"]["uniform_1048576x5"],
                   source="trace_tpu_torch/csrc/threefry.cu"),
             sppm_launches=s18["steps"]["mesh1m_sppm_1024_fused"]["eager"][
                 "launches"],
             cases=s18["cases"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
