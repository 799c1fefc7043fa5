#!/usr/bin/env python3
"""Drive the PyTorch port (`rnb_neus2_torch`) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing JSON lines with `elapsed_s`:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions. Exits non-zero without a CUDA device or without the package
   beside this script.
2. build: every kernel library of the main path (`hash_grad_small`,
   `scatter_add`, `encode_jacobian`, `corner_backward`, `neus_loss`,
   `march`), built with nvcc
   from the sources in the checkout, the point-to-mesh library of the Chamfer
   metric (`native/raycast.cc`, g++), the PNG row unfilter
   (`rnb_neus2_torch/native/png_unfilter.cc`, g++) and the image codecs'
   helpers (`rnb_neus2_torch/native/codecs.cc`, g++), the AV1 decoder
   (`rnb_neus2_torch/native/av1.cc`, g++), the AVIF frame scaler
   (`rnb_neus2_torch/native/scale.cc`, g++), the AV1 encoder
   (`native/av1_enc.cc`) and the OpenEXR codecs (`native/exr.cc`: PIZ,
   B44, DWA), all at once (one compiler per library), with `-Xptxas -v`
   output.
3. kernel vs plain: each exact-backward kernel's wrapper on card tensors
   at the main path's shapes against its plain PyTorch version (the
   training encode's two kernels: phase 21); max abs error ≤
   1e-5·(1 + max |plain|) (float atomics sum in another order), and every
   row that no element touches exactly 0.0 in both. (A touched entry whose
   terms cancel may come out 0.0 in one summation order and not in
   another: on the card both the kernels and `index_add_` sum in a varying
   order.) `hash_grad_small`: n = 2^21 and 2^18 at the 4096- and
   13,824-row levels 0 and 1, a ragged and an empty input, and dense
   tables of 29,792 and 32,768 rows, over one block's shared memory.
   `scatter_add`: n = 2^18 at the 2^19-row hashed tables and the dense
   39,304-, 125,000- and 373,248-row levels 2-4, n = 2^21, a ragged and
   an empty input, and F = 1. Some indices fall outside the table. Then
   each kernel's in-place entry point (`bench_scatter.check_in_place`)
   at n = 2^18 into a (S, F) view with sentinel rows on both sides, at
   F = 1, 2 and 4, on a zeroed view, a random one and one that starts 4
   bytes past an 8-byte boundary (F = 2 and 4 aligned take the float2
   vector path, the others 32-bit atomics), and on the padded hot-row
   input: the sentinels and untouched rows keep their bits.
4. timing: CUDA events over 50 launches after warm-up, with the stream held
   by a sleep kernel while the launches queue, so that host overhead does
   not count: the allocating wrapper (`ms`, a zeroed table per launch),
   the in-place entry point (`ms_into`, the main path's), the plain
   version, one PyTorch library call (`index_add_`) and the bounds (bytes
   over 3.35 TB/s vs float adds over 67 TFLOP/s): `bound_ms` for the
   allocating call, n·(4 + 4F) + S·F·4 bytes, and `bound_into_ms` for the
   in-place one, n·(4 + 4F) bytes plus a read and a write of each row
   that this input adds to. On uniform
   random indices here, and after phase 7 on the inputs that the trained
   field's next exact step gives each level, which the kernels line
   reports (per step: the sum over the kernel's levels); there also,
   for `hash_grad_small`, the other kernel on the
   same inputs (`ms_into_scatter_add`), each kernel's fixed cost (one
   launch on its first level's indices with zero values, which add
   nothing: `ms_into_zero_values`), and one line per level with the share of
   elements whose row repeats within its warp of 32 consecutive elements
   (the atomics the aggregation can remove), for the exact step's
   elements and the K = 1 step's picks (the plain version's, which the
   K-corner kernel adds alike). Each input is first checked against the
   plain version as in phase 3. Then the training encode's two kernels
   on the K = 1 step's inputs: each held against its plain version on
   the card (the forward bit for bit, the backward's picks equal), its
   device ms, the plain version's and its bound (`encode_bounds`: bytes
   with the gather counted in distinct 32-byte sectors, over 3.35 TB/s,
   vs float32 operations over 67 TFLOP/s); no single PyTorch call
   computes either (`library_ms` null).
5. probes: every section of `rnb_neus2_torch.tools.bench_scatter` (the
   five TPU scatter-add probes' sweeps), both kernels at every point,
   checked exactly against the plain version; a mismatch raises.
6. agreement: one training loss and its gradients at a small config on the
   card against the same on the CPU (the CPU port is held against the JAX
   package by tests/test_torch_*.py); then the default config's K = 1
   encode backward on the card and the CPU with the same positions and
   cotangents: the `corner_backward` kernel's own picked corner of every
   sample at every level is the CPU's, and the table gradients agree as
   in phase 3.
7. train: the main path — `Trainer.train_step` at the full default width
   (14 levels x F=2, 2^19 hashed tables, 64-wide MLPs, 2^18-sample batch,
   128^3 occupancy grid) of the unmodified default config: the default
   stochastic backward (stoch_corner_bwd=1) and the divergence guard on,
   which checkpoints every healthy step on the card. From init for 440
   steps on a seeded synthetic sphere, so that the last 29 run all 14
   levels; then the exact backward (only stoch_corner_bwd=0 changed) for
   20 steps. Launch counts are zeroed just before each and read just
   after: `encode_jacobian` once a step (the field call); at K = 1
   `corner_backward` once a step and neither exact-backward kernel; in
   the exact steps `hash_grad_small` twice a step (levels 0 and 1) and
   `scatter_add` once for each other level the step runs
   (`_expected_launches`). Each run prints the guard's
   counters (rollbacks, degraded, the loss and eikonal floors); a
   rollback on the sphere is reported, not hidden.
8. rollback: one NaN color loss fed to the default run's guard
   (`_consume_metrics`) rolls it back. Parameters, Adam moments and step
   counts, EMA parameters, the occupancy grid and the error map must
   equal the good snapshot bit for bit, and the generator's next draws
   must differ from a replay of the snapshot's. Then 16 more steps: every
   one accepted, the color loss finite, and its mean below the loss EMA
   that the snapshot restored (the trailing average: one step's loss at
   convergence is noise).
9. mesh: the default run's EMA field exported on the card. At res 192 its
   fine volume goes through the card's marching cubes and, fetched to the
   host, through the numpy one: V within 1e-5, F equal. Then
   `extract_mesh` at res 512 and 1024 (the CLI and pipeline defaults):
   V and F counts, active blocks, seconds per stage and
   `torch.cuda.max_memory_allocated`; the sphere's vertices lie within a
   voxel of radius 0.25 (median), and the 512 OBJ written to a temporary
   directory reads back with `load_obj`. At 1024 the export runs again
   with the slabbed marching cubes (8 slabs): V, F and N equal to the
   first export's (which `extract.mc_slabs` runs one-shot on this card),
   its seconds and peak beside them; then both marching cubes alone on
   the same fine volume, equal, with their seconds and the memory each
   allocates beside the volume.
10. chamfer: the protocol of tests/test_chamfer_gate.py on the card, guard
   on: the composite scene at 12 views of 80x96, 8 levels, top resolution
   256, a 2^15 table, n_ladder 1024, 900 steps, extraction at 128 against
   `composite_gt_mesh(192)`. The same absolute gate: chamfer_l1 < 0.05
   and completeness < 0.04.
11. cli: the sphere of phase 7 written as a prepared scene (16 views,
   256x256, 16-bit RGBA PNGs, transform.json) by the port's
   `write_prepared_scene`; `load_transform_json` matches `sphere_dataset`
   within the 16-bit quantization (origins 1e-5, normals in the mask
   5e-3, the same mask). Then `python -m rnb_neus2_torch.cli.testbed
   --scene D --maxiter 300 --save-snapshot --save-mesh --resolution 256
   --trace-steps 16 --render-path P --render-frames 8` as a subprocess
   (P: a camera path between training views 0 and 4; the trace covers
   steps 256-271, one 16-step chunk): exit 0, its `iteration=300` line,
   both files; its Chrome trace names the CUDA functions of the two
   kernels its default path launches (`encode_jacobian`,
   `corner_backward`, the loss's three and the march's four) and the
   trainer's spans; 8 RGBA PNGs of 256x256 whose
   first and last differ; and the count of metric reads it prints equals
   that of the same loop run on the CPU with the step body, the refresh
   and the read replaced by counters (the port's schedule). Its
   snapshot restored in this process into a fresh `Trainer` of the same
   flags equals the file bit for bit (parameters, Adam moments, steps and
   count, EMA, the float16 grid, its bitfield against min(0.1, mean), the
   refresh count, step, ray count, the loss and eikonal EMAs, the
   generator), and one more step gives a finite loss. Prints the
   snapshot's bytes, write and read seconds, the PNG decode ms per view
   (the scene's 256x256 files and one 612x512 view), the CLI's ms/step,
   the trace's size and kernel count and the fly-through's seconds.
12. pipeline: the sphere as an IDR input (cameras.npz, normal/, albedo/,
   mask/ PNGs; `write_idr_scene`) through `run_full_pipeline` in this
   process on the card: load, prepare (silhouette scaling), stage 1 to
   step 666, stage 2 resumed from its snapshot with --opti-lights to 1000
   (all 14 levels from step 411, except in a 16-step chunk that started
   below that bucket), the mesh at 512, the largest component. The CLI
   trains through `Trainer.train_steps` (metrics read every 25 steps, or
   every two 16-step chunks from step 256); every step body and chunk is
   recorded with its level bucket. Launch counts zeroed just before and
   read just after: `corner_backward` once per step body,
   `encode_jacobian` once per training-encode forward (each step body's
   field call and each chunk of the mesh's normals, counted by
   `_record_forwards`), neither exact-backward kernel; rollbacks are
   counted and reported. mesh.obj reads back with
   `load_obj`, and its median vertex radius about the sphere's world
   centre lies within a voxel (at 512) of the world radius. The input's
   albedos carry a per-view scale (1 + 0.01 i); albedo ratios on that
   mesh and the prepared albedos are finite and positive (the line
   prints ratio × scale, which would be flat), and the scaled albedos
   are written. Prints seconds per stage, ms/step
   through the CLI loop, metric reads, snapshot and OBJ write seconds,
   peak memory.
13. render and Testbed: right after phase 10, while the phase-7 trainer
   lives, the host syncs of its step: `torch.cuda.set_sync_debug_mode`
   counts the synchronizing calls of 16 `train_step_async` steps, of a
   32-step `train_steps` call with its one read, and of one
   `_consume_metrics`. Then the renderer on its EMA field at all 14 levels
   (`render_view`): view 0 at 256x256 (silhouette IoU against the
   dataset's alpha ≥ 0.9; depth inside the silhouette within (0.5, 3.0)),
   the same view at 512x612 with the focal length scaled per axis to keep
   the field of view (coverage within 0.01 of the 256x256 one), ms per
   frame, rays/s and peak memory for each, and beside them the device ms
   per frame of the renderer's dense march (`ops/ray_march.march`, its
   own span in one profiled frame) and of the whole frame; and a 32x32
   crop of rays from
   the CPU rendered on the card and by the CPU port on the same
   parameters and bitfield (`render_rays`): albedo, alpha and depth within
   1e-4, alpha x normal within 1e-4. After phase 12, the Python `Testbed`
   on the card on the phase-11 scene: 16 `frame()`s, `render_to_cpu`,
   `compute_marching_cubes_mesh` at 128, and `save_snapshot` /
   `load_snapshot` into a second `Testbed`, equal to the file bit for bit.

14. dynamic: a three-frame sequence at full width (`FrameSequenceTrainer`,
   the unmodified `TestbedConfig()`): the phase-7 sphere's 16 views of
   256x256 with its centre at 0.5 + k·S, S = (0.06, -0.04, 0), the first
   frame 440 steps, each later frame 400 delta steps then 100 canonical
   steps. Launch counts zeroed just before and read just after each
   phase: the delta phases run no training step, launch no backward
   kernel and launch `encode_jacobian` once per delta step (its
   position-differentiable field call); the first frame and the canonical
   phases launch `encode_jacobian` and `corner_backward` once per step
   body. Each later frame meets the JAX tests' criteria
   (tests/test_dynamic.py): R within 0.08 of I, |t + k·S| < 0.5·|k·S|,
   cos(t, -k·S) > 0.8; its mesh at res 256 equals the JAX package's
   (the canonical world-space mesh through the inverse delta, (V − t)·R,
   within 1e-5; faces and normals the canonical mesh's) and has its
   median within 0.5·|k·S| of −t·R, where that formula puts the
   canonical sphere's centre (the world origin; k·S only where R = I,
   and R drifts: its distance to k·S is printed). Before frame 2's
   canonical phase,
   one delta gradient on the card against the CPU port on the same
   uniforms: within 1e-4 relative. Prints ms/step of every phase and the
   peak memory.
15. refinement, on the phase-7 trainer right after phase 13's renderer:
   (a) pose refinement as in tests/test_camera_refine.py (view 0's rays
   offset by (0.03, -0.02, 0), 400 steps of 4096 rays, adam lr 2e-3):
   |t0 + T| < 0.6·|T|, the other views' translations < 0.02; (b) focal
   refinement (every ray corrupted as focal × 1.06, the focal offset
   alone trained, 400 steps): |1.06·(1 + f) − 1| < 0.036 on both axes;
   (a) and (b) launch `encode_jacobian` once per step and no backward
   kernel (the field is frozen). (c) `optimise_mesh_step`, 16 steps
   on the EMA field's mesh at res 256 in the unit cube: the mean
   |‖v − c‖ − 0.25| does not grow. (d) `export_cuda_snapshot` →
   `import_cuda_snapshot` into a fresh `Trainer`: the parameters and
   their EMA equal the EMA's fp16 rounding bit for bit, the density grid
   survives the Morton round trip (its fp16 rounding). (e) 20 full-width
   steps from init with `sparse_adam=False`: finite, the last 5 steps'
   mean color loss below the first 5's, launches per step bucket.
16. options, each at full width from init on the phase-7 sphere beside
   200 steps of the unmodified default config, launches
   counted per level bucket (raises on a rollback or a non-finite loss)
   and 8 more steps under the profiler (per-span device ms):
   (a) aabb_scale 4 as `TestbedConfig.from_network_json(base.json,
   aabb_scale=4)` gives it (cone 1/256, the unit-cube march on
   `march_flat`'s single-phase ladder, as the JAX trainer): 300 steps,
   `sample_and_march` device ms, peak memory; then a 3-cascade grid
   (`update_cascaded` on the trained field's densities) marched by
   `march` at cone 1/256 over 4,096 rays into the cube [−1.5, 2.5]³ on
   the card and by the CPU port: valid and n_valid bit for bit, t
   within 1e-6 relative. (b) the fp16 and rollover emulations together,
   200 steps; one step's gradients (exact backward, 4,096 rays the card
   marched) card vs CPU after `quantize_grads_fp16`: every entry a
   float16 value over 128, each tensor within 2e-3 relative L2 (the
   float32 gradients already differ by up to 5.6e-4 in summation order,
   the variance's one sum over every sample; then a last-bit difference
   can round one fp16 step, 2^-11, apart). (c)
   `light_prng_salt = 1`: one step's draws against salt 0 differ in
   `light_idx` only; 20 steps. (d) bf16 compute, 200 steps; one step's
   loss within 2e-2 and gradients within 3e-2 of each tensor's largest
   entry card vs CPU (the tolerance of tests/test_torch_options.py).
17. extra modes at the JAX tests' sizes (tests/test_extra_modes.py,
   tests/test_takikawa.py), launches counted per fit: `ImageField` on
   the 48x48 pattern, 300 steps (loss < 5e-3, render MSE < 1e-2);
   `SdfField` hash (4 levels, top 64), 250 steps (loss < 5e-3, IoU >
   0.9) and Takikawa (depth 6 from 3), 150 steps (IoU > 0.5);
   `VolumeField` (4 levels, top 32), 300 steps (loss < 5e-3); a 256x256
   SDF shade frame and volume frame, finite; the `Testbed` in Image mode
   from a PNG on disk, 100 steps.
18. data parallelism: `parallel.ParallelTrainer` with two replicas on the
   card (`devices=["cuda:0", "cuda:0"]`) at the full default width on the
   phase-7 sphere, 450 steps on the CLI's schedule (`train_steps(25, 25)`
   18 times: 14 levels from step 411, a full-sweep refresh at every
   cadence past step 256), beside a single `Trainer` from the same init
   on the same schedule: ms/step, device busy ms/step (8 profiled
   `train_step`s), peak memory, each kernel's launches against twice the
   recorded step bodies' count, the replicas' largest parameter
   difference after every read (must be 0), the loss trend against the
   single trainer (the last six reads' mean loss_total within 3 × the sum
   of their spreads, tests/test_parallel.py's rule), then the training
   encode's two kernels against their plain versions on the first
   replica's inputs of one more step (as phase 4 on the main path), and
   a forced rollback
   (both replicas' parameters scaled, then a NaN loss read: both restored
   to the snapshot bit for bit, and training goes on).
19. formats: the phase-7 sphere written twice as a Meshroom-style input
   (`write_sfm_scene`: AliceVision SfMData JSON for normals and albedos,
   a mask folder by pose id): A with 16-bit PNG normals and albedos and
   8-bit PNG masks, B with float EXR normals (`save_exr`), 16-bit TIFF
   albedos (`save_image(".tif")`) and JPEG masks (`save_image(".jpg")`,
   found by `_find_mask_in_folder`'s `.jpg` step). Both loaded and
   prepared on the host: B's prepared albedos and both alphas equal A's,
   its normals within 1 (the count of differing samples printed), the
   same n2w. Then `run_full_pipeline` on B on the card: stage 1 to 133,
   stage 2 to 200, the mesh at 512; launches against the recorded level
   buckets' count (as phase 12); the mesh's median vertex radius within
   a voxel of the world radius. Then every codec on the host at 612x512
   (DiLiGenT-MV's view size; a rendered sphere's normal map): PNG
   16-bit, TIFF LZW 16-bit, EXR ZIP half and float, JPEG 4:2:0 (the
   normal map's 8 bits), ms per view to decode and to encode (each file
   read back exactly; the JPEG decoded twice identically), and a
   4032x3024 JPEG (a camera photo's size) encoded and decoded. Last, the
   seconds of `load_transform_json` on a prepared 16-view 612x512 scene
   of 16-bit PNGs (`scene_load_seconds`; loaded by its path from another
   checkout's root, this file times that checkout's package on the same
   scene). Also the committed JPEG 2000 / Group 4 sphere
   (`jp2_scene_phase`), AVIF sphere (`avif_scene_phase`: lossless
   8-bit 4:4:4 normals, cv2-default albedos, lossless grey masks),
   SGILog / grid-AVIF sphere (`sgilog_scene_phase`: SGILog and SGILog24
   albedos, normals as 2x2 grids of lossless AVIF tiles, PNG masks) and
   sequence / layered AVIF sphere (`avis_scene_phase`: normals as 3-frame
   AVIF sequences whose first frame is the view, albedos as 2-layer
   spatial AVIFs, PNG masks) and the AVIF sphere of plain multi-frame
   streams (`avif_inter_scene_phase`: normals and albedos as libaom
   streams with look-ahead whose last shown frame is the view, together
   using compound prediction, global motion and shown-existing frames,
   PNG masks) and the EXR sphere (`exr_scene_phase`: normals as HALF
   PIZ, DWAA and 16x16-tiled mip-mapped ZIP files in turn, view 0's as
   part 0 of a 2-part file, albedos as FLOAT PXR24 and HALF B44A, PNG
   masks, all written by OpenEXR 3.1.5); each view's decode timed; normals, albedos
   and n2w equal to the JAX package's digests; each through
   `run_full_pipeline` (200 steps, mesh at 256; launches per level
   bucket, radius within a voxel), and the 612x512 JPEG 2000, Group 4,
   AVIF (8-bit q95 colour, lossless 4:4:4 colour, 12-bit unchanged, film
   grain, superres, a sequence's first frame, a 306x256 frame scaled to
   its 612x512 ispe, a 2-layer spatial image, a 4-frame stream with
   compound prediction and global motion) and SGILog / SGILog24
   (`sgilog_view`) decodes, the sphere's 612x512 HALF RGB normal map as
   OpenEXR wrote it in PIZ, PXR24, B44, B44A, DWAA, DWAB and 64x64 ZIP
   tiles (each decode equal to expected.npz), and libwebp's lossless
   analysis of the screenshot-shaped view (`native.vp8l_analyze`)
   alone.

20. final slice (within 90 s): every fixture of
   tests/torch_fixtures/formats (JPEG, TIFF, BMP, PNM, Radiance, Sun
   raster, GIF, WebP, JPEG 2000, AVIF and OpenEXR, written where the CPU
   tests run by its make_fixtures.py with cv2, PIL, libaom and OpenEXR
   3.1.5, which the card's host lacks) decoded on the host in the three read
   modes, equal to cv2's decode in its expected.npz (SGILog TIFFs, AVIF
   film grain, superres, grids, sequences, scaled frames, layered images
   and plain multi-frame streams with compound prediction, global motion
   and the other inter tools among them); EXR files in IMREAD_UNCHANGED
   only, equal to OpenEXR's `InputFile` decode there (PIZ, PXR24, B44,
   B44A, DWAA, DWAB, tiled and multi-part files), their 8-bit colour and
   grey reads refused by name; the files cv2 cannot read raising
   UnreadableImage, those of `REFUSED_FIXTURES` (deep, UINT and
   subsampled EXR) raising UnsupportedImage by name (at least N_FIXTURES
   files) (ms per decode; the 612x512 files, best of 3); `python -m rnb_neus2_torch.tools.mesh_from_snapshot`
   as a subprocess on phase 11's scene and snapshot at resolution 256
   (GT 128): exit 0, its OBJ equal to phase 11's mesh_300.obj (faces
   equal, vertices within 1e-5), its Chamfer printed and not gated (the
   sphere is not the composite scene); `Trainer.train(32)` on a fresh
   default-config trainer on that scene, launches against the recorded
   level buckets' count (as phase 12); then every section of
   `tools/bench_primitives` on the card, one line per row.

21. encode kernels (right after phase 7, ≈ 25 s): the training encode's
   `encode_jacobian` and `corner_backward` kernels against their plain
   versions at the default config (14 levels, F = 2) on 2^18 random
   positions and cotangents: the forward bit for bit with its plain
   version on the card at La = 1, 8 and 14 and with a valid_level, and
   with the CPU's at La = 14; the backward's picks equal the CPU plain
   version's at all 14 levels for K = 1, 2 and salt 0, 3, its gradient
   within 1e-5 of the largest entry, every row that no pick touches
   exactly 0.0 in both; one launch per call. Then both kernels against
   the CPU's plain versions (forward bit for bit, picks equal, gradient
   within 1e-5) on a ragged batch (2^18 − 27 samples: the last tile of
   either kernel is partial) and on positions outside [0, 1] (x·4 − 1.5:
   negative corners, the dense levels' int64 remainder). Prints its
   seconds, and phase 4's encode rows print each kernel's tile plan, its
   shared memory per block and ptxas's registers, stack and spills.

22. loss kernels (right after phase 21): the NeuS composite and loss's
   three kernels (`kernels/neus_loss.py`: the forward's scan and
   composite, the backward) against their plain version run in float64
   on double copies of the same inputs, fed the kernels' float32 prefix
   C and α values, C against the twin of the kernels' own logs (bit for
   bit) and against the twin's prefix of the float32 plain version's
   logs of the same inputs, α against float64's (`testing/loss_batch.
   hold_against_float64`): on the arguments of the
   phase-7 trainer's next step, which is then undone (2^18 slots, 2^16
   rays), on the CPU tests' edge-case batch under each of their
   configurations (`EDGE_CASES`, two of them weighting the eikonal term)
   and on an eight-tile batch whose rays cross tiles (`TILE_CASES`):
   total and metrics within 1e-5 relative, the per-ray colour within 1e-4
   of its largest entry, every gradient entry by entry (at most 1% of a
   tensor's entries off rtol 1e-4 with an atol of 1e-5 of its largest
   entry, none off by 1e-3 of that entry; the variance's sum within 1e-3
   of its terms' magnitudes), the colour and a worst entry also within
   twice the float32 plain version's own error where that version's
   transmittance is right, log T within 1e-4, keep
   equal, one launch of each kernel (`loss_batch.py` states why); the
   samples whose float64 T lies within 1e-4 (relative) of the threshold
   counted and their rays left out, as the rays whose weight sum lies
   on two sides of the mask term's clamp in the two versions. The scan's output (from a forward
   that also writes its logs and C; the training path writes neither),
   entry by entry: its logs within two float32 steps of log1p(−min(α,
   1 − 1e-7)) of its own α, that α within four times the float32 plain
   version's largest α error of the float64 version's, and C against
   the reference's prefix within two float32 steps of max |C| plus
   the logs' summed difference (`loss_batch.scan_checks`). Against the twin of the kernels' own logs
   (`loss_batch.prefix_checks`): C bit for bit, T within one float32
   step, keep equal but where the two T
   straddle 1e-4, log T within two float32 steps of the largest |C| of
   the CPU's `torch.cumsum` of the same logs, and a second forward and
   backward bit for bit with the first. Then each kernel's ms, its plain
   version's and its bound on the main path's arguments, and the two
   forward launches' ms against the whole forward's bound. Every training
   path's launch counts include the three kernels, once per step body.

23. march kernels (right after phase 22): the training march and its
   compaction's four kernels (`kernels/march.py`: the dilated coarse
   grid, the count pass, the scan, the write pass; the coarse grid only
   on the blocked path, cone 0) against the plain march
   (`ops/ray_march.march_flat_plain`) and the twin of their loops
   (`kernels/march.walk_twin`) on the same card tensors, every field bit
   for bit, each kernel launched once per march
   (`testing/march_cases.hold`): on the phase-7 trainer's next step's
   rays, jitter and bitfield (`march_cases.capture_march` between the
   guard's snapshot and restore; 2^16 rays, 2^18 slots), on 2^18 rays of
   the same sampler, on the first 8,192 rays (NB = K/8, where the
   blocked and single-phase kernels must also equal each other), on the
   first 2^16 − 27, on the rays reordered so that the first overflows a
   one-slot budget (total 0), on `march_cases.edge_rays` (rays that miss
   the cube, start inside it, lie on a slab plane, u = 0), on an empty
   and a full bitfield, and at cone 1/256 and aabb_scale 4 with the 1-D
   bitfield (the options path). Then each kernel's ms alone, the four
   launches' and the wrapper's, the plain march's ms and the bounds with
   the walk's cell reads and their 32-byte sectors (`march_bounds`), and
   the phase's seconds. Every training path's launch counts include the
   four kernels once per march (one per step body, delta step and
   refinement step), the coarse grid's 0 at cone > 0.

Then one JSON line with every kernel's numbers (the launches of its
path: the exact steps' for `hash_grad_small` and `scatter_add`, with the
default path's 0 beside them, the K = 1 steps' for the other four; the
pipeline's, the dynamic path's per phase, the refinement's, the
dense-Adam run's, each option path's, each extra-mode fit's, the
data-parallel run's, the formats pipeline's, the JP2 and AVIF scenes'
and `Trainer.train`'s, with
the timings on the first replica's inputs), and as
the last line {"ok": true, "device": {...}}.
Any failed phase raises and the script exits non-zero.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T0 = time.perf_counter()
WALL_LIMIT_S = 1150            # the process is killed past this
TRAIN_STEPS = 440              # bucket 14 from step 411
FULL_LEVEL_STEPS = 20          # at least this many final steps at 14 levels
EXACT_STEPS = 20
LOG_EVERY = 20
CLI_STEPS = 300
TRACE_STEPS = 16               # the CLI's traced window, steps 256-271
FLY_FRAMES = 8
# stage 1 to 666, stage 2 to 1000: at 600 steps the sphere's median
# radius sits on phase 12's one-voxel bound (0.494586), with each ray's
# exact transmittance (0.49455-0.49467) as with the JAX package's
# buffer-wide sum that the loss kernels compute (in a float32 tree
# order 0.494553-0.494688 in 13 runs, one under the bound; rounded once
# from float64, 0.494558-0.494635 in five, two under; PERF.md §6); it
# is about 0.4954 at 1000
PIPELINE_STEPS = 1000
SPHERE = dict(n_views=16, width=256, height=256, radius=0.25)
DYN_FIRST, DYN_DELTA, DYN_NEXT = 440, 400, 100   # phase 14's schedule
DYN_SHIFT = (0.06, -0.04, 0.0)  # the sphere's motion per frame
REFINE_STEPS = 400
REFINE_FOCAL = 560.0           # phase 15's views of the phase-7 sphere
FOCAL_CORRUPT = 0.06
MESH_STEPS = 16
DENSE_STEPS = 20
OPT_AABB_STEPS = 300           # phase 16's option runs
OPT_EMU_STEPS = 200
OPT_SALT_STEPS = 20
OPT_BF16_STEPS = 200
EXTRA_STEPS = {"image": 300, "sdf": 250, "takikawa": 150, "volume": 300}
EXTRA_TESTBED_STEPS = 100      # phase 17's Testbed in Image mode
FORMATS_STEPS = 200            # phase 19: stage 1 to 133, stage 2 to 200
JP2_STEPS = 200                # phase 19's JPEG 2000 / Group 4 scene
JP2_MESH_RES = 256
JP2_SCENE = ROOT / "tests" / "torch_fixtures" / "jp2_scene"
AVIF_STEPS = 200               # phase 19's committed scenes
AVIF_MESH_RES = 256
AVIF_SCENE = ROOT / "tests" / "torch_fixtures" / "avif_scene"
SGILOG_SCENE = ROOT / "tests" / "torch_fixtures" / "sgilog_scene"
AVIS_SCENE = ROOT / "tests" / "torch_fixtures" / "avis_scene"
AVIF_INTER_SCENE = ROOT / "tests" / "torch_fixtures" / "avif_inter_scene"
EXR_SCENE = ROOT / "tests" / "torch_fixtures" / "exr_scene"
CODEC_VIEW = (512, 612)        # phase 19's codec timings: H, W
PHOTO = (3024, 4032)
CODEC_REPEATS = 3              # phase 19's codec rows: the median of 3 (5 until PR 20)
SCENE_LOAD = dict(n_views=16, width=612, height=512, focal=560.0)
SCENE_LOAD_REPEATS = 5
PAR_READS, PAR_SYNC = 18, 25   # phase 18: 450 steps, a read per 25
FIXTURES = ROOT / "tests" / "torch_fixtures" / "formats"   # phase 20
FIXTURE_REPEATS = 3
# phase 20's fixtures that cv2 reads and the port refuses by name (file:
# the feature its UnsupportedImage names)
REFUSED_FIXTURES = {"exr_refused_deep.exr": "deep EXR",
                    "exr_refused_uint.exr": "EXR UINT channel",
                    "exr_refused_subsampled.exr": "subsampled EXR channel"}
N_FIXTURES = 315
TRAIN_API_STEPS = 32
# the loss's kernels, by their counters' names: the forward's two, the
# backward
LOSS_KERNELS = ("neus_loss_scan", "neus_loss_forward", "neus_loss_backward")
# the march's kernels, by their counters' names, in launch order (the
# coarse grid only on the blocked path, cone 0)
MARCH_KERNELS = ("march_coarse", "march_count", "march_scan", "march_write")


def log(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase,
                      "elapsed_s": round(time.perf_counter() - T0, 3),
                      **kw}), flush=True)


def build_all(build, modules) -> None:
    """Phase 2: one compiler per library, all started together."""
    with ThreadPoolExecutor(len(modules)) as pool:
        list(pool.map(lambda mod: mod._library(), modules))
    for mod in modules:
        _, rec = build._LOADED[mod.LIBRARY]
        print(rec["log"], flush=True)
        log("build", library=rec["path"], built=rec["built"],
            seconds=rec["seconds"])


def check_cases(torch, bench, name, fn, plain, dev, cases) -> float:
    """Phase 3 for one kernel over (n, S, F) cases
    (`bench_scatter.check_against_plain`, which raises on a mismatch).
    Returns the largest abs error seen."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    worst = 0.0
    for n, S, F in cases:
        idx = torch.randint(0, S, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
        idx = torch.where(idx % 7 == 0, idx + 1, idx)   # rows left untouched
        out_of_range = torch.rand(n, generator=gen, device=dev) < 0.01
        idx = torch.where(out_of_range, idx + S * (idx % 2 * 2 - 1), idx)
        cf = torch.randn(n, F, generator=gen, device=dev)
        got = fn(idx, cf, S)
        torch.cuda.synchronize()
        want = plain(idx, cf, S)
        err = bench.check_against_plain(name, got, want, idx, S,
                                        exact=False)
        keep = (idx >= 0) & (idx < S)
        n_zero = int((torch.bincount(idx[keep], minlength=S) == 0).sum())
        log("kernel_vs_plain", kernel=name, n=n, S=S, F=F, max_abs_err=err,
            tol=1e-5 * (1.0 + float(want.abs().max())),
            untouched_rows=n_zero, dropped=int((~keep).sum()))
        if n and n_zero == 0:
            raise AssertionError("no untouched rows to check exact zeros")
        worst = max(worst, err)
    return worst


def check_in_place_cases(torch, bench, name, mod, fn_into, dev, S) -> float:
    """Phase 3, in place, at n = 2^18 into a (S, F) view of a larger
    buffer: F = 1, 2, 4 on a zeroed, a random and a misaligned view, and
    the padded hot row. Returns the largest abs error."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    n = 1 << 18
    worst = 0.0
    for F in (1, 2, 4):
        for mode in ("zeroed", "nonzero", "misaligned"):
            idx = torch.randint(-S // 50, S + S // 50, (n,), generator=gen,
                                device=dev, dtype=torch.int32)
            idx = torch.where(idx % 5 == 0, idx + 1, idx)
            v = torch.randn(n, F, generator=gen, device=dev)
            buf, view = bench.in_place_view(S, F, dev, gen,
                                            nonzero=mode == "nonzero",
                                            misaligned=mode == "misaligned")
            before = mod.launches
            err = bench.check_in_place(name, fn_into, buf, view, idx, v)
            if mod.launches != before + 1:
                raise AssertionError(f"{name} in place did not launch")
            log("kernel_vs_plain_in_place", kernel=name, n=n, S=S, F=F,
                view=mode, vector_path=F % 2 == 0 and mode != "misaligned",
                max_abs_err=err)
            worst = max(worst, err)
    idx = torch.randint(0, S, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    v = torch.randn(n, 2, generator=gen, device=dev)
    pad = torch.arange(n, device=dev) >= n // 2
    idx[pad] = 1234
    v[pad] = 0.0
    buf, view = bench.in_place_view(S, 2, dev, gen)
    err = bench.check_in_place(name, fn_into, buf, view, idx, v)
    log("kernel_vs_plain_in_place", kernel=name, n=n, S=S, F=2,
        view="padded hot row", max_abs_err=err)
    return max(worst, err)


def check_kernels_vs_plain(torch, bench, kernels, dev) -> dict:
    """Phase 3. Returns each kernel's largest abs error."""
    hgs, sca = kernels["hash_grad_small"], kernels["scatter_add"]
    n1, n8 = 1 << 18, 1 << 21
    errs = {
        "hash_grad_small": check_cases(
            torch, bench, "hash_grad_small", hgs.grad_small, hgs.plain, dev,
            [(n8, 4096, 2), (n8, 13824, 2), (n1, 4096, 2), (n1, 13824, 2),
             (1_000_003, 13824, 2), (0, 4096, 2), (n8, 32768, 2),
             (1_000_003, 29792, 2)]),
        "scatter_add": check_cases(
            torch, bench, "scatter_add", sca.scatter_add, sca.plain, dev,
            [(n1, 1 << 19, 2), (n1, 39304, 2), (n1, 125000, 2),
             (n1, 373248, 2), (n8, 1 << 19, 2), (262_147, 1 << 19, 2),
             (0, 1 << 19, 2), (n1, 1 << 19, 1)]),
    }
    for name, S in (("hash_grad_small", 13824), ("scatter_add", 1 << 19)):
        errs[name] = max(errs[name], check_in_place_cases(
            torch, bench, name, kernels[name], bench.KERNELS_INTO[name], dev,
            S))
    return errs


def time_inputs(torch, bench, name, mod, dev, card, inputs,
                main_path=False) -> dict:
    """Phase 4 for one kernel module over (S, idx, v) inputs, each first
    checked against the plain version as in phase 3. On the `main_path`
    inputs, for `hash_grad_small`, also `scatter_add`'s in-place entry
    point on the same inputs (`ms_into_scatter_add`). Returns the sums
    over the inputs, and the largest abs error."""
    fn = bench.KERNELS[name]
    fn_into = bench.KERNELS_INTO[name]
    other = (bench.KERNELS_INTO["scatter_add"]
             if main_path and name == "hash_grad_small" else None)
    plain = mod.plain
    keys = ("ms", "ms_into", "plain_ms", "library_ms", "bound_ms",
            "bound_into_ms")
    keys += ("ms_into_scatter_add",) if other else ()
    tot = dict.fromkeys(keys, 0.0)
    tot["max_abs_err"] = 0.0
    for S, idx, v in inputs:
        n, F = v.shape
        err = bench.check_against_plain(name, fn(idx, v, S),
                                        plain(idx, v, S), idx, S,
                                        exact=False)
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        out = torch.zeros(S, F, device=dev)
        row = {
            "ms": bench.time_ms(lambda: fn(idx, v, S)),
            "ms_into": bench.time_ms(lambda: fn_into(out, idx, v)),
            "plain_ms": bench.time_ms(lambda: plain(idx, v, S)),
            "library_ms": bench.time_ms(lambda: torch.zeros(
                S, F, device=dev).index_add_(0, idx, v)),
        }
        if other:
            row["ms_into_scatter_add"] = bench.time_ms(
                lambda: other(out, idx, v))
        row["bound_ms"], bound_by = bench.scatter_bound(n, S, F)
        row["bound_into_ms"], _ = bench.scatter_bound_into(
            n, F, bench.rows_added_to(idx, v, S))
        log("timing", kernel=name, n=n, S=S, F=F, card=card,
            distinct_rows=int(torch.unique(idx).numel()),
            zero_values=int((v == 0).all(1).sum()), max_abs_err=err,
            bound_by=bound_by, **row)
        for k in keys:
            tot[k] += row[k]
        tot["bound_by"] = bound_by
    return tot


def uniform_inputs(torch, dev, sizes, ns) -> list:
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    return [(S, torch.randint(0, S, (n,), generator=gen, device=dev,
                              dtype=torch.int32),
             torch.randn(n, 2, generator=gen, device=dev))
            for n in ns for S in sizes]


def check_small_agreement(torch, dev) -> None:
    """Phase 6a, at a small config whose levels 0 and 1 take the
    shared-memory kernel and levels 2-3 the global-atomics one: the march
    of one CPU ray batch on the card equals the CPU's bit for bit; the loss
    (rtol 1e-5) and every gradient (max error ≤ 1e-4 of the tensor's
    largest entry) agree on the CPU's samples. Exact backward."""
    from rnb_neus2_torch.config import (HashGridConfig, LossConfig,
                                        MarchConfig, NetworkConfig,
                                        RenderFlags)
    from rnb_neus2_torch.grid import occupancy
    from rnb_neus2_torch.models.neus_field import NeusField
    from rnb_neus2_torch.ops import hash_encoding, ray_march
    from rnb_neus2_torch.render.losses import RayBatch, training_loss
    from rnb_neus2_torch.testing.synthetic import sphere_dataset
    from rnb_neus2_torch.train.sampler import draw_uniforms, sample_ray_batch

    grid = HashGridConfig(n_levels=4, top_resolution=64)
    net = NetworkConfig(stoch_corner_bwd=0)
    if hash_encoding.levels_through_kernel(
            hash_encoding.HashGridStatic(grid)) != [0, 1]:
        raise AssertionError("the small config must reach the kernel")
    gen = torch.Generator()
    gen.manual_seed(3)
    cpu_field = NeusField(grid, net, "cpu", gen)
    with torch.no_grad():   # off the init, where w_enc is zero
        cpu_field.sdf_w_enc.normal_(0.0, 0.05, generator=gen)
        cpu_field.hash_table.normal_(0.0, 1e-3, generator=gen)
        bit = occupancy.update(occupancy.init_state(32), cpu_field.density(
            occupancy.cell_positions(32, gen))).bitfield
    ds = sphere_dataset(n_views=4, width=48, height=48, radius=0.2)
    R, S = 256, 1 << 13
    uni = draw_uniforms(R, gen, "cpu")
    batch, samples, pos, _ = sample_ray_batch(ds, bit, R, S, MarchConfig(),
                                              uniforms=uni)
    to = lambda xs, d: [x.to(d) for x in xs]
    on_card = ray_march.march_flat(*to((batch.ray_o, batch.ray_d, bit,
                                        uni.start), dev), 1024, S, 0.0)
    march_equal = all(torch.equal(a.cpu(), b) for a, b in zip(on_card,
                                                              samples))
    results = []
    for d in ("cpu", dev):
        field = NeusField(grid, net, d)
        field.load_state_dict(cpu_field.state_dict())
        loss, _ = training_loss(
            field(pos.to(d)), type(samples)(*to(samples, d)),
            RayBatch(*to(batch, d)), RenderFlags(), LossConfig())
        grads = torch.autograd.grad(loss, list(field.parameters()))
        results.append((float(loss.detach()), [g.cpu() for g in grads]))
    (l0, g0), (l1, g1) = results
    worst = max(float((a - b).abs().max()) / (float(a.abs().max()) + 1e-12)
                for a, b in zip(g0, g1))
    log("agreement", config="small, exact backward",
        march_equal=march_equal, valid_samples=int(samples.valid.sum()),
        loss_cpu=l0, loss_gpu=l1, max_rel_grad_err=worst)
    if not march_equal:
        raise AssertionError("the march on the card differs from the CPU's")
    if abs(l0 - l1) > 1e-5 * abs(l0) or not worst <= 1e-4:
        raise AssertionError("card and CPU disagree on the small config")


def check_stochastic_agreement(torch, dev, n: int = 1 << 16) -> None:
    """Phase 6b: the default config's K = 1 encode backward on the card
    (the `corner_backward` kernel) and on the CPU (its plain version) from
    the same positions, table and cotangents. The kernel's own picks equal
    the CPU's at every level; the table gradients of the training encode
    agree within 1e-5·(1 + max |CPU|), and every entry that no pick
    touches is exactly 0.0 in both."""
    from rnb_neus2_torch.config import HashGridConfig
    from rnb_neus2_torch.kernels import corner_backward as cbw
    from rnb_neus2_torch.ops import hash_encoding as he

    static = he.HashGridStatic(HashGridConfig())
    L = static.cfg.n_levels
    gen = torch.Generator()
    gen.manual_seed(4)
    x = torch.rand(n, 3, generator=gen)
    table = torch.randn(static.n_entries, 2, generator=gen) * 1e-2
    cot = [torch.randn(n, static.cfg.output_dim, generator=gen)
           for _ in range(4)]
    picks, grads = [], []
    for d in ("cpu", dev):
        xd, cd = x.to(d), [c.to(d) for c in cot]
        _, choices = cbw.corner_backward(static, xd, cd[0], cd[1:], L,
                                         (1.0,) * L, 1, 0, static.n_entries,
                                         with_choices=True)
        picks.append(choices.cpu())
        t = table.to(d).requires_grad_(True)
        f, j = he.make_encode_with_jacobian_cv(static, corner_samples=1)(
            t, xd)
        loss = (f * cd[0]).sum() + sum((jd * c).sum()
                                       for jd, c in zip(j, cd[1:]))
        grads.append(torch.autograd.grad(loss, t)[0].cpu())
    differ = (picks[0] != picks[1]).flatten(1).sum(1).tolist()
    touched = _touched(torch, static, x, picks[0])
    want, got = grads
    err = float((got - want).abs().max())
    tol = 1e-5 * (1.0 + float(want.abs().max()))
    zeros_kept = bool((got[~touched] == 0).all()
                      and (want[~touched] == 0).all())
    log("agreement", config="default, K=1 backward", samples=n,
        picks_differ_per_level=differ, max_abs_err=err, tol=tol,
        touched_entries=int(touched.sum()),
        untouched_exactly_zero=zeros_kept)
    if any(differ):
        raise AssertionError(f"picked corners differ on the card: {differ}")
    if not (err <= tol and zeros_kept):
        raise AssertionError("K=1 table gradients disagree card vs CPU")


def _touched(torch, static, x, choices):
    """(n_entries,) bool: the table rows that the (La, K, N) `choices` of
    positions `x` pick (CPU tensors)."""
    from rnb_neus2_torch.ops import hash_encoding as he

    touched = torch.zeros(static.n_entries, dtype=torch.bool)
    for lvl in range(choices.shape[0]):
        idx = he._level_corner_arrays(x, static, lvl)[0]           # (N,8)
        rows = idx.gather(1, choices[lvl].t().long())
        touched[rows.flatten() + int(static.offsets[lvl])] = True
    return touched


def train(torch, kernels, dev, stoch: int, steps: int):
    """Phase 7: one training path at full width from init. Returns
    (summary, trainer)."""
    from rnb_neus2_torch.config import TestbedConfig
    from rnb_neus2_torch.testing.synthetic import sphere_dataset
    from rnb_neus2_torch.train.trainer import Trainer

    cfg = TestbedConfig()
    if stoch != cfg.network.stoch_corner_bwd:
        cfg = dataclasses.replace(cfg, network=dataclasses.replace(
            cfg.network, stoch_corner_bwd=stoch))
    ds = sphere_dataset(n_views=16, width=256, height=256, radius=0.25,
                        device=dev)
    tr = Trainer(ds, cfg, device=dev)
    log("train_setup", stoch_corner_bwd=stoch,
        hash_rows=tr.field.static.n_entries, levels=cfg.grid.n_levels,
        batch=cfg.train.target_batch_size, occ_grid=cfg.train.occ_grid_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.reset_launches()
    hist = []
    for _ in range(steps):
        m = tr.train_step()
        torch.cuda.synchronize()
        hist.append(m)
        if tr.step % LOG_EVERY == 0 or tr.step == steps:
            log("step", stoch_corner_bwd=stoch, step=tr.step,
                step_ms=m["step_ms"], loss_color=m["loss_color"],
                loss_total=m["loss_total"], rays=m["rays_per_batch"],
                levels=m["n_levels_run"], valid=m["n_valid_total"],
                kept=m["n_samples_kept"])
    launches = {name: k.launches for name, k in kernels.items()}
    want = _expected_launches([int(m["n_levels_run"]) for m in hist],
                              k=stoch)
    color = [m["loss_color"] for m in hist]
    totals = [m["loss_total"] for m in hist]
    L = tr.cfg.grid.n_levels
    full = [m for m in hist if m["n_levels_run"] == L]
    trailing_full = 0
    for m in reversed(hist):
        if m["n_levels_run"] != L:
            break
        trailing_full += 1
    summary = {
        "stoch_corner_bwd": stoch, "steps": steps, "launches": launches,
        "launches_expected": want,
        "median_step_ms": statistics.median(m["step_ms"] for m in hist[5:]),
        "median_step_ms_all_levels": statistics.median(
            m["step_ms"] for m in full[-FULL_LEVEL_STEPS:]) if full else None,
        "final_steps_at_all_levels": trailing_full,
        "rays_per_batch_last": hist[-1]["rays_per_batch"],
        "valid_samples_last": hist[-1]["n_valid_total"],
        "kept_samples_last": hist[-1]["n_samples_kept"],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "color_first5": sum(color[:5]) / 5, "color_last5": sum(color[-5:]) / 5,
        "guard": guard_counters(tr),
    }
    log("train", **summary)
    if not all(math.isfinite(v) for v in color + totals):
        raise AssertionError("non-finite loss")
    if not summary["color_last5"] < summary["color_first5"]:
        raise AssertionError("the color loss did not fall")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} in {steps} steps; "
                             f"want {want}")
    return summary, tr


def guard_counters(tr) -> dict:
    """The divergence guard's state after a run."""
    return {"enabled": tr.cfg.train.divergence_guard,
            "rollbacks": tr._guard_total_rollbacks,
            "degraded": not tr.cfg.flags.apply_rgbplus,
            "rearms_used": tr._guard_rearms_used,
            "lr_scale": tr.lr_scale,
            "loss_ema_floor": tr._guard_ema_floor,
            "ek_ema_floor": tr._guard_ek_floor,
            "checkpoint_steps": [g and g["step"] for g in (
                tr._good, tr._anchor, tr._deep_anchor)]}


def forced_rollback(torch, tr, steps: int = 16) -> dict:
    """Phase 8: one NaN color loss through the guard of a trained run; the
    restored state equals the good snapshot bit for bit, the generator
    draws a new stream, and training goes on."""
    good = tr._good
    out = tr._consume_metrics({
        "loss_color": float("nan"), "loss_ek": 0.0, "loss_mask": 0.0,
        "n_valid_total": 1.0, "rays_per_batch": tr._bucket()})
    if not out.get("rolled_back") or tr._good is not good:
        raise AssertionError("a NaN loss did not roll back to the good "
                             "snapshot")
    pairs = [(f"param.{k}", p, good["params"][k])
             for k, p in tr.params.items()]
    for name in ("mu", "nu", "steps", "ema"):
        pairs += [(f"{name}.{k}", t, good["opt"][name][k])
                  for k, t in getattr(tr.opt, name).items()]
    pairs += [(f"emap.{k}", t, getattr(good["emap"], k))
              for k, t in tr.emap._asdict().items()]
    pairs += [(f"occ.{k}", getattr(tr.occ, k), getattr(good["occ"], k))
              for k in ("density", "bitfield", "mean_density")]
    differ = [n for n, a, b in pairs if not torch.equal(a, b)]
    dev = tr.device

    def draws(state):
        g = torch.Generator(device=dev)
        g.set_state(state)
        return torch.rand(1024, generator=g, device=dev)
    new_stream = not torch.equal(draws(tr.generator.get_state()),
                                 draws(good["rng"]))
    restored_step = tr.step
    hist = [tr.train_step() for _ in range(steps)]
    torch.cuda.synchronize()
    color = [m["loss_color"] for m in hist]
    summary = {"restored_step": restored_step,
               "tensors_compared": len(pairs), "tensors_differ": differ,
               "bytes_compared": sum(a.numel() * a.element_size()
                                     for _, a, _ in pairs),
               "new_generator_stream": new_stream,
               "lr_scale_after": tr.lr_scale,
               "rolled_back_after": sum("rolled_back" in m for m in hist),
               "color": color, "loss_ema_restored": good["loss_ema"][0],
               "color_first4": sum(color[:4]) / 4,
               "color_last4": sum(color[-4:]) / 4,
               "guard": guard_counters(tr)}
    log("rollback", **summary)
    if differ or not new_stream:
        raise AssertionError("the rollback did not restore the snapshot "
                             "bit for bit with a new generator stream")
    # falling: below the trailing loss EMA that the snapshot restored
    # (one step's color loss at convergence is noise-dominated)
    if not all(math.isfinite(c) for c in color) \
            or summary["rolled_back_after"] \
            or not sum(color) / steps < good["loss_ema"][0]:
        raise AssertionError("training after the rollback failed")
    return summary


def mesh_export(torch, tr, card) -> dict:
    """Phase 9: the trained field's EMA mesh on the card."""
    import numpy as np
    import tempfile
    from rnb_neus2_torch.mesh import extract, writer
    from rnb_neus2_torch.mesh.marching import marching_cubes_grid
    from rnb_neus2_torch.mesh.marching_device import marching_cubes_device

    field = extract._bind(tr.field, tr.inference_params)
    res = 192
    csdf, active = extract.coarse_pass(field, res, 0.0, 1.0)
    vol = extract.fine_volume(field, csdf, active, res, 0.0, 1.0)
    t0 = time.perf_counter()
    V, F = marching_cubes_device(vol, (0.0, 0.0, 0.0), 1.0 / res)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    V0, F0 = marching_cubes_grid(vol.cpu().numpy(), (0.0, 0.0, 0.0),
                                 1.0 / res)
    t2 = time.perf_counter()
    same = V.shape == V0.shape and F.shape == F0.shape
    err = float(np.abs(V.cpu().numpy() - V0).max()) if same and len(V0) \
        else None
    faces_equal = same and bool(np.array_equal(F.cpu().numpy(), F0))
    log("mesh_vs_host", res=res, vertices=len(V0), faces=len(F0),
        active_blocks=int(active.shape[0]), max_abs_err=err,
        faces_equal=faces_equal, card_s=t1 - t0, numpy_s=t2 - t1)
    if not (faces_equal and len(F0) and err <= 1e-5):
        raise AssertionError("card marching cubes differs from numpy")
    del csdf, vol, V, F
    out = {"vs_host_res192": {"faces": len(F0), "card_s": t1 - t0,
                              "numpy_s": t2 - t1}}
    meta = tr.dataset.meta
    for res in (512, 1024):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        m = extract.extract_mesh(tr.field, tr.inference_params,
                                 resolution=res, meta=meta)
        total = time.perf_counter() - t0
        # back to the unit cube: the sphere of radius 0.25 at its centre
        unit = (m["V"] - np.asarray(meta.n2w_translation)) \
            / meta.n2w_scale * meta.scale + np.asarray(meta.offset)
        r_err = np.abs(np.linalg.norm(unit - 0.5, axis=1) - 0.25)
        row = {"res": res, "vertices": len(m["V"]), "faces": len(m["F"]),
               "active_blocks": m["active_blocks"], "seconds": m["seconds"],
               "total_s": total,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "memory_before": base,
               "radius_err_median": float(np.median(r_err)),
               "radius_err_p99": float(np.percentile(r_err, 99)),
               "card": card}
        if not (len(m["F"]) and np.isfinite(m["V"]).all()
                and np.isfinite(m["N"]).all()
                and row["radius_err_median"] < 0.01):
            log("mesh", **row)
            raise AssertionError(f"the res-{res} mesh is not the sphere")
        if res == 512:
            with tempfile.TemporaryDirectory() as d:
                path = Path(d) / "mesh.obj"
                t0 = time.perf_counter()
                writer.save_mesh(path, m["V"], m["F"], m["N"])
                row["obj_write_s"] = time.perf_counter() - t0
                row["obj_bytes"] = path.stat().st_size
                Vr, Fr = writer.load_obj(path)
            # "%0.5f" rounds by ≤ 5e-6, and parsing to float32 adds an ulp
            row["obj_max_abs_err"] = float(np.abs(Vr - m["V"]).max())
            if not (np.array_equal(Fr, m["F"])
                    and row["obj_max_abs_err"] <= 1e-5):
                log("mesh", **row)
                raise AssertionError("the OBJ does not read back")
        if res == 1024:
            row["slabbed"] = slabbed_export(torch, tr, m, base, card)
            # the slab count the rule picks at this point, for a 1025³
            # volume (an expanded view: no memory)
            row["mc_slabs_rule"] = extract.mc_slabs(torch.empty(
                (1025, 1, 1), device=tr.device).expand(1025, 1025, 1025))
        log("mesh", **row)
        out[f"res{res}"] = row
    return out


def slabbed_export(torch, tr, one_shot: dict, base: int, card) -> dict:
    """Phase 9's res-1024 export again with the slabbed marching cubes (8
    slabs): the mesh must equal the one-shot's; its seconds and peak. Then
    both marching cubes alone on the same fine volume: seconds and the
    memory each allocates beside the volume (peak − allocated before), the
    basis of `extract.MC_BYTES_PER_POINT`."""
    import numpy as np
    from rnb_neus2_torch.mesh import extract
    from rnb_neus2_torch.mesh.marching_device import (
        marching_cubes_device, marching_cubes_device_slabbed)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rule = extract.mc_slabs
    extract.mc_slabs = lambda vol: 8
    try:
        t0 = time.perf_counter()
        m = extract.extract_mesh(tr.field, tr.inference_params,
                                 resolution=1024, meta=tr.dataset.meta)
    finally:
        extract.mc_slabs = rule
    row = {"n_slabs": 8, "seconds": m["seconds"],
           "total_s": time.perf_counter() - t0,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "memory_before": base, "card": card,
           "identical": all(np.array_equal(m[k], one_shot[k])
                            for k in ("V", "F", "N"))}
    del m
    field = extract._bind(tr.field, tr.inference_params)
    csdf, active = extract.coarse_pass(field, 1024, 0.0, 1.0)
    vol = extract.fine_volume(field, csdf, active, 1024, 0.0, 1.0)
    del csdf, active
    meshes = []
    for n, fn in ((1, lambda: marching_cubes_device(vol, (0.0,) * 3,
                                                    1.0 / 1024)),
                  (8, lambda: marching_cubes_device_slabbed(
                      vol, (0.0,) * 3, 1.0 / 1024, 0.0, 8))):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        V, F = fn()
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - before
        row[f"mc_alone_{n}"] = {"seconds": time.perf_counter() - t0,
                                "bytes_beside_volume": extra,
                                "bytes_per_point": extra / vol.numel()}
        meshes.append((V, F))
        del V, F
    row["mc_alone_identical"] = all(torch.equal(a, b) for a, b in
                                    zip(*meshes))
    del vol, meshes
    if not (row["identical"] and row["mc_alone_identical"]):
        log("mesh_slabbed", **row)
        raise AssertionError("the slabbed res-1024 mesh differs from the "
                             "one-shot's")
    return row


def chamfer_protocol(torch, dev, card) -> dict:
    """Phase 10: tests/test_chamfer_gate.py's protocol and gate on the
    card, with the default guard on."""
    from rnb_neus2_torch.config import (HashGridConfig, MarchConfig,
                                        TestbedConfig, TrainConfig)
    from rnb_neus2_torch.mesh.extract import extract_mesh
    from rnb_neus2_torch.mesh.metrics import chamfer_distance
    from rnb_neus2_torch.testing.synthetic import (composite_dataset,
                                                   composite_gt_mesh)
    from rnb_neus2_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    ds = composite_dataset(n_views=12, width=80, height=96,
                           focal=900.0 * 80 / 512, device=dev)
    cfg = TestbedConfig(
        grid=HashGridConfig(n_levels=8, top_resolution=256,
                            log2_hashmap_size=15),
        train=TrainConfig(target_batch_size=1 << 13,
                          initial_rays_per_batch=256,
                          occ_grid_size=64, seed=0),
        march=MarchConfig(n_ladder=1024))
    tr = Trainer(ds, cfg, device=dev)
    t1 = time.perf_counter()
    last = {}
    for _ in range(900):
        last = tr.train_step()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    m = extract_mesh(tr.field, tr.inference_params, resolution=128,
                     meta=ds.meta)
    Vg, Fg = composite_gt_mesh(192)
    Vg = (Vg - 0.5) / 0.5
    ch = chamfer_distance(m["V"], m["F"], Vg, Fg)
    t3 = time.perf_counter()
    row = {**ch, "gate_chamfer_l1": 0.05, "gate_completeness": 0.04,
           "loss_color_last": last["loss_color"], "steps": tr.step,
           "vertices": len(m["V"]), "setup_s": t1 - t0, "train_s": t2 - t1,
           "extract_and_chamfer_s": t3 - t2, "total_s": t3 - t0,
           "guard": guard_counters(tr), "card": card}
    log("chamfer", **row)
    if not (math.isfinite(last["loss_color"]) and ch["chamfer_l1"] < 0.05
            and ch["completeness"] < 0.04):
        raise AssertionError(f"the Chamfer gate failed: {ch}")
    return row


def main_path_inputs(torch, tr) -> list:
    """[(kernel name, S, idx, v)] of one more training step of the trained
    field, level by level: what it gives the in-place entry points."""
    from rnb_neus2_torch.kernels import hash_grad_small as hgs
    from rnb_neus2_torch.kernels import scatter_add as sca

    seen = []

    def hook(mod, attr, name):
        real = getattr(mod, attr)

        def record(out, idx, v):
            seen.append((name, out.shape[0], idx.clone(), v.clone()))
            return real(out, idx, v)
        setattr(mod, attr, record)
        return mod, attr, real

    hooks = [hook(hgs, "grad_small_into", "hash_grad_small"),
             hook(sca, "scatter_add_into", "scatter_add")]
    try:
        tr.train_step()
    finally:
        for mod, attr, real in hooks:
            setattr(mod, attr, real)
    return seen


def encode_inputs(torch, tr) -> dict:
    """The arguments that one more training step of `tr` hands the
    training encode's two kernels' entry points (the first call of each:
    on a `ParallelTrainer`, the first replica's), cloned with their
    layout."""
    from rnb_neus2_torch.kernels import corner_backward as cbw
    from rnb_neus2_torch.kernels import encode_jacobian as ejac

    seen = {}
    real_f, real_b = ejac.encode_jacobian_into, cbw.corner_backward_into

    def fwd(outs, table, positions, static, La, mask):
        seen.setdefault("encode_jacobian", dict(
            table=table.detach().clone(), positions=positions.clone(),
            static=static, La=La, mask=tuple(mask)))
        return real_f(outs, table, positions, static, La, mask)

    def bwd(g_table, static, positions, g_out, g_jac, La, mask, k, salt,
            choices=None):
        seen.setdefault("corner_backward", dict(
            static=static, positions=positions.clone(), g_out=g_out.clone(),
            g_jac=[g.clone() for g in g_jac], La=La, mask=tuple(mask), k=k,
            salt=salt, n_entries=g_table.shape[0]))
        return real_b(g_table, static, positions, g_out, g_jac, La, mask, k,
                      salt, choices)

    ejac.encode_jacobian_into, cbw.corner_backward_into = fwd, bwd
    try:
        tr.train_step()
    finally:
        ejac.encode_jacobian_into, cbw.corner_backward_into = real_f, real_b
    return seen


def _gathered_sectors(torch, a) -> int:
    """Distinct 32-byte sectors of the table that the forward's corner
    rows cover, over its active levels: what its gather must read at the
    least."""
    from rnb_neus2_torch.ops import hash_encoding as he

    static, F = a["static"], a["static"].cfg.n_features_per_level
    sectors = []
    for lvl in range(a["La"]):
        idx = he._level_corner_arrays(a["positions"], static, lvl)[0]
        sectors.append(torch.unique(
            ((idx + int(static.offsets[lvl])) * (F * 4)) // 32))
    return int(torch.unique(torch.cat(sectors)).numel())


def encode_bounds(torch, name: str, a: dict) -> dict:
    """`bound_ms` of one call of the training encode's kernel `name` on
    the inputs `a` (`encode_inputs`): the larger of its bytes over
    3.35 TB/s and its float32 operations over 67 TFLOP/s (bench_scatter's
    rates). Forward: the positions and the four (N, L·F) outputs once,
    and each distinct 32-byte sector of the gathered corner rows once
    (hashed rows scatter, so a row costs a sector); operations ≈ 55 +
    68·F per (sample, level). Backward: the positions and the active
    levels' columns of the four cotangents once, the whole zeroed
    (n_entries, F) gradient written once; operations ≈ 86 + 68·F + K·(20
    + F) per (sample, level)."""
    from rnb_neus2_torch.tools import bench_scatter as bench

    static = a["static"]
    n, La = a["positions"].shape[0], a["La"]
    F, L = static.cfg.n_features_per_level, static.cfg.n_levels
    if name == "encode_jacobian":
        nbytes = n * 12 + 4 * n * L * F * 4 + 32 * _gathered_sectors(torch, a)
        ops = n * La * (55 + 68 * F)
    else:
        k = a["k"]
        nbytes = n * 12 + 4 * n * La * F * 4 + a["n_entries"] * F * 4
        ops = n * La * (86 + 68 * F + k * (20 + F))
    t_bytes, t_ops = nbytes / bench.HBM_BYTES_PER_S, ops / bench.FP32_FLOPS
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": nbytes, "bound_ops": ops}


def time_encode_kernels(torch, bench, dev, card, ins: dict,
                        label: str) -> dict:
    """Each training-encode kernel on its captured inputs `ins`
    (`encode_inputs`): first held against its plain version on the card
    (the forward bit for bit, the backward's picks equal and its gradient
    within 1e-5 of the largest entry), then the allocating call
    (`ms`, the main path's; for the backward also `ms_into`, the kernel
    alone adding into a given gradient, and that at levels 0 and 0–1
    alone, `ms_into_first_levels`), the plain version (`plain_ms`), the
    bound, and each kernel at tile caps of 32, 64 and 96 samples
    (`ms_by_tile`; the kernel's TILE is its fastest), timed as phase 4
    times. Raises on a mismatch."""
    from rnb_neus2_torch.kernels import corner_backward as cbw
    from rnb_neus2_torch.kernels import encode_jacobian as ejac

    t0 = time.perf_counter()
    out = {}
    a = ins["encode_jacobian"]
    fargs = (a["table"], a["positions"], a["static"], a["La"], a["mask"])
    got, want = ejac.encode_jacobian(*fargs), ejac.plain(*fargs)
    torch.cuda.synchronize()
    equal = all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                for g, w in zip(got, want))
    out["encode_jacobian"] = {
        "n": a["positions"].shape[0], "La": a["La"],
        "bit_equal": equal, "max_abs_err": max(
            float((g - w).abs().max()) for g, w in zip(got, want)),
        "ms": bench.time_ms(lambda: ejac.encode_jacobian(*fargs)),
        "plain_ms": bench.time_ms(lambda: ejac.plain(*fargs)),
        "library_ms": None, **encode_bounds(torch, "encode_jacobian", a)}
    b = ins["corner_backward"]
    bargs = (b["static"], b["positions"], b["g_out"], b["g_jac"], b["La"],
             b["mask"], b["k"], b["salt"], b["n_entries"])
    got, gc = cbw.corner_backward(*bargs, with_choices=True)
    want, wc = cbw.plain(*bargs, with_choices=True)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = 1e-5 * float(want.abs().max())
    out["corner_backward"] = {
        "n": b["positions"].shape[0], "La": b["La"], "k": b["k"],
        "g_out_contiguous": b["g_out"].is_contiguous(),
        "picks_differ": int((gc != wc).sum()), "max_abs_err": err,
        "tol": tol, "rows_touched": int((want != 0).any(1).sum()),
        "ms": bench.time_ms(lambda: cbw.corner_backward(*bargs)),
        "ms_into": bench.time_ms(lambda: cbw.corner_backward_into(
            got, *bargs[:-1])),
        "plain_ms": bench.time_ms(lambda: cbw.plain(*bargs)),
        "library_ms": None, **encode_bounds(torch, "corner_backward", b)}
    # the kernel alone at its first levels: level 0's 4,096 hot rows
    out["corner_backward"]["ms_into_first_levels"] = {
        La: bench.time_ms(lambda La=La: cbw.corner_backward_into(
            got, b["static"], b["positions"], b["g_out"], b["g_jac"], La,
            b["mask"], b["k"], b["salt"])) for La in (1, 2)}
    # each kernel at other tile caps than its TILE
    for name, mod, fn in (
            ("encode_jacobian", ejac, lambda: ejac.encode_jacobian(*fargs)),
            ("corner_backward", cbw,
             lambda: cbw.corner_backward_into(got, *bargs[:-1]))):
        real, sweep = mod.TILE, {}
        try:
            for tile in (32, 64, 96):
                mod.TILE = tile
                sweep[tile] = bench.time_ms(fn)
        finally:
            mod.TILE = real
        out[name]["ms_by_tile"] = sweep
    for name, mod in (("encode_jacobian", ejac), ("corner_backward", cbw)):
        out[name].update(kernel_resources(mod, a["static"]))
    seconds = time.perf_counter() - t0
    for name, row in out.items():
        log("encode_kernel_timing", kernel=name, inputs=label, card=card,
            seconds=seconds, **row)
    if not equal or out["corner_backward"]["picks_differ"] or not err <= tol:
        raise AssertionError(f"the encode kernels disagree with their plain "
                             f"versions on the {label} inputs: {out}")
    return out


_PTXAS_USAGE = re.compile(
    r"kernelILi(\d)E.*?\n\s*(\d+) bytes stack frame, (\d+) bytes spill "
    r"stores.*?\n.*?Used (\d+) registers")


def kernel_resources(mod, static) -> dict:
    """One training-encode kernel module's tile plan at `static` (T,
    stages, shared memory per block) and ptxas's registers, stack frame
    and spill stores for its F, from the build log (`-Xptxas -v`)."""
    from rnb_neus2_torch.kernels import build, hash_corners as hc

    L, F = static.cfg.n_levels, static.cfg.n_features_per_level
    T, stages = hc.tile_plan(L, F, mod.TILE)
    row = {"tile": T, "stages": stages, "shared_bytes":
           hc.BARRIER_BYTES + stages * hc.stage_bytes(T, L, F)}
    log_text = build._LOADED[mod.LIBRARY][1]["log"]
    for f, stack, spill, regs in _PTXAS_USAGE.findall(log_text):
        if int(f) == F:
            row.update(registers=int(regs), stack_bytes=int(stack),
                       spill_bytes=int(spill))
    return row


def encode_kernels_phase(torch, bench, dev, card, n: int = 1 << 18
                         ) -> dict:
    """Phase 21: both training-encode kernels against their plain
    versions at the default config (14 levels, F = 2) on n random
    positions and cotangents: the forward bit for bit with the plain
    version on the card (La = 1, 8, 14, and 14 with valid_level 9) and on
    the CPU (La = 14); the backward's picks equal the CPU's at every level
    for K = 1, 2 and salt 0, 3, its gradient within 1e-5 of the largest
    entry, every row that no pick touches 0.0 in both. Returns the
    largest abs errors and the phase's seconds. Then both kernels on a
    ragged batch (n − 27 samples) and on positions outside [0, 1] (x·4 −
    1.5) against the CPU's plain versions: the forward bit for bit, the
    backward's picks (K = 1, salt 0) equal and its gradient within
    1e-5."""
    from rnb_neus2_torch.config import HashGridConfig
    from rnb_neus2_torch.kernels import corner_backward as cbw
    from rnb_neus2_torch.kernels import encode_jacobian as ejac
    from rnb_neus2_torch.ops import hash_encoding as he

    t0 = time.perf_counter()
    static = he.HashGridStatic(HashGridConfig())
    L = static.cfg.n_levels
    gen = torch.Generator()
    gen.manual_seed(21)
    x = torch.rand(n, 3, generator=gen)
    table = torch.randn(static.n_entries, 2, generator=gen) * 1e-2
    cot = [torch.randn(n, static.cfg.output_dim, generator=gen)
           for _ in range(4)]
    xd, td, cd = x.to(dev), table.to(dev), [c.to(dev) for c in cot]
    errs = {"encode_jacobian": 0.0, "corner_backward": 0.0}
    failed = []
    for La, valid in ((1, None), (8, None), (14, None), (14, 9)):
        mask = he._level_mask(La, valid)
        before = ejac.launches
        got = ejac.encode_jacobian(td, xd, static, La, mask)
        twins = [ejac.plain(td, xd, static, La, mask)]
        if La == L and valid is None:
            twins.append(ejac.plain(table, x, static, La, mask))
        torch.cuda.synchronize()
        equal = [all(torch.equal(g.cpu().view(torch.int32),
                                 w.cpu().view(torch.int32))
                     for g, w in zip(got, twin)) for twin in twins]
        err = max(float((g - w).abs().max()) for g, w in zip(got, twins[0]))
        errs["encode_jacobian"] = max(errs["encode_jacobian"], err)
        row = {"La": La, "valid_level": valid, "n": n,
               "bit_equal_card_twin": equal[0],
               "bit_equal_cpu_twin": equal[1] if len(equal) > 1 else None,
               "launches": ejac.launches - before, "max_abs_err": err}
        log("encode_forward_vs_plain", **row)
        if not all(equal) or row["launches"] != 1:
            failed.append(row)
    full = (1.0,) * L
    for k in (1, 2):
        for salt in (0, 3):
            before = cbw.launches
            got, choices = cbw.corner_backward(
                static, xd, cd[0], cd[1:], L, full, k, salt,
                static.n_entries, with_choices=True)
            want, want_choices = cbw.plain(
                static, x, cot[0], cot[1:], L, full, k, salt,
                static.n_entries, with_choices=True)
            got, choices = got.cpu(), choices.cpu()
            touched = _touched(torch, static, x, want_choices)
            err = float((got - want).abs().max())
            tol = 1e-5 * float(want.abs().max())
            errs["corner_backward"] = max(errs["corner_backward"], err)
            row = {"k": k, "salt": salt, "n": n,
                   "launches": cbw.launches - before,
                   "picks_differ_per_level": (choices != want_choices)
                   .flatten(1).sum(1).tolist(),
                   "max_abs_err": err, "tol": tol,
                   "touched_entries": int(touched.sum()),
                   "untouched_exactly_zero": bool(
                       not got[~touched].any() and not want[~touched].any())}
            log("corner_backward_vs_plain", **row)
            if (any(row["picks_differ_per_level"]) or not err <= tol
                    or not row["untouched_exactly_zero"]
                    or row["launches"] != 1):
                failed.append(row)
    for case, xs in (("ragged", x[:n - 27]),
                     ("outside_unit_cube", x * 4.0 - 1.5)):
        m = xs.shape[0]
        cs = [c[:m] for c in cot]
        xsd, csd = xs.to(dev), [c.to(dev) for c in cs]
        before = (ejac.launches, cbw.launches)
        got = ejac.encode_jacobian(td, xsd, static, L, full)
        g, choices = cbw.corner_backward(static, xsd, csd[0], csd[1:], L,
                                         full, 1, 0, static.n_entries,
                                         with_choices=True)
        want = ejac.plain(table, xs, static, L, full)
        wg, wc = cbw.plain(static, xs, cs[0], cs[1:], L, full, 1, 0,
                           static.n_entries, with_choices=True)
        torch.cuda.synchronize()
        g = g.cpu()
        err = float((g - wg).abs().max())
        row = {"case": case, "n": m,
               "launches": [ejac.launches - before[0],
                            cbw.launches - before[1]],
               "bit_equal_cpu_twin": all(
                   torch.equal(a.cpu().view(torch.int32),
                               b.view(torch.int32))
                   for a, b in zip(got, want)),
               "picks_differ": int((choices.cpu() != wc).sum()),
               "max_abs_err": err, "tol": 1e-5 * float(wg.abs().max())}
        errs["corner_backward"] = max(errs["corner_backward"], err)
        log("encode_kernels_case", **row)
        if (not row["bit_equal_cpu_twin"] or row["picks_differ"]
                or not err <= row["tol"] or row["launches"] != [1, 1]):
            failed.append(row)
    seconds = time.perf_counter() - t0
    log("encode_kernels", card=card, seconds=seconds, failed=failed,
        max_abs_err=errs)
    if failed:
        raise AssertionError(f"the encode kernels disagree: {failed}")
    return {"max_abs_err": errs, "seconds": seconds}


def neus_loss_bounds(torch, args, fwd) -> dict:
    """`bound_ms` of each loss kernel on one call's arguments `args` (those
    of a `neus_loss` call) and its forward's outputs `fwd`: the larger of
    its bytes over 3.35 TB/s and its float32 operations over 67 TFLOP/s
    (bench_scatter's rates). What this run's data needs of the function,
    each input read once and each output written once; the kernels'
    intermediates (lw, the tiles' prefixes and totals, the alive mask) do
    not count. The forward (`neus_loss_forward_function`) reads ray_id and
    valid (and the attributes' alive column) per slot, sdf, ∇sdf, dt, the
    direction and v per alive slot (every alive α enters the buffer-wide
    prefix), the raw albedo per kept sample and the per-ray data, and
    writes keep, α and T (the residuals the backward reads) per slot,
    pred4, weight sum and colour per ray and the loss; the scan's and the
    composite's rows split these bytes, each input charged to the first
    kernel that reads it, so that they sum to the forward's. The backward:
    per slot ray_id, keep and valid, per kept sample sdf, ∇sdf, raw
    albedo, dt, the direction, α and T, per ray the forward's pred4 and
    weight sum and the per-ray data; writes the gradients of sdf, ∇sdf,
    raw albedo (and a per-sample variance) every slot. Operations ≈ 60
    per alive slot (α), 40 (composite) and 150 (backward) per kept
    sample."""
    from rnb_neus2_torch.kernels import neus_loss as nl
    from rnb_neus2_torch.tools import bench_scatter as bench

    sdf, grad, alb, v, dirs, inp, opt = args
    S, R = inp.dt.shape[0], inp.seg_start.shape[0]
    alive = int(nl.slot_alive(dirs, inp).sum())
    kept = int(fwd.keep.sum())
    per_sample = inp.per_sample_dirs
    v_per_sample = v.numel() == S and v.dim() == 1
    v_bytes = 4 * (alive if v_per_sample else 1)
    ray_data = R * (8 + 12 + 16 + 4 + 4)    # seg_start, light, target4, masks
    ray_dirs = 0 if per_sample else 12 * R
    scan = (S * (8 + 1 + (4 if per_sample else 0))
            + alive * (4 + 12 + 4 + (12 if per_sample else 0))
            + R * 2 + ray_dirs + v_bytes + 4 * S)
    composite = (kept * 12 + ray_data
                 + S * (1 + 4) + R * (20 + 4) + 4 * 6 + 16)
    bwd_bytes = (S * (8 + 1 + 1) + kept * (4 + 12 + 12 + 4 + 4 + 4
                                          + (12 if per_sample else 0))
                 + R * (20 + 2 + 12 + 16 + 4 + 4) + ray_dirs + 4
                 + 4 * S * 7 + 4 * (S if v_per_sample else 1))
    out = {}
    for name, nbytes, ops in (
            ("neus_loss_scan", scan, 60 * alive),
            ("neus_loss_forward", composite, 40 * kept),
            ("neus_loss_forward_function", scan + composite,
             60 * alive + 40 * kept),
            ("neus_loss_backward", bwd_bytes, 150 * kept)):
        t_bytes, t_ops = nbytes / bench.HBM_BYTES_PER_S, ops / bench.FP32_FLOPS
        out[name] = {"bound_ms": 1e3 * max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "bound_bytes": nbytes, "bound_ops": ops}
    out["alive_slots"], out["kept_samples"] = alive, kept
    return out


def time_loss_kernels(torch, bench, card, args) -> dict:
    """Each loss kernel on one call's arguments (`args`, the main path's):
    its launch alone on buffers allocated once, as the training path runs
    it (`ms`); on the forward's two rows also the two launches together
    (`function_ms`, against the whole forward's bound,
    `function_bound_ms`) and with their allocations (`forward_ms`); the
    plain version in float32 (`plain_ms`: the scan's α, logs and the
    twin's prefix; the forward without autograd; the backward as
    autograd's pass over a kept graph), and the bound
    (`neus_loss_bounds`). No single PyTorch call computes any of them, so
    `library_ms` is None."""
    from rnb_neus2_torch.kernels import neus_loss as nl

    sdf, grad, alb, v, dirs, inp, opt = args
    fields = [x.detach() for x in (sdf, grad, alb, v, dirs)]
    p = nl.prepare(*fields, inp, opt)
    fwd, out = nl.forward_buffers(p)
    nl.launch_scan(p, out)
    nl.launch_forward(p, out)
    g = torch.ones((), device=sdf.device)
    leaves = [x.clone().requires_grad_() for x in fields[:4]] + [fields[4]]
    with torch.no_grad():
        plain_scan = bench.time_ms(lambda: nl.plain_scan(
            leaves[0], leaves[1], leaves[3], leaves[4], inp, opt))
        plain_fwd = bench.time_ms(lambda: nl.plain(*leaves, inp, opt))
    total = nl.plain(*leaves, inp, opt)[0]
    plain_bwd = bench.time_ms(lambda: torch.autograd.grad(
        total, leaves[:4], retain_graph=True))

    def both_launches():
        nl.launch_scan(p, out)
        nl.launch_forward(p, out)
    bounds = neus_loss_bounds(torch, args, fwd)
    function = {"function_ms": bench.time_ms(both_launches),
                "function_bound_ms":
                bounds["neus_loss_forward_function"]["bound_ms"],
                "forward_ms": bench.time_ms(lambda: nl.forward(p))}
    rows = {
        "neus_loss_scan": {"ms": bench.time_ms(lambda: nl.launch_scan(
            p, out)), "plain_ms": plain_scan, "library_ms": None,
            **function},
        "neus_loss_forward": {"ms": bench.time_ms(lambda: nl.launch_forward(
            p, out)), "plain_ms": plain_fwd, "library_ms": None,
            **function},
        "neus_loss_backward": {"ms": bench.time_ms(lambda: nl.backward(
            p, fwd.saved, g, v.shape, False)), "plain_ms": plain_bwd,
            "library_ms": None}}
    for name, row in rows.items():
        row.update(bounds[name])
        log("loss_kernel_timing", kernel=name, card=card, S=p.options.S,
            R=p.options.R, alive_slots=bounds["alive_slots"],
            kept_samples=bounds["kept_samples"], **row)
    return rows


def loss_kernels_phase(torch, bench, dev, card, tr) -> dict:
    """Phase 22: the loss's three kernels against their plain version run
    in float64 fed the kernels' prefix C and α, their α, logs and C against the
    float32 plain version's (C against the twin's prefix of its logs),
    and their prefix against the twin of their own logs (`testing/loss_batch.py:
    hold_against_float64`, whose tolerances it prints) on the arguments of
    the phase-7 trainer's next training step, which is then undone (the
    default config at full width: 2^18 slots, 2^16 rays, 14 levels), on
    the CPU tests' edge-case batch under each of their configurations
    (`EDGE_CASES`) and on the eight-tile batch (`TILE_CASES`):
    the total, the metrics, the per-ray colour and every gradient, with
    the samples whose float64 T lies within 1e−4 (relative) of the
    threshold counted and their rays left out; C bit for bit, T, keep,
    log T against the CPU's cumsum, and repeat runs bit for bit; the
    float32 plain version's own errors (its largest |Δ log T| among them)
    beside the kernels'. Then the kernels' times on the main path's
    arguments (`time_loss_kernels`). Returns the rows of the final line
    and the phase's seconds; raises if a case misses a tolerance."""
    from rnb_neus2_torch.testing import loss_batch as lb

    t0 = time.perf_counter()
    # the next step's arguments, from a step that is then undone: the
    # trainer comes back as it was (the guard's rollback restore), so the
    # later phases that read it start where they would without this one
    state = tr._snapshot_state()
    _, calls = lb.capture_call(tr.train_step_async)
    tr._restore(state)
    if len(calls) != 1:
        raise AssertionError(f"a training step called the loss "
                             f"{len(calls)} times")
    reports, failed = [], []
    for label, args in [("main path", calls[0])] + lb.edge_case_calls(dev):
        rep = lb.hold_against_float64(args, label)
        log("loss_kernels_vs_float64", card=card, **rep)
        reports.append(rep)
        if not rep["ok"]:
            failed.append(label)
    rows = time_loss_kernels(torch, bench, card, calls[0])
    # the scan's error: C against its plain version's (the twin's prefix
    # of the float32 plain version's logs of the same inputs)
    rows["neus_loss_scan"]["max_abs_err"] = max(
        r["scan"]["C_vs_plain_twin_max_abs_err"] for r in reports)
    rows["neus_loss_forward"]["max_abs_err"] = max(
        max(r["kernel"]["forward"]["total_abs_err"],
            r["kernel"]["forward"]["color_max_abs_err"]) for r in reports)
    rows["neus_loss_backward"]["max_abs_err"] = max(
        e["max_abs_err"] for r in reports
        for e in r["kernel"]["grads"].values())
    seconds = time.perf_counter() - t0
    main = reports[0]
    log("loss_kernels", card=card, seconds=seconds, failed=failed,
        longest_segment=main["longest_segment"],
        near_threshold_samples=main["near_threshold_samples"],
        kernel_max_abs_dlogT=main["kernel"]["max_abs_dlogT"],
        plain_float32_max_abs_dlogT=main["plain_float32"]["max_abs_dlogT"],
        scan=main["scan"], prefix=main["prefix"])
    if failed:
        raise AssertionError(f"the loss kernels disagree with the float64 "
                             f"plain version: {failed}")
    return {"rows": rows, "seconds": seconds, "reports": reports}


def march_bounds(torch, p, reads) -> dict:
    """`bound_ms` of each march kernel and of the whole march on one call
    (`p`, its `kernels/march.Plan`; `reads`, the cells that `walk_twin`
    reads in each pass): the larger of its bytes over 3.35 TB/s and its
    float32 operations over 67 TFLOP/s (bench_scatter's rates). The
    function's bytes, each input read once and each output written once:
    o, d and u (28 B per ray), the fine bitfield (g³ B) and the coarse grid
    (cg³ B, blocked path) once, 17 B per slot (t, dt, ray_id, valid) and
    17 B per ray (seg_start, n_valid, ray_kept). Each input is charged to
    the first kernel that reads it and each output to the one that writes
    it, so that the rows sum to the whole: the coarse grid's kernel the
    bitfield and the coarse grid, the count pass the rays and n_valid
    (and the bitfield on the single-phase path), the scan seg_start and
    ray_kept, the write pass the slots. Operations: the coarse grid's
    any-pool and separable dilation, g³ + 6·cg³ ORs; ≈ 40 per cell the
    walk reads (a ladder point, its position, the tests, the index);
    beside them the reads and the distinct 32-byte sectors they touch (the
    sector method of `encode_bounds`)."""
    from rnb_neus2_torch.tools import bench_scatter as bench

    R, S = p.R, p.S
    fine, coarse = p.g ** 3, (p.cg ** 3 if p.blocked else 0)
    sectors = lambda idx: int(torch.unique(idx // 32).numel())
    n_reads = {k: int(v.numel()) for k, v in reads.items()}
    parts = {
        "march_coarse": (fine + coarse if p.blocked else 0,
                         fine + 6 * coarse),
        "march_count": (28 * R + 8 * R + (0 if p.blocked else fine),
                        40 * (n_reads["fine"] + n_reads["coarse"])),
        "march_scan": (9 * R, 4 * R),
        "march_write": (17 * S, 40 * (n_reads["write_fine"]
                                      + n_reads["write_coarse"]) + 4 * S)}
    parts["march"] = tuple(map(sum, zip(*parts.values())))
    out = {}
    for name, (nbytes, ops) in parts.items():
        t_bytes, t_ops = nbytes / bench.HBM_BYTES_PER_S, ops / bench.FP32_FLOPS
        out[name] = {"bound_ms": 1e3 * max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "bound_bytes": nbytes, "bound_ops": ops}
    out["reads"] = {**n_reads, "fine_sectors": sectors(reads["fine"]),
                    "coarse_sectors": sectors(reads["coarse"]),
                    "write_fine_sectors": sectors(reads["write_fine"])}
    return out


def time_march_kernels(torch, bench, card, args, n_ladder, S) -> dict:
    """Each march kernel's launch alone on buffers allocated once
    (`kernels/march.prepare`, then one `run`), the four together (`run`,
    `launches_ms`) and with the wrapper's checks and allocations
    (`march_flat`, `function_ms`), the plain march (`plain_ms`; the coarse
    grid's row: `_coarse_dilated` alone), on one call's arguments, and the
    bounds (`march_bounds`). No single PyTorch call computes any of them,
    so `library_ms` is None."""
    from rnb_neus2_torch.kernels import march as mk
    from rnb_neus2_torch.ops import ray_march

    prep = mk.prepare(*args, n_ladder, S, 0.0)
    mk.run(prep)
    p = prep.plan
    reads = {}
    mk.walk_twin(*args, n_ladder, S, 0.0, reads=reads)
    bounds = march_bounds(torch, p, reads)
    whole = {"function_ms": bench.time_ms(
        lambda: ray_march.march_flat(*args, n_ladder, S, 0.0)),
        "launches_ms": bench.time_ms(lambda: mk.run(prep)),
        "function_bound_ms": bounds["march"]["bound_ms"],
        "function_bound_bytes": bounds["march"]["bound_bytes"]}
    plain_ms = bench.time_ms(
        lambda: ray_march.march_flat_plain(*args, n_ladder, S, 0.0), 10)
    coarse_plain = bench.time_ms(
        lambda: ray_march._coarse_dilated(args[2], p.g), 10)
    rows = {}
    for name, fn in (("march_coarse", mk.launch_coarse),
                     ("march_count", mk.launch_count),
                     ("march_scan", mk.launch_scan),
                     ("march_write", mk.launch_write)):
        rows[name] = {"ms": bench.time_ms(lambda: fn(prep)),
                      "plain_ms": coarse_plain if name == "march_coarse"
                      else plain_ms, "library_ms": None, **bounds[name],
                      **whole}
        log("march_kernel_timing", kernel=name, card=card, R=p.R, S=S,
            K=p.K, NB=p.NB, reads=bounds["reads"], **rows[name])
    return rows


def march_kernels_phase(torch, bench, dev, card, tr) -> dict:
    """Phase 23: the march kernels against the plain march and the twin of
    their loops on the same card tensors, every field bit for bit
    (`testing/march_cases.hold`): on the arguments of the phase-7
    trainer's next step, which is then undone (2^16 rays, 2^18 slots, the
    trained 128³ bitfield); on 2^18 rays of the same sampler; on the first
    8,192 rays (NB = K/8), where the blocked and single-phase results must
    also equal each other; on the first 2^16 − 27 rays; on the rays
    reordered so that the first overflows a one-slot budget (total 0);
    on `edge_rays` (rays that miss the cube, start inside it, lie on a
    slab plane, u = 0); on an empty and a full bitfield; at cone 1/256
    and aabb_scale 4 with the 1-D bitfield (the options path). Then the
    kernels' times on the main path's arguments (`time_march_kernels`).
    Returns the rows of the final line and the phase's seconds; raises
    if any case differs or launches other than once per kernel."""
    from rnb_neus2_torch.ops import ray_march
    from rnb_neus2_torch.testing import march_cases as mc
    from rnb_neus2_torch.train.sampler import sample_ray_batch

    t0 = time.perf_counter()
    state = tr._snapshot_state()
    _, calls = mc.capture_march(tr.train_step_async)
    tr._restore(state)
    if len(calls) != 1:
        raise AssertionError(f"a training step marched {len(calls)} times")
    o, d, bit, u, K, S, cone = calls[0]
    main = (o, d, bit, u)
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    _, big = mc.capture_march(lambda: sample_ray_batch(
        tr.dataset, bit, 1 << 18, S, tr.cfg.march, generator=gen))
    first = lambda n: (o[:n], d[:n], bit, u[:n])
    n_main = ray_march.march_flat_plain(*main, K, S, cone).n_valid
    lead = int(torch.argmax(n_main))
    order = torch.cat([torch.tensor([lead], device=dev),
                       torch.arange(o.shape[0], device=dev)
                       [torch.arange(o.shape[0], device=dev) != lead]])
    edge = [torch.from_numpy(x).to(dev) for x in mc.edge_rays(4099, 23)]
    cases = [
        ("main_path", main, S, 0.0, 1.0),
        ("rays_2^18", big[0][:4], S, 0.0, 1.0),
        ("R_8192", first(8192), S, 0.0, 1.0),
        ("R_2^16-27", first(o.shape[0] - 27), S, 0.0, 1.0),
        ("total_0", (o[order], d[order], bit, u[order]), 1, 0.0, 1.0),
        ("edge_rays", (edge[0], edge[1], bit, edge[2]), S, 0.0, 1.0),
        ("empty_bitfield", (o, d, torch.zeros_like(bit), u), S, 0.0, 1.0),
        ("full_bitfield", (o, d, torch.ones_like(bit), u), S, 0.0, 1.0),
        ("cone_aabb_4", main, S, 1.0 / 256.0, 4.0)]
    reports, failed = [], []
    for label, args, slots, c, aabb in cases:
        rep = mc.hold(args, K, slots, c, aabb, label=label)
        log("march_kernels_case", card=card, **rep)
        reports.append(rep)
        if not rep["ok"]:
            failed.append(label)
    rep = mc.hold(first(8192), K, S, 0.0, blocked=False, label="R_8192_ladder")
    same = all(torch.equal(a, b) for a, b in zip(
        ray_march.march_flat(*first(8192), K, S, 0.0),
        ray_march.march_flat(*first(8192), K, S, 0.0, blocked=False)))
    log("march_kernels_case", card=card, blocked_equals_ladder=same, **rep)
    reports.append(rep)
    if not (rep["ok"] and same):
        failed.append("R_8192_ladder")
    checks = {"total_0": lambda r: r["valid"] == 0 and r["kept"] == 0,
              "empty_bitfield": lambda r: r["valid"] == 0,
              "main_path": lambda r: 0 < r["valid"] <= S and r["blocked"],
              "R_8192": lambda r: r["NB"] == r["K"] // 8,
              "cone_aabb_4": lambda r: not r["blocked"] and r["valid"] > 0}
    failed += [r["label"] for r in reports
               if r["label"] in checks and not checks[r["label"]](r)]
    rows = time_march_kernels(torch, bench, card, main, K, S)
    for name in rows:
        rows[name]["max_abs_err"] = max(r["max_abs_err"] for r in reports)
    seconds = time.perf_counter() - t0
    log("march_kernels", card=card, seconds=seconds, failed=failed,
        cases=len(reports))
    if failed:
        raise AssertionError(f"the march kernels differ from the plain "
                             f"march: {failed}")
    return {"rows": rows, "seconds": seconds, "reports": reports}


def warp_repeats(torch, S, idx, v) -> dict:
    """Of the elements a kernel adds (index in [0, S), a non-zero value),
    the share whose row equals another's in its warp of 32 consecutive
    elements, and the share of atomics that summing such rows first
    removes (1 - distinct rows per warp / elements)."""
    n = idx.numel()
    live = (idx >= 0) & (idx < S) & (v != 0).any(1)
    dead = -1 - torch.arange(n + (-n % 32), device=idx.device)
    key = torch.cat([torch.where(live, idx.long(), dead[:n]), dead[n:]])
    rows = key.view(-1, 32).sort(1).values
    dup = rows[:, 1:] == rows[:, :-1]
    repeat = torch.zeros_like(rows, dtype=torch.bool)
    repeat[:, 1:] |= dup
    repeat[:, :-1] |= dup
    n_live = int(live.sum())
    return {"elements": n_live,
            "repeat_share": int(repeat.sum()) / max(n_live, 1),
            "atomics_removed_share": int(dup.sum()) / max(n_live, 1)}


class _Tee(io.TextIOBase):
    """stdout that is also kept: the pipeline's [INFO] lines carry its
    timings."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, text):
        self.buf.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def _floats(pattern: str, text: str) -> list:
    return [float(m) for m in re.findall(pattern, text)]


def dry_metric_reads(argv) -> int:
    """The metric reads of the CLI's loop for `argv`, run in this process
    on the CPU with the step body, the occupancy refresh and the read
    replaced by counters (only the step and the error map's counters
    advance); the flags that act after the loop are dropped."""
    from rnb_neus2_torch.cli import testbed
    from rnb_neus2_torch.train.trainer import Trainer

    after = {"--save-snapshot": 0, "--save-mesh": 0, "--render-path": 1,
             "--render-frames": 1}
    dry, i = [], 0
    while i < len(argv):
        if argv[i] in after:
            i += 1 + after[argv[i]]
            continue
        dry.append(argv[i])
        i += 1
    reads = []
    saved = {k: getattr(Trainer, k) for k in (
        "_step_body", "refresh_occupancy", "_consume_metrics")}
    Trainer._step_body = lambda self, n_rays, n_active: {}
    Trainer.refresh_occupancy = lambda self, n_active: None
    Trainer._consume_metrics = lambda self, m: reads.append(self.step) or {}
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = testbed.main(dry + ["--device", "cpu"])
    finally:
        for k, v in saved.items():
            setattr(Trainer, k, v)
    if rc != 0:
        raise AssertionError(f"the dry CLI loop exited {rc}")
    return len(reads)


def check_trace(path: Path) -> dict:
    """The Chrome trace of the CLI's --trace-steps: the CUDA functions of
    the kernels that its default path (K = 1) launches, the training
    encode's forward and K-corner backward, the loss's forward and
    backward and the march's four, and the trainer's spans are in it."""
    trace = json.loads(path.read_text())
    events = trace["traceEvents"]
    names = {e.get("name", "") for e in events}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    found = {k: sum(k in e.get("name", "") for e in kernels)
             for k in ("encode_jacobian_kernel", "corner_backward_kernel",
                       *(f"{name}_kernel"
                         for name in LOSS_KERNELS + MARCH_KERNELS))}
    spans = ("occupancy_refresh", "sample_and_march", "field_forward",
             "loss", "backward", "optimizer")
    row = {"trace_bytes": path.stat().st_size, "trace_events": len(events),
           "trace_kernels": len(kernels), "trace_kernel_launches": found,
           "trace_spans_missing": [n for n in spans if n not in names]}
    if not all(found.values()) or row["trace_spans_missing"]:
        raise AssertionError(f"the trace lacks kernels or spans: {row}")
    return row


def cli_phase(torch, dev, card, work: Path) -> dict:
    """Phase 11: the testbed CLI in a subprocess on a scene written to
    disk under `work` (kept for phase 13), with a trace and a fly-through,
    and its snapshot restored here bit for bit."""
    import numpy as np
    from rnb_neus2_torch import interop
    from rnb_neus2_torch.cli import testbed
    from rnb_neus2_torch.io import image_io, png
    from rnb_neus2_torch.io.dataset import load_transform_json
    from rnb_neus2_torch.render.camera_path import CameraKeyframe, CameraPath
    from rnb_neus2_torch.testing.synthetic import (sphere_dataset,
                                                   write_prepared_scene)
    from rnb_neus2_torch.train import snapshot as snap
    from rnb_neus2_torch.train.trainer import Trainer

    scene = work / "scene"
    t0 = time.perf_counter()
    write_prepared_scene(str(scene), **SPHERE)
    t1 = time.perf_counter()
    files = sorted(scene.glob("*/*.png"))
    for f in files:
        image_io.load_image_raw16(f)
    t2 = time.perf_counter()
    big = np.random.default_rng(0).integers(
        0, 65536, (612, 512, 4), dtype=np.uint16)
    big[..., :3] = np.sort(big[..., :3], axis=1)
    png.write_png(work / "big.png", big)
    t3 = time.perf_counter()
    for _ in range(5):
        if not np.array_equal(png.read_png(work / "big.png"), big):
            raise AssertionError("the 612x512 PNG does not read back")
    t4 = time.perf_counter()
    ds = load_transform_json(str(scene), dev)
    t5 = time.perf_counter()
    mem = sphere_dataset(**SPHERE)
    inside = mem.alpha_normal.numpy() > 0.5
    row = {
        "views": SPHERE["n_views"], "png_files": len(files),
        "scene_write_s": t1 - t0,
        "png_decode_ms_per_view_256": 1e3 * (t2 - t1) / len(files) * 2,
        "png_decode_ms_612x512_rgba16": 1e3 * (t4 - t3) / 5,
        "load_transform_json_s": t5 - t4,
        "origin_err": float(np.abs(ds.cameras.origin.cpu().numpy()
                                   - mem.cameras.origin.numpy()).max()),
        "normal_err_in_mask": float(np.abs(
            ds.normals.cpu().numpy()[inside]
            - mem.normals.numpy()[inside]).max()),
        "mask_equal": bool(np.array_equal(
            ds.alpha_normal.cpu().numpy() > 0.5, inside)),
    }
    if not (row["origin_err"] < 1e-5 and row["normal_err_in_mask"]
            < 5e-3 and row["mask_equal"]):
        log("cli", **row)
        raise AssertionError("the written scene does not load back as "
                             "the sphere")
    rot = ds.cameras.rot_c2w.cpu().numpy()
    org = ds.cameras.origin.cpu().numpy()
    cam_path = work / "path.json"
    CameraPath([CameraKeyframe.from_matrix(
        np.concatenate([rot[i], org[i][:, None]], axis=1))
        for i in (0, 4)]).save(str(cam_path))
    argv = ["--scene", str(scene), "--maxiter", str(CLI_STEPS),
            "--save-snapshot", "--save-mesh", "--resolution", "256",
            "--trace-steps", str(TRACE_STEPS), "--render-path",
            str(cam_path), "--render-frames", str(FLY_FRAMES)]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "rnb_neus2_torch.cli.testbed", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    row["cli_s"] = time.perf_counter() - t0
    print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
    out = scene / "output"
    path = out / f"snapshot_{CLI_STEPS}.msgpack"
    if proc.returncode != 0 \
            or f"iteration={CLI_STEPS} loss=" not in proc.stdout \
            or not path.exists() \
            or not (out / f"mesh_{CLI_STEPS}.obj").exists():
        log("cli", returncode=proc.returncode, **row)
        raise AssertionError("the CLI run failed")
    row["cli_ms_per_step"] = _floats(r"\(([\d.]+) ms/step",
                                     proc.stdout)[0]
    # the same without the profiled window
    row["trace_s"] = _floats(r"trace to \S+ in ([\d.]+) s",
                             proc.stdout)[0]
    row["cli_ms_per_step_untraced"] = (
        row["cli_ms_per_step"] * CLI_STEPS - 1e3 * row["trace_s"]) \
        / (CLI_STEPS - TRACE_STEPS)
    row["metric_reads"] = int(_floats(r"([\d]+) metric reads",
                                      proc.stdout)[0])
    row.update(check_trace(out / "trace" / "trace.json"))
    row["metric_reads_schedule"] = dry_metric_reads(
        argv + ["--trace-dir", str(work / "dry_trace")])
    frames = [png.read_png(out / "flythrough" / f"{i:05d}.png")
              for i in range(FLY_FRAMES)]
    row["flythrough_s"] = _floats(r"fly-through frames to \S+ in "
                                  r"([\d.]+) s", proc.stdout)[0]
    row["flythrough_endpoint_diff"] = int(np.abs(
        frames[0].astype(int) - frames[-1].astype(int)).max())
    row["flythrough_alpha_mean"] = [float(f[..., 3].mean() / 255)
                                    for f in frames]
    if row["metric_reads"] != row["metric_reads_schedule"] \
            or len(frames) != FLY_FRAMES \
            or any(f.shape != (256, 256, 4) or f.dtype != np.uint8
                   for f in frames) \
            or not row["flythrough_endpoint_diff"]:
        log("cli", **row)
        raise AssertionError("the CLI's reads, trace or fly-through "
                             "failed")
    row["snapshot_write_s"] = _floats(r"Wrote \d+ bytes in ([\d.]+) s",
                                      proc.stdout)[0]
    row["snapshot_bytes"] = path.stat().st_size
    t0 = time.perf_counter()
    data = snap.load_snapshot(str(path))
    row["snapshot_read_s"] = time.perf_counter() - t0
    cfg = testbed.make_config(testbed.build_argparser().parse_args(argv))
    tr = Trainer(ds, cfg, device=dev)
    t0 = time.perf_counter()
    snap.restore_trainer(tr, data)
    torch.cuda.synchronize()
    row["restore_s"] = time.perf_counter() - t0
    differ = _restore_differences(torch, interop, tr, data)
    row["restored_step"] = tr.step
    row["differ"] = differ
    m = tr.train_step()
    torch.cuda.synchronize()
    row["next_loss_total"] = m["loss_total"]
    row["card"] = card
    log("cli", **row)
    if differ or not math.isfinite(m["loss_total"]):
        raise AssertionError(f"the CLI's snapshot did not restore bit "
                             f"for bit: {differ}")
    return row


def _restore_differences(torch, interop, tr, data) -> list:
    """Names of the restored fields that differ from the snapshot file."""
    import numpy as np
    differ = []

    def same(name, got, want):
        got, want = np.asarray(got), np.asarray(want)
        if got.dtype != want.dtype or not np.array_equal(got, want):
            differ.append(name)

    def walk(name, got, want):
        if isinstance(want, dict):
            if set(got) != set(want):
                differ.append(name)
                return
            for k in want:
                walk(f"{name}.{k}", got[k], want[k])
        else:
            same(name, got, want)

    walk("params", interop.state_dict(interop.params_to_jax(tr.params)),
         data["params"])
    chain, ema = interop.opt_state_to_jax(tr.opt)
    walk("adam_state", chain, data["adam_state"])
    walk("ema_params", interop.state_dict(ema), data["ema_params"])
    grid = np.asarray(data["density_grid"]).astype(np.float32)
    same("density_grid", tr.occ.density.cpu().numpy(), grid)
    d = torch.from_numpy(grid)
    same("bitfield", tr.occ.bitfield.cpu().numpy(),
         (d > torch.clamp_max(torch.clamp_min(d, 0.0).mean(), 0.1)).numpy())
    for name, got in (("density_ema_step", tr.occ.ema_step),
                      ("step", tr.step), ("n_rays", tr.n_rays)):
        if got != int(data[name]):
            differ.append(name)
    for name, ema_m in (("loss_ema", tr.loss_ema), ("ek_ema", tr.ek_ema)):
        want = float(data[name])
        if not (ema_m.value == want or math.isnan(want)
                and not ema_m._initialized) \
                or ema_m.updates != int(data[name + "_updates"]):
            differ.append(name)
    same("torch_rng_state", tr.generator.get_state().numpy(),
         data["torch_rng_state"])
    return differ


def pipeline_phase(torch, kernels, card) -> dict:
    """Phase 12: run_full_pipeline from an IDR input on disk to mesh.obj,
    in this process, with the kernels' launches counted."""
    import numpy as np
    from rnb_neus2_torch.cli import pipeline
    from rnb_neus2_torch.config import HashGridConfig
    from rnb_neus2_torch.io.albedo_scaling import (
        compute_albedo_scale_ratios, scale_and_save_albedos)
    from rnb_neus2_torch.mesh.writer import load_obj
    from rnb_neus2_torch.testing.synthetic import write_idr_scene
    from rnb_neus2_torch.train.trainer import Trainer

    world_center = np.array([0.2, -0.1, 0.3])
    stages, steps, chunks, reads = [], [], [], []
    real = {k: getattr(Trainer, k) for k in (
        "_step_body", "_run_chunk", "_consume_metrics")}
    real_stage = pipeline.run_testbed

    def timed_stage(*a, **k):
        t0 = time.perf_counter()
        real_stage(*a, **k)
        torch.cuda.synchronize()
        stages.append({"stage": a[3], "maxiter": a[1],
                       "seconds": time.perf_counter() - t0})

    def counted_body(self, n_rays, n_active):
        steps.append((self.step, n_active))
        return real["_step_body"](self, n_rays, n_active)

    def counted_chunk(self, n_rays, n_active, chunk):
        chunks.append((self.step, n_active))
        return real["_run_chunk"](self, n_rays, n_active, chunk)

    def counted_read(self, metrics):
        out = real["_consume_metrics"](self, metrics)
        reads.append((self.step, "rolled_back" in out))
        return out

    counted = {"_step_body": counted_body, "_run_chunk": counted_chunk,
               "_consume_metrics": counted_read}

    with tempfile.TemporaryDirectory() as d:
        root = Path(d)
        scales = [(1.0 + 0.01 * i,) * 3 for i in range(SPHERE["n_views"])]
        r_world = write_idr_scene(str(root / "in"), world_center=world_center,
                                  albedo_scales=scales, **SPHERE)
        tee = _Tee(sys.stdout)
        pipeline.run_testbed = timed_stage
        for k, fn in counted.items():
            setattr(Trainer, k, fn)
        forwards, undo_fwd = _record_forwards()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.reset_launches()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(tee):
                mesh_path = pipeline.run_full_pipeline(
                    str(root / "in"), str(root / "out"),
                    max_steps=PIPELINE_STEPS, mesh_resolution=512,
                    device="cuda")
            torch.cuda.synchronize()
        finally:
            pipeline.run_testbed = real_stage
            for k, fn in real.items():
                setattr(Trainer, k, fn)
            undo_fwd()
        total = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.items()}
        text = tee.buf.getvalue()
        n_steps = len(steps)
        # the step bodies' field calls and the mesh's normal chunks
        want = _expected_launches([n for _, n in steps],
                                  forwards=len(forwards))
        # steps whose chunk holds a smaller bucket than the step's own
        held = [s for s, n in steps if n < min(
            b for b in (4, 9, 14) if b >= HashGridConfig().valid_levels(s))]
        prepared = root / "out" / "prepared_data"
        with open(prepared / "transform.json") as f:
            n2w_scale = json.load(f)["n2w"][0][0]
        voxel = 2.0 / 512 * n2w_scale
        t1 = time.perf_counter()
        V, F = load_obj(mesh_path)
        t2 = time.perf_counter()
        radius = float(np.median(np.linalg.norm(V - world_center, axis=1)))
        ratios = compute_albedo_scale_ratios(
            str(prepared / "albedos"), str(prepared / "transform.json"),
            mesh_path, rng=np.random.default_rng(0))
        scale_and_save_albedos(str(prepared / "albedos"),
                               str(root / "scaled"), ratios)
        t3 = time.perf_counter()
        row = {
            "steps": PIPELINE_STEPS, "step_bodies": n_steps,
            "chunks": len(chunks), "chunk_starts": [c for c, _ in chunks],
            "metric_reads": len(reads),
            "rollbacks": sum(rb for _, rb in reads),
            "steps_at_14_levels": sum(n == 14 for _, n in steps),
            "steps_held_below_their_bucket": held,
            "launches": launches, "launches_expected": want,
            "encode_forwards": len(forwards),
            "stages": stages, "total_s": total,
            "ms_per_step_cli": _floats(r"\(([\d.]+) ms/step", text),
            "metric_reads": [int(v) for v in _floats(r"(\d+) metric reads",
                                                     text)],
            "snapshot_write_s": _floats(r"Wrote \d+ bytes in ([\d.]+) s",
                                        text),
            "mesh_extract_and_write_s": re.findall(
                r"extract ([\d.]+) s, write ([\d.]+) s", text),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "vertices": len(V), "faces": len(F), "load_obj_s": t2 - t1,
            "median_radius": radius, "world_radius": r_world,
            "voxel": voxel, "albedo_ratios": ratios[:, 0].tolist(),
            # the ratios undo the views' albedo scales up to one factor
            "albedo_ratio_times_scale": (ratios[:, 0] * np.asarray(
                scales)[:, 0]).tolist(),
            "albedo_s": t3 - t2,
            "scaled_albedos": len(list((root / "scaled").glob("*.png"))),
            "card": card}
    log("pipeline", **row)
    if (launches != want or launches["corner_backward"] != n_steps
            or launches["encode_jacobian"] <= n_steps):
        raise AssertionError(f"kernel launches {launches} in {n_steps} "
                             f"steps; want {want}")
    if row["steps_at_14_levels"] == 0:
        raise AssertionError("stage 2 never ran all 14 levels")
    if not (len(F) and abs(radius - r_world) <= voxel):
        raise AssertionError(f"mesh.obj median radius {radius}, the "
                             f"sphere's {r_world} (voxel {voxel})")
    if not (np.isfinite(ratios).all() and (ratios > 0).all()
            and row["scaled_albedos"] == SPHERE["n_views"]):
        raise AssertionError("albedo scaling failed")
    return row


def host_syncs(torch, tr) -> dict:
    """Phase 13: the synchronizing CUDA calls of the trained run's steps,
    counted with `torch.cuda.set_sync_debug_mode("warn")`: 16
    `train_step_async` steps (no read), their one `_consume_metrics`, and
    a `train_steps(32, sync_every=32)` call. Each count lists the source
    lines that synchronized."""
    import warnings

    def count(fn):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                result = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        where = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
                 if "synchroniz" in str(w.message)]
        return result, {"syncs": len(where),
                        "sources": sorted(set(where))}

    step0 = tr.step
    pending, async_row = count(
        lambda: [tr.train_step_async() for _ in range(16)][-1])
    _, read_row = count(lambda: tr._consume_metrics(pending))
    step1 = tr.step
    _, steps_row = count(lambda: tr.train_steps(32, sync_every=32))
    row = {"steps_async": [step0, step1], "async_16_steps": async_row,
           "consume_metrics": read_row,
           "train_steps_32": {"steps": [step1, tr.step], **steps_row}}
    log("host_syncs", **row)
    return row


def render_march_share(torch, render) -> dict:
    """One frame (`render()`) under `torch.profiler` with the renderer's
    dense march (`ops/ray_march.march`) in a span of its own: the device
    ms per frame of the kernels the march launched, of all the frame's
    device activity, and the march's calls."""
    from torch.autograd import DeviceType
    from rnb_neus2_torch.ops import ray_march

    real, calls = ray_march.march, []

    def spanned(*a, **kw):
        calls.append(1)
        with torch.profiler.record_function("render_march"):
            return real(*a, **kw)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    ray_march.march = spanned
    try:
        with torch.profiler.profile(activities=acts) as prof:
            render()
            torch.cuda.synchronize()
    finally:
        ray_march.march = real

    def in_march(evt):
        while evt is not None:
            if evt.name == "render_march":
                return True
            evt = evt.cpu_parent
        return False
    events = prof.events()
    march_us = sum(k.duration for e in events if in_march(e)
                   for k in e.kernels)
    busy_us = sum(e.time_range.elapsed_us() for e in events
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))
    return {"march_device_ms_per_frame": march_us / 1e3,
            "device_busy_ms_per_frame": busy_us / 1e3,
            "march_calls_per_frame": len(calls)}


def render_phase(torch, tr, card) -> dict:
    """Phase 13: the renderer on the trained run's EMA field on the card,
    against the dataset's silhouette, at 512x612, and against the CPU
    port on a crop of rays; beside each frame size's ms per frame, the
    device ms of its dense march (`render_march_share`)."""
    import numpy as np
    from rnb_neus2_torch.geom.camera import rays_from_pixels
    from rnb_neus2_torch.mesh.extract import _bind
    from rnb_neus2_torch.render import renderer

    field = _bind(tr.field, tr.inference_params)
    cams = tr.dataset.cameras
    bit, march = tr.occ.bitfield, tr.cfg.march

    def timed(cams_v, reps=3):
        renderer.render_view(field, None, cams_v, 0, bit, march)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = renderer.render_view(field, None, cams_v, 0, bit, march)
        ms = (time.perf_counter() - t0) * 1e3 / reps
        W, H = cams_v.resolution
        share = render_march_share(torch, lambda: renderer.render_view(
            field, None, cams_v, 0, bit, march))
        return out, {"W": W, "H": H, "tiles": -(-W * H // 4096),
                     "ms_per_frame": ms, "rays_per_s": W * H / ms * 1e3,
                     **share,
                     "max_memory_allocated": torch.cuda.max_memory_allocated(),
                     "memory_before": base,
                     "alpha_mean": float(out["alpha"].mean()),
                     "finite": bool(all(np.isfinite(v).all()
                                        for v in out.values()))}

    small, row_small = timed(cams)
    gt = tr.dataset.alpha_normal[0].cpu().numpy() > 0.5
    pred = small["alpha"] > 0.5
    row_small["silhouette_iou"] = float((gt & pred).sum()
                                        / max((gt | pred).sum(), 1))
    depth = small["depth"][pred]
    row_small["depth_in_silhouette"] = [float(depth.min()),
                                        float(depth.max())]
    W, H = 512, 612
    scale = torch.tensor([W / cams.resolution[0], H / cams.resolution[1]],
                         device=cams.focal.device)
    big_cams = cams._replace(focal=cams.focal * scale, resolution=(W, H))
    _, row_big = timed(big_cams)
    # a 32x32 crop at the centre of view 0: rays made on the CPU, rendered
    # on the card and by the CPU port
    ys, xs = np.mgrid[112:144, 112:144]
    xy = torch.tensor(np.stack([(xs.ravel() + 0.5) / 256,
                                (ys.ravel() + 0.5) / 256], 1),
                      dtype=torch.float32)
    o, d = rays_from_pixels(cams.to("cpu"), torch.zeros(1024,
                                                        dtype=torch.int64),
                            xy)
    on_card = [t.cpu() for t in renderer.render_rays(
        field, o.to(bit.device), d.to(bit.device), bit, march)]
    t0 = time.perf_counter()
    on_cpu = renderer.render_rays(_bind(tr.field, tr.inference_params)
                                  .to("cpu"), o, d, bit.cpu(), march)
    cpu_s = time.perf_counter() - t0
    names = ("albedo", "depth", "alpha")
    errs = {n: float((a - b).abs().max())
            for n, a, b in zip(names, on_card, on_cpu)}
    errs["alpha_x_normal"] = float((on_cpu[2][:, None] * (
        on_card[3] - on_cpu[3])).abs().max())
    crop = {"max_abs_err": errs, "tol": 1e-4, "cpu_s": cpu_s,
            "alpha_mean": float(on_cpu[2].mean())}
    row = {"res256": row_small, "res512x612": row_big, "crop32": crop,
           "card": card}
    log("render", **row)
    if not (row_small["finite"] and row_big["finite"]
            and row_small["silhouette_iou"] >= 0.9
            and 0.5 < row_small["depth_in_silhouette"][0]
            and row_small["depth_in_silhouette"][1] < 3.0
            and abs(row_big["alpha_mean"] - row_small["alpha_mean"]) < 0.01
            and max(errs.values()) <= 1e-4 and crop["alpha_mean"] > 0.1):
        raise AssertionError(f"the render of the trained sphere failed: "
                             f"{row}")
    return row


def testbed_phase(torch, dev, card, work: Path) -> dict:
    """Phase 13: the Python `Testbed` on the card on the phase-11 scene."""
    import numpy as np
    from rnb_neus2_torch import api, interop
    from rnb_neus2_torch.train import snapshot as snap

    scene = str(work / "scene")
    t = [time.perf_counter()]
    tb = api.Testbed(api.TestbedMode.Nerf, device=dev)
    tb.load_training_data(scene)
    t.append(time.perf_counter())
    frames = sum(tb.frame() for _ in range(16))
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    img = tb.render_to_cpu(0)
    t.append(time.perf_counter())
    shots = screenshot_checks(tb, img, work)
    t.append(time.perf_counter())
    m = tb.compute_marching_cubes_mesh((128, 128, 128))
    t.append(time.perf_counter())
    path = work / "testbed.msgpack"
    tb.save_snapshot(str(path))
    tb2 = api.Testbed(api.TestbedMode.Nerf, device=dev)
    tb2.load_training_data(scene)
    tb2.load_snapshot(str(path))
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    differ = _restore_differences(torch, interop, tb2._trainer,
                                  snap.load_snapshot(str(path)))
    differ += [k for k, p in tb._trainer.params.items()
               if not torch.equal(p, tb2._trainer.params[k])]
    row = {"frames": frames, "step": tb.training_step, "loss": tb.loss,
           "n_params": tb.n_params(), "image_shape": list(img.shape),
           "image_finite": bool(np.isfinite(img).all()),
           "mesh_vertices": len(m["V"]), "mesh_faces": len(m["F"]),
           "snapshot_bytes": path.stat().st_size, "differ": differ,
           "screenshots": shots,
           "seconds": {k: b - a for k, a, b in zip(
               ("load", "16_frames", "render_to_cpu", "screenshots",
                "mesh_128", "snapshot_save_and_load"), t, t[1:])},
           "card": card}
    log("testbed", **row)
    if not (frames == 16 and tb2.training_step == 16 and not differ
            and row["image_finite"] and img.shape == (256, 256, 4)
            and len(m["F"]) and np.isfinite(m["V"]).all()
            and math.isfinite(tb.loss)):
        raise AssertionError(f"the Testbed phase failed: {row}")
    return row


WRITER_FIXTURES = ROOT / "tests" / "torch_fixtures" / "writers"


# the AVIF writer's bounds against cv2's file of the same input (as
# tests/test_torch_image_avif_writer.py holds them): per channel, PSNR at
# most this far under cv2's, max abs error at most this far over
AVIF_PSNR_MARGIN_DB = 0.5
AVIF_MAX_ERR_MARGIN = 8


def avif_error(image, got, ref) -> dict:
    """Per channel PSNR and max abs error against `image` of the port's
    decoded AVIF `got` and of cv2's `ref`, and whether they keep the
    bounds."""
    import numpy as np

    def psnr(a, b):
        mse = float(np.mean((a.astype(np.float64) - b) ** 2))
        return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)

    chans = range(image.shape[2]) if image.ndim == 3 else [None]
    pick = (lambda a, k: a if k is None else a[..., k])
    row = {"psnr_db": [], "cv2_psnr_db": [], "max_abs_err": [],
           "cv2_max_abs_err": []}
    for k in chans:
        x = pick(image, k).astype(np.int64)
        row["psnr_db"].append(psnr(x, pick(got, k)))
        row["cv2_psnr_db"].append(psnr(x, pick(ref, k)))
        row["max_abs_err"].append(int(np.abs(x - pick(got, k)).max()))
        row["cv2_max_abs_err"].append(int(np.abs(x - pick(ref, k)).max()))
    row["within_bounds"] = bool(
        got.shape == ref.shape == image.shape
        and all(a >= b - AVIF_PSNR_MARGIN_DB
                for a, b in zip(row["psnr_db"], row["cv2_psnr_db"]))
        and all(a <= b + AVIF_MAX_ERR_MARGIN
                for a, b in zip(row["max_abs_err"], row["cv2_max_abs_err"])))
    return row


def writer_fixture_checks() -> dict:
    """The port's `.webp`, `.gif`, `.jp2` and `.avif` encoders on the
    committed input against cv2.imwrite's committed files of it
    (tests/torch_fixtures/writers/): GIF and JPEG 2000 byte for byte, the
    WebP (whose bytes are the port's own) pixel for pixel, alpha 0
    included (`webp_alpha0` counts the pixels under alpha 0 whose colour
    libwebp left non-zero), the AVIF (whose bytes are the port's own AV1
    encoder's) read back as the encoder's reconstruction and within the
    bounds of cv2's file's error (`avif_error`), every file decoded by
    the port's reader."""
    import numpy as np
    from rnb_neus2_torch.io import avif, gif, image_io, jpeg2000, webp

    rgba = image_io.read_image(WRITER_FIXTURES / "input.png")
    encoders = {".webp": webp.encode_webp, ".gif": gif.encode_gif,
                ".jp2": jpeg2000.encode_jp2}
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for ext, encode in encoders.items():
            ours = encode(rgba)
            want = (WRITER_FIXTURES / f"cv2{ext}").read_bytes()
            path = Path(d) / f"port{ext}"
            path.write_bytes(ours)
            got = image_io.read_image(path)
            ref = image_io.read_image(WRITER_FIXTURES / f"cv2{ext}")
            if ext == ".webp":
                same = got.shape == ref.shape and np.array_equal(got, ref)
            else:
                same = ours == want and np.array_equal(got, ref)
            out[ext] = {"bytes": len(ours), "cv2_bytes": len(want),
                        "same_bytes": ours == want, "agree": bool(same)}
            if ext == ".webp":
                out[ext]["webp_alpha0"] = int(
                    ref[ref[..., 3] == 0, :3].any(-1).sum())
            if not same:
                raise AssertionError(f"writer fixture {ext}: {out[ext]}")
        ours, recon, arecon = avif.encode_avif_recon(rgba)
        want = (WRITER_FIXTURES / "cv2.avif").read_bytes()
        path = Path(d) / "port.avif"
        path.write_bytes(ours)
        got = image_io.read_image(path)
        row = avif_error(rgba, got, image_io.read_image(
            WRITER_FIXTURES / "cv2.avif"))
        exact = np.array_equal(got, avif.reconstructed(recon, arecon))
        out[".avif"] = {"bytes": len(ours), "cv2_bytes": len(want),
                        "same_bytes": ours == want,
                        "reads_as_reconstruction": exact,
                        "agree": exact and row["within_bounds"], **row}
        if not out[".avif"]["agree"]:
            raise AssertionError(f"writer fixture .avif: {out['.avif']}")
    return out


def screenshot_checks(tb, img, work: Path) -> dict:
    """`Testbed.screenshot` to `.webp`, `.gif`, `.jp2` and `.avif` of the
    frame `img` just rendered (`render_to_cpu` is held to it, so that the
    check is exact), each read back by the port's reader: the JPEG 2000
    equals the 8-bit RGBA that `save_image` makes of it, the WebP the same
    but under alpha 0, where it holds the colour libwebp's analysis leaves
    (`native.vp8l_analyze`, pinned to cv2's files by
    tests/test_torch_image_writers.py), the GIF has the RGBA's shape and
    transparency, the AVIF is the AV1 encoder's reconstruction of that
    RGBA, and the encoders reproduce cv2's committed files
    (`writer_fixture_checks`)."""
    import numpy as np
    from rnb_neus2_torch.io import avif, image_io, native

    rgba = (np.clip(np.nan_to_num(img.astype(np.float32), nan=0.0), 0, 1)
            * 255.0).astype(np.uint8)
    clear = native.vp8l_analyze(rgba)[0]
    seen = rgba[..., 3] > 0
    if not np.array_equal(clear[seen], rgba[seen]):
        raise AssertionError("WebP analysis changed a pixel of alpha > 0")
    # cv2 reads back 3 channels from a WebP without alpha under 255 and
    # a GIF without a transparent pixel
    webp_ch = 4 if (rgba[..., 3] < 255).any() else 3
    gif_ch = 4 if (rgba[..., 3] == 0).any() else 3
    want = {".jp2": rgba, ".webp": clear[..., :webp_ch],
            ".avif": avif.reconstructed(*avif.encode_avif_recon(rgba)[1:])}
    tb.render_to_cpu = lambda view_idx=0, **kw: img
    out = {}
    try:
        for ext in (".webp", ".gif", ".jp2", ".avif"):
            path = work / f"screenshot{ext}"
            t0 = time.perf_counter()
            tb.screenshot(str(path))
            t1 = time.perf_counter()
            got = image_io.read_image(path)
            if ext in want:
                ok = got.dtype == np.uint8 and np.array_equal(got, want[ext])
            else:
                ok = (got.shape == rgba.shape[:2] + (gif_ch,)
                      and got.dtype == np.uint8
                      and (gif_ch == 3 or np.array_equal(
                          got[..., 3] == 0, rgba[..., 3] == 0)))
            out[ext] = {"bytes": path.stat().st_size,
                        "write_ms": (t1 - t0) * 1e3, "agree": bool(ok)}
            if not ok:
                raise AssertionError(f"screenshot {ext}: {out[ext]}")
    finally:
        del tb.render_to_cpu
    out["fixtures"] = writer_fixture_checks()
    return out


def _record_step_bodies(cls=None):
    """Patch `cls._step_body` (`Trainer`'s by default) to record each
    body's level bucket; returns (records, undo)."""
    from rnb_neus2_torch.train.trainer import Trainer

    cls = cls or Trainer
    real = cls.__dict__["_step_body"]
    rec = []

    def counted(self, n_rays, n_active):
        rec.append(n_active)
        return real(self, n_rays, n_active)

    cls._step_body = counted
    return rec, lambda: setattr(cls, "_step_body", real)


def _expected_launches(buckets, grid=None, k: int = 1,
                       forwards: int | None = None,
                       losses: int | None = None,
                       blocked: bool = True) -> dict:
    """Each kernel's launches for step bodies at the given level buckets
    (of `grid`, the default grid if None) with K = `k` picked corners:
    `encode_jacobian` once per training-encode forward (`forwards`; one
    per body, the step's field call, if None); at K ≥ 1 `corner_backward`
    once per body (all its levels in one launch) and neither exact-backward
    kernel; at K = 0 `hash_grad_small` at the dense levels of at most
    2^15 entries (0-1 by default) and `scatter_add` at every other level
    the body runs. The loss's three kernels (the forward's two and the
    backward) once per loss (`losses`; one per body, the step's loss, if
    None), and the march's four once per march: every body, delta step
    and refinement step marches once and computes one loss; the coarse
    grid's kernel only on the blocked path (`blocked`: cone 0)."""
    from rnb_neus2_torch.config import HashGridConfig
    from rnb_neus2_torch.ops import hash_encoding as he

    fwd = len(buckets) if forwards is None else forwards
    n_loss = len(buckets) if losses is None else losses
    loss = {name: n_loss for name in LOSS_KERNELS}
    loss.update({name: n_loss if blocked or name != "march_coarse" else 0
                 for name in MARCH_KERNELS})
    if k:
        return {"hash_grad_small": 0, "scatter_add": 0,
                "encode_jacobian": fwd, "corner_backward": len(buckets),
                **loss}
    static = he.HashGridStatic(grid or HashGridConfig())
    small = sum(len(he.levels_through_kernel(static, b)) for b in buckets)
    return {"hash_grad_small": small, "scatter_add": sum(buckets) - small,
            "encode_jacobian": fwd, "corner_backward": 0, **loss}


def _record_forwards():
    """Patch `NeusField.sdf_and_grad`, the field's one way to the training
    encode (the step's field call, the mesh's normals and colours, a
    render), to count its calls: each is one training-encode forward.
    Returns (calls, undo)."""
    from rnb_neus2_torch.models.neus_field import NeusField

    real = NeusField.__dict__["sdf_and_grad"]
    calls = []

    def counted(self, *a, **kw):
        calls.append(1)
        return real(self, *a, **kw)

    NeusField.sdf_and_grad = counted
    return calls, lambda: setattr(NeusField, "sdf_and_grad", real)


def _to(x, dev, dtype=None):
    """Tensors, and dicts, tuples and NamedTuples of them, moved to `dev`;
    float tensors cast to `dtype` when given."""
    import torch
    if isinstance(x, dict):
        return {k: _to(v, dev, dtype) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        cast = dtype if dtype is not None and x.is_floating_point() \
            else x.dtype
        return x.to(dev, cast)
    if isinstance(x, tuple):
        vals = [_to(v, dev, dtype) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def delta_card_vs_cpu(torch, seq, n_rays: int) -> dict:
    """Phase 14's agreement: one delta gradient of the sequence's current
    state on the card and by the CPU port on the same inputs (the field,
    the delta and the card's marched batch), both in float64. In float32
    the comparison is ill-conditioned at full width: the gradient sums
    ~27k per-sample terms that carry the level-13 lattice scale squared
    (~4e6) and cancel, so the card's and the CPU's rounding alone moved
    it by up to 5.6e-2 relative with the positions made equal (an H100
    80GB HBM3 at 700 W); float64 leaves only the implementations'
    differences. The training encode's forward kernel and the loss's
    kernels take float32 only, so on the card their plain versions stand
    in for them here (phase 21 holds the encode kernel bit for bit
    against its plain version, phase 22 the loss kernels against theirs
    in float64)."""
    from rnb_neus2_torch.kernels import encode_jacobian as ejac
    from rnb_neus2_torch.kernels import neus_loss as nl
    from rnb_neus2_torch.models import delta_network as dn
    from rnb_neus2_torch.train import dynamic
    from rnb_neus2_torch.train.sampler import draw_uniforms

    f64 = torch.float64
    gen = torch.Generator(device=seq.trainer.device)
    gen.manual_seed(14)
    marched = dynamic.sample_ray_batch(
        seq.trainer.dataset, seq.trainer.occ.bitfield, n_rays,
        seq.cfg.train.target_batch_size, seq.cfg.march,
        uniforms=draw_uniforms(n_rays, gen, seq.trainer.device),
        ray_transform=lambda o, d: dn.apply_rigid(seq.delta, o, d))
    state = seq.trainer.field.state_dict()
    real = dynamic.sample_ray_batch
    out = {}
    for name, dev in (("card", seq.trainer.device), ("cpu", "cpu")):
        twin = dynamic.FrameSequenceTrainer(seq.trainer.dataset, seq.cfg,
                                            seq.dyn, device=dev)
        twin.trainer.field.load_state_dict(
            {k: v.to(dev) for k, v in state.items()})
        twin.trainer.field.double()
        twin.delta = _to(seq.delta, dev, f64)
        batch = _to(marched, dev, f64)
        t0 = time.perf_counter()
        dynamic.sample_ray_batch = lambda *a, **k: batch
        kernel, ejac.encode_jacobian = ejac.encode_jacobian, ejac.plain
        loss_kernels, nl.neus_loss = nl.neus_loss, nl.plain
        try:
            loss, grads = twin.delta_grad(n_rays)
        finally:
            dynamic.sample_ray_batch = real
            ejac.encode_jacobian = kernel
            nl.neus_loss = loss_kernels
        out[name] = (float(loss), {k: v.cpu() for k, v in grads.items()},
                     time.perf_counter() - t0)
        del twin
    rel = {k: float((out["card"][1][k] - g).abs().max()
                    / g.abs().max().clamp_min(1e-30))
           for k, g in out["cpu"][1].items()}
    row = {"n_rays": n_rays, "samples": int(marched[1].valid.sum()),
           "dtype": "float64", "loss_card": out["card"][0],
           "loss_cpu": out["cpu"][0], "grad_rel_err": rel,
           "card_s": out["card"][2], "cpu_s": out["cpu"][2]}
    row["passed"] = max(rel.values()) <= 1e-4 and math.isclose(
        row["loss_card"], row["loss_cpu"], rel_tol=1e-5)
    log("dynamic_card_vs_cpu", **row)
    return row


def dynamic_phase(torch, kernels, dev, card) -> dict:
    """Phase 14: a three-frame dynamic sequence at full width on the card
    (`FrameSequenceTrainer`), with the JAX tests' criteria per frame and
    the kernels' launches counted per phase."""
    import numpy as np
    from rnb_neus2_torch.config import TestbedConfig
    from rnb_neus2_torch.io.dataset import SceneMeta, build_dataset
    from rnb_neus2_torch.models import delta_network as dn
    from rnb_neus2_torch.testing.synthetic import (ring_cameras,
                                                   render_sphere_views)
    from rnb_neus2_torch.train import dynamic

    shift = np.asarray(DYN_SHIFT, np.float32)

    def frame(k):
        cams = ring_cameras(16, 1.5, 256, 256, 70.0, device=dev)
        n, a, al = render_sphere_views(cams, center=tuple(0.5 + k * shift),
                                       radius=0.25)
        return build_dataset(cams, n, a, al, al, SceneMeta())

    dyn = dynamic.DynamicConfig(
        first_frame_max_training_step=DYN_FIRST,
        predict_global_movement_training_step=DYN_DELTA,
        next_frame_max_training_step=DYN_NEXT)
    seq = dynamic.FrameSequenceTrainer(frame(0), TestbedConfig(), dyn,
                                       device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bodies, undo = _record_step_bodies()
    rows = []

    def run(name, fn, steps, forwards=None, losses=None):
        """`forwards` and `losses`: the phase's training-encode forwards
        and losses when they are not one per step body (the delta steps'
        position-differentiable field calls and their losses)."""
        for k in kernels.values():
            k.reset_launches()
        start = len(bodies)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        launches = {n: k.launches for n, k in kernels.items()}
        want = _expected_launches(bodies[start:], forwards=forwards,
                                  losses=losses)
        row = {"phase": name, "steps": steps, "seconds": s,
               "ms_per_step": 1e3 * s / steps, "launches": launches,
               "launches_expected": want,
               "step_bodies": len(bodies) - start,
               "levels": sorted(set(bodies[start:]))}
        rows.append(row)
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, want {want}")
        return row

    frames = []
    try:
        run("first_frame", seq.train_first_frame, DYN_FIRST)
        for k in (1, 2):
            ds = frame(k)
            # one field call per delta step, through the forward kernel;
            # the frozen table takes no gradient
            d = run(f"delta_{k}", lambda: seq.predict_movement(ds), DYN_DELTA,
                    forwards=DYN_DELTA, losses=DYN_DELTA)
            if d["step_bodies"] or d["launches"] != {
                    "hash_grad_small": 0, "scatter_add": 0,
                    "encode_jacobian": DYN_DELTA, "corner_backward": 0,
                    **{name: DYN_DELTA
                       for name in LOSS_KERNELS + MARCH_KERNELS}}:
                raise AssertionError("the delta phase ran a training step "
                                     "or launched a scatter kernel")
            delta = {key: v.detach().cpu() for key, v in seq.delta.items()}
            if k == 2:
                card_vs_cpu = delta_card_vs_cpu(
                    torch, seq, max(min(seq.trainer.n_rays, 8192), 4096))
            c = run(f"canonical_{k}", seq.train_frame, DYN_NEXT)
            if c["step_bodies"] != DYN_NEXT \
                    or c["levels"] != [seq.cfg.grid.n_levels]:
                raise AssertionError(f"canonical phase {k}: {c}")
            R = dn.rotation_6d_to_matrix(delta["rotation6d"]).numpy()
            t = delta["translation"].numpy()
            want_t = -k * shift
            # the delta's translation about the unit cube's centre c (the
            # canonical sphere's): R·c + t − c. A rotation about c leaves
            # the sphere's views unchanged, so R drifts there and t, the
            # translation about the cube's corner, trades off against it
            moved = R @ np.full(3, 0.5, np.float32) + t - 0.5
            cos = float(moved @ want_t / (np.linalg.norm(moved)
                                          * np.linalg.norm(want_t) + 1e-9))

            t0 = time.perf_counter()
            m = seq.extract_mesh(resolution=256)
            mesh_s = time.perf_counter() - t0
            # the JAX package's frame mesh: the canonical world-space mesh
            # through the inverse delta, (V − t)·R, normals unturned
            seq.frame, frame_k = 0, seq.frame
            canon = seq.extract_mesh(resolution=256)
            seq.frame = frame_k
            jax_v = (canon["V"] - t) @ R
            mesh_formula_err = float(np.abs(m["V"] - jax_v).max()) \
                if m["V"].shape == jax_v.shape else float("inf")
            same_nf = (np.array_equal(m["F"], canon["F"])
                       and np.array_equal(m["N"], canon["N"]))
            centre = np.median(m["V"], axis=0)
            # where that formula puts the canonical sphere's centre (the
            # world origin): −t·R, which is k·S only where R = I (R drifts:
            # a sphere's rotation is unobservable, and t trades off)
            want_centre = -t @ R
            row = {"frame": k, "rotation_err": float(np.abs(
                R - np.eye(3)).max()), "translation": t.tolist(),
                "translation_err": float(np.linalg.norm(t - want_t)),
                "shift": float(np.linalg.norm(want_t)), "cos": cos,
                "centre_moved": moved.tolist(),
                "centre_moved_err": float(np.linalg.norm(moved - want_t)),
                "delta_loss_first": seq.delta_losses[0],
                "delta_loss_last": seq.delta_losses[-1],
                "mesh_vertices": len(m["V"]), "mesh_s": mesh_s,
                "mesh_formula_err": mesh_formula_err,
                "mesh_same_faces_normals": bool(same_nf),
                "mesh_centre": centre.tolist(),
                "mesh_centre_want": want_centre.tolist(),
                "mesh_centre_err": float(np.linalg.norm(
                    centre - want_centre)),
                "mesh_centre_vs_kS": float(np.linalg.norm(
                    centre - k * shift)),
                "mesh_centre_tol": float(0.5 * np.linalg.norm(k * shift))}
            row["passed"] = (row["rotation_err"] < 0.08
                             and row["centre_moved_err"] < 0.5 * row["shift"]
                             and cos > 0.8 and row["mesh_centre_err"]
                             < row["mesh_centre_tol"]
                             and mesh_formula_err < 1e-5 and same_nf)
            log("dynamic_frame", **row)
            frames.append(row)
    finally:
        undo()
    failed = [f for f in frames if not f["passed"]]
    if failed:
        raise AssertionError(f"frames fail the JAX tests' criteria: {failed}")
    if not card_vs_cpu["passed"]:
        raise AssertionError(f"the delta gradient disagrees card vs CPU: "
                             f"{card_vs_cpu}")
    out = {"phases": rows, "frames": frames, "card_vs_cpu": card_vs_cpu,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "rollbacks": seq.trainer._guard_total_rollbacks, "card": card}
    log("dynamic", **out)
    return out


def refine_phase(torch, kernels, tr, card) -> dict:
    """Phase 15 on the phase-7 trainer: pose and focal refinement (the
    loop of tests/test_camera_refine.py), mesh refinement, a CUDA-testbed
    snapshot round trip, and 20 dense-Adam steps."""
    import numpy as np
    import tempfile
    from rnb_neus2_torch.config import OptimizerConfig, TestbedConfig
    from rnb_neus2_torch.io.dataset import SceneMeta
    from rnb_neus2_torch.mesh import refine
    from rnb_neus2_torch.mesh.extract import extract_mesh
    from rnb_neus2_torch.render.losses import training_loss
    from rnb_neus2_torch.testing.synthetic import sphere_dataset
    from rnb_neus2_torch.train import camera_refine as cr
    from rnb_neus2_torch.train import tcnn_snapshot
    from rnb_neus2_torch.train.sampler import (sample_positions,
                                               sample_ray_batch)
    from rnb_neus2_torch.train.trainer import Trainer

    dev = tr.device
    cfg = tr.cfg
    # the phase-7 sphere through 16 narrower lenses: at focal 70 a view
    # sees it in 0.7% of its pixels (phase 13's alpha_mean), 1.7 of 256
    # rays per view and step, where a 0.02 translation moves its
    # silhouette by under a pixel; at REFINE_FOCAL it fills about a third
    # of each view, as the sphere of the JAX tests' 32x32 views at focal 70
    ds = sphere_dataset(n_views=SPHERE["n_views"], width=SPHERE["width"],
                        height=SPHERE["height"], radius=SPHERE["radius"],
                        focal=REFINE_FOCAL, device=dev)
    lcfg = dataclasses.replace(cfg.loss, ek_loss_weight=0.0)
    out = {"card": card, "views_covered": float(ds.alpha_normal.mean()),
           "phase7_views_covered": float(tr.dataset.alpha_normal.mean())}

    def refine_loop(corrupt, mask):
        """REFINE_STEPS steps of 4096 rays against the frozen field;
        `corrupt(p, img, o, d)` → refined rays; `mask` zeroes gradients
        of the fields it names."""
        gen = torch.Generator(device=dev)
        gen.manual_seed(15)
        params = cr.init_refine_params(ds.n_images, dev)
        opt = cr.make_refiner(params, 2e-3)
        for k in kernels.values():
            k.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REFINE_STEPS):
            batch, samples, _, (img, _) = sample_ray_batch(
                ds, tr.occ.bitfield, 4096, cfg.train.target_batch_size,
                cfg.march, generator=gen)
            p = cr.CameraRefineParams(*(v.detach().requires_grad_()
                                        for v in params))
            with tr.field.frozen():
                o2, d2 = corrupt(p, batch, img)
                out_f = tr.field(sample_positions(o2, d2, samples),
                                 differentiable_positions=True)
                loss, _ = training_loss(out_f, samples, batch._replace(
                    ray_o=o2, ray_d=d2, sample_attrs=None), cfg.flags,
                    lcfg, 1.0)
                grads = torch.autograd.grad(loss, list(p), allow_unused=True,
                                            materialize_grads=True)
            grads = [torch.zeros_like(g) if name in mask else g
                     for name, g in zip(p._fields, grads)]
            params = opt.step(params, cr.CameraRefineParams(*grads))
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        launches = {n: k.launches for n, k in kernels.items()}
        # one forward per step through the position-differentiable
        # encode; the frozen field takes no table gradient; the loss's
        # three kernels and the march's four once per step
        if launches != {"hash_grad_small": 0, "scatter_add": 0,
                        "encode_jacobian": REFINE_STEPS,
                        "corner_backward": 0,
                        **{name: REFINE_STEPS
                           for name in LOSS_KERNELS + MARCH_KERNELS}}:
            raise AssertionError(f"refinement launched {launches}")
        return params, {"seconds": s, "ms_per_step": 1e3 * s / REFINE_STEPS,
                        "launches": launches,
                        "loss_last": float(loss.detach())}

    true_t = torch.tensor([0.03, -0.02, 0.0], device=dev)

    def pose(p, batch, img):
        o = batch.ray_o + true_t * (img == 0)[:, None]
        return cr.refine_rays(p, img, o, batch.ray_d)

    params, row = refine_loop(pose, ())
    t0 = params.trans[0].cpu().numpy()
    row.update(trans_view0=t0.tolist(), err=float(np.linalg.norm(
        t0 + true_t.cpu().numpy())), bound=0.6 * float(true_t.norm()),
        others_max=float(params.trans[1:].abs().max()))
    log("refine_pose", **row)
    out["pose"] = row
    if not (row["err"] < row["bound"] and row["others_max"] < 0.02):
        raise AssertionError(f"pose refinement: {row}")

    corrupt_p = cr.init_refine_params(ds.n_images, dev)._replace(
        focal=torch.full((2,), FOCAL_CORRUPT, device=dev))

    def focal(p, batch, img):
        rot = ds.cameras.rot_c2w[img]
        o1, d1 = cr.refine_rays(corrupt_p, img, batch.ray_o, batch.ray_d,
                                rot_c2w=rot)
        return cr.refine_rays(p, img, o1, d1, rot_c2w=rot)

    params, row = refine_loop(focal, ("rot", "trans", "exposure"))
    eff = (1.0 + FOCAL_CORRUPT) * (1.0 + params.focal.cpu().numpy())
    row.update(effective_focal=eff.tolist(), bound=0.6 * FOCAL_CORRUPT)
    log("refine_focal", **row)
    out["focal"] = row
    if not np.all(np.abs(eff - 1.0) < 0.6 * FOCAL_CORRUPT):
        raise AssertionError(f"focal refinement: {row}")

    # (c) mesh refinement in the unit cube, where the field lives
    t0 = time.perf_counter()
    m = extract_mesh(tr.field, tr.inference_params, 256,
                     meta=SceneMeta(scale=1.0, offset=(0.0, 0.0, 0.0),
                                    from_na=False))
    t1 = time.perf_counter()
    fn = refine.field_sdf_grad_fn(tr.field, tr.inference_params)
    V2 = refine.optimise_mesh_step(fn, m["V"], m["F"], n_steps=MESH_STEPS)
    t2 = time.perf_counter()
    err = lambda V: float(np.mean(np.abs(
        np.linalg.norm(V - 0.5, axis=1) - 0.25)))
    row = {"vertices": len(m["V"]), "steps": MESH_STEPS,
           "extract_s": t1 - t0, "optimise_s": t2 - t1,
           "ms_per_step": 1e3 * (t2 - t1) / MESH_STEPS,
           "radius_err_before": err(m["V"]), "radius_err_after": err(V2),
           "abs_sdf_before": float(np.abs(fn(m["V"])[0]).mean()),
           "abs_sdf_after": float(np.abs(fn(V2)[0]).mean())}
    log("mesh_refine", **row)
    out["mesh_refine"] = row
    if not (np.isfinite(V2).all()
            and row["radius_err_after"] <= row["radius_err_before"]):
        raise AssertionError(f"mesh refinement: {row}")

    # (d) CUDA-testbed snapshot round trip into a fresh trainer
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "snapshot.msgpack")
        t0 = time.perf_counter()
        tcnn_snapshot.export_cuda_snapshot(path, tr)
        t1 = time.perf_counter()
        tr2 = Trainer(tr.dataset, cfg, device=dev)
        t2 = time.perf_counter()
        tcnn_snapshot.import_cuda_snapshot(path, tr2)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        size = Path(path).stat().st_size
    half = lambda t: t.detach().half().float()
    differ = [k for k, p in tr.inference_params.items()
              if not (torch.equal(tr2.params[k].detach(), half(p))
                      and torch.equal(tr2.opt.ema[k], half(p)))]
    grid_ok = torch.equal(tr2.occ.density, half(tr.occ.density))
    row = {"bytes": size, "export_s": t1 - t0, "import_s": t3 - t2,
           "params_differ": differ, "density_round_trip": grid_ok,
           "step": tr2.step, "n_rays": tr2.n_rays}
    log("tcnn_snapshot", **row)
    out["tcnn_snapshot"] = row
    if differ or not grid_ok or (tr2.step, tr2.n_rays) != (tr.step,
                                                           tr.n_rays):
        raise AssertionError(f"CUDA-testbed snapshot round trip: {row}")
    del tr2

    # (e) dense Adam at full width from init
    dense = TestbedConfig(optimizer=OptimizerConfig(sparse_adam=False))
    trd = Trainer(tr.dataset, dense, device=dev)
    for k in kernels.values():
        k.reset_launches()
    hist = []
    t0 = time.perf_counter()
    for _ in range(DENSE_STEPS):
        hist.append(trd.train_step())
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    want = _expected_launches([m["n_levels_run"] for m in hist])
    color = [m["loss_color"] for m in hist]
    row = {"steps": DENSE_STEPS, "seconds": s,
           "ms_per_step": 1e3 * s / DENSE_STEPS, "launches": launches,
           "launches_expected": want, "color_first5": sum(color[:5]) / 5,
           "color_last5": sum(color[-5:]) / 5,
           "finite": all(math.isfinite(m["loss_total"]) for m in hist)}
    log("dense_adam", **row)
    out["dense_adam"] = row
    if not (row["finite"] and row["color_last5"] < row["color_first5"]
            and launches == want):
        raise AssertionError(f"dense Adam: {row}")
    del trd
    return out


def _march_blocked(cfg) -> bool:
    """Whether the trainer's march at `cfg` takes the blocked path (and
    so launches the coarse grid's kernel)."""
    from rnb_neus2_torch.ops import ray_march

    cone = cfg.march.cone_angle
    return ray_march._takes_blocked(ray_march.effective_ladder_points(
        cfg.march.n_ladder, cone), cone, 1)


def _train_counted(torch, kernels, tr, steps: int, label: str,
                   profile_steps: int = 8) -> dict:
    """`steps` train_steps of `tr` with every kernel's launches counted per
    level bucket, then `profile_steps` more under the profiler (per-phase
    device ms). Raises on a non-finite loss, a rollback or a launch count
    that the buckets do not give."""
    from rnb_neus2_torch.tools.profile_step import profile_window

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.reset_launches()
    hist = []
    t0 = time.perf_counter()
    for _ in range(steps):
        hist.append(tr.train_step())
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    want = _expected_launches([int(m["n_levels_run"]) for m in hist],
                              tr.cfg.grid, tr.cfg.network.stoch_corner_bwd,
                              blocked=_march_blocked(tr.cfg))
    peak = torch.cuda.max_memory_allocated()
    prof = profile_window(lambda n: [tr.train_step() for _ in range(n)],
                          profile_steps)
    prof.pop("metrics")
    color = [m["loss_color"] for m in hist]
    row = {"path": label, "steps": steps, "seconds": s,
           "ms_per_step": 1e3 * s / steps,
           "median_step_ms": statistics.median(m["step_ms"]
                                               for m in hist[5:]),
           "launches": launches, "launches_expected": want,
           "levels_last": hist[-1]["n_levels_run"],
           "rays_per_batch_last": hist[-1]["rays_per_batch"],
           "color_first5": sum(color[:5]) / 5,
           "color_last5": sum(color[-5:]) / 5,
           "finite": all(math.isfinite(m["loss_total"]) for m in hist),
           "guard": guard_counters(tr), "max_memory_allocated": peak,
           "profiled_steps": profile_steps,
           "device_ms_per_step": prof["device_busy_ms_per_step"],
           "wall_ms_per_step_profiled": prof["wall_ms_per_step"],
           "idle_share": prof["idle_share"],
           "phase_device_ms": {p: v["device_ms"]
                               for p, v in prof["phases"].items()}}
    log("options_train", **row)
    if not row["finite"] or row["guard"]["rollbacks"] or launches != want:
        raise AssertionError(f"option path {label}: {row}")
    return row


def _card_vs_cpu_grads(torch, tr, loss_cfg, n_rays: int, seed: int):
    """One loss and its gradients on a batch that the card marched from
    `tr`'s state, by a copy of `tr`'s field on the card and one on the
    CPU (the exact backward on both): ((loss, grads) card, (loss, grads)
    CPU), grads by parameter name, on the CPU. The CPU computes the loss
    layer with its plain version in float64 (`loss_batch.plain_float64`):
    the card's loss kernels sum each ray's own log transmittance, the
    float32 plain version the whole buffer's, whose rounding reaches 0.16
    in log T on a full 2^18-slot buffer (phase 22), so the float32 CPU
    loss is no yardstick for the card's."""
    from rnb_neus2_torch.kernels import neus_loss as nl
    from rnb_neus2_torch.models.neus_field import NeusField
    from rnb_neus2_torch.render.losses import training_loss
    from rnb_neus2_torch.testing.loss_batch import plain_float64
    from rnb_neus2_torch.train.sampler import draw_uniforms, sample_ray_batch

    dev = tr.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    batch, samples, pos, _ = sample_ray_batch(
        tr.dataset, tr.occ.bitfield, n_rays, tr.cfg.train.target_batch_size,
        tr.cfg.march, uniforms=draw_uniforms(n_rays, gen, dev))
    net = dataclasses.replace(tr.cfg.network, stoch_corner_bwd=0)
    state = tr.field.state_dict()
    out = []
    real = nl.neus_loss
    for d in (dev, "cpu"):
        field = NeusField(tr.cfg.grid, net, d)
        field.load_state_dict({k: v.to(d) for k, v in state.items()})
        nl.neus_loss = real if d == dev else plain_float64
        try:
            loss, _ = training_loss(field(pos.to(d)), _to(samples, d),
                                    _to(batch, d), tr.cfg.flags, loss_cfg,
                                    1.0)
        finally:
            nl.neus_loss = real
        names = [n for n, _ in field.named_parameters()]
        grads = torch.autograd.grad(loss, list(field.parameters()))
        out.append((float(loss.detach()),
                    {n: g.detach().cpu() for n, g in zip(names, grads)}))
        del field
    return out[0], out[1], int(samples.valid.sum())


def options_phase(torch, kernels, dev, card, ds) -> dict:
    """Phase 16: the JAX trainer's options at full width on the phase-7
    sphere, each from a random init (module docstring)."""
    import numpy as np
    from rnb_neus2_torch.config import TestbedConfig
    from rnb_neus2_torch.grid import occupancy
    from rnb_neus2_torch.ops import ray_march
    from rnb_neus2_torch.render.losses import quantize_grads_fp16
    from rnb_neus2_torch.train.sampler import draw_uniforms
    from rnb_neus2_torch.train.trainer import Trainer, light_generator

    base = ROOT / "rnb_neus2_torch" / "configs" / "nerf" / "base.json"
    out = {}

    # the unmodified default config over the same steps, for comparison
    tr = Trainer(ds, TestbedConfig(), device=dev)
    out["default"] = _train_counted(torch, kernels, tr, OPT_EMU_STEPS,
                                    "default")
    out["default"]["card"] = card
    del tr

    # (a) aabb_scale 4 as from_network_json gives it: cone 1/256, the
    # per-level scale of top_resolution·4, the unit-cube march
    cfg = TestbedConfig.from_network_json(str(base), aabb_scale=4.0)
    if cfg.march.cone_angle != 1.0 / 256.0 or cfg.grid.aabb_scale != 4.0:
        raise AssertionError(f"from_network_json(aabb_scale=4): {cfg.grid}, "
                             f"{cfg.march}")
    tr = Trainer(ds, cfg, device=dev)
    row = _train_counted(torch, kernels, tr, OPT_AABB_STEPS, "aabb_scale_4")
    row["card"] = card
    # a 3-cascade grid from the trained field, marched at cone 1/256 over
    # the cube [−1.5, 2.5]³ on the card and by the CPU port
    C, G = 3, occupancy.NERF_GRIDSIZE
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    pts = occupancy.cascade_cell_positions(G, C, gen, dev)
    with torch.no_grad():
        dens = torch.cat([tr.field.density(p) for p in pts.split(1 << 20)])
    state = occupancy.update_cascaded(
        occupancy.init_state_cascaded(G, C, dev), dens.reshape(C, -1))
    rng = np.random.default_rng(16)
    R = 4096
    o = rng.normal(size=(R, 3))
    o = 0.5 + 3.6 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = 0.5 + (rng.random((R, 3)) - 0.5) * 0.8 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    args = [torch.as_tensor(a.astype(np.float32))
            for a in (o, d, rng.random(R))]
    marched = []
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        m = ray_march.march(args[0].to(where), args[1].to(where),
                            state.bitfield.to(where), args[2].to(where),
                            cfg.march.n_ladder, 256, 1.0 / 256.0,
                            aabb_scale=4.0)
        if where != "cpu":
            torch.cuda.synchronize()
        marched.append((_to(m, "cpu"), time.perf_counter() - t0))
    (mc, card_s), (mh, cpu_s) = marched
    t_rel = float(((mc.t - mh.t).abs() / mh.t.abs().clamp_min(1e-30))
                  [mh.valid].max()) if bool(mh.valid.any()) else 0.0
    march_row = {
        "rays": R, "cascades": C, "occupied_cells": [
            int(b.sum()) for b in state.bitfield],
        "valid_equal": torch.equal(mc.valid, mh.valid),
        "n_valid_equal": torch.equal(mc.n_valid, mh.n_valid),
        "valid_samples": int(mh.valid.sum()),
        "n_valid_sum": int(mh.n_valid.sum()),
        "valid_differ": int((mc.valid != mh.valid).sum()),
        "t_max_rel_err": t_rel, "card_s": card_s, "cpu_s": cpu_s}
    log("options_cascaded_march", **march_row)
    row["cascaded_march"] = march_row
    out["aabb_scale_4"] = row
    if not (march_row["valid_equal"] and march_row["n_valid_equal"]
            and t_rel <= 1e-6 and march_row["valid_samples"] > 0):
        raise AssertionError(f"cascaded march card vs CPU: {march_row}")
    del tr, pts, dens, state

    # (b) the fp16 and rollover gradient emulations together
    cfg = TestbedConfig()
    emu = dataclasses.replace(cfg, loss=dataclasses.replace(
        cfg.loss, fp16_grad_emulation=True, rollover_grad_emulation=True))
    tr = Trainer(ds, emu, device=dev)
    row = _train_counted(torch, kernels, tr, OPT_EMU_STEPS, "emulations")
    (lc, gc), (lh, gh), n_valid = _card_vs_cpu_grads(
        torch, tr, emu.loss, 4096, 161)
    qc = quantize_grads_fp16(gc)
    qh = quantize_grads_fp16(gh)
    not_fp16 = [k for k, g in qc.items()
                if not torch.equal((g * 128.0).half().float(), g * 128.0)]
    rel_l2 = lambda a, b: {k: float((a[k] - g).norm()
                                    / g.norm().clamp_min(1e-30))
                           for k, g in b.items()}
    rel = rel_l2(qc, qh)
    agree = {"valid_samples": n_valid, "loss_card": lc, "loss_cpu": lh,
             "grad_rel_l2": rel, "unquantized_rel_l2": rel_l2(gc, gh),
             "not_fp16_over_128": not_fp16,
             "table_zero_entries_card": int((qc["hash_table"] == 0).sum()),
             "table_zero_entries_cpu": int((qh["hash_table"] == 0).sum())}
    log("options_emulation_card_vs_cpu", **agree)
    row["card_vs_cpu"] = agree
    row["card"] = card
    out["emulations"] = row
    if not_fp16 or max(rel.values()) > 2e-3 or not math.isclose(
            lc, lh, rel_tol=1e-5):
        raise AssertionError(f"emulation gradients card vs CPU: {agree}")
    del tr

    # (c) light_prng_salt: one step's draws against salt 0
    draws = []
    for salt in (0, 1):
        g = torch.Generator(device=dev)
        g.manual_seed(cfg.train.seed)
        lg = light_generator(dataclasses.replace(
            cfg.train, light_prng_salt=salt), dev)
        draws.append(draw_uniforms(1 << 14, g, dev, False, lg))
    same = {f: torch.equal(getattr(draws[0], f), getattr(draws[1], f))
            for f in ("xy", "skip", "start", "light_idx")}
    salted = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, light_prng_salt=1))
    tr = Trainer(ds, salted, device=dev)
    row = _train_counted(torch, kernels, tr, OPT_SALT_STEPS, "light_salt")
    row.update(draws_equal=same, card=card)
    log("options_light_salt", draws_equal=same)
    out["light_salt"] = row
    if same != {"xy": True, "skip": True, "start": True,
                "light_idx": False}:
        raise AssertionError(f"salted draws: {same}")
    del tr

    # (d) bfloat16 compute
    bf = dataclasses.replace(cfg, network=dataclasses.replace(
        cfg.network, compute_dtype="bfloat16"))
    tr = Trainer(ds, bf, device=dev)
    row = _train_counted(torch, kernels, tr, OPT_BF16_STEPS, "bfloat16")
    (lc, gc), (lh, gh), n_valid = _card_vs_cpu_grads(
        torch, tr, bf.loss, 4096, 162)
    worst = {k: float((gc[k] - g).abs().max() / g.abs().max().clamp_min(
        1e-30)) for k, g in gh.items()}
    agree = {"valid_samples": n_valid, "loss_card": lc, "loss_cpu": lh,
             "grad_max_err_of_max": worst}
    log("options_bf16_card_vs_cpu", **agree)
    row.update(card_vs_cpu=agree, card=card)
    out["bfloat16"] = row
    if max(worst.values()) > 3e-2 or not math.isclose(lc, lh, rel_tol=2e-2):
        raise AssertionError(f"bf16 card vs CPU: {agree}")
    del tr
    torch.cuda.empty_cache()
    return out


def _fit_counted(torch, kernels, label: str, fit) -> dict:
    """`fit()` → (loss, extra dict), with every kernel's launches counted
    and its seconds."""
    torch.cuda.synchronize()
    for k in kernels.values():
        k.reset_launches()
    t0 = time.perf_counter()
    loss, extra = fit()
    torch.cuda.synchronize()
    row = {"fit": label, "loss": loss, "seconds": time.perf_counter() - t0,
           "launches": {n: k.launches for n, k in kernels.items()}, **extra}
    return row


def extra_modes_phase(torch, kernels, dev, card, work: Path) -> dict:
    """Phase 17: the Image, Sdf and Volume workloads on the card at the
    JAX tests' sizes (module docstring)."""
    import numpy as np
    from rnb_neus2_torch import api
    from rnb_neus2_torch.config import HashGridConfig
    from rnb_neus2_torch.io.image_io import save_image
    from rnb_neus2_torch.models import extra_modes as em
    from rnb_neus2_torch.ops import hash_encoding as he
    from rnb_neus2_torch.testing.synthetic import icosphere

    def per_step(grid, steps):
        """The features-only encode: the exact backward's kernels per
        level, no training-encode kernel."""
        static = he.HashGridStatic(grid)
        small = len(he.levels_through_kernel(static))
        return {"hash_grad_small": small * steps,
                "scatter_add": (grid.n_levels - small) * steps,
                "encode_jacobian": 0, "corner_backward": 0,
                **{name: 0 for name in LOSS_KERNELS + MARCH_KERNELS}}

    rows = {}
    H = W = 48
    ys, xs = np.mgrid[0:H, 0:W]
    img = np.stack([np.sin(xs / 6.0) * 0.5 + 0.5,
                    np.cos(ys / 9.0) * 0.5 + 0.5,
                    ((xs + ys) % 16) / 16.0], -1).astype(np.float32)

    def image():
        f = em.ImageField(device=dev)
        params, loss = f.fit(img, n_steps=EXTRA_STEPS["image"], batch=4096)
        mse = float(np.mean((f.render(params, W, H) - img) ** 2))
        return loss, {"render_mse": mse}

    rows["image"] = _fit_counted(torch, kernels, "image", image)
    rows["image"]["launches_expected"] = {
        "hash_grad_small": 0,
        "scatter_add": em.Hash2D().n_levels * EXTRA_STEPS["image"],
        "encode_jacobian": 0, "corner_backward": 0,
        **{name: 0 for name in LOSS_KERNELS + MARCH_KERNELS}}
    V, F = icosphere(0.3, (0.5, 0.5, 0.5), subdiv=2)
    sdf_grid = HashGridConfig(n_levels=4, top_resolution=64)
    fields = {}

    def sdf_hash():
        f = em.SdfField(sdf_grid, device=dev)
        _, loss = f.fit(V, F, n_steps=EXTRA_STEPS["sdf"], batch=2048)
        fields["sdf"] = f
        return loss, {"iou": f.calculate_iou(n_samples=1 << 13)}

    rows["sdf_hash"] = _fit_counted(torch, kernels, "sdf_hash", sdf_hash)
    rows["sdf_hash"]["launches_expected"] = per_step(sdf_grid,
                                                     EXTRA_STEPS["sdf"])

    def sdf_takikawa():
        f = em.SdfField(encoding="takikawa", octree_depth=6,
                        octree_starting_level=3, device=dev)
        _, loss = f.fit(V, F, n_steps=EXTRA_STEPS["takikawa"],
                        batch=1 << 11)
        levels = sum(len(k) > 0 for k in f.octree.cell_keys)
        return loss, {"iou": f.calculate_iou(n_samples=1 << 13),
                      "octree_levels": levels,
                      "octree_vertices": f.octree.n_vertices}

    rows["sdf_takikawa"] = _fit_counted(torch, kernels, "sdf_takikawa",
                                        sdf_takikawa)
    rows["sdf_takikawa"]["launches_expected"] = {
        "hash_grad_small": 0, "scatter_add":
            rows["sdf_takikawa"]["octree_levels"] * EXTRA_STEPS["takikawa"],
        "encode_jacobian": 0, "corner_backward": 0,
        **{name: 0 for name in LOSS_KERNELS + MARCH_KERNELS}}
    g = np.mgrid[0:24, 0:24, 0:24] / 24.0
    vol = np.exp(-(((g - 0.5) ** 2).sum(0)) / 0.05).astype(np.float32)
    vol_grid = HashGridConfig(n_levels=4, top_resolution=32)

    def volume():
        f = em.VolumeField(vol_grid, device=dev)
        _, loss = f.fit(vol, n_steps=EXTRA_STEPS["volume"], batch=4096)
        fields["volume"] = f
        return loss, {}

    rows["volume"] = _fit_counted(torch, kernels, "volume", volume)
    rows["volume"]["launches_expected"] = per_step(vol_grid,
                                                   EXTRA_STEPS["volume"])
    # frames of the fitted SDF (shade) and volume
    t0 = time.perf_counter()
    shade = fields["sdf"].render(W=256, H=256, mode="shade")
    t1 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    frame = fields["volume"].render(W=256, H=256, generator=gen)
    t2 = time.perf_counter()
    renders = {"sdf_shade_finite": bool(np.isfinite(shade).all()),
               "sdf_coverage": float(shade[..., 3].mean()),
               "sdf_shade_s": t1 - t0,
               "volume_finite": bool(np.isfinite(frame).all()),
               "volume_mean": float(frame[..., :3].mean()),
               "volume_s": t2 - t1}
    log("extra_renders", **renders)
    # the Testbed facade, Image mode, from a PNG on disk
    path = str(work / "pattern.png")
    save_image(img, path, bit_depth=16)
    tb = api.Testbed(api.TestbedMode.Image, device=dev)
    tb.load_training_data(path)
    frames = sum(tb.frame() for _ in range(4))
    tb.train(EXTRA_TESTBED_STEPS - 4)
    out_img = tb.render_to_cpu()
    testbed = {"mode": "Image", "frames": frames, "step": tb.training_step,
               "loss": tb.loss, "image_shape": list(out_img.shape),
               "render_mse": float(np.mean((out_img - img) ** 2))}
    log("extra_testbed", **testbed)
    for r in rows.values():
        r["card"] = card
        log("extra_fit", **r)
    failed = [k for k, r in rows.items()
              if r["launches"] != r["launches_expected"]
              or not math.isfinite(r["loss"])]
    gates = {"image": rows["image"]["loss"] < 5e-3
             and rows["image"]["render_mse"] < 1e-2,
             "sdf_hash": rows["sdf_hash"]["loss"] < 5e-3
             and rows["sdf_hash"]["iou"] > 0.9,
             "sdf_takikawa": rows["sdf_takikawa"]["iou"] > 0.5,
             "volume": rows["volume"]["loss"] < 5e-3,
             "renders": renders["sdf_shade_finite"]
             and renders["volume_finite"] and renders["sdf_coverage"] > 0,
             "testbed": frames == 4
             and tb.training_step == EXTRA_TESTBED_STEPS
             and out_img.shape == (H, W, 3)
             and testbed["render_mse"] < 5e-2}
    if failed or not all(gates.values()):
        raise AssertionError(f"extra modes: launches/loss {failed}, "
                             f"gates {gates}")
    return {"fits": rows, "renders": renders, "testbed": testbed}


def _parallel_run(torch, kernels, tr, label: str) -> dict:
    """Phase 18's schedule on one trainer: PAR_READS calls of
    `train_steps(PAR_SYNC, PAR_SYNC)`, launches counted per recorded level
    bucket and replica, the replicas compared after every read."""
    from rnb_neus2_torch.tools.profile_step import profile_window

    replicas = getattr(tr, "replicas", None)
    n_rep = len(replicas) if replicas else 1
    rec, undo = _record_step_bodies(type(tr))
    refreshes = []
    real_refresh = tr.refresh_occupancy
    tr.refresh_occupancy = lambda n: (refreshes.append(tr.step),
                                      real_refresh(n))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.reset_launches()
    reads, max_diff = [], 0.0
    t0 = time.perf_counter()
    try:
        for _ in range(PAR_READS):
            t = time.perf_counter()
            out = tr.train_steps(PAR_SYNC, PAR_SYNC)
            torch.cuda.synchronize()
            reads.append({"step": tr.step, "s": time.perf_counter() - t,
                          "loss_total": out["loss_total"],
                          "loss_color": out["loss_color"],
                          "levels": out.get("n_levels_run"),
                          "rays": out["rays_per_batch"],
                          "rolled_back": bool(out.get("rolled_back"))})
            with torch.no_grad():
                for rep in (replicas or [])[1:]:
                    max_diff = max(max_diff, max(
                        float((p - tr.params[k]).abs().max())
                        for k, p in rep.params.items()))
    finally:
        undo()
        del tr.refresh_occupancy
    total = time.perf_counter() - t0
    steps = tr.step
    launches = {n: k.launches for n, k in kernels.items()}
    want = {n: n_rep * c for n, c in _expected_launches(
        rec, tr.cfg.grid, tr.cfg.network.stoch_corner_bwd).items()}
    peak = torch.cuda.max_memory_allocated()
    prof = profile_window(lambda n: [tr.train_step() for _ in range(n)], 8)
    last = reads[-6:]
    row = {"trainer": label, "replicas": n_rep, "steps": steps,
           "seconds": total, "ms_per_step": 1e3 * total / len(rec),
           "ms_per_step_all_levels": 1e3 * reads[-1]["s"] / PAR_SYNC,
           "step_bodies": len(rec), "launches": launches,
           "launches_expected": want, "max_memory_allocated": peak,
           "replica_max_param_diff": max_diff,
           "refreshes_past_256": sum(s >= 256 for s in refreshes),
           "loss_last6_mean": statistics.mean(r["loss_total"] for r in last),
           "loss_last6_std": statistics.pstdev(r["loss_total"]
                                               for r in last),
           "reads": reads, "guard": guard_counters(tr),
           "device_ms_per_step": prof["device_busy_ms_per_step"],
           "wall_ms_per_step_profiled": prof["wall_ms_per_step"],
           "idle_share": prof["idle_share"],
           "phase_device_ms": {p: v["device_ms"]
                               for p, v in prof["phases"].items()}}
    log("parallel_train", **row)
    if launches != want or max_diff != 0.0 or row["guard"]["rollbacks"] \
            or not all(math.isfinite(r["loss_total"]) for r in reads) \
            or reads[-1]["levels"] != tr.cfg.grid.n_levels \
            or not row["refreshes_past_256"]:
        raise AssertionError(f"the {label} run failed: {row}")
    return row


def parallel_phase(torch, bench, kernels, dev, card) -> dict:
    """Phase 18: two replicas on the card at full width against a single
    `Trainer`, the training encode's kernels on the first replica's
    inputs, a forced rollback of both replicas."""
    from rnb_neus2_torch.config import TestbedConfig
    from rnb_neus2_torch.parallel import ParallelTrainer
    from rnb_neus2_torch.testing.synthetic import sphere_dataset
    from rnb_neus2_torch.train.trainer import Trainer

    ds = sphere_dataset(**SPHERE, device=dev)
    torch.cuda.empty_cache()
    single = _parallel_run(torch, kernels,
                           Trainer(ds, TestbedConfig(), device=dev),
                           "single")
    torch.cuda.empty_cache()
    tr = ParallelTrainer(ds, TestbedConfig(), devices=[dev, dev])
    par = _parallel_run(torch, kernels, tr, "parallel")
    gap = abs(par["loss_last6_mean"] - single["loss_last6_mean"])
    spread = 3 * (par["loss_last6_std"] + single["loss_last6_std"]) + 1e-5
    log("parallel_vs_single", card=card, loss_gap=gap, loss_bound=spread,
        ms_per_step=[single["ms_per_step"], par["ms_per_step"]],
        device_ms_per_step=[single["device_ms_per_step"],
                            par["device_ms_per_step"]],
        max_memory_allocated=[single["max_memory_allocated"],
                              par["max_memory_allocated"]])
    if not gap < spread:
        raise AssertionError("the two replicas' loss does not track the "
                             "single trainer's")
    # the training encode's kernels on the first replica's inputs of one
    # more step
    timed = time_encode_kernels(torch, bench, dev, card,
                                encode_inputs(torch, tr), "parallel")
    # a forced rollback: both replicas' parameters scaled, then a NaN read
    good = tr._good
    with torch.no_grad():
        for rep in tr.replicas:
            for p in rep.params.values():
                p.mul_(2.0)
    out = tr._consume_metrics({
        "loss_color": float("nan"), "loss_ek": 0.0, "loss_mask": 0.0,
        "n_valid_total": 1.0, "rays_per_batch": tr._bucket()})
    differ = [f"{i}.{k}" for i, rep in enumerate(tr.replicas)
              for k, p in rep.params.items()
              if not torch.equal(p, good["params"][k])]
    after = [tr.train_step()["loss_total"] for _ in range(8)]
    roll = {"rolled_back": bool(out.get("rolled_back")),
            "restored_step": good["step"], "replicas": tr.n_dev,
            "tensors_differ": differ, "loss_after": after}
    log("parallel_rollback", **roll)
    if differ or not roll["rolled_back"] \
            or not all(math.isfinite(v) for v in after):
        raise AssertionError(f"the replicas' rollback failed: {roll}")
    return {"launches": par["launches"], "steps": par["step_bodies"],
            "kernels": timed, "single": single, "parallel": par,
            "rollback": roll}


def _compare_prepared(png, a: Path, b: Path) -> dict:
    """Phase 19: B's prepared PNGs against A's."""
    import numpy as np

    out = {"frames": 0, "albedo_equal": True, "alpha_equal": True,
           "normal_max_diff": 0, "normal_samples_differing": 0}
    for name in sorted(p.name for p in (a / "normals").glob("*.png")):
        out["frames"] += 1
        na, nb = (png.read_png(d / "normals" / name).astype(np.int64)
                  for d in (a, b))
        aa, ab = (png.read_png(d / "albedos" / name) for d in (a, b))
        d = np.abs(na - nb)
        out["normal_max_diff"] = max(out["normal_max_diff"],
                                     int(d[..., :3].max()))
        out["normal_samples_differing"] += int((d[..., :3] > 0).sum())
        out["alpha_equal"] &= bool((d[..., 3] == 0).all()
                                   and np.array_equal(aa[..., 3], ab[..., 3]))
        out["albedo_equal"] &= bool(np.array_equal(aa, ab))
    with open(a / "transform.json") as f, open(b / "transform.json") as g:
        out["n2w_equal"] = json.load(f)["n2w"] == json.load(g)["n2w"]
    return out


def netpbm_scene(root: Path, png, world_center) -> dict:
    """Phase 19: the sphere written by the port's own writers with 16-bit
    PPM normals, 8-bit BMP albedos and PGM masks, prepared, and held
    against the PNG scene's prepared arrays (root/png/prepared): the
    normals and alphas equal, the albedos within one 8-bit step of the
    16-bit ones, the same n2w."""
    import numpy as np
    from rnb_neus2_torch.io.dataloaders import load_data
    from rnb_neus2_torch.io.prepare import prepare_testbed_data
    from rnb_neus2_torch.testing.synthetic import write_sfm_scene

    t0 = time.perf_counter()
    normals, albedos, masks, _ = write_sfm_scene(
        str(root / "netpbm"), "netpbm", world_center=world_center, **SPHERE)
    t1 = time.perf_counter()
    data = load_data(normals, albedo_sfm_path=albedos)
    for v in data["views"]:
        v["mask_path"] = str(Path(masks) / f"{v['pose_id']}.pgm")
    prepare_testbed_data(data, str(root / "netpbm" / "prepared"))
    out = {"write_s": t1 - t0, "load_and_prepare_s": time.perf_counter() - t1,
           "frames": 0, "normal_max_diff": 0, "alpha_equal": True,
           "albedo_max_diff_x257": 0}
    a, b = root / "png" / "prepared", root / "netpbm" / "prepared"
    for name in sorted(p.name for p in (a / "normals").glob("*.png")):
        out["frames"] += 1
        na, nb = (png.read_png(d / "normals" / name).astype(np.int64)
                  for d in (a, b))
        aa, ab = (png.read_png(d / "albedos" / name).astype(np.int64)
                  for d in (a, b))
        out["normal_max_diff"] = max(out["normal_max_diff"],
                                     int(np.abs(na - nb).max()))
        out["alpha_equal"] &= bool(np.array_equal(aa[..., 3] > 0,
                                                  ab[..., 3] > 0))
        out["albedo_max_diff_x257"] = max(
            out["albedo_max_diff_x257"],
            int(np.abs(aa[..., :3] - ab[..., :3] * 257).max()))
    with open(a / "transform.json") as f, open(b / "transform.json") as g:
        out["n2w_equal"] = json.load(f)["n2w"] == json.load(g)["n2w"]
    log("formats_netpbm_scene", **out)
    return out


def _unit_normals():
    """The codec view: a rendered sphere's normal map in [0, 1] at
    DiLiGenT-MV's 612x512, and its coverage (1 on the sphere)."""
    import numpy as np
    from rnb_neus2_torch.testing.synthetic import (render_sphere_views,
                                                   ring_cameras)

    h, w = CODEC_VIEW
    cams = ring_cameras(1, 1.5, w, h, 560.0)
    normals, _, alphas = render_sphere_views(cams, radius=0.25)
    unit = np.clip((normals[0] * np.array([1.0, -1.0, -1.0]) + 1) / 2, 0, 1)
    return unit, alphas[0]


def codec_view():
    """The codec view as the writer rows of phase 19 take it: 16-bit RGB,
    and 8-bit RGBA with alpha 0 off the sphere (a screenshot's shape)."""
    import numpy as np

    unit, alpha = _unit_normals()
    rgba = np.concatenate([unit, alpha[..., None]], -1)
    return ((unit * 65535).astype(np.uint16),
            (rgba * 255).astype(np.uint8))


# cv2's XYZ → RGB (sRGB primaries, D65), inverted to write LogLuv
XYZ2RGB = ((3.240479, -1.53715, -0.498535), (-0.969256, 1.875991, 0.041556),
           (0.055648, -0.204043, 1.057311))


def _tiff_file(tags: dict, strips: list) -> bytes:
    """A little-endian one-image TIFF: `tags` {tag: (type 3 or 4,
    values)}, the strips in order (their offsets and counts filled in)."""
    import struct
    tags = {**tags, 273: (4, [0] * len(strips)),
            279: (4, [len(s) for s in strips])}
    data_at = 8 + 2 + 12 * len(tags) + 4
    offsets, pos = [], data_at
    for s in strips:
        offsets.append(pos)
        pos += len(s)
    tags[273] = (4, offsets)
    entries, extra = b"", b""
    for tag, (typ, vals) in sorted(tags.items()):
        packed = struct.pack("<" + {3: "H", 4: "I"}[typ] * len(vals), *vals)
        if len(packed) <= 4:
            value = packed.ljust(4, b"\0")
        else:
            value = struct.pack("<I", pos + len(extra))
            extra += packed
        entries += struct.pack("<HHI", tag, typ, len(vals)) + value
    return (b"II*\0" + struct.pack("<IH", 8, len(tags)) + entries
            + b"\0" * 4 + b"".join(strips) + extra)


def sgilog_view(compression: int) -> tuple:
    """The codec view's colours as a 612x512 LogLuv TIFF, assembled here
    (the card's host has no TIFF writer of SGILog, and a libtiff file of
    it passes the TIFF fixtures' 64 KB): XYZ through the inverse of cv2's
    XYZ2RGB, coded as libtiff's LogLuv32fromXYZ codes them without
    dithering; compression 34676 (SGILog) stores each row's four byte
    planes as literal runs, 34677 (SGILog24) the 10-bit log luminance
    with a 14-bit colour index (here (u·64 + v) % 16289 of the 8-bit u, v
    codes: any index decodes at the same cost). → (file bytes, the RGB it
    was made from)."""
    import numpy as np

    h, w = CODEC_VIEW
    unit, _ = _unit_normals()
    xyz = unit.astype(np.float64) @ np.linalg.inv(np.array(XYZ2RGB)).T
    X, Y, Z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    s = X + 15 * Y + 3 * Z
    lit = (Y > 5.4136769e-20) & (s > 0)
    s = np.where(lit, s, 1.0)
    ue = np.clip(np.floor(410 * np.where(lit, 4 * X / s, 0.210526316)),
                 0, 255).astype(np.uint32)
    ve = np.clip(np.floor(410 * np.where(lit, 9 * Y / s, 0.473684211)),
                 0, 255).astype(np.uint32)
    logy = np.log2(np.where(lit, Y, 1.0))
    rows = 16
    strips = []
    if compression == 34676:
        le = np.where(lit, np.clip(np.floor(256 * (logy + 64)), 0, 0x7FFF),
                      0).astype(np.uint32)
        code = (le << 16) | (ue << 8) | ve
        for y0 in range(0, h, rows):
            out = bytearray()
            for row in code[y0:y0 + rows]:
                for shift in (24, 16, 8, 0):
                    plane = ((row >> shift) & 0xFF).astype(np.uint8).tobytes()
                    for i in range(0, w, 127):
                        part = plane[i:i + 127]
                        out += bytes([len(part)]) + part
            strips.append(bytes(out))
    else:
        l10 = np.where(lit, np.clip(np.floor(64 * (logy + 12)), 0, 1023),
                       0).astype(np.uint32)
        code = (l10 << 14) | ((ue * 64 + ve) % 16289)
        packed = np.stack([(code >> 16) & 0xFF, (code >> 8) & 0xFF,
                           code & 0xFF], -1).astype(np.uint8)
        strips = [packed[y0:y0 + rows].tobytes() for y0 in range(0, h, rows)]
    tags = {256: (3, [w]), 257: (3, [h]), 258: (3, [16] * 3),
            259: (3, [compression]), 262: (3, [32845]), 277: (3, [3]),
            278: (3, [rows]), 284: (3, [1]), 339: (3, [2] * 3)}
    return _tiff_file(tags, strips), unit


def codec_timings(work: Path) -> dict:
    """Phase 19: ms per view of every decoder and encoder on the host, at
    DiLiGenT-MV's 612x512 on a rendered sphere's normal map (PNG, TIFF,
    EXR, JPEG, BMP, PPM, PFM, Radiance, Sun raster; WebP, GIF and JPEG
    2000 and AVIF as `save_image` writes a screenshot, 8-bit RGBA (the
    AVIF read back as its encoder's reconstruction), and JPEG 2000 also
    as 16-bit RGB; libaom's AVIFs and lossy JPEG 2000, which the port
    does not write, decoded from phase 20's fixtures; SGILog and SGILog24 as
    `sgilog_view` assembles them; OpenEXR's files of the normal map in
    PIZ, PXR24, B44, B44A, DWAA, DWAB and 64x64 ZIP tiles, each equal to
    the library's decode; libwebp's lossless analysis alone), and a
    4032x3024 JPEG."""
    import numpy as np
    from rnb_neus2_torch.io import (avif, bmp, exr, gif, hdr, jpeg, jpeg2000,
                                    native, png, pxm, sunras, tiff, webp)

    h, w = CODEC_VIEW
    unit, _ = _unit_normals()
    u16 = (unit * 65535).astype(np.uint16)
    u8 = (unit * 255).astype(np.uint8)
    f32 = (unit * 2 - 1).astype(np.float32)
    rgb16, rgba8 = codec_view()
    # what libwebp's file of it decodes to (alpha 0 as its analysis leaves
    # it), timed alone
    ms = []
    for _ in range(CODEC_REPEATS):
        t0 = time.perf_counter()
        clear, info, _ = native.vp8l_analyze(rgba8)
        ms.append((time.perf_counter() - t0) * 1e3)
    cases = {
        "png_16bit": (".png", lambda p: png.write_png(p, u16),
                      png.read_png, u16),
        "tiff_lzw_16bit": (".tif", lambda p: tiff.write_tiff(p, u16),
                           tiff.read_tiff, u16),
        "exr_zip_half": (".exr", lambda p: exr.write_exr(
            p, f32.astype(np.float16)), exr.read_exr,
            f32.astype(np.float16).astype(np.float32)),
        "exr_zip_float": (".exr", lambda p: exr.write_exr(p, f32),
                          exr.read_exr, f32),
        "jpeg_420": (".jpg", lambda p: jpeg.write_jpeg(p, u8),
                     jpeg.read_jpeg, None),
        "bmp_24bit": (".bmp", lambda p: bmp.write_bmp(p, u8), bmp.read_bmp,
                      u8),
        "ppm_16bit": (".ppm", lambda p: pxm.write_pnm(p, u16, "ppm"),
                      pxm.read_pnm, u16),
        "pfm_float": (".pfm", lambda p: pxm.write_pfm(p, f32), pxm.read_pfm,
                      f32),
        "hdr_rle": (".hdr", lambda p: hdr.write_hdr(p, unit.astype(
            np.float32)), hdr.read_hdr, None),
        "sun_raster_24bit": (".ras", lambda p: sunras.write_sunras(p, u8),
                             sunras.read_sunras, u8),
        "webp_rgba_8bit": (".webp", lambda p: webp.write_webp(p, rgba8),
                           webp.read_webp, clear),
        "gif_rgba_8bit": (".gif", lambda p: gif.write_gif(p, rgba8),
                          gif.read_gif, None),
        "jp2_rgba_8bit": (".jp2", lambda p: jpeg2000.write_jp2(p, rgba8),
                          jpeg2000.read_jpeg2000, rgba8),
        "jp2_rgb_16bit": (".jp2", lambda p: jpeg2000.write_jp2(p, rgb16),
                          jpeg2000.read_jpeg2000, rgb16),
        "avif_rgba_8bit": (".avif", lambda p: avif.write_avif(p, rgba8),
                           avif.read_avif, avif.reconstructed(
                               *avif.encode_avif_recon(rgba8)[1:])),
    }
    out = {"view": [w, h], "repeats": CODEC_REPEATS,
           "webp_analysis": {"ms": statistics.median(ms),
                             "transform_set": int(info[0]),
                             "tile_bits": int(info[2])}}
    # formats the port reads and does not write: phase 20's 612x512
    # fixtures of the same sphere (see make_fixtures.py)
    from rnb_neus2_torch.io import image_io
    for name, file, mode in (
            ("jp2_lossless_16bit_colour", "jp2_lossless16_612x512.jp2",
             "unchanged"),
            ("jp2_lossy_8bit_colour", "jp2_lossy8_612x512.jp2", "color"),
            ("avif_q95_8bit_colour", "avif_q95_612x512.avif", "color"),
            ("avif_lossless_444_colour", "avif_lossless444_612x512.avif",
             "color"),
            ("avif_12bit_unchanged", "avif_12bit_612x512.avif",
             "unchanged"),
            ("avif_film_grain_colour", "avif_film_grain_612x512.avif",
             "color"),
            ("avif_superres_colour", "avif_superres_612x512.avif", "color"),
            ("avis_first_frame_colour", "avis_612x512.avif", "color"),
            ("avif_ispe_scaled_colour", "avif_ispe_306x256_to_612x512.avif",
             "color"),
            ("avif_layers_spatial_colour", "avif_layers_spatial_612x512.avif",
             "color"),
            ("avif_inter_tools_colour", "avif_inter_tools_612x512.avif",
             "color"),
            ("tiff_group4_mask", "g4_mask_612x512.tif", "unchanged")):
        dec = []
        for _ in range(CODEC_REPEATS):
            t0 = time.perf_counter()
            got = image_io.read_image(FIXTURES / file, mode)
            dec.append((time.perf_counter() - t0) * 1e3)
        if got.shape[:2] != (h, w):
            raise AssertionError(f"{name}: {got.shape}")
        out[name] = {"decode_ms": statistics.median(dec), "mode": mode,
                     "bytes": (FIXTURES / file).stat().st_size}
    # the sphere's normal map as OpenEXR 3.1.5 wrote it in each
    # compression (HALF RGB), equal to the library's decode
    with np.load(FIXTURES / "expected.npz") as z:
        for name, file in (
                ("exr_piz_half", "exr_piz_612x512.exr"),
                ("exr_pxr24_half", "exr_pxr24_612x512.exr"),
                ("exr_b44_half", "exr_b44_612x512.exr"),
                ("exr_b44a_half", "exr_b44a_612x512.exr"),
                ("exr_dwaa_half", "exr_dwaa_612x512.exr"),
                ("exr_dwab_half", "exr_dwab_612x512.exr"),
                ("exr_tiled_zip_half", "exr_tiled_zip_612x512.exr")):
            want = z[f"{file}:unchanged"]
            dec = []
            for _ in range(CODEC_REPEATS):
                t0 = time.perf_counter()
                got = exr.read_exr(FIXTURES / file)
                dec.append((time.perf_counter() - t0) * 1e3)
            if got.shape != (h, w, 3) or not np.array_equal(got, want):
                raise AssertionError(f"{name}: differs from OpenEXR's decode")
            out[name] = {"decode_ms": statistics.median(dec),
                         "mode": "unchanged",
                         "bytes": (FIXTURES / file).stat().st_size}
    for name, comp in (("sgilog_logluv32", 34676),
                       ("sgilog24_logluv24", 34677)):
        blob, rgb = sgilog_view(comp)
        path = work / f"codec_{name}.tif"
        path.write_bytes(blob)
        dec = []
        for _ in range(CODEC_REPEATS):
            t0 = time.perf_counter()
            got = image_io.read_image(path, "unchanged")
            dec.append((time.perf_counter() - t0) * 1e3)
        if got.shape != (h, w, 3) or got.dtype != np.float32 \
                or not np.isfinite(got).all():
            raise AssertionError(f"{name}: {got.shape} {got.dtype}")
        # LogLuv32 codes luminance to 0.27% and u', v' to 1/410
        err = float(np.abs(got - rgb).max())
        if comp == 34676 and err > 0.02:
            raise AssertionError(f"{name}: off the view by {err}")
        out[name] = {"decode_ms": statistics.median(dec), "mode": "unchanged",
                     "bytes": len(blob), "max_abs_err": err}
    for name, (ext, write, read, want) in cases.items():
        path = work / f"codec_{name}{ext}"
        enc, dec = [], []
        for _ in range(CODEC_REPEATS):
            t0 = time.perf_counter()
            write(path)
            t1 = time.perf_counter()
            got = read(path)
            t2 = time.perf_counter()
            enc.append((t1 - t0) * 1e3)
            dec.append((t2 - t1) * 1e3)
        again = read(path)
        if want is not None and not np.array_equal(got, want):
            raise AssertionError(f"{name}: the file does not read back")
        if not np.array_equal(got, again) or got.shape[:2] != (h, w):
            raise AssertionError(f"{name}: decode is not repeatable")
        out[name] = {"decode_ms": statistics.median(dec),
                     "encode_ms": statistics.median(enc),
                     "bytes": path.stat().st_size}
    rng = np.random.default_rng(19)
    y, x = np.mgrid[:PHOTO[0], :PHOTO[1]].astype(np.float32)
    photo = np.stack([128 + 90 * np.sin(x / (97 + 13 * c))
                      * np.cos(y / (61 + 7 * c)) for c in range(3)], -1)
    photo = np.clip(photo + rng.normal(0, 6, photo.shape), 0, 255) \
        .astype(np.uint8)
    del x, y
    path = work / "photo.jpg"
    t0 = time.perf_counter()
    jpeg.write_jpeg(path, photo)
    t1 = time.perf_counter()
    first = jpeg.read_jpeg(path)
    t2 = time.perf_counter()
    second = jpeg.read_jpeg(path)
    t3 = time.perf_counter()
    if first.shape != photo.shape or not np.array_equal(first, second):
        raise AssertionError("4032x3024 JPEG: decode is not repeatable")
    err = np.abs(first.astype(np.int16) - photo).mean()
    out["jpeg_photo"] = {"size": [PHOTO[1], PHOTO[0]],
                         "encode_ms": (t1 - t0) * 1e3,
                         "decode_ms": [(t2 - t1) * 1e3, (t3 - t2) * 1e3],
                         "bytes": path.stat().st_size,
                         "mean_abs_err": float(err)}
    return out


def scene_load_seconds() -> list:
    """Seconds of each of SCENE_LOAD_REPEATS `io/dataset.py:
    load_transform_json` calls on a prepared sphere scene of 16-bit RGBA
    PNGs (SCENE_LOAD): the PNG path's start-up cost. `rnb_neus2_torch` is
    the first one on sys.path, so that this file, loaded by its path from
    another checkout's root, times that checkout on the same scene."""
    from rnb_neus2_torch.io.dataset import load_transform_json
    from rnb_neus2_torch.testing.synthetic import write_prepared_scene

    with tempfile.TemporaryDirectory() as d:
        write_prepared_scene(d, **SCENE_LOAD)
        load_transform_json(d)                 # builds the unfilter library
        seconds = []
        for _ in range(SCENE_LOAD_REPEATS):
            t0 = time.perf_counter()
            load_transform_json(d)
            seconds.append(time.perf_counter() - t0)
    return seconds


def _digest(a) -> str:
    import hashlib
    import numpy as np
    a = np.ascontiguousarray(a)
    return hashlib.sha256(f"{a.dtype}{a.shape}".encode()
                          + a.tobytes()).hexdigest()


def jp2_scene_phase(torch, kernels, root: Path, png) -> dict:
    """Phase 19: the committed sphere of lossless 16-bit JPEG 2000
    normals, lossy 8-bit JPEG 2000 albedos and Group 4 TIFF masks
    (tests/torch_fixtures/jp2_scene), prepared on the host: normals and
    their alphas (the masks) equal to the PNG scene's prepared ones
    (root/png/prepared), the albedos, normals and n2w equal to the JAX
    package's (expected.json's digests);
    then `run_full_pipeline` on the card (JP2_STEPS, mesh at JP2_MESH_RES)
    with its launches per level bucket and the mesh's median radius
    within a voxel of the sphere's."""
    import numpy as np
    from rnb_neus2_torch.cli import pipeline
    from rnb_neus2_torch.io.dataloaders import load_data
    from rnb_neus2_torch.io.prepare import prepare_testbed_data
    from rnb_neus2_torch.mesh.writer import load_obj

    expected = json.loads((JP2_SCENE / "expected.json").read_text())
    kw = dict(albedo_sfm_path=str(JP2_SCENE / "albedos.sfm.json"),
              mask_sfm_path=str(JP2_SCENE / "masks.sfm.json"))
    normals = str(JP2_SCENE / "normals.sfm.json")
    t0 = time.perf_counter()
    data = load_data(normals, **kw)
    prepare_testbed_data(data, str(root / "jp2" / "prepared"))
    prep_s = time.perf_counter() - t0
    a, b = root / "png" / "prepared", root / "jp2" / "prepared"
    cmp = {"frames": 0, "normals_equal": True, "alphas_equal": True,
           "albedo_digests_equal": True, "normal_digests_equal": True}
    for name in sorted(p.name for p in (a / "normals").glob("*.png")):
        cmp["frames"] += 1
        na, nb = (png.read_png(d / "normals" / name) for d in (a, b))
        ab = png.read_png(b / "albedos" / name)
        # the normal map's alpha is the mask's; the albedo's alpha follows
        # its lossy samples, held by the digest
        cmp["normals_equal"] &= bool(np.array_equal(na[..., :3],
                                                    nb[..., :3]))
        cmp["alphas_equal"] &= bool(np.array_equal(na[..., 3], nb[..., 3]))
        want = expected["frames"][name]
        cmp["albedo_digests_equal"] &= _digest(ab) == want["albedo"]
        cmp["normal_digests_equal"] &= _digest(nb) == want["normal"]
    with open(b / "transform.json") as f:
        cmp["n2w_equal"] = json.load(f)["n2w"] == expected["n2w"]
    cmp["mask_files"] = sorted({Path(v["mask_path"]).suffix
                                for v in data["views"]})
    log("formats_jp2_prepare", prepare_s=prep_s, **cmp)
    if not (cmp["frames"] == SPHERE["n_views"] and cmp["normals_equal"]
            and cmp["alphas_equal"] and cmp["albedo_digests_equal"]
            and cmp["normal_digests_equal"] and cmp["n2w_equal"]
            and cmp["mask_files"] == [".tif"]):
        raise AssertionError(f"prepared JPEG 2000 / Group 4 scene: {cmp}")

    buckets, undo = _record_step_bodies()
    forwards, undo_fwd = _record_forwards()
    for k in kernels.values():
        k.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        mesh_path = pipeline.run_full_pipeline(
            normals, str(root / "jp2_out"), max_steps=JP2_STEPS,
            mesh_resolution=JP2_MESH_RES, device="cuda", **kw)
        torch.cuda.synchronize()
    finally:
        undo()
        undo_fwd()
    total = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    want = _expected_launches(buckets, forwards=len(forwards))
    with open(root / "jp2_out" / "prepared_data" / "transform.json") as f:
        voxel = 2.0 / JP2_MESH_RES * json.load(f)["n2w"][0][0]
    V, F = load_obj(mesh_path)
    center = np.asarray(expected["world_center"])
    radius = float(np.median(np.linalg.norm(V - center, axis=1)))
    row = {"steps": JP2_STEPS, "step_bodies": len(buckets),
           "launches": launches, "launches_expected": want,
           "pipeline_s": total, "vertices": len(V), "faces": len(F),
           "median_radius": radius,
           "world_radius": expected["world_radius"], "voxel": voxel,
           **{k: cmp[k] for k in ("normals_equal", "alphas_equal",
                                  "albedo_digests_equal", "n2w_equal")},
           "prepare_s": prep_s}
    log("formats_jp2", **row)
    if launches != want:
        raise AssertionError(f"JPEG 2000 scene: kernel launches {launches} "
                             f"in {len(buckets)} steps; want {want}")
    if not (len(F) and abs(radius - expected["world_radius"]) <= voxel):
        raise AssertionError(f"JPEG 2000 scene: median radius {radius}, "
                             f"the sphere's {expected['world_radius']} "
                             f"(voxel {voxel})")
    return row


def avif_scene_phase(torch, kernels, root: Path, png) -> dict:
    """Phase 19: the committed AVIF sphere (tests/torch_fixtures/avif_scene:
    lossless 8-bit 4:4:4 normals, albedos at cv2's default quality,
    lossless grey masks) through `committed_scene_phase`."""
    return committed_scene_phase(torch, kernels, root, png, AVIF_SCENE,
                                 "avif", [".avif"])


def avis_scene_phase(torch, kernels, root: Path, png) -> dict:
    """Phase 19: the committed sequence / layered AVIF sphere
    (tests/torch_fixtures/avis_scene: normals as 3-frame AVIF sequences
    whose first frame is the view, albedos as 2-layer spatial AVIFs
    decoded through the AV1 inter path, PNG masks) through
    `committed_scene_phase`."""
    return committed_scene_phase(torch, kernels, root, png, AVIS_SCENE,
                                 "avis", [".avif", ".png"])


def avif_inter_scene_phase(torch, kernels, root: Path, png) -> dict:
    """Phase 19: the committed AVIF sphere of plain multi-frame AV1
    streams (tests/torch_fixtures/avif_inter_scene: normals and albedos
    each a libaom stream with look-ahead whose last shown frame is the
    view, together using compound prediction, global motion and
    shown-existing frames; PNG masks) through `committed_scene_phase`."""
    return committed_scene_phase(torch, kernels, root, png, AVIF_INTER_SCENE,
                                 "avif_inter", [".avif", ".png"])


def exr_scene_phase(torch, kernels, root: Path, png) -> dict:
    """Phase 19: the committed EXR sphere (tests/torch_fixtures/exr_scene,
    written by OpenEXR 3.1.5: normals as HALF PIZ, DWAA and 16x16-tiled
    mip-mapped ZIP files in turn, view 0's as part 0 of a 2-part file,
    albedos as FLOAT PXR24 and HALF B44A, PNG masks) through
    `committed_scene_phase`."""
    return committed_scene_phase(torch, kernels, root, png, EXR_SCENE,
                                 "exr_variants", [".exr", ".png"])


def sgilog_scene_phase(torch, kernels, root: Path, png) -> dict:
    """Phase 19: the committed SGILog / grid-AVIF sphere
    (tests/torch_fixtures/sgilog_scene: SGILog and SGILog24 albedos, grid
    AVIF normals of 2x2 lossless tiles, PNG masks) through
    `committed_scene_phase`."""
    return committed_scene_phase(torch, kernels, root, png, SGILOG_SCENE,
                                 "sgilog", [".avif", ".png", ".tif"])


def committed_scene_phase(torch, kernels, root: Path, png, scene: Path,
                          tag: str, suffixes: list) -> dict:
    """A committed sphere scene prepared on the host: the normals,
    albedos and n2w equal to the JAX package's (expected.json's digests),
    each view's decode timed (whether the alphas equal the PNG scene's is
    printed: these normals carry no alpha of their own); then
    `run_full_pipeline` on the card (AVIF_STEPS, mesh at AVIF_MESH_RES)
    with its launches per level bucket and the mesh's median radius
    within a voxel of the sphere's. Logs `formats_<tag>_prepare` and
    `formats_<tag>`."""
    import numpy as np
    from rnb_neus2_torch.cli import pipeline
    from rnb_neus2_torch.io import image_io
    from rnb_neus2_torch.io.dataloaders import load_data
    from rnb_neus2_torch.io.prepare import prepare_testbed_data
    from rnb_neus2_torch.mesh.writer import load_obj

    expected = json.loads((scene / "expected.json").read_text())
    kw = dict(albedo_sfm_path=str(scene / "albedos.sfm.json"),
              mask_sfm_path=str(scene / "masks.sfm.json"))
    normals = str(scene / "normals.sfm.json")
    decode_ms = {}
    for kind in ("normals", "albedos", "masks"):
        times = []
        for path in sorted((scene / kind).iterdir()):
            t0 = time.perf_counter()
            image_io.read_image(path)
            times.append(1e3 * (time.perf_counter() - t0))
        decode_ms[kind] = statistics.median(times)
    t0 = time.perf_counter()
    data = load_data(normals, **kw)
    prepare_testbed_data(data, str(root / tag / "prepared"))
    prep_s = time.perf_counter() - t0
    a, b = root / "png" / "prepared", root / tag / "prepared"
    cmp = {"frames": 0, "alphas_equal": True, "albedo_digests_equal": True,
           "normal_digests_equal": True}
    for name in sorted(p.name for p in (a / "normals").glob("*.png")):
        cmp["frames"] += 1
        na, nb = (png.read_png(d / "normals" / name) for d in (a, b))
        cmp["alphas_equal"] &= bool(np.array_equal(na[..., 3], nb[..., 3]))
        want = expected["frames"][name]
        cmp["albedo_digests_equal"] &= \
            _digest(png.read_png(b / "albedos" / name)) == want["albedo"]
        cmp["normal_digests_equal"] &= _digest(nb) == want["normal"]
    with open(b / "transform.json") as f:
        cmp["n2w_equal"] = json.load(f)["n2w"] == expected["n2w"]
    cmp["files"] = sorted({Path(v[k]).suffix for v in data["views"]
                           for k in ("normal_path", "albedo_path",
                                     "mask_path")})
    log(f"formats_{tag}_prepare", prepare_s=prep_s, decode_ms=decode_ms,
        **cmp)
    if not (cmp["frames"] == SPHERE["n_views"]
            and cmp["albedo_digests_equal"] and cmp["normal_digests_equal"]
            and cmp["n2w_equal"] and cmp["files"] == suffixes):
        raise AssertionError(f"prepared {tag} scene: {cmp}")

    buckets, undo = _record_step_bodies()
    forwards, undo_fwd = _record_forwards()
    for k in kernels.values():
        k.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        mesh_path = pipeline.run_full_pipeline(
            normals, str(root / f"{tag}_out"), max_steps=AVIF_STEPS,
            mesh_resolution=AVIF_MESH_RES, device="cuda", **kw)
        torch.cuda.synchronize()
    finally:
        undo()
        undo_fwd()
    total = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    want = _expected_launches(buckets, forwards=len(forwards))
    with open(root / f"{tag}_out" / "prepared_data" / "transform.json") as f:
        voxel = 2.0 / AVIF_MESH_RES * json.load(f)["n2w"][0][0]
    V, F = load_obj(mesh_path)
    center = np.asarray(expected["world_center"])
    radius = float(np.median(np.linalg.norm(V - center, axis=1)))
    row = {"steps": AVIF_STEPS, "step_bodies": len(buckets),
           "launches": launches, "launches_expected": want,
           "pipeline_s": total, "vertices": len(V), "faces": len(F),
           "median_radius": radius,
           "world_radius": expected["world_radius"], "voxel": voxel,
           "decode_ms": decode_ms, "prepare_s": prep_s,
           **{k: cmp[k] for k in ("alphas_equal", "albedo_digests_equal",
                                  "normal_digests_equal", "n2w_equal")}}
    log(f"formats_{tag}", **row)
    if launches != want:
        raise AssertionError(f"{tag} scene: kernel launches {launches} "
                             f"in {len(buckets)} steps; want {want}")
    if not (len(F) and abs(radius - expected["world_radius"]) <= voxel):
        raise AssertionError(f"{tag} scene: median radius {radius}, the "
                             f"sphere's {expected['world_radius']} "
                             f"(voxel {voxel})")
    return row


def formats_phase(torch, kernels, card) -> dict:
    """Phase 19: the Meshroom-style scene in PNG, in EXR/TIFF/JPEG and in
    PPM/BMP/PGM, prepared and compared, the committed JPEG 2000 / Group 4
    scene prepared and through the pipeline on the card, the EXR/TIFF/JPEG
    one through the pipeline, then the codecs' timings."""
    import numpy as np
    from rnb_neus2_torch.cli import pipeline
    from rnb_neus2_torch.io import png
    from rnb_neus2_torch.io.dataloaders import load_data
    from rnb_neus2_torch.io.prepare import prepare_testbed_data
    from rnb_neus2_torch.mesh.writer import load_obj
    from rnb_neus2_torch.testing.synthetic import write_sfm_scene

    world_center = np.array([0.2, -0.1, 0.3])
    with tempfile.TemporaryDirectory() as d:
        root = Path(d)
        scenes, seconds = {}, {}
        for fmt in ("png", "exr"):
            t0 = time.perf_counter()
            scenes[fmt] = write_sfm_scene(str(root / fmt), fmt,
                                          world_center=world_center,
                                          **SPHERE)
            t1 = time.perf_counter()
            normals, albedos, masks, r_world = scenes[fmt]
            data = load_data(normals, albedo_sfm_path=albedos,
                             mask_folder_path=masks)
            prepare_testbed_data(data, str(root / fmt / "prepared"))
            seconds[fmt] = {"write_s": t1 - t0,
                            "load_and_prepare_s": time.perf_counter() - t1}
        mask_paths = [v["mask_path"] for v in data["views"]]
        cmp = _compare_prepared(png, root / "png" / "prepared",
                                root / "exr" / "prepared")
        netpbm = netpbm_scene(root, png, world_center)
        jp2 = jp2_scene_phase(torch, kernels, root, png)
        avif = avif_scene_phase(torch, kernels, root, png)
        sgilog = sgilog_scene_phase(torch, kernels, root, png)
        avis = avis_scene_phase(torch, kernels, root, png)
        inter = avif_inter_scene_phase(torch, kernels, root, png)
        exr_variants = exr_scene_phase(torch, kernels, root, png)
        log("formats_prepare", seconds=seconds, mask_files=sorted(
            {Path(p).suffix for p in mask_paths}), **cmp)
        if not (cmp["frames"] == SPHERE["n_views"] and cmp["albedo_equal"]
                and cmp["alpha_equal"] and cmp["normal_max_diff"] <= 1
                and cmp["n2w_equal"]):
            raise AssertionError(f"prepared EXR/TIFF/JPEG scene differs "
                                 f"from the PNG one: {cmp}")
        if not all(p.endswith(".jpg") for p in mask_paths):
            raise AssertionError(f"masks found: {mask_paths}")
        if not (netpbm["frames"] == SPHERE["n_views"]
                and netpbm["normal_max_diff"] == 0 and netpbm["alpha_equal"]
                and netpbm["albedo_max_diff_x257"] < 257
                and netpbm["n2w_equal"]):
            raise AssertionError(f"prepared PPM/BMP/PGM scene differs from "
                                 f"the PNG one: {netpbm}")

        normals, albedos, masks, r_world = scenes["exr"]
        buckets, undo = _record_step_bodies()
        forwards, undo_fwd = _record_forwards()
        for k in kernels.values():
            k.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            mesh_path = pipeline.run_full_pipeline(
                normals, str(root / "out"), max_steps=FORMATS_STEPS,
                mesh_resolution=512, albedo_sfm_path=albedos,
                mask_folder_path=masks, device="cuda")
            torch.cuda.synchronize()
        finally:
            undo()
            undo_fwd()
        total = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.items()}
        want = _expected_launches(buckets, forwards=len(forwards))
        with open(root / "out" / "prepared_data" / "transform.json") as f:
            voxel = 2.0 / 512 * json.load(f)["n2w"][0][0]
        V, F = load_obj(mesh_path)
        radius = float(np.median(np.linalg.norm(V - world_center, axis=1)))
        codecs = codec_timings(root)
        codecs["png_scene_load_s"] = scene_load_seconds()
    row = {"steps": FORMATS_STEPS, "step_bodies": len(buckets),
           "steps_at_14_levels": sum(b == 14 for b in buckets),
           "launches": launches, "launches_expected": want,
           "pipeline_s": total, "vertices": len(V), "faces": len(F),
           "median_radius": radius, "world_radius": r_world, "voxel": voxel,
           "codecs": codecs, "jp2_scene": jp2, "avif_scene": avif,
           "sgilog_scene": sgilog, "avis_scene": avis,
           "avif_inter_scene": inter, "exr_scene": exr_variants,
           "card": card}
    log("formats", **row)
    if launches != want:
        raise AssertionError(f"kernel launches {launches} in "
                             f"{len(buckets)} steps; want {want}")
    if not (len(F) and abs(radius - r_world) <= voxel):
        raise AssertionError(f"mesh.obj median radius {radius}, the "
                             f"sphere's {r_world} (voxel {voxel})")
    return row


def decode_fixtures() -> dict:
    """Phase 20, part 1: every fixture of tests/torch_fixtures/formats
    (JPEG, TIFF with CCITT, BMP, PNM/PAM/PFM, Radiance, Sun raster, GIF,
    WebP, JPEG 2000, AVIF, OpenEXR)
    decoded in each mode on the host, equal to cv2's decode in
    expected.npz (EXR: IMREAD_UNCHANGED only, equal to OpenEXR's
    `InputFile` decode; its colour and grey reads refused by name); where
    cv2 returned None (an empty array there), the port must raise
    UnreadableImage, and UnsupportedImage naming the feature for
    REFUSED_FIXTURES. The 612x512 files are timed in "color"
    mode (the best of FIXTURE_REPEATS)."""
    import numpy as np
    from rnb_neus2_torch.io import image_io
    from rnb_neus2_torch.io.errors import UnreadableImage, UnsupportedImage

    with np.load(FIXTURES / "expected.npz") as z:
        expected = {k: z[k] for k in z.files}
    files = sorted(p for p in FIXTURES.iterdir()
                   if p.is_file() and p.suffix not in (".py", ".npz"))
    ms, bad, refused, named, exr_8bit = {}, [], 0, 0, 0
    for path in files:
        is_exr = path.suffix == ".exr"
        for mode in ("unchanged", "color", "grey"):
            if is_exr and mode != "unchanged":
                # EXR read as 8-bit colour or grey stays refused by name
                try:
                    image_io.read_image(path, mode)
                except UnsupportedImage as e:
                    if "8-bit colour or grey" not in str(e):
                        raise
                    exr_8bit += 1
                    continue
                bad.append(f"{path.name}:{mode} read, the port refuses it")
                continue
            want = expected[f"{path.name}:{mode}"]
            t0 = time.perf_counter()
            try:
                got = image_io.read_image(path, mode)
            except UnreadableImage:
                got = None
            except UnsupportedImage as e:
                if REFUSED_FIXTURES.get(path.name, "?") not in str(e):
                    raise
                named += 1
                continue
            dt = 1e3 * (time.perf_counter() - t0)
            ms[f"{path.name}:{mode}"] = dt
            if want.size == 0:
                refused += 1
                if got is not None:
                    bad.append(f"{path.name}:{mode} read, cv2 cannot")
            elif got is None or got.dtype != want.dtype \
                    or not np.array_equal(got, want):
                bad.append(f"{path.name}:{mode}")
    big = {}
    for name in ("prog_612x512.jpg", "prog_612x512_cut3.jpg",
                 "webp_lossy_612x512.webp", "webp_lossless_612x512.webp",
                 "hdr_612x512.hdr", "bmp_rle8_612x512.bmp",
                 "jp2_lossless16_612x512.jp2", "jp2_lossy8_612x512.jp2",
                 "g4_mask_612x512.tif", "avif_q95_612x512.avif",
                 "avif_lossless444_612x512.avif", "avif_12bit_612x512.avif",
                 "avis_612x512.avif", "avif_ispe_306x256_to_612x512.avif",
                 "avif_layers_spatial_612x512.avif",
                 "avif_inter_tools_612x512.avif"):
        times = []
        for _ in range(FIXTURE_REPEATS):
            t0 = time.perf_counter()
            image_io.read_image(FIXTURES / name, "color")
            times.append(1e3 * (time.perf_counter() - t0))
        big[name] = min(times)
    exr_ms = {k: v for k, v in ms.items() if k.split(":")[0].endswith(".exr")}
    row = {"files": len(files), "decodes": len(ms), "refused": refused,
           "refused_by_name": named, "exr_files": len(exr_ms),
           "exr_decode_s": sum(exr_ms.values()) / 1e3,
           "exr_8bit_refused": exr_8bit,
           "mismatched": bad, "ms_per_decode": ms,
           "ms_612x512_progressive_color": big["prog_612x512.jpg"],
           "ms_612x512_progressive_cut3_color":
               big["prog_612x512_cut3.jpg"],
           "ms_612x512_color": big,
           "decode_s": sum(ms.values()) / 1e3}
    log("fixtures", **row)
    n_exr = sum(p.suffix == ".exr" for p in files)
    if bad or len(files) < N_FIXTURES or exr_8bit != 2 * n_exr \
            or named != sum(1 if n.endswith(".exr") else 3
                            for n in REFUSED_FIXTURES):
        raise AssertionError(f"fixtures that differ from cv2's decode: "
                             f"{bad}")
    return row


def final_slice_phase(torch, kernels, card, work: Path) -> dict:
    """Phase 20: the fixtures, `python -m
    rnb_neus2_torch.tools.mesh_from_snapshot` on phase 11's scene and
    snapshot, `Trainer.train(32)` with its launches counted, and every
    section of `tools/bench_primitives` on the card."""
    import numpy as np
    from rnb_neus2_torch.config import TestbedConfig
    from rnb_neus2_torch.io.dataset import load_transform_json
    from rnb_neus2_torch.mesh.writer import load_obj
    from rnb_neus2_torch.tools import bench_primitives
    from rnb_neus2_torch.train.trainer import Trainer
    from rnb_neus2_torch.utils.meters import Logger

    t_phase = time.perf_counter()
    row = {"fixtures": decode_fixtures()}
    scene = work / "scene"
    out = scene / "output"
    V11, F11 = load_obj(out / f"mesh_{CLI_STEPS}.obj")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "rnb_neus2_torch.tools.mesh_from_snapshot",
         "--scene", str(scene), "--snapshot",
         str(out / f"snapshot_{CLI_STEPS}.msgpack"), "--resolution", "256",
         "--gt-resolution", "128"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    row["mesh_from_snapshot_s"] = time.perf_counter() - t0
    print(proc.stdout[-3000:], proc.stderr[-3000:], flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"mesh_from_snapshot exited "
                             f"{proc.returncode}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    V, F = load_obj(out / f"mesh_{CLI_STEPS}.obj")
    row["mesh_from_snapshot"] = result
    row["mesh_vs_phase11"] = {
        "vertices": [len(V), len(V11)], "faces_equal":
            bool(F.shape == F11.shape and np.array_equal(F, F11)),
        "max_vertex_diff": float(np.abs(V - V11).max())
        if V.shape == V11.shape else None}
    log("mesh_from_snapshot", **row["mesh_vs_phase11"], result=result)
    if not (row["mesh_vs_phase11"]["faces_equal"]
            and row["mesh_vs_phase11"]["max_vertex_diff"] <= 1e-5
            and result["mesh_vertices"] == len(V11)):
        raise AssertionError(f"mesh_from_snapshot's mesh differs from "
                             f"phase 11's: {row['mesh_vs_phase11']}")

    ds = load_transform_json(str(scene), "cuda")
    tr = Trainer(ds, TestbedConfig(), device="cuda")
    buckets, undo = _record_step_bodies()
    lines = []

    class Lines(Logger):
        def info(self, msg):
            lines.append(msg)
    for k in kernels.values():
        k.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        tr.train(TRAIN_API_STEPS, log_every=TRAIN_API_STEPS // 2,
                 logger=Lines())
        torch.cuda.synchronize()
    finally:
        undo()
    launches = {name: k.launches for name, k in kernels.items()}
    want = _expected_launches(buckets)
    row["train_api"] = {"steps": tr.step, "step_bodies": len(buckets),
                        "seconds": time.perf_counter() - t0,
                        "step_ms_ema": tr.step_ms.value, "log": lines,
                        "launches": launches, "launches_expected": want}
    log("train_api", **row["train_api"])
    del tr, ds
    torch.cuda.empty_cache()
    if launches != want or tr_steps_wrong(row["train_api"]):
        raise AssertionError(f"Trainer.train: launches {launches}, want "
                             f"{want}: {row['train_api']}")

    t0 = time.perf_counter()
    prims = bench_primitives.run(device="cuda")
    for p in prims:
        log("primitive", **p)
    row["primitives"] = {"rows": len(prims),
                         "seconds": time.perf_counter() - t0}
    row["seconds"] = time.perf_counter() - t_phase
    row["card"] = card
    log("final_slice", **{k: v for k, v in row.items()
                          if k not in ("fixtures",)})
    return row


def tr_steps_wrong(train_api: dict) -> bool:
    """`Trainer.train(n)` ran other than n steps, or logged other than its
    two lines."""
    return (train_api["steps"] != TRAIN_API_STEPS
            or train_api["step_bodies"] != TRAIN_API_STEPS
            or len(train_api["log"]) != 2
            or not train_api["log"][-1].startswith(
                f"iteration={TRAIN_API_STEPS} loss="))


def main() -> int:
    signal.alarm(WALL_LIMIT_S)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "rnb_neus2_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no rnb_neus2_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from rnb_neus2_torch.device import resolve_device
    from rnb_neus2_torch.kernels import build
    from rnb_neus2_torch.kernels import corner_backward as cbw
    from rnb_neus2_torch.kernels import encode_jacobian as ejac
    from rnb_neus2_torch.kernels import hash_grad_small as hgs
    from rnb_neus2_torch.kernels import march as mk
    from rnb_neus2_torch.kernels import neus_loss as nl
    from rnb_neus2_torch.kernels import scatter_add as sca
    from rnb_neus2_torch.io import native, png, raycast
    from rnb_neus2_torch.ops import hash_encoding as he
    from rnb_neus2_torch.tools import bench_scatter as bench
    av1 = types.SimpleNamespace(_library=native._av1_library,
                                LIBRARY=native.AV1_LIBRARY)
    scale = types.SimpleNamespace(_library=native._scale_library,
                                  LIBRARY=native.SCALE_LIBRARY)
    av1_enc = types.SimpleNamespace(_library=native._av1_enc_library,
                                    LIBRARY=native.AV1_ENC_LIBRARY)
    exr = types.SimpleNamespace(_library=native._exr_library,
                                LIBRARY=native.EXR_LIBRARY)

    kernels = {"hash_grad_small": hgs, "scatter_add": sca,
               "encode_jacobian": ejac, "corner_backward": cbw,
               "neus_loss_scan": nl.scan_kernel,
               "neus_loss_forward": nl.forward_kernel,
               "neus_loss_backward": nl.backward_kernel,
               **{c.name: c for c in mk.COUNTERS}}
    scatters = ("hash_grad_small", "scatter_add")
    card = bench.card_name_and_power()
    print(card, flush=True)
    dev = resolve_device("cuda")
    log("device", kind=torch.cuda.get_device_name(0), nvidia_smi=card,
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)

    build_all(build, [hgs, sca, ejac, cbw, nl, mk, raycast, png, native,
                      av1, scale, av1_enc, exr])
    errs = check_kernels_vs_plain(torch, bench, kernels, dev)
    for name, sizes in (("hash_grad_small", (4096, 13824)),
                        ("scatter_add", (39304, 125000, 373248, 1 << 19))):
        time_inputs(torch, bench, name, kernels[name], dev, card,
                    uniform_inputs(torch, dev, sizes, (1 << 18, 1 << 21)))
    probes = bench.run(list(bench.SECTIONS), dev,
                       emit=lambda line: log("probe", **json.loads(line)))
    log("probes", points=len(probes))
    check_small_agreement(torch, dev)
    check_stochastic_agreement(torch, dev)
    summary, tr = train(torch, kernels, dev, 1, TRAIN_STEPS)
    if summary["final_steps_at_all_levels"] < FULL_LEVEL_STEPS:
        raise AssertionError("too few final steps ran all 14 levels")
    exact, tr_exact = train(torch, kernels, dev, 0, EXACT_STEPS)
    # phase 21: the training encode's kernels against their plain versions
    encode_phase = encode_kernels_phase(torch, bench, dev, card)
    # phase 22: the loss's kernels against their plain version in float64
    loss_phase = loss_kernels_phase(torch, bench, dev, card, tr)
    # phase 23: the march's kernels against the plain march, bit for bit
    march_phase = march_kernels_phase(torch, bench, dev, card, tr)
    # phase 4 again, on the inputs of the trained fields' next steps: the
    # training encode's kernels on the K = 1 step's, the exact backward's
    # on the exact step's, level by level
    enc_in = encode_inputs(torch, tr)
    enc_timed = time_encode_kernels(torch, bench, dev, card, enc_in, "K=1")
    exact_in = main_path_inputs(torch, tr_exact)
    b = enc_in["corner_backward"]
    base = he._position_hash(b["positions"])
    for lvl in range(b["La"]):
        # the K = 1 picks that the backward kernel adds, as elements
        _, idx, v = cbw.level_picks(b["static"], b["positions"], b["g_out"],
                                    b["g_jac"], lvl, b["mask"][lvl], b["k"],
                                    b["salt"] * b["La"] + lvl, base)
        S = int(b["static"].table_sizes[lvl])
        exact_case = exact_in[lvl] if lvl < len(exact_in) else None
        log("warp_repeats", level=lvl, kernel=exact_case and exact_case[0],
            S=S, **{"K=1": warp_repeats(torch, S, idx, v),
                    "exact": exact_case and warp_repeats(
                        torch, *exact_case[1:])})
    fixed = {}
    for name, S, idx, v in (next(c for c in exact_in if c[0] == k)
                            for k in scatters):
        out = torch.zeros(S, v.shape[1], device=dev)
        zeros = torch.zeros_like(v)
        fixed[name] = bench.time_ms(
            lambda: bench.KERNELS_INTO[name](out, idx, zeros))
        log("fixed_cost", kernel=name, S=S, n=idx.numel(), card=card,
            ms_into_zero_values=fixed[name])
    rows = []
    for name in scatters:
        mod = kernels[name]
        # the exact backward is these kernels' path since the K-corner
        # backward became one kernel
        t = time_inputs(torch, bench, name, mod, dev, card,
                        [c[1:] for c in exact_in if c[0] == name],
                        main_path=True)
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"rnb_neus2_torch/csrc/{mod.SOURCE}",
            "replaces": list(mod.REPLACES),
            "path": "exact backward (stoch_corner_bwd=0)",
            "launches": exact["launches"][name],
            "launches_default_path": summary["launches"][name],
            "max_abs_err": max(errs[name], t["max_abs_err"]),
            "ms": t["ms"],
            "ms_into": t["ms_into"],
            "ms_into_scatter_add": t.get("ms_into_scatter_add"),
            "ms_into_zero_values": fixed[name],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_into_ms": t["bound_into_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    for name in ("encode_jacobian", "corner_backward"):
        mod, t = kernels[name], enc_timed[name]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"rnb_neus2_torch/csrc/{mod.SOURCE}",
            "replaces": list(mod.REPLACES),
            "path": "default (stoch_corner_bwd=1)",
            "launches": summary["launches"][name],
            "launches_exact_path": exact["launches"][name],
            "max_abs_err": max(encode_phase["max_abs_err"][name],
                               t["max_abs_err"]),
            "ms": t["ms"],
            "ms_into": t.get("ms_into"),
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "bound_bytes": t["bound_bytes"],
            "library_ms": None,
        })
    for name in LOSS_KERNELS:
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"rnb_neus2_torch/csrc/{nl.SOURCE}",
            "replaces": list(nl.REPLACES),
            "path": "every training path",
            "launches": summary["launches"][name],
            "launches_exact_path": exact["launches"][name],
            **loss_phase["rows"][name],
        })
    for name in MARCH_KERNELS:
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"rnb_neus2_torch/csrc/{mk.SOURCE}",
            "replaces": list(mk.REPLACES),
            "path": "every training path (the coarse grid's: at cone 0)",
            "launches": summary["launches"][name],
            "launches_exact_path": exact["launches"][name],
            **march_phase["rows"][name],
        })
    del enc_in, exact_in
    forced_rollback(torch, tr)
    mesh_export(torch, tr, card)
    chamfer_protocol(torch, dev, card)
    host_syncs(torch, tr)
    render_phase(torch, tr, card)
    refined = refine_phase(torch, kernels, tr, card)
    del tr, tr_exact
    torch.cuda.empty_cache()
    # phase 11's scene, snapshot and mesh stay for phase 20
    work11 = tempfile.TemporaryDirectory()
    cli_phase(torch, dev, card, Path(work11.name))
    piped = pipeline_phase(torch, kernels, card)
    testbed_phase(torch, dev, card, Path(work11.name))
    dyn = dynamic_phase(torch, kernels, dev, card)
    from rnb_neus2_torch.testing.synthetic import sphere_dataset
    ds = sphere_dataset(**SPHERE, device=dev)
    opts = options_phase(torch, kernels, dev, card, ds)
    del ds
    with tempfile.TemporaryDirectory() as work:
        extra = extra_modes_phase(torch, kernels, dev, card, Path(work))
    par = parallel_phase(torch, bench, kernels, dev, card)
    torch.cuda.empty_cache()
    fmts = formats_phase(torch, kernels, card)
    final = final_slice_phase(torch, kernels, card, Path(work11.name))
    work11.cleanup()
    for row in rows:
        row["launches_pipeline"] = piped["launches"][row["name"]]
        row["pipeline_steps"] = piped["step_bodies"]
        row["launches_dynamic"] = {p["phase"]: p["launches"][row["name"]]
                                   for p in dyn["phases"]}
        row["launches_refinement"] = sum(
            refined[k]["launches"][row["name"]] for k in ("pose", "focal"))
        row["launches_dense_adam"] = \
            refined["dense_adam"]["launches"][row["name"]]
        row["launches_options"] = {k: r["launches"][row["name"]]
                                   for k, r in opts.items()}
        row["launches_extra_modes"] = {
            k: r["launches"][row["name"]] for k, r in extra["fits"].items()}
        row["launches_parallel"] = par["launches"][row["name"]]
        row["launches_formats"] = fmts["launches"][row["name"]]
        row["launches_formats_jp2"] = \
            fmts["jp2_scene"]["launches"][row["name"]]
        row["formats_jp2_steps"] = fmts["jp2_scene"]["step_bodies"]
        row["launches_formats_avif"] = \
            fmts["avif_scene"]["launches"][row["name"]]
        row["formats_avif_steps"] = fmts["avif_scene"]["step_bodies"]
        row["launches_formats_sgilog"] = \
            fmts["sgilog_scene"]["launches"][row["name"]]
        row["formats_sgilog_steps"] = fmts["sgilog_scene"]["step_bodies"]
        row["launches_formats_avis"] = \
            fmts["avis_scene"]["launches"][row["name"]]
        row["formats_avis_steps"] = fmts["avis_scene"]["step_bodies"]
        row["launches_train_api"] = \
            final["train_api"]["launches"][row["name"]]
        row["formats_steps"] = fmts["step_bodies"]
        row["parallel_steps"] = par["steps"]
        t = par["kernels"].get(row["name"])
        if t:
            row["max_abs_err"] = max(row["max_abs_err"], t["max_abs_err"])
            row["parallel_path"] = {k: t.get(k) for k in (
                "ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")}
    log("done", card=card, total_s=time.perf_counter() - T0)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
