#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --digests [--package-root DIR]

Run from the root of the repository. ``--package-root DIR`` runs the
script on the package under DIR (another commit unpacked there) instead of
its own; ``--digests`` runs only J1, J5, J2, J6, J7 and J3's replayed paths
and prints their digest lines (sha256 of each path's outputs, measurements,
flags and carried state, the keyframe windows as (P, P, N) whatever layout
the package keeps), so one call can hold two commits' paths byte for byte.
Phases:

  1. Build the port's CUDA kernels from ``video_stabilizer_tpu_torch/csrc``
     (one nvcc per source, all at once) and print what ptxas reports for
     each kernel (registers, shared memory); all 16 instances of kernel A
     (2 models x 2 interps x 1-4 channels), every block-size instance of
     kernels B and C, both of kernel D (the wavefront for windows of up
     to 32, one thread a row beyond), both of kernels E (n = 4 one
     thread a matrix, n = 8 one warp a matrix) and F (P = 4, 8), kernel
     G's one, H's two (its narrow and wide engines), I's one and J's four
     (R = 4 and 8 Jacobian rows, each in the histogram and the exact-count
     mode) must report no spills and a 0-byte stack
     frame (kernel E: 32 bytes, the CUDA math library's sinf / cosf
     argument-reduction buffer).
  2. Check that ``utils.io.synth_shaky_clip`` gives the same small clip on
     the card as on the CPU (the tests hold the CPU's to the JAX package's).
  3. Drive the 1080p similarity path over two chunks to capture real
     kernel inputs: 1080p BGR, 8 streams, 16-frame chunks, state carried
     from chunk to chunk, on content with rotation and zoom jitter as well
     as 1 px shake.
  4. Kernel A (output warp), similarity + bilinear, against its plain
     PyTorch version on the card: at the main path's batch (128 frames,
     crop 32) and at 16 frames with random similarity transforms; 4
     frames of its similarity + Lanczos2 form; and both similarity forms
     on 3 ragged 437x1033 frames (partial tiles both ways, crop 5) at 1, 3
     and 4 channels with bulk shifts near the +-192 clip. Bar: max 1 LSB,
     >= 99.9 % of pixels equal; the share printed is bit-equal pixels.
  5. Kernel B (per-level 4-DOF GN solve) against its plain version on the
     card, at each of the six 1080p level shapes, with the items of that
     chunk. Bar, over every item: converged equal, A/B within 1e-5, TX/TY
     within 1e-3 px; and the items' A/B at least 10x the A/B bar. Two
     launches must give bit-identical outputs. Reported per level: the
     launch plan (cluster size, block size, shared memory), mean and max
     iterations, the wrapper's time between CUDA events (host launch
     overhead included, as earlier runs took it: the ``ms`` of the
     kernels line) beside the kernel's device time (20 launches replayed
     from a CUDA graph: its ``device_ms``), the time per iteration and the
     fixed cost (a line through the device times at max_iters 1, 4 and 16
     with threshold 0), and the device time under every cluster size
     (1-8) and block size the kernel is built for.
 5F. Kernel B in its fixed-iteration mode (``fixed_iters`` = K: exactly K
     iterations, converged = the last step moved no corner by the
     threshold) against its plain version on phase 5's items at K = 1 and
     4: converged equal, iters == K on every item, A/B 1e-5, TX/TY 1e-3
     px, two launches bit-identical; wrapper and device time per level.
  6. Drive the 4K homography path (config 4 of apps/bench_configs.py:
     3840x2160 BGR, 2 streams x 16-frame chunks, phase-correlation init,
     8-DOF model, Lanczos2 output, crop 32) over two chunks to capture
     kernel C's inputs at its 7 levels and kernel A's frames and
     corrections; and align 16 pairs whose template is a 4K frame warped
     by a known homography with perspective (by kernel A's homography
     form), capturing kernel C's inputs there too.
  7. Kernel A, homography + Lanczos2, against its plain version: the 32
     captured 4K frames with their real corrections and 8 frames with
     random homographies (|p0,p1,p3,p4|, |p6,p7| <= 4e-3, translation
     <= 40 px); 4 frames of the homography + bilinear form; and both
     homography forms on the ragged case of phase 4. Bar: max 1 LSB,
     >= 99.9 % of pixels equal.
  8. Kernel C (per-level 8-DOF GN solve) against its plain version at all
     7 level shapes, on the captured and the perspective items. Bar, over
     every item: converged equal, corner error between the two <= 0.02 px
     (the GN threshold) at the level's size; and the perspective items'
     median max(|p6|,|p7|) at least 10x the largest p6/p7 gap. Two
     launches must give bit-identical outputs. Reported per level as in
     phase 5.
 D.  Kernel D (the TV-L1 smoother's whole 100-iteration loop, one launch)
     against its plain version, bit for bit (float32 bits, so NaN
     positions count): (a) the 1080p chunk's rows (8 x 16 x 4 of 16, the
     valid lengths and lam as ``_chunk_smoothed`` built them in phase 3's
     chunk), (b) the 4K chunk's (2 x 16 x 8, phase 6's), (c) the
     streaming window (4 rows, count 1-16, a real window of (a)), (d)
     ``eval_combos``' rows (its 12 lambdas, one per combo, 12 x 55 x 4),
     (e) edge rows: N = 1, 2, 23, and 64 and 400 (the working values in
     the output row), lam 0.1, valid_len 1, N and per
     row, exact ties at mag == lam, a NaN row, values of 1e-30 and 1e6.
     Also whether torch on the card compares and subtracts a Python float
     lam in float32 (as JAX does). Times (a)-(d): the wrapper between CUDA
     events over 50 launches, the device time (50 launches replayed from a
     CUDA graph), the plain version, the roofline bound and the
     dependence-depth bound: the row's 2 x (100 - 1) + N - 1 wavefront
     steps times one step, measured on one row of the shape alone (its
     device time at 1,100 iterations less that at 100, over the 2,000
     steps between them: the launch cost drops out), beside that row's
     own 100 iterations less none; the device time per step of the depth.
     No library call computes this loop.
 E.  Kernels E (the regularized Jacobi pseudo-inverse, one launch a call)
     and F (the accumulator scan, one launch a chunk or clip) against their
     plain versions on the card. Kernel E on the Hessians a spy recorded in
     phases 3 and 6 ((a) the 1080p chunk's 6 levels, (b) the 4K chunk's 7),
     (c) one streaming item (each 1080p level's first alone), (d) G1's
     sweep (its align un-captured, 864 items a level) and (e) edge
     matrices, n = 4 and 8: zero, diagonal, equal diagonal entries, SPD,
     cond 1e7 and rank-deficient (both the Tikhonov branch), entries of
     1e-30 and 1e30, a NaN. Bar: bit-equal (float32 bits, NaN positions
     included), else every entry within 2 ulps (the phase says which held
     and the largest gap). Kernel F on the accumulator calls a spy recorded
     in phases 3 and 6 ((a), (b)), (c) 32-frame clips of both models (a
     chunk's measurements twice over, smoothed by kernel D, through
     ``batch.accumulate_corrections``), (d) the smoother sweep's 12
     combos with one decay row each, (e) the clips with the smoother off,
     (f) failures mid-chunk, (g) invalid leading steps, (h) a NaN and a
     1e30 measurement. Bar: bit-equal, every step's accumulator and the
     last, NaN positions included. Times as in phase D: the wrapper over
     50 launches, the device time (50 launches replayed from a CUDA graph),
     the plain version, the roofline bound and the dependent-chain bound,
     measured: kernel E's 4x4 form on one matrix alone, its device time at
     66 sweeps less that at 6, over 10 (6 sweeps' 36 rotations in order,
     no launch); its 8x8 form 6 x 7 rounds of 4 independent rotations, so
     42 of those 4x4 rotations (the 8x8 form's own time a round, one
     matrix at 66 less 6 sweeps, is printed beside it); and for every
     shape one matrix's own 6 sweeps less none; kernel F on one
     sequence alone, its steps tiled 11 times less once, over 10. Kernel
     E's library yardstick: ``torch.linalg.eigh`` and the
     same regularized V diag(inv_w) V^T as a matmul, timed only. No library
     call runs kernel F's scan.
 G.  Kernels G (BGR to gray, one launch a call) and H (a pyramid level's
     downsample, one launch a level over all frames) against their plain
     versions on the card, bit for bit. Kernel G on (a) a 1080p chunk of
     bench.py's content (8 x 16 frames), (b) a 4K chunk (config 4's
     content, 2 x 16), (c) one 1080p frame, (d) one ragged 437x1033 frame
     and 3 of them at an odd address (the byte-at-a-time path) and (e)
     all 2^24 BGR triples as one 4096x4096 image. Kernel H (its narrow
     engine on small levels, its wide one on large) at every level of
     (a)'s and (b)'s pyramids (5 and 6 levels below the first, on their
     gray frames; levels 1 and 2 also from one frame and from every frame
     at an odd address), (c) a ragged chain of 3 frames from 437x1033
     down to 3x8 (7 levels), (d) one 1080p frame's pyramid (the streaming
     step's), (e) the soak's 48x64 frame's, (f) 4 frames of 1080x1924
     (rows 4 bytes apart) and (g) 70,000 8x8 frames (more than a grid
     axis's 65,535), 2 levels below the first each. Per shape: the wrapper between CUDA
     events over 50 launches, the device time (50 launches replayed from
     a CUDA graph), the plain version, the byte bound; for H also
     ``F.conv2d`` alone (stride 2, TF32 off, on the replicate-padded
     float32 input: it leaves out the pad, both casts and the shift;
     whether its floor equals the kernel is printed), and per chain the
     sums and the whole pyramid's device time (50 ``build_pyramid`` calls
     replayed from a CUDA graph, the gaps between its launches included).
     No single PyTorch call rounds as kernel G does.
 I.  Kernel I (a keyframe set's precompute: gradients, tile argmax,
     Jacobian rows, u8 windows; one launch for every level of all the
     keyframes) against its plain version on the card, bit for bit in all
     five fields (float32 as bits), in both models on every input, in one
     launch for all levels and with each level's work list alone: (a) the
     6 levels of a 1080p chunk's 64 keyframes (the odd frames of bench.py's
     content, 8 x 16, through kernels G and H), (b) the 7 levels of a 4K
     chunk's 16 (config 4's content), (c) one 1080p frame (K = 1), (d) the
     zero pyramid of 8 streams (the zero carry), (e) tie-heavy frames
     (flat, stripes, a checkerboard), (f) the ragged chain from 437x1033,
     (g) the soak's 64x48 and (h) 70,000 8x8 frames; and from every other
     frame of a buffer at an odd address (``align_pairs``' strided view)
     into rows [8, 8 + K) of a set whose 8 rows before and 2 after stay
     unchanged. Per level alone, in the input's path model (homography for
     (b), similarity otherwise): the wrapper between CUDA events over 50
     launches, the device time (50 launches replayed from a CUDA graph),
     the plain version, the byte bound; per input the one launch's wrapper
     and device time beside the levels' sums and the summed bound. No
     single PyTorch call computes this precompute.
 SEL. Kernel J (select's warp-diff prelude of a level: the template
     intensities, the Lanczos2 warp diffs at the incoming transform, the
     histogram keep-mask, the masked Jacobian and the Hessian; one launch
     a level, either model) against its plain version on the card, on the
     calls phases 3 and 6 recorded: (a) the 1080p chunk's 6 levels
     (similarity, 128 items), (b) the 4K chunk's 7 (homography, 32
     items), (c) one streaming item (each 1080p level's first, on its own
     keyframe), (d) G1's sweep (its align un-captured, 864 items a level,
     one keep fraction each) and (e) edge inputs in both models: ties
     (every diff 7), keep fractions 0, 1, 1.5, -0.5 and 0.5 per item,
     diffs in the overflow bin (windows of 255 under the positive tap
     weights at half-pixel positions), positions pushed onto the clamp,
     and ragged N (a 437x1033 chain's finest and coarsest levels). The
     kernel also writes its warp diffs (a debug output, off on the paths).
     Bars: tmpl bit-equal; jac_masked equal to jac * mask (x 0.5 for the
     similarity) bit for bit, the mask histogram_mask's on the kernel's
     own diffs; those diffs within 2^-10 of the plain version's (the two
     add the taps in other orders); each mask entry that differs from the
     plain version's counted and printed, and each lies within that gap
     of an integer or in a row where such an entry's bin moved; the
     Hessian within 1.2e-7 of a float64 sum of the same masked products,
     relative to the sum of their magnitudes (float32 products summed in
     float64 and rounded once stay within 2^-23; a float32 running sum
     does not), and symmetric; two launches byte-equal. Per level of (a)
     and (b): the launch plan, the wrapper between CUDA events over 50
     launches, the device time (50 launches replayed from a CUDA graph),
     the plain version, the byte bound (each input read once: a
     keyframe's coords, jac and idx once for each keyframe in use, the 16
     taps and the outputs for each item) and the taps counted as 32-byte
     sectors twice: in the JAX package's (P, P, N) windows (a sector a
     tap) and in the port's keypoint-major ones (the sectors each patch's
     4 rows of 4 bytes touch at their device addresses); and each chunk's
     sums; (c)'s device time a level and summed. Printed first: the
     registers a thread of each form
     (``cudaFuncGetAttributes``) and the CTAs an SM holds. No single
     PyTorch call computes this prelude.
     Then its exact-count mode (``selection="topk"``), on (a)-(d) under
     ``topk`` and on the edge inputs at the default count and (ties,
     overflow, ragged) at k = 1, k = N and k > N: its mask (a debug
     output) equal to ``topk_mask`` of its own diffs bit for bit, exactly
     k kept in every row, tmpl bit-equal, jac_masked = jac * mask bit for
     bit, the diffs within 2^-10 of the plain version's, the Hessian
     within 1.2e-7 of a float64 sum, symmetric, two launches and clusters
     1-8 byte-equal, the ties input cut inside its run of 7s; each mask
     entry that differs from the plain ``topk`` prelude's counted and
     printed, and each lies within 2 x 2^-10 of its row's k-th plain diff
     (two diffs that close may swap order). Per level of (a), (b) and (d):
     the device time under each cluster size; of (a) and (b) also the
     wrapper, the device time beside the histogram mode's, the plain
     ``topk`` prelude, ``topk_mask`` alone on the kernel's diffs and the
     byte bound; the registers, static shared memory and CTAs an SM of
     the mode at the chunks' largest slice and at G1's level 0 uncapped.
 8C. 4K content: a chunk of 2 streams x 16 frames through the 4K path from
     a fresh state, stream 0 a moving perspective sequence (each frame the
     previous one warped by a known homography with p6/p7 != 0, through
     kernel A's homography form): kernel C against its plain version at
     all 7 levels to phase 8's bars, the perspective check on stream 0's
     items. The same content through the 4K similarity path: kernel B at
     its 7 levels to phase 5's bars.
  9. The 1080p similarity path, timed, on bench.py's content (translation
     only, 1 px jitter): 4 chunks with carried state from a fresh start,
     first un-captured (``utils.graphs.eager()``) under the span recorder
     for the stage table, then through ``stabilize_chunk_streams``, which
     replays the captured chunk (its first call captures), with every
     launch count set to 0 before and read after. Checks the output
     shape, the replays, the align success rate (>= 0.9), the measured
     motion against the clip's known motion, and the launches: kernel E
     once per level (as B), kernel F once per chunk, kernel G once per
     chunk, kernel H once per level below the first (5 a chunk; 6 at 4K
     in phase 10), kernel I once a chunk (every level in one launch;
     the fresh state's zero carry runs before the counts are set to 0)
     and kernel J once per level (as B).
     Prints the un-captured keyframe span beside kernel I's first
     design's. One more chunk, replayed, runs under torch.profiler.
 9T. Phase 9's run with ``selection="topk"`` (the exact-count keypoint
     selection): the same checks, kernel J (its exact-count mode) launched
     once per level as B, no plain version run on the card; its stage
     table beside phase 9's; then, on one more un-captured chunk's calls,
     each 1080p level's ``histogram_mask`` and ``topk_mask`` alone and
     kernel J's two modes, each call between CUDA events.
 9F. The FIR output warp (``output_warp="fir"``, ops/fast_warp.py)
     against the gather oracle (ops/warp.py) on phase 9's 128 delayed
     frames and corrections and on 8 of them at integer translations
     (bit-exact), subpixel translations (<= 1 LSB) and rotation / zoom
     within the envelope (<= 2 LSB on > 99.9 %); timed beside kernel A and
     grid_sample on the 128 frames.
 J1. The 1080p chunk of phase 9's clip through the captured chunk
     program as a serving loop calls it, donating its state (each call's
     returned state fed to the next), against the un-captured composition
     run twice on a copy of the state taken before each donated call, on
     the same pinned inputs (any output in which it differs from itself is
     held to phase 9's bars instead): every call's outputs, meas, succ,
     valid and state byte-equal; the returned state the key's static
     inputs; the first chunk's returned outputs unchanged after the later
     chunks ran. Prints the replayed chunks' digest line, the capture and
     instantiate time, the graph pool's bytes, the peak memory, the static
     inputs' and outputs' bytes, the replayed chunk's host-clock time over
     20 chunks (median, min, max, spread) beside the un-captured chunks',
     the device-busy share and the copies of 3 replays under
     torch.profiler (beside the DtoD a replay read while the state was
     copied in and cloned out), and the launches per replay (kernels D, F
     and G once, E and J once per level, I once, H once per level below
     the first). Then a state passed again after a later call advanced it
     must raise, and two chains of one key fed in turn (the streams, and
     the streams reversed) must each equal their run alone.
 10. The 4K homography path, timed, the same way: 4 chunks on
     bench_configs' content (seeds 5 and 6), kernel C's and kernel A's
     homography + Lanczos2 counts > 0 and kernel B's 0, success >= 0.9,
     p2*W, p5*W against the known motion; one more chunk under the
     profiler.
10F. The FIR warp's homography + Lanczos2 form against the gather oracle
     on phase 10's 32 delayed frames and corrections and on 4 frames with
     random homographies within the envelope (<= 2 LSB on > 99.9 %); timed
     beside kernel A.
 J2. J1 for the 4K config 4 chunk (cuFFT, kernel C, kernel A's
     homography + Lanczos2 form), the replay timed over 8 chunks.
 J5. The clip path: ``stabilize_streams`` (``_stabilize_streams_jit``) on
     the first 32 frames of phase 9's 8 streams, the clip on the card
     before the call (the upload timed apart). The un-captured call twice
     (an output in which it differs from itself is held to phase 9's bars
     instead), then the first call (eager run and capture) and 5 replays:
     outputs, meas and success byte-equal to the un-captured call, the
     first call's values unchanged after the replays (the last replay's
     digest line printed); kernels A and B
     launched in every replay, G once, H once per level below the first
     and I twice (the zero carry and the keyframes). Prints the
     first call's, the capture's and
     the instantiation's time, the graph pool, the peak memory, the
     launches per replay and the replays' median and spread beside the
     un-captured time.
 J6. J5 for ``stabilize_streams_homography`` on the first 32 frames of
     phase 10's 2 4K streams (config 4: cuFFT, kernel C, kernel A's
     homography + Lanczos2 form).
 J9. The clip programs' memory, and the programs J5-J8 do not run on the
     card. (a) ``stabilize_streams`` on the first 32, 24 and 16 frames of
     phase 9's 8 streams in a row, then the 16 once more: the program
     keeps one key after each call (a new length drops the last one's
     graph and pool), the card holds no more than that key's pool and
     static input (+ 0.25 GB) after each call once its cache is emptied,
     and the last call replays. (b) ``stabilize_streams`` with
     ``output_warp="fir"`` (the FIR warp inside the clip program) on 2
     streams x 32 frames, (c) the smoother sweep's ``eval_combos`` on its
     app's default clip (60 frames of 360x640, seed 4; lag 10, memory 5,
     its 12 combos), after the app's one align, (d) ``median_flow_px``
     called alone on 8 1080p pairs: each as J5, with 2 or 3 replays.
J10. The chunk programs' memory, and long replay. (a)
     ``stabilize_chunk_streams`` on 16-frame chunks of phase 9's streams
     with 8, 6, 4, 8, 6, 4 and 8 streams in a row (each stream count's
     state carried to its next call), then ``ChunkedStabilizer.
     process_chunk`` on one stream with chunks of 16, 8, 16, 8, 6, 4 and 2
     frames. After each call, its cache emptied, the card holds no more
     than the largest pool a key grew at its capture, the kept keys'
     static inputs, the other kept keys' static outputs, the caller's
     state and 0.25 GB (the shared pool's own segments printed beside);
     at most 4 keys are kept, and the 5th chunk length drops the least
     recently called. Every repeated shape replays, and every replay is
     byte-equal to the un-captured call on the same inputs (outputs,
     meas, success, valid, carried state), after the other keys of the
     shared pool captured and replayed in between. The stabilizer's calls
     donate its state, so that state is a kept key's static inputs (counted
     once). Last, another stabilizer's chunks of 16, 8, 6 and 4 frames drop
     the 2-frame key while the first keeps its state: the same bar after,
     that state counted as the caller's, and its next chunk byte-equal to
     the un-captured one. (c) What a dropped key keeps: from an empty
     program an 8-stream (then a 2-stream) 16-frame key, then one
     stream's keys of 2, 4, 6 and 8 frames, the 4th dropping it; the
     card's reserved memory (cache emptied) less that of the same 1-stream
     keys alone, at most the dropped key's pool + 0.25 GB. (b) 1,000
     replays of
     tests/test_torch_soak.py's 64x48 two-frame chunk: one capture, the
     card's reserved memory the same after replay 1 and replay 1,000, the
     state finite; the replays' median time.
 11. Reported, no bar: one chunk of 4 px jitter content through kernel B
     and through its plain version (un-captured, so the patched engine
     runs), with convergence and known-motion
     error for each. Each item whose converged flag differs between the
     two runs is named (stream, frame, level), and on each run's inputs of
     that level both engines' own loops and their per-iteration max corner
     moves (fixed mode, K = 1 .. max_iters) are printed side by side.
 G2. Kernel C with one threshold per item, drawn from 0.01 / 0.02 /
     0.04 px, against its plain version on phase 8's captured and
     perspective items at all 7 levels: phase 8's bars (the p6/p7 check on
     the items whose engines ran the same iterations), two launches
     bit-identical, times and bound of the captured items.
 G1. The aligner sweep at 1080p: apps/grid_search_align's 27 combos
     (threshold 0.01 / 0.02 / 0.04 x fraction 0.7 / 0.8 / 0.9 x
     max_displacement 5 / 10 / 20, window margin widened to 22) on 32
     frames of bench.py's content (seed 100) through ``align_clip_impl``
     with (27,) DynAlignParams, launch counts set to 0 before and read
     after (kernel B once per level for all 27 x 32 items, kernel I twice:
     the zero carry and the keyframes, kernel J once per level, one keep
     fraction per item). (a) Kernel B
     with per-item thresholds against its plain version at every level:
     converged equal; phase 5's bars on the items whose engines ran the
     same iterations (not the A/B >= 10x check: translation-only content);
     the items that stopped one iteration apart (at most 1 % of a level)
     straddle their threshold, the plain engine's move at the deciding
     step within 10 % of it; fewer iterations at 0.04 px than at 0.01 px.
     (b) Each combo run alone with those values in its AlignerParams: ok
     equal on every frame, measurements within phase 5's bars, the
     bit-equal combos counted.
     (c) The sweep's align time beside the 27 runs alone, and
     ``_align_clip_jit`` with the (27,) dyn as an input: its first call
     and 5 replays byte-equal to the un-captured sweep, timed; the
     smoother sweep's one align (no dyn, default parameters), a one-shot
     call: its first call beside the un-captured time, byte-equal. (d)
     The FIR warp and ``median_jitter_px_device_impl`` over all combos'
     outputs, un-captured and timed; the best combo's out/in jitter ratio
     below 0.6.
 J7. ``run_combos`` (align, accumulate and FIR warp) on G1's inputs: the
     un-captured call twice, the first call and 3 replays, outputs, meas
     and ok byte-equal (the last replay's digest line printed); timed
     beside G1's un-captured align and FIR.
 J8. ``median_jitter_px_device_impl`` on J7's outputs (27 x 21 1080p
     pairs): the un-captured call twice, the first call and 3 replays,
     byte-equal f32, the out/in ratios equal G1 (d)'s; timed.
 G2 path. 8 frames of config 4's content through ``align_clip_impl`` with
     model="homography" and the three thresholds as (3,) DynAlignParams,
     launch counts set to 0 before and read after: kernels C and J once
     per level, kernel I twice, kernel B never; the 0.02 px combo against
     the run
     without ``dyn``: ok equal, >= 6 of 7 frames aligned.
 G3. The apps' pipeline at 1080p without cv2: 32 frames of bench.py's
     content written as a .y4m, read back bit-equal through
     ``utils.io.read_video`` (the native Y4M reader, built by ``make -C
     native``), stabilized by apps/video_test's ``stabilize_streaming``,
     ``stabilize_chunked`` and ``stabilize_batch`` (crop 0), each scored
     with ``median_jitter_px_device``: 22 outputs, output jitter < 0.6x
     the input's, align failures printed; the batch mode, a one-shot call
     of ``_stabilize_clip_jit`` (``_stabilize_streams_jit`` on one
     stream), once more un-captured: byte-equal, its time beside the first
     call's. Nothing is written as mp4.
 12. The port on the card against the port on the CPU (the plain versions)
     on a small clip: ok equal, >= 99 % of output pixels within 1 LSB.
 S1. The streaming path, timed: ``VideoStabilizer`` (crop 32, defaults
     otherwise: lag 10, smoother memory 5, bilinear) over 48 frames of one
     1080p stream of bench.py's content (seed 100) from a fresh state,
     twice: un-captured under the span recorder (the stage table), then
     through its replayed graphs (``_to_gray``, ``_align_next_frame_impl``,
     ``_smooth_window``, ``_warp_fn``; the first call of each key
     captures), each with every launch count set to 0 before and read
     after. Checks 38
     outputs of (1016, 1856, 3) u8, align success >= 0.9 of the 47
     alignable frames, TX/TY against the known motion (phase 9's bars),
     and the launches: kernel A once per output, kernel B once per level
     of every frame (the first frame runs the level loop, as in the JAX
     package), kernel C never, kernel D once per smoothed window, kernels E
     and J once per level of every frame, kernel F never (the host's
     accumulator), kernel G once per frame, kernel H once per level
     below the first of every frame and kernel I once for each of the 24
     keyframe frames (the odd ones; every level in one launch). Prints the
     un-captured keyframe span, the steady frames' mean beside kernel I's
     first design's, and a keyframe frame's.
     Prints the per-frame latency (host clock up to each frame's sync;
     median and p90 of frames 12-47) and the
     per-frame stage table from the spans; then 8 more frames, replayed,
     run under torch.profiler (device busy share).
 J3. A third fresh ``VideoStabilizer`` over S1's frames with every key
     already captured: no new capture; the outputs, measurements and
     flags of both replayed runs byte-equal to S1's un-captured run (its
     digest line printed, the carried aligner state and accumulator
     included); the per-frame median and p90 over frames 12-47 beside the
     un-captured run's.
 S2. Streaming vs chunked on the card: S1's first 32 frames against
     ``stabilize_stream_chunked`` (16-frame chunks): ok equal,
     measurements within 1e-5, >= 99.5 % of output pixels within 1 LSB
     (the JAX package's bars, test_batch.py:28-83).
 S5. S1's clip and checks with ``AlignerParams(fixed_iters=4)`` (kernel
     B's fixed mode, the card's counterpart of bench_latency's ``_fixed4``):
     per-frame median and p90, AlignNextFrame, success and known-motion
     error printed beside S1's.
 S3. Kernel A's and B's inputs captured from 4 frames of a 1080p stream
     with rotation and zoom (after ``lag`` frames from a fresh state,
     un-captured so that the spies see the wrappers' calls):
     kernel B at one item per launch at the six levels (phase 5's bars,
     the items' A/B >= 10x the A/B bar too; two launches bit-identical;
     wrapper and device time per level) and kernel A at one frame per
     launch (max 1 LSB, >= 99.9 % equal), with ``grid_sample`` on one
     frame as the yardstick.
 S4. The streaming path on the card against the CPU on a small clip
     (96x128, 20 frames): ok equal, >= 99 % of pixels within 1 LSB.
 P1. ``python -m video_stabilizer_tpu_torch.bench`` at its defaults (8
     streams x 16 1080p frames, 4 reps x 4 chunks), in this process: its
     JSON line parses with its metric string and the card's name, the
     align success >= 0.9, and the launch counts show kernels A, B, D and
     G launched, H 5 times for each G, I at least 6 times for each G (a
     whole number of levels: each fresh state's zero carry adds 6), J as
     often as B, C not.
 P2. ``apps/bench_configs.py``'s ``bench_4k`` at 2 streams, 3 reps:
     kernels A, C, D and G launched, H 6 times and I at least 7 for each
     G, J as often as C, B not; success >= 0.9 on the frames after each
     stream's first.
 P3. The latency modes, shortened: ``bench_latency`` (chain 16, 3 reps;
     the chain replayed as one captured graph),
     ``bench_latency_chunk2`` (chain 8, 3 reps) and
     ``bench_latency_request`` (20 samples): each line parses, each value
     positive and finite.
 J4. ``apps/bench_configs.py --mode latency`` at chain 32, 5 reps: the
     JAX tool's ``run_chain``, 32 align steps captured as one graph
     (``bench_configs.run_chain``: 1 capture, 5 replays, kernel B's, H's,
     I's and J's launches counted through them, J as B, I once for each
     of the chain's 16 keyframe steps; G none: the chain's frames are gray);
     prints its p50 beside the same steps issued one call each.
 P4. ``apps/profile_chunk.py`` on one un-captured 1080p chunk (a replayed
     graph has no Python frames): its per-kernel table
     names kernel A's, B's, D's, E's, F's, G's, H's, I's and J's symbols
     (J's ``prelude_kernel``: profile_chunk's ``HAND_KERNELS`` line charges
     select's device time to it), the hand kernels' line, the smoother's,
     the pseudo-inverse's, the accumulator's, the gray conversion's, the
     pyramid's, the keyframe's and select's kernels and device time per
     chunk are printed, ``--parse-only`` reprints the same
     totals from the saved trace, and ``--by-source`` puts over 90 % of
     the device time on frames under ``video_stabilizer_tpu_torch/``.
 P5. The scale-out modules on the card: ``graft_entry.entry()``,
     ``dryrun_multichip(1)``, a sharded chunk on the one-card mesh
     byte-equal to the unsharded call on the same 2 1080p streams (outputs
     and carried state), ``stabilize_streams_sharded`` on those 2 x 32
     frames twice (a capture of the card's ``_stabilize_streams_jit``, then
     a replay, kernel D launched by each) byte-equal to the un-captured
     clip, and
     ``apps/multihost_smoke`` (CPU, gloo) as a subprocess.

After each phase every program's graphs but the streaming programs' are
dropped (an 8-stream 1080p chunk program holds a memory pool of 8.76
GB); the streaming programs' stay. Every
phase runs; the script exits 1 if any failed, 2 without a card. On
success it prints the per-stage times, one ``{"kernels": [...]}`` line
(twenty entries: kernel A's two chunked forms and its one-frame form,
B per chunk, at one item, in its fixed mode at K = 4 (S5's launches) and
with per-item thresholds (G1's launches), C per chunk and with per-item
thresholds (the G2 path's launches), D at the 1080p chunk's rows, E at the
1080p chunk's level 0, F, G, H (summed over its 5 levels) and I's
similarity form (summed over its 6 levels) at the 1080p chunk (the 1080p
path's launches), J's similarity form summed over the 1080p chunk's 6
levels (the 1080p path's launches), its exact-count mode summed over the
same levels (9T's launches), and E's 8x8 form at the 4K chunk's
level 0 and I's and J's homography forms summed over the 4K chunk's 7
levels (the 4K path's launches)), the
card's name and power limit, and as its last line ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback
from unittest import mock

import numpy as np
import torch

HEIGHT, WIDTH, STREAMS, CHUNK, CHUNKS = 1080, 1920, 8, 16, 4
SEED = 100
# The 4K homography path: apps/bench_configs.py:34-53, BASELINE.json
# config 4. Its content is bench_configs', one seed per stream.
H4K, W4K, CHUNKS_4K = 2160, 3840, 4
SEEDS_4K = (5, 6)                 # one stream each
HOMOGRAPHY = "homography"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_OPS_PER_S = 67e12            # H100 SXM float32 outside the tensor cores
WARP_REPLACES = "video_stabilizer_tpu/ops/pallas_warp.py:117"
GN_REPLACES = "video_stabilizer_tpu/ops/pallas_gn.py:133"
GN8_REPLACES = "video_stabilizer_tpu/ops/pallas_gn.py:383"
# Kernel D replaces an XLA device loop, not a Pallas kernel: the lax.scan
# of tvl1_smooth.
TVL1_REPLACES = "video_stabilizer_tpu/models/smoother.py:30"
TVL1_NAME = "tvl1_smooth"
TVL1_ITERS = 100
# csrc/tvl1.cu's LANES: rows of up to this many values take its wavefront
# kernel (one lane a column), longer ones its one-thread-a-row kernel.
TVL1_LANES = 32
# Float32 operations of csrc/tvl1.cu per column and iteration (the
# relaxation's two multiplies and add) and per live pair update (the
# difference, abs, mag - lam, the clamp, the divide, * 0.5, xi + xj, * 0.5,
# the compare, diff * shrink, the add, the subtract and the two selects).
TVL1_OPS_PER_COLUMN = 3
TVL1_OPS_PER_PAIR = 14
# Kernels E and F replace XLA computations, not Pallas kernels: the Jacobi
# pseudo-inverse, Python loops that XLA unrolls (regularized_pinv_sym4 of
# ops/linalg.py), and the accumulator's lax.scan (the chunk's, chunked.py;
# the clip's twin is models/batch.py:284).
PINV_REPLACES = "video_stabilizer_tpu/ops/linalg.py:177"
PINV_NAME = "regularized_pinv_sym4"
PINV8_NAME = "regularized_pinv_sym4[8x8]"   # the kernels line's 8x8 entry
PINV_SWEEPS = 6
PINV_CHAIN_SWEEPS = 66     # phase E's chain: 66 less 6 sweeps, over 10
PINV_ROUNDS8 = PINV_SWEEPS * 7     # the 8x8 form's depth in rotations
PINV_ROTATIONS4 = PINV_SWEEPS * 6  # the 4x4 form's
ACCUM_REPLACES = "video_stabilizer_tpu/models/chunked.py:180"
ACCUM_NAME = "accum_scan"
# Float32 operations of csrc/accum.cu per folded step, by (P, smoother on):
# the inverse of the smoothed transform (similarity 17, homography 39: the
# adjugate's 27, the H22 normalization's 10, to_matrix's 2), two composes
# (17 or 59 each: the 3x3 products' 45), the four corners (18 or 27 each,
# the square root and the maximum counted one each), the decay's 10, the
# P multiplies by the factor and the 2P selects of the reset and the valid
# mask. Without the smoother the inverse and one compose drop out.
ACCUM_OPS_PER_FOLD = {(4, True): 145, (4, False): 111, (8, True): 299,
                      (8, False): 201}
# Kernels G and H replace XLA stages, not Pallas kernels: the colour
# conversion and a pyramid level's downsample (build_pyramid's step).
GRAY_REPLACES = "video_stabilizer_tpu/models/stabilizer.py:86"
GRAY_NAME = "bgr_to_gray"
PYR_REPLACES = "video_stabilizer_tpu/ops/pyr_down.py:50"
PYR_NAME = "pyr_down"
RAGGED_LEVELS = 8          # phase G's chain: 437x1033 down to 3x8
MANY_FRAMES = 70000        # phases G and I: more frames than a grid axis holds
# Kernel I replaces two XLA stages, not Pallas kernels: the keyframe
# precompute of each model, a level at a time. Its launch count and plain
# version go by KEY_NAME; the kernels line has one entry per model.
KEY_NAME = "keyframe"
KEY_ENTRY = "compute_keyframe"
KEY_H_ENTRY = "compute_keyframe[homography]"
# The un-captured keyframe span (ms) of kernel I's first design, a launch a
# level with the carried keyframes concatenated to the new ones, in the
# same script on an NVIDIA H100 80GB HBM3 at 700 W: phase 9, phase 10, and
# S1's mean over its steady frames (0 on the frames without a keyframe).
KEY_SPAN_BEFORE = {"similarity": 1.74, HOMOGRAPHY: 1.73, "stream": 0.29}
KEY_REPLACES = "video_stabilizer_tpu/models/aligner.py:163"
KEY_H_REPLACES = "video_stabilizer_tpu/models/homography_aligner.py:74"
# Operations of csrc/gray.cu per pixel (3 converts, 3 multiplies, 2 adds,
# the round) and of csrc/pyr_down.cu per output (per 4 outputs: two source
# rows' row sums, 17 each, and the column sums and the pack, 10). The
# integer ones count at the float32 rate (the table has no int32 rate);
# both kernels stay byte-bound at half that rate.
GRAY_OPS_PER_PIXEL = 9
PYR_OPS_PER_OUTPUT = 11
# Operations of csrc/keyframe.cu per tile pixel (two differences, two
# absolute values, two compares) and per keypoint (the similarity's four
# centring subtractions, eight products and four adds, two conversions; the
# homography's four subtractions, four products for u and v, two for g,
# four for the quadratic terms and sixteen rows times g, two conversions).
# Either way the kernel is byte-bound by two orders of magnitude.
KEY_OPS_PER_PIXEL = 6
KEY_OPS_PER_POINT = {4: 18, 8: 32}
# Kernel J replaces XLA stages, not a Pallas kernel: select's prelude of a
# level of each model, everything before the GN loop of _align_level and
# _align_level_h. Its launch count and plain version go by SEL_NAME; the
# kernels line has one entry per model, and one for its exact-count mode
# (selection="topk", the 1080p similarity path of 9T).
SEL_NAME = "level_prelude"
SEL_ENTRY = "level_prelude"
SEL_H_ENTRY = "level_prelude[homography]"
SEL_TOPK_ENTRY = "level_prelude[topk]"
SEL_REPLACES = "video_stabilizer_tpu/models/aligner.py:316"
SEL_H_REPLACES = "video_stabilizer_tpu/models/homography_aligner.py:130"
# The gap allowed between kernel J's warp diffs and its plain version's:
# the two add the 16 bf16 tap products and the 4 + 4 tap weights in other
# orders, a few float32 roundings of values up to about 320.
SEL_WD_GAP = 2.0 ** -10
# Kernel J's bytes, by Jacobian rows R, each input read once: per
# (keyframe in use, set, keypoint) 8 of coords, 4 R of jac and 4 of idx;
# per (keyframe, template) pair in use and (set, keypoint) the template
# byte; per (item, set, keypoint) the 16 window taps (at most the
# keyframe's whole P x P window), and written 4 of tmpl and 4 R of
# jac_masked. Counted as 32-byte sectors: in the JAX package's (P, P, N)
# windows each tap costs a sector of its own; in the port's keypoint-major
# (N, P, P) ones a patch costs the sectors its 4 rows of 4 bytes touch
# (``sel_sectors``). Its float32 operations per (item, set, keypoint): the
# position (similarity 10, homography 24 with u and v), clamp and floor
# 8, eight Lanczos2 weights 128, their normalizer 7, the 4x4 bf16 taps
# 100, the divide, |sample - tmpl| 2, the bin 2, the mask 2, jac_masked
# R, and the Hessian's R masked rows and R (R + 1) / 2 products and sums.
SEL_KEY_BYTES = {4: 28, 8: 44}
SEL_OUT_BYTES = {4: 20, 8: 36}
SEL_TAPS = 16
# Kernel J's Hessian against a float64 sum of the same masked products,
# relative to the sum of their magnitudes: each float32 product is within
# 2^-24 of the exact one, and the float64 sum, rounded once to float32,
# adds 2^-24 more, so a sound kernel stays within 2^-23 (1.19e-7); a
# float32 running sum of the same products reads up to about 1.7e-7 at
# the chunks' levels.
SEL_HESS_BAR = 1.2e-7
SEL_OPS = {4: 288, 8: 362}


# Stack frames a kernel may report beside its 0 spills: kernel E's 32 bytes
# are the CUDA math library's sinf / cosf argument-reduction buffer (its
# Payne-Hanek path, for |x| > 105615; the Jacobi angle is within pi/2),
# which torch's float32 sin and cos kernels carry too.
STACK_BYTES = {"jacobi": 32}


def pinv_ops(n: int) -> int:
    """Float32 operations of csrc/jacobi.cu per n x n matrix: per rotation
    the angle's 4 and atan2, cos and sin (counted one each), and 6 (4
    multiplies, 2 adds) per element of the 2 rows of A, the 2 columns of A
    and the 2 columns of V it rotates; then the regularization's 2n, V
    diag(inv_w)'s n^2 and per output element n products and 2n adds (the
    tree adds the reduction's 0)."""
    rotations = PINV_SWEEPS * n * (n - 1) // 2
    return rotations * (7 + 18 * n) + 2 * n + n * n + 3 * n ** 3

failures: list[str] = []


def log(msg: str):
    print(msg, flush=True)


def check(cond: bool, what: str):
    log(("  ok    " if cond else "  FAIL  ") + what)
    if not cond:
        failures.append(what)


def phase(name: str):
    """Run a phase, record a failure and carry on to the next."""
    def deco(fn):
        def run(*args, **kw):
            log(f"== {name}")
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            except Exception:
                traceback.print_exc(file=sys.stdout)
                failures.append(f"{name}: raised")
                return None
            finally:
                release_graphs()
                log(f"   ({time.perf_counter() - t0:.1f} s)")
        return run
    return deco


def release_graphs():
    """Drop every program's captured graphs after a phase but the streaming
    programs': a chunk, clip, sweep or metric program holds a memory pool
    (8.76 GB for an 8-stream 1080p or a 2-stream 4K chunk), and the
    phases run dozens of configurations. The streaming programs' pools are
    small (under 0.1 GB each) and stay, so that the streaming phases replay
    graphs the earlier ones captured."""
    from video_stabilizer_tpu_torch.models import aligner, smoother, stabilizer
    from video_stabilizer_tpu_torch.utils import graphs
    streaming = (aligner._align_next_frame_impl, smoother._smooth_window,
                 stabilizer._to_gray, stabilizer._warp_fn)
    graphs.reset([p for p in graphs.PROGRAMS if p not in streaming])


PLAIN_ON_CARD = {TVL1_NAME: 0, PINV_NAME: 0, ACCUM_NAME: 0, GRAY_NAME: 0,
                 PYR_NAME: 0, KEY_NAME: 0, SEL_NAME: 0}
PLAIN = {}


def count_plain_on_card():
    """Count the calls of kernel D's, E's, F's, G's, H's, I's and J's plain
    versions on a card tensor made through their dispatchers
    (``models.smoother.tvl1_smooth``, ``ops.linalg.regularized_pinv_sym4``,
    ``ops.accum.accum_scan``, ``ops.gray.bgr_to_gray``,
    ``ops.pyr_down.pyr_down``, ``ops.keyframe.keyframe_level``,
    ``ops.prelude.level_prelude``, either selection: every path's). Phases
    E, G, I and SEL call the plain versions kept in ``PLAIN``, which are not
    counted (phase D calls ``ops.tvl1``'s own)."""
    from video_stabilizer_tpu_torch.models import smoother
    from video_stabilizer_tpu_torch.ops import (
        accum, gray, keyframe, linalg, prelude)
    # ``ops.pyr_down`` is the function (ops/__init__ exports it): the
    # module comes from sys.modules.
    pyr = sys.modules["video_stabilizer_tpu_torch.ops.pyr_down"]
    for name, module, attr in (
            (TVL1_NAME, smoother, "tvl1_smooth_plain"),
            (PINV_NAME, linalg, "regularized_pinv_sym4_plain"),
            (ACCUM_NAME, accum, "accum_scan_plain"),
            (GRAY_NAME, gray, "bgr_to_gray_plain"),
            (PYR_NAME, pyr, "pyr_down_plain"),
            (KEY_NAME, keyframe, "keyframe_level_plain"),
            (SEL_NAME, prelude, "level_prelude_plain")):
        plain = PLAIN.setdefault(name, getattr(module, attr))

        def counted(x, *args, _plain=plain, _name=name, **kw):
            # Kernel J's plain version takes (spec, key, ...).
            on = args[0].windows if _name == SEL_NAME else x
            if on.device.type != "cpu":
                PLAIN_ON_CARD[_name] += 1
            return _plain(x, *args, **kw)
        setattr(module, attr, counted)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up, between CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds of one ``fn()`` with the host's launch
    overhead out of the way: ``reps`` calls captured once in a CUDA graph
    (after one warm-up call outside it), one replay timed between CUDA
    events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# Synthetic streams
# --------------------------------------------------------------------------

# bench.py's content for the main path: translation only, 1 px jitter.
MAIN_CONTENT = dict(jitter_px=1.0, pan_px_per_frame=0.3)
# Kernel B's items come from content with rotation and zoom as well, so
# that A and B are far above the bar they are held to.
GN_CONTENT = dict(jitter_px=1.0, pan_px_per_frame=0.3, rot_jitter=0.002,
                  zoom_jitter=0.001)
# The generator's default jitter, where the GN loop's capture range ends.
WIDE_CONTENT = dict(jitter_px=4.0, pan_px_per_frame=0.5)


def synth_streams(dev, num_frames, content, height=None, width=None,
                  seeds=None):
    """(S, T, H, W, 3) u8 host frames and (S, T, 4) window poses from
    ``utils.io.synth_shaky_clip`` (1080p unless given), one seed per stream
    (SEED + s for the 1080p streams unless given), with its crops computed
    on the card."""
    from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip

    height, width = height or HEIGHT, width or WIDTH
    seeds = seeds or [SEED + s for s in range(STREAMS)]
    frames = np.empty((len(seeds), num_frames, height, width, 3), np.uint8)
    poses = np.empty((len(seeds), num_frames, 4))
    for s, seed in enumerate(seeds):
        frames[s], poses[s] = synth_shaky_clip(
            num_frames, height, width, seed=seed, device=dev, poses=True,
            **content)
    return frames, poses


def known_motion_error(shift, ok, poses):
    """RMS and max px of the measured (S, T, 2) translation of a
    translation-only clip against its known motion: from frame t-1 to t,
    minus the window offset step."""
    truth = -np.diff(poses[..., 2:], axis=1)
    err = (shift[:, 1:] - truth)[ok[:, 1:]]
    return float(np.sqrt(np.mean(err ** 2))), float(np.abs(err).max())


def reset_launch_counts():
    from video_stabilizer_tpu_torch.ops import warp_kernel
    from video_stabilizer_tpu_torch.ops.accum import accum_scan_kernel
    from video_stabilizer_tpu_torch.ops.gn8_solve import gn8_solve
    from video_stabilizer_tpu_torch.ops.gn_solve import gn_solve
    from video_stabilizer_tpu_torch.ops.gray import bgr_to_gray_kernel
    from video_stabilizer_tpu_torch.ops.keyframe import keyframe_levels_kernel
    from video_stabilizer_tpu_torch.ops.linalg import (
        regularized_pinv_sym4_kernel)
    from video_stabilizer_tpu_torch.ops.prelude import level_prelude_kernel
    from video_stabilizer_tpu_torch.ops.pyr_down import pyr_down_kernel
    from video_stabilizer_tpu_torch.ops.tvl1 import tvl1_smooth_kernel
    warp_kernel.reset_launches()
    for fn in (gn_solve, gn8_solve, tvl1_smooth_kernel,
               regularized_pinv_sym4_kernel, accum_scan_kernel,
               bgr_to_gray_kernel, pyr_down_kernel, keyframe_levels_kernel,
               level_prelude_kernel):
        fn.launches = 0


def launch_counts() -> dict:
    """Launches since the last reset, per kernel and form."""
    from video_stabilizer_tpu_torch.ops.accum import accum_scan_kernel
    from video_stabilizer_tpu_torch.ops.gn8_solve import gn8_solve
    from video_stabilizer_tpu_torch.ops.gn_solve import gn_solve
    from video_stabilizer_tpu_torch.ops.gray import bgr_to_gray_kernel
    from video_stabilizer_tpu_torch.ops.keyframe import keyframe_levels_kernel
    from video_stabilizer_tpu_torch.ops.linalg import (
        regularized_pinv_sym4_kernel)
    from video_stabilizer_tpu_torch.ops.prelude import level_prelude_kernel
    from video_stabilizer_tpu_torch.ops.pyr_down import pyr_down_kernel
    from video_stabilizer_tpu_torch.ops.tvl1 import tvl1_smooth_kernel
    from video_stabilizer_tpu_torch.ops.warp_kernel import warp_frames
    counts = {f"warp_frames[{m},{i}]": n
              for (m, i), n in warp_frames.form_launches.items()}
    counts.update({"gn_solve": gn_solve.launches,
                   "gn8_solve": gn8_solve.launches,
                   TVL1_NAME: tvl1_smooth_kernel.launches,
                   PINV_NAME: regularized_pinv_sym4_kernel.launches,
                   ACCUM_NAME: accum_scan_kernel.launches,
                   GRAY_NAME: bgr_to_gray_kernel.launches,
                   PYR_NAME: pyr_down_kernel.launches,
                   KEY_NAME: keyframe_levels_kernel.launches,
                   SEL_NAME: level_prelude_kernel.launches})
    return counts


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

@phase("build")
def build_kernels():
    from video_stabilizer_tpu_torch.ops import cuda_build, gn8_solve, gn_solve
    # Kernel A: 2 models x 2 interps x 1-4 channels; B and C: one instance
    # per block size; D: the wavefront and the any-length one; E: n = 4
    # and 8; F: P = 4 and 8; G: one; H: its narrow and wide engines; I:
    # one for both models; J: R = 4 and 8, each in the histogram and the
    # exact-count mode.
    instances = dict(warp=16, gn_solve=len(gn_solve.THREADS),
                     gn8_solve=len(gn8_solve.THREADS), tvl1=2, jacobi=2,
                     accum=2, gray=1, pyr_down=2, keyframe=1, prelude=4)
    reports = cuda_build.build()
    for name, text in reports.items():
        for line in text.splitlines():
            if any(k in line for k in ("Function properties", "registers",
                                       "spill", "error")):
                log(f"  {name}: {line.strip()}")
        # Every kernel instance's arrays must live in registers: no spills,
        # and no stack but the math library's (STACK_BYTES).
        want = instances.get(name)
        if want is not None:
            stack = STACK_BYTES.get(name, 0)
            stacks = [ln.strip() for ln in text.splitlines()
                      if "bytes stack frame" in ln]
            clean = [ln for ln in stacks if ln == f"{stack} bytes stack "
                     "frame, 0 bytes spill stores, 0 bytes spill loads"]
            check(len(stacks) == want and len(clean) == want,
                  f"{name}.cu: {len(clean)} of {len(stacks)} kernel "
                  f"instances (of {want}) with a {stack}-byte stack frame "
                  "and no spills")
    for name in cuda_build.SOURCES:
        check(cuda_build.library_path(name).exists(), f"built {name}.cu")
    return True


@phase("synthetic clips: generated on the card as on the CPU")
def synth_on_card(dev):
    from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip

    for content in (MAIN_CONTENT, GN_CONTENT):
        clips = [synth_shaky_clip(6, 96, 128, seed=SEED, device=d,
                                  poses=True, **content)
                 for d in (dev, "cpu")]
        check(all(np.array_equal(a, b) for a, b in zip(*clips)),
              f"{content}: frames and poses equal")


@phase("capture a real chunk's kernel inputs (content with rotation and "
       "zoom)")
def capture(params, dev):
    from video_stabilizer_tpu_torch import transforms as T
    from video_stabilizer_tpu_torch.models import aligner, chunked
    from video_stabilizer_tpu_torch.ops import prelude
    from video_stabilizer_tpu_torch.ops.gn_solve import gn_solve

    frames, _ = synth_streams(dev, 2 * CHUNK, GN_CONTENT)
    states = chunked.init_stream_state(WIDTH, HEIGHT, params, 3, STREAMS, dev)
    states = chunked.stabilize_chunk_streams(states, frames[:, :CHUNK],
                                             params)[0]
    chunk1 = torch.as_tensor(frames[:, CHUNK:2 * CHUNK]).to(dev)
    with mock.patch.object(aligner, "gn_solve", wraps=gn_solve) as spy, \
            mock.patch.object(chunked, "tvl1_smooth",
                              wraps=chunked.tvl1_smooth) as smooth, \
            mock.patch.object(aligner, "regularized_pinv_sym4",
                              wraps=aligner.regularized_pinv_sym4) as pinv, \
            mock.patch.object(chunked, "accum_scan",
                              wraps=chunked.accum_scan) as scan, \
            mock.patch.object(prelude, "level_prelude",
                              wraps=prelude.level_prelude) as sel:
        _, delayed, accums, *_ = chunked.stabilize_chunk_core(
            states, chunk1, params, WIDTH, HEIGHT)
    t_ul = T.center_to_ul(accums, WIDTH, HEIGHT, minus_one=True)
    torch.cuda.synchronize()
    return dict(warp_frames=delayed.batch().flatten(0, 1),
                warp_segments=delayed,
                warp_ts=t_ul.reshape(-1, 4).contiguous(),
                gn_calls=[(c.args, c.kwargs) for c in spy.call_args_list],
                tvl1_calls=[(c.args, c.kwargs)
                            for c in smooth.call_args_list],
                pinv_calls=[c.args[0] for c in pinv.call_args_list],
                accum_calls=[(c.args, c.kwargs)
                             for c in scan.call_args_list],
                sel_calls=[c.args for c in sel.call_args_list],
                levels=len(aligner.level_specs(WIDTH, HEIGHT,
                                               params.aligner)))


def warp_compare(frames, ts, crop, interp="bilinear", model="similarity",
                 group=16, got=None):
    """(max |diff| LSB, share of pixels equal) between kernel A's output on
    (B, H, W, C) ``frames`` (``got``, else its contiguous form's) and its
    plain version on the card, the plain version ``group`` frames at a
    time."""
    from video_stabilizer_tpu_torch.ops.warp_kernel import (
        warp_frames, warp_frames_plain)
    form = dict(interp=interp, model=model)
    if got is None:
        got = warp_frames(frames, ts, crop, **form)
    max_err, n_equal = 0, 0
    for i in range(0, frames.shape[0], group):
        want = warp_frames_plain(frames[i:i + group], ts[i:i + group], crop,
                                 **form)
        diff = (got[i:i + group].to(torch.int16) - want.to(torch.int16)).abs()
        max_err = max(max_err, int(diff.max()))
        n_equal += int((diff == 0).sum())
    return max_err, n_equal / got.numel()


def segment_compare(segs, ts, crop, group=16, **form):
    """(output, max |diff| LSB, share of pixels equal) of kernel A's
    segment form on the card against its plain version on the same frames
    copied into one batch."""
    from video_stabilizer_tpu_torch.ops.warp_kernel import (
        warp_frame_segments)
    got = warp_frame_segments(*segs, ts, crop, **form)
    return (got, *warp_compare(segs.batch().flatten(0, 1), ts, crop,
                               group=group, got=got, **form))


def check_segments(cap, crop, group, short=True, **form):
    """Kernel A's segment form on a captured chunk's delayed frames, where
    they lie (the carried tail and the chunk), held bit for bit to its
    plain version and to the contiguous form's output; with ``short`` also
    a chunk of 4 < lag frames (the tail alone) and the clip's strided
    segment (the first tc frames of the joined [tail | chunk] clip). Then
    the device time of the segment form beside the contiguous form's.
    Returns (max |diff|, segment ms, its device ms, contiguous ms)."""
    from video_stabilizer_tpu_torch.ops.warp_kernel import (
        FrameSegments, warp_frame_segments, warp_frames)

    segs, ts, frames = cap["warp_segments"], cap["warp_ts"], cap[
        "warp_frames"]
    streams, lag = segs.seg0.shape[:2]
    tc = segs.n_out
    contiguous = warp_frames(frames, ts, crop, **form)
    cases = {f"the chunk as segments ({streams} streams, a tail of {lag}, "
             f"a chunk of {tc})": (segs, ts, contiguous)}
    clip = far = None
    if short:
        short_ts = ts.view(streams, tc, -1)[:, :4].flatten(0, 1).contiguous()
        clip = torch.cat([segs.seg0, segs.seg1], dim=1)
        cases[f"a chunk of 4 < lag {lag} (the tail alone)"] = (
            FrameSegments(segs.seg0, segs.seg1[:, :4], 4), short_ts, None)
        cases[f"the clip's strided segment (the first {tc} of "
              f"{lag + tc})"] = (FrameSegments(clip, None, tc), ts,
                                 contiguous)
        # Two streams of one frame 2^32 + 3 bytes apart: 64-bit offsets.
        step = 2 ** 32 + 3
        far = torch.empty(step + frames[0].numel(), dtype=torch.uint8,
                          device=frames.device).as_strided(
            (2, 1) + tuple(frames.shape[1:]),
            (step, frames[0].numel()) + frames[0].stride())
        far.copy_(frames[:2, None])
        cases["two frames 2^32 + 3 bytes apart"] = (
            FrameSegments(far, None, 1), ts[:2].contiguous(), None)
    worst = 0
    for name, (sg, t, same_as) in cases.items():
        got, max_err, equal = segment_compare(sg, t, crop, group, **form)
        same = same_as is None or torch.equal(got, same_as)
        check(max_err == 0 and equal == 1.0 and same,
              f"segment form, {name}: max |diff| {max_err} LSB, "
              f"{equal * 100:.4f} % equal"
              + ("" if same_as is None else
                 f"; equal to the contiguous form's output: {same}"))
        worst = max(worst, max_err)
        del got
    del contiguous, cases, far

    def seg():
        return warp_frame_segments(*segs, ts, crop, **form)

    def cont():
        return warp_frames(frames, ts, crop, **form)
    seg_ms, seg_dev = cuda_ms(seg, 10), graph_ms(seg, 10)
    cont_ms, cont_dev = cuda_ms(cont, 10), graph_ms(cont, 10)
    line = (f"  segment form {seg_ms:.3f} ms (device {seg_dev:.3f} ms), "
            f"contiguous form {cont_ms:.3f} ms (device {cont_dev:.3f} ms)")
    if clip is not None:
        clip_dev = graph_ms(lambda: warp_frame_segments(clip, None, tc, ts,
                                                        crop, **form), 10)
        line += f", the clip's strided segment device {clip_dev:.3f} ms"
    log(line)
    return worst, seg_ms, seg_dev, cont_ms


RAGGED = (3, 437, 1033)   # frames, rows, columns: partial tiles both ways
RAGGED_CROP = 5


def warp_ragged(dev, model):
    """Kernel A's two forms of ``model`` against the plain version on 3
    frames of 437x1033 (partial 216x512 tiles in both axes, crop 5) at 1, 3
    and 4 channels, with bulk shifts near the +-192 clip of the tile base
    and |A|,|B| (p0, p1, p3, p4) up to 0.008, p6, p7 up to 4e-3. Bar: max
    1 LSB, >= 99.9 % equal. Returns the largest |diff|."""
    n, h, w = RAGGED
    g = torch.Generator().manual_seed(SEED + 3)
    lin = (torch.rand((n, 4), generator=g) * 2 - 1) * 0.008
    sign = torch.where(torch.rand((n, 2), generator=g) < 0.5, -1.0, 1.0)
    shift = sign * (185 + torch.rand((n, 2), generator=g) * 10)
    if model == "similarity":
        ts = torch.cat([lin[:, :2], shift], 1)
    else:
        persp = (torch.rand((n, 2), generator=g) * 2 - 1) * 4e-3
        ts = torch.stack([lin[:, 0], lin[:, 1], shift[:, 0] / w, lin[:, 2],
                          lin[:, 3], shift[:, 1] / w, persp[:, 0],
                          persp[:, 1]], 1)
    ts = ts.to(dev)
    worst = 0
    for c in (1, 3, 4):
        frames = torch.randint(0, 256, (n, h, w, c), generator=g,
                               dtype=torch.uint8).to(dev)
        for interp in ("bilinear", "lanczos2"):
            max_err, equal = warp_compare(frames, ts, RAGGED_CROP,
                                          interp=interp, model=model)
            check(max_err <= 1 and equal >= 0.999,
                  f"ragged {n}x{h}x{w}x{c}, {model} + {interp}, crop "
                  f"{RAGGED_CROP}, shifts near +-192: max |diff| {max_err} "
                  f"LSB, {equal * 100:.4f} % equal")
            worst = max(worst, max_err)
    return worst


def warp_bound(frames, ts, crop, interp, model):
    """(bound ms, what bounds it, GB, GFLOP) of one warp launch: each frame
    read once, each output written once, against OPS_PER_PIXEL."""
    from video_stabilizer_tpu_torch.ops.warp_kernel import OPS_PER_PIXEL
    bsz, h, w, c = frames.shape
    n_out = bsz * (h - 2 * crop) * (w - 2 * crop)
    bytes_moved = frames.numel() + n_out * c + ts.numel() * 4
    ops = n_out * OPS_PER_PIXEL(c, interp, model)
    bound_ms, bound_by = roofline(bytes_moved, ops)
    return bound_ms, bound_by, bytes_moved / 1e9, ops / 1e9


def grid_sample_ms(frames, ts, crop, reps):
    """Yardstick of kernel A's similarity + bilinear form: one library call
    computing the same bilinear, zero-border warp on the same (B, H, W, C)
    frames, float NCHW in and out, timed between CUDA events."""
    _, height, width, _ = frames.shape
    dev = frames.device
    ho, wo = height - 2 * crop, width - 2 * crop
    src = frames.permute(0, 3, 1, 2).float()
    ys, xs = torch.meshgrid(
        torch.arange(crop, crop + ho, device=dev, dtype=torch.float32),
        torch.arange(crop, crop + wo, device=dev, dtype=torch.float32),
        indexing="ij")
    a, b, tx, ty = (ts[:, k, None, None] for k in range(4))
    sx = (1.0 + a) * xs - b * ys + tx
    sy = b * xs + (1.0 + a) * ys + ty
    grid = torch.stack([sx / (width - 1) * 2 - 1, sy / (height - 1) * 2 - 1],
                       dim=-1)
    return cuda_ms(lambda: torch.nn.functional.grid_sample(
        src, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True), reps)


@phase("kernel A: output warp vs its plain version (1080p, similarity)")
def check_warp(cap, crop, dev):
    from video_stabilizer_tpu_torch.ops.warp_kernel import warp_frames_plain

    frames, ts = cap["warp_frames"], cap["warp_ts"]
    bsz = frames.shape[0]
    max_err, equal = warp_compare(frames, ts, crop)
    check(max_err <= 1 and equal >= 0.999,
          f"main-path inputs ({bsz} frames, crop {crop}): max |diff| "
          f"{max_err} LSB, {equal * 100:.4f} % equal")
    g = torch.Generator().manual_seed(SEED)
    rnd = torch.cat([(torch.rand((16, 2), generator=g) * 2 - 1) * 0.008,
                     (torch.rand((16, 2), generator=g) * 2 - 1) * 40], 1)
    rnd = rnd.to(dev)
    max_rnd, equal_rnd = warp_compare(frames[:16].contiguous(), rnd, 0)
    check(max_rnd <= 1 and equal_rnd >= 0.999,
          f"random similarity (16 frames, |A|,|B| <= 0.008, |t| <= 40 px): "
          f"max |diff| {max_rnd} LSB, {equal_rnd * 100:.4f} % equal")
    max_l, equal_l = warp_compare(frames[:4].contiguous(), rnd[:4], crop,
                                  interp="lanczos2")
    check(max_l <= 1 and equal_l >= 0.999,
          f"similarity + Lanczos2 (4 frames, random similarity): max |diff| "
          f"{max_l} LSB, {equal_l * 100:.4f} % equal")
    max_ragged = warp_ragged(dev, "similarity")
    max_seg, ms, device_ms, cont_ms = check_segments(cap, crop, 16)

    def plain():
        for i in range(0, bsz, 16):
            warp_frames_plain(frames[i:i + 16], ts[i:i + 16], crop)
    plain_ms = cuda_ms(plain, 2)

    library_ms = grid_sample_ms(frames, ts, crop, 5)
    bound_ms, bound_by, gb, gflop = warp_bound(frames, ts, crop, "bilinear",
                                               "similarity")
    log(f"  kernel (segment form) {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"grid_sample "
        f"{library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}: "
        f"{gb:.3f} GB, {gflop:.2f} GFLOP); kernel / grid_sample "
        f"{ms / library_ms:.2f}, kernel / bound {ms / bound_ms:.1f}")
    return dict(name="warp_frames[similarity,bilinear]", route="cuda",
                source="video_stabilizer_tpu_torch/csrc/warp.cu",
                replaces=WARP_REPLACES,
                max_abs_err=max(max_err, max_rnd, max_ragged, max_seg),
                ms=ms, device_ms=device_ms, contiguous_ms=cont_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def roofline(bytes_moved, ops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Kernel B against its plain version, on every item: converged equal, and
# the transforms within these bars. Both loops run the same f32 arithmetic
# and differ only in the order of the sum over keypoints; on the first runs
# (H100, PR 1) the gap was at most 7.7e-7 in A/B and 1.0e-4 px in TX/TY.
GN_AB_BAR, GN_T_BAR = 1e-5, 1e-3


def gn_bytes(args, t_out, iters):
    """Bytes kernel B or C must move for this run's data: the 4x4 window
    taps of both keypoint sets of every item at each of its iterations (at
    most a keyframe's whole windows), each other input of the items and of
    the keyframes in use read once (the item's float32 threshold
    included), each output written once. Both kernels take (windows,
    key_index, tmpl, jac_masked, hinv, two (K, 2, N) keypoint coordinates,
    ox, oy, initial transform) and a threshold per item."""
    windows, key_index, *per_item = args[:5]
    fx, fy, ox, oy, t_init = args[5:10]
    k, n, p, _ = windows.shape
    iters_per_key = torch.zeros(k, dtype=torch.float64,
                                device=iters.device).index_add_(
        0, key_index.long(), iters.double())
    taps = float(torch.clamp(iters_per_key * 2 * n * 16, max=p * p * n).sum())
    keys = int(torch.unique(key_index).numel())
    item_bytes = sum(a.numel() * a.element_size()
                     for a in (key_index, *per_item, t_init)) \
        + t_init.shape[0] * 4
    key_bytes = keys * (fx[0].numel() + fy[0].numel()) * 4
    out_bytes = t_out.shape[0] * (t_out.shape[1] + 3) * 4
    return taps + item_bytes + key_bytes + (ox.numel() + oy.numel()) * 4 \
        + out_bytes


def deterministic(fn) -> bool:
    """Whether two launches on the same inputs give bit-identical
    outputs."""
    first, second = fn(), fn()
    return all(torch.equal(a, b) for a, b in zip(first, second))


# max_iters of the fit of a GN kernel's time against its iterations.
FIT_ITERS = (1, 4, 16)


def iteration_fit(solve, args, kw):
    """(ms per iteration, fixed ms) of a GN kernel on these items: the
    least-squares line through its device times (``graph_ms``) at
    max_iters = 1, 4 and 16 with threshold 0, where no item converges and
    each runs max_iters iterations."""
    times = [graph_ms(lambda m=m: solve(*args, **dict(
        kw, threshold=0.0, max_iters=m)), 10) for m in FIT_ITERS]
    slope, fixed = np.polyfit(FIT_ITERS, times, 1)
    return float(slope), float(fixed)


def plan_sweep(module, solve_with_plan, args, kw) -> str:
    """The kernel's device time (``graph_ms``) at this level under every
    cluster size and block size it is built for: the measurement behind
    ``launch_plan``. Every plan must launch: a refused one raises."""
    from video_stabilizer_tpu_torch.ops.gn_solve import (
        CLUSTER_SIZES, make_plan)
    items, n = args[-1].shape[0], args[0].shape[1]
    out = []
    for cs in CLUSTER_SIZES:
        for threads in module.THREADS:
            plan = make_plan(items, n, cs, threads, module.CACHE_FLOATS)
            ms = graph_ms(lambda: solve_with_plan(plan, *args, **kw), 5)
            out.append(f"{cs}x{threads} {ms:.3f}")
    return ", ".join(out)


def describe_plan(plan) -> str:
    return (f"{plan.cluster} CTA{'s' if plan.cluster > 1 else ''} x "
            f"{plan.threads} threads per item, grid {plan.grid}, "
            f"{plan.cached} of {plan.slice} keypoints per CTA cached in "
            f"{plan.smem} B of shared memory")


def level_table(rows):
    """Print the per-level table of a GN kernel."""
    log("  level      P  N      items mean-it max-it ms/iter fixed ms "
        "kernel ms device ms bound ms plain ms plan (CTAs x threads, smem "
        "B)")
    for r in rows:
        log(f"  {r['level']:<10} {r['p']:<2} {r['n']:<6} {r['items']:<5} "
            f"{r['mean_it']:<7.2f} {r['max_it']:<6d} {r['per_it']:<7.4f} "
            f"{r['fixed']:<8.4f} {r['ms']:<9.4f} {r['device']:<9.4f} "
            f"{r['bound']:<8.4f} {r['plain']:<8.3f} {r['plan'].cluster} x "
            f"{r['plan'].threads}, {r['plan'].smem}")


@phase("kernel B: per-level GN solve vs its plain version")
def check_gn(cap):
    from video_stabilizer_tpu_torch.ops import gn_solve as module
    from video_stabilizer_tpu_torch.ops.gn_solve import (
        OPS_PER_SAMPLE, gn_solve, gn_solve_plain, gn_solve_with_plan,
        launch_plan)

    calls = cap["gn_calls"]
    check(len(calls) == cap["levels"],
          f"{len(calls)} GN launches per chunk ({cap['levels']} levels)")
    totals = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0)
    bound_share = dict(bytes=0.0, operations=0.0)
    worst = 0.0
    rows = []
    for args, kw in calls:
        n, p = args[0].shape[1], args[0].shape[3]
        t_g, c_g, d_g, i_g = gn_solve(*args, **kw)
        t_w, c_w, d_w, i_w = gn_solve_plain(*args, **kw)
        level = f"{kw['width']}x{kw['height']} (P={p}, N={n}, " \
                f"{t_g.shape[0]} items)"
        d_ab = float((t_g[:, :2] - t_w[:, :2]).abs().max())
        d_t = float((t_g[:, 2:] - t_w[:, 2:]).abs().max())
        d_it = int((i_g - i_w).abs().max())
        same_conv = bool((c_g == c_w).all())
        worst = max(worst, d_ab, d_t)
        for i in torch.nonzero(c_g != c_w).flatten().tolist():
            log(f"    item {i}: converged {bool(c_g[i])} (kernel) vs "
                f"{bool(c_w[i])} (plain), iters {int(i_g[i])} vs "
                f"{int(i_w[i])}, disp01 {float(d_g[i]):.4f} vs "
                f"{float(d_w[i]):.4f} px")
        check(same_conv and d_ab <= GN_AB_BAR and d_t <= GN_T_BAR,
              f"{level}: converged equal on all items {same_conv}; over all "
              f"items |dA,dB| {d_ab:.2e} (bar {GN_AB_BAR:.0e}), |dTX,dTY| "
              f"{d_t:.2e} px (bar {GN_T_BAR:.0e}), |d iters| {d_it}; mean "
              f"iters {float(i_g.float().mean()):.2f}, converged "
              f"{float(c_g.float().mean()) * 100:.1f} %")
        # The bar must be small against what it compares.
        ab = t_w[:, :2].abs().amax(dim=1)
        check(float(ab.median()) >= 10 * GN_AB_BAR,
              f"{level}: the items' max(|A|,|B|) has median "
              f"{float(ab.median()):.2e} and max {float(ab.max()):.2e}, "
              f">= 10x the A/B bar")
        plan = launch_plan(t_g.shape[0], n)
        log(f"    plan: {describe_plan(plan)}")
        check(deterministic(lambda: gn_solve(*args, **kw)),
              f"{level}: two launches give bit-identical outputs")
        # The wrapper's time between CUDA events, host launch overhead
        # included, as earlier runs took it; and the kernel's device time.
        ms = cuda_ms(lambda: gn_solve(*args, **kw), 20)
        device_ms = graph_ms(lambda: gn_solve(*args, **kw), 20)
        plain_ms = cuda_ms(lambda: gn_solve_plain(*args, **kw), 2)
        per_it, fixed = iteration_fit(gn_solve, args, kw)
        bytes_moved = gn_bytes(args, t_g, i_g)
        # Operations: every item's own iteration count, both sets.
        ops = int(i_g.sum()) * 2 * n * OPS_PER_SAMPLE
        bound_ms, bound_by = roofline(bytes_moved, ops)
        bound_share[bound_by] += bound_ms
        log(f"    kernel {ms:.4f} ms (device {device_ms:.4f} ms), plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
            f"{bytes_moved / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP), kernel / "
            f"bound {ms / bound_ms:.1f}; threshold 0: {per_it:.4f} ms per "
            f"iteration + {fixed:.4f} ms")
        log("    plans (CTAs x threads ms): "
            + plan_sweep(module, gn_solve_with_plan, args, kw))
        rows.append(dict(level=f"{kw['width']}x{kw['height']}", p=p, n=n,
                         items=t_g.shape[0],
                         mean_it=float(i_g.float().mean()),
                         max_it=int(i_g.max()), per_it=per_it, fixed=fixed,
                         ms=ms, device=device_ms, bound=bound_ms,
                         plain=plain_ms, plan=plan))
        for k, v in (("ms", ms), ("device_ms", device_ms),
                     ("plain_ms", plain_ms), ("bound_ms", bound_ms)):
            totals[k] += v
    level_table(rows)
    log(f"  per chunk (sum of {len(calls)} levels): kernel "
        f"{totals['ms']:.4f} ms (device {totals['device_ms']:.4f} ms; "
        f"0.549-0.577 ms on an NVIDIA H100 80GB HBM3 at 700 W with the "
        f"threshold a launch argument, PERF.md section 6), plain "
        f"{totals['plain_ms']:.3f} ms, bound {totals['bound_ms']:.4f} ms")
    return dict(name="gn_solve", route="cuda",
                source="video_stabilizer_tpu_torch/csrc/gn_solve.cu",
                replaces=GN_REPLACES, max_abs_err=worst, ms=totals["ms"],
                device_ms=totals["device_ms"], plain_ms=totals["plain_ms"],
                bound_ms=totals["bound_ms"],
                bound_by=max(bound_share, key=bound_share.get),
                library_ms=None)


def gn_compare(args, kw, level, ab_check=True):
    """Kernel B against its plain version on one level's items, phase 5's
    bars: converged equal, A/B within GN_AB_BAR, TX/TY within GN_T_BAR px,
    two launches bit-identical, and (``ab_check``) the items' A/B median at
    least 10x the A/B bar. Returns (the kernel's outputs, the largest
    gap)."""
    from video_stabilizer_tpu_torch.ops.gn_solve import (
        gn_solve, gn_solve_plain)

    got = gn_solve(*args, **kw)
    want = gn_solve_plain(*args, **kw)
    (t_g, c_g, _, i_g), (t_w, c_w, _, i_w) = got, want
    d_ab = float((t_g[:, :2] - t_w[:, :2]).abs().max())
    d_t = float((t_g[:, 2:] - t_w[:, 2:]).abs().max())
    same_conv = bool((c_g == c_w).all())
    for i in torch.nonzero(c_g != c_w).flatten().tolist():
        log(f"    item {i}: converged {bool(c_g[i])} (kernel) vs "
            f"{bool(c_w[i])} (plain), iters {int(i_g[i])} vs {int(i_w[i])}")
    check(same_conv and d_ab <= GN_AB_BAR and d_t <= GN_T_BAR,
          f"{level}: converged equal on all items {same_conv}; |dA,dB| "
          f"{d_ab:.2e} (bar {GN_AB_BAR:.0e}), |dTX,dTY| {d_t:.2e} px (bar "
          f"{GN_T_BAR:.0e}), |d iters| {int((i_g - i_w).abs().max())}; mean "
          f"iters {float(i_g.float().mean()):.2f}, converged "
          f"{float(c_g.float().mean()) * 100:.1f} %")
    if ab_check:
        ab = t_w[:, :2].abs().amax(dim=1)
        check(float(ab.median()) >= 10 * GN_AB_BAR,
              f"{level}: the items' max(|A|,|B|) has median "
              f"{float(ab.median()):.2e} and max {float(ab.max()):.2e}, "
              f">= 10x the A/B bar")
    check(deterministic(lambda: gn_solve(*args, **kw)),
          f"{level}: two launches give bit-identical outputs")
    return got, max(d_ab, d_t)


# The counts of kernel B's fixed-iteration mode held to its plain version;
# the last is the streaming latency mode of S5 and the kernels line.
FIXED_KS = (1, 4)
FIXED_NAME = f"gn_solve[fixed {FIXED_KS[-1]}]"


@phase("kernel B in fixed-iteration mode vs its plain version (the six "
       "1080p levels, K = 1 and 4)")
def check_gn_fixed(cap):
    """Phase 5's items and bars with ``fixed_iters`` = K: converged (the
    last step moved no corner by the threshold) equal, iters == K on every
    item, A/B 1e-5, TX/TY 1e-3 px, two launches bit-identical; per level
    the wrapper's time between CUDA events and the device time (CUDA
    graph) at each K. Returns the kernels line's entry at the last K."""
    from video_stabilizer_tpu_torch.ops.gn_solve import (
        OPS_PER_SAMPLE, gn_solve, gn_solve_plain)

    calls = cap["gn_calls"]
    worst, entry = 0.0, None
    for k in FIXED_KS:
        totals = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0)
        bound_share = dict(bytes=0.0, operations=0.0)
        for args, kw in calls:
            kwf = dict(kw, fixed_iters=k)
            n, p = args[0].shape[1], args[0].shape[3]
            level = (f"K={k} {kw['width']}x{kw['height']} (P={p}, N={n}, "
                     f"{args[-1].shape[0]} items)")
            (t_g, _, _, i_g), gap = gn_compare(args, kwf, level,
                                               ab_check=False)
            worst = max(worst, gap)
            i_w = gn_solve_plain(*args, **kwf)[3]
            check(bool((i_g == k).all()) and bool((i_w == k).all()),
                  f"{level}: iters == {k} on every item, both engines")
            ms = cuda_ms(lambda: gn_solve(*args, **kwf), 20)
            device_ms = graph_ms(lambda: gn_solve(*args, **kwf), 20)
            plain_ms = cuda_ms(lambda: gn_solve_plain(*args, **kwf), 2)
            bytes_moved = gn_bytes(args, t_g, i_g)
            ops = int(i_g.sum()) * 2 * n * OPS_PER_SAMPLE
            bound_ms, bound_by = roofline(bytes_moved, ops)
            bound_share[bound_by] += bound_ms
            log(f"    kernel {ms:.4f} ms (device {device_ms:.4f} ms), plain "
                f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            for key, val in (("ms", ms), ("device_ms", device_ms),
                             ("plain_ms", plain_ms), ("bound_ms", bound_ms)):
                totals[key] += val
        log(f"  K={k}, per chunk (sum of {len(calls)} levels): kernel "
            f"{totals['ms']:.4f} ms (device {totals['device_ms']:.4f} ms), "
            f"plain {totals['plain_ms']:.3f} ms, bound "
            f"{totals['bound_ms']:.4f} ms")
        entry = dict(name=f"gn_solve[fixed {k}]", route="cuda",
                     source="video_stabilizer_tpu_torch/csrc/gn_solve.cu",
                     replaces=GN_REPLACES, ms=totals["ms"],
                     device_ms=totals["device_ms"],
                     plain_ms=totals["plain_ms"],
                     bound_ms=totals["bound_ms"],
                     bound_by=max(bound_share, key=bound_share.get),
                     library_ms=None)
    entry["max_abs_err"] = worst
    return entry


@phase("4K homography path: capture two chunks' kernel inputs, and align "
       "16 pairs with known perspective")
def capture_4k(params, dev):
    from video_stabilizer_tpu_torch.models import chunked
    from video_stabilizer_tpu_torch.models import homography_aligner as ha
    from video_stabilizer_tpu_torch.models.aligner import level_specs
    from video_stabilizer_tpu_torch.models.stabilizer import bgr_to_gray
    from video_stabilizer_tpu_torch.ops import prelude
    from video_stabilizer_tpu_torch.ops.gn8_solve import gn8_solve
    from video_stabilizer_tpu_torch.ops.pyr_down import build_pyramid
    from video_stabilizer_tpu_torch.ops.warp_kernel import warp_frames

    frames, _ = synth_streams(dev, 2 * CHUNK, GN_CONTENT, H4K, W4K,
                              SEEDS_4K)
    states = chunked.init_stream_state(W4K, H4K, params, 3, len(SEEDS_4K),
                                       dev, model=HOMOGRAPHY)
    states = chunked.stabilize_chunk_streams(states, frames[:, :CHUNK],
                                             params, HOMOGRAPHY)[0]
    chunk1 = torch.as_tensor(frames[:, CHUNK:]).to(dev)
    with mock.patch.object(ha, "gn8_solve", wraps=gn8_solve) as spy, \
            mock.patch.object(chunked, "tvl1_smooth",
                              wraps=chunked.tvl1_smooth) as smooth, \
            mock.patch.object(ha, "regularized_pinv_sym4",
                              wraps=ha.regularized_pinv_sym4) as pinv, \
            mock.patch.object(chunked, "accum_scan",
                              wraps=chunked.accum_scan) as scan, \
            mock.patch.object(prelude, "level_prelude",
                              wraps=prelude.level_prelude) as sel:
        _, delayed, accums, *_ = chunked.stabilize_chunk_core(
            states, chunk1, params, W4K, H4K, HOMOGRAPHY)
    calls = [(c.args, c.kwargs) for c in spy.call_args_list]
    sel_calls = [c.args for c in sel.call_args_list]
    tvl1_calls = [(c.args, c.kwargs) for c in smooth.call_args_list]
    pinv_calls = [c.args[0] for c in pinv.call_args_list]
    accum_calls = [(c.args, c.kwargs) for c in scan.call_args_list]

    # Pairs with perspective: each template is a frame of the clip warped
    # by a known homography through kernel A, so the aligner must find
    # p6, p7 far from 0 at every level.
    g = torch.Generator().manual_seed(SEED + 1)
    n = 16
    p_true = (torch.rand((n, 8), generator=g) * 2 - 1) * torch.tensor(
        [2e-3, 2e-3, 3.0 / W4K, 2e-3, 2e-3, 3.0 / W4K, 4e-3, 4e-3])
    key = bgr_to_gray(chunk1.reshape((-1, H4K, W4K, 3))[:n])
    tmpl = warp_frames(key[..., None].contiguous(), p_true.to(dev), 0,
                       interp="lanczos2", model=HOMOGRAPHY)[..., 0]
    specs = level_specs(W4K, H4K, params.aligner)
    key_pyr = build_pyramid(key, len(specs))
    tmpl_pyr = build_pyramid(tmpl, len(specs))
    idx = torch.arange(n, device=dev)
    with mock.patch.object(ha, "gn8_solve", wraps=gn8_solve) as spy:
        p_found, failed = ha.align_all_levels_h(
            tmpl_pyr, idx, ha._compute_keyframe_h(key_pyr, specs), idx, specs,
            params.aligner, torch.zeros((n, 8), device=dev))
    persp = [(c.args, c.kwargs) for c in spy.call_args_list]
    err = (p_found.cpu() - p_true).abs().amax(dim=0)
    log(f"  perspective pairs: {int(failed.sum())} of {n} failed; found p "
        f"within {[float(f'{e:.1e}') for e in err]} of the true p")
    torch.cuda.synchronize()
    return dict(warp_frames=delayed.batch().flatten(0, 1),
                warp_segments=delayed,
                warp_ts=accums.reshape(-1, 8).contiguous(), gn8_calls=calls,
                persp_calls=persp, tvl1_calls=tvl1_calls,
                pinv_calls=pinv_calls, accum_calls=accum_calls,
                sel_calls=sel_calls, levels=len(specs))


@phase("kernel A: output warp vs its plain version (4K, homography)")
def check_warp_4k(cap, crop, dev):
    from video_stabilizer_tpu_torch.ops.warp_kernel import warp_frames_plain

    form = dict(interp="lanczos2", model=HOMOGRAPHY)
    frames, ts = cap["warp_frames"], cap["warp_ts"]
    bsz = frames.shape[0]
    max_err, equal = warp_compare(frames, ts, crop, group=4, **form)
    check(max_err <= 1 and equal >= 0.999,
          f"4K path's inputs ({bsz} frames, real corrections, crop {crop}): "
          f"max |diff| {max_err} LSB, {equal * 100:.4f} % equal")
    g = torch.Generator().manual_seed(SEED + 2)
    rnd = (torch.rand((8, 8), generator=g) * 2 - 1) * 4e-3
    rnd[:, [2, 5]] = (torch.rand((8, 2), generator=g) * 2 - 1) * 40 / W4K
    rnd = rnd.to(dev)
    sub = frames[:8].contiguous()
    max_rnd, equal_rnd = warp_compare(sub, rnd, 0, group=4, **form)
    check(max_rnd <= 1 and equal_rnd >= 0.999,
          f"random homographies (8 frames, |p0,p1,p3,p4|, |p6,p7| <= 4e-3, "
          f"|t| <= 40 px): max |diff| {max_rnd} LSB, "
          f"{equal_rnd * 100:.4f} % equal")
    max_b, equal_b = warp_compare(sub[:4], rnd[:4], crop, group=4,
                                  interp="bilinear", model=HOMOGRAPHY)
    check(max_b <= 1 and equal_b >= 0.999,
          f"homography + bilinear (4 frames): max |diff| {max_b} LSB, "
          f"{equal_b * 100:.4f} % equal")
    del sub
    max_ragged = warp_ragged(dev, HOMOGRAPHY)
    max_seg, ms, device_ms, cont_ms = check_segments(cap, crop, 4,
                                                     short=False, **form)

    def plain():
        for i in range(0, bsz, 4):
            warp_frames_plain(frames[i:i + 4], ts[i:i + 4], crop, **form)
    plain_ms = cuda_ms(plain, 1)
    bound_ms, bound_by, gb, gflop = warp_bound(frames, ts, crop, **form)
    log(f"  kernel (segment form) {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.3f} ms ({bound_by}: {gb:.3f} GB, {gflop:.1f} "
        "GFLOP), "
        f"kernel / bound {ms / bound_ms:.1f}; no library call: grid_sample "
        "has no Lanczos2")
    return dict(name="warp_frames[homography,lanczos2]", route="cuda",
                source="video_stabilizer_tpu_torch/csrc/warp.cu",
                replaces=WARP_REPLACES,
                max_abs_err=max(max_err, max_rnd, max_ragged, max_seg),
                ms=ms, device_ms=device_ms, contiguous_ms=cont_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def corner_gap(p_a, p_b, width, height):
    """(B,) max distance between the level's GN corners ((w-1, h-1)
    extent) warped by two (B, 8) homographies, in px at that level."""
    from video_stabilizer_tpu_torch import homography as Hm
    from video_stabilizer_tpu_torch.ops.gn_solve import gn_corners
    corners = gn_corners(width, height, p_a.device)
    a = Hm.warp_points(p_a[:, None, :].double(), corners.double(), width,
                       height)
    b = Hm.warp_points(p_b[:, None, :].double(), corners.double(), width,
                       height)
    return torch.linalg.vector_norm(a - b, dim=-1).amax(dim=-1)


# Kernel C against its plain version, on every item: converged equal and
# the level's GN corners within this bar (px at the level's size). Both
# loops run the same f32 arithmetic and differ only in the order of the
# sums over keypoints and in the compose (1/M22 times each entry in the
# kernel, as _compose_h; a division in the plain version, as the XLA loop).
# The 8x8 Hessian of a small level is ill-conditioned along p6/p7, and its
# inverse carries those rounding differences into p: on an H100 (700 W)
# the gap reached 3.5e-3 px at 60x33 with equal iteration counts,
# and 1.8e-2 px on an L0 item whose loop stopped one iteration later. A
# loop stops when a step moves no corner by the 0.02 px threshold, so the
# two loops are held to that threshold; the share of items within 1e-3 px
# is reported beside it. The perspective items' p6/p7, at least 10x the
# largest p6/p7 gap, make sure the kernel updates p6 and p7 at all.
GN8_CORNER_BAR = 0.02


@phase("kernel C: per-level 8-DOF GN solve vs its plain version")
def check_gn8(cap):
    from video_stabilizer_tpu_torch.ops import gn8_solve as module
    from video_stabilizer_tpu_torch.ops.gn8_solve import (
        OPS_PER_SAMPLE, gn8_solve, gn8_solve_plain, gn8_solve_with_plan,
        launch_plan)

    calls, persp = cap["gn8_calls"], cap["persp_calls"]
    check(len(calls) == cap["levels"] == len(persp),
          f"{len(calls)} kernel C launches per chunk and {len(persp)} for "
          f"the perspective pairs ({cap['levels']} levels)")
    totals = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0)
    bound_share = dict(bytes=0.0, operations=0.0)
    worst = 0.0
    rows = []
    for (args, kw), (pargs, pkw) in zip(calls, persp):
        w, h = kw["width"], kw["height"]
        n, p_size = args[0].shape[1], args[0].shape[3]
        level = f"{w}x{h} (P={p_size}, N={n})"
        gaps, conv_equal, p67_gap, medians = [], True, 0.0, None
        n_items, n_fine, same_iter_gap = 0, 0, 0.0
        for name, (a, k) in (("captured", (args, kw)),
                             ("perspective", (pargs, pkw))):
            p_g, c_g, d_g, i_g = gn8_solve(*a, **k)
            p_w, c_w, d_w, i_w = gn8_solve_plain(*a, **k)
            check(deterministic(lambda: gn8_solve(*a, **k)),
                  f"{level} {name}: two launches give bit-identical outputs")
            same = bool((c_g == c_w).all())
            conv_equal &= same
            item_gap = corner_gap(p_g, p_w, w, h)
            gap = float(item_gap.max())
            gaps.append(gap)
            n_items += item_gap.numel()
            n_fine += int((item_gap <= 1e-3).sum())
            same = i_g == i_w
            if bool(same.any()):
                same_iter_gap = max(same_iter_gap,
                                    float(item_gap[same].max()))
            p67_gap = max(p67_gap, float((p_g[:, 6:] - p_w[:, 6:]).abs().max()))
            for i in torch.nonzero(c_g != c_w).flatten().tolist():
                log(f"    {name} item {i}: converged {bool(c_g[i])} "
                    f"(kernel) vs {bool(c_w[i])} (plain), iters "
                    f"{int(i_g[i])} vs {int(i_w[i])}")
            log(f"    {level} {name}, {p_g.shape[0]} items: converged "
                f"{float(c_g.float().mean()) * 100:.1f} %, mean iters "
                f"{float(i_g.float().mean()):.2f}, corner gap {gap:.2e} px, "
                f"|d iters| {int((i_g - i_w).abs().max())}")
            if name == "perspective":
                medians = float(p_w[:, 6:].abs().amax(dim=1).median())
        worst = max(worst, *gaps)
        check(conv_equal and max(gaps) <= GN8_CORNER_BAR,
              f"{level}: converged equal on all items {conv_equal}; corner "
              f"gap {max(gaps):.2e} px (bar {GN8_CORNER_BAR:.0e}; "
              f"{same_iter_gap:.2e} px where the iterations are equal; "
              f"{n_fine} of {n_items} items within 1e-3 px); p6/p7 gap "
              f"{p67_gap:.2e}")
        check(medians >= 10 * p67_gap,
              f"{level}: the perspective items' max(|p6|,|p7|) has median "
              f"{medians:.2e}, >= 10x the largest p6/p7 gap {p67_gap:.2e}")
        p_out, _, _, iters = gn8_solve(*args, **kw)
        plan = launch_plan(p_out.shape[0], n)
        log(f"    plan: {describe_plan(plan)}")
        ms = cuda_ms(lambda: gn8_solve(*args, **kw), 10)
        device_ms = graph_ms(lambda: gn8_solve(*args, **kw), 20)
        plain_ms = cuda_ms(lambda: gn8_solve_plain(*args, **kw), 1)
        per_it, fixed = iteration_fit(gn8_solve, args, kw)
        bytes_moved = gn_bytes(args, p_out, iters)
        ops = int(iters.sum()) * 2 * n * OPS_PER_SAMPLE
        bound_ms, bound_by = roofline(bytes_moved, ops)
        bound_share[bound_by] += bound_ms
        log(f"    kernel {ms:.4f} ms (device {device_ms:.4f} ms), plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
            f"{bytes_moved / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP), kernel / "
            f"bound {ms / bound_ms:.1f}; mean iters "
            f"{float(iters.float().mean()):.2f}; threshold 0: {per_it:.4f} "
            f"ms per iteration + {fixed:.4f} ms")
        log("    plans (CTAs x threads ms): "
            + plan_sweep(module, gn8_solve_with_plan, args, kw))
        rows.append(dict(level=f"{w}x{h}", p=p_size, n=n,
                         items=p_out.shape[0],
                         mean_it=float(iters.float().mean()),
                         max_it=int(iters.max()), per_it=per_it, fixed=fixed,
                         ms=ms, device=device_ms, bound=bound_ms,
                         plain=plain_ms, plan=plan))
        for key, val in (("ms", ms), ("device_ms", device_ms),
                         ("plain_ms", plain_ms), ("bound_ms", bound_ms)):
            totals[key] += val
    level_table(rows)
    log(f"  per chunk (sum of {len(calls)} levels): kernel "
        f"{totals['ms']:.4f} ms (device {totals['device_ms']:.4f} ms), "
        f"plain {totals['plain_ms']:.3f} ms, bound "
        f"{totals['bound_ms']:.4f} ms")
    return dict(name="gn8_solve", route="cuda",
                source="video_stabilizer_tpu_torch/csrc/gn8_solve.cu",
                replaces=GN8_REPLACES, max_abs_err=worst, ms=totals["ms"],
                device_ms=totals["device_ms"], plain_ms=totals["plain_ms"],
                bound_ms=totals["bound_ms"],
                bound_by=max(bound_share, key=bound_share.get),
                library_ms=None)


# Per-frame homography of the moving perspective stream: random steps
# within these bounds (p0, p1, p3, p4; p2, p5 normalized by W; p6, p7),
# with |p6|, |p7| at least half their bound.
PERSP_STEP = (1e-3, 1e-3, 2.0 / W4K, 1e-3, 1e-3, 2.0 / W4K, 2e-3, 2e-3)


def perspective_stream(first, steps):
    """(T, H, W, 3) u8 frames on the card: ``first``, then each frame the
    previous one warped by the next (8,) homography of ``steps`` through
    kernel A's homography + Lanczos2 form (as capture_4k builds its
    pairs)."""
    from video_stabilizer_tpu_torch.ops.warp_kernel import warp_frames
    seq = [first]
    for p in steps:
        seq.append(warp_frames(seq[-1][None].contiguous(), p[None], 0,
                               interp="lanczos2", model=HOMOGRAPHY)[0])
    return torch.stack(seq)


@phase("4K content: kernel C on a moving perspective stream, kernel B at "
       "4K (similarity)")
def check_4k_content(params_4k, dev):
    """A 4K chunk of 2 streams x 16 frames through the 4K path (fresh
    state), stream 0 a moving perspective sequence (``perspective_stream``,
    p6/p7 != 0 in every step), stream 1 bench_configs' content with
    rotation and zoom: kernel C against its plain version at all 7 levels,
    phase 8's bars (converged equal, corner gap <= 0.02 px, the
    perspective items' median max(|p6|,|p7|) >= 10x the largest p6/p7
    gap, bit-identical launches). Then the same content (stream 0 its own
    seed's frames) through the 4K similarity path: kernel B against its
    plain version at its 7 levels, phase 5's bars."""
    from video_stabilizer_tpu_torch.config import StabilizerParams
    from video_stabilizer_tpu_torch.models import aligner, chunked
    from video_stabilizer_tpu_torch.models import homography_aligner as ha
    from video_stabilizer_tpu_torch.ops.gn8_solve import (
        gn8_solve, gn8_solve_plain)
    from video_stabilizer_tpu_torch.ops.gn_solve import gn_solve

    host, _ = synth_streams(dev, CHUNK, GN_CONTENT, H4K, W4K, SEEDS_4K)
    frames = torch.as_tensor(host).to(dev)
    g = torch.Generator().manual_seed(SEED + 4)
    bound = torch.tensor(PERSP_STEP)
    steps = (torch.rand((CHUNK - 1, 8), generator=g) * 2 - 1) * bound
    sign = torch.where(steps[:, 6:] < 0, -1.0, 1.0)
    steps[:, 6:] = sign * (0.5 + 0.5 * torch.rand((CHUNK - 1, 2),
                                                  generator=g)) * bound[6:]
    persp = frames.clone()
    persp[0] = perspective_stream(frames[0, 0], steps.to(dev))
    states = chunked.init_stream_state(W4K, H4K, params_4k, 3, 2, dev,
                                       model=HOMOGRAPHY)
    with mock.patch.object(ha, "gn8_solve", wraps=gn8_solve) as spy:
        chunked.stabilize_chunk_core(states, persp, params_4k, W4K, H4K,
                                     HOMOGRAPHY)
    calls = [(c.args, c.kwargs) for c in spy.call_args_list]
    del persp
    levels = len(aligner.level_specs(W4K, H4K, params_4k.aligner))
    check(len(calls) == levels,
          f"{len(calls)} kernel C launches ({levels} levels)")
    # Stream 0's items but its first (frame 0 against the zero keyframe).
    persp_items = torch.arange(1, CHUNK, device=dev)
    for args, kw in calls:
        w, h = kw["width"], kw["height"]
        level = f"4K content {w}x{h} (N={args[0].shape[1]})"
        p_g, c_g, _, i_g = gn8_solve(*args, **kw)
        p_w, c_w, _, i_w = gn8_solve_plain(*args, **kw)
        same = bool((c_g == c_w).all())
        gap = float(corner_gap(p_g, p_w, w, h).max())
        p67_gap = float((p_g[:, 6:] - p_w[:, 6:]).abs().max())
        median = float(p_w[persp_items, 6:].abs().amax(dim=1).median())
        check(same and gap <= GN8_CORNER_BAR,
              f"{level}: converged equal {same}; corner gap {gap:.2e} px "
              f"(bar {GN8_CORNER_BAR:.0e}); |d iters| "
              f"{int((i_g - i_w).abs().max())}; converged "
              f"{float(c_g.float().mean()) * 100:.1f} %")
        check(median >= 10 * p67_gap,
              f"{level}: the perspective stream's max(|p6|,|p7|) has median "
              f"{median:.2e}, >= 10x the largest p6/p7 gap {p67_gap:.2e}")
        check(deterministic(lambda: gn8_solve(*args, **kw)),
              f"{level}: two launches give bit-identical outputs")
    del calls

    params = StabilizerParams(crop_pixels=32)
    states = chunked.init_stream_state(W4K, H4K, params, 3, 2, dev)
    with mock.patch.object(aligner, "gn_solve", wraps=gn_solve) as spy:
        chunked.stabilize_chunk_core(states, frames, params, W4K, H4K)
    calls = [(c.args, c.kwargs) for c in spy.call_args_list]
    check(len(calls) == levels,
          f"{len(calls)} kernel B launches at 4K ({levels} levels)")
    for args, kw in calls:
        gn_compare(args, kw, f"4K similarity {kw['width']}x{kw['height']} "
                   f"(N={args[0].shape[1]}, {args[-1].shape[0]} items)")


def tvl1_call_args(call):
    """(data, lam, valid_len) of a recorded ``tvl1_smooth`` call, which
    must run TVL1_ITERS iterations."""
    import inspect

    from video_stabilizer_tpu_torch.ops.tvl1 import tvl1_smooth_plain
    args, kw = call
    bound = inspect.signature(tvl1_smooth_plain).bind(*args, **kw)
    bound.apply_defaults()
    if bound.arguments["iterations"] != TVL1_ITERS:
        raise ValueError(f"the path smooths with "
                         f"{bound.arguments['iterations']} iterations")
    return (bound.arguments["data"], bound.arguments["lam"],
            bound.arguments["valid_len"])


def tvl1_compare(data, lam, valid):
    """(bits equal, NaN positions equal, max |diff| where both are finite)
    of kernel D against its plain version on one call."""
    from video_stabilizer_tpu_torch.ops.tvl1 import (
        tvl1_smooth_kernel, tvl1_smooth_plain)
    got = tvl1_smooth_kernel(data, lam, TVL1_ITERS, valid)
    want = tvl1_smooth_plain(data, lam, TVL1_ITERS, valid)
    same = torch.equal(got.contiguous().view(torch.int32),
                       want.contiguous().view(torch.int32))
    nan_same = torch.equal(torch.isnan(got), torch.isnan(want))
    fin = torch.isfinite(got) & torch.isfinite(want)
    err = float((got - want).abs()[fin].max()) if bool(fin.any()) else 0.0
    return same, nan_same, err


def tvl1_depth(n: int, iterations: int) -> int:
    """Dependent steps of one row in kernel D: the wavefront's 2 x
    (iterations - 1) + N - 1 for N <= TVL1_LANES (one relaxation step
    when N is 1), the iterations x (N - 1) pair updates in order beyond."""
    if n <= TVL1_LANES:
        return 2 * (iterations - 1) + max(n - 1, 1)
    return iterations * (n - 1)


def tvl1_bound(data, lam, valid):
    """(roofline ms, what bounds it, dependence-depth ms, one step's ms,
    the row's own TVL1_ITERS iterations less none, rows, N) of one kernel D
    call. Roofline: each row, lam and valid_len read once, each output
    written once; the operations of the live pairs only. Dependence depth:
    ``tvl1_depth`` steps of one row times one step, measured: the call's
    row with the most live pairs (the first such) alone, its device time at
    11 x TVL1_ITERS iterations less that at TVL1_ITERS, over the steps
    between the two depths (the launch cost drops out)."""
    from video_stabilizer_tpu_torch.ops.tvl1 import (
        pack_rows, tvl1_smooth_kernel)
    rows_t, lam_r, valid_r = pack_rows(data, lam, valid)
    rows, n = rows_t.shape
    pairs = int((valid_r.clamp(max=n) - 1).clamp(min=0).sum())
    bytes_moved = 2 * rows * n * 4 + rows * 8
    ops = TVL1_ITERS * (rows * n * TVL1_OPS_PER_COLUMN
                        + pairs * TVL1_OPS_PER_PAIR)
    bound_ms, bound_by = roofline(bytes_moved, ops)
    k = int(valid_r.argmax())
    row, lam_k, valid_k = rows_t[k:k + 1], lam_r[k:k + 1], valid_r[k:k + 1]

    def one_row_ms(iters):
        return graph_ms(lambda: tvl1_smooth_kernel(row, lam_k, iters,
                                                   valid_k), 10)

    long, at_iters = 11 * TVL1_ITERS, one_row_ms(TVL1_ITERS)
    step_ms = ((one_row_ms(long) - at_iters)
               / (tvl1_depth(n, long) - tvl1_depth(n, TVL1_ITERS)))
    return (bound_ms, bound_by, tvl1_depth(n, TVL1_ITERS) * step_ms, step_ms,
            at_iters - one_row_ms(0), rows, n)


def tvl1_edge_calls(dev):
    """Phase D (e): rows of N = 1, 2, 23, and 64 and 400 (the working
    values in the output row), each call with lam 0.1 (a float32
    cannot hold it), valid_len 1, N and one per row, ties at mag == lam, a
    NaN, values of 1e-30 and 1e6."""
    g = torch.Generator().manual_seed(SEED + 7)
    calls = []
    for n in (1, 2, 23, 64, 400):
        x = torch.cumsum(torch.randn((8, n), generator=g), -1) * 3
        if n >= 2:
            x[0, :2] = torch.tensor([0.0, 0.1])    # |diff| == float32(0.1)
            x[4, :2] = torch.tensor([1.0, 5.0])    # |diff| == 4.0
        x[1, n // 2] = float("nan")
        x[2] = 1e-30 * torch.arange(n)
        x[3] = 1e6 * torch.randn(n, generator=g)
        x = x.to(dev)
        lams = torch.tensor([0.1, 0.5, 1.0, 4.0] * 2, device=dev)
        valid = torch.tensor([n, 1, n // 2 + 1, n, 4, n, 2, n],
                             device=dev)
        for lam, v in ((0.1, None), (0.1, 1), (4.0, n), (lams, valid)):
            per_row = isinstance(v, torch.Tensor)
            what = (f"N={n}, lam {'per row' if per_row else lam}, "
                    f"valid_len {'per row' if per_row else v}")
            calls.append((what, (x, lam, v)))
    return calls


@phase("kernel D: TV-L1 smoother vs its plain version (the chunks, the "
       "streaming window, eval_combos, edge rows)")
def check_tvl1(calls_1080p, calls_4k, params, dev):
    """See D in the module's docstring."""
    from video_stabilizer_tpu_torch.apps import grid_search_smoother as gss
    from video_stabilizer_tpu_torch.config import StabilizerParams
    from video_stabilizer_tpu_torch.models import batch
    from video_stabilizer_tpu_torch.ops.tvl1 import (
        tvl1_smooth_kernel, tvl1_smooth_plain)

    # Whether torch on the card takes a Python float lam as float32, as
    # JAX's jnp.asarray(lam, float32) does (on the CPU it does).
    m = torch.tensor([0.1], device=dev)
    gt, sub = bool(m > 0.1), float(m - 0.1)
    check(not gt and sub == 0.0,
          f"torch on the card: float32(0.1) > 0.1 is {gt}, float32(0.1) - "
          f"0.1 = {sub!r} (float32 arithmetic: False and 0.0)")

    check(len(calls_1080p) == 1 and len(calls_4k) == 1,
          f"one smoother call per chunk: {len(calls_1080p)} (1080p), "
          f"{len(calls_4k)} (4K)")
    chunk = tvl1_call_args(calls_1080p[0])
    chunk_4k = tvl1_call_args(calls_4k[0])
    # (c) the streaming window: a real window of the 1080p chunk (stream
    # 0, its last frame), the first ``count`` rows of the ring's stage
    # buffer filled, the rest 0, as L1SmootherCenter.update leaves it.
    window = chunk[0][0, -1].T                        # (win, 4)
    stream = []
    for count in range(1, window.shape[0] + 1):
        buf = torch.zeros_like(window)
        buf[:count] = window[:count]
        stream.append((buf.T, params.lambda_, count))
    # (d) eval_combos' rows: its 12 lambdas over 60 frames of measurements
    # (a seeded random walk), through smooth_trajectory.
    rng = np.random.default_rng(SEED + 5)
    meas = torch.from_numpy(np.stack(
        [rng.normal(0, 1e-3, 60), rng.normal(0, 1e-3, 60),
         rng.normal(0.3, 1.0, 60), rng.normal(0, 1.0, 60)], -1).astype(
        np.float32)).to(dev)
    combos = list(itertools.product(gss.LAMBDAS, gss.DECAYS))
    lams = torch.tensor([c[0] for c in combos], device=dev)
    with mock.patch.object(batch, "tvl1_smooth",
                           wraps=batch.tvl1_smooth) as spy:
        batch.smooth_trajectory(meas.expand((len(combos),) + meas.shape),
                                StabilizerParams(lag=10, smoother_memory=5),
                                lam=lams)
    combo = tvl1_call_args((spy.call_args.args, spy.call_args.kwargs))

    timed_calls = [("(a) 1080p chunk", chunk), ("(b) 4K chunk", chunk_4k),
                   ("(c) streaming window, count 16", stream[-1]),
                   ("(d) eval_combos, 12 lambdas", combo)]
    checked = (timed_calls[:2]
               + [(f"(c) streaming window, count {c[2]}", c) for c in stream]
               + timed_calls[3:] + tvl1_edge_calls(dev))
    worst, all_same = 0.0, True
    for what, (data, lam, valid) in checked:
        same, nan_same, err = tvl1_compare(data, lam, valid)
        worst = max(worst, err)
        all_same &= same
        if not same:
            log(f"    {what}: bits differ; NaN positions equal {nan_same}, "
                f"max |diff| {err:.3e}")
    check(all_same, f"kernel D bit-equal to its plain version on all "
          f"{len(checked)} calls ((a)-(e), NaN rows included); max |diff| "
          f"where both finite {worst:.3e}")

    log("  shape | rows x N | kernel ms | device ms | plain ms | roofline "
        "ms | depth bound ms (steps x one step's ns) | device ns per step "
        "of the depth")
    entry = None
    for what, (data, lam, valid) in timed_calls:
        ms = cuda_ms(lambda: tvl1_smooth_kernel(data, lam, TVL1_ITERS,
                                                valid), 50)
        device_ms = graph_ms(lambda: tvl1_smooth_kernel(
            data, lam, TVL1_ITERS, valid), 50)
        plain_ms = cuda_ms(lambda: tvl1_smooth_plain(data, lam, TVL1_ITERS,
                                                     valid), 1)
        bound_ms, bound_by, chain_ms, step_ms, row_ms, rows, n = tvl1_bound(
            data, lam, valid)
        depth = tvl1_depth(n, TVL1_ITERS)
        log(f"  {what} | {rows} x {n} | {ms:.4f} | {device_ms:.4f} | "
            f"{plain_ms:.2f} | {bound_ms:.6f} ({bound_by}) | {chain_ms:.4f} "
            f"({depth} x {step_ms * 1e6:.1f}) | "
            f"{device_ms * 1e6 / depth:.1f}; device / depth bound "
            f"{device_ms / chain_ms:.2f}; the bound's row alone, "
            f"{TVL1_ITERS} iterations less none: {row_ms:.4f}")
        if entry is None:
            entry = dict(name=TVL1_NAME, route="cuda",
                         source="video_stabilizer_tpu_torch/csrc/tvl1.cu",
                         replaces=TVL1_REPLACES, max_abs_err=worst, ms=ms,
                         device_ms=device_ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         chain_bound_ms=chain_ms, library_ms=None)
    log("  library: none (no PyTorch call runs this loop)")
    return entry


def ulp_gap(got, want):
    """(bits equal, NaN positions equal, the largest gap in float32 units
    in the last place where neither is NaN, the largest |diff| where both
    are finite) of two float32 tensors."""
    a = got.contiguous().view(torch.int32).to(torch.int64)
    b = want.contiguous().view(torch.int32).to(torch.int64)
    nan_a, nan_b = torch.isnan(got), torch.isnan(want)
    # Ordered integers: adjacent floats differ by one, -0 and +0 are 0.
    gap = (torch.where(a < 0, -(a & 0x7FFFFFFF), a)
           - torch.where(b < 0, -(b & 0x7FFFFFFF), b)).abs()
    gap = gap[~(nan_a | nan_b)]
    both = torch.isfinite(got) & torch.isfinite(want)
    diff = (got - want).abs()[both]
    return (torch.equal(a, b), torch.equal(nan_a, nan_b),
            int(gap.max()) if gap.numel() else 0,
            float(diff.max()) if diff.numel() else 0.0)


def pinv_edge_calls(dev):
    """Phase E's edge matrices, n = 4 and 8: zero; diagonal (every apq =
    0); equal diagonal entries (app == aqq); a well-conditioned SPD; a
    decoupled direction of 1e-4 beside 1e3 (cond 1e7: the Tikhonov
    branch); a zero row and column (rank-deficient, w_min 0: the Tikhonov
    branch); the SPD at 1e-30 and at 1e30; a NaN."""
    g = torch.Generator().manual_seed(SEED + 9)
    calls = []
    for n in (4, 8):
        q, _ = torch.linalg.qr(torch.randn((n, n), generator=g,
                                           dtype=torch.float64))
        spd = (q * torch.linspace(1.0, 50.0, n, dtype=torch.float64)) @ q.T
        equal = torch.full((n, n), 0.5, dtype=torch.float64)
        equal.fill_diagonal_(3.0)
        ill = torch.zeros((n, n), dtype=torch.float64)
        ill[0, 0] = 1e-4
        ill[1:, 1:] = (q[1:, 1:] * torch.linspace(1.0, 1e3, n - 1,
                                                  dtype=torch.float64)
                       ) @ q[1:, 1:].T
        deficient = spd.clone()
        deficient[-1], deficient[:, -1] = 0.0, 0.0
        nan = spd.clone()
        nan[0, 1] = float("nan")
        mats = torch.stack([
            torch.zeros((n, n), dtype=torch.float64),
            torch.diag(torch.arange(1.0, n + 1, dtype=torch.float64)),
            equal, spd, ill, deficient, spd * 1e-30, spd * 1e30, nan])
        calls.append((f"(e) {n}x{n} edge matrices (zero, diagonal, equal "
                      "diagonal, SPD, cond 1e7, rank-deficient, 1e-30, "
                      "1e30, NaN)", mats.to(torch.float32).to(dev)))
    return calls


def sweep_hessians(dev):
    """The Hessians of G1's sweep (27 combos x 32 frames, 864 items a
    level): its align, un-captured, with a spy on the pseudo-inverse."""
    from video_stabilizer_tpu_torch.apps import grid_search_align as gsa
    from video_stabilizer_tpu_torch.models import aligner
    from video_stabilizer_tpu_torch.models.batch import align_clip_impl

    frames = synth_streams(dev, SWEEP_FRAMES, MAIN_CONTENT, seeds=[SEED])[0][0]
    gray = torch.from_numpy(gsa.host_gray(frames)).to(dev)
    base, _ = gsa.widened_aligner()
    dyn = gsa.dyn_params(gsa.combo_grid(), dev)
    with mock.patch.object(aligner, "regularized_pinv_sym4",
                           wraps=aligner.regularized_pinv_sym4) as spy:
        align_clip_impl(gray, base, WIDTH, HEIGHT, dyn=dyn)
    return [c.args[0] for c in spy.call_args_list]


def pinv_library(h):
    """The library yardstick of kernel E: ``torch.linalg.eigh`` and the
    same regularized V diag(inv_w) V^T as a batched matmul (timed only)."""
    w, v = torch.linalg.eigh(h)
    w_max = torch.amax(w, dim=-1, keepdim=True)
    w_min = torch.amin(w, dim=-1, keepdim=True)
    lam = torch.where(w_max / (w_min + 1e-10) > 1e6, 1e-6 * w_max,
                      torch.zeros_like(w_max))
    w2 = w + lam
    cutoff = torch.clamp(w_max + lam, min=0.0) * 1e-7
    inv_w = torch.where(w2 > cutoff, 1.0 / w2, torch.zeros_like(w2))
    return (v * inv_w[..., None, :]) @ v.mT


def accum_call_args(call):
    """(accum0, meas, smoothed, succ, valid, params, width, height, model,
    decay) of a recorded ``accum_scan`` call."""
    import inspect

    from video_stabilizer_tpu_torch.ops.accum import accum_scan
    args, kw = call
    bound = inspect.signature(accum_scan).bind(*args, **kw)
    bound.apply_defaults()
    return tuple(bound.arguments.values())


def accum_clip_call(chunk_call, enable_smoother=True):
    """The clip layout's call (``batch.accumulate_corrections``, recorded
    by a spy) on a 32-frame clip made of a recorded chunk's measurements
    and flags twice over, smoothed by kernel D as the clip path does."""
    from video_stabilizer_tpu_torch.models import batch

    _, meas, _, succ, _, params, width, height, model, _ = chunk_call
    meas = torch.cat([meas, meas], dim=1)
    succ = torch.cat([succ, succ], dim=1)
    params = dataclasses.replace(params, enable_smoother=enable_smoother)
    smoothed = (batch.smooth_trajectory(meas, params) if enable_smoother
                else meas)
    with mock.patch.object(batch, "accum_scan",
                           wraps=batch.accum_scan) as spy:
        batch.accumulate_corrections(meas, succ, smoothed, params, width,
                                     height, model)
    return accum_call_args((spy.call_args.args, spy.call_args.kwargs))


def accum_sweep_call(dev):
    """The smoother sweep's call: ``eval_combos``' 12 combos (one lam and
    one decay row each) over 60 frames of measurements (a seeded random
    walk with failures) at its app's 360x640, through
    ``batch.accumulate_corrections``, recorded by a spy."""
    from video_stabilizer_tpu_torch.apps import grid_search_smoother as gss
    from video_stabilizer_tpu_torch.config import StabilizerParams
    from video_stabilizer_tpu_torch.models import batch

    rng = np.random.default_rng(SEED + 6)
    t = 60
    meas = torch.from_numpy(np.stack(
        [rng.normal(0, 2e-3, t), rng.normal(0, 2e-3, t),
         rng.normal(0.3, 6.0, t), rng.normal(0, 6.0, t)], -1).astype(
        np.float32)).to(dev)
    ok = torch.from_numpy(rng.random(t) > 0.1).to(dev)
    combos = list(itertools.product(gss.LAMBDAS, gss.DECAYS))
    lams = torch.tensor([c[0] for c in combos], device=dev)
    decays = torch.tensor([c[1] for c in combos], device=dev)
    params = StabilizerParams(lag=10, smoother_memory=5)
    meas_c = meas.expand((len(combos),) + meas.shape)
    ok_c = ok.expand((len(combos),) + ok.shape)
    smoothed = batch.smooth_trajectory(meas_c, params, lam=lams)
    with mock.patch.object(batch, "accum_scan",
                           wraps=batch.accum_scan) as spy:
        batch.accumulate_corrections(meas_c, ok_c, smoothed, params, 640,
                                     360, decay=decays)
    return accum_call_args((spy.call_args.args, spy.call_args.kwargs))


def accum_variants(call):
    """Phase E's edge calls of kernel F from a chunk's call: failures in
    the middle of the chunk; invalid leading steps (a fresh stream, and
    streams 6 and 0 steps in); a NaN measurement and a 1e30 one."""
    accum0, meas, smoothed, succ, valid, *rest = call
    steps = meas.shape[1]
    fail = succ.clone()
    fail[:, steps // 3:steps // 3 + 3] = False
    fail[::2, steps - 4] = False
    seen = torch.tensor([0, 6] * meas.shape[0], device=meas.device)[
        :meas.shape[0], None]
    lead = seen + torch.arange(steps, device=meas.device) - rest[0].lag >= 0
    odd = meas.clone()
    odd[0, 3, 2] = float("nan")
    odd[-1, 5, 0] = 1e30
    return [("(f) failures mid-chunk", (accum0, meas, smoothed, fail, valid,
                                        *rest)),
            ("(g) invalid leading steps", (accum0, meas, smoothed, succ,
                                           lead, *rest)),
            ("(h) a NaN and a 1e30 measurement", (accum0, odd, smoothed,
                                                  succ, valid, *rest))]


def accum_bound(call):
    """(roofline ms, what bounds it, dependent-chain ms) of one kernel F
    call. Roofline: measurements, smoothed rows, flags, decay rows and the
    starting accumulator read once, every step's accumulator and the last
    one written once; the operations of the steps this call folds
    (ACCUM_OPS_PER_FOLD), the reset's selects on the rest. Dependent chain,
    measured: sequence 0 alone, its device time at 11 x its steps (the
    call's steps tiled) less that at 1 x, over 10, so the time of its
    steps' folds in order without the launch."""
    from video_stabilizer_tpu_torch.ops.accum import accum_scan_kernel
    accum0, meas, smoothed, succ, valid, params, w, h, model, decay = call
    b, steps, p = meas.shape
    on = params.enable_smoother
    folds = b * steps if valid is None else int(valid.sum())
    bytes_moved = (b * steps * p * 4 * (3 if on else 2)
                   + b * steps * (1 if valid is None else 2)
                   + b * p * 8 + (0 if decay is None else b * 16))
    ops = folds * ACCUM_OPS_PER_FOLD[(p, on)] + (b * steps - folds) * p
    bound_ms, bound_by = roofline(bytes_moved, ops)

    def one(reps):
        def tile(x):
            return None if x is None else x[:1].repeat(
                (1, reps) + (1,) * (x.dim() - 2))
        return (accum0[:1], tile(meas), tile(smoothed), tile(succ),
                tile(valid), params, w, h, model,
                None if decay is None else decay[:1])

    def seq_ms(reps):
        args = one(reps)
        return graph_ms(lambda: accum_scan_kernel(*args), 10)

    chain_ms = (seq_ms(11) - seq_ms(1)) / 10
    return bound_ms, bound_by, chain_ms


@phase("E. kernels E and F: the Jacobi pseudo-inverse and the accumulator "
       "scan vs their plain versions (the chunks, a streaming item, G1's "
       "sweep, clips, the smoother sweep, edge cases)")
def check_pinv_accum(pinv_1080p, pinv_4k, accum_1080p, accum_4k, dev):
    """See E in the module's docstring. Returns the kernels line's entries
    of kernel E's two forms (4x4, 8x8) and of kernel F."""
    from video_stabilizer_tpu_torch.ops.accum import accum_scan_kernel
    from video_stabilizer_tpu_torch.ops.linalg import (
        regularized_pinv_sym4_kernel)

    plain_e, plain_f = PLAIN[PINV_NAME], PLAIN[ACCUM_NAME]
    check(len(pinv_1080p) == 6 and len(pinv_4k) == 7
          and len(accum_1080p) == 1 and len(accum_4k) == 1,
          f"the chunks' calls: {len(pinv_1080p)} (1080p) and {len(pinv_4k)} "
          f"(4K) pseudo-inverses, one per level; {len(accum_1080p)} and "
          f"{len(accum_4k)} accumulator scans, one per chunk")
    g1 = sweep_hessians(dev)
    check(len(g1) == 6 and all(h.shape[0] == 864 for h in g1),
          f"G1's sweep: {len(g1)} calls of {[h.shape[0] for h in g1]} items")

    # Kernel E.
    e_calls = ([(f"(a) 1080p chunk, level {k}", h)
                for k, h in enumerate(pinv_1080p)]
               + [(f"(b) 4K chunk, level {k}", h)
                  for k, h in enumerate(pinv_4k)]
               + [(f"(c) one streaming item, level {k}", h[:1])
                  for k, h in enumerate(pinv_1080p)]
               + [(f"(d) G1's sweep, level {k}", h) for k, h in enumerate(g1)]
               + pinv_edge_calls(dev))
    bit_equal, nan_same, worst_ulps, worst_e = True, True, 0, 0.0
    for what, h in e_calls:
        got = regularized_pinv_sym4_kernel(h)
        same, nans, ulps, err = ulp_gap(got, plain_e(h))
        bit_equal &= same
        nan_same &= nans
        worst_ulps, worst_e = max(worst_ulps, ulps), max(worst_e, err)
        if not same:
            log(f"    {what}: bits differ; NaN positions equal {nans}, "
                f"largest gap {ulps} ulps, max |diff| {err:.3e}")
    if bit_equal:
        check(True, f"kernel E bit-equal to its plain version on all "
              f"{len(e_calls)} calls ((a)-(e), NaN positions included)")
    else:
        check(nan_same and worst_ulps <= 2,
              f"kernel E NOT bit-equal to its plain version; the 2-ulp bar: "
              f"NaN positions equal {nan_same}, largest gap {worst_ulps} "
              f"ulps (max |diff| {worst_e:.3e}) over {len(e_calls)} calls")

    log("  kernel E | shape | kernel ms | device ms | plain ms | library ms "
        "(eigh) | roofline ms | chain ms (4x4: 6 sweeps of one matrix; "
        "8x8: 42 of those rotations)")
    timed_e = [("(a) 1080p chunk, level 0", pinv_1080p[0]),
               ("(b) 4K chunk, level 0", pinv_4k[0]),
               ("(c) one streaming item", pinv_1080p[0][:1]),
               ("(d) G1's sweep, level 0", g1[0])]
    entries_e, rotation_ms = {}, None
    for what, h in timed_e:
        b, n = h.shape[0], h.shape[-1]
        ms = cuda_ms(lambda: regularized_pinv_sym4_kernel(h), 50)
        device_ms = graph_ms(lambda: regularized_pinv_sym4_kernel(h), 50)
        plain_ms = cuda_ms(lambda: plain_e(h), 1)
        library_ms = cuda_ms(lambda: pinv_library(h), 5)
        bound_ms, bound_by = roofline(2 * b * n * n * 4, b * pinv_ops(n))
        one = h[:1].contiguous()

        def sweeps_ms(sweeps):
            return graph_ms(lambda: regularized_pinv_sym4_kernel(
                one, sweeps=sweeps), 10)
        own_ms = ((sweeps_ms(PINV_CHAIN_SWEEPS) - sweeps_ms(PINV_SWEEPS))
                  * PINV_SWEEPS / (PINV_CHAIN_SWEEPS - PINV_SWEEPS))
        run_ms = sweeps_ms(PINV_SWEEPS) - sweeps_ms(0)
        if n == 4:
            chain_ms, note = own_ms, ""
            if rotation_ms is None:
                rotation_ms = own_ms / PINV_ROTATIONS4
        else:
            # The 8x8 form's 4 rotations a round are independent: its
            # depth is 42 rotations of the 4x4 chain's (shape (a)'s).
            chain_ms = PINV_ROUNDS8 * rotation_ms
            note = (f"; one matrix's 6 sweeps alone {own_ms:.4f} ms, "
                    f"{own_ms * 1e3 / PINV_ROUNDS8:.3f} us a round against "
                    f"{rotation_ms * 1e3:.3f} us a 4x4 rotation")
        log(f"  {what} | {b} x {n}x{n} | {ms:.4f} | {device_ms:.4f} | "
            f"{plain_ms:.2f} | {library_ms:.4f} | {bound_ms:.6f} "
            f"({bound_by}) | {chain_ms:.4f}; device / chain "
            f"{device_ms / chain_ms:.2f}{note}; one matrix alone, "
            f"{PINV_SWEEPS} sweeps less none: {run_ms:.4f}")
        entries_e.setdefault(n, dict(
            name=PINV_NAME if n == 4 else PINV8_NAME, route="cuda",
            source="video_stabilizer_tpu_torch/csrc/jacobi.cu",
            replaces=PINV_REPLACES, max_abs_err=worst_e, ms=ms,
            device_ms=device_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, chain_bound_ms=chain_ms,
            library_ms=library_ms))

    # Kernel F.
    chunk = accum_call_args(accum_1080p[0])
    chunk_4k = accum_call_args(accum_4k[0])
    clip = accum_clip_call(chunk)
    sweep = accum_sweep_call(dev)
    f_calls = ([("(a) 1080p chunk", chunk), ("(b) 4K chunk", chunk_4k),
                ("(c) 1080p clip of 32 frames", clip),
                ("(c) 4K clip of 32 frames", accum_clip_call(chunk_4k)),
                ("(d) the smoother sweep, a decay row per combo", sweep),
                ("(e) smoother off, 1080p clip",
                 accum_clip_call(chunk, enable_smoother=False)),
                ("(e) smoother off, 4K clip",
                 accum_clip_call(chunk_4k, enable_smoother=False))]
               + accum_variants(chunk) + accum_variants(chunk_4k))
    all_same, worst_f = True, 0.0
    for what, call in f_calls:
        got = accum_scan_kernel(*call)
        want = plain_f(*call)
        for g, w in zip(got, want):
            same, nans, ulps, err = ulp_gap(g, w)
            all_same &= same
            worst_f = max(worst_f, err)
            if not same:
                log(f"    {what}: bits differ; NaN positions equal {nans}, "
                    f"largest gap {ulps} ulps, max |diff| {err:.3e}")
    check(all_same, f"kernel F bit-equal to its plain version on all "
          f"{len(f_calls)} calls ((a)-(h): every step's accumulator and the "
          f"last, NaN positions included); max |diff| where both finite "
          f"{worst_f:.3e}")

    log("  kernel F | sequences x steps x P | kernel ms | device ms | plain "
        "ms | roofline ms | chain ms (one sequence's folds)")
    entry_f = None
    for what, call in f_calls[:3] + f_calls[4:5]:
        b, steps, p = call[1].shape
        ms = cuda_ms(lambda: accum_scan_kernel(*call), 50)
        device_ms = graph_ms(lambda: accum_scan_kernel(*call), 50)
        plain_ms = cuda_ms(lambda: plain_f(*call), 1)
        bound_ms, bound_by, chain_ms = accum_bound(call)
        log(f"  {what} | {b} x {steps} x {p} | {ms:.4f} | {device_ms:.4f} | "
            f"{plain_ms:.2f} | {bound_ms:.6f} ({bound_by}) | {chain_ms:.4f}; "
            f"device / chain {device_ms / chain_ms:.2f}")
        if entry_f is None:
            entry_f = dict(name=ACCUM_NAME, route="cuda",
                           source="video_stabilizer_tpu_torch/csrc/accum.cu",
                           replaces=ACCUM_REPLACES, max_abs_err=worst_f,
                           ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           chain_bound_ms=chain_ms, library_ms=None)
    log("  kernel F's library: none (no PyTorch call runs this scan)")
    return entries_e[4], entries_e[8], entry_f


def gray_bound(pixels):
    """Kernel G's roofline bound: 3 bytes read and 1 written a pixel."""
    return roofline(4 * pixels, GRAY_OPS_PER_PIXEL * pixels)


def pyr_bound(x):
    """Kernel H's roofline bound on (..., H, W) input ``x``: each source
    byte read once, each output byte written once."""
    h, w = x.shape[-2], x.shape[-1]
    frames = x.numel() // (h * w)
    outputs = frames * (h // 2) * (w // 2)
    return roofline(x.numel() + outputs, PYR_OPS_PER_OUTPUT * outputs)


def bgr_cube(dev):
    """Every BGR triple once: a (4096, 4096, 3) u8 image on the card."""
    v = torch.arange(1 << 24, dtype=torch.int32, device=dev)
    return torch.stack([v >> 16, (v >> 8) & 255, v & 255], -1).to(
        torch.uint8).reshape(4096, 4096, 3)


def odd_address(x):
    """A contiguous copy of ``x`` at an odd byte address (the kernels'
    byte-at-a-time paths)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def conv_yardstick(x):
    """(F.conv2d's ms, whether floor(conv) equals kernel H): the pyramid's
    5x5 stencil as one float32 convolution, stride 2, TF32 off, on the
    replicate-padded float32 input. The timed call leaves out the pad,
    both casts and the shift."""
    import torch.nn.functional as F

    h, w = x.shape[-2], x.shape[-1]
    taps = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], device=x.device)
    weight = (torch.outer(taps, taps) / 256.0).reshape(1, 1, 5, 5)
    padded = F.pad(x.reshape(-1, 1, h, w).float(), (2, 2, 2, 2),
                   mode="replicate")
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ms = cuda_ms(lambda: F.conv2d(padded, weight, stride=2), 10)
        out = F.conv2d(padded, weight, stride=2)
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    return ms, out


@phase("G. kernels G and H: BGR to gray and the pyramid's downsample vs "
       "their plain versions (the 1080p and 4K chunks, one frame, ragged "
       "frames, every BGR triple)")
def check_gray_pyr(params, params_4k, dev):
    """See G in the module's docstring. Returns the kernels line's entries
    of kernels G and H at the 1080p chunk."""
    from video_stabilizer_tpu_torch.models.aligner import level_specs
    from video_stabilizer_tpu_torch.ops.gray import bgr_to_gray_kernel
    from video_stabilizer_tpu_torch.ops.pyr_down import (build_pyramid,
                                                         pyr_down_kernel)

    plain_g, plain_h = PLAIN[GRAY_NAME], PLAIN[PYR_NAME]
    chunk = torch.from_numpy(synth_streams(dev, CHUNK, MAIN_CONTENT)[0]).to(
        dev)
    chunk_4k = torch.from_numpy(synth_streams(
        dev, CHUNK, MAIN_CONTENT, H4K, W4K, seeds=list(SEEDS_4K))[0]).to(dev)
    ragged = chunk[0, :RAGGED[0], :RAGGED[1], :RAGGED[2]].contiguous()

    # Kernel G.
    g_calls = [("(a) 1080p chunk", chunk), ("(b) 4K chunk", chunk_4k),
               ("(c) one 1080p frame", chunk[0, 0]),
               ("(d) one ragged frame", ragged[0]),
               ("(d) ragged frames at an odd address", odd_address(ragged)),
               ("(e) every BGR triple", bgr_cube(dev))]
    log("  kernel G | shape | equal | kernel ms | device ms | plain ms | "
        "bound ms (bytes) | device / bound")
    entry_g, grays = None, {}
    for what, x in g_calls:
        got, want = bgr_to_gray_kernel(x), plain_g(x)
        same = torch.equal(got, want)
        err = int((got.int() - want.int()).abs().max())
        check(same, f"kernel G {what} {tuple(x.shape)}: bit-equal to its "
              f"plain version (max |diff| {err})")
        grays[what] = want
        ms = cuda_ms(lambda: bgr_to_gray_kernel(x), 50)
        device_ms = graph_ms(lambda: bgr_to_gray_kernel(x), 50)
        plain_ms = cuda_ms(lambda: plain_g(x), 5)
        bound_ms, bound_by = gray_bound(got.numel())
        log(f"  {what} | {tuple(x.shape)} | {same} | {ms:.4f} | "
            f"{device_ms:.4f} | {plain_ms:.3f} | {bound_ms:.4f} "
            f"({bound_by}) | {device_ms / bound_ms:.2f}")
        if entry_g is None:
            entry_g = dict(name=GRAY_NAME, route="cuda",
                           source="video_stabilizer_tpu_torch/csrc/gray.cu",
                           replaces=GRAY_REPLACES, max_abs_err=float(err),
                           ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=None)
        del got, want
    log("  kernel G's library: none (no single PyTorch call rounds as "
        "cvtColor's float form does)")

    # Kernel H, level by level on the chunks' real gray frames: 5 levels
    # below the 1080p chunk's first, 6 below the 4K chunk's, a ragged chain
    # of 8 levels from 437x1033 down to 3x8, one 1080p frame (the streaming
    # step's pyramid), the soak's frame, rows 4 bytes apart (the wide
    # engine's word loads) and more frames than a grid axis holds.
    frame = grays["(c) one 1080p frame"]
    soak = grays["(a) 1080p chunk"][0, 0, :SOAK_H, :SOAK_W].contiguous()
    soak_levels = len(level_specs(SOAK_W, SOAK_H, params.aligner))
    gen = torch.Generator(dev).manual_seed(SEED)
    chains = [("(a) 1080p chunk",
               grays["(a) 1080p chunk"].reshape(-1, HEIGHT, WIDTH),
               len(level_specs(WIDTH, HEIGHT, params.aligner)), (33, 60)),
              ("(b) 4K chunk", grays["(b) 4K chunk"].reshape(-1, H4K, W4K),
               len(level_specs(W4K, H4K, params_4k.aligner)), (33, 60)),
              ("(c) ragged chain",
               grays["(d) ragged frames at an odd address"], RAGGED_LEVELS,
               (3, 8)),
              ("(d) one 1080p frame", frame,
               len(level_specs(WIDTH, HEIGHT, params.aligner)), (33, 60)),
              ("(e) the soak's frame", soak, soak_levels,
               (SOAK_H >> (soak_levels - 1), SOAK_W >> (soak_levels - 1))),
              ("(f) 4 frames of 1080x1924",
               torch.randint(0, 256, (4, HEIGHT, WIDTH + 4), device=dev,
                             dtype=torch.uint8, generator=gen), 3,
               (270, 481)),
              (f"(g) {MANY_FRAMES} 8x8 frames",
               torch.randint(0, 256, (MANY_FRAMES, 8, 8), device=dev,
                             dtype=torch.uint8, generator=gen), 3, (2, 2))]
    del grays, g_calls, chunk, chunk_4k
    torch.cuda.empty_cache()
    log("  kernel H | input | equal | kernel ms | device ms | plain ms | "
        "conv2d ms | bound ms (bytes) | device / bound")
    entry_h, all_same, worst = None, True, 0
    for what, x, levels, end in chains:
        totals = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0,
                      bound_ms=0.0)
        top = x
        for level in range(1, levels):
            got, want = pyr_down_kernel(x), plain_h(x)
            same = torch.equal(got, want)
            all_same &= same
            worst = max(worst, int((got.int() - want.int()).abs().max()))
            if level <= 2 and x.dim() == 3 and x.shape[0] > 1:
                # The byte-at-a-time paths on a word-wide source: one frame
                # (the narrow engine) and every frame (the chunks' wide).
                for part in (x[:1], x):
                    same_odd = torch.equal(
                        pyr_down_kernel(odd_address(part)),
                        want[:part.shape[0]])
                    all_same &= same_odd
                    log(f"    {what}, level {level} from {part.shape[0]} "
                        f"frames at an odd address: equal {same_odd}")
            ms = cuda_ms(lambda: pyr_down_kernel(x), 50)
            device_ms = graph_ms(lambda: pyr_down_kernel(x), 50)
            plain_ms = cuda_ms(lambda: plain_h(x), 5)
            conv_ms, conv = conv_yardstick(x)
            # An odd side gives the convolution one more row or column.
            conv = conv[..., :want.shape[-2], :want.shape[-1]]
            conv_same = torch.equal(conv.floor().to(torch.uint8).reshape(
                want.shape), want)
            bound_ms, bound_by = pyr_bound(x)
            log(f"  {what} {level - 1} -> {level} | {tuple(x.shape)} | "
                f"{same} | {ms:.4f} | {device_ms:.4f} | {plain_ms:.3f} | "
                f"{conv_ms:.4f} (floor equal {conv_same}) | {bound_ms:.4f} "
                f"({bound_by}) | {device_ms / bound_ms:.2f}")
            for k, v in (("ms", ms), ("device_ms", device_ms),
                         ("plain_ms", plain_ms), ("library_ms", conv_ms),
                         ("bound_ms", bound_ms)):
                totals[k] += v
            x = want
            del got, conv
        # The whole pyramid as the paths build it: its levels - 1 launches,
        # 50 pyramids replayed from a CUDA graph (the gaps between launches
        # included).
        pyramid_ms = graph_ms(lambda: build_pyramid(top, levels), 50)
        log(f"  {what}, all {levels - 1} levels | kernel "
            f"{totals['ms']:.4f} ms | device {totals['device_ms']:.4f} | "
            f"whole pyramid from a graph {pyramid_ms:.4f} | plain "
            f"{totals['plain_ms']:.3f} | conv2d {totals['library_ms']:.4f} | "
            f"bound {totals['bound_ms']:.4f} | device / bound "
            f"{totals['device_ms'] / totals['bound_ms']:.2f}")
        check(tuple(x.shape[-2:]) == end,
              f"{what}: the chain ends at {tuple(x.shape[-2:])} (want {end})")
        if entry_h is None:
            entry_h = dict(name=PYR_NAME, route="cuda",
                           source="video_stabilizer_tpu_torch/csrc/"
                                  "pyr_down.cu",
                           replaces=PYR_REPLACES, bound_by=bound_by,
                           **totals)
    check(all_same, f"kernel H bit-equal to its plain version at every level "
          f"of every chain (both chunks, the ragged chain, one frame, the "
          f"soak's frame, rows 4 bytes apart, {MANY_FRAMES} frames; and from "
          f"an odd address); max |diff| {worst}")
    log("  kernel H's library yardstick: F.conv2d alone (stride 2, TF32 "
        "off) on the replicate-padded float32 input; it leaves out the pad, "
        "both casts and the shift")
    entry_h["max_abs_err"] = float(worst)
    return entry_g, entry_h


def key_bound(x, spec, rows):
    """Kernel I's roofline bound on one level ``x`` (K, h, w): the level
    read once; idx (2 int32), coords (4 float32), the Jacobian (2 x rows
    float32) a keypoint and the P x P windows a tile written once."""
    keys = x.shape[0]
    n = spec.ht * spec.wt
    p = spec.tile + 2 * spec.margin
    out = keys * n * (8 + 16 + 8 * rows + p * p)
    ops = keys * (n * spec.tile ** 2 * KEY_OPS_PER_PIXEL
                  + n * KEY_OPS_PER_POINT[rows])
    return roofline(x.numel() + out, ops)


def key_fields_equal(got, want):
    """(bit-equal in all five fields, max |diff| over them): float32
    fields compared as bits, so a zero's sign and NaN positions count."""
    same, err = True, 0.0
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            same &= g.shape == w.shape and torch.equal(
                g.view(torch.int32), w.view(torch.int32))
        else:
            same &= torch.equal(g, w)
        if g.numel():
            err = max(err, float((g.double() - w.double()).abs().max()))
    return bool(same), err


def tie_frames(dev):
    """Three 1080p frames on which every tile ties: flat, vertical and
    horizontal stripes 1 px apart in a 3 px period, a 1 px checkerboard."""
    y = torch.arange(HEIGHT, device=dev)[:, None]
    x = torch.arange(WIDTH, device=dev)[None, :]
    flat = torch.full((HEIGHT, WIDTH), 128, device=dev)
    stripes = (x % 3 == 0) * 90 + (y % 3 == 0) * 60 + 40
    checker = ((x + y) % 2) * 255
    return torch.stack([flat, stripes, checker]).to(torch.uint8)


def strided_odd(levels):
    """Each level's keyframes as every other frame of a buffer of 2 K + 1
    frames, starting one byte past an aligned address: ``align_pairs``'
    view of its odd frames, at an odd address."""
    out = []
    for x in levels:
        keys, h, w = x.shape
        buf = torch.empty((2 * keys + 1) * h * w + 1, dtype=torch.uint8,
                          device=x.device)
        view = buf.as_strided((keys, h, w), (2 * h * w, w, 1), h * w + 1)
        view.copy_(x)
        out.append(view)
    return out


# The in-place check's rows: the carried keyframes before the new ones
# (align_pairs' offset at the 1080p chunk) and guard rows after them.
KEY_OFFSET, KEY_GUARD = 8, 2


def keyframes_in_place(levels, lvl_specs, model, wants):
    """Kernel I from ``strided_odd(levels)`` into a set whose rows before
    KEY_OFFSET and after the keyframes hold a byte pattern: (rows [offset,
    offset + K) bit-equal to ``wants`` in all five fields, the other rows
    unchanged)."""
    from video_stabilizer_tpu_torch.ops.keyframe import (
        LevelKeyData, keyframe_levels_kernel)
    keys = levels[0].shape[0]
    out = tuple(LevelKeyData(*(
        torch.full((KEY_OFFSET + keys + KEY_GUARD,) + f.shape[1:], 0x5A,
                   dtype=torch.uint8, device=f.device).view(f.dtype)
        if f.dtype == torch.uint8 else
        torch.full((KEY_OFFSET + keys + KEY_GUARD,) + f.shape[1:],
                   0x5A5A5A5A, dtype=torch.int32, device=f.device)
        .view(f.dtype) for f in w)) for w in wants)
    before = [[f.clone() for f in o] for o in out]
    got = keyframe_levels_kernel(strided_odd(levels), lvl_specs, model,
                                 out=out, offset=KEY_OFFSET)
    same, untouched = got is out, True
    for o, b, w in zip(out, before, wants):
        inside = LevelKeyData(*(f[KEY_OFFSET:KEY_OFFSET + keys] for f in o))
        same &= key_fields_equal(inside, w)[0]
        for f, fb in zip(o, b):
            untouched &= torch.equal(f[:KEY_OFFSET], fb[:KEY_OFFSET])
            untouched &= torch.equal(f[KEY_OFFSET + keys:],
                                     fb[KEY_OFFSET + keys:])
    return same, untouched


@phase("I. kernel I: the keyframe precompute vs its plain version, both "
       "models, every level in one launch and each level alone (the 1080p "
       "and 4K chunks, one frame, the zero pyramid, ties, ragged levels, "
       "the soak's frame, 70,000 frames; strided, in place)")
def check_keyframe(params, params_4k, dev):
    """See I in the module's docstring. Returns the kernels line's entries
    of kernel I at the 1080p chunk (similarity) and the 4K chunk
    (homography)."""
    from video_stabilizer_tpu_torch.models.aligner import level_specs
    from video_stabilizer_tpu_torch.ops.gray import bgr_to_gray_kernel
    from video_stabilizer_tpu_torch.ops.keyframe import (
        keyframe_level_kernel, keyframe_levels_kernel)
    from video_stabilizer_tpu_torch.ops.pyr_down import build_pyramid

    plain = PLAIN[KEY_NAME]

    def keyframes(height, width, seeds):
        """The odd frames of a chunk of bench.py's content, as gray
        (K, h, w) through kernels G and H: a chunk's keyframes."""
        bgr = torch.from_numpy(synth_streams(
            dev, CHUNK, MAIN_CONTENT, height, width, seeds=seeds)[0]).to(dev)
        gray = bgr_to_gray_kernel(bgr)[:, 1::2]
        return gray.reshape((-1,) + gray.shape[2:]).contiguous()

    specs = level_specs(WIDTH, HEIGHT, params.aligner)
    specs_4k = level_specs(W4K, H4K, params_4k.aligner)
    specs_soak = level_specs(SOAK_W, SOAK_H, params.aligner)
    key_1080p = keyframes(HEIGHT, WIDTH, None)
    ragged = key_1080p[:RAGGED[0], :RAGGED[1], :RAGGED[2]].contiguous()
    gen = torch.Generator(dev).manual_seed(SEED)
    # (name, pyramid levels, specs, the model timed: the path's)
    inputs = [
        ("(a) 1080p chunk", build_pyramid(key_1080p, len(specs)), specs,
         "similarity"),
        ("(b) 4K chunk", build_pyramid(keyframes(H4K, W4K, list(SEEDS_4K)),
                                       len(specs_4k)), specs_4k, HOMOGRAPHY),
        ("(c) one 1080p frame", build_pyramid(key_1080p[:1], len(specs)),
         specs, "similarity"),
        ("(d) the zero pyramid, 8 streams",
         [torch.zeros((STREAMS, s.height, s.width), dtype=torch.uint8,
                      device=dev) for s in specs], specs, "similarity"),
        ("(e) ties: flat, stripes, checkerboard",
         build_pyramid(tie_frames(dev), len(specs)), specs, "similarity"),
        ("(f) ragged chain from 437x1033",
         build_pyramid(ragged, len(level_specs(RAGGED[2], RAGGED[1],
                                               params.aligner))),
         level_specs(RAGGED[2], RAGGED[1], params.aligner), "similarity"),
        ("(g) the soak's 64x48",
         build_pyramid(key_1080p[:2, :SOAK_H, :SOAK_W].contiguous(),
                       len(specs_soak)), specs_soak, "similarity"),
        (f"(h) {MANY_FRAMES} 8x8 frames",
         [torch.randint(0, 256, (MANY_FRAMES, 8, 8), device=dev,
                        dtype=torch.uint8, generator=gen)],
         level_specs(8, 8, params.aligner), "similarity")]
    del key_1080p, ragged
    log("  kernel I | input | level | K x h x w | model | equal, one launch "
        "/ level alone (5 fields) | kernel ms | device ms | plain ms | "
        "bound ms (bytes) | device / bound   (per level: that level's work "
        "list alone)")
    entries, all_same, worst, in_place, untouched = {}, True, 0.0, True, True
    for what, levels, lvl_specs, timed_model in inputs:
        for model in ("similarity", HOMOGRAPHY):
            rows = 4 if model == "similarity" else 8
            wants = [plain(x, s, model) for x, s in zip(levels, lvl_specs)]
            got_all = keyframe_levels_kernel(levels, lvl_specs, model)
            totals = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0)
            for level, (x, s, want, got) in enumerate(
                    zip(levels, lvl_specs, wants, got_all)):
                same, err = key_fields_equal(got, want)
                alone, err_alone = key_fields_equal(
                    keyframe_level_kernel(x, s, model), want)
                all_same &= same and alone
                worst = max(worst, err, err_alone)
                if model != timed_model:
                    if not (same and alone):
                        log(f"  {what} | {level} | {model}: NOT bit-equal "
                            f"(one launch {same}, alone {alone}; max |diff| "
                            f"{max(err, err_alone)})")
                    continue
                ms = cuda_ms(lambda: keyframe_level_kernel(x, s, model), 50)
                device_ms = graph_ms(
                    lambda: keyframe_level_kernel(x, s, model), 50)
                plain_ms = cuda_ms(lambda: plain(x, s, model), 5)
                bound_ms, bound_by = key_bound(x, s, rows)
                log(f"  {what} | {level} | {tuple(x.shape)} | {model} | "
                    f"{same} / {alone} | {ms:.4f} | {device_ms:.4f} | "
                    f"{plain_ms:.3f} | {bound_ms:.4f} ({bound_by}) | "
                    f"{device_ms / bound_ms:.2f}")
                for k, v in (("ms", ms), ("device_ms", device_ms),
                             ("plain_ms", plain_ms), ("bound_ms", bound_ms)):
                    totals[k] += v
            del got_all
            ok_in, ok_out = keyframes_in_place(levels, lvl_specs, model,
                                               wants)
            in_place &= ok_in
            untouched &= ok_out
            del wants
            if model != timed_model:
                continue
            # Every level in the one launch the paths run: its wrapper
            # between CUDA events over 50 launches, and 50 launches
            # replayed from a CUDA graph.
            set_ms = cuda_ms(lambda: keyframe_levels_kernel(
                levels, lvl_specs, model), 50)
            set_device_ms = graph_ms(lambda: keyframe_levels_kernel(
                levels, lvl_specs, model), 50)
            log(f"  {what}, all {len(levels)} levels, {model} | one launch: "
                f"kernel {set_ms:.4f} ms, device {set_device_ms:.4f} | "
                f"levels alone: kernel {totals['ms']:.4f}, device "
                f"{totals['device_ms']:.4f} | plain {totals['plain_ms']:.3f} "
                f"| bound {totals['bound_ms']:.4f} | one launch's device / "
                f"bound {set_device_ms / totals['bound_ms']:.2f}")
            if what.startswith("(a)") or what.startswith("(b)"):
                name = KEY_ENTRY if model == "similarity" else KEY_H_ENTRY
                entries[name] = dict(
                    name=name, route="cuda",
                    source="video_stabilizer_tpu_torch/csrc/keyframe.cu",
                    replaces=(KEY_REPLACES if model == "similarity"
                              else KEY_H_REPLACES),
                    bound_by="bytes", library_ms=None, ms=set_ms,
                    device_ms=set_device_ms, plain_ms=totals["plain_ms"],
                    bound_ms=totals["bound_ms"])
        del levels
        torch.cuda.empty_cache()
    check(all_same, "kernel I bit-equal to its plain version in idx_x, "
          "idx_y, coords, jac and windows at every level of every input, "
          "both models, in one launch for all levels and with each level's "
          f"work list alone; max |diff| {worst}")
    check(in_place and untouched, "kernel I from every other frame of a "
          "buffer at an odd address into rows [8, 8 + K) of a set: "
          f"bit-equal there ({in_place}) at every input, both models, and "
          f"the 8 rows before and 2 after unchanged ({untouched})")
    log("  kernel I's library: none (no single PyTorch call computes the "
        "keyframe precompute)")
    for entry in entries.values():
        entry["max_abs_err"] = worst
    return entries.get(KEY_ENTRY), entries.get(KEY_H_ENTRY)


def sel_positions(args):
    """The clamped window positions (rel_x, rel_y), (B, 2, N) each, of one
    level's kernel J call, formed as the plain version forms them."""
    from video_stabilizer_tpu_torch import transforms as T
    from video_stabilizer_tpu_torch.ops import gn8_solve, patches
    spec, key, kidx, _, _, transform, _, _, model = args
    p, kidx = key.windows.shape[-1], kidx.long()
    ox, oy = patches.window_origins_flat(spec.ht, spec.wt, spec.tile,
                                         spec.margin, device=kidx.device)
    if model == "similarity":
        t_ul = T.center_to_ul(transform, spec.width,
                              spec.height)[:, None, None, :]
        return patches.warp_rel_positions_flat(
            key.coords[kidx, 0], key.coords[kidx, 1], t_ul, ox, oy, p)
    u, v = gn8_solve.normalized_keypoints(key, spec)
    return gn8_solve.warp_rel_positions_h(
        transform[:, None, None, :], u[kidx], v[kidx], spec.width,
        spec.height, ox, oy, p)


def sel_sectors(args) -> int:
    """The 32-byte sectors the 4x4 tap patches of one level's call touch
    in its keypoint-major windows at their device addresses: a patch's 4
    rows of 4 bytes, each sector counted once a patch."""
    spec, key, kidx = args[:3]
    n, p = spec.ht * spec.wt, key.windows.shape[-1]
    rx, ry = sel_positions(args)
    nidx = torch.arange(n, device=rx.device)
    first = (key.windows.data_ptr()
             + ((kidx.long()[:, None, None] * n + nidx) * p
                + torch.floor(ry).long() - 1) * p
             + torch.floor(rx).long() - 1)                     # (B, 2, N)
    rows = first[..., None] + torch.arange(4, device=rx.device) * p
    ends = torch.cat([rows // 32, (rows + 3) // 32], dim=-1).sort(-1).values
    return int((1 + (ends.diff(dim=-1) != 0).sum(-1)).sum())


def sel_bound(args):
    """Kernel J's roofline bound on one level's call (``SEL_KEY_BYTES``):
    (bound ms, bound_by, the taps counted as 32-byte sectors of the JAX
    package's (P, P, N) windows (16 a patch) ms, the same counted in the
    port's keypoint-major windows (``sel_sectors``) ms)."""
    spec, key, kidx, templates, tidx, transform, _, fraction, _ = args
    n, bsz = spec.ht * spec.wt, kidx.shape[0]
    p, rows = key.windows.shape[-1], key.jac.shape[1]
    kidx = kidx.long()
    uses = torch.bincount(kidx, minlength=key.windows.shape[0])
    taps = float(torch.clamp(uses * 2 * SEL_TAPS, max=p * p).sum()) * n
    keys = int((uses > 0).sum())
    pairs = int(torch.unique(kidx * templates.shape[0] + tidx.long())
                .numel())
    per_item = bsz * (2 * 8 + 4 * rows + 4 * rows * rows + (
        4 if isinstance(fraction, torch.Tensor) else 0))
    total = (2 * n * (keys * SEL_KEY_BYTES[rows] + pairs
                      + bsz * SEL_OUT_BYTES[rows]) + taps + per_item)
    ms, by = roofline(total, bsz * 2 * n * SEL_OPS[rows])
    lanes = total - taps + bsz * 2 * n * SEL_TAPS * 32
    rows_major = total - taps + sel_sectors(args) * 32
    return (ms, by, lanes / HBM_BYTES_PER_S * 1e3,
            rows_major / HBM_BYTES_PER_S * 1e3)


def sel_one_item(args, item=0):
    """One level's kernel J call cut to one item on its own keyframe and
    template: the streaming step's shape (B = 1, K = 1, M = 1)."""
    spec, key, kidx, templates, tidx, transform, params, fraction, model = \
        args
    from video_stabilizer_tpu_torch.ops.keyframe import LevelKeyData
    k, m = int(kidx[item]), int(tidx[item])
    if isinstance(fraction, torch.Tensor) and fraction.dim() == 1:
        fraction = fraction[item:item + 1]
    return (spec, LevelKeyData(*(f[k:k + 1] for f in key)),
            kidx.new_zeros(1), templates[m:m + 1], tidx.new_zeros(1),
            transform[item:item + 1].contiguous(), params, fraction, model)


def sel_compare(args):
    """Kernel J (with its debug warp-diff output) against its plain version
    on one level's call. Returns a dict: the bars (tmpl bit-equal, jac_masked
    = jac * mask of the kernel's own wd bit for bit, the kernel's wd within
    SEL_WD_GAP of the plain one, every mask entry that differs from the
    plain version's explained, the Hessian within SEL_HESS_BAR of a float64
    sum of the kernel's own masked products relative to the sum of their
    magnitudes, symmetric, two launches byte-equal) and the figures."""
    from video_stabilizer_tpu_torch.ops.prelude import (
        level_prelude_kernel, selection_mask)
    spec, key, kidx, templates, tidx, transform, params, fraction, model = \
        args
    got = level_prelude_kernel(*args, return_wd=True)
    again = level_prelude_kernel(*args, return_wd=True)
    want = PLAIN[SEL_NAME](*args, return_wd=True)
    tm, jm, hess, wd = got
    tm_p, _, _, wd_p = want
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, again))
    gap = float((wd - wd_p).abs().max()) if wd.numel() else 0.0
    mask = selection_mask(wd, params, fraction)
    mask_p = selection_mask(wd_p, params, fraction)
    jac = key.jac[kidx.long()]
    # A mask entry may differ from the plain version's only where a plain
    # diff lies within the gap of an integer (its bin may differ), or in a
    # row where such a bin moved (the row's threshold may move with it).
    differ = mask != mask_p
    near = (wd_p - torch.round(wd_p)).abs() <= SEL_WD_GAP
    bins, bins_p = (torch.clamp(torch.floor(x), max=256) for x in (wd, wd_p))
    moved = (bins != bins_p).any(dim=-1, keepdim=True).expand_as(differ)
    return dict(
        tmpl=torch.equal(tm, tm_p), jac_masked=sel_jac_masked(jm, jac, mask),
        gap=gap, differ=int(differ.sum()), near=int((differ & near).sum()),
        moved=int((differ & ~near & moved).sum()),
        unexplained=int((differ & ~near & ~moved).sum()),
        hess_rel=sel_hess_rel(hess, jac, mask),
        symmetric=torch.equal(hess, hess.transpose(1, 2)),
        deterministic=same, kept=float(mask.mean()) if mask.numel() else 0.0,
        overflow=int((wd >= 256).sum()), entries=wd.numel())


def sel_jac_masked(jm, jac, mask) -> bool:
    """jac_masked equal to jac * mask (x 0.5 for the similarity's R = 4)
    bit for bit."""
    want = jac * (mask * 0.5 if jac.shape[1] == 4 else mask)[:, None]
    return torch.equal(jm.view(torch.int32), want.view(torch.int32))


def sel_hess_rel(hess, jac, mask) -> float:
    """The largest gap between the Hessian and a float64 sum of the same
    masked products, relative to the sum of their magnitudes."""
    if not hess.numel():
        return 0.0
    jm64, j64 = (jac * mask[:, None]).double(), jac.double()
    h64 = torch.einsum("brsn,bqsn->brq", jm64, j64)
    mag = torch.einsum("brsn,bqsn->brq", jm64.abs(), j64.abs())
    return float(((hess.double() - h64).abs() / mag.clamp_min(1e-300)).max())


def topk_args(args, fraction=None):
    """One level's kernel J call under ``selection="topk"``, its count from
    ``fraction`` where given, else from the call's ``smallest_fraction``."""
    over = dict(selection="topk")
    if fraction is not None:
        over["smallest_fraction"] = fraction
    return args[:6] + (dataclasses.replace(args[6], **over),) + args[7:]


def sel_exact_compare(args):
    """Kernel J's exact-count mode on one level's ``topk`` call, with its
    warp diffs and mask (debug outputs). Returns a dict: the bars (its mask
    ``topk_mask``'s of its own wd bit for bit, exactly k kept in every row,
    tmpl bit-equal to the plain version's, jac_masked = jac * mask bit for
    bit, wd within SEL_WD_GAP of the plain one, the Hessian within
    SEL_HESS_BAR of a float64 sum, symmetric, two launches and every
    cluster size 1-8 byte-equal) and the entries where its mask differs
    from the plain ``topk`` prelude's, each of which must lie within 2
    SEL_WD_GAP of its row's k-th plain value (two diffs that close may
    swap order)."""
    from video_stabilizer_tpu_torch.ops.prelude import (
        launch_plan, level_prelude_kernel)
    from video_stabilizer_tpu_torch.ops.select import topk_count, topk_mask
    spec, key, kidx, *_, params, _, _ = args
    bsz, n = kidx.shape[0], spec.ht * spec.wt
    frac = params.smallest_fraction
    k = min(topk_count(n, frac), n)
    got = level_prelude_kernel(*args, return_wd=True, return_mask=True)

    def same(other) -> bool:
        return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, other))

    again = same(level_prelude_kernel(*args, return_wd=True,
                                      return_mask=True))
    plans = all(same(level_prelude_kernel(
        *args, return_wd=True, return_mask=True,
        plan=launch_plan(bsz, n, c, exact=True))) for c in (1, 2, 4, 8))
    tm, jm, hess, wd, mask = got
    tm_p, _, _, wd_p = PLAIN[SEL_NAME](*args, return_wd=True)
    jac = key.jac[kidx.long()]
    differ = mask != topk_mask(wd_p, frac)
    kth = torch.sort(wd_p, dim=-1).values[..., k - 1:k]
    near = (wd_p - kth).abs() <= 2 * SEL_WD_GAP
    ordered = torch.sort(wd, dim=-1).values
    return dict(
        own=torch.equal(mask, topk_mask(wd, frac)),
        exact_k=bool((mask.sum(dim=-1) == k).all()),
        tmpl=torch.equal(tm, tm_p), jac_masked=sel_jac_masked(jm, jac, mask),
        gap=float((wd - wd_p).abs().max()),
        differ=int(differ.sum()), near=int((differ & near).sum()),
        unexplained=int((differ & ~near).sum()),
        hess_rel=sel_hess_rel(hess, jac, mask),
        symmetric=torch.equal(hess, hess.transpose(1, 2)),
        deterministic=again, plans=plans, k=k, n=n, rows=2 * bsz,
        tie_cuts=int((ordered[..., k - 1] == ordered[..., k]).sum())
        if k < n else 0, overflow=int((wd >= 256).sum()))


def sel_exact_passes(r) -> bool:
    return (r["own"] and r["exact_k"] and r["tmpl"] and r["jac_masked"]
            and r["gap"] <= SEL_WD_GAP and r["unexplained"] == 0
            and r["hess_rel"] <= SEL_HESS_BAR and r["symmetric"]
            and r["deterministic"] and r["plans"])


def sel_exact_row(r) -> str:
    return (f"mask = topk_mask(own wd) {r['own']}, exactly k = {r['k']} of "
            f"N = {r['n']} in all {r['rows']} rows {r['exact_k']}, tmpl "
            f"{r['tmpl']}, jac_masked {r['jac_masked']}, wd gap "
            f"{r['gap']:.3g}, masks != plain topk {r['differ']} (within "
            f"2^-9 of the row's k-th value {r['near']}, else "
            f"{r['unexplained']}), hess rel {r['hess_rel']:.3g}, symmetric "
            f"{r['symmetric']}, two launches {r['deterministic']}, clusters "
            f"1-8 {r['plans']}; rows cut inside a run of equal values "
            f"{r['tie_cuts']}, overflow {r['overflow']}")


def sel_exact_edges(edges):
    """The exact-count mode's edge inputs: phase SEL's (``sel_edges``) at
    the default count, and its ties, overflow and ragged inputs also at k
    = 1 (fraction 0), k = N (fraction 1) and k > N (fraction 1.5: every
    entry kept)."""
    out = [(name, topk_args(args)) for name, args in edges]
    for name, args in edges:
        if name.startswith(("ties", "overflow", "ragged")):
            out += [(f"{name}, fraction {f}", topk_args(args, f))
                    for f in (0.0, 1.0, 1.5)]
    return out


def sel_passes(r) -> bool:
    return (r["tmpl"] and r["jac_masked"] and r["gap"] <= SEL_WD_GAP
            and r["unexplained"] == 0 and r["hess_rel"] <= SEL_HESS_BAR
            and r["symmetric"] and r["deterministic"])


def sel_row(r) -> str:
    return (f"tmpl {r['tmpl']}, jac_masked {r['jac_masked']}, wd gap "
            f"{r['gap']:.3g}, masks != plain {r['differ']} (near an "
            f"integer {r['near']}, in rows with a moved bin {r['moved']}, "
            f"else {r['unexplained']}), hess rel {r['hess_rel']:.3g}, "
            f"symmetric {r['symmetric']}, deterministic "
            f"{r['deterministic']}; kept {r['kept']:.3f}, overflow "
            f"{r['overflow']} of {r['entries']}")


def sweep_preludes(dev):
    """Kernel J's calls in G1's sweep (27 combos x 32 frames, 864 items a
    level, one keep fraction per item): its align, un-captured, with a spy
    on the dispatcher."""
    from video_stabilizer_tpu_torch.apps import grid_search_align as gsa
    from video_stabilizer_tpu_torch.models.batch import align_clip_impl
    from video_stabilizer_tpu_torch.ops import prelude

    frames = synth_streams(dev, SWEEP_FRAMES, MAIN_CONTENT, seeds=[SEED])[0][0]
    gray = torch.from_numpy(gsa.host_gray(frames)).to(dev)
    base, _ = gsa.widened_aligner()
    dyn = gsa.dyn_params(gsa.combo_grid(), dev)
    with mock.patch.object(prelude, "level_prelude",
                           wraps=prelude.level_prelude) as spy:
        align_clip_impl(gray, base, WIDTH, HEIGHT, dyn=dyn)
    return [c.args for c in spy.call_args_list]


def sel_lobes(args):
    """An edge input from one level's call: the first keyframe's windows
    replaced by 255 under each tap of positive 2-D Lanczos2 weight and 0
    under the others at positions moved by half a pixel each way (the
    similarity's (0, 0, 0.5, 0.5), the homography's translation of 0.5 /
    width), 8 items on it, templates 0 and 255 in turn: diffs of up to
    about 320, many in the overflow bin."""
    from video_stabilizer_tpu_torch import transforms as T
    from video_stabilizer_tpu_torch.ops import gn8_solve, patches
    from video_stabilizer_tpu_torch.ops.keyframe import LevelKeyData
    spec, key, kidx, templates, tidx, transform, params, fraction, model = \
        args
    dev = key.windows.device
    one = LevelKeyData(*(f[:1].clone() for f in key))
    p = one.windows.shape[-1]
    ox, oy = patches.window_origins_flat(spec.ht, spec.wt, spec.tile,
                                         spec.margin, device=dev)
    if model == "similarity":
        t = torch.tensor([[0.0, 0.0, 0.5, 0.5]], device=dev)
        t_ul = T.center_to_ul(t, spec.width, spec.height)[:, None, None, :]
        rx, ry = patches.warp_rel_positions_flat(
            one.coords[:, 0], one.coords[:, 1], t_ul, ox, oy, p)
    else:
        t = torch.zeros((1, 8), device=dev)
        t[0, 2] = t[0, 5] = 0.5 / spec.width
        u, v = gn8_solve.normalized_keypoints(one, spec)
        rx, ry = gn8_solve.warp_rel_positions_h(
            t[:, None, None, :], u, v, spec.width, spec.height, ox, oy, p)
    win = torch.zeros_like(one.windows[0])            # (N, P, P)
    n = torch.arange(win.shape[0], device=dev)
    sign = (-1, 1, 1, -1)
    for s in range(2):
        x0 = torch.floor(rx[0, s]).long() - 1
        y0 = torch.floor(ry[0, s]).long() - 1
        for a in range(4):
            for b in range(4):
                win[n, y0 + a, x0 + b] = 255 if sign[a] * sign[b] > 0 else 0
    one.windows[0] = win
    items = 8
    frames = torch.zeros((2, spec.height, spec.width), dtype=torch.uint8,
                         device=dev)
    frames[1] = 255
    return (spec, one, torch.zeros(items, dtype=torch.int64, device=dev),
            frames, torch.arange(items, device=dev) % 2,
            t.expand(items, -1).contiguous(), params, fraction, model)


def sel_edges(sim_args, hom_args, ragged, dev):
    """Phase SEL's edge inputs: (name, call). From a 1080p and a 4K level's
    call: ties (zero windows, a flat template of 7: every diff 7), keep
    fractions 0 and 1 (and 1.5, -0.5) per item, the overflow bin
    (``sel_lobes``), positions pushed onto the clamp; and ragged N (a
    437x1033 chain's keyframes through the plain keyframe precompute)."""
    from video_stabilizer_tpu_torch.ops.keyframe import LevelKeyData
    keyframe_level_plain = PLAIN[KEY_NAME]
    out = []
    for args in (sim_args, hom_args):
        spec, key, kidx, templates, tidx, transform, params, _, model = args
        bsz = kidx.shape[0]
        fracs = torch.tensor([0.0, 1.0, 1.5, -0.5, 0.5], device=dev)[
            torch.arange(bsz, device=dev) % 5]
        zero = LevelKeyData(*key[:4], torch.zeros_like(key.windows))
        flat = torch.full_like(templates, 7)
        out.append((f"ties, {model}", (spec, zero, kidx, flat, tidx,
                                       transform, params, fracs, model)))
        out.append((f"fractions 0, 1, 1.5, -0.5, 0.5, {model}",
                    (spec, key, kidx, templates, tidx, transform, params,
                     fracs, model)))
        out.append((f"overflow, {model}", sel_lobes(args)))
        push = transform.clone()
        if model == "similarity":
            push[:, 0] += 0.05
            push[:, 2:] += torch.tensor([40.0, -40.0], device=dev)
        else:
            push[:, 2] += 40.0 / spec.width
            push[:, 5] -= 40.0 / spec.width
            push[:, 6] += 2e-3
        out.append((f"clamp, {model}", (spec, key, kidx, templates, tidx,
                                        push, params, 0.8, model)))
    frames, specs, params = ragged
    g = torch.Generator(device=dev).manual_seed(SEED)
    for model, rows in (("similarity", 4), (HOMOGRAPHY, 8)):
        for lvl in (0, len(specs) - 1):
            spec = specs[lvl]
            key = keyframe_level_plain(frames[lvl], spec, model)
            bsz = 5
            scale = torch.tensor([1e-3, 1e-3, 1.0, 1.0] if rows == 4 else
                                 [1e-3, 1e-3, 1.0 / spec.width, 1e-3, 1e-3,
                                  1.0 / spec.width, 1e-4, 1e-4], device=dev)
            t = (torch.rand((bsz, rows), generator=g, device=dev) * 2 - 1) \
                * scale
            kidx = torch.tensor([0, 1, 2, 1, 0], device=dev)
            tidx = torch.tensor([2, 0, 1, 1, 2], device=dev)
            out.append((f"ragged {spec.width}x{spec.height} (N = "
                        f"{spec.ht * spec.wt}), {model}",
                        (spec, key, kidx, frames[lvl], tidx, t, params,
                         torch.rand(bsz, generator=g, device=dev), model)))
    return out


@phase("SEL. kernel J: select's prelude vs its plain version (the 1080p "
       "and 4K chunks' levels, one streaming item, G1's 864 items, edge "
       "inputs)")
def check_prelude(calls_1080p, calls_4k, params, dev):
    """See SEL in the module's docstring. Returns the kernels line's
    entries of kernel J at the 1080p chunk (similarity) and the 4K chunk
    (homography)."""
    from video_stabilizer_tpu_torch.models.aligner import level_specs
    from video_stabilizer_tpu_torch.ops.prelude import (
        THREADS, kernel_attributes, launch_plan, level_prelude_kernel)
    from video_stabilizer_tpu_torch.ops.pyr_down import build_pyramid

    plain = PLAIN[SEL_NAME]
    worst, all_pass, plan_same = 0.0, True, True
    entries = {}
    slice0 = max(launch_plan(a[2].shape[0], a[0].ht * a[0].wt).slice
                 for a in calls_1080p + calls_4k)
    regs, smem, ctas = kernel_attributes(slice0)
    log(f"  kernel J's registers a thread (cudaFuncGetAttributes numRegs): "
        f"4x4 form {regs[0]}, 8x8 form {regs[1]}; static shared memory "
        f"{smem[0]} and {smem[1]} bytes; CTAs of {THREADS} threads an SM at "
        f"the chunks' largest slice ({slice0}): {ctas[0]} and {ctas[1]}")
    log("  kernel J | input | level | B (keyframes) x N | model | plan "
        "(cluster x slice) | bars | kernel ms | device ms | plain ms | "
        "bound ms (bytes) | sectors ms, (P, P, N) | sectors ms, (N, P, P) "
        "| device / bound")
    for what, calls, name, replaces in (
            ("(a) 1080p chunk", calls_1080p, SEL_ENTRY, SEL_REPLACES),
            ("(b) 4K chunk", calls_4k, SEL_H_ENTRY, SEL_H_REPLACES)):
        totals = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                      lane_ms=0.0, sector_ms=0.0)
        # The level loop runs coarse to fine; the table goes fine first.
        for args in sorted(calls, key=lambda a: -a[0].width):
            spec, key, kidx, *_, model = args
            keys = int(torch.unique(kidx).numel())
            r = sel_compare(args)
            ok = sel_passes(r)
            all_pass &= ok
            worst = max(worst, r["gap"])
            bsz, n = kidx.shape[0], spec.ht * spec.wt
            plan = launch_plan(bsz, n)
            ms = cuda_ms(lambda: level_prelude_kernel(*args), 50)
            device_ms = graph_ms(lambda: level_prelude_kernel(*args), 50)
            plain_ms = cuda_ms(lambda: plain(*args), 5)
            bound_ms, bound_by, lane_ms, sector_ms = sel_bound(args)
            # Every cluster size: the same bytes (the float64 Hessian sums
            # make the result the plan's no matter), and its device time.
            ref = level_prelude_kernel(*args)
            by_plan = []
            for c in (1, 2, 4, 8):
                pl = launch_plan(bsz, n, c)
                got = level_prelude_kernel(*args, plan=pl)
                plan_same &= all(torch.equal(x.view(torch.int32),
                                             y.view(torch.int32))
                                 for x, y in zip(got, ref))
                plan_ms = graph_ms(
                    lambda: level_prelude_kernel(*args, plan=pl), 20)
                by_plan.append(f"{c} x {pl.slice} {plan_ms:.4f}")
            del ref, got
            log(f"  {what} | {spec.width}x{spec.height} | {bsz} ({keys}) x "
                f"{n} | {model} | {plan.cluster} x {plan.slice} | "
                f"{'pass' if ok else 'FAIL'}: {sel_row(r)} | {ms:.4f} | "
                f"{device_ms:.4f} | {plain_ms:.3f} | {bound_ms:.4f} "
                f"({bound_by}) | {lane_ms:.4f} | {sector_ms:.4f} | "
                f"{device_ms / bound_ms:.2f} | device ms by cluster x slice: "
                + ", ".join(by_plan))
            for k, v in (("ms", ms), ("device_ms", device_ms),
                         ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                         ("lane_ms", lane_ms), ("sector_ms", sector_ms)):
                totals[k] += v
        log(f"  {what}, all {len(calls)} levels: kernel "
            f"{totals['ms']:.4f} ms, device {totals['device_ms']:.4f}, "
            f"plain {totals['plain_ms']:.3f}, bound {totals['bound_ms']:.4f}"
            f" (bytes; with the taps as 32-byte sectors "
            f"{totals['sector_ms']:.4f} in the keypoint-major windows, "
            f"{totals['lane_ms']:.4f} in (P, P, N) ones), device / bound "
            f"{totals['device_ms'] / max(totals['bound_ms'], 1e-12):.2f}, "
            f"device / sectors "
            f"{totals['device_ms'] / max(totals['sector_ms'], 1e-12):.2f}")
        entries[name] = dict(
            name=name, route="cuda",
            source="video_stabilizer_tpu_torch/csrc/prelude.cu",
            replaces=replaces, bound_by="bytes", library_ms=None,
            ms=totals["ms"], device_ms=totals["device_ms"],
            plain_ms=totals["plain_ms"], bound_ms=totals["bound_ms"])

    others = [(f"(c) one streaming item, {a[0].width}x{a[0].height}",
               sel_one_item(a))
              for a in sorted(calls_1080p, key=lambda a: -a[0].width)]
    sweep = sweep_preludes(dev)
    check(len(sweep) == len(calls_1080p) and all(
        isinstance(a[7], torch.Tensor) and a[7].shape == a[2].shape
        for a in sweep), f"G1's sweep: {len(sweep)} kernel J calls, each "
          "with one keep fraction per item")
    others += [(f"(d) G1's sweep, {a[0].width}x{a[0].height}, "
                f"{a[2].shape[0]} items", a)
               for a in sorted(sweep, key=lambda a: -a[0].width)]
    del sweep
    by_width = {a[0].width: a for a in calls_1080p}
    by_width_4k = {a[0].width: a for a in calls_4k}
    ragged_specs = level_specs(RAGGED[2], RAGGED[1], params.aligner)
    frames = torch.randint(0, 256, RAGGED, dtype=torch.uint8, device=dev,
                           generator=torch.Generator(dev).manual_seed(SEED))
    frames = build_pyramid(frames, len(ragged_specs))
    edges = sel_edges(
        by_width[min(by_width, key=lambda w: abs(w - 480))],
        by_width_4k[min(by_width_4k, key=lambda w: abs(w - 480))],
        (frames, ragged_specs, params.aligner), dev)
    others += [(f"(e) {name}", args) for name, args in edges]
    one_frame_ms = 0.0
    for what, args in others:
        r = sel_compare(args)
        ok = sel_passes(r)
        all_pass &= ok
        worst = max(worst, r["gap"])
        if what.startswith("(e) overflow"):
            ok &= r["overflow"] > 0
            check(r["overflow"] > 0, f"{what}: {r['overflow']} diffs at or "
                  "above 256")
        timed_ms = ""
        if what.startswith("(c)"):
            ms = graph_ms(lambda: level_prelude_kernel(*args), 50)
            one_frame_ms += ms
            timed_ms = f" | device {ms:.4f} ms"
        log(f"  {what} | {'pass' if ok else 'FAIL'}: {sel_row(r)}"
            + timed_ms)
        torch.cuda.empty_cache()
    log(f"  (c) one streaming item, all {len(calls_1080p)} levels: device "
        f"{one_frame_ms:.4f} ms")
    check(plan_same, "kernel J gives the same bytes under every cluster "
          "size (1, 2, 4, 8) at every level of both chunks")
    check(all_pass, "kernel J against its plain version at every input: "
          "tmpl bit-equal, jac_masked = jac * mask of its own wd bit for "
          f"bit, wd within {SEL_WD_GAP:.3g} (largest {worst:.3g}), every "
          "differing mask entry near an integer or in a row with a moved "
          f"bin, Hessian within {SEL_HESS_BAR:.3g} of a float64 sum, "
          "symmetric, two launches byte-equal")
    log("  kernel J's library: none (no single PyTorch call computes "
        "select's prelude)")
    for entry in entries.values():
        entry["max_abs_err"] = worst
    others = [(what, args) for what, args in others
              if not what.startswith("(e)")]
    topk = check_prelude_exact(calls_1080p, calls_4k, others, edges)
    return entries.get(SEL_ENTRY), entries.get(SEL_H_ENTRY), topk


def check_prelude_exact(calls_1080p, calls_4k, others, edges):
    """Phase SEL's exact-count mode: every input of the histogram mode's
    part under ``selection="topk"`` (``sel_exact_compare``), the edges at
    k = 1, N and above N too; per level of (a) and (b) the wrapper, the
    device time beside the histogram mode's, each cluster size's, the
    plain ``topk`` prelude, ``topk_mask`` alone on the kernel's warp diffs
    and the byte bound. Returns the kernels line's entry of the mode at the
    1080p chunk (the 9T path's)."""
    from video_stabilizer_tpu_torch.ops.prelude import (
        THREADS, kernel_attributes, launch_plan, level_prelude_kernel)
    from video_stabilizer_tpu_torch.ops.select import topk_mask

    plain = PLAIN[SEL_NAME]
    worst, all_pass = 0.0, True
    slice0 = max(launch_plan(a[2].shape[0], a[0].ht * a[0].wt,
                             exact=True).slice for a in calls_1080p + calls_4k)
    regs, smem, ctas = kernel_attributes(slice0, exact=True)
    log(f"  exact-count mode (selection=\"topk\"): registers a thread 4x4 "
        f"form {regs[0]}, 8x8 form {regs[1]}; static shared memory "
        f"{smem[0]} and {smem[1]} bytes; CTAs of {THREADS} threads an SM at "
        f"the chunks' largest slice ({slice0}): {ctas[0]} and {ctas[1]}")
    log("  kernel J[topk] | input | level | B x N | plan | bars | kernel ms "
        "| device ms | histogram mode's device ms | plain topk ms | "
        "topk_mask alone ms | bound ms (bytes) | device / bound | device "
        "ms by cluster x slice")
    totals = {chunk: dict(ms=0.0, device_ms=0.0, mask_ms=0.0, plain_ms=0.0,
                          select_ms=0.0, bound_ms=0.0) for chunk in "ab"}
    timed = [("(a) 1080p chunk", a) for a in sorted(
        calls_1080p, key=lambda a: -a[0].width)]
    timed += [("(b) 4K chunk", a) for a in sorted(
        calls_4k, key=lambda a: -a[0].width)]
    timed += [(what, a) for what, a in others if what.startswith("(d)")]
    for what, mask_args in timed:
        args = topk_args(mask_args)
        spec, key, kidx = args[:3]
        bsz, n = kidx.shape[0], spec.ht * spec.wt
        r = sel_exact_compare(args)
        ok = sel_exact_passes(r)
        all_pass &= ok
        worst = max(worst, r["gap"])
        plan = launch_plan(bsz, n, exact=True)
        by_plan = []
        for c in (1, 2, 4, 8):
            pl = launch_plan(bsz, n, c, exact=True)
            plan_ms = graph_ms(
                lambda: level_prelude_kernel(*args, plan=pl), 20)
            by_plan.append(f"{c} x {pl.slice} {plan_ms:.4f}")
        row = f"  {what} | {spec.width}x{spec.height} | {bsz} x {n} | " \
              f"{plan.cluster} x {plan.slice} | " \
              f"{'pass' if ok else 'FAIL'}: {sel_exact_row(r)}"
        if what.startswith("(d)"):
            log(f"{row} | device ms by cluster x slice: " + ", ".join(
                by_plan))
            torch.cuda.empty_cache()
            continue
        ms = cuda_ms(lambda: level_prelude_kernel(*args), 50)
        device_ms = graph_ms(lambda: level_prelude_kernel(*args), 50)
        mask_ms = graph_ms(lambda: level_prelude_kernel(*mask_args), 50)
        plain_ms = cuda_ms(lambda: plain(*args), 5)
        wd = level_prelude_kernel(*args, return_wd=True)[3]
        frac = args[6].smallest_fraction
        select_ms = cuda_ms(lambda: topk_mask(wd, frac), 20)
        del wd
        bound_ms, _, _, _ = sel_bound(args)
        log(f"{row} | {ms:.4f} | {device_ms:.4f} | {mask_ms:.4f} | "
            f"{plain_ms:.3f} | {select_ms:.4f} | {bound_ms:.4f} | "
            f"{device_ms / bound_ms:.2f} | " + ", ".join(by_plan))
        for k, v in (("ms", ms), ("device_ms", device_ms),
                     ("mask_ms", mask_ms), ("plain_ms", plain_ms),
                     ("select_ms", select_ms), ("bound_ms", bound_ms)):
            totals[what[1]][k] += v
    for chunk, what, calls in (("a", "(a) 1080p chunk", calls_1080p),
                               ("b", "(b) 4K chunk", calls_4k)):
        t = totals[chunk]
        log(f"  {what}, all {len(calls)} levels, exact-count mode: kernel "
            f"{t['ms']:.4f} ms, device {t['device_ms']:.4f} (histogram mode "
            f"{t['mask_ms']:.4f}: "
            f"{t['device_ms'] / max(t['mask_ms'], 1e-12):.2f}x), plain topk "
            f"{t['plain_ms']:.3f}, topk_mask alone {t['select_ms']:.4f}, "
            f"bound {t['bound_ms']:.4f} (bytes), device / bound "
            f"{t['device_ms'] / max(t['bound_ms'], 1e-12):.2f}")
    totals = totals["a"]
    g1 = max((a for what, a in others if what.startswith("(d)")),
             key=lambda a: a[0].width, default=None)
    if g1 is not None:
        # What the cap on the slice (EXACT_MAX_SLICE) keeps the mode from.
        n = g1[0].ht * g1[0].wt
        regs, smem, ctas = kernel_attributes(n, exact=True)
        log(f"  exact-count mode at G1's level 0 uncapped (one CTA an item, "
            f"slice {n}, {8 * n} bytes of dynamic shared memory): CTAs an "
            f"SM {ctas[0]} and {ctas[1]}")
    for what, args in [(w, topk_args(a)) for w, a in others
                       if w.startswith("(c)")] + [
            (f"(e) {name}", args) for name, args in sel_exact_edges(edges)]:
        r = sel_exact_compare(args)
        ok = sel_exact_passes(r)
        if what.startswith("(e) overflow"):
            ok &= r["overflow"] > 0
        if what.startswith("(e) ties") and r["k"] < r["n"]:
            ok &= r["tie_cuts"] == r["rows"]
        all_pass &= ok
        worst = max(worst, r["gap"])
        log(f"  {what} | {'pass' if ok else 'FAIL'}: {sel_exact_row(r)}")
        torch.cuda.empty_cache()
    check(all_pass, "kernel J's exact-count mode at every input, both "
          "models: its mask topk_mask's of its own wd bit for bit, exactly k "
          "kept in every row, tmpl bit-equal, jac_masked = jac * mask bit "
          f"for bit, wd within {SEL_WD_GAP:.3g} (largest {worst:.3g}), "
          "every mask entry that differs from the plain topk prelude's "
          f"within {2 * SEL_WD_GAP:.3g} of its row's k-th value, Hessian "
          f"within {SEL_HESS_BAR:.3g} of a float64 sum, symmetric, two "
          "launches and clusters 1-8 byte-equal; the ties input cut inside "
          "its run of 7s in every row, the overflow input above 256")
    log("  kernel J[topk]'s library: none (no single PyTorch call computes "
        f"select's prelude); topk_mask's sort and scatter alone "
        f"{totals['select_ms']:.4f} ms over the 1080p chunk's levels")
    return dict(name=SEL_TOPK_ENTRY, route="cuda",
                source="video_stabilizer_tpu_torch/csrc/prelude.cu",
                replaces=SEL_REPLACES, bound_by="bytes", library_ms=None,
                max_abs_err=worst, ms=totals["ms"],
                device_ms=totals["device_ms"], plain_ms=totals["plain_ms"],
                bound_ms=totals["bound_ms"])


def drive_path(frames, params, dev, model="similarity"):
    """Drive a chunked path over every chunk of ``frames`` (S, T, H, W, 3)
    from a fresh state, twice: un-captured (``graphs.eager()``) under a
    span Recorder, for the per-stage device times; then through the entry
    point, which on the card replays the captured chunk (its first call
    captures), with every launch count set to 0 just before and read just
    after. Checks each replayed chunk's output; prints both runs' chunk
    times, frames/s, peak memory and the stage table. Returns (launch
    counts, meas (S, T, P), ok (S, T), states, last chunk, stages)."""
    from video_stabilizer_tpu_torch.models import chunked
    from video_stabilizer_tpu_torch.utils import graphs
    from video_stabilizer_tpu_torch.utils.spans import Recorder

    streams, total, height, width = frames.shape[:4]
    # Each chunk arrives in its own pinned host buffer, as a server's
    # decoder would leave it; filling the buffers is set-up, not timed.
    chunks = [torch.from_numpy(np.ascontiguousarray(
        frames[:, c:c + CHUNK])).pin_memory()
        for c in range(0, total, CHUNK)]

    # The stages, from the un-captured chunk: a replay runs no span.
    states = chunked.init_stream_state(width, height, params, 3, streams,
                                       dev, model=model)
    eager_walls, stage_runs = [], []
    with graphs.eager():
        for chunk in chunks:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with Recorder() as rec:
                states = chunked.stabilize_chunk_streams(states, chunk,
                                                         params, model)[0]
            torch.cuda.synchronize()
            eager_walls.append((time.perf_counter() - t0) * 1e3)
            stage_runs.append(rec.totals())

    states = chunked.init_stream_state(width, height, params, 3, streams,
                                       dev, model=model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    walls, device_ms, metas, succs = [], [], [], []
    for c, chunk in enumerate(chunks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        states, out, meas, succ, valid = chunked.stabilize_chunk_streams(
            states, chunk, params, model)
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        device_ms.append(start.elapsed_time(end))
        crop = 2 * params.crop_pixels
        check(tuple(out.shape) == (streams, CHUNK, height - crop,
                                   width - crop, 3)
              and out.dtype == torch.uint8,
              f"chunk {c}: output {tuple(out.shape)} {out.dtype}")
        expect_valid = np.arange(c * CHUNK, (c + 1) * CHUNK) >= params.lag
        check(bool((valid.cpu().numpy() == expect_valid[None]).all()),
              f"chunk {c}: the first {params.lag} outputs of the stream "
              "are marked invalid, the rest valid")
        check(bool(out.any()), f"chunk {c}: output not blank")
        metas.append(meas.cpu().numpy())
        succs.append(succ.cpu().numpy())
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prog = chunked._stabilize_chunk_streams_jit
    check(prog.replays == len(chunks) - 1,
          f"the entry point replayed the captured chunk {prog.replays} "
          f"times (want {len(chunks) - 1}: the first call captures)")

    log("  chunk wall through the entry point (host clock, synchronized; "
        "chunk 0 runs eagerly and captures): "
        + ", ".join(f"{w:.1f}" for w in walls) + " ms")
    log(f"  the same chunks on the device timeline (CUDA events): "
        + ", ".join(f"{w:.1f}" for w in device_ms) + " ms")
    log("  un-captured chunks (graphs.eager(), under the span recorder): "
        + ", ".join(f"{w:.1f}" for w in eager_walls) + " ms")
    steady = walls[1:]
    fps = streams * CHUNK / (np.mean(steady) / 1e3)
    log(f"  steady chunk {np.mean(steady):.1f} ms = {fps:.1f} frames/s "
        f"(replays, mean of chunks 1-{len(chunks) - 1}; un-captured "
        f"{np.mean(eager_walls[1:]):.1f} ms); peak device memory "
        f"{peak_gb:.2f} GB (the graph's pool included)")
    names = list(stage_runs[0])
    mean = {k: float(np.mean([r.get(k, 0.0) for r in stage_runs[1:]]))
            for k in names}
    log(f"  stage device times of the un-captured chunk, mean of chunks "
        f"1-{len(chunks) - 1} (CUDA events):")
    for k in names:
        log(f"    {k:<22} {mean[k]:9.3f} ms")
    log(f"    {'sum of stages':<22} {sum(mean.values()):9.3f} ms")
    log(f"  the un-captured keyframe span {mean.get('keyframe', 0.0):.3f} ms "
        f"(kernel I a launch a level, the carried keyframes concatenated: "
        f"{KEY_SPAN_BEFORE[model]} ms)")
    log(f"  launches: {launches}")
    ok = np.concatenate(succs, axis=1)
    rate = float(ok.mean())
    check(rate >= 0.9, f"align success rate {rate:.4f} "
          f"({int(ok.sum())} of {ok.size}; each stream's first frame has "
          "nothing to align to)")
    mean["steady chunk (host clock)"] = float(np.mean(steady))
    mean["un-captured chunk (host clock)"] = float(np.mean(eager_walls[1:]))
    return (launches, np.concatenate(metas, axis=1), ok, states, chunks[-1],
            mean)


@phase("main path: 1080p similarity, 8 streams x 16-frame chunks, carried "
       "state")
def main_path(frames, poses, params, dev):
    launches, meas, ok, states, last, stages = drive_path(frames, params,
                                                          dev)
    check(launches.get("warp_frames[similarity,bilinear]", 0) > 0
          and launches["gn_solve"] > 0 and launches["tvl1_smooth"] > 0,
          "kernel A (similarity, bilinear), kernel B and kernel D launched")
    path_checks_e_f(launches, "gn_solve", CHUNKS)
    path_checks_g_h(launches, CHUNKS, path_levels(WIDTH, HEIGHT, params),
                    "one conversion and one pyramid a chunk")
    path_checks_i(launches, CHUNKS)
    known_motion_checks(meas, ok, poses)
    return launches, states, last, stages


def path_checks_e_f(launches, gn: str, chunks: int):
    """Kernel E and kernel J once per level (as the GN kernel ``gn``) and
    kernel F once per chunk on a chunked path."""
    check(launches[PINV_NAME] == launches[gn] > 0
          and launches[ACCUM_NAME] == chunks,
          f"kernel E launched {launches[PINV_NAME]} times (once per level: "
          f"{gn} {launches[gn]}), kernel F {launches[ACCUM_NAME]} (once per "
          f"chunk: {chunks})")
    check(launches[SEL_NAME] == launches[gn],
          f"kernel J launched {launches[SEL_NAME]} times (want "
          f"{launches[gn]}: once per level of every chunk, as {gn})")


def path_levels(width, height, params) -> int:
    """The aligner's pyramid levels at a frame size."""
    from video_stabilizer_tpu_torch.models.aligner import level_specs
    return len(level_specs(width, height, params.aligner))


def path_checks_g_h(launches, calls: int, levels: int, what: str):
    """Kernel G once per conversion and kernel H once per pyramid level
    below the first, over ``calls`` conversions (``what``)."""
    want_h = calls * (levels - 1)
    check(launches[GRAY_NAME] == calls and launches[PYR_NAME] == want_h,
          f"kernel G launched {launches[GRAY_NAME]} times and kernel H "
          f"{launches[PYR_NAME]} (want {calls} and {want_h}: {what}, "
          f"{levels - 1} levels below the first)")


def path_checks_i(launches, chunks: int):
    """Kernel I once per chunk (``align_pairs``: all the chunk's keyframes
    at every level in one launch). ``drive_path`` builds the fresh state,
    whose zero carry takes one more launch, before it sets the counts to
    0."""
    check(launches[KEY_NAME] == chunks,
          f"kernel I launched {launches[KEY_NAME]} times (want {chunks}: "
          "once per chunk, every level of its keyframes in one launch; the "
          "zero carry's ran before the counts were set to 0)")


def known_motion_checks(meas, ok, poses):
    """Phase 9's bars on a translation-only 1080p clip's measurements."""
    # Motion from frame t-1 to t of a translation-only clip is minus the
    # window offset step. The bars allow for the clip's own bias: each
    # bilinear crop blurs its frame by its own sub-pixel phase. On such a
    # clip (270x480, jitter 1 px, 11 frames, on the CPU) the JAX package's
    # aligner is off by RMS 0.10 px and at most 0.19 px, the port's by
    # 0.11 and 0.19.
    rms, max_err = known_motion_error(meas[..., 2:], ok, poses)
    check(max_err < 0.5 and rms < 0.2,
          f"measured TX/TY against the clip's known motion: RMS {rms:.4f} "
          f"px, max {max_err:.4f} px")
    ab = float(np.abs(meas[..., :2][ok]).max())
    check(ab < 2e-3, f"measured |A|,|B| on a translation-only clip: {ab:.2e}")


@phase("4K homography path: 2 streams x 16-frame chunks, carried state")
def main_path_4k(frames, poses, params, dev):
    launches, meas, ok, states, last, stages = drive_path(
        frames, params, dev, HOMOGRAPHY)
    check(launches["gn8_solve"] > 0
          and launches.get("warp_frames[homography,lanczos2]", 0) > 0
          and launches["tvl1_smooth"] > 0 and launches["gn_solve"] == 0,
          "kernel C, kernel A (homography, Lanczos2) and kernel D launched, "
          "kernel B not")
    path_checks_e_f(launches, "gn8_solve", CHUNKS_4K)
    path_checks_g_h(launches, CHUNKS_4K, path_levels(W4K, H4K, params),
                    "one conversion and one pyramid a chunk")
    path_checks_i(launches, CHUNKS_4K)
    # The normalized translation (p2, p5) times W is the motion in px at
    # the frame centre. On such a clip (270x480, jitter 1 px, pan 0.3,
    # seeds 5 and 6, 12 frames, on the CPU) the JAX package's 8-DOF aligner
    # is off by RMS 0.033 px and at most 0.080 px, the port's by 0.036 and
    # 0.107; its |p0,p1,p3,p4| reach 8.3e-4 and |p6,p7| 1.4e-3.
    rms, max_err = known_motion_error(meas[..., [2, 5]] * W4K, ok, poses)
    check(max_err < 0.3 and rms < 0.1,
          f"measured p2*W, p5*W against the clip's known motion: RMS "
          f"{rms:.4f} px, max {max_err:.4f} px")
    lin = float(np.abs(meas[..., [0, 1, 3, 4]][ok]).max())
    persp = float(np.abs(meas[..., 6:][ok]).max())
    check(lin < 2e-3 and persp < 3e-3,
          f"measured |p0,p1,p3,p4| {lin:.2e}, |p6,p7| {persp:.2e} on a "
          "translation-only clip")
    return launches, states, last, stages


@phase("device busy share of one more chunk, replayed (torch.profiler)")
def profile_chunk(states, chunk, params, model="similarity"):
    from video_stabilizer_tpu_torch.models import chunked

    # The first call captures; the profiled one replays (the entry point
    # leaves its input state as it was).
    chunked.stabilize_chunk_streams(states, chunk, params, model)
    span_ms, by_name = device_events(
        lambda: chunked.stabilize_chunk_streams(states, chunk, params,
                                                model), 1)
    busy = sum(ms for ms, _ in by_name.values())
    if busy <= 0:
        log("  the profiler recorded no device time: busy share not "
            "measured")
        return
    log(f"  chunk {span_ms:.1f} ms on the device timeline (under the "
        f"profiler), kernels and copies {busy:.1f} ms: busy "
        f"{busy / span_ms * 100:.1f} %, idle "
        f"{(1 - busy / span_ms) * 100:.1f} %")
    log("  top device time by kernel:")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (ms, count) in top:
        log(f"    {ms:9.3f} ms  {count:6d}x  {name[:70]}")


def device_events(run, reps):
    """(span ms, {name: [ms, count]}) of ``reps`` calls of ``run()`` under
    torch.profiler (CUDA activity), from its raw device events: kernels,
    copies and memsets, each counted once. (The profiler's
    ``key_averages`` also gives each launching operator its kernels' time,
    so a sum over its rows counts a kernel twice.)"""
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(reps):
            run()
        end.record()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            row = by_name.setdefault(e.name(), [0.0, 0])
            row[0] += e.duration_ns() / 1e6
            row[1] += 1
    return start.elapsed_time(end), by_name


J_STEADY = {"similarity": 20, HOMOGRAPHY: 8}   # J1's and J2's replays
J_PROFILED = 3                                 # replays under the profiler
J_OUTPUTS = ("outputs", "meas", "succ", "valid")
# A replay's DtoD copies while the chunk programs copied their state in and
# cloned it out at every call (this script's J1 and J2 then): the figure a
# donated replay's is read against.
J_DTOD_BEFORE = {"similarity": "1.50 ms", HOMOGRAPHY: "1.50-1.58 ms"}


def leaves_equal(a, b) -> bool:
    from video_stabilizer_tpu_torch.parallel.mesh import tensor_leaves
    la, lb = tensor_leaves(a), tensor_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


_KEYPOINT_MAJOR = []


def keypoint_major_windows() -> bool:
    """Whether the imported package keeps its keyframe windows
    keypoint-major, (..., N, P, P), or as the JAX package does, (..., P,
    P, N): a probe of its plain window extraction (N = 6, P = 4)."""
    if not _KEYPOINT_MAJOR:
        from video_stabilizer_tpu_torch.ops.patches import (
            extract_tile_windows_flat)
        shape = extract_tile_windows_flat(
            torch.zeros((1, 6, 4), dtype=torch.uint8), 2, 1).shape
        _KEYPOINT_MAJOR.append(tuple(shape[-3:]) == (6, 4, 4))
    return _KEYPOINT_MAJOR[0]


def tree_digest(tree) -> str:
    """sha256 of every tensor, array and scalar of ``tree`` in order (its
    dtype, shape and bytes), keyframe windows (a ``windows`` field) as (...,
    P, P, N) whatever layout the package keeps, so that two packages that
    differ only in the windows' layout give the same digest."""
    import hashlib
    h = hashlib.sha256()
    major = keypoint_major_windows()

    def walk(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().contiguous()
            h.update(f"{x.dtype}{tuple(x.shape)}".encode())
            h.update(x.view(torch.uint8).numpy().tobytes()
                     if x.numel() else b"")
        elif isinstance(x, np.ndarray):
            x = np.ascontiguousarray(x)
            h.update(f"{x.dtype}{x.shape}".encode() + x.tobytes())
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            for name in x._fields:
                v = getattr(x, name)
                if name == "windows" and major:
                    v = v.movedim(-3, -1)
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        else:
            h.update(repr(x).encode())
    walk(tree)
    return h.hexdigest()


def log_digest(tag: str, what: str, tree):
    log(f"  digest {tag}: sha256 {tree_digest(tree)} ({what}; windows as "
        "(P, P, N))")


def within_bars(name, got, want) -> bool:
    """The bars of phases 9 and 10 for an output on which the un-captured
    path is not deterministic itself: outputs within 1 LSB on >= 99.9 %,
    measurements within 1e-3, flags equal."""
    if name == "outputs":
        d = (got.to(torch.int16) - want.to(torch.int16)).abs()
        return int(d.max()) <= 1 and float((d == 0).float().mean()) >= 0.999
    if name == "meas":
        return float((got - want).abs().max()) <= 1e-3
    return bool(torch.equal(got, want))


def captured_vs_eager(frames, params, dev, model="similarity", tag="J1"):
    """J1 / J2: the chunks of ``frames`` through the chunk program as a
    serving loop calls it, donating its state (each call's state fed to
    the next), against the un-captured path (``graphs.eager()``) run twice
    on a copy of the state taken before each donated call, on the same
    pinned inputs; then the replay's steady time, capture cost, memory,
    copies, device-busy share and launches per replay, and (J1) two chains
    in turn and the refusal of an advanced state. A package whose programs
    do not donate (``--package-root`` on an older tree) runs the same
    chain through ``stabilize_chunk_streams``."""
    from video_stabilizer_tpu_torch.models import chunked
    from video_stabilizer_tpu_torch.parallel.mesh import tensor_leaves
    from video_stabilizer_tpu_torch.utils import graphs

    prog = chunked._stabilize_chunk_streams_jit
    donating = bool(getattr(prog, "donate_argnames", ()))
    streams, total, height, width = frames.shape[:4]
    chunks = [torch.from_numpy(np.ascontiguousarray(
        frames[:, c:c + CHUNK])).pin_memory()
        for c in range(0, total, CHUNK)]

    def fresh():
        return chunked.init_stream_state(width, height, params, 3, streams,
                                         dev, model=model)

    def step(states, chunk):
        if donating:
            return prog(states, chunk, params, width, height, model)
        return chunked.stabilize_chunk_streams(states, chunk, params, model)

    graphs.reset([prog])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    reset_launch_counts()
    states, got = fresh(), []
    befores = [tree_to(states, "cpu", True)]   # the state before each call
    for c, chunk in enumerate(chunks):
        states, *res = step(states, chunk)
        got.append(res)
        befores.append(tree_to(states, "cpu", True))
        if c == 0:
            first = [x.clone() for x in res]
    torch.cuda.synchronize()
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    how = "donated" if donating else "copied in and cloned out"
    check(prog.captures == 1 and prog.replays == len(chunks) - 1,
          f"{prog.captures} capture, {prog.replays} replays over "
          f"{len(chunks)} chunks (the first call captures; the state {how})")
    in_static = {x.untyped_storage().data_ptr()
                 for e in prog._cache.values() for x in e.static_in
                 if x is not None}
    held = {x.untyped_storage().data_ptr() for x in tensor_leaves(states)}
    log(f"  the state a call returns lies in the key's static inputs: "
        f"{held <= in_static}")
    if donating:
        check(held <= in_static, "the donated chain's state is the key's "
              "static inputs, returned uncloned")
    log_digest(tag, f"{len(chunks)} replayed chunks' outputs, meas, succ, "
               "valid and the carried state", (got, states))

    # The reference: the un-captured path twice on a copy of each call's
    # starting state (an output in which it differs from itself is held to
    # phase 9's / 10's bars instead).
    eager, eager_walls = [], []
    for c, chunk in enumerate(chunks):
        runs = []
        for k in range(2):
            copy = tree_to(befores[c], dev, True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with graphs.eager():
                st, *res = step(copy, chunk)
            torch.cuda.synchronize()
            if c or k:
                eager_walls.append((time.perf_counter() - t0) * 1e3)
            runs.append((tree_to(st, "cpu"), res))
            del copy, st
        eager.append(runs)
    unstable = [name for i, name in enumerate(J_OUTPUTS)
                if not all(torch.equal(a[1][i], b[1][i]) for a, b in eager)]
    if not all(leaves_equal(a[0], b[0]) for a, b in eager):
        unstable.append("state")
    log(f"  the un-captured path run twice from each call's state: "
        + (f"not deterministic in {unstable}" if unstable
           else "byte-equal in outputs, meas, succ, valid and state"))
    for i, name in enumerate(J_OUTPUTS):
        pairs = [(g[i], w[0][1][i]) for g, w in zip(got, eager)]
        if name in unstable:
            check(all(within_bars(name, g, w) for g, w in pairs),
                  f"{name}: within phase 9's / 10's bars of the un-captured "
                  "path (which is not deterministic there itself)")
        else:
            check(all(torch.equal(g, w) for g, w in pairs),
                  f"{name} of {len(chunks)} chunks byte-equal to the "
                  "un-captured path")
    if "state" not in unstable:
        check(all(leaves_equal(b, w[0][0])
                  for b, w in zip(befores[1:], eager)),
              f"the state after each of the {len(chunks)} calls "
              f"({len(tensor_leaves(states))} tensors) byte-equal to the "
              "un-captured path's")
    check(all(torch.equal(a, b) for a, b in zip(first, got[0])),
          "chunk 0's returned outputs unchanged after chunks 1-"
          f"{len(chunks) - 1} ran")
    del got, eager, befores, first
    stats = prog.stats()[0]
    log(f"  capture: first call {stats['first_call_s']:.2f} s (eager "
        f"{stats['eager_s']:.2f} s, capture {stats['capture_s']:.2f} s, "
        f"instantiate {stats['instantiate_s']:.2f} s); graph pool "
        f"{stats['pool_bytes'] / 1e9:.2f} GB; peak device memory "
        f"{peak_gb:.2f} GB ({base_gb:.2f} GB held before the run); static "
        f"inputs {stats['static_in_bytes'] / 1e9:.3f} GB, static outputs "
        f"{stats['static_out_bytes'] / 1e9:.3f} GB (the state "
        f"{graphs.storage_nbytes(tensor_leaves(states)) / 1e9:.3f} GB)")
    per_replay = {(f"{k[0]}[{','.join(k[1])}]" if k[1] else k[0]): n
                  for k, n in stats["launches_per_replay"].items()}
    log(f"  launches per replay {per_replay}; this run's counts {launches}")
    gn = "gn_solve" if model == "similarity" else "gn8_solve"
    check(per_replay.get("tvl1_smooth_kernel", 0) == 1
          and per_replay.get("regularized_pinv_sym4_kernel", 0)
          == per_replay.get(gn, -1)
          and per_replay.get("accum_scan_kernel", 0) == 1,
          "kernel D launched once in every replay (the chunk's smoother), "
          f"kernel E once per level (as {gn}), kernel F once (the chunk's "
          "accumulator)")
    check(per_replay.get("bgr_to_gray_kernel", 0) == 1
          and per_replay.get("pyr_down_kernel", 0)
          == per_replay.get(gn, 0) - 1 > 0,
          "kernel G launched once in every replay (the chunk's gray), "
          f"kernel H once per level below the first ({gn} less one)")
    check(per_replay.get("keyframe_levels_kernel", 0) == 1,
          "kernel I launched once in every replay (the chunk's keyframes, "
          "every level; the zero carry is the state's)")
    check(per_replay.get("level_prelude_kernel", 0)
          == per_replay.get(gn, -1),
          f"kernel J launched once per level in every replay (as {gn})")

    n = J_STEADY[model]
    walls = []
    for k in range(n):
        t0 = time.perf_counter()
        states = step(states, chunks[k % len(chunks)])[0]
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    walls = np.asarray(walls)
    med, med_e = float(np.median(walls)), float(np.median(eager_walls))
    spread = (walls.max() - walls.min()) / med * 100
    log(f"  replayed chunk, host clock, each synchronized, {n} chunks: "
        f"median {med:.2f} ms, min {walls.min():.2f}, max {walls.max():.2f}, "
        f"spread (max - min) / median {spread:.1f} % = "
        f"{streams * CHUNK / med * 1e3:.1f} frames/s; "
        f"un-captured, same phase, {len(eager_walls)} chunks: median "
        f"{med_e:.1f} ms, min {min(eager_walls):.1f}, max "
        f"{max(eager_walls):.1f} ({med_e / med:.2f}x)")

    def replay():
        nonlocal states
        states = step(states, chunks[0])[0]
    span, by_name = device_events(replay, J_PROFILED)
    busy = sum(ms for ms, _ in by_name.values())
    events = sum(n for _, n in by_name.values())
    copies = {}
    for name, (ms, _) in by_name.items():
        if name.startswith("Memcpy"):
            kind = name.split(" (")[0]
            copies[kind] = copies.get(kind, 0.0) + ms
    if busy > 0:
        log(f"  {J_PROFILED} replays under torch.profiler: {span:.1f} ms on "
            f"the device timeline, {events} device events, busy "
            f"{busy:.1f} ms = {busy / span * 100:.1f} % (the profiler slows "
            f"the replay; its device events, {busy / J_PROFILED:.1f} ms a "
            f"replay, are {busy / J_PROFILED / med * 100:.1f} % of the "
            f"unprofiled median); copies per replay "
            + ", ".join(f"{k} {v / J_PROFILED:.2f} ms"
                        for k, v in sorted(copies.items()))
            + f" (the state {how}; copied in and cloned out, a replay "
              f"read {J_DTOD_BEFORE[model]} of DtoD on an NVIDIA H100 80GB "
              "HBM3 at 700 W)")
    else:
        log("  the profiler recorded no device time: busy share not "
            "measured")
    if donating and model == "similarity":
        chains_in_turn(step, fresh, chunks, states)
    return dict(median=med, eager=med_e, walls=walls)


def chains_in_turn(step, fresh, chunks, states):
    """J1's donation checks: a state that a later call has advanced is
    refused, and two chains of one key fed in turn (phase 9's streams, and
    the same streams in reverse order) each give byte for byte what they
    give alone."""
    stale = states
    states = step(states, chunks[1])[0]
    try:
        step(stale, chunks[1])
        refused = "no error"
    except RuntimeError as err:
        refused = str(err)
    check("already advanced" in refused,
          f"a state passed again after a later call advanced it is refused "
          f"({refused[:120]})")
    del stale, states
    flipped = [c.flip(0).contiguous().pin_memory() for c in chunks[:2]]
    alone = []
    for feed in (chunks[:2], flipped):
        st, outs = fresh(), []
        for chunk in feed:
            st, *res = step(st, chunk)
            outs.append(res)
        alone.append((tree_to(st, "cpu", True), outs))
        del st
    a, b, got_a, got_b = fresh(), fresh(), [], []
    for c in range(2):
        a, *res_a = step(a, chunks[c])
        b, *res_b = step(b, flipped[c])
        got_a.append(res_a)
        got_b.append(res_b)
    same = all(
        leaves_equal(tree_to(st, "cpu"), want[0])
        and all(torch.equal(g, w) for gs, ws in zip(got, want[1])
                for g, w in zip(gs, ws))
        for st, got, want in ((a, got_a, alone[0]), (b, got_b, alone[1])))
    check(same, "two chains of one key fed in turn (2 chunks each, the "
          "second on the streams reversed): outputs, meas, succ, valid and "
          "state byte-equal to each chain alone")


@phase("J1. the captured 1080p chunk (8 streams x 16 frames) against the "
       "un-captured one, and its replay")
def captured_1080p(frames, params, dev):
    return captured_vs_eager(frames, params, dev)


@phase("J2. the captured 4K config 4 chunk (2 streams x 16 frames) against "
       "the un-captured one, and its replay")
def captured_4k(frames, params, dev):
    return captured_vs_eager(frames, params, dev, HOMOGRAPHY, "J2")


J_CLIP_FRAMES = 32        # J5's and J6's clips: phase 9's / 10's first 32
J_CLIP_REPLAYS = 5
J_CLIP_OUTPUTS = ("outputs", "meas", "succ")


def replay_figures(walls, eager_ms, frames=None) -> str:
    """Median, min, max and spread of replayed host-clock times beside the
    un-captured ones."""
    walls = np.asarray(walls)
    med, med_e = float(np.median(walls)), float(np.median(eager_ms))
    rate = f" = {frames / med * 1e3:.1f} frames/s" if frames else ""
    return (f"replayed, each synchronized, {len(walls)} calls: median "
            f"{med:.2f} ms, min {walls.min():.2f}, max {walls.max():.2f}, "
            f"spread (max - min) / median "
            f"{(walls.max() - walls.min()) / med * 100:.1f} %{rate}; "
            f"un-captured, same phase: "
            + ", ".join(f"{ms:.1f}" for ms in eager_ms)
            + f" ms ({med_e / med:.2f}x)")


def program_vs_eager(prog, run, names, replays):
    """A program's entry point ``run()`` against the same call inside
    ``graphs.eager()``: the un-captured call twice (an output in which it
    differs from itself is held to ``within_bars`` instead of byte
    equality), then
    the first call (eager run and capture) and ``replays`` replays, each
    against the un-captured results, from a reset program with the launch
    counts set to 0. Prints the capture's figures, the pool, the peak
    memory and the launches per replay; returns (the last replay's
    outputs, the replays' host ms, the un-captured ms)."""
    from video_stabilizer_tpu_torch.utils import graphs

    eager, eager_ms = [], []
    with graphs.eager():
        for _ in range(2):
            out, ms = timed(run)
            eager.append(out)
            eager_ms.append(ms)
    unstable = [n for n, a, b in zip(names, *eager) if not torch.equal(a, b)]
    log("  the un-captured call run twice: "
        + (f"not deterministic in {unstable}" if unstable
           else f"byte-equal in {', '.join(names)}"))
    want = eager[0]
    del eager

    def same(got):
        return all((within_bars(n, g, w) if n in unstable
                    else torch.equal(g, w))
                   for n, g, w in zip(names, got, want))

    graphs.reset([prog])
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    reset_launch_counts()
    first, first_ms = timed(run)
    first_copy = [x.clone() for x in first]
    ok_first = same(first)
    walls, ok_replays = [], True
    for _ in range(replays):
        out, ms = timed(run)
        walls.append(ms)
        ok_replays &= same(out)
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kind = "within the bars of the un-captured path where it is not " \
        "deterministic, byte-equal elsewhere" if unstable else "byte-equal"
    check(prog.captures == 1 and prog.replays == replays,
          f"{prog.name}: {prog.captures} capture, {prog.replays} replays")
    check(ok_first and ok_replays,
          f"{', '.join(names)} of the first call and of {replays} replays "
          f"{kind} to the un-captured call")
    check(all(torch.equal(a, b) for a, b in zip(first, first_copy)),
          "the first call's returned values unchanged after the replays")
    stats = prog.stats()[0]
    log(f"  first call {first_ms:.1f} ms (eager {stats['eager_s']:.2f} s, "
        f"capture {stats['capture_s']:.2f} s, instantiate "
        f"{stats['instantiate_s']:.2f} s); graph pool "
        f"{stats['pool_bytes'] / 1e9:.2f} GB; peak device memory "
        f"{peak_gb:.2f} GB ({base_gb:.2f} GB held before)")
    per_replay = {(f"{k[0]}[{','.join(k[1])}]" if k[1] else k[0]): n
                  for k, n in stats["launches_per_replay"].items()}
    log(f"  launches per replay {per_replay}; this run's counts {launches}")
    return out, walls, eager_ms, stats


def clip_vs_eager(frames, params, dev, model="similarity", tag="J5"):
    """J5 / J6: ``stabilize_streams`` (``stabilize_streams_homography``),
    which replay ``_stabilize_streams_jit``, on the first J_CLIP_FRAMES
    frames of every stream, captured and replayed, against the un-captured
    call on the same card clip."""
    from video_stabilizer_tpu_torch.models import batch, homography_aligner

    host = torch.from_numpy(np.ascontiguousarray(frames[:, :J_CLIP_FRAMES]))
    clip, up_ms = timed(lambda: host.to(dev))
    log(f"  the entry point's upload: {host.numel() / 1e6:.1f} MB pageable "
        f"host -> card in {up_ms:.1f} ms (before the call; the program "
        "copies the card clip into its static input)")
    if model == "similarity":
        def run():
            return batch.stabilize_streams(clip, params, dev)
    else:
        def run():
            return homography_aligner.stabilize_streams_homography(
                clip, params, dev)
    out, walls, eager_ms, stats = program_vs_eager(
        batch._stabilize_streams_jit, run, J_CLIP_OUTPUTS, J_CLIP_REPLAYS)
    streams, total = host.shape[:2]
    lag = params.lag
    check(tuple(out[0].shape) == (streams, total - lag,
                                  host.shape[2] - 2 * params.crop_pixels,
                                  host.shape[3] - 2 * params.crop_pixels, 3),
          f"output {tuple(out[0].shape)}; align success "
          f"{float(out[2][:, 1:].float().mean()):.3f}")
    need = "gn_solve" if model == "similarity" else "gn8_solve"
    per = stats["launches_per_replay"]
    check(any(k[0] == "warp_frames" and k[1] is None for k in per)
          and per.get((need, None), 0) > 0
          and per.get(("tvl1_smooth_kernel", None), 0) == 1
          and per.get(("regularized_pinv_sym4_kernel", None), 0)
          == per[(need, None)]
          and per.get(("accum_scan_kernel", None), 0) == 1,
          f"kernel A and kernel {'B' if need == 'gn_solve' else 'C'} "
          "launched in every replay, kernel D once, kernel E once per "
          "level, kernel F once")
    check(per.get(("bgr_to_gray_kernel", None), 0) == 1
          and per.get(("pyr_down_kernel", None), 0)
          == per.get((need, None), 0) - 1 > 0,
          "kernel G launched once in every replay (the clip's gray), kernel "
          f"H once per level below the first ({need} less one)")
    check(per.get(("keyframe_levels_kernel", None), 0) == 2,
          "kernel I launched twice in every replay (the clip's zero carry "
          "and its keyframes, every level in one launch each)")
    check(per.get(("level_prelude_kernel", None), 0) == per[(need, None)],
          f"kernel J launched once per level in every replay (as {need})")
    log("  clip " + replay_figures(walls, eager_ms, streams * total))
    log_digest(tag, "the last replay's outputs, meas and succ", out)
    return walls


@phase("J5. the captured 1080p similarity clip (stabilize_streams, 8 streams "
       "x 32 frames) against the un-captured one, and its replay")
def clip_1080p(frames, params, dev):
    return clip_vs_eager(frames, params, dev)


@phase("J6. the captured 4K config 4 clip (stabilize_streams_homography, 2 "
       "streams x 32 frames) against the un-captured one, and its replay")
def clip_4k(frames, params, dev):
    return clip_vs_eager(frames, params, dev, HOMOGRAPHY, "J6")


J_LENGTHS = (32, 24, 16)  # J9 (a): three clip lengths in a row
J_HELD_SLACK = 0.25e9     # J9 (a): bytes held beyond the kept key's


@phase("J9. the clip programs' memory over three clip lengths in a row, and "
       "the programs J5-J8 do not run: the FIR warp inside the clip, "
       "eval_combos, median_flow_px alone")
def clip_programs(frames, params, dev):
    """See J9 in the module's docstring."""
    from video_stabilizer_tpu_torch.apps import grid_search_smoother as gss
    from video_stabilizer_tpu_torch.config import StabilizerParams
    from video_stabilizer_tpu_torch.models import batch
    from video_stabilizer_tpu_torch.utils import flow, graphs
    from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip

    prog = batch._stabilize_streams_jit
    graphs.reset([prog])
    clip = torch.from_numpy(
        np.ascontiguousarray(frames[:, :J_LENGTHS[0]])).to(dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_reserved()
    log(f"  (a) {clip.shape[0]} streams, lengths {J_LENGTHS} then "
        f"{J_LENGTHS[-1]} again; the card's reserved memory after each call "
        f"(its cache emptied) over the {base / 1e9:.2f} GB before:")
    held_ok = True
    for t in J_LENGTHS + J_LENGTHS[-1:]:
        out, ms = timed(lambda: batch.stabilize_streams(clip[:, :t], params,
                                                        dev))
        del out
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved() - base
        pool = prog.stats()[0]["pool_bytes"]
        static_in = clip[:, :t].numel()
        keys = len(prog.stats())
        held_ok &= keys == 1 and held <= pool + static_in + J_HELD_SLACK
        log(f"    T = {t}: {ms:.1f} ms; keys kept {keys}, captures "
            f"{prog.captures}, replays {prog.replays}, evictions "
            f"{prog.evictions}; held {held / 1e9:.2f} GB, the key's pool "
            f"{pool / 1e9:.2f} GB + static input {static_in / 1e9:.2f} GB")
    n = len(J_LENGTHS)
    check(held_ok and (prog.captures, prog.replays, prog.evictions)
          == (n, 1, n - 1),
          f"one key kept after each call, the card holding no more than its "
          f"pool and static input + {J_HELD_SLACK / 1e9:.2f} GB; {n} "
          f"captures, {n - 1} evictions, the repeated length replayed")
    del clip

    log("  (b) the FIR output warp inside the clip program:")
    fir = dataclasses.replace(params, output_warp="fir")
    clip = torch.from_numpy(
        np.ascontiguousarray(frames[:2, :J_LENGTHS[0]])).to(dev)
    out, walls, eager_ms, stats = program_vs_eager(
        prog, lambda: batch.stabilize_streams(clip, fir, dev),
        J_CLIP_OUTPUTS, 2)
    per = stats["launches_per_replay"]
    check(per.get(("gn_solve", None), 0) > 0
          and per.get(("warp_frames", None), 0) == 0,
          "kernel B launched in every replay, kernel A not (the FIR warps)")
    log("  FIR clip " + replay_figures(walls, eager_ms))
    del clip, out

    log("  (c) eval_combos on the smoother sweep's default clip:")
    h, w, t = 360, 640, 60
    small = torch.as_tensor(synth_shaky_clip(
        t, h, w, seed=4, jitter_px=1.0, pan_px_per_frame=0.3, device=dev),
        device=dev)
    gray = flow.gray_f32(small).round().to(torch.uint8)
    align = StabilizerParams().aligner
    with graphs.eager():
        want = batch._align_clip_jit(gray, align, w, h)
    (meas, ok), first_ms = timed(lambda: batch._align_clip_jit(gray, align,
                                                               w, h))
    check(torch.equal(meas, want[0]) and torch.equal(ok, want[1]),
          f"the app's one align, first call {first_ms:.1f} ms: byte-equal "
          "to the un-captured one")
    combos = list(itertools.product(gss.LAMBDAS, gss.DECAYS))
    lams = torch.tensor([c[0] for c in combos], device=dev)
    decays = torch.tensor([c[1] for c in combos], device=dev)
    pair = StabilizerParams(lag=10, smoother_memory=5)
    out, walls, eager_ms, stats = program_vs_eager(
        gss.eval_combos,
        lambda: (gss.eval_combos(small, meas, ok, pair, lams, decays),),
        ("outputs",), 2)
    check(stats["launches_per_replay"].get(("tvl1_smooth_kernel", None), 0)
          == 1, "kernel D launched once in every replay (all combos' rows)")
    check(tuple(out[0].shape) == (len(combos), t - pair.lag,
                                  h - 2 * gss.CROP, w - 2 * gss.CROP, 3),
          f"eval_combos output {tuple(out[0].shape)}")
    log(f"  eval_combos ({len(combos)} combos) "
        + replay_figures(walls, eager_ms))
    del small, out

    log("  (d) median_flow_px called alone:")
    gray = flow.gray_f32(torch.from_numpy(
        np.ascontiguousarray(frames[0, :9])).to(dev))
    prev, curr = gray[:-1], gray[1:]
    out, walls, eager_ms, _ = program_vs_eager(
        flow.median_flow_px, lambda: (flow.median_flow_px(prev, curr),),
        ("medians",), 3)
    check(tuple(out[0].shape) == (8,) and bool(torch.isfinite(out[0]).all()),
          f"8 pairs' medians, finite: {[round(float(x), 3) for x in out[0]]}")
    log("  median_flow_px over 8 pairs " + replay_figures(walls, eager_ms))


J10_STREAMS = (8, 6, 4, 8, 6, 4, 8)    # J10 (a): stream counts in a row
J10_LENGTHS = (16, 8, 16, 8, 6, 4, 2)  # then one stream's chunk lengths
J10_REPLAYS = 1000                     # J10 (b): the soak's chunk replayed
# J10 (a), last: another stabilizer's chunk lengths that drop the key of
# J10_LENGTHS' last one (its kept keys are then 8, 6, 4 and 2, least
# recently called first).
J10_EVICTING = (16, 8, 6, 4)
# J10 (c): the dropped key's stream counts (16-frame chunks), then one
# stream's chunk lengths, whose 4th new key drops it (4 keys per card).
J10_DROP_STREAMS = (8, 2)
J10_FILLERS = (2, 4, 6, 8)
J10_NAMES = ("state", "outputs", "meas", "succ", "valid")
# tests/test_torch_soak.py's stream: 64x48, its parameters and content.
SOAK_H, SOAK_W, SOAK_FRAMES = 48, 64, 1000


def tree_to(tree, dev, copy=False):
    """A tensor or a nested tuple (NamedTuple) of them, moved to ``dev``
    (with ``copy``, copied also where it lies there already)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev, copy=copy)
    if isinstance(tree, tuple):
        items = [tree_to(x, dev, copy) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(
            items)
    return tree


def pool_segments(handle) -> int:
    """The bytes of the card's segments in the memory pool ``handle``."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(handle))


def same_as_eager(call, got) -> bool:
    """A replay's outputs ``got`` (named J10_NAMES) against ``call()`` run
    twice inside ``graphs.eager()`` on the same inputs: byte-equal to the
    first run, or within phase 9's bars where the two runs differ from each
    other (the state is then not held)."""
    from video_stabilizer_tpu_torch.utils import graphs
    with graphs.eager():
        runs = [call() for _ in range(2)]
    ok = True
    for name, g, w, w2 in zip(J10_NAMES, got, *runs):
        if name == "state":
            ok &= leaves_equal(g, w) or not leaves_equal(w, w2)
        elif torch.equal(w, w2):
            ok &= g.dtype == w.dtype and torch.equal(g, w)
        else:
            ok &= within_bars(name, g, w)
    return ok


class HeldMemory:
    """J10 (a)'s bar: after a call, with the card's cache emptied, the
    reserved memory over ``base`` is at most the largest pool a key of the
    program grew at its capture since the pool opened (a dropped key's
    blocks stay in the shared pool while another key holds it), the kept
    keys' static inputs, the other kept keys' static outputs, what the
    caller holds, and 0.25 GB. A storage counts once: a donated state the
    caller holds is a kept key's static input, or, once that key was
    dropped, the caller's alone."""

    def __init__(self, prog):
        self.prog = prog
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        self.base = torch.cuda.memory_reserved()
        self.peak = 0

    def read(self, caller=()) -> tuple:
        """(within the bar, a line for the log); ``caller``: the tensors
        the caller holds."""
        from video_stabilizer_tpu_torch.utils import graphs
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved() - self.base
        stats = self.prog.stats()
        self.peak = max([self.peak] + [s["pool_bytes"] for s in stats])
        largest = max(stats, key=lambda s: s["pool_bytes"])
        static = [x for e in self.prog._cache.values() for x in e.static_in
                  if x is not None]
        ins = graphs.storage_nbytes(static)
        caller = graphs.storage_nbytes(static + list(caller)) - ins
        outs = sum(s["static_out_bytes"] for s in stats)
        if largest["pool_bytes"] == self.peak:
            outs -= largest["static_out_bytes"]
        bar = self.peak + ins + outs + caller + J_HELD_SLACK
        pool = pool_segments(self.prog.pool(torch.device(
            "cuda", torch.cuda.current_device())))
        return held <= bar, (
            f"keys kept {len(stats)}, captures {self.prog.captures}, "
            f"replays {self.prog.replays}, evictions {self.prog.evictions}; "
            f"held {held / 1e9:.2f} GB <= {bar / 1e9:.2f} GB (largest pool "
            f"{self.peak / 1e9:.2f} + static inputs {ins / 1e9:.2f} + other "
            f"keys' static outputs {outs / 1e9:.2f} + the caller's "
            f"{caller / 1e9:.2f} + {J_HELD_SLACK / 1e9:.2f}); the shared "
            f"pool's segments {pool / 1e9:.2f} GB")


def held_after(frames, params, dev, streams=None) -> tuple:
    """J10 (c)'s reading: from an empty chunk-streams program, one
    ``streams``-stream chunk of CHUNK frames (none where None), then one
    stream's chunks of J10_FILLERS frames, each from a fresh state on the
    host; the card's reserved memory (cache emptied) over that before the
    first call. Returns (bytes held, the first key's pool bytes,
    evictions)."""
    from video_stabilizer_tpu_torch.models import chunked
    from video_stabilizer_tpu_torch.utils import graphs

    prog = chunked._stabilize_chunk_streams_jit
    graphs.reset([prog])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    calls = ([(streams, CHUNK)] if streams else []) + [
        (1, t) for t in J10_FILLERS]
    pool = 0
    for i, (s, t) in enumerate(calls):
        x = torch.from_numpy(np.ascontiguousarray(frames[:s, :t]))
        state = chunked.init_stream_state(WIDTH, HEIGHT, params, 3, s, "cpu")
        out = chunked.stabilize_chunk_streams(tree_to(state, dev), x, params)
        del out, state
        if i == 0:
            pool = prog.stats()[0]["pool_bytes"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() - base
    evictions = prog.evictions
    graphs.reset([prog])
    return held, pool, evictions


def dropped_key(frames, params, dev):
    """J10 (c): what a dropped chunk key keeps in the shared pool. For each
    of J10_DROP_STREAMS, ``held_after`` with that key first (the 4th filler
    key drops it) less ``held_after`` of the fillers alone: the bytes the
    card still holds for the dropped key, beside its own pool."""
    ok = True
    for streams in J10_DROP_STREAMS:
        held, pool, evictions = held_after(frames, params, dev, streams)
        alone, _, alone_evictions = held_after(frames, params, dev)
        left = held - alone
        ok &= evictions == 1 and alone_evictions == 0
        ok &= left <= pool + J_HELD_SLACK
        log(f"  (c) a {streams}-stream key (pool {pool / 1e9:.3f} GB) "
            f"dropped by 1-stream keys of {J10_FILLERS} frames "
            f"({evictions} eviction): the card holds {held / 1e9:.3f} GB, "
            f"the same keys alone {alone / 1e9:.3f} GB ({alone_evictions} "
            f"evictions): the dropped key left {left / 1e9:.3f} GB")
    check(ok, "a dropped chunk key (8 and 2 streams) leaves at most its own "
          f"pool + {J_HELD_SLACK / 1e9:.2f} GB on the card while the shared "
          "pool's other keys live")


def evicted_while_held(stab, frames, start, memory, params, dev, reference):
    """J10 (a), last: ``stab``'s key dropped while it holds its donated
    state. Another stabilizer feeds the chunk lengths that make ``stab``'s
    key the least recently called and then drop it; the card's reserved
    memory is read (the held state counted as the caller's), and ``stab``'s
    next chunk, its state copied into a new key, equals the un-captured
    chunk."""
    from video_stabilizer_tpu_torch.models import chunked
    from video_stabilizer_tpu_torch.parallel.mesh import tensor_leaves
    from video_stabilizer_tpu_torch.utils import graphs

    prog1 = chunked._stabilize_chunk_jit
    other = chunked.ChunkedStabilizer(params, device=dev)
    at, evictions = 0, prog1.evictions
    for t in J10_EVICTING:
        other.process_chunk(torch.from_numpy(np.ascontiguousarray(
            frames[1, at:at + t])))
        at += t
    state_bytes = graphs.storage_nbytes(tensor_leaves(stab._state))
    kept = {m[1][0] for key in prog1._cache for m in key[2]
            if m[0] == "tensor" and m[1][1:] == (HEIGHT, WIDTH, 3)}
    dropped = J10_LENGTHS[-1] not in kept
    within, line = memory.read(tensor_leaves(stab._state))
    log(f"  after {prog1.evictions - evictions} more evictions (another "
        f"stabilizer's chunks of {J10_EVICTING} frames), the "
        f"{J10_LENGTHS[-1]}-frame key dropped {dropped} while its caller "
        f"keeps the donated state ({state_bytes / 1e9:.3f} GB, that key's "
        f"donated static inputs): {line}")
    check(dropped and within, "a key dropped while its caller keeps the "
          "donated state: the card held no more than the bar, the state's "
          "static inputs counted as the caller's")
    x = torch.from_numpy(np.ascontiguousarray(frames[0, start:start + 2]))
    prev = tree_to(stab._state, "cpu", True)
    got = stab.process_chunk(x)
    check(same_as_eager(reference(prev, x), (stab._state, *got)),
          "the held state's next chunk (copied into a new key) byte-equal "
          "to the un-captured chunk")


@phase("J10. the chunk programs' memory over stream counts and chunk "
       "lengths (4 keys per card in one shared pool), and 1,000 replays of "
       "the soak's chunk")
def chunk_programs(frames, params, dev):
    """See J10 in the module's docstring."""
    from video_stabilizer_tpu_torch.config import StabilizerParams
    from video_stabilizer_tpu_torch.models import chunked
    from video_stabilizer_tpu_torch.parallel.mesh import tensor_leaves
    from video_stabilizer_tpu_torch.utils import graphs
    from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip

    prog = chunked._stabilize_chunk_streams_jit
    graphs.reset([prog])
    memory = HeldMemory(prog)
    log(f"  (a) stabilize_chunk_streams on {CHUNK}-frame chunks of "
        f"{J10_STREAMS} streams in a row, each stream count's state "
        f"carried on the host (the program copies it in); reserved memory "
        f"after each call (cache emptied) over the "
        f"{memory.base / 1e9:.2f} GB before:")
    states, ok_held, ok_same, most, calls = {}, True, True, 0, {}
    for s in J10_STREAMS:
        c = calls[s] = calls.get(s, -1) + 1
        x = torch.from_numpy(np.ascontiguousarray(
            frames[:s, c * CHUNK:(c + 1) * CHUNK]))
        state = states.get(s) or chunked.init_stream_state(
            WIDTH, HEIGHT, params, 3, s, "cpu")
        replays = prog.replays
        got, ms = timed(lambda: chunked.stabilize_chunk_streams(
            tree_to(state, dev), x, params))
        replayed = prog.replays > replays
        if replayed:
            ok_same &= same_as_eager(
                lambda: chunked.stabilize_chunk_streams(
                    tree_to(state, dev), x, params), got)
        states[s] = tree_to(got[0], "cpu")
        del got, state
        within, line = memory.read()
        ok_held &= within
        most = max(most, len(prog.stats()))
        log(f"    {s} streams, chunk {c}: "
            f"{'replay' if replayed else 'first call'} {ms:.1f} ms; {line}")
    n_keys = len(set(J10_STREAMS))
    check(ok_held and most <= 4,
          "the card held no more than the bar after every call, at most 4 "
          "keys kept")
    check((prog.captures, prog.replays, prog.evictions)
          == (n_keys, len(J10_STREAMS) - n_keys, 0) and ok_same,
          f"{prog.captures} captures, {prog.replays} replays: every repeated "
          "stream count replayed, byte-equal to the un-captured call "
          "(outputs, meas, success, valid, carried state) after the other "
          "keys' captures and replays")
    del states

    prog1 = chunked._stabilize_chunk_jit
    graphs.reset([prog, prog1])
    memory = HeldMemory(prog1)
    log(f"  ChunkedStabilizer.process_chunk on one stream, chunks of "
        f"{J10_LENGTHS} frames in a row:")
    stab = chunked.ChunkedStabilizer(params, device=dev)
    start, ok_held, ok_same = 0, True, True

    def reference(prev, x):
        """The un-captured chunk from a host copy of the state the donating
        call started from."""
        def run():
            st, out, meas, succ, valid = chunked.stabilize_chunk_impl(
                tree_to(prev, dev, True), x, params)
            return st, out[valid], meas, succ
        return run

    for t in J10_LENGTHS:
        x = torch.from_numpy(np.ascontiguousarray(frames[0, start:start + t]))
        start += t
        prev = tree_to(stab._state if stab._state is not None else
                       chunked.init_stream_state(WIDTH, HEIGHT, params, 3, 1,
                                                 "cpu"), "cpu", True)
        replays = prog1.replays
        got, ms = timed(lambda: stab.process_chunk(x))
        replayed = prog1.replays > replays
        if replayed:
            ok_same &= same_as_eager(reference(prev, x), (stab._state, *got))
        del got, prev
        within, line = memory.read(tensor_leaves(stab._state))
        ok_held &= within
        log(f"    {t} frames: {'replay' if replayed else 'first call'} "
            f"{ms:.1f} ms; {line}")
    kept = sorted({m[1][0] for key in prog1._cache for m in key[2]
                   if m[0] == "tensor" and m[1][1:] == (HEIGHT, WIDTH, 3)})
    want_kept = sorted(set(J10_LENGTHS) - {J10_LENGTHS[0]})
    n_keys = len(set(J10_LENGTHS))
    check(ok_held, "the card held no more than the bar after every call")
    check((prog1.captures, prog1.replays, prog1.evictions)
          == (n_keys, len(J10_LENGTHS) - n_keys, n_keys - 4) and ok_same
          and kept == want_kept,
          f"{prog1.captures} captures, {prog1.replays} replays (byte-equal "
          f"to the un-captured call), {prog1.evictions} eviction: the 5th "
          f"chunk length dropped the least recently called; kept {kept}")
    evicted_while_held(stab, frames, start, memory, params, dev, reference)
    del stab
    dropped_key(frames, params, dev)

    log(f"  (b) {J10_REPLAYS} replays of the soak's {SOAK_W}x{SOAK_H} "
        "two-frame chunk (tests/test_torch_soak.py's stream):")
    soak = StabilizerParams(lag=4, smoother_memory=2, crop_pixels=4)
    clip = synth_shaky_clip(SOAK_FRAMES, SOAK_H, SOAK_W, seed=1000,
                            jitter_px=0.6, pan_px_per_frame=0.1, device=dev)
    graphs.reset([prog1])
    state = chunked.init_stream_state(SOAK_W, SOAK_H, soak, 3, 1, dev)
    walls, reserved, readings = [], [], {}

    def read():
        """(bytes allocated, bytes reserved with the cache emptied)."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()

    for k in range(J10_REPLAYS + 1):
        i = 2 * k % SOAK_FRAMES
        (state, *_), ms = timed(lambda: chunked.stabilize_chunk_impl(
            state, torch.from_numpy(clip[i:i + 2]), soak))
        walls.append(ms)
        reserved.append(torch.cuda.memory_reserved())
        if k in (1, J10_REPLAYS):
            readings[k] = read()
    finite = bool(torch.isfinite(state.accum).all()
                  and torch.isfinite(state.meas_tail).all())
    walls = np.asarray(walls[1:])
    (alloc1, res1), (alloc_n, res_n) = readings[1], readings[J10_REPLAYS]
    # Replay 1's reading emptied the cache: count changes from replay 2 on.
    steps = [(k, reserved[k] - reserved[k - 1]) for k in range(3, len(
        reserved)) if reserved[k] != reserved[k - 1]]
    check(prog1.captures == 1 and prog1.replays == J10_REPLAYS
          and (alloc_n, res_n) == (alloc1, res1) and finite
          and int(state.steps_seen) == 2 * (J10_REPLAYS + 1),
          f"{prog1.captures} capture, {prog1.replays} replays; after replay "
          f"1 / {J10_REPLAYS}: allocated {alloc1} / {alloc_n} bytes, "
          f"reserved (cache emptied) {res1 / 1e6:.1f} / {res_n / 1e6:.1f} MB;"
          f" state finite {finite}, steps_seen {int(state.steps_seen)}; a "
          f"replay (host clock, synchronized) median {np.median(walls):.3f} "
          f"ms, min {walls.min():.3f}, max {walls.max():.3f}")
    log(f"  reserved without emptying the cache: {reserved[1] / 1e6:.1f} MB "
        f"after replay 1, {reserved[-1] / 1e6:.1f} MB after replay "
        f"{J10_REPLAYS}; changes at (replay, bytes) {steps[:10]}")


@phase("1080p similarity with selection='topk': 8 streams x 16-frame "
       "chunks, carried state")
def topk_path(frames, poses, params, dev, mask_stages):
    """Phase 9's run with the exact-count keypoint selection: the same
    checks (kernel J in its exact-count mode once per level, as B), the
    plain prelude run on the card no time, and its stage table beside phase
    9's (histogram mask). Returns the launch counts."""
    from video_stabilizer_tpu_torch.models import chunked
    from video_stabilizer_tpu_torch.ops import prelude
    from video_stabilizer_tpu_torch.utils import graphs

    plain_before = dict(PLAIN_ON_CARD)
    launches, meas, ok, states, last, stages = drive_path(frames, params,
                                                          dev)
    check(launches.get("warp_frames[similarity,bilinear]", 0) > 0
          and launches["gn_solve"] > 0 and launches["tvl1_smooth"] > 0,
          "kernel A (similarity, bilinear), kernel B and kernel D launched")
    path_checks_e_f(launches, "gn_solve", CHUNKS)
    check(PLAIN_ON_CARD == plain_before,
          f"the plain versions ran on the card no time in this phase "
          f"({PLAIN_ON_CARD[SEL_NAME] - plain_before[SEL_NAME]} plain "
          "preludes: selection=\"topk\" goes to kernel J's exact-count "
          "mode)")
    path_checks_i(launches, CHUNKS)
    known_motion_checks(meas, ok, poses)
    log("  stage device times, mean of chunks 1-3 (CUDA events), ms: "
        "histogram mask (phase 9) | topk")
    for k in stages:
        log(f"    {k:<26} {mask_stages.get(k, float('nan')):9.3f} "
            f"{stages[k]:9.3f}")
    for name, st in (("mask", mask_stages), ("topk", stages)):
        log(f"    select, all levels ({name}): "
            f"{sum(v for k, v in st.items() if k.startswith('select')):.3f}"
            " ms")
    # Kernel J's calls of one more un-captured chunk (after the counts
    # were read), for the op times below.
    with graphs.eager(), mock.patch.object(
            prelude, "level_prelude", wraps=prelude.level_prelude) as spy:
        chunked.stabilize_chunk_streams(states, last, params)
    select_op_times(params.aligner, dev, [c.args for c in spy.call_args_list])
    return launches


def select_op_times(aligner_params, dev, calls):
    """The two selections alone, one after the other on the same warp
    diffs (integer-valued, so with ties), at each 1080p level's (items, 2,
    N) shape, and kernel J's two modes on that level's recorded ``calls``
    (the histogram mask and the exact count, the whole prelude): each
    call's time between CUDA events, host launch overhead included. The
    chunk's stage times above move with the host's pace between runs; this
    compares the four within one stretch of it."""
    from video_stabilizer_tpu_torch.models.aligner import level_specs
    from video_stabilizer_tpu_torch.ops.prelude import level_prelude_kernel
    from video_stabilizer_tpu_torch.ops.select import (
        histogram_mask, topk_mask)

    g = torch.Generator().manual_seed(SEED + 7)
    by_width = {a[0].width: a for a in calls}
    mask_params = dataclasses.replace(aligner_params, selection="mask")
    rows = []
    for spec in level_specs(WIDTH, HEIGHT, aligner_params):
        n = spec.ht * spec.wt
        wd = torch.floor(torch.rand((STREAMS * CHUNK, 2, n), generator=g)
                         * 64).to(dev)
        frac = aligner_params.smallest_fraction
        args = by_width[spec.width]
        as_mask = args[:6] + (mask_params,) + args[7:]
        rows.append((f"{spec.width}x{spec.height}",
                     cuda_ms(lambda: histogram_mask(wd, frac), 20),
                     cuda_ms(lambda: topk_mask(wd, frac), 20),
                     cuda_ms(lambda: level_prelude_kernel(*as_mask), 20),
                     cuda_ms(lambda: level_prelude_kernel(*args), 20)))
    log(f"  the selection alone, ({STREAMS * CHUNK}, 2, N) warp diffs, and "
        "kernel J's whole prelude on the level's call, in its histogram and "
        "exact-count modes, ms per call: " + ", ".join(
            f"{lv} mask {m:.3f} topk {t:.3f} J {jm:.3f} J[topk] {jt:.3f}"
            for lv, m, t, jm, jt in rows)
        + "; all levels " + ", ".join(
            f"{name} {sum(r[i] for r in rows):.3f}" for i, name in (
                (1, "mask"), (2, "topk"), (3, "J"), (4, "J[topk]"))))


def fir_oracle_gap(frames, ts, fir, oracle, group):
    """(max |diff| LSB, share within 1, share within 2) between the FIR
    warp and the gather oracle, ``group`` frames at a time."""
    worst, within1, within2, total = 0, 0, 0, 0
    for i in range(0, frames.shape[0], group):
        f, t = frames[i:i + group], ts[i:i + group]
        diff = (fir(f, t).to(torch.int16) - oracle(f, t).to(torch.int16)).abs()
        worst = max(worst, int(diff.max()))
        within1 += int((diff <= 1).sum())
        within2 += int((diff <= 2).sum())
        total += diff.numel()
    return worst, within1 / total, within2 / total


@phase("FIR output warp on the card (1080p, similarity + bilinear): against "
       "the gather oracle, timed beside kernel A and grid_sample")
def check_fir(states, chunk, params, dev):
    """``ops/fast_warp.warp_image_fast`` against ``ops/warp.warp_image_bgr``
    (zero border) at tests/test_fast_warp_oracle.py's bars: on phase 9's
    128 delayed frames with their corrections (<= 2 LSB on > 99.9 %); on 8
    of them at integer translations (bit-exact), at subpixel translations
    (<= 1 LSB) and at rotation / zoom within the envelope, |A,B| <= 0.0027
    (<= 2 LSB on > 99.9 %, at most 8). Then the FIR path of the pipeline
    (``batch._warp_frames`` with output_warp="fir", crop 32) timed on the
    128 frames beside kernel A and grid_sample."""
    from video_stabilizer_tpu_torch import transforms as T
    from video_stabilizer_tpu_torch.config import resolve_residual_bound
    from video_stabilizer_tpu_torch.models import batch, chunked
    from video_stabilizer_tpu_torch.ops.fast_warp import warp_image_fast
    from video_stabilizer_tpu_torch.ops.warp import warp_image_bgr
    from video_stabilizer_tpu_torch.ops.warp_kernel import warp_frames

    _, delayed, accums, *_ = chunked.stabilize_chunk_core(
        states, chunk.to(dev), params, WIDTH, HEIGHT)
    frames = delayed.batch().flatten(0, 1)
    ts = T.center_to_ul(accums, WIDTH, HEIGHT,
                        minus_one=True).reshape(-1, 4).contiguous()
    rb = resolve_residual_bound(params, WIDTH, HEIGHT)

    def fir(f, t):
        return warp_image_fast(f, t, residual_bound=rb)

    def oracle(f, t):
        return warp_image_bgr(f, t, border="zero")

    worst, w1, w2 = fir_oracle_gap(frames, ts, fir, oracle, 8)
    check(w2 > 0.999 and worst <= 8,
          f"{frames.shape[0]} frames, real corrections (|A,B| <= "
          f"{float(ts[:, :2].abs().max()):.1e}), residual bound {rb}: max "
          f"|diff| {worst} LSB, {w1 * 100:.4f} % within 1, {w2 * 100:.4f} % "
          "within 2")
    g = torch.Generator().manual_seed(SEED + 5)
    sub = frames[:8].contiguous()
    shifts = torch.randint(-150, 151, (8, 2), generator=g).float()
    zero = torch.zeros((8, 2))
    cases = {
        "integer translation": (torch.cat([zero, shifts], 1), 0, 0.0),
        "subpixel translation": (torch.cat(
            [zero, (torch.rand((8, 2), generator=g) * 2 - 1) * 30], 1), 1,
            0.0),
        "rotation / zoom, |A,B| <= 0.0027": (torch.cat(
            [(torch.rand((8, 2), generator=g) * 2 - 1) * 0.0027,
             (torch.rand((8, 2), generator=g) * 2 - 1) * 10], 1), 8, 0.999),
    }
    for name, (t, max_bar, share_bar) in cases.items():
        worst_c, _, w2_c = fir_oracle_gap(sub, t.to(dev), fir, oracle, 8)
        check(worst_c <= max_bar and (share_bar == 0.0 or w2_c > share_bar),
              f"{name} (8 frames): max |diff| {worst_c} LSB (bar "
              f"{max_bar}), {w2_c * 100:.4f} % within 2")
    del sub

    params_fir = dataclasses.replace(params, output_warp="fir")
    crop = params.crop_pixels
    fir_ms = cuda_ms(lambda: batch._warp_frames(frames, ts, params_fir, WIDTH,
                                                HEIGHT, "similarity"), 3)
    kernel_ms = cuda_ms(lambda: warp_frames(frames, ts, crop), 10)
    library_ms = grid_sample_ms(frames, ts, crop, 5)
    log(f"  {frames.shape[0]} frames, crop {crop}: FIR {fir_ms:.3f} ms, "
        f"kernel A {kernel_ms:.3f} ms, grid_sample {library_ms:.3f} ms; FIR "
        f"/ kernel A {fir_ms / kernel_ms:.1f}")


@phase("FIR output warp on the card (4K, homography + Lanczos2): against "
       "the gather oracle, timed beside kernel A")
def check_fir_4k(states, chunk, params, dev):
    """``ops/fast_warp.warp_homography_fast`` + Lanczos2 against the gather
    oracle (``ops/warp.warp_field_bgr`` on the homography's sample
    positions, zero border) on phase 10's 32 delayed frames with their
    corrections and on 4 of them with random homographies within the
    envelope (|p0,p1,p3,p4| <= 1e-3, |p6,p7| <= 2e-3, |t| <= 40 px):
    <= 2 LSB on > 99.9 %. Then the FIR path timed on the 32 frames beside
    kernel A."""
    from video_stabilizer_tpu_torch.config import resolve_residual_bound
    from video_stabilizer_tpu_torch.models import batch, chunked
    from video_stabilizer_tpu_torch.ops.fast_warp import (
        homography_field, warp_homography_fast)
    from video_stabilizer_tpu_torch.ops.warp import warp_field_bgr
    from video_stabilizer_tpu_torch.ops.warp_kernel import warp_frames

    _, delayed, accums, *_ = chunked.stabilize_chunk_core(
        states, chunk.to(dev), params, W4K, H4K, HOMOGRAPHY)
    frames = delayed.batch().flatten(0, 1)
    ts = accums.reshape(-1, 8).contiguous()
    rb = resolve_residual_bound(params, W4K, H4K)

    def fir(f, p):
        return warp_homography_fast(f, p, interp="lanczos2",
                                    residual_bound=rb)

    def oracle(f, p):
        return warp_field_bgr(f, *homography_field(p, H4K, W4K),
                              interp="lanczos2", border="zero")

    for name, (f, p) in {
            "real corrections": (frames, ts),
            "random homographies": (frames[:4], (
                (torch.rand((4, 8), generator=torch.Generator().manual_seed(
                    SEED + 6)) * 2 - 1) * torch.tensor(
                    [1e-3, 1e-3, 40.0 / W4K, 1e-3, 1e-3, 40.0 / W4K, 2e-3,
                     2e-3])).to(dev))}.items():
        worst, w1, w2 = fir_oracle_gap(f, p, fir, oracle, 2)
        check(w2 > 0.999,
              f"{name} ({f.shape[0]} frames), residual bound {rb}: max "
              f"|diff| {worst} LSB, {w1 * 100:.4f} % within 1, "
              f"{w2 * 100:.4f} % within 2")
    params_fir = dataclasses.replace(params, output_warp="fir")
    crop = params.crop_pixels
    fir_ms = cuda_ms(lambda: batch._warp_frames(frames, ts, params_fir, W4K,
                                                H4K, HOMOGRAPHY), 2)
    kernel_ms = cuda_ms(lambda: warp_frames(frames, ts, crop,
                                            interp="lanczos2",
                                            model=HOMOGRAPHY), 10)
    log(f"  {frames.shape[0]} frames, crop {crop}: FIR {fir_ms:.3f} ms, "
        f"kernel A {kernel_ms:.3f} ms; FIR / kernel A "
        f"{fir_ms / kernel_ms:.1f}; no library call: grid_sample has no "
        "Lanczos2")


def one_item(args, item):
    """Kernel B's arguments cut to one item: key_index, tmpl, jac_masked,
    hinv and t_init are per item; the keyframes' operands stay."""
    one = list(args)
    for k in (1, 2, 3, 4, 9):
        one[k] = args[k][item:item + 1]
    return one


def item_kw(kw, item):
    """A GN launch's keyword arguments cut to one of its items: its own
    threshold, where the launch has one per item."""
    thr = kw["threshold"]
    if isinstance(thr, torch.Tensor) and thr.dim() == 1:
        return dict(kw, threshold=thr[item:item + 1])
    return kw


def permuted_keypoints(one):
    """The same item with its keypoints in another (seeded random) order:
    the same sums, added in another order."""
    n = one[0].shape[-1]
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(SEED))
    perm = perm.to(one[0].device)
    out = list(one)
    out[0] = one[0][:, perm].contiguous()   # windows (K, N, P, P)
    for k in (2, 3, 5, 6, 7, 8):  # tmpl, jac, fx, fy, ox, oy
        out[k] = one[k][..., perm].contiguous()
    return out


def step_sequence(solve, one, kw, steps):
    """Iterations 1 .. ``steps`` of ``solve`` on one item's arguments, each
    one step of its fixed-iteration mode from the transform the step before
    left (a GN step depends only on the transform it starts from). Returns
    (per step: the max corner move in px at the level's size, the GN
    corners of t_K against t_(K-1) in float64, and whether the engine's own
    float32 test found that step below the threshold), and t_steps."""
    from video_stabilizer_tpu_torch import transforms as T
    from video_stabilizer_tpu_torch.ops.gn_solve import gn_corners
    w, h = kw["width"], kw["height"]
    corners = gn_corners(w, h, one[0].device).double()

    def at(t):
        return T.warp_points_center(t.double()[:, None, :], corners, w * 0.5,
                                    h * 0.5)
    args = list(one)
    out = []
    for _ in range(steps):
        t_k, below, _, _ = solve(*args, **dict(kw, fixed_iters=1))
        out.append((float((at(t_k) - at(args[9])).norm(dim=-1).amax()),
                    bool(below[0])))
        args[9] = t_k
    return out, args[9]


def diagnose_item(item, name, args, kw):
    """Kernel B and its plain version on one item of one level, on the same
    inputs: their own loops (converged, iterations), and side by side the
    per-iteration max corner move of each (fixed mode, one step at a time
    up to max_iters), with the plain version on the keypoints in another
    order as a third column: the same arithmetic summed in another order.
    '*' marks a step the engine itself found below the threshold."""
    from video_stabilizer_tpu_torch.ops.gn_solve import (
        gn_solve, gn_solve_plain)
    one = one_item(args, item)
    kw = item_kw(kw, item)
    own = {}
    for ename, solve in (("kernel", gn_solve), ("plain", gn_solve_plain)):
        _, conv, d01, iters = solve(*one, **kw)
        own[ename] = (bool(conv[0]), int(iters[0]), float(d01[0]))
    log(f"      on the {name} run's inputs: kernel converged "
        f"{own['kernel'][0]} in {own['kernel'][1]}, plain "
        f"{own['plain'][0]} in {own['plain'][1]} iterations (max_iters "
        f"{kw['max_iters']}); "
        f"disp01 {own['kernel'][2]:.4f} / {own['plain'][2]:.4f} px")
    m = kw["max_iters"]
    seq_k, t_k = step_sequence(gn_solve, one, kw, m)
    seq_p, _ = step_sequence(gn_solve_plain, one, kw, m)
    seq_r, _ = step_sequence(gn_solve_plain, permuted_keypoints(one), kw, m)
    direct = gn_solve(*one, **dict(kw, fixed_iters=m))[0]
    log(f"      kernel fixed_iters={m} from the start equals its {m} single "
        f"steps bit for bit: {bool(torch.equal(direct, t_k))}")

    def first_gap(a, b, tol):
        return next((k + 1 for k, (x, y) in enumerate(zip(a, b))
                     if abs(x[0] - y[0]) > tol), None)

    for label, other in (("kernel vs plain", seq_k),
                         ("plain permuted vs plain", seq_r)):
        gaps = [abs(x[0] - y[0]) for x, y in zip(other, seq_p)]
        flips = [k + 1 for k, (x, y) in enumerate(zip(other, seq_p))
                 if x[1] != y[1]]
        log(f"      {label}: steps equal to 1e-6 px up to step "
            f"{(first_gap(other, seq_p, 1e-6) or m + 1) - 1}, largest gap "
            f"{max(gaps):.2e} px (step {gaps.index(max(gaps)) + 1}); "
            f"own stop test differs at steps {flips[:8]}")
    log("      step: kernel / plain / plain permuted (px; * below the "
        "threshold by the engine's own test)")
    for r in range(0, m, 3):
        log("        " + "  ".join(
            f"{k + 1:2d}: " + " / ".join(
                f"{seq[k][0]:.7f}{'*' if seq[k][1] else ' '}"
                for seq in (seq_k, seq_p, seq_r))
            for k in range(r, min(r + 3, m))))


@phase("1080p at 4 px jitter: one chunk with kernel B, one with its plain "
       "version")
def wide_jitter(params, dev):
    """Reported, with no bar: how the GN loop fares past bench.py's 1 px
    jitter, with the kernel and with its plain version (the reference's
    loop in PyTorch) on the same chunk. Each item whose converged flag
    differs between the two runs is named (stream, frame, level) and
    diagnosed (``diagnose_item``) on each run's own inputs of that level."""
    from video_stabilizer_tpu_torch.models import aligner, chunked
    from video_stabilizer_tpu_torch.ops.gn_solve import (
        gn_solve, gn_solve_plain)
    from video_stabilizer_tpu_torch.utils import graphs

    frames, poses = synth_streams(dev, CHUNK, WIDE_CONTENT)
    runs = {}
    for name, engine in (("kernel", gn_solve), ("plain", gn_solve_plain)):
        levels = []

        def recorded(*args, engine=engine, levels=levels, **kw):
            out = engine(*args, **kw)
            levels.append((args, kw, out))
            return out
        states = chunked.init_stream_state(WIDTH, HEIGHT, params, 3, STREAMS,
                                           dev)
        # Un-captured, so that the patched engine runs at every level.
        with mock.patch.object(aligner, "gn_solve", recorded), \
                graphs.eager():
            _, _, meas, ok, _ = chunked.stabilize_chunk_streams(
                states, frames, params)
        meas, ok = meas.cpu().numpy(), ok.cpu().numpy()
        rms, max_err = known_motion_error(meas[..., 2:], ok, poses)
        runs[name] = levels
        log(f"  {name}: {int(ok.sum())} of {ok.size} frames aligned; "
            f"TX/TY against the known motion RMS {rms:.4f} px, max "
            f"{max_err:.4f} px")
        for _, kw, (_, conv, _, iters) in levels:
            log(f"    {kw['width']}x{kw['height']}: "
                f"{float(conv.float().mean()) * 100:.1f} % converged, "
                f"{int((iters >= kw['max_iters']).sum())} of "
                f"{iters.numel()} items at max_iters, mean iters "
                f"{float(iters.float().mean()):.2f}")
    for (args, kw, got), (pargs, pkw, want) in zip(runs["kernel"],
                                                   runs["plain"]):
        level = f"{kw['width']}x{kw['height']}"
        differ = torch.nonzero(got[1] != want[1]).flatten().tolist()
        log(f"  {level}: converged differs on {len(differ)} items; "
            f"|dTX,dTY| over all items "
            f"{float((got[0][:, 2:] - want[0][:, 2:]).abs().max()):.2e} px")
        for item in differ[:2]:
            # Items are stream-major, then frame (aligner.align_pairs).
            log(f"    item {item}: stream {item // CHUNK}, frame "
                f"{item % CHUNK}, level {level}: the kernel run converged "
                f"{bool(got[1][item])} in {int(got[3][item])} iterations, "
                f"the plain run {bool(want[1][item])} in "
                f"{int(want[3][item])}")
            diagnose_item(item, "kernel", args, kw)
            diagnose_item(item, "plain", pargs, pkw)


@phase("small clip: the port on the card vs the port on the CPU")
def small_reference(dev):
    from video_stabilizer_tpu_torch.config import StabilizerParams
    from video_stabilizer_tpu_torch.models import chunked
    from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip

    params = StabilizerParams(lag=4, smoother_memory=2, crop_pixels=8)
    frames = np.stack([synth_shaky_clip(16, 96, 128, seed=51 + s,
                                        jitter_px=0.8, pan_px_per_frame=0.3,
                                        rot_jitter=0.002) for s in range(2)])
    outs = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        st = chunked.init_stream_state(128, 96, params, 3, 2, d)
        res = []
        for c in range(2):
            st, out, meas, ok, _ = chunked.stabilize_chunk_streams(
                st, frames[:, 8 * c:8 * (c + 1)], params)
            res.append((out.cpu().numpy(), meas.cpu().numpy(),
                        ok.cpu().numpy()))
        outs[name] = [np.concatenate(x, axis=1) for x in zip(*res)]
    (o_g, m_g, k_g), (o_c, m_c, k_c) = outs["card"], outs["cpu"]
    d_ab = float(np.abs(m_g[..., :2] - m_c[..., :2]).max())
    d_t = float(np.abs(m_g[..., 2:] - m_c[..., 2:]).max())
    within = float((np.abs(o_g.astype(np.int32) - o_c) <= 1).mean())
    check(bool((k_g == k_c).all()) and d_ab <= 6e-4 and d_t <= 0.1
          and within >= 0.99,
          f"ok equal {bool((k_g == k_c).all())}, |dA,dB| {d_ab:.2e}, "
          f"|dTX,dTY| {d_t:.2e}, {within * 100:.3f} % of pixels within "
          "1 LSB")


# --------------------------------------------------------------------------
# Parameter sweeps (kernels B and C with one threshold per item) and the
# apps' pipeline
# --------------------------------------------------------------------------

SWEEP_FRAMES = 32         # G1's and G3's clip: bench.py's content, seed 100
ITEM_NAME_B = "gn_solve[per-item threshold]"
ITEM_NAME_C = "gn8_solve[per-item threshold]"
# The threshold axis of the reference's grid (grid_search_align.cpp:135-146):
# G2 draws one per item, and its 4K path sweeps all three.
ITEM_THRESHOLDS = (0.01, 0.02, 0.04)


def timed(fn):
    """(fn(), host milliseconds from a synchronized start to the device's
    end of its work)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def gn_item_entry(name, source, replaces, totals, bound_share, worst):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=worst, ms=totals["ms"],
                device_ms=totals["device_ms"], plain_ms=totals["plain_ms"],
                bound_ms=totals["bound_ms"],
                bound_by=max(bound_share, key=bound_share.get),
                library_ms=None)


def similarity_corner_gap(t_a, t_b, width, height):
    """(B,) max distance between the level's GN corners ((w-1, h-1)
    extent) under two (B, 4) centre-pivot similarities, in px."""
    from video_stabilizer_tpu_torch import transforms as T
    from video_stabilizer_tpu_torch.ops.gn_solve import gn_corners
    corners = gn_corners(width, height, t_a.device).double()

    def at(t):
        return T.warp_points_center(t.double()[:, None, :], corners,
                                    width * 0.5, height * 0.5)
    return torch.linalg.vector_norm(at(t_a) - at(t_b), dim=-1).amax(dim=-1)


# An item whose two engines stop one iteration apart is held to this: the
# plain engine's move at the step where the first engine stopped lies
# within this share of the item's threshold, so the two engines' stop tests
# straddle the threshold by their sum-order rounding (phase 11's finding).
KNIFE_EDGE = 0.1


def step_apart_items(plain, args, kw, i_g, i_w, gap_fn):
    """The items whose engines stopped at different iterations: per item
    (index, kernel and plain iterations, threshold, the plain engine's
    corner move in px at the first engine's last step, knife-edge or not).
    The move comes from the plain engine run alone on the item with
    max_iters k - 1 and k, k the fewer iterations."""
    out = []
    for item in torch.nonzero(i_g != i_w).flatten().tolist():
        one, okw = one_item(args, item), item_kw(kw, item)
        thr = float(torch.as_tensor(okw["threshold"]).reshape(-1)[0])
        k = int(min(i_g[item], i_w[item]))
        before = plain(*one, **dict(okw, max_iters=k - 1))[0]
        after = plain(*one, **dict(okw, max_iters=k))[0]
        move = float(gap_fn(before, after, kw["width"], kw["height"])[0])
        edge = (abs(int(i_g[item]) - int(i_w[item])) == 1
                and abs(move - thr) <= KNIFE_EDGE * thr)
        out.append((item, int(i_g[item]), int(i_w[item]), thr, move, edge))
        log(f"    item {item}: kernel {int(i_g[item])} vs plain "
            f"{int(i_w[item])} iterations at threshold {thr:.4g} px; the "
            f"plain engine's step {k} moved {move:.6f} px "
            f"({(move / thr - 1) * 100:+.2f} % of the threshold)")
    return out


def per_item_b(calls):
    """G1 (a): kernel B against its plain version on the sweep's items, one
    threshold per item, at every level: converged equal; on the items whose
    engines ran the same iterations, phase 5's bars (A/B 1e-5, TX/TY 1e-3
    px; the clip is translation only, so not the A/B >= 10x check); the
    items that stopped one iteration apart straddle their threshold
    (KNIFE_EDGE) and are at most 1 % of the level (or 1); two launches
    bit-identical; iterations summed by threshold; wrapper, device and
    plain times and the bound, summed over the levels."""
    from video_stabilizer_tpu_torch.ops.gn_solve import (
        OPS_PER_SAMPLE, gn_solve, gn_solve_plain)

    totals = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0)
    bound_share = dict(bytes=0.0, operations=0.0)
    worst = 0.0
    iters_by_thr = {v: 0 for v in ITEM_THRESHOLDS}
    for args, kw in calls:
        n, p = args[0].shape[1], args[0].shape[3]
        items = args[9].shape[0]
        level = f"{kw['width']}x{kw['height']} (P={p}, N={n}, {items} items)"
        (t_g, c_g, _, i_g) = gn_solve(*args, **kw)
        (t_w, c_w, _, i_w) = gn_solve_plain(*args, **kw)
        same = i_g == i_w
        d_ab = float((t_g[:, :2] - t_w[:, :2])[same].abs().max())
        d_t = float((t_g[:, 2:] - t_w[:, 2:])[same].abs().max())
        worst = max(worst, d_ab, d_t)
        apart = step_apart_items(gn_solve_plain, args, kw, i_g, i_w,
                                 similarity_corner_gap)
        conv_equal = bool((c_g == c_w).all())
        check(conv_equal and d_ab <= GN_AB_BAR and d_t <= GN_T_BAR
              and all(a[-1] for a in apart)
              and len(apart) <= max(1, items // 100),
              f"{level}: converged equal {conv_equal}; on the "
              f"{int(same.sum())} items with equal iterations |dA,dB| "
              f"{d_ab:.2e} (bar {GN_AB_BAR:.0e}), |dTX,dTY| {d_t:.2e} px "
              f"(bar {GN_T_BAR:.0e}); {len(apart)} items one step apart, "
              f"each within {KNIFE_EDGE:.0%} of its threshold "
              f"{all(a[-1] for a in apart)}; mean iters "
              f"{float(i_g.float().mean()):.2f}")
        check(deterministic(lambda: gn_solve(*args, **kw)),
              f"{level}: two launches give bit-identical outputs")
        for v in ITEM_THRESHOLDS:
            iters_by_thr[v] += int(i_g[kw["threshold"] == v].sum())
        ms = cuda_ms(lambda: gn_solve(*args, **kw), 10)
        device_ms = graph_ms(lambda: gn_solve(*args, **kw), 10)
        plain_ms = cuda_ms(lambda: gn_solve_plain(*args, **kw), 1)
        bytes_moved = gn_bytes(args, t_g, i_g)
        ops = int(i_g.sum()) * 2 * n * OPS_PER_SAMPLE
        bound_ms, bound_by = roofline(bytes_moved, ops)
        bound_share[bound_by] += bound_ms
        log(f"    kernel {ms:.4f} ms (device {device_ms:.4f} ms), plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        for k, v in (("ms", ms), ("device_ms", device_ms),
                     ("plain_ms", plain_ms), ("bound_ms", bound_ms)):
            totals[k] += v
    log(f"  per sweep (sum of {len(calls)} levels): kernel "
        f"{totals['ms']:.4f} ms (device {totals['device_ms']:.4f} ms), "
        f"plain {totals['plain_ms']:.3f} ms, bound "
        f"{totals['bound_ms']:.4f} ms")
    lo, hi = ITEM_THRESHOLDS[0], ITEM_THRESHOLDS[-1]
    check(iters_by_thr[lo] > iters_by_thr[hi],
          "each item stops at its own threshold: iterations summed over the "
          "levels, by threshold, " + ", ".join(
              f"{v} px {n}" for v, n in iters_by_thr.items()))
    return gn_item_entry(ITEM_NAME_B,
                         "video_stabilizer_tpu_torch/csrc/gn_solve.cu",
                         GN_REPLACES, totals, bound_share, worst)


def sweep_inputs(dev):
    """G1's inputs: (host frames, card clip, card gray, combos, the widened
    aligner params, the sweep's StabilizerParams, the combos'
    DynAlignParams)."""
    from video_stabilizer_tpu_torch.apps import grid_search_align as gsa
    from video_stabilizer_tpu_torch.config import StabilizerParams

    frames = synth_streams(dev, SWEEP_FRAMES, MAIN_CONTENT, seeds=[SEED])[0][0]
    clip = torch.from_numpy(frames).to(dev)
    gray = torch.from_numpy(gsa.host_gray(frames)).to(dev)
    combos = gsa.combo_grid()
    base, line = gsa.widened_aligner()
    log(f"  {len(combos)} combos x {SWEEP_FRAMES} frames; {line}")
    params = StabilizerParams(aligner=base, enable_smoother=False,
                              crop_pixels=gsa.CROP)
    return (frames, clip, gray, combos, base, params,
            gsa.dyn_params(combos, dev))


@phase("G1 aligner sweep at 1080p: grid_search_align's 27 combos in one "
       "level loop")
def aligner_sweep(dev):
    """The combos of apps/grid_search_align (threshold x fraction x
    max_displacement, window margin widened to 22) on 32 frames of bench.py's
    content through ``align_clip_impl`` with (27,) DynAlignParams, the
    launch counts set to 0 just before and read just after. (a) kernel B
    with per-item thresholds against its plain version on the sweep's
    items; (b) each combo run alone with those values in its AlignerParams
    (ok equal, phase 5's bars); (c) the sweep's align time beside the 27
    runs alone; (d) the FIR warp and the device jitter metric over all
    combos' outputs, timed, the best combo's out/in ratio below 0.6.
    Returns (the kernels line's entry, kernel B's launches, the inputs and
    un-captured figures that J7 and J8 use)."""
    from video_stabilizer_tpu_torch.apps import grid_search_align as gsa
    from video_stabilizer_tpu_torch.config import StabilizerParams
    from video_stabilizer_tpu_torch.models import aligner
    from video_stabilizer_tpu_torch.models.batch import (
        _align_clip_jit, align_clip_impl)
    from video_stabilizer_tpu_torch.ops.gn_solve import gn_solve
    from video_stabilizer_tpu_torch.utils import graphs
    from video_stabilizer_tpu_torch.utils.flow import (
        gray_f32, median_jitter_px_device_impl)

    frames, clip, gray, combos, base, params, dyn = sweep_inputs(dev)
    levels = len(aligner.level_specs(WIDTH, HEIGHT, base))
    torch.cuda.synchronize()
    reset_launch_counts()
    with mock.patch.object(aligner, "gn_solve", wraps=gn_solve) as spy:
        (meas, ok), sweep_ms = timed(
            lambda: align_clip_impl(gray, base, WIDTH, HEIGHT, dyn=dyn))
    launches = launch_counts()
    calls = [(c.args, c.kwargs) for c in spy.call_args_list]
    check(launches["gn_solve"] == levels == len(calls)
          and calls[0][1]["threshold"].shape == (len(combos) * SWEEP_FRAMES,),
          f"kernel B launched once per level ({launches['gn_solve']} of "
          f"{levels}) for all {len(combos)} x {SWEEP_FRAMES} items, one "
          "threshold per item")
    check(launches[KEY_NAME] == 2,
          f"kernel I launched {launches[KEY_NAME]} times (want 2: the "
          "clip's zero carry and its keyframes, every level in one launch "
          "each)")
    check(launches[SEL_NAME] == levels,
          f"kernel J launched {launches[SEL_NAME]} times (want {levels}: "
          f"once per level for all {len(combos)} x {SWEEP_FRAMES} items, one "
          "keep fraction per item)")

    log("  (a) kernel B with per-item thresholds vs its plain version:")
    entry = per_item_b(calls)

    ok_equal, bit_equal, d_ab, d_t, alone_ms = True, 0, 0.0, 0.0, 0.0
    for c, (thr, frac, md) in enumerate(combos):
        one = dataclasses.replace(base, threshold=thr, smallest_fraction=frac,
                                  max_displacement=md)
        (m1, ok1), ms = timed(
            lambda: align_clip_impl(gray, one, WIDTH, HEIGHT))
        alone_ms += ms
        same = bool((ok1 == ok[c]).all())
        ok_equal &= same
        both = ok1 & ok[c]
        if bool(both.any()):
            d = (m1 - meas[c]).abs()[both]
            d_ab = max(d_ab, float(d[:, :2].max()))
            d_t = max(d_t, float(d[:, 2:].max()))
        bit_equal += int(torch.equal(m1, meas[c]) and same)
        if not same:
            log(f"    combo {c} ({thr}, {frac}, {md}): ok differs on frames "
                f"{torch.nonzero(ok1 != ok[c]).flatten().tolist()}")
    check(ok_equal and d_ab <= GN_AB_BAR and d_t <= GN_T_BAR,
          f"(b) the sweep vs each combo alone: ok equal on every frame "
          f"{ok_equal}; |dA,dB| {d_ab:.2e} (bar {GN_AB_BAR:.0e}), |dTX,dTY| "
          f"{d_t:.2e} px (bar {GN_T_BAR:.0e}); {bit_equal} of {len(combos)} "
          "combos bit-equal")
    log(f"  (c) align: the sweep {sweep_ms:.1f} ms for {len(combos)} combos "
        f"un-captured; the combos one by one {alone_ms:.1f} ms in all "
        f"({alone_ms / sweep_ms:.2f}x the sweep)")
    rates = ok[:, 1:].float().mean(dim=1)
    log(f"  align success per combo (frames 1-{SWEEP_FRAMES - 1}): "
        + ", ".join(f"{float(r):.2f}" for r in rates))
    # The sweep's align replayed (``_align_clip_jit``, the (27,) dyn an
    # input), against the un-captured run above.
    graphs.reset([_align_clip_jit])
    walls, same = [], True
    for k in range(1 + J_CLIP_REPLAYS):
        (m_r, ok_r), ms = timed(
            lambda: _align_clip_jit(gray, base, WIDTH, HEIGHT, dyn))
        same &= torch.equal(m_r, meas) and torch.equal(ok_r, ok)
        if k:
            walls.append(ms)
        else:
            first_ms = ms
    check(same and _align_clip_jit.replays == J_CLIP_REPLAYS,
          f"    the sweep's align replayed ({_align_clip_jit.replays} "
          "replays): meas and ok byte-equal to the un-captured sweep")
    log(f"    first call {first_ms:.1f} ms, graph pool "
        f"{_align_clip_jit.stats()[0]['pool_bytes'] / 1e9:.2f} GB; "
        + replay_figures(walls, [sweep_ms]))
    # The smoother sweep's one align (apps/grid_search_smoother.py): the
    # clip without dyn at the default parameters, a one-shot call.
    one_shot = StabilizerParams().aligner
    with graphs.eager():
        (m_e, ok_e), eager_ms = timed(
            lambda: _align_clip_jit(gray, one_shot, WIDTH, HEIGHT))
    (m_f, ok_f), first_ms = timed(
        lambda: _align_clip_jit(gray, one_shot, WIDTH, HEIGHT))
    check(torch.equal(m_f, m_e) and torch.equal(ok_f, ok_e),
          f"    the smoother sweep's one align: its first call (eager run "
          f"and capture) {first_ms:.1f} ms against {eager_ms:.1f} ms "
          "un-captured, byte-equal")

    with graphs.eager():
        outs, warp_ms = timed(lambda: gsa.warp_combos(clip, meas, ok,
                                                      params))
        in_j, in_ms = timed(lambda: float(median_jitter_px_device_impl(
            gray_f32(clip))))
        out_j, metric_ms = timed(lambda: median_jitter_px_device_impl(
            gray_f32(outs)).cpu())
    ratios = out_j / max(in_j, 1e-9)
    best = int(torch.argmin(ratios))
    log(f"  (d) un-captured: FIR warp of {outs.shape[0]} x {outs.shape[1]} "
        f"frames {warp_ms:.1f} ms; device jitter metric over all combos' "
        f"outputs {metric_ms:.1f} ms ({outs.shape[0] * (outs.shape[1] - 1)} "
        f"pairs), over the input {in_ms:.1f} ms (replayed: J7, J8)")
    check(bool(torch.isfinite(ratios).all()) and float(ratios[best]) < 0.6,
          f"input jitter {in_j:.3f} px; best combo {combos[best]} out/in "
          f"{float(ratios[best]):.4f}, worst {float(ratios.max()):.4f}")
    del outs
    inputs = dict(gray=gray, clip=clip, dyn=dyn, params=params, in_j=in_j,
                  ratios=ratios, align_ms=sweep_ms, warp_ms=warp_ms,
                  metric_ms=metric_ms)
    return entry, launches["gn_solve"], inputs


J_SWEEP_REPLAYS = 3


@phase("J7. G1's sweep (run_combos: align, accumulate and FIR warp of 27 "
       "combos) captured and replayed against the un-captured one")
def sweep_replayed(g1):
    """``run_combos`` on G1's inputs: the un-captured call twice, the first
    call and J_SWEEP_REPLAYS replays, outputs, meas and ok byte-equal;
    times beside G1 (c) and (d)'s un-captured align and FIR. Returns the
    last replay's outputs for J8."""
    from video_stabilizer_tpu_torch.apps import grid_search_align as gsa

    out, walls, eager_ms, _ = program_vs_eager(
        gsa.run_combos,
        lambda: gsa.run_combos(g1["gray"], g1["clip"], g1["dyn"],
                               g1["params"]),
        ("outputs", "meas", "ok"), J_SWEEP_REPLAYS)
    log(f"  run_combos {replay_figures(walls, eager_ms)}; G1's un-captured "
        f"align {g1['align_ms']:.1f} ms + FIR {g1['warp_ms']:.1f} ms")
    log_digest("J7", "the last replay's outputs, meas and ok", out)
    return out[0]


@phase("J8. the dense-LK jitter metric (median_jitter_px_device_impl) on "
       "J7's outputs, captured and replayed against the un-captured one")
def metric_replayed(outs, g1):
    """``median_jitter_px_device_impl`` over the 27 combos' outputs: the
    un-captured call twice, the first call and J_SWEEP_REPLAYS replays,
    byte-equal f32; the out/in ratios equal G1 (d)'s."""
    from video_stabilizer_tpu_torch.utils.flow import (
        gray_f32, median_jitter_px_device_impl)

    gray = gray_f32(outs)
    del outs
    out, walls, eager_ms, _ = program_vs_eager(
        median_jitter_px_device_impl,
        lambda: (median_jitter_px_device_impl(gray),), ("medians",),
        J_SWEEP_REPLAYS)
    ratios = out[0].cpu() / max(g1["in_j"], 1e-9)
    check(torch.equal(ratios, g1["ratios"]),
          "the replayed metric's out/in ratios equal G1 (d)'s")
    log(f"  metric over {gray.shape[0]} x {gray.shape[1] - 1} pairs "
        f"{replay_figures(walls, eager_ms)}; G1 (d) un-captured "
        f"{g1['metric_ms']:.1f} ms")


@phase("G2 kernel C with per-item thresholds vs its plain version (phase "
       "8's 4K items)")
def check_gn8_per_item(cap):
    """Phase 8's captured and perspective items, each with a threshold drawn
    from ITEM_THRESHOLDS, at all 7 levels, with phase 8's bars: converged
    equal and corners within GN8_CORNER_BAR on every item; the perspective
    items' p6/p7 >= 10x the p6/p7 gap of the items whose engines ran the
    same iterations (an item whose engines stopped apart compares two
    iterates, not the kernel's p6/p7 update); two launches bit-identical.
    Items whose engines stopped apart are printed with the plain engine's
    move at the deciding step, but not held to KNIFE_EDGE: along the 8x8
    Hessian's ill-conditioned p6/p7 direction the engines' steps part by up
    to 20 % of a 0.01 px threshold at 60x33 (an NVIDIA H100 80GB HBM3, 700
    W), which the corner bar covers. Times and bound of the captured items;
    the p6/p7 gap printed by threshold."""
    from video_stabilizer_tpu_torch.ops.gn8_solve import (
        OPS_PER_SAMPLE, gn8_solve, gn8_solve_plain)

    g = torch.Generator().manual_seed(SEED + 11)
    choices = torch.tensor(ITEM_THRESHOLDS)
    totals = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0)
    bound_share = dict(bytes=0.0, operations=0.0)
    worst = 0.0
    for (args, kw), (pargs, pkw) in zip(cap["gn8_calls"], cap["persp_calls"]):
        w, h = kw["width"], kw["height"]
        level = f"{w}x{h} (P={args[0].shape[3]}, N={args[0].shape[1]})"
        gaps, conv_equal, p67_gap, median, apart = [], True, 0.0, 0.0, []
        n_items = 0
        for name, (a, k) in (("captured", (args, kw)),
                             ("perspective", (pargs, pkw))):
            items = a[9].shape[0]
            n_items += items
            thr = choices[torch.randint(0, len(choices), (items,),
                                        generator=g)].to(a[0].device)
            k = dict(k, threshold=thr)
            p_g, c_g, _, i_g = gn8_solve(*a, **k)
            p_w, c_w, _, i_w = gn8_solve_plain(*a, **k)
            check(deterministic(lambda: gn8_solve(*a, **k)),
                  f"{level} {name}: two launches give bit-identical outputs")
            conv_equal &= bool((c_g == c_w).all())
            gaps.append(float(corner_gap(p_g, p_w, w, h).max()))
            apart += step_apart_items(gn8_solve_plain, a, k, i_g, i_w,
                                      corner_gap)
            d67 = (p_g[:, 6:] - p_w[:, 6:]).abs().amax(dim=1)
            same = i_g == i_w
            if bool(same.any()):
                p67_gap = max(p67_gap, float(d67[same].max()))
            log(f"    {level} {name}, {items} items: |d iters| "
                f"{int((i_g - i_w).abs().max())}; p6/p7 gap by threshold: "
                + ", ".join(f"{v} px {float(d67[thr == v].max()):.2e}"
                            for v in ITEM_THRESHOLDS
                            if bool((thr == v).any())))
            if name == "perspective":
                median = float(p_w[:, 6:].abs().amax(dim=1).median())
            else:
                kwc, p_cap, iters = k, p_g, i_g
        worst = max(worst, *gaps)
        check(conv_equal and max(gaps) <= GN8_CORNER_BAR
              and median >= 10 * p67_gap,
              f"{level}: converged equal {conv_equal}; corner gap "
              f"{max(gaps):.2e} px (bar {GN8_CORNER_BAR:.0e}) over all "
              f"{n_items} items, {len(apart)} of them stopped apart; "
              f"perspective items' max(|p6|,|p7|) median {median:.2e} vs "
              f"the p6/p7 gap {p67_gap:.2e} at equal iterations")
        ms = cuda_ms(lambda: gn8_solve(*args, **kwc), 10)
        device_ms = graph_ms(lambda: gn8_solve(*args, **kwc), 10)
        plain_ms = cuda_ms(lambda: gn8_solve_plain(*args, **kwc), 1)
        bytes_moved = gn_bytes(args, p_cap, iters)
        ops = int(iters.sum()) * 2 * args[0].shape[1] * OPS_PER_SAMPLE
        bound_ms, bound_by = roofline(bytes_moved, ops)
        bound_share[bound_by] += bound_ms
        log(f"    kernel {ms:.4f} ms (device {device_ms:.4f} ms), plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        for key, val in (("ms", ms), ("device_ms", device_ms),
                         ("plain_ms", plain_ms), ("bound_ms", bound_ms)):
            totals[key] += val
    log(f"  per chunk (sum of {len(cap['gn8_calls'])} levels): kernel "
        f"{totals['ms']:.4f} ms (device {totals['device_ms']:.4f} ms), "
        f"plain {totals['plain_ms']:.3f} ms, bound "
        f"{totals['bound_ms']:.4f} ms")
    return gn_item_entry(ITEM_NAME_C,
                         "video_stabilizer_tpu_torch/csrc/gn8_solve.cu",
                         GN8_REPLACES, totals, bound_share, worst)


@phase("G2 path: the 4K homography aligner over three thresholds in one "
       "level loop")
def homography_sweep(params_4k, dev):
    """8 frames of config 4's content (seed 5) through ``align_clip_impl``
    with model="homography" and (3,) DynAlignParams (ITEM_THRESHOLDS, the
    params' fraction and bound), the launch counts set to 0 just before and
    read just after: kernel C once per level, kernel B never. The 0.02 px
    combo against the run without ``dyn``: ok equal (the corner gap at full
    size printed). Returns kernel C's launches."""
    from video_stabilizer_tpu_torch.models.aligner import (
        DynAlignParams, level_specs)
    from video_stabilizer_tpu_torch.models.batch import align_clip_impl

    al = params_4k.aligner
    frames = synth_streams(dev, 8, MAIN_CONTENT, H4K, W4K,
                           seeds=[SEEDS_4K[0]])[0][0]
    clip = torch.from_numpy(frames).to(dev)
    c_n = len(ITEM_THRESHOLDS)
    dyn = DynAlignParams(
        torch.tensor(ITEM_THRESHOLDS, device=dev),
        torch.full((c_n,), al.smallest_fraction, device=dev),
        torch.full((c_n,), al.max_displacement, device=dev))
    levels = len(level_specs(W4K, H4K, al))
    torch.cuda.synchronize()
    reset_launch_counts()
    (p, ok), ms = timed(lambda: align_clip_impl(clip, al, W4K, H4K, dyn=dyn,
                                                model=HOMOGRAPHY))
    launches = launch_counts()
    check(launches["gn8_solve"] == levels and launches["gn_solve"] == 0,
          f"kernel C launched once per level ({launches['gn8_solve']} of "
          f"{levels}) for {c_n} x 8 items, kernel B not")
    check(launches[KEY_NAME] == 2,
          f"kernel I launched {launches[KEY_NAME]} times (want 2: the "
          "clip's zero carry and its keyframes, every level in one launch "
          "each)")
    check(launches[SEL_NAME] == levels,
          f"kernel J launched {launches[SEL_NAME]} times (want {levels}: "
          "once per level, its homography form)")
    log(f"  sweep {ms:.1f} ms; align success per threshold "
        + ", ".join(f"{t} px {int(ok[c, 1:].sum())}/7"
                    for c, t in enumerate(ITEM_THRESHOLDS)))
    (p1, ok1), ms1 = timed(lambda: align_clip_impl(clip, al, W4K, H4K,
                                                   model=HOMOGRAPHY))
    c = ITEM_THRESHOLDS.index(al.threshold)
    both = ok1 & ok[c]
    gap = float(corner_gap(p[c][both], p1[both], W4K, H4K).max()) \
        if bool(both.any()) else 0.0
    check(bool(torch.isfinite(p).all()) and bool((ok1 == ok[c]).all())
          and int(ok1[1:].sum()) >= 6,
          f"the {al.threshold} px combo vs the run without dyn ({ms1:.1f} "
          f"ms): ok equal {bool((ok1 == ok[c]).all())}, "
          f"{int(ok1[1:].sum())}/7 aligned; corner gap {gap:.2e} px at "
          f"{W4K}x{H4K}")
    return launches["gn8_solve"]


def write_y4m(path, gray_frames):
    """A 420jpeg YUV4MPEG2 file of (T, H, W) u8 gray frames with neutral
    chroma, laid out as tests/test_native.py:63-71 writes one."""
    t, h, w = gray_frames.shape
    chroma = np.full((h // 2, w // 2), 128, np.uint8).tobytes()
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 C420jpeg\n".encode())
        for y in gray_frames:
            f.write(b"FRAME\n" + y.tobytes() + chroma + chroma)


@phase("G3 the apps' pipeline at 1080p without cv2: .y4m through the "
       "native reader, video_test's three modes, the device jitter metric")
def apps_pipeline(dev):
    """32 frames of bench.py's content written as a .y4m, read back through
    ``utils.io.read_video`` (the native Y4M reader), stabilized by
    apps/video_test's ``stabilize_streaming``, ``stabilize_chunked`` and
    ``stabilize_batch`` (crop 0, video_test.cpp:54), each scored with
    ``median_jitter_px_device``: 22 outputs of 1080x1920x3, output jitter
    below 0.6x the input's (tests/test_flow.py:72-86). Nothing is written
    as mp4."""
    import tempfile

    from video_stabilizer_tpu_torch.apps import video_test
    from video_stabilizer_tpu_torch.config import StabilizerParams
    from video_stabilizer_tpu_torch.utils import graphs, io, native
    from video_stabilizer_tpu_torch.utils.flow import median_jitter_px_device

    frames = synth_streams(dev, SWEEP_FRAMES, MAIN_CONTENT, seeds=[SEED])[0][0]
    check(native.available(), "native/libframepipe.so built and loaded")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "clip.y4m")
        write_y4m(path, frames[..., 0])
        (read, ms) = timed(lambda: list(io.read_video(path)))
    check(len(read) == SWEEP_FRAMES
          and np.array_equal(np.stack(read), frames),
          f"the .y4m reads back as the clip's {len(read)} frames, bit-equal "
          f"({ms:.1f} ms)")
    params = StabilizerParams(crop_pixels=0)
    in_j = median_jitter_px_device(frames, device=dev)
    for mode, run in (("streaming", video_test.stabilize_streaming),
                      ("chunked", video_test.stabilize_chunked),
                      ("batch", video_test.stabilize_batch)):
        (outs, failures), ms = timed(lambda: run(read, params, device=dev))
        out_j = median_jitter_px_device(outs, device=dev)
        check(len(outs) == SWEEP_FRAMES - params.lag
              and outs[0].shape == (HEIGHT, WIDTH, 3)
              and out_j < 0.6 * in_j,
              f"{mode}: {len(outs)} outputs in {ms:.1f} ms, align failures "
              f"{failures}; jitter {in_j:.3f} -> {out_j:.3f} px (ratio "
              f"{out_j / in_j:.3f}, bar 0.6)")
    # The batch mode is a one-shot caller of ``_stabilize_clip_jit`` (the
    # streams program on one stream): its call above paid the eager run and
    # the capture.
    with graphs.eager():
        (eager_outs, _), eager_ms = timed(
            lambda: video_test.stabilize_batch(read, params, device=dev))
    check(all(np.array_equal(a, b) for a, b in zip(eager_outs, outs)),
          f"batch mode un-captured {eager_ms:.1f} ms against its first call "
          f"{ms:.1f} ms (eager run and capture): outputs byte-equal")


# --------------------------------------------------------------------------
# The streaming path: one stream, one frame in and one out (VideoStabilizer)
# --------------------------------------------------------------------------

STREAM_FRAMES = 48        # S1's timed frames from a fresh state
STREAM_PROFILED = 8       # then these under torch.profiler
STREAM_CAPTURED = 4       # then these with the kernels' inputs captured
STREAM_STEADY = 12        # latency over frames STREAM_STEADY .. 47
STREAM_VS_CHUNKED = 32    # S2: frames through both paths
# The entries of S3 in the kernels line, each with the launch count of S1
# that it reports.
STREAM_KERNELS = (("warp_frames[similarity,bilinear,1 frame]",
                   "warp_frames[similarity,bilinear]"),
                  ("gn_solve[1 item]", "gn_solve"))
STREAM_TOP = ("ConvertToGray", "AlignNextFrame", "SmootherUpdate",
              "WarpBySimilarityTransform")


def recording(stab):
    """Wrap ``stab``'s aligner so that every frame's (transform, ok) device
    tensors are kept (read after the run, so no extra host sync)."""
    record = []
    align = stab.aligner.align_next_frame

    def recorded(gray):
        t, ok = align(gray)
        record.append((t, ok))
        return t, ok
    stab.aligner.align_next_frame = recorded
    return record


def read_record(record):
    """(meas (T, 4), ok (T,)) numpy of a ``recording``."""
    meas = torch.stack([t for t, _ in record]).cpu().numpy()
    ok = torch.stack([k for _, k in record]).cpu().numpy()
    return meas, ok


def timed_stream(host, poses, params, dev, eager=False):
    """``STREAM_FRAMES`` pinned host frames through a fresh
    ``VideoStabilizer`` with every launch count set to 0 before and read
    after, each frame timed on the host clock up to its sync: through its
    replayed graphs, or with ``eager`` un-captured (``graphs.eager()``)
    under a span Recorder, for the stage table. Checks the outputs, the
    align success and TX/TY against the known motion (phase 9's bars) and
    the launches: kernel A once per output, kernel B once per level of
    every frame (the first included, as in the JAX package), kernel C
    never, kernel D once per smoothed window. Prints the per-frame
    latency (and the stage table); returns its figures, the stabilizer (to
    run on) and the recorded measurements."""
    from video_stabilizer_tpu_torch.models import aligner
    from video_stabilizer_tpu_torch.models.stabilizer import VideoStabilizer
    from video_stabilizer_tpu_torch.utils import graphs
    from video_stabilizer_tpu_torch.utils.spans import Recorder

    lag, crop = params.lag, params.crop_pixels
    stab = VideoStabilizer(params, dev)
    record = recording(stab)
    mode = graphs.eager if eager else contextlib.nullcontext
    spans = Recorder if eager else contextlib.nullcontext
    torch.cuda.synchronize()
    reset_launch_counts()
    walls, device_ms, stage_runs, outs = [], [], [], []
    with mode():
        for i in range(STREAM_FRAMES):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            with spans() as rec:
                out = stab.process_frame(host[i])
            end.record()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            device_ms.append(start.elapsed_time(end))
            if eager:
                stage_runs.append(rec.totals())
            if out is not None:
                outs.append(out)
    launches = launch_counts()

    want_shape = (HEIGHT - 2 * crop, WIDTH - 2 * crop, 3)
    check(len(outs) == STREAM_FRAMES - lag
          and all(tuple(o.shape) == want_shape and o.dtype == torch.uint8
                  for o in outs),
          f"{len(outs)} outputs (want {STREAM_FRAMES - lag}), each "
          f"{want_shape} u8: {sorted({tuple(o.shape) for o in outs})}")
    check(all(bool(o.any()) for o in outs), "no output blank")
    meas, ok = read_record(record)
    rate = float(ok[1:].mean())
    check(rate >= 0.9, f"align success {rate:.4f} ({int(ok[1:].sum())} of "
          f"{STREAM_FRAMES - 1} alignable frames)")
    rms, max_err = known_motion_error(meas[None, :, 2:], ok[None],
                                      poses[None, :STREAM_FRAMES])
    check(max_err < 0.5 and rms < 0.2,
          f"measured TX/TY against the clip's known motion: RMS {rms:.4f} "
          f"px, max {max_err:.4f} px")
    levels = len(aligner.level_specs(WIDTH, HEIGHT, params.aligner))
    want_b = levels * STREAM_FRAMES
    # The smoother finalizes a frame once smoother_memory more have come.
    want_d = STREAM_FRAMES - params.smoother_memory
    want_h = (levels - 1) * STREAM_FRAMES
    # From a fresh state frame 0 fills buffer 0 and the odd frames are the
    # keyframe frames, each computing its keyframe's levels in one launch.
    want_i = STREAM_FRAMES // 2
    n_a = launches.get("warp_frames[similarity,bilinear]", 0)
    check(n_a == STREAM_FRAMES - lag and launches["gn_solve"] == want_b
          and launches["gn8_solve"] == 0
          and launches["tvl1_smooth"] == want_d
          and launches[PINV_NAME] == want_b and launches[ACCUM_NAME] == 0
          and launches[GRAY_NAME] == STREAM_FRAMES
          and launches[PYR_NAME] == want_h
          and launches[KEY_NAME] == want_i
          and launches[SEL_NAME] == want_b
          and sum(launches.values())
          == n_a + 3 * want_b + want_d + STREAM_FRAMES + want_h + want_i,
          f"launches {launches}: kernel A {STREAM_FRAMES - lag} (one per "
          f"output), kernels B, E and J {want_b} each (one per level of every "
          f"frame, the first included), kernel C 0, kernel D {want_d} (one "
          "per smoothed window), kernel F 0 (the streaming accumulator is "
          f"the host's), kernel G {STREAM_FRAMES} (one per frame), kernel H "
          f"{want_h} (one per level below the first of every frame), "
          f"kernel I {want_i} (one per keyframe frame, every level in one "
          "launch)")

    steady = np.asarray(walls[STREAM_STEADY:])
    log(f"  {'un-captured (graphs.eager())' if eager else 'replayed'}: "
        f"per-frame latency, host clock up to the frame's sync, frames "
        f"{STREAM_STEADY}-{STREAM_FRAMES - 1}: median "
        f"{np.median(steady):.1f} ms, p90 {np.percentile(steady, 90):.1f} "
        f"ms, min {steady.min():.1f}, max {steady.max():.1f}; on the "
        f"device timeline median "
        f"{np.median(device_ms[STREAM_STEADY:]):.1f} ms")
    log(f"  frames 0-{STREAM_STEADY - 1} (host clock): "
        + ", ".join(f"{w:.0f}" for w in walls[:STREAM_STEADY]) + " ms")
    figures = dict(median=float(np.median(steady)),
                   p90=float(np.percentile(steady, 90)), align=None,
                   success=rate, rms=rms, max_err=max_err)
    if not eager:
        return dict(launches=launches, levels=levels, stab=stab, meas=meas,
                    ok=ok, outs=outs, figures=figures, walls=walls)
    runs = stage_runs[STREAM_STEADY:]
    names = sorted({k for r in runs for k in r},
                   key=lambda k: (k not in STREAM_TOP,
                                  STREAM_TOP.index(k) if k in STREAM_TOP
                                  else 0, k))
    stages = {k: float(np.mean([r.get(k, 0.0) for r in runs]))
              for k in names}
    log(f"  per-frame stage device times, mean of frames {STREAM_STEADY}-"
        f"{STREAM_FRAMES - 1} (CUDA events; the aligner's stages nest in "
        "AlignNextFrame, keyframe runs every other frame):")
    for k in names:
        pad = "" if k in STREAM_TOP else "  "
        log(f"    {pad}{k:<26} {stages[k]:9.3f} ms")
    log(f"    sum of the top stages      "
        f"{sum(stages.get(k, 0.0) for k in STREAM_TOP):9.3f} ms")
    figures["align"] = stages.get("AlignNextFrame", 0.0)
    key_runs = [r["keyframe"] for r in runs if "keyframe" in r]
    log(f"  the un-captured keyframe span, mean of frames {STREAM_STEADY}-"
        f"{STREAM_FRAMES - 1}, {stages.get('keyframe', 0.0):.3f} ms (kernel I "
        f"a launch a level: {KEY_SPAN_BEFORE['stream']} ms); "
        f"{np.mean(key_runs) if key_runs else 0.0:.3f} ms a keyframe frame")
    return dict(launches=launches, levels=levels, stab=stab, meas=meas,
                ok=ok, outs=outs, figures=figures, walls=walls)


@phase("S1. streaming path: 1080p, one stream, VideoStabilizer, timed")
def streaming_path(frames, poses, params, dev):
    """``timed_stream`` on S1's clip, then ``STREAM_PROFILED`` more frames
    under torch.profiler. Returns the first ``STREAM_VS_CHUNKED`` frames'
    results for S2, the launches and S1's figures."""
    # Each frame arrives in its own pinned host buffer, as a camera's
    # decoder would leave it; filling the buffers is set-up, not timed.
    host = [torch.from_numpy(np.ascontiguousarray(f)).pin_memory()
            for f in frames]
    eager = timed_stream(host, poses, params, dev, eager=True)
    run = timed_stream(host, poses, params, dev)
    stab = run["stab"]

    # Device busy share over more frames, from the profiler's raw device
    # events: a frame runs some 40k device operations, too many to build
    # the profiler's event tree (key_averages) in time.
    more = iter(host[STREAM_FRAMES:STREAM_FRAMES + STREAM_PROFILED])
    span_ms, by_name = device_events(
        lambda: stab.process_frame(next(more)), STREAM_PROFILED)
    busy = sum(ms for ms, _ in by_name.values())
    if busy > 0:
        per_frame = busy / STREAM_PROFILED
        events = sum(n for _, n in by_name.values())
        log(f"  {STREAM_PROFILED} replayed frames under torch.profiler: "
            f"{span_ms:.1f} ms on the device timeline, {events} kernels "
            f"and copies ({events / STREAM_PROFILED:.0f} a frame; about "
            f"38k with the plain smoother) "
            f"{busy:.1f} ms: busy {busy / span_ms * 100:.1f} %, idle "
            f"{(1 - busy / span_ms) * 100:.1f} %; {per_frame:.1f} ms of "
            f"device events a frame, "
            f"{per_frame / run['figures']['median'] * 100:.1f} % of the "
            "unprofiled median frame")
    else:
        log("  the profiler recorded no device time: busy share not "
            "measured")
    n_vs = STREAM_VS_CHUNKED - params.lag
    return dict(launches=run["launches"], levels=run["levels"],
                meas=run["meas"][:STREAM_VS_CHUNKED],
                ok=run["ok"][:STREAM_VS_CHUNKED],
                outs=torch.stack(run["outs"][:n_vs]).cpu().numpy(),
                figures=run["figures"], eager=eager, replayed=run,
                host=host)


def stream_digest(run):
    """J3's digest line: a replayed ``timed_stream`` run's outputs,
    measurements, flags, carried aligner state and accumulator."""
    stab = run["stab"]
    log_digest("J3", "the replayed run's outputs, measurements, flags, the "
               "carried aligner state and accumulator",
               (run["outs"], run["meas"], run["ok"], stab.aligner._state,
                stab._accum))


@phase("J3. the streaming path replayed against the un-captured one (S1's "
       "clip, every graph captured)")
def streaming_replayed(host, poses, params, dev, s1):
    """A third fresh ``VideoStabilizer`` over S1's frames, every key of
    its programs captured by S1's replayed run: outputs and measurements of
    both replayed runs byte-equal to S1's un-captured run; the per-frame
    median and p90 over frames 12-47 (36 frames) beside the un-captured
    run's."""
    from video_stabilizer_tpu_torch.models import aligner, smoother
    from video_stabilizer_tpu_torch.models import stabilizer as stab_mod

    progs = (stab_mod._to_gray, aligner._align_next_frame_impl,
             smoother._smooth_window, stab_mod._warp_fn)
    before = {p.name: p.captures for p in progs}
    run = timed_stream(host, poses, params, dev)
    new = {p.name: p.captures - before[p.name] for p in progs}
    check(not any(new.values()),
          f"no new capture in this run ({new}); replays so far "
          f"{ {p.name: p.replays for p in progs} }")
    eager = s1["eager"]
    for name, got in (("S1's replayed run", s1["replayed"]),
                      ("this run", run)):
        same_out = len(got["outs"]) == len(eager["outs"]) and all(
            torch.equal(a, b) for a, b in zip(got["outs"], eager["outs"]))
        same_meas = (np.array_equal(got["meas"], eager["meas"])
                     and np.array_equal(got["ok"], eager["ok"]))
        check(same_out and same_meas,
              f"{name}: {len(got['outs'])} outputs byte-equal "
              f"{same_out}, measurements and flags byte-equal {same_meas}")
    stream_digest(run)
    fig, eag = run["figures"], eager["figures"]
    log(f"  replayed | un-captured, frames {STREAM_STEADY}-"
        f"{STREAM_FRAMES - 1} ({STREAM_FRAMES - STREAM_STEADY} frames): "
        f"median {fig['median']:.2f} | {eag['median']:.1f} ms, p90 "
        f"{fig['p90']:.2f} | {eag['p90']:.1f} ms")
    return fig


@phase("S3 capture: kernels A's and B's inputs from a stream with rotation "
       "and zoom")
def capture_stream(params, dev):
    """A fresh ``VideoStabilizer`` over ``params.lag`` frames of one 1080p
    stream of GN_CONTENT (rotation and zoom jitter), then
    ``STREAM_CAPTURED`` more with kernel A's and B's inputs captured."""
    from video_stabilizer_tpu_torch.models import aligner, batch
    from video_stabilizer_tpu_torch.models.stabilizer import VideoStabilizer
    from video_stabilizer_tpu_torch.ops.gn_solve import gn_solve
    from video_stabilizer_tpu_torch.ops.warp_kernel import warp_frames

    from video_stabilizer_tpu_torch.utils import graphs

    frames, _ = synth_streams(dev, params.lag + STREAM_CAPTURED, GN_CONTENT,
                              seeds=[SEED])
    stab = VideoStabilizer(params, dev)
    # Un-captured: a replay calls no wrapper for the spies to see.
    with graphs.eager():
        for f in frames[0, :params.lag]:
            stab.process_frame(f)
        with mock.patch.object(aligner, "gn_solve",
                               wraps=gn_solve) as gn_spy, \
                mock.patch.object(batch, "warp_frames",
                                  wraps=warp_frames) as warp_spy:
            for f in frames[0, params.lag:]:
                stab.process_frame(f)
    torch.cuda.synchronize()
    return dict(levels=len(aligner.level_specs(WIDTH, HEIGHT,
                                               params.aligner)),
                gn_calls=[(c.args, c.kwargs) for c in gn_spy.call_args_list],
                warp_calls=[(c.args, c.kwargs)
                            for c in warp_spy.call_args_list])


@phase("S5. streaming path with fixed_iters=4: 1080p, S1's stream, timed")
def streaming_fixed(frames, poses, params, dev, s1_figures):
    """S1's clip and checks (``timed_stream``) with
    ``AlignerParams(fixed_iters=4)``: every level of every frame runs
    exactly 4 GN iterations in kernel B's fixed mode (the card's
    counterpart of apps/bench_configs.py's bench_latency ``_fixed4``).
    Prints S1's figures beside S5's."""
    host = [torch.from_numpy(np.ascontiguousarray(f)).pin_memory()
            for f in frames[:STREAM_FRAMES]]
    run = timed_stream(host, poses, params, dev)
    fig = run["figures"]
    log("  S1 (converging loop) | S5 (fixed_iters=4), both replayed: "
        f"per-frame median {s1_figures['median']:.1f} | {fig['median']:.1f} "
        f"ms, p90 {s1_figures['p90']:.1f} | {fig['p90']:.1f} ms, success "
        f"{s1_figures['success']:.4f} | {fig['success']:.4f}, TX/TY RMS "
        f"{s1_figures['rms']:.4f} | {fig['rms']:.4f} px (max "
        f"{s1_figures['max_err']:.4f} | {fig['max_err']:.4f})")
    return run["launches"]


@phase("S2. streaming vs chunked on the card (first 32 frames of S1's clip)")
def streaming_vs_chunked(frames, params, dev, s1):
    """The JAX package's own bars for streaming vs clip (test_batch.py:
    28-83): ok equal, measurements within 1e-5, >= 99.5 % of output pixels
    within 1 LSB (the chunked path accumulates in float32 on the card, the
    streaming one in float64 on the host)."""
    from video_stabilizer_tpu_torch.models import chunked

    out, meas, ok = chunked.stabilize_stream_chunked(
        frames[:STREAM_VS_CHUNKED], params, CHUNK, device=dev)
    same_ok = bool((ok == s1["ok"]).all())
    d_meas = float(np.abs(meas - s1["meas"]).max())
    check(out.shape == s1["outs"].shape,
          f"output {out.shape} (streaming {s1['outs'].shape})")
    within = float((np.abs(out.astype(np.int32) - s1["outs"]) <= 1).mean())
    equal = float((out == s1["outs"]).mean())
    check(same_ok and d_meas <= 1e-5 and within >= 0.995,
          f"ok equal {same_ok}; |d meas| {d_meas:.2e} (bar 1e-5); "
          f"{within * 100:.3f} % of pixels within 1 LSB (bar 99.5 %), "
          f"{equal * 100:.3f} % equal")


@phase("S3. kernels B and A at one item / one frame vs their plain "
       "versions (captured from a stream with rotation and zoom)")
def check_one_item(s1, crop):
    from video_stabilizer_tpu_torch.ops.gn_solve import (
        OPS_PER_SAMPLE, gn_solve, gn_solve_plain, launch_plan)
    from video_stabilizer_tpu_torch.ops.warp_kernel import (
        warp_frame_segments, warp_frames, warp_frames_plain)

    calls, levels = s1["gn_calls"], s1["levels"]
    check(len(calls) == levels * STREAM_CAPTURED,
          f"{len(calls)} kernel B calls over {STREAM_CAPTURED} frames "
          f"({levels} levels)")
    totals = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0)
    bound_share = dict(bytes=0.0, operations=0.0)
    worst = 0.0
    for lvl in range(levels):
        items = calls[lvl::levels]           # this level of every frame
        kw = items[0][1]
        n, p = items[0][0][0].shape[1], items[0][0][0].shape[3]
        level = f"{kw['width']}x{kw['height']} (P={p}, N={n})"
        same, d_ab, d_t, iters, ab = True, 0.0, 0.0, [], []
        one_item = all(args[-1].shape[0] == 1 for args, _ in items)
        for args, k in items:
            t_g, c_g, _, i_g = gn_solve(*args, **k)
            t_w, c_w, _, i_w = gn_solve_plain(*args, **k)
            same &= bool((c_g == c_w).all())
            d_ab = max(d_ab, float((t_g[:, :2] - t_w[:, :2]).abs().max()))
            d_t = max(d_t, float((t_g[:, 2:] - t_w[:, 2:]).abs().max()))
            iters.append(int(i_g[0]))
            ab.append(float(t_w[0, :2].abs().max()))
        worst = max(worst, d_ab, d_t)
        check(one_item and same and d_ab <= GN_AB_BAR and d_t <= GN_T_BAR,
              f"{level}, {len(items)} frames, one item per launch "
              f"{one_item}: converged equal {same}; "
              f"|dA,dB| {d_ab:.2e} (bar {GN_AB_BAR:.0e}), |dTX,dTY| "
              f"{d_t:.2e} px (bar {GN_T_BAR:.0e}); iterations {iters}")
        check(float(np.median(ab)) >= 10 * GN_AB_BAR,
              f"{level}: the items' max(|A|,|B|) has median "
              f"{float(np.median(ab)):.2e}, >= 10x the A/B bar")
        args, kw = items[0]
        check(deterministic(lambda: gn_solve(*args, **kw)),
              f"{level}: two launches give bit-identical outputs")
        t_g, _, _, i_g = gn_solve(*args, **kw)
        ms = cuda_ms(lambda: gn_solve(*args, **kw), 20)
        device_ms = graph_ms(lambda: gn_solve(*args, **kw), 20)
        plain_ms = cuda_ms(lambda: gn_solve_plain(*args, **kw), 2)
        bytes_moved = gn_bytes(args, t_g, i_g)
        ops = int(i_g.sum()) * 2 * n * OPS_PER_SAMPLE
        bound_ms, bound_by = roofline(bytes_moved, ops)
        bound_share[bound_by] += bound_ms
        log(f"    plan: {describe_plan(launch_plan(1, n))}; kernel "
            f"{ms:.4f} ms (device {device_ms:.4f} ms), plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"{int(i_g[0])} iterations")
        for key, val in (("ms", ms), ("device_ms", device_ms),
                         ("plain_ms", plain_ms), ("bound_ms", bound_ms)):
            totals[key] += val
    log(f"  per frame (sum of {levels} levels, one item each): kernel "
        f"{totals['ms']:.4f} ms (device {totals['device_ms']:.4f} ms), "
        f"plain {totals['plain_ms']:.3f} ms, bound "
        f"{totals['bound_ms']:.4f} ms")
    gn_entry = dict(name="gn_solve[1 item]", route="cuda",
                    source="video_stabilizer_tpu_torch/csrc/gn_solve.cu",
                    replaces=GN_REPLACES, max_abs_err=worst,
                    ms=totals["ms"], device_ms=totals["device_ms"],
                    plain_ms=totals["plain_ms"], bound_ms=totals["bound_ms"],
                    bound_by=max(bound_share, key=bound_share.get),
                    library_ms=None)

    warps = s1["warp_calls"]
    check(len(warps) == STREAM_CAPTURED,
          f"{len(warps)} kernel A calls over {STREAM_CAPTURED} frames")
    max_err, equal = 0, 1.0
    forms = {(tuple(a[0].shape), a[2], tuple(sorted(k.items())))
             for a, k in warps}
    for (frame, ts, c), _ in warps:
        e, q = warp_compare(frame, ts, c)
        max_err, equal = max(max_err, e), min(equal, q)
    check(forms == {((1, HEIGHT, WIDTH, 3), crop,
                      (("interp", "bilinear"), ("model", "similarity")))}
          and max_err <= 1 and equal >= 0.999,
          f"{len(warps)} streaming frames, calls {forms}: max |diff| "
          f"{max_err} LSB, at least {equal * 100:.4f} % equal per frame")
    (frame, ts, c), _ = warps[0]
    seg = warp_frame_segments(frame[None], None, 1, ts, c)
    check(torch.equal(seg, warp_frames(frame, ts, c)),
          "the frame as a one-frame segment: kernel A's segment form gives "
          "the contiguous form's bytes")
    del seg
    ms = cuda_ms(lambda: warp_frames(frame, ts, c), 20)
    device_ms = graph_ms(lambda: warp_frames(frame, ts, c), 20)
    seg_device_ms = graph_ms(
        lambda: warp_frame_segments(frame[None], None, 1, ts, c), 20)
    plain_ms = cuda_ms(lambda: warp_frames_plain(frame, ts, c), 2)
    library_ms = grid_sample_ms(frame, ts, c, 20)
    bound_ms, bound_by, gb, gflop = warp_bound(frame, ts, c, "bilinear",
                                               "similarity")
    log(f"  one frame: kernel {ms:.4f} ms (device {device_ms:.4f} ms; as a "
        f"one-frame segment {seg_device_ms:.4f} ms), "
        f"plain {plain_ms:.3f} ms, grid_sample {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {gb * 1e3:.2f} MB, {gflop:.3f} "
        f"GFLOP); device / bound {device_ms / bound_ms:.1f}")
    warp_entry = dict(name="warp_frames[similarity,bilinear,1 frame]",
                      route="cuda",
                      source="video_stabilizer_tpu_torch/csrc/warp.cu",
                      replaces=WARP_REPLACES, max_abs_err=max_err, ms=ms,
                      device_ms=device_ms, plain_ms=plain_ms,
                      bound_ms=bound_ms, bound_by=bound_by,
                      library_ms=library_ms)
    return warp_entry, gn_entry


@phase("S4. small clip: the streaming path on the card vs on the CPU")
def streaming_small_reference(dev):
    from video_stabilizer_tpu_torch.config import StabilizerParams
    from video_stabilizer_tpu_torch.models.stabilizer import VideoStabilizer
    from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip

    params = StabilizerParams(lag=4, smoother_memory=2, crop_pixels=8)
    frames = synth_shaky_clip(20, 96, 128, seed=52, jitter_px=0.8,
                              pan_px_per_frame=0.3, rot_jitter=0.002)
    runs = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        stab = VideoStabilizer(params, d)
        record = recording(stab)
        outs = [stab.process_frame(f) for f in frames]
        runs[name] = (np.stack([o.cpu().numpy() for o in outs
                                if o is not None]),) + read_record(record)
    (o_g, m_g, k_g), (o_c, m_c, k_c) = runs["card"], runs["cpu"]
    same_ok = bool((k_g == k_c).all())
    within = float((np.abs(o_g.astype(np.int32) - o_c) <= 1).mean())
    check(same_ok and o_g.shape == o_c.shape and within >= 0.99,
          f"ok equal {same_ok} ({int(k_g.sum())} of {k_g.size} aligned); "
          f"outputs {o_g.shape}; |d meas| {np.abs(m_g - m_c).max():.2e}; "
          f"{within * 100:.3f} % of pixels within 1 LSB")


# --------------------------------------------------------------------------
# P1-P5: the measuring tools and the scale-out layer, each run through the
# entry point its user calls, with the launch counts set to 0 before and
# read after
# --------------------------------------------------------------------------

def run_tool(fn, *args, **kw):
    """(return value, stdout lines, launch counts) of one tool run; what it
    prints on stdout and stderr is logged."""
    out, err = io.StringIO(), io.StringIO()
    reset_launch_counts()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        ret = fn(*args, **kw)
    launches = launch_counts()
    lines = out.getvalue().splitlines()
    run_tool.stderr = err.getvalue()
    for line in err.getvalue().splitlines() + lines:
        log("  | " + line)
    return ret, lines, launches


def json_line(lines, metric: str) -> dict:
    """The tool's last stdout line as JSON, checked for its metric and a
    positive finite value."""
    got = json.loads(lines[-1])
    value = got.get("value")
    check(got.get("metric") == metric and isinstance(value, (int, float))
          and math.isfinite(value) and value > 0,
          f"JSON line {got.get('metric')} = {value} {got.get('unit')} "
          f"(want {metric}, a positive finite value)")
    return got


def kernels_launched(launches, a_form: str, b: bool, c: bool, levels: int,
                     what: str):
    """Kernel A's form ``a_form``, B and C as ``b`` and ``c`` say, D, G
    with ``levels`` - 1 launches of H for each of its, and I at least
    once for each G (each chunk's keyframes, every level in one launch;
    each fresh state's zero carry adds one)."""
    check(launches.get(f"warp_frames[{a_form}]", 0) > 0
          and (launches["gn_solve"] > 0) == b
          and (launches["gn8_solve"] > 0) == c
          and launches["tvl1_smooth"] > 0
          and launches[GRAY_NAME] > 0
          and launches[PYR_NAME] == (levels - 1) * launches[GRAY_NAME]
          and launches[KEY_NAME] >= launches[GRAY_NAME]
          and launches[SEL_NAME]
          == launches["gn_solve"] + launches["gn8_solve"],
          f"{what}: launches {launches}")


@phase("P1. python -m video_stabilizer_tpu_torch.bench at its defaults "
       "(8 streams x 16 1080p frames, 4 reps x 4 chunks)")
def tool_bench(smi):
    from video_stabilizer_tpu_torch import bench

    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    with mock.patch.dict(os.environ, env, clear=True):
        (line, ok_rate), lines, launches = run_tool(bench.main)
    got = json_line(lines, "stabilized_1080p_bgr_fps_8streams_chunked")
    check(got == line and set(got) == {"metric", "value", "unit", "device"}
          and got["device"] == smi,
          f"one JSON line of metric, value, unit and device "
          f"{got.get('device')!r}")
    check(ok_rate >= 0.9, f"align success {ok_rate:.4f} (the last chunk)")
    kernels_launched(launches, "similarity,bilinear", True, False, 6,
                     "kernel A (similarity, bilinear), B, D, G and H (5 "
                     "levels a conversion) launched, C not")


@phase("P2. apps/bench_configs.py --mode 4k: config 4, 2 streams x 16 "
       "frames, 3 reps")
def tool_bench_4k():
    from video_stabilizer_tpu_torch.apps import bench_configs

    _, lines, launches = run_tool(bench_configs.main, [
        "--mode", "4k", "--streams", "2", "--frames", "16", "--reps", "3"])
    got = json_line(lines, "stabilized_4k_bgr_homography_lanczos2_fps_"
                           "2streams_chunked")
    check(got["align_success"] >= 0.9,
          f"align success {got['align_success']:.4f} on the frames after "
          "each stream's first")
    kernels_launched(launches, "homography,lanczos2", False, True, 7,
                     "kernel A (homography, Lanczos2), C, D, G and H (6 "
                     "levels a conversion) launched, B not")


LATENCY_MODES = (
    (["--mode", "latency", "--chain", "16", "--reps", "3"],
     "p50_on_device_align_latency_1080p"),
    (["--mode", "latency-chunk2", "--chain", "8", "--reps", "3"],
     "p50_e2e_latency_1080p_chunk2_single_stream"),
    (["--mode", "latency-request", "--samples", "20"],
     "single_request_latency_1080p_chunk2"),
)


@phase("P3. apps/bench_configs.py's latency modes, shortened (chain 16 / "
       "chain 8 / 20 samples)")
def tool_latency():
    from video_stabilizer_tpu_torch.apps import bench_configs

    for argv, metric in LATENCY_MODES:
        _, lines, launches = run_tool(bench_configs.main, argv)
        json_line(lines, metric)
        log(f"  launches: {launches}")


@phase("J4. apps/bench_configs.py --mode latency: 32 streaming align "
       "steps as one captured graph, 5 reps")
def latency_chain(dev):
    from video_stabilizer_tpu_torch.apps import bench_configs
    from video_stabilizer_tpu_torch.config import AlignerParams
    from video_stabilizer_tpu_torch.models import aligner

    chain, reps = 32, 5
    bench_configs.run_chain.reset()
    _, lines, launches = run_tool(bench_configs.main, [
        "--mode", "latency", "--chain", str(chain), "--reps", str(reps)])
    got = json_line(lines, "p50_on_device_align_latency_1080p")
    prog = bench_configs.run_chain
    check(prog.captures == 1 and prog.replays == reps,
          f"run_chain: {prog.captures} capture, {prog.replays} replays "
          f"(want 1 and {reps})")
    levels = len(aligner.level_specs(WIDTH, HEIGHT, AlignerParams()))
    want = levels * chain * (1 + 2 * reps)
    check(launches["gn_solve"] == want and launches["gn8_solve"] == 0,
          f"kernel B launched {launches['gn_solve']} times (want {want}: "
          f"{levels} levels x {chain} steps, in the first call, {reps} "
          f"replays of the chain and {reps} chains issued step by step)")
    want_h = want // levels * (levels - 1)
    check(launches[PYR_NAME] == want_h and launches[GRAY_NAME] == 0,
          f"kernel H launched {launches[PYR_NAME]} times (want {want_h}: "
          f"{levels - 1} levels below the first of every step), kernel G "
          f"{launches[GRAY_NAME]} (the chain's frames are gray already)")
    # Every chain starts from the same fresh state: its odd steps are the
    # keyframe frames (the first step fills buffer 0).
    want_i = (chain // 2) * (1 + 2 * reps)
    check(launches[KEY_NAME] == want_i,
          f"kernel I launched {launches[KEY_NAME]} times (want {want_i}: "
          f"one, every level, for each of the {chain // 2} keyframe steps "
          f"of each chain, in the first call, {reps} replays and {reps} "
          "chains issued step by step)")
    check(launches[SEL_NAME] == want,
          f"kernel J launched {launches[SEL_NAME]} times (want {want}: as "
          "kernel B, once per level of every step)")
    stats = prog.stats()[0]
    issued = [ln for ln in run_tool.stderr.splitlines()
              if "issued one call each" in ln]
    log(f"  on the device (one replay of the {chain}-step graph): p50 "
        f"{got['value']:.3f} ms/frame; issued step by step: "
        f"{issued[0].split(': ', 1)[1] if issued else 'not printed'}; "
        f"capture {stats['capture_s']:.2f} s, instantiate "
        f"{stats['instantiate_s']:.2f} s, graph pool "
        f"{stats['pool_bytes'] / 1e6:.1f} MB")

    # The same chain timed on the device timeline (CUDA events) both ways:
    # one replay of the chain's graph, and its steps' graphs replayed one
    # call each.
    from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip
    params = AlignerParams()
    clip = torch.from_numpy(synth_shaky_clip(
        chain, HEIGHT, WIDTH, seed=6, jitter_px=1.0, color=False)).to(dev)
    state0 = aligner.init_state(WIDTH, HEIGHT, params, dev)

    def device_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(state0, clip, params, WIDTH, HEIGHT)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / chain
    whole = [device_ms(prog) for _ in range(reps)]
    steps = [device_ms(bench_configs._chain_steps) for _ in range(reps)]
    log(f"  device timeline, ms a step: the chain's graph "
        + ", ".join(f"{t:.3f}" for t in whole) + "; the steps' graphs one "
        "call each " + ", ".join(f"{t:.3f}" for t in steps))


@phase("P4. apps/profile_chunk.py on one 1080p chunk (8 x 16 frames): per "
       "kernel, --parse-only, --by-source, --copies")
def tool_profile():
    from video_stabilizer_tpu_torch.apps import profile_chunk

    with tempfile.TemporaryDirectory() as logdir:
        args = ["--logdir", logdir, "--top", "15"]
        t0 = time.perf_counter()
        totals, _, _ = run_tool(profile_chunk.main, args)
        size = os.path.getsize(os.path.join(logdir, "trace.json"))
        log(f"  run, trace and summary {time.perf_counter() - t0:.1f} s; "
            f"trace {size / 1e6:.1f} MB")
        names = list(totals)
        for symbol in ("warp_kernel", "gn_solve_kernel", "tvl1_wave_kernel",
                       "pinv4_kernel", "accum_kernel", "gray_kernel",
                       "pyr_down_kernel", "keyframe_kernel",
                       profile_chunk.HAND_KERNELS["J"][0]):
            hits = [n for n in names if symbol in n]
            check(bool(hits), f"the per-kernel table names {symbol}: "
                  f"{hits[:1]}")
        t0 = time.perf_counter()
        parsed, _, _ = run_tool(profile_chunk.main, args + ["--parse-only"])
        check(parsed == totals,
              f"--parse-only reprints the same {len(totals)} totals "
              f"({time.perf_counter() - t0:.1f} s)")
        by_src, _, _ = run_tool(profile_chunk.main,
                                args + ["--parse-only", "--by-source"])
        copies, _, _ = run_tool(profile_chunk.main,
                                args + ["--parse-only", "--copies"])
    copy_report(copies)
    total = sum(us for us, _ in totals.values())
    events = sum(n for _, n in totals.values())
    hand = profile_chunk.hand_kernel_totals(totals)
    log("  hand kernels in the chunk: " + ", ".join(
        f"{k} {us / 1e3:.3f} ms x{n}" for k, (us, n) in hand.items()))
    select = [(us, n) for name, (us, n) in by_src.items()
              if "/models/aligner.py" in name and "_level_prelude" in name]
    log(f"  select's own frames (aligner._level_prelude, outside kernel "
        f"J's module): {sum(n for _, n in select)} device events, "
        f"{sum(us for us, _ in select) / 1e3:.3f} ms")
    smooth = [(us, n) for name, (us, n) in by_src.items()
              if "/ops/tvl1.py" in name or "/models/smoother.py" in name]
    log(f"  the smoother's device work in the chunk: "
        f"{sum(n for _, n in smooth)} kernels, "
        f"{sum(us for us, _ in smooth) / 1e3:.3f} ms, of {events} device "
        f"events and {total / 1e3:.1f} ms in all (the plain loop: 30,316 "
        "kernels)")
    for what, source, plain in (
            ("Jacobi pseudo-inverse's (kernel E)", "/ops/linalg.py", "6,828"),
            ("accumulator's (kernel F)", "/ops/accum.py", "2,272"),
            ("gray conversion's (kernel G)", "/ops/gray.py", None),
            ("pyramid's (kernel H)", "/ops/pyr_down.py", None),
            ("keyframe precompute's (kernel I)", "/ops/keyframe.py",
             "about 400"),
            ("select prelude's (kernel J)", "/ops/prelude.py", None)):
        # pad_edge (ops/pyr_down.py) served the plain keyframe's gradients
        # and windows.
        rows = [(us, n) for name, (us, n) in by_src.items()
                if source in name and "pad_edge" not in name]
        log(f"  the {what} device work in the chunk: "
            f"{sum(n for _, n in rows)} kernels, "
            f"{sum(us for us, _ in rows) / 1e3:.3f} ms"
            + (f" (the plain version: {plain} kernels)" if plain else ""))
    mine = sum(us for name, (us, _) in by_src.items()
               if name.startswith(profile_chunk.PACKAGE))
    check(total > 0 and mine / total > 0.9,
          f"--by-source: {mine / 1e3:.1f} of {total / 1e3:.1f} ms of device "
          f"time ({100 * mine / max(total, 1e-9):.1f} %) on frames under "
          f"{profile_chunk.PACKAGE}")


def copy_report(copies):
    """Log the chunk's device copies (``profile_chunk.py --copies``: by
    source frame, issuing operator and its input shapes) with their total,
    and check that kernel A reads the delayed frames where they lie: no
    copy under ``batch.warp_delayed`` or ``batch._warp_frames``, and no
    concatenation of frames under ``chunked.stabilize_chunk_core`` (its one
    frame copy is the new tail's)."""
    log(f"  device copies in the chunk: "
        f"{sum(us for us, _ in copies.values()) / 1e3:.3f} ms, "
        f"{sum(n for _, n in copies.values())} copies at {len(copies)} "
        "sites:")
    for site, (us, n) in sorted(copies.items(), key=lambda kv: -kv[1][0]):
        log(f"    {us / 1e3:8.3f} ms x{n:<4d} {site}")
    warp = [k for k in copies
            if "/models/batch.py" in k and ("): warp_delayed " in k
                                            or "): _warp_frames " in k)]
    frames = f"{HEIGHT}, {WIDTH}, 3]"
    cat = [k for k in copies if "): stabilize_chunk_core " in k
           and "aten::cat" in k and frames in k]
    check(not warp and not cat,
          f"no copy of the delayed frames: {len(warp)} copy sites under "
          f"warp_delayed / _warp_frames, {len(cat)} frame concatenations "
          "under stabilize_chunk_core")


@phase("P5. the scale-out modules on the card: graft_entry, the one-card "
       "mesh, multihost_smoke")
def scale_out(params, dev):
    # The two-process CPU smoke runs beside the card's part of the phase.
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    smoke = subprocess.Popen(
        [sys.executable, "-m", "video_stabilizer_tpu_torch.apps."
         "multihost_smoke"], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        on_card(params, dev)
        text, _ = smoke.communicate(timeout=180)
    finally:
        if smoke.poll() is None:
            smoke.kill()
            smoke.wait()
    for line in text.splitlines()[-6:]:
        log("  | " + line)
    check(smoke.returncode == 0 and "multihost smoke OK" in text,
          f"multihost_smoke (2 processes, CPU, gloo): exit "
          f"{smoke.returncode} after {time.perf_counter() - t0:.1f} s")


def on_card(params, dev):
    """P5's card part: the graft entry points, and a sharded chunk on the
    one-card mesh against the unsharded call."""
    from video_stabilizer_tpu_torch import graft_entry, parallel
    from video_stabilizer_tpu_torch.models import batch, chunked
    from video_stabilizer_tpu_torch.parallel.mesh import tensor_leaves
    from video_stabilizer_tpu_torch.utils import graphs

    fn, (clip,) = graft_entry.entry()
    out = fn(clip)
    check(tuple(out.shape) == (4, 164, 304, 3) and out.dtype == torch.uint8
          and out.device.type == "cuda" and bool(out.any()),
          f"graft_entry.entry(): {tuple(out.shape)} {out.dtype} on "
          f"{out.device}")
    run_tool(graft_entry.dryrun_multichip, 1)

    # Two 1080p streams over two 16-frame chunks, through the one-card mesh
    # and through the unsharded call.
    frames, _ = synth_streams(dev, 2 * CHUNK, MAIN_CONTENT,
                              seeds=[SEED, SEED + 1])
    mesh = parallel.make_mesh()
    check(mesh.devices == (torch.device("cuda", 0),),
          f"make_mesh(): {mesh.devices}")
    sharded = parallel.init_sharded_stream_states(2, WIDTH, HEIGHT, params,
                                                  mesh)
    state = chunked.init_stream_state(WIDTH, HEIGHT, params, 3, 2, dev)
    same = True
    for c in range(2):
        chunk = frames[:, c * CHUNK:(c + 1) * CHUNK]
        sharded, *got = parallel.stabilize_chunk_streams_sharded(
            sharded, chunk, mesh, params)
        state, *want = chunked.stabilize_chunk_streams(
            state, torch.from_numpy(chunk), params)
        same &= all(torch.equal(g.shards[0], w) for g, w in zip(got, want))
    same_state = all(torch.equal(g, w) for g, w in zip(
        tensor_leaves(sharded.shards[0]), tensor_leaves(state)))
    check(same and same_state,
          f"sharded chunk on the one-card mesh byte-equal to the unsharded "
          f"call: outputs, measurements, flags {same}, carried state "
          f"{same_state}")

    # The sharded clip on the same streams: the shard replays the card's
    # ``_stabilize_streams_jit`` graph; against the un-captured clip.
    prog = batch._stabilize_streams_jit
    graphs.reset([prog])
    clip = torch.from_numpy(frames).to(dev)
    with graphs.eager():
        want, eager_ms = timed(lambda: batch.stabilize_streams(clip, params,
                                                               dev))
    reset_launch_counts()
    runs = [timed(lambda: parallel.stabilize_streams_sharded(clip, mesh,
                                                             params))
            for _ in range(2)]
    n_d = launch_counts()["tvl1_smooth"]
    check(n_d == 2, f"kernel D launched {n_d} times by the sharded clip "
          "(want 2: the first call and the replay)")
    same = all(torch.equal(g.shards[0], w)
               for got, _ in runs for g, w in zip(got, want))
    check(same and prog.captures == 1 and prog.replays == 1,
          f"sharded clip (2 x {clip.shape[1]} frames) on the one-card mesh: "
          f"first call {runs[0][1]:.1f} ms (capture), replay "
          f"{runs[1][1]:.1f} ms, un-captured {eager_ms:.1f} ms; outputs, "
          f"measurements, flags byte-equal to the un-captured clip {same}")


@phase("digests: J1, J5, J2, J6, J7 and J3 alone, their digest lines")
def digests_only(params, params_4k, dev):
    """The replayed paths of J1, J5, J2, J6, J7 and J3 on their phases'
    inputs, each printing its digest line, and nothing else of the script:
    run on another commit's package (``--package-root``) it gives the lines
    to hold this one's against."""
    for shape, chunks, seeds, prm, runs in (
            ((HEIGHT, WIDTH), CHUNKS, None, params,
             (captured_1080p, clip_1080p)),
            ((H4K, W4K), CHUNKS_4K, list(SEEDS_4K), params_4k,
             (captured_4k, clip_4k))):
        frames, _ = synth_streams(dev, CHUNK * chunks, MAIN_CONTENT, *shape,
                                  seeds=seeds)
        for run in runs:
            run(frames, prm, dev)
        del frames
        torch.cuda.empty_cache()
    _, clip, gray, _, _, sweep_params, dyn = sweep_inputs(dev)
    sweep_replayed(dict(gray=gray, clip=clip, dyn=dyn, params=sweep_params,
                        align_ms=math.nan, warp_ms=math.nan))
    del clip, gray
    frames, poses = synth_streams(
        dev, STREAM_FRAMES + STREAM_PROFILED, MAIN_CONTENT, seeds=[SEED])
    host = [torch.from_numpy(np.ascontiguousarray(f)).pin_memory()
            for f in frames[0, :STREAM_FRAMES]]
    stream_digest(timed_stream(host, poses[0], params, dev))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 2
    # ``--package-root DIR`` runs the script on the package under DIR (an
    # unpacked commit), ``--digests`` only the paths' digest lines.
    argv = sys.argv[1:]
    root = os.path.dirname(os.path.abspath(__file__))
    if "--package-root" in argv:
        root = os.path.abspath(argv[argv.index("--package-root") + 1])
    sys.path.insert(0, root)
    from video_stabilizer_tpu_torch.config import (
        AlignerParams, StabilizerParams)

    dev = torch.device("cuda")
    count_plain_on_card()
    smi = nvidia_smi()
    log(f"card: {torch.cuda.get_device_name(0)} ({smi}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    if not build_kernels():
        log("chip_smoke: FAILED (the kernels did not build)")
        return 1

    params = StabilizerParams(crop_pixels=32)
    # Config 4 (apps/bench_configs.py:34-53).
    params_4k = StabilizerParams(
        aligner=AlignerParams(phase_correlate=True),
        output_interp="lanczos2", crop_pixels=32)
    params_topk = dataclasses.replace(
        params, aligner=AlignerParams(selection="topk"))
    params_fixed = dataclasses.replace(
        params, aligner=AlignerParams(fixed_iters=FIXED_KS[-1]))
    if "--digests" in argv:
        digests_only(params, params_4k, dev)
        log("chip_smoke: digests " + ("FAILED:\n  " + "\n  ".join(failures)
                                      if failures else "done"))
        return 1 if failures else 0
    crop = params.crop_pixels
    synth_on_card(dev)
    kernels = {}
    smooth_calls, pinv_calls, accum_calls, sel_calls = {}, {}, {}, {}
    cap = capture(params, dev)
    if cap is not None:
        kernels["warp_frames[similarity,bilinear]"] = check_warp(cap, crop,
                                                                 dev)
        kernels["gn_solve"] = check_gn(cap)
        kernels[FIXED_NAME] = check_gn_fixed(cap)
        smooth_calls["1080p"] = cap["tvl1_calls"]
        pinv_calls["1080p"] = cap["pinv_calls"]
        accum_calls["1080p"] = cap["accum_calls"]
        sel_calls["1080p"] = cap["sel_calls"]
        del cap
    cap = capture_4k(params_4k, dev)
    if cap is not None:
        kernels["warp_frames[homography,lanczos2]"] = check_warp_4k(
            cap, crop, dev)
        kernels["gn8_solve"] = check_gn8(cap)
        kernels[ITEM_NAME_C] = check_gn8_per_item(cap)
        smooth_calls["4K"] = cap["tvl1_calls"]
        pinv_calls["4K"] = cap["pinv_calls"]
        accum_calls["4K"] = cap["accum_calls"]
        sel_calls["4K"] = cap["sel_calls"]
        del cap
    if len(smooth_calls) == 2:
        kernels[TVL1_NAME] = check_tvl1(smooth_calls["1080p"],
                                        smooth_calls["4K"], params, dev)
    del smooth_calls
    if len(pinv_calls) == 2:
        entries = check_pinv_accum(pinv_calls["1080p"], pinv_calls["4K"],
                                   accum_calls["1080p"], accum_calls["4K"],
                                   dev)
        if entries is not None:
            (kernels[PINV_NAME], kernels[PINV8_NAME],
             kernels[ACCUM_NAME]) = entries
    del pinv_calls, accum_calls
    torch.cuda.empty_cache()
    entries = check_gray_pyr(params, params_4k, dev)
    if entries is not None:
        kernels[GRAY_NAME], kernels[PYR_NAME] = entries
    torch.cuda.empty_cache()
    entries = check_keyframe(params, params_4k, dev)
    if entries is not None:
        kernels[KEY_ENTRY], kernels[KEY_H_ENTRY] = entries
    torch.cuda.empty_cache()
    if len(sel_calls) == 2:
        entries = check_prelude(sel_calls["1080p"], sel_calls["4K"], params,
                                dev)
        if entries is not None:
            (kernels[SEL_ENTRY], kernels[SEL_H_ENTRY],
             kernels[SEL_TOPK_ENTRY]) = entries
    del sel_calls
    torch.cuda.empty_cache()
    check_4k_content(params_4k, dev)
    torch.cuda.empty_cache()

    # Each path runs with every launch count set to 0 just before it and
    # read just after; each kernel's launches come from the path it serves.
    path_launches = {}
    for name, run, model, prm, shape, chunks, seeds in (
            ("1080p", main_path, "similarity", params, (HEIGHT, WIDTH),
             CHUNKS, None),
            ("4K", main_path_4k, HOMOGRAPHY, params_4k, (H4K, W4K),
             CHUNKS_4K, list(SEEDS_4K))):
        t0 = time.perf_counter()
        frames, poses = synth_streams(dev, CHUNK * chunks, MAIN_CONTENT,
                                      *shape, seeds=seeds)
        log(f"== {name} path's clip {frames.shape} in "
            f"{time.perf_counter() - t0:.1f} s")
        result = run(frames, poses, prm, dev)
        if result is None:
            del frames
            continue
        launches, states, last_chunk, stages = result
        for kname in kernels:
            if launches.get(kname, 0) > 0:
                # Kernels D-H run on both paths: their counts are the
                # 1080p ones.
                path_launches.setdefault(kname, launches[kname])
        if model == HOMOGRAPHY and launches.get(PINV_NAME, 0) > 0:
            # Kernel E's 8x8 form: the 4K path's pseudo-inverses.
            path_launches[PINV8_NAME] = launches[PINV_NAME]
        if launches.get(KEY_NAME, 0) > 0:
            # Kernel I: the 1080p path's similarity keyframes, the 4K
            # path's homography ones.
            path_launches[KEY_ENTRY if model == "similarity"
                          else KEY_H_ENTRY] = launches[KEY_NAME]
        if launches.get(SEL_NAME, 0) > 0:
            # Kernel J: the 1080p path's similarity preludes, the 4K
            # path's homography ones.
            path_launches[SEL_ENTRY if model == "similarity"
                          else SEL_H_ENTRY] = launches[SEL_NAME]
        if model == "similarity":
            # Right after phase 9, so that both runs meet the same host
            # pace: on an NVIDIA H100 80GB HBM3 (700.00 W) a run after the
            # profiler's chunk read 1.2-1.5x slower in every eager stage,
            # the smoother's included.
            topk = topk_path(frames, poses, params_topk, dev, stages)
            if topk is not None and topk.get(SEL_NAME, 0) > 0:
                # Kernel J's exact-count mode: 9T's preludes.
                path_launches[SEL_TOPK_ENTRY] = topk[SEL_NAME]
        profile_chunk(states, last_chunk, prm, model)
        if model == "similarity":
            check_fir(states, last_chunk, prm, dev)
        else:
            check_fir_4k(states, last_chunk, prm, dev)
        del states, last_chunk
        torch.cuda.empty_cache()
        if model == "similarity":
            captured_1080p(frames, prm, dev)
            clip_1080p(frames, prm, dev)
            clip_programs(frames, prm, dev)
            chunk_programs(frames, prm, dev)
        else:
            captured_4k(frames, prm, dev)
            clip_4k(frames, prm, dev)
        del frames
        torch.cuda.empty_cache()
    # The sweeps: G1 (kernel B, one threshold per item) and G2's 4K path
    # (kernel C), each with its own launch counts; then G3.
    sweep = aligner_sweep(dev)
    if sweep is not None:
        kernels[ITEM_NAME_B], path_launches[ITEM_NAME_B], g1 = sweep
        outs = sweep_replayed(g1)
        if outs is not None:
            metric_replayed(outs, g1)
        del sweep, g1, outs
    torch.cuda.empty_cache()
    n_c = homography_sweep(params_4k, dev)
    if n_c:
        path_launches[ITEM_NAME_C] = n_c
    apps_pipeline(dev)
    torch.cuda.empty_cache()
    wide_jitter(params, dev)
    small_reference(dev)

    # The streaming path: its own clip, its own launch counts (S1, and S5 in
    # kernel B's fixed mode), read into the one-frame / one-item entries of
    # kernels A and B (S3) and the fixed-mode entry.
    t0 = time.perf_counter()
    frames, poses = synth_streams(
        dev, STREAM_FRAMES + STREAM_PROFILED, MAIN_CONTENT, seeds=[SEED])
    frames, poses = frames[0], poses[0]
    log(f"== streaming path's clip {frames.shape} in "
        f"{time.perf_counter() - t0:.1f} s")
    s1 = streaming_path(frames, poses, params, dev)
    one = (None, None)
    if s1 is not None:
        j3 = streaming_replayed(s1["host"][:STREAM_FRAMES], poses, params,
                                dev, s1)
        streaming_vs_chunked(frames, params, dev, s1)
        for name, counted in STREAM_KERNELS:
            if s1["launches"].get(counted, 0) > 0:
                path_launches[name] = s1["launches"][counted]
        s5 = streaming_fixed(frames, poses, params_fixed, dev,
                             j3 or s1["figures"])
        if s5 is not None and s5.get("gn_solve", 0) > 0:
            path_launches[FIXED_NAME] = s5["gn_solve"]
    del frames, s1
    s3 = capture_stream(params, dev)
    if s3 is not None:
        one = check_one_item(s3, crop) or one
    del s3
    torch.cuda.empty_cache()
    for (name, _), entry in zip(STREAM_KERNELS, one):
        kernels[name] = entry
    streaming_small_reference(dev)
    torch.cuda.empty_cache()

    # The tools and the scale-out layer: each its own launch counts.
    tool_bench(smi)
    tool_bench_4k()
    tool_latency()
    latency_chain(dev)
    tool_profile()
    scale_out(params, dev)

    check(not any(PLAIN_ON_CARD.values()),
          f"plain versions run on the card over every path: {PLAIN_ON_CARD} "
          "(each smoother, pseudo-inverse, accumulator, gray, pyramid, "
          "keyframe and select prelude call there, 9T's exact-count ones "
          "too, went to kernel D, E, F, G, H, I or J)")
    missing = [k for k, v in kernels.items()
               if v is None or k not in path_launches]
    if failures or missing or len(kernels) != 20:
        log("chip_smoke: FAILED:\n  " + "\n  ".join(
            failures + [f"{k}: not checked or not launched on its path"
                        for k in missing]))
        return 1
    for name, k in kernels.items():
        k["launches"] = path_launches[name]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # Kernels A-I also give their device time beside the wrapper's ms (A's
    # chunked forms: of the segment form the path runs, and the contiguous
    # form's wrapper ms); D, E and F their dependent-chain bound beside the
    # roofline one.
    extra = ("device_ms", "chain_bound_ms", "contiguous_ms")
    print(json.dumps({"kernels": [
        {k: kern[k] for k in keys + extra if k in keys or k in kern}
        for kern in kernels.values()]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
