#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one GPU and check them.

Run from the repository root: `python3 chip_smoke.py`. Needs one CUDA card,
nvcc (the kernels are built from nlsolvers_tpu_torch/csrc at first use) and
nvidia-smi. Imports torch, numpy and nlsolvers_tpu_torch only, never JAX.

Phases, one line each (or a few):
  1. device    the card's name and `nvidia-smi` name, power limit
  2. build     one nvcc per csrc/*.cu, all started together; seconds,
               registers and spills from ptxas, and per instantiation of
               the 2D pass1/pipe kernels (iso and aniso; K1 and K2 in
               their 16-byte and scalar forms; the shard policies), of K3,
               K5 <P, MAXW, OPK, VEC>, K8 <P, MAXW, MODE, VEC, LANES> and
               K13 <MAXW, VEC>, of kick_bc <KIND, VEC> and of
               pass1_shard3d <P, MAXW, MODE, VEC>; fails unless all 96 K1 /
               K5 and all 48 pass1_shard3d instantiations are there and
               none of them spills
  3. parity    each 2D kernel (K1-K3) against its plain PyTorch version on
               the same seeded CUDA tensors, at 1024^2 complex64, 4096^2
               and on ragged grids (250x333, 250x334, 251x335: the scalar
               instantiations; j up to 18, real fields with sign -1):
               fields rel-L2 <= 1e-5 (same elementwise arithmetic up to FMA
               contraction); reduced dots |got - want| <= 1e-4 * ||a|| ||b||
               (summation order differs). K1 on every bucket (j up to 31)
               and at 4096^2 too. K1, K2 and K3 launched twice on the same
               inputs give the same bits. Times at the main path's
               shapes: device time of the launched kernels (torch.profiler)
               and wall time by CUDA events, which include the host's
               enqueue, over 20 calls; for K1, K2 and K3 per step also by
               CUDA-graph replay (the step's launches captured once and
               replayed back to back: no host in the window), at 1024^2
               and 4096^2, beside torch.matmul's for K3.
  4. main      nlse_problem("cubic", (1024, 1024), 10, 1e-4, m=10) through
               problems.run: 200 steps, exactly 1 K1 + 9 K2 + 1 K3 + 2
               kick_bc + 10 recur launches per step (both half kicks, the
               closing one with the ghost copy), finite snapshots,
               relative mass drift < 1e-3.
  5. paths     20 steps with the kernels vs the plain planar versions
               (rel-L2 <= 1e-5), and the plain planar path vs the complex
               ss2_step path (rel-L2 <= 2e-4, the gate of
               tests/test_pallas.py).
  6. rate      steps/s: median of 3 chunks of 200 steps, synchronized; the
               device's busy time per step from torch.profiler, and the host
               syncs one step makes.
  7. parity3d  the 3D kernels (pass1_3d, pass2, bc3d) against their plain
               versions at 128^3 and on a ragged 37x50x61 grid, the iso
               reference, iso clean and aniso operators, j in {0, 4, 8}:
               the same gates, and bc3d exactly equal. Times at 128^3 per
               step of the main path, beside the one-call PyTorch yardsticks
               (torch.matmul for combine, torch.addmm for pass2); combine
               and torch.matmul also by CUDA-graph replay.
  8. main3d    nlse_problem("cubic", (128, 128, 128), 10, 1e-4, m=10): 200
               steps with exactly 9 pass1_3d + 10 pass2 (9 and the start
               norm's norm-only form) + 1 combine + 2
               kick_bc launches per step and no bc3d, finite snapshots, mass
               drift < 1e-3; then with c(x) = 1 + 0.4 U[0, 1) for 100 steps,
               same gates; then 20 steps of 3D sEWI: the bootstrap as an SS2
               step, every later step 27 pass1_3d + 30 pass2 + 3 combine + 1
               bc3d (the standalone ghost copy) and no kick_bc.
  9. paths3d   20 steps, iso and c(x): kernels vs plain planar (<= 1e-5),
               plain planar vs complex ss2_step (<= 2e-4).
 10. rate3d    steps/s at 128^3 iso (5 chunks of 100) and 128^3 c(x) (3 of
               100), their chunks interleaved, and 256^3 iso (3 of 20), each
               with device busy ms per step, idle share, launches and host
               syncs per step; at 128^3 also the host's own profile.
 11. parity2d-aniso  K1' (pass1_aniso2d) and K2' (pipe_aniso2d) against
               their plain versions, c = 1 + 0.4 U[0, 1), at 1024^2 and on
               a ragged 250x333 grid, j up to 18 (the 16 and 32 column
               buckets of m=20), complex and real fields, the scalar
               instantiations on 250x334 and 251x335, and 4096^2: the gates
               of phase 3; K1' launched twice gives the same bits. Device
               times per step at 1024^2 m=10 beside the bytes bound; K1'
               and K2' by CUDA-graph replay at 1024^2 and 4096^2.
 12. main2d-aniso  nlse_problem("cubic", (1024, 1024), 10, 1e-4, m=10) with
               c(x) from default_rng(0) (benchmarks/perf_table.py's
               nlse2d_1024_ss2_aniso): 200 steps through problems.run,
               exactly 1 K1' + 9 K2' + 1 K3 + 2 kick_bc + 10 recur
               launches per step and no iso launch, finite snapshots,
               relative mass drift < 1e-3.
 13. sewi2d    the same problem with integrator="sewi", 100 steps through
               problems.run: the step-1 bootstrap launches exactly 1 K1' +
               9 K2' + 1 K3 + 2 kick_bc + 10 recur and every later step
               3 K1' + 27 K2' + 3 K3 + 30 recur (its ghost copy is the
               plain one);
               finite snapshots; the mass drift is printed, not gated (sEWI
               does not conserve it exactly).
 14. paths2d-aniso  20 steps of SS2, sEWI, fused sEWI and Gautschi on c(x):
               kernels vs plain planar (rel-L2 <= 1e-5), plain planar vs
               the complex path (<= 2e-4); 10 steps of 3D sEWI at 128^3,
               kernels vs plain planar (<= 1e-5).
 15. rate2d-aniso  1024^2 iso SS2 and c(x) SS2 (3 chunks of 200 each,
               interleaved), then c(x) sEWI (3 of 50), as in phase 10. Each
               run carries its step index, so sEWI bootstraps once.
 16. parity-optin  the kernels of the opt-in paths against their plain
               versions: K13 (ss2_resident_step, one whole SS2 step) at
               1024^2 m=10 and on ragged grids (250x333, 200x256, 130x260,
               97x333, 3x129, 5x3: every density, both variants, with and
               without the ghost ring, m from 1 to 20); K5 (iter_step) at
               1024^2, 128^3 and ragged grids, every operator it takes,
               complex and real fields, every bucket (j up to 30), with w
               on chip and, at 2048^2 and 160^3, in a device scratch (the
               form of each size printed; the largest square grid whose w
               stays on chip too); K8 (pipe_3d) at 128^3,
               256^3 and on ragged grids (20x30x50, 37x50x61, 21x23x64,
               9x31x260, 33x17x132, 17x3x33: nx % 4 == 0 and != 0, bricks
               cut in y and z, halo columns), every 3D operator, complex and
               real, j up to 18. The gates of phase 3; K5 (both forms of
               w), K8 and K13 launched twice repeat bit for bit. Device
               times per step of their paths beside the bounds, K5, K8 and
               K13 also by CUDA-graph replay (K5 at 1024^2, 128^3 and
               2048^2), and K13's streaming floor.
 17. main-resident  phase 4's problem with config.resident_mode "auto":
               200 steps through problems.run under
               torch.cuda.set_sync_debug_mode("error") (no host sync),
               exactly 1 K13 launch per step and no other counted launch
               (no kick_bc: K13 kicks inside),
               mass drift < 1e-3.
 18. main-iter  with config.fused_iter: 1024^2 SS2 (exactly 9 K5 + 1 pass2,
               the start norm's norm-only form, + 1 K3 + 2 kick_bc per
               step) and 128^3 SS2 (the same), 100 steps each,
               mass drift < 1e-3.
 19. main-pipe3d  with config.pipeline_3d: 128^3 iso and c(x) SS2, 100
               steps each: exactly 1 pass2 (the start norm) + 1 pass1_3d +
               8 K8 + 1 K2 (the last, stencil-free iteration)
               + 1 K3 + 2 kick_bc per step, mass drift < 1e-3.
 20. paths-optin  20 steps of each switch against the default path:
               resident (Taylor in place of eigh) rel-L2 <= 1e-4, fused_iter
               (2D, 3D) and pipeline_3d (iso, c(x)) <= 1e-5 (the same
               arithmetic, other rounding).
 21. rate-optin  steps/s of each opt-in path beside its default, chunks
               interleaved in this one call, with phase 6's profile: resident
               vs default and fused_iter vs the pipe at 1024^2 (3 chunks of
               200 each), pipeline_3d vs two-pass at 128^3 (3 of 100) and
               256^3 (3 of 20).
 22. parity-shard  the shard kernels against their plain versions with
               random halos and face weights, at corner, edge and interior
               places of a larger grid: pass1_shard2d (K1' shard2d,
               shard2d_aniso) at local 2048^2 and on ragged blocks down to
               2x2, pass1_shard3d (K9-K12, K1' shard3d*) in every mode at
               local 256^3 and on ragged blocks down to 2x2x2, P in {1, 2}
               (P=1 with sign -1), j up to 18: the gates of phase 3; bc3d
               with global offsets exactly equal. Device times per step of
               the sharded main paths (every shard, j = 0..8) beside the
               bytes bound.
 23. main-shard2d  make_sharded_nlse_step at 4096^2 on a (2, 2) mesh of
               four shards on this card (local 2048^2, the JAX README's 2D
               anchor), cubic SS2 m=10, reference variant, iso and c(x) =
               1 + 0.4 U[0, 1) from default_rng(0): exactly 4 x (9
               pass1_shard2d + 10 pass2 (9 and each shard's start norm,
               the norm-only form) + 1 combine + 2 kick_bc) launches per
               step and no unsharded pass1 or pipe launch, finite state,
               mass drift < 1e-3.
 24. main-shard3d  512^3 on (2, 2, 2) (local 256^3), clean variant, iso and
               c(x): exactly 8 x (9 pass1_shard3d + 10 pass2 + 1 combine +
               2 kick_bc) launches per step; 256^3 on (1, 1, 4), reference
               variant (x split only): 4 x the same; the same gates.
 25. paths-shard  20 steps: the sharded step with the kernels vs its plain
               versions (rel-L2 <= 1e-5) at 512^2 on (2, 2) and 64^3 on
               (2, 2, 2) and (1, 1, 4), iso and c(x); the sharded step vs
               the unsharded kernel path (nlse_problem) on the same global
               grid at full size (<= 2e-4).
 26. rate-shard  steps/s of the sharded step beside the unsharded one at
               4096^2 (3 chunks of 20 each) and 512^3 (3 of 5), chunks
               interleaved, with phase 6's profile.
 27. kick-bc   kick_bc (both half kicks of an SS2 step in one pass each,
               the closing one with the ghost copy) against kick_bc_ref:
               every density kind, 2D and 3D, with and without the ghost
               copy, the 16-byte and scalar forms (nx % 4 != 0, a state 4
               bytes off), and every shard block of 4096^2 on (2, 2) and
               512^3 on (2, 2, 2) with its offsets: fields rel-L2 <= 1e-5,
               every ghost cell bit-equal to its source cell in the
               kernel's own output, the input untouched, two launches bit
               for bit. Times per step (both kicks) at 1024^2, 4096^2,
               128^3 and 256^3 by CUDA-graph replay beside the eager kicks
               and ghost copy it replaces and 20 bytes per cell per kick.
 28. parity-rw  the real-wave route: pass1_3d and pass2 on real fields
               (P=1) with the operator's sign flipped, iso reference, iso
               clean and aniso, at 128^3 and 37x50x61, j in {0, 4, 8}: the
               gates of phase 3; bc3d at P=1 exactly equal; K3 at k=2, P=1,
               1024^2.
 29. main-rw   realwave_problem("sine_gordon", (1024, 1024), 10, 1e-4, m=10,
               gautschi, float32) from benchmarks/perf_table.py's kink (u0 = 4
               atan(exp(x/1.5)), v0 = 0, m = 1): 200 steps through
               problems.run, exactly 2 K1 + 18 K2 + 2 K3 + 20 recur launches
               per step (K3 combining 2 matrix functions, then 1), no kick_bc
               and no K13; 128^3 sine-Gordon and 128^3 Klein-Gordon with c = 1
               + 0.4 U[0, 1) from default_rng(0), 100 steps each, exactly 18
               pass1_3d + 20 pass2 + 2 K3 + 1 bc3d; 1024^2 c(x) Klein-Gordon,
               100 steps, 2 K1' + 18 K2' + 2 K3 + 20 recur; finite (u, v)
               snapshots. The relative drift of the energy (v^2/2 +
               c |grad u|^2/2 + m V(u)) is printed, not gated.
 30. paths-rw  20 steps, each from the kernel path's state, against the
               same step under config.kernel_mode "off" (the generic
               Krylov path): rel-L2 on u <= 1e-5 for every kind at 256^2
               (phi-4 also with c(x)) and at 128^3 iso and c(x); the same
               against fused_iter (1024^2, 128^3) and pipeline_3d (128^3
               iso and c(x)), whose launches per step are counted first
               (each matrix function's start norm one pass2).
               The free-running 20-step difference is printed beside it.
 31. rate-rw   steps/s of sine-Gordon Gautschi at 1024^2 (3 chunks of 200),
               128^3 (3 of 100) and 256^3 (3 of 20), each with phase 6's
               profile (device busy ms, idle share, launches and host syncs
               per step; two eigh syncs expected).
 32. models-rest  Boussinesq Gautschi, 10 steps at 512^2 float32 on the
               generic path (no counted launch), finite; stochastic phi-4
               SV at 1024^2, 100 steps twice with one seed: equal bits, and
               another seed differs; evolve_guarded on a diverging phi-4 SV
               run: bad_at inside the run, the later snapshots and series
               zero, at most one host sync per snapshot.
Each of phases 28-39 prints its seconds; from phase 3 on, a line
"[elapsed s] phase N name" opens each phase.
 33. pipeline-env  whether scipy, h5py and g++ are there (scipy is
               required); the port's native npy writer built into
               nlsolvers_tpu_torch/_build/ and one array round-tripped.
 34. parity-batched  the batched forms of K1', K2', K3 and kick_bc at the
               datagen point (B=8 lanes of 256^2, m=20, complex, c(x) per
               lane; K1' at j = 0 with ||W_0||^2 and at j = 19, K2' at every
               j of a run and at j = 19, K3 k=1, both kicks), of K1 / K2 on
               the iso operator, and a ragged real batch (3 x 251x335, sign
               -1: the scalar forms): one launch each, against the plain
               batched versions (the gates of phase 3, every ghost cell
               bit-equal to its source cell) and bit-equal to B launches of
               the unbatched kernel, lane by lane. Times per batched step by
               CUDA-graph replay beside the B unbatched launch sequences of
               the same work, the profiler and the events, the plain
               batched versions, torch.matmul of the lanes for K3, and 8 x
               the 256^2 bytes bound. Then the 3D half at the 3D datagen
               point (B=8 lanes of 128^3, m=10, iso and c(x) per lane,
               P=2 and P=1 with sign -1): pass1_3d at j = 0 and 9, pass2
               with 0 (the norm-only form), 1 and 9 columns, bc3d, and
               kick_bc on the 3D batch, with the same gates (bc3d exactly
               equal); times per batched step of the 3D paths (9 pass1_3d,
               the norm + 9 pass2, 1 bc3d, both kicks) by graph beside the
               8 unbatched launch sequences and 8 x the 128^3 bytes bound.
               Then the batched K5 and K8: K5 on 8 lanes of 256^2
               (m=20, iso and c(x), j = 0, 9, 18) and of 128^3 (iso, j = 0,
               8), K8 on 8 lanes of 128^3 (iso and c(x), j = 0, 7), P=2 and
               P=1 with sign -1, ragged real batches (3 x 251x335, 3 x
               37x50x61: the scalar forms), the form of w each K5 launch
               takes printed: against the plain batched versions (phase 3's
               gates), bit-equal to 8 unbatched launches, two launches bit
               for bit; times per batched step (K5: the 19 or 9 launches of
               one fused run at 256^2 c(x) and iso and 128^3 iso; K8: the 8
               of one pipelined run at 128^3 c(x) and iso) by graph beside
               the 8 unbatched launch sequences and 8 x the bytes bound.
 35. datagen-engine  the datagen engine (pipeline/engine.py) at the
               production width, 256^2 B=8, with Datagen's samplers and
               fields (c layered, m piecewise): the NLSE engine (m=20,
               complex64, planar) steps every lane in one batched step, exactly
               1 K1' + 19 K2' + 1 K3 + 2 kick_bc + 20 recur counted launches
               per batched step whatever B (no iso launch, no bc3d); each
               lane's 20 steps are bit-equal to nlse_problem with its m and c
               run alone (each batched kernel gives its lanes the
               unbatched launch's bits, and the batched eigh gives each
               matrix the single-matrix eigh's bits on this stack); the
               kernels are within 1e-5 of kernel_mode "off"; a lane
               started as NaN gets bad_at 0 and stays NaN while the other
               two stay bit-equal to their runs alone. The
               real-wave engine (sine-Gordon Gautschi from Datagen's
               kink_field draws, 256^2, m=10, float32, B=8) is one batched
               step too: exactly 2 K1' + 18 K2' + 2 K3 + 20 recur per
               batched step,
               each lane's 20 steps bit-equal to realwave_problem run
               alone, each step from the engine's state within 1e-5 of the
               same step under kernel_mode "off", a NaN lane confined; and
               the 3D paths at 128^3, m=10, B=8, c(x) per lane: NLSE SS2
               (9 pass1_3d + 10 pass2 + 1 K3 + 2 kick_bc per batched step)
               and Klein-Gordon Gautschi (18 pass1_3d + 20 pass2 + 2 K3 + 1
               bc3d), each lane's 20 steps bit-equal to its problem run
               alone, a NaN lane confined. A phi-4 Gautschi batch with one
               lane at 1e3 times the other's amplitude gives that lane
               bad_at < S while the other stays finite and bit-equal to its
               run alone. The two-step NLSE integrators are one batched
               step too, 2D c(x) 256^2 m=20 and 3D c(x) 128^3
               m=10, B=8: the bootstrap takes the SS2 step's 43 / 22
               launches, every later step exactly 3 K1' + 57 K2' + 3 K3 +
               60 recur (sEWI, Gautschi; fused sEWI 2 + 38 + 2 + 40) or
               27 pass1_3d + 30 pass2 + 3 K3 + 1 bc3d (fused sEWI 18 + 20
               + 2 + 1); each
               lane's 20 steps bit-equal to nlse_problem alone, a NaN lane
               confined. Then the batched engines under the switches, each
               with its counts per batched step, lanes bit-equal to their
               problems alone under the same switch over 20 steps, and a
               NaN lane: SS2 fused_iter 256^2 c(x) (19 K5 + 1 pass2 + 1 K3
               + 2 kick_bc), SS2 fused_iter 128^3 iso (9 + 1 + 1 + 2; K5
               has no 3D c(x) mode, as JAX's), SS2 pipeline_3d 128^3 c(x)
               (1 pass2 + 1 pass1_3d + 8 K8 + 1 K2 + 1 K3 + 2 kick_bc),
               sine-Gordon Gautschi fused_iter 256^2 c(x) (18 K5 + 2 pass2
               + 2 K3) and Klein-Gordon Gautschi pipeline_3d 128^3 c(x) (2
               pass2 + 2 pass1_3d + 16 K8 + 2 K2 + 2 K3 + 1 bc3d).
 36. datagen-main  the CLI as a subprocess (python -m
               nlsolvers_tpu_torch.pipeline), --format npy: the NLSE sweep
               nlse --phenomenon multi_soliton --system cubic --nx 256 --T
               0.12 --nt 200 --snapshots 20 --num-runs 8 --batch-size 8
               --anisotropy-type layered --m-type piecewise --record-energy
               (the production dt 1.2/2000 at a tenth of its depth) and
               realwave --phenomenon kink_field --system sine_gordon --nx
               256 --T 0.6 --nt 200 --snapshots 20 --num-runs 8
               --batch-size 8: exit 0, 8 runs archived each, every archived
               trajectory finite, the recorded mass series equal to the
               archived snapshots' mass (rtol 1e-5); the no-flux sweep's
               mass drift printed (the ghost copy changes the mass where a
               draw touches the boundary, as in JAX's engine), the same
               draws with --bc none gated at relative mass drift < 1e-3 per
               run; with h5py, the NLSE sweep again with --format hdf5,
               bit-equal to the npy one (without h5py, printed as not run).
               The NLSE npy sweep runs alone, the others together after it.
 37. rate-datagen  trajectories/min and trajectory-steps/s of the NLSE
               sweep (its own sweep summary), and one batched step (B=8)
               in this process: wall ms, device busy ms and idle share
               (torch.profiler), launches per batched step and per
               trajectory-step, host syncs. Then the sweeps DG_SWEEPS
               (2D NLSE sEWI at 256^2 m=20 at the NLSE sweep's depth; 2D
               sine-Gordon at 256^2, 3D NLSE SS2 and 3D Klein-Gordon at
               128^3, 8 runs each): one batched step's wall, busy time,
               idle share and launches, and the sweep through Datagen.run
               in trajectories/min (datagen_rates, which time_kernels.py
               --parts sweeps runs on another tree).
 38. parity-batched-shard  the batched forms of pass1_shard2d and
               pass1_shard3d (batched_parity_shard): B = 2 lanes of the
               local blocks of the datagen-shard paths (512^2 of 1024^2 on
               (2, 2), c(x) and iso, j up to 18; (256, 256, 64) of 256^3 on
               (1, 1, 4), c(x) and iso), ragged real batches and 2 x 2(x2)
               blocks: one launch each, against the plain batched versions
               (phase 3's gates), bit-equal to B unbatched launches, two
               launches bit for bit; pass1_shard3d's bricks
               (lanczos3d.shard3d_tiles) equal to the library's count and
               ring bytes; one batched sharded Lanczos run's shard kernels
               (every shard, j = 0..m-2; c(x), and the 3D iso reference
               operator too) by graph beside the B lanes' unbatched launch
               sequences and the bytes bound.
 39. datagen-shard  the grid-sharded datagen engines (shard_datagen), B = 2
               lanes in one batched sharded step, every shard on this card:
               2D cubic NLSE c(x) 1024^2 m=20 on (2, 2), SS2 (exactly 4 x (19
               pass1_shard2d + 20 pass2 + 1 K3 + 2 kick_bc) per batched step)
               and sEWI (after the SS2 bootstrap 4 x (57 + 60 + 3)), 2D
               sine-Gordon Gautschi float32 1024^2 m=10 on (2, 2) (4 x (18 +
               20 + 2)), 3D cubic NLSE c(x) 256^3 m=10 on (1, 1, 4), the
               reference variant (4 x (9 pass1_shard3d + 10 pass2 + 1 K3 + 2
               kick_bc)), each with the counters at 0 just before and read
               just after; each lane within 2e-4 rel-L2 of the unsharded
               engine on the same draws and bit-equal to the lane stepped
               alone (make_sharded_nlse_step for SS2); then Datagen.run with
               shard_grid (2, 2) at 1024^2: 2 runs archived, the launches
               exact, the mass series equal to the archive's mass (1e-5).
 40. batch-axis  the batch axis (batch_axis_phase), every shard on this
               card, B = 4: the sharded datagen engine with batch_axis,
               2D cubic NLSE c(x) 1024^2 SS2 m=20 on (batch, gy, gx) =
               (2, 2, 2) and 3D c(x) 256^3 SS2 m=10 on (2, 1, 1, 4), each
               lane bit-equal to its lane block of 2 run on the grid-only
               mesh, the launches (counters at 0 just before, read just
               after) equal to the two blocks' grid-only runs; the
               unsharded engine (256^2 c(x) SS2 m=20, B = 8) with a
               ("batch",) mesh of 2 bit-equal to no mesh (snapshots,
               bad_at, mass series), 2 x (1 K1' + 19 K2' + 1 K3 + 2
               kick_bc) per step, both timed warm; batched_evolve of one
               planar problem on that mesh, B = 4, each lane bit-equal to
               the problem stepped alone, the launches those of its two
               blocks without a mesh; a complex128 sharded SS2
               step (the generic path, plain torch) at 256^2 on (2, 2)
               within rel-L2 1e-10 of the unsharded complex128 problem;
               distributed.initialize at world size 1 (gloo on localhost)
               and Datagen.run on its global batch mesh, 2 runs archived.
               Prints its elapsed time.
 41. study     the integrator study (study_phase) through
               nlsolvers_tpu_torch.analysis on the card, files under
               _smoke_study/: compare.integrator_study on study._study_inputs'
               cubic colliding packets, c piecewise layers, m constant, seed
               0, Lx 10, SS2 vs sEWI at 256^2, 512^2, 1024^2 x dt 1e-3,
               5e-4, T 0.05, 11 snapshots, m=10, complex64 (the trajectories
               kept at dt 5e-4); sine-Gordon kink Gautschi vs SV at 256^2,
               1024^2, dt 1e-3, T 0.02, float32. One cell a call with the
               counters at 0 just before and read just after: exactly its
               steps x (SS2 1 K1' + 9 K2' + 1 K3 + 2 kick_bc; sEWI the SS2
               bootstrap, then 3 K1' + 27 K2' + 3 K3; Gautschi 2 K1 + 18 K2
               + 2 K3; SV none), every cell simulation_stable. The NLSE
               cells at dt 5e-4 against kernel_mode "off": at 512^2 over
               the whole cell (final snapshot rel-L2 and mass series <=
               1e-5); at 1024^2, where dt rho(A) ~ 21 with m=10 amplifies
               rounding in a free-running cell, steps 1-3 and every 10th
               from the kernel run's state (field and mass <= 1e-5), the
               free-running difference printed beside the kernel run's own
               under a 2^-24 perturbation of u0. The summary rows, the CSV
               and the SS2-sEWI / Gautschi-SV differences (finite) with
               their ratio between the two dt printed, mass drift printed,
               not gated. Structure SSIM and the modal energy grid of |u| at
               1024^2, the modal spectrum at 256^2, finite. profiling.trace
               around one 1024^2 SS2 cell inside annotate("study-cell"): the
               Chrome trace names the annotation and pass1_tile_kernel,
               pipe_2d_kernel, combine_kernel, kick_bc_kernel (up to 5
               tries, printed); StepTimer over 20 SS2 steps with a sync
               each, printed beside phase 15's c(x) steps/s. With
               matplotlib, study.run_study at 256^2 and 512^2 with the same
               gates and its artifacts listed; else "not run". Prints its
               elapsed time.
 42. recurrence  the 2D pipelined loop's scalar recurrence on the card
               (lanczos2d._lanczos_rec: the recurrence kernel launched
               inside each K1' / K2' call) against the eager loop
               (_lanczos_eager, called directly) on the same seeded fields:
               200^2 c(x) m=20 with B=1 and B=30 (a zero lane, a NaN lane),
               256^2 iso m=10, P=1 with sign -1 (iso 256^2 m=10, c(x)
               200^2 m=20): W, s, alphas, betas and beta0 bit-equal, each of
               the 30 lanes bit-equal to the lane run alone; exactly 1 K1' /
               K1 + m-1 K2' / K2 and m recurrence launches a device run, the
               eager run the same kernels and none; _lanczos_pipe takes the
               device recurrence on the card, the eager loop under
               kernel_mode "off"; the recurrence kernel's device time a
               run (profiler) beside the eager recurrence's, at 1024^2
               iso m=10 one lane and 200^2 c(x) m=20 B=30. Prints its
               elapsed time.
Every phase that counts launches counts the recurrence kernel too
(lanczos2d.recur_kernel.launches, key "recur"): m a 2D pipelined Lanczos
run on the card, 0 for every other loop.
Then the card's name and power limit, the kernels as one JSON line
(twenty-six: K1-K3, pass1_3d, pass2, bc3d, K1', K2', K13, K5, K8,
pass1_shard2d, pass1_shard3d, kick_bc, recur_kernel, and the batched
forms of K1', K2',
K3, kick_bc, pass1_3d, pass2, bc3d, K5, K8, pass1_shard2d and
pass1_shard3d; `ms` of K1, K2, K3, K1', K2', K5, K8, K13, kick_bc and the
batched forms is the CUDA-graph reading,
with the profiler's sum and the events beside it, and K3's library_ms
torch.matmul's graph reading; bc3d's launches are the 3D sEWI run's;
recur_kernel's `ms` the profiler's sum, `plain_ms` the eager recurrence's
device time, with the task30 cell's point beside them; nine
carry the real-wave Gautschi step's launches per step, and pass1_3d,
pass2, bc3d and K3 their P=1 parity; the batched forms the datagen
engine's launches per batched step of 8 lanes (the 2D NLSE step's, for
pass1_3d and pass2 the 3D NLSE step's, for bc3d the 3D real-wave step's,
for K5 the 2D NLSE step's under fused_iter, for K8 the 3D NLSE step's
under pipeline_3d; the other paths' beside them) and the graph time of
the 8 unbatched launch sequences beside theirs; the batched shard
kernels, K1', K2', K3, pass2 and kick_bc also the batch-axis paths'
launches per step per sub-mesh), and last {"ok": true, "device": ...}. Any failed phase exits non-zero and prints no result.
"""

import dataclasses
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from functools import partial
from pathlib import Path
from types import SimpleNamespace

N, LX, DT, KRYLOV_M = 1024, 10.0, 1e-4, 10
N3, N3_BIG = 128, 256
NS, NS3 = 4096, 512            # the sharded operating points: 2048^2 and
                               # 256^3 local shards on (2, 2), (2, 2, 2)
FIELD_TOL, DOT_TOL = 1e-5, 1e-4
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
SOURCE = "nlsolvers_tpu_torch/csrc/lanczos2d.cu"
SOURCE3 = "nlsolvers_tpu_torch/csrc/lanczos3d.cu"
SOURCE_RS = "nlsolvers_tpu_torch/csrc/resident2d.cu"
SOURCE_KB = "nlsolvers_tpu_torch/csrc/kick.cu"
PALLAS = "nlsolvers_tpu/ops/pallas/lanczos2d.py"
PALLAS3 = "nlsolvers_tpu/ops/pallas/lanczos3d_pipe.py"
PALLAS_BC = "nlsolvers_tpu/ops/pallas/bc3d.py"
PALLAS_RS = "nlsolvers_tpu/ops/pallas/resident2d.py"
F32_OPS_PER_S = 67e12          # H100 SXM data sheet, float32 outside the
                               # tensor cores


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def rel(a, b):
    return float((a - b).norm() / b.norm())


def dot_err(got, want, lefts, right):
    """max_i |got_i - want_i| / (||a_i|| ||b||) over a (k, 2) dot array."""
    rn = float(right.norm())
    return max(float((got[i] - want[i]).abs().max())
               / (float(a.norm()) * rn) for i, a in enumerate(lefts))


def dev_us(e):
    """Device time of a profiler row that is a kernel, in microseconds; 0
    for host-op rows, whose device time repeats that of their kernels."""
    from torch.autograd import DeviceType
    if getattr(e, "device_type", None) != DeviceType.CUDA:
        return 0
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0) or 0)


def profiled(torch, fn, tries=5):
    """torch.profiler's key_averages() over fn(); profiled again, up to
    `tries` times, when the trace holds no kernel rows (the profiler drops a
    trace now and then; once three in a row). None if every try comes back
    empty: the caller then times with CUDA events or reports the number as
    not measured."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = prof.key_averages()
        if any(dev_us(e) > 0 for e in rows):
            return rows
        time.sleep(0.2)
    print(f"torch.profiler recorded no device time in {tries} tries")
    return None


def times_ms(torch, fn, reps=20):
    """(device, wall) ms per call of fn: the summed device time of the
    kernels it launches (torch.profiler), and CUDA events around each call,
    median, which include the host's enqueue time when that is longer."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        walls.append(a.elapsed_time(b))
    def batch():
        for _ in range(reps):
            fn()

    rows = profiled(torch, batch)
    if rows is None:
        # CUDA events around the whole batch: the device time when the
        # host enqueues faster than the card runs, else an upper bound
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        batch()
        b.record()
        b.synchronize()
        print(f"  (timed by CUDA events around {reps} calls: "
              f"{a.elapsed_time(b) / reps:.4f} ms per call)")
        return a.elapsed_time(b) / reps, statistics.median(walls)
    device = sum(dev_us(e) for e in rows) / 1e3 / reps
    return device, statistics.median(walls)


def graph_ms(torch, fn, replays=20):
    """ms per call of fn by CUDA-graph replay: fn's launches captured once
    in a torch.cuda.CUDAGraph (warmed up on a side stream, as PyTorch
    requires), replayed back to back with CUDA events around the replays.
    The host's enqueue is out of the window; the median of three windows."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(replays):
            g.replay()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / replays)
    del g
    return statistics.median(out)


def kernel_name(mangled):
    """name<template args> of a mangled kernel whose name ends in _kernel or
    _partials; the name is the length-prefixed identifier before that end."""
    import re
    m = re.search(r"(_kernel|_partials)(I(?:L[ib]\d+E)+E)?", mangled)
    if not m:
        return mangled[:40]
    end = m.end(1)
    name = mangled[:end]
    for j in range(end - 1, 0, -1):
        digits = re.search(r"\d{1,3}$", mangled[:j])
        if digits and int(digits.group()[-len(str(end - j)):]) == end - j:
            name = mangled[j:end]
            break
    if m.group(2):
        name += "<" + ", ".join(re.findall(r"L[ib](\d+)E", m.group(2))) + ">"
    return name


def kernel_resources(lines):
    """(kernel, registers, spill-store bytes) for each kernel in a build
    log's ptxas -v lines."""
    import re
    out, fn, spill = [], "", 0
    for ln in lines:
        if "Function properties for" in ln:
            fn = kernel_name(ln.split("Function properties for")[1].strip())
        elif "spill stores" in ln:
            spill = int(re.search(r"(\d+) bytes spill stores", ln).group(1))
        elif "Used " in ln and " registers" in ln and fn:
            regs = int(ln.split("Used ")[1].split(" registers")[0])
            out.append((fn, regs, spill))
            fn, spill = "", 0
    return out


def bound_ms(nbytes):
    """Least time for `nbytes` of device-memory traffic at the data-sheet
    rate (every kernel here but K13 is bound by bytes, not operations)."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def ops_ms(nops):
    """Least time for `nops` float32 operations at the data-sheet rate."""
    return nops / F32_OPS_PER_S * 1e3


def advance(step, s, n, first=1):
    """n steps from step index `first`. A two-step integrator takes its SS2
    bootstrap at index 1 only, so a caller that goes on from an earlier
    advance passes the next index."""
    for i in range(first, first + n):
        s = step(s, i)
    return s


def finite(torch, s):
    """All values finite, for a state or a two-step state (u, u_prev)."""
    parts = s if isinstance(s, tuple) else (s,)
    return all(bool(torch.isfinite(x).all()) for x in parts)


def host_syncs(torch, fn):
    """Host syncs that fn() makes (torch.cuda sync debug mode)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def rate(torch, runs, chunk, order, n_prof, host_profile=False):
    """Steps/s of one or more problems, each the median of its synchronized
    chunks of `chunk` steps, taken in the interleaved `order` of run labels
    (so that host drift falls on all runs alike). Then per run:
    torch.profiler over n_prof steps (device busy ms/step, idle share,
    launches per step, the top kernels), the host syncs of one step and,
    with host_profile, the host functions that take the most time (cProfile
    over n_prof steps). runs: {label: (problem, initial state)}. Each run
    carries its step index, so a two-step integrator bootstraps once, in the
    warm-up, and every timed step is a step of the integrator itself.
    Returns {label: median steps/s}."""
    state = {k: advance(p.step, s, 3) for k, (p, s) in runs.items()}
    nxt = {k: 4 for k in runs}
    torch.cuda.synchronize()
    rates = {k: [] for k in runs}
    for k in order:
        t0 = time.perf_counter()
        state[k] = advance(runs[k][0].step, state[k], chunk, nxt[k])
        torch.cuda.synchronize()
        rates[k].append(chunk / (time.perf_counter() - t0))
        nxt[k] += chunk
    for label, (prob, _) in runs.items():
        s = state[label]
        check(finite(torch, s), f"{label}: non-finite state after timing")
        r = rates[label]
        sps = statistics.median(r)
        print(f"{label}: {sps:.2f} steps/s median of {len(r)} x {chunk} "
              f"steps (min {min(r):.2f}, max {max(r):.2f}; in call order "
              f"{', '.join(f'{x:.1f}' for x in r)}); {1e3 / sps:.4f} ms/step")
        box, idx = [s], [nxt[label]]

        def steps():
            box[0] = advance(prob.step, box[0], n_prof, idx[0])
            idx[0] += n_prof

        rows = profiled(torch, steps)
        if rows is None:
            print(f"{label}: device busy time not measured (no trace)")
            rows = []
        else:
            busy_ms = sum(dev_us(e) for e in rows) / 1e3 / n_prof
            launched = sum(e.count for e in rows if dev_us(e) > 0) / n_prof
            print(f"{label}: device busy {busy_ms:.4f} ms/step of "
                  f"{1e3 / sps:.4f} ms/step -> idle share "
                  f"{1 - busy_ms * sps / 1e3:.3f}; {launched:.0f} kernel "
                  f"launches per step")
        for e in sorted(rows, key=dev_us, reverse=True)[:8]:
            print(f"  {dev_us(e) / 1e3 / n_prof:9.4f} ms/step "
                  f"{e.count // n_prof:4d}x/step {e.key[:70]}")

        def one_step():
            box[0] = prob.step(box[0], idx[0])
            idx[0] += 1

        print(f"{label}: host syncs in one step: "
              f"{host_syncs(torch, one_step)}")
        if host_profile:
            import cProfile
            import pstats
            torch.cuda.synchronize()
            prof_h = cProfile.Profile()
            prof_h.enable()
            s = advance(prob.step, box[0], n_prof, idx[0])
            torch.cuda.synchronize()
            prof_h.disable()
            st = pstats.Stats(prof_h)
            total = st.total_tt / n_prof * 1e3
            print(f"{label}: host profile (cProfile, which slows the host): "
                  f"{total:.3f} ms/step; most self time:")
            top = sorted(st.stats.items(), key=lambda kv: kv[1][2],
                         reverse=True)[:10]
            for (fname, line, fn), (_, ncalls, tt, _, _) in top:
                where = f"{Path(fname).name}:{line}({fn})"
                print(f"  {tt / n_prof * 1e3:8.4f} ms/step "
                      f"{ncalls // n_prof:5d}x/step {where[:70]}")
    return {k: statistics.median(r) for k, r in rates.items()}


# the datagen production point (benchmarks/datagen_bench.py:22-26, from the
# reference's nlse_2d_launch.sh): cubic NLSE, 256^2, Lx = 10, T = 1.2,
# nt = 2000, 128 snapshots, batch 8, Krylov m = 20, c layered, m piecewise
DG_N, DG_LX, DG_M, DG_DT = 256, 10.0, 20, 1.2 / 2000
DG_RW_DT, DG_RW_M = 0.6 / 200, 10      # the real-wave sweep of datagen-main
DG_PER_STEP = {"K1'": 1, "K2'": DG_M - 1, "K3": 1, "kick_bc": 2,
               "recur": DG_M}
DG_RW_PER_STEP = {"K1'": 2, "K2'": 2 * (DG_RW_M - 1), "K3": 2,
                  "recur": 2 * DG_RW_M}
DG_B = 8                       # lanes of the datagen engine checks


def plain(fn):
    """fn() with the kernels' plain versions (config.kernel_mode "off")."""
    from nlsolvers_tpu_torch import config
    config.kernel_mode = "off"
    try:
        return fn()
    finally:
        config.kernel_mode = "auto"


def batched_parity(torch, np, operators):
    """Phase 34: the batched forms of K1', K2', K3 and kick_bc at the
    datagen point (B = 8 lanes of 256^2, m = 20, P = 2, c(x) per lane),
    and of K1, K2 on the iso operator and on a ragged real batch (the scalar
    forms): ONE launch each, against the plain batched versions (fields
    rel-L2 <= 1e-5, dots <= 1e-4 of the Cauchy-Schwarz scale, every ghost
    cell bit-equal to its source cell) and bit-equal to B unbatched
    launches, lane by lane. Then per batched step by CUDA-graph replay,
    beside the B unbatched launch sequences of the same work, the plain
    batched versions and, for K3, torch.matmul of the lanes (K1 and K2 on
    the iso operator too, the datagen path without c(x)). Returns {kernel:
    readings} for the JSON line."""
    from nlsolvers_tpu_torch.models.nonlinearities import nlse_density_planar
    from nlsolvers_tpu_torch.ops.cuda import kick as kb
    from nlsolvers_tpu_torch.ops.cuda import lanczos2d as lz

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4321)
    B, n, m = DG_B, DG_N, DG_M
    dx = 2.0 * DG_LX / (n - 1)

    def fld(P=2, shape=(n, n), lanes=B):
        return torch.randn((lanes, P) + shape, generator=gen, device=dev)

    def lane_dot_err(got, want, lefts, right):
        return max(dot_err(got[b], want[b], [x[b] for x in lefts], right[b])
                   for b in range(got.shape[0]))

    def lane_rel(a, b):
        return max(rel(a[i], b[i]) for i in range(a.shape[0]))

    def bit_equal(got, lanes):
        return all(torch.equal(x[b], y) for b, want in enumerate(lanes)
                   for x, y in zip(got, want))

    errs = {}

    def gate(label, key, fe, de, same, got, want):
        torch.cuda.synchronize()
        errs[key] = max(errs.get(key, 0.0),
                        max(float((a - b).abs().max())
                            for a, b in zip(got, want) if a.dim() == 4))
        print(f"parity-batched {label}: field rel-L2 {fe:.3e}, dot err "
              f"{de:.3e}, bit-equal to {B} unbatched launches {same}")
        check(fe <= FIELD_TOL, f"{label}: field rel-L2 {fe:.3e}")
        check(de <= DOT_TOL, f"{label}: dot error {de:.3e}")
        check(same, f"{label}: a lane differs from its unbatched launch")

    c = 1.0 + 0.4 * torch.rand((B, n, n), generator=gen, device=dev)
    aniso = operators.batched_aniso_laplacian_2d(list(c), dx, dx, device=dev)
    iso = operators.laplacian_2d((n, n), dx, dx, device=dev).kernel_desc
    lane_a = [dict(aniso, wx=aniso["wx"][b], wy=aniso["wy"][b])
              for b in range(B)]

    def scal_of(rows, lanes=B):
        s = torch.rand((lanes, rows, 2), generator=gen, device=dev) - 0.5
        s[:, 0, 0], s[:, 0, 1] = 0.8, 0.0
        return s

    def check_pass1(label, key, p1, desc, lanes_d, W, j):
        scal = torch.rand((W[0].shape[0], 1, 2), generator=gen, device=dev)
        got = p1(scal, W[j], W[:j], desc, norm=True)
        want = plain(lambda: p1(scal, W[j], W[:j], desc, norm=True))
        alone = [p1(scal[b], W[j][b], [w[b] for w in W[:j]], lanes_d[b],
                    norm=True) for b in range(W[0].shape[0])]
        nerr = float(((got[2] - want[2]).abs() / want[2]).max())
        gate(label, key, lane_rel(got[0], want[0]),
             max(lane_dot_err(got[1], want[1], W[:j + 1], want[0]), nerr),
             bit_equal(got, alone), got, want)

    def check_pipe(label, key, pp, desc, lanes_d, av, W, last):
        nw = len(W)
        scal = scal_of(nw + 1, av.shape[0])
        got = pp(scal, av, W, desc, last)
        want = plain(lambda: pp(scal, av, W, desc, last))
        alone = [pp(scal[b], av[b], [w[b] for w in W], lanes_d[b], last)
                 for b in range(av.shape[0])]
        nsq, gram = (got[1], got[2]) if last else (got[2], got[3])
        nsq0, gram0 = (want[1], want[2]) if last else (want[2], want[3])
        fe = lane_rel(got[0], want[0])
        de = max(float(((nsq - nsq0).abs() / nsq0.abs()).max()),
                 lane_dot_err(gram, gram0, W, want[0]))
        if not last:
            fe = max(fe, lane_rel(got[1], want[1]))
            de = max(de, lane_dot_err(got[4], want[4], W + [want[0]],
                                      want[1]))
        gate(label, key, fe, de, bit_equal(got, alone), got, want)

    # the datagen path: K1' at j = 0, K2' at every j of m = 20, K3 k = 1
    W = [fld() for _ in range(m)]
    av = fld()
    check_pass1("K1' j=0", "K1'", lz.pass1_aniso2d, aniso, lane_a, W, 0)
    check_pass1("K1' j=19", "K1'", lz.pass1_aniso2d, aniso, lane_a, W, 19)
    for j in range(m - 1):
        check_pipe(f"K2' j={j}{' last' if j == m - 2 else ''}", "K2'",
                   lz.pipe_aniso2d, aniso, lane_a, av, W[:j + 1],
                   j == m - 2)
    check_pipe("K2' j=19", "K2'", lz.pipe_aniso2d, aniso, lane_a, av, W,
               False)
    q = torch.rand((B, 1, m, 2), generator=gen, device=dev) - 0.5
    got = lz.combine(q, W)
    want = plain(lambda: lz.combine(q, W))
    alone = [lz.combine(q[b], [w[b] for w in W]) for b in range(B)]
    gate("K3 k=1 m=20", "K3", lane_rel(got[0], want[0]), 0.0,
         bit_equal(got, alone), got, want)
    # the iso operator; a ragged real batch (the scalar forms), sign -1
    check_pass1("K1 iso j=0", "K1", lz.pass1_iso2d, iso, [iso] * B, W, 0)
    check_pipe("K2 iso j=5", "K2", lz.pipe_iso2d, iso, [iso] * B, av, W[:6],
               False)
    rag = dict(operators.laplacian_2d((251, 335), dx, dx,
                                      device=dev).kernel_desc, sign=-1.0)
    Wr = [fld(1, (251, 335), 3) for _ in range(6)]
    check_pass1("K1 P=1 251x335 j=4", "K1", lz.pass1_iso2d, rag, [rag] * 3,
                Wr, 4)
    check_pipe("K2 P=1 251x335 j=4 last", "K2", lz.pipe_iso2d, rag,
               [rag] * 3, Wr[5], Wr[:5], True)
    ca = 1.0 + 0.4 * torch.rand((3, 251, 335), generator=gen, device=dev)
    rag_a = operators.batched_aniso_laplacian_2d(list(ca), dx, dx,
                                                 device=dev)
    rag_al = [dict(rag_a, wx=rag_a["wx"][b], wy=rag_a["wy"][b])
              for b in range(3)]
    check_pipe("K2' P=1 251x335 j=3", "K2'", lz.pipe_aniso2d, rag_a, rag_al,
               Wr[5], Wr[:4], False)
    del Wr

    # kick_bc: the opening kick and the closing one with the ghost copy
    up = fld()
    mf = 0.5 + torch.rand((B, n, n), generator=gen, device=dev)
    rho = nlse_density_planar("cubic", mf)
    grid = kb.kick_grid((n, n))
    for g in (None, grid):
        got = kb.phase_kick_bc_planar(up, rho, 0.3, g)
        want = plain(lambda: kb.phase_kick_bc_planar(up, rho, 0.3, g))
        alone = [kb.phase_kick_bc_planar(
            up[b], nlse_density_planar("cubic", mf[b]), 0.3, g)
            for b in range(B)]
        ghost = True
        if g is not None:
            rows = torch.arange(n, device=dev).clamp(1, n - 2)
            ghost = bool(torch.equal(got, got[..., rows, :][..., rows]))
        print(f"parity-batched kick_bc {'ghost copy' if g else 'kick'}: "
              f"ghost cells bit-equal to their source cells {ghost}")
        check(ghost, "kick_bc batched: a ghost cell differs")
        gate(f"kick_bc {'ghost' if g else 'kick'}", "kick_bc",
             lane_rel(got, want), 0.0, bit_equal([got], [[a] for a in alone]),
             [got], [want])

    # times per batched step at the datagen point
    scs = [scal_of(j + 2) for j in range(m - 1)]
    one = torch.tensor([[0.8, 0.3]], device=dev).expand(B, 1, 2).contiguous()

    def k1():
        lz.pass1_aniso2d(one, W[0], [], aniso, norm=True)

    def k1_lanes():
        for b in range(B):
            lz.pass1_aniso2d(one[b], W[0][b], [], lane_a[b], norm=True)

    def k2():
        for j in range(m - 1):
            lz.pipe_aniso2d(scs[j], av, W[:j + 1], aniso, j == m - 2)

    def k2_lanes():
        for b in range(B):
            for j in range(m - 1):
                lz.pipe_aniso2d(scs[j][b], av[b], [w[b] for w in W[:j + 1]],
                                lane_a[b], j == m - 2)

    def k1_iso():
        lz.pass1_iso2d(one, W[0], [], iso, norm=True)

    def k1_iso_lanes():
        for b in range(B):
            lz.pass1_iso2d(one[b], W[0][b], [], iso, norm=True)

    def k2_iso():
        for j in range(m - 1):
            lz.pipe_iso2d(scs[j], av, W[:j + 1], iso, j == m - 2)

    def k2_iso_lanes():
        for b in range(B):
            for j in range(m - 1):
                lz.pipe_iso2d(scs[j][b], av[b], [w[b] for w in W[:j + 1]],
                              iso, j == m - 2)

    def k3():
        lz.combine(q, W)

    def k3_lanes():
        for b in range(B):
            lz.combine(q[b], [w[b] for w in W])

    def kick():
        kb.phase_kick_bc_planar(kb.phase_kick_bc_planar(up, rho, 0.3), rho,
                                0.3, grid)

    rho_l = [nlse_density_planar("cubic", mf[b]) for b in range(B)]

    def kick_lanes():
        for b in range(B):
            kb.phase_kick_bc_planar(kb.phase_kick_bc_planar(
                up[b], rho_l[b], 0.3), rho_l[b], 0.3, grid)

    Wc = torch.stack([torch.complex(w[:, 0], w[:, 1]).reshape(B, -1)
                      for w in W], dim=1)
    qc = torch.complex(q[..., 0], q[..., 1])
    col = 2 * n * n * 4 * B
    wbytes = 2 * n * n * 4 * B
    k2_cols = sum(j + 4 for j in range(m - 2)) + m + 1
    out = {}
    for key, fn, lanes, launches, nbytes, lib in (
            ("K1'", k1, k1_lanes, 1, 2 * col + wbytes, None),
            ("K2'", k2, k2_lanes, m - 1, k2_cols * col + (m - 2) * wbytes,
             None),
            ("K3", k3, k3_lanes, 1, (m + 1) * col,
             lambda: torch.matmul(qc, Wc)),
            ("kick_bc", kick, kick_lanes, 2, 20 * n * n * B * 2, None),
            ("K1", k1_iso, k1_iso_lanes, 1, 2 * col, None),
            ("K2", k2_iso, k2_iso_lanes, m - 1, k2_cols * col, None)):
        g = graph_ms(torch, fn, 50)
        g_lanes = graph_ms(torch, lanes, 20)
        prof, events = times_ms(torch, fn, 20)
        plain_ms = plain(lambda: times_ms(torch, fn, 5))[0]
        lib_ms = None if lib is None else graph_ms(torch, lib, 50)
        out[key] = dict(err=errs[key], graph=g, lanes_graph=g_lanes,
                        t=(prof, events, plain_ms), nbytes=nbytes,
                        lib=lib_ms, launches=launches)
        print(f"parity-batched {key} B={B} {n}^2 m={m}: graph {g:.4f} ms "
              f"per batched step ({launches} launch"
              f"{'es' if launches > 1 else ''}), {B} unbatched launch "
              f"sequences {g_lanes:.4f} ms ({g_lanes / g:.2f}x); profiler "
              f"{prof:.4f}, events {events:.4f}; plain batched {plain_ms:.4f}"
              + ("" if lib_ms is None else f"; torch.matmul of the lanes "
                 f"{lib_ms:.4f}")
              + f"; bound {bound_ms(nbytes):.4f} ms ({nbytes / 1e6:.1f} MB)"
              f" -> {bound_ms(nbytes) / g:.3f} of it")
    del W, av, up, Wc
    torch.cuda.empty_cache()
    return out


DG3_N, DG3_M = 128, 10         # the 3D datagen point: JAX's --dim 3 nx,
                               # Krylov m = 10 (DatagenConfig's 3D default)
DG3_PER_STEP = {"pass1_3d": DG3_M - 1, "pass2": DG3_M, "K3": 1,
                "kick_bc": 2}
DG3_RW_PER_STEP = {"pass1_3d": 2 * (DG3_M - 1), "pass2": 2 * DG3_M,
                   "K3": 2, "bc3d": 1}


def batched_parity3d(torch, np, operators):
    """Phase 34, 3D half: the batched forms of pass1_3d, pass2 (its
    norm-only form too) and bc3d at the 3D datagen point (B = 8 lanes of
    128^3, m = 10), iso and c(x) per lane, P = 2 and P = 1 (sign -1), and
    kick_bc on a 3D batch: ONE launch each, against the plain batched
    versions (fields rel-L2 <= 1e-5, dots <= 1e-4 of the Cauchy-Schwarz
    scale, bc3d exactly) and bit-equal to B unbatched launches, lane by
    lane. Then per batched step of the 3D datagen paths (pass1_3d j =
    0..8; pass2's norm form and nw = 1..9; one bc3d; both kicks) by
    CUDA-graph replay beside the B unbatched launch sequences, the
    profiler, the events and the plain batched versions. Returns {kernel:
    readings} for the JSON line."""
    from nlsolvers_tpu_torch.models.nonlinearities import nlse_density_planar
    from nlsolvers_tpu_torch.ops.cuda import bc3d as b3
    from nlsolvers_tpu_torch.ops.cuda import kick as kb
    from nlsolvers_tpu_torch.ops.cuda import lanczos3d as l3

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4322)
    B, n, m = DG_B, DG3_N, DG3_M
    shape, R = (n, n, n), n * n
    dx = 2.0 * DG_LX / (n - 1)

    def fld(P):
        return torch.randn((B, P, R, n), generator=gen, device=dev)

    errs = {}

    def gate(label, key, got, want, lanes, fields):
        torch.cuda.synchronize()
        fe = de = 0.0
        for b in range(B):
            scale = max(float(f[b].norm()) ** 2 for f in fields)
            for x, y in zip(got, want):
                if x.dim() == 4:
                    fe = max(fe, rel(x[b], y[b]))
                else:
                    de = max(de, float((x[b] - y[b]).abs().max()) / scale)
        same = all(torch.equal(x[b], y) for b, ys in enumerate(lanes)
                   for x, y in zip(got, ys))
        errs[key] = max(errs.get(key, 0.0),
                        max(float((x - y).abs().max())
                            for x, y in zip(got, want) if x.dim() == 4))
        print(f"parity-batched {label}: field rel-L2 {fe:.3e}, dot err "
              f"{de:.3e}, bit-equal to {B} unbatched launches {same}")
        check(fe <= FIELD_TOL, f"{label}: field rel-L2 {fe:.3e}")
        check(de <= DOT_TOL, f"{label}: dot error {de:.3e}")
        check(same, f"{label}: a lane differs from its unbatched launch")

    c = 1.0 + 0.4 * torch.rand((B,) + shape, generator=gen, device=dev)
    ops_ = {"iso": (operators.laplacian_3d(shape, dx,
                                           device=dev).kernel_desc, None),
            "c(x)": (operators.batched_aniso_laplacian_3d(list(c), dx,
                                                          device=dev), c)}
    del c
    for P in (2, 1):
        W = [fld(P) for _ in range(m)]
        for op, (d, _) in ops_.items():
            d = dict(d, sign=-1.0) if P == 1 else d
            lanes = [d if "wx" not in d else
                     dict(d, **{k: d[k][b] for k in ("wx", "wy", "wz")})
                     for b in range(B)]
            key = "pass1_3d" + (" P=1" if P == 1 else "")
            for j in (0, m - 1):
                scal = torch.rand((B, 1, 2), generator=gen, device=dev)
                got = l3.pass1_3d(scal, W[j], W[:j], d)
                want = plain(lambda: l3.pass1_3d(scal, W[j], W[:j], d))
                alone = [l3.pass1_3d(scal[b], W[j][b],
                                     [w[b] for w in W[:j]], lanes[b])
                         for b in range(B)]
                gate(f"pass1_3d {op} P={P} j={j}", key, got, want, alone,
                     W[:j + 1] + [want[0]])
        key = "pass2" + (" P=1" if P == 1 else "")
        for nw in (0, 1, m - 1):
            q = (torch.rand((B, nw, 2), generator=gen, device=dev) - 0.5
                 if nw else None)
            got = l3.pass2(q, W[-1], W[:nw])
            want = plain(lambda: l3.pass2(q, W[-1], W[:nw]))
            alone = [l3.pass2(None if q is None else q[b], W[-1][b],
                              [w[b] for w in W[:nw]]) for b in range(B)]
            gate(f"pass2 P={P} nw={nw}{' (norm form)' if not nw else ''}",
                 key, got, want, alone, W[:nw] + [W[-1], want[0]])
        up = W[0].clone()
        alone = [b3.neumann_bc_planar_3d(up[b].clone(), shape)
                 for b in range(B)]
        got = b3.neumann_bc_planar_3d(up.clone(), shape)
        want = plain(lambda: b3.neumann_bc_planar_3d(up.clone(), shape))
        torch.cuda.synchronize()
        same = all(torch.equal(got[b], a) for b, a in enumerate(alone))
        print(f"parity-batched bc3d P={P}: equal to its plain version "
              f"{bool(torch.equal(got, want))}, bit-equal to {B} unbatched "
              f"launches {same}")
        check(bool(torch.equal(got, want)) and same, f"bc3d batched P={P}")
        del W, up, got, want, alone
    # kick_bc on the 3D batch: the opening kick and the closing one with
    # the ghost copy
    up = fld(2)
    mf = 0.5 + torch.rand((B, R, n), generator=gen, device=dev)
    rho = nlse_density_planar("cubic", mf)
    rho_l = [nlse_density_planar("cubic", mf[b]) for b in range(B)]
    grid = kb.kick_grid(shape)
    for g in (None, grid):
        got = kb.phase_kick_bc_planar(up, rho, 0.3, g)
        want = plain(lambda: kb.phase_kick_bc_planar(up, rho, 0.3, g))
        alone = [[kb.phase_kick_bc_planar(up[b], rho_l[b], 0.3, g)]
                 for b in range(B)]
        gate(f"kick_bc 3D {'ghost' if g else 'kick'}", "kick_bc 3D", [got],
             [want], alone, [up])

    # times per batched step of the 3D datagen paths
    out = {}
    col1 = R * n * 4 * B                 # one real (B, 1, R, nx) column
    for P in (2, 1):
        W = [fld(P) for _ in range(m)]
        w = fld(P)
        one = torch.tensor([[0.8, 0.3]], device=dev).expand(
            B, 1, 2).contiguous()
        qs = [torch.rand((B, j + 1, 2), generator=gen, device=dev) - 0.5
              for j in range(m - 1)]
        col = P * col1
        runs = []
        for op, (d, _) in ops_.items():
            d = dict(d, sign=-1.0) if P == 1 else d
            lanes = [d if "wx" not in d else
                     dict(d, **{k: d[k][b] for k in ("wx", "wy", "wz")})
                     for b in range(B)]

            def p1(d=d):
                for j in range(m - 1):
                    l3.pass1_3d(one, W[j], W[:j], d)

            def p1_lanes(lanes=lanes):
                for b in range(B):
                    for j in range(m - 1):
                        l3.pass1_3d(one[b], W[j][b], [x[b] for x in W[:j]],
                                    lanes[b])

            wts = 3 * col1 * (m - 1) if op == "c(x)" else 0
            key = "pass1_3d" + (" aniso" if op == "c(x)" else "")
            runs.append((key + (" P=1" if P == 1 else ""), p1, p1_lanes,
                         m - 1,
                         sum(j + 2 for j in range(m - 1)) * col + wts))

        def p2():
            l3.pass2(None, W[0], [])
            for j in range(m - 1):
                l3.pass2(qs[j], w, W[:j + 1])

        def p2_lanes():
            for b in range(B):
                l3.pass2(None, W[0][b], [])
                for j in range(m - 1):
                    l3.pass2(qs[j][b], w[b], [x[b] for x in W[:j + 1]])

        def bc():
            b3.neumann_bc_planar_3d(w, shape)

        def bc_lanes():
            for b in range(B):
                b3.neumann_bc_planar_3d(w[b], shape)

        sfx = " P=1" if P == 1 else ""
        runs.append(("pass2" + sfx, p2, p2_lanes, m,
                     (sum(j + 3 for j in range(m - 1)) + 1) * col))
        cells = 2 * n * n + 2 * (n - 2) * n + 2 * (n - 2) * (n - 2)
        runs.append(("bc3d" + sfx, bc, bc_lanes, 1, cells * P * 4 * 2 * B))
        if P == 2:
            def kick():
                kb.phase_kick_bc_planar(kb.phase_kick_bc_planar(
                    up, rho, 0.3), rho, 0.3, grid)

            def kick_lanes():
                for b in range(B):
                    kb.phase_kick_bc_planar(kb.phase_kick_bc_planar(
                        up[b], rho_l[b], 0.3), rho_l[b], 0.3, grid)

            runs.append(("kick_bc 3D", kick, kick_lanes, 2,
                         20 * R * n * B * 2))
        for key, fn, lanes_fn, launches, nbytes in runs:
            g = graph_ms(torch, fn, 10)
            g_lanes = graph_ms(torch, lanes_fn, 5)
            prof, events = times_ms(torch, fn, 5)
            plain_ms = plain(lambda: times_ms(torch, fn, 2))[0]
            base = key.replace(" aniso", "")
            out[key] = dict(err=errs.get(base, 0.0), graph=g,
                            lanes_graph=g_lanes, t=(prof, events, plain_ms),
                            nbytes=nbytes, lib=None, launches=launches)
            print(f"parity-batched {key} B={B} {n}^3 m={m}: graph {g:.4f} "
                  f"ms per batched step ({launches} launch"
                  f"{'es' if launches > 1 else ''}), {B} unbatched launch "
                  f"sequences {g_lanes:.4f} ms ({g_lanes / g:.2f}x); "
                  f"profiler {prof:.4f}, events {events:.4f}; plain batched "
                  f"{plain_ms:.4f}; bound {bound_ms(nbytes):.4f} ms "
                  f"({nbytes / 1e6:.1f} MB) -> {bound_ms(nbytes) / g:.3f} "
                  f"of it")
        del W, w
    del up, ops_
    torch.cuda.empty_cache()
    return out


def batched_parity_optin(torch, np, operators):
    """Phase 34, opt-in half: the batched K5 (iter_step, config.fused_iter)
    and K8 (pipe_3d, config.pipeline_3d) at the datagen points: K5 on B = 8
    lanes of 256^2 (m = 20, iso and c(x) per lane, j = 0, 9, 18) and of
    128^3 (iso, j = 0, 8), K8 on 8 lanes of 128^3 (iso and c(x), j = 0, 7),
    each with P = 2, then P = 1 with the sign flipped, and a ragged real
    batch of each (the scalar forms): ONE launch each, against the plain
    batched versions (phase 3's gates), bit-equal to B unbatched launches
    lane by lane, and two launches bit for bit. Then per batched step (the
    launches of one Lanczos run: K5 j = 0..m-2, K8 j = 0..m-3) by
    CUDA-graph replay beside the B unbatched launch sequences, the
    profiler, the events, the plain batched versions and B x the bytes
    bound. Returns {kernel: readings} for the JSON line."""
    from nlsolvers_tpu_torch.ops.cuda import lanczos2d as lz
    from nlsolvers_tpu_torch.ops.cuda import lanczos3d as l3

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4323)
    B = DG_B

    def fld(lanes, P, rows, nx):
        return torch.randn((lanes, P, rows, nx), generator=gen, device=dev)

    errs = {}

    def gate(label, key, fn, want, alone, fields):
        """fn() (the batched launch) against the plain batched outputs
        `want` and the unbatched launches `alone`, lane by lane; `fields`
        are the fields whose products scale the dots."""
        got, again = fn(), fn()
        torch.cuda.synchronize()
        lanes = got[0].shape[0]
        fe = de = 0.0
        for b in range(lanes):
            scale = max(float(f[b].norm()) ** 2 for f in fields)
            for x, y in zip(got, want):
                if x.dim() == 4:
                    fe = max(fe, rel(x[b], y[b]))
                else:
                    de = max(de, float((x[b] - y[b]).abs().max()) / scale)
        same = all(torch.equal(x[b], y) for b, ys in enumerate(alone)
                   for x, y in zip(got, ys))
        repeat = all(torch.equal(x, y) for x, y in zip(got, again))
        errs[key] = max(errs.get(key, 0.0),
                        max(float((x - y).abs().max())
                            for x, y in zip(got, want) if x.dim() == 4))
        print(f"parity-batched {label}: field rel-L2 {fe:.3e}, dot err "
              f"{de:.3e}, bit-equal to {lanes} unbatched launches {same}, "
              f"two launches bit for bit {repeat}")
        check(fe <= FIELD_TOL, f"{label}: field rel-L2 {fe:.3e}")
        check(de <= DOT_TOL, f"{label}: dot error {de:.3e}")
        check(same, f"{label}: a lane differs from its unbatched launch")
        check(repeat, f"{label}: two launches differ")

    def k5_scal(W, j):
        """(lanes, 1, j+3) [s_j, bs, s_0..s_j], inverse norms near
        1/||W_i|| per lane (the loop's magnitudes)."""
        lanes = W[0].shape[0]
        norms = torch.stack([w.flatten(1).norm(dim=1) for w in W[:j + 1]],
                            dim=1)
        sv = (0.5 + 0.5 * torch.rand((lanes, j + 1), generator=gen,
                                     device=dev)) / norms
        bs = torch.full((lanes, 1), 0.3, device=dev)
        return torch.cat([sv[:, j:j + 1], bs, sv], dim=1)[:, None]

    def lane_desc(d, b):
        return d if "wx" not in d else dict(
            d, **{k: d[k][b] for k in ("wx", "wy", "wz") if k in d})

    def check_k5(label, d, W, j):
        lanes = W[0].shape[0]
        rows, nx = W[0].shape[-2:]
        opk = lz._iter_opk(d, "k5")
        onchip, grid = lz.iter_form(W[0].shape[1], rows, nx, opk, j,
                                    nx % 4 == 0, lanes)
        scal = k5_scal(W, j)

        def fn():
            return lz.iter_step(scal, W[j], W[:j], d)

        want = plain(fn)
        alone = [lz.iter_step(scal[b], W[j][b], [w[b] for w in W[:j]],
                              lane_desc(d, b)) for b in range(lanes)]
        w0 = lz._pass1_ref(scal[..., :2], W[j], W[:j],
                           lz._operator_ref(W[j], d))[0]
        gate(f"{label} ({'on-chip' if onchip else 'global'} w, {grid} "
             f"blocks)", "K5", fn, want, alone, W[:j + 1] + [w0])

    def check_k8(label, key, d, W, av, j):
        lanes = av.shape[0]
        scal = torch.rand((lanes, j + 2, 2), generator=gen, device=dev) - 0.5
        scal[:, 0, 0], scal[:, 0, 1] = 0.8, 0.0

        def fn():
            return l3.pipe_3d(scal, av, W[:j + 1], d)

        want = plain(fn)
        alone = [l3.pipe_3d(scal[b], av[b], [w[b] for w in W[:j + 1]],
                            lane_desc(d, b)) for b in range(lanes)]
        gate(label, key, fn, want, alone, W[:j + 1] + [av, want[0],
                                                       want[1]])

    n, m = DG_N, DG_M
    dx = 2.0 * DG_LX / (n - 1)
    c2 = 1.0 + 0.4 * torch.rand((B, n, n), generator=gen, device=dev)
    ops2 = {"iso": operators.laplacian_2d((n, n), dx, dx,
                                          device=dev).kernel_desc,
            "c(x)": operators.batched_aniso_laplacian_2d(list(c2), dx, dx,
                                                         device=dev)}
    n3, m3 = DG3_N, DG3_M
    dx3 = 2.0 * DG_LX / (n3 - 1)
    c3 = 1.0 + 0.4 * torch.rand((B, n3, n3, n3), generator=gen, device=dev)
    ops3 = {"iso": operators.laplacian_3d((n3,) * 3, dx3,
                                          device=dev).kernel_desc,
            "c(x)": operators.batched_aniso_laplacian_3d(list(c3), dx3,
                                                         device=dev)}
    del c2, c3
    for P in (2, 1):
        flip = (lambda d: dict(d, sign=-1.0)) if P == 1 else (lambda d: d)
        sfx = f" P={P}" + (" sign -1" if P == 1 else "")
        W = [fld(B, P, n, n) for _ in range(m - 1)]
        for op, d in ops2.items():
            for j in (0, 9, 18):
                check_k5(f"K5 {op} {n}^2 j={j}{sfx}", flip(d), W, j)
        del W
        W = [fld(B, P, n3 * n3, n3) for _ in range(m3)]
        for j in (0, 8):
            check_k5(f"K5 iso {n3}^3 j={j}{sfx}", flip(ops3["iso"]), W, j)
        av = fld(B, P, n3 * n3, n3)
        for op, d in ops3.items():
            for j in (0, 7):
                check_k8(f"K8 {op} {n3}^3 j={j}{sfx}", "K8", flip(d), W,
                         av, j)
        del W, av
    # ragged real batches, sign -1: the scalar forms (nx % 4 != 0)
    rag = operators.batched_aniso_laplacian_2d(
        list(1.0 + 0.4 * torch.rand((3, 251, 335), generator=gen,
                                    device=dev)), dx, dx, device=dev)
    Wr = [fld(3, 1, 251, 335) for _ in range(6)]
    check_k5("K5 c(x) 3 x 251x335 j=4 P=1 sign -1", dict(rag, sign=-1.0),
             Wr, 4)
    check_k5("K5 iso 3 x 251x335 j=5 P=1 sign -1", dict(
        operators.laplacian_2d((251, 335), dx, dx, device=dev).kernel_desc,
        sign=-1.0), Wr, 5)
    shp = (37, 50, 61)
    rag3 = operators.batched_aniso_laplacian_3d(
        list(1.0 + 0.4 * torch.rand((3,) + shp, generator=gen, device=dev)),
        dx3, device=dev)
    Wr = [fld(3, 1, shp[0] * shp[1], shp[2]) for _ in range(5)]
    check_k8("K8 c(x) 3 x 37x50x61 j=3 P=1 sign -1", "K8",
             dict(rag3, sign=-1.0), Wr, Wr[4], 3)
    check_k5("K5 iso 3 x 37x50x61 j=3 P=1 sign -1", dict(
        operators.laplacian_3d(shp, dx3, device=dev).kernel_desc,
        sign=-1.0), Wr, 3)
    del Wr, rag, rag3

    # times per batched step: the K5 launches of one fused run, the K8
    # launches of one pipelined 3D run
    out = {}
    runs = []
    col2 = 2 * n * n * 4
    W2 = [fld(B, 2, n, n) for _ in range(m)]
    for op in ("c(x)", "iso"):
        d = ops2[op]
        scs = [k5_scal(W2, j) for j in range(m - 1)]
        wts = 2 * n * n * 4 * (m - 1) if op == "c(x)" else 0

        def k5(d=d, scs=scs):
            for j in range(m - 1):
                lz.iter_step(scs[j], W2[j], W2[:j], d)

        def k5_lanes(d=d, scs=scs):
            for b in range(B):
                db = lane_desc(d, b)
                for j in range(m - 1):
                    lz.iter_step(scs[j][b], W2[j][b],
                                 [w[b] for w in W2[:j]], db)

        runs.append((f"K5 {op} {n}^2 m={m}", k5, k5_lanes, m - 1,
                     B * (sum(j + 2 for j in range(m - 1)) * col2 + wts)))
    col3 = 2 * n3 ** 3 * 4
    W3 = [fld(B, 2, n3 * n3, n3) for _ in range(m3)]
    av3 = fld(B, 2, n3 * n3, n3)
    scs3 = [k5_scal(W3, j) for j in range(m3 - 1)]

    def k5_3d():
        for j in range(m3 - 1):
            lz.iter_step(scs3[j], W3[j], W3[:j], ops3["iso"])

    def k5_3d_lanes():
        for b in range(B):
            for j in range(m3 - 1):
                lz.iter_step(scs3[j][b], W3[j][b], [w[b] for w in W3[:j]],
                             ops3["iso"])

    runs.append((f"K5 iso {n3}^3 m={m3}", k5_3d, k5_3d_lanes, m3 - 1,
                 B * sum(j + 2 for j in range(m3 - 1)) * col3))
    sc8 = []
    for j in range(m3 - 2):
        s8 = torch.rand((B, j + 2, 2), generator=gen, device=dev) - 0.5
        s8[:, 0, 0], s8[:, 0, 1] = 0.8, 0.0
        sc8.append(s8)
    for op in ("c(x)", "iso"):
        d = ops3[op]
        wts = 3 * n3 ** 3 * 4 * (m3 - 2) if op == "c(x)" else 0

        def k8(d=d):
            for j in range(m3 - 2):
                l3.pipe_3d(sc8[j], av3, W3[:j + 1], d)

        def k8_lanes(d=d):
            for b in range(B):
                db = lane_desc(d, b)
                for j in range(m3 - 2):
                    l3.pipe_3d(sc8[j][b], av3[b], [w[b] for w in W3[:j + 1]],
                               db)

        runs.append((f"K8 {op} {n3}^3 m={m3}", k8, k8_lanes, m3 - 2,
                     B * (sum(j + 4 for j in range(m3 - 2)) * col3 + wts)))
    for key, fn, lanes_fn, launches, nbytes in runs:
        g = graph_ms(torch, fn, 10)
        g_lanes = graph_ms(torch, lanes_fn, 5)
        prof, events = times_ms(torch, fn, 5)
        plain_ms = plain(lambda: times_ms(torch, fn, 2))[0]
        out[key] = dict(err=errs["K8" if key.startswith("K8") else "K5"],
                        graph=g, lanes_graph=g_lanes,
                        t=(prof, events, plain_ms), nbytes=nbytes, lib=None,
                        launches=launches)
        print(f"parity-batched {key} B={B}: graph {g:.4f} ms per batched "
              f"step ({launches} launches), {B} unbatched launch sequences "
              f"{g_lanes:.4f} ms ({g_lanes / g:.2f}x); profiler {prof:.4f}, "
              f"events {events:.4f}; plain batched {plain_ms:.4f}; bound "
              f"{bound_ms(nbytes):.4f} ms ({nbytes / 1e6:.1f} MB) -> "
              f"{bound_ms(nbytes) / g:.3f} of it")
    del W2, W3, av3, ops2, ops3
    torch.cuda.empty_cache()
    return out


# the sweeps of rate-datagen beside the NLSE one: (label, DatagenConfig
# arguments); 8 runs in one batch each, c layered, m piecewise; the 2D sEWI
# sweep at the NLSE sweep's production dt and depth
DG_SWEEPS = (
    ("nlse 2D sewi", dict(family="nlse", phenomenon="multi_soliton",
                          system="cubic", nx=DG_N, T=0.12, nt=200,
                          snapshots=20, integrator="sewi")),
    ("realwave 2D", dict(family="realwave", phenomenon="kink_field",
                         system="sine_gordon", nx=DG_N, T=0.6, nt=200,
                         snapshots=20)),
    ("nlse 3D", dict(family="nlse", phenomenon="multi_soliton_state",
                     system="cubic", dim=3, nx=DG3_N, T=0.048, nt=80,
                     snapshots=5)),
    ("realwave 3D", dict(family="realwave", phenomenon="kink_field",
                         system="klein_gordon", dim=3, nx=DG3_N, T=0.24,
                         nt=80, snapshots=5)))


def datagen_rates(torch, np, datagen, work, sweeps=DG_SWEEPS, runs=DG_B):
    """For each sweep of `sweeps`: one batched step of its engine (B =
    `runs` lanes drawn by Datagen) timed by the host's clock around 10
    steps inside one call, synchronized, its device busy time and idle
    share from torch.profiler over 5 steps and its kernel launches; then
    the sweep end to end through Datagen.run (sampling, guard, npy
    archive): trajectories/min. `datagen` is the pipeline module of the
    package under test (time_kernels.py passes another tree's). Returns
    {label: readings}."""
    out = {}
    for label, kw in sweeps:
        cfg = datagen.DatagenConfig(
            Lx=DG_LX, num_runs=runs, batch_size=runs,
            anisotropy_type="layered", m_type="piecewise",
            archive_format="npy", output_dir=str(work / "rate_sweep"), **kw)
        dg = datagen.Datagen(cfg)
        _, u0s, v0s, m_b, c_b = dg._sample_batch(runs)
        m_b, c_b = m_b.astype(np.float32), c_b.astype(np.float32)
        if cfg.family == "nlse":
            u0 = np.stack(u0s)
            args = (np.stack([u0.real, u0.imag], axis=1).astype(np.float32),
                    m_b, c_b)
        else:
            args = (np.stack(u0s).astype(np.float32),
                    np.stack(v0s).astype(np.float32), m_b, c_b)
        args = [torch.from_numpy(a).to("cuda") for a in args]
        fn = dg.traj_fn
        fn(*args, 2, 1)                                  # warm
        torch.cuda.synchronize()
        n_b = 10
        t0 = time.perf_counter()
        fn(*args, 2, n_b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n_b * 1e3
        n_p = 5
        rows = profiled(torch, lambda: fn(*args, 2, n_p))
        busy = launched = None
        if rows is not None:
            busy = sum(dev_us(e) for e in rows) / 1e3 / n_p
            launched = sum(e.count for e in rows if dev_us(e) > 0) / n_p
        del args
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        written = dg.run()
        sweep = time.perf_counter() - t0
        steps = (cfg.snapshots - 1) * cfg.snapshot_freq
        r = dict(batched=getattr(fn, "batched", False), wall_ms=wall,
                 busy_ms=busy, idle=None if busy is None else 1 - busy / wall,
                 launches=launched, sweep_s=sweep, runs=len(written),
                 steps=steps, per_min=len(written) / sweep * 60.0,
                 traj_steps_s=len(written) * steps / sweep,
                 per_min_steps=runs / (wall / 1e3 * steps) * 60.0)
        out[label] = r
        print(f"rate-datagen {label} (B={runs}, {cfg.nx}^{cfg.dim} m="
              f"{cfg.krylov_m}, batched step {r['batched']}): one batched "
              f"step {wall:.3f} ms wall, device busy "
              + ("not measured" if busy is None else
                 f"{busy:.4f} ms -> idle share {r['idle']:.3f}, "
                 f"{launched:.1f} kernel launches per batched step")
              + f"; sweep of {len(written)} runs x {steps} steps "
              f"{sweep:.3f} s (sampling {dg.last_stats['sample_s']:.3f}, "
              f"evolve {dg.last_stats['evolve_s']:.3f}, archive "
              f"{dg.last_stats['archive_s']:.3f}): {r['per_min']:.2f} "
              f"trajectories/min, {r['traj_steps_s']:.1f} trajectory-steps/"
              f"s; the steps alone {r['per_min_steps']:.2f} "
              f"trajectories/min")
        del dg
        import shutil
        shutil.rmtree(work / "rate_sweep", ignore_errors=True)
    return out


def datagen_phases(torch, np, root, counters_all):
    """Phases 33-37: the datagen pipeline (nlsolvers_tpu_torch/pipeline/)
    on the card. Returns ({kernel key: launches per batched step} of the 2D
    NLSE datagen step, counted in datagen-engine, and parity-batched's
    readings)."""
    import importlib.util
    import re
    import shutil

    from nlsolvers_tpu_torch import config, native
    from nlsolvers_tpu_torch.models import problems
    from nlsolvers_tpu_torch.ops import operators
    from nlsolvers_tpu_torch.pipeline import datagen, engine

    work = root / "_smoke_datagen"          # git-ignored, removed at the end
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    shape = (DG_N, DG_N)

    def counts():
        return {k: f.launches for k, f in counters_all.items() if f.launches}

    def zero():
        torch.cuda.synchronize()
        for f in counters_all.values():
            f.launches = 0

    # ---------------------------------------------------------- 33. pipeline-env
    t_ph = time.perf_counter()
    have = {m_: importlib.util.find_spec(m_) is not None
            for m_ in ("scipy", "h5py")}
    gxx = shutil.which("g++")
    print(f"pipeline-env: scipy {have['scipy']}, h5py {have['h5py']}, g++ "
          f"{gxx}")
    check(have["scipy"], "pipeline-env: scipy is missing (fields and "
          "downsampling need it)")
    so = native._compile()
    check(so.parent == root / "nlsolvers_tpu_torch" / "_build",
          f"native writer built at {so}")
    a = np.random.default_rng(0).standard_normal((3, 64, 64)).astype(
        np.float32)
    with native.AsyncNpyWriter(n_threads=2) as w:
        w.submit(work / "roundtrip.npy", a)
        w.flush()
        errors = w.errors
    back = np.load(work / "roundtrip.npy")
    print(f"pipeline-env: native writer {so.name} built; round trip of a "
          f"{a.shape} float32 array equal {np.array_equal(back, a)}, errors "
          f"{errors}")
    check(errors == 0 and np.array_equal(back, a), "native writer round "
          "trip")
    print(f"pipeline-env: {time.perf_counter() - t_ph:.1f} s")

    # ---------------------------------------------------------- 34. parity-batched
    t_ph = time.perf_counter()
    bat = batched_parity(torch, np, operators)
    print(f"parity-batched 2D: {time.perf_counter() - t_ph:.1f} s")
    bat.update(batched_parity3d(torch, np, operators))
    print(f"parity-batched 3D: {time.perf_counter() - t_ph:.1f} s")
    bat.update(batched_parity_optin(torch, np, operators))
    print(f"parity-batched: {time.perf_counter() - t_ph:.1f} s")

    # ---------------------------------------------------------- 35. datagen-engine
    t_ph = time.perf_counter()
    B = DG_B

    def sample(family, phenomenon, system, batch, seed, dim=2):
        """A batch as Datagen samples it (its samplers, fields and RNG)."""
        cfg = datagen.DatagenConfig(
            family=family, phenomenon=phenomenon, system=system, dim=dim,
            nx=DG_N if dim == 2 else DG3_N, Lx=DG_LX, num_runs=batch,
            anisotropy_type="layered", m_type="piecewise", seed=seed,
            archive_format="npy", output_dir=str(work / f"sample_{family}"))
        _, u0s, v0s, m_, c_ = datagen.Datagen(cfg)._sample_batch(batch)
        return u0s, v0s, m_.astype(np.float32), c_.astype(np.float32)

    u0s, _, m_n, c_n = sample("nlse", "multi_soliton", "cubic", B, 0)
    u0 = np.stack(u0s)
    packed = np.stack([u0.real, u0.imag], axis=1).astype(np.float32)
    fn = engine.make_nlse_trajectory_fn("cubic", shape, DG_LX, DG_DT,
                                        krylov_m=DG_M)
    check(fn.planar and fn.batched, "datagen-engine: the NLSE engine left "
          "the batched planar path")
    zero()
    fn(packed, m_n, c_n, 2, 1)                        # one batched step
    got = counts()
    print(f"datagen-engine NLSE {DG_N}^2 B={B} m={DG_M}: launches per "
          f"batched step {got} ({sum(got.values())} counted, one "
          f"trajectory-step's)")
    check(got == DG_PER_STEP, f"datagen-engine: launches {got} != "
          f"{DG_PER_STEP}")
    per_batched_step = dict(got)
    S_e, f_e = 5, 5                                   # 20 steps
    eng = fn(packed, m_n, c_n, S_e, f_e)
    for b in range(B):
        prob = problems.nlse_problem("cubic", shape, DG_LX, DG_DT,
                                     m_field=m_n[b], c_field=c_n[b],
                                     krylov_m=DG_M, dtype=torch.complex64)
        ref = problems.run(prob, prob.init(packed[b]), S_e, f_e)
        ref = torch.stack([ref.real, ref.imag], dim=1)
        same = bool(torch.equal(eng[b], ref))
        print(f"datagen-engine lane {b}: {(S_e - 1) * f_e} steps of the "
              f"batched step bit-equal to nlse_problem run alone {same} "
              f"(rel-L2 {rel(eng[b, -1], ref[-1]):.3e})")
        check(same, f"datagen-engine lane {b} differs from nlse_problem")
    config.kernel_mode = "off"
    try:
        plain = fn(packed, m_n, c_n, S_e, f_e)
    finally:
        config.kernel_mode = "auto"
    worst = max(rel(eng[b, -1], plain[b, -1]) for b in range(B))
    print(f"datagen-engine: kernels vs kernel_mode off after "
          f"{(S_e - 1) * f_e} steps, max rel-L2 {worst:.3e} (gate 1e-5)")
    check(worst <= 1e-5, f"datagen-engine: kernels vs plain {worst:.3e}")
    check(bool(torch.isfinite(eng).all()), "datagen-engine: non-finite")
    del eng, plain
    # a lane started as NaN: the batched eigh gives it NaN coefficients
    # (torch's eigh would raise), the guard flags it, the others go on
    fg = engine.make_nlse_trajectory_fn("cubic", shape, DG_LX, DG_DT,
                                        krylov_m=DG_M, guard=True)
    nan_in = packed[:3].copy()
    nan_in[1] = np.nan
    gs, gbad = fg(nan_in, m_n[:3], c_n[:3], 3, 5)
    alone = [fn(packed[b:b + 1], m_n[b:b + 1], c_n[b:b + 1], 3, 5)[0]
             for b in (0, 2)]
    same = all(torch.equal(gs[b], a) for b, a in zip((0, 2), alone))
    print(f"datagen-engine NaN lane: bad_at {gbad.tolist()} of 3 snapshots; "
          f"lane 1 all NaN {bool(torch.isnan(gs[1]).all())}; lanes 0 and 2 "
          f"bit-equal to their runs alone {same}")
    check(gbad.tolist() == [3, 0, 3] and bool(torch.isnan(gs[1]).all())
          and same, "datagen-engine: the NaN lane")
    del gs

    def lanes_alone(label, got, alone):
        """Each lane of the engine's output against its problem run alone,
        bit for bit."""
        for b in range(len(alone)):
            ref = alone[b]
            if isinstance(got, tuple):
                same = all(torch.equal(g[b], r) for g, r in zip(got, ref))
                err = float((got[0][b] - ref[0]).abs().max())
            else:
                same = bool(torch.equal(got[b], ref))
                err = float((got[b] - ref).abs().max())
            print(f"datagen-engine {label} lane {b}: 20 steps of the "
                  f"batched step bit-equal to its problem run alone {same} "
                  f"(max |difference| {err:.3e})")
            check(same, f"datagen-engine {label} lane {b} differs from its "
                  f"problem run alone")

    def launches_per_batched_step(label, fn, args, want):
        zero()
        fn(*args, 2, 1)
        got = counts()
        print(f"datagen-engine {label}: launches per batched step {got} "
              f"({sum(got.values())} counted)")
        check(got == want, f"datagen-engine {label}: launches {got} != "
              f"{want}")
        return got

    def nan_lane(label, fg, args):
        """Lane 1 of three started as NaN: bad_at 0 and NaN throughout;
        lanes 0 and 2 bit-equal to their runs alone (B = 1)."""
        bad_args = [a[:3].copy() for a in args]
        bad_args[0][1] = np.nan
        out = fg(*bad_args, 3, 5)
        snaps, gbad = out[0], out[-1]
        alone = [fg(*[a[b:b + 1] for a in args], 3, 5)[0][0]
                 for b in (0, 2)]
        same = all(torch.equal(snaps[b], a) for b, a in zip((0, 2), alone))
        print(f"datagen-engine {label} NaN lane: bad_at {gbad.tolist()} of "
              f"3 snapshots; lane 1 all NaN "
              f"{bool(torch.isnan(snaps[1]).all())}; lanes 0 and 2 "
              f"bit-equal to their runs alone {same}")
        check(gbad.tolist() == [3, 0, 3] and bool(torch.isnan(snaps[1]).all())
              and same, f"datagen-engine {label}: the NaN lane")

    # the real-wave engine (2D sine-Gordon Gautschi) as one batched step
    B = DG_B
    u0r, v0r, m_r, c_r = sample("realwave", "kink_field", "sine_gordon", B,
                                1)
    u0r = np.stack(u0r).astype(np.float32)
    v0r = np.stack(v0r).astype(np.float32)
    fr = engine.make_realwave_trajectory_fn("sine_gordon", shape, DG_LX,
                                            DG_RW_DT, krylov_m=DG_RW_M)
    check(fr.batched, "datagen-engine: the real-wave engine is not batched")
    per_batched_rw = launches_per_batched_step(
        f"sine-Gordon Gautschi {DG_N}^2 B={B} m={DG_RW_M}", fr,
        (u0r, v0r, m_r, c_r), DG_RW_PER_STEP)
    n_rw = 20
    u_s, v_s = fr(u0r, v0r, m_r, c_r, n_rw + 1, 1)
    worst = 0.0
    alone = []
    for b in range(B):
        prob = problems.realwave_problem(
            "sine_gordon", shape, DG_LX, DG_RW_DT, m_field=m_r[b],
            c_field=c_r[b], krylov_m=DG_RW_M, dtype=torch.float32)
        s0 = prob.init(u0r[b], v0r[b])
        alone.append(problems.run(prob, s0, n_rw + 1, 1))
        # each step from the engine's state (u_k, u_{k-1}) under
        # kernel_mode "off" against the engine's next u
        config.kernel_mode = "off"
        try:
            for k in range(1, n_rw + 1):
                s = (u_s[b, k - 1], u_s[b, k - 2] if k >= 2 else s0[1])
                worst = max(worst, rel(u_s[b, k], prob.step(s, k)[0]))
        finally:
            config.kernel_mode = "auto"
    lanes_alone("real-wave 2D", (u_s, v_s), alone)
    print(f"datagen-engine real-wave 2D: each of {n_rw} steps from the "
          f"engine's state vs kernel_mode off, max rel-L2 {worst:.3e} (gate "
          f"1e-5)")
    check(worst <= 1e-5, f"datagen-engine real-wave: per-step rel-L2 "
          f"{worst:.3e}")
    del u_s, v_s, alone
    nan_lane("real-wave 2D", engine.make_realwave_trajectory_fn(
        "sine_gordon", shape, DG_LX, DG_RW_DT, krylov_m=DG_RW_M, guard=True),
        (u0r, v0r, m_r, c_r))

    # the 3D paths at 128^3, m = 10, c(x) per lane: NLSE SS2 and the
    # real-wave Gautschi step, each one batched step
    shape3 = (DG3_N,) * 3
    u3, _, m3, c3 = sample("nlse", "multi_soliton_state", "cubic", B, 2, 3)
    u3 = np.stack(u3)
    p3 = np.stack([u3.real, u3.imag], axis=1).astype(np.float32)
    f3 = engine.make_nlse_trajectory_fn("cubic", shape3, DG_LX, DG_DT,
                                        krylov_m=DG3_M)
    check(f3.planar and f3.batched, "datagen-engine: the 3D NLSE engine is "
          "not batched")
    per_batched_3d = launches_per_batched_step(
        f"NLSE SS2 {DG3_N}^3 B={B} m={DG3_M}", f3, (p3, m3, c3),
        DG3_PER_STEP)
    got3 = f3(p3, m3, c3, 5, 5)
    alone = []
    for b in range(B):
        prob = problems.nlse_problem("cubic", shape3, DG_LX, DG_DT,
                                     m_field=m3[b], c_field=c3[b],
                                     krylov_m=DG3_M, dtype=torch.complex64)
        ref = problems.run(prob, prob.init(p3[b]), 5, 5)
        alone.append(torch.stack([ref.real, ref.imag], dim=1))
    lanes_alone("NLSE 3D", got3, alone)
    check(bool(torch.isfinite(got3).all()), "datagen-engine NLSE 3D: "
          "non-finite")
    del got3, alone
    nan_lane("NLSE 3D", engine.make_nlse_trajectory_fn(
        "cubic", shape3, DG_LX, DG_DT, krylov_m=DG3_M, guard=True),
        (p3, m3, c3))
    u3r, v3r, m3r, c3r = sample("realwave", "kink_field", "klein_gordon", B,
                                3, 3)
    u3r = np.stack(u3r).astype(np.float32)
    v3r = np.stack(v3r).astype(np.float32)
    f3r = engine.make_realwave_trajectory_fn("klein_gordon", shape3, DG_LX,
                                             DG_RW_DT, krylov_m=DG3_M)
    check(f3r.batched, "datagen-engine: the 3D real-wave engine is not "
          "batched")
    per_batched_rw3 = launches_per_batched_step(
        f"Klein-Gordon Gautschi {DG3_N}^3 B={B} m={DG3_M}", f3r,
        (u3r, v3r, m3r, c3r), DG3_RW_PER_STEP)
    got3r = f3r(u3r, v3r, m3r, c3r, 5, 5)
    alone = []
    for b in range(B):
        prob = problems.realwave_problem(
            "klein_gordon", shape3, DG_LX, DG_RW_DT, m_field=m3r[b],
            c_field=c3r[b], krylov_m=DG3_M, dtype=torch.float32)
        alone.append(problems.run(prob, prob.init(u3r[b], v3r[b]), 5, 5))
    lanes_alone("real-wave 3D", got3r, alone)
    check(all(bool(torch.isfinite(x).all()) for x in got3r),
          "datagen-engine real-wave 3D: non-finite")
    del got3r, alone
    nan_lane("real-wave 3D", engine.make_realwave_trajectory_fn(
        "klein_gordon", shape3, DG_LX, DG_RW_DT, krylov_m=DG3_M, guard=True),
        (u3r, v3r, m3r, c3r))
    torch.cuda.empty_cache()

    def lanes_of(family, shp, dt, mk, args, use_c=True, **kw):
        """Each lane's problem run alone for 20 steps (5 snapshots, 5 steps
        apart), as the engine returns it."""
        out = []
        for b in range(B):
            c_b = args[-1][b] if use_c else None
            if family == "nlse":
                prob = problems.nlse_problem(
                    "cubic", shp, DG_LX, dt, m_field=args[1][b],
                    c_field=c_b, krylov_m=mk, dtype=torch.complex64, **kw)
                ref = problems.run(prob, prob.init(args[0][b]), 5, 5)
                out.append(torch.stack([ref.real, ref.imag], dim=1))
            else:
                prob = problems.realwave_problem(
                    "sine_gordon" if len(shp) == 2 else "klein_gordon", shp,
                    DG_LX, dt, m_field=args[2][b], c_field=c_b,
                    krylov_m=mk, dtype=torch.float32)
                out.append(problems.run(prob, prob.init(args[0][b],
                                                        args[1][b]), 5, 5))
        return out

    # the two-step NLSE integrators (sEWI, fused sEWI, Gautschi) as one
    # batched step, 2D (256^2, m = 20) and 3D (128^3, m = 10), c(x) per
    # lane: step 1 is the batched SS2 bootstrap, every later step the
    # batched two-step step (3 or 2 matrix functions) and its ghost copy
    for integ, k in (("sewi", 3), ("sewi_fused", 2), ("gautschi", 3)):
        for label, shp, args, mk, boot, want in (
                (f"{integ} {DG_N}^2", shape, (packed, m_n, c_n), DG_M,
                 DG_PER_STEP, {"K1'": k, "K2'": k * (DG_M - 1), "K3": k,
                               "recur": k * DG_M}),
                (f"{integ} {DG3_N}^3", shape3, (p3, m3, c3), DG3_M,
                 DG3_PER_STEP, {"pass1_3d": k * (DG3_M - 1),
                                "pass2": k * DG3_M, "K3": k, "bc3d": 1})):
            ft = engine.make_nlse_trajectory_fn("cubic", shp, DG_LX, DG_DT,
                                                krylov_m=mk, integrator=integ)
            check(ft.planar and ft.batched, f"datagen-engine {label}: not "
                  f"one batched planar step")
            launches_per_batched_step(f"{label} bootstrap", ft, args, boot)
            zero()
            ft(*args, 2, 2)
            got = counts()
            got2 = {k_: got.get(k_, 0) - boot.get(k_, 0)
                    for k_ in set(got) | set(boot)
                    if got.get(k_, 0) != boot.get(k_, 0)}
            print(f"datagen-engine {label} B={B}: launches per batched "
                  f"two-step step {got2} ({sum(got2.values())} counted)")
            check(got2 == want, f"datagen-engine {label}: launches {got2} "
                  f"!= {want}")
            eng = ft(*args, 5, 5)
            check(bool(torch.isfinite(eng).all()), f"datagen-engine {label}:"
                  f" non-finite")
            lanes_alone(label, eng, lanes_of("nlse", shp, DG_DT, mk, args,
                                             integrator=integ))
            del eng
            nan_lane(label, engine.make_nlse_trajectory_fn(
                "cubic", shp, DG_LX, DG_DT, krylov_m=mk, integrator=integ,
                guard=True), args)
    torch.cuda.empty_cache()

    # the batched SS2 and real-wave Gautschi engines under the opt-in
    # switches: one batched K5 per iteration (fused_iter; 3D on the iso
    # operator, the only 3D one K5 takes) or K8 (pipeline_3d), each loop's
    # start norm one pass2
    from nlsolvers_tpu_torch.utils import interop
    per_sw = {}
    for label, sw, family, shp, args, dt, mk, use_c, want in (
            (f"SS2 fused_iter {DG_N}^2 c(x)", {"fused_iter": True}, "nlse",
             shape, (packed, m_n, c_n), DG_DT, DG_M, True,
             {"K5": DG_M - 1, "pass2": 1, "K3": 1, "kick_bc": 2}),
            (f"SS2 fused_iter {DG3_N}^3 iso", {"fused_iter": True}, "nlse",
             shape3, (p3, m3, c3), DG_DT, DG3_M, False,
             {"K5": DG3_M - 1, "pass2": 1, "K3": 1, "kick_bc": 2}),
            (f"SS2 pipeline_3d {DG3_N}^3 c(x)", {"pipeline_3d": True},
             "nlse", shape3, (p3, m3, c3), DG_DT, DG3_M, True,
             {"pass2": 1, "pass1_3d": 1, "K8": DG3_M - 2, "K2": 1, "K3": 1,
              "kick_bc": 2}),
            (f"sine-Gordon Gautschi fused_iter {DG_N}^2 c(x)",
             {"fused_iter": True}, "realwave", shape, (u0r, v0r, m_r, c_r),
             DG_RW_DT, DG_RW_M, True,
             {"K5": 2 * (DG_RW_M - 1), "pass2": 2, "K3": 2}),
            (f"Klein-Gordon Gautschi pipeline_3d {DG3_N}^3 c(x)",
             {"pipeline_3d": True}, "realwave", shape3,
             (u3r, v3r, m3r, c3r), DG_RW_DT, DG3_M, True,
             {"pass2": 2, "pass1_3d": 2, "K8": 2 * (DG3_M - 2), "K2": 2,
              "K3": 2, "bc3d": 1})):
        old_sw = interop.set_switches(**sw)
        try:
            if family == "nlse":
                def make(**kw):
                    return engine.make_nlse_trajectory_fn(
                        "cubic", shp, DG_LX, dt, krylov_m=mk, use_c=use_c,
                        **kw)
            else:
                def make(**kw):
                    return engine.make_realwave_trajectory_fn(
                        "sine_gordon" if len(shp) == 2 else "klein_gordon",
                        shp, DG_LX, dt, krylov_m=mk, use_c=use_c, **kw)
            fs = make()
            check(fs.batched, f"datagen-engine {label}: not batched")
            per_sw[label] = launches_per_batched_step(f"{label} B={B}", fs,
                                                      args, want)
            lanes_alone(label, fs(*args, 5, 5),
                        lanes_of(family, shp, dt, mk, args, use_c))
            nan_lane(label, make(guard=True), args)
        finally:
            interop.set_switches(**old_sw)
    del u3r, v3r, p3
    torch.cuda.empty_cache()

    # one diverging lane: phi-4 (focusing) Gautschi, lane 1 at 1e3 times
    # lane 0's amplitude, dt = 0.05
    S_d, f_d = 6, 2
    x = np.linspace(-DG_LX, DG_LX, DG_N)
    env = np.exp(-(x[:, None] ** 2 + x[None, :] ** 2) / 2.0)
    u_d = np.stack([0.5 * env, 500.0 * env]).astype(np.float32)
    fd = engine.make_realwave_trajectory_fn("phi4", shape, DG_LX, 0.05,
                                            krylov_m=DG_RW_M, guard=True)
    ud, vd, bad = fd(u_d, np.zeros_like(u_d), m_r[:2], c_r[:2], S_d, f_d)
    u1, v1, bad1 = fd(u_d[:1], np.zeros_like(u_d[:1]), m_r[:1], c_r[:1],
                      S_d, f_d)
    bad = bad.tolist()
    same = bool(torch.equal(ud[0], u1[0]) and torch.equal(vd[0], v1[0]))
    print(f"datagen-engine diverging lane (phi-4 Gautschi, x1e3): bad_at "
          f"{bad} of {S_d} snapshots; the other lane finite "
          f"{bool(torch.isfinite(ud[0]).all())} and bit-equal to its run "
          f"alone {same}")
    check(bad[0] == S_d and bad[1] < S_d and bad1.tolist() == [S_d],
          f"datagen-engine: bad_at {bad}")
    check(bool(torch.isfinite(ud[0]).all() & torch.isfinite(vd[0]).all())
          and same, "datagen-engine: the finite lane changed")
    del ud, vd, u1, v1
    torch.cuda.empty_cache()
    print(f"datagen-engine: {time.perf_counter() - t_ph:.1f} s")

    # ---------------------------------------------------------- 36. datagen-main
    t_ph = time.perf_counter()
    runs = 8
    nlse_args = ["nlse", "--phenomenon", "multi_soliton", "--system",
                 "cubic", "--nx", str(DG_N), "--T", "0.12", "--nt", "200",
                 "--snapshots", "20", "--num-runs", str(runs),
                 "--batch-size", str(runs), "--anisotropy-type", "layered",
                 "--m-type", "piecewise", "--record-energy"]
    rw_args = ["realwave", "--phenomenon", "kink_field", "--system",
               "sine_gordon", "--nx", str(DG_N), "--T", "0.6", "--nt", "200",
               "--snapshots", "20", "--num-runs", str(runs), "--batch-size",
               str(runs)]

    def cli(*jobs):
        """The CLI sweeps `jobs` [(args, fmt, out)] as subprocesses started
        together, each writing its output to a file; the sweep wall of each
        from its own summary line. A sweep that outlives 900 s is killed."""
        procs = []
        for args, fmt, out in jobs:
            cmd = [sys.executable, "-m", "nlsolvers_tpu_torch.pipeline"] + \
                args + ["--format", fmt, "--output-dir", str(work / out)]
            log = open(work / f"{out}.log", "w")
            procs.append((args, fmt, out, log, time.perf_counter(),
                          subprocess.Popen(cmd, cwd=root, stdout=log,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
        walls = []
        for args, fmt, out, log, t0, proc in procs:
            try:
                rc = proc.wait(timeout=900)
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait()
            log.close()
            text = (work / f"{out}.log").read_text()
            tail = [ln for ln in text.strip().splitlines()
                    if "sweep summary" in ln or ln.startswith("wrote")]
            print(f"datagen-main {out} ({args[0]}, --format {fmt}): exit "
                  f"{rc} in {time.perf_counter() - t0:.1f} s (process "
                  f"included); " + " | ".join(tail))
            check(rc == 0, f"datagen-main {args[0]} {fmt}: exit {rc}: "
                  f"{text.strip()[-2000:]}")
            summ = [ln for ln in text.splitlines()
                    if ln.startswith("sweep summary")]
            check(len(summ) == 1, f"datagen-main {args[0]}: no sweep "
                  f"summary")
            walls.append(float(re.search(r"max ([0-9.]+)s",
                                         summ[0]).group(1)))
        return walls

    def npy_runs(out):
        return sorted((work / out / "npy").glob("run_*.json"))

    def nlse_sweep(out):
        """The sweep's runs: (u, recorded mass series, relative drift, max
        |u0| on the boundary ring) each, after the shape, finite and series
        gates."""
        metas = npy_runs(out)
        check(len(metas) == runs, f"datagen-main nlse {out}: {len(metas)} "
              f"runs archived")
        dx2 = (2.0 * DG_LX / (DG_N - 1)) ** 2
        res = []
        for p in metas:
            u = np.load(p.with_name(p.stem + "_u.npy"))
            mass = np.load(p.with_name(p.stem + "_mass.npy"))
            check(u.shape == (20, DG_N, DG_N) and np.isfinite(u).all(),
                  f"datagen-main nlse {p.name}: {u.shape}, finite "
                  f"{np.isfinite(u).all()}")
            # the series recorded on the device is the mass of the archived
            # snapshots (tests/test_datagen.py:475-500 holds JAX's so)
            host = np.sum(np.abs(u) ** 2, axis=(1, 2)) * dx2
            check(np.allclose(mass, host, rtol=1e-5), f"datagen-main nlse "
                  f"{p.name}: recorded mass {mass[:3]} != host {host[:3]}")
            ring = np.concatenate([u[0, [0, -1]].ravel(),
                                   u[0, :, [0, -1]].ravel()])
            res.append((u, float(np.max(np.abs(mass - mass[0])) / mass[0]),
                        float(np.abs(ring).max())))
        return res

    # the NLSE sweep alone (rate-datagen reads its wall), then the rest
    # together
    nlse_wall, = cli((nlse_args, "npy", "nlse_npy"))
    later = [(nlse_args + ["--bc", "none"], "npy", "nlse_npy_nobc"),
             (rw_args, "npy", "rw_npy")]
    if have["h5py"]:
        later.append((nlse_args, "hdf5", "nlse_h5"))
    cli(*later)
    swept = nlse_sweep("nlse_npy")
    u_npy = [u for u, _, _ in swept]
    print(f"datagen-main nlse: {runs} runs archived, finite, recorded mass "
          f"= the archived snapshots' (rtol 1e-5); relative mass drift per "
          f"run over {19 * 10} steps with the no-flux ghost copy (printed, "
          f"not gated: the copy does not conserve mass where the field "
          f"touches the boundary, in JAX's engine alike): "
          + ", ".join(f"{d:.2e} (|u0| on the edge {r:.2f})"
                      for _, d, r in swept))
    drifts = [d for _, d, _ in nlse_sweep("nlse_npy_nobc")]
    print(f"datagen-main nlse --bc none (the same draws, no ghost copy): "
          f"relative mass drift per run max {max(drifts):.3e} (gate 1e-3): "
          f"{', '.join(f'{d:.2e}' for d in drifts)}")
    check(max(drifts) < 1e-3, f"datagen-main nlse --bc none: mass drift "
          f"{max(drifts):.3e}")
    metas = npy_runs("rw_npy")
    check(len(metas) == runs, f"datagen-main realwave: {len(metas)} runs")
    for p in metas:
        for sfx in ("u", "v"):
            arr = np.load(p.with_name(f"{p.stem}_{sfx}.npy"))
            check(arr.shape == (20, DG_N, DG_N) and np.isfinite(arr).all(),
                  f"datagen-main realwave {p.name} {sfx}: not finite")
    print(f"datagen-main realwave: {runs} runs archived, u and v finite")
    if have["h5py"]:
        from nlsolvers_tpu_torch.pipeline import io_hdf5
        h5s = sorted((work / "nlse_h5" / "hdf5").glob("run_*.h5"))
        check(len(h5s) == runs, f"datagen-main hdf5: {len(h5s)} runs")
        same = all(np.array_equal(io_hdf5.load_run(p)["u"], u)
                   for p, u in zip(h5s, u_npy))
        print(f"datagen-main nlse --format hdf5: {runs} runs archived, "
              f"trajectories bit-equal to the npy sweep's {same}")
        check(same, "datagen-main: hdf5 and npy sweeps differ")
    else:
        print("datagen-main --format hdf5: not run, h5py is not installed "
              "on this machine (the npy format needs no h5py)")
    del u_npy
    print(f"datagen-main: {time.perf_counter() - t_ph:.1f} s")

    # ---------------------------------------------------------- 37. rate-datagen
    t_ph = time.perf_counter()
    steps_run = 19 * (200 // 20)          # (snapshots - 1) * snapshot_freq
    print(f"rate-datagen nlse CLI sweep ({runs} runs of {steps_run} steps, "
          f"{DG_N}^2 m={DG_M}, sweep wall {nlse_wall:.3f} s incl. sampling "
          f"and archive): {runs / nlse_wall * 60:.2f} trajectories/min, "
          f"{runs * steps_run / nlse_wall:.1f} trajectory-steps/s")
    cfg = datagen.DatagenConfig(
        family="nlse", phenomenon="multi_soliton", system="cubic", nx=DG_N,
        Lx=DG_LX, T=0.12, nt=200, snapshots=20, num_runs=runs,
        batch_size=runs, anisotropy_type="layered", m_type="piecewise",
        record_energy=True, archive_format="npy",
        output_dir=str(work / "rate"))
    dg = datagen.Datagen(cfg)
    _, u0s, _, m_b, c_b = dg._sample_batch(runs)
    u0 = np.stack(u0s)
    packed = np.stack([u0.real, u0.imag], axis=1).astype(np.float32)
    m_b, c_b = m_b.astype(np.float32), c_b.astype(np.float32)
    n_b = 10
    dg.traj_fn(packed, m_b, c_b, 2, 1)                  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dg.traj_fn(packed, m_b, c_b, 2, n_b)
    torch.cuda.synchronize()
    wall_step = (time.perf_counter() - t0) / n_b
    n_p = 5
    rows = profiled(torch, lambda: dg.traj_fn(packed, m_b, c_b, 2, n_p))
    if rows is None:
        print("rate-datagen: device busy time not measured (no trace)")
    else:
        busy = sum(dev_us(e) for e in rows) / 1e3 / n_p
        launched = sum(e.count for e in rows if dev_us(e) > 0) / n_p
        print(f"rate-datagen: batched step (B={runs}) {wall_step * 1e3:.3f} "
              f"ms wall, device busy {busy:.4f} ms -> idle share "
              f"{1 - busy / (wall_step * 1e3):.3f}; {launched:.1f} kernel "
              f"launches per batched step (all kernels, "
              f"{sum(DG_PER_STEP.values())} of them counted ones), "
              f"{launched / runs:.2f} per trajectory-step")
        for e in sorted(rows, key=dev_us, reverse=True)[:8]:
            print(f"  {dev_us(e) / 1e3 / n_p:9.4f} ms/batched step "
                  f"{e.count // n_p:4d}x {e.key[:70]}")
    syncs = host_syncs(torch, lambda: dg.traj_fn(packed, m_b, c_b, 2, 1))
    on_card = [torch.from_numpy(a).to("cuda") for a in (packed, m_b, c_b)]
    s1, s5 = (host_syncs(torch, lambda k=k: dg.traj_fn(*on_card, 2, k))
              for k in (1, 5))
    print(f"rate-datagen: host syncs of a call of one batched step: {syncs} "
          f"(inputs uploaded), {s1} (inputs on the card); per batched step "
          f"(1 against 5 steps) {(s5 - s1) / 4:.2f}, "
          f"{(s5 - s1) / 4 / runs:.3f} per trajectory-step")
    del dg
    torch.cuda.empty_cache()
    datagen_rates(torch, np, datagen, work)
    shutil.rmtree(work, ignore_errors=True)
    print(f"rate-datagen: {time.perf_counter() - t_ph:.1f} s")
    per_step = {"nlse 2D": per_batched_step, "realwave 2D": per_batched_rw,
                "nlse 3D": per_batched_3d, "realwave 3D": per_batched_rw3,
                "nlse 2D fused_iter": per_sw[f"SS2 fused_iter {DG_N}^2 c(x)"],
                "nlse 3D pipeline_3d":
                    per_sw[f"SS2 pipeline_3d {DG3_N}^3 c(x)"]}
    return per_step, bat



# the grid-sharded datagen points (JAX's Datagen docstring: "single runs too
# large for one chip (1024^2/256^3 configs)"): the 2D NLSE sweep's physics
# (Lx = 10, dt = 1.2/2000, m = 20, c layered, m piecewise) at 1024^2 on a
# (2, 2) mesh, sine-Gordon Gautschi (dt = 0.6/200, m = 10) at 1024^2 on
# (2, 2), and the 3D cubic NLSE c(x) (m = 10, the 3D datagen dt 0.048/80) at
# 256^3 on (1, 1, 4) (the reference variant needs z and y whole); B = 2
# lanes, every shard on this card
SH_N, SH_N3, SH_B = 1024, 256, 2
SH_MESH2, SH_MESH3 = (2, 2), (1, 1, 4)
SH_DT3 = 0.048 / 80


def shard_lane_descs(torch, kind, lshape, mshape, scale, B, gen, P=2):
    """[(batched descriptor, [each lane's descriptor])] for every shard of an
    mshape mesh of lshape blocks: the shard kernels' descriptors, face
    weights in [1, 1.4) per lane (aniso), sign -1 with P=1. Under the 3D
    reference variant z and y are whole."""
    import numpy as np
    dev = torch.device("cuda", 0)
    nd = len(lshape)
    R = math.prod(lshape[:-1])
    glob = tuple(a * b for a, b in zip(mshape, lshape))
    aniso = kind.endswith("aniso")
    if nd == 2:
        wsh = (("wx", lshape), ("wy", lshape), ("wxl", lshape[:1]),
               ("wyh", lshape[1:]))
    else:
        wsh = (("wx", (R, lshape[2])), ("wy", (R, lshape[2])),
               ("wz", (R, lshape[2])), ("wxl", (R,)),
               ("wyh", (lshape[0], lshape[2])), ("wzh", lshape[1:]))
    out = []
    for k in range(math.prod(mshape)):
        pos = [int(c) for c in np.unravel_index(k, mshape)]
        d = dict(kind=kind, scale=scale, sign=-1.0 if P == 1 else 1.0,
                 variant="reference" if not aniso else "aniso",
                 **dict(zip(("NZ", "NY", "NX")[-nd:], glob)),
                 **dict(zip(("z0", "y0", "x0")[-nd:],
                            (p * n for p, n in zip(pos, lshape)))))
        if nd == 3:
            d.update(lnz=lshape[0], lny=lshape[1])
        if aniso:
            d.update({key: 1.0 + 0.4 * torch.rand(
                (B,) + shp, generator=gen, device=dev) for key, shp in wsh})
        lanes = [dict(d, **{key: d[key][b] for key, _ in wsh}) if aniso
                 else d for b in range(B)]
        out.append((d, lanes))
    return out


def shard_halos(torch, lshape, P, B, gen):
    """Random halos of B lanes of a block: (yh, xh) in 2D, (yh, zh, xh) in
    3D, each with a leading B."""
    dev = torch.device("cuda", 0)
    if len(lshape) == 2:
        ny, nx = lshape
        shapes = ((P, 2, nx), (P, 2, ny))
    else:
        nz, ny, nx = lshape
        shapes = ((P, 2, nz, nx), (P, 2, ny, nx), (P, 2, nz * ny))
    return [torch.randn((B,) + s, generator=gen, device=dev) for s in shapes]


def batched_parity_shard(torch, np):
    """Phase 38: the batched forms of pass1_shard2d and pass1_shard3d (K1'
    shard2d / shard2d_aniso, K9-K12 and K1' shard3d / shard3d_aniso under
    JAX's vmap of the sharded step) at the grid-sharded datagen points: B =
    2 lanes of the local 512^2 block of 1024^2 on (2, 2) (P = 2, c(x) per
    lane, j = 0, 9, 18; the iso reference operator j = 0) and of the local
    (256, 256, 64) block of 256^3 on (1, 1, 4) (c(x) and iso reference,
    j = 0, 8), ragged real batches (3 x 250x333 and 3 x 20x30x50, sign -1:
    the P = 1 forms) and 2 x 2(x2) blocks: ONE launch each, against the
    plain batched versions (fields rel-L2 <= 1e-5, dots <= 1e-4 of the
    Cauchy-Schwarz scale), bit-equal to B unbatched launches lane by lane,
    and two launches bit for bit. Then the shard kernels of one batched
    sharded Lanczos run of the datagen-shard paths (every shard, j = 0..m-2,
    the loop's scalars [1/chat, 0]) by CUDA-graph replay beside the B lanes'
    unbatched launch sequences, the profiler and the events, the plain
    batched versions and the bytes bound. Returns {kernel: readings}."""
    from nlsolvers_tpu_torch.ops.cuda import lanczos2d as lz
    from nlsolvers_tpu_torch.ops.cuda import lanczos3d as l3

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2468)
    errs = {"pass1_shard2d": 0.0, "pass1_shard3d": 0.0}
    scale2 = ((SH_N - 1) / (2 * DG_LX)) ** 2
    scale3 = ((SH_N3 - 1) / (2 * DG_LX)) ** 2

    def cols(lshape, P, B, n):
        rows = math.prod(lshape[:-1])
        return [torch.randn((B, P, rows, lshape[-1]), generator=gen,
                            device=dev) for _ in range(n)]

    def one(label, key, kern, d, lanes, hs, W, j):
        B = W[0].shape[0]
        scal = 0.2 + 0.8 * torch.rand((B, 1, 2), generator=gen, device=dev)
        got = kern(scal, W[j], W[:j], *hs, d)
        want = plain(lambda: kern(scal, W[j], W[:j], *hs, d))
        again = kern(scal, W[j], W[:j], *hs, d)
        alone = [kern(scal[b], W[j][b], [w[b] for w in W[:j]],
                      *[h[b] for h in hs], lanes[b]) for b in range(B)]
        torch.cuda.synchronize()
        fe = max(rel(got[0][b], want[0][b]) for b in range(B))
        de = max(dot_err(got[1][b], want[1][b], [w[b] for w in W[:j + 1]],
                         want[0][b]) for b in range(B))
        same = all(torch.equal(x[b], y) for b, a in enumerate(alone)
                   for x, y in zip(got, a))
        rep = all(torch.equal(x, y) for x, y in zip(got, again))
        errs[key] = max(errs[key], float((got[0] - want[0]).abs().max()))
        print(f"parity-batched-shard {label}: field rel-L2 {fe:.3e}, dot err "
              f"{de:.3e}, bit-equal to {B} unbatched launches {same}, two "
              f"launches bit for bit {rep}")
        check(fe <= FIELD_TOL, f"{label}: field rel-L2 {fe:.3e}")
        check(de <= DOT_TOL, f"{label}: dot error {de:.3e}")
        check(same, f"{label}: a lane differs from its unbatched launch")
        check(rep, f"{label}: two launches differ")

    L2 = SH_N // SH_MESH2[1]
    b3 = (SH_N3, SH_N3, SH_N3 // SH_MESH3[2])
    cases = []
    for kind, lshape, mshape, scale, P, B, js in (
            ("shard2d_aniso", (L2, L2), SH_MESH2, scale2, 2, SH_B,
             (0, 9, 18)),
            ("shard2d", (L2, L2), SH_MESH2, scale2, 2, SH_B, (0,)),
            ("shard2d_aniso", (250, 333), (2, 2), scale2, 1, 3, (4,)),
            ("shard2d", (2, 2), (3, 3), scale2, 2, 3, (4,)),
            ("shard3d_aniso", b3, SH_MESH3, scale3, 2, SH_B, (0, 8)),
            ("shard3d", b3, SH_MESH3, scale3, 2, SH_B, (0,)),
            ("shard3d_aniso", (20, 30, 50), (2, 2, 2), scale3, 1, 3, (4,)),
            ("shard3d", (2, 2, 2), (1, 1, 3), scale3, 2, 3, (4,))):
        key = "pass1_shard2d" if len(lshape) == 2 else "pass1_shard3d"
        kern = lz.pass1_shard2d if len(lshape) == 2 else l3.pass1_shard3d
        # the last shard of the mesh: its place shows in the offsets
        d, lanes = shard_lane_descs(torch, kind, lshape, mshape, scale, B,
                                    gen, P)[-1]
        hs = shard_halos(torch, lshape, P, B, gen)
        W = cols(lshape, P, B, max(js) + 1)
        tag = "x".join(map(str, lshape))
        for j in js:
            one(f"{kind} {tag} P={P} B={B} j={j}", key, kern, d, lanes, hs,
                W, j)
        del W, hs
        cases.append(kind)
    torch.cuda.empty_cache()

    # the bricks of pass1_shard3d (lanczos3d.shard3d_tiles) against the
    # library's count of partial rows and bytes of shared memory (a tree
    # older than the brick kernel, timed by time_kernels.py, has neither)
    lib3 = l3._lib()
    for shp in ((b3, (SH_N3,) * 3, (20, 30, 50), (2, 2, 2))
                if hasattr(l3, "shard3d_tiles") else ()):
        for aniso in (False, True):
            for vec in (0, 1):
                t = l3.shard3d_tiles(*shp, 2, aniso, vec)
                blocks = lib3.lz3_shard_blocks(*shp, t["nxt"], t["tyt"],
                                               t["pz"])
                smem = lib3.lz3_shard_smem(2, 2 if aniso else 0, vec,
                                           t["nxt"], t["tyt"])
                check(blocks == t["blocks"] and smem == t["smem"],
                      f"shard3d_tiles {shp} aniso={aniso} vec={vec}: "
                      f"{t} against the library's {blocks} bricks, {smem} "
                      f"bytes")
        t = l3.shard3d_tiles(*shp, 2, True, shp[-1] % 4 == 0)
        print(f"parity-batched-shard pass1_shard3d bricks of "
              f"{'x'.join(map(str, shp))}: {t['nxt']} columns x {t['tyt']} "
              f"rows x {t['pz']} planes, {t['threads']} threads, "
              f"{t['blocks']} per lane, ring {t['smem']} bytes (c(x), P=2)")

    # one batched sharded Lanczos run's shard kernels (P = 2): c(x), and the
    # iso reference operator of the 3D datagen-shard point
    out = {}
    for key, kern, kind, lshape, mshape, scale, m in (
            ("pass1_shard2d", lz.pass1_shard2d, "shard2d_aniso", (L2, L2),
             SH_MESH2, scale2, DG_M),
            ("pass1_shard3d", l3.pass1_shard3d, "shard3d_aniso", b3,
             SH_MESH3, scale3, DG3_M),
            ("pass1_shard3d iso", l3.pass1_shard3d, "shard3d", b3,
             SH_MESH3, scale3, DG3_M)):
        B = SH_B
        descs = shard_lane_descs(torch, kind, lshape, mshape, scale, B, gen)
        hs = [shard_halos(torch, lshape, 2, B, gen) for _ in descs]
        Ws = [cols(lshape, 2, B, m - 1) for _ in descs]
        s = torch.tensor([[0.5, 0.0]], device=dev).expand(B, 1, 2)
        s = s.contiguous()

        def run(Ws=Ws, hs=hs, descs=descs, kern=kern, m=m, s=s):
            for W, h, (d, _) in zip(Ws, hs, descs):
                for j in range(m - 1):
                    kern(s, W[j], W[:j], *h, d)

        def lanes(Ws=Ws, hs=hs, descs=descs, kern=kern, m=m, s=s, B=B):
            for b in range(B):
                for W, h, (_, ld) in zip(Ws, hs, descs):
                    for j in range(m - 1):
                        kern(s[b], W[j][b], [w[b] for w in W[:j]],
                             *[x[b] for x in h], ld[b])

        g = graph_ms(torch, run, 10)
        g_lanes = graph_ms(torch, lanes, 5)
        prof, events = times_ms(torch, run, 5)
        plain_ms = plain(lambda: times_ms(torch, run, 2))[0]
        col = 2 * math.prod(lshape) * 4
        nsh = len(descs)
        halo = sum(x[0].numel() for x in hs[0]) * 4
        wts = sum(descs[0][0][k][0].numel() for k in descs[0][0]
                  if k.startswith("w")) * 4
        nbytes = B * nsh * sum((j + 2) * col + halo + wts
                               for j in range(m - 1))
        launches = nsh * (m - 1)
        out[key] = dict(err=errs[key.split()[0]], graph=g,
                        lanes_graph=g_lanes, t=(prof, events, plain_ms),
                        nbytes=nbytes, lib=None, launches=launches)
        tag = "x".join(map(str, lshape))
        op = "c(x)" if kind.endswith("aniso") else "iso"
        print(f"parity-batched-shard {key} B={B} local {tag} on {mshape} "
              f"m={m} {op}: graph {g:.4f} ms per batched run ({launches} "
              f"launches), {B} unbatched launch sequences {g_lanes:.4f} ms "
              f"({g_lanes / g:.2f}x); profiler {prof:.4f}, events "
              f"{events:.4f}; plain batched {plain_ms:.4f}; bound "
              f"{bound_ms(nbytes):.4f} ms ({nbytes / 1e6:.1f} MB) -> "
              f"{bound_ms(nbytes) / g:.3f} of it")
        del Ws, hs, descs
        torch.cuda.empty_cache()
    return out


def shard_datagen(torch, np, root, counters):
    """Phase 39: the grid-sharded datagen engines
    (parallel/spatial.make_sharded_*_trajectory_fn, as Datagen runs them
    under shard_grid) at full width on this card, B = 2 lanes stepped as ONE
    batched sharded step: 2D cubic NLSE c(x) 1024^2 m = 20 on (2, 2) with
    SS2 and sEWI (the draws of Datagen's samplers: multi_soliton, c layered,
    m piecewise), 2D sine-Gordon Gautschi float32 1024^2 m = 10 on (2, 2)
    (kink_field draws), 3D cubic NLSE c(x) 256^3 m = 10 on (1, 1, 4) (the
    reference variant; a seeded Gaussian per lane, c = 1 + 0.4 U[0, 1)).
    Per path, every launch counter set to 0 just before the batched run and
    read just after: exactly the shard kernels' launches per batched step
    (per shard m-1 shard pass1, m pass2 with the start norm, 1 K3 and 2
    kick_bc per SS2 matrix function step; three matrix functions per sEWI
    step after the SS2 bootstrap; two per Gautschi step) and no unsharded
    kernel; finite snapshots; each lane within 2e-4 rel-L2 of the unsharded
    engine on the same draws (pipeline/engine.py); each lane bit-equal to
    the same lane stepped alone (the unbatched make_sharded_nlse_step for
    SS2, the engine on one lane otherwise). Returns {path: {kernel: launches
    per batched step}}."""
    import shutil

    from nlsolvers_tpu_torch.parallel import mesh as pmesh
    from nlsolvers_tpu_torch.parallel import shards, spatial
    from nlsolvers_tpu_torch.pipeline import datagen, engine

    dev = torch.device("cuda", 0)
    work = root / "_smoke_datagen"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    per_step = {}

    def draws(family, phenomenon, system, n):
        cfg = datagen.DatagenConfig(
            family=family, phenomenon=phenomenon, system=system, nx=n,
            num_runs=SH_B, anisotropy_type="layered", m_type="piecewise",
            output_dir=str(work), archive_format="npy", device="cuda")
        dg = datagen.Datagen(cfg)
        _, u0s, v0s, m, c = dg._sample_batch(SH_B)
        return u0s, v0s, m.astype(np.float32), c.astype(np.float32)

    def drive(label, traj, args, snaps, freq, want, n_sh, first_step=None):
        """The batched run with the counters at 0 just before and read just
        after: want per batched step (first_step: the bootstrap's)."""
        torch.cuda.synchronize()
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        out = traj(*args, snaps, freq)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: f.launches for k, f in counters.items() if f.launches}
        steps = (snaps - 1) * freq
        first = want if first_step is None else first_step
        exp = {k: n_sh * (first.get(k, 0) + (steps - 1) * want.get(k, 0))
               for k in set(want) | set(first)}
        exp = {k: v for k, v in exp.items() if v}
        print(f"datagen-shard {label}: {steps} batched steps of B={SH_B} in "
              f"{wall:.3f} s ({wall / steps * 1e3:.1f} ms per batched step, "
              f"snapshots included); launches {got} "
              f"({sum(got.values()) / steps:.0f} counted per batched step)")
        check(got == exp, f"datagen-shard {label}: launches {got} != {exp}")
        per_step[label] = {k: v // steps for k, v in got.items()}
        return out

    def lanes_close(label, got, want):
        for b in range(SH_B):
            for x, y in zip(got, want):
                check(bool(torch.isfinite(x[b]).all()),
                      f"datagen-shard {label}: lane {b} not finite")
                e = rel(x[b, -1], y[b, -1])
                print(f"datagen-shard {label}: lane {b} last snapshot vs the "
                      f"unsharded engine rel-L2 {e:.3e}")
                check(e <= 2e-4, f"datagen-shard {label}: lane {b} {e:.3e}")

    def lanes_alone(label, got, alone):
        same = all(torch.equal(x[b], y) for b, ys in enumerate(alone)
                   for x, y in zip(got, ys))
        print(f"datagen-shard {label}: each lane bit-equal to the lane "
              f"stepped alone {same}")
        check(same, f"datagen-shard {label}: a lane differs from its run "
              f"alone")

    # 2D NLSE, SS2 and sEWI, 1024^2 on (2, 2), m = 20
    shape = (SH_N, SH_N)
    mesh = pmesh.make_mesh(("gy", "gx"), SH_MESH2,
                           devices=[dev] * math.prod(SH_MESH2))
    n_sh = mesh.size
    u0s, _, m, c = draws("nlse", "multi_soliton", "cubic", SH_N)
    u0 = np.stack(u0s)
    packed = np.stack([u0.real, u0.imag], axis=1).astype(np.float32)
    ss2 = {"pass1_shard2d": DG_M - 1, "pass2": DG_M, "K3": 1, "kick_bc": 2}
    sewi = {"pass1_shard2d": 3 * (DG_M - 1), "pass2": 3 * DG_M, "K3": 3}
    for integ, want, snaps, freq in (("ss2", ss2, 3, 5),
                                     ("sewi", sewi, 3, 3)):
        label = f"nlse 2D {integ} {SH_N}^2 m={DG_M} {SH_MESH2}"
        traj = spatial.make_sharded_nlse_trajectory_fn(
            "cubic", shape, DG_LX, DG_DT, mesh, integrator=integ,
            krylov_m=DG_M)
        got = drive(label, traj, (packed, m, c), snaps, freq, want, n_sh,
                    None if integ == "ss2" else ss2)
        ref = engine.make_nlse_trajectory_fn(
            "cubic", shape, DG_LX, DG_DT, integrator=integ, krylov_m=DG_M)(
            packed, m, c, snaps, freq)
        lanes_close(label, [got], [ref])
        del ref
        if integ == "ss2":
            step = spatial.make_sharded_nlse_step(
                "cubic", shape, DG_LX, DG_DT, mesh, krylov_m=DG_M,
                use_c=True)
            alone = []
            for b in range(SH_B):
                mp, cp = shards.shard(m[b], mesh), shards.shard(c[b], mesh)
                s = shards.shard(packed[b], mesh)
                out = [shards.gather(s, mesh)]
                for _ in range(snaps - 1):
                    s = advance(lambda x, i: step(x, mp, cp), s, freq)
                    out.append(shards.gather(s, mesh))
                alone.append([torch.stack(out)])
        else:
            alone = [[traj(packed[b:b + 1], m[b:b + 1], c[b:b + 1], snaps,
                           freq)[0]] for b in range(SH_B)]
        lanes_alone(label, [got], alone)
        del got, alone

    # 2D sine-Gordon Gautschi float32, 1024^2 on (2, 2), m = 10
    u0s, v0s, m, c = draws("realwave", "kink_field", "sine_gordon", SH_N)
    u0 = np.stack(u0s).astype(np.float32)
    v0 = np.stack(v0s).astype(np.float32)
    label = f"sine-Gordon 2D gautschi {SH_N}^2 m={DG_RW_M} {SH_MESH2}"
    traj = spatial.make_sharded_realwave_trajectory_fn(
        "sine_gordon", shape, DG_LX, DG_RW_DT, mesh, krylov_m=DG_RW_M)
    rw = {"pass1_shard2d": 2 * (DG_RW_M - 1), "pass2": 2 * DG_RW_M, "K3": 2}
    got = drive(label, traj, (u0, v0, m, c), 3, 5, rw, n_sh)
    ref = engine.make_realwave_trajectory_fn(
        "sine_gordon", shape, DG_LX, DG_RW_DT, krylov_m=DG_RW_M)(
        u0, v0, m, c, 3, 5)
    lanes_close(label, got[:1], ref[:1])
    alone = [traj(u0[b:b + 1], v0[b:b + 1], m[b:b + 1], c[b:b + 1], 3, 5)
             for b in range(SH_B)]
    lanes_alone(label, got, [[x[0] for x in a] for a in alone])
    del got, ref, alone

    # 3D NLSE c(x), 256^3 on (1, 1, 4), the reference variant, m = 10
    shape3 = (SH_N3,) * 3
    mesh3 = pmesh.make_mesh(("gz", "gy", "gx"), SH_MESH3,
                            devices=[dev] * math.prod(SH_MESH3))
    gen = torch.Generator(device=dev).manual_seed(97)
    x = torch.linspace(-DG_LX, DG_LX, SH_N3, device=dev)
    zz, yy, xx = torch.meshgrid(x, x, x, indexing="ij")
    u3 = []
    for b in range(SH_B):
        env = torch.exp(-((xx - b) ** 2 + yy ** 2 + zz ** 2) / (4 + 2 * b))
        u3.append(torch.stack([env * torch.cos(0.5 * xx),
                               env * torch.sin(0.5 * xx)]))
    u3 = torch.stack(u3)
    del zz, yy, xx
    m3 = torch.ones((SH_B,) + shape3, device=dev)
    c3 = 1.0 + 0.4 * torch.rand((SH_B,) + shape3, generator=gen,
                                device=dev)
    label = f"nlse 3D ss2 {SH_N3}^3 m={DG3_M} {SH_MESH3} reference"
    traj = spatial.make_sharded_nlse_trajectory_fn(
        "cubic", shape3, DG_LX, SH_DT3, mesh3, axis_names=("gz", "gy", "gx"),
        krylov_m=DG3_M)
    ss3 = {"pass1_shard3d": DG3_M - 1, "pass2": DG3_M, "K3": 1, "kick_bc": 2}
    got = drive(label, traj, (u3, m3, c3), 3, 2, ss3, mesh3.size)
    ref = engine.make_nlse_trajectory_fn(
        "cubic", shape3, DG_LX, SH_DT3, krylov_m=DG3_M)(u3, m3, c3, 3, 2)
    lanes_close(label, [got], [ref])
    del ref
    alone = [[traj(u3[b:b + 1], m3[b:b + 1], c3[b:b + 1], 3, 2)[0]]
             for b in range(SH_B)]
    lanes_alone(label, [got], alone)
    del got, alone, u3, m3, c3
    torch.cuda.empty_cache()

    # the user's entry point: Datagen.run with shard_grid (the CLI's
    # --shard-grid 2,2), 2 runs of the 2D NLSE sweep at 1024^2, guard and
    # mass series on, npy archives
    nt, snaps = 10, 3
    cfg = datagen.DatagenConfig(
        family="nlse", phenomenon="multi_soliton", system="cubic", nx=SH_N,
        T=nt * DG_DT, nt=nt, snapshots=snaps, num_runs=SH_B,
        anisotropy_type="layered", m_type="piecewise", seed=3,
        output_dir=str(work / "sweep"), archive_format="npy",
        record_energy=True, shard_grid=SH_MESH2, device="cuda")
    dg = datagen.Datagen(cfg)
    steps = (snaps - 1) * cfg.snapshot_freq
    torch.cuda.synchronize()
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    written = dg.run()
    wall = time.perf_counter() - t0
    got = {k: f.launches for k, f in counters.items() if f.launches}
    exp = {k: n_sh * steps * v for k, v in ss2.items()}
    print(f"datagen-shard Datagen.run shard_grid={SH_MESH2} {SH_N}^2: "
          f"{len(written)} runs archived in {wall:.2f} s; launches {got}")
    check(got == exp, f"datagen-shard Datagen.run: launches {got} != {exp}")
    check(len(written) == SH_B, f"datagen-shard Datagen.run: "
          f"{len(written)} archives")
    dx = 2.0 * DG_LX / (SH_N - 1)
    for path in written:
        base = path.with_suffix("")
        u = np.load(f"{base}_u.npy")
        mass = np.load(f"{base}_mass.npy")
        host = (np.abs(u) ** 2).sum(axis=(1, 2)) * dx * dx
        e = float(np.max(np.abs(mass - host) / host))
        print(f"datagen-shard {path.name}: u {u.shape} finite "
              f"{bool(np.isfinite(u).all())}, mass series vs the archive's "
              f"mass rel {e:.3e}")
        check(u.shape == (snaps, SH_N, SH_N) and np.isfinite(u).all(),
              f"datagen-shard {path.name}: archived u")
        check(e <= 1e-5, f"datagen-shard {path.name}: mass {e:.3e}")
    shutil.rmtree(work, ignore_errors=True)
    return per_step


BA_B, BA_MESH2, BA_MESH3 = 4, (2, 2, 2), (2, 1, 1, 4)


def batch_axis_phase(torch, np, root, counters):
    """Phase 40: the batch axis (parallel/spatial's batch_axis,
    pipeline/engine's mesh, parallel/distributed), every shard on this
    card. The grid-sharded datagen engine with batch_axis on a (batch,
    *grid) mesh, B = BA_B lanes: 2D cubic NLSE c(x) 1024^2 SS2 m = 20 on
    (2, 2, 2) (the datagen-shard draws) and 3D cubic NLSE c(x) 256^3 SS2
    m = 10 on (2, 1, 1, 4); each lane bit-equal to its lane block run on the
    grid-only mesh ((2, 2), (1, 1, 4)), and the launches of the batch-axis
    run (counters at 0 just before, read just after) equal to those of the
    grid-only runs of the two blocks of B = 2. The unsharded datagen engine
    (256^2 c(x) SS2 m = 20, B = 8) with a ("batch",) mesh of 2: snapshots,
    bad_at and the mass series bit-equal to no mesh, each step 2 x the
    batched step's launches, both timed after a warm-up round.
    parallel/batch.batched_evolve of one planar problem (problem.step's
    batched form) on that mesh, B = BA_B: each lane bit-equal to the problem
    stepped alone, the launches those of its two blocks without a mesh. A
    complex128 sharded SS2 step (the generic path) at 256^2 on (2, 2) within rel-L2
    1e-10 of the unsharded complex128 problem. distributed.initialize at
    world size 1 (gloo on localhost) and Datagen.run through it on the
    global batch mesh. Returns ({path: {kernel: launches per step per
    sub-mesh}}, elapsed seconds)."""
    import shutil
    import socket

    from nlsolvers_tpu_torch.models import problems
    from nlsolvers_tpu_torch.parallel import distributed as dist
    from nlsolvers_tpu_torch.parallel import mesh as pmesh
    from nlsolvers_tpu_torch.parallel import shards, spatial
    from nlsolvers_tpu_torch.pipeline import datagen, engine

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    work = root / "_smoke_batch_axis"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    per_sub = {}

    def counted(fn):
        torch.cuda.synchronize()
        for f in counters.values():
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: f.launches for k, f in counters.items()
                     if f.launches}

    def one_mesh(axes, shape):
        return pmesh.make_mesh(axes, shape, devices=[dev] * math.prod(shape))

    def against_blocks(label, make, args, snaps, freq, grid_axes,
                       grid_shape, steps):
        """The batch-axis run against the grid-only runs of its two lane
        blocks: bits and launches."""
        grid = make(one_mesh(grid_axes, grid_shape), None)
        half = BA_B // 2
        n_want, alone = {}, []
        t1 = time.perf_counter()
        for sl in (slice(0, half), slice(half, BA_B)):
            out, n = counted(lambda: grid(*[a[sl] for a in args], snaps,
                                          freq))
            alone.append(out)
            for k, v in n.items():
                n_want[k] = n_want.get(k, 0) + v
        wall_grid = time.perf_counter() - t1
        traj = make(one_mesh(("batch",) + grid_axes, (2,) + grid_shape),
                    "batch")
        t1 = time.perf_counter()
        got, n_got = counted(lambda: traj(*args, snaps, freq))
        wall = time.perf_counter() - t1
        same = torch.equal(got, torch.cat(alone))
        print(f"batch-axis {label}: {steps} steps of B={BA_B} on "
              f"{(2,) + grid_shape} in {wall:.3f} s ({wall / steps * 1e3:.1f}"
              f" ms per step, snapshots included; the two blocks of "
              f"B={half} on {grid_shape} before it, the first warming up: "
              f"{wall_grid / steps * 1e3:.1f} ms per step together); "
              f"launches {n_got} (the two grid-only blocks: {n_want}); each "
              f"lane bit-equal to its block on {grid_shape} {same}")
        check(bool(torch.isfinite(got).all()),
              f"batch-axis {label}: not finite")
        check(same, f"batch-axis {label}: a lane differs from its block "
              f"run on the grid-only mesh")
        check(n_got == n_want, f"batch-axis {label}: launches {n_got} != "
              f"{n_want}")
        per_sub[label] = {k: v // (2 * steps) for k, v in n_got.items()}
        del got, alone

    # 2D NLSE c(x) SS2 1024^2 m = 20 on (2, 2, 2), the datagen-shard draws
    cfg = datagen.DatagenConfig(
        family="nlse", phenomenon="multi_soliton", system="cubic", nx=SH_N,
        num_runs=BA_B, anisotropy_type="layered", m_type="piecewise",
        output_dir=str(work), archive_format="npy", device="cuda")
    _, u0s, _, m, c = datagen.Datagen(cfg)._sample_batch(BA_B)
    u0 = np.stack(u0s)
    packed = np.stack([u0.real, u0.imag], axis=1).astype(np.float32)
    m, c = m.astype(np.float32), c.astype(np.float32)
    against_blocks(
        f"nlse 2D ss2 {SH_N}^2 m={DG_M}",
        lambda mesh, ba: spatial.make_sharded_nlse_trajectory_fn(
            "cubic", (SH_N, SH_N), DG_LX, DG_DT, mesh, batch_axis=ba,
            krylov_m=DG_M),
        (packed, m, c), 3, 2, ("gy", "gx"), BA_MESH2[1:], 4)
    del packed, m, c

    # 3D NLSE c(x) SS2 256^3 m = 10 on (2, 1, 1, 4), the reference variant
    shape3 = (SH_N3,) * 3
    gen = torch.Generator(device=dev).manual_seed(98)
    x = torch.linspace(-DG_LX, DG_LX, SH_N3, device=dev)
    zz, yy, xx = torch.meshgrid(x, x, x, indexing="ij")
    u3 = []
    for b in range(BA_B):
        env = torch.exp(-((xx - b) ** 2 + yy ** 2 + zz ** 2) / (4 + b))
        u3.append(torch.stack([env * torch.cos(0.5 * xx),
                               env * torch.sin(0.5 * xx)]))
    u3 = torch.stack(u3)
    del zz, yy, xx, env
    m3 = torch.ones((BA_B,) + shape3, device=dev)
    c3 = 1.0 + 0.4 * torch.rand((BA_B,) + shape3, generator=gen, device=dev)
    against_blocks(
        f"nlse 3D ss2 {SH_N3}^3 m={DG3_M} reference",
        lambda mesh, ba: spatial.make_sharded_nlse_trajectory_fn(
            "cubic", shape3, DG_LX, SH_DT3, mesh,
            axis_names=("gz", "gy", "gx"), batch_axis=ba, krylov_m=DG3_M),
        (u3, m3, c3), 3, 2, ("gz", "gy", "gx"), BA_MESH3[1:], 4)
    del u3, m3, c3
    torch.cuda.empty_cache()

    # the unsharded datagen engine with a ("batch",) mesh of 2
    cfg = datagen.DatagenConfig(
        family="nlse", phenomenon="multi_soliton", system="cubic", nx=DG_N,
        num_runs=DG_B, anisotropy_type="layered", m_type="piecewise",
        output_dir=str(work), archive_format="npy", device="cuda")
    _, u0s, _, m, c = datagen.Datagen(cfg)._sample_batch(DG_B)
    u0 = np.stack(u0s)
    packed = np.stack([u0.real, u0.imag], axis=1).astype(np.float32)
    m, c = m.astype(np.float32), c.astype(np.float32)
    bmesh = one_mesh(("batch",), (2,))
    label = f"engine nlse 2D ss2 {DG_N}^2 m={DG_M} ('batch',) 2"
    kw = dict(krylov_m=DG_M, guard=True, record_energy=True, device=dev)
    fns = {key: engine.make_nlse_trajectory_fn(
        "cubic", (DG_N, DG_N), DG_LX, DG_DT, mesh=mesh_, **kw)
        for key, mesh_ in (("none", None), ("mesh", bmesh))}
    runs, walls = {}, {}
    for rep in range(2):            # the first round warms both up
        for key, fn in fns.items():
            t1 = time.perf_counter()
            runs[key] = counted(lambda: fn(packed, m, c, 3, 5))
            walls[key] = time.perf_counter() - t1
    (want, wbad, wser), n_want = runs["none"]
    (got, bad, ser), n_got = runs["mesh"]
    same = (torch.equal(got, want) and torch.equal(bad, wbad)
            and torch.equal(ser["mass"], wser["mass"]))
    exp = {k: 2 * 10 * v for k, v in DG_PER_STEP.items()}
    print(f"batch-axis {label}: launches {n_got} (no mesh {n_want}); "
          f"snapshots, bad_at and mass series bit-equal to no mesh {same}; "
          f"10 steps {walls['mesh']:.3f} s (no mesh {walls['none']:.3f} s; "
          f"both warm, {walls['mesh'] / walls['none']:.2f}x)")
    check(same, f"batch-axis {label}: differs from the engine without a "
          f"mesh")
    check(n_got == exp, f"batch-axis {label}: launches {n_got} != {exp}")
    per_sub[label] = {k: v // 20 for k, v in n_got.items()}
    del got, want, runs

    # parallel/batch.batched_evolve of one planar problem (the first draw's
    # m and c) over the first BA_B draws on a ("batch",) mesh of 2: each
    # block one batched step (problem.step.batched), each lane bit-equal to
    # the problem stepped alone, the launches those of the two blocks run
    # without a mesh
    from nlsolvers_tpu_torch.models.evolve import evolve
    from nlsolvers_tpu_torch.parallel import batch as pbatch

    label = f"batched_evolve nlse 2D ss2 {DG_N}^2 m={DG_M} ('batch',) 2"
    prob = problems.nlse_problem(
        "cubic", (DG_N, DG_N), DG_LX, DG_DT,
        m_field=torch.from_numpy(m[0]).to(dev),
        c_field=torch.from_numpy(c[0]).to(dev), krylov_m=DG_M, device=dev)
    check(callable(getattr(prob.step, "batched", None)),
          f"batch-axis {label}: the problem has no batched step")
    states0 = torch.stack([prob.init(torch.from_numpy(packed[b]).to(dev))
                           for b in range(BA_B)])
    n_want = {}
    for sl in (slice(0, BA_B // 2), slice(BA_B // 2, BA_B)):
        _, n = counted(lambda: pbatch.batched_evolve(prob, states0[sl], 3, 2))
        for k, v in n.items():
            n_want[k] = n_want.get(k, 0) + v
    got, n_got = counted(lambda: pbatch.batched_evolve(
        prob, states0, 3, 2, mesh=bmesh))
    alone = torch.stack([evolve(prob.step, states0[b], 3, 2,
                                observe=prob.observe)
                         for b in range(BA_B)])
    same = torch.equal(got, alone)
    print(f"batch-axis {label}: B={BA_B}, 4 steps, {tuple(got.shape)}; "
          f"launches {n_got} (the two blocks without a mesh: {n_want}); "
          f"each lane bit-equal to the problem stepped alone {same}")
    check(bool(torch.isfinite(got).all()), f"batch-axis {label}: not finite")
    check(same, f"batch-axis {label}: a lane differs from the problem "
          f"stepped alone")
    check(n_got == n_want and n_got == {
        k: 2 * 4 * v for k, v in DG_PER_STEP.items()},
        f"batch-axis {label}: launches {n_got} != {n_want}")
    per_sub[label] = {k: v // 8 for k, v in n_got.items()}
    del got, alone, states0, prob, packed, m, c

    # a complex128 sharded SS2 step, the generic path, 256^2 on (2, 2)
    n2, mesh4 = 256, one_mesh(("gy", "gx"), (2, 2))
    xs = torch.linspace(-1, 1, n2, dtype=torch.float64, device=dev)
    env = torch.exp(-(xs[:, None] ** 2 + xs[None, :] ** 2) * 4)
    u64 = torch.complex(env, env * xs[None, :])
    m64 = 1.0 + 0.2 * torch.rand((n2, n2), generator=gen, device=dev,
                                 dtype=torch.float64)
    prob = problems.nlse_problem("cubic", (n2, n2), DG_LX, 1e-3,
                                 m_field=m64, krylov_m=8,
                                 dtype=torch.complex128, device=dev)
    ref = prob.init(u64)
    step = spatial.make_sharded_nlse_step(
        "cubic", (n2, n2), DG_LX, 1e-3, mesh4, krylov_m=8,
        dtype=torch.complex128)
    up = shards.shard(torch.stack([u64.real, u64.imag]), mesh4)
    mp = shards.shard(m64, mesh4)
    (up, ref), n_c = counted(lambda: advance(
        lambda st, i: (step(st[0], mp), prob.step(st[1], i)), (up, ref), 3))
    g = shards.gather(up, mesh4)
    e = rel(torch.complex(g[0], g[1]), ref)
    print(f"batch-axis complex128 sharded SS2 {n2}^2 (2, 2), 3 steps: "
          f"rel-L2 {e:.3e} against the unsharded complex128 problem; "
          f"counted launches {n_c} (plain torch)")
    check(e <= 1e-10, f"batch-axis complex128 sharded step {e:.3e}")
    check(not n_c, f"batch-axis complex128: kernel launches {n_c}")

    # distributed.initialize at world size 1, Datagen.run through it
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.initialize(f"localhost:{port}", 1, 0)
    try:
        gmesh = dist.global_mesh(("batch",))
        cfg = datagen.DatagenConfig(
            family="nlse", phenomenon="multi_soliton", system="cubic",
            nx=DG_N, T=10 * DG_DT, nt=10, snapshots=3, num_runs=2,
            anisotropy_type="layered", m_type="piecewise", seed=5,
            output_dir=str(work / "dist"), archive_format="npy",
            mesh=gmesh, device="cuda")
        dg = datagen.Datagen(cfg)
        written = dg.run()
        print(f"batch-axis distributed: world size "
              f"{dist.process_count()}, rank {dist.process_index()}, global "
              f"mesh {gmesh.shape} on {[str(d) for d in gmesh.devices]}; "
              f"Datagen.run archived {len(written)} runs: "
              f"{dg.summary_line}")
        check(dist.process_count() == 1 and len(written) == 2,
              f"batch-axis distributed: {len(written)} archives")
        for path in written:
            u = np.load(f"{path.with_suffix('')}_u.npy")
            check(u.shape == (3, DG_N, DG_N) and np.isfinite(u).all(),
                  f"batch-axis distributed: {path.name}")
    finally:
        dist.shutdown()
    shutil.rmtree(work, ignore_errors=True)
    elapsed = time.perf_counter() - t0
    print(f"batch-axis: {elapsed:.1f} s")
    return per_sub, elapsed


# phase 41, the integrator study (the reference's integrator-comparison
# study, compare_utils_complex_2d.py; SURVEY.md section 4 item 3) through
# nlsolvers_tpu_torch.analysis: the cubic NLSE on the c(x) main path's
# operator (colliding packets, c piecewise layers) at three widths up to the
# main path's 1024^2, SS2 against sEWI; sine-Gordon (kink) Gautschi against
# SV; complex64 / float32, which take the kernels
ST_LX, ST_M, ST_SNAPS = 10.0, 10, 11
ST_NX, ST_DT, ST_T = (256, 512, 1024), (1e-3, 5e-4), 0.05
ST_OFF_NX = 512      # the widest where dt rho(A) at dt 5e-4 stays ~m/2
ST_RW_NX, ST_RW_DT, ST_RW_T = (256, 1024), (1e-3,), 0.02
ST_PER_STEP = {"ss2": {"K1'": 1, "K2'": ST_M - 1, "K3": 1, "kick_bc": 2,
                       "recur": ST_M},
               "sewi": {"K1'": 3, "K2'": 3 * (ST_M - 1), "K3": 3,
                        "recur": 3 * ST_M},
               "gautschi": {"K1": 2, "K2": 2 * (ST_M - 1), "K3": 2,
                            "recur": 2 * ST_M},
               "sv": {}}
ST_TRACE_NAMES = ("study-cell", "pass1_tile_kernel", "pipe_2d_kernel",
                  "combine_kernel", "kick_bc_kernel")


# phase 42, the device recurrence: the 2D pipelined loop's scalar
# recurrence as the recurrence kernel launched inside K1' / K2' (K1 / K2),
# against the same loop's eager torch ops (lanczos2d._lanczos_eager, the
# plain function called directly), at the datagen sweep's point (200^2 c(x)
# m=20, one lane and a batch of 30), on 256^2 iso m=10 and on the real-wave
# operator (P=1, sign -1)
RC_N, RC_M, RC_B = 200, 20, 30
RC_ISO_N, RC_ISO_M = 256, 10


def bits_equal(torch, a, b):
    """Same shape, dtype and bits (NaN where NaN, the other bits equal)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        torch.where(na, 0, a).view(torch.int32),
        torch.where(nb, 0, b).view(torch.int32)))


def runs_equal(torch, got, want, lane=None):
    """Two Lanczos runs (W, s, alphas, betas, beta0) bit for bit, or the
    `lane` of a batched `got` against the unbatched run `want`."""
    pick = (lambda x: x) if lane is None else (lambda x: x[lane])
    if [len(x) for x in got[:4]] != [len(x) for x in want[:4]]:
        return False
    pairs = [(pick(a), b) for g, w in zip(got[:4], want[:4])
             for a, b in zip(g, w)] + [(pick(got[4]), want[4])]
    return all(bits_equal(torch, a, b) for a, b in pairs)


def recurrence_phase(torch, lz, operators, counters):
    """Phase 42: the device recurrence (lanczos2d._lanczos_rec) against
    the eager loop (lanczos2d._lanczos_eager) on the same seeded fields:
    W, s, alphas, betas and beta0 bit-equal, on RC_N^2 c(x) m=RC_M one lane
    and RC_B lanes (lane 1 zero: safe_inv's 0; lane 2 NaN), each lane of the
    batch bit-equal to the lane run alone, RC_ISO_N^2 iso m=RC_ISO_M one
    lane, and P=1 with sign -1 (iso and c(x)). Counters at 0 before each
    run: the device run exactly 1 K1' / K1 + m-1 K2' / K2 and m recurrence
    launches, the eager run the same kernels and no recurrence launch;
    _lanczos_pipe takes the device recurrence on the card and the eager
    loop under kernel_mode "off" (no recurrence launch)."""
    from nlsolvers_tpu_torch import config

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4242)
    dx = 2.0 * LX / (RC_N - 1)

    def aniso(B):
        cs = [1.0 + 0.4 * torch.rand((RC_N, RC_N), generator=gen,
                                     device=dev, dtype=torch.float64)
              for _ in range(B)]
        d = operators.batched_aniso_laplacian_2d(cs, dx, dx, device=dev)
        one = dict(d, wx=d["wx"][0].contiguous(), wy=d["wy"][0].contiguous())
        return d, one, [dict(d, wx=d["wx"][b].contiguous(),
                             wy=d["wy"][b].contiguous()) for b in range(B)]

    def counted(fn, *args):
        torch.cuda.synchronize()
        for f in counters.values():
            f.launches = 0
        out = fn(*args)
        torch.cuda.synchronize()
        return out, {k: f.launches for k, f in counters.items()
                     if f.launches}

    def compare(label, u, m, desc, k1, k2):
        dev_run, n_dev = counted(lz._lanczos_rec, u, m, desc)
        eager, n_eager = counted(lz._lanczos_eager, u, m, desc)
        want = {k1: 1, k2: m - 1}
        check(n_dev == dict(want, recur=m), f"recurrence {label}: "
              f"launches {n_dev} != {dict(want, recur=m)}")
        check(n_eager == want, f"recurrence {label}: eager launches "
              f"{n_eager} != {want}")
        same = runs_equal(torch, dev_run, eager)
        print(f"recurrence {label}: device vs eager bit-equal {same}, "
              f"launches {n_dev}")
        check(same, f"recurrence {label}: the device recurrence differs "
              f"from the eager loop")
        return dev_run

    d30, d1, lanes = aniso(RC_B)
    u1 = torch.randn((2, RC_N, RC_N), generator=gen, device=dev)
    compare(f"{RC_N}^2 c(x) m={RC_M} B=1", u1, RC_M, d1, "K1'", "K2'")
    u30 = torch.randn((RC_B, 2, RC_N, RC_N), generator=gen, device=dev)
    u30[1] = 0.0
    u30[2] = float("nan")
    run30 = compare(f"{RC_N}^2 c(x) m={RC_M} B={RC_B}", u30, RC_M, d30,
                    "K1'", "K2'")
    alone = [runs_equal(torch, run30, lz._lanczos_rec(
        u30[b].contiguous(), RC_M, lanes[b]), lane=b) for b in range(RC_B)]
    print(f"recurrence B={RC_B}: lanes bit-equal to the lane run alone "
          f"{sum(alone)} of {RC_B}")
    check(all(alone), f"recurrence: lanes "
          f"{[b for b, ok in enumerate(alone) if not ok]} differ from their "
          f"runs alone")
    check(float(run30[1][0][1]) == 0 and float(run30[1][1][1]) == 0,
          "recurrence: the zero lane's s_0, s_1 are not 0")
    dxi = 2.0 * LX / (RC_ISO_N - 1)
    iso = operators.laplacian_2d((RC_ISO_N, RC_ISO_N), dxi, dxi,
                                 device=dev).kernel_desc
    ui = torch.randn((2, RC_ISO_N, RC_ISO_N), generator=gen, device=dev)
    compare(f"{RC_ISO_N}^2 iso m={RC_ISO_M} B=1", ui, RC_ISO_M, iso, "K1",
            "K2")
    ur = torch.randn((1, RC_ISO_N, RC_ISO_N), generator=gen, device=dev)
    compare(f"{RC_ISO_N}^2 iso P=1 sign -1 m={RC_ISO_M}", ur, RC_ISO_M,
            dict(iso, sign=-1.0), "K1", "K2")
    ua = torch.randn((1, RC_N, RC_N), generator=gen, device=dev)
    compare(f"{RC_N}^2 c(x) P=1 sign -1 m={RC_M}", ua, RC_M,
            dict(d1, sign=-1.0), "K1'", "K2'")
    _, n_pipe = counted(lz._lanczos_pipe, u1, RC_M, d1)
    config.kernel_mode = "off"
    try:
        _, n_off = counted(lz._lanczos_pipe, u1, RC_M, d1)
    finally:
        config.kernel_mode = "auto"
    print(f"recurrence: _lanczos_pipe launches {n_pipe} (kernels), {n_off} "
          f"(kernel_mode off)")
    check(n_pipe.get("recur") == RC_M and n_off == {},
          f"recurrence: _lanczos_pipe launches {n_pipe}, off {n_off}")

    def recur_ms(label, u, m, desc, reps=10):
        """(recurrence kernel, eager recurrence) device ms a run: the
        recur_kernel rows of reps profiled _lanczos_rec runs, and the eager
        runs' device time less the device runs' other kernels (the same
        K1 / K2 and reductions)."""
        def dev_ms(fn, key=""):
            rows = profiled(torch, lambda: [fn(u, m, desc)
                                            for _ in range(reps)])
            if rows is None:
                return None
            return sum(dev_us(e) for e in rows if key in e.key) / 1e3 / reps
        k = dev_ms(lz._lanczos_rec, "recur_kernel")
        rec_all, eager = dev_ms(lz._lanczos_rec), dev_ms(lz._lanczos_eager)
        if None in (k, rec_all, eager):
            print(f"recurrence {label}: device time not measured (no trace)")
            return None, None
        print(f"recurrence {label}: recur_kernel {k:.4f} ms a run ({m} "
              f"launches, {k / m * 1e3:.2f} us each); the eager recurrence "
              f"{eager - (rec_all - k):.4f} ms of device time a run")
        return k, eager - (rec_all - k)

    dxn = 2.0 * LX / (N - 1)
    main_desc = operators.laplacian_2d((N, N), dxn, dxn,
                                       device=dev).kernel_desc
    un = torch.randn((2, N, N), generator=gen, device=dev)
    times = {"main": recur_ms(f"{N}^2 iso m={KRYLOV_M} B=1", un, KRYLOV_M,
                              main_desc),
             "task30": recur_ms(f"{RC_N}^2 c(x) m={RC_M} B={RC_B}", u30,
                                RC_M, d30)}
    print(f"recurrence: {time.perf_counter() - t0:.1f} s")
    return times


def recur_bytes(B, m):
    """Least device traffic of a run's m recurrence launches on B lanes:
    each reads its launch's reduced sums and writes beta and s and, but for
    the last, alpha, the next K2's scal and the gram it keeps (float32)."""
    n = 0
    for j in range(-1, m - 1):
        last = j == m - 2
        nout = 3 if j < 0 else 1 + 2 * (j + 1) + (0 if last else 2 * (j + 2))
        n += nout + 2 + (0 if last else 1 + 2 * (j + 3) + 2 * (j + 1))
    return 4 * B * n


def study_steps(T, dt):
    """The steps of a study cell, as compare.integrator_study counts them."""
    nt = max(1, int(round(T / dt)))
    freq = max(1, nt // (ST_SNAPS - 1))
    return nt // freq * freq


def study_launches(integrator, n):
    """Counted launches of an n-step cell; sEWI's first step is the SS2
    bootstrap."""
    if integrator != "sewi":
        return {k: n * v for k, v in ST_PER_STEP[integrator].items()}
    boot, per = ST_PER_STEP["ss2"], ST_PER_STEP["sewi"]
    return {k: boot.get(k, 0) + (n - 1) * per.get(k, 0)
            for k in set(boot) | set(per)}


def study_phase(torch, np, root, counters, rate_ref):
    """Phase 41: the integrator study through nlsolvers_tpu_torch.analysis
    on the card. Every cell runs through compare.integrator_study, one cell
    a call (the same downsampled inputs as one call over the matrix) with
    the launch counters at 0 just before and read just after: exactly its
    steps x ST_PER_STEP (sEWI after its SS2 bootstrap), every cell
    simulation_stable. The dt 5e-4 NLSE cells against config.kernel_mode
    "off": over the whole cell at ST_OFF_NX^2, steps 1-3 and every 10th
    from the kernel run's state at 1024^2 (final snapshot / field and mass
    within 1e-5).
    Printed: summary rows, the CSV, the SS2-sEWI (Gautschi-SV) differences
    and their ratio between the two dt. Then structure / spectral
    diagnostics on the kept trajectories (finite), profiling.trace around
    one 1024^2 SS2 cell (the annotation and the four kernels named, up to 5
    tries), StepTimer over 20 SS2 steps beside phase 15's rate, and
    study.run_study at 256^2 / 512^2 where matplotlib is installed. Returns
    the elapsed seconds."""
    import csv
    import importlib.util
    import shutil

    from nlsolvers_tpu_torch.analysis import (compare, spectral, structure,
                                              study)
    from nlsolvers_tpu_torch.models import problems
    from nlsolvers_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    work = root / "_smoke_study"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    c64 = torch.complex64

    def counted(fn):
        torch.cuda.synchronize()
        for f in counters.values():
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: f.launches for k, f in counters.items()
                     if f.launches}

    def cell(family, kind, inputs, integrator, nx, dt, T, dtype,
             keep=None):
        u0, v0, m, c = inputs
        return compare.integrator_study(
            family, kind, u0, v0_high=v0, m_high=m, c_high=c,
            integrators=(integrator,), nx_values=[nx], dt_values=[dt], T=T,
            Lx=ST_LX, num_snapshots=ST_SNAPS, krylov_m=ST_M, dtype=dtype,
            keep_traj=keep, device="cuda")

    def matrix(family, kind, inputs, integrators, nxs, dts, T, dtype,
               keep=None):
        results = {}
        for nx in nxs:
            for dt in dts:
                for integ in integrators:
                    res, got = counted(lambda: cell(family, kind, inputs,
                                                    integ, nx, dt, T, dtype,
                                                    keep))
                    r = res[(integ, nx, dt)]
                    n = study_steps(T, dt)
                    want = study_launches(integ, n)
                    print(f"study {kind} {integ} {nx}^2 dt {dt:g}: {n} "
                          f"steps, walltime {r['walltime']:.4f} s (run, "
                          f"readback, analysis); launches {got}")
                    check(got == {k: v for k, v in want.items() if v},
                          f"study {integ} {nx}^2 dt {dt:g}: launches {got} "
                          f"!= {want}")
                    check(bool(r["simulation_stable"]),
                          f"study {integ} {nx}^2 dt {dt:g}: not stable")
                    results.update(res)
        return results

    def show(results, pair, dts, T, label):
        rows = study.summary_rows(results, T)
        for r in rows:
            print(f"study row {json.dumps(r)}")
        path = study.save_summary_csv(rows, work / f"summary_{label}.csv")
        print(f"study {path.name}:\n{path.read_text().rstrip()}")
        diffs = compare.pairwise_solution_difference(results, pair)
        for (nx, dt), d in sorted(diffs.items()):
            print(f"study {pair[0]}-{pair[1]} {nx}^2 dt {dt:g}: rel-L2 "
                  f"{d:.6e}")
            check(math.isfinite(d), f"study {pair}: difference {d}")
        if len(dts) == 2:
            for nx in sorted({k[0] for k in diffs}):
                print(f"study {pair[0]}-{pair[1]} {nx}^2: dt {dts[0]:g} / "
                      f"{dts[1]:g} ratio "
                      f"{diffs[(nx, dts[0])] / diffs[(nx, dts[1])]:.4f}")

    # 1. the NLSE study
    nl_in = study._study_inputs("nlse", "cubic", "colliding_packets",
                                max(ST_NX), ST_LX, 0, "constant",
                                "piecewise_layers", {})
    dt_min = min(ST_DT)
    keep = lambda nx, dt: dt == dt_min
    nl = matrix("nlse", "cubic", nl_in, ("ss2", "sewi"), ST_NX, ST_DT, ST_T,
                c64, keep)
    nbig = max(ST_NX)

    def apart(a, b):
        """(final snapshot rel-L2, mass series max relative) of two cells."""
        return (float(np.linalg.norm(a["final_snapshot"] - b["final_snapshot"])
                      / np.linalg.norm(b["final_snapshot"])),
                float(np.max(np.abs(a["mass"] - b["mass"]) / b["mass"])))

    # the kernels against kernel_mode "off" at dt 5e-4. Free-running over
    # the whole cell at ST_OFF_NX^2, where dt rho(A) ~ 5 keeps the m=10
    # Krylov step resolved: phase 5's 1e-5. At 1024^2 (dt rho(A) ~ 21) a
    # free-running cell amplifies rounding: its difference is printed beside
    # the kernel run's own under a 2^-24 perturbation of u0, and steps 1-3
    # and every 10th are gated from the kernel run's state instead (1e-5 on
    # the field and on its mass), as phase 30 does for the same reason
    for integ in ("ss2", "sewi"):
        off = plain(lambda: cell("nlse", "cubic", nl_in, integ, ST_OFF_NX,
                                 dt_min, ST_T, c64))
        e, em = apart(nl[(integ, ST_OFF_NX, dt_min)],
                      off[(integ, ST_OFF_NX, dt_min)])
        print(f"study {integ} {ST_OFF_NX}^2 dt {dt_min:g}: kernels vs "
              f"kernel_mode off over the cell, final snapshot rel-L2 "
              f"{e:.3e}, mass series {em:.3e}")
        check(e <= 1e-5 and em <= 1e-5, f"study {integ} {ST_OFF_NX}^2: "
              f"kernels vs plain {e:.3e} / {em:.3e} > 1e-5")
        on = nl[(integ, nbig, dt_min)]
        off = plain(lambda: cell("nlse", "cubic", nl_in, integ, nbig, dt_min,
                                 ST_T, c64))[(integ, nbig, dt_min)]
        rng = np.random.default_rng(1)
        u0p = nl_in[0] * (1 + 2.0 ** -24 * rng.standard_normal(
            nl_in[0].shape))
        pert = cell("nlse", "cubic", (u0p,) + nl_in[1:], integ, nbig, dt_min,
                    ST_T, c64)[(integ, nbig, dt_min)]
        (e, em), (ep, emp) = apart(on, off), apart(pert, on)
        prob = problems.nlse_problem(
            "cubic", (nbig, nbig), ST_LX, dt_min, m_field=nl_in[2],
            c_field=nl_in[3], integrator=integ, krylov_m=ST_M, dtype=c64)
        s, worst, worst_m = prob.init(nl_in[0]), 0.0, 0.0
        n = study_steps(ST_T, dt_min)
        gated = sorted({1, 2, 3} | set(range(10, n + 1, 10)))
        for i in range(1, n + 1):
            if i in gated:
                b = prob.observe(plain(lambda: prob.step(s, i)))
            s = prob.step(s, i)
            if i in gated:
                a = prob.observe(s)
                ma, mb = (a.abs() ** 2).sum(), (b.abs() ** 2).sum()
                worst = max(worst, rel(a, b))
                worst_m = max(worst_m, float((ma - mb).abs() / mb))
        print(f"study {integ} {nbig}^2 dt {dt_min:g}: steps {gated} from "
              f"the kernel run's state vs the same step under kernel_mode off: "
              f"field rel-L2 <= {worst:.3e}, mass <= {worst_m:.3e}; over the "
              f"cell (free-running, not gated) final snapshot {e:.3e}, mass "
              f"series {em:.3e}, where the kernel run with u0 perturbed by "
              f"2^-24 reads {ep:.3e} / {emp:.3e}; walltime {on['walltime']:.4f}"
              f" s vs {off['walltime']:.4f} s off")
        check(worst <= 1e-5 and worst_m <= 1e-5, f"study {integ} {nbig}^2: "
              f"a step vs plain {worst:.3e} / {worst_m:.3e} > 1e-5")
        del prob, s, a, b
    show(nl, ("ss2", "sewi"), ST_DT, ST_T, "nlse")

    # 2. the real-wave study
    rw_in = study._study_inputs("realwave", "sine_gordon", "kink_solution",
                                max(ST_RW_NX), ST_LX, 0, "constant", None, {})
    rw = matrix("realwave", "sine_gordon", rw_in, ("gautschi", "sv"),
                ST_RW_NX, ST_RW_DT, ST_RW_T, torch.float32)
    show(rw, ("gautschi", "sv"), ST_RW_DT, ST_RW_T, "realwave")

    # 3. diagnostics on the card's output
    t1 = time.perf_counter()
    kept = nl[("ss2", nbig, dt_min)]["trajectory"]
    ssim = structure.structure_similarity(np.abs(kept))
    modes = structure.modal_energy_grid(kept)
    k_c, spec = spectral.modal_energy_spectrum(
        nl[("ss2", min(ST_NX), dt_min)]["trajectory"])
    print(f"study diagnostics: SSIM of |u| at {nbig}^2 against frame 0 "
          f"{[round(float(x), 6) for x in ssim]}; modal energy grid "
          f"{modes.shape}, its total {float(modes.sum()):.6e}; modal "
          f"spectrum at {min(ST_NX)}^2 {spec.shape}, the first bins "
          f"{[f'{x:.4e}' for x in spec[-1, :4]]}; "
          f"{time.perf_counter() - t1:.2f} s")
    check(all(np.isfinite(x).all() for x in (ssim, modes, k_c, spec)),
          "study diagnostics: not finite")

    # 4. profiling
    for tries in range(1, 6):
        logdir = work / f"trace_{tries}"
        with profiling.trace(logdir):
            with profiling.annotate("study-cell"):
                cell("nlse", "cubic", nl_in, "ss2", nbig, max(ST_DT), ST_T,
                     c64)
        text = next(logdir.glob("trace_*.json")).read_text()
        missing = [k for k in ST_TRACE_NAMES if k not in text]
        if not missing:
            break
        time.sleep(0.2)
    print(f"study trace: {tries} tries; {len(text) / 1e6:.1f} MB Chrome "
          f"trace; names {[k for k in ST_TRACE_NAMES if k in text]}, "
          f"missing {missing}")
    check(not missing, f"study trace: missing {missing}")
    for d in work.glob("trace_*"):
        shutil.rmtree(d)
    u0, _, m, c = nl_in
    prob = problems.nlse_problem("cubic", (nbig, nbig), ST_LX, max(ST_DT),
                                 m_field=m, c_field=c, krylov_m=ST_M,
                                 dtype=c64)
    s = profiling.sync(prob.step(prob.init(u0), 1))
    timer = profiling.StepTimer()
    for i in range(2, 22):
        s = prob.step(s, i)
        timer.lap(s)
    summ = timer.summary()
    print(f"study StepTimer, SS2 {nbig}^2 c(x) dt {max(ST_DT):g}, a sync "
          f"per step: {json.dumps(summ)}; phase 15's rate2d c(x) {N}^2 "
          f"(200-step chunks, one sync per chunk): {rate_ref:.2f} steps/s")
    check(summ["count"] == 20 and math.isfinite(summ["steps_per_s"]),
          f"study StepTimer: {summ}")
    del prob, s

    # 5. the figure set, where matplotlib is installed
    if importlib.util.find_spec("matplotlib") is None:
        print("study run_study: not run (no matplotlib on this machine)")
    else:
        nxs = (256, 512)
        arts, got = counted(lambda: study.run_study(
            work / "figures", "nlse", "cubic", integrators=("ss2", "sewi"),
            nx_values=list(nxs), dt_values=list(ST_DT), T=ST_T, Lx=ST_LX,
            phenomenon="colliding_packets", m_type="constant",
            c_type="piecewise_layers", num_snapshots=ST_SNAPS,
            krylov_m=ST_M, seed=0, dtype=c64, device="cuda"))
        want = {}
        for integ in ("ss2", "sewi"):
            for dt in ST_DT:
                for k, v in study_launches(integ, study_steps(ST_T, dt)
                                           ).items():
                    want[k] = want.get(k, 0) + v * len(nxs)
        with open(arts["summary_csv"]) as f:
            stable = [r["simulation_stable"] for r in csv.DictReader(f)]
        print(f"study run_study at {list(nxs)}: launches {got}; artifacts "
              f"{sorted(arts)}; stable {stable}")
        check(got == {k: v for k, v in want.items() if v},
              f"study run_study: launches {got} != {want}")
        check(stable == ["True"] * 8, f"study run_study: stable {stable}")
    elapsed = time.perf_counter() - t0
    print(f"study: {elapsed:.1f} s")
    return elapsed


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "nlsolvers_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no nlsolvers_tpu_torch package beside "
              f"{Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    from nlsolvers_tpu_torch import config
    from nlsolvers_tpu_torch.models import nlse, problems
    from nlsolvers_tpu_torch.models.nonlinearities import nlse_density
    from nlsolvers_tpu_torch.ops import boundaries, operators
    from nlsolvers_tpu_torch.ops.cuda import _build
    from nlsolvers_tpu_torch.ops.cuda import bc3d as b3
    from nlsolvers_tpu_torch.ops.cuda import kick as kb
    from nlsolvers_tpu_torch.ops.cuda import lanczos2d as lz
    from nlsolvers_tpu_torch.ops.cuda import lanczos3d as l3
    from nlsolvers_tpu_torch.ops.cuda import resident2d as rs
    from nlsolvers_tpu_torch.utils import interop

    check("jax" not in sys.modules, "jax was imported")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls must stay off (torch default)")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # ---------------------------------------------------------- 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"device: {name} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | count {torch.cuda.device_count()}")
    print(smi_line)

    # ---------------------------------------------------------- 2. build
    libs = ("lanczos2d", "lanczos3d", "resident2d", "kick")
    _build.build_all(libs)
    resources = {}
    for lib in libs:
        log = _build.build_log(lib)
        res = resources[lib] = kernel_resources(
            log.read_text().splitlines() if log.exists() else [])
        regs = [nreg for _, nreg, _ in res]
        spills = [f"{k} ({sp} bytes spill stores)" for k, _, sp in res if sp]
        print(f"build {lib}: {_build.build_seconds(lib):.2f} s (nvcc sm_90a "
              f"and load, builds in parallel); {len(regs)} kernels, "
              f"registers {min(regs, default=0)}-{max(regs, default=0)}; "
              f"kernels that spill registers: {len(spills)} "
              f"{'; '.join(spills)}")
    # every instantiation of the 2D kernels: K1 / K1' <P, MAXW, OPK, VEC>
    # (OPK 1 = aniso), the shard policies <P, MAXW, OP>, K2 <P, MAXW, LAST,
    # OP, VEC> and K3 <P, VEC> (VEC 4: 16-byte loads); K5 <P, MAXW, OPK,
    # VEC>, K8 <P, MAXW, MODE, VEC>, K13 <MAXW, VEC>; pass1_3d <P, MAXW,
    # MODE, LANES> and pass2 <P, MAXW, STORE, LANES> (LANES: the batched
    # form). K1 and K5 spill in no instantiation.
    for kname, nreg, spill in [r for lib in libs for r in resources[lib]]:
        if kname.startswith(("pass1_tile_kernel", "pass1_2d_kernel",
                             "pipe_2d_kernel", "combine_kernel",
                             "iter_kernel", "pipe3d_kernel",
                             "resident_kernel", "kick_bc_kernel",
                             "pass1_3d_kernel", "pass2_kernel",
                             "pass1_shard3d_kernel")):
            print(f"ptxas {kname}: {nreg} registers, {spill} bytes spill "
                  f"stores")
    # 2 P x 4 buckets x 2 VEC x (2 K1 operators + 4 K5 operators) = 96
    new_kernels = [(k, sp) for k, _, sp in resources["lanczos2d"]
                   if k.startswith(("pass1_tile_kernel", "iter_kernel"))]
    print(f"build: {len(new_kernels)} K1 / K5 instantiations, spills in "
          f"{sum(1 for _, sp in new_kernels if sp)}")
    check(len(new_kernels) == 96 and not any(sp for _, sp in new_kernels),
          f"K1 / K5: {len(new_kernels)} instantiations (96 expected), "
          f"spills {[k for k, sp in new_kernels if sp]}")
    # pass1_shard3d <P, MAXW, MODE, VEC> (MODE 3-5 the shard modes, VEC 4
    # the 16-byte form): 2 P x 4 buckets x 3 modes x 2 forms = 48
    shard3d = [(k, nreg, sp) for k, nreg, sp in resources["lanczos3d"]
               if k.startswith("pass1_shard3d_kernel")]
    regs3 = [nreg for _, nreg, _ in shard3d]
    print(f"build: {len(shard3d)} pass1_shard3d instantiations, registers "
          f"{min(regs3, default=0)}-{max(regs3, default=0)}, spills in "
          f"{sum(1 for *_, sp in shard3d if sp)}")
    check(len(shard3d) == 48 and not any(sp for *_, sp in shard3d),
          f"pass1_shard3d: {len(shard3d)} instantiations (48 expected), "
          f"spills {[k for k, _, sp in shard3d if sp]}")

    # ---------------------------------------------------------- 3. parity
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 3 parity")
    gen = torch.Generator(device=dev).manual_seed(1234)

    def field(ny=N, nx=N, P=2):
        return torch.randn((P, ny, nx), generator=gen, device=dev)

    def scalars(rows):
        s = torch.rand((rows, 2), generator=gen, device=dev) - 0.5
        s[0, 0], s[0, 1] = 0.8, 0.0
        return s

    def both(fn):
        got = fn()
        config.kernel_mode = "off"
        try:
            want = fn()
        finally:
            config.kernel_mode = "auto"
        return got, want

    def gate(label, fe, de):
        torch.cuda.synchronize()
        print(f"parity {label}: field rel-L2 {fe:.3e}, dot err {de:.3e}")
        check(fe <= FIELD_TOL, f"{label}: field rel-L2 {fe:.3e} > {FIELD_TOL}")
        check(de <= DOT_TOL, f"{label}: dot error {de:.3e} > {DOT_TOL}")

    dx = 2.0 * LX / (N - 1)
    desc = operators.laplacian_2d((N, N), dx, dx, device=dev).kernel_desc
    errs = {k: 0.0 for k in ("K1", "K2", "K3", "pass1_3d", "pass2", "bc3d",
                             "K1'", "K2'")}

    def parity_pass1(j, d, ny, nx, P=2, fn=lz.pass1_iso2d, key="K1"):
        W = [field(ny, nx, P) for _ in range(j + 1)]
        scal = scalars(1)
        (w, raw), (w0, raw0) = both(lambda: fn(scal, W[j], W[:j], d))
        fe, de = rel(w, w0), dot_err(raw, raw0, W, w0)
        errs[key] = max(errs[key], float((w - w0).abs().max()))
        return fe, de

    def parity_pipe(j, last, d, ny, nx, P=2, fn=lz.pipe_iso2d, key="K2"):
        av, *W = [field(ny, nx, P) for _ in range(j + 2)]
        scal = scalars(j + 2)
        got, want = both(lambda: fn(scal, av, W, d, last))
        fe = rel(got[0], want[0])
        errs[key] = max(errs[key], float((got[0] - want[0]).abs().max()))
        nsq, gram = (got[1], got[2]) if last else (got[2], got[3])
        nsq0, gram0 = (want[1], want[2]) if last else (want[2], want[3])
        de = max(float((nsq - nsq0).abs().max() / nsq0.abs().max()),
                 dot_err(gram, gram0, W, want[0]))
        if not last:
            fe = max(fe, rel(got[1], want[1]))
            errs[key] = max(errs[key], float((got[1] - want[1]).abs().max()))
            de = max(de, dot_err(got[4], want[4], W + [want[0]], want[1]))
        return fe, de

    def parity_combine(k, ny, nx, P=2, m=KRYLOV_M, key="K3"):
        W = [field(ny, nx, P) for _ in range(m)]
        q = (torch.rand((k, m, 2), generator=gen, device=dev) - 0.5)
        got, want = both(lambda: lz.combine(q, W))
        errs[key] = max([errs[key]] + [float((a - b).abs().max())
                                       for a, b in zip(got, want)])
        return max(rel(a, b) for a, b in zip(got, want)), 0.0

    ragged = operators.laplacian_2d((250, 333), dx, dx, device=dev).kernel_desc
    rag334 = operators.laplacian_2d((250, 334), dx, dx, device=dev).kernel_desc
    rag335 = operators.laplacian_2d((251, 335), dx, dx, device=dev).kernel_desc
    dx4 = 2.0 * LX / (NS - 1)
    desc4 = operators.laplacian_2d((NS, NS), dx4, dx4, device=dev).kernel_desc
    clean = dict(desc, variant="clean")
    cases = [
        ("K1 j=0", lambda: parity_pass1(0, desc, N, N)),
        ("K1 j=3", lambda: parity_pass1(3, desc, N, N)),
        ("K2 j=0", lambda: parity_pipe(0, False, desc, N, N)),
        ("K2 j=4", lambda: parity_pipe(4, False, desc, N, N)),
        (f"K2 j={KRYLOV_M - 2} last",
         lambda: parity_pipe(KRYLOV_M - 2, True, desc, N, N)),
        ("K2 j=3 clean", lambda: parity_pipe(3, False, clean, N, N)),
        ("K2 j=2 real", lambda: parity_pipe(2, False, desc, N, N, P=1)),
        ("K3 k=1", lambda: parity_combine(1, N, N)),
        ("K3 k=2", lambda: parity_combine(2, N, N)),
        ("K1 j=2 250x333", lambda: parity_pass1(2, ragged, 250, 333)),
        # K1 on the walker: every bucket (j up to 31), real fields, the
        # scalar forms (nx % 4 != 0), 4096^2
        ("K1 j=7 real", lambda: parity_pass1(7, desc, N, N, P=1)),
        ("K1 j=12 (m=20)", lambda: parity_pass1(12, desc, N, N)),
        ("K1 j=18 (m=20)", lambda: parity_pass1(18, desc, N, N)),
        ("K1 j=31 clean 250x333",
         lambda: parity_pass1(31, dict(ragged, variant="clean"), 250, 333)),
        ("K1 j=0 250x334", lambda: parity_pass1(0, rag334, 250, 334)),
        ("K1 j=9 real sign -1 251x335",
         lambda: parity_pass1(9, dict(rag335, sign=-1.0), 251, 335, P=1)),
        ("K1 j=0 251x335", lambda: parity_pass1(0, rag335, 251, 335)),
        (f"K1 j=0 {NS}^2", lambda: parity_pass1(0, desc4, NS, NS)),
        (f"K1 j=5 {NS}^2", lambda: parity_pass1(5, desc4, NS, NS)),
        ("K2 j=2 250x333", lambda: parity_pipe(2, False, ragged, 250, 333)),
        ("K2 j=2 last 250x333",
         lambda: parity_pipe(2, True, ragged, 250, 333)),
        ("K3 k=1 250x333", lambda: parity_combine(1, 250, 333)),
        # the 16-byte (nx % 4 == 0) and scalar instantiations of K2 and K3,
        # every bucket (j up to 18, m = 20), P = 1 with sign -1, and 4096^2
        ("K2 j=17 (m=20)", lambda: parity_pipe(17, False, desc, N, N)),
        ("K2 j=12 250x334", lambda: parity_pipe(12, False, rag334, 250,
                                                334)),
        ("K2 j=18 last 251x335", lambda: parity_pipe(18, True, rag335, 251,
                                                     335)),
        ("K2 j=6 real sign -1 251x335",
         lambda: parity_pipe(6, False, dict(rag335, sign=-1.0), 251, 335,
                             P=1)),
        ("K3 k=3 m=20 251x335", lambda: parity_combine(3, 251, 335, m=20)),
        ("K3 k=2 real 250x334", lambda: parity_combine(2, 250, 334, P=1)),
        (f"K2 j=4 {NS}^2", lambda: parity_pipe(4, False, desc4, NS, NS)),
        (f"K2 j={KRYLOV_M - 2} last {NS}^2",
         lambda: parity_pipe(KRYLOV_M - 2, True, desc4, NS, NS)),
        (f"K3 k=4 {NS}^2", lambda: parity_combine(4, NS, NS)),
    ]
    for label, fn in cases:
        gate(label, *fn())

    # fixed grid, fixed order of sums, no atomics: two launches on the same
    # inputs give the same bits
    av, *W = [field() for _ in range(KRYLOV_M)]
    sc = scalars(KRYLOV_M)
    q = torch.rand((2, KRYLOV_M - 1, 2), generator=gen, device=dev) - 0.5
    sc1 = scalars(1)
    for label, fn in (
            ("K1", lambda: lz.pass1_iso2d(sc1, av, W[:5], desc)),
            ("K2", lambda: lz.pipe_iso2d(sc, av, W, desc, False)),
            ("K2 last", lambda: lz.pipe_iso2d(sc, av, W, desc, True)),
            ("K3", lambda: lz.combine(q, W))):
        same = all(bool(torch.equal(a, b)) for a, b in zip(fn(), fn()))
        print(f"repeat {label} at {N}^2: outputs and dots bit for bit equal "
              f"{same}")
        check(same, f"{label}: two launches on the same inputs differ")
    del av, W

    def timed(fn, reps=20):
        t_k = times_ms(torch, fn, reps)
        config.kernel_mode = "off"
        try:
            t_p = times_ms(torch, fn, reps)
        finally:
            config.kernel_mode = "auto"
        return t_k + t_p          # (dev, wall) kernel, (dev, wall) plain

    def show(label, t):
        print(f"time {label}: kernel {t[0]:.4f} ms device ({t[1]:.4f} "
              f"wall), plain {t[2]:.4f} ms device ({t[3]:.4f} wall)")

    def pipe_step(fn, d, scs, av, W):
        """The K2 (K2') launches of one Lanczos run, j = 0..m-2, the last
        one LAST."""
        for j in range(KRYLOV_M - 1):
            fn(scs[j], av, W[:j + 1], d, j == KRYLOV_M - 2)

    def show_graph(key, n, g, t, launches):
        """The graph reading beside the profiler's sum and the events; n is
        the side of a square grid or the grid's name."""
        at = f"{n}^2" if isinstance(n, int) else n
        print(f"time {key} per step at {at}: CUDA-graph replay {g:.4f} ms "
              f"({g / launches:.4f} ms per launch); profiler sum "
              f"{t[0]:.4f} ms; CUDA events around each call {t[1]:.4f} ms")

    def stacked_complex(W):
        """The planar columns as one (m, n) complex64 tensor (set-up of the
        one-call yardsticks, outside the timed calls)."""
        return torch.stack([torch.complex(w[0], w[1]).reshape(-1)
                            for w in W])

    # kernel vs plain time at the main path's shapes (1024^2, m=10)
    col2 = 2 * N * N * 4
    u = field()
    W = [field() for _ in range(KRYLOV_M)]
    av = field()
    one = torch.eye(1, 2, device=dev)
    q1 = torch.rand((1, KRYLOV_M, 2), generator=gen, device=dev) - 0.5
    k1 = timed(lambda: lz.pass1_iso2d(one, u, [], desc))
    k2 = [0.0] * 4
    scs = [scalars(j + 2) for j in range(KRYLOV_M - 1)]
    for j in range(KRYLOV_M - 1):
        t = timed(lambda: lz.pipe_iso2d(scs[j], av, W[:j + 1], desc,
                                        j == KRYLOV_M - 2))
        show(f"K2 j={j}", t)
        k2 = [a + b for a, b in zip(k2, t)]
    k3 = timed(lambda: lz.combine(q1, W))
    Wc = stacked_complex(W)
    qc = torch.complex(q1[..., 0], q1[..., 1])               # (1, m)
    k3_lib = times_ms(torch, lambda: torch.matmul(qc, Wc))[0]
    graphs = {"K1": graph_ms(torch, lambda: lz.pass1_iso2d(one, u, [], desc),
                             200),
              "K2": graph_ms(torch, lambda: pipe_step(lz.pipe_iso2d, desc,
                                                      scs, av, W)),
              "K3": graph_ms(torch, lambda: lz.combine(q1, W)),
              "K3 matmul": graph_ms(torch, lambda: torch.matmul(qc, Wc))}
    del Wc
    times = {"K1": k1, "K2": tuple(k2), "K3": k3}
    for key, t in times.items():
        show(f"{key} per step", t)
    print(f"time K3 one-call yardstick torch.matmul((1, {KRYLOV_M}) c64, "
          f"({KRYLOV_M}, {N * N}) c64): {k3_lib:.4f} ms device")
    show_graph("K1", N, graphs["K1"], times["K1"], 1)
    show_graph("K2", N, graphs["K2"], times["K2"], KRYLOV_M - 1)
    show_graph("K3", N, graphs["K3"], times["K3"], 1)
    print(f"time K3 matmul yardstick at {N}^2 by CUDA-graph replay: "
          f"{graphs['K3 matmul']:.4f} ms")
    # bytes per step: K1 j=0 reads W_0, writes av_0; K2 at j reads av_j and
    # W_0..W_j, writes W_{j+1} and av_{j+1} (the last only W_{j+1}); K3
    # reads m columns, writes 1
    k2_cols = sum(j + 4 for j in range(KRYLOV_M - 2)) + KRYLOV_M + 1
    bytes2 = {"K1": 2 * col2, "K2": k2_cols * col2,
              "K3": (KRYLOV_M + 1) * col2}
    for key in ("K1", "K2", "K3"):
        print(f"bound {key} per step at {N}^2: {bytes2[key] / 1e6:.1f} MB -> "
              f"{bound_ms(bytes2[key]):.4f} ms at 3.35 TB/s; graph reading "
              f"at {bound_ms(bytes2[key]) / graphs[key]:.3f} of it (the "
              f"50 MB L2 holds several 8.4 MB columns)")
    del u, W, av

    # K2 and K3 at 4096^2 (a column is 134 MB: the bytes bound is honest)
    W = [field(NS, NS) for _ in range(KRYLOV_M)]
    av = field(NS, NS)
    t4 = {"K1": times_ms(torch, lambda: lz.pass1_iso2d(one, av, [], desc4),
                         5),
          "K2": times_ms(torch, lambda: pipe_step(lz.pipe_iso2d, desc4, scs,
                                                  av, W), 5),
          "K3": times_ms(torch, lambda: lz.combine(q1, W), 5)}
    Wc = stacked_complex(W)
    qc = torch.complex(q1[..., 0], q1[..., 1])
    g4 = {"K1": graph_ms(torch, lambda: lz.pass1_iso2d(one, av, [], desc4),
                         20),
          "K2": graph_ms(torch, lambda: pipe_step(lz.pipe_iso2d, desc4, scs,
                                                  av, W), 5),
          "K3": graph_ms(torch, lambda: lz.combine(q1, W), 5),
          "K3 matmul": graph_ms(torch, lambda: torch.matmul(qc, Wc), 5)}
    del Wc
    for key, launches_ in (("K1", 1), ("K2", KRYLOV_M - 1), ("K3", 1)):
        show_graph(key, NS, g4[key], t4[key], launches_)
        nb = bytes2[key] * (NS // N) ** 2
        print(f"bound {key} per step at {NS}^2: {nb / 1e6:.1f} MB -> "
              f"{bound_ms(nb):.4f} ms at 3.35 TB/s; graph reading at "
              f"{bound_ms(nb) / g4[key]:.3f} of it")
    print(f"time K3 matmul yardstick at {NS}^2 by CUDA-graph replay: "
          f"{g4['K3 matmul']:.4f} ms")
    del W, av

    # ---------------------------------------------------------- 4. main path
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 4 main path")
    x = torch.linspace(-LX, LX, N, dtype=torch.float32)
    X, Y = torch.meshgrid(x, x, indexing="ij")
    env = torch.exp(-(X ** 2 + Y ** 2) / 4)
    u0 = torch.stack([env * torch.cos(0.5 * X), env * torch.sin(0.5 * X)])
    m_field = torch.ones((N, N))
    prob = problems.nlse_problem("cubic", (N, N), LX, DT, m_field=m_field,
                                 krylov_m=KRYLOV_M, dtype=torch.complex64)
    check(prob.meta["planar_state"], "main path did not take the planar path")
    check(prob.meta["device"] == "cuda", "main path is not on the card")
    state0 = prob.init(u0)
    snaps, freq = 5, 50
    steps = (snaps - 1) * freq
    counters2 = {"K1": lz.pass1_iso2d, "K2": lz.pipe_iso2d, "K3": lz.combine,
                 "kick_bc": kb.phase_kick_bc_planar,
                 "recur": lz.recur_kernel}
    for f in counters2.values():
        f.launches = 0
    t0 = time.perf_counter()
    traj = problems.run(prob, state0, snaps, freq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters2.items()}
    want = {"K1": steps, "K2": (KRYLOV_M - 1) * steps, "K3": steps,
            "kick_bc": 2 * steps, "recur": KRYLOV_M * steps}
    print(f"main: {steps} steps of cubic SS2 at {N}^2 m={KRYLOV_M} in "
          f"{wall:.3f} s; launches {launches}")
    check(launches == want, f"launches {launches} != {want}")
    check(tuple(traj.shape) == (snaps, N, N) and traj.dtype == torch.complex64,
          f"snapshots {tuple(traj.shape)} {traj.dtype}")
    check(bool(torch.isfinite(torch.view_as_real(traj)).all()),
          "non-finite snapshot")
    mass = (traj.abs().double() ** 2).sum(dim=(1, 2))
    drift = float(((mass - mass[0]).abs() / mass[0]).max())
    print(f"main: relative mass drift over {steps} steps {drift:.3e}")
    check(drift < 1e-3, f"mass drift {drift:.3e} >= 1e-3")
    del traj

    # ---------------------------------------------------------- 5. paths
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 5 paths")
    n_par = 20
    auto = prob.observe(advance(prob.step, state0, n_par))
    config.kernel_mode = "off"
    try:
        plain = prob.observe(advance(prob.step, state0, n_par))
        lap = operators.laplacian_2d((N, N), dx, dx, device=dev)
        rho = nlse_density("cubic", m_field.to(dev))

        def complex_step(z, i):
            return boundaries.neumann_no_velocity_2d(
                nlse.ss2_step(z, lap, rho, DT, m=KRYLOV_M))

        cpath = advance(complex_step, prob.observe(state0), n_par)
    finally:
        config.kernel_mode = "auto"
    e_kp, e_pc = rel(auto, plain), rel(plain, cpath)
    print(f"paths: {n_par} steps kernels vs plain planar rel-L2 {e_kp:.3e}; "
          f"plain planar vs complex ss2_step rel-L2 {e_pc:.3e}")
    check(e_kp <= 1e-5, f"kernel vs plain path rel-L2 {e_kp:.3e} > 1e-5")
    check(e_pc <= 2e-4, f"planar vs complex path rel-L2 {e_pc:.3e} > 2e-4")
    del auto, plain, cpath

    # ---------------------------------------------------------- 6. rate
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 6 rate")
    rate(torch, {"rate": (prob, state0)}, 200, ["rate"] * 3, 20)
    n_eigh = host_syncs(torch, lambda: torch.linalg.eigh(
        torch.eye(KRYLOV_M, device=dev)))
    print(f"rate: host syncs in one {KRYLOV_M}x{KRYLOV_M} torch.linalg.eigh "
          f"alone: {n_eigh}")
    del prob, state0

    # ---------------------------------------------------------- 7. parity3d
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 7 parity3d")
    def ops3d(shape, c=None):
        """The main path's three 3D operator descriptors on `shape`."""
        d3 = 2.0 * LX / (shape[-1] - 1)
        if c is None:
            c = 1.0 + 0.4 * torch.rand(shape, generator=gen, device=dev)
        return {"iso": operators.laplacian_3d(shape, d3,
                                              device=dev).kernel_desc,
                "clean": operators.laplacian_3d(shape, d3, variant="clean",
                                                device=dev).kernel_desc,
                "aniso": operators.anisotropic_laplacian_3d(
                    c, d3, device=dev).kernel_desc}

    def parity_pass1_3d(j, d, R, nx, P=2, key="pass1_3d"):
        W = [field(R, nx, P) for _ in range(j + 1)]
        scal = torch.tensor([[0.7, 0.3]], device=dev)
        (w, raw), (w0, raw0) = both(lambda: l3.pass1_3d(scal, W[j], W[:j], d))
        errs[key] = max(errs[key], float((w - w0).abs().max()))
        return rel(w, w0), dot_err(raw, raw0, W, w0)

    def parity_pass2(j, R, nx, P=2, key="pass2"):
        w, *W = [field(R, nx, P) for _ in range(j + 2)]
        q = torch.rand((j + 1, 2), generator=gen, device=dev) - 0.5
        (a, n1), (b, n0) = both(lambda: l3.pass2(q, w, W))
        errs[key] = max(errs[key], float((a - b).abs().max()))
        return rel(a, b), float((n1 - n0).abs().max() / n0.abs().max())

    for shape in ((N3, N3, N3), (37, 50, 61)):
        R, nx = shape[0] * shape[1], shape[2]
        tag = "x".join(map(str, shape))
        for mode, d in ops3d(shape).items():
            for j in (0, 4, 8):
                gate(f"pass1_3d {mode} j={j} {tag}",
                     *parity_pass1_3d(j, d, R, nx))
        for j in (0, 4, 8):
            gate(f"pass2 j={j} {tag}", *parity_pass2(j, R, nx))
        up = field(R, nx)
        got, want = both(lambda: b3.neumann_bc_planar_3d(up.clone(), shape))
        torch.cuda.synchronize()
        same = bool(torch.equal(got, want))
        print(f"parity bc3d {tag}: exactly equal {same}")
        check(same, f"bc3d {tag} differs from its plain version")
        del up, got, want

    # 3D times per step of the main path (128^3, m=10, iso reference)
    shape3 = (N3, N3, N3)
    R3 = N3 * N3
    col3 = 2 * R3 * N3 * 4
    d3 = ops3d(shape3)
    W = [field(R3, N3) for _ in range(KRYLOV_M)]
    w = field(R3, N3)
    scal = torch.tensor([[0.7, 0.3]], device=dev)
    Wc = stacked_complex(W)
    wc = torch.complex(w[0], w[1]).reshape(1, -1)
    t3 = {"pass1_3d": [0.0] * 4, "pass1_3d aniso": [0.0] * 4,
          "pass2": [0.0] * 4}
    pass2_lib = 0.0
    for j in range(KRYLOV_M - 1):
        for key, d in (("pass1_3d", d3["iso"]),
                       ("pass1_3d aniso", d3["aniso"])):
            t = timed(lambda: l3.pass1_3d(scal, W[j], W[:j], d))
            show(f"{key} j={j}", t)
            t3[key] = [a + b for a, b in zip(t3[key], t)]
        q = torch.rand((j + 1, 2), generator=gen, device=dev) - 0.5
        t = timed(lambda: l3.pass2(q, w, W[:j + 1]))
        show(f"pass2 j={j}", t)
        t3["pass2"] = [a + b for a, b in zip(t3["pass2"], t)]
        qc = torch.complex(q[:, 0], q[:, 1]).reshape(1, -1)
        lib = times_ms(torch, lambda: torch.addmm(wc, qc, Wc[:j + 1],
                                                  alpha=-1))[0]
        print(f"time pass2 j={j} one-call yardstick torch.addmm (leaves out "
              f"the norm): {lib:.4f} ms device")
        pass2_lib += lib
    # the run's start norm: pass2's norm-only form, one launch per step
    t = timed(lambda: l3.pass2(None, W[0], []))
    show("pass2 norm", t)
    t3["pass2"] = [a + b for a, b in zip(t3["pass2"], t)]
    t3["combine 128^3"] = timed(lambda: lz.combine(q1, W))
    qc = torch.complex(q1[..., 0], q1[..., 1])
    combine3_lib = times_ms(torch, lambda: torch.matmul(qc, Wc))[0]
    g3d = {"K3": graph_ms(torch, lambda: lz.combine(q1, W)),
           "K3 matmul": graph_ms(torch, lambda: torch.matmul(qc, Wc))}
    up = field(R3, N3)
    t3["bc3d"] = timed(lambda: b3.neumann_bc_planar_3d(up, shape3))
    for key, t in t3.items():
        show(f"{key} per step", t)
    print(f"time pass2 one-call yardsticks per step: {pass2_lib:.4f} ms; "
          f"combine 128^3 torch.matmul: {combine3_lib:.4f} ms device")
    print(f"time combine 128^3 by CUDA-graph replay: {g3d['K3']:.4f} ms; "
          f"torch.matmul by CUDA-graph replay: {g3d['K3 matmul']:.4f} ms")
    bc_cells = (2 * N3 * N3 + 2 * (N3 - 2) * N3 + 2 * (N3 - 2) * (N3 - 2))
    # bytes per step: pass1 at j reads W_0..W_j and writes w (aniso also
    # reads three weight planes); pass2 at j reads w and W_0..W_j and writes
    # W_{j+1}, its norm-only form reads W_0; bc3d reads and writes the face
    # cells
    bytes3 = {"pass1_3d": sum(j + 2 for j in range(KRYLOV_M - 1)) * col3,
              "pass1_3d aniso": (sum(j + 2 for j in range(KRYLOV_M - 1))
                                 + 1.5 * (KRYLOV_M - 1)) * col3,
              "pass2": (sum(j + 3 for j in range(KRYLOV_M - 1)) + 1) * col3,
              "combine 128^3": (KRYLOV_M + 1) * col3,
              "bc3d": bc_cells * 2 * 4 * 2}
    for key, nb in bytes3.items():
        print(f"bound {key} per step: {nb / 1e6:.1f} MB -> "
              f"{bound_ms(nb):.4f} ms at 3.35 TB/s; kernel at "
              f"{bound_ms(nb) / t3[key][0]:.3f} of it")
    del W, w, Wc, wc, up, d3

    # ---------------------------------------------------------- 8. main3d
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 8 main3d")
    def problem3d(n, c=None, integrator="ss2"):
        prob = problems.nlse_problem("cubic", (n, n, n), LX, DT,
                                     m_field=torch.ones((n, n, n)),
                                     c_field=c, krylov_m=KRYLOV_M,
                                     integrator=integrator)
        check(prob.meta["planar_state"] and prob.meta["device"] == "cuda",
              f"3D problem at {n}^3 did not take the planar path on the card")
        x = torch.linspace(-LX, LX, n, dtype=torch.float32, device=dev)
        Z, Y, X = torch.meshgrid(x, x, x, indexing="ij")
        env = torch.exp(-(X ** 2 + Y ** 2 + Z ** 2) / 4)
        u0 = torch.stack([env * torch.cos(0.5 * X), env * torch.sin(0.5 * X)])
        return prob, prob.init(u0)

    counters3 = {"pass1_3d": l3.pass1_3d, "pass2": l3.pass2,
                 "combine": lz.combine, "bc3d": b3.neumann_bc_planar_3d,
                 "kick_bc": kb.phase_kick_bc_planar}
    # both half kicks are kick_bc, the closing one with the ghost copy; the
    # Lanczos run's start norm is one more pass2 (its norm-only form)
    per_step3 = {"pass1_3d": KRYLOV_M - 1, "pass2": KRYLOV_M,
                 "combine": 1, "bc3d": 0, "kick_bc": 2}
    c3 = torch.from_numpy((1.0 + 0.4 * np.random.default_rng(0).random(
        shape3)).astype(np.float32))

    def main3d(label, prob, state0, snaps, freq):
        steps = (snaps - 1) * freq
        for f in counters3.values():
            f.launches = 0
        t0 = time.perf_counter()
        traj = problems.run(prob, state0, snaps, freq)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: f.launches for k, f in counters3.items()}
        want = {k: v * steps for k, v in per_step3.items()}
        print(f"{label}: {steps} steps at {N3}^3 m={KRYLOV_M} in {wall:.3f} "
              f"s; launches {got} ({sum(got.values()) / steps:.0f} per step)")
        check(got == want, f"{label}: launches {got} != {want}")
        check(tuple(traj.shape) == (snaps,) + shape3, f"{label}: snapshots "
              f"{tuple(traj.shape)}")
        check(bool(torch.isfinite(torch.view_as_real(traj)).all()),
              f"{label}: non-finite snapshot")
        mass = (traj.abs().double() ** 2).sum(dim=(1, 2, 3))
        drift = float(((mass - mass[0]).abs() / mass[0]).max())
        print(f"{label}: relative mass drift over {steps} steps {drift:.3e}")
        check(drift < 1e-3, f"{label}: mass drift {drift:.3e} >= 1e-3")
        return got

    prob3, s3 = problem3d(N3)
    snaps3, freq3 = 5, 50
    steps3 = (snaps3 - 1) * freq3
    launches3 = main3d("main3d iso", prob3, s3, snaps3, freq3)
    prob3c, s3c = problem3d(N3, c3)
    main3d("main3d c(x)", prob3c, s3c, 3, 50)

    # the standalone bc3d runs after the 3D two-step steps, which no kick
    # closes: sEWI at 128^3, the bootstrap (an SS2 step) then sEWI steps
    prob3s, s3s = problem3d(N3, integrator="sewi")
    steps3s = 20
    for f in counters3.values():
        f.launches = 0
    t0 = time.perf_counter()
    s = advance(prob3s.step, s3s, steps3s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches3s = {k: f.launches for k, f in counters3.items()}
    boot3 = dict(per_step3)
    per_sewi3 = {"pass1_3d": 3 * (KRYLOV_M - 1), "pass2": 3 * KRYLOV_M,
                 "combine": 3, "bc3d": 1, "kick_bc": 0}
    want = {k: boot3[k] + (steps3s - 1) * v for k, v in per_sewi3.items()}
    print(f"main3d sewi: {steps3s} steps of cubic sEWI at {N3}^3 in "
          f"{wall:.3f} s; launches {launches3s} (bootstrap {boot3}, then "
          f"{per_sewi3} per step)")
    check(launches3s == want, f"main3d sewi: launches {launches3s} != {want}")
    check(finite(torch, s), "main3d sewi: non-finite state")
    del prob3s, s3s, s

    # ---------------------------------------------------------- 9. paths3d
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 9 paths3d")
    for label, prob, s0, c in (("iso", prob3, s3, None),
                               ("c(x)", prob3c, s3c, c3)):
        auto = prob.observe(advance(prob.step, s0, n_par))
        config.kernel_mode = "off"
        try:
            plain = prob.observe(advance(prob.step, s0, n_par))
            d3x = 2.0 * LX / (N3 - 1)
            lap = (operators.laplacian_3d(shape3, d3x, device=dev)
                   if c is None else
                   operators.anisotropic_laplacian_3d(c, d3x, device=dev))
            rho = nlse_density("cubic", torch.ones(shape3, device=dev))

            def complex_step(z, i):
                return boundaries.neumann_no_velocity_3d(
                    nlse.ss2_step(z, lap, rho, DT, m=KRYLOV_M))

            cpath = advance(complex_step, prob.observe(s0), n_par)
        finally:
            config.kernel_mode = "auto"
        e_kp, e_pc = rel(auto, plain), rel(plain, cpath)
        print(f"paths3d {label}: {n_par} steps kernels vs plain planar "
              f"rel-L2 {e_kp:.3e}; plain planar vs complex ss2_step rel-L2 "
              f"{e_pc:.3e}")
        check(e_kp <= 1e-5, f"3D {label} kernel vs plain path rel-L2 "
              f"{e_kp:.3e} > 1e-5")
        check(e_pc <= 2e-4, f"3D {label} planar vs complex path rel-L2 "
              f"{e_pc:.3e} > 2e-4")
        del auto, plain, cpath

    # ---------------------------------------------------------- 10. rate3d
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 10 rate3d")
    iso, cx = f"rate3d iso {N3}^3", f"rate3d c(x) {N3}^3"
    rate(torch, {iso: (prob3, s3), cx: (prob3c, s3c)}, 100,
         [iso, cx, cx, iso, iso, cx, iso, iso], 20, host_profile=True)
    del prob3, s3, prob3c, s3c
    prob_big, s_big = problem3d(N3_BIG)
    big = f"rate3d iso {N3_BIG}^3"
    rate(torch, {big: (prob_big, s_big)}, 20, [big] * 3, 5)
    del prob_big, s_big

    # ---------------------------------------------------------- 11. parity2d-aniso
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 11 parity2d-aniso")
    # c = 1 + 0.4 U[0, 1) from default_rng(0), as benchmarks/perf_table.py's
    # nlse2d_1024_ss2_aniso row
    c2 = torch.from_numpy((1.0 + 0.4 * np.random.default_rng(0).random(
        (N, N))).astype(np.float32))
    desc_a = operators.anisotropic_laplacian_2d(c2, dx, dx,
                                                device=dev).kernel_desc
    ragged_a = operators.anisotropic_laplacian_2d(
        1.0 + 0.4 * torch.rand((250, 333), generator=gen, device=dev), dx, dx,
        device=dev).kernel_desc
    rag_a334, rag_a335 = (operators.anisotropic_laplacian_2d(
        1.0 + 0.4 * torch.rand(shp, generator=gen, device=dev), dx, dx,
        device=dev).kernel_desc for shp in ((250, 334), (251, 335)))
    desc4a = operators.anisotropic_laplacian_2d(
        torch.from_numpy((1.0 + 0.4 * np.random.default_rng(0).random(
            (NS, NS))).astype(np.float32)), dx4, dx4, device=dev).kernel_desc
    a1 = dict(fn=lz.pass1_aniso2d, key="K1'")
    a2 = dict(fn=lz.pipe_aniso2d, key="K2'")
    cases = [
        ("K1' j=0", lambda: parity_pass1(0, desc_a, N, N, **a1)),
        ("K1' j=4", lambda: parity_pass1(4, desc_a, N, N, **a1)),
        ("K1' j=8", lambda: parity_pass1(8, desc_a, N, N, **a1)),
        ("K1' j=18", lambda: parity_pass1(18, desc_a, N, N, **a1)),
        ("K1' j=4 real", lambda: parity_pass1(4, desc_a, N, N, P=1, **a1)),
        ("K2' j=0", lambda: parity_pipe(0, False, desc_a, N, N, **a2)),
        ("K2' j=4", lambda: parity_pipe(4, False, desc_a, N, N, **a2)),
        ("K2' j=8", lambda: parity_pipe(8, False, desc_a, N, N, **a2)),
        (f"K2' j={KRYLOV_M - 2} last",
         lambda: parity_pipe(KRYLOV_M - 2, True, desc_a, N, N, **a2)),
        ("K2' j=12 (m=20)", lambda: parity_pipe(12, False, desc_a, N, N,
                                                **a2)),
        ("K2' j=17 (m=20)", lambda: parity_pipe(17, False, desc_a, N, N,
                                                **a2)),
        ("K2' j=18 last (m=20)", lambda: parity_pipe(18, True, desc_a, N, N,
                                                     **a2)),
        ("K2' j=0 real", lambda: parity_pipe(0, False, desc_a, N, N, P=1,
                                             **a2)),
        ("K2' j=8 real", lambda: parity_pipe(8, False, desc_a, N, N, P=1,
                                             **a2)),
        ("K1' j=2 250x333", lambda: parity_pass1(2, ragged_a, 250, 333,
                                                 **a1)),
        ("K1' j=0 250x333", lambda: parity_pass1(0, ragged_a, 250, 333,
                                                 **a1)),
        ("K1' j=25 250x334", lambda: parity_pass1(25, rag_a334, 250, 334,
                                                  **a1)),
        ("K1' j=3 real sign -1 251x335",
         lambda: parity_pass1(3, dict(rag_a335, sign=-1.0), 251, 335, P=1,
                              **a1)),
        ("K1' j=0 251x335", lambda: parity_pass1(0, rag_a335, 251, 335,
                                                 **a1)),
        ("K2' j=2 250x333", lambda: parity_pipe(2, False, ragged_a, 250, 333,
                                                **a2)),
        ("K2' j=2 last 250x333",
         lambda: parity_pipe(2, True, ragged_a, 250, 333, **a2)),
        ("K2' j=18 250x333", lambda: parity_pipe(18, False, ragged_a, 250,
                                                 333, **a2)),
        ("K2' j=4 real 250x333",
         lambda: parity_pipe(4, False, ragged_a, 250, 333, P=1, **a2)),
        ("K2' j=12 250x334", lambda: parity_pipe(12, False, rag_a334, 250,
                                                 334, **a2)),
        ("K2' j=7 last 251x335", lambda: parity_pipe(7, True, rag_a335, 251,
                                                     335, **a2)),
        ("K2' j=3 real sign -1 251x335",
         lambda: parity_pipe(3, False, dict(rag_a335, sign=-1.0), 251, 335,
                             P=1, **a2)),
    ]
    for label, fn in cases:
        gate(label, *fn())
    Wr = [field() for _ in range(5)]
    same = all(bool(torch.equal(a, b)) for a, b in zip(
        lz.pass1_aniso2d(sc1, Wr[4], Wr[:4], desc_a),
        lz.pass1_aniso2d(sc1, Wr[4], Wr[:4], desc_a)))
    print(f"repeat K1' at {N}^2: outputs and dots bit for bit equal {same}")
    check(same, "K1': two launches on the same inputs differ")
    del ragged_a, rag_a334, rag_a335, Wr

    # K1' and K2' per step of the main2d-aniso path (1024^2, m=10)
    u = field()
    W = [field() for _ in range(KRYLOV_M)]
    av = field()
    ka1 = timed(lambda: lz.pass1_aniso2d(one, u, [], desc_a))
    ka2 = [0.0] * 4
    for j in range(KRYLOV_M - 1):
        t = timed(lambda: lz.pipe_aniso2d(scs[j], av, W[:j + 1], desc_a,
                                          j == KRYLOV_M - 2))
        show(f"K2' j={j}", t)
        ka2 = [a + b for a, b in zip(ka2, t)]
    times_a = {"K1'": ka1, "K2'": tuple(ka2)}
    graphs["K1'"] = graph_ms(torch, lambda: lz.pass1_aniso2d(one, u, [],
                                                             desc_a), 200)
    graphs["K2'"] = graph_ms(torch, lambda: pipe_step(lz.pipe_aniso2d,
                                                      desc_a, scs, av, W))
    show_graph("K1'", N, graphs["K1'"], times_a["K1'"], 1)
    show_graph("K2'", N, graphs["K2'"], times_a["K2'"], KRYLOV_M - 1)
    # bytes per step: K1' reads W_0 and the two weight planes, writes av_0;
    # K2' as K2, plus the two weight planes at every iteration but the last
    wplane = N * N * 4
    bytes_a = {"K1'": 2 * col2 + 2 * wplane,
               "K2'": k2_cols * col2 + 2 * (KRYLOV_M - 2) * wplane}
    for key, t in times_a.items():
        show(f"{key} per step", t)
        nb = bytes_a[key]
        print(f"bound {key} per step: {nb / 1e6:.1f} MB -> "
              f"{bound_ms(nb):.4f} ms at 3.35 TB/s; kernel at "
              f"{bound_ms(nb) / t[0]:.3f} of it (profiler), "
              f"{bound_ms(nb) / graphs[key]:.3f} (graph)")
    del u, W, av

    # K2' at 4096^2
    W = [field(NS, NS) for _ in range(KRYLOV_M)]
    av = field(NS, NS)
    gate(f"K2' j=8 {NS}^2", *parity_pipe(8, False, desc4a, NS, NS, **a2))
    gate(f"K1' j=0 {NS}^2", *parity_pass1(0, desc4a, NS, NS, **a1))
    gate(f"K1' j=6 {NS}^2", *parity_pass1(6, desc4a, NS, NS, **a1))
    t4["K1'"] = times_ms(torch, lambda: lz.pass1_aniso2d(one, av, [],
                                                         desc4a), 5)
    g4["K1'"] = graph_ms(torch, lambda: lz.pass1_aniso2d(one, av, [],
                                                         desc4a), 20)
    show_graph("K1'", NS, g4["K1'"], t4["K1'"], 1)
    nb, ga = bytes_a["K1'"] * (NS // N) ** 2, g4["K1'"]
    print(f"bound K1' per step at {NS}^2: {nb / 1e6:.1f} MB -> "
          f"{bound_ms(nb):.4f} ms at 3.35 TB/s; graph reading at "
          f"{bound_ms(nb) / ga:.3f} of it")
    t4["K2'"] = times_ms(torch, lambda: pipe_step(lz.pipe_aniso2d, desc4a,
                                                  scs, av, W), 5)
    g4["K2'"] = graph_ms(torch, lambda: pipe_step(lz.pipe_aniso2d, desc4a,
                                                  scs, av, W), 5)
    show_graph("K2'", NS, g4["K2'"], t4["K2'"], KRYLOV_M - 1)
    nb = bytes_a["K2'"] * (NS // N) ** 2
    ga = g4["K2'"]
    print(f"bound K2' per step at {NS}^2: {nb / 1e6:.1f} MB -> "
          f"{bound_ms(nb):.4f} ms at 3.35 TB/s; graph reading at "
          f"{bound_ms(nb) / ga:.3f} of it")
    del W, av, desc4a

    # ---------------------------------------------------------- 12. main2d-aniso
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 12 main2d-aniso")
    counters2a = {"K1": lz.pass1_iso2d, "K2": lz.pipe_iso2d,
                  "K1'": lz.pass1_aniso2d, "K2'": lz.pipe_aniso2d,
                  "K3": lz.combine, "kick_bc": kb.phase_kick_bc_planar,
                  "recur": lz.recur_kernel}

    def counted(fn):
        for f in counters2a.values():
            f.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, {
            k: f.launches for k, f in counters2a.items()}

    def problem2d(integrator="ss2", c=c2):
        prob = problems.nlse_problem("cubic", (N, N), LX, DT,
                                     m_field=m_field, c_field=c,
                                     krylov_m=KRYLOV_M, integrator=integrator,
                                     dtype=torch.complex64)
        check(prob.meta["planar_state"] and prob.meta["device"] == "cuda",
              f"2D {integrator} did not take the planar path on the card")
        return prob, prob.init(u0)

    def mass_drift(traj):
        mass = (traj.abs().double() ** 2).sum(dim=(1, 2))
        return float(((mass - mass[0]).abs() / mass[0]).max())

    prob_a, state_a = problem2d()
    traj, wall, launches_a = counted(
        lambda: problems.run(prob_a, state_a, snaps, freq))
    want = {"K1": 0, "K2": 0, "K1'": steps, "K2'": (KRYLOV_M - 1) * steps,
            "K3": steps, "kick_bc": 2 * steps, "recur": KRYLOV_M * steps}
    print(f"main2d-aniso: {steps} steps of cubic SS2 with c(x) at {N}^2 "
          f"m={KRYLOV_M} in {wall:.3f} s; launches {launches_a}")
    check(launches_a == want, f"main2d-aniso: launches {launches_a} != "
          f"{want}")
    check(tuple(traj.shape) == (snaps, N, N) and traj.dtype == torch.complex64,
          f"main2d-aniso: snapshots {tuple(traj.shape)} {traj.dtype}")
    check(bool(torch.isfinite(torch.view_as_real(traj)).all()),
          "main2d-aniso: non-finite snapshot")
    drift = mass_drift(traj)
    print(f"main2d-aniso: relative mass drift over {steps} steps "
          f"{drift:.3e}")
    check(drift < 1e-3, f"main2d-aniso: mass drift {drift:.3e} >= 1e-3")
    del traj

    # ---------------------------------------------------------- 13. sewi2d
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 13 sewi2d")
    prob_s, state_s = problem2d("sewi")
    _, _, boot = counted(lambda: prob_s.step(state_s, 1))
    want_boot = {"K1": 0, "K2": 0, "K1'": 1, "K2'": KRYLOV_M - 1, "K3": 1,
                 "kick_bc": 2, "recur": KRYLOV_M}
    check(boot == want_boot, f"sewi2d: bootstrap launches {boot} != "
          f"{want_boot}")
    snaps_s, freq_s = 5, 25
    steps_s = (snaps_s - 1) * freq_s
    traj, wall, got = counted(
        lambda: problems.run(prob_s, state_s, snaps_s, freq_s))
    per_step = {"K1": 0, "K2": 0, "K1'": 3, "K2'": 3 * (KRYLOV_M - 1),
                "K3": 3, "kick_bc": 0, "recur": 3 * KRYLOV_M}
    want = {k: boot[k] + (steps_s - 1) * v for k, v in per_step.items()}
    print(f"sewi2d: {steps_s} steps of cubic sEWI with c(x) at {N}^2 "
          f"m={KRYLOV_M} in {wall:.3f} s; launches {got} (bootstrap "
          f"{boot}, then {per_step} per step)")
    check(got == want, f"sewi2d: launches {got} != {want}")
    check(bool(torch.isfinite(torch.view_as_real(traj)).all()),
          "sewi2d: non-finite snapshot")
    print(f"sewi2d: relative mass drift over {steps_s} steps "
          f"{mass_drift(traj):.3e} (not gated: sEWI does not conserve it "
          f"exactly)")
    del traj

    # ---------------------------------------------------------- 14. paths2d-aniso
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 14 paths2d-aniso")
    lap_a = operators.anisotropic_laplacian_2d(c2, dx, dx, device=dev)
    rho = nlse_density("cubic", m_field.to(dev))
    two_step = {"sewi": nlse.sewi_step,
                "sewi_fused": partial(nlse.sewi_step, fuse_exp_sinc=True),
                "gautschi": nlse.gautschi_step}

    def complex_run(integrator, lap, neum, z, n):
        """n steps of the complex path from z: the package's complex
        steppers, whose Lanczos is ops/krylov's generic one under
        kernel_mode "off"; a two-step integrator takes one SS2 step at
        step 1."""
        z_prev = z
        for i in range(1, n + 1):
            if integrator == "ss2" or i == 1:
                z, z_prev = neum(nlse.ss2_step(z, lap, rho, DT,
                                               m=KRYLOV_M)), z
            else:
                zn, z_prev = two_step[integrator](z, z_prev, lap, rho, DT,
                                                  m=KRYLOV_M)
                z = neum(zn)
        return z

    for integ in ("ss2", "sewi", "sewi_fused", "gautschi"):
        prob_i, s0 = problem2d(integ)
        auto = prob_i.observe(advance(prob_i.step, s0, n_par))
        config.kernel_mode = "off"
        try:
            plain = prob_i.observe(advance(prob_i.step, s0, n_par))
            cpath = complex_run(integ, lap_a, boundaries.neumann_no_velocity_2d,
                                prob_i.observe(prob_i.init(u0)), n_par)
        finally:
            config.kernel_mode = "auto"
        e_kp, e_pc = rel(auto, plain), rel(plain, cpath)
        print(f"paths2d-aniso {integ}: {n_par} steps kernels vs plain planar "
              f"rel-L2 {e_kp:.3e}; plain planar vs complex path rel-L2 "
              f"{e_pc:.3e}")
        check(e_kp <= 1e-5, f"2D c(x) {integ} kernel vs plain path rel-L2 "
              f"{e_kp:.3e} > 1e-5")
        check(e_pc <= 2e-4, f"2D c(x) {integ} planar vs complex path rel-L2 "
              f"{e_pc:.3e} > 2e-4")
        del prob_i, s0, auto, plain, cpath
    n_par3 = 10
    prob3s, s3s = problem3d(N3, integrator="sewi")
    auto = prob3s.observe(advance(prob3s.step, s3s, n_par3))
    config.kernel_mode = "off"
    try:
        plain = prob3s.observe(advance(prob3s.step, s3s, n_par3))
    finally:
        config.kernel_mode = "auto"
    e_kp = rel(auto, plain)
    print(f"paths3d sewi: {n_par3} steps at {N3}^3 kernels vs plain planar "
          f"rel-L2 {e_kp:.3e}")
    check(e_kp <= 1e-5, f"3D sEWI kernel vs plain path rel-L2 {e_kp:.3e} > "
          f"1e-5")
    del prob3s, s3s, auto, plain

    # ---------------------------------------------------------- 15. rate2d-aniso
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 15 rate2d-aniso")
    prob_iso, state_iso = problem2d(c=None)
    iso2, cx2 = f"rate2d iso {N}^2", f"rate2d c(x) {N}^2"
    rates2a = rate(torch, {iso2: (prob_iso, state_iso),
                           cx2: (prob_a, state_a)}, 200,
                   [iso2, cx2, cx2, iso2, iso2, cx2], 20)
    del prob_iso, state_iso
    sw2 = f"rate2d c(x) sewi {N}^2"
    rate(torch, {sw2: (prob_s, state_s)}, 50, [sw2] * 3, 10)
    del prob_a, state_a, prob_s, state_s

    # ---------------------------------------------------------- 16. parity-optin
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 16 parity-optin")
    errs.update({"K13": 0.0, "K5": 0.0, "K8": 0.0})
    mf1 = m_field.to(dev)
    ug = u0.to(dev).contiguous()               # the main path's initial field

    def parity_resident(u, mf, d, m, **kw):
        sc = {}
        got, want = both(lambda: rs.ss2_resident_step(u, mf, d, DT, m,
                                                      scratch=sc, **kw))
        errs["K13"] = max(errs["K13"], float((got - want).abs().max()))
        return rel(got, want), 0.0

    def k5_form(d, rows, nx, P, j):
        """K5's form of w and grid for a call on fresh (aligned) fields."""
        onchip, grid = lz.iter_form(P, rows, nx, lz._iter_opk(d, "k5"), j,
                                    nx % 4 == 0)
        return f"{'on-chip' if onchip else 'global'} w, {grid} blocks"

    def parity_iter(j, d, rows, nx, P=2):
        print(f"K5 j={j} P={P} {rows}x{nx}: {k5_form(d, rows, nx, P, j)}")
        W = [field(rows, nx, P) for _ in range(j + 1)]
        # inverse norms near 1/||W_i||, as the loop passes them, so that
        # the fields keep the loop's magnitudes
        sv = ((0.5 + 0.5 * torch.rand(j + 1, generator=gen, device=dev))
              / torch.stack([w.norm() for w in W]))
        scal = torch.cat([torch.stack([sv[j], sv[0] * 0 + 0.3]), sv])[None]
        scal = scal.contiguous()
        (wn, raw, nsq), (wn0, raw0, nsq0) = both(
            lambda: lz.iter_step(scal, W[j], W[:j], d))
        w0 = scal[0, 0] * lz._operator_ref(W[j], d)
        if j > 0:
            w0 = w0 - scal[0, 1] * W[j - 1]
        errs["K5"] = max(errs["K5"], float((wn - wn0).abs().max()))
        return rel(wn, wn0), max(dot_err(raw, raw0, W, w0),
                                 float((nsq - nsq0).abs().max()
                                       / nsq0.abs().max()))

    def pipe3(scal, av, W, d, last):
        return l3.pipe_3d(scal, av, W, d)

    k8 = dict(fn=pipe3, key="K8")
    R3 = N3 * N3
    d3b, d3r = ops3d((N3, N3, N3)), ops3d((20, 30, 50))
    ragged_cl = operators.laplacian_2d((250, 333), dx, dx, variant="clean",
                                       device=dev).kernel_desc
    ragged_an = operators.anisotropic_laplacian_2d(
        1.0 + 0.4 * torch.rand((250, 333), generator=gen, device=dev), dx, dx,
        device=dev).kernel_desc
    mf_r = 1.0 + 0.2 * torch.rand((250, 333), generator=gen, device=dev)
    u_r = field(250, 333)

    def desc2(ny, nx, variant):
        """The 2D Laplacian at the main path's spacing (theta 2.09)."""
        return operators.laplacian_2d((ny, nx), dx, dx, variant=variant,
                                      device=dev).kernel_desc

    # K5's global form (w in a device scratch): 2048^2 complex, which
    # FUSED_ITER_BYTES admits, and 160^3; the largest square 2D complex
    # grid (a multiple of 64) whose w stays on chip
    N5 = 2 * N
    dx5 = 2.0 * LX / (N5 - 1)
    desc5 = operators.laplacian_2d((N5, N5), dx5, dx5,
                                   device=dev).kernel_desc
    desc5a = operators.anisotropic_laplacian_2d(
        1.0 + 0.4 * torch.rand((N5, N5), generator=gen, device=dev), dx5,
        dx5, device=dev).kernel_desc
    n_chip = max(n for n in range(64, N5 + 1, 64)
                 if lz.iter_form(2, n, n, 0, KRYLOV_M - 2, True)[0])
    desc_chip = desc2(n_chip, n_chip, "reference")
    d3g = ops3d((160, 160, 160))
    print(f"K5 forms of w (iso2d, m={KRYLOV_M}): {N}^2 "
          f"{k5_form(desc, N, N, 2, KRYLOV_M - 2)}; {n_chip}^2 (the largest "
          f"on-chip square) {k5_form(desc_chip, n_chip, n_chip, 2, 8)}; "
          f"{N5}^2 {k5_form(desc5, N5, N5, 2, KRYLOV_M - 2)}; {N3}^3 "
          f"{k5_form(d3b['iso'], R3, N3, 2, KRYLOV_M - 2)}; 160^3 "
          f"{k5_form(d3g['iso'], 160 * 160, 160, 2, KRYLOV_M - 2)}")
    check(not lz.iter_form(2, N5, N5, 0, KRYLOV_M - 2, True)[0]
          and lz.iter_form(2, N, N, 0, KRYLOV_M - 2, True)[0],
          f"K5: {N}^2 must keep w on chip and {N5}^2 must not")
    cases = [
        ("K13 1024^2 m=10", lambda: parity_resident(ug, mf1, desc, KRYLOV_M)),
        ("K13 1024^2 m=10 random field",
         lambda: parity_resident(field(), mf1, desc, KRYLOV_M)),
        ("K13 250x333 clean cubic_quintic m=20 no ghost ring",
         lambda: parity_resident(u_r, mf_r, ragged_cl, 20,
                                 kind="cubic_quintic", apply_bc=False)),
        ("K13 250x333 saturable m=10",
         lambda: parity_resident(u_r, mf_r, ragged, KRYLOV_M,
                                 kind="saturable")),
    ] + [
        (f"K13 {ny}x{nx} {kind} {variant} m={m}"
         f"{'' if bc else ' no ghost ring'}",
         lambda ny=ny, nx=nx, kind=kind, variant=variant, m=m, bc=bc:
         parity_resident(field(ny, nx), 1.0 + 0.2 * torch.rand(
             (ny, nx), generator=gen, device=dev), desc2(ny, nx, variant), m,
             kind=kind, apply_bc=bc))
        for (ny, nx), kind, variant, m, bc in (
            ((200, 256), "cubic", "clean", 20, False),
            ((130, 260), "saturable", "clean", KRYLOV_M, True),
            ((97, 333), "cubic_quintic", "reference", 20, True),
            ((64, 64), "cubic", "reference", 2, False),
            ((3, 129), "saturable", "reference", 3, True),
            ((5, 3), "cubic", "clean", 1, True))
    ] + [
        ("K5 iso2d j=0", lambda: parity_iter(0, desc, N, N)),
        ("K5 iso2d j=4", lambda: parity_iter(4, desc, N, N)),
        ("K5 iso2d j=8", lambda: parity_iter(8, desc, N, N)),
        ("K5 iso2d clean j=3", lambda: parity_iter(3, clean, N, N)),
        ("K5 iso2d j=4 real", lambda: parity_iter(4, desc, N, N, P=1)),
        ("K5 aniso2d j=4", lambda: parity_iter(4, desc_a, N, N)),
        ("K5 aniso2d j=18", lambda: parity_iter(18, desc_a, N, N)),
        ("K5 iso2d j=8 250x333", lambda: parity_iter(8, ragged, 250, 333)),
        ("K5 aniso2d j=2 real 250x333",
         lambda: parity_iter(2, ragged_an, 250, 333, P=1)),
        ("K5 iso3d j=0 128^3", lambda: parity_iter(0, d3b["iso"], R3, N3)),
        ("K5 iso3d j=8 128^3", lambda: parity_iter(8, d3b["iso"], R3, N3)),
        ("K5 iso3d clean j=4 128^3",
         lambda: parity_iter(4, d3b["clean"], R3, N3)),
        ("K5 iso3d j=4 real 128^3",
         lambda: parity_iter(4, d3b["iso"], R3, N3, P=1)),
        ("K5 iso3d j=4 20x30x50", lambda: parity_iter(4, d3r["iso"], 600, 50)),
        ("K5 iso3d clean j=18 real 20x30x50",
         lambda: parity_iter(18, d3r["clean"], 600, 50, P=1)),
        # every bucket up to j = 30, both forms of w, the scalar forms
        ("K5 iso2d j=30", lambda: parity_iter(30, desc, N, N)),
        ("K5 iso2d clean j=13 real", lambda: parity_iter(13, clean, N, N,
                                                         P=1)),
        ("K5 aniso2d j=12 real sign -1 250x333",
         lambda: parity_iter(12, dict(ragged_an, sign=-1.0), 250, 333, P=1)),
        ("K5 iso2d j=25 250x334",
         lambda: parity_iter(25, desc2(250, 334, "clean"), 250, 334)),
        ("K5 iso3d j=30 37x50x61",
         lambda: parity_iter(30, ops3d((37, 50, 61))["iso"], 1850, 61)),
        ("K5 iso3d clean j=14 21x23x64",
         lambda: parity_iter(14, ops3d((21, 23, 64))["clean"], 483, 64)),
        ("K5 iso3d j=5 9x31x260",
         lambda: parity_iter(5, ops3d((9, 31, 260))["iso"], 279, 260)),
        (f"K5 iso2d j=8 {n_chip}^2 (largest on-chip)",
         lambda: parity_iter(8, desc_chip, n_chip, n_chip)),
        (f"K5 iso2d j=0 {N5}^2 (global w)",
         lambda: parity_iter(0, desc5, N5, N5)),
        (f"K5 iso2d j=8 {N5}^2 (global w)",
         lambda: parity_iter(8, desc5, N5, N5)),
        (f"K5 aniso2d j=17 {N5}^2 (global w)",
         lambda: parity_iter(17, desc5a, N5, N5)),
        (f"K5 iso2d j=3 real {N5}^2", lambda: parity_iter(3, desc5, N5, N5,
                                                          P=1)),
        ("K5 iso3d clean j=6 160^3 (global w)",
         lambda: parity_iter(6, d3g["clean"], 160 * 160, 160)),
        ("K8 iso j=0 128^3",
         lambda: parity_pipe(0, False, d3b["iso"], R3, N3, **k8)),
        ("K8 iso j=4 128^3",
         lambda: parity_pipe(4, False, d3b["iso"], R3, N3, **k8)),
        ("K8 iso j=7 128^3",
         lambda: parity_pipe(7, False, d3b["iso"], R3, N3, **k8)),
        ("K8 clean j=4 128^3",
         lambda: parity_pipe(4, False, d3b["clean"], R3, N3, **k8)),
        ("K8 aniso j=4 128^3",
         lambda: parity_pipe(4, False, d3b["aniso"], R3, N3, **k8)),
        ("K8 aniso j=7 128^3",
         lambda: parity_pipe(7, False, d3b["aniso"], R3, N3, **k8)),
        ("K8 iso j=4 real 128^3",
         lambda: parity_pipe(4, False, d3b["iso"], R3, N3, P=1, **k8)),
        ("K8 iso j=3 20x30x50",
         lambda: parity_pipe(3, False, d3r["iso"], 600, 50, **k8)),
        ("K8 clean j=3 real 20x30x50",
         lambda: parity_pipe(3, False, d3r["clean"], 600, 50, P=1, **k8)),
        ("K8 aniso j=3 20x30x50",
         lambda: parity_pipe(3, False, d3r["aniso"], 600, 50, **k8)),
        ("K8 aniso j=18 20x30x50",
         lambda: parity_pipe(18, False, d3r["aniso"], 600, 50, **k8)),
    ] + [
        (f"K8 {key} j={j}{' real' * (P == 1)} {'x'.join(map(str, shp))}",
         lambda shp=shp, key=key, j=j, P=P: parity_pipe(
             j, False, ops3d(shp)[key], shp[0] * shp[1], shp[2], P=P, **k8))
        for shp, key, P, j in (
            ((37, 50, 61), "aniso", 2, 8), ((21, 23, 64), "aniso", 2, 12),
            ((21, 23, 64), "clean", 1, 18), ((9, 31, 260), "iso", 2, 5),
            ((9, 31, 260), "aniso", 1, 2), ((33, 17, 132), "clean", 2, 18),
            ((17, 3, 33), "iso", 2, 18), ((N3_BIG,) * 3, "aniso", 2, 7))
    ]
    for label, fn in cases:
        gate(label, *fn())
    del u_r, mf_r, ragged_cl, ragged_an, d3r

    # K8, K13 and K5 (both forms of w) launched twice on the same inputs
    # give the same bits
    av, *W = [field(R3, N3) for _ in range(KRYLOV_M - 1)]
    sc8 = scalars(KRYLOV_M - 1)
    sc_rep = {}

    def k5_scal(W, j):
        """K5's scalars [s_j, bs, s_0..s_j], inverse norms near 1/||W_i||
        (the loop's magnitudes)."""
        sv = ((0.5 + 0.5 * torch.rand(j + 1, generator=gen, device=dev))
              / torch.stack([w.norm() for w in W[:j + 1]]))
        return torch.cat([torch.stack([sv[j], sv[0] * 0 + 0.3]),
                          sv])[None].contiguous()

    W5 = [field(N5, N5) for _ in range(KRYLOV_M - 1)]
    s5, s3 = k5_scal(W5, 8), k5_scal(W, 7)
    for label, fn in (
            (f"K5 {N5}^2 (global w)",
             lambda: lz.iter_step(s5, W5[8], W5[:8], desc5)),
            (f"K5 {N3}^3 (on-chip w)",
             lambda: lz.iter_step(s3, W[7], W[:7], d3b["iso"])),
            ("K8 c(x)", lambda: l3.pipe_3d(sc8, av, W, d3b["aniso"])),
            ("K13", lambda: (rs.ss2_resident_step(ug, mf1, desc, DT, 20,
                                                  scratch=sc_rep),))):
        same = all(bool(torch.equal(a, b)) for a, b in zip(fn(), fn()))
        print(f"repeat {label}: outputs and dots bit for bit equal {same}")
        check(same, f"{label}: two launches on the same inputs differ")
    del av, W, sc_rep, W5

    # K13, K5 and K8 per step of their paths: K13 and K5 at 1024^2 m=10
    # (iso), K8 at 128^3 m=10 (iso and c(x); it runs for j = 0..m-3)
    sc_rs = {}

    def k13_step():
        return rs.ss2_resident_step(ug, mf1, desc, DT, KRYLOV_M,
                                    scratch=sc_rs)

    t_rs = timed(k13_step)
    show("K13 per step", t_rs)
    g_rs = graph_ms(torch, k13_step)
    show_graph("K13", N, g_rs, t_rs, 1)
    W = [field() for _ in range(KRYLOV_M)]
    t_k5 = [0.0] * 4
    for j in range(KRYLOV_M - 1):
        sc5 = k5_scal(W, j)
        t = timed(lambda: lz.iter_step(sc5, W[j], W[:j], desc))
        show(f"K5 j={j}", t)
        t_k5 = [a + b for a, b in zip(t_k5, t)]
    show("K5 per step", t_k5)

    def k5_run(W, d):
        """The K5 launches of one Lanczos run, j = 0..m-2, at its scalars."""
        scs5 = [k5_scal(W, j) for j in range(KRYLOV_M - 1)]

        def run():
            for j in range(KRYLOV_M - 1):
                lz.iter_step(scs5[j], W[j], W[:j], d)
        return run

    g_k5 = {f"{N}^2": graph_ms(torch, k5_run(W, desc))}
    del W
    W = [field(R3, N3) for _ in range(KRYLOV_M - 1)]
    g_k5[f"{N3}^3"] = graph_ms(torch, k5_run(W, d3b["iso"]))
    del W
    W = [field(N5, N5) for _ in range(KRYLOV_M - 1)]
    g_k5[f"{N5}^2"] = graph_ms(torch, k5_run(W, desc5), 5)
    del W
    for key, g in g_k5.items():
        col = {f"{N}^2": col2, f"{N3}^3": col3, f"{N5}^2": 4 * col2}[key]
        nb = sum(j + 2 for j in range(KRYLOV_M - 1)) * col
        print(f"time K5 per step at {key} by CUDA-graph replay: {g:.4f} ms "
              f"({g / (KRYLOV_M - 1):.4f} ms per launch); bound "
              f"{nb / 1e6:.1f} MB -> {bound_ms(nb):.4f} ms at 3.35 TB/s, "
              f"graph reading at {bound_ms(nb) / g:.3f} of it")
    W = [field(R3, N3) for _ in range(KRYLOV_M - 1)]
    av = field(R3, N3)
    t_k8 = {"iso": [0.0] * 4, "aniso": [0.0] * 4}
    for j in range(KRYLOV_M - 2):
        sc8 = scalars(j + 2)
        for key in t_k8:
            t = timed(lambda: l3.pipe_3d(sc8, av, W[:j + 1], d3b[key]))
            show(f"K8 {key} j={j}", t)
            t_k8[key] = [a + b for a, b in zip(t_k8[key], t)]
    g_k8 = {}
    for key, t in t_k8.items():
        show(f"K8 {key} per step", t)
        scs8 = [scalars(j + 2) for j in range(KRYLOV_M - 2)]

        def k8_step(key=key, scs8=scs8):
            for j in range(KRYLOV_M - 2):
                l3.pipe_3d(scs8[j], av, W[:j + 1], d3b[key])

        g_k8[key] = graph_ms(torch, k8_step)
        show_graph(f"K8 {key}", f"{N3}^3", g_k8[key], t, KRYLOV_M - 2)
    del W, av
    # The bounds. K13's function reads u and the m field and writes the new
    # u; its float32 operations per cell (stencil, recurrence, the CGS dots
    # and subtractions, norms, both kicks, the combine) bound it first.
    # Its own design streams the basis: K13_STREAM below.
    m_ = KRYLOV_M
    plane2 = N * N * 4
    bytes_rs = 2 * col2 + plane2
    ops_rs = N * N * (22 * (m_ - 1) + 8 * m_ * (m_ - 1) + 30 + 8 * m_)
    # the kernel's passes: the kick reads u and writes W_0 and av_0; pass j
    # < m-2 reads av_j and W_0..W_j and writes W_{j+1} and av_{j+1}, the
    # last reads m columns and writes one; the combine reads m, writes one;
    # the m field twice
    stream_rs = (col2 * (3 + sum(j + 4 for j in range(m_ - 2)) + 2 * (m_ + 1))
                 + 2 * plane2)
    print(f"K13 design traffic (basis streamed, in this kernel's order): "
          f"{stream_rs / 1e6:.1f} MB per step -> {bound_ms(stream_rs):.4f} "
          f"ms at 3.35 TB/s; graph reading at "
          f"{bound_ms(stream_rs) / g_rs:.3f} of it")
    # K5 at j reads W_0..W_j and writes W_{j+1}; K8 at j reads av_j and
    # W_0..W_j, writes W_{j+1} and av_{j+1} (c(x): three weight planes more)
    bytes_k5 = sum(j + 2 for j in range(m_ - 1)) * col2
    ops_k5 = N * N * sum(22 + 16 * (j + 1) for j in range(m_ - 1))
    bytes_k8 = sum(j + 4 for j in range(m_ - 2)) * col3
    # c(x): the three (R, nx) face-weight planes, read once per launch
    bytes_k8a = bytes_k8 + (m_ - 2) * 3 * (col3 // 2)
    bounds = {"K13": (bytes_rs, ops_rs), "K5": (bytes_k5, ops_k5),
              "K8": (bytes_k8, 0), "K8 c(x)": (bytes_k8a, 0)}
    times_o = {"K13": t_rs, "K5": t_k5, "K8": t_k8["iso"],
               "K8 c(x)": t_k8["aniso"]}
    graphs_o = {"K13": g_rs, "K8": g_k8["iso"], "K8 c(x)": g_k8["aniso"],
                "K5": g_k5[f"{N}^2"]}
    for key, (nb, no) in bounds.items():
        b_ms = max(bound_ms(nb), ops_ms(no))
        g = graphs_o.get(key)
        print(f"bound {key} per step: {nb / 1e6:.1f} MB -> "
              f"{bound_ms(nb):.4f} ms at 3.35 TB/s; {no / 1e9:.3f} GFLOP -> "
              f"{ops_ms(no):.4f} ms at 67 TFLOP/s; kernel at "
              f"{b_ms / times_o[key][0]:.3f} of the larger (profiler)"
              + ("" if g is None else f", {b_ms / g:.3f} (graph)"))

    # ---------------------------------------------------------- 17. main-resident
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 17 main-resident")
    counters_all = {"K1": lz.pass1_iso2d, "K2": lz.pipe_iso2d,
                    "K1'": lz.pass1_aniso2d, "K2'": lz.pipe_aniso2d,
                    "K3": lz.combine, "K5": lz.iter_step,
                    "K13": rs.ss2_resident_step, "pass1_3d": l3.pass1_3d,
                    "pass2": l3.pass2, "K8": l3.pipe_3d,
                    "bc3d": b3.neumann_bc_planar_3d,
                    "kick_bc": kb.phase_kick_bc_planar,
                    "recur": lz.recur_kernel}

    def main_optin(label, prob, s0, snaps_, freq_, per_step,
                   sync_free=False):
        """problems.run with every launch counter at 0 just before and
        read just after: exactly per_step launches of each kernel per step
        and none of the others, finite snapshots, mass drift < 1e-3; with
        sync_free the run is under set_sync_debug_mode("error")."""
        n_steps = (snaps_ - 1) * freq_
        for f in counters_all.values():
            f.launches = 0
        torch.cuda.synchronize()
        if sync_free:
            torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            traj = problems.run(prob, s0, snaps_, freq_)
        finally:
            if sync_free:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: f.launches for k, f in counters_all.items()}
        want = {k: per_step.get(k, 0) * n_steps for k in counters_all}
        print(f"{label}: {n_steps} steps in {wall:.3f} s; launches "
              f"{ {k: v for k, v in got.items() if v} } "
              f"({sum(got.values()) / n_steps:.0f} counted per step)"
              + ("; no host sync (sync debug mode 'error')" if sync_free
                 else ""))
        check(got == want, f"{label}: launches {got} != {want}")
        check(bool(torch.isfinite(torch.view_as_real(traj)).all()),
              f"{label}: non-finite snapshot")
        mass = (traj.abs().double() ** 2).sum(dim=tuple(range(1, traj.dim())))
        drift_ = float(((mass - mass[0]).abs() / mass[0]).max())
        print(f"{label}: relative mass drift over {n_steps} steps "
              f"{drift_:.3e}")
        check(drift_ < 1e-3, f"{label}: mass drift {drift_:.3e} >= 1e-3")
        return got, n_steps

    def with_switches(prob, **sw):
        """prob with config switches set while its step runs."""
        def step(s, i):
            old = interop.set_switches(**sw)
            try:
                return prob.step(s, i)
            finally:
                interop.set_switches(**old)
        return dataclasses.replace(prob, step=step)

    old_sw = interop.set_switches(resident_mode="auto")
    try:
        prob_r = problems.nlse_problem("cubic", (N, N), LX, DT,
                                       m_field=m_field, krylov_m=KRYLOV_M,
                                       dtype=torch.complex64)
    finally:
        interop.set_switches(**old_sw)
    check(not prob_r.meta["planar_state"] and prob_r.meta["device"] == "cuda",
          "the resident problem took another path")
    state_r = prob_r.init(torch.complex(u0[0], u0[1]))
    launches_r, steps_r = main_optin("main-resident 1024^2", prob_r, state_r,
                                     snaps, freq, {"K13": 1}, sync_free=True)

    # ---------------------------------------------------------- 18. main-iter
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 18 main-iter")
    p2, s2 = problem2d(c=None)
    p2_fused = with_switches(p2, fused_iter=True)
    # the fused loop's start norm is pass2's norm-only form
    per_iter = {"K5": KRYLOV_M - 1, "pass2": 1, "K3": 1, "kick_bc": 2}
    launches_i, steps_i = main_optin("main-iter 1024^2", p2_fused, s2, 3,
                                     50, per_iter)
    p3, s3 = problem3d(N3)
    main_optin("main-iter 128^3", with_switches(p3, fused_iter=True), s3, 3,
               50, per_iter)

    # ---------------------------------------------------------- 19. main-pipe3d
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 19 main-pipe3d")
    per_pipe3d = {"pass2": 1, "pass1_3d": 1, "K8": KRYLOV_M - 2, "K2": 1,
                  "K3": 1, "kick_bc": 2}
    p3_pipe = with_switches(p3, pipeline_3d=True)
    launches_p, steps_p = main_optin("main-pipe3d iso 128^3", p3_pipe, s3, 3,
                                     50, per_pipe3d)
    p3c, s3c = problem3d(N3, c3)
    p3c_pipe = with_switches(p3c, pipeline_3d=True)
    main_optin("main-pipe3d c(x) 128^3", p3c_pipe, s3c, 3, 50, per_pipe3d)

    # ---------------------------------------------------------- 20. paths-optin
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 20 paths-optin")
    for label, (po, so), (pd, sd), tol in (
            ("resident vs default 1024^2", (prob_r, state_r), (p2, s2), 1e-4),
            ("fused_iter vs default 1024^2", (p2_fused, s2), (p2, s2), 1e-5),
            ("fused_iter vs default 128^3",
             (with_switches(p3, fused_iter=True), s3), (p3, s3), 1e-5),
            ("pipeline_3d vs default iso 128^3", (p3_pipe, s3), (p3, s3),
             1e-5),
            ("pipeline_3d vs default c(x) 128^3", (p3c_pipe, s3c),
             (p3c, s3c), 1e-5)):
        a = po.observe(advance(po.step, so, n_par))
        b = pd.observe(advance(pd.step, sd, n_par))
        e = rel(a, b)
        print(f"paths-optin {label}: {n_par} steps rel-L2 {e:.3e} (gate "
              f"{tol:g})")
        check(e <= tol, f"{label}: rel-L2 {e:.3e} > {tol:g}")
        del a, b

    # ---------------------------------------------------------- 21. rate-optin
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 21 rate-optin")
    rr, rf, rd = (f"rate-optin {k} {N}^2" for k in
                  ("resident", "fused_iter", "default"))
    rate(torch, {rr: (prob_r, state_r), rf: (p2_fused, s2), rd: (p2, s2)},
         200, [rd, rr, rf, rf, rr, rd, rd, rf, rr], 20)
    del prob_r, state_r, p2, p2_fused, s2, p3c, s3c, p3c_pipe
    q3, t3w = f"rate-optin pipeline_3d {N3}^3", f"rate-optin two-pass {N3}^3"
    rate(torch, {q3: (p3_pipe, s3), t3w: (p3, s3)}, 100,
         [t3w, q3, q3, t3w, t3w, q3], 20)
    del p3, s3, p3_pipe
    pb, sb = problem3d(N3_BIG)
    qb = f"rate-optin pipeline_3d {N3_BIG}^3"
    tb = f"rate-optin two-pass {N3_BIG}^3"
    rate(torch, {qb: (with_switches(pb, pipeline_3d=True), sb),
                 tb: (pb, sb)}, 20, [tb, qb, qb, tb, tb, qb], 5)
    del pb, sb

    # ---------------------------------------------------------- 22. parity-shard
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 22 parity-shard")
    from nlsolvers_tpu_torch.parallel import mesh as pmesh
    from nlsolvers_tpu_torch.parallel import shards, spatial

    errs.update({"pass1_shard2d": 0.0, "pass1_shard3d": 0.0})
    L2, L3 = NS // 2, NS3 // 2              # the local blocks of the meshes
    scale2, scale3 = ((NS - 1) / (2 * LX)) ** 2, ((NS3 - 1) / (2 * LX)) ** 2

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def faces(*shape):
        """Face weights 0.5 (c + c') of a c in [1, 1.4)."""
        return 1.0 + 0.4 * torch.rand(shape, generator=gen, device=dev)

    def desc_s2(mode, ny, nx, pos, P=2):
        """A 2D shard descriptor: the (ny, nx) block at place `pos` of a
        grid of 3 x 3 such blocks (sign -1 with P=1)."""
        d = dict(kind="shard2d_aniso" if mode == "aniso" else "shard2d",
                 NY=3 * ny, NX=3 * nx, y0=pos[0] * ny, x0=pos[1] * nx,
                 scale=scale2, sign=-1.0 if P == 1 else 1.0, variant=mode)
        if mode == "aniso":
            d.update(wx=faces(ny, nx), wy=faces(ny, nx), wxl=faces(ny),
                     wyh=faces(nx))
        return d

    def desc_s3(mode, shape, pos, P=2):
        """A 3D shard descriptor: the block `shape` at place `pos` of a grid
        of 3 x 3 x 3 such blocks; under the reference variant z and y are
        whole (x split only), as the sharded step requires."""
        nz, ny, nx = shape
        R = nz * ny
        ref = mode == "reference"
        d = dict(kind="shard3d_aniso" if mode == "aniso" else "shard3d",
                 NZ=nz if ref else 3 * nz, NY=ny if ref else 3 * ny,
                 NX=3 * nx, lnz=nz, lny=ny, z0=0 if ref else pos[0] * nz,
                 y0=0 if ref else pos[1] * ny, x0=pos[2] * nx, scale=scale3,
                 sign=-1.0 if P == 1 else 1.0,
                 variant="clean" if mode == "aniso" else mode)
        if mode == "aniso":
            d.update(wx=faces(R, nx), wy=faces(R, nx), wz=faces(R, nx),
                     wxl=faces(R), wyh=faces(nz, nx), wzh=faces(ny, nx))
        return d

    def halos(shape, P):
        """Random halos of a block `shape`: (yh, xh) in 2D, (yh, zh, xh) in
        3D."""
        if len(shape) == 2:
            ny, nx = shape
            return rnd(P, 2, nx), rnd(P, 2, ny)
        nz, ny, nx = shape
        return rnd(P, 2, nz, nx), rnd(P, 2, ny, nx), rnd(P, 2, nz * ny)

    def parity_shard(kernel, d, shape, j, P, key):
        W = [field(math.prod(shape[:-1]), shape[-1], P) for _ in range(j + 1)]
        hs = halos(shape, P)
        scal = torch.tensor([[0.7, 0.3]], device=dev)
        (w, raw), (w0, raw0) = both(lambda: kernel(scal, W[j], W[:j], *hs, d))
        errs[key] = max(errs[key], float((w - w0).abs().max()))
        return rel(w, w0), dot_err(raw, raw0, W, w0)

    def parity_s2(mode, ny, nx, j, P=2, pos=(1, 1)):
        return parity_shard(lz.pass1_shard2d, desc_s2(mode, ny, nx, pos, P),
                            (ny, nx), j, P, "pass1_shard2d")

    def parity_s3(mode, shape, j, P=2, pos=(1, 1, 1)):
        return parity_shard(l3.pass1_shard3d, desc_s3(mode, shape, pos, P),
                            shape, j, P, "pass1_shard3d")

    b3l = (L3, L3, L3)
    cases = [
        ("pass1_shard2d reference j=0 corner",
         lambda: parity_s2("reference", L2, L2, 0, pos=(0, 0))),
        ("pass1_shard2d reference j=8",
         lambda: parity_s2("reference", L2, L2, 8)),
        ("pass1_shard2d clean j=4 edge",
         lambda: parity_s2("clean", L2, L2, 4, pos=(2, 1))),
        ("pass1_shard2d reference j=18 real",
         lambda: parity_s2("reference", L2, L2, 18, P=1)),
        ("pass1_shard2d aniso j=0", lambda: parity_s2("aniso", L2, L2, 0)),
        ("pass1_shard2d aniso j=8 corner",
         lambda: parity_s2("aniso", L2, L2, 8, pos=(2, 2))),
        ("pass1_shard2d aniso j=18", lambda: parity_s2("aniso", L2, L2, 18)),
        ("pass1_shard2d aniso j=4 real",
         lambda: parity_s2("aniso", L2, L2, 4, P=1)),
        ("pass1_shard2d clean j=3 250x333",
         lambda: parity_s2("clean", 250, 333, 3)),
        ("pass1_shard2d aniso j=18 250x333 edge",
         lambda: parity_s2("aniso", 250, 333, 18, pos=(2, 0))),
        ("pass1_shard2d reference j=2 real 2x131",
         lambda: parity_s2("reference", 2, 131, 2, P=1, pos=(0, 1))),
        ("pass1_shard2d aniso j=4 2x2", lambda: parity_s2("aniso", 2, 2, 4)),
        ("pass1_shard3d reference j=0",
         lambda: parity_s3("reference", b3l, 0, pos=(0, 0, 1))),
        ("pass1_shard3d reference j=8 corner",
         lambda: parity_s3("reference", b3l, 8, pos=(0, 0, 0))),
        ("pass1_shard3d clean j=0", lambda: parity_s3("clean", b3l, 0)),
        ("pass1_shard3d clean j=8 corner",
         lambda: parity_s3("clean", b3l, 8, pos=(0, 0, 0))),
        ("pass1_shard3d clean j=18 real",
         lambda: parity_s3("clean", b3l, 18, P=1)),
        ("pass1_shard3d aniso j=0", lambda: parity_s3("aniso", b3l, 0)),
        ("pass1_shard3d aniso j=8 edge",
         lambda: parity_s3("aniso", b3l, 8, pos=(2, 1, 0))),
        ("pass1_shard3d aniso j=18", lambda: parity_s3("aniso", b3l, 18)),
        ("pass1_shard3d aniso j=4 real",
         lambda: parity_s3("aniso", b3l, 4, P=1)),
        ("pass1_shard3d reference j=3 20x30x50",
         lambda: parity_s3("reference", (20, 30, 50), 3)),
        ("pass1_shard3d clean j=18 real 20x30x50",
         lambda: parity_s3("clean", (20, 30, 50), 18, P=1)),
        ("pass1_shard3d aniso j=4 20x30x50",
         lambda: parity_s3("aniso", (20, 30, 50), 4)),
        ("pass1_shard3d clean j=4 2x2x2",
         lambda: parity_s3("clean", (2, 2, 2), 4)),
        ("pass1_shard3d aniso j=18 real 2x2x2",
         lambda: parity_s3("aniso", (2, 2, 2), 18, P=1)),
    ]
    for label, fn in cases:
        gate(label, *fn())
    # the ghost copy on one shard's block at its global offsets
    for shp, glob, offs in ((b3l, (NS3,) * 3, (0, 0, 0)),
                            (b3l, (NS3,) * 3, (L3, L3, L3)),
                            (b3l, (NS3, NS3, 4 * L3), (0, 0, L3)),
                            ((20, 30, 50), (60, 30, 100), (20, 0, 50)),
                            ((20, 30, 50), (60, 90, 150), (20, 30, 50)),
                            ((2, 2, 2), (6, 6, 6), (2, 4, 0))):
        up = field(shp[0] * shp[1], shp[2])
        got, want = both(lambda: b3.neumann_bc_planar_3d(up.clone(), shp,
                                                         glob, offs))
        torch.cuda.synchronize()
        same = bool(torch.equal(got, want))
        tag = "x".join(map(str, shp))
        print(f"parity bc3d {tag} at {offs} of {glob}: exactly equal {same}")
        check(same, f"bc3d {tag} at {offs} differs from its plain version")
        del up, got, want

    # The shard kernels per step of the sharded main paths: every shard of
    # the mesh, j = 0..m-2, the loop's scalars [1/chat, 0]. Bytes per
    # launch: W_0..W_j read, w written, plus the halos (and the weights).
    # Beside the profiler's sum, CUDA events around `reps` back-to-back
    # calls (no sync between them) give a second reading of the same work:
    # the device time when the card is the slower side, else more.
    def batch_events_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    def shard_step_times(kernel, descs, lshape, reps):
        rows, nx = math.prod(lshape[:-1]), lshape[-1]
        Ws = [[field(rows, nx) for _ in range(KRYLOV_M - 1)] for _ in descs]
        hs = [halos(lshape, 2) for _ in descs]
        s = torch.tensor([[0.5, 0.0]], device=dev)
        tot = [0.0] * 5
        for j in range(KRYLOV_M - 1):
            def call():
                return [kernel(s, W[j], W[:j], *h, d)
                        for W, h, d in zip(Ws, hs, descs)]
            t = timed(call, reps) + (batch_events_ms(call, reps),)
            tot = [a + b for a, b in zip(tot, t)]
        return tot

    def mesh_descs(mode, lshape, mshape):
        """The descriptors of every shard of an mshape mesh of lshape
        blocks (so every block is at a corner of the grid)."""
        out = []
        for k in range(math.prod(mshape)):
            pos = tuple(int(c) for c in np.unravel_index(k, mshape))
            d = (desc_s2(mode, *lshape, pos) if len(lshape) == 2
                 else desc_s3(mode, lshape, pos))
            d.update(zip(("NZ", "NY", "NX")[-len(lshape):],
                         (a * b for a, b in zip(mshape, lshape))))
            out.append(d)
        return out

    t_s = {}
    for mode in ("reference", "aniso"):
        t_s[f"pass1_shard2d {mode}"] = shard_step_times(
            lz.pass1_shard2d, mesh_descs(mode, (L2, L2), (2, 2)), (L2, L2),
            5)
    for mode in ("clean", "aniso"):
        t_s[f"pass1_shard3d {mode}"] = shard_step_times(
            l3.pass1_shard3d, mesh_descs(mode, b3l, (2, 2, 2)), b3l, 2)
    colL2, colL3 = 2 * L2 * L2 * 4, 2 * L3 ** 3 * 4
    cols = sum(j + 2 for j in range(KRYLOV_M - 1))
    n_it = KRYLOV_M - 1
    halo2, halo3 = 2 * 2 * (2 * L2) * 4, 2 * 2 * (3 * L3 * L3) * 4
    bytes_s = {
        "pass1_shard2d reference": 4 * (cols * colL2 + n_it * halo2),
        "pass1_shard2d aniso": 4 * (cols * colL2 + n_it * (
            halo2 + 2 * L2 * L2 * 4 + 2 * L2 * 4)),
        "pass1_shard3d clean": 8 * (cols * colL3 + n_it * halo3),
        "pass1_shard3d aniso": 8 * (cols * colL3 + n_it * (
            halo3 + 3 * L3 ** 3 * 4 + 3 * L3 * L3 * 4)),
    }
    for key, t in t_s.items():
        show(f"{key} per step (every shard)", t)
        nb = bytes_s[key]
        print(f"bound {key} per step: {nb / 1e6:.1f} MB -> "
              f"{bound_ms(nb):.4f} ms at 3.35 TB/s; kernel at "
              f"{bound_ms(nb) / t[0]:.3f} of it; CUDA events around the "
              f"batched calls {t[4]:.4f} ms ({bound_ms(nb) / t[4]:.3f} of "
              f"the bound)")

    # ---------------------------------------------------------- 23. main-shard2d
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 23 main-shard2d")
    counters_sh = dict(counters_all, pass1_shard2d=lz.pass1_shard2d,
                       pass1_shard3d=l3.pass1_shard3d)

    def gaussian(shape):
        """A Gaussian times exp(0.5 i x) on the grid `shape`, planar
        (2,) + shape on the card."""
        x = torch.linspace(-LX, LX, shape[-1], dtype=torch.float32,
                           device=dev)
        g = torch.meshgrid(*([x] * len(shape)), indexing="ij")
        env = torch.exp(-sum(a * a for a in g) / 4)
        return torch.stack([env * torch.cos(0.5 * g[-1]),
                            env * torch.sin(0.5 * g[-1])])

    def sharded(global_shape, mshape, variant, c=None):
        """make_sharded_nlse_step on a mesh of shards that all sit on this
        card, as a problem-like object for advance/rate: its step takes and
        returns a tuple of the shards' planar blocks."""
        axes = ("gy", "gx") if len(global_shape) == 2 else ("gz", "gy", "gx")
        mesh = pmesh.make_mesh(axes, mshape,
                               devices=[dev] * math.prod(mshape))
        step = spatial.make_sharded_nlse_step(
            "cubic", global_shape, LX, DT, mesh, axis_names=axes,
            krylov_m=KRYLOV_M, variant=variant, use_c=c is not None)
        u0 = gaussian(global_shape)
        mp = shards.shard(torch.ones(global_shape, device=dev), mesh)
        cp = None if c is None else shards.shard(c, mesh)

        def stp(s, i):
            del i
            return tuple(step(list(s), mp) if cp is None
                         else step(list(s), mp, cp))

        return SimpleNamespace(step=stp, mesh=mesh, u0=u0,
                               state=tuple(shards.shard(u0, mesh)),
                               shape=global_shape, variant=variant, c=c)

    def mass(s):
        return sum(float((x.double() ** 2).sum()) for x in s)

    def main_shard(label, sp, n_steps, per_shard):
        """n_steps of the sharded step with every launch counter at 0 just
        before and read just after: exactly per_shard launches of each
        kernel per shard and step, none of the others; finite state of the
        global shape; relative mass drift < 1e-3 (taken every n/5 steps)."""
        n_sh = sp.mesh.size
        m0, drift = mass(sp.state), 0.0
        for f in counters_sh.values():
            f.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = sp.state
        for i in range(1, n_steps + 1):
            s = sp.step(s, i)
            if i % max(1, n_steps // 5) == 0:
                drift = max(drift, abs(mass(s) - m0) / m0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: f.launches for k, f in counters_sh.items()}
        want = {k: per_shard.get(k, 0) * n_sh * n_steps for k in counters_sh}
        print(f"{label}: {n_steps} steps on a {sp.mesh.shape} mesh in "
              f"{wall:.3f} s (mass checks included); launches "
              f"{ {k: v for k, v in got.items() if v} } "
              f"({sum(got.values()) / n_steps:.0f} counted per step)")
        check(got == want, f"{label}: launches {got} != {want}")
        full = shards.gather(list(s), sp.mesh)
        check(tuple(full.shape) == (2,) + sp.shape, f"{label}: gathered "
              f"state {tuple(full.shape)}")
        check(bool(torch.isfinite(full).all()), f"{label}: non-finite state")
        del full
        print(f"{label}: relative mass drift over {n_steps} steps "
              f"{drift:.3e}")
        check(drift < 1e-3, f"{label}: mass drift {drift:.3e} >= 1e-3")
        return got, n_steps

    per2 = {"pass1_shard2d": KRYLOV_M - 1, "pass2": KRYLOV_M, "K3": 1,
            "kick_bc": 2}
    per3 = {"pass1_shard3d": KRYLOV_M - 1, "pass2": KRYLOV_M, "K3": 1,
            "kick_bc": 2}
    cs2 = torch.from_numpy((1.0 + 0.4 * np.random.default_rng(0).random(
        (NS, NS))).astype(np.float32))
    sp2 = sharded((NS, NS), (2, 2), "reference")
    launches_s2, steps_s2 = main_shard(f"main-shard2d {NS}^2 iso", sp2, 50,
                                       per2)
    sp2c = sharded((NS, NS), (2, 2), "reference", cs2)
    main_shard(f"main-shard2d {NS}^2 c(x)", sp2c, 50, per2)

    # ---------------------------------------------------------- 24. main-shard3d
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 24 main-shard3d")
    cs3 = torch.from_numpy((1.0 + 0.4 * np.random.default_rng(0).random(
        (NS3,) * 3, dtype=np.float32)))
    sp3 = sharded((NS3,) * 3, (2, 2, 2), "clean")
    launches_s3, steps_s3 = main_shard(f"main-shard3d {NS3}^3 iso", sp3, 10,
                                       per3)
    sp3c = sharded((NS3,) * 3, (2, 2, 2), "clean", cs3)
    main_shard(f"main-shard3d {NS3}^3 c(x)", sp3c, 10, per3)
    sp3r = sharded((N3_BIG,) * 3, (1, 1, 4), "reference")
    main_shard(f"main-shard3d {N3_BIG}^3 reference (1, 1, 4)", sp3r, 20,
               per3)

    # ---------------------------------------------------------- 25. paths-shard
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 25 paths-shard")
    def kernels_vs_plain(sp, n):
        a = advance(sp.step, sp.state, n)
        config.kernel_mode = "off"
        try:
            b = advance(sp.step, sp.state, n)
        finally:
            config.kernel_mode = "auto"
        return rel(shards.gather(list(a), sp.mesh),
                   shards.gather(list(b), sp.mesh))

    g64 = (1.0 + 0.4 * torch.rand((64,) * 3, generator=gen, device=dev))
    g512 = (1.0 + 0.4 * torch.rand((512, 512), generator=gen, device=dev))
    for label, sp in (
            ("512^2 (2, 2) iso", sharded((512, 512), (2, 2), "reference")),
            ("512^2 (2, 2) c(x)", sharded((512, 512), (2, 2), "reference",
                                          g512)),
            ("64^3 (2, 2, 2) iso", sharded((64,) * 3, (2, 2, 2), "clean")),
            ("64^3 (2, 2, 2) c(x)", sharded((64,) * 3, (2, 2, 2), "clean",
                                            g64)),
            ("64^3 (1, 1, 4) reference iso",
             sharded((64,) * 3, (1, 1, 4), "reference")),
            ("64^3 (1, 1, 4) reference c(x)",
             sharded((64,) * 3, (1, 1, 4), "reference", g64))):
        e = kernels_vs_plain(sp, n_par)
        print(f"paths-shard {label}: {n_par} steps kernels vs plain rel-L2 "
              f"{e:.3e}")
        check(e <= 1e-5, f"sharded {label} kernel vs plain path rel-L2 "
              f"{e:.3e} > 1e-5")

    def unsharded(sp):
        """The unsharded kernel path (nlse_problem) on the same grid."""
        prob = problems.nlse_problem("cubic", sp.shape, LX, DT,
                                     m_field=torch.ones(sp.shape),
                                     c_field=sp.c, krylov_m=KRYLOV_M,
                                     variant=sp.variant,
                                     dtype=torch.complex64)
        check(prob.meta["planar_state"] and prob.meta["device"] == "cuda",
              f"unsharded {sp.shape} did not take the planar path on the "
              f"card")
        return SimpleNamespace(prob=prob, state=prob.init(sp.u0))

    ref_runs = {}
    for label, sp in ((f"{NS}^2 iso", sp2), (f"{NS}^2 c(x)", sp2c),
                      (f"{NS3}^3 iso", sp3), (f"{NS3}^3 c(x)", sp3c),
                      (f"{N3_BIG}^3 reference (1, 1, 4)", sp3r)):
        un = unsharded(sp)
        a = shards.gather(list(advance(sp.step, sp.state, n_par)), sp.mesh)
        b = advance(un.prob.step, un.state, n_par).reshape(a.shape)
        e = rel(a, b)
        print(f"paths-shard {label}: {n_par} steps sharded vs unsharded "
              f"kernel path rel-L2 {e:.3e}")
        check(e <= 2e-4, f"sharded {label} vs unsharded rel-L2 {e:.3e} > "
              f"2e-4")
        del a, b
        if label in (f"{NS}^2 iso", f"{NS3}^3 iso"):
            ref_runs[label] = un
        del un

    # ---------------------------------------------------------- 26. rate-shard
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 26 rate-shard")
    del sp2c, sp3c, sp3r
    for label, sp, chunk, n_prof in ((f"{NS}^2", sp2, 20, 5),
                                     (f"{NS3}^3", sp3, 5, 2)):
        un = ref_runs.pop(label + " iso")
        rs_, ru_ = (f"rate-shard sharded {label} {sp.mesh.shape}",
                    f"rate-shard unsharded {label}")
        rate(torch, {rs_: (sp, sp.state), ru_: (un.prob, un.state)}, chunk,
             [rs_, ru_, ru_, rs_, rs_, ru_], n_prof)
        del un
    del sp2, sp3

    # ---------------------------------------------------------- 27. kick-bc
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 27 kick-bc")
    from nlsolvers_tpu_torch.models.nonlinearities import nlse_density_planar
    errs["kick_bc"] = 0.0

    def clamp_gather(out, shape, glob, offs):
        """out at the clamped index of every cell: what the ghost copy
        leaves, so in the kernel's own output each ghost cell must equal
        its source cell."""
        idx = []
        for n, g, o in zip(shape, glob, offs):
            c = torch.arange(n, device=dev)
            if o == 0:
                c[0] = 1
            if o + n == g:
                c[n - 1] = n - 2
            idx.append(c)
        grids = torch.meshgrid(*idx, indexing="ij")
        return out.reshape((2,) + shape)[(slice(None),) + grids].reshape(
            out.shape)

    def parity_kick(label, kind, shape, glob=None, offs=None, theta=0.3,
                    offset=0):
        """kick_bc with and without the ghost copy against kick_bc_ref on
        the same inputs: fields rel-L2, ghost cells bit-equal to their
        source cells, the input untouched, two launches bit for bit."""
        R, nx = math.prod(shape[:-1]), shape[-1]
        buf = torch.empty(2 * R * nx + offset, device=dev)
        up = buf[offset:].view(2, R, nx)
        up.copy_(field(R, nx))
        m = 0.5 + torch.rand((R, nx), generator=gen, device=dev)
        rho = nlse_density_planar(kind, m, sigma1=0.8, sigma2=-0.15,
                                  kappa=0.7)
        keep = up.clone()
        grid = kb.kick_grid(shape, glob, offs)
        fe = 0.0
        for g in (None, grid):
            got, want = both(lambda: kb.phase_kick_bc_planar(up, rho, theta,
                                                             g))
            fe = max(fe, rel(got, want))
            errs["kick_bc"] = max(errs["kick_bc"],
                                  float((got - want).abs().max()))
            again = kb.phase_kick_bc_planar(up, rho, theta, g)
            check(bool(torch.equal(got, again)), f"kick_bc {label}: two "
                  f"launches on the same inputs differ")
        ghost_ok = bool(torch.equal(got, clamp_gather(
            got, shape, glob or shape, offs or (0,) * len(shape))))
        check(ghost_ok, f"kick_bc {label}: a ghost cell differs from its "
              f"source cell")
        check(bool(torch.equal(up, keep)), f"kick_bc {label}: the input "
              f"changed")
        gate(f"kick_bc {label} (ghost cells equal their sources, repeats "
             f"bit for bit)", fe, 0.0)

    for kind in ("cubic", "cubic_quintic", "saturable"):
        for shape in ((N, N), (250, 333), (N3, N3, N3), (37, 50, 61)):
            parity_kick(f"{kind} {'x'.join(map(str, shape))}", kind, shape)
    parity_kick(f"cubic {N}^2 theta dt/2", "cubic", (N, N), theta=0.5 * DT)
    parity_kick(f"cubic {N}^2 4 bytes off", "cubic", (N, N), offset=1)
    parity_kick("cubic_quintic 250x334", "cubic_quintic", (250, 334))
    parity_kick("saturable 251x335", "saturable", (251, 335))
    for glob, mshape in (((NS, NS), (2, 2)), ((NS3,) * 3, (2, 2, 2))):
        blk = tuple(g // k for g, k in zip(glob, mshape))
        for pos in itertools.product(*(range(k) for k in mshape)):
            offs = tuple(p * n for p, n in zip(pos, blk))
            parity_kick(f"cubic block {'x'.join(map(str, blk))} at {offs} "
                        f"of {'x'.join(map(str, glob))}", "cubic", blk, glob,
                        offs, theta=0.5 * DT)
            torch.cuda.empty_cache()

    # times per step: the two kick_bc launches (the opening kick, the
    # closing one with the ghost copy) against the eager ops they replace
    # (two plain kicks and the ghost copy: in 2D the plain copy, in 3D the
    # bc3d kernel), by CUDA-graph replay, beside 20 bytes per cell per kick
    bytes_kb, g_kb, t_kb = {}, {}, {}
    for shape in ((N, N), (NS, NS), (N3,) * 3, (N3_BIG,) * 3):
        R, nx = math.prod(shape[:-1]), shape[-1]
        tag = f"{shape[0]}^{len(shape)}"
        up = field(R, nx)
        rho = nlse_density_planar("cubic", torch.ones((R, nx), device=dev))
        grid = kb.kick_grid(shape)
        th = 0.5 * DT
        if len(shape) == 2:
            neum = boundaries.neumann_no_velocity_2d
        else:
            neum = partial(b3.neumann_bc_planar_3d, shape=shape)

        def new_pair():
            kb.phase_kick_bc_planar(up, rho, th)
            kb.phase_kick_bc_planar(up, rho, th, grid)

        def old_pair():
            kb.phase_kick_planar(up, rho(up), th)
            neum(kb.phase_kick_planar(up, rho(up), th))

        nb = 2 * 20 * R * nx
        g_new = graph_ms(torch, new_pair)
        g_one = graph_ms(torch, lambda: kb.phase_kick_bc_planar(up, rho, th,
                                                                grid))
        g_old = graph_ms(torch, old_pair)
        t_new = timed(new_pair, 10)
        t_old = times_ms(torch, old_pair, 10)
        print(f"time kick_bc per step at {tag}: CUDA-graph replay "
              f"{g_new:.4f} ms for both kicks ({g_one:.4f} ms the one with "
              f"the ghost copy); profiler {t_new[0]:.4f} ms, events "
              f"{t_new[1]:.4f} ms; plain {t_new[2]:.4f} ms device")
        print(f"time eager kicks + ghost copy it replaces at {tag}: "
              f"CUDA-graph replay {g_old:.4f} ms, profiler {t_old[0]:.4f} ms")
        print(f"bound kick_bc per step at {tag}: {nb / 1e6:.1f} MB -> "
              f"{bound_ms(nb):.4f} ms at 3.35 TB/s; graph reading at "
              f"{bound_ms(nb) / g_new:.3f} of it (one kick: "
              f"{bound_ms(nb / 2) / g_one:.3f})")
        bytes_kb[tag], g_kb[tag], t_kb[tag] = nb, g_new, t_new
        del up, rho
        torch.cuda.empty_cache()

    # ---------------------------------------------------------- 28. parity-rw
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 28 parity-rw")
    # the real-wave problems' route: real fields (P=1) and the operators
    # with their sign flipped (problems.realwave_problem runs on -Lap)
    t_ph = time.perf_counter()
    errs.update({"pass1_3d P=1": 0.0, "pass2 P=1": 0.0, "K3 P=1": 0.0})
    for shape in ((N3, N3, N3), (37, 50, 61)):
        R, nx = shape[0] * shape[1], shape[2]
        tag = "x".join(map(str, shape))
        for mode, d in ops3d(shape).items():
            d = dict(d, sign=-1.0)
            for j in (0, 4, 8):
                gate(f"pass1_3d {mode} j={j} {tag} real sign -1",
                     *parity_pass1_3d(j, d, R, nx, P=1, key="pass1_3d P=1"))
        for j in (0, 4, 8):
            gate(f"pass2 j={j} {tag} real",
                 *parity_pass2(j, R, nx, P=1, key="pass2 P=1"))
        up = field(R, nx, P=1)
        got, want = both(lambda: b3.neumann_bc_planar_3d(up.clone(), shape))
        torch.cuda.synchronize()
        same = bool(torch.equal(got, want))
        print(f"parity bc3d {tag} real (P=1): exactly equal {same}")
        check(same, f"bc3d {tag} at P=1 differs from its plain version")
        del up, got, want
    gate(f"K3 k=2 real {N}^2", *parity_combine(2, N, N, P=1, key="K3 P=1"))
    print(f"parity-rw: {time.perf_counter() - t_ph:.1f} s")

    # ---------------------------------------------------------- 29. main-rw
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 29 main-rw")
    # benchmarks/perf_table.py's sg_row: the kink u0 = 4 atan(exp(x/1.5))
    # along x, v0 = 0, m = 1, Lx = 10, dt = 1e-4, m = 10, float32
    t_ph = time.perf_counter()
    from nlsolvers_tpu_torch.models.evolve import evolve_guarded
    from nlsolvers_tpu_torch.models.nonlinearities import realwave_potential

    def kink(shape):
        x = torch.linspace(-LX, LX, shape[-1], dtype=torch.float32,
                           device=dev)
        return (4.0 * torch.atan(torch.exp(x / 1.5))).expand(
            shape).contiguous()

    def realwave(kind, shape, c=None, integrator="gautschi"):
        prob = problems.realwave_problem(
            kind, shape, LX, DT, m_field=torch.ones(shape), c_field=c,
            integrator=integrator, krylov_m=KRYLOV_M, dtype=torch.float32)
        check(prob.meta["device"] == "cuda", "real-wave problem not on the "
              "card")
        return prob, prob.init(kink(shape), torch.zeros(shape, device=dev))

    def energy(u, v, V, c=None):
        """sum (v^2/2 + c |grad u|^2/2 + V(u)) dx^d in float64, forward
        differences, c on the faces (the operator's face weights)."""
        u, v = u.double(), v.double()
        h = 2.0 * LX / (u.shape[-1] - 1)
        e = (0.5 * v * v + V(u)).sum()
        for a in range(u.dim()):
            n = u.shape[a]
            g2 = torch.diff(u, dim=a) ** 2
            if c is not None:
                cd = c.to(dev).double()
                g2 = g2 * 0.5 * (cd.narrow(a, 0, n - 1) + cd.narrow(a, 1,
                                                                     n - 1))
            e = e + 0.5 * g2.sum() / (h * h)
        return float(e) * h ** u.dim()

    def main_rw(label, kind, prob, s0, snaps_, freq_, per_step, c=None):
        """problems.run with every launch counter at 0 just before and read
        just after: exactly per_step launches of each kernel per step and
        none of the others (no kick_bc, no K13), finite (u, v) snapshots;
        the relative energy drift printed, not gated."""
        n_steps = (snaps_ - 1) * freq_
        for f in counters_all.values():
            f.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, v = problems.run(prob, s0, snaps_, freq_)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: f.launches for k, f in counters_all.items()}
        want = {k: per_step.get(k, 0) * n_steps for k in counters_all}
        print(f"{label}: {n_steps} steps in {wall:.3f} s; launches "
              f"{ {k: v_ for k, v_ in got.items() if v_} } "
              f"({sum(got.values()) / n_steps:.0f} counted per step)")
        check(got == want, f"{label}: launches {got} != {want}")
        shp = (snaps_,) + tuple(s0[0].shape)
        check(tuple(u.shape) == shp == tuple(v.shape)
              and u.dtype == v.dtype == torch.float32,
              f"{label}: snapshots {tuple(u.shape)} {tuple(v.shape)}")
        check(bool(torch.isfinite(u).all() & torch.isfinite(v).all()),
              f"{label}: non-finite snapshot")
        V = realwave_potential(kind)
        E = [energy(u[k], v[k], V, c) for k in range(snaps_)]
        drift = max(abs(e - E[0]) / abs(E[0]) for e in E)
        print(f"{label}: energy {E[0]:.6e} -> {E[-1]:.6e}, relative drift "
              f"over {n_steps} steps {drift:.3e} (printed, not gated)")
        del u, v
        return got, n_steps

    def combine_specs(prob, s):
        """The number of matrix functions each K3 launch of one step
        combines (the rows of the coefficients it is given)."""
        ks, orig = [], lz.combine_coefficients

        def spy(*args):
            q = orig(*args)
            ks.append(int(q.shape[0]))
            return q

        lz.combine_coefficients = spy
        try:
            prob.step(s, 1)
        finally:
            lz.combine_coefficients = orig
        return ks

    per_rw2 = {"K1": 2, "K2": 2 * (KRYLOV_M - 1), "K3": 2,
               "recur": 2 * KRYLOV_M}
    per_rw2a = {"K1'": 2, "K2'": 2 * (KRYLOV_M - 1), "K3": 2,
                "recur": 2 * KRYLOV_M}
    per_rw3 = {"pass1_3d": 2 * (KRYLOV_M - 1), "pass2": 2 * KRYLOV_M,
               "K3": 2, "bc3d": 1}
    p_sg, s_sg = realwave("sine_gordon", (N, N))
    check(p_sg.meta["filter"] == "mod_cosine", "sine-Gordon filter")
    ks = combine_specs(p_sg, s_sg)
    print(f"main-rw: K3 launches of one Gautschi step combine {ks} matrix "
          f"functions")
    check(ks == [2, 1], f"K3 per step {ks} != [2, 1]")
    launches_rw, steps_rw = main_rw(f"main-rw sine-Gordon {N}^2",
                                    "sine_gordon", p_sg, s_sg, 5, 50,
                                    per_rw2)
    p_sg3, s_sg3 = realwave("sine_gordon", shape3)
    ks = combine_specs(p_sg3, s_sg3)
    check(ks == [2, 1], f"K3 per 3D step {ks} != [2, 1]")
    launches_rw3, steps_rw3 = main_rw(f"main-rw sine-Gordon {N3}^3",
                                      "sine_gordon", p_sg3, s_sg3, 3, 50,
                                      per_rw3)
    p_kg3, s_kg3 = realwave("klein_gordon", shape3, c3)
    main_rw(f"main-rw Klein-Gordon c(x) {N3}^3", "klein_gordon", p_kg3,
            s_kg3, 3, 50, per_rw3, c3)
    p_kg2, s_kg2 = realwave("klein_gordon", (N, N), c2)
    launches_rwa, steps_rwa = main_rw(f"main-rw Klein-Gordon c(x) {N}^2",
                                      "klein_gordon", p_kg2, s_kg2, 3, 50,
                                      per_rw2a, c2)
    print(f"main-rw: {time.perf_counter() - t_ph:.1f} s")

    # ---------------------------------------------------------- 30. paths-rw
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 30 paths-rw")
    # Each step of the kernel path against the same step, from the same
    # state, under the other setting: the Gautschi recurrence u' = 2 cos u
    # - u_past sums each step's rounding into the trajectory (quadratically
    # in the step count on the kink's flat part), so a free-running
    # comparison is printed beside the per-step one, not gated.
    t_ph = time.perf_counter()

    def step_under(prob, s, i, mode="auto", **sw):
        old = interop.set_switches(**sw)
        config.kernel_mode = mode
        try:
            return prob.step(s, i)
        finally:
            config.kernel_mode = "auto"
            interop.set_switches(**old)

    def paths_rw(label, prob, s0, other, n=n_par, tol=1e-5):
        s, worst = s0, 0.0
        for i in range(1, n + 1):
            a = step_under(prob, s, i)
            b = step_under(prob, s, i, **other)
            worst = max(worst, rel(a[0], b[0]))
            s = a
        t = s0
        for i in range(1, n + 1):
            t = step_under(prob, t, i, **other)
        free = rel(s[0], t[0])
        print(f"paths-rw {label}: {n} steps, each step from the kernel "
              f"path's state: max rel-L2 on u {worst:.3e} (gate {tol:g}); "
              f"free-running {n} steps {free:.3e}")
        check(worst <= tol, f"paths-rw {label}: rel-L2 {worst:.3e} > "
              f"{tol:g}")

    def launches_of(prob, s, **sw):
        for f in counters_all.values():
            f.launches = 0
        step_under(prob, s, 1, **sw)
        torch.cuda.synchronize()
        return {k: f.launches for k, f in counters_all.items()
                if f.launches}

    off = {"mode": "off"}
    for kind in ("sine_gordon", "double_sine_gordon",
                 "hyperbolic_sine_gordon", "klein_gordon", "phi4"):
        pk, sk = realwave(kind, (256, 256))
        paths_rw(f"{kind} 256^2 kernels vs kernel_mode off", pk, sk, off)
        if kind == "phi4":
            pk, sk = realwave(kind, (256, 256), 1.0 + 0.4 * torch.rand(
                (256, 256), generator=gen, device=dev))
            paths_rw(f"{kind} c(x) 256^2 kernels vs kernel_mode off", pk,
                     sk, off)
    paths_rw(f"sine-Gordon {N3}^3 kernels vs kernel_mode off", p_sg3, s_sg3,
             off)
    paths_rw(f"Klein-Gordon c(x) {N3}^3 kernels vs kernel_mode off", p_kg3,
             s_kg3, off)
    for label, prob, s, sw, want in (
            (f"fused_iter {N}^2", p_sg, s_sg, {"fused_iter": True},
             {"K5": 2 * (KRYLOV_M - 1), "pass2": 2, "K3": 2}),
            (f"fused_iter {N3}^3", p_sg3, s_sg3, {"fused_iter": True},
             {"K5": 2 * (KRYLOV_M - 1), "pass2": 2, "K3": 2, "bc3d": 1}),
            (f"pipeline_3d {N3}^3", p_sg3, s_sg3, {"pipeline_3d": True},
             {"pass2": 2, "pass1_3d": 2, "K8": 2 * (KRYLOV_M - 2), "K2": 2,
              "K3": 2, "bc3d": 1}),
            (f"pipeline_3d c(x) {N3}^3", p_kg3, s_kg3, {"pipeline_3d": True},
             {"pass2": 2, "pass1_3d": 2, "K8": 2 * (KRYLOV_M - 2), "K2": 2,
              "K3": 2, "bc3d": 1})):
        got = launches_of(prob, s, **sw)
        print(f"paths-rw {label}: launches per step {got}")
        check(got == want, f"{label}: launches per step {got} != {want}")
        paths_rw(f"{label} vs the default real path", prob, s, sw)
    print(f"paths-rw: {time.perf_counter() - t_ph:.1f} s")

    # ---------------------------------------------------------- 31. rate-rw
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 31 rate-rw")
    t_ph = time.perf_counter()
    r2 = f"rate-rw sine-Gordon {N}^2"
    rate(torch, {r2: (p_sg, s_sg)}, 200, [r2] * 3, 20)
    r3 = f"rate-rw sine-Gordon {N3}^3"
    rate(torch, {r3: (p_sg3, s_sg3)}, 100, [r3] * 3, 20)
    del p_sg3, s_sg3, p_kg3, s_kg3, p_kg2, s_kg2
    torch.cuda.empty_cache()
    p_big, s_big = realwave("sine_gordon", (N3_BIG,) * 3)
    rb = f"rate-rw sine-Gordon {N3_BIG}^3"
    rate(torch, {rb: (p_big, s_big)}, 20, [rb] * 3, 5)
    del p_big, s_big
    torch.cuda.empty_cache()
    print(f"rate-rw: {time.perf_counter() - t_ph:.1f} s")

    # ---------------------------------------------------------- 32. models-rest
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 32 models-rest")
    t_ph = time.perf_counter()
    nb_ = 512
    pbq = problems.boussinesq_problem((nb_, nb_), 20.0, 1e-3,
                                      krylov_m=KRYLOV_M, dtype=torch.float32)
    xb = torch.linspace(-20.0, 20.0, nb_, device=dev)
    ub = (0.5 / torch.cosh(0.7 * xb) ** 2).expand(nb_, nb_).contiguous()
    for f in counters_all.values():
        f.launches = 0
    ubq, vbq = problems.run(pbq, pbq.init(ub), 3, 5)
    torch.cuda.synchronize()
    got = {k: f.launches for k, f in counters_all.items() if f.launches}
    print(f"models-rest Boussinesq Gautschi {nb_}^2: 10 steps on the "
          f"generic path, counted kernel launches {got}, max |u| "
          f"{float(ubq[-1].abs().max()):.6f}")
    check(not got, f"Boussinesq launched counted kernels {got}")
    check(bool(torch.isfinite(ubq).all() & torch.isfinite(vbq).all()),
          "Boussinesq: non-finite snapshot")
    del ubq, vbq, pbq

    def phi4_run(seed):
        pst = problems.stochastic_phi4_problem((N, N), LX, DT, seed=seed,
                                               dtype=torch.float32)
        x = torch.linspace(-LX, LX, N, device=dev)
        u = torch.tanh(x / math.sqrt(2.0)).expand(N, N).contiguous()
        return problems.run(pst, pst.init(u), 3, 50)

    a_, b_, c_ = phi4_run(7), phi4_run(7), phi4_run(8)
    torch.cuda.synchronize()
    same = all(bool(torch.equal(x, y)) for x, y in zip(a_, b_))
    differ = not bool(torch.equal(a_[0][-1], c_[0][-1]))
    print(f"models-rest stochastic phi-4 SV {N}^2: 100 steps twice with one "
          f"seed bit for bit equal {same}; another seed differs {differ}")
    check(same and differ, "stochastic phi-4: seeds do not replay")
    check(bool(torch.isfinite(a_[0]).all()), "stochastic phi-4: non-finite")
    del a_, b_, c_

    S_g, f_g = 12, 2
    pdv = problems.realwave_problem("phi4", (256, 256), LX, 0.05,
                                    integrator="sv", dtype=torch.float32)
    udv = 3.0 + 0.1 * torch.randn((256, 256), generator=gen, device=dev)
    box_g = []

    def guarded():
        box_g.append(evolve_guarded(
            pdv.step, pdv.init(udv), S_g, f_g, observe=pdv.observe,
            scalars={"max_u": lambda s: s[0].abs().amax()}))

    n_sync = host_syncs(torch, guarded)
    (ug, vg), bad_g, ser_g = box_g[0]
    ser_g = ser_g["max_u"]
    k_g = int(bad_g)
    print(f"models-rest evolve_guarded phi-4 SV diverging: bad_at {k_g} of "
          f"{S_g} snapshots ({f_g} steps each), host syncs {n_sync}; max|u| "
          f"series {[f'{x:.3g}' for x in ser_g.tolist()]}")
    check(0 < k_g < S_g, f"evolve_guarded: bad_at {k_g}")
    check(not bool(torch.isfinite(ug[k_g]).all()
                   & torch.isfinite(vg[k_g]).all()),
          "evolve_guarded: the snapshot at bad_at is finite")
    check(not bool(ug[k_g + 1:].any() | vg[k_g + 1:].any())
          and not bool(ser_g[k_g + 1:].any()),
          "evolve_guarded: the snapshots after the exit are not zero")
    check(n_sync <= k_g + 1, f"evolve_guarded: {n_sync} host syncs for "
          f"{k_g} snapshots")
    print(f"models-rest: {time.perf_counter() - t_ph:.1f} s")

    # ---------------------------------------------------------- 33-36. datagen
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 33-37 datagen")
    dg_per_step, bat = datagen_phases(torch, np, root, counters_all)

    # ---------------------------------------------------------- 38. parity-batched-shard
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 38 "
          f"parity-batched-shard")
    t_ph = time.perf_counter()
    bat_sh = batched_parity_shard(torch, np)
    print(f"parity-batched-shard: {time.perf_counter() - t_ph:.1f} s")

    # ---------------------------------------------------------- 39. datagen-shard
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 39 datagen-shard")
    t_ph = time.perf_counter()
    sh_per_step = shard_datagen(torch, np, root, counters_sh)
    print(f"datagen-shard: {time.perf_counter() - t_ph:.1f} s")

    # ---------------------------------------------------------- 40. batch-axis
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 40 batch-axis")
    ba_per_sub, _ = batch_axis_phase(torch, np, root, counters_sh)

    # ---------------------------------------------------------- 41. study
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 41 study")
    study_phase(torch, np, root, counters_sh, rates2a[cx2])

    # ---------------------------------------------------------- 42. recurrence
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 42 recurrence")
    rc_times = recurrence_phase(torch, lz, operators, counters_all)

    def entry(kname, source, replaces, launches_, n_steps, err, t, nbytes,
              lib, nops=0, graph=None):
        """One kernel of the JSON line: `launches` over the n_steps of its
        main path's run; `ms`, `plain_ms`, `bound_ms` and `library_ms` per
        step of that path; bound_ms the larger of the bytes' and the float32
        operations' time. `ms` is the CUDA-graph reading where one is given
        (then the profiler's sum and the events stand beside it), else the
        profiler's sum."""
        by_ops = ops_ms(nops) > bound_ms(nbytes)
        e = dict(name=kname, route="cuda", source=source,
                 replaces=replaces, launches=launches_,
                 launches_per_step=launches_ / n_steps, max_abs_err=err,
                 ms=t[0] if graph is None else graph, plain_ms=t[2],
                 bound_ms=max(bound_ms(nbytes), ops_ms(nops)),
                 bound_by="operations" if by_ops else "bytes",
                 library_ms=lib)
        if graph is not None:
            e.update(graph_ms=graph, profiler_ms=t[0], events_ms=t[1])
        return e

    kernels = [
        entry("pass1_iso2d", SOURCE, f"{PALLAS}:473", launches["K1"], steps,
              errs["K1"], times["K1"], bytes2["K1"], None,
              graph=graphs["K1"]),
        entry("pipe_iso2d", SOURCE, f"{PALLAS}:779", launches["K2"], steps,
              errs["K2"], times["K2"], bytes2["K2"], None,
              graph=graphs["K2"]),
        entry("combine", SOURCE, f"{PALLAS}:1005", launches["K3"], steps,
              errs["K3"], times["K3"], bytes2["K3"], graphs["K3 matmul"],
              graph=graphs["K3"]),
        entry("pass1_3d", SOURCE3, f"{PALLAS3}:391", launches3["pass1_3d"],
              steps3, errs["pass1_3d"], t3["pass1_3d"], bytes3["pass1_3d"],
              None),
        entry("pass2", SOURCE3, f"{PALLAS}:938", launches3["pass2"], steps3,
              errs["pass2"], t3["pass2"], bytes3["pass2"], pass2_lib),
        entry("bc3d", SOURCE3, f"{PALLAS_BC}:52", launches3s["bc3d"],
              steps3s, 0.0, t3["bc3d"], bytes3["bc3d"], None),
        entry("pass1_aniso2d", SOURCE, f"{PALLAS}:473", launches_a["K1'"],
              steps, errs["K1'"], times_a["K1'"], bytes_a["K1'"], None,
              graph=graphs["K1'"]),
        entry("pipe_aniso2d", SOURCE, f"{PALLAS}:779", launches_a["K2'"],
              steps, errs["K2'"], times_a["K2'"], bytes_a["K2'"], None,
              graph=graphs["K2'"]),
        entry("ss2_resident_step", SOURCE_RS, f"{PALLAS_RS}:90",
              launches_r["K13"], steps_r, errs["K13"], t_rs, bytes_rs, None,
              ops_rs, graph=g_rs),
        entry("iter_step", SOURCE, f"{PALLAS}:637", launches_i["K5"],
              steps_i, errs["K5"], t_k5, bytes_k5, None, ops_k5,
              graph=g_k5[f"{N}^2"]),
        entry("pipe_3d", SOURCE3, f"{PALLAS3}:1135", launches_p["K8"],
              steps_p, errs["K8"], t_k8["iso"], bytes_k8, None,
              graph=g_k8["iso"]),
        entry("pass1_shard2d", SOURCE, f"{PALLAS}:473",
              launches_s2["pass1_shard2d"], steps_s2, errs["pass1_shard2d"],
              t_s["pass1_shard2d reference"],
              bytes_s["pass1_shard2d reference"], None),
        entry("pass1_shard3d", SOURCE3, f"{PALLAS3}:558",
              launches_s3["pass1_shard3d"], steps_s3, errs["pass1_shard3d"],
              t_s["pass1_shard3d clean"], bytes_s["pass1_shard3d clean"],
              None),
        entry("kick_bc", SOURCE_KB, f"{PALLAS_BC}:52", launches["kick_bc"],
              steps, errs["kick_bc"], t_kb[f"{N}^2"], bytes_kb[f"{N}^2"],
              None, graph=g_kb[f"{N}^2"]),
    ]
    # the recurrence kernel: per step of the main path (one Lanczos run of
    # KRYLOV_M columns), bit-equal to the eager recurrence (max_abs_err 0,
    # phase 42), plain_ms the eager recurrence's device time; beside it the
    # same at the task30 cell's point (RC_N^2 c(x), m = RC_M, B = RC_B)
    (k_main, eager_main), (k_30, eager_30) = rc_times["main"], \
        rc_times["task30"]
    e = entry("recur_kernel", SOURCE, f"{PALLAS}:1058 (jnp ops between the "
              f"kernels)", launches["recur"], steps, 0.0,
              (k_main, None, eager_main), recur_bytes(1, KRYLOV_M), None)
    e.update(task30_ms=k_30, task30_plain_ms=eager_30,
             task30_bound_ms=bound_ms(recur_bytes(RC_B, RC_M)),
             task30_launches=RC_M,
             datagen_launches_per_batched_step=dg_per_step["nlse 2D"][
                 "recur"])
    kernels.append(e)
    # the real-wave Gautschi step's launches per step (main-rw) and the P=1
    # sign -1 parity (parity-rw) beside each kernel of its path
    rw = {"pass1_iso2d": (launches_rw, "K1", steps_rw),
          "pipe_iso2d": (launches_rw, "K2", steps_rw),
          "combine": (launches_rw, "K3", steps_rw),
          "pass1_3d": (launches_rw3, "pass1_3d", steps_rw3),
          "pass2": (launches_rw3, "pass2", steps_rw3),
          "bc3d": (launches_rw3, "bc3d", steps_rw3),
          "pass1_aniso2d": (launches_rwa, "K1'", steps_rwa),
          "pipe_aniso2d": (launches_rwa, "K2'", steps_rwa),
          "recur_kernel": (launches_rw, "recur", steps_rw)}
    p1 = {"pass1_3d": errs["pass1_3d P=1"], "pass2": errs["pass2 P=1"],
          "bc3d": 0.0, "combine": errs["K3 P=1"]}
    # the batched forms of the datagen steps: launches per batched step of
    # B = DG_B lanes (datagen-engine: the 2D NLSE step, and for the 3D
    # kernels the 3D NLSE step; the real-wave steps' beside them), times
    # per batched step (parity-batched) beside the B unbatched launch
    # sequences
    # (K5 and K8: the engine's steps under fused_iter / pipeline_3d, times
    # at the 2D and 3D datagen points with c(x))
    for kname, key, ck, path, source, replaces in (
            ("pass1_aniso2d", "K1'", "K1'", "nlse 2D", SOURCE,
             f"{PALLAS}:473"),
            ("pipe_aniso2d", "K2'", "K2'", "nlse 2D", SOURCE,
             f"{PALLAS}:779"),
            ("combine", "K3", "K3", "nlse 2D", SOURCE, f"{PALLAS}:1005"),
            ("kick_bc", "kick_bc", "kick_bc", "nlse 2D", SOURCE_KB,
             f"{PALLAS_BC}:52"),
            ("pass1_3d", "pass1_3d", "pass1_3d", "nlse 3D", SOURCE3,
             f"{PALLAS3}:391"),
            ("pass2", "pass2", "pass2", "nlse 3D", SOURCE3, f"{PALLAS}:938"),
            ("bc3d", "bc3d P=1", "bc3d", "realwave 3D", SOURCE3,
             f"{PALLAS_BC}:52"),
            ("iter_step", f"K5 c(x) {DG_N}^2 m={DG_M}", "K5",
             "nlse 2D fused_iter", SOURCE, f"{PALLAS}:637"),
            ("pipe_3d", f"K8 c(x) {DG3_N}^3 m={DG3_M}", "K8",
             "nlse 3D pipeline_3d", SOURCE3, f"{PALLAS3}:1135")):
        r = bat[key]
        n_l = dg_per_step[path][ck]
        e = entry(f"{kname} batched", source, replaces, n_l, 1, r["err"],
                  r["t"], r["nbytes"], r["lib"], graph=r["graph"])
        e.update(lanes=DG_B, unbatched_lanes_graph_ms=r["lanes_graph"],
                 datagen_path=path,
                 datagen_launches_per_trajectory_step=n_l / DG_B)
        for other in ("realwave 2D", "nlse 3D", "realwave 3D"):
            if other != path and ck in dg_per_step[other]:
                e[f"launches_per_batched_step {other}"] = \
                    dg_per_step[other][ck]
        kernels.append(e)
    # the batched shard kernels: launches per batched sharded step of B =
    # SH_B lanes (datagen-shard: the 2D NLSE SS2 and 3D NLSE SS2 paths; the
    # other paths' beside them), times per batched sharded Lanczos run
    # (parity-batched-shard) beside the B lanes' unbatched launch sequences
    for kname, source, replaces, path in (
            ("pass1_shard2d", SOURCE, f"{PALLAS}:473",
             f"nlse 2D ss2 {SH_N}^2 m={DG_M} {SH_MESH2}"),
            ("pass1_shard3d", SOURCE3, f"{PALLAS3}:558",
             f"nlse 3D ss2 {SH_N3}^3 m={DG3_M} {SH_MESH3} reference")):
        r = bat_sh[kname]
        n_l = sh_per_step[path][kname]
        e = entry(f"{kname} batched", source, replaces, n_l, 1, r["err"],
                  r["t"], r["nbytes"], None, graph=r["graph"])
        e.update(lanes=SH_B, unbatched_lanes_graph_ms=r["lanes_graph"],
                 datagen_path=path)
        iso = bat_sh.get(f"{kname} iso")
        if iso is not None:      # the iso reference operator's run beside
            e.update(iso_graph_ms=iso["graph"],
                     iso_unbatched_lanes_graph_ms=iso["lanes_graph"],
                     iso_bound_ms=bound_ms(iso["nbytes"]),
                     iso_max_abs_err=iso["err"])
        for other, counts_ in sh_per_step.items():
            if other != path and kname in counts_:
                e[f"launches_per_batched_step {other}"] = counts_[kname]
        kernels.append(e)
    # the batch-axis paths (phase 40): launches per step per sub-mesh
    for e in kernels:
        key = {"pass1_shard2d batched": "pass1_shard2d",
               "pass1_shard3d batched": "pass1_shard3d",
               "pass1_aniso2d batched": "K1'", "pipe_aniso2d batched": "K2'",
               "combine batched": "K3", "pass2 batched": "pass2",
               "kick_bc batched": "kick_bc"}.get(e["name"])
        for path, counts_ in ba_per_sub.items():
            if key in counts_:
                e[f"launches_per_step_per_submesh batch-axis {path}"] = \
                    counts_[key]
    for e in kernels:
        if e["name"] in rw:
            got_, key_, n_ = rw[e["name"]]
            e["realwave_launches_per_step"] = got_[key_] / n_
        if e["name"] in p1:
            e["p1_max_abs_err"] = p1[e["name"]]
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
