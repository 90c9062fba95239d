"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing its results; any failure raises (non-zero exit):

1. the card: CUDA must be available; prints nvidia-smi's name and power
   limit; TF32 must be off.
2. builds the CUDA kernels from ``pfhubbenchmarks_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel).
3. holds each kernel against its plain PyTorch version on the card, on
   seeded inputs at bench1's shapes (J.v at 100^2/50^2/25^2 for both
   quadrature rules, at 100^2 also against ``torch.func.jvp`` of the
   residual, block-Jacobi and LMR at every level), with CUDA-event times of
   both; that ``_lib.stream_handle()`` is PyTorch's current stream (on a
   side stream too), with both getters' host us; and the transfers at every
   pair (100<->50, 50<->25; ``transfer_pair_checks``): kernel D through
   ``TransferPlan``, the object the main path calls, for prolong, prolong
   with ``out``, restrict and inject, unmasked and with seeded 0/1 masks,
   to the bit against the plain versions and against itself on a rerun;
   per-call and device times (launches queued behind a sleep kernel) of
   each op beside the library's, ``torch.sparse.mm`` of the prolongation's
   CSR matrix and its transpose (checked against the plain versions), per
   call and on the device; at 100->50 the host path of one restriction in
   parts (checks, allocation, stream handle, ctypes call; 1,000 calls
   each), the plan's and the old path's (a copy of the launch path before
   the plans, around the new kernel); kernel N at every level
   (``node_blocks_phase``) and N's one-launch build of the hierarchy
   (``node_build_phase``: every level's planes and the injected states in
   one launch, held to the per-level launches of N and the injections with
   ``torch.equal``).
4. bench1's main path: the port's bench1 at full size (100x100) through
   ``Runner.run``, the whole adaptive run to its final time (t = 1000, the
   JAX run's 74 rows to t = 1025.5), held against the committed
   ``results/bench1_out.csv`` by the ``tools/check_trajectories.py`` BOUNDS
   for bench1: the time column equal (rtol 1e-9) for at least the first 21
   rows, with TFE rel 1e-6 and solute rel 1e-9 on those rows; TFE
   interpolated onto the JAX run's times within rel 5e-3 over the whole run;
   the run reaches its final time. It prints the matched rows, the first
   row that parts, the dt decisions that flip, and steps, attempts, Newton
   and Krylov counts beside the JAX run's. Each kernel and chain of that
   path must have run in that run.
5. the same checks at bench6's shapes (F = 3, levels 100^2/50^2/25^2): the
   CH+Poisson J.v (kernel E) for both rules, J.v and b - J.v forms, with
   and without the Dirichlet mask, at 100^2 also against ``torch.func.jvp``
   of the residual; the transfers at every pair as in phase 3, with the
   problem's Dirichlet masks (the main path's case) and without; the
   descend and ascend chains' launch sequences against their plain twins;
   kernel N at every level with the Dirichlet masks and the one-launch
   build, as in phase 3; kernel W at BM6's physics (``tri_box_chp``,
   bench6's outer J.v: the triangle box with the Dirichlet rows in its
   store) at 100^2 and 37 x 23, with and without the mask, J.v and b - J.v,
   against E with ``torch.equal`` (required), its plain version and
   ``torch.func.jvp`` of the f64 residual (``chp_box_phase``).
6. bench6's main path: the port's bench6 at full size (100x100) through
   ``Runner.run`` to t = 3.19; the 14 rows against the committed
   ``results/bench6_out.csv`` (time column rtol 1e-9, TFE rel 1e-6, solute
   rel 1e-9); each kernel and chain of that path must have launched, kernel
   R (the f32 residual of the cp line search) among them. Its outer J.v
   is kernel W at BM6's physics (``tri_box_chp``), and E must not launch.
7. the same checks at bench2's shapes (F = 6, levels 100^2/50^2/25^2): the
   CH+AC J.v (kernel F), coupled at ffc3 and field-split at dunavant1, both
   forms, with 4 order parameters at every level and with 1 and 2 at 100^2,
   also against ``torch.func.jvp`` of the residual; block-Jacobi and LMR
   with the field groups; kernel N as in phase 3, field-split (the main
   path's) and coupled, with 4 order parameters at every level and with 1
   and 2 at 100^2, and the one-launch build of each of those six
   hierarchies; both chains' launch sequences with the groups; the warm
   multigrid build of the hierarchy (kernel N per level and the
   injections, median of 5); the transfers (D, F = 6) at every pair as in
   phase 3.
8. bench2's main path: the port's bench2 at full size (100x100, six
   fields) through ``Runner.run``, the whole adaptive run to its final time
   (t = 100, the JAX run's 126 rows to t = 101.99), held against the
   committed ``results/bench2_out.csv`` by the ``tools/check_trajectories.py``
   BOUNDS for bench2: the time column equal (rtol 1e-9) for at least the
   first 28 rows, with TFE rel 1e-5 and solute rel 1e-9 on those rows; TFE
   interpolated onto the JAX run's times within rel 3e-2; the final time
   reached. It prints the matched rows, the first row that parts and the
   dt decisions that flip. Each kernel (R and N among them) and both chains
   must have run; the seconds of its multigrid builds, timed inside the
   run, and their share of its wall.
9. the same checks at bench3's shapes (F = 2, levels 350^2/175^2/35^2/7^2,
   ratios 2, 5, 5): the AC + heat J.v (kernel G) at every level with
   dunavant2 and at 350^2 with ffc3, both forms, at 350^2 also against
   ``torch.func.jvp`` of the residual; the transfers at every pair as in
   phase 3: kernel H for 175<->35 and 35<->7, kernel D for 350<->175, with
   the host path of H's restriction at 175->35;
   block-Jacobi and LMR at 350^2; both level steps (TPU kernels 6 and 9) at
   each of the three pairs, their launch sequences and their kernels (a
   chain kernel of one level); kernel N at every level and the one-launch
   build (its injections at ratios 2, 5 and 5) as in phase 3; and
   the warm multigrid build of the 4-level hierarchy, with and without the
   dense 7^2 inverse, timed (medians of 5).
10. bench3's main path: the port's bench3 at full size (350x350) through
   ``Runner.run``, its first 14 rows (to t = 12.15, the
   ``tools/check_trajectories.py`` prefix) against the committed
   ``results/bench3_out.csv`` (time column rtol 1e-9, TFE rel 1e-6, solid
   fraction rel 1e-5); its coarsest solve must be the dense inverse, and
   each kernel, the sweep loop, both level steps and both chains must have
   run; the seconds of its multigrid builds, timed inside the run, and
   their share of its wall, split between kernel N's planes with the
   injections and the dense 7^2 inverse. bench3's full length runs in phase
   19's replay.
11. the same checks at bench1_3d's shapes (F = 2, Kuhn tets, levels
   50^3/25^3/5^3): the 3D Cahn-Hilliard J.v over tet boxes (kernel U) at
   50^3 with keast2 and ffc3, at 25^3 and 5^3 with keast2, against its plain
   version, ``torch.func.jvp`` of the residual (which is also its library
   time), the gather form (kernel I, its comparison: the max abs difference
   printed, I also against the plain version) and itself on a rerun (to the
   bit); the b - J.v form at keast2 50^3; U's and I's device time per launch
   in the same call (launches queued behind a sleep kernel), U's per-call
   time, bound, boxes, recompute factor, registers, spills and shared
   memory; B and C on 1-leaf states at 50^3; the per-call times of
   the 3D transfers (plain torch) 50<->25 and 25<->5; two warm multigrid
   builds of 50/25/5, with and without the dense 5^3 inverse (medians of 5
   in turns); and one K-cycle apply.
12. bench1_3d's main path: the port's bench1_3d at full size (50^3) through
   ``Runner.run`` to t = 52.7; the 24 rows against the committed
   ``results/bench1_3d_out.csv`` (the JAX package's run; time column rtol
   1e-9, TFE rel 1e-6, solute rel 1e-9) and the JAX run's Newton counts
   (98 accepted, 102 over all attempts); its coarsest solve must be the
   dense inverse, kernels U and L must have run and I must not; the
   seconds of its multigrid builds, timed inside the run. If the smoke has
   already run 1000 s when this phase starts, it runs the first 10 rows (to
   t = 12.7) and says so.
13. kernel R (the f32 residual) at bench6 (with its Dirichlet rows), bench2
   (1, 2 and 4 order parameters) and bench1 at 100^2 against its plain
   version (rtol 1e-5, atol 1e-5 max|R|); the tile kernels T10 and T12 at
   bench3 350^2 and 175^2 (ffc3 and dunavant2), bench1 and bench2 100^2
   (coupled ffc3, split dunavant1) and the JAX tests' bench1 24^2 and
   bench2 16^2, J.v and b - J.v, against their plain versions and
   ``torch.func.jvp`` of the f32 residual (their library call); TS and the
   tiled sweep loop at bench3 350^2, bench1 100^2, bench2 100^2 with and
   without the field groups and bench2 8^2; reruns of T12 and TS at 350^2
   must give the same bits; the device time per launch of G, T10 and T12
   at bench3 350^2 (queued behind a sleep kernel).
14. bench1 in the tiled configuration (``tiled_grid_kernels=True``): 10
   rows, with T10, T12, TS and the tiled sweep loop required; its time
   column and per-step Newton counts must equal phase 4's first 10, its
   Krylov counts and wall are printed beside them.
15. bench3 in the tiled configuration: its first 14 rows (to t = 12.15),
   held likewise against phase 10's 14.
16. kernel P (the FMA-ladder probe, TPU row 20) against its plain version
   at the TPU probe's four shapes and at one thread per vertex of kernel I
   at 50^3 and 25^3 (depth 200, rtol and atol depth x 2^-23 of max|ref|:
   one f32 ulp per step, nvcc contracting to FMA); its SASS must hold at
   least two FFMA or FMUL per step at every depth built (``cuobjdump``, the
   chain not folded); then the probe path, ``ops/fma_chain.probe`` (the
   device time of one launch as the slope between depths 200 and 400, and
   the f32 operations per second), with its launches counted.
17. bench1's replay: the port's bench1 at 100x100 through ``timeloop.run``
   on the time grid of ``results/bench1_replay.csv`` (the reference's 73
   rows), held against that CSV (the JAX package's replay: time column
   rtol 1e-9, TFE rel 1e-5, the REPLAY_BOUNDS of
   ``tools/check_trajectories.py``, solute rel 1e-9); the step to t = 65.5
   must be solved by the substep warm start. It prints the rung of every
   rescued step. If the smoke has run BENCH1_REPLAY_LATE_S by then, it runs
   the first 23 rows only (the t = 65.5 step included) and says so.
18. bench6's replay: the 14 rows of ``results/bench6_replay.csv``, TFE rel
   1e-6, solute rel 1e-9 (its first 7 rows if the smoke runs late).
19. bench3's replay: 350x350 on the 46 rows of
   ``results/bench3_replay.csv`` (to t = 103.03), TFE and solid fraction rel
   5e-4 (REPLAY_BOUNDS); the t = 41.59 step must take the 2 x (dt/2)
   fallback after both damped rungs ran, and each rung's Newton and Krylov
   counts are printed. If the smoke runs late, its first 28 rows (the
   t = 41.59 step included).
20. kernel S (the per-shard sweep of the sharded LMR smoother, TPU row 18)
   against its plain version at bench1 100^2 (stored 102x104 on 2 x 4) and
   bench3 350^2 (352x352) on 2 x 4 and 2 x 2 ``LocalComm`` meshes, seeded r,
   with its per-call, device and library times (``torch.func.jvp`` of the
   f32 residual over the shard's slab) at 2 x 4; the sharded sweep (n = 1
   and 3) against the single-device sweep loop (kernel L) on the
   unpadded grid (rtol 2e-4, atol 2e-5 max|ref|), nothing written into the
   padding; the per-call time of one sweep with its exchanges; the halo
   residual and functionals against the global f64 ones (rel 1e-12);
   ``DistComm`` over NCCL at world size 1 (a loopback rendezvous) against
   ``LocalComm`` 1 x 1 (within 1e-6, and says if bit-identical); then the
   path, the dry run's entry point (``parallel/dryrun.main``) at 2 x 4 on
   bench1 and bench3, which must launch S and C.
21. kernel Q (the row-block grid J.v probe, TPU row 19) at bench3 350^2 in
   7 blocks of 50: cases a and b against their plain versions, the fold to
   the bit; the folded case a against kernel G and ``torch.func.jvp`` of
   the f32 residual; the device time per launch of Q, its fold and G; then
   the path, the probe (``ops/gridjvp.probe``, cases a, b and c, which also
   times T12), which must launch Q.
22. kernel L (the LMR sweep loop of a gather level in one launch: TPU rows
   3, 4, 11, 15 and 17) at every gather level of the main paths and each
   sweep count they run there (bench1 100^2/50^2/25^2, bench6 with its
   Dirichlet mask, bench2 with the field groups at 100^2 and 25^2, bench3
   350^2/175^2/35^2, bench1_3d 50^3 and 25^3): against its plain version
   (TOL_F32), against the launch sequence B, J.v, C (the max abs difference
   printed; the target 0, required in 3D, where the J.v is kernel U and L
   runs U's box body) and against itself on a rerun (to the bit); device
   and per-call times of L and of the sequence, the bound, the grid and
   barrier count, and at levels of at most 20,201 nodes one CTA against the
   cooperative grid; in 3D also L's device time before kernel U (over I's
   gather body, PERF.md) and L's registers and shared memory.
23. the chain kernels (``vcycle_descend_chain``, ``vcycle_ascend_chain``:
   TPU rows 7 and 8, each chain of gather levels in one launch) at every
   main-path hierarchy (bench1 100/50/25, bench6 with its Dirichlet masks,
   bench2 with the field groups, bench3 350/175/35/7) and its sweep counts:
   against the launch sequence (``.sequence``; the max abs difference
   printed, the target 0), the plain version (TOL_F32) and a rerun (to the
   bit); device and per-call times of kernel and sequence in the same call,
   the plain version's per call, the bound, the grid, registers, spills and
   CTAs per SM (``chain_phase``).
25. bench2's replay: 100x100 on the 120 rows of
   ``results/bench2_replay.csv`` (to t = 101.67), TFE rel 3e-2 (the
   REPLAY_BOUNDS) and solute rel 1e-9; it prints the rung that solves the
   t = 81.51 step (the JAX run's: the continuation in dt). Its first 40
   rows if the smoke has run BENCH2_REPLAY_LATE_S by then.
26. bench2_eta1 (one order parameter), made through the registry
   (``benchmarks/registry.get_benchmark``), its whole adaptive run against
   ``results/bench2_eta1_out.csv`` (121 rows to t = 100.15): the final time
   reached and TFE interpolated onto its times within rel 3e-2, with the
   matched rows and the flipped dt decisions printed. Its first 28 rows
   if the smoke runs late.
27. prints the card line, the per-kernel JSON line, then
   ``{"ok": true, "device": ...}``.
28. kernel W (``tri_box``, the triangle-box J.v: each triangle's point
   tangents once, every node summed in the gather's order) at the shapes
   of ``TRI_BOX_CASES`` (bench1 100^2 and 37 x 23 at ffc3; bench2 100^2,
   50^2, 25^2 coupled at ffc3 with 4 order parameters, 100^2 with 2 and 1;
   bench3 350^2, 175^2, 35^2, 7^2 at ffc3), J.v and b - J.v: against its
   plain version (TOL_F32), against A, F or G with ``torch.equal`` and
   against itself on a rerun (both required); device us of W, A, F or G
   and T10 in the same call, per-call us of W, the gather kernel, the plain
   version and (at bench1 and bench2 100^2 and bench3 350^2)
   ``torch.func.jvp`` of the f32 residual, the bound, boxes, registers,
   spills, shared bytes and CTAs per SM (``tri_box_phase``).
29. the residual box (``residual_box``: kernel R's residual over triangle
   boxes, each point residual once, every node summed in R's order) at the
   shapes of ``RESIDUAL_BOX_CASES`` (bench2 100^2 with 4, 2 and 1 order
   parameters, bench6 100^2 with its Dirichlet rows, both at 37 x 23):
   against its plain version (TOL_R), against R with ``torch.equal`` and
   against itself on a rerun (both required); device us of the box and R
   in turns, per-call us of both and of the plain version, the bound,
   boxes, registers, spills, shared bytes and CTAs per SM
   (``residual_box_phase``).

30. kernel V (``vcycle_fused``: TPU row 5, a V-cycle apply and its exported
   A z in one cooperative launch with a thread-block cluster dimension) at
   the hierarchies of ``VCYCLE_CASES`` (bench1 100/50/25; bench2 with 4, 2
   and 1 order parameters at 100/50/25; bench1 at 74 x 46 / 37 x 23), with
   each benchmark's sweep counts, on the IC plus seeded noise injected down
   and kernel N's planes: z and A z against the split apply (``.sequence``:
   the descend chain, kernel L on the coarsest level, the ascend chain and
   kernel W) with ``torch.equal`` and against itself on a rerun (both
   required), against the plain version (TOL_F32); device us of V with the
   plan's scopes and with the coarsest level on cluster 0 and on the grid,
   of the coarsest phase alone in each scope (and on a cluster of 8), and
   of the split apply; per-call us of V and the split apply in turns, the
   plain version's; the bound; the cluster size, grid, registers, spills
   and co-resident clusters (``vcycle_phase``).
31. the anisotropic bench3 (``bench3.make(anisotropy=True)``, the physics
   "acha": the four-fold a(theta) read from the state's gradient), last
   before the summary (``aniso_phase``): kernel W (``tri_box_acha``) at
   350^2 ffc3 against its plain version, the gather form (``acha_jvp``,
   ``torch.equal``, required), ``torch.func.jvp`` of the f64 residual (the
   f32 one forms grad phi with the cancellation the kernels avoid) and a
   rerun, with device us of both and per-call us of W / gather / plain /
   ``torch.func.jvp``; the gather and kernel N (its "ach" kernel, to the
   bit the isotropic plan's) at every dunavant2 level of 350/175/35/7 and
   the run's one-launch build (its "ach" kernel); the
   level steps and the two chains (``vcycle_{descend,ascend}_chain_acha``)
   against their plain versions and sequences; then the anisotropic run at
   350^2 over the 34 rows of ``tests/data/bench3_aniso_jax_rows.csv`` (the
   JAX package's CPU run, ``tools/jax_bench3_aniso_rows.py``): time column
   equal, TFE rel 1e-6, solid fraction rel 1e-5, each row's Newton count
   that of the ``.json``, the Krylov counts printed beside it; it requires W,
   both chains and N's one-launch build at those instantiations and refuses
   the gather, the isotropic kernels and L.
32. kernels U and L at bench6_3d's physics with the Dirichlet mask
   (``chp3d_tile``, ``lmr_loop_chp3d``: port kernels with no TPU row, the
   JAX package runs bench6_3d on XLA) at its levels 50^3 and 25^3, ffc3,
   the x-face rows of phi masked (``chp3d_phase``): U's J.v and b - J.v
   against its plain version and ``torch.func.jvp`` of the f32 residual
   with its BC rows (TOL_F32), its masked rows equal to v and b - v
   (``torch.equal``), a rerun to the bit; L with 2 sweeps against its plain
   version (TOL_F32), its sequence B, U, C and a rerun (to the bit, both
   required); device and per-call us of each beside its plain version, the
   library call (U) and the sequence (L), the bounds (CHP3D_OPS), the
   ptxas lines of both sources and registers, spills and CTAs per SM.
33. bench6_3d's main path (``bench6_3d_phases``): at 20^3 the whole run (9
   rows to t = 3.83) against every row of ``tests/data/bench6_3d_jax_rows_20``
   (the JAX package's CPU run, ``tools/jax_bench6_3d_rows.py``), and at its
   published 50^3 the whole run to t >= 3 with the rows that
   ``tests/data/bench6_3d_jax_rows`` holds checked (only those rows if the
   smoke has run BENCH6_3D_LATE_S by then, which it says): time column
   rtol 1e-9, TFE rel 1e-6, solute rel 1e-9, each row's Newton count that
   of the ``.json`` (the Krylov counts printed beside them); on every row
   phi on its x faces to 1e-9 (every accepted state), the solute conserved
   to rel 1e-10 of row 1 and TFE decreasing. U and L at CHP3 are required,
   L launched 4 times per Krylov iteration (every sweep loop) and U more
   than 3 times (the outer J.v and each level's b - A x), one
   preconditioner apply 6 wrapper calls; the CH3 U and L, B, C, the 2D
   kernels and the chains are refused.

34-36. the f64 linear branch (``linear_phases``; no kernel: the JAX package
   runs it in XLA): poisson at 64^2 (34), poisson3d at 32^3 (35) and elast
   at 250 x 10 (36), their published sizes, through ``timeloop.run`` on the
   card, each held to the JAX package's CPU row of
   ``tests/data/linear_jax_rows.json`` (``tools/jax_linear_rows.py``): the
   time column and the Newton count (1) equal, the observables within rel
   1e-6, the Krylov counts printed beside the JAX run's (not held). The
   port's L2 rates on the card: poisson at 16/32/64 in 1.8-2.3, poisson3d
   at 12/24 in 1.7-2.4 (tests/test_manufactured.py's bounds). elast's
   strain energy within abs 5e-11 of ``results/elast_out.csv`` (half a
   unit of its last printed digit) and its tip deflection within rel 1e-6
   of it (the CSV's tip is the TPU run's, 2.5e-9 from the JAX package's CPU
   run); the dense build's parts (the J columns, the LU, the explicit
   inverse; ``_lib.SECONDS``) in the run and in a warm build, one apply's
   CUDA-event time, the solve's wall and its peak
   ``torch.cuda.max_memory_allocated``. Each problem runs once more under
   ``HostFloats``: every aten op of the run is watched, and a
   floating-point result on the CPU of more than ``HOST_FLOATS_MAX``
   elements (anything larger than FGMRES's Hessenberg column) fails the
   phase; the final state must be on the card. No kernel may launch.

Phases 28, 29 and 30 run between 7 and 8, phases 32 and 33 after 12, phases
20-24 after 25 and 26, phases 34-36 after 31. The
outer J.v and the exported A z of bench1 (4, 17), bench2 (8, 25),
bench2_eta1 (26) and bench3 (10, 19) are kernel W: those phases require it
and refuse A's, F's or G's launches; the tiled bench1 (14) and bench3 (15)
require T10 and W. The f32 residual of the cp line search of bench6 (6,
18), bench2 (8, 25) and bench2_eta1 (26) is the residual box: those phases
require it and refuse R's launches. The apply with its exported A z of bench1 (4,
17), bench2 (8, 25) and bench2_eta1 (26) is kernel V: those phases require it
and refuse the chain kernels' and L's launches. Every main-path phase prints
its Newton and Krylov counts beside those of the smokes before kernel V and
before the boxes of A and R, which were equal (``COUNTS_BEFORE_BOXES``), its
time column as equal to theirs or not, its wall, and the
seconds of its multigrid builds and
their share of its wall (the dense coarse inverse apart) beside those of the
smokes before kernel N (PERF.md section 5), and refuses a ``torch.func.jvp`` block
build on its path; where ``COUNTS_BEFORE_BOXES`` records its step count, its
Newton and Krylov counts must equal those. Every 2D main path (4, 6, 8, 10,
14, 15, 17-19, 25, 26, 31) requires N's one-launch build, one launch per
multigrid build (``node_build`` launches equal to the builds), and refuses
the per-level N (``node_blocks``). Every other main-path phase on gather
levels (6, 10, 18, 19) requires the two chain kernels and refuses B's and
C's launches (a gather level's sweeps run
inside L, and inside the chain kernels), the chains' and level steps'
launch sequences (each chain is one launch) and D (the builds' injections
run in N's one launch); kernel L runs the coarsest
level's sweeps where that is not the dense inverse, and bench1_3d's K-cycle
(12). The tiled runs (14, 15) keep the chains' launch sequences, and their
tiled levels sweep with TS and C. Each main-path phase also prints the
wrapper calls (kernel launches and chain calls) of one preconditioner apply
in its configuration (at most 5 for bench1, bench6 and bench2, 4 for bench3:
required) and its ms per Krylov iteration.

In the kernel line, ``kernels`` lists the CUDA kernels: ``launches`` is the
sum of a kernel's launches over the main-path runs (each counted from 0
just before its run; ``paths`` splits it), ``ms``/``plain_ms`` are the
CUDA-event times of its first timed case (or of the case named its main
shape: T12's is bench3 350^2 at dunavant2, its level rule), ``bound_ms``
the least time the
card could take for that case: the larger of its bytes (each input read
once, each output written once) over 3.35 TB/s and its f32 operations over
67 TFLOP/s (H100 SXM data sheet), with ``bound_by`` naming which.
``library_ms`` is one PyTorch call computing the same function where there
is one (block-Jacobi's einsum pair; for the J.v kernels A, E, F, G, I, U,
W, T10, T12 and Q ``torch.func.jvp`` of the f32 residual, for S over the shard's
slab; for the transfers D and H ``torch.sparse.mm`` of the transfer's CSR
matrix), else null (R and the residual box have no library call). Kernel
I's record names U as ``comparison_of``, and R's the residual box: each
took the other's place on the main paths, so its launches there are 0.
``device_ms``, where present (L at bench2's 25^2 with 8 sweeps and the
groups, its main shape; W at bench2's 100^2 with 4 order parameters, its
main shape, and A and F at theirs, from phase 28; the residual box at
bench2's 100^2 with 4 order parameters, from phase 29; G at bench3's 350^2 at
ffc3, from phase 9; D at bench1's 100<->50 prolongation and H at
bench3's 175<->35 prolongation; kernels U, I, B and C at bench1_3d's 50^3, R at
bench6's 100^2, T10, T12 and TS at bench3's 350^2, S on one shard of
bench3's 350^2 on 2 x 4, Q's case a without its fold), is the device time of one launch: launches
queued behind a sleep kernel, between two CUDA events. For kernel P the
main shape is one thread per vertex of kernel I at 50^3, its ``launches``
those of the probe path, its ``device_ms`` the probe's slope times the
depth (the launch cost cancelled). Kernel S's main shape is one shard of
bench3 350^2 on 2 x 4, its ``launches`` those of the two dry runs; Q's is
case a at 350^2 (``ms`` and ``plain_ms`` the whole J.v, slabs and fold),
its ``launches`` those of the probe path (the fold counted as one more).
The chain kernels' main shape is bench1's 100/50/25 (phase 23); the
anisotropic instantiations' (``acha_jvp``, ``tri_box_acha`` and the
``_acha`` chains, phase 31) bench3's 350^2 and 350/175/35/7, the gather's
record naming W as ``comparison_of``. Kernel N's
(``node_blocks``, a port kernel with no TPU row: its ``replaces`` names the
JAX function it computes, and ``note`` says so) is bench2's 100^2 with the
field-split tangent, its ``library_ms`` the ``torch.func.jvp`` build of the
same planes and its ``device_ms`` one launch queued behind a sleep kernel;
it names N's one-launch form (``node_build``, bench2's split build of
100/50/25 its main shape, ``library_ms`` null) as ``comparison_of``, and E
(``chp_jvp``) names W at BM6's physics (``tri_box_chp``, its main shape
bench6's 100^2 with the Dirichlet mask). U and L at bench6_3d's physics
(``chp3d_tile``, ``lmr_loop_chp3d``, phase 32) are port kernels with no TPU
row (``note``); their main shape is bench6_3d's 50^3 at ffc3 with the mask
(L with 2 sweeps, ``library_ms`` null), their launches those of phase 33's
two runs.
``chains`` lists
the tiled sweep loop and the launch sequences of the two V-cycle level
steps and the two chains, which stand for TPU kernels 13 (the tiled sweep
loop: TS and C), 6 and 9 (the level steps) and 7 and 8 (the chains; their
kernels are ``vcycle_descend_chain`` and ``vcycle_ascend_chain``, and the
sequences run only on the tiled configuration), with the same keys,
except ``calls`` (calls on the main paths) in place of
``launches`` and ``sequence_of`` in place of ``route``; their arithmetic is
counted again under the kernels.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

HERE = os.path.dirname(os.path.abspath(__file__))
# bench1's whole adaptive run (phase 4): the tools/check_trajectories.py
# BOUNDS, and the JAX run's counts (BENCH_r05.json's breakdown)
BENCH1_MIN_MATCHED, BENCH1_INTERP_TOL = 21, 5e-3
JAX_BENCH1 = dict(steps=74, attempts=86, newton=327, krylov=4936,
                  krylov_all=5874)
BENCH1_TILED_ROWS = 10                # phase 14: to t = 11.1
BENCH6_ROWS = 14                      # results/bench6_out.csv, to t = 3.19
# bench2's whole adaptive run (phase 8, 126 rows to t = 101.99): the
# tools/check_trajectories.py BOUNDS
BENCH2_MIN_MATCHED, BENCH2_INTERP_TOL = 28, 3e-2
BENCH3_ROWS = 14                      # phases 10, 15: to t = 12.15
BENCH1_3D_ROWS = 24                   # results/bench1_3d_out.csv, to t = 52.7
BENCH1_3D_PREFIX_ROWS = 10            # to t = 12.7, if the smoke runs late
BENCH1_3D_LATE_S = 1000.0
JAX_BENCH1_3D_NEWTON = (98, 102)      # accepted, over all attempts
# bench6_3d (phase 33): the JAX package's CPU rows (tools/jax_bench6_3d_rows.py)
# at 20^3 (the whole run) and at 50^3 (its first rows); the 50^3 run is cut
# to the rows of its file if the smoke has run BENCH6_3D_LATE_S by then
BENCH6_3D_ROWS_20 = "bench6_3d_jax_rows_20"
BENCH6_3D_ROWS_50 = "bench6_3d_jax_rows"
BENCH6_3D_LATE_S = 900.0
# kernel L's device us per call in 3D before kernel U, over kernel I's gather
# body (2 sweeps; PERF.md)
L3D_BEFORE_U_US = {50: 99.3, 25: 42.2}
P_DEPTH = 200                         # phase 16: the TPU probe's default
# phase 20: kernel S and the dry run at bench1 100^2 and bench3 350^2;
# phase 21: kernel Q at bench3 350^2 in 7 row blocks of 50 (the TPU probe's)
SHARD_CASES = (("bench1", 100), ("bench3", 350))
Q_NX, Q_BR = 350, 50
# the replays (phases 17-19): all rows, or a prefix that keeps the rescued
# steps (bench1's t = 65.5, bench3's t = 41.59) if the smoke runs late
BENCH1_REPLAY_ROWS, BENCH1_REPLAY_PREFIX, BENCH1_REPLAY_LATE_S = 73, 23, 780.0
BENCH6_REPLAY_ROWS, BENCH6_REPLAY_PREFIX, BENCH6_REPLAY_LATE_S = 14, 7, 900.0
BENCH3_REPLAY_ROWS, BENCH3_REPLAY_PREFIX, BENCH3_REPLAY_LATE_S = 46, 28, 900.0
# phases 25, 26: bench2's replay (the t = 81.51 step is its row 110) and
# bench2_eta1's whole run (121 rows), or these prefixes if the smoke runs
# late
BENCH2_REPLAY_ROWS, BENCH2_REPLAY_PREFIX, BENCH2_REPLAY_LATE_S = 120, 40, 800.0
BENCH2_ETA1_PREFIX, BENCH2_ETA1_LATE_S = 28, 880.0
# Newton / Krylov and Newton / Krylov over all attempts of the smokes before
# kernel N (PERF.md section 5), by phase label and step count
COUNTS_BEFORE_N = {("phase 4: bench1", 74): ((327, 4998), (368, 5891)),
                   ("phase 6: bench6", 14): ((28, 1114), None),
                   ("phase 8: bench2", 14): ((62, 684), (71, 1131)),
                   ("phase 10: bench3", 14): ((58, 357), None),
                   ("phase 12: bench1_3d", 24): ((98, 8675), (102, 9005)),
                   ("phase 17: bench1 replay", 73): ((285, 7713), (388, 10502)),
                   ("phase 19: bench3 replay", 46): ((193, 1568), (308, 3417))}
# Newton / Krylov and Newton / Krylov over all attempts of the smokes before
# W at BM1 and the residual box took A's and R's place (PERF.md section 5),
# which the boxes keep (they give the gather kernels' bits), by phase label
# and step count
COUNTS_BEFORE_BOXES = {
    ("phase 4: bench1", 74): ((327, 4998), (368, 5891)),
    ("phase 6: bench6", 14): ((28, 1107), None),
    ("phase 8: bench2", 126): ((583, 9431), (672, 12475)),
    ("phase 10: bench3", 14): ((58, 369), (61, 604)),
    ("phase 12: bench1_3d", 24): ((98, 8675), (102, 9005)),
    ("phase 17: bench1 replay", 73): ((285, 7713), (388, 10502)),
    ("phase 18: bench6 replay", 14): ((28, 1104), None),
    ("phase 19: bench3 replay", 46): ((193, 1577), (308, 3472)),
    ("phase 25: bench2 replay", 120): ((544, 9048), (689, 11893)),
    ("phase 26: bench2_eta1", 121): ((558, 8478), (586, 9705))}
TOL_F32 = dict(rtol=2e-4, atol_scale=2e-5)   # tests/test_pallas_vcycle.py
# the walls of the last two smokes before kernel N, A (working tree) and B
# (git archive), NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 5), by phase
# label and step count
WALLS_BEFORE_N = {
    ("phase 4: bench1", 74): (49.331, 38.322),
    ("phase 6: bench6", 14): (5.377, 4.138),
    ("phase 8: bench2", 14): (169.736, 133.619),
    ("phase 10: bench3", 14): (17.645, 13.890),
    ("phase 12: bench1_3d", 24): (151.956, 121.097),
    ("phase 17: bench1 replay", 73): (60.930, 49.609),
    ("phase 18: bench6 replay", 14): (5.175, 4.144),
    ("phase 19: bench3 replay", 46): (76.347, 68.817)}
# the multigrid builds of smoke A, before kernel N: seconds and share of the
# wall (PERF.md section 5)
BUILDS_BEFORE_N = {
    ("phase 4: bench1", 74): (38.578, 0.782),
    ("phase 8: bench2", 14): (166.6, 0.9816),
    ("phase 10: bench3", 14): (16.13, 0.9141)}
# the most wrapper calls one preconditioner apply may make on the gather
# paths: two chain launches and the coarsest solve (one L launch; bench3's
# dense inverse makes none)
MAX_CALLS_PER_APPLY = {"bench1": 5, "bench6": 5, "bench2": 5, "bench3": 4}
# on a gather path no level runs B or C (their bodies run in L), no chain
# runs as its launch sequence (it is one launch of a chain kernel), and no
# build launches N per level or injects by D (N's one launch does both)
GATHER_ABSENT = ("block_jacobi_apply", "lmr_step", "descend_level",
                 "ascend_level", "descend_chain", "ascend_chain",
                 "node_blocks", "transfer_dyadic")
TOL_R = dict(rtol=1e-5, atol_scale=1e-5)     # tests/test_pallas.py:22-28
TOL_EXACT = dict(rtol=0.0, atol_scale=0.0)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def chac_tangent_ops(ne: int, split: bool) -> int:
    """f32 operations per point of BM2's tangent (chac_jvp.cu, ``ne`` order
    parameters), counted as in TANGENT_OPS. Both operators: the c row and
    the mu flux 5; f_b - f_a = rho^2 (c_a - c_b)(2c - c_a - c_b), linear in
    c, 2; per eta e^2, t = e - e^2 and h'' = 60 t (1 - 2e), 6; sum_j e_j^2,
    ne - 1; per eta row 13: sum_{j!=i} e_j^2 as the total minus e_i^2 (1),
    w dwell' = 2w - 12w t (2), the diagonal factor (4), times de_i (1), the
    source with de_i/dt (3) and the flux (2). Split: the mu source
    dmu - 2 rho^2 dc, 2. Coupled adds per eta h' = 30 t^2 (2), e_i de_i (1),
    h' de_i (1) and their sums (2 (ne - 1)), 2 rho^2 (c_a - c_b) dc once
    (1), the two eta terms of the mu source (2), and per eta row 6:
    sum_{j!=i} e_j de_j as the total minus e_i de_i (1), 4 w alpha e_i times
    it (2), h'(e_i) times the dc term (1) and two adds."""
    ops = 5 + 2 + 6 * ne + (ne - 1) + 13 * ne + 2
    if not split:
        ops += 4 * ne + 2 * (ne - 1) + 1 + 2 + 6 * ne
    return ops


# f32 operations of one pointwise tangent, counted as what the function
# needs: a mul or an add is 1 (negations fold into the contraction),
# products of the physics constants and 1/dt are per-launch constants,
# shared subexpressions count once, a polynomial of the state takes its
# cheapest form, and a sum over j != i is the total minus its own term.
# CH (ch_jvp.cu, F = 2): dc/dt 1, the two fluxes 4, f''(c) (quadratic, by
# Horner) 4, dmu - f'' dc 2. CH+Poisson (chp_jvp.cu, F = 3): CH's, the k
# dphi term of the mu source 2, the phi source (k/eps) dc 1. CH + 4 AC
# (chac_jvp.cu, F = 6): chac_tangent_ops.
# AC + heat (ach_jvp.cu, F = 2, bench3): phi^2 and s = 1 - phi^2 2, dg/dU =
# -lam s^2 2, dg/dphi = 1 - 3 phi^2 + 4 lam U phi s 6, dg 3, the two sources
# (d/dt, the dg term, the difference) 6, the U fluxes 6, the phi fluxes 2.
# AC + heat with the four-fold anisotropy (phys_acha.cuh, F = 2, the
# anisotropic bench3), per point: phi^2 and s 2, g = (phi - lam U s) s 4,
# dg/dU 2, dg/dphi 6 (lam U shared with g), dg 3, inv_tau dg + g d inv_tau
# 3, the two sources 5; the flux terms, counted per point as "ach" counts
# them: d theta 4, d inv_tau 3, d beta 1, the phi fluxes 10, the U fluxes 6.
TANGENT_OPS = {2: 11, 3: 14,
               (6, "coupled"): chac_tangent_ops(4, False),
               (6, "split"): chac_tangent_ops(4, True), "ach": 27,
               "acha": 25 + 24}
# ACHA::tri, once per triangle: the gradient of phi 10, r^2 3, r 1, cos and
# sin of theta 2, (cos + i sin)^m at m = 4 24, cos and sin of m (theta -
# theta0) 6, a 2, beta 2, a''/a - beta^2 4, 1/r^2 1, inv_tau 2
ACHA_TRI_OPS = 10 + 3 + 1 + 2 + 24 + 6 + 2 + 2 + 4 + 1 + 2


def chac_residual_ops(ne: int) -> int:
    """f32 operations per point of BM2's terms (phys_chac.cuh's residual,
    ``ne`` order parameters), counted as in TANGENT_OPS. The c row and the
    mu flux: (c - c0)/dt 2, the fluxes 4; 2 rho^2 ((c - c_a) + (c_a - c_b)
    H) 4 and the mu source 1; f_b - f_a, linear in c, 2; H and sum_j e_j^2,
    2 (ne - 1) adds. Per eta 27: e^2, e^3 and h(e) by Horner 7, t = e - e^2
    1, h' = 30 t^2 2, dwell = 2 t (1 - 2e) 4, sum_{j!=i} e_j^2 as the total
    minus e^2 1, the derivative (f_b - f_a) h' + w dwell + 2 w alpha e
    sum 6, the source with (e - e0)/dt 4, the flux 2."""
    return 11 + 2 + 2 * (ne - 1) + 27 * ne


# f32 operations of the pointwise terms (kernel R's Phys::residual), counted
# as in TANGENT_OPS. CH (phys_ch.cuh): (c - c0)/dt 2, the two fluxes 4,
# f'(c) = 2 rho_s a b (b - a) with a = c - c_a, b = c_b - c 6, mu - f' 1.
# CH+Poisson (phys_chp.cuh): CH's, the k phi term of the mu source 2, the
# phi source (k/eps) c 1. CH + AC: chac_residual_ops.
RESIDUAL_OPS = {"ch": 13, "chp": 16, 1: chac_residual_ops(1),
                2: chac_residual_ops(2), 4: chac_residual_ops(4)}


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def device_ms(fn) -> float:
    """Device time of one call of ``fn``: the package's queued-launch timer
    (ops/_lib.device_ms, 40 calls behind a sleep kernel)."""
    from pfhubbenchmarks_tpu_torch.ops import _lib

    return _lib.device_ms(fn)


def cuda_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median per-call time of ``fn`` over ``reps`` CUDA-event windows."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def interleaved_ms(fns: dict, rounds: int = 8, reps: int = 8) -> dict:
    """Median per-call ms of each function of ``fns`` (CUDA events around one
    call), timed in turns: ``rounds`` rounds of ``reps`` calls of each, so a
    drift of the host's speed reaches all of them alike."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            for _ in range(reps):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                b.synchronize()
                times[name].append(a.elapsed_time(b))
    return {name: statistics.median(t) for name, t in times.items()}


# ---- work of one call, from the shapes (for bound_ms) ----------------------

def nodes(g) -> int:
    return (g.ny + 1) * (g.nx + 1) + g.ny * g.nx


def jvp_work(g, F, masked=False, with_b=False, ops=None, ns=1, tri_ops=0):
    """(bytes, flops) of one J.v: ``ns`` state planes + F tangent planes (+
    b, mask) in, F planes out. Per triangle (4 per cell, 3 nodes each): the
    F gradients (2 * (3 mul + 2 add) per field) and ``tri_ops`` (a tangent
    that reads the state's gradient: ACHA_TRI_OPS), and per quadrature point
    the interpolation of the state and the F tangents (3 mul + 2 add each),
    the tangent (``ops``, default TANGENT_OPS[F]) and the test-function
    contraction (3 nodes x 3 terms x mul + add per field)."""
    N, nq = nodes(g), g.tab().nq
    ops = TANGENT_OPS[F] if ops is None else ops
    byts = 4 * (ns * N + 2 * F * N + (F * N if with_b else 0)
                + (F * (g.ny + 1) * (g.nx + 1) if masked else 0))
    flops = g.ny * g.nx * 4 * (10 * F + tri_ops
                               + nq * (5 * (ns + F) + ops + 18 * F))
    return byts, flops


def residual_work(g, F, ops, n_prev, masked=False):
    """(bytes, flops) of one residual: F state planes, the ``n_prev`` planes
    of the previous time level that the terms read (+ the Dirichlet mask and
    g) in, F planes out. Per triangle the F gradients (10 per field), per
    quadrature point the interpolation of the F fields and the n_prev
    previous ones (5 each), the terms (``ops``) and the test-function
    contraction (18 per field)."""
    N, nq = nodes(g), g.tab().nq
    byts = 4 * ((2 * F + n_prev) * N
                + (2 * F * (g.ny + 1) * (g.nx + 1) if masked else 0))
    flops = g.ny * g.nx * 4 * (10 * F + nq * (5 * (F + n_prev) + ops + 18 * F))
    return byts, flops


def tile_sweep_work(g, F, jv_kw=None, groups=None):
    """TS: the state planes, r and the block planes in, z and A z out; the
    block-Jacobi apply and the J.v."""
    jv_kw = jv_kw or {}
    N = nodes(g)
    bj_b, bj_f = bj_work(g, F, groups)
    return (bj_b + 4 * (jv_kw.get("ns", 1) + F) * N,
            bj_f + jvp_work(g, F, **jv_kw)[1])


def bj_work(g, F, groups=None):
    """Reads the in-group planes (all F^2 without groups) and r, writes z."""
    N = nodes(g)
    planes = F * F if groups is None else sum(len(gr) ** 2 for gr in groups)
    return 4 * (planes * N + 2 * F * N), 2 * planes * N


def lmr_work(g, F):
    N = nodes(g)   # x, r, z, Az in; x, r out; two dots and two axpys
    return 4 * 6 * F * N, 8 * F * N


def general_nnz(coarse, fine):
    """Nonzero weights of the general-ratio prolongation (kernel H): the
    class weights of every coarse cell's fine vertices and centres, 2 per
    node of the last fine row and column (1 where px = 0) and the corner."""
    from pfhubbenchmarks_tpu_torch.ops.transfer import class_tables

    R = fine.nx // coarse.nx
    wv, wm, _ = class_tables(R)
    cells = coarse.ny * coarse.nx
    edge = (2 * R - 1) * (coarse.nx + coarse.ny)
    return cells * (int((wv != 0).sum()) + int((wm != 0).sum())) + edge + 1


def transfer_work(coarse, fine, F, op, masked=False, accumulate=False):
    """Dyadic (kernel D): 2 operations per fine node and field; an odd ratio
    (kernel H): a multiply and an add per nonzero weight of P and field."""
    nc, nf = nodes(coarse), nodes(fine)
    mask = F * ((fine if op == "prolong" else coarse).ny + 1) * (
        (fine if op == "prolong" else coarse).nx + 1) if masked else 0
    flops = (2 * F * nf if fine.nx == 2 * coarse.nx
             else 2 * F * general_nnz(coarse, fine))
    if op == "prolong":
        return 4 * (F * nc + F * nf * (2 if accumulate else 1) + mask), flops
    return 4 * (F * nf + F * nc + mask), flops


def transfer_matrices(coarse, fine, prolong, dev, k=4):
    """The prolongation ``prolong(wc, coarse, fine)`` as a CSR matrix P [fine
    nodes, coarse nodes] (vertex plane, then centre plane, flattened) and
    R = P^T, f32 on the card: the one PyTorch call (``torch.sparse.mm``)
    that computes what kernels D and H compute. From 4 k^2 probes in f64:
    per leaf and class (iy mod k, ix mod k) of coarse nodes, the ones of
    the class, and the same with each node's flat index plus one; a P1
    prolongation reaches one coarse cell's corners and centre, so a fine
    node i meets at most one node j of a class, and its two values are
    P[i, j] and (j + 1) P[i, j]."""
    shapes = (coarse.vshape, coarse.mshape)
    n_leaf = [math.prod(sh) for sh in shapes]
    B = 4 * k * k
    probe = [torch.zeros((B,) + sh, dtype=torch.float64, device=dev)
             for sh in shapes]
    p = 0
    for leaf, sh in enumerate(shapes):
        iy = torch.arange(sh[0], device=dev)[:, None]
        ix = torch.arange(sh[1], device=dev)[None, :]
        index = (sum(n_leaf[:leaf]) + iy * sh[1] + ix + 1).double()
        for a in range(k):
            for b in range(k):
                sel = ((iy % k == a) & (ix % k == b)).double()
                probe[leaf][p], probe[leaf][p + 1] = sel, sel * index
                p += 2
    vf, mf = prolong(tuple(probe), coarse, fine)
    flat = torch.cat([vf.reshape(B, -1), mf.reshape(B, -1)], 1)
    unit, weighted = flat[0::2], flat[1::2]
    pi, fi = torch.nonzero(unit, as_tuple=True)
    val = unit[pi, fi]
    cj = torch.round(weighted[pi, fi] / val).long() - 1
    P = torch.sparse_coo_tensor(torch.stack([fi, cj]), val.float(),
                                (flat.shape[1], sum(n_leaf)),
                                check_invariants=False).coalesce()
    return P.to_sparse_csr(), P.t().coalesce().to_sparse_csr()


def library_transfer_ms(label, coarse, fine, prolong, restrict, dev, F, rng):
    """The library calls of one prolongation and one restriction,
    ``torch.sparse.mm`` of ``transfer_matrices``' P and R on F columns,
    checked against the plain versions (max abs difference printed, rel 1e-6
    of max|ref|): the calls (key "prolong" / "restrict"), to be timed per
    call beside the kernels (``interleaved_ms``), and their device ms (queued
    behind a sleep kernel, key "prolong_device" / "restrict_device")."""
    P, R = transfer_matrices(coarse, fine, prolong, dev)

    def pair(g):
        return tuple(torch.tensor(rng.standard_normal((F,) + sh),
                                  dtype=torch.float32, device=dev)
                     for sh in (g.vshape, g.mshape))

    def cols(w):  # [nodes, F]: the library's layout
        return torch.cat([t.reshape(F, -1) for t in w], 1).t().contiguous()

    xc, rf = pair(coarse), pair(fine)
    Xc, Rf = cols(xc), cols(rf)
    out = {}
    for name, M, X, ref in (("prolong", P, Xc, prolong(xc, coarse, fine)),
                            ("restrict", R, Rf, restrict(rf, coarse, fine))):
        got = torch.sparse.mm(M, X)
        want = cols(ref)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        out[name] = lambda M=M, X=X: torch.sparse.mm(M, X)
        out[name + "_device"] = device_ms(out[name])
        print(f"{label}: library {name} (torch.sparse.mm, {M._nnz()} nonzeros, "
              f"{F} columns): {out[name + '_device'] * 1e3:.2f} us on the "
              f"device; max abs diff to the plain version {err:.3e} (max|ref| "
              f"{scale:.3e})", flush=True)
        if err > 1e-6 * max(scale, 1.0):
            raise AssertionError(f"{label}: the library {name} disagrees")
    return out


def host_us(fn, n: int = 1000) -> float:
    """Host microseconds per call of ``fn`` over ``n`` calls (what it
    launches is queued, not waited for; the card is synchronized after)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / n / 1e3


def old_transfer_parts(plan, src):
    """The launch path of a transfer before the plans (``ops/transfer.py``'s
    ``_check``, two ``new_empty``, ``_launch`` / ``_launch_general`` of the
    parent), copied here only to time it, around the new kernels: (check,
    allocate, library and stream, call) for one call of ``plan``'s op
    without ``out``. H's call also makes the parent's ``param_floats``
    query and ``params.ctypes`` object, which the new launcher no longer
    takes."""
    from pfhubbenchmarks_tpu_torch.ops import _lib
    from pfhubbenchmarks_tpu_torch.ops import transfer as kt

    coarse, fine, op, mask = plan.coarse, plan.fine, plan.op, plan.mask
    src_g, dst_g = (coarse, fine) if op == "prolong" else (fine, coarse)
    code = {"prolong": 0, "restrict": 1, "inject": 2}[op]

    def check():
        if plan.R == 2:
            kt._check_dyadic(coarse, fine)
        else:
            kt._general_ratio(coarse, fine)
        for g in (coarse, fine):
            if g.periodic or g.pad_to != (1, 1):
                raise NotImplementedError(op)
        _lib.check_cuda(op, [t for p in [src] for t in p]
                        + ([mask] if mask is not None else []))
        F = src[0].shape[0]
        _lib.check_shapes(op, src, (F,) + src_g.vshape, (F,) + src_g.mshape)
        if mask is not None and tuple(mask.shape) != (F,) + dst_g.vshape:
            raise ValueError(op)

    def alloc():
        F = src[0].shape[0]
        return (src[0].new_empty((F,) + dst_g.vshape),
                src[0].new_empty((F,) + dst_g.mshape))

    def stream():
        _lib.library()
        return torch.cuda.current_stream().cuda_stream

    dst = alloc()
    s = stream()

    def call():
        lib = _lib.library()
        mp = None if mask is None else mask.data_ptr()
        if plan.R == 2:
            lib.call("pfh_transfer", code, src[0].data_ptr(), src[1].data_ptr(),
                     dst[0].data_ptr(), dst[1].data_ptr(), mp, src[0].shape[0],
                     coarse.ny, coarse.nx, 0, s)
            _lib.count_launch("transfer_dyadic")
            return
        params = kt._general_params(plan.R)
        if params.size != lib.lib.pfh_transfer_general_param_floats():
            raise RuntimeError("GenWeights")
        params.ctypes.data  # noqa: B018 (the parent passed this address)
        lib.call("pfh_transfer_general", code, plan.R, src[0].data_ptr(),
                 src[1].data_ptr(), dst[0].data_ptr(), dst[1].data_ptr(), mp,
                 src[0].shape[0], coarse.ny, coarse.nx, 0, s)
        _lib.count_launch("transfer_general")

    return check, alloc, stream, call


def host_breakdown(label, plan, src):
    """Host us per call of each part of one call of ``plan`` (no ``out``):
    its check, the allocation, the stream handle and the ctypes call with
    its launch, and the whole call; the same for the old path
    (``old_transfer_parts``); over 1,000 calls each."""
    from pfhubbenchmarks_tpu_torch.ops import _lib

    v = src[0]
    dst = plan.kernel(src)   # binds the plan's launcher
    fn = plan._fn
    s = _lib.stream_handle()

    def call():
        fn(*plan._head, src[0].data_ptr(), src[1].data_ptr(), dst[0].data_ptr(),
           dst[1].data_ptr(), plan._mask_ptr, *plan._ints, 0, s)
        _lib.count_launch(plan.kernel_name)

    new = {"check": host_us(lambda: plan.check(src)),
           "allocate": host_us(lambda: (v.new_empty(plan.dst_shapes[0]),
                                        v.new_empty(plan.dst_shapes[1]))),
           "stream": host_us(_lib.stream_handle),
           "call": host_us(call),
           "whole": host_us(lambda: plan.kernel(src))}
    check, alloc, stream, ocall = old_transfer_parts(plan, src)

    def old_whole():
        check()
        alloc()
        stream()
        ocall()

    old = {"check": host_us(check), "allocate": host_us(alloc),
           "stream": host_us(stream), "call": host_us(ocall),
           "whole": host_us(old_whole)}
    for name, parts in (("plan", new), ("old path", old)):
        print(f"{label}: host us per call, {name}: "
              + ", ".join(f"{k} {t:.2f}" for k, t in parts.items())
              + f" (parts sum {sum(parts[k] for k in parts if k != 'whole'):.2f})",
              flush=True)
    return new, old


def check_stream_handle(label):
    """``_lib.stream_handle()`` must be PyTorch's current stream, on the
    default stream and inside ``torch.cuda.stream``; prints both getters'
    host us per call."""
    from pfhubbenchmarks_tpu_torch.ops import _lib

    side = torch.cuda.Stream()
    for ctx in (None, side):
        if ctx is None:
            got, want = _lib.stream_handle(), torch.cuda.current_stream().cuda_stream
        else:
            with torch.cuda.stream(ctx):
                got = _lib.stream_handle()
                want = torch.cuda.current_stream().cuda_stream
            if want != side.cuda_stream:
                raise AssertionError("torch.cuda.stream did not switch streams")
        if got != want:
            raise AssertionError(f"stream_handle {got:#x} is not the current "
                                 f"stream {want:#x}")
    torch.cuda.synchronize()
    print(f"{label}: stream handle: _lib.stream_handle() "
          f"{host_us(_lib.stream_handle):.3f} us per call, "
          f"torch.cuda.current_stream().cuda_stream "
          f"{host_us(lambda: torch.cuda.current_stream().cuda_stream):.3f} us; "
          f"equal on the default stream and on a side stream", flush=True)


def transfer_pair_checks(K, phase, label, coarse, fine, F, masks, noise_pair,
                         rng, dev, breakdown=False):
    """Kernel D or H at one level pair through ``TransferPlan``, the object
    the main path calls: prolong, prolong+=, restrict and (dyadic) inject
    against the plain versions to the bit (TOL_EXACT), unmasked and masked
    (``masks`` = the pair's (fine, coarse) Dirichlet masks, or seeded 0/1
    masks where the problem has none), each also against itself on a rerun;
    on the main path's variant (masked where the problem has masks) the
    per-call and device times of each op beside the plain version's and the
    library's (``torch.sparse.mm``, per call and device). ``breakdown``:
    also the host path of one restriction, new and old."""
    from pfhubbenchmarks_tpu_torch.ops import transfer as kt

    dyadic = fine.nx == 2 * coarse.nx
    kk = K["transfer_dyadic" if dyadic else "transfer_general"]
    tag = f"{phase}: {'D' if dyadic else 'H'} {label} {fine.nx}<->{coarse.nx}"
    main_masked = masks[0] is not None or masks[1] is not None

    def seeded_mask(g):
        return torch.tensor((rng.random((F,) + g.vshape) < 0.2).astype(np.float32),
                            device=dev)

    if not main_masked:
        masks = (seeded_mask(fine), seeded_mask(coarse))
    lib_ms = library_transfer_ms(tag, coarse, fine, kt.transfer_ops(
        coarse, fine, "plain")[1], kt.transfer_ops(coarse, fine, "plain")[0],
        dev, F, rng)
    summary = {}
    for masked in (False, True):
        mf, mc = masks if masked else (None, None)
        lab = f"{label} {fine.nx}<->{coarse.nx}{' masked' if masked else ''}"
        P = kt.TransferPlan(coarse, fine, F, "prolong", mf)
        Rt = kt.TransferPlan(coarse, fine, F, "restrict", mc)
        ops = [("prolong", P, None), ("prolong+=", P, "out"),
               ("restrict", Rt, None)]
        if dyadic and not masked:
            ops.append(("inject", kt.TransferPlan(coarse, fine, F, "inject"),
                        None))
        main = masked == main_masked
        for name, plan, out in ops:
            src = noise_pair(coarse if plan.op == "prolong" else fine, F)
            base = noise_pair(fine, F) if out else None

            def run(version, plan=plan, src=src, base=base):
                o = None if base is None else tuple(t.clone() for t in base)
                return getattr(plan, version)(src, o)

            got, again = run("kernel"), run("kernel")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{tag} {name}: a rerun changed bits")
            timing = work = lib = dev_ms = None
            if main:
                o = None if base is None else tuple(t.clone() for t in base)
                calls = {"plan": lambda: plan(src, o)}
                if name in lib_ms:
                    calls["library"] = lib_ms[name]
                per_call = interleaved_ms(calls)
                timing = (per_call["plan"],
                          cuda_ms(lambda: plan.plain(src, o), reps=10))
                dev_ms = device_ms(lambda: plan(src, o))
                if plan.op != "inject":
                    work = transfer_work(coarse, fine, F, plan.op, masked,
                                         accumulate=bool(out))
                else:   # reads and writes the coarse nodes' values
                    work = (8 * F * nodes(coarse), 0)
                lib = per_call.get("library")
                summary[name] = (timing[0], dev_ms, lib,
                                 lib_ms.get(name + "_device"))
            kk.check(f"{name} {lab} (rerun equal)", got, run("plain"),
                     TOL_EXACT, timing, work, library_ms=lib, dev_ms=dev_ms)
    print(f"{tag}: us per call through the plan / on the device (library per "
          f"call / device; per call timed in turns with the library): " + "; ".join(
              f"{n} {t * 1e3:.1f} / {d * 1e3:.2f}"
              + (f" ({lt * 1e3:.1f} / {ld * 1e3:.2f})" if lt is not None else "")
              for n, (t, d, lt, ld) in summary.items()), flush=True)
    print(f"{tag}: below the library per call / on the device: " + "; ".join(
        f"{n} {t < lt} / {d < ld}" for n, (t, d, lt, ld) in summary.items()
        if lt is not None), flush=True)
    if breakdown:
        plan = kt.TransferPlan(coarse, fine, F, "restrict",
                               masks[1] if main_masked else None)
        host_breakdown(f"{tag} restrict", plan, noise_pair(fine, F))
    return summary


def sweep_work(g, F, n, jv_kw=None, groups=None):
    """n sweeps: state, block planes and (x, r) in once, (x, r) out once;
    the flops of n block-Jacobi applies, J.v and LMR steps."""
    jv_kw = jv_kw or {}
    N, ns = nodes(g), jv_kw.get("ns", 1)
    byts = 4 * (ns * N + bj_work(g, F, groups)[0] // 4 - 2 * F * N + 4 * F * N)
    flops = n * (jvp_work(g, F, **jv_kw)[1] + bj_work(g, F, groups)[1]
                 + lmr_work(g, F)[1])
    return byts, flops


def chain_work(grids, F, nu, nu_fine, ascend: bool, jv_kw=None, groups=None,
               masked=True):
    """Inputs once (rhs, per-level state planes, block planes, masks, and for
    the ascent the iterates and coarse correction), outputs once; the flops
    of its sweeps, residuals and transfers. With two grids: one level step."""
    jv_kw = jv_kw or {}
    K = len(grids) - 1
    byts = flops = 0
    for l in range(K):
        g, N = grids[l], nodes(grids[l])
        n = nu_fine if l == 0 else nu
        byts += 4 * (jv_kw.get("ns", 1) * N + bj_work(g, F, groups)[0] // 4
                     - 2 * F * N + (F * (g.ny + 1) * (g.nx + 1) if masked else 0))
        byts += 4 * F * N * (2 if ascend else 1)   # rhs (+ iterate) in
        flops += sweep_work(g, F, n, jv_kw, groups)[1]
        op = "prolong" if ascend else "restrict"
        flops += transfer_work(grids[l + 1], g, F, op)[1]
        if ascend:
            flops += jvp_work(g, F, **jv_kw)[1]
        elif l + 1 < K:
            byts += 4 * F * nodes(grids[l + 1])   # restricted rhs out
    if ascend:
        byts += 4 * F * (nodes(grids[K]) + nodes(grids[0]))   # xc in, z out
    else:
        byts += 4 * F * (sum(nodes(g) for g in grids[:K]) + nodes(grids[K]))
    return byts, flops


# Kernel I's work for BM1 in 3D (ch3d_jvp.cu, F = 2), counted as what the
# function needs at a rule exact for degree 2 (keast2, ffc3), as in
# TANGENT_OPS. A Kuhn tet's vertices 0 -> 1 -> 2 -> 3 step along one axis
# each, so a P1 gradient is one difference per axis and a test gradient is
# at most one difference of two flux components (1/h and the volume fold
# into the constants). Per tet, once: the gradients of dc and dmu (3 per
# field), the fluxes M grad(dmu) and -kappa grad(dc) (3 per field), their
# contraction with the 4 test gradients (2 per field), the element mass
# action on dc/dt and dmu, V/20 (v_i + sum_j v_j) (11 per field: the mass
# matrix is exact at these rules and the same in every tet), the mass and
# flux parts of each vertex summed (4 per field) and the tet's 4 values
# added into the nodes' sums (4 per field). Per point, only f''(c) dc: c
# and dc interpolated (4 mul + 3 add each), f''(c) by Horner (4), the
# product (1) and its weighted contraction into the 4 vertices (8).
CH3D_TET_OPS = 2 * (3 + 3 + 2 + 11 + 4 + 4)
CH3D_POINT_OPS = 7 + 7 + 4 + 1 + 8
# BM6's tangent in 3D (phys_chp3d.cuh), counted as CH3D's: per tet the same
# 27 operations for each of its three fields (phi's gradient, its flux
# -grad(dphi), the contraction, the mass action on k dc / epsilon, the sums;
# the coupling -k dphi folds into mu's mass action), per point the same
# f''(c) dc (the only term that varies within a tet).
CHP3D_TET_OPS = 3 * (3 + 3 + 2 + 11 + 4 + 4)
CHP3D_POINT_OPS = CH3D_POINT_OPS
CH3D_OPS = (CH3D_TET_OPS, CH3D_POINT_OPS)
CHP3D_OPS = (CHP3D_TET_OPS, CHP3D_POINT_OPS)


def jvp3d_work(g, F=2, ns=1, with_b=False, ops=CH3D_OPS, masked=False):
    """(bytes, flops) of one 3D J.v: ``ns`` state planes + F tangent planes
    (+ b, + the F mask planes when ``masked``) in, F planes out, over the
    (nz+1)(ny+1)(nx+1) vertices; each of the 6 tets of a cell counted once
    (``ops``: the operations per tet and per point, BM1's CH3D_OPS or BM6's
    CHP3D_OPS; kernel I evaluates each tet once per vertex, 4 times, kernel
    U once per box that holds its cell, 1.5 times on average), and for
    b - J v one subtraction per node and field."""
    N, nq = g.n_vertices, g.tab().nq
    assert nq >= 4, "the count takes the mass matrix as exact (degree 2)"
    tet_ops, point_ops = ops
    byts = 4 * N * (ns + 2 * F + (F if with_b else 0) + (F if masked else 0))
    flops = (g.nz * g.ny * g.nx * 6 * (tet_ops + nq * point_ops)
             + (F * N if with_b else 0))
    return byts, flops


def bj3d_work(g, F=2):
    N = g.n_vertices   # F^2 planes and r in, z out
    return 4 * N * (F * F + 2 * F), 2 * F * F * N


def lmr3d_work(g, F=2):
    N = g.n_vertices   # x, r, z, Az in; x, r out; two dots and two axpys
    return 4 * 6 * F * N, 8 * F * N


def sweep3d_work(g, n, F=2, ops=CH3D_OPS, masked=False):
    """n sweeps: the state plane, the block planes, (x, r) (and the mask
    planes) in once, (x, r) out once; the flops of n block-Jacobi applies,
    J.v and LMR steps."""
    N = g.n_vertices
    byts = 4 * N * (1 + F * F + 4 * F + (F if masked else 0))
    flops = n * (jvp3d_work(g, F, ops=ops)[1] + bj3d_work(g, F)[1]
                 + lmr3d_work(g, F)[1])
    return byts, flops


def bound(work):
    byts, flops = work
    t_b, t_f = byts / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def node_blocks_work(g, F, ns, tangent_ops, masked=False):
    """(bytes, flops) of kernel N at level ``g``: the ``ns`` state planes
    the tangent reads and the 3 diagonals (+ the F mask planes on the
    vertices) in, the F^2 block planes out. Per node one tangent's state
    coefficients (``tangent_ops``, as TANGENT_OPS counts them: the one-hot
    directions fold the rest), the F^2 entries of P (3 mul + 2 add each) and
    the Gauss-Jordan on [P | I]: per pivot 2F divisions and (F - 1) rows of
    2F mul + sub."""
    N = nodes(g)
    byts = 4 * ((ns + 3 + F * F) * N
                + (F * (g.ny + 1) * (g.nx + 1) if masked else 0))
    flops = N * (tangent_ops + 5 * F * F + F * (2 * F + 4 * F * (F - 1)))
    return byts, flops


def node_plan(problem, g, dev, split=False):
    """Kernel N's plan at level ``g`` of ``problem``, as solve/gmg.py
    builds it (from the level's gather J.v; the split operator's for
    ``split``)."""
    from pfhubbenchmarks_tpu_torch.ops.node_blocks import NodeBlockPlan

    bcs = problem.dirichlet_for(g)
    return NodeBlockPlan(g, problem.kernel_jvp(g, dev, bcs, split=split),
                         problem.terms_precond if split else problem.terms,
                         device=dev, dirichlet=bcs)


def node_blocks_phase(phase, label, K, problem, grids, dt, dev, state_on,
                      split=False, ns=1, ops=None, main=False, library_at=1):
    """Kernel N at every level of ``grids`` (the main path's plans):
    against its plain version (the hand-written tangent with one-hot
    directions, TOL_F32), its rerun (to the bit) and the library build
    (``torch.func.jvp``, TOL_F32; and whether to the bit, the target for
    BM1, whose source column N takes in torch's forward-mode order); device
    us (launches queued behind a sleep kernel), per-call us of kernel / plain / library (the library
    timed at the first ``library_at`` levels, it takes up to seconds), the
    bound, registers, spills and CTAs per SM. ``main``: the finest level is
    N's main shape in the kernel line."""
    F = problem.n_fields
    ops = TANGENT_OPS[F] if ops is None else ops
    for l, g in enumerate(grids):
        plan = node_plan(problem, g, dev, split)
        w = state_on(problem, g)
        got = plan.kernel(w, w, dt)
        again = plan.kernel(w, w, dt)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        k_ms = cuda_ms(lambda: plan.kernel(w, w, dt))
        p_ms = cuda_ms(lambda: plan.plain(w, w, dt), reps=10)
        lib_ms = (cuda_ms(lambda: plan.library(w, w, dt), reps=3, warmup=1)
                  if l < library_at else None)
        dev_ms = device_ms(lambda: plan.kernel(w, w, dt))
        lab = f"{label} {g.ny}x{g.nx}"
        K["node_blocks"].check(
            lab, got, plan.plain(w, w, dt), TOL_F32, (k_ms, p_ms),
            node_blocks_work(g, F, ns, ops, plan.mask is not None),
            library_ms=lib_ms, dev_ms=dev_ms, main=main and l == 0)
        lib = plan.library(w, w, dt)
        K["node_blocks"].check(f"{lab} vs the torch.func.jvp build", got, lib,
                               TOL_F32)
        lib_bits = all(torch.equal(a, b) for a, b in zip(got, lib))
        info = plan.info()
        print(f"phase {phase}: kernel N {lab}: rerun "
              f"{'bit-identical' if same else 'DIFFERS'}, the torch.func.jvp "
              f"build {'bit-identical' if lib_bits else 'within TOL_F32'}, "
              f"device "
              f"{dev_ms * 1e3:.2f} us, per call {k_ms * 1e3:.1f} us (plain "
              f"{p_ms * 1e3:.1f}, library "
              f"{'not timed' if lib_ms is None else f'{lib_ms * 1e3:.1f}'}),"
              f" {info['registers']} registers, {info['local_bytes']} local "
              f"bytes, {info['ctas_per_sm']} CTAs per SM", flush=True)
        if not same:
            raise AssertionError(f"kernel N {lab}: a rerun gives other bits")


def node_build_work(grids, F, ns, tangent_ops, masked=False):
    """(bytes, flops) of N's one-launch build over ``grids``: kernel N's
    work at each level (``node_blocks_work``, the finest level's mask only
    where ``masked``: the coarse levels' Dirichlet rows are masks too) and
    the coarse levels' injected states: 2F planes of w and w0 read and
    written. A coarse level's ``ns`` state planes are among the 2F it
    reads, so they are not counted again; the composed index is not
    counted, since a dyadic or odd ratio gives it by arithmetic."""
    byts = flops = 0
    for l, g in enumerate(grids):
        b, f = node_blocks_work(g, F, ns, tangent_ops, masked)
        byts += b + (4 * (4 * F - ns) * nodes(g) if l else 0)
        flops += f
    return byts, flops


def flat_build(out):
    """The tensors of a build's ``(states, planes)``: the coarse levels'
    injected states, then every level's planes."""
    states, planes = out
    return ([t for pair in states[1:] for half in pair for t in half]
            + [t for p in planes for t in p])


def node_build_phase(phase, label, K, problem, dt, dev, state_on, ns=1,
                     ops=None, main=False):
    """N's one-launch build (``node_build``) of ``problem``'s hierarchy,
    the plan its main path builds (``precond_builder(...).node_build``), on
    the IC plus noise (w) and other noise (w0): against the per-level
    launches of N and the injections it replaces (``.sequence``) with
    ``torch.equal`` on every level's planes and every coarse level's
    injected states, and against itself on a rerun (both required); against
    its plain version (TOL_F32); device us of both forms (launches queued
    behind a sleep kernel, two rounds in turns) and per-call us in turns,
    the wrapper calls of one build in each form, the bound
    (``node_build_work``), registers, spills and CTAs per SM. ``main``: N's
    one-launch main shape in the kernel line (bench2's split build)."""
    from pfhubbenchmarks_tpu_torch.ops import _lib

    nb = problem.precond_builder(dev).node_build
    grids, F = nb.grids, problem.n_fields
    ops = TANGENT_OPS[F] if ops is None else ops
    w, w0 = state_on(problem, grids[0]), state_on(problem, grids[0])
    got = nb.kernel(w, w0, dt)
    again = nb.kernel(w, w0, dt)
    torch.cuda.synchronize()
    before = sum(_lib.LAUNCHES.values())
    ref = nb.sequence(w, w0, dt)
    torch.cuda.synchronize()
    seq_calls = sum(_lib.LAUNCHES.values()) - before + sum(
        inj.R != 2 for inj in nb.injs)   # an odd-ratio injection: slicing
    bits = all(torch.equal(x, y) for x, y in zip(flat_build(got),
                                                  flat_build(ref)))
    rerun = all(torch.equal(x, y) for x, y in zip(flat_build(got),
                                                   flat_build(again)))
    fns = {"build": lambda: nb.kernel(w, w0, dt),
           "sequence": lambda: nb.sequence(w, w0, dt)}
    per = interleaved_ms(fns)
    rounds = [{k: device_ms(fn) for k, fn in fns.items()} for _ in range(2)]
    dev_us = {k: statistics.mean(r[k] for r in rounds) * 1e3 for k in fns}
    plain_ms = cuda_ms(lambda: nb.plain(w, w0, dt), reps=5)
    work = node_build_work(grids, F, ns, ops, nb.mask is not None)
    lab = f"{label} {'/'.join(str(g.nx) for g in grids)}"
    K["node_build"].check(lab, flat_build(got), flat_build(nb.plain(w, w0, dt)),
                          TOL_F32, (per["build"], plain_ms), work,
                          dev_ms=dev_us["build"] * 1e-3, main=main)
    info = nb.info()
    print(f"phase {phase}: N's one-launch build {lab}: vs the per-level N "
          f"and injections {'bit-identical' if bits else 'DIFFERS'} (every "
          f"level's planes and states), rerun "
          f"{'bit-identical' if rerun else 'DIFFERS'}; device us one launch "
          f"{dev_us['build']:.2f}, per-level sequence {dev_us['sequence']:.2f}"
          f" (rounds {[{k: round(x * 1e3, 2) for k, x in r.items()} for r in rounds]}); "
          f"per call {per['build'] * 1e3:.1f} us vs {per['sequence'] * 1e3:.1f}"
          f" us (plain {plain_ms * 1e3:.1f} us); wrapper calls per build 1 vs "
          f"{seq_calls}; bound {bound(work)[0] * 1e3:.3f} us "
          f"({bound(work)[1]}); {info['registers']} registers, "
          f"{info['local_bytes']} local bytes, {info['ctas_per_sm']} CTAs per "
          f"SM", flush=True)
    if not (bits and rerun):
        raise AssertionError(f"{label}: N's one-launch build differs from the "
                             "per-level launches or from itself on a rerun")


def chp_box_phase(dev, K, rng):
    """Phase 5's kernel W at BM6's physics (``tri_box_chp``: the triangle
    box with the Dirichlet rows of phi in its store), bench6's outer J.v, at
    ffc3 at 100^2 and 37 x 23, with and without the Dirichlet mask, J.v and
    b - J.v: against kernel E (``jv.gather``) with ``torch.equal`` and
    against itself on a rerun (both required), against its plain version
    and ``torch.func.jvp`` of the f64 residual (TOL_F32); device us of W and
    E (two rounds in turns), per-call us in turns with the plain version's
    and the library's (``torch.func.jvp`` of the f32 residual), the bound
    (``jvp_work`` with the mask), boxes, registers, spills, shared bytes and
    CTAs per SM. The masked 100^2 J.v is its main shape."""
    from pfhubbenchmarks_tpu_torch.benchmarks import bench6
    from pfhubbenchmarks_tpu_torch.fem.assembly import make_residual

    f32, f64, dt = torch.float32, torch.float64, 0.32
    KW = K["tri_box_chp"]

    def pair(g, F, scale=1.0):
        return tuple(torch.tensor(scale * rng.standard_normal((F,) + s),
                                  dtype=f32, device=dev)
                     for s in (g.vshape, g.mshape))

    for size in (100, (37, 23)):
        ny, nx = (size, size) if isinstance(size, int) else size
        pb = bench6.make(nx=nx, ny=ny)
        g, F = pb.grid, pb.n_fields
        assert g.rule_name == "ffc3" and pb.outer_jvp_form == "box"
        v0, m0 = g.interpolate(pb.ic_fns)
        w = tuple(torch.tensor(a, dtype=f32, device=dev) + n
                  for a, n in zip((v0, m0), pair(g, F, 0.01)))
        for bc in pb.dirichlet:
            w = (bc.apply_value(w[0]).contiguous(), w[1])
        v, b = pair(g, F), pair(g, F)
        for bcs in (pb.dirichlet, ()):
            jv = pb.kernel_jvp(g, dev, bcs, form="box")
            gather = jv.gather
            lab = (f"bench6 ffc3 {g.ny}x{g.nx} "
                   f"{'masked' if bcs else 'unmasked'}")
            main = size == 100 and bool(bcs)
            got = jv.kernel(w, w, dt, v)
            got_b = jv.kernel(w, w, dt, v, b=b)
            again = jv.kernel(w, w, dt, v) + jv.kernel(w, w, dt, v, b=b)
            ref_g = gather.kernel(w, w, dt, v) + gather.kernel(w, w, dt, v, b=b)
            res64 = make_residual(g, pb.terms, F, device=dev, dirichlet=bcs,
                                  dtype=f64)
            w64, v64 = (tuple(t.double() for t in p) for p in (w, v))
            lib64 = torch.func.jvp(lambda u: res64(u, w64, dt), (w64,),
                                   (v64,))[1]
            res32 = make_residual(g, pb.terms, F, device=dev, dirichlet=bcs,
                                  dtype=f32)

            def library(res32=res32):
                return torch.func.jvp(lambda u: res32(u, w, dt), (w,), (v,))[1]

            fns = {"W": lambda: jv.kernel(w, w, dt, v),
                   "E": lambda: gather.kernel(w, w, dt, v)}
            per = interleaved_ms(fns)
            rounds = [{k: device_ms(fn) for k, fn in fns.items()}
                      for _ in range(2)]
            dev_us = {k: statistics.mean(r[k] for r in rounds) * 1e3
                      for k in fns}
            timing = (per["W"], cuda_ms(lambda: jv.plain(w, w, dt, v), reps=10))
            library_ms = cuda_ms(library, reps=10)
            work = jvp_work(g, F, masked=bool(bcs))
            KW.check(f"{lab} Jv", got, jv.plain(w, w, dt, v), TOL_F32, timing,
                     work, library_ms=library_ms, dev_ms=dev_us["W"] * 1e-3,
                     main=main)
            KW.check(f"{lab} b-Jv", got_b, jv.plain(w, w, dt, v, b=b), TOL_F32)
            KW.check(f"{lab} Jv vs torch.func.jvp of the f64 residual", got,
                     tuple(t.float() for t in lib64), TOL_F32)
            rerun = all(torch.equal(x, y) for x, y in zip(got + got_b, again))
            diff = max(float((x - y).abs().max())
                       for x, y in zip(got + got_b, ref_g))
            bits = all(torch.equal(x, y) for x, y in zip(got + got_b, ref_g))
            info = jv.plan.info()
            print(f"phase 5: kernel W at BM6 {lab}: vs E (J.v and b - J.v) "
                  f"{'bit-identical' if bits else f'DIFFERS by {diff:.3e}'}, "
                  f"rerun {'bit-identical' if rerun else 'DIFFERS'}; device "
                  f"us W {dev_us['W']:.2f}, E {dev_us['E']:.2f} (rounds "
                  f"{[{k: round(x * 1e3, 2) for k, x in r.items()} for r in rounds]}"
                  f"); per call W {per['W'] * 1e3:.1f} us, E "
                  f"{per['E'] * 1e3:.1f} us, plain {timing[1] * 1e3:.1f} us, "
                  f"library {library_ms * 1e3:.1f} us; bound "
                  f"{bound(work)[0] * 1e3:.3f} us ({bound(work)[1]}); boxes "
                  f"{jv.plan.boxes} of {jv.plan.box}; {info['registers']} "
                  f"registers, {info['local_bytes']} local bytes, "
                  f"{info['dynamic_smem']} shared bytes, {info['ctas_per_sm']}"
                  f" CTAs per SM", flush=True)
            if not (bits and rerun):
                raise AssertionError(f"W at BM6 {lab}: differs from E by "
                                     f"{diff:.3e} or from itself on a rerun")
            if main:
                K["chp_jvp"].device_ms = dev_us["E"] * 1e-3


class Kernel:
    """Per-kernel aggregate of the comparisons against the plain twins."""

    def __init__(self, name, source, replaces, also_replaces=(),
                 comparison_of=None, note=None):
        self.name, self.source, self.replaces = name, source, replaces
        self.also_replaces = also_replaces
        self.comparison_of = comparison_of
        self.note = note
        self.max_abs_err = 0.0
        self.ms = self.plain_ms = self.bound_ms = self.bound_by = None
        self.library_ms = self.device_ms = None

    def check(self, label, got, ref, tol, timing=None, work=None,
              library_ms=None, dev_ms=None, main=False):
        torch.cuda.synchronize()
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        scale = max(float(r.abs().max()) for r in ref)
        ok = all(torch.allclose(g, r, rtol=tol["rtol"],
                                atol=tol["atol_scale"] * max(scale, 1.0))
                 for g, r in zip(got, ref))
        self.max_abs_err = max(self.max_abs_err, err)
        line = (f"check {self.name} {label}: max_abs_err={err:.3e} "
                f"max|ref|={scale:.3e} rel_err={err / max(scale, 1e-30):.3e} "
                f"rtol={tol['rtol']:g} "
                f"atol={tol['atol_scale']:g}*max(1,max|ref|)")
        if timing is not None:
            k_ms, p_ms = timing
            b_ms, b_by = bound(work)
            line += (f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                     f"bound_ms={b_ms:.6f} ({b_by})")
            if library_ms is not None:
                line += f" library_ms={library_ms:.4f}"
            if dev_ms is not None:
                line += f" device_ms={dev_ms:.5f}"
            # the first timed case is the main shape, unless one says so
            if self.ms is None or main:
                self.ms, self.plain_ms = k_ms, p_ms
                self.bound_ms, self.bound_by = b_ms, b_by
                self.library_ms, self.device_ms = library_ms, dev_ms
        print(line + (" ok" if ok else " FAIL"), flush=True)
        if not ok:
            raise AssertionError(f"{self.name} {label} disagrees with its "
                                 f"plain version (max_abs_err {err:.3e})")

    def record(self, paths: dict):
        launches = sum(p.get(self.name, 0) for p in paths.values())
        rec = dict(name=self.name, route="cuda", source=self.source,
                   replaces=self.replaces, launches=launches,
                   max_abs_err=self.max_abs_err, ms=self.ms,
                   plain_ms=self.plain_ms, bound_ms=self.bound_ms,
                   bound_by=self.bound_by, library_ms=self.library_ms,
                   paths={k: p.get(self.name, 0) for k, p in paths.items()})
        if self.device_ms is not None:
            rec["device_ms"] = self.device_ms
        if self.also_replaces:
            rec["also_replaces"] = list(self.also_replaces)
        if self.comparison_of:
            rec["comparison_of"] = self.comparison_of
        if self.note:
            rec["note"] = self.note
        return rec


class Chain(Kernel):
    """A launch sequence of the kernels that stands for one TPU kernel."""

    def __init__(self, name, replaces, sequence_of,
                 source="pfhubbenchmarks_tpu_torch/ops/vcycle_chain.py",
                 also_replaces=()):
        super().__init__(name, source, replaces, also_replaces)
        self.sequence_of = sequence_of

    def record(self, paths: dict):
        rec = super().record(paths)
        del rec["route"]
        rec["calls"] = rec.pop("launches")
        rec["sequence_of"] = list(self.sequence_of)
        return rec


def preconditioner_calls(label, problem, dt):
    """Print the wrapper calls of one preconditioner apply (a V-cycle, or
    bench1_3d's K-cycle) of ``problem``'s configuration, built at its
    initial state and ``dt``: the kernel launches and chain calls, counted
    from 0 around the apply."""
    from pfhubbenchmarks_tpu_torch.ops import _lib

    dev = torch.device("cuda", 0)
    w = problem.initial_state(dev)
    Minv = problem.precond_builder(dev)(w, w, dt)
    r = tuple(torch.ones_like(t, dtype=torch.float32) for t in w)
    torch.cuda.synchronize()
    _lib.reset_launches()
    Minv(r)
    torch.cuda.synchronize()
    launches = {k: n for k, n in _lib.LAUNCHES.items() if n}
    calls = {k: n for k, n in _lib.CALLS.items() if n}
    n_l, n_c = sum(launches.values()), sum(calls.values())
    print(f"{label}: one preconditioner apply: {n_l + n_c} wrapper calls "
          f"({n_l} kernel launches {launches}, {n_c} chain calls {calls}; "
          "17 for bench1, bench6, bench2 and 23 for bench3 before the chain "
          "kernels)", flush=True)
    if hasattr(Minv, "minv_matvec"):
        _lib.reset_launches()
        Minv.minv_matvec(r)
        torch.cuda.synchronize()
        pair = {k: n for k, n in {**_lib.LAUNCHES, **_lib.CALLS}.items() if n}
        print(f"{label}: one apply with its exported A z (FGMRES's pair): "
              f"{sum(pair.values())} wrapper calls {pair} (4 before kernel "
              "V on bench1's and bench2's paths: the two chains, L and W)",
              flush=True)
    return n_l + n_c


def drive(label, problem, run, required, absent=GATHER_ABSENT,
          max_calls=None):
    """Call ``run()`` (a run of ``problem``'s main path) with the launch and
    chain-call counts and the stage seconds set to 0 just before and read
    just after; print its counts (beside ``COUNTS_BEFORE_N``), its wall
    (beside ``WALLS_BEFORE_N``) and its ms per Krylov iteration, its
    multigrid builds' seconds and share of the wall (the dense coarse
    inverse apart; beside ``BUILDS_BEFORE_N``), refuse
    a ``torch.func.jvp`` block build on the path (``SECONDS['jvp_blocks']``),
    and require each of ``required`` to have run and none
    of ``absent`` (B and C, which a gather level's sweeps do not launch:
    their body runs inside kernel L; the chains' launch sequences, which a
    chain of gather levels does not run: it is one launch of a chain
    kernel). Then print the wrapper calls of one preconditioner apply at
    the run's first dt, at most ``max_calls`` where given. On a 2D path
    every multigrid build must be one launch of N's one-launch form
    (``node_build`` launches equal to the builds, ``_lib.ENTRIES``), and
    where ``COUNTS_BEFORE_BOXES`` records the run's step count its Newton
    and Krylov counts must equal those. Returns the counts, the run's
    result, its wall seconds and the stage seconds."""
    from pfhubbenchmarks_tpu_torch.ops import _lib

    torch.cuda.synchronize()
    _lib.reset_launches()
    t0 = time.perf_counter()
    result = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    calls = dict(_lib.CALLS)
    seconds = dict(_lib.SECONDS)
    n_builds = _lib.ENTRIES["precond_build"]
    rows = result.rows
    st = result.stats
    g = problem.grid
    dims = ((g.nz,) if getattr(g, 'dim', 2) == 3 else ()) + (g.ny, g.nx)
    print(f"{label}: {'x'.join(map(str, dims))} to "
          f"t={rows[-1, 0]:.6g}: steps={len(st)} "
          f"attempts={len(st) + sum(s.retries for s in st)} "
          f"newton={sum(s.newton_iters for s in st)} "
          f"krylov={sum(s.krylov_iters for s in st)} "
          f"newton_all={sum(s.newton_iters_all for s in st)} "
          f"krylov_all={sum(s.krylov_iters_all for s in st)} "
          f"wall_s={wall:.3f} launches={launches} chain_calls={calls} "
          f"stage_s={seconds}", flush=True)
    krylov = (sum(s.krylov_iters for s in st),
              sum(s.krylov_iters_all for s in st))
    newton = (sum(s.newton_iters for s in st),
              sum(s.newton_iters_all for s in st))
    gather = COUNTS_BEFORE_BOXES.get((label, len(st)))
    same = (gather is not None and gather[0] == newton[:1] + krylov[:1]
            and (gather[1] is None or gather[1] == (newton[1], krylov[1])))
    print(f"{label}: newton / krylov, newton_all / krylov_all {newton[0]} / "
          f"{krylov[0]}, {newton[1]} / {krylov[1]} over {len(st)} steps; "
          f"before kernel N: "
          f"{COUNTS_BEFORE_N.get((label, len(st)), 'not recorded')}; before "
          f"kernel V (and before the boxes of A and R): "
          f"{gather if gather else 'not recorded'}"
          f"{(' (equal)' if same else ' (DIFFERS)') if gather else ''}",
          flush=True)
    print(f"{label}: wall {wall:.3f} s (before kernel N, smokes A / "
          f"B: {WALLS_BEFORE_N.get((label, len(st)), 'not recorded')}), "
          f"{wall / max(krylov[1], 1) * 1e3:.3f} ms per Krylov iteration over "
          f"all attempts", flush=True)
    print(f"{label}: krylov per step {[s.krylov_iters for s in st]}, "
          f"newton per step {[s.newton_iters for s in st]}, "
          f"krylov_all per step {[s.krylov_iters_all for s in st]}, "
          f"newton_all per step {[s.newton_iters_all for s in st]}, "
          f"retries per step {[s.retries for s in st]}", flush=True)
    build_s, dense_s = seconds["precond_build"], seconds["dense_coarse"]
    print(f"{label}: multigrid builds {build_s:.3f} s, {n_builds} builds over "
          f"{sum(s.newton_iters_all for s in st)} Newton iterations, share "
          f"{build_s / wall:.4f} of the {wall:.3f} s wall (of it the dense "
          f"coarse inverse {dense_s:.3f} s, share {dense_s / wall:.4f}; the "
          f"block planes and injections {build_s - dense_s:.3f} s, share "
          f"{(build_s - dense_s) / wall:.4f}); before kernel N: "
          f"{BUILDS_BEFORE_N.get((label, len(st)), 'not recorded')}",
          flush=True)
    if not np.isfinite(rows).all():
        raise AssertionError(f"{label}: rows are not finite")
    if seconds["jvp_blocks"] > 0:
        raise AssertionError(f"{label}: the torch.func.jvp block build ran "
                             "on the main path")
    counts = {**launches, **calls}
    if getattr(g, "dim", 2) == 2:
        print(f"{label}: {n_builds} multigrid builds, {launches['node_build']} "
              f"launches of N's one-launch build, {launches['node_blocks']} of "
              f"the per-level N", flush=True)
        if launches["node_build"] != n_builds:
            raise AssertionError(f"{label}: {launches['node_build']} build "
                                 f"launches for {n_builds} multigrid builds")
    if gather is not None and not same:
        raise AssertionError(f"{label}: Newton / Krylov counts differ from "
                             f"{gather}")
    missing = [k for k in required if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{label}: did not run on the main path: {missing}")
    extra = [k for k in absent if counts[k] > 0]
    if extra:
        raise AssertionError(f"{label}: launched on the main path: {extra}")
    n_calls = preconditioner_calls(label, problem, float(st[0].dt))
    if max_calls is not None and n_calls > max_calls:
        raise AssertionError(f"{label}: {n_calls} wrapper calls per "
                             f"preconditioner apply (at most {max_calls})")
    return counts, result, wall, seconds


def hold_rows(label, result, ref_csv, n_rows, tfe_tol=1e-6, col2_tol=1e-9,
              ref_dir="results"):
    """The run's rows against the first ``n_rows`` of ``ref_csv`` in
    ``ref_dir`` (relative to the repo): as many rows, time column rtol 1e-9,
    the first observable within rel ``tfe_tol`` and the second within rel
    ``col2_tol``."""
    from pfhubbenchmarks_tpu_torch.io.csvout import read_csv

    ref_rows, cols = read_csv(os.path.join(HERE, ref_dir, ref_csv))
    ref_rows = ref_rows[:n_rows]
    rows = result.rows
    if list(result.columns) != cols:
        raise AssertionError(f"columns {result.columns} != {cols}")
    if rows.shape != ref_rows.shape:
        raise AssertionError(f"rows {rows.shape} vs reference {ref_rows.shape}")
    print(f"{label}: time column {rows[:, 0].tolist()}", flush=True)
    np.testing.assert_allclose(rows[:, 0], ref_rows[:, 0], rtol=1e-9, atol=0)
    tfe_rel = float(np.max(np.abs(rows[:, 1] - ref_rows[:, 1])
                           / np.abs(ref_rows[:, 1])))
    sol_rel = float(np.max(np.abs(rows[:, 2] - ref_rows[:, 2])
                           / np.abs(ref_rows[:, 2])))
    print(f"{label}: vs {ref_dir}/{ref_csv} rows 1-{n_rows}: time column "
          f"equal, tfe_rel={tfe_rel:.3e} (<={tfe_tol:g}), "
          f"{cols[2]}_rel={sol_rel:.3e} (<={col2_tol:g})", flush=True)
    if tfe_rel > tfe_tol or sol_rel > col2_tol:
        raise AssertionError(f"{label}: rows disagree with {ref_dir}/{ref_csv}")


def run_main_path(label, runner, end_time, ref_csv, n_rows, required,
                  tfe_tol=1e-6, col2_tol=1e-9, **kw):
    """Drive ``runner`` to ``end_time`` (at most ``n_rows`` steps) and hold
    its rows against ``ref_csv`` (``drive``, with ``kw``; ``hold_rows``)."""
    out = drive(label, runner.problem,
                lambda: runner.run(end_time=end_time, max_steps=n_rows,
                                   verbose=True), required, **kw)
    hold_rows(label, out[1], ref_csv, n_rows, tfe_tol, col2_tol)
    return out


def flipped_decisions(times, ref_times):
    """The dt decisions that part two runs: steps that start from a time
    both runs reach and end at different times. [(row, t0, t, t_ref)]."""
    a, b = np.concatenate([[0.0], times]), np.concatenate([[0.0], ref_times])
    flips = []
    for i in range(len(a) - 1):
        j = np.flatnonzero(np.isclose(b, a[i], rtol=1e-9, atol=0))
        if len(j) and j[0] + 1 < len(b) and not np.isclose(
                a[i + 1], b[j[0] + 1], rtol=1e-9, atol=0):
            flips.append((i + 1, a[i], a[i + 1], b[j[0] + 1]))
    return flips


def hold_trajectory(label, result, ref_csv, end_time, min_matched, interp_tol,
                    tfe_tol=1e-6, col2_tol=1e-9):
    """An adaptive run to its final time against ``ref_csv``, by the
    ``tools/check_trajectories.py`` BOUNDS: the time column equal (rtol
    1e-9) for at least ``min_matched`` rows, with the observables within
    ``tfe_tol`` and ``col2_tol`` on those rows; TFE interpolated onto the
    reference times within rel ``interp_tol``; the run at its final time.
    Returns the matched rows and the flipped dt decisions."""
    from pfhubbenchmarks_tpu_torch.io.csvout import read_csv

    ref, cols = read_csv(os.path.join(HERE, "results", ref_csv))
    ours = result.rows
    if list(result.columns) != cols:
        raise AssertionError(f"columns {result.columns} != {cols}")
    n = min(len(ours), len(ref))
    match = np.isclose(ours[:n, 0], ref[:n, 0], rtol=1e-9, atol=0)
    k = n if match.all() else int(np.argmin(match))
    tfe_rel = sol_rel = float("inf")
    if k:
        tfe_rel = float(np.max(np.abs(ours[:k, 1] - ref[:k, 1])
                               / np.abs(ref[:k, 1])))
        sol_rel = float(np.max(np.abs(ours[:k, 2] - ref[:k, 2])
                               / np.abs(ref[:k, 2])))
    tmax = min(ours[-1, 0], ref[-1, 0])
    sel = ref[:, 0] <= tmax
    interp = np.interp(ref[sel, 0], ours[:, 0], ours[:, 1])
    interp_rel = float(np.max(np.abs(interp - ref[sel, 1]) / np.abs(ref[sel, 1])))
    flips = flipped_decisions(ours[:, 0], ref[:, 0])
    # the smokes before kernel V matched every row of each reference they
    # ran to the end
    print(f"{label}: time column {ours[:, 0].tolist()}; "
          + (f"equal to the smokes' before kernel V on these {n} rows (rows "
             f"of results/{ref_csv})" if k == n else "parts from the smokes' "
             f"before kernel V, which matched every row of "
             f"results/{ref_csv}"), flush=True)
    print(f"{label}: vs results/{ref_csv}: {len(ours)} rows to "
          f"t={ours[-1, 0]:.6g} against {len(ref)} to t={ref[-1, 0]:.6g}; "
          f"matched rows {k} (>= {min_matched}), tfe_rel on them "
          f"{tfe_rel:.3e} (<={tfe_tol:g}), {cols[2]}_rel {sol_rel:.3e} "
          f"(<={col2_tol:g}); interp tfe_rel {interp_rel:.3e} "
          f"(<={interp_tol:g}); flipped dt decisions {len(flips)}", flush=True)
    if k < n or len(ours) != len(ref):
        print(f"{label}: first row that parts: row {k + 1}, t="
              f"{ours[k, 0] if k < len(ours) else None} against "
              f"t={ref[k, 0] if k < len(ref) else None}", flush=True)
    for row, t0, t, t_ref in flips:
        print(f"{label}: dt decision flipped at row {row}: from t={t0:.6g} "
              f"to {t:.6g} (dt {t - t0:.6g}) against {t_ref:.6g} (dt "
              f"{t_ref - t0:.6g})", flush=True)
    if (k < min_matched or (k and (tfe_rel > tfe_tol or sol_rel > col2_tol))
            or interp_rel > interp_tol or ours[-1, 0] < end_time * (1 - 1e-12)):
        raise AssertionError(f"{label}: the run fails the bounds against "
                             f"results/{ref_csv}")
    return k, flips


def replay_phase(label, problem, dev, ref_csv, n_rows, required, tfe_tol,
                 col2_tol, absent=GATHER_ABSENT):
    """``timeloop.run`` of ``problem`` on the time grid of ``ref_csv``
    (column 0), at most ``n_rows`` steps, with ``replay_partial`` (a step
    no rung solves ends the run short, which the row check refuses), held
    against ``ref_csv``; prints the rung and ladder of every rescued step.
    ``required`` and ``absent`` as for ``drive``. Returns ``drive``'s
    counts, result and wall."""
    from pfhubbenchmarks_tpu_torch import timeloop
    from pfhubbenchmarks_tpu_torch.io.csvout import read_csv

    grid = read_csv(os.path.join(HERE, "results", ref_csv))[0][:, 0]
    counts, result, wall, _ = drive(
        label, problem, lambda: timeloop.run(
            problem, device=dev, time_grid=grid, max_steps=n_rows,
            replay_partial=True, verbose=True), required, absent)
    for st in result.stats:
        if st.rescue:
            ladder = ", ".join(
                f"{r['rung']} {r['newton']}/{r['krylov']} "
                f"{'ok' if r['converged'] else 'failed'}" for r in st.ladder)
            print(f"{label}: step {st.step} (t={st.t:.6g}, dt={st.dt:.6g}) "
                  f"rescued by {st.rescue}; rungs (newton/krylov): {ladder}",
                  flush=True)
    hold_rows(label, result, ref_csv, n_rows, tfe_tol, col2_tol)
    return counts, result, wall


def rescued_at(result, t):
    """The stats of the step to time ``t``."""
    return next(st for st in result.stats if np.isclose(st.t, t, rtol=1e-9))


def kernel_records():
    """The per-kernel and per-chain records of the kernel line."""
    from pfhubbenchmarks_tpu_torch.ops import _lib

    replaces_vc = "pfhubbenchmarks_tpu/ops/pallas_vcycle.py:200"
    replaces_jv = "pfhubbenchmarks_tpu/ops/pallas_residual.py:198"
    csrc = "pfhubbenchmarks_tpu_torch/csrc/"
    K = {
        "ch_jvp": Kernel("ch_jvp", csrc + "ch_jvp.cu", replaces_jv),
        # E: W at BM6's physics took its place on bench6's outer J.v
        "chp_jvp": Kernel("chp_jvp", csrc + "chp_jvp.cu", replaces_jv,
                          comparison_of="tri_box_chp"),
        "chac_jvp": Kernel("chac_jvp", csrc + "chac_jvp.cu", replaces_jv),
        "ach_jvp": Kernel("ach_jvp", csrc + "ach_jvp.cu", replaces_jv),
        # the z-slab J.v (row 16) and the whole-array one (row 14): U on
        # every path, I (the gather form) its comparison in phase 11
        "ch3d_jvp": Kernel("ch3d_jvp", csrc + "ch3d_jvp.cu",
                           "pfhubbenchmarks_tpu/ops/pallas3d.py:294",
                           ("pfhubbenchmarks_tpu/ops/pallas3d.py:149",),
                           comparison_of="ch3d_tile"),
        "ch3d_tile": Kernel("ch3d_tile", csrc + "fem_tet_tile.cuh",
                            "pfhubbenchmarks_tpu/ops/pallas3d.py:294",
                            ("pfhubbenchmarks_tpu/ops/pallas3d.py:149",)),
        "block_jacobi_apply": Kernel("block_jacobi_apply",
                                     csrc + "block_jacobi.cu", replaces_vc),
        "lmr_step": Kernel("lmr_step", csrc + "lmr.cu", replaces_vc),
        # L: the sweep loop of a gather level in one launch (rows 3, 4, 11,
        # 15, 17), one source per physics over lmr_loop.cuh
        "lmr_sweep": Kernel(
            "lmr_sweep", csrc + "lmr_loop.cuh",
            "pfhubbenchmarks_tpu/ops/pallas_residual.py:247",
            ("pfhubbenchmarks_tpu/ops/pallas_residual.py:333",
             "pfhubbenchmarks_tpu/ops/pallas_tiled.py:189",
             "pfhubbenchmarks_tpu/ops/pallas3d.py:182",
             "pfhubbenchmarks_tpu/ops/pallas3d.py:347")),
        "transfer_dyadic": Kernel("transfer_dyadic", csrc + "transfer.cu",
                                  replaces_vc),
        # the general-ratio transfers of the fused kernels (_GenLevelMats)
        "transfer_general": Kernel("transfer_general",
                                   csrc + "transfer_general.cu",
                                   "pfhubbenchmarks_tpu/ops/pallas_vcycle.py:97"),
        # R: one body (fem_residual.cuh), one source per physics; the
        # residual box took its place on the cp line search
        "residual": Kernel("residual", csrc + "fem_residual.cuh",
                           "pfhubbenchmarks_tpu/ops/pallas_residual.py:226",
                           comparison_of="residual_box"),
        # T10, T12, TS: one body (fem_tile.cuh), one source per physics
        "tile_jvp_recompute": Kernel(
            "tile_jvp_recompute", csrc + "fem_tile.cuh",
            "pfhubbenchmarks_tpu/ops/pallas_tiled.py:67"),
        "tile_jvp_seam": Kernel("tile_jvp_seam", csrc + "fem_tile.cuh",
                                "pfhubbenchmarks_tpu/ops/pallas_tiled_grid.py:179"),
        "tile_sweep": Kernel("tile_sweep", csrc + "fem_tile.cuh",
                             "pfhubbenchmarks_tpu/ops/pallas_tiled_grid.py:246"),
        # P: the FMA-ladder probe
        "fma_chain": Kernel("fma_chain", csrc + "fma_chain.cu",
                            "tools/probes/lanefill_probe.py:55"),
        # S: the per-shard sweep body of the sharded smoother (its
        # pallas_call at :153)
        "shard_sweep": Kernel("shard_sweep", csrc + "shard_sweep.cu",
                              "pfhubbenchmarks_tpu/parallel/halo_smoother.py:86"),
        # Q: the row-block grid J.v probe
        "gridjvp_probe": Kernel("gridjvp_probe", csrc + "gridjvp_probe.cu",
                                "tools/probes/gridjvp_probe.py:167"),
        # the chains of gather levels in one launch each (rows 7 and 8; a
        # level step, rows 6 and 9, is a chain of one level)
        "vcycle_descend_chain": Kernel(
            "vcycle_descend_chain", csrc + "vcycle_chain.cuh",
            "pfhubbenchmarks_tpu/ops/pallas_vcycle.py:652",
            ("pfhubbenchmarks_tpu/ops/pallas_vcycle.py:566",)),
        "vcycle_ascend_chain": Kernel(
            "vcycle_ascend_chain", csrc + "vcycle_chain.cuh",
            "pfhubbenchmarks_tpu/ops/pallas_vcycle.py:798",
            ("pfhubbenchmarks_tpu/ops/pallas_vcycle.py:939",)),
        # W: the triangle-box J.v (each triangle's point tangents once), the
        # outer J.v and exported A z of bench1, bench2 and bench3 in place of
        # A, F and G
        "tri_box": Kernel("tri_box", csrc + "fem_tri_box.cuh", replaces_jv),
        # the residual box (R's residual over triangle boxes, each point
        # residual once), the cp line search's f32 residual of bench2 and
        # bench6 in place of R
        "residual_box": Kernel("residual_box", csrc + "fem_tri_box.cuh",
                               "pfhubbenchmarks_tpu/ops/pallas_residual.py:226"),
        # V: a whole V-cycle apply and its exported A z in one launch (row
        # 5 with with_matvec), bench1's and bench2's apply
        "vcycle_fused": Kernel("vcycle_fused", csrc + "vcycle_fused.cuh",
                               replaces_vc),
        # the anisotropic BM3's instantiations (phys_acha.cuh): W on its
        # outer J.v and exported A z, the gather form (W's comparison, the
        # chains' level J.v) and the two chains
        "acha_jvp": Kernel("acha_jvp", csrc + "acha_jvp.cu", replaces_jv,
                           comparison_of="tri_box_acha"),
        "tri_box_acha": Kernel("tri_box_acha", csrc + "acha_box.cu",
                               replaces_jv),
        "vcycle_descend_chain_acha": Kernel(
            "vcycle_descend_chain_acha", csrc + "vcycle_chain_acha.cu",
            "pfhubbenchmarks_tpu/ops/pallas_vcycle.py:652",
            ("pfhubbenchmarks_tpu/ops/pallas_vcycle.py:566",)),
        "vcycle_ascend_chain_acha": Kernel(
            "vcycle_ascend_chain_acha", csrc + "vcycle_chain_acha.cu",
            "pfhubbenchmarks_tpu/ops/pallas_vcycle.py:798",
            ("pfhubbenchmarks_tpu/ops/pallas_vcycle.py:939",)),
        # N: the 2D node-block-Jacobi build of one level, a port kernel
        # with no TPU row; its one-launch form took its place on the paths
        "node_blocks": Kernel(
            "node_blocks", csrc + "node_blocks.cuh",
            "pfhubbenchmarks_tpu/solve/precond.py:54",
            comparison_of="node_build",
            note="a port kernel with no TPU row: the JAX package builds "
                 "these blocks with jax.jvp in XLA (make_block_jacobi, "
                 "outside any Pallas kernel); library_ms is the port's "
                 "torch.func.jvp build of the same planes"),
        # N's one-launch form: every level's planes and the injected states
        # of a whole multigrid build in one launch, lanes per node
        "node_build": Kernel(
            "node_build", csrc + "node_blocks.cuh",
            "pfhubbenchmarks_tpu/solve/precond.py:54",
            note="a port kernel with no TPU row: the whole 2D multigrid "
                 "build (kernel N at every level and the state injections) "
                 "in one launch; library_ms null (no one PyTorch call "
                 "builds the planes)"),
        # W at BM6's physics with its Dirichlet rows: bench6's outer J.v in
        # place of E
        "tri_box_chp": Kernel("tri_box_chp", csrc + "chp_box.cu",
                              replaces_jv),
        # U and L at bench6_3d's physics with the Dirichlet mask: port
        # kernels with no TPU row (the JAX package runs bench6_3d on XLA)
        "chp3d_tile": Kernel(
            "chp3d_tile", csrc + "chp3d_tile.cu",
            "pfhubbenchmarks_tpu/benchmarks/bench1_3d.py:114",
            ("pfhubbenchmarks_tpu/ops/pallas3d.py:294",),
            note="a port kernel with no TPU row: the JAX package's outer "
                 "J.v factory returns None with Dirichlet faces "
                 "(bench1_3d.py:114-120) and its 3D cycle skips the Pallas "
                 "kernels on levels with BC rows (solve/gmg3d.py:93), so "
                 "bench6_3d's J.v runs on XLA; U's body (row 16's "
                 "counterpart) at BM6's physics with the mask"),
        "lmr_loop_chp3d": Kernel(
            "lmr_loop_chp3d", csrc + "lmr_loop_chp3d.cu",
            "pfhubbenchmarks_tpu/solve/gmg3d.py:93",
            ("pfhubbenchmarks_tpu/ops/pallas3d.py:182",),
            note="a port kernel with no TPU row: the JAX package's 3D cycle "
                 "sweeps bench6_3d's levels on XLA (solve/gmg3d.py:93 skips "
                 "the Pallas sweep kernels on levels with BC rows); L's 3D "
                 "form (row 15's counterpart) at BM6's physics with the "
                 "mask; library_ms null (no one PyTorch call runs n LMR "
                 "sweeps)"),
    }
    seq = ("level J.v (ch_jvp, chp_jvp, chac_jvp or ach_jvp)", "lmr_sweep",
           "transfer_dyadic")
    C = {
        "tile_sweep_loop": Chain(
            "tile_sweep_loop", "pfhubbenchmarks_tpu/ops/pallas_tiled_grid.py:246",
            ("tile_sweep", "lmr_step"),
            source="pfhubbenchmarks_tpu_torch/ops/lmr.py"),
        "descend_level": Chain("descend_level",
                               "pfhubbenchmarks_tpu/ops/pallas_vcycle.py:566",
                               seq + ("transfer_general",)),
        "ascend_level": Chain("ascend_level",
                              "pfhubbenchmarks_tpu/ops/pallas_vcycle.py:939",
                              seq + ("transfer_general",)),
        "descend_chain": Chain("descend_chain",
                               "pfhubbenchmarks_tpu/ops/pallas_vcycle.py:652",
                               seq),
        "ascend_chain": Chain("ascend_chain",
                              "pfhubbenchmarks_tpu/ops/pallas_vcycle.py:798",
                              seq),
    }
    assert set(K) == set(_lib.KERNELS) and set(C) == set(_lib.CHAINS)
    return K, C


def bench1_3d_phases(dev, K, C, rng, t_start, paths):
    """Phases 11 and 12: kernel I, B and C, the 3D sweep loop, transfers,
    builds and one K-cycle apply at bench1_3d's shapes, then bench1_3d's
    main path (all 24 rows, or the first 10 if the smoke has run
    BENCH1_3D_LATE_S by then). Adds the main path's counts to ``paths``."""
    from pfhubbenchmarks_tpu_torch import timeloop
    from pfhubbenchmarks_tpu_torch.benchmarks import bench1_3d
    from pfhubbenchmarks_tpu_torch.fem.assembly3d import make_residual3d
    from pfhubbenchmarks_tpu_torch.ops import _lib, fem_jvp3d, lmr
    from pfhubbenchmarks_tpu_torch.solve import gmg3d
    from pfhubbenchmarks_tpu_torch.solve import transfer3d as t3
    from pfhubbenchmarks_tpu_torch.solve.precond import make_block_jacobi3d

    f32 = torch.float32
    problem = bench1_3d.make()
    s = problem.solver
    F = problem.n_fields
    grids = [dataclasses.replace(g, rule_name=s.precond_rule)
             for g in gmg3d.build_hierarchy3d(problem.grid)]
    assert [g.nx for g in grids] == [50, 25, 5], [g.nx for g in grids]
    dt = 0.4

    def noise(g, scale=1.0):
        return (torch.tensor(scale * rng.standard_normal((F,) + g.vshape),
                             dtype=f32, device=dev),)

    def state(g):
        """The IC on ``g`` plus seeded noise."""
        (v,) = g.interpolate(problem.ic_fns)
        return (torch.tensor(v, dtype=f32, device=dev) + noise(g, 0.01)[0],)

    t11 = time.perf_counter()
    KU, KI = K["ch3d_tile"], K["ch3d_jvp"]
    lib = _lib.library()
    for rule, g0 in [("keast2", grids[0]), ("ffc3", grids[0]),
                     ("keast2", grids[1]), ("keast2", grids[2])]:
        g = dataclasses.replace(g0, rule_name=rule)
        jv = problem.kernel_jvp(g, dev)
        w, v, b = state(g), noise(g), noise(g)
        res = make_residual3d(g, problem.terms, F, device=dev, dtype=f32)

        def library(w=w, v=v, res=res):
            return torch.func.jvp(lambda u: res(u, w, dt), (w,), (v,))[1]

        lab = f"{rule} {g.nz}^3"
        dims = (g.nz, g.ny, g.nx)
        # U and I in turns, each queued behind a sleep kernel
        u_dev = device_ms(lambda: jv.kernel(w, w, dt, v))
        i_dev = device_ms(lambda: jv.gather(w, w, dt, v))
        u_dev2 = device_ms(lambda: jv.kernel(w, w, dt, v))
        plain_ms = cuda_ms(lambda: jv.plain(w, w, dt, v), reps=10)
        u_ms = cuda_ms(lambda: jv.kernel(w, w, dt, v))
        i_ms = cuda_ms(lambda: jv.gather(w, w, dt, v))
        lib_ms = cuda_ms(library, reps=5)
        ref = jv.plain(w, w, dt, v)
        got, again = jv.kernel(w, w, dt, v), jv.kernel(w, w, dt, v)
        KU.check(f"{lab} Jv", got, ref, TOL_F32, (u_ms, plain_ms),
                 jvp3d_work(g), library_ms=lib_ms, dev_ms=u_dev)
        KU.check(f"{lab} Jv vs torch.func.jvp", got, library(), TOL_F32)
        if not torch.equal(got[0], again[0]):
            raise AssertionError(f"U {lab}: a rerun changed the bits")
        gat = jv.gather(w, w, dt, v)
        KI.check(f"{lab} Jv", gat, ref, TOL_F32, (i_ms, plain_ms),
                 jvp3d_work(g), library_ms=lib_ms, dev_ms=i_dev)
        d_ui = float((got[0] - gat[0]).abs().max())
        iu = lib.kernel_info("pfh_ch3d_tile_info", jv.launch.nq)
        ii = lib.kernel_info("pfh_ch3d_jvp_info", jv.launch.nq)
        b_ms, b_by = bound(jvp3d_work(g))
        print(f"phase 11: U {lab}: device {u_dev * 1e3:.2f} us per launch "
              f"({u_dev2 * 1e3:.2f} again) vs I's {i_dev * 1e3:.2f} in the "
              f"same call ({i_dev / u_dev:.2f}x); per call {u_ms * 1e3:.1f} "
              f"us (I {i_ms * 1e3:.1f}); bound {b_ms * 1e3:.3f} us ({b_by}); "
              f"{math.prod(fem_jvp3d.tet_boxes(dims))} boxes of "
              f"{fem_jvp3d.TET_BOX} vertices (z, y, x), recompute factor "
              f"{fem_jvp3d.recompute_factor(dims):.3f}; U {iu}; I {ii}; U vs "
              f"I max abs diff {d_ui:.3e}; rerun bit-identical", flush=True)
        if g.nz == 50 and rule == "keast2":
            u_b = device_ms(lambda: jv.kernel(w, w, dt, v, b=b))
            KU.check(f"{lab} b-Jv", jv.kernel(w, w, dt, v, b=b),
                     jv.plain(w, w, dt, v, b=b), TOL_F32,
                     (cuda_ms(lambda: jv.kernel(w, w, dt, v, b=b)),
                      cuda_ms(lambda: jv.plain(w, w, dt, v, b=b), reps=10)),
                     jvp3d_work(g, with_b=True), dev_ms=u_b)
            KI.check(f"{lab} b-Jv", jv.gather(w, w, dt, v, b=b),
                     jv.plain(w, w, dt, v, b=b), TOL_F32)

    # the per-level states and block planes of the hierarchy
    w_ls, pinvs = [], []
    wl = state(grids[0])
    for l, g in enumerate(grids):
        w_ls.append(wl)
        pinvs.append(make_block_jacobi3d(g, problem.terms_tangent, F,
                                         device=dev)(wl, wl, dt).pinv_planes)
        if l + 1 < len(grids):
            wl = t3.inject3d_any(grids[l + 1], g)(wl)

    # B and C on 1-leaf states at 50^3
    g = grids[0]
    r = noise(g)
    timing = (cuda_ms(lambda: lmr.block_jacobi_apply_kernel(pinvs[0], r)),
              cuda_ms(lambda: lmr.block_jacobi_apply_plain(pinvs[0], r)))
    K["block_jacobi_apply"].check(
        "bench1_3d 50^3", lmr.block_jacobi_apply_kernel(pinvs[0], r),
        lmr.block_jacobi_apply_plain(pinvs[0], r), TOL_F32, timing,
        bj3d_work(g), dev_ms=device_ms(
            lambda: lmr.block_jacobi_apply_kernel(pinvs[0], r)))
    x, r, z, az = (noise(g) for _ in range(4))
    xk, rk = [tuple(t.clone() for t in p) for p in (x, r)]
    xp, rp = [tuple(t.clone() for t in p) for p in (x, r)]
    lmr.lmr_step_kernel(xk, rk, z, az)
    lmr.lmr_step_plain(xp, rp, z, az)
    xs, rs = [tuple(t.clone() for t in p) for p in (x, r)]  # scratch
    timing = (cuda_ms(lambda: lmr.lmr_step_kernel(xs, rs, z, az)),
              cuda_ms(lambda: lmr.lmr_step_plain(xs, rs, z, az)))
    K["lmr_step"].check("bench1_3d 50^3", xk + rk, xp + rp, TOL_F32, timing,
                        lmr3d_work(g), dev_ms=device_ms(
                            lambda: lmr.lmr_step_kernel(xs, rs, z, az)))

    # the transfers (plain torch on the card, as XLA in the JAX package)
    for fine, coarse in zip(grids[:-1], grids[1:]):
        P = t3.prolong3d_any(coarse, fine)
        R = t3.restrict3d_any(coarse, fine)
        inj = t3.inject3d_any(coarse, fine)
        xc, rf = noise(coarse), noise(fine)
        lhs = float(torch.vdot(P(xc)[0].double().reshape(-1),
                               rf[0].double().reshape(-1)))
        rhs = float(torch.vdot(xc[0].double().reshape(-1),
                               R(rf)[0].double().reshape(-1)))
        rel = abs(lhs - rhs) / abs(lhs)
        print(f"phase 11: transfers {fine.nz}<->{coarse.nz}: prolong "
              f"{cuda_ms(lambda: P(xc)):.4f} ms, restrict "
              f"{cuda_ms(lambda: R(rf)):.4f} ms, inject "
              f"{cuda_ms(lambda: inj(rf)):.4f} ms per call; "
              f"<P x, y> vs <x, R y> rel {rel:.2e}", flush=True)
        if rel > 1e-5:
            raise AssertionError("the 3D restriction is not the transpose")
        if fine.nz == 2 * coarse.nz:
            # the ratio-2 forms against the general ones at R = 2
            Pg = t3.prolong3d_general(coarse, fine)
            Rg = t3.restrict3d_general(coarse, fine)
            dp = float((P(xc)[0] - Pg(xc)[0]).abs().max())
            dr = float((R(rf)[0] - Rg(rf)[0]).abs().max())
            print(f"phase 11: transfers {fine.nz}<->{coarse.nz} general form "
                  f"at R = 2: prolong {cuda_ms(lambda: Pg(xc)):.4f} ms, "
                  f"restrict {cuda_ms(lambda: Rg(rf)):.4f} ms per call; max "
                  f"abs difference to the ratio-2 forms {dp:.2e} / {dr:.2e}",
                  flush=True)
            if dp > 0.0 or dr > 1e-5 * float(R(rf)[0].abs().max()):
                raise AssertionError("the 3D ratio-2 and general transfers "
                                     "disagree at R = 2")

    # two warm multigrid builds of 50/25/5, with and without the dense 5^3
    # inverse, in turns; then one K-cycle apply
    w13 = problem.initial_state(dev)
    builds = {"with the dense inverse": problem.precond_builder(dev),
              "without": dataclasses.replace(problem, solver=dataclasses.replace(
                  s, gmg_dense_coarse_max_dofs=0)).precond_builder(dev)}
    assert builds["with the dense inverse"].dense_coarse
    assert not builds["without"].dense_coarse
    times = {name: [] for name in builds}
    for rep in range(6):
        for name, build in builds.items():
            torch.cuda.synchronize()
            t_b = time.perf_counter()
            build(w13, w13, dt)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t_b) * 1e3)
    build_ms = {name: statistics.median(t[1:]) for name, t in times.items()}
    for name, t in times.items():
        print(f"phase 11: multigrid build of 50/25/5 {name}: first "
              f"{t[0]:.1f} ms, then median {build_ms[name]:.1f} ms of "
              f"{[round(x, 1) for x in t[1:]]}", flush=True)
    Minv = builds["with the dense inverse"](w13, w13, dt)
    r = noise(grids[0])
    torch.cuda.synchronize()
    _lib.reset_launches()
    Minv(r)
    torch.cuda.synchronize()
    launches = {k: n for k, n in _lib.LAUNCHES.items() if n}
    calls = {k: n for k, n in _lib.CALLS.items() if n}
    print(f"phase 11: one K-cycle apply (50/25/5, kcycle {s.gmg_kcycle}, dense "
          f"5^3): {cuda_ms(lambda: Minv(r), reps=10):.3f} ms per call; "
          f"launches {launches}, chain calls {calls} per apply", flush=True)
    torch.cuda.synchronize()
    print(f"phase 11: bench1_3d-shape kernels agree with their "
          f"plain versions ({time.perf_counter() - t11:.1f} s)", flush=True)

    # ---- phase 12: bench1_3d's main path at 50^3 ------------------------
    runner = timeloop.Runner(problem, dev)
    build = builds["with the dense inverse"]
    n_dofs = gmg3d.coarse_dof_count(build.grids[-1], F)
    print(f"phase 12: hierarchy {[g.nx for g in build.grids]} at "
          f"{s.precond_rule}, kcycle {s.gmg_kcycle}, build.dense_coarse="
          f"{build.dense_coarse} ({n_dofs} coarse dofs)", flush=True)
    n_rows = BENCH1_3D_ROWS
    elapsed = time.perf_counter() - t_start
    if elapsed > BENCH1_3D_LATE_S:
        n_rows = BENCH1_3D_PREFIX_ROWS
        print(f"phase 12: the smoke has run {elapsed:.0f} s (> "
              f"{BENCH1_3D_LATE_S:.0f} s): bench1_3d runs its first "
              f"{n_rows} rows only", flush=True)
    paths["bench1_3d"], result, wall, seconds = run_main_path(
        "phase 12: bench1_3d", runner, None, "bench1_3d_out.csv", n_rows,
        ("ch3d_tile", "lmr_sweep"), tfe_tol=1e-6, col2_tol=1e-9,
        absent=("block_jacobi_apply", "lmr_step", "ch3d_jvp",
                "vcycle_descend_chain", "vcycle_ascend_chain"))
    newton = (sum(st.newton_iters for st in result.stats),
              sum(st.newton_iters_all for st in result.stats))
    print(f"phase 12: bench1_3d newton / newton_all {newton[0]} / {newton[1]} "
          f"against the JAX run's {JAX_BENCH1_3D_NEWTON} over all 24 rows",
          flush=True)
    if n_rows == BENCH1_3D_ROWS and newton != JAX_BENCH1_3D_NEWTON:
        raise AssertionError("bench1_3d's Newton counts part from the JAX run's")
    n_builds = sum(st.newton_iters_all for st in result.stats)
    build_s = seconds["precond_build"]
    print(f"phase 12: multigrid builds on the main path (with the dense 5^3 "
          f"inverse): {n_builds} builds, {build_s:.3f} s measured "
          f"({build_s / n_builds * 1e3:.1f} ms each; phase 11's warm build "
          f"{build_ms['with the dense inverse']:.1f} ms), share "
          f"{build_s / wall:.4f} of the {wall:.3f} s run", flush=True)


def ptxas_lines(source: str) -> list[str]:
    """The ``-Xptxas -v`` lines of one source's build (registers, spills,
    stack) from the library's build log; empty when the library was loaded
    from an earlier build."""
    from pfhubbenchmarks_tpu_torch.ops import _lib

    log = _lib.library().build_log
    head = f"== {source}\n"
    if head not in log:
        return []
    part = log.split(head, 1)[1].split("\n== ", 1)[0]
    return [ln.strip() for ln in part.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def chp3d_phase(dev, K, rng):
    """Phase 32: kernels U and L at bench6_3d's physics with the Dirichlet
    mask (``chp3d_tile``, ``lmr_loop_chp3d``) at its levels 50^3 and 25^3,
    ffc3, with the level's x-face rows of phi masked. U: J.v and b - J.v
    against the plain version (TOL_F32) and ``torch.func.jvp`` of the f32
    residual with its BC rows (its library call); the masked rows equal to
    v (b - v) with ``torch.equal``; a rerun to the bit; device us (launches
    queued behind a sleep kernel) and per-call us of U, the plain version
    and the library call; the bound (CHP3D_OPS). L with the level's sweep
    count (2): against its plain version (TOL_F32), its launch sequence B,
    U, C (``torch.equal``, required: L runs U's body) and a rerun (to the
    bit); device and per-call us of L and the sequence; the bound. The
    ptxas lines of both sources, and registers, spills and CTAs per SM of
    each instantiation."""
    from pfhubbenchmarks_tpu_torch.benchmarks import bench6_3d
    from pfhubbenchmarks_tpu_torch.fem.assembly3d import make_residual3d
    from pfhubbenchmarks_tpu_torch.ops import _lib, lmr
    from pfhubbenchmarks_tpu_torch.solve import gmg3d
    from pfhubbenchmarks_tpu_torch.solve import transfer3d as t3
    from pfhubbenchmarks_tpu_torch.solve.precond import make_block_jacobi3d

    t32 = time.perf_counter()
    f32 = torch.float32
    label = "phase 32"
    pb = bench6_3d.make()
    s, F, dt = pb.solver, pb.n_fields, 0.32
    grids = gmg3d.build_hierarchy3d(pb.grid)
    assert [g.nx for g in grids] == [50, 25, 5] and grids[0].tab().nq == 8
    lib = _lib.library()
    for src in ("chp3d_tile.cu", "lmr_loop_chp3d.cu"):
        print(f"{label}: ptxas {src}: {ptxas_lines(src) or 'not in this log'}",
              flush=True)
    KU, KL = K["chp3d_tile"], K["lmr_loop_chp3d"]
    (v0,) = grids[0].interpolate(pb.ic_fns)
    w = pb.initial_state(dev)
    w = (w[0].to(f32) + torch.tensor(0.01 * rng.standard_normal(v0.shape),
                                     dtype=f32, device=dev),)
    for l, g in enumerate(grids[:2]):
        bcs = pb.dirichlet_for(g)
        jv = pb.kernel_jvp(g, dev, bcs)
        mask = jv.launch.mask != 0
        v, b = ((torch.tensor(rng.standard_normal((F,) + g.vshape), dtype=f32,
                              device=dev),) for _ in range(2))
        res = make_residual3d(g, pb.terms, F, device=dev, dirichlet=bcs,
                              dtype=f32)

        def library(w=w, v=v, res=res):
            return torch.func.jvp(lambda u: res(u, w, dt), (w,), (v,))[1]

        lab = f"bench6_3d {g.nz}^3 ffc3"
        u_dev = device_ms(lambda: jv.kernel(w, w, dt, v))
        u_ms = cuda_ms(lambda: jv.kernel(w, w, dt, v))
        plain_ms = cuda_ms(lambda: jv.plain(w, w, dt, v), reps=10)
        lib_ms = cuda_ms(library, reps=5)
        got, again = jv.kernel(w, w, dt, v), jv.kernel(w, w, dt, v)
        work = jvp3d_work(g, F, ops=CHP3D_OPS, masked=True)
        KU.check(f"{lab} Jv", got, jv.plain(w, w, dt, v), TOL_F32,
                 (u_ms, plain_ms), work, library_ms=lib_ms, dev_ms=u_dev,
                 main=l == 0)
        KU.check(f"{lab} Jv vs torch.func.jvp", got, library(), TOL_F32)
        got_b = jv.kernel(w, w, dt, v, b=b)
        KU.check(f"{lab} b-Jv", got_b, jv.plain(w, w, dt, v, b=b), TOL_F32)
        if not torch.equal(got[0], again[0]):
            raise AssertionError(f"U at CHP3 {lab}: a rerun changed the bits")
        if not (torch.equal(got[0][mask], v[0][mask])
                and torch.equal(got_b[0][mask], (b[0] - v[0])[mask])):
            raise AssertionError(f"U at CHP3 {lab}: a masked row is not v "
                                 "(b - v)")
        info = lib.kernel_info("pfh_chp3d_tile_info", jv.launch.nq)
        b_ms, b_by = bound(work)
        print(f"{label}: U {lab}: device {u_dev * 1e3:.2f} us per launch; per "
              f"call U / plain / torch.func.jvp {u_ms * 1e3:.1f} / "
              f"{plain_ms * 1e3:.1f} / {lib_ms * 1e3:.1f} us; bound "
              f"{b_ms * 1e3:.3f} us ({b_by}); {int(mask.sum())} masked rows "
              f"equal v and b - v; rerun bit-identical; {info} on "
              f"{smi_line()}", flush=True)

        # L with the level's sweeps, against its plain version and sequence
        pinv = make_block_jacobi3d(g, pb.terms_tangent, F, device=dev,
                                   dirichlet=bcs)(w, w, dt).pinv_planes
        for n in sorted({s.gmg_nu_pre, s.gmg_nu_post}):
            sweep = lmr.make_lmr_sweep_loop(jv, n)
            r0 = torch.tensor(rng.standard_normal((F,) + g.vshape), dtype=f32,
                              device=dev)

            def run(version, r0=r0, sweep=sweep):
                x, r = (torch.zeros_like(r0),), (r0.clone(),)
                return getattr(sweep, version)(x, r, w, w, dt, *pinv)

            kout, kagain = run("kernel"), run("kernel")
            seq, ref = run("sequence"), run("plain")
            kflat, seqflat = kout[0] + kout[1], seq[0] + seq[1]
            same = all(torch.equal(a, c) for a, c in zip(kflat, seqflat))
            if not all(torch.equal(a, c) for a, c in
                       zip(kflat, kagain[0] + kagain[1])):
                raise AssertionError(f"L at CHP3 {lab}: a rerun changed the "
                                     "bits")
            l_dev = device_ms(lambda: run("kernel"))
            s_dev = device_ms(lambda: run("sequence"))
            per = interleaved_ms({"kernel": lambda: run("kernel"),
                                  "sequence": lambda: run("sequence")})
            p_ms = once_ms(lambda: run("plain"))
            swork = sweep3d_work(g, n, F, ops=CHP3D_OPS, masked=True)
            KL.check(f"{lab} n={n}", kflat, ref[0] + ref[1], TOL_F32,
                     (per["kernel"], p_ms), swork, dev_ms=l_dev, main=l == 0)
            lb_ms, lb_by = bound(swork)
            d_seq = max(float((a - c).abs().max())
                        for a, c in zip(kflat, seqflat))
            print(f"{label}: L {lab} n={n}: device {l_dev * 1e3:.2f} us vs the "
                  f"sequence B, U, C's {s_dev * 1e3:.2f}; per call "
                  f"{per['kernel'] * 1e3:.1f} vs {per['sequence'] * 1e3:.1f} "
                  f"us, plain {p_ms * 1e3:.1f} us; bound {lb_ms * 1e3:.3f} us "
                  f"({lb_by}); vs the sequence max abs diff {d_seq:.3e}"
                  f"{' (bit-identical)' if same else ''}; rerun bit-identical; "
                  f"{lib.kernel_info('pfh_lmr_loop_chp3d_info', jv.launch.nq)}",
                  flush=True)
            if not same:
                raise AssertionError(f"L at CHP3 {lab}: not the bits of its "
                                     "sequence B, U, C")
        w = t3.inject3d_any(grids[l + 1], g)(w)
    torch.cuda.synchronize()
    print(f"{label}: U and L at CHP3 with the mask agree with their plain "
          f"versions ({time.perf_counter() - t32:.1f} s)", flush=True)


def bench6_3d_run(label, problem, dev, gate_name, max_steps=None):
    """bench6_3d's main path through ``Runner.run`` (``drive``: U and L at
    CHP3 required, the other J.v kernels, B, C and the chains refused),
    with every accepted state's phi checked on its x faces; then the rows
    that ``tests/data/<gate_name>.csv`` holds against the run's (time column
    rtol 1e-9, TFE rel 1e-6, solute rel 1e-9) and the ``.json``'s Newton
    counts; the solute conserved to rel 1e-10 of row 1 and TFE decreasing
    on every row; every sweep loop one launch of L (4 per apply) and every
    J.v one of U. Returns ``drive``'s counts and the result."""
    from pfhubbenchmarks_tpu_torch import timeloop

    with open(os.path.join(HERE, "tests", "data", gate_name + ".json")) as f:
        gate = json.load(f)
    runner = timeloop.Runner(problem, dev)
    faces = []
    inner = runner.step

    def step(*a):
        res, obs = inner(*a)
        if res.converged:
            (v,) = res.x
            faces.append(max(float((bc.rows(v) - torch.as_tensor(
                bc.g, dtype=v.dtype, device=v.device)).abs().max())
                for bc in problem.dirichlet))
        return res, obs

    runner.step = step
    counts, result, wall, _ = drive(
        label, problem, lambda: runner.run(max_steps=max_steps, verbose=True),
        ("chp3d_tile", "lmr_loop_chp3d"),
        absent=GATHER_ABSENT + ("ch3d_tile", "ch3d_jvp", "lmr_sweep",
                                "vcycle_descend_chain", "vcycle_ascend_chain",
                                "node_build", "vcycle_fused", "tri_box_chp",
                                "chp_jvp"),
        max_calls=6)
    st = result.stats
    k_all = sum(x.krylov_iters_all for x in st)
    n_u, n_l = counts["chp3d_tile"], counts["lmr_loop_chp3d"]
    print(f"{label}: {len(st)} rows to t={result.rows[-1, 0]:.6g}, wall "
          f"{wall:.3f} s on {smi_line()}; launches U {n_u}, L {n_l} over "
          f"{k_all} Krylov iterations (all attempts): L {n_l / k_all:.3f} and U "
          f"{n_u / k_all:.3f} per iteration; phi on its faces max |phi - g| "
          f"{max(faces):.3e} over {len(faces)} accepted states", flush=True)
    if n_l != 4 * k_all or n_u <= 3 * k_all:
        raise AssertionError(f"{label}: a sweep loop or a J.v ran outside U "
                             "and L")
    if len(faces) != len(st) or max(faces) > 1e-9:
        raise AssertionError(f"{label}: phi is off its Dirichlet faces")
    rows = result.rows
    sol_drift = float(np.max(np.abs(rows[:, 2] / rows[0, 2] - 1.0)))
    print(f"{label}: solute drift from row 1 {sol_drift:.3e} (<= 1e-10); TFE "
          f"decreasing on every row: {bool(np.all(np.diff(rows[:, 1]) < 0))}",
          flush=True)
    if sol_drift > 1e-10 or not np.all(np.diff(rows[:, 1]) < 0):
        raise AssertionError(f"{label}: solute not conserved or TFE not "
                             "decreasing")
    n_ref = len(gate["newton_iters"])
    k = min(n_ref, len(rows))
    newton = [x.newton_iters for x in st]
    krylov = [x.krylov_iters for x in st]
    print(f"{label}: newton per row {newton} against the JAX run's "
          f"{gate['newton_iters']}; krylov per row {krylov} against the JAX "
          f"run's {gate['krylov_iters']} (not held)", flush=True)
    hold_rows(label, dataclasses.replace(result, rows=rows[:k]),
              gate_name + ".csv", n_ref, tfe_tol=1e-6, col2_tol=1e-9,
              ref_dir=os.path.join("tests", "data"))
    if newton[:k] != gate["newton_iters"][:k]:
        raise AssertionError(f"{label}: Newton counts differ from the JAX "
                             "run's")
    return counts, result


def bench6_3d_phases(dev, K, rng, t_start, paths):
    """Phases 32 and 33: U and L at bench6_3d's physics (``chp3d_phase``),
    then bench6_3d's main path at 20^3 (the whole run, against every row of
    the JAX package's ``tests/data/bench6_3d_jax_rows_20``) and at its
    published 50^3 (the whole run to t >= 3, the rows of
    ``tests/data/bench6_3d_jax_rows`` held; only those rows if the smoke has
    run BENCH6_3D_LATE_S by then). Adds the main paths' counts to
    ``paths``."""
    from pfhubbenchmarks_tpu_torch.benchmarks import bench6_3d

    chp3d_phase(dev, K, rng)
    t33 = time.perf_counter()
    label = "phase 33: bench6_3d 20^3"
    counts, result = bench6_3d_run(label, bench6_3d.make(nx=20, ny=20, nz=20),
                                   dev, BENCH6_3D_ROWS_20)
    if result.rows[-1, 0] < 3.0:
        raise AssertionError(f"{label}: the run stopped before t = 3")
    paths["bench6_3d 20^3"] = counts
    label = "phase 33: bench6_3d"
    problem = bench6_3d.make()
    max_steps = None
    elapsed = time.perf_counter() - t_start
    if elapsed > BENCH6_3D_LATE_S:
        with open(os.path.join(HERE, "tests", "data",
                               BENCH6_3D_ROWS_50 + ".json")) as f:
            max_steps = len(json.load(f)["newton_iters"])
        print(f"{label}: the smoke has run {elapsed:.0f} s (> "
              f"{BENCH6_3D_LATE_S:.0f} s): bench6_3d runs the {max_steps} rows "
              f"of the JAX package's 50^3 file only", flush=True)
    build = problem.precond_builder(dev)
    print(f"{label}: hierarchy {[g.nx for g in build.grids]} at ffc3, "
          f"build.dense_coarse={build.dense_coarse}", flush=True)
    if not build.dense_coarse:
        raise AssertionError(f"{label}: the coarsest solve is not the dense "
                             "inverse")
    counts, result = bench6_3d_run(label, problem, dev, BENCH6_3D_ROWS_50,
                                   max_steps)
    if max_steps is None and result.rows[-1, 0] < 3.0:
        raise AssertionError(f"{label}: the run stopped before t = 3")
    paths["bench6_3d"] = counts
    print(f"phase 33: bench6_3d's two runs ({time.perf_counter() - t33:.1f} s)",
          flush=True)


# phases 34-36: the JAX package's CPU rows of the linear problems
# (tools/jax_linear_rows.py), by run label
LINEAR_ROWS = os.path.join("tests", "data", "linear_jax_rows.json")
# the largest floating-point CPU result a linear run may make: FGMRES's
# Hessenberg column (restart + 1 <= 51 values) is read to the host
HOST_FLOATS_MAX = 64


class HostFloats(TorchDispatchMode):
    """Watches every aten op run under it and counts, by op, those that
    give a floating-point CPU tensor of more than ``HOST_FLOATS_MAX``
    elements: a run on the card that makes one has left the card. Host
    data becoming a tensor (``lift_fresh``: the problem's tabulations,
    coordinates and boundary values, uploaded as they are built) is counted
    apart, in ``uploads``."""

    def __init__(self):
        super().__init__()
        self.ops = {}
        self.n_ops = 0
        self.uploads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.n_ops += 1
        if func.__name__.startswith("lift_fresh"):
            self.uploads += 1
            return out
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.device.type == "cpu"
                    and t.is_floating_point() and t.numel() > HOST_FLOATS_MAX):
                self.ops[str(func)] = self.ops.get(str(func), 0) + 1
        return out


def linear_run(label, name, kwargs, dev):
    """One run of ``name`` (``make(**kwargs)``) through ``timeloop.run`` on
    ``dev``: the launch counts and stage seconds set to 0 just before, the
    peak memory statistics reset; no kernel may launch and the state must
    be f64 on the card. Returns the result, its wall seconds, the stage
    seconds and the peak bytes allocated."""
    from pfhubbenchmarks_tpu_torch import timeloop
    from pfhubbenchmarks_tpu_torch.benchmarks.registry import get_benchmark
    from pfhubbenchmarks_tpu_torch.ops import _lib

    problem = get_benchmark(name, **kwargs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    t0 = time.perf_counter()
    result = timeloop.run(problem, device=dev, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: n for k, n in {**_lib.LAUNCHES, **_lib.CALLS}.items() if n}
    if launched:
        raise AssertionError(f"{label}: kernels launched on the f64 branch: "
                             f"{launched}")
    if any(t.device.type != dev.type or t.dtype != torch.float64
           for t in result.state):
        raise AssertionError(f"{label}: the state is not f64 on the card")
    return result, wall, dict(_lib.SECONDS), torch.cuda.max_memory_allocated()


def hold_linear_row(label, result, ref, rtol=1e-6):
    """The run's one row against the JAX package's row ``ref`` (a run of
    ``LINEAR_ROWS``): time column equal, Newton counts equal, each
    observable within ``rtol``; the Krylov counts printed beside the JAX
    run's. Returns the observables' largest relative difference."""
    rows = result.rows
    newton = [s.newton_iters for s in result.stats]
    krylov = [s.krylov_iters for s in result.stats]
    ref_rows = np.asarray(ref["rows"])
    if list(result.columns) != ref["columns"] or rows.shape != ref_rows.shape:
        raise AssertionError(f"{label}: rows {rows.shape} {result.columns} vs "
                             f"the JAX run's {ref_rows.shape} {ref['columns']}")
    rel = np.abs(rows[:, 1:] / ref_rows[:, 1:] - 1.0)
    print(f"{label}: row {rows.tolist()} against the JAX package's CPU row "
          f"{ref_rows.tolist()}: rel {rel.tolist()} (<= {rtol:g}); newton "
          f"{newton} (the JAX run's {ref['newton_iters']}), krylov {krylov} "
          f"(the JAX run's {ref['krylov_iters']}, not held)", flush=True)
    if not np.array_equal(rows[:, 0], ref_rows[:, 0]):
        raise AssertionError(f"{label}: the time column differs")
    if newton != ref["newton_iters"]:
        raise AssertionError(f"{label}: Newton counts differ")
    if not np.isfinite(rows).all() or float(rel.max()) > rtol:
        raise AssertionError(f"{label}: the row differs from the JAX run's")
    return float(rel.max())


def linear_rates(label, name, sizes, lo, hi, dev):
    """The port's L2 rates on the card: ``name`` at each of ``sizes`` (cells
    per axis), log2 of the ratio of successive L2 errors over the ratio of
    sizes, each in (``lo``, ``hi``)."""
    errs = []
    for n in sizes:
        kw = {"nx": n, "ny": n} | ({"nz": n} if name == "poisson3d" else {})
        result, _, _, _ = linear_run(label, name, kw, dev)
        errs.append(float(np.sqrt(result.rows[0, 1])))
    rates = [math.log(errs[i] / errs[i + 1]) / math.log(sizes[i + 1] / sizes[i])
             for i in range(len(sizes) - 1)]
    print(f"{label}: L2 errors {errs} at {list(sizes)}, rates {rates} (in "
          f"{lo}-{hi})", flush=True)
    if not all(lo < r < hi for r in rates):
        raise AssertionError(f"{label}: the L2 rates leave {lo}-{hi}")


def linear_checked(label, name, kwargs, dev):
    """``linear_run`` under ``HostFloats``: no op may give a floating-point
    CPU tensor of more than ``HOST_FLOATS_MAX`` elements."""
    watch = HostFloats()
    with watch:
        linear_run(label, name, kwargs, dev)
    print(f"{label}: {watch.n_ops} aten ops watched ({watch.uploads} host "
          f"arrays lifted to tensors), floating-point CPU results of more "
          f"than {HOST_FLOATS_MAX} elements: {watch.ops or 'none'}",
          flush=True)
    if watch.ops:
        raise AssertionError(f"{label}: the run left the card: {watch.ops}")


def linear_phases(dev):
    """Phases 34-36: poisson, poisson3d and elast at their published sizes
    on the card against the JAX package's CPU rows, the L2 rates, elast
    against ``results/elast_out.csv`` and its dense build in parts."""
    from pfhubbenchmarks_tpu_torch.benchmarks.elast import make as make_elast
    from pfhubbenchmarks_tpu_torch.io.csvout import read_csv
    from pfhubbenchmarks_tpu_torch.ops import _lib

    with open(os.path.join(HERE, LINEAR_ROWS)) as f:
        jax_rows = json.load(f)["runs"]
    smi = smi_line()
    walls = {}
    for phase, key, name, kwargs in (
            (34, "poisson 64x64", "poisson", {"nx": 64, "ny": 64}),
            (35, "poisson3d 32^3", "poisson3d", {"nx": 32, "ny": 32, "nz": 32})):
        label = f"phase {phase}: {key}"
        t_phase = time.perf_counter()
        result, wall, _, peak = linear_run(label, name, kwargs, dev)
        walls[key] = wall
        print(f"{label}: wall {wall:.3f} s on {smi}, peak "
              f"{peak / 2**20:.1f} MiB allocated", flush=True)
        hold_linear_row(label, result, jax_rows[key])
        linear_checked(label, name, kwargs, dev)
        if name == "poisson":
            linear_rates(label, name, (16, 32, 64), 1.8, 2.3, dev)
        else:
            linear_rates(label, name, (12, 24), 1.7, 2.4, dev)
        print(f"{label}: phase {time.perf_counter() - t_phase:.1f} s",
              flush=True)

    label, key = "phase 36: elast 250x10", "elast 250x10"
    t_phase = time.perf_counter()
    result, wall, seconds, peak = linear_run(label, "elast", {}, dev)
    walls[key] = wall
    parts = {k: seconds[k] * 1e3 for k in ("dense_jacobian", "dense_lu",
                                           "dense_inverse")}
    print(f"{label}: wall {wall:.3f} s on {smi}, peak {peak / 2**30:.3f} GiB "
          f"allocated; the dense build in the run: J columns "
          f"{parts['dense_jacobian']:.2f} ms, LU {parts['dense_lu']:.2f} ms, "
          f"explicit inverse {parts['dense_inverse']:.2f} ms", flush=True)
    hold_linear_row(label, result, jax_rows[key])
    csv_rows, _ = read_csv(os.path.join(HERE, "results", "elast_out.csv"))
    energy, tip = result.rows[0, 1], result.rows[0, 2]
    d_energy = abs(energy - csv_rows[0, 1])
    r_tip = abs(tip / csv_rows[0, 2] - 1.0)
    print(f"{label}: against results/elast_out.csv {csv_rows[0].tolist()}: "
          f"strain_energy abs {d_energy:.3e} (<= 5e-11), tip_deflection rel "
          f"{r_tip:.3e} (<= 1e-6; abs {abs(tip - csv_rows[0, 2]):.3e})",
          flush=True)
    if d_energy > 5e-11 or r_tip > 1e-6:
        raise AssertionError(f"{label}: the row differs from elast_out.csv")
    linear_checked(label, "elast", {}, dev)
    # a warm build and one apply, by CUDA events
    problem = make_elast()
    w = problem.initial_state(dev)
    build = problem.precond_builder(dev)
    _lib.reset_launches()
    torch.cuda.synchronize()
    t_b = time.perf_counter()
    Minv = build(w, w, 1.0)
    torch.cuda.synchronize()
    warm = {k: _lib.SECONDS[k] * 1e3 for k in parts}
    if Minv.inverse.device.type != dev.type or Minv.inverse.dtype != torch.float64:
        raise AssertionError(f"{label}: the dense inverse is not f64 on the "
                             "card")
    r = tuple(torch.randn_like(t) for t in w)
    apply_ms = cuda_ms(lambda: Minv(r), reps=20)
    print(f"{label}: warm build {(time.perf_counter() - t_b) * 1e3:.2f} ms: J "
          f"columns {warm['dense_jacobian']:.2f} ms, LU {warm['dense_lu']:.2f} "
          f"ms, explicit inverse {warm['dense_inverse']:.2f} ms; one apply "
          f"{apply_ms:.4f} ms (n = {Minv.inverse.shape[0]}, f64)", flush=True)
    del Minv
    print(f"{label}: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    print(f"phases 34-36: walls poisson 64^2 {walls['poisson 64x64']:.3f} s, "
          f"poisson3d 32^3 {walls['poisson3d 32^3']:.3f} s, elast 250x10 "
          f"{walls[key]:.3f} s on {smi}", flush=True)


def tile_phases(dev, K, C, noise_pair, state_on, residual_jvp, paths, refs):
    """Phases 13-15: kernels R, T10, T12, TS and the tiled sweep loop against
    their plain versions (and T10/T12 against ``torch.func.jvp`` of the f32
    residual, their library call), with device times; then bench1 and
    bench3 in the tiled configuration, held against the rows and per-step
    Newton counts of their gather runs (``refs``: phase 4's and phase 10's
    results and walls). Adds the main paths' counts to ``paths``."""
    from pfhubbenchmarks_tpu_torch import timeloop
    from pfhubbenchmarks_tpu_torch.benchmarks import bench1, bench2, bench3, bench6
    from pfhubbenchmarks_tpu_torch.ops import lmr

    t13 = time.perf_counter()
    p1, p2, p3, p6 = bench1.make(), bench2.make(), bench3.make(), bench6.make()

    # R at bench6 (Dirichlet rows u - g), bench2 (1, 2 and 4 order
    # parameters) and bench1, on the true-rule grid
    KR = K["residual"]
    for label, pb, ops, n_prev, dt_ in (
            ("bench6", p6, RESIDUAL_OPS["chp"], 1, 0.32),
            ("bench2 NE=4", p2, RESIDUAL_OPS[4], 5, 0.16),
            ("bench2 NE=2", bench2.make(num_eta=2), RESIDUAL_OPS[2], 3, 0.16),
            ("bench2 NE=1", bench2.make(num_eta=1), RESIDUAL_OPS[1], 2, 0.16),
            ("bench1", p1, RESIDUAL_OPS["ch"], 1, 0.5)):
        g, F = pb.grid, pb.n_fields
        res = pb.kernel_residual(g, dev, pb.dirichlet)
        w, w0 = state_on(pb, g), state_on(pb, g)
        timing = (cuda_ms(lambda: res.kernel(w, w0, dt_)),
                  cuda_ms(lambda: res.plain(w, w0, dt_), reps=10))
        KR.check(f"{label} {g.ny}x{g.nx}", res.kernel(w, w0, dt_),
                 res.plain(w, w0, dt_), TOL_R, timing,
                 residual_work(g, F, ops, n_prev, masked=bool(pb.dirichlet)),
                 dev_ms=device_ms(lambda: res.kernel(w, w0, dt_)))

    # T10 and T12 (J.v and b - J.v) against their plain versions and
    # torch.func.jvp: bench3 at 350^2 and 175^2, bench1 and bench2 at 100^2,
    # then the JAX tests' shapes (bench1 24^2, bench2 16^2)
    jv_kw3 = dict(ns=2, ops=TANGENT_OPS["ach"])
    dt3, dt2 = 1.28, 0.16
    g350, g175 = p3.grid, dataclasses.replace(p3.grid, nx=175, ny=175)
    cases = [(p3, dataclasses.replace(g0, rule_name=rule), {}, dt3, jv_kw3)
             for g0 in (g350, g175) for rule in ("ffc3", "dunavant2")]
    cases += [(p1, dataclasses.replace(p1.grid, rule_name=rule), {}, 0.5, {})
              for rule in ("ffc3", "dunavant2")]
    cases += [(p2, dataclasses.replace(p2.grid, rule_name=rule),
               dict(split=split), dt2,
               dict(ns=5, ops=TANGENT_OPS[(6, "split" if split else "coupled")]))
              for split, rule in ((False, "ffc3"), (True, "dunavant1"))]
    cases += [(bench1.make(nx=24, ny=24), None, {}, 0.3, None),
              (bench2.make(nx=16, ny=16), None, dict(split=False), 0.05, None)]
    devt = {}
    for pb, g, kw, dt_, jv_kw in cases:
        g = g or pb.grid
        F = pb.n_fields
        w, v, b = state_on(pb, g), noise_pair(g, F), noise_pair(g, F)
        split = kw.get("split", False)
        library = residual_jvp(pb, g, w, dt_, v,
                               pb.terms_precond if split else None)
        lab = (f"{pb.name}{' split' if split else ''} {g.rule_name} "
               f"{g.ny}x{g.nx}")
        timed = jv_kw is not None and g.nx in (350, 100)
        for form in ("recompute", "seam"):
            kk = K[f"tile_jvp_{form}"]
            jv = pb.kernel_jvp(g, dev, form=form, **kw)
            timing = work = library_ms = None
            if timed:
                timing = (cuda_ms(lambda: jv.kernel(w, w, dt_, v)),
                          cuda_ms(lambda: jv.plain(w, w, dt_, v), reps=10))
                work = jvp_work(g, F, **jv_kw)
                library_ms = cuda_ms(library, reps=10)
            # the main shapes: T10 the outer J.v (ffc3), T12 the levels
            main = g.nx == 350 and (form == "recompute") == (g.rule_name == "ffc3")
            kk.check(f"{lab} Jv", jv.kernel(w, w, dt_, v),
                     jv.plain(w, w, dt_, v), TOL_F32, timing, work,
                     library_ms=library_ms, main=main)
            kk.check(f"{lab} b-Jv", jv.kernel(w, w, dt_, v, b=b),
                     jv.plain(w, w, dt_, v, b=b), TOL_F32)
            kk.check(f"{lab} Jv vs torch.func.jvp", jv.kernel(w, w, dt_, v),
                     library(), TOL_F32)
            if g.nx == 350:
                devt[(g.rule_name, form)] = device_ms(
                    lambda: jv.kernel(w, w, dt_, v))
                if form == "seam":
                    again = jv.kernel(w, w, dt_, v, b=b)
                    first = jv.kernel(w, w, dt_, v, b=b)
                    if not all(torch.equal(x, y) for x, y in zip(first, again)):
                        raise AssertionError(f"T12 {lab}: a rerun differs")
        if g.nx == 350:
            gather = pb.kernel_jvp(g, dev)
            devt[(g.rule_name, "gather")] = device_ms(
                lambda: gather.kernel(w, w, dt_, v))
    for rule in ("ffc3", "dunavant2"):
        print(f"phase 13: device time per launch at bench3 350^2 {rule}: "
              f"G {devt[(rule, 'gather')]:.5f} ms, T10 "
              f"{devt[(rule, 'recompute')]:.5f} ms, T12 "
              f"{devt[(rule, 'seam')]:.5f} ms", flush=True)
    K["tile_jvp_recompute"].device_ms = devt[("ffc3", "recompute")]
    K["tile_jvp_seam"].device_ms = devt[("dunavant2", "seam")]

    # TS (z and A z) and the tiled sweep loop: bench3 350^2 and bench1 100^2
    # at dunavant2, bench2 100^2 split at dunavant1 with and without the
    # field groups, and the JAX tests' bench2 8^2 (coupled ffc3, and split
    # with the groups)
    KS, CL = K["tile_sweep"], C["tile_sweep_loop"]
    s3, s1 = p3.solver, p1.solver
    ts_cases = [(p3, "dunavant2", False, None, dt3, s3.gmg_nu_pre, jv_kw3),
                (p1, "dunavant2", False, None, 0.5, s1.gmg_nu_pre, {}),
                (p2, "dunavant1", True, p2.field_groups, dt2, 2,
                 dict(ns=5, ops=TANGENT_OPS[(6, "split")])),
                (p2, "dunavant1", True, None, dt2, 2,
                 dict(ns=5, ops=TANGENT_OPS[(6, "split")])),
                (bench2.make(nx=8, ny=8), "ffc3", False, None, 0.05, 1, None),
                (bench2.make(nx=8, ny=8), "dunavant1", True,
                 p2.field_groups, 0.05, 1, None)]
    for pb, rule, split, groups, dt_, n_sw, jv_kw in ts_cases:
        g = dataclasses.replace(pb.grid, rule_name=rule)
        F = pb.n_fields
        w = state_on(pb, g)
        pinv = node_plan(pb, g, dev, split).kernel(w, w, dt_)
        jv = pb.kernel_jvp(g, dev, form="seam",
                           **(dict(split=split) if pb.name.startswith("bench2")
                              else {}))
        ts = jv.tile_sweep
        r = noise_pair(g, F)
        lab = (f"{pb.name}{' split' if split else ''} {rule} {g.ny}x{g.nx}"
               f"{' groups' if groups else ''}")
        timing = work = None
        if jv_kw is not None:
            timing = (cuda_ms(lambda: ts.kernel(w, w, dt_, r, pinv, groups)),
                      cuda_ms(lambda: ts.plain(w, w, dt_, r, pinv, groups),
                              reps=10))
            work = tile_sweep_work(g, F, jv_kw, groups)
        zk, azk = ts.kernel(w, w, dt_, r, pinv, groups)
        zp, azp = ts.plain(w, w, dt_, r, pinv, groups)
        KS.check(f"{lab} (z, Az)", zk + azk, zp + azp, TOL_F32, timing, work,
                 dev_ms=(device_ms(lambda: ts.kernel(w, w, dt_, r, pinv, groups))
                         if g.nx == 350 else None))
        if g.nx == 350:
            z2, az2 = ts.kernel(w, w, dt_, r, pinv, groups)
            if not all(torch.equal(x, y) for x, y in zip(zk + azk, z2 + az2)):
                raise AssertionError(f"TS {lab}: a rerun differs")
        sweep = lmr.make_tile_sweep_loop(ts, n_sw, groups)

        def run_sweep(fn):
            x = tuple(torch.zeros_like(t) for t in r)
            rr = tuple(t.clone() for t in r)
            return fn(x, rr, w, w, dt_, *pinv)

        xk, rk = run_sweep(sweep.kernel)
        xp, rp = run_sweep(sweep.plain)
        timing = work = None
        if jv_kw is not None:
            timing = (cuda_ms(lambda: run_sweep(sweep.kernel), reps=10),
                      cuda_ms(lambda: run_sweep(sweep.plain), reps=3))
            work = sweep_work(g, F, n_sw, jv_kw, groups)
        CL.check(f"{lab} n={n_sw}", xk + rk, xp + rp, TOL_F32, timing, work)
    torch.cuda.synchronize()
    print(f"phase 13: R, T10, T12, TS and the tiled sweep loop agree with "
          f"their plain versions; T12 and TS reruns are bit-identical "
          f"({time.perf_counter() - t13:.1f} s)", flush=True)

    # ---- phases 14 and 15: bench1 and bench3 in the tiled configuration ---
    tiled_required = ("tile_jvp_recompute", "tile_jvp_seam", "tile_sweep",
                      "tile_sweep_loop", "lmr_step", "transfer_dyadic",
                      "descend_chain", "ascend_chain", "node_build")
    # a tiled level's sweeps are TS and C, a gather level's L: no B
    for phase, label, pb, end, n_rows, ref_csv, tols, more in (
            (14, "bench1", p1, None, BENCH1_TILED_ROWS, "bench1_out.csv",
             dict(), ("tri_box", "lmr_sweep")),
            (15, "bench3", p3, None, BENCH3_ROWS, "bench3_out.csv",
             dict(tfe_tol=1e-6, col2_tol=1e-5),
             ("tri_box", "transfer_general", "descend_level", "ascend_level"))):
        pt = dataclasses.replace(pb, solver=dataclasses.replace(
            pb.solver, tiled_grid_kernels=True))
        runner = timeloop.Runner(pt, dev)
        build = pt.precond_builder(dev)
        print(f"phase {phase}: {label} tiled: levels "
              f"{[g.nx for g in build.grids]} routed "
              f"{['tile' if t else 'gather' for t in build.tiled_levels]}",
              flush=True)
        counts, res, wall, _ = run_main_path(
            f"phase {phase}: {label} tiled", runner, end, ref_csv, n_rows,
            tiled_required + more, absent=("block_jacobi_apply",
                                           "vcycle_descend_chain",
                                           "vcycle_ascend_chain",
                                           "node_blocks"), **tols)
        paths[f"{label} tiled"] = counts
        ref, ref_wall = refs[label]
        ref_st = ref.stats[:n_rows]
        ref_newton = [st.newton_iters for st in ref_st]
        newton = [st.newton_iters for st in res.stats]
        print(f"phase {phase}: {label} tiled vs gather (phase "
              f"{4 if label == 'bench1' else 10}), first {n_rows} rows: newton "
              f"{newton} vs {ref_newton}; krylov "
              f"{[st.krylov_iters for st in res.stats]} vs "
              f"{[st.krylov_iters for st in ref_st]}; wall {wall:.3f} s vs "
              f"{ref_wall:.3f} s", flush=True)
        if newton != ref_newton or not np.array_equal(res.rows[:, 0],
                                                       ref.rows[:n_rows, 0]):
            raise AssertionError(f"{label} tiled: rows or Newton counts differ "
                                 "from the gather run")


def fma_chain_phase(dev, K, paths):
    """Phase 16: kernel P against its plain version at the probe's six
    shapes, with per-call times; its SASS (the chain not folded); then the
    probe path (``ops/fma_chain.probe``) with the launch counts set to 0
    just before and read just after. Adds the probe's counts to ``paths``."""
    from pfhubbenchmarks_tpu_torch.ops import _lib
    from pfhubbenchmarks_tpu_torch.ops import fma_chain as P

    t16 = time.perf_counter()
    KP = K["fma_chain"]
    # one f32 ulp of a per step: nvcc contracts a t + y c_i into an FMA,
    # the plain version rounds the product first
    tol = dict(rtol=P_DEPTH * 2.0 ** -23, atol_scale=P_DEPTH * 2.0 ** -23)
    main_name = P.SHAPES[4][0]   # one thread per vertex of kernel I at 50^3
    for name, shape in P.SHAPES:
        x, y = P.inputs(shape, dev)
        n = x.numel()
        timing = (cuda_ms(lambda: P.fma_chain_kernel(x, y, P_DEPTH)),
                  cuda_ms(lambda: P.fma_chain_plain(x, y, P_DEPTH), reps=5))
        KP.check(f"{name} depth {P_DEPTH}", [P.fma_chain_kernel(x, y, P_DEPTH)],
                 [P.fma_chain_plain(x, y, P_DEPTH)], tol, timing,
                 (4 * 3 * n, P.chain_ops(n, P_DEPTH)), main=name == main_name)

    # the chain is not folded: two FMAs a step in the SASS, or, where the
    # toolkit has no cuobjdump, a time per step that stays the same from
    # depth 200 to 800
    x, y = P.inputs(P.SHAPES[4][1], dev)
    t = {d: P.launch_ms(x, y, d, 100) for d in (200, 400, 800)}
    slopes = ((t[400] - t[200]) / 200, (t[800] - t[400]) / 400)
    print(f"phase 16: P at {main_name}: device ms per launch "
          f"{ {d: round(v, 6) for d, v in t.items()} }, ns per step "
          f"{slopes[0] * 1e6:.4f} (200->400) and {slopes[1] * 1e6:.4f} "
          f"(400->800)", flush=True)
    try:
        sass = P.sass_counts(_lib.library().path)
    except FileNotFoundError:
        sass = None
        print("phase 16: no cuobjdump beside nvcc: the check is the time per "
              "step's linearity", flush=True)
        if not 0.8 <= slopes[1] / slopes[0] <= 1.25:
            raise AssertionError("P: the time does not grow linearly in depth")
    if sass is not None:
        print(f"phase 16: SASS FFMA/FMUL per depth {sass}", flush=True)
        if sorted(sass) != list(P.DEPTHS) or any(
                sum(sass[d]) < 2 * d for d in P.DEPTHS):
            raise AssertionError("P: the chain was folded (fewer than two "
                                 "FFMA or FMUL a step)")

    torch.cuda.synchronize()
    _lib.reset_launches()
    probe = P.probe(P_DEPTH, launches=100, device=dev)
    torch.cuda.synchronize()
    paths["lanefill probe"] = dict(_lib.LAUNCHES)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for r in probe:
        print(f"phase 16: probe {r['name']}: {r['threads']} threads "
              f"({r['threads'] / 32 / (4 * sms):.2f} warps per scheduler), "
              f"{r['chain_ms'] * 1e3:.3f} us for {P_DEPTH} steps "
              f"({r['step_ns']:.4f} ns/step), {r['flop_per_s'] / 1e12:.3f} "
              f"TFLOP/s = {r['flop_per_s'] / F32_FLOP_PER_S:.4f} of "
              f"{F32_FLOP_PER_S / 1e12:g}", flush=True)
    if paths["lanefill probe"]["fma_chain"] <= 0:
        raise AssertionError("the probe path did not launch P")
    KP.device_ms = next(r["chain_ms"] for r in probe if r["name"] == main_name)
    print(f"phase 16: P agrees with its plain version; the probe launched it "
          f"{paths['lanefill probe']['fma_chain']} times "
          f"({time.perf_counter() - t16:.1f} s)", flush=True)


# what every 2D main path on gather levels launches besides its J.v: the
# two chains and N's one-launch build (the injections within it)
CHAIN_2D = ("vcycle_descend_chain", "vcycle_ascend_chain", "node_build")
# the paths of kernel V (bench1, bench2 and their variants): V and N's
# one-launch build; no chain kernel and no L (their bodies run in V)
FUSED_2D = ("vcycle_fused", "node_build")
FUSED_ABSENT = GATHER_ABSENT + ("vcycle_descend_chain", "vcycle_ascend_chain",
                                "lmr_sweep")


def prefix_rows(t_start, phase, label, full, prefix, late_s):
    """``full`` rows, or ``prefix`` if the smoke has run more than
    ``late_s`` seconds since ``t_start`` (and says so)."""
    elapsed = time.perf_counter() - t_start
    if elapsed <= late_s:
        return full
    print(f"phase {phase}: the smoke has run {elapsed:.0f} s (> "
          f"{late_s:.0f} s): {label} runs its first {prefix} rows only",
          flush=True)
    return prefix


def replay_phases(dev, t_start, paths, problem1, problem6, problem3):
    """Phases 17-19: the replays of bench1, bench6 and bench3 on the time
    grids of the JAX package's replay CSVs, each cut to a prefix that keeps
    its rescued step if the smoke runs late. Adds each run's counts to
    ``paths``."""
    n = prefix_rows(t_start, 17, "bench1", BENCH1_REPLAY_ROWS,
                    BENCH1_REPLAY_PREFIX, BENCH1_REPLAY_LATE_S)
    paths["bench1 replay"], res1, _ = replay_phase(
        "phase 17: bench1 replay", problem1, dev, "bench1_replay.csv", n,
        FUSED_2D, tfe_tol=1e-5, col2_tol=1e-9,
        absent=FUSED_ABSENT + ("ch_jvp",))
    st = rescued_at(res1, 65.5)
    print(f"phase 17: the step to t=65.5 (step {st.step}): "
          f"{st.rescue or 'its first attempt'}", flush=True)
    if not st.rescue.startswith("substep"):
        raise AssertionError("bench1 replay: the t = 65.5 step did not go "
                             "through the substep warm start")

    n = prefix_rows(t_start, 18, "bench6", BENCH6_REPLAY_ROWS,
                    BENCH6_REPLAY_PREFIX, BENCH6_REPLAY_LATE_S)
    paths["bench6 replay"], _, _ = replay_phase(
        "phase 18: bench6 replay", problem6, dev, "bench6_replay.csv", n,
        ("tri_box_chp", "residual_box", "lmr_sweep") + CHAIN_2D,
        tfe_tol=1e-6, col2_tol=1e-9,
        absent=GATHER_ABSENT + ("residual", "chp_jvp"))

    n = prefix_rows(t_start, 19, "bench3", BENCH3_REPLAY_ROWS,
                    BENCH3_REPLAY_PREFIX, BENCH3_REPLAY_LATE_S)
    paths["bench3 replay"], res3, _ = replay_phase(
        "phase 19: bench3 replay", problem3, dev, "bench3_replay.csv", n,
        ("tri_box",) + CHAIN_2D, tfe_tol=5e-4, col2_tol=5e-4,
        absent=GATHER_ABSENT + ("ach_jvp",))
    st = rescued_at(res3, 41.59)
    rungs = [r["rung"] for r in st.ladder]
    print(f"phase 19: the step to t=41.59 (step {st.step}): "
          f"{st.rescue or 'its first attempt'} after {rungs}", flush=True)
    if (st.rescue != "2x(dt/2)" or "damped from warm" not in rungs
            or "damped from continuation" not in rungs):
        raise AssertionError("bench3 replay: the t = 41.59 step did not take "
                             "the 2x(dt/2) fallback after both damped rungs")


def bench2_more_phases(dev, t_start, paths, problem2):
    """Phases 25 and 26: bench2's replay on the time grid of the JAX
    package's ``results/bench2_replay.csv`` (120 rows; the REPLAY_BOUNDS:
    every row, TFE rel 3e-2, solute rel 1e-9) with the rung that solves the
    t = 81.51 step (the JAX run's: the continuation in dt); bench2_eta1's
    whole adaptive run, made through the registry, against
    ``results/bench2_eta1_out.csv`` (121 rows to t = 100.15): the final
    time reached, TFE interpolated onto its times within rel 3e-2, the
    matched rows printed. Each is cut to a prefix if the smoke runs late.
    Adds each run's counts to ``paths``."""
    from pfhubbenchmarks_tpu_torch import timeloop
    from pfhubbenchmarks_tpu_torch.benchmarks import registry

    required = FUSED_2D + ("residual_box",)
    absent = FUSED_ABSENT + ("chac_jvp", "residual")
    n = prefix_rows(t_start, 25, "bench2's replay", BENCH2_REPLAY_ROWS,
                    BENCH2_REPLAY_PREFIX, BENCH2_REPLAY_LATE_S)
    paths["bench2 replay"], res2, _ = replay_phase(
        "phase 25: bench2 replay", problem2, dev, "bench2_replay.csv", n,
        required, tfe_tol=3e-2, col2_tol=1e-9, absent=absent)
    if res2.rows[-1, 0] >= 81.51 * (1 - 1e-9):
        st = rescued_at(res2, 81.51)
        print(f"phase 25: the step to t=81.51 (step {st.step}): solved by "
              f"{st.rescue or 'its first attempt'} (the JAX run: "
              "continuation)", flush=True)
    else:
        print("phase 25: the replay stops before the t=81.51 step",
              flush=True)

    problem = registry.get_benchmark("bench2_eta1")
    runner = timeloop.Runner(problem, dev)
    full = prefix_rows(t_start, 26, "bench2_eta1", None, BENCH2_ETA1_PREFIX,
                       BENCH2_ETA1_LATE_S)
    paths["bench2_eta1"], res, _, _ = drive(
        "phase 26: bench2_eta1", problem,
        lambda: runner.run(max_steps=full, verbose=True), required, absent,
        max_calls=MAX_CALLS_PER_APPLY["bench2"])
    end = problem.time.end_time if full is None else float(res.rows[-1, 0])
    hold_trajectory("phase 26: bench2_eta1", res, "bench2_eta1_out.csv", end,
                    0, BENCH2_INTERP_TOL, tfe_tol=1e-5)


def shard_sweep_work(slab, F, ns, ops):
    """(bytes, flops) of one launch of kernel S on a shard's slab grid
    ((by+1) x (bx+1) cells): the ``ns`` state planes, r, the F^2 P^-1
    planes and the cell mask in once, the owned windows of z and A z out;
    the block-Jacobi apply at every slab node (bj_work) and the J.v of the
    slab's cells (jvp_work), each once, as the function needs."""
    N, owned = nodes(slab), 2 * (slab.ny - 1) * (slab.nx - 1)
    byts = 4 * ((ns + F + F * F) * N + slab.ny * slab.nx + 2 * F * owned)
    return byts, bj_work(slab, F)[1] + jvp_work(slab, F, ops=ops, ns=ns)[1]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def shard_sweep_phase(dev, K, paths):
    """Phase 20 (TPU row 18): kernel S against its plain version at bench1
    100^2 and bench3 350^2 on 2 x 4 and 2 x 2 ``LocalComm`` meshes; the
    sharded sweep (n = 1 and 3) against the single-device sweep loop
    (kernel L over A's or G's body); the halo residual and functional against the
    global f64 ones; ``DistComm`` over NCCL at world size 1 against
    ``LocalComm``; then the dry run (the path's entry point) at 2 x 4 on
    bench1 and bench3 with the launch counts set to 0 just before and read
    just after. Adds the dry runs' counts to ``paths``."""
    import torch.distributed as dist

    from pfhubbenchmarks_tpu_torch.benchmarks.registry import get_benchmark
    from pfhubbenchmarks_tpu_torch.fem.assembly import (make_functional,
                                                        make_residual)
    from pfhubbenchmarks_tpu_torch.ops import _lib, lmr
    from pfhubbenchmarks_tpu_torch.ops.shard_sweep import (cell_mask,
                                                           make_shard_sweep)
    from pfhubbenchmarks_tpu_torch.parallel import dryrun
    from pfhubbenchmarks_tpu_torch.parallel.comm import DistComm, LocalComm
    from pfhubbenchmarks_tpu_torch.parallel.halo import (block_grid, extend,
                                                         extend_pairs,
                                                         make_halo_functional,
                                                         make_halo_residual)
    from pfhubbenchmarks_tpu_torch.parallel.halo_smoother import (
        make_sharded_lmr_sweep)
    from pfhubbenchmarks_tpu_torch.parallel.mesh import (ShardMesh, join_state,
                                                         shard_state)
    from pfhubbenchmarks_tpu_torch.solve.precond import make_block_jacobi

    t20 = time.perf_counter()
    KS = K["shard_sweep"]
    hold = Kernel("sharded sweep", "", "")   # prints and raises; not recorded
    rng = np.random.default_rng(20261017)
    dt = 0.1
    F = 2

    def logical(pair, g):
        return (pair[0][..., : g.ny + 1, : g.nx + 1].clone(
                    memory_format=torch.contiguous_format),
                pair[1][..., : g.ny, : g.nx].clone(
                    memory_format=torch.contiguous_format))

    def seeded(g, scale, base=None):
        """Seeded noise (plus ``base``) on the logical nodes, 0 in padding."""
        out = []
        for i, (s, (ly, lx)) in enumerate(zip(
                (g.vshape, g.mshape), ((g.ny + 1, g.nx + 1), (g.ny, g.nx)))):
            a = torch.zeros((F,) + s, dtype=torch.float64, device=dev)
            a[:, :ly, :lx] = torch.tensor(scale * rng.standard_normal((F, ly, lx)),
                                          device=dev)
            out.append(a if base is None else base[i] + a)
        return tuple(out)

    devt = {}
    for bench, nx in SHARD_CASES:
        pb0 = get_benchmark(bench, nx=nx, ny=nx)
        phys = pb0.kernel_phys()
        ns, ops = (1, TANGENT_OPS[2]) if phys.kind == "ch" else (2, TANGENT_OPS["ach"])
        for shape in ((2, 4), (2, 2)):
            mesh = ShardMesh(*shape)
            comm = LocalComm(mesh, dev)
            pb = dryrun.aligned_problem(bench, nx, mesh)
            g = pb.grid
            lab = f"{bench} {nx}^2 (stored {g.vshape[0]}x{g.vshape[1]}) mesh {shape[0]}x{shape[1]}"
            w64 = seeded(g, 0.01, pb.initial_state(dev))
            w = tuple(a.float() for a in w64)
            r = tuple(a.float() for a in seeded(g, 1.0))
            planes = make_block_jacobi(g, pb.terms, F, device=dev)(w, w, dt).pinv_planes
            ws, rs, ps = (shard_state(t, comm) for t in (w, r, planes))
            by, bx = mesh.block_shape(*g.vshape)
            slab = block_grid(g, by + 1, bx + 1)
            s = make_shard_sweep(slab, phys, F, device=dev)
            mask = extend([b[0] for b in shard_state(
                (torch.as_tensor(cell_mask(g), device=dev),), comm)], comm, hi=0)
            ws_e = extend_pairs(ws, comm)
            args = list(zip(extend_pairs(rs, comm), ws_e, ws_e,
                            extend_pairs(ps, comm), mask, [dt] * mesh.size))
            got = [s.kernel(*a) for a in args]
            ref = [s.plain(*a) for a in args]
            timing = work = library_ms = dev_ms = None
            main = bench == "bench3" and shape == (2, 4)
            if shape == (2, 4):
                a0 = args[0]
                res_blk = make_residual(slab, pb.terms, F, device=dev,
                                        dtype=torch.float32)
                z_slab = tuple(torch.einsum("ijyx,jyx->iyx", P_, r_)
                               for P_, r_ in zip(a0[3], a0[0]))
                timing = (cuda_ms(lambda: s.kernel(*a0)),
                          cuda_ms(lambda: s.plain(*a0), reps=10))
                work = shard_sweep_work(slab, F, ns, ops)
                library_ms = cuda_ms(lambda: torch.func.jvp(
                    lambda u: res_blk(u, a0[1], dt), (a0[1],), (z_slab,)), reps=10)
                dev_ms = devt[bench] = device_ms(lambda: s.kernel(*a0))
            KS.check(f"{lab} z, Az (every shard)",
                     [t for o in got for pair in o for t in pair],
                     [t for o in ref for pair in o for t in pair], TOL_F32,
                     timing, work, library_ms=library_ms, dev_ms=dev_ms,
                     main=main)

            # the sharded sweep against the single-device sweep loop (kernel
            # L) on the unpadded grid, n = 1 and 3
            jv = pb0.kernel_jvp(pb0.grid, dev)
            sweep = make_sharded_lmr_sweep(g, phys, F, comm)
            x0s = [tuple(torch.zeros_like(t) for t in b) for b in rs]
            for n in (1, 3):
                loop = lmr.make_lmr_sweep_loop(jv, n)
                x1 = tuple(torch.zeros_like(t) for t in logical(r, g))
                r1 = logical(r, g)
                loop.kernel(x1, r1, logical(w, g), logical(w, g), dt,
                            *logical(planes, g))
                xs, rs_n = sweep(x0s, rs, ws, ws, ps, dt, n)
                xg, rg = join_state(xs, mesh), join_state(rs_n, mesh)
                for t in xg + rg:
                    z = t.clone()
                    z[..., : g.ny + 1, : g.nx + 1] = 0.0
                    if float(z.abs().max()) != 0.0:
                        raise AssertionError(f"{lab}: the sharded sweep wrote "
                                             "into the padding")
                hold.check(f"{lab} n={n} vs the single-device sweep loop",
                           list(logical(xg, g) + logical(rg, g)), list(x1 + r1),
                           TOL_F32)
            if shape == (2, 4):
                call_ms = cuda_ms(lambda: sweep(x0s, rs, ws, ws, ps, dt, 1), reps=10)
                print(f"phase 20: {lab}: one sweep with its exchanges "
                      f"{call_ms * 1e3:.1f} us per call ({mesh.size} launches "
                      f"of S, {2 * mesh.size} of C's stages, 9 halo "
                      f"extensions); S device {devt[bench] * 1e3:.3f} us per launch, "
                      f"bound {bound(work)[0] * 1e3:.3f} us ({bound(work)[1]})",
                      flush=True)

            # the halo residual and functional against the global f64 ones
            w0 = pb.initial_state(dev)
            w64s, w0s = shard_state(w64, comm), shard_state(w0, comm)
            rh = join_state(make_halo_residual(g, pb.terms, F, comm)(w64s, w0s, dt),
                            mesh)
            rg = make_residual(g, pb.terms, F, device=dev)(w64, w0, dt)
            rel = max(float((a - b).abs().max() / b.abs().max())
                      for a, b in zip(rh, rg))
            rels = {}
            for name, density in pb.observables.items():
                hv = float(make_halo_functional(g, density, comm)(w64s))
                gv = float(make_functional(g, density, device=dev)(w64))
                rels[name] = abs(hv - gv) / abs(gv)
            print(f"phase 20: {lab}: halo residual rel {rel:.3e}, functionals "
                  f"rel {rels} (<= 1e-12)", flush=True)
            if rel > 1e-12 or max(rels.values()) > 1e-12:
                raise AssertionError(f"{lab}: the halo assembly disagrees with "
                                     "the global one")

    # DistComm over NCCL at world size 1 against LocalComm 1 x 1
    mesh1 = ShardMesh(1, 1)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        outs = {}
        for comm in (LocalComm(mesh1, dev), DistComm(mesh1, dev)):
            pb = dryrun.aligned_problem(*SHARD_CASES[0], mesh1)
            g = pb.grid
            w64 = pb.initial_state(dev)
            w = tuple(a.float() for a in w64)
            planes = make_block_jacobi(g, pb.terms, F, device=dev)(w, w, dt).pinv_planes
            ws = shard_state(w64, comm)
            res = make_halo_residual(g, pb.terms, F, comm)(ws, ws, dt)
            r = [tuple((-t).float() for t in pair) for pair in res]
            x0 = [tuple(torch.zeros_like(t) for t in pair) for pair in r]
            w32s = shard_state(w, comm)
            sweep = make_sharded_lmr_sweep(g, pb.kernel_phys(), F, comm)
            x, r3 = sweep(x0, r, w32s, w32s, shard_state(planes, comm), dt, 3)
            tfe = make_halo_functional(g, pb.observables["total_free_energy"], comm)(ws)
            outs[type(comm).__name__] = [*res[0], *x[0], *r3[0], tfe.reshape(1)]
        same = all(torch.equal(a, b) for a, b in zip(outs["LocalComm"],
                                                      outs["DistComm"]))
        hold.check("DistComm (NCCL, world size 1) vs LocalComm 1x1",
                   outs["DistComm"], outs["LocalComm"],
                   dict(rtol=1e-6, atol_scale=1e-6))
        print(f"phase 20: DistComm over NCCL at world size 1: residual, 3 "
              f"sweeps and TFE {'bit-identical to' if same else 'within 1e-6 of'}"
              " LocalComm 1x1", flush=True)
    finally:
        dist.destroy_process_group()

    # the path: the dry run's entry point at 2 x 4, bench1 and bench3
    for bench, nx in SHARD_CASES:
        torch.cuda.synchronize()
        _lib.reset_launches()
        out = dryrun.main(["--mesh", "2x4", "--bench", bench, "--nx", str(nx)])
        torch.cuda.synchronize()
        paths[f"sharded dry run {bench}"] = counts = dict(_lib.LAUNCHES)
        print(f"phase 20: dry run {bench}: ||r|| {out['residual_norm']}, "
              f"observables {out['observables']}, launches {counts}", flush=True)
        if counts["shard_sweep"] <= 0 or counts["lmr_step"] <= 0:
            raise AssertionError(f"the {bench} dry run did not launch S and C")
    print(f"phase 20: S, the sharded sweep, the halo assembly and DistComm "
          f"agree ({time.perf_counter() - t20:.1f} s)", flush=True)


def gridjvp_phase(dev, K, paths):
    """Phase 21 (TPU row 19): first the probe path (``ops/gridjvp.probe``,
    cases a, b and c, at bench3 350^2), with the launch counts set to 0 just
    before and read just after: Q's launches there go to ``paths`` (G and
    T12 run there as its references and are not counted), and its device
    times per launch of Q, its fold and G are the ones recorded. Then kernel
    Q (cases a and b) and its fold against their plain versions, and the
    folded case a against kernel G and ``torch.func.jvp`` of the f32
    residual, on seeded inputs."""
    from pfhubbenchmarks_tpu_torch.benchmarks import bench3
    from pfhubbenchmarks_tpu_torch.fem.assembly import make_residual
    from pfhubbenchmarks_tpu_torch.ops import _lib, gridjvp

    t21 = time.perf_counter()
    torch.cuda.synchronize()
    _lib.reset_launches()
    outs = {case: gridjvp.probe(case, device=dev, nx=Q_NX, br=Q_BR)
            for case in gridjvp.CASES}
    torch.cuda.synchronize()
    counts = dict(_lib.LAUNCHES)
    paths["gridjvp probe"] = {"gridjvp_probe": counts["gridjvp_probe"]}
    for out in outs.values():
        print(f"phase 21: probe case {out['case']} (body {out['body']}): "
              f"out_m norm {out['out_m_norm']:.6g}, "
              + ", ".join(f"vs {k}: err_v {out[k]['err_v']:.3e} err_m "
                          f"{out[k]['err_m']:.3e} {'ok' if out[k]['ok'] else 'FAIL'}"
                          for k in ("kernel G", "torch.func.jvp") if k in out)
              + "; device us per launch "
              + ", ".join(f"{k} {v:.3f}" for k, v in out["device_us"].items()),
              flush=True)
        if not all(out[k]["ok"] for k in ("kernel G", "torch.func.jvp") if k in out):
            raise AssertionError(f"probe case {out['case']} disagrees")
    if counts["gridjvp_probe"] <= 0:
        raise AssertionError("the probe path did not launch Q")
    # device ms per launch, from the probe's timer
    devt = {case: outs[case]["device_us"]["Q"] / 1e3 for case in ("a", "b")}
    devt["fold"] = outs["a"]["device_us"]["Q fold"] / 1e3
    devt["G"] = outs["a"]["device_us"]["G"] / 1e3

    KQ = K["gridjvp_probe"]
    pb = bench3.make(nx=Q_NX, ny=Q_NX)
    g = pb.grid
    q = gridjvp.make_gridjvp(g, pb.kernel_phys(), device=dev, br=Q_BR)
    rng = np.random.default_rng(20261018)
    w = tuple((a.float() + 0.01 * torch.tensor(rng.standard_normal(a.shape),
                                               dtype=torch.float32, device=dev))
              .contiguous() for a in pb.initial_state(dev))
    z = tuple(torch.tensor(rng.standard_normal(a.shape), dtype=torch.float32,
                           device=dev) for a in w)
    dt = 0.01
    res32 = make_residual(g, pb.terms, 2, device=dev, dtype=torch.float32)
    library = lambda: torch.func.jvp(lambda u: res32(u, w, dt), (w,), (z,))[1]  # noqa: E731
    work = {"a": jvp_work(g, 2, ops=TANGENT_OPS["ach"], ns=2),
            "b": jvp_work(g, 2, ops=0, ns=0)}
    for case in ("a", "b"):
        slabs_k, om_k = q.kernel(case, w, dt, z)
        slabs_p, om_p = q.plain(case, w, dt, z)
        timing = (cuda_ms(lambda: q.fold.kernel(q.kernel(case, w, dt, z)[0])),
                  cuda_ms(lambda: q.fold.plain(q.plain(case, w, dt, z)[0]), reps=10))
        KQ.check(f"case {case} {Q_NX}^2: slabs and cell rows ({q.n_blocks} "
                 f"blocks of {Q_BR})",
                 [slabs_k, om_k], [slabs_p, om_p], TOL_F32, timing, work[case],
                 library_ms=cuda_ms(library, reps=10) if case == "a" else None,
                 dev_ms=devt[case], main=case == "a")
        KQ.check(f"case {case} {Q_NX}^2: fold", [q.fold.kernel(slabs_k)],
                 [q.fold.plain(slabs_k)], TOL_EXACT)
    folded = (q.fold.kernel(q.kernel("a", w, dt, z)[0]), q.kernel("a", w, dt, z)[1])
    jv_g = pb.kernel_jvp(g, dev)
    hold = Kernel("gridjvp folded", "", "")   # prints and raises; not recorded
    hold.check("case a folded vs kernel G", folded, jv_g.kernel(w, w, dt, z), TOL_F32)
    hold.check("case a folded vs torch.func.jvp", folded, library(), TOL_F32)
    print(f"phase 21: device time per launch at bench3 {Q_NX}^2 ffc3: Q case a "
          f"{devt['a'] * 1e3:.3f} us, case b {devt['b'] * 1e3:.3f} us, its fold "
          f"{devt['fold'] * 1e3:.3f} us, G {devt['G'] * 1e3:.3f} us; bound "
          f"{bound(work['a'])[0] * 1e3:.3f} us ({bound(work['a'])[1]})", flush=True)
    print(f"phase 21: Q agrees with its plain version and with G; the probe "
          f"launched it {counts['gridjvp_probe']} times "
          f"({time.perf_counter() - t21:.1f} s)", flush=True)


def once_ms(fn) -> float:
    """One call of ``fn`` between two CUDA events (for the plain versions at
    the large levels, which take seconds)."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def sweep_counts(s, level, n_levels, dense_coarse):
    """The sweep counts the main path runs on ``level`` of a hierarchy of
    ``n_levels`` under solver settings ``s`` (solve/gmg.py, gmg3d.py)."""
    if level == n_levels - 1:
        return set() if dense_coarse else {s.gmg_coarse_sweeps}
    if level == 0:
        return {s.gmg_nu_fine_pre or s.gmg_nu_pre,
                s.gmg_nu_fine_post or s.gmg_nu_post}
    return {s.gmg_nu_pre, s.gmg_nu_post}


def sweep_loop_phase(dev, K, rng):
    """Phase 22: kernel L (the LMR sweep loop of a gather level in one
    launch) at every gather level of the main paths, for each sweep count
    they run there: bench1 100^2/50^2/25^2, bench6 (Dirichlet mask) 100^2/
    50^2/25^2, bench2 (groups) 100^2 and 25^2, bench3 350^2/175^2/35^2,
    bench1_3d 50^3 and 25^3. Each case: L against its plain version (the
    plain sweep loop, TOL_F32), against the launch sequence B, J.v, C
    (``sweep.sequence``: the max abs difference printed, the target 0) and
    against itself on a rerun (to the bit); the device time per call (40
    calls behind a sleep kernel) of L and of the sequence, their per-call
    times, L's bound (``sweep_work``, ``sweep3d_work``), its grid and its
    barrier count; at levels of at most 20,201 nodes also the device time
    of L as one CTA and as the cooperative grid (``lmr_sweep_kernel``'s
    ``one_cta``)."""
    from pfhubbenchmarks_tpu_torch.benchmarks import (bench1, bench1_3d,
                                                      bench2, bench3, bench6)
    from pfhubbenchmarks_tpu_torch.ops import _lib, fem_jvp3d, lmr
    from pfhubbenchmarks_tpu_torch.ops import transfer as kt
    from pfhubbenchmarks_tpu_torch.solve import transfer3d as t3
    from pfhubbenchmarks_tpu_torch.solve.precond import make_block_jacobi3d

    t22 = time.perf_counter()
    KL = K["lmr_sweep"]
    f32 = torch.float32

    def case(label, g, n, jv, w, pinv, dt, groups, work, nodes_, main=False):
        three_d = getattr(g, "dim", 2) == 3
        sweep = lmr.make_lmr_sweep_loop(jv, n, groups)
        b = tuple(torch.tensor(rng.standard_normal(t.shape), dtype=f32,
                               device=dev) for t in w)

        def run(fn):
            x = tuple(torch.zeros_like(t) for t in b)
            r = tuple(t.clone() for t in b)
            fn(x, r, w, w, dt, *pinv)
            return list(x + r)

        got, again, seq = run(sweep.kernel), run(sweep.kernel), run(sweep.sequence)
        plain_ms = once_ms(lambda: run(sweep.plain))
        ref = run(sweep.plain)
        if any(not torch.equal(a, c) for a, c in zip(got, again)):
            raise AssertionError(f"L {label} n={n}: a rerun changed the bits")
        d_seq = max(float((a - c).abs().max()) for a, c in zip(got, seq))
        # in-place calls on scratch copies for the timers
        xs = tuple(torch.zeros_like(t) for t in b)
        rs = tuple(t.clone() for t in b)
        grid = lmr.lmr_sweep_kernel(jv.launch, n, xs, rs, w, dt, pinv, groups)
        l_ms = cuda_ms(lambda: sweep.kernel(xs, rs, w, w, dt, *pinv))
        seq_ms = cuda_ms(lambda: sweep.sequence(xs, rs, w, w, dt, *pinv))
        l_dev = device_ms(lambda: sweep.kernel(xs, rs, w, w, dt, *pinv))
        seq_dev = device_ms(lambda: sweep.sequence(xs, rs, w, w, dt, *pinv))
        forms = ""
        if nodes_ <= 20_201:
            one, coop = (device_ms(lambda k=k: lmr.lmr_sweep_kernel(
                jv.launch, n, xs, rs, w, dt, pinv, groups, one_cta=k))
                for k in (True, False))
            forms = (f"; one CTA {one * 1e3:.2f} us, cooperative grid "
                     f"{coop * 1e3:.2f} us")
        b_ms, b_by = bound(work)
        if three_d:
            info = _lib.library().kernel_info("pfh_lmr_loop_ch3d_info",
                                              jv.launch.nq)
            forms += (f"; L before U (I's gather body) {L3D_BEFORE_U_US[g.nz]} "
                      f"us, {l_dev * 1e3 / L3D_BEFORE_U_US[g.nz]:.3f} of it; U's boxes "
                      f"{math.prod(fem_jvp3d.tet_boxes((g.nz, g.ny, g.nx)))}; "
                      f"L {info}")
        print(f"phase 22: L {label} n={n}: {nodes_} nodes, grid {grid} CTAs, "
              f"{3 * n} barriers; device {l_dev * 1e3:.2f} us per call vs "
              f"the sequence's {seq_dev * 1e3:.2f}; per call {l_ms * 1e3:.1f} "
              f"vs {seq_ms * 1e3:.1f} us; bound {b_ms * 1e3:.3f} us ({b_by})"
              f"{forms}; vs the sequence max abs diff {d_seq:.3e}"
              f"{' (bit-identical)' if d_seq == 0.0 else ''}; rerun "
              f"bit-identical", flush=True)
        if three_d and d_seq != 0.0:
            raise AssertionError(f"L {label} n={n}: not the bits of the "
                                 f"sequence B, U, C ({d_seq:.3e})")
        KL.check(f"{label} n={n}", got, ref, TOL_F32, (l_ms, plain_ms), work,
                 dev_ms=l_dev, main=main)
        KL.check(f"{label} n={n} vs the sequence", got, seq, TOL_F32)

    # 2D: per benchmark its hierarchy at the level rule, the IC (+ noise,
    # Dirichlet values) injected down, the level's block planes and J.v
    for name, pb, dt, split, jv_kw, skip in (
            ("bench1", bench1.make(), 0.5, False, {}, ()),
            ("bench6", bench6.make(), 0.32, False, {}, ()),
            ("bench2", bench2.make(), 0.16, True,
             dict(ns=5, ops=TANGENT_OPS[(6, "split")]), (50,)),
            ("bench3", bench3.make(), 1.28, False,
             dict(ns=2, ops=TANGENT_OPS["ach"]), ())):
        s = pb.solver
        F = pb.n_fields
        build = pb.precond_builder(dev)
        grids = build.grids
        groups = pb.field_groups if split else None
        v, m = grids[0].interpolate(pb.ic_fns)
        w = tuple(torch.tensor(a, dtype=f32, device=dev) + torch.tensor(
            0.01 * rng.standard_normal((F,) + a.shape[1:]), dtype=f32, device=dev)
            for a in (v, m))
        for bc in pb.dirichlet_for(grids[0]):
            w = (bc.apply_value(w[0]).contiguous(), w[1])
        for l, g in enumerate(grids):
            counts = sweep_counts(s, l, len(grids), build.dense_coarse)
            if counts and g.nx not in skip:
                bcs = pb.dirichlet_for(g)
                pinv = node_plan(pb, g, dev, split).kernel(w, w, dt)
                jv = pb.kernel_jvp(g, dev, bcs, split=split)
                for n in sorted(counts):
                    case(f"{name} {g.ny}x{g.nx}{' masked' if bcs else ''}"
                         f"{' groups' if groups else ''}", g, n, jv, w, pinv,
                         dt, groups, sweep_work(g, F, n, jv_kw, groups),
                         nodes(g), main=(name == "bench2" and g.nx == 25))
            if l + 1 < len(grids):
                w = kt.inject(w, grids[l + 1], g)

    # 3D: bench1_3d's 50^3 and 25^3 levels (its 5^3 is the dense solve)
    pb = bench1_3d.make()
    s, F, dt = pb.solver, pb.n_fields, 0.4
    build = pb.precond_builder(dev)
    grids = build.grids
    (v,) = grids[0].interpolate(pb.ic_fns)
    w = (torch.tensor(v, dtype=f32, device=dev) + torch.tensor(
        0.01 * rng.standard_normal(v.shape), dtype=f32, device=dev),)
    for l, g in enumerate(grids):
        counts = sweep_counts(s, l, len(grids), build.dense_coarse)
        if counts:
            pinv = make_block_jacobi3d(g, pb.terms_tangent, F, device=dev)(
                w, w, dt).pinv_planes
            jv = pb.kernel_jvp(g, dev)
            for n in sorted(counts):
                case(f"bench1_3d {g.nz}^3", g, n, jv, w, pinv, dt, None,
                     sweep3d_work(g, n), g.n_vertices)
        if l + 1 < len(grids):
            w = t3.inject3d_any(grids[l + 1], g)(w)
    torch.cuda.synchronize()
    print(f"phase 22: kernel L agrees with its plain version at every gather "
          f"level ({time.perf_counter() - t22:.1f} s)", flush=True)


# phase 28: kernel W against A, F and G at the main shapes (bench1 100^2 and
# a ragged 37 x 23, bench2 100^2 and its levels, bench3 350^2 and its
# levels, all at ffc3, the outer rule), and the gather kernels' device us in
# their first profiles (PERF.md section 6); a size is n (n x n cells) or
# (ny, nx)
TRI_BOX_CASES = (("bench1", None, (100, (37, 23))),
                 ("bench2", 4, (100, 50, 25)), ("bench2", 2, (100,)),
                 ("bench2", 1, (100,)), ("bench3", None, (350, 175, 35, 7)))
GATHER_DEVICE_US_BEFORE = {"chac_jvp": 37.12, "ach_jvp": 24.78, "ch_jvp": 6.48}
# the gather J.v that W replaces on each benchmark's outer J.v: its record
# and its letter
TRI_BOX_GATHER = {"bench1": ("ch_jvp", "A"), "bench2": ("chac_jvp", "F"),
                  "bench3": ("ach_jvp", "G")}


def tri_box_phase(dev, K, rng):
    """Phase 28: kernel W (``tri_box``, the triangle-box J.v, each
    triangle's point tangents once) at every shape of ``TRI_BOX_CASES``
    (bench1 at ffc3 at 100^2 and 37 x 23; bench2 coupled at ffc3 with 4
    order parameters at 100^2, 50^2, 25^2 and with 2 and 1 at 100^2; bench3
    at ffc3 at 350^2, 175^2, 35^2, 7^2), J.v and b - J.v: against its plain
    version (TOL_F32), against the gather kernel it replaces on the outer
    J.v (A, F or G, ``jv.gather``) with ``torch.equal``, and against itself
    on a rerun (to the bit), each required; device us per launch (launches
    queued behind a sleep kernel) of W, the gather kernel and, where it has
    the physics (bench1 100^2, bench2 with 4 order parameters, bench3), T10,
    in two rounds in turns; per-call us of W, the gather kernel and the
    plain version; W's bound (``jvp_work``, the work count of A, F and G),
    boxes, registers, spills, shared bytes and CTAs per SM; at the first
    shape of each benchmark (bench1 and bench2 100^2, bench3 350^2; bench2's
    is W's main shape in the kernel line) also against ``torch.func.jvp`` of
    the f32 residual, its library call, timed per call. Sets the device time
    of W, A and F in the kernel line (G's, at its main shape, comes from
    phase 9, which runs after this phase)."""
    from pfhubbenchmarks_tpu_torch.benchmarks import bench1, bench2, bench3
    from pfhubbenchmarks_tpu_torch.fem.assembly import make_residual

    t28 = time.perf_counter()
    f32 = torch.float32
    KW = K["tri_box"]

    def pair(g, F, scale=1.0):
        return tuple(torch.tensor(scale * rng.standard_normal((F,) + s),
                                  dtype=f32, device=dev)
                     for s in (g.vshape, g.mshape))

    def state(pb, g):
        v, m = g.interpolate(pb.ic_fns)
        return tuple(torch.tensor(a, dtype=f32, device=dev) + n
                     for a, n in zip((v, m), pair(g, pb.n_fields, 0.01)))

    for name, ne, sizes in TRI_BOX_CASES:
        for size in sizes:
            ny, nx = (size, size) if isinstance(size, int) else size
            pb = {"bench1": lambda: bench1.make(nx=nx, ny=ny),
                  "bench2": lambda: bench2.make(nx=nx, ny=ny, num_eta=ne),
                  "bench3": lambda: bench3.make(nx=nx, ny=ny)}[name]()
            g, F = pb.grid, pb.n_fields
            assert g.rule_name == "ffc3" and pb.outer_jvp_form == "box"
            dt = {"bench1": 0.5, "bench2": 0.16, "bench3": 1.28}[name]
            jv = pb.kernel_jvp(g, dev, form="box")
            gather = jv.gather
            w, v, b = state(pb, g), pair(g, F), pair(g, F)
            lab = (f"{name}{f' NE={ne}' if ne else ''}"
                   f"{' coupled' if name == 'bench2' else ''} ffc3 "
                   f"{g.ny}x{g.nx}")
            main = name == "bench2" and ne == 4 and size == 100
            first = size == sizes[0] and (ne in (None, 4))
            work = {"bench1": lambda: jvp_work(g, F),
                    "bench2": lambda: jvp_work(
                        g, F, ns=1 + ne, ops=chac_tangent_ops(ne, False)),
                    "bench3": lambda: jvp_work(g, F, ns=2,
                                               ops=TANGENT_OPS["ach"])}[name]()
            got = jv.kernel(w, w, dt, v)
            got_b = jv.kernel(w, w, dt, v, b=b)
            again = jv.kernel(w, w, dt, v) + jv.kernel(w, w, dt, v, b=b)
            ref_g = gather.kernel(w, w, dt, v) + gather.kernel(w, w, dt, v, b=b)
            library = library_ms = None
            if first:
                res = make_residual(g, pb.terms, F, device=dev, dtype=f32)
                library = (lambda res=res, w=w, v=v, dt=dt: torch.func.jvp(
                    lambda u: res(u, w, dt), (w,), (v,))[1])
                library_ms = cuda_ms(library, reps=10)
            per = interleaved_ms({"W": lambda: jv.kernel(w, w, dt, v),
                                  "gather": lambda: gather.kernel(w, w, dt, v)})
            timing = (per["W"], cuda_ms(lambda: jv.plain(w, w, dt, v), reps=10))
            t10 = (pb.kernel_jvp(g, dev, form="recompute")
                   if ne in (None, 4) and isinstance(size, int) else None)
            fns = {"W": lambda: jv.kernel(w, w, dt, v),
                   "gather": lambda: gather.kernel(w, w, dt, v)}
            if t10 is not None:
                fns["T10"] = lambda: t10.kernel(w, w, dt, v)
            rounds = [{k: device_ms(fn) for k, fn in fns.items()}
                      for _ in range(2)]
            dev_us = {k: statistics.mean(r[k] for r in rounds) * 1e3
                      for k in fns}
            KW.check(f"{lab} Jv", got, jv.plain(w, w, dt, v), TOL_F32, timing,
                     work, library_ms=library_ms, dev_ms=dev_us["W"] * 1e-3,
                     main=main)
            KW.check(f"{lab} b-Jv", got_b, jv.plain(w, w, dt, v, b=b), TOL_F32)
            if library is not None:
                KW.check(f"{lab} Jv vs torch.func.jvp", got, library(), TOL_F32)
            rerun = all(torch.equal(x, y) for x, y in zip(got + got_b, again))
            diff = max(float((x - y).abs().max())
                       for x, y in zip(got + got_b, ref_g))
            bits = all(torch.equal(x, y) for x, y in zip(got + got_b, ref_g))
            info = jv.plan.info()
            gkey, gname = TRI_BOX_GATHER[name]
            print(f"phase 28: kernel W {lab}: vs {gname} (J.v and b - J.v) "
                  f"{'bit-identical' if bits else f'DIFFERS by {diff:.3e}'}, "
                  f"rerun {'bit-identical' if rerun else 'DIFFERS'}; device "
                  f"us W {dev_us['W']:.2f}, {gname} {dev_us['gather']:.2f}"
                  + (f", T10 {dev_us['T10']:.2f}" if "T10" in dev_us else "")
                  + f" (rounds {[{k: round(x * 1e3, 2) for k, x in r.items()} for r in rounds]})"
                  f"; per call W {per['W'] * 1e3:.1f} us, {gname} "
                  f"{per['gather'] * 1e3:.1f} us, plain {timing[1] * 1e3:.1f}"
                  f" us"
                  + (f", library {library_ms * 1e3:.1f} us" if library_ms
                     else "")
                  + f"; bound {bound(work)[0] * 1e3:.3f} us "
                  f"({bound(work)[1]}); boxes {jv.plan.boxes} of "
                  f"{jv.plan.box}; {info['registers']} registers, "
                  f"{info['local_bytes']} local bytes, {info['dynamic_smem']} "
                  f"shared bytes, {info['ctas_per_sm']} CTAs per SM",
                  flush=True)
            if not rerun:
                raise AssertionError(f"W {lab}: a rerun changed the bits")
            if not bits:
                raise AssertionError(f"W {lab}: differs from {gname} by {diff:.3e}")
            if first:
                gk = K[gkey]
                if name != "bench3":   # G's is set at its main shape in phase 9
                    gk.device_ms = dev_us["gather"] * 1e-3
                print(f"phase 28: {gname} ({gk.name}) {lab}: device "
                      f"{dev_us['gather']:.2f} us (first profile "
                      f"{GATHER_DEVICE_US_BEFORE[gk.name]} us)", flush=True)
    torch.cuda.synchronize()
    print(f"phase 28: kernel W agrees with its plain version and equals A, F "
          f"and G to the bit ({time.perf_counter() - t28:.1f} s)", flush=True)


# phase 29: the residual box against kernel R at the cp line search's shapes
# (bench2 100^2 with 4, 2 and 1 order parameters, bench6 100^2 with its
# Dirichlet rows) and ragged ones; name, order parameters, (ny, nx), dt
RESIDUAL_BOX_CASES = (("bench2", 4, (100, 100), 0.16),
                      ("bench2", 2, (100, 100), 0.16),
                      ("bench2", 1, (100, 100), 0.16),
                      ("bench6", None, (100, 100), 0.32),
                      ("bench2", 4, (37, 23), 0.16),
                      ("bench6", None, (37, 23), 0.32))


def residual_box_phase(dev, K):
    """Phase 29: the residual box (``residual_box``, kernel R's residual over
    triangle boxes, each point residual once) at every shape of
    ``RESIDUAL_BOX_CASES``: against its plain version (TOL_R, kernel R's),
    against kernel R (``res.gather``) with ``torch.equal`` and against itself
    on a rerun (both required); device us per launch of the box and R in
    two rounds in turns (launches queued behind a sleep kernel); per-call us
    of the box and R in turns and of the plain version; the bound
    (``residual_work``, R's count), boxes, registers, spills, shared bytes
    and CTAs per SM. The states are the IC plus seeded noise (w, with the
    Dirichlet values on their rows) against the IC (w0). Sets the residual
    box's record in the kernel line at bench2 100^2 with 4 order
    parameters, its main shape."""
    from pfhubbenchmarks_tpu_torch.benchmarks import bench2, bench6

    t29 = time.perf_counter()
    KB = K["residual_box"]
    rng = np.random.default_rng(20261018)
    for name, ne, (ny, nx), dt in RESIDUAL_BOX_CASES:
        pb = (bench2.make(nx=nx, ny=ny, num_eta=ne) if name == "bench2"
              else bench6.make(nx=nx, ny=ny))
        g, F = pb.grid, pb.n_fields
        assert g.rule_name == "ffc3" and pb.residual_form == "box"
        res = pb.kernel_residual(g, dev, pb.dirichlet, form="box")
        w0 = tuple(t.float().contiguous() for t in pb.initial_state(dev))
        v = (w0[0] + torch.tensor(0.02 * rng.standard_normal(w0[0].shape),
                                  dtype=torch.float32, device=dev),
             w0[1] + torch.tensor(0.02 * rng.standard_normal(w0[1].shape),
                                  dtype=torch.float32, device=dev))
        for bc in pb.dirichlet:
            v = (bc.apply_value(v[0]).contiguous(), v[1])
        w = v
        lab = (f"{name}{f' NE={ne}' if ne else ''} ffc3 {ny}x{nx}"
               f"{' Dirichlet' if pb.dirichlet else ''}")
        main = name == "bench2" and ne == 4 and nx == 100
        ops = RESIDUAL_OPS[ne] if ne else RESIDUAL_OPS["chp"]
        work = residual_work(g, F, ops, 1 + ne if ne else 1,
                             masked=bool(pb.dirichlet))
        got = res.kernel(w, w0, dt)
        again = res.kernel(w, w0, dt)
        ref = res.gather.kernel(w, w0, dt)
        per = interleaved_ms({"box": lambda: res.kernel(w, w0, dt),
                              "R": lambda: res.gather.kernel(w, w0, dt)})
        timing = (per["box"], cuda_ms(lambda: res.plain(w, w0, dt), reps=10))
        fns = {"box": lambda: res.kernel(w, w0, dt),
               "R": lambda: res.gather.kernel(w, w0, dt)}
        rounds = [{k: device_ms(fn) for k, fn in fns.items()} for _ in range(2)]
        dev_us = {k: statistics.mean(r[k] for r in rounds) * 1e3 for k in fns}
        KB.check(lab, got, res.plain(w, w0, dt), TOL_R, timing, work,
                 dev_ms=dev_us["box"] * 1e-3, main=main)
        rerun = all(torch.equal(x, y) for x, y in zip(got, again))
        bits = all(torch.equal(x, y) for x, y in zip(got, ref))
        diff = max(float((x - y).abs().max()) for x, y in zip(got, ref))
        info = res.plan.info()
        print(f"phase 29: residual box {lab}: vs R "
              f"{'bit-identical' if bits else f'DIFFERS by {diff:.3e}'}, rerun "
              f"{'bit-identical' if rerun else 'DIFFERS'}; device us box "
              f"{dev_us['box']:.2f}, R {dev_us['R']:.2f} (rounds "
              f"{[{k: round(x * 1e3, 2) for k, x in r.items()} for r in rounds]}"
              f"); per call box {per['box'] * 1e3:.1f} us, R "
              f"{per['R'] * 1e3:.1f} us, plain {timing[1] * 1e3:.1f} us; bound "
              f"{bound(work)[0] * 1e3:.3f} us ({bound(work)[1]}); boxes "
              f"{res.plan.boxes} of {res.plan.box}; {info['registers']} "
              f"registers, {info['local_bytes']} local bytes, "
              f"{info['dynamic_smem']} shared bytes, {info['ctas_per_sm']} "
              f"CTAs per SM", flush=True)
        if not rerun:
            raise AssertionError(f"residual box {lab}: a rerun changed the bits")
        if not bits:
            raise AssertionError(f"residual box {lab}: differs from R by "
                                 f"{diff:.3e}")
    torch.cuda.synchronize()
    print(f"phase 29: the residual box agrees with its plain version and "
          f"equals R to the bit ({time.perf_counter() - t29:.1f} s)",
          flush=True)


def chain_phase(dev, K, rng):
    """Phase 23: the chain kernels (``vcycle_descend_chain``,
    ``vcycle_ascend_chain``: a V-cycle's descent and ascent over every level
    in one launch each) at every main-path hierarchy: bench1 100/50/25,
    bench6 with its Dirichlet masks, bench2 with the field groups (F = 6),
    bench3 350/175/35/7 (ratios 2, 5, 5), with each benchmark's sweep
    counts, on the IC plus seeded noise injected down and the levels' block
    planes. Each chain kernel against its launch sequence (``.sequence``:
    per level L, D or H and the level J.v; the max abs difference printed,
    the target 0), its plain version (TOL_F32) and itself on a rerun (to the
    bit); the device time per call (40 calls behind a sleep kernel) of the
    kernel and of the sequence in the same call; per-call times of kernel,
    sequence (in turns) and plain version; the bound (``chain_work``); the
    grid, registers, spills and CTAs per SM of the instantiation."""
    from pfhubbenchmarks_tpu_torch.benchmarks import (bench1, bench2, bench3,
                                                      bench6)
    from pfhubbenchmarks_tpu_torch.fem.assembly import bc_mask
    from pfhubbenchmarks_tpu_torch.ops import transfer as kt
    from pfhubbenchmarks_tpu_torch.ops.vcycle_chain import (make_ascend_chain,
                                                            make_descend_chain)

    t23 = time.perf_counter()
    f32 = torch.float32

    def pair(g, F):
        return tuple(torch.tensor(rng.standard_normal((F,) + s), dtype=f32,
                                  device=dev) for s in (g.vshape, g.mshape))

    def flat(out):
        if isinstance(out, tuple) and len(out) == 3:   # (xs, bs, bc)
            out = out[0] + out[1] + [out[2]]
        else:
            out = [out]
        return [t.clone() for p in out for t in p]

    for name, pb, dt, split, jv_kw in (
            ("bench1", bench1.make(), 0.5, False, {}),
            ("bench6", bench6.make(), 0.32, False, {}),
            ("bench2", bench2.make(), 0.16, True,
             dict(ns=5, ops=TANGENT_OPS[(6, "split")])),
            ("bench3", bench3.make(), 1.28, False,
             dict(ns=2, ops=TANGENT_OPS["ach"]))):
        s, F = pb.solver, pb.n_fields
        grids = pb.precond_builder(dev).grids
        nc = len(grids) - 1
        groups = pb.field_groups if split else None
        v, m = grids[0].interpolate(pb.ic_fns)
        w = tuple(torch.tensor(a, dtype=f32, device=dev) + torch.tensor(
            0.01 * rng.standard_normal((F,) + a.shape[1:]), dtype=f32,
            device=dev) for a in (v, m))
        for bc in pb.dirichlet_for(grids[0]):
            w = (bc.apply_value(w[0]).contiguous(), w[1])
        ws, pinvs, jvs, masks = [], [], [], []
        for l, g in enumerate(grids):
            bcs = pb.dirichlet_for(g)
            jvs.append(pb.kernel_jvp(g, dev, bcs, split=split))
            mk = bc_mask(g, bcs, F)
            masks.append(None if mk is None else torch.as_tensor(mk, device=dev))
            if l < nc:
                ws.append(w)
                pinvs.append(node_plan(pb, g, dev, split).kernel(w, w, dt))
                w = kt.inject(w, grids[l + 1], g)
        masked = any(mk is not None for mk in masks)
        sizes = "/".join(str(g.nx) for g in grids)
        nud = dict(nu=s.gmg_nu_pre, nu_fine=s.gmg_nu_fine_pre or s.gmg_nu_pre)
        nua = dict(nu=s.gmg_nu_post,
                   nu_fine=s.gmg_nu_fine_post or s.gmg_nu_post)
        desc = make_descend_chain(grids, jvs, masks=masks, field_groups=groups,
                                  **nud)
        asc = make_ascend_chain(grids, jvs, masks=masks, field_groups=groups,
                                **nua)
        assert desc.one_launch and asc.one_launch
        b0, xc = pair(grids[0], F), pair(grids[-1], F)
        dargs = (b0, ws, ws, dt, pinvs)
        xs_s, bs_s, _ = desc.sequence(*dargs)
        aargs = ([b0] + bs_s, xs_s, xc, ws, ws, dt, pinvs)
        for chain, args, nus, up in ((desc, dargs, nud, False),
                                     (asc, aargs, nua, True)):
            rec = K[chain.plan.kernel_name]
            got, again = flat(chain.kernel(*args)), flat(chain.kernel(*args))
            seq, ref = flat(chain.sequence(*args)), flat(chain.plain(*args))
            if any(not torch.equal(a, c) for a, c in zip(got, again)):
                raise AssertionError(f"{rec.name} {name}: a rerun changed the "
                                     "bits")
            d_seq = max(float((a - c).abs().max()) for a, c in zip(got, seq))
            k_dev = device_ms(lambda: chain.kernel(*args))
            s_dev = device_ms(lambda: chain.sequence(*args))
            per_call = interleaved_ms({"kernel": lambda: chain.kernel(*args),
                                       "sequence": lambda: chain.sequence(*args)})
            p_ms = once_ms(lambda: chain.plain(*args))
            work = chain_work(grids, F, nus["nu"], nus["nu_fine"], ascend=up,
                              jv_kw=jv_kw, groups=groups, masked=masked)
            b_ms, b_by = bound(work)
            info = chain.plan.info()
            print(f"phase 23: {rec.name} {name} {sizes}"
                  f"{' masked' if masked else ''}{' groups' if groups else ''}"
                  f" nu={nus['nu_fine']}/{nus['nu']}: grid {chain.plan.grid} "
                  f"CTAs ({info['ctas_per_sm']} per SM), {info['registers']} "
                  f"registers, {info['local_bytes']} local bytes, "
                  f"{info['static_smem']} static shared bytes; device "
                  f"{k_dev * 1e3:.2f} us per call vs the sequence's "
                  f"{s_dev * 1e3:.2f} (the sum of its level steps); per call "
                  f"kernel / plain / sequence {per_call['kernel'] * 1e3:.1f} / "
                  f"{p_ms * 1e3:.1f} / {per_call['sequence'] * 1e3:.1f} us; "
                  f"bound {b_ms * 1e3:.3f} us ({b_by}); vs the sequence max "
                  f"abs diff {d_seq:.3e}"
                  f"{' (bit-identical)' if d_seq == 0.0 else ''}; rerun "
                  f"bit-identical", flush=True)
            rec.check(f"{name} {sizes}", got, ref, TOL_F32,
                      (per_call["kernel"], p_ms), work, dev_ms=k_dev,
                      main=name == "bench1")
            rec.check(f"{name} {sizes} vs the sequence", got, seq, TOL_F32)
    torch.cuda.synchronize()
    print(f"phase 23: the chain kernels agree with their plain versions at "
          f"every main-path hierarchy ({time.perf_counter() - t23:.1f} s)",
          flush=True)


# phase 30: kernel V's hierarchies: (benchmark, order parameters, fine
# (ny, nx) or None for the benchmark's own); 74 x 46 / 37 x 23 is a ragged
# pair of bench1's physics
VCYCLE_CASES = (("bench1", None, None), ("bench2", 4, None),
                ("bench2", 2, None), ("bench2", 1, None),
                ("bench1", None, (46, 74)))


def vcycle_work(grids, F, s, jv_kw, mv_kw, groups, mv_grid):
    """(bytes, flops) of one V apply: the right-hand side, every level's
    state and in-group block planes in once, z and A z out once; the flops
    of the descent's and the ascent's sweeps, transfers and residuals, the
    coarsest sweeps and the exported J.v."""
    K = len(grids) - 1
    ns = jv_kw.get("ns", 1)
    byts = 4 * 3 * F * nodes(grids[0])
    for g in grids:
        byts += 4 * ns * nodes(g) + bj_work(g, F, groups)[0] - 4 * 2 * F * nodes(g)
    flops = sum(chain_work(grids, F, nu, nu_fine, ascend=up, jv_kw=jv_kw,
                           groups=groups, masked=False)[1]
                for nu, nu_fine, up in (
                    (s.gmg_nu_pre, s.gmg_nu_fine_pre or s.gmg_nu_pre, False),
                    (s.gmg_nu_post, s.gmg_nu_fine_post or s.gmg_nu_post,
                     True)))
    flops += sweep_work(grids[K], F, s.gmg_coarse_sweeps, jv_kw, groups)[1]
    flops += jvp_work(mv_grid, F, **mv_kw)[1]
    return byts, flops


def vcycle_phase(dev, K, rng):
    """Phase 30: kernel V (``vcycle_fused``: TPU row 5, the apply and its
    exported A z in one launch) at the hierarchies of ``VCYCLE_CASES``, the
    plan and the exported J.v of each benchmark's own multigrid build, with
    its sweep counts, on the IC plus seeded noise injected down and kernel
    N's planes of every level. Each case: z and A z against the split apply
    (``.sequence``: the descend chain, L on the coarsest level, the ascend
    chain and W) with ``torch.equal``, and against itself on a rerun (both
    required); against the plain version (TOL_F32); device us per apply (40
    behind a sleep kernel) of V as the plan routes it, of V with the
    coarsest level on cluster 0 (of ``vf.CLUSTER`` and of 8 CTAs), on the
    grid and with the two coarsest levels on cluster 0, of the coarsest
    phase alone on cluster 0 (of both sizes) and on the grid, and of the
    split apply; per-call us of V and the split apply in turns,
    the plain version's; the bound (``vcycle_work``); the cluster size,
    grid, registers, spills and co-resident clusters."""
    from pfhubbenchmarks_tpu_torch.benchmarks import bench1, bench2
    from pfhubbenchmarks_tpu_torch.ops import transfer as kt
    from pfhubbenchmarks_tpu_torch.ops import vcycle_fused as vf

    t30 = time.perf_counter()
    f32 = torch.float32
    rec = K["vcycle_fused"]
    for name, ne, dims in VCYCLE_CASES:
        if name == "bench1":
            pb = bench1.make() if dims is None else bench1.make(
                ny=dims[0], nx=dims[1])
            dt, split, jv_kw, mv_kw = 0.5, False, {}, {}
        else:
            pb = bench2.make(num_eta=ne)
            dt, split = 0.16, True
            jv_kw = dict(ns=1 + ne, ops=chac_tangent_ops(ne, True))
            mv_kw = dict(ns=1 + ne, ops=chac_tangent_ops(ne, False))
        s, F = pb.solver, pb.n_fields
        build = pb.precond_builder(dev)
        vc, grids = build.vcycle, build.grids
        if vc is None:
            raise AssertionError(f"phase 30: {name}'s build does not route "
                                 "its apply to kernel V")
        plan = vc.plan
        groups = pb.field_groups if split else None
        v, m = grids[0].interpolate(pb.ic_fns)
        w = tuple(torch.tensor(a, dtype=f32, device=dev) + torch.tensor(
            0.01 * rng.standard_normal((F,) + a.shape[1:]), dtype=f32,
            device=dev) for a in (v, m))
        ws, pinvs = [], []
        for l, g in enumerate(grids):
            ws.append(w)
            pinvs.append(node_plan(pb, g, dev, split).kernel(w, w, dt))
            if l + 1 < len(grids):
                w = kt.inject(w, grids[l + 1], g)
        b = tuple(torch.tensor(rng.standard_normal((F,) + sh), dtype=f32,
                               device=dev)
                  for sh in (grids[0].vshape, grids[0].mshape))
        args = (b, ws, ws, dt, pinvs)

        def flat(out):
            return [t.clone() for p in out for t in p]

        got, again = flat(vc.kernel(*args)), flat(vc.kernel(*args))
        grid = plan.grid
        seq, seq2 = flat(vc.sequence(*args)), flat(vc.sequence(*args))
        ref = flat(vc.plain(*args))
        if any(not torch.equal(a, c) for a, c in zip(got, again)):
            raise AssertionError(f"V {name}: a rerun changed the bits")
        if any(not torch.equal(a, c) for a, c in zip(got, seq)) or any(
                not torch.equal(a, c) for a, c in zip(seq, seq2)):
            d = max(float((a - c).abs().max()) for a, c in zip(got, seq))
            raise AssertionError(f"V {name}: z and A z are not the split "
                                 f"apply's bits (max abs diff {d:.3e})")
        Kl = plan.K
        z, az = (tuple(torch.empty_like(t) for t in b) for _ in range(2))

        def launch(**kw):
            return lambda: plan.launch(dev, ws, pinvs, dt, b, z, az, **kw)

        coarse, C = vf.PHASES["coarse"], vf.CLUSTER
        times = {"V": device_ms(lambda: vc.kernel(*args)),
                 "V coarsest on cluster 0": device_ms(launch(
                     cluster_from=Kl, cluster=C)),
                 "V coarsest on a cluster of 8": device_ms(launch(
                     cluster_from=Kl, cluster=8)),
                 "V coarsest on the grid": device_ms(launch(
                     cluster_from=Kl + 1, cluster=1)),
                 "coarsest alone on cluster 0": device_ms(launch(
                     cluster_from=Kl, cluster=C, phases=coarse)),
                 "coarsest alone on a cluster of 8": device_ms(launch(
                     cluster_from=Kl, cluster=8, phases=coarse)),
                 "coarsest alone on the grid": device_ms(launch(
                     cluster_from=Kl + 1, cluster=1, phases=coarse)),
                 "the split apply": device_ms(lambda: vc.sequence(*args))}
        if Kl >= 2:
            times["V two coarsest levels on cluster 0"] = device_ms(launch(
                cluster_from=Kl - 1, cluster=C))
        per_call = interleaved_ms({"V": lambda: vc.kernel(*args),
                                   "split": lambda: vc.sequence(*args)})
        p_ms = once_ms(lambda: vc.plain(*args))
        mv_grid = dataclasses.replace(grids[0], rule_name=pb.grid.rule_name)
        work = vcycle_work(grids, F, s, jv_kw, mv_kw, groups, mv_grid)
        b_ms, b_by = bound(work)
        info = plan.info()
        label = (f"{name}{f' NE={ne}' if ne else ''} "
                 f"{'/'.join(f'{g.ny}x{g.nx}' for g in grids)}")
        scope = "cluster 0" if plan.cluster_from == Kl else "the grid"
        print(f"phase 30: V {label}: cluster {plan.cluster} CTAs, grid {grid} "
              f"CTAs ({info['clusters']} co-resident clusters, "
              f"{info['ctas_per_sm']} CTAs per SM), {info['registers']} "
              f"registers, {info['local_bytes']} local bytes, "
              f"{info['static_smem']} static shared bytes; the coarsest level "
              f"({plan.coarse_ctas} CTAs of work) on {scope} by the plan's "
              f"rule; device us per apply: "
              + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in times.items())
              + f"; per call V / split / plain {per_call['V'] * 1e3:.1f} / "
              f"{per_call['split'] * 1e3:.1f} / {p_ms * 1e3:.1f} us; bound "
              f"{b_ms * 1e3:.3f} us ({b_by}); z and A z equal the split "
              f"apply's (torch.equal), rerun bit-identical", flush=True)
        rec.check(label, got, ref, TOL_F32, (per_call["V"], p_ms), work,
                  dev_ms=times["V"], main=(name == "bench1" and dims is None))
    torch.cuda.synchronize()
    print(f"phase 30: kernel V equals the split apply at every hierarchy "
          f"({time.perf_counter() - t30:.1f} s)", flush=True)


# phase 31: the anisotropic bench3's gate, the JAX package's CPU run at
# 350^2 (tools/jax_bench3_aniso_rows.py): its rows (.csv) and each row's
# Newton and Krylov counts (.json)
ANISO_ROWS = os.path.join("tests", "data", "bench3_aniso_jax_rows")


def aniso_phase(dev, K, rng, paths):
    """Phase 31: the anisotropic bench3 (``bench3.make(anisotropy=True)``,
    the physics "acha", csrc/phys_acha.cuh). (a) At 350^2 ffc3 kernel W
    (``tri_box_acha``) against its plain version (TOL_F32), against the
    gather form (``acha_jvp``) with ``torch.equal`` and against itself on a
    rerun (both required), and against ``torch.func.jvp`` of the f64
    residual (the f32 one's distance to it printed), J.v and b - J.v; device us of W and the gather in turns,
    per-call us of W / gather / plain / ``torch.func.jvp``, the bound,
    registers and CTAs per SM; the distance to the isotropic W on the same
    inputs. At each dunavant2 level of 350/175/35/7 the gather against its
    plain version, and kernel N's "ach" instantiation (the plan of the
    anisotropic physics) against its plain version and, to the bit, the
    isotropic problem's plan. The level steps (a chain of one level, TPU
    rows 6 and 9) at each pair and the two chains over the hierarchy (rows
    7 and 8) with bench3's sweep counts: against their plain versions
    (TOL_F32), their launch sequences (kernel L, D or H and the gather;
    ``torch.equal`` printed) and a rerun (to the bit, required); device us
    of kernel and sequence, per-call us of kernel / sequence / plain, the
    bound, grid, registers and CTAs per SM. (b) The anisotropic run at
    350^2 through ``Runner.run`` over the rows of ``ANISO_ROWS``: the time
    column equal, TFE rel 1e-6, solid fraction rel 1e-5 and each row's
    Newton count equal to the JAX run's; the Krylov counts printed beside
    the JAX run's, not held. W, both chains and N must launch, and the
    gather, the isotropic kernels and L must not."""
    from pfhubbenchmarks_tpu_torch import timeloop
    from pfhubbenchmarks_tpu_torch.benchmarks import bench3
    from pfhubbenchmarks_tpu_torch.fem.assembly import make_residual
    from pfhubbenchmarks_tpu_torch.ops import _lib
    from pfhubbenchmarks_tpu_torch.ops import transfer as kt
    from pfhubbenchmarks_tpu_torch.ops.vcycle_chain import (
        make_ascend_chain, make_ascend_level, make_descend_chain,
        make_descend_level)
    from pfhubbenchmarks_tpu_torch.solve.gmg import build_hierarchy

    t31 = time.perf_counter()
    f32 = torch.float32
    label = "phase 31: bench3 anisotropic"
    pb, iso = bench3.make(anisotropy=True), bench3.make()
    F, s, dt = pb.n_fields, pb.solver, 1.28
    jv_kw = dict(ns=2, ops=TANGENT_OPS["acha"], tri_ops=ACHA_TRI_OPS)

    def pair(g, scale=1.0):
        return tuple(torch.tensor(scale * rng.standard_normal((F,) + sh),
                                  dtype=f32, device=dev)
                     for sh in (g.vshape, g.mshape))

    def state(g):
        v0, m0 = g.interpolate(pb.ic_fns)
        return tuple((torch.tensor(a, dtype=f32, device=dev) + n).contiguous()
                     for a, n in zip((v0, m0), pair(g, 0.01)))

    def flat(out):
        if isinstance(out, tuple) and len(out) == 3:   # (xs, bs, bc)
            out = out[0] + out[1] + [out[2]]
        elif isinstance(out, tuple) and len(out) == 2 and isinstance(
                out[0], tuple):                          # (x, bc)
            out = list(out)
        else:
            out = [out]
        return [t.clone() for p in out for t in p]

    # (a) W and the gather at 350^2 ffc3, the outer J.v
    g = pb.grid
    w, v, b = state(g), pair(g), pair(g)
    jv = pb.kernel_jvp(g, dev, form="box")
    gather = jv.gather
    res = make_residual(g, pb.terms, F, device=dev, dtype=f32)
    res64 = make_residual(g, pb.terms, F, device=dev, dtype=torch.float64)
    w64, v64 = (tuple(t.double() for t in p) for p in (w, v))

    def library():
        return torch.func.jvp(lambda u: res(u, w, dt), (w,), (v,))[1]

    # the reference: torch.func.jvp of the f64 residual. The f32 one forms
    # grad phi as a sum of slot values near -1 and the rotation flux reads
    # it through 1/|grad phi|, so it lies over 100x farther from the f64 J.v
    # than the kernels, which form grad phi from differences (state_grad)
    ref64 = tuple(t.float() for t in torch.func.jvp(
        lambda u: res64(u, w64, dt), (w64,), (v64,))[1])

    got = jv.kernel(w, w, dt, v) + jv.kernel(w, w, dt, v, b=b)
    again = jv.kernel(w, w, dt, v) + jv.kernel(w, w, dt, v, b=b)
    ref_g = gather.kernel(w, w, dt, v) + gather.kernel(w, w, dt, v, b=b)
    fns = {"W": lambda: jv.kernel(w, w, dt, v),
           "gather": lambda: gather.kernel(w, w, dt, v)}
    per = interleaved_ms(fns)
    p_ms = cuda_ms(lambda: jv.plain(w, w, dt, v), reps=10)
    lib_ms = cuda_ms(library, reps=10)
    rounds = [{k: device_ms(fn) for k, fn in fns.items()} for _ in range(2)]
    dev_us = {k: statistics.mean(r[k] for r in rounds) * 1e3 for k in fns}
    work = jvp_work(g, F, **jv_kw)
    lab = "350x350 ffc3"
    K["tri_box_acha"].check(f"{lab} Jv", got[:2], jv.plain(w, w, dt, v),
                            TOL_F32, (per["W"], p_ms), work,
                            library_ms=lib_ms, dev_ms=dev_us["W"] * 1e-3)
    K["tri_box_acha"].check(f"{lab} b-Jv", got[2:],
                            jv.plain(w, w, dt, v, b=b), TOL_F32)
    K["tri_box_acha"].check(f"{lab} Jv vs torch.func.jvp of the f64 residual",
                            got[:2], ref64, TOL_F32)
    d_lib = max(float((x - y).abs().max()) for x, y in zip(library(), ref64))
    d_w = max(float((x - y).abs().max()) for x, y in zip(got[:2], ref64))
    K["acha_jvp"].check(f"{lab} Jv", ref_g[:2], jv.plain(w, w, dt, v), TOL_F32,
                        (per["gather"], p_ms), work, library_ms=lib_ms,
                        dev_ms=dev_us["gather"] * 1e-3)
    K["acha_jvp"].check(f"{lab} b-Jv", ref_g[2:], jv.plain(w, w, dt, v, b=b),
                        TOL_F32)
    bits = all(torch.equal(x, y) for x, y in zip(got, ref_g))
    rerun = all(torch.equal(x, y) for x, y in zip(got, again))
    iso_w = iso.kernel_jvp(g, dev, form="box").kernel(w, w, dt, v)
    scale = max(float(t.abs().max()) for t in got[:2])
    d_iso = max(float((x - y).abs().max()) for x, y in zip(got[:2], iso_w))
    info_w = jv.plan.info()
    info_g = _lib.library().kernel_info("pfh_acha_jvp_info", 4)
    b_ms, b_by = bound(work)
    print(f"{label}: kernel W {lab}: vs the gather (J.v and b - J.v) "
          f"{'bit-identical' if bits else 'DIFFERS'}, rerun "
          f"{'bit-identical' if rerun else 'DIFFERS'}; device us W "
          f"{dev_us['W']:.2f}, gather {dev_us['gather']:.2f} (rounds "
          f"{[{k: round(x * 1e3, 2) for k, x in r.items()} for r in rounds]})"
          f"; per call W / gather / plain / torch.func.jvp "
          f"{per['W'] * 1e3:.1f} / {per['gather'] * 1e3:.1f} / "
          f"{p_ms * 1e3:.1f} / {lib_ms * 1e3:.1f} us; bound "
          f"{b_ms * 1e3:.3f} us ({b_by}); W {info_w['registers']} registers, "
          f"{info_w['local_bytes']} local bytes, {info_w['ctas_per_sm']} CTAs "
          f"per SM; the gather {info_g['registers']} registers, "
          f"{info_g['local_bytes']} local bytes, {info_g['ctas_per_sm']} CTAs "
          f"per SM; the isotropic W lies {d_iso:.3e} away ({d_iso / scale:.3e} "
          f"of max|Jv|); from torch.func.jvp of the f64 residual W lies "
          f"{d_w:.3e}, torch.func.jvp of the f32 residual {d_lib:.3e}",
          flush=True)
    if not (bits and rerun):
        raise AssertionError(f"{label}: W differs from the gather or from "
                             "itself on a rerun")

    # the gather and kernel N at every dunavant2 level
    grids = [dataclasses.replace(gg, rule_name=s.precond_rule)
             for gg in build_hierarchy(pb.grid, min_cells=s.gmg_min_cells)]
    assert [gg.nx for gg in grids] == [350, 175, 35, 7]
    ws, pinvs, jvs = [], [], []
    wl = state(grids[0])
    for l, gl in enumerate(grids):
        jvl = pb.kernel_jvp(gl, dev)
        jvs.append(jvl)
        vl, bl = pair(gl), pair(gl)
        labl = f"dunavant2 {gl.ny}x{gl.nx}"
        K["acha_jvp"].check(f"{labl} Jv", jvl.kernel(wl, wl, dt, vl),
                            jvl.plain(wl, wl, dt, vl), TOL_F32)
        K["acha_jvp"].check(f"{labl} b-Jv", jvl.kernel(wl, wl, dt, vl, b=bl),
                            jvl.plain(wl, wl, dt, vl, b=bl), TOL_F32)
        plan = node_plan(pb, gl, dev)
        if plan._symbol != "pfh_node_blocks_ach":
            raise AssertionError(f"{label}: kernel N's plan is {plan._symbol}")
        pn = plan.kernel(wl, wl, dt)
        K["node_blocks"].check(f"bench3 anisotropic {labl}", pn,
                               plan.plain(wl, wl, dt), TOL_F32)
        same = all(torch.equal(x, y) for x, y in
                   zip(pn, node_plan(iso, gl, dev).kernel(wl, wl, dt)))
        print(f"{label}: kernel N {labl}: the anisotropic plan launches "
              f"{plan._symbol}, its planes "
              f"{'bit-identical to' if same else 'DIFFER from'} the isotropic "
              f"plan's", flush=True)
        if not same:
            raise AssertionError(f"{label}: kernel N's planes differ")
        ws.append(wl)
        pinvs.append(pn)
        if l + 1 < len(grids):
            wl = kt.inject(wl, grids[l + 1], gl)
    # the anisotropic run's build in one launch (its "ach" kernel)
    node_build_phase(31, "bench3 anisotropic", K, pb, dt, dev,
                     lambda _pb, gg: state(gg), ns=2, ops=TANGENT_OPS["ach"])

    # the level steps at each pair, then the chains over the hierarchy
    nud = dict(nu=s.gmg_nu_pre, nu_fine=s.gmg_nu_fine_pre or s.gmg_nu_pre)
    nua = dict(nu=s.gmg_nu_post, nu_fine=s.gmg_nu_fine_post or s.gmg_nu_post)
    nc = len(grids) - 1
    for l in range(nc):
        fine, coarse = grids[l], grids[l + 1]
        nu_d = nud["nu_fine"] if l == 0 else nud["nu"]
        nu_a = nua["nu_fine"] if l == 0 else nua["nu"]
        d = make_descend_level(fine, coarse, jvs[l], nu=nu_d)
        a = make_ascend_level(fine, coarse, jvs[l], nu=nu_a)
        bb, xc = pair(fine), pair(coarse)
        dargs = (bb, ws[l], ws[l], dt, pinvs[l])
        xp, _ = d.plain(*dargs)
        aargs = (bb, xp, xc, ws[l], ws[l], dt, pinvs[l])
        for step, args, nu, up in ((d, dargs, nu_d, False),
                                   (a, aargs, nu_a, True)):
            rec = K[step.plan.kernel_name]
            kout, kagain = flat(step.kernel(*args)), flat(step.kernel(*args))
            seq = flat(step.sequence(*args))
            rec.check(f"level step {fine.nx}{'<-' if up else '->'}"
                      f"{coarse.nx} nu={nu}", kout, flat(step.plain(*args)),
                      TOL_F32)
            same = all(torch.equal(x, y) for x, y in zip(kout, seq))
            again_ok = all(torch.equal(x, y) for x, y in zip(kout, kagain))
            print(f"{label}: level step {fine.nx}{'<-' if up else '->'}"
                  f"{coarse.nx} nu={nu}: vs its sequence "
                  f"{'bit-identical' if same else 'DIFFERS'}, rerun "
                  f"{'bit-identical' if again_ok else 'DIFFERS'}", flush=True)
            if not again_ok:
                raise AssertionError(f"{label}: a level step's rerun differs")
    desc = make_descend_chain(grids, jvs, **nud)
    asc = make_ascend_chain(grids, jvs, **nua)
    b0, xc = pair(grids[0]), pair(grids[-1])
    dargs = (b0, ws[:nc], ws[:nc], dt, pinvs[:nc])
    xs_s, bs_s, _ = desc.sequence(*dargs)
    aargs = ([b0] + bs_s, xs_s, xc, ws[:nc], ws[:nc], dt, pinvs[:nc])
    for chain, args, nus, up in ((desc, dargs, nud, False),
                                 (asc, aargs, nua, True)):
        rec = K[chain.plan.kernel_name]
        kout, kagain = flat(chain.kernel(*args)), flat(chain.kernel(*args))
        seq, ref = flat(chain.sequence(*args)), flat(chain.plain(*args))
        if any(not torch.equal(x, y) for x, y in zip(kout, kagain)):
            raise AssertionError(f"{rec.name}: a rerun changed the bits")
        d_seq = max(float((x - y).abs().max()) for x, y in zip(kout, seq))
        k_dev = device_ms(lambda: chain.kernel(*args))
        s_dev = device_ms(lambda: chain.sequence(*args))
        per_c = interleaved_ms({"kernel": lambda: chain.kernel(*args),
                                "sequence": lambda: chain.sequence(*args)})
        pc_ms = once_ms(lambda: chain.plain(*args))
        cwork = chain_work(grids, F, nus["nu"], nus["nu_fine"], ascend=up,
                           jv_kw=jv_kw, masked=False)
        cb_ms, cb_by = bound(cwork)
        info = chain.plan.info()
        print(f"{label}: {rec.name} 350/175/35/7 nu={nus['nu_fine']}/"
              f"{nus['nu']}: grid {chain.plan.grid} CTAs "
              f"({info['ctas_per_sm']} per SM), {info['registers']} registers, "
              f"{info['local_bytes']} local bytes; device {k_dev * 1e3:.2f} us "
              f"vs the sequence's {s_dev * 1e3:.2f}; per call kernel / plain / "
              f"sequence {per_c['kernel'] * 1e3:.1f} / {pc_ms * 1e3:.1f} / "
              f"{per_c['sequence'] * 1e3:.1f} us; bound {cb_ms * 1e3:.3f} us "
              f"({cb_by}); vs the sequence max abs diff {d_seq:.3e}"
              f"{' (bit-identical)' if d_seq == 0.0 else ''}; rerun "
              f"bit-identical", flush=True)
        rec.check("bench3 anisotropic 350/175/35/7", kout, ref, TOL_F32,
                  (per_c["kernel"], pc_ms), cwork, dev_ms=k_dev, main=True)
        rec.check("bench3 anisotropic 350/175/35/7 vs the sequence", kout, seq,
                  TOL_F32)
    torch.cuda.synchronize()
    print(f"{label}: kernels W, the gather, N and the chains agree with "
          f"their plain versions ({time.perf_counter() - t31:.1f} s)",
          flush=True)

    # (b) the anisotropic run at 350^2 against the JAX package's rows
    with open(os.path.join(HERE, ANISO_ROWS + ".json")) as f:
        gate = json.load(f)
    n_rows = len(gate["newton_iters"])
    runner = timeloop.Runner(pb, dev)
    build = runner.problem.precond_builder(dev)
    if not build.dense_coarse:
        raise AssertionError(f"{label}: the coarsest solve is not the dense "
                             "inverse")
    counts, result, wall, _ = drive(
        label, pb, lambda: runner.run(max_steps=n_rows, verbose=True),
        ("tri_box_acha", "vcycle_descend_chain_acha",
         "vcycle_ascend_chain_acha", "node_build"),
        absent=GATHER_ABSENT + ("acha_jvp", "ach_jvp", "tri_box",
                                "vcycle_descend_chain", "vcycle_ascend_chain",
                                "lmr_sweep"),
        max_calls=MAX_CALLS_PER_APPLY["bench3"])
    paths["bench3_aniso"] = counts
    newton = [st.newton_iters for st in result.stats]
    krylov = [st.krylov_iters for st in result.stats]
    n_same = sum(a == b for a, b in zip(newton, gate["newton_iters"]))
    print(f"{label}: {len(newton)} rows to t={result.rows[-1, 0]:.6g}, wall "
          f"{wall:.3f} s on {smi_line()}; newton per row {newton} against the "
          f"JAX run's {gate['newton_iters']} ({n_same} of {n_rows} equal); "
          f"krylov per row {krylov} (sum {sum(krylov)}) against the JAX run's "
          f"{gate['krylov_iters']} (sum {sum(gate['krylov_iters'])}; not "
          f"held)", flush=True)
    hold_rows(label, result, os.path.basename(ANISO_ROWS) + ".csv", n_rows,
              tfe_tol=1e-6, col2_tol=1e-5,
              ref_dir=os.path.dirname(ANISO_ROWS))
    if newton != gate["newton_iters"]:
        raise AssertionError(f"{label}: Newton counts differ from the JAX "
                             "run's")
    print(f"{label}: the run holds the JAX package's {n_rows} rows and Newton "
          f"counts ({time.perf_counter() - t31:.1f} s for the phase)",
          flush=True)


def main() -> None:
    t_start = time.perf_counter()
    # ---- phase 1: the card --------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    from pfhubbenchmarks_tpu_torch import config, timeloop
    from pfhubbenchmarks_tpu_torch.benchmarks import bench1, bench2, bench3, bench6
    from pfhubbenchmarks_tpu_torch.fem.assembly import bc_mask, make_residual
    from pfhubbenchmarks_tpu_torch.ops import _lib, lmr
    from pfhubbenchmarks_tpu_torch.ops import transfer as kt
    from pfhubbenchmarks_tpu_torch.ops.vcycle_chain import (
        make_ascend_chain, make_ascend_level, make_descend_chain,
        make_descend_level)
    from pfhubbenchmarks_tpu_torch.solve.gmg import (build_hierarchy,
                                                     coarse_dof_count)

    dev = torch.device("cuda", 0)
    smi = smi_line()
    print(f"phase 1: {smi}", flush=True)
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    if not config.tf32_disabled():
        raise AssertionError("TF32 is on")
    print("phase 1: TF32 off", flush=True)

    # ---- phase 2: build -------------------------------------------------
    lib = _lib.library()
    print(f"phase 2: built {lib.path.name} in {lib.build_seconds:.2f} s",
          flush=True)
    src = ""
    for ln in lib.build_log.splitlines():
        if ln.startswith("== "):
            src = ln[3:]
        elif "Used" in ln or "spill" in ln:
            print(f"phase 2: ptxas {src} {ln.strip()}", flush=True)

    # ---- phase 3: kernels vs plain versions at bench1's shapes ---------
    K, C = kernel_records()
    assert set(K) == set(_lib.KERNELS) and set(C) == set(_lib.CHAINS)
    rng = np.random.default_rng(20261016)

    def noise_pair(g, F, scale=1.0):
        return tuple(torch.tensor(scale * rng.standard_normal((F,) + s),
                                  dtype=torch.float32, device=dev)
                     for s in (g.vshape, g.mshape))

    def state_on(problem, g):
        """The IC on ``g`` plus seeded noise, with its Dirichlet values."""
        F = problem.n_fields
        v, m = g.interpolate(problem.ic_fns)
        v, m = (torch.tensor(a, dtype=torch.float32, device=dev) + n
                for a, n in zip((v, m), noise_pair(g, F, 0.01)))
        for bc in problem.dirichlet_for(g):
            v = bc.apply_value(v)
        return v.contiguous(), m

    def residual_jvp(problem, g, w, dt_, v, terms=None, dirichlet=()):
        """A call of ``torch.func.jvp`` of the f32 residual (built once): the
        J.v kernels' reference independent of the hand-written tangents of
        their plain versions, and their library call."""
        res = make_residual(g, terms or problem.terms, problem.n_fields,
                            device=dev, dirichlet=dirichlet, dtype=torch.float32)
        return lambda: torch.func.jvp(lambda u: res(u, w, dt_), (w,), (v,))[1]

    problem1 = bench1.make()
    s1 = problem1.solver
    dt = 0.5
    grids1 = build_hierarchy(problem1.grid,
                             min_cells=problem1.solver.gmg_min_cells)
    assert [g.nx for g in grids1] == [100, 50, 25], [g.nx for g in grids1]

    t3 = time.perf_counter()
    for rule in ("ffc3", "dunavant2"):
        for g0 in grids1:
            g = dataclasses.replace(g0, rule_name=rule)
            jv = problem1.kernel_jvp(g, dev)
            w, v, b = state_on(problem1, g), noise_pair(g, 2), noise_pair(g, 2)
            library = residual_jvp(problem1, g, w, dt, v)
            timing = (cuda_ms(lambda: jv.kernel(w, w, dt, v)),
                      cuda_ms(lambda: jv.plain(w, w, dt, v), reps=10))
            K["ch_jvp"].check(f"{rule} {g.ny}x{g.nx}", jv.kernel(w, w, dt, v),
                              jv.plain(w, w, dt, v), TOL_F32, timing,
                              jvp_work(g, 2), library_ms=(
                                  cuda_ms(library, reps=10) if g.nx == 100
                                  else None))
            if g.nx == 100:
                K["ch_jvp"].check(f"{rule} {g.ny}x{g.nx} b-Jv",
                                  jv.kernel(w, w, dt, v, b=b),
                                  jv.plain(w, w, dt, v, b=b), TOL_F32)
                K["ch_jvp"].check(f"{rule} {g.ny}x{g.nx} Jv vs torch.func.jvp",
                                  jv.kernel(w, w, dt, v), library(), TOL_F32)

    def check_bj_lmr(problem, grids, F, label, rule="dunavant2", groups=None):
        """B and C at each level, on kernel N's block planes (of the
        field-split operator with ``groups``, which are also B's and C's
        field groups)."""
        for g0 in grids:
            g = dataclasses.replace(g0, rule_name=rule)
            w = state_on(problem, g)
            planes = node_plan(problem, g, dev, groups is not None).kernel(
                w, w, dt)
            r = noise_pair(g, F)
            # the library call: one einsum pair over all F^2 planes (the same
            # function where the cross-group planes are 0)
            library_ms = cuda_ms(lambda: lmr.block_jacobi_apply_plain(planes, r))
            timing = (cuda_ms(lambda: lmr.block_jacobi_apply_kernel(planes, r,
                                                                    groups)),
                      cuda_ms(lambda: lmr.block_jacobi_apply_plain(planes, r,
                                                                   groups)))
            K["block_jacobi_apply"].check(
                f"{label} {g.ny}x{g.nx}",
                lmr.block_jacobi_apply_kernel(planes, r, groups),
                lmr.block_jacobi_apply_plain(planes, r, groups), TOL_F32, timing,
                bj_work(g, F, groups), library_ms=library_ms)

            x, r, z, az = (noise_pair(g, F) for _ in range(4))
            xk, rk = [tuple(t.clone() for t in p) for p in (x, r)]
            xp, rp = [tuple(t.clone() for t in p) for p in (x, r)]
            lmr.lmr_step_kernel(xk, rk, z, az, groups)
            lmr.lmr_step_plain(xp, rp, z, az, groups)
            xs, rs = [tuple(t.clone() for t in p) for p in (x, r)]  # scratch
            timing = (cuda_ms(lambda: lmr.lmr_step_kernel(xs, rs, z, az, groups)),
                      cuda_ms(lambda: lmr.lmr_step_plain(xs, rs, z, az, groups)))
            K["lmr_step"].check(f"{label} {g.ny}x{g.nx}", xk + rk, xp + rp,
                                TOL_F32, timing, lmr_work(g, F))

    def check_transfers(phase, problem, grids, F, label, breakdown=()):
        """D or H at every pair of ``grids`` (transfer_pair_checks), with the
        problem's Dirichlet masks; the host-path breakdown at the fine
        sizes in ``breakdown``."""
        for fine, coarse in zip(grids[:-1], grids[1:]):
            masks = tuple(None if m is None else torch.as_tensor(m, device=dev)
                          for m in (bc_mask(g, problem.dirichlet_for(g), F)
                                    for g in (fine, coarse)))
            transfer_pair_checks(K, phase, label, coarse, fine, F, masks,
                                 noise_pair, rng, dev,
                                 breakdown=fine.nx in breakdown)

    check_bj_lmr(problem1, grids1, 2, "bench1")
    node_blocks_phase(3, "bench1", K, problem1,
                      [dataclasses.replace(g, rule_name=s1.precond_rule)
                       for g in grids1], dt, dev, state_on)
    node_build_phase(3, "bench1", K, problem1, dt, dev, state_on)
    check_stream_handle("phase 3")
    check_transfers("phase 3", problem1, grids1, 2, "bench1", breakdown=(100,))
    torch.cuda.synchronize()
    print(f"phase 3: bench1-shape kernels agree with their plain versions "
          f"({time.perf_counter() - t3:.1f} s)", flush=True)

    # ---- phase 4: bench1's main path at 100x100, the whole run ----------
    paths = {}
    runner1 = timeloop.Runner(problem1, dev)
    paths["bench1"], result1, wall1, seconds1 = drive(
        "phase 4: bench1", problem1, lambda: runner1.run(verbose=True),
        FUSED_2D, absent=FUSED_ABSENT + ("ch_jvp",),
        max_calls=MAX_CALLS_PER_APPLY["bench1"])
    hold_trajectory("phase 4: bench1", result1, "bench1_out.csv",
                    problem1.time.end_time, BENCH1_MIN_MATCHED,
                    BENCH1_INTERP_TOL)
    st1 = result1.stats
    port1 = dict(steps=len(st1), attempts=len(st1) + sum(s.retries for s in st1),
                 newton=sum(s.newton_iters for s in st1),
                 krylov=sum(s.krylov_iters for s in st1),
                 krylov_all=sum(s.krylov_iters_all for s in st1))
    print("phase 4: bench1 steps / attempts / newton / krylov / krylov_all: "
          + " / ".join(str(port1[k]) for k in JAX_BENCH1) + " (port, "
          f"newton_all {sum(s.newton_iters_all for s in st1)}) against "
          + " / ".join(str(v) for v in JAX_BENCH1.values())
          + f" (the JAX run, BENCH_r05.json); wall {wall1:.3f} s, "
          f"{wall1 / max(port1['krylov_all'], 1) * 1e3:.2f} ms per Krylov "
          f"iteration over all attempts, builds {seconds1['precond_build']:.3f}"
          " s", flush=True)

    # ---- phase 5: kernels and chains at bench6's shapes -----------------
    problem6 = bench6.make()
    F6 = problem6.n_fields
    s6 = problem6.solver
    grids6 = [dataclasses.replace(g, rule_name=s6.precond_rule)
              for g in build_hierarchy(problem6.grid, min_cells=s6.gmg_min_cells)]
    assert [g.nx for g in grids6] == [100, 50, 25], [g.nx for g in grids6]
    dt6 = 0.32
    t5 = time.perf_counter()
    for rule in ("ffc3", "dunavant2"):
        for g0 in grids6:
            g = dataclasses.replace(g0, rule_name=rule)
            w, v, b = (state_on(problem6, g), noise_pair(g, F6),
                       noise_pair(g, F6))
            for bcs in (problem6.dirichlet_for(g), ()):
                jv = problem6.kernel_jvp(g, dev, bcs)
                lab = f"{rule} {g.ny}x{g.nx} {'masked' if bcs else 'unmasked'}"
                library = residual_jvp(problem6, g, w, dt6, v, dirichlet=bcs)
                timing = work = library_ms = None
                if g.nx == 100 and bcs:
                    timing = (cuda_ms(lambda: jv.kernel(w, w, dt6, v)),
                              cuda_ms(lambda: jv.plain(w, w, dt6, v), reps=10))
                    work = jvp_work(g, F6, masked=True)
                    library_ms = cuda_ms(library, reps=10)
                K["chp_jvp"].check(f"{lab} Jv", jv.kernel(w, w, dt6, v),
                                   jv.plain(w, w, dt6, v), TOL_F32, timing, work,
                                   library_ms=library_ms)
                K["chp_jvp"].check(f"{lab} b-Jv", jv.kernel(w, w, dt6, v, b=b),
                                   jv.plain(w, w, dt6, v, b=b), TOL_F32)
                if g.nx == 100:
                    K["chp_jvp"].check(
                        f"{lab} Jv vs torch.func.jvp", jv.kernel(w, w, dt6, v),
                        library(), TOL_F32)

    check_bj_lmr(problem6, grids6, F6, "bench6")
    node_blocks_phase(5, "bench6 masked", K, problem6, grids6, dt6, dev,
                      state_on)
    node_build_phase(5, "bench6 masked", K, problem6, dt6, dev, state_on)
    chp_box_phase(dev, K, rng)
    check_transfers("phase 5", problem6, grids6, F6, "bench6")

    # the chains, on the injected per-level states and their block planes
    masks6 = [None if m is None else torch.as_tensor(m, device=dev)
              for m in (bc_mask(g, problem6.dirichlet_for(g), F6) for g in grids6)]
    jvs6 = [problem6.kernel_jvp(g, dev, problem6.dirichlet_for(g)) for g in grids6]
    w_ls, pinvs = [], []
    wl = state_on(problem6, grids6[0])
    for l, g in enumerate(grids6[:-1]):
        w_ls.append(wl)
        pinvs.append(node_plan(problem6, g, dev).kernel(wl, wl, dt6))
        wl = kt.inject_plain(wl, grids6[l + 1], g)
    nus = dict(nu=s6.gmg_nu_pre, nu_fine=s6.gmg_nu_fine_pre or s6.gmg_nu_pre)
    descend = make_descend_chain(grids6, jvs6, masks=masks6, **nus)
    ascend = make_ascend_chain(grids6, jvs6, masks=masks6, nu=s6.gmg_nu_post,
                               nu_fine=s6.gmg_nu_fine_post or s6.gmg_nu_post)
    b0 = noise_pair(grids6[0], F6)
    xs_k, bs_k, bc_k = descend.sequence(b0, w_ls, w_ls, dt6, pinvs)
    xs_p, bs_p, bc_p = descend.plain(b0, w_ls, w_ls, dt6, pinvs)
    timing = (cuda_ms(lambda: descend.sequence(b0, w_ls, w_ls, dt6, pinvs),
                      reps=10),
              cuda_ms(lambda: descend.plain(b0, w_ls, w_ls, dt6, pinvs), reps=3))
    work = chain_work(grids6, F6, nus["nu"], nus["nu_fine"], ascend=False)
    got = [t for p in xs_k + bs_k + [bc_k] for t in p]
    ref = [t for p in xs_p + bs_p + [bc_p] for t in p]
    C["descend_chain"].check("100/50/25", got, ref, TOL_F32, timing, work)
    xc = noise_pair(grids6[-1], F6)
    bs_in = [b0] + bs_p
    timing = (cuda_ms(lambda: ascend.sequence(bs_in, xs_p, xc, w_ls, w_ls, dt6,
                                              pinvs), reps=10),
              cuda_ms(lambda: ascend.plain(bs_in, xs_p, xc, w_ls, w_ls, dt6,
                                           pinvs), reps=3))
    work = chain_work(grids6, F6, s6.gmg_nu_post,
                      s6.gmg_nu_fine_post or s6.gmg_nu_post, ascend=True)
    C["ascend_chain"].check(
        "100/50/25", ascend.sequence(bs_in, xs_p, xc, w_ls, w_ls, dt6, pinvs),
        ascend.plain(bs_in, xs_p, xc, w_ls, w_ls, dt6, pinvs), TOL_F32, timing,
        work)
    torch.cuda.synchronize()
    print(f"phase 5: bench6-shape kernels and chain sequences agree with their plain "
          f"versions ({time.perf_counter() - t5:.1f} s)", flush=True)

    # ---- phase 6: bench6's main path at 100x100 -------------------------
    runner6 = timeloop.Runner(problem6, dev)
    build = runner6.problem.precond_builder(dev)
    print(f"phase 6: hierarchy {[g.nx for g in build.grids]}, coarsest solve "
          f"{'dense' if build.dense_coarse else f'{s6.gmg_coarse_sweeps} LMR sweeps'}",
          flush=True)
    paths["bench6"], _, _, _ = run_main_path(
        "phase 6: bench6", runner6, None, "bench6_out.csv", BENCH6_ROWS,
        ("tri_box_chp", "vcycle_descend_chain", "vcycle_ascend_chain",
         "lmr_sweep", "residual_box", "node_build"),
        absent=GATHER_ABSENT + ("residual", "chp_jvp"),
        max_calls=MAX_CALLS_PER_APPLY["bench6"])

    # ---- phase 7: kernels, sweep loop and chains at bench2's shapes -----
    problem2 = bench2.make()
    F2 = problem2.n_fields
    s2 = problem2.solver
    groups2 = problem2.field_groups
    grids2 = [dataclasses.replace(g, rule_name=s2.precond_rule)
              for g in build_hierarchy(problem2.grid, min_cells=s2.gmg_min_cells)]
    assert [g.nx for g in grids2] == [100, 50, 25], [g.nx for g in grids2]
    dt2 = 0.16
    t7 = time.perf_counter()
    for num_eta in (4, 2, 1):
        pb = problem2 if num_eta == 4 else bench2.make(num_eta=num_eta)
        Fb = pb.n_fields
        for split in (False, True):
            rule = "dunavant1" if split else "ffc3"
            for g0 in (grids2 if num_eta == 4 else grids2[:1]):
                g = dataclasses.replace(g0, rule_name=rule)
                w, v, b = state_on(pb, g), noise_pair(g, Fb), noise_pair(g, Fb)
                jv = pb.kernel_jvp(g, dev, split=split)
                lab = (f"NE={num_eta} {'split' if split else 'coupled'} {rule} "
                       f"{g.ny}x{g.nx}")
                library = residual_jvp(pb, g, w, dt2, v,
                                       pb.terms_precond if split else None)
                timing = work = library_ms = None
                if g.nx == 100 and num_eta == 4:
                    timing = (cuda_ms(lambda: jv.kernel(w, w, dt2, v)),
                              cuda_ms(lambda: jv.plain(w, w, dt2, v), reps=10))
                    work = jvp_work(g, Fb, ns=1 + num_eta, ops=TANGENT_OPS[
                        (Fb, "split" if split else "coupled")])
                    library_ms = cuda_ms(library, reps=10)
                K["chac_jvp"].check(f"{lab} Jv", jv.kernel(w, w, dt2, v),
                                    jv.plain(w, w, dt2, v), TOL_F32, timing, work,
                                    library_ms=library_ms)
                K["chac_jvp"].check(f"{lab} b-Jv", jv.kernel(w, w, dt2, v, b=b),
                                    jv.plain(w, w, dt2, v, b=b), TOL_F32)
                if g.nx == 100:
                    K["chac_jvp"].check(
                        f"{lab} Jv vs torch.func.jvp", jv.kernel(w, w, dt2, v),
                        library(), TOL_F32)

    check_bj_lmr(problem2, grids2, F2, "bench2 groups", rule=s2.precond_rule,
                 groups=groups2)
    # kernel N: the main path's field-split planes with 4 order parameters
    # at every level (its main shape at 100^2), the coupled ones, and 1 and 2
    # order parameters at 100^2
    for num_eta in (4, 2, 1):
        pb = problem2 if num_eta == 4 else bench2.make(num_eta=num_eta)
        for split in (True, False):
            node_blocks_phase(
                7, f"bench2 NE={num_eta} {'split' if split else 'coupled'}", K,
                pb, grids2 if num_eta == 4 else grids2[:1], dt2, dev, state_on,
                split=split, ns=1 + num_eta, ops=chac_tangent_ops(num_eta, split),
                main=num_eta == 4 and split, library_at=int(num_eta == 4))
            # kernel V takes BM2's split levels only: the coupled build is
            # the chains'
            node_build_phase(
                7, f"bench2 NE={num_eta} {'split' if split else 'coupled'}", K,
                dataclasses.replace(pb, solver=dataclasses.replace(
                    pb.solver, field_split=split,
                    fuse_vcycle=pb.solver.fuse_vcycle if split
                    else "split_chain")), dt2, dev, state_on,
                ns=1 + num_eta, ops=chac_tangent_ops(num_eta, split),
                main=num_eta == 4 and split)
    check_transfers("phase 7", problem2, grids2, F2, "bench2")

    # the per-level split states, block planes (kernel N) and J.v of the
    # cycle
    jvs2 = [problem2.kernel_jvp(g, dev, split=True) for g in grids2]
    plans2 = [node_plan(problem2, g, dev, split=True) for g in grids2]
    w_ls2, pinvs2 = [], []
    w = state_on(problem2, grids2[0])
    for l, g in enumerate(grids2):
        w_ls2.append(w)
        pinvs2.append(plans2[l].kernel(w, w, dt2))
        if l + 1 < len(grids2):
            w = kt.inject_plain(w, grids2[l + 1], g)

    # the main path's multigrid build (kernel N per level, the injections),
    # warm: the path builds once per Newton iteration
    build2 = problem2.precond_builder(dev)
    w2 = problem2.initial_state(dev)
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t_bj = time.perf_counter()
        build2(w2, w2, dt2)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t_bj) * 1e3)
    bj_build_ms = statistics.median(times[1:])
    print(f"phase 7: multigrid build of the 100/50/25 hierarchy ({F2} "
          f"fields, kernel N per level and the injections): first "
          f"{times[0]:.2f} ms, then median {bj_build_ms:.3f} ms of "
          f"{[round(x, 3) for x in times[1:]]} (the torch.func.jvp build before "
          f"kernel N: 2,346.7 ms a build on the main path)", flush=True)

    jv_kw2 = dict(ns=5, ops=TANGENT_OPS[(F2, "split")])
    n_coarse = s2.gmg_coarse_sweeps
    nus2 = dict(nu=s2.gmg_nu_pre, nu_fine=s2.gmg_nu_fine_pre or s2.gmg_nu_pre)
    nua2 = dict(nu=s2.gmg_nu_post, nu_fine=s2.gmg_nu_fine_post or s2.gmg_nu_post)
    descend2 = make_descend_chain(grids2, jvs2, **nus2, field_groups=groups2)
    ascend2 = make_ascend_chain(grids2, jvs2, **nua2, field_groups=groups2)
    wk2, pk2 = w_ls2[:-1], pinvs2[:-1]
    b0 = noise_pair(grids2[0], F2)
    xs_k, bs_k, bc_k = descend2.sequence(b0, wk2, wk2, dt2, pk2)
    xs_p, bs_p, bc_p = descend2.plain(b0, wk2, wk2, dt2, pk2)
    timing = (cuda_ms(lambda: descend2.sequence(b0, wk2, wk2, dt2, pk2),
                      reps=10),
              cuda_ms(lambda: descend2.plain(b0, wk2, wk2, dt2, pk2), reps=3))
    C["descend_chain"].check(
        "bench2 100/50/25 groups", [t for p in xs_k + bs_k + [bc_k] for t in p],
        [t for p in xs_p + bs_p + [bc_p] for t in p], TOL_F32, timing,
        chain_work(grids2, F2, ascend=False, jv_kw=jv_kw2, groups=groups2,
                   **nus2))
    xc = noise_pair(grids2[-1], F2)
    bs_in = [b0] + bs_p
    timing = (cuda_ms(lambda: ascend2.sequence(bs_in, xs_p, xc, wk2, wk2, dt2,
                                               pk2), reps=10),
              cuda_ms(lambda: ascend2.plain(bs_in, xs_p, xc, wk2, wk2, dt2, pk2),
                      reps=3))
    C["ascend_chain"].check(
        "bench2 100/50/25 groups",
        ascend2.sequence(bs_in, xs_p, xc, wk2, wk2, dt2, pk2),
        ascend2.plain(bs_in, xs_p, xc, wk2, wk2, dt2, pk2), TOL_F32, timing,
        chain_work(grids2, F2, ascend=True, jv_kw=jv_kw2, groups=groups2,
                   **nua2))
    torch.cuda.synchronize()
    print(f"phase 7: bench2-shape kernels, sweep loop and chains agree with "
          f"their plain versions ({time.perf_counter() - t7:.1f} s)", flush=True)

    # ---- phases 28 and 29: kernel W against A, F and G, the residual box
    # against R, at their main shapes ---------------------------------------
    tri_box_phase(dev, K, rng)
    residual_box_phase(dev, K)
    vcycle_phase(dev, K, rng)

    # ---- phase 8: bench2's main path at 100x100 -------------------------
    runner2 = timeloop.Runner(problem2, dev)
    build = runner2.problem.precond_builder(dev)
    print(f"phase 8: hierarchy {[g.nx for g in build.grids]} at "
          f"{s2.precond_rule}, field groups {groups2}, coarsest solve "
          f"{'dense' if build.dense_coarse else f'{n_coarse} LMR sweeps'}",
          flush=True)
    paths["bench2"], result2, wall2, seconds2 = drive(
        "phase 8: bench2", problem2, lambda: runner2.run(verbose=True),
        FUSED_2D + ("residual_box",),
        absent=FUSED_ABSENT + ("chac_jvp", "residual"),
        max_calls=MAX_CALLS_PER_APPLY["bench2"])
    hold_trajectory("phase 8: bench2", result2, "bench2_out.csv",
                    problem2.time.end_time, BENCH2_MIN_MATCHED,
                    BENCH2_INTERP_TOL, tfe_tol=1e-5)
    # precond_lag 'newton': one multigrid build (kernel N's planes of every
    # level, injections) per Newton iteration, over every attempt, timed
    # inside the run by solve/gmg.py
    n_builds = sum(st.newton_iters_all for st in result2.stats)
    build_s = seconds2["precond_build"]
    print(f"phase 8: multigrid builds on the main path: {n_builds} builds, "
          f"{build_s:.3f} s measured ({build_s / n_builds * 1e3:.3f} ms each; "
          f"phase 7's warm build {bj_build_ms:.3f} ms; before kernel N "
          f"2,346.7 ms), share {build_s / wall2:.4f} of the {wall2:.3f} s run",
          flush=True)

    # ---- phase 9: kernels, transfers and level steps at bench3's shapes ---
    problem3 = bench3.make()
    F3 = problem3.n_fields
    s3 = problem3.solver
    grids3 = [dataclasses.replace(g, rule_name=s3.precond_rule)
              for g in build_hierarchy(problem3.grid, min_cells=s3.gmg_min_cells)]
    assert [g.nx for g in grids3] == [350, 175, 35, 7], [g.nx for g in grids3]
    dt3 = 1.28
    jv_kw3 = dict(ns=2, ops=TANGENT_OPS["ach"])
    t9 = time.perf_counter()
    for rule, g0 in [("ffc3", grids3[0])] + [("dunavant2", g) for g in grids3]:
        g = dataclasses.replace(g0, rule_name=rule)
        w, v, b = state_on(problem3, g), noise_pair(g, F3), noise_pair(g, F3)
        jv = problem3.kernel_jvp(g, dev)
        lab = f"{rule} {g.ny}x{g.nx}"
        library = residual_jvp(problem3, g, w, dt3, v)
        timing = work = library_ms = dev_ms = None
        if g.nx == 350:
            timing = (cuda_ms(lambda: jv.kernel(w, w, dt3, v)),
                      cuda_ms(lambda: jv.plain(w, w, dt3, v), reps=10))
            work = jvp_work(g, F3, **jv_kw3)
            library_ms = cuda_ms(library, reps=10)
            dev_ms = device_ms(lambda: jv.kernel(w, w, dt3, v))
        K["ach_jvp"].check(f"{lab} Jv", jv.kernel(w, w, dt3, v),
                           jv.plain(w, w, dt3, v), TOL_F32, timing, work,
                           library_ms=library_ms, dev_ms=dev_ms)
        K["ach_jvp"].check(f"{lab} b-Jv", jv.kernel(w, w, dt3, v, b=b),
                           jv.plain(w, w, dt3, v, b=b), TOL_F32)
        if g.nx == 350:
            K["ach_jvp"].check(f"{lab} Jv vs torch.func.jvp",
                               jv.kernel(w, w, dt3, v), library(), TOL_F32)

    # the transfers of the hierarchy: H for the ratio-5 pairs, D for 350<->175
    check_transfers("phase 9", problem3, grids3, F3, "bench3", breakdown=(175,))

    check_bj_lmr(problem3, grids3[:1], F3, "bench3", rule=s3.precond_rule)
    node_blocks_phase(9, "bench3", K, problem3, grids3, dt3, dev, state_on,
                      ns=2, ops=TANGENT_OPS["ach"])
    node_build_phase(9, "bench3", K, problem3, dt3, dev, state_on, ns=2,
                     ops=TANGENT_OPS["ach"])

    # the level steps (TPU kernels 6 and 9) on the injected per-level states
    # and their block planes, with bench3's sweep counts
    w_ls3, pinvs3 = [], []
    wl = state_on(problem3, grids3[0])
    for l, g in enumerate(grids3):
        w_ls3.append(wl)
        pinvs3.append(node_plan(problem3, g, dev).kernel(wl, wl, dt3))
        if l + 1 < len(grids3):
            wl = kt.inject(wl, grids3[l + 1], g)
    for l, (fine, coarse) in enumerate(zip(grids3[:-1], grids3[1:])):
        nu_d = (s3.gmg_nu_fine_pre or s3.gmg_nu_pre) if l == 0 else s3.gmg_nu_pre
        nu_a = (s3.gmg_nu_fine_post or s3.gmg_nu_post) if l == 0 else s3.gmg_nu_post
        jv = problem3.kernel_jvp(fine, dev)
        d = make_descend_level(fine, coarse, jv, nu=nu_d)
        a = make_ascend_level(fine, coarse, jv, nu=nu_a)
        wl, pl = w_ls3[l], pinvs3[l]
        b, xc = noise_pair(fine, F3), noise_pair(coarse, F3)
        xk, bck = d.sequence(b, wl, wl, dt3, pl)
        xp, bcp = d.plain(b, wl, wl, dt3, pl)
        xc1, bcc1 = (tuple(t.clone() for t in p)
                     for p in d.kernel(b, wl, wl, dt3, pl))
        K["vcycle_descend_chain"].check(
            f"level step {fine.nx}->{coarse.nx} nu={nu_d}", xc1 + bcc1,
            xp + bcp, TOL_F32)
        K["vcycle_ascend_chain"].check(
            f"level step {coarse.nx}->{fine.nx} nu={nu_a}",
            a.kernel(b, xp, xc, wl, wl, dt3, pl),
            a.plain(b, xp, xc, wl, wl, dt3, pl), TOL_F32)
        for tag, step, args in (
                (f"descend {fine.nx}->{coarse.nx} nu={nu_d}", d,
                 (b, wl, wl, dt3, pl)),
                (f"ascend {coarse.nx}->{fine.nx} nu={nu_a}", a,
                 (b, xp, xc, wl, wl, dt3, pl))):
            per_call = interleaved_ms({"kernel": lambda: step.kernel(*args),
                                       "sequence": lambda: step.sequence(*args)})
            print(f"phase 9: level step {tag} as one chain launch: device "
                  f"{device_ms(lambda: step.kernel(*args)) * 1e3:.2f} us vs the "
                  f"sequence's {device_ms(lambda: step.sequence(*args)) * 1e3:.2f}"
                  f"; per call {per_call['kernel'] * 1e3:.1f} vs "
                  f"{per_call['sequence'] * 1e3:.1f} us", flush=True)
        timing = (cuda_ms(lambda: d.sequence(b, wl, wl, dt3, pl), reps=10),
                  cuda_ms(lambda: d.plain(b, wl, wl, dt3, pl), reps=3))
        C["descend_level"].check(
            f"{fine.nx}->{coarse.nx} nu={nu_d}", xk + bck, xp + bcp, TOL_F32,
            timing, chain_work([fine, coarse], F3, nu_d, nu_d, ascend=False,
                               jv_kw=jv_kw3, masked=False))
        timing = (cuda_ms(lambda: a.sequence(b, xp, xc, wl, wl, dt3, pl),
                          reps=10),
                  cuda_ms(lambda: a.plain(b, xp, xc, wl, wl, dt3, pl), reps=3))
        C["ascend_level"].check(
            f"{coarse.nx}->{fine.nx} nu={nu_a}",
            a.sequence(b, xp, xc, wl, wl, dt3, pl),
            a.plain(b, xp, xc, wl, wl, dt3, pl), TOL_F32, timing,
            chain_work([fine, coarse], F3, nu_a, nu_a, ascend=True,
                       jv_kw=jv_kw3, masked=False))

    # the multigrid build of the 4-level hierarchy (block-Jacobi planes,
    # injections, and the dense 7^2 inverse: jacfwd of the coarse residual and
    # torch.linalg.inv), with and without the dense inverse. The main path
    # builds once per Newton iteration, so after a first build each the warm
    # builds are timed, the two kinds in turns (host-clock noise is tens of
    # ms), and their medians compared.
    w3 = problem3.initial_state(dev)
    builds = {"with the dense inverse": problem3.precond_builder(dev),
              "without": dataclasses.replace(problem3, solver=dataclasses.replace(
                  s3, gmg_dense_coarse_max_dofs=0)).precond_builder(dev)}
    assert builds["with the dense inverse"].dense_coarse
    assert not builds["without"].dense_coarse
    times = {name: [] for name in builds}
    for rep in range(6):
        for name, build in builds.items():
            torch.cuda.synchronize()
            t_b = time.perf_counter()
            build(w3, w3, dt3)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t_b) * 1e3)
    build_ms = {name: statistics.median(t[1:]) for name, t in times.items()}
    for name, t in times.items():
        print(f"phase 9: multigrid build of 350/175/35/7 {name}: first "
              f"{t[0]:.1f} ms, then median {build_ms[name]:.1f} ms of "
              f"{[round(x, 1) for x in t[1:]]}", flush=True)
    print(f"phase 9: the dense 7^2 inverse adds "
          f"{build_ms['with the dense inverse'] - build_ms['without']:.1f} ms "
          f"to the median warm build", flush=True)
    torch.cuda.synchronize()
    print(f"phase 9: bench3-shape kernels, transfers and level steps agree "
          f"with their plain versions ({time.perf_counter() - t9:.1f} s)",
          flush=True)

    # ---- phase 10: bench3's main path at 350x350 -----------------------
    runner3 = timeloop.Runner(problem3, dev)
    build = runner3.problem.precond_builder(dev)
    n_dofs = coarse_dof_count(build.grids[-1], F3)
    print(f"phase 10: hierarchy {[g.nx for g in build.grids]} at "
          f"{s3.precond_rule}, build.dense_coarse={build.dense_coarse} "
          f"({n_dofs} coarse dofs)", flush=True)
    if not build.dense_coarse:
        raise AssertionError("bench3's coarsest solve is not the dense inverse")
    paths["bench3"], result3, wall3, seconds3 = run_main_path(
        "phase 10: bench3", runner3, None, "bench3_out.csv", BENCH3_ROWS,
        ("tri_box", "vcycle_descend_chain", "vcycle_ascend_chain",
         "node_build"),
        absent=GATHER_ABSENT + ("ach_jvp",),
        tfe_tol=1e-6, col2_tol=1e-5, max_calls=MAX_CALLS_PER_APPLY["bench3"])
    n_builds3 = sum(st.newton_iters_all for st in result3.stats)
    build_s3, dense_s3 = seconds3["precond_build"], seconds3["dense_coarse"]
    print(f"phase 10: multigrid builds on the main path (with the dense 7^2 "
          f"inverse): {n_builds3} builds, {build_s3:.3f} s measured "
          f"({build_s3 / n_builds3 * 1e3:.2f} ms each: kernel N's planes and "
          f"the injections {(build_s3 - dense_s3) / n_builds3 * 1e3:.2f} ms, "
          f"the dense 7^2 inverse {dense_s3 / n_builds3 * 1e3:.2f} ms; phase "
          f"9's warm build {build_ms['with the dense inverse']:.1f} ms), share "
          f"{build_s3 / wall3:.4f} of the {wall3:.3f} s run (planes and "
          f"injections {(build_s3 - dense_s3) / wall3:.4f}, dense inverse "
          f"{dense_s3 / wall3:.4f})", flush=True)

    bench1_3d_phases(dev, K, C, rng, t_start, paths)
    bench6_3d_phases(dev, K, rng, t_start, paths)

    # bench1's first rows and their wall (the sum of their steps' walls)
    wall1_prefix = sum(st.wall for st in result1.stats[:BENCH1_TILED_ROWS])
    tile_phases(dev, K, C, noise_pair, state_on, residual_jvp, paths,
                {"bench1": (result1, wall1_prefix), "bench3": (result3, wall3)})

    fma_chain_phase(dev, K, paths)
    replay_phases(dev, t_start, paths, problem1, problem6, problem3)
    bench2_more_phases(dev, t_start, paths, problem2)
    shard_sweep_phase(dev, K, paths)
    gridjvp_phase(dev, K, paths)
    sweep_loop_phase(dev, K, rng)
    chain_phase(dev, K, rng)
    aniso_phase(dev, K, rng, paths)
    linear_phases(dev)

    # ---- phase 27: summary -----------------------------------------------
    print(smi, flush=True)
    print(json.dumps({"kernels": [K[k].record(paths) for k in _lib.KERNELS],
                      "chains": [C[k].record(paths) for k in _lib.CHAINS]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
