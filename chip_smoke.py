#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``conjugategradient_tpu_torch``)
on one NVIDIA GPU.

Usage, from the repository root: ``python3 chip_smoke.py``

1. Print the card (``nvidia-smi`` name and power limit) and build the
   CUDA kernels from ``conjugategradient_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel).
2. Hold each of the fifty-one kernels against its plain-torch version on the
   card, at the main paths' shapes (128 x 128 tiles on the n = 262,144
   block-tridiagonal operator and on poisson3d_48; 8 x 128 tiles on
   poisson3d_48 for the SpMV; the JAX package's symdia-big operator,
   n = 2,097,152 with 41 diagonals, in full and symmetric DIA storage, and
   poisson3d_48 as DIA; the 256^3 stencil of BASELINE config 4 in float32
   and float64) and at small ragged shapes, and time both, beside one
   library call (cuSPARSE ``torch.sparse_csr_tensor @ x`` for the SpMVs,
   cuDNN ``conv3d`` with TF32 off for the stencil) and the least time the
   card could take for each kernel's bytes.  Kernel 11 on each of its
   kernels that can take the volume (``stencil7_staged``, the staged
   kernel, forced where its rows and alignment allow, and ``stencil7``,
   the register march, forced), ``fused_stencil_dir_dot`` (p_new, q) and
   ``fused_update_dot(_pcg)`` (x', r'; also at lengths 210, 4097 and
   256^3) must be bit-equal to their plain versions; a NaN put into the
   stencil's input reaches only its point and its six neighbours.  The fused MINRES kernels (full storage, symmetric
   storage with the banded and the general landing, the update; with and
   without the Jacobi diagonal, shift 0 and not 0, a first step without a
   pending update) give v, w, x' and r2' bit-equal, q and the dots within
   the stated tolerances, repeat bit for bit, and their last CTAs' scalar
   steps agree with the plain versions' torch ops to ``TAIL_ULPS``.  The
   fused BiCGStab kernels, on bench.py's bicgstab-bell operator (n =
   262,144, 128 x 128, nonsymmetric), on the timed path's convection-
   diffusion operator (nx = 512, kmax 5, padding slots on column block 0;
   kernels 18 and 19 timed there too) and at a ragged nrb = 13 with bn = 32
   and 64 (with and without the Jacobi diagonal, with alpha, beta and omega
   0, and with a NaN alpha and omega, which their tails clamp to 0 so that
   the next update is a no-op; the update kernel at lengths 210, 4097 and
   n): p', p^, s, s^, x_h, x' and r' bit-equal, v', t and the dots within
   the stated tolerances, two launches bit-identical, the tails within
   ``TAIL_ULPS``; a launch of the update kernel that is not live writes
   nothing (n and 4097).  The row-sharded kernels 6 (``bell_spmv_dot``) and 17
   (``minres_shard_spmv_dot``), on shards 0 and 3 of the n = 262,144
   operator split into 4 (``split_tridiag_tiles``) and at a ragged nrb = 13
   with bn = 32 and 64 at a row offset that is not 0 (kernel 17 also with a
   shift, with su = 0 and with a Jacobi-scaled v): q within TOL_Q, w and x'
   bit-equal (also written over w-2 and x), the dots within TOL_DOT, two
   launches bit-identical; kernels 2, 3 and 16 in the sharded loop's
   partials-only mode bit-equal to their full-tail launches, and at the
   lengths of one shard (n / 4, n / 8) bit-equal to their plain versions in
   x', r' and r2' (the dots within TOL_DOT); a launch of kernel 2, 3 or 16
   that is not live writes nothing (n and n / 8, with and without the
   scalar step); kernels 6 and 17 timed on a shard of P = 4 (and P = 8),
   kernels 2, 3 and 16 in partials-only mode at n / 4 and n / 8, and the
   floor of one elementwise launch at n (``torch.add``; no library time of
   theirs).  Kernels 5 and 4 on the packed
   nonzeros of sparse tiles (``bell_spmv_packed``,
   ``fused_dir_spmv_dot_packed``) on poisson3d_48 (kernel 5 at 128 x 128
   and 8 x 128, kernel 4 at 128 x 128 with and without the Jacobi
   diagonal, beta 0 and not 0) and on its 8 x 8 tiles, a float32 width
   the dense kernels do not take: y and q within TOL_Q of the plain
   versions (built to agree bit for bit, which is printed) and of the
   dense tiles' plain products, p_new bit-equal, pap within TOL_DOT,
   repeats bit-identical; both timed beside the dense kernels on the same
   operator, cuSPARSE and their bound on the bytes the nonzeros need, and
   the one-time pack timed; the two designs against each other on the
   n = 262,144 tiles with entries zeroed down to a fill of 0.05 (the
   crossover).  Kernels 18 and 19 on the packed nonzeros
   (``bicgstab_dir_spmv_dot_packed``, ``bicgstab_s_spmv_dot_packed``) on
   the convection-diffusion operators at nx = 512 and 64 (128 x 128) and
   at nx = 37 with bn = 32 (n not a multiple of 32), with and without the
   Jacobi diagonal, with alpha, beta and omega 0 and with a NaN alpha and
   omega: p', p^, v', s, s^, x_h and t bit-equal to the plain versions,
   the dots within TOL_DOT, the tails within ``TAIL_ULPS``; both timed on
   nx = 512 beside the dense kernels 18 and 19 on the same operator, with
   their bound on the bytes the nonzeros need.  Kernels 14 and 15 on the
   packed nonzeros (``minres_dir_spmv_dot_packed``: one kernel on full
   storage's view or on symmetric storage's view of D + U + U^T) on
   poisson3d_48 at 128 x 128 in both storages and on a ragged 2-D Poisson
   nx = 37 at bn = 32, with and without the Jacobi diagonal, shift 0 and
   not 0, a first step and NaN scalars: v, q, w and x' bit-equal to the
   plain versions, the dots within TOL_DOT, the tail 0 ulps from torch's,
   a launch with live = 0 a no-op; timed on poisson3d_48 beside the dense
   kernel 14 (full) and the dense kernel 15's general landing, with the
   bound on the bytes the storage's nonzeros need.  Kernel 1 on the packed
   nonzeros of sparse symmetric tiles (``sym_fused_dir_spmv_dot_packed``:
   the packed kernel 4 on ``SymBellMatrix.packed()``) on poisson3d_48 at
   128 x 128 and on the ragged 2-D Poisson nx = 37 at bn = 32, with and
   without the Jacobi diagonal, beta 0 and not 0: p_new and q bit-equal to
   the plain version, pap within TOL_DOT, q within TOL_Q of the tiles'
   general landing, repeats bit-identical; timed on poisson3d_48 beside
   the general landing, with the bound on the stored nonzeros and the
   view's own bound.  Kernel 7 in both forms (``dia_spmv_rows``, the
   offsets by value, four rows a thread, on operators of at most 32
   diagonals; ``dia_spmv``, one thread a row) bit-equal to the plain
   version, the routed call too, on the shapes below and at n = 3, 1001
   and 110,592 with offsets beyond n on both sides, ncols equal to n,
   above and below it, a NaN in x, and x or the diagonals not 16-byte
   aligned; both timed on poisson3d_48 (``dia_spmv_rows`` is its route),
   ``dia_spmv`` on symdia-big (its route: 41 diagonals).  Kernel 10 in
   its three forms (``sym_dia_spmv_tiled``, the tiled kernel, on its
   geometry; ``sym_dia_spmv_rows``, the offsets by value, up to 32 stored
   offsets; and ``sym_dia_spmv``, one thread a row) bit-equal to the
   plain version on symdia-big, poisson3d_48, dense_256 and a ragged
   n = 1001 (offsets 0, 3, 300), the routed call too; each timed on
   symdia-big and poisson3d_48.  Then, before the timing rows, the
   registers, static shared memory and spills that ``nvcc -Xptxas -v``
   reports for each instantiation of kernels 1 and 15 on the banded
   landing and of the row-sharded kernels 6 and 17 (``ptxas_report``),
   the banded tile ring's geometry at every tile width and type, and
   kernels 1 and 15's device time at n = 262,144 against the ring depth S
   (3, 4, 6, 8, 12 stages and the default), every depth's outputs held
   bit-equal to the default's (``banded_ring_report``); then kernels 6 and
   17's ring on the sharded path's shards (strips, CTAs, chunks, stages,
   shared memory) and a launch's device time at P = 8 (each launch on the
   next shard, as in the loop), float32 and bf16, against the same depths,
   the bits held alike (``sharded_ring_report``; ``--sharded-only`` sweeps
   P = 4 too).
3. Drive the blocked-ELL path through its entry points, with the launch
   counters reset just before and read just after: the tester on
   ``problems/poisson3d_48.mtx`` and ``problems/elasticity3d_16.mtx`` in
   both blocked layouts (symbell and bell, float32, plain CG and Jacobi
   PCG); fused CG and Jacobi PCG on poisson3d_48 in full and in symmetric
   storage once on the dense-tile route and once on the packed route (iterations,
   rel_error, ms/it, the kernels launched, the two trajectories); the
   n = 262,144 operator in both storages for 256 timed steps, its dense
   tiles held to the dense kernels;
   the fused solves against the plain-torch loop on the same card, and
   twice against themselves (bitwise); the portable loop on
   ``load_matrix(layout="bell")`` (8 x 128 tiles); residual replacement
   every 8 steps on the fused symmetric and full solves and the portable
   loop, against the same solves run by the plain versions on the CPU; one
   x0 warm start; the tester's default CSR float64 path twice (bitwise).
   Then the DIA / SELL path, with its own reset and read: the tester with
   ``--layout auto`` (resolves to DIA: kernel 7's ``dia_spmv_rows``) and ``--layout symdia --precond
   jacobi`` on poisson3d_48, ``--layout auto --reorder`` on powerlaw_1138
   (SELL), the float64 ``--layout auto`` tester on poisson2d_34 twice
   (bitwise); CG on symdia-big in both storages for 64 timed steps (the
   full one on ``dia_spmv``, the symmetric one on the tiled kernel 10,
   poisson3d_48's symdia tester on sym_dia_spmv: the route by shape); a
   float32 DIA solve twice (bitwise) and against the plain versions on the
   CPU (trajectory, with and without residual replacement).
   Then the stencil path, with its own reset and read: the tester on
   ``stencil:64`` float32 (the fused stencil CG), on ``stencil:48``
   float64 twice (bitwise), and with ``--precond jacobi`` and ``--precond
   amg`` (both smoothers); at 256^3 the fused stencil CG for 256 timed
   steps (and its busy share over 64), the portable loop, and bench.py's
   mgpcg comparison (plain fused CG against MG-PCG with each smoother, to
   1e-5 ||b||); residual replacement against the CPU's plain versions on
   64^3 and a ragged 33 x 35 x 37 grid; one x0 warm start; 32 steps of
   the portable loop on the ragged grid (kernel 11's register march).
   Every path prints kernel 11's launches on each route.
   Then the MINRES path, with its own reset and read: the tester with
   ``--method minres`` on poisson3d_48 (symbell and bell, float32, with and
   without Jacobi), once with ``--shift`` inside the spectrum, and on CSR
   float64 twice (bitwise); the n = 262,144 operator in both storages for
   256 timed steps (bench.py's minres protocol, b = arange(1, n+1)/n; the
   dense tiles, no packed launch), the busy share over 64, and the
   portable MINRES loop beside it; poisson3d_48 in both storages on its
   own route (the packed kernel 1) and forced onto the dense tiles:
   ms/it over 256 steps, the busy share over 64, the kernels launched and
   the two routes' 25-step histories; the fused
   solve against the portable loop and twice against itself (bitwise); an
   indefinite solve (shift between the Lanczos Ritz extremes) in both
   storages; caps of 1, 2 and 7 steps against the portable loop; b = 0;
   one x0 warm start.
   Then the BiCGStab path, with its own reset and read: the tester with
   ``--method bicgstab`` on the general ``problems/convdiff_34.mtx`` (bell
   float32, dia float32 with Jacobi, auto, CSR float64 twice, bitwise),
   each float32 line run again through ``bicgstab_solve`` on the card (the
   same history; its true residual held to the residual-gap law that a
   sweep of renumbered host solves reads) and on the host (where the two
   trajectories part);
   ``bicgstab_solve(fused="always")`` on the bicgstab-bell operator, which
   ends in a few steps (dense tiles: the dense kernels 18 and 19), against
   the portable loop's flags; the steady-state timing on bench.py's
   convection-diffusion operator at nx = 512 (n = 262,144) as full 128 x
   128 blocked-ELL (sparse tiles: the packed kernels 18 and 19), 256 live
   steps at tol = 0, fused and portable, with the busy share and the three
   kernels' device times; the fused solve there on each route
   (``forced_route``), unpreconditioned and with Jacobi: ms/it, the kernels
   launched, and the two routes' 25-step histories;
   the portable loop on bench.py's DIA lane (nx = 2048, n = 4,194,304) for
   64 steps; fused against portable over 25 steps and twice against itself
   (bitwise); the skew breakdown; the half-step exit; caps of 1, 2 and 7;
   b = 0; one x0 warm start.
   Then the sharded path, with its own reset and read: ``sharded_cg_solve``
   on the n = 262,144 operator split into 4 and 8 shards on the card (the
   in-process shard group): the fused CG for 256 steps at each P beside the
   single-card fused CG (ms/it, effective GB/s on the same 413.1 MB/it, the
   busy share over 64 steps and each kernel's device ms/it), the fused
   Jacobi PCG at P = 4, the fused MINRES at P = 4 and 8, the fused CG and
   MINRES at P = 8 on bf16 shards (kernels 6 and 17's bf16 forms), the
   portable sharded CG at P = 4;
   the fused sharded CG against the single-card one over 25 steps and twice
   against itself (bitwise); the float64 portable sharded CG on poisson3d_48
   (``partition_csr_rows``, P = 4) against ``cg_solve`` (equal iterations, x
   to 1e-11); sharded MINRES on indefinite operators against
   ``minres_solve``; caps of 1, 2 and 7; b = 0; one x0 warm start.
   Then the GMRES / preconditioner / API path, with its own reset and
   read: GMRES(32) on bench.py's convection-diffusion DIA lane (nx = 1024,
   n = 1,048,576, 5 diagonals: kernel 7's ``dia_spmv_rows``) for 128 inner
   steps at tol = 0 (4 cycles, the Givens estimates not rising within a
   cycle, info.rnorm against ||b - Ax|| recomputed on the card and in
   float64; ms per step, bench.py's byte model over the copy rate of
   ``utils.hbm_bandwidth_gbps``, the busy share, the Givens chain's share
   timed alone, ``utils.memory_stats``); GMRES(32) on convdiff-512 as
   128 x 128 blocked-ELL (packed kernel 5) for 128 steps against the same
   float32 solve on the CPU (``trajectory_ok``, the final true residual to
   1e-3); Chebyshev PCG (degree 8, ``estimate_spectral_bounds``) on the
   256^3 stencil (``stencil7_staged``) to 1e-5 ||b|| beside plain CG, in fewer
   iterations; block-Jacobi PCG (b = 8) through the tester on poisson3d_48
   ``--layout auto`` (DIA: kernel 7 for A and for the apply); the
   reference's object API (``CG.createCG(torch.float32)``) on poisson3d_48's
   host CSR arrays; ``run_cg`` in 4 chunks of 64 steps through a checkpoint
   file (``save_state`` / ``load_state``) on the fused CG at n = 262,144 in
   both storages, and in chunks of 64 on the portable DIA CG on
   poisson3d_48, each history hash equal to one uninterrupted solve's; the
   tester's ``--estimate-steps`` and ``--progress 64``.
   Then the multi-RHS path, with its own reset and read (the ``*_multi``
   SpMVs are plain torch, as in the JAX package; the path's kernels are
   ``stencil7_staged`` and ``dia_spmv_rows``): ``bell_spmv_multi`` on bench.py's
   batched operator (n = 131,072, 128 x 128, float32) at R = 1, 8 and 32,
   each column within 1e-5 of max|Y| of kernel 5 on that column, timed
   beside R launches of kernel 5; ``sym_bell_spmv_multi`` on the n =
   262,144 symmetric tiles the same way against kernel 5 on the full
   tiles, two calls bit-identical; ``cg_solve_batched`` with 8 seeded
   lanes in float64 on poisson3d_48 (bell), each lane's iterations equal
   to its solo solve's and its history within 1e-10 relative, and in
   float32 on the n = 262,144 symmetric tiles (ms a step, the busy share;
   the trajectory against solo solves there and on the sharded path's cut
   copy); the tester with ``--precond blockjacobi --nrhs 8`` on
   poisson3d_48 as DIA (kernel 7 for each column's apply) and on
   ``stencil:128 --nrhs 4`` (each lane the solo loop, kernel 11);
   ``block_cg_solve`` on the float64 lanes against the lockstep's counts,
   with its host reads a block iteration; ``minres_solve_batched`` (on the
   symmetric peclet-0 grid), ``bicgstab_solve_batched`` and
   ``gmres_solve_batched`` (restart 32) with 4 lanes on the 512 x 512
   convection-diffusion grid as DIA, lane 0 against the solo solve, ms a
   step; ``run_batched_cg`` in chunks of 64 through a checkpoint file,
   its history hash equal to one uninterrupted batched solve's.
   Then the pipelined / s-step path, with its own reset and read (its
   kernels: ``bell_spmv``, ``dia_spmv_rows``, ``sym_dia_spmv``,
   ``stencil7_staged``): ``cg_solve(fused="never")``, ``pipelined_cg_solve`` and
   ``sstep_cg_solve`` at s = 2 and 4, 256 float32 steps each at tol = -1
   on the n = 262,144 full-storage tiles (kernel 5; on the cut copy if the
   pipelined loop stops early there), each required to make every step:
   ms/it, effective GB/s, the busy share, launches a step and host reads a
   step or block; float64 poisson3d_48 on CSR and DIA (pipelined, Jacobi
   GV, s = 2 and 4), each with the CPU's iteration count and its history
   within 1e-10 above a floor, s = 1 with plain CG's count; the tester's
   ``--method pipelined|sstep`` on poisson3d_48 (DIA, symmetric DIA) and
   ``stencil:64`` (plain and with multigrid).  Then the SA-AMG / FSAI path
   (kernel ``dia_spmv_rows``): bench.py's amg lane, poisson2d(512) as
   float32 CSR, b = arange(1, n + 1) / n, tol = 1e-6 ||b||: plain CG,
   Jacobi PCG, SA-AMG PCG with each smoother, FSAI PCG at power 1 and 2
   (host setup, levels and their layouts, iterations, the true residual,
   time to tolerance as the median of 3, the apply's ms and launches, the
   busy share), the AMG and FSAI(1) solves again in float64 to the
   tolerance on the true residual; and GMRES(32) with SA-AMG on DIA levels
   against CSR levels on that system and on convdiff_34.mtx.
   The portable loops end at convergence: the steps launched are counted
   against the iterations for MG-PCG at 256^3, a portable DIA solve, a
   portable BiCGStab solve, a portable sharded CG solve and a lockstep
   block-Jacobi PCG solve.
   The bfloat16 forms of kernels 1, 4, 5, 7, 10, 14, 15 and 17 (bf16 tiles
   or diagonals, float32 vectors; counted as ``<name>_bf16``) are checked
   in phase 2 at their float32 forms' shapes, each bit-equal to the float32
   launch on the widened operands and held to its plain version as the
   float32 form is (q and y of the dense forms and the MINRES dots within
   TOL_Q / TOL_DOT), and timed beside the plain version and the bytes
   bound.  So are the bf16 forms of kernels 18 and 19 (dense on the
   bicgstab-bell operator and at a ragged nrb = 13, bn = 32; packed on
   convdiff-512's bf16 view and on convdiff-37 at bn = 32; with and
   without the Jacobi d, on a first step and a later one, with a NaN alpha
   and omega) and of kernel 6 (the n = 262,144 operator's bf16 shards at
   P = 4 and 8); kernel 11's bf16 form (every op rounded to bf16, as
   torch's ops on a bf16 volume) at 256^3 and on the ragged volumes, bit-
   equal to its plain version with coefficients exact in bf16 and not, and
   to the float32 launch on the widened volume where no op rounds
   (integer-valued input), with its distance from that launch on random
   input in bf16 ulps, the NaN reach, and cuDNN's bf16 conv3d beside it.
   The refine / bf16 path runs bench.py's cg-bf16 lane (fused CG on the
   n = 262,144 tiles in bf16, both storages, beside float32: ms/it and
   effective GB/s on the 413.1 MB/it convention, history hashes), the
   refined solve of that system against fused float32 CG to 1e-6 ||b||,
   refined solves on poisson3d_48 (``--layout auto``: DIA; 128 x 128
   blocked-ELL: the packed bf16 forms) and elasticity3d_16 (DIA, 99
   diagonals) held to the JAX package's counts (``JAX_REFINE_COUNTS``),
   the portable CG and MINRES loops on the bf16 tiles, and the tester's
   ``--refine bfloat16`` (auto, bell, symbell) and ``--dtype bfloat16``;
   then the portable CG on symdia-big's bf16 SymDIA operator (the tiled
   kernel 10's bf16 form) beside float32, the tester's ``--layout symdia``
   in bf16 and with ``--refine bfloat16`` on poisson3d_48 (one thread a
   row) held to the JAX tester's counts, ``--method minres --dtype
   bfloat16`` on poisson2d_34, the fused MINRES lane in bf16 (n = 262,144,
   both storages, 256 steps) beside float32, ``minres_solve`` on
   poisson3d_48's bf16 tiles in both storages (the packed route) and with a
   NaN tile value (the sticky NaN flag), and the sharded MINRES on bf16
   shards at P = 4 against the single card's bf16 fused MINRES.
   Then the bf16 BiCGStab / sharded / stencil path, with its own reset and
   read: ``bicgstab_solve(fused="always")`` on the bicgstab-bell operator's
   bf16 tiles beside float32 (to 1e-5 ||b||, and at tol = -1, where the
   recurrence reaches 0 and the solve ends at its breakdown exit after a
   few steps, float32 alike), and on convdiff-512's bf16 tiles for 256
   live steps on each route (the packed one, its own, and the dense one,
   forced) beside float32, ms/it best of 3; a NaN tile value in either
   (the sticky breakdown flag after one step); ``sharded_cg_solve``
   (``method="standard"``, plain and Jacobi) on the cut operator's bf16
   shards at P = 4 against the single card's bf16 fused CG / PCG
   (``trajectory_ok``), 64 steps on the n = 262,144 bf16 shards beside
   float32, and a NaN tile value; the tester on ``stencil:256 --dtype
   bfloat16`` and ``stencil:64 --dtype bfloat16 --method minres`` (the
   portable loops on bf16 vectors, kernel 11's bf16 form) beside float32;
   32 steps of the portable CG on a ragged 33 x 35 x 37 bf16 grid (kernel
   11's bf16 register march).  Then the implicit gradients
   (``phase_autodiff_path``, ``AUTODIFF_KERNELS``): ``implicit_cg_solve``
   on the n = 262,144 tiles in both storages (forward and adjoint on
   kernels 1 or 4, and 2) and ``implicit_gmres_solve`` on the 1M-row DIA
   lane (64 steps at tol 0, kernel 7 a forward step), the gradients of
   <c, x> in b and the stored values against float64 on the plain route,
   a central difference along a seeded symmetric direction (the GMRES one
   on a convdiff nx = 64 solve that converges), two backward passes'
   bits, forward and backward ms, launches and the adjoint's count; then
   the sharded layouts (``phase_sharded_layouts_path``,
   ``SHARDED_LAYOUT_KERNELS``): ``sharded_symbell_cg_solve`` at P = 4 and
   8 (CG to 1e-5 ||b|| against the single card's fused CG; standard,
   Jacobi, pipelined, s-step, MINRES, BiCGStab and GMRES for 24 steps on
   the cut operator against the one-card solves, twice bit for bit),
   ``sharded_dia_cg_solve`` (standard, s-step) and
   ``sharded_symdia_cg_solve`` (standard, pipelined) on symdia-big at P =
   4, ``sharded_sell_cg_solve`` on the 1.5M-row power-law pattern at P = 4
   (CG to 1e-5 ||b||, s-step for 24 steps), each with its ms/it and device
   ms a step (host-bound: not judged) and a hash of its history and x.
   Then the rest of ``parallel/`` (``phase_sharded_families_path``,
   ``FAMILY_KERNELS``): the state API (``sharded_cg_init`` /
   ``sharded_run_cg`` on the n = 262,144 shards at P = 4, 64 steps at tol
   = -1; the DIA and SELL siblings on symdia-big and the power-law pattern
   to 1e-5 ||b||), each in chunks through ``save_state`` / ``load_state``
   files, bit for bit the uninterrupted portable solve; the 2-D grid at
   p = 2 (CG to 1e-5 ||b|| on the n = 262,144 operator; standard, Jacobi,
   pipelined and s-step for 24 steps on the cut operator against the
   one-card solves; the group's counters); the batched solves at R = 8
   (lockstep and block CG on the cut operator's P = 4 shards, on
   symdia-big at P = 4 and on the cut operator's 2-D grid, per-lane counts
   against the one-card loops); ``sharded_stencil_cg_solve`` and sharded
   MG-PCG at 256^3, P = 4, against the one-card portable CG and MG-PCG
   (equal counts; kernel 11's launches by route; one shard's product bit
   for bit the one-card product's slice); sharded SA-AMG and FSAI PCG on
   poisson2d(512) at P = 4 against the one-card PCGs (equal counts: the
   float32 preconditioned solves at a tolerance float32 reaches there,
   ``F32_REACHABLE_TOL``, the float64 ones at the full tolerances); each
   sharded call's own launches counted and checked (kernel 5 in the state
   API and 2-D solves, packed kernel 5 in the AMG and FSAI levels, kernel
   7 in the DIA state API, kernel 11 by route in each stencil solve); and
   the sharded LOBPCG (CholQR²) on the eigs lane at P = 4 against the
   one-card LOBPCG, ms an iteration and device ms beside it (host-bound:
   not judged); a hash of each solve's history and x.
   ``--autodiff-only``, ``--sharded-layouts-only`` and
   ``--sharded-families-only`` run one of these paths alone, with its
   launches counted.
4. Check that every kernel launched during its path and that no plain
   version was given a CUDA tensor there; print the kernel table as JSON
   (a kernel's launches summed over the paths that run it).

``python3 chip_smoke.py --fused-cg-only`` runs nothing but the fused
loops and kernels 2, 3 and 16, for comparing two trees on one card (run
beside another tree's package, it gives that tree's numbers): the ms/it
and a hash of each history of the fused CG at n = 262,144 (both storages)
and at 256^3, of the fused Jacobi PCG at n = 262,144 (symmetric storage),
of the fused MINRES there in both storages (history and x), of the fused
CG, PCG and MINRES on poisson3d_48 (the packed route) and of
``sharded_cg_solve`` at P = 4 on the fused kernels (CG, Jacobi PCG and
MINRES; history and x); the fused BiCGStab's hash on the bicgstab-bell
operator and its ms/it and hash (history and x) on convdiff-512 on each
route (the packed one, its own, and the dense one); the portable DIA CG
on poisson3d_48 as ``--layout auto`` loads it (history hash at the
tester's tolerance, ms/it and hash over 256 steps); one hash of each of
kernels 2, 3 and 16 on seeded inputs (at n with the scalar step, there
again on inputs whose squares tie below FLT_MIN, and at n / 8 partials
only), of kernel 20 (at n with the scalar
step, on the tie inputs, and not live) and of kernel 7's y on
poisson3d_48 and symdia-big; their device times (kernels 2, 3 and 16 at
n, with and without the scalar step, 256^3, n / 4 and n / 8; kernel 20 at
n; kernel 7 on both operators, cuSPARSE beside it), and the elementwise
floor; on a tree that has them, the cg-bf16 lane's ms/it and history hash
(full storage) and the refined solve of its system (history and x), and
the fused MINRES at n = 262,144 on bf16 tiles in both storages (ms/it,
history and x), and the fused BiCGStab on the bicgstab-bell operator's
bf16 tiles (history and x) and the sharded fused CG at P = 4 on bf16
shards (ms/it, history and x); one hash a call of kernels 1 and 15 on
the banded landing (outputs and the work's scalars) on seeded inputs, in
float32 and bf16, at n = 262,144 and at a ragged nrb = 13, bn = 64
(``banded_hashes``), and their device times at n = 262,144 beside their
plain versions and bound (``banded_rows``); on a tree with the staged
ring, the ring-depth sweep too; the sharded fused CG and MINRES at P = 8
on float32 and on bf16 shards (history and x); one hash a call of kernels
6 and 17 in float32 and bf16 on the n = 262,144 operator's P = 4 shards 0
and 3 and P = 8 shard 0, and on ragged nrb = 13 shards at bn = 32 and 64
with row_group None and 3 (``sharded_hashes``).

``python3 chip_smoke.py --stencil-only [TREE]`` runs kernel 11 alone: one
hash a call in float32, float64 and bf16 at 256^3, on the small, ragged
and offset (misaligned) volumes of ``stencil_hashes``, with (6, -1), the
bf16-rounded (0.1, -1/3) and in bf16 the float32 (0.1, -1/3); the history
and x of the portable bf16 CG on stencil:256 (the tester's), float32
MG-PCG and Chebyshev PCG at 256^3; the ``-Xptxas -v`` report and the
``cuobjdump -sass`` counts of conversion, bf16-pair, arithmetic, load and
store instructions of each kernel-11 function; a launch's device time at
256^3 (one volume, and four volumes taken in turn so that L2 cannot hold
the input) and at each V-cycle level (128^3 .. 16^3) in the three types,
staged and register march forced beside each other; one V-cycle apply's
device time; the portable bf16 CG on stencil:256 (ms/it and device ms a
step); the staged kernel's ring depth and x-chunk sweep.  Given the
root of another checkout (TREE), its kernels run beside this tree's in
the same process (TREE's, this tree's, this tree's, TREE's), and its
``stencil.cu`` is compiled beside this one for the report and counts.

``python3 chip_smoke.py --dia-only [TREE]`` runs kernels 7 and 10 alone:
one hash a call on each route in float32 and bf16 (each y held to the plain
version, each bf16 y to the float32 launch on the widened diagonals) on the
operators of phase 2 (symdia-big, poisson3d_48, a 27-point stencil, a
ragged n = 110,591, x at an offset of 1, ragged n = 1001 with offsets 0, 3,
300 and a NaN, dense_256, a rectangular 1001 x 1300, negative offsets only,
offsets past n, -0 terms); the history and x of four portable solves (the
SymDIA CG on poisson3d_48 in float32 and bf16, the bf16 SymDIA CG on
symdia-big, the bf16 DIA CG on poisson3d_48); the ``-Xptxas -v`` report and
``cuobjdump -sass`` counts of ``dia_spmv.cu``; device ms a call of kernel 10
on symdia-big and poisson3d_48 and of kernel 7 on poisson3d_48 in both
types, and of a step of the bf16 SymDIA CG on symdia-big; and the sweep of
the tiled kernel's tile height and ring depth.  Given the root of another checkout (TREE), its
package is imported beside this one: its hashes are printed and held equal
to this tree's, and its calls are timed in turns with this tree's (TREE's,
this tree's, this tree's, TREE's).

``python3 chip_smoke.py --sharded-only [TREE]`` runs kernels 6 and 17
alone: the ``-Xptxas -v`` report, their ring's geometry and depth sweep
(on a tree that has it), and their device times at P = 4 and 8 in both
forms beside their plain versions and bound; given the root of another
checkout of this repository (TREE), that tree's kernels are built from its
own sources, opened beside this tree's and timed in the same process on
the same inputs, in turns (TREE's, this tree's, this tree's, TREE's).

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the package beside this script, it exits non-zero and prints no
result.  Times are CUDA-event times, and kernel device times from
torch.profiler, on this card.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import io
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FUSED_SOURCE = "conjugategradient_tpu_torch/csrc/fused_cg.cu"
MINRES_SOURCE = "conjugategradient_tpu_torch/csrc/fused_minres.cu"
BICGSTAB_SOURCE = "conjugategradient_tpu_torch/csrc/fused_bicgstab.cu"
SOURCES = {
    "sym_fused_dir_spmv_dot": FUSED_SOURCE,
    "fused_dir_spmv_dot": FUSED_SOURCE,
    "fused_update_dot": FUSED_SOURCE,
    "fused_update_dot_pcg": FUSED_SOURCE,
    "bell_spmv": "conjugategradient_tpu_torch/csrc/bell_spmv.cu",
    "dia_spmv": "conjugategradient_tpu_torch/csrc/dia_spmv.cu",
    "dia_spmv_rows": "conjugategradient_tpu_torch/csrc/dia_spmv.cu",
    "sym_dia_spmv": "conjugategradient_tpu_torch/csrc/dia_spmv.cu",
    "stencil7": "conjugategradient_tpu_torch/csrc/stencil.cu",
    "stencil7_staged": "conjugategradient_tpu_torch/csrc/stencil.cu",
    "fused_stencil_dir_dot": "conjugategradient_tpu_torch/csrc/fused_stencil.cu",
    "minres_dir_spmv_dot": MINRES_SOURCE,
    "sym_minres_dir_spmv_dot": MINRES_SOURCE,
    "minres_update_dot": MINRES_SOURCE,
    "bicgstab_dir_spmv_dot": BICGSTAB_SOURCE,
    "bicgstab_s_spmv_dot": BICGSTAB_SOURCE,
    "bicgstab_update_dot": BICGSTAB_SOURCE,
    "bell_spmv_dot": FUSED_SOURCE,
    "minres_shard_spmv_dot": MINRES_SOURCE,
    "bell_spmv_packed": "conjugategradient_tpu_torch/csrc/bell_spmv.cu",
    "fused_dir_spmv_dot_packed": FUSED_SOURCE,
    "bicgstab_dir_spmv_dot_packed": BICGSTAB_SOURCE,
    "bicgstab_s_spmv_dot_packed": BICGSTAB_SOURCE,
    "minres_dir_spmv_dot_packed": MINRES_SOURCE,
    "sym_minres_dir_spmv_dot_packed": MINRES_SOURCE,
    "sym_fused_dir_spmv_dot_packed": FUSED_SOURCE,
    "sym_dia_spmv_tiled": "conjugategradient_tpu_torch/csrc/dia_spmv.cu",
    "sym_dia_spmv_rows": "conjugategradient_tpu_torch/csrc/dia_spmv.cu",
}
REPLACES = {
    "sym_fused_dir_spmv_dot": "conjugategradient_tpu/ops/pallas/fused_cg.py:338",
    "fused_dir_spmv_dot": "conjugategradient_tpu/ops/pallas/fused_cg.py:111",
    "fused_update_dot": "conjugategradient_tpu/ops/pallas/fused_cg.py:608 (fused_update_dot), "
                        "conjugategradient_tpu/ops/pallas/fused_stencil.py:150 "
                        "(fused_update_dot_3d)",
    "fused_update_dot_pcg": "conjugategradient_tpu/ops/pallas/fused_cg.py:555",
    "bell_spmv": "conjugategradient_tpu/ops/pallas/ell_spmv.py:57",
    "dia_spmv": "conjugategradient_tpu/ops/pallas/dia_spmv.py:181 (dia_spmv_pallas), "
                "dia_spmv.py:130 (dia_spmv_pallas_2d), "
                "dia_spmv.py:398 (dia_spmv_pallas_blocked)",
    "sym_dia_spmv": "conjugategradient_tpu/ops/pallas/dia_spmv.py:304",
    # the by-value kernel 7: the same function as dia_spmv, up to 32 diagonals
    "dia_spmv_rows": "conjugategradient_tpu/ops/pallas/dia_spmv.py:181 (dia_spmv_pallas), "
                     "dia_spmv.py:130 (dia_spmv_pallas_2d), "
                     "dia_spmv.py:398 (dia_spmv_pallas_blocked)",
    "stencil7": "conjugategradient_tpu/ops/pallas/stencil.py:136",
    # kernel 11's staged kernel: the same function (its route by shape, dtype
    # and alignment; ops/cuda/stencil.stencil_route)
    "stencil7_staged": "conjugategradient_tpu/ops/pallas/stencil.py:136",
    "fused_stencil_dir_dot": "conjugategradient_tpu/ops/pallas/fused_stencil.py:69",
    "minres_dir_spmv_dot": "conjugategradient_tpu/ops/pallas/fused_minres.py:113",
    "sym_minres_dir_spmv_dot": "conjugategradient_tpu/ops/pallas/fused_minres.py:298",
    "minres_update_dot": "conjugategradient_tpu/ops/pallas/fused_minres.py:425",
    "bicgstab_dir_spmv_dot": "conjugategradient_tpu/ops/pallas/fused_bicgstab.py:84",
    "bicgstab_s_spmv_dot": "conjugategradient_tpu/ops/pallas/fused_bicgstab.py:200",
    "bicgstab_update_dot": "conjugategradient_tpu/ops/pallas/fused_bicgstab.py:293",
    "bell_spmv_dot": "conjugategradient_tpu/ops/pallas/fused_cg.py:467",
    "minres_shard_spmv_dot": "conjugategradient_tpu/ops/pallas/fused_minres.py:528",
    # the packed kernels compute the same functions as 5, 4, 18, 19, 14 and
    # 15 on sparse tiles (14 and 15: one kernel on either storage's view)
    "bell_spmv_packed": "conjugategradient_tpu/ops/pallas/ell_spmv.py:57",
    "fused_dir_spmv_dot_packed": "conjugategradient_tpu/ops/pallas/fused_cg.py:111",
    "bicgstab_dir_spmv_dot_packed": "conjugategradient_tpu/ops/pallas/fused_bicgstab.py:84",
    "bicgstab_s_spmv_dot_packed": "conjugategradient_tpu/ops/pallas/fused_bicgstab.py:200",
    "minres_dir_spmv_dot_packed": "conjugategradient_tpu/ops/pallas/fused_minres.py:113",
    "sym_minres_dir_spmv_dot_packed": "conjugategradient_tpu/ops/pallas/fused_minres.py:298",
    # packed kernel 4 on symmetric storage's view of D + U + U^T: kernel 1's
    # function on sparse tiles; the tiled and by-value kernels 10, the same
    # function as sym_dia_spmv
    "sym_fused_dir_spmv_dot_packed": "conjugategradient_tpu/ops/pallas/fused_cg.py:338",
    "sym_dia_spmv_tiled": "conjugategradient_tpu/ops/pallas/dia_spmv.py:304",
    "sym_dia_spmv_rows": "conjugategradient_tpu/ops/pallas/dia_spmv.py:304",
}
# the bfloat16-tile forms of kernels 1, 4, 5, 6, 7, 10, 14, 15, 17, 18 and 19
# (float32 vectors) and the bf16-volume form of kernel 11: the same sources
# and the same TPU kernels, which take bf16 operands too
for _name in ("sym_fused_dir_spmv_dot", "fused_dir_spmv_dot", "bell_spmv", "dia_spmv",
              "dia_spmv_rows", "bell_spmv_packed", "fused_dir_spmv_dot_packed",
              "sym_fused_dir_spmv_dot_packed", "sym_dia_spmv", "sym_dia_spmv_tiled",
              "sym_dia_spmv_rows", "minres_dir_spmv_dot", "minres_dir_spmv_dot_packed", "sym_minres_dir_spmv_dot",
              "sym_minres_dir_spmv_dot_packed", "minres_shard_spmv_dot",
              "bicgstab_dir_spmv_dot", "bicgstab_dir_spmv_dot_packed", "bicgstab_s_spmv_dot",
              "bicgstab_s_spmv_dot_packed", "bell_spmv_dot", "stencil7", "stencil7_staged"):
    SOURCES[f"{_name}_bf16"] = SOURCES[_name]
    REPLACES[f"{_name}_bf16"] = REPLACES[_name]
BLOCKED_KERNELS = ("sym_fused_dir_spmv_dot", "fused_dir_spmv_dot", "fused_update_dot",
                   "fused_update_dot_pcg", "bell_spmv", "bell_spmv_packed",
                   "fused_dir_spmv_dot_packed", "sym_fused_dir_spmv_dot_packed")
DIA_KERNELS = ("dia_spmv", "dia_spmv_rows", "sym_dia_spmv", "sym_dia_spmv_tiled",
               "sym_dia_spmv_rows")
STENCIL_KERNELS = ("stencil7", "stencil7_staged", "fused_stencil_dir_dot", "fused_update_dot")
MINRES_KERNELS = ("minres_dir_spmv_dot", "sym_minres_dir_spmv_dot", "minres_update_dot",
                  "bell_spmv", "bell_spmv_packed", "minres_dir_spmv_dot_packed",
                  "sym_minres_dir_spmv_dot_packed")
BICGSTAB_KERNELS = ("bicgstab_dir_spmv_dot", "bicgstab_s_spmv_dot", "bicgstab_update_dot",
                    "bell_spmv", "dia_spmv_rows", "bell_spmv_packed",
                    "bicgstab_dir_spmv_dot_packed", "bicgstab_s_spmv_dot_packed")
SHARDED_KERNELS = ("bell_spmv_dot", "minres_shard_spmv_dot", "fused_update_dot",
                   "fused_update_dot_pcg", "minres_update_dot", "bell_spmv")
# the H100 SXM's published peaks (NVIDIA data sheet, 700 W): HBM3 rate, and
# float32 and float64 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_F64_PER_S = 34e12
# BASELINE config 4: the 7-point Poisson stencil on a 256^3 grid
STENCIL_GRID = (256, 256, 256)
STENCIL_SMALL = ((5, 6, 7), (3, 9, 130), (2, 2, 2))
STENCIL_STEPS = 256
F32_TRUE_REL_FLOOR = 2e-2  # ||b - Ax|| / ||b|| after a float32 256^3 solve
# the JAX package's symdia-big operator (bench.py bench_symdia_big)
SYMDIA_N = 1 << 21
SYMDIA_OFFSETS = tuple(k * 1024 for k in range(21))
DIA_STEPS = 64
# stated tolerances (f32 sum order differs between kernel and plain version)
TOL_ELEMWISE = 1e-6  # p_new, x', r': rtol of max|plain|
TOL_Q = 1e-5  # q: of max|q|
TOL_DOT = 1e-5  # pap, rnorm, rho: relative
TOL_SOLVE_REL = 1e-5  # solve tolerance: 1e-5 * ||b||
REL_ERROR_BOUND = 1e-8  # tester rel_error = ||b - Ax||^2 / ||x||^2
TRAJ_RTOL = 5e-2  # fused vs plain rho_history over 25 steps
PARITY_MIN_USED = 10  # sharded vs one card: entries above the float32 floor
RESTART_RTOL = 2e-3  # card vs CPU plain versions, 32 steps with restarts
RESTART_EVERY = 8
ITER_SLACK = 8
TAIL_ULPS = 2  # the kernels' scalar steps against torch 0-d ops, per slot
MINRES_TRAJ_RTOL = 5e-3  # fused vs portable MINRES rnorm_history over 25 steps
MINRES_STEPS = 256
# an indefinite float32 solve to 1e-4 ||b||: the true residual may exceed the
# estimate by this factor (MINRES loses ~eps * kappa^2 in its w recurrence)
MINRES_INDEF_TOL_REL = 1e-4
MINRES_TRUE_FACTOR = 10.0
# a portable loop launches at most this many steps after the one that set
# done (solver/restart.py: LOOKAHEAD - 1)
STEPS_AFTER_DONE = 3
# BiCGStab: bench.py:1367's operator ends in ~4 steps (kappa ~ 1.015); the
# timed convection-diffusion runs BICG_STEPS live steps at tol = 0
BICG_BENCH_MAX_K = 4
BICG_STEPS = 256
BICG_DIA_STEPS = 64
# fused vs portable BiCGStab rnorm_history over 25 f32 steps: 5e-3 over the
# first 10 (the JAX package's bound for its two loops), 5e-2 over steps
# 11-15, and finite after: the two loops' sums run in another order and its
# products amplify that.  On the card, convdiff nx=512 parts by 1.2e-2 at
# step 21 and then spikes (273 against 12.2 at step 23); nx=64 by 3e-3 at
# step 15, 1.4e-2 at 16, 0.11 at 19
BICG_TRAJ_RTOL = 5e-3
BICG_TRAJ_MID_RTOL = 5e-2
# float32 BiCGStab's true residual stalls at the residual gap, a multiple
# of eps * max_k ||r_k||: the recurrence can spike to hundreds of ||b|| on
# convdiff_34, and where it does rel_error = ||b - Ax||^2 / ||x||^2 rises
# with the square of the spike.  bicg_gap_sweep reads the multiple on the
# host, over the tester's system with its unknowns renumbered (every sum
# then rounds another way), and each float32 tester line is held to
# REL_ERROR_BOUND, or where its own recurrence spiked to the gap law with
# GAP_ULPS (the run's true residual within tol + GAP_ULPS eps max_k ||r_k||)
GAP_ULPS = 64
GAP_SEEDS = 32
CONVDIFF = "problems/convdiff_34.mtx"
N_BIG = 262_144
MATRICES = ("problems/poisson3d_48.mtx", "problems/elasticity3d_16.mtx")
DEVICE = "cuda:0"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    import torch

    for _ in range(warm):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(fn, reps: int = 10, tries: int = 3):
    """Device time per call: the sum of the CUDA kernels' own times in a
    torch.profiler trace of ``reps`` calls, or None if ``tries`` traces in
    a row hold no device time (a trace of this card now and then comes
    back empty)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = 0.0
        for e in prof.key_averages():
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                total_us += getattr(e, "self_device_time_total", None) or \
                    getattr(e, "self_cuda_time_total", 0.0)
        if total_us > 0:
            return total_us / 1e3 / reps
    return None


def kernel_profile(fn, top: int = 4):
    """One call under torch.profiler: (device ms, kernels launched, the
    ``top`` kernels by device time as (name, ms, count)), or None if the
    trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
            rows.append((e.key, us / 1e3, e.count))
    if not rows or sum(r[1] for r in rows) <= 0:
        return None
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), sum(r[2] for r in rows), rows[:top]


def time_pair(kernel_fn, plain_fn) -> dict:
    """Kernel and plain version timed in turns (plain, kernel, kernel,
    plain): CUDA-event time per call (host work included) and profiler
    device time per call.  ``ms``/``plain_ms`` are the device times when the
    profiler saw them, else the event times."""
    ev = [cuda_ms(f) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn)]
    dk, dp = device_ms(kernel_fn), device_ms(plain_fn)
    ek, ep = min(ev[1], ev[2]), min(ev[0], ev[3])
    return {"ms": dk if dk is not None else ek,
            "plain_ms": dp if dp is not None else ep,
            "event_ms": ek, "plain_event_ms": ep,
            "device_ms": dk, "plain_device_ms": dp}


def rel_max_err(a, b) -> tuple:
    """(max |a - b|, max |b|)."""
    d = float((a.double() - b.double()).abs().max())
    return d, float(b.double().abs().max())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(moved: int, flops: int, peak_flops: float = PEAK_F32_PER_S) -> dict:
    """The least time the card could take for a call: its bytes (each input
    read once, each output written once) over the HBM rate, or its
    operations over the rate for their type (float32 unless given),
    whichever is larger."""
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def needed_bound(nnz: int, vec_bytes: int) -> float:
    """The least time for a sparse-tile kernel's function on what its
    inputs need: a 4-byte value and a 4-byte int32 column per nonzero, and
    the vectors it reads and writes, each once, over the HBM rate (ms)."""
    return (8 * nnz + vec_bytes) / PEAK_BYTES_PER_S * 1e3


def library_ms(fn) -> float:
    """One PyTorch call's time, as ``time_pair`` reports a kernel's: device
    time when the profiler sees it, else CUDA-event time."""
    dm = device_ms(fn)
    return dm if dm is not None else cuda_ms(fn)


def csr_from_dia(a):
    """A DIA operator's nonzeros as a torch sparse CSR tensor (rows in
    order, columns ascending): the cuSPARSE yardstick's operand."""
    import torch

    n, ncols = a.shape
    cols = torch.arange(n, device=a.device)[:, None] + a.offsets_dev.long()[None, :]
    vals = a.diags.t()  # (n, ndiag): row i's entries in ascending column order
    keep = (cols >= 0) & (cols < ncols) & (vals != 0)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=a.device)
    crow[1:] = keep.sum(dim=1).cumsum(0)
    return torch.sparse_csr_tensor(crow.int(), cols[keep].int(), vals[keep], (n, ncols))


def csr_from_bell(a):
    """A full blocked-ELL operator's nonzeros as a torch sparse CSR tensor."""
    import torch

    nrb, kmax, bm, bn = a.blocks.shape
    n, ncols = a.shape
    dev = a.device
    order = torch.argsort(a.block_cols.long(), dim=1, stable=True)
    bcols = torch.gather(a.block_cols.long(), 1, order)
    vals = a.blocks[torch.arange(nrb, device=dev)[:, None], order].permute(0, 2, 1, 3)
    cols = (bcols[:, None, :, None] * bn
            + torch.arange(bn, device=dev)[None, None, None, :]).expand(nrb, bm, kmax, bn)
    keep = ((vals != 0) & (cols < ncols)).reshape(nrb * bm, kmax * bn)[:n]
    vals = vals.reshape(nrb * bm, kmax * bn)[:n]
    cols = cols.reshape(nrb * bm, kmax * bn)[:n]
    crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    crow[1:] = keep.sum(dim=1).cumsum(0)
    return torch.sparse_csr_tensor(crow.int(), cols[keep].int(), vals[keep], (n, ncols))


def library_spmv(csr, x, y_kernel, label) -> float:
    """Time ``csr @ x`` (one cuSPARSE SpMV) and check it computes what the
    kernel computed, to TOL_Q of max|y| (another summation order)."""
    y = csr @ x
    e, m = rel_max_err(y, y_kernel)
    check(e <= TOL_Q * m, f"library SpMV {label}: differs from the kernel by {e} (max {m})")
    return library_ms(lambda: csr @ x)


# ---- phase 2: kernels against their plain versions -------------------------

def block_tridiag_ops(n, bn, device):
    """The n-row block-tridiagonal operator in full and in symmetric
    storage, from the same host tiles."""
    import torch

    from conjugategradient_tpu_torch.problems import block_tridiag_tiles
    from conjugategradient_tpu_torch.types import BlockedEllMatrix, SymBellMatrix

    blocks, cols, nnz = block_tridiag_tiles(n, bn, bn, seed=0)
    full = BlockedEllMatrix(torch.from_numpy(blocks).to(device),
                            torch.from_numpy(cols).to(device), (n, n), nnz)
    sym = SymBellMatrix._pack_np(blocks, cols.astype(np.int64), (n, n), (n, n),
                                 nnz, check=False, device=device)
    return full, sym


def split_tridiag_tiles(n, n_shards, bn=128, seed=0):
    """``problems.block_tridiag_tiles(n)`` split by block-rows into shards:
    (n_shards, nrb / n_shards, 3, bn, bn) tiles and (n_shards, nrb /
    n_shards, 3) GLOBAL column blocks (numpy views, no copy).  The sharded
    path's operator: building the CSR of ~100 M nonzeros to partition it
    would take most of a minute on the host, and the CPU tests hold this
    split equal, as an operator, to ``partition_csr_rows`` on that CSR."""
    from conjugategradient_tpu_torch.problems import block_tridiag_tiles

    blocks, cols, _ = block_tridiag_tiles(n, bn, bn, seed=seed)
    nrb = blocks.shape[0]
    if nrb % n_shards:
        raise ValueError(f"{nrb} block-rows do not split into {n_shards} shards")
    return (blocks.reshape(n_shards, nrb // n_shards, 3, bn, bn),
            cols.reshape(n_shards, nrb // n_shards, 3))


def cut_tridiag_ops(blocks4, cols4, nnz, seed=11):
    """The sharded path's operator with its diagonal tiles cut to
    rho_off * (2.05 + 0.5 u) I, u uniform per row (seeded), rho_off the
    coupling tile's spectral radius: SPD (the couplings add at most
    2 rho_off) with a condition number of at most 91 and a diagonal that
    varies by row, so CG and Jacobi PCG stay above the float32 floor for
    about 20 of 25 steps (the original diagonal, ~1000 times the coupling,
    ends CG in two).  Returns the one-card full-storage matrix, the P = 4
    and P = 8 shard views of the same tiles, and 1/diag."""
    import torch

    from conjugategradient_tpu_torch.types import BlockedEllMatrix

    n_shards, nrb, _, bn, _ = blocks4.shape
    n = n_shards * nrb * bn
    rho_off = float(np.abs(np.linalg.eigvalsh(blocks4[0, 0, 1].double().cpu().numpy())).max())
    d = torch.as_tensor(rho_off * (2.05 + 0.5 * np.random.default_rng(seed).random(n)),
                        dtype=torch.float32, device=blocks4.device)
    cut = blocks4.clone()
    cut[:, :, 0] = torch.diag_embed(d.view(n_shards, nrb, bn))
    full = BlockedEllMatrix(cut.view(-1, 3, bn, bn), cols4.reshape(-1, 3), (n, n), nnz)
    ops = {4: (cut, cols4), 8: (cut.view(8, -1, 3, bn, bn), cols4.view(8, -1, 3))}
    return full, ops, 1.0 / d


def random_block_csr(rng, nrb, bm, bn, per_row, ncols=None):
    """Random block-sparse host CSR: SPD with square bn tiles (the shape of
    tests/test_symbell.py's _random_block_sym) when ``ncols`` is None, else
    a general (nrb*bm, ncols) pattern of bm x bn tiles."""
    n = nrb * bm
    A = np.zeros((n, n if ncols is None else ncols), np.float32)
    for i in range(nrb):
        if ncols is None:
            D = rng.standard_normal((bn, bn)).astype(np.float32)
            A[i * bn:(i + 1) * bn, i * bn:(i + 1) * bn] = D + D.T + 4 * bn * np.eye(bn, dtype=np.float32)
            hi = np.arange(i + 1, nrb)
            for c in rng.choice(hi, size=min(per_row, len(hi)), replace=False):
                B = rng.standard_normal((bn, bn)).astype(np.float32)
                A[i * bn:(i + 1) * bn, c * bn:(c + 1) * bn] = B
                A[c * bn:(c + 1) * bn, i * bn:(i + 1) * bn] = B.T
        else:
            for c in rng.choice(-(-ncols // bn), size=per_row, replace=False):
                hi = min((c + 1) * bn, ncols)
                A[i * bm:(i + 1) * bm, c * bn:hi] = rng.standard_normal((bm, hi - c * bn))
    rows, cols = np.nonzero(A)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    return A[rows, cols], cols, indptr, A.shape


def random_block_sym(rng, nrb, bn, per_row, device):
    from conjugategradient_tpu_torch.types import SymBellMatrix
    from conjugategradient_tpu_torch.types.bell import pack_host_arrays

    data, cols, indptr, shape = random_block_csr(rng, nrb, bn, bn, per_row)
    blocks, bcols, nnz = pack_host_arrays(data, cols, indptr, shape, bn, bn)
    return SymBellMatrix._pack_np(blocks, bcols.astype(np.int64), shape, shape,
                                  nnz, check=True, device=device)


def random_block_full(rng, nrb, bm, bn, per_row, device, ncols=None):
    from conjugategradient_tpu_torch.types import BlockedEllMatrix

    data, cols, indptr, shape = random_block_csr(rng, nrb, bm, bn, per_row, ncols)
    return BlockedEllMatrix.from_csr_host(data, cols, indptr, shape, bm=bm, bn=bn,
                                          device=device)


def load_symbell(path, device):
    from conjugategradient_tpu_torch import load_matrix

    return load_matrix(os.path.join(ROOT, path), layout="symbell",
                       dtype=np.float32, bn=128, device=device)


def load_bell(path, device, bm=128, bn=128):
    from conjugategradient_tpu_torch import load_matrix

    return load_matrix(os.path.join(ROOT, path), layout="bell",
                       dtype=np.float32, bm=bm, bn=bn, device=device)


def padded_inv_diag(a, rows):
    """1 / diag(A) padded with 1 to ``rows`` entries."""
    import torch

    d = (1.0 / a.diagonal().float()).reshape(-1)
    return torch.nn.functional.pad(d, (0, rows - d.numel()), value=1.0)


def check_k1(a, rng, mirror, with_d, row_group, errs, label):
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc

    nrb, bn = a.nrb, a.bn
    dev = a.device

    def vec():
        return torch.as_tensor(rng.standard_normal((nrb, bn)), dtype=torch.float32, device=dev)

    r, pold = vec(), vec()
    d = padded_inv_diag(a, nrb * bn).reshape(nrb, bn) if with_d else None
    beta = torch.tensor([[0.37]], dtype=torch.float32, device=dev)
    pk, qk, papk = fc.sym_fused_dir_spmv_dot(
        a.diag_blocks, a.off_blocks, a.off_cols, r, pold, beta, d,
        mirror=mirror, row_group=row_group, mirror_src=a.mirror_src)
    pp, qp, papp = fc._sym_dir_plain(a.diag_blocks, a.off_blocks, a.off_cols, r, pold,
                                     beta, d, a.mirror_src, None, None)
    torch.cuda.synchronize()
    e_p, m_p = rel_max_err(pk, pp)
    e_q, m_q = rel_max_err(qk, qp)
    e_pap = abs(float(papk) - float(papp))
    check(e_p <= TOL_ELEMWISE * m_p, f"K1 {label}: p_new err {e_p} vs max {m_p}")
    check(e_q <= TOL_Q * m_q, f"K1 {label}: q err {e_q} vs max|q| {m_q}")
    check(e_pap <= TOL_DOT * abs(float(papp)), f"K1 {label}: pap {float(papk)} vs {float(papp)}")
    errs["sym_fused_dir_spmv_dot"] = max(errs["sym_fused_dir_spmv_dot"], e_p, e_q, e_pap)
    print(f"  K1 {label:<34} |dp|={e_p:.3g} |dq|={e_q:.3g} (max|q| {m_q:.4g}) "
          f"|dpap|={e_pap:.3g} (pap {float(papp):.6g})")
    return (r, pold, beta, d)


def check_k4(a, rng, with_d, beta_v, errs, label):
    """Kernel 4 against its plain version: p_new bit for bit, q and pap to
    the stated tolerances."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc

    nrb, bn = a.nrb, a.bn
    dev = a.device

    def vec():
        return torch.as_tensor(rng.standard_normal((nrb, bn)), dtype=torch.float32, device=dev)

    r, pold = vec(), vec()
    d = padded_inv_diag(a, nrb * bn).reshape(nrb, bn) if with_d else None
    beta = torch.tensor([[beta_v]], dtype=torch.float32, device=dev)
    pk, qk, papk = fc.fused_dir_spmv_dot(a.blocks, a.block_cols, r, pold, beta, d)
    pp, qp, papp = fc._full_dir_plain(a.blocks, a.block_cols, r, pold, beta, d, None, None)
    torch.cuda.synchronize()
    e_q, m_q = rel_max_err(qk, qp)
    e_pap = abs(float(papk) - float(papp))
    check(torch.equal(pk, pp), f"K4 {label}: p_new not bit-equal to the plain version")
    check(e_q <= TOL_Q * m_q, f"K4 {label}: q err {e_q} vs max|q| {m_q}")
    check(e_pap <= TOL_DOT * abs(float(papp)), f"K4 {label}: pap {float(papk)} vs {float(papp)}")
    errs["fused_dir_spmv_dot"] = max(errs["fused_dir_spmv_dot"], e_q, e_pap)
    print(f"  K4 {label:<38} p_new bit-equal |dq|={e_q:.3g} (max|q| {m_q:.4g}) "
          f"|dpap|={e_pap:.3g} (pap {float(papp):.6g})")
    return r, pold, beta


def check_k5(a, rng, errs, label):
    """Kernel 5 against its plain version."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import bell_spmv as kb

    x2d = torch.as_tensor(rng.standard_normal((a.padded_shape[1] // a.bn, a.bn)),
                          dtype=torch.float32, device=a.device)
    yk = kb.bell_spmv_tiles(a.blocks, a.block_cols, x2d)
    yp = kb._bell_plain(a.blocks, a.block_cols, x2d)
    torch.cuda.synchronize()
    e, m = rel_max_err(yk, yp)
    check(e <= TOL_Q * m, f"K5 {label}: y err {e} vs max|y| {m}")
    errs["bell_spmv"] = max(errs["bell_spmv"], e)
    print(f"  K5 {label:<38} |dy|={e:.3g} (max|y| {m:.4g}), tiles {a.tile_bytes() / 1e6:.1f} MB")
    return x2d


def check_k5_packed(a, rng, errs, label):
    """Packed kernel 5 against its plain version (built to agree bit for
    bit; held to TOL_Q) and against the dense tiles' plain product, a
    repeat bit-identical.  Returns the operand."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import bell_spmv as kb

    pk = a.packed()
    x = torch.as_tensor(rng.standard_normal(pk.ncols), dtype=torch.float32, device=a.device)
    yk = kb.bell_spmv_packed(pk, x)
    yk2 = kb.bell_spmv_packed(pk, x)
    yp = kb.packed_apply(pk, x)
    yd = kb._bell_plain(a.blocks, a.block_cols, x.view(-1, a.bn))
    torch.cuda.synchronize()
    e, m = rel_max_err(yk, yp)
    ed, md = rel_max_err(yk, yd)
    check(e <= TOL_Q * m, f"K5 packed {label}: y err {e} vs max|y| {m}")
    check(ed <= TOL_Q * md, f"K5 packed {label}: y vs the dense tiles err {ed} vs {md}")
    check(torch.equal(yk, yk2), f"K5 packed {label}: a repeat is not bit-identical")
    errs["bell_spmv_packed"] = max(errs["bell_spmv_packed"], e)
    print(f"  K5 packed {label:<31} |dy|={e:.3g} (bit-equal {torch.equal(yk, yp)}), "
          f"vs dense tiles {ed:.3g}; view {pk.nbytes() / 1e6:.2f} MB for {pk.nnz} "
          f"nonzeros ({pk.vals.numel() / max(pk.nnz, 1):.4f} slots each), tiles "
          f"{a.tile_bytes() / 1e6:.1f} MB")
    return x


def check_k4_packed(a, rng, with_d, beta_v, errs, label):
    """Packed kernel 4 against its plain version: p_new bit for bit, q to
    TOL_Q (built to agree bit for bit), pap to TOL_DOT; a repeat
    bit-identical; q against the dense tiles' plain version to TOL_Q."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc

    pk = a.packed()
    nrb, bn = a.nrb, a.bn

    def vec():
        return torch.as_tensor(rng.standard_normal((nrb, bn)), dtype=torch.float32,
                               device=a.device)

    r, pold = vec(), vec()
    d = padded_inv_diag(a, nrb * bn).reshape(nrb, bn) if with_d else None
    beta = torch.tensor([[beta_v]], dtype=torch.float32, device=a.device)
    k = fc.fused_dir_spmv_dot_packed(pk, r, pold, beta, d)
    k2 = fc.fused_dir_spmv_dot_packed(pk, r, pold, beta, d)
    pl = fc._packed_dir_plain(pk, r, pold, beta, d, None, None)
    qd = fc._full_dir_plain(a.blocks, a.block_cols, r, pold, beta, d, None, None)[1]
    torch.cuda.synchronize()
    e_q, m_q = rel_max_err(k[1], pl[1])
    e_d, _ = rel_max_err(k[1], qd)
    e_pap = abs(float(k[2]) - float(pl[2]))
    check(torch.equal(k[0], pl[0]), f"K4 packed {label}: p_new not bit-equal to the plain version")
    check(e_q <= TOL_Q * m_q, f"K4 packed {label}: q err {e_q} vs max|q| {m_q}")
    check(e_d <= TOL_Q * m_q, f"K4 packed {label}: q vs the dense tiles err {e_d}")
    check(e_pap <= TOL_DOT * abs(float(pl[2])), f"K4 packed {label}: pap {float(k[2])} vs {float(pl[2])}")
    check(all(torch.equal(u, v) for u, v in zip(k, k2)),
          f"K4 packed {label}: a repeat is not bit-identical")
    errs["fused_dir_spmv_dot_packed"] = max(errs["fused_dir_spmv_dot_packed"], e_q, e_pap)
    print(f"  K4 packed {label:<31} p_new bit-equal |dq|={e_q:.3g} (bit-equal "
          f"{torch.equal(k[1], pl[1])}, max|q| {m_q:.4g}) vs dense tiles {e_d:.3g} "
          f"|dpap|={e_pap:.3g}")
    return r, pold, beta, d


def check_k1_packed(a, rng, with_d, beta_v, errs, label):
    """Packed kernel 1 (the packed kernel 4 on symmetric storage's view of
    D + U + U^T) against its plain version: p_new and q bit for bit, pap to
    TOL_DOT; a repeat bit-identical; q against the dense general landing's
    plain version on the tiles to TOL_Q (another summation order)."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.ops.spmv import bell_packed_route

    pk = a.packed()
    check(pk.symmetric and bell_packed_route(a), f"K1 packed {label}: not on the packed route")
    nrb, bn = a.nrb, a.bn

    def vec():
        return torch.as_tensor(rng.standard_normal((nrb, bn)), dtype=torch.float32,
                               device=a.device)

    r, pold = vec(), vec()
    d = padded_inv_diag(a, nrb * bn).reshape(nrb, bn) if with_d else None
    beta = torch.tensor([[beta_v]], dtype=torch.float32, device=a.device)
    name = "sym_fused_dir_spmv_dot_packed"
    before = fc.LAUNCHES[name]
    k = fc.fused_dir_spmv_dot_packed(pk, r, pold, beta, d)
    k2 = fc.fused_dir_spmv_dot_packed(pk, r, pold, beta, d)
    check(fc.LAUNCHES[name] == before + 2, f"K1 packed {label}: counted {fc.LAUNCHES[name] - before}")
    pl = fc._packed_dir_plain(pk, r, pold, beta, d, None, None)
    qd = fc._sym_dir_plain(a.diag_blocks, a.off_blocks, a.off_cols, r, pold, beta, d,
                           a.mirror_src, None, None)[1]
    torch.cuda.synchronize()
    e_q, m_q = rel_max_err(k[1], pl[1])
    e_d, _ = rel_max_err(k[1], qd)
    e_pap = abs(float(k[2]) - float(pl[2]))
    check(torch.equal(k[0], pl[0]), f"K1 packed {label}: p_new not bit-equal to the plain version")
    check(torch.equal(k[1], pl[1]), f"K1 packed {label}: q not bit-equal to the plain version "
                                    f"({e_q} of max|q| {m_q})")
    check(e_d <= TOL_Q * m_q, f"K1 packed {label}: q vs the tiles' landing err {e_d}")
    check(e_pap <= TOL_DOT * abs(float(pl[2])), f"K1 packed {label}: pap {float(k[2])} vs {float(pl[2])}")
    check(all(torch.equal(u, v) for u, v in zip(k, k2)),
          f"K1 packed {label}: a repeat is not bit-identical")
    errs[name] = max(errs[name], e_q, e_pap)
    print(f"  K1 packed {label:<31} p_new, q bit-equal (max|q| {m_q:.4g}) vs the tiles' "
          f"landing {e_d:.3g} |dpap|={e_pap:.3g}; view {pk.nnz} entries")
    return r, pold, beta, d


def crossover(big_full, rng):
    """Packed against dense kernels 4 and 5 on the n = 262,144
    block-tridiagonal tiles with entries zeroed at random, at falling
    fills: where the packed kernels start to win (CUDA-event ms a launch,
    inputs as one solve step has them)."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import bell_spmv as kb
    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.ops.spmv import bell_packed_route
    from conjugategradient_tpu_torch.types import BlockedEllMatrix

    dev = big_full.device
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    x = torch.randn(big_full.padded_shape[1], device=dev, generator=gen)
    r, pold = x.view(-1, big_full.bn), torch.randn_like(x).view(-1, big_full.bn)
    beta = torch.full((1, 1), 0.37, device=dev)
    work = fc.FusedWork.new(dev, maxiter=1 << 20, tol=-1.0)
    out = (torch.empty_like(r), torch.empty_like(r))
    rows = []
    for fill in (1.0, 0.5, 0.4, 0.3, 0.25, 0.15, 0.05):
        keep = torch.rand(big_full.blocks.shape, device=dev, generator=gen) < fill
        blocks = torch.where(keep, big_full.blocks, 0.0) if fill < 1 else big_full.blocks
        nnz = int(torch.count_nonzero(blocks))
        a = BlockedEllMatrix(blocks, big_full.block_cols, big_full.shape, nnz)
        pk = a.packed()
        t5d = cuda_ms(lambda: kb.bell_spmv_tiles(a.blocks, a.block_cols, r))
        t5p = cuda_ms(lambda: kb.bell_spmv_packed(pk, x))
        t4d = cuda_ms(lambda: fc.fused_dir_spmv_dot(a.blocks, a.block_cols, r, pold, beta,
                                                    out=out, work=work))
        t4p = cuda_ms(lambda: fc.fused_dir_spmv_dot_packed(pk, r, pold, beta, out=out,
                                                           work=work))
        rows.append((fill, nnz / big_full.blocks.numel(), t5d, t5p, t4d, t4p,
                     bell_packed_route(a)))
        del a, pk, blocks, keep
    torch.cuda.synchronize()
    return rows


# The design the packed view was weighed against: CSR, one warp per row,
# lanes striding over the row's nonzeros.  A yardstick built and timed
# here only; the port does not carry it.
CSR_YARDSTICK = r"""
extern "C" __global__ void csr_warp_row(const int* __restrict__ ptr,
                                        const int* __restrict__ cols,
                                        const float* __restrict__ vals,
                                        const float* __restrict__ x,
                                        float* __restrict__ y, int rows) {
  const int row = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.f;
  for (int e = ptr[row] + lane; e < ptr[row + 1]; e += 32)
    acc = fmaf(__ldg(vals + e), __ldg(x + __ldg(cols + e)), acc);
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) y[row] = acc;
}
extern "C" int csr_warp_row_launch(const int* ptr, const int* cols, const float* vals,
                                   const float* x, float* y, int rows, void* stream) {
  const long long threads = 256, total = (long long)rows * 32;
  csr_warp_row<<<(unsigned)((total + threads - 1) / threads), (unsigned)threads, 0,
                 (cudaStream_t)stream>>>(ptr, cols, vals, x, y, rows);
  return (int)cudaGetLastError();
}
"""


def csr_yardstick(pk, x):
    """The CSR warp-per-row SpMV on the packed view's nonzeros (put in row
    order here), checked against packed kernel 5 to TOL_Q: its device ms a
    launch."""
    import ctypes

    import torch

    from conjugategradient_tpu_torch.ops.cuda import _build
    from conjugategradient_tpu_torch.ops.cuda import bell_spmv as kb

    out = _build.BUILD_DIR / "csr_yardstick.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = _build.BUILD_DIR / "csr_yardstick.cu"
        src.write_text(CSR_YARDSTICK)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out), str(src)],
                       check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).csr_warp_row_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = x.device
    lens = pk.row_len.long()
    ptr = torch.zeros(pk.rows + 1, dtype=torch.int64, device=dev)
    ptr[1:] = lens.cumsum(0)
    row = torch.repeat_interleave(torch.arange(pk.rows, device=dev), lens)
    k = torch.arange(row.numel(), device=dev) - ptr[row]
    at = pk.chunk_off[row // 32] + 32 * k + row % 32
    vals, cols, ptr32 = pk.vals[at].contiguous(), pk.cols[at].contiguous(), ptr.int()
    y = torch.empty(pk.rows, device=dev)

    def launch():
        return fn(ptr32.data_ptr(), cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(),
                  pk.rows, torch.cuda.current_stream(dev).cuda_stream)

    check(launch() == 0, "CSR yardstick: launch failed")
    e, m = rel_max_err(y, kb.bell_spmv_packed(pk, x))
    check(e <= TOL_Q * m, f"CSR yardstick: y differs from packed kernel 5 by {e} (max {m})")
    return library_ms(launch)


def check_update(shape, rng, pcg, errs, label, dev):
    """Kernel 2 (or 3) against its plain version: x' and r' bit for bit,
    the dots within TOL_DOT."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc

    def vec():
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    x, p, r, q = vec(), vec(), vec(), vec()
    d = vec().abs() + 0.1
    alpha = torch.tensor([[0.61]], dtype=torch.float32, device=dev)
    name = "fused_update_dot_pcg" if pcg else "fused_update_dot"
    if pcg:
        ok = fc.fused_update_dot_pcg(x, p, r, q, d, alpha)
        op = fc._update_plain(name, x, p, r, q, d, alpha, None, None)
    else:
        ok = fc.fused_update_dot(x, p, r, q, alpha)
        op = fc._update_plain(name, x, p, r, q, None, alpha, None, None)
    torch.cuda.synchronize()
    check(torch.equal(ok[0], op[0]) and torch.equal(ok[1], op[1]),
          f"{name} {label}: x' or r' not bit-equal to the plain version")
    worst = 0.0
    for i, what in ((2, "rnorm"), (3, "rho"))[: 2 if pcg else 1]:
        e = abs(float(ok[i]) - float(op[i]))
        check(e <= TOL_DOT * abs(float(op[i])), f"{name} {label}: {what} {float(ok[i])} vs {float(op[i])}")
        worst = max(worst, e)
    errs[name] = max(errs[name], worst)
    print(f"  {name:<21}{label:<14} x', r' bit-equal; max abs err of the dots {worst:.3g}")
    return x, p, r, q, d, alpha


def phase_kernels(dev, big, big_full):
    """Kernels against plain versions; returns (errs, times of the JSON
    table's shapes, times at the other main-path shapes, operators)."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import bell_spmv as kb
    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.types.bell import pack_nonzeros

    rng = np.random.default_rng(0)
    errs = dict.fromkeys(SOURCES, 0.0)
    times, extra = {}, {}
    p3d = load_symbell(MATRICES[0], dev)
    p3d_full = load_bell(MATRICES[0], dev)
    p3d_8 = load_bell(MATRICES[0], dev, bm=8)
    rag_sym = poisson2d_ops(37, 32, dev)[1]
    for label, a in (("tridiag n=262144 full", big_full), ("poisson3d_48 full", p3d_full),
                     ("poisson3d_48 8x128 (load_matrix default)", p3d_8)):
        print(f"  {label}: tiles {tuple(a.blocks.shape)}, {a.tile_bytes() / 1e6:.1f} MB")
    for with_d in (False, True):
        tag = "+d" if with_d else ""
        args = check_k1(big, rng, "banded", with_d, 8, errs, f"tridiag n=262144 banded{tag}")
        check_k1(big, rng, "scatter", with_d, 8, errs, f"tridiag n=262144 general{tag}")
        check_k1(p3d, rng, "scatter", with_d, 8, errs, f"poisson3d_48 general{tag}")
    _, small_t = block_tridiag_ops(13 * 64, 64, dev)
    small_g = random_block_sym(rng, 13, 32, 3, dev)
    for with_d in (False, True):
        tag = "+d" if with_d else ""
        check_k1(small_t, rng, "banded", with_d, 4, errs, f"ragged nrb=13 bn=64 banded{tag}")
        check_k1(small_g, rng, "scatter", with_d, 4, errs, f"ragged nrb=13 bn=32 general{tag}")
    # kernel 1 on the packed nonzeros of sparse symmetric tiles (the route
    # of the fused CG step there): poisson3d_48 at 128 x 128 and a ragged
    # 2-D Poisson nx = 37 at bn = 32 (n = 1369, nrb = 43)
    k1p_args = {}
    for a, label in ((p3d, "poisson3d_48 sym"), (rag_sym, "ragged poisson2d-37 bn=32 sym")):
        for with_d in (False, True):
            for beta_v in (0.0, 0.37):
                got = check_k1_packed(a, rng, with_d, beta_v, errs,
                                      f"{label}{'+d' if with_d else ''} beta={beta_v}")
                if a is p3d and beta_v:
                    k1p_args[with_d] = got

    # main-path timing, kernel and plain version on the same inputs; the
    # kernels get their scratch and outputs made once, as inside a solve
    r, pold, beta, _ = args
    # a solve state that never finishes, so every timed launch does its work
    work = fc.FusedWork.new(dev, maxiter=1 << 20, tol=-1.0)
    out = (torch.empty_like(r), torch.empty_like(r))
    times["sym_fused_dir_spmv_dot"] = time_pair(
        lambda: fc.sym_fused_dir_spmv_dot(
            big.diag_blocks, big.off_blocks, big.off_cols, r, pold, beta,
            mirror="banded", mirror_src=big.mirror_src, out=out, work=work),
        lambda: fc._sym_dir_plain(
            big.diag_blocks, big.off_blocks, big.off_cols, r, pold, beta, None,
            big.mirror_src, None, None))
    rg = torch.randn(p3d.nrb, 128, device=dev)
    out_g = (torch.empty_like(rg), torch.empty_like(rg))
    extra["K1 general poisson3d_48"] = time_pair(
        lambda: fc.sym_fused_dir_spmv_dot(
            p3d.diag_blocks, p3d.off_blocks, p3d.off_cols, rg, rg, beta,
            mirror="scatter", mirror_src=p3d.mirror_src, out=out_g, work=work),
        lambda: fc._sym_dir_plain(
            p3d.diag_blocks, p3d.off_blocks, p3d.off_cols, rg, rg, beta, None,
            p3d.mirror_src, None, None))
    # packed kernel 1 on the same operator, beside the general landing; its
    # bound counts the stored nonzeros (diagonal and upper tiles), and the
    # view's own bound (the upper ones twice) stands beside it
    pk1 = p3d.packed()
    stored = int(torch.count_nonzero(p3d.diag_blocks)) + int(torch.count_nonzero(p3d.off_blocks))
    vec1 = p3d.nrb * 128 * 4
    for with_d, key, table in ((False, "sym_fused_dir_spmv_dot_packed", times),
                               (True, "K1 packed poisson3d_48 +d", extra)):
        r1, pold1, beta1, d1 = k1p_args[with_d]
        out1 = (torch.empty_like(r1), torch.empty_like(r1))
        vb = (5 if with_d else 4) * vec1  # r p_old (d) in, p_new q out
        table[key] = time_pair(
            lambda: fc.fused_dir_spmv_dot_packed(pk1, r1, pold1, beta1, d1, out=out1, work=work),
            lambda: fc._packed_dir_plain(pk1, r1, pold1, beta1, d1, None, None))
        table[key].update(bound(8 * stored + vb, 2 * pk1.nnz + (6 if with_d else 4) * p3d.n),
                          library_ms=None)  # as kernel 1: no one call
        table[key]["needed_ms"] = needed_bound(stored, vb)
        table[key]["view_ms"] = needed_bound(pk1.nnz, vb)
    for pcg in (False, True):
        name = "fused_update_dot_pcg" if pcg else "fused_update_dot"
        x, p, r, q, d, alpha = check_update((N_BIG // 128, 128), rng, pcg, errs, "(2048, 128)", dev)
        check_update((13, 32), rng, pcg, errs, "(13, 32)", dev)
        out = (torch.empty_like(x), torch.empty_like(r))
        dd = d if pcg else None
        kern = fc.fused_update_dot_pcg if pcg else (
            lambda x_, p_, r_, q_, d_, a_, **kw: fc.fused_update_dot(x_, p_, r_, q_, a_, **kw))
        times[name] = time_pair(
            lambda: kern(x, p, r, q, dd, alpha, out=out, work=work),
            lambda: fc._update_plain(name, x, p, r, q, dd, alpha, None, None))

    # kernels 4 and 5 (full blocked-ELL)
    for with_d in (False, True):
        for beta_v in (0.0, 0.37):
            tag = f"{'+d' if with_d else ''} beta={beta_v}"
            k4_args = check_k4(big_full, rng, with_d, beta_v, errs, f"tridiag n=262144{tag}")
            check_k4(p3d_full, rng, with_d, beta_v, errs, f"poisson3d_48{tag}")
    small_f = random_block_full(rng, 13, 32, 32, 3, dev)
    for with_d in (False, True):
        check_k4(small_f, rng, with_d, 0.37, errs, f"ragged nrb=13 bn=32{'+d' if with_d else ''}")
    x_big = check_k5(big_full, rng, errs, "tridiag n=262144 128x128")
    x_p3d = check_k5(p3d_full, rng, errs, "poisson3d_48 128x128")
    x_p8 = check_k5(p3d_8, rng, errs, "poisson3d_48 8x128")
    check_k5(random_block_full(rng, 13, 8, 64, 3, dev, ncols=300), rng, errs,
             "ragged rect 104x300 8x64")
    r, pold, beta = k4_args
    out = (torch.empty_like(r), torch.empty_like(r))
    times["fused_dir_spmv_dot"] = time_pair(
        lambda: fc.fused_dir_spmv_dot(big_full.blocks, big_full.block_cols, r, pold, beta,
                                      out=out, work=work),
        lambda: fc._full_dir_plain(big_full.blocks, big_full.block_cols, r, pold, beta,
                                   None, None, None))
    extra["K4 poisson3d_48"] = time_pair(
        lambda: fc.fused_dir_spmv_dot(p3d_full.blocks, p3d_full.block_cols, rg, rg, beta,
                                      out=out_g, work=work),
        lambda: fc._full_dir_plain(p3d_full.blocks, p3d_full.block_cols, rg, rg, beta,
                                   None, None, None))
    times["bell_spmv"] = time_pair(
        lambda: kb.bell_spmv_tiles(big_full.blocks, big_full.block_cols, x_big),
        lambda: kb._bell_plain(big_full.blocks, big_full.block_cols, x_big))
    for label, a, x in (("K5 poisson3d_48 128x128", p3d_full, x_p3d),
                        ("K5 poisson3d_48 8x128", p3d_8, x_p8)):
        extra[label] = time_pair(lambda: kb.bell_spmv_tiles(a.blocks, a.block_cols, x),
                                 lambda: kb._bell_plain(a.blocks, a.block_cols, x))
        extra[label].update(bound(nbytes(a.blocks, a.block_cols, x) + a.n * 4,
                                  2 * a.blocks.numel()))
        extra[label]["library_ms"] = library_spmv(
            csr_from_bell(a), x.reshape(-1)[:a.shape[1]],
            kb.bell_spmv_tiles(a.blocks, a.block_cols, x)[:a.n], label)

    # kernels 4 and 5 on the packed nonzeros of sparse tiles: poisson3d_48
    # (both tile shapes of the main path) and a float32 operator of bn = 8,
    # which had no kernel before
    pk_ms = {}
    for label, a in (("poisson3d_48 128x128", p3d_full), ("poisson3d_48 8x128", p3d_8)):
        pk_ms[label] = cuda_ms(lambda: pack_nonzeros(a.blocks, a.block_cols, a.padded_shape[1]),
                               reps=3, warm=1)
    p3d_bn8 = load_bell(MATRICES[0], dev, bm=8, bn=8)
    xk5 = {}
    for label, a in (("poisson3d_48 128x128", p3d_full), ("poisson3d_48 8x128", p3d_8),
                     ("poisson3d_48 8x8", p3d_bn8)):
        xk5[label] = check_k5_packed(a, rng, errs, label)
    before = fc.LAUNCHES["bell_spmv_packed"]
    y8 = p3d_bn8.matvec(xk5["poisson3d_48 8x8"][:p3d_bn8.n])
    check(fc.LAUNCHES["bell_spmv_packed"] == before + 1 and bool(torch.isfinite(y8).all()),
          "bn = 8 float32 operator: matvec did not take the packed kernel")
    for with_d in (False, True):
        for beta_v in (0.0, 0.37):
            tag = f"{'+d' if with_d else ''} beta={beta_v}"
            k4p_args = check_k4_packed(p3d_full, rng, with_d, beta_v, errs,
                                       f"poisson3d_48{tag}")
    check_k4_packed(p3d_bn8, rng, True, 0.37, errs, "poisson3d_48 8x8+d beta=0.37")
    r4, pold4, beta4, d4 = k4p_args
    pk = p3d_full.packed()
    out_p = (torch.empty_like(r4), torch.empty_like(r4))
    vec_b = p3d_full.nrb * 128 * 4
    times["fused_dir_spmv_dot_packed"] = time_pair(
        lambda: fc.fused_dir_spmv_dot_packed(pk, r4, pold4, beta4, out=out_p, work=work),
        lambda: fc._packed_dir_plain(pk, r4, pold4, beta4, None, None, None))
    times["fused_dir_spmv_dot_packed"].update(bound(8 * pk.nnz + 4 * vec_b, 2 * pk.nnz + 4 * p3d_full.n))
    times["fused_dir_spmv_dot_packed"]["library_ms"] = None  # as kernel 4: no one call
    extra["K4 packed poisson3d_48 +d"] = time_pair(
        lambda: fc.fused_dir_spmv_dot_packed(pk, r4, pold4, beta4, d4, out=out_p, work=work),
        lambda: fc._packed_dir_plain(pk, r4, pold4, beta4, d4, None, None))
    extra["K4 packed poisson3d_48 +d"].update(bound(8 * pk.nnz + 5 * vec_b, 2 * pk.nnz + 6 * p3d_full.n))
    for label, a in (("poisson3d_48 128x128", p3d_full), ("poisson3d_48 8x128", p3d_8)):
        pka, x = a.packed(), xk5[label]
        key = "bell_spmv_packed" if a is p3d_full else f"K5 packed {label}"
        table = times if a is p3d_full else extra
        table[key] = time_pair(lambda: kb.bell_spmv_packed(pka, x),
                               lambda: kb.packed_apply(pka, x))
        table[key].update(bound(8 * pka.nnz + 4 * (pka.ncols + a.n), 2 * pka.nnz))
        table[key]["library_ms"] = library_spmv(
            csr_from_bell(a), x[:a.shape[1]], kb.bell_spmv_packed(pka, x)[:a.n], label)
        if a is p3d_full:
            print(f"  CSR, one warp per row, on the same nonzeros: {csr_yardstick(pka, x):.5f} ms "
                  f"a launch; packed (SELL-32) kernel 5 {table[key]['ms']:.5f}  [{card_line()}]")
        print(f"  pack {label}: {pk_ms[label]:.4f} ms once per operator; view "
              f"{pka.nbytes() / 1e6:.3f} MB ({pka.nnz} nonzeros), tiles "
              f"{a.tile_bytes() / 1e6:.1f} MB")
    for fill, got, t5d, t5p, t4d, t4p, route in crossover(big_full, rng):
        print(f"  crossover, n=262144 tiles at fill {fill:.2f} ({got:.4f} of the slots): "
              f"K5 dense {t5d:.5f} packed {t5p:.5f}; K4 dense {t4d:.5f} packed {t4p:.5f} "
              f"(ms, events); the route picks {'packed' if route else 'dense'}  [{card_line()}]")

    # bounds from this run's inputs: every vector is n float32 entries
    n, v = N_BIG, N_BIG * 4
    times["sym_fused_dir_spmv_dot"].update(bound(
        nbytes(big.diag_blocks, big.off_blocks, big.off_cols) + 4 * v,
        2 * big.diag_blocks.numel() + 4 * big.off_blocks.numel() + 4 * n))
    extra["K1 general poisson3d_48"].update(bound(
        nbytes(p3d.diag_blocks, p3d.off_blocks, p3d.off_cols, p3d.mirror_src)
        + 4 * p3d.nrb * 128 * 4,
        2 * p3d.diag_blocks.numel() + 4 * p3d.off_blocks.numel() + 4 * p3d.nrb * 128))
    times["fused_update_dot"].update(bound(6 * v, 6 * n))  # x p r q in, x' r' out
    times["fused_update_dot_pcg"].update(bound(7 * v, 9 * n))  # and d
    times["fused_dir_spmv_dot"].update(bound(
        nbytes(big_full.blocks, big_full.block_cols) + 4 * v, 2 * big_full.blocks.numel() + 4 * n))
    extra["K4 poisson3d_48"].update(bound(
        nbytes(p3d_full.blocks, p3d_full.block_cols) + 4 * p3d_full.nrb * 128 * 4,
        2 * p3d_full.blocks.numel() + 4 * p3d_full.nrb * 128))
    # the sparse-tile rows' bounds on what these inputs need (the nonzeros
    # and the vectors), beside the tile-stream bounds above
    extra["K4 poisson3d_48"]["needed_ms"] = needed_bound(pk.nnz, 4 * vec_b)
    extra["K1 general poisson3d_48"]["needed_ms"] = needed_bound(
        int(torch.count_nonzero(p3d.diag_blocks)) + int(torch.count_nonzero(p3d.off_blocks)),
        4 * vec_b)
    for label, a in (("K5 poisson3d_48 128x128", p3d_full), ("K5 poisson3d_48 8x128", p3d_8)):
        extra[label]["needed_ms"] = needed_bound(a.packed().nnz, 4 * (a.padded_shape[1] + a.n))
    times["bell_spmv"].update(bound(nbytes(big_full.blocks, big_full.block_cols) + 2 * v,
                                    2 * big_full.blocks.numel()))
    # kernels 1-4 fuse an SpMV with vector updates and dots: no one PyTorch
    # call computes that
    for name in BLOCKED_KERNELS[:4]:
        times[name]["library_ms"] = None
    times["bell_spmv"]["library_ms"] = library_spmv(
        csr_from_bell(big_full), x_big.reshape(-1),
        kb.bell_spmv_tiles(big_full.blocks, big_full.block_cols, x_big), "tridiag n=262144")
    torch.cuda.synchronize()
    return errs, times, extra, {"p3d": p3d, "p3d_full": p3d_full, "p3d_8": p3d_8,
                                "p3d_bn8": p3d_bn8}


# ---- phase 2, DIA: kernels 7-10 against their plain versions -----------------

def sym_dia_pair(n, offs_pos, rng, dev, scale=0.05):
    """A random diagonally dominant symmetric DIA operator in full and in
    symmetric storage, drawn as bench.py's symdia-big is (one normal draw
    per stored off-diagonal, in order, zero past the end; the main diagonal
    1 + 2·max row sum)."""
    import torch

    from conjugategradient_tpu_torch.types import DIAMatrix, SymDIAMatrix

    diags_pos = np.zeros((len(offs_pos), n), np.float32)
    for j, k in enumerate(offs_pos[1:], start=1):
        d = (scale * rng.standard_normal(n)).astype(np.float32)
        d[n - k:] = 0.0
        diags_pos[j] = d
    diags_pos[0] = 1.0 + 2.0 * np.abs(diags_pos[1:]).sum(axis=0).max()
    offs_full = tuple(-k for k in reversed(offs_pos[1:])) + tuple(offs_pos)
    diags_full = np.zeros((len(offs_full), n), np.float32)
    for j, off in enumerate(offs_full):
        if off >= 0:
            diags_full[j] = diags_pos[offs_pos.index(off)]
        else:
            diags_full[j, -off:] = diags_pos[offs_pos.index(-off)][: n + off]
    nnz = int(np.count_nonzero(diags_full))
    full = DIAMatrix(torch.from_numpy(diags_full).to(dev), offs_full, (n, n), nnz)
    sym = SymDIAMatrix(torch.from_numpy(diags_pos).to(dev), tuple(offs_pos), (n, n), nnz)
    return full, sym


def check_dia(a, sym, rng, errs, label, x=None):
    """Both kernels 7 on ``a`` (``dia_spmv_rows`` where its parameter holds
    the offsets, and ``dia_spmv``; the routed call too) bit for bit against
    the plain version (and on ``sym``, its symmetric half, when given:
    both kernels 10, the tiled one on its geometry whether or not the route
    takes it there, and the one the route picks), on one random x or the
    one given; returns x and the routed y."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import dia_spmv as kd

    if x is None:
        x = torch.as_tensor(rng.standard_normal(a.shape[1]), dtype=torch.float32,
                            device=a.device)
    offs = tuple(a.offsets)
    route = kd.dia_route(offs)
    before = kd.LAUNCHES[route]
    yk = kd.dia_spmv_diags(a.diags, a.offsets, a.offsets_dev, x)
    check(kd.LAUNCHES[route] == before + 1, f"{label}: dia_spmv_diags did not take {route}")
    yp = kd._dia_plain(a.diags, a.offsets, x)
    same = lambda u, v: torch.equal(u.view(torch.int32), v.view(torch.int32))  # noqa: E731
    kernels = ["dia_spmv"] + (["dia_spmv_rows"] if a.ndiag <= kd.MAX_PARAM_DIAGS else [])
    for name in kernels:
        y1 = kd.dia_cuda(a.diags, offs, a.offsets_dev, x, name)
        y2 = kd.dia_cuda(a.diags, offs, a.offsets_dev, x, name)
        torch.cuda.synchronize()
        e = float((y1.double() - yp.double()).abs().nan_to_num().max())  # NaN rows: NaN - NaN
        check(same(y1, yp), f"{name} {label}: not bit-equal to the plain version ({e})")
        check(same(y1, y2), f"{name} {label}: a repeat differs")
        errs[name] = max(errs[name], e)
    check(same(yk, yp), f"{route} {label}: the routed call differs from the plain version")
    msg = (f"  dia_spmv {label:<30} {' and '.join(kernels)} bit-equal to the plain version "
           f"(max|y| {float(yp.abs().nan_to_num().max()):.4g}, {int(torch.isnan(yp).sum())} NaN "
           f"rows), the route takes {route}; {a.ndiag} diagonals, {a.shape[0]} x {a.shape[1]}, "
           f"{nbytes(a.diags) / 1e6:.1f} MB")
    if sym is not None:
        m = float(yp.abs().max())
        tiling = kd.sym_dia_tiling(sym.offsets, sym.n)
        check(tiling is not None, f"{label}: no geometry for the tiled kernel 10")
        route = kd.sym_dia_route(sym.offsets, sym.n)
        before = kd.LAUNCHES[route]
        ys = kd.sym_dia_spmv_diags(sym.diags, sym.offsets, sym.offsets_dev, x)
        check(kd.LAUNCHES[route] == before + 1, f"{label}: sym_dia_spmv_diags did not take {route}")
        yps = kd._sym_dia_plain(sym.diags, sym.offsets, x)
        check(torch.equal(ys, yps), f"{route} {label}: the routed call differs from the plain version")
        # each kernel 10 forced: the tiled one on its geometry, whether or not
        # the route takes it there; the by-value one up to 32 stored offsets
        forced = ["sym_dia_spmv_tiled", "sym_dia_spmv"] + \
            (["sym_dia_spmv_rows"] if sym.ndiag <= kd.MAX_PARAM_DIAGS else [])
        for name in forced:
            y1 = kd.sym_dia_cuda(sym.diags, sym.offsets, sym.offsets_dev, x, name, tiling)
            y2 = kd.sym_dia_cuda(sym.diags, sym.offsets, sym.offsets_dev, x, name, tiling)
            torch.cuda.synchronize()
            e, _ = rel_max_err(y1, yps)
            check(torch.equal(y1, yps), f"{name} {label}: not bit-equal to the plain version ({e})")
            check(torch.equal(y1, y2), f"{name} {label}: a repeat differs")
            errs[name] = max(errs[name], e)
        ef, _ = rel_max_err(ys, yk)
        check(ef <= TOL_Q * m, f"sym_dia_spmv {label}: {ef} from the full layout's y")
        msg += (f"; {' and '.join(forced)} bit-equal ({tiling}, {tiling.ctas(sym.n)} CTAs; "
                f"{sym.ndiag} stored), the route takes {route}; |y_sym - y_full| {ef:.3g}")
    print(msg)
    return x, yk


def check_dia_edges(dev, rng, errs):
    """Both kernels 7 bit-equal to the plain version at n = 3, 1001 and
    110,592: offsets beyond n on both sides, ncols equal to n, above and
    below it, a NaN in x, and x (a view at offset 1) or the diagonals not
    16-byte aligned."""
    import torch

    from conjugategradient_tpu_torch.types import DIAMatrix

    for n in (3, 1001, 110592):
        offs = (-n - 3, -5, -1, 0, 1, 4, 48, n + 2)
        flat = torch.as_tensor(rng.standard_normal(len(offs) * n + 1), dtype=torch.float32,
                               device=dev)
        for shift in (0, 1):  # the diagonals aligned, then a view at offset 1
            diags = flat[shift:shift + len(offs) * n].view(len(offs), n)
            for ncols in (n, n + 37, max(1, n - 2)):
                a = DIAMatrix(diags, offs, (n, ncols), diags.numel())
                xb = torch.as_tensor(rng.standard_normal(ncols + 1), dtype=torch.float32,
                                     device=dev)
                xb[1 + ncols // 2] = float("nan")
                for xs in (0, 1):
                    x = xb[xs:xs + ncols]
                    check_dia(a, None, rng, errs, f"n={n} ncols={ncols} diags+{shift} x+{xs} NaN",
                              x=x)


def dia_bounds(a, sym):
    """Bounds of one call: dia_spmv reads its diagonals, offsets and x once
    and writes y; sym_dia_spmv the same on its stored half-band, with two
    multiply-adds per stored off-diagonal entry (None without ``sym``)."""
    n, ncols = a.shape
    full = bound(nbytes(a.diags, a.offsets_dev) + (ncols + n) * 4, 2 * a.ndiag * n)
    if sym is None:
        return full, None
    half = bound(nbytes(sym.diags, sym.offsets_dev) + 2 * n * 4, 2 * (2 * sym.ndiag - 1) * n)
    return full, half


def phase_dia_kernels(dev, errs, times, extra):
    """Kernels 7-10 (two CUDA kernels) against their plain versions, timed
    beside cuSPARSE; returns the operators phase 3 reuses."""
    import torch

    from conjugategradient_tpu_torch import load_matrix
    from conjugategradient_tpu_torch.convert import dia_from_arrays
    from conjugategradient_tpu_torch.ops.cuda import dia_spmv as kd

    errs.update(dict.fromkeys(DIA_KERNELS, 0.0))
    # the tiled kernel 10's geometry on each shape it is timed on, and
    # whether the route takes it there
    for label, offs, n in (("symdia-big", SYMDIA_OFFSETS, SYMDIA_N),
                           ("poisson3d_48", (0, 1, 48, 2304), 110592)):
        t = kd.sym_dia_tiling(offs, n)
        launch = []
        for dt in kd.TILE_GEOMETRY:
            lt, st = kd.launch_tiling(t, dt)
            launch.append(f"{str(dt)[6:]}: {lt.planes} planes, {st} stages, {lt.ctas(n)} CTAs, "
                          f"{lt.smem_bytes(st, 2 if dt == torch.bfloat16 else 4, len(offs))} B "
                          f"of shared memory, the route takes {kd.sym_dia_route(offs, n, dt)}")
        print(f"  sym_dia_tiling {label}: {t}, {t.ctas(n)} CTAs; launched as {'; '.join(launch)}")
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    big, big_sym = sym_dia_pair(SYMDIA_N, SYMDIA_OFFSETS, rng, dev)
    print(f"  symdia-big built in {time.perf_counter() - t0:.1f} s: full {big.ndiag} diagonals "
          f"{nbytes(big.diags) / 1e6:.1f} MB, symmetric {big_sym.ndiag} "
          f"{nbytes(big_sym.diags) / 1e6:.1f} MB, nnz {big.nnz}")
    p3d = load_matrix(os.path.join(ROOT, MATRICES[0]), layout="dia", dtype=np.float32, device=dev)
    p3d_sym = load_matrix(os.path.join(ROOT, MATRICES[0]), layout="symdia", dtype=np.float32,
                          device=dev)
    dense = load_matrix(os.path.join(ROOT, "problems/dense_256.mtx"), layout="dia",
                        dtype=np.float32, device=dev)
    dense_sym = load_matrix(os.path.join(ROOT, "problems/dense_256.mtx"), layout="symdia",
                            dtype=np.float32, device=dev)
    x_big, y_big = check_dia(big, big_sym, rng, errs, "symdia-big n=2097152")
    x_p3d, y_p3d = check_dia(p3d, p3d_sym, rng, errs, "poisson3d_48")
    check_dia(dense, dense_sym, rng, errs, "dense_256")
    check_dia(*sym_dia_pair(1001, (0, 3, 300), rng, dev, scale=0.3), rng, errs,
              "ragged n=1001 offsets 0,3,300")
    rect = rng.standard_normal((4, 1001)).astype(np.float32)
    check_dia(dia_from_arrays(rect, (-7, 0, 5, 299), (1001, 1300), rect.size, device=dev),
              None, rng, errs, "rect 1001x1300")
    neg = rng.standard_normal((3, 777)).astype(np.float32)
    check_dia(dia_from_arrays(neg, (-300, -3, -1), (777, 777), neg.size, device=dev),
              None, rng, errs, "negative offsets only")
    check_dia_edges(dev, rng, errs)
    # a wide band (50 stored offsets) that the route gives one thread a row
    ela = load_matrix(os.path.join(ROOT, MATRICES[1]), layout="dia", dtype=np.float32, device=dev)
    ela_sym = load_matrix(os.path.join(ROOT, MATRICES[1]), layout="symdia", dtype=np.float32,
                          device=dev)
    check_dia(ela, ela_sym, np.random.default_rng(16), errs, "elasticity3d_16")

    for label, a, sym, x, y in (("symdia-big", big, big_sym, x_big, y_big),
                                ("poisson3d_48", p3d, p3d_sym, x_p3d, y_p3d)):
        full_b, half_b = dia_bounds(a, sym)
        # both kernels 7 where the by-value one takes the offsets; the route
        # takes dia_spmv_rows on poisson3d_48 (7) and dia_spmv on symdia-big (41)
        t7 = {name: time_pair(lambda: kd.dia_cuda(a.diags, a.offsets, a.offsets_dev, x, name),
                              lambda: kd._dia_plain(a.diags, a.offsets, x))
              for name in ("dia_spmv", "dia_spmv_rows") if name == "dia_spmv"
              or a.ndiag <= kd.MAX_PARAM_DIAGS}
        tf = t7[kd.dia_route(a.offsets)]
        # each kernel 10 on the same operator: the tiled one on its geometry,
        # one thread a row, by value (both shapes hold 32 offsets or fewer)
        t10 = {name: time_pair(
            lambda: kd.sym_dia_cuda(sym.diags, sym.offsets, sym.offsets_dev, x, name),
            lambda: kd._sym_dia_plain(sym.diags, sym.offsets, x))
            for name in ("sym_dia_spmv_tiled", "sym_dia_spmv", "sym_dia_spmv_rows")}
        csr = csr_from_dia(a)
        lib = library_spmv(csr, x, y, label)  # the same y = A x for both storages
        del csr
        for t in t7.values():
            t.update(full_b, library_ms=lib)
        for t in t10.values():
            t.update(half_b, library_ms=lib)
        full_bytes = nbytes(a.diags) + (a.shape[1] + a.n) * 4
        print(f"  {label} SpMV on full-layout bytes ({full_bytes / 1e6:.1f} MB): dia_spmv "
              f"{full_bytes / tf['ms'] / 1e6:.1f} GB/s, " + ", ".join(
                  f"{name} {full_bytes / t['ms'] / 1e6:.1f} GB/s" for name, t in t10.items()) +
              " effective")
        if label == "symdia-big":
            times["dia_spmv"], times["sym_dia_spmv_tiled"] = tf, t10["sym_dia_spmv_tiled"]
            times["sym_dia_spmv"] = t10["sym_dia_spmv"]
            extra[f"sym_dia_spmv_rows {label}"] = t10["sym_dia_spmv_rows"]
        else:
            times["dia_spmv_rows"], extra[f"dia_spmv {label}"] = tf, t7["dia_spmv"]
            times["sym_dia_spmv_rows"] = t10["sym_dia_spmv_rows"]
            extra[f"sym_dia_spmv_tiled {label}"] = t10["sym_dia_spmv_tiled"]
            extra[f"sym_dia_spmv {label}"] = t10["sym_dia_spmv"]
    dia_route_rows(p3d, rng, errs, extra)
    torch.cuda.synchronize()
    return {"big": big, "big_sym": big_sym, "p3d": p3d, "p3d_sym": p3d_sym,
            "dense_sym": dense_sym, "ela_sym": ela_sym}


def dia_route_rows(p3d, rng, errs, extra):
    """The route's evidence at poisson3d_48's size: both kernels 7, checked
    bit for bit and timed against each other, on a 27-point stencil's 27
    diagonals (n = 110,592), on poisson3d_48's offsets at a ragged n =
    110,591, and on poisson3d_48 with x a view at offset 1."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import dia_spmv as kd
    from conjugategradient_tpu_torch.types import DIAMatrix

    n, dev = p3d.n, p3d.device
    o27 = tuple(sorted(i + 48 * j + 2304 * k for i in (-1, 0, 1) for j in (-1, 0, 1)
                       for k in (-1, 0, 1)))
    d27 = torch.as_tensor(rng.standard_normal((27, n)), dtype=torch.float32, device=dev)
    ragged = p3d.diags[:, :n - 1].contiguous()
    xb = torch.as_tensor(rng.standard_normal(n + 1), dtype=torch.float32, device=dev)
    for label, a, x in (("27-point n=110592", DIAMatrix(d27, o27, (n, n), d27.numel()), xb[:n]),
                        ("poisson3d_48 n=110591",
                         DIAMatrix(ragged, p3d.offsets, (n - 1, n - 1), p3d.nnz), xb[:n - 1]),
                        ("poisson3d_48 x+1", p3d, xb[1:])):
        check_dia(a, None, rng, errs, label, x=x)
        for name in ("dia_spmv_rows", "dia_spmv"):
            t = time_pair(lambda: kd.dia_cuda(a.diags, a.offsets, a.offsets_dev, x, name),
                          lambda: kd._dia_plain(a.diags, a.offsets, x))
            t.update(dia_bounds(a, None)[0], library_ms=None)
            extra[f"{name} {label}"] = t


# ---- phase 2, MINRES: kernels 14-16 against their plain versions -------------

def minres_operands(nrb, bn, rng, dev, with_d, shift, first=False):
    """Six random (nrb, bn) vectors, the (1, 8) scalar row (``first``: the
    first step's, 1/gamma = phi = 0) and the Jacobi diagonal (or None)."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    vecs = [torch.as_tensor(rng.standard_normal((nrb, bn)), dtype=torch.float32, device=dev)
            for _ in range(6)]
    su = torch.zeros(1, 8)
    su[0, fm.SU_INV_BETA], su[0, fm.SU_SHIFT] = 0.31, shift
    if not first:
        su[0, fm.SU_OLDEPS], su[0, fm.SU_DELTA] = 0.11, 0.23
        su[0, fm.SU_IGAMMA], su[0, fm.SU_PHI] = 0.57, 0.83
    d = None
    if with_d:
        d = torch.as_tensor(0.5 + rng.random((nrb, bn)), dtype=torch.float32, device=dev)
    return vecs, su.to(dev), d


def minres_dir_pair(a, mirror, row_group=None, packed=False):
    """(name, kernel wrapper, plain version) of MINRES kernel 1 on ``a``:
    kernel 14 on full storage, kernel 15 (with ``mirror``) on symmetric;
    ``packed``: the packed kernel on ``a.packed()`` (either storage)."""
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm
    from conjugategradient_tpu_torch.ops.cuda._common import form
    from conjugategradient_tpu_torch.ops.cuda.bell_spmv import packed_product
    from conjugategradient_tpu_torch.ops.spmv import bell_apply, sym_bell_apply
    from conjugategradient_tpu_torch.types import BlockedEllMatrix

    # a bf16 operator: its kernels' bf16 forms, the plain versions on the
    # widened tiles (.float() of float32 tiles is the tiles themselves)
    if packed:
        pk = a.packed()
        name = "sym_minres_dir_spmv_dot_packed" if pk.symmetric else "minres_dir_spmv_dot_packed"
        kern = lambda vecs, su, d, **kw: fm.minres_dir_spmv_dot_packed(pk, *vecs, su, d, **kw)
        apply = packed_product(pk)
    elif isinstance(a, BlockedEllMatrix):
        name = "minres_dir_spmv_dot"
        kern = lambda vecs, su, d, **kw: fm.minres_dir_spmv_dot(
            a.blocks, a.block_cols, *vecs, su, d, row_group=row_group, **kw)
        apply = lambda v: bell_apply(a.blocks.float(), a.block_cols, v)
    else:
        name = "sym_minres_dir_spmv_dot"
        kern = lambda vecs, su, d, **kw: fm.sym_minres_dir_spmv_dot(
            a.diag_blocks, a.off_blocks, a.off_cols, *vecs, su, d, mirror=mirror,
            mirror_src=a.mirror_src, row_group=row_group or 8, **kw)
        apply = lambda v: sym_bell_apply(a.diag_blocks.float(), a.off_blocks.float(),
                                         a.off_cols, a.mirror_src, v)
    name = form(name, a.dtype)
    plain = lambda vecs, su, d: fm._dir_plain(name, apply, vecs, su, d, None, None)
    return name, kern, plain


def same_bits(a, b) -> bool:
    """Equal, NaN where the other is NaN (a NaN's payload aside)."""
    import torch

    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def check_minres_dir(a, rng, mirror, with_d, shift, errs, label, first=False, row_group=None,
                     packed=False, nan=False):
    """MINRES kernel 1 against its plain version: v, w_new, x_new bit for
    bit (``packed``: q too, which the packed kernel is built to match), q
    within TOL_Q of max|q|, v.q within TOL_DOT and v.r1 within TOL_DOT of
    ||v|| ||r1|| (a dot of unrelated vectors can cancel); two launches
    bit-identical; the last CTA's scalar step (c1, alpha, alpha/beta)
    within TAIL_ULPS of torch's on the kernel's own dots (``packed``: 0
    ulps).  ``nan``: 1/beta and phi NaN, so every output is NaN exactly
    where the plain version's is."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    name, kern, plain = minres_dir_pair(a, mirror, row_group, packed)
    vecs, su, d = minres_operands(a.nrb, a.bn, rng, a.device, with_d, shift, first)
    if nan:
        su[0, fm.SU_INV_BETA] = su[0, fm.SU_PHI] = float("nan")
    wk = fm.MinresWork.new(a.device, maxiter=4)
    wk.scal[fm.M_OLDB] = 1.7
    wk.start(torch.tensor(2.3, device=a.device))
    wp_scal = wk.scal.clone()
    k = kern(vecs, su, d, work=wk)
    k2 = kern(vecs, su, d)
    p = plain(vecs, su, d)
    torch.cuda.synchronize()
    bitwise = ((0, "v"), (1, "q"), (2, "w_new"), (3, "x_new")) if packed else \
        ((0, "v"), (2, "w_new"), (3, "x_new"))
    for i, what in bitwise:
        check(same_bits(k[i], p[i]), f"{name} {label}: {what} not bit-equal to the plain version")
    check(all(same_bits(x, y) for x, y in zip(k, k2)), f"{name} {label}: two launches differ")
    if nan:
        check(bool(torch.isnan(k[0]).all()) and math.isnan(float(k[4])),
              f"{name} {label}: a NaN 1/beta left finite entries")
        print(f"  {name} {label:<34} v, q, w, x' bit-equal with NaN 1/beta and phi; repeat ok")
        return vecs, su, d
    if first:
        check(torch.equal(k[3], vecs[5]) and not bool(k[2].any()),
              f"{name} {label}: a first step (1/gamma = phi = 0) changed x or w")
    e_q, m_q = rel_max_err(k[1], p[1])
    check(e_q <= TOL_Q * m_q, f"{name} {label}: q err {e_q} vs max|q| {m_q}")
    e_vq = abs(float(k[4]) - float(p[4]))
    e_vr1 = abs(float(k[5]) - float(p[5]))
    check(e_vq <= TOL_DOT * abs(float(p[4])), f"{name} {label}: vq {float(k[4])} vs {float(p[4])}")
    vr1_scale = float(p[0].norm() * vecs[1].norm())
    check(e_vr1 <= TOL_DOT * vr1_scale, f"{name} {label}: vr1 {float(k[5])} vs {float(p[5])}")
    wp = fm.MinresWork.new(a.device, maxiter=4)
    wp.scal.copy_(wp_scal)
    fm.finish_dir(wp, k[4][0, 0], k[5][0, 0])
    ulps = int((wk.scal[:fm.M_VQ].view(torch.int32) - wp.scal[:fm.M_VQ].view(torch.int32)).abs().max())
    check(ulps <= (0 if packed else TAIL_ULPS), f"{name} {label}: scalar step {ulps} ulps from "
          "torch's")
    errs[name] = max(errs[name], e_q, e_vq, e_vr1)
    print(f"  {name} {label:<34} v, {'q, ' if packed else ''}w, x' bit-equal; |dq|={e_q:.3g} "
          f"(max|q| {m_q:.4g}) |dvq|={e_vq:.3g} |dvr1|={e_vr1:.3g}; repeat ok; scalar step "
          f"{ulps} ulp")
    return vecs, su, d


def check_minres_idle(a, rng, label):
    """The packed kernel 1 on a solve that is no longer live: no output and
    no scalar written."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    name, kern, _ = minres_dir_pair(a, None, packed=True)
    vecs, su, d = minres_operands(a.nrb, a.bn, rng, a.device, True, 0.07)
    wk = fm.MinresWork.new(a.device, maxiter=4)
    wk.start(torch.tensor(2.3, device=a.device))
    wk.ctl[fc.C_LIVE] = 0
    kept = wk.scal.clone()
    out = tuple(torch.full_like(vecs[0], 7.0) for _ in range(4))
    kern(vecs, su, d, out=out, work=wk)
    torch.cuda.synchronize()
    check(all(bool((o == 7.0).all()) for o in out)
          and torch.equal(wk.scal.view(torch.int32), kept.view(torch.int32)),
          f"{name} {label}: a launch with live = 0 wrote something")
    print(f"  {name} {label:<34} live = 0: nothing written")


def poisson2d_ops(nx, bn, dev):
    """The 5-point 2-D Poisson operator on an nx x nx grid as float32 full
    and symmetric blocked-ELL with bn x bn tiles (sparse tiles)."""
    from conjugategradient_tpu_torch.problems import poisson2d_coo
    from conjugategradient_tpu_torch.types import BlockedEllMatrix, SymBellMatrix

    rows, cols, vals, shape = poisson2d_coo(nx)
    order = np.lexsort((cols, rows))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=shape[0]))])
    full = BlockedEllMatrix.from_csr_host(vals[order].astype(np.float32), cols[order], indptr,
                                          shape, bm=bn, bn=bn, device=dev)
    return full, SymBellMatrix.from_bell(full)


def check_minres_update(shape, rng, with_d, errs, label, dev):
    """Kernel 16 against its plain version: r2' bit for bit (also written
    over r1), beta^2 within TOL_DOT, and every scalar the last CTA writes
    (the Givens step) within TAIL_ULPS of torch's on the kernel's own dot."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    q, r1, r2 = (torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)
                 for _ in range(3))
    d = torch.as_tensor(0.5 + rng.random(shape), dtype=torch.float32, device=dev) if with_d else None

    wk, wp = minres_update_work(dev), minres_update_work(dev)
    yk, bk = fm.minres_update_dot(q, r1, r2, wk.c1, wk.ia, d, work=wk)
    yp, bp = fm._update_plain(q, r1, r2, wp.c1, wp.ia, d, None, None)
    r1c = r1.clone()
    y2, b2 = fm.minres_update_dot(q, r1c, r2, wp.c1, wp.ia, d, out=r1c)
    torch.cuda.synchronize()
    check(torch.equal(yk, yp), f"minres_update_dot {label}: r2' not bit-equal to the plain version")
    check(torch.equal(y2, yp) and torch.equal(b2, bk),
          f"minres_update_dot {label}: in place over r1, or launched again, it differs")
    e = abs(float(bk) - float(bp))
    check(e <= TOL_DOT * abs(float(bp)), f"minres_update_dot {label}: bsq {float(bk)} vs {float(bp)}")
    fm.finish_update(wp, bk[0, 0])
    ulps = int((wk.scal[:fm.M_VQ].view(torch.int32) - wp.scal[:fm.M_VQ].view(torch.int32)).abs().max())
    check(ulps <= TAIL_ULPS and torch.equal(wk.ctl, wp.ctl) and int(wk.ctl[fc.C_K]) == 1,
          f"minres_update_dot {label}: scalar step {ulps} ulps from torch's, ctl {wk.ctl.tolist()} "
          f"vs {wp.ctl.tolist()}")
    errs["minres_update_dot"] = max(errs["minres_update_dot"], e)
    print(f"  minres_update_dot {label:<20} r2' bit-equal (also over r1); |dbsq|={e:.3g}; "
          f"Givens step {ulps} ulp, ctl equal")
    return q, r1, r2, d


def phase_minres_kernels(dev, big, big_full, ops, errs, times, extra):
    """Kernels 14-16 against their plain versions and timed, at the MINRES
    path's shapes and at small ragged ones."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    rng = np.random.default_rng(14)
    p3d = ops["p3d"]
    for with_d in (False, True):
        for shift in (0.0, 0.07):
            tag = f"{'+d' if with_d else ''} shift={shift}"
            full_args = check_minres_dir(big_full, rng, None, with_d, shift, errs,
                                         f"tridiag n=262144 full{tag}")
            band_args = check_minres_dir(big, rng, "banded", with_d, shift, errs,
                                         f"tridiag n=262144 banded{tag}")
            gen_args = check_minres_dir(p3d, rng, "scatter", with_d, shift, errs,
                                        f"poisson3d_48 general{tag}")
    check_minres_dir(big, rng, "scatter", True, 0.07, errs, "tridiag n=262144 general+d")
    _, small_t = block_tridiag_ops(13 * 64, 64, dev)
    small_g = random_block_sym(rng, 13, 32, 3, dev)
    small_f = random_block_full(rng, 13, 32, 32, 3, dev)
    for first in (False, True):
        tag = " first step" if first else "+d"
        for a, mirror, label in ((big_full, None, "tridiag n=262144 full"),
                                 (big, "banded", "tridiag n=262144 banded"),
                                 (small_f, None, "ragged nrb=13 bn=32 full"),
                                 (small_t, "banded", "ragged nrb=13 bn=64 banded"),
                                 (small_g, "scatter", "ragged nrb=13 bn=32 general")):
            if first or a.nrb == 13:
                check_minres_dir(a, rng, mirror, not first, 0.07, errs, label + tag, first=first,
                                 row_group=4 if a.nrb == 13 else None)
    # the packed kernel, the route of fused MINRES on sparse tiles, on both
    # storages' views: poisson3d_48 at 128 x 128 (the main path) and a
    # ragged 2-D Poisson nx = 37 at bn = 32 (n = 1369); with and without d,
    # shift 0 and not 0, a first step, NaN scalars, live = 0
    from conjugategradient_tpu_torch.ops.spmv import bell_packed_route

    p3f = ops["p3d_full"]
    dense_full_args = check_minres_dir(p3f, rng, None, False, 0.07, errs,
                                       "poisson3d_48 full (dense route)")
    rag_full, rag_sym = poisson2d_ops(37, 32, dev)
    packed_args = {}
    for a, label in ((p3f, "poisson3d_48 full"), (p3d, "poisson3d_48 sym"),
                     (rag_full, "ragged poisson2d-37 bn=32 full"),
                     (rag_sym, "ragged poisson2d-37 bn=32 sym")):
        check(bell_packed_route(a), f"{label}: the route does not take the packed view")
        for with_d in (False, True):
            for shift in (0.0, 0.07):
                got = check_minres_dir(a, rng, None, with_d, shift, errs,
                                       f"{label}{'+d' if with_d else ''} shift={shift}",
                                       packed=True)
                if not with_d and shift:
                    packed_args[label] = got
        check_minres_dir(a, rng, None, True, 0.07, errs, f"{label}+d first step", first=True,
                         packed=True)
        check_minres_dir(a, rng, None, False, 0.07, errs, f"{label} NaN", packed=True, nan=True)
        check_minres_idle(a, rng, label)
    stored = int(torch.count_nonzero(p3d.diag_blocks)) + int(torch.count_nonzero(p3d.off_blocks))
    check(p3f.packed().nnz == p3d.packed().nnz == int(torch.count_nonzero(p3f.blocks)),
          f"poisson3d_48: views hold {p3f.packed().nnz} and {p3d.packed().nnz} nonzeros")
    upd = {}
    for with_d in (False, True):
        upd[with_d] = check_minres_update((N_BIG // 128, 128), rng, with_d, errs,
                                          f"(2048, 128){'+d' if with_d else ''}", dev)
        check_minres_update((13, 32), rng, with_d, errs, f"(13, 32){'+d' if with_d else ''}", dev)

    # timing on the last shifted, unpreconditioned inputs, launched as the
    # solver launches them: in place, with a work that never finishes
    work = fm.MinresWork.new(dev, maxiter=1 << 20, tol=-1.0)
    work.start(torch.tensor(2.3, device=dev))
    n, v = N_BIG, N_BIG * 4
    for key, a, mirror, args, table, packed in (
        ("minres_dir_spmv_dot", big_full, None, full_args, times, False),
        ("sym_minres_dir_spmv_dot", big, "banded", band_args, times, False),
        ("sym_minres_dir_spmv_dot general poisson3d_48", p3d, "scatter", gen_args, extra, False),
        ("minres_dir_spmv_dot poisson3d_48 full", p3f, None, dense_full_args, extra, False),
        ("minres_dir_spmv_dot_packed", p3f, None, packed_args["poisson3d_48 full"], times, True),
        ("sym_minres_dir_spmv_dot_packed", p3d, None, packed_args["poisson3d_48 sym"], times,
         True),
    ):
        _, kern, plain = minres_dir_pair(a, mirror, packed=packed)
        vecs, su, _ = args
        vecs = [t.clone() for t in vecs]
        out = (vecs[2], torch.empty_like(vecs[0]), vecs[4], vecs[5])
        su0 = su.clone()
        su0[0, fm.SU_PHI] = 0.0  # x stays put over the timed launches
        t = time_pair(lambda: kern(vecs, su0, None, out=out, work=work),
                      lambda: plain(vecs, su0, None))
        vb = 10 * a.nrb * a.bn * 4  # r2 r1 v_prev w-1 w-2 x in; v q w x' out
        if packed:
            # the function's own nonzeros: full storage's tiles', or the
            # stored diagonal and upper ones (the view holds the upper
            # ones twice)
            nnz = stored if a.packed().symmetric else a.packed().nnz
            t.update(bound(8 * nnz + vb, 2 * a.packed().nnz + 14 * a.nrb * a.bn),
                     library_ms=None)
            t["needed_ms"] = needed_bound(nnz, vb)
            t["view_ms"] = needed_bound(a.packed().nnz, vb)
        else:
            tiles = nbytes(a.blocks, a.block_cols) if mirror is None else \
                nbytes(a.diag_blocks, a.off_blocks, a.off_cols)
            flops = 2 * a.blocks.numel() if mirror is None else \
                2 * a.diag_blocks.numel() + 4 * a.off_blocks.numel()
            t.update(bound(tiles + vb, flops + 14 * a.nrb * a.bn),
                     library_ms=None)  # an SpMV fused with updates and two dots: no one call
        if a is p3d and not packed:  # sparse tiles: the bound on the stored nonzeros too
            t["needed_ms"] = needed_bound(stored, vb)
        if a is p3f and not packed:
            t["needed_ms"] = needed_bound(p3f.packed().nnz, vb)
        table[key] = t
    q, r1, r2, _ = upd[False]
    out = torch.empty_like(q)
    t = time_pair(lambda: fm.minres_update_dot(q, r1, r2, work.c1, work.ia, out=out, work=work),
                  lambda: fm._update_plain(q, r1, r2, work.c1, work.ia, None, None, None))
    t.update(bound(4 * v, 7 * n), library_ms=None)  # q r1 r2 in, r2' out
    times["minres_update_dot"] = t
    torch.cuda.synchronize()


# ---- phase 2, BiCGStab: kernels 18-20 against their plain versions -----------

def nonsym_tridiag(n, bn, dev, seed=0):
    """bench.py:1367-1403's nonsymmetric block-tridiagonal operator (the JAX
    lane bicgstab-bell): up/lo tiles 0.08 N(0, 1) from the seed, the
    diagonal (2 + sum|up| + sum|lo|) I, as full blocked-ELL."""
    import torch

    from conjugategradient_tpu_torch.types import BlockedEllMatrix

    nrb = n // bn
    rng = np.random.default_rng(seed)
    up = (0.08 * rng.standard_normal((bn, bn))).astype(np.float32)
    lo = (0.08 * rng.standard_normal((bn, bn))).astype(np.float32)
    diag = np.eye(bn, dtype=np.float32) * (2.0 + np.abs(up).sum() + np.abs(lo).sum())
    blocks = np.zeros((nrb, 3, bn, bn), dtype=np.float32)
    cols = np.zeros((nrb, 3), dtype=np.int32)
    for i in range(nrb):
        blocks[i, 0], cols[i, 0] = diag, i
        k = 1
        for c, t in ((i - 1, lo), (i + 1, up)):
            if 0 <= c < nrb:
                blocks[i, k], cols[i, k] = t, c
                k += 1
    return BlockedEllMatrix(torch.from_numpy(blocks).to(dev), torch.from_numpy(cols).to(dev),
                            (n, n), nrb * 3 * bn * bn)


def convdiff_csr(nx):
    """bench.py:1113-1138's operator: the 5-point upwind convection-diffusion
    stencil on an nx x nx grid, peclet 10, as float32 host CSR."""
    from conjugategradient_tpu_torch.problems import convection_diffusion_2d_coo

    rows, cols, vals, shape = convection_diffusion_2d_coo(nx, peclet=10.0)
    order = np.lexsort((cols, rows))
    r, c, v = rows[order], cols[order], vals[order].astype(np.float32)
    indptr = np.zeros(shape[0] + 1, np.int64)
    np.add.at(indptr, r + 1, 1)
    return v, c, np.cumsum(indptr), shape


def convdiff_bell(nx, dev, bn=128):
    from conjugategradient_tpu_torch.types import BlockedEllMatrix

    return BlockedEllMatrix.from_csr_host(*convdiff_csr(nx), bm=bn, bn=bn, device=dev)


def bicg_work(dev, maxiter=5, tol=1e-3):
    """A live BiCGStab work with non-trivial scalars (rho_k = 1.7, beta from
    ||r0||^2 = 2.3)."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb

    w = fb.BicgstabWork.new(dev, maxiter=maxiter, tol=tol)
    w.scal[fb.B_RHO_NEXT] = 1.7
    w.start(torch.tensor(2.3, device=dev))
    return w


def tail_ulps(wk, wp) -> int:
    """The largest distance in ulps between two works' scalar slots (the
    kernels' last CTA against torch's 0-d ops), the dots left out."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb

    return int((wk.scal[:fb.B_RV].view(torch.int32)
                - wp.scal[:fb.B_RV].view(torch.int32)).abs().max())


def bicg_forms(a, packed, row_group=None):
    """Kernels 18 and 19 on ``a`` in one form, the dense tiles or the packed
    nonzeros: (kernel 18, its plain version, kernel 19, its plain version),
    each taking the vector operands of the dense wrappers."""
    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb

    if packed:
        pk = a.packed()
        return (lambda *v, **kw: fb.bicgstab_dir_spmv_dot_packed(pk, *v, **kw),
                lambda *v: fb._packed_dir_plain(pk, *v),
                lambda *v, **kw: fb.bicgstab_s_spmv_dot_packed(pk, *v, **kw),
                lambda *v: fb._packed_s_plain(pk, *v))
    return (lambda *v, **kw: fb.bicgstab_dir_spmv_dot(a.blocks, a.block_cols, *v,
                                                      row_group=row_group, **kw),
            lambda *v: fb._tile_dir_plain(a.blocks, a.block_cols, *v),
            lambda *v, **kw: fb.bicgstab_s_spmv_dot(a.blocks, a.block_cols, *v,
                                                    row_group=row_group, **kw),
            lambda *v: fb._tile_s_plain(a.blocks, a.block_cols, *v))


def check_bicg_tiles(a, rng, with_d, beta_v, omega_v, alpha_v, errs, label, row_group=None,
                     nan=False, packed=False):
    """Kernels 18 and 19 (``packed``: their packed forms) against their
    plain versions: p', p^, s, s^, x_h bit for bit, v' and t within TOL_Q of
    their largest entry (packed: bit for bit, which they are built to be),
    the dots within TOL_DOT of the product of their operands' norms (dots of
    unrelated vectors can cancel), two launches bit-identical, and the last
    CTAs' scalar steps within TAIL_ULPS of torch's on the kernels' own dots.
    ``nan``: r^ = 0 and rho_k = 0 make alpha = 0/0 in kernel 18's tail, and
    r = v' = 0 make omega = 0/0 in kernel 19's: both are clamped to 0, and
    the next kernel's update is an exact no-op."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb
    from conjugategradient_tpu_torch.ops.cuda._common import form

    dev, nrb, bn = a.device, a.nrb, a.bn
    k18, p18, k19, p19 = bicg_forms(a, packed, row_group)
    tag = "K18p/K19p" if packed else "K18/K19"
    suffix = "_packed" if packed else ""

    def vec():
        return torch.as_tensor(rng.standard_normal((nrb, bn)), dtype=torch.float32, device=dev)

    r, p, v, rhat, x = vec(), vec(), vec(), vec(), vec()
    if nan:
        rhat.zero_()
    d = padded_inv_diag(a, nrb * bn).reshape(nrb, bn) if with_d else None
    beta = torch.tensor([[beta_v]], dtype=torch.float32, device=dev)
    omega = torch.tensor([[omega_v]], dtype=torch.float32, device=dev)
    wk, wp = bicg_work(dev), bicg_work(dev)
    if nan:
        wk.scal[fb.B_RHO_NEXT] = wp.scal[fb.B_RHO_NEXT] = 0.0
    k1 = k18(r, p, v, rhat, beta, omega, d, work=wk)
    k1b = k18(r, p, v, rhat, beta, omega, d)
    p1 = p18(r, p, v, rhat, beta, omega, d, None, None)
    torch.cuda.synchronize()
    check(torch.equal(k1[0], p1[0]) and torch.equal(k1[1], p1[1]),
          f"K18 {label}: p' or p^ not bit-equal to the plain version")
    check(not packed or torch.equal(k1[2], p1[2]),
          f"K18 packed {label}: v' not bit-equal to the plain version")
    check(all(torch.equal(s_, t_) for s_, t_ in zip(k1, k1b)), f"K18 {label}: two launches differ")
    e_v, m_v = rel_max_err(k1[2], p1[2])
    e_rv = abs(float(k1[3]) - float(p1[3]))
    check(e_v <= TOL_Q * m_v, f"K18 {label}: v' err {e_v} vs max {m_v}")
    check(e_rv <= TOL_DOT * float(rhat.norm() * p1[2].norm()),
          f"K18 {label}: rv {float(k1[3])} vs {float(p1[3])}")
    fb.finish_dir(wp, k1[3][0, 0])
    u1 = tail_ulps(wk, wp)
    check(u1 <= TAIL_ULPS, f"K18 {label}: scalar step {u1} ulps from torch's")
    if nan:
        check(math.isnan(float(wk.scal[fb.B_ALPHA])) and float(wk.scal[fb.B_ALPHA_C]) == 0.0,
              f"K18 {label}: alpha = 0/0 was not clamped to 0")
        r.zero_()
    alpha = wk.alpha_c if nan else torch.tensor([[alpha_v]], dtype=torch.float32, device=dev)
    vn = torch.zeros_like(r) if nan else k1[2]
    k2 = k19(r, vn, x, k1[1], alpha, d, work=wk)
    k2b = k19(r, vn, x, k1[1], alpha, d)
    p2 = p19(r, vn, x, k1[1], alpha, d, None, None)
    torch.cuda.synchronize()
    check(all(torch.equal(k2[i], p2[i]) for i in range(3)),
          f"K19 {label}: s, s^ or x_h not bit-equal to the plain version")
    check(not packed or torch.equal(k2[3], p2[3]),
          f"K19 packed {label}: t not bit-equal to the plain version")
    check(all(torch.equal(s_, t_) for s_, t_ in zip(k2, k2b)), f"K19 {label}: two launches differ")
    e_t, m_t = rel_max_err(k2[3], p2[3])
    check(e_t <= TOL_Q * max(m_t, 1e-30), f"K19 {label}: t err {e_t} vs max {m_t}")
    scale = float(p2[0].norm() * p2[0].norm() + p2[3].norm() * p2[0].norm()
                  + p2[3].norm() * p2[3].norm())
    e_d = max(abs(float(k2[i]) - float(p2[i])) for i in range(4, 7))
    check(e_d <= TOL_DOT * scale, f"K19 {label}: dots {[float(t) for t in k2[4:]]} vs "
          f"{[float(t) for t in p2[4:]]}")
    fb.finish_s(wp, k2[4][0, 0], k2[5][0, 0], k2[6][0, 0])
    u2 = tail_ulps(wk, wp)
    check(u2 <= TAIL_ULPS and torch.equal(wk.ctl, wp.ctl),
          f"K19 {label}: scalar step {u2} ulps from torch's, ctl {wk.ctl.tolist()} vs "
          f"{wp.ctl.tolist()}")
    if nan:
        check(torch.equal(k2[0], r) and torch.equal(k2[2], x),
              f"K19 {label}: a clamped alpha changed s or x_h")
        check(math.isnan(float(wk.scal[fb.B_OMEGA])) and float(wk.scal[fb.B_OMEGA_C]) == 0.0,
              f"K19 {label}: omega = 0/0 was not clamped to 0")
        k3 = fb.bicgstab_update_dot(k2[2], k2[1], k2[0], k2[3], rhat, wk.omega_c)
        torch.cuda.synchronize()
        check(torch.equal(k3[0], k2[2]) and torch.equal(k3[1], k2[0]),
              f"K20 {label}: a clamped omega changed x_h or s")
    for name, e in ((f"bicgstab_dir_spmv_dot{suffix}", max(e_v, e_rv)),
                    (f"bicgstab_s_spmv_dot{suffix}", max(e_t, e_d))):
        name = form(name, a.dtype)
        errs[name] = max(errs[name], e)
    bits = "p', p^, v', s, s^, x_h, t" if packed else "p', p^, s, s^, x_h"
    print(f"  {tag} {label:<38} {bits} bit-equal; |dv'|={e_v:.3g} (max {m_v:.4g}) "
          f"|dt|={e_t:.3g} (max {m_t:.4g}) |drv|={e_rv:.3g} |ddots|={e_d:.3g}; repeat ok; "
          f"scalar steps {u1}, {u2} ulp{'; NaN alpha and omega clamped, updates no-ops' if nan else ''}")
    return r, p, v, rhat, x, k1, beta, omega, alpha, d


def check_bicg_update(n, rng, errs, label, dev):
    """Kernel 20 against its plain version: x', r' bit for bit (also in place
    over x_h and s), the dots within TOL_DOT, its scalar step within
    TAIL_ULPS and its control words equal; omega = 0 returns x_h and s."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb

    xh, sh, s, t, rhat = (torch.as_tensor(rng.standard_normal(n), dtype=torch.float32, device=dev)
                          for _ in range(5))
    w = torch.tensor([[0.45]], dtype=torch.float32, device=dev)
    wk, wp = bicg_work(dev), bicg_work(dev)
    k = fb.bicgstab_update_dot(xh, sh, s, t, rhat, w, work=wk)
    p = fb._update_plain(xh, sh, s, t, rhat, w, None, None)
    xc, sc = xh.clone(), s.clone()
    k2 = fb.bicgstab_update_dot(xc, sh, sc, t, rhat, w, out=(xc, sc))
    z = fb.bicgstab_update_dot(xh, sh, s, t, rhat, torch.zeros(1, 1, device=dev))
    torch.cuda.synchronize()
    check(torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]) and torch.equal(k2[0], p[0])
          and torch.equal(k2[1], p[1]), f"K20 {label}: x' or r' not bit-equal to the plain version")
    check(torch.equal(z[0], xh) and torch.equal(z[1], s), f"K20 {label}: omega = 0 changed x_h or s")
    e = max(abs(float(k[i]) - float(p[i])) for i in (2, 3))
    scale = float(p[1].norm() * (p[1].norm() + rhat.norm()))
    check(e <= TOL_DOT * scale, f"K20 {label}: dots {float(k[2])}, {float(k[3])} vs "
          f"{float(p[2])}, {float(p[3])}")
    fb.finish_update(wp, k[2][0, 0], k[3][0, 0])
    u = tail_ulps(wk, wp)
    check(u <= TAIL_ULPS and torch.equal(wk.ctl, wp.ctl),
          f"K20 {label}: scalar step {u} ulps from torch's, ctl {wk.ctl.tolist()} vs {wp.ctl.tolist()}")
    errs["bicgstab_update_dot"] = max(errs["bicgstab_update_dot"], e)
    print(f"  K20 n={n:<10}{label:<14} x', r' bit-equal (also in place); omega = 0 keeps x_h, s; "
          f"|ddots|={e:.3g}; scalar step {u} ulp, ctl equal")
    return xh, sh, s, t, rhat, w


def bicg_update_not_live(n, dev):
    """Kernel 20 launched as the solver launches it (x' over x_h, r' over
    s) on a work that is not live, on seeded inputs: the buffers it could
    write (x_h, s, the partials filled with 7, the counter, scal, ctl,
    hist) before and after."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb

    xh, sh, s, t, rhat, w = update_operands(n, 41, dev)
    work = bicg_work(dev)
    work.ctl[fb.C_LIVE] = 0
    work.partials.fill_(7.0)
    bufs = (xh, s, work.partials, work.counter, work.scal, work.ctl, work.hist)
    kept = [b.clone() for b in bufs]
    fb.bicgstab_update_dot(xh, sh, s, t, rhat, w, out=(xh, s), work=work)
    torch.cuda.synchronize()
    return kept, bufs


def check_bicg_update_not_live(n, dev) -> None:
    """A launch of kernel 20 that is not live writes nothing."""
    kept, bufs = bicg_update_not_live(n, dev)
    check(all(same_bits(a, b) for a, b in zip(kept, bufs)),
          f"K20 n={n}: a launch that is not live wrote")
    print(f"  K20 n={n:<10}a launch that is not live writes nothing (x_h, s, partials, counter, "
          "scal, ctl, hist)")


def time_bicg_tiles(a, args, work, packed=False, with_d=False) -> tuple:
    """Kernels 18 and 19 (``packed``: their packed forms) timed against
    their plain versions on the operands ``check_bicg_tiles`` returned,
    launched as the solver launches them (outputs made once, ``work``
    live), each with its bound: each input read once, each output written
    once (the dense forms' tiles; the packed forms' value, 4 or 2 bytes, and
    4-byte column a nonzero)."""
    import torch

    r, p, v, rhat, x, k1, beta, omega, alpha, d = args
    d = d if with_d else None
    k18, p18, k19, p19 = bicg_forms(a, packed)
    out1 = tuple(torch.empty_like(r) for _ in range(3))
    out2 = tuple(torch.empty_like(r) for _ in range(4))
    t1 = time_pair(lambda: k18(r, p, v, rhat, beta, omega, d, out=out1, work=work),
                   lambda: p18(r, p, v, rhat, beta, omega, d, None, None))
    t2 = time_pair(lambda: k19(r, k1[2], x, k1[1], alpha, d, out=out2, work=work),
                   lambda: p19(r, k1[2], x, k1[1], alpha, d, None, None))
    n, vb = r.numel(), r.numel() * 4
    nd = int(d is not None)
    if packed:
        nnz = a.packed().nnz
        per_nz = a.packed().vals.element_size() + 4
        t1.update(bound(per_nz * nnz + (7 + nd) * vb, 2 * nnz + 6 * n))
        t2.update(bound(per_nz * nnz + (8 + nd) * vb, 2 * nnz + 10 * n))
    else:
        tiles = nbytes(a.blocks, a.block_cols)
        t1.update(bound(tiles + (7 + nd) * vb, 2 * a.blocks.numel() + 6 * n))
        t2.update(bound(tiles + (8 + nd) * vb, 2 * a.blocks.numel() + 10 * n))
    for t in (t1, t2):
        # an SpMV fused with updates and dots: no one call
        t["library_ms"] = None
    return t1, t2


def phase_bicgstab_kernels(dev, errs, times, extra):
    """Kernels 18-20 against their plain versions and timed, on bench.py's
    bicgstab-bell operator (n = 262,144, 128 x 128), on the timed main
    path's convection-diffusion operator and at ragged shapes; kernels 18
    and 19 in their packed forms on convection-diffusion operators, timed
    beside the dense forms on nx = 512."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb
    from conjugategradient_tpu_torch.ops.spmv import bell_packed_route

    rng = np.random.default_rng(18)
    a = nonsym_tridiag(N_BIG, 128, dev, seed=0)
    print(f"  bicgstab-bell operator: tiles {tuple(a.blocks.shape)}, {a.tile_bytes() / 1e6:.1f} MB")
    for with_d in (False, True):
        tag = "+d" if with_d else ""
        args = check_bicg_tiles(a, rng, with_d, 0.4, 0.25, 0.6, errs, f"n=262144{tag}")
        check_bicg_tiles(a, rng, with_d, 0.0, 0.0, 0.0, errs, f"n=262144{tag} beta=omega=alpha=0")
    check_bicg_tiles(a, rng, False, 0.4, 0.25, 0.6, errs, "n=262144 NaN alpha, omega", nan=True)
    # the timed main path's operator: kmax 5, its padding slots point at
    # column block 0
    cd = convdiff_bell(512, dev)
    check(cd.kmax == 5, f"convdiff 512 blocked-ELL: kmax {cd.kmax}, expected 5")
    print(f"  convdiff-512 operator: tiles {tuple(cd.blocks.shape)}, {cd.tile_bytes() / 1e6:.1f} MB")
    cd_args = check_bicg_tiles(cd, rng, False, 0.4, 0.25, 0.6, errs, "convdiff-512 dense")
    cd_args_d = check_bicg_tiles(cd, rng, True, 0.4, 0.25, 0.6, errs, "convdiff-512+d dense")
    # the packed forms, which the main path takes on these sparse tiles: on
    # the same operator, on nx = 64, and on nx = 37 at bn = 32 (n = 1369, not
    # a multiple of 32); with and without d, with the scalars 0, and with a
    # NaN alpha and omega
    cd_packed = {}
    for op, name in ((cd, "convdiff-512 (main path)"), (convdiff_bell(64, dev), "convdiff-64"),
                     (convdiff_bell(37, dev, bn=32), "ragged convdiff-37 bn=32")):
        check(bell_packed_route(op), f"{name}: the route does not take the packed view")
        for with_d in (False, True):
            tag = "+d" if with_d else ""
            got = check_bicg_tiles(op, rng, with_d, 0.4, 0.25, 0.6, errs, f"{name}{tag}",
                                   packed=True)
            if op is cd:
                cd_packed[with_d] = got
            check_bicg_tiles(op, rng, with_d, 0.0, 0.0, 0.0, errs,
                             f"{name}{tag} beta=omega=alpha=0", packed=True)
        check_bicg_tiles(op, rng, True, 0.4, 0.25, 0.6, errs, f"{name} NaN alpha, omega",
                         nan=True, packed=True)
    for bn in (32, 64):
        small = nonsym_tridiag(13 * bn, bn, dev, seed=bn)
        for with_d in (False, True):
            check_bicg_tiles(small, rng, with_d, 0.4, 0.25, 0.6, errs,
                             f"ragged nrb=13 bn={bn}{'+d' if with_d else ''}", row_group=3)
        check_bicg_tiles(small, rng, True, 0.4, 0.25, 0.6, errs, f"ragged nrb=13 bn={bn} NaN",
                         nan=True)
    for n in (210, 4097):
        check_bicg_update(n, rng, errs, "", dev)
    upd = check_bicg_update(N_BIG, rng, errs, "(main path)", dev)
    for n in (N_BIG, 4097):
        check_bicg_update_not_live(n, dev)

    # timing on a work that never finishes (tol = -1, maxiter 2^20)
    work = fb.BicgstabWork.new(dev, maxiter=1 << 20, tol=-1.0)
    work.start(torch.sum(args[0] * args[0]))
    times["bicgstab_dir_spmv_dot"], times["bicgstab_s_spmv_dot"] = time_bicg_tiles(a, args, work)
    # convdiff-512, both forms side by side (the packed ones are the main
    # path's); sparse tiles: the dense forms' bound on the nonzeros too (7
    # and 8 vectors, 8 and 9 with d, as the packed forms' bound_ms counts)
    extra["K18 convdiff-512"], extra["K19 convdiff-512"] = time_bicg_tiles(cd, cd_args, work)
    extra["K18 convdiff-512 +d"], extra["K19 convdiff-512 +d"] = time_bicg_tiles(
        cd, cd_args_d, work, with_d=True)
    times["bicgstab_dir_spmv_dot_packed"], times["bicgstab_s_spmv_dot_packed"] = \
        time_bicg_tiles(cd, cd_packed[False], work, packed=True)
    extra["K18 packed convdiff-512 +d"], extra["K19 packed convdiff-512 +d"] = time_bicg_tiles(
        cd, cd_packed[True], work, packed=True, with_d=True)
    cd_nnz, vb = cd.packed().nnz, N_BIG * 4
    check(cd_nnz == int(torch.count_nonzero(cd.blocks)), "convdiff-512: the view lost nonzeros")
    for key, nvec in (("K18 convdiff-512", 7), ("K19 convdiff-512", 8),
                      ("K18 convdiff-512 +d", 8), ("K19 convdiff-512 +d", 9)):
        extra[key]["needed_ms"] = needed_bound(cd_nnz, nvec * vb)
    xh, sh, s, t, rh, w = upd
    out3 = (torch.empty_like(xh), torch.empty_like(xh))
    times["bicgstab_update_dot"] = time_pair(
        lambda: fb.bicgstab_update_dot(xh, sh, s, t, rh, w, out=out3, work=work),
        lambda: fb._update_plain(xh, sh, s, t, rh, w, None, None))
    torch.cuda.synchronize()
    check(int(work.ctl[fb.C_LIVE]) == 1, "BiCGStab timing: the timing work stopped being live")
    times["bicgstab_update_dot"].update(bound(7 * N_BIG * 4, 8 * N_BIG))
    # two axpys and two dots: no one call
    times["bicgstab_update_dot"]["library_ms"] = None
    return {"bench_bell": a, "convdiff": cd}


# ---- phase 3: the main path ------------------------------------------------

def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.5f}"


def bnorm(n: int) -> float:
    return math.sqrt(n * (n + 1) * (2 * n + 1) / 6.0)


def run_tester(path, layout, precond, tol, dtype="float32", extra=()):
    """The port's tester in this process; returns (dim, nnz, ms, rel_error,
    summary, printed lines)."""
    from conjugategradient_tpu_torch import tester

    src = path if path.startswith("stencil:") else os.path.join(ROOT, path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tester.main([src, "--layout", layout,
                          "--dtype", dtype, "--precond", precond,
                          "--tol", repr(tol), "--summary",
                          "--device", str(DEVICE), *extra])
    lines = buf.getvalue().strip().splitlines()
    check(rc == 0, f"tester {path} {layout} {precond} {' '.join(extra)}: rc={rc}")
    dim, nnz, ms, rel = lines[0].split()
    summ = json.loads(lines[1])
    return int(dim), int(nnz), float(ms), float(rel), summ, lines


def trajectory_ok(h_fused, h_plain, k, floor_rel=1e-10):
    """rho_history over the first k steps, restricted to entries above the
    f32 noise floor (floor_rel * rho_0)."""
    hf = h_fused[1:k + 1].double().cpu().numpy()
    hp = h_plain[1:k + 1].double().cpu().numpy()
    keep = hp > floor_rel * float(h_plain[0])
    if not keep.any():
        return True, 0
    ok = np.allclose(hf[keep], hp[keep], rtol=TRAJ_RTOL, atol=0)
    return ok, int(keep.sum())


@contextlib.contextmanager
def forced_route(packed: bool):
    """Send every float32 or bf16 blocked-ELL operator, full or symmetric, down one
    route, the packed nonzeros or the dense tiles, in its SpMV and fused
    steps, to compare the two on one operator (the port itself picks by
    tile fill and has no switch for it)."""
    import torch

    from conjugategradient_tpu_torch.ops import spmv
    from conjugategradient_tpu_torch.solver import fused, fused_bicgstab, fused_minres

    users = (spmv, fused, fused_bicgstab, fused_minres)
    saved = spmv.bell_packed_route
    for mod in users:
        mod.bell_packed_route = lambda a: packed and a.dtype in (torch.float32, torch.bfloat16)
    try:
        yield
    finally:
        for mod in users:
            mod.bell_packed_route = saved


def k11_launches(bf16: bool = False) -> int:
    """Launches of kernel 11 on either route (the staged kernel or the
    register march), of its float32 / float64 forms or of its bf16 ones."""
    from conjugategradient_tpu_torch.ops.cuda import _common

    sfx = "_bf16" if bf16 else ""
    return _common.LAUNCHES["stencil7" + sfx] + _common.LAUNCHES["stencil7_staged" + sfx]


def kernel5_launches() -> int:
    """Launches of kernel 5 in either form (dense tiles or packed)."""
    from conjugategradient_tpu_torch.ops.cuda import _common

    return _common.LAUNCHES["bell_spmv"] + _common.LAUNCHES["bell_spmv_packed"]


ROUTE_KERNELS = ("fused_dir_spmv_dot", "fused_dir_spmv_dot_packed", "bell_spmv",
                 "bell_spmv_packed")
# symmetric storage: the tiles' kernel 1, or packed kernel 1 and packed
# kernel 5 (the SpMV of rel_error); the dense route's SpMV is plain torch
SYM_ROUTE_KERNELS = ("sym_fused_dir_spmv_dot", "sym_fused_dir_spmv_dot_packed",
                     "bell_spmv_packed")


def route_comparison(dev, a, card):
    """Fused CG and Jacobi PCG on poisson3d_48 at 128 x 128 (full or
    symmetric storage), the tester's protocol (b = 1..n, tol 1e-5 ||b||),
    on the dense route and on the packed route in this process:
    iterations, rel_error, ms/it (the best of three solves), the kernels
    each launched, and the two 25-step trajectories against each other.
    Returns {(precond, route): ms/it}."""
    from conjugategradient_tpu_torch.types import SymBellMatrix

    import torch

    from conjugategradient_tpu_torch import accuracy, cg_solve, jacobi_preconditioner
    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.utils import Timer

    sym = isinstance(a, SymBellMatrix)
    kernels = SYM_ROUTE_KERNELS if sym else ROUTE_KERNELS
    layout = "symbell" if sym else "bell"
    bb = torch.arange(1, a.n + 1, dtype=torch.float32, device=dev)
    tt = TOL_SOLVE_REL * bnorm(a.n)
    out = {}
    for precond in ("none", "jacobi"):
        M = jacobi_preconditioner(a) if precond == "jacobi" else None
        runs = {}
        for route in ("dense", "packed"):
            with forced_route(route == "packed"):
                cg_solve(a, bb, tol=tt, M=M, maxiter=8)
                before = {k: fc.LAUNCHES[k] for k in kernels}
                best = float("inf")
                for _ in range(3):  # host-bound: the best of three solves
                    t = Timer(dev).start_measure()
                    x, info = cg_solve(a, bb, tol=tt, M=M)
                    t.stop_measure()
                    best = min(best, t.get_duration())
                rel = float(accuracy(a, bb, x))
                _, h25 = cg_solve(a, bb, tol=0.0, maxiter=25, M=M)
                used = {k: fc.LAUNCHES[k] - before[k] for k in kernels}
            k = int(info.iterations)
            what = f"poisson3d_48 {layout} 128x128 precond {precond}, {route} route"
            check(bool(info.converged) and rel < REL_ERROR_BOUND,
                  f"{what}: converged {bool(info.converged)}, rel_error {rel}")
            mine = [n for n in kernels if n.endswith("_packed") == (route == "packed")]
            check(used[mine[0]] >= k + 25 and all(used[n] >= 1 for n in mine)
                  and all(used[n] == 0 for n in kernels if n not in mine),
                  f"{what}: launches {used}")
            ms_it = best / k
            runs[route] = (k, h25)
            out[(precond, route)] = ms_it
            print(f"  {what}: {k} its, {ms_it:.5f} ms/it, rel_error {rel:.3e}, "
                  f"launches {used}  [{card}]")
        ok, n_used = trajectory_ok(runs["packed"][1].rho_history, runs["dense"][1].rho_history, 25)
        check(ok, f"poisson3d_48 {layout} {precond}: packed vs dense rho_history beyond rtol "
                  f"{TRAJ_RTOL}")
        check(abs(runs["packed"][0] - runs["dense"][0]) <= ITER_SLACK,
              f"poisson3d_48 {layout} {precond}: iterations packed {runs['packed'][0]} vs dense "
              f"{runs['dense'][0]}")
        hp = runs["packed"][1].rho_history[:26].double().cpu()
        hd = runs["dense"][1].rho_history[:26].double().cpu()
        gap = float(((hp - hd).abs() / hd.abs()).max())
        print(f"  poisson3d_48 {layout} {precond}: the two routes' 25-step trajectories agree "
              f"on {n_used} entries (max rel diff {gap:.3g})")
    return out


def phase_main_path(dev, big, big_full, ops, card):
    import torch

    from conjugategradient_tpu_torch import (accuracy, cg_solve, fused_bell_cg_solve,
                                             jacobi_preconditioner)
    from conjugategradient_tpu_torch.io import read_csr_host
    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.utils import Timer

    p3d, p3d_full = ops["p3d"], ops["p3d_full"]
    results = {}
    # (a) the tester, the reference protocol's entry point, in both blocked
    # layouts (bell: kernels 4, 2/3 per step and kernel 5 for rel_error)
    for layout in ("symbell", "bell"):
        for path in MATRICES:
            for precond in ("none", "jacobi"):
                n = read_csr_host(os.path.join(ROOT, path))[3][0]
                tol = TOL_SOLVE_REL * bnorm(n)
                dim, nnz, ms, rel, summ, _ = run_tester(path, layout, precond, tol)
                it = summ["iterations"][0]
                what = f"tester {path} --layout {layout} --precond {precond}"
                check(summ["converged"][0], f"{what}: not converged in {it}")
                check(math.isfinite(rel) and rel < REL_ERROR_BOUND,
                      f"{what}: rel_error {rel} >= {REL_ERROR_BOUND}")
                print(f"  {what}: dim {dim} nnz {nnz} {ms:.3f} ms, {it} its "
                      f"({ms / max(it, 1):.4f} ms/it), rel_error {rel:.3e}  [{card}]")
                results[(path, layout, precond)] = (ms, it)
    # (a') full storage on poisson3d_48: the dense route against the packed
    results["routes"] = route_comparison(dev, ops["p3d_full"], card)
    results["sym_routes"] = route_comparison(dev, ops["p3d"], card)

    # (b) n = 262,144 block-tridiagonal: 256 timed steps, then to tolerance
    n = N_BIG
    b = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
    steps = 256
    # tol = -1: no tolerance stops it.  This operator (kappa ~ 1.004) drives
    # the recurrence residual to f32 underflow in ~15 steps; from there the
    # rho == 0 guard keeps every step a full pass over the tiles.
    fused_bell_cg_solve(big, b, tol=-1.0, maxiter=steps)
    t = Timer(dev).start_measure()
    _, info = fused_bell_cg_solve(big, b, tol=-1.0, maxiter=steps)
    t.stop_measure()
    check(int(info.iterations) == steps, f"fixed run took {int(info.iterations)} steps")
    ms_it = t.get_duration() / steps
    eff = big.full_tile_bytes() + 10 * n * 4
    streamed = big.tile_bytes() + 10 * n * 4
    print(f"  fused CG n={n} banded: {ms_it:.5f} ms/it, effective "
          f"{eff / ms_it / 1e6:.1f} GB/s (full-layout {eff / 1e6:.1f} MB/it), "
          f"streamed {streamed / ms_it / 1e6:.1f} GB/s ({streamed / 1e6:.1f} MB/it)  [{card}]")
    # the card's stream rate, measured here: one 1 GiB device-to-device copy
    src = torch.empty(256 << 20, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    copy_gbps = 2 * src.numel() * 4 / cuda_ms(lambda: dst.copy_(src), reps=10) / 1e6
    del src, dst
    print(f"  stream copy {copy_gbps:.1f} GB/s; fused CG streams at "
          f"{streamed / ms_it / 1e6 / copy_gbps:.3f} of it  [{card}]")
    run64 = lambda: fused_bell_cg_solve(big, b, tol=-1.0, maxiter=64)
    t = Timer(dev).start_measure()
    run64()
    t.stop_measure()
    busy = device_ms(run64, reps=1)
    if busy is not None:
        print(f"  fused CG n={n}, 64 steps: device busy {busy:.4f} of "
              f"{t.get_duration():.4f} ms wall ({100 * busy / t.get_duration():.1f}%)  [{card}]")
    else:
        print("  device busy share: not measured (no device time in the trace)")
    _, info2 = fused_bell_cg_solve(big, b, tol=-1.0, maxiter=steps)
    check(torch.equal(info.rho_history.view(torch.int32), info2.rho_history.view(torch.int32)),
          "two fused runs gave different rho_history bits")

    # (b') the same operator in full storage: kernel 4 streams every tile
    fused_bell_cg_solve(big_full, b, tol=-1.0, maxiter=steps)
    t = Timer(dev).start_measure()
    _, infof = fused_bell_cg_solve(big_full, b, tol=-1.0, maxiter=steps)
    t.stop_measure()
    check(int(infof.iterations) == steps, f"full fixed run took {int(infof.iterations)} steps")
    ms_it_full = t.get_duration() / steps
    streamed_full = big_full.tile_bytes() + 10 * n * 4
    print(f"  fused CG n={n} full storage: {ms_it_full:.5f} ms/it, streamed "
          f"{streamed_full / ms_it_full / 1e6:.1f} GB/s ({streamed_full / 1e6:.1f} MB/it), "
          f"{streamed_full / ms_it_full / 1e6 / copy_gbps:.3f} of the copy rate; "
          f"symmetric {ms_it:.5f} ms/it  [{card}]")
    run64f = lambda: fused_bell_cg_solve(big_full, b, tol=-1.0, maxiter=64)
    t = Timer(dev).start_measure()
    run64f()
    t.stop_measure()
    busy = device_ms(run64f, reps=1)
    if busy is not None:
        print(f"  fused CG n={n} full, 64 steps: device busy {busy:.4f} of "
              f"{t.get_duration():.4f} ms wall ({100 * busy / t.get_duration():.1f}%)  [{card}]")
    _, infof2 = fused_bell_cg_solve(big_full, b, tol=-1.0, maxiter=steps)
    check(torch.equal(infof.rho_history.view(torch.int32), infof2.rho_history.view(torch.int32)),
          "two full-storage fused runs gave different rho_history bits")
    # dense tiles keep the dense kernels: 8 steps and rel_error's SpMV
    before = dict(fc.LAUNCHES)
    xf, _ = fused_bell_cg_solve(big_full, b, tol=-1.0, maxiter=8)
    accuracy(big_full, b, xf)
    used = {k: fc.LAUNCHES[k] - before[k] for k in ROUTE_KERNELS + ("bell_pack",)}
    check(used == {"fused_dir_spmv_dot": 8, "fused_dir_spmv_dot_packed": 0, "bell_spmv": 1,
                   "bell_spmv_packed": 0, "bell_pack": 0},
          f"n={n} full storage (dense tiles): launches {used}")
    print(f"  fused CG n={n} full storage, dense tiles: the dense kernels ({used})")
    results["big_full"] = (ms_it_full, streamed_full, copy_gbps)

    cg_solve(big, b, tol=-1.0, maxiter=32, fused="never")
    t = Timer(dev).start_measure()
    cg_solve(big, b, tol=-1.0, maxiter=64, fused="never")
    t.stop_measure()
    plain_ms_it = t.get_duration() / 64
    print(f"  plain-torch CG n={n}: {plain_ms_it:.5f} ms/it, effective "
          f"{eff / plain_ms_it / 1e6:.1f} GB/s  [{card}]")
    results["big"] = (ms_it, plain_ms_it, eff, streamed)

    # fused against the portable loop (plain torch on symmetric storage; on
    # full storage its SpMV is kernel 5)
    for label, a, M in (
        ("tridiag", big, None),
        ("poisson3d_48", p3d, None),
        ("poisson3d_48 jacobi", p3d, "jacobi"),
        ("tridiag full", big_full, None),
        ("poisson3d_48 full", p3d_full, None),
        ("poisson3d_48 full jacobi", p3d_full, "jacobi"),
    ):
        bb = torch.arange(1, a.n + 1, dtype=torch.float32, device=dev)
        tt = TOL_SOLVE_REL * bnorm(a.n)
        Mf = jacobi_preconditioner(a) if M else None
        _, fin = cg_solve(a, bb, tol=tt, M=Mf)
        _, pin = cg_solve(a, bb, tol=tt, M=Mf, fused="never")
        _, f25 = cg_solve(a, bb, tol=0.0, maxiter=25, M=Mf)
        _, p25 = cg_solve(a, bb, tol=0.0, maxiter=25, M=Mf, fused="never")
        ok, used = trajectory_ok(f25.rho_history, p25.rho_history, 25)
        check(ok, f"{label}: fused vs plain rho_history differ beyond rtol {TRAJ_RTOL}")
        check(bool(fin.converged) and bool(pin.converged), f"{label}: a solve did not converge")
        di = abs(int(fin.iterations) - int(pin.iterations))
        check(di <= ITER_SLACK, f"{label}: iterations {int(fin.iterations)} vs {int(pin.iterations)}")
        _, fin2 = cg_solve(a, bb, tol=tt, M=Mf)
        check(torch.equal(fin.rho_history.view(torch.int32), fin2.rho_history.view(torch.int32)),
              f"{label}: fused rho_history not bitwise repeatable")
        print(f"  {label}: fused {int(fin.iterations)} its vs plain {int(pin.iterations)}; "
              f"25-step trajectory agrees on {used} entries; bitwise repeat ok")

    phase_bell_paths(dev, ops, card)

    # the tester's default path: CSR, float64, portable loop; its SpMV is a
    # segmented reduction that must repeat bit for bit on the card
    from conjugategradient_tpu_torch import load_matrix

    csr = load_matrix(os.path.join(ROOT, MATRICES[0]), layout="csr",
                      dtype=np.float64, device=dev)
    b64 = torch.arange(1, csr.n + 1, dtype=torch.float64, device=dev)
    _, i64 = cg_solve(csr, b64, tol=1e-8 * bnorm(csr.n))
    _, i64b = cg_solve(csr, b64, tol=1e-8 * bnorm(csr.n))
    check(bool(i64.converged), "csr float64 solve did not converge")
    check(torch.equal(i64.rho_history.view(torch.int64), i64b.rho_history.view(torch.int64)),
          "csr float64 history not repeatable")
    print(f"  csr float64 poisson3d_48: {int(i64.iterations)} its, bitwise repeat ok")
    torch.cuda.synchronize()
    return results


def phase_bell_paths(dev, ops, card):
    """The portable loop on load_matrix's default 8 x 128 tiles, residual
    replacement on the three loops, and an x0 warm start."""
    import torch

    from conjugategradient_tpu_torch import accuracy, cg_solve, fused_bell_cg_solve
    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.utils import Timer

    # (c) the portable loop on full storage with bm != bn: packed kernel 5
    # once a step (sparse tiles)
    p8 = ops["p3d_8"]
    check((p8.bm, p8.bn) == (8, 128), f"load_matrix default tiles {p8.bm}x{p8.bn}")
    bb = torch.arange(1, p8.n + 1, dtype=torch.float32, device=dev)
    tt = TOL_SOLVE_REL * bnorm(p8.n)
    cg_solve(p8, bb, tol=tt, maxiter=8)
    before = fc.LAUNCHES["bell_spmv_packed"]
    t = Timer(dev).start_measure()
    x, info = cg_solve(p8, bb, tol=tt)
    t.stop_measure()
    k = int(info.iterations)
    launched = fc.LAUNCHES["bell_spmv_packed"] - before
    rel = float(accuracy(p8, bb, x))
    check(bool(info.converged), f"portable bell 8x128: not converged in {k}")
    check(launched >= k + 1, f"portable bell 8x128: {launched} SpMV launches for {k} steps")
    check(rel < REL_ERROR_BOUND, f"portable bell 8x128: rel_error {rel}")
    print(f"  portable loop poisson3d_48 bell 8x128: {k} its, {launched} packed kernel-5 launches, "
          f"{t.get_duration() / k:.4f} ms/it, rel_error {rel:.3e}  [{card}]")

    # (d) recompute_r_every on the fused symmetric and full solves and the
    # portable loop, against the same solves by the plain versions (CPU)
    path = MATRICES[1]
    sym, full, b8 = load_symbell(path, dev), load_bell(path, dev), load_bell(path, dev, bm=8)
    be = torch.arange(1, sym.n + 1, dtype=torch.float32, device=dev)
    for label, a, run in (
        ("fused symmetric", sym, fused_bell_cg_solve),
        ("fused full", full, fused_bell_cg_solve),
        ("portable bell 8x128", b8, cg_solve),
    ):
        _, ic = run(a, be, tol=0.0, maxiter=32, recompute_r_every=RESTART_EVERY)
        _, ip = run(a.to("cpu"), be.cpu(), tol=0.0, maxiter=32, recompute_r_every=RESTART_EVERY)
        hc, hp = ic.rho_history.double().cpu().numpy(), ip.rho_history.double().numpy()
        check(int(ic.iterations) == 32 and np.isfinite(hc).all(),
              f"restart {label}: {int(ic.iterations)} steps, history finite {np.isfinite(hc).all()}")
        err = float(np.max(np.abs(hc - hp) / np.abs(hp)))
        check(err <= RESTART_RTOL, f"restart {label}: card vs plain rel diff {err}")
        print(f"  recompute_r_every={RESTART_EVERY} {label} elasticity3d_16: 32 steps, "
              f"max rel diff to the plain versions {err:.3g}")

    # (e) x0 warm start: r0 = b - A x0 through packed kernel 5
    p3f = ops["p3d_full"]
    x0 = torch.as_tensor(np.random.default_rng(5).standard_normal(p3f.n),
                         dtype=torch.float32, device=dev)
    bb = torch.arange(1, p3f.n + 1, dtype=torch.float32, device=dev)
    before = fc.LAUNCHES["bell_spmv_packed"]
    x, info = fused_bell_cg_solve(p3f, bb, x0, tol=TOL_SOLVE_REL * bnorm(p3f.n))
    r0 = (bb.cpu() - p3f.to("cpu").matvec(x0.cpu())).double()
    e0 = abs(float(info.rho_history[0]) / float(r0 @ r0) - 1)
    rel = float(accuracy(p3f, bb, x))
    check(fc.LAUNCHES["bell_spmv_packed"] > before, "x0 warm start did not launch packed kernel 5")
    check(bool(info.converged) and rel < REL_ERROR_BOUND,
          f"x0 warm start: converged {bool(info.converged)}, rel_error {rel}")
    check(e0 <= TOL_DOT, f"x0 warm start: ||r0||^2 off the plain version by {e0}")
    print(f"  x0 warm start poisson3d_48 full: {int(info.iterations)} its, ||r0||^2 "
          f"rel diff {e0:.3g}, rel_error {rel:.3e}")


def phase_dia_path(dev, ops, card):
    """The DIA / SELL path through its entry points (module doc, phase 3)."""
    import torch

    from conjugategradient_tpu_torch import SellMatrix, cg_solve, jacobi_preconditioner, load_matrix
    from conjugategradient_tpu_torch.io import read_csr_host
    from conjugategradient_tpu_torch.ops.cuda import _common
    from conjugategradient_tpu_torch.solver import cg as cg_mod
    from conjugategradient_tpu_torch.utils import Timer

    # (a) the tester: --layout auto resolves poisson3d_48 to DIA, which the
    # dia_spmv_rows counter shows (7 diagonals: the by-value kernel 7);
    # symdia with Jacobi PCG (a small operator: the route by shape takes the
    # by-value kernel 10, not the tiled one), and on elasticity3d_16 (50
    # stored offsets: one thread a row)
    for path, layout, precond, kernel in (
            (MATRICES[0], "auto", "none", "dia_spmv_rows"),
            (MATRICES[0], "symdia", "jacobi", "sym_dia_spmv_rows"),
            (MATRICES[1], "symdia", "jacobi", "sym_dia_spmv")):
        n = read_csr_host(os.path.join(ROOT, path))[3][0]
        before = _common.LAUNCHES[kernel]
        dim, nnz, ms, rel, summ, _ = run_tester(path, layout, precond, TOL_SOLVE_REL * bnorm(n))
        it = summ["iterations"][0]
        launched = _common.LAUNCHES[kernel] - before
        what = f"tester {path} --layout {layout} --precond {precond}"
        check(summ["converged"][0], f"{what}: not converged in {it}")
        check(math.isfinite(rel) and rel < REL_ERROR_BOUND, f"{what}: rel_error {rel}")
        check(launched >= 2 * it, f"{what}: {launched} {kernel} launches for 2 solves of {it} steps")
        print(f"  {what}: dim {dim} nnz {nnz} {ms:.3f} ms, {it} its ({ms / max(it, 1):.4f} "
              f"ms/it), {launched} {kernel} launches, rel_error {rel:.3e}  [{card}]")

    # (b) --layout auto --reorder on powerlaw_1138 resolves to SELL (plain
    # torch: no kernel of this package)
    path = "problems/powerlaw_1138.mtx"
    op, _ = load_matrix(os.path.join(ROOT, path), layout="auto", reorder=True, device=dev)
    check(isinstance(op, SellMatrix) and op.pos_identity,
          f"auto --reorder on {path} gave {type(op).__name__}")
    before = dict(_common.LAUNCHES)
    n = op.n
    dim, nnz, ms, rel, summ, _ = run_tester(path, "auto", "jacobi", TOL_SOLVE_REL * bnorm(n),
                                            extra=("--reorder",))
    check(summ["converged"][0] and rel < REL_ERROR_BOUND, f"tester {path} sell: rel_error {rel}")
    check(dict(_common.LAUNCHES) == before, "the SELL solve launched a kernel")
    print(f"  tester {path} --layout auto --reorder --precond jacobi (SELL): dim {dim} nnz {nnz} "
          f"{ms:.3f} ms, {summ['iterations'][0]} its, rel_error {rel:.3e}  [{card}]")

    # (c) the float64 auto path (DIA, plain torch) twice: bit for bit
    path = "problems/poisson2d_34.mtx"
    runs = [run_tester(path, "auto", "none", 1e-8 * bnorm(1156), dtype="float64",
                       extra=("--history",)) for _ in range(2)]
    check(runs[0][4]["converged"][0], "f64 auto poisson2d_34 did not converge")
    check(runs[0][5][0].split()[3] == runs[1][5][0].split()[3] and runs[0][5][2] == runs[1][5][2],
          "f64 auto poisson2d_34: the two runs differ")
    print(f"  tester {path} --layout auto --dtype float64 twice: {runs[0][4]['iterations'][0]} its, "
          f"rel_error {runs[0][3]:.3e}, residual history bitwise repeat ok")

    # (d) symdia-big in both storages, DIA_STEPS timed full passes (tol = -1)
    big, big_sym = ops["big"], ops["big_sym"]
    n = big.n
    b = torch.arange(1, n + 1, dtype=torch.float32, device=dev) / n
    eff = nbytes(big.diags) + 7 * n * 4  # full-layout bytes, bench.py's convention
    for label, a, kernel in (("full", big, "dia_spmv"),
                             ("symmetric", big_sym, "sym_dia_spmv_tiled")):
        cg_solve(a, b, tol=-1.0, maxiter=8)
        before = _common.LAUNCHES[kernel]
        t = Timer(dev).start_measure()
        _, info = cg_solve(a, b, tol=-1.0, maxiter=DIA_STEPS)
        t.stop_measure()
        check(int(info.iterations) == DIA_STEPS, f"symdia-big {label}: {int(info.iterations)} steps")
        launched = _common.LAUNCHES[kernel] - before
        check(launched >= DIA_STEPS + 1, f"symdia-big {label}: {launched} launches")
        ms_it = t.get_duration() / DIA_STEPS
        streamed = nbytes(a.diags) + 7 * n * 4
        busy = device_ms(lambda: cg_solve(a, b, tol=-1.0, maxiter=DIA_STEPS), reps=1)
        busy_s = "not measured" if busy is None else \
            f"{busy / DIA_STEPS:.5f} ms/it ({100 * busy / t.get_duration():.1f}%)"
        print(f"  CG symdia-big {label} ({a.ndiag} diagonals): {ms_it:.5f} ms/it, effective "
              f"{eff / ms_it / 1e6:.1f} GB/s ({eff / 1e6:.1f} MB/it full layout), streamed "
              f"{streamed / ms_it / 1e6:.1f} GB/s; device busy {busy_s}; {launched} launches  "
              f"[{card}]")

    # (e) a float32 DIA solve twice (bitwise), and the card against the plain
    # versions on the CPU over 32 steps (trajectory), with and without
    # residual replacement, and symmetric storage with Jacobi
    p3d, p3d_sym = ops["p3d"], ops["p3d_sym"]
    bb = torch.arange(1, p3d.n + 1, dtype=torch.float32, device=dev)
    tt = TOL_SOLVE_REL * bnorm(p3d.n)
    with count_steps(cg_mod, "cg_step") as counter:
        _, i1 = cg_solve(p3d, bb, tol=tt)
    check_stops_at_done("portable DIA CG poisson3d_48", counter.calls, int(i1.iterations))
    _, i2 = cg_solve(p3d, bb, tol=tt)
    check(bool(i1.converged), "f32 DIA poisson3d_48 did not converge")
    check(torch.equal(i1.rho_history.view(torch.int32), i2.rho_history.view(torch.int32)),
          "f32 DIA solve: rho_history not bitwise repeatable")
    print(f"  f32 DIA poisson3d_48: {int(i1.iterations)} its, bitwise repeat ok")
    for label, a, pc, every in (("dia", p3d, False, 0), ("dia", p3d, False, RESTART_EVERY),
                                ("symdia jacobi", p3d_sym, True, 0)):
        Mc = jacobi_preconditioner(a) if pc else None
        ac = a.to("cpu")
        Mp = jacobi_preconditioner(ac) if pc else None
        _, ic = cg_solve(a, bb, tol=0.0, maxiter=32, M=Mc, recompute_r_every=every)
        _, ip = cg_solve(ac, bb.cpu(), tol=0.0, maxiter=32, M=Mp, recompute_r_every=every)
        hc, hp = ic.rho_history.double().cpu().numpy(), ip.rho_history.double().numpy()
        check(np.isfinite(hc).all(), f"f32 {label}: history not finite")
        err = float(np.max(np.abs(hc - hp) / np.abs(hp)))
        check(err <= RESTART_RTOL, f"f32 {label} every={every}: card vs plain rel diff {err}")
        print(f"  f32 {label} poisson3d_48 recompute_r_every={every}: 32 steps, max rel diff "
              f"to the plain versions on the CPU {err:.3g}")
    torch.cuda.synchronize()


# ---- phase 2, stencil: kernels 11-13 against their plain versions ------------

def conv3d_stencil(u, center, off):
    """The 7-point stencil as one cuDNN 3-D convolution (3x3x3 weight,
    zero padding 1): the library yardstick, which the port never calls."""
    import torch

    wgt = torch.zeros(1, 1, 3, 3, 3, dtype=u.dtype, device=u.device)
    wgt[0, 0, 1, 1, 1] = center
    for i, j, k in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0), (1, 1, 2)):
        wgt[0, 0, i, j, k] = off
    return lambda: torch.nn.functional.conv3d(u[None, None], wgt, padding=1)[0, 0]


def nan_mask(shape, at, dev):
    """Where a NaN at ``at`` must reach: the point and its six neighbours."""
    import torch

    want = torch.zeros(shape, dtype=torch.bool, device=dev)
    for d in ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1)):
        idx = tuple(a + b for a, b in zip(at, d))
        if all(0 <= i < n for i, n in zip(idx, shape)):
            want[idx] = True
    return want


def k11_routes(u):
    """Kernel 11's kernels that can take ``u``, each forced: the staged
    kernel where u's rows are 16-byte multiples on an aligned base (whatever
    the size threshold), and the register march; (counter, context)."""
    routes = [("stencil7", stencil_general_route)]
    if (u.shape[2] * u.element_size()) % 16 == 0 and u.data_ptr() % 16 == 0:
        routes.insert(0, ("stencil7_staged", stencil_staged_route))
    return routes


def check_stencil7(shape, dtype, dev, errs, rng):
    """stencil7 on each of its routes (k11_routes) bit for bit against its
    plain version, and a NaN at one point reaching only that point and its
    six neighbours in both."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import stencil as ks

    u = torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=dev)
    un = u.clone()
    at = tuple(n // 2 for n in shape)
    un[at] = float("nan")
    want = nan_mask(shape, at, dev)
    yp, ypn = ks._stencil7_plain(u, 6.0, -1.0), ks._stencil7_plain(un, 6.0, -1.0)
    for name, ctx in k11_routes(u):
        with ctx():
            yk, ykn = ks.stencil7(u, 6.0, -1.0), ks.stencil7(un, 6.0, -1.0)
        torch.cuda.synchronize()
        e, m = rel_max_err(yk, yp)
        check(torch.equal(yk, yp),
              f"{name} {shape} {dtype}: not bit-equal to the plain version ({e})")
        check(torch.equal(torch.isnan(ykn), want) and torch.equal(torch.isnan(ypn), want)
              and torch.equal(ykn.nan_to_num(), ypn.nan_to_num()),
              f"{name} {shape} {dtype}: a NaN reached other points than its neighbours")
        errs[name] = max(errs[name], e)
        print(f"  {name:<15} {str(shape):<16} {str(dtype):<14} bit-equal (max|y| {m:.4g}); "
              f"NaN reaches {int(want.sum())} points in both")
    return u


def check_fused_stencil(shape, dev, errs, rng):
    """fused_stencil_dir_dot: p_new and q bit-equal to the plain version,
    pap within TOL_DOT, two launches bit-identical, a no-op once not live."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.ops.cuda import fused_stencil as kfs

    def vol():
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    r, pold = vol(), vol()
    beta = torch.tensor([[0.37]], dtype=torch.float32, device=dev)
    k1 = kfs.fused_stencil_dir_dot(r, pold, beta, 6.0, -1.0)
    k2 = kfs.fused_stencil_dir_dot(r, pold, beta, 6.0, -1.0)
    pl = kfs._fused_stencil_dir_plain(r, pold, beta, 6.0, -1.0, None, None)
    torch.cuda.synchronize()
    check(torch.equal(k1[0], pl[0]) and torch.equal(k1[1], pl[1]),
          f"fused_stencil_dir_dot {shape}: p_new or q not bit-equal to the plain version")
    e_pap = abs(float(k1[2]) - float(pl[2]))
    check(e_pap <= TOL_DOT * abs(float(pl[2])),
          f"fused_stencil_dir_dot {shape}: pap {float(k1[2])} vs {float(pl[2])}")
    check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
          f"fused_stencil_dir_dot {shape}: two launches differ")
    w = fc.FusedWork.new(dev, maxiter=4)
    w.ctl[fc.C_LIVE] = 0
    out = (torch.full_like(r, 7.0), torch.full_like(r, 7.0))
    kept = [o.clone() for o in out] + [w.scal.clone()]
    kfs.fused_stencil_dir_dot(r, pold, beta, 6.0, -1.0, out=out, work=w)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(kept, [*out, w.scal])),
          f"fused_stencil_dir_dot {shape}: launched with live = 0, it changed its outputs")
    errs["fused_stencil_dir_dot"] = max(errs["fused_stencil_dir_dot"], e_pap)
    print(f"  fused_stencil_dir_dot {str(shape):<16} p_new, q bit-equal; |dpap|={e_pap:.3g} "
          f"(pap {float(pl[2]):.6g}); repeat bit-identical; no-op at live = 0")
    return r, pold, beta


def phase_stencil_kernels(dev, errs, times, extra):
    """Kernels 11-13 against their plain versions and timed, at 256^3 and at
    small ragged shapes."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.ops.cuda import fused_stencil as kfs
    from conjugategradient_tpu_torch.ops.cuda import stencil as ks

    rng = np.random.default_rng(4)
    n = int(np.prod(STENCIL_GRID))
    big = {}
    for dtype in (torch.float32, torch.float64):
        for shape in (STENCIL_GRID,) + STENCIL_SMALL:
            u = check_stencil7(shape, dtype, dev, errs, rng)
            if shape == STENCIL_GRID:
                big[dtype] = u.nan_to_num_(0.0)
    for shape in (STENCIL_GRID, STENCIL_SMALL[0]):
        args = check_fused_stencil(shape, dev, errs, rng)
        if shape == STENCIL_GRID:
            r, pold, beta = args
    for length in (210, 4097):  # n % 4 != 0: the kernel's scalar tail
        check_update((length,), rng, False, errs, f"n={length}", dev)
    x, p, rr, q, _, alpha = check_update((n,), rng, False, errs, "256^3", dev)

    torch.backends.cudnn.allow_tf32 = False  # the yardstick in full float32
    for dtype in (torch.float32, torch.float64):
        u = big[dtype]
        conv = conv3d_stencil(u, 6.0, -1.0)
        lib_ms = library_ms(conv)
        for name, ctx in k11_routes(u):
            with ctx():
                t = time_pair(lambda: ks.stencil7(u, 6.0, -1.0),
                              lambda: ks._stencil7_plain(u, 6.0, -1.0))
                e, m = rel_max_err(conv(), ks.stencil7(u, 6.0, -1.0))
            t.update(bound(2 * nbytes(u), 8 * n,
                           PEAK_F32_PER_S if dtype == torch.float32 else PEAK_F64_PER_S))
            check(e <= TOL_Q * m, f"conv3d yardstick {dtype}: differs from {name} by {e} "
                  f"(max {m})")
            t["library_ms"] = lib_ms
            if dtype == torch.float32:
                times[name] = t
            else:
                extra[f"{name} float64 256^3"] = t
    work = fc.FusedWork.new(dev, maxiter=1 << 20, tol=-1.0)
    out = (torch.empty_like(r), torch.empty_like(r))
    t = time_pair(lambda: kfs.fused_stencil_dir_dot(r, pold, beta, 6.0, -1.0, out=out, work=work),
                  lambda: kfs._fused_stencil_dir_plain(r, pold, beta, 6.0, -1.0, None, None))
    t.update(bound(4 * n * 4, 12 * n), library_ms=None)  # r, p_old in; p_new, q out
    times["fused_stencil_dir_dot"] = t
    out = (torch.empty_like(x), torch.empty_like(x))
    t = time_pair(lambda: fc.fused_update_dot(x, p, rr, q, alpha, out=out, work=work),
                  lambda: fc._update_plain("fused_update_dot", x, p, rr, q, None, alpha, None, None))
    t.update(bound(6 * n * 4, 6 * n), library_ms=None)
    extra["fused_update_dot 256^3"] = t
    torch.cuda.synchronize()


# ---- phase 3, stencil: the matrix-free path (BASELINE config 4) ---------------

def stencil_rhs(n, dev, scale=1.0):
    import torch

    return torch.arange(1, n + 1, dtype=torch.float32, device=dev) / scale


def phase_stencil_path(dev, card):
    """The stencil path through its entry points (module doc, phase 3)."""
    import torch

    from conjugategradient_tpu_torch import (StencilOperator, accuracy, cg_solve,
                                             fused_stencil_cg_solve, multigrid_preconditioner)
    from conjugategradient_tpu_torch.ops.cuda import _common
    from conjugategradient_tpu_torch.solver import cg as cg_mod
    from conjugategradient_tpu_torch.utils import Timer

    # (a) the tester: stencil:64 float32 takes the fused path
    n64 = 64 ** 3
    before = dict(_common.LAUNCHES)
    dim, nnz, ms, rel, summ, _ = run_tester("stencil:64", "csr", "none", TOL_SOLVE_REL * bnorm(n64))
    it = summ["iterations"][0]
    fused = _common.LAUNCHES["fused_stencil_dir_dot"] - before["fused_stencil_dir_dot"]
    check(summ["converged"][0] and math.isfinite(rel) and rel < REL_ERROR_BOUND,
          f"tester stencil:64 f32: converged {summ['converged'][0]} rel_error {rel}")
    check(fused >= 2 * it, f"tester stencil:64 f32: {fused} fused launches for 2 solves of {it}")
    print(f"  tester stencil:64 --dtype float32: dim {dim} nnz {nnz} {ms:.3f} ms, {it} its "
          f"({ms / max(it, 1):.4f} ms/it), rel_error {rel:.3e}  [{card}]")
    # (b) float64 stencil:48 (portable loop on the float64 kernel) twice, bitwise
    n48 = 48 ** 3
    runs = [run_tester("stencil:48", "csr", "none", 1e-8 * bnorm(n48), dtype="float64",
                       extra=("--history",)) for _ in range(2)]
    check(runs[0][4]["converged"][0] and runs[0][3] < REL_ERROR_BOUND,
          f"tester stencil:48 f64: rel_error {runs[0][3]}")
    check(runs[0][5][0].split()[3] == runs[1][5][0].split()[3] and runs[0][5][2] == runs[1][5][2],
          "tester stencil:48 f64: the two runs differ")
    print(f"  tester stencil:48 --dtype float64 twice: {runs[0][4]['iterations'][0]} its, "
          f"{runs[0][2]:.3f} ms, rel_error {runs[0][3]:.3e}, history bitwise repeat ok  [{card}]")
    # (c) the tester with Jacobi and with multigrid, both smoothers
    for precond, extra in (("jacobi", ()), ("amg", ()), ("amg", ("--smoother", "chebyshev"))):
        dim, nnz, ms, rel, summ, _ = run_tester("stencil:64", "csr", precond,
                                                TOL_SOLVE_REL * bnorm(n64), extra=extra)
        it = summ["iterations"][0]
        what = f"tester stencil:64 --precond {precond} {' '.join(extra)}"
        check(summ["converged"][0] and rel < REL_ERROR_BOUND, f"{what}: rel_error {rel}")
        print(f"  {what}: {it} its, {ms:.3f} ms ({ms / max(it, 1):.4f} ms/it), "
              f"rel_error {rel:.3e}  [{card}]")

    # (d) 256^3: the fused stencil CG over STENCIL_STEPS full steps (tol = -1)
    op = StencilOperator.poisson(STENCIL_GRID, device=dev)
    n = op.shape[0]
    b = stencil_rhs(n, dev, scale=n)
    fused_stencil_cg_solve(op, b, tol=-1.0, maxiter=16)
    t = Timer(dev).start_measure()
    _, info = fused_stencil_cg_solve(op, b, tol=-1.0, maxiter=STENCIL_STEPS)
    t.stop_measure()
    check(int(info.iterations) == STENCIL_STEPS, f"stencil fixed run took {int(info.iterations)}")
    ms_it = t.get_duration() / STENCIL_STEPS
    per_it = 10 * n * 4  # kernel 12: 4 volumes; kernel 2: 6
    src = torch.empty(256 << 20, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    copy_gbps = 2 * src.numel() * 4 / cuda_ms(lambda: dst.copy_(src), reps=10) / 1e6
    del src, dst
    print(f"  fused stencil CG 256^3: {ms_it:.5f} ms/it, effective {per_it / ms_it / 1e6:.1f} "
          f"GB/s on {per_it / 1e6:.1f} MB/it (bound {per_it / PEAK_BYTES_PER_S * 1e3:.4f} ms/it), "
          f"{per_it / ms_it / 1e6 / copy_gbps:.3f} of the {copy_gbps:.1f} GB/s copy rate  [{card}]")
    run64 = lambda: fused_stencil_cg_solve(op, b, tol=-1.0, maxiter=64)
    t = Timer(dev).start_measure()
    run64()
    t.stop_measure()
    busy = device_ms(run64, reps=1)
    busy_s = "not measured" if busy is None else \
        f"{busy:.4f} of {t.get_duration():.4f} ms ({100 * busy / t.get_duration():.1f}%)"
    print(f"  fused stencil CG 256^3, 64 steps: device busy {busy_s}  [{card}]")
    _, info2 = fused_stencil_cg_solve(op, b, tol=-1.0, maxiter=STENCIL_STEPS)
    check(torch.equal(info.rho_history.view(torch.int32), info2.rho_history.view(torch.int32)),
          "two fused stencil runs gave different rho_history bits")
    cg_solve(op, b, tol=-1.0, maxiter=4, fused="never")
    t = Timer(dev).start_measure()
    _, pi = cg_solve(op, b, tol=-1.0, maxiter=32, fused="never")
    t.stop_measure()
    plain_ms_it = t.get_duration() / 32
    ok, used = trajectory_ok(info.rho_history, pi.rho_history, 25)
    check(ok, f"stencil 256^3: fused vs portable rho_history differ beyond rtol {TRAJ_RTOL}")
    print(f"  portable loop (fused='never') 256^3: {plain_ms_it:.5f} ms/it; fused vs portable "
          f"25-step trajectory agrees on {used} entries  [{card}]")

    # (e) bench.py's mgpcg comparison: time to tol 1e-5 ||b||, b = arange/n
    bn_ = float(b.double().norm())
    tol = TOL_SOLVE_REL * bn_
    rows = {}
    for label, M in (("plain fused CG", None),
                     ("MG-PCG jacobi", multigrid_preconditioner(op)),
                     ("MG-PCG chebyshev", multigrid_preconditioner(op, smoother="chebyshev"))):
        cg_solve(op, b, tol=tol, M=M)
        with count_steps(cg_mod, "cg_step") as counter:  # the portable loop's steps
            t = Timer(dev).start_measure()
            x, info = cg_solve(op, b, tol=tol, M=M)
            t.stop_measure()
        if M is not None:
            check_stops_at_done(f"{label} 256^3", counter.calls, int(info.iterations))
        true_rel = float((b - op.matvec(x)).double().norm()) / bn_
        # float32's attainable accuracy here is ~eps * kappa ~ 3e-3 of ||b||
        check(bool(info.converged) and true_rel < F32_TRUE_REL_FLOOR,
              f"{label} 256^3: converged {bool(info.converged)}, true rel residual {true_rel}")
        rows[label] = (t.get_duration(), int(info.iterations))
        busy = device_ms(lambda: cg_solve(op, b, tol=tol, M=M), reps=1)
        busy_s = "not measured" if busy is None else \
            f"{busy:.2f} ms ({100 * busy / t.get_duration():.1f}%)"
        print(f"  {label} 256^3 to 1e-5 ||b||: {t.get_duration():.2f} ms, {int(info.iterations)} its "
              f"({t.get_duration() / int(info.iterations):.4f} ms/it), true rel residual "
              f"{true_rel:.3e}; device busy {busy_s}  [{card}]")
    # one V-cycle apply: host wall, device time, kernels and the longest ones
    r = stencil_rhs(n, dev, scale=n)
    for label, M in (("jacobi", multigrid_preconditioner(op)),
                     ("chebyshev", multigrid_preconditioner(op, smoother="chebyshev"))):
        wall = cuda_ms(lambda: M(r), reps=5, warm=1)
        prof = kernel_profile(lambda: M(r))
        if prof is None:
            print(f"  V-cycle apply 256^3 {label}: {wall:.3f} ms; device time not measured")
            continue
        dev_ms, launched, top = prof
        names = "; ".join(f"{k[:48]} {ms:.3f} ms x{c}" for k, ms, c in top)
        print(f"  V-cycle apply 256^3 {label}: {wall:.3f} ms wall, {dev_ms:.3f} ms device "
              f"({100 * dev_ms / wall:.1f}%), {launched} device launches; longest: {names}  [{card}]")
    plain_it = rows["plain fused CG"][1]
    for label in ("MG-PCG jacobi", "MG-PCG chebyshev"):
        check(5 * rows[label][1] <= plain_it, f"{label}: {rows[label][1]} its vs plain {plain_it}")
        print(f"  {label}: {plain_it / rows[label][1]:.1f}x fewer iterations, "
              f"{rows['plain fused CG'][0] / rows[label][0]:.2f}x the plain solve's speed")

    # (f) residual replacement every RESTART_EVERY steps, card against the
    # plain versions on the CPU; a ragged grid too (kernel 2's scalar tail)
    for grid in ((64, 64, 64), (33, 35, 37)):
        sop = StencilOperator.poisson(grid, device=dev)
        bs = stencil_rhs(sop.shape[0], dev)
        _, ic = fused_stencil_cg_solve(sop, bs, tol=0.0, maxiter=32, recompute_r_every=RESTART_EVERY)
        _, ip = fused_stencil_cg_solve(sop.to("cpu"), bs.cpu(), tol=0.0, maxiter=32,
                                       recompute_r_every=RESTART_EVERY)
        hc, hp = ic.rho_history.double().cpu().numpy(), ip.rho_history.double().numpy()
        check(int(ic.iterations) == 32 and np.isfinite(hc).all(), f"restart stencil {grid}")
        err = float(np.max(np.abs(hc - hp) / np.abs(hp)))
        check(err <= RESTART_RTOL, f"restart stencil {grid}: card vs plain rel diff {err}")
        print(f"  recompute_r_every={RESTART_EVERY} fused stencil {grid}: 32 steps, max rel diff "
              f"to the plain versions on the CPU {err:.3g}")
    # (g) x0 warm start: r0 = b - A x0 through stencil7
    sop = StencilOperator.poisson((64, 64, 64), device=dev)
    bs = stencil_rhs(sop.shape[0], dev)
    x0 = torch.as_tensor(np.random.default_rng(6).standard_normal(sop.shape[0]),
                         dtype=torch.float32, device=dev)
    before = k11_launches()
    x, info = fused_stencil_cg_solve(sop, bs, x0, tol=TOL_SOLVE_REL * bnorm(sop.shape[0]))
    r0 = (bs.cpu() - sop.to("cpu").matvec(x0.cpu())).double()
    e0 = abs(float(info.rho_history[0]) / float(r0 @ r0) - 1)
    rel = float(accuracy(sop, bs, x))
    check(k11_launches() > before, "x0 warm start did not launch kernel 11")
    check(bool(info.converged) and rel < REL_ERROR_BOUND and e0 <= TOL_DOT,
          f"stencil x0 warm start: converged {bool(info.converged)}, rel_error {rel}, r0 {e0}")
    print(f"  x0 warm start stencil 64^3: {int(info.iterations)} its, ||r0||^2 rel diff {e0:.3g}, "
          f"rel_error {rel:.3e}")
    # (h) the portable loop on a ragged grid: rows of 37 float32 points are not
    # 16-byte multiples, so kernel 11 takes its register march
    rop = StencilOperator.poisson((33, 35, 37), device=dev)
    before = _common.LAUNCHES["stencil7"]
    _, ri = cg_solve(rop, stencil_rhs(rop.shape[0], dev), tol=-1.0, maxiter=32, fused="never")
    check(int(ri.iterations) == 32 and _common.LAUNCHES["stencil7"] - before >= 32
          and bool(torch.isfinite(ri.rho_history).all()),
          f"portable CG (33, 35, 37): {int(ri.iterations)} its, "
          f"{_common.LAUNCHES['stencil7'] - before} register-march launches")
    print(f"  portable CG stencil (33, 35, 37) float32, 32 steps: "
          f"{_common.LAUNCHES['stencil7'] - before} launches of kernel 11's register march")
    torch.cuda.synchronize()


# ---- phase 3, MINRES: the symmetric-indefinite path ---------------------------

class count_steps(contextlib.AbstractContextManager):
    """Count the calls of a portable loop's step function (``cg_step`` of
    solver/cg.py or ``minres_step`` of solver/minres.py) while inside."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, 0

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def counted(*args, **kwargs):
            self.calls += 1
            return self.real(*args, **kwargs)

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def check_stops_at_done(label, launched, iterations):
    """The repair of the portable loop: steps launched against iterations."""
    extra = launched - iterations
    check(0 <= extra <= STEPS_AFTER_DONE,
          f"{label}: {launched} steps launched for {iterations} iterations "
          f"(more than {STEPS_AFTER_DONE} after done)")
    print(f"  {label}: {launched} steps launched for {iterations} iterations "
          f"({extra} after done; at most {STEPS_AFTER_DONE})")


def ritz_shift(op, fraction):
    """A shift strictly inside the spectrum: ``fraction`` of the way from
    the smallest to the largest Ritz value of 30 Lanczos steps (both lie
    inside the spectrum, so A - shift I is indefinite)."""
    from conjugategradient_tpu_torch.solver.eigs import _lanczos_ritz

    ritz = _lanczos_ritz(op, 30, None, 0, None)[2]
    lo, hi = float(ritz[0]), float(ritz[-1])
    return lo + fraction * (hi - lo), lo, hi


MINRES_DENSE_K1 = ("minres_dir_spmv_dot", "sym_minres_dir_spmv_dot")
MINRES_PACKED_K1 = ("minres_dir_spmv_dot_packed", "sym_minres_dir_spmv_dot_packed")


def minres_route_comparison(dev, p3d, p3d_full, copy_gbps, card):
    """The fused MINRES on poisson3d_48 in both storages, once on the route
    the port picks (the packed kernel 1) and once forced onto the dense
    tiles (``forced_route``): ms/it over MINRES_STEPS steps at tol = -1
    (bench.py's protocol: the init and the steps), the device's busy share
    over 64 steps, the kernels each launched, and the two routes' 25-step
    histories against each other (``trajectory_ok``)."""
    import torch

    from conjugategradient_tpu_torch import fused_minres_solve
    from conjugategradient_tpu_torch.ops.cuda import _common
    from conjugategradient_tpu_torch.ops.spmv import bell_packed_route
    from conjugategradient_tpu_torch.solver.fused_minres import fused_minres_init, fused_minres_step
    from conjugategradient_tpu_torch.utils import Timer

    n = p3d.n
    b = torch.arange(1, n + 1, dtype=torch.float32, device=dev) / n
    watched = MINRES_DENSE_K1 + MINRES_PACKED_K1 + ("minres_update_dot",)
    for label, a in (("full", p3d_full), ("symmetric", p3d)):
        check(bell_packed_route(a), f"poisson3d_48 {label}: not on the packed route")
        hist = {}
        for route in ("packed", "dense"):
            what = f"fused MINRES poisson3d_48 {label}, {route} route"
            with (contextlib.nullcontext() if route == "packed" else forced_route(False)):
                fused_minres_solve(a, b, tol=-1.0, maxiter=8)
                before = {k: _common.LAUNCHES[k] for k in watched}
                t = Timer(dev).start_measure()
                state = fused_minres_init(a, b, None, MINRES_STEPS, tol=-1.0)
                for _ in range(MINRES_STEPS):
                    fused_minres_step(a, state)
                t.stop_measure()
                used = {k: _common.LAUNCHES[k] - before[k] for k in watched}
                check(int(state.k) == MINRES_STEPS, f"{what}: {int(state.k)} steps stepped")
                ms_it = t.get_duration() / MINRES_STEPS
                run64 = lambda: fused_minres_solve(a, b, tol=-1.0, maxiter=64)
                t = Timer(dev).start_measure()
                run64()
                t.stop_measure()
                busy = device_ms(run64, reps=1)
                _, h25 = fused_minres_solve(a, b, tol=0.0, maxiter=25)
            mine = [k for k in MINRES_DENSE_K1 + MINRES_PACKED_K1 if used[k]]
            check(len(mine) == 1 and used[mine[0]] == MINRES_STEPS
                  and used["minres_update_dot"] == MINRES_STEPS
                  and mine[0].endswith("_packed") == (route == "packed"),
                  f"{what}: launches {used}")
            hist[route] = h25.rnorm_history
            busy_s = "not measured" if busy is None else \
                f"{busy:.4f} of {t.get_duration():.4f} ms ({100 * busy / t.get_duration():.1f}%)"
            print(f"  {what}: {ms_it:.5f} ms/it over {MINRES_STEPS} steps; 64 steps: device busy "
                  f"{busy_s}; launches {used}  [{card}]")
        ok, n_used = trajectory_ok(hist["packed"], hist["dense"], 25)
        check(ok and n_used >= PARITY_MIN_USED,
              f"fused MINRES poisson3d_48 {label}: packed vs dense history beyond rtol "
              f"{TRAJ_RTOL} ({n_used} entries above the floor)")
        hp, hd = (hist[r][1:26].double().cpu().numpy() for r in ("packed", "dense"))
        print(f"  fused MINRES poisson3d_48 {label}: the two routes' 25-step histories agree on "
              f"{n_used} entries (largest relative difference {np.abs(hp / hd - 1).max():.2g})")
    torch.cuda.synchronize()


def phase_minres_path(dev, big, big_full, ops, card):
    """The MINRES path through its entry points (module doc, phase 3)."""
    import torch

    from conjugategradient_tpu_torch import (fused_minres_solve, jacobi_preconditioner,
                                             minres_solve)
    from conjugategradient_tpu_torch.io import read_csr_host
    from conjugategradient_tpu_torch.ops.cuda import _common
    from conjugategradient_tpu_torch.solver import minres as minres_mod
    from conjugategradient_tpu_torch.solver.fused_minres import fused_minres_init, fused_minres_step
    from conjugategradient_tpu_torch.utils import Timer

    p3d, p3d_full = ops["p3d"], ops["p3d_full"]
    path = MATRICES[0]
    n = read_csr_host(os.path.join(ROOT, path))[3][0]
    tol = TOL_SOLVE_REL * bnorm(n)
    minres = ("--method", "minres")
    # (a) the tester with --method minres, both blocked layouts: sparse
    # tiles, so the packed kernel 1 in both
    for layout, kernel in (("symbell", "sym_minres_dir_spmv_dot_packed"),
                           ("bell", "minres_dir_spmv_dot_packed")):
        for precond in ("none", "jacobi"):
            before = dict(_common.LAUNCHES)
            dim, nnz, ms, rel, summ, _ = run_tester(path, layout, precond, tol, extra=minres)
            it = summ["iterations"][0]
            launched = _common.LAUNCHES[kernel] - before[kernel]
            dense = sum(_common.LAUNCHES[k] - before[k] for k in MINRES_DENSE_K1)
            what = f"tester {path} --method minres --layout {layout} --precond {precond}"
            check(summ["converged"][0], f"{what}: not converged in {it}")
            check(math.isfinite(rel) and rel < REL_ERROR_BOUND, f"{what}: rel_error {rel}")
            check(launched >= 2 * it and dense == 0,
                  f"{what}: {launched} {kernel} launches for 2 solves of {it}, {dense} dense")
            print(f"  {what}: dim {dim} nnz {nnz} {ms:.3f} ms, {it} its ({ms / max(it, 1):.4f} "
                  f"ms/it), rel_error {rel:.3e}  [{card}]")
    # once with a shift inside the spectrum (indefinite)
    shift, lo, hi = ritz_shift(p3d, 0.002)
    dim, nnz, ms, rel, summ, _ = run_tester(path, "symbell", "none", tol,
                                            extra=minres + ("--shift", repr(shift)))
    it = summ["iterations"][0]
    check(summ["converged"][0] and math.isfinite(rel) and rel < REL_ERROR_BOUND,
          f"tester --method minres --shift {shift}: converged {summ['converged'][0]} "
          f"in {it}, rel_error {rel}")
    print(f"  tester {path} --method minres --layout symbell --shift {shift:.5f} (Ritz extremes "
          f"{lo:.4f}, {hi:.4f}): {it} its, {ms:.3f} ms, rel_error {rel:.3e}  [{card}]")
    # the float64 CSR path (portable loop) twice: bit for bit
    runs = [run_tester(path, "csr", "none", 1e-8 * bnorm(n), dtype="float64",
                       extra=minres + ("--history",)) for _ in range(2)]
    check(runs[0][4]["converged"][0] and runs[0][3] < REL_ERROR_BOUND,
          f"tester --method minres csr f64: rel_error {runs[0][3]}")
    check(runs[0][5][0].split()[3] == runs[1][5][0].split()[3] and runs[0][5][2] == runs[1][5][2],
          "tester --method minres csr f64: the two runs differ")
    print(f"  tester {path} --method minres --layout csr --dtype float64 twice: "
          f"{runs[0][4]['iterations'][0]} its, {runs[0][2]:.3f} ms, rel_error {runs[0][3]:.3e}, "
          f"history bitwise repeat ok  [{card}]")

    # (b) n = 262,144, both storages: MINRES_STEPS timed steps.  tol = -1: this
    # operator (kappa ~ 1.004) drives the estimate to float32 underflow in
    # ~16 steps, and 0 <= 0 would end a tol = 0 run there.
    n = N_BIG
    b = torch.arange(1, n + 1, dtype=torch.float32, device=dev) / n
    src = torch.empty(256 << 20, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    copy_gbps = 2 * src.numel() * 4 / cuda_ms(lambda: dst.copy_(src), reps=10) / 1e6
    del src, dst
    eff = big_full.tile_bytes() + 14 * n * 4
    before = dict(_common.LAUNCHES)
    for label, a in (("symmetric", big), ("full", big_full)):
        fused_minres_solve(a, b, tol=-1.0, maxiter=MINRES_STEPS)
        # bench.py's protocol: the init and MINRES_STEPS steps (no exit work)
        t = Timer(dev).start_measure()
        state = fused_minres_init(a, b, None, MINRES_STEPS, tol=-1.0)
        for _ in range(MINRES_STEPS):
            fused_minres_step(a, state)
        t.stop_measure()
        check(int(state.k) == MINRES_STEPS, f"fused MINRES {label}: {int(state.k)} steps stepped")
        ms_it = t.get_duration() / MINRES_STEPS
        # and the whole solve: the flush and rnorm_true's extra SpMV included
        t = Timer(dev).start_measure()
        _, info = fused_minres_solve(a, b, tol=-1.0, maxiter=MINRES_STEPS)
        t.stop_measure()
        solve_ms = t.get_duration()
        check(int(info.iterations) == MINRES_STEPS and bool(torch.isfinite(info.rnorm_history).all()),
              f"fused MINRES {label}: {int(info.iterations)} steps, history finite "
              f"{bool(torch.isfinite(info.rnorm_history).all())}")
        check(torch.equal(info.rnorm_history.view(torch.int32), state.hist.view(torch.int32)),
              f"fused MINRES {label}: stepping and solving gave different history bits")
        streamed = a.tile_bytes() + 14 * n * 4
        run64 = lambda: fused_minres_solve(a, b, tol=-1.0, maxiter=64)
        t = Timer(dev).start_measure()
        run64()
        t.stop_measure()
        busy = device_ms(run64, reps=1)
        busy_s = "not measured" if busy is None else \
            f"{busy:.4f} of {t.get_duration():.4f} ms ({100 * busy / t.get_duration():.1f}%)"
        _, info2 = fused_minres_solve(a, b, tol=-1.0, maxiter=MINRES_STEPS)
        check(torch.equal(info.rnorm_history.view(torch.int32), info2.rnorm_history.view(torch.int32)),
              f"fused MINRES {label}: two runs gave different history bits")
        minres_solve(a, b, tol=-1.0, maxiter=8, fused="never")
        t = Timer(dev).start_measure()
        _, pinfo = minres_solve(a, b, tol=-1.0, maxiter=32, fused="never")
        t.stop_measure()
        port_ms_it = t.get_duration() / 32
        print(f"  fused MINRES n={n} {label}: {ms_it:.5f} ms/it (whole solve {solve_ms:.3f} ms for "
              f"{MINRES_STEPS} steps), effective {eff / ms_it / 1e6:.1f} "
              f"GB/s on {eff / 1e6:.1f} MB/it (full layout), streamed {streamed / ms_it / 1e6:.1f} "
              f"GB/s ({streamed / 1e6:.1f} MB/it), {streamed / ms_it / 1e6 / copy_gbps:.3f} of the "
              f"{copy_gbps:.1f} GB/s copy rate; 64 steps: device busy {busy_s}; bitwise repeat ok; "
              f"portable MINRES loop {port_ms_it:.5f} ms/it  [{card}]")
    packed_used = sum(_common.LAUNCHES[k] - before[k] for k in MINRES_PACKED_K1)
    check(packed_used == 0, f"fused MINRES n={n}: the dense tiles took the packed kernel "
          f"{packed_used} times")

    # (b2) poisson3d_48 (sparse tiles) in both storages on its own route,
    # the packed kernel, and forced onto the dense tiles
    minres_route_comparison(dev, p3d, p3d_full, copy_gbps, card)

    # (c) fused against the portable loop on the card (the plain torch
    # recurrence; on full storage its SpMV is kernel 5), and repeatability
    for label, a, M in (("tridiag", big, None), ("tridiag full", big_full, None),
                        ("poisson3d_48", p3d, None), ("poisson3d_48 jacobi", p3d, "jacobi"),
                        ("poisson3d_48 full", p3d_full, None),
                        ("poisson3d_48 full jacobi", p3d_full, "jacobi")):
        bb = torch.arange(1, a.n + 1, dtype=torch.float32, device=dev) / a.n
        tt = TOL_SOLVE_REL * float(bb.double().norm())
        Mf = jacobi_preconditioner(a) if M else None
        _, fin = minres_solve(a, bb, tol=tt, M=Mf)
        with count_steps(minres_mod, "minres_step") as counter:
            _, pin = minres_solve(a, bb, tol=tt, M=Mf, fused="never")
        _, f25 = minres_solve(a, bb, tol=0.0, maxiter=25, M=Mf)
        _, p25 = minres_solve(a, bb, tol=0.0, maxiter=25, M=Mf, fused="never")
        hf, hp = f25.rnorm_history.double().cpu().numpy(), p25.rnorm_history.double().cpu().numpy()
        keep = np.isfinite(hp) & (hp > 1e-5 * hp[0])  # above the float32 floor
        check(np.allclose(hf[keep], hp[keep], rtol=MINRES_TRAJ_RTOL, atol=0),
              f"MINRES {label}: fused vs portable history differ beyond rtol {MINRES_TRAJ_RTOL}")
        check(bool(fin.converged) and bool(pin.converged), f"MINRES {label}: a solve did not converge")
        di = abs(int(fin.iterations) - int(pin.iterations))
        check(di <= ITER_SLACK, f"MINRES {label}: iterations {int(fin.iterations)} vs {int(pin.iterations)}")
        _, fin2 = minres_solve(a, bb, tol=tt, M=Mf)
        check(torch.equal(fin.rnorm_history.view(torch.int32), fin2.rnorm_history.view(torch.int32)),
              f"MINRES {label}: fused history not bitwise repeatable")
        print(f"  MINRES {label}: fused {int(fin.iterations)} its vs portable {int(pin.iterations)}; "
              f"25-step history agrees on {int(keep.sum())} entries; bitwise repeat ok")
        check_stops_at_done(f"portable MINRES {label}", counter.calls, int(pin.iterations))

    # (d) an indefinite solve in both storages: shift between the Ritz extremes
    sym, full = load_symbell(MATRICES[1], dev), load_bell(MATRICES[1], dev)
    shift, lo, hi = ritz_shift(sym, 0.01)
    be = torch.arange(1, sym.n + 1, dtype=torch.float32, device=dev)
    tt = MINRES_INDEF_TOL_REL * float(be.double().norm())
    for label, a in (("symmetric", sym), ("full", full)):
        x, info = minres_solve(a, be, tol=tt, shift=shift, maxiter=4 * a.n)
        k = int(info.iterations)
        h = info.rnorm_history.double().cpu().numpy()[: k + 1]
        true_r = float((be - (a.matvec(x) - shift * x)).double().norm())
        check(bool(info.converged), f"indefinite MINRES {label}: not converged in {k}")
        check(bool(np.all(np.diff(h) <= 0)), f"indefinite MINRES {label}: the history increases")
        check(abs(float(info.rnorm_true) - true_r) <= 1e-3 * true_r
              and true_r <= MINRES_TRUE_FACTOR * max(float(info.rnorm), tt),
              f"indefinite MINRES {label}: rnorm_true {float(info.rnorm_true)}, ||b - (A - sI)x|| "
              f"{true_r}, estimate {float(info.rnorm)}")
        print(f"  indefinite MINRES elasticity3d_16 {label}, shift {shift:.4f} (Ritz extremes "
              f"{lo:.4f}, {hi:.4f}): {k} its to {MINRES_INDEF_TOL_REL:g} ||b||, history "
              f"non-increasing, rnorm_true / rnorm = {float(info.rnorm_true) / float(info.rnorm):.2f} "
              f"(at most {MINRES_TRUE_FACTOR:g})")

    # (e) caps of 1, 2 and 7 steps: the pending update is flushed
    bb = torch.arange(1, p3d.n + 1, dtype=torch.float32, device=dev) / p3d.n
    for a, label in ((p3d, "symmetric"), (p3d_full, "full")):
        for cap in (1, 2, 7):
            xf, fi = fused_minres_solve(a, bb, tol=0.0, maxiter=cap)
            xp, _ = minres_solve(a, bb, tol=0.0, maxiter=cap, fused="never")
            e, m = rel_max_err(xf, xp)
            check(int(fi.iterations) == cap and e <= 1e-4 * m,
                  f"MINRES cap {cap} {label}: {int(fi.iterations)} steps, x differs by {e} (max {m})")
    print("  fused MINRES capped at 1, 2, 7 steps (both storages): x equals the portable "
          "loop's to 1e-4 of max|x|")
    # (f) b = 0, and an x0 warm start (r0 through kernel 5 on full storage)
    x, info = minres_solve(p3d, torch.zeros_like(bb), tol=1e-30)
    check(int(info.iterations) == 0 and bool(info.converged) and not bool(x.any()),
          f"MINRES b = 0: {int(info.iterations)} iterations")
    x0 = torch.as_tensor(np.random.default_rng(5).standard_normal(p3d_full.n),
                         dtype=torch.float32, device=dev)
    bb = torch.arange(1, p3d_full.n + 1, dtype=torch.float32, device=dev)
    before = kernel5_launches()
    x, info = minres_solve(p3d_full, bb, x0, tol=tol)
    r0 = (bb.cpu() - p3d_full.to("cpu").matvec(x0.cpu())).double()
    e0 = abs(float(info.rnorm_history[0]) / float(r0.norm()) - 1)
    true_rel = float((bb - p3d_full.matvec(x)).double().norm()) / float(bb.double().norm())
    check(kernel5_launches() >= before + 2, "MINRES x0 warm start did not launch kernel 5")
    check(bool(info.converged) and e0 <= TOL_DOT and true_rel < 1e-3,
          f"MINRES x0 warm start: converged {bool(info.converged)}, ||r0|| off by {e0}, true "
          f"relative residual {true_rel}")
    print(f"  MINRES b = 0: 0 its; x0 warm start poisson3d_48 full: {int(info.iterations)} its, "
          f"||r0|| rel diff {e0:.3g}, true relative residual {true_rel:.3e}")
    torch.cuda.synchronize()


F32_EPS = float(np.finfo(np.float32).eps)


def residual_norm(host, x) -> float:
    """||b - A x|| in float64 on the host, b = 1..n as the tester's."""
    data, indices, indptr, shape = host
    rows = np.repeat(np.arange(shape[0]), np.diff(indptr))
    ax = np.bincount(rows, weights=data * x[indices], minlength=shape[0])
    return float(np.linalg.norm(np.arange(1, shape[0] + 1) - ax))


def rel_error(host, x) -> float:
    return residual_norm(host, x) ** 2 / float(x @ x)


def bicg_tester_rerun(path, layout, precond, tol, device):
    """The tester's float32 BiCGStab solve (b = 1..n, its default 128 x 128
    tiles) run again through bicgstab_solve on ``device``: the history as
    the tester prints it (norms through their float32 squares; None for
    NaN) and x as float64 on the host."""
    import torch

    from conjugategradient_tpu_torch import bicgstab_solve, jacobi_preconditioner, load_matrix

    a = load_matrix(os.path.join(ROOT, path), layout=layout, dtype=np.float32, bm=128, bn=128,
                    device=device)
    b = torch.arange(1, a.shape[0] + 1, dtype=torch.float32, device=device)
    m = jacobi_preconditioner(a) if precond == "jacobi" else None
    x, info = bicgstab_solve(a, b, tol=tol, M=m)
    k = int(info.iterations)
    sq = np.sqrt((info.rnorm_history * info.rnorm_history).double().cpu().numpy()[:k + 1])
    return [float(h) if np.isfinite(h) else None for h in sq], x.double().cpu().numpy()


def bicg_gap_sweep(host, tol, seeds):
    """BiCGStab's float32 residual gap on the host: the system with its
    unknowns renumbered ``seeds`` ways (every dot and row sum then rounds
    another way), each solved without and with Jacobi.  Returns the gap
    ||b - Ax|| / (eps max_k ||r_k||) and max_k ||r_k|| / ||b|| of every
    converged solve, and the count of those that broke down."""
    import torch

    from conjugategradient_tpu_torch import CSRMatrix, bicgstab_solve, jacobi_preconditioner

    data, indices, indptr, shape = host
    n = shape[0]
    rows = np.repeat(np.arange(n), np.diff(indptr))
    b0 = np.arange(1, n + 1, dtype=np.float64)
    ks, peaks, broke = [], [], 0
    for seed in range(seeds):
        perm = np.random.default_rng(seed).permutation(n)
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        a = CSRMatrix.from_coo(inv[rows], inv[indices], data, shape, dtype=torch.float32,
                               device="cpu")
        b = torch.from_numpy(b0[perm].astype(np.float32))
        for m in (None, jacobi_preconditioner(a)):
            x, info = bicgstab_solve(a, b, tol=tol, M=m)
            if not bool(info.converged):  # a breakdown: no converged x to read
                broke += 1
                continue
            peak = float(info.rnorm_history[:int(info.iterations) + 1].max())
            ks.append(residual_norm(host, x.double().numpy()[inv]) / (F32_EPS * peak))
            peaks.append(peak / float(np.linalg.norm(b0)))
    return ks, peaks, broke


BICG_ROUTE_KERNELS = ("bicgstab_dir_spmv_dot", "bicgstab_s_spmv_dot",
                      "bicgstab_dir_spmv_dot_packed", "bicgstab_s_spmv_dot_packed")


def bicg_route_comparison(dev, cd, b, card):
    """The fused BiCGStab on convdiff-512 once on the dense route and once
    on the packed route (``forced_route``), unpreconditioned and with
    Jacobi: ms/it over BICG_STEPS steps at tol = 0 (init included), the
    kernels each launched, and the two 25-step histories against each
    other (section (e)'s bounds)."""
    import torch

    from conjugategradient_tpu_torch import fused_bicgstab_solve, jacobi_preconditioner
    from conjugategradient_tpu_torch.ops.cuda import _common
    from conjugategradient_tpu_torch.utils import Timer

    for precond in ("none", "jacobi"):
        inv = jacobi_preconditioner(cd).inv_diag if precond == "jacobi" else None
        hist = {}
        for route in ("dense", "packed"):
            what = f"fused BiCGStab convdiff nx=512 precond {precond}, {route} route"
            with forced_route(route == "packed"):
                fused_bicgstab_solve(cd, b, tol=0.0, maxiter=8, inv_diag=inv)
                before = {k: _common.LAUNCHES[k] for k in BICG_ROUTE_KERNELS}
                t = Timer(dev).start_measure()
                _, info = fused_bicgstab_solve(cd, b, tol=0.0, maxiter=BICG_STEPS, inv_diag=inv)
                t.stop_measure()
                used = {k: _common.LAUNCHES[k] - before[k] for k in BICG_ROUTE_KERNELS}
                _, h25 = fused_bicgstab_solve(cd, b, tol=0.0, maxiter=25, inv_diag=inv)
            k = int(info.iterations)
            check(k == BICG_STEPS and not bool(info.breakdown),
                  f"{what}: {k} of {BICG_STEPS} steps, breakdown {bool(info.breakdown)}")
            check(all(used[n] == (BICG_STEPS if n.endswith("_packed") == (route == "packed") else 0)
                      for n in BICG_ROUTE_KERNELS), f"{what}: launches {used}")
            hist[route] = h25.rnorm_history.double().cpu().numpy()
            print(f"  {what}: {t.get_duration() / BICG_STEPS:.5f} ms/it over {BICG_STEPS} steps, "
                  f"launches {used}  [{card}]")
        hd, hp = hist["dense"], hist["packed"]
        check(np.allclose(hp[:11], hd[:11], rtol=BICG_TRAJ_RTOL, atol=0)
              and np.isfinite(hp).all() and np.isfinite(hd).all(),
              f"fused BiCGStab convdiff nx=512 {precond}: packed vs dense history {hp.tolist()} vs "
              f"{hd.tolist()}")
        print(f"  fused BiCGStab convdiff nx=512 {precond}: the two routes' 25-step histories agree "
              f"within {BICG_TRAJ_RTOL:g} over 10 steps (largest difference there "
              f"{np.abs(hp[:11] / hd[:11] - 1).max():.2g}, to step 25 {np.abs(hp / hd - 1).max():.2g})")
    torch.cuda.synchronize()


def phase_bicgstab_path(dev, bic_ops, card):
    """The BiCGStab path through its entry points (module doc, phase 3)."""
    import torch

    from conjugategradient_tpu_torch import (bicgstab_solve, fused_bicgstab_solve,
                                             jacobi_preconditioner)
    from conjugategradient_tpu_torch.io import loader
    from conjugategradient_tpu_torch.ops.cuda import _common
    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb
    from conjugategradient_tpu_torch.ops.spmv import bell_packed_route
    from conjugategradient_tpu_torch.solver import bicgstab as bicgstab_mod
    from conjugategradient_tpu_torch.solver.fused_bicgstab import (fused_bicgstab_init,
                                                                   fused_bicgstab_step)
    from conjugategradient_tpu_torch.types import BlockedEllMatrix, DIAMatrix
    from conjugategradient_tpu_torch.utils import Timer

    # (a) the tester with --method bicgstab on the general convdiff_34.mtx;
    # each float32 line is run again through bicgstab_solve on the card (the
    # same history, and x for the true residual) and on the host (where the
    # two trajectories part)
    path, nb = CONVDIFF, bnorm(1156)
    tol = TOL_SOLVE_REL * nb
    host = loader.read_csr_host(os.path.join(ROOT, path))  # float64 CSR
    ks, peaks, broke = bicg_gap_sweep(host, tol, GAP_SEEDS)
    check(len(ks) >= GAP_SEEDS and max(ks) <= GAP_ULPS, f"BiCGStab float32 on the host: ||b - Ax|| up to {max(ks):.1f} "
          f"eps max_k ||r_k||, above GAP_ULPS = {GAP_ULPS}")
    print(f"  BiCGStab float32 residual gap on the host, convdiff_34 renumbered {GAP_SEEDS} ways "
          f"x (none, jacobi), {broke} breakdowns: ||b - Ax|| = {min(ks):.1f}-{max(ks):.1f} eps "
          f"max_k ||r_k|| (GAP_ULPS {GAP_ULPS}), max_k ||r_k|| = {min(peaks):.3g}-{max(peaks):.3g} "
          f"||b||")
    bicg = ("--method", "bicgstab")
    for layout, precond, kernel in (("bell", "none", "bell_spmv_packed"),
                                    ("dia", "jacobi", "dia_spmv_rows"),
                                    ("auto", "none", "dia_spmv_rows")):
        before = _common.LAUNCHES[kernel]
        dim, nnz, ms, rel, summ, lines = run_tester(path, layout, precond, tol,
                                                    extra=bicg + ("--history",))
        it = summ["iterations"][0]
        printed = json.loads(lines[2])["residual_norms"]
        launched = _common.LAUNCHES[kernel] - before
        what = f"tester {path} --method bicgstab --layout {layout} --precond {precond}"
        hist, x = bicg_tester_rerun(path, layout, precond, tol, dev)
        check(hist == printed, f"{what}: bicgstab_solve on the same inputs gave another history")
        hist_host, x_host = bicg_tester_rerun(path, layout, precond, tol, "cpu")
        peak, true_r = max(h for h in hist if h is not None), residual_norm(host, x)
        gap = true_r / (F32_EPS * peak)
        bound_ = max(REL_ERROR_BOUND, ((tol + GAP_ULPS * F32_EPS * peak) / np.linalg.norm(x)) ** 2)
        check(summ["converged"][0] and math.isfinite(rel) and rel < bound_,
              f"{what}: converged {summ['converged'][0]} in {it}, rel_error {rel} >= {bound_:.3g}")
        check(gap <= GAP_ULPS, f"{what}: ||b - Ax|| = {gap:.1f} eps max_k ||r_k||")
        check(launched >= 2 * 2 * it, f"{what}: {launched} {kernel} launches for 2 solves of {it}")
        peak_host = max(h for h in hist_host if h is not None)
        part = next((k for k, (c, h) in enumerate(zip(hist, hist_host))
                     if c is None or h is None or abs(c - h) > 1e-3 * h), None)
        print(f"  {what}: dim {dim} nnz {nnz} {ms:.3f} ms, {it} its ({ms / max(it, 1):.4f} ms/it), "
              f"rel_error {rel:.3e} (bound {bound_:.3g}), largest ||r_k|| {peak / nb:.3g} ||b|| at "
              f"step {hist.index(peak)}, ||b - Ax|| {true_r / nb:.3g} ||b|| = {gap:.1f} eps "
              f"max_k ||r_k||; on the host {len(hist_host) - 1} its, largest ||r_k|| "
              f"{peak_host / nb:.3g} ||b||, rel_error {rel_error(host, x_host):.3e}; the card's "
              f"history parts from the host's by 1e-3 at step {part}  [{card}]")
    runs = [run_tester(path, "csr", "none", 1e-8 * nb, dtype="float64", extra=bicg + ("--history",))
            for _ in range(2)]
    check(runs[0][4]["converged"][0] and runs[0][3] < REL_ERROR_BOUND,
          f"tester --method bicgstab csr f64: rel_error {runs[0][3]}")
    check(runs[0][5][0].split()[3] == runs[1][5][0].split()[3] and runs[0][5][2] == runs[1][5][2],
          "tester --method bicgstab csr f64: the two runs differ")
    print(f"  tester {path} --method bicgstab --layout csr --dtype float64 twice: "
          f"{runs[0][4]['iterations'][0]} its, {runs[0][2]:.3f} ms, rel_error {runs[0][3]:.3e}, "
          f"history bitwise repeat ok  [{card}]")

    # (b) fused="always" on bench.py:1367's operator, b = arange(1, n+1)/n:
    # diagonally dominant (kappa ~ 1.015), so a few steps
    a = bic_ops["bench_bell"]
    n = a.n
    b = torch.arange(1, n + 1, dtype=torch.float32, device=dev) / n
    bn_ = float(b.double().norm())
    for tol in (TOL_SOLVE_REL * bn_, 0.0):
        before = {k: _common.LAUNCHES[k] for k in BICG_ROUTE_KERNELS}
        xf, fi = bicgstab_solve(a, b, tol=tol, maxiter=64, fused="always")
        used = {k: _common.LAUNCHES[k] - before[k] for k in BICG_ROUTE_KERNELS}
        launched = used["bicgstab_dir_spmv_dot"]
        check(used["bicgstab_s_spmv_dot"] == launched and not bell_packed_route(a)
              and all(used[k] == 0 for k in BICG_ROUTE_KERNELS if k.endswith("_packed")),
              f"fused BiCGStab bicgstab-bell (dense tiles): launches {used}")
        xp, pi = bicgstab_solve(a, b, tol=tol, maxiter=64)
        true_r = float((b - a.matvec(xf)).double().norm())
        k = int(fi.iterations)
        check(launched >= k and torch.isfinite(xf).all(), f"fused BiCGStab tol={tol}: {launched} launches, x finite "
              f"{bool(torch.isfinite(xf).all())}")
        check(k <= BICG_BENCH_MAX_K and true_r <= TOL_SOLVE_REL * bn_
              and abs(float(fi.rnorm_true) - true_r) <= 1e-3 * true_r + 1e-7 * bn_,
              f"fused BiCGStab tol={tol}: {k} its, ||b - Ax|| {true_r}, rnorm_true {float(fi.rnorm_true)}")
        check(bool(fi.converged) == bool(pi.converged) and bool(fi.breakdown) == bool(pi.breakdown),
              f"fused BiCGStab tol={tol}: converged/breakdown {bool(fi.converged)}/{bool(fi.breakdown)}, "
              f"portable {bool(pi.converged)}/{bool(pi.breakdown)}")
        e, m = rel_max_err(xf, xp)
        check(e <= 1e-4 * m, f"fused BiCGStab tol={tol}: x differs from the portable loop's by {e}")
        print(f"  fused BiCGStab bicgstab-bell n={n}, tol {tol:.3g}: {k} its (portable "
              f"{int(pi.iterations)}), converged {bool(fi.converged)}, breakdown {bool(fi.breakdown)} "
              f"as the portable loop; history {[float(h) for h in fi.rnorm_history[:k + 1]]}; "
              f"rnorm_true {float(fi.rnorm_true):.4g} = ||b - Ax||")

    # (c) the steady-state timing: bench.py's bicgstab-bell lane times 128
    # steps that its operator does not have (it ends in ~4), so the timed
    # operator is bench.py:1113's convection-diffusion at n = 262,144 (nx =
    # 512) as full blocked-ELL 128 x 128.  Its right-hand side is a seeded
    # standard normal: with b = arange(1, n+1)/n (or ones) the shadow
    # residual decorrelates and rho = r^.r comes out exactly 0 in float32 after
    # 90-202 steps, a Lanczos breakdown, while with this b every one of the
    # 256 steps at tol = 0 stays live (checked below)
    cd = bic_ops["convdiff"]
    n = cd.n
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(n), dtype=torch.float32,
                        device=dev)
    # the operator's sparse tiles take the packed kernels 18 and 19.  The
    # effective rate keeps bench.py's convention (the full layout's bytes:
    # 2 tile streams + 17 vectors), which is not a stream rate on this
    # route; the needed-bytes rate counts the nonzeros the two products
    # read (8 bytes each) and the same 17 vectors
    check(bell_packed_route(cd), "convdiff-512: the route does not take the packed view")
    eff = 2 * cd.tile_bytes() + 17 * n * 4
    needed = 2 * 8 * cd.packed().nnz + 17 * n * 4
    fused_bicgstab_solve(cd, b, tol=0.0, maxiter=8)
    before = {k_: _common.LAUNCHES[k_] for k_ in BICG_ROUTE_KERNELS}
    t = Timer(dev).start_measure()
    state = fused_bicgstab_init(cd, b, None, BICG_STEPS)
    for _ in range(BICG_STEPS):
        fused_bicgstab_step(cd, state)
    t.stop_measure()
    used = {k_: _common.LAUNCHES[k_] - before[k_] for k_ in BICG_ROUTE_KERNELS}
    check(used == {"bicgstab_dir_spmv_dot": 0, "bicgstab_s_spmv_dot": 0,
                   "bicgstab_dir_spmv_dot_packed": BICG_STEPS,
                   "bicgstab_s_spmv_dot_packed": BICG_STEPS},
          f"fused BiCGStab convdiff: launches {used} in {BICG_STEPS} steps")
    k = int(state.k)
    check(k == BICG_STEPS and not bool(state.done),
          f"fused BiCGStab convdiff: {k} of {BICG_STEPS} steps live, done {bool(state.done)}")
    ms_it = t.get_duration() / BICG_STEPS
    t = Timer(dev).start_measure()
    _, info = fused_bicgstab_solve(cd, b, tol=0.0, maxiter=BICG_STEPS)
    t.stop_measure()
    solve_ms = t.get_duration()
    check(int(info.iterations) == BICG_STEPS and not bool(info.breakdown)
          and bool(torch.isfinite(info.rnorm_history).all()),
          f"fused BiCGStab convdiff solve: {int(info.iterations)} its, breakdown {bool(info.breakdown)}")
    check(torch.equal(info.rnorm_history.view(torch.int32), state.hist.view(torch.int32)),
          "fused BiCGStab convdiff: stepping and solving gave different history bits")
    run64 = lambda: fused_bicgstab_solve(cd, b, tol=0.0, maxiter=64)
    t = Timer(dev).start_measure()
    run64()
    t.stop_measure()
    busy = device_ms(run64, reps=1)
    busy_s = "not measured" if busy is None else \
        f"{busy:.4f} of {t.get_duration():.4f} ms ({100 * busy / t.get_duration():.1f}%)"
    prof = kernel_profile(lambda: fused_bicgstab_solve(cd, b, tol=0.0, maxiter=32), top=12)
    per_kernel = "not measured"
    if prof is not None:
        got = {}
        for key, ms, count in prof[2]:
            for short, tag in (("K18", "bicg_dir_kernel"), ("K19", "bicg_s_kernel"),
                               ("K18 packed", "bicg_dir_packed_kernel"),
                               ("K19 packed", "bicg_s_packed_kernel"),
                               ("K20", "bicg_update_kernel")):
                if tag in key:
                    got[short] = ms / 32
        per_kernel = ", ".join(f"{k_} {v_:.5f}" for k_, v_ in sorted(got.items())) + " ms/it"
    bicgstab_solve(cd, b, tol=0.0, maxiter=8)
    with count_steps(bicgstab_mod, "bicgstab_step") as counter:
        t = Timer(dev).start_measure()
        _, pinfo = bicgstab_solve(cd, b, tol=0.0, maxiter=BICG_STEPS)
        t.stop_measure()
    check(int(pinfo.iterations) == BICG_STEPS and counter.calls == BICG_STEPS,
          f"portable BiCGStab convdiff: {int(pinfo.iterations)} its in {counter.calls} steps")
    port_ms_it = t.get_duration() / BICG_STEPS
    print(f"  fused BiCGStab convdiff nx=512 (n={n}, 128x128, kmax 5, {cd.tile_bytes() / 1e6:.1f} MB "
          f"of tiles, packed route): {k} steps all live, {ms_it:.5f} ms/it (init + {BICG_STEPS} "
          f"steps; whole solve {solve_ms:.3f} ms), effective {eff / ms_it / 1e6:.1f} GB/s on "
          f"{eff / 1e6:.1f} MB/it (2 tile streams + 17 vectors: bench.py's convention, not a "
          f"stream rate here), needed-bytes rate {needed / ms_it / 1e6:.1f} GB/s on "
          f"{needed / 1e6:.1f} MB/it (2 x 8 bytes a nonzero + 17 vectors); 64 steps: device busy "
          f"{busy_s}; kernels' device time {per_kernel}; bitwise step/solve ok; portable loop "
          f"{port_ms_it:.5f} ms/it ({port_ms_it / ms_it:.1f}x the fused)  [{card}]")
    bicg_route_comparison(dev, cd, b, card)

    # (d) the portable loop on bench.py:1141's DIA lane (n = 4,194,304)
    dia = DIAMatrix.from_csr_host(*convdiff_csr(2048), device=dev)
    bd = torch.arange(1, dia.n + 1, dtype=torch.float32, device=dev) / dia.n
    bicgstab_solve(dia, bd, tol=0.0, maxiter=4)
    before = _common.LAUNCHES["dia_spmv_rows"]
    t = Timer(dev).start_measure()
    _, dinfo = bicgstab_solve(dia, bd, tol=0.0, maxiter=BICG_DIA_STEPS)
    t.stop_measure()
    check(int(dinfo.iterations) == BICG_DIA_STEPS and _common.LAUNCHES["dia_spmv_rows"] - before
          >= 2 * BICG_DIA_STEPS, f"portable BiCGStab DIA: {int(dinfo.iterations)} its")
    print(f"  portable BiCGStab DIA convdiff nx=2048 (n={dia.n}, {len(dia.offsets)} diagonals): "
          f"{BICG_DIA_STEPS} steps, {t.get_duration() / BICG_DIA_STEPS:.5f} ms/it  [{card}]")
    del dia, bd

    # (e) fused against the portable loop, and twice against itself
    small = convdiff_bell(64, dev)
    bs = torch.arange(1, small.n + 1, dtype=torch.float32, device=dev) / small.n
    for label, op, rhs, M in (("convdiff nx=512", cd, b, None),
                              ("convdiff nx=512 jacobi", cd, b, jacobi_preconditioner(cd)),
                              ("convdiff nx=64", small, bs, None)):
        _, f25 = bicgstab_solve(op, rhs, tol=0.0, maxiter=25, M=M, fused="always")
        _, p25 = bicgstab_solve(op, rhs, tol=0.0, maxiter=25, M=M)
        _, f25b = bicgstab_solve(op, rhs, tol=0.0, maxiter=25, M=M, fused="always")
        hf, hp = f25.rnorm_history.double().cpu().numpy(), p25.rnorm_history.double().cpu().numpy()
        check(np.allclose(hf[:11], hp[:11], rtol=BICG_TRAJ_RTOL, atol=0)
              and np.allclose(hf[11:16], hp[11:16], rtol=BICG_TRAJ_MID_RTOL, atol=0)
              and np.isfinite(hf).all() and np.isfinite(hp).all(),
              f"BiCGStab {label}: fused vs portable history {hf.tolist()} vs {hp.tolist()}")
        check(torch.equal(f25.rnorm_history.view(torch.int32), f25b.rnorm_history.view(torch.int32)),
              f"BiCGStab {label}: fused history not bitwise repeatable")
        print(f"  BiCGStab {label}: fused vs portable 25-step history within {BICG_TRAJ_RTOL:g} over "
              f"10 steps, {BICG_TRAJ_MID_RTOL:g} to step 15 (largest difference there "
              f"{np.abs(hf[:16] / hp[:16] - 1).max():.2g}, to step 25 "
              f"{np.abs(hf / hp - 1).max():.2g}), finite after; bitwise repeat ok")

    # (f) a breakdown: the skew matrix [[0, 1], [-1, 0]] as blocked-ELL
    skew = BlockedEllMatrix.from_csr_host(np.array([1.0, -1.0], np.float32), np.array([1, 0]),
                                          np.array([0, 1, 2]), (2, 2), bm=32, bn=32, device=dev)
    b2 = torch.tensor([1.0, 0.0], device=dev)
    xf, fi = bicgstab_solve(skew, b2, tol=1e-12, maxiter=10, fused="always")
    xp, pi = bicgstab_solve(skew, b2, tol=1e-12, maxiter=10)
    check(bool(fi.breakdown) and bool(pi.breakdown) and not bool(fi.converged)
          and int(fi.iterations) == int(pi.iterations) == 1 and torch.equal(xf, xp)
          and bool(torch.isfinite(xf).all()),
          f"BiCGStab skew breakdown: fused {bool(fi.breakdown)} {int(fi.iterations)} {xf.tolist()}, "
          f"portable {bool(pi.breakdown)} {int(pi.iterations)} {xp.tolist()}")
    print(f"  BiCGStab skew breakdown: 1 step, breakdown flagged, the last finite iterate "
          f"{xf.tolist()} returned (as the portable loop)")

    # (g) the half-step exit: the first step whose ||s|| undercuts every
    # norm before it, with tol just above it
    st = fused_bicgstab_init(small, bs, None, 40)
    seen, j = [float(st.rnorm)], None
    for step in range(1, 41):
        fused_bicgstab_step(small, st)
        snorm = float(torch.sqrt(st.work.scal[fb.B_SS]))
        if snorm < 0.999 * min(seen) and float(st.rnorm) < snorm:
            j = step
            break
        seen += [snorm, float(st.rnorm)]
    check(j is not None, "BiCGStab half-step exit: no step to exit at")
    tol = snorm * (1 + 1e-6)
    _, hf_ = bicgstab_solve(small, bs, tol=tol, maxiter=40, fused="always")
    _, hp_ = bicgstab_solve(small, bs, tol=tol, maxiter=40)
    check(int(hf_.iterations) == j and bool(hf_.converged) and abs(float(hf_.rnorm) - snorm)
          <= 1e-5 * snorm and int(hp_.iterations) == j,
          f"BiCGStab half-step exit at {j}: fused {int(hf_.iterations)} its rnorm {float(hf_.rnorm)}, "
          f"portable {int(hp_.iterations)}, ||s|| {snorm}")
    print(f"  BiCGStab half-step exit: step {j} ends at its half step (rnorm = ||s|| = {snorm:.5g}), "
          f"fused and portable")

    # (h) caps of 1, 2 and 7 steps; b = 0; an x0 warm start (r0 through kernel 5)
    for cap in (1, 2, 7):
        xf, fi = bicgstab_solve(small, bs, tol=0.0, maxiter=cap, fused="always")
        xp, _ = bicgstab_solve(small, bs, tol=0.0, maxiter=cap)
        e, m = rel_max_err(xf, xp)
        check(int(fi.iterations) == cap and e <= 1e-4 * m,
              f"BiCGStab cap {cap}: {int(fi.iterations)} steps, x differs by {e} (max {m})")
    x, info = bicgstab_solve(small, torch.zeros_like(bs), tol=1e-30, fused="always")
    check(int(info.iterations) == 0 and bool(info.converged) and not bool(x.any()),
          f"BiCGStab b = 0: {int(info.iterations)} iterations")
    x0 = torch.as_tensor(0.01 * np.random.default_rng(5).standard_normal(small.n),
                         dtype=torch.float32, device=dev)
    before = kernel5_launches()
    tw = TOL_SOLVE_REL * float(bs.double().norm())
    x, info = bicgstab_solve(small, bs, x0, tol=tw, maxiter=400, fused="always")
    r0 = (bs.cpu() - small.to("cpu").matvec(x0.cpu())).double()
    e0 = abs(float(info.rnorm_history[0]) / float(r0.norm()) - 1)
    true_rel = float((bs - small.matvec(x)).double().norm()) / float(bs.double().norm())
    check(kernel5_launches() >= before + 2, "BiCGStab x0 warm start did not launch kernel 5")
    check(bool(info.converged) and e0 <= TOL_DOT and true_rel < 1e-3,
          f"BiCGStab x0 warm start: converged {bool(info.converged)}, ||r0|| off by {e0}, true "
          f"relative residual {true_rel}")
    print(f"  BiCGStab caps 1, 2, 7: x equals the portable loop's to 1e-4 of max|x|; b = 0: 0 its; "
          f"x0 warm start: {int(info.iterations)} its, ||r0|| rel diff {e0:.3g}, true relative "
          f"residual {true_rel:.3e}")

    # (i) the portable loop ends at convergence
    with count_steps(bicgstab_mod, "bicgstab_step") as counter:
        _, pin = bicgstab_solve(small, bs, tol=tw, maxiter=400)
    check(bool(pin.converged), "portable BiCGStab convdiff nx=64: not converged")
    check_stops_at_done("portable BiCGStab convdiff nx=64", counter.calls, int(pin.iterations))
    torch.cuda.synchronize()


# ---- phase 2, sharded: kernels 6 and 17 against their plain versions ------------

def sharded_ops(dev, n_shards):
    """The n = 262,144 block-tridiagonal operator split into ``n_shards``
    row shards on the card (split_tridiag_tiles)."""
    import torch

    blocks, cols = split_tridiag_tiles(N_BIG, n_shards, 128)
    return torch.from_numpy(blocks).to(dev), torch.from_numpy(cols).to(dev)


def random_shard(rng, nrb, bn, n_shards, shard, dev):
    """A ragged random shard: tiles with GLOBAL column blocks over
    ``n_shards * nrb`` block-rows, and its row offset."""
    import torch

    ncb = n_shards * nrb
    blocks = torch.as_tensor(rng.standard_normal((nrb, 3, bn, bn)), dtype=torch.float32,
                             device=dev)
    cols = torch.as_tensor(rng.integers(0, ncb, (nrb, 3)), dtype=torch.int32, device=dev)
    return blocks, cols, ncb, shard * nrb * bn


def check_k6(blocks, cols, full, off, errs, label):
    """Kernel 6 against its plain version: q within TOL_Q of max|q|, pap
    within TOL_DOT, two launches bit-identical."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.ops.cuda._common import form

    qk, pk = fc.bell_spmv_dot(blocks, cols, full, off)
    qk2, pk2 = fc.bell_spmv_dot(blocks, cols, full, off)
    qp, pp = fc._spmv_dot_plain(blocks, cols, full, off, None, None)
    torch.cuda.synchronize()
    e_q, m_q = rel_max_err(qk, qp)
    e_pap = abs(float(pk) - float(pp))
    check(e_q <= TOL_Q * m_q, f"K6 {label}: q err {e_q} vs max|q| {m_q}")
    check(e_pap <= TOL_DOT * abs(float(pp)), f"K6 {label}: pap {float(pk)} vs {float(pp)}")
    check(torch.equal(qk, qk2) and torch.equal(pk, pk2), f"K6 {label}: two launches differ")
    name = form("bell_spmv_dot", blocks.dtype)
    errs[name] = max(errs[name], e_q, e_pap)
    print(f"  K6 {label:<40} |dq|={e_q:.3g} (max|q| {m_q:.4g}) |dpap|={e_pap:.3g} "
          f"(pap {float(pp):.6g}); repeat ok")


def check_k17(blocks, cols, full, off, rng, errs, label, shift=0.07, first=False, jacobi=False):
    """Kernel 17 against its plain version: w and x' bit for bit (also
    written over w-2 and x), q within TOL_Q of max|q|, v.q within TOL_DOT
    and v.r1 within TOL_DOT of ||v_win|| ||r1||; two launches bit-identical.
    ``first``: su = 0 (no pending update: w = 0, x unchanged); ``jacobi``: v
    scaled as the loop scales it, (d * r2) / beta."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm
    from conjugategradient_tpu_torch.ops.cuda._common import form

    nrb, bn = blocks.shape[0], blocks.shape[3]
    dev = blocks.device
    name = form("minres_shard_spmv_dot", blocks.dtype)

    def vec(shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    if jacobi:
        full = (torch.as_tensor(0.5 + rng.random(full.shape), dtype=torch.float32, device=dev)
                * full) * 0.31
    vecs = [vec((nrb, bn)) for _ in range(5)]
    su = torch.zeros(1, 8, device=dev)
    su[0, fm.SU_SHIFT] = shift
    if not first:
        su[0, fm.SU_OLDEPS:fm.SU_PHI + 1] = torch.tensor([0.11, 0.23, 0.57, 0.83])
    k = fm.minres_shard_spmv_dot(blocks, cols, full, *vecs, su, off)
    k2 = fm.minres_shard_spmv_dot(blocks, cols, full, *vecs, su, off)
    p = fm._shard_plain(blocks, cols, full, tuple(vecs), su, off, None, None)
    w_in, x_in = vecs[3].clone(), vecs[4].clone()
    q_o, dots = torch.empty_like(w_in), torch.empty(2, device=dev)
    k3 = fm.minres_shard_spmv_dot(blocks, cols, full, *vecs[:3], w_in, x_in, su, off,
                                  out=(q_o, w_in, x_in, dots))
    torch.cuda.synchronize()
    check(torch.equal(k[1], p[1]) and torch.equal(k[2], p[2]),
          f"K17 {label}: w or x' not bit-equal to the plain version")
    check(torch.equal(k3[1], p[1]) and torch.equal(k3[2], p[2]),
          f"K17 {label}: w or x' written over w-2 and x differ")
    check(all(torch.equal(a, b) for a, b in zip(k, k2)), f"K17 {label}: two launches differ")
    if first:
        check(not bool(k[1].any()) and torch.equal(k[2], vecs[4]),
              f"K17 {label}: a first step (su = 0) changed x or w")
    e_q, m_q = rel_max_err(k[0], p[0])
    check(e_q <= TOL_Q * m_q, f"K17 {label}: q err {e_q} vs max|q| {m_q}")
    e_vq = abs(float(k[3]) - float(p[3]))
    e_vr1 = abs(float(k[4]) - float(p[4]))
    vwin = full[off // bn:off // bn + nrb]
    check(e_vq <= TOL_DOT * abs(float(p[3])), f"K17 {label}: vq {float(k[3])} vs {float(p[3])}")
    check(e_vr1 <= TOL_DOT * float(vwin.norm() * vecs[0].norm()),
          f"K17 {label}: vr1 {float(k[4])} vs {float(p[4])}")
    errs[name] = max(errs[name], e_q, e_vq, e_vr1)
    print(f"  K17 {label:<39} w, x' bit-equal (also in place); |dq|={e_q:.3g} "
          f"(max|q| {m_q:.4g}) |dvq|={e_vq:.3g} |dvr1|={e_vr1:.3g}; repeat ok")
    return vecs, su


def check_partials_only(shape, rng, dev, label):
    """Kernels 2, 3 and 16 in the sharded loop's partials-only mode against
    their full-tail launches: x', r' and r2' bit-equal, the same partial
    sums, and the solve's scalars and control words untouched."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    x, p, r, q = (torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)
                  for _ in range(4))
    d = torch.as_tensor(0.5 + rng.random(shape), dtype=torch.float32, device=dev)
    alpha = torch.full((1, 1), 0.61, device=dev)
    for name, kern in (
        ("fused_update_dot", lambda **kw: fc.fused_update_dot(x, p, r, q, alpha, **kw)),
        ("fused_update_dot_pcg", lambda **kw: fc.fused_update_dot_pcg(x, p, r, q, d, alpha, **kw)),
    ):
        full = kern(work=fc.FusedWork.new(dev, maxiter=4))
        work = fc.FusedWork.new(dev, maxiter=4)
        before = (work.scal.clone(), work.ctl.clone(), work.hist.clone())
        part = kern(work=work, partials_only=True)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(full, part)),
              f"{name} {label}: partials-only launch differs from the full-tail one")
        check(torch.equal(work.scal, before[0]) and torch.equal(work.ctl, before[1])
              and torch.equal(work.hist.isnan(), before[2].isnan()),
              f"{name} {label}: partials-only launch changed the solve's scalars")
    c1, ia = torch.full((1, 1), 0.4, device=dev), torch.full((1, 1), 0.9, device=dev)
    for dd in (None, d):
        wf, wp = fm.MinresWork.new(dev, maxiter=4), fm.MinresWork.new(dev, maxiter=4)
        for w in (wf, wp):
            w.start(torch.tensor(2.3, device=dev))
        before = (wp.scal.clone(), wp.ctl.clone())
        yf, bf = fm.minres_update_dot(q, r, p, c1, ia, dd, work=wf)
        yp, bp = fm.minres_update_dot(q, r, p, c1, ia, dd, work=wp, partials_only=True)
        torch.cuda.synchronize()
        check(torch.equal(yf, yp) and torch.equal(bf, bp),
              f"minres_update_dot {label}: partials-only launch differs from the full-tail one")
        check(torch.equal(wp.scal, before[0]) and torch.equal(wp.ctl, before[1]),
              f"minres_update_dot {label}: partials-only launch changed the solve's scalars")
    print(f"  partials-only kernels 2, 3, 16 {label:<12} x', r', r2' and partials bit-equal "
          "to the full-tail launches; scalars untouched")


def phase_sharded_kernels(dev, errs, times, extra):
    """Kernels 6 and 17 against their plain versions and timed on the
    sharded path's shards (the n = 262,144 operator in 4 and 8 shards), at
    a ragged nrb = 13, and the partials-only modes of kernels 2, 3 and 16.
    Returns the split operator."""
    import torch

    rng = np.random.default_rng(17)
    blocks4, cols4 = sharded_ops(dev, 4)
    m4 = N_BIG // 4
    full = torch.as_tensor(rng.standard_normal((N_BIG // 128, 128)), dtype=torch.float32,
                           device=dev)
    for s in (0, 3):
        check_k6(blocks4[s], cols4[s], full, s * m4, errs, f"tridiag n=262144 P=4 shard {s}")
    for bn in (32, 64):
        b13, c13, ncb, off = random_shard(rng, 13, bn, 3, 2, dev)
        full13 = torch.as_tensor(rng.standard_normal((ncb, bn)), dtype=torch.float32, device=dev)
        check_k6(b13, c13, full13, off, errs, f"ragged nrb=13 bn={bn} offset {off}")
    for s in (0, 3):
        check_k17(blocks4[s], cols4[s], full, s * m4, rng, errs, f"tridiag n=262144 P=4 shard {s}")
    check_k17(blocks4[1], cols4[1], full, m4, rng, errs, "tridiag P=4 shard 1 first step",
              first=True)
    check_k17(blocks4[2], cols4[2], full, 2 * m4, rng, errs, "tridiag P=4 shard 2 jacobi v",
              shift=0.0, jacobi=True)
    for bn in (32, 64):
        b13, c13, ncb, off = random_shard(rng, 13, bn, 3, 1, dev)
        full13 = torch.as_tensor(rng.standard_normal((ncb, bn)), dtype=torch.float32, device=dev)
        for first, jacobi in ((False, False), (True, False), (False, True)):
            tag = " first step" if first else (" jacobi v" if jacobi else "")
            check_k17(b13, c13, full13, off, rng, errs, f"ragged nrb=13 bn={bn}{tag}",
                      first=first, jacobi=jacobi)
    check_partials_only((N_BIG // 128, 128), rng, dev, "(2048, 128)")
    check_partials_only((13, 32), rng, dev, "(13, 32)")
    # kernels 2, 3 and 16 at the lengths of one shard (n / P): against their
    # plain versions, partials-only against full-tail, and not live
    rng_u = np.random.default_rng(41)
    for n_shards in UPDATE_SHARDS:
        shape, label = (N_BIG // 128 // n_shards, 128), f"n/{n_shards}"
        for pcg in (False, True):
            check_update(shape, rng_u, pcg, errs, label, dev)
        for with_d in (False, True):
            check_minres_update(shape, rng_u, with_d, errs, label + ("+d" if with_d else ""), dev)
        check_partials_only(shape, rng_u, dev, label)
    for n in (N_BIG, N_BIG // 8):
        check_update_not_live(n, dev, f"n={n}")
    extra.update(update_rows(dev, sharded_only=True))

    # timing at the path's shapes, launched as the loop launches them
    sharded_table_rows((blocks4, cols4), torch.float32, times, extra, ("K6", "K17"))
    torch.cuda.synchronize()
    print(f"  kernels 6 / 17 at P = 4: bound {times['bell_spmv_dot']['bound_ms']:.5f} / "
          f"{times['minres_shard_spmv_dot']['bound_ms']:.5f} ms per launch "
          f"(x{4}: {4 * times['bell_spmv_dot']['bound_ms']:.5f} / "
          f"{4 * times['minres_shard_spmv_dot']['bound_ms']:.5f} per iteration)")
    return blocks4, cols4


# ---- phase 3, sharded: the row-sharded solve ------------------------------------------

def kernel_rows(fn, steps, top=6):
    """The device ms and CUDA kernel launches per step over one call of
    ``fn`` (a solve of ``steps`` steps), and the ``top`` kernels' device ms
    per step, or 'not measured'."""
    prof = kernel_profile(fn, top=top)
    if prof is None:
        return "not measured"
    total, launched, rows = prof
    short = []
    for name, ms, _ in rows:
        name = name.replace("void ", "").replace("(anonymous namespace)::", "")
        short.append((name.split("<")[0].split("(")[0].split("::")[-1][:24], ms / steps))
    return (f"device {total / steps:.5f} ms/it in {launched / steps:.1f} launches/it; top: "
            + ", ".join(f"{n} {ms:.5f}" for n, ms in short))


def phase_sharded_path(dev, big_full, shard_ops, card):
    """The row-sharded path through ``sharded_cg_solve`` (module doc, phase 3)."""
    import torch

    from conjugategradient_tpu_torch import (CSRMatrix, cg_solve, fused_bell_cg_solve,
                                             fused_bell_pcg_solve, load_matrix, minres_solve)
    from conjugategradient_tpu_torch.io import read_csr_host
    from conjugategradient_tpu_torch.parallel import loops, make_row_mesh, partition_csr_rows
    from conjugategradient_tpu_torch.parallel import sharded_cg_solve
    from conjugategradient_tpu_torch.problems import poisson2d_coo
    from conjugategradient_tpu_torch.utils import Timer

    blocks4, cols4 = shard_ops
    n = N_BIG
    b = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
    bm = b / n  # bench.py's minres right-hand side
    eff = big_full.tile_bytes() + 10 * n * 4  # the single-card fused CG's 413.1 MB/it
    ops = {4: (blocks4, cols4), 8: (blocks4.view(8, -1, 3, 128, 128), cols4.view(8, -1, 3))}
    inv_diag = 1.0 / big_full.diagonal()

    lo8 = ops[8][0].to(torch.bfloat16)  # the P = 8 shards in bf16

    def solve(n_shards, rhs, steps, bf16=False, **kw):
        bl, cl = ops[n_shards]
        return sharded_cg_solve(lo8 if bf16 else bl, cl, rhs, mesh=make_row_mesh(n_shards, dev),
                                tol=-1.0, maxiter=steps, **kw)

    def timed(label, n_shards, rhs, steps, **kw):
        """ms per live step; every step must be live, except for MINRES,
        whose Lanczos beta may reach 0 (done): then the live steps are
        counted and the time is over those."""
        solve(n_shards, rhs, 16, **kw)
        t = Timer(dev).start_measure()
        x, info = solve(n_shards, rhs, steps, **kw)
        t.stop_measure()
        k = int(info.iterations)
        check(k == steps or (kw.get("method") == "minres" and k > 0),
              f"sharded {label} P={n_shards}: {k} of {steps} steps live")
        ms_it = t.get_duration() / k
        run64 = lambda: solve(n_shards, rhs, 64, **kw)
        t = Timer(dev).start_measure()
        run64()
        t.stop_measure()
        busy = device_ms(run64, reps=1)
        busy_s = "not measured" if busy is None else \
            f"{busy:.4f} of {t.get_duration():.4f} ms ({100 * busy / t.get_duration():.1f}%)"
        print(f"  sharded {label} n={n} P={n_shards}: k = {k} of {steps}, {ms_it:.5f} ms/it, effective "
              f"{eff / ms_it / 1e6:.1f} GB/s on {eff / 1e6:.1f} MB/it; 64 steps: device busy "
              f"{busy_s}; {kernel_rows(run64, 64)}  [{card}]")
        return x, info, ms_it

    # (a) the fused sharded CG at P = 4 and 8, the single-card fused CG beside
    fused_bell_cg_solve(big_full, b, tol=-1.0, maxiter=32)
    t = Timer(dev).start_measure()
    _, info1 = fused_bell_cg_solve(big_full, b, tol=-1.0, maxiter=256)
    t.stop_measure()
    one_ms = t.get_duration() / 256
    print(f"  single-card fused CG n={n} full storage: {one_ms:.5f} ms/it, effective "
          f"{eff / one_ms / 1e6:.1f} GB/s  [{card}]")
    for n_shards in (4, 8):
        timed("fused CG", n_shards, b, 256)
    # (b) fused Jacobi PCG at P = 4, fused MINRES at P = 4 and 8, the fused
    # CG and MINRES at P = 8 on bf16 shards (kernels 6 and 17's bf16 forms),
    # the portable CG beside
    timed("fused Jacobi PCG", 4, b, 256, inv_diag=inv_diag)
    for n_shards in (4, 8):
        timed("fused MINRES", n_shards, bm, 256, method="minres")
    timed("fused CG, bf16 shards,", 8, b, 256, bf16=True)
    timed("fused MINRES, bf16 shards,", 8, bm, 256, bf16=True, method="minres")
    solve(4, b, 8, use_fused="never")
    t = Timer(dev).start_measure()
    _, ip = solve(4, b, 64, use_fused="never")
    t.stop_measure()
    check(int(ip.iterations) == 64, f"portable sharded CG: {int(ip.iterations)} steps")
    print(f"  portable sharded CG n={n} P=4: {t.get_duration() / 64:.5f} ms/it  [{card}]")

    # (c) against the single-card fused CG and Jacobi PCG at P = 4 and 8: the
    # 25-step trajectory on the cut operator (cut_tridiag_ops), at least
    # PARITY_MIN_USED entries above the float32 floor; then twice, bitwise
    cut_full, cut_ops, cut_inv = cut_tridiag_ops(blocks4, cols4, big_full.nnz)
    rhs = torch.as_tensor(np.random.default_rng(9).standard_normal(n), dtype=torch.float32,
                          device=dev)
    used_all = []
    for n_shards in (4, 8):
        for jac in (None, cut_inv):
            what = f"sharded fused {'Jacobi PCG' if jac is not None else 'CG'} P={n_shards}"
            _, i25 = sharded_cg_solve(*cut_ops[n_shards], rhs, mesh=make_row_mesh(n_shards, dev),
                                      tol=-1.0, maxiter=25, inv_diag=jac)
            if jac is None:
                _, o25 = fused_bell_cg_solve(cut_full, rhs, tol=-1.0, maxiter=25)
            else:
                _, o25 = fused_bell_pcg_solve(cut_full, rhs, jac, tol=-1.0, maxiter=25)
            ok, used = trajectory_ok(i25.rho_history, o25.rho_history, 25)
            check(ok and used >= PARITY_MIN_USED,
                  f"{what} vs the single card: rho_history beyond rtol {TRAJ_RTOL} or only "
                  f"{used} entries above the float32 floor")
            hs, ho = (h[1:26].double().cpu().numpy() for h in (i25.rho_history,
                                                              o25.rho_history))
            keep = ho > 1e-10 * float(o25.rho_history[0])
            used_all.append(f"{used} ({np.abs(hs[keep] / ho[keep] - 1).max():.2g})")
    for n_shards in (4, 8):
        x1, r1 = solve(n_shards, b, 256)
        x2, r2 = solve(n_shards, b, 256)
        check(torch.equal(x1, x2) and torch.equal(r1.rho_history.view(torch.int32),
                                                  r2.rho_history.view(torch.int32)),
              f"sharded fused CG P={n_shards}: two runs differ")
    print(f"  sharded vs single-card fused CG and Jacobi PCG, P=4 and 8, cut operator: 25-step "
          f"rho_history agrees on {', '.join(used_all)} entries above the float32 floor (largest "
          f"relative difference); P=4 and P=8 "
          f"repeat bit for bit")

    # (d) float64 portable sharded CG on poisson3d_48 at P = 4 against cg_solve
    path = os.path.join(ROOT, MATRICES[0])
    data, indices, indptr, shape = read_csr_host(path)
    blocks, bcols, n_pad = partition_csr_rows(data, indices, indptr, shape, 4, bm=8, bn=8)
    np3 = shape[0]
    b64 = torch.zeros(n_pad, dtype=torch.float64, device=dev)
    b64[:np3] = torch.arange(1, np3 + 1, dtype=torch.float64, device=dev)
    tol64 = 1e-8 * bnorm(np3)
    with count_steps(loops, "_pcg_body_fn") as counter:
        xs, is_ = sharded_cg_solve(blocks, bcols, b64, mesh=make_row_mesh(4, dev), tol=tol64)
    csr = load_matrix(path, layout="csr", dtype=np.float64, device=dev)
    x1, i1 = cg_solve(csr, b64[:np3], tol=tol64)
    e, m = rel_max_err(xs[:np3], x1)
    check(bool(is_.converged) and int(is_.iterations) == int(i1.iterations) and e <= 1e-11 * m,
          f"float64 sharded CG poisson3d_48: {int(is_.iterations)} vs {int(i1.iterations)} its, "
          f"x differs by {e} (max {m})")
    print(f"  float64 portable sharded CG poisson3d_48 P=4 (8 x 8 tiles): {int(is_.iterations)} "
          f"its as cg_solve, x to {e / m:.3g} of max|x|")
    check_stops_at_done("portable sharded CG poisson3d_48", counter.calls, int(is_.iterations))

    # (e) sharded MINRES on indefinite operators against the single-card
    # minres_solve, fused (128 x 128 tiles) and portable (32 x 32: a float32
    # SpMV on the card is kernel 5, which takes bn in CUDA_BN): poisson2d(24)
    # - 3I (__graft_entry__.py:481; singular, so only its first three phibars,
    # as there) and poisson2d(20) - 3I (tests/test_sharded_minres.py:38) to
    # MINRES_INDEF_TOL_REL ||b||
    import scipy.sparse as sp

    for nx, steps in ((24, 3), (20, None)):
        rows, cols, vals, shp = poisson2d_coo(nx)
        vals = np.asarray(vals, np.float64).copy()
        vals[np.asarray(rows) == np.asarray(cols)] -= 3.0
        a = sp.csr_matrix((vals.astype(np.float32), (rows, cols)), shape=shp)
        a.sort_indices()
        na = shp[0]
        one = CSRMatrix.from_arrays(a.data, a.indices, a.indptr, shp, device=dev)
        bb = torch.ones(na, dtype=torch.float32, device=dev)
        tt = 0.0 if steps else MINRES_INDEF_TOL_REL * float(bb.norm())
        _, i_one = minres_solve(one, bb, tol=tt, maxiter=steps or 4 * na)
        for tile, fused in ((128, "always"), (32, "never")):
            bl, bc, npd = partition_csr_rows(a.data, a.indices, a.indptr, shp, 4, bm=tile, bn=tile)
            bp = torch.zeros(npd, dtype=torch.float32, device=dev)
            bp[:na] = 1.0
            x, info = sharded_cg_solve(bl, bc, bp, mesh=make_row_mesh(4, dev), tol=tt,
                                       maxiter=steps or 4 * na, method="minres", use_fused=fused)
            k, k1 = int(info.iterations), int(i_one.iterations)
            h = np.sqrt(info.rho_history.double().cpu().numpy()[:4])
            h1 = i_one.rnorm_history.double().cpu().numpy()[:4]
            true_r = float((bb - one.matvec(x[:na])).double().norm())
            what = (f"indefinite sharded MINRES poisson2d({nx}) - 3I P=4 {tile}x{tile} "
                    f"use_fused={fused}")
            check(np.allclose(h, h1, rtol=1e-3), f"{what}: phibar {h} vs {h1}")
            if steps:
                check(k == steps, f"{what}: {k} of {steps} steps")
                print(f"  {what}: {k} steps, the first phibars to 1e-3 of the single card's")
                continue
            check(bool(info.converged) and abs(k - k1) <= ITER_SLACK
                  and true_r <= MINRES_TRUE_FACTOR * tt,
                  f"{what}: {k} its against {k1}, ||b - Ax|| {true_r}")
            print(f"  {what}: {k} its (single card {k1}), ||b - Ax|| = {true_r:.3e} "
                  f"({tt:.3e} asked)")

    # (f) caps of 1, 2 and 7 against the portable loop (cut operator, P = 4
    # and 8, with and without Jacobi); b = 0; an x0 warm start (fused, P = 4)
    for n_shards in (4, 8):
        for jac in (None, cut_inv):
            for method in ("standard", "minres"):
                for cap in (1, 2, 7):
                    kw = dict(mesh=make_row_mesh(n_shards, dev), tol=-1.0, maxiter=cap,
                              method=method, inv_diag=jac)
                    xf, fi = sharded_cg_solve(*cut_ops[n_shards], rhs, **kw)
                    xp, _ = sharded_cg_solve(*cut_ops[n_shards], rhs, use_fused="never", **kw)
                    e, m = rel_max_err(xf, xp)
                    check(int(fi.iterations) == cap and e <= 1e-4 * m,
                          f"sharded {method} P={n_shards} jacobi={jac is not None} cap {cap}: "
                          f"{int(fi.iterations)} steps, x differs by {e}")
    del cut_full, cut_ops
    for method in ("standard", "minres"):
        x, info = sharded_cg_solve(*ops[4], torch.zeros_like(b), mesh=make_row_mesh(4, dev),
                                   tol=1e-30, method=method)
        check(not bool(x.any()) and bool(info.converged) and int(info.iterations) <= 1,
              f"sharded {method} b = 0: {int(info.iterations)} its")
    x0 = torch.as_tensor(np.random.default_rng(5).standard_normal(n), dtype=torch.float32,
                         device=dev)
    x, info = sharded_cg_solve(*ops[4], b, x0, mesh=make_row_mesh(4, dev),
                               tol=TOL_SOLVE_REL * bnorm(n))
    r0 = b - big_full.matvec(x0)
    e0 = abs(float(info.rho_history[0]) / float(r0.double() @ r0.double()) - 1)
    true_rel = float((b - big_full.matvec(x)).double().norm()) / bnorm(n)
    check(bool(info.converged) and e0 <= TOL_DOT and true_rel < 1e-4,
          f"sharded x0 warm start: converged {bool(info.converged)}, ||r0||^2 off by {e0}, "
          f"true relative residual {true_rel}")
    print(f"  sharded CG and MINRES capped at 1, 2, 7 steps, P=4 and 8, with and without "
          f"Jacobi: x equals the portable loop's to 1e-4 of max|x|; b = 0 ends at once; x0 warm start {int(info.iterations)} its, "
          f"||r0||^2 rel diff {e0:.3g}, true relative residual {true_rel:.3e}")
    torch.cuda.synchronize()


# ---- kernels 2, 3 and 16: per-call hashes, not-live launches, timing rows ----------

# GMRES, the block-Jacobi and Chebyshev preconditioners, the CG object API,
# checkpointed solves and the tester's new flags
GMRES_NX = 1024  # bench.py:1224's lane: the convection-diffusion DIA operator, n = 1,048,576
GMRES_RESTART = 32
GMRES_STEPS = 128
GMRES_BELL_NX = 512  # convdiff-512 as 128 x 128 blocked-ELL (the packed route)
GMRES_RNORM_RTOL = 1e-5  # info.rnorm against ||b - Ax|| recomputed in float64
GMRES_TWIN_RTOL = 1e-3  # the final true residual, card against the CPU's
GIVENS_SLACK = 1e-6  # a Givens estimate may exceed the one before by this (rounding)
F32_EPS = 2.0 ** -23
CHEB_DEGREE = 8
BJ_BLOCK = 8
CKPT_CHUNKS = 4  # run_cg chunks of 64 steps, through a file between each
GMRES_KERNELS = ("dia_spmv_rows", "bell_spmv_packed", "stencil7_staged")


def gmres_bytes_per_step(dia, n: int, m: int) -> int:
    """bench.py:1272's byte model of one inner step: the operator, the
    matvec's in and out, CGS2 over the live rows (the cycle average of
    4 (m+3)/2 rows), the basis write and the rotations' vectors."""
    return dia.diags.numel() * 4 + 2 * n * 4 + 4 * ((m + 3) // 2) * n * 4 + 5 * n * 4


def rotation_chain_ms(m: int, dev) -> float:
    """CUDA-event ms per inner step of the Givens chain alone, averaged over
    a cycle of m steps (step j applies its j previous rotations, each one
    2 x 2 product and its copy, as solver/gmres.py does)."""
    import torch

    col = torch.randn(m + 1, device=dev)
    G = torch.eye(2, device=dev).repeat(m, 1, 1)

    def cycle():
        for j in range(m):
            for i in range(j):
                col[i: i + 2] = G[i] @ col[i: i + 2]

    return cuda_ms(cycle, reps=3, warm=1) / m


def givens_monotone(hist, k: int, m: int) -> bool:
    """Within each cycle the Givens estimates do not rise: hist[c m] (the
    true norm the cycle starts from) down to hist[c m + m - 1]."""
    h = hist[: k + 1].double().cpu().numpy()
    for c in range(0, k, m):
        seg = h[c: min(c + m, k + 1)]
        if np.any(np.diff(seg) > GIVENS_SLACK * seg[:-1]):
            return False
    return True


def log_records(logger_name):
    """A handler that keeps the records of one logger, and its remover."""
    import logging

    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger(logger_name)
    h = Keep(level=logging.DEBUG)
    logger.addHandler(h)
    return records, lambda: logger.removeHandler(h)


def phase_gmres_path(dev, big, big_full, card):
    """GMRES(32) on the DIA lane and on convdiff-512's packed tiles,
    Chebyshev PCG on stencil:256, block-Jacobi PCG through the tester,
    the CG object API, chunked checkpointed solves and the tester's
    --estimate-steps and --progress."""
    import torch

    from conjugategradient_tpu_torch import (CG, DIAMatrix, StencilOperator, cg_solve,
                                             fused_bell_cg_solve, gmres_solve, load_matrix,
                                             memory_footprint, read_mtx_csr, utils)
    from conjugategradient_tpu_torch.ops.cuda import _common
    from conjugategradient_tpu_torch.ops.spmv import bell_packed_route
    from conjugategradient_tpu_torch.solver import (cg_init, chebyshev_preconditioner,
                                                    estimate_spectral_bounds, fused_cg_init,
                                                    load_state, run_cg, save_state)
    from conjugategradient_tpu_torch.utils import Timer

    # (a) GMRES(32) on bench.py's DIA lane: 128 inner steps at tol = 0
    v, c, p, shape = convdiff_csr(GMRES_NX)
    dia = DIAMatrix.from_csr_host(v, c, p, shape, device=dev)
    n, m = shape[0], GMRES_RESTART
    check(len(dia.offsets) == 5, f"convdiff DIA: {len(dia.offsets)} diagonals")
    b = torch.arange(1, n + 1, dtype=torch.float32, device=dev) / n
    gmres_solve(dia, b, tol=0.0, maxiter=m, restart=m)  # warm-up
    before = _common.LAUNCHES["dia_spmv_rows"]
    t = Timer(dev).start_measure()
    x, info = gmres_solve(dia, b, tol=0.0, maxiter=GMRES_STEPS, restart=m)
    t.stop_measure()
    launched = _common.LAUNCHES["dia_spmv_rows"] - before
    k, cycles = int(info.iterations), int(info.cycles)
    check(k == GMRES_STEPS and cycles == GMRES_STEPS // m,
          f"GMRES DIA: {k} iterations, {cycles} cycles")
    check(givens_monotone(info.rnorm_history, k, m), "GMRES DIA: a Givens estimate rose in a cycle")
    r_card = float((b - dia.matvec(x)).double().norm())  # the kernel, float32
    check(abs(float(info.rnorm) - r_card) <= GMRES_RNORM_RTOL * r_card,
          f"GMRES DIA: rnorm {float(info.rnorm)} against recomputed {r_card}")
    # float64 (plain torch): within float32's rounding of b - Ax, a few
    # eps32 (||b|| + || |A| |x| ||)
    d64 = DIAMatrix(dia.diags.double(), dia.offsets, dia.shape, dia.nnz)
    r64 = float((b.double() - d64.matvec(x.double())).norm())
    ax_abs = DIAMatrix(d64.diags.abs(), dia.offsets, dia.shape, dia.nnz).matvec(x.double().abs())
    slack = 4 * F32_EPS * (float(b.double().norm()) + float(ax_abs.norm()))
    check(abs(float(info.rnorm) - r64) <= GMRES_RNORM_RTOL * r64 + slack,
          f"GMRES DIA: rnorm {float(info.rnorm)} against float64 {r64} (slack {slack})")
    check(launched >= GMRES_STEPS + GMRES_STEPS // m,
          f"GMRES DIA: dia_spmv_rows launched {launched} times")
    ms_step = t.get_duration() / k
    copy_gbps = utils.hbm_bandwidth_gbps(1 << 30, 10, device=dev)
    model = gmres_bytes_per_step(dia, n, m)
    eff = model / ms_step / 1e6
    chain = rotation_chain_ms(m, dev)
    busy = device_ms(lambda: gmres_solve(dia, b, tol=0.0, maxiter=GMRES_STEPS, restart=m),
                     reps=1)
    busy_s = "not measured" if busy is None else \
        f"{busy / k:.4f} ms/step ({100 * busy / t.get_duration():.1f}%)"
    mem = utils.memory_stats(dev)
    check(mem.get("peak_bytes_in_use", 0) > 0, f"memory_stats on the card: {mem}")
    print(f"  GMRES({m}) convdiff DIA n={n} (5 diagonals), {k} steps, {cycles} cycles: "
          f"{ms_step:.5f} ms/step ({launched} dia_spmv_rows launches); byte model "
          f"{model / 1e6:.1f} MB/step -> {eff:.1f} GB/s, {eff / copy_gbps:.4f} of the "
          f"{copy_gbps:.1f} GB/s copy rate (utils.hbm_bandwidth_gbps); device busy {busy_s}; "
          f"Givens chain alone {chain:.5f} ms/step ({100 * chain / ms_step:.1f}% of the step); "
          f"rnorm {float(info.rnorm):.6e}, recomputed {r_card:.6e} (float64 {r64:.6e}); "
          f"peak memory {mem['peak_bytes_in_use'] / 2**30:.2f} GiB  [{card}]")
    del dia, d64, ax_abs, x, b

    # (b) GMRES(32) on convdiff-512's sparse tiles (packed kernel 5), against
    # the same float32 solve on the CPU
    cd = convdiff_bell(GMRES_BELL_NX, dev)
    check(bell_packed_route(cd), "convdiff-512 blocked-ELL is not on the packed route")
    bc = torch.as_tensor(np.random.default_rng(0).standard_normal(cd.n), dtype=torch.float32)
    gmres_solve(cd, bc.to(dev), tol=0.0, maxiter=m, restart=m)
    before = _common.LAUNCHES["bell_spmv_packed"]
    t = Timer(dev).start_measure()
    xg, ig = gmres_solve(cd, bc.to(dev), tol=0.0, maxiter=GMRES_STEPS, restart=m)
    t.stop_measure()
    launched = _common.LAUNCHES["bell_spmv_packed"] - before
    cd_cpu = convdiff_bell(GMRES_BELL_NX, "cpu")
    xc, ic = gmres_solve(cd_cpu, bc, tol=0.0, maxiter=GMRES_STEPS, restart=m)
    ok, used = trajectory_ok(ig.rnorm_history, ic.rnorm_history, GMRES_STEPS)
    check(int(ig.iterations) == GMRES_STEPS and ok,
          f"GMRES convdiff-512 packed: {int(ig.iterations)} its; history against the CPU's "
          f"beyond rtol {TRAJ_RTOL}")
    rel = abs(float(ig.rnorm) - float(ic.rnorm)) / float(ic.rnorm)
    check(rel <= GMRES_TWIN_RTOL, f"GMRES convdiff-512: final true residual {float(ig.rnorm)} "
          f"against the CPU's {float(ic.rnorm)}")
    check(launched >= GMRES_STEPS, f"GMRES convdiff-512: bell_spmv_packed launched {launched}")
    print(f"  GMRES({m}) convdiff-512 128x128 blocked-ELL (packed route), {GMRES_STEPS} steps: "
          f"{t.get_duration() / GMRES_STEPS:.5f} ms/step ({launched} bell_spmv_packed launches); "
          f"history within rtol {TRAJ_RTOL} of the CPU's float32 solve on {used} entries, final "
          f"true residual "
          f"{float(ig.rnorm):.6e} vs CPU {float(ic.rnorm):.6e} (rel {rel:.2e})  [{card}]")
    del cd, cd_cpu, xg, xc

    # (c) Chebyshev PCG (degree 8, the Lanczos interval) on stencil:256 against
    # plain CG (the fused stencil loop), to 1e-5 ||b||
    op = StencilOperator.poisson(STENCIL_GRID, device=dev)
    n = op.shape[0]
    b = stencil_rhs(n, dev, scale=n)
    bn_ = float(b.double().norm())
    tol = TOL_SOLVE_REL * bn_
    t = Timer(dev).start_measure()
    lo, hi = estimate_spectral_bounds(op)
    t.stop_measure()
    est_ms = t.get_duration()
    rows = {}
    for label, M in (("plain CG (fused)", None),
                     (f"Chebyshev PCG degree {CHEB_DEGREE}",
                      chebyshev_preconditioner(op, lo, hi, degree=CHEB_DEGREE))):
        cg_solve(op, b, tol=tol, M=M, maxiter=8)
        t = Timer(dev).start_measure()
        x, info = cg_solve(op, b, tol=tol, M=M)
        t.stop_measure()
        true_rel = float((b - op.matvec(x)).double().norm()) / bn_
        check(bool(info.converged) and true_rel < F32_TRUE_REL_FLOOR,
              f"{label} 256^3: converged {bool(info.converged)}, true rel residual {true_rel}")
        rows[label] = int(info.iterations)
        print(f"  {label} 256^3 to 1e-5 ||b||: {t.get_duration():.2f} ms, "
              f"{int(info.iterations)} its ({t.get_duration() / int(info.iterations):.4f} ms/it), "
              f"true rel residual {true_rel:.3e}  [{card}]")
    its = list(rows.values())
    check(its[1] < its[0], f"Chebyshev PCG took {its[1]} iterations, plain CG {its[0]}")
    print(f"  estimate_spectral_bounds 256^3: [{lo:.6g}, {hi:.6g}] in {est_ms:.2f} ms  [{card}]")
    del op, b, x

    # (d) block-Jacobi PCG (b = 8) through the tester: poisson3d_48 as DIA
    # (kernel 7 for A and for the apply)
    path = MATRICES[0]
    n3 = 110_592
    before = _common.LAUNCHES["dia_spmv_rows"]
    dim, nnz, ms, rel, summ, _ = run_tester(path, "auto", "blockjacobi", TOL_SOLVE_REL * bnorm(n3),
                                            extra=("--block-size", str(BJ_BLOCK)))
    launched = _common.LAUNCHES["dia_spmv_rows"] - before
    its = summ["iterations"][0]
    check(summ["converged"] == [True] and rel < REL_ERROR_BOUND,
          f"tester {path} auto blockjacobi: {summ}, rel_error {rel}")
    check(launched >= 2 * 2 * its, f"block-Jacobi tester: dia_spmv_rows launched {launched} "
          f"times for 2 solves of {its} iterations")
    print(f"  tester {path} --layout auto --precond blockjacobi --block-size {BJ_BLOCK}: "
          f"{dim} {nnz} {ms:.3f} ms, {its} its, rel_error {rel:.3e} ({launched} dia_spmv_rows "
          f"launches over the warm-up and the timed solve)  [{card}]")

    # (e) the reference's object API on poisson3d_48's host CSR arrays
    data, indices, indptr, _ = read_mtx_csr(os.path.join(ROOT, path), dtype=np.float32)
    cg = CG.createCG(torch.float32, device=dev)
    cg.setMatrix(data, indices, indptr)
    cg.setTarget(np.arange(1, n3 + 1, dtype=np.float32))
    t = Timer(dev).start_measure()
    cg.solve(TOL_SOLVE_REL * bnorm(n3))
    t.stop_measure()
    acc = cg.accuracy()
    fp = cg.memoryFootprint()
    check(cg.converged and acc < REL_ERROR_BOUND and cg.getDimension() == n3
          and fp == memory_footprint(n3, len(data), torch.float32)
          and fp == (2 * len(data) + 4 * n3) * 4 + 2 * n3 * 4,
          f"CG API: converged {cg.converged}, accuracy {acc}, footprint {fp}")
    print(f"  CG.createCG(float32) poisson3d_48 CSR: {cg.iterations} its in "
          f"{t.get_duration():.2f} ms, accuracy {acc:.3e}, memoryFootprint {fp} B  [{card}]")

    # (f) run_cg in 4 chunks of 64 with save_state / load_state between: the
    # history hash of one uninterrupted solve (the --fused-cg-only hashes)
    ckpt = os.path.join(ROOT, "build", "chip_smoke_checkpoint.npz")
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    bb = torch.arange(1, N_BIG + 1, dtype=torch.float32, device=dev)
    steps = 64 * CKPT_CHUNKS
    for label, a in (("n=262144 symmetric", big), ("n=262144 full", big_full)):
        _, whole = fused_bell_cg_solve(a, bb, tol=-1.0, maxiter=steps)
        state = fused_cg_init(a, bb, maxiter=steps, tol=-1.0)
        for _ in range(CKPT_CHUNKS):
            state = run_cg(a, state, -1.0, steps=64)
            save_state(ckpt, state)
            state = load_state(ckpt, device=dev)
        h_whole, h_chunks = digest(whole.rho_history), digest(state.hist)
        check(h_whole == h_chunks, f"fused CG {label}: chunked history {h_chunks} against one "
              f"solve's {h_whole}")
        print(f"  fused CG {label}: {CKPT_CHUNKS} run_cg chunks of 64 through a checkpoint file, "
              f"rho_history sha256 {h_chunks} (one solve: {h_whole})  [{card}]")
    p3dia = load_matrix(os.path.join(ROOT, path), layout="auto", dtype=np.float32, device=dev)
    bp = torch.arange(1, n3 + 1, dtype=torch.float32, device=dev)
    tol3 = TOL_SOLVE_REL * bnorm(n3)
    _, whole = cg_solve(p3dia, bp, tol=tol3)
    state = cg_init(p3dia, bp, maxiter=n3 + 1)
    chunks = 0
    while not bool(state.done) and int(state.k) < n3 + 1:
        state = run_cg(p3dia, state, tol3, steps=64)
        save_state(ckpt, state)
        state = load_state(ckpt, device=dev)
        chunks += 1
    h_whole, h_chunks = digest(whole.rho_history), digest(state.hist)
    check(h_whole == h_chunks and int(state.k) == int(whole.iterations),
          f"portable DIA CG poisson3d_48: chunked {h_chunks} against {h_whole}")
    print(f"  portable DIA CG poisson3d_48 (tol 1e-5 ||b||): {chunks} run_cg chunks of 64, "
          f"{int(state.k)} its, rho_history sha256 {h_chunks} (one solve: {h_whole})  [{card}]")
    os.remove(ckpt)

    # (g) the tester's --estimate-steps and --progress 64 on the card
    from conjugategradient_tpu_torch import tester

    records, remove = log_records("conjugategradient_tpu")
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = tester.main([os.path.join(ROOT, path), "--layout", "auto", "--dtype", "float32",
                              "--tol", repr(tol3), "--summary", "--estimate-steps",
                              "--progress", "64", "--device", str(DEVICE)])
    finally:
        remove()
    lines = buf.getvalue().strip().splitlines()
    trace = [r for r in records if r.startswith("iter ")]
    check(rc == 0 and len(lines) == 3 and lines[0].startswith("expected_steps ")
          and len(trace) >= 2, f"tester --estimate-steps --progress 64: rc {rc}, {lines}, "
          f"{len(trace)} progress lines")
    k_last = int(trace[-1].split()[1])
    rel = float(lines[1].split()[3])
    check(k_last == json.loads(lines[2])["iterations"][0] and rel < REL_ERROR_BOUND,
          f"--progress: last line {trace[-1]!r} against {lines[2]}, rel_error {rel}")
    print(f"  tester {path} --layout auto --estimate-steps --progress 64: {lines[0]}; "
          f"{len(trace)} progress lines, the last {trace[-1]!r}; {lines[1]}  [{card}]")


# ---- the multi-RHS path ---------------------------------------------------

MULTI_KERNELS = ("stencil7_staged", "dia_spmv_rows")
MULTI_N = 131_072  # bench.py:516-546's bench_batched operator (201 MB of tiles)
MULTI_R = (1, 8, 32)
MULTI_LANES = 8
TOL_MULTI = 1e-5  # a multi-RHS column against the single-RHS kernel: of max|Y|
MULTI_F64_TOL_REL = 1e-8  # float64 lockstep solves: 1e-8 ||b||, off the roundoff floor
MULTI_HIST_RTOL = 1e-10  # float64 lanes against their solo solves, above 1e-14 rho_0
MULTI_F32_STEPS = 64
MULTI_TRAJ_STEPS = 25  # float32 lanes against their solo solves (TRAJ_RTOL)
NONSYM_NX = 512  # bench.py:1113-1138's convection-diffusion grid, n = 262,144
NONSYM_LANES = 4
NONSYM_STEPS = 64
NONSYM_TRAJ_STEPS = 10  # lane 0 against the solo solve: the first steps, 5e-3
NONSYM_TRAJ_RTOL = 5e-3
MULTI_STENCIL = "stencil:128"


def multi_columns_ok(Y, single, X, label) -> float:
    """Each column of a multi-RHS product against the single-RHS route on
    that column, within TOL_MULTI of max|Y|; returns the largest error."""
    scale = float(Y.abs().max())
    err = 0.0
    for j in range(X.shape[1]):
        err = max(err, float((Y[:, j] - single(X[:, j].contiguous())).abs().max()))
    check(err <= TOL_MULTI * scale, f"{label}: a column {err} from the single-RHS kernel "
          f"(max|Y| {scale})")
    return err


def multi_tester(args):
    """The port's tester in this process on --nrhs arguments; returns
    (line fields, the per-lane JSON, the summary JSON)."""
    from conjugategradient_tpu_torch import tester

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tester.main([*args, "--summary", "--device", str(DEVICE)])
    lines = buf.getvalue().strip().splitlines()
    check(rc == 0 and len(lines) == 3, f"tester {' '.join(args)}: rc {rc}, {lines}")
    return lines[0].split(), json.loads(lines[1]), json.loads(lines[2])


def lanes_hist_ok(h_lane, h_solo, k) -> bool:
    """A float64 lane's history against its solo solve's: 1e-10 relative
    above 1e-14 rho_0."""
    hl = h_lane[: k + 1].double().cpu().numpy()
    hs = h_solo[: k + 1].double().cpu().numpy()
    keep = hs > 1e-14 * hs[0]
    return bool(np.all(np.abs(hl - hs)[keep] <= MULTI_HIST_RTOL * hs[keep]))


def count_host_reads(fn):
    """Run ``fn`` with torch's sync debug mode on: the host reads it makes
    (each a warning) and its result."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen), out


def phase_multi_path(dev, big, big_full, card):
    """bell_spmv_multi on bench.py's batched operator at R = 1, 8, 32 and
    sym_bell_spmv_multi on the n = 262,144 symmetric tiles; the lockstep CG
    (float64 poisson3d_48 against solo solves, float32 on the n = 262,144
    tiles), block-Jacobi and stencil --nrhs through the tester, block CG,
    the batched MINRES / BiCGStab / GMRES(32) on the 512 x 512 grid, and
    run_batched_cg in chunks through a checkpoint file."""
    import torch

    from conjugategradient_tpu_torch import (BlockedEllMatrix, DIAMatrix, block_cg_solve,
                                             cg_solve, cg_solve_batched, load_matrix)
    from conjugategradient_tpu_torch.ops.cuda import _common
    from conjugategradient_tpu_torch.ops.spmv import (bell_spmv, bell_spmv_multi,
                                                      sym_bell_spmv_multi)
    from conjugategradient_tpu_torch.problems import (block_tridiag_tiles,
                                                      convection_diffusion_2d_coo)
    from conjugategradient_tpu_torch.solver import (batched_cg_init, batched_state_result,
                                                    bicgstab_solve, bicgstab_solve_batched,
                                                    gmres_solve, gmres_solve_batched,
                                                    load_state, minres_solve,
                                                    minres_solve_batched, run_batched_cg,
                                                    save_state)
    from conjugategradient_tpu_torch.solver.precond import block_jacobi_preconditioner
    from conjugategradient_tpu_torch.utils import Timer

    gen = torch.Generator().manual_seed(15)

    # (a) bell_spmv_multi on the bench's operator, R = 1, 8, 32, beside R
    # launches of kernel 5; sym_bell_spmv_multi on the symmetric tiles
    blocks, cols, nnz = block_tridiag_tiles(MULTI_N, 128, 128, seed=0)
    op = BlockedEllMatrix(torch.from_numpy(blocks).to(dev), torch.from_numpy(cols).to(dev),
                          (MULTI_N, MULTI_N), nnz)
    del blocks
    Xall = torch.randn(MULTI_N, max(MULTI_R), generator=gen).to(dev)
    k5_ms = library_ms(lambda: bell_spmv(op, Xall[:, 0].contiguous()))
    per_rhs = {}
    for R in MULTI_R:
        X = Xall[:, :R].contiguous()
        before = _common.LAUNCHES["bell_spmv"]
        err = multi_columns_ok(bell_spmv_multi(op, X), lambda x: bell_spmv(op, x), X,
                               f"bell_spmv_multi R={R}")
        check(_common.LAUNCHES["bell_spmv"] - before == R, "bell_spmv: one launch a column")
        ms = library_ms(lambda: bell_spmv_multi(op, X))
        cols = [X[:, j].contiguous() for j in range(R)]
        k5_r = library_ms(lambda: [bell_spmv(op, x) for x in cols])
        per_rhs[R] = ms / R
        print(f"  bell_spmv_multi n={MULTI_N} 128x128 R={R}: {ms:.5f} ms a call, "
              f"{ms / R:.5f} ms per RHS (amortization {per_rhs[MULTI_R[0]] / (ms / R):.2f}x "
              f"over R=1); {R} launches of kernel 5 {k5_r:.5f} ms (one {k5_ms:.5f}); "
              f"columns within {err:.3e} of kernel 5  [{card}]")
    del op, Xall
    Xs = torch.randn(big.shape[0], MULTI_LANES, generator=gen).to(dev)
    Ys = sym_bell_spmv_multi(big, Xs)
    err = multi_columns_ok(Ys, lambda x: bell_spmv(big_full, x), Xs,
                           "sym_bell_spmv_multi n=262144")
    check(torch.equal(Ys, sym_bell_spmv_multi(big, Xs)), "sym_bell_spmv_multi: two calls differ")
    ms = library_ms(lambda: sym_bell_spmv_multi(big, Xs))
    print(f"  sym_bell_spmv_multi n={big.shape[0]} R={MULTI_LANES}: {ms:.5f} ms a call, two calls "
          f"bit-identical, columns within {err:.3e} of kernel 5 on the full tiles  [{card}]")
    del Xs, Ys

    # (b) cg_solve_batched, R = 8: float64 poisson3d_48 (bell) against solo
    # solves; float32 on the symmetric n = 262,144 tiles (trajectory, ms a
    # step, busy share); block-Jacobi DIA and the stencil through the tester
    path = MATRICES[0]
    p64 = load_matrix(os.path.join(ROOT, path), layout="bell", dtype=np.float64, device=dev)
    n3 = p64.shape[0]
    # seeded independent lanes (rolled copies of one ramp are nearly
    # dependent, which block CG's shared space cannot use), per-lane tol
    B64 = torch.randn(MULTI_LANES, n3, generator=gen, dtype=torch.float64).to(dev)
    tol64 = MULTI_F64_TOL_REL * torch.linalg.vector_norm(B64, dim=1)
    cg_solve_batched(p64, B64, tol=tol64, maxiter=4)
    t = Timer(dev).start_measure()
    X64, i64 = cg_solve_batched(p64, B64, tol=tol64)
    t.stop_measure()
    lock_its = [int(v) for v in i64.iterations.cpu()]
    for j in range(MULTI_LANES):
        _, si = cg_solve(p64, B64[j].contiguous(), tol=float(tol64[j]), fused="never")
        check(lock_its[j] == int(si.iterations) and bool(i64.converged[j]) and
              lanes_hist_ok(i64.rho_history[j], si.rho_history, lock_its[j]),
              f"lockstep f64 lane {j}: {lock_its[j]} its against solo {int(si.iterations)}")
    lock_ms = t.get_duration() / max(lock_its)
    print(f"  cg_solve_batched float64 {path} bell R={MULTI_LANES} (seeded lanes, each to "
          f"1e-8 ||b_j||): "
          f"iterations {lock_its}, each lane's equal to its solo solve and its history within "
          f"{MULTI_HIST_RTOL} relative; {t.get_duration():.2f} ms, {lock_ms:.4f} ms a "
          f"lockstep step  [{card}]")

    # tol = -1 as on the main path: rho reaches exactly 0 on these tiles in
    # the second step, where tol = 0 would end every lane; the rho == 0 guard
    # keeps each of the MULTI_F32_STEPS steps a full pass
    B32 = torch.randn(MULTI_LANES, big.shape[0], generator=gen).to(dev)
    cg_solve_batched(big, B32, tol=-1.0, maxiter=4)
    t = Timer(dev).start_measure()
    _, i32 = cg_solve_batched(big, B32, tol=-1.0, maxiter=MULTI_F32_STEPS)
    t.stop_measure()
    check(int(i32.iterations.min()) == MULTI_F32_STEPS,
          f"lockstep f32 n=262144: iterations {i32.iterations.tolist()}, "
          f"expected {MULTI_F32_STEPS} in every lane")
    step_ms = t.get_duration() / MULTI_F32_STEPS
    used = 0
    for j in range(MULTI_LANES):
        _, si = cg_solve(big, B32[j].contiguous(), tol=-1.0, maxiter=MULTI_F32_STEPS,
                         fused="never")
        ok, u = trajectory_ok(i32.rho_history[j], si.rho_history, MULTI_F32_STEPS)
        check(ok, f"lockstep f32 n=262144 lane {j}: history against the solo solve beyond "
              f"rtol {TRAJ_RTOL}")
        used += u
    # the trajectory above holds only the entries before rho reaches 0; it
    # is held over MULTI_TRAJ_STEPS on the sharded path's cut copy (full
    # storage), which stays above the float32 floor
    cut_full = cut_tridiag_ops(big_full.blocks.view(4, -1, 3, 128, 128),
                               big_full.block_cols.view(4, -1, 3), big_full.nnz)[0]
    _, ic = cg_solve_batched(cut_full, B32, tol=-1.0, maxiter=MULTI_TRAJ_STEPS)
    used_cut = 0
    for j in range(MULTI_LANES):
        _, si = cg_solve(cut_full, B32[j].contiguous(), tol=-1.0, maxiter=MULTI_TRAJ_STEPS,
                         fused="never")
        ok, u = trajectory_ok(ic.rho_history[j], si.rho_history, MULTI_TRAJ_STEPS)
        check(ok, f"lockstep f32 cut n=262144 lane {j}: history against the solo solve beyond "
              f"rtol {TRAJ_RTOL}")
        used_cut += u
    del cut_full
    run64 = lambda: cg_solve_batched(big, B32, tol=-1.0, maxiter=MULTI_F32_STEPS)  # noqa: E731
    busy = device_ms(run64, reps=1)
    busy_s = "not measured" if busy is None else \
        f"{busy / MULTI_F32_STEPS:.4f} ms a step ({100 * busy / t.get_duration():.1f}%)"
    print(f"  cg_solve_batched float32 n={big.shape[0]} symmetric R={MULTI_LANES}, "
          f"{MULTI_F32_STEPS} steps in every lane: {step_ms:.4f} ms a lockstep step "
          f"({step_ms / MULTI_LANES:.4f} per RHS), device busy {busy_s}; every lane within "
          f"rtol {TRAJ_RTOL} of its solo solve on {used} entries before rho reaches 0, and on "
          f"{used_cut} entries of {MULTI_TRAJ_STEPS} steps on the cut copy (full storage)  "
          f"[{card}]")
    del B32

    tol3 = TOL_SOLVE_REL * bnorm(n3)
    before = _common.LAUNCHES["dia_spmv_rows"]
    fields, lanes, summ = multi_tester([os.path.join(ROOT, path), "--layout", "auto",
                                        "--dtype", "float32", "--precond", "blockjacobi",
                                        "--block-size", str(BJ_BLOCK), "--nrhs",
                                        str(MULTI_LANES), "--tol", repr(tol3)])
    launched = _common.LAUNCHES["dia_spmv_rows"] - before
    check(lanes["converged"] == [True] * MULTI_LANES and float(fields[3]) < REL_ERROR_BOUND
          and launched >= 2 * MULTI_LANES * max(lanes["iterations"]),
          f"tester blockjacobi --nrhs: {lanes}, rel_error {fields[3]}, {launched} launches")
    print(f"  tester {path} --layout auto --precond blockjacobi --block-size {BJ_BLOCK} --nrhs "
          f"{MULTI_LANES}: {' '.join(fields)}; iterations {lanes['iterations']}, "
          f"{lanes['per_rhs_ms']:.3f} ms per RHS ({launched} dia_spmv_rows launches over the "
          f"warm-up and the timed solve)  [{card}]")

    ns = int(MULTI_STENCIL.split(":")[1]) ** 3
    tol_s = TOL_SOLVE_REL * bnorm(ns)
    before = k11_launches()
    fields, lanes, summ = multi_tester([MULTI_STENCIL, "--dtype", "float32", "--nrhs", "4",
                                        "--tol", repr(tol_s)])
    launched = k11_launches() - before
    check(lanes["converged"] == [True] * 4 and launched >= 2 * sum(lanes["iterations"]),
          f"tester {MULTI_STENCIL} --nrhs 4: {lanes}, {launched} stencil7 launches")
    print(f"  tester {MULTI_STENCIL} --nrhs 4 float32 (each lane the solo portable loop): "
          f"{' '.join(fields)}; iterations {lanes['iterations']}, {lanes['per_rhs_ms']:.2f} ms "
          f"per RHS ({launched} stencil7 launches)  [{card}]")

    # (c) block CG, R = 8, on the float64 poisson3d_48 lanes of (b)
    block_cg_solve(p64, B64, tol=tol64, maxiter=2)
    t = Timer(dev).start_measure()
    reads, (Xb, ib) = count_host_reads(lambda: block_cg_solve(p64, B64, tol=tol64))
    t.stop_measure()
    block_its = [int(v) for v in ib.iterations.cpu()]
    kb = max(block_its)
    check(bool(ib.converged.all()) and all(a < b for a, b in zip(block_its, lock_its)),
          f"block CG: iterations {block_its} against the lockstep's {lock_its}")
    print(f"  block_cg_solve float64 {path} R={MULTI_LANES}: iterations {block_its} (lockstep "
          f"{lock_its}); {t.get_duration():.2f} ms, {t.get_duration() / kb:.4f} ms a block "
          f"iteration; {reads} host reads, {reads / kb:.2f} a block iteration  [{card}]")
    del p64, B64, X64, Xb

    # (d) batched MINRES (the symmetric peclet-0 grid), BiCGStab and
    # GMRES(32) (bench.py's peclet-10 convection-diffusion), R = 4 on
    # 512 x 512 DIA: lane 0 against the solo solve, ms a step
    def grid_dia(peclet):
        rows, cols, vals, shape = convection_diffusion_2d_coo(NONSYM_NX, peclet=peclet)
        order = np.lexsort((cols, rows))
        r, c, v = rows[order], cols[order], vals[order].astype(np.float32)
        indptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=shape[0]))])
        return DIAMatrix.from_csr_host(v, c, indptr, shape, device=dev)

    Bn = torch.randn(NONSYM_LANES, NONSYM_NX ** 2, generator=gen).to(dev)
    for label, a, batched, solo, kw in (
        ("minres_solve_batched (peclet 0)", grid_dia(0.0), minres_solve_batched, minres_solve,
         {}),
        ("bicgstab_solve_batched", grid_dia(10.0), bicgstab_solve_batched, bicgstab_solve, {}),
        ("gmres_solve_batched(32)", grid_dia(10.0), gmres_solve_batched, gmres_solve,
         {"restart": 32}),
    ):
        batched(a, Bn, tol=0.0, maxiter=4, **kw)
        t = Timer(dev).start_measure()
        Xn, inf = batched(a, Bn, tol=0.0, maxiter=NONSYM_STEPS, **kw)
        t.stop_measure()
        _, si = solo(a, Bn[0].contiguous(), tol=0.0, maxiter=NONSYM_STEPS, **kw)
        h_l = inf.rnorm_history[0, : NONSYM_TRAJ_STEPS + 1].double().cpu().numpy()
        h_s = si.rnorm_history[: NONSYM_TRAJ_STEPS + 1].double().cpu().numpy()
        check(int(inf.iterations[0]) == int(si.iterations)
              and np.allclose(h_l, h_s, rtol=NONSYM_TRAJ_RTOL, atol=0),
              f"{label}: iterations {inf.iterations.tolist()} (solo {int(si.iterations)}), "
              f"lane 0 {h_l} against {h_s}")
        print(f"  {label} {NONSYM_NX}x{NONSYM_NX} DIA R={NONSYM_LANES}, iterations "
              f"{inf.iterations.tolist()}: {t.get_duration() / int(inf.iterations.max()):.4f} "
              f"ms a step; lane 0 within "
              f"{NONSYM_TRAJ_RTOL} of the solo solve over {NONSYM_TRAJ_STEPS} steps  [{card}]")
        del Xn
    del Bn

    # (e) run_batched_cg in chunks of 64 through a checkpoint file: the bits
    # of one uninterrupted batched solve (poisson3d_48 as --layout auto
    # loads it: DIA), and the lockstep loop's steps after the last lane
    p3dia = load_matrix(os.path.join(ROOT, path), layout="auto", dtype=np.float32, device=dev)
    bp = torch.arange(1, n3 + 1, dtype=torch.float32, device=dev)
    Bp = torch.stack([torch.roll(bp, j) for j in range(MULTI_LANES)])
    _, whole = cg_solve_batched(p3dia, Bp, tol=tol3)
    ckpt = os.path.join(ROOT, "build", "chip_smoke_batched.npz")
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    state = batched_cg_init(p3dia, Bp)
    chunks = 0
    while bool(state.live.any()):
        state = run_batched_cg(p3dia, state, tol3, steps=64)
        save_state(ckpt, state)
        state = load_state(ckpt, device=dev)
        chunks += 1
    os.remove(ckpt)
    _, chunked = batched_state_result(state)
    h_whole, h_chunks = digest(whole.rho_history), digest(chunked.rho_history)
    check(h_whole == h_chunks and torch.equal(whole.iterations, chunked.iterations),
          f"run_batched_cg chunks: {h_chunks} against one solve's {h_whole}")
    M = block_jacobi_preconditioner(p3dia, block_size=BJ_BLOCK)
    before = _common.LAUNCHES["dia_spmv_rows"]
    _, ib = cg_solve_batched(p3dia, Bp, tol=tol3, M=M)
    torch.cuda.synchronize()
    steps = (_common.LAUNCHES["dia_spmv_rows"] - before) // MULTI_LANES - 1
    print(f"  run_batched_cg {path} DIA R={MULTI_LANES}: {chunks} chunks of 64 through a "
          f"checkpoint file, rho_history sha256 {h_chunks} (one solve: {h_whole})  [{card}]")
    check_stops_at_done(f"lockstep block-Jacobi PCG {path} DIA R={MULTI_LANES}", steps,
                        int(ib.iterations.max()))


CA_KERNELS = ("bell_spmv", "dia_spmv_rows", "sym_dia_spmv_rows", "stencil7_staged")
CA_STEPS = 256  # at tol = -1 on the n = 262,144 full-storage tiles
CA_S = (2, 4)  # s-step block sizes timed there
CA_F64_TOL_REL = 1e-8  # float64 poisson3d_48 solves to 1e-8 ||b||
# card against the CPU's float64 history: (floor, rtol), the largest
# relative difference on the entries above floor * rho_0.  The GV
# recurrences and the s = 4 monomial basis amplify the two devices'
# last-bit differences: GV's grow as the residual falls (4.4e-11 / 1.8e-10
# above 1e-8 rho_0 on CSR / DIA, 5.7e-9 above 1e-12), so it is held above
# 1e-6; s = 4, whose basis conditions like kappa^4 (~7e11 on poisson3d_48),
# to 1e-9 (1.17-1.19e-10 measured).  tests/test_torch_pipelined.py and
# test_torch_sstep.py find the same against the JAX package.
CA_CHECK = {"cg": (1e-16, 1e-10), "gv": (1e-6, 1e-10), "sstep2": (1e-16, 1e-10),
            "sstep4": (1e-12, 1e-9)}
CA_STENCIL = "stencil:64"
CA_TESTER_MAXITER = 5000
AMG_NX = 512  # bench.py:787-860's amg lane: poisson2d_coo(512) assembled as float32 CSR
AMG_TOL_REL = 1e-6
AMG_PLAIN_MAXITER = 6000
AMG_REPS = 1  # time to tolerance: one timed solve (the run's time budget)
AMG_APPLY_REPS = 20
AMG_KERNELS = ("dia_spmv_rows",)
AMG_F64_SLACK = 3  # float64 AMG / FSAI PCG iterations against the float32 solve's
AMG_F32_TRUE_BOUND = 0.1  # a float32 true relative residual: a solution, not the tol
GUARD_RESTART = 32
GUARD_CYCLES = 4  # GMRES+AMG: maxiter = 4 cycles of 32
# GMRES+AMG tolerances (of ||b||): float32 GMRES reaches only its true
# residual's floor, near 1e-3 on poisson2d(512) and 4e-6 on convdiff_34
GUARD_TOL_REL = {"poisson2d(512)": 1e-3, "problems/convdiff_34.mtx": 1e-5}
GUARD_ITER_SLACK = 2  # GMRES+AMG iterations, DIA levels against CSR levels (float32)
GUARD_TRUE_RATIO = 2.0  # and their true residuals, each within 2x of the other


def ca_history_diff(h_card, h_cpu, k):
    """A float64 card history against the CPU's: {floor: the largest
    relative difference on the entries above floor * rho_0}, or None where
    the NaN entries (s-step's between blocks) differ."""
    hc = h_card[: k + 1].double().cpu().numpy()
    hh = h_cpu[: k + 1].double().cpu().numpy()
    if not np.array_equal(np.isnan(hc), np.isnan(hh)):
        return None
    out = {}
    for floor in (1e-16, 1e-12, 1e-8, 1e-6):
        keep = ~np.isnan(hh) & (hh > floor * hh[0])
        out[floor] = float(np.max(np.abs(hc - hh)[keep] / hh[keep]))
    return out


def phase_ca_path(dev, big, big_full, card):
    """Pipelined and s-step CG: 256 float32 steps on the n = 262,144
    full-storage tiles (kernel 5) beside the portable cg_solve, ms/it,
    effective GB/s, busy share, launches a step and host reads; float64
    poisson3d_48 on CSR and DIA (and Jacobi GV) against the CPU's solve;
    s = 1 against plain CG; the tester's --method pipelined|sstep on
    kernels 7, 10 and 11."""
    import torch

    from conjugategradient_tpu_torch import cg_solve, jacobi_preconditioner, load_matrix
    from conjugategradient_tpu_torch.ops.cuda import _common
    from conjugategradient_tpu_torch.solver import pipelined_cg_solve, sstep_cg_solve
    from conjugategradient_tpu_torch.utils import Timer

    n = N_BIG
    gen = torch.Generator().manual_seed(16)
    solvers = [("cg_solve(fused='never')", lambda a, b, **kw: cg_solve(a, b, fused="never", **kw)),
               ("pipelined_cg_solve", pipelined_cg_solve)]
    solvers += [(f"sstep_cg_solve s={s}",
                 (lambda s: lambda a, b, **kw: sstep_cg_solve(a, b, s=s, **kw))(s)) for s in CA_S]

    # (a) 256 steps at tol = -1 on the full-storage tiles; these tiles can
    # take the residual to exactly 0 (PR 15's lockstep finding), where the
    # pipelined alpha may be 0/0: then every loop is timed on the cut copy
    # (condition <= 91, seeded normal b), which stays off the floor
    b = torch.arange(1, n + 1, dtype=torch.float32, device=dev) / n
    op, label = big_full, "n=262144 full storage (402.7 MB)"
    pipelined_cg_solve(op, b, tol=-1.0, maxiter=4)
    _, probe = pipelined_cg_solve(op, b, tol=-1.0, maxiter=CA_STEPS)
    if int(probe.iterations) < CA_STEPS:
        print(f"  pipelined_cg_solve on the full tiles stopped at {int(probe.iterations)} of "
              f"{CA_STEPS} steps (alpha 0/0 once the residual underflows): timing on the cut "
              f"copy")
        op = cut_tridiag_ops(big_full.blocks.view(4, -1, 3, 128, 128),
                             big_full.block_cols.view(4, -1, 3), big_full.nnz)[0]
        b = torch.randn(n, generator=gen).to(dev)
        label = "n=262144 cut copy, full storage (402.7 MB)"
    eff = big_full.tile_bytes() + 10 * n * 4
    rows = {}
    for name, solve in solvers:
        solve(op, b, tol=-1.0, maxiter=8)
        before = dict(_common.LAUNCHES)
        t = Timer(dev).start_measure()
        reads, (_, info) = count_host_reads(lambda: solve(op, b, tol=-1.0, maxiter=CA_STEPS))
        t.stop_measure()
        its = int(info.iterations)
        check(its == CA_STEPS, f"{name} {label}: {its} of {CA_STEPS} steps")
        launched = {k: _common.LAUNCHES[k] - before[k] for k in before
                    if _common.LAUNCHES[k] != before[k]}
        ms_it = t.get_duration() / CA_STEPS
        busy = device_ms(lambda: solve(op, b, tol=-1.0, maxiter=CA_STEPS), reps=1)
        busy_s = "not measured" if busy is None else \
            f"{busy / CA_STEPS:.4f} ms a step ({100 * busy / t.get_duration():.1f}%)"
        per = {k: v / CA_STEPS for k, v in launched.items()}
        unit = "block" if name.startswith("sstep") else "step"
        s = int(name.split("=")[1]) if unit == "block" else 1
        rows[name] = (ms_it, busy)
        print(f"  {name} {label} float32, {CA_STEPS} steps at tol = -1: {ms_it:.4f} ms/it, "
              f"effective {eff / ms_it / 1e6:.1f} GB/s on {eff / 1e6:.1f} MB/it; device busy "
              f"{busy_s}; launches a step {per}; {reads} host reads, "
              f"{reads * s / CA_STEPS:.3f} a {unit}  [{card}]")
    check(all(np.isfinite(v[0]) for v in rows.values()), "CA timing: a time is not finite")
    del op

    # (b) float64 poisson3d_48 on CSR and DIA: the card against the CPU's
    # solve of the same inputs (iterations equal, histories within 1e-10)
    path = MATRICES[0]
    cases = []
    for layout in ("csr", "dia"):
        a_card = load_matrix(os.path.join(ROOT, path), layout=layout, dtype=np.float64,
                             device=dev)
        a_cpu = load_matrix(os.path.join(ROOT, path), layout=layout, dtype=np.float64,
                            device="cpu")
        cases.append((layout, a_card, a_cpu))
    n3 = cases[0][1].shape[0]
    b_cpu = torch.arange(1, n3 + 1, dtype=torch.float64)
    b_card = b_cpu.to(dev)
    tol = CA_F64_TOL_REL * bnorm(n3)
    failed = []
    for layout, a_card, a_cpu in cases:
        runs = [("pipelined", "cg", lambda a, bb, M: pipelined_cg_solve(a, bb, tol=tol), None),
                ("sstep s=2", "sstep2", lambda a, bb, M: sstep_cg_solve(a, bb, s=2, tol=tol),
                 None),
                ("sstep s=4", "sstep4", lambda a, bb, M: sstep_cg_solve(a, bb, s=4, tol=tol),
                 None),
                ("pipelined Jacobi GV", "gv",
                 lambda a, bb, M: pipelined_cg_solve(a, bb, tol=tol, M=M), True)]
        for what, floor, run, with_m in runs:
            Mc = jacobi_preconditioner(a_card) if with_m else None
            Mh = jacobi_preconditioner(a_cpu) if with_m else None
            xc, ic = run(a_card, b_card, Mc)
            xh, ih = run(a_cpu, b_cpu, Mh)
            k = int(ih.iterations)
            diff = ca_history_diff(ic.rho_history, ih.rho_history, k)
            fl, rtol = CA_CHECK[floor]
            ok = (int(ic.iterations) == k and bool(ic.converged) and bool(ih.converged)
                  and diff is not None and diff[fl] <= rtol)
            diff_s = "NaN slots differ" if diff is None else " / ".join(
                f"{v:.2e}" for v in diff.values())
            print(f"  {what} float64 {path} {layout} to {CA_F64_TOL_REL} ||b||: card "
                  f"{int(ic.iterations)} its, CPU {k}; largest relative history difference "
                  f"above 1e-16 / 1e-12 / 1e-8 / 1e-6 rho_0: {diff_s} (held to {rtol:g} above "
                  f"{fl:g}){'' if ok else ': FAILED'}  [{card}]")
            if not ok:
                failed.append(f"{what} {layout}")
        _, i1 = sstep_cg_solve(a_card, b_card, s=1, tol=tol)
        _, ic = cg_solve(a_card, b_card, tol=tol)
        check(int(i1.iterations) == int(ic.iterations),
              f"sstep s=1 {layout}: {int(i1.iterations)} its against cg_solve's "
              f"{int(ic.iterations)}")
        print(f"  sstep_cg_solve s=1 float64 {path} {layout}: {int(i1.iterations)} its, plain "
              f"CG's count  [{card}]")
    check(not failed, f"float64 card solves against the CPU's: {failed}")
    del cases

    # (c) the tester: --method pipelined|sstep on float32 DIA (kernel 7),
    # symmetric DIA (kernel 10) and the stencil (kernel 11).  The float32
    # GV recurrences stall above this tolerance without residual
    # replacement (solver/pipelined.py), so the preconditioned runs take
    # --recompute, as the JAX tester's help says they should
    tol3 = TOL_SOLVE_REL * bnorm(n3)
    cap = ("--maxiter", str(CA_TESTER_MAXITER))
    for src, layout, precond, extra in (
            (path, "auto", "none", ("--method", "pipelined")),
            (path, "auto", "jacobi", ("--method", "pipelined", "--recompute", "50")),
            (path, "auto", "none", ("--method", "sstep", "--sstep-s", "4")),
            (path, "symdia", "none", ("--method", "sstep", "--sstep-s", "2")),
            (CA_STENCIL, "csr", "none", ("--method", "pipelined")),
            (CA_STENCIL, "csr", "amg", ("--method", "pipelined", "--recompute", "5"))):
        extra = extra + cap
        nn = int(src.split(":")[1]) ** 3 if src.startswith("stencil:") else n3
        tt = tol3 if nn == n3 else TOL_SOLVE_REL * bnorm(nn)
        dim, nnz, ms, rel, summ, _ = run_tester(src, layout, precond, tt, extra=extra)
        it = summ["iterations"][0]
        what = f"tester {src} --layout {layout} --precond {precond} {' '.join(extra)}"
        check(summ["converged"][0] and math.isfinite(rel) and rel < REL_ERROR_BOUND,
              f"{what}: {summ}, rel_error {rel}")
        print(f"  {what} float32: dim {dim} nnz {nnz} {ms:.3f} ms, {it} its "
              f"({ms / max(it, 1):.4f} ms/it), rel_error {rel:.3e}  [{card}]")


def amg_case(dev):
    """bench.py's amg lane: poisson2d_coo(512) assembled as float32 CSR on
    the card, b = arange(1, n + 1) / n, and its host float64 copy."""
    import scipy.sparse as sp
    import torch

    from conjugategradient_tpu_torch import CSRMatrix
    from conjugategradient_tpu_torch.problems import poisson2d_coo

    rows, cols, vals, shape = poisson2d_coo(AMG_NX)
    A = CSRMatrix.from_coo(rows, cols, vals, shape, dtype=np.float32, device=dev)
    host = sp.csr_matrix((np.asarray(vals, np.float64), (rows, cols)), shape=shape)
    n = shape[0]
    b = torch.arange(1, n + 1, dtype=torch.float32, device=dev) / n
    return A, host, b


def true_rel(host, b, x) -> float:
    bh = b.double().cpu().numpy()
    return float(np.linalg.norm(bh - host @ x.double().cpu().numpy()) / np.linalg.norm(bh))


def phase_amg_path(dev, card):
    """bench.py's amg lane at its published size: plain CG, Jacobi PCG,
    SA-AMG PCG (Jacobi and Chebyshev smoothers) and FSAI PCG (power 1 and
    2), host setup, levels and layouts, iterations, the true residual, time
    to tolerance, the V-cycle's ms, launches and busy share; then the
    GMRES guard: GMRES(32) with SA-AMG on DIA levels against CSR levels."""
    import torch

    from conjugategradient_tpu_torch import (cg_solve, fsai_preconditioner, gmres_solve,
                                             jacobi_preconditioner, load_matrix,
                                             smoothed_aggregation_preconditioner)
    from conjugategradient_tpu_torch.ops.cuda import _common
    from conjugategradient_tpu_torch.solver import amg

    A, host, b = amg_case(dev)
    n = A.shape[0]
    tol = AMG_TOL_REL * float(torch.linalg.vector_norm(b.double()))
    print(f"  poisson2d({AMG_NX}) float32 CSR: n={n} nnz={A.nnz}, tol {AMG_TOL_REL} ||b|| "
          f"= {tol:.4e}")

    layouts = []

    def layouts_of():
        """Each level's layout by the rule the apply used, from the
        hierarchy rebuilt on the host once (it is deterministic)."""
        if not layouts:
            mats, _ = amg._build_hierarchy(amg._to_scipy_csr(A), theta=0.08,
                                           smooth_prolongator=True, coarse_size=400,
                                           max_levels=20)
            layouts.extend([amg._level_layout(m["A"]) for m in mats] + ["dense"])
        return layouts

    def timed(M, maxiter=None):
        cg_solve(A, b, tol=tol, M=M, maxiter=maxiter)
        ts = []
        for _ in range(AMG_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, info = cg_solve(A, b, tol=tol, M=M, maxiter=maxiter)
            float(info.rnorm_sq)
            ts.append((time.perf_counter() - t0) * 1e3)
        ts.sort()
        busy = device_ms(lambda: cg_solve(A, b, tol=tol, M=M, maxiter=maxiter), reps=1,
                         tries=2)
        return x, info, ts[len(ts) // 2], busy

    def apply_stats(M):
        r = b.clone()
        M(r)
        before = dict(_common.LAUNCHES)
        M(r)
        torch.cuda.synchronize()
        per = {k: _common.LAUNCHES[k] - before[k] for k in before
               if _common.LAUNCHES[k] != before[k]}
        return cuda_ms(lambda: M(r), reps=AMG_APPLY_REPS), per, kernel_profile(lambda: M(r))

    results = {}
    for name, build, maxiter in (
            ("plain CG", lambda: None, AMG_PLAIN_MAXITER),
            ("Jacobi PCG", lambda: jacobi_preconditioner(A), AMG_PLAIN_MAXITER),
            ("SA-AMG PCG, Jacobi smoother", lambda: smoothed_aggregation_preconditioner(A),
             None),
            ("SA-AMG PCG, Chebyshev smoother",
             lambda: smoothed_aggregation_preconditioner(A, smoother="chebyshev"), None),
            ("FSAI(1) PCG", lambda: fsai_preconditioner(A, power=1), AMG_PLAIN_MAXITER),
            ("FSAI(2) PCG", lambda: fsai_preconditioner(A, power=2), AMG_PLAIN_MAXITER)):
        t0 = time.perf_counter()
        M = build()
        setup_s = time.perf_counter() - t0
        x, info, ms, busy = timed(M, maxiter)
        its = int(info.iterations)
        rel = true_rel(host, b, x)
        # float32 reaches the tolerance on its recurrence residual; the true
        # one sits at float32's floor, so the float64 solves below hold it
        check(bool(info.converged) and math.isfinite(rel) and rel < AMG_F32_TRUE_BOUND,
              f"{name}: converged {bool(info.converged)} in {its}, true residual {rel:.3e}")
        busy_s = "not measured" if busy is None else f"{100 * busy / ms:.1f}%"
        extra = ""
        if M is not None and name.startswith(("SA", "FSAI")):
            ams, per, prof = apply_stats(M)
            dev_s = "not measured" if prof is None else f"{prof[0]:.4f} ms device"
            if name.startswith("SA"):
                extra = (f"; levels {list(M.level_sizes)} "
                         f"(layouts {layouts_of()}), operator complexity "
                         f"{M.operator_complexity:.3f}")
            else:
                extra = f"; G {type(M.G).__name__} ({M.nnz} nonzeros), Gt {type(M.Gt).__name__}"
            extra += f"; apply {ams:.4f} ms ({dev_s}), launches an apply {per}"
        results[name] = (its, ms)
        print(f"  {name}: setup {setup_s:.3f} s, {its} its, converged {bool(info.converged)}, "
              f"true relative residual {rel:.3e}, time to tolerance {ms:.2f} ms (median of "
              f"{AMG_REPS}), {ms / max(its, 1):.4f} ms/it, device busy {busy_s}{extra}  [{card}]")
    # the same solves in float64 on the card (no kernel: float64 DIA runs
    # the plain product), to the tolerance on the true residual too
    A64 = A.astype(torch.float64)
    b64 = b.double()
    for name, build in (("SA-AMG PCG, Jacobi smoother",
                         lambda: smoothed_aggregation_preconditioner(A64)),
                        ("FSAI(1) PCG", lambda: fsai_preconditioner(A64, power=1))):
        x, info = cg_solve(A64, b64, tol=tol, M=build())
        its, rel = int(info.iterations), true_rel(host, b64, x)
        check(bool(info.converged) and rel < 10 * AMG_TOL_REL
              and abs(its - results[name][0]) <= AMG_F64_SLACK,
              f"{name} float64: converged {bool(info.converged)} in {its} (float32 "
              f"{results[name][0]}), true residual {rel:.3e}")
        print(f"  {name} float64: {its} its (float32 {results[name][0]}), true relative "
              f"residual {rel:.3e}  [{card}]")
    del A64, b64
    plain_ms = results["plain CG"][1]
    for name in results:
        if name != "plain CG":
            its, ms = results[name]
            print(f"  {name}: {results['plain CG'][0] / max(its, 1):.1f}x fewer iterations and "
                  f"{plain_ms / ms:.2f}x less time than plain CG  [{card}]")

    # the GMRES guard: SA-AMG inside GMRES(32) on DIA levels (the default)
    # against CSR levels, on this system and on convdiff_34.mtx; a fault
    # fails the phase
    cd = load_matrix(os.path.join(ROOT, CONVDIFF), layout="csr", dtype=np.float32, device=dev)
    cd_host = amg._to_scipy_csr(cd)
    bc = torch.arange(1, cd.shape[0] + 1, dtype=torch.float32, device=dev)
    for label, a, a_host, rhs in (("poisson2d(512)", A, host, b),
                                  (CONVDIFF, cd, cd_host, bc)):
        gtol = GUARD_TOL_REL[label] * float(torch.linalg.vector_norm(rhs.double()))
        got = {}
        for layout in ("auto", "csr"):
            before = dict(_common.LAUNCHES)
            M = smoothed_aggregation_preconditioner(a, level_layout=layout)
            x, info = gmres_solve(a, rhs, tol=gtol, restart=GUARD_RESTART, M=M,
                                  maxiter=GUARD_CYCLES * GUARD_RESTART)
            torch.cuda.synchronize()
            rel = true_rel(a_host, rhs, x)
            dia = sum(_common.LAUNCHES[k] - before[k] for k in ("dia_spmv", "dia_spmv_rows"))
            got[layout] = (bool(info.converged), int(info.iterations), rel)
            check(math.isfinite(rel) and (layout == "csr" or dia > 0),
                  f"GMRES+AMG {label} {layout} levels: {got[layout]}, {dia} DIA launches")
            print(f"  gmres_solve(restart={GUARD_RESTART}, maxiter "
                  f"{GUARD_CYCLES * GUARD_RESTART}, M=SA-AMG level_layout={layout!r}) {label} "
                  f"float32 to {GUARD_TOL_REL[label]} ||b||: converged {bool(info.converged)}, "
                  f"{int(info.iterations)} its, true relative residual {rel:.3e}, {dia} DIA "
                  f"kernel launches  [{card}]")
        (ca, ka, ra), (cc, kc, rc) = got["auto"], got["csr"]
        check(ca == cc and abs(ka - kc) <= GUARD_ITER_SLACK
              and max(ra, rc) <= GUARD_TRUE_RATIO * min(ra, rc),
              f"GMRES+AMG {label}: DIA levels {got['auto']} against CSR levels {got['csr']}")


DEFLATION_KERNELS = ("dia_spmv_rows", "bell_spmv_packed")
EIGS_K = 8  # bench.py:1286-1363's eigs lane: LOBPCG k = 8, Jacobi, n = 262,144 symmetric tiles
EIGS_ITERS = (48, 96)  # its two-point protocol: fixed-count runs at tol = 0, tol_absolute
EIGS_REPS = 3
EIGS_TOL_REL = 1e-5  # its time-to-tolerance run, cap 200
EIGS_TOL_MAXITER = 200
EIGS_LANCZOS_ITERS = 120  # the float64 Lanczos pass that lambda_min is held against
EIGS_F32_RQ = 1e-5  # float32 Rayleigh-Ritz rounding, of theta_max, in that comparison
DEFL_K = 8
DEFL_HARVEST_M = 200
# of ||b||: the amg lane's 1e-6, and 1e-4, where the float32 deflated solves
# also reach the tolerance (at 1e-6 they may stop at the divergence guard,
# as the JAX package's do: poisson2d(128) and (256) on the CPU)
DEFL_TOLS = (1e-6, 1e-4)
# time to stop: one timed solve at each tolerance (the median of 3 at 1e-6
# before the sharded families path took that share of the run's time)
DEFL_REPS = {1e-6: 1, 1e-4: 1}
DEFL_F64_TOL_REL = 1e-8
DEFL_ITER_SLACK = 1  # float64 deflated CG, card against the CPU's plain versions
LOBPCG_ITER_SLACK = 3  # float64 LOBPCG there (tests/test_torch_lobpcg.py's slack)
LOBPCG_F64_TOL = 3e-3  # of theta_max: all 4 pairs converge (55 its on the CPU)
LOBPCG_F64_MAXITER = 150
SCIPY_FILE = "problems/poisson2d_110.mtx"
SCIPY_RTOL = 1e-8
SCIPY_GMRES_RESTART = 50  # both gmres calls (scipy's default of 20 takes ~4x the cycles)
SCIPY_TRUE_FACTOR = 2.0  # each solve's true relative residual: at most 2 rtol
SCIPY_EIG_RTOL = 1e-8  # eigsh against scipy's shift-invert eigsh
SCIPY_EYE_N = 100  # eigsh(identity, k=3): a triple eigenvalue


def eigs_lane(dev, big, card) -> None:
    """bench.py's eigs lane on the n = 262,144 symmetric tiles: LOBPCG k = 8
    with Jacobi, ms an iteration from the two-point difference of fixed-count
    runs (CUDA events, the median of 3), device ms and busy share
    (torch.profiler), host reads an iteration; the run to 1e-5 (cap 200):
    iterations, seconds, max residual, lambda_min, held against a float64
    Lanczos pass of the same operator on the card."""
    import torch

    from conjugategradient_tpu_torch import jacobi_preconditioner, lanczos_eigs, lobpcg_eigs

    M = jacobi_preconditioner(big)

    def run(maxiter, tol, absolute):
        return lobpcg_eigs(big, k=EIGS_K, M=M, which="smallest", tol=tol, maxiter=maxiter,
                           tol_absolute=absolute)

    def timed(maxiter, tol, absolute=False):
        res = run(maxiter, tol, absolute)
        ts = []
        for _ in range(EIGS_REPS):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            e0.record()
            res = run(maxiter, tol, absolute)
            e1.record()
            e1.synchronize()
            ts.append(e0.elapsed_time(e1))
        ts.sort()
        return res, ts[len(ts) // 2]

    lo, hi = EIGS_ITERS
    r_lo, t_lo = timed(lo, 0.0, True)
    r_hi, t_hi = timed(hi, 0.0, True)
    check(r_lo.iters == lo and r_hi.iters == hi,
          f"eigs lane: fixed-count runs made {r_lo.iters} / {r_hi.iters} iterations")
    per_it = (t_hi - t_lo) / (hi - lo)
    d_lo = device_ms(lambda: run(lo, 0.0, True), reps=1)
    d_hi = device_ms(lambda: run(hi, 0.0, True), reps=1)
    dev_it = None if d_lo is None or d_hi is None else (d_hi - d_lo) / (hi - lo)
    prof = kernel_profile(lambda: run(8, 0.0, True), top=5)
    reads_lo, _ = count_host_reads(lambda: run(lo, 0.0, True))
    reads_hi, _ = count_host_reads(lambda: run(hi, 0.0, True))
    busy_s = ("not measured" if dev_it is None else
              f"{dev_it:.4f} ms device an iteration ({100 * dev_it / per_it:.1f}% busy)")
    print(f"  eigs lane: lobpcg_eigs(k={EIGS_K}, M=Jacobi) n={N_BIG} symmetric 128 x 128 float32, "
          f"{lo} / {hi} iterations at tol = 0: {t_lo:.2f} / {t_hi:.2f} ms (median of "
          f"{EIGS_REPS}), {per_it:.4f} ms an iteration (two-point), {busy_s}, "
          f"{(reads_hi - reads_lo) / (hi - lo):.3f} host reads an iteration ({reads_lo} / "
          f"{reads_hi} a call), fixed cost {t_hi - per_it * hi:.2f} ms a call  [{card}]")
    if prof is not None:
        print(f"  eigs lane, 8 iterations under torch.profiler: {prof[0]:.3f} ms device, "
              f"{prof[1]} kernels; the top five by device time "
              f"{[(k[:60], round(ms, 4), c) for k, ms, c in prof[2]]}  [{card}]")
    res, t_tol = timed(EIGS_TOL_MAXITER, EIGS_TOL_REL)
    vals, resid = np.asarray(res.values, np.float64), np.asarray(res.residuals, np.float64)
    check(np.all(np.isfinite(vals)) and np.all(np.diff(vals) >= 0),
          f"eigs lane: values {vals}")
    theta = float(np.abs(vals).max())
    big64 = big.astype(torch.float64)
    ref = lanczos_eigs(big64, k=1, which="smallest", iters=EIGS_LANCZOS_ITERS)
    del big64
    lam, lam64 = float(vals[0]), float(ref.values[0])
    # each Ritz value lies within its residual norm of an eigenvalue; the
    # float32 Rayleigh-Ritz adds its rounding
    bound = float(resid[0]) + float(ref.residuals[0]) + EIGS_F32_RQ * theta
    print(f"  eigs lane to {EIGS_TOL_REL} (relative, cap {EIGS_TOL_MAXITER}): {res.iters} "
          f"iterations, {t_tol / 1e3:.4f} s (median of {EIGS_REPS}), converged "
          f"{int(np.sum(res.converged))}/{EIGS_K}, max residual {resid.max():.4e}, lambda_min "
          f"{lam:.8f} against the float64 Lanczos's {lam64:.8f} ({EIGS_LANCZOS_ITERS} steps, "
          f"residual bound {float(ref.residuals[0]):.2e}): difference {abs(lam - lam64):.3e}, "
          f"held to {bound:.3e}  [{card}]")
    check(abs(lam - lam64) <= bound,
          f"eigs lane: lambda_min {lam} against float64 Lanczos {lam64}, bound {bound:.3e}")


def deflation_at_scale(dev, card) -> None:
    """poisson2d(512) as float32 DIA (5 diagonals: kernel 7 by value), b =
    arange(1, n+1)/n: plain CG against deflated CG with k = 8 bases from
    LOBPCG with SA-AMG (built on the CSR copy), Lanczos at its default
    length and the harvest of a 200-step CG pass (the first solve
    warm-started from its x), at 1e-6 and 1e-4 of ||b||: setup seconds,
    basis_quality, iterations, ms to the stop (one solve at each tolerance)
    and a step,
    the true relative residual, the divergence guard and kernel 7's
    launches."""
    import torch

    from conjugategradient_tpu_torch import (DIAMatrix, cg_solve, deflated_cg_solve,
                                             harvest_deflation_basis, make_deflation_basis,
                                             smoothed_aggregation_preconditioner)
    from conjugategradient_tpu_torch.ops.cuda import _common
    from conjugategradient_tpu_torch.solver import basis_quality

    A, host, b = amg_case(dev)
    dia = DIAMatrix.from_csr(A)
    check(dia.ndiag == 5, f"poisson2d({AMG_NX}) as DIA: {dia.ndiag} diagonals")
    n = A.shape[0]
    bn2 = float(torch.linalg.vector_norm(b.double()))
    print(f"  poisson2d({AMG_NX}) float32 DIA: n={n}, {dia.ndiag} diagonals, k={DEFL_K}")

    def timed(solve, reps):
        """(x, info, the median ms of ``reps`` solves, kernel-7 launches a
        solve); every solve here launches nothing to build."""
        ts = []
        before = _common.LAUNCHES["dia_spmv_rows"]
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, info = solve()
            float(info.rnorm_sq)
            ts.append((time.perf_counter() - t0) * 1e3)
        ts.sort()
        return x, info, ts[len(ts) // 2], (_common.LAUNCHES["dia_spmv_rows"] - before) // reps

    bases = {}
    t0 = time.perf_counter()
    M = smoothed_aggregation_preconditioner(A)
    t_amg = time.perf_counter() - t0
    t0 = time.perf_counter()
    bases["LOBPCG + SA-AMG"] = (make_deflation_basis(dia, k=DEFL_K, method="lobpcg", M=M), None,
                                time.perf_counter() - t0, f" (+ {t_amg:.3f} s AMG setup)")
    t0 = time.perf_counter()
    bases["Lanczos, default length"] = (make_deflation_basis(dia, k=DEFL_K), None,
                                        time.perf_counter() - t0, "")
    t0 = time.perf_counter()
    basis, x_m = harvest_deflation_basis(dia, b, k=DEFL_K, m=DEFL_HARVEST_M, return_x=True)
    bases[f"harvest m={DEFL_HARVEST_M}"] = (basis, x_m, time.perf_counter() - t0,
                                            " (the first solve warm-started from its x)")
    qual = {name: float(basis_quality(dia, v[0]).max()) for name, v in bases.items()}
    for name, (_, _, setup, note) in bases.items():
        print(f"  basis {name}: setup {setup:.3f} s{note}, basis_quality max {qual[name]:.4g}  "
              f"[{card}]")
    for tol_rel in DEFL_TOLS:
        tol = tol_rel * bn2
        rows = [("plain CG", lambda: cg_solve(dia, b, tol=tol, maxiter=AMG_PLAIN_MAXITER))]
        for name, (basis, x0, _, _) in bases.items():
            rows.append((name, (lambda basis, x0: lambda: deflated_cg_solve(
                dia, b, basis, x0=x0, tol=tol, maxiter=AMG_PLAIN_MAXITER))(basis, x0)))
        plain = None
        reps = DEFL_REPS[tol_rel]
        for name, solve in rows:
            x, info, ms, k7 = timed(solve, reps)
            its = int(info.iterations)
            rel = true_rel(host, b, x)
            conv = bool(info.converged)
            guard = (not conv) and math.isfinite(float(info.rnorm_sq)) and its < AMG_PLAIN_MAXITER
            check(math.isfinite(rel) and rel < AMG_F32_TRUE_BOUND and (conv or guard),
                  f"{name} at {tol_rel} ||b||: converged {conv} in {its}, guard {guard}, "
                  f"true residual {rel:.3e}")
            plain = plain or (its, ms)
            print(f"  {name} to {tol_rel} ||b||: {its} its ({its / plain[0]:.2f}x plain CG's), "
                  f"converged {conv}, divergence guard {guard}, true relative residual {rel:.3e}, "
                  f"time to stop {ms:.2f} ms (median of {reps}, {ms / plain[1]:.2f}x plain "
                  f"CG's), {ms / max(its, 1):.4f} ms/it, {k7} kernel-7 launches  [{card}]")


def deflation_parity(dev, card) -> None:
    """float64 poisson3d_48 on CSR and DIA: deflated CG with one host basis
    (8 Lanczos vectors of the CPU copy) and LOBPCG k = 4 on the card against
    the same calls on CPU tensors (the plain versions) in this run."""
    import torch

    from conjugategradient_tpu_torch import (deflated_cg_solve, load_matrix, lobpcg_eigs,
                                             make_deflation_basis)
    from conjugategradient_tpu_torch.solver import deflation_basis_from_vectors

    path = MATRICES[0]
    failed = []
    for layout in ("csr", "dia"):
        a_card = load_matrix(os.path.join(ROOT, path), layout=layout, dtype=np.float64,
                             device=dev)
        a_cpu = load_matrix(os.path.join(ROOT, path), layout=layout, dtype=np.float64,
                            device="cpu")
        n3 = a_cpu.shape[0]
        b_cpu = torch.arange(1, n3 + 1, dtype=torch.float64)
        tol = DEFL_F64_TOL_REL * bnorm(n3)
        W = make_deflation_basis(a_cpu, k=DEFL_K, lanczos_iters=40).W
        _, ic = deflated_cg_solve(a_card, b_cpu.to(dev),
                                  deflation_basis_from_vectors(a_card, W.to(dev)), tol=tol)
        _, ih = deflated_cg_solve(a_cpu, b_cpu, deflation_basis_from_vectors(a_cpu, W), tol=tol)
        k = int(ih.iterations)
        diff = ca_history_diff(ic.rho_history, ih.rho_history, max(k, int(ic.iterations)))
        ok = (abs(int(ic.iterations) - k) <= DEFL_ITER_SLACK and bool(ic.converged)
              and bool(ih.converged) and diff is not None and diff[1e-8] <= 1e-10)
        diff_s = "NaN slots differ" if diff is None else f"{diff[1e-8]:.2e}"
        print(f"  deflated_cg_solve float64 {path} {layout} (k={DEFL_K}, Lanczos basis) to "
              f"{DEFL_F64_TOL_REL} ||b||: card {int(ic.iterations)} its, CPU {k}; largest "
              f"relative history difference above 1e-8 rho_0 {diff_s}"
              f"{'' if ok else ': FAILED'}  [{card}]")
        if not ok:
            failed.append(f"deflated {layout}")
        rc = lobpcg_eigs(a_card, k=4, tol=LOBPCG_F64_TOL, maxiter=LOBPCG_F64_MAXITER,
                         return_history=True)
        rh = lobpcg_eigs(a_cpu, k=4, tol=LOBPCG_F64_TOL, maxiter=LOBPCG_F64_MAXITER,
                         return_history=True)
        m = min(len(rc[1]), len(rh[1]))
        lam_diff = float(np.max(np.abs(rc[1][:m] - rh[1][:m])) / np.abs(rh[1]).max())
        ok = (abs(rc[0].iters - rh[0].iters) <= LOBPCG_ITER_SLACK
              and np.allclose(rc[0].values, rh[0].values, rtol=1e-10, atol=0)
              and lam_diff <= 1e-10)
        print(f"  lobpcg_eigs(k=4) float64 {path} {layout} to {LOBPCG_F64_TOL}: card "
              f"{rc[0].iters} its, CPU {rh[0].iters}, values {rc[0].values}, largest eigenvalue "
              f"history difference {lam_diff:.2e} of the largest value{'' if ok else ': FAILED'}"
              f"  [{card}]")
        if not ok:
            failed.append(f"lobpcg {layout}")
    check(not failed, f"float64 card solves against the CPU's: {failed}")


def deflation_tester(dev, card) -> None:
    """The tester: --deflate 8 --tol 1e-8 on poisson2d_34 (float64 CSR; dim
    1156, rel_error < 1e-10, as tests/test_deflated.py holds the JAX
    tester), --deflate 8 on poisson3d_48 float32 blocked-ELL (packed kernel
    5), and --eigs 4 with Jacobi and --history, and with --eigs-method
    lanczos, on poisson3d_48 float32 blocked-ELL."""
    from conjugategradient_tpu_torch import tester

    def run(args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = tester.main([*args, "--device", str(DEVICE)])
        lines = buf.getvalue().strip().splitlines()
        check(rc == 0, f"tester {' '.join(args)}: rc {rc}")
        return lines

    lines = run([os.path.join(ROOT, "problems/poisson2d_34.mtx"), "--deflate", "8", "--tol",
                 "1e-8", "--summary"])
    dim, nnz, ms, rel = lines[0].split()
    summ = json.loads(lines[1])
    check(dim == "1156" and float(rel) < 1e-10 and summ["converged"] == [True],
          f"tester --deflate 8 poisson2d_34: {lines}")
    print(f"  tester problems/poisson2d_34.mtx --deflate 8 --tol 1e-8 float64: dim {dim} nnz {nnz} "
          f"{float(ms):.3f} ms, {summ['iterations'][0]} its, rel_error {float(rel):.3e}  [{card}]")
    p3d = os.path.join(ROOT, MATRICES[0])
    tol = TOL_SOLVE_REL * bnorm(110_592)
    lines = run([p3d, "--deflate", "8", "--layout", "bell", "--dtype", "float32", "--tol",
                 repr(tol), "--summary"])
    dim, nnz, ms, rel = lines[0].split()
    summ = json.loads(lines[1])
    check(math.isfinite(float(rel)) and float(rel) < REL_ERROR_BOUND,
          f"tester --deflate 8 poisson3d_48 bell: {lines}")
    print(f"  tester {MATRICES[0]} --deflate 8 --layout bell float32 --tol 1e-5 ||b||: dim {dim} "
          f"{float(ms):.3f} ms, {summ['iterations'][0]} its, converged {summ['converged'][0]}, "
          f"rel_error {float(rel):.3e}  [{card}]")
    lam_min = 6.0 * (1.0 - math.cos(math.pi / 49.0))  # 7-point Poisson, h = 1/49
    for extra in (["--precond", "jacobi", "--history"], ["--eigs-method", "lanczos"]):
        lines = run([p3d, "--eigs", "4", "--layout", "bell", "--dtype", "float32", *extra])
        dim, nnz, ms, rel = lines[0].split()
        rec = json.loads(lines[1])
        vals = rec["eigenvalues"]
        check(len(lines) == (3 if "--history" in extra else 2) and len(vals) == 4
              and all(math.isfinite(v) and v > 0 for v in vals) and vals == sorted(vals),
              f"tester --eigs 4 {' '.join(extra)}: {lines[:2]}")
        if "--history" in extra:
            hist = json.loads(lines[2])
            check(len(hist["eigenvalue_history"]) == rec["iterations"] + 1,
                  f"tester --eigs --history: {len(hist['eigenvalue_history'])} rows")
        print(f"  tester {MATRICES[0]} --eigs 4 --layout bell float32 {' '.join(extra)}: "
              f"{float(ms):.3f} ms, {rec['iterations']} iterations, eigenvalues "
              f"{[round(v, 6) for v in vals]} (lambda_min of the 7-point Poisson {lam_min:.6f}), "
              f"max relative residual {float(rel):.3e}, converged {rec['converged']}  [{card}]")


def scipy_drop_in(dev, card) -> None:
    """scipy_compat on poisson2d_110 as a scipy matrix, held against
    scipy.sparse.linalg on the host: cg, minres, bicgstab and gmres (info
    codes, ||b - Ax|| / ||b||), lobpcg (k = 4: each value within its
    residual of scipy's shift-invert eigsh) and eigsh(k = 4, which="SM");
    eigsh on the identity (a triple eigenvalue, k = 3)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from conjugategradient_tpu_torch import read_mtx_csr, scipy_compat

    data, indices, indptr, shape = read_mtx_csr(os.path.join(ROOT, SCIPY_FILE))
    A = sp.csr_matrix((data, indices, indptr), shape=shape)
    n = A.shape[0]
    b = np.arange(1, n + 1, dtype=np.float64) / n
    for name in ("cg", "minres", "bicgstab", "gmres"):
        kw = {"restart": SCIPY_GMRES_RESTART} if name == "gmres" else {}
        t0 = time.perf_counter()
        x, info = getattr(scipy_compat, name)(A, b, rtol=SCIPY_RTOL, device=dev, **kw)
        ms = (time.perf_counter() - t0) * 1e3
        xs, infos = getattr(spla, name)(A, b, rtol=SCIPY_RTOL, **kw)
        rel = float(np.linalg.norm(b - A @ x.cpu().numpy()) / np.linalg.norm(b))
        rels = float(np.linalg.norm(b - A @ xs) / np.linalg.norm(b))
        check(info == infos == 0 and rel <= SCIPY_TRUE_FACTOR * SCIPY_RTOL and x.is_cuda,
              f"scipy_compat.{name}: info {info} (scipy {infos}), true residual {rel:.3e}")
        print(f"  scipy_compat.{name} {SCIPY_FILE} rtol {SCIPY_RTOL}: info {info} (scipy {infos}), "
              f"||b - Ax||/||b|| {rel:.3e} (scipy {rels:.3e}), {ms:.1f} ms  [{card}]")
    ref = np.sort(spla.eigsh(A, k=4, sigma=0, which="LM")[0])
    X = np.random.default_rng(0).standard_normal((n, 4))
    t0 = time.perf_counter()
    w, v = scipy_compat.lobpcg(A, X, largest=False, tol=1e-6, maxiter=300, device=dev)
    ms = (time.perf_counter() - t0) * 1e3
    r = np.linalg.norm(A @ v - v * w, axis=0) / np.linalg.norm(v, axis=0)
    check(np.all(np.abs(w - ref) <= r + 1e-12),
          f"scipy_compat.lobpcg: {w} against {ref}, residuals {r}")
    print(f"  scipy_compat.lobpcg {SCIPY_FILE} k=4: {w} against scipy's shift-invert eigsh {ref}, "
          f"residuals {r}, {ms:.1f} ms  [{card}]")
    t0 = time.perf_counter()
    w = scipy_compat.eigsh(A, k=4, which="SM", return_eigenvectors=False, device=dev)
    ms = (time.perf_counter() - t0) * 1e3
    err = float(np.max(np.abs(w - ref) / ref))
    check(err <= SCIPY_EIG_RTOL, f"scipy_compat.eigsh SM: {w} against {ref}")
    print(f"  scipy_compat.eigsh {SCIPY_FILE} k=4 which=SM: {w}, relative difference {err:.2e} "
          f"from scipy's shift-invert eigsh, {ms:.1f} ms  [{card}]")
    w, v = scipy_compat.eigsh(sp.identity(SCIPY_EYE_N, format="csr"), k=3, device=dev)
    check(np.allclose(w, 1.0, rtol=1e-12, atol=0) and np.allclose(v.T @ v, np.eye(3), atol=1e-8),
          f"scipy_compat.eigsh identity: {w}")
    print(f"  scipy_compat.eigsh identity({SCIPY_EYE_N}) k=3: {w}, orthonormal vectors  [{card}]")


def phase_deflation_path(dev, big, card):
    """Deflated CG, LOBPCG and the scipy drop-in: the eigs lane, deflation at
    scale, float64 parity with the CPU, the tester's --deflate and --eigs,
    and scipy_compat on scipy matrices."""
    eigs_lane(dev, big, card)
    deflation_at_scale(dev, card)
    deflation_parity(dev, card)
    deflation_tester(dev, card)
    scipy_drop_in(dev, card)


UPDATE_SHARDS = (4, 8)  # the sharded loop's P: kernels 2, 3 and 16 run at n / P


def digest(*tensors) -> str:
    """sha256 of the tensors' bytes, in order (16 hex digits); a bf16
    tensor's bytes through an int16 view (numpy has no bf16)."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def update_operands(n, seed, dev, ties=False):
    """Seeded x, p, r, q (standard normal) and d (in [0.5, 1.5)) of n
    float32 entries, and alpha = 0.61.  ``ties``: x, p, r, q small
    integers times 2^-75 and alpha = 0.5, so r' is exact and many of its
    squares are ties below FLT_MIN, where a rounded square and an FMA
    part."""
    import torch

    rng = np.random.default_rng(seed)
    if ties:
        vecs = [torch.as_tensor(rng.integers(-15, 16, n) * 2.0 ** -75, dtype=torch.float32,
                                device=dev) for _ in range(4)]
    else:
        vecs = [torch.as_tensor(rng.standard_normal(n), dtype=torch.float32, device=dev)
                for _ in range(4)]
    vecs.append(torch.as_tensor(0.5 + rng.random(n), dtype=torch.float32, device=dev))
    return (*vecs, torch.full((1, 1), 0.5 if ties else 0.61, dtype=torch.float32, device=dev))


def minres_update_work(dev, maxiter=9, tol=1e-3):
    """A MINRES solve's work part-way: every scalar kernel 16's step reads
    set to a value that is not 0."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    w = fm.MinresWork.new(dev, maxiter=maxiter, tol=tol, shift=0.07)
    w.scal[fm.M_OLDB], w.scal[fm.M_DBAR], w.scal[fm.M_EPSLN] = 1.7, 0.4, 0.2
    w.scal[fm.M_CS], w.scal[fm.M_SN], w.scal[fm.M_ALFA] = -0.8, 0.6, 2.2
    w.scal[fm.M_C1], w.scal[fm.M_IA] = 0.4, 0.9
    w.start(torch.tensor(2.3, device=dev))
    return w


def update_launches(dev, x, p, r, q, d, alpha):
    """(label, launch(work, partials_only, out) -> outputs, new work) for
    kernels 2, 3, 16 and 16 with d, on these operands (kernel 16 reads q,
    r and p as its q, r1 and r2)."""
    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    def fused_work():
        w = fc.FusedWork.new(dev, maxiter=9, tol=1e-3)
        w.scal[fc.S_RNORM], w.scal[fc.S_RHO] = 2.5, 1.5
        return w

    def k16(dd):
        return lambda w, po, out: fm.minres_update_dot(q, r, p, w.c1, w.ia, dd, out=out, work=w,
                                                       partials_only=po)

    return (
        ("fused_update_dot",
         lambda w, po, out: fc.fused_update_dot(x, p, r, q, alpha, out=out, work=w,
                                                partials_only=po), fused_work),
        ("fused_update_dot_pcg",
         lambda w, po, out: fc.fused_update_dot_pcg(x, p, r, q, d, alpha, out=out, work=w,
                                                    partials_only=po), fused_work),
        ("minres_update_dot", k16(None), lambda: minres_update_work(dev)),
        ("minres_update_dot+d", k16(d), lambda: minres_update_work(dev)),
    )


def update_hashes(dev, card) -> None:
    """A hash of each of kernels 2, 3 and 16 on seeded inputs: at n =
    262,144 with the scalar step (its outputs, then the work's scalars,
    control words and history after it), there again on inputs whose
    squares tie below FLT_MIN (update_operands), and at n / 8 in
    partials-only mode (its outputs); for comparing two trees on one
    card."""
    for n, partials, ties in ((N_BIG, False, False), (N_BIG, False, True),
                              (N_BIG // 8, True, False)):
        for label, launch, new_work in update_launches(dev, *update_operands(n, 5, dev, ties)):
            w = new_work()
            outs = launch(w, partials, None)
            h = digest(*outs, w.scal, w.ctl, w.hist) if not partials else digest(*outs)
            mode = "partials only" if partials else "with the scalar step"
            print(f"  per-call hash {label} n={n} {mode}{', ties' if ties else ''}: {h}  "
                  f"[{card}]")


def check_update_not_live(n, dev, label) -> None:
    """Kernels 2, 3 and 16 on a solve that is not live, with and without
    the scalar step: nothing changes (the inputs, the outputs' buffers, the
    partials, the counter, scal, ctl, hist)."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc

    ops = update_operands(n, 23, dev)
    for name, launch, new_work in update_launches(dev, *ops):
        for partials in (False, True):
            w = new_work()
            w.ctl[fc.C_LIVE] = 0
            w.partials.fill_(7.0)
            outs = [torch.full_like(ops[0], 3.0) for _ in range(1 if "minres" in name else 2)]
            bufs = (*ops, *outs, w.partials, w.counter, w.scal, w.ctl, w.hist)
            kept = [t.clone() for t in bufs]
            launch(w, partials, outs[0] if len(outs) == 1 else tuple(outs))
            torch.cuda.synchronize()
            check(all(same_bits(a, b) for a, b in zip(kept, bufs)),
                  f"{name} {label} partials_only={partials}: a launch that is not live wrote")
    print(f"  kernels 2, 3, 16 {label}: a launch that is not live writes nothing, "
          "with and without the scalar step")


def update_rows(dev, sharded_only=False) -> dict:
    """Kernels 2, 3 and 16 timed against their plain versions (time_pair),
    launched as their loops launch them (into their buffers, on a solve's
    work that never finishes): in partials-only mode at n / 4 and n / 8,
    which the sharded loop launches P times a step; unless
    ``sharded_only``, also with the scalar step at n = 262,144 (kernel 16
    with and without d), kernels 2 and 16 there without it, and kernel 2
    at 256^3 (the row of kernel 13).
    Each with the bound on the bytes of its vectors."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    work = fc.FusedWork.new(dev, maxiter=1 << 20, tol=-1.0)
    mwork = fm.MinresWork.new(dev, maxiter=1 << 20, tol=-1.0)
    mwork.start(torch.tensor(2.3, device=dev))
    cases = [(N_BIG // P, f"n/{P} partials", True, ("K2", "K3", "K16")) for P in UPDATE_SHARDS]
    if not sharded_only:  # and at n without the scalar step, to part bytes from the tail
        cases = [(N_BIG, "n=262144", False, ("K2", "K3", "K16", "K16+d")),
                 (N_BIG, "n=262144 partials", True, ("K2", "K16")),
                 (math.prod(STENCIL_GRID), "256^3", False, ("K2",))] + cases
    rows = {}
    for n, tag, partials, kernels in cases:
        x, p, r, q, d, alpha = update_operands(n, 31, dev)
        xo, ro = torch.empty_like(x), torch.empty_like(r)
        fns = {
            "K2": (lambda: fc.fused_update_dot(x, p, r, q, alpha, out=(xo, ro), work=work,
                                               partials_only=partials),
                   lambda: fc._update_plain("fused_update_dot", x, p, r, q, None, alpha, None,
                                            None), 6, 6),
            "K3": (lambda: fc.fused_update_dot_pcg(x, p, r, q, d, alpha, out=(xo, ro), work=work,
                                                   partials_only=partials),
                   lambda: fc._update_plain("fused_update_dot_pcg", x, p, r, q, d, alpha, None,
                                            None), 7, 9),
            "K16": (lambda: fm.minres_update_dot(q, r, p, mwork.c1, mwork.ia, out=ro, work=mwork,
                                                 partials_only=partials),
                    lambda: fm._update_plain(q, r, p, mwork.c1, mwork.ia, None, None, None), 4, 7),
            "K16+d": (lambda: fm.minres_update_dot(q, r, p, mwork.c1, mwork.ia, d, out=ro,
                                                   work=mwork, partials_only=partials),
                      lambda: fm._update_plain(q, r, p, mwork.c1, mwork.ia, d, None, None), 5, 9),
        }
        for k in kernels:
            kern, plain, streams, flops = fns[k]
            t = time_pair(kern, plain)
            # vectors in and out, 4 bytes an entry; no one call computes it
            t.update(bound(streams * n * 4, flops * n), library_ms=None)
            rows[f"{k} {tag}"] = t
    torch.cuda.synchronize()
    check(int(work.ctl[fc.C_LIVE]) == 1 and int(mwork.ctl[fc.C_LIVE]) == 1,
          "update timing: a timed solve stopped being live, so later launches were no-ops")
    return rows


def dia_operators(dev) -> dict:
    """poisson3d_48 as DIA (7 diagonals) and symdia-big in full storage (41),
    as phase 2 builds them."""
    from conjugategradient_tpu_torch import load_matrix

    p3d = load_matrix(os.path.join(ROOT, MATRICES[0]), layout="dia", dtype=np.float32, device=dev)
    big, _ = sym_dia_pair(SYMDIA_N, SYMDIA_OFFSETS, np.random.default_rng(0), dev)
    return {"poisson3d_48": p3d, "symdia-big": big}


def bicg_dia_hashes(dev, card) -> None:
    """Per-call hashes of kernels 20 and 7 on seeded inputs, for comparing
    two trees on one card: kernel 20 at n = 262,144 with the scalar step
    (its outputs, then the work's scalars, control words and history), on
    inputs whose squares tie below FLT_MIN (update_operands), and not live
    (every buffer it could write; also checked unchanged); y of kernel 7
    (the route each tree takes) on poisson3d_48 and symdia-big."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import dia_spmv as kd
    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb

    for ties in (False, True):
        xh, sh, s, t, rhat, w = update_operands(N_BIG, 5, dev, ties)
        work = bicg_work(dev)
        outs = fb.bicgstab_update_dot(xh, sh, s, t, rhat, w, work=work)
        print(f"  per-call hash bicgstab_update_dot n={N_BIG} with the scalar step"
              f"{', ties' if ties else ''}: {digest(*outs, work.scal, work.ctl, work.hist)}  "
              f"[{card}]")
    kept, bufs = bicg_update_not_live(N_BIG, dev)
    check(all(same_bits(a, b) for a, b in zip(kept, bufs)),
          "K20: a launch that is not live wrote")
    print(f"  per-call hash bicgstab_update_dot n={N_BIG} not live: {digest(*bufs)} "
          f"(unchanged)  [{card}]")
    for label, a in dia_operators(dev).items():
        x = torch.as_tensor(np.random.default_rng(7).standard_normal(a.shape[1]),
                            dtype=torch.float32, device=dev)
        y = kd.dia_spmv_diags(a.diags, a.offsets, a.offsets_dev, x)
        print(f"  per-call hash dia_spmv {label} ({a.ndiag} diagonals): {digest(y)}  [{card}]")


def bicg_dia_rows(dev) -> dict:
    """Kernel 20 at n = 262,144 on a work that stays live, launched as the
    solver launches it, and kernel 7 through ``dia_spmv_diags`` (the route
    each tree takes) on poisson3d_48 and symdia-big, timed against their
    plain versions (time_pair), with their bounds; cuSPARSE beside kernel 7."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import dia_spmv as kd
    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb

    rows = {}
    xh, sh, s, t, rhat, w = update_operands(N_BIG, 31, dev)
    work = fb.BicgstabWork.new(dev, maxiter=1 << 20, tol=-1.0)
    work.start(torch.tensor(2.3, device=dev))
    out = (torch.empty_like(xh), torch.empty_like(xh))
    r = time_pair(lambda: fb.bicgstab_update_dot(xh, sh, s, t, rhat, w, out=out, work=work),
                  lambda: fb._update_plain(xh, sh, s, t, rhat, w, None, None))
    torch.cuda.synchronize()
    check(int(work.ctl[fb.C_LIVE]) == 1, "K20 timing: the timing work stopped being live")
    r.update(bound(7 * N_BIG * 4, 8 * N_BIG), library_ms=None)
    rows["K20 n=262144"] = r
    for label, a in dia_operators(dev).items():
        x = torch.as_tensor(np.random.default_rng(7).standard_normal(a.shape[1]),
                            dtype=torch.float32, device=dev)
        r = time_pair(lambda: kd.dia_spmv_diags(a.diags, a.offsets, a.offsets_dev, x),
                      lambda: kd._dia_plain(a.diags, a.offsets, x))
        y = kd.dia_spmv_diags(a.diags, a.offsets, a.offsets_dev, x)
        lib = library_spmv(csr_from_dia(a), x, y, label)
        r.update(dia_bounds(a, None)[0], library_ms=lib)
        rows[f"K7 {label}"] = r
    return rows


def elementwise_floor(dev, card) -> None:
    """The floor of one elementwise launch at n = 262,144: the device time
    of torch.add(x, p, alpha=a, out=xo) over float32 (12 bytes an entry).
    Not a library time for kernels 2, 3 or 16: one axpy, no dot, no
    scalar step."""
    import torch

    x, p, _, _, _, _ = update_operands(N_BIG, 37, dev)
    xo = torch.empty_like(x)
    fn = lambda: torch.add(x, p, alpha=0.61, out=xo)
    dev_ms, ev_ms = device_ms(fn), cuda_ms(fn)
    b = bound(3 * N_BIG * 4, 2 * N_BIG)["bound_ms"]
    print(f"  time floor: torch.add n=262144 (one elementwise launch; no library time of "
          f"kernels 2, 3, 16) {fmt_ms(dev_ms)} device / {ev_ms:.5f} per call; bound "
          f"{b:.5f} (ms)  [{card}]")


def print_time_row(name, t, card) -> None:
    more = ""
    if "bound_ms" in t:
        more = f"; bound {t['bound_ms']:.5f} ({t['bound_by']}, {t['bound_ms'] / t['ms']:.3f} of it)"
    if "needed_ms" in t:
        more += (f"; needed-bytes bound {t['needed_ms']:.5f} "
                 f"({t['needed_ms'] / t['ms']:.4f} of it)")
    if "view_ms" in t:
        more += f"; the view's own bound {t['view_ms']:.5f}"
    if t.get("library_ms") is not None:
        lib = "conv3d" if name.startswith("stencil7") else "cuSPARSE"
        more += f"; {lib} {t['library_ms']:.5f}"
    print(f"  time {name:<28} kernel {fmt_ms(t['device_ms'])} device / "
          f"{t['event_ms']:.5f} per call; plain {fmt_ms(t['plain_device_ms'])} "
          f"device / {t['plain_event_ms']:.5f} per call{more} (ms)  [{card}]")


# ---- bfloat16 tiles: the bf16 forms of kernels 1, 4, 5, 7, 10, 14, 15, 17 ---

BF16_KERNELS = ("sym_fused_dir_spmv_dot_bf16", "fused_dir_spmv_dot_bf16", "bell_spmv_bf16",
                "dia_spmv_bf16", "dia_spmv_rows_bf16", "bell_spmv_packed_bf16",
                "fused_dir_spmv_dot_packed_bf16", "sym_fused_dir_spmv_dot_packed_bf16",
                "sym_dia_spmv_bf16", "sym_dia_spmv_tiled_bf16", "minres_dir_spmv_dot_bf16",
                "minres_dir_spmv_dot_packed_bf16", "sym_minres_dir_spmv_dot_bf16",
                "sym_minres_dir_spmv_dot_packed_bf16", "minres_shard_spmv_dot_bf16",
                "sym_dia_spmv_rows_bf16")
# the float32 form's time on the shape a bf16 form is timed on, where that
# is not the float32 form's own row: kernel 10 one thread a row on
# poisson3d_48 (the route there until the by-value kernel took it)
BF16_F32_ROW = {"sym_dia_spmv_bf16": "sym_dia_spmv poisson3d_48"}
# the tester's bf16 SymDIA runs on poisson3d_48 (the by-value kernel 10),
# and the JAX tester's on the CPU, recorded once: (inner)
# iterations, converged; the card's run is held to the same converged and
# iterations within 10% (bf16 vector arithmetic rounds at other places in
# XLA: tests/test_torch_bf16_kernels.py allows 15% on poisson2d_34)
JAX_SYMDIA_BF16_COUNTS = {"refine": (121, True), "bfloat16": (76, True)}
BF16_MINRES_STEPS = 256  # the fused bf16 MINRES lane: steps at tol = -1, beside float32
BF16_SYMDIA_STEPS = 64  # portable CG on symdia-big's bf16 operator, beside float32
BF16_SHARDS = 4
REFINE_KERNELS = BF16_KERNELS
REFINE_TOL_REL = 1e-6  # the cg-bf16 system's refined solve: tol = 1e-6 ||b||
REFINE_FILE_TOL_REL = 1e-4  # poisson3d_48 and elasticity3d_16: tol = 1e-4 ||b||, b = 1..n
# the JAX package's refined_cg_solve on the CPU at those tolerances (float32
# high, bfloat16 low), recorded once: (refinements, inner iterations,
# converged); the card's run is held to the same converged, refinements
# within 1 and inner iterations within 10% (tests/test_torch_refine.py's
# bounds).  elasticity3d_16's values are not exact in bf16 and
# eps_bf16 * kappa > 1 there: both packages stop on the contraction guard.
JAX_REFINE_COUNTS = {
    ("poisson3d_48", "auto"): (2, 121, True),
    ("poisson3d_48", "bell"): (2, 121, True),
    ("elasticity3d_16", "dia"): (1, 62, False),
}
REFINE_ITER_REL = 0.1


def bf16_check(name, label, launch, widened, plain, exact) -> float:
    """One bf16 form on one shape: ``launch()`` counts one launch of
    ``name``; every output is bit-equal to ``widened()`` (the float32 form
    on the widened operands); against ``plain()``: p_new bit for bit, y / q
    bit for bit where ``exact`` (the packed and DIA forms) else within TOL_Q
    of their largest entry, pap within TOL_DOT.  Returns the largest
    difference from the plain version."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc

    before = fc.LAUNCHES[name]
    k = launch()
    check(fc.LAUNCHES[name] == before + 1, f"{name} {label}: {fc.LAUNCHES[name] - before} launches")
    w, p = widened(), plain()
    torch.cuda.synchronize()
    k, w, p = ((t,) if isinstance(t, torch.Tensor) else tuple(t) for t in (k, w, p))
    check(all(torch.equal(a, b) for a, b in zip(k, w)),
          f"{name} {label}: not bit-equal to the float32 launch on the widened operands")
    err = 0.0
    for i, (a, b) in enumerate(zip(k, p)):
        e, m = rel_max_err(a, b)
        err = max(err, e)
        if len(k) == 3 and i == 2:
            check(e <= TOL_DOT * abs(float(b)), f"{name} {label}: pap {float(a)} vs {float(b)}")
        elif exact or (len(k) == 3 and i == 0):
            check(torch.equal(a, b), f"{name} {label}: output {i} not bit-equal to the plain version")
        else:
            check(e <= TOL_Q * m, f"{name} {label}: output {i} err {e} vs max {m}")
    same = all(torch.equal(a, b) for a, b in zip(k, p))
    print(f"  {name} {label:<34} = float32 launch on widened operands (bits); vs plain "
          f"|d|={err:.3g}{' (bit-equal)' if same else ''}")
    return err


def phase_bf16_kernels(dev, big, big_full, ops, dia_ops, errs, times):
    """The bf16 forms of kernels 1, 4, 5 and 7 at the shapes of their float32
    forms (the n = 262,144 block-tridiagonal tiles in both storages,
    poisson3d_48's sparse tiles through the packed view, symdia-big's 41
    diagonals and poisson3d_48's 7), each held to the float32 launch on the
    widened operands (bit for bit) and to its plain version, and timed
    beside the plain version and its bytes bound; no one PyTorch call takes
    a bf16 operator with float32 x to float32 y (library_ms null)."""
    import torch

    from conjugategradient_tpu_torch.convert import dia_from_arrays
    from conjugategradient_tpu_torch.ops.cuda import bell_spmv as kb
    from conjugategradient_tpu_torch.ops.cuda import dia_spmv as kd
    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.types.bell import PackedBell

    bf16, f32 = torch.bfloat16, torch.float32
    rng = np.random.default_rng(18)
    errs.update(dict.fromkeys(BF16_KERNELS, 0.0))
    full, sym = big_full.astype(bf16), big.astype(bf16)
    p3d_full, p3d = ops["p3d_full"].astype(bf16), ops["p3d"].astype(bf16)
    wide_full, wide_diag, wide_off = full.blocks.float(), sym.diag_blocks.float(), sym.off_blocks.float()
    nrb, v = N_BIG // 128, N_BIG * 4

    def vec(rows, cols=128):
        return torch.as_tensor(rng.standard_normal((rows, cols)), dtype=f32, device=dev)

    def widen(pk):
        return PackedBell(pk.vals.float(), pk.cols, pk.row_len, pk.chunk_off, pk.nnz, pk.ncols,
                          pk.symmetric)

    def keep(name, e):
        errs[name] = max(errs[name], e)

    r, pold, d = vec(nrb), vec(nrb), vec(nrb).abs() + 0.5
    beta = torch.tensor([[0.37]], dtype=f32, device=dev)
    for dd in (None, d):
        tag = "+d" if dd is not None else ""
        keep("fused_dir_spmv_dot_bf16", bf16_check(
            "fused_dir_spmv_dot_bf16", f"tridiag n=262144 full{tag}",
            lambda: fc.fused_dir_spmv_dot(full.blocks, full.block_cols, r, pold, beta, dd),
            lambda: fc.fused_dir_spmv_dot(wide_full, full.block_cols, r, pold, beta, dd),
            lambda: fc._full_dir_plain(full.blocks, full.block_cols, r, pold, beta, dd, None,
                                       None), exact=False))
        for mirror in ("banded", "scatter"):
            keep("sym_fused_dir_spmv_dot_bf16", bf16_check(
                "sym_fused_dir_spmv_dot_bf16", f"tridiag n=262144 {mirror}{tag}",
                lambda: fc.sym_fused_dir_spmv_dot(sym.diag_blocks, sym.off_blocks, sym.off_cols,
                                                  r, pold, beta, dd, mirror=mirror,
                                                  mirror_src=sym.mirror_src),
                lambda: fc.sym_fused_dir_spmv_dot(wide_diag, wide_off, sym.off_cols, r, pold,
                                                  beta, dd, mirror=mirror,
                                                  mirror_src=sym.mirror_src),
                lambda: fc._sym_dir_plain(sym.diag_blocks, sym.off_blocks, sym.off_cols, r,
                                          pold, beta, dd, sym.mirror_src, None, None),
                exact=False))
    rp = vec(p3d.nrb)
    keep("sym_fused_dir_spmv_dot_bf16", bf16_check(
        "sym_fused_dir_spmv_dot_bf16", "poisson3d_48 general",
        lambda: fc.sym_fused_dir_spmv_dot(p3d.diag_blocks, p3d.off_blocks, p3d.off_cols, rp, rp,
                                          beta, mirror="scatter", mirror_src=p3d.mirror_src),
        lambda: fc.sym_fused_dir_spmv_dot(p3d.diag_blocks.float(), p3d.off_blocks.float(),
                                          p3d.off_cols, rp, rp, beta, mirror="scatter",
                                          mirror_src=p3d.mirror_src),
        lambda: fc._sym_dir_plain(p3d.diag_blocks, p3d.off_blocks, p3d.off_cols, rp, rp, beta,
                                  None, p3d.mirror_src, None, None), exact=False))
    x2d = vec(nrb)
    keep("bell_spmv_bf16", bf16_check(
        "bell_spmv_bf16", "tridiag n=262144 128x128",
        lambda: kb.bell_spmv_tiles(full.blocks, full.block_cols, x2d),
        lambda: kb.bell_spmv_tiles(wide_full, full.block_cols, x2d),
        lambda: kb._bell_plain(full.blocks, full.block_cols, x2d), exact=False))
    pk_full, pk_sym = p3d_full.packed(), p3d.packed()
    check(pk_full.vals.dtype == bf16 and pk_sym.vals.dtype == bf16,
          "poisson3d_48 bf16: the packed views are not bf16")
    xp = torch.as_tensor(rng.standard_normal(pk_full.ncols), dtype=f32, device=dev)
    for label, pk in (("poisson3d_48 full", pk_full), ("poisson3d_48 sym view", pk_sym)):
        keep("bell_spmv_packed_bf16", bf16_check(
            "bell_spmv_packed_bf16", label, lambda: kb.bell_spmv_packed(pk, xp),
            lambda: kb.bell_spmv_packed(widen(pk), xp), lambda: kb.packed_apply(pk, xp),
            exact=True))
    r3, p3, d3 = vec(p3d.nrb), vec(p3d.nrb), vec(p3d.nrb).abs() + 0.5
    for beta_v in (0.0, 0.37):
        b3 = torch.tensor([[beta_v]], dtype=f32, device=dev)
        for dd in (None, d3):
            tag = f"{'+d' if dd is not None else ''} beta={beta_v}"
            for name, pk in (("fused_dir_spmv_dot_packed_bf16", pk_full),
                             ("sym_fused_dir_spmv_dot_packed_bf16", pk_sym)):
                keep(name, bf16_check(
                    name, f"poisson3d_48{tag}",
                    lambda: fc.fused_dir_spmv_dot_packed(pk, r3, p3, b3, dd),
                    lambda: fc.fused_dir_spmv_dot_packed(widen(pk), r3, p3, b3, dd),
                    lambda: fc._packed_dir_plain(pk, r3, p3, b3, dd, None, None),
                    exact=True))
    dia_big, dia_p3d = dia_ops["big"].astype(bf16), dia_ops["p3d"].astype(bf16)
    rect = rng.standard_normal((4, 1001)).astype(np.float32)
    ragged = dia_from_arrays(rect, (-7, 0, 5, 299), (1001, 1300), rect.size,
                             device=dev).astype(bf16)
    xd = {}
    for label, a in (("symdia-big n=2097152", dia_big), ("poisson3d_48", dia_p3d),
                     ("ragged rect 1001x1300", ragged)):
        x = torch.as_tensor(rng.standard_normal(a.shape[1]), dtype=f32, device=dev)
        xd[label] = x
        name = f"{kd.dia_route(a.offsets)}_bf16"
        keep(name, bf16_check(
            name, label, lambda: kd.dia_spmv_diags(a.diags, a.offsets, a.offsets_dev, x),
            lambda: kd.dia_spmv_diags(a.diags.float(), a.offsets, a.offsets_dev, x),
            lambda: kd._dia_plain(a.diags, a.offsets, x), exact=True))

    # timing at the table's shapes; the fused kernels get their scratch and
    # outputs made once, as inside a solve
    work = fc.FusedWork.new(dev, maxiter=1 << 20, tol=-1.0)
    out = (torch.empty_like(r), torch.empty_like(r))
    out3 = (torch.empty_like(r3), torch.empty_like(r3))
    vb3 = p3d.nrb * 128 * 4
    stored = int(torch.count_nonzero(p3d.diag_blocks)) + int(torch.count_nonzero(p3d.off_blocks))
    rows = {
        "fused_dir_spmv_dot_bf16": (
            lambda: fc.fused_dir_spmv_dot(full.blocks, full.block_cols, r, pold, beta, out=out,
                                          work=work),
            lambda: fc._full_dir_plain(full.blocks, full.block_cols, r, pold, beta, None, None,
                                       None),
            bound(nbytes(full.blocks, full.block_cols) + 4 * v,
                  2 * full.blocks.numel() + 4 * N_BIG)),
        "sym_fused_dir_spmv_dot_bf16": (
            lambda: fc.sym_fused_dir_spmv_dot(sym.diag_blocks, sym.off_blocks, sym.off_cols, r,
                                              pold, beta, mirror="banded",
                                              mirror_src=sym.mirror_src, out=out, work=work),
            lambda: fc._sym_dir_plain(sym.diag_blocks, sym.off_blocks, sym.off_cols, r, pold,
                                      beta, None, sym.mirror_src, None, None),
            bound(nbytes(sym.diag_blocks, sym.off_blocks, sym.off_cols) + 4 * v,
                  2 * sym.diag_blocks.numel() + 4 * sym.off_blocks.numel() + 4 * N_BIG)),
        "bell_spmv_bf16": (
            lambda: kb.bell_spmv_tiles(full.blocks, full.block_cols, x2d),
            lambda: kb._bell_plain(full.blocks, full.block_cols, x2d),
            bound(nbytes(full.blocks, full.block_cols) + 2 * v, 2 * full.blocks.numel())),
        "bell_spmv_packed_bf16": (
            lambda: kb.bell_spmv_packed(pk_full, xp), lambda: kb.packed_apply(pk_full, xp),
            bound(6 * pk_full.nnz + 4 * (pk_full.ncols + p3d_full.n), 2 * pk_full.nnz)),
        "fused_dir_spmv_dot_packed_bf16": (
            lambda: fc.fused_dir_spmv_dot_packed(pk_full, r3, p3, beta, out=out3, work=work),
            lambda: fc._packed_dir_plain(pk_full, r3, p3, beta, None, None, None),
            bound(6 * pk_full.nnz + 4 * vb3, 2 * pk_full.nnz + 4 * p3d_full.n)),
        "sym_fused_dir_spmv_dot_packed_bf16": (
            lambda: fc.fused_dir_spmv_dot_packed(pk_sym, r3, p3, beta, out=out3, work=work),
            lambda: fc._packed_dir_plain(pk_sym, r3, p3, beta, None, None, None),
            bound(6 * stored + 4 * vb3, 2 * pk_sym.nnz + 4 * p3d.n)),
    }
    for label, a in (("symdia-big n=2097152", dia_big), ("poisson3d_48", dia_p3d)):
        x = xd[label]
        rows[f"{kd.dia_route(a.offsets)}_bf16"] = (
            lambda a=a, x=x: kd.dia_spmv_diags(a.diags, a.offsets, a.offsets_dev, x),
            lambda a=a, x=x: kd._dia_plain(a.diags, a.offsets, x), dia_bounds(a, None)[0])
    for name, (kern, plain, bnd) in rows.items():
        times[name] = time_pair(kern, plain)
        times[name].update(bnd, library_ms=None)
    torch.cuda.synchronize()


def check_minres_bf16(lo, rng, mirror, with_d, shift, errs, label, first=False,
                      packed=False):
    """Kernel 14 or 15 (or their packed form) on the bf16 operator ``lo``:
    held to its plain version as the float32 form is (check_minres_dir),
    and every output bit-equal to the float32 launch on the widened tiles.
    Returns the operands."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc

    vecs, su, d = check_minres_dir(lo, rng, mirror, with_d, shift, errs, label, first=first,
                                   packed=packed)
    name, kern, _ = minres_dir_pair(lo, mirror, packed=packed)
    _, kern32, _ = minres_dir_pair(lo.astype(torch.float32), mirror, packed=packed)
    before = fc.LAUNCHES[name]
    k = kern(vecs, su, d)
    check(fc.LAUNCHES[name] == before + 1, f"{name} {label}: not one launch of its bf16 form")
    w = kern32(vecs, su, d)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(k, w)),
          f"{name} {label}: not bit-equal to the float32 launch on the widened tiles")
    print(f"  {name} {label:<34} = float32 launch on widened tiles (bits)")
    return vecs, su, d


def phase_bf16_minres_dia_kernels(dev, big, big_full, ops, dia_ops, shard_ops, errs, times,
                                  extra):
    """The bf16 forms of kernels 10, 14, 15 and 17 at the shapes of their
    float32 forms: kernel 10 on symdia-big's 21 stored diagonals (the tiled
    kernel), poisson3d_48's 4 (by value), a ragged n = 1001, and
    dense_256's 256 and elasticity3d_16's 50 (one thread a row), each
    kernel that takes the shape on each; kernels 14 and 15 on the n = 262,144
    block-tridiagonal tiles (dense; banded and general landings), with and
    without d, shifted, a first step, and their packed form on
    poisson3d_48's views in both storages; kernel 17 on the n = 262,144
    operator split in 4 and 8.  Each held to the float32 launch on the
    widened operands (bit for bit) and to its plain version, and timed
    beside the plain version and its bytes bound (library_ms null: no one
    PyTorch call takes a bf16 operator with float32 vectors); then every
    bf16 form's time beside its float32 form's on the same shape."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import dia_spmv as kd
    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    bf16, f32 = torch.bfloat16, torch.float32
    rng = np.random.default_rng(19)

    def vec(shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=f32, device=dev)

    # kernel 10: each kernel that takes the shape (the tiled one wherever
    # its geometry exists, by value up to 32 stored offsets), and the routed
    # call; dense_256 and elasticity3d_16 are the wide bands (256 and 50
    # stored offsets) that the route gives one thread a row
    _, ragged = sym_dia_pair(1001, (0, 3, 300), rng, dev, scale=0.3)
    sym_x = {}
    wide = np.random.default_rng(256)  # x of the wide bands, leaving rng's draws as they were
    for label, s, xr in (("symdia-big n=2097152", dia_ops["big_sym"], rng),
                         ("poisson3d_48", dia_ops["p3d_sym"], rng),
                         ("ragged n=1001 0,3,300", ragged, rng),
                         ("dense_256", dia_ops["dense_sym"], wide),
                         ("elasticity3d_16", dia_ops["ela_sym"], wide)):
        lo = s.astype(bf16)
        x = torch.as_tensor(xr.standard_normal(lo.n), dtype=f32, device=dev)
        sym_x[label] = (lo, x)
        tiling = kd.sym_dia_tiling(lo.offsets, lo.n)
        check(tiling is not None and tiling == kd.sym_dia_tiling(s.offsets, s.n),
              f"{label}: no bf16 tiling, or not float32's")
        for r in ("sym_dia_spmv_tiled", "sym_dia_spmv_rows", "sym_dia_spmv"):
            if r == "sym_dia_spmv_rows" and lo.ndiag > kd.MAX_PARAM_DIAGS:
                continue
            name = r + "_bf16"
            errs[name] = max(errs[name], bf16_check(
                name, label, lambda: kd.sym_dia_cuda(lo.diags, lo.offsets, lo.offsets_dev, x, r),
                lambda: kd.sym_dia_cuda(lo.diags.float(), lo.offsets, lo.offsets_dev, x, r),
                lambda: kd._sym_dia_plain(lo.diags, lo.offsets, x), exact=True))
        route = kd.sym_dia_route(lo.offsets, lo.n, bf16) + "_bf16"
        before = fc.LAUNCHES[route]
        y = kd.sym_dia_spmv_diags(lo.diags, lo.offsets, lo.offsets_dev, x)
        torch.cuda.synchronize()
        check(fc.LAUNCHES[route] == before + 1
              and torch.equal(y, kd._sym_dia_plain(lo.diags, lo.offsets, x)),
              f"{label}: the routed bf16 call did not take {route} or differs")
        print(f"  sym_dia_spmv_diags {label} bf16: the route takes {route} (float32: "
              f"{kd.sym_dia_route(s.offsets, s.n)})")

    # kernels 14 and 15, dense tiles, then the packed form
    full, sym = big_full.astype(bf16), big.astype(bf16)
    p3f, p3d = ops["p3d_full"].astype(bf16), ops["p3d"].astype(bf16)
    args = {}
    for with_d in (False, True):
        tag = f"{'+d' if with_d else ''} shift=0.07"
        args["full", with_d] = check_minres_bf16(full, rng, None, with_d, 0.07, errs,
                                                 f"tridiag n=262144 full{tag}")
        args["sym", with_d] = check_minres_bf16(sym, rng, "banded", with_d, 0.07, errs,
                                                f"tridiag n=262144 banded{tag}")
        check_minres_bf16(sym, rng, "scatter", with_d, 0.07, errs,
                          f"tridiag n=262144 general{tag}")
    check_minres_bf16(full, rng, None, True, 0.07, errs, "tridiag n=262144 full first step",
                      first=True)
    check_minres_bf16(sym, rng, "banded", True, 0.0, errs, "tridiag n=262144 banded first step",
                      first=True)
    for a, label in ((p3f, "poisson3d_48 full"), (p3d, "poisson3d_48 sym")):
        for with_d in (False, True):
            args[label, with_d] = check_minres_bf16(
                a, rng, None, with_d, 0.07, errs, f"{label}{'+d' if with_d else ''} shift=0.07",
                packed=True)
        check_minres_bf16(a, rng, None, True, 0.0, errs, f"{label}+d first step", first=True,
                          packed=True)

    # kernel 17 on bf16 shards, P = 4 and 8
    blocks4, cols4 = shard_ops
    lo4 = blocks4.to(bf16)
    lo8, cols8 = lo4.view(8, -1, 3, 128, 128), cols4.view(8, -1, 3)
    full_v = vec((N_BIG // 128, 128))
    for n_shards, bl, cl in ((4, lo4, cols4), (8, lo8, cols8)):
        m = N_BIG // n_shards
        for s_ in (0, n_shards - 1):
            label = f"tridiag n=262144 P={n_shards} shard {s_} bf16"
            vecs, su = check_k17(bl[s_], cl[s_], full_v, s_ * m, rng, errs, label)
            before = fc.LAUNCHES["minres_shard_spmv_dot_bf16"]
            k = fm.minres_shard_spmv_dot(bl[s_], cl[s_], full_v, *vecs, su, s_ * m)
            w = fm.minres_shard_spmv_dot(bl[s_].float(), cl[s_], full_v, *vecs, su, s_ * m)
            torch.cuda.synchronize()
            check(fc.LAUNCHES["minres_shard_spmv_dot_bf16"] == before + 1
                  and all(torch.equal(a, b) for a, b in zip(k, w)),
                  f"K17 {label}: not one bf16 launch bit-equal to the float32 launch on the "
                  "widened tiles")
            print(f"  K17 {label:<39} = float32 launch on widened tiles (bits)")

    # timing at the table's shapes, launched as the solver and the loop
    # launch them: in place, on a work that never finishes
    for label, name in (("symdia-big n=2097152", "sym_dia_spmv_tiled_bf16"),
                        ("poisson3d_48", "sym_dia_spmv_bf16"),
                        ("poisson3d_48", "sym_dia_spmv_rows_bf16")):
        lo, x = sym_x[label]
        times[name] = time_pair(
            lambda: kd.sym_dia_cuda(lo.diags, lo.offsets, lo.offsets_dev, x, name[:-5]),
            lambda: kd._sym_dia_plain(lo.diags, lo.offsets, x))
        times[name].update(bound(nbytes(lo.diags, lo.offsets_dev) + 2 * lo.n * 4,
                                 2 * (2 * lo.ndiag - 1) * lo.n), library_ms=None)
    work = fm.MinresWork.new(dev, maxiter=1 << 20, tol=-1.0)
    work.start(torch.tensor(2.3, device=dev))
    stored = int(torch.count_nonzero(p3d.diag_blocks)) + int(torch.count_nonzero(p3d.off_blocks))
    for name, a, mirror, key, packed in (
        ("minres_dir_spmv_dot_bf16", full, None, ("full", False), False),
        ("sym_minres_dir_spmv_dot_bf16", sym, "banded", ("sym", False), False),
        ("minres_dir_spmv_dot_packed_bf16", p3f, None, ("poisson3d_48 full", False), True),
        ("sym_minres_dir_spmv_dot_packed_bf16", p3d, None, ("poisson3d_48 sym", False), True),
    ):
        _, kern, plain = minres_dir_pair(a, mirror, packed=packed)
        vecs, su, _ = args[key]
        vecs = [t.clone() for t in vecs]
        out = (vecs[2], torch.empty_like(vecs[0]), vecs[4], vecs[5])
        su0 = su.clone()
        su0[0, fm.SU_PHI] = 0.0  # x stays put over the timed launches
        t = time_pair(lambda: kern(vecs, su0, None, out=out, work=work),
                      lambda: plain(vecs, su0, None))
        vb = 10 * a.nrb * a.bn * 4  # r2 r1 v_prev w-1 w-2 x in; v q w x' out
        if packed:
            nnz = stored if a.packed().symmetric else a.packed().nnz
            t.update(bound(6 * nnz + vb, 2 * a.packed().nnz + 14 * a.nrb * a.bn),
                     library_ms=None)
        else:
            tiles = nbytes(a.blocks, a.block_cols) if mirror is None else \
                nbytes(a.diag_blocks, a.off_blocks, a.off_cols)
            flops = 2 * a.blocks.numel() if mirror is None else \
                2 * a.diag_blocks.numel() + 4 * a.off_blocks.numel()
            t.update(bound(tiles + vb, flops + 14 * a.nrb * a.bn), library_ms=None)
        times[name] = t
    sharded_table_rows(shard_ops, bf16, times, extra, ("K17",))
    # every bf16 form beside its float32 form on the same shape
    ratio = []
    for name in BF16_KERNELS:
        ref = BF16_F32_ROW.get(name, name[:-5])
        t32 = times.get(ref, extra.get(ref))
        if name in times and t32 is not None:
            ratio.append(f"{name} {times[name]['ms']:.5f} / {t32['ms']:.5f}")
    print("  bf16 forms against their float32 forms on the same shapes (ms, device): "
          + ", ".join(ratio))
    torch.cuda.synchronize()


def true_rel64(a64, b, x) -> float:
    """||b - A x|| / ||b|| in float64 (``a64`` the float64 operator on the
    card)."""
    r = b.double() - a64.matvec(x.double())
    return float(r.norm() / b.double().norm())


def phase_refine_path(dev, big, big_full, dia_ops, shard_ops, card):
    """The refine / bf16 path: bench.py's cg-bf16 lane (fused CG on the
    n = 262,144 block-tridiagonal tiles in bf16, float32 vectors, 256 steps
    at tol = -1, best of 3, beside the float32 run, in both storages); the
    refined solve of the same system (float32 high, bf16 low) against fused
    float32 CG to the same tolerance; refined solves on poisson3d_48 as
    --layout auto loads it (DIA, kernel 7 by value) and as 128 x 128
    blocked-ELL (the packed bf16 forms) and on elasticity3d_16 as DIA
    (kernel 7 past 32 diagonals) against the JAX package's counts; the
    portable CG loop on the bf16 tiles (kernel 5's dense bf16 form); the
    tester's --refine bfloat16 and --dtype bfloat16; then the bf16 forms of
    kernels 10, 14, 15 and 17 on their paths (bf16_minres_dia_path)."""
    import torch

    from conjugategradient_tpu_torch import (cg_solve, fused_bell_cg_solve, load_matrix,
                                             minres_solve, refined_cg_solve)
    from conjugategradient_tpu_torch.utils import Timer

    bf16, f32 = torch.bfloat16, torch.float32
    n = N_BIG
    b = torch.arange(1, n + 1, dtype=f32, device=dev)
    eff = big_full.tile_bytes() + 10 * n * 4  # the float32 full layout's 413.1 MB/it

    def best(solve, a, rhs, steps=256):
        solve(a, rhs, tol=-1.0, maxiter=32)
        ms = float("inf")
        for _ in range(3):
            t = Timer(dev).start_measure()
            _, info = solve(a, rhs, tol=-1.0, maxiter=steps)
            t.stop_measure()
            ms = min(ms, t.get_duration() / int(info.iterations))
        return ms, info

    for storage, hi in (("full", big_full), ("symmetric", big)):
        lo = hi.astype(bf16)
        got = {}
        for label, a in (("float32", hi), ("bf16", lo)):
            ms, info = best(fused_bell_cg_solve, a, b)
            check(int(info.iterations) == 256 and bool(torch.isfinite(info.rho_history[:257]).all()),
                  f"cg-bf16 {storage} {label}: {int(info.iterations)} steps or a non-finite history")
            got[label] = ms
            print(f"  cg-bf16 lane, {storage} storage, {label} tiles ({a.tile_bytes() / 1e6:.1f} MB): "
                  f"{ms:.5f} ms/it, {eff / ms / 1e6:.1f} GB/s effective on 413.1 MB/it, "
                  f"rho_history sha256 {digest(info.rho_history)}  [{card}]")
        print(f"  cg-bf16 {storage}: bf16 / float32 time per step {got['bf16'] / got['float32']:.3f}")

    # the refined solve of the same system against fused float32 CG
    bm_ = b / n
    tol = REFINE_TOL_REL * float(bm_.double().norm())
    a64 = big_full.astype(torch.float64)

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, x, info

    ms_r, x_r, rinfo = timed(lambda: refined_cg_solve(big_full, bm_, tol=tol))
    ms_c, x_c, cinfo = timed(lambda: cg_solve(big_full, bm_, tol=tol))
    rel_r, rel_c = true_rel64(a64, bm_, x_r), true_rel64(a64, bm_, x_c)
    del a64
    check(rinfo.converged and rel_r <= 1.05 * REFINE_TOL_REL,
          f"refine on the cg-bf16 system: converged {rinfo.converged}, true rel {rel_r}")
    print(f"  refine cg-bf16 system (float32 high, bf16 low, tol 1e-6 ||b||): "
          f"{rinfo.refinements} refinements, {rinfo.inner_iterations} inner iterations, true "
          f"rel residual {rel_r:.3e}, {ms_r:.3f} ms to tolerance; fused float32 CG "
          f"{int(cinfo.iterations)} its, true rel {rel_c:.3e}, {ms_c:.3f} ms  [{card}]")

    # refined solves on the files, against the JAX package's counts
    for name, layout, kw in (("poisson3d_48", "auto", {}),
                             ("poisson3d_48", "bell", {"bm": 128, "bn": 128}),
                             ("elasticity3d_16", "dia", {})):
        path = os.path.join(ROOT, f"problems/{name}.mtx")
        a = load_matrix(path, layout=layout, dtype=np.float32, device=dev, **kw)
        a64 = load_matrix(path, layout="csr", dtype=np.float64, device=dev)
        bf = torch.arange(1, a.shape[0] + 1, dtype=f32, device=dev)
        tol_f = REFINE_FILE_TOL_REL * bnorm(a.shape[0])
        ms, x, info = timed(lambda: refined_cg_solve(a, bf, tol=tol_f))
        jr, ji, jc = JAX_REFINE_COUNTS[(name, layout)]
        rel = true_rel64(a64, bf, x)
        print(f"  refine {name} --layout {layout} ({type(a).__name__}, tol 1e-4 ||b||): "
              f"{info.refinements} refinements, {info.inner_iterations} inner iterations, "
              f"converged {info.converged}, true rel residual {rel:.3e}, {ms:.3f} ms; the JAX "
              f"package on the CPU: {jr}, {ji}, converged {jc}  [{card}]")
        check(info.converged == jc and abs(info.refinements - jr) <= 1
              and abs(info.inner_iterations - ji) <= REFINE_ITER_REL * ji,
              f"refine {name} {layout}: ({info.refinements}, {info.inner_iterations}, "
              f"{info.converged}) against the JAX package's ({jr}, {ji}, {jc})")
        check(not jc or rel <= 1.05 * REFINE_FILE_TOL_REL, f"refine {name} {layout}: true rel {rel}")

    # the portable loops on bf16 tiles: kernel 5's dense bf16 form under CG
    # (fused="never") and MINRES (fused="never")
    lo = big_full.astype(bf16)
    _, cinfo = cg_solve(lo, b, fused="never", tol=-1.0, maxiter=32)
    _, minfo = minres_solve(lo, bm_, tol=0.0, maxiter=32, fused="never")
    check(int(cinfo.iterations) == 32 and math.isfinite(float(cinfo.rnorm_sq))
          and math.isfinite(float(minfo.rnorm)),
          "portable CG / MINRES on bf16 tiles: not 32 finite steps")
    print(f"  portable CG (32 steps) and MINRES (rnorm {float(minfo.rnorm):.3e} after "
          f"{int(minfo.iterations)}) on the n=262144 bf16 tiles")

    # the tester: --refine bfloat16 (auto: DIA; bell and symbell: the packed
    # fused bf16 forms) and --dtype bfloat16 (the portable loop on bf16
    # vectors: kernel 7 and the packed kernel 5 in their bf16 forms)
    tol_t = REFINE_FILE_TOL_REL * bnorm(110592)
    for layout in ("auto", "bell", "symbell"):
        dim, nnz, ms, rel, summ, _ = run_tester(MATRICES[0], layout, "none", tol_t,
                                                extra=("--refine", "bfloat16"))
        check(summ["converged"] == [True] and rel < REL_ERROR_BOUND,
              f"tester --refine bfloat16 {layout}: {summ} rel_error {rel}")
        print(f"  tester {MATRICES[0]} --layout {layout} --dtype float32 --refine bfloat16: "
              f"{dim} {nnz} {ms:.3f} ms rel_error {rel:.3e}, {summ['iterations'][0]} inner "
              f"iterations  [{card}]")
    for layout in ("auto", "bell"):
        dim, nnz, ms, rel, summ, _ = run_tester(MATRICES[0], layout, "none", 1e-2 * bnorm(110592),
                                                dtype="bfloat16")
        check(math.isfinite(rel), f"tester --dtype bfloat16 {layout}: rel_error {rel}")
        print(f"  tester {MATRICES[0]} --layout {layout} --dtype bfloat16 (tol 1e-2 ||b||): "
              f"{dim} {nnz} {ms:.3f} ms rel_error {rel:.3e}, {summ['iterations'][0]} its, "
              f"converged {summ['converged'][0]}  [{card}]")
    bf16_minres_dia_path(dev, big, big_full, dia_ops, shard_ops, card)


def bf16_minres_dia_path(dev, big, big_full, dia_ops, shard_ops, card):
    """The paths that reach the bf16 forms of kernels 10, 14, 15 and 17:
    the portable CG on symdia-big's bf16 operator (the tiled kernel 10), 64
    steps at tol = -1 beside float32; the tester's --layout symdia in bf16
    and with --refine bfloat16 on poisson3d_48 (by value) against the JAX
    tester's counts, a bf16 CG on dense_256's 256 stored offsets (one
    thread a row), and --method minres --dtype bfloat16 on
    poisson2d_34 (the portable loop on bf16 vectors, as in the JAX
    package); the fused MINRES lane in bf16, 256 steps at tol = -1 in both
    storages beside float32 (kernels 14 and 15, dense, with 16); minres_solve
    on poisson3d_48's bf16 tiles in both storages (the packed route), and
    its sticky NaN flag on a NaN tile value; the sharded MINRES on bf16
    shards at P = 4 (kernel 17) against the single card's bf16 fused MINRES
    on the same operator."""
    import dataclasses

    import torch

    from conjugategradient_tpu_torch import cg_solve, fused_minres_solve, load_matrix, minres_solve
    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.parallel import make_row_mesh, sharded_cg_solve
    from conjugategradient_tpu_torch.utils import Timer

    bf16, f32 = torch.bfloat16, torch.float32

    def per_step(solve, a, rhs, steps, **kw):
        """ms per step of the best of 3 solves of ``steps`` steps at tol =
        -1 after a warm-up; the last solve's info."""
        solve(a, rhs, tol=-1.0, maxiter=8, **kw)
        ms = float("inf")
        for _ in range(3):
            t = Timer(dev).start_measure()
            _, info = solve(a, rhs, tol=-1.0, maxiter=steps, **kw)
            t.stop_measure()
            ms = min(ms, t.get_duration() / int(info.iterations))
        return ms, info

    # (a) the portable CG on symdia-big in bf16 (tiled kernel 10) and float32
    sb = dia_ops["big_sym"]
    bs = torch.arange(1, sb.n + 1, dtype=f32, device=dev) / sb.n
    got = {}
    for label, a in (("float32", sb), ("bf16", sb.astype(bf16))):
        before = fc.LAUNCHES["sym_dia_spmv_tiled_bf16"]
        ms, info = per_step(cg_solve, a, bs, BF16_SYMDIA_STEPS)
        check(int(info.iterations) == BF16_SYMDIA_STEPS
              and bool(torch.isfinite(info.rho_history[:BF16_SYMDIA_STEPS + 1]).all()),
              f"symdia-big CG {label}: {int(info.iterations)} steps or a non-finite history")
        check(label == "float32" or fc.LAUNCHES["sym_dia_spmv_tiled_bf16"] - before
              >= 3 * BF16_SYMDIA_STEPS, f"symdia-big CG bf16: the tiled bf16 kernel 10 did not run")
        got[label] = ms
        print(f"  portable CG symdia-big (SymDIA, {label} diagonals, {a.diags.numel() * a.diags.element_size() / 1e6:.1f} MB): "
              f"{ms:.5f} ms/it over {BF16_SYMDIA_STEPS} steps, rho_history sha256 "
              f"{digest(info.rho_history)}  [{card}]")
    print(f"  symdia-big CG: bf16 / float32 time per step {got['bf16'] / got['float32']:.3f}")

    # (b) the tester on poisson3d_48 as SymDIA in bf16 (kernel 10 by value)
    for key, tol, dtype, extra_args in (
            ("refine", REFINE_FILE_TOL_REL * bnorm(110592), "float32", ("--refine", "bfloat16")),
            ("bfloat16", 1e-2 * bnorm(110592), "bfloat16", ())):
        before = fc.LAUNCHES["sym_dia_spmv_rows_bf16"]
        dim, nnz, ms, rel, summ, _ = run_tester(MATRICES[0], "symdia", "none", tol,
                                                dtype=dtype, extra=extra_args)
        ji, jc = JAX_SYMDIA_BF16_COUNTS[key]
        its = summ["iterations"][0]
        check(fc.LAUNCHES["sym_dia_spmv_rows_bf16"] > before,
              f"tester symdia {key}: kernel 10's by-value bf16 form did not run")
        check(summ["converged"] == [jc] and abs(its - ji) <= REFINE_ITER_REL * ji
              and rel < (REL_ERROR_BOUND if key == "refine" else 5e-3),
              f"tester symdia {key}: {its} its converged {summ['converged']} rel_error {rel}, "
              f"the JAX tester {ji} its converged {jc}")
        print(f"  tester {MATRICES[0]} --layout symdia --dtype {dtype} {' '.join(extra_args)}: "
              f"{dim} {nnz} {ms:.3f} ms rel_error {rel:.3e}, {its} its (the JAX tester on the "
              f"CPU: {ji}, converged {jc})  [{card}]")
    # a bf16 SymDIA CG on dense_256 (256 stored offsets: one thread a row)
    ds = load_matrix(os.path.join(ROOT, "problems/dense_256.mtx"), layout="symdia",
                     dtype=np.float32, device=dev).astype(bf16)
    bd = torch.arange(1, ds.n + 1, dtype=f32, device=dev)
    before = fc.LAUNCHES["sym_dia_spmv_bf16"]
    xd, info = cg_solve(ds, bd, tol=-1.0, maxiter=16)
    check(int(info.iterations) == 16 and fc.LAUNCHES["sym_dia_spmv_bf16"] - before >= 16,
          "CG dense_256 SymDIA bf16: kernel 10's one-thread-a-row bf16 form did not run")
    launched = fc.LAUNCHES["sym_dia_spmv_bf16"] - before
    # the same solve on the widened operator (float32 sym_dia_spmv, held to
    # the plain version in phase 1 on dense_256) gives the same bits
    xw, infow = cg_solve(ds.astype(f32), bd, tol=-1.0, maxiter=16)
    check(torch.equal(info.rho_history, infow.rho_history) and torch.equal(xd, xw),
          "CG dense_256 SymDIA bf16: the history or x differs from the float32 solve on the "
          "widened operator")
    print(f"  portable CG dense_256 (SymDIA, bf16, {ds.ndiag} stored), 16 steps: "
          f"{launched} sym_dia_spmv_bf16 launches, rho_history sha256 "
          f"{digest(info.rho_history)}, history and x bit-equal to the float32 solve on the "
          f"widened operator  [{card}]")
    dim, nnz, ms, rel, summ, _ = run_tester("problems/poisson2d_34.mtx", "bell", "none", 1.0,
                                            dtype="bfloat16", extra=("--method", "minres"))
    its = summ["iterations"][0]
    check(summ["converged"] == [True] and abs(its - 90) <= 0.15 * 90 and rel < 1e-2,
          f"tester --method minres --dtype bfloat16: {its} its rel_error {rel}")
    print(f"  tester problems/poisson2d_34.mtx --layout bell --method minres --dtype bfloat16 "
          f"(tol 1): {dim} {nnz} {ms:.3f} ms rel_error {rel:.3e}, {its} its (the JAX tester on "
          f"the CPU: 90 its, rel_error 5.9e-3)  [{card}]")

    # (c) the fused bf16 MINRES lane: kernels 14 and 15 (dense tiles) with 16
    bm = torch.arange(1, N_BIG + 1, dtype=f32, device=dev) / N_BIG
    for storage, hi in (("full", big_full), ("symmetric", big)):
        got = {}
        for label, a in (("float32", hi), ("bf16", hi.astype(bf16))):
            ms, info = per_step(fused_minres_solve, a, bm, BF16_MINRES_STEPS)
            check(int(info.iterations) == BF16_MINRES_STEPS
                  and bool(torch.isfinite(info.rnorm_history[:BF16_MINRES_STEPS + 1]).all()),
                  f"fused MINRES {storage} {label}: {int(info.iterations)} steps or a non-finite "
                  "history")
            got[label] = ms
            eff = a.tile_bytes() + 14 * N_BIG * 4
            print(f"  fused MINRES n=262144 {storage}, {label} tiles "
                  f"({a.tile_bytes() / 1e6:.1f} MB): {ms:.5f} ms/it, {eff / ms / 1e6:.1f} GB/s "
                  f"on tiles + 14 vectors, rnorm_history sha256 {digest(info.rnorm_history)}  "
                  f"[{card}]")
        print(f"  fused MINRES {storage}: bf16 / float32 time per step "
              f"{got['bf16'] / got['float32']:.3f}")

    # (d) minres_solve on poisson3d_48's bf16 tiles: the packed route
    p3f = load_bell(MATRICES[0], dev)
    p3d = load_symbell(MATRICES[0], dev)
    bp = torch.arange(1, p3d.n + 1, dtype=f32, device=dev) / p3d.n
    for label, a, name in (("full", p3f, "minres_dir_spmv_dot_packed_bf16"),
                           ("symmetric", p3d, "sym_minres_dir_spmv_dot_packed_bf16")):
        lo = a.astype(bf16)
        before = {k: fc.LAUNCHES[k] for k in (name, "minres_update_dot", "bell_spmv_bf16")}
        x, info = minres_solve(lo, bp, tol=1e-4 * float(bp.norm()))
        _, i32 = minres_solve(a, bp, tol=1e-4 * float(bp.norm()))
        k = int(info.iterations)
        check(bool(info.converged) and fc.LAUNCHES[name] - before[name] >= k
              and fc.LAUNCHES["minres_update_dot"] - before["minres_update_dot"] >= k
              and fc.LAUNCHES["bell_spmv_bf16"] == before["bell_spmv_bf16"]
              and abs(k - int(i32.iterations)) <= ITER_SLACK,
              f"minres_solve poisson3d_48 {label} bf16: {k} its (float32 {int(i32.iterations)}),"
              f" launches {fc.LAUNCHES[name] - before[name]}")
        print(f"  minres_solve poisson3d_48 {label} bf16 tiles (packed route): {k} its "
              f"(float32 tiles {int(i32.iterations)}), converged, rnorm_true "
              f"{float(info.rnorm_true):.3e}; {name} launched every step  [{card}]")
    lo = p3f.astype(bf16)
    bad = lo.blocks.clone()
    bad[0, 0, 0, 0] = float("nan")
    _, ninfo = minres_solve(dataclasses.replace(lo, blocks=bad), bp, tol=0.0, maxiter=8)
    check(not bool(ninfo.converged) and math.isnan(float(ninfo.rnorm))
          and int(ninfo.iterations) <= 1,
          f"fused bf16 MINRES with a NaN tile value: converged {bool(ninfo.converged)}, rnorm "
          f"{float(ninfo.rnorm)}, {int(ninfo.iterations)} its")
    print(f"  fused bf16 MINRES, a NaN tile value: stops after {int(ninfo.iterations)} step, "
          "not converged, rnorm NaN (the sticky NaN flag)")

    # (e) sharded MINRES on bf16 shards, P = 4 (kernel 17), against the single
    # card's bf16 fused MINRES on the cut operator (cut_tridiag_ops)
    blocks4, cols4 = shard_ops
    cut_full, cut_ops, _ = cut_tridiag_ops(blocks4, cols4, big_full.nnz)
    rhs = torch.as_tensor(np.random.default_rng(9).standard_normal(N_BIG), dtype=f32, device=dev)
    lo_blocks = cut_ops[BF16_SHARDS][0].to(bf16)
    before = fc.LAUNCHES["minres_shard_spmv_dot_bf16"]
    t = Timer(dev).start_measure()
    x, info = sharded_cg_solve(lo_blocks, cut_ops[BF16_SHARDS][1], rhs,
                               mesh=make_row_mesh(BF16_SHARDS, dev), tol=-1.0, maxiter=64,
                               method="minres")
    t.stop_measure()
    _, one = fused_minres_solve(cut_full.astype(bf16), rhs, tol=-1.0, maxiter=64)
    h = info.rho_history[:26].double().sqrt().cpu().numpy()
    h1 = one.rnorm_history[:26].double().cpu().numpy()
    keep = h1 > 1e-5 * h1[0]
    check(int(info.iterations) == 64
          and fc.LAUNCHES["minres_shard_spmv_dot_bf16"] - before >= 64 * BF16_SHARDS
          and np.allclose(h[keep], h1[keep], rtol=MINRES_TRAJ_RTOL, atol=0),
          f"sharded bf16 MINRES P={BF16_SHARDS}: {int(info.iterations)} its, phibar {h[:6]} vs "
          f"the single card's {h1[:6]}")
    print(f"  sharded MINRES bf16 shards P={BF16_SHARDS}: 64 its, {t.get_duration() / 64:.5f} "
          f"ms/it, phibar to {MINRES_TRAJ_RTOL} of the single card's bf16 fused MINRES over "
          f"{int(keep.sum())} steps above its floor  [{card}]")


# ---- bfloat16 operands: the bf16 forms of kernels 18, 19, 6 and 11 ----------

BF16_BICG_KERNELS = ("bicgstab_dir_spmv_dot_bf16", "bicgstab_s_spmv_dot_bf16",
                     "bicgstab_dir_spmv_dot_packed_bf16", "bicgstab_s_spmv_dot_packed_bf16",
                     "bell_spmv_dot_bf16", "stencil7_bf16", "stencil7_staged_bf16")
# the float32 form of each bf16 form timed on the same shape in phase 2
BF16_BICG_F32_ROW = {"bicgstab_dir_spmv_dot_bf16": "bicgstab_dir_spmv_dot",
                     "bicgstab_s_spmv_dot_bf16": "bicgstab_s_spmv_dot",
                     "bicgstab_dir_spmv_dot_packed_bf16": "bicgstab_dir_spmv_dot_packed",
                     "bicgstab_s_spmv_dot_packed_bf16": "bicgstab_s_spmv_dot_packed",
                     "bell_spmv_dot_bf16": "bell_spmv_dot", "K6 bf16 tridiag P=8": "K6 tridiag P=8",
                     "stencil7_bf16": "stencil7", "stencil7_staged_bf16": "stencil7_staged"}
BF16_BICG_STEPS = 256  # convdiff-512's fused BiCGStab in bf16: live steps at tol = 0
BF16_SHARD_STEPS = 64  # the sharded fused CG on bf16 shards, P = 4, beside float32
BF16_STENCIL_MAXITER = 4000  # the tester's bf16 stencil runs: a cap far above their counts
BF16_ULP = 2.0 ** -7  # bf16's spacing relative to a power of two (8 bits of mantissa)


def check_bicg_bf16(lo, wide, rng, with_d, beta_v, omega_v, alpha_v, errs, label,
                    packed=False, row_group=None, nan=False):
    """Kernels 18 and 19's bf16 forms on the bf16 operator ``lo``: held to
    their plain versions as the float32 forms are (check_bicg_tiles), then
    one launch of each bf16 form on those operands, every output bit-equal
    to the float32 launch on the widened operator ``wide``.  Returns
    check_bicg_tiles's operands."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc

    args = check_bicg_tiles(lo, rng, with_d, beta_v, omega_v, alpha_v, errs, label,
                            row_group=row_group, nan=nan, packed=packed)
    r, p, v, rhat, x, k1, beta, omega, alpha, d = args
    k18, _, k19, _ = bicg_forms(lo, packed, row_group)
    w18, _, w19, _ = bicg_forms(wide, packed, row_group)
    suffix = "_packed" if packed else ""
    names = (f"bicgstab_dir_spmv_dot{suffix}_bf16", f"bicgstab_s_spmv_dot{suffix}_bf16")
    before = [fc.LAUNCHES[nm] for nm in names]
    a1, b1 = k18(r, p, v, rhat, beta, omega, d), w18(r, p, v, rhat, beta, omega, d)
    a2, b2 = k19(r, a1[2], x, a1[1], alpha, d), w19(r, a1[2], x, a1[1], alpha, d)
    torch.cuda.synchronize()
    check([fc.LAUNCHES[nm] - b for nm, b in zip(names, before)] == [1, 1],
          f"K18/K19 bf16 {label}: not one launch of each bf16 form")
    check(all(same_bits(s_, t_) for s_, t_ in zip((*a1, *a2), (*b1, *b2))),
          f"K18/K19 bf16 {label}: not bit-equal to the float32 launch on the widened operator")
    print(f"  {names[0]}, {names[1]} {label}: = float32 launch on the widened operator (bits)")
    return args


def check_k6_bf16(lo, cols, full, off, errs, label):
    """Kernel 6's bf16 form: held to its plain version as the float32 form is
    (check_k6: q within TOL_Q, pap within TOL_DOT, repeats bit-identical),
    and bit-equal to the float32 launch on the widened shard."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc

    check_k6(lo, cols, full, off, errs, label)
    before = fc.LAUNCHES["bell_spmv_dot_bf16"]
    qb, pb = fc.bell_spmv_dot(lo, cols, full, off)
    q32, p32 = fc.bell_spmv_dot(lo.float(), cols, full, off)
    torch.cuda.synchronize()
    check(fc.LAUNCHES["bell_spmv_dot_bf16"] == before + 1 and torch.equal(qb, q32)
          and torch.equal(pb, p32),
          f"K6 bf16 {label}: not one bf16 launch bit-equal to the float32 launch on the widened "
          "tiles")
    print(f"  K6 bf16 {label:<36} = float32 launch on the widened tiles (bits)")


def check_stencil7_bf16(shape, dev, errs, rng):
    """Kernel 11's bf16 form on a bf16 volume: bit-equal to its plain version
    (each product and sum rounded to bf16 in both) with coefficients exact
    in bf16 and with the bf16-rounded 0.1 and -1/3; on integer-valued input,
    where no op rounds, bit-equal to the float32 launch on the widened
    volume; on random input its distance from that launch, in bf16 ulps of
    max|y|; a NaN reaching only its point and its six neighbours."""
    import torch

    from conjugategradient_tpu_torch import StencilOperator
    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.ops.cuda import stencil as ks

    bf16 = torch.bfloat16
    u = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev).to(bf16)
    inexact = StencilOperator(0.1, -1 / 3, shape, bf16, dev)
    ui = torch.as_tensor(rng.integers(-16, 17, shape), dtype=bf16, device=dev)
    at = tuple(n // 2 for n in shape)
    un = u.clone()
    un[at] = float("nan")
    want = nan_mask(shape, at, dev)
    for route, ctx in k11_routes(u):
        name = route + "_bf16"
        with ctx():
            before = fc.LAUNCHES[name]
            for c, w in ((6.0, -1.0), (inexact.center, inexact.off), (0.1, -1 / 3)):
                yk, yp = ks.stencil7(u, c, w), ks._stencil7_plain(u, c, w)
                torch.cuda.synchronize()
                check(yk.dtype == bf16 and torch.equal(yk.view(torch.int16), yp.view(torch.int16)),
                      f"{name} {shape} c={c} w={w}: not bit-equal to the plain version")
            check(fc.LAUNCHES[name] == before + 3, f"{name} {shape}: launches")
            check(torch.equal(ks.stencil7(ui, 6.0, -1.0),
                              ks.stencil7(ui.float(), 6.0, -1.0).to(bf16)),
                  f"{name} {shape}: integer input differs from the float32 launch")
            y32 = ks.stencil7(u.float(), 6.0, -1.0)
            yk = ks.stencil7(u, 6.0, -1.0)
            ulps = float((yk.float() - y32).abs().max()) / (BF16_ULP * float(y32.abs().max()))
            yk, yp = ks.stencil7(un, 6.0, -1.0), ks._stencil7_plain(un, 6.0, -1.0)
        check(torch.equal(torch.isnan(yk), want) and torch.equal(torch.isnan(yp), want)
              and torch.equal(yk.nan_to_num(), yp.nan_to_num()),
              f"{name} {shape}: a NaN reached other points than its neighbours")
        print(f"  {name:<20} {str(shape):<16} bit-equal to the plain version (c, w exact, "
              f"rounded to bf16 and float32 only); integer input = float32 launch (bits); random "
              f"input {ulps:.3g} bf16 ulps of max|y| from the float32 launch; NaN reaches "
              f"{int(want.sum())} points in both")
    return u


def phase_bf16_bicgstab_stencil_kernels(dev, bic_ops, shard_ops, errs, times, extra):
    """The bf16 forms of kernels 18 and 19 (dense on the bicgstab-bell
    operator and at a ragged nrb = 13 with bn = 32; packed on convdiff-512's
    bf16 view and on convdiff-37 at bn = 32), with and without the Jacobi d,
    on a first step (beta = omega = alpha = 0) and a later one, and with a
    NaN alpha and omega; kernel 6's on the n = 262,144 operator's bf16
    shards at P = 4 and 8; kernel 11's at 256^3 and on ragged volumes.
    Each held to its plain version and to the float32 launch on the widened
    operands, then timed beside its plain version and its bytes bound
    (library_ms null for kernels 18, 19 and 6: no one PyTorch call takes a
    bf16 operator with float32 vectors; cuDNN conv3d in bf16 for kernel 11),
    and beside its float32 form's time on the same shape."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb
    from conjugategradient_tpu_torch.ops.cuda import stencil as ks

    bf16 = torch.bfloat16
    rng = np.random.default_rng(20)
    bell = bic_ops["bench_bell"]
    lo_bell, lo_cd = bell.astype(bf16), bic_ops["convdiff"].astype(bf16)
    wide_bell, wide_cd = lo_bell.astype(torch.float32), lo_cd.astype(torch.float32)
    print(f"  bf16 bicgstab-bell tiles {lo_bell.tile_bytes() / 1e6:.1f} MB; bf16 convdiff-512 "
          f"view {lo_cd.packed().vals.numel() * 6 / 1e6:.2f} MB of values and columns")
    args = {}
    for with_d in (False, True):
        tag = "+d" if with_d else ""
        args["dense", with_d] = check_bicg_bf16(lo_bell, wide_bell, rng, with_d, 0.4, 0.25, 0.6,
                                                errs, f"n=262144 bf16{tag}")
        check_bicg_bf16(lo_bell, wide_bell, rng, with_d, 0.0, 0.0, 0.0, errs,
                        f"n=262144 bf16{tag} first step (beta=omega=alpha=0)")
        args["packed", with_d] = check_bicg_bf16(lo_cd, wide_cd, rng, with_d, 0.4, 0.25, 0.6,
                                                 errs, f"convdiff-512 bf16{tag}", packed=True)
        check_bicg_bf16(lo_cd, wide_cd, rng, with_d, 0.0, 0.0, 0.0, errs,
                        f"convdiff-512 bf16{tag} first step", packed=True)
    check_bicg_bf16(lo_bell, wide_bell, rng, False, 0.4, 0.25, 0.6, errs,
                    "n=262144 bf16 NaN alpha, omega", nan=True)
    check_bicg_bf16(lo_cd, wide_cd, rng, True, 0.4, 0.25, 0.6, errs,
                    "convdiff-512 bf16 NaN alpha, omega", packed=True, nan=True)
    small = nonsym_tridiag(13 * 32, 32, dev, seed=32).astype(bf16)
    ragged = convdiff_bell(37, dev, bn=32).astype(bf16)
    for with_d in (False, True):
        tag = "+d" if with_d else ""
        check_bicg_bf16(small, small.astype(torch.float32), rng, with_d, 0.4, 0.25, 0.6, errs,
                        f"ragged nrb=13 bn=32 bf16{tag}", row_group=3)
        check_bicg_bf16(ragged, ragged.astype(torch.float32), rng, with_d, 0.4, 0.25, 0.6, errs,
                        f"ragged convdiff-37 bn=32 bf16{tag}", packed=True)

    # kernel 6 on bf16 shards, P = 4 and 8
    blocks4, cols4 = shard_ops
    lo4 = blocks4.to(bf16)
    lo8, cols8 = lo4.view(8, -1, 3, 128, 128), cols4.view(8, -1, 3)
    full = torch.as_tensor(rng.standard_normal((N_BIG // 128, 128)), dtype=torch.float32,
                           device=dev)
    for n_shards, bl, cl in ((4, lo4, cols4), (8, lo8, cols8)):
        m = N_BIG // n_shards
        for s_ in (0, n_shards - 1):
            check_k6_bf16(bl[s_], cl[s_], full, s_ * m, errs,
                          f"tridiag n=262144 P={n_shards} shard {s_} bf16")

    # kernel 11 on bf16 volumes
    big_u = None
    for shape in (STENCIL_GRID,) + STENCIL_SMALL:
        u = check_stencil7_bf16(shape, dev, errs, rng)
        if shape == STENCIL_GRID:
            big_u = u

    # timing at the table's shapes, launched as the solver and the loops
    # launch them (in place, on works that never finish)
    work = fb.BicgstabWork.new(dev, maxiter=1 << 20, tol=-1.0)
    work.start(torch.tensor(2.3, device=dev))
    times["bicgstab_dir_spmv_dot_bf16"], times["bicgstab_s_spmv_dot_bf16"] = time_bicg_tiles(
        lo_bell, args["dense", False], work)
    times["bicgstab_dir_spmv_dot_packed_bf16"], times["bicgstab_s_spmv_dot_packed_bf16"] = \
        time_bicg_tiles(lo_cd, args["packed", False], work, packed=True)
    torch.cuda.synchronize()
    check(int(work.ctl[fb.C_LIVE]) == 1, "bf16 BiCGStab timing: the timing work stopped being live")
    sharded_table_rows(shard_ops, bf16, times, extra, ("K6",))
    n = int(np.prod(STENCIL_GRID))
    conv = conv3d_stencil(big_u, 6.0, -1.0)
    lib_ms = library_ms(conv)
    for route, ctx in k11_routes(big_u):
        with ctx():
            t = time_pair(lambda: ks.stencil7(big_u, 6.0, -1.0),
                          lambda: ks._stencil7_plain(big_u, 6.0, -1.0))
            e, m = rel_max_err(conv().float(), ks.stencil7(big_u, 6.0, -1.0).float())
        t.update(bound(2 * nbytes(big_u), 8 * n))  # bf16 in and out; the ops in float32
        check(e <= 4 * BF16_ULP * m, f"conv3d bf16 yardstick: differs from {route}_bf16 by {e} "
              f"(max {m})")
        t["library_ms"] = lib_ms
        times[f"{route}_bf16"] = t
        print(f"  conv3d in bf16 (the yardstick) within {e / (BF16_ULP * m):.3g} bf16 ulps of "
              f"max|y| of {route}_bf16")
    torch.cuda.synchronize()
    ratio = []
    for name, ref in BF16_BICG_F32_ROW.items():
        tb, t32 = times.get(name, extra.get(name)), times.get(ref, extra.get(ref))
        ratio.append(f"{name} {tb['ms']:.5f} / {t32['ms']:.5f} ({tb['ms'] / t32['ms']:.3f})")
    print("  bf16 forms of kernels 18, 19, 6, 11 against their float32 forms on the same shapes "
          "(ms, device): " + ", ".join(ratio))


def phase_bf16_bicgstab_stencil_path(dev, bic_ops, shard_ops, big_full, card):
    """The paths that reach the bf16 forms of kernels 18, 19, 6 and 11:
    ``bicgstab_solve(fused="always")`` on the bicgstab-bell operator's bf16
    tiles (the dense forms; at tol = -1 it ends at its breakdown exit after
    a few steps, as in float32, so its steps are timed on convdiff-512) and
    on convdiff-512's bf16 tiles (the packed forms: 256 live steps at tol =
    0, and forced onto the dense forms), each beside float32, and a NaN
    tile value (the sticky breakdown flag after one step);
    ``sharded_cg_solve(method="standard")`` on bf16 shards at P = 4, plain
    and Jacobi, against the single card's bf16 fused CG / PCG on the cut
    operator (``trajectory_ok``), timed beside float32, and a NaN tile
    value; the tester's ``stencil:256 --dtype bfloat16`` and ``stencil:64
    --dtype bfloat16 --method minres`` (the portable loops on bf16 vectors:
    kernel 11's bf16 form) beside their float32 runs."""
    import dataclasses

    import torch

    from conjugategradient_tpu_torch import (StencilOperator, bicgstab_solve, cg_solve,
                                             fused_bell_cg_solve, fused_bell_pcg_solve,
                                             fused_bicgstab_solve)
    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.parallel import make_row_mesh, sharded_cg_solve
    from conjugategradient_tpu_torch.utils import Timer

    bf16, f32 = torch.bfloat16, torch.float32

    def timed(fn):
        """(ms, result) of one call after a warm-up one."""
        fn()
        t = Timer(dev).start_measure()
        out = fn()
        t.stop_measure()
        return t.get_duration(), out

    # (a) bicgstab-bell: the dense bf16 forms of kernels 18 and 19 with 20
    bell = bic_ops["bench_bell"]
    b = torch.arange(1, bell.n + 1, dtype=f32, device=dev) / bell.n
    tol = TOL_SOLVE_REL * float(b.double().norm())
    for label, a in (("float32", bell), ("bf16", bell.astype(bf16))):
        before = {k: fc.LAUNCHES[k] for k in ("bicgstab_dir_spmv_dot_bf16",
                                              "bicgstab_s_spmv_dot_bf16")}
        ms, (x, info) = timed(lambda: bicgstab_solve(a, b, tol=tol, maxiter=64, fused="always"))
        k = int(info.iterations)
        check(bool(info.converged) and k <= BICG_BENCH_MAX_K,
              f"fused BiCGStab bicgstab-bell {label}: {k} its, converged {bool(info.converged)}")
        check(label == "float32" or all(fc.LAUNCHES[n_] - before[n_] >= 2 * k for n_ in before),
              f"fused BiCGStab bicgstab-bell bf16: the dense bf16 kernels 18 / 19 did not run")
        _, (x0, i0) = timed(lambda: bicgstab_solve(a, b, tol=-1.0, maxiter=BF16_BICG_STEPS,
                                                   fused="always"))
        print(f"  fused BiCGStab bicgstab-bell {label} tiles ({a.tile_bytes() / 1e6:.1f} MB), "
              f"tol 1e-5 ||b||: {k} its, {ms:.3f} ms to tolerance, rnorm_history and x sha256 "
              f"{digest(info.rnorm_history, x)}; tol = -1, maxiter {BF16_BICG_STEPS}: ends after "
              f"{int(i0.iterations)} its (breakdown {bool(i0.breakdown)}: the recurrence reaches "
              f"0)  [{card}]")
    # (b) convdiff-512: the packed bf16 forms (its route) and the dense ones
    # (forced), BF16_BICG_STEPS live steps at tol = 0, best of 3, beside float32
    cd = bic_ops["convdiff"]
    bc = torch.as_tensor(np.random.default_rng(0).standard_normal(cd.n), dtype=f32, device=dev)
    for route in ("packed", "dense"):
        got = {}
        name = "bicgstab_dir_spmv_dot" + ("_packed_bf16" if route == "packed" else "_bf16")
        for label, a in (("float32", cd), ("bf16", cd.astype(bf16))):
            before = fc.LAUNCHES[name]
            with forced_route(route == "packed"):
                fused_bicgstab_solve(a, bc, tol=0.0, maxiter=16)
                best = float("inf")
                for _ in range(3):
                    t = Timer(dev).start_measure()
                    x, info = fused_bicgstab_solve(a, bc, tol=0.0, maxiter=BF16_BICG_STEPS)
                    t.stop_measure()
                    best = min(best, t.get_duration() / int(info.iterations))
            check(int(info.iterations) == BF16_BICG_STEPS and math.isfinite(float(info.rnorm)),
                  f"fused BiCGStab convdiff-512 {route} {label}: {int(info.iterations)} steps")
            check(label == "float32" or fc.LAUNCHES[name] - before >= 3 * BF16_BICG_STEPS,
                  f"fused BiCGStab convdiff-512 {route} bf16: {name} did not run every step")
            got[label] = best
            print(f"  fused BiCGStab convdiff-512 {route} route, {label} tiles: {best:.5f} ms/it "
                  f"over {BF16_BICG_STEPS} steps (best of 3), rnorm_history sha256 "
                  f"{digest(info.rnorm_history)}  [{card}]")
        print(f"  fused BiCGStab convdiff-512 {route} route: bf16 / float32 time per step "
              f"{got['bf16'] / got['float32']:.3f}")
    for label, a in (("bicgstab-bell", bell.astype(bf16)), ("convdiff-512", cd.astype(bf16))):
        bad = a.blocks.clone()
        bad[0, 0, 0, 0] = float("nan")
        rhs = b if label == "bicgstab-bell" else bc
        _, ninfo = bicgstab_solve(dataclasses.replace(a, blocks=bad), rhs, tol=0.0, maxiter=8,
                                  fused="always")
        check(bool(ninfo.breakdown) and not bool(ninfo.converged) and int(ninfo.iterations) == 1,
              f"fused bf16 BiCGStab {label}, a NaN tile value: breakdown {bool(ninfo.breakdown)}, "
              f"{int(ninfo.iterations)} its")
        print(f"  fused bf16 BiCGStab {label}, a NaN tile value: stops after 1 step, breakdown "
              "(the sticky flag), not converged")

    # (c) sharded fused CG and Jacobi PCG on bf16 shards, P = 4 (kernel 6)
    blocks4, cols4 = shard_ops
    cut_full, cut_ops, cut_inv = cut_tridiag_ops(blocks4, cols4, big_full.nnz)
    rhs = torch.as_tensor(np.random.default_rng(9).standard_normal(N_BIG), dtype=f32, device=dev)
    lo_cut = cut_ops[4][0].to(bf16)
    mesh = make_row_mesh(4, dev)
    for jac in (None, cut_inv):
        what = f"sharded fused {'Jacobi PCG' if jac is not None else 'CG'} bf16 shards P=4"
        before = fc.LAUNCHES["bell_spmv_dot_bf16"]
        _, i25 = sharded_cg_solve(lo_cut, cut_ops[4][1], rhs, mesh=mesh, tol=-1.0, maxiter=25,
                                  inv_diag=jac)
        one = cut_full.astype(bf16)
        if jac is None:
            _, o25 = fused_bell_cg_solve(one, rhs, tol=-1.0, maxiter=25)
        else:
            _, o25 = fused_bell_pcg_solve(one, rhs, jac, tol=-1.0, maxiter=25)
        ok, used = trajectory_ok(i25.rho_history, o25.rho_history, 25)
        check(ok and used >= PARITY_MIN_USED
              and fc.LAUNCHES["bell_spmv_dot_bf16"] - before >= 4 * 25,
              f"{what} vs the single card's bf16 solve: rho_history beyond rtol {TRAJ_RTOL} or "
              f"only {used} entries above the float32 floor, or kernel 6's bf16 form did not run")
        print(f"  {what}: 25-step rho_history within {TRAJ_RTOL} of the single card's bf16 fused "
              f"solve on {used} entries above the float32 floor  [{card}]")
    got = {}
    b_ = torch.arange(1, N_BIG + 1, dtype=f32, device=dev)
    for label, bl in (("float32", blocks4), ("bf16", blocks4.to(bf16))):
        sharded_cg_solve(bl, cols4, b_, mesh=mesh, tol=-1.0, maxiter=8)
        best = float("inf")
        for _ in range(3):  # host-bound: the best of 3
            t = Timer(dev).start_measure()
            x, info = sharded_cg_solve(bl, cols4, b_, mesh=mesh, tol=-1.0,
                                       maxiter=BF16_SHARD_STEPS)
            t.stop_measure()
            best = min(best, t.get_duration() / BF16_SHARD_STEPS)
        check(int(info.iterations) == BF16_SHARD_STEPS,
              f"sharded fused CG {label} P=4: {int(info.iterations)} steps")
        got[label] = best
        print(f"  sharded fused CG n=262144 P=4, {label} shards: {best:.5f} ms/it over "
              f"{BF16_SHARD_STEPS} steps (best of 3), rho_history sha256 "
              f"{digest(info.rho_history)}  [{card}]")
    print(f"  sharded fused CG P=4: bf16 / float32 time per step {got['bf16'] / got['float32']:.3f}")
    bad = lo_cut.clone()
    bad[0, 0, 0, 0, 0] = float("nan")
    _, ninfo = sharded_cg_solve(bad, cut_ops[4][1], rhs, mesh=mesh, tol=-1.0, maxiter=8)
    check(not bool(ninfo.converged) and int(ninfo.iterations) <= 1
          and math.isnan(float(ninfo.rho_history[int(ninfo.iterations)])),
          f"sharded bf16 CG, a NaN tile value: {int(ninfo.iterations)} its")
    print(f"  sharded fused CG on bf16 shards, a NaN tile value: stops after "
          f"{int(ninfo.iterations)} step, NaN residual, not converged")

    # (d) the tester on bf16 stencils: the portable loops on bf16 vectors
    for grid, extra_args in ((256, ()), (64, ("--method", "minres"))):
        n_ = grid ** 3
        tol_t = TOL_SOLVE_REL * bnorm(n_)
        row = {}
        for dtype in ("float32", "bfloat16"):
            before = k11_launches(bf16=True)
            dim, nnz, ms, rel, summ, _ = run_tester(
                f"stencil:{grid}", "csr", "none", tol_t, dtype=dtype,
                extra=(*extra_args, "--maxiter", str(BF16_STENCIL_MAXITER)))
            its = summ["iterations"][0]
            check(summ["converged"] == [True] and math.isfinite(rel),
                  f"tester stencil:{grid} {dtype} {' '.join(extra_args)}: {its} its, converged "
                  f"{summ['converged']}, rel_error {rel}")
            check(dtype == "float32" or k11_launches(bf16=True) - before >= its,
                  f"tester stencil:{grid} bf16: kernel 11's bf16 form did not run")
            row[dtype] = ms / max(its, 1)
            print(f"  tester stencil:{grid} --dtype {dtype} {' '.join(extra_args)} (tol 1e-5 "
                  f"||b||): {dim} {nnz} {ms:.3f} ms, {its} its, {row[dtype]:.5f} ms/it, "
                  f"rel_error {rel:.3e}  [{card}]")
        print(f"  tester stencil:{grid} {' '.join(extra_args)}: bf16 / float32 time per "
              f"iteration {row['bfloat16'] / row['float32']:.3f}")
    # (e) the portable CG on a ragged bf16 grid: rows of 37 bf16 points are not
    # 16-byte multiples, so kernel 11's bf16 form takes its register march
    rop = StencilOperator.poisson((33, 35, 37), dtype=bf16, device=dev)
    rb = torch.arange(rop.shape[0], dtype=torch.float64, device=dev).to(bf16) + 1
    before = fc.LAUNCHES["stencil7_bf16"]
    _, ri = cg_solve(rop, rb, tol=-1.0, maxiter=32)
    check(int(ri.iterations) == 32 and fc.LAUNCHES["stencil7_bf16"] - before >= 32,
          f"portable CG bf16 (33, 35, 37): {int(ri.iterations)} its, "
          f"{fc.LAUNCHES['stencil7_bf16'] - before} register-march launches")
    print(f"  portable CG stencil (33, 35, 37) bf16, 32 steps: "
          f"{fc.LAUNCHES['stencil7_bf16'] - before} launches of kernel 11's bf16 register march")


# ---- kernels 1 and 15 on the banded landing: the staged tile ring ------------

BANDED_STAGES = (3, 4, 6, 8, 12)  # the ring-depth sweep at n = 262,144, bn = 128


def banded_ring(bn, dtype, stages=0) -> dict:
    """The tile ring of kernels 1 and 15 on the banded landing, as
    csrc/tile.cuh sizes it (TileChunk, ring_smem_bytes): chunks of whole
    tile rows, 16 KB or the whole tile if smaller; ``stages`` (0: the
    default, 96 KB of chunks); the dynamic shared memory of a CTA."""
    import torch

    row = bn * (2 if dtype == torch.bfloat16 else 4)
    rows = min(bn, 16 * 1024 // row)
    chunk = rows * row
    s = max(3, stages) if stages > 0 else 96 * 1024 // chunk
    return {"chunk_rows": rows, "chunk_bytes": chunk, "stages": s,
            "smem_bytes": (2 * s * 8 + 127) // 128 * 128 + s * chunk}


def banded_operators(dev, big) -> list:
    """(label, symmetric banded operator): the n = 262,144 tiles and a
    ragged nrb = 13, bn = 64 operator (13 rows in strips of 8), each in
    float32 and in bf16."""
    import torch

    small = block_tridiag_ops(13 * 64, 64, dev)[1]
    return [(f"{label} {tag}", a if dt == torch.float32 else a.astype(dt))
            for label, a in (("n=262144", big), ("ragged nrb=13 bn=64", small))
            for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))]


def banded_launches(a, dev, seed=21):
    """Kernels 1 and 15 on the banded landing of ``a`` on seeded inputs,
    launched as the solvers launch them (kernel 1 with d and beta = 0.37;
    kernel 15 in place, with d and the shift 0.07, after a pending
    update), each on a fresh work: (name, launch() -> the outputs and the
    work's scalars)."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    rng = np.random.default_rng(seed)
    nrb, bn = a.nrb, a.bn
    r, pold = (torch.as_tensor(rng.standard_normal((nrb, bn)), dtype=torch.float32, device=dev)
               for _ in range(2))
    d = torch.as_tensor(0.5 + rng.random((nrb, bn)), dtype=torch.float32, device=dev)
    beta = torch.full((1, 1), 0.37, device=dev)
    vecs, su, dm = minres_operands(nrb, bn, rng, dev, True, 0.07)

    def k1():
        work = fc.FusedWork.new(dev, maxiter=9, tol=1e-3)
        work.scal[fc.S_RHO] = 1.5
        out = fc.sym_fused_dir_spmv_dot(a.diag_blocks, a.off_blocks, a.off_cols, r, pold, beta,
                                        d, mirror="banded", mirror_src=a.mirror_src, work=work)
        return (*out, work.scal)

    def k15():
        work = fm.MinresWork.new(dev, maxiter=9, tol=1e-3, shift=0.07)
        work.start(torch.tensor(2.3, device=dev))
        v = [t.clone() for t in vecs]
        out = fm.sym_minres_dir_spmv_dot(a.diag_blocks, a.off_blocks, a.off_cols, *v, su, dm,
                                         mirror="banded", mirror_src=a.mirror_src,
                                         out=(v[2], torch.empty_like(v[0]), v[4], v[5]),
                                         work=work)
        return (*out, work.scal)

    return (("K1", k1), ("K15", k15))


def banded_hashes(dev, big, card) -> None:
    """One hash a call of kernels 1 and 15 on the banded landing (outputs
    and the work's scalars) on seeded inputs, float32 and bf16, at n =
    262,144 and ragged nrb = 13, bn = 64; for comparing two trees on one
    card."""
    for label, a in banded_operators(dev, big):
        for name, launch in banded_launches(a, dev):
            print(f"  per-call hash {name} banded {label}: {digest(*launch())}  [{card}]")


def banded_timers(a, dev) -> dict:
    """Kernels 1 and 15 on the banded landing of ``a`` (n = 262,144), each
    as a launch alone into buffers made once and on a solve's work that
    never finishes (as the solvers launch them; kernel 15 in place, with
    phi = 0 so x stays put), beside its plain version on the same inputs:
    name -> (kernel launch, plain launch)."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    work = fc.FusedWork.new(dev, maxiter=1 << 20, tol=-1.0)
    mwork = fm.MinresWork.new(dev, maxiter=1 << 20, tol=-1.0)
    mwork.start(torch.tensor(2.3, device=dev))
    rng = np.random.default_rng(3)
    r, pold = (torch.as_tensor(rng.standard_normal((a.nrb, a.bn)), dtype=torch.float32,
                               device=dev) for _ in range(2))
    beta = torch.full((1, 1), 0.37, device=dev)
    vecs, su, _ = minres_operands(a.nrb, a.bn, rng, dev, False, 0.07)
    su[0, fm.SU_PHI] = 0.0
    out = (torch.empty_like(r), torch.empty_like(r))
    mout = (vecs[2], torch.empty_like(vecs[0]), vecs[4], vecs[5])
    _, kern, plain = minres_dir_pair(a, "banded")
    return {
        "K1": (lambda: fc.sym_fused_dir_spmv_dot(a.diag_blocks, a.off_blocks, a.off_cols, r,
                                                 pold, beta, mirror="banded",
                                                 mirror_src=a.mirror_src, out=out, work=work),
               lambda: fc._sym_dir_plain(a.diag_blocks, a.off_blocks, a.off_cols, r, pold,
                                         beta, None, a.mirror_src, None, None)),
        "K15": (lambda: kern(vecs, su, None, out=mout, work=mwork),
                lambda: plain(vecs, su, None)),
    }


def banded_rows(dev, big) -> dict:
    """Kernels 1 and 15 on the banded landing at n = 262,144, float32 and
    bf16 tiles, timed against their plain versions (time_pair, launched as
    banded_timers makes them), with the bound on their bytes: the tiles
    read once, and the vectors (kernel 1: r, p_old in, p_new, q out;
    kernel 15: six in, four out)."""
    import torch

    rows = {}
    v = N_BIG * 4
    for tag, a in (("", big), (" bf16", big.astype(torch.bfloat16))):
        tiles = nbytes(a.diag_blocks, a.off_blocks, a.off_cols)
        flops = 2 * a.diag_blocks.numel() + 4 * a.off_blocks.numel()
        for name, (kern, plain) in banded_timers(a, dev).items():
            t = time_pair(kern, plain)
            t.update(bound(tiles + (4 if name == "K1" else 10) * v,
                           flops + (4 if name == "K1" else 14) * N_BIG), library_ms=None)
            rows[f"{name} banded n=262144{tag}"] = t
    torch.cuda.synchronize()
    return rows


def ptxas_report(card) -> None:
    """``nvcc -Xptxas -v`` on the ring-staged kernels' sources, as the build
    compiles them: registers, static shared memory and spills of each
    instantiation of kernels 1 and 15's banded landing and of the
    row-sharded kernels 6 and 17."""
    import re

    from conjugategradient_tpu_torch.ops.cuda import _build

    tmp = os.path.join(ROOT, "build", "ptxas")
    os.makedirs(tmp, exist_ok=True)
    procs = [(src, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
         os.path.join(tmp, src + ".o"), str(_build.SRC_DIR / src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for src in ("fused_cg.cu", "fused_minres.cu")]
    for src, proc in procs:
        out, err = proc.communicate(timeout=900)
        check(proc.returncode == 0, f"nvcc -Xptxas -v {src} failed: {err[-2000:]}")
        entry = None
        for line in (out + err).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = m.group(1)
                k = re.search(r"(sym_dir_banded_kernel|minres_banded_kernel|spmv_dot_kernel|"
                              r"minres_shard_kernel)ILi(\d+)E(\w+?)E", name)
                entry = None if k is None else (
                    f"{k.group(1)}<{k.group(2)}, {'bf16' if 'bfloat16' in k.group(3) else 'f32'}>")
                info = {}
                continue
            if entry is None:
                continue
            for key, pat in (("spill stores", r"(\d+) bytes spill stores"),
                             ("spill loads", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers"),
                             ("smem", r"(\d+) bytes smem")):
                m = re.search(pat, line)
                if m:
                    info[key] = int(m.group(1))
            if "registers" in info:
                print(f"  ptxas {entry}: {info['registers']} registers, {info.get('smem', 0)} B "
                      f"static smem, {info.get('spill stores', 0)} B spill stores, "
                      f"{info.get('spill loads', 0)} B spill loads  [{card}]")
                entry = None
    for src in ("fused_cg.cu", "fused_minres.cu"):
        sass_loads(os.path.join(tmp, src + ".o"), card)


def sass_loads(obj, card) -> None:
    """The global loads of kernels 6 and 17 at bn = 128 in the compiled
    object (``cuobjdump -sass``): how many LDG instructions each holds, and
    the most a warp issues in a row before its next FFMA (how many tile
    loads it keeps in flight where tiles are loaded into registers), and
    the bulk copies (UBLKCP) where they are staged."""
    import re

    from conjugategradient_tpu_torch.ops.cuda import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", obj], capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass {obj} failed: {out.stderr[-2000:]}")
    entry, counts = None, {}
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(r"(spmv_dot_kernel|minres_shard_kernel)ILi128E(\w+?)E", m.group(1))
            entry = None if k is None else \
                f"{k.group(1)}<128, {'bf16' if 'bfloat16' in k.group(2) else 'f32'}>"
            if entry:
                counts[entry] = {"LDG": 0, "run": 0, "most": 0, "UBLKCP": 0}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if entry is None or m is None:
            continue
        op, c = m.group(1), counts[entry]
        if op.startswith("LDG"):
            c["LDG"] += 1
            c["run"] += 1
            c["most"] = max(c["most"], c["run"])
        elif op.startswith("FFMA"):
            c["run"] = 0
        elif op.startswith("UBLKCP"):
            c["UBLKCP"] += 1
    for entry, c in counts.items():
        print(f"  sass {entry}: {c['LDG']} LDG, at most {c['most']} in a row before an FFMA, "
              f"{c['UBLKCP']} UBLKCP  [{card}]")


def banded_ring_report(dev, big, card) -> None:
    """The ring of kernels 1 and 15 on the banded landing: its geometry at
    each tile width and type, then the device time at n = 262,144 against
    the ring depth (CUDA-event ms a call, each depth's outputs hashed and
    held equal to the default's: the depth changes no bit).  Trees without
    the ring print nothing."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc

    if not hasattr(fc, "set_banded_ring_stages"):
        return
    for bn in (32, 64, 128, 256):
        for dt in (torch.float32, torch.bfloat16):
            g = banded_ring(bn, dt)
            print(f"  ring bn={bn} {str(dt)[6:]}: {g['chunk_rows']} tile rows a chunk "
                  f"({g['chunk_bytes']} B), {g['stages']} stages, {g['smem_bytes']} B dynamic "
                  f"smem a CTA")
    for tag, a in (("f32", big), ("bf16", big.astype(torch.bfloat16))):
        timers = banded_timers(a, dev)
        for name, fn in banded_launches(a, dev):
            ring_depth_row(f"{name} banded n=262144 {tag}", "a call", fn, timers[name][0], 1,
                           fc.set_banded_ring_stages, a.dtype, card)


def ring_depth_row(what, unit, fn, timer, per, set_stages, dtype, card) -> None:
    """One row of a ring-depth sweep: at each depth of BANDED_STAGES and at
    the default (set by ``set_stages``), ``fn()``'s outputs hashed and held
    equal to the default's (the depth changes no bit), and ``timer``'s
    device ms over ``per`` launches (CUDA-event ms where the profiler sees
    none)."""
    ref = digest(*fn())
    cells = []
    try:
        for stages in (*BANDED_STAGES, 0):
            set_stages(stages)
            check(digest(*fn()) == ref, f"{what}: {stages} ring stages changed the bits")
            ms = device_ms(timer)
            label = stages or f"default {banded_ring(128, dtype)['stages']}"
            cells.append(f"S={label} " + (f"{ms / per:.5f}" if ms is not None else
                                          f"{cuda_ms(timer) / per:.5f} (events)"))
    finally:
        set_stages(0)
    print(f"  ring depth {what} (device ms {unit}): {'; '.join(cells)}  [{card}]")


# ---- kernels 6 and 17: the row-sharded kernels on the staged tile ring ------

SHARDED_SHAPES = (4, 8)  # the n = 262,144 operator's shard counts of the sharded path


def sharded_operators(dev) -> list:
    """(label, tiles, columns, gathered operand, row offset, row_group) of
    kernels 6 and 17's per-call hashes: the n = 262,144 operator's P = 4
    shards 0 and 3 and P = 8 shard 0 (row_group None), and ragged nrb = 13
    shards at bn = 32 and 64 with row_group None and 3, each in float32
    and in bf16; the gathered operands seeded."""
    import torch

    rng = np.random.default_rng(22)
    blocks4, cols4 = sharded_ops(dev, 4)
    blocks8, cols8 = blocks4.view(8, -1, 3, 128, 128), cols4.view(8, -1, 3)
    m4 = N_BIG // 4
    full = torch.as_tensor(rng.standard_normal((N_BIG // 128, 128)), dtype=torch.float32,
                           device=dev)
    cases = [("n=262144 P=4 shard 0", blocks4[0], cols4[0], full, 0, None),
             ("n=262144 P=4 shard 3", blocks4[3], cols4[3], full, 3 * m4, None),
             ("n=262144 P=8 shard 0", blocks8[0], cols8[0], full, 0, None)]
    for bn in (32, 64):
        b13, c13, ncb, off = random_shard(rng, 13, bn, 3, 1, dev)
        f13 = torch.as_tensor(rng.standard_normal((ncb, bn)), dtype=torch.float32, device=dev)
        for rg in (None, 3):
            cases.append((f"ragged nrb=13 bn={bn} row_group={rg}", b13, c13, f13, off, rg))
    return [(f"{label} {tag}", bl if dt == torch.float32 else bl.to(dt), cl, f, off, rg)
            for label, bl, cl, f, off, rg in cases
            for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))]


def sharded_launches(blocks, cols, full, off, row_group, seed=22):
    """Kernels 6 and 17 on one shard, launched as the row-sharded loops
    launch them: kernel 6 into buffers on a live solve's work; kernel 17 in
    place (w over w-2, x' over x) after a pending update, with the shift
    0.07, on a live work; each on seeded vectors: (name, launch() -> the
    outputs)."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    dev = blocks.device
    rng = np.random.default_rng(seed)
    nrb, bn = blocks.shape[0], blocks.shape[3]
    vecs = [torch.as_tensor(rng.standard_normal((nrb, bn)), dtype=torch.float32, device=dev)
            for _ in range(5)]
    su = torch.zeros(1, 8, device=dev)
    su[0, fm.SU_SHIFT] = 0.07
    su[0, fm.SU_OLDEPS:fm.SU_PHI + 1] = torch.tensor([0.11, 0.23, 0.57, 0.83])

    def k6():
        out = (torch.empty(nrb, bn, device=dev), torch.empty(1, 1, device=dev))
        return fc.bell_spmv_dot(blocks, cols, full, off, row_group=row_group, out=out,
                                work=fc.FusedWork.new(dev, maxiter=9))

    def k17():
        v = [t.clone() for t in vecs]
        out = (torch.empty_like(v[0]), v[3], v[4], torch.empty(2, device=dev))
        return fm.minres_shard_spmv_dot(blocks, cols, full, *v, su, off, row_group=row_group,
                                        out=out, work=fm.MinresWork.new(dev, maxiter=9))

    return (("K6", k6), ("K17", k17))


def sharded_hashes(dev, card) -> None:
    """One hash a call of kernels 6 and 17 (their outputs) on each of
    sharded_operators's shards; for comparing two trees on one card."""
    for label, blocks, cols, full, off, rg in sharded_operators(dev):
        for name, launch in sharded_launches(blocks, cols, full, off, rg):
            print(f"  per-call hash {name} {label}: {digest(*launch())}  [{card}]")


def sharded_timers(shard_ops, n_shards, dtype) -> dict:
    """Kernels 6 and 17 on the n = 262,144 operator split in ``n_shards``
    (``shard_ops``: sharded_ops's P = 4 split), tiles of ``dtype``, each as
    the loops launch it (into buffers made once, on a solve's work that
    never finishes; kernel 17 in place with phi = 0, so x stays put):
    name -> (one launch on shard 0, its plain version, the bound on one
    launch's bytes (phase_sharded_kernels's), one launch on each shard in
    turn).  Repeated launches on one shard can find some of its tiles in
    L2 (a P = 8 shard's are 51 MB in float32); the loop's launches, one a
    shard, never do."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    rng = np.random.default_rng(17)
    blocks4, cols4 = shard_ops
    dev = blocks4.device
    bls = blocks4.view(n_shards, -1, 3, 128, 128).to(dtype)
    cls = cols4.view(n_shards, -1, 3)
    bl, cl = bls[0], cls[0]
    m = N_BIG // n_shards
    full = torch.as_tensor(rng.standard_normal((N_BIG // 128, 128)), dtype=torch.float32,
                           device=dev)
    work = fc.FusedWork.new(dev, maxiter=1 << 20, tol=-1.0)
    mwork = fm.MinresWork.new(dev, maxiter=1 << 20, tol=-1.0)
    mwork.start(torch.tensor(2.3, device=dev))
    q, pap = torch.empty(m // 128, 128, device=dev), torch.empty(1, 1, device=dev)
    vecs = [torch.as_tensor(rng.standard_normal((m // 128, 128)), dtype=torch.float32,
                            device=dev) for _ in range(5)]
    su = torch.zeros(1, 8, device=dev)
    su[0, fm.SU_SHIFT] = 0.07
    su[0, fm.SU_OLDEPS:fm.SU_PHI] = torch.tensor([0.11, 0.23, 0.57])
    out = (torch.empty_like(vecs[0]), vecs[3], vecs[4], torch.empty(2, device=dev))

    def k6(s_):
        fc.bell_spmv_dot(bls[s_], cls[s_], full, s_ * m, out=(q, pap), work=work)

    def k17(s_):
        fm.minres_shard_spmv_dot(bls[s_], cls[s_], full, *vecs, su, s_ * m, out=out, work=mwork)

    return {
        "K6": (lambda: k6(0), lambda: fc._spmv_dot_plain(bl, cl, full, 0, None, None),
               bound(nbytes(bl, cl, full) + m * 4, 2 * bl.numel() + 2 * m),
               lambda: [k6(s_) for s_ in range(n_shards)]),
        "K17": (lambda: k17(0),
                lambda: fm._shard_plain(bl, cl, full, tuple(vecs), su, 0, None, None),
                bound(nbytes(bl, cl, full, su) + 8 * m * 4, 2 * bl.numel() + 12 * m),
                lambda: [k17(s_) for s_ in range(n_shards)]),
    }


def sharded_table_rows(shard_ops, dtype, times, extra, names) -> None:
    """Phase 2's rows of kernels 6 and 17 (those in ``names``), tiles of
    ``dtype``: time_pair of one launch on shard 0 against its plain version
    (sharded_timers), with the bound on its bytes and no library time (an
    SpMV fused with window dots, and for 17 with axpys and a shift: no one
    call); P = 4 into ``times`` under the kernel's counter, P = 8 into
    ``extra``."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda._common import form

    counters = {"K6": "bell_spmv_dot", "K17": "minres_shard_spmv_dot"}
    tag = " bf16" if dtype == torch.bfloat16 else ""
    for n_shards in SHARDED_SHAPES:
        for name, (kern, plain, bnd, _) in sharded_timers(shard_ops, n_shards, dtype).items():
            if name in names:
                t = time_pair(kern, plain)
                t.update(bnd, library_ms=None)
                if n_shards == 4:
                    times[form(counters[name], dtype)] = t
                else:
                    extra[f"{name}{tag} tridiag P=8"] = t
    torch.cuda.synchronize()


def other_library(root):
    """The kernel library of the tree at ``root`` (another checkout of this
    repository), built there from its own sources and opened beside this
    tree's: its own ``_build`` module, loaded under another name."""
    import importlib.util

    path = os.path.join(root, "conjugategradient_tpu_torch", "ops", "cuda", "_build.py")
    spec = importlib.util.spec_from_file_location("other_tree_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build()
    return mod.load_library()


@contextlib.contextmanager
def kernels_of(lib):
    """Launch this tree's wrappers on the kernels of ``lib`` (this tree's or
    other_library's: the entry points of kernels 6 and 17 take the same
    arguments in both)."""
    from conjugategradient_tpu_torch.ops.cuda import _build

    saved = _build.load_library()
    _build._lib = lib
    try:
        yield
    finally:
        _build._lib = saved


def sharded_rows(dev, card, other=None) -> None:
    """Kernels 6 and 17 at P = 4 and 8, float32 and bf16 tiles, timed
    against their plain versions (time_pair on shard 0, launched as
    sharded_timers makes them) with their bound, then a launch's device ms
    where each launch takes the next shard, as the loop does; with
    ``other`` (another tree's root), that tree's kernels timed the same two
    ways in the same process on the same inputs, in turns (other, this,
    this, other: profiler device ms a launch)."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import _build

    libs = {"this": _build.load_library()}
    if other is not None:
        libs["other"] = other_library(other)
    shard_ops = sharded_ops(dev, 4)
    for n_shards in SHARDED_SHAPES:
        for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            for name, (kern, plain, bnd, cycle) in sharded_timers(shard_ops, n_shards,
                                                                  dt).items():
                t = time_pair(kern, plain)
                t.update(bnd, library_ms=None)
                print_time_row(f"{name} P={n_shards} {tag}", t, card)
                for how, fn, per in (("one shard", kern, 1), ("shards in turn", cycle, n_shards)):
                    got = []
                    for who in (("other", "this", "this", "other") if other else ("this",)):
                        with kernels_of(libs[who]):
                            ms = device_ms(fn)
                        got.append(float("nan") if ms is None else ms / per)
                    c = min(got[1:3]) if other else got[0]
                    line = (f"  {how} {name} P={n_shards} {tag}: this {c:.5f} ms a launch "
                            f"({bnd['bound_ms'] / c:.3f} of the bound {bnd['bound_ms']:.5f})")
                    if other:
                        p_ = min(got[0], got[3])
                        line += (f", other {p_:.5f} ({bnd['bound_ms'] / p_:.3f}), this / other "
                                 f"{c / p_:.3f} (device ms, other, this, this, other: "
                                 f"{'; '.join(f'{v:.5f}' for v in got)})")
                    print(f"{line}  [{card}]")
    torch.cuda.synchronize()


def sharded_ring_report(dev, card, shapes=SHARDED_SHAPES) -> None:
    """The ring of kernels 6 and 17: its geometry on the sharded path's
    shards (chunks, stages and dynamic shared memory as banded_ring gives
    them; strips, and the persistent grid of at most two CTAs an SM), then
    a launch's device time, each launch on the next shard as in the loop,
    against the ring depth at each P of ``shapes`` in both forms (each
    depth's outputs on shard 0 hashed and held equal to the default's).
    Trees without the ring print nothing."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc

    if not hasattr(fc, "set_sharded_ring_stages"):
        return
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n_shards in SHARDED_SHAPES:
        nrb = N_BIG // 128 // n_shards
        strips = -(-nrb // fc.auto_row_group(nrb, dev))
        grid = min(strips, 2 * sms)
        for dt in (torch.float32, torch.bfloat16):
            g = banded_ring(128, dt)
            print(f"  ring K6/K17 P={n_shards} {str(dt)[6:]}: {nrb} block-rows of 3 slots, "
                  f"{strips} strips on {grid} CTAs ({nrb // grid}-{-(-nrb // grid)} rows a "
                  f"CTA), {g['chunk_rows']} tile rows a chunk ({g['chunk_bytes']} B), "
                  f"{g['stages']} stages, {g['smem_bytes']} B dynamic smem a CTA")
    blocks4, cols4 = sharded_ops(dev, 4)
    full = torch.as_tensor(np.random.default_rng(23).standard_normal((N_BIG // 128, 128)),
                           dtype=torch.float32, device=dev)
    for n_shards in shapes:
        bl = blocks4.view(n_shards, -1, 3, 128, 128)[0]
        cl = cols4.view(n_shards, -1, 3)[0]
        for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            timers = sharded_timers((blocks4, cols4), n_shards, dt)
            for name, fn in sharded_launches(bl.to(dt), cl, full, 0, None):
                ring_depth_row(f"{name} P={n_shards} {tag}", "a launch, the shards in turn", fn,
                               timers[name][3], n_shards, fc.set_sharded_ring_stages, dt, card)


def sharded_only(dev, card, other=None) -> None:
    """``--sharded-only [TREE]``: kernels 6 and 17 alone: the ptxas report,
    their ring's geometry and depth sweep, and their rows at P = 4 and 8
    in both forms, with another tree's kernels beside them in the same
    process when its root is given (sharded_rows)."""
    ptxas_report(card)
    sharded_ring_report(dev, card)
    sharded_rows(dev, card, other)


# ---- kernel 11: per-call and solve hashes, volumes in turn, SASS ------------

# the per-call hashes of kernel 11 (stencil_hashes): 256^3, STENCIL_SMALL,
# ragged volumes (nz of 1, 7, 8, 9, 130, 256; ny and nx of 1, 2, 9, 33) and
# offset views whose base is not 16-byte aligned ((shape, offset in elements))
STENCIL_RAGGED = ((33, 9, 1), (2, 2, 7), (1, 9, 8), (33, 1, 9), (2, 9, 130), (33, 2, 256))
STENCIL_OFFSET = (((33, 9, 256), 1), ((33, 9, 256), 3), ((33, 9, 256), 7))
STENCIL_VOLUMES = 4  # 256^3 volumes taken in turn: 4 x 33.5 MB in bf16, more than the L2 holds
VCYCLE_SHAPES = tuple((s, s, s) for s in (256, 128, 64, 32, 16))  # MG-PCG's levels at 256^3


def stencil_volume(shape, dtype, dev, seed, offset=0):
    """A seeded standard-normal (nx, ny, nz) volume of ``dtype``, as a view
    ``offset`` elements into a flat buffer (its base then 16-byte aligned
    only where offset * itemsize is a multiple of 16)."""
    import torch

    n = math.prod(shape)
    buf = torch.as_tensor(np.random.default_rng(seed).standard_normal(n + offset),
                          dtype=torch.float64, device=dev).to(dtype)
    return buf[offset:offset + n].view(shape)


def stencil_coeffs(dtype):
    """The (center, off) pairs of the per-call hashes: (6, -1); 0.1 and
    -1/3 rounded to bf16; in bf16 also 0.1 and -1/3 rounded to float32
    only, which bf16 cannot hold (the kernel takes float32 coefficients)."""
    import torch

    def r(v, dt):
        return float(torch.tensor(v, dtype=torch.float64).to(dt))

    pairs = [(6.0, -1.0), (r(0.1, torch.bfloat16), r(-1 / 3, torch.bfloat16))]
    if dtype == torch.bfloat16:
        pairs.append((r(0.1, torch.float32), r(-1 / 3, torch.float32)))
    return pairs


def stencil_hashes(dev, card) -> None:
    """One hash a call of kernel 11 (``ops/cuda/stencil.stencil7``, each
    tree's own route) in float32, float64 and bf16 on the shapes above with
    each coefficient pair, then the history and x of three stencil solves:
    the portable bf16 CG on stencil:256 as the tester runs it (b = 1..n
    formed in bf16 as the tester forms it, tol 1e-5 ||b||), float32 MG-PCG
    (Jacobi smoother) and Chebyshev PCG (degree CHEB_DEGREE, the Lanczos
    interval) at 256^3 to 1e-5 ||b|| with b = arange / n."""
    import torch

    from conjugategradient_tpu_torch import StencilOperator, cg_solve, multigrid_preconditioner
    from conjugategradient_tpu_torch.ops.cuda import stencil as ks
    from conjugategradient_tpu_torch.solver import (chebyshev_preconditioner,
                                                    estimate_spectral_bounds)

    cases = [(s, 0) for s in (STENCIL_GRID,) + STENCIL_SMALL + STENCIL_RAGGED] + \
        list(STENCIL_OFFSET)
    count = 0
    for tag, dtype in (("f32", torch.float32), ("f64", torch.float64), ("bf16", torch.bfloat16)):
        for i, (shape, off) in enumerate(cases):
            u = stencil_volume(shape, dtype, dev, seed=40 + i, offset=off)
            for c, w in stencil_coeffs(dtype):
                y = ks.stencil7(u, c, w)
                print(f"  stencil7 hash {tag} {shape} +{off} c={c!r} w={w!r}: sha256 "
                      f"{digest(y)}  [{card}]")
                count += 1
    print(f"  stencil7 per-call hashes: {count}")
    bf16 = torch.bfloat16
    op = StencilOperator.poisson(STENCIL_GRID, dtype=bf16, device=dev)
    n = op.shape[0]
    b = torch.arange(n, dtype=torch.float64, device=dev).to(bf16) + 1
    x, info = cg_solve(op, b, tol=TOL_SOLVE_REL * bnorm(n), maxiter=BF16_STENCIL_MAXITER)
    print(f"  portable CG stencil:256 bf16 (the tester's b and tol): {int(info.iterations)} its, "
          f"rho_history and x sha256 {digest(info.rho_history, x)}  [{card}]")
    op = StencilOperator.poisson(STENCIL_GRID, device=dev)
    b = stencil_rhs(n, dev, scale=n)
    tol = TOL_SOLVE_REL * float(b.double().norm())
    x, info = cg_solve(op, b, tol=tol, M=multigrid_preconditioner(op))
    print(f"  MG-PCG 256^3 float32 (Jacobi smoother): {int(info.iterations)} its, rho_history and "
          f"x sha256 {digest(info.rho_history, x)}  [{card}]")
    lo, hi = estimate_spectral_bounds(op)
    x, info = cg_solve(op, b, tol=tol, M=chebyshev_preconditioner(op, lo, hi, degree=CHEB_DEGREE))
    print(f"  Chebyshev PCG 256^3 float32 degree {CHEB_DEGREE} on [{lo!r}, {hi!r}]: "
          f"{int(info.iterations)} its, rho_history and x sha256 {digest(info.rho_history, x)}  "
          f"[{card}]")


@contextlib.contextmanager
def stencil_general_route():
    """Send every kernel-11 call down the register march, whose C entry
    points take the same arguments in every version of this repository:
    to run another tree's kernels under this tree's wrapper (kernels_of),
    or to time this tree's two kernels on one volume."""
    from conjugategradient_tpu_torch.ops.cuda import stencil as ks

    saved = ks.stencil_route
    ks.stencil_route = lambda u: "stencil7"
    try:
        yield
    finally:
        ks.stencil_route = saved


@contextlib.contextmanager
def stencil_staged_route():
    """Take kernel 11's staged kernel wherever its row and alignment rule
    holds, whatever the size threshold (ops/cuda/stencil.STAGED_MIN_POINTS)."""
    from conjugategradient_tpu_torch.ops.cuda import stencil as ks

    saved = ks.STAGED_MIN_POINTS
    ks.STAGED_MIN_POINTS = dict.fromkeys(saved, 0)
    try:
        yield
    finally:
        ks.STAGED_MIN_POINTS = saved


@contextlib.contextmanager
def stencil_other_tree(lib):
    """Kernel 11 from ``lib`` (another tree's library, other_library) under
    this tree's wrapper, on the register march: the one kernel-11 entry
    point every tree has."""
    with kernels_of(lib), stencil_general_route():
        yield


def stencil_turns(fns, vols) -> list:
    """Device ms of one launch of each of ``fns`` (context managers paired
    with a callable of a volume), each timed on the volumes taken in turn,
    in the given order."""
    got = []
    for ctx, fn in fns:
        with ctx():
            ms = device_ms(lambda: [fn(v) for v in vols])
        got.append(float("nan") if ms is None else ms / len(vols))
    return got


def stencil_rows(dev, card, other=None) -> None:
    """Kernel 11 at 256^3 in bf16, float32 and float64: time_pair on one
    volume (this tree's route and its plain version, repeated on that
    volume) with its bound and conv3d; then at each level of MG-PCG's
    V-cycle at 256^3 (256^3 .. 16^3) in the three types a launch's device
    ms on STENCIL_VOLUMES volumes taken in turn, as a solve's loop meets
    them: this tree's two kernels forced (general, staged, staged,
    general), which sets the route's size threshold, and, with ``other``
    (another tree's root), that tree's kernels under this tree's wrapper on
    its general route beside this tree's own route in the same process
    (other, this, this, other).  Then one V-cycle apply's device ms
    (other, this, this, other)."""
    import torch

    from conjugategradient_tpu_torch import StencilOperator, multigrid_preconditioner
    from conjugategradient_tpu_torch.ops.cuda import stencil as ks

    other_lib = other_library(other) if other is not None else None
    here = contextlib.nullcontext
    general, staged = stencil_general_route, stencil_staged_route
    parent = lambda: stencil_other_tree(other_lib)

    def cell(label, g):
        return (f"{label}: " + "; ".join(f"{v:.5f}" for v in g))

    torch.backends.cudnn.allow_tf32 = False
    routes = getattr(ks, "stencil_route", None)
    for shape in VCYCLE_SHAPES:
        for tag, dtype, peak in (("bf16", torch.bfloat16, PEAK_F32_PER_S),
                                 ("f32", torch.float32, PEAK_F32_PER_S),
                                 ("f64", torch.float64, PEAK_F64_PER_S)):
            vols = [stencil_volume(shape, dtype, dev, seed=60 + i) for i in range(STENCIL_VOLUMES)]
            u, n = vols[0], math.prod(shape)
            bnd = bound(2 * nbytes(u), 8 * n, peak)
            route = routes(u) if routes is not None else "stencil7"
            label = f"stencil7 {tag} {'x'.join(map(str, shape))}"
            if shape == STENCIL_GRID:
                t = time_pair(lambda: ks.stencil7(u, 6.0, -1.0),
                              lambda: ks._stencil7_plain(u, 6.0, -1.0))
                t.update(bnd)
                t["library_ms"] = library_ms(conv3d_stencil(u, 6.0, -1.0))
                print_time_row(f"{label} one volume ({route})", t, card)
            k = lambda v: ks.stencil7(v, 6.0, -1.0)
            cells = [f"bound {bnd['bound_ms']:.5f}", f"route {route}"]
            if routes is not None:
                g = stencil_turns(((general, k), (staged, k), (staged, k), (general, k)), vols)
                s_, g_ = min(g[1:3]), min(g[0], g[3])
                cells.append(f"staged {s_:.5f} ({bnd['bound_ms'] / s_:.3f} of the bound), "
                             f"register march {g_:.5f} ({bnd['bound_ms'] / g_:.3f}), staged / "
                             f"march {s_ / g_:.3f} ({cell('march, staged, staged, march', g)})")
            if other_lib is not None:
                g = stencil_turns(((parent, k), (here, k), (here, k), (parent, k)), vols)
                c, p_ = min(g[1:3]), min(g[0], g[3])
                cells.append(f"this {c:.5f} ({bnd['bound_ms'] / c:.3f}), other {p_:.5f} "
                             f"({bnd['bound_ms'] / p_:.3f}), this / other {c / p_:.3f} "
                             f"({cell('other, this, this, other', g)})")
            elif routes is None:
                g = stencil_turns(((here, k),), vols)
                cells.append(f"this {g[0]:.5f} ({bnd['bound_ms'] / g[0]:.3f} of the bound)")
            print(f"  volumes in turn {label}: device ms a launch; {'; '.join(cells)}  [{card}]")
            del vols, u
    op = StencilOperator.poisson(STENCIL_GRID, device=dev)
    r = stencil_rhs(op.shape[0], dev, scale=op.shape[0])
    for smoother in ("jacobi", "chebyshev"):
        M = multigrid_preconditioner(op, smoother=smoother)
        order = ((parent, "other"), (here, "this"), (here, "this"), (parent, "other")) \
            if other_lib is not None else ((here, "this"),)
        cells = []
        for ctx, who in order:
            with ctx():
                prof = kernel_profile(lambda: M(r))
            cells.append(f"{who} " + ("not measured" if prof is None else
                                      f"{prof[0]:.4f} ms device, {prof[1]} launches"))
        print(f"  V-cycle apply 256^3 {smoother}: {'; '.join(cells)}  [{card}]")


STENCIL_LOOP_STEPS = 64  # the portable bf16 CG on stencil:256: steps timed a run


def stencil_loop_rows(dev, card, other=None) -> None:
    """The portable CG on stencil:256 in bf16 (kernel 11's bf16 form once a
    step, the tester's b): ms/it over STENCIL_LOOP_STEPS steps at tol = -1
    (host clock, the best of 3) and the device ms a step (torch.profiler
    over one run), this tree's kernels and, with ``other``, that tree's
    beside them (other, this, this, other)."""
    import torch

    from conjugategradient_tpu_torch import StencilOperator, cg_solve
    from conjugategradient_tpu_torch.utils import Timer

    other_lib = other_library(other) if other is not None else None
    parent = lambda: stencil_other_tree(other_lib)
    bf16 = torch.bfloat16
    op = StencilOperator.poisson(STENCIL_GRID, dtype=bf16, device=dev)
    b = torch.arange(op.shape[0], dtype=torch.float64, device=dev).to(bf16) + 1
    run = lambda: cg_solve(op, b, tol=-1.0, maxiter=STENCIL_LOOP_STEPS)
    order = ((parent, "other"), (contextlib.nullcontext, "this"),
             (contextlib.nullcontext, "this"), (parent, "other")) if other_lib is not None \
        else ((contextlib.nullcontext, "this"),)
    cells = []
    for ctx, who in order:
        with ctx():
            run()
            best = float("inf")
            for _ in range(3):
                t = Timer(dev).start_measure()
                _, info = run()
                t.stop_measure()
                best = min(best, t.get_duration() / int(info.iterations))
            prof = kernel_profile(run)
        dev_ms = "not measured" if prof is None else f"{prof[0] / STENCIL_LOOP_STEPS:.5f}"
        cells.append(f"{who} {best:.5f} ms/it, device {dev_ms} ms a step")
    print(f"  portable CG stencil:256 bf16, {STENCIL_LOOP_STEPS} steps: {'; '.join(cells)}  "
          f"[{card}]")


SASS_OPS = ("F2F", "F2FP", "HADD2", "HFMA2", "FADD", "FMUL", "FFMA", "DADD", "DMUL", "DFMA",
            "PRMT", "SHFL", "LDG", "LDS", "STG", "UBLKCP", "SYNCS")


def stencil_sass(card, other=None) -> None:
    """Kernel 11's compiled code, this tree's and ``other``'s: the
    registers, static shared memory and spills that ``nvcc -Xptxas -v``
    reports for each instantiation in ``csrc/stencil.cu``, then each
    function's count of the conversion (F2F, F2FP), bf16 pair (HADD2,
    HFMA2), float and double arithmetic, shuffle, load, store and bulk-copy
    instructions in ``cuobjdump -sass``."""
    import re

    def label(name):
        k = re.search(r"(stencil7\w*?_kernel)I(\w+?)E", name)
        if k is None:
            return None
        ty = "bf16" if "bfloat16" in k.group(2) else ("f64" if k.group(2).startswith("d") else
                                                      "f32")
        return f"{k.group(1)}<{ty}>"

    sass_report(card, "stencil.cu", SASS_OPS, other, label)


def demangled(names) -> dict:
    """Each mangled name in ``names`` as ``cu++filt`` (beside nvcc) prints
    it, or as it is where that tool is missing."""
    import re

    from conjugategradient_tpu_torch.ops.cuda import _build

    names = sorted(set(names))
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cu++filt")
    if not names or not os.path.exists(tool):
        return {n: n for n in names}
    out = subprocess.run([tool, *names], capture_output=True, text=True, timeout=120)
    lines = out.stdout.splitlines()
    if out.returncode != 0 or len(lines) != len(names):
        return {n: n for n in names}
    def short(d):
        """The function's name and template arguments, without the
        parameter list: up to the '(' that balances the last ')'."""
        d = re.sub(r"^void |<unnamed>::|\(anonymous namespace\)::", "", d.strip())
        depth = 0
        for i in range(len(d) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(d[i], 0)
            if depth == 0 and d[i] == "(":
                return d[:i]
        return d

    return {n: short(d) for n, d in zip(names, lines)}


def sass_report(card, source, ops, other=None, label=None) -> None:
    """``nvcc -Xptxas -v`` on ``csrc/<source>`` of this tree and of
    ``other``'s, as the build compiles it: each function's registers,
    static shared memory and spills; then each function's count of the
    instructions ``ops`` in ``cuobjdump -sass``.  ``label`` names a mangled
    function, or None to leave it out; by default every function, by its
    demangled name."""
    import re

    from conjugategradient_tpu_torch.ops.cuda import _build

    tmp = os.path.join(ROOT, "build", "ptxas")
    os.makedirs(tmp, exist_ok=True)
    trees = [("this", ROOT)] + ([("other", other)] if other is not None else [])
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    stem = os.path.splitext(source)[0]
    for who, root in trees:
        src = os.path.join(root, "conjugategradient_tpu_torch", "csrc", source)
        obj = os.path.join(tmp, f"{stem}_{who}.o")
        out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                              obj, src], capture_output=True, text=True, timeout=600)
        check(out.returncode == 0, f"nvcc -Xptxas -v {src} failed: {out.stderr[-2000:]}")
        sass = subprocess.run([tool, "-sass", obj], capture_output=True, text=True, timeout=300)
        check(sass.returncode == 0, f"cuobjdump -sass {obj} failed: {sass.stderr[-2000:]}")
        text = out.stdout + out.stderr
        if label is None:
            names = demangled(re.findall(r"Compiling entry function '(\S+)'", text) +
                              re.findall(r"Function : (\S+)", sass.stdout))
            name_of = names.get
        else:
            name_of = label
        entry, info = None, {}
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry, info = name_of(m.group(1)), {}
                continue
            if entry is None:
                continue
            for key, pat in (("spill stores", r"(\d+) bytes spill stores"),
                             ("spill loads", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers"),
                             ("smem", r"(\d+) bytes smem")):
                m = re.search(pat, line)
                if m:
                    info[key] = int(m.group(1))
            if "registers" in info:
                print(f"  ptxas {who} {entry}: {info['registers']} registers, "
                      f"{info.get('smem', 0)} B static smem, {info.get('spill stores', 0)} B "
                      f"spill stores, {info.get('spill loads', 0)} B spill loads  [{card}]")
                entry = None
        entry, counts = None, {}
        for line in sass.stdout.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                entry = name_of(m.group(1))
                if entry:
                    counts[entry] = dict.fromkeys(ops, 0)
                continue
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if entry is None or m is None:
                continue
            if m.group(1) in counts[entry]:
                counts[entry][m.group(1)] += 1
        for entry, c in counts.items():
            print(f"  sass {who} {entry}: " + ", ".join(f"{k} {v}" for k, v in c.items()) +
                  f"  [{card}]")


STENCIL_SWEEP = ((3, 4, 6), (1, 2, 4, 8, 16))  # ring stages, x planes a CTA


def stencil_ring_sweep(dev, card) -> None:
    """The staged kernel's device ms a launch (volumes in turn, the
    staged kernel forced) at 256^3, 128^3 and 64^3 in each type against its
    ring depth and x planes a CTA (STENCIL_SWEEP), each setting's output
    hashed and held equal to the default's.  Trees without the staged
    kernel print nothing."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import stencil as ks

    if not hasattr(ks, "staged_stages"):
        return
    saved = ks.STAGED_XCHUNK, ks.staged_stages
    for shape in VCYCLE_SHAPES[:3]:
        for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32),
                           ("f64", torch.float64)):
            vols = [stencil_volume(shape, dtype, dev, seed=60 + i) for i in range(STENCIL_VOLUMES)]
            with stencil_staged_route():
                ref = digest(ks.stencil7(vols[0], 6.0, -1.0))
                cells = []
                try:
                    for stages in STENCIL_SWEEP[0]:
                        ks.staged_stages = lambda xc, s=stages: s
                        for xc in STENCIL_SWEEP[1]:
                            ks.STAGED_XCHUNK = (xc, xc)
                            check(digest(ks.stencil7(vols[0], 6.0, -1.0)) == ref,
                                  f"stencil7_staged {tag} {shape}: S={stages} x={xc} changed "
                                  "the bits")
                            ms = device_ms(lambda: [ks.stencil7(v, 6.0, -1.0) for v in vols])
                            cells.append(f"S{stages}x{xc} " + ("-" if ms is None else
                                                               f"{ms / len(vols):.5f}"))
                finally:
                    ks.STAGED_XCHUNK, ks.staged_stages = saved
            xc = ks.staged_xchunk(shape[0])
            print(f"  ring sweep stencil7_staged {tag} {'x'.join(map(str, shape))} (device ms a "
                  f"launch, volumes in turn; default S{ks.staged_stages(xc)}, x{xc}): "
                  f"{'; '.join(cells)}  [{card}]")
            del vols


def stencil_only(dev, card, other=None) -> None:
    """``--stencil-only [TREE]``: kernel 11 alone: its per-call and solve
    hashes (stencil_hashes), its compiled code (stencil_sass) and its
    timing rows (stencil_rows), with another tree's kernels beside them
    in the same process when its root is given."""
    stencil_hashes(dev, card)
    stencil_sass(card, other)
    stencil_rows(dev, card, other)
    stencil_loop_rows(dev, card, other)
    stencil_ring_sweep(dev, card)


# ---- kernels 7 and 10 alone (--dia-only [TREE]) --------------------------------------------

DIA_SOLVE_MAXITER = 2000  # the --dia-only solves' cap, far above their counts
DIA_SWEEP = ((64, 128), (2, 3, 4, 6, 8))  # the tiled kernel 10's tile heights and ring depths
DIA_TURN_REPS = 50  # launches a profiler trace of the --dia-only timing rows holds


def other_package(root):
    """The port's package of the tree at ``root`` (another checkout of this
    repository), imported beside this tree's under another name: its own
    wrappers, types and solvers, and its kernels built there from its own
    sources."""
    import importlib.util

    pkg = os.path.join(root, "conjugategradient_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "other_tree_cgt", os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_tree_cgt"] = mod
    spec.loader.exec_module(mod)
    import other_tree_cgt.ops.cuda._build as ob  # noqa: F401  (registered just above)

    ob.build()
    ob.load_library()
    return mod


def dia_hash_cases(dev):
    """The operators of phase_dia_kernels and dia_route_rows as raw
    tensors: (label, full (diags, offsets) or None, symmetric (diags,
    offsets) or None, x), x seeded (a NaN in the ragged n = 1001 one)."""
    import torch

    from conjugategradient_tpu_torch import load_matrix

    rng = np.random.default_rng(26)

    def vec(n):
        return torch.as_tensor(rng.standard_normal(n), dtype=torch.float32, device=dev)

    def raw(a):
        return a.diags, tuple(int(o) for o in a.offsets)

    big, big_sym = sym_dia_pair(SYMDIA_N, SYMDIA_OFFSETS, np.random.default_rng(0), dev)
    path = os.path.join(ROOT, MATRICES[0])
    p3d = load_matrix(path, layout="dia", dtype=np.float32, device=dev)
    p3s = load_matrix(path, layout="symdia", dtype=np.float32, device=dev)
    dense = os.path.join(ROOT, "problems/dense_256.mtx")
    dd = load_matrix(dense, layout="dia", dtype=np.float32, device=dev)
    ds = load_matrix(dense, layout="symdia", dtype=np.float32, device=dev)
    n = p3d.n
    o27 = tuple(sorted(i + 48 * j + 2304 * k for i in (-1, 0, 1) for j in (-1, 0, 1)
                       for k in (-1, 0, 1)))
    pos27 = tuple(o for o in o27 if o >= 0)
    f1001, s1001 = sym_dia_pair(1001, (0, 3, 300), rng, dev, scale=0.3)
    x1001 = vec(1001)
    x1001[500] = float("nan")
    xb = vec(n + 1)
    rect = torch.as_tensor(rng.standard_normal((4, 1001)), dtype=torch.float32, device=dev)
    neg = torch.as_tensor(rng.standard_normal((3, 777)), dtype=torch.float32, device=dev)
    past = torch.as_tensor(rng.standard_normal((3, 1000)), dtype=torch.float32, device=dev)
    xpast = vec(1000)
    xpast[3] = float("nan")
    return [
        ("symdia-big n=2097152", raw(big), raw(big_sym), vec(SYMDIA_N)),
        ("poisson3d_48", raw(p3d), raw(p3s), vec(n)),
        ("27-point n=110592", (torch.as_tensor(rng.standard_normal((27, n)), dtype=torch.float32,
                                               device=dev), o27),
         (torch.as_tensor(rng.standard_normal((len(pos27), n)), dtype=torch.float32, device=dev),
          pos27), vec(n)),
        ("poisson3d_48 n=110591", (p3d.diags[:, :n - 1].contiguous(), raw(p3d)[1]),
         (p3s.diags[:, :n - 1].contiguous(), raw(p3s)[1]), vec(n - 1)),
        ("poisson3d_48 x+1", raw(p3d), raw(p3s), xb[1:]),
        ("ragged n=1001 offsets 0,3,300 NaN", raw(f1001), raw(s1001), x1001),
        ("dense_256", raw(dd), raw(ds), vec(256)),
        ("rect 1001x1300", (rect, (-7, 0, 5, 299)), None, vec(1300)),
        ("negative offsets only", (neg, (-300, -3, -1)), None, vec(777)),
        ("offsets past n=1000 NaN", None, (past, (0, 5, 2000)), xpast),
        ("poisson3d_48 -0 rows", None, (-p3s.diags.abs(), raw(p3s)[1]),
         torch.zeros(n, dtype=torch.float32, device=dev)),
    ]


def dia_calls(pkg, cases, who, card, check_plain: bool) -> list:
    """One hash a call of kernels 7 and 10 through ``pkg``'s wrappers (the
    route each tree takes), float32 then bf16 diagonals, on each case of
    dia_hash_cases; with ``check_plain``, each y held bit for bit to the
    plain version and each bf16 y to the float32 launch on the widened
    diagonals.  Returns the hashes in order."""
    import importlib

    import torch

    kd = importlib.import_module(f"{pkg.__name__}.ops.cuda.dia_spmv")
    launches = importlib.import_module(f"{pkg.__name__}.ops.cuda._common").LAUNCHES
    same = lambda u, v: torch.equal(u.view(torch.int32), v.view(torch.int32))  # noqa: E731
    got = []
    for label, full, sym, x in cases:
        for kernel, op, call, plain in (
                ("K7", full, kd.dia_spmv_diags, kd._dia_plain),
                ("K10", sym, kd.sym_dia_spmv_diags, kd._sym_dia_plain)):
            if op is None:
                continue
            diags, offs = op
            od = torch.tensor(offs, dtype=torch.int32, device=diags.device)
            ys = {}
            for tag, d in (("f32", diags), ("bf16", diags.bfloat16())):
                before = dict(launches)
                ys[tag] = call(d, offs, od, x)
                route = [k for k in launches if launches[k] != before[k]]
                torch.cuda.synchronize()
                h = digest(ys[tag])
                got.append(h)
                print(f"  dia hash {who} {kernel} {tag} {label} ({len(offs)} offsets, "
                      f"{'/'.join(route)}): {h}  [{card}]")
                if check_plain:
                    check(same(ys[tag], plain(d, offs, x)),
                          f"{kernel} {tag} {label}: not bit-equal to the plain version")
            if check_plain:
                check(same(ys["bf16"], call(diags.bfloat16().float(), offs, od, x)),
                      f"{kernel} {label}: the bf16 launch differs from the float32 launch on "
                      "the widened diagonals")
    return got


def dia_solves(pkg, dev, who, card) -> list:
    """The history and x of four portable solves through ``pkg``: the
    SymDIA CG on poisson3d_48 in float32 and bf16 (to 1e-5·||b||, b = 1..n),
    the bf16 SymDIA CG on symdia-big (BF16_SYMDIA_STEPS steps at tol = -1,
    b = 1..n / n) and the bf16 DIA CG on poisson3d_48."""
    import torch

    path = os.path.join(ROOT, MATRICES[0])
    p3s = pkg.load_matrix(path, layout="symdia", dtype=np.float32, device=dev)
    p3d = pkg.load_matrix(path, layout="dia", dtype=np.float32, device=dev)
    _, big = sym_dia_pair(SYMDIA_N, SYMDIA_OFFSETS, np.random.default_rng(0), dev)
    big = pkg.SymDIAMatrix(big.diags, big.offsets, big.shape, big.nnz).astype(torch.bfloat16)
    bp = torch.arange(1, p3s.n + 1, dtype=torch.float32, device=dev)
    bb = torch.arange(1, big.n + 1, dtype=torch.float32, device=dev) / big.n
    tol = TOL_SOLVE_REL * bnorm(p3s.n)
    got = []
    for label, a, b, kw in (
            ("SymDIA CG poisson3d_48 f32", p3s, bp, {"tol": tol}),
            ("SymDIA CG poisson3d_48 bf16", p3s.astype(torch.bfloat16), bp, {"tol": tol}),
            ("SymDIA CG symdia-big bf16", big, bb, {"tol": -1.0, "maxiter": BF16_SYMDIA_STEPS}),
            ("DIA CG poisson3d_48 bf16", p3d.astype(torch.bfloat16), bp, {"tol": tol})):
        kw.setdefault("maxiter", DIA_SOLVE_MAXITER)
        x, info = pkg.cg_solve(a, b, **kw)
        h = digest(info.rho_history, x)
        got.append(h)
        print(f"  dia solve hash {who} {label}: {int(info.iterations)} its, converged "
              f"{bool(info.converged)}, rho_history and x sha256 {h}  [{card}]")
    return got


DIA_SASS_OPS = ("LDG", "LDGSTS", "LDS", "STS", "STG", "FMUL", "FADD", "FFMA", "PRMT", "SHF",
                "LOP3", "IMAD", "SEL", "BAR", "DEPBAR", "BRA")


def dia_sass(card, other=None) -> None:
    """Kernels 7 and 10's compiled code, this tree's and ``other``'s: the
    registers, static shared memory and spills that ``nvcc -Xptxas -v``
    reports for each function of ``csrc/dia_spmv.cu``, then each function's
    count of load, store, arithmetic, conversion (PRMT, SHF, LOP3, IMAD)
    and barrier instructions in ``cuobjdump -sass``."""
    sass_report(card, "dia_spmv.cu", DIA_SASS_OPS, other)


def dia_turns(fns, reps=DIA_TURN_REPS) -> list:
    """Device ms a call of each callable in ``fns``, in the given order."""
    got = []
    for fn in fns:
        ms = device_ms(fn, reps=reps)
        got.append(float("nan") if ms is None else ms)
    return got


def dia_rows_other(dev, card, other=None) -> None:
    """Device ms a call of the forms of kernels 7 and 10 this slice
    redesigned, routed as each tree routes them, on the PERF.md rows'
    operators: kernel 10 on symdia-big (the tiled kernel) and poisson3d_48
    (a small operator), kernel 7 on poisson3d_48, float32 and bf16 each,
    with their bytes bound; with ``other`` (a package from other_package),
    that tree's calls beside this tree's in turns (other, this, this,
    other).  Then a step of the portable bf16 SymDIA CG on symdia-big."""
    import importlib

    import torch

    from conjugategradient_tpu_torch import load_matrix
    from conjugategradient_tpu_torch.ops.cuda import dia_spmv as kd

    rng = np.random.default_rng(27)
    _, big = sym_dia_pair(SYMDIA_N, SYMDIA_OFFSETS, np.random.default_rng(0), dev)
    path = os.path.join(ROOT, MATRICES[0])
    p3s = load_matrix(path, layout="symdia", dtype=np.float32, device=dev)
    p3d = load_matrix(path, layout="dia", dtype=np.float32, device=dev)
    trees = [("this", kd)] + ([("other", importlib.import_module(
        f"{other.__name__}.ops.cuda.dia_spmv"))] if other is not None else [])
    for label, a, sym in (("K10 symdia-big", big, True), ("K10 poisson3d_48", p3s, True),
                          ("K7 poisson3d_48", p3d, False)):
        x = torch.as_tensor(rng.standard_normal(a.shape[1]), dtype=torch.float32, device=dev)
        for tag, d in (("f32", a.diags), ("bf16", a.diags.bfloat16())):
            offs, od = tuple(int(o) for o in a.offsets), a.offsets_dev
            n = d.shape[1]
            if sym:
                moved, flops = nbytes(d, od) + 2 * n * 4, 2 * (2 * len(offs) - 1) * n
                calls = {who: (lambda m=m: m.sym_dia_spmv_diags(d, offs, od, x)) for who, m in trees}
                route = kd.sym_dia_route(offs, n, d.dtype)
            else:
                moved, flops = nbytes(d, od) + (a.shape[1] + n) * 4, 2 * len(offs) * n
                calls = {who: (lambda m=m: m.dia_spmv_diags(d, offs, od, x)) for who, m in trees}
                route = kd.dia_route(offs)
            bnd = bound(moved, flops)["bound_ms"]
            order = ("other", "this", "this", "other") if other is not None else ("this",)
            g = dia_turns([calls[w] for w in order])
            c = min(g[1:3]) if other is not None else g[0]
            cells = [f"this ({route}) {c:.5f} ({bnd / c:.3f} of the bound {bnd:.5f})"]
            if other is not None:
                p_ = min(g[0], g[3])
                cells.append(f"other {p_:.5f} ({bnd / p_:.3f}), this / other {c / p_:.3f} "
                             f"(other, this, this, other: {'; '.join(f'{v:.5f}' for v in g)})")
            print(f"  turns {label} {tag}: device ms a call; {'; '.join(cells)}  [{card}]")
    # the bf16 SymDIA CG on symdia-big: device ms a step (the tiled kernel 10
    # once a step and the loop's vector ops), each tree's solver
    bb = torch.arange(1, big.n + 1, dtype=torch.float32, device=dev) / big.n
    pkgs = [("this", sys.modules["conjugategradient_tpu_torch"])] + \
        ([("other", other)] if other is not None else [])
    runs = {}
    for who, pkg in pkgs:
        op = pkg.SymDIAMatrix(big.diags, big.offsets, big.shape, big.nnz).astype(torch.bfloat16)
        runs[who] = lambda pkg=pkg, op=op: pkg.cg_solve(op, bb, tol=-1.0,
                                                        maxiter=BF16_SYMDIA_STEPS)
    order = ("other", "this", "this", "other") if other is not None else ("this",)
    cells = []
    for who in order:
        prof = kernel_profile(runs[who])
        cells.append(f"{who} " + ("not measured" if prof is None else
                                  f"{prof[0] / BF16_SYMDIA_STEPS:.5f}"))
    print(f"  bf16 SymDIA CG symdia-big, {BF16_SYMDIA_STEPS} steps: device ms a step; "
          f"{'; '.join(cells)}  [{card}]")


def dia_tiled_sweep(dev, card) -> None:
    """The tiled kernel 10 on symdia-big, float32 and bf16: device ms a call
    at each tile height and ring depth of DIA_SWEEP, swept forward and then
    backward (the lesser of the two), each setting's y held bit for bit to
    the default's (the geometry changes no bit)."""
    import dataclasses

    import torch

    from conjugategradient_tpu_torch.ops.cuda import dia_spmv as kd

    _, big = sym_dia_pair(SYMDIA_N, SYMDIA_OFFSETS, np.random.default_rng(0), dev)
    x = torch.as_tensor(np.random.default_rng(28).standard_normal(big.n), dtype=torch.float32,
                        device=dev)
    base = kd.sym_dia_tiling(big.offsets, big.n)
    settings = [(m, st) for m in DIA_SWEEP[0] for st in DIA_SWEEP[1]]
    for tag, d in (("f32", big.diags), ("bf16", big.diags.bfloat16())):
        ref = kd.sym_dia_spmv_diags(d, big.offsets, big.offsets_dev, x)
        got = {}
        for order in (settings, settings[::-1]):
            for planes, stages in order:
                t = dataclasses.replace(base, planes=planes)
                call = lambda: kd.sym_dia_cuda(d, big.offsets, big.offsets_dev, x,  # noqa: E731
                                               "sym_dia_spmv_tiled", t, stages)
                check(torch.equal(call(), ref), f"sym_dia_spmv_tiled {tag} M={planes} "
                                                f"S={stages}: changed the bits")
                ms = device_ms(call, reps=DIA_TURN_REPS)
                got[planes, stages] = min(got.get((planes, stages), math.inf),
                                          math.inf if ms is None else ms)
        dm, ds = kd.TILE_GEOMETRY[d.dtype]
        print(f"  tiled sweep sym_dia_spmv_tiled {tag} symdia-big (device ms a call, the lesser "
              f"of a forward and a backward sweep; default M{dm}S{ds}): " + "; ".join(
                  f"M{m}S{st} {v:.5f}" for (m, st), v in got.items()) + f"  [{card}]")


def dia_only(dev, card, other=None) -> None:
    """``--dia-only [TREE]``: kernels 7 and 10 alone.  One hash a call on
    every route (dia_calls; this tree's calls held to the plain versions),
    the history and x of four portable solves (dia_solves), the compiled
    code (dia_sass), the timing rows (dia_rows_other) and the sweep of the
    tiled kernel's geometry.  Given TREE (another checkout's root), its package runs beside
    this one: its hashes are printed and held equal to this tree's, and its
    calls are timed in turns with this tree's."""
    other_pkg = other_package(other) if other is not None else None
    cases = dia_hash_cases(dev)
    this_pkg = sys.modules["conjugategradient_tpu_torch"]
    mine = dia_calls(this_pkg, cases, "this", card, True) + dia_solves(this_pkg, dev, "this", card)
    print(f"  dia hashes this: {len(mine)}")
    if other_pkg is not None:
        theirs = dia_calls(other_pkg, cases, "other", card, False) + \
            dia_solves(other_pkg, dev, "other", card)
        moved = sum(a != b for a, b in zip(mine, theirs))
        print(f"  dia hashes equal to the other tree's: {len(mine) - moved} of {len(mine)}")
        check(moved == 0 and len(mine) == len(theirs), f"{moved} dia hashes moved")
    del cases
    dia_sass(card, other)
    dia_rows_other(dev, card, other_pkg)
    dia_tiled_sweep(dev, card)


def fused_cg_only(dev, card) -> None:
    """The fused loops alone (``--fused-cg-only``), for comparing two trees
    on one card (this file run beside another tree's package gives that
    tree's numbers).  ms/it (the best of 3 solves after a warm-up) and a
    hash of each history: fused CG at n = 262,144 in both storages and at
    256^3, fused Jacobi PCG at n = 262,144 in symmetric storage (256 steps
    at tol = -1, dense tiles); the fused MINRES at n = 262,144 in both
    storages (bench.py's protocol), hash of history and x; fused CG, PCG
    and MINRES on poisson3d_48 (symmetric storage, the packed route);
    ``sharded_cg_solve`` at P = 4 with the fused kernels (CG, Jacobi PCG,
    MINRES), hash of history and x; the fused BiCGStab on bench.py's
    bicgstab-bell operator and on convdiff-512 (ms/it on each route);
    the portable DIA CG on poisson3d_48 (``--layout auto``: at the tester's
    tolerance, and ms/it over 256 steps); then the per-call hashes of
    kernels 2, 3 and 16 (update_hashes) and of kernels 20 and 7
    (bicg_dia_hashes), their timing rows (update_rows, bicg_dia_rows) and
    the elementwise floor."""
    import torch

    from conjugategradient_tpu_torch import (StencilOperator, bicgstab_solve, cg_solve,
                                             fused_bell_cg_solve, fused_bell_pcg_solve,
                                             fused_bicgstab_solve, fused_minres_solve,
                                             fused_stencil_cg_solve, load_matrix)
    import conjugategradient_tpu_torch as cgt
    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.parallel import make_row_mesh, sharded_cg_solve
    from conjugategradient_tpu_torch.utils import Timer

    def timed(solve, *args, steps=256, **kw):
        """(ms per step, the best of 3 solves of ``steps`` steps at tol =
        -1 after a warm-up; x; info of the last)."""
        solve(*args, tol=-1.0, maxiter=32, **kw)
        best = float("inf")
        for _ in range(3):
            t = Timer(dev).start_measure()
            x, info = solve(*args, tol=-1.0, maxiter=steps, **kw)
            t.stop_measure()
            best = min(best, t.get_duration() / int(info.iterations))
        return best, x, info

    big_full, big = block_tridiag_ops(N_BIG, 128, dev)
    b = torch.arange(1, N_BIG + 1, dtype=torch.float32, device=dev)
    op = StencilOperator.poisson(STENCIL_GRID, device=dev)
    bs = stencil_rhs(op.shape[0], dev, scale=op.shape[0])
    for label, solve, a, rhs in (("n=262144 symmetric", fused_bell_cg_solve, big, b),
                                 ("n=262144 full", fused_bell_cg_solve, big_full, b),
                                 ("stencil 256^3", fused_stencil_cg_solve, op, bs)):
        ms, _, info = timed(solve, a, rhs)
        print(f"  fused CG {label}: {ms:.5f} ms/it (best of 3 runs of 256 steps), "
              f"rho_history sha256 {digest(info.rho_history)}  [{card}]")
    ms, _, info = timed(fused_bell_pcg_solve, big, b, 1.0 / big.diagonal())
    print(f"  fused Jacobi PCG n=262144 symmetric: {ms:.5f} ms/it (best of 3 runs of 256 "
          f"steps), rho_history sha256 {digest(info.rho_history)}  [{card}]")
    # the cg-bf16 lane (full storage, bf16 tiles) and the refined solve of
    # its system: trees that have them print these two lines more
    if "refined_cg_solve" in dir(cgt):
        ms, _, info = timed(fused_bell_cg_solve, big_full.astype(torch.bfloat16), b)
        print(f"  fused CG n=262144 full bf16 (cg-bf16): {ms:.5f} ms/it (best of 3 runs of 256 "
              f"steps), rho_history sha256 {digest(info.rho_history)}  [{card}]")
        ms, _, info = timed(fused_bell_cg_solve, big.astype(torch.bfloat16), b)
        print(f"  fused CG n=262144 symmetric bf16 (cg-bf16, banded kernel 1): {ms:.5f} ms/it "
              f"(best of 3 runs of 256 steps), rho_history sha256 {digest(info.rho_history)}  "
              f"[{card}]")
        br = b / N_BIG
        x, rinfo = cgt.refined_cg_solve(big_full, br, tol=REFINE_TOL_REL * float(br.double().norm()))
        print(f"  refine n=262144 full (float32 high, bf16 low): {rinfo.refinements} refinements, "
              f"{rinfo.inner_iterations} inner iterations, rnorm_history and x sha256 "
              f"{digest(torch.tensor(rinfo.rnorm_history, dtype=torch.float64), x)}  [{card}]")
    bm = b / N_BIG  # bench.py's minres protocol
    for label, a in (("n=262144 symmetric", big), ("n=262144 full", big_full)):
        ms, x, info = timed(fused_minres_solve, a, bm, steps=MINRES_STEPS)
        print(f"  fused MINRES {label}: {int(info.iterations)} its, {ms:.5f} ms/it, "
              f"rnorm_history and x sha256 {digest(info.rnorm_history, x)}  [{card}]")
    # the same on bf16 tiles (kernels 14 and 15's bf16 forms): trees that
    # have them print these two lines more
    if "minres_dir_spmv_dot_bf16" in fc.LAUNCHES:
        for label, a in (("n=262144 symmetric bf16", big), ("n=262144 full bf16", big_full)):
            ms, x, info = timed(fused_minres_solve, a.astype(torch.bfloat16), bm,
                                steps=MINRES_STEPS)
            print(f"  fused MINRES {label}: {int(info.iterations)} its, {ms:.5f} ms/it, "
                  f"rnorm_history and x sha256 {digest(info.rnorm_history, x)}  [{card}]")
    p3d = load_symbell(MATRICES[0], dev)
    bp = torch.arange(1, p3d.n + 1, dtype=torch.float32, device=dev)
    for label, solve, args in (("CG", fused_bell_cg_solve, (p3d, bp)),
                               ("Jacobi PCG", fused_bell_pcg_solve,
                                (p3d, bp, 1.0 / p3d.diagonal())),
                               ("MINRES", fused_minres_solve, (p3d, bp / p3d.n))):
        ms, x, info = timed(solve, *args)
        hist = info.rnorm_history if label == "MINRES" else info.rho_history
        print(f"  fused {label} poisson3d_48 symmetric (packed route): {int(info.iterations)} "
              f"its, {ms:.5f} ms/it, history and x sha256 {digest(hist, x)}  [{card}]")
    blocks4, cols4 = sharded_ops(dev, 4)
    mesh = make_row_mesh(4, dev)
    for label, rhs, kw in (("CG", b, {}),
                           ("Jacobi PCG", b, {"inv_diag": 1.0 / big_full.diagonal()}),
                           ("MINRES", bm, {"method": "minres"})):
        ms, x, info = timed(sharded_cg_solve, blocks4, cols4, rhs, mesh=mesh, use_fused="always",
                            **kw)
        print(f"  sharded fused {label} n=262144 P=4: {int(info.iterations)} its, {ms:.5f} ms/it, "
              f"rho_history and x sha256 {digest(info.rho_history, x)}  [{card}]")
    # the same CG on bf16 shards (kernel 6's bf16 form): trees that have it
    # print this line more
    if "bell_spmv_dot_bf16" in fc.LAUNCHES:
        ms, x, info = timed(sharded_cg_solve, blocks4.to(torch.bfloat16), cols4, b, mesh=mesh,
                            use_fused="always")
        print(f"  sharded fused CG n=262144 P=4 bf16: {int(info.iterations)} its, {ms:.5f} ms/it, "
              f"rho_history and x sha256 {digest(info.rho_history, x)}  [{card}]")
    # the sharded fused CG and MINRES at P = 8 on float32 and on bf16 shards
    # (kernels 6 and 17 in both forms), history and x
    blocks8, cols8 = blocks4.view(8, -1, 3, 128, 128), cols4.view(8, -1, 3)
    mesh8 = make_row_mesh(8, dev)
    for tag, bl in (("", blocks8), (" bf16", blocks8.to(torch.bfloat16))):
        for label, rhs, kw in (("CG", b, {}), ("MINRES", bm, {"method": "minres"})):
            ms, x, info = timed(sharded_cg_solve, bl, cols8, rhs, mesh=mesh8, use_fused="always",
                                **kw)
            rows = kernel_rows(lambda: sharded_cg_solve(bl, cols8, rhs, mesh=mesh8, tol=-1.0,
                                                        maxiter=64, use_fused="always", **kw), 64)
            print(f"  sharded fused {label} n=262144 P=8{tag}: {int(info.iterations)} its, "
                  f"{ms:.5f} ms/it, rho_history and x sha256 {digest(info.rho_history, x)}; 64 "
                  f"steps: {rows}  [{card}]")
    del blocks8, cols8, bl
    a = nonsym_tridiag(N_BIG, 128, dev, seed=0)
    b = torch.arange(1, a.n + 1, dtype=torch.float32, device=dev) / a.n
    for tol in (TOL_SOLVE_REL * float(b.double().norm()), 0.0):
        x, info = bicgstab_solve(a, b, tol=tol, maxiter=64, fused="always")
        print(f"  fused BiCGStab bicgstab-bell tol {tol:.3g}: {int(info.iterations)} its, "
              f"rnorm_history and x sha256 {digest(info.rnorm_history, x)}  [{card}]")
    # the same on bf16 tiles (kernels 18 and 19's dense bf16 forms): trees
    # that have them print this line more
    if "bicgstab_dir_spmv_dot_bf16" in fc.LAUNCHES:
        x, info = bicgstab_solve(a.astype(torch.bfloat16), b, tol=0.0, maxiter=64, fused="always")
        print(f"  fused BiCGStab bicgstab-bell bf16 tol 0: {int(info.iterations)} its, "
              f"rnorm_history and x sha256 {digest(info.rnorm_history, x)}  [{card}]")
    # phase 3's convdiff-512 solve on each route (its sparse tiles take the
    # packed kernels 18 and 19 unless forced), then kernel 20; every step live
    cd = convdiff_bell(512, dev)
    bc = torch.as_tensor(np.random.default_rng(0).standard_normal(cd.n), dtype=torch.float32,
                         device=dev)
    for route in ("packed", "dense"):
        with forced_route(route == "packed"):
            ms, x, info = timed(fused_bicgstab_solve, cd, bc, steps=BICG_STEPS)
        print(f"  fused BiCGStab convdiff-512 ({route} route): {int(info.iterations)} its, "
              f"{ms:.5f} ms/it, rnorm_history and x sha256 {digest(info.rnorm_history, x)}  "
              f"[{card}]")
    # the portable DIA loop on poisson3d_48 as --layout auto loads it: the
    # tester's tolerance, then 256 full passes
    p3dia = load_matrix(os.path.join(ROOT, MATRICES[0]), layout="auto", dtype=np.float32,
                        device=dev)
    _, info = cg_solve(p3dia, bp, tol=TOL_SOLVE_REL * bnorm(p3dia.n))
    print(f"  portable DIA CG poisson3d_48 (--layout auto, tol 1e-5 ||b||): "
          f"{int(info.iterations)} its, rho_history sha256 {digest(info.rho_history)}  [{card}]")
    ms, x, info = timed(cg_solve, p3dia, bp)
    print(f"  portable DIA CG poisson3d_48 (--layout auto): {ms:.5f} ms/it over 256 steps, "
          f"rho_history and x sha256 {digest(info.rho_history, x)}  [{card}]")
    update_hashes(dev, card)
    bicg_dia_hashes(dev, card)
    banded_hashes(dev, big, card)
    sharded_hashes(dev, card)
    for name, t in update_rows(dev).items():
        print_time_row(name, t, card)
    for name, t in banded_rows(dev, big).items():
        print_time_row(name, t, card)
    banded_ring_report(dev, big, card)
    for name, t in bicg_dia_rows(dev).items():
        print_time_row(name, t, card)
    elementwise_floor(dev, card)


# ---- implicit gradients (solver/autodiff.py) and the row-sharded layouts ------------------

AUTODIFF_KERNELS = ("sym_fused_dir_spmv_dot", "fused_dir_spmv_dot", "fused_update_dot",
                    "dia_spmv_rows")
SHARDED_LAYOUT_KERNELS = ("dia_spmv", "fused_dir_spmv_dot", "fused_update_dot", "bell_spmv")
AD_TOL_REL = 1e-5  # the float32 CG solves: 1e-5 ||b||
AD_TOL64_REL = 1e-13  # the float64 plain-route reference and the finite differences
AD_GRAD_RTOL = 1e-4  # a float32 CG gradient against float64's, in 2-norm
AD_GMRES_STEPS = 64  # GMRES(32) on the 1M lane: two cycles at tol 0 (it converges in ~1e4)
# after 64 steps the float32 and float64 gradients part by 2e-5 (b) and 9e-5
# (diagonals) on the CPU at nx = 512; 1e-3 leaves room for the larger n
AD_GMRES_RTOL = 1e-3
AD_FD_EPS = 1e-5  # central difference step along a unit-variance direction (float64)
AD_FD_RTOL = 1e-3  # <g, D> of a float32 CG gradient against the float64 difference
AD_FD64_RTOL = 1e-6  # <g, D> of a float64 gradient against it
# float32 GMRES to 1e-5 ||b|| on convdiff nx = 64 (condition ~1e3): <g, D> to
# 5e-3 of the difference (8e-4 measured on the CPU)
AD_GMRES_FD_RTOL = 5e-3
AD_GMRES_FD_NX = 64  # the GMRES solve that converges, for its finite difference
LAYOUT_STEPS = 24  # fixed-step trajectories against the one-card solves (s = 4 blocks)
# float32 solves to a tolerance, sharded against one card: the sums run in
# another order, so the test of the last step may fall one step (one s-step
# block) either way
LAYOUT_ITER_SLACK = 1
POWERLAW_N = 1_572_864  # bench.py:556's irregular lane at the north-star scale


@contextlib.contextmanager
def recorded(module, name):
    """The info of every call of ``module.name`` (a solver returning (x,
    info)) while the block runs."""
    seen = []
    orig = getattr(module, name)

    def spy(*args, **kwargs):
        out = orig(*args, **kwargs)
        seen.append(out[1])
        return out

    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, orig)


def launch_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


def rel2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def ad_gradients(solve, op, fields, b, c, **kw):
    """x, info, the gradients of <c, x> in (b, *fields), the forward and
    backward ms, their kernel launches, and whether a second backward pass
    over the same graph gives the same bits."""
    import dataclasses

    import torch

    from conjugategradient_tpu_torch.ops.cuda import _common

    leaves = [getattr(op, f).detach().clone().requires_grad_() for f in fields]
    opg = dataclasses.replace(op, **dict(zip(fields, leaves)))
    bb = b.detach().clone().requires_grad_()
    torch.cuda.synchronize()
    l0, t0 = dict(_common.LAUNCHES), time.perf_counter()
    x, info = solve(opg, bb, **kw)
    torch.cuda.synchronize()
    l1, t1 = dict(_common.LAUNCHES), time.perf_counter()
    loss = torch.dot(c, x)
    g = torch.autograd.grad(loss, [bb, *leaves], retain_graph=True)
    torch.cuda.synchronize()
    l2, t2 = dict(_common.LAUNCHES), time.perf_counter()
    g2 = torch.autograd.grad(loss, [bb, *leaves])
    same = all(torch.equal(u.view(torch.uint8), v.view(torch.uint8)) for u, v in zip(g, g2))
    return (x, info, g, 1e3 * (t1 - t0), 1e3 * (t2 - t1), launch_delta(l0, l1),
            launch_delta(l1, l2), same)


def fd_directional(solve, op64, fields, D, b64, c64, **kw) -> float:
    """(L(θ + εD) − L(θ − εD)) / 2ε for L = <c, x(θ)>, in float64."""
    import dataclasses

    import torch

    def loss(sign):
        o = dataclasses.replace(op64, **{f: getattr(op64, f) + sign * AD_FD_EPS * d
                                         for f, d in zip(fields, D)})
        x, _ = solve(o, b64, **kw)
        return float(torch.dot(c64, x))

    return (loss(1.0) - loss(-1.0)) / (2 * AD_FD_EPS)


def tridiag_directions(big, big_full, seed=3):
    """One seeded SYMMETRIC perturbation of the block-tridiagonal operator
    in both storages: symmetric diagonal tiles Dd and upper tiles Doff in
    symmetric storage; in full storage the same, each lower tile the
    transpose of its upper mirror, padding slots 0.  Float64."""
    import torch

    dev = big.device
    nrb, bn = big.diag_blocks.shape[0], big.bn
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    Dd = torch.randn((nrb, bn, bn), generator=gen, dtype=torch.float64, device=dev)
    Dd = 0.5 * (Dd + Dd.transpose(1, 2))
    Doff = torch.randn((nrb, bn, bn), generator=gen, dtype=torch.float64, device=dev)
    i = torch.arange(nrb, device=dev)
    pad = big.off_cols[:, 0].long() == i  # the last block-row's slot
    Doff = torch.where(pad[:, None, None], 0.0, Doff)
    sym = (Dd, Doff[:, None])
    j = big_full.block_cols.long()
    ii = i[:, None].expand_as(j)
    real = big_full.blocks.reshape(nrb, j.shape[1], -1).ne(0).any(dim=2)
    full = torch.where((j == ii)[..., None, None], Dd[ii],
                       torch.where((j == ii + 1)[..., None, None], Doff[ii],
                                   torch.where((j == ii - 1)[..., None, None],
                                               Doff[j].transpose(-1, -2), 0.0)))
    full = torch.where(real[..., None, None], full, 0.0)
    return sym, (full,)


def phase_autodiff_path(dev, big, big_full, card):
    """implicit_cg_solve on the n = 262,144 block-tridiagonal operator in
    both storages (forward and adjoint on the fused kernels 1 or 4, and 2)
    and implicit_gmres_solve on the GMRES lane's 1M-row DIA operator
    (kernel 7 a forward step; the adjoint's transposed matvec is the plain
    DIA product's VJP): the gradients of <c, x> in b and in the stored
    values against float64 on the plain route, against a central
    difference along one seeded direction, two backward passes' bits."""
    import dataclasses

    import torch

    from conjugategradient_tpu_torch import (CSRMatrix, DIAMatrix, cg_solve, gmres_solve,
                                             implicit_cg_solve, implicit_gmres_solve)
    from conjugategradient_tpu_torch.problems import convection_diffusion_2d_coo
    from conjugategradient_tpu_torch.solver import autodiff

    # warm-up, untimed: the first backward pass of a process imports and
    # initialises what autograd and torch.func need (seconds, once)
    w_full, w_sym = block_tridiag_ops(4096, 128, dev)
    w = torch.ones(4096, dtype=torch.float32, device=dev)
    for a, fields in ((w_sym, ("diag_blocks", "off_blocks")), (w_full, ("blocks",))):
        ad_gradients(implicit_cg_solve, a, fields, w, w, tol=1e-3)
    wv, wc, wp, wshape = convdiff_csr(32)
    w_dia = DIAMatrix.from_csr_host(wv, wc, wp, wshape, device=dev)
    w = torch.ones(wshape[0], dtype=torch.float32, device=dev)
    ad_gradients(implicit_gmres_solve, w_dia, ("diags",), w, w, tol=0.0, maxiter=8, restart=4)
    del w_full, w_sym, w_dia

    n = N_BIG
    rng = np.random.default_rng(0)
    b = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32, device=dev)
    c = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32, device=dev)
    b64, c64 = b.double(), c.double()
    tol, tol64 = AD_TOL_REL * float(b.norm()), AD_TOL64_REL * float(b64.norm())
    d_sym, d_full = tridiag_directions(big, big_full)
    for label, a, fields, D in (("symmetric storage (K1, K2)", big, ("diag_blocks", "off_blocks"),
                                 d_sym),
                                ("full storage (K4, K2)", big_full, ("blocks",), d_full)):
        with recorded(autodiff, "cg_solve") as infos:
            x, info, g, fwd_ms, bwd_ms, lf, lb, same = ad_gradients(
                implicit_cg_solve, a, fields, b, c, tol=tol)
        k, k_adj = int(info.iterations), int(infos[-1].iterations)
        a64 = dataclasses.replace(a, **{f: getattr(a, f).double() for f in fields})
        _, i64, g64, *_ = ad_gradients(implicit_cg_solve, a64, fields, b64, c64, tol=tol64,
                                       fused="never")
        errs = [rel2(u, v) for u, v in zip(g, g64)]
        pred = sum(float((u.double() * d).sum()) for u, d in zip(g[1:], D))
        fd = fd_directional(cg_solve, a64, fields, D, b64, c64, tol=tol64, fused="never")
        fd_err = abs(pred - fd) / abs(fd)
        check(bool(info.converged) and bool(infos[-1].converged),
              f"autodiff CG {label}: forward or adjoint did not converge")
        check(max(errs) <= AD_GRAD_RTOL,
              f"autodiff CG {label}: gradients against float64 {errs}")
        check(fd_err <= AD_FD_RTOL, f"autodiff CG {label}: <g, D> {pred} against the central "
                                    f"difference {fd} ({fd_err})")
        fused_name = "sym_fused_dir_spmv_dot" if "symmetric" in label else "fused_dir_spmv_dot"
        check(lf.get(fused_name, 0) > 0 and lb.get(fused_name, 0) > 0
              and lb.get("fused_update_dot", 0) > 0,
              f"autodiff CG {label}: the fused kernels did not carry forward and adjoint "
              f"({lf}, {lb})")
        print(f"  implicit_cg_solve n={n} {label}, f32, tol {AD_TOL_REL:g} ||b||: forward "
              f"{fwd_ms:.3f} ms ({k} its; launches {lf}), backward {bwd_ms:.3f} ms (adjoint "
              f"{k_adj} its, float64 forward {int(i64.iterations)}; launches {lb}); "
              f"backward/forward {bwd_ms / fwd_ms:.2f}; against float64 on the plain route "
              f"(2-norm, b then {', '.join(fields)}): {', '.join(f'{e:.2e}' for e in errs)}; "
              f"<g, D> {pred:.9e} against the central difference {fd:.9e} (rel "
              f"{fd_err:.2e}); two backward passes bit-equal: {same}; hash "
              f"{digest(*g)}  [{card}]")
        del a64, g, g64, x

    # GMRES(32) on bench.py's DIA lane, two cycles at tol 0
    v, cc, p, shape = convdiff_csr(GMRES_NX)
    dia = DIAMatrix.from_csr_host(v, cc, p, shape, device=dev)
    nd = shape[0]
    bd = torch.arange(1, nd + 1, dtype=torch.float32, device=dev) / nd
    cd = torch.as_tensor(rng.standard_normal(nd), dtype=torch.float32, device=dev)
    kw = dict(tol=0.0, maxiter=AD_GMRES_STEPS, restart=GMRES_RESTART)
    with recorded(autodiff, "gmres_solve") as infos:
        _, info, g, fwd_ms, bwd_ms, lf, lb, same = ad_gradients(
            implicit_gmres_solve, dia, ("diags",), bd, cd, **kw)
    k, k_adj = int(info.iterations), int(infos[-1].iterations)
    d64 = dataclasses.replace(dia, diags=dia.diags.double())
    _, _, g64, *_ = ad_gradients(implicit_gmres_solve, d64, ("diags",), bd.double(),
                                 cd.double(), **kw)
    errs = [rel2(u, v) for u, v in zip(g, g64)]
    check(k == k_adj == AD_GMRES_STEPS, f"autodiff GMRES 1M: {k} / {k_adj} steps")
    check(max(errs) <= AD_GMRES_RTOL, f"autodiff GMRES 1M: gradients against float64 {errs}")
    check(lf.get("dia_spmv_rows", 0) >= AD_GMRES_STEPS,
          f"autodiff GMRES 1M: dia_spmv_rows launched {lf} in the forward")
    print(f"  implicit_gmres_solve convdiff DIA n={nd}, GMRES({GMRES_RESTART}) {AD_GMRES_STEPS} "
          f"steps at tol 0, f32: forward {fwd_ms:.3f} ms ({k} steps; launches {lf}), backward "
          f"{bwd_ms:.3f} ms (adjoint {k_adj} steps on the plain DIA product's VJP; launches "
          f"{lb}); backward/forward {bwd_ms / fwd_ms:.2f}; against float64 (b, diags): "
          f"{errs[0]:.2e}, {errs[1]:.2e}; two backward passes bit-equal: {same}; hash "
          f"{digest(*g)}  [{card}]")
    del dia, d64, g, g64

    # the finite difference needs a solve at its solution: GMRES(32) on
    # convdiff nx = 64, float32 on kernel 7 and float64 on the plain route
    rows, cols, vals, shp = convection_diffusion_2d_coo(AD_GMRES_FD_NX, peclet=10.0)
    small = DIAMatrix.from_csr(CSRMatrix.from_coo(rows, cols, vals, shp, dtype=np.float32,
                                                  device=dev))
    ns = shp[0]
    bs = torch.as_tensor(rng.standard_normal(ns), dtype=torch.float32, device=dev)
    cs = torch.as_tensor(rng.standard_normal(ns), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    D = torch.randn(small.diags.shape, generator=gen, dtype=torch.float64, device=dev)
    with recorded(autodiff, "gmres_solve") as infos:
        _, info, g, fwd_ms, bwd_ms, lf, lb, same = ad_gradients(
            implicit_gmres_solve, small, ("diags",), bs, cs, tol=AD_TOL_REL * float(bs.norm()),
            maxiter=20 * ns, restart=GMRES_RESTART)
    s64 = dataclasses.replace(small, diags=small.diags.double())
    kw64 = dict(tol=AD_TOL64_REL * float(bs.double().norm()), maxiter=20 * ns,
                restart=GMRES_RESTART)
    _, i64, g64, *_ = ad_gradients(implicit_gmres_solve, s64, ("diags",), bs.double(),
                                   cs.double(), **kw64)
    fd = fd_directional(gmres_solve, s64, ("diags",), (D,), bs.double(), cs.double(), **kw64)
    pred, pred64 = float((g[1].double() * D).sum()), float((g64[1] * D).sum())
    fd_err, fd_err64 = abs(pred - fd) / abs(fd), abs(pred64 - fd) / abs(fd)
    check(bool(info.converged) and bool(infos[-1].converged) and bool(i64.converged),
          "autodiff GMRES nx=64: a solve did not converge")
    check(fd_err <= AD_GMRES_FD_RTOL and fd_err64 <= AD_FD64_RTOL,
          f"autodiff GMRES nx=64: <g, D> {pred} (float64 {pred64}) against {fd}")
    print(f"  implicit_gmres_solve convdiff DIA n={ns} to {AD_TOL_REL:g} ||b||, f32 on kernel "
          f"7: {int(info.iterations)} steps forward, {int(infos[-1].iterations)} adjoint; "
          f"<g, D> {pred:.9e} (float64 route {pred64:.9e}) against the central difference "
          f"{fd:.9e}: rel {fd_err:.2e} ({fd_err64:.2e}); two backward passes bit-equal: "
          f"{same}  [{card}]")
    torch.cuda.synchronize()


def symbell_split(blocks, cols, n_shards):
    """The block-tridiagonal full-storage tiles (nrb, 3, bn, bn) and their
    block columns (nrb, 3) (torch) as ``partition_symbell_rows`` shards them
    (bn tiles, n_shards | nrb), built from the tiles on their device:
    building the CSR of ~100 M nonzeros to partition it would take most of
    a minute on the host, and the CPU tests hold this split equal to the
    partitioner on a small operator."""
    import torch

    nrb, _, bn, _ = blocks.shape
    L = nrb // n_shards
    dev = blocks.device
    i = torch.arange(nrb, device=dev)
    colsl = cols.long()

    def tile_at(col):
        hit = (colsl == col[:, None]).to(blocks.dtype)
        return torch.einsum("rk,rkmn->rmn", hit, blocks)

    r = i % L
    last = r == L - 1
    diag = tile_at(i).view(n_shards, L, bn, bn)
    up = tile_at(i + 1)
    off = torch.where(last[:, None, None], 0.0, up).view(n_shards, L, 1, bn, bn)
    off_cols = torch.where(last, r, r + 1).to(torch.int32).view(n_shards, L, 1)
    lo = tile_at(i - 1)
    rows = [([0] if s else []) + ([L - 1] if s < n_shards - 1 else []) for s in range(n_shards)]
    nxr = max(max(len(rs) for rs in rows), 1)
    cross = torch.zeros((n_shards, nxr, 1, bn, bn), dtype=blocks.dtype, device=dev)
    cross_rows = torch.zeros((n_shards, nxr), dtype=torch.int32, device=dev)
    cross_cols = torch.zeros((n_shards, nxr, 1), dtype=torch.int32, device=dev)
    for s, rs in enumerate(rows):
        for slot, rr in enumerate(rs):
            g = s * L + rr
            cross[s, slot, 0] = lo[g] if rr == 0 and s else up[g]
            cross_rows[s, slot] = rr
            cross_cols[s, slot, 0] = g - 1 if rr == 0 and s else g + 1
    return diag, off, off_cols, cross, cross_rows, cross_cols


def layout_timed(label, run, card) -> None:
    """ms/it of a sharded solve (``run``: every step live) and its device
    ms a step (these loops are host-bound: printed, not judged)."""
    import torch

    from conjugategradient_tpu_torch.utils import Timer

    run()
    t = Timer(torch.device(DEVICE)).start_measure()
    _, info = run()
    t.stop_measure()
    k = max(int(info.iterations), 1)
    busy = device_ms(run, reps=1)
    busy_s = "not measured" if busy is None else f"{busy / k:.4f}"
    print(f"  {label}: {k} steps, {t.get_duration() / k:.4f} ms/it, device {busy_s} ms a step "
          f"(host-bound: not judged)  [{card}]")


def layout_parity(label, sharded, one, squared_one: bool, k: int, min_used: int) -> str:
    """The sharded history against the one-card solve's (norms squared
    where the one-card info holds norms), above the float32 floor."""
    h1 = one.rnorm_history ** 2 if squared_one else one.rho_history
    ok, used = trajectory_ok(sharded.rho_history, h1, k)
    hs, ho = (h[1:k + 1].double().cpu().numpy() for h in (sharded.rho_history, h1))
    keep = ho > 1e-10 * float(h1[0])
    worst = float(np.abs(hs[keep] / ho[keep] - 1).max()) if keep.any() else 0.0
    check(ok and used >= min_used,
          f"{label}: rho_history parts by {worst:.3g} (rtol {TRAJ_RTOL}) from the one-card "
          f"solve's, {used} entries above the float32 floor")
    return f"{used}"


def phase_sharded_layouts_path(dev, big, big_full, shard_ops, dia_ops, card):
    """The symmetric blocked-ELL, DIA, symmetric DIA and SELL front ends and
    the sharded methods, on one card, against the one-card solves of the
    same operators (module doc, phase 3)."""
    import torch

    from conjugategradient_tpu_torch import (bicgstab_solve, cg_solve, gmres_solve,
                                             jacobi_preconditioner, minres_solve)
    from conjugategradient_tpu_torch.parallel import (make_row_mesh, partition_dia_rows,
                                                      sharded_dia_cg_solve,
                                                      sharded_sell_cg_solve,
                                                      sharded_symbell_cg_solve,
                                                      sharded_symdia_cg_solve)
    from conjugategradient_tpu_torch.solver.pipelined import pipelined_cg_solve
    from conjugategradient_tpu_torch.solver.sstep import sstep_cg_solve

    n = N_BIG
    b = torch.as_tensor(np.random.default_rng(9).standard_normal(n), dtype=torch.float32,
                        device=dev)
    tol = TOL_SOLVE_REL * float(b.norm())
    hashes = []

    # (a) symmetric blocked-ELL on the n = 262,144 operator at P = 4 and 8:
    # CG to 1e-5 ||b|| against the single card's fused CG (equal counts,
    # tests/test_sharded.py:822), then every method for LAYOUT_STEPS steps
    # on the cut operator (cut_tridiag_ops) against its one-card solve
    x1, i1 = cg_solve(big, b, tol=tol)
    for n_shards in (4, 8):
        parts = symbell_split(big_full.blocks, big_full.block_cols, n_shards)
        g = make_row_mesh(n_shards, dev)
        xs, is_ = sharded_symbell_cg_solve(*parts, b, mesh=g, tol=tol)
        e, m = rel_max_err(xs, x1)
        check(int(is_.iterations) == int(i1.iterations) and bool(is_.converged)
              and e <= 1e-4 * m,
              f"sharded symbell CG P={n_shards}: {int(is_.iterations)} its against "
              f"{int(i1.iterations)}, x differs by {e}")
        print(f"  sharded symbell CG n={n} P={n_shards} to {TOL_SOLVE_REL:g} ||b||: "
              f"{int(is_.iterations)} its as the single card's fused CG, x to {e / m:.2e} of "
              f"max|x|; collectives {g.counts}")
    cut_full, cut_ops, cut_inv = cut_tridiag_ops(*shard_ops, big_full.nnz)
    jac = jacobi_preconditioner(cut_full)
    steps = LAYOUT_STEPS
    one = {
        "standard": (cg_solve(cut_full, b, tol=0.0, maxiter=steps)[1], False),
        "jacobi": (cg_solve(cut_full, b, tol=0.0, maxiter=steps, M=jac)[1], False),
        "pipelined": (pipelined_cg_solve(cut_full, b, tol=0.0, maxiter=steps)[1], False),
        "sstep": (sstep_cg_solve(cut_full, b, s=4, tol=0.0, maxiter=steps)[1], False),
        "minres": (minres_solve(cut_full, b, tol=0.0, maxiter=steps)[1], True),
        "bicgstab": (bicgstab_solve(cut_full, b, tol=0.0, maxiter=steps)[1], True),
        "gmres": (gmres_solve(cut_full, b, tol=0.0, maxiter=steps)[1], True),
    }
    cut_blocks = cut_full.blocks
    used = []
    for n_shards in (4, 8):
        parts = symbell_split(cut_blocks, cut_full.block_cols, n_shards)
        for name, (info1, squared) in one.items():
            kw = dict(method="standard" if name == "jacobi" else name)
            if name == "jacobi":
                kw["inv_diag"] = cut_inv
            run = (lambda kw=kw: sharded_symbell_cg_solve(
                *parts, b, mesh=make_row_mesh(n_shards, dev), tol=0.0, maxiter=steps, **kw))
            xs, is_ = run()
            check(int(is_.iterations) == int(info1.iterations),
                  f"sharded symbell {name} P={n_shards}: {int(is_.iterations)} steps against "
                  f"{int(info1.iterations)}")
            # BiCGStab on a symmetric operator amplifies the sums' rounding
            # (the fused and portable loops part by 5e-2 after step 15)
            k_cmp = 15 if name == "bicgstab" else steps
            # s-step records block boundaries only: steps / 4 entries
            min_used = steps // 4 if name == "sstep" else PARITY_MIN_USED
            used.append(f"{name} P={n_shards} " + layout_parity(
                f"sharded symbell {name} P={n_shards}", is_, info1, squared, k_cmp, min_used))
            xs2, is2 = run()
            check(torch.equal(xs, xs2) and torch.equal(is_.rho_history.view(torch.int32),
                                                       is2.rho_history.view(torch.int32)),
                  f"sharded symbell {name} P={n_shards}: two runs differ")
            hashes.append(f"symbell {name} P={n_shards} {digest(is_.rho_history, xs)}")
            if n_shards == 8:
                layout_timed(f"sharded symbell {name} n={n} P=8", run, card)
    print(f"  sharded symbell, every method, {steps} steps on the cut operator against the "
          f"one-card solve: entries above the float32 floor {', '.join(used)}; each twice "
          f"bit for bit")
    del cut_full, cut_ops, parts

    # (b) symdia-big (n = 2,097,152, 41 diagonals / 21 stored) at P = 4: DIA
    # standard and s-step (the matrix-powers basis), SymDIA standard and
    # pipelined (the JAX front end refuses s-step there)
    big_dia, big_sym = dia_ops["big"], dia_ops["big_sym"]
    nd = big_dia.n
    bd = torch.as_tensor(np.random.default_rng(10).standard_normal(nd), dtype=torch.float32,
                         device=dev)
    tol_d = TOL_SOLVE_REL * float(bd.norm())
    for label, a, front, methods in (
            ("DIA", big_dia, sharded_dia_cg_solve, ("standard", "sstep")),
            ("SymDIA", big_sym, sharded_symdia_cg_solve, ("standard", "pipelined"))):
        diags, n_pad = partition_dia_rows(a.diags.cpu().numpy(), a.shape, 4)
        diags = torch.as_tensor(diags, device=dev)  # on the card once, not per solve
        for method in methods:
            ref = {"standard": cg_solve, "sstep": sstep_cg_solve,
                   "pipelined": pipelined_cg_solve}[method]
            x1, i1 = ref(a, bd, tol=tol_d)
            run = (lambda method=method: front(diags, a.offsets, bd, mesh=make_row_mesh(4, dev),
                                               tol=tol_d, method=method))
            xs, is_ = run()
            e, m = rel_max_err(xs, x1)
            slack = LAYOUT_ITER_SLACK * (4 if method == "sstep" else 1)
            check(bool(is_.converged) and abs(int(is_.iterations) - int(i1.iterations)) <= slack
                  and e <= 1e-4 * m,
                  f"sharded {label} {method} symdia-big P=4: {int(is_.iterations)} its against "
                  f"{int(i1.iterations)}, x differs by {e}")
            hashes.append(f"{label} {method} P=4 {digest(is_.rho_history, xs)}")
            layout_timed(f"sharded {label} {method} symdia-big n={nd} P=4 "
                         f"({int(is_.iterations)} its, the single card {int(i1.iterations)}, "
                         f"x to {e / m:.2e})", run, card)
        del diags

    # (c) SELL on the irregular power-law pattern at P = 4: CG to 1e-5 ||b||
    # against the single card's; s-step against the single card's s-step
    # over its first three blocks.  On this operator s-step's first block
    # raises ||r||^2 16-fold and the two sum orders part by ~1e-3 (float32)
    # and ~1e-10 (float64) over three blocks, then by 0.1-0.5 in the fourth
    # or fifth in either dtype (CPU, n = 200,000): a chaotic trajectory,
    # not one to hold further.  Each is timed over LAYOUT_STEPS steps
    parts, sell, nnz, secs = powerlaw_parts(dev)
    print(f"  power-law n={POWERLAW_N} nnz={nnz}: built and partitioned in {secs:.1f} s (host)")
    bp = torch.zeros(parts[-1], dtype=torch.float32, device=dev)
    bp[:POWERLAW_N] = torch.as_tensor(np.random.default_rng(11).standard_normal(POWERLAW_N),
                                      dtype=torch.float32, device=dev)
    tol_p = TOL_SOLVE_REL * float(bp.norm())

    def sell_run(method, tol, steps=None):
        return sharded_sell_cg_solve(parts, bp, mesh=make_row_mesh(4, dev), tol=tol,
                                     maxiter=steps, method=method)

    x1, i1 = cg_solve(sell, bp[:POWERLAW_N], tol=tol_p)
    xs, is_ = sell_run("standard", tol_p)
    e, m = rel_max_err(xs[:POWERLAW_N], x1)
    check(bool(is_.converged) and abs(int(is_.iterations) - int(i1.iterations))
          <= LAYOUT_ITER_SLACK and e <= 1e-4 * m,
          f"sharded SELL CG power-law P=4: {int(is_.iterations)} its against "
          f"{int(i1.iterations)}, x differs by {e}")
    hashes.append(f"SELL standard P=4 {digest(is_.rho_history, xs)}")
    print(f"  sharded SELL CG power-law n={POWERLAW_N} P=4 to {TOL_SOLVE_REL:g} ||b||: "
          f"{int(is_.iterations)} its, the single card {int(i1.iterations)}, x to {e / m:.2e}")
    _, o_s = sstep_cg_solve(sell, bp[:POWERLAW_N], s=4, tol=0.0, maxiter=steps)
    xs, is_ = sell_run("sstep", 0.0, steps)
    used_s = layout_parity("sharded SELL sstep power-law P=4", is_, o_s, False, 12, 3)
    hashes.append(f"SELL sstep P=4 {digest(is_.rho_history, xs)}")
    print(f"  sharded SELL s-step power-law P=4, {steps} steps: the first {used_s} block "
          f"entries agree with the single card's s-step")
    for method in ("standard", "sstep"):
        layout_timed(f"sharded SELL {method} power-law n={POWERLAW_N} P=4",
                     lambda method=method: sell_run(method, 0.0, steps), card)
    print("  sharded layouts hashes (history and x): " + "; ".join(hashes))
    torch.cuda.synchronize()


FAMILY_KERNELS = ("bell_spmv", "bell_spmv_packed", "dia_spmv", "stencil7_staged", "stencil7")
STATE_STEPS = 64  # the blocked-ELL state API at tol = -1, in STATE_CHUNKS chunks
STATE_CHUNKS = 4
STATE_DIA_CHUNK = 2  # steps a chunk of the DIA solve to tolerance (6 its: 3 files)
STATE_SELL_CHUNK = 100  # and of the SELL one (565 its: 6 files)
BATCH_R = 8
FAMILY_LOBPCG_STEPS = 24  # the fixed-count LOBPCG runs that are timed
FAMILY_TIMED_STEPS = 64  # the fixed-count runs of the longer solves that are timed
# The float32 preconditioned solves' counts are held equal to the one-card
# counts at a tolerance float32 reaches on the operator: the one-card
# float32 solves to 1e-5 (256^3) and 1e-6 (poisson2d(512)) ||b|| end at a
# true relative residual of about 1e-3 (MG-PCG), 3.6e-3 (SA-AMG) and 2.4e-2
# (FSAI(1)) on an H100, so below those the recurrences carry rounding, not
# the operator, and two summation orders part.  The float64 solves are held
# equal at the full tolerances.  Each float32 solve's true residual must
# come within F32_TRUE_SLACK of its tolerance.
F32_REACHABLE_TOL = {"MG-PCG": 1e-2, "SA-AMG": 1e-2, "FSAI(1)": 1e-1}
F32_TRUE_SLACK = 2.0


def grid_split(blocks, cols, p: int):
    """The block-tridiagonal tiles (nrb, 3, bn, bn) and their block columns
    (nrb, 3) (torch) as ``partition_csr_blocks_2d`` splits them into a
    p x p grid: each block row's tiles that fall in column stripe j,
    ascending, LOCAL column ids, zero tiles at column 0 after them (a zero
    tile of the input is padding, as the CSR holds no entry there); built
    from the tiles on their device (the CSR of ~100 M nonzeros would take
    most of a minute on the host; the CPU tests hold this split equal to
    the partitioner on a small operator)."""
    import torch

    nrb, slots, bn, _ = blocks.shape
    L = nrb // p
    dev = blocks.device
    parts, col_parts, kmax = [], [], 1
    rows = torch.arange(L, device=dev)[:, None]
    for i in range(p):
        rb, rc = blocks[i * L:(i + 1) * L], cols[i * L:(i + 1) * L].long()
        row_b, row_c = [], []
        real = rb.abs().amax(dim=(-2, -1)) > 0  # padding slots: zero tiles at column 0
        for j in range(p):
            keep = ((rc // L) == j) & real
            order = torch.argsort(torch.where(keep, rc, nrb), dim=1, stable=True)
            kept = torch.gather(keep, 1, order)
            kmax = max(kmax, int(kept.sum(dim=1).max()))
            row_b.append(torch.where(kept[..., None, None], rb[rows, order], 0.0))
            row_c.append(torch.where(kept, torch.gather(rc, 1, order) - j * L, 0).to(torch.int32))
        parts.append(torch.stack(row_b))
        col_parts.append(torch.stack(row_c))
    return (torch.stack(parts)[:, :, :, :kmax].contiguous(),
            torch.stack(col_parts)[:, :, :, :kmax].contiguous())


@functools.lru_cache(maxsize=1)
def powerlaw_parts(dev, n_shards=4):
    """The power-law SELL operator (POWERLAW_N rows, bench.py:556's pattern)
    as ``partition_sell_rows`` shards it, on the card, its one-card
    SellMatrix, its nonzeros and the host seconds the build took; built
    once a run (both sharded paths take it)."""
    import torch

    from conjugategradient_tpu_torch import SellMatrix
    from conjugategradient_tpu_torch.parallel import partition_sell_rows
    from conjugategradient_tpu_torch.problems import powerlaw_spd_coo

    t0 = time.perf_counter()
    rows, cols, vals, shp = powerlaw_spd_coo(POWERLAW_N, avg_degree=4.8, seed=0)
    order = np.lexsort((cols, rows))
    r_, c_, v_ = rows[order], cols[order], vals[order].astype(np.float32)
    indptr = np.zeros(POWERLAW_N + 1, np.int64)
    np.add.at(indptr, r_ + 1, 1)
    indptr = np.cumsum(indptr)
    parts = partition_sell_rows(v_, c_, indptr, shp, n_shards)
    parts = tuple(torch.as_tensor(a, device=dev) for a in parts[:4]) + parts[4:]
    sell = SellMatrix.from_csr_host(v_, c_, indptr, shp, device=dev)
    return parts, sell, len(v_), time.perf_counter() - t0


def last_three(info, tol):
    """||r||/tol at a solve's last three history entries (its iterations
    k - 2 .. k)."""
    k = int(info.iterations)
    return info.rho_history[max(k - 2, 0):k + 1].double().sqrt().cpu() / tol


def launched(run, names):
    """``run()`` and the launches of each kernel in ``names`` it made."""
    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc

    before = {k: fc.LAUNCHES[k] for k in names}
    out = run()
    return out, {k: fc.LAUNCHES[k] - before[k] for k in names}


def timed_solve(run, card, label, steps_of=lambda out: int(out[1].iterations)) -> str:
    """One warm run, then ms an iteration (CUDA events) and device ms an
    iteration of ``run``; a line for the report (host-bound: not judged)."""
    import torch

    run()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    out = run()
    e1.record()
    e1.synchronize()
    k = max(steps_of(out), 1)
    busy = device_ms(run, reps=1)
    busy_s = "not measured" if busy is None else f"{busy / k:.4f}"
    return (f"  {label}: {k} its, {e0.elapsed_time(e1) / k:.4f} ms/it, device {busy_s} ms/it "
            f"(host-bound: not judged)  [{card}]")


def phase_sharded_families_path(dev, big, big_full, shard_ops, dia_ops, card):
    """The state API with its files, the 2-D grid, the batched solves, the
    sharded stencil, multigrid, AMG, FSAI and LOBPCG, on one card, against
    the one-card solves (module doc, phase 3)."""
    import tempfile

    import torch

    from conjugategradient_tpu_torch import (StencilOperator, block_cg_solve, cg_solve,
                                             cg_solve_batched, fsai_preconditioner,
                                             jacobi_preconditioner, lobpcg_eigs,
                                             multigrid_preconditioner,
                                             smoothed_aggregation_preconditioner)
    from conjugategradient_tpu_torch import parallel as tpar
    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.ops.cuda import stencil as ks
    from conjugategradient_tpu_torch.parallel.sharded_stencil import _local_stencil_matvec
    from conjugategradient_tpu_torch.solver.checkpoint import load_state, save_state
    from conjugategradient_tpu_torch.solver.pipelined import pipelined_cg_solve
    from conjugategradient_tpu_torch.solver.sstep import sstep_cg_solve

    t_phase = time.perf_counter()
    n = N_BIG
    b = torch.as_tensor(np.random.default_rng(12).standard_normal(n), dtype=torch.float32,
                        device=dev)
    tol = TOL_SOLVE_REL * float(b.norm())
    hashes = []
    g4 = tpar.make_row_mesh(4, dev)

    # (a) the state API, in chunks through files, against the uninterrupted
    # portable solve (use_fused="never" on the blocked-ELL shards)
    big_dia = dia_ops["big"]
    diags, _ = tpar.partition_dia_rows(big_dia.diags.cpu().numpy(), big_dia.shape, 4)
    diags = torch.as_tensor(diags, device=dev)
    bd = torch.as_tensor(np.random.default_rng(10).standard_normal(big_dia.n),
                         dtype=torch.float32, device=dev)
    tol_d = TOL_SOLVE_REL * float(bd.norm())
    sell_parts, _, _, secs = powerlaw_parts(dev)
    print(f"  power-law n={POWERLAW_N} SELL at P=4: built and partitioned in {secs:.1f} s (host; "
          f"once a run)")
    bp = torch.zeros(sell_parts[-1], dtype=torch.float32, device=dev)
    bp[:POWERLAW_N] = torch.as_tensor(np.random.default_rng(11).standard_normal(POWERLAW_N),
                                      dtype=torch.float32, device=dev)
    tol_p = TOL_SOLVE_REL * float(bp.norm())
    # the kernel each chunked run must launch (SELL's local product is plain)
    cases = (
        ("blocked-ELL n=262144 64 steps at tol -1", shard_ops, b, -1.0, STATE_STEPS,
         STATE_STEPS // STATE_CHUNKS, tpar.sharded_cg_solve, tpar.sharded_cg_init,
         tpar.sharded_run_cg, {"use_fused": "never"}, "bell_spmv"),
        (f"DIA symdia-big to {TOL_SOLVE_REL:g} ||b||", (diags, big_dia.offsets), bd, tol_d, None,
         STATE_DIA_CHUNK, tpar.sharded_dia_cg_solve, tpar.sharded_dia_cg_init,
         tpar.sharded_dia_run_cg, {}, "dia_spmv"),
        (f"SELL power-law to {TOL_SOLVE_REL:g} ||b||", (sell_parts,), bp, tol_p, None,
         STATE_SELL_CHUNK, tpar.sharded_sell_cg_solve, tpar.sharded_sell_cg_init,
         tpar.sharded_sell_run_cg, {}, None),
    )
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        for label, ops, rhs, tol_c, maxiter, chunk, solve, init, run, kw, kernel in cases:
            x_ref, info_ref = solve(*ops, rhs, mesh=g4, tol=tol_c, maxiter=maxiter, **kw)
            t0 = time.perf_counter()

            def chunked():
                state = init(*ops, rhs, mesh=g4, maxiter=maxiter)
                chunks = 0
                while bool(state.live):
                    state = run(*ops, state, tol=tol_c, steps=chunk, mesh=g4)
                    save_state(path, state)
                    state = load_state(path, device=dev)
                    chunks += 1
                return state, chunks

            (state, chunks), used = launched(chunked, ("bell_spmv", "dia_spmv"))
            secs = time.perf_counter() - t0
            x, info = tpar.sharded_state_result(state)
            h_ref, h = digest(info_ref.rho_history, x_ref), digest(info.rho_history, x)
            check(h == h_ref and int(info.iterations) == int(info_ref.iterations),
                  f"state API {label}: chunked {int(info.iterations)} its hash {h}, the "
                  f"uninterrupted solve {int(info_ref.iterations)} its hash {h_ref}")
            check(chunks > 1, f"state API {label}: ran in {chunks} chunk")
            check(kernel is None or used[kernel] >= 4 * int(info.iterations),
                  f"state API {label}: the chunked run launched {used} for "
                  f"{int(info.iterations)} its at P=4")
            hashes.append(f"state {label.split()[0]} P=4 {h}")
            print(f"  state API {label} P=4: {chunks} chunks through files ({secs:.2f} s), "
                  f"{int(info.iterations)} its, launches {used}; history and x sha256 {h}, the "
                  f"uninterrupted portable solve's {h_ref}  [{card}]")
    del sell_parts, bp

    print(f"  ({time.perf_counter() - t_phase:.1f} s into the phase)")
    # (b) the 2-D grid at p = 2: CG to tolerance on the n = 262,144 operator;
    # every single-RHS method for FAMILY steps on the cut operator
    grid_b, grid_c = grid_split(big_full.blocks, big_full.block_cols, 2)
    print(f"  2-D grid p=2 of the n={n} operator: blocks {tuple(grid_b.shape)}, "
          f"{grid_b.numel() * 4 / 1e6:.0f} MB of tiles")
    g2 = tpar.make_mesh_2d(2, dev)
    x1, i1 = cg_solve(big_full, b, tol=tol)
    (xs, is_), used = launched(lambda: tpar.sharded_cg_solve_2d(grid_b, grid_c, b, mesh=g2,
                                                                 tol=tol), ("bell_spmv",))
    e, m = rel_max_err(xs, x1)
    check(int(is_.iterations) == int(i1.iterations) and bool(is_.converged) and e <= 1e-4 * m,
          f"2-D CG p=2: {int(is_.iterations)} its against {int(i1.iterations)}, x by {e}")
    check(g2.counts["all_gather"] == 0, f"2-D CG p=2 all-gathered: {g2.counts}")
    check(used["bell_spmv"] >= 4 * int(is_.iterations),
          f"2-D CG p=2: {used} for {int(is_.iterations)} its on four blocks")
    hashes.append(f"2-D standard p=2 {digest(is_.rho_history, xs)}")
    print(f"  2-D CG p=2 n={n} to {TOL_SOLVE_REL:g} ||b||: {int(is_.iterations)} its as the "
          f"single card's, x to {e / m:.2e} of max|x|; collectives {g2.counts}; launches "
          f"{used}  [{card}]")
    del grid_b, grid_c
    cut_full, cut_ops, cut_inv = cut_tridiag_ops(*shard_ops, big_full.nnz)
    cut_b, cut_c = grid_split(cut_full.blocks, cut_full.block_cols, 2)
    steps = LAYOUT_STEPS
    jac = jacobi_preconditioner(cut_full)
    one = {"standard": cg_solve(cut_full, b, tol=0.0, maxiter=steps)[1],
           "jacobi": cg_solve(cut_full, b, tol=0.0, maxiter=steps, M=jac)[1],
           "pipelined": pipelined_cg_solve(cut_full, b, tol=0.0, maxiter=steps)[1],
           "sstep": sstep_cg_solve(cut_full, b, s=4, tol=0.0, maxiter=steps)[1]}
    used = []
    for name, info1 in one.items():
        kw = {"method": "standard" if name == "jacobi" else name}
        if name == "jacobi":
            kw["inv_diag"] = cut_inv
        g = tpar.make_mesh_2d(2, dev)
        (xs, is_), ran = launched(lambda: tpar.sharded_cg_solve_2d(
            cut_b, cut_c, b, mesh=g, tol=0.0, maxiter=steps, **kw), ("bell_spmv",))
        check(int(is_.iterations) == int(info1.iterations) and g.counts["all_gather"] == 0
              and ran["bell_spmv"] > 0,
              f"2-D {name} p=2: {int(is_.iterations)} steps against {int(info1.iterations)}, "
              f"collectives {g.counts}, launches {ran}")
        min_used = steps // 4 if name == "sstep" else PARITY_MIN_USED
        used.append(f"{name} " + layout_parity(f"2-D {name} p=2", is_, info1, False, steps,
                                               min_used))
        hashes.append(f"2-D {name} p=2 cut {digest(is_.rho_history, xs)}")
    print(f"  2-D p=2, {steps} steps on the cut operator against the one-card solves: entries "
          f"above the float32 floor {', '.join(used)}; no all_gather  [{card}]")
    print(timed_solve(lambda: tpar.sharded_cg_solve_2d(cut_b, cut_c, b, mesh=tpar.make_mesh_2d(
        2, dev), tol=0.0, maxiter=steps), card, f"2-D CG p=2 n={n}, {steps} steps"))

    print(f"  ({time.perf_counter() - t_phase:.1f} s into the phase)")
    # (c) the batched solves at R = 8: lockstep and block CG against the
    # one-card loops, per-lane counts
    def lanes(nn, seed):
        return torch.as_tensor(np.random.default_rng(seed).standard_normal((BATCH_R, nn)),
                               dtype=torch.float32, device=dev)

    B = lanes(n, 13)
    tol_b = TOL_SOLVE_REL * torch.linalg.vector_norm(B, dim=1)
    Bd = lanes(big_dia.n, 14)
    tol_bd = TOL_SOLVE_REL * torch.linalg.vector_norm(Bd, dim=1)
    one_card = {"lockstep": cg_solve_batched, "block": block_cg_solve}
    for label, op1, rhs, tols, run in (
            ("blocked-ELL cut P=4", cut_full, B, tol_b,
             lambda m: tpar.sharded_cg_solve_batched(*cut_ops[4], B, mesh=g4, tol=tol_b,
                                                     method=m)),
            ("DIA symdia-big P=4", big_dia, Bd, tol_bd,
             lambda m: tpar.sharded_dia_cg_solve_batched(diags, big_dia.offsets, Bd, mesh=g4,
                                                         tol=tol_bd, method=m)),
            ("2-D cut p=2", cut_full, B, tol_b,
             lambda m: tpar.sharded_cg_solve_2d_batched(cut_b, cut_c, B,
                                                        mesh=tpar.make_mesh_2d(2, dev),
                                                        tol=tol_b, method=m))):
        for method in ("lockstep", "block"):
            _, i1 = one_card[method](op1, rhs, tol=tols)
            Xs, is_ = run(method)
            ks_, k1 = is_.iterations.tolist(), i1.iterations.tolist()
            check(bool(is_.converged.all()) and ks_ == k1,
                  f"batched {method} {label}: per-lane its {ks_} against the one-card {k1}")
            hashes.append(f"batched {method} {label} {digest(is_.rho_history, Xs)}")
            print(f"  batched {method} R={BATCH_R} {label} to {TOL_SOLVE_REL:g} ||b_i||: per-lane "
                  f"its {ks_}, the one-card loop's {k1}  [{card}]")
        print(timed_solve(lambda: run("lockstep"), card, f"batched lockstep R={BATCH_R} {label}",
                          lambda out: int(out[1].iterations.max())))
        if not label.startswith("2-D"):  # its one-card loop is the blocked-ELL one
            print(timed_solve(lambda: cg_solve_batched(op1, rhs, tol=tols), card,
                              f"one-card lockstep R={BATCH_R} {label.split()[0]}",
                              lambda out: int(out[1].iterations.max())))
    del Bd, B, cut_b, cut_c, diags

    print(f"  ({time.perf_counter() - t_phase:.1f} s into the phase)")
    # (d) the sharded stencil at 256^3, P = 4: CG and MG-PCG against the
    # one-card portable CG and MG-PCG; one shard's product against the
    # slice of the one-card kernel 11 product
    op = StencilOperator.poisson(STENCIL_GRID, device=dev)
    ns = op.shape[0]
    bs = stencil_rhs(ns, dev, scale=ns)
    tol_s = TOL_SOLVE_REL * float(bs.double().norm())
    sx = STENCIL_GRID[0] // 4
    u = stencil_volume(STENCIL_GRID, torch.float32, dev, seed=60)
    whole = ks.stencil7(u, 6.0, -1.0)
    flat, m4 = u.reshape(-1), ns // 4
    parts = _local_stencil_matvec(g4, [flat[i * m4:(i + 1) * m4] for i in range(4)], 6.0, -1.0,
                                  (sx,) + STENCIL_GRID[1:])
    same = all(torch.equal(parts[i].view(torch.int32),
                           whole.reshape(-1)[i * m4:(i + 1) * m4].view(torch.int32))
               for i in range(4))
    check(same, "sharded stencil product: a shard differs from the one-card kernel 11 slice")
    print(f"  sharded stencil product 256^3 P=4: every shard's y bit for bit the one-card "
          f"kernel 11 slice (window route {ks.stencil_route(torch.empty((sx + 2,) + STENCIL_GRID[1:], device=dev))}, "
          f"whole volume {ks.stencil_route(u)})  [{card}]")
    del u, whole, parts
    # the V-cycle apply itself: the sharded one gives the one-card bits
    M1 = multigrid_preconditioner(op)
    Ms = tpar.sharded_multigrid_preconditioner(STENCIL_GRID, 4, dtype=torch.float32)
    r = torch.as_tensor(np.random.default_rng(15).standard_normal(ns), dtype=torch.float32,
                        device=dev)
    z1 = M1(r)
    zs = torch.cat(Ms.make_local_apply([], g4)([r[i * m4:(i + 1) * m4] for i in range(4)]))
    check(torch.equal(z1.view(torch.int32), zs.view(torch.int32)),
          "sharded V-cycle 256^3 P=4: the apply differs from the one-card apply")
    print(f"  sharded V-cycle apply 256^3 P=4: bit for bit the one-card apply  [{card}]")
    del r, z1, zs
    op64 = StencilOperator.poisson(STENCIL_GRID, dtype=torch.float64, device=dev)
    bs64 = bs.double()
    tol_mg = F32_REACHABLE_TOL["MG-PCG"] * float(bs64.norm())
    # each solve's tolerance and the kernel 11 routes its sharded run must take
    for label, op_, rhs, M1_, Ms_, tol_c, routes_in in (
            ("CG", op, bs, None, None, tol_s, ("stencil7_staged",)),
            ("MG-PCG", op, bs, M1, Ms, tol_mg, ("stencil7", "stencil7_staged")),
            ("MG-PCG float64", op64, bs64, multigrid_preconditioner(op64),
             tpar.sharded_multigrid_preconditioner(STENCIL_GRID, 4, dtype=torch.float64), tol_s,
             ("stencil7",))):
        x1, i1 = cg_solve(op_, rhs, tol=tol_c, M=M1_, fused="never")
        (xs, is_), routes = launched(lambda: tpar.sharded_stencil_cg_solve(
            STENCIL_GRID, rhs, mesh=g4, tol=tol_c, M_local=Ms_), ("stencil7", "stencil7_staged"))
        e, m = rel_max_err(xs, x1)
        true = float((op64.matvec(xs.double()) - bs64).norm() / bs64.norm())
        k = int(is_.iterations)
        check(bool(is_.converged) and k == int(i1.iterations) and e <= 1e-3 * m,
              f"sharded stencil {label} 256^3 P=4: {k} its against {int(i1.iterations)}, x by {e}")
        check(all(routes[r] > 0 for r in routes_in) and sum(routes.values()) >= 4 * k,
              f"sharded stencil {label} 256^3 P=4: kernel 11 launches by route {routes} in {k} its")
        check(label != "MG-PCG" or true <= F32_TRUE_SLACK * tol_c / float(bs64.norm()),
              f"sharded stencil {label} 256^3 P=4: true rel residual {true:.3e} at tol "
              f"{tol_c / float(bs64.norm()):g}")
        hashes.append(f"stencil {label} P=4 {digest(is_.rho_history, xs)}")
        tail = [f"{float(a):.4g}/{float(c):.4g}" for a, c in zip(
            last_three(is_, tol_c), last_three(i1, tol_c))]
        print(f"  sharded stencil {label} 256^3 P=4 to {tol_c / float(bs64.norm()):g} ||b||: "
              f"{k} its, the one-card {label}'s {int(i1.iterations)} (its history and x sha256 "
              f"{digest(i1.rho_history, x1)}); ||r||/tol of the last three, sharded/one-card: "
              f"{', '.join(tail)}; true rel residual {true:.3e}; kernel 11 launches by route "
              f"{routes}  [{card}]")
        if label == "MG-PCG float64":
            continue
        # timed over FAMILY_TIMED_STEPS live steps (tol 0), MG-PCG to tolerance
        t_tol, t_it = (tol_s, None) if M1_ is not None else (0.0, FAMILY_TIMED_STEPS)
        print(timed_solve(lambda: tpar.sharded_stencil_cg_solve(
            STENCIL_GRID, bs, mesh=g4, tol=t_tol, maxiter=t_it, M_local=Ms_), card,
            f"sharded stencil {label} 256^3 P=4"))
        print(timed_solve(lambda: cg_solve(op, bs, tol=t_tol, maxiter=t_it, M=M1_,
                                           fused="never"),
                          card, f"one-card portable {label} 256^3"))
    del op, bs, op64, bs64

    print(f"  ({time.perf_counter() - t_phase:.1f} s into the phase)")
    # (e) sharded SA-AMG and FSAI PCG on poisson2d(512) at P = 4
    A, host, ba = amg_case(dev)
    na = A.shape[0]
    h32 = host.astype(np.float32)
    h32.sort_indices()
    blocks_a, cols_a, n_pad_a = tpar.partition_csr_rows(h32.data, h32.indices, h32.indptr,
                                                        h32.shape, 4)
    blocks_a, cols_a = torch.as_tensor(blocks_a, device=dev), torch.as_tensor(cols_a, device=dev)
    b_pad = torch.zeros(n_pad_a, dtype=torch.float32, device=dev)
    b_pad[:na] = ba
    tol_a = AMG_TOL_REL * float(torch.linalg.vector_norm(ba.double()))
    A64 = A.astype(torch.float64)
    blocks_64, b_pad64 = blocks_a.double(), b_pad.double()
    # float32 at its reachable tolerance with the kernels it must launch
    # (kernel 5 on the solve's 128-wide tiles, packed kernel 5 on the
    # preconditioners' 8-wide level tiles); float64 at AMG_TOL_REL, plain
    for label, M1, build, a1, blk, rhs, tol_rel in (
            ("SA-AMG", smoothed_aggregation_preconditioner(A),
             lambda: tpar.sharded_amg_preconditioner(A, 4, n_pad_a, dtype=torch.float32),
             A, blocks_a, b_pad, F32_REACHABLE_TOL["SA-AMG"]),
            ("SA-AMG float64", smoothed_aggregation_preconditioner(A64),
             lambda: tpar.sharded_amg_preconditioner(A64, 4, n_pad_a, dtype=torch.float64),
             A64, blocks_64, b_pad64, AMG_TOL_REL),
            ("FSAI(1)", fsai_preconditioner(A, power=1),
             lambda: tpar.sharded_fsai_preconditioner(A, 4, n_pad_a, dtype=torch.float32),
             A, blocks_a, b_pad, F32_REACHABLE_TOL["FSAI(1)"]),
            ("FSAI(1) float64", fsai_preconditioner(A64, power=1),
             lambda: tpar.sharded_fsai_preconditioner(A64, 4, n_pad_a, dtype=torch.float64),
             A64, blocks_64, b_pad64, AMG_TOL_REL)):
        tol_c = tol_rel * float(torch.linalg.vector_norm(ba.double()))
        x1, i1 = cg_solve(a1, rhs[:na], tol=tol_c, M=M1, maxiter=AMG_PLAIN_MAXITER)
        t0 = time.perf_counter()
        pre = build()
        setup = time.perf_counter() - t0
        (xs, is_), used = launched(lambda: tpar.sharded_cg_solve(
            blk, cols_a, rhs, mesh=g4, tol=tol_c, M_local=pre, maxiter=AMG_PLAIN_MAXITER),
            ("bell_spmv", "bell_spmv_packed"))
        k, true = int(is_.iterations), true_rel(host, ba, xs[:na])
        f32 = not label.endswith("float64")
        check(bool(is_.converged) and k == int(i1.iterations),
              f"sharded {label} PCG poisson2d(512) P=4: {k} its against {int(i1.iterations)}")
        check(not f32 or (true <= F32_TRUE_SLACK * tol_rel and used["bell_spmv"] > k
                          and used["bell_spmv_packed"] > k),
              f"sharded {label} PCG poisson2d(512) P=4: true rel residual {true:.3e} at tol "
              f"{tol_rel:g}, launches {used} in {k} its")
        hashes.append(f"{label} PCG P=4 {digest(is_.rho_history, xs)}")
        tail = [f"{float(a):.4g}/{float(c):.4g}" for a, c in zip(
            last_three(is_, tol_c), last_three(i1, tol_c))]
        print(f"  sharded {label} PCG poisson2d({AMG_NX}) P=4 to {tol_rel:g} ||b||: {k} its, the "
              f"one-card PCG's {int(i1.iterations)}; ||r||/tol of the last three, "
              f"sharded/one-card: {', '.join(tail)}; host setup {setup:.2f} s, true rel residual "
              f"{true:.3e}; launches {used}  [{card}]")
        if not f32:
            continue
        print(timed_solve(lambda: tpar.sharded_cg_solve(
            blocks_a, cols_a, b_pad, mesh=g4, tol=tol_a, M_local=pre,
            maxiter=FAMILY_TIMED_STEPS), card, f"sharded {label} PCG poisson2d({AMG_NX}) P=4"))
        print(timed_solve(lambda: cg_solve(A, ba, tol=tol_a, M=M1, maxiter=FAMILY_TIMED_STEPS),
                          card, f"one-card {label} PCG poisson2d({AMG_NX})"))
    del blocks_a, cols_a, A, A64, blocks_64

    print(f"  ({time.perf_counter() - t_phase:.1f} s into the phase)")
    # (f) the sharded LOBPCG (CholQR²) on the eigs lane at P = 4 against the
    # one-card LOBPCG (Householder QR), Jacobi both
    jac_big = jacobi_preconditioner(big)
    m_rows = n // 4
    inv4 = jac_big.inv_diag.reshape(4, m_rows)
    pre = tpar.ShardedPreconditioner(op_arrays=(inv4,),
                                     make_local_apply=lambda arrs: (lambda r: arrs[0] * r))
    one_run = (lambda maxiter, tol_e: lobpcg_eigs(big, k=EIGS_K, M=jac_big, tol=tol_e,
                                                  maxiter=maxiter))
    sh_run = (lambda maxiter, tol_e: tpar.sharded_lobpcg_eigs(
        shard_ops[0], shard_ops[1], k=EIGS_K, n=n, mesh=g4, M_local=pre, tol=tol_e,
        maxiter=maxiter))
    r1, rs = one_run(EIGS_TOL_MAXITER, EIGS_TOL_REL), sh_run(EIGS_TOL_MAXITER, EIGS_TOL_REL)
    v1, vs = np.asarray(r1.values, np.float64), np.asarray(rs.values, np.float64)
    theta = float(np.abs(v1).max())
    bound = (np.asarray(r1.residuals, np.float64) + np.asarray(rs.residuals, np.float64)
             + EIGS_F32_RQ * theta)
    check(bool(np.all(rs.converged)) and np.all(np.abs(vs - v1) <= bound),
          f"sharded LOBPCG P=4: values {vs} against the one card's {v1}, bound {bound}")
    hashes.append(f"LOBPCG P=4 {digest(torch.as_tensor(vs), rs.vectors)}")
    print(f"  sharded LOBPCG k={EIGS_K} (Jacobi) P=4 to {EIGS_TOL_REL} (cap {EIGS_TOL_MAXITER}): "
          f"{rs.iters} its, the one card's {r1.iters}; max |lambda - lambda_1| "
          f"{np.abs(vs - v1).max():.3e} within {bound.min():.3e}  [{card}]")
    steps_of = lambda res: res.iters  # noqa: E731
    print(timed_solve(lambda: sh_run(FAMILY_LOBPCG_STEPS, 0.0), card,
                      f"sharded LOBPCG (CholQR2) P=4, {FAMILY_LOBPCG_STEPS} its", steps_of))
    print(timed_solve(lambda: one_run(FAMILY_LOBPCG_STEPS, 0.0), card,
                      f"one-card LOBPCG (Householder QR), {FAMILY_LOBPCG_STEPS} its", steps_of))
    print("  sharded families hashes (history and x): " + "; ".join(hashes))
    print(f"  sharded families phase: {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.synchronize()


def layouts_only(dev, card, which: str) -> None:
    """``--autodiff-only`` / ``--sharded-layouts-only`` /
    ``--sharded-families-only``: the one path, its operators built as the
    full run builds them, its launches counted."""
    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc

    big_full, big = block_tridiag_ops(N_BIG, 128, dev)
    fc.reset_counts()
    if which == "autodiff":
        phase_autodiff_path(dev, big, big_full, card)
        kernels = AUTODIFF_KERNELS
    else:
        dia_ops = dict(zip(("big", "big_sym"),
                           sym_dia_pair(SYMDIA_N, SYMDIA_OFFSETS, np.random.default_rng(0), dev)))
        shard_ops = sharded_ops(dev, 4)
        if which == "sharded families":
            phase_sharded_families_path(dev, big, big_full, shard_ops, dia_ops, card)
            kernels = FAMILY_KERNELS
        else:
            phase_sharded_layouts_path(dev, big, big_full, shard_ops, dia_ops, card)
            kernels = SHARDED_LAYOUT_KERNELS
    counts = dict(fc.LAUNCHES)
    print(f"  {which} path: launches {({k: counts[k] for k in kernels})}")
    for name in kernels:
        check(counts[name] > 0, f"kernel {name} never launched on the {which} path")
    print(card)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from conjugategradient_tpu_torch.ops.cuda import _build
    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc

    dev = torch.device(DEVICE)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    print(f"phase 1: built {os.path.relpath(str(lib), ROOT)} in {time.perf_counter() - t0:.1f} s")
    if sys.argv[1:] == ["--fused-cg-only"]:
        fused_cg_only(dev, card)
        return 0
    if sys.argv[1:2] == ["--sharded-only"] and len(sys.argv) <= 3:
        sharded_only(dev, card, sys.argv[2] if len(sys.argv) == 3 else None)
        return 0
    if sys.argv[1:2] == ["--stencil-only"] and len(sys.argv) <= 3:
        stencil_only(dev, card, sys.argv[2] if len(sys.argv) == 3 else None)
        return 0
    if sys.argv[1:2] == ["--dia-only"] and len(sys.argv) <= 3:
        dia_only(dev, card, sys.argv[2] if len(sys.argv) == 3 else None)
        return 0
    only = {"--autodiff-only": "autodiff", "--sharded-layouts-only": "sharded layouts",
            "--sharded-families-only": "sharded families"}
    if len(sys.argv) == 2 and sys.argv[1] in only:
        layouts_only(dev, card, only[sys.argv[1]])
        return 0

    print(f"phase 2: kernels vs plain versions ({time.perf_counter() - t0:.1f} s since the build "
          "began)")
    big_full, big = block_tridiag_ops(N_BIG, 128, dev)
    errs, times, extra, ops = phase_kernels(dev, big, big_full)
    dia_ops = phase_dia_kernels(dev, errs, times, extra)
    phase_stencil_kernels(dev, errs, times, extra)
    phase_minres_kernels(dev, big, big_full, ops, errs, times, extra)
    bic_ops = phase_bicgstab_kernels(dev, errs, times, extra)
    shard_ops = phase_sharded_kernels(dev, errs, times, extra)
    phase_bf16_kernels(dev, big, big_full, ops, dia_ops, errs, times)
    phase_bf16_minres_dia_kernels(dev, big, big_full, ops, dia_ops, shard_ops, errs, times,
                                  extra)
    phase_bf16_bicgstab_stencil_kernels(dev, bic_ops, shard_ops, errs, times, extra)
    ptxas_report(card)
    banded_ring_report(dev, big, card)
    sharded_ring_report(dev, card, shapes=(8,))
    for name, t in list(times.items()) + list(extra.items()):
        print_time_row(name, t, card)
    elementwise_floor(dev, card)

    # phase 3: each path with the counters set to 0 just before it and read
    # just after; a kernel's launches are those of its own path
    launches = {}
    for label, kernels, run in (
        ("blocked-ELL", BLOCKED_KERNELS,
         lambda: phase_main_path(dev, big, big_full, ops, card)),
        ("DIA / SELL", DIA_KERNELS, lambda: phase_dia_path(dev, dia_ops, card)),
        ("stencil", STENCIL_KERNELS, lambda: phase_stencil_path(dev, card)),
        ("MINRES", MINRES_KERNELS, lambda: phase_minres_path(dev, big, big_full, ops, card)),
        ("BiCGStab", BICGSTAB_KERNELS, lambda: phase_bicgstab_path(dev, bic_ops, card)),
        ("sharded", SHARDED_KERNELS, lambda: phase_sharded_path(dev, big_full, shard_ops, card)),
        ("GMRES / preconditioners / API", GMRES_KERNELS,
         lambda: phase_gmres_path(dev, big, big_full, card)),
        ("multi-RHS", MULTI_KERNELS, lambda: phase_multi_path(dev, big, big_full, card)),
        ("pipelined / s-step", CA_KERNELS, lambda: phase_ca_path(dev, big, big_full, card)),
        ("SA-AMG / FSAI", AMG_KERNELS, lambda: phase_amg_path(dev, card)),
        ("deflation / LOBPCG / scipy", DEFLATION_KERNELS,
         lambda: phase_deflation_path(dev, big, card)),
        ("refine / bf16", REFINE_KERNELS,
         lambda: phase_refine_path(dev, big, big_full, dia_ops, shard_ops, card)),
        ("bf16 BiCGStab / sharded / stencil", BF16_BICG_KERNELS,
         lambda: phase_bf16_bicgstab_stencil_path(dev, bic_ops, shard_ops, big_full, card)),
        ("autodiff", AUTODIFF_KERNELS, lambda: phase_autodiff_path(dev, big, big_full, card)),
        ("sharded layouts", SHARDED_LAYOUT_KERNELS,
         lambda: phase_sharded_layouts_path(dev, big, big_full, shard_ops, dia_ops, card)),
        ("sharded families", FAMILY_KERNELS,
         lambda: phase_sharded_families_path(dev, big, big_full, shard_ops, dia_ops, card)),
    ):
        print(f"phase 3: main path, {label} ({time.perf_counter() - t0:.1f} s since the build "
              "began)")
        fc.reset_counts()
        run()
        counts, plain_on_cuda = dict(fc.LAUNCHES), dict(fc.PLAIN_ON_CUDA)
        print(f"  {label} path: launches {counts}, plain on CUDA {plain_on_cuda}")
        print(f"  {label} path: kernel 11's launches by route: " + ", ".join(
            f"{k} {counts[k]}" for k in ("stencil7", "stencil7_staged", "stencil7_bf16",
                                         "stencil7_staged_bf16")))
        for name in kernels:
            check(counts[name] > 0, f"kernel {name} never launched on the {label} path")
            launches[name] = launches.get(name, 0) + counts[name]  # summed over its paths
        for name, count in plain_on_cuda.items():
            check(count == 0, f"plain {name} ran on CUDA tensors in the {label} path")

    print(f"phase 4: launches {launches}; {time.perf_counter() - t0:.1f} s since the build began")
    table = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name]["ms"],
         "plain_ms": times[name]["plain_ms"], "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"], "library_ms": times[name]["library_ms"]}
        for name in SOURCES
    ]}
    print(json.dumps(table))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
